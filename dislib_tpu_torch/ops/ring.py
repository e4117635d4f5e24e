"""Ring-parallel kNN and ε-pass over the mesh 'rows' axis.

Counterpart of ``ring_auto``, ``ring_kneighbors`` and
``ring_neigh_count_min`` in ``dislib_tpu/ops/ring.py``.  The reference keeps each query shard resident
and rotates the fitted shards around the 'rows' axis with ``ppermute``,
folding each visiting shard into a running top-k, through
``ops/overlap.panel_pipeline``.  The port runs the same schedule over
the ranks of a mesh: each rank keeps its query block and its fit block
(features over 'cols'); the fetch is a ``ppermute`` by one over 'rows'
(``parallel/distributed.ppermute``, in flight while the previous
panel's block is consumed under ``db``), and the row norms and the
cross term are ``psum``-ed over 'cols', as in
``dislib_tpu/ops/ring.py:66-119``.  At step t a rank holds the fit block
of the rank t places back, so a panel carries the fit index of its first
row.  On a one-rank mesh the fetch is the identity and the loop takes
one step, so the single step materialises the whole (mq, mf) distance
block — the reason ``neighbors/base.py`` routes here only on a mesh of
more than one row, as the reference does.

The cross term ``q @ f_curᵀ`` is ``ops/kernels.panel_gemm`` at FLOAT32
under ``overlap="kernel"`` (``pallas`` is its alias), the reference's
``overlap == "pallas"`` branch; under ``db`` and ``seq`` it is the precise
``torch.matmul``.  ``f_curᵀ`` is made contiguous once per call, as the
kernel takes a row-major (K, N) operand.  The merge keeps the k smallest
of the carried best and the step's candidates with ties to the lower fit
index (``ops/base.merge_smallest``), which is what the reference's
``lax.top_k`` over ``[best ∥ step]`` keeps.  Where the port departs: a
distance² below 0 (cancellation, |d²| within rounding of 0) ranks as 0,
as on the direct and chunked paths, where the reference's ring ranks the
negative values; the distances returned are ``max(d², 0)`` on both.

``ring_neigh_count_min`` is the ε-neighbourhood pass of DBSCAN's and
Daura's ring tier, the reference's ``:150-265``: each rank's rows, with
every feature (all-gathered over 'cols' once a fit and padded by
``ops/tiled.pad_cols``: :func:`ring_rows`), stay home, while (rows,
vals, colmask) rotate around 'rows' by ``ppermute`` in
``panel_pipeline`` under the ``db`` and ``seq`` schedules; each visit
folds the visiting block into the running (count, min) by
``ops/tiled.neigh_count_min_pair`` in row tiles of :data:`RING_TILE`,
the rows' global ids carried as their blocks' offsets (a block's rows
are contiguous), so the structural diagonal is the ids' equality.  The
counts and mins are ``pmax``/``pmin``-ed over 'cols', as the
reference's are.  On one rank the fetch is never called and the one
step folds the home rows into themselves.

Not ported: ``comm_only=True`` of both kernels (a bench device: the
rotation-only program that times the ring's communication alone, which
one rank does not have).
"""

from __future__ import annotations

import torch

from dislib_tpu_torch.ops import kernels as _k
from dislib_tpu_torch.ops import overlap as _ov
from dislib_tpu_torch.ops import precision as px
from dislib_tpu_torch.ops import tiled as _tiled
from dislib_tpu_torch.ops.base import merge_smallest, precise, split_keys
from dislib_tpu_torch.parallel import distributed as _dist
from dislib_tpu_torch.parallel import mesh as _mesh


# inner streaming tile edge within one ring step (module-level so tests
# can shrink it)
RING_TILE = 2048


def ring_auto(flag, mesh, large):
    """Shared ring-routing policy: ``flag`` True forces the ring schedule,
    False forces it off, None picks it when the mesh has >1 row shard and
    the caller's own size predicate ``large`` holds."""
    if flag is not None:
        return bool(flag)
    return mesh.shape[_mesh.ROWS] > 1 and large


@precise
def ring_kneighbors(qp, fp, mesh, k, m_fit, overlap="db"):
    """(distances² (mq_loc, k) float32, indices (mq_loc, k) int32) of the
    k nearest fitted rows per query row of this rank, ascending.

    ``qp`` (mq_pad/R, d_pad/C) and ``fp`` (mf_pad/R, d_pad/C): this rank's
    blocks of the padded backings (the whole backings on one rank); fit
    rows at or past ``m_fit`` are +inf and never neighbours.  Padded query
    rows carry garbage; callers crop.  ``overlap`` is a canonical schedule
    of ``ops/overlap.SCHEDULES``."""
    nrows = mesh.shape[_mesh.ROWS]
    my = mesh.coord[0]
    mf_loc = fp.shape[0]
    q = qp.contiguous()
    q_sq = _dist.psum(torch.sum(q * q, dim=1), _mesh.COLS, mesh)
    # a panel: f^T, its row norms and the fit index of its first row
    pan0 = (fp.T.contiguous(),
            _dist.psum(torch.sum(fp * fp, dim=1), _mesh.COLS, mesh),
            my * mf_loc)

    def fetch(t, prev):
        ft, fsq, _ = _ov.landed(prev)
        # one hop: the fit block of the rank t places back
        return (_dist.ppermute(ft, _mesh.ROWS, 1, mesh, async_op=True),
                _dist.ppermute(fsq, _mesh.ROWS, 1, mesh, async_op=True),
                (my - t) % nrows * mf_loc)

    def consume(t, best, pan):
        ft_cur, fsq_cur, off = _ov.landed(pan)
        if overlap == "kernel":
            part = _k.panel_gemm(q, ft_cur, px.FLOAT32)
        else:
            part = torch.matmul(q, ft_cur)                # (mq, mf_loc)
        part = _dist.psum(part, _mesh.COLS, mesh)
        # q_sq − 2·part + f_sq, in the reference's order of rounding
        d2 = part.mul_(-2.0).add_(q_sq[:, None]).add_(fsq_cur[None, :])
        d2[:, max(m_fit - off, 0):] = float("inf")
        return merge_smallest(best, d2.clamp_min_(0.0), k, off)

    best = _ov.panel_pipeline(nrows, pan0, fetch, consume, None,
                              _ov.overlapped(overlap))
    return split_keys(best)


def ring_rows(x) -> torch.Tensor:
    """The rows a ring ε-pass keeps home: this rank's rows of the ds-array
    ``x`` with every feature — its block all-gathered over 'cols' (the
    reference's ``:172``), the logical columns padded by
    ``ops/tiled.pad_cols`` — once a fit: the block's rows, padding
    included (the callers mask them by their global ids; one rank's block
    has no padded rows)."""
    return _tiled.pad_cols(x._row_block()[:, : x.shape[1]])


def ring_neigh_count_min(xv, eps2, vals, colmask, sentinel, mesh,
                         overlap="db", counts=True, mins=True):
    """Per-row (ε-neighbour count int32 (ml,), min over neighbour vals
    (ml,) of ``vals.dtype``) of this rank's rows ``xv`` (:func:`ring_rows`)
    against every rank's — ``ops/tiled.neigh_count_min`` over the whole
    dataset.  adj(i, j) = (d²(i, j) ≤ eps2 ∨ i = j) ∧ colmask_j, the
    single-device contract; ``vals``/``colmask`` are this rank's (ml,)
    and zero pad columns change no distance.  Home row i is global row
    ``r·ml + i`` on mesh row r.  ``overlap`` is a canonical schedule of
    ``ops/overlap.SCHEDULES``.  ``counts=False`` or ``mins=False`` skips
    a reduction the caller does not read (None in its place), as in
    ``ops/tiled.neigh_count_min``."""
    nrows = mesh.shape[_mesh.ROWS]
    my = mesh.coord[0]
    ml = xv.shape[0]
    tile = max(1, min(RING_TILE, ml))
    # colmask travels as bytes (a bool collective is not every backend's)
    pan0 = (xv.contiguous(), vals.contiguous(),
            colmask.to(torch.uint8).contiguous())

    def fetch(t, prev):
        # one hop: the block of the rank t places back
        return tuple(_dist.ppermute(p, _mesh.ROWS, 1, mesh, async_op=True)
                     for p in _ov.landed(prev))

    def consume(t, acc, pan):
        x, v, cm = _ov.landed(pan)
        return _tiled.neigh_count_min_pair(
            xv, my * ml, x, (my - t) % nrows * ml, eps2, v, cm, sentinel,
            tile, counts=counts, mins=mins, acc=acc)

    acc0 = (torch.zeros(ml, dtype=torch.int32, device=xv.device)
            if counts else None,
            torch.full((ml,), sentinel, dtype=vals.dtype, device=xv.device)
            if mins else None)
    cnt, mn = _ov.panel_pipeline(nrows, pan0, fetch, consume, acc0,
                                 _ov.overlapped(overlap))
    # every rank of a mesh row computed the same rows from the gathered
    # features; the reference makes that invariance explicit
    if counts:
        cnt = _dist.pmax(cnt, _mesh.COLS, mesh)
    if mins:
        mn = _dist.pmin(mn, _mesh.COLS, mesh)
    return cnt, mn
