"""Ring-parallel kNN and ε-pass over the mesh 'rows' axis.

Counterpart of ``ring_auto``, ``ring_kneighbors`` and
``ring_neigh_count_min`` in ``dislib_tpu/ops/ring.py``.  The reference keeps each query shard resident
and rotates the fitted shards around the 'rows' axis with ``ppermute``,
folding each visiting shard into a running top-k, through
``ops/overlap.panel_pipeline``.  The port runs the same schedule on one
rank, a ``(1, 1)`` mesh: the fetch is the identity (the one panel is
already home; the ``ppermute`` hop over NCCL is ROADMAP.md A.2) and the
loop takes one step, so the single step materialises the whole
(mq, mf) distance block — the reason ``neighbors/base.py`` routes here
only on a mesh of more than one row, as the reference does.

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
Daura's ring tier: the same ``panel_pipeline`` with the identity fetch,
whose one step folds the home shard into the running (count, min) by
``ops/tiled.neigh_count_min`` in row tiles of :data:`RING_TILE`.

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
from dislib_tpu_torch.parallel import mesh as _mesh


# inner streaming tile edge within one ring step (module-level so tests
# can shrink it)
RING_TILE = 2048


def _one_rank(what, mesh):
    nrows = mesh.shape[_mesh.ROWS]
    if nrows != 1:
        raise NotImplementedError(
            f"{what} over {nrows} row shards: the port runs one rank; the "
            "ppermute hop over NCCL is ROADMAP.md A.2")
    return nrows


def ring_auto(flag, mesh, large):
    """Shared ring-routing policy: ``flag`` True forces the ring schedule,
    False forces it off, None picks it when the mesh has >1 row shard and
    the caller's own size predicate ``large`` holds."""
    if flag is not None:
        return bool(flag)
    return mesh.shape[_mesh.ROWS] > 1 and large


@precise
def ring_kneighbors(qp, fp, mesh, k, m_fit, overlap="db"):
    """(distances² (mq_pad, k) float32, indices (mq_pad, k) int32) of the
    k nearest fitted rows per query row, ascending.

    ``qp`` (mq_pad, d) and ``fp`` (mf_pad, d): the padded backings; fit
    rows at or past ``m_fit`` are +inf and never neighbours.  Padded query
    rows carry garbage; callers crop.  ``overlap`` is a canonical schedule
    of ``ops/overlap.SCHEDULES``."""
    nrows = _one_rank("ring_kneighbors", mesh)
    q = qp.contiguous()
    q_sq = torch.sum(q * q, dim=1)
    # a panel: f^T, its row norms and the fit index of its first row
    pan0 = (fp.T.contiguous(), torch.sum(fp * fp, dim=1), 0)

    def consume(t, best, pan):
        ft_cur, fsq_cur, off = pan
        if overlap == "kernel":
            part = _k.panel_gemm(q, ft_cur, px.FLOAT32)
        else:
            part = torch.matmul(q, ft_cur)                # (mq, mf_loc)
        # q_sq − 2·part + f_sq, in the reference's order of rounding
        d2 = part.mul_(-2.0).add_(q_sq[:, None]).add_(fsq_cur[None, :])
        d2[:, max(m_fit - off, 0):] = float("inf")
        return merge_smallest(best, d2.clamp_min_(0.0), k, off)

    best = _ov.panel_pipeline(nrows, pan0, _identity_fetch, consume, None,
                              _ov.overlapped(overlap))
    return split_keys(best)


def _identity_fetch(t, prev):
    return prev                      # one rank: the panel is already home


def ring_neigh_count_min(xp, eps2, vals, colmask, sentinel, mesh,
                         overlap="db", counts=True, mins=True):
    """Per-row (ε-neighbour count int32 (mp,), min over neighbour vals
    (mp,) of ``vals.dtype``) of ``xp`` (mp, np) against itself —
    ``ops/tiled.neigh_count_min`` under the ring's schedule.  adj(i, j) =
    (d²(i, j) ≤ eps2 ∨ i = j) ∧ colmask_j, the single-device contract;
    zero pad columns change no distance.  ``overlap`` is a canonical
    schedule of ``ops/overlap.SCHEDULES``; on one rank every schedule
    consumes the one panel the same way.  ``counts=False`` or
    ``mins=False`` skips a reduction the caller does not read (None in its
    place), as in ``ops/tiled.neigh_count_min``."""
    nrows = _one_rank("ring_neigh_count_min", mesh)
    pan0 = (xp.contiguous(), vals, colmask)

    def consume(t, acc, pan):
        x, v, cm = pan
        cnt, mn = _tiled.neigh_count_min(x, eps2, v, cm, sentinel,
                                         max(1, min(RING_TILE, x.shape[0])),
                                         counts=counts, mins=mins)
        return (acc[0] + cnt if counts else None,
                torch.minimum(acc[1], mn) if mins else None)

    acc0 = (torch.zeros(xp.shape[0], dtype=torch.int32, device=xp.device),
            torch.full((xp.shape[0],), sentinel, dtype=vals.dtype,
                       device=xp.device))
    return _ov.panel_pipeline(nrows, pan0, _identity_fetch, consume, acc0,
                              _ov.overlapped(overlap))
