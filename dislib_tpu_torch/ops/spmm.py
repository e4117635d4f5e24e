"""SpMM: sparse @ dense.

Counterpart of ``dislib_tpu/ops/spmm.py``.  The reference contracts its
row-sharded sparse buffers against a dense operand in a SUMMA-style panel
loop — each panel of B rows assembled along the mesh's 'rows' axis by a
masked ``psum``, each device folding its local entries in with a gather
and a segment sum — and has no Pallas kernel for it ("the inner
gather/scatter has no Pallas variant").  On one rank there is no panel:
C = A @ B is one gather of B's rows at the entries' columns, a scale by
the entries' values, and a sum of each output row's contiguous segment of
products (``torch.segment_reduce`` over the row-sorted entries of
``data/sparse.SparseArray``).  Each row's products are summed in entry
order, so two calls give bit-identical results on the card (``index_add_``
would add with atomics in a varying order).

On a mesh of R x C ranks (:func:`_spmm_ranks`, the reference's
``spmm_panels``): B's contraction rows walk in :func:`spmm_steps` panels
of h = K_pad / steps rows (``DSLIB_SPMM_PANELS``, default 4, fitted to
divide K_pad); every rank of a mesh column contributes the slice of the
panel it holds (zeros elsewhere, so a panel may span several owners) and
one ``psum`` over 'rows' assembles it — exact, one owner a row.  Each rank
folds its entries of the panel into its (m_local, n_local) output block,
B's columns being its own, in slices of at most :data:`BLOCK_BYTES` of
products as on one rank.  Under ``layout="slots"`` (the default) the
entries come from the shard's column-partitioned view
(``ShardedSparse.panel_view``), so panel t touches only its own slot
range; ``"masked"`` masks every entry of the shard by the panel's
columns.  The panels go through ``ops/overlap.panel_pipeline``: under
``db`` the next panel's ``psum`` is in flight while this one folds (two
panels live), under ``seq`` one; the schedules are bit-equal.  B is never
gathered whole and A never densified.

Mixed precision, as the reference's: the operands round to the policy's
compute dtype, and their products (exact in float32 for bf16 operands) are
summed in the policy's accumulation dtype (float32).  On one rank B's
columns go in the same slices, and ``overlap``, ``panels`` and ``layout``
are checked and give the same single fold.
"""

from __future__ import annotations

import os

import torch

from dislib_tpu_torch.ops import overlap as _ov
from dislib_tpu_torch.ops import precision as px
from dislib_tpu_torch.parallel import distributed as _dist
from dislib_tpu_torch.utils import profiling as _prof

__all__ = ["spmm", "spmm_rows", "spmm_steps", "seg_sum"]

#: bytes of float32 products one slice of B's columns may hold
BLOCK_BYTES = 1 << 30


def seg_sum(vals: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Sums of the consecutive segments of ``vals`` (along dim 0) whose
    sizes are ``lengths``, each summed in a fixed order; an empty segment
    sums to 0."""
    if vals.shape[0] == 0:
        return torch.zeros((lengths.shape[0], *vals.shape[1:]),
                           dtype=vals.dtype, device=vals.device)
    return torch.segment_reduce(vals, "sum", lengths=lengths, axis=0)


def spmm_rows(rows_len, cols, vals, b, policy=px.FLOAT32) -> torch.Tensor:
    """``A @ b`` for A given by its row-sorted entries: ``cols``/``vals``
    (nnz,) and ``rows_len`` (m,) entries per row; ``b`` (k, n) dense.
    Returns (m, n) in the policy's accumulation dtype."""
    vc = px.to_compute(vals, policy)
    bc = px.to_compute(b, policy)
    acc = torch.promote_types(px.accum_dtype(policy),
                              torch.promote_types(vc.dtype, bc.dtype))
    return _folded(rows_len, cols.to(torch.int64), vc, bc, acc)


def _folded(rows_len, idx, vc, bc, acc):
    """The row sums of the products of the entries (``idx``, ``vc``) with
    ``bc``'s rows, in dtype ``acc``: ``bc``'s columns in slices of at most
    :data:`BLOCK_BYTES` of products (the entries times the slice's width
    times 4 bytes)."""
    m, n = rows_len.shape[0], bc.shape[1]
    step = max(1, int(BLOCK_BYTES) // (4 * max(1, vc.shape[0])))
    if step >= n:
        return _fold(rows_len, idx, vc, bc, acc)
    out = torch.empty((m, n), dtype=acc, device=bc.device)
    for c0 in range(0, n, step):
        out[:, c0:c0 + step] = _fold(rows_len, idx, vc,
                                     bc[:, c0:c0 + step], acc)
    return out


def _fold(rows_len, idx, vc, bc, acc):
    prod = bc.index_select(0, idx).to(acc) * vc.to(acc)[:, None]
    return seg_sum(prod, rows_len)


def _fit_steps(requested, k_pad):
    """The largest panel count at most ``requested`` that divides the
    padded contraction dimension (the reference's ``_fit_steps``)."""
    for st in range(max(2, min(int(requested), k_pad)), 1, -1):
        if k_pad % st == 0:
            return st
    return 1


def spmm_steps(panels=None) -> int:
    """The SpMM's panel count across ranks: ``panels``, else
    ``DSLIB_SPMM_PANELS`` (default 4), at least 2 so the double-buffered
    schedule has a panel to overlap."""
    if panels is None:
        panels = int(os.environ.get("DSLIB_SPMM_PANELS", "4"))
    return max(2, int(panels))


def spmm(a, b, *, precision=None, overlap=None, panels=None, layout=None):
    """sparse @ dense: ``a`` a :class:`~data.sparse.SparseArray`, ``b`` a
    dense ds-array on the same device (and mesh).  Returns a dense
    ds-array of the policy's accumulation dtype."""
    from dislib_tpu_torch.data.array import Array
    from dislib_tpu_torch.data.sparse import SparseArray
    if not isinstance(a, SparseArray):
        raise TypeError(f"spmm needs a SparseArray lhs, got {type(a)}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"spmm shape mismatch: {a.shape} @ {b.shape}")
    if a.device != b.device:
        raise ValueError(f"spmm operands live on different devices: "
                         f"{a.device} vs {b.device}")
    if layout not in (None, "slots", "masked"):
        raise ValueError(f"spmm: unknown layout {layout!r}")
    sched = _ov.resolve(overlap)
    policy = px.resolve(precision)
    reg = (a.block_size[0], b.block_size[1])
    if a._mesh.world > 1 or b._mesh.world > 1:
        if a._mesh != b._mesh:
            raise ValueError("spmm operands live on different meshes")
        lay = "slots" if layout is None else layout
        _prof.count_schedule("spmm", sched)
        _prof.count_schedule("spmm_layout", lay)
        out = _spmm_ranks(a, b, policy, sched, spmm_steps(panels), lay)
        return Array(out, (a.shape[0], b.shape[1]), a._mesh, reg)
    k, n = b.shape
    out = spmm_rows(a._row_len, a._cols, a._vals,
                    b._data[:k, :n].contiguous(), policy)
    return Array._from_logical(out, a._mesh, reg_shape=reg)


def _spmm_ranks(a, b, policy, sched, steps, layout):
    """This rank's (m_local, n_local) block of ``a @ b`` across ranks: the
    panel loop of the module docstring."""
    mesh = a._mesh
    bl = b._local                           # (k_loc, n_loc), B's block
    k_pad = b._pshape[0]
    k_loc, n_loc = bl.shape
    r = mesh.coord[0]
    steps = _fit_steps(steps, k_pad)
    h = k_pad // steps
    rep = a.sharded()
    m_local = rep.m_local
    dev = bl.device
    if layout == "slots":
        view = rep.panel_view(steps, h)
        cnt = rep.panel_counts(steps, h)[r]
        vd = px.to_compute(view.data[0], policy)
        parts = []
        for t in range(steps):
            lo = t * view.nse_p
            hi = lo + int(cnt[t])
            rows = view.lrows[0, lo:hi].to(torch.int64)
            parts.append((torch.bincount(rows, minlength=m_local),
                          view.cols[0, lo:hi].to(torch.int64), vd[lo:hi]))
    else:
        rows, cols, vals = rep._live()
        lens = torch.bincount(rows.to(torch.int64), minlength=m_local)
        cols = cols.to(torch.int64)
        vc = px.to_compute(vals, policy)
        zero = torch.zeros((), dtype=vc.dtype, device=dev)
        parts = []
        for t in range(steps):
            inp = (cols >= t * h) & (cols < t * h + h)
            parts.append((lens, (cols - t * h).clamp_(0, h - 1),
                          torch.where(inp, vc, zero)))
    acc_dt = torch.promote_types(px.accum_dtype(policy), torch.promote_types(
        parts[0][2].dtype, px.to_compute(bl[:1], policy).dtype))

    def fetch(t, prev):
        del prev
        # panel t is B's global rows [t·h, t·h + h): each rank of the mesh
        # column sends the slice it holds, zeros elsewhere
        lo, r0 = t * h, r * k_loc
        a0, a1 = max(lo, r0), min(lo + h, r0 + k_loc)
        pan = torch.zeros((h, n_loc), dtype=bl.dtype, device=dev)
        if a0 < a1:
            pan[a0 - lo:a1 - lo] = bl[a0 - r0:a1 - r0]
        return (_dist.psum(pan, "rows", mesh, async_op=True),)

    def consume(t, acc, pan):
        (p,) = _ov.landed(pan)
        lens, cols, w = parts[t]
        return acc + _folded(lens, cols, w, px.to_compute(p, policy), acc_dt)

    acc0 = torch.zeros((m_local, n_loc), dtype=acc_dt, device=dev)
    return _ov.panel_pipeline(steps, fetch(0, None), fetch, consume, acc0,
                              _ov.overlapped(sched))
