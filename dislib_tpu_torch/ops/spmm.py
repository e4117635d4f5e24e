"""SpMM: sparse @ dense on one card.

Counterpart of ``dislib_tpu/ops/spmm.py``.  The reference contracts its
row-sharded sparse buffers against a dense operand in a SUMMA-style panel
loop — each panel of B rows broadcast along the mesh's 'rows' axis, each
device folding its local entries in with a gather and a segment sum — and
has no Pallas kernel for it ("the inner gather/scatter has no Pallas
variant").  On one rank there is no broadcast: C = A @ B is one gather of
B's rows at the entries' columns, a scale by the entries' values, and a
sum of each output row's contiguous segment of products
(``torch.segment_reduce`` over the row-sorted entries of
``data/sparse.SparseArray``).  Each row's products are summed in entry
order, so two calls give bit-identical results on the card (``index_add_``
would add with atomics in a varying order).

Mixed precision, as the reference's: the operands round to the policy's
compute dtype, and their products (exact in float32 for bf16 operands) are
summed in the policy's accumulation dtype (float32).  B's columns go in slices of at most
:data:`BLOCK_BYTES` of products.  ``overlap``, ``panels`` and ``layout``
are the reference's multi-rank knobs: ``overlap`` and ``layout`` are
checked as the reference checks them, and on one rank every setting gives
the same single fold.
"""

from __future__ import annotations

import torch

from dislib_tpu_torch.ops import overlap as _ov
from dislib_tpu_torch.ops import precision as px

__all__ = ["spmm", "spmm_rows", "seg_sum"]

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
    m, n = rows_len.shape[0], b.shape[1]
    idx = cols.to(torch.int64)
    step = max(1, int(BLOCK_BYTES) // (4 * max(1, vals.shape[0])))
    if step >= n:
        return _fold(rows_len, idx, vc, bc, acc)
    out = torch.empty((m, n), dtype=acc, device=b.device)
    for c0 in range(0, n, step):
        out[:, c0:c0 + step] = _fold(rows_len, idx, vc,
                                     bc[:, c0:c0 + step], acc)
    return out


def _fold(rows_len, idx, vc, bc, acc):
    prod = bc.index_select(0, idx).to(acc) * vc.to(acc)[:, None]
    return seg_sum(prod, rows_len)


def spmm(a, b, *, precision=None, overlap=None, panels=None, layout=None):
    """sparse @ dense: ``a`` a :class:`~data.sparse.SparseArray`, ``b`` a
    dense ds-array on the same device.  Returns a dense ds-array of the
    policy's accumulation dtype."""
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
    _ov.resolve(overlap)
    del panels                    # one rank folds every panel in one pass
    policy = px.resolve(precision)
    k, n = b.shape
    out = spmm_rows(a._row_len, a._cols, a._vals,
                    b._data[:k, :n].contiguous(), policy)
    return Array._from_logical(out, a._mesh,
                               reg_shape=(a.block_size[0], b.block_size[1]))
