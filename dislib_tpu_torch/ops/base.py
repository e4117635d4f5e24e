"""Shared device kernels used across estimators.

Counterpart of ``dislib_tpu/ops/base.py``: the one distance formulation
every caller shares, so numerical fixes land in one place.  Two dense
ds-arrays give a ds-array of their distances (the reference's eager
``_array_distances``, as under ``DSLIB_EAGER=1``), through the kernel.
"""

from __future__ import annotations

import torch

from dislib_tpu_torch.ops import kernels as _k
# the f32-faithful scope lives in the precision module; re-exported here
# for the package-wide import path, as in the reference
from dislib_tpu_torch.ops.precision import precise  # noqa: F401


def distances_sq(a, b, precision=None, use_kernel: bool = False):
    """Pairwise squared euclidean distances (m, k) between rows of ``a``
    (m, d) and rows of ``b`` (k, d): one GEMM + norms
    (‖a‖² − 2a·bᵀ + ‖b‖²), clamped at zero against cancellation.

    ``precision``: None, ``"highest"`` or ``"float32"`` (the
    float32-faithful contraction), or ``"default"`` (the reference's one
    bf16 pass: bf16 operands, float32 sums and norms).
    ``use_kernel=True`` routes tensors to the hand kernel
    (:func:`ops.kernels.distances_sq`), which on CPU tensors runs the same
    plain formulation.  Two dense ds-arrays give a ds-array (m, k),
    always through the kernel; a ds-array beside anything else raises
    ``TypeError``."""
    from dislib_tpu_torch.data.array import Array
    if isinstance(a, Array) or isinstance(b, Array):
        if not (type(a) is Array and type(b) is Array):
            raise TypeError(
                "distances_sq over ds-arrays needs BOTH operands as dense "
                f"Arrays, got {type(a).__name__} and {type(b).__name__}")
        return _array_distances(a, b, precision)
    if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)):
        raise TypeError(
            "distances_sq takes two torch tensors or two dense ds-arrays, "
            f"got {type(a).__name__} and {type(b).__name__}")
    if use_kernel:
        return _k.distances_sq(a, b, precision=precision)
    return _k.distances_sq_plain(a, b, precision=precision)


@precise
def _array_distances(a, b, precision=None):
    """ds-array pairwise squared distances (the reference's
    ``data/array._array_distances`` under ``DSLIB_EAGER=1``): the kernel on
    the logical regions, wrapped as an (m, k) ds-array on ``a``'s mesh."""
    from dislib_tpu_torch.data.array import Array
    if a.shape[1] != b.shape[1]:
        raise ValueError(f"distances_sq: feature dims differ "
                         f"({a.shape[1]} vs {b.shape[1]})")
    if a.device != b.device:
        raise ValueError(f"distances_sq: operands live on different "
                         f"devices: {a.device} vs {b.device}")
    (m, n), k = a.shape, b.shape[0]
    d = _k.distances_sq(a._data[:m, :n].contiguous(),
                        b._data[:k, :n].contiguous(), precision=precision)
    return Array._from_logical(d, a._mesh)


def cholesky_nan(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of ``a`` (..., n, n), NaN where a matrix is
    not positive definite: ``jnp.linalg.cholesky``'s result, where
    ``torch.linalg.cholesky`` raises.  ``cholesky_ex`` reports the failure
    on the device, so there is no host sync."""
    chol, info = torch.linalg.cholesky_ex(a)
    return torch.where((info == 0)[..., None, None], chol,
                       torch.full_like(chol, float("nan")))


# ---------------------------------------------------------------------------
# the k smallest distances, ties to the lower index
# ---------------------------------------------------------------------------
#
# The reference's kNN merges rely on ``lax.top_k`` keeping the lower
# position on ties: carried candidates precede a chunk, and chunks arrive
# in index order, so of two equal distances the lower fit index wins.
# ``torch.topk`` promises no order for ties — neither which of several
# equal values it keeps at the k-th place nor their order — on the CPU or
# on CUDA.  So a chunk's k smallest are chosen in two steps.  A float32
# top-k gives the k smallest values, which are right whatever it does with
# ties: every distance below the k-th value v is among them.  The places
# left are v's, and they go to the lowest indices where the chunk holds v,
# found by a cumulative count of ``d2 == v`` along the row.  The k chosen
# candidates then become int64 keys, their distance's float32 bits high
# and their index low: distances are clamped at 0, and the bits of a
# non-negative float32 (+inf included) order as the float does, so the
# integer order of the keys is the order of (distance, index).  Only 2k
# keys are ever sorted (the carried k and the chunk's k), never the chunk.
# A NaN distance (non-finite input) gives an unspecified neighbour.

def _keys(d2: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Keys int64 ``bits(d2)·2^32 + id`` of candidates ``d2`` float32 ≥ 0
    with indices ``ids`` in [0, 2^32), elementwise (``+ 0.0`` turns a
    -0.0 into +0.0, whose bits order first)."""
    return torch.add(ids.to(torch.int64), (d2 + 0.0).view(torch.int32),
                     alpha=1 << 32)


def merge_keyed(best: torch.Tensor, d2: torch.Tensor, ids: torch.Tensor,
                k: int) -> torch.Tensor:
    """Keys (rows, k) int64, ascending, of the k smallest of the carried
    keys ``best`` (rows, ≥ k) and the candidates ``d2`` (rows, n) float32
    ≥ 0 whose indices ``ids`` (rows, n) stand in any order (the IVF scan's
    gathered list entries); an index of −1 (an empty slot) sorts after
    every other at its distance.  Every candidate is keyed, so ties go to
    the lower index wherever it stands."""
    cand = torch.cat((best, _keys(d2, ids.to(torch.int64) & 0xFFFFFFFF)),
                     dim=1)
    return torch.topk(cand, k, dim=1, largest=False, sorted=True).values


def chunk_smallest(d2: torch.Tensor, k: int, off: int = 0) -> torch.Tensor:
    """Keys (rows, min(k, n)) int64, ascending, of the k smallest of the
    chunk ``d2`` (rows, n) float32 ≥ 0 whose column j is fit row
    ``off + j``, ties to the lower index."""
    n = d2.shape[1]
    kk = min(k, n)
    vals, pos = torch.topk(d2, kk, dim=1, largest=False, sorted=True)
    v = vals[:, -1:]                                  # the k-th value
    n_lt = torch.sum(vals < v, dim=1, keepdim=True)   # places below v
    # v's ties counted along the row: int32 written by the compare itself
    # and scanned in place (no bool copy, no cast pass)
    seen = torch.eq(d2, v, out=torch.empty(d2.shape, dtype=torch.int32,
                                           device=d2.device)).cumsum_(1)
    want = torch.arange(1, kk + 1, dtype=torch.int32, device=d2.device)
    tie_pos = torch.searchsorted(seen, want.expand(d2.shape[0], kk)
                                 .contiguous())       # j-th v in the row
    slot = torch.arange(kk, device=d2.device)
    below = slot < n_lt
    tie_pos = torch.gather(tie_pos, 1, (slot - n_lt).clamp_min_(0))
    pos = torch.where(below, pos, tie_pos.clamp_max_(n - 1))
    keys = _keys(torch.where(below, vals, v), pos + off)
    return torch.sort(keys, dim=1).values


def merge_smallest(best, d2: torch.Tensor, k: int, off: int = 0):
    """Keys (rows, ≤ k) int64, ascending, of the k smallest of the carried
    keys ``best`` (None to start) and the chunk ``d2`` (rows, n) whose
    column j is fit row ``off + j``: the chunk's own k smallest
    (:func:`chunk_smallest`) joined with ``best``, 2k candidates."""
    sel = chunk_smallest(d2, k, off)
    if best is None:
        return sel
    cand = torch.cat((best, sel), dim=1)
    return torch.topk(cand, min(k, cand.shape[1]), dim=1, largest=False,
                      sorted=True).values


def split_keys(keys: torch.Tensor):
    """(d2 float32, idx int32) of keys from :func:`merge_smallest`."""
    return (keys >> 32).to(torch.int32).view(torch.float32), \
        (keys & 0xFFFFFFFF).to(torch.int32)
