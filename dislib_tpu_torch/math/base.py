"""Blocked math: the distributed GEMM.

Counterpart of ``dislib_tpu/math/base.py`` (``matmul`` and its routing,
dense only).  One entry, two schedules:

- ``"xla"``: one product of the whole padded operands through
  ``ops/precision.pdot`` — a plain product, which the reference also
  leaves to its compiler (the name is kept so ``algorithm=`` and
  ``DSLIB_MATMUL_ALGO`` mean the same in both packages);
- ``"summa"``: the explicit panel schedule (``ops/summa``) under the
  ``DSLIB_OVERLAP`` schedule; ``kernel``/``pallas`` runs its panel GEMM on
  the hand CUDA kernel.

``kron`` and ``svd`` are later slices (ROADMAP.md A.7); a sparse lhs is
A.10.
"""

from __future__ import annotations

import os

import torch

from dislib_tpu_torch.data.array import Array
from dislib_tpu_torch.ops import overlap as _ov
from dislib_tpu_torch.ops import precision as px
from dislib_tpu_torch.ops.summa import summa_matmul, summa_supported

# auto-SUMMA size gate: below this min logical dimension an explicit panel
# schedule buys nothing over one product (``DSLIB_SUMMA_MIN_DIM``
# overrides at runtime, as in the reference)
_SUMMA_MIN_DIM = 256


def _summa_min_dim() -> int:
    env = os.environ.get("DSLIB_SUMMA_MIN_DIM")
    return int(env) if env else _SUMMA_MIN_DIM


def _pick_algorithm(algorithm, a, b, a_shape, b_shape, transpose_a,
                    transpose_b):
    """The matmul routing rule: an explicit ``algorithm=`` wins; ``"auto"``
    consults ``DSLIB_MATMUL_ALGO``, then picks ``"summa"`` on a genuinely
    2-D mesh for untransposed operands whose every logical dim is at least
    ``_SUMMA_MIN_DIM``, and ``"xla"`` otherwise."""
    if algorithm not in ("auto", "summa", "xla"):
        raise ValueError(f"unknown matmul algorithm {algorithm!r}: "
                         "expected 'auto', 'summa' or 'xla'")
    if algorithm == "auto":
        env = os.environ.get("DSLIB_MATMUL_ALGO", "auto")
        if env not in ("auto", "summa", "xla"):
            raise ValueError(f"bad DSLIB_MATMUL_ALGO={env!r}")
        algorithm = env
    if algorithm == "auto":
        big = min(a_shape[0], a_shape[1], b_shape[1]) >= _summa_min_dim()
        return "summa" if (big and summa_supported(a._mesh)
                           and not (transpose_a or transpose_b)) else "xla"
    return algorithm


def matmul(a: Array, b: Array, transpose_a: bool = False,
           transpose_b: bool = False, *, algorithm: str = "auto",
           precision=None) -> Array:
    """Distributed GEMM (reference: ``dislib_tpu.math.matmul``).

    ``precision``: the mixed-precision policy (None → the
    ``DSLIB_MATMUL_PRECISION`` default) — ``"bfloat16"`` contracts
    bf16-compute / f32-accumulate within ``ERROR_BOUNDS``; the default is
    float32-faithful."""
    if type(a) is not Array or type(b) is not Array:
        raise NotImplementedError(
            f"matmul of {type(a).__name__} @ {type(b).__name__}: the port "
            "takes dense ds-arrays; sparse operands are ROADMAP.md A.10")
    if a.device != b.device:
        raise ValueError(f"matmul operands live on different devices: "
                         f"{a.device} vs {b.device}")
    policy = px.resolve(precision)
    a_shape = (a.shape[1], a.shape[0]) if transpose_a else a.shape
    b_shape = (b.shape[1], b.shape[0]) if transpose_b else b.shape
    if a_shape[1] != b_shape[0]:
        raise ValueError(f"matmul shape mismatch: {a_shape} @ {b_shape}")
    out_shape = (a_shape[0], b_shape[1])
    reg = (a._reg_shape[1] if transpose_a else a._reg_shape[0],
           b._reg_shape[0] if transpose_b else b._reg_shape[1])
    algo = _pick_algorithm(algorithm, a, b, a_shape, b_shape, transpose_a,
                           transpose_b)
    if algo == "summa":
        return _matmul_summa(a, b, transpose_a, transpose_b, policy,
                             out_shape, reg)
    ad, bd = _match_inner(a._data, b._data, transpose_a, transpose_b)
    # zero-padding invariant => padded contraction == logical contraction
    out = px.pdot(ad.T if transpose_a else ad, bd.T if transpose_b else bd,
                  policy)
    return Array(_crop_or_keep(out, out_shape), out_shape, a._mesh, reg)


def _matmul_summa(a, b, transpose_a, transpose_b, policy, out_shape, reg):
    """The SUMMA route.  Requested transposes materialise first."""
    if transpose_a:
        a = a.transpose()
    if transpose_b:
        b = b.transpose()
    ad, bd = _match_inner(a._data, b._data, False, False)
    out = summa_matmul(ad, bd, a._mesh, policy, overlap=_ov.resolve())
    return Array(_crop_or_keep(out, out_shape), out_shape, a._mesh, reg)


def _match_inner(ad, bd, transpose_a, transpose_b):
    """Equalize the padded contraction dims of the two backings (operands
    padded to different quanta)."""
    inner_a = ad.shape[0] if transpose_a else ad.shape[1]
    inner_b = bd.shape[1] if transpose_b else bd.shape[0]
    if inner_a != inner_b:
        pad_to = max(inner_a, inner_b)
        if transpose_a:
            ad = _grow(ad, (pad_to, ad.shape[1]))
        else:
            ad = _grow(ad, (ad.shape[0], pad_to))
        if transpose_b:
            bd = _grow(bd, (bd.shape[0], pad_to))
        else:
            bd = _grow(bd, (pad_to, bd.shape[1]))
    return ad, bd


def _grow(data: torch.Tensor, shape) -> torch.Tensor:
    """Place ``data`` on a zero canvas of ``shape`` (zero is exact in every
    policy dtype, so a padded tail never perturbs a contraction)."""
    if tuple(data.shape) == tuple(shape):
        return data
    canvas = torch.zeros(shape, dtype=data.dtype, device=data.device)
    canvas[: data.shape[0], : data.shape[1]] = data[: shape[0], : shape[1]]
    return canvas


def _crop_or_keep(padded, logical_shape):
    """The product of two quantum-padded operands is already
    quantum-padded for the output logical shape."""
    del logical_shape
    return padded
