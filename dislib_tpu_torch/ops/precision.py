"""Mixed-precision policy — the ONE place the port's kernels get compute dtypes.

Counterpart of ``dislib_tpu/ops/precision.py``.  The policy table
(:class:`Policy`, :data:`FLOAT32`, :data:`BFLOAT16`), the documented error
bounds (:data:`ERROR_BOUNDS`) and the selection rule (:func:`resolve`,
``DSLIB_MATMUL_PRECISION`` and its aliases) are copied verbatim: the port is
held to the reference's own contract, so the two tables must never drift.

- ``float32`` (default): operands contract at float32-faithful precision.
  On an NVIDIA card that means no TF32 tensor-core passes: :func:`precise`
  turns ``torch.backends.cuda.matmul.allow_tf32`` and
  ``torch.backends.cudnn.allow_tf32`` off for its scope.
- ``bfloat16``: GEMM operands are rounded to bfloat16 and contracted with
  float32 accumulation.  The product of two bf16 values is exact in f32,
  so upcasting the rounded operands and contracting in f32 is the same
  function as a bf16-in / f32-accumulate tensor-core GEMM.
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import NamedTuple

import torch


class Policy(NamedTuple):
    """A compute/accumulate precision pair for library GEMMs."""

    name: str             # canonical policy name ("float32" | "bfloat16")
    compute: str          # dtype operands are rounded to for GEMM passes
    accum: str            # accumulation dtype (always float32)
    dot_precision: str | None  # lax precision for f32-operand dots


FLOAT32 = Policy("float32", "float32", "float32", "highest")
BFLOAT16 = Policy("bfloat16", "bfloat16", "float32", None)

_POLICIES = {"float32": FLOAT32, "bfloat16": BFLOAT16}
_ALIASES = {
    "float32": "float32", "f32": "float32", "fp32": "float32",
    "highest": "float32",
    "bfloat16": "bfloat16", "bf16": "bfloat16",
}

# Copied verbatim from the reference: max_ij |C - C_ref| /
# (||A||_F ||B||_F / sqrt(k)) for "matmul", and the factorisation bounds the
# later slices are held to.
ERROR_BOUNDS = {
    ("matmul", "bfloat16"): 2e-2,
    ("qr_orth", "bfloat16"): 4e-2,
    ("qr_resid", "bfloat16"): 2e-2,
    ("tsqr_orth", "bfloat16"): 4e-2,
    ("tsqr_resid", "bfloat16"): 2e-2,
    ("randomsvd_values", "bfloat16"): 2e-2,
    ("lanczos_values", "bfloat16"): 1e-1,
    ("polar_orth", "bfloat16"): 5e-2,
    ("polar_resid", "bfloat16"): 3e-2,
    ("svd_values", "bfloat16"): 2e-2,
    ("svd_resid", "bfloat16"): 4e-2,
    ("matmul", "float32"): 1e-6,
    ("qr_orth", "float32"): 1e-4,
    ("qr_resid", "float32"): 1e-5,
    ("tsqr_orth", "float32"): 1e-4,
    ("tsqr_resid", "float32"): 1e-5,
    ("randomsvd_values", "float32"): 1e-4,
    ("lanczos_values", "float32"): 1e-2,
    ("polar_orth", "float32"): 1e-4,
    ("polar_resid", "float32"): 1e-4,
    ("svd_values", "float32"): 1e-4,
    ("svd_resid", "float32"): 1e-4,
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve(precision=None) -> Policy:
    """The library's ONE precision-selection rule.

    ``precision`` may be a :class:`Policy`, a name/alias (``"float32"``,
    ``"f32"``, ``"bfloat16"``, ``"bf16"``), or None — None reads
    ``DSLIB_MATMUL_PRECISION`` (same aliases) and falls back to float32.
    """
    if precision is None:
        precision = os.environ.get("DSLIB_MATMUL_PRECISION") or "float32"
    if isinstance(precision, Policy):
        return precision
    key = _ALIASES.get(str(precision).lower())
    if key is None:
        raise ValueError(
            f"unknown precision policy {precision!r}: expected one of "
            f"{sorted(set(_ALIASES))} (or a dislib_tpu_torch.ops.precision"
            ".Policy)")
    return _POLICIES[key]


def compute_dtype(policy: Policy) -> torch.dtype:
    return _DTYPES[policy.compute]


def accum_dtype(policy: Policy) -> torch.dtype:
    return _DTYPES[policy.accum]


def to_compute(x: torch.Tensor, policy: Policy = FLOAT32) -> torch.Tensor:
    """Round an operand to the policy's GEMM compute dtype.  The float32
    policy is a floor, not a ceiling: float64 operands pass through
    untouched.  The bfloat16 policy rounds every float input, float64
    included."""
    dt = compute_dtype(policy)
    if policy.name == "float32" and x.dtype == torch.float64:
        return x
    return x if x.dtype == dt else x.to(dt)


def f32(x: torch.Tensor) -> torch.Tensor:
    """Pin an operand to exactly float32 (a ceiling, unlike
    :func:`to_compute`'s float32 policy)."""
    return x if x.dtype == torch.float32 else x.to(torch.float32)


def result_dtype(a: torch.Tensor, b: torch.Tensor,
                 policy: Policy) -> torch.dtype:
    """Accumulation dtype of a policy GEMM over already-rounded operands:
    the policy's accumulation dtype promoted with the operand dtypes
    (float32; float64 for float64 operands under the float32 floor)."""
    return torch.promote_types(accum_dtype(policy),
                               torch.promote_types(a.dtype, b.dtype))


@contextlib.contextmanager
def _f32_scope():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def precise(fn=None):
    """The float32-faithful scope: TF32 off for cuBLAS and cuDNN while it
    is active, the caller's settings restored after.

    ``with precise(): ...`` scopes a block; ``@precise`` wraps a function.
    """
    if fn is None:
        return _f32_scope()

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with _f32_scope():
            return fn(*args, **kwargs)
    return wrapped


def pdot(a: torch.Tensor, b: torch.Tensor,
         policy: Policy = FLOAT32) -> torch.Tensor:
    """THE library GEMM: operands rounded to the policy compute dtype,
    contracted with float32 accumulation (float64 for float64 operands
    under the float32 floor).  Output dtype is the accumulation dtype."""
    a = to_compute(a, policy)
    b = to_compute(b, policy)
    acc = result_dtype(a, b, policy)
    with _f32_scope():
        return torch.matmul(a.to(acc), b.to(acc))
