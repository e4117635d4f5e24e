"""Mixed-precision policy — the ONE place the port's kernels get compute dtypes.

Counterpart of ``dislib_tpu/ops/precision.py``.  The policy table
(:class:`Policy`, :data:`FLOAT32`, :data:`BFLOAT16`), the documented error
bounds (:data:`ERROR_BOUNDS`) and the selection rule (:func:`resolve`,
``DSLIB_MATMUL_PRECISION`` and its aliases) are copied verbatim: the port is
held to the reference's own contract, so the two tables must never drift.

- ``float32`` (default): operands contract at float32-faithful precision.
  On an NVIDIA card that means no single-pass TF32 product: :func:`precise`
  turns ``torch.backends.cuda.matmul.allow_tf32`` and
  ``torch.backends.cudnn.allow_tf32`` off for its scope, and the hand
  ``panel_gemm`` kernel runs the 3xTF32 split (``ops/kernels.py``).
- ``bfloat16``: GEMM operands are rounded to bfloat16 and contracted with
  float32 accumulation, as the reference contracts them with
  ``preferred_element_type=float32``.  On CUDA tensors :func:`pdot` and
  :func:`peinsum` run that product natively: bf16 operands on the tensor
  cores with a float32 result (``torch.mm``/``torch.bmm`` with
  ``out_dtype=torch.float32``; a bf16 *result* would round the sums).  CPU
  torch has no such product (``aten::mm.dtype``), so CPU tensors upcast
  the rounded operands and contract in f32 with TF32 off: the product of
  two bf16 values is exact in f32, so that is the same function.
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


def of_name(name: str) -> Policy:
    """Policy from its canonical name (``"float32"`` | ``"bfloat16"``)."""
    return _POLICIES[name]


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


def _bf16_native(a: torch.Tensor, b: torch.Tensor, policy: Policy) -> bool:
    """Whether a policy product of the rounded ``a`` and ``b`` runs as a
    native bf16 product with a float32 result (CUDA, BFLOAT16)."""
    return (policy.compute == "bfloat16" and a.device.type == "cuda"
            and a.dtype == b.dtype == torch.bfloat16)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) @ (k, n) of bf16 CUDA operands, f32 result."""
    return torch.mm(a, b, out_dtype=torch.float32)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched (B, m, k) @ (B, k, n) of bf16 CUDA operands, f32 result."""
    return torch.bmm(a, b, out_dtype=torch.float32)


def _matmul_f32_out(a: torch.Tensor, b: torch.Tensor, mm=_mm_f32,
                    bmm=_bmm_f32) -> torch.Tensor:
    """``torch.matmul(a, b)`` with a float32 result, through ``mm``/``bmm``
    (``torch.matmul`` takes no ``out_dtype``): 1-D operands are lifted to
    a row or a column, batch dimensions broadcast and flatten into one.
    ``mm`` and ``bmm`` are the products (a test hands in CPU ones)."""
    vec_a, vec_b = a.dim() == 1, b.dim() == 1
    a = a[None] if vec_a else a
    b = b[:, None] if vec_b else b
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    (m, k), n = a.shape[-2:], b.shape[-1]
    if not batch:
        out = mm(a, b)
    else:
        out = bmm(a.expand(*batch, m, k).reshape(-1, m, k),
                  b.expand(*batch, k, n).reshape(-1, k, n)).reshape(
                      *batch, m, n)
    if vec_a:
        out = out.squeeze(-2)
    if vec_b:
        out = out.squeeze(-1)
    return out


def _einsum_as_bmm(subscripts: str, a: torch.Tensor, b: torch.Tensor,
                   bmm=_bmm_f32) -> torch.Tensor:
    """A two-operand einsum written as one batched product: indices in
    both operands and the output batch, in both and not the output
    contract, the rest are each operand's free indices.  Each operand is
    permuted to (batch, free, contracted) / (batch, contracted, free) and
    flattened, and the result permuted to the output's order."""
    ins, out = subscripts.replace(" ", "").split("->")
    sa, sb = ins.split(",")
    if len(set(sa)) != len(sa) or len(set(sb)) != len(sb) \
            or any(c not in sa + sb for c in out):
        raise ValueError(f"peinsum: {subscripts!r} is not a batched "
                         "product of two operands")
    batch = [c for c in sa if c in sb and c in out]
    contr = [c for c in sa if c in sb and c not in out]
    free_a = [c for c in sa if c not in sb]
    free_b = [c for c in sb if c not in sa]
    if sorted(out) != sorted(batch + free_a + free_b):
        raise ValueError(f"peinsum: {subscripts!r} sums an index of one "
                         "operand only")
    size = {**dict(zip(sa, a.shape)), **dict(zip(sb, b.shape))}

    def prod(cs):
        p = 1
        for c in cs:
            p *= size[c]
        return p

    a3 = a.permute([sa.index(c) for c in batch + free_a + contr]).reshape(
        prod(batch), prod(free_a), prod(contr))
    b3 = b.permute([sb.index(c) for c in batch + contr + free_b]).reshape(
        prod(batch), prod(contr), prod(free_b))
    res = bmm(a3, b3).reshape([size[c] for c in batch + free_a + free_b])
    order = batch + free_a + free_b
    return res.permute([order.index(c) for c in out])


def pdot(a: torch.Tensor, b: torch.Tensor,
         policy: Policy = FLOAT32) -> torch.Tensor:
    """THE library GEMM: operands rounded to the policy compute dtype,
    contracted with float32 accumulation (float64 for float64 operands
    under the float32 floor).  Output dtype is the accumulation dtype.
    BFLOAT16 on CUDA tensors is one native bf16 product with a float32
    result; everything else contracts in the accumulation dtype with TF32
    off."""
    a = to_compute(a, policy)
    b = to_compute(b, policy)
    if _bf16_native(a, b, policy):
        return _matmul_f32_out(a, b)
    acc = result_dtype(a, b, policy)
    with _f32_scope():
        return torch.matmul(a.to(acc), b.to(acc))


def peinsum(subscripts: str, a: torch.Tensor, b: torch.Tensor,
            policy: Policy = FLOAT32) -> torch.Tensor:
    """The policy-routed einsum — :func:`pdot` for contractions a plain
    matmul cannot spell (the block-Jacobi SVD's batched pair updates).
    Same contract as :func:`pdot`: operands rounded to the policy compute
    dtype, contracted in the accumulation dtype with TF32 off, or under
    BFLOAT16 on CUDA as one native batched bf16 product with a float32
    result (:func:`_einsum_as_bmm`)."""
    a = to_compute(a, policy)
    b = to_compute(b, policy)
    if _bf16_native(a, b, policy):
        return _einsum_as_bmm(subscripts, a, b)
    acc = result_dtype(a, b, policy)
    with _f32_scope():
        return torch.einsum(subscripts, a.to(acc), b.to(acc))
