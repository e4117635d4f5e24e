"""Polar decomposition by Newton–Schulz iteration.

Counterpart of ``dislib_tpu/math/polar.py``.  A = U H with U the closest
matrix with orthonormal columns and H = UᵀA symmetric PSD:

    X₀      = A / ‖A‖_F                      (spectrum scaled into (0, 1])
    G_k     = X_kᵀ X_k                        (one (n, n) Gram GEMM)
    X_{k+1} = 1.5·X_k − 0.5·X_k G_k           (one (m, n)×(n, n) GEMM)

Pure GEMM work through the precision policy.  The reference runs the loop
on the device; here each iteration reads its ‖G_k − I‖_max on the host
once to decide whether to go on, and stops at the same iteration as the
reference: an iteration whose error is within ``tol`` leaves X unchanged
and still counts.  The reported ``ortho_err`` is that of the returned U.
Pad rows/cols of the backing are zero and stay zero (σ = 0 is a fixed
point), so padding never perturbs the logical factors.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from dislib_tpu_torch.data.array import Array
from dislib_tpu_torch.ops import precision as px
from dislib_tpu_torch.utils.profiling import host_read

# orthogonality floors per policy: a tol below the compute dtype's
# reachable ‖XᵀX − I‖_max would burn max_iter on every call
_TOL_FLOOR = {"float32": 1e-6, "bfloat16": 5e-3}
_TOL_DEFAULT = {"float32": 1e-5, "bfloat16": 1e-2}


def polar(a: Array, precision=None, max_iter: int = 30,
          tol: float | None = None, info: bool = False):
    """Polar decomposition ``A = U @ H`` of a tall (m ≥ n) ds-array.

    Returns ``(U, H)`` — U (m, n) with orthonormal columns, H (n, n)
    symmetric PSD — or ``(U, H, info_dict)`` when ``info=True`` with
    ``{"iterations": k, "ortho_err": ‖UᵀU − I‖_max}``.

    ``tol``: convergence threshold on ‖X_kᵀX_k − I‖_max, defaulting per
    policy (1e-5 float32, 1e-2 bfloat16) and clamped to the policy's
    floor with a warning.  ``max_iter`` bounds the loop.
    """
    m, n = a.shape
    if m < n:
        raise ValueError(
            f"polar needs a tall or square array (m >= n), got {a.shape}; "
            "factorise a.T and transpose the identity A = (Uᵀ H)ᵀ = H Uᵀ "
            "for the left polar form")
    policy = px.resolve(precision)
    if tol is None:
        tol = _TOL_DEFAULT[policy.name]
    floor = _TOL_FLOOR[policy.name]
    if float(tol) < floor:
        warnings.warn(
            f"polar: tol={tol:g} is below the {policy.name} orthogonality "
            f"floor; clamping to {floor:g}", RuntimeWarning, stacklevel=2)
    tol = max(float(tol), floor)
    u_pad, h, iters, err = _polar_kernel(a._data, a.shape, policy,
                                         int(max_iter), tol)
    u_arr = Array._from_logical_padded(u_pad, (m, n), a._mesh, a._reg_shape)
    h_arr = Array._from_logical_padded(h, (n, n), a._mesh)
    if not info:
        return u_arr, h_arr
    return u_arr, h_arr, {"iterations": int(iters), "ortho_err": float(err)}


@px.precise
def _polar_kernel(ap: torch.Tensor, shape, policy, max_iter: int, tol):
    """The Newton–Schulz loop on the padded backing; one host read of the
    Gram error per iteration."""
    m, n = shape
    x = px.f32(ap)
    np_pad = x.shape[1]
    # the reference compares in float32: round tol the same way
    tol = float(np.float32(tol))
    # Frobenius norm over the padded canvas == over the logical block
    alpha = torch.sqrt(torch.sum(x * x))
    x = x / torch.clamp(alpha, min=1e-30)
    # pad-aware identity: ones only on the logical diagonal
    eye = torch.zeros((np_pad, np_pad), dtype=x.dtype, device=x.device)
    eye[:n, :n] = torch.eye(n, dtype=x.dtype, device=x.device)
    err, it = float("inf"), 0
    while err > tol and it < max_iter:
        g = px.pdot(x.T, x, policy)                       # Gram, (n, n)
        err = host_read(torch.max(torch.abs(g - eye)), "polar_iteration")
        # a converged x passes through unchanged
        if err > tol:
            x = 1.5 * x - 0.5 * px.pdot(x, g, policy)
        it += 1
    # report the RETURNED factor's error, not the pre-update iterate's
    g_final = px.pdot(x.T, x, policy)
    err = torch.max(torch.abs(g_final - eye))
    h = px.pdot(x.T, px.f32(ap), policy)                  # H = Uᵀ A
    h = 0.5 * (h + h.T)                                   # exact symmetry
    return x, h, it, err
