"""Truncated SVD by Golub–Kahan–Lanczos bidiagonalisation.

Counterpart of ``dislib_tpu/decomposition/lanczos.py``: GEMVs on the padded
operand with full reorthogonalisation of both Lanczos bases, then the SVD
of the small bidiagonal matrix.
"""

from __future__ import annotations

import torch

from dislib_tpu_torch.data.array import Array
from dislib_tpu_torch.ops import precision as px


def lanczos_svd(a: Array, k: int = 6, bs: int | None = None,
                rank: int | None = None, num_iterations: int | None = None,
                tol: float = 1e-8, epsilon: float | None = None,
                max_num_iterations: int | None = None,
                singular_values: int | None = None, random_state=None,
                verbose: bool = False, precision=None):
    """Truncated SVD via Golub–Kahan–Lanczos bidiagonalisation.

    Returns (U, S, V): U (m, k), S (1, k), V (n, k).  ``singular_values``
    and ``rank`` are reference-parity aliases for ``k``.  The start vector
    is :func:`_start_vector`'s draw from ``random_state`` (a
    ``torch.Generator`` stream, not the reference's).

    ``precision``: mixed-precision policy (None → the
    ``DSLIB_MATMUL_PRECISION`` default) for the A·v / Aᵀ·u products;
    reorthogonalisation and the bidiagonal SVD stay float32 — bounds in
    ``ops/precision.ERROR_BOUNDS``.
    """
    del bs, tol, epsilon, max_num_iterations, verbose
    policy = px.resolve(precision)
    k = singular_values or rank or k
    m, n = a.shape
    steps = min(num_iterations or max(2 * k, k + 8), min(m, n))
    u, s, v = _gkl(px.f32(a._data), n, steps,
                   0 if random_state is None else random_state, policy)
    return (Array._from_logical(u[:m, :k].contiguous(), a._mesh),
            Array._from_logical(s[:k].reshape(1, -1), a._mesh),
            Array._from_logical(v[:n, :k].contiguous(), a._mesh))


def _start_vector(seed: int, n: int, device) -> torch.Tensor:
    """The Lanczos start vector's Gaussian draw, from a ``torch.Generator``
    seeded with ``seed``."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn((n,), generator=g, dtype=torch.float32, device=device)


@px.precise
def _gkl(a: torch.Tensor, n_valid: int, steps: int, seed: int,
         policy=px.FLOAT32):
    """``steps`` Lanczos steps on the padded operand: its pad rows/cols
    are zero, and the start vector is masked to the logical columns, so
    the pad entries of every Lanczos vector stay exactly zero."""
    m, n = a.shape
    dev = a.device
    v = _start_vector(seed, n, dev)
    v = v * (torch.arange(n, device=dev) < n_valid)
    v = v / torch.linalg.norm(v)
    vs = torch.zeros((n, steps), dtype=torch.float32, device=dev)
    us = torch.zeros((m, steps), dtype=torch.float32, device=dev)
    alphas = torch.zeros((steps,), dtype=torch.float32, device=dev)
    betas = torch.zeros((steps,), dtype=torch.float32, device=dev)
    u = torch.zeros((m,), dtype=torch.float32, device=dev)
    beta = torch.zeros((), dtype=torch.float32, device=dev)
    for j in range(steps):
        vs[:, j] = v
        u = px.pdot(a, v, policy) - beta * u
        # full reorthogonalisation (unfilled columns are zero)
        u = u - us @ (us.T @ u)
        alpha = torch.linalg.norm(u)
        u = u / torch.where(alpha < 1e-30, 1.0, alpha)
        us[:, j] = u
        alphas[j] = alpha
        w = px.pdot(a.T, u, policy) - alpha * v
        w = w - vs @ (vs.T @ w)
        beta = torch.linalg.norm(w)
        betas[j] = beta
        v = w / torch.where(beta < 1e-30, 1.0, beta)
    # bidiagonal B: alphas on the diagonal, betas[:-1] above it
    b = torch.diag(alphas) + torch.diag(betas[:-1], 1)
    ub, s, vbt = torch.linalg.svd(b)
    return us @ ub, s, vs @ vbt.T
