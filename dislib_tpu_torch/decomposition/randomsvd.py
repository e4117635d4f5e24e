"""Randomized SVD.

Counterpart of ``dislib_tpu/decomposition/randomsvd.py``: a Gaussian test
matrix, power iterations with tsQR re-orthonormalisation, a small dense SVD
of the projected matrix, and the back-multiplication.  A float32 dense
Array takes the fused path (:func:`_random_svd_fused`, the whole pipeline
on the padded backing with no intermediate ds-arrays); anything else the
composed path through ``matmul`` and ``tsqr``.  Both start from the one
draw :func:`_omega_of`.
"""

from __future__ import annotations

import numpy as np
import torch

from dislib_tpu_torch.data.array import Array, _repad
from dislib_tpu_torch.decomposition.tsqr import (tsqr, _tsqr_shardmap,
                                                 _use_cholqr)
from dislib_tpu_torch.math.base import matmul
from dislib_tpu_torch.ops import precision as px


def random_svd(a: Array, iters: int = 2, epsilon: float | None = None,
               tol: float = 1e-3, nsv: int | None = None,
               k: int | None = None, oversample: int = 10,
               random_state=None, verbose: bool = False, precision=None):
    """Truncated randomized SVD of ``a``.

    Returns (U, S, V) with U (m, nsv), S (1, nsv), V (n, nsv); the sketch
    is nsv + ``oversample`` wide.  ``random_state`` seeds the test matrix
    (:func:`_omega_of`, drawn by ``torch.Generator``: the same seed gives
    the same result in this package, not the reference's draw).

    ``precision``: mixed-precision policy (None → the
    ``DSLIB_MATMUL_PRECISION`` default) for the sketch, power-iteration,
    projection and back-multiplication GEMMs; the tsQR
    re-orthonormalisations are pinned to FLOAT32 explicitly, and the
    small SVD runs in float32 — bounds in ``ops/precision.ERROR_BOUNDS``.
    """
    del epsilon, tol, verbose
    policy = px.resolve(precision)
    m, n = a.shape
    nsv = nsv if nsv is not None else (k if k is not None else min(m, n, 6))
    sketch = min(n, nsv + oversample)
    nsv = min(nsv, sketch)  # only `sketch` directions exist in the subspace
    seed = 0 if random_state is None else int(np.random.RandomState(
        random_state).randint(2**31 - 1)) \
        if not isinstance(random_state, (int, np.integer)) \
        else int(random_state)
    mesh = a._mesh

    if type(a) is Array and m >= sketch and a.dtype == torch.float32:
        u_log, s, vt = _random_svd_fused(
            a._data, _omega_of(seed, n, sketch, a.device), a.shape, iters,
            sketch, nsv, mesh, mesh.rows, cholqr=_use_cholqr(a.device),
            policy=policy)
        u = Array._from_logical_padded(_repad(u_log, (m, nsv), mesh),
                                       (m, nsv), mesh)
        v = Array._from_logical(vt.T[:, :nsv].contiguous(), mesh)
        return u, Array._from_logical(s[:nsv].reshape(1, -1), mesh), v

    omega = Array._from_logical(_omega_of(seed, n, sketch, a.device), mesh)
    # the orthonormalisations are pinned FLOAT32 explicitly, so an ambient
    # DSLIB_MATMUL_PRECISION never leaks into them
    y = matmul(a, omega, precision=policy)                  # (m, sketch)
    q, _ = tsqr(y, precision=px.FLOAT32) if m >= sketch else _qr_fallback(y)
    for _ in range(iters):
        z = matmul(a, q, transpose_a=True, precision=policy)    # (n, sketch)
        qz, _ = tsqr(z, precision=px.FLOAT32) if n >= sketch \
            else _qr_fallback(z)
        y = matmul(a, qz, precision=policy)
        q, _ = tsqr(y, precision=px.FLOAT32) if m >= sketch \
            else _qr_fallback(y)
    b = matmul(q, a, transpose_a=True, precision=policy)    # (sketch, n)
    bv = px.f32(b._data[: b.shape[0], : b.shape[1]])
    with px.precise():
        ub, s, vt = torch.linalg.svd(bv, full_matrices=False)
    u = matmul(q, Array._from_logical(ub, mesh), precision=policy)
    u = u[:, :nsv]
    v = Array._from_logical(vt.T[:, :nsv].contiguous(), mesh)
    return u, Array._from_logical(s[:nsv].reshape(1, -1), mesh), v


@px.precise
def _random_svd_fused(a_pad, omega, a_shape, iters, sketch, nsv, mesh, p,
                      *, cholqr, policy=px.FLOAT32):
    """Sketch, power iterations, projection and SVD on the padded backing.
    Its zero pad rows/cols add nothing to any GEMM, and tsQR's Q rows at
    zero input rows are zero for a full-rank sketch, so the logical crop
    of U is exact."""
    m, n = a_shape
    av = px.f32(a_pad[:, :n])

    def ortho(y):
        # rows must be ≥ sketch per shard and divisible by p
        rows = y.shape[0]
        target = max(p * sketch, -(-rows // p) * p)
        if target != rows:
            y = torch.nn.functional.pad(y, (0, 0, 0, target - rows))
        q, _ = _tsqr_shardmap(y, mesh, p, cholqr=cholqr, policy=px.FLOAT32)
        return q[:rows]

    q = ortho(px.pdot(av, omega, policy))
    for _ in range(iters):
        qz = ortho(px.pdot(av.T, q, policy))
        q = ortho(px.pdot(av, qz, policy))
    b = px.pdot(q.T, av, policy)                           # (sketch, n)
    ub, s, vt = torch.linalg.svd(b, full_matrices=False)
    u = px.pdot(q, ub[:, :nsv], policy)                    # (mp, nsv)
    return u[:m], s, vt


def _omega_of(seed: int, n: int, sketch: int, device) -> torch.Tensor:
    """The Gaussian test matrix — the one draw both paths share.  It draws
    from a ``torch.Generator`` seeded with ``seed``, not the reference's
    threefry stream."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn((n, sketch), generator=g, dtype=torch.float32,
                       device=device)


def _qr_fallback(y: Array):
    from dislib_tpu_torch.math.qr import qr as _qr
    # pinned float32 like the tsqr orthonormalisations
    return _qr(y, mode="economic", precision=px.FLOAT32)
