"""Consensus ADMM.

Counterpart of ``dislib_tpu/optimization/admm.py``.  The reference's
agents are the mesh's row shards, one ``shard_map`` with ``pmean``/``psum``
over them.  Here the ``p`` agents are a leading batch dimension on one
device, as ``decomposition/tsqr._tsqr_shardmap`` does: the padded rows of
(x, y) split into ``p`` equal contiguous blocks (the reference's row
sharding; zero pad rows are inert), and per iteration

    local:      x_i = (A_iᵀA_i + ρI)⁻¹ (A_iᵀb_i + ρ(z − u_i))   (a batched
                Cholesky of the (p, n, n) systems, factorised once)
    consensus:  z̄ = mean_i(x_i + u_i),  z = prox(z̄)
    local:      u_i += x_i − z

with the primal and dual residuals summed over the agents.  The loop
stops on the reference's test (both residuals under their tolerances)
through :func:`runtime.loop.run_chunked`: masked steps in chunks, one
read per chunk.  ``p`` is the port mesh's rows (:func:`_agents`: 1 on
one card).

Across ranks each mesh row is one agent, as the reference's row shards
are: a rank holds its rows (its blocks all-gathered over 'cols', none on
a one-column mesh) as a batch of one.  Per iteration ``Σ_i(x_i + u_i)``
is one ``psum`` over 'rows' (z̄ its mean), and the residuals' three sums
(``Σ‖x_i − z‖²``, ``Σ‖x_i‖²``, ``Σ‖ρu_i‖²``) a second, packed one: they
need the new z, and summing them directly keeps each as the one-card
batch sums it (the one-psum form ``Σ‖x_i‖² − 2z·Σx_i + p‖z‖²`` cancels in
float32 near convergence, where the stop test reads it).  So every rank
computes the same residuals and stops at the same step.  Everything runs
under
:func:`~dislib_tpu_torch.ops.precision.precise` (TF32 off).  ``fit`` is
``_fit_finalize(_fit_async(x, y))``, the search's async-trial hooks.
"""

from __future__ import annotations

import numpy as np
import torch

from dislib_tpu_torch.base import BaseEstimator
from dislib_tpu_torch.cluster.kmeans import _to_host
from dislib_tpu_torch.data.array import Array
from dislib_tpu_torch.data.sparse import dense_input
from dislib_tpu_torch.ops.base import cholesky_nan, precise
from dislib_tpu_torch.parallel import distributed as _dist
from dislib_tpu_torch.parallel import mesh as _mesh
from dislib_tpu_torch.runtime.loop import run_chunked
from dislib_tpu_torch.utils.dlog import verbose_logger


def soft_threshold(v, k):
    """Soft-thresholding operator S_k(v) — the L1 prox."""
    return torch.sign(v) * torch.clamp_min(torch.abs(v) - k, 0.0)


def identity_prox(v, k):
    return v


def _agents() -> int:
    """The consensus agents: the default mesh's rows, as the reference's
    row shards."""
    return _mesh.mesh_shape()[0]


def _agents_of(mesh) -> int:
    """The agents of a fit on an array on ``mesh``: its rows across
    ranks, :func:`_agents` on one rank."""
    return mesh.rows if mesh.world > 1 else _agents()


class ADMM(BaseEstimator):
    """Generic consensus ADMM driver.

    Parameters
    ----------
    z_prox : callable(z_mean, kappa) -> z — the global prox step on torch
        tensors (identity if None), e.g. :func:`soft_threshold`.
    prox_kappa : float — scalar handed to ``z_prox`` (e.g. the L1
        threshold).
    rho : float — augmented-Lagrangian penalty.
    max_iter, abstol, reltol : convergence controls.

    Attributes
    ----------
    z_ : ndarray (n_features,) — consensus solution.
    n_iter_ : int ;  converged_ : bool
    history_ : ndarray (n_iter_,) — per-iteration primal residual.
    """

    def __init__(self, z_prox=None, prox_kappa=0.0, rho=1.0, max_iter=100,
                 abstol=1e-4, reltol=1e-2, verbose=False):
        self.z_prox = z_prox
        self.prox_kappa = prox_kappa
        self.rho = rho
        self.max_iter = max_iter
        self.abstol = abstol
        self.reltol = reltol
        self.verbose = verbose

    def fit(self, x: Array, y: Array):
        """Solve consensus least-squares + prox over row blocks of
        (x, y)."""
        self._fit_finalize(self._fit_async(x, y))
        return self

    # async trial protocol: the handle is the loop's device outputs; at
    # tolerances > 0 the loop reads its stop condition once per chunk of
    # steps (runtime/loop.run_chunked, counted in HOST_READS), where the
    # reference's lax.while_loop reads nothing
    def _fit_async(self, x: Array, y: Array):
        # a SparseArray densifies through its budget-guarded lazy
        # backing, as the reference's x._data does
        x, y = dense_input(x, "ADMM"), dense_input(y, "ADMM")
        if y.shape[1] != 1:
            raise ValueError(
                f"ADMM supports a single target column; y is {y.shape}")
        if x.shape[0] != y.shape[0]:
            raise ValueError(f"x and y row counts differ: {x.shape[0]} != "
                             f"{y.shape[0]}")
        prox = self.z_prox if self.z_prox is not None else identity_prox
        return _admm_fit(x._row_block(), y._row_block(), x.shape,
                         float(self.rho), float(self.prox_kappa),
                         float(self.abstol), float(self.reltol),
                         int(self.max_iter), prox, _agents_of(x._mesh),
                         x._mesh)

    def _carry_in(self, arrays: dict, device):
        self.z_ = np.array(arrays["z_"], np.float32).ravel()

    def _fit_finalize(self, state):
        if state is None:
            return
        z, n_iter, conv, hist = _to_host(*state)
        self.z_ = z.ravel()
        self.n_iter_ = int(n_iter)
        self.converged_ = bool(conv)
        self.history_ = np.asarray(hist[: self.n_iter_], dtype=np.float64)
        verbose_logger("admm", self.verbose).info(
            "converged=%s n_iter=%d primal_residual=%.3g", self.converged_,
            self.n_iter_, self.history_[-1] if len(self.history_) else np.nan)


@precise
def _admm_fit(xp, yp, x_shape, rho, kappa, abstol, reltol, max_iter, prox,
              p, mesh):
    """Consensus ADMM over ``p`` contiguous row blocks of the padded
    backings.  Returns ``(z, n_iter, converged, hist)`` as device
    tensors — the reference's 4-tuple.  On a ``mesh`` of several ranks
    ``xp``/``yp`` are this rank's rows, the one agent of its mesh row; the
    sums over the agents are ``psum`` calls over 'rows' (the identity
    with no process group)."""
    n = x_shape[1]
    xv, yv = xp[:, :n], yp[:, :1]
    q = p // mesh.rows                  # the agents this rank holds
    rows = max(q, -(-xv.shape[0] // q) * q)     # the mesh's row padding
    a = torch.nn.functional.pad(xv, (0, 0, 0, rows - xv.shape[0]))
    b = torch.nn.functional.pad(yv, (0, 0, 0, rows - yv.shape[0]))
    a = a.reshape(q, rows // q, n)
    b = b.reshape(q, rows // q, 1)

    def agents_sum(t):
        """``t`` (agents, ...) summed over every agent, on every rank."""
        return _dist.psum(torch.sum(t, dim=0), _mesh.ROWS, mesh)

    dev, dt = a.device, a.dtype
    # each agent's Cholesky factor of (A_iᵀA_i + ρI), once.  One product
    # an agent: on an H100 the batched product of 4 agents of 250000 rows
    # put their Grams 7.3e-5 off float64, a plain product 6.6e-7
    # (tools/torch_admm_diag.py)
    gram = torch.stack([ai.T @ ai for ai in a])
    chol = cholesky_nan(gram + rho * torch.eye(n, dtype=dt, device=dev))
    atb = torch.stack([(ai.T @ bi)[:, 0] for ai, bi in zip(a, b)])  # (q, n)

    def solve(rhs):
        w = torch.linalg.solve_triangular(chol, rhs[..., None], upper=False)
        return torch.linalg.solve_triangular(chol.mT, w, upper=True)[..., 0]

    sq_np = float(np.sqrt(n * p))
    sq_p = float(np.sqrt(p))
    x_i = torch.zeros((q, n), dtype=dt, device=dev)
    u_i = torch.zeros((q, n), dtype=dt, device=dev)
    z = torch.zeros((n,), dtype=dt, device=dev)
    conv = torch.zeros((), dtype=torch.bool, device=dev)
    n_iter = torch.zeros((), dtype=torch.int32, device=dev)
    hist = torch.zeros((max_iter,), dtype=dt, device=dev)

    def step(t):
        nonlocal x_i, u_i, z, conv, n_iter
        active = ~conv
        nx = solve(atb + rho * (z[None, :] - u_i))
        nz = prox(agents_sum(nx + u_i) / p, kappa)      # the pmean
        nu = u_i + nx - nz
        # residuals: per-agent sums, then summed over the agents (psum)
        r2, x2, u2 = agents_sum(torch.stack([
            torch.sum((nx - nz[None, :]) ** 2, dim=1),
            torch.sum(nx ** 2, dim=1),
            torch.sum((rho * nu) ** 2, dim=1)], dim=1)).unbind()
        r = torch.sqrt(r2)
        s = rho * sq_p * torch.linalg.norm(nz - z)
        e_pri = sq_np * abstol + reltol * torch.maximum(
            torch.sqrt(x2), sq_p * torch.linalg.norm(nz))
        e_dual = sq_np * abstol + reltol * torch.sqrt(u2)
        x_i = torch.where(active, nx, x_i)
        u_i = torch.where(active, nu, u_i)
        z = torch.where(active, nz, z)
        conv = torch.where(active, (r < e_pri) & (s < e_dual), conv)
        hist[t] = torch.where(active, r, hist[t])
        n_iter = n_iter + active.to(torch.int32)

    # with both tolerances <= 0 the residuals are never under them
    run_chunked(step, None if abstol <= 0 and reltol <= 0 else lambda: ~conv,
                max_iter, "admm")
    return z, n_iter, conv, hist
