"""Gaussian mixture via EM.

Counterpart of ``dislib_tpu/cluster/gm.py``.  The EM loop runs on the
device as the reference's ``lax.while_loop`` does, through
:func:`runtime.loop.run_chunked`: masked EM steps in chunks, one read of
``converged`` after each chunk, stopping once ``|lb − prev_lb| < tol``.
An inactive step changes nothing, so the results equal the reference's
early-exiting loop.  ``fit`` reads the fitted parameters back in one
transfer at the end.

All four covariance types of the reference are supported: full, tied,
diag, spherical; with the ``kmeans`` or ``random`` initial
responsibilities, or explicit ``weights_init``/``means_init``/
``precisions_init``.  Padded rows carry weight 0 everywhere.  Everything
runs under :func:`~dislib_tpu_torch.ops.precision.precise` (TF32 off).

Where the port departs from the reference's code:

- ``fit`` runs :func:`_gm_fit` directly; the reference always goes through
  its ``ChunkedFitLoop``.  ``checkpoint=``/``health=`` raise
  ``NotImplementedError`` (ROADMAP.md A.12).  A ``SparseArray`` is
  densified through its budget-guarded lazy backing, as the reference's
  ``x._data`` is (``data/sparse.dense_input``).
- The ``kmeans`` init runs the port's KMeans device loop, whose E-step is
  the hand CUDA kernel ``distances_sq`` on a card, in KMeans' fast mode
  (the bf16-operand variant) when ``DSLIB_KMEANS_FAST_DISTANCE=1`` asks
  for it, as the reference's does.
- ``init_params="random"`` draws with :func:`_random_resp`, one named
  function (a ``torch.Generator``; the reference draws with
  ``jax.random.uniform``, which torch does not reproduce).
- The ``full`` type's per-component products, which the reference maps
  over the components with ``vmap`` (one (k, m, d) intermediate), loop
  over the components: one (m, d) intermediate at a time, 200 MB at
  1M × 50 in f32.
- ``torch.linalg.cholesky`` raises on a matrix that is not positive
  definite, where ``jnp.linalg.cholesky`` returns NaN: the port factors
  with :func:`~dislib_tpu_torch.ops.base.cholesky_nan`, which keeps the
  NaN, with no host sync.
- ``predict`` is the reference's fusion-graph node body, called eagerly.

``fit`` is ``_fit_finalize(_fit_async(x))``, the search's async-trial
hooks; ``_score_async`` is the mean log-likelihood as a device scalar.
"""

from __future__ import annotations

import numpy as np
import torch

from dislib_tpu_torch.base import BaseEstimator
from dislib_tpu_torch.cluster.kmeans import _crop, _to_host
from dislib_tpu_torch.data.array import Array, ensure_canonical
from dislib_tpu_torch.data.sparse import dense_input
from dislib_tpu_torch.ops.base import cholesky_nan, precise
from dislib_tpu_torch.runtime import health as _health
from dislib_tpu_torch.runtime.loop import run_chunked
from dislib_tpu_torch.utils.dlog import verbose_logger

_LOG2PI = float(np.log(2.0 * np.pi))
_COV_TYPES = ("full", "tied", "diag", "spherical")


class GaussianMixture(BaseEstimator):
    """Gaussian mixture model (reference parity: the reference's
    ``GaussianMixture``).

    Parameters
    ----------
    n_components : int, default 1
    covariance_type : 'full' | 'tied' | 'diag' | 'spherical'
    tol : float — convergence threshold on the lower-bound delta.
    reg_covar : float — ridge added to covariance diagonals.
    max_iter : int
    init_params : 'kmeans' | 'random'
    weights_init, means_init, precisions_init : optional explicit inits.
    arity : int — accepted, ignored.
    random_state : int or None
    verbose : bool — logs the fit's lower bound under ``dslib.gm``.

    Attributes
    ----------
    weights_, means_, covariances_ : ndarrays
    converged_ : bool ;  n_iter_ : int ;  lower_bound_ : float
    history_ : ndarray (n_iter_,) — per-iteration lower bound.
    """

    def __init__(self, n_components=1, covariance_type="full", tol=1e-3,
                 reg_covar=1e-6, max_iter=100, init_params="kmeans",
                 weights_init=None, means_init=None, precisions_init=None,
                 arity=50, random_state=None, verbose=False):
        self.n_components = n_components
        self.covariance_type = covariance_type
        self.tol = tol
        self.reg_covar = reg_covar
        self.max_iter = max_iter
        self.init_params = init_params
        self.weights_init = weights_init
        self.means_init = means_init
        self.precisions_init = precisions_init
        self.arity = arity
        self.random_state = random_state
        self.verbose = verbose

    # ------------------------------------------------------------------

    def _init_resp(self, x: Array) -> torch.Tensor:
        """Initial responsibilities (m_pad, k): hard KMeans labels or
        random."""
        k = self.n_components
        if self.init_params == "kmeans":
            from dislib_tpu_torch.cluster.kmeans import (KMeans, _kmeans_fit,
                                                         _kmeans_predict)
            km = KMeans(n_clusters=k, max_iter=10, tol=1e-4,
                        random_state=self.random_state)
            km._check_supported(x)
            centers = _kmeans_fit(x._data, x.shape, km._init_centers(x),
                                  10, 1e-4, fast=km._fast())[0]
            labels = _kmeans_predict(x._data, x.shape, centers)[:, 0]
            return torch.nn.functional.one_hot(labels.long(), k).to(
                torch.float32)
        if self.init_params == "random":
            seed = 0 if self.random_state is None else int(self.random_state)
            resp = _random_resp(seed, (x._data.shape[0], k), x.device)
            return resp / torch.sum(resp, dim=1, keepdim=True)
        raise ValueError(f"unsupported init_params {self.init_params!r}")

    def _check_params(self, x):
        if self.covariance_type not in _COV_TYPES:
            raise ValueError(f"bad covariance_type {self.covariance_type!r}")
        if self.max_iter < 1:
            raise ValueError("max_iter must be >= 1")

    def fit(self, x: Array, y=None, checkpoint=None, health=None):
        """Fit by EM on ``x``'s device; one read per chunk of EM steps and
        one at the end."""
        if checkpoint is not None or health is not None:
            raise NotImplementedError(
                "GaussianMixture.fit checkpoint=/health=: the ChunkedFitLoop"
                " is not ported yet (ROADMAP.md A.12)")
        self._fit_finalize(self._fit_async(x))
        return self

    # async trial protocol: the EM fit (the KMeans init included) runs on
    # the device; at tol > 0 its loops read their stop conditions once per
    # chunk of steps (runtime/loop.run_chunked, counted in HOST_READS),
    # where the reference's lax.while_loop reads nothing
    def _fit_async(self, x, y=None):
        self._check_params(x)
        x = dense_input(x, "GaussianMixture")
        return _gm_fit(x._data, x.shape, self._init_resp(x),
                       self.covariance_type, float(self.reg_covar),
                       float(self.tol), int(self.max_iter),
                       self._explicit_inits(x.device))

    def _fit_finalize(self, state):
        if state is None:
            return
        weights, means, covs, lb, n_iter, conv, hist, _ = _to_host(*state)
        self.weights_ = weights
        self.means_ = means
        self.covariances_ = covs
        self.lower_bound_ = float(lb)
        self.n_iter_ = int(n_iter)
        self.converged_ = bool(conv)
        self.history_ = np.asarray(hist[: self.n_iter_], dtype=np.float64)
        verbose_logger("gm", self.verbose).info(
            "iter %d: lower_bound=%.6g", self.n_iter_, self.lower_bound_)

    def _score_async(self, state, x, y=None):
        if state is None:
            return super()._score_async(state, x, y)
        return _gm_loglik(x._data, x.shape, state[0], state[1], state[2],
                          self.covariance_type)

    def _explicit_inits(self, device):
        """(weights, means, covs) overrides from the *_init parameters."""
        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        w = None if self.weights_init is None else dev(self.weights_init)
        mu = None if self.means_init is None else dev(self.means_init)
        covs = None
        if self.precisions_init is not None:
            p = np.asarray(self.precisions_init, np.float64)
            covs = dev(np.linalg.inv(p)) if self.covariance_type in \
                ("full", "tied") else dev(1.0 / p)
        return (w, mu, covs)

    def fit_predict(self, x: Array, y=None) -> Array:
        return self.fit(x).predict(x)

    def predict(self, x: Array) -> Array:
        """Component index per row, an (m, 1) int32 ds-array."""
        self._check_fitted()
        x = ensure_canonical(x)
        weights, means, covs = self._params_on(x.device)
        labels = _gm_predict(x._data, x.shape, weights, means, covs,
                             self.covariance_type)
        return Array._from_padded(labels, (x.shape[0], 1), x._mesh)

    def score(self, x: Array, y=None) -> float:
        """Mean per-sample log-likelihood under the fitted mixture."""
        self._check_fitted()
        return float(_gm_loglik(x._data, x.shape,
                                *self._params_on(x.device),
                                self.covariance_type))

    def _params_on(self, device):
        return self._predict_leaves(device, self.weights_, self.means_,
                                    self.covariances_)

    def _carry_in(self, arrays: dict, device):
        self.covariance_type = str(arrays.get("covariance_type",
                                            self.covariance_type))
        for name in ("weights_", "means_", "covariances_"):
            setattr(self, name, np.array(arrays[name], np.float32))

    def _check_fitted(self):
        if not hasattr(self, "means_"):
            raise RuntimeError("GaussianMixture is not fitted")


def _random_resp(seed, shape, device) -> torch.Tensor:
    """``init_params="random"``'s one draw: uniform [0, 1) of ``shape``
    from a ``torch.Generator`` seeded with ``seed`` (the reference draws
    ``jax.random.uniform(PRNGKey(seed), shape)``; the parity tests hand
    that draw in here)."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    return torch.rand(shape, generator=g, device=device)


# ---------------------------------------------------------------------------
# device functions
# ---------------------------------------------------------------------------

def _chol_precisions(covs, cov_type, d):
    """Cholesky factors of the precision matrices (sklearn-style): for
    ``full`` the (k, d, d) upper factors, batched; ``tied`` one (d, d);
    ``diag``/``spherical`` the inverse standard deviations."""
    if cov_type in ("full", "tied"):
        chol = cholesky_nan(covs)
        eye = torch.eye(d, dtype=covs.dtype, device=covs.device)
        return torch.linalg.solve_triangular(
            chol, eye.expand_as(chol), upper=False).mT
    return 1.0 / torch.sqrt(covs)


def _log_prob(xv, means, prec, cov_type, d):
    """log N(x | mu_k, Sigma_k) per row and component: (m, k)."""
    if cov_type == "full":
        # maha_ik = ‖x_i P_k − μ_k P_k‖², expanded (as in the reference)
        # so no (m, d) difference materialises; one component at a time,
        # so the GEMM z = x @ P_k is the only (m, d) intermediate
        cols = []
        for mu, pc in zip(means, prec):
            z = xv @ pc
            t = mu @ pc
            cols.append(torch.clamp_min(
                torch.sum(z * z, dim=1) - 2.0 * (z @ t) + t @ t, 0.0))
        maha = torch.stack(cols, dim=1)
        logdet = torch.sum(torch.log(torch.diagonal(prec, dim1=1, dim2=2)),
                           dim=1)
        return -0.5 * (d * _LOG2PI + maha) + logdet[None, :]
    if cov_type == "tied":
        y = xv @ prec
        mu_p = means @ prec
        maha = (torch.sum(y * y, dim=1)[:, None] - 2.0 * y @ mu_p.T
                + torch.sum(mu_p * mu_p, dim=1)[None, :])
        logdet = torch.sum(torch.log(torch.diagonal(prec)))
        return -0.5 * (d * _LOG2PI + maha) + logdet
    if cov_type == "diag":
        p2 = prec * prec
        maha = ((xv * xv) @ p2.T - 2.0 * xv @ (means * p2).T
                + torch.sum(means * means * p2, dim=1)[None, :])
        logdet = torch.sum(torch.log(prec), dim=1)
        return -0.5 * (d * _LOG2PI + maha) + logdet[None, :]
    p2 = prec * prec                                          # spherical
    sq = (torch.sum(xv * xv, dim=1)[:, None] - 2.0 * xv @ means.T
          + torch.sum(means * means, dim=1)[None, :])
    maha = sq * p2[None, :]
    logdet = d * torch.log(prec)
    return -0.5 * (d * _LOG2PI + maha) + logdet[None, :]


def _estimate_covs(xv, resp, nk, means, cov_type, reg_covar, w):
    """M-step covariance update; ``resp`` already includes the row mask."""
    d = xv.shape[1]
    eye = torch.eye(d, dtype=xv.dtype, device=xv.device)
    if cov_type == "full":
        # √r-weighted, as the reference: wd = √r_k (x − μ_k) makes the
        # covariance wdᵀwd, symmetric PSD by construction; one component's
        # (m, d) wd at a time
        covs = torch.empty((len(means), d, d), dtype=xv.dtype,
                           device=xv.device)
        for c in range(len(means)):
            wd = (xv - means[c][None, :]) * torch.sqrt(resp[:, c])[:, None]
            covs[c] = wd.T @ wd / nk[c] + reg_covar * eye
        return covs
    if cov_type == "tied":
        xw = xv * w[:, None]
        avg_x2 = xw.T @ xv
        avg_mu2 = (means * nk[:, None]).T @ means
        cov = (avg_x2 - avg_mu2) / torch.sum(nk)
        return cov + reg_covar * eye
    avg_x2 = resp.T @ (xv * xv) / nk[:, None]
    if cov_type == "diag":
        return avg_x2 - means * means + reg_covar
    return torch.mean(avg_x2 - means * means, dim=1) + reg_covar


def _e_step(xv, w, m, weights, means, covs, cov_type):
    """Responsibilities (m_pad, k) and the mean log-likelihood."""
    prec = _chol_precisions(covs, cov_type, xv.shape[1])
    logp = _log_prob(xv, means, prec, cov_type, xv.shape[1]) \
        + torch.log(weights)[None, :]
    lse = torch.logsumexp(logp, dim=1)
    return torch.exp(logp - lse[:, None]), torch.sum(lse * w) / m


@precise
def _gm_fit(xp, shape, resp0, cov_type, reg_covar, tol, max_iter,
            overrides=(None, None, None)):
    """EM on the padded backing ``xp`` of logical ``shape`` from the
    responsibilities ``resp0`` (or the explicit ``overrides``), until
    ``|lb − prev_lb| < tol`` or ``max_iter`` (the reference's ``cond``),
    in chunks of masked steps (:func:`run_chunked`).  Returns ``(weights,
    means, covs, lb, n_iter, converged, hist, hvec)`` as device tensors —
    the reference's 8-tuple."""
    m, n = shape
    xv, w = _crop(xp, shape)
    dev, dt = xv.device, xv.dtype

    def m_step(resp):
        resp = resp * w[:, None]
        nk = torch.sum(resp, dim=0) + 1e-10
        means = resp.T @ xv / nk[:, None]
        covs = _estimate_covs(xv, resp, nk, means, cov_type, reg_covar, w)
        return nk / m, means, covs

    weights, means, covs = (o if o is not None else v for o, v in
                            zip(overrides, m_step(resp0.to(dt))))
    lb = torch.full((), float("-inf"), dtype=dt, device=dev)
    conv = torch.zeros((), dtype=torch.bool, device=dev)
    n_iter = torch.zeros((), dtype=torch.int32, device=dev)
    hist = torch.zeros((max_iter,), dtype=dt, device=dev)

    def step(t):
        nonlocal weights, means, covs, lb, conv, n_iter
        active = ~conv
        resp, new_lb = _e_step(xv, w, m, weights, means, covs, cov_type)
        nw, nm, nc = m_step(resp)
        weights = torch.where(active, nw, weights)
        means = torch.where(active, nm, means)
        covs = torch.where(active, nc, covs)
        conv = torch.where(active, torch.abs(new_lb - lb) < tol, conv)
        lb = torch.where(active, new_lb, lb)
        hist[t] = torch.where(active, new_lb, hist[t])
        n_iter = n_iter + active.to(torch.int32)

    # |lb - prev_lb| < tol never holds at tol <= 0
    run_chunked(step, None if tol <= 0 else lambda: ~conv, max_iter, "gm")
    hvec = _health.health_vec(carries=(weights, means, covs), hist=hist,
                              n_done=n_iter, increasing=True)
    return weights, means, covs, lb, n_iter, conv, hist, hvec


@precise
def _gm_loglik(xp, shape, weights, means, covs, cov_type):
    xv, w = _crop(xp, shape)
    return _e_step(xv, w, shape[0], weights, means, covs, cov_type)[1]


@precise
def _gm_predict(xp, shape, weights, means, covs, cov_type):
    """``predict``'s body (the reference's fusion node): the most likely
    component per row as (m_pad, 1) int32, 0 on padded rows."""
    xv, w = _crop(xp, shape)
    prec = _chol_precisions(covs, cov_type, xv.shape[1])
    logp = _log_prob(xv, means, prec, cov_type, xv.shape[1]) \
        + torch.log(weights)[None, :]
    labels = torch.argmax(logp, dim=1).to(torch.int32)
    return (labels * w.to(torch.int32))[:, None].contiguous()
