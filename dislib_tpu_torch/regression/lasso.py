"""Lasso via consensus ADMM.

Counterpart of ``dislib_tpu/regression/lasso.py``: delegates to
:class:`dislib_tpu_torch.optimization.ADMM` with the L1 soft-threshold
prox, ``kappa = lmbd / (rho · p)`` with ``p`` the port mesh's rows (the
global objective carries λ once; each agent contributes ρ).  ``predict``
goes through the port's ``matmul``; ``score`` is the R² shared with
``LinearRegression``.
"""

from __future__ import annotations

import numpy as np
import torch

from dislib_tpu_torch.base import BaseEstimator
from dislib_tpu_torch.data.array import Array
from dislib_tpu_torch.optimization import admm as _admm
from dislib_tpu_torch.regression.linear import _r2_score


class Lasso(BaseEstimator):
    """L1-regularised least squares:  (1/2)‖Xw − y‖² + λ‖w‖₁.

    Attributes
    ----------
    coef_ : ndarray (n_features,)
    n_iter_ : int ;  converged_ : bool
    """

    def __init__(self, lmbd=1.0, rho=1.0, max_iter=100, atol=1e-4, rtol=1e-2):
        self.lmbd = lmbd
        self.rho = rho
        self.max_iter = max_iter
        self.atol = atol
        self.rtol = rtol

    def _admm(self):
        kappa = float(self.lmbd) / (float(self.rho) * _admm._agents())
        return _admm.ADMM(z_prox=_admm.soft_threshold, prox_kappa=kappa,
                          rho=self.rho, max_iter=self.max_iter,
                          abstol=self.atol, reltol=self.rtol)

    def fit(self, x: Array, y: Array):
        self._fit_finalize(self._fit_async(x, y))
        return self

    # async trial protocol: ADMM's device handle
    def _fit_async(self, x, y=None):
        if y is None:
            raise ValueError("Lasso requires y")
        admm = self._admm()
        return (admm, admm._fit_async(x, y))

    def _fit_finalize(self, state):
        if state is None:
            return
        admm, admm_state = state
        admm._fit_finalize(admm_state)
        self.coef_ = admm.z_
        self.n_iter_ = admm.n_iter_
        self.converged_ = admm.converged_

    def _score_async(self, state, x, y=None):
        if state is None:
            return super()._score_async(state, x, y)
        coef = state[1][0].reshape(-1, 1)         # the device consensus z
        return _r2_score(x._data, y._data, x.shape, y.shape, coef,
                         torch.zeros((1,), dtype=coef.dtype,
                                     device=coef.device))

    def predict(self, x: Array) -> Array:
        """x @ coef_ through ``matmul``, (m, 1); the weight ds-array is
        cached by the identity of ``coef_``."""
        self._check_fitted()
        from dislib_tpu_torch.math import matmul
        cached = getattr(self, "_w_cache", None)
        if cached is None or cached[0] is not self.coef_ \
                or cached[1].device != x.device:
            w = Array._from_logical(
                torch.as_tensor(np.asarray(self.coef_, np.float32)
                                .reshape(-1, 1)), x._mesh)
            self._w_cache = (self.coef_, w)
        return matmul(x, self._w_cache[1])

    def score(self, x: Array, y: Array) -> float:
        """R² (sklearn convention), computed on the device."""
        self._check_fitted()
        coef = torch.as_tensor(np.asarray(self.coef_, np.float32),
                               device=x.device).reshape(-1, 1)
        return float(_r2_score(x._data, y._data, x.shape, y.shape, coef,
                               torch.zeros((1,), device=x.device)))

    def _carry_in(self, arrays: dict, device):
        self.coef_ = np.array(arrays["coef_"], np.float32).ravel()

    def _check_fitted(self):
        if not hasattr(self, "coef_"):
            raise RuntimeError("Lasso is not fitted")
