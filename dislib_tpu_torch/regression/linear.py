"""Linear regression via the normal equations.

Counterpart of ``dislib_tpu/regression/linear.py``: XᵀX and Xᵀy are GEMMs
on the device (a masked ones-column carries the intercept) and the
(n+1)×(n+1) system is solved there, with a 1e-7 ridge for rank-deficient
inputs.  Multi-output y is supported.  A ``SparseArray`` is densified
through its budget-guarded lazy backing, as in the reference
(``data/sparse.dense_input``).  Everything runs under
:func:`~dislib_tpu_torch.ops.precision.precise` (TF32 off).  ``predict``
is the reference's fusion-graph node body, called eagerly.  ``fit`` is
``_fit_finalize(_fit_async(x, y))``, the search's async-trial hooks;
``_score_async`` is the R² as a device scalar.

Across ranks each rank forms its rows' (n+1)×(n+1) Gram and Xᵀy (its
blocks all-gathered over 'cols' first, none on a one-column mesh), ONE
``psum`` over 'rows' joins them, and every rank solves the system.
``predict`` is local; the R² takes two small ``psum`` calls, of Σy (the
mean) and then of the residual and total sums, so each is summed as on
one rank.
"""

from __future__ import annotations

import numpy as np
import torch

from dislib_tpu_torch.base import BaseEstimator
from dislib_tpu_torch.cluster.kmeans import _to_host
from dislib_tpu_torch.data.array import Array, ensure_canonical
from dislib_tpu_torch.data.sparse import dense_input
from dislib_tpu_torch.ops.base import precise
from dislib_tpu_torch.parallel import distributed as _dist
from dislib_tpu_torch.parallel import mesh as _mesh


class LinearRegression(BaseEstimator):
    """Ordinary least squares.

    Attributes
    ----------
    coef_ : ndarray (n_features, n_targets)
    intercept_ : ndarray (n_targets,)
    """

    _capturable = frozenset({"predict"})

    def __init__(self, fit_intercept=True, arity=50):
        self.fit_intercept = fit_intercept
        self.arity = arity  # reference parity; ignored

    def fit(self, x: Array, y: Array):
        self._fit_finalize(self._fit_async(x, y))
        return self

    # async trial protocol: the handle is the (coef, intercept) device
    # pair, read back only after the search has dispatched the fold
    def _fit_async(self, x, y=None):
        if y is None:
            raise ValueError("LinearRegression requires y")
        x = dense_input(x, "LinearRegression")
        y = dense_input(y, "LinearRegression")
        if x.shape[0] != y.shape[0]:
            raise ValueError("x and y row counts differ")
        return _linreg_fit(x._row_block(), y._row_block(), x.shape, y.shape,
                           self.fit_intercept, x._mesh, x._at[0])

    def _fit_finalize(self, state):
        if state is None:
            return
        self.coef_, self.intercept_ = _to_host(*state)

    def _score_async(self, state, x, y=None):
        if state is None:
            return super()._score_async(state, x, y)
        return _r2_score(x._row_block(), y._row_block(), x.shape, y.shape,
                         *state, x._mesh, x._at[0])

    def predict(self, x: Array) -> Array:
        """ŷ = x @ coef + intercept, (m, n_targets)."""
        self._check_fitted()
        x = ensure_canonical(x)
        coef, intercept = self._predict_leaves(x.device, self.coef_,
                                               self.intercept_)
        return Array._from_rows(
            _linreg_predict(x._row_block(), x.shape, coef, intercept,
                            x._at[0]),
            (x.shape[0], self.coef_.shape[1]), x._mesh)

    def score(self, x: Array, y: Array) -> float:
        """R² score (sklearn convention), computed on the device."""
        self._check_fitted()
        coef, intercept = self._predict_leaves(x.device, self.coef_,
                                               self.intercept_)
        return float(_r2_score(x._row_block(), y._row_block(), x.shape,
                               y.shape, coef, intercept, x._mesh, x._at[0]))

    def _carry_in(self, arrays: dict, device):
        self.coef_ = np.array(arrays["coef_"], np.float32)
        self.intercept_ = np.array(arrays["intercept_"], np.float32)

    def _check_fitted(self):
        if not hasattr(self, "coef_"):
            raise RuntimeError("LinearRegression is not fitted")


def _valid(xv, m, row0=0):
    """1 on the logical rows of ``xv`` (its first row global ``row0``),
    0 on the pad, as an (rows, 1) column."""
    return (torch.arange(xv.shape[0], device=xv.device) < m - row0).to(
        xv.dtype)[:, None]


@precise
def _linreg_fit(xp, yp, x_shape, y_shape, fit_intercept, mesh, row0=0):
    """The normal equations from the rows ``xp``/``yp`` of ``mesh`` (the
    padded backings on one rank; across ranks this rank's rows from
    global row ``row0``, their Gram and Xᵀy summed by ONE packed ``psum``
    over 'rows')."""
    m, n = x_shape
    t = y_shape[1]
    xv = xp[:, :n]
    yv = yp[:, :t]
    # padded rows are zero: a masked ones-column keeps them inert
    xa = torch.cat([xv, _valid(xv, m, row0)], dim=1) if fit_intercept \
        else xv
    k = xa.shape[1]
    xtx = xa.T @ xa
    xty = xa.T @ yv
    packed = _dist.psum(torch.cat([xtx.reshape(-1), xty.reshape(-1)]),
                        _mesh.ROWS, mesh)
    xtx, xty = packed[: k * k].view(k, k), packed[k * k:].view(k, t)
    # small ridge for numerical safety on rank-deficient inputs
    sol = torch.linalg.solve(
        xtx + 1e-7 * torch.eye(k, dtype=xv.dtype, device=xv.device), xty)
    if fit_intercept:
        return sol[:-1], sol[-1]
    return sol, torch.zeros((t,), dtype=xv.dtype, device=xv.device)


@precise
def _r2_score(xp, yp, x_shape, y_shape, coef, intercept, mesh, row0=0):
    """R² of a linear predictor, summed over all targets, on the device
    (shared with ``Lasso``); across ranks from this rank's rows, two
    ``psum`` calls over 'rows'."""
    m, n = x_shape
    t = y_shape[1]
    xv = xp[:, :n]
    yv = yp[:, :t]
    w = _valid(xv, m, row0)
    pred = (xv @ coef + intercept[None, :]) * w
    resid = torch.sum(((yv - pred) * w) ** 2)
    ymean = _dist.psum(torch.sum(yv * w, dim=0), _mesh.ROWS, mesh) / m
    total = torch.sum(((yv - ymean[None, :]) * w) ** 2)
    resid, total = _dist.psum(torch.stack([resid, total]), _mesh.ROWS, mesh)
    return 1.0 - resid / torch.clamp_min(total, 1e-12)


@precise
def _linreg_predict(xp, shape, coef, intercept, row0=0):
    """``predict``'s body (the reference's fusion node); 0 on padded
    rows (``xp``'s first row is global row ``row0``)."""
    xv = xp[:, : shape[1]]
    return (xv @ coef + intercept[None, :]) * _valid(xv, shape[0], row0)
