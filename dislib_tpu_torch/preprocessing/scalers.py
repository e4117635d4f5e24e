"""Feature scalers.

Counterpart of ``dislib_tpu/preprocessing/scalers.py``: fit statistics are
the ds-array's reductions, transform a broadcasted elementwise op on the
device.  ``mean_``, ``var_``, ``data_min_`` and ``data_max_`` are (1, n)
ds-arrays, as in the reference.

Sparse input, as in the reference: ``StandardScaler(with_mean=False)``
fits a ``SparseArray`` by the one-pass moments ``mean``, ``square().mean``
and ``var = E[x²] − μ²`` (fixed-order column sums of the nonzeros) and
transforms it by ``scale_cols``, staying sparse; centering a
``SparseArray`` raises ``ValueError``, and ``MinMaxScaler`` (whose shift
densifies) raises ``TypeError`` on one.
"""

from __future__ import annotations

import torch

from dislib_tpu_torch.base import BaseEstimator, carried_array
from dislib_tpu_torch.data.array import Array, _repad, _zero_pad
from dislib_tpu_torch.data.sparse import check_input as _check_input


class StandardScaler(BaseEstimator):
    """Standardise features to zero mean / unit variance.

    Attributes: mean_ (Array 1×n), var_ (Array 1×n).
    """

    def __init__(self, with_mean=True, with_std=True):
        self.with_mean = with_mean
        self.with_std = with_std

    def fit(self, x: Array, y=None):
        if _check_input(x, "StandardScaler"):
            if self.with_mean:
                raise ValueError(
                    "cannot center a SparseArray (densifies); use "
                    "with_mean=False or x.to_dense()")
            # one-pass moments: centering would densify
            self.mean_ = x.mean(axis=0)
            ex2 = x.square().mean(axis=0)
            self.var_ = ex2 - self.mean_ * self.mean_
            return self
        m = x.shape[0]
        mean = x.mean(axis=0)
        # two-pass variance: mean((x-μ)²), biased (ddof=0) like the
        # reference (the one-pass E[x²]−μ² form cancels catastrophically
        # in float32 when |μ| ≫ σ)
        xc = x - mean
        self.mean_ = mean
        self.var_ = (xc * xc).sum(axis=0) * (1.0 / m)
        return self

    def fit_transform(self, x: Array, y=None) -> Array:
        return self.fit(x).transform(x)

    def _scale_array(self) -> Array:
        """``_safe_sqrt(var_)``, cached by the identity of ``var_``."""
        cached = getattr(self, "_scale_cache", None)
        if cached is None or cached[0] is not self.var_:
            self._scale_cache = (self.var_, _safe_sqrt(self.var_))
        return self._scale_cache[1]

    def transform(self, x: Array) -> Array:
        self._check_fitted()
        if _check_input(x, "StandardScaler"):
            if self.with_mean:
                raise ValueError("cannot center a SparseArray")
            if not self.with_std:
                return x
            return x.scale_cols(1.0 / _sqrt_vec(self.var_))
        out = x
        if self.with_mean:
            out = out - self.mean_
        if self.with_std:
            out = out / self._scale_array()
        return out

    def inverse_transform(self, x: Array) -> Array:
        self._check_fitted()
        if _check_input(x, "StandardScaler"):
            if self.with_mean:
                raise ValueError("cannot center a SparseArray")
            if not self.with_std:
                return x
            return x.scale_cols(_sqrt_vec(self.var_))
        out = x
        if self.with_std:
            out = out * self._scale_array()
        if self.with_mean:
            out = out + self.mean_
        return out

    def _carry_in(self, arrays: dict, device):
        self.mean_ = carried_array(arrays["mean_"], device)
        self.var_ = carried_array(arrays["var_"], device)

    def _check_fitted(self):
        if not hasattr(self, "mean_"):
            raise RuntimeError("StandardScaler is not fitted")


class MinMaxScaler(BaseEstimator):
    """Scale features to a [lo, hi] range (reference parity:
    feature_range)."""

    def __init__(self, feature_range=(0, 1)):
        self.feature_range = feature_range

    def fit(self, x: Array, y=None):
        if _check_input(x, "MinMaxScaler"):
            raise TypeError("MinMaxScaler is dense-only (its affine shift "
                            "densifies); use x.to_dense()")
        self.data_min_ = x.min(axis=0)
        self.data_max_ = x.max(axis=0)
        return self

    def fit_transform(self, x: Array, y=None) -> Array:
        return self.fit(x).transform(x)

    def _range_array(self) -> Array:
        """``_nonzero(max - min)``, cached by the (min_, max_)
        identities."""
        cached = getattr(self, "_range_cache", None)
        if cached is None or cached[0][0] is not self.data_min_ \
                or cached[0][1] is not self.data_max_:
            self._range_cache = ((self.data_min_, self.data_max_),
                                 _nonzero(self.data_max_ - self.data_min_))
        return self._range_cache[1]

    def transform(self, x: Array) -> Array:
        self._check_fitted()
        _check_input(x, "MinMaxScaler")
        lo, hi = self.feature_range
        scaled = (x - self.data_min_) / self._range_array()
        return scaled * (hi - lo) + float(lo)

    def inverse_transform(self, x: Array) -> Array:
        self._check_fitted()
        _check_input(x, "MinMaxScaler")
        lo, hi = self.feature_range
        return (x - float(lo)) / (hi - lo) * self._range_array() \
            + self.data_min_

    def _carry_in(self, arrays: dict, device):
        self.data_min_ = carried_array(arrays["data_min_"], device)
        self.data_max_ = carried_array(arrays["data_max_"], device)

    def _check_fitted(self):
        if not hasattr(self, "data_min_"):
            raise RuntimeError("MinMaxScaler is not fitted")


def _sqrt_vec(v: Array) -> torch.Tensor:
    """(n,) sqrt(max(v, 0)) with zeros → 1 (a no-op scale)."""
    d = torch.sqrt(torch.clamp_min(v._data[0, : v._shape[1]], 0.0))
    return torch.where(d == 0.0, torch.ones_like(d), d)


def _safe_sqrt(v: Array) -> Array:
    """:func:`_sqrt_vec` as a padded (1, n) ds-array."""
    d = _sqrt_vec(v).reshape(1, -1)
    return Array(_repad(d, v._shape, v._mesh), v._shape, v._mesh,
                 v._reg_shape)


def _nonzero(v: Array) -> Array:
    d = torch.where(v._data == 0.0, torch.ones_like(v._data), v._data)
    return Array(_zero_pad(d, v._shape), v._shape, v._mesh, v._reg_shape)
