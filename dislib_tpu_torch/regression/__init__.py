"""Regression estimators (counterpart of ``dislib_tpu/regression``)."""

from dislib_tpu_torch.regression.linear import LinearRegression
from dislib_tpu_torch.regression.lasso import Lasso

__all__ = ["LinearRegression", "Lasso"]
