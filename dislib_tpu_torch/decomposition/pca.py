"""Principal component analysis.

Counterpart of ``dislib_tpu/decomposition/pca.py``: the covariance from one
scatter GEMM XᵀX − m·μμᵀ (no centred copy of X), then an ``eigh`` (method
'eig') or an SVD (method 'svd') of the (n, n) covariance.  The reference's
``arity`` (reduction fan-in) is accepted and ignored, as there.
"""

from __future__ import annotations

import torch

from dislib_tpu_torch.base import BaseEstimator, carried_array
from dislib_tpu_torch.data.array import Array
from dislib_tpu_torch.math.base import matmul
from dislib_tpu_torch.ops import precision as px


class PCA(BaseEstimator):
    """Principal component analysis.

    Parameters
    ----------
    n_components : int or None — defaults to n_features.
    arity : int — accepted for reference API parity; ignored.
    method : 'eig' | 'svd' — covariance + eigh, or an SVD of the
        covariance.
    precision : mixed-precision policy for the scatter GEMM (the O(mn²)
        work); None → the ``DSLIB_MATMUL_PRECISION`` default.  The (n, n)
        eigh/SVD stays float32.

    Attributes
    ----------
    components_ : Array (n_components, n_features)
    explained_variance_ : Array (1, n_components)
    mean_ : Array (1, n_features)
    """

    def __init__(self, n_components=None, arity=50, method="eig", eps=1e-9,
                 precision=None):
        self.n_components = n_components
        self.arity = arity
        self.method = method
        self.eps = eps
        self.precision = precision

    def fit(self, x: Array, y=None):
        m, n = x.shape
        k = self.n_components or n
        if self.method not in ("eig", "svd"):
            raise ValueError(f"unknown method {self.method!r}")
        mean, comps, var = _pca_fit(x._data, x.shape, self.method == "svd",
                                    px.resolve(self.precision))
        self.mean_ = Array._from_logical(mean.reshape(1, -1), x._mesh)
        self.components_ = Array._from_logical(comps[:k].contiguous(),
                                               x._mesh)
        self.explained_variance_ = Array._from_logical(
            var[:k].reshape(1, -1), x._mesh)
        return self

    def fit_transform(self, x: Array, y=None) -> Array:
        return self.fit(x).transform(x)

    def transform(self, x: Array) -> Array:
        return matmul(x - self.mean_, self.components_, transpose_b=True)

    def inverse_transform(self, y: Array) -> Array:
        return matmul(y, self.components_) + self.mean_

    def _carry_in(self, arrays: dict, device):
        for name in ("mean_", "components_", "explained_variance_"):
            setattr(self, name, carried_array(arrays[name], device))


@px.precise
def _pca_fit(xp: torch.Tensor, shape, use_svd: bool, policy=px.FLOAT32):
    m, n = shape
    xv = xp[:, :n]  # crop cols; padded rows are zero
    mean = torch.sum(xv, dim=0) / m
    # Σ (x-μ)(x-μ)ᵀ over the logical rows = XᵀX − m μμᵀ (zero pad rows
    # add nothing to XᵀX)
    scatter = px.pdot(xv.T, xv, policy) - m * torch.outer(mean, mean)
    cov = scatter / (m - 1)
    if use_svd:
        # symmetric PSD: the singular values are the eigenvalues
        u, s, _ = torch.linalg.svd(cov)
        return mean, u.T, s
    w, v = torch.linalg.eigh(cov)
    order = torch.argsort(-w)
    return mean, v[:, order].T, w[order]
