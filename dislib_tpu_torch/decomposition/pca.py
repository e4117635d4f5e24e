"""Principal component analysis.

Counterpart of ``dislib_tpu/decomposition/pca.py``: the covariance from one
scatter GEMM XᵀX − m·μμᵀ (no centred copy of X), then an ``eigh`` (method
'eig') or an SVD (method 'svd') of the (n, n) covariance.  The reference's
``arity`` (reduction fan-in) is accepted and ignored, as there.  Across
ranks each rank sums its rows and one packed ``psum`` joins them;
``transform`` and ``inverse_transform`` run through the broadcast ops and
the transposed ``matmul`` of ``math/base.py``.
"""

from __future__ import annotations

import torch

from dislib_tpu_torch.base import BaseEstimator, carried_array
from dislib_tpu_torch.data.array import Array
from dislib_tpu_torch.math.base import matmul
from dislib_tpu_torch.ops import precision as px
from dislib_tpu_torch.parallel import distributed as _dist
from dislib_tpu_torch.parallel import mesh as _mesh


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
        mean, comps, var = _pca_fit(x._row_block(), x.shape,
                                    self.method == "svd",
                                    px.resolve(self.precision), x._mesh)
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
def _pca_fit(xp: torch.Tensor, shape, use_svd: bool, policy=px.FLOAT32,
             mesh=None):
    """Mean, components and variances from the rows ``xp`` (the whole
    padded backing, or in a ``torch.distributed`` job this rank's rows:
    their column sums and XᵀX then travel in ONE packed ``psum`` over
    'rows', and the (n, n) eigenproblem is solved on every rank)."""
    m, n = shape
    xv = xp[:, :n]  # crop cols; padded rows are zero
    col_sum = torch.sum(xv, dim=0)
    gram = px.pdot(xv.T, xv, policy)
    if mesh is not None and mesh.groups is not None:
        packed = _dist.psum(torch.cat([col_sum.to(gram.dtype),
                                       gram.reshape(-1)]), _mesh.ROWS, mesh)
        col_sum = packed[:n].to(col_sum.dtype)
        gram = packed[n:].view(n, n)
    mean = col_sum / m
    # Σ (x-μ)(x-μ)ᵀ over the logical rows = XᵀX − m μμᵀ (zero pad rows
    # add nothing to XᵀX)
    scatter = gram - m * torch.outer(mean, mean)
    cov = scatter / (m - 1)
    if use_svd:
        # symmetric PSD: the singular values are the eigenvalues
        u, s, _ = torch.linalg.svd(cov)
        return mean, u.T, s
    w, v = torch.linalg.eigh(cov)
    order = torch.argsort(-w)
    return mean, v[:, order].T, w[order]
