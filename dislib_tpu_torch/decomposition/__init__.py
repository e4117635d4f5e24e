"""Decompositions (counterpart of ``dislib_tpu/decomposition``)."""

from dislib_tpu_torch.decomposition.tsqr import tsqr
from dislib_tpu_torch.decomposition.randomsvd import random_svd
from dislib_tpu_torch.decomposition.lanczos import lanczos_svd
from dislib_tpu_torch.decomposition.pca import PCA

__all__ = ["tsqr", "random_svd", "lanczos_svd", "PCA"]
