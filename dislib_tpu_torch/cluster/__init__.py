"""Clustering estimators (counterpart of ``dislib_tpu/cluster``)."""

from dislib_tpu_torch.cluster.kmeans import KMeans
from dislib_tpu_torch.cluster.minibatch import MiniBatchKMeans
from dislib_tpu_torch.cluster.gm import GaussianMixture

__all__ = ["KMeans", "MiniBatchKMeans", "GaussianMixture"]
