"""Clustering estimators (counterpart of ``dislib_tpu/cluster``)."""

from dislib_tpu_torch.cluster.kmeans import KMeans
from dislib_tpu_torch.cluster.minibatch import MiniBatchKMeans
from dislib_tpu_torch.cluster.gm import GaussianMixture
from dislib_tpu_torch.cluster.dbscan import DBSCAN
from dislib_tpu_torch.cluster.daura import Daura

__all__ = ["KMeans", "MiniBatchKMeans", "GaussianMixture", "DBSCAN",
           "Daura"]
