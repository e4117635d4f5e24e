"""Clustering estimators (counterpart of ``dislib_tpu/cluster``)."""

from dislib_tpu_torch.cluster.kmeans import KMeans

__all__ = ["KMeans"]
