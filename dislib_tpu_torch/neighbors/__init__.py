"""Nearest neighbours (counterpart of ``dislib_tpu/neighbors``)."""

from dislib_tpu_torch.neighbors.base import NearestNeighbors

__all__ = ["NearestNeighbors"]
