"""Classifiers (counterpart of ``dislib_tpu/classification``)."""

from dislib_tpu_torch.classification.csvm import CascadeSVM
from dislib_tpu_torch.classification.knn import KNeighborsClassifier

__all__ = ["CascadeSVM", "KNeighborsClassifier"]
