"""Classifiers (counterpart of ``dislib_tpu/classification``; CascadeSVM
is ROADMAP.md A.10)."""

from dislib_tpu_torch.classification.knn import KNeighborsClassifier

__all__ = ["KNeighborsClassifier"]
