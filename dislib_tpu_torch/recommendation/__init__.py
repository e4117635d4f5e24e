"""Recommendation (counterpart of ``dislib_tpu/recommendation``): ALS."""

from dislib_tpu_torch.recommendation.als import ALS

__all__ = ["ALS"]
