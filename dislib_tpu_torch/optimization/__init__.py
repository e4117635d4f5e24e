"""Optimizers (counterpart of ``dislib_tpu/optimization``)."""

from dislib_tpu_torch.optimization.admm import ADMM, soft_threshold

__all__ = ["ADMM", "soft_threshold"]
