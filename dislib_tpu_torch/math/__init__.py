"""Blocked math (counterpart of ``dislib_tpu/math``)."""

from dislib_tpu_torch.math.base import matmul

__all__ = ["matmul"]
