"""Blocked math (counterpart of ``dislib_tpu/math``)."""

from dislib_tpu_torch.math.base import matmul, kron, svd
from dislib_tpu_torch.math.polar import polar
from dislib_tpu_torch.math.qr import qr

__all__ = ["matmul", "kron", "svd", "qr", "polar"]
