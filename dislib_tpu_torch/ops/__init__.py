"""Device kernels and the policies around them (counterpart of
``dislib_tpu/ops``)."""

from dislib_tpu_torch.ops.base import distances_sq, precise

__all__ = ["distances_sq", "precise"]
