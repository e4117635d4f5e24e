"""The ds-array (counterpart of ``dislib_tpu/data``)."""

from dislib_tpu_torch.data.array import Array, array, zeros

__all__ = ["Array", "array", "zeros"]
