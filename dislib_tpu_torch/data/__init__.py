"""The ds-array (counterpart of ``dislib_tpu/data``)."""

from dislib_tpu_torch.data.array import (
    Array, array, random_array, zeros, full, ones, identity, eye,
    apply_along_axis, concat_rows, concat_cols, rechunk, ensure_canonical,
)

__all__ = ["Array", "array", "random_array", "zeros", "full", "ones",
           "identity", "eye", "apply_along_axis", "concat_rows",
           "concat_cols", "rechunk", "ensure_canonical"]
