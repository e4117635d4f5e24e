"""Array padding and trimming on the logical shape.

Counterpart of ``dislib_tpu/data/util.py``: ``pad``,
``pad_last_blocks_with_zeros``, ``compute_bottom_right_shape``,
``remove_last_rows`` and ``remove_last_columns``.  Physical padding is the
Array's own (a zero canvas to the mesh quantum); these helpers change the
logical shape, for API parity.
"""

from __future__ import annotations

import torch

from dislib_tpu_torch.data.array import Array as _Array


def pad(x: _Array, pad_width, value=0.0) -> _Array:
    """Grow the logical shape by ((top, bottom), (left, right)) filled with
    ``value``."""
    (top, bottom), (left, right) = pad_width
    logical = x._data[: x.shape[0], : x.shape[1]]
    out = torch.nn.functional.pad(logical, (left, right, top, bottom),
                                  value=value)
    return _Array._from_logical(out, x._mesh, reg_shape=x._reg_shape)


def pad_last_blocks_with_zeros(x: _Array) -> _Array:
    """Pad so the logical shape is an exact multiple of the block size."""
    br, bc = x._reg_shape
    bottom = (-x.shape[0]) % br
    right = (-x.shape[1]) % bc
    if bottom == 0 and right == 0:
        return x
    return pad(x, ((0, bottom), (0, right)), 0.0)


def compute_bottom_right_shape(x: _Array):
    """Shape of the bottom-right (possibly ragged) block."""
    br, bc = x._reg_shape
    r = x.shape[0] % br or br
    c = x.shape[1] % bc or bc
    return r, c


def remove_last_rows(x: _Array, n: int) -> _Array:
    return x[: x.shape[0] - n, :]


def remove_last_columns(x: _Array, n: int) -> _Array:
    return x[:, : x.shape[1] - n]
