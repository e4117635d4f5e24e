"""Single-rank re-quantization of a padded backing.

Counterpart of ``dislib_tpu/ops/rechunk.py`` (``requantize_body`` and
``repad_axis`` only).  The multi-rank schedules — the panel exchange, the
``dcn`` hierarchy and the grow schedule — are ROADMAP.md A.11.
"""

from __future__ import annotations

import torch


def requantize_body(data: torch.Tensor, logical_shape, out_pshape,
                    mesh="default") -> torch.Tensor:
    """Re-pad ``data`` (any padded canvas holding ``logical_shape`` at its
    origin) onto a zero canvas of ``out_pshape`` and re-zero everything
    outside the logical region, so the pad-and-mask invariant holds even
    for a poisoned input tail.  ``mesh`` is kept for the reference's
    signature: one rank has no placement to constrain."""
    del mesh
    m, n = (int(s) for s in logical_shape)
    r = min(data.shape[0], out_pshape[0])
    c = min(data.shape[1], out_pshape[1])
    out = torch.zeros(tuple(out_pshape), dtype=data.dtype, device=data.device)
    out[: min(r, m), : min(c, n)] = data[: min(r, m), : min(c, n)]
    return out


def repad_axis(a: torch.Tensor, logical: int, target: int,
               axis: int = 0) -> torch.Tensor:
    """Crop ``a`` to its first ``logical`` slices along ``axis`` and
    zero-fill out to ``target`` (any number of dimensions)."""
    idx = [slice(None)] * a.dim()
    idx[axis] = slice(0, logical)
    cropped = a[tuple(idx)]
    if target == logical:
        return cropped
    shape = list(cropped.shape)
    shape[axis] = target
    out = torch.zeros(shape, dtype=a.dtype, device=a.device)
    out[tuple(idx)] = cropped
    return out
