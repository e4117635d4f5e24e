"""Shared device kernels used across estimators.

Counterpart of ``dislib_tpu/ops/base.py``: the one distance formulation
every caller shares, so numerical fixes land in one place.
"""

from __future__ import annotations

import torch

from dislib_tpu_torch.ops import kernels as _k
# the f32-faithful scope lives in the precision module; re-exported here
# for the package-wide import path, as in the reference
from dislib_tpu_torch.ops.precision import precise  # noqa: F401


def distances_sq(a: torch.Tensor, b: torch.Tensor, precision=None,
                 use_kernel: bool = False) -> torch.Tensor:
    """Pairwise squared euclidean distances (m, k) between rows of ``a``
    (m, d) and rows of ``b`` (k, d): one GEMM + norms
    (‖a‖² − 2a·bᵀ + ‖b‖²), clamped at zero against cancellation.

    ``use_kernel=True`` routes to the hand kernel
    (:func:`ops.kernels.distances_sq`), which on CPU tensors runs the same
    plain formulation.  ds-array operands (the reference's fusion-graph
    node) are not ported yet: ROADMAP.md A.4."""
    if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)):
        raise NotImplementedError(
            "distances_sq takes torch tensors; the ds-array form (a node "
            "of the reference's lazy fusion graph) is ROADMAP.md A.4")
    if use_kernel:
        return _k.distances_sq(a, b, precision=precision)
    return _k.distances_sq_plain(a, b, precision=precision)
