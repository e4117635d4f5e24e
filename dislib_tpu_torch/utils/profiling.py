"""Host-read accounting.

Counterpart of the transfer counter in ``dislib_tpu/utils/profiling.py``.
The reference runs its data-dependent loops (the SVD sweeps, the polar
iteration, CholeskyQR2's fallback) on the device in ``lax.while_loop`` /
``lax.cond`` with no host read.  PyTorch has to bring a scalar to the host
to branch, so each such read goes through :func:`host_read`, which counts
it by site: a run can show it read once per sweep, iteration or local QR.
An estimator's one transfer of its fitted results (``cluster/kmeans.
_to_host``) counts under ``"results"``.
"""

from __future__ import annotations

import torch

#: host reads per site, counted by :func:`host_read`
HOST_READS: dict[str, int] = {}


def count_read(site: str) -> None:
    """Count one read from the device under ``site``."""
    HOST_READS[site] = HOST_READS.get(site, 0) + 1


def host_read(t: torch.Tensor, site: str):
    """The Python value of the one-element tensor ``t`` (a sync with the
    device), counted under ``site``."""
    count_read(site)
    return t.item()


def reset_host_reads() -> None:
    HOST_READS.clear()
