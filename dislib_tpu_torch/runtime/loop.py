"""The data-dependent fit loops, run in chunks of masked steps.

The reference keeps three fit loops on the device in a ``lax.while_loop``
that stops on a condition of the carried state, with no host read:

- KMeans' Lloyd loop, until ``shift < tol`` (``dislib_tpu/cluster/
  kmeans.py``, ``_kmeans_fit``'s ``cond``);
- GaussianMixture's EM loop, until ``|lb − prev_lb| < tol``
  (``dislib_tpu/cluster/gm.py``, ``_gm_fit``'s ``cond``);
- consensus ADMM, until both residuals are under their tolerances
  (``dislib_tpu/optimization/admm.py``, ``_admm_fit``'s ``cond``).

PyTorch has to bring a scalar to the host to branch.  :func:`run_chunked`
enqueues :data:`EVERY` steps, then reads the condition once (through
``utils/profiling.host_read``), and stops when it is false.  Each step is
*masked*: it computes whether the loop is still running from the carried
state and leaves the state as it is when it is not, so the steps past the
stop inside a chunk change nothing and the result equals the reference's
early-exiting loop.  A fit runs at most ``EVERY − 1`` masked steps past
the stop and makes at most ``⌈max_iter / EVERY⌉ − 1`` reads here, plus the
one read of its results.  Where the condition cannot stop the loop (a
tolerance ≤ 0), the caller passes no condition and the steps run to
``max_iter`` with no read: the masks alone keep the result the
reference's, a NaN included.
"""

from __future__ import annotations

from typing import Callable

import torch

from dislib_tpu_torch.utils.profiling import host_read

#: steps enqueued between two reads of the loop's condition.  A read
#: drains the queue (~0.1 ms for KMeans on 1M x 100 on an H100) and a chunk
#: runs on average (EVERY - 1) / 2 steps past the stop; of 1, 2, 4, 8 and
#: 16, 8 gave the fastest fits there (``tools/torch_linalg_diag.py
#: --loop-every``, PERF.md)
EVERY = 8


def run_chunked(step: Callable[[int], None],
                running: Callable[[], torch.Tensor] | None, max_iter: int,
                site: str) -> int:
    """Call ``step(t)`` for ``t = 0, 1, …`` in chunks of :data:`EVERY`, and
    after each chunk that leaves steps to run read ``running()`` (a
    one-element bool tensor: the reference's ``cond`` without its
    iteration bound); stop when it is false or at ``max_iter`` steps.
    Returns the number of steps run (enqueued), masked ones included.
    ``running`` is the reference's condition, NaN included: a NaN shift
    stops KMeans, while a NaN lower bound or residual keeps EM and ADMM
    running to ``max_iter``, as there.  ``running=None``: no reads."""
    t = 0
    while t < max_iter:
        stop = max_iter if running is None else min(max_iter, t + EVERY)
        for i in range(t, stop):
            step(i)
        t = stop
        if t < max_iter and not host_read(running(), site):
            break
    return t
