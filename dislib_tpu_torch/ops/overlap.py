"""Comm–compute overlap: the library-wide panel-schedule contract.

Counterpart of ``dislib_tpu/ops/overlap.py``.  :func:`panel_pipeline` is the
ONE implementation of the panel loop every collective schedule runs: a
prologue fetch, a body, an epilogue drain.  Here it is a Python loop over
eager tensor ops.  On a mesh of several ranks a fetch returns its panel
in flight (``parallel/distributed.Pending``: a collective's work handle
and its buffer) and ``consume`` waits on it through :func:`landed` before
it reads it; under ``db`` the fetch of panel t+1 is issued before panel t
is consumed.  With NCCL the wait orders the current stream and not the
host, so the transfer runs under the previous panel's GEMM.

Routing (``DSLIB_OVERLAP``): ``db`` (default) = double-buffered, ``seq`` =
sequential-phase, ``kernel`` = double-buffered with the panel GEMM on the
hand CUDA kernel (``ops/kernels.panel_gemm``).  ``pallas`` is accepted as
an alias of ``kernel``, so ``DSLIB_OVERLAP=pallas`` means what it means
for the reference.  There is no silent degrade: on a CUDA tensor the
kernel route launches the kernel or raises.

:func:`host_pipeline` lifts the same discipline to host loops of the fit
drivers (the cascade SVM's per-level node batches, the forest's
per-level snapshot reads).
"""

from __future__ import annotations

import os

from dislib_tpu_torch.parallel.distributed import Pending

SCHEDULES = ("db", "seq", "kernel")

_ALIASES = {
    "": "db", "db": "db", "auto": "db", "on": "db", "1": "db",
    "overlap": "db",
    "seq": "seq", "off": "seq", "0": "seq", "sequential": "seq",
    "kernel": "kernel", "pallas": "kernel",
}


def resolve(explicit=None) -> str:
    """The overlap-schedule routing rule: an explicit value wins,
    otherwise ``DSLIB_OVERLAP``, otherwise the double-buffered default.
    Returns a canonical name from :data:`SCHEDULES`."""
    raw = explicit if explicit is not None \
        else os.environ.get("DSLIB_OVERLAP", "db")
    key = _ALIASES.get(str(raw).lower())
    if key is None:
        raise ValueError(
            f"unknown overlap schedule {raw!r}: expected one of "
            f"{SCHEDULES} or 'pallas' (DSLIB_OVERLAP accepts the same "
            "values)")
    return key


def overlapped(schedule: str) -> bool:
    """True when ``schedule`` software-pipelines the panel loop (``db``
    and ``kernel``); False for the sequential-phase schedule."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown overlap schedule {schedule!r}")
    return schedule != "seq"


def panel_pipeline(steps, pan0, fetch, consume, acc0, overlap):
    """THE shared panel-loop schedule.  Computes::

        acc = consume(steps-1, ... consume(1, consume(0, acc0, pan0),
                                           fetch(1, pan0)) ...)

    ``pan0`` is panel 0; ``fetch(t, prev)`` produces panel ``t`` from
    panel ``t-1`` and is only called with ``t >= 1``; ``consume(t, acc,
    pan)`` folds panel ``t`` into the accumulator.

    ``overlap=False``: each step fetches its panel, then consumes it.
    ``overlap=True``: each step issues the NEXT panel's fetch before
    consuming the current one, and the last panel drains in an epilogue.
    Both consume panels in the same order with the same ops, so the two
    schedules give bit-equal results."""
    steps = int(steps)
    if steps <= 0:
        return acc0
    if overlap:
        acc, pan = acc0, pan0
        for t in range(steps - 1):
            nxt = fetch(t + 1, pan)        # issue panel t+1's fetch ...
            acc = consume(t, acc, pan)     # ... before panel t's compute
            pan = nxt
        return consume(steps - 1, acc, pan)   # epilogue drain
    acc = consume(0, acc0, pan0)
    pan = pan0
    for t in range(1, steps):
        pan = fetch(t, pan)                # fetch ...
        acc = consume(t, acc, pan)         # ... THEN compute
    return acc


def landed(pan):
    """The panel ``pan`` (a tuple) with each in-flight part waited on:
    what a ``consume`` reads."""
    return tuple(p.wait() if isinstance(p, Pending) else p for p in pan)


def host_pipeline(steps, fetch, consume, overlap=True):
    """:func:`panel_pipeline`'s discipline lifted to HOST loops — the fit
    drivers' dispatch→read sequences (the CSVM cascade's per-level node
    batches, the forest's per-level snapshot reads), where the "fetch" is
    a device dispatch or an enqueued device→host copy and the "compute"
    is the blocking host read.

    ``fetch(t)`` ISSUES step t's work and returns its handle without
    blocking; ``consume(t, handle)`` blocks on the handle and returns the
    step's host result.  ``overlap=True`` issues fetch(t+1) before
    consume(t), with exactly ONE extra step in flight; ``overlap=False``
    is the strict fetch-then-consume chain.  Both evaluate the same
    ``consume(t, fetch(t))`` pairs in the same order, so the schedules
    are bit-equal by construction.  Returns ``[consume(0, ...), ...,
    consume(steps-1, ...)]``."""
    steps = int(steps)
    out = []
    if steps <= 0:
        return out
    if overlap:
        pending = fetch(0)
        for t in range(1, steps):
            nxt = fetch(t)                 # issue step t ...
            out.append(consume(t - 1, pending))   # ... under t-1's read
            pending = nxt
        out.append(consume(steps - 1, pending))   # epilogue drain
        return out
    for t in range(steps):
        out.append(consume(t, fetch(t)))
    return out
