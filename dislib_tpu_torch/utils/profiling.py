"""Host-read accounting, the process-wide counters and tracing.

Counterpart of ``dislib_tpu/utils/profiling.py``.

- **Host reads.**  The reference runs its data-dependent loops (the SVD
  sweeps, the polar iteration, CholeskyQR2's fallback) on the device in
  ``lax.while_loop`` / ``lax.cond`` with no host read.  PyTorch has to
  bring a scalar to the host to branch, so each such read goes through
  :func:`host_read`, which counts it by site: a run can show it read once
  per sweep, iteration or local QR.  An estimator's one transfer of its
  fitted results (``runtime.fetch_packed``, a fit chunk's packed read)
  counts under ``"results"``.
- **Counters** (the reference's ``_Counters``): dispatches
  (:func:`count_dispatch`), host↔device transfers through the blessed
  boundaries (:func:`count_transfer`: ``runtime.fetch`` and
  ``AsyncFetch.result``), the resilience tallies of the fit-loop driver,
  the watchdog and the ingest quarantine (:func:`count_resilience`), and
  the overlap router's schedules (:func:`count_schedule`).  All are host
  integers, so reading them costs no device work.
- **Tracing**: :func:`start_trace`/:func:`stop_trace`/:func:`trace` wrap
  ``torch.profiler`` (a Chrome trace per capture), :func:`annotate` is
  ``torch.profiler.record_function``; :func:`memory_stats` reads
  ``torch.cuda.memory_stats``.

Not ported, because they are JAX's: ``profiled_jit`` (a counting
``jax.jit``), ``op_graph`` (compiled HLO text) and ``trace_count`` (jit
retraces).  The port compiles nothing at run time but its kernels, which
``_build`` builds once per source.
"""

from __future__ import annotations

import contextlib
import os
import threading

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


# ---------------------------------------------------------------------------
# dispatch / transfer / resilience / schedule counters
# ---------------------------------------------------------------------------

class _Counters:
    """Process-wide dispatch and transfer tallies (total, dispatches also
    per name), the resilience tallies and the overlap schedules."""

    __slots__ = ("dispatches", "transfers", "dispatch_by", "resilience",
                 "schedules")

    def __init__(self):
        self.dispatches = 0
        self.transfers = 0
        self.dispatch_by: dict[str, int] = {}
        self.resilience: dict[str, int] = {}
        self.schedules: dict[str, int] = {}


_COUNTERS = _Counters()
_COUNTERS_LOCK = threading.Lock()


def count_dispatch(name: str, n: int = 1) -> None:
    """Record ``n`` device dispatches under ``name``."""
    with _COUNTERS_LOCK:
        _COUNTERS.dispatches += n
        _COUNTERS.dispatch_by[name] = _COUNTERS.dispatch_by.get(name, 0) + n


def dispatch_count() -> int:
    """Total dispatches recorded since the last :func:`reset_counters`."""
    return _COUNTERS.dispatches


def count_transfer(n: int = 1) -> None:
    """Record ``n`` host↔device transfers (``runtime.fetch``,
    ``AsyncFetch.result``)."""
    with _COUNTERS_LOCK:
        _COUNTERS.transfers += n


def transfer_count() -> int:
    """Total transfers through the blessed boundaries since the last
    :func:`reset_counters`."""
    return _COUNTERS.transfers


def count_resilience(key: str, n: int = 1) -> None:
    """Record ``n`` resilience events under ``key``: ``rollbacks``,
    ``chunk_retries``, ``escalations_<tier>``, ``watchdog_trips``,
    ``mesh_shrinks``/``mesh_grows`` and ``quarantined_rows``, as in the
    reference."""
    with _COUNTERS_LOCK:
        _COUNTERS.resilience[key] = _COUNTERS.resilience.get(key, 0) + n


def resilience_counters() -> dict:
    """Resilience tallies since the last :func:`reset_counters` (keys
    absent until their first event)."""
    with _COUNTERS_LOCK:
        return dict(_COUNTERS.resilience)


def count_schedule(kernel: str, schedule: str, n: int = 1) -> None:
    """Record that ``kernel`` ran under the overlap ``schedule`` (key
    ``f"{kernel}:{schedule}"``)."""
    with _COUNTERS_LOCK:
        key = f"{kernel}:{schedule}"
        _COUNTERS.schedules[key] = _COUNTERS.schedules.get(key, 0) + n


def schedule_counters() -> dict:
    """``{"kernel:schedule": count}`` since the last
    :func:`reset_counters`."""
    with _COUNTERS_LOCK:
        return dict(_COUNTERS.schedules)


def counters() -> dict:
    """Copies of every tally: ``{dispatches, transfers, dispatch_by,
    resilience, schedules}``."""
    with _COUNTERS_LOCK:
        return {"dispatches": _COUNTERS.dispatches,
                "transfers": _COUNTERS.transfers,
                "dispatch_by": dict(_COUNTERS.dispatch_by),
                "resilience": dict(_COUNTERS.resilience),
                "schedules": dict(_COUNTERS.schedules)}


def reset_counters() -> None:
    """Zero every tally of :func:`counters` (not :data:`HOST_READS`)."""
    with _COUNTERS_LOCK:
        _COUNTERS.dispatches = 0
        _COUNTERS.transfers = 0
        _COUNTERS.dispatch_by.clear()
        _COUNTERS.resilience.clear()
        _COUNTERS.schedules.clear()


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

_TRACE: dict = {"prof": None, "logdir": None}


def start_trace(logdir: str) -> None:
    """Begin a ``torch.profiler`` capture of the host and, where a card
    is present, the device; :func:`stop_trace` writes it to ``logdir`` as
    a Chrome trace (open it in Perfetto)."""
    if _TRACE["prof"] is not None:
        raise RuntimeError("a trace is already running")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _TRACE.update(prof=prof, logdir=str(logdir))


def stop_trace() -> str | None:
    """End the capture; returns the trace file's path (None when no
    capture ran)."""
    prof, logdir = _TRACE["prof"], _TRACE["logdir"]
    if prof is None:
        return None
    _TRACE.update(prof=None, logdir=None)
    prof.__exit__(None, None, None)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace-{os.getpid()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(logdir: str):
    """``with trace(logdir): fit()`` — :func:`start_trace` and
    :func:`stop_trace` around the block."""
    start_trace(logdir)
    try:
        yield
    finally:
        stop_trace()


@contextlib.contextmanager
def annotate(name: str):
    """Mark a phase on the trace timeline (``record_function``)."""
    with torch.profiler.record_function(name):
        yield


def memory_stats() -> dict:
    """``{device: stats or None}``: ``torch.cuda.memory_stats`` of each
    visible card (``allocated_bytes.all.current``, ...); the CPU reports
    None, as the reference's CPU devices do."""
    out = {"cpu": None}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            out[f"cuda:{i}"] = torch.cuda.memory_stats(i)
    return out
