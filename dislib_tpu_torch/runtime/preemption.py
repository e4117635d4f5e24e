"""Preemption watcher.

Counterpart of ``dislib_tpu/runtime/preemption.py``, its one-process
part.  On a preemptible machine the eviction notice arrives as SIGTERM
(plus, on some schedulers, a sentinel file) shortly before the hard kill.
The watcher sets a process-wide flag; checkpointed fit loops poll it
BETWEEN k-iteration device chunks, write their snapshot, and raise a
clean :class:`Preempted` whose snapshot is the resume point for the
replacement job.

Two trigger paths feed the same flag:

- **signals** — ``PreemptionWatcher`` installs SIGTERM/SIGINT handlers
  (opt-in, context-manager scoped: libraries must not steal signal
  handlers behind the application's back);
- **sentinel file** — ``DSLIB_PREEMPTION_FILE`` names a path polled by
  ``preemption_requested()``; the scheduler (or an operator) touches it
  to request a graceful drain.  The poll is one ``os.path.exists`` per
  chunk boundary.

Not ported yet: the capacity level (``capacity_target``,
``request_capacity``, ``clear_capacity``), which feeds the elastic mesh
resizes and the fleet-wide coordination ledger (ROADMAP.md A.11).
"""

from __future__ import annotations

import os
import signal
import threading

__all__ = ["Preempted", "PreemptionWatcher", "preemption_requested",
           "request_preemption", "clear_preemption", "raise_if_preempted",
           "last_signal"]


class Preempted(Exception):
    """Raised by a checkpointed fit at a chunk boundary once preemption is
    requested: the snapshot on disk (``checkpoint_path``) is consistent
    and the fit resumes from it — on the same mesh or a different one."""

    def __init__(self, message: str, checkpoint_path: str | None = None):
        super().__init__(message)
        self.checkpoint_path = checkpoint_path


_EVENT = threading.Event()
_SIGNUM: int | None = None


def preemption_requested() -> bool:
    """True once a preemption has been signalled (watcher signal, explicit
    :func:`request_preemption`, or the ``DSLIB_PREEMPTION_FILE`` sentinel
    existing).  Sticky until :func:`clear_preemption`."""
    if _EVENT.is_set():
        return True
    path = os.environ.get("DSLIB_PREEMPTION_FILE")
    if path and os.path.exists(path):
        _EVENT.set()
        return True
    return False


def request_preemption() -> None:
    """Set the preemption flag directly (tests, manual drains)."""
    _EVENT.set()


def clear_preemption() -> None:
    """Reset the flag — call after handling a :class:`Preempted` when the
    same process goes on to resume (e.g. the SIGTERM turned out survivable,
    or a test rig reuses the process)."""
    global _SIGNUM
    _SIGNUM = None
    _EVENT.clear()


def last_signal() -> int | None:
    """The signal number that set the flag, if a watcher did."""
    return _SIGNUM


def raise_if_preempted(checkpoint=None) -> None:
    """Estimator hook: call right AFTER a snapshot lands (or its async
    write starts), at the chunk boundary.  Raises :class:`Preempted` when
    the flag is set; no-op otherwise.  The snapshot-first ordering is what
    makes the raise safe: an in-flight ``save_async`` is flushed before
    raising, so whatever is on disk at raise time is a complete resume
    point."""
    if not preemption_requested():
        return
    flush = getattr(checkpoint, "flush", None)
    if flush is not None:
        flush()                         # async snapshot must land first
    path = getattr(checkpoint, "path", None)
    msg = "fit preempted at a chunk boundary"
    if path:
        msg += f" — resume from the snapshot at {path}"
    raise Preempted(msg, checkpoint_path=path)


class PreemptionWatcher:
    """Scoped signal → preemption-flag bridge.

    Usage::

        with dislib_tpu_torch.runtime.PreemptionWatcher():   # SIGTERM by default
            model.fit(x, checkpoint=FitCheckpoint(path, every=10))

    ``install()``/``uninstall()`` are also exposed for long-lived services
    that keep the watcher for the process lifetime.  Previous handlers are
    restored on uninstall.  Signal handlers can only be installed from the
    main thread (Python restriction) — worker threads rely on the sentinel
    file instead.
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self.signals = tuple(signals)
        self._previous: dict = {}

    def _handler(self, signum, frame):
        global _SIGNUM
        _SIGNUM = signum
        _EVENT.set()

    def install(self) -> "PreemptionWatcher":
        for s in self.signals:
            self._previous[s] = signal.signal(s, self._handler)
        return self

    def uninstall(self) -> None:
        for s, prev in self._previous.items():
            # getsignal can report None for handlers not set from Python;
            # restoring None is invalid — fall back to the default action
            signal.signal(s, prev if prev is not None else signal.SIG_DFL)
        self._previous.clear()

    def __enter__(self) -> "PreemptionWatcher":
        return self.install()

    def __exit__(self, *exc) -> bool:
        self.uninstall()
        return False
