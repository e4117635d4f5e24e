"""Transient-failure retry policy.

Counterpart of ``dislib_tpu/runtime/retry.py``, copied (stdlib only).  The
ingest loaders (``data/io.py``) re-read a file under it: a flaky shared
filesystem (EIO, a connection reset, a stale NFS handle) is retried, with
bounded attempts, exponential backoff with seedable jitter and an optional
wall-clock deadline, and anything classified fatal (a missing file, a parse
error, a user bug) re-raises at once.

Classification is conservative: a retried fatal error wastes attempts at
worst, but a non-retried transient kills a job that would have survived,
so network/IO error *types* are transient by default and everything else
must match a known transient *message*.  ``Preempted``,
``KeyboardInterrupt`` and ``SystemExit`` are control flow, never retried,
as in the reference.  The reference also classifies its coordination
exceptions (``RankDead``, ``CoordinationTimeout``); the port has no
coordination layer yet (ROADMAP.md A.11).
"""

from __future__ import annotations

import os
import random
import re
import time

__all__ = ["Retry", "retry_call", "is_transient_error"]

# gRPC status text and kernel-ish error strings that mark an exception of
# an otherwise-opaque type (RuntimeError) as transient
_TRANSIENT_MSG = re.compile(
    r"(?i)\b(unavailable|deadline.?exceeded|timed.?out"
    r"|connection (reset|refused|closed|aborted)|broken pipe|socket closed"
    r"|temporarily unavailable|resource.?exhausted|try again|heartbeat"
    r"|failed to connect)")

# OSError subclasses that mean "the request itself is wrong", not "the
# environment hiccuped" — never retried
_FATAL_OSERRORS = (FileNotFoundError, IsADirectoryError, NotADirectoryError,
                   PermissionError, FileExistsError)


def is_transient_error(exc: BaseException) -> bool:
    """Default transient-vs-fatal classification (see module docstring)."""
    from dislib_tpu_torch.runtime.preemption import Preempted
    if isinstance(exc, (Preempted, KeyboardInterrupt, SystemExit)):
        return False                      # control flow, not a failure
    if isinstance(exc, (ConnectionError, TimeoutError, InterruptedError,
                        BlockingIOError)):
        return True
    if isinstance(exc, OSError):
        return not isinstance(exc, _FATAL_OSERRORS)
    if isinstance(exc, (ValueError, TypeError, KeyError, IndexError,
                        AssertionError, ArithmeticError)):
        return False                      # user/programming errors
    return bool(_TRANSIENT_MSG.search(str(exc)))


class Retry:
    """Bounded-retry policy with exponential backoff + jitter.

    Parameters
    ----------
    attempts : int, default 3 — total tries (1 = no retry).
    backoff : float, default 0.5 — first retry delay, seconds; doubles per
        attempt up to ``max_backoff``.
    max_backoff : float, default 30.0.
    jitter : float, default 0.25 — each delay is scaled by
        ``1 + jitter·u`` with ``u ~ U[0, 1)``; seed it (``seed=``) for a
        deterministic schedule (the fault-injection tests do).
    deadline : float or None — wall-clock budget in seconds; once the next
        sleep would overrun it, the last error re-raises.
    classify : callable(exc) -> bool | None — overrides the default
        transient classification; ``None`` falls through to the default.
    sleep : callable(seconds) — injection point for tests.
    """

    def __init__(self, attempts: int = 3, backoff: float = 0.5,
                 max_backoff: float = 30.0, jitter: float = 0.25,
                 deadline: float | None = None, classify=None, seed=None,
                 sleep=time.sleep):
        if attempts < 1:
            raise ValueError("attempts must be >= 1")
        self.attempts = int(attempts)
        self.backoff = float(backoff)
        self.max_backoff = float(max_backoff)
        self.jitter = float(jitter)
        self.deadline = None if deadline is None else float(deadline)
        self.classify = classify
        # the jitter's generator is made at the first retry: seeding one
        # from the OS costs ~0.1 ms, and most calls never retry (a fit
        # makes a policy per chunk read)
        self._seed = seed
        self._rng = None
        self._sleep = sleep

    @classmethod
    def from_env(cls, **defaults) -> "Retry":
        """Policy with env overrides — the launch-script knob surface:
        ``DSLIB_RETRY_ATTEMPTS`` / ``DSLIB_RETRY_BACKOFF`` /
        ``DSLIB_RETRY_MAX_BACKOFF`` / ``DSLIB_RETRY_DEADLINE`` (empty
        string = no deadline).  ``defaults`` seed the call-site policy."""
        env = os.environ
        kw = dict(defaults)
        if "DSLIB_RETRY_ATTEMPTS" in env:
            kw["attempts"] = int(env["DSLIB_RETRY_ATTEMPTS"])
        if "DSLIB_RETRY_BACKOFF" in env:
            kw["backoff"] = float(env["DSLIB_RETRY_BACKOFF"])
        if "DSLIB_RETRY_MAX_BACKOFF" in env:
            kw["max_backoff"] = float(env["DSLIB_RETRY_MAX_BACKOFF"])
        if env.get("DSLIB_RETRY_DEADLINE"):
            kw["deadline"] = float(env["DSLIB_RETRY_DEADLINE"])
        return cls(**kw)

    def is_transient(self, exc: BaseException) -> bool:
        if self.classify is not None:
            verdict = self.classify(exc)
            if verdict is not None:
                return bool(verdict)
        return is_transient_error(exc)

    def call(self, fn, *args, **kwargs):
        """Run ``fn(*args, **kwargs)``, retrying transient failures.  The
        last exception re-raises with its original type and traceback."""
        start = time.monotonic()
        for attempt in range(1, self.attempts + 1):
            try:
                return fn(*args, **kwargs)
            except BaseException as exc:  # noqa: BLE001 — classified below
                if attempt >= self.attempts or not self.is_transient(exc):
                    raise
                delay = min(self.max_backoff,
                            self.backoff * (2.0 ** (attempt - 1)))
                if self._rng is None:
                    self._rng = random.Random(self._seed)
                delay *= 1.0 + self.jitter * self._rng.random()
                if self.deadline is not None and \
                        time.monotonic() - start + delay > self.deadline:
                    raise
                self._sleep(delay)
        raise AssertionError("unreachable")  # loop always returns or raises


def retry_call(fn, *args, retry: Retry | None = None, **kwargs):
    """``(retry or Retry.from_env()).call(fn, *args, **kwargs)``."""
    return (retry if retry is not None else Retry.from_env()) \
        .call(fn, *args, **kwargs)
