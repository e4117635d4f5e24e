"""ModelPool — serve checkpoint generation N while N+1 trains.

Counterpart of ``dislib_tpu/serving/hotswap.py`` (host code, kept as a
copy of its own).  A trainer keeps saving fit state into a rotating
:class:`~dislib_tpu_torch.utils.checkpoint.FitCheckpoint` (atomic
renames, embedded checksums, keep-k generations).  The pool polls that
path and swaps the served pipeline through the ``runtime.adoption`` gate:

1. the checksum-verified ``load()`` — a torn or corrupt newest
   generation falls back to the previous good one, so the pool never
   builds a model from damaged bytes;
2. the health-gated warmup: the candidate pipeline runs one zero batch
   through EVERY serving bucket, which captures the candidate's own CUDA
   graphs (so the post-swap hot path never captures and never builds a
   kernel), and the concatenated outputs pass the non-finite guard — a
   generation that predicts NaN is rejected with a typed
   :class:`~dislib_tpu_torch.runtime.AdoptionRejected` and the pool
   keeps serving the old generation;
3. the swap itself is one atomic reference assignment — in-flight
   batches finish on the old pipeline, the next batch takes the new one.

All checkpoint reads go through :func:`dislib_tpu_torch.runtime.adopt_latest`
— enforced by the adoption-gate lint in ``tests/test_torch_serving.py``.
"""

from __future__ import annotations

import os
import threading
import time

from dislib_tpu_torch.runtime import (AdoptionRejected, adopt_latest,
                                      generation_token)
from dislib_tpu_torch.serving.buckets import bucket_ladder
from dislib_tpu_torch.serving.cache import ProgramCache


def _default_poll_s() -> float:
    return float(os.environ.get("DSLIB_SERVE_POLL_S", "0.25"))


class ModelPool:
    """The served-model slot, refreshed from a rotating checkpoint.

    Parameters
    ----------
    checkpoint : FitCheckpoint — the path a trainer rotates (the pool
        only ever reads; build a separate FitCheckpoint instance on the
        same path as the writer's, exactly as a cross-process reader
        would).
    build : callable(state_dict) -> ServePipeline — turn a verified
        snapshot into a servable pipeline.
    buckets : bucket ladder warmed (and health-gated) before every swap;
        default per :func:`~dislib_tpu_torch.serving.buckets.bucket_ladder`.
    poll_interval_s : float — minimum seconds between disk polls
        (``DSLIB_SERVE_POLL_S``, default 0.25); :meth:`poll` calls inside
        the window are free no-ops, so the server can poll every batch.
    """

    def __init__(self, checkpoint, build, buckets=None,
                 poll_interval_s=None, name="serving"):
        self.checkpoint = checkpoint
        self.build = build
        self.buckets = bucket_ladder(buckets)
        self.poll_interval_s = _default_poll_s() \
            if poll_interval_s is None else float(poll_interval_s)
        self.name = name
        self.cache = ProgramCache()
        self.adoptions = 0
        self.rejections = 0
        self.last_rejection: Exception | None = None
        self._lock = threading.Lock()
        self._poll_lock = threading.Lock()  # serializes whole adoptions
        self._current = (None, None)        # (token, pipeline)
        self._last_poll = 0.0
        self._rejected_token = None         # don't re-gate a known-bad gen
        self._skip_token = None             # last no-op poll's disk state
        self._adopted_mtime = None          # monotonicity floor (adoption)

    # -- the served slot ----------------------------------------------------

    def current(self):
        """Atomic read of ``(generation_token, pipeline)``; pipeline is
        None until the first successful adoption."""
        return self._current

    @property
    def adopting(self) -> bool:
        """True while some thread is inside an adoption attempt (its
        load/build/warm phase) — waiters use this to keep waiting
        instead of declaring the pool empty."""
        return self._poll_lock.locked()

    # -- polling / adoption --------------------------------------------------

    def poll(self, force: bool = False) -> bool:
        """Adopt the newest verified+healthy generation if one appeared;
        returns True when a swap happened.  Rate-limited to
        ``poll_interval_s`` unless ``force``; a rejected generation
        (health gate) or an all-corrupt checkpoint is counted, remembered
        in ``last_rejection``, and serving continues on the old model.

        Whole-poll serialization: two pollers (a second server sharing
        the pool, or an operator's force-poll next to the worker's)
        interleaving their slow adopt/warm phases could otherwise assign
        ``_current`` out of order and roll the served generation
        BACKWARDS — a concurrent poll simply yields to the in-flight
        one."""
        if not self._poll_lock.acquire(blocking=False):
            return False                    # an adoption is in flight
        try:
            return self._poll_locked(force)
        finally:
            self._poll_lock.release()

    def _poll_locked(self, force: bool) -> bool:
        now = time.monotonic()
        if not force and now - self._last_poll < self.poll_interval_s:
            return False
        self._last_poll = now
        token, _ = self._current
        disk = generation_token(self.checkpoint)
        if disk is not None and disk in (self._rejected_token,
                                         self._skip_token):
            return False    # a gen that already failed the gate, or a
        try:                # disk state a full poll already deemed a no-op
            adoption = adopt_latest(
                self.checkpoint, self.build, probe=self._warm_probe,
                last_token=token, min_mtime_ns=self._adopted_mtime,
                name=self.name)
        except Exception as e:  # noqa: BLE001 — typed below, serving goes on
            self.rejections += 1
            self.last_rejection = e
            if isinstance(e, AdoptionRejected):
                # memoize the SETTLED disk state, not e.token: when the
                # rejected state was a fallback behind a corrupt newest
                # file, load() already cleaned that file up, so e.token
                # names a file that no longer exists and would never
                # match — the pool would re-run the full load+build+gate
                # every interval.  A fresh write still changes the token
                # and re-arms the gate.
                self._rejected_token = generation_token(self.checkpoint)
            else:
                # corrupt-beyond-repair checkpoints etc. — keep serving,
                # but surface loudly for the operator
                import warnings
                warnings.warn(f"{self.name}: generation adoption failed "
                              f"({type(e).__name__}: {e}); continuing on "
                              "the current generation", RuntimeWarning,
                              stacklevel=2)
            return False
        if adoption is None:
            # remember the PRE-poll disk state so polls until the next
            # real write cost one stat, not a full load+build (covers the
            # fallback case where the monotonicity guard keeps the
            # in-memory gen).  It must be the token captured BEFORE the
            # adoption attempt: re-statting here could capture a
            # generation written DURING the attempt and skip it forever.
            self._skip_token = disk
            return False
        with self._lock:
            self._current = (adoption.token, adoption.model)
        self.cache.rekey("warming", adoption.token)
        self._adopted_mtime = adoption.mtime_ns
        self._skip_token = None
        self.adoptions += 1
        return True

    def _warm_probe(self, pipeline):
        """The adoption probe: warm (capture) every bucket on the
        CANDIDATE pipeline and hand the concatenated outputs to the health
        gate.  Runs before the swap, so a post-swap batch never captures
        and a NaN-predicting generation never reaches the served slot.  The
        generation token is not known yet — warm under a provisional key
        and re-key after adoption."""
        return self.cache.warm(pipeline, "warming", self.buckets)

    def stats(self) -> dict:
        token, pipe = self._current
        return {"generation": repr(token), "live": pipe is not None,
                "adoptions": self.adoptions, "rejections": self.rejections,
                "cache": self.cache.stats()}
