"""Deterministic fault-injection harness.

Counterpart of ``dislib_tpu/utils/faults.py``, its one-process part.
Everything here is schedule-driven: faults fire at an exact save count,
an exact byte position, or an exact call count — never on a timer or an
RNG — so the resilience tests reproduce bit-identically on any machine.

- **kill-at-iteration-k** — :class:`CallbackCheckpoint` /
  :class:`SigtermAtNthSave` fire right AFTER the n-th snapshot reaches
  disk, the state a preempted job leaves behind;
- **snapshot damage** — :func:`corrupt_snapshot` flips a byte, truncates,
  or replaces a snapshot with a foreign ``.npz``;
- **flaky IO / RPC** — :class:`FlakyCall` and :class:`FlakyOpen` fail the
  first n invocations with a transient error, exercising the
  :class:`~dislib_tpu_torch.runtime.retry.Retry` policy;
- **numerical / liveness faults** — :class:`NaNAtChunk` poisons a loop
  carry at an exact chunk index, :class:`DivergenceRamp` scales it into a
  blow-up, :class:`HangAtChunk` stalls a chunk's force point past the
  watchdog deadline, :class:`TripAtChunk` forces a guard verdict where no
  float carry exists to poison (the cascade SVM's host-side state), and
  :class:`FaultAtTier` trips until the escalation ladder reaches a given
  tier.  All are :class:`~dislib_tpu_torch.runtime.health.HealthPolicy`
  subclasses: pass them as ``fit(..., health=...)`` and the estimator's
  own guard becomes the injector.

Not ported yet: the capacity and multi-process injectors
(``CapacityAtSave``, ``oscillation_schedule``, ``KillRankAt``,
``LeaseExpiry``, ``TornCoordWrite``; ROADMAP.md A.11) and the serving
ones (``TornBundleWrite``, ``CanaryGateTrip``).
"""

from __future__ import annotations

import builtins
import os
import signal as _signal
import time as _time

import numpy as np

from dislib_tpu_torch.runtime.health import ChunkGuard, HealthPolicy, Verdict
from dislib_tpu_torch.utils.checkpoint import FitCheckpoint

__all__ = ["CallbackCheckpoint", "SigtermAtNthSave", "sigterm_self",
           "corrupt_snapshot", "FlakyCall", "FlakyOpen",
           "NaNAtChunk", "DivergenceRamp", "HangAtChunk", "TripAtChunk",
           "FaultAtTier"]


class CallbackCheckpoint(FitCheckpoint):
    """Runs ``callback()`` right AFTER the ``after``-th successful save —
    the snapshot is on disk when the fault fires, exactly the state a
    preempted/killed job leaves behind."""

    def __init__(self, path, every: int = 1, after: int = 1, callback=None,
                 keep: int = 2):
        super().__init__(path, every=every, keep=keep)
        self._left = int(after)
        self._callback = callback

    def save(self, state):
        super().save(state)
        self._left -= 1
        if self._left == 0 and self._callback is not None:
            self._callback()


def sigterm_self() -> None:
    """Deliver SIGTERM to this process — the real preemption notice."""
    os.kill(os.getpid(), _signal.SIGTERM)


class SigtermAtNthSave(CallbackCheckpoint):
    """SIGTERM lands right after the n-th snapshot: with a
    :class:`~dislib_tpu_torch.runtime.preemption.PreemptionWatcher` installed the
    fit raises ``Preempted`` at the NEXT chunk boundary."""

    def __init__(self, path, every: int = 1, after: int = 1, keep: int = 2):
        super().__init__(path, every=every, after=after,
                         callback=sigterm_self, keep=keep)


def corrupt_snapshot(path, mode: str = "flip", position: int | None = None):
    """Deterministically damage a snapshot file in place.

    - ``"flip"`` — XOR one byte (the middle one unless ``position``);
    - ``"truncate"`` — keep only the first half of the file;
    - ``"foreign"`` — replace with a plain ``np.savez`` carrying no
      integrity record (a non-dislib ``.npz``).
    """
    path = str(path)
    if mode == "foreign":
        np.savez(path, junk=np.arange(3))
        return
    with open(path, "rb") as f:
        data = bytearray(f.read())
    if mode == "truncate":
        data = data[: max(1, len(data) // 2)]
    elif mode == "flip":
        pos = len(data) // 2 if position is None else int(position)
        data[pos] ^= 0xFF
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    with open(path, "wb") as f:
        f.write(bytes(data))


class FlakyCall:
    """Wraps a callable: the first ``failures`` invocations raise a
    transient error (``exc_factory()``), later ones delegate.  ``calls``
    counts every invocation — assert on it to pin the retry schedule."""

    def __init__(self, fn, failures: int = 1, exc_factory=None):
        self.fn = fn
        self.failures = int(failures)
        self.calls = 0
        self.exc_factory = exc_factory or (
            lambda: ConnectionResetError("injected transient failure"))

    def __call__(self, *args, **kwargs):
        self.calls += 1
        if self.calls <= self.failures:
            raise self.exc_factory()
        return self.fn(*args, **kwargs)


class FlakyOpen:
    """``builtins.open`` stand-in that fails the first ``failures`` opens
    of one specific ``path`` with a transient ``OSError`` (EIO) — flaky
    shared-filesystem injection for the ingest retry path.  Install with
    ``monkeypatch.setattr(builtins, "open", FlakyOpen(path, 2))``."""

    def __init__(self, path, failures: int = 1, exc_factory=None):
        self._path = os.path.abspath(str(path))
        self._real = builtins.open
        self.failures = int(failures)
        self.fails = 0
        self.exc_factory = exc_factory or (
            lambda: OSError(5, "injected flaky read"))  # errno 5 = EIO

    def __call__(self, file, *args, **kwargs):
        try:
            same = os.path.abspath(os.fspath(file)) == self._path
        except TypeError:
            same = False  # fd-based open: never injected
        if same and self.fails < self.failures:
            self.fails += 1
            raise self.exc_factory()
        return self._real(file, *args, **kwargs)


# ---------------------------------------------------------------------------
# numerical / liveness fault injection (round-8 health PR)
# ---------------------------------------------------------------------------

def _poison_carry(carries, where, mutate):
    """Apply ``mutate(host_ndarray) -> host_ndarray`` to the ``where``-th
    float-dtype tensor among ``carries`` (None/ints/scalars skipped),
    returning ``(new_tuple, hit)``.  The carry goes to the host, is
    mutated there and comes back as a fresh tensor on the carry's own
    device — what a corrupted memory buffer would hand the next chunk.
    ``hit`` is False when no eligible carry exists (e.g. a first chunk
    that admits no state) — callers keep the fault ARMED then, so an
    injection can never be silently lost."""
    import torch
    out = list(carries)
    fi = 0
    for i, c in enumerate(carries):
        if not isinstance(c, torch.Tensor) or not c.is_floating_point() \
                or c.dim() == 0:
            continue
        if fi == where:
            host = c.detach().cpu().numpy().copy()
            out[i] = torch.from_numpy(np.ascontiguousarray(
                mutate(host))).to(c.device)
            return tuple(out), True
        fi += 1
    return tuple(out), False


class NaNAtChunk(HealthPolicy):
    """Health policy whose guard poisons one carry with NaN right before
    the ``at_chunk``-th chunk dispatches (1-based admit count) — the
    deterministic stand-in for a numerical blow-up inside that chunk.
    Fires once: after a rollback the re-run chunk is clean, so a fit
    under the default 'retry' action must land on the unfaulted model.

    ``where`` selects the n-th float carry, ``position`` the flat element
    poisoned (middle when None)."""

    def __init__(self, at_chunk=2, where=0, position=None, **kw):
        super().__init__(**kw)
        self.at_chunk = int(at_chunk)
        self.where = int(where)
        self.position = position
        self.fired = 0

    def make_guard(self, name, checkpoint=None):
        return _NaNAtChunkGuard(name, self, checkpoint)


class _NaNAtChunkGuard(ChunkGuard):
    def admit(self, *carries):
        carries = super().admit(*carries)
        pol = self.policy
        # >= keeps the fault ARMED past a chunk with no eligible carry
        # (e.g. ALS's first fresh chunk admits no state): it lands on the
        # first admit that CAN be poisoned instead of silently fizzling
        if self.chunk_index >= pol.at_chunk and not pol.fired:
            def mutate(host):
                pos = host.size // 2 if pol.position is None \
                    else int(pol.position) % max(host.size, 1)
                host.flat[pos] = np.nan
                return host
            carries, hit = _poison_carry(carries, pol.where, mutate)
            pol.fired += int(hit)
        return carries


class DivergenceRamp(HealthPolicy):
    """Health policy whose guard scales one carry by ``factor`` at every
    chunk from ``at_chunk`` on (or once, with ``repeat=False``) — a
    deterministic divergence ramp for the norm-growth / monotonicity
    guards (arm them: ``grow_limit=`` or ``monotone_rtol=``)."""

    def __init__(self, at_chunk=1, factor=1e4, repeat=True, **kw):
        super().__init__(**kw)
        self.at_chunk = int(at_chunk)
        self.factor = float(factor)
        self.repeat = bool(repeat)
        self.fired = 0

    def make_guard(self, name, checkpoint=None):
        return _DivergenceRampGuard(name, self, checkpoint)


class _DivergenceRampGuard(ChunkGuard):
    def admit(self, *carries):
        carries = super().admit(*carries)
        pol = self.policy
        if self.chunk_index >= pol.at_chunk and (pol.repeat or not pol.fired):
            carries, hit = _poison_carry(
                carries, 0, lambda host: host * pol.factor)
            pol.fired += int(hit)
        return carries


class HangAtChunk(HealthPolicy):
    """Health policy whose guard stalls the ``at_chunk``-th chunk's force
    point (the health read) for ``hang_s`` seconds, ``times`` attempts in
    a row — the deterministic stand-in for a hung kernel.
    With ``deadline_s < hang_s`` the watchdog trips a typed
    ``WatchdogTimeout``; the ``Retry`` policy re-attempts the
    resolution, so ``times=1`` self-heals on the second attempt and a
    large ``times`` exhausts the attempts and aborts cleanly.

    The stall fires at the first CHECK at-or-after ``at_chunk`` (loops
    like the forest's only check at snapshot boundaries, so an exact
    match could silently never inject — the same armed-fault rule as
    ``_poison_carry``), and the injector pins ``first_deadline_s`` to
    the steady-state deadline so the production compile-grace on a
    guard's first check cannot mask the injected hang."""

    def __init__(self, at_chunk=1, hang_s=0.4, times=1, deadline_s=0.05,
                 **kw):
        kw.setdefault("first_deadline_s", deadline_s)
        super().__init__(deadline_s=deadline_s, **kw)
        self.at_chunk = int(at_chunk)
        self.hang_s = float(hang_s)
        self.times = int(times)
        self.stalls = 0

    def make_guard(self, name, checkpoint=None):
        return _HangAtChunkGuard(name, self, checkpoint)


class _HangAtChunkGuard(ChunkGuard):
    def _resolve(self, handle):
        pol = self.policy
        if self.chunk_index >= pol.at_chunk and pol.stalls < pol.times:
            pol.stalls += 1
            _time.sleep(pol.hang_s)
        return super()._resolve(handle)


class TripAtChunk(HealthPolicy):
    """Health policy whose guard forces an unhealthy verdict at the
    ``at_chunk``-th chunk regardless of the actual values — for loops
    whose numeric state offers nothing to poison (the cascade SVM's
    host-side SV indices) and for exercising the gating/rollback
    machinery in isolation.  Fires at the first ``times`` checks from
    ``at_chunk`` on (``times`` > max_restarts exhausts the remediation
    budget and forces the typed raise)."""

    def __init__(self, at_chunk=1, guard_name="injected", times=1, **kw):
        super().__init__(**kw)
        self.at_chunk = int(at_chunk)
        self.guard_name = guard_name
        self.times = int(times)
        self.fired = 0

    def make_guard(self, name, checkpoint=None):
        return _TripAtChunkGuard(name, self, checkpoint)


class _TripAtChunkGuard(ChunkGuard):
    def _maybe_trip(self, it):
        pol = self.policy
        if self.chunk_index >= pol.at_chunk and pol.fired < pol.times:
            pol.fired += 1
            v = Verdict(False, guard=pol.guard_name,
                        detail={"iteration": it, "injected": True})
            self.last_verdict = v
            return v
        return None

    def check(self, hvec, carry_names=(), carry_shapes=(), it=None,
              increasing=False):
        return self._maybe_trip(it) or super().check(
            hvec, carry_names, carry_shapes, it, increasing)

    def check_host(self, values, it=None):
        return self._maybe_trip(it) or super().check_host(values, it)


class FaultAtTier(HealthPolicy):
    """Health policy whose guard trips EVERY check (from ``at_chunk`` on)
    until the fit-loop escalation ladder reaches remediation tier
    ``tiers`` — i.e. the fault "defeats" exactly the first ``tiers``
    ladder tiers (0 = healed by the first plain chunk retry, 1 = defeats
    retry, healed by policy remediation, 2 = defeats retry AND
    remediation, healed only by the elastic tier (a plain retry on the
    one-card mesh), 3 = defeats the whole ladder and forces the typed
    raise).  The healing signal is the
    driver's :meth:`~dislib_tpu_torch.runtime.health.ChunkGuard.on_escalation`
    notification, so the injector tracks the LADDER's actual tier — not a
    guessed attempt count — and a schedule change cannot silently turn a
    tier-2 drill into a tier-1 one.  Give the policy a budget that makes
    the target tier reachable (e.g. ``max_restarts=3,
    elastic_attempts=1`` for tier 2)."""

    def __init__(self, tiers=1, at_chunk=1, guard_name="fault-at-tier",
                 **kw):
        super().__init__(**kw)
        self.tiers = int(tiers)
        self.at_chunk = int(at_chunk)
        self.guard_name = guard_name
        self.fired = 0
        self.healed = False

    def make_guard(self, name, checkpoint=None):
        return _FaultAtTierGuard(name, self, checkpoint)


class _FaultAtTierGuard(ChunkGuard):
    def _maybe_trip(self, it):
        pol = self.policy
        if self.chunk_index >= pol.at_chunk and not pol.healed:
            pol.fired += 1
            v = Verdict(False, guard=pol.guard_name,
                        detail={"iteration": it, "injected": True,
                                "defeats_tiers": pol.tiers})
            self.last_verdict = v
            return v
        return None

    def on_escalation(self, escalation):
        # the re-run AFTER an escalation that reached tier `tiers` passes
        if escalation.tier_index >= self.policy.tiers:
            self.policy.healed = True

    def check(self, hvec, carry_names=(), carry_shapes=(), it=None,
              increasing=False):
        return self._maybe_trip(it) or super().check(
            hvec, carry_names, carry_shapes, it, increasing)

    def check_host(self, values, it=None):
        return self._maybe_trip(it) or super().check_host(values, it)
