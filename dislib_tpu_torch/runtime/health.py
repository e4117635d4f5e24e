"""Runtime health layer — fused numerical-health guards, chunk watchdog,
rollback-to-last-good remediation.

Counterpart of ``dislib_tpu/runtime/health.py``, the whole file.  A fit
survives *internal* faults: a NaN/Inf that appears in a loop carry, a
diverging loss, a carry norm blowing up, or a chunk whose force point
never returns (a hung kernel).

Design, in the order a chunked fit loop meets it:

- **fused guards** — each chunk computes a tiny health vector
  (:func:`health_vec`) from its final carries on the device, with no
  host sync; the chunk's one read (``runtime.fetch_packed``) carries it
  beside the chunk's results, so judging it costs no extra read.
- **watchdogged read** — :meth:`ChunkGuard.check` resolves the read (it
  waits on the copy's CUDA event) under an optional deadline
  (``DSLIB_CHUNK_DEADLINE_S``) on a watchdog thread.  A chunk whose
  force point hangs trips a typed :class:`WatchdogTimeout`; the
  resolution is retried under the :class:`~dislib_tpu_torch.runtime.
  retry.Retry` policy before the fit aborts.  Reads inside a chunk
  (``run_chunked``'s stop flag at ``tol > 0``) go through
  :meth:`ChunkGuard.read`, under the same deadline.
- **gated snapshots** — :meth:`ChunkGuard.save_async` refuses to write a
  snapshot for a chunk whose check tripped.
- **remediation** — :meth:`ChunkGuard.remediate` applies the
  :class:`HealthPolicy` action: roll back to the last good generation and
  re-run (``retry``), re-run with a doubled damping knob (``halve``: GMM
  ``reg_covar``, ALS ``lambda_``), re-run with a seeded perturbation of
  the restored carries (``reseed``), or raise
  :class:`NumericalDivergence` (``raise``, and always once
  ``max_restarts`` is spent or no checkpoint exists).

Only the nonfinite guards are armed by default: the monotonicity and
norm-growth thresholds are opt-in (``monotone_rtol`` / ``grow_limit``).
The deterministic fault injectors live in ``dislib_tpu_torch.utils.
faults``.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

__all__ = ["NumericalDivergence", "WatchdogTimeout", "HealthPolicy",
           "ChunkGuard", "Verdict", "Remediation", "NO_REMEDIATION",
           "guard", "health_vec", "check_snapshot", "HEALTH_BASE_LEN"]

# fixed slots of a health vector; per-carry (count, first_flat_index)
# pairs follow, one pair per guarded carry
HEALTH_BASE_LEN = 9
_SLOT_CARRY_NF = 0      # nonfinite total over carries
_SLOT_INPUT_NF = 1      # nonfinite total over inputs (not remediable)
_SLOT_RISE = 2          # worst monotonicity violation over the chunk
_SLOT_SCALE = 3         # max |loss| over the chunk (rise's reference scale)
_SLOT_MAX_ABS = 4       # max |carry| (norm-growth guard)
_SLOT_LOSS_NF = 5       # nonfinite entries in the chunk's loss history —
#                         catches a transient blow-up that washed out of
#                         the carries (e.g. one garbage E-step) but left
#                         the trajectory poisoned
_SLOT_LOSS_VALID = 6    # 1.0 when the chunk produced a loss history (an
#                         explicit flag, NOT a NaN sentinel in the value
#                         slots)
_SLOT_LOSS_FIRST = 7    # chunk's first loss value — the guard compares it
#                         against the PREVIOUS chunk's last loss so the
#                         monotone guard sees cross-chunk jumps too (and
#                         is not structurally dead at every=1, where each
#                         chunk has a single-entry history)
_SLOT_LOSS_LAST = 8     # chunk's last loss value (host-side carry-over)


class NumericalDivergence(RuntimeError):
    """A fit's numerical state went bad (non-finite carries, diverging
    loss, exploding norms) and the remediation policy could not (or was
    configured not to) heal it.  Carries everything a postmortem needs:
    the estimator, the iteration the guard tripped at, which guard, and
    the offending carry coordinates."""

    def __init__(self, message, estimator=None, iteration=None, guard=None,
                 detail=None):
        super().__init__(message)
        self.estimator = estimator
        self.iteration = iteration
        self.guard = guard
        self.detail = detail or {}


class WatchdogTimeout(TimeoutError):
    """A chunk's force point (the health-vector read) exceeded its
    deadline — a hung kernel or copy.  Subclasses ``TimeoutError``
    so the default ``Retry`` classification treats it as transient, which
    is what lets the watchdog escalate through the retry policy
    before the clean abort."""


class HealthPolicy:
    """Configuration for a fit's health guards.

    Parameters (env default in parentheses; the constructor wins)
    ----------
    action : 'retry' | 'halve' | 'reseed' | 'raise' (``DSLIB_HEALTH_ACTION``,
        default 'retry') — what :meth:`ChunkGuard.remediate` does on a
        recoverable trip.  'halve' doubles the guard's ``damping`` factor
        per restart (estimators with a damping knob apply it); 'reseed'
        perturbs the restored carries with a seeded jitter; both fall
        back to plain rollback-and-retry semantics where the estimator
        has no such knob.
    max_restarts : int (``DSLIB_HEALTH_MAX_RESTARTS``, default 2) —
        rollbacks allowed before the typed raise.
    deadline_s : float | None (``DSLIB_CHUNK_DEADLINE_S``, default off) —
        chunk watchdog deadline on the health read's force point.
    first_deadline_s : float | None (``DSLIB_CHUNK_FIRST_DEADLINE_S``,
        default ``10 * deadline_s``) — deadline for the guard's FIRST
        check only: that force point usually blocks on a kernel's first
        build (``nvcc``, seconds), which a steady-state deadline would
        misread as a hang.
    monotone_rtol : float | None (``DSLIB_HEALTH_MONOTONE_RTOL``, default
        off) — trip when the chunk's loss history rises (falls, for
        increasing metrics) by more than ``rtol * max(|loss|, 1)``.
    grow_limit : float | None (``DSLIB_HEALTH_GROW_LIMIT``, default off)
        — trip when ``max|carry|`` exceeds this.
    enabled : bool (``DSLIB_HEALTH``, default on) — master switch; a
        disabled policy's guard admits everything and never trips.
    seed : int — base seed of the 'reseed' perturbation stream.
    elastic_attempts : int (``DSLIB_HEALTH_ELASTIC_ATTEMPTS``, default 0)
        — rollback attempts the fit-loop escalation ladder may spend at
        the elastic tier (the LAST rungs of the shared ``max_restarts``
        budget; see ``runtime.fitloop``).  On the port's one-card mesh
        that tier cannot shrink the mesh and runs as a plain retry.
    grow_attempts : int (``DSLIB_HEALTH_GROW_ATTEMPTS``, default 2) —
        kept for the reference's API: mesh grow-back resizes come with
        the capacity plan (ROADMAP.md A.11), so no port fit spends it.
    """

    def __init__(self, action=None, max_restarts=None, deadline_s=None,
                 monotone_rtol=None, grow_limit=None, enabled=None, seed=0,
                 first_deadline_s=None, elastic_attempts=None,
                 grow_attempts=None):
        env = os.environ
        if action is None:
            action = env.get("DSLIB_HEALTH_ACTION", "retry")
        if action not in ("retry", "halve", "reseed", "raise"):
            raise ValueError(f"unknown health action {action!r}")
        self.action = action
        self.max_restarts = int(env.get("DSLIB_HEALTH_MAX_RESTARTS", 2)) \
            if max_restarts is None else int(max_restarts)
        if deadline_s is None and env.get("DSLIB_CHUNK_DEADLINE_S"):
            deadline_s = float(env["DSLIB_CHUNK_DEADLINE_S"])
        self.deadline_s = deadline_s
        if first_deadline_s is None and env.get("DSLIB_CHUNK_FIRST_DEADLINE_S"):
            first_deadline_s = float(env["DSLIB_CHUNK_FIRST_DEADLINE_S"])
        if first_deadline_s is None and deadline_s is not None:
            first_deadline_s = 10.0 * deadline_s   # compile-time grace
        self.first_deadline_s = first_deadline_s
        if monotone_rtol is None and env.get("DSLIB_HEALTH_MONOTONE_RTOL"):
            monotone_rtol = float(env["DSLIB_HEALTH_MONOTONE_RTOL"])
        self.monotone_rtol = monotone_rtol
        if grow_limit is None and env.get("DSLIB_HEALTH_GROW_LIMIT"):
            grow_limit = float(env["DSLIB_HEALTH_GROW_LIMIT"])
        self.grow_limit = grow_limit
        self.enabled = (env.get("DSLIB_HEALTH", "1") != "0") \
            if enabled is None else bool(enabled)
        self.seed = int(seed)
        self.elastic_attempts = \
            int(env.get("DSLIB_HEALTH_ELASTIC_ATTEMPTS", 0)) \
            if elastic_attempts is None else int(elastic_attempts)
        self.grow_attempts = \
            int(env.get("DSLIB_HEALTH_GROW_ATTEMPTS", 2)) \
            if grow_attempts is None else int(grow_attempts)

    def make_guard(self, name, checkpoint=None):
        """Build the per-fit guard.  Fault-injection policies
        (``dislib_tpu_torch.utils.faults``) override this to hand the fit a
        corrupting/hanging guard — the deterministic injection seam."""
        return ChunkGuard(name, self, checkpoint)


class Verdict:
    """Outcome of one chunk check: ``ok``, the tripped ``guard`` name
    (``None`` when ok), whether rollback can help (``recoverable``), and
    a ``detail`` dict naming the offending carries/coordinates."""

    __slots__ = ("ok", "guard", "recoverable", "detail")

    def __init__(self, ok, guard=None, recoverable=True, detail=None):
        self.ok = bool(ok)
        self.guard = guard
        self.recoverable = bool(recoverable)
        self.detail = detail or {}

    def __repr__(self):
        return (f"Verdict(ok={self.ok}, guard={self.guard!r}, "
                f"recoverable={self.recoverable}, detail={self.detail})")


class Remediation:
    """What the fit loop should do after rolling back to last-good:
    ``attempt`` (1-based restart count), ``damping`` (multiplier for the
    estimator's damping knob — 2**attempt under the 'halve' action, 1.0
    otherwise), and :meth:`perturb` (seeded jitter for 'reseed')."""

    __slots__ = ("attempt", "action", "damping", "seed")

    def __init__(self, attempt, action, seed):
        self.attempt = int(attempt)
        self.action = action
        self.damping = float(2 ** attempt) if action == "halve" else 1.0
        self.seed = int(seed)

    def perturb(self, arr, scale=1e-3):
        """Seeded relative jitter of a restored carry ('reseed' action;
        identity under every other action).  Deterministic in
        (policy.seed, attempt) so a remediated fit is reproducible: the
        reference's NumPy draw, so a 'reseed' fit matches it.  A tensor
        comes back as a tensor on its own device."""
        if isinstance(arr, torch.Tensor):
            if self.action != "reseed":
                return arr
            host = self.perturb(arr.detach().cpu().numpy())
            return torch.from_numpy(host).to(arr.device)
        arr = np.asarray(arr)
        if self.action != "reseed":
            return arr
        rng = np.random.RandomState((self.seed + 0x9E37) ^ self.attempt)
        span = np.maximum(np.abs(arr), 1.0)
        return (arr + scale * span * rng.standard_normal(arr.shape)) \
            .astype(arr.dtype, copy=False)


class _NoRemediation(Remediation):
    """The identity remediation: attempt 0, no damping, no perturbation —
    what a clean (non-rollback) state load applies."""

    def __init__(self):
        super().__init__(0, "none", 0)

    @staticmethod
    def perturb(arr, scale=1e-3):
        return arr


NO_REMEDIATION = _NoRemediation()


def guard(name, health=None, checkpoint=None):
    """Normalise a ``fit(..., health=...)`` argument into a per-fit
    :class:`ChunkGuard`: ``None`` builds the env-default policy, a
    :class:`HealthPolicy` (or fault-injection subclass) builds its own
    guard, and an existing guard passes through."""
    if isinstance(health, ChunkGuard):
        return health
    policy = health if isinstance(health, HealthPolicy) else HealthPolicy()
    return policy.make_guard(name, checkpoint)


class ChunkGuard:
    """Per-fit health guard: admits carries into each chunk (the fault
    injectors' corruption seam), checks the chunk's fused health vector
    under the watchdog, gates snapshot writes on the verdict, and runs
    the remediation bookkeeping."""

    def __init__(self, name, policy, checkpoint=None):
        self.name = name
        self.policy = policy
        self.checkpoint = checkpoint
        self.chunk_index = 0            # admits seen (0-based chunk counter)
        self.restarts = 0
        self.last_verdict = Verdict(True)
        self._prev_loss_last = None     # last HEALTHY chunk's final loss —
        #                                 the cross-chunk monotone reference
        self._checks_done = 0           # first check gets the compile grace

    # -- carry admission (fault-injection seam) -------------------------

    def admit(self, *carries):
        """Pass the chunk's input carries through the guard.  Production
        guards return them unchanged; fault-injection guards corrupt them
        at an exact chunk index.  Always call it once per chunk — it is
        also the chunk counter."""
        self.chunk_index += 1
        return carries

    # -- the watchdogged check ------------------------------------------

    def _resolve(self, handle):
        """Blocking resolution of one health read (the chunk's force
        point): waits on the ``AsyncFetch`` copy's CUDA event.  Fault
        injectors override this to simulate a hung kernel."""
        return handle.result() if hasattr(handle, "result") \
            else np.asarray(handle)

    def _watched_resolve(self, handle):
        # the guard's first check usually blocks on a kernel's first build
        # (nvcc), not a hung kernel — give it the compile-grace deadline
        deadline = self.policy.first_deadline_s if self._checks_done == 0 \
            else self.policy.deadline_s
        if deadline is None:
            return self._resolve(handle)
        box = {}

        def run():
            try:
                box["value"] = self._resolve(handle)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                box["exc"] = e

        t = threading.Thread(target=run, name="dslib-chunk-watchdog",
                             daemon=True)
        t.start()
        t.join(deadline)
        if t.is_alive():
            from dislib_tpu_torch.utils.profiling import count_resilience
            count_resilience("watchdog_trips")
            raise WatchdogTimeout(
                f"{self.name}: chunk {self.chunk_index} force point "
                f"exceeded its {deadline}s deadline — hung kernel or "
                "dispatch")
        if "exc" in box:
            raise box["exc"]
        return box["value"]

    def read(self, t, site):
        """A read INSIDE a chunk (``runtime/loop.run_chunked``'s stop
        flag): the Python value of the one-element tensor ``t``, counted
        under ``site``.  With a deadline it goes through the same watched,
        retried resolution as :meth:`check`, so the first blocking read of
        every chunk is under the watchdog; without one it is a plain
        ``host_read``."""
        if not self.policy.enabled or self.policy.deadline_s is None:
            from dislib_tpu_torch.utils.profiling import host_read
            return host_read(t, site)
        from dislib_tpu_torch.runtime.elastic import AsyncFetch
        from dislib_tpu_torch.runtime.retry import Retry
        handle = AsyncFetch(t, site=site)
        return np.asarray(Retry.from_env().call(
            lambda: self._watched_resolve(handle))).reshape(-1)[0].item()

    def check(self, hvec, carry_names=(), carry_shapes=(), it=None,
              increasing=False):
        """Classify one chunk's health vector (device array, AsyncFetch
        handle, or host ndarray) into a :class:`Verdict`.

        The device→host copy is enqueued asynchronously first
        (``fetch(blocking=False)`` semantics) and resolved under the
        watchdog deadline; resolution failures escalate through the
        ``Retry`` policy (``WatchdogTimeout`` classifies transient) and
        re-raise typed once attempts are exhausted.  ``increasing``
        states the loss direction (must match the ``health_vec`` call)
        so the cross-chunk monotone comparison is signed correctly."""
        if not self.policy.enabled:
            self.last_verdict = Verdict(True)
            return self.last_verdict
        from dislib_tpu_torch.runtime.elastic import AsyncFetch
        from dislib_tpu_torch.runtime.retry import Retry
        if isinstance(hvec, np.ndarray) or hasattr(hvec, "result"):
            handle = hvec               # host values, or a handle whose
            #                             copy is already enqueued
        else:
            handle = AsyncFetch(hvec, site="health")   # copy enqueued
            #                                           before resolution
        try:
            h = np.asarray(Retry.from_env().call(
                lambda: self._watched_resolve(handle)), np.float64).ravel()
        finally:
            self._checks_done += 1
        v = self._classify(h, carry_names, carry_shapes, it, increasing)
        self.last_verdict = v
        if v.ok and len(h) > _SLOT_LOSS_LAST and \
                h[_SLOT_LOSS_VALID] > 0:
            self._prev_loss_last = float(h[_SLOT_LOSS_LAST])
        return v

    def check_host(self, values, it=None):
        """Host-value variant for loops whose per-chunk state is already
        on host (the cascade SVM's level merges): ``values`` maps carry
        name → ndarray/scalar; trips the nonfinite guard only."""
        if not self.policy.enabled:
            self.last_verdict = Verdict(True)
            return self.last_verdict
        bad = {}
        for name, val in values.items():
            arr = np.asarray(val, np.float64)
            nf = ~np.isfinite(arr)
            if nf.any():
                bad[name] = {"count": int(nf.sum()),
                             "first_index": int(np.flatnonzero(nf.ravel())[0])}
        if bad:
            v = Verdict(False, guard="nonfinite", recoverable=True,
                        detail={"carries": bad, "iteration": it})
        else:
            v = Verdict(True)
        self.last_verdict = v
        return v

    def _classify(self, h, carry_names, carry_shapes, it,
                  increasing=False):
        pol = self.policy
        detail = {"hvec": h.tolist(), "iteration": it}
        if h[_SLOT_CARRY_NF] > 0 or h[_SLOT_INPUT_NF] > 0 \
                or h[_SLOT_LOSS_NF] > 0:
            carries = {}
            for i in range(max(0, (len(h) - HEALTH_BASE_LEN) // 2)):
                cnt = h[HEALTH_BASE_LEN + 2 * i]
                if cnt <= 0:
                    continue
                name = carry_names[i] if i < len(carry_names) else f"carry{i}"
                info = {"count": int(cnt),
                        "first_index": int(h[HEALTH_BASE_LEN + 2 * i + 1])}
                if i < len(carry_shapes) and carry_shapes[i]:
                    info["coords"] = tuple(
                        int(c) for c in np.unravel_index(
                            min(info["first_index"],
                                int(np.prod(carry_shapes[i])) - 1),
                            carry_shapes[i]))
                carries[name] = info
            detail["carries"] = carries
            if h[_SLOT_LOSS_NF] > 0:
                detail["loss_nonfinite"] = int(h[_SLOT_LOSS_NF])
            if h[_SLOT_INPUT_NF] > 0:
                detail["input_nonfinite"] = int(h[_SLOT_INPUT_NF])
                # bad *input* data: a rollback re-reads the same data, so
                # remediation cannot help — quarantine at ingest instead
                return Verdict(False, guard="input-nonfinite",
                               recoverable=False, detail=detail)
            return Verdict(False, guard="nonfinite", detail=detail)
        if pol.monotone_rtol is not None:
            rise = float(h[_SLOT_RISE])
            # cross-chunk jump: previous healthy chunk's last loss vs this
            # chunk's first — the boundary the in-chunk diffs cannot see
            # (and at every=1 the ONLY signal, each history being length 1)
            if self._prev_loss_last is not None \
                    and len(h) > _SLOT_LOSS_FIRST \
                    and h[_SLOT_LOSS_VALID] > 0:
                step = h[_SLOT_LOSS_FIRST] - self._prev_loss_last
                rise = max(rise, float(-step if increasing else step))
            if rise > pol.monotone_rtol * max(h[_SLOT_SCALE], 1.0):
                detail["rise"] = rise
                detail["scale"] = float(h[_SLOT_SCALE])
                return Verdict(False, guard="divergence", detail=detail)
        if pol.grow_limit is not None and h[_SLOT_MAX_ABS] > pol.grow_limit:
            detail["max_abs"] = float(h[_SLOT_MAX_ABS])
            return Verdict(False, guard="norm-growth", detail=detail)
        return Verdict(True)

    def on_escalation(self, escalation) -> None:
        """Notification hook the fit-loop driver fires after every
        ladder escalation (``runtime.fitloop.Escalation``).  Production
        guards ignore it; tier-targeted fault injectors
        (``utils.faults.FaultAtTier``) use it to stop firing once the
        right remediation tier is reached."""

    # -- gated snapshot writes ------------------------------------------

    def save_async(self, checkpoint, state):
        """Snapshot gate: forward to ``checkpoint.save_async`` ONLY when
        the last check was healthy — an unhealthy chunk's state must
        never rotate the last good generation away."""
        if not self.last_verdict.ok:
            return None
        return checkpoint.save_async(state)

    def save(self, checkpoint, state):
        """Blocking variant of the gated write."""
        if not self.last_verdict.ok:
            return None
        return checkpoint.save(state)

    # -- remediation ------------------------------------------------------

    def remediate(self, verdict=None, it=None):
        """Decide the response to a tripped guard: return a
        :class:`Remediation` (the caller rolls back to last-good and
        re-runs), or raise :class:`NumericalDivergence` when the policy
        says raise, the trip is not recoverable (bad input data), there
        is no checkpoint to roll back to, or ``max_restarts`` is spent."""
        v = verdict if verdict is not None else self.last_verdict
        it = v.detail.get("iteration") if it is None else it
        reasons = []
        if self.policy.action == "raise":
            reasons.append("policy action is 'raise'")
        if not v.recoverable:
            reasons.append("non-finite input data cannot be healed by "
                           "rollback (quarantine it at ingest)")
        if self.checkpoint is None:
            reasons.append("no checkpoint to roll back to (pass "
                           "checkpoint= to enable self-healing)")
        if self.restarts >= self.policy.max_restarts:
            reasons.append(f"max_restarts={self.policy.max_restarts} "
                           "exhausted")
        if reasons:
            raise NumericalDivergence(
                f"{self.name}: health guard {v.guard!r} tripped at "
                f"iteration {it} — {'; '.join(reasons)} "
                f"(detail: {v.detail})",
                estimator=self.name, iteration=it, guard=v.guard,
                detail=v.detail)
        self.restarts += 1
        # the rollback (and any halve/reseed perturbation) breaks loss
        # continuity — drop the cross-chunk monotone reference so the
        # re-run chunk is not judged against the pre-rollback trajectory
        self._prev_loss_last = None
        return Remediation(self.restarts, self.policy.action,
                           self.policy.seed + self.restarts)

    def rollback(self, restore, scratch, remediation=None, checkpoint=None,
                 expect=None):
        """Load the newest good snapshot and hand it to
        ``restore(snap, remediation)``; fall back to
        ``scratch(remediation)`` when no snapshot exists (or there is no
        checkpoint at all).  The ONE state-(re)load path every rollback,
        elastic resize, and initial warm start of the fit loop funnels
        through — so the snapshot-vs-scratch dispatch and the remediation
        threading cannot drift between call sites.  ``checkpoint``
        overrides the guard's own (the fit-loop driver passes its sink:
        an injected guard may carry none).

        ``expect`` declares what a compatible snapshot must contain (see
        :func:`check_snapshot`); a mismatch raises the shared
        "stale or foreign snapshot" ``ValueError`` BEFORE ``restore``
        runs — the estimators' five copy-pasted validation blocks
        collapsed here (round 19), and the health-guard lint keeps them
        from growing back."""
        rem = NO_REMEDIATION if remediation is None else remediation
        ck = self.checkpoint if checkpoint is None else checkpoint
        snap = ck.load() if ck is not None else None
        if snap is not None and expect:
            check_snapshot(self.name, snap, expect)
        return restore(snap, rem) if snap is not None else scratch(rem)


def check_snapshot(name, snap, expect):
    """Validate a loaded snapshot against the estimator's declared
    expectations — the one place the "stale or foreign snapshot" raise
    lives.  ``expect`` maps snapshot key -> spec:

    - a tuple is a required shape; ``None`` dims are wildcards (elastic
      factor rows repadded per mesh, e.g. ALS's ``(None, n_f)``);
    - an int is a required scalar value (logical dims like ALS's
      ``m``/``n``, which outlive any padding).

    A missing key or a mismatch raises ``ValueError`` mentioning
    "stale or foreign snapshot" (tests and callers match on the phrase).
    Estimators declare this via ``ChunkedFitLoop(snapshot_expect=...)``
    rather than hand-checking in their ``restore`` callbacks.
    """
    for key, spec in expect.items():
        if key not in snap:
            raise ValueError(
                f"{name}: checkpoint is missing {key!r} — stale or "
                "foreign snapshot")
        if isinstance(spec, tuple):
            got = tuple(np.asarray(snap[key]).shape)
            want = tuple(spec)
            if len(got) != len(want) or any(
                    w is not None and g != w for g, w in zip(got, want)):
                shown = tuple("*" if w is None else w for w in want)
                raise ValueError(
                    f"{name}: checkpoint {key!r} shape {got} does not "
                    f"match this estimator/data {shown} — stale or "
                    "foreign snapshot")
        else:
            got = int(np.asarray(snap[key]))
            if got != int(spec):
                raise ValueError(
                    f"{name}: checkpoint {key!r} = {got} does not match "
                    f"this estimator/data ({int(spec)}) — stale or "
                    "foreign snapshot")


def _masked_max(x: torch.Tensor) -> torch.Tensor:
    """max(0, max(x)) — 0 for an empty x (``jnp.max(initial=0.0)``)."""
    if x.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=x.device)
    return torch.clamp_min(x.max().to(torch.float32), 0.0)


def health_vec(carries=(), inputs=(), hist=None, n_done=None,
               increasing=False) -> torch.Tensor:
    """Build the (HEALTH_BASE_LEN + 2·len(carries),) float32 health vector
    on the device, from a fit's final carries, without a host sync.

    Layout: ``[carry_nonfinite_total, input_nonfinite_total, rise, scale,
    max_abs_carry, loss_nonfinite, loss_valid, loss_first, loss_last,
    (count, first_flat_index) per carry]`` — the reference's layout.
    ``hist``/``n_done``: the per-iteration loss history (slots beyond
    ``n_done`` ignored); ``rise`` is the worst consecutive violation of
    monotonicity (losses must fall, or rise when ``increasing=True``) and
    ``scale`` its reference magnitude."""
    tensors = [torch.as_tensor(t) for t in (*carries, *inputs)]
    if hist is not None:
        tensors.append(torch.as_tensor(hist))
    dev = tensors[0].device if tensors else torch.device("cpu")
    z = torch.zeros((), dtype=torch.float32, device=dev)

    def _stats(c, with_max=True):
        # (non-finite count, first non-finite flat index — 0 when none —
        # and max |finite value|) of a float tensor, in 5 launches: the
        # vector is built after every chunk (every batch of a stream)
        c = torch.as_tensor(c)
        if not torch.is_floating_point(c) or c.numel() == 0:
            return None
        flat = c.reshape(-1)
        fin = torch.isfinite(flat)
        count = flat.numel() - fin.sum()
        first = torch.argmin(fin.view(torch.uint8))
        # NaNs must not mask a finite blow-up elsewhere; they already
        # trip the nonfinite guard themselves
        mx = torch.where(fin, flat.abs(), 0).amax() if with_max else None
        return count, first, mx

    cstats = [_stats(c) for c in carries]
    ints = [v for st in cstats if st is not None for v in st[:2]]
    ints += [st[0] for st in (_stats(x, False) for x in inputs)
             if st is not None]
    ints = torch.stack(ints).to(torch.float32) if ints else None
    pairs, k, n_cnt = [], 0, sum(st is not None for st in cstats)
    for st in cstats:
        if st is None:
            pairs.extend([z, z])
        else:
            pairs.extend([ints[2 * k], ints[2 * k + 1]])
            k += 1
    carry_nf = ints[0: 2 * n_cnt: 2].sum() if n_cnt else z
    input_nf = ints[2 * n_cnt:].sum() \
        if ints is not None and ints.numel() > 2 * n_cnt else z
    mxs = [st[2] for st in cstats if st is not None]
    max_abs = torch.stack(mxs).amax().to(torch.float32) if mxs else z
    rise = scale = loss_nf = loss_valid = loss_first = loss_last = z
    if hist is not None:
        hist = torch.as_tensor(hist).to(torch.float32).reshape(-1)
        n = hist.shape[0]
        if n >= 1:
            idx = torch.arange(n, device=dev)
            done = torch.as_tensor(n if n_done is None else n_done,
                                   device=dev).to(torch.int64)
            valid = idx < done
            fin = torch.isfinite(hist)
            loss_nf = (valid & ~fin).sum().to(torch.float32)
            scale = _masked_max(torch.where(valid & fin, hist.abs(),
                                            torch.zeros_like(hist)))
            ran = done >= 1
            loss_valid = ran.to(torch.float32)
            h0 = hist[0]
            hl = hist[torch.clamp(done - 1, 0, n - 1)]
            loss_first = torch.where(ran & torch.isfinite(h0), h0, z)
            loss_last = torch.where(ran & torch.isfinite(hl), hl, z)
            loss_valid = torch.where(torch.isfinite(h0) & torch.isfinite(hl),
                                     loss_valid, z)
            if n >= 2:
                diffs = hist[1:] - hist[:-1]
                dvalid = (idx[1:] < done) & torch.isfinite(diffs)
                viol = -diffs if increasing else diffs
                rise = _masked_max(torch.where(dvalid, viol,
                                               torch.zeros_like(viol)))
    out = [carry_nf, input_nf, rise, scale, max_abs, loss_nf, loss_valid,
           loss_first, loss_last, *pairs]
    return torch.stack([o.to(torch.float32) for o in out])
