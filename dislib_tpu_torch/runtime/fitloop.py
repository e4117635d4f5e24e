"""The resilient chunk-fit runtime: the one driver every iterative fit
runs on.

Counterpart of ``dislib_tpu/runtime/fitloop.py``.  :class:`ChunkedFitLoop`
owns the per-chunk protocol: admit the carries through the guard (the
fault-injection seam), run one chunk, judge its health vector under the
watchdog, commit the deferred state, gate the snapshot write on the
verdict, roll back to the last good generation on a trip, and poll the
preemption flag at the boundary.  An estimator supplies:

- ``init(rem)``    — build a fresh :class:`LoopState` (``rem`` perturbs /
  damps after a rollback with no snapshot; the initial call passes a
  neutral remediation, so closures never branch on None);
- ``restore(snap, rem)`` — rebuild state from a snapshot dict (validate,
  apply ``rem``); raise ``ValueError`` on a stale/foreign snapshot;
- ``step(state, chunk)`` — run ONE chunk on ``state.carries`` (already
  passed through the guard's admit seam) and return a
  :class:`ChunkOutcome` whose ``hvec`` (fused health vector, or a handle
  on its part of the chunk's packed read) or ``host_values`` the driver
  judges;

plus a ``snapshot(state) -> dict`` builder, called only at save
boundaries.  A chunk of k iterations is the estimator's device loop
(``runtime/loop.run_chunked``) with ``max_iter = k``, so the masked steps
are the unchecked fit's.

Successive trips of one fit escalate through the tiers of
:class:`EscalationLadder` with a shared budget (``HealthPolicy.
max_restarts``): **retry** (plain rollback and re-run), **remediate**
(rollback plus the policy action: ``halve`` doubles the damping knob,
``reseed`` perturbs the restored carries), **elastic**, then the typed
raise.  On the port's one-card (1, 1) mesh the elastic tier cannot
shrink the mesh: it degrades to a plain retry that still calls the
estimator's rebind hook in both phases, as the reference's
``_shrink_mesh`` does on a one-row mesh, and counts in
``info["escalations"]["elastic"]``.  Streaming estimators call
:meth:`ChunkedFitLoop.run_one` (one committed chunk per ``partial_fit``
call; budget and cadence stream-wide).

Not ported yet: the capacity plan (the reference polls
``capacity_target`` at each boundary and shrinks or grows the mesh),
which needs several cards (ROADMAP.md A.11); ``info["mesh_shrinks"]`` and
``info["mesh_grows"]`` stay 0.
"""

from __future__ import annotations

from dislib_tpu_torch.runtime import health as _health
from dislib_tpu_torch.runtime.health import NO_REMEDIATION
from dislib_tpu_torch.parallel import distributed as _dist
from dislib_tpu_torch.runtime.preemption import (preemption_requested,
                                                 raise_if_preempted)
from dislib_tpu_torch.utils.profiling import count_resilience

__all__ = ["ChunkedFitLoop", "LoopState", "ChunkOutcome", "Escalation",
           "EscalationLadder", "NO_REMEDIATION", "TIERS", "data_rebind",
           "stream_state"]

TIERS = ("retry", "remediate", "elastic")

def stream_state(checkpoint, key="n_batches"):
    """``(consumed, snapshot_dict)`` of a STREAMING fit's checkpoint —
    ``(0, None)`` when there is no usable snapshot.  The producer-side
    resume point: the driver restores the MODEL state, but only the
    producer knows the batch order, so it must feed ``run_one`` batches
    from this position on (re-feeding consumed batches would apply them
    twice); a fully consumed stream adopts the snapshot as the fitted
    state.  Lives here so estimator code never reads checkpoints
    directly (the driver lint forbids it)."""
    snap = checkpoint.load() if checkpoint is not None else None
    if snap is None or key not in snap:
        return 0, None
    return int(snap[key]), snap


def data_rebind(holder, key="x"):
    """The standard elastic-tier rebind hook over a mutable data holder
    (``{key: ds_array}``): materialise a pending op chain before the
    switch (``mesh=None``), re-canonicalise after it.  Objects exposing
    ``rebind_mesh(mesh)`` (an ``IVFIndex``) own their re-layout.  On the
    one-card mesh both phases leave the data where it is."""
    def hook(mesh):
        from dislib_tpu_torch.data.array import Array, ensure_canonical
        x = holder.get(key)
        if hasattr(x, "rebind_mesh"):
            x.rebind_mesh(mesh)
            return
        if isinstance(x, Array):
            holder[key] = x.force() if mesh is None else ensure_canonical(x)
    return hook


class LoopState:
    """One point of a chunked fit: ``carries`` (the device arrays that
    flow chunk-to-chunk — the guard's admit/poison seam), ``it``
    (completed iterations/levels/rounds), ``done`` (converged), and
    ``extra`` (estimator-owned scalars riding along, e.g. the current
    loss)."""

    __slots__ = ("carries", "it", "done", "extra")

    def __init__(self, carries=(), it=0, done=False, extra=None):
        self.carries = tuple(carries)
        self.it = int(it)
        self.done = bool(done)
        self.extra = extra


class ChunkOutcome:
    """What one chunk produced: the successor ``state``, the fused
    health ``hvec`` (device array — judged under the watchdog) or
    ``host_values`` (name → ndarray, for loops whose state is host-side),
    and ``history`` (this chunk's per-iteration loss values; the driver
    owns the cross-rollback trimming).

    ``state`` and ``history`` may each be a CALLABLE (deferred commit):
    the driver invokes them only AFTER the chunk's verdict passed.  Step
    closures whose successor state needs device scalars (``int(n_done)``,
    ``float(shift)``, a fetched ``changed`` flag) MUST defer them this
    way: the hvec is an output of the same fused program, so resolving it
    first — under the watchdog deadline — forces the whole chunk, and a
    hung collective trips a typed ``WatchdogTimeout`` instead of blocking
    forever in an estimator-side sync (review-found: the eager ports left
    real kernel hangs outside the watchdog).  A deferred state also
    cannot leak a faulted chunk's side effects — its closure never runs
    on the rollback path.  ``check_on='save'`` loops (the forest) must
    keep ``state`` eager: the save-boundary decision reads ``state.done``
    before any check."""

    __slots__ = ("state", "hvec", "host_values", "history")

    def __init__(self, state, hvec=None, host_values=None, history=()):
        self.state = state
        self.hvec = hvec
        self.host_values = host_values
        self.history = history


class Escalation:
    """One rung of the ladder: the ``tier`` this attempt runs at, the
    global ``attempt`` number (1-based, = the guard's restart count), the
    1-based ``tier_attempt`` within the tier, and the tier-adjusted
    ``remediation`` the estimator's restore/init closures apply."""

    __slots__ = ("tier", "tier_index", "attempt", "tier_attempt",
                 "remediation")

    def __init__(self, tier, attempt, tier_attempt, remediation):
        self.tier = tier
        self.tier_index = TIERS.index(tier)
        self.attempt = attempt
        self.tier_attempt = tier_attempt
        self.remediation = remediation


class EscalationLadder:
    """Maps the guard's restart counter onto tiers.  The schedule spends
    the shared budget (``max_restarts``) as: 1 plain retry, then policy
    remediation, then ``elastic_attempts`` mesh-shrink attempts (last —
    most disruptive), then the typed raise.  The raise conditions
    (non-recoverable trip, 'raise' action, no checkpoint, spent budget)
    stay with :meth:`ChunkGuard.remediate` so diagnostics cannot drift."""

    def __init__(self, guard, elastic_ok=False):
        self.guard = guard
        pol = guard.policy
        budget = max(0, int(pol.max_restarts))
        retry_n = min(1, budget)
        elastic_n = min(max(0, int(getattr(pol, "elastic_attempts", 0))),
                        budget - retry_n) if elastic_ok else 0
        self.schedule = (["retry"] * retry_n
                         + ["remediate"] * (budget - retry_n - elastic_n)
                         + ["elastic"] * elastic_n)

    def escalate(self, verdict, it=None) -> Escalation:
        rem = self.guard.remediate(verdict, it=it)   # typed-raise gate
        a = rem.attempt
        tier = self.schedule[a - 1] if 0 < a <= len(self.schedule) \
            else "remediate"
        tier_attempt = self.schedule[: a].count(tier) or 1
        action = self.guard.policy.action if tier == "remediate" else "retry"
        esc = Escalation(tier, a, tier_attempt,
                         _health.Remediation(tier_attempt, action, rem.seed))
        count_resilience("rollbacks")
        count_resilience("escalations_" + tier)
        if tier == "retry":
            count_resilience("chunk_retries")
        self.guard.on_escalation(esc)
        return esc


class ChunkedFitLoop:
    """The one driver every chunked fit runs on.

    Parameters
    ----------
    name : str — estimator name for guards/diagnostics.
    checkpoint : FitCheckpoint | None — rollback target + save sink; None
        runs the protocol without snapshots (a recoverable trip then
        raises typed, as before).
    health : HealthPolicy | ChunkGuard | None — the fit's policy (fault
        injectors are policy subclasses; see ``utils.faults``).
    max_iter : int | None — iteration budget; None = run until a chunk
        reports ``done`` (propagation/extraction loops).
    chunk_iters : int | None — iterations per chunk; None = the
        checkpoint's ``every`` (whole budget when no checkpoint).  Loops
        whose natural chunk is one host iteration/level (cascade SVM,
        forest) pass 1 and move the cadence to ``save_every``.
    save_every : int — snapshot every N committed chunks (1 = each).
    check_on : 'chunk' | 'save' — judge every chunk, or only at save
        boundaries (the forest's cadence: its per-level health vector is
        read once per snapshot chunk, one sync per chunk either way).
        With ``check_on='save'`` and no checkpoint the loop never judges
        (the forest defers to its adoption-time check).
    save_final : bool — whether the converged/final state snapshots
        (the forest's growth loop snapshots only resumable mid-points).
    carry_names / carry_shapes / increasing — forwarded to
        ``guard.check`` for diagnostics and the monotone direction.
    snapshot_expect : dict | None — the snapshot compatibility contract
        (key -> required shape tuple with ``None`` wildcards, or required
        scalar); validated by ``health.check_snapshot`` inside the one
        rollback funnel before any ``restore`` callback runs, raising the
        shared "stale or foreign snapshot" ``ValueError`` on mismatch.
    elastic : callable(mesh) | None — rebind hook for the elastic tier:
        called with None before and with the mesh after the (would-be)
        switch.  None disables the tier for this fit.
    mesh : parallel.mesh.Mesh | None — the fit's mesh; on one with a
        process group the preemption flag and each chunk's health verdict
        are agreed across its ranks (``distributed.any_rank``), so that
        every rank stops, raises or goes on at the same chunk (the stop
        flag already is: it comes from all-reduced values).

    ``info`` carries the fit's resilience summary (chunks, rollbacks,
    escalations per tier, mesh shrinks/grows) — estimators expose it as
    ``fit_info_``; the same events also feed the process-wide
    ``utils.profiling`` resilience counters.
    """

    def __init__(self, name, *, checkpoint=None, health=None, max_iter=None,
                 chunk_iters=None, save_every=1, check_on="chunk",
                 save_final=True, carry_names=(), carry_shapes=(),
                 increasing=False, elastic=None, snapshot_expect=None,
                 mesh=None):
        self.name = name
        self.mesh = mesh
        self.checkpoint = checkpoint
        self.guard = _health.guard(name, health, checkpoint)
        self.max_iter = max_iter
        self.chunk_iters = chunk_iters
        self.save_every = max(1, int(save_every))
        self.check_on = check_on
        self.save_final = bool(save_final)
        self.carry_names = tuple(carry_names)
        self.carry_shapes = tuple(carry_shapes)
        self.increasing = bool(increasing)
        self.elastic = elastic
        # snapshot compatibility contract, validated by the ONE rollback
        # funnel (guard.rollback -> health.check_snapshot) before any
        # restore callback sees the snapshot; streaming estimators may
        # reassign it per call (the stream's width can change the want)
        self.snapshot_expect = dict(snapshot_expect) if snapshot_expect \
            else None
        self.ladder = EscalationLadder(self.guard,
                                       elastic_ok=elastic is not None)
        self.history: list = []
        self.info = {"chunks": 0, "rollbacks": 0, "mesh_shrinks": 0,
                     "mesh_grows": 0,
                     "escalations": dict.fromkeys(TIERS, 0)}
        self._state = None
        self._esc = None
        self._it0 = None
        self._cadence = 0
        self._preempt = False

    # -- protocol pieces -------------------------------------------------

    def _load_state(self, init, restore, rem=NO_REMEDIATION) -> LoopState:
        st = self.guard.rollback(restore, init, rem,
                                 checkpoint=self.checkpoint,
                                 expect=self.snapshot_expect)
        if self._it0 is None:
            self._it0 = st.it           # this-run history starts here
        del self.history[max(0, st.it - self._it0):]
        self._cadence = 0               # snapshot cadence re-anchors
        return st

    def _plan(self, state):
        if self.max_iter is None:
            return None
        left = self.max_iter - state.it
        if self.chunk_iters is not None:
            return min(self.chunk_iters, left)
        return left if self.checkpoint is None \
            else min(self.checkpoint.every, left)

    def _one_chunk(self, st, step, chunk):
        """admit → step → judge (watchdogged) → materialize the deferred
        commit.  Returns ``(state, history)``, or None after a rollback
        was decided (``self._esc`` holds the escalation).  The preemption
        flag is polled ONCE here and reused by ``_commit`` — two
        independent polls could let a flag arriving between them snapshot
        a chunk whose health vector was never judged (check_on='save')."""
        carries = self.guard.admit(*st.carries)
        out = step(LoopState(carries, st.it, st.done, st.extra), chunk)
        self._preempt = preemption_requested()
        if self.mesh is not None:
            self._preempt = _dist.any_rank(self._preempt, self.mesh)
        if self.check_on == "chunk":
            do_check = True
        else:                           # 'save': judge at save boundaries
            boundary = out.state.done \
                or (self._cadence + 1) % self.save_every == 0 \
                or self._preempt
            do_check = self.checkpoint is not None and boundary
        if do_check:
            if out.host_values is not None:
                verdict = self.guard.check_host(out.host_values, it=st.it)
            elif out.hvec is not None:
                verdict = self.guard.check(
                    out.hvec, carry_names=self.carry_names,
                    carry_shapes=self.carry_shapes, it=st.it,
                    increasing=self.increasing)
            else:
                verdict = None
            verdict = self._agreed(verdict, st.it)
            if verdict is not None and not verdict.ok:
                esc = self.ladder.escalate(verdict, it=st.it)  # may raise
                self.info["rollbacks"] += 1
                self.info["escalations"][esc.tier] += 1
                if esc.tier == "elastic":
                    self._shrink_mesh()
                self._esc = esc
                return None
        state = out.state() if callable(out.state) else out.state
        hist = out.history() if callable(out.history) else out.history
        return state, hist

    def _agreed(self, verdict, it):
        """The chunk's verdict, agreed across the ranks of a multi-rank
        fit (``distributed.any_rank``): a trip on any rank trips every
        rank — on a rank whose own check passed, as the typed guard
        ``'peer'`` (not recoverable: a multi-rank fit has no snapshot to
        roll back to) — so no rank goes on into a collective that its
        peers have left."""
        if self.mesh is None or self.mesh.groups is None:
            return verdict
        bad = verdict is not None and not verdict.ok
        if _dist.any_rank(bad, self.mesh) and not bad:
            return _health.Verdict(False, guard="peer", recoverable=False,
                                   detail={"iteration": it,
                                           "tripped_on": "another rank"})
        return verdict

    def _commit(self, st, hist, snapshot):
        self.info["chunks"] += 1
        self._cadence += 1
        if hist is not None and len(hist):
            self.history.extend(hist)
        if self.checkpoint is None:
            return
        boundary = st.done or self._cadence % self.save_every == 0
        if (boundary or self._preempt) \
                and (not st.done or self.save_final):
            self.guard.save_async(self.checkpoint, snapshot(st))
        if self._preempt and not st.done \
                and (self.max_iter is None or st.it < self.max_iter):
            raise_if_preempted(self.checkpoint)

    def _shrink_mesh(self):
        """Elastic tier on the one-card mesh: there is no row axis to
        halve, so the attempt degrades to a plain retry, as the
        reference's does on a one-row mesh — the rebind hook still runs
        both phases (before and after the would-be switch)."""
        from dislib_tpu_torch.parallel import mesh as _mesh
        if self.elastic is not None:
            self.elastic(None)
            self.elastic(_mesh.get_mesh())

    # -- entry points ----------------------------------------------------

    def run(self, *, init, step, restore=None, snapshot=None) -> LoopState:
        """Drive a whole fit: chunks until converged/budget-spent, the
        full protocol per chunk.  Returns the final state (also kept as
        ``self.state``); flushes the checkpoint before returning."""
        st = self._load_state(init, restore)
        while not st.done:
            chunk = self._plan(st)
            if chunk is not None and chunk <= 0:
                break
            got = self._one_chunk(st, step, chunk)
            if got is None:             # rolled back: reload last-good
                st = self._load_state(init, restore, self._esc.remediation)
                continue
            st, hist = got
            self._commit(st, hist, snapshot)
        if self.checkpoint is not None:
            self.checkpoint.flush()     # last snapshot lands before return
        self._state = st
        return st

    def run_one(self, *, init, step, restore=None, snapshot=None) -> LoopState:
        """Streaming entry (``partial_fit``): ONE committed chunk per
        call, protocol identical — admit, judge, rollback/escalate until
        the chunk commits (or the typed raise), gated save at the
        cadence, preemption poll.  The loop object persists across calls,
        so the fault budget, save cadence, and escalation state are
        stream-wide; the first call restores from the checkpoint (a
        preempted stream resumes where it snapshot)."""
        st = self._state if self._state is not None \
            else self._load_state(init, restore)
        while True:
            got = self._one_chunk(st, step, None)
            if got is None:
                st = self._load_state(init, restore, self._esc.remediation)
                continue
            st, hist = got
            self._commit(st, hist, snapshot)
            self._state = st
            return st

    @property
    def state(self):
        return self._state
