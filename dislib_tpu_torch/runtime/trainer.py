"""Continuous-learning trainer: train → bundle → canary → promote, with
every seam surviving its faults.

Counterpart of ``dislib_tpu/runtime/trainer.py``.  It connects the
streaming :meth:`~dislib_tpu_torch.runtime.fitloop.ChunkedFitLoop.run_one`
loop, the rotating :class:`~dislib_tpu_torch.utils.checkpoint.
FitCheckpoint`, the deployment bundles and the
:class:`~dislib_tpu_torch.serving.router.ModelRouter` canary/promote
seam:

- **stream seam** — each raw host batch rides the ingest quarantine
  (:func:`dislib_tpu_torch.data.io.quarantine_batch`) before it reaches
  the estimator; a batch that quarantines to nothing is skipped and
  counted, never fed.
- **training seam** — the estimator's ``partial_fit`` rides
  ``ChunkedFitLoop.run_one``, so rollback-to-last-good, the chunk
  watchdog and preemption polling are inherited.  A mid-stream
  :class:`~dislib_tpu_torch.runtime.preemption.Preempted` is counted and
  propagates typed — a restarted trainer resumes from the snapshot.
- **export seam** — one deployment bundle per generation, written through
  :class:`~dislib_tpu_torch.runtime.retry.Retry` and read BACK through
  ``load_bundle`` (CRC-verified, its graphs captured) before anything
  serves it: a torn artifact surfaces as ``SnapshotCorrupt``, classifies
  transient at this seam, and the export retries.
- **promotion seam** — each verified bundle serves first as a
  :meth:`~dislib_tpu_torch.serving.router.ModelRouter.set_canary` arm,
  and is promoted only through the health gate; an unhealthy canary is
  aborted (traffic stays on the last-good generation), and after
  ``promote_budget`` consecutive rejections the trainer raises the typed
  :class:`PromotionFailed` with the last-good generation still serving.

A **promotion ledger** (in memory and appended to
``<bundle_dir>/ledger.jsonl``) records every generation's (generation,
checksum, verdict, counters, wall times).  The served generation is
monotone except by an explicit :meth:`ContinuousTrainer.rollback`.

Env knobs (constructor args override):

- ``DSLIB_TRAINER_BATCHES`` — batches consumed per generation (8);
- ``DSLIB_TRAINER_CANARY_FRACTION`` — canary traffic split (0.5);
- ``DSLIB_TRAINER_PROMOTE_BUDGET`` — consecutive canary rejections
  before the typed :class:`PromotionFailed` (3);
- ``DSLIB_TRAINER_EXPORT_ATTEMPTS`` — bundle-export retry budget (4);
  backoff and jitter ride the ``DSLIB_RETRY_*`` knobs.

Where the port departs: ``membership=`` (a trainer that is one rank of a
multi-host fleet, its lease kept and its peers watched) is ROADMAP.md
A.11 and raises ``NotImplementedError``; the ``fleet`` block of
:meth:`ContinuousTrainer.stats` reports zeros.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from dislib_tpu_torch.runtime.bundle_io import file_crc
from dislib_tpu_torch.runtime.preemption import Preempted
from dislib_tpu_torch.runtime.retry import Retry
from dislib_tpu_torch.utils.checkpoint import SnapshotCorrupt
from dislib_tpu_torch.utils.profiling import count_resilience

__all__ = ["ContinuousTrainer", "PromotionFailed"]


def _env_int(name, default):
    return int(os.environ.get(name, default))


def _env_float(name, default):
    return float(os.environ.get(name, default))


class PromotionFailed(RuntimeError):
    """The canary health gate refused ``attempts`` consecutive
    generations — the promote budget is exhausted and an operator must
    look.  The LAST-GOOD generation is still serving; carries ``tenant``,
    ``generation`` (the last refused one), ``attempts`` and ``last_good``
    (the generation still serving, or None when nothing promoted)."""

    def __init__(self, message, tenant=None, generation=None, attempts=0,
                 last_good=None):
        super().__init__(message)
        self.tenant = tenant
        self.generation = generation
        self.attempts = int(attempts)
        self.last_good = last_good


class ContinuousTrainer:
    """The train → bundle → canary → promote daemon (module docstring).

    Parameters
    ----------
    estimator : streaming estimator with the ``partial_fit(batch,
        checkpoint=, health=)`` contract riding ``ChunkedFitLoop.run_one``
        (``MiniBatchKMeans``; its ``fit_info_`` feeds :meth:`stats`).
    stream : iterable of host batches (ndarray rows), possibly infinite.
    checkpoint : FitCheckpoint — the stream's rotating snapshot (rollback
        target, preemption resume point, and the adoption-gated state
        embedded in every exported bundle).
    pipeline_of : callable(estimator, generation) -> pipeline — the
        servable chain of one generation's export.
    bundle_dir : str — one ``gen_NNNNNN.dsb.npz`` artifact per generation
        plus the ``ledger.jsonl`` promotion ledger.
    router, tenant : the serving side.  None disables canary/promote
        (``verdict="exported"``).  The FIRST generation registers the
        tenant (gated before any traffic); later ones canary against the
        serving primary.
    buckets : bucket ladder of the exported bundles.
    batches_per_generation / canary_fraction / promote_budget : the
        ``DSLIB_TRAINER_*`` knobs.
    retry : Retry — the export-seam policy; default
        ``Retry.from_env(attempts=DSLIB_TRAINER_EXPORT_ATTEMPTS,
        backoff=0.1)`` with ``SnapshotCorrupt`` classified transient.
    health : HealthPolicy | None — passed to the estimator's stream.
    health_gate : callable(LoadedBundle, generation) -> bool — the
        promotion gate.  None gates on the probe (all outputs finite).  A
        gate that RAISES counts as unhealthy (recorded in the ledger
        entry), except control-flow exceptions, which propagate.
    probe : ndarray (rows, n_features) | None — rows for the default
        gate; None with no ``health_gate`` accepts every verified bundle.
    quota_rows / deadline_ms : the tenant registration's quota and each
        generation's ``PredictServer`` deadline.
    quarantine : tri-state passed to the batch screen.
    membership : a multi-host fleet's membership — ROADMAP.md A.11;
        anything but None raises ``NotImplementedError``.
    """

    def __init__(self, estimator, stream, checkpoint, pipeline_of,
                 bundle_dir, router=None, tenant=None, buckets=None,
                 batches_per_generation=None, canary_fraction=None,
                 promote_budget=None, retry=None, health=None,
                 health_gate=None, probe=None, quota_rows=None,
                 deadline_ms=None, quarantine=None, name="trainer",
                 membership=None):
        if membership is not None:
            raise NotImplementedError(
                "ContinuousTrainer(membership=...): a trainer that is one "
                "rank of a multi-host fleet (its lease, its peers' deaths "
                "and rejoins) is ROADMAP.md A.11; the port trains on one "
                "card")
        self.estimator = estimator
        self._stream = iter(stream)
        self.checkpoint = checkpoint
        self.pipeline_of = pipeline_of
        self.bundle_dir = str(bundle_dir)
        os.makedirs(self.bundle_dir, exist_ok=True)
        self.router = router
        self.tenant = tenant
        self.buckets = buckets
        self.batches_per_generation = \
            _env_int("DSLIB_TRAINER_BATCHES", 8) \
            if batches_per_generation is None else int(batches_per_generation)
        self.canary_fraction = \
            _env_float("DSLIB_TRAINER_CANARY_FRACTION", 0.5) \
            if canary_fraction is None else float(canary_fraction)
        self.promote_budget = _env_int("DSLIB_TRAINER_PROMOTE_BUDGET", 3) \
            if promote_budget is None else int(promote_budget)
        self.retry = retry if retry is not None else Retry.from_env(
            attempts=_env_int("DSLIB_TRAINER_EXPORT_ATTEMPTS", 4),
            backoff=0.1, classify=self._classify_export)
        self.health = health
        self.health_gate = health_gate
        self.probe = None if probe is None else np.asarray(probe, np.float32)
        self.quota_rows = quota_rows
        self.deadline_ms = deadline_ms
        self.quarantine = quarantine
        self.name = name

        self.generation = 0             # last trained generation
        self.served_generation = None   # what the tenant's primary serves
        self.ledger: list[dict] = []    # promotion ledger, oldest first
        self._last_good = None          # (generation, bundle path)
        self._primary_server = None     # the server this trainer installed
        self._consecutive_rejections = 0
        self._exhausted = False
        self._counters = {
            "promotions": 0,            # generations made primary
            "canary_rejections": 0,     # health gate said no
            "promote_failures": 0,      # budget exhaustions (typed raise)
            "rollbacks": 0,             # automatic stay-on-last-good
            "rollbacks_of_served": 0,   # explicit rollback() calls
            "exports": 0,
            "export_retries": 0,
            "batches": 0,
            "batches_skipped": 0,       # quarantined to nothing
            "preemptions": 0,
        }

    # -- export-seam classification ---------------------------------------

    @staticmethod
    def _classify_export(exc):
        """At the export seam a torn or bit-corrupt artifact
        (``SnapshotCorrupt`` from the read-back) is TRANSIENT: rewriting
        the artifact fixes it.  Everything else falls through to the
        default classification."""
        if isinstance(exc, SnapshotCorrupt):
            return True
        return None

    # -- stream side -------------------------------------------------------

    def train_generation(self) -> bool:
        """Consume one generation's cadence of batches, each screened
        through the ingest quarantine, then fed to ``partial_fit``.
        Returns False when the stream is exhausted before yielding a
        single batch; a partial cadence at stream end still forms a final
        generation.  A mid-stream ``Preempted`` is counted and
        propagates."""
        from dislib_tpu_torch.data import io as _dio
        g = self.generation + 1
        pulled = 0
        while pulled < self.batches_per_generation:
            try:
                batch = next(self._stream)
            except StopIteration:
                self._exhausted = True
                break
            pulled += 1
            src = f"{self.name}/gen{g}/batch{self._counters['batches'] + 1}"
            try:
                clean, _ = _dio.quarantine_batch(batch, source=src,
                                                 quarantine=self.quarantine)
            except ValueError:
                # every row quarantined: skip and count (the quarantine
                # ledger holds the audit)
                self._counters["batches_skipped"] += 1
                continue
            try:
                self.estimator.partial_fit(clean, checkpoint=self.checkpoint,
                                           health=self.health)
            except Preempted:
                self._counters["preemptions"] += 1
                count_resilience("trainer_preemptions")
                raise
            self._counters["batches"] += 1
        if pulled:
            self.generation = g
        return pulled > 0

    # -- export seam -------------------------------------------------------

    def _bundle_path(self, g: int) -> str:
        return os.path.join(self.bundle_dir, f"gen_{g:06d}.dsb.npz")

    def export_generation(self):
        """Export generation ``self.generation`` through the retry policy:
        the checkpoint flushes (the embedded state reads through the
        adoption gate), the artifact writes atomically, and it is read
        BACK through ``load_bundle`` before anyone serves it.  Returns
        ``(path, LoadedBundle)``."""
        from dislib_tpu_torch.serving import bundle as _bundle
        g = self.generation
        if self.checkpoint is not None:
            self.checkpoint.flush()
        pipe = self.pipeline_of(self.estimator, g)
        path = self._bundle_path(g)
        attempts = [0]

        def _attempt():
            attempts[0] += 1
            # through the module attribute: the export seam's injectors
            # (utils.faults.TornBundleWrite) patch serving.bundle
            _bundle.export_bundle(pipe, path, buckets=self.buckets,
                                  checkpoint=self.checkpoint)
            # the read-back IS the verification: CRC over every entry,
            # every bucket captured — what serving will use
            return _bundle.load_bundle(path)

        loaded = self.retry.call(_attempt)
        self._counters["exports"] += 1
        if attempts[0] > 1:
            self._counters["export_retries"] += attempts[0] - 1
            count_resilience("trainer_export_retries", attempts[0] - 1)
        return path, loaded

    # -- promotion seam ----------------------------------------------------

    def _gate(self, loaded, g, record):
        """Health-gate one loaded bundle: the user gate wins; the probe
        gate requires every probe prediction finite; no gate and no probe
        accepts (the bundle already CRC-verified)."""
        if self.health_gate is not None:
            try:
                return bool(self.health_gate(loaded, g))
            except (Preempted, KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:  # noqa: BLE001 — a raising gate is a veto
                record["gate_error"] = f"{type(e).__name__}: {e}"
                return False
        if self.probe is None:
            return True
        rows = self.probe
        fit = [b for b in loaded.buckets if b >= rows.shape[0]]
        bucket = min(fit) if fit else max(loaded.buckets)
        rows = rows[: bucket]
        vals = loaded.pipeline.predict_bucket(rows, bucket)
        return bool(np.all(np.isfinite(vals)))

    def _make_server(self, loaded, g):
        from dislib_tpu_torch.serving.server import PredictServer
        srv = PredictServer(pipeline=loaded.pipeline, buckets=loaded.buckets,
                            deadline_ms=self.deadline_ms,
                            name=f"{self.name}-g{g}")
        srv.start()
        return srv

    def _commit_record(self, record):
        record["served"] = self.served_generation
        record["counters"] = dict(self._counters)
        self.ledger.append(record)
        try:
            with open(os.path.join(self.bundle_dir, "ledger.jsonl"),
                      "a") as f:
                f.write(json.dumps(record) + "\n")
        except OSError:
            pass                        # the in-memory ledger is canonical

    def publish_generation(self) -> dict:
        """Export → canary → health gate → promote (or automatic rollback
        to last-good) for the current generation; returns the ledger
        record.  The served generation moves FORWARD only here and
        BACKWARD only in :meth:`rollback`."""
        t0 = time.perf_counter()
        path, loaded = self.export_generation()
        export_s = time.perf_counter() - t0
        g = self.generation
        record = {"generation": g, "path": path,
                  "checksum": file_crc(path), "verdict": None,
                  "export_s": round(export_s, 4)}
        if self.router is None or self.tenant is None:
            record["verdict"] = "exported"
            self._last_good = (g, path)
            self._commit_record(record)
            return record
        if self.served_generation is not None \
                and g <= self.served_generation:
            raise RuntimeError(
                f"{self.name}: refusing to publish generation {g} over "
                f"served generation {self.served_generation} — the served "
                "generation moves backward only via rollback()")
        t0 = time.perf_counter()
        srv = self._make_server(loaded, g)
        fresh = self.tenant not in self.router.tenants()
        if not fresh:
            self.router.set_canary(self.tenant, srv,
                                   fraction=self.canary_fraction)
        if self._gate(loaded, g, record):
            if fresh:
                # initial deploy: gated BEFORE any traffic is routed
                self.router.add_tenant(self.tenant, srv,
                                       quota_rows=self.quota_rows)
            else:
                self.router.promote(self.tenant)
            old, self._primary_server = self._primary_server, srv
            self.served_generation = g
            self._last_good = (g, path)
            self._counters["promotions"] += 1
            self._consecutive_rejections = 0
            record["verdict"] = "promoted"
            record["promote_s"] = round(time.perf_counter() - t0, 4)
            count_resilience("trainer_promotions")
            self._commit_record(record)
            if old is not None:
                old.stop()              # drained; new primary has traffic
            return record
        # unhealthy canary: route 100% back to last-good, retire the
        # canary server, spend promote budget
        if not fresh:
            self.router.abort_canary(self.tenant, failed=True)
        srv.stop()
        self._counters["canary_rejections"] += 1
        self._counters["rollbacks"] += 1
        self._consecutive_rejections += 1
        record["verdict"] = "rejected"
        record["promote_s"] = round(time.perf_counter() - t0, 4)
        count_resilience("trainer_canary_rejections")
        if self._consecutive_rejections >= self.promote_budget:
            self._counters["promote_failures"] += 1
            record["verdict"] = "rejected+budget"
            self._commit_record(record)
            last = self._last_good[0] if self._last_good else None
            raise PromotionFailed(
                f"{self.name}: canary health gate refused "
                f"{self._consecutive_rejections} consecutive generations "
                f"(budget {self.promote_budget}); generation "
                f"{last!r} is still serving — operator attention required",
                tenant=self.tenant, generation=g,
                attempts=self._consecutive_rejections, last_good=last)
        self._commit_record(record)
        return record

    def rollback(self, to_generation=None) -> dict:
        """EXPLICITLY move the served generation backward: reload an
        earlier *promoted* generation's bundle (default: the newest one
        below the served generation) through ``load_bundle``, and
        re-point the tenant's primary at it via
        :meth:`ModelRouter.rollback`.  Recorded in the ledger
        (``verdict="rollback"``) and counted (``rollbacks_of_served``)."""
        if self.router is None or self.tenant is None:
            raise RuntimeError(f"{self.name}: no router/tenant to roll back")
        if self.served_generation is None:
            raise RuntimeError(f"{self.name}: nothing promoted yet")
        promoted = [r for r in self.ledger if r["verdict"] == "promoted"
                    and r["generation"] < self.served_generation]
        if to_generation is not None:
            promoted = [r for r in promoted
                        if r["generation"] == int(to_generation)]
        if not promoted:
            raise RuntimeError(
                f"{self.name}: no promoted generation below "
                f"{self.served_generation}"
                + (f" matching {to_generation}" if to_generation is not None
                   else "") + " to roll back to")
        target = promoted[-1]
        from dislib_tpu_torch.serving import bundle as _bundle
        loaded = _bundle.load_bundle(target["path"])
        g = target["generation"]
        srv = self._make_server(loaded, g)
        self.router.rollback(self.tenant, srv)
        old, self._primary_server = self._primary_server, srv
        self.served_generation = g
        self._last_good = (g, target["path"])
        self._consecutive_rejections = 0
        self._counters["rollbacks_of_served"] += 1
        count_resilience("trainer_rollbacks_of_served")
        record = {"generation": g, "path": target["path"],
                  "checksum": target["checksum"], "verdict": "rollback"}
        self._commit_record(record)
        if old is not None:
            old.stop()
        return record

    # -- daemon loop -------------------------------------------------------

    def step(self) -> dict | None:
        """One full cadence: train a generation, publish it.  None when
        the stream is exhausted."""
        if not self.train_generation():
            return None
        return self.publish_generation()

    def run(self, generations=None) -> dict:
        """Drive :meth:`step` until the stream exhausts or ``generations``
        cadences complete (None = forever).  ``Preempted`` and
        :class:`PromotionFailed` propagate typed.  Returns :meth:`stats`."""
        done = 0
        while generations is None or done < generations:
            if self.step() is None:
                break
            done += 1
        return self.stats()

    def close(self) -> None:
        """Stop the primary server this trainer installed (canary servers
        are retired as they lose)."""
        srv, self._primary_server = self._primary_server, None
        if srv is not None:
            srv.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        """The trainer's seam counters, the fit loop's ``fit_info_``
        and the process quarantine ledger's totals; the ``fleet`` block
        (deaths and rejoins of a multi-host fleet, A.11) is zeros."""
        from dislib_tpu_torch.data.io import quarantine_ledger
        led = quarantine_ledger()
        info = getattr(self.estimator, "fit_info_", None) or {}
        out = dict(self._counters)
        out.update({
            "generation": self.generation,
            "served_generation": self.served_generation,
            "last_good": self._last_good[0] if self._last_good else None,
            "stream_exhausted": self._exhausted,
            "ledger_entries": len(self.ledger),
            "quarantine": {"n_quarantined": led.n_quarantined,
                           "n_loaded": led.n_loaded,
                           "reports_retained": len(led.reports)},
            "stream": {"chunks": info.get("chunks", 0),
                       "rollbacks": info.get("rollbacks", 0),
                       "mesh_shrinks": info.get("mesh_shrinks", 0),
                       "mesh_grows": info.get("mesh_grows", 0)},
            "fleet": {"rank_deaths": 0, "rank_rejoins": 0},
        })
        return out
