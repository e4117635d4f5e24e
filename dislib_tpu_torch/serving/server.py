"""PredictServer — request micro-batching with a latency deadline.

Counterpart of ``dislib_tpu/serving/server.py`` (host code, kept as a
copy of its own), its one-card part.  Requests arrive one at a time (a
row, or a small row block) but the card wants batches: one CUDA-graph
replay over 512 rows costs little more than over 1.  The server queues
submissions and flushes a batch when EITHER

- the queued rows fill the largest bucket (throughput bound), OR
- the OLDEST queued request has waited ``deadline_ms``
  (``DSLIB_SERVE_DEADLINE_MS``, default 5) — the latency bound.

A flush coalesces whole requests into the smallest covering bucket (a
request's rows never split across batches; an oversize request is
chunked at largest-bucket granularity) and runs one replay a piece.
Between batches the server polls its :class:`ModelPool` (when serving
one), so generation hot-swaps happen at batch boundaries — a response is
always computed entirely by one generation.

Not ported: the fleet's capacity re-layout and dead-shard drain
(``elastic=``, ``membership=``; reference ``server.py:300-443``), which
raise ``NotImplementedError`` naming ROADMAP.md A.11.
:class:`ShardDrained` is exported for API parity and never raised on one
card.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np

from dislib_tpu_torch.serving.buckets import (bucket_for, bucket_ladder,
                                              split_rows)
from dislib_tpu_torch.serving.cache import ProgramCache
from dislib_tpu_torch.utils import profiling as _prof

_LATENCY_WINDOW = 8192      # completions kept for the p50/p95/p99 estimate


def _default_deadline_s() -> float:
    return float(os.environ.get("DSLIB_SERVE_DEADLINE_MS", "5")) / 1e3


class QueueFull(RuntimeError):
    """Backpressure, typed: the server's queue already holds
    ``max_queue_rows`` rows — the request rate is outrunning the device
    and THIS submission was shed (the queue never grows until the
    process OOMs).  Subclasses ``RuntimeError``; carries the ``tenant``
    whose request was shed so a router's admission layer can attribute
    the rejection."""

    def __init__(self, message, tenant=None):
        super().__init__(message)
        self.tenant = tenant


class ShardDrained(RuntimeError):
    """(Raised by a multi-rank fleet; never on one card, ROADMAP.md
    A.11.)  This server is part of a sharded fleet and a peer host's lease
    EXPIRED: until the fleet heals, responses assembled here would
    silently miss the dead host's shard of the model — torn
    results.  The server DRAINS instead: queued and new requests fail
    with this typed error (carrying the dead ``rank`` and ``last_seen``)
    so the caller's load balancer re-routes, and serving resumes
    automatically when the peer's lease is renewed or a restart rejoins."""

    def __init__(self, message, rank=None, last_seen=None):
        super().__init__(message)
        self.rank = rank
        self.last_seen = last_seen


class ServeResponse:
    """One request's result: ``values`` (n_rows, out_cols ndarray), the
    ``generation`` token that computed it (None for a static pipeline),
    and the request's ``latency_s`` (submit → response)."""

    __slots__ = ("values", "generation", "latency_s")

    def __init__(self, values, generation, latency_s):
        self.values = values
        self.generation = generation
        self.latency_s = latency_s

    def __repr__(self):
        return (f"ServeResponse(shape={self.values.shape}, "
                f"generation={self.generation!r}, "
                f"latency_ms={1e3 * self.latency_s:.3f})")


class _Pending:
    __slots__ = ("rows", "future", "t_submit", "tenant")

    def __init__(self, rows, tenant=None):
        self.rows = rows
        self.future = Future()
        self.t_submit = time.perf_counter()
        self.tenant = tenant


class PredictServer:
    """Micro-batching front of a :class:`ServePipeline` or
    :class:`ModelPool`.

    Use as a context manager (``with PredictServer(...) as srv``) or call
    :meth:`start`/:meth:`stop`.  ``submit`` returns a
    ``concurrent.futures.Future`` resolving to :class:`ServeResponse`;
    ``predict`` is the blocking convenience returning just the values.
    """

    def __init__(self, pipeline=None, pool=None, buckets=None,
                 deadline_ms=None, max_queue_rows=65536, name="serve",
                 elastic=None, membership=None):
        if (pipeline is None) == (pool is None):
            raise ValueError("pass exactly one of pipeline= or pool=")
        if elastic is not None or membership is not None:
            raise NotImplementedError(
                "PredictServer(elastic=..., membership=...): the fleet's "
                "capacity re-layout and dead-shard drain are multi-rank "
                "(ROADMAP.md A.11); the port serves on one card")
        self._pipeline = pipeline
        self._pool = pool
        if pool is not None:
            # the served ladder must be ⊆ the pool's warmed+health-gated
            # ladder: routing a request to a bucket adoption never warmed
            # would pay a capture on the hot path AND run a shape
            # the health gate never validated
            self.buckets = pool.buckets if buckets is None \
                else bucket_ladder(buckets)
            extra = set(self.buckets) - set(pool.buckets)
            if extra:
                raise ValueError(
                    f"server buckets {sorted(extra)} are not in the "
                    f"pool's warmed ladder {pool.buckets} — every served "
                    "bucket must be warmed and health-gated at "
                    "adoption")
        else:
            self.buckets = bucket_ladder(buckets)
        self.deadline_s = _default_deadline_s() if deadline_ms is None \
            else float(deadline_ms) / 1e3
        self.name = name
        self.max_queue_rows = int(max_queue_rows)
        self.cache = pool.cache if pool is not None else ProgramCache()
        self._cv = threading.Condition()
        self._queue: deque[_Pending] = deque()
        self._queued_rows = 0               # backpressure accounting
        self._running = False
        self._thread: threading.Thread | None = None
        # accounting
        self._lat = deque(maxlen=_LATENCY_WINDOW)
        self._batches = 0
        self._requests = 0
        self._rows = 0
        self._dispatch_hist: deque[int] = deque(maxlen=_LATENCY_WINDOW)
        self._t_first = None
        self._t_last = None
        # per-tenant observability: latency windows, request tallies,
        # and shed counts keyed by the submit() tenant label —
        # the router reads THESE numbers rather than timing around the
        # server
        self._shed = 0
        self._tenant_lat: dict[str, deque] = {}
        self._tenant_requests: dict[str, int] = {}
        self._tenant_shed: dict[str, int] = {}
        # per-bucket wall-clock cost model: measured predict_bucket
        # walls keyed by bucket, learned from the server's
        # own serving — the admission layer (ModelRouter deadline shed)
        # reads predict_latency() instead of guessing
        self._bucket_wall: dict[int, deque] = {}

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "PredictServer":
        if self._running:
            return self
        if self._pipeline is not None:
            # static pipeline: warm (capture) every bucket up front so
            # the request path never captures (a ModelPool warms at
            # adoption)
            self.cache.warm(self._pipeline, None, self.buckets)
        else:
            self._pool.poll(force=True)
        self._running = True
        self._thread = threading.Thread(target=self._worker,
                                        name=f"dslib-{self.name}",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Drain the queue (every accepted request gets a response), then
        stop the worker."""
        if not self._running:
            return
        with self._cv:
            self._running = False
            self._cv.notify_all()
        self._thread.join()
        self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- request side --------------------------------------------------------

    def submit(self, rows, tenant=None) -> Future:
        """Queue one request (a (k, n_features) block or a single (n,)
        row); the Future resolves to a :class:`ServeResponse`.  Raises
        :class:`QueueFull` when the queue already holds
        ``max_queue_rows`` rows — backpressure: a client outrunning the
        device must hear about it instead of growing the queue until the
        process OOMs.  ``tenant`` labels the request for the per-tenant
        latency/shed accounting in :meth:`stats` (a
        :class:`~dislib_tpu.serving.router.ModelRouter` sets it)."""
        rows = np.asarray(rows, np.float32)
        if rows.ndim == 1:
            rows = rows.reshape(1, -1)
        if rows.ndim != 2 or rows.shape[0] < 1:
            raise ValueError(f"a request is a (k, n_features) row block, "
                             f"got shape {rows.shape}")
        p = _Pending(rows, tenant)
        with self._cv:
            if not self._running:
                raise RuntimeError("PredictServer is not running — use "
                                   "start() or a with-block")
            if self._queued_rows + rows.shape[0] > self.max_queue_rows:
                self._shed += 1
                if tenant is not None:
                    self._tenant_shed[tenant] = \
                        self._tenant_shed.get(tenant, 0) + 1
                raise QueueFull(
                    f"{self.name}: queue full ({self._queued_rows} rows "
                    f"queued, max_queue_rows={self.max_queue_rows}) — "
                    "the request rate is outrunning the device; back off "
                    "and retry", tenant=tenant)
            self._queued_rows += rows.shape[0]
            self._queue.append(p)
            self._cv.notify_all()
        return p.future

    def predict(self, rows, tenant=None) -> np.ndarray:
        return self.submit(rows, tenant=tenant).result().values

    # -- worker side ---------------------------------------------------------

    def _worker(self):
        top = self.buckets[-1]
        while True:
            with self._cv:
                while self._running and not self._queue:
                    self._cv.wait(timeout=0.1)
                if not self._queue:
                    if not self._running:
                        return
                    continue
                # deadline window: wait for more work until the OLDEST
                # request's deadline, or until the largest bucket fills
                flush_at = self._queue[0].t_submit + self.deadline_s
                while self._running:
                    left = flush_at - time.perf_counter()
                    if self._queued_rows >= top or left <= 0:
                        break
                    self._cv.wait(timeout=left)
                # assemble: whole requests, smallest covering bucket
                batch = [self._queue.popleft()]
                total = batch[0].rows.shape[0]
                while self._queue and \
                        total + self._queue[0].rows.shape[0] <= top:
                    p = self._queue.popleft()
                    total += p.rows.shape[0]
                    batch.append(p)
                self._queued_rows -= total
            self._execute(batch, total)

    def _serving(self):
        """(generation, pipeline) for the next batch — polls the pool so
        hot-swaps land at batch boundaries.  Before the FIRST adoption
        the worker waits briefly instead of failing the batch: another
        poller may hold the pool's adoption lock mid-warm (poll() yields
        to it), or the trainer may be a moment away from its first
        save."""
        if self._pool is None:
            return None, self._pipeline
        deadline = time.perf_counter() + 2.0
        while True:
            self._pool.poll()
            gen, pipe = self._pool.current()
            if pipe is not None:
                return gen, pipe
            # never expire while an adoption is actually in flight on
            # another thread: its warm phase captures the whole bucket
            # ladder (and builds the kernels on a first use), which can
            # outlive any fixed deadline
            if time.perf_counter() >= deadline and not self._pool.adopting:
                raise RuntimeError(
                    f"{self.name}: no model generation has been adopted "
                    "yet (is the checkpoint path empty?)")
            self._pool.poll(force=True)
            time.sleep(0.01)

    def _execute(self, batch, total):
        try:
            gen, pipe = self._serving()
        except Exception as e:  # noqa: BLE001 — no model: fail the batch
            for p in batch:
                if p.future.set_running_or_notify_cancel():
                    p.future.set_exception(e)
            return
        # per-request validation BEFORE the replay: one malformed
        # request must fail ITS future, not poison the whole batch
        good = []
        for p in batch:
            if p.rows.shape[1] != pipe.n_features:
                if p.future.set_running_or_notify_cancel():
                    p.future.set_exception(ValueError(
                        f"request has {p.rows.shape[1]} features, "
                        f"pipeline serves {pipe.n_features}"))
            else:
                good.append(p)
        if not good:
            return
        batch = good
        total = sum(p.rows.shape[0] for p in batch)
        try:
            rows = batch[0].rows if len(batch) == 1 else \
                np.concatenate([p.rows for p in batch], axis=0)
            pieces = []
            walls = []
            d0 = _prof.thread_dispatch_count()
            for size in split_rows(total, self.buckets):
                bucket = bucket_for(size, self.buckets)
                t_piece = time.perf_counter()
                pieces.append(pipe.predict_bucket(rows[:size], bucket))
                walls.append((bucket, time.perf_counter() - t_piece))
                self.cache.record_hit(gen, bucket)
                rows = rows[size:]
            dispatches = _prof.thread_dispatch_count() - d0
            out = pieces[0] if len(pieces) == 1 else \
                np.concatenate(pieces, axis=0)
        except Exception as e:  # noqa: BLE001 — fail the batch, keep serving
            for p in batch:
                if not p.future.set_running_or_notify_cancel():
                    continue
                p.future.set_exception(e)
            return
        t_done = time.perf_counter()
        # accounting mutates under the condition lock so a monitoring
        # thread's stats() snapshot never iterates a deque mid-append
        with self._cv:
            self._batches += 1
            self._dispatch_hist.append(dispatches)
            for bucket, wall in walls:
                self._bucket_wall.setdefault(
                    bucket, deque(maxlen=512)).append(wall)
            if self._t_first is None:
                self._t_first = t_done
            self._t_last = t_done
            lats = []
            for p in batch:
                lat = t_done - p.t_submit
                lats.append(lat)
                self._lat.append(lat)
                self._requests += 1
                self._rows += p.rows.shape[0]
                if p.tenant is not None:
                    self._tenant_lat.setdefault(
                        p.tenant,
                        deque(maxlen=_LATENCY_WINDOW)).append(lat)
                    self._tenant_requests[p.tenant] = \
                        self._tenant_requests.get(p.tenant, 0) + 1
        off = 0
        for p, lat in zip(batch, lats):
            k = p.rows.shape[0]
            if p.future.set_running_or_notify_cancel():
                p.future.set_result(
                    ServeResponse(out[off:off + k].copy(), gen, lat))
            off += k

    # -- cost model ----------------------------------------------------------

    def bucket_cost(self) -> dict:
        """The learned per-bucket cost model: ``{bucket: p95 wall
        seconds}`` over the measured ``predict_bucket`` walls of this
        server's own serving.  A bucket appears once it has ≥ 3 samples
        — before that the model declines to predict (None from
        :meth:`predict_latency`) rather than shed on a guess."""
        with self._cv:
            snap = {b: np.asarray(d, np.float64)
                    for b, d in self._bucket_wall.items()}
        return {b: float(np.percentile(w, 95))
                for b, w in sorted(snap.items()) if w.size >= 3}

    def predict_latency(self, n_rows: int) -> float | None:
        """Predicted submit→response seconds for an ``n_rows`` request
        arriving NOW: the deadline window the batcher may hold it, plus
        the predicted execute walls of the rows already queued ahead of
        it, plus its own bucket pieces — all read from the learned
        :meth:`bucket_cost` model.  Returns None when any needed bucket
        has no model yet (an admission layer must not shed on
        ignorance)."""
        costs = self.bucket_cost()
        with self._cv:
            backlog = self._queued_rows
        predicted = self.deadline_s

        def _pieces_cost(total: int) -> float | None:
            acc = 0.0
            for size in split_rows(int(total), self.buckets):
                c = costs.get(bucket_for(size, self.buckets))
                if c is None:
                    return None
                acc += c
            return acc

        for total in (backlog, int(n_rows)):
            if total:
                c = _pieces_cost(total)
                if c is None:
                    return None
                predicted += c
        return predicted

    # -- accounting ----------------------------------------------------------

    @staticmethod
    def _percentiles(lat: np.ndarray) -> dict:
        """p50/p95/p99 (ms) over one latency window, None when empty."""
        if not lat.size:
            return {"p50_ms": None, "p95_ms": None, "p99_ms": None}
        return {f"p{q}_ms": round(1e3 * float(np.percentile(lat, q)), 4)
                for q in (50, 95, 99)}

    def stats(self) -> dict:
        """Serving counters: request latency percentiles (p50/p95/p99
        ms, overall AND per tenant under ``tenants``), QPS over the
        completion window, rows/batches served, ``shed`` (submissions
        rejected by backpressure — total, and per tenant), and the
        per-batch dispatch distribution (the 1-dispatch-per-batch
        invariant as a number; oversize split requests legitimately cost
        one dispatch per piece).  A benchmark reads its headline
        numbers from here — the server is its own observability source.
        Dispatch deltas read the worker thread's own tally
        (``profiling.thread_dispatch_count``), so other threads' device
        work does not inflate them."""
        with self._cv:                      # consistent snapshot vs the
            lat = np.asarray(self._lat)     # worker's accounting block
            disp = np.asarray(self._dispatch_hist, np.int64)
            t_first, t_last = self._t_first, self._t_last
            requests, rows = self._requests, self._rows
            batches, depth = self._batches, len(self._queue)
            queued_rows = self._queued_rows
            shed = self._shed
            tenant_lat = {t: np.asarray(d, np.float64)
                          for t, d in self._tenant_lat.items()}
            tenant_requests = dict(self._tenant_requests)
            tenant_shed = dict(self._tenant_shed)
        lat = lat.astype(np.float64)
        window = (t_last - t_first) \
            if t_first is not None and t_last > t_first else None
        tenants = {}
        for t in sorted(set(tenant_lat) | set(tenant_shed)):
            tenants[t] = {"requests": tenant_requests.get(t, 0),
                          "shed": tenant_shed.get(t, 0),
                          **self._percentiles(
                              tenant_lat.get(t, np.empty(0)))}
        return {
            "requests": requests,
            "rows": rows,
            "batches": batches,
            **self._percentiles(lat),
            "qps": round(requests / window, 2) if window else None,
            "rows_per_s": round(rows / window, 2) if window else None,
            "dispatches_per_batch_max": int(disp.max()) if disp.size
            else None,
            "dispatches_per_batch_mean": round(float(disp.mean()), 3)
            if disp.size else None,
            "queue_depth": depth,
            "queued_rows": queued_rows,
            "shed": shed,
            "bucket_cost_ms": {b: round(1e3 * c, 4)
                               for b, c in self.bucket_cost().items()},
            "tenants": tenants,
            "swaps": self._pool.adoptions if self._pool is not None
            else None,
            "rejected_swaps": self._pool.rejections
            if self._pool is not None else None,
        }
