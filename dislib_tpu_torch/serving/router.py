"""ModelRouter — one serving process, N tenants.

Counterpart of ``dislib_tpu/serving/router.py`` (host code, kept as a
copy of its own); it needs nothing but the server.  The router is the
thin front that lets several tenants share servers safely:

- **tenant → server mapping**: each tenant names a
  :class:`~dislib_tpu_torch.serving.server.PredictServer` (several
  tenants may point at the SAME server and share its warmed programs; a
  tenant with its own model points at its own server).
- **admission control**: a per-tenant in-flight row quota.  A tenant
  outrunning its quota gets a typed :class:`TenantQuotaExceeded` on ITS
  submissions only — the noisy neighbour is shed, everyone else's
  futures are untouched (the server's own :class:`QueueFull`
  backpressure stays underneath as the global limit), and an optional
  latency budget sheds a request the server's learned cost model
  predicts would miss it (:class:`DeadlineShed`).
- **canary / A-B routing**: :meth:`set_canary` splits a tenant's traffic
  between its primary server (N) and a canary server (N+1) by REQUEST
  HASH — the same request key always lands on the same arm.
  :meth:`promote` makes the canary primary only while the canary's model
  is live through the ``runtime.adoption`` gate; :meth:`abort_canary`
  routes 100% back to N; :meth:`rollback` re-points the primary.

Observability rides the server's own per-tenant accounting
(``PredictServer.stats()["tenants"]``): the router labels every
submission with its tenant (canary arms as ``tenant:canary``).
"""

from __future__ import annotations

import os
import threading
import zlib

import numpy as np

from dislib_tpu_torch.serving.server import PredictServer

_HASH_BUCKETS = 10_000      # canary fraction resolution: 0.01%


def _default_router_deadline_s() -> float | None:
    raw = os.environ.get("DSLIB_DEADLINE_MS")
    return None if raw is None else float(raw) / 1e3


class TenantQuotaExceeded(RuntimeError):
    """Admission control, typed: THIS tenant's in-flight rows would
    exceed its quota, so this submission is shed — other tenants'
    requests are untouched (noisy-neighbour isolation).  Carries the
    offending ``tenant`` and its ``quota_rows``."""

    def __init__(self, message, tenant=None, quota_rows=None):
        super().__init__(message)
        self.tenant = tenant
        self.quota_rows = quota_rows


class DeadlineShed(RuntimeError):
    """Latency-budget admission control, typed: the routed
    server's learned cost model (:meth:`PredictServer.predict_latency`)
    predicts this request would miss the router's latency budget
    (``deadline_ms`` / ``DSLIB_DEADLINE_MS``), so it is shed AT
    ADMISSION — before it queues, where it would also push every request
    behind it past its own deadline.  Subclasses ``RuntimeError`` like
    the other shed types; carries the ``tenant``, the ``predicted_ms``,
    and the ``deadline_ms`` that refused it."""

    def __init__(self, message, tenant=None, predicted_ms=None,
                 deadline_ms=None):
        super().__init__(message)
        self.tenant = tenant
        self.predicted_ms = predicted_ms
        self.deadline_ms = deadline_ms


class _Tenant:
    __slots__ = ("name", "server", "quota_rows", "inflight_rows",
                 "canary", "canary_fraction", "quota_shed", "promotions",
                 "promote_failures", "rollbacks", "deadline_shed")

    def __init__(self, name, server, quota_rows):
        self.name = name
        self.server = server
        self.quota_rows = quota_rows
        self.inflight_rows = 0
        self.canary: PredictServer | None = None
        self.canary_fraction = 0.0
        self.quota_shed = 0
        self.promotions = 0
        self.promote_failures = 0
        self.rollbacks = 0
        self.deadline_shed = 0


def _request_hash(rows: np.ndarray, key) -> int:
    """Deterministic per-request hash for the canary split: the caller's
    routing ``key`` when given (a user/session id — keeps one client on
    one arm), else the request bytes themselves."""
    if key is not None:
        data = key if isinstance(key, bytes) else str(key).encode()
    else:
        data = np.ascontiguousarray(rows).tobytes()
    return zlib.crc32(data) % _HASH_BUCKETS


class _Retired(Exception):
    """A routed server stopped before the request reached its queue."""


class ModelRouter:
    """Multi-tenant front over shared :class:`PredictServer` instances.

    Use as a context manager: ``with ModelRouter() as r`` starts every
    distinct server exactly once on entry and drains/stops them on exit
    (servers already running are left to their owner).  All routing
    state is lock-protected; the heavy lifting stays in the servers.
    """

    def __init__(self, name="router", deadline_ms=None):
        self.name = name
        self._tenants: dict[str, _Tenant] = {}
        self._lock = threading.Lock()
        self._started: list[PredictServer] = []
        # latency budget: predicted-miss admission control.
        # None (and DSLIB_DEADLINE_MS unset) = no budget, never sheds.
        self.deadline_s = _default_router_deadline_s() \
            if deadline_ms is None else float(deadline_ms) / 1e3

    # -- tenancy -------------------------------------------------------------

    def add_tenant(self, tenant: str, server: PredictServer,
                   quota_rows: int | None = None) -> None:
        """Register ``tenant`` on ``server``.  Any number of tenants may
        share one server — that is the sharing fast path (one warmed
        ladder serves them all).  ``quota_rows`` caps the
        tenant's in-flight rows (admission control); None = no per-tenant
        cap (the server's global backpressure still applies)."""
        if not isinstance(server, PredictServer):
            raise TypeError(f"tenant {tenant!r}: server must be a "
                            f"PredictServer, got {type(server).__name__}")
        with self._lock:
            if tenant in self._tenants:
                raise ValueError(f"tenant {tenant!r} already registered")
            self._tenants[tenant] = _Tenant(
                tenant, server,
                None if quota_rows is None else int(quota_rows))

    def tenants(self):
        with self._lock:
            return sorted(self._tenants)

    def _get(self, tenant) -> _Tenant:
        t = self._tenants.get(tenant)
        if t is None:
            raise KeyError(f"unknown tenant {tenant!r} — add_tenant first")
        return t

    # -- canary / A-B --------------------------------------------------------

    def set_canary(self, tenant: str, server: PredictServer,
                   fraction: float = 0.1) -> None:
        """Route ``fraction`` of ``tenant``'s requests (by request hash)
        to ``server`` — generation N+1 next to the primary's N.  The
        split is deterministic per request key: A/B comparisons are
        reproducible and one client sticks to one arm."""
        if not 0.0 < fraction <= 1.0:
            raise ValueError(f"canary fraction must be in (0, 1], got "
                             f"{fraction}")
        with self._lock:
            self._get(tenant)           # typed before any side effect
            active = bool(self._started)
        # a canary attached mid-flight starts under the router's
        # lifecycle like any other registered server — and BEFORE it is
        # published as a route target: a concurrent submit must never
        # meet a not-yet-running canary (start() is outside the lock; it
        # warms the whole bucket ladder)
        if active and not server._running:
            server.start()
            self._started.append(server)
        with self._lock:
            t = self._get(tenant)
            t.canary = server
            t.canary_fraction = float(fraction)

    def abort_canary(self, tenant: str, *, failed: bool = False) -> None:
        """Route 100% of ``tenant`` back to its primary (the canary
        server keeps running — its owner decides its fate).
        ``failed=True`` records the abort as a promotion failure (the
        health gate refused the candidate) in the tenant's counters."""
        with self._lock:
            t = self._get(tenant)
            t.canary = None
            t.canary_fraction = 0.0
            if failed:
                t.promote_failures += 1

    def promote(self, tenant: str) -> None:
        """Make ``tenant``'s canary its primary — but only while the
        canary's model is LIVE through the adoption gate: a pool-backed
        canary must have actually adopted a generation (checksum +
        health-gated warmup), otherwise the promotion is refused with a
        ``RuntimeError`` and traffic stays on the old primary.  The
        demoted primary server keeps running (it may serve other
        tenants); in-flight futures on either arm resolve normally —
        promotion only changes where NEW requests route."""
        with self._lock:
            t = self._get(tenant)
            if t.canary is None:
                t.promote_failures += 1
                raise RuntimeError(f"tenant {tenant!r} has no canary to "
                                   "promote")
            pool = t.canary._pool
            if pool is not None and pool.current()[1] is None:
                t.promote_failures += 1
                raise RuntimeError(
                    f"tenant {tenant!r}: canary has not adopted a live "
                    "generation through the adoption gate (last "
                    f"rejection: {pool.last_rejection!r}) — refusing to "
                    "promote an unvalidated model")
            t.server = t.canary
            t.canary = None
            t.canary_fraction = 0.0
            t.promotions += 1

    def rollback(self, tenant: str, server: PredictServer) -> None:
        """EXPLICITLY re-point ``tenant``'s primary at ``server`` — the
        one sanctioned way the served generation moves backward (an
        earlier generation's server kept by its owner).
        Any pending canary is cleared (a rollback supersedes an A/B in
        flight); the demoted primary keeps running — its owner decides
        its fate.  Counted per tenant (``rollbacks`` in :meth:`stats`)."""
        if not isinstance(server, PredictServer):
            raise TypeError(f"tenant {tenant!r}: rollback target must be "
                            f"a PredictServer, got {type(server).__name__}")
        with self._lock:
            self._get(tenant)           # typed before any side effect
            active = bool(self._started)
        # same lifecycle rule as set_canary: never publish a
        # not-yet-running server as a route target
        if active and not server._running:
            server.start()
            self._started.append(server)
        with self._lock:
            t = self._get(tenant)
            t.server = server
            t.canary = None
            t.canary_fraction = 0.0
            t.rollbacks += 1

    def route(self, tenant: str, rows, key=None):
        """(server, label) this request would take — the canary split
        made inspectable (tests and dry-runs)."""
        rows = np.asarray(rows, np.float32)
        with self._lock:
            t = self._get(tenant)
            if t.canary is not None and \
                    _request_hash(rows, key) < \
                    t.canary_fraction * _HASH_BUCKETS:
                return t.canary, f"{tenant}:canary"
            return t.server, tenant

    # -- request side --------------------------------------------------------

    def submit(self, rows, tenant: str, key=None):
        """Admit, route, and queue one request for ``tenant``; returns
        the server's Future.  Sheds with :class:`TenantQuotaExceeded`
        when the tenant's in-flight rows would exceed its quota — only
        the offender's submission fails; the server's own
        :class:`~dislib_tpu.serving.server.QueueFull` backpressure can
        still fire underneath as the global limit.  With a latency
        budget set (``deadline_ms`` / ``DSLIB_DEADLINE_MS``), sheds with
        :class:`DeadlineShed` when the routed server's learned cost
        model predicts a budget miss; with no model yet (cold server)
        the request is ADMITTED — the budget never sheds on
        ignorance."""
        rows = np.asarray(rows, np.float32)
        if rows.ndim == 1:
            rows = rows.reshape(1, -1)
        try:
            return self._submit(rows, tenant, key)
        except _Retired:
            # the routed server was retired (a promote, an aborted canary
            # or a rollback stopped it) between the route and the queue:
            # the route has moved on, so route again, once
            return self._submit(rows, tenant, key, retry=False)

    def _submit(self, rows, tenant, key, retry=True):
        k = rows.shape[0]
        with self._lock:
            t = self._get(tenant)
            if t.quota_rows is not None and \
                    t.inflight_rows + k > t.quota_rows:
                t.quota_shed += 1
                raise TenantQuotaExceeded(
                    f"{self.name}: tenant {tenant!r} has "
                    f"{t.inflight_rows} rows in flight; {k} more would "
                    f"exceed its quota ({t.quota_rows}) — request shed, "
                    "other tenants unaffected",
                    tenant=tenant, quota_rows=t.quota_rows)
            if t.canary is not None and \
                    _request_hash(rows, key) < \
                    t.canary_fraction * _HASH_BUCKETS:
                server, label = t.canary, f"{tenant}:canary"
            else:
                server, label = t.server, tenant
            t.inflight_rows += k
        # the latency-budget check runs OUTSIDE the router lock:
        # predict_latency takes the server's own condition lock, and the
        # router must never hold both at once (lock-order discipline).
        # The inflight reservation above keeps the quota sound meanwhile.
        if self.deadline_s is not None:
            predicted = server.predict_latency(k)
            if predicted is not None and predicted > self.deadline_s:
                with self._lock:
                    t.inflight_rows -= k
                    t.deadline_shed += 1
                raise DeadlineShed(
                    f"{self.name}: tenant {tenant!r} request predicted at "
                    f"{1e3 * predicted:.2f} ms against a "
                    f"{1e3 * self.deadline_s:.2f} ms budget — shed at "
                    "admission (queueing it would also push every request "
                    "behind it past its deadline)",
                    tenant=tenant, predicted_ms=1e3 * predicted,
                    deadline_ms=1e3 * self.deadline_s)
        try:
            fut = server.submit(rows, tenant=label)
        except BaseException as exc:
            with self._lock:
                t.inflight_rows -= k
                moved = server is not t.server and server is not t.canary
            if retry and moved and not server._running:
                raise _Retired() from exc
            raise
        def _release(_f, _t=t, _k=k):
            with self._lock:
                _t.inflight_rows -= _k
        fut.add_done_callback(_release)
        return fut

    def predict(self, rows, tenant: str, key=None) -> np.ndarray:
        return self.submit(rows, tenant, key=key).result().values

    # -- lifecycle -----------------------------------------------------------

    def _servers(self):
        seen, out = set(), []
        for t in self._tenants.values():
            for s in (t.server, t.canary):
                if s is not None and id(s) not in seen:
                    seen.add(id(s))
                    out.append(s)
        return out

    def start(self) -> "ModelRouter":
        """Start every distinct registered server exactly once (shared
        servers start once no matter how many tenants point at them);
        servers already running stay their owner's responsibility."""
        with self._lock:
            servers = self._servers()
        for s in servers:
            if not s._running:
                s.start()
                self._started.append(s)
        return self

    def stop(self) -> None:
        """Drain and stop only the servers :meth:`start` started."""
        started, self._started = self._started, []
        for s in started:
            s.stop()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- observability -------------------------------------------------------

    def stats(self) -> dict:
        """Per-tenant routing + serving view: quota shed counts and
        in-flight rows from the router, latency percentiles and
        backpressure shed from the underlying server's OWN per-tenant
        accounting (primary and canary arms reported separately)."""
        with self._lock:
            tenants = {name: (t.server, t.canary, t.canary_fraction,
                              t.inflight_rows, t.quota_rows, t.quota_shed,
                              t.promotions, t.promote_failures, t.rollbacks,
                              t.deadline_shed)
                       for name, t in self._tenants.items()}
        out = {}
        for name, (server, canary, frac, inflight, quota, shed,
                   promotions, promote_failures, rollbacks,
                   deadline_shed) in tenants.items():
            sstats = server.stats()
            entry = {"server": server.name,
                     "inflight_rows": inflight,
                     "quota_rows": quota,
                     "quota_shed": shed,
                     "deadline_shed": deadline_shed,
                     "promotions": promotions,
                     "promote_failures": promote_failures,
                     "rollbacks": rollbacks,
                     "serving": sstats["tenants"].get(
                         name, {"requests": 0, "shed": 0})}
            if canary is not None:
                entry["canary"] = {
                    "server": canary.name,
                    "fraction": frac,
                    "serving": canary.stats()["tenants"].get(
                        f"{name}:canary", {"requests": 0, "shed": 0})}
            out[name] = entry
        return out
