"""The port's chunked fit loop against the reference's, on the CPU.

The escalation ladder's schedules and walks are host logic, held equal to
the reference's for every small budget.  KMeans (64–256 rows) runs
through both packages' ``ChunkedFitLoop``: unchecked and checked fits
agree (centers within 1e-5, ``n_iter_`` and ``fit_info_`` equal), a
snapshot the reference wrote resumes in the port, the fault injectors
(``NaNAtChunk`` under 'retry' and 'reseed', ``FaultAtTier``) heal or
raise as in the reference, preemption and the watchdog act at chunk
boundaries, and a stale snapshot is refused.  The reference fits share
module fixtures; the preemption races are given ~100 chunks of margin
(the signal lands from the snapshot worker).
"""

import numpy as np
import pytest

import dislib_tpu as ds
from dislib_tpu.cluster import KMeans as RefKMeans
from dislib_tpu.runtime import fitloop as ref_fl
from dislib_tpu.runtime import health as ref_health
from dislib_tpu.utils import faults as ref_faults
from dislib_tpu.utils import profiling as ref_prof
from dislib_tpu.utils.checkpoint import FitCheckpoint as RefCheckpoint

import dislib_tpu_torch as dst
from dislib_tpu_torch.cluster import KMeans
from dislib_tpu_torch.runtime import fitloop as port_fl
from dislib_tpu_torch.runtime import health as port_health
from dislib_tpu_torch.runtime import preemption as port_pre
from dislib_tpu_torch.utils import faults
from dislib_tpu_torch.utils import profiling as prof
from dislib_tpu_torch.utils.checkpoint import FitCheckpoint

M, N, K = 128, 4, 3


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    dst.init(device="cpu")
    monkeypatch.setenv("DSLIB_RETRY_BACKOFF", "0")
    port_pre.clear_preemption()
    yield
    port_pre.clear_preemption()


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    centers = rng.uniform(-5, 5, (K, N))
    lab = rng.randint(0, K, M)
    return (centers[lab] + rng.standard_normal((M, N))).astype(np.float32)


def _km(cls, **kw):
    kw.setdefault("max_iter", 12)
    kw.setdefault("tol", 0.0)
    return cls(n_clusters=K, random_state=5, **kw)


@pytest.fixture(scope="module")
def ref_fits(data, tmp_path_factory):
    ds.init()           # built before the conftest's per-test mesh reset
    d = tmp_path_factory.mktemp("ref")
    a = ds.array(data)
    out = {"plain": _km(RefKMeans).fit(a),
           "checked": _km(RefKMeans).fit(
               a, checkpoint=RefCheckpoint(str(d / "c.npz"), every=3))}
    # a snapshot "left by a killed fit": the state after 6 of 12 steps
    _km(RefKMeans, max_iter=6).fit(
        a, checkpoint=RefCheckpoint(str(d / "half.npz"), every=3))
    out["half_path"] = str(d / "half.npz")
    return out


def _close(port, ref):
    np.testing.assert_allclose(port.centers_, ref.centers_, rtol=1e-5,
                               atol=1e-5)
    assert port.n_iter_ == ref.n_iter_


# -- the escalation ladder ------------------------------------------------------

@pytest.mark.parametrize("elastic_ok", [False, True])
@pytest.mark.parametrize("elastic", [0, 1, 2])
@pytest.mark.parametrize("restarts", [0, 1, 2, 3, 4])
def test_ladder_schedules_equal_the_references(restarts, elastic,
                                               elastic_ok):
    kw = {"max_restarts": restarts, "elastic_attempts": elastic}
    ref = ref_fl.EscalationLadder(
        ref_health.HealthPolicy(**kw).make_guard("x", object()),
        elastic_ok=elastic_ok)
    port = port_fl.EscalationLadder(
        port_health.HealthPolicy(**kw).make_guard("x", object()),
        elastic_ok=elastic_ok)
    assert port.schedule == ref.schedule


@pytest.mark.parametrize("action", ["retry", "halve", "reseed"])
def test_ladder_walk_and_counters_equal_the_references(action):
    def walk(health, fl, p):
        p.reset_counters()
        lad = fl.EscalationLadder(health.HealthPolicy(
            action=action, max_restarts=3, elastic_attempts=1).make_guard(
                "x", object()), elastic_ok=True)
        steps = []
        v = health.Verdict(False, guard="nonfinite")
        while True:
            try:
                e = lad.escalate(v, it=4)
            except health.NumericalDivergence as err:
                steps.append(("raise", err.guard, err.iteration))
                return steps, p.resilience_counters()
            r = e.remediation
            steps.append((e.tier, e.attempt, e.tier_attempt, r.action,
                          r.damping, r.seed))

    assert walk(port_health, port_fl, prof) == \
        walk(ref_health, ref_fl, ref_prof)


def test_remediation_perturb_is_the_references_draw():
    import torch
    arr = np.random.RandomState(1).rand(5, 3).astype(np.float32)
    ref = ref_health.Remediation(2, "reseed", 7).perturb(arr)
    port = port_health.Remediation(2, "reseed", 7)
    np.testing.assert_array_equal(port.perturb(arr), ref)
    np.testing.assert_array_equal(port.perturb(torch.from_numpy(arr)).numpy(),
                                  ref)
    assert port_health.Remediation(2, "halve", 7).damping == 4.0


@pytest.mark.parametrize("case", range(4))
def test_health_vec_equals_the_references(case):
    import jax.numpy as jnp
    import torch
    rng = np.random.RandomState(case)
    a = rng.standard_normal((5, 3)).astype(np.float32) * 10
    b = rng.standard_normal(7).astype(np.float32)
    ids = np.arange(4, dtype=np.int32)
    x = rng.standard_normal((6, 2)).astype(np.float32)
    hist = np.sort(rng.rand(6).astype(np.float32))[::-1].copy()
    if case >= 1:
        a[2, 1], b[5] = np.nan, np.inf
    if case >= 2:
        x[3, 0], hist[2] = np.nan, np.inf
    if case == 3:
        a[:], hist[:] = np.nan, -1.0
    kw = {"n_done": 4, "increasing": bool(case % 2)}
    ref = ref_health.health_vec(
        carries=tuple(jnp.asarray(v) for v in (a, ids, b)),
        inputs=(jnp.asarray(x),), hist=jnp.asarray(hist), **kw)
    got = port_health.health_vec(
        carries=tuple(torch.from_numpy(v) for v in (a, ids, b)),
        inputs=(torch.from_numpy(x),), hist=torch.from_numpy(hist), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_commit_runs_only_after_a_passing_verdict(tmp_path):
    seen = []
    pol = faults.TripAtChunk(at_chunk=2)
    loop = port_fl.ChunkedFitLoop("x", checkpoint=FitCheckpoint(
        str(tmp_path / "x.npz")), health=pol, max_iter=4, chunk_iters=1)

    def step(st, chunk):
        def commit():
            seen.append(st.it)
            return port_fl.LoopState((), st.it + 1)
        return port_fl.ChunkOutcome(commit, host_values={"a": np.ones(2)})

    st = loop.run(init=lambda rem: port_fl.LoopState(()), step=step,
                  restore=lambda snap, rem: port_fl.LoopState(
                      (), it=int(snap["it"])),
                  snapshot=lambda st: {"it": st.it})
    # the tripped chunk (it 1) never committed; its re-run did
    assert st.it == 4 and seen == [0, 1, 2, 3]
    assert loop.info["rollbacks"] == 1 and loop.info["chunks"] == 4


# -- KMeans through both packages' loops ---------------------------------------

def test_unchecked_and_checked_fits_agree_with_the_reference(data, ref_fits,
                                                             tmp_path):
    x = dst.array(data)
    plain = _km(KMeans).fit(x)
    checked = _km(KMeans).fit(x, checkpoint=FitCheckpoint(
        str(tmp_path / "c.npz"), every=3))
    _close(plain, ref_fits["plain"])
    _close(checked, ref_fits["checked"])
    assert plain.fit_info_ == ref_fits["plain"].fit_info_
    assert checked.fit_info_ == ref_fits["checked"].fit_info_
    np.testing.assert_array_equal(checked.centers_, plain.centers_)
    np.testing.assert_allclose(checked.history_, ref_fits["plain"].history_,
                               rtol=1e-5)


def test_a_reference_snapshot_resumes_in_the_port(data, ref_fits, tmp_path):
    import shutil
    path = str(tmp_path / "half.npz")
    shutil.copy(ref_fits["half_path"], path)
    prof.reset_host_reads()
    got = _km(KMeans).fit(dst.array(data),
                          checkpoint=FitCheckpoint(path, every=3))
    _close(got, ref_fits["plain"])
    assert got.fit_info_["chunks"] == 2         # steps 7-12 only
    # the port's own snapshot loads in the reference
    snap = RefCheckpoint(path).load()
    assert int(snap["n_iter"]) == 12


@pytest.mark.parametrize("action", ["retry", "reseed"])
def test_nan_at_chunk_heals_as_in_the_reference(data, tmp_path, action):
    def run(cls, array, ck, inj):
        return _km(cls).fit(array(data), checkpoint=ck(
            str(tmp_path / f"{cls.__module__[:12]}.npz"), every=3),
            health=inj.NaNAtChunk(at_chunk=3, action=action))

    ref = run(RefKMeans, ds.array, RefCheckpoint, ref_faults)
    port = run(KMeans, dst.array, FitCheckpoint, faults)
    _close(port, ref)
    assert port.fit_info_ == ref.fit_info_
    assert port.fit_info_["rollbacks"] == 1
    plain = _km(KMeans).fit(dst.array(data))
    np.testing.assert_array_equal(port.centers_, plain.centers_)


@pytest.mark.parametrize("tiers,action", [(0, "retry"), (1, "reseed"),
                                          (3, "retry")])
def test_fault_at_tier_walks_the_ladder_as_in_the_reference(data, tmp_path,
                                                            tiers, action):
    def run(cls, array, ck, inj, p):
        p.reset_counters()
        pol = inj.FaultAtTier(tiers=tiers, at_chunk=2, action=action,
                              max_restarts=2)
        try:
            est = _km(cls).fit(array(data), checkpoint=ck(
                str(tmp_path / f"{cls.__module__[:12]}.npz"), every=3),
                health=pol)
        except Exception as e:              # noqa: BLE001 — compared below
            return (type(e).__name__, getattr(e, "guard", None)), \
                p.resilience_counters()
        return est, p.resilience_counters()

    ref, ref_c = run(RefKMeans, ds.array, RefCheckpoint, ref_faults,
                     ref_prof)
    port, port_c = run(KMeans, dst.array, FitCheckpoint, faults, prof)
    assert port_c == ref_c
    if tiers == 3:
        assert port == ref == ("NumericalDivergence", "fault-at-tier")
        return
    assert port.fit_info_ == ref.fit_info_
    # 'reseed' at the remediate tier: the same seeded perturbation
    _close(port, ref)


def test_sigterm_and_watcher_preempt_and_resume_bit_identically(data,
                                                                tmp_path):
    x = dst.array(data)
    plain = _km(KMeans, max_iter=200).fit(x)
    path = str(tmp_path / "p.npz")
    with pytest.raises(port_pre.Preempted) as err:
        with port_pre.PreemptionWatcher():
            _km(KMeans, max_iter=200).fit(x, checkpoint=faults.SigtermAtNthSave(
                path, every=2, after=1))
    assert err.value.checkpoint_path == path
    import signal
    assert port_pre.last_signal() == signal.SIGTERM
    port_pre.clear_preemption()
    done_before = int(FitCheckpoint(path).load()["n_iter"])
    assert 2 <= done_before < 200
    resumed = _km(KMeans, max_iter=200).fit(x, checkpoint=FitCheckpoint(
        path, every=2))
    np.testing.assert_array_equal(resumed.centers_, plain.centers_)
    assert resumed.fit_info_["chunks"] == (200 - done_before) // 2


@pytest.mark.parametrize("tol", [0.0, 1e-9])
def test_hang_at_chunk_trips_the_watchdog_and_heals(data, tmp_path, tol):
    # at tol > 0 the first blocking read of a chunk is run_chunked's stop
    # flag, INSIDE the chunk: it too is under the deadline
    x = dst.array(data)
    plain = _km(KMeans, max_iter=20, tol=tol).fit(x)
    prof.reset_counters()
    got = _km(KMeans, max_iter=20, tol=tol).fit(
        x, checkpoint=FitCheckpoint(str(tmp_path / "h.npz"), every=10),
        health=faults.HangAtChunk(at_chunk=1, hang_s=0.3, deadline_s=0.05))
    assert prof.resilience_counters() == {"watchdog_trips": 1}
    np.testing.assert_array_equal(got.centers_, plain.centers_)
    with pytest.raises(port_health.WatchdogTimeout, match="deadline"):
        _km(KMeans, max_iter=20, tol=tol).fit(
            x, health=faults.HangAtChunk(at_chunk=1, hang_s=0.3, times=9,
                                         deadline_s=0.05))


def test_a_stale_snapshot_is_refused(data, tmp_path):
    path = str(tmp_path / "s.npz")
    _km(KMeans).fit(dst.array(data), checkpoint=FitCheckpoint(path))
    with pytest.raises(ValueError, match="stale or foreign snapshot"):
        KMeans(n_clusters=K + 1, random_state=5).fit(
            dst.array(data), checkpoint=FitCheckpoint(path))
