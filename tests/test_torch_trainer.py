"""The port's ContinuousTrainer against the reference's, on CPU.

One stream of host batches (a poisoned batch among them) goes through
``dislib_tpu.runtime.ContinuousTrainer`` (8 virtual CPU devices) and
``dislib_tpu_torch.runtime.ContinuousTrainer`` on the CPU, each training a
``MiniBatchKMeans`` whose initial centers are carried across, exporting a
deployment bundle per generation, and promoting through its package's
``ModelRouter``.  Generation 2's export meets ``TornBundleWrite(failures=1)``
(patched into each package's ``serving.bundle``) and generation 3's canary
``CanaryGateTrip(times=1)``.  The two must give the same ledger verdicts,
counters and served generation, and centers within the MiniBatchKMeans
parity tolerance (rtol/atol 1e-5, as ``tests/test_torch_minibatch.py``).

The reference's bundle is loaded in the process that wrote it (its
fresh-process load is the one that fails, ROADMAP.md C.4).  The port's
own seams — the promote budget, ``rollback()``, the ledger file and a
counted ``Preempted`` — are held on the port alone.
"""

import json
import os

import numpy as np
import pytest

import dislib_tpu as ds
from dislib_tpu import runtime as ref_rt
from dislib_tpu import serving as ref_sv
from dislib_tpu.cluster import MiniBatchKMeans as RefMBK
from dislib_tpu.utils import faults as ref_faults
from dislib_tpu.utils.checkpoint import FitCheckpoint as RefCheckpoint

import dislib_tpu_torch as dst
from dislib_tpu_torch.cluster import MiniBatchKMeans
from dislib_tpu_torch.data import io as port_io
from dislib_tpu_torch.runtime import (ContinuousTrainer, Preempted,
                                      PromotionFailed, Retry,
                                      clear_preemption, request_preemption)
from dislib_tpu_torch.serving import ModelRouter, ServePipeline
from dislib_tpu_torch.utils import faults
from dislib_tpu_torch.utils import profiling as prof
from dislib_tpu_torch.utils.checkpoint import FitCheckpoint

NF, K, ROWS, BUCKETS, TENANT = 6, 4, 64, (8,), "alpha"
COUNTER_KEYS = ("promotions", "canary_rejections", "promote_failures",
                "rollbacks", "rollbacks_of_served", "exports",
                "export_retries", "batches", "batches_skipped",
                "preemptions")


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    dst.init(device="cpu")
    monkeypatch.setenv("DSLIB_RETRY_BACKOFF", "0")
    clear_preemption()
    yield
    clear_preemption()


def _batches(n, seed=0, poison=(), dead=()):
    """n host batches of blobs; the batches in ``poison`` carry NaN rows,
    those in ``dead`` are NaN throughout."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-6, 6, (K, NF))
    out = []
    for i in range(n):
        lab = rng.randint(0, K, ROWS)
        b = (centers[lab] + rng.standard_normal((ROWS, NF))).astype(
            np.float32)
        if i in poison:
            b[::5, 1] = np.nan
        if i in dead:
            b[:] = np.nan
        out.append(b)
    return out, centers


def _init(stream):
    return stream[0][[0, 16, 32, 48]].copy()


def _port_trainer(root, stream, router, **kw):
    est = MiniBatchKMeans(n_clusters=K, init=_init(stream))
    ck = FitCheckpoint(os.path.join(root, "ck.npz"), every=1, keep=2)
    probe = stream[1][:4]
    return ContinuousTrainer(
        est, iter(stream), ck,
        lambda e, g: ServePipeline(e, n_features=NF),
        os.path.join(root, "bundles"), router=router, tenant=TENANT,
        buckets=BUCKETS, batches_per_generation=2, canary_fraction=0.5,
        retry=Retry(attempts=3, backoff=0.0,
                    classify=ContinuousTrainer._classify_export),
        probe=probe, **kw)


def _ref_trainer(root, stream, router):
    est = RefMBK(n_clusters=K, init=_init(stream))
    ck = RefCheckpoint(os.path.join(root, "ck.npz"), every=1, keep=2)
    probe = stream[1][:4]
    return ref_rt.ContinuousTrainer(
        est, iter(stream), ck,
        lambda e, g: ref_sv.ServePipeline(e, n_features=NF),
        os.path.join(root, "bundles"), router=router, tenant=TENANT,
        buckets=BUCKETS, batches_per_generation=2, canary_fraction=0.5,
        retry=ref_rt.Retry(
            attempts=3, backoff=0.0,
            classify=ref_rt.ContinuousTrainer._classify_export),
        probe=probe)


def _drive(tr, bundle_mod, faults_mod, monkeypatch):
    """Four generations: a torn export in generation 2, a tripped canary
    in generation 3."""
    records, torn = [tr.step()], faults_mod.TornBundleWrite(failures=1)
    monkeypatch.setattr(bundle_mod, "write_bundle", torn)
    records.append(tr.step())
    monkeypatch.undo()
    tr.health_gate = faults_mod.CanaryGateTrip(times=1)
    records.append(tr.step())
    records.append(tr.step())
    return records, torn.calls


def test_trainer_matches_the_reference_over_one_stream(tmp_path,
                                                       monkeypatch):
    from dislib_tpu.data import io as ref_io
    from dislib_tpu.serving import bundle as ref_bundle

    from dislib_tpu_torch.serving import bundle as port_bundle
    stream, _ = _batches(8, poison=(3,), dead=(5,))
    port_io.quarantine_ledger().reset()
    ref_io.quarantine_ledger().reset()
    with ModelRouter() as prouter:
        ptr = _port_trainer(str(tmp_path / "port"), stream, prouter)
        prec, pcalls = _drive(ptr, port_bundle, faults, monkeypatch)
        pstats = ptr.stats()
        ptr.close()
    with ref_sv.ModelRouter() as rrouter:
        rtr = _ref_trainer(str(tmp_path / "ref"), stream, rrouter)
        rrec, rcalls = _drive(rtr, ref_bundle, ref_faults, monkeypatch)
        rstats = rtr.stats()
        rtr.close()
    verdicts = [r["verdict"] for r in prec]
    assert verdicts == ["promoted", "promoted", "rejected", "promoted"]
    assert verdicts == [r["verdict"] for r in rrec]
    assert pcalls == rcalls == 2                # torn once, rewritten once
    for key in COUNTER_KEYS:
        assert pstats[key] == rstats[key], key
    assert pstats["export_retries"] == 1
    assert pstats["batches_skipped"] == 1 and pstats["batches"] == 7
    assert pstats["served_generation"] == rstats["served_generation"] == 4
    assert [r["served"] for r in prec] == [r["served"] for r in rrec] \
        == [1, 2, 2, 4]
    assert pstats["quarantine"]["n_quarantined"] == \
        rstats["quarantine"]["n_quarantined"] > 0
    assert pstats["fleet"] == {"rank_deaths": 0, "rank_rejoins": 0}
    np.testing.assert_allclose(ptr.estimator.centers_,
                               np.asarray(rtr.estimator.centers_),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ptr.estimator.counts_,
                                  np.asarray(rtr.estimator.counts_))


@pytest.fixture
def served(tmp_path):
    """A port trainer with two generations promoted behind a live
    router."""
    stream, _ = _batches(12)
    router = ModelRouter().__enter__()
    tr = _port_trainer(str(tmp_path), stream, router, promote_budget=2)
    recs = [tr.step(), tr.step()]
    yield tr, router, stream, recs
    tr.close()
    router.__exit__(None, None, None)


def _labels_of(tr, g, rows):
    """Generation g's direct predict of ``rows``, from its bundle."""
    from dislib_tpu_torch.serving import load_bundle
    loaded = load_bundle(tr._bundle_path(g))
    return loaded.pipeline.predict_bucket(rows, BUCKETS[0])


def test_promotion_failed_at_the_budget_keeps_last_good_serving(served):
    tr, router, stream, recs = served
    assert [r["verdict"] for r in recs] == ["promoted", "promoted"]
    tr.health_gate = faults.CanaryGateTrip(times=99)
    assert tr.step()["verdict"] == "rejected"
    with pytest.raises(PromotionFailed) as ei:
        tr.step()
    e = ei.value
    assert (e.tenant, e.generation, e.attempts, e.last_good) == \
        (TENANT, 4, 2, 2)
    assert tr.ledger[-1]["verdict"] == "rejected+budget"
    assert tr.stats()["promote_failures"] == 1
    assert router.stats()[TENANT]["promote_failures"] == 2
    rows = stream[0][:5]
    got = router.submit(rows, TENANT).result(timeout=60)
    np.testing.assert_array_equal(got.values, _labels_of(tr, 2, rows))


def test_rollback_steps_back_one_promoted_generation(served):
    tr, router, stream, _ = served
    rec = tr.rollback()
    assert rec["verdict"] == "rollback" and tr.served_generation == 1
    assert tr.stats()["rollbacks_of_served"] == 1
    assert router.stats()[TENANT]["rollbacks"] == 1
    rows = stream[2][:7]
    got = router.submit(rows, TENANT).result(timeout=60)
    np.testing.assert_array_equal(got.values, _labels_of(tr, 1, rows))
    with pytest.raises(RuntimeError, match="matching 99"):
        tr.rollback(to_generation=99)


def test_ledger_file_mirrors_memory_and_checksums_match(served):
    from dislib_tpu_torch.runtime.bundle_io import file_crc
    tr, _, _, _ = served
    tr.rollback()
    with open(os.path.join(tr.bundle_dir, "ledger.jsonl")) as f:
        on_disk = [json.loads(line) for line in f]
    assert on_disk == tr.ledger
    for r in tr.ledger:
        assert r["checksum"] == file_crc(r["path"])
    assert [r["verdict"] for r in on_disk] == ["promoted", "promoted",
                                               "rollback"]


def test_preempted_mid_stream_is_counted_and_propagates(tmp_path):
    stream, _ = _batches(6)
    tr = _port_trainer(str(tmp_path), stream, None)
    assert tr.step()["verdict"] == "exported"
    prof.reset_counters()
    request_preemption()
    with pytest.raises(Preempted):
        tr.step()
    clear_preemption()
    assert tr.stats()["preemptions"] == 1
    assert prof.resilience_counters()["trainer_preemptions"] == 1
    # the snapshot is flushed: a fresh trainer resumes the stream from it
    n0 = int(FitCheckpoint(str(tmp_path / "ck.npz")).load()["n_batches"])
    assert n0 >= 2
    fresh = _port_trainer(str(tmp_path), stream[n0:], None)
    assert fresh.step()["verdict"] == "exported"
    assert fresh.estimator.n_batches_ == n0 + 2


def test_membership_names_the_roadmap_item(tmp_path):
    stream, _ = _batches(2)
    with pytest.raises(NotImplementedError, match="A.11"):
        _port_trainer(str(tmp_path), stream, None, membership=object())


def test_a_request_routed_to_a_retired_server_is_routed_again():
    """The window a promotion leaves: the router picks the primary, the
    trainer promotes the canary and stops the old primary, and only then
    does the request reach the old primary's queue.  The router routes it
    again (to the new primary) instead of failing it."""
    from dislib_tpu_torch.serving import PredictServer
    stream, _ = _batches(2)
    km = dst.from_fitted_arrays(dst.KMeans, {"centers_": _init(stream)},
                                device="cpu", n_clusters=K)
    old = PredictServer(pipeline=ServePipeline(km, n_features=NF),
                        buckets=BUCKETS, deadline_ms=1).start()
    new = PredictServer(pipeline=ServePipeline(km, n_features=NF),
                        buckets=BUCKETS, deadline_ms=1).start()
    router = ModelRouter()
    router.add_tenant(TENANT, old)
    real = old.submit

    def promote_then_queue(rows, tenant=None):
        router.set_canary(TENANT, new, fraction=0.5)
        router.promote(TENANT)
        old.stop()
        return real(rows, tenant=tenant)

    old.submit = promote_then_queue
    rows = stream[0][:5]
    got = router.submit(rows, TENANT).result(timeout=60)
    np.testing.assert_array_equal(
        got.values, km.predict(dst.array(rows)).collect())
    assert router.route(TENANT, rows)[0] is new
    # a server that stops while still routed fails the request as before
    with pytest.raises(RuntimeError, match="not running"):
        new.stop()
        router.submit(rows, TENANT)
