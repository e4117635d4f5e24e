"""The port's serving layer against the reference's, on CPU.

The same numpy rows go through ``dislib_tpu.serving`` (8 virtual CPU
devices, one XLA program per bucket) and ``dislib_tpu_torch.serving`` on
the CPU, where every served chain runs eagerly on the plain versions of
the kernels (a CUDA graph replay needs a card: ``tests/test_torch_cuda.py``
holds those).  Fitted reference models are carried into the port with
``from_fitted_arrays``, so both packages serve the same model.

Tolerances: labels and top-k ids equal; linear predictions, forest
probabilities and IVF distances within 1e-5 (float32 sums in another
order); fold-in scores within 1e-4 of the reference's ``_fold_in_body``
(as ``tests/test_torch_als.py``); ``pack_sparse_rows`` bit-equal.  The
pipeline is held to a direct predict on the same rows bit for bit, as the
reference's ``tests/test_serving.py`` does.

The reference's own ``SparseFoldInPipeline`` is not the oracle (its
fold-in serving fails under the installed jax, ROADMAP.md C.2), nor its
bundle path (C.4).
"""

import ast
import os
import threading
import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

import dislib_tpu as ds
from dislib_tpu import serving as ref_serving
from dislib_tpu.ops import precision as ref_px
from dislib_tpu.recommendation import als as ref_als
from dislib_tpu.retrieval import IVFIndex as RefIVF
from dislib_tpu.retrieval import RetrievalPipeline as RefRetrieval
from dislib_tpu.serving import buckets as ref_buckets

import dislib_tpu_torch as dst
from dislib_tpu_torch import serving
from dislib_tpu_torch.recommendation import ALS
from dislib_tpu_torch.retrieval import IVFIndex, RetrievalPipeline
from dislib_tpu_torch.runtime import (AdoptionRejected, adopt_latest,
                                      generation_token)
from dislib_tpu_torch.serving import (BucketLadderError, ModelPool,
                                      ModelRouter, PredictServer,
                                      ProgramCache, QueueFull,
                                      ServePipeline, SparseFoldInPipeline,
                                      TenantQuotaExceeded, bucket_for,
                                      bucket_ladder, pack_sparse_rows,
                                      split_rows)
from dislib_tpu_torch.serving.buckets import BucketTemplate
from dislib_tpu_torch.utils import profiling as prof
from dislib_tpu_torch.utils.checkpoint import FitCheckpoint
from dislib_tpu_torch.utils.faults import corrupt_snapshot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKETS = (1, 8, 64)
NF = 8

_ctx = {}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    dst.init(device="cpu")


def ctx():
    """Module-cached rows and models: the reference's fits, and the port's
    carried copies of them."""
    if not _ctx:
        dst.init(device="cpu")
        rng = np.random.RandomState(7)
        x = rng.rand(200, NF).astype(np.float32)
        a = ds.array(x)
        y = (x[:, :1] @ np.ones((1, 2), np.float32) * 3.0
             + x[:, 1:3]).astype(np.float32)
        cls = (x[:, 0] + x[:, 1] > 1.0).astype(np.float32)[:, None]
        ref = {"scaler": ds.StandardScaler().fit(a),
               "km": ds.KMeans(n_clusters=3, max_iter=4,
                               random_state=0).fit(a),
               "lr": ds.LinearRegression().fit(a, ds.array(y)),
               "rf": ds.RandomForestClassifier(
                   n_estimators=3, max_depth=4, random_state=0).fit(
                       a, ds.array(cls))}
        port = {
            "scaler": dst.from_fitted_arrays(dst.StandardScaler, {
                "mean_": ref["scaler"].mean_.collect(),
                "var_": ref["scaler"].var_.collect()}, device="cpu"),
            "km": dst.from_fitted_arrays(dst.KMeans, {
                "centers_": np.asarray(ref["km"].centers_)}, device="cpu",
                n_clusters=3),
            "lr": dst.from_fitted_arrays(dst.LinearRegression, {
                "coef_": ref["lr"].coef_,
                "intercept_": ref["lr"].intercept_}, device="cpu"),
            "rf": dst.from_fitted_arrays(dst.RandomForestClassifier, {
                k: np.asarray(getattr(ref["rf"], k)) for k in
                ("_edges", "_feats", "_tbins", "_depth", "_leaves",
                 "n_features_", "classes_")}, device="cpu")}
        _ctx.update(x=x, ref=ref, port=port)
    return _ctx


def _km_pipe():
    c = ctx()["port"]
    return ServePipeline(c["km"], transforms=(c["scaler"],))


def _linreg_state(g):
    """Generation g of the hot-swap model: ŷ = x @ 1 + g, so a response's
    value − row-sum names the generation that computed it."""
    return {"coef": np.ones((NF, 1), np.float32),
            "intercept": np.full(1, float(g), np.float32)}


def _build_linreg(state):
    lr = dst.LinearRegression()
    lr.coef_ = np.asarray(state["coef"], np.float32)
    lr.intercept_ = np.asarray(state["intercept"], np.float32)
    return ServePipeline(lr, n_features=NF)


def _linreg(g):
    return _build_linreg(_linreg_state(g))


def _gen_of(values, rows):
    g = np.unique(np.round(values.ravel() - rows.sum(axis=1), 3))
    assert len(g) == 1, f"response mixes generations: {g}"
    return float(g[0])


# ---------------------------------------------------------------------------
# buckets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ladder", [None, (64, 1, 8, 8), (3,), (5, 2, 9)])
def test_ladder_and_splits_match_the_reference(ladder, monkeypatch):
    monkeypatch.delenv("DSLIB_SERVE_BUCKETS", raising=False)
    want = ref_buckets.bucket_ladder(ladder)
    assert bucket_ladder(ladder) == want
    for n in (1, 2, 3, 8, 9, 64, 65, 150, 1100):
        assert bucket_for(n, want) == ref_buckets.bucket_for(n, want)
        assert split_rows(n, want) == ref_buckets.split_rows(n, want)


@pytest.mark.parametrize("env", ["4, 32", "8,8,64", "512,64", "x,8", "0,8",
                                 ", ,"])
def test_env_ladder_parses_as_the_reference(env, monkeypatch):
    monkeypatch.setenv("DSLIB_SERVE_BUCKETS", env)
    try:
        want = ref_buckets.bucket_ladder()
    except ref_buckets.BucketLadderError as exc:
        with pytest.raises(BucketLadderError) as got:
            bucket_ladder()
        assert str(got.value) == str(exc)
        assert isinstance(got.value, ValueError)
        return
    assert bucket_ladder() == want
    with pytest.raises(ValueError):
        bucket_ladder((0, 8))


def test_template_fills_as_the_reference():
    # the pinned template (the served path on cuda) is held on the card,
    # tests/test_torch_cuda.py
    rng = np.random.RandomState(1)
    ours, ref = BucketTemplate((8, 4)), ref_buckets.BucketTemplate((8, 4))
    for k in (5, 2, 7, 1):
        rows = rng.rand(k, 4).astype(np.float32)
        np.testing.assert_array_equal(ours.fill(rows), ref.fill(rows))
    with pytest.raises(ValueError):
        ours.fill(np.ones((9, 4), np.float32))


# ---------------------------------------------------------------------------
# pipelines against the reference's predict_bucket
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["scaler_kmeans", "linreg",
                                   "forest_proba"])
def test_predict_bucket_matches_the_reference(model):
    c = ctx()
    x, ref, port = c["x"], c["ref"], c["port"]
    if model == "scaler_kmeans":
        rp = ref_serving.ServePipeline(ref["km"], transforms=(ref["scaler"],),
                                       n_features=NF)
        pp = _km_pipe()
        direct = port["km"].predict(port["scaler"].transform(
            dst.array(x[:5]))).collect()
    elif model == "linreg":
        rp = ref_serving.ServePipeline(ref["lr"], n_features=NF)
        pp = ServePipeline(port["lr"])
        direct = port["lr"].predict(dst.array(x[:5])).collect()
    else:
        rp = ref_serving.ServePipeline(ref["rf"], method="predict_proba",
                                       n_features=NF)
        pp = ServePipeline(port["rf"], method="predict_proba")
        direct = port["rf"].predict_proba(dst.array(x[:5])).collect()
    assert pp.n_features == NF
    want = np.asarray(rp.predict_bucket(x[:5], 8))
    got = pp.predict_bucket(x[:5], 8)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, direct)
    if model == "scaler_kmeans":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # a one-row request through bucket 1, and the same rows in bucket 64
    np.testing.assert_array_equal(pp.predict_bucket(x[3], 1), got[3:4])
    np.testing.assert_array_equal(pp.predict_bucket(x[:5], 64), got)


def test_cpu_programs_run_eagerly_and_count_their_ops():
    pipe = _km_pipe()
    cache = ProgramCache()
    out = cache.warm(pipe, "g0", BUCKETS)
    assert np.all(np.isfinite(out)) and len(cache) == len(BUCKETS)
    st = cache.stats()["gen='g0'/bucket=8"]
    assert st["mode"] == "eager" and st["eager_reason"].startswith("cpu")
    assert st["captures_at_warm"] == 0 and st["builds_at_warm"] == 0
    assert pipe.program(8).mode == "eager"
    assert [s for s, ok in pipe._steps()] == [
        "StandardScaler.transform", "KMeans.predict"]
    assert all(ok for _, ok in pipe._steps())
    prof.reset_counters()
    pipe.predict_bucket(ctx()["x"][:4], 8)
    c = prof.counters()
    assert c["traces"] == 0 and set(c["dispatch_by"]) == {"eager_chain"}
    assert c["dispatches"] > 1              # its ATen ops, counted
    assert serving.pipeline.declared(ctx()["port"]["rf"], "predict_proba")
    assert not serving.pipeline.declared(dst.GaussianMixture(), "predict")


def test_pipeline_rejects_bad_requests_and_infers_width():
    pipe = _km_pipe()
    with pytest.raises(ValueError, match="features"):
        pipe.predict_bucket(np.ones((2, NF + 1), np.float32), 8)
    with pytest.raises(ValueError, match="exceed"):
        pipe.predict_bucket(np.ones((9, NF), np.float32), 8)
    c = ctx()["port"]
    assert ServePipeline(c["km"]).n_features == NF
    assert ServePipeline(c["lr"]).n_features == NF
    assert ServePipeline(c["rf"]).n_features == NF


def test_program_cache_rekey_evicts_old_generations():
    pipe = _km_pipe()
    cache = ProgramCache()
    cache.warm(pipe, "g0", BUCKETS)
    assert cache.is_warm("g0", 8) and not cache.is_warm("g1", 8)
    cache.rekey("g0", "g1")
    assert cache.is_warm("g1", 8) and not cache.is_warm("g0", 8)
    cache.warm(pipe, "warming", BUCKETS)
    cache.rekey("warming", "g2")
    assert len(cache) == len(BUCKETS)
    assert cache.is_warm("g2", 8) and not cache.is_warm("g1", 8)
    cache.record_hit("g2", 8)
    assert cache.stats()["gen='g2'/bucket=8"]["hits"] == 1


# ---------------------------------------------------------------------------
# the micro-batching server
# ---------------------------------------------------------------------------

def _km_server(deadline_ms=5, **kw):
    return PredictServer(pipeline=_km_pipe(), buckets=BUCKETS,
                         deadline_ms=deadline_ms, **kw)


def test_single_request_flushes_on_deadline():
    with _km_server(deadline_ms=5) as srv:
        r = srv.submit(ctx()["x"][0]).result(timeout=30)
        assert r.values.shape == (1, 1) and r.generation is None
        assert srv.stats()["batches"] == 1


def test_burst_coalesces_and_every_response_is_a_direct_predict():
    c = ctx()
    pipe = _km_pipe()
    with PredictServer(pipeline=pipe, buckets=BUCKETS,
                       deadline_ms=20) as srv:
        futs = [srv.submit(c["x"][i:i + 2]) for i in range(0, 80, 2)]
        outs = [f.result(timeout=30) for f in futs]
        st = srv.stats()
    assert st["requests"] == 40 and st["rows"] == 80
    assert st["batches"] < st["requests"]
    # one eager chain a batch: its dispatches are one bucket's ops
    d0 = prof.thread_dispatch_count()
    pipe.predict_bucket(c["x"][:8], 64)
    assert st["dispatches_per_batch_max"] == \
        prof.thread_dispatch_count() - d0
    want = c["port"]["km"].predict(c["port"]["scaler"].transform(
        dst.array(c["x"]))).collect().ravel()
    for i, o in zip(range(0, 80, 2), outs):
        np.testing.assert_array_equal(o.values.ravel(), want[i:i + 2])


def test_oversize_request_splits_at_the_largest_bucket():
    c = ctx()
    with _km_server() as srv:
        r = srv.submit(c["x"][:150]).result(timeout=30)
        st = srv.stats()
    assert r.values.shape == (150, 1)
    want = c["port"]["km"].predict(c["port"]["scaler"].transform(
        dst.array(c["x"][:150]))).collect()
    np.testing.assert_array_equal(r.values, want)
    # 150 rows over (1, 8, 64): pieces of 64 + 64 + 22, all in bucket 64
    assert split_rows(150, BUCKETS) == [64, 64, 22]
    assert st["batches"] == 1 and set(srv.bucket_cost()) == {64}


def test_bad_request_fails_only_its_own_future():
    c = ctx()
    with _km_server(deadline_ms=50) as srv:
        good1 = srv.submit(c["x"][:2])
        bad = srv.submit(np.ones((2, NF + 3), np.float32))
        good2 = srv.submit(c["x"][2:4])
        with pytest.raises(ValueError, match="features"):
            bad.result(timeout=30)
        assert good1.result(timeout=30).values.shape == (2, 1)
        assert good2.result(timeout=30).values.shape == (2, 1)
        assert srv.submit(c["x"][:2]).result(timeout=30).values.shape == \
            (2, 1)


def test_lifecycle_backpressure_and_refusals():
    c = ctx()
    srv = _km_server()
    with pytest.raises(RuntimeError):
        srv.submit(np.ones((1, NF), np.float32))
    with srv:
        pass
    with pytest.raises(RuntimeError):
        srv.submit(np.ones((1, NF), np.float32))
    with pytest.raises(ValueError, match="exactly one"):
        PredictServer()
    with pytest.raises(NotImplementedError, match="A.11"):
        PredictServer(pipeline=_km_pipe(), elastic=True)
    with pytest.raises(NotImplementedError, match="A.11"):
        PredictServer(pipeline=_km_pipe(), membership=object())
    srv = _km_server(deadline_ms=2000, max_queue_rows=4)
    with srv:
        futs = [srv.submit(c["x"][i:i + 2], tenant="acme") for i in (0, 2)]
        with pytest.raises(QueueFull, match="queue full") as ei:
            srv.submit(c["x"][:1], tenant="acme")
        assert ei.value.tenant == "acme"
        assert srv.stats()["tenants"]["acme"]["shed"] == 1
    for f in futs:                      # stop() drained the queue
        assert f.result(timeout=10).values.shape == (2, 1)


def test_stats_cost_model_and_predicted_latency():
    with _km_server(deadline_ms=1) as srv:
        assert srv.predict_latency(3) is None       # no model yet
        for _ in range(4):
            srv.predict(np.zeros((2, NF), np.float32), tenant="t")
        st = srv.stats()
        cost = srv.bucket_cost()
        assert set(cost) == {8} and cost[8] > 0
        assert srv.predict_latency(3) == pytest.approx(
            srv.deadline_s + cost[8])
        assert srv.predict_latency(100) is None     # bucket 64 unknown
    for key in ("p50_ms", "p95_ms", "p99_ms", "requests", "rows", "batches",
                "qps", "rows_per_s", "dispatches_per_batch_max",
                "queue_depth", "queued_rows", "shed", "bucket_cost_ms",
                "tenants", "swaps", "rejected_swaps"):
        assert key in st
    assert st["tenants"]["t"]["requests"] == 4


# ---------------------------------------------------------------------------
# adoption and hot-swap
# ---------------------------------------------------------------------------

def _probe(p):
    return p.predict_bucket(np.zeros((1, NF), np.float32), 1)


def test_adopt_latest_gates_and_tokens_as_the_reference(tmp_path):
    from dislib_tpu.runtime import generation_token as ref_token
    from dislib_tpu.utils.checkpoint import FitCheckpoint as RefCheckpoint
    path = str(tmp_path / "gen.npz")
    writer = FitCheckpoint(path, keep=2)
    reader = FitCheckpoint(path, keep=2)
    assert generation_token(reader) is None
    assert adopt_latest(reader, _build_linreg) is None
    writer.save(_linreg_state(1))
    assert generation_token(reader) == ref_token(RefCheckpoint(path, keep=2))
    ad = adopt_latest(reader, _build_linreg, probe=_probe)
    assert ad is not None and repr(ad).startswith("Adoption(")
    assert adopt_latest(reader, _build_linreg, last_token=ad.token) is None
    writer.save(_linreg_state(2))
    ad2 = adopt_latest(reader, _build_linreg, last_token=ad.token)
    assert ad2 is not None and ad2.token != ad.token
    assert float(ad2.state["intercept"][0]) == 2.0
    # the reference's gate adopts the port's snapshot, and vice versa
    RefCheckpoint(path, keep=2).save(_linreg_state(3))
    ad3 = adopt_latest(reader, _build_linreg, last_token=ad2.token)
    assert float(ad3.state["intercept"][0]) == 3.0


@pytest.mark.parametrize("where", ["state", "probe", "validate"])
def test_unhealthy_generation_is_refused_typed(tmp_path, where):
    path = str(tmp_path / "gen.npz")
    if where == "state":
        # NaN centers behind integer labels: the probe alone is blind
        # (argmin over NaN distances is a finite label), the state gate
        # refuses
        FitCheckpoint(path, keep=2).save(
            {"centers": np.full((3, NF), np.nan, np.float32)})

        def build(state):
            km = dst.KMeans(n_clusters=3)
            km.centers_ = np.asarray(state["centers"], np.float32)
            return ServePipeline(km, n_features=NF)
        assert np.all(np.isfinite(_probe(build(
            {"centers": np.full((3, NF), np.nan, np.float32)}))))
        with pytest.raises(AdoptionRejected, match="non-finite state"):
            adopt_latest(FitCheckpoint(path, keep=2), build, probe=_probe)
        return
    FitCheckpoint(path, keep=2).save(_linreg_state(1))
    if where == "probe":
        def build(state):
            pipe = _build_linreg(state)
            pipe.model.coef_ = np.full((NF, 1), np.inf, np.float32)
            return pipe
        with pytest.raises(AdoptionRejected, match="warmup predict") as ei:
            adopt_latest(FitCheckpoint(path, keep=2), build, probe=_probe)
        assert ei.value.token is not None and ei.value.detail
        return

    def validate(model, state):
        raise AdoptionRejected("refused by the caller", token="t")
    with pytest.raises(AdoptionRejected, match="caller"):
        adopt_latest(FitCheckpoint(path, keep=2), _build_linreg,
                     validate=validate)


def test_writer_rotation_never_yields_torn_state(tmp_path):
    path = str(tmp_path / "gen.npz")
    writer = FitCheckpoint(path, keep=2)
    reader = FitCheckpoint(path, keep=2)
    n_gens = 25
    stop = threading.Event()

    def write():
        for g in range(1, n_gens + 1):
            writer.save(_linreg_state(g))
        stop.set()

    t = threading.Thread(target=write)
    t.start()
    seen, last = [], None
    try:
        while not stop.is_set() or not seen:
            ad = adopt_latest(reader, _build_linreg, last_token=last)
            if ad is None:
                continue
            last = ad.token
            assert np.array_equal(ad.state["coef"],
                                  np.ones((NF, 1), np.float32))
            g = float(ad.state["intercept"][0])
            assert g == int(g) and 1 <= g <= n_gens
            seen.append(g)
    finally:
        t.join()
    assert seen == sorted(seen), "adoptions went backwards"


def test_pool_swaps_refuses_nan_and_survives_corruption(tmp_path):
    path = str(tmp_path / "gen.npz")
    writer = FitCheckpoint(path, keep=2)
    pool = ModelPool(FitCheckpoint(path, keep=2), _build_linreg,
                     buckets=BUCKETS, poll_interval_s=0.0)
    assert pool.current() == (None, None) and not pool.adopting
    writer.save(_linreg_state(1))
    assert pool.poll(force=True)
    rows = ctx()["x"][:4]

    def served_gen():
        _, pipe = pool.current()
        return _gen_of(pipe.predict_bucket(rows, 8), rows)

    assert served_gen() == 1.0
    st = pool.stats()
    assert st["live"] and st["adoptions"] == 1
    assert len(st["cache"]) == len(BUCKETS)
    writer.save({"coef": np.full((NF, 1), np.nan, np.float32),
                 "intercept": np.zeros(1, np.float32)})
    assert not pool.poll(force=True)
    assert pool.rejections == 1 and served_gen() == 1.0
    assert isinstance(pool.last_rejection, AdoptionRejected)
    assert not pool.poll(force=True)        # no re-gating storm
    assert pool.rejections == 1
    writer.save(_linreg_state(3))
    assert pool.poll(force=True)
    assert served_gen() == 3.0
    with pytest.warns(RuntimeWarning):
        writer.save(_linreg_state(4))
        corrupt_snapshot(path)
        pool.poll(force=True)
    g = served_gen()
    assert g in (3.0, 4.0) and g == int(g)


def test_server_over_pool_serves_across_swaps_untorn(tmp_path):
    path = str(tmp_path / "gen.npz")
    writer = FitCheckpoint(path, keep=2)
    writer.save(_linreg_state(1))
    pool = ModelPool(FitCheckpoint(path, keep=2), _build_linreg,
                     buckets=BUCKETS, poll_interval_s=0.0)
    with pytest.raises(ValueError, match="warmed ladder"):
        PredictServer(pool=pool, buckets=(1, 8, 64, 512))
    rows = ctx()["x"][:4]
    with PredictServer(pool=pool, deadline_ms=1) as srv:
        r1 = srv.submit(rows).result(timeout=30)
        assert _gen_of(r1.values, rows) == 1.0
        writer.save(_linreg_state(2))
        deadline = time.time() + 30
        while time.time() < deadline:
            r = srv.submit(rows).result(timeout=30)
            assert _gen_of(r.values, rows) in (1.0, 2.0)
            if r.generation != r1.generation:
                break
            time.sleep(0.005)
        assert r.generation != r1.generation, "swap never served"
        assert _gen_of(r.values, rows) == 2.0
        assert srv.stats()["swaps"] == 2


def test_pool_follows_a_checkpointed_kmeans_fit(tmp_path):
    """A real ``FitCheckpoint`` rotated by a checkpointed KMeans fit:
    every adopted generation serves the labels of a direct predict with
    that generation's centers."""
    c = ctx()
    x = c["x"]
    path = str(tmp_path / "km.npz")
    scaler = c["port"]["scaler"]

    def build(state):
        km = dst.KMeans(n_clusters=3)
        km.centers_ = np.asarray(state["centers"], np.float32)
        return ServePipeline(km, transforms=(scaler,), n_features=NF)

    pool = ModelPool(FitCheckpoint(path, keep=2), build, buckets=BUCKETS,
                     poll_interval_s=0.0)
    xs = scaler.transform(dst.array(x))
    km = dst.KMeans(n_clusters=3, max_iter=1, tol=0.0, random_state=0)
    served = {}
    for it in range(1, 5):
        km.max_iter = it
        km.fit(xs, checkpoint=FitCheckpoint(path, every=1, keep=2))
        assert pool.poll(force=True) or it > 1
        tok, pipe = pool.current()
        served[tok] = pipe.model.centers_
        got = pipe.predict_bucket(x[:40], 64)
        want = pipe.model.predict(scaler.transform(
            dst.array(x[:40]))).collect()
        np.testing.assert_array_equal(got, want)
    assert pool.adoptions >= 2 and len(served) >= 2


# ---------------------------------------------------------------------------
# the tenant router
# ---------------------------------------------------------------------------

def test_router_quotas_shed_only_the_offender():
    srv = _km_server()
    r = ModelRouter()
    r.add_tenant("noisy", srv, quota_rows=4)
    r.add_tenant("quiet", srv)
    with r:
        srv.deadline_s = 1.0
        f1 = r.submit(np.ones((4, NF), np.float32), "noisy")
        with pytest.raises(TenantQuotaExceeded) as ei:
            r.submit(np.ones((1, NF), np.float32), "noisy")
        assert ei.value.tenant == "noisy" and ei.value.quota_rows == 4
        f2 = r.submit(np.ones((2, NF), np.float32), "quiet")
        srv.deadline_s = 0.001
        assert f1.result(timeout=30).values.shape == (4, 1)
        assert f2.result(timeout=30).values.shape == (2, 1)
        st = r.stats()
        assert st["noisy"]["quota_shed"] == 1
        assert st["quiet"]["quota_shed"] == 0
        for _ in range(3):                  # the quota frees each time
            r.predict(np.ones((4, NF), np.float32), "noisy")
        assert r.stats()["noisy"]["inflight_rows"] == 0
    with pytest.raises(ValueError, match="already registered"):
        r.add_tenant("quiet", srv)
    with pytest.raises(KeyError, match="unknown tenant"):
        r.submit(np.ones((1, NF), np.float32), "ghost")
    with pytest.raises(TypeError, match="PredictServer"):
        r.add_tenant("u", object())


def test_router_canary_promote_abort_and_rollback(tmp_path):
    s1 = PredictServer(pipeline=_linreg(5.0), buckets=BUCKETS, name="gen5")
    s2 = PredictServer(pipeline=_linreg(6.0), buckets=BUCKETS, name="gen6")
    r = ModelRouter()
    r.add_tenant("t", s1)
    rows = np.ones((1, NF), np.float32)
    with r:
        r.set_canary("t", s2, fraction=0.5)
        labels = {f"user{i}": r.route("t", rows, key=f"user{i}")[1]
                  for i in range(32)}
        assert set(labels.values()) == {"t", "t:canary"}
        for k, lab in labels.items():           # deterministic per key
            assert r.route("t", rows, key=k)[1] == lab
        seen = {float(r.predict(rows, "t", key=k).ravel()[0]) - NF
                for k in labels}
        assert seen == {5.0, 6.0}
        r.promote("t")
        for i in range(8):
            assert float(r.predict(rows, "t", key=f"user{i}")[0, 0]) - \
                NF == 6.0
        with pytest.raises(RuntimeError, match="no canary"):
            r.promote("t")
        r.set_canary("t", s1, fraction=1.0)
        assert r.route("t", rows, key="k")[1] == "t:canary"
        r.abort_canary("t", failed=True)
        assert r.route("t", rows, key="k")[1] == "t"
        r.rollback("t", s1)
        assert float(r.predict(rows, "t")[0, 0]) - NF == 5.0
        st = r.stats()["t"]
        assert (st["promotions"], st["rollbacks"]) == (1, 1)
        assert st["promote_failures"] == 2
    with pytest.raises(ValueError, match="fraction"):
        r.set_canary("t", s2, fraction=0.0)
    pool = ModelPool(FitCheckpoint(str(tmp_path / "never"), keep=2),
                     build=lambda s: _linreg(0.0), buckets=BUCKETS)
    hollow = PredictServer(pool=pool, name="hollow")
    r._tenants["t"].canary = hollow      # bypass set_canary's start
    r._tenants["t"].canary_fraction = 0.5
    with pytest.raises(RuntimeError, match="adoption gate"):
        r.promote("t")
    assert r._tenants["t"].server is s1


def test_router_deadline_sheds_on_the_learned_cost():
    srv = _km_server(deadline_ms=1)
    r = ModelRouter(deadline_ms=1e-6)
    r.add_tenant("t", srv)
    with r:
        # no cost model yet: the budget never sheds on ignorance
        for _ in range(3):
            r.predict(np.ones((2, NF), np.float32), "t")
        with pytest.raises(serving.DeadlineShed) as ei:
            r.submit(np.ones((2, NF), np.float32), "t")
        assert ei.value.tenant == "t" and ei.value.predicted_ms > 0
        assert r.stats()["t"]["deadline_shed"] == 1
        assert r.stats()["t"]["inflight_rows"] == 0


# ---------------------------------------------------------------------------
# sparse fold-in
# ---------------------------------------------------------------------------

M_ALS, N_ALS, F_ALS, LAM = 40, 24, 3, 0.065


def _als_model():
    rng = np.random.RandomState(0)
    users = rng.rand(M_ALS, F_ALS).astype(np.float32)
    items = rng.rand(N_ALS, F_ALS).astype(np.float32)
    return dst.from_fitted_arrays(ALS, {"users_": users, "items_": items},
                                  device="cpu", n_f=F_ALS, lambda_=LAM)


def _new_ratings(k=6, seed=3):
    rng = np.random.RandomState(seed)
    r = (rng.rand(k, N_ALS) < 0.3) * (1 + 4 * rng.rand(k, N_ALS))
    r[0] = 0                                # a user with no rating
    return r.astype(np.float32)


@pytest.mark.parametrize("form", ["dense", "csr", "pairs"])
def test_pack_sparse_rows_is_bit_equal_to_the_reference(form):
    r = _new_ratings()
    if form == "dense":
        rows = r
    elif form == "csr":
        rows = sp.csr_matrix(r)
    else:
        rows = [(np.nonzero(row)[0], row[np.nonzero(row)[0]]) for row in r]
    want = ref_serving.pack_sparse_rows(rows, 12, n_items=N_ALS)
    got = pack_sparse_rows(rows, 12, n_items=N_ALS)
    assert got.dtype == np.float32 and got.shape == (6, 24)
    np.testing.assert_array_equal(got, np.asarray(want))
    with pytest.raises(ValueError, match="nse_cap"):
        pack_sparse_rows(rows, 2, n_items=N_ALS)
    wide = np.zeros((1, N_ALS + 3), np.float32)
    wide[0, -1] = 1.0
    with pytest.raises(ValueError, match="out of range"):
        pack_sparse_rows(wide, 12, n_items=N_ALS)


@pytest.mark.parametrize("top_n", [None, 4])
def test_fold_in_pipeline_matches_the_reference_body(top_n):
    model = _als_model()
    pipe = SparseFoldInPipeline(model, nse_cap=12, top_n=top_n)
    assert pipe.n_features == 24
    r = _new_ratings()
    packed = pipe.pack(r)
    got = pipe.predict_bucket(packed, 8)
    cols, vals = ref_als._fold_in_pack(r, N_ALS)
    _, want = ref_als._fold_in_body(
        vals, cols, jnp.asarray(model.items_), LAM, F_ALS, ref_px.FLOAT32,
        top_n=int(top_n or 0))
    if top_n:
        rid, rsc = (np.asarray(a) for a in want)
        assert got.shape == (6, 2 * top_n)
        np.testing.assert_allclose(got[:, top_n:], rsc, rtol=0, atol=1e-4)
        srt = np.sort(rsc, axis=1)[:, ::-1]
        untied = np.all(np.abs(np.diff(srt, axis=1)) > 1e-4, axis=1)
        np.testing.assert_array_equal(got[untied, :top_n].astype(np.int32),
                                      rid[untied])
    else:
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(got, model.fold_in(r), rtol=0,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="nse_cap"):
        pipe.predict_bucket(np.ones((2, 5), np.float32), 8)
    with pytest.raises(ValueError, match="FITTED"):
        SparseFoldInPipeline(ALS())
    with PredictServer(pipeline=pipe, buckets=BUCKETS, deadline_ms=1) as s:
        np.testing.assert_array_equal(s.predict(packed[:3]), got[:3])


# ---------------------------------------------------------------------------
# IVF retrieval
# ---------------------------------------------------------------------------

def _ivf_pair():
    rng = np.random.RandomState(7)
    centers = rng.randn(4, 16).astype(np.float32) * 20
    x = (centers[rng.randint(0, 4, 128)] + rng.randn(128, 16)).astype(
        np.float32)
    labels = np.argmin(((x[:, None] - centers[None]) ** 2).sum(-1), 1)
    q = (centers[rng.randint(0, 4, 24)] + rng.randn(24, 16)).astype(
        np.float32)
    ref = RefIVF(n_lists=4, nprobe=2)._build(x, labels, centers)
    port = IVFIndex(n_lists=4, nprobe=2)._build(x, labels, centers,
                                                device="cpu")
    return ref, port, x, q


@pytest.mark.parametrize("overlap", ["db", "kernel"])
def test_retrieval_pipeline_matches_the_reference(overlap, monkeypatch):
    ref, port, x, q = _ivf_pair()
    # the reference's Pallas route fails under the installed jax (C.1):
    # every port route is held to the reference's db
    monkeypatch.setenv("DSLIB_OVERLAP", "db")
    want = np.asarray(RefRetrieval(ref, k=5).predict_bucket(q, 64))
    pipe = RetrievalPipeline(port, k=5, overlap=overlap)
    assert (pipe.n_features, pipe.out_cols, pipe.overlap) == (16, 10,
                                                              overlap)
    got = pipe.predict_bucket(q, 64)
    assert got.shape == (24, 10)
    np.testing.assert_array_equal(got[:, :5], want[:, :5])
    scale = float((q.astype(np.float64) ** 2).sum(1).max()
                  + (x.astype(np.float64) ** 2).sum(1).max())
    np.testing.assert_allclose(got[:, 5:] ** 2, want[:, 5:] ** 2, rtol=0,
                               atol=1e-5 * scale)
    d, i = port.search(q, k=5, overlap=overlap)
    np.testing.assert_array_equal(got[:, :5].astype(np.int32), i.collect())
    np.testing.assert_array_equal(got[:, 5:], d.collect())
    assert prof.schedule_counters()[f"ivf_search:{overlap}"] >= 1
    with pytest.raises(ValueError, match="features"):
        pipe.predict_bucket(q[:, :3], 8)
    from dislib_tpu_torch.parallel import mesh as port_mesh
    import torch
    assert pipe.rebind_mesh(port_mesh.make_mesh((1, 1), "cpu")) is False
    with pytest.raises(NotImplementedError, match="A.11"):
        pipe.rebind_mesh(port_mesh.Mesh(2, 1, torch.device("cpu")))
    with pytest.raises(ValueError, match="k must be"):
        RetrievalPipeline(port, k=0)


# ---------------------------------------------------------------------------
# the adoption-gate lint
# ---------------------------------------------------------------------------

SERVING_DIR = "dislib_tpu_torch/serving"
ADOPTION = "dislib_tpu_torch/runtime/adoption.py"
_FORBIDDEN_ATTR_CALLS = ("load",)
_FORBIDDEN_NP_CALLS = ("load", "savez")


def _serving_files():
    d = os.path.join(REPO, SERVING_DIR)
    for fn in sorted(os.listdir(d)):
        if fn.endswith(".py"):
            yield f"{SERVING_DIR}/{fn}", os.path.join(d, fn)


def test_serving_reads_models_only_through_the_adoption_gate():
    """The reference's ``TestAdoptionGateLint``: no raw snapshot read
    (``.load()``, ``np.load``, ``open()``) anywhere under serving/; the
    pool imports ``adopt_latest``; the gate reads through the verified
    ``checkpoint.load()`` and judges through ``check_host``."""
    offenders = []
    scanned = set()
    for rel, full in _serving_files():
        scanned.add(os.path.basename(rel))
        tree = ast.parse(open(full, encoding="utf-8").read())
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute):
                if f.attr in _FORBIDDEN_ATTR_CALLS:
                    offenders.append(f"{rel}:{node.lineno}: .{f.attr}()")
                elif isinstance(f.value, ast.Name) \
                        and f.value.id in ("np", "numpy", "zipfile",
                                           "torch") \
                        and f.attr in _FORBIDDEN_NP_CALLS:
                    offenders.append(
                        f"{rel}:{node.lineno}: {f.value.id}.{f.attr}()")
            elif isinstance(f, ast.Name) and f.id == "open":
                offenders.append(f"{rel}:{node.lineno}: open()")
    assert not offenders, "\n".join(offenders)
    assert {"hotswap.py", "router.py", "server.py", "sparse.py"} <= scanned
    src = open(os.path.join(REPO, SERVING_DIR, "hotswap.py"),
               encoding="utf-8").read()
    assert "adopt_latest" in src
    tree = ast.parse(open(os.path.join(REPO, ADOPTION),
                          encoding="utf-8").read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "adopt_latest")
    calls = [n.func for n in ast.walk(fn) if isinstance(n, ast.Call)]
    attrs = {f.attr for f in calls if isinstance(f, ast.Attribute)}
    assert "load" in attrs and "check_host" in attrs
    names = {f.attr for f in calls if isinstance(f, ast.Attribute)
             and isinstance(f.value, ast.Name)
             and f.value.id in ("np", "numpy")}
    assert "load" not in names
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        import dislib_tpu_torch.serving.hotswap  # noqa: F401
