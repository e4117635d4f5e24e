"""The port's deployment bundles against the reference's, on CPU.

Bundle bytes: ``runtime.bundle_io`` writes the checkpoint container with
its embedded CRC-32, so a file either package writes verifies under the
other's ``read_bundle``.

Served values: each of the three served pipelines (scaler → KMeans, sparse
fold-in, IVF retrieval) is exported and loaded at buckets 1/8/64 and held
bit-equal to the port's live pipeline, and to the reference's LIVE
pipelines (its loaded bundle is no oracle, ROADMAP.md C.4): KMeans labels
equal to ``ServePipeline``'s, fold-in within 1e-4 of
``SparseFoldInPipeline``'s (as ``tests/test_torch_serving.py``), IVF ids
equal to ``RetrievalPipeline``'s under ``db`` on data without ties (its
``kernel`` route fails, C.1) and distances within 1e-5 of the cancelling
magnitudes.  A fresh subprocess — an empty build directory, ``build_all``
disabled, neither ``jax`` nor ``dislib_tpu`` imported — serves the same
values bit for bit.  On the CPU a bundle carries no kernel library; the
library path (install from bytes, SHA-256 check, no build) is driven with
a ``cuda`` fingerprint and stand-in library bytes.
"""

import hashlib
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

import dislib_tpu as ds
from dislib_tpu import serving as ref_sv
from dislib_tpu.recommendation import ALS as RefALS
from dislib_tpu.retrieval import IVFIndex as RefIVF
from dislib_tpu.retrieval import RetrievalPipeline as RefRetrieval
from dislib_tpu.runtime import bundle_io as ref_io

import dislib_tpu_torch as dst
from dislib_tpu_torch import _build
from dislib_tpu_torch.recommendation import ALS
from dislib_tpu_torch.retrieval import IVFIndex, RetrievalPipeline
from dislib_tpu_torch.runtime import (BundleIncompatible, BundleShardCorrupt,
                                      read_bundle, write_bundle)
from dislib_tpu_torch.runtime.bundle_io import shard_path
from dislib_tpu_torch.serving import (BundlePipeline, LoadedBundle,
                                      PredictServer, ServePipeline,
                                      SparseFoldInPipeline, export_bundle,
                                      load_bundle, runtime_fingerprint)
from dislib_tpu_torch.serving import bundle as port_bundle
from dislib_tpu_torch.utils import profiling as prof
from dislib_tpu_torch.utils.checkpoint import FitCheckpoint, SnapshotCorrupt
from dislib_tpu_torch.utils.faults import corrupt_snapshot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKETS = (1, 8, 64)
NF = 8

_ctx = {}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    dst.init(device="cpu")


def ctx():
    """Module-cached models: the reference's fits and the port's carried
    copies of them, the ALS factors and the IVF layout."""
    if _ctx:
        return _ctx
    dst.init(device="cpu")
    rng = np.random.RandomState(7)
    x = rng.rand(200, NF).astype(np.float32)
    a = ds.array(x)
    rsc = ds.StandardScaler().fit(a)
    rkm = ds.KMeans(n_clusters=3, max_iter=4, random_state=0).fit(
        rsc.transform(a))
    sc = dst.from_fitted_arrays(dst.StandardScaler, {
        "mean_": rsc.mean_.collect(), "var_": rsc.var_.collect()},
        device="cpu")
    km = dst.from_fitted_arrays(dst.KMeans, {
        "centers_": np.asarray(rkm.centers_)}, device="cpu", n_clusters=3)
    users = rng.rand(40, 3).astype(np.float32)
    items = rng.rand(24, 3).astype(np.float32)
    als = dst.from_fitted_arrays(ALS, {"users_": users, "items_": items},
                                 device="cpu", n_f=3, lambda_=0.065)
    rals = RefALS(n_f=3, lambda_=0.065)
    rals.users_, rals.items_ = users, items
    ratings = ((rng.rand(64, 24) < 0.3)
               * (1 + 4 * rng.rand(64, 24))).astype(np.float32)
    ratings[0] = 0                          # a user with no rating
    centers = rng.randn(4, 16).astype(np.float32) * 20
    ix_x = (centers[rng.randint(0, 4, 128)]
            + rng.randn(128, 16)).astype(np.float32)
    labels = np.argmin(((ix_x[:, None] - centers[None]) ** 2).sum(-1), 1)
    q = (centers[rng.randint(0, 4, 64)] + rng.randn(64, 16)).astype(
        np.float32)
    _ctx.update(
        x=x, ref_km=ref_sv.ServePipeline(rkm, transforms=(rsc,)),
        km_pipe=ServePipeline(km, transforms=(sc,)), als=als, rals=rals,
        ratings=ratings,
        ivf=IVFIndex(n_lists=4, nprobe=2)._build(ix_x, labels, centers,
                                                 device="cpu"),
        ref_ivf=RefIVF(n_lists=4, nprobe=2)._build(ix_x, labels, centers),
        ix_x=ix_x, q=q)
    return _ctx


def _pipes():
    """(name, live port pipeline, request rows) of the three kinds."""
    c = ctx()
    out = [("kmeans", c["km_pipe"], c["x"][:64])]
    for top_n in (None, 3):
        p = SparseFoldInPipeline(c["als"], nse_cap=12, top_n=top_n)
        out.append((f"fold_in_{top_n}", p, p.pack(c["ratings"])))
    out.append(("ivf", RetrievalPipeline(c["ivf"], k=5, overlap="kernel"),
                c["q"]))
    return out


# -- the bytes ----------------------------------------------------------------

@pytest.mark.parametrize("writer", ["reference", "port"])
def test_bundle_files_verify_in_both_packages(writer, tmp_path):
    path = str(tmp_path / "b.npz")
    arrays = {"bundle_meta": np.asarray(json.dumps({"a": 1})),
              "leaf_1": np.arange(12, dtype=np.float32).reshape(3, 4),
              "lib__x": np.frombuffer(b"\x7fELF...", np.uint8)}
    (ref_io.write_bundle if writer == "reference" else write_bundle)(
        path, arrays)
    for got in (read_bundle(path), ref_io.read_bundle(path)):
        assert sorted(got) == sorted(arrays)
        for k, v in arrays.items():
            np.testing.assert_array_equal(got[k], v)
    with pytest.raises(ValueError, match="reserved"):
        write_bundle(path, {"_dslib_crc32": np.zeros(1)})


@pytest.mark.parametrize("mode", ["truncate", "flip", "foreign"])
def test_damaged_bundle_raises_snapshot_corrupt(mode, tmp_path):
    path = str(tmp_path / "km.npz")
    export_bundle(ctx()["km_pipe"], path, buckets=(8,))
    corrupt_snapshot(path, mode=mode)
    with pytest.raises(SnapshotCorrupt):
        read_bundle(path)
    with pytest.raises(SnapshotCorrupt):
        load_bundle(path)


# -- the served values -----------------------------------------------------

@pytest.mark.parametrize("name", ["kmeans", "fold_in_None", "fold_in_3",
                                  "ivf"])
def test_loaded_bundle_serves_as_the_live_pipelines(name, tmp_path,
                                                    monkeypatch):
    _, live, rows = next(p for p in _pipes() if p[0] == name)
    path = str(tmp_path / f"{name}.npz")
    man = export_bundle(live, path, buckets=BUCKETS)
    assert man["buckets"] == list(BUCKETS) and man["libraries"] == {}
    assert man["spec"]["kind"] == {"kmeans": "serve",
                                   "ivf": "retrieval"}.get(
                                       name, "sparse_fold_in")
    loaded = load_bundle(path)
    assert isinstance(loaded, LoadedBundle) and not loaded.fallback
    assert isinstance(loaded.pipeline, BundlePipeline)
    assert loaded.buckets == BUCKETS
    c = ctx()
    for b in BUCKETS:
        prof.reset_counters()
        got = loaded.pipeline.predict_bucket(rows[:b], b)
        assert prof.counters()["dispatch_by"]["bundle_exec"] == 1
        np.testing.assert_array_equal(got, live.predict_bucket(rows[:b], b))
        if name == "kmeans":
            want = np.asarray(c["ref_km"].predict_bucket(rows[:b], b))
            np.testing.assert_array_equal(got, want)
        elif name.startswith("fold_in"):
            top_n = live.top_n
            want = np.asarray(ref_sv.SparseFoldInPipeline(
                c["rals"], nse_cap=12, top_n=top_n).predict_bucket(
                    rows[:b], b))
            if top_n:
                np.testing.assert_allclose(got[:, top_n:], want[:, top_n:],
                                           rtol=0, atol=1e-4)
                srt = np.sort(want[:, top_n:], axis=1)
                untied = np.all(np.diff(srt, axis=1) > 1e-4, axis=1)
                np.testing.assert_array_equal(got[untied, :top_n],
                                              want[untied, :top_n])
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        else:
            monkeypatch.setenv("DSLIB_OVERLAP", "db")
            want = np.asarray(RefRetrieval(c["ref_ivf"], k=5).predict_bucket(
                rows[:b], b))
            np.testing.assert_array_equal(got[:, :5], want[:, :5])
            scale = float((rows.astype(np.float64) ** 2).sum(1).max()
                          + (c["ix_x"].astype(np.float64) ** 2).sum(1)
                          .max())
            np.testing.assert_allclose(got[:, 5:] ** 2, want[:, 5:] ** 2,
                                       rtol=0, atol=1e-5 * scale)
    with pytest.raises(ValueError, match="ladder"):
        loaded.pipeline.predict_bucket(rows[:2], 512)
    with PredictServer(pipeline=loaded.pipeline, buckets=loaded.buckets,
                       deadline_ms=1) as srv:
        np.testing.assert_array_equal(srv.predict(rows[:5]),
                                      live.predict_bucket(rows[:5], 8))


_CHILD = r"""
import json, sys, tempfile
import numpy as np
from dislib_tpu_torch import _build
_build.BUILD_DIR = tempfile.mkdtemp()

def _refuse():
    raise AssertionError("build_all called in the loading process")

_build.build_all = _refuse
import dislib_tpu_torch as dst
from dislib_tpu_torch.serving import load_bundle
from dislib_tpu_torch.utils import profiling as prof
dst.init(device="cpu")
out = {}
for name, path, rows in json.loads(sys.argv[1]):
    loaded = load_bundle(path)
    rows = np.load(rows)
    out[name] = {str(b): loaded.pipeline.predict_bucket(rows[:b], b).tolist()
                 for b in loaded.buckets}
out["foreign"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "dislib_tpu"))
out["traces"] = prof.counters()["trace_by"]
print(json.dumps(out))
"""


def test_fresh_process_serves_the_bundles_bit_equal(tmp_path):
    jobs, want = [], {}
    for name, live, rows in _pipes():
        path = str(tmp_path / f"{name}.npz")
        export_bundle(live, path, buckets=BUCKETS)
        np.save(str(tmp_path / f"{name}.npy"), rows)
        jobs.append([name, path, str(tmp_path / f"{name}.npy")])
        want[name] = {b: live.predict_bucket(rows[:b], b) for b in BUCKETS}
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(jobs)],
                         capture_output=True, text=True, env=env,
                         cwd=str(tmp_path), timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["foreign"] == []
    assert got["traces"] == {}                  # no build, no capture (CPU)
    for name, per in want.items():
        for b, w in per.items():
            g = np.asarray(got[name][str(b)], np.float32)
            np.testing.assert_array_equal(g, w.astype(np.float32))


# -- compatibility -----------------------------------------------------------

def _state_of_km():
    return {"centers": np.asarray(ctx()["km_pipe"].model.centers_,
                                  np.float32)}


def _build_km(state):
    km = dst.KMeans(n_clusters=3)
    km.centers_ = np.asarray(state["centers"], np.float32)
    return ServePipeline(km, transforms=ctx()["km_pipe"].transforms)


def test_fingerprint_mismatch_is_typed_and_falls_back_loudly(
        tmp_path, monkeypatch):
    path = str(tmp_path / "km.npz")
    export_bundle(ctx()["km_pipe"], path, buckets=(8,),
                  state=_state_of_km())
    bare = str(tmp_path / "bare.npz")
    export_bundle(ctx()["km_pipe"], bare, buckets=(8,))
    real = runtime_fingerprint()
    monkeypatch.setattr(port_bundle, "runtime_fingerprint",
                        lambda: dict(real, torch="0.0.0"))
    with pytest.raises(BundleIncompatible, match="torch") as ei:
        load_bundle(path)
    assert ei.value.expected["torch"] == real["torch"]
    assert ei.value.found["torch"] == "0.0.0"
    with pytest.warns(RuntimeWarning, match="falling back"):
        lb = load_bundle(path, build=_build_km)
    assert lb.fallback and not isinstance(lb.pipeline, BundlePipeline)
    np.testing.assert_array_equal(lb.state["centers"],
                                  _state_of_km()["centers"])
    x = ctx()["x"][:8]
    np.testing.assert_array_equal(lb.pipeline.predict_bucket(x, 8),
                                  ctx()["km_pipe"].predict_bucket(x, 8))
    # no embedded state: nothing to fall back to
    with pytest.raises(BundleIncompatible, match="no model state"):
        load_bundle(bare, build=_build_km)


def test_reference_bundle_is_incompatible_and_rebuilds_from_its_state(
        tmp_path):
    from dislib_tpu.serving import bundle as ref_bundle
    c = ctx()
    path = str(tmp_path / "ref.npz")
    ref_bundle.export_bundle(c["ref_km"], path, buckets=(8,),
                             state=_state_of_km())
    with pytest.raises(BundleIncompatible, match="JAX reference"):
        load_bundle(path)
    with pytest.warns(RuntimeWarning):
        lb = load_bundle(path, build=_build_km)
    assert lb.fallback
    x = c["x"][:8]
    np.testing.assert_array_equal(
        lb.pipeline.predict_bucket(x, 8),
        np.asarray(c["ref_km"].predict_bucket(x, 8)))


def _fake_cuda(monkeypatch, tmp_path):
    """A ``cuda`` fingerprint and stand-in library bytes, so the library
    path runs on the CPU; ``build_all`` refuses."""
    real = runtime_fingerprint()
    monkeypatch.setattr(port_bundle, "runtime_fingerprint",
                        lambda: dict(real, platform="cuda"))
    libs = {}
    for name in _build.SIGNATURES:
        data = f"stand-in {name} library".encode()
        libs[name] = {"key": _build.source_key(name),
                      "sha256": hashlib.sha256(data).hexdigest(),
                      "bytes": data}
    monkeypatch.setattr(_build, "library", lambda name: None)
    monkeypatch.setattr(_build, "loaded_libraries", lambda: libs)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))

    def refuse():
        raise AssertionError("build_all called")

    monkeypatch.setattr(_build, "build_all", refuse)
    return libs


def test_kernel_libraries_install_from_the_bundle_without_a_build(
        tmp_path, monkeypatch):
    libs = _fake_cuda(monkeypatch, tmp_path)
    path = str(tmp_path / "km.npz")
    man = export_bundle(ctx()["km_pipe"], path, buckets=(8,),
                        state=_state_of_km())
    assert sorted(man["libraries"]) == sorted(_build.SIGNATURES)
    lb = load_bundle(path)
    assert not lb.fallback
    for name, lib in libs.items():
        target = _build._target(name, lib["key"])
        with open(target, "rb") as f:
            assert f.read() == lib["bytes"]
    # a library whose bytes fail their SHA-256: typed, never rebuilt
    raw = read_bundle(path)
    meta = json.loads(str(raw["bundle_meta"][()]))
    meta["libraries"]["distances_sq"]["sha256"] = "0" * 64
    raw["bundle_meta"] = np.asarray(json.dumps(meta))
    write_bundle(path, raw)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build2"))
    with pytest.raises(BundleIncompatible, match="SHA-256"):
        load_bundle(path)
    assert not os.path.exists(str(tmp_path / "_build2"))
    with pytest.warns(RuntimeWarning):
        assert load_bundle(path, build=_build_km).fallback


def test_install_library_checks_reuses_and_never_replaces(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    name = "distances_sq"
    key = _build.source_key(name)
    data = b"bytes of a library"
    sha = hashlib.sha256(data).hexdigest()
    with pytest.raises(ValueError, match="SHA-256"):
        _build.install_library(name, key, data + b"!", sha)
    with pytest.raises(ValueError, match="another source"):
        _build.install_library(name, "f" * 64, data, sha)
    with pytest.raises(ValueError, match="no CUDA kernel library"):
        _build.install_library("nope", key, data, sha)
    path = _build.install_library(name, key, data, sha)
    assert path == _build._target(name) and os.listdir(tmp_path) == [
        os.path.basename(path)]
    with open(path, "wb") as f:                 # a file already there
        f.write(b"kept")
    assert _build.install_library(name, key, data, sha) == path
    with open(path, "rb") as f:
        assert f.read() == b"kept"
    monkeypatch.setitem(_build._LIBS, name, object())
    monkeypatch.setitem(_build._LOADED_FROM, name, "/loaded/elsewhere.so")
    assert _build.install_library(name, key, data, sha) == \
        "/loaded/elsewhere.so"
    # the library name is the digest of the source and the flags only
    assert os.path.basename(_build._target(name)) == \
        f"{name}-{key[:16]}.so"


def test_fingerprint_keys(monkeypatch):
    fp = runtime_fingerprint()
    assert (fp["platform"], fp["device_kind"], fp["capability"],
            fp["n_devices"], fp["mesh_shape"], fp["pad_quantum"]) == \
        ("cpu", "cpu", None, 1, [1, 1], 1)
    assert fp["kernels"] == _build.kernels_digest()
    assert set(port_bundle._HARD_KEYS) <= set(fp)
    monkeypatch.setenv("DSLIB_OVERLAP", "kernel")
    assert runtime_fingerprint()["statics"]["overlap"] == "kernel"


# -- sharded bundles and state ---------------------------------------------

def test_sharded_bundle_loads_whole_or_not_at_all(tmp_path, monkeypatch):
    path = str(tmp_path / "km.npz")
    man = export_bundle(ctx()["km_pipe"], path, buckets=(1, 8), hosts=2,
                        state=_state_of_km())
    assert man["hosts"] == 2 and len(man["shard_crcs"]) == 2
    lb = load_bundle(path)
    assert (lb.hosts, lb.host, lb.fallback) == (2, 0, False)
    x = ctx()["x"][:8]
    np.testing.assert_array_equal(lb.pipeline.predict_bucket(x, 8),
                                  ctx()["km_pipe"].predict_bucket(x, 8))
    corrupt_snapshot(shard_path(path, 1), mode="flip")
    prof.reset_counters()
    with pytest.raises(BundleShardCorrupt) as ei:
        load_bundle(path)
    assert ei.value.host == 1 and "CRC" in ei.value.reason
    assert prof.resilience_counters()["bundle_barrier_abort"] == 1
    os.remove(shard_path(path, 1))
    with pytest.raises(BundleShardCorrupt, match="unreadable"):
        load_bundle(path)
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    with pytest.raises(NotImplementedError, match="A.11"):
        load_bundle(path)
    with pytest.raises(NotImplementedError, match="A.11"):
        export_bundle(ctx()["km_pipe"], path, buckets=(8,), hosts=2)


def test_checkpoint_state_is_embedded_through_the_adoption_gate(tmp_path):
    ck = FitCheckpoint(str(tmp_path / "ck.npz"))
    with pytest.raises(ValueError, match="no generation"):
        export_bundle(ctx()["km_pipe"], str(tmp_path / "b.npz"),
                      buckets=(8,), checkpoint=ck)
    ck.save({"centers": np.ones((3, NF), np.float32),
             "n_iter": np.asarray(4)})
    export_bundle(ctx()["km_pipe"], str(tmp_path / "b.npz"), buckets=(8,),
                  checkpoint=ck)
    lb = load_bundle(str(tmp_path / "b.npz"))
    np.testing.assert_array_equal(lb.state["centers"], np.ones((3, NF)))
    assert int(lb.state["n_iter"]) == 4
    with pytest.raises(ValueError, match="at most one"):
        export_bundle(ctx()["km_pipe"], str(tmp_path / "b.npz"),
                      checkpoint=ck, state={})
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert load_bundle(str(tmp_path / "b.npz")).fallback is False
