"""The port across ranks: 4 gloo CPU processes against the reference.

For each mesh shape, (2, 2) and (4, 1), one group of 4 ranks
(``tests/torch_mesh_worker.py``, one ``python`` process each, joined
through a FileStore under ``tmp_path``) runs every scenario on inputs made
from fixed seeds and writes its blocks and collected results; the test
runs the reference in this process on the same mesh shape
(``ds.init(shape, devices=jax.devices()[:4])``, the conftest's 8 virtual
CPU devices, restored afterwards) and holds the ranks to it:

- ``array`` → ``collect`` bit-equal, and each rank's block is the
  reference's shard of the padded array (``P(ROWS, COLS)``);
- an elementwise op between two arrays (``/``, ``**``, ``*``) equal to
  NumPy's, with the pad of every block still zero;
- the reductions within 1e-6 of the reference's (a gloo sum adds the
  ranks' partials in its own order);
- ``matmul(algorithm="summa")`` under both policies against the
  reference's SUMMA under ``overlap="db"`` within ``ERROR_BOUNDS`` (its
  Pallas route fails inside ``shard_map``, ROADMAP.md C.1), and two runs
  on one mesh bit-equal;
- KMeans: centers within 1e-5, labels equal, inertia within 1e-5;
- the ring kNN (and the gathered path) indices equal to the reference's
  on tie-free data, distances within 1e-5;
- ``shuffle``/``train_test_split`` bit-equal to the NumPy permutation;
- every estimator not yet ported to the mesh raises NotImplementedError.

A rank that hangs fails the test in seconds: the job's collectives time
out after 60 s at most and the test kills its ranks at :data:`WAIT_S`.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import dislib_tpu as ds
from dislib_tpu.cluster import KMeans as RefKMeans
from dislib_tpu.neighbors import NearestNeighbors as RefNN

from dislib_tpu_torch.ops.precision import ERROR_BOUNDS

import torch_mesh_worker as W

WAIT_S = 90
WORLD = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_ranks(tmp, rows, cols):
    """Run the 4 ranks to their end; returns each rank's npz as a dict."""
    store = os.path.join(tmp, "store")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_mesh_worker.py"),
         str(r), str(WORLD), store, tmp, str(rows), str(cols)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WAIT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
    return [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
            for r in range(WORLD)]


def _reference(rows, cols, inp):
    """The reference's results on a (rows, cols) mesh of 4 CPU devices."""
    ref = {}
    ds.init((rows, cols), devices=jax.devices()[:WORLD])
    try:
        x = ds.array(inp["x"])
        ref["x_padded"] = np.asarray(x._data)
        for kind in ("sum", "mean", "min", "max", "norm"):
            for axis in (0, 1, None):
                ref[f"{kind}_{axis}"] = getattr(x, kind)(axis=axis).collect()
        a, b = ds.array(inp["a"]), ds.array(inp["b"])
        for pol in ("float32", "bfloat16"):
            ref[f"summa_{pol}"] = np.asarray(ds.matmul(
                a, b, algorithm="summa", precision=pol).collect())
        km_x = ds.array(inp["km"])
        km = RefKMeans(n_clusters=W.KM_K, random_state=0, max_iter=20,
                       tol=1e-4).fit(km_x)
        ref["km_centers"] = km.centers_
        ref["km_labels"] = km.predict(km_x).collect()
        ref["km_inertia"] = km.inertia_
        ref["km_n_iter"] = km.n_iter_
        d, i = RefNN(n_neighbors=W.NN_K, ring=True).fit(
            ds.array(inp["fit"])).kneighbors(ds.array(inp["q"]))
        ref["knn_idx"], ref["knn_dist"] = i.collect(), d.collect()
    finally:
        ds.init()
    return ref


@pytest.fixture(scope="module", params=[(2, 2), (4, 1)],
                ids=["mesh2x2", "mesh4x1"])
def job(request, tmp_path_factory):
    rows, cols = request.param
    inp = W.inputs()
    ranks = _run_ranks(str(tmp_path_factory.mktemp(f"ranks{rows}x{cols}")),
                       rows, cols)
    os.environ["DSLIB_OVERLAP"] = "db"
    try:
        ref = _reference(rows, cols, inp)
    finally:
        del os.environ["DSLIB_OVERLAP"]
    metas = [json.loads(r["meta"].tobytes()) for r in ranks]
    return {"rows": rows, "cols": cols, "inp": inp, "ranks": ranks,
            "ref": ref, "metas": metas}


def _same_on_every_rank(job, key):
    first = job["ranks"][0][key]
    for r in job["ranks"][1:]:
        np.testing.assert_array_equal(r[key], first)
    return first


def test_ranks_sit_on_the_row_major_grid(job):
    coords = [tuple(m["coord"]) for m in job["metas"]]
    assert coords == [divmod(r, job["cols"]) for r in range(WORLD)]


def test_collect_round_trip_and_blocks_are_the_reference_placement(job):
    np.testing.assert_array_equal(_same_on_every_rank(job, "x"),
                                  job["inp"]["x"])
    padded = job["ref"]["x_padded"]
    ml, nl = padded.shape[0] // job["rows"], padded.shape[1] // job["cols"]
    for rank, got in enumerate(job["ranks"]):
        r, c = divmod(rank, job["cols"])
        np.testing.assert_array_equal(
            got["x_block"], padded[r * ml:(r + 1) * ml, c * nl:(c + 1) * nl])
    np.testing.assert_array_equal(_same_on_every_rank(job, "x_plus"),
                                  job["inp"]["x"] * 2.0 + job["inp"]["x"]
                                  - 1.0)
    np.testing.assert_array_equal(_same_on_every_rank(job, "rows"),
                                  job["inp"]["x"][[5, 200, 0, 77]])


@pytest.mark.parametrize("op", ["div", "pow", "mul"])
def test_elementwise_between_arrays_keeps_a_zero_pad(job, op):
    x = job["inp"]["x"]
    want = {"div": x / x, "pow": x ** x, "mul": x * x}[op]
    np.testing.assert_allclose(_same_on_every_rank(job, f"x_{op}"), want,
                               rtol=1e-6, atol=0)
    padded = np.zeros_like(job["ref"]["x_padded"])
    padded[:x.shape[0], :x.shape[1]] = 1.0
    ml, nl = padded.shape[0] // job["rows"], padded.shape[1] // job["cols"]
    for rank, got in enumerate(job["ranks"]):
        r, c = divmod(rank, job["cols"])
        block = got[f"x_{op}_block"]
        inside = padded[r * ml:(r + 1) * ml, c * nl:(c + 1) * nl] == 1.0
        assert block.shape == inside.shape
        np.testing.assert_array_equal(block[~inside], 0.0)
        assert np.isfinite(block).all()


@pytest.mark.parametrize("kind", ["sum", "mean", "min", "max", "norm"])
def test_reductions_match_the_reference(job, kind):
    for axis in (0, 1, None):
        got = _same_on_every_rank(job, f"{kind}_{axis}")
        np.testing.assert_allclose(got, job["ref"][f"{kind}_{axis}"],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pol", ["float32", "bfloat16"])
def test_summa_matches_the_reference_within_error_bounds(job, pol):
    a, b = job["inp"]["a"], job["inp"]["b"]
    scale = np.linalg.norm(a) * np.linalg.norm(b) / np.sqrt(a.shape[1])
    got = _same_on_every_rank(job, f"summa_{pol}")
    err = np.abs(got.astype(np.float64) - job["ref"][f"summa_{pol}"]).max()
    assert err / scale <= ERROR_BOUNDS[("matmul", pol)]
    err64 = np.abs(got.astype(np.float64)
                   - a.astype(np.float64) @ b.astype(np.float64)).max()
    assert err64 / scale <= ERROR_BOUNDS[("matmul", pol)]
    # two runs on one mesh are bit-equal
    np.testing.assert_array_equal(got, _same_on_every_rank(
        job, f"summa_{pol}_again"))
    if pol == "float32":
        # the gathered route: each rank's rows of A times its columns of B
        err = np.abs(_same_on_every_rank(job, "xla_float32").astype(
            np.float64) - a.astype(np.float64) @ b.astype(np.float64)).max()
        assert err / scale <= ERROR_BOUNDS[("matmul", pol)]


def test_kmeans_matches_the_reference(job):
    ref = job["ref"]
    np.testing.assert_allclose(_same_on_every_rank(job, "km_centers"),
                               ref["km_centers"], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_same_on_every_rank(job, "km_labels"),
                                  ref["km_labels"])
    assert int(_same_on_every_rank(job, "km_n_iter")) == ref["km_n_iter"]
    np.testing.assert_allclose(float(_same_on_every_rank(job, "km_inertia")),
                               ref["km_inertia"], rtol=1e-5)
    np.testing.assert_allclose(float(_same_on_every_rank(job, "km_score")),
                               -ref["km_inertia"], rtol=1e-5)
    # one mesh, one seed: the same centers, bit for bit
    np.testing.assert_array_equal(
        _same_on_every_rank(job, "km_centers"),
        _same_on_every_rank(job, "km_centers_again"))


@pytest.mark.parametrize("ring", [True, False])
def test_knn_matches_the_reference_ring(job, ring):
    ref = job["ref"]
    np.testing.assert_array_equal(
        _same_on_every_rank(job, f"knn_{ring}_idx"), ref["knn_idx"])
    np.testing.assert_allclose(_same_on_every_rank(job, f"knn_{ring}_dist"),
                               ref["knn_dist"], rtol=1e-5, atol=1e-5)


def test_shuffle_and_split_are_the_numpy_permutation(job):
    x, y = job["inp"]["x"], job["inp"]["y"]
    perm = np.random.RandomState(3).permutation(x.shape[0])
    np.testing.assert_array_equal(_same_on_every_rank(job, "shuffle_x"),
                                  x[perm])
    np.testing.assert_array_equal(_same_on_every_rank(job, "shuffle_y"),
                                  y[perm])
    perm = np.random.RandomState(4).permutation(x.shape[0])
    n_test = int(round(x.shape[0] * 0.25))
    n_train = x.shape[0] - n_test
    np.testing.assert_array_equal(_same_on_every_rank(job, "split_train"),
                                  x[perm[:n_train]])
    np.testing.assert_array_equal(_same_on_every_rank(job, "split_test"),
                                  x[perm[n_train:]])
    np.testing.assert_array_equal(_same_on_every_rank(job, "split_ytest"),
                                  y[perm[n_train:]])


def test_random_array_is_the_one_rank_draw(job):
    import dislib_tpu_torch as dst
    want = dst.random_array((37, 11), random_state=5, device="cpu").collect()
    np.testing.assert_array_equal(_same_on_every_rank(job, "random"), want)


def test_unported_estimators_raise_on_every_rank(job):
    for meta in job["metas"]:
        assert meta["missed"] == []
    comm = job["metas"][0]["comm"]
    for name in ("psum", "broadcast", "all_gather", "all_to_all"):
        assert comm[name]["calls"] > 0, name
    # the ring hops only on a mesh of more than one row
    assert comm["ppermute"]["calls"] > 0
