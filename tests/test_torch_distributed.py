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
- ``eye``/``identity`` equal to ``np.eye``, every block's pad zero;
- each binary op of a full array with a (1, n), an (m, 1) and a (1, 1)
  operand, in either order, equal to the same op on the host (NumPy's,
  torch's for ``**``), the pad of every block still zero;
- ``StandardScaler``/``MinMaxScaler`` within 1e-5 of the reference's;
- ``tsqr`` (the tree, CholeskyQR2, and blocks shorter than n) within
  ``ERROR_BOUNDS`` of orthogonality and residual, Q and R against the
  reference's after sign normalisation; CholeskyQR2 refused on one rank
  makes every rank take the tree, bit-equal to the tree route;
- ``random_svd`` (fused and composed, the reference's test matrix handed
  to ``_omega_of``) and PCA: values and explained variance within 1e-4,
  U, V and the components within 1e-4 up to sign;
- GaussianMixture (full and diag, the ``kmeans`` init) within rtol/atol
  1e-4 of the reference's, ``n_iter_`` equal; the ``random`` init equal
  to the port's one-rank fit from the same draw; a health trip on one
  rank raises on every rank;
- ``LinearRegression`` (two targets): coefficients, intercepts and R²
  within 1e-5 of the reference's, relative to the largest;
  ``Lasso``: ``coef_`` within 1e-5 of the reference's, ``n_iter_`` equal
  to the port's one-rank fit with the same agents (a stop before
  ``max_iter``);
- ``MiniBatchKMeans``: centers within 1e-5 of one rank's after the same
  batches, counts equal; a health trip on one rank raises on every rank;
- ``polar``: U and H within ``ERROR_BOUNDS`` of one rank's, the same
  iteration count; ``lanczos_svd`` and ``svd`` (both tiers): values
  within 1e-5 of the largest (one rank's, and a float64 NumPy oracle's),
  vectors within 1e-4 up to sign where the values stand apart;
- ``qr``: R within 1e-5 (of its largest entry) of NumPy's up to row
  signs, orthogonality and residual within ``ERROR_BOUNDS``, the full Q
  held by orthogonality and QᵀA = R (its complement is the port's own
  draw);
- ``kron``, ``concat_rows``/``concat_cols``, ``apply_along_axis`` and
  ``iterator`` bit-equal to NumPy, every block's pad zero;
- ``KNeighborsClassifier`` (the gathered route and the ring) predicting
  the reference's labels; both searches' scores within 1e-5 of one
  rank's (relative), the same ``best_params_`` and host reads;
  GaussianMixture's async-trial hooks: the score the sharded fit's, the
  model the reference's diagonal fit (rtol/atol 1e-4, ``n_iter_`` equal);
- the quantile edges (a tie column, zeros of both signs, a NaN column)
  bit-equal to one rank's ``_quantile_bins``, NaN edges for the NaN
  column and every zero edge a +0.0;
- ``DecisionTreeClassifier``: edges, splits, leaves and predictions
  bit-equal to the reference's; ``DecisionTreeRegressor``: the splits
  equal, leaves within 1e-5 of the largest and predictions within 1e-5;
- a bootstrap ``RandomForestClassifier`` (``try_features="sqrt"``)
  bit-equal to the port's one-rank forest of the same ``random_state``,
  its ``predict_proba``, score, search hooks and a ``GridSearchCV`` over
  it equal to one rank's;
- a reference forest and CascadeSVM carried in (written by this test to
  ``carry.npz`` while the ranks run) predicting the reference's
  predictions on the sharded queries;
- DBSCAN and Daura equal to the reference's ring tier (``_RING = True``)
  and to the port's one-rank fit, on data with no pair within 1e-3
  (d²) of the threshold; the non-ring tiers raise across ranks; a NaN in
  one mesh row's data raises on every rank;
- dense ``CascadeSVM`` (rbf and linear, block rows 64): SV indices and
  ``n_iter_`` equal to one rank's, α within ``ALPHA_TOL`` and the
  decision values within ``DEC_TOL`` (``tests/test_torch_csvm.py``'s);
- the sparse ds-array (A.2c): ``collect`` bit-equal to the scipy input,
  each rank's ``ShardedSparse`` shard and ``panel_view`` the reference's
  shard bit for bit, ``to_dense``, ``sum``/``mean`` and the sparse
  scaler's moments within 1e-6 of the reference's, row indexing and
  ``shuffle`` the NumPy rows, the densify route into
  ``LinearRegression``;
- SpMM at 2 and 4 panels: two runs, ``db``/``seq`` bit-equal, both
  layouts within 1e-5 of the reference's largest entry, and B's columns
  folded in slices bit-equal to one slice;
- sparse KMeans and the sparse kNN (sparse and dense queries) against the
  reference; dense ALS against the reference (its threefry V₀ handed to
  ``_draw_items``) and sparse ALS against C.2's substitute oracle (the
  port's dense fit of the densified ratings and its one-rank sparse fit);
- the IVF index from the reference's labels and centers: ``pad_waste``,
  each rank's stripe, the searches under ``db``/``seq``/``kernel``, a
  carried index and the ranks' own fit searched exactly;
- sparse CascadeSVM (ELL and host-CSR staging) against the reference's
  sparse cascade on the same mesh and against one rank;
- every estimator not yet ported to the mesh raises NotImplementedError,
  and the checkpointed fits of the ones ported here name A.11.

A rank that hangs fails the test in seconds: the job's collectives time
out after 60 s at most and the test kills its ranks at :data:`WAIT_S`.
"""

import importlib
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import dislib_tpu as ds
from dislib_tpu.cluster import GaussianMixture as RefGM
from dislib_tpu.classification import KNeighborsClassifier as RefKNC
from dislib_tpu.cluster import KMeans as RefKMeans
from dislib_tpu.neighbors import NearestNeighbors as RefNN
from dislib_tpu.preprocessing import MinMaxScaler, StandardScaler
from dislib_tpu.regression import Lasso as RefLasso
from dislib_tpu.regression import LinearRegression as RefLR
from dislib_tpu.classification import CascadeSVM as RefCSVM
from dislib_tpu.cluster import DBSCAN as RefDBSCAN
from dislib_tpu.cluster import Daura as RefDaura
from dislib_tpu.trees import DecisionTreeClassifier as RefDTC
from dislib_tpu.trees import DecisionTreeRegressor as RefDTR
from dislib_tpu.trees import RandomForestClassifier as RefRFC
from dislib_tpu.recommendation import ALS as RefALS
from dislib_tpu.retrieval import IVFIndex as RefIVF
from dislib_tpu.ops.spmm import spmm as ref_spmm

from dislib_tpu_torch.ops.precision import ERROR_BOUNDS

import torch_mesh_worker as W

WAIT_S = 90
WORLD = 4
# the reference forest the ranks carry in
CARRY_RF = dict(n_estimators=3, max_depth=3, random_state=0,
                n_bins=W.TREE_BINS)
ALPHA_TOL, DEC_TOL = 1e-4, 1e-4       # tests/test_torch_csvm.py's
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _start_ranks(tmp, rows, cols):
    """Start the 4 ranks; returns their processes.  random_svd's test
    matrix is the reference's draw (JAX's stream is not reproducible in
    torch), handed to the ranks in ``omega.npz``."""
    np.savez(os.path.join(tmp, "omega.npz"), **{
        f"{W.SV_SEED}_{W.SV_SHAPE[1]}_{W.SV_SKETCH}": np.array(
            jax.random.normal(jax.random.PRNGKey(W.SV_SEED),
                              (W.SV_SHAPE[1], W.SV_SKETCH), np.float32))})
    # the reference's dense ALS draws V₀ at its padded item count
    q = int(np.lcm(rows, cols))
    n_pad = max(q, -(-W.ALS_SHAPE[1] // q) * q)
    _, kv = jax.random.split(jax.random.PRNGKey(W.ALS_KW["random_state"]))
    np.save(os.path.join(tmp, "als_v0.npy"), np.array(jax.random.uniform(
        kv, (n_pad, W.ALS_F), np.float32)))
    store = os.path.join(tmp, "store")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_mesh_worker.py"),
         str(r), str(WORLD), store, tmp, str(rows), str(cols)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]


def _wait_ranks(tmp, procs):
    """Wait for the ranks to their end (killed at :data:`WAIT_S`); returns
    each rank's npz as a dict."""
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


def _reference(rows, cols, inp, tmp):
    """The reference's results on a (rows, cols) mesh of 4 CPU devices;
    first the models the ranks carry in (``tmp/carry.npz``)."""
    ref = {}
    ds.init((rows, cols), devices=jax.devices()[:WORLD])
    try:
        _reference_carry(ref, inp, tmp)
        _reference_a2c(ref, inp, tmp)
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
        _reference_a2b(ref, inp)
        _reference_a2b2(ref, inp)
        _reference_a2b3(ref, inp)
    finally:
        ds.init()
    return ref


def _reference_a2b(ref, inp):
    """The reference's results of A.2b's first part on the current mesh."""
    x = ds.array(inp["x"])
    for cls in (StandardScaler, MinMaxScaler):
        ref[f"{cls.__name__}_t"] = np.asarray(cls().fit_transform(x).collect())
    for name in ("x", "short"):
        q, r = ds.tsqr(ds.array(inp[name]))
        ref[f"tsqr_{name}_q"], ref[f"tsqr_{name}_r"] = (
            np.asarray(q.collect()), np.asarray(r.collect()))
    u, s, v = ds.random_svd(ds.array(inp["sv"]), nsv=W.SV_NSV,
                            random_state=W.SV_SEED)
    ref["rsvd_u"], ref["rsvd_s"], ref["rsvd_v"] = (
        np.asarray(u.collect()), np.asarray(s.collect()),
        np.asarray(v.collect()))
    pca = ds.PCA(n_components=4).fit(x)
    ref["pca_var"] = np.asarray(pca.explained_variance_.collect())
    ref["pca_comp"] = np.asarray(pca.components_.collect())
    ref["pca_mean"] = np.asarray(pca.mean_.collect())
    ref["pca_t"] = np.asarray(pca.transform(x).collect())
    g = ds.array(inp["gm"])
    for cov in ("full", "diag"):
        est = RefGM(covariance_type=cov, **W.GM_KW).fit(g)
        for attr in ("weights_", "means_", "covariances_", "history_"):
            ref[f"gm_{cov}_{attr}"] = getattr(est, attr)
        ref[f"gm_{cov}_lb"] = est.lower_bound_
        ref[f"gm_{cov}_n_iter"] = est.n_iter_
        ref[f"gm_{cov}_labels"] = np.asarray(est.predict(g).collect())
        ref[f"gm_{cov}_score"] = est.score(g)


def _reference_a2b2(ref, inp):
    """The reference's linear models and kNN classifier on the current
    mesh."""
    x, y = ds.array(inp["x"]), ds.array(inp["y"])
    lr = RefLR().fit(x, y)
    ref["lr_coef"], ref["lr_intercept"] = lr.coef_, lr.intercept_
    ref["lr_score"] = lr.score(x, y)
    la = RefLasso(**W.LASSO_KW).fit(x, ds.array(inp["y"][:, :1]))
    ref["lasso_coef"], ref["lasso_n_iter"] = la.coef_, la.n_iter_
    knn = RefKNC(n_neighbors=5).fit(ds.array(inp["fit"]),
                                    ds.array(inp["fit_y"]))
    ref["knn_pred"] = np.asarray(knn.predict(ds.array(inp["q"])).collect())


def _reference_carry(ref, inp, tmp):
    """A reference forest and CascadeSVM fitted on the current mesh, their
    arrays written to ``tmp/carry.npz`` (in one rename: the ranks wait
    for it), and their predictions on the queries."""
    x = ds.array(inp["tree_x"])
    rf = RefRFC(**CARRY_RF).fit(x, ds.array(inp["tree_yc"]))
    sv = RefCSVM().fit(ds.array(inp["csvm_x"], block_size=(
        W.CSVM_BLOCK, W.CSVM_SHAPE[1])), ds.array(inp["csvm_y"]))
    arrays = {f"rf_{k}": np.asarray(getattr(rf, k)) for k in (
        "_edges", "_feats", "_tbins", "_depth", "_leaves", "n_features_",
        "classes_")}
    arrays.update({f"sv_{k}": np.asarray(getattr(sv, k)) for k in (
        "_sv_x", "_sv_y", "_sv_alpha", "_sv_idx", "_gamma_fit",
        "classes_")})
    part = os.path.join(tmp, "carry_part.npz")
    np.savez(part, **arrays)
    os.replace(part, os.path.join(tmp, "carry.npz"))
    ref["carried_rf_pred"] = np.asarray(rf.predict(x).collect())
    ref["carried_rf_proba"] = np.asarray(rf.predict_proba(x).collect())
    q = ds.array(inp["csvm_q"])
    ref["carried_sv_dec"] = np.asarray(sv.decision_function(q).collect())
    ref["carried_sv_pred"] = np.asarray(sv.predict(q).collect())


def _reference_a2b3(ref, inp):
    """The reference's trees, and its DBSCAN and Daura ring tier, on the
    current mesh."""
    x = ds.array(inp["tree_x"])
    for name, cls, ykey, kw in (("dtc", RefDTC, "tree_yc", W.DTC_KW),
                                ("dtr", RefDTR, "tree_yr", W.DTR_KW)):
        est = cls(n_bins=W.TREE_BINS, **kw).fit(x, ds.array(inp[ykey]))
        for attr in ("_edges", "_feats", "_tbins", "_leaves"):
            ref[f"{name}{attr}"] = np.asarray(getattr(est, attr))
        ref[f"{name}_pred"] = np.asarray(est.predict(x).collect())
    dbscan = importlib.import_module("dislib_tpu.cluster.dbscan")
    daura = importlib.import_module("dislib_tpu.cluster.daura")
    saved = dbscan._RING, daura._RING
    dbscan._RING = daura._RING = True
    try:
        est = RefDBSCAN(eps=W.DB_EPS, min_samples=W.DB_MIN).fit(
            ds.array(inp["db"]))
        ref["db_labels"] = est.labels_
        ref["db_core"] = est.core_sample_indices_
        est = RefDaura(cutoff=W.DA_CUT).fit(ds.array(inp["da"]))
        ref["da_labels"] = est.labels_
        ref["da_clusters"] = np.concatenate([np.r_[len(c), c]
                                             for c in est.clusters_])
    finally:
        dbscan._RING, daura._RING = saved


def _reference_a2c(ref, inp, tmp):
    """The reference's A.2c on the current mesh: first the IVF index, whose
    labels and centers go to ``tmp/ivf.npz`` (one rename: the ranks wait
    for it), then the sparse ds-array, SpMM, sparse KMeans, the sparse kNN,
    dense ALS and sparse CascadeSVM."""
    ix = RefIVF(n_lists=W.IVF_LISTS, nprobe=W.IVF_PROBE,
                random_state=0).fit(ds.array(inp["ivf"]))
    part = os.path.join(tmp, "ivf_part.npz")
    np.savez(part, labels=ix._labels_h, centers=ix._centers_h)
    os.replace(part, os.path.join(tmp, "ivf.npz"))
    ref["ivf_pad_waste"] = ix.pad_waste
    for name in ("_vecs", "_ids", "_vsq", "_offs", "_cnts"):
        ref[f"ivf{name}"] = np.asarray(getattr(ix, name))
    q = ds.array(inp["ivf_q"])
    for nprobe in (W.IVF_PROBE, W.IVF_LISTS):
        dist, idx = ix.search(q, k=W.IVF_K, nprobe=nprobe, overlap="db")
        ref[f"ivf_{nprobe}_dist"] = np.asarray(dist.collect())
        ref[f"ivf_{nprobe}_idx"] = np.asarray(idx.collect())
    x = ds.SparseArray.from_scipy(W.sparse_of(inp["sp_x"]))
    rep = x.sharded()
    for name in ("data", "lrows", "cols", "counts_dev"):
        ref[f"sh_{name}"] = np.asarray(getattr(rep, name))
    pv = rep.panel_view(2, 20)
    for name in ("data", "lrows", "cols", "counts_dev"):
        ref[f"pv_{name}"] = np.asarray(getattr(pv, name))
    ref["sp_dense"] = np.asarray(x.to_dense().collect())
    for axis in (0, 1, None):
        ref[f"sp_sum_{axis}"] = np.asarray(x.sum(axis).collect())
        ref[f"sp_mean_{axis}"] = np.asarray(x.mean(axis).collect())
    sc = StandardScaler(with_mean=False).fit(x)
    ref["sp_sc_mean"] = np.asarray(sc.mean_.collect())
    ref["sp_sc_var"] = np.asarray(sc.var_.collect())
    b = ds.array(inp["sp_b"])
    for panels in W.SP_PANELS:
        ref[f"spmm_{panels}"] = np.asarray(ref_spmm(x, b, panels=panels)
                                           .collect())
    kx = ds.SparseArray.from_scipy(W.sparse_of(inp["skm"]))
    km = RefKMeans(n_clusters=W.SKM_K, random_state=0, max_iter=20,
                   tol=1e-4).fit(kx)
    ref["skm_centers"], ref["skm_inertia"] = km.centers_, km.inertia_
    ref["skm_labels"] = np.asarray(km.predict(kx).collect())
    f = ds.SparseArray.from_scipy(W.sparse_of(inp["fit"]
                                              * (inp["fit"] > 0.3)))
    qd = inp["q"] * (inp["q"] > 0.3)
    for name, qq in (("sparse", ds.SparseArray.from_scipy(W.sparse_of(qd))),
                     ("dense", ds.array(qd))):
        dist, idx = RefNN(n_neighbors=W.NN_K).fit(f).kneighbors(qq)
        ref[f"sknn_{name}_dist"] = np.asarray(dist.collect())
        ref[f"sknn_{name}_idx"] = np.asarray(idx.collect())
    als = RefALS(**W.ALS_KW).fit(ds.array(inp["als"]))
    ref["als_users"], ref["als_items"] = als.users_, als.items_
    ref["als_history"], ref["als_n_iter"] = als.history_, als.n_iter_
    sx = ds.SparseArray.from_scipy(W.sparse_of(inp["ssv"]), block_size=(
        W.SSV_BLOCK, W.SSV_SHAPE[1]))
    sv = RefCSVM(max_iter=W.CSVM_ITERS).fit(sx, ds.array(inp["ssv_y"]))
    ref["ssv_idx"], ref["ssv_alpha"] = (np.asarray(sv._sv_idx),
                                        np.asarray(sv._sv_alpha))
    ref["ssv_n_iter"] = sv.n_iter_
    ref["ssv_dec"] = np.asarray(sv.decision_function(sx).collect())


@pytest.fixture(scope="module", params=[(2, 2), (4, 1)],
                ids=["mesh2x2", "mesh4x1"])
def job(request, tmp_path_factory):
    rows, cols = request.param
    inp = W.inputs()
    tmp = str(tmp_path_factory.mktemp(f"ranks{rows}x{cols}"))
    procs = _start_ranks(tmp, rows, cols)
    # the reference runs while the ranks do
    os.environ["DSLIB_OVERLAP"] = "db"
    try:
        ref = _reference(rows, cols, inp, tmp)
    finally:
        del os.environ["DSLIB_OVERLAP"]
        ranks = _wait_ranks(tmp, procs)
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


# -- A.2b's first part ------------------------------------------------------------

def _blocks_hold_a_zero_pad(job, key, shape):
    """Every rank's block of ``key`` has the block shape of a ds-array of
    logical ``shape`` on the job's mesh, is finite, and is zero outside
    the logical region."""
    q = np.lcm(job["rows"], job["cols"])
    pm, pn = (max(q, -(-d // q) * q) for d in shape)
    ml, nl = pm // job["rows"], pn // job["cols"]
    for rank, got in enumerate(job["ranks"]):
        r, c = divmod(rank, job["cols"])
        block = got[key]
        assert block.shape == (ml, nl), key
        assert np.isfinite(block).all(), key
        rows = np.arange(r * ml, (r + 1) * ml)[:, None] < shape[0]
        cols = np.arange(c * nl, (c + 1) * nl)[None, :] < shape[1]
        np.testing.assert_array_equal(block[~(rows & cols)], 0, err_msg=key)


def test_eye_and_identity_are_numpy_eye_on_every_rank(job):
    for name, want in (("eye57", np.eye(5, 7)), ("eye5", np.eye(5)),
                       ("identity5", np.eye(5))):
        np.testing.assert_array_equal(_same_on_every_rank(job, name), want)
        _blocks_hold_a_zero_pad(job, f"{name}_block", want.shape)


@pytest.mark.parametrize("vec", ["row", "col", "one"])
def test_broadcast_ops_against_a_vector_keep_a_zero_pad(job, vec):
    import torch
    x = job["inp"]["x"]
    v = _same_on_every_rank(job, f"bc_{vec}")
    assert v.shape == {"row": (1, x.shape[1]), "col": (x.shape[0], 1),
                       "one": (1, 1)}[vec]
    np.testing.assert_allclose(v, {"row": x.mean(0, keepdims=True),
                                   "col": x.sum(1, keepdims=True),
                                   "one": x.max(keepdims=True)}[vec],
                               rtol=1e-6)
    ops = {"add": np.add, "sub": np.subtract, "mul": np.multiply,
           "div": np.divide,
           # torch's pow, as one rank computes it (NumPy's powf differs
           # from it in the last place)
           "pow": lambda a, b: (torch.from_numpy(np.ascontiguousarray(a))
                                ** torch.from_numpy(
                                    np.ascontiguousarray(b))).numpy()}
    for op, f in ops.items():
        for order, want in (("xv", f(x, v)), ("vx", f(v, x))):
            key = f"bc_{vec}_{op}_{order}"
            np.testing.assert_array_equal(_same_on_every_rank(job, key),
                                          want, err_msg=key)
            _blocks_hold_a_zero_pad(job, f"{key}_block", x.shape)


@pytest.mark.parametrize("cls", ["StandardScaler", "MinMaxScaler"])
def test_scalers_match_the_reference(job, cls):
    got = _same_on_every_rank(job, f"{cls}_t")
    np.testing.assert_allclose(got, job["ref"][f"{cls}_t"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_same_on_every_rank(job, f"{cls}_back"),
                               job["inp"]["x"], rtol=1e-5, atol=1e-5)
    _blocks_hold_a_zero_pad(job, f"{cls}_block", job["inp"]["x"].shape)


def _signed_qr(q, r):
    d = np.where(np.diag(r) < 0, -1.0, 1.0)
    return q * d, r * d[:, None]


@pytest.mark.parametrize("case", ["x", "short", "chol", "forced"])
def test_tsqr_matches_the_reference(job, case):
    a = job["inp"]["short" if case == "short" else "x"]
    q = _same_on_every_rank(job, f"tsqr_{case}_q").astype(np.float64)
    r = _same_on_every_rank(job, f"tsqr_{case}_r").astype(np.float64)
    assert q.shape == a.shape and r.shape == (a.shape[1],) * 2
    orth = np.abs(q.T @ q - np.eye(a.shape[1])).max()
    assert orth <= ERROR_BOUNDS[("tsqr_orth", "float32")]
    assert np.linalg.norm(q @ r - a) / np.linalg.norm(a) <= \
        ERROR_BOUNDS[("tsqr_resid", "float32")]
    ref = "short" if case == "short" else "x"
    (qp, rp), (qr_, rr) = _signed_qr(q, r), _signed_qr(
        job["ref"][f"tsqr_{ref}_q"], job["ref"][f"tsqr_{ref}_r"])
    assert np.abs(qp - qr_).max() <= ERROR_BOUNDS[("tsqr_orth", "float32")]
    assert np.abs(rp - rr).max() / np.abs(rr).max() <= 1e-5
    if case == "x":
        _blocks_hold_a_zero_pad(job, "tsqr_x_q_block", a.shape)
    if case == "short":
        _blocks_hold_a_zero_pad(job, "tsqr_short_q_block", a.shape)
    if case == "forced":
        # CholeskyQR2 refused on rank 1 alone: every rank took the tree
        # for its block and for the R stack, so the factors are the tree
        # route's, bit for bit
        for got in job["ranks"]:
            assert int(got["tsqr_forced_trees"]) == 2
        np.testing.assert_array_equal(q, _same_on_every_rank(
            job, "tsqr_x_q").astype(np.float64))
        np.testing.assert_array_equal(r, _same_on_every_rank(
            job, "tsqr_x_r").astype(np.float64))


def _col_signs(u):
    idx = np.abs(u).argmax(0)
    return np.where(u[idx, np.arange(u.shape[1])] < 0, -1.0, 1.0)


@pytest.mark.parametrize("path", ["fused", "composed"])
def test_random_svd_matches_the_reference(job, path):
    ref = job["ref"]
    s = _same_on_every_rank(job, f"rsvd_{path}_s").ravel()
    s_ref = ref["rsvd_s"].ravel()
    assert np.abs(s - s_ref).max() / s_ref[0] <= 1e-4
    u = _same_on_every_rank(job, f"rsvd_{path}_u")
    v = _same_on_every_rank(job, f"rsvd_{path}_v")
    assert u.shape == (W.SV_SHAPE[0], W.SV_NSV)
    assert v.shape == (W.SV_SHAPE[1], W.SV_NSV)
    sg, sg_ref = _col_signs(u), _col_signs(ref["rsvd_u"])
    assert np.abs(u * sg - ref["rsvd_u"] * sg_ref).max() <= 1e-4
    assert np.abs(v * sg - ref["rsvd_v"] * sg_ref).max() <= 1e-4
    _blocks_hold_a_zero_pad(job, f"rsvd_{path}_u_block", u.shape)


def test_pca_matches_the_reference(job):
    ref, x = job["ref"], job["inp"]["x"]
    var = _same_on_every_rank(job, "pca_var")
    np.testing.assert_allclose(var, ref["pca_var"], rtol=1e-4)
    np.testing.assert_allclose(_same_on_every_rank(job, "pca_mean"),
                               ref["pca_mean"], rtol=1e-6)
    comp = _same_on_every_rank(job, "pca_comp")
    sg, sg_ref = _col_signs(comp.T), _col_signs(ref["pca_comp"].T)
    assert np.abs(comp.T * sg - ref["pca_comp"].T * sg_ref).max() <= 1e-4
    t = _same_on_every_rank(job, "pca_t")
    assert np.abs(t * sg - ref["pca_t"] * sg_ref).max() <= \
        1e-4 * np.abs(ref["pca_t"]).max()
    _blocks_hold_a_zero_pad(job, "pca_t_block", t.shape)
    np.testing.assert_allclose(_same_on_every_rank(job, "pca_back"),
                               (t @ comp) + ref["pca_mean"], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("cov", ["full", "diag"])
def test_gm_matches_the_reference(job, cov):
    ref = job["ref"]
    assert int(_same_on_every_rank(job, f"gm_{cov}_n_iter")) == \
        ref[f"gm_{cov}_n_iter"]
    for attr in ("weights_", "means_", "covariances_", "history_"):
        np.testing.assert_allclose(
            _same_on_every_rank(job, f"gm_{cov}_{attr}"),
            ref[f"gm_{cov}_{attr}"], rtol=1e-4, atol=1e-4, err_msg=attr)
    np.testing.assert_allclose(float(_same_on_every_rank(
        job, f"gm_{cov}_lb")), ref[f"gm_{cov}_lb"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(_same_on_every_rank(
        job, f"gm_{cov}_score")), ref[f"gm_{cov}_score"], rtol=1e-5,
        atol=1e-5)
    np.testing.assert_array_equal(_same_on_every_rank(
        job, f"gm_{cov}_labels"), ref[f"gm_{cov}_labels"])
    _blocks_hold_a_zero_pad(job, f"gm_{cov}_labels_block", (W.GM_SHAPE[0],
                                                            1))


def test_unseeded_draws_agree_across_ranks(job):
    # without a seed each rank would pick its own init rows and its own
    # permutation, and their row exchanges would not match
    assert np.isfinite(_same_on_every_rank(job, "km_unseeded_centers")).all()
    got = _same_on_every_rank(job, "shuffle_unseeded")
    x = job["inp"]["x"]
    np.testing.assert_array_equal(np.sort(got, axis=0), np.sort(x, axis=0))


def test_gm_random_init_is_the_one_rank_fit_and_trips_agree(job):
    assert int(_same_on_every_rank(job, "gm_random_ranks_n_iter")) == \
        int(_same_on_every_rank(job, "gm_random_one_n_iter"))
    for what in ("means", "covs"):
        np.testing.assert_allclose(
            _same_on_every_rank(job, f"gm_random_ranks_{what}"),
            _same_on_every_rank(job, f"gm_random_one_{what}"), rtol=1e-4,
            atol=1e-4)
    # the trip was injected on rank 1: it raised there, and its peers
    # raised as 'peer' instead of waiting in the next chunk's collectives
    guards = [got["gm_trip_guard"].tobytes().decode()
              for got in job["ranks"]]
    assert guards == ["peer", "injected", "peer", "peer"]


# -- A.2b's second part ---------------------------------------------------------

def _rel_to_largest(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def test_linear_regression_matches_the_reference(job):
    ref, x = job["ref"], job["inp"]["x"]
    coef = _same_on_every_rank(job, "lr_coef")
    icpt = _same_on_every_rank(job, "lr_intercept")
    assert _rel_to_largest(coef, ref["lr_coef"]) <= 1e-5
    assert _rel_to_largest(icpt, ref["lr_intercept"]) <= 1e-5
    score = float(_same_on_every_rank(job, "lr_score"))
    assert abs(score - ref["lr_score"]) <= 1e-5 * abs(ref["lr_score"])
    # the search hook's device R² is the score
    assert float(_same_on_every_rank(job, "lr_score_async")) == score
    pred = _same_on_every_rank(job, "lr_pred")
    np.testing.assert_allclose(pred, x.astype(np.float64) @ coef + icpt,
                               rtol=1e-5, atol=1e-5)
    _blocks_hold_a_zero_pad(job, "lr_pred_block", pred.shape)


def test_lasso_matches_the_reference_and_stops_with_one_rank(job):
    ref = job["ref"]
    coef = _same_on_every_rank(job, "lasso_coef")
    np.testing.assert_allclose(coef, ref["lasso_coef"], rtol=0, atol=1e-5)
    # the ranks stop at one step, the one the one-rank fit with the same
    # agents stops at, before max_iter
    n_iter = int(_same_on_every_rank(job, "lasso_n_iter"))
    assert n_iter == int(_same_on_every_rank(job, "lasso_one_n_iter"))
    assert n_iter < W.LASSO_KW["max_iter"]
    np.testing.assert_allclose(coef, _same_on_every_rank(
        job, "lasso_one_coef"), rtol=0, atol=1e-5)
    assert float(_same_on_every_rank(job, "lasso_score_async")) == \
        float(_same_on_every_rank(job, "lasso_score"))
    np.testing.assert_allclose(_same_on_every_rank(job, "lasso_pred"),
                               job["inp"]["x"].astype(np.float64)
                               @ coef[:, None], rtol=1e-5, atol=1e-5)


def test_minibatch_kmeans_is_the_one_rank_stream(job):
    np.testing.assert_allclose(_same_on_every_rank(job, "mbk_ranks_centers"),
                               _same_on_every_rank(job, "mbk_one_centers"),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(_same_on_every_rank(job, "mbk_ranks_counts"),
                                  _same_on_every_rank(job, "mbk_one_counts"))
    n = int(_same_on_every_rank(job, "mbk_ranks_n_batches"))
    assert n == int(_same_on_every_rank(job, "mbk_one_n_batches")) == \
        2 * -(-W.KM_SHAPE[0] // W.MBK_KW["batch_size"])
    np.testing.assert_allclose(_same_on_every_rank(job, "mbk_ranks_history"),
                               _same_on_every_rank(job, "mbk_one_history"),
                               rtol=1e-5)
    assert _same_on_every_rank(job, "mbk_labels").shape == (W.KM_SHAPE[0], 1)
    # a trip on rank 1 alone: the stream raises on every rank
    guards = [got["mbk_trip_guard"].tobytes().decode()
              for got in job["ranks"]]
    assert guards == ["peer", "injected", "peer", "peer"]


def test_polar_is_the_one_rank_factor(job):
    a = job["inp"]["a"].astype(np.float64)
    u = _same_on_every_rank(job, "polar_ranks_u").astype(np.float64)
    h = _same_on_every_rank(job, "polar_ranks_h").astype(np.float64)
    assert int(_same_on_every_rank(job, "polar_ranks_iters")) == \
        int(_same_on_every_rank(job, "polar_one_iters"))
    assert np.abs(u - _same_on_every_rank(job, "polar_one_u")).max() <= \
        ERROR_BOUNDS[("polar_orth", "float32")]
    assert _rel_to_largest(h, _same_on_every_rank(job, "polar_one_h")) <= \
        ERROR_BOUNDS[("polar_resid", "float32")]
    assert np.abs(u.T @ u - np.eye(u.shape[1])).max() <= \
        ERROR_BOUNDS[("polar_orth", "float32")]
    assert np.linalg.norm(u @ h - a) / np.linalg.norm(a) <= \
        ERROR_BOUNDS[("polar_resid", "float32")]
    _blocks_hold_a_zero_pad(job, "polar_u_block", a.shape)


def _distinct(s, gap=1e-2):
    """Columns whose value stands at least ``gap``·σ₁ from its
    neighbours'."""
    s = np.asarray(s, np.float64).ravel()
    d = np.abs(np.diff(s)) >= gap * s[0]
    return np.concatenate([d[:1], d[:-1] & d[1:], d[-1:]])


def test_lanczos_svd_is_the_one_rank_factorisation(job):
    s = _same_on_every_rank(job, "lz_ranks_s").ravel()
    s1 = _same_on_every_rank(job, "lz_one_s").ravel()
    assert np.abs(s - s1).max() <= 1e-5 * s1[0]
    s64 = np.linalg.svd(job["inp"]["sv"].astype(np.float64),
                        compute_uv=False)[:W.LANCZOS_K]
    assert np.abs(s - s64).max() <= 1e-5 * s64[0]
    keep = _distinct(s1)
    for key in ("u", "v"):
        got = _same_on_every_rank(job, f"lz_ranks_{key}")
        one = _same_on_every_rank(job, f"lz_one_{key}")
        sg, sg1 = (_col_signs(_same_on_every_rank(job, f"lz_{w}_u"))
                   for w in ("ranks", "one"))
        assert np.abs((got * sg - one * sg1)[:, keep]).max() <= 1e-4


@pytest.mark.parametrize("tier", ["scalar", "block"])
def test_svd_matches_a_float64_oracle(job, tier):
    a = job["inp"]["sv" if tier == "scalar" else "svb"].astype(np.float64)
    u = _same_on_every_rank(job, f"svd_{tier}_u").astype(np.float64)
    s = _same_on_every_rank(job, f"svd_{tier}_s").ravel()
    v = _same_on_every_rank(job, f"svd_{tier}_v").astype(np.float64)
    u64, s64, vt64 = np.linalg.svd(a, full_matrices=False)
    assert np.abs(s - s64).max() <= 1e-5 * s64[0]
    assert np.linalg.norm(u * s @ v.T - a) / np.linalg.norm(a) <= \
        ERROR_BOUNDS[("svd_resid", "float32")]
    keep = _distinct(s64)
    sg, sg64 = _col_signs(u), _col_signs(u64)
    assert np.abs((u * sg - u64 * sg64)[:, keep]).max() <= 1e-4
    assert np.abs((v * sg - vt64.T * sg64)[:, keep]).max() <= 1e-4
    assert int(_same_on_every_rank(job, f"svd_{tier}_sweeps")) >= 1
    _blocks_hold_a_zero_pad(job, f"svd_{tier}_u_block", a.shape)


@pytest.mark.parametrize("mode", ["economic", "full", "wide"])
def test_qr_against_numpy_and_error_bounds(job, mode):
    a = job["inp"]["wide" if mode == "wide" else "qr"].astype(np.float64)
    modes = ("economic", "full") if mode == "wide" else (mode,)
    for md in modes:
        key = f"qr_wide_{md}" if mode == "wide" else f"qr_{md}"
        q = _same_on_every_rank(job, f"{key}_q").astype(np.float64)
        r = _same_on_every_rank(job, f"{key}_r").astype(np.float64)
        k = min(a.shape)
        assert q.shape == ((a.shape[0], a.shape[0]) if md == "full"
                           else (a.shape[0], k))
        assert np.abs(q.T @ q - np.eye(q.shape[1])).max() <= \
            ERROR_BOUNDS[("qr_orth", "float32")]
        assert np.linalg.norm(q @ r - a) / np.linalg.norm(a) <= \
            ERROR_BOUNDS[("qr_resid", "float32")]
        # QᵀA = R: the full Q's complement is orthogonal to A's columns
        assert np.linalg.norm(q.T @ a - r) / np.linalg.norm(a) <= \
            ERROR_BOUNDS[("qr_resid", "float32")]
        r64 = np.linalg.qr(a)[1]
        assert _rel_to_largest(_rows_signed(r[:k]), _rows_signed(r64)) <= 1e-5
    if mode == "economic":
        np.testing.assert_array_equal(_same_on_every_rank(job, "qr_r_only"),
                                      _same_on_every_rank(job,
                                                          "qr_economic_r"))
    if mode != "wide":
        _blocks_hold_a_zero_pad(job, f"qr_{mode}_q_block",
                                _same_on_every_rank(job, f"qr_{mode}_q").shape)


def _rows_signed(r):
    """R's rows signed so that its diagonal is non-negative."""
    return r * np.where(np.diag(r) < 0, -1.0, 1.0)[:, None]


def test_kron_and_the_array_helpers_are_numpy_bit_for_bit(job):
    inp = job["inp"]
    x, y, short = inp["x"], inp["y"], inp["short"]
    for key, want in (
            ("kron", np.kron(inp["ka"], inp["kb"])),
            ("concat_rows", np.vstack([x, short, x])),
            ("concat_cols", np.hstack([x, y, x])),
            ("apply_twice1", x * 2.0 + 1.0),
            ("apply_max0", x.max(0, keepdims=True)),
            ("apply_minmax1", np.stack([x.min(1), x.max(1)], 1)),
            ("apply_head0", x[:3])):
        np.testing.assert_array_equal(_same_on_every_rank(job, key), want,
                                      err_msg=key)
        _blocks_hold_a_zero_pad(job, f"{key}_block", want.shape)
    # a func vmap cannot trace: the host tier, with its warning
    np.testing.assert_array_equal(_same_on_every_rank(job, "apply_host"),
                                  np.sort(x, axis=0))
    assert int(_same_on_every_rank(job, "apply_host_warned")) == 1
    for axis, step in ((0, 50), (1, 5)):
        n = int(_same_on_every_rank(job, f"iter{axis}_n"))
        assert n == -(-x.shape[axis] // step)
        for i in range(n):
            want = x[i * step:(i + 1) * step] if axis == 0 \
                else x[:, i * step:(i + 1) * step]
            np.testing.assert_array_equal(
                _same_on_every_rank(job, f"iter{axis}_{i}"), want)


@pytest.mark.parametrize("route", ["gathered", "ring"])
def test_knn_classifier_predicts_the_reference_labels(job, route):
    pred = _same_on_every_rank(job, f"knn_{route}_pred")
    np.testing.assert_array_equal(pred, job["ref"]["knn_pred"])
    _blocks_hold_a_zero_pad(job, f"knn_{route}_pred_block", pred.shape)
    acc = float(np.mean(pred.ravel() == job["inp"]["q_y"].ravel()))
    assert float(_same_on_every_rank(job, f"knn_{route}_score")) == acc
    assert abs(float(_same_on_every_rank(job, f"knn_{route}_score_async"))
               - acc) <= 1e-6
    np.testing.assert_array_equal(_same_on_every_rank(job, "knn_classes"),
                                  np.arange(W.KNN_CLASSES))


@pytest.mark.parametrize("est", ["km", "knn"])
def test_grid_search_is_the_one_rank_search(job, est):
    scores = _same_on_every_rank(job, f"gs_{est}_ranks_scores")
    one = _same_on_every_rank(job, f"gs_{est}_one_scores")
    np.testing.assert_allclose(scores, one, rtol=1e-5, atol=0)
    assert _same_on_every_rank(job, f"gs_{est}_ranks_best").tobytes() == \
        _same_on_every_rank(job, f"gs_{est}_one_best").tobytes()
    # each score read once, nothing else read in the dispatch
    reads = json.loads(_same_on_every_rank(
        job, f"gs_{est}_ranks_reads").tobytes())
    grid = W.GS_KM_GRID if est == "km" else W.GS_KNN_GRID
    assert reads == {"search": len(next(iter(grid.values()))) * W.GS_CV}
    assert reads == json.loads(_same_on_every_rank(
        job, f"gs_{est}_one_reads").tobytes())


def test_gm_search_hooks_are_the_sharded_fit(job):
    np.testing.assert_allclose(float(_same_on_every_rank(
        job, "gm_hook_score")), float(_same_on_every_rank(
            job, "gm_fit_score")), rtol=1e-5)
    # the hooks' model is the reference's diagonal fit, as the parity
    # case holds the sharded fit (rtol/atol 1e-4, n_iter exact)
    ref = job["ref"]
    assert int(_same_on_every_rank(job, "gm_hook_n_iter")) == \
        ref["gm_diag_n_iter"]
    for attr in ("weights_", "means_", "covariances_"):
        np.testing.assert_allclose(
            _same_on_every_rank(job, f"gm_hook_{attr}"),
            ref[f"gm_diag_{attr}"], rtol=1e-4, atol=1e-4, err_msg=attr)
    np.testing.assert_allclose(float(_same_on_every_rank(
        job, "gm_hook_lb")), ref["gm_diag_lb"], rtol=1e-4, atol=1e-4)


# -- A.2b's part (ii) -------------------------------------------------------------

def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


def test_quantile_edges_are_the_one_rank_edges_bit_for_bit(job):
    got = _same_on_every_rank(job, "edges_ranks")
    one = _same_on_every_rank(job, "edges_one")
    assert got.shape == (W.TREE_SHAPE[1] + 1, W.TREE_BINS - 1)
    np.testing.assert_array_equal(_bits(got), _bits(one))
    # the column holding a NaN has NaN edges, the others none
    assert np.isnan(got[-1]).all() and not np.isnan(got[:-1]).any()
    # a zero enters as +0.0: the column of both zeros has a zero edge,
    # and no edge is a -0.0
    assert (got[3] == 0).any()
    assert not np.signbit(got[got == 0]).any()


@pytest.mark.parametrize("name", ["dtc", "dtr"])
def test_decision_trees_match_the_reference(job, name):
    ref = job["ref"]
    for attr in ("_edges", "_feats", "_tbins"):
        np.testing.assert_array_equal(
            _same_on_every_rank(job, f"{name}_ranks{attr}"),
            ref[f"{name}{attr}"], err_msg=attr)
    leaves = _same_on_every_rank(job, f"{name}_ranks_leaves")
    pred = _same_on_every_rank(job, f"{name}_ranks_pred")
    if name == "dtc":
        # integer histograms: the reference's tree, bit for bit
        np.testing.assert_array_equal(leaves, ref["dtc_leaves"])
        np.testing.assert_array_equal(pred, ref["dtc_pred"])
    else:
        # the ranks' float sums are added in rank order
        assert _rel_to_largest(leaves, ref["dtr_leaves"]) <= 1e-5
        np.testing.assert_allclose(pred, ref["dtr_pred"], rtol=1e-5,
                                   atol=1e-5)
    # one rank's tree too, and its score
    for attr in ("_edges", "_feats", "_tbins"):
        np.testing.assert_array_equal(
            _same_on_every_rank(job, f"{name}_ranks{attr}"),
            _same_on_every_rank(job, f"{name}_one{attr}"))
    assert abs(float(_same_on_every_rank(job, f"{name}_ranks_score"))
               - float(_same_on_every_rank(job, f"{name}_one_score"))) <= 1e-6
    _blocks_hold_a_zero_pad(job, f"{name}_pred_block", pred.shape)


def test_bootstrap_forest_is_the_one_rank_forest(job):
    for attr in ("_edges", "_feats", "_tbins", "_leaves"):
        np.testing.assert_array_equal(
            _bits(_same_on_every_rank(job, f"rf_ranks{attr}")),
            _bits(_same_on_every_rank(job, f"rf_one{attr}")), err_msg=attr)
    proba = _same_on_every_rank(job, "rf_ranks_proba")
    np.testing.assert_array_equal(proba, _same_on_every_rank(
        job, "rf_one_proba"))
    _blocks_hold_a_zero_pad(job, "rf_proba_block", proba.shape)
    score = float(_same_on_every_rank(job, "rf_ranks_score"))
    assert abs(score - float(_same_on_every_rank(job, "rf_one_score"))) \
        <= 1e-6
    # the search hooks: the same score (the hook's is float32, as the
    # reference's), and a search over the forest scores every fold as one
    # rank does
    assert float(_same_on_every_rank(job, "rf_ranks_score_async")) == \
        float(np.float32(score))
    np.testing.assert_array_equal(_same_on_every_rank(job, "rf_ranks_gs"),
                                  _same_on_every_rank(job, "rf_one_gs"))


def test_carried_reference_models_predict_the_reference(job):
    ref = job["ref"]
    np.testing.assert_array_equal(
        _same_on_every_rank(job, "carried_rf_pred"), ref["carried_rf_pred"])
    np.testing.assert_allclose(_same_on_every_rank(job, "carried_rf_proba"),
                               ref["carried_rf_proba"], rtol=0, atol=1e-6)
    dec = _same_on_every_rank(job, "carried_sv_dec")
    np.testing.assert_allclose(dec, ref["carried_sv_dec"], rtol=0,
                               atol=DEC_TOL)
    clear = np.abs(ref["carried_sv_dec"].ravel()) > 1e-3
    np.testing.assert_array_equal(
        _same_on_every_rank(job, "carried_sv_pred").ravel()[clear],
        ref["carried_sv_pred"].ravel()[clear])


def test_dbscan_and_daura_match_the_reference_ring(job):
    ref = job["ref"]
    for key in ("db_labels", "db_core", "da_labels", "da_clusters"):
        got = _same_on_every_rank(job, key.replace("_", "_ranks_", 1))
        np.testing.assert_array_equal(got, ref[key], err_msg=key)
        np.testing.assert_array_equal(
            got, _same_on_every_rank(job, key.replace("_", "_one_", 1)),
            err_msg=key)
    assert int(_same_on_every_rank(job, "db_ranks_n")) == \
        len(np.unique(ref["db_labels"][ref["db_labels"] >= 0]))
    lab = _same_on_every_rank(job, "db_fit_predict")
    np.testing.assert_array_equal(lab.ravel(), ref["db_labels"])
    _blocks_hold_a_zero_pad(job, "db_fit_predict_block", lab.shape)
    # the dense and tiled tiers need every row on one rank: forced, they
    # raise across ranks
    for got in job["ranks"]:
        assert got["db_no_ring"].tobytes() == b"raised"


def test_a_density_trip_on_one_mesh_row_raises_on_every_rank(job):
    # a NaN in a row of mesh row 1: its ranks trip on their input, the
    # others as peers
    guards = [got["db_trip_guard"].tobytes().decode()
              for got in job["ranks"]]
    want = ["input-nonfinite" if r // job["cols"] == 1 else "peer"
            for r in range(WORLD)]
    assert guards == want


@pytest.mark.parametrize("kernel", ["rbf", "linear"])
def test_cascade_svm_is_the_one_rank_cascade(job, kernel):
    a, b = f"sv_{kernel}_ranks", f"sv_{kernel}_one"
    np.testing.assert_array_equal(_same_on_every_rank(job, f"{a}_idx"),
                                  _same_on_every_rank(job, f"{b}_idx"))
    assert int(_same_on_every_rank(job, f"{a}_n_iter")) == \
        int(_same_on_every_rank(job, f"{b}_n_iter"))
    np.testing.assert_allclose(_same_on_every_rank(job, f"{a}_alpha"),
                               _same_on_every_rank(job, f"{b}_alpha"),
                               rtol=0, atol=ALPHA_TOL)
    dec = _same_on_every_rank(job, f"{a}_dec")
    one = _same_on_every_rank(job, f"{b}_dec")
    np.testing.assert_allclose(dec, one, rtol=0, atol=DEC_TOL)
    clear = np.abs(one.ravel()) > 1e-3
    np.testing.assert_array_equal(
        _same_on_every_rank(job, f"{a}_pred").ravel()[clear],
        _same_on_every_rank(job, f"{b}_pred").ravel()[clear])
    assert abs(float(_same_on_every_rank(job, f"{a}_score"))
               - float(_same_on_every_rank(job, f"{b}_score"))) <= 1e-6
    _blocks_hold_a_zero_pad(job, f"sv_{kernel}_dec_block", dec.shape)


# -- A.2c: the sparse tier, ALS, the IVF index and sparse CascadeSVM --------

def _mesh_row(job, rank):
    return divmod(rank, job["cols"])[0]


def test_sparse_array_and_its_shards_match_the_reference(job):
    inp, ref = job["inp"], job["ref"]
    mat = W.sparse_of(inp["sp_x"])
    for key, want in (("sp_indptr", mat.indptr), ("sp_indices", mat.indices),
                      ("sp_data", mat.data)):
        np.testing.assert_array_equal(_same_on_every_rank(job, key), want)
    for rank, got in enumerate(job["ranks"]):
        r = _mesh_row(job, rank)
        for name in ("data", "lrows", "cols"):
            np.testing.assert_array_equal(got[f"sh_{name}"],
                                          ref[f"sh_{name}"][r:r + 1])
        np.testing.assert_array_equal(got["sh_counts"],
                                      ref["sh_counts_dev"][r:r + 1])
        for name in ("data", "lrows", "cols", "counts_dev"):
            np.testing.assert_array_equal(got[f"pv_{name}"],
                                          ref[f"pv_{name}"][r:r + 1])
    dense = _same_on_every_rank(job, "sp_dense")
    np.testing.assert_array_equal(dense, mat.toarray())
    np.testing.assert_allclose(dense, ref["sp_dense"], rtol=1e-6, atol=1e-6)
    _blocks_hold_a_zero_pad(job, "sp_dense_block", W.SP_SHAPE)
    for kind in ("sum", "mean"):
        for axis in (0, 1, None):
            key = f"sp_{kind}_{axis}"
            np.testing.assert_allclose(_same_on_every_rank(job, key),
                                       ref[key], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(_same_on_every_rank(job, "sp_rows"),
                                  mat[[5, 200, 0, 77, 77]].toarray())
    perm = np.random.RandomState(3).permutation(W.SP_SHAPE[0])
    np.testing.assert_array_equal(_same_on_every_rank(job, "sp_shuffle"),
                                  mat[perm].toarray())
    for key in ("sp_sc_mean", "sp_sc_var"):
        np.testing.assert_allclose(_same_on_every_rank(job, key), ref[key],
                                   rtol=1e-6, atol=1e-6)
    scale = np.sqrt(ref["sp_sc_var"].astype(np.float64))
    np.testing.assert_allclose(_same_on_every_rank(job, "sp_sc_t"),
                               mat.toarray() / np.where(scale == 0, 1, scale),
                               rtol=1e-5, atol=1e-6)
    # the densify route: y = x₀ + x₁ fitted exactly
    want = np.zeros((W.SP_SHAPE[1], 1))
    want[:2] = 1.0
    np.testing.assert_allclose(_same_on_every_rank(job, "sp_lr_coef"), want,
                               atol=1e-4)


@pytest.mark.parametrize("panels", W.SP_PANELS)
def test_spmm_matches_the_reference_and_its_schedules_agree(job, panels):
    want = job["ref"][f"spmm_{panels}"]
    scale = float(np.abs(want).max())
    base = _same_on_every_rank(job, f"spmm_{panels}_slots_db")
    np.testing.assert_array_equal(
        _same_on_every_rank(job, f"spmm_{panels}_again"), base)
    for lay in ("slots", "masked"):
        got = _same_on_every_rank(job, f"spmm_{panels}_{lay}_db")
        np.testing.assert_array_equal(
            _same_on_every_rank(job, f"spmm_{panels}_{lay}_seq"), got)
        assert np.abs(got - want).max() <= 1e-5 * scale, lay
        _blocks_hold_a_zero_pad(job, f"spmm_{panels}_{lay}_db_block",
                                want.shape)
    for key in ("spmm_matmul", "spmm_densify"):
        got = _same_on_every_rank(job, key)
        assert np.abs(got - want).max() <= 1e-5 * scale, key
    # each panel's fold takes B's columns in slices of BLOCK_BYTES of
    # products (here one to three columns): the same sums, bit for bit, as
    # one slice, and the slices of each panel cover the rank's columns
    np.testing.assert_array_equal(
        _same_on_every_rank(job, f"spmm_{panels}_sliced"), base)
    for r in job["ranks"]:
        widths = r[f"spmm_{panels}_sliced_widths"]
        n_loc = int(r["spmm_n_local"])
        steps = int(r[f"spmm_{panels}_sliced_steps"])
        assert n_loc > 3 and widths.max() <= 3, widths
        assert widths.sum() == steps * n_loc, (widths, steps, n_loc)


def test_sparse_kmeans_matches_the_reference(job):
    ref = job["ref"]
    np.testing.assert_allclose(_same_on_every_rank(job, "skm_centers"),
                               ref["skm_centers"], atol=1e-5)
    np.testing.assert_array_equal(_same_on_every_rank(job, "skm_labels"),
                                  ref["skm_labels"])
    inertia = float(_same_on_every_rank(job, "skm_inertia"))
    assert abs(inertia - ref["skm_inertia"]) <= 1e-5 * ref["skm_inertia"]
    assert abs(-float(_same_on_every_rank(job, "skm_score")) - inertia) \
        <= 1e-5 * inertia
    _blocks_hold_a_zero_pad(job, "skm_labels_block", (W.SKM_SHAPE[0], 1))


@pytest.mark.parametrize("q", ["sparse", "dense"])
def test_sparse_knn_matches_the_reference(job, q):
    ref = job["ref"]
    np.testing.assert_array_equal(_same_on_every_rank(job, f"sknn_{q}_idx"),
                                  ref[f"sknn_{q}_idx"])
    np.testing.assert_allclose(_same_on_every_rank(job, f"sknn_{q}_dist"),
                               ref[f"sknn_{q}_dist"], atol=1e-5)
    _blocks_hold_a_zero_pad(job, f"sknn_{q}_idx_block", (W.NN_Q[0], W.NN_K))


def test_dense_als_matches_the_reference(job):
    ref = job["ref"]
    for name in ("users", "items"):
        got = _same_on_every_rank(job, f"als_dense_{name}")
        want = ref[f"als_{name}"]
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), name
    np.testing.assert_allclose(_same_on_every_rank(job, "als_dense_history"),
                               ref["als_history"], atol=1e-5)
    assert int(_same_on_every_rank(job, "als_dense_n_iter")) \
        == ref["als_n_iter"] < W.ALS_KW["max_iter"]


def test_sparse_als_matches_its_substitute_oracle(job):
    # the reference's sparse fit fails (ROADMAP.md C.2): the oracles are
    # the port's dense fit of the densified ratings on the same mesh and
    # the port's one-rank sparse fit
    for oracle in ("densified", "sparse_one"):
        for name in ("users", "items"):
            got = _same_on_every_rank(job, f"als_sparse_{name}")
            want = _same_on_every_rank(job, f"als_{oracle}_{name}")
            assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), \
                (oracle, name)
        np.testing.assert_allclose(
            _same_on_every_rank(job, "als_sparse_history"),
            _same_on_every_rank(job, f"als_{oracle}_history"), atol=1e-4)
        assert int(_same_on_every_rank(job, "als_sparse_n_iter")) \
            == int(_same_on_every_rank(job, f"als_{oracle}_n_iter"))
    assert _same_on_every_rank(job, "als_fold_in").shape \
        == (5, W.ALS_SHAPE[1])


def test_ivf_layout_and_search_match_the_reference(job):
    ref, rows, cols = job["ref"], job["rows"], job["cols"]
    for meta in job["ranks"]:
        assert json.loads(meta["ivf_pad_waste"].tobytes()) \
            == ref["ivf_pad_waste"]
    e_pad = ref["ivf_ids"].shape[0] // rows
    d_loc = ref["ivf_vecs"].shape[1] // cols
    for rank, got in enumerate(job["ranks"]):
        r, c = divmod(rank, cols)
        np.testing.assert_array_equal(
            got["ivf_vecs"], ref["ivf_vecs"][r * e_pad:(r + 1) * e_pad,
                                             c * d_loc:(c + 1) * d_loc])
        np.testing.assert_array_equal(
            got["ivf_ids"], ref["ivf_ids"][r * e_pad:(r + 1) * e_pad])
        np.testing.assert_allclose(
            got["ivf_vsq"], ref["ivf_vsq"][r * e_pad:(r + 1) * e_pad],
            rtol=1e-6)
        for name in ("offs", "cnts"):
            np.testing.assert_array_equal(got[f"ivf_{name}"],
                                          ref[f"ivf_{name}"][r])
    for nprobe in (W.IVF_PROBE, W.IVF_LISTS):
        for sched in ("db", "seq", "kernel"):
            key = f"ivf_{nprobe}_{sched}"
            np.testing.assert_array_equal(
                _same_on_every_rank(job, f"{key}_idx"),
                ref[f"ivf_{nprobe}_idx"], err_msg=key)
            np.testing.assert_allclose(
                _same_on_every_rank(job, f"{key}_dist"),
                ref[f"ivf_{nprobe}_dist"], atol=1e-5, err_msg=key)
    _blocks_hold_a_zero_pad(job, "ivf_idx_block", (W.IVF_Q, W.IVF_K))
    # a carried reference index, and the ranks' own fit searched exactly
    for key, nprobe in (("ivf_carried", W.IVF_PROBE),
                        ("ivf_fit_exact", W.IVF_LISTS)):
        np.testing.assert_array_equal(_same_on_every_rank(job, f"{key}_idx"),
                                      ref[f"ivf_{nprobe}_idx"])
        np.testing.assert_allclose(_same_on_every_rank(job, f"{key}_dist"),
                                   ref[f"ivf_{nprobe}_dist"], atol=1e-5)


@pytest.mark.parametrize("staging", ["ell", "csr"])
def test_sparse_cascade_svm_is_the_one_rank_cascade(job, staging):
    # against the reference's sparse cascade on the same mesh, and against
    # the port's one-rank fit
    one = f"ssv_{staging}_one"
    got = f"ssv_{staging}_ranks"
    ref = job["ref"]
    for r in job["ranks"]:
        np.testing.assert_array_equal(r[f"{got}_idx"], ref["ssv_idx"])
        assert int(r[f"{got}_n_iter"]) == int(ref["ssv_n_iter"])
        np.testing.assert_allclose(r[f"{got}_alpha"], ref["ssv_alpha"],
                                   rtol=0, atol=ALPHA_TOL)
        np.testing.assert_allclose(r[f"{got}_dec"], ref["ssv_dec"],
                                   rtol=0, atol=DEC_TOL)
        np.testing.assert_array_equal(r[f"{got}_idx"], r[f"{one}_idx"])
        assert int(r[f"{got}_n_iter"]) == int(r[f"{one}_n_iter"])
        np.testing.assert_allclose(r[f"{got}_alpha"], r[f"{one}_alpha"],
                                   atol=ALPHA_TOL)
        np.testing.assert_allclose(r[f"{got}_dec"], r[f"{one}_dec"],
                                   atol=DEC_TOL)
        assert float(r[f"{got}_score"]) == float(r[f"{one}_score"])
