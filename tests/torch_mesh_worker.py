"""One rank of the port's multi-rank CPU tests (``test_torch_distributed``).

Run as ``python tests/torch_mesh_worker.py RANK WORLD STORE OUT ROWS COLS``
by the test, once per rank: it joins a gloo job through the FileStore
``STORE``, builds a ``(ROWS, COLS)`` mesh on the CPU, runs every scenario
on inputs made from fixed seeds (:func:`inputs`, which the test also
calls), and writes this rank's blocks and the collected results to
``OUT/rank<RANK>.npz``.  It imports no JAX.
"""

from __future__ import annotations

import importlib
import json
import os
import sys

import numpy as np

# the shapes are small and not multiples of the pad quanta, so every
# block of every rank holds padding somewhere
X_SHAPE = (203, 13)
A_SHAPE, B_SHAPE = (70, 50), (50, 37)
KM_SHAPE, KM_K = (300, 8), 4
NN_FIT, NN_Q, NN_K = (257, 8), (61, 8), 5
# A.2b's first part: a (30, 13) array whose (4, 1) blocks (8 rows) are
# shorter than its 13 columns; random_svd's decayed (203, 40) input and
# sketch (nsv + 10 = 16 < 40 columns); GaussianMixture's blobs, 482 rows
# (padded on both meshes), k = 3
SHORT_SHAPE = (30, 13)
SV_SHAPE, SV_NSV, SV_SEED = (203, 40), 6, 0
SV_SKETCH = SV_NSV + 10
GM_SHAPE, GM_K = (482, 4), 3
GM_KW = dict(n_components=GM_K, max_iter=40, tol=1e-4, random_state=0)


def inputs():
    """Every input, made from fixed seeds with NumPy."""
    rng = np.random.RandomState(0)
    x = rng.rand(*X_SHAPE).astype(np.float32)
    y = rng.rand(X_SHAPE[0], 2).astype(np.float32)
    a = rng.randn(*A_SHAPE).astype(np.float32)
    b = rng.randn(*B_SHAPE).astype(np.float32)
    centers = rng.rand(KM_K, KM_SHAPE[1]).astype(np.float32) * 4
    km = (centers[rng.randint(0, KM_K, KM_SHAPE[0])]
          + 0.3 * rng.randn(*KM_SHAPE)).astype(np.float32)
    fit = rng.rand(*NN_FIT).astype(np.float32)
    q = rng.rand(*NN_Q).astype(np.float32)
    short = rng.rand(*SHORT_SHAPE).astype(np.float32)
    sv = (rng.standard_normal(SV_SHAPE) * 0.9 ** np.arange(SV_SHAPE[1])
          ).astype(np.float32)
    g_centers = rng.uniform(-6, 6, (GM_K, GM_SHAPE[1]))
    g_lab = rng.randint(0, GM_K, GM_SHAPE[0])
    gm = (g_centers[g_lab] + np.array([0.5, 1.0, 1.5])[g_lab, None]
          * rng.standard_normal(GM_SHAPE)).astype(np.float32)
    return dict(x=x, y=y, a=a, b=b, km=km, fit=fit, q=q, short=short,
                sv=sv, gm=gm)


def unported(dst, x, y):
    """Every estimator not yet ported to the mesh, fitted on the sharded
    ``x``: each must raise NotImplementedError.  Returns the names of
    those that did not."""
    from dislib_tpu_torch import cluster, regression, trees, \
        classification, recommendation, retrieval
    from dislib_tpu_torch.model_selection import GridSearchCV
    calls = {
        "GaussianMixture(checkpoint=)": lambda: cluster.GaussianMixture(
            n_components=2, random_state=0).fit(x, checkpoint=object()),
        "MiniBatchKMeans": lambda: cluster.MiniBatchKMeans(
            n_clusters=2, random_state=0).fit(x),
        "DBSCAN": lambda: cluster.DBSCAN().fit(x),
        "Daura": lambda: cluster.Daura(cutoff=0.5).fit(
            dst.array(np.zeros((x.shape[0], 12), np.float32))),
        "LinearRegression": lambda: regression.LinearRegression().fit(x, y),
        "Lasso": lambda: regression.Lasso().fit(x, y),
        "RandomForestClassifier": lambda: trees.RandomForestClassifier(
            n_estimators=2, random_state=0).fit(x, y),
        "DecisionTreeRegressor": lambda: trees.DecisionTreeRegressor(
            random_state=0).fit(x, y),
        "CascadeSVM": lambda: classification.CascadeSVM().fit(x, y),
        "KNeighborsClassifier": lambda: classification.KNeighborsClassifier(
        ).fit(x, y).predict(x),
        "qr": lambda: dst.qr(x),
        "svd": lambda: dst.svd(x),
        "ALS": lambda: recommendation.ALS(n_f=2).fit(x),
        "IVFIndex": lambda: retrieval.IVFIndex(n_lists=2).fit(x),
        "GridSearchCV": lambda: GridSearchCV(
            cluster.KMeans(max_iter=2), {"n_clusters": [2, 3]}, cv=2).fit(x),
        "transpose": lambda: x.T,
        "apply_along_axis": lambda: dst.apply_along_axis(
            lambda v: v * 2, 0, x),
        "KMeans(checkpoint=)": lambda: cluster.KMeans(
            n_clusters=2).fit(x, checkpoint=object()),
        "save_model": lambda: dst.save_model(cluster.KMeans(), os.devnull),
    }
    missed = []
    for name, call in calls.items():
        try:
            call()
        except NotImplementedError:
            continue
        except Exception as exc:  # noqa: BLE001 — reported to the test
            missed.append(f"{name}: {type(exc).__name__}: {exc}")
            continue
        missed.append(name)
    return missed


def run(dst, mesh, inp):
    """Every scenario on ``mesh``; returns {name: array} of this rank."""
    from dislib_tpu_torch.cluster import KMeans
    from dislib_tpu_torch.neighbors import NearestNeighbors
    out = {}
    x = dst.array(inp["x"])
    out["x_block"] = x._local.numpy()
    out["x"] = x.collect()
    for kind in ("sum", "mean", "min", "max", "norm"):
        for axis in (0, 1, None):
            r = getattr(x, kind)(axis=axis)
            out[f"{kind}_{axis}_block"] = r._local.numpy()
            out[f"{kind}_{axis}"] = r.collect()
    out["x_plus"] = ((x * 2.0 + x) - 1.0).collect()
    # two arrays: 0/0 and 0**0 in the pad must not survive the op
    for name, r in (("x_div", x / x), ("x_pow", x ** x), ("x_mul", x * x)):
        out[f"{name}_block"] = r._local.numpy()
        out[name] = r.collect()
    a, b = dst.array(inp["a"]), dst.array(inp["b"])
    for pol in ("float32", "bfloat16"):
        c = dst.matmul(a, b, algorithm="summa", precision=pol)
        out[f"summa_{pol}_block"] = c._local.float().numpy()
        out[f"summa_{pol}"] = c.collect()
        out[f"summa_{pol}_again"] = dst.matmul(
            a, b, algorithm="summa", precision=pol).collect()
    out["xla_float32"] = dst.matmul(a, b, algorithm="xla").collect()
    km_x = dst.array(inp["km"])
    km = KMeans(n_clusters=KM_K, random_state=0, max_iter=20,
                tol=1e-4).fit(km_x)
    lab = km.predict(km_x)
    out["km_centers"] = km.centers_
    out["km_labels_block"] = lab._local.numpy()
    out["km_labels"] = lab.collect()
    out["km_inertia"] = np.float64(km.inertia_)
    out["km_n_iter"] = np.int64(km.n_iter_)
    out["km_score"] = np.float64(km.score(km_x))
    km2 = KMeans(n_clusters=KM_K, random_state=0, max_iter=20,
                 tol=1e-4).fit(km_x)
    out["km_centers_again"] = km2.centers_
    f, q = dst.array(inp["fit"]), dst.array(inp["q"])
    for ring in (True, False):
        d, i = NearestNeighbors(n_neighbors=NN_K, ring=ring).fit(
            f).kneighbors(q)
        out[f"knn_{ring}_idx_block"] = i._local.numpy()
        out[f"knn_{ring}_idx"] = i.collect()
        out[f"knn_{ring}_dist"] = d.collect()
    y = dst.array(inp["y"])
    xs, ys = dst.shuffle(x, y, random_state=3)
    out["shuffle_x"], out["shuffle_y"] = xs.collect(), ys.collect()
    out["shuffle_block"] = xs._local.numpy()
    tr, te, ytr, yte = dst.train_test_split(x, y, random_state=4)
    out["split_train"], out["split_test"] = tr.collect(), te.collect()
    out["split_ytest"] = yte.collect()
    out["rows"] = x[np.array([5, 200, 0, 77])].collect()
    out["random"] = dst.random_array((37, 11), random_state=5).collect()
    return out


def run_a2b(dst, inp, job_dir):
    """A.2b's first part: ``eye``, the broadcast ops, the scalers,
    ``tsqr``, ``random_svd``, PCA and GaussianMixture across ranks.
    random_svd's test matrix is the one in ``job_dir/omega.npz`` (the
    reference's draw, written by the test)."""
    import torch
    from dislib_tpu_torch import decomposition, preprocessing
    from dislib_tpu_torch.cluster import GaussianMixture, gm as gm_mod
    randomsvd = importlib.import_module(
        "dislib_tpu_torch.decomposition.randomsvd")
    tsqr_mod = importlib.import_module("dislib_tpu_torch.decomposition.tsqr")
    from dislib_tpu_torch.runtime.health import NumericalDivergence
    from dislib_tpu_torch.utils import faults
    out = {}
    for name, e in (("eye57", dst.eye(5, 7)), ("eye5", dst.eye(5)),
                    ("identity5", dst.identity(5))):
        out[name], out[f"{name}_block"] = e.collect(), e._local.numpy()
    # every binary op of a full array with a (1, n), an (m, 1) and a
    # (1, 1) operand, in either order
    x = dst.array(inp["x"])
    vecs = {"row": x.mean(axis=0), "col": x.sum(axis=1),
            "one": x.max(axis=None)}
    for v, arr in vecs.items():
        out[f"bc_{v}"] = arr.collect()
        for op in ("add", "sub", "mul", "div", "pow"):
            f = {"add": lambda a, b: a + b, "sub": lambda a, b: a - b,
                 "mul": lambda a, b: a * b, "div": lambda a, b: a / b,
                 "pow": lambda a, b: a ** b}[op]
            for order, r in (("xv", f(x, arr)), ("vx", f(arr, x))):
                out[f"bc_{v}_{op}_{order}"] = r.collect()
                out[f"bc_{v}_{op}_{order}_block"] = r._local.numpy()
    for cls in ("StandardScaler", "MinMaxScaler"):
        sc = getattr(preprocessing, cls)()
        t = sc.fit_transform(x)
        out[f"{cls}_t"], out[f"{cls}_block"] = t.collect(), t._local.numpy()
        out[f"{cls}_back"] = sc.inverse_transform(t).collect()
    # tsqr: the tree (the CPU's route), CholeskyQR2, and CholeskyQR2
    # refused on rank 1 alone: every rank must take the tree then
    short = dst.array(inp["short"])
    for name, a in (("x", x), ("short", short)):
        q, r = decomposition.tsqr(a)
        out[f"tsqr_{name}_q"], out[f"tsqr_{name}_r"] = q.collect(), r.collect()
        out[f"tsqr_{name}_q_block"] = q._local.numpy()
    saved = os.environ.get("DSLIB_TSQR_CHOLQR")
    os.environ["DSLIB_TSQR_CHOLQR"] = "1"
    cholqr2, tree = tsqr_mod._cholqr2, tsqr_mod._local_tsqr
    trees = []
    try:
        q, r = decomposition.tsqr(x)
        out["tsqr_chol_q"], out["tsqr_chol_r"] = q.collect(), r.collect()
        if dst.get_mesh().rank == 1:
            def refused(a):
                qc, rc, _ = cholqr2(a)
                return qc, rc, torch.zeros((), dtype=torch.bool)
            tsqr_mod._cholqr2 = refused
        tsqr_mod._local_tsqr = lambda *a: trees.append(1) or tree(*a)
        q, r = decomposition.tsqr(x)
    finally:
        tsqr_mod._cholqr2, tsqr_mod._local_tsqr = cholqr2, tree
        if saved is None:
            os.environ.pop("DSLIB_TSQR_CHOLQR", None)
        else:
            os.environ["DSLIB_TSQR_CHOLQR"] = saved
    out["tsqr_forced_q"], out["tsqr_forced_r"] = q.collect(), r.collect()
    out["tsqr_forced_trees"] = np.int64(len(trees))
    # random_svd with the reference's test matrix: the fused path, and the
    # composed one (a float64 array)
    omega = dict(np.load(os.path.join(job_dir, "omega.npz")))
    randomsvd._omega_of = lambda seed, n, sketch, device: torch.from_numpy(
        omega[f"{seed}_{n}_{sketch}"]).to(device)
    for name, dt in (("fused", np.float32), ("composed", np.float64)):
        u, s_, v = decomposition.random_svd(
            dst.array(inp["sv"], dtype=dt), nsv=SV_NSV,
            random_state=SV_SEED)
        out[f"rsvd_{name}_u"], out[f"rsvd_{name}_s"] = (u.collect(),
                                                       s_.collect())
        out[f"rsvd_{name}_v"] = v.collect()
        out[f"rsvd_{name}_u_block"] = u._local.numpy()
    pca = decomposition.PCA(n_components=4).fit(x)
    out["pca_var"] = pca.explained_variance_.collect()
    out["pca_comp"] = pca.components_.collect()
    out["pca_mean"] = pca.mean_.collect()
    t = pca.transform(x)
    out["pca_t"], out["pca_t_block"] = t.collect(), t._local.numpy()
    out["pca_back"] = pca.inverse_transform(t).collect()
    g = dst.array(inp["gm"])
    for cov in ("full", "diag"):
        est = GaussianMixture(covariance_type=cov, **GM_KW).fit(g)
        for attr in ("weights_", "means_", "covariances_", "history_"):
            out[f"gm_{cov}_{attr}"] = getattr(est, attr)
        out[f"gm_{cov}_lb"] = np.float64(est.lower_bound_)
        out[f"gm_{cov}_n_iter"] = np.int64(est.n_iter_)
        lab = est.predict(g)
        out[f"gm_{cov}_labels"] = lab.collect()
        out[f"gm_{cov}_labels_block"] = lab._local.numpy()
        out[f"gm_{cov}_score"] = np.float64(est.score(g))
    # the random init: one draw at the logical rows, so the fit is the
    # one-rank fit's
    for name, arr in (("ranks", g), ("one", dst.array(inp["gm"],
                                                      device="cpu"))):
        est = GaussianMixture(init_params="random", **GM_KW).fit(arr)
        out[f"gm_random_{name}_means"] = est.means_
        out[f"gm_random_{name}_covs"] = est.covariances_
        out[f"gm_random_{name}_n_iter"] = np.int64(est.n_iter_)
    # unseeded draws: rank 0's fresh seed on every rank, so the ranks'
    # row exchanges agree
    from dislib_tpu_torch.cluster import KMeans
    out["km_unseeded_centers"] = KMeans(n_clusters=GM_K, max_iter=3).fit(
        g).centers_
    out["shuffle_unseeded"] = dst.shuffle(x).collect()
    # a health trip on rank 1 alone trips every rank: no rank is left in
    # the next chunk's collectives
    health = faults.TripAtChunk(at_chunk=1) if dst.get_mesh().rank == 1 \
        else None
    try:
        GaussianMixture(covariance_type="diag", **GM_KW).fit(g, health=health)
        out["gm_trip_guard"] = np.frombuffer(b"none", np.uint8)
    except NumericalDivergence as exc:
        out["gm_trip_guard"] = np.frombuffer(str(exc.guard).encode(),
                                             np.uint8)
    del gm_mod
    return out


def main(argv):
    rank, world, store, out_dir, rows, cols = argv[1:7]
    rank, world, rows, cols = int(rank), int(world), int(rows), int(cols)
    import torch
    torch.set_num_threads(1)
    import dislib_tpu_torch as dst
    from dislib_tpu_torch.parallel import distributed as dd
    dd.initialize(f"file://{store}", world, rank, device="cpu", timeout=60)
    mesh = dst.init((rows, cols))
    inp = inputs()
    out = run(dst, mesh, inp)
    out.update(run_a2b(dst, inp, out_dir))
    x = dst.array(inp["x"])
    y = dst.array((inp["y"][:, :1] > 0.5).astype(np.float32))
    missed = unported(dst, x, y)
    try:
        x._data
        missed.append("_data")
    except NotImplementedError:
        pass
    out["meta"] = np.frombuffer(json.dumps({
        "coord": list(mesh.coord), "missed": missed,
        "comm": dd.comm_stats()}).encode(), np.uint8)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dd.shutdown()


if __name__ == "__main__":
    main(sys.argv)
