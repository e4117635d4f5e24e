"""One rank of the port's multi-rank CPU tests (``test_torch_distributed``).

Run as ``python tests/torch_mesh_worker.py RANK WORLD STORE OUT ROWS COLS``
by the test, once per rank: it joins a gloo job through the FileStore
``STORE``, builds a ``(ROWS, COLS)`` mesh on the CPU, runs every scenario
on inputs made from fixed seeds (:func:`inputs`, which the test also
calls), and writes this rank's blocks and the collected results to
``OUT/rank<RANK>.npz``.  It imports no JAX.
"""

from __future__ import annotations

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
    return dict(x=x, y=y, a=a, b=b, km=km, fit=fit, q=q)


def unported(dst, x, y):
    """Every estimator not yet ported to the mesh, fitted on the sharded
    ``x``: each must raise NotImplementedError.  Returns the names of
    those that did not."""
    from dislib_tpu_torch import cluster, decomposition, preprocessing, \
        regression, trees, classification, recommendation, retrieval
    from dislib_tpu_torch.model_selection import GridSearchCV
    calls = {
        "GaussianMixture": lambda: cluster.GaussianMixture(
            n_components=2, random_state=0).fit(x),
        "MiniBatchKMeans": lambda: cluster.MiniBatchKMeans(
            n_clusters=2, random_state=0).fit(x),
        "DBSCAN": lambda: cluster.DBSCAN().fit(x),
        "Daura": lambda: cluster.Daura(cutoff=0.5).fit(
            dst.array(np.zeros((x.shape[0], 12), np.float32))),
        "StandardScaler": lambda: preprocessing.StandardScaler(
        ).fit_transform(x),
        "MinMaxScaler": lambda: preprocessing.MinMaxScaler().fit_transform(x),
        "LinearRegression": lambda: regression.LinearRegression().fit(x, y),
        "Lasso": lambda: regression.Lasso().fit(x, y),
        "RandomForestClassifier": lambda: trees.RandomForestClassifier(
            n_estimators=2, random_state=0).fit(x, y),
        "DecisionTreeRegressor": lambda: trees.DecisionTreeRegressor(
            random_state=0).fit(x, y),
        "CascadeSVM": lambda: classification.CascadeSVM().fit(x, y),
        "KNeighborsClassifier": lambda: classification.KNeighborsClassifier(
        ).fit(x, y).predict(x),
        "PCA": lambda: decomposition.PCA(n_components=2).fit(x),
        "tsqr": lambda: decomposition.tsqr(x),
        "random_svd": lambda: decomposition.random_svd(x, nsv=2),
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
