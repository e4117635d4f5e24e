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
# A.2b's second part: qr's panel shrunk to QR_PANEL so a (203, 20) array
# takes the blocked loop (3 panels) and the full QR its complement path;
# a (13, 30) short-wide array the Householder fallback; svd's block tier
# at (203, 130) (>= 2·64 padded columns), a decayed spectrum so the
# values stand apart; kron of (5, 3) and (4, 7); the kNN classifier's
# labels (3 classes) for the fit rows; MiniBatchKMeans' batches of 64
# rows (the last 44) over 2 epochs; the searches' grids, 3 folds
QR_PANEL = 8
QR_SHAPE, WIDE_SHAPE = (203, 20), (13, 30)
SVD_BLOCK_SHAPE = (203, 130)
KRON_A, KRON_B = (5, 3), (4, 7)
KNN_CLASSES = 3
MBK_KW = dict(n_clusters=KM_K, batch_size=64, epochs=2, random_state=0)
LASSO_KW = dict(lmbd=2.0, rho=5.0, max_iter=200)
LANCZOS_K = 6
GS_KM_GRID = {"n_clusters": [2, 3, 4]}
GS_KNN_GRID = {"n_neighbors": [1, 3, 5, 7]}
GS_CV = 3
# A.2b's part (ii): the trees on (203, 5) rows (a tie column and a column
# of zeros of both signs), edges also with a NaN column; 4 classes; the
# regressor's target steps whose gains stand apart; a bootstrap forest of
# FOREST_KW; DBSCAN on rings and Daura on frames whose pairs keep MARGIN
# (d²) from the threshold; CascadeSVM on 256 × 4 blobs, block rows 64;
# the ring's tile and the pass's column chunk shrunk to RING_TILE rows
TREE_SHAPE, TREE_BINS = (203, 5), 8
DTC_KW, DTR_KW = dict(max_depth=4), dict(max_depth=3)
FOREST_KW = dict(n_estimators=4, max_depth=4, try_features="sqrt",
                 random_state=0, n_bins=TREE_BINS)
FOREST_GRID = {"max_depth": [2, 3]}
MARGIN = 1e-3
DB_EPS, DB_MIN, DA_CUT, DA_ATOMS = 0.4, 5, 1.5, 4
CSVM_SHAPE, CSVM_BLOCK, CSVM_ITERS = (256, 4), 64, 3
RING_TILE = 16


def _d2(x):
    x = x.astype(np.float64)
    sq = (x * x).sum(1)
    return np.maximum(sq[:, None] - 2.0 * x @ x.T + sq[None, :], 0.0)


def _with_margin(x, thr):
    """``x`` without the rows of a pair within MARGIN of ``thr`` (d²)."""
    while True:
        near = np.abs(_d2(x) - thr) < MARGIN
        np.fill_diagonal(near, False)
        if not near.any():
            return x
        x = np.delete(x, np.nonzero(near.any(1))[0][:1], axis=0)


def inputs_a2b3():
    """A.2b's part (ii)'s inputs, from fixed seeds."""
    rng = np.random.RandomState(11)
    m, n = TREE_SHAPE
    tx = rng.rand(m, n).astype(np.float32)
    tx[:, 2] = rng.randint(0, 4, m) / 4.0              # ties
    z = rng.rand(m) < 0.3
    tx[z, 3] = np.where(rng.rand(z.sum()) < 0.5, -0.0, 0.0)
    tx[:, 4] = rng.standard_normal(m)
    yc = ((tx[:, 0] > 0.5).astype(int) + (tx[:, 1] > 0.6)
          + (rng.rand(m) < 0.1)).astype(np.float32)[:, None]
    yr = (4.0 * (tx[:, 0] > 0.5) + 2.0 * (tx[:, 1] > 0.3) + 1.0
          * (tx[:, 4] > 0.8) + 0.05 * rng.standard_normal(m)).astype(
        np.float32)[:, None]
    ex = np.c_[tx, rng.rand(m).astype(np.float32)]
    ex[17, -1] = np.nan
    t = rng.rand(120) * 2 * np.pi
    rings = np.vstack([np.c_[np.cos(t), np.sin(t)],
                       np.c_[np.cos(t) + 6.0, np.sin(t)]])
    db = _with_margin((rings + 0.05 * rng.standard_normal(rings.shape)
                       ).astype(np.float32), DB_EPS ** 2)
    c = rng.standard_normal((6, 3 * DA_ATOMS)) * 2
    da = _with_margin((c[rng.randint(0, 6, 150)] + 0.4 * rng.standard_normal(
        (150, 3 * DA_ATOMS))).astype(np.float32), DA_CUT ** 2 * DA_ATOMS)
    cm, cd = CSVM_SHAPE
    cx = np.vstack([rng.standard_normal((cm // 2, cd)),
                    rng.standard_normal((cm // 2, cd)) + 2.5])
    cy = np.r_[np.zeros(cm // 2), np.ones(cm // 2)]
    p = rng.permutation(cm)
    cq = rng.standard_normal((50, cd)) + 1.25
    return dict(tree_x=tx, tree_yc=yc, tree_yr=yr, edges_x=ex, db=db, da=da,
                csvm_x=cx[p].astype(np.float32),
                csvm_y=cy[p].astype(np.float32)[:, None],
                csvm_q=cq.astype(np.float32))


# A.2c: a (203, 37) sparse matrix (~15 % dense) and SpMM's (37, 19)
# right-hand side at DSLIB_SPMM_PANELS 2 and 4; sparse KMeans on
# separated sparse blobs (300 × 20, k = 4); the sparse kNN on sparse
# versions of the kNN fit rows and queries; ALS on (70, 30) low-rank
# ratings (n_f = 3, 8 sweeps at tol 1e-3: the stop stands clear of the
# tolerance), the reference's V₀ handed in by ``job_dir/als_v0.npz``; the
# IVF index on a (300, 6) catalog (8 lists), built from the reference's
# labels and centers in ``job_dir/ivf.npz``, and 37 queries, k = 4;
# sparse CascadeSVM on (256, 30) blobs ~60 % zeros, block rows 64,
# staged by ELL and by the host CSR
SP_SHAPE, SP_B = (203, 37), 19
SP_PANELS = (2, 4)
SKM_SHAPE, SKM_K = (300, 20), 4
ALS_SHAPE, ALS_F = (70, 30), 3
ALS_KW = dict(n_f=ALS_F, lambda_=0.065, tol=1e-3, max_iter=8,
              random_state=0)
IVF_SHAPE, IVF_Q, IVF_LISTS, IVF_K, IVF_PROBE = (300, 6), 37, 8, 4, 3
SSV_SHAPE, SSV_BLOCK = (256, 30), 64


def inputs_a2c():
    """A.2c's inputs, from fixed seeds (sparse ones as dense arrays with
    zeros: each side makes its scipy CSR)."""
    rng = np.random.RandomState(19)
    sp_x = rng.rand(*SP_SHAPE).astype(np.float32)
    sp_x[rng.rand(*SP_SHAPE) > 0.15] = 0
    sp_b = rng.randn(SP_SHAPE[1], SP_B).astype(np.float32)
    m, n = SKM_SHAPE
    cen = np.where(rng.rand(SKM_K, n) < 0.4, 3.0 * rng.rand(SKM_K, n), 0.0)
    lab = rng.randint(0, SKM_K, m)
    skm = np.where(cen[lab] > 0, cen[lab] + 0.1 * rng.randn(m, n), 0.0)
    u, v = rng.rand(ALS_SHAPE[0], ALS_F), rng.rand(ALS_SHAPE[1], ALS_F)
    full = u @ v.T
    full = 1.0 + 4.0 * (full - full.min()) / (full.max() - full.min())
    mask = rng.rand(*ALS_SHAPE) < 0.4
    mask[np.arange(ALS_SHAPE[0]), rng.randint(0, ALS_SHAPE[1],
                                              ALS_SHAPE[0])] = True
    mask[rng.randint(0, ALS_SHAPE[0], ALS_SHAPE[1]),
         np.arange(ALS_SHAPE[1])] = True
    cm, cd = SSV_SHAPE
    ssv = np.vstack([rng.standard_normal((cm // 2, cd)),
                     rng.standard_normal((cm // 2, cd)) + 0.8])
    ssv[np.abs(ssv) < 0.85] = 0
    ssv_y = np.r_[np.zeros(cm // 2), np.ones(cm // 2)]
    perm = rng.permutation(cm)
    return dict(sp_x=sp_x, sp_b=sp_b, skm=skm.astype(np.float32),
                als=(full * mask).astype(np.float32),
                ivf=rng.randn(*IVF_SHAPE).astype(np.float32),
                ivf_q=rng.randn(IVF_Q, IVF_SHAPE[1]).astype(np.float32),
                ssv=ssv[perm].astype(np.float32),
                ssv_y=ssv_y[perm].astype(np.float32)[:, None])


def sparse_of(a):
    """The scipy CSR of a dense input (its zeros unstored)."""
    import scipy.sparse as sp
    return sp.csr_matrix(a)


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
    qr_a = rng.standard_normal(QR_SHAPE).astype(np.float32)
    wide = rng.standard_normal(WIDE_SHAPE).astype(np.float32)
    svb = (rng.standard_normal(SVD_BLOCK_SHAPE)
           * 0.97 ** np.arange(SVD_BLOCK_SHAPE[1])).astype(np.float32)
    ka = rng.standard_normal(KRON_A).astype(np.float32)
    kb = rng.standard_normal(KRON_B).astype(np.float32)
    fit_y = rng.randint(0, KNN_CLASSES, (NN_FIT[0], 1)).astype(np.float32)
    q_y = rng.randint(0, KNN_CLASSES, (NN_Q[0], 1)).astype(np.float32)
    return dict(x=x, y=y, a=a, b=b, km=km, fit=fit, q=q, short=short,
                sv=sv, gm=gm, qr=qr_a, wide=wide, svb=svb, ka=ka, kb=kb,
                fit_y=fit_y, q_y=q_y, **inputs_a2b3(), **inputs_a2c())


def unported(dst, x, y):
    """Every estimator not yet ported to the mesh, fitted on the sharded
    ``x``: each must raise NotImplementedError.  Returns the names of
    those that did not."""
    from dislib_tpu_torch import cluster, trees, classification, \
        recommendation, retrieval
    box = {}
    inp_x = x.collect()

    def ckpt(call):
        def run():
            try:
                call()
            except NotImplementedError as exc:
                box["msg"] = str(exc)
                raise
        return run

    calls = {
        "GaussianMixture(checkpoint=)": lambda: cluster.GaussianMixture(
            n_components=2, random_state=0).fit(x, checkpoint=object()),
        "MiniBatchKMeans(checkpoint=)": lambda: cluster.MiniBatchKMeans(
            n_clusters=2, random_state=0).partial_fit(
                x, checkpoint=object()),
        "DBSCAN(checkpoint=)": ckpt(lambda: cluster.DBSCAN().fit(
            x, checkpoint=object())),
        "Daura(checkpoint=)": ckpt(lambda: cluster.Daura(cutoff=0.5).fit(
            dst.array(np.zeros((x.shape[0], 12), np.float32)),
            checkpoint=object())),
        "RandomForestClassifier(checkpoint=)": ckpt(
            lambda: trees.RandomForestClassifier(
                n_estimators=2, random_state=0).fit(x, y,
                                                    checkpoint=object())),
        "DecisionTreeRegressor(checkpoint=)": ckpt(
            lambda: trees.DecisionTreeRegressor(random_state=0).fit(
                x, y, checkpoint=object())),
        "CascadeSVM(checkpoint=)": ckpt(
            lambda: classification.CascadeSVM().fit(x, y,
                                                    checkpoint=object())),
        "ALS(checkpoint=)": ckpt(lambda: recommendation.ALS(n_f=2).fit(
            x, checkpoint=object())),
        "SparseArray.T": ckpt(lambda: dst.SparseArray.from_scipy(
            sparse_of(inp_x)).T),
        "IVFIndex.rebind_mesh": ckpt(lambda: retrieval.IVFIndex(
            n_lists=2, random_state=0).fit(x).rebind_mesh(
                type(dst.get_mesh())(1, dst.get_mesh().world,
                                     dst.get_mesh().device))),
        "transpose": lambda: x.T,
        "KMeans(checkpoint=)": lambda: cluster.KMeans(
            n_clusters=2).fit(x, checkpoint=object()),
        "save_model": lambda: dst.save_model(cluster.KMeans(), os.devnull),
    }
    missed = []
    for name, call in calls.items():
        box.clear()
        try:
            call()
        except NotImplementedError:
            # a checkpointed multi-rank fit names A.11
            if "msg" in box and "A.11" not in box["msg"]:
                missed.append(f"{name}: {box['msg']}")
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


def run_a2b2(dst, inp):
    """A.2b's second part: the linear models, MiniBatchKMeans, qr, svd,
    polar, lanczos_svd, kron, the array helpers, KNeighborsClassifier and
    the searches across ranks; where the test holds a call to the port on
    one rank, that call runs here too on ``device="cpu"`` arrays (a mesh
    of one rank in this process)."""
    import torch
    from dislib_tpu_torch import cluster, classification, regression
    from dislib_tpu_torch.model_selection import GridSearchCV
    from dislib_tpu_torch.runtime.health import NumericalDivergence
    from dislib_tpu_torch.utils import faults, profiling
    admm = importlib.import_module("dislib_tpu_torch.optimization.admm")
    qr_mod = importlib.import_module("dislib_tpu_torch.math.qr")
    nb = importlib.import_module("dislib_tpu_torch.neighbors.base")
    rows = dst.get_mesh().rows
    out = {}

    def both(key):
        """The sharded array of input ``key`` and the one-rank one."""
        return dst.array(inp[key]), dst.array(inp[key], device="cpu")

    # -- LinearRegression (two targets) and Lasso/ADMM ----------------------
    (x, x1), (y, y1) = both("x"), both("y")
    lr = regression.LinearRegression().fit(x, y)
    out["lr_coef"], out["lr_intercept"] = lr.coef_, lr.intercept_
    out["lr_score"] = np.float64(lr.score(x, y))
    out["lr_score_async"] = np.float64(lr._score_async(
        lr._fit_async(x, y), x, y))
    pred = lr.predict(x)
    out["lr_pred"], out["lr_pred_block"] = pred.collect(), pred._local.numpy()
    y0 = dst.array(inp["y"][:, :1])
    la = regression.Lasso(**LASSO_KW).fit(x, y0)
    out["lasso_coef"], out["lasso_n_iter"] = la.coef_, np.int64(la.n_iter_)
    out["lasso_score"] = np.float64(la.score(x, y0))
    out["lasso_score_async"] = np.float64(la._score_async(
        la._fit_async(x, y0), x, y0))
    out["lasso_pred"] = la.predict(x).collect()
    agents = admm._agents
    admm._agents = lambda: rows       # one rank, the same agents
    try:
        one = regression.Lasso(**LASSO_KW).fit(
            x1, dst.array(inp["y"][:, :1], device="cpu"))
    finally:
        admm._agents = agents
    out["lasso_one_coef"], out["lasso_one_n_iter"] = (one.coef_,
                                                      np.int64(one.n_iter_))
    # -- MiniBatchKMeans: the same batches as one rank ----------------------
    k, k1 = both("km")
    for name, arr in (("ranks", k), ("one", k1)):
        est = cluster.MiniBatchKMeans(**MBK_KW).fit(arr)
        out[f"mbk_{name}_centers"] = est.centers_
        out[f"mbk_{name}_counts"] = est.counts_
        out[f"mbk_{name}_n_batches"] = np.int64(est.n_batches_)
        out[f"mbk_{name}_history"] = est.history_
    lab = est.predict(k)
    out["mbk_labels"] = lab.collect()
    # a health trip on rank 1 alone trips every rank's stream
    health = faults.TripAtChunk(at_chunk=1, times=9) \
        if dst.get_mesh().rank == 1 else None
    try:
        est = cluster.MiniBatchKMeans(**MBK_KW)
        est.partial_fit(k, health=health)
        est.partial_fit(k)
        out["mbk_trip_guard"] = np.frombuffer(b"none", np.uint8)
    except NumericalDivergence as exc:
        out["mbk_trip_guard"] = np.frombuffer(str(exc.guard).encode(),
                                              np.uint8)
    # -- polar and lanczos_svd against one rank -----------------------------
    a, a1 = both("a")
    for name, arr in (("ranks", a), ("one", a1)):
        u, h, info = dst.polar(arr, info=True)
        out[f"polar_{name}_u"], out[f"polar_{name}_h"] = (u.collect(),
                                                          h.collect())
        out[f"polar_{name}_iters"] = np.int64(info["iterations"])
        if name == "ranks":
            out["polar_u_block"] = u._local.numpy()
    sv, sv1 = both("sv")
    for name, arr in (("ranks", sv), ("one", sv1)):
        u, s_, v = dst.lanczos_svd(arr, k=LANCZOS_K, random_state=0)
        out[f"lz_{name}_u"], out[f"lz_{name}_s"] = u.collect(), s_.collect()
        out[f"lz_{name}_v"] = v.collect()
    # -- qr: the blocked loop (economic, 'r', full) and the fallback --------
    panel = qr_mod._PANEL
    qr_mod._PANEL = QR_PANEL
    try:
        q_in = dst.array(inp["qr"])
        for mode in ("economic", "full"):
            q, r = dst.qr(q_in, mode=mode)
            out[f"qr_{mode}_q"], out[f"qr_{mode}_r"] = q.collect(), r.collect()
            out[f"qr_{mode}_q_block"] = q._local.numpy()
        out["qr_r_only"] = dst.qr(q_in, mode="r").collect()
        w = dst.array(inp["wide"])
        for mode in ("economic", "full"):
            q, r = dst.qr(w, mode=mode)
            out[f"qr_wide_{mode}_q"] = q.collect()
            out[f"qr_wide_{mode}_r"] = r.collect()
    finally:
        qr_mod._PANEL = panel
    # -- svd: the scalar tier and the block tier ----------------------------
    for name, key in (("scalar", "sv"), ("block", "svb")):
        arr = dst.array(inp[key])
        u, s_, v = dst.svd(arr)
        out[f"svd_{name}_u"], out[f"svd_{name}_s"] = u.collect(), s_.collect()
        out[f"svd_{name}_v"] = v.collect()
        out[f"svd_{name}_u_block"] = u._local.numpy()
        out[f"svd_{name}_sweeps"] = np.int64(
            profiling.HOST_READS.get("svd_sweep", 0))
        profiling.HOST_READS.pop("svd_sweep", None)
    # -- kron and the array helpers: NumPy's, bit for bit -------------------
    ka, kb = dst.array(inp["ka"]), dst.array(inp["kb"])
    kr = dst.kron(ka, kb)
    out["kron"], out["kron_block"] = kr.collect(), kr._local.numpy()
    xb = dst.array(inp["x"], block_size=(50, 5))
    short = dst.array(inp["short"])
    cr = dst.concat_rows([x, short, x])
    out["concat_rows"], out["concat_rows_block"] = (cr.collect(),
                                                    cr._local.numpy())
    cc = dst.concat_cols([x, y, x])
    out["concat_cols"], out["concat_cols_block"] = (cc.collect(),
                                                    cc._local.numpy())
    for name, (fn, axis) in {
            "twice1": (lambda v: v * 2.0 + 1.0, 1),
            "max0": (lambda v: torch.max(v), 0),
            "minmax1": (lambda v: torch.stack([v.min(), v.max()]), 1),
            "head0": (lambda v: v[:3], 0)}.items():
        r = dst.apply_along_axis(fn, axis, x)
        out[f"apply_{name}"], out[f"apply_{name}_block"] = (
            r.collect(), r._local.numpy())
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out["apply_host"] = dst.apply_along_axis(
            lambda v: np.sort(np.asarray(v)), 0, x).collect()
    out["apply_host_warned"] = np.int64(len(caught))
    for axis in (0, 1):
        blocks = list(xb.iterator(axis=axis))
        out[f"iter{axis}_n"] = np.int64(len(blocks))
        for i, blk in enumerate(blocks):
            out[f"iter{axis}_{i}"] = blk.collect()
    # -- KNeighborsClassifier: the gathered route, then the ring ------------
    f, fy = dst.array(inp["fit"]), dst.array(inp["fit_y"])
    q, qy = dst.array(inp["q"]), dst.array(inp["q_y"])
    ring_min = nb._RING_MIN
    for route in ("gathered", "ring"):
        nb._RING_MIN = ring_min if route == "gathered" else 64
        try:
            knn = classification.KNeighborsClassifier(n_neighbors=5).fit(
                f, fy)
            pred = knn.predict(q)
            out[f"knn_{route}_pred"] = pred.collect()
            out[f"knn_{route}_pred_block"] = pred._local.numpy()
            out[f"knn_{route}_score"] = np.float64(knn.score(q, qy))
            out[f"knn_{route}_score_async"] = np.float64(knn._score_async(
                knn._fit_async(f, fy), q, qy))
        finally:
            nb._RING_MIN = ring_min
    out["knn_classes"] = knn.classes_
    # -- the searches, each against one rank's, host reads counted ----------
    for name, est, grid, data in (
            ("km", cluster.KMeans(max_iter=5, tol=0.0, random_state=0),
             GS_KM_GRID, ("km", None)),
            ("knn", classification.KNeighborsClassifier(), GS_KNN_GRID,
             ("fit", "fit_y"))):
        for where in ("ranks", "one"):
            dev = None if where == "ranks" else "cpu"
            xs = dst.array(inp[data[0]], device=dev)
            ys = None if data[1] is None else dst.array(inp[data[1]],
                                                        device=dev)
            profiling.reset_host_reads()
            gs = GridSearchCV(est, grid, cv=GS_CV, refit=False)
            gs.fit(xs, ys) if ys is not None else gs.fit(xs)
            reads = dict(profiling.HOST_READS)
            out[f"gs_{name}_{where}_scores"] = np.stack([
                gs.cv_results_[f"split{j}_test_score"]
                for j in range(GS_CV)])
            out[f"gs_{name}_{where}_best"] = np.frombuffer(json.dumps(
                gs.best_params_).encode(), np.uint8)
            out[f"gs_{name}_{where}_reads"] = np.frombuffer(json.dumps(
                reads, sort_keys=True).encode(), np.uint8)
    # -- the other async-trial hooks: GaussianMixture ----------------------
    g = dst.array(inp["gm"])
    gm = cluster.GaussianMixture(covariance_type="diag", **GM_KW)
    state = gm._fit_async(g)
    out["gm_hook_score"] = np.float64(gm._score_async(state, g))
    gm._fit_finalize(state)
    for attr in ("weights_", "means_", "covariances_"):
        out[f"gm_hook_{attr}"] = getattr(gm, attr)
    out["gm_hook_lb"] = np.float64(gm.lower_bound_)
    out["gm_hook_n_iter"] = np.int64(gm.n_iter_)
    out["gm_fit_score"] = np.float64(cluster.GaussianMixture(
        covariance_type="diag", **GM_KW).fit(g).score(g))
    return out


def _wait_for(path, timeout_s=120.0):
    """Wait for ``path`` (the test writes it while the ranks run)."""
    import time
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout_s:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.05)
    return dict(np.load(path))


def run_a2b3(dst, inp, job_dir):
    """A.2b's part (ii): the quantile edges, the decision trees and a
    bootstrap forest (and a search over it), DBSCAN and Daura on the
    ring, dense CascadeSVM, each on the ranks and, where the test holds a
    call to one rank, on ``device="cpu"`` arrays too; a reference forest
    and CascadeSVM carried in from ``job_dir/carry.npz`` (written by the
    test while the ranks run) predict on the sharded queries."""
    import torch
    from dislib_tpu_torch import classification, cluster, trees
    from dislib_tpu_torch.model_selection import GridSearchCV
    from dislib_tpu_torch.runtime.health import NumericalDivergence
    dt = importlib.import_module("dislib_tpu_torch.trees.decision_tree")
    ring = importlib.import_module("dislib_tpu_torch.ops.ring")
    tiled = importlib.import_module("dislib_tpu_torch.ops.tiled")
    mesh = dst.get_mesh()
    out = {}

    def both(key, **kw):
        return dst.array(inp[key], **kw), dst.array(inp[key], device="cpu",
                                                    **kw)

    # -- the quantile edges: exact order statistics across ranks ------------
    ex = dst.array(inp["edges_x"])
    got = dt._quantile_bins(ex._row_block(), ex.shape, TREE_BINS, ex._at[0],
                            mesh)
    out["edges_ranks"] = got.numpy()
    out["edges_one"] = dt._quantile_bins(torch.from_numpy(inp["edges_x"]),
                                         ex.shape, TREE_BINS).numpy()
    # -- the decision trees --------------------------------------------------
    (x, x1) = both("tree_x")
    for name, cls, ykey, kw in (
            ("dtc", trees.DecisionTreeClassifier, "tree_yc", DTC_KW),
            ("dtr", trees.DecisionTreeRegressor, "tree_yr", DTR_KW)):
        y, y1 = both(ykey)
        fits = {}
        for where, xs, ys in (("ranks", x, y), ("one", x1, y1)):
            est = fits[where] = cls(n_bins=TREE_BINS, **kw).fit(xs, ys)
            for attr in ("_edges", "_leaves"):
                out[f"{name}_{where}{attr}"] = getattr(est, attr).numpy()
            for attr in ("_feats", "_tbins"):
                out[f"{name}_{where}{attr}"] = getattr(est, attr)
            pred = est.predict(xs)
            out[f"{name}_{where}_pred"] = pred.collect()
            out[f"{name}_{where}_score"] = np.float64(est.score(xs, ys))
        out[f"{name}_pred_block"] = fits["ranks"].predict(x)._local.numpy()
    # -- a bootstrap forest: the one-rank forest, bit for bit ---------------
    y, y1 = both("tree_yc")
    fits = {}
    for where, xs, ys in (("ranks", x, y), ("one", x1, y1)):
        rf = fits[where] = trees.RandomForestClassifier(**FOREST_KW).fit(
            xs, ys)
        for attr in ("_edges", "_leaves"):
            out[f"rf_{where}{attr}"] = getattr(rf, attr).numpy()
        for attr in ("_feats", "_tbins"):
            out[f"rf_{where}{attr}"] = getattr(rf, attr)
        proba = rf.predict_proba(xs)
        out[f"rf_{where}_proba"] = proba.collect()
        out[f"rf_{where}_score"] = np.float64(rf.score(xs, ys))
        est = trees.RandomForestClassifier(**FOREST_KW)
        out[f"rf_{where}_score_async"] = np.float64(est._score_async(
            est._fit_async(xs, ys), xs, ys))
        gs = GridSearchCV(trees.RandomForestClassifier(**FOREST_KW),
                          FOREST_GRID, cv=GS_CV, refit=False).fit(xs, ys)
        out[f"rf_{where}_gs"] = np.stack([
            gs.cv_results_[f"split{j}_test_score"] for j in range(GS_CV)])
    out["rf_proba_block"] = fits["ranks"].predict_proba(x)._local.numpy()
    # -- the carried reference forest and CascadeSVM ------------------------
    carry = _wait_for(os.path.join(job_dir, "carry.npz"))
    rf = trees.from_fitted_arrays(trees.RandomForestClassifier, {
        k[3:]: v for k, v in carry.items() if k.startswith("rf_")})
    out["carried_rf_pred"] = rf.predict(x).collect()
    out["carried_rf_proba"] = rf.predict_proba(x).collect()
    sv = trees.from_fitted_arrays(classification.CascadeSVM, {
        k[3:]: v for k, v in carry.items() if k.startswith("sv_")})
    q = dst.array(inp["csvm_q"])
    out["carried_sv_dec"] = sv.decision_function(q).collect()
    out["carried_sv_pred"] = sv.predict(q).collect()
    # -- DBSCAN and Daura on the ring ---------------------------------------
    tile, block = ring.RING_TILE, tiled.BLOCK_BYTES
    ring.RING_TILE, tiled.BLOCK_BYTES = RING_TILE, 4 * RING_TILE * 3 * RING_TILE
    try:
        d, d1 = both("db")
        for where, xs in (("ranks", d), ("one", d1)):
            est = cluster.DBSCAN(eps=DB_EPS, min_samples=DB_MIN).fit(xs)
            out[f"db_{where}_labels"] = est.labels_
            out[f"db_{where}_core"] = est.core_sample_indices_
            out[f"db_{where}_n"] = np.int64(est.n_clusters_)
        lab = cluster.DBSCAN(eps=DB_EPS, min_samples=DB_MIN).fit_predict(d)
        out["db_fit_predict"], out["db_fit_predict_block"] = (
            lab.collect(), lab._local.numpy())
        f, f1 = both("da")
        for where, xs in (("ranks", f), ("one", f1)):
            est = cluster.Daura(cutoff=DA_CUT).fit(xs)
            out[f"da_{where}_labels"] = est.labels_
            out[f"da_{where}_clusters"] = np.concatenate(
                [np.r_[len(c), c] for c in est.clusters_])
        # a NaN in a row of mesh row 1: its ranks trip on their input, the
        # others as peers, and no rank is left in the ring
        bad = inp["db"].copy()
        q_ = np.lcm(mesh.rows, mesh.cols)
        bad[max(q_, -(-len(bad) // q_) * q_) // mesh.rows] = np.nan
        try:
            cluster.DBSCAN(eps=DB_EPS, min_samples=DB_MIN).fit(
                dst.array(bad))
            out["db_trip_guard"] = np.frombuffer(b"none", np.uint8)
        except NumericalDivergence as exc:
            out["db_trip_guard"] = np.frombuffer(str(exc.guard).encode(),
                                                 np.uint8)
        # the dense and tiled tiers need every row on one rank
        dbscan = importlib.import_module("dislib_tpu_torch.cluster.dbscan")
        dbscan._RING = False
        try:
            cluster.DBSCAN(eps=DB_EPS, min_samples=DB_MIN).fit(d)
            out["db_no_ring"] = np.frombuffer(b"ran", np.uint8)
        except NotImplementedError:
            out["db_no_ring"] = np.frombuffer(b"raised", np.uint8)
        finally:
            dbscan._RING = None
    finally:
        ring.RING_TILE, tiled.BLOCK_BYTES = tile, block
    # -- dense CascadeSVM: the one-rank cascade -----------------------------
    blk = (CSVM_BLOCK, CSVM_SHAPE[1])
    (cx, cx1), (cy, cy1) = both("csvm_x", block_size=blk), both("csvm_y")
    (q, q1) = both("csvm_q")
    for kernel in ("rbf", "linear"):
        fits = {}
        for where, xs, ys, qs in (("ranks", cx, cy, q), ("one", cx1, cy1,
                                                          q1)):
            est = fits[where] = classification.CascadeSVM(kernel=kernel,
                                             max_iter=CSVM_ITERS).fit(xs, ys)
            key = f"sv_{kernel}_{where}"
            out[f"{key}_idx"], out[f"{key}_alpha"] = (est._sv_idx,
                                                      est._sv_alpha)
            out[f"{key}_n_iter"] = np.int64(est.n_iter_)
            out[f"{key}_dec"] = est.decision_function(qs).collect()
            out[f"{key}_pred"] = est.predict(qs).collect()
            out[f"{key}_score"] = np.float64(est.score(xs, ys))
        out[f"sv_{kernel}_dec_block"] = fits["ranks"].decision_function(
            q)._local.numpy()
    return out


def run_a2c(dst, inp, job_dir):
    """A.2c: the sparse ds-array and its ShardedSparse shard, SpMM, the
    densify route and the sparse scaler, sparse KMeans, the sparse kNN,
    ALS (dense and sparse), the IVF index and sparse CascadeSVM across
    ranks; where the test holds a call to one rank, that call runs here
    too on ``device="cpu"`` arrays."""
    import torch
    from dislib_tpu_torch import classification, preprocessing, retrieval
    from dislib_tpu_torch.base import from_fitted_arrays
    from dislib_tpu_torch.cluster import KMeans
    from dislib_tpu_torch.neighbors import NearestNeighbors
    from dislib_tpu_torch.recommendation import ALS
    als_mod = importlib.import_module("dislib_tpu_torch.recommendation.als")
    spmm_mod = importlib.import_module("dislib_tpu_torch.ops.spmm")
    mesh = dst.get_mesh()
    out = {}
    mat = sparse_of(inp["sp_x"])
    x = dst.SparseArray.from_scipy(mat)
    c = x.collect()
    out["sp_indptr"], out["sp_indices"], out["sp_data"] = (
        c.indptr, c.indices, c.data)
    out["sp_local"] = np.stack([x._rows.numpy(), x._cols.numpy(),
                                x._vals.view(torch.int32).numpy()])
    rep = x.sharded()
    for name in ("data", "lrows", "cols"):
        out[f"sh_{name}"] = getattr(rep, name).numpy()
    out["sh_counts"] = rep.counts_dev.numpy()
    pv = rep.panel_view(2, 20)
    for name in ("data", "lrows", "cols", "counts_dev"):
        out[f"pv_{name}"] = getattr(pv, name).numpy()
    d = x.to_dense()
    out["sp_dense"], out["sp_dense_block"] = d.collect(), d._local.numpy()
    for axis in (0, 1, None):
        out[f"sp_sum_{axis}"] = x.sum(axis).collect()
        out[f"sp_mean_{axis}"] = x.mean(axis).collect()
    out["sp_rows"] = x[np.array([5, 200, 0, 77, 77])].collect().toarray()
    xs = dst.shuffle(x, random_state=3)
    out["sp_shuffle"] = xs.collect().toarray()
    sc = preprocessing.StandardScaler(with_mean=False).fit(x)
    out["sp_sc_mean"], out["sp_sc_var"] = (sc.mean_.collect(),
                                           sc.var_.collect())
    out["sp_sc_t"] = sc.transform(x).collect().toarray()
    # the densify route into an estimator with no sparse path
    out["sp_lr_coef"] = dst.LinearRegression().fit(
        x, dst.array(inp["sp_x"][:, :2].sum(1, keepdims=True))).coef_
    # -- SpMM: both layouts and schedules, two panel counts -----------------
    b = dst.array(inp["sp_b"])
    for panels in SP_PANELS:
        for lay in ("slots", "masked"):
            for sched in ("db", "seq"):
                r = spmm_mod.spmm(x, b, panels=panels, layout=lay,
                                  overlap=sched)
                key = f"spmm_{panels}_{lay}_{sched}"
                out[key], out[f"{key}_block"] = r.collect(), r._local.numpy()
        out[f"spmm_{panels}_again"] = spmm_mod.spmm(
            x, b, panels=panels).collect()
    # B's columns in slices: a BLOCK_BYTES that holds the products of three
    # columns of the sparsest panel of any rank, so every panel folds in
    # slices of one to three columns, the last one short
    block, fold = spmm_mod.BLOCK_BYTES, spmm_mod._fold
    for panels in SP_PANELS:
        steps = spmm_mod._fit_steps(panels, b._pshape[0])
        cnt = x.sharded().panel_counts(steps, b._pshape[0] // steps)
        widths = []

        def counted(*args):
            widths.append(args[3].shape[1])
            return fold(*args)
        spmm_mod.BLOCK_BYTES = 4 * 3 * int(cnt[cnt > 0].min())
        spmm_mod._fold = counted
        try:
            out[f"spmm_{panels}_sliced"] = spmm_mod.spmm(
                x, b, panels=panels).collect()
        finally:
            spmm_mod.BLOCK_BYTES, spmm_mod._fold = block, fold
        out[f"spmm_{panels}_sliced_widths"] = np.array(widths, np.int64)
        out[f"spmm_{panels}_sliced_steps"] = np.int64(steps)
    out["spmm_n_local"] = np.int64(b._local.shape[1])
    out["spmm_matmul"] = dst.matmul(x, b).collect()
    out["spmm_densify"] = dst.matmul(x, b, algorithm="densify").collect()
    # -- sparse KMeans --------------------------------------------------------
    kx = dst.SparseArray.from_scipy(sparse_of(inp["skm"]))
    km = KMeans(n_clusters=SKM_K, random_state=0, max_iter=20,
                tol=1e-4).fit(kx)
    out["skm_centers"], out["skm_inertia"] = km.centers_, np.float64(
        km.inertia_)
    out["skm_n_iter"] = np.int64(km.n_iter_)
    lab = km.predict(kx)
    out["skm_labels"], out["skm_labels_block"] = (lab.collect(),
                                                  lab._local.numpy())
    out["skm_score"] = np.float64(km.score(kx))
    # -- the sparse kNN: sparse and dense queries ----------------------------
    f = dst.SparseArray.from_scipy(sparse_of(inp["fit"] * (inp["fit"] > 0.3)))
    qd = inp["q"] * (inp["q"] > 0.3)
    for name, q in (("sparse", dst.SparseArray.from_scipy(sparse_of(qd))),
                    ("dense", dst.array(qd))):
        dist, idx = NearestNeighbors(n_neighbors=NN_K).fit(f).kneighbors(q)
        out[f"sknn_{name}_dist"], out[f"sknn_{name}_idx"] = (dist.collect(),
                                                            idx.collect())
        out[f"sknn_{name}_idx_block"] = idx._local.numpy()
    # -- ALS: dense against the reference, sparse against its oracle --------
    v0 = np.load(os.path.join(job_dir, "als_v0.npy"))
    als_mod._draw_items = lambda seed, n, n_f, device: torch.from_numpy(
        v0[:n]).to(device)
    r_h = inp["als"]
    for name, arr in (("dense", dst.array(r_h)),
                      ("sparse", dst.SparseArray.from_scipy(sparse_of(r_h))),
                      ("sparse_one", dst.SparseArray.from_scipy(
                          sparse_of(r_h), device="cpu")),
                      ("densified", dst.SparseArray.from_scipy(
                          sparse_of(r_h)).to_dense())):
        est = ALS(**ALS_KW).fit(arr)
        out[f"als_{name}_users"], out[f"als_{name}_items"] = (est.users_,
                                                            est.items_)
        out[f"als_{name}_history"] = est.history_
        out[f"als_{name}_n_iter"] = np.int64(est.n_iter_)
    out["als_fold_in"] = est.fold_in(sparse_of(r_h[:5]))
    # -- the IVF index: the reference's layout, its search and a carry ------
    ref = _wait_for(os.path.join(job_dir, "ivf.npz"))
    items, q = inp["ivf"], dst.array(inp["ivf_q"])
    ix = retrieval.IVFIndex(n_lists=IVF_LISTS, nprobe=IVF_PROBE)._build(
        items, ref["labels"], ref["centers"])
    out["ivf_pad_waste"] = np.frombuffer(json.dumps(
        ix.pad_waste, sort_keys=True).encode(), np.uint8)
    for name in ("_vecs", "_ids", "_vsq", "_offs", "_cnts"):
        out[f"ivf{name}"] = getattr(ix, name).numpy()
    for nprobe in (IVF_PROBE, IVF_LISTS):
        for sched in ("db", "seq", "kernel"):
            dist, idx = ix.search(q, k=IVF_K, nprobe=nprobe, overlap=sched)
            key = f"ivf_{nprobe}_{sched}"
            out[f"{key}_dist"], out[f"{key}_idx"] = (dist.collect(),
                                                     idx.collect())
    out["ivf_idx_block"] = idx._local.numpy()
    carried = from_fitted_arrays(retrieval.IVFIndex, {
        "_items_h": items, "_labels_h": ref["labels"],
        "_centers_h": ref["centers"]}, nprobe=IVF_PROBE)
    dist, idx = carried.search(q, k=IVF_K)
    out["ivf_carried_dist"], out["ivf_carried_idx"] = (dist.collect(),
                                                       idx.collect())
    fitted = retrieval.IVFIndex(n_lists=IVF_LISTS, random_state=0).fit(
        dst.array(items))
    dist, idx = fitted.search(q, k=IVF_K, nprobe=IVF_LISTS)
    out["ivf_fit_exact_dist"], out["ivf_fit_exact_idx"] = (dist.collect(),
                                                           idx.collect())
    # -- sparse CascadeSVM: ELL staging, then the host CSR ------------------
    blk = (SSV_BLOCK, SSV_SHAPE[1])
    smat = sparse_of(inp["ssv"])
    for staging in ("ell", "csr"):
        saved = os.environ.get("DSLIB_SPARSE_ELL_BUDGET")
        if staging == "csr":
            os.environ["DSLIB_SPARSE_ELL_BUDGET"] = "1"
        try:
            for where, dev in (("ranks", None), ("one", "cpu")):
                sx = dst.SparseArray.from_scipy(smat, block_size=blk,
                                                device=dev)
                est = classification.CascadeSVM(max_iter=CSVM_ITERS).fit(
                    sx, dst.array(inp["ssv_y"], device=dev))
                key = f"ssv_{staging}_{where}"
                out[f"{key}_idx"], out[f"{key}_alpha"] = (est._sv_idx,
                                                          est._sv_alpha)
                out[f"{key}_n_iter"] = np.int64(est.n_iter_)
                out[f"{key}_dec"] = est.decision_function(sx).collect()
                out[f"{key}_score"] = np.float64(est.score(
                    sx, dst.array(inp["ssv_y"], device=dev)))
        finally:
            if saved is None:
                os.environ.pop("DSLIB_SPARSE_ELL_BUDGET", None)
            else:
                os.environ["DSLIB_SPARSE_ELL_BUDGET"] = saved
    del mesh
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
    out.update(run_a2b2(dst, inp))
    out.update(run_a2b3(dst, inp, out_dir))
    out.update(run_a2c(dst, inp, out_dir))
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
