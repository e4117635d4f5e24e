"""The port's mesh of ranks, in one process.

- the mesh: shapes, ``pad_quantum``, each rank's coordinate and the rank
  lists of its 'rows' and 'cols' groups (``distributed.grid_groups`` with
  ``new_group`` recorded), and the block geometry of a ds-array;
- the central guard: ``Array._data`` raises on a mesh of several ranks;
- ``initialize``: no job without a launch variable, the backend rule,
  the one-rank-per-card check of NCCL, and ``init()``'s default mesh;
- a gloo job of ONE rank (a FileStore under ``tmp_path``): SUMMA, KMeans,
  the ring, tsqr, GaussianMixture, random_svd, PCA, a scaler, the linear
  models, MiniBatchKMeans, qr, svd, polar, lanczos_svd, a forest, a
  regression tree, DBSCAN and Daura on the ring, CascadeSVM (dense and
  sparse), sparse KMeans, the sparse kNN, ALS (dense and sparse) and the
  IVF index run their collectives over groups of one, and must be
  bit-equal to the same calls with no process group;
- the ``random_array`` draw: the same logical values at the pad quanta
  of the (1, 1), (2, 2) and (4, 1) meshes;
- the exchange plan of the shuffle: the reference's ``_routing`` plan.
"""

import importlib
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dislib_tpu.utils import base as ref_utils

import dislib_tpu_torch as dst
from dislib_tpu_torch.cluster import KMeans
from dislib_tpu_torch.ops import ring as port_ring
from dislib_tpu_torch.parallel import distributed as dd
from dislib_tpu_torch.parallel import mesh as port_mesh

# the module (``dislib_tpu_torch.data.array`` is also the function's name)
port_array = importlib.import_module("dislib_tpu_torch.data.array")
port_qr = importlib.import_module("dislib_tpu_torch.math.qr")
port_dbscan = importlib.import_module("dislib_tpu_torch.cluster.dbscan")
port_daura = importlib.import_module("dislib_tpu_torch.cluster.daura")


@pytest.fixture(autouse=True)
def _port_on_cpu():
    dst.init(device="cpu")
    yield
    dd.shutdown()


def _fake_mesh(rows, cols, rank):
    """A grid mesh as one rank of a job sees it, without the job (the
    blocks' geometry needs no collective)."""
    return port_mesh.Mesh(rows, cols, torch.device("cpu"), rank, groups={})


@pytest.mark.parametrize("shape,quantum", [((1, 1), 1), ((2, 2), 2),
                                           ((4, 1), 4), ((2, 3), 6),
                                           ((4, 2), 4)])
def test_pad_quantum_is_lcm(shape, quantum):
    assert port_mesh.pad_quantum(_fake_mesh(*shape, 0)) == quantum


@pytest.mark.parametrize("rows,cols", [(2, 2), (4, 1), (2, 3), (1, 4)])
def test_grid_groups_map_coordinates_and_axes(rows, cols, monkeypatch):
    made = []
    monkeypatch.setattr(dist, "new_group", lambda ranks: made.append(
        tuple(ranks)) or tuple(ranks))
    for rank in range(rows * cols):
        made.clear()
        monkeypatch.setattr(dist, "get_rank", lambda: rank)
        dd._GROUPS.clear()
        groups = dd.grid_groups(rows, cols)
        r, c = divmod(rank, cols)
        assert _fake_mesh(rows, cols, rank).coord == (r, c)
        # 'rows' is the ranks that share this rank's column, 'cols' those
        # that share its row: the groups of lax.psum(x, 'rows') / 'cols'
        assert groups["rows"].ranks == tuple(i * cols + c for i in range(rows))
        assert groups["rows"].index == r
        assert groups["cols"].ranks == tuple(r * cols + j for j in range(cols))
        assert groups["cols"].index == c
        assert groups[dd.ALL].ranks == tuple(range(rows * cols))
        # every rank makes every group, in one order
        assert made == [tuple(i * cols + j for i in range(rows))
                        for j in range(cols)] + \
            [tuple(i * cols + j for j in range(cols)) for i in range(rows)]
    dd._GROUPS.clear()


def test_block_geometry_and_the_data_guard():
    mesh = _fake_mesh(2, 2, 3)
    block = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    a = port_array.Array(block, (5, 7), mesh)
    assert a._pshape == (6, 8)
    assert a._at == (3, 4)
    assert a._local is block
    with pytest.raises(NotImplementedError, match="A.11"):
        a._data
    with pytest.raises(NotImplementedError, match="A.11"):
        a.T
    # column indexing still needs the transpose's exchange (the iterator,
    # which raised here before A.2b's second part, runs across ranks now)
    with pytest.raises(NotImplementedError, match="A.11"):
        a[:, 1:3]
    # the pad of a block is zeroed by its global position
    got = port_array._zero_pad(torch.ones(3, 4), (5, 7), (3, 4))
    want = torch.zeros(3, 4)
    want[:2, :3] = 1
    assert torch.equal(got, want)
    # a value placed at a global offset lands in the blocks that hold it
    vals = torch.arange(1, 8, dtype=torch.float32).reshape(1, 7)
    blocks = [port_array._block_with(vals, (0, 0), (5, 7),
                                     _fake_mesh(2, 2, r)) for r in range(4)]
    whole = torch.cat([torch.cat(blocks[:2], 1), torch.cat(blocks[2:], 1)])
    want = torch.zeros(6, 8)
    want[0, :7] = vals
    assert torch.equal(whole, want)


def test_a_grid_mesh_needs_a_job():
    with pytest.raises(NotImplementedError, match="A.2"):
        dst.init((2, 2), device="cpu")
    with pytest.raises(NotImplementedError, match="A.2"):
        port_ring.ring_kneighbors(torch.zeros((4, 2)), torch.zeros((4, 2)),
                                  port_mesh.Mesh(2, 1, torch.device("cpu")),
                                  1, 4)


def test_initialize_without_a_job_is_a_no_op(monkeypatch):
    for name in ("DSLIB_COORDINATOR", "DSLIB_NUM_PROCS", "DSLIB_PROC_ID",
                 "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert dd.initialize() is False
    assert not dd.is_initialized()
    assert dd.process_info() == (0, 1)
    with pytest.raises(ValueError, match="coordinator"):
        dd.initialize(num_processes=2, process_id=0)
    with pytest.raises(ValueError, match="process_id"):
        dd.initialize("localhost:1", 2, 5, device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        dd.initialize("localhost:1", 2, 0, backend="nccl", device="cpu")
    assert not dd.is_initialized()


def test_two_nccl_ranks_on_one_card_raise():
    class Store(dict):
        def set(self, k, v):
            self[k] = v.encode()

        def get(self, k):
            return self[k]

    store = Store()
    store.set("dslib/card/1", "host/GPU-0")
    with pytest.raises(RuntimeError, match="one card"):
        dd._check_one_rank_per_card(store, 0, 2, "host/GPU-0")
    store.set("dslib/card/1", "host/GPU-1")
    dd._check_one_rank_per_card(store, 0, 2, "host/GPU-0")


def _one_rank_results():
    """SUMMA under both policies, a KMeans fit and predict, and the ring's
    one step, on the default mesh."""
    rng = np.random.RandomState(0)
    a = dst.array(rng.randn(40, 24).astype(np.float32))
    b = dst.array(rng.randn(24, 33).astype(np.float32))
    out = {pol: dst.matmul(a, b, algorithm="summa", precision=pol).collect()
           for pol in ("float32", "bfloat16")}
    x = dst.array(rng.rand(120, 6).astype(np.float32))
    km = KMeans(n_clusters=3, random_state=0, max_iter=8, tol=0).fit(x)
    out["centers"] = km.centers_
    out["labels"] = km.predict(x).collect()
    out["score"] = np.float64(km.score(x))
    f = torch.from_numpy(rng.rand(50, 6).astype(np.float32))
    q = torch.from_numpy(rng.rand(17, 6).astype(np.float32))
    d2, idx = port_ring.ring_kneighbors(q, f, dst.get_mesh(), 4, 50)
    out["ring_d2"], out["ring_idx"] = d2.numpy(), idx.numpy()
    # A.2b's first part: tsqr (CholeskyQR2, its route agreed across the
    # ranks), GaussianMixture, random_svd, PCA and the scalers
    saved = os.environ.get("DSLIB_TSQR_CHOLQR")
    os.environ["DSLIB_TSQR_CHOLQR"] = "1"
    try:
        qq, rr = dst.tsqr(a)
    finally:
        if saved is None:
            os.environ.pop("DSLIB_TSQR_CHOLQR", None)
        else:
            os.environ["DSLIB_TSQR_CHOLQR"] = saved
    out["tsqr_q"], out["tsqr_r"] = qq.collect(), rr.collect()
    gm = dst.GaussianMixture(n_components=3, random_state=0, max_iter=4,
                             tol=0).fit(x)
    out["gm_means"], out["gm_covs"] = gm.means_, gm.covariances_
    out["gm_score"] = np.float64(gm.score(x))
    out["rsvd_s"] = dst.random_svd(a, nsv=3, random_state=0)[1].collect()
    out["pca_t"] = dst.PCA(n_components=2).fit_transform(x).collect()
    out["scaled"] = dst.StandardScaler().fit_transform(x).collect()
    # A.2b's second part: the linear models, MiniBatchKMeans, the panel
    # QR (its panel shrunk so the loop runs), svd, polar and lanczos_svd
    y = dst.array(rng.rand(120, 1).astype(np.float32))
    lr = dst.LinearRegression().fit(x, y)
    out["lr_coef"], out["lr_score"] = lr.coef_, np.float64(lr.score(x, y))
    la = dst.Lasso(lmbd=0.5, rho=5.0).fit(x, y)
    out["lasso_coef"], out["lasso_n_iter"] = la.coef_, np.int64(la.n_iter_)
    mbk = dst.MiniBatchKMeans(n_clusters=3, batch_size=32,
                              random_state=0).fit(x)
    out["mbk_centers"] = mbk.centers_
    panel = port_qr._PANEL
    port_qr._PANEL = 8
    try:
        w = dst.array(rng.randn(60, 20).astype(np.float32))
        out["qr_q"], out["qr_r"] = (t.collect() for t in dst.qr(
            w, mode="economic"))
    finally:
        port_qr._PANEL = panel
    out["svd_s"] = dst.svd(w)[1].collect()
    out["polar_u"] = dst.polar(w)[0].collect()
    out["lanczos_s"] = dst.lanczos_svd(w, k=3, random_state=0)[1].collect()
    # A.2b's part (ii): a bootstrap forest and a regression tree, DBSCAN
    # and Daura on the ring, CascadeSVM
    yc = dst.array((rng.rand(120, 1) > 0.5).astype(np.float32))
    rf = dst.RandomForestClassifier(n_estimators=3, max_depth=3,
                                    random_state=0).fit(x, yc)
    out["rf_leaves"], out["rf_feats"] = rf._leaves.numpy(), rf._feats
    out["rf_proba"] = rf.predict_proba(x).collect()
    dtr = dst.DecisionTreeRegressor(max_depth=3).fit(x, y)
    out["dtr_leaves"] = dtr._leaves.numpy()
    out["dtr_score"] = np.float64(dtr.score(x, y))
    saved = port_dbscan._RING, port_daura._RING
    port_dbscan._RING = port_daura._RING = True
    try:
        out["db_labels"] = dst.DBSCAN(eps=0.3, min_samples=4).fit(x).labels_
        out["da_labels"] = dst.Daura(cutoff=0.3).fit(dst.array(
            rng.rand(60, 6).astype(np.float32))).labels_
    finally:
        port_dbscan._RING, port_daura._RING = saved
    sv = dst.CascadeSVM(max_iter=2).fit(
        dst.array(rng.rand(120, 6).astype(np.float32), block_size=(32, 6)),
        yc)
    out["sv_alpha"], out["sv_idx"] = sv._sv_alpha, sv._sv_idx
    out["sv_dec"] = sv.decision_function(x).collect()
    # A.2c: SpMM, sparse KMeans, the sparse kNN, ALS (dense and sparse),
    # the IVF index and sparse CascadeSVM
    import scipy.sparse as sp
    mat = sp.random(90, 12, density=0.3, random_state=1, dtype=np.float32,
                    format="csr")
    xs = dst.SparseArray.from_scipy(mat)
    out["spmm"] = dst.matmul(xs, dst.array(rng.randn(12, 5).astype(
        np.float32))).collect()
    skm = KMeans(n_clusters=3, random_state=0, max_iter=5, tol=0).fit(xs)
    out["skm_centers"], out["skm_labels"] = (skm.centers_,
                                             skm.predict(xs).collect())
    d, i = dst.NearestNeighbors(n_neighbors=3).fit(xs).kneighbors(xs[:7])
    out["sknn_d"], out["sknn_i"] = d.collect(), i.collect()
    for name, arr in (("als_sparse", xs), ("als_dense", xs.to_dense())):
        als = dst.ALS(n_f=2, max_iter=3, tol=0, random_state=0).fit(arr)
        out[f"{name}_u"], out[f"{name}_v"] = als.users_, als.items_
    ix = dst.IVFIndex(n_lists=4, nprobe=2, random_state=0).fit(x)
    for ov in ("db", "kernel"):
        d, i = ix.search(x[:9], k=3, overlap=ov)
        out[f"ivf_{ov}_d"], out[f"ivf_{ov}_i"] = d.collect(), i.collect()
    ssv = dst.CascadeSVM(max_iter=2).fit(dst.SparseArray.from_scipy(
        sp.csr_matrix(rng.rand(120, 6).astype(np.float32)
                      * (rng.rand(120, 6) > 0.4)), block_size=(32, 6)), yc)
    out["ssv_alpha"], out["ssv_idx"] = ssv._sv_alpha, ssv._sv_idx
    return out


def test_a_gloo_world_of_one_is_bit_equal_to_no_job(tmp_path):
    plain = _one_rank_results()
    assert dd.initialize(f"file://{tmp_path / 'store'}", 1, 0,
                         device="cpu", timeout=30)
    try:
        mesh = dst.init()
        assert (mesh.rows, mesh.cols, mesh.backend) == (1, 1, "gloo")
        assert mesh.groups is not None
        dd.reset_comm_stats()
        job = _one_rank_results()
        comm = dd.comm_stats()
        with pytest.raises(ValueError, match="needs 2 ranks"):
            dst.init((2, 1))
    finally:
        dd.shutdown()
    # the collectives ran, over groups of one rank
    assert comm["broadcast"]["calls"] == 4 and comm["psum"]["calls"] > 8
    assert comm["all_gather"]["calls"] > 0 and comm["pmax"]["calls"] > 0
    assert comm["reduce_scatter"]["calls"] > 0 \
        and comm["all_to_all"]["calls"] > 0
    for key, want in plain.items():
        np.testing.assert_array_equal(job[key], want, err_msg=key)
    assert not dd.is_initialized()


def test_dslib_mesh_is_read_in_a_job(tmp_path, monkeypatch):
    monkeypatch.setenv("DSLIB_MESH", "1,1")
    assert dd.initialize(f"file://{tmp_path / 'store'}", 1, 0,
                         device="cpu", timeout=30)
    try:
        assert port_mesh.mesh_shape(dst.init()) == (1, 1)
        monkeypatch.setenv("DSLIB_MESH", "1,2")
        with pytest.raises(ValueError, match="needs 2 ranks"):
            dst.init()
    finally:
        dd.shutdown()


@pytest.mark.parametrize("quantum", [1, 2, 4])
def test_random_array_draw_does_not_depend_on_the_quantum(quantum):
    shape = (37, 11)
    base = port_array._random_uniform(5, shape, shape, torch.float32,
                                      torch.device("cpu"))
    pshape = port_array._padded_shape(shape, quantum)
    got = port_array._random_uniform(5, pshape, shape, torch.float32,
                                     torch.device("cpu"))
    assert tuple(got.shape) == pshape
    assert torch.equal(got[:37, :11], base)
    assert not got[37:].any() and not got[:, 11:].any()
    # the one-rank array is that draw
    np.testing.assert_array_equal(
        dst.random_array(shape, random_state=5).collect(), base.numpy())


@pytest.mark.parametrize("m,p", [(12, 4), (203, 2), (64, 8)])
def test_exchange_plan_is_the_references(m, p):
    perm = np.random.RandomState(m).permutation(m)
    m_loc = -(-m // p)
    want = ref_utils._routing(perm, m_loc, p)
    got = port_array._routing(perm, m_loc, m_loc, p)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # a gather of fewer rows: every row lands once, in order
    src = perm[: m // 3]
    send, dst_idx = port_array._routing(src, m_loc, -(-len(src) // p), p)
    rows = np.full(p * -(-len(src) // p) + 1, -1)
    for s in range(p):
        for d in range(p):
            live = dst_idx[d, s] < -(-len(src) // p)
            rows[d * -(-len(src) // p) + dst_idx[d, s][live]] = \
                s * m_loc + send[s, d][live]
    np.testing.assert_array_equal(rows[: len(src)], src)
