"""The port's sparse ds-array, SpMM, sparse svmlight ingest, sparse matmul
routes and sparse KMeans against the reference's, on CPU.

The same scipy matrices (drawn with a seed) go through ``dislib_tpu`` (8
virtual CPU devices) and ``dislib_tpu_torch`` on the CPU.  Tolerances:
structure (shape, nnz, positions) exactly; values that are one float32
operation of the same inputs exactly; float32 sums that run in another
order (row and column sums, SpMM, densify-then-GEMM) within 1e-5 of the
reference's (relative) and within ``ERROR_BOUNDS[("matmul", policy)]`` of
a float64 NumPy product; sparse KMeans' centers within 1e-5, its labels
and ``n_iter_`` exactly (blobs far apart: no row near a tie).
"""

import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import dislib_tpu as ds
from dislib_tpu.cluster import KMeans as RefKMeans
from dislib_tpu.data import sparse as ref_sparse
from dislib_tpu.data.sparse import SparseArray as RefSparse
from dislib_tpu.ops import precision as ref_px
from dislib_tpu.ops.spmm import spmm as ref_spmm

import dislib_tpu_torch as dst
from dislib_tpu_torch.cluster import KMeans as PortKMeans
from dislib_tpu_torch.data import sparse as port_sparse
from dislib_tpu_torch.data.sparse import SparseArray as PortSparse
from dislib_tpu_torch.ops import kernels as port_k
from dislib_tpu_torch.ops import precision as port_px
from dislib_tpu_torch.ops.spmm import spmm as port_spmm
from dislib_tpu_torch.utils import profiling as prof


@pytest.fixture(autouse=True)
def _port_on_cpu():
    dst.init(device="cpu")
    port_k.reset_launches()
    prof.reset_host_reads()
    yield


def _mat(m=37, n=23, density=0.15, seed=0):
    return sp.random(m, n, density=density, random_state=seed,
                     dtype=np.float32, format="csr")


def _both(mat, **kw):
    return RefSparse.from_scipy(mat, **kw), PortSparse.from_scipy(mat, **kw)


def _dense(a):
    return np.asarray(a.collect())


def _close(got, want, rtol=1e-5):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(1.0, np.abs(want).max()))


# -- the SparseArray API ---------------------------------------------------------

def test_metadata_collect_and_to_dense():
    mat = _mat()
    ref, port = _both(mat, block_size=(8, 5))
    assert port.shape == ref.shape and port.nnz == ref.nnz == mat.nnz
    assert port.block_size == ref.block_size == (8, 5)
    assert str(port.dtype).endswith(str(ref.dtype))
    assert port.device.type == "cpu"
    got, want = port.collect(), ref.collect()
    assert sp.issparse(got) and got.format == "csr"
    np.testing.assert_array_equal(got.toarray(), want.toarray())
    assert isinstance(port.to_dense(), dst.Array)
    np.testing.assert_array_equal(_dense(port.to_dense()),
                                  _dense(ref.to_dense()))
    np.testing.assert_array_equal(port._data.numpy(),
                                  np.asarray(ref.to_dense().collect()))
    x = mat.toarray()
    rd, pd = RefSparse.from_dense(x), PortSparse.from_dense(x)
    assert pd.nnz == rd.nnz and pd.block_size == rd.block_size
    np.testing.assert_array_equal(pd.collect().toarray(),
                                  rd.collect().toarray())
    assert repr(port).startswith("dslib.SparseArray(shape=(37, 23)")


@pytest.mark.parametrize("key", [
    (slice(3, 20), slice(None)), ([5, 1, 30], slice(2, 9)), 4,
    (slice(None), [0, 7, 22]), (np.arange(37) % 3 == 0, slice(None)),
    (slice(0, 37, 4), 3)])
def test_getitem_matches_reference(key):
    ref, port = _both(_mat(seed=1))
    r, p = ref[key], port[key]
    assert isinstance(p, PortSparse) and p.shape == r.shape
    np.testing.assert_array_equal(p.collect().toarray(),
                                  r.collect().toarray())


@pytest.mark.parametrize("axis", [0, 1, None])
def test_sum_mean_match_reference(axis):
    ref, port = _both(_mat(seed=2))
    for op in ("sum", "mean"):
        got = getattr(port, op)(axis)
        assert isinstance(got, dst.Array)
        _close(_dense(got), _dense(getattr(ref, op)(axis)))


def test_elementwise_ops_match_reference():
    mat, other = _mat(seed=3), _mat(seed=4)
    ref, port = _both(mat)
    ro, po = _both(other)
    v = np.random.RandomState(5).rand(mat.shape[1]).astype(np.float32)
    pairs = [(ref.T, port.T), (ref.transpose(), port.transpose()),
             (ref.square(), port.square()),
             (ref.scale_cols(v), port.scale_cols(v)),
             (ref * 2.5, port * 2.5), (3.0 * ref, 3.0 * port),
             (ref / 3.0, port / 3.0), (-ref, -port),
             (ref + ro, port + po), (ref - ro, port - po)]
    for r, p in pairs:
        assert isinstance(p, PortSparse) and p.shape == r.shape
        np.testing.assert_array_equal(p.collect().toarray(),
                                      r.collect().toarray())
    d = np.random.RandomState(6).rand(*mat.shape).astype(np.float32)
    for r, p in ((ref + ds.array(d), port + dst.array(d)),
                 (ref - ds.array(d), port - dst.array(d))):
        np.testing.assert_array_equal(_dense(p), _dense(r))
    np.testing.assert_array_equal(port.row_norms_sq().numpy(),
                                  np.asarray(ref.row_norms_sq()))
    with pytest.raises(ValueError, match="scale vector length"):
        port.scale_cols(v[:3])
    with pytest.raises(ValueError, match="shape mismatch"):
        port + PortSparse.from_scipy(_mat(m=5))


def test_from_scipy_quarantine_and_labels():
    mat = _mat(seed=7).tolil()
    mat[3, 4] = np.nan
    mat[9, 0] = np.inf
    mat = mat.tocsr()
    y = np.arange(mat.shape[0], dtype=np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ra, ry = RefSparse.from_scipy(mat, quarantine=True, labels=y)
        pa, py = PortSparse.from_scipy(mat, quarantine=True, labels=y)
    np.testing.assert_array_equal(py, ry)
    np.testing.assert_array_equal(pa.collect().toarray(),
                                  ra.collect().toarray())
    np.testing.assert_array_equal(pa.quarantine_.rows, ra.quarantine_.rows)
    assert PortSparse.from_scipy(_mat()).quarantine_ is None


def test_sharded_layout_and_knobs(monkeypatch):
    mat = _mat(seed=8)
    ref, port = _both(mat)
    rep = port.sharded()
    assert rep.p == 1 and rep.nnz == mat.nnz and rep.nse % 64 == 0
    ref_rep = ref.sharded()
    np.testing.assert_array_equal(rep.rowsq().numpy()[0],
                                  np.asarray(ref_rep.rowsq()).ravel()[
                                      :mat.shape[0]])
    for got, want in zip(rep.host_triplets(), ref_rep.host_triplets()):
        np.testing.assert_array_equal(got, want)
    built = port_sparse.ShardedSparse.build(*ref_rep.host_triplets(),
                                            mat.shape, nse=200)
    assert built.nse == 256
    with pytest.raises(ValueError, match="out of range"):
        port_sparse.ShardedSparse.build([0], [99], [1.0], (2, 3))
    monkeypatch.setenv("DSLIB_SPARSE_NSE_QUANTUM", "16")
    monkeypatch.setenv("DSLIB_SPARSE_DENSIFY_BUDGET", "100")
    for mod in (ref_sparse, port_sparse):
        assert mod.nse_quantum() == 16 and mod.densify_budget_bytes() == 100
    for a in _both(mat):
        with pytest.raises(MemoryError, match="DSLIB_SPARSE_DENSIFY_BUDGET"):
            a._data


def test_unported_layouts_name_the_roadmap_items():
    # the on-device reshard stays A.11 and panel_view waits for the
    # multi-rank mesh with the multi-panel SpMM (A.2); ell and row_steps
    # are ported: bit-equal to the reference's
    ref, port = _both(_mat())
    with pytest.raises(NotImplementedError, match="A.11"):
        port.resharded()
    with pytest.raises(NotImplementedError,
                       match="multi-panel SpMM.*ROADMAP.md A.2"):
        port.sharded().panel_view(4, 8)
    for got, want in zip(port.ell(), ref.ell()):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(port.row_steps(8), ref.row_steps(8)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert port.ell(budget=8) is None and ref.ell(budget=8) is None


def test_array_of_a_scipy_matrix_is_dense_as_the_reference():
    # C.11: the reference densifies a scipy sparse matrix
    # and flags it sparse: collect gives a CSR, and ops that keep zeros
    # zero keep the flag
    mat = _mat(seed=9)
    for m in (mat, mat.tocoo(), sp.csc_matrix(mat)):
        p, r = dst.array(m), ds.array(m)
        assert type(p) is dst.Array and p.shape == r.shape
        np.testing.assert_array_equal(p._data.numpy(), mat.toarray())
        for op in (lambda a: a, lambda a: a * 2.0, lambda a: a + 1.0,
                   lambda a: a.T, lambda a: a[2:9, :], lambda a: a.exp(),
                   lambda a: a + a, lambda a: a.astype(np.float32)):
            got, want = op(p).collect(), op(r).collect()
            assert sp.issparse(got) == sp.issparse(want)
            if sp.issparse(want):
                got, want = got.toarray(), want.toarray()
            _close(got, np.asarray(want))


# -- spmm and the sparse matmul routes --------------------------------------------

def _err(c, want, a, b):
    """ERROR_BOUNDS' matmul metric against a float64 product."""
    scale = np.linalg.norm(a) * np.linalg.norm(b) / np.sqrt(a.shape[1])
    return np.abs(c - want).max() / scale


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
def test_spmm_matches_reference_and_f64(policy):
    mat = _mat(m=70, n=45, density=0.08, seed=10)
    b = np.random.RandomState(11).standard_normal((45, 9)).astype(np.float32)
    ref, port = _both(mat)
    want64 = mat.toarray().astype(np.float64) @ b.astype(np.float64)
    got = _dense(port_spmm(port, dst.array(b), precision=policy))
    assert got.dtype == np.float32
    assert _err(got, want64, mat.toarray(), b) <= \
        port_px.ERROR_BOUNDS[("matmul", policy)] \
        == ref_px.ERROR_BOUNDS[("matmul", policy)]
    _close(got, _dense(ref_spmm(ref, ds.array(b), precision=policy)))
    for kw in ({"overlap": "seq"}, {"panels": 7}, {"layout": "masked"}):
        np.testing.assert_array_equal(
            _dense(port_spmm(port, dst.array(b), precision=policy, **kw)),
            got)


@pytest.mark.parametrize("algorithm", ["auto", "spmm", "densify"])
@pytest.mark.parametrize("density", [0.05, 0.5])
def test_matmul_sparse_routes_match_reference(algorithm, density):
    mat = _mat(m=40, n=30, density=density, seed=12)
    b = np.random.RandomState(13).standard_normal((30, 6)).astype(np.float32)
    ref, port = _both(mat)
    got = dst.matmul(port, dst.array(b), algorithm=algorithm)
    want = ds.matmul(ref, ds.array(b), algorithm=algorithm)
    _close(_dense(got), _dense(want))
    assert _err(_dense(got), mat.toarray().astype(np.float64) @ b,
                mat.toarray(), b) <= port_px.ERROR_BOUNDS[("matmul",
                                                           "float32")]
    np.testing.assert_array_equal(_dense(port @ dst.array(b)),
                                  _dense(dst.matmul(port, dst.array(b))))
    np.testing.assert_array_equal(_dense(port @ b), _dense(port @
                                                           dst.array(b)))


def test_matmul_sparse_routing_and_errors(monkeypatch):
    from dislib_tpu.math import base as ref_mb
    from dislib_tpu_torch.math import base as port_mb
    for density in (0.05, 0.5):
        ref, port = _both(_mat(m=40, n=30, density=density, seed=14))
        assert port_mb._pick_sparse_algorithm(port, "auto") == \
            ref_mb._pick_sparse_algorithm(ref, "auto") == \
            ("spmm" if density <= 0.1 else "densify")
    monkeypatch.setenv("DSLIB_SPARSE_DENSIFY_BUDGET", "100")
    assert port_mb._pick_sparse_algorithm(port, "auto") == "spmm"
    b = dst.array(np.ones((30, 2), np.float32))
    for bad in (dict(transpose_a=True), dict(transpose_b=True)):
        with pytest.raises(TypeError, match="sparse matmul fast path"):
            dst.matmul(port, b, **bad)
    with pytest.raises(TypeError, match="sparse matmul fast path"):
        dst.matmul(dst.array(np.ones((2, 40), np.float32)), port)
    with pytest.raises(ValueError, match="unknown sparse matmul"):
        dst.matmul(port, b, algorithm="xla")
    with pytest.raises(ValueError, match="shape mismatch"):
        dst.matmul(port, dst.array(np.ones((3, 2), np.float32)))


# -- load_svmlight_file(store_sparse=True) --------------------------------------

def test_load_svmlight_sparse_matches_reference_triplets(tmp_path,
                                                         monkeypatch):
    rng = np.random.RandomState(15)
    lines = []
    for i in range(60):
        cols = np.sort(rng.choice(40, rng.randint(0, 6), replace=False))
        lines.append(" ".join([str(i % 3)] + [f"{c + 1}:{rng.rand():.6g}"
                                              for c in cols]))
    path = tmp_path / "x.svm"
    path.write_text("\n".join(lines) + "\n")
    for native in ("1", None):
        if native:
            monkeypatch.setenv("DSLIB_NO_NATIVE", native)
        else:
            monkeypatch.delenv("DSLIB_NO_NATIVE", raising=False)
        rx, ry = ds.load_svmlight_file(str(path), n_features=40)
        px_, py = dst.load_svmlight_file(str(path), n_features=40)
        assert isinstance(px_, PortSparse) and px_.shape == rx.shape
        ref_t = ref_sparse.ShardedSparse.host_triplets(rx.sharded())
        got_t = px_.sharded().host_triplets()
        for got, want in zip(got_t, ref_t):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(py.collect(), np.asarray(ry.collect()))


# -- sparse KMeans ---------------------------------------------------------------

def _sparse_blobs(m=300, n=40, k=4, seed=16):
    """k blobs on disjoint column groups: rows of a blob share its
    support, so the clusters are far apart."""
    rng = np.random.RandomState(seed)
    lab = rng.randint(0, k, m)
    x = np.zeros((m, n), np.float32)
    width = n // k
    for i, c in enumerate(lab):
        cols = c * width + rng.choice(width, 4, replace=False)
        x[i, cols] = rng.rand(4).astype(np.float32) + 1.0
    return sp.csr_matrix(x)


@pytest.mark.parametrize("max_iter,tol", [(1, 0.0), (20, 1e-4)])
def test_sparse_kmeans_matches_reference(max_iter, tol):
    mat = _sparse_blobs()
    ref_x, port_x = _both(mat)
    kw = dict(n_clusters=4, random_state=3, max_iter=max_iter, tol=tol)
    ref = RefKMeans(**kw).fit(ref_x)
    port = PortKMeans(**kw).fit(port_x)
    assert port.n_iter_ == ref.n_iter_
    _close(port.centers_, np.asarray(ref.centers_))
    _close(port.history_, np.asarray(ref.history_))
    _close(np.float32(port.inertia_), np.float32(ref.inertia_))
    np.testing.assert_array_equal(port.predict(port_x).collect(),
                                  np.asarray(ref.predict(ref_x).collect()))
    _close(np.float32(port.score(port_x)), np.float32(ref.score(ref_x)))
    # one Lloyd step from the same centers against float64 NumPy
    x64 = mat.toarray().astype(np.float64)
    c0 = PortKMeans(**kw)._init_centers(port_x).numpy().astype(np.float64)
    np.testing.assert_array_equal(
        c0, np.asarray(RefKMeans(**kw)._init_centers(ref_x)))
    d = ((x64[:, None, :] - c0[None]) ** 2).sum(2)
    lab = d.argmin(1)
    want = np.stack([x64[lab == c].mean(0) for c in range(4)])
    one = PortKMeans(**{**kw, "max_iter": 1, "tol": 0.0}).fit(port_x)
    _close(one.centers_, want)


def test_sparse_kmeans_async_hooks_and_dense_agree():
    mat = _sparse_blobs(seed=17)
    port_x = PortSparse.from_scipy(mat)
    km = PortKMeans(n_clusters=4, random_state=1)
    state = km._fit_async(port_x)
    score = km._score_async(state, port_x)
    km._fit_finalize(state)
    _close(np.float32(float(score)), np.float32(km.score(port_x)))
    dense = PortKMeans(n_clusters=4, random_state=1).fit(dst.array(
        mat.toarray()))
    assert dense.n_iter_ == km.n_iter_
    _close(km.centers_, dense.centers_)
