"""Sparse input across the port's estimators, against the reference's, on
CPU.

The same scipy matrices (drawn with a seed) go through ``dislib_tpu`` (8
virtual CPU devices) and ``dislib_tpu_torch`` on the CPU.  Tolerances:
the staging layouts (``row_steps``, ``ell``) bit-equal, on a uniform and on
a skewed draw (one dense row sets the step's entry budget); kNN indices
exactly and distances within rtol/atol 1e-5 (float32 cross terms summed in
other orders; the data hold no near ties); the scaler's moments within
rtol 1e-5; shuffled and split rows exactly; every estimator that densifies
a ``SparseArray`` (through its budget-guarded lazy backing, as the
reference's ``x._data``) bit-equal to its fit on the dense array, and
raising ``MemoryError`` past a lowered ``DSLIB_SPARSE_DENSIFY_BUDGET``.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import dislib_tpu as ds
from dislib_tpu.classification import KNeighborsClassifier as RefKNN
from dislib_tpu.data.sparse import SparseArray as RefSparse
from dislib_tpu.neighbors import NearestNeighbors as RefNN
from dislib_tpu.neighbors import base as ref_nb
from dislib_tpu.preprocessing import StandardScaler as RefStd

import dislib_tpu_torch as dst
from dislib_tpu_torch import cluster, optimization, regression, trees
from dislib_tpu_torch.classification import KNeighborsClassifier as PortKNN
from dislib_tpu_torch.data.sparse import SparseArray as PortSparse
from dislib_tpu_torch.neighbors import NearestNeighbors as PortNN
from dislib_tpu_torch.neighbors import base as port_nb
from dislib_tpu_torch.preprocessing import StandardScaler as PortStd


@pytest.fixture(autouse=True)
def _port_on_cpu():
    dst.init(device="cpu")
    yield


def _mat(m=120, n=16, density=0.25, seed=0, skew=False):
    mat = sp.random(m, n, density=density, random_state=seed,
                    dtype=np.float32, format="lil")
    if skew:
        mat[7, :] = np.arange(1, n + 1, dtype=np.float32)   # a dense row
        mat[m // 2:, :] = 0.0
        mat[m // 2:, 3] = 1.5                               # one entry
    return mat.tocsr()


def _both(mat):
    return RefSparse.from_scipy(mat), PortSparse.from_scipy(mat)


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("skew", [False, True], ids=["uniform", "skewed"])
@pytest.mark.parametrize("chunk", [8, 50, 4096])
def test_row_steps_and_ell_match_reference(skew, chunk):
    mat = _mat(skew=skew)
    ref, port = _both(mat)
    _equal(port.row_steps(chunk), ref.row_steps(chunk))
    plan, budget = port.row_step_plan(chunk)
    assert budget >= int(np.diff(mat.indptr).max())
    _equal(port.ell(), ref.ell())
    # the ShardedSparse buffers: the reference's device build (on its 8
    # row shards) equals its host build, and the port's equals both
    ref_rep, port_rep = ref.sharded(), port.sharded()
    assert ref_rep.row_step_plan(chunk) == (plan, budget) \
        == port_rep.row_step_plan(chunk)
    _equal(port_rep.row_step_buffers(chunk), ref.row_steps(chunk))
    _equal(port.row_steps(chunk), ref_rep.row_step_buffers(chunk))
    _equal(port_rep.ell_buffers(), ref.ell())
    ev, ec = ref_rep.ell_buffers()
    _equal(port_rep.ell_buffers(), (np.asarray(ev)[:mat.shape[0]],
                                    np.asarray(ec)[:mat.shape[0]]))
    r = int(np.diff(mat.indptr).max())
    assert port.ell(budget=mat.shape[0] * r * 8 - 1) is None
    assert port.ell(budget=mat.shape[0] * r * 8) is not None


@pytest.fixture
def chunked(monkeypatch, request):
    """``_CHUNK`` in both packages: 4096 (one window) or 16 (windows of
    16 rows, the sparse fit's steps also capped by entries)."""
    monkeypatch.setattr(ref_nb, "_CHUNK", request.param)
    monkeypatch.setattr(port_nb, "_CHUNK", request.param)
    return request.param


def _fq(seed=1, mf=150, mq=33, n=12):
    rng = np.random.RandomState(seed)
    f = rng.rand(mf, n).astype(np.float32)
    q = rng.rand(mq, n).astype(np.float32)
    f[f < 0.55], q[q < 0.55] = 0.0, 0.0
    return f, q


@pytest.mark.parametrize("chunked", [4096, 16], indirect=True,
                         ids=["one-window", "windows"])
@pytest.mark.parametrize("combo", ["sparse-fit", "sparse-queries",
                                   "sparse-both"])
def test_sparse_kneighbors_matches_reference(chunked, combo):
    f, q = _fq()
    rf, pf = (_both(sp.csr_matrix(f)) if combo != "sparse-queries"
              else (ds.array(f), dst.array(f)))
    rq, pq = (_both(sp.csr_matrix(q)) if combo != "sparse-fit"
              else (ds.array(q), dst.array(q)))
    rd, ri = RefNN(n_neighbors=5).fit(rf).kneighbors(rq)
    pd, pi = PortNN(n_neighbors=5).fit(pf).kneighbors(pq)
    np.testing.assert_array_equal(pi.collect(), ri.collect())
    np.testing.assert_allclose(pd.collect(), rd.collect(), rtol=1e-5,
                               atol=1e-5)
    assert pi.collect().dtype == np.int32 and pd.shape == (q.shape[0], 5)


@pytest.mark.parametrize("weights", ["uniform", "distance"])
def test_knn_classifier_on_a_sparse_fit_set(weights):
    rng = np.random.RandomState(3)
    centers = rng.rand(3, 10) * 3
    lab = rng.randint(0, 3, 200)
    x = (centers[lab] + 0.3 * rng.standard_normal((200, 10))).astype(
        np.float32)
    x[x < 1.0] = 0.0
    y = (lab * 2).astype(np.float32)[:, None]
    rx, px_ = _both(sp.csr_matrix(x[:150]))
    ref = RefKNN(n_neighbors=4, weights=weights).fit(rx, ds.array(y[:150]))
    port = PortKNN(n_neighbors=4, weights=weights).fit(px_,
                                                       dst.array(y[:150]))
    np.testing.assert_array_equal(port.classes_, ref.classes_)
    rq, pq = _both(sp.csr_matrix(x[150:]))
    for qr, qp in ((rq, pq), (ds.array(x[150:]), dst.array(x[150:]))):
        np.testing.assert_array_equal(port.predict(qp).collect(),
                                      ref.predict(qr).collect())
        assert port.score(qp, dst.array(y[150:])) == \
            ref.score(qr, ds.array(y[150:]))
    state = port._fit_async(px_, dst.array(y[:150]))
    port._fit_finalize(state)
    assert float(port._score_async(state, pq, dst.array(y[150:]))) == \
        port.score(pq, dst.array(y[150:]))


def test_standard_scaler_on_a_sparse_array():
    x = np.random.RandomState(4).standard_normal((90, 7)).astype(np.float32)
    x[np.abs(x) < 0.7] = 0.0
    rs, ps = _both(sp.csr_matrix(x))
    ref = RefStd(with_mean=False).fit(rs)
    port = PortStd(with_mean=False).fit(ps)
    for name in ("mean_", "var_"):
        np.testing.assert_allclose(getattr(port, name).collect(),
                                   getattr(ref, name).collect(), rtol=1e-5)
    out = port.transform(ps)
    assert isinstance(out, PortSparse) and out.nnz == ps.nnz
    np.testing.assert_allclose(out.collect().toarray(),
                               ref.transform(rs).collect().toarray(),
                               rtol=1e-5)
    back = port.inverse_transform(out).collect().toarray()
    np.testing.assert_allclose(back, x, rtol=1e-5, atol=1e-6)
    assert PortStd(with_mean=False, with_std=False).fit(ps).transform(ps) \
        is ps
    for est in (PortStd(), RefStd()):
        with pytest.raises(ValueError, match="center"):
            est.fit(ps if isinstance(est, PortStd) else rs)
    dense_fit = PortStd().fit(dst.array(x))
    with pytest.raises(ValueError, match="center"):
        dense_fit.transform(ps)
    with pytest.raises(ValueError, match="center"):
        dense_fit.inverse_transform(ps)


def test_shuffle_and_split_keep_a_sparse_array_sparse():
    mat = _mat(m=40, n=9, seed=5)
    rs, ps = _both(mat)
    y = np.arange(40, dtype=np.float32)[:, None]
    got_x, got_y = dst.shuffle(ps, dst.array(y), random_state=3)
    want_x, want_y = ds.utils.shuffle(rs, ds.array(y), random_state=3)
    assert isinstance(got_x, PortSparse)
    np.testing.assert_array_equal(got_x.collect().toarray(),
                                  want_x.collect().toarray())
    np.testing.assert_array_equal(got_y.collect(), want_y.collect())
    got = dst.train_test_split(ps, dst.array(y), test_size=0.3,
                               random_state=1)
    want = ds.utils.train_test_split(rs, ds.array(y), test_size=0.3,
                                     random_state=1)
    for g, w in zip(got, want):
        gv, wv = g.collect(), w.collect()
        if sp.issparse(gv):
            assert isinstance(g, PortSparse)
            gv, wv = gv.toarray(), wv.toarray()
        np.testing.assert_array_equal(gv, wv)
    with pytest.raises(TypeError):
        dst.shuffle(mat)


def _blob_rows(m=96, n=6, seed=6):
    rng = np.random.RandomState(seed)
    lab = rng.randint(0, 3, m)
    x = (np.eye(3, n)[lab] * 4 + 0.3 * rng.standard_normal((m, n)))
    x[np.abs(x) < 0.25] = 0.0
    return x.astype(np.float32), lab


def _fitted(name, x, y_cls, y_reg):
    """(estimator fitted on x, its fitted arrays)."""
    if name == "LinearRegression":
        e = regression.LinearRegression().fit(x, y_reg)
        return [e.coef_, e.intercept_]
    if name == "Lasso":
        return [regression.Lasso(lmbd=0.05).fit(x, y_reg).coef_]
    if name == "ADMM":
        return [optimization.ADMM(max_iter=20).fit(x, y_reg).z_]
    if name == "GaussianMixture":
        e = cluster.GaussianMixture(n_components=3, random_state=0).fit(x)
        return [e.means_, e.covariances_, e.weights_]
    if name == "DBSCAN":
        return [cluster.DBSCAN(eps=1.2, min_samples=3).fit(x).labels_]
    if name == "Daura":
        return [cluster.Daura(cutoff=1.5).fit(x).labels_]
    cls = getattr(trees, name)
    y = y_cls if "Classifier" in name else y_reg
    kw = {} if name.startswith("Decision") else {"n_estimators": 3}
    e = cls(random_state=0, **kw).fit(x, y)
    out = [e._feats, e._tbins, e._edges.numpy(), e._leaves.numpy()]
    if "Classifier" in name:
        out.append(e.predict_proba(x).collect())
    return out


DENSIFY_ROUTE = ["LinearRegression", "Lasso", "ADMM", "GaussianMixture",
                 "DBSCAN", "Daura", "DecisionTreeClassifier",
                 "DecisionTreeRegressor", "RandomForestClassifier",
                 "RandomForestRegressor"]


@pytest.mark.parametrize("name", DENSIFY_ROUTE)
def test_densify_route_equals_the_dense_fit(name, monkeypatch):
    x, lab = _blob_rows()
    xs = PortSparse.from_scipy(sp.csr_matrix(x))
    y_cls = dst.array((lab % 2).astype(np.float32)[:, None])
    y_reg = dst.array((x @ np.arange(1.0, 7.0)).astype(np.float32)[:, None])
    for got, want in zip(_fitted(name, xs, y_cls, y_reg),
                         _fitted(name, dst.array(x), y_cls, y_reg)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    monkeypatch.setenv("DSLIB_SPARSE_DENSIFY_BUDGET", "1024")
    with pytest.raises(MemoryError, match="CascadeSVM"):
        _fitted(name, PortSparse.from_scipy(sp.csr_matrix(x)), y_cls, y_reg)
