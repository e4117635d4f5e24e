"""The port's NearestNeighbors, single-rank ring and KNeighborsClassifier
against the reference's, on CPU.

The same numpy inputs go through ``dislib_tpu`` (8 virtual CPU devices) and
``dislib_tpu_torch`` on the CPU.  Tolerances: distances rtol/atol 1e-5
(float32 products summed in different orders; queries are never fit rows,
so no distance sits at the square root's steep start near 0); indices,
labels and class codes exactly equal; scores within 1e-6.  The chunked
path is reached by shrinking ``_CHUNK`` in both packages.  Ties go to the
lower fit index in both (``lax.top_k`` keeps the lower position; the port
keys every candidate by (distance, index)).  The reference's ring breaks
ties by the order its shards arrive, so the ring is held against it on
data without ties.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import dislib_tpu as ds
from dislib_tpu.classification import KNeighborsClassifier as RefKNN
from dislib_tpu.neighbors import NearestNeighbors as RefNN
from dislib_tpu.neighbors import base as ref_nb

import dislib_tpu_torch as dst
from dislib_tpu_torch.classification import KNeighborsClassifier as PortKNN
from dislib_tpu_torch.neighbors import NearestNeighbors as PortNN
from dislib_tpu_torch.neighbors import base as port_nb
from dislib_tpu_torch.ops import kernels as K
from dislib_tpu_torch.ops import ring as port_ring
from dislib_tpu_torch.ops.base import chunk_smallest, merge_smallest, \
    split_keys
from dislib_tpu_torch.parallel import mesh as port_mesh

MF, MQ, N = 203, 37, 5          # ragged: not multiples of 8 or the chunk


@pytest.fixture(autouse=True)
def _port_on_cpu():
    dst.init(device="cpu")
    yield


@pytest.fixture
def chunked(monkeypatch, request):
    """``_CHUNK`` in both packages: 4096 (direct path) or 16 (13
    chunks)."""
    monkeypatch.setattr(ref_nb, "_CHUNK", request.param)
    monkeypatch.setattr(port_nb, "_CHUNK", request.param)
    return request.param


def _fq(seed=0, dup=False):
    rng = np.random.RandomState(seed)
    f = rng.rand(MF, N).astype(np.float32)
    q = rng.rand(MQ, N).astype(np.float32)
    if dup:
        # duplicate groups inside one chunk and across chunk boundaries
        for src, dst_rows in ((10, (11, 50, 120)), (31, (32, 47, 190)),
                              (0, (15, 16, 17, 200))):
            f[list(dst_rows)] = f[src]
        q[:8] = f[[10, 31, 0, 10, 31, 0, 10, 31]] + 0.1
    return f, q


def _both(f, q, k, n_neighbors=None, **kw):
    ref = RefNN(n_neighbors=k, ring=False).fit(ds.array(f)).kneighbors(
        ds.array(q), n_neighbors=n_neighbors)
    port = PortNN(n_neighbors=k, **kw).fit(dst.array(f)).kneighbors(
        dst.array(q), n_neighbors=n_neighbors)
    return [a.collect() for a in ref], [a.collect() for a in port]


@pytest.mark.parametrize("chunked", [4096, 16], indirect=True,
                         ids=["direct", "chunked"])
@pytest.mark.parametrize("k", [1, 6, MF])
def test_kneighbors_matches_reference(chunked, k):
    f, q = _fq()
    (rd, ri), (pd, pi) = _both(f, q, k)
    assert pi.dtype == np.int32 and pi.shape == (MQ, k)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_allclose(pd, rd, rtol=1e-5, atol=1e-5)
    assert np.all(np.diff(pd, axis=1) >= 0)


@pytest.mark.parametrize("chunked", [4096, 16], indirect=True,
                         ids=["direct", "chunked"])
def test_kneighbors_per_call_n_neighbors(chunked):
    f, q = _fq(seed=1)
    (rd, ri), (pd, pi) = _both(f, q, 3, n_neighbors=9)
    assert pi.shape == (MQ, 9)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_allclose(pd, rd, rtol=1e-5, atol=1e-5)
    idx = PortNN(n_neighbors=4).fit(dst.array(f)).kneighbors(
        dst.array(q), return_distance=False)
    np.testing.assert_array_equal(idx.collect(), pi[:, :4])


@pytest.mark.parametrize("chunked", [4096, 16], indirect=True,
                         ids=["direct", "chunked"])
def test_duplicate_fit_rows_tie_to_the_lower_index(chunked):
    f, q = _fq(dup=True)
    (rd, ri), (pd, pi) = _both(f, q, 8)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_allclose(pd, rd, rtol=1e-5, atol=1e-5)
    # each query near a duplicate group lists the group in index order
    for row, group in zip(range(3), ([10, 11, 50, 120], [31, 32, 47, 190],
                                     [0, 15, 16, 17, 200])):
        np.testing.assert_array_equal(pi[row, :len(group)], group)
    # every fit row the same: the first k indices, on both paths
    same = np.repeat(f[:1], MF, axis=0)
    (_, ri), (_, pi) = _both(same, q, 20)
    np.testing.assert_array_equal(pi, np.tile(np.arange(20), (MQ, 1)))
    np.testing.assert_array_equal(ri, pi)


def test_merge_keeps_the_lower_index_on_ties():
    # torch.topk alone may keep any of the equal values at the k-th place
    d = torch.zeros((3, 4096))
    d[:, ::7] = 1.0
    best = merge_smallest(None, d, 5)
    d2, idx = split_keys(best)
    want = np.setdiff1d(np.arange(4096), np.arange(0, 4096, 7))[:5]
    np.testing.assert_array_equal(idx.numpy(), np.tile(want, (3, 1)))
    assert idx.dtype == torch.int32 and bool((d2 == 0).all())
    # a carried best precedes a later chunk: equal distances keep it
    more = merge_smallest(best, torch.zeros((3, 2)), 6, off=9001)
    np.testing.assert_array_equal(split_keys(more)[1].numpy()[0],
                                  list(want) + [9001])


@pytest.mark.parametrize("rows, n, k", [(40, 300, 10), (33, 97, 15),
                                        (9, 12, 12), (5, 1, 1)])
def test_chunk_smallest_is_the_order_of_distance_then_index(rows, n, k):
    # against a full sort of every (distance, index) pair of the chunk, on
    # data with many equal distances at and around the k-th place
    g = torch.Generator().manual_seed(rows * n + k)
    for d in (torch.rand((rows, n), generator=g),
              torch.round(torch.rand((rows, n), generator=g) * 6) / 6,
              torch.zeros((rows, n)), torch.full((rows, n), float("inf"))):
        d2, idx = split_keys(chunk_smallest(d, k, off=500))
        pairs = [sorted((float(v), j + 500) for j, v in enumerate(r))[:k]
                 for r in d.tolist()]
        np.testing.assert_array_equal(idx.numpy(),
                                      [[j for _, j in p] for p in pairs])
        np.testing.assert_array_equal(d2.numpy(),
                                      [[v for v, _ in p] for p in pairs])


@pytest.mark.parametrize("use_dist", [False, True],
                         ids=["uniform", "distance"])
def test_vote_is_the_one_hot_sum_first_maximum(use_dist):
    # the class-count-free vote against the reference's one-hot sum and
    # first-maximum argmax, with ties between classes (k even, few classes)
    from dislib_tpu_torch.classification.knn import _vote
    rng = np.random.RandomState(5)
    codes = torch.from_numpy(rng.randint(0, 4, 60).astype(np.int32))
    idx = torch.from_numpy(rng.randint(0, 60, (500, 6)).astype(np.int32))
    dist = torch.from_numpy(rng.choice([0.0, 0.5, 1.0, 2.0], (500, 6))
                            .astype(np.float32))
    c = codes[idx.long()].numpy()
    w = 1.0 / np.maximum(dist.numpy(), 1e-10) if use_dist \
        else np.ones(c.shape, np.float32)
    onehot = (c[:, :, None] == np.arange(4)).astype(np.float32) * \
        w[:, :, None]
    want = np.argmax(onehot.sum(1), axis=1)
    np.testing.assert_array_equal(_vote(dist, idx, codes, use_dist).numpy(),
                                  want)


@pytest.mark.parametrize("overlap", ["db", "seq", "kernel"])
def test_ring_single_rank_matches_reference_ring(overlap):
    f, q = _fq(seed=2)
    k = 7
    rd, ri = RefNN(n_neighbors=k, ring=True).fit(ds.array(f)).kneighbors(
        ds.array(q))
    K.reset_launches()
    d2, idx = port_ring.ring_kneighbors(torch.from_numpy(q),
                                        torch.from_numpy(f),
                                        dst.get_mesh(), k, MF,
                                        overlap=overlap)
    assert K.LAUNCHES["panel_gemm"] == 0          # CPU: the plain version
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), ri.collect())
    np.testing.assert_allclose(np.sqrt(d2.numpy()), rd.collect(), rtol=1e-5,
                               atol=1e-5)
    # the chunked path gives the same neighbours
    _, pi = PortNN(n_neighbors=k).fit(dst.array(f)).kneighbors(
        dst.array(q))
    np.testing.assert_array_equal(pi.collect(), idx.numpy())


def test_ring_routing_needs_more_than_one_row():
    mesh = dst.get_mesh()
    assert port_ring.ring_auto(True, mesh, False)
    assert not port_ring.ring_auto(False, mesh, True)
    assert not port_ring.ring_auto(None, mesh, True)       # one row
    assert port_ring.ring_auto(None, port_mesh.Mesh(2, 1, mesh.device), True)
    # ring=True on the one-row mesh: a warning, then the chunked path
    f, q = _fq()
    with pytest.warns(UserWarning, match="A.2"):
        a = PortNN(n_neighbors=4, ring=True).fit(dst.array(f)).kneighbors(
            dst.array(q))[1].collect()
    b = PortNN(n_neighbors=4, ring=False).fit(dst.array(f)).kneighbors(
        dst.array(q))[1].collect()
    np.testing.assert_array_equal(a, b)


def test_ring_on_several_ranks_raises():
    mesh = port_mesh.Mesh(2, 1, torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="A.2"):
        port_ring.ring_kneighbors(torch.zeros((4, 2)), torch.zeros((4, 2)),
                                  mesh, 1, 4)


def test_kneighbors_errors():
    f, q = _fq()
    with pytest.raises(RuntimeError, match="not fitted"):
        PortNN().kneighbors(dst.array(q))
    nn = PortNN().fit(dst.array(f))
    for k in (0, MF + 1):
        with pytest.raises(ValueError, match="n_neighbors"):
            nn.kneighbors(dst.array(q), n_neighbors=k)


# -- KNeighborsClassifier ------------------------------------------------------

def _labelled(seed=0, m=150, n=4, k=3, float_labels=False):
    rng = np.random.RandomState(seed)
    centers = rng.rand(k, n).astype(np.float32)
    lab = rng.randint(0, k, m)
    x = (centers[lab] + 0.15 * rng.standard_normal((m, n))).astype(
        np.float32)
    y = (lab * 1.5 + 0.25).astype(np.float32) if float_labels else lab * 2
    return x, y[:, None]


@pytest.mark.parametrize("chunked", [4096, 16], indirect=True,
                         ids=["direct", "chunked"])
@pytest.mark.parametrize("weights", ["uniform", "distance"])
@pytest.mark.parametrize("float_labels", [False, True],
                         ids=["int_labels", "float_labels"])
def test_knn_classifier_matches_reference(chunked, weights, float_labels):
    x, y = _labelled(float_labels=float_labels)
    xt, yt, xv, yv = x[:110], y[:110], x[110:], y[110:].copy()
    yv[:3] = 99                         # labels unseen at fit: never right
    kw = dict(n_neighbors=5, weights=weights)
    ref = RefKNN(**kw).fit(ds.array(xt), ds.array(yt))
    port = PortKNN(**kw).fit(dst.array(xt), dst.array(yt))
    np.testing.assert_array_equal(port.classes_, np.unique(yt))
    rp, pp = ref.predict(ds.array(xv)).collect(), \
        port.predict(dst.array(xv)).collect()
    assert pp.dtype == (np.float32 if float_labels else np.int32)
    np.testing.assert_array_equal(pp, rp)
    want = ref.score(ds.array(xv), ds.array(yv))
    assert want < 1.0
    assert abs(port.score(dst.array(xv), dst.array(yv)) - want) <= 1e-6
    st = port._fit_async(dst.array(xt), dst.array(yt))
    got = port._score_async(st, dst.array(xv), dst.array(yv))
    assert isinstance(got, torch.Tensor) and got.dim() == 0
    assert abs(float(got) - want) <= 1e-6


def test_knn_classifier_errors():
    x, y = _labelled()
    knn = PortKNN(n_neighbors=200)
    with pytest.raises(RuntimeError, match="not fitted"):
        knn.predict(dst.array(x))
    knn.fit(dst.array(x), dst.array(y))
    with pytest.raises(ValueError, match="n_neighbors"):
        knn.predict(dst.array(x))
    with pytest.raises(ValueError, match="bad weights"):
        PortKNN(weights="bogus").fit(dst.array(x), dst.array(y)).predict(
            dst.array(x))
    with pytest.raises(ValueError, match="row counts"):
        PortKNN().fit(dst.array(x), dst.array(y[:10]))
    with pytest.raises(ValueError, match="requires y"):
        PortKNN()._fit_async(dst.array(x))


# -- carried models and sparse input -----------------------------------------

def test_from_fitted_arrays_nearest_neighbors():
    f, q = _fq(seed=3)
    ref = RefNN(n_neighbors=4).fit(ds.array(f))
    port = dst.from_fitted_arrays(
        PortNN, {"_fit_data": ref._fit_data.collect()}, device="cpu",
        n_neighbors=4)
    rd, ri = ref.kneighbors(ds.array(q))
    pd, pi = port.kneighbors(dst.array(q))
    np.testing.assert_array_equal(pi.collect(), ri.collect())
    np.testing.assert_allclose(pd.collect(), rd.collect(), rtol=1e-5,
                               atol=1e-5)


def test_from_fitted_arrays_knn_classifier():
    x, y = _labelled(seed=4, float_labels=True)
    ref = RefKNN(n_neighbors=3).fit(ds.array(x[:100]), ds.array(y[:100]))
    port = dst.from_fitted_arrays(
        PortKNN, {"_fit_x": ref._fit_x.collect(),
                  "_codes": np.asarray(ref._codes),
                  "classes_": ref.classes_}, device="cpu", n_neighbors=3)
    np.testing.assert_array_equal(
        port.predict(dst.array(x[100:])).collect(),
        ref.predict(ds.array(x[100:])).collect())


def test_sparse_input_raises_naming_a10():
    # sparse fit sets and queries are ported: the sparse stream equals the
    # reference's (and the port's dense path) on every combination
    from dislib_tpu.data.sparse import SparseArray as RefSparse
    f, q = _fq()
    f[f < 0.4], q[q < 0.4] = 0.0, 0.0
    fs, qs = sp.csr_matrix(f), sp.csr_matrix(q)
    dense = PortNN(n_neighbors=4).fit(dst.array(f)).kneighbors(dst.array(q))
    for fp, fr in ((dst.SparseArray.from_scipy(fs), RefSparse.from_scipy(fs)),
                   (dst.array(f), ds.array(f))):
        for qp, qr in ((dst.SparseArray.from_scipy(qs),
                        RefSparse.from_scipy(qs)), (dst.array(q), None)):
            got = PortNN(n_neighbors=4).fit(fp).kneighbors(qp)
            np.testing.assert_array_equal(got[1].collect(),
                                          dense[1].collect())
            np.testing.assert_allclose(got[0].collect(), dense[0].collect(),
                                       rtol=1e-5, atol=1e-5)
            if qr is not None:
                want = RefNN(n_neighbors=4).fit(fr).kneighbors(qr)
                np.testing.assert_array_equal(got[1].collect(),
                                              want[1].collect())
    x, y = _labelled()
    x[x < 0.3] = 0.0
    xs = dst.SparseArray.from_scipy(sp.csr_matrix(x))
    knn = PortKNN(n_neighbors=3).fit(xs, dst.array(y))
    ref = RefKNN(n_neighbors=3).fit(RefSparse.from_scipy(sp.csr_matrix(x)),
                                    ds.array(y))
    np.testing.assert_array_equal(knn.predict(xs).collect(),
                                  ref.predict(ds.array(x)).collect())
    with pytest.raises(TypeError):
        PortNN().fit(sp.csr_matrix(f))
