"""The port's MiniBatchKMeans against the reference's, on CPU.

The same numpy batches go through ``dislib_tpu`` (8 virtual CPU devices)
and ``dislib_tpu_torch`` on the CPU, where the step's ``distances_sq``
kernel runs its plain version.  Tolerances: ``centers_`` and ``history_``
within rtol/atol 1e-5 (float32 updates whose GEMMs sum in different
orders); ``counts_`` and ``n_batches_`` exactly (sums of integer
masses).
"""

import numpy as np
import pytest

import dislib_tpu as ds
from dislib_tpu.cluster import MiniBatchKMeans as RefMBK

import dislib_tpu_torch as dst
from dislib_tpu_torch.cluster import MiniBatchKMeans as PortMBK
from dislib_tpu_torch.ops import kernels as port_k


def _blobs(m=800, n=6, k=4, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-8, 8, (k, n))
    lab = rng.randint(0, k, m)
    return (centers[lab] + rng.standard_normal((m, n))).astype(np.float32)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    dst.init(device="cpu")
    port_k.reset_launches()
    yield


def _same(port, ref):
    assert port.n_batches_ == ref.n_batches_ == port.n_iter_
    np.testing.assert_array_equal(port.counts_, ref.counts_)
    np.testing.assert_allclose(port.centers_, ref.centers_, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(port.inertia_, ref.inertia_, rtol=1e-5)
    np.testing.assert_allclose(port.history_, ref.history_, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("init", ["random", "ndarray"])
def test_partial_fit_stream_matches_reference(init):
    x = _blobs()
    kw = dict(n_clusters=4, random_state=2,
              init=x[[3, 100, 200, 300]] if init == "ndarray" else "random")
    ref, port = RefMBK(**kw), PortMBK(**kw)
    for b in range(5):
        batch = x[b * 96:(b + 1) * 96]          # multiples of 8 rows
        ref.partial_fit(ds.array(batch))
        port.partial_fit(dst.array(batch))
        _same(port, ref)
    # host batches are accepted as well
    ref.partial_fit(x[500:596])
    port.partial_fit(x[500:596])
    _same(port, ref)
    assert port_k.LAUNCHES["distances_sq"] == 0


def test_fit_two_epochs_of_row_slices_matches_reference():
    x = _blobs(m=840)
    kw = dict(n_clusters=4, batch_size=200, epochs=2, random_state=0)
    ref = RefMBK(**kw).fit(ds.array(x))
    port = PortMBK(**kw).fit(dst.array(x))
    _same(port, ref)
    assert port.n_batches_ == 2 * 5                  # a ragged last slice
    got = port.predict(dst.array(x)).collect().ravel()
    want = ref.predict(ds.array(x)).collect().ravel()
    np.testing.assert_array_equal(got, want)
    # a fresh fit restarts the stream
    port.fit(dst.array(x))
    assert port.n_batches_ == 10


def test_carried_from_reference_predicts_like_it():
    x = _blobs()
    ref = RefMBK(n_clusters=4, batch_size=128, random_state=0).fit(
        ds.array(x))
    port = dst.from_fitted_arrays(PortMBK, {"centers_": ref.centers_,
                                            "counts_": ref.counts_},
                                  device="cpu", n_clusters=4)
    np.testing.assert_array_equal(
        port.predict(dst.array(x)).collect().ravel(),
        ref.predict(ds.array(x)).collect().ravel())
    np.testing.assert_array_equal(port.counts_, ref.counts_)


def test_refusals_name_the_roadmap_items(tmp_path):
    import scipy.sparse as sp
    from dislib_tpu_torch.utils.checkpoint import FitCheckpoint
    # checkpoint= is ported: the stream snapshots and equals the plain one
    plain = PortMBK(n_clusters=2, random_state=0).partial_fit(
        dst.array(_blobs()))
    ck = PortMBK(n_clusters=2, random_state=0).partial_fit(
        dst.array(_blobs()), checkpoint=FitCheckpoint(
            str(tmp_path / "mbk.npz")))
    np.testing.assert_array_equal(ck.centers_, plain.centers_)
    # a sparse batch raises ValueError in both packages (the reference's
    # np.asarray of it fails); predict takes sparse queries, as KMeans'
    xs = sp.random(16, 3, density=0.5, format="csr", random_state=0,
                   dtype=np.float32)
    for est, arr in ((PortMBK(n_clusters=2, batch_size=8), dst.SparseArray),
                     (RefMBK(n_clusters=2, batch_size=8), None)):
        with pytest.raises(ValueError):
            est.partial_fit(xs)
        if arr is not None:
            with pytest.raises(ValueError):
                est.fit(arr.from_scipy(xs))
    port = PortMBK(n_clusters=2, random_state=0).fit(dst.array(_blobs()))
    q = _blobs(seed=1)[:50]
    q[q < 0] = 0.0
    np.testing.assert_array_equal(
        port.predict(dst.SparseArray.from_dense(q)).collect(),
        port.predict(dst.array(q)).collect())
