"""The port's KMeans against the reference's, on CPU.

The same numpy inputs go through ``dislib_tpu`` (8 virtual CPU devices) and
``dislib_tpu_torch`` on the CPU, where the E-step's ``distances_sq`` kernel
runs its plain version.  Tolerances: centers, history and inertia at
1e-5 (float32 Lloyd steps whose distance GEMMs sum in different orders);
``n_iter_`` exactly; predict labels exactly on every row that is not a
near tie (see :func:`_clear_rows`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dislib_tpu as ds
from dislib_tpu.cluster import KMeans as RefKMeans
from dislib_tpu.cluster import kmeans as ref_km

import dislib_tpu_torch as dst
from dislib_tpu_torch.cluster import KMeans as PortKMeans
from dislib_tpu_torch.cluster import kmeans as port_km
from dislib_tpu_torch.ops import kernels as port_k


def _blobs(m=600, n=7, k=4, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-10, 10, (k, n))
    lab = rng.randint(0, k, m)
    return (centers[lab] + rng.standard_normal((m, n))).astype(np.float32)


def _uniform(m=500, n=5, seed=1):
    return np.random.RandomState(seed).rand(m, n).astype(np.float32)


DATA = {"blobs": (_blobs, 4), "uniform": (_uniform, 3)}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    dst.init(device="cpu")
    port_k.reset_launches()
    yield


def _init_rows(x, k, seed=3):
    rng = np.random.RandomState(seed)
    return x[rng.choice(x.shape[0], k, replace=False)].copy()


@pytest.mark.parametrize("data", sorted(DATA))
@pytest.mark.parametrize("max_iter,tol", [(1, 0.0), (20, 1e-4)])
def test_kmeans_fit_kernel_matches_reference(data, max_iter, tol):
    make, k = DATA[data]
    x = make()
    c0 = _init_rows(x, k)
    a = ds.array(x)
    ref = [np.asarray(v) for v in ref_km._kmeans_fit(
        a._data, a.shape, jnp.asarray(c0), max_iter, tol)]
    p = dst.array(x)
    got = [v.numpy() for v in port_km._kmeans_fit(
        p._data, p.shape, torch.from_numpy(c0), max_iter, tol)]
    (rc, rn, ri, rs, rh, rv), (gc, gn, gi, gs, gh, gv) = ref, got
    assert int(gn) == int(rn)
    np.testing.assert_allclose(gc, rc, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gh, rh, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(gi), float(ri), rtol=1e-5)
    # the health vector: counts and indices are exact; its float slots
    # (losses, rise, max |center|) carry the same 1e-5 f32 tolerance,
    # scaled by the inertia they are measured against
    assert gv.shape == rv.shape
    np.testing.assert_allclose(gv, rv, rtol=1e-5, atol=1e-5 * float(ri))
    assert port_k.LAUNCHES["distances_sq"] == 0


def _clear_rows(x, centers):
    """Rows whose two smallest reference distances differ by more than
    1e-4·(‖x‖² + max‖c‖²): their argmin cannot flip under float32
    reassociation, so the labels there must be equal."""
    x64, c64 = x.astype(np.float64), centers.astype(np.float64)
    d = ((x64[:, None, :] - c64[None, :, :]) ** 2).sum(-1)
    two = np.sort(d, axis=1)[:, :2]
    scale = (x64 ** 2).sum(1) + (c64 ** 2).sum(1).max()
    return (two[:, 1] - two[:, 0]) > 1e-4 * scale


@pytest.mark.parametrize("data", sorted(DATA))
@pytest.mark.parametrize("init", ["ndarray", "random"])
def test_kmeans_estimator_matches_reference(data, init):
    make, k = DATA[data]
    x = make()
    kw = dict(n_clusters=k, max_iter=15, tol=1e-4, random_state=0,
              init=_init_rows(x, k) if init == "ndarray" else "random")
    ref = RefKMeans(**kw).fit(ds.array(x))
    px = dst.array(x)
    port = PortKMeans(**kw).fit(px)
    assert port.n_iter_ == ref.n_iter_
    np.testing.assert_allclose(port.centers_, ref.centers_, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(port.history_, ref.history_, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(port.inertia_, ref.inertia_, rtol=1e-5)
    np.testing.assert_allclose(port.score(px), ref.score(ds.array(x)),
                               rtol=1e-5)
    got = port.predict(px).collect().ravel()
    want = ref.predict(ds.array(x)).collect().ravel()
    assert got.dtype == np.int32
    clear = _clear_rows(x, ref.centers_)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got[clear], want[clear])
    assert port_k.LAUNCHES["distances_sq"] == 0


def test_kmeans_random_init_draws_the_reference_rows():
    x = _uniform()
    a, p = ds.array(x), dst.array(x)
    ref = np.asarray(RefKMeans(n_clusters=3, random_state=7)._init_centers(a))
    got = PortKMeans(n_clusters=3, random_state=7)._init_centers(p).numpy()
    np.testing.assert_array_equal(got, ref)


def test_kmeans_unported_options_name_the_roadmap_item(monkeypatch):
    x = dst.array(_uniform())
    with pytest.raises(NotImplementedError, match="A.6"):
        PortKMeans(n_clusters=3, fast_distance=True).fit(x)
    monkeypatch.setenv("DSLIB_KMEANS_FAST_DISTANCE", "1")
    with pytest.raises(NotImplementedError, match="A.6"):
        PortKMeans(n_clusters=3).fit(x)
    monkeypatch.delenv("DSLIB_KMEANS_FAST_DISTANCE")
    with pytest.raises(NotImplementedError, match="A.12"):
        PortKMeans(n_clusters=3).fit(x, checkpoint=object())
    with pytest.raises(NotImplementedError, match="A.10"):
        PortKMeans(n_clusters=3).fit(_uniform())


def test_kmeans_get_set_params_and_clone():
    from dislib_tpu_torch.base import clone
    km = PortKMeans(n_clusters=5, max_iter=3)
    assert km.get_params()["n_clusters"] == 5
    km.set_params(tol=0.5)
    c = clone(km)
    assert c.get_params() == km.get_params() and c is not km
    with pytest.raises(ValueError):
        km.set_params(bogus=1)
    with pytest.raises(RuntimeError, match="not fitted"):
        km.predict(dst.array(_uniform()))
