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
from dislib_tpu.ops import base as ref_ops

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


def test_kmeans_tol_zero_reads_nothing_and_matches_a_nan_stop():
    # at tol = 0 the loop reads no condition; a NaN row makes the first
    # shift NaN, which stops the reference's while_loop after one step:
    # the port's masked steps leave the same state and n_iter
    from dislib_tpu_torch.utils import profiling
    x = _uniform()
    x[7, 2] = np.nan
    c0 = _init_rows(_uniform(), 3)
    a = ds.array(x)
    rc, rn, _, rs, rh, _ = [np.asarray(v) for v in ref_km._kmeans_fit(
        a._data, a.shape, jnp.asarray(c0), 12, 0.0)]
    profiling.reset_host_reads()
    p = dst.array(x)
    gc, gn, _, gs, gh, _ = [v.numpy() for v in port_km._kmeans_fit(
        p._data, p.shape, torch.from_numpy(c0), 12, 0.0)]
    assert profiling.HOST_READS.get("kmeans", 0) == 0
    assert int(gn) == int(rn) == 1 and np.isnan(gs) and np.isnan(rs)
    np.testing.assert_allclose(gc, rc, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gh, rh, rtol=1e-5, atol=1e-5)


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
    # fast_distance (A.6) is ported: the argument and the environment
    # variable both select it (held against the reference below)
    x = dst.array(_uniform())
    monkeypatch.setenv("DSLIB_KMEANS_FAST_DISTANCE", "1")
    assert PortKMeans(n_clusters=3)._fast()
    assert not PortKMeans(n_clusters=3, fast_distance=False)._fast()
    monkeypatch.delenv("DSLIB_KMEANS_FAST_DISTANCE")
    assert PortKMeans(n_clusters=3, fast_distance=True)._fast()
    # checkpoint= is ported (tests/test_torch_fitloop.py holds it against
    # the reference): a checkpointed fit is the same fit
    import tempfile
    from dislib_tpu_torch.utils.checkpoint import FitCheckpoint
    plain = PortKMeans(n_clusters=3, random_state=0, max_iter=4).fit(x)
    with tempfile.TemporaryDirectory() as d:
        ck = PortKMeans(n_clusters=3, random_state=0, max_iter=4).fit(
            x, checkpoint=FitCheckpoint(f"{d}/km.npz", every=2))
    np.testing.assert_array_equal(ck.centers_, plain.centers_)
    # sparse input is ported (held against the reference in
    # tests/test_torch_sparse.py); host data is not a ds-array
    import scipy.sparse as sp
    km = PortKMeans(n_clusters=3, random_state=0, max_iter=2).fit(
        dst.SparseArray.from_scipy(sp.csr_matrix(_uniform())))
    assert km.centers_.shape == (3, 5)
    with pytest.raises(TypeError, match="SparseArray"):
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


@pytest.mark.parametrize("data", sorted(DATA))
def test_kmeans_tol_fit_stops_within_a_chunk_of_convergence(data,
                                                            monkeypatch):
    # every Lloyd step the port enqueues runs distances_sq once: count them
    from dislib_tpu_torch.runtime import loop
    from dislib_tpu_torch.utils import profiling
    steps = []
    dist = port_km._distances_sq
    monkeypatch.setattr(port_km, "_distances_sq",
                        lambda *a, **kw: steps.append(1) or dist(*a, **kw))
    make, k = DATA[data]
    x = make()
    kw = dict(n_clusters=k, init=_init_rows(x, k), max_iter=300, tol=1e-4)
    ref = RefKMeans(**kw).fit(ds.array(x))
    profiling.reset_host_reads()
    port = PortKMeans(**kw).fit(dst.array(x))
    n = ref.n_iter_
    assert port.n_iter_ == n < 300
    assert n <= len(steps) <= n + loop.EVERY - 1
    # one read per chunk run, never a read after the last possible chunk
    assert profiling.HOST_READS["kmeans"] == -(-len(steps) // loop.EVERY) \
        <= -(-300 // loop.EVERY)
    np.testing.assert_allclose(port.centers_, ref.centers_, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(port.history_, ref.history_, rtol=1e-5,
                               atol=1e-5)


def test_run_chunked_counts_its_steps_and_reads(monkeypatch):
    from dislib_tpu_torch.runtime import loop
    from dislib_tpu_torch.utils import profiling
    profiling.reset_host_reads()
    seen = []
    # the condition turns false after step 5: the loop ends with its chunk
    monkeypatch.setattr(loop, "EVERY", 4)
    ran = loop.run_chunked(seen.append, lambda: torch.tensor(len(seen) < 6),
                           20, "t")
    assert ran == 8 and seen == list(range(8))
    assert profiling.HOST_READS["t"] == 2
    # never true: max_iter steps, and no read after the last chunk
    profiling.reset_host_reads()
    assert loop.run_chunked(lambda t: None, lambda: torch.tensor(True), 10,
                            "t") == 10
    assert profiling.HOST_READS["t"] == 2
    # no condition (a tolerance <= 0): max_iter steps and no read at all
    profiling.reset_host_reads()
    seen.clear()
    assert loop.run_chunked(seen.append, None, 10, "t") == 10
    assert seen == list(range(10)) and profiling.HOST_READS.get("t", 0) == 0
    # a NaN shift stops KMeans as the reference's cond does
    shift = torch.tensor(float("nan"))
    assert not bool(shift >= 1e-4)


# -- fast_distance (the E-step on bf16 operands) --------------------------------
#
# Tolerances: labels exactly (well-separated blobs: no row is near a tie
# that the bf16 rounding of x and the centers, ~2^-8 relative, could flip);
# centers and inertia at 1e-5, as the float32 fits above: with equal labels
# the M-step sums the same float32 rows in both packages, and the inertia
# sums float32 distances whose cross terms are exact bf16 products added
# in different orders.

def _ref_fast_distances(x, c):
    """The reference's fast E-step (``cluster/kmeans.py``'s ``step`` with
    ``fast=True``): the bf16 copy of x against the bf16-rounded centers,
    products summed in float32, norms float32 from the unrounded operands."""
    xj, cj = jnp.asarray(x), jnp.asarray(c)
    cross = jnp.matmul(xj.astype(jnp.bfloat16), cj.astype(jnp.bfloat16).T,
                       precision="default", preferred_element_type=jnp.float32)
    d = jnp.sum(xj * xj, axis=1, keepdims=True) - 2.0 * cross \
        + jnp.sum(cj * cj, axis=1)[None, :]
    return np.asarray(jnp.maximum(d, 0.0))


def test_plain_bf16_variant_matches_the_reference():
    rng = np.random.RandomState(5)
    x = (rng.standard_normal((300, 13)) * 3).astype(np.float32)
    c = rng.standard_normal((7, 13)).astype(np.float32)
    want = _ref_fast_distances(x, c)
    scale = (x.astype(np.float64) ** 2).sum(1).max() + \
        (c.astype(np.float64) ** 2).sum(1).max()
    tx, tc = torch.from_numpy(x), torch.from_numpy(c)
    a16 = port_k.bf16_rows(tx)
    assert a16.shape == (300, 16) and a16.dtype == torch.bfloat16
    assert not a16[:, 13:].any()
    from dislib_tpu_torch.ops import base as port_base
    outs = [port_k.distances_sq_bf16(a16, (tx * tx).sum(1), tc),
            port_k.distances_sq(tx, tc, precision="default"),
            port_k.distances_sq(tx, tc, precision="bfloat16"),
            port_base.distances_sq(tx, tc, precision="default",
                                   use_kernel=True)]
    for out in outs:
        assert out.dtype == torch.float32 and (out >= 0).all()
        assert np.abs(out.numpy() - want).max() / scale <= 1e-6
    # against a float64 computation on the rounded operands
    x16 = tx.to(torch.bfloat16).double().numpy()
    c16 = tc.to(torch.bfloat16).double().numpy()
    exact = np.maximum((x.astype(np.float64) ** 2).sum(1)[:, None]
                       - 2.0 * x16 @ c16.T
                       + (c.astype(np.float64) ** 2).sum(1)[None], 0.0)
    assert np.abs(outs[0].numpy() - exact).max() / scale <= 1e-6
    # the reference's distances_sq(..., precision="default") is float32 on
    # the CPU (JAX's default precision there is full float32): the bf16
    # variant is within the bf16 rounding of the cross term of it
    ref_default = np.asarray(ref_ops.distances_sq(
        jnp.asarray(x), jnp.asarray(c), precision="default"))
    bound = 2 * 2.0 ** -8 * np.sqrt((x.astype(np.float64) ** 2).sum(1))[
        :, None] * np.sqrt((c.astype(np.float64) ** 2).sum(1))[None] * 2
    assert (np.abs(outs[0].numpy() - ref_default) <= bound + 1e-5).all()
    assert port_k.LAUNCHES["distances_sq"] == 0


@pytest.mark.parametrize("max_iter,tol", [(1, 0.0), (20, 1e-4)])
def test_kmeans_fast_fit_matches_reference(max_iter, tol):
    x = _blobs()
    c0 = _init_rows(_blobs(seed=0), 4, seed=3)
    a = ds.array(x)
    ref = [np.asarray(v) for v in ref_km._kmeans_fit(
        a._data, a.shape, jnp.asarray(c0), max_iter, tol, fast=True)]
    got = [v.numpy() for v in port_km._kmeans_fit(
        torch.from_numpy(x), x.shape, torch.from_numpy(c0), max_iter, tol,
        fast=True)]
    centers, n_iter, inertia = got[:3]
    assert int(n_iter) == int(ref[1])
    np.testing.assert_allclose(centers, ref[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(inertia, ref[2], rtol=1e-5)


def test_kmeans_fast_distance_estimator_matches_reference(monkeypatch):
    x = _blobs(seed=2)
    init = _init_rows(x, 4, seed=1)
    a, p = ds.array(x), dst.array(x)
    ref = RefKMeans(n_clusters=4, init=init, max_iter=10,
                    fast_distance=True).fit(a)
    port = PortKMeans(n_clusters=4, init=init, max_iter=10,
                      fast_distance=True).fit(p)
    assert port.n_iter_ == ref.n_iter_
    np.testing.assert_allclose(port.centers_, ref.centers_, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(port.inertia_, ref.inertia_, rtol=1e-5)
    # predict stays float32 in both: labels equal the float32 fit's
    np.testing.assert_array_equal(port.predict(p).collect(),
                                  np.asarray(ref.predict(a).collect()))
    # the environment variable selects the same mode
    monkeypatch.setenv("DSLIB_KMEANS_FAST_DISTANCE", "1")
    env = PortKMeans(n_clusters=4, init=init, max_iter=10).fit(p)
    np.testing.assert_array_equal(env.centers_, port.centers_)
