"""The port's GaussianMixture against the reference's, on CPU.

The same numpy inputs go through ``dislib_tpu`` (8 virtual CPU devices) and
``dislib_tpu_torch`` on the CPU, where the KMeans init's ``distances_sq``
kernel runs its plain version.  The reference's ``init_params="random"``
draw (``jax.random.uniform``) is handed to the port's draw function
(``gm._random_resp``).  Tolerances: ``weights_``, ``means_``,
``covariances_``, ``lower_bound_`` and ``history_`` within rtol/atol 1e-4
(float32 EM steps whose GEMMs and reductions sum in different orders, over
up to 40 iterations); ``n_iter_`` and ``converged_`` exactly; ``predict``
labels exactly on rows whose two best log-probabilities differ by more than
1e-3; ``score`` within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dislib_tpu as ds
from dislib_tpu.cluster import GaussianMixture as RefGM

import dislib_tpu_torch as dst
from dislib_tpu_torch.cluster import GaussianMixture as PortGM
from dislib_tpu_torch.cluster import gm as port_gm
from dislib_tpu_torch.ops import kernels as port_k
from dislib_tpu_torch.utils import profiling

COV_TYPES = ["full", "tied", "diag", "spherical"]
K, D = 3, 4


def _blobs(m=480, seed=0):
    """Three blobs of different spreads; m a multiple of 8, so the
    reference's 8-device row padding adds no rows."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-6, 6, (K, D))
    scale = np.array([0.5, 1.0, 1.5])
    lab = rng.randint(0, K, m)
    x = centers[lab] + scale[lab, None] * rng.standard_normal((m, D))
    return x.astype(np.float32)


def _ref_draw(seed, shape, device):
    """The reference's random-init draw, handed to the port."""
    u = jax.random.uniform(jax.random.PRNGKey(seed), shape,
                           dtype=jnp.float32)
    return torch.from_numpy(np.array(u)).to(device)


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    dst.init(device="cpu")
    port_k.reset_launches()
    monkeypatch.setattr(port_gm, "_random_resp", _ref_draw)
    yield


def _explicit(cov, x):
    rng = np.random.RandomState(4)
    means = x[rng.choice(len(x), K, replace=False)]
    weights = np.full(K, 1.0 / K, np.float32)
    a = rng.standard_normal((K, D, D)) * 0.1
    spd = np.eye(D) + a @ a.transpose(0, 2, 1)
    prec = {"full": spd, "tied": spd[0], "diag": 1.0 + rng.rand(K, D),
            "spherical": 1.0 + rng.rand(K)}[cov]
    return dict(weights_init=weights, means_init=means, precisions_init=prec)


def _log_probs(x, est):
    """float64 log-probabilities (m, k) of a fitted reference mixture."""
    from scipy.stats import multivariate_normal
    cov = est.covariances_.astype(np.float64)
    out = []
    for c in range(K):
        sigma = {"full": lambda: cov[c], "tied": lambda: cov,
                 "diag": lambda: np.diag(cov[c]),
                 "spherical": lambda: cov[c] * np.eye(D)}[
                     est.covariance_type]()
        out.append(np.log(est.weights_[c]) + multivariate_normal(
            est.means_[c], sigma).logpdf(x.astype(np.float64)))
    return np.stack(out, 1)


@pytest.mark.parametrize("cov", COV_TYPES)
@pytest.mark.parametrize("init", ["kmeans", "random", "explicit"])
def test_gm_matches_reference(cov, init):
    x = _blobs()
    kw = dict(n_components=K, covariance_type=cov, max_iter=40, tol=1e-4,
              random_state=0)
    if init == "explicit":
        kw.update(_explicit(cov, x))
    else:
        kw["init_params"] = init
    a = ds.array(x)
    assert a._data.shape[0] == x.shape[0]
    ref = RefGM(**kw).fit(a)
    p = dst.array(x)
    profiling.reset_host_reads()
    port = PortGM(**kw).fit(p)
    assert port.n_iter_ == ref.n_iter_
    assert port.converged_ == ref.converged_
    for name in ("weights_", "means_", "covariances_"):
        np.testing.assert_allclose(getattr(port, name), getattr(ref, name),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(port.lower_bound_, ref.lower_bound_,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(port.history_, ref.history_, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(port.score(p), ref.score(a), rtol=1e-5,
                               atol=1e-5)
    got = port.predict(p).collect().ravel()
    want = ref.predict(a).collect().ravel()
    assert got.dtype == np.int32
    lp = np.sort(_log_probs(x, ref), axis=1)
    clear = lp[:, -1] - lp[:, -2] > 1e-3
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got[clear], want[clear])
    # the EM loop read its condition once per chunk of masked steps
    from dislib_tpu_torch.runtime.loop import EVERY
    assert profiling.HOST_READS.get("gm", 0) <= -(-port.max_iter // EVERY)
    assert port_k.LAUNCHES["distances_sq"] == 0


def test_gm_stops_within_a_chunk_of_convergence(monkeypatch):
    # each EM step of the port's loop is counted: at most EVERY - 1 masked
    # steps past the reference's stop
    from dislib_tpu_torch.runtime import loop
    steps = []
    e_step = port_gm._e_step
    monkeypatch.setattr(port_gm, "_e_step",
                        lambda *a: steps.append(1) or e_step(*a))
    x = _blobs(seed=3)
    kw = dict(n_components=K, max_iter=100, tol=1e-3, random_state=1,
              init_params="random")
    ref = RefGM(**kw).fit(ds.array(x))
    port = PortGM(**kw).fit(dst.array(x))
    assert port.converged_ and port.n_iter_ == ref.n_iter_ < 100
    assert port.n_iter_ <= len(steps) <= port.n_iter_ + loop.EVERY - 1


def test_gm_random_init_is_one_named_draw():
    x = _blobs()
    p = dst.array(x)
    resp = PortGM(n_components=K, init_params="random",
                  random_state=5)._init_resp(p).numpy()
    ref = np.asarray(RefGM(n_components=K, init_params="random",
                           random_state=5)._init_resp(ds.array(x)))
    np.testing.assert_allclose(resp, ref, rtol=1e-6)


def test_gm_carried_from_reference_predicts_like_it():
    x = _blobs()
    a = ds.array(x)
    for cov in COV_TYPES:
        ref = RefGM(n_components=K, covariance_type=cov,
                    random_state=0).fit(a)
        port = dst.from_fitted_arrays(PortGM, {
            "weights_": ref.weights_, "means_": ref.means_,
            "covariances_": ref.covariances_,
            "covariance_type": ref.covariance_type}, device="cpu")
        lp = np.sort(_log_probs(x, ref), axis=1)
        clear = lp[:, -1] - lp[:, -2] > 1e-3
        got = port.predict(dst.array(x)).collect().ravel()
        np.testing.assert_array_equal(got[clear],
                                      ref.predict(a).collect().ravel()[clear])
        np.testing.assert_allclose(port.score(dst.array(x)), ref.score(a),
                                   rtol=1e-5, atol=1e-5)


def test_gm_refusals_name_the_roadmap_items(monkeypatch, tmp_path):
    from dislib_tpu_torch.utils.checkpoint import FitCheckpoint
    p = dst.array(_blobs())
    # checkpoint= is ported: a checkpointed fit is the same fit
    plain = PortGM(n_components=K, random_state=0, max_iter=6, tol=0).fit(p)
    ck = PortGM(n_components=K, random_state=0, max_iter=6, tol=0).fit(
        p, checkpoint=FitCheckpoint(str(tmp_path / "gm.npz"), every=4))
    np.testing.assert_array_equal(ck.means_, plain.means_)
    assert ck.fit_info_["chunks"] == 2
    # a SparseArray densifies through its lazy backing, as in the
    # reference: the fit equals the fit on the dense array, bit for bit
    sparse = PortGM(n_components=K, random_state=0).fit(
        dst.SparseArray.from_dense(_blobs()))
    dense = PortGM(n_components=K, random_state=0).fit(p)
    for name in ("weights_", "means_", "covariances_", "history_"):
        np.testing.assert_array_equal(getattr(sparse, name),
                                      getattr(dense, name))
    with pytest.raises(TypeError):
        PortGM(n_components=K).fit(_blobs())
    # KMeans' fast mode is ported: GM's kmeans init runs it, and the fit
    # ends fitted and finite
    monkeypatch.setenv("DSLIB_KMEANS_FAST_DISTANCE", "1")
    fast = PortGM(n_components=K, random_state=0).fit(p)
    assert np.isfinite(fast.means_).all() and fast.means_.shape[0] == K
    monkeypatch.delenv("DSLIB_KMEANS_FAST_DISTANCE")
    with pytest.raises(ValueError, match="covariance_type"):
        PortGM(covariance_type="bogus").fit(p)
    with pytest.raises(RuntimeError, match="not fitted"):
        PortGM().predict(p)


def test_gm_non_positive_definite_covariance_gives_nan_as_reference():
    # a singular covariance: jnp.linalg.cholesky returns NaN, the port keeps
    # that (torch.linalg.cholesky would raise)
    covs = torch.zeros((2, D, D))
    covs[0] = torch.eye(D)
    prec = port_gm._chol_precisions(covs, "full", D)
    assert torch.isfinite(prec[0]).all() and torch.isnan(prec[1]).all()
