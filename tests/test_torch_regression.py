"""The port's scalers, LinearRegression, ADMM and Lasso against the
reference's, on CPU.

The same numpy inputs go through ``dislib_tpu`` (8 virtual CPU devices) and
``dislib_tpu_torch`` on the CPU.  ADMM and Lasso run p = 8 consensus agents
in the port (``admm._agents`` returns 8), against the reference's 8 row
shards.  Tolerances: scaler statistics and transforms within rtol 1e-5
(f32 reductions in different orders; the large-mean case's variance within
1e-5 of float64 NumPy, which a one-pass variance misses by orders of
magnitude); LinearRegression's coefficients within rtol/atol 1e-4 (a
float32 normal-equations solve) and predictions within 1e-4; ADMM's ``z_``
and ``history_`` within rtol/atol 1e-4 and ``n_iter_`` exactly; R² scores
within 1e-5.
"""

import numpy as np
import pytest
import torch

import dislib_tpu as ds
from dislib_tpu.optimization import ADMM as RefADMM
from dislib_tpu.preprocessing import MinMaxScaler as RefMinMax
from dislib_tpu.preprocessing import StandardScaler as RefStd
from dislib_tpu.regression import Lasso as RefLasso
from dislib_tpu.regression import LinearRegression as RefLinear

import dislib_tpu_torch as dst
from dislib_tpu_torch.optimization import ADMM as PortADMM
from dislib_tpu_torch.optimization import admm as port_admm
from dislib_tpu_torch.preprocessing import MinMaxScaler as PortMinMax
from dislib_tpu_torch.preprocessing import StandardScaler as PortStd
from dislib_tpu_torch.regression import Lasso as PortLasso
from dislib_tpu_torch.regression import LinearRegression as PortLinear
from dislib_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _port_on_cpu():
    dst.init(device="cpu")
    yield


def _data(m=203, n=6, t=1, seed=0, sparse=False):
    """x, y = x·β + noise (+ 3 per target); β sparse when asked."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((m, n)).astype(np.float32)
    beta = rng.standard_normal((n, t))
    if sparse:
        beta[::2] = 0.0
    y = x @ beta + 3.0 + 0.1 * rng.standard_normal((m, t))
    return x, y.astype(np.float32)


# -- scalers -------------------------------------------------------------------

@pytest.mark.parametrize("with_mean,with_std", [(True, True), (False, True),
                                                (True, False)])
def test_standard_scaler_matches_reference(with_mean, with_std):
    x, _ = _data()
    kw = dict(with_mean=with_mean, with_std=with_std)
    ref, port = RefStd(**kw).fit(ds.array(x)), PortStd(**kw).fit(dst.array(x))
    for name in ("mean_", "var_"):
        np.testing.assert_allclose(getattr(port, name).collect(),
                                   getattr(ref, name).collect(), rtol=1e-5,
                                   atol=1e-6)
    t = port.transform(dst.array(x))
    np.testing.assert_allclose(t.collect(),
                               ref.transform(ds.array(x)).collect(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.inverse_transform(t).collect(), x,
                               rtol=1e-5, atol=1e-5)


def test_standard_scaler_large_mean_variance():
    # mean ~1e4, std ~1 (the reference's own regression case): the
    # two-pass variance keeps float32 close to float64
    x = (1e4 + np.random.RandomState(0).randn(200, 3)).astype(np.float32)
    ref, port = RefStd().fit(ds.array(x)), PortStd().fit(dst.array(x))
    want = x.astype(np.float64).var(axis=0)
    np.testing.assert_allclose(port.var_.collect().ravel(), want, rtol=1e-3)
    np.testing.assert_allclose(port.var_.collect(), ref.var_.collect(),
                               rtol=1e-5)
    t = port.transform(dst.array(x)).collect()
    assert abs(t.std() - 1.0) < 1e-3


def test_minmax_scaler_matches_reference():
    x, _ = _data(seed=1)
    x[:, 2] = 5.0                                   # a constant column
    kw = dict(feature_range=(-1, 2))
    ref = RefMinMax(**kw).fit(ds.array(x))
    port = PortMinMax(**kw).fit(dst.array(x))
    np.testing.assert_array_equal(port.data_min_.collect(),
                                  ref.data_min_.collect())
    np.testing.assert_array_equal(port.data_max_.collect(),
                                  ref.data_max_.collect())
    t = port.transform(dst.array(x))
    np.testing.assert_allclose(t.collect(),
                               ref.transform(ds.array(x)).collect(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port.inverse_transform(t).collect(), x,
                               rtol=1e-5, atol=1e-5)


def test_scalers_carried_from_reference_transform_like_it():
    x, _ = _data(seed=2)
    ref = RefStd().fit(ds.array(x))
    port = dst.from_fitted_arrays(PortStd, {
        "mean_": ref.mean_.collect(), "var_": ref.var_.collect()},
        device="cpu")
    np.testing.assert_allclose(port.transform(dst.array(x)).collect(),
                               ref.transform(ds.array(x)).collect(),
                               rtol=1e-6, atol=1e-6)
    ref = RefMinMax().fit(ds.array(x))
    port = dst.from_fitted_arrays(PortMinMax, {
        "data_min_": ref.data_min_.collect(),
        "data_max_": ref.data_max_.collect()}, device="cpu")
    np.testing.assert_allclose(port.transform(dst.array(x)).collect(),
                               ref.transform(ds.array(x)).collect(),
                               rtol=1e-6, atol=1e-6)


def test_sparse_input_names_a10():
    # sparse input, as in the reference: StandardScaler(with_mean=False)
    # fits one-pass moments (within 1e-5 of the reference's), MinMaxScaler
    # refuses, LinearRegression and Lasso densify (bit-equal to the fit on
    # the dense array)
    import scipy.sparse as sp
    from dislib_tpu.data.sparse import SparseArray as RefSparse
    x, y = _data(m=96)
    x[np.abs(x) < 0.8] = 0.0
    xs = sp.csr_matrix(x)
    ps, rs = dst.SparseArray.from_scipy(xs), RefSparse.from_scipy(xs)
    port, ref = PortStd(with_mean=False).fit(ps), \
        RefStd(with_mean=False).fit(rs)
    for name in ("mean_", "var_"):
        np.testing.assert_allclose(getattr(port, name).collect(),
                                   getattr(ref, name).collect(), rtol=1e-5,
                                   atol=1e-6)
    for est, arr in ((PortMinMax(), ps), (RefMinMax(), rs)):
        with pytest.raises(TypeError):
            est.fit(arr)
    y_p = dst.array(y)
    for cls in (PortLinear, PortLasso):
        sparse, dense = cls().fit(ps, y_p), cls().fit(dst.array(x), y_p)
        np.testing.assert_array_equal(sparse.coef_, dense.coef_)


# -- LinearRegression ----------------------------------------------------------

@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("targets", [1, 3])
def test_linear_regression_matches_reference(fit_intercept, targets):
    x, y = _data(t=targets)
    kw = dict(fit_intercept=fit_intercept)
    ref = RefLinear(**kw).fit(ds.array(x), ds.array(y))
    port = PortLinear(**kw).fit(dst.array(x), dst.array(y))
    np.testing.assert_allclose(port.coef_, ref.coef_, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(port.intercept_, ref.intercept_, rtol=1e-4,
                               atol=1e-4)
    assert port.coef_.shape == (6, targets)
    np.testing.assert_allclose(port.predict(dst.array(x)).collect(),
                               ref.predict(ds.array(x)).collect(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(port.score(dst.array(x), dst.array(y)),
                               ref.score(ds.array(x), ds.array(y)),
                               rtol=1e-5, atol=1e-5)
    # the carried model predicts what the reference does
    carried = dst.from_fitted_arrays(
        PortLinear, {"coef_": ref.coef_, "intercept_": ref.intercept_},
        device="cpu")
    np.testing.assert_allclose(carried.predict(dst.array(x)).collect(),
                               ref.predict(ds.array(x)).collect(),
                               rtol=1e-5, atol=1e-5)


# -- ADMM and Lasso at p = 8 -----------------------------------------------------

@pytest.fixture
def eight_agents(monkeypatch):
    assert ds.get_mesh().shape["rows"] == 8
    monkeypatch.setattr(port_admm, "_agents", lambda: 8)


@pytest.mark.parametrize("m", [203, 256])
def test_admm_matches_reference_at_eight_agents(eight_agents, m):
    x, y = _data(m=m, seed=3)
    kw = dict(rho=1.0, max_iter=200, abstol=1e-6, reltol=1e-5)
    ref = RefADMM(**kw).fit(ds.array(x), ds.array(y - 3.0))
    profiling.reset_host_reads()
    port = PortADMM(**kw).fit(dst.array(x), dst.array(y - 3.0))
    assert port.n_iter_ == ref.n_iter_ and port.converged_ == ref.converged_
    np.testing.assert_allclose(port.z_, ref.z_, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(port.history_, ref.history_, rtol=1e-4,
                               atol=1e-4)
    from dislib_tpu_torch.runtime.loop import EVERY
    assert profiling.HOST_READS["admm"] <= -(-port.n_iter_ // EVERY)


@pytest.mark.parametrize("lmbd", [5.0, 40.0])
def test_lasso_matches_reference_at_eight_agents(eight_agents, lmbd):
    x, y = _data(m=256, seed=4, sparse=True)
    y = y - 3.0
    kw = dict(lmbd=lmbd, rho=1.0, max_iter=300, atol=1e-5, rtol=1e-4)
    ref = RefLasso(**kw).fit(ds.array(x), ds.array(y))
    port = PortLasso(**kw).fit(dst.array(x), dst.array(y))
    assert port.n_iter_ == ref.n_iter_ and port.converged_ == ref.converged_
    np.testing.assert_allclose(port.coef_, ref.coef_, rtol=1e-4, atol=1e-4)
    assert (port.coef_ == 0).sum() == (ref.coef_ == 0).sum()
    np.testing.assert_allclose(port.predict(dst.array(x)).collect(),
                               ref.predict(ds.array(x)).collect(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(port.score(dst.array(x), dst.array(y)),
                               ref.score(ds.array(x), ds.array(y)),
                               rtol=1e-5, atol=1e-5)
    carried = dst.from_fitted_arrays(PortLasso, {"coef_": ref.coef_},
                                     device="cpu")
    np.testing.assert_allclose(carried.predict(dst.array(x)).collect(),
                               ref.predict(ds.array(x)).collect(),
                               rtol=1e-5, atol=1e-5)


def test_soft_threshold_and_one_agent_lasso():
    v = torch.tensor([-3.0, -0.5, 0.0, 0.2, 2.0])
    np.testing.assert_array_equal(port_admm.soft_threshold(v, 1.0).numpy(),
                                  [-2.0, 0.0, 0.0, 0.0, 1.0])
    # one agent (the card's mesh): kappa = lmbd / rho
    assert port_admm._agents() == 1
    assert PortLasso(lmbd=4.0, rho=2.0)._admm().prox_kappa == 2.0
    with pytest.raises(ValueError, match="single target"):
        PortADMM().fit(dst.array(np.ones((8, 2), np.float32)),
                       dst.array(np.ones((8, 2), np.float32)))
