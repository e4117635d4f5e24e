"""The port's KFold, GridSearchCV, RandomizedSearchCV, shuffle,
train_test_split and the estimators' async-trial hooks, on CPU.

The same numpy inputs go through ``dislib_tpu`` (8 virtual CPU devices) and
``dislib_tpu_torch`` on the CPU.  Tolerances: folds, permutations,
``best_params_`` and ``rank_test_score`` exactly equal; ``cv_results_``
scores within 1e-6 (relative for the KMeans scores, negative inertias in
the tens: float32 sums in different orders); an estimator's
``_score_async(_fit_async(x, y))`` within 1e-6 of ``fit`` then ``score``
(the same arithmetic, a device scalar against a host float).
"""

import logging

import numpy as np
import pytest
import scipy.stats
import torch

import dislib_tpu as ds
from dislib_tpu.classification import KNeighborsClassifier as RefKNN
from dislib_tpu.cluster import KMeans as RefKMeans
from dislib_tpu.model_selection import GridSearchCV as RefGrid
from dislib_tpu.model_selection import KFold as RefKFold
from dislib_tpu.model_selection import RandomizedSearchCV as RefRandom
from dislib_tpu.utils import shuffle as ref_shuffle
from dislib_tpu.utils import train_test_split as ref_split

import dislib_tpu_torch as dst
import dislib_tpu_torch.base as port_base
from dislib_tpu_torch.base import BaseEstimator
from dislib_tpu_torch.classification import KNeighborsClassifier as PortKNN
from dislib_tpu_torch.cluster import GaussianMixture, KMeans
from dislib_tpu_torch.model_selection import GridSearchCV, KFold, \
    RandomizedSearchCV
from dislib_tpu_torch.optimization import ADMM
from dislib_tpu_torch.regression import Lasso, LinearRegression
from dislib_tpu_torch.trees import (DecisionTreeClassifier,
                                    DecisionTreeRegressor,
                                    RandomForestClassifier,
                                    RandomForestRegressor)
from dislib_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _port_on_cpu():
    dst.init(device="cpu")
    yield


def _blobs(seed=0, m=120, n=4, k=3, std=0.15):
    rng = np.random.RandomState(seed)
    centers = rng.rand(k, n).astype(np.float32)
    lab = rng.randint(0, k, m)
    x = (centers[lab] + std * rng.standard_normal((m, n))).astype(np.float32)
    return x, lab.astype(np.float32)[:, None]


def _results_match(port, ref, rtol=0.0):
    n_folds = sum(k.startswith("split") for k in ref.cv_results_)
    for j in range(n_folds):
        np.testing.assert_allclose(port.cv_results_[f"split{j}_test_score"],
                                   ref.cv_results_[f"split{j}_test_score"],
                                   rtol=rtol, atol=0.0 if rtol else 1e-6)
    np.testing.assert_array_equal(port.cv_results_["rank_test_score"],
                                  ref.cv_results_["rank_test_score"])
    assert port.cv_results_["params"] == ref.cv_results_["params"]
    assert port.best_params_ == ref.best_params_


# -- (e) KFold ---------------------------------------------------------------

@pytest.mark.parametrize("shuffle", [False, True])
def test_kfold_matches_reference(shuffle):
    x, y = _blobs(m=23)
    kw = dict(n_splits=4, shuffle=shuffle, random_state=3)
    ref = list(RefKFold(**kw).split(ds.array(x), ds.array(y)))
    port = list(KFold(**kw).split(dst.array(x), dst.array(y)))
    assert len(port) == len(ref) == 4
    for p, r in zip(port, ref):
        for a, b in zip(p, r):
            np.testing.assert_array_equal(a.collect(), b.collect())
    assert [f[1] for f in KFold(n_splits=3).split(dst.array(x))] == \
        [None] * 3
    with pytest.raises(ValueError, match="n_splits"):
        next(KFold(n_splits=24).split(dst.array(x)))


# -- (f) the searches ----------------------------------------------------------

def test_grid_search_knn_matches_reference():
    x, y = _blobs(std=0.3)
    grid = {"n_neighbors": [1, 4, 9], "weights": ["uniform", "distance"]}
    ref = RefGrid(RefKNN(), grid, cv=3).fit(ds.array(x), ds.array(y))
    port = GridSearchCV(PortKNN(), grid, cv=3).fit(dst.array(x),
                                                   dst.array(y))
    _results_match(port, ref)
    np.testing.assert_array_equal(port.predict(dst.array(x)).collect(),
                                  ref.predict(ds.array(x)).collect())
    assert abs(port.score(dst.array(x), dst.array(y))
               - ref.score(ds.array(x), ds.array(y))) <= 1e-6


def test_grid_search_kmeans_matches_reference():
    x, _ = _blobs(seed=1)
    grid = {"n_clusters": [2, 3, 4]}
    kw = dict(random_state=0, max_iter=10, tol=0.0)
    ref = RefGrid(RefKMeans(**kw), grid, cv=3, refit=False).fit(ds.array(x))
    port = GridSearchCV(KMeans(**kw), grid, cv=3, refit=False).fit(
        dst.array(x))
    _results_match(port, ref, rtol=1e-6)
    assert not hasattr(port, "best_estimator_")
    with pytest.raises(RuntimeError, match="refit"):
        port.predict(dst.array(x))


def test_randomized_search_matches_reference():
    x, y = _blobs(seed=2, std=0.3)
    dists = {"n_neighbors": scipy.stats.randint(1, 8),
             "weights": ["uniform", "distance"]}
    kw = dict(n_iter=5, cv=KFold(n_splits=3, shuffle=True, random_state=1),
              random_state=4)
    ref_kw = dict(kw, cv=RefKFold(n_splits=3, shuffle=True, random_state=1))
    ref = RefRandom(RefKNN(), dists, **ref_kw).fit(ds.array(x), ds.array(y))
    port = RandomizedSearchCV(PortKNN(), dists, **kw).fit(dst.array(x),
                                                          dst.array(y))
    _results_match(port, ref)


@pytest.mark.parametrize("scoring", ["accuracy", lambda est, xv, yv: 0.5])
def test_scorers(scoring):
    x, y = _blobs(seed=3)
    gs = GridSearchCV(PortKNN(), {"n_neighbors": [1, 3]}, cv=2,
                      scoring=scoring, refit=False).fit(dst.array(x),
                                                        dst.array(y))
    ref = RefGrid(RefKNN(), {"n_neighbors": [1, 3]}, cv=2, scoring=scoring,
                  refit=False).fit(ds.array(x), ds.array(y))
    _results_match(gs, ref)
    with pytest.raises(ValueError, match="unknown scorer"):
        GridSearchCV(PortKNN(), {"n_neighbors": [1]}, cv=2,
                     scoring="bogus").fit(dst.array(x), dst.array(y))


def test_r2_scorer_over_linear_regression():
    rng = np.random.RandomState(5)
    x = rng.rand(60, 3).astype(np.float32)
    y = (x @ [1.0, -2.0, 0.5] + 0.1).astype(np.float32)[:, None]
    gs = GridSearchCV(LinearRegression(), {"fit_intercept": [True, False]},
                      cv=3, scoring="r2").fit(dst.array(x), dst.array(y))
    assert gs.best_params_ == {"fit_intercept": True}
    assert gs.best_score_ > 0.999


# -- (g) shuffle and train_test_split ------------------------------------------

def test_shuffle_matches_reference_and_numpy():
    x, y = _blobs(m=41)
    xs, ys = dst.shuffle(dst.array(x), dst.array(y), random_state=7)
    rx, ry = ref_shuffle(ds.array(x), ds.array(y), random_state=7)
    perm = np.random.RandomState(7).permutation(41)
    np.testing.assert_array_equal(xs.collect(), x[perm])
    np.testing.assert_array_equal(ys.collect(), y[perm])
    np.testing.assert_array_equal(xs.collect(), rx.collect())
    np.testing.assert_array_equal(ys.collect(), ry.collect())
    np.testing.assert_array_equal(
        dst.shuffle(dst.array(x), random_state=np.random.RandomState(7))
        .collect(), x[perm])
    with pytest.raises(ValueError, match="same number of rows"):
        dst.shuffle(dst.array(x), dst.array(y[:5]))


@pytest.mark.parametrize("test_size,train_size", [(0.25, None), (0.3, 0.5)])
def test_train_test_split_matches_reference(test_size, train_size):
    x, y = _blobs(m=41)
    kw = dict(test_size=test_size, train_size=train_size, random_state=2)
    port = dst.train_test_split(dst.array(x), dst.array(y), **kw)
    ref = ref_split(ds.array(x), ds.array(y), **kw)
    assert len(port) == 4
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p.collect(), r.collect())
    xt, xv = dst.train_test_split(dst.array(x), **kw)
    np.testing.assert_array_equal(xt.collect(), port[0].collect())
    np.testing.assert_array_equal(xv.collect(), port[1].collect())
    with pytest.raises(ValueError, match="same number of rows"):
        dst.train_test_split(dst.array(x), dst.array(y[:5]))


# -- (h) the async-trial hooks of each estimator -------------------------------

def _xy(seed=6, m=90, n=3):
    rng = np.random.RandomState(seed)
    x = rng.rand(m, n).astype(np.float32)
    y = (x @ np.arange(1.0, n + 1) - 2.0 + 0.05 * rng.standard_normal(m))
    return x, y.astype(np.float32)[:, None]


def _labels(seed=6):
    x, lab = _blobs(seed=seed, m=90, n=3, std=0.2)
    return x, lab


ESTIMATORS = {
    "kmeans": (lambda: KMeans(n_clusters=3, random_state=0, max_iter=20),
               _blobs, False),
    "kmeans_tol0": (lambda: KMeans(n_clusters=3, random_state=0, tol=0.0),
                    _blobs, False),
    "gm": (lambda: GaussianMixture(n_components=2, random_state=0,
                                   max_iter=15), _blobs, False),
    "linear": (LinearRegression, _xy, True),
    "lasso": (lambda: Lasso(lmbd=0.5, max_iter=60), _xy, True),
    "tree_cls": (lambda: DecisionTreeClassifier(max_depth=4), _labels, True),
    "tree_reg": (lambda: DecisionTreeRegressor(max_depth=4), _xy, True),
    "forest_cls": (lambda: RandomForestClassifier(n_estimators=4,
                                                  random_state=0),
                   _labels, True),
    "forest_reg": (lambda: RandomForestRegressor(n_estimators=4,
                                                 random_state=0), _xy, True),
}


@pytest.mark.parametrize("name", list(ESTIMATORS))
def test_score_async_of_fit_async_equals_fit_then_score(name):
    make, data, supervised = ESTIMATORS[name]
    x, y = data()
    X, Y = dst.array(x), dst.array(y)
    args = (X, Y) if supervised else (X,)
    est = make()
    state = est._fit_async(*args)
    assert state is not None
    got = est._score_async(state, *args)
    assert isinstance(got, torch.Tensor) and got.dim() == 0
    want = make().fit(*args).score(*args)
    assert abs(float(got) - want) <= 1e-6 * max(1.0, abs(want))
    est._fit_finalize(state)
    assert abs(est.score(*args) - want) <= 1e-6 * max(1.0, abs(want))


def test_admm_fit_async_equals_fit():
    x, y = _xy()
    X, Y = dst.array(x), dst.array(y)
    sync = ADMM(rho=2.0, max_iter=40).fit(X, Y)
    est = ADMM(rho=2.0, max_iter=40)
    est._fit_finalize(est._fit_async(X, Y))
    np.testing.assert_array_equal(est.z_, sync.z_)
    assert (est.n_iter_, est.converged_) == (sync.n_iter_, sync.converged_)


def test_fit_async_reads_nothing_at_tol_zero():
    x, _ = _blobs()
    profiling.reset_host_reads()
    state = KMeans(n_clusters=3, random_state=0, tol=0.0)._fit_async(
        dst.array(x))
    assert profiling.HOST_READS == {}
    assert isinstance(state[0], torch.Tensor)


# -- the dispatch protocol -----------------------------------------------------

def test_folds_pipeline_two_deep(monkeypatch):
    """Fold f's scores are read only after fold f+1's fits are
    dispatched."""
    events = []
    orig_fit, orig_score = KMeans._fit_async, KMeans._score_async

    class _ReadLogged:
        def __init__(self, v):
            self.v = v

        def __float__(self):
            events.append("read")
            return float(self.v)

    def spy_fit(self, x, y=None):
        events.append("fit")
        return orig_fit(self, x, y)

    def spy_score(self, state, x, y=None):
        return _ReadLogged(orig_score(self, state, x, y))

    monkeypatch.setattr(KMeans, "_fit_async", spy_fit)
    monkeypatch.setattr(KMeans, "_score_async", spy_score)
    x, _ = _blobs(m=90)
    GridSearchCV(KMeans(random_state=0, max_iter=3),
                 {"n_clusters": [2, 3]}, cv=3, refit=False).fit(dst.array(x))
    assert events == (["fit"] * 2 + ["fit"] * 2 + ["read"] * 2
                      + ["fit"] * 2 + ["read"] * 2 + ["read"] * 2)


def test_scores_stay_tensors_until_read():
    """Every score is read once, through host_read, and no other read
    happens in a kNN search (its fits read nothing); the refit reads its
    classes_ once."""
    x, y = _blobs(seed=8)
    profiling.reset_host_reads()
    GridSearchCV(PortKNN(), {"n_neighbors": [1, 3, 5]}, cv=4,
                 refit=False).fit(dst.array(x), dst.array(y))
    assert profiling.HOST_READS == {"search": 12}
    profiling.reset_host_reads()
    GridSearchCV(PortKNN(), {"n_neighbors": [1, 3]}, cv=2).fit(
        dst.array(x), dst.array(y))
    assert profiling.HOST_READS == {"search": 4, "results": 1}


@pytest.mark.parametrize("labels", ["int", "float", "one_class"])
def test_knn_fit_async_maps_codes_without_a_read(labels):
    """The classifier's codes come from the device with no host read and
    equal the reference's host mapping; classes_ is read once, at
    _fit_finalize."""
    x, y = _blobs(seed=9)
    y = {"int": (y * 3 - 2).astype(np.int64),
         "float": y.astype(np.float32) * 0.5 + 0.25,
         "one_class": np.full_like(y, 7.0, dtype=np.float32)}[labels]
    est = PortKNN(n_neighbors=3)
    profiling.reset_host_reads()
    state = est._fit_async(dst.array(x), dst.array(y))
    assert profiling.HOST_READS == {}
    classes = np.unique(y)
    np.testing.assert_array_equal(est._codes.numpy(),
                                  np.searchsorted(classes, y.ravel()))
    est._fit_finalize(state)
    assert profiling.HOST_READS == {"results": 1}
    np.testing.assert_array_equal(est.classes_, classes)
    assert est.classes_.dtype == classes.dtype


def test_fallback_notice_logged_once(caplog):
    class _NoAsync(BaseEstimator):
        def __init__(self, a=1):
            self.a = a

        def fit(self, x, y=None):
            self.done_ = True
            return self

        def score(self, x, y=None):
            return float(self.a)

    port_base._ASYNC_FALLBACK_NOTICED.discard("_NoAsync")
    x, _ = _blobs(m=60)
    with caplog.at_level(logging.INFO, logger="dslib.search"):
        gs = GridSearchCV(_NoAsync(), {"a": [1, 2]}, cv=2,
                          refit=False).fit(dst.array(x))
    notices = [r for r in caplog.records
               if "does not implement _fit_async" in r.message]
    assert len(notices) == 1
    assert gs.best_params_ == {"a": 2}


def test_default_score_async_finalizes_first():
    class _Half(BaseEstimator):
        def __init__(self, a=1):
            self.a = a

        def _fit_async(self, x, y=None):
            return torch.tensor(float(self.a))

        def _fit_finalize(self, state):
            self.fitted_ = float(state)

        def score(self, x, y=None):
            return self.fitted_

    x, _ = _blobs(m=30)
    assert _Half(a=3)._score_async(torch.tensor(3.0), dst.array(x)) == 3.0
    with pytest.raises(TypeError, match="no score"):
        BaseEstimator()._score_async(None, dst.array(x))
