"""Every iterative estimator of the port on its fit loop, on the CPU.

- **C.14**: a non-finite input to KMeans, GaussianMixture, ALS and
  ``MiniBatchKMeans.partial_fit`` raises ``NumericalDivergence`` with the
  reference's guard name (the port used to return NaN models).
- ``fit_info_`` equals the reference's on the same data for KMeans, GM,
  ALS, MiniBatchKMeans, CascadeSVM, the forest, DBSCAN and Daura.
- One kill-and-resume per estimator, held bit-identical to the port's
  own uninterrupted fit: the kill is a preemption requested from the
  guard's admit seam at an exact chunk (deterministic, in the main
  thread), the resume a fresh estimator on a fresh ``FitCheckpoint``.
"""

import numpy as np
import pytest
import torch

import dislib_tpu as ds
from dislib_tpu.runtime.health import NumericalDivergence as RefDivergence

import dislib_tpu_torch as dst
from dislib_tpu_torch.runtime import health as port_health
from dislib_tpu_torch.runtime import preemption as port_pre
from dislib_tpu_torch.utils.checkpoint import FitCheckpoint


@pytest.fixture(autouse=True)
def _cpu():
    dst.init(device="cpu")
    port_pre.clear_preemption()
    yield
    port_pre.clear_preemption()


def _rng(seed=0):
    return np.random.RandomState(seed)


def _blobs(m=128, n=4, k=3, seed=0):
    rng = _rng(seed)
    c = rng.uniform(-5, 5, (k, n))
    return (c[rng.randint(0, k, m)] + rng.standard_normal((m, n))).astype(
        np.float32)


def _ratings(m=30, n=20, seed=1):
    rng = _rng(seed)
    return ((rng.rand(m, n) < 0.4) * rng.randint(1, 6, (m, n))).astype(
        np.float32)


def _two_classes(m=128, seed=2):
    rng = _rng(seed)
    x = np.r_[rng.randn(m // 2, 4), rng.randn(m // 2, 4) + 3.0]
    y = np.r_[np.zeros(m // 2), np.ones(m // 2)]
    return x.astype(np.float32), y.astype(np.float32)[:, None]


def _chain(m=64):
    # one cluster along a line: min-label propagation needs several rounds
    t = np.arange(m, dtype=np.float32) * 0.3
    return np.c_[t, np.zeros(m, np.float32)]


def _frames(m=40, seed=3):
    return _rng(seed).rand(m, 6).astype(np.float32)


# -- C.14: non-finite fits raise, as in the reference ---------------------------

def _with_nan(a):
    a = a.copy()
    a.flat[a.size // 3] = np.nan
    return a


NAN_CASES = {
    "kmeans": (lambda p: p.KMeans(n_clusters=3, random_state=0),
               lambda est, p: est.fit(p.array(_with_nan(_blobs()))),
               "nonfinite"),
    "gm": (lambda p: p.GaussianMixture(n_components=2, random_state=0),
           lambda est, p: est.fit(p.array(_with_nan(_blobs()))),
           "nonfinite"),
    "als": (lambda p: p.ALS(n_f=2, max_iter=3, random_state=0),
            lambda est, p: est.fit(p.array(_with_nan(_ratings()))),
            "nonfinite"),
    "minibatch": (lambda p: p.MiniBatchKMeans(n_clusters=2, random_state=0),
                  lambda est, p: est.partial_fit(
                      p.array(_with_nan(_blobs()))),
                  "input-nonfinite"),
}


@pytest.mark.parametrize("name", sorted(NAN_CASES))
def test_nonfinite_fit_raises_the_references_guard(name):
    make, fit, guard = NAN_CASES[name]
    with pytest.raises(RefDivergence) as ref:
        fit(make(ds), ds)
    with pytest.raises(port_health.NumericalDivergence) as got:
        fit(make(dst), dst)
    assert got.value.guard == ref.value.guard == guard
    assert got.value.estimator == ref.value.estimator


# -- fit_info_ against the reference ---------------------------------------------

FIT_CASES = {
    "kmeans": (lambda p: p.KMeans(n_clusters=3, random_state=0, max_iter=5),
               lambda p: (p.array(_blobs()),)),
    "gm": (lambda p: p.GaussianMixture(n_components=2, random_state=0,
                                       max_iter=5, tol=0.0),
           lambda p: (p.array(_blobs()),)),
    "als": (lambda p: p.ALS(n_f=2, max_iter=3, tol=0.0, random_state=0),
            lambda p: (p.array(_ratings()),)),
    "minibatch": (lambda p: p.MiniBatchKMeans(n_clusters=3, batch_size=32,
                                              random_state=0),
                  lambda p: (p.array(_blobs()),)),
    "csvm": (lambda p: p.CascadeSVM(max_iter=2, check_convergence=False),
             lambda p: (p.array(_two_classes(64)[0], block_size=(32, 4)),
                        p.array(_two_classes(64)[1]))),
    "forest": (lambda p: p.RandomForestClassifier(n_estimators=2,
                                                  max_depth=2,
                                                  random_state=0),
               lambda p: (p.array(_two_classes()[0]),
                          p.array(_two_classes()[1]))),
    "dbscan": (lambda p: p.DBSCAN(eps=0.5, min_samples=3),
               lambda p: (p.array(_chain()),)),
    "daura": (lambda p: p.Daura(cutoff=0.3),
              lambda p: (p.array(_frames()),)),
}


@pytest.mark.parametrize("name", sorted(FIT_CASES))
def test_fit_info_equals_the_references(name):
    make, args = FIT_CASES[name]
    ref = make(ds).fit(*args(ds))
    got = make(dst).fit(*args(dst))
    assert got.fit_info_ == ref.fit_info_


# -- one kill-and-resume per estimator ------------------------------------------

class _PreemptAt(port_health.HealthPolicy):
    """Requests preemption when the ``at_chunk``-th chunk is admitted; the
    loop raises ``Preempted`` at that chunk's boundary, after its
    snapshot."""

    def __init__(self, at_chunk):
        super().__init__()
        self.at_chunk = int(at_chunk)

    def make_guard(self, name, checkpoint=None):
        return _PreemptGuard(name, self, checkpoint)


class _PreemptGuard(port_health.ChunkGuard):
    def admit(self, *carries):
        carries = super().admit(*carries)
        if self.chunk_index == self.policy.at_chunk:
            port_pre.request_preemption()
        return carries


def _same(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _same(u, v)
    else:
        np.testing.assert_array_equal(a, b)


KILL_CASES = {
    "gm": (lambda: dst.GaussianMixture(n_components=3, random_state=0,
                                       max_iter=12, tol=0.0),
           lambda: (dst.array(_blobs()),), 3, 2,
           ("weights_", "means_", "covariances_", "lower_bound_",
            "n_iter_")),
    "als": (lambda: dst.ALS(n_f=3, max_iter=6, tol=0.0, random_state=0),
            lambda: (dst.array(_ratings()),), 1, 3,
            ("users_", "items_", "rmse_", "n_iter_")),
    "minibatch": (lambda: dst.MiniBatchKMeans(n_clusters=3, batch_size=16,
                                              random_state=0),
                  lambda: (dst.array(_blobs()),), 2, 3,
                  ("centers_", "counts_", "n_batches_")),
    "forest": (lambda: dst.RandomForestClassifier(
                   n_estimators=3, random_state=0, try_features="sqrt"),
               lambda: (dst.array(_two_classes()[0]),
                        dst.array(_two_classes()[1])), 2, 2,
               ("_feats", "_tbins", "_leaves")),
    "csvm": (lambda: dst.CascadeSVM(max_iter=2, check_convergence=False),
             lambda: (dst.array(_two_classes(64)[0], block_size=(32, 4)),
                      dst.array(_two_classes(64)[1])), 1, 1,
             ("_sv_idx", "_sv_alpha", "_sv_x")),
    "dbscan": (lambda: dst.DBSCAN(eps=0.5, min_samples=3),
               lambda: (dst.array(_chain()),), 1, 2,
               ("labels_", "core_sample_indices_")),
    "daura": (lambda: dst.Daura(cutoff=0.3),
              lambda: (dst.array(_frames()),), 1, 2,
              ("labels_", "clusters_")),
}


@pytest.mark.parametrize("name", sorted(KILL_CASES))
def test_kill_and_resume_is_bit_identical(name, tmp_path):
    make, args, every, at_chunk, attrs = KILL_CASES[name]
    plain = make().fit(*args())
    path = str(tmp_path / f"{name}.npz")
    with pytest.raises(port_pre.Preempted):
        make().fit(*args(), checkpoint=FitCheckpoint(path, every=every),
                   health=_PreemptAt(at_chunk))
    port_pre.clear_preemption()
    snap = FitCheckpoint(path).load()
    assert snap is not None
    resumed = make().fit(*args(), checkpoint=FitCheckpoint(path,
                                                           every=every))
    for attr in attrs:
        _same(getattr(resumed, attr), getattr(plain, attr))
    assert resumed.fit_info_["chunks"] >= 1
