"""The port's ALS against the reference's, on CPU.

The same numpy ratings go through ``dislib_tpu`` (8 virtual CPU devices)
and ``dislib_tpu_torch`` on the CPU.  The reference's starting item
factors (``jax.random.uniform`` of the second key of
``split(PRNGKey(seed))``, drawn at the padded item count and cropped) are
handed to the port's draw function (``als._draw_items``).  The
reference's sparse path fails under the installed jax (ROADMAP.md C.2),
so the port's sparse fit is held against the reference's DENSE fit on
the densified ratings.

Tolerances: factors within 1e-4 and ``history_`` within rtol 1e-5 of the
reference (float32 sweeps whose products and sums run in another order);
``n_iter_`` and ``converged_`` exactly; one sweep within 1e-4 of a
float64 NumPy solve of the per-row normal equations; the fold-in's
factors and scores within 1e-4 of the reference's ``_fold_in_body``, its
top-n ids equal wherever the scores are untied; two sparse fits, and a
sparse fit in one chunk or in many, bit-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import dislib_tpu as ds
from dislib_tpu.recommendation import ALS as RefALS
from dislib_tpu.recommendation import als as ref_als

import dislib_tpu_torch as dst
from dislib_tpu_torch.recommendation import ALS
from dislib_tpu_torch.recommendation import als as port_als
from dislib_tpu_torch.utils import profiling

M, N, F, LAM = 40, 24, 3, 0.065
TOL = 3.1e-4        # |ΔRMSE| first falls below it at the 21st sweep


def _ratings(seed=0, m=M, n=N, n_f=F, density=0.4):
    """Low-rank ratings in [1, 5] with an observed mask in which every row
    and column has a rating (``tests/test_als.py``'s draw)."""
    rng = np.random.RandomState(seed)
    u = rng.rand(m, n_f)
    v = rng.rand(n, n_f)
    full = u @ v.T
    full = 1.0 + 4.0 * (full - full.min()) / (full.max() - full.min())
    mask = rng.rand(m, n) < density
    mask[np.arange(m), rng.randint(0, n, m)] = True
    mask[rng.randint(0, m, n), np.arange(n)] = True
    return (full * mask).astype(np.float32), full.astype(np.float32), mask


def _ref_draw(seed, n, n_f, device):
    """The reference's V0: its dense fit draws at the padded item count."""
    n_pad = -(-n // 8) * 8
    _, kv = jax.random.split(jax.random.PRNGKey(seed))
    v0 = jax.random.uniform(kv, (n_pad, n_f), jnp.float32)
    return torch.from_numpy(np.array(v0)[:n]).to(device)


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    dst.init(device="cpu")
    monkeypatch.setattr(port_als, "_draw_items", _ref_draw)
    yield


@pytest.fixture(scope="module")
def data():
    r, full, mask = _ratings()
    test = np.where(~mask, full, 0.0).astype(np.float32)
    test[test != 0] *= np.random.RandomState(1).rand(
        int((test != 0).sum())) < 0.3
    return r, test


@pytest.fixture(scope="module")
def ref_fits(data):
    """The reference's dense fits, one per option set, fitted once."""
    ds.init()           # built before the conftest's per-test mesh reset
    r, test = data
    fits = {
        "plain": RefALS(n_f=F, lambda_=LAM, tol=0.0, max_iter=3,
                        random_state=0).fit(ds.array(r)),
        "test": RefALS(n_f=F, lambda_=LAM, tol=0.0, max_iter=3,
                       random_state=0).fit(ds.array(r), test=test),
        "tol": RefALS(n_f=F, lambda_=LAM, tol=TOL, max_iter=40,
                      random_state=0).fit(ds.array(r)),
    }
    return fits


def _close(port, ref):
    np.testing.assert_allclose(port.users_, ref.users_, rtol=0, atol=1e-4)
    np.testing.assert_allclose(port.items_, ref.items_, rtol=0, atol=1e-4)
    np.testing.assert_allclose(port.history_, ref.history_, rtol=1e-5)
    assert port.n_iter_ == ref.n_iter_
    assert port.converged_ == ref.converged_
    assert port.rmse_ == pytest.approx(ref.rmse_, rel=1e-5)


def _numpy_sweep(r, mask, v, lam):
    """One ALS sweep in float64: each row's normal equations solved."""
    f = v.shape[1]
    out = []
    for rr, mm, src in ((r, mask, v), (r.T, mask.T, None)):
        src = out[0] if src is None else src
        res = np.zeros((rr.shape[0], f))
        for i in range(rr.shape[0]):
            obs = mm[i]
            vo = src[obs]
            a = vo.T @ vo + lam * max(obs.sum(), 1) * np.eye(f)
            res[i] = np.linalg.solve(a, vo.T @ rr[i, obs])
        out.append(res)
    return out


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_fit_matches_the_reference_dense_fit(data, ref_fits, kind):
    r, _ = data
    x = dst.array(r, device="cpu") if kind == "dense" \
        else dst.SparseArray.from_dense(r, device="cpu")
    port = ALS(n_f=F, lambda_=LAM, tol=0.0, max_iter=3,
               random_state=0).fit(x)
    _close(port, ref_fits["plain"])
    assert port.history_.shape == (3,) and not port.converged_


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_held_out_ratings_drive_the_rmse(data, ref_fits, kind):
    r, test = data
    if kind == "dense":
        x, t = dst.array(r, device="cpu"), test
    else:
        x = dst.SparseArray.from_dense(r, device="cpu")
        t = sp.csr_matrix(test)
    port = ALS(n_f=F, lambda_=LAM, tol=0.0, max_iter=3,
               random_state=0).fit(x, test=t)
    _close(port, ref_fits["test"])
    assert port.rmse_ != pytest.approx(ref_fits["plain"].rmse_, rel=1e-3)
    with pytest.raises(ValueError, match="test ratings shape"):
        ALS(n_f=F, max_iter=1).fit(x, test=test[:, :5])


def test_tol_stops_at_the_reference_iteration(data, ref_fits):
    r, _ = data
    ref = ref_fits["tol"]
    assert ref.converged_ and 16 < ref.n_iter_ < 40
    # the stop is not a near tie: every |ΔRMSE| keeps a margin from tol
    steps = np.abs(np.diff(ref.history_))
    assert steps[-1] < TOL - 1e-5 and (steps[:-1] > TOL + 1e-5).all()
    profiling.reset_host_reads()
    port = ALS(n_f=F, lambda_=LAM, tol=TOL, max_iter=40,
               random_state=0).fit(dst.array(r, device="cpu"))
    _close(port, ref)
    # one read per chunk of EVERY sweeps until the stop, one of the results
    from dislib_tpu_torch.runtime.loop import EVERY
    assert profiling.HOST_READS == {"als": -(-port.n_iter_ // EVERY),
                                    "results": 1}
    profiling.reset_host_reads()
    ALS(n_f=F, lambda_=LAM, tol=0.0, max_iter=3, random_state=0).fit(
        dst.array(r, device="cpu"))
    assert profiling.HOST_READS == {"results": 1}


def test_one_sweep_matches_a_float64_solve(data):
    r, _ = data
    mask = r != 0
    port = ALS(n_f=F, lambda_=LAM, tol=-1.0, max_iter=1,
               random_state=0).fit(dst.array(r, device="cpu"))
    v0 = _ref_draw(0, N, F, "cpu").numpy().astype(np.float64)
    u1, v1 = _numpy_sweep(r.astype(np.float64), mask, v0, LAM)
    np.testing.assert_allclose(port.users_, u1, rtol=0, atol=1e-4)
    np.testing.assert_allclose(port.items_, v1, rtol=0, atol=1e-4)


def test_sparse_fit_is_fixed_order_and_row_aligned(data, monkeypatch):
    r, _ = data
    x = dst.SparseArray.from_dense(r, device="cpu")

    def fit():
        return ALS(n_f=F, lambda_=LAM, tol=0.0, max_iter=3,
                   random_state=0).fit(x)

    one = fit()
    np.testing.assert_array_equal(one.users_, fit().users_)
    # chunks of at most 16 entries: many chunks, none splitting a row
    monkeypatch.setattr(port_als, "SPARSE_BUDGET_BYTES", 16 * 4 * F * F)
    lengths = np.bincount(np.nonzero(r)[0], minlength=M)
    chunks = port_als._row_chunks(lengths, 16)
    assert len(chunks) > 10
    starts = np.concatenate([[0], np.cumsum(lengths)])
    assert chunks[0][0] == 0 and chunks[-1][1] == M
    for (r0, r1, e0, e1), nxt in zip(chunks, chunks[1:] + [None]):
        assert (e0, e1) == (starts[r0], starts[r1])
        assert e1 - e0 <= 16 or r1 == r0 + 1
        assert nxt is None or nxt[0] == r1
    many = fit()
    np.testing.assert_array_equal(one.users_, many.users_)
    np.testing.assert_array_equal(one.items_, many.items_)


def test_fold_in_matches_the_reference(data, ref_fits):
    r, _ = data
    ref = ref_fits["plain"]
    port = dst.from_fitted_arrays(ALS, {"users_": ref.users_,
                                        "items_": ref.items_},
                                  device="cpu", n_f=F, lambda_=LAM)
    new = r[5:10]
    cols, vals = ref_als._fold_in_pack(new, N)
    want_f, want_p = ref_als._fold_in_body(
        vals, cols, jnp.asarray(ref.items_), LAM, F, _ref_policy())
    want_p = np.asarray(want_p)
    np.testing.assert_allclose(port.fold_in(new), want_p, rtol=0, atol=1e-4)
    # the (cols, vals) pair and the packed [cols | vals] serving form
    pc, pv = (torch.from_numpy(np.array(a)) for a in (cols, vals))
    np.testing.assert_allclose(port.fold_in((pc, pv)), want_p, rtol=0,
                               atol=1e-4)
    buf = torch.cat([pc.float(), pv], dim=1)
    got_f, got_p = port_als._als_fold_in_packed(
        buf, torch.from_numpy(np.array(ref.items_)), LAM, F, _port_policy())
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got_p.numpy(), want_p, rtol=0, atol=1e-4)
    # top_n: the same scores; ids equal where the scores are untied
    ids, scores = port.fold_in(sp.csr_matrix(new), top_n=4)
    _, (rid, rsc) = ref_als._fold_in_body(
        vals, cols, jnp.asarray(ref.items_), LAM, F, _ref_policy(),
        top_n=4)
    np.testing.assert_allclose(scores, np.asarray(rsc), rtol=0, atol=1e-4)
    srt = -np.sort(-want_p, axis=1)
    untied = np.diff(srt[:, :5], axis=1) < -1e-4
    rid = np.asarray(rid)
    for i in range(ids.shape[0]):
        for j in range(4):
            if (j == 0 or untied[i, j - 1]) and untied[i, j]:
                assert ids[i, j] == rid[i, j]
    assert ids.dtype == np.int32
    # one user as a 1-D row; an out-of-range column adds nothing
    np.testing.assert_allclose(port.fold_in(new[0]), want_p[:1], rtol=0,
                               atol=1e-4)
    bad_c = torch.cat([pc, torch.full((5, 1), N + 3, dtype=pc.dtype)], 1)
    bad_v = torch.cat([pv, torch.ones((5, 1))], 1)
    np.testing.assert_allclose(port.fold_in((bad_c, bad_v)), want_p,
                               rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="items"):
        port.fold_in(r[:2, :5])


def _ref_policy():
    from dislib_tpu.ops import precision as ref_px
    return ref_px.FLOAT32


def _port_policy():
    from dislib_tpu_torch.ops import precision as px
    return px.FLOAT32


def test_predict_user_and_async_protocol(data, ref_fits):
    r, _ = data
    est = ALS(n_f=F, lambda_=LAM, tol=0.0, max_iter=3, random_state=0)
    est._fit_finalize(est._fit_async(dst.array(r, device="cpu")))
    _close(est, ref_fits["plain"])
    p = est.predict_user(3)
    np.testing.assert_allclose(p, ref_fits["plain"].predict_user(3),
                               rtol=0, atol=1e-4)
    with pytest.raises(IndexError):
        est.predict_user(M)


def test_unported_options_and_bad_input_raise(data, tmp_path):
    # checkpoint=/health= are ported: a checkpointed fit equals the
    # unchecked one bit for bit (the kill-and-resume cases are in
    # tests/test_torch_resilience.py)
    from dislib_tpu_torch.runtime import HealthPolicy
    from dislib_tpu_torch.utils.checkpoint import FitCheckpoint
    r, _ = data
    x = dst.array(r, device="cpu")
    plain = ALS(n_f=2, max_iter=4, tol=0.0, random_state=0).fit(x)
    ck = ALS(n_f=2, max_iter=4, tol=0.0, random_state=0).fit(
        x, checkpoint=FitCheckpoint(str(tmp_path / "als.npz"), every=2),
        health=HealthPolicy())
    np.testing.assert_array_equal(ck.users_, plain.users_)
    assert (plain.fit_info_["chunks"], ck.fit_info_["chunks"]) == (1, 2)
    with pytest.raises(ValueError, match="max_iter"):
        ALS(max_iter=0).fit(x)
    with pytest.raises(TypeError, match="ds-array"):
        ALS().fit(r)
    with pytest.raises(RuntimeError, match="not fitted"):
        ALS().fold_in(r[:1])


@pytest.mark.parametrize("fmt", ["json", "npz"])
def test_save_load_round_trip(data, tmp_path, fmt):
    r, _ = data
    est = ALS(n_f=F, lambda_=LAM, tol=0.0, max_iter=3,
              random_state=0).fit(dst.array(r, device="cpu"))
    path = str(tmp_path / f"als.{fmt}")
    dst.save_model(est, path, save_format=fmt)
    back = dst.load_model(path, device="cpu")
    assert isinstance(back, ALS) and back.get_params() == est.get_params()
    for name in ("users_", "items_", "history_"):
        np.testing.assert_array_equal(getattr(back, name),
                                      getattr(est, name))
    assert (back.n_iter_, back.converged_, back.rmse_) == \
        (est.n_iter_, est.converged_, est.rmse_)
    np.testing.assert_array_equal(back.fold_in(r[:3]), est.fold_in(r[:3]))
