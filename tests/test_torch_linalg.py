"""The port's blocked linear algebra against the reference's, on CPU.

The same numpy inputs go through ``dislib_tpu`` (8 virtual CPU devices, so
its tsQR tree has p = 8 row shards) and ``dislib_tpu_torch`` on the CPU
(p = 1), and both against a float64 NumPy oracle.  Each result is held to
its row of ``ERROR_BOUNDS`` under both policies:

- tsqr/qr: ‖QᵀQ − I‖_max ≤ ``*_orth`` and ‖QR − A‖_F/‖A‖_F ≤ ``*_resid``
  against the oracle; Q and R against the reference's after the sign
  normalisation diag(R) ≥ 0, max abs difference ≤ ``*_orth`` for Q and
  ``*_resid`` relative to max|R| for R;
- svd: values within ``svd_values`` of the oracle's relative to σ₁, the
  factors' residual within ``svd_resid``; under float32 U and V against
  the reference's (each U column signed so its largest entry is positive,
  V's column alike) within ``svd_resid`` — under bfloat16 the sweeps stop
  at the policy's 5e-3 floor, where singular values 1.5% apart (cond 10
  over 160 values) leave their vectors mixed, so U and V are held through
  the residual only;
- polar: ``polar_orth``/``polar_resid`` against the oracle, the iteration
  count EQUAL to the reference's, U against the reference's within
  ``polar_orth``;
- random_svd / lanczos_svd: values within ``randomsvd_values`` /
  ``lanczos_values`` of the oracle's and of the reference's, relative to
  σ₁, with the reference's own draw injected into the port's one draw
  function (JAX's threefry stream cannot be reproduced in torch);
- PCA: explained variance within 1e-5 relative (float32; 2e-2 under
  bfloat16, the reference's own PCA policy test) and components (signed
  as above) within 5e-4 of the reference's — the scatter form
  XᵀX − m·μμᵀ cancels about three digits at the data's mean of 3 —, and
  transform and inverse_transform within 5e-4 of their largest entry;
- kron: bit-equal (one product per element on both sides).
"""

import importlib

import jax
import numpy as np
import pytest
import torch

import dislib_tpu as ds
from dislib_tpu.ops import precision as ref_px

import dislib_tpu_torch as dst
from dislib_tpu_torch.data.array import Array as PortArray
from dislib_tpu_torch.ops import precision as port_px
from dislib_tpu_torch.utils import profiling as port_prof

port_tsqr = importlib.import_module("dislib_tpu_torch.decomposition.tsqr")
port_qr = importlib.import_module("dislib_tpu_torch.math.qr")
port_rsvd = importlib.import_module("dislib_tpu_torch.decomposition.randomsvd")
port_lz = importlib.import_module("dislib_tpu_torch.decomposition.lanczos")
port_base = importlib.import_module("dislib_tpu_torch.math.base")
ref_qr = importlib.import_module("dislib_tpu.math.qr")

POLICIES = ("float32", "bfloat16")
B = port_px.ERROR_BOUNDS


@pytest.fixture(autouse=True)
def _port_on_cpu():
    dst.init(device="cpu")
    port_prof.reset_host_reads()
    yield


def test_the_bounds_are_the_reference_table():
    assert B == ref_px.ERROR_BOUNDS


def _conditioned(m, n, cond, seed=0):
    """(m, n) float32 matrix with condition number ~cond and σ₁ = 1 (the
    reference's precision-test recipe)."""
    rng = np.random.RandomState(seed)
    k = min(m, n)
    u, _ = np.linalg.qr(rng.standard_normal((m, k)))
    v, _ = np.linalg.qr(rng.standard_normal((n, k)))
    s = np.logspace(0, -np.log10(cond), k)
    return ((u * s) @ v.T).astype(np.float32)


def _decayed(m, n, seed, rate=0.9):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((m, n)) * rate ** np.arange(n)).astype(
        np.float32)


def _qr_signed(q, r):
    """diag(R) ≥ 0; a full Q's complement columns (defined only up to a
    sign each) signed by their largest entry."""
    k = min(r.shape)
    d = np.where(np.diag(r)[:k] < 0, -1.0, 1.0)
    q = np.hstack([q[:, :k] * d, q[:, k:] * _col_signs(q[:, k:])])
    return q, r[:k] * d[:, None]


def _col_signs(u):
    idx = np.abs(u).argmax(0)
    return np.where(u[idx, np.arange(u.shape[1])] < 0, -1.0, 1.0)


def _orth(q):
    return np.abs(q.T.astype(np.float64) @ q - np.eye(q.shape[1])).max()


def _resid(q, r, x):
    return np.linalg.norm(q.astype(np.float64) @ r - x) / np.linalg.norm(x)


def _hold_qr(port, ref, x, key, policy):
    """The tsqr/qr contract: both factorisations against the oracle, and
    the port's against the reference's after sign normalisation."""
    (qp, rp), (qr_, rr) = [(np.asarray(q.collect()), np.asarray(r.collect()))
                           for q, r in (port, ref)]
    assert _orth(qp) <= B[(f"{key}_orth", policy)]
    assert _resid(qp, rp, x) <= B[(f"{key}_resid", policy)]
    assert _resid(qr_, rr, x) <= B[(f"{key}_resid", policy)]
    (qp, rp), (qr_, rr) = _qr_signed(qp, rp), _qr_signed(qr_, rr)
    assert np.abs(qp - qr_).max() <= B[(f"{key}_orth", policy)]
    assert np.abs(rp - rr).max() / np.abs(rr).max() <= \
        B[(f"{key}_resid", policy)]


# -- tsqr ------------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("route", ["0", "1"], ids=["tree", "cholqr2"])
def test_tsqr_matches_reference(policy, route, monkeypatch):
    monkeypatch.setenv("DSLIB_TSQR_CHOLQR", route)
    x = _conditioned(512, 48, 10.0, seed=3)
    ref = ds.tsqr(ds.array(x, block_size=(64, 48)), precision=policy)
    port = dst.tsqr(dst.array(x, block_size=(64, 48)), precision=policy)
    _hold_qr(port, ref, x, "tsqr", policy)
    # CholeskyQR2 reads one scalar per local QR: the shard's and the
    # R-stack's (p = 1)
    assert port_prof.HOST_READS == ({"cholqr2_ok": 2} if route == "1"
                                    else {})
    assert dst.tsqr(dst.array(x), mode="r").shape == (48, 48)
    q_sel, _ = dst.tsqr(dst.array(x), indexes=[0, 5])
    assert q_sel.shape == (512, 2)


@pytest.mark.parametrize("route", [False, True], ids=["tree", "cholqr2"])
def test_tsqr_tree_over_eight_shards_matches_reference(route, monkeypatch):
    """``_tsqr_shardmap`` written for p shards: at the reference's p = 8
    it gives the reference's factors."""
    monkeypatch.setenv("DSLIB_TSQR_CHOLQR", "1" if route else "0")
    x = _conditioned(1024, 32, 100.0, seed=4)
    ref = ds.tsqr(ds.array(x, block_size=(128, 32)))
    q, r = port_tsqr._tsqr_shardmap(torch.from_numpy(x), dst.get_mesh(), 8,
                                    cholqr=route)
    mesh = dst.get_mesh()
    port = (PortArray(q, (1024, 32), mesh), PortArray(r, (32, 32), mesh))
    _hold_qr(port, ref, x, "tsqr", "float32")
    assert port_prof.HOST_READS == ({"cholqr2_ok": 9} if route else {})


def test_cholqr_breakdown_falls_back_to_the_tree(monkeypatch):
    """cond ≈ 1e5 squares to a Gram of cond ≈ 1e10, past float32: the
    CholeskyQR2 result is refused (one host read per local QR) and the
    Householder tree's is returned — the same factors as the tree route,
    within the bounds of the reference's own CholeskyQR2 run."""
    x = _conditioned(512, 24, 1e5, seed=5)
    monkeypatch.setenv("DSLIB_TSQR_CHOLQR", "0")
    q0, r0 = dst.tsqr(dst.array(x))
    monkeypatch.setenv("DSLIB_TSQR_CHOLQR", "1")
    port = dst.tsqr(dst.array(x))
    assert port_prof.HOST_READS == {"cholqr2_ok": 2}
    np.testing.assert_array_equal(port[0].collect(), q0.collect())
    np.testing.assert_array_equal(port[1].collect(), r0.collect())
    _, _, ok = port_tsqr._cholqr2(torch.from_numpy(x))
    assert not bool(ok)
    ref = ds.tsqr(ds.array(x, block_size=(64, 24)))
    qp, rp = port[0].collect(), port[1].collect()
    assert _orth(qp) <= B[("tsqr_orth", "float32")]
    assert _resid(qp, rp, x) <= B[("tsqr_resid", "float32")]
    qr_, rr = ref[0].collect(), ref[1].collect()
    assert _resid(qr_, rr, x) <= B[("tsqr_resid", "float32")]


def test_cholqr_exact_breakdown_is_folded_into_ok():
    """A duplicated column makes the Gram singular: ``cholesky_ex``
    reports it through ``info`` instead of raising."""
    base = np.random.RandomState(6).standard_normal((64, 4)).astype(
        np.float32)
    x = torch.from_numpy(np.hstack([base, base[:, :1]]))
    _, _, ok = port_tsqr._cholqr2(x)
    assert not bool(ok)
    q, r = port_tsqr._local_qr(x, True)
    np.testing.assert_allclose((q @ r).numpy(), x.numpy(), atol=1e-5)


# -- qr --------------------------------------------------------------------------

@pytest.fixture
def small_panel(monkeypatch):
    monkeypatch.setattr(port_qr, "_PANEL", 16)
    monkeypatch.setattr(ref_qr, "_PANEL", 16)


@pytest.mark.parametrize("policy", POLICIES)
def test_qr_economic_and_r_match_reference(policy, small_panel):
    x = _conditioned(256, 40, 10.0, seed=7)
    ref = ds.qr(ds.array(x, block_size=(32, 40)), mode="economic",
                precision=policy)
    port = dst.qr(dst.array(x), mode="economic", precision=policy)
    _hold_qr(port, ref, x, "qr", policy)
    r_only = dst.qr(dst.array(x), mode="r", precision=policy).collect()
    np.testing.assert_array_equal(r_only, port[1].collect())


def test_qr_full_matches_reference(small_panel, monkeypatch):
    """m − n > _PANEL: the complement path, with the reference's Gaussian
    block injected into the port's one draw."""
    m, n = 256, 40
    x = _conditioned(m, n, 10.0, seed=8)
    g = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (m, m - n),
                                     np.float32))
    monkeypatch.setattr(port_qr, "_complement_draw",
                        lambda mp, k, device: torch.from_numpy(g[:mp, :k]
                                                               .copy()))
    qr_, rr = [np.asarray(v.collect())
               for v in ds.qr(ds.array(x, block_size=(32, 40)))]
    qp, rp = [v.collect() for v in dst.qr(dst.array(x))]
    assert qp.shape == (m, m) and rp.shape == (m, n)
    assert _orth(qp) <= B[("qr_orth", "float32")]
    assert _resid(qp, rp, x) <= B[("qr_resid", "float32")]
    (qp, rp), (qr_, rr) = _qr_signed(qp, rp), _qr_signed(qr_, rr)
    assert np.abs(qp - qr_).max() <= B[("qr_orth", "float32")]
    assert np.abs(rp - rr).max() <= B[("qr_resid", "float32")]


@pytest.mark.parametrize("policy", POLICIES)
def test_qr_full_complement_is_orthogonal_to_q1(policy, small_panel):
    """The complement factored from a projected Gaussian seed: one
    projection pass (the reference's) leaves ‖Q₁ᵀQ₂‖ amplified by the
    seed's conditioning, past 1e-6 under float32 and past ``qr_orth``
    under bfloat16 here (this test fails without the second pass); the
    port projects Q₂ against Q₁ once more in float32 and refactors it.
    Bounds: the cross term within 1e-6 under float32 (working precision)
    and the whole Q within ``qr_orth`` under both policies."""
    m, n = 256, 40
    x = _conditioned(m, n, 10.0, seed=8)
    q, r = dst.qr(dst.array(x), precision=policy)
    qh = q.collect()
    assert _orth(qh) <= B[("qr_orth", policy)]
    assert _resid(qh, r.collect(), x) <= B[("qr_resid", policy)]
    if policy == "float32":
        assert np.abs(qh[:, :n].T.astype(np.float64) @ qh[:, n:]).max() \
            <= 1e-6


@pytest.mark.parametrize("mode", ["full", "economic", "r"])
def test_qr_small_fallback_matches_reference(mode):
    x = _conditioned(30, 10, 10.0, seed=9)
    ref, port = ds.qr(ds.array(x), mode=mode), dst.qr(dst.array(x),
                                                      mode=mode)
    if mode == "r":
        np.testing.assert_allclose(np.abs(port.collect()),
                                   np.abs(np.asarray(ref.collect())),
                                   atol=B[("qr_resid", "float32")])
        return
    _hold_qr(port, ref, x, "qr", "float32")
    assert port[0].shape == ref[0].shape


# -- svd -------------------------------------------------------------------------

def _hold_svd(port, ref, x, policy):
    up, sp, vp = [np.asarray(v.collect()) for v in port]
    ur, sr, vr = [np.asarray(v.collect()) for v in ref]
    sp, sr = sp.ravel(), sr.ravel()
    s_ref = np.linalg.svd(x.astype(np.float64), compute_uv=False)
    assert np.abs(sp - s_ref).max() / s_ref[0] <= B[("svd_values", policy)]
    assert np.abs(sp - sr).max() / s_ref[0] <= B[("svd_values", policy)]
    resid = np.linalg.norm(x - (up * sp) @ vp.T) / np.linalg.norm(x)
    assert resid <= B[("svd_resid", policy)]
    if policy != "float32":
        return
    sgp, sgr = _col_signs(up), _col_signs(ur)
    assert np.abs(up * sgp - ur * sgr).max() <= B[("svd_resid", policy)]
    assert np.abs(vp * sgp - vr * sgr).max() <= B[("svd_resid", policy)]


@pytest.mark.parametrize("policy", POLICIES)
def test_svd_block_tier_matches_reference(policy):
    """n = 160 ≥ 2·64: three column blocks (one padded), a padded pair in
    every round."""
    x = _conditioned(256, 160, 10.0, seed=11)
    ref = ds.svd(ds.array(x), precision=policy)
    port = dst.svd(dst.array(x), precision=policy)
    _hold_svd(port, ref, x, policy)
    sweeps = port_prof.HOST_READS["svd_sweep"]
    assert 1 <= sweeps <= 30


def test_svd_scalar_tier_matches_reference_and_ignores_the_policy():
    x = _conditioned(48, 24, 10.0, seed=12)
    ref = ds.svd(ds.array(x))
    port = dst.svd(dst.array(x))
    _hold_svd(port, ref, x, "float32")
    np.testing.assert_array_equal(
        dst.svd(dst.array(x), compute_uv=False,
                precision="bfloat16").collect(), port[1].collect())


def test_svd_odd_width_and_a_poisoned_pad():
    """An odd column count (a padded pair each round), and a hand-padded
    backing whose pad holds garbage: the ingest re-mask keeps it out (the
    pad columns change the round-robin schedule, so the vectors agree up
    to a sign each)."""
    x = _conditioned(40, 7, 10.0, seed=13)
    clean = dst.svd(dst.array(x))
    data = torch.full((45, 9), 1e3)
    data[:40, :7] = torch.from_numpy(x)
    dirty = dst.svd(PortArray(data, (40, 7), dst.get_mesh()))
    _hold_svd(dirty, clean, x, "float32")
    assert (dirty[0]._data[40:] == 0).all() and \
        (dirty[2]._data[7:] == 0).all() and (dirty[2]._data[:, 7:] == 0).all()
    ref = ds.svd(ds.array(x))
    _hold_svd(clean, ref, x, "float32")


def test_pair_svd_is_an_svd():
    g = torch.Generator().manual_seed(19)
    _, r = torch.linalg.qr(torch.rand((3, 300, 32), generator=g))
    u, s, vh = port_base._pair_svd(r)
    eye = torch.eye(32)
    assert float((u.transpose(1, 2) @ u - eye).abs().max()) <= 1e-5
    assert float((vh @ vh.transpose(1, 2) - eye).abs().max()) <= 1e-5
    assert float(((u * s[:, None, :]) @ vh - r).abs().max()
                 / r.abs().max()) <= 1e-5
    assert bool((s[:, :-1] >= s[:, 1:]).all())


def test_svd_eps_clamp_warns():
    with pytest.warns(RuntimeWarning, match="clamping"):
        dst.svd(dst.array(_conditioned(20, 5, 10.0)), eps=1e-9)


def test_grow_canvas_re_masks():
    data = torch.arange(12.0).reshape(3, 4)
    got = port_base.grow_canvas(data, (4, 6), valid=(2, 3))
    want = np.zeros((4, 6), np.float32)
    want[:2, :3] = data.numpy()[:2, :3]
    np.testing.assert_array_equal(got.numpy(), want)
    assert port_base.grow_canvas(data, (3, 4)) is data


# -- polar -----------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("cond", [10.0, 1e4])
def test_polar_matches_reference(policy, cond):
    x = _conditioned(192, 40, cond, seed=14)
    ur, hr, info_r = ds.polar(ds.array(x), precision=policy, max_iter=60,
                              info=True)
    up, hp, info_p = dst.polar(dst.array(x), precision=policy, max_iter=60,
                               info=True)
    assert info_p["iterations"] == info_r["iterations"]
    assert port_prof.HOST_READS["polar_iteration"] == info_p["iterations"]
    uh, hh = up.collect(), hp.collect()
    assert _orth(uh) <= B[("polar_orth", policy)]
    assert np.linalg.norm(uh.astype(np.float64) @ hh - x) \
        / np.linalg.norm(x) <= B[("polar_resid", policy)]
    assert np.abs(uh - np.asarray(ur.collect())).max() <= \
        B[("polar_orth", policy)]
    # the reported error is the returned U's, measured by the policy's Gram
    if policy == "float32":
        assert abs(info_p["ortho_err"] - _orth(uh)) <= 1e-6
    assert abs(info_p["ortho_err"] - info_r["ortho_err"]) <= \
        B[("polar_orth", policy)]


def test_polar_max_iter_exit_and_clamp():
    x = np.random.RandomState(15).standard_normal((96, 12)).astype(
        np.float32)
    _, _, info_r = ds.polar(ds.array(x), max_iter=3, info=True)
    up, _, info_p = dst.polar(dst.array(x), max_iter=3, info=True)
    assert info_p["iterations"] == info_r["iterations"] == 3
    assert abs(info_p["ortho_err"] - _orth(up.collect())) <= 1e-6
    with pytest.warns(RuntimeWarning, match="clamping"):
        dst.polar(dst.array(x), tol=1e-9)
    with pytest.raises(ValueError, match="m >= n"):
        dst.polar(dst.array(x.T))


# -- kron ------------------------------------------------------------------------

@pytest.mark.parametrize("shapes", [((3, 4), (5, 2)), ((1, 3), (4, 1)),
                                    ((7, 6), (3, 3))], ids=str)
def test_kron_matches_reference(shapes):
    a = np.random.RandomState(16).standard_normal(shapes[0]).astype(
        np.float32)
    b = np.random.RandomState(17).standard_normal(shapes[1]).astype(
        np.float32)
    want = np.asarray(ds.kron(ds.array(a), ds.array(b)).collect())
    got = dst.kron(dst.array(a), dst.array(b))
    np.testing.assert_array_equal(got.collect(), want)
    np.testing.assert_array_equal(want, np.kron(a, b))


# -- random_svd, lanczos_svd -------------------------------------------------------

def _ref_omega(monkeypatch):
    """Route the port's test matrix through the reference's draw."""
    monkeypatch.setattr(
        port_rsvd, "_omega_of",
        lambda seed, n, sketch, device: torch.from_numpy(np.array(
            jax.random.normal(jax.random.PRNGKey(seed), (n, sketch),
                              np.float32))))


def _hold_values(port_s, ref_s, x, key, policy, k):
    s_ref = np.linalg.svd(x.astype(np.float64), compute_uv=False)[:k]
    sp, sr = port_s.collect().ravel(), np.asarray(ref_s.collect()).ravel()
    assert np.abs(sp - s_ref).max() / s_ref[0] <= B[(key, policy)]
    assert np.abs(sp - sr).max() / s_ref[0] <= B[(key, policy)]


@pytest.mark.parametrize("policy", POLICIES)
def test_random_svd_fused_matches_reference(policy, monkeypatch):
    _ref_omega(monkeypatch)
    x = _decayed(768, 96, 5)
    ref = ds.random_svd(ds.array(x, block_size=(96, 96)), nsv=12,
                        random_state=0, precision=policy)
    port = dst.random_svd(dst.array(x), nsv=12, random_state=0,
                          precision=policy)
    _hold_values(port[1], ref[1], x, "randomsvd_values", policy, 12)
    up, vp = port[0].collect(), port[2].collect()
    ur, vr = np.asarray(ref[0].collect()), np.asarray(ref[2].collect())
    assert up.shape == (768, 12) and vp.shape == (96, 12)
    sg = _col_signs(up)
    assert np.abs(up * sg - ur * _col_signs(ur)).max() <= \
        B[("randomsvd_values", policy)]
    assert np.abs(vp * sg - vr * _col_signs(ur)).max() <= \
        B[("randomsvd_values", policy)]


def test_random_svd_composed_matches_reference(monkeypatch):
    """m < sketch: the composed path (matmul, tsqr, and the qr fallback
    for the short sketch), pinned float32 under an ambient bfloat16."""
    _ref_omega(monkeypatch)
    x = np.random.RandomState(11).standard_normal((10, 64)).astype(
        np.float32)
    ref = ds.random_svd(ds.array(x), nsv=4, random_state=3)
    port = dst.random_svd(dst.array(x), nsv=4, random_state=3)
    _hold_values(port[1], ref[1], x, "randomsvd_values", "float32", 4)
    monkeypatch.setenv("DSLIB_MATMUL_PRECISION", "bfloat16")
    np.testing.assert_array_equal(
        dst.random_svd(dst.array(x), nsv=4, random_state=3,
                       precision="float32")[1].collect(),
        port[1].collect())


def test_random_svd_draws_once_per_call():
    x = _decayed(64, 16, 6)
    a = dst.random_svd(dst.array(x), nsv=3, random_state=1)[1].collect()
    b = dst.random_svd(dst.array(x), nsv=3, random_state=1)[1].collect()
    np.testing.assert_array_equal(a, b)
    omega = port_rsvd._omega_of(1, 16, 13, "cpu")
    assert omega.shape == (16, 13) and omega.dtype == torch.float32


@pytest.mark.parametrize("policy", POLICIES)
def test_lanczos_matches_reference(policy, monkeypatch):
    monkeypatch.setattr(
        port_lz, "_start_vector",
        lambda seed, n, device: torch.from_numpy(np.array(
            jax.random.normal(jax.random.PRNGKey(seed), (n,), np.float32))))
    x = _decayed(384, 64, 6)
    ref = ds.lanczos_svd(ds.array(x), k=6, random_state=0, precision=policy)
    port = dst.lanczos_svd(dst.array(x), k=6, random_state=0,
                           precision=policy)
    _hold_values(port[1], ref[1], x, "lanczos_values", policy, 6)
    assert port[0].shape == (384, 6) and port[2].shape == (64, 6)


# -- PCA -------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["eig", "svd"])
def test_pca_matches_reference(method):
    x = _decayed(512, 32, 8) + np.float32(3.0)
    ref = ds.PCA(n_components=4, method=method).fit(ds.array(x))
    port = dst.PCA(n_components=4, method=method).fit(dst.array(x))
    var_r = np.asarray(ref.explained_variance_.collect())
    np.testing.assert_allclose(port.explained_variance_.collect(), var_r,
                               rtol=1e-5)
    cov = np.cov(x.astype(np.float64), rowvar=False)
    np.testing.assert_allclose(port.explained_variance_.collect().ravel(),
                               np.linalg.eigvalsh(cov)[::-1][:4], rtol=1e-5)
    np.testing.assert_allclose(port.mean_.collect(),
                               np.asarray(ref.mean_.collect()), rtol=1e-6)
    cp, cr = port.components_.collect(), np.asarray(
        ref.components_.collect())
    sg_p, sg_r = _col_signs(cp.T), _col_signs(cr.T)
    assert np.abs(cp.T * sg_p - cr.T * sg_r).max() <= 5e-4
    tp = port.transform(dst.array(x)).collect() * sg_p
    tr = np.asarray(ref.transform(ds.array(x)).collect()) * sg_r
    assert np.abs(tp - tr).max() <= 5e-4 * np.abs(tr).max()
    y = (tp[:5] * sg_p).astype(np.float32)
    back_p = port.inverse_transform(dst.array(y)).collect()
    back_r = np.asarray(ref.inverse_transform(
        ds.array((y * sg_p * sg_r).astype(np.float32))).collect())
    assert np.abs(back_p - back_r).max() <= 5e-4 * np.abs(back_r).max()


def test_pca_bfloat16_close_to_float32_and_bad_method():
    x = _decayed(512, 32, 8)
    var32 = dst.PCA(n_components=4).fit(dst.array(x)) \
        .explained_variance_.collect()
    var16 = dst.PCA(n_components=4, precision="bf16").fit(dst.array(x)) \
        .explained_variance_.collect()
    assert np.abs(var16 - var32).max() / var32.max() <= 2e-2
    with pytest.raises(ValueError, match="method"):
        dst.PCA(method="nope").fit(dst.array(x))


# -- padded inputs through the linalg entry points ------------------------------------

def test_linalg_on_a_padded_backing_matches_unpadded():
    x = _conditioned(64, 12, 10.0, seed=18)
    data = torch.zeros((70, 15))
    data[:64, :12] = torch.from_numpy(x)
    xp = PortArray(data, (64, 12), dst.get_mesh())
    for fn in (dst.tsqr, lambda a: dst.polar(a),
               lambda a: dst.random_svd(a, nsv=3, random_state=0)):
        for got, want in zip(fn(xp), fn(dst.array(x))):
            assert got.shape == want.shape
            np.testing.assert_allclose(got.collect(), want.collect(),
                                       atol=2e-5)
    pca_p = dst.PCA(n_components=3).fit(xp)
    pca_u = dst.PCA(n_components=3).fit(dst.array(x))
    np.testing.assert_allclose(pca_p.explained_variance_.collect(),
                               pca_u.explained_variance_.collect(),
                               rtol=1e-5)
