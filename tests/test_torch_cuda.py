"""The port's CUDA kernels on the card, against their plain versions.

Needs a CUDA card and ``nvcc``; every test skips without a card.  The module
imports neither JAX nor ``dislib_tpu``, so on a machine without JAX it runs
without the repository's conftest::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

Tolerances: ``panel_gemm`` within ``ERROR_BOUNDS[("matmul", "float32")]``
(normalized) of the plain version — both accumulate the same (policy-
rounded) operands in f32; ``distances_sq`` within 1e-5 of the plain version
relative to max‖a‖² + max‖b‖², the magnitudes that cancel in the
formulation; ``node_histogram`` bit-equal to the plain version for integer
contributions (sums of integers below 2^24 are exact in any order), and for
non-integer ones within 1e-5 of the f64 sums relative to each cell's sum of
|w·stats| (its atomics add in a varying order); a decision tree fitted on
the card identical to the one fitted on the CPU (exact histograms, and
the gain arithmetic in a fixed order on both devices).  ``panel_gemm``
FLOAT32 is also held to float32 faithfulness: its error against float64 at
most 1/8 of a single-pass TF32 product's (cuBLAS with TF32 allowed).
"""

import numpy as np
import pytest
import torch

import dislib_tpu_torch as dst
from dislib_tpu_torch.cluster import kmeans as km_mod
from dislib_tpu_torch.ops import kernels as K
from dislib_tpu_torch.ops import precision as px
from dislib_tpu_torch.trees import (DecisionTreeClassifier,
                                    RandomForestClassifier)

pytestmark = pytest.mark.cuda

# the last two span many K stages and several tiles in both directions
SHAPES = [(1, 5, 300), (129, 257, 130), (1000, 77, 33), (256, 128, 16),
          (300, 1000, 520), (4097, 2053, 259)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    K.reset_launches()
    return torch.device("cuda", 0)


def _gemm_err(c, ref, a, b):
    scale = (torch.linalg.norm(a.double()) * torch.linalg.norm(b.double())
             / a.shape[1] ** 0.5)
    return float((c.double() - ref.double()).abs().max() / scale)


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
@pytest.mark.parametrize("mkn", SHAPES, ids=str)
def test_panel_gemm_matches_plain(dev, policy, mkn):
    m, k, n = mkn
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((m, k), generator=g, device=dev)
    b = torch.randn((k, n), generator=g, device=dev)
    pol = px.resolve(policy)
    got = K.panel_gemm(a, b, pol)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert _gemm_err(got, K.panel_gemm_plain(a, b, pol), a, b) <= \
        px.ERROR_BOUNDS[("matmul", "float32")]
    assert K.LAUNCHES["panel_gemm"] == 1


def test_panel_gemm_float32_is_float32_faithful(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    a = torch.randn((2048, 8192), generator=g, device=dev)
    b = torch.randn((8192, 2048), generator=g, device=dev)
    ref = a.double() @ b.double()
    got = K.panel_gemm(a, b, px.FLOAT32)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    err, err_tf32 = _gemm_err(got, ref, a, b), _gemm_err(tf32, ref, a, b)
    assert err <= px.ERROR_BOUNDS[("matmul", "float32")]
    assert err <= err_tf32 / 8, (err, err_tf32)


def test_panel_gemm_bf16_copies_an_unaligned_or_ragged_a(dev):
    g = torch.Generator(device=dev).manual_seed(4)
    for m, k, n in [(130, 64, 70), (130, 77, 70)]:
        base = torch.randn(m * k + 1, generator=g, device=dev).bfloat16()
        a = base[1:].view(m, k)              # contiguous, 2 bytes off
        b = torch.randn((k, n), generator=g, device=dev).bfloat16()
        assert a.data_ptr() % 16 != 0
        assert K.gemm_plan(m, n, k, a.dtype, a.data_ptr()).pad_a
        got = K.panel_gemm(a, b, px.BFLOAT16)
        want = K.panel_gemm_plain(a, b, px.BFLOAT16)
        assert _gemm_err(got, want, a.float(), b.float()) <= \
            px.ERROR_BOUNDS[("matmul", "float32")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_panel_gemm_plan_is_the_compiled_one(dev, dtype):
    p = K.gemm_plan(16384, 16384, 16384, dtype)
    assert K.gemm_compiled_plan(dtype) == (p.bm, p.bn, p.bk, p.stages,
                                           p.smem_bytes)


@pytest.mark.parametrize("mkn", SHAPES, ids=str)
def test_distances_sq_matches_plain(dev, mkn):
    m, d, k = mkn
    g = torch.Generator(device=dev).manual_seed(1)
    a = torch.randn((m, d), generator=g, device=dev)
    b = torch.randn((k, d), generator=g, device=dev)
    got = K.distances_sq(a, b)
    torch.cuda.synchronize()
    want = K.distances_sq_plain(a, b, precision="highest")
    scale = float((a * a).sum(1).max() + (b * b).sum(1).max())
    assert float((got - want).abs().max()) / scale <= 1e-5
    assert bool((got >= 0).all())
    assert K.LAUNCHES["distances_sq"] == 1


@pytest.mark.parametrize("k", [1, 10, 17, 257])
@pytest.mark.parametrize("d", [1, 3, 33, 100])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
def test_distances_sq_ragged_shapes(dev, d, k, offset):
    # d = 100 on an aligned a takes the bulk-copy stream, the rest the
    # slices; an a that starts 4 bytes into its storage is never streamed
    m = 3001
    g = torch.Generator(device=dev).manual_seed(d * 1000 + k)
    base = torch.randn(m * d + offset, generator=g, device=dev)
    a = base[offset:].view(m, d)
    b = torch.randn((k, d), generator=g, device=dev)
    plan = K.dist_plan(m, d, a.data_ptr(), 132)
    assert (plan.rows > 0) == (d == 100 and offset == 0)
    got = K.distances_sq(a, b)
    torch.cuda.synchronize()
    want = K.distances_sq_plain(a, b, precision="highest")
    scale = float((a * a).sum(1).max() + (b * b).sum(1).max())
    assert float((got - want).abs().max()) / scale <= 1e-5
    assert K.LAUNCHES["distances_sq"] == 1


@pytest.mark.parametrize("d", [4, 100])
def test_distances_sq_stream_keeps_nan(dev, d):
    a = torch.ones((1000, d), device=dev)
    a[513, 2] = float("nan")
    assert K.dist_plan(1000, d, a.data_ptr(), 132).rows > 0
    got = K.distances_sq(a, torch.zeros((10, d), device=dev)).cpu()
    assert torch.isnan(got[513]).all()
    assert not torch.isnan(got[torch.arange(1000) != 513]).any()


def test_distances_sq_keeps_nan(dev):
    a = torch.ones((3, 4), device=dev)
    a[1, 2] = float("nan")
    got = K.distances_sq(a, torch.zeros((2, 4), device=dev)).cpu()
    assert torch.isnan(got[1]).all() and not torch.isnan(got[[0, 2]]).any()


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.ones((8, 4), device=dev)
    with pytest.raises(TypeError):
        K.panel_gemm(x.double(), x.T.contiguous().double())
    with pytest.raises(TypeError):
        K.distances_sq(x.double(), x.double())
    with pytest.raises(ValueError, match="contiguous"):
        K.panel_gemm(x, x.T)
    with pytest.raises(ValueError, match="CUDA device"):
        K.distances_sq(x, x.cpu())
    assert K.LAUNCHES == {"panel_gemm": 0, "distances_sq": 0,
                          "node_histogram": 0}


def test_kmeans_on_the_card_matches_the_cpu(dev):
    # well-separated blobs, one initial center in each: no point is near a
    # tie that f32 reassociation could flip between the kernel and the CPU
    # plain version (two centers in one blob would split it at a boundary
    # dense with near-ties)
    rng = np.random.RandomState(0)
    centers = rng.uniform(-20, 20, (6, 12))
    x = (centers[rng.randint(0, 6, 5000)]
         + rng.standard_normal((5000, 12))).astype(np.float32)
    init = (centers + 0.5 * rng.standard_normal((6, 12))).astype(np.float32)
    kw = dict(n_clusters=6, init=init, max_iter=8, tol=0.0)
    gpu = dst.KMeans(**kw).fit(dst.array(x, device=dev))
    cpu = dst.KMeans(**kw).fit(dst.array(x, device="cpu"))
    assert K.LAUNCHES["distances_sq"] == 8
    assert gpu.n_iter_ == cpu.n_iter_ == 8
    np.testing.assert_allclose(gpu.centers_, cpu.centers_, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(gpu.inertia_, cpu.inertia_, rtol=1e-4)


def test_fit_kernel_leaves_its_results_on_the_card(dev):
    x = dst.array(np.random.RandomState(0).rand(4096, 8).astype(np.float32),
                  device=dev)
    c0 = x._data[:4].clone()
    torch.cuda.synchronize()
    out = km_mod._kmeans_fit(x._data, x.shape, c0, 20, 0.0)
    # nothing was read back yet: every result is still a device tensor
    assert all(t.device.type == "cuda" for t in out)
    assert K.LAUNCHES["distances_sq"] == 20


def test_summa_matmul_on_the_card(dev, monkeypatch):
    monkeypatch.setenv("DSLIB_OVERLAP", "pallas")
    rng = np.random.RandomState(2)
    a = rng.standard_normal((300, 200)).astype(np.float32)
    b = rng.standard_normal((200, 170)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    for policy in ("float32", "bfloat16"):
        K.reset_launches()
        got = dst.matmul(dst.array(a, device=dev), dst.array(b, device=dev),
                         algorithm="summa", precision=policy).collect()
        assert K.LAUNCHES["panel_gemm"] == 1
        scale = np.linalg.norm(a) * np.linalg.norm(b) / np.sqrt(200)
        assert np.abs(got - want).max() / scale <= \
            px.ERROR_BOUNDS[("matmul", policy)]


def _hist_inputs(dev, T, m, n, n_nodes, n_bins, S, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    node = torch.randint(0, n_nodes, (T, m), generator=g, device=dev,
                         dtype=torch.int32)
    bx = torch.randint(0, n_bins, (m, n), generator=g, device=dev,
                       dtype=torch.int32)
    w = torch.poisson(torch.ones((T, m), device=dev), generator=g)
    stats = torch.randint(0, 3, (m, S), generator=g, device=dev).float()
    return node, bx, w, stats


HIST_SHAPES = [(3, 1000, 7, 4, 32, 2),        # ragged m, several chunks
               (2, 50_001, 5, 2048, 32, 2),   # the deepest level: slices
               (1, 20_011, 3, 64, 1024, 2),   # n_bins 1024
               (2, 30_000, 4, 8, 32, 5),      # S 5
               (1, 123_457, 10, 1, 32, 2),    # T 1, every row in one node
               (16, 40_000, 6, 16, 32, 2),    # T 16
               (16, 200_000, 20, 2, 32, 2)]   # private copies per warp


@pytest.mark.parametrize("shape", HIST_SHAPES, ids=str)
def test_node_histogram_bit_equal_to_plain(dev, shape):
    T, m, n, n_nodes, n_bins, S = shape
    node, bx, w, stats = _hist_inputs(dev, *shape)
    nsm = torch.cuda.get_device_properties(dev).multi_processor_count
    private = K.hist_plan(T, m, n, n_nodes, n_bins, S, nsm).private
    assert private == (shape == HIST_SHAPES[-1])
    got = K.node_histogram(node, bx, w, stats, n_nodes, n_bins)
    torch.cuda.synchronize()
    assert got.shape == (T, n_nodes, n, n_bins, S)
    assert torch.equal(got, K.node_histogram_plain(node, bx, w, stats,
                                                   n_nodes, n_bins))
    assert K.LAUNCHES["node_histogram"] == 1


@pytest.mark.parametrize("kind", ["one-node", "half-empty", "node-minus-1",
                                  "nan-on-zero-weight"])
def test_node_histogram_layouts_bit_equal_to_plain(dev, kind):
    # the deepest level's shape with the node layouts that stress the
    # partition: every row in one node (split into items that add), half
    # the nodes empty (items that write zeros), rows dropped for node -1,
    # and a NaN stat on a weight-0 row (kept: 0·NaN is NaN)
    T, m, n, n_nodes, n_bins, S = 2, 60_001, 7, 2048, 32, 2
    node, bx, w, stats = _hist_inputs(dev, T, m, n, n_nodes, n_bins, S,
                                      seed=5)
    if kind == "one-node":
        node.fill_(1234)
    elif kind == "half-empty":
        node.mul_(2).remainder_(n_nodes)
    elif kind == "node-minus-1":
        node[:, ::3] = -1
    else:
        w[:, 17] = 0
        stats[17, 1] = float("nan")
    got = K.node_histogram(node, bx, w, stats, n_nodes, n_bins)
    torch.cuda.synchronize()
    want = K.node_histogram_plain(node, bx, w, stats, n_nodes, n_bins)
    assert torch.equal(torch.nan_to_num(got, nan=-1.0),
                       torch.nan_to_num(want, nan=-1.0))
    assert torch.isnan(want).any() == (kind == "nan-on-zero-weight")
    assert K.LAUNCHES["node_histogram"] == 1


def test_node_histogram_non_integer_stats(dev):
    node, bx, w, _ = _hist_inputs(dev, 2, 60_000, 6, 16, 32, 3)
    g = torch.Generator(device=dev).manual_seed(1)
    stats = torch.randn((60_000, 3), generator=g, device=dev)
    got = K.node_histogram(node, bx, w, stats, 16, 32)
    exact = K.node_histogram_plain(node, bx, w.double(), stats.double(),
                                   16, 32)
    scale = K.node_histogram_plain(node, bx, w, stats.abs(), 16, 32)
    assert bool(((got.double() - exact).abs() <= 1e-5 * scale).all())


def test_decision_tree_on_the_card_matches_the_cpu(dev):
    rng = np.random.RandomState(5)
    centers = rng.rand(8, 20).astype(np.float32)
    lab = rng.randint(0, 8, 20_000)
    x = centers[lab] + 0.08 * rng.standard_normal((20_000, 20)).astype(
        np.float32)
    y = (lab % 2).astype(np.float32)[:, None]
    gpu = DecisionTreeClassifier().fit(dst.array(x, device=dev),
                                       dst.array(y, device=dev))
    assert K.LAUNCHES["node_histogram"] == gpu._depth
    cpu = DecisionTreeClassifier().fit(dst.array(x, device="cpu"),
                                       dst.array(y, device="cpu"))
    assert torch.equal(gpu._edges.cpu(), cpu._edges)
    np.testing.assert_array_equal(gpu._feats, cpu._feats)
    np.testing.assert_array_equal(gpu._tbins, cpu._tbins)
    assert torch.equal(gpu._leaves.cpu(), cpu._leaves)


def test_forest_launches_the_kernel_once_per_level(dev):
    rng = np.random.RandomState(6)
    x = rng.rand(5000, 12).astype(np.float32)
    y = (x[:, 0] + x[:, 1] > 1).astype(np.float32)[:, None]
    X, Y = dst.array(x, device=dev), dst.array(y, device=dev)
    rf = RandomForestClassifier(n_estimators=4, random_state=0).fit(X, Y)
    assert K.LAUNCHES["node_histogram"] == rf._depth
    again = RandomForestClassifier(n_estimators=4, random_state=0).fit(X, Y)
    np.testing.assert_array_equal(rf._feats, again._feats)
    assert torch.equal(rf._leaves, again._leaves)
    assert rf.score(X, Y) >= 0.95


# -- the ds-array's eager ops and the blocked linear algebra ------------------
#
# Each entry point on the card against the port on the CPU at the same
# inputs, held to its ERROR_BOUNDS row (float32) after sign normalisation:
# diag(R) ≥ 0 for QR factors, each singular/eigen vector signed so its
# largest entry is positive.  Singular vectors are held within 1e-3: at
# cond 10 over 160 values neighbours are 1.4e-3·σ₁ apart, so a backward
# error of ~1e-6·σ₁ may turn a vector by up to ~7e-4.  Elementwise +, −,
# ×, ÷ are bit-equal (one IEEE operation per element on both devices);
# reductions within 1e-6.

def _conditioned(m, n, cond, seed=0):
    rng = np.random.RandomState(seed)
    k = min(m, n)
    u, _ = np.linalg.qr(rng.standard_normal((m, k)))
    v, _ = np.linalg.qr(rng.standard_normal((n, k)))
    return ((u * np.logspace(0, -np.log10(cond), k)) @ v.T).astype(
        np.float32)


def _signs(u):
    idx = np.abs(u).argmax(0)
    return np.where(u[idx, np.arange(u.shape[1])] < 0, -1.0, 1.0)


def _qr_signed(q, r):
    k = min(r.shape)
    d = np.where(np.diag(r)[:k] < 0, -1.0, 1.0)
    return (np.hstack([q[:, :k] * d, q[:, k:] * _signs(q[:, k:])]),
            r[:k] * d[:, None])


def _both_devices(x, dev):
    return dst.array(x, device=dev), dst.array(x, device="cpu")


def _close_qr(gpu, cpu, key):
    (qg, rg), (qc, rc) = [_qr_signed(q.collect(), r.collect())
                          for q, r in (gpu, cpu)]
    assert np.abs(qg - qc).max() <= px.ERROR_BOUNDS[(f"{key}_orth",
                                                     "float32")]
    assert np.abs(rg - rc).max() / np.abs(rc).max() <= \
        px.ERROR_BOUNDS[(f"{key}_resid", "float32")]


def _close_svd(gpu, cpu):
    (ug, sg, vg), (uc, sc, vc) = [[a.collect() for a in r]
                                  for r in (gpu, cpu)]
    assert np.abs(sg - sc).max() / sc.max() <= \
        px.ERROR_BOUNDS[("svd_values", "float32")]
    assert np.abs(ug * _signs(ug) - uc * _signs(uc)).max() <= 1e-3
    assert np.abs(vg * _signs(ug) - vc * _signs(uc)).max() <= 1e-3


def test_array_ops_on_the_card_match_the_cpu(dev):
    rng = np.random.RandomState(7)
    x = (np.abs(rng.standard_normal((37, 11))) + 0.5).astype(np.float32)
    y = (np.abs(rng.standard_normal((1, 11))) + 0.5).astype(np.float32)
    (xg, xc), (yg, yc) = _both_devices(x, dev), _both_devices(y, dev)
    for fn in (lambda a, b: a + b, lambda a, b: a - b,
               lambda a, b: a * b, lambda a, b: a / b,
               lambda a, b: 2.0 / a, lambda a, b: -a):
        got = fn(xg, yg)
        assert got.device.type == "cuda"
        np.testing.assert_array_equal(got.collect(), fn(xc, yc).collect())
    for kind in ("sum", "mean", "min", "max", "norm"):
        for axis in (0, 1, None):
            np.testing.assert_allclose(
                getattr(xg, kind)(axis=axis).collect(),
                getattr(xc, kind)(axis=axis).collect(), rtol=1e-6)
    for a, b in ((dst.eye(5, 7, device=dev), dst.eye(5, 7, device="cpu")),
                 (dst.full((4, 3), 2.5, device=dev),
                  dst.full((4, 3), 2.5, device="cpu")),
                 (dst.concat_rows([xg, yg]), dst.concat_rows([xc, yc])),
                 (dst.apply_along_axis(lambda v: v * 2.0, 0, xg),
                  dst.apply_along_axis(lambda v: v * 2.0, 0, xc))):
        assert a.device.type == "cuda"
        np.testing.assert_array_equal(a.collect(), b.collect())
    r = dst.random_array((300, 7), random_state=3, device=dev).collect()
    assert r.min() >= 0.0 and r.max() < 1.0


@pytest.mark.parametrize("route", ["0", "1"], ids=["tree", "cholqr2"])
def test_tsqr_on_the_card_matches_the_cpu(dev, route, monkeypatch):
    monkeypatch.setenv("DSLIB_TSQR_CHOLQR", route)
    x = _conditioned(4096, 64, 10.0, seed=8)
    xg, xc = _both_devices(x, dev)
    _close_qr(dst.tsqr(xg), dst.tsqr(xc), "tsqr")
    # a padded backing on the card gives the unpadded result
    data = torch.zeros((4100, 67), device=dev)
    data[:4096, :64] = torch.from_numpy(x).to(dev)
    padded = dst.Array(data, (4096, 64), xg._mesh)
    _close_qr(dst.tsqr(padded), dst.tsqr(xc), "tsqr")


def test_cholqr_breakdown_on_the_card_falls_back(dev, monkeypatch):
    from dislib_tpu_torch.utils import profiling as prof
    x = _conditioned(2048, 32, 1e5, seed=9)
    xg, xc = _both_devices(x, dev)
    monkeypatch.setenv("DSLIB_TSQR_CHOLQR", "0")
    tree = dst.tsqr(xg)
    monkeypatch.setenv("DSLIB_TSQR_CHOLQR", "1")
    prof.reset_host_reads()
    got = dst.tsqr(xg)
    assert prof.HOST_READS == {"cholqr2_ok": 2}
    for a, b in zip(got, tree):
        assert torch.equal(a._data, b._data)
    # at cond 1e5 the factors of two devices differ by ~cond·u: hold the
    # card's to the oracle
    q, r = (a.collect().astype(np.float64) for a in got)
    assert np.abs(q.T @ q - np.eye(32)).max() <= \
        px.ERROR_BOUNDS[("tsqr_orth", "float32")]
    assert np.linalg.norm(q @ r - x) / np.linalg.norm(x) <= \
        px.ERROR_BOUNDS[("tsqr_resid", "float32")]


def test_qr_on_the_card_matches_the_cpu(dev, monkeypatch):
    import importlib
    qr_mod = importlib.import_module("dislib_tpu_torch.math.qr")
    monkeypatch.setattr(qr_mod, "_PANEL", 16)
    x = _conditioned(256, 40, 10.0, seed=10)
    xg, xc = _both_devices(x, dev)
    _close_qr(dst.qr(xg, mode="economic"), dst.qr(xc, mode="economic"), "qr")
    # full: the complement's Gaussian block is each device's own draw, so
    # Q₁ and R are compared and the whole Q held to the oracle
    (qg, rg), (qc, rc) = dst.qr(xg), dst.qr(xc)
    _close_qr((qg[:, :40], rg[:40]), (qc[:, :40], rc[:40]), "qr")
    q = qg.collect().astype(np.float64)
    assert np.abs(q.T @ q - np.eye(256)).max() <= \
        px.ERROR_BOUNDS[("qr_orth", "float32")]
    assert np.linalg.norm(q @ rg.collect() - x) / np.linalg.norm(x) <= \
        px.ERROR_BOUNDS[("qr_resid", "float32")]
    np.testing.assert_allclose(np.abs(dst.qr(xg, mode="r").collect()),
                               np.abs(dst.qr(xc, mode="r").collect()),
                               atol=1e-5)


@pytest.mark.parametrize("shape", [(256, 160), (300, 24)], ids=str)
def test_svd_on_the_card_matches_the_cpu(dev, shape):
    x = _conditioned(*shape, 10.0, seed=11)
    xg, xc = _both_devices(x, dev)
    _close_svd(dst.svd(xg), dst.svd(xc))


def test_pair_svd_on_the_card_is_float32_faithful(dev):
    """The block tier's batched (128, 128) pair SVD: cuSOLVER's Jacobi
    alone leaves its factors up to ~1e-4 from orthogonal; the refined
    factors are orthogonal, and reproduce R, to 1e-5."""
    import importlib
    base = importlib.import_module("dislib_tpu_torch.math.base")
    g = torch.Generator(device=dev).manual_seed(14)
    _, r = torch.linalg.qr(torch.rand((4, 4096, 128), generator=g,
                                      device=dev))
    with px.precise():
        u, s, vh = base._pair_svd(r)
        eye = torch.eye(128, device=dev)
        assert float((u.transpose(1, 2) @ u - eye).abs().max()) <= 1e-5
        assert float((vh @ vh.transpose(1, 2) - eye).abs().max()) <= 1e-5
        assert float(((u * s[:, None, :]) @ vh - r).abs().max()
                     / r.abs().max()) <= 1e-5


def test_polar_on_the_card_matches_the_cpu(dev):
    x = _conditioned(1024, 96, 100.0, seed=12)
    xg, xc = _both_devices(x, dev)
    ug, hg, ig = dst.polar(xg, info=True)
    uc, hc, ic = dst.polar(xc, info=True)
    assert ig["iterations"] == ic["iterations"]
    assert np.abs(ug.collect() - uc.collect()).max() <= \
        px.ERROR_BOUNDS[("polar_orth", "float32")]
    assert ig["ortho_err"] <= px.ERROR_BOUNDS[("polar_orth", "float32")]


def test_decompositions_on_the_card_match_the_cpu(dev):
    rng = np.random.RandomState(13)
    x = (rng.standard_normal((2048, 96)) * 0.9 ** np.arange(96)).astype(
        np.float32)
    xg, xc = _both_devices(x, dev)
    tol = px.ERROR_BOUNDS[("randomsvd_values", "float32")]
    # the same seed draws differently on the two devices: hold both to the
    # exact values
    s_ref = np.linalg.svd(x.astype(np.float64), compute_uv=False)
    for fn, key, k in ((lambda a: dst.random_svd(a, nsv=8, random_state=0),
                        "randomsvd_values", 8),
                       (lambda a: dst.lanczos_svd(a, k=6, random_state=0),
                        "lanczos_values", 6)):
        for a in (xg, xc):
            s = fn(a)[1].collect().ravel()
            assert np.abs(s - s_ref[:k]).max() / s_ref[0] <= \
                px.ERROR_BOUNDS[(key, "float32")]
    for method in ("eig", "svd"):
        pg = dst.PCA(n_components=4, method=method).fit(xg)
        pc = dst.PCA(n_components=4, method=method).fit(xc)
        np.testing.assert_allclose(pg.explained_variance_.collect(),
                                   pc.explained_variance_.collect(),
                                   rtol=tol)
        cg, cc = pg.components_.collect().T, pc.components_.collect().T
        assert np.abs(cg * _signs(cg) - cc * _signs(cc)).max() <= 1e-4
    a = rng.standard_normal((7, 6)).astype(np.float32)
    b = rng.standard_normal((3, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        dst.kron(dst.array(a, device=dev), dst.array(b, device=dev))
        .collect(), np.kron(a, b))
