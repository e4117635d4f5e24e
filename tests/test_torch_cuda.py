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
               (16, 40_000, 6, 16, 32, 2)]    # T 16


@pytest.mark.parametrize("shape", HIST_SHAPES, ids=str)
def test_node_histogram_bit_equal_to_plain(dev, shape):
    T, m, n, n_nodes, n_bins, S = shape
    node, bx, w, stats = _hist_inputs(dev, *shape)
    got = K.node_histogram(node, bx, w, stats, n_nodes, n_bins)
    torch.cuda.synchronize()
    assert got.shape == (T, n_nodes, n, n_bins, S)
    assert torch.equal(got, K.node_histogram_plain(node, bx, w, stats,
                                                   n_nodes, n_bins))
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
