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
|w·stats| (the integer path's atomics add in a varying order; the
fixed-order path is also bit-identical from call to call, and so are the
leaf sums and a regressor's fit); a decision tree fitted on
the card identical to the one fitted on the CPU (exact histograms, and
the gain arithmetic in a fixed order on both devices).  ``panel_gemm``
FLOAT32 is also held to float32 faithfulness: its error against float64 at
most 1/8 of a single-pass TF32 product's (cuBLAS with TF32 allowed).
Under BFLOAT16 on the card, ``pdot``/``peinsum`` are native bf16 products
with a float32 result: within ``ERROR_BOUNDS`` of float64, and within
1e-4 of the CPU's f32 contraction of the same rounded operands (the card
sums in another order).  The new estimators on the card match the CPU at
1e-4.  kNN: identical fit rows give bit-identical kernel distances, and
the lower fit index comes first; the single-rank ring (its cross term on
``panel_gemm``) within 1e-5 of the chunked path's distances, with equal
indices wherever that path has no tie within 1e-5; a kNN search's scores
within 1e-6 of the CPU's, read only after the next fold is dispatched.
The bf16-operand ``distances_sq`` within 1e-5 of its plain version (the
same exact bf16 products summed in another order); a model saved on the
card and loaded back onto it predicts bit-equal.  The ε-pass: the kernel
at its block shapes (a column chunk of every row against a row tile,
columns padded to a multiple of 4 or not) within 1e-5 of its plain
version; DBSCAN and Daura fitted on the card equal to the CPU's on data
whose pairwise d² keeps a 1e-3 margin from the threshold, every tier's
distance blocks launched on the kernel.  Sparse: two SpMM calls and two
sparse KMeans fits bit-identical (fixed-order sums, no atomics), and
within 1e-5 of the CPU.  The batched ``distances_sq`` entry within 1e-5
of its plain version (normalized as above) and bit-equal, node by node,
to the 2-D entry (the same tiles), one launch for all nodes; CascadeSVM
on the card with the CPU's support vectors and α within 1e-4, two fits
and the ELL and dense fits bit-identical; the sparse kNN within 1e-5 of
the CPU.  ``panel_gemm`` at the IVF centroid shape and ``distances_sq`` at
the IVF quantizer's shape against their plain versions (as above); ALS on
the card within 1e-4 of the CPU, two sparse fits bit-identical (fixed-order
segment sums) and the dense fit within 1e-4 of the sparse one; the IVF
index on the card with the CPU's ids and d² within 1e-5 of the cancelling
magnitudes, under ``db`` and under ``kernel``.  The checkpointed fit: an
``AsyncFetch`` of a carry that the next chunk updates in place holds the
value from before that chunk; a checkpointed KMeans fit bit-identical to
the unchecked one, with ``distances_sq`` launched every step; a resumed
forest bit-identical to the uninterrupted one, ``node_histogram``
launched once per remaining level.  Serving: every declared chain
captured at every bucket, each replay bit-equal to its eager chain and
a served batch equal to a direct predict (the IVF search's ids and
distances exactly); one replay per bucket piece and no capture or build
after warm; a generation swap that captures four graphs and builds
nothing; each kernel captured under the serving layer's capture mode
bit-equal to a launch outside a graph.
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
    got = K.node_histogram(node, bx, w, stats, n_nodes, n_bins, integer=True)
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
    want = K.node_histogram_plain(node, bx, w, stats, n_nodes, n_bins)
    # both orders of the sums: any order (atomics) and the fixed one
    for integer in (True, False):
        got = K.node_histogram(node, bx, w, stats, n_nodes, n_bins,
                               integer=integer)
        torch.cuda.synchronize()
        assert torch.equal(torch.nan_to_num(got, nan=-1.0),
                           torch.nan_to_num(want, nan=-1.0))
    assert torch.isnan(want).any() == (kind == "nan-on-zero-weight")
    assert K.LAUNCHES["node_histogram"] == 2


def test_node_histogram_non_integer_stats(dev):
    node, bx, w, _ = _hist_inputs(dev, 2, 60_000, 6, 16, 32, 3)
    g = torch.Generator(device=dev).manual_seed(1)
    stats = torch.randn((60_000, 3), generator=g, device=dev)
    exact = K.node_histogram_plain(node, bx, w.double(), stats.double(),
                                   16, 32)
    scale = K.node_histogram_plain(node, bx, w, stats.abs(), 16, 32)
    for integer in (True, False):
        got = K.node_histogram(node, bx, w, stats, 16, 32, integer=integer)
        assert bool(((got.double() - exact).abs() <= 1e-5 * scale).all())


# the regressor's shapes and the partition's stress layouts: (T, m, n,
# n_nodes, n_bins, S, layout)
FIXED_SHAPES = [(8, 1_000_000, 100, 1, 32, 3, "random"),   # first level
                (8, 1_000_000, 100, 128, 32, 3, "random"),  # deepest
                (2, 60_001, 7, 2048, 32, 3, "one-node"),
                (2, 60_001, 7, 2048, 32, 3, "half-empty"),
                (3, 1000, 7, 4, 32, 2, "random"),
                (1, 20_011, 3, 64, 1024, 2, "random"),
                (16, 200_000, 20, 2, 32, 2, "random")]


@pytest.mark.parametrize("shape", FIXED_SHAPES, ids=str)
def test_node_histogram_fixed_order_is_bit_identical(dev, shape):
    # non-integer contributions (a regressor's w·y): two calls give the same
    # bits, within f32 rounding of the f64 sums (1e-5 of each cell's sum of
    # |w·stats|)
    T, m, n, n_nodes, n_bins, S, layout = shape
    node, bx, w, _ = _hist_inputs(dev, T, m, n, n_nodes, n_bins, S, seed=7)
    if layout == "one-node":
        node.fill_(1234)
    elif layout == "half-empty":
        node.mul_(2).remainder_(n_nodes)
    g = torch.Generator(device=dev).manual_seed(8)
    stats = torch.randn((m, S), generator=g, device=dev)
    first = K.node_histogram(node, bx, w, stats, n_nodes, n_bins)
    second = K.node_histogram(node, bx, w, stats, n_nodes, n_bins)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    exact = K.node_histogram_plain(node, bx, w.double(), stats.double(),
                                   n_nodes, n_bins)
    scale = K.node_histogram_plain(node, bx, w, stats.abs(), n_nodes, n_bins)
    assert bool(((first.double() - exact).abs() <= 1e-5 * scale).all())
    assert K.LAUNCHES["node_histogram"] == 2
    if n_nodes == 1:        # the first level: its node is cut into chunks
        plan = K.hist_plan(T, m, n, n_nodes, n_bins, S, torch.cuda
                           .get_device_properties(dev).multi_processor_count,
                           fixed_order=True)
        assert m > plan.rows_per_item


def test_leaf_stats_on_the_card_are_bit_identical(dev):
    from dislib_tpu_torch.trees import decision_tree as dt
    g = torch.Generator(device=dev).manual_seed(9)
    T, m, n_leaves = 8, 500_000, 256
    node = torch.randint(0, n_leaves, (T, m), generator=g, device=dev,
                         dtype=torch.int32)
    w = torch.poisson(torch.ones((T, m), device=dev), generator=g)
    stats = torch.randn((m, 3), generator=g, device=dev)
    first = dt._leaf_stats(node, w, stats, n_leaves)[0]
    second = dt._leaf_stats(node, w, stats, n_leaves)[0]
    assert torch.equal(first, second)
    cpu = dt._leaf_stats(node.cpu(), w.cpu(), stats.cpu(), n_leaves)[0]
    torch.testing.assert_close(first.cpu(), cpu, rtol=1e-5, atol=1e-3)


def test_regressor_fit_on_the_card_is_reproducible(dev):
    from dislib_tpu_torch.trees import RandomForestRegressor
    rng = np.random.RandomState(3)
    x = rng.rand(100_000, 12).astype(np.float32)
    y = (np.sin(6 * x[:, :1]) + x[:, 1:2] ** 2).astype(np.float32)
    X, Y = dst.array(x, device=dev), dst.array(y, device=dev)
    a = RandomForestRegressor(n_estimators=4, max_depth=8,
                              random_state=0).fit(X, Y)
    b = RandomForestRegressor(n_estimators=4, max_depth=8,
                              random_state=0).fit(X, Y)
    assert torch.equal(a._leaves, b._leaves)
    assert np.array_equal(a._feats, b._feats)
    assert np.array_equal(a._tbins, b._tbins)


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


@pytest.mark.parametrize("shape", [((1_000_000, 50), 16), ((4096, 100), 10)],
                         ids=["gm-kmeans-init", "minibatch-batch"])
def test_distances_sq_at_this_slices_shapes(dev, shape):
    # GaussianMixture's KMeans init (d = 50 takes the slices: d % 4 != 0)
    # and a MiniBatchKMeans batch
    (m, d), k = shape
    g = torch.Generator(device=dev).manual_seed(10)
    a = torch.randn((m, d), generator=g, device=dev)
    b = torch.randn((k, d), generator=g, device=dev)
    nsm = torch.cuda.get_device_properties(dev).multi_processor_count
    assert (K.dist_plan(m, d, a.data_ptr(), nsm).rows == 0) == (d % 4 != 0)
    got = K.distances_sq(a, b)
    want = K.distances_sq_plain(a, b, "highest")
    scale = float((a.double() ** 2).sum(1).max()
                  + (b.double() ** 2).sum(1).max())
    assert float((got.double() - want.double()).abs().max()) / scale <= 1e-5
    assert K.LAUNCHES["distances_sq"] == 1


@pytest.mark.parametrize("sa,sb", [((512, 300), (300, 200)),
                                   ((4, 257, 64), (4, 64, 130)),
                                   ((300, 64), (64,))], ids=str)
def test_pdot_bfloat16_on_the_card_is_a_native_product(dev, sa, sb,
                                                       monkeypatch):
    # BFLOAT16 on CUDA tensors: one bf16 product with a float32 result
    # (aten::mm.dtype / bmm.dtype), within ERROR_BOUNDS of float64, and
    # within f32 accumulation of the CPU's contraction of the same rounded
    # operands
    calls = []
    native = px._matmul_f32_out
    monkeypatch.setattr(px, "_matmul_f32_out",
                        lambda a, b: calls.append(1) or native(a, b))
    g = torch.Generator(device=dev).manual_seed(11)
    a = torch.randn(sa, generator=g, device=dev)
    b = torch.randn(sb, generator=g, device=dev)
    got = px.pdot(a, b, px.BFLOAT16)
    assert calls and got.dtype == torch.float32
    ref = torch.matmul(a.double(), b.double())
    k = sa[-1]
    scale = float(torch.linalg.norm(a.double()) * torch.linalg.norm(
        b.double())) / k ** 0.5
    assert float((got.double() - ref).abs().max()) / scale <= \
        px.ERROR_BOUNDS[("matmul", "bfloat16")]
    cpu = px.pdot(a.cpu(), b.cpu(), px.BFLOAT16)
    torch.testing.assert_close(got.cpu(), cpu, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("subscripts,sa,sb", [
    ("wmi,wij->mwj", (4, 512, 128), (4, 128, 128)),
    ("nwi,wji->nwj", (512, 4, 128), (4, 128, 128))])
def test_peinsum_bfloat16_on_the_card_is_one_bmm(dev, subscripts, sa, sb,
                                                 monkeypatch):
    calls = []
    native = px._einsum_as_bmm
    monkeypatch.setattr(px, "_einsum_as_bmm",
                        lambda *a: calls.append(1) or native(*a))
    g = torch.Generator(device=dev).manual_seed(12)
    a = torch.randn(sa, generator=g, device=dev)
    b = torch.randn(sb, generator=g, device=dev)
    got = px.peinsum(subscripts, a, b, px.BFLOAT16)
    assert calls and got.dtype == torch.float32
    cpu = px.peinsum(subscripts, a.cpu(), b.cpu(), px.BFLOAT16)
    torch.testing.assert_close(got.cpu(), cpu, rtol=1e-4, atol=1e-4)


def test_bfloat16_linalg_on_the_card_within_error_bounds(dev):
    # the linear algebra under BFLOAT16 now runs native bf16 products: the
    # svd block tier (peinsum) and random_svd (pdot) hold their bounds
    rng = np.random.RandomState(13)
    x = rng.rand(1024, 256).astype(np.float32)
    s64 = np.linalg.svd(x.astype(np.float64), compute_uv=False)
    u, s, v = dst.svd(dst.array(x, device=dev), precision="bfloat16")
    s = s.collect().ravel()
    assert np.abs(s - s64).max() / s64[0] <= \
        px.ERROR_BOUNDS[("svd_values", "bfloat16")]
    approx = (u.collect().astype(np.float64) * s) @ v.collect().T
    assert np.linalg.norm(approx - x) / np.linalg.norm(x) <= \
        px.ERROR_BOUNDS[("svd_resid", "bfloat16")]
    xr = (rng.standard_normal((8192, 512)) * 0.95 ** np.arange(512)).astype(
        np.float32)
    _, sr, _ = dst.random_svd(dst.array(xr, device=dev), iters=2, nsv=16,
                              random_state=0, precision="bfloat16")
    exact = np.linalg.svd(xr.astype(np.float64), compute_uv=False)[:16]
    assert np.abs(sr.collect().ravel() - exact).max() / exact[0] <= \
        px.ERROR_BOUNDS[("randomsvd_values", "bfloat16")]


def test_new_estimators_on_the_card_match_the_cpu(dev):
    # GaussianMixture (its KMeans init launches distances_sq),
    # MiniBatchKMeans, the scalers, LinearRegression and Lasso: the card
    # against the CPU at 1e-4 (f32 sums in other orders)
    rng = np.random.RandomState(14)
    centers = rng.uniform(-5, 5, (4, 10))
    x = (centers[rng.randint(0, 4, 20_000)]
         + rng.standard_normal((20_000, 10))).astype(np.float32)
    y = (x @ rng.standard_normal((10, 1)) + 0.1).astype(np.float32)
    on = {d: (dst.array(x, device=d), dst.array(y, device=d))
          for d in (dev, "cpu")}

    def both(fit, *attrs):
        outs = [fit(*on[d]) for d in (dev, "cpu")]
        for a in attrs:
            np.testing.assert_allclose(getattr(outs[0], a),
                                       getattr(outs[1], a), rtol=1e-4,
                                       atol=1e-4, err_msg=a)
        return outs

    K.reset_launches()
    gpu, cpu = both(lambda X, Y: dst.GaussianMixture(
        n_components=4, random_state=0, tol=1e-3).fit(X),
        "weights_", "means_", "covariances_")
    assert gpu.n_iter_ == cpu.n_iter_
    assert 1 <= K.LAUNCHES["distances_sq"] <= 11
    both(lambda X, Y: dst.MiniBatchKMeans(
        n_clusters=4, batch_size=4096, random_state=0).fit(X),
        "centers_", "counts_")
    gpu, cpu = both(lambda X, Y: dst.StandardScaler().fit(X))
    np.testing.assert_allclose(gpu.var_.collect(), cpu.var_.collect(),
                               rtol=1e-5)
    both(lambda X, Y: dst.LinearRegression().fit(X, Y), "coef_",
         "intercept_")
    gpu, cpu = both(lambda X, Y: dst.Lasso(lmbd=50.0).fit(X, Y), "coef_")
    assert gpu.n_iter_ == cpu.n_iter_


@pytest.mark.parametrize("shape", [((10_000, 10), 4096), ((66_667, 20), 4096)],
                         ids=["knn", "knn-search"])
def test_distances_sq_at_the_knn_shapes(dev, shape):
    # a kNN chunk: bench_knn's width (d = 10 takes the slices) and the
    # search's (d = 20, the stream)
    (m, d), k = shape
    g = torch.Generator(device=dev).manual_seed(15)
    a = torch.rand((m, d), generator=g, device=dev)
    b = torch.rand((k, d), generator=g, device=dev)
    nsm = torch.cuda.get_device_properties(dev).multi_processor_count
    assert (K.dist_plan(m, d, a.data_ptr(), nsm).rows == 0) == (d % 4 != 0)
    got = K.distances_sq(a, b)
    want = K.distances_sq_plain(a, b, "highest")
    scale = float((a.double() ** 2).sum(1).max()
                  + (b.double() ** 2).sum(1).max())
    assert float((got.double() - want.double()).abs().max()) / scale <= 1e-5
    assert K.LAUNCHES["distances_sq"] == 1


def test_panel_gemm_at_the_ring_cross_term(dev):
    # the ring's q @ f^T at the kNN width: K = 10, one K stage
    g = torch.Generator(device=dev).manual_seed(16)
    q = torch.rand((3000, 10), generator=g, device=dev)
    ft = torch.rand((10, 5000), generator=g, device=dev)
    got = K.panel_gemm(q, ft, px.FLOAT32)
    assert _gemm_err(got, K.panel_gemm_plain(q, ft, px.FLOAT32), q, ft) <= \
        px.ERROR_BOUNDS[("matmul", "float32")]
    assert K.LAUNCHES["panel_gemm"] == 1


@pytest.mark.parametrize("chunk", [4096, 500], ids=["direct", "chunked"])
def test_kneighbors_tie_rule_on_the_card(dev, chunk, monkeypatch):
    # identical fit rows give bit-identical kernel distances: the lower
    # fit index must come first, across chunk boundaries too
    from dislib_tpu_torch.neighbors import NearestNeighbors
    from dislib_tpu_torch.neighbors import base as nb
    monkeypatch.setattr(nb, "_CHUNK", chunk)
    rng = np.random.RandomState(17)
    f = rng.rand(3000, 10).astype(np.float32)
    groups = [[10, 11, 499, 500, 2999], [7, 1000, 1001, 2500]]
    for grp in groups:
        f[grp] = f[grp[0]]
    q = f[[10, 7]] + 0.01
    nn = NearestNeighbors(n_neighbors=6).fit(dst.array(f, device=dev))
    _, idx = nn.kneighbors(dst.array(q, device=dev))
    got = idx.collect()
    assert K.LAUNCHES["distances_sq"] == (1 if chunk == 4096 else 6)
    for row, grp in enumerate(groups):
        np.testing.assert_array_equal(got[row, :len(grp)], grp)
    same = np.repeat(f[:1], 3000, axis=0)
    _, idx = NearestNeighbors(n_neighbors=40).fit(
        dst.array(same, device=dev)).kneighbors(dst.array(q, device=dev))
    np.testing.assert_array_equal(idx.collect(),
                                  np.tile(np.arange(40), (2, 1)))


def test_ring_on_the_card_matches_the_chunked_path(dev, monkeypatch):
    # the single-rank ring under overlap="kernel": the cross term on
    # panel_gemm; against the chunked path on the card
    from dislib_tpu_torch.neighbors import NearestNeighbors
    from dislib_tpu_torch.neighbors import base as nb
    from dislib_tpu_torch.ops.ring import ring_kneighbors
    monkeypatch.setattr(nb, "_CHUNK", 1000)
    rng = np.random.RandomState(18)
    f = rng.rand(5000, 10).astype(np.float32)
    q = rng.rand(700, 10).astype(np.float32)
    fd, qd = torch.from_numpy(f).to(dev), torch.from_numpy(q).to(dev)
    d2, idx = ring_kneighbors(qd, fd, dst.get_mesh(), 11, 5000,
                              overlap="kernel")
    assert K.LAUNCHES == {"panel_gemm": 1, "distances_sq": 0,
                          "node_histogram": 0}
    dc, ic = NearestNeighbors(n_neighbors=11).fit(
        dst.array(f, device=dev)).kneighbors(dst.array(q, device=dev))
    assert K.LAUNCHES["distances_sq"] == 5
    dc, ic = dc.collect(), ic.collect()
    np.testing.assert_allclose(torch.sqrt(d2).cpu().numpy(), dc, rtol=1e-5,
                               atol=1e-5)
    # indices equal where the chunked path has no tie within 1e-5
    gap = np.diff(dc, axis=1) > 1e-5
    clear = np.concatenate([gap[:, :1], gap[:, 1:] & gap[:, :-1]], axis=1)
    got = idx.cpu().numpy()[:, :-1]
    assert (got[clear] == ic[:, :-1][clear]).all()


def test_search_on_the_card_reads_only_scores_after_the_next_fold(
        dev, monkeypatch):
    # the kNN search on the card: each fold's fits and scores are enqueued
    # before the previous fold's scores are read; the only host reads are
    # the scores (utils/profiling.HOST_READS), and they equal the CPU's
    from dislib_tpu_torch.classification import KNeighborsClassifier
    from dislib_tpu_torch.model_selection import GridSearchCV
    from dislib_tpu_torch.model_selection import search
    from dislib_tpu_torch.utils import profiling
    rng = np.random.RandomState(19)
    lab = rng.randint(0, 3, 3000)
    x = (rng.rand(3, 8)[lab] + 0.2 * rng.standard_normal((3000, 8))).astype(
        np.float32)
    y = lab.astype(np.float32)[:, None]
    grid = {"n_neighbors": [1, 5], "weights": ["uniform", "distance"]}
    cpu = GridSearchCV(KNeighborsClassifier(), grid, cv=3, refit=False).fit(
        dst.array(x, device="cpu"), dst.array(y, device="cpu"))
    events = []
    real_read, real_fit = search.host_read, KNeighborsClassifier._fit_async

    def spy_read(v, site):
        assert v.is_cuda
        events.append("read")
        return real_read(v, site)

    def spy_fit(self, xt, yt=None):
        events.append("fit")
        return real_fit(self, xt, yt)

    monkeypatch.setattr(search, "host_read", spy_read)
    monkeypatch.setattr(KNeighborsClassifier, "_fit_async", spy_fit)
    profiling.reset_host_reads()
    gpu = GridSearchCV(KNeighborsClassifier(), grid, cv=3, refit=False).fit(
        dst.array(x, device=dev), dst.array(y, device=dev))
    assert profiling.HOST_READS == {"search": 12}
    assert events == (["fit"] * 4 + ["fit"] * 4 + ["read"] * 4
                      + ["fit"] * 4 + ["read"] * 4 + ["read"] * 4)
    for j in range(3):
        np.testing.assert_allclose(gpu.cv_results_[f"split{j}_test_score"],
                                   cpu.cv_results_[f"split{j}_test_score"],
                                   atol=1e-6)


def test_knn_trial_on_the_card_never_synchronises(dev):
    # a kNN trial's fit (the class codes on the card) and its score queue
    # behind the work before them: torch raises on any synchronising call
    # in "error" mode; classes_ are read at _fit_finalize only
    from dislib_tpu_torch.classification import KNeighborsClassifier
    from dislib_tpu_torch.utils import profiling
    rng = np.random.RandomState(20)
    lab = rng.randint(0, 4, 2000)
    x = (rng.rand(4, 6)[lab] + 0.1 * rng.standard_normal((2000, 6))).astype(
        np.float32)
    y = (lab * 2.5).astype(np.float32)[:, None]
    xt, yt = dst.array(x[:1500], device=dev), dst.array(y[:1500], device=dev)
    xv, yv = dst.array(x[1500:], device=dev), dst.array(y[1500:], device=dev)
    est = KNeighborsClassifier(n_neighbors=7, weights="distance")
    torch.cuda.synchronize()
    profiling.reset_host_reads()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = est._fit_async(xt, yt)
        got = est._score_async(state, xv, yv)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert profiling.HOST_READS == {}
    est._fit_finalize(state)
    assert profiling.HOST_READS == {"results": 1}
    np.testing.assert_array_equal(est.classes_, np.unique(y))
    want = KNeighborsClassifier(n_neighbors=7, weights="distance").fit(
        dst.array(x[:1500], device="cpu"), dst.array(y[:1500], device="cpu")
    ).score(dst.array(x[1500:], device="cpu"),
            dst.array(y[1500:], device="cpu"))
    assert abs(float(got) - want) <= 1e-6


# -- the bf16-operand distances_sq (KMeans fast_distance) --------------------------

@pytest.mark.parametrize("d", [1, 7, 8, 33, 100, 300])
@pytest.mark.parametrize("k", [1, 10, 17])
def test_distances_sq_bf16_matches_plain(dev, d, k):
    """Within 1e-5 of the plain version relative to max‖a‖² + max‖b‖²:
    both sum the same exact bf16 products in float32, in another order."""
    g = torch.Generator(device=dev).manual_seed(d * 100 + k)
    m = 1000 + 3 * d
    a = torch.randn((m, d), generator=g, device=dev)
    b = torch.randn((k, d), generator=g, device=dev)
    a16, a_sq = K.bf16_rows(a), (a * a).sum(1)
    got = K.distances_sq_bf16(a16, a_sq, b)
    torch.cuda.synchronize()
    want = K.distances_sq_bf16_plain(a16, a_sq, b)
    scale = float((a.double() ** 2).sum(1).max()
                  + (b.double() ** 2).sum(1).max())
    assert got.shape == (m, k) and (got >= 0).all()
    assert float((got.double() - want.double()).abs().max()) / scale <= 1e-5
    assert K.LAUNCHES["distances_sq"] == 1
    via = K.distances_sq(a, b, precision="default")
    assert float((via.double() - want.double()).abs().max()) / scale <= 1e-5
    assert K.LAUNCHES["distances_sq"] == 2


def test_distances_sq_bf16_rejects_what_it_does_not_take(dev):
    a = torch.randn((64, 12), device=dev)
    a16, a_sq, b = K.bf16_rows(a), (a * a).sum(1), torch.randn((3, 12),
                                                               device=dev)
    with pytest.raises(TypeError):
        K.distances_sq_bf16(a16.float(), a_sq, b)
    with pytest.raises(ValueError, match="multiple of 8"):
        K.distances_sq_bf16(a16[:, :12].contiguous(), a_sq, b)
    with pytest.raises(ValueError, match="aligned"):     # 8 bytes in
        K.distances_sq_bf16(a16.view(-1)[4: 4 + 63 * 16].view(63, 16),
                            a_sq[:63], b)
    nan_a = a.clone()
    nan_a[5, 2] = float("nan")
    got = K.distances_sq_bf16(K.bf16_rows(nan_a), (nan_a * nan_a).sum(1), b)
    assert torch.isnan(got[5]).all() and not torch.isnan(got[:5]).any()
    assert K.LAUNCHES["distances_sq"] == 1


def test_kmeans_fast_distance_on_the_card_matches_the_cpu(dev):
    """Labels equal on well-separated blobs; centers at 1e-4 (the M-step
    sums the same float32 rows in another order)."""
    rng = np.random.RandomState(4)
    centers = rng.uniform(-10, 10, (4, 6))
    x = (centers[rng.randint(0, 4, 4000)]
         + rng.standard_normal((4000, 6))).astype(np.float32)
    init = x[[0, 1000, 2000, 3000]].copy()
    kw = dict(n_clusters=4, init=init, max_iter=10, tol=0.0,
              fast_distance=True)
    card = dst.KMeans(**kw).fit(dst.array(x, device=dev))
    assert K.LAUNCHES["distances_sq"] == card.n_iter_ == 10
    cpu = dst.KMeans(**kw).fit(dst.array(x, device="cpu"))
    assert card.n_iter_ == cpu.n_iter_
    np.testing.assert_allclose(card.centers_, cpu.centers_, rtol=1e-4,
                               atol=1e-4)


# -- a model saved on the card and loaded back onto it ----------------------------

@pytest.mark.parametrize("fmt", ["json", "cbor", "npz"])
def test_model_round_trip_on_the_card(dev, tmp_path, fmt):
    """A forest, a kNN classifier and PCA fitted on the card, saved, loaded
    onto the card: predictions bit-equal, state on the card."""
    from dislib_tpu_torch import load_model, save_model
    from dislib_tpu_torch.classification import KNeighborsClassifier
    rng = np.random.RandomState(9)
    x = rng.standard_normal((3000, 8)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] > 0).astype(np.float32)[:, None]
    X, Y = dst.array(x, device=dev), dst.array(y, device=dev)
    models = [RandomForestClassifier(n_estimators=3, max_depth=5,
                                     random_state=0).fit(X, Y),
              KNeighborsClassifier(n_neighbors=5).fit(X, Y),
              dst.PCA(n_components=3).fit(X),
              dst.KMeans(n_clusters=3, random_state=0).fit(X)]
    for est in models:
        path = str(tmp_path / f"{type(est).__name__}.{fmt}")
        save_model(est, path, save_format=fmt)
        back = load_model(path, device=dev)
        if isinstance(est, dst.PCA):
            assert back.components_.device == dev
            got, want = back.transform(X), est.transform(X)
        else:
            got, want = back.predict(X), est.predict(X)
        assert got.device == dev
        assert torch.equal(got._data, want._data)
    assert models[0]._leaves.device.type == "cuda"


# -- the ε-pass, DBSCAN and Daura --------------------------------------------------

@pytest.mark.parametrize("m,d,k,pad", [(20_000, 10, 2048, False),
                                       (20_000, 10, 2048, True),
                                       (5_000, 15, 1, True),
                                       (3_001, 15, 3_001, True)],
                         ids=["eps-slices", "eps-stream", "medoid", "dense"])
def test_distances_sq_at_the_eps_pass_shapes(dev, m, d, k, pad):
    from dislib_tpu_torch.ops import tiled
    g = torch.Generator(device=dev).manual_seed(16)
    x = torch.rand((m, d), generator=g, device=dev)
    if pad:
        x = tiled.pad_cols(x)
        assert x.shape[1] % 4 == 0 and not x[:, d:].any()
    a, b = x, x[:k]
    nsm = torch.cuda.get_device_properties(dev).multi_processor_count
    assert (K.dist_plan(m, x.shape[1], a.data_ptr(), nsm).rows > 0) == pad
    got = K.distances_sq(a, b)
    want = K.distances_sq_plain(a, b, "highest")
    scale = float(2 * (a.double() ** 2).sum(1).max())
    assert float((got.double() - want.double()).abs().max()) / scale <= 1e-5
    assert K.LAUNCHES["distances_sq"] == 1


def _margin_blobs(m, n, k, seed, std, thr):
    """Blobs whose pairwise float64 d² keeps 1e-3 from ``thr``."""
    rng = np.random.RandomState(seed)
    c = rng.rand(k, n)
    x = (c[rng.randint(0, k, m)] + std * rng.standard_normal((m, n)))
    x64 = x.astype(np.float32).astype(np.float64)
    sq = (x64 ** 2).sum(1)
    d2 = sq[:, None] - 2 * x64 @ x64.T + sq[None]
    near = np.abs(d2 - thr) < 1e-3
    np.fill_diagonal(near, False)
    return x[~near.any(1)].astype(np.float32)


@pytest.mark.parametrize("tier", ["dense", "tiled", "ring"])
def test_dbscan_and_daura_on_the_card_match_the_cpu(dev, tier, monkeypatch):
    from dislib_tpu_torch.cluster import daura as da_mod
    from dislib_tpu_torch.cluster import dbscan as db_mod
    from dislib_tpu_torch.ops import ring, tiled
    for mod in (db_mod, da_mod):
        if tier == "tiled":
            monkeypatch.setattr(mod, "_DENSE_MAX", 0)
        if tier == "ring":
            monkeypatch.setattr(mod, "_RING", True)
    monkeypatch.setattr(tiled, "TILE", 256)
    monkeypatch.setattr(ring, "RING_TILE", 256)
    x = _margin_blobs(1500, 10, 6, 3, 0.08, 0.3 ** 2)
    card = dst.DBSCAN(eps=0.3, min_samples=5).fit(dst.array(x, device=dev))
    assert K.LAUNCHES["distances_sq"] >= 1
    cpu = dst.DBSCAN(eps=0.3, min_samples=5).fit(dst.array(x, device="cpu"))
    np.testing.assert_array_equal(card.labels_, cpu.labels_)
    np.testing.assert_array_equal(card.core_sample_indices_,
                                  cpu.core_sample_indices_)
    f = _margin_blobs(1200, 15, 5, 6, 0.05, 0.3 ** 2 * 5)
    K.reset_launches()
    card = dst.Daura(cutoff=0.3).fit(dst.array(f, device=dev))
    # the dense tier's one (m, m) matrix, or a pass and a medoid column
    # per cluster
    per_cluster = -(-len(f) // 256) + 1
    assert K.LAUNCHES["distances_sq"] == (1 if tier == "dense" else
                                          len(card.clusters_) * per_cluster)
    cpu = dst.Daura(cutoff=0.3).fit(dst.array(f, device="cpu"))
    np.testing.assert_array_equal(card.labels_, cpu.labels_)
    assert [c[0] for c in card.clusters_] == [c[0] for c in cpu.clusters_]


# -- the sparse ds-array -----------------------------------------------------------

def _sparse(m, n, density, seed):
    import scipy.sparse as sp
    return sp.random(m, n, density=density, random_state=seed,
                     dtype=np.float32, format="csr")


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
def test_spmm_on_the_card_is_bit_identical_and_matches_the_cpu(dev, policy):
    from dislib_tpu_torch.ops.spmm import spmm
    mat = _sparse(3000, 2000, 0.01, 17)
    b = np.random.RandomState(18).rand(2000, 33).astype(np.float32)
    xs = dst.SparseArray.from_scipy(mat, device=dev)
    B = dst.array(b, device=dev)
    one = spmm(xs, B, precision=policy)._data
    two = spmm(xs, B, precision=policy)._data
    assert torch.equal(one, two)
    cpu = spmm(dst.SparseArray.from_scipy(mat, device="cpu"),
               dst.array(b, device="cpu"), precision=policy)._data
    np.testing.assert_allclose(one.cpu().numpy(), cpu.numpy(), rtol=1e-5,
                               atol=1e-5)
    dense = dst.matmul(xs, B, algorithm="densify", precision=policy)
    np.testing.assert_allclose(dense.collect(), one.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


def test_sparse_kmeans_on_the_card_is_bit_identical(dev):
    mat = _sparse(5000, 400, 0.05, 19)
    xs = dst.SparseArray.from_scipy(mat, device=dev)
    kw = dict(n_clusters=6, random_state=2, max_iter=15, tol=0.0)
    a, b = dst.KMeans(**kw).fit(xs), dst.KMeans(**kw).fit(xs)
    np.testing.assert_array_equal(a.centers_, b.centers_)
    assert a.inertia_ == b.inertia_ and a.n_iter_ == b.n_iter_ == 15
    np.testing.assert_array_equal(a.predict(xs).collect(),
                                  b.predict(xs).collect())
    assert K.LAUNCHES["distances_sq"] == 0
    cpu = dst.KMeans(**{**kw, "max_iter": 1}).fit(
        dst.SparseArray.from_scipy(mat, device="cpu"))
    one = dst.KMeans(**{**kw, "max_iter": 1}).fit(xs)
    np.testing.assert_allclose(one.centers_, cpu.centers_, rtol=1e-5,
                               atol=1e-5)
    col_sums = xs.sum(0)
    assert col_sums.device.type == "cuda"
    np.testing.assert_allclose(col_sums.collect(), np.asarray(mat.sum(0)),
                               rtol=1e-5, atol=1e-5)


# -- the batched distances_sq entry, CascadeSVM and the sparse kNN -----------------

@pytest.mark.parametrize("shape", [(20, 1024, 20), (3, 512, 20),
                                   (7, 257, 20), (2, 300, 33), (1, 64, 4)],
                         ids=str)
def test_distances_sq_batched_matches_plain(dev, shape):
    # level 0's nodes, a merged level's, a ragged last level (cap not a
    # multiple of a tile), an odd width (the slices), a single node
    nb, cap, d = shape
    g = torch.Generator(device=dev).manual_seed(cap + d)
    a = torch.randn(shape, generator=g, device=dev)
    b = torch.randn((nb, cap // 2 + 1, d), generator=g, device=dev)
    for lhs, rhs in ((a, a), (a, b)):
        K.reset_launches()
        got = K.distances_sq_batched(lhs, rhs)
        torch.cuda.synchronize()
        assert K.LAUNCHES["distances_sq"] == 1        # one launch, nb nodes
        want = K.distances_sq_batched_plain(lhs, rhs)
        scale = float((lhs * lhs).sum(2).max() + (rhs * rhs).sum(2).max())
        assert float((got - want).abs().max()) / scale <= 1e-5
        for i in (0, nb - 1):             # no node reads past its own rows
            one = K.distances_sq(lhs[i].contiguous(), rhs[i].contiguous())
            assert torch.equal(got[i], one)


def test_csvm_on_the_card_matches_the_cpu(dev):
    import scipy.sparse as sp
    from dislib_tpu_torch.classification import CascadeSVM
    rng = np.random.RandomState(21)
    x = np.vstack([rng.randn(600, 6), rng.randn(600, 6) + 2.5]).astype(
        np.float32)
    y = np.r_[np.zeros(600), np.ones(600)].astype(np.float32)[:, None]
    kw = dict(max_iter=2, check_convergence=False)
    card = CascadeSVM(**kw).fit(dst.array(x, block_size=(256, 6), device=dev),
                                dst.array(y, device=dev))
    assert K.LAUNCHES["distances_sq"] >= 2        # batched, one a level
    again = CascadeSVM(**kw).fit(dst.array(x, block_size=(256, 6),
                                           device=dev),
                                 dst.array(y, device=dev))
    np.testing.assert_array_equal(card._sv_alpha, again._sv_alpha)
    cpu = CascadeSVM(**kw).fit(dst.array(x, block_size=(256, 6),
                                         device="cpu"),
                               dst.array(y, device="cpu"))
    np.testing.assert_array_equal(card._sv_idx, cpu._sv_idx)
    np.testing.assert_allclose(card._sv_alpha, cpu._sv_alpha, atol=1e-4)
    xs = sp.csr_matrix(np.where(x > 1.0, x, 0.0))
    ell = CascadeSVM(**kw).fit(dst.SparseArray.from_scipy(xs, device=dev),
                               dst.array(y, device=dev))
    dense = CascadeSVM(**kw).fit(dst.array(xs.toarray(), device=dev),
                                 dst.array(y, device=dev))
    np.testing.assert_array_equal(ell._sv_alpha, dense._sv_alpha)
    q = dst.SparseArray.from_scipy(xs[:100], device=dev)
    np.testing.assert_allclose(
        ell.decision_function(q).collect(),
        ell.decision_function(dst.array(xs[:100].toarray(),
                                        device=dev)).collect(),
        atol=1e-4)


def test_sparse_kneighbors_on_the_card_matches_the_cpu(dev):
    mat, q = _sparse(3000, 500, 0.02, 22), _sparse(200, 500, 0.02, 23)
    out = {}
    for where in (dev, "cpu"):
        nn = dst.NearestNeighbors(n_neighbors=5).fit(
            dst.SparseArray.from_scipy(mat, device=where))
        out[str(where)] = [a.collect() for a in nn.kneighbors(
            dst.SparseArray.from_scipy(q, device=where))]
    np.testing.assert_allclose(out[str(dev)][0], out["cpu"][0], rtol=1e-5,
                               atol=1e-5)
    assert K.LAUNCHES["distances_sq"] == 0


def test_panel_gemm_at_the_ivf_centroid_shape(dev):
    # the IVF search's centroid cross term under overlap="kernel": 4,096
    # queries x 64 features against 1,024 centroids
    g = torch.Generator(device=dev).manual_seed(24)
    q = torch.randn((4096, 64), generator=g, device=dev)
    ct = torch.randn((64, 1024), generator=g, device=dev)
    got = K.panel_gemm(q, ct, px.FLOAT32)
    assert K.LAUNCHES["panel_gemm"] == 1
    assert _gemm_err(got, K.panel_gemm_plain(q, ct, px.FLOAT32), q, ct) \
        <= px.ERROR_BOUNDS[("matmul", "float32")]


def test_distances_sq_at_the_ivf_quantizer_shape(dev):
    # the IVF quantizer's E-step: 1,000,000 catalog rows x 64 against
    # 1,024 centres (a 4 GB output)
    g = torch.Generator(device=dev).manual_seed(25)
    a = torch.randn((1_000_000, 64), generator=g, device=dev) * 4.0
    b = torch.randn((1024, 64), generator=g, device=dev) * 4.0
    got = K.distances_sq(a, b)
    assert K.LAUNCHES["distances_sq"] == 1
    scale = float((a.double() ** 2).sum(1).max()
                  + (b.double() ** 2).sum(1).max())
    want = K.distances_sq_plain(a, b, "highest")
    assert float((got.double() - want.double()).abs().max()) <= 1e-5 * scale
    assert bool((got >= 0).all())


def test_als_on_the_card_matches_the_cpu(dev, monkeypatch):
    from dislib_tpu_torch.recommendation import ALS
    from dislib_tpu_torch.recommendation import als as als_mod
    # one V0 for both devices: a generator on the card draws another
    # stream than one on the CPU
    draw = als_mod._draw_items
    monkeypatch.setattr(als_mod, "_draw_items",
                        lambda seed, n, n_f, device: draw(
                            seed, n, n_f, "cpu").to(device))
    mat = _sparse(2000, 300, 0.05, 26)
    fits = {}
    for where in (dev, "cpu", dev):
        est = ALS(n_f=8, tol=0.0, max_iter=3, random_state=0)
        x = dst.SparseArray.from_scipy(mat, device=where)
        fits.setdefault(str(where), []).append(est.fit(x))
    card, again = fits[str(dev)]
    cpu = fits["cpu"][0]
    # the segment sums are fixed-order: two card fits bit-identical
    np.testing.assert_array_equal(card.users_, again.users_)
    np.testing.assert_array_equal(card.items_, again.items_)
    np.testing.assert_allclose(card.users_, cpu.users_, rtol=0, atol=1e-4)
    np.testing.assert_allclose(card.items_, cpu.items_, rtol=0, atol=1e-4)
    dense = ALS(n_f=8, tol=0.0, max_iter=3, random_state=0).fit(
        dst.array(mat.toarray(), device=dev))
    np.testing.assert_allclose(dense.users_, card.users_, rtol=0, atol=1e-4)
    np.testing.assert_allclose(card.fold_in(mat[:5]), cpu.fold_in(mat[:5]),
                               rtol=0, atol=1e-4)
    assert sum(K.LAUNCHES.values()) == 0


def test_ivf_on_the_card_matches_the_cpu(dev):
    from dislib_tpu_torch.retrieval import IVFIndex
    rng = np.random.RandomState(27)
    centers = rng.randn(16, 32).astype(np.float32) * 4
    x = (centers[rng.randint(0, 16, 5000)]
         + rng.randn(5000, 32)).astype(np.float32)
    q = (centers[rng.randint(0, 16, 300)]
         + rng.randn(300, 32)).astype(np.float32)
    out = {}
    for where in (dev, "cpu"):
        ix = IVFIndex(n_lists=16, nprobe=4, kmeans_max_iter=5,
                      random_state=0).fit(dst.array(x, device=where))
        out[str(where)] = {r: [a.collect() for a in ix.search(
            dst.array(q, device=where), k=10, overlap=r)]
            for r in ("db", "kernel")}
    card, cpu = out[str(dev)], out["cpu"]
    assert K.LAUNCHES["distances_sq"] >= 5
    assert K.LAUNCHES["panel_gemm"] == 1
    scale = float((q ** 2).sum(1).max() + (x ** 2).sum(1).max())
    for r in ("db", "kernel"):
        np.testing.assert_array_equal(card[r][1], cpu[r][1])
        np.testing.assert_allclose(card[r][0] ** 2, cpu[r][0] ** 2, rtol=0,
                                   atol=1e-5 * scale)


# -- the checkpointed fit ------------------------------------------------------

def test_async_fetch_holds_the_value_before_an_in_place_chunk(dev):
    from dislib_tpu_torch.runtime import fetch
    carry = torch.arange(1 << 22, dtype=torch.float32, device=dev)
    want = carry.cpu().numpy()
    for _ in range(3):
        handle = fetch(carry, blocking=False)
        # the next "chunk": many in-place updates enqueued right behind
        # the copy on the same stream
        for _ in range(20):
            carry.mul_(1.0001).add_(1.0)
        np.testing.assert_array_equal(handle.result(), want)
        want = carry.cpu().numpy()


def test_checkpointed_kmeans_is_the_unchecked_fit(dev, tmp_path):
    from dislib_tpu_torch.utils.checkpoint import FitCheckpoint
    from dislib_tpu_torch.utils import profiling as prof
    x = dst.array(np.random.RandomState(4).rand(20000, 16).astype(
        np.float32), device=dev)
    kw = dict(n_clusters=8, random_state=0, max_iter=30, tol=0.0)
    prof.reset_host_reads()
    plain = dst.KMeans(**kw).fit(x)
    assert prof.HOST_READS == {"results": 1}
    assert K.LAUNCHES["distances_sq"] == 30
    checked = dst.KMeans(**kw).fit(x, checkpoint=FitCheckpoint(
        str(tmp_path / "k.npz"), every=10))
    assert K.LAUNCHES["distances_sq"] == 60
    np.testing.assert_array_equal(checked.centers_, plain.centers_)
    assert checked.fit_info_["chunks"] == 3


def test_resumed_forest_is_bit_identical(dev, tmp_path):
    from dislib_tpu_torch.runtime import Preempted, clear_preemption
    from dislib_tpu_torch.runtime import request_preemption
    from dislib_tpu_torch.utils import faults
    from dislib_tpu_torch.utils.checkpoint import FitCheckpoint
    rng = np.random.RandomState(6)
    x = rng.rand(5000, 12).astype(np.float32)
    y = (x[:, 0] + x[:, 1] > 1).astype(np.float32)[:, None]
    X, Y = dst.array(x, device=dev), dst.array(y, device=dev)
    kw = dict(n_estimators=4, random_state=0, try_features="sqrt")
    plain = RandomForestClassifier(**kw).fit(X, Y)
    path = str(tmp_path / "f.npz")
    with pytest.raises(Preempted):
        RandomForestClassifier(**kw).fit(X, Y, checkpoint=faults.
                                         CallbackCheckpoint(
                                             path, every=2, after=1,
                                             callback=request_preemption))
    clear_preemption()
    lvl = int(FitCheckpoint(path).load()["lvl"])
    K.reset_launches()
    resumed = RandomForestClassifier(**kw).fit(
        X, Y, checkpoint=FitCheckpoint(path, every=2))
    assert K.LAUNCHES["node_histogram"] == plain._depth - lvl
    np.testing.assert_array_equal(resumed._feats, plain._feats)
    np.testing.assert_array_equal(resumed._tbins, plain._tbins)
    assert torch.equal(resumed._leaves, plain._leaves)


# ---------------------------------------------------------------------------
# serving: one CUDA-graph replay a bucket
# ---------------------------------------------------------------------------

SERVE_BUCKETS = (1, 8, 64, 512)


def _served(kind, dev):
    """(pipeline, direct(rows) -> ndarray, feature width) of one served
    chain, fitted on the card."""
    from dislib_tpu_torch.retrieval import IVFIndex, RetrievalPipeline
    from dislib_tpu_torch.serving import ServePipeline, SparseFoldInPipeline
    dst.init(device=dev)
    rng = np.random.RandomState(9)
    x = rng.rand(4000, 20).astype(np.float32)
    a = dst.array(x)
    if kind == "scaler_kmeans":
        sc = dst.StandardScaler().fit(a)
        km = dst.KMeans(n_clusters=10, max_iter=5, random_state=0).fit(a)
        return (ServePipeline(km, transforms=(sc,)),
                lambda r: km.predict(sc.transform(dst.array(r))).collect(), x)
    if kind == "linreg":
        lr = dst.LinearRegression().fit(a, dst.array(x[:, :2] * 3 + 1))
        return ServePipeline(lr), \
            lambda r: lr.predict(dst.array(r)).collect(), x
    if kind == "forest_proba":
        y = (x[:, 0] + x[:, 1] > 1).astype(np.float32)[:, None]
        rf = RandomForestClassifier(n_estimators=3, max_depth=5,
                                    random_state=0).fit(a, dst.array(y))
        return ServePipeline(rf, method="predict_proba"), \
            lambda r: rf.predict_proba(dst.array(r)).collect(), x
    if kind == "fold_in":
        import scipy.sparse as sp
        r = sp.random(500, 120, density=0.1, random_state=2, format="csr",
                      dtype=np.float32)
        r.data = 1 + 4 * r.data
        als = dst.ALS(n_f=8, max_iter=3, tol=0.0, random_state=0).fit(
            dst.SparseArray.from_dense(r.toarray(), device=dev))
        pipe = SparseFoldInPipeline(als, nse_cap=32)
        return pipe, lambda q: None, pipe.pack(r[:600])
    cat = rng.randn(20000, 16).astype(np.float32)
    ix = IVFIndex(n_lists=32, nprobe=4, random_state=0).fit(dst.array(cat))
    pipe = RetrievalPipeline(ix, k=5, overlap="kernel")

    def direct(q):
        d, i = ix.search(q, k=5, overlap="kernel")
        return np.concatenate([i.collect().astype(np.float32),
                               d.collect()], axis=1)
    return pipe, direct, cat[:600] + 0.01


@pytest.mark.parametrize("kind", ["scaler_kmeans", "linreg",
                                  "forest_proba", "fold_in", "ivf_kernel"])
def test_served_replay_is_bit_equal_to_the_eager_chain(dev, kind):
    from dislib_tpu_torch.serving import ProgramCache
    pipe, direct, rows = _served(kind, dev)
    cache = ProgramCache()
    cache.warm(pipe, "g", SERVE_BUCKETS)
    for b in SERVE_BUCKETS:
        prog = pipe.program(b)
        assert prog.mode == "graph", prog.reason
        got = pipe.predict_bucket(rows[:b], b)
        want = direct(rows[:b])
        if want is not None:
            np.testing.assert_array_equal(got, want)
        replay = prog.replay_device().clone()
        assert torch.equal(replay, prog.eager_device()), b
    assert all(v["captures_at_warm"] == 1 and v["builds_at_warm"] == 0
               for v in cache.stats().values())


def test_pinned_template_fills_as_the_host_one(dev):
    from dislib_tpu_torch.serving.buckets import BucketTemplate
    rng = np.random.RandomState(1)
    pinned, host = BucketTemplate((8, 4), pinned=True), \
        BucketTemplate((8, 4))
    assert pinned.tensor.is_pinned()
    for k in (5, 2, 7, 1):
        rows = rng.rand(k, 4).astype(np.float32)
        np.testing.assert_array_equal(pinned.fill(rows), host.fill(rows))


def test_one_replay_per_piece_and_no_capture_after_warm(dev):
    from dislib_tpu_torch.serving import PredictServer, split_rows
    from dislib_tpu_torch.utils import profiling as prof
    pipe, direct, x = _served("scaler_kmeans", dev)
    sizes = [1, 3, 17, 64, 100, 700, 1100]
    want = {k: direct(x[:k]) for k in sizes}
    with PredictServer(pipeline=pipe, buckets=SERVE_BUCKETS,
                       deadline_ms=2) as srv:
        assert prof.trace_count() >= len(SERVE_BUCKETS)
        K.reset_launches()
        prof.reset_counters()
        # one request a batch: each batch's dispatches are its pieces
        got = [srv.predict(x[:k]) for k in sizes]
        hist = list(srv._dispatch_hist)
        futs = [srv.submit(x[:k]) for k in sizes]     # coalesced
        got += [f.result(timeout=60).values for f in futs]
        c = prof.counters()
    for k, g in zip(sizes + sizes, got):
        np.testing.assert_array_equal(g, want[k])
    assert hist == [len(split_rows(k, SERVE_BUCKETS)) for k in sizes]
    assert c["traces"] == 0                 # no capture, no build
    assert c["dispatch_by"] == {"fused_chain": c["dispatches"]}
    assert K.LAUNCHES["distances_sq"] == c["dispatches"]


def test_generation_swap_builds_nothing(dev, tmp_path):
    from dislib_tpu_torch.serving import ModelPool, ServePipeline
    from dislib_tpu_torch.utils import profiling as prof
    from dislib_tpu_torch.utils.checkpoint import FitCheckpoint
    dst.init(device=dev)
    x = np.random.RandomState(3).rand(5000, 20).astype(np.float32)
    X = dst.array(x)
    path = str(tmp_path / "km.npz")

    def build(state):
        km = dst.KMeans(n_clusters=6)
        km.centers_ = np.asarray(state["centers"], np.float32)
        return ServePipeline(km, n_features=20)

    pool = ModelPool(FitCheckpoint(path, keep=2), build,
                     buckets=SERVE_BUCKETS, poll_interval_s=0.0)
    dst.KMeans(n_clusters=6, max_iter=2, tol=0.0, random_state=0).fit(
        X, checkpoint=FitCheckpoint(path, every=1))
    assert pool.poll(force=True)
    prof.reset_counters()
    dst.KMeans(n_clusters=6, max_iter=3, tol=0.0, random_state=1).fit(
        X, checkpoint=FitCheckpoint(path, every=1))
    assert pool.poll(force=True)
    c = prof.counters()["trace_by"]
    assert c == {"cuda_graph": len(SERVE_BUCKETS)}      # no nvcc:*
    tok, pipe = pool.current()
    prof.reset_counters()
    got = pipe.predict_bucket(x[:50], 64)
    np.testing.assert_array_equal(
        got, pipe.model.predict(dst.array(x[:50])).collect())
    assert prof.trace_count() == 0
    assert prof.counters()["dispatch_by"] == {"fused_chain": 1}


@pytest.mark.parametrize("kernel,shape", [
    ("distances_sq", (1, 100, 10)), ("distances_sq", (512, 100, 10)),
    ("panel_gemm", (512, 64, 1024))])
def test_kernels_capture_under_the_serving_capture_mode(dev, kernel, shape):
    """Each kernel on the served path in a CUDA graph captured as the
    serving layer captures (a side stream, ``thread_local`` mode): its
    ``cudaFuncSetAttribute`` and (``panel_gemm``) its host-encoded TMA
    descriptors are legal inside the capture, and a replay is bit-equal
    to a launch outside it."""
    m, d, n = shape
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((m, d), generator=g, device=dev)
    b = torch.randn((n, d) if kernel == "distances_sq" else (d, n),
                    generator=g, device=dev)

    def fn():
        return K.distances_sq(a, b) if kernel == "distances_sq" \
            else K.panel_gemm(a, b, px.FLOAT32)

    want = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with K.recording_launches(capturing=True) as rec:
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            out = fn()
    assert rec == {kernel: 1}
    before = K.LAUNCHES[kernel]
    graph.replay()
    K.add_launches(rec)
    torch.cuda.synchronize()
    assert K.LAUNCHES[kernel] == before + 1
    assert torch.equal(out, want)


_BUNDLE_CHILD = r"""
import json, sys, tempfile
import numpy as np
from dislib_tpu_torch import _build
_build.BUILD_DIR = tempfile.mkdtemp()

def _refuse():
    raise AssertionError("build_all called in the loading process")

_build.build_all = _refuse
import dislib_tpu_torch as dst
from dislib_tpu_torch.serving import load_bundle
from dislib_tpu_torch.utils import profiling as prof
dst.init(device="cuda:0")
loaded = load_bundle(sys.argv[1])
rows = np.load(sys.argv[2])
modes = {b: loaded.pipeline.program(b).mode for b in loaded.buckets}
out = {str(b): loaded.pipeline.predict_bucket(rows[:b], b).tolist()
       for b in loaded.buckets}
print(json.dumps({"out": out, "modes": modes,
                  "traces": prof.counters()["trace_by"],
                  "dispatch_by": prof.counters()["dispatch_by"]}))
"""


def test_bundle_loads_in_a_fresh_process_without_a_build(dev, tmp_path):
    """Export a scaler → KMeans pipeline on the card; a child process
    with an empty build directory and ``build_all`` raising installs the
    bundle's kernel libraries, captures every bucket and serves each
    bit-equal to the live pipeline's replay."""
    import json
    import os
    import subprocess
    import sys
    from dislib_tpu_torch import _build
    from dislib_tpu_torch.serving import ServePipeline, export_bundle
    dst.init(device=dev)
    x = np.random.RandomState(4).rand(3000, 20).astype(np.float32)
    X = dst.array(x)
    sc = dst.StandardScaler().fit(X)
    km = dst.KMeans(n_clusters=6, max_iter=3, random_state=0).fit(
        sc.transform(X))
    live = ServePipeline(km, transforms=(sc,))
    want = {b: live.predict_bucket(x[:b], b) for b in SERVE_BUCKETS}
    path = str(tmp_path / "km.npz")
    man = export_bundle(live, path, buckets=SERVE_BUCKETS)
    assert sorted(man["libraries"]) == sorted(_build.SIGNATURES)
    np.save(str(tmp_path / "rows.npy"), x[:max(SERVE_BUCKETS)])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-c", _BUNDLE_CHILD, path,
         str(tmp_path / "rows.npy")], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=repo), timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(got["modes"].values()) == {"graph"}
    assert got["traces"] == {"cuda_graph": len(SERVE_BUCKETS)}   # no nvcc
    assert got["dispatch_by"]["bundle_exec"] == len(SERVE_BUCKETS)
    for b in SERVE_BUCKETS:
        np.testing.assert_array_equal(
            np.asarray(got["out"][str(b)], want[b].dtype), want[b])
