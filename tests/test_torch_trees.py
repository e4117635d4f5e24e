"""The port's forest against the reference's, on CPU.

The same numpy inputs go through ``dislib_tpu`` (8 virtual CPU devices) and
``dislib_tpu_torch`` on the CPU, where ``node_histogram`` runs its plain
version.  The reference's Pallas histogram runs in interpret mode, as its
own tests run it.

Tolerances, and why:

- histograms of integer contributions (Poisson weights × counts): bit-equal
  — every partial sum is an integer below 2^24, exact in any order;
- quantile edges and bins: bit-equal — the port writes out the reference's
  folded f32 index arithmetic and its fused interpolation;
- classification trees (splits, leaves, predictions): bit-equal, as they
  are built from exact histograms;
- regression: totals and leaves at rtol 1e-5 — sums of non-integer
  ``y`` and ``y²`` in another order; splits equal on this data, whose best
  gains are not near ties;
- carried-across forests: ``predict`` and ``score`` equal, ``predict_proba``
  at 1e-6 (a mean of per-tree ratios, whose division may be rounded
  differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dislib_tpu as ds
from dislib_tpu.ops import pallas_kernels as ref_pk
from dislib_tpu.trees import decision_tree as ref_dt
from dislib_tpu.trees import (DecisionTreeClassifier as RefDTC,
                              DecisionTreeRegressor as RefDTR,
                              RandomForestClassifier as RefRFC,
                              RandomForestRegressor as RefRFR)

import dislib_tpu_torch as dst
from dislib_tpu_torch.ops import kernels as port_k
from dislib_tpu_torch.parallel import mesh as port_mesh
from dislib_tpu_torch.runtime.health import NumericalDivergence
from dislib_tpu_torch.trees import decision_tree as port_dt
from dislib_tpu_torch.trees import (DecisionTreeClassifier,
                                    DecisionTreeRegressor,
                                    RandomForestClassifier,
                                    RandomForestRegressor, from_fitted_arrays)

_ARRAYS = ("_edges", "_feats", "_tbins", "_depth", "_leaves", "n_features_")


@pytest.fixture(autouse=True)
def _port_on_cpu():
    dst.init(device="cpu")
    port_k.reset_launches()
    yield
    assert port_k.LAUNCHES["node_histogram"] == 0


def _class_data(seed, m=300, n=6, k=3):
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, n) * 3
    lab = rng.randint(0, k, m)
    x = centers[lab] + rng.randn(m, n) * 0.9
    return x.astype(np.float32), lab.astype(np.float32)


def _reg_data(seed, m=300, n=5):
    rng = np.random.RandomState(seed)
    x = rng.rand(m, n).astype(np.float32) * 4
    y = (np.sin(x[:, 0]) * 3 + x[:, 1] ** 2 - 2 * x[:, 2]).astype(np.float32)
    return x, y


def _hist_inputs(rng, T, m, n, n_nodes, n_bins, s, dtype=np.float32):
    node = rng.randint(0, n_nodes, (T, m)).astype(np.int32)
    bx = rng.randint(0, n_bins, (m, n)).astype(np.int32)
    w = rng.poisson(1.0, (T, m)).astype(dtype)
    stats = rng.randint(0, 3, (m, s)).astype(dtype)
    return node, bx, w, stats


def _port_hist(node, bx, w, stats, n_nodes, n_bins):
    return port_k.node_histogram(
        torch.from_numpy(node), torch.from_numpy(bx), torch.from_numpy(w),
        torch.from_numpy(stats), n_nodes, n_bins).numpy()


# -- node_histogram -------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 3, 2, 4, 2), (128, 5, 4, 8, 3),
                                   (200, 2, 8, 32, 1)], ids=str)
def test_node_histogram_bit_equal_to_reference(shape):
    if not ref_pk.hist_available():
        pytest.skip("the reference's pallas histogram kernel is unavailable")
    m, n, n_nodes, n_bins, s = shape
    T = 3
    node, bx, w, stats = _hist_inputs(np.random.RandomState(7), T, m, n,
                                      n_nodes, n_bins, s)
    got = _port_hist(node, bx, w, stats, n_nodes, n_bins)
    assert got.shape == (T, n_nodes, n, n_bins, s)
    assert got.dtype == np.float32
    for t in range(T):
        pallas = np.asarray(ref_pk.node_histogram(
            jnp.asarray(node[t]), jnp.asarray(bx),
            jnp.asarray(w[t][:, None] * stats), n_nodes, n_bins))
        scatter = np.asarray(ref_dt._node_histogram(
            jnp.asarray(node[t]), jnp.asarray(bx), jnp.asarray(w[t]),
            jnp.asarray(stats), n_nodes, n_bins, hist="xla"))
        np.testing.assert_array_equal(got[t], pallas)
        np.testing.assert_array_equal(got[t], scatter)


def test_node_histogram_bit_equal_f64_x64_mode():
    if not ref_pk.hist_available():
        pytest.skip("the reference's pallas histogram kernel is unavailable")
    node, bx, w, stats = _hist_inputs(np.random.RandomState(8), 2, 96, 3, 4,
                                      8, 2, dtype=np.float64)
    got = _port_hist(node, bx, w, stats, 4, 8)
    assert got.dtype == np.float64
    with jax.enable_x64(True):
        for t in range(2):
            # the Pallas kernel keeps f64; the reference's forest router
            # casts its result to the f32 compute dtype (same values here)
            pallas = np.asarray(ref_pk.node_histogram(
                jnp.asarray(node[t]), jnp.asarray(bx),
                jnp.asarray(w[t][:, None] * stats), 4, 8))
            assert pallas.dtype == np.float64
            np.testing.assert_array_equal(got[t], pallas)
            scatter = np.asarray(ref_dt._node_histogram(
                jnp.asarray(node[t]), jnp.asarray(bx), jnp.asarray(w[t]),
                jnp.asarray(stats), 4, 8, hist="xla"))
            np.testing.assert_array_equal(got[t], scatter.astype(np.float64))


def test_node_histogram_non_integer_stats():
    # regression stats: sums of non-integers, whose order may differ from
    # the reference's scatter — rtol 1e-5
    rng = np.random.RandomState(9)
    node, bx, w, _ = _hist_inputs(rng, 2, 150, 4, 4, 8, 3)
    stats = rng.standard_normal((150, 3)).astype(np.float32)
    got = _port_hist(node, bx, w, stats, 4, 8)
    for t in range(2):
        ref = np.asarray(ref_dt._node_histogram(
            jnp.asarray(node[t]), jnp.asarray(bx), jnp.asarray(w[t]),
            jnp.asarray(stats), 4, 8, hist="xla"))
        np.testing.assert_allclose(got[t], ref, rtol=1e-5, atol=1e-5)


def _emulate_partition(node, w, stats, n_nodes, plan):
    """The CUDA partition in numpy: per-(node, chunk) counts, their
    node-major exclusive scan, and the stable scatter in which warp v of a
    chunk owns rows [v·rows_per_warp, (v+1)·rows_per_warp) and places them
    after the chunk's slot for the node and the earlier warps' rows.
    Returns (idx (T, m) with −1 past each tree's kept rows, node_start
    (T, n_nodes + 1))."""
    T, m = node.shape
    rpw = plan.rows_per_warp
    chunk = port_k._PART_WARPS * rpw
    contrib = w[:, :, None] * stats[None]                     # f32
    key = np.where((node >= 0) & (node < n_nodes)
                   & (contrib != 0).any(axis=2), node, -1)
    counts = np.zeros((T, n_nodes, plan.n_pchunks), np.int64)
    for t in range(T):
        for c in range(plan.n_pchunks):
            k = key[t, c * chunk:(c + 1) * chunk]
            counts[t, :, c] = np.bincount(k[k >= 0], minlength=n_nodes)
    flat = counts.reshape(T, -1)
    offs = (np.cumsum(flat, axis=1) - flat).reshape(counts.shape)
    node_start = np.concatenate([offs[:, :, 0], flat.sum(1)[:, None]], 1)
    idx = np.full((T, m), -1, np.int64)
    for t in range(T):
        for c in range(plan.n_pchunks):
            cursor = offs[t, :, c].copy()
            for v in range(port_k._PART_WARPS):      # warps in row order
                for i in range(c * chunk + v * rpw,
                               min(m, c * chunk + (v + 1) * rpw)):
                    if key[t, i] >= 0:
                        idx[t, cursor[key[t, i]]] = i
                        cursor[key[t, i]] += 1
    return idx, node_start


def _emulate_histogram(bx, w, stats, idx, node_start, n_nodes, n_bins,
                       plan, fixed_order=False):
    """The CUDA histogram items in numpy, from the partition's output: each
    (node, row chunk, feature group, slice) adds its rows into
    [copy][slot][entry][lane] and stores (a node of one item, zeros for no
    rows) or adds its non-zero entries to the output that the partition
    zeroed (a node of several items).  Every other entry stays NaN.

    ``fixed_order``: a node of several items stores each row chunk's sums
    in its own partial slot, ``split_start[p] + chunk`` (the scan of the
    chunk counts of split nodes), and the reduce adds the slots from zero
    in chunk order, in float32.  Returns ``(out, slots used per tree)``."""
    T = idx.shape[0]
    n, S = bx.shape[1], stats.shape[1]
    E = n_bins * S
    copies = port_k._HIST_WARPS if plan.private else 1
    out = np.full((T, n_nodes, n, E), np.nan, np.float32)
    slots = port_k.hist_partial_slots(idx.shape[1], plan)
    partial = np.full((T, slots, n, E), np.nan, np.float32)
    used = np.zeros(T, np.int64)
    for t in range(T):
        for p in range(n_nodes):
            ns, ne = node_start[t, p], node_start[t, p + 1]
            n_items = max(1, -(-(ne - ns) // plan.rows_per_item))
            first = used[t]
            if n_items > 1 and fixed_order:
                used[t] += n_items
                assert used[t] <= slots
            elif n_items > 1:
                out[t, p] = 0
            for ch in range(n_items):
                rs = ns + ch * plan.rows_per_item
                re = min(ne, rs + plan.rows_per_item)
                for fg in range(plan.n_fgroups):
                    f0 = fg * plan.fgs
                    nf = min(plan.fgs, n - f0)
                    f = np.arange(nf)
                    slot, lane = f // 32, f % 32
                    assert slot.max() < plan.J
                    for sl in range(plan.n_slices):
                        e0 = sl * plan.slice_len
                        el = min(plan.slice_len, E - e0)
                        hist = np.zeros((copies, plan.J, plan.slice_len, 32),
                                        np.float32)
                        for r in range(rs, re):
                            i = idx[t, r]
                            cp = ((r - rs) // 32) % port_k._HIST_WARPS \
                                if plan.private else 0
                            b = bx[i, f0:f0 + nf]
                            for s in range(S):
                                c = np.float32(w[t, i] * stats[i, s])
                                if c == 0:
                                    continue
                                e = b * S + s - e0
                                ok = (b >= 0) & (b < n_bins) & (e >= 0) \
                                    & (e < el)
                                np.add.at(hist[cp], (slot[ok], e[ok],
                                                     lane[ok]), c)
                        v = np.zeros((nf, el), np.float32)
                        for cp in range(copies):       # copies in warp order
                            v += hist[cp][slot, :el, lane]
                        dst = out[t, p, f0:f0 + nf, e0:e0 + el]
                        if n_items == 1:
                            dst[...] = v
                        elif fixed_order:
                            partial[t, first + ch, f0:f0 + nf,
                                    e0:e0 + el] = v
                        else:
                            dst += np.where(v != 0, v, np.float32(0))
            if n_items > 1 and fixed_order:
                acc = np.zeros((n, E), np.float32)
                for ch in range(n_items):              # chunk order
                    acc += partial[t, first + ch]
                out[t, p] = acc
    return out.reshape(T, n_nodes, n, n_bins, S), used


def _small_plan(monkeypatch, shape, smem, private_rows=1 << 30,
                part_rows=(4, 8), item_rows=16, n_sms=4):
    """``hist_plan`` at a small shape, with the thresholds shrunk so that
    chunks, items, groups, slices and private copies all occur."""
    T, m, n, n_nodes, n_bins, S = shape
    monkeypatch.setattr(port_k, "_HIST_PRIVATE_ROWS", private_rows)
    monkeypatch.setattr(port_k, "_PART_MIN_ROWS", part_rows[0])
    monkeypatch.setattr(port_k, "_PART_MAX_ROWS", part_rows[1])
    monkeypatch.setattr(port_k, "_HIST_MIN_ITEM_ROWS", item_rows)
    plan = port_k.hist_plan(T, m, n, n_nodes, n_bins, S, n_sms=n_sms,
                            smem_bytes=smem)
    assert port_k.hist_smem_bytes(plan) - port_k._HIST_TILE_BYTES <= smem
    assert plan.J <= 4 and plan.fgs <= 32 * plan.J
    assert plan.n_fgroups * plan.fgs >= n
    assert plan.n_slices * plan.slice_len >= n_bins * S
    assert plan.slice_len % 4 == 0
    assert plan.n_pchunks * port_k._PART_WARPS * plan.rows_per_warp >= m
    return plan


def _layout(kind, rng, T, m, n_nodes):
    """Node assignments of the emulator cases."""
    if kind == "one-node":
        return np.full((T, m), n_nodes // 2 + 1, np.int32)
    if kind == "half-empty":
        return (2 * rng.randint(0, n_nodes // 2, (T, m))).astype(np.int32)
    if kind == "out-of-range":
        return rng.randint(-1, n_nodes + 2, (T, m)).astype(np.int32)
    return rng.randint(0, n_nodes, (T, m)).astype(np.int32)


@pytest.mark.parametrize("kind,shape", [
    ("random", (3, 300, 4, 8, 4, 2)),
    ("one-node", (2, 211, 3, 16, 4, 2)),
    ("half-empty", (2, 257, 3, 16, 4, 1)),
    ("out-of-range", (3, 190, 2, 4, 4, 2)),
    ("nan-on-zero-weight", (2, 150, 2, 4, 4, 3))], ids=str)
def test_partition_is_a_stable_sort_by_node(kind, shape, monkeypatch):
    T, m, n, n_nodes, n_bins, S = shape
    rng = np.random.RandomState(11)
    node, bx, w, stats = _hist_inputs(rng, T, m, n, n_nodes, n_bins, S)
    node = _layout(kind, rng, T, m, n_nodes)
    if kind == "nan-on-zero-weight":
        w[:, 7] = 0
        stats[7, 1] = np.nan            # 0·NaN is NaN: kept
        stats[9] = 0                    # every product ±0: dropped
    plan = _small_plan(monkeypatch, shape, 1 << 16)
    assert plan.n_pchunks > 1
    idx, node_start = _emulate_partition(node, w, stats, n_nodes, plan)
    contrib = w[:, :, None] * stats[None]
    for t in range(T):
        key = np.where((node[t] >= 0) & (node[t] < n_nodes)
                       & (contrib[t] != 0).any(axis=1), node[t], n_nodes)
        order = np.argsort(key, kind="stable")
        kept = int((key < n_nodes).sum())
        np.testing.assert_array_equal(idx[t, :kept], order[:kept])
        assert (idx[t, kept:] == -1).all()
        np.testing.assert_array_equal(
            node_start[t], np.concatenate([[0], np.cumsum(np.bincount(
                key[key < n_nodes], minlength=n_nodes))]))
    if kind == "nan-on-zero-weight":
        assert 7 in idx[0] and 9 not in idx[0]
    if kind == "out-of-range":
        assert not np.isin(np.flatnonzero(node[0] < 0), idx[0]).any()


@pytest.mark.parametrize("kind,shape,smem,private", [
    ("one-node", (2, 400, 5, 16, 8, 2), 1 << 16, False),     # deep, 1 node
    ("half-empty", (2, 300, 4, 8, 8, 2), 1 << 16, False),
    ("out-of-range", (2, 250, 3, 4, 4, 2), 1 << 16, False),
    ("random", (1, 120, 70, 2, 4, 2), 3 * 32 * 8 * 4, False),  # groups
    ("random", (1, 60, 3, 2, 1024, 5), 32 * 1024, False),      # slices
    ("nan-on-zero-weight", (2, 200, 3, 4, 8, 2), 1 << 16, False),
    ("random", (2, 300, 40, 2, 4, 2), 1 << 16, True),          # private
], ids=["one-node", "half-empty", "node-minus-1", "feature-groups",
        "sliced-features", "nan-on-zero-weight", "private-copies"])
def test_histogram_items_bit_equal_to_plain(kind, shape, smem, private,
                                            monkeypatch):
    T, m, n, n_nodes, n_bins, S = shape
    rng = np.random.RandomState(12)
    node, bx, w, stats = _hist_inputs(rng, T, m, n, n_nodes, n_bins, S)
    node = _layout(kind, rng, T, m, n_nodes)
    if kind == "nan-on-zero-weight":
        w[:, 5] = 0
        stats[5, 0] = np.nan
    plan = _small_plan(monkeypatch, shape, smem,
                       private_rows=1 if private else 1 << 30)
    assert bool(plan.private) == private
    if kind == "feature-groups":
        assert plan.n_fgroups > 1
    if kind == "sliced-features":
        assert plan.n_slices > 1
    idx, node_start = _emulate_partition(node, w, stats, n_nodes, plan)
    got, _ = _emulate_histogram(bx, w, stats, idx, node_start, n_nodes,
                                n_bins, plan)
    want = _port_hist(node, bx, w, stats, n_nodes, n_bins)
    np.testing.assert_array_equal(got, want)
    if kind == "one-node":                # split into items that add
        assert node_start[0, -1] > 2 * plan.rows_per_item
    if kind == "nan-on-zero-weight":
        assert np.isnan(want).any()


@pytest.mark.parametrize("kind,shape,smem", [
    ("one-node", (2, 400, 5, 16, 8, 3), 1 << 16),        # split nodes
    ("random", (2, 300, 40, 2, 4, 3), 1 << 16),          # 40 features
    ("random", (1, 200, 70, 2, 8, 3), 8 * 3 * 32 * 4 * 4),  # narrow slices
    ("half-empty", (2, 300, 4, 8, 8, 3), 1 << 16)],
    ids=["one-node", "random", "narrow-slices", "half-empty"])
def test_fixed_order_items_match_plain(kind, shape, smem, monkeypatch):
    # the regressor's path: non-integer w·stats summed in a fixed order
    # (a copy per warp, split nodes through partial slots added in chunk
    # order) — within f32 rounding of the plain version's row-order sums,
    # every slot written, and no more slots than hist_partial_slots
    T, m, n, n_nodes, n_bins, S = shape
    rng = np.random.RandomState(13)
    node, bx, w, _ = _hist_inputs(rng, T, m, n, n_nodes, n_bins, S)
    node = _layout(kind, rng, T, m, n_nodes)
    stats = rng.standard_normal((m, S)).astype(np.float32)
    monkeypatch.setattr(port_k, "_PART_MIN_ROWS", 4)
    monkeypatch.setattr(port_k, "_PART_MAX_ROWS", 8)
    monkeypatch.setattr(port_k, "_HIST_MIN_ITEM_ROWS", 16)
    monkeypatch.setattr(port_k, "_HIST_PRIVATE_ROWS", 64)
    plan = port_k.hist_plan(T, m, n, n_nodes, n_bins, S, n_sms=4,
                            smem_bytes=smem, fixed_order=True)
    assert plan.private == 1
    # eight copies: feature groups first, then narrower slices where eight
    # copies of one feature's entries do not fit
    one = port_k.hist_plan(T, m, n, n_nodes, n_bins, S, n_sms=4,
                           smem_bytes=smem, private=False)
    if kind == "narrow-slices":
        assert plan.J == 1 and plan.n_fgroups > one.n_fgroups
        assert plan.n_slices > one.n_slices
    idx, node_start = _emulate_partition(node, w, stats, n_nodes, plan)
    got, used = _emulate_histogram(bx, w, stats, idx, node_start, n_nodes,
                                   n_bins, plan, fixed_order=True)
    if kind == "one-node":
        assert used.min() > 1
    assert not np.isnan(got).any()
    exact = _port_hist(node, bx, w.astype(np.float64),
                       stats.astype(np.float64), n_nodes, n_bins)
    scale = _port_hist(node, bx, w, np.abs(stats), n_nodes, n_bins)
    assert (np.abs(got - exact) <= 1e-5 * scale + 1e-30).all()


def test_fixed_order_plan_at_the_regressors_shapes():
    # 8 trees, 1M x 100, 32 bins, S 3 ([w, wy, wy²]): eight copies of the
    # whole 96-entry histogram, in four groups of 25 features
    plan = port_k.hist_plan(8, 1_000_000, 100, 1, 32, 3, n_sms=132,
                            fixed_order=True)
    assert (plan.private, plan.J, plan.n_fgroups, plan.n_slices) == \
        (1, 1, 4, 1)
    assert port_k.hist_smem_bytes(plan) <= 227 * 1024
    assert port_k.hist_partial_slots(1_000_000, plan) * plan.rows_per_item \
        >= 2 * 1_000_000
    with pytest.raises(ValueError, match="copy per warp"):
        port_k.hist_plan(8, 1000, 10, 1, 32, 3, n_sms=132, private=False,
                         fixed_order=True)


def test_plain_histogram_float_sums_are_fixed_order():
    # C.7: the plain version's float path is a stable sort by cell and a
    # segment_reduce, so on 4 CPU threads two calls give the same bits,
    # bit-equal to a sequential row-order f32 sum per cell, within 1e-5 of
    # float64 np.add.at; dropped rows (node -1 or past the last) add nothing
    rng = np.random.RandomState(15)
    T, m, n, n_nodes, n_bins, S = 2, 1000, 4, 4, 8, 3
    node = rng.randint(-1, n_nodes + 1, (T, m)).astype(np.int32)
    bx = rng.randint(0, n_bins, (m, n)).astype(np.int32)
    w = rng.poisson(1.0, (T, m)).astype(np.float32)
    stats = rng.standard_normal((m, S)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (node, bx, w, stats)]
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        first = port_k.node_histogram_plain(*args, n_nodes, n_bins)
        second = port_k.node_histogram_plain(*args, n_nodes, n_bins)
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(first, second)
    seq = np.zeros((T, n_nodes, n, n_bins, S), np.float32)
    exact = np.zeros(seq.shape)
    for t in range(T):
        kept = (node[t] >= 0) & (node[t] < n_nodes)
        c = w[t][:, None] * stats
        for i in np.flatnonzero(kept):
            for f in range(n):
                seq[t, node[t, i], f, bx[i, f]] += c[i]
            np.add.at(exact[t], (node[t, i], np.arange(n), bx[i]),
                      c[i].astype(np.float64))
    np.testing.assert_array_equal(first.numpy(), seq)
    np.testing.assert_allclose(first.numpy(), exact, rtol=0, atol=1e-5)
    # the integer declaration keeps the scatter, bit-equal for integers
    ints = [args[0], args[1], args[2], torch.round(args[3] * 2)]
    assert torch.equal(
        port_k.node_histogram_plain(*ints, n_nodes, n_bins, integer=True),
        port_k.node_histogram_plain(*ints, n_nodes, n_bins))


def test_leaf_stats_sum_in_row_order():
    # the stable sort + segmented sum adds each leaf's contributions from
    # zero in row order: bit-equal to a sequential row-order scatter, with
    # empty leaves 0
    rng = np.random.RandomState(14)
    T, m, n_leaves, S = 3, 500, 16, 3
    node = rng.randint(0, n_leaves // 2, (T, m)).astype(np.int32) * 2
    w = rng.poisson(1.0, (T, m)).astype(np.float32)
    stats = rng.standard_normal((m, S)).astype(np.float32)
    leaves, hvec = port_dt._leaf_stats(torch.from_numpy(node),
                                       torch.from_numpy(w),
                                       torch.from_numpy(stats), n_leaves)
    want = np.zeros((T, n_leaves, S), np.float32)
    for t in range(T):
        for i in range(m):
            want[t, node[t, i]] += np.float32(w[t, i] * stats[i])
    np.testing.assert_array_equal(leaves.numpy(), want)
    assert (leaves.numpy()[:, 1::2] == 0).all()
    assert float(hvec[0]) == 0.0


@pytest.mark.parametrize("shape", [
    (16, 1_000_000, 100, 2048, 32, 2),   # the main path's deepest level
    (16, 1_000_000, 100, 1, 32, 2),      # its first level
    (1, 100_000, 20, 2048, 1024, 5),     # n_bins 1024, S 5
    (1, 7, 3, 1, 2, 1)], ids=str)
def test_hist_plan_at_the_estimators_shapes(shape):
    T, m, n, n_nodes, n_bins, S = shape
    plan = port_k.hist_plan(T, m, n, n_nodes, n_bins, S, n_sms=132)
    assert port_k.hist_smem_bytes(plan) <= port_k.HIST_SMEM_BYTES \
        + port_k._HIST_TILE_BYTES <= 227 * 1024
    assert plan.n_slices * plan.slice_len >= n_bins * S
    assert (plan.n_slices - 1) * plan.slice_len < n_bins * S
    assert plan.n_fgroups * plan.fgs >= n and plan.fgs <= 32 * plan.J
    assert plan.n_pchunks * port_k._PART_WARPS * plan.rows_per_warp >= m
    assert (plan.n_pchunks - 1) * port_k._PART_WARPS * plan.rows_per_warp < m
    # the partition's per-warp counters fit beside nothing else
    assert port_k._PART_WARPS * n_nodes * 4 <= 227 * 1024


# -- binning -------------------------------------------------------------------

@pytest.mark.parametrize("m,n,n_bins", [(1001, 6, 32), (300, 5, 33),
                                        (97, 3, 8), (5000, 4, 1024),
                                        (64, 2, 2), (300, 6, 7),
                                        (1000, 4, 9)], ids=str)
def test_quantile_bins_and_bin_data_bit_equal(m, n, n_bins):
    rng = np.random.RandomState(m)
    x = (rng.standard_normal((m, n)) * rng.rand(n) * 10).astype(np.float32)
    x[::7, 0] = x[3, 0]                   # ties, and rows on an edge
    if n > 2:
        x[5, 2] = np.nan                  # a NaN column: NaN edges, bin 0
    ref_edges = np.asarray(ref_dt._quantile_bins(jnp.asarray(x), (m, n),
                                                 n_bins))
    ref_bx = np.asarray(ref_dt._bin_data(jnp.asarray(x), (m, n),
                                         jnp.asarray(ref_edges)))
    tx = torch.from_numpy(x)
    edges = port_dt._quantile_bins(tx, (m, n), n_bins)
    bx = port_dt._bin_data(tx, (m, n), edges)
    assert edges.shape == (n, n_bins - 1) and edges.dtype == torch.float32
    np.testing.assert_array_equal(edges.numpy(), ref_edges)
    assert bx.dtype == torch.int32
    np.testing.assert_array_equal(bx.numpy(), ref_bx)
    # the binning of edges the reference computed, chunked
    small = port_dt._BIN_CHUNK
    try:
        port_dt._BIN_CHUNK = 3 * n * (n_bins - 1)
        np.testing.assert_array_equal(
            port_dt._bin_data(tx, (m, n), torch.from_numpy(ref_edges.copy()))
            .numpy(), ref_bx)
    finally:
        port_dt._BIN_CHUNK = small


# -- one level of the forest ---------------------------------------------------

@pytest.mark.parametrize("criterion", ["gini", "mse"])
def test_forest_level_matches_reference(criterion):
    rng = np.random.RandomState(11)
    T, m, n, n_nodes, n_bins, tf = 3, 240, 6, 4, 8, 3
    x = rng.standard_normal((m, n)).astype(np.float32)
    bx = np.asarray(ref_dt._bin_data(
        jnp.asarray(x), (m, n),
        ref_dt._quantile_bins(jnp.asarray(x), (m, n), n_bins)))
    node = rng.randint(0, n_nodes, (T, m)).astype(np.int32)
    w = rng.poisson(1.0, (T, m)).astype(np.float32)
    if criterion == "gini":
        lab = rng.randint(0, 3, m)
        stats = np.eye(3, dtype=np.float32)[lab]
    else:
        y = (x[:, 0] * 2 + np.sin(x[:, 1])).astype(np.float32)
        stats = np.stack([np.ones(m, np.float32), y, y * y], 1)
    keys = jax.random.split(jax.random.PRNGKey(5), T)
    scores = np.stack([np.asarray(jax.random.uniform(k, (n_nodes, n)))
                       for k in keys])
    ref = ref_dt._forest_level(
        jnp.asarray(node), jnp.asarray(bx), jnp.asarray(w),
        jnp.asarray(stats), keys, n_nodes, tf, 0.0, criterion, n_bins)
    ref_feat, ref_tbin, ref_split, ref_node, ref_tot = \
        (np.asarray(a) for a in ref[:5])
    tnode = torch.from_numpy(node.copy())
    feat, tbin, is_split, new_node, tot = port_dt._forest_level(
        tnode, torch.from_numpy(bx), torch.from_numpy(w),
        torch.from_numpy(stats), torch.from_numpy(scores), n_nodes, tf,
        0.0, criterion, n_bins)
    assert new_node is tnode                # updated in place
    np.testing.assert_array_equal(feat.numpy(), ref_feat)
    np.testing.assert_array_equal(tbin.numpy(), ref_tbin)
    np.testing.assert_array_equal(is_split.numpy(), ref_split)
    np.testing.assert_array_equal(new_node.numpy(), ref_node)
    if criterion == "gini":
        np.testing.assert_array_equal(tot.numpy(), ref_tot)
    else:
        np.testing.assert_allclose(tot.numpy(), ref_tot, rtol=1e-5)


# -- whole estimators ----------------------------------------------------------

def _fit_both(ref_cls, port_cls, x, y, **kw):
    ref = ref_cls(**kw).fit(ds.array(x), ds.array(y[:, None]))
    port = port_cls(**kw).fit(dst.array(x), dst.array(y[:, None]))
    return ref, port


@pytest.mark.parametrize("seed,n_bins,depth",
                         [(0, 32, np.inf), (1, 7, 4)], ids=str)
def test_decision_tree_classifier_matches_reference(seed, n_bins, depth):
    x, y = _class_data(seed)
    ref, port = _fit_both(RefDTC, DecisionTreeClassifier, x, y,
                          n_bins=n_bins, max_depth=depth)
    assert port._depth == ref._depth
    np.testing.assert_array_equal(np.asarray(port._edges),
                                  np.asarray(ref._edges))
    np.testing.assert_array_equal(port._feats, ref._feats)
    np.testing.assert_array_equal(port._tbins, ref._tbins)
    np.testing.assert_array_equal(port._leaves.numpy(),
                                  np.asarray(ref._leaves))
    np.testing.assert_array_equal(port.classes_, ref.classes_)
    np.testing.assert_array_equal(
        port.predict(dst.array(x)).collect(), ref.predict(ds.array(x))
        .collect())


def test_decision_tree_regressor_matches_reference():
    x, y = _reg_data(2)
    ref, port = _fit_both(RefDTR, DecisionTreeRegressor, x, y, max_depth=5)
    np.testing.assert_array_equal(port._feats, ref._feats)
    np.testing.assert_array_equal(port._tbins, ref._tbins)
    np.testing.assert_allclose(port._leaves.numpy(), np.asarray(ref._leaves),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        port.predict(dst.array(x)).collect(),
        ref.predict(ds.array(x)).collect(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["soft", "hard", "regressor"])
def test_carried_forest_predicts_like_reference(kind):
    if kind == "regressor":
        x, y = _reg_data(3)
        ref = RefRFR(n_estimators=5, random_state=0, max_depth=6)
        cls, params = RandomForestRegressor, {}
    else:
        x, y = _class_data(4, k=3)
        ref = RefRFC(n_estimators=5, random_state=0,
                     hard_vote=kind == "hard")
        cls, params = RandomForestClassifier, {"hard_vote": kind == "hard"}
    ref.fit(ds.array(x), ds.array(y[:, None]))
    names = _ARRAYS + (("classes_",) if kind != "regressor" else ())
    arrays = {k: np.asarray(getattr(ref, k)) for k in names}
    port = from_fitted_arrays(cls, arrays, device="cpu", **params)
    assert type(port) is cls and port.get_params()["random_state"] is None
    q = np.random.RandomState(5).permutation(x)[:97]   # a ragged query
    X, Q = (dst.array(x), dst.array(q))
    rX, rQ = (ds.array(x), ds.array(q))
    want = ref.predict(rQ).collect()
    got = port.predict(Q).collect()
    assert got.dtype == want.dtype and got.shape == (97, 1)
    if kind == "regressor":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        assert port.score(X, dst.array(y[:, None])) == pytest.approx(
            ref.score(rX, ds.array(y[:, None])), abs=1e-6)
        return
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(port.predict_proba(Q).collect(),
                               ref.predict_proba(rQ).collect(), atol=1e-6)
    assert port.score(X, dst.array(y[:, None])) == \
        ref.score(rX, ds.array(y[:, None]))


def test_forest_fit_is_seeded_and_predicts_well():
    x, y = _class_data(6, m=400)
    X, Y = dst.array(x), dst.array(y[:, None])
    a = RandomForestClassifier(n_estimators=6, random_state=3).fit(X, Y)
    b = RandomForestClassifier(n_estimators=6, random_state=3).fit(X, Y)
    c = RandomForestClassifier(n_estimators=6, random_state=4).fit(X, Y)
    np.testing.assert_array_equal(a._feats, b._feats)
    np.testing.assert_array_equal(a._leaves.numpy(), b._leaves.numpy())
    assert not np.array_equal(a._leaves.numpy(), c._leaves.numpy())
    assert a.score(X, Y) >= 0.95
    proba = a.predict_proba(X).collect()
    assert proba.shape == (400, 3)
    np.testing.assert_allclose(proba.sum(1), 1.0, rtol=1e-6)
    # the forest's trees are the trees it walks: the leaf counts of every
    # tree sum to that tree's bootstrap weight
    assert (a._leaves.sum(dim=(1, 2)) > 0).all()


# -- what the port refuses ------------------------------------------------------

def test_fit_checkpoint_and_health_are_not_ported(tmp_path):
    # they are ported now: a checked growth is the unchecked one
    from dislib_tpu_torch.runtime import HealthPolicy
    from dislib_tpu_torch.utils.checkpoint import FitCheckpoint
    x, y = _class_data(7, m=60)
    plain = RandomForestClassifier(n_estimators=2, random_state=1).fit(
        dst.array(x), dst.array(y[:, None]))
    ck = RandomForestClassifier(n_estimators=2, random_state=1).fit(
        dst.array(x), dst.array(y[:, None]),
        checkpoint=FitCheckpoint(str(tmp_path / "rf.npz"), every=2),
        health=HealthPolicy())
    np.testing.assert_array_equal(ck._feats, plain._feats)
    assert ck.fit_info_["chunks"] == plain.fit_info_["chunks"]


def test_non_finite_forest_is_refused_at_adoption():
    x, y = _reg_data(8, m=80)
    y[3] = np.nan
    with pytest.raises(NumericalDivergence) as err:
        DecisionTreeRegressor(max_depth=3).fit(dst.array(x),
                                               dst.array(y[:, None]))
    assert err.value.estimator == "forest"
    assert err.value.guard == "nonfinite"
    assert err.value.detail["carries"]["leaves"]["count"] >= 1


def test_default_device_is_cuda_and_never_silently_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(port_mesh, "_default_mesh", None)
    x, y = _class_data(9, m=40)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RandomForestClassifier(n_estimators=2).fit(dst.array(x),
                                                   dst.array(y[:, None]))
    arrays = {"_edges": np.zeros((6, 31), np.float32),
              "_feats": np.zeros((1, 1, 1), np.int32),
              "_tbins": np.zeros((1, 1, 1), np.int32), "_depth": 1,
              "_leaves": np.zeros((1, 2, 3), np.float32), "n_features_": 6,
              "classes_": np.arange(3.0)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_fitted_arrays(RandomForestClassifier, arrays)
