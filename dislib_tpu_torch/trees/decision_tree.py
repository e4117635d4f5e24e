"""Histogram decision trees, grown level by level for a whole forest.

Counterpart of ``dislib_tpu/trees/decision_tree.py``.  The design is the
reference's: a tree of depth D is a heap-shaped array of 2^D − 1 internal
nodes and 2^D leaves, every sample carries its current node id, and each
level is one weighted (node, feature, bin) histogram followed by a
vectorised best-gain search.  Nodes that stop splitting become
pass-through splits (everything goes left), so shapes never change.
Features are cut into per-feature quantile bins once per fit, and the
bootstrap is Poisson(1) sample weights per (tree, sample).

The reference grows every tree of the forest in one ``jax.vmap``-ed
program per level; here the tree is a leading dimension of every tensor,
and one level is one call of :func:`_forest_level`.  Its histogram is the
hand CUDA kernel ``node_histogram`` (``ops/kernels.py``), launched once per
level for the whole forest; CPU tensors take the kernel's plain version.

The bootstrap weights and the per-node feature-sampling scores come from
one ``torch.Generator`` on the data's device, seeded from
``random_state``: the same seed gives the same forest on the same device,
but not the reference's draws (``jax.random`` is another generator).

``fit`` is ``_fit_finalize(_fit_async(x, y))``: the search's async-trial
hooks split it at the adoption, the fit's first host read; ``forest.py``
scores the grown forest on the device (``_score_async``).

Not ported yet: ``fit(checkpoint=..., health=...)``, the per-level
snapshots and rollback of the reference's ``ChunkedFitLoop`` (ROADMAP.md
A.12).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from dislib_tpu_torch.base import BaseEstimator
from dislib_tpu_torch.data.array import Array
from dislib_tpu_torch.data.sparse import dense_input
from dislib_tpu_torch.ops import kernels as _k
from dislib_tpu_torch.runtime import health as _health

# split thresholds are per-feature quantile bin edges, ``n_bins`` per
# feature (constructor parameter, default N_BINS) — the reference's
# discretisation contract
N_BINS = 32
# node arrays are heap-shaped (2^depth), so depth is capped; a finite
# max_depth above the cap warns (_effective_depth)
MAX_DEPTH_CAP = 12
# rows × features × edges that _bin_data compares in one step
_BIN_CHUNK = 1 << 26


# ---------------------------------------------------------------------------
# device functions
# ---------------------------------------------------------------------------

def _quantile_bins(xp: torch.Tensor, shape, n_bins=N_BINS) -> torch.Tensor:
    """Per-feature bin edges from quantiles of the valid rows:
    (n, n_bins-1), in the data's dtype.

    The reference is ``jnp.percentile`` (linear interpolation) inside a
    jitted program, and XLA folds its constants: divisions become
    products with the reciprocal and constant factors are merged, so the
    percentile of edge ``i`` is ``i · (100 · (1 / n_bins))`` and its
    fractional row index that times ``0.01 · (m − 1)``, each constant and
    each product rounded to f32; the interpolation
    ``low·(1 − h) + high·h`` is one fused multiply-add.  This function
    writes those steps out: the index arithmetic in f32 on the host, the
    product ``high·h`` rounded to f32, and the fused add done in f64 and
    rounded once to f32.  A column holding a NaN gets NaN edges, as in the
    reference.  f64 data is interpolated in f64, without the fused
    rounding."""
    m, n = shape
    xv = xp[:m, :n]
    f32 = xv.dtype != torch.float64
    fdt = np.float32 if f32 else np.float64
    i = np.arange(1, n_bins, dtype=fdt)
    qi = (i * fdt(fdt(100) * fdt(fdt(1) / fdt(n_bins)))).astype(fdt) \
        * fdt(fdt(0.01) * (fdt(m) - fdt(1)))
    qi = qi.astype(fdt)
    lo = np.floor(qi)
    hw = (qi - lo).astype(fdt)
    lw = (fdt(1) - hw).astype(fdt)
    dev = xv.device
    lo_i = torch.as_tensor(np.clip(lo, 0, m - 1).astype(np.int64), device=dev)
    hi_i = torch.as_tensor(np.clip(np.ceil(qi), 0, m - 1).astype(np.int64),
                           device=dev)
    xs = torch.sort(xv.to(torch.float32) if f32 else xv, dim=0).values
    lv, hv = xs[lo_i], xs[hi_i]                       # (n_bins-1, n)
    hw_t = torch.as_tensor(hw, device=dev)[:, None]
    lw_t = torch.as_tensor(lw, device=dev)[:, None]
    if f32:
        edges = (lv.double() * lw_t.double()
                 + (hv * hw_t).double()).to(torch.float32)
    else:
        edges = lv * lw_t + hv * hw_t
    edges = torch.where(torch.isnan(xv).any(dim=0)[None, :],
                        torch.full_like(edges, float("nan")), edges)
    return edges.T.contiguous().to(xv.dtype)


def _bin_data(xp: torch.Tensor, shape, edges: torch.Tensor) -> torch.Tensor:
    """Bin index of every (sample, feature): (m_pad, n) int32 in
    [0, n_bins), the count of edges strictly below the value — so a NaN
    lands in bin 0.  The reference broadcasts one (m, n, n_bins − 1)
    comparison; here it runs in row chunks of at most ``_BIN_CHUNK``
    comparisons, which keeps the boolean temporary small at any m."""
    n = shape[1]
    xv = xp[:, :n]
    out = torch.empty(xv.shape, dtype=torch.int32, device=xv.device)
    step = max(1, _BIN_CHUNK // max(1, n * edges.shape[1]))
    for r in range(0, xv.shape[0], step):
        out[r: r + step] = (xv[r: r + step, :, None] > edges[None]).sum(
            dim=2, dtype=torch.int32)
    return out


def _node_histogram(node, bx, w, stats, n_nodes, n_bins,
                    integer=False) -> torch.Tensor:
    """Per-tree, per-sample ``w·stats`` histogrammed into (T, n_nodes, n,
    n_bins, S).  The reference routes between an XLA scatter and its
    Pallas kernel; here CUDA tensors always go to the hand kernel (which
    launches or raises) and CPU tensors to its plain scatter.
    ``integer``: every ``w·stats`` is an integer (the kernel may add in
    any order); otherwise it sums in a fixed order."""
    return _k.node_histogram(node, bx, w, stats, n_nodes, n_bins,
                             integer=integer)


def _scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last dimension in the order of the
    reference's ``jnp.cumsum`` on XLA:CPU, which scans blocks of 16
    sequentially from zero and adds the scanned block totals (recursively
    for more than 16 blocks).  The order is written out because the sums
    of non-integer stats depend on it, and ``torch.cumsum`` takes another
    on the CPU (f64 accumulation) and on the card (a parallel scan): with
    the order fixed, a split that ties exactly between bins or features
    breaks the same way on both devices and in both packages."""
    n = x.shape[-1]
    if n <= 16:
        out = torch.empty_like(x)
        acc = torch.zeros_like(x[..., 0])
        for b in range(n):
            acc = acc + x[..., b]
            out[..., b] = acc
        return out
    nb = -(-n // 16)
    inner = _scan(torch.nn.functional.pad(x, (0, nb * 16 - n))
                  .reshape(*x.shape[:-1], nb, 16))
    outer = _scan(inner[..., -1])
    inner[..., 1:, :] += outer[..., :-1, None]
    return inner.reshape(*x.shape[:-1], nb * 16)[..., :n]


def _sum_last(s: torch.Tensor) -> torch.Tensor:
    """Sum over the last (short) dimension, sequentially from zero — the
    order of an XLA reduction, on either device."""
    acc = torch.zeros_like(s[..., 0])
    for k in range(s.shape[-1]):
        acc = acc + s[..., k]
    return acc


def _gain_and_split(hist: torch.Tensor, criterion: str):
    """Gain of every (node, feature, bin) split from a level histogram
    (..., n_nodes, n, n_bins, S), and the per-node stat totals
    (..., n_nodes, S).  criterion: 'gini' (S = class counts) or 'mse'
    (S = [w, wy, wy²]).  The last bin puts everything left and a split
    with an empty side is no split: both get gain −inf."""
    # stats of bins <= b
    left = _scan(hist.movedim(-2, -1)).movedim(-1, -2)
    total = left[..., -1:, :]
    right = total - left

    def impurity(s):
        if criterion == "gini":
            w = _sum_last(s)
            p = s / torch.clamp_min(w, 1e-12)[..., None]
            return w * (1.0 - _sum_last(p * p))
        w, wy, wy2 = s[..., 0], s[..., 1], s[..., 2]
        return wy2 - wy * wy / torch.clamp_min(w, 1e-12)  # w * variance

    gain = impurity(total) - impurity(left) - impurity(right)
    gain[..., -1] = -torch.inf
    if criterion == "mse":
        wl, wr = left[..., 0], right[..., 0]
    else:
        wl, wr = _sum_last(left), _sum_last(right)
    gain = torch.where((wl > 0) & (wr > 0), gain, -torch.inf)
    return gain, total[..., 0, 0, :]


def _mask_features(gain: torch.Tensor, scores, try_features):
    """Restrict each node's search to a random subset of ``try_features``
    features: those whose uniform ``scores`` (..., n_nodes, n) are among
    the node's top ``try_features``.  The scores are an argument so a
    test can hand in the reference's draws."""
    n = gain.shape[-2]
    if try_features is None or try_features >= n:
        return gain
    kth = torch.topk(scores, try_features, dim=-1).values[..., -1]
    allowed = scores >= kth[..., None]
    return torch.where(allowed[..., None], gain, -torch.inf)


def _forest_level(node, bx, w, stats, scores, n_nodes, try_features,
                  min_gain, criterion, n_bins):
    """Grow one level of every tree.  ``node`` (T, m) int32, ``bx`` (m, n)
    int32 shared by the trees, ``w`` (T, m), ``stats`` (m, S), ``scores``
    (T, n_nodes, n) or None.  Returns ``(feat, tbin, is_split, node,
    totals)``, the first three (T, n_nodes), ``totals`` (T, n_nodes, S).

    ``node`` is updated in place and returned: the reference donates it to
    its level program, which aliases the new assignment onto the old
    buffer, and nothing reads the old assignment afterwards.  The
    reference's per-level health vector is not built: its only reader is
    the checkpointed fit loop (ROADMAP.md A.12); an unchecked fit is
    judged at adoption, here too."""
    T = node.shape[0]
    m, n = bx.shape
    # gini's stats are one-hot classes and w Poisson counts: integers, and
    # every sum below 2^24 at the sizes the forest takes
    hist = _node_histogram(node, bx, w, stats, n_nodes, n_bins,
                           integer=criterion == "gini")
    gain, totals = _gain_and_split(hist, criterion)
    del hist
    gain = _mask_features(gain, scores, try_features)
    flat = gain.reshape(T, n_nodes, -1)
    best = torch.argmax(flat, dim=-1)                 # first of equal gains
    best_gain = torch.take_along_dim(flat, best[..., None], dim=-1)[..., 0]
    del gain, flat
    is_split = best_gain > min_gain
    # pass-through for non-splitting nodes: everything goes left
    feat = torch.where(is_split, best // n_bins, 0).to(torch.int32)
    tbin = torch.where(is_split, best % n_bins, n_bins - 1).to(torch.int32)
    # route samples: right iff bin(x_f) > threshold bin
    nl = node.long()
    f_sel = torch.gather(feat, 1, nl)
    b_sel = torch.gather(tbin, 1, nl)
    rows = torch.arange(m, device=bx.device)[None, :] * n
    x_bin = torch.take(bx, rows + f_sel)
    go_right = (x_bin > b_sel) & torch.gather(is_split, 1, nl)
    node.mul_(2).add_(go_right.to(node.dtype))
    return feat, tbin, is_split, node, totals


def _leaf_stats(node, w, stats, n_leaves):
    """Final-level per-leaf stat sums (T, n_leaves, S) f32, and the health
    vector over them.  The sums run in a fixed order on every device: the
    rows are sorted stably by (tree, leaf) and each stat's column is
    reduced per leaf by ``torch.segment_reduce`` on its own 1-D column (on
    CUDA one thread block per leaf, in a fixed order; on the CPU from zero
    in row order, the reference scatter's), so a regressor's non-integer
    sums give the same bits on every run (an ``index_add_`` adds with
    atomics on CUDA)."""
    T, S = node.shape[0], stats.shape[1]
    dev = node.device
    n_seg = T * n_leaves
    contrib = (w[:, :, None] * stats[None]).to(torch.float32).reshape(-1, S)
    key = (node.to(torch.int32) + torch.arange(
        T, dtype=torch.int32, device=dev)[:, None] * n_leaves).reshape(-1)
    sorted_key, order = torch.sort(key, stable=True)
    lengths = torch.searchsorted(sorted_key, torch.arange(
        n_seg + 1, dtype=torch.int32, device=dev)).diff()
    cols = contrib[order].T.contiguous()              # (S, T·m)
    leaves = torch.stack([torch.segment_reduce(c, "sum", lengths=lengths,
                                               unsafe=True) for c in cols],
                         dim=1).reshape(T, n_leaves, S)
    return leaves, _health.health_vec(carries=(leaves,))


def _pack_levels(levels, depth) -> torch.Tensor:
    """The per-level (T, 2^lvl) splits of a grown forest, zero-padded and
    stacked to (T, depth, 2^(depth-1)) on their device."""
    wide = 2 ** (depth - 1)
    return torch.stack([torch.nn.functional.pad(a, (0, wide - a.shape[1]))
                        for a in levels], dim=1)


def _forest_apply_core(qp, q_shape, edges, feats, tbins, depth):
    """Leaf index of every query row in every tree: (T, mq_pad) int64.
    ``feats``/``tbins`` are the packed (T, depth, 2^(depth-1)) splits."""
    bq = _bin_data(qp, q_shape, edges)                # (mq_pad, n)
    T = feats.shape[0]
    mq, n = bq.shape
    node = torch.zeros((T, mq), dtype=torch.int64, device=bq.device)
    rows = torch.arange(mq, device=bq.device)[None, :] * n
    for lvl in range(depth):
        f = torch.gather(feats[:, lvl], 1, node)
        b = torch.gather(tbins[:, lvl], 1, node)
        x_bin = torch.take(bq, rows + f)
        node = node * 2 + (x_bin > b)
    return node


# ---------------------------------------------------------------------------
# the tree builder shared by the estimators
# ---------------------------------------------------------------------------

class _BaseTreeEnsemble(BaseEstimator):
    """Shared fit/apply machinery; subclasses set ``_criterion``, the stats
    encoding and the predictions."""

    _criterion = "gini"
    _private_fitted_attrs = ("_edges", "_feats", "_tbins", "_depth",
                             "_leaves")

    def _effective_depth(self, m):
        d = self.max_depth
        if d is None or np.isinf(d):
            d = MAX_DEPTH_CAP
        elif d > MAX_DEPTH_CAP:
            warnings.warn(
                f"max_depth={d} exceeds the depth cap {MAX_DEPTH_CAP}: tree "
                "node arrays are heap-shaped (2^depth), so growth is capped "
                f"at {MAX_DEPTH_CAP} levels — unlike the reference's "
                "data-bounded recursion. Deep fine-structure beyond the cap "
                "will not be modelled.", UserWarning, stacklevel=3)
        return int(max(1, min(d, MAX_DEPTH_CAP,
                              int(np.ceil(np.log2(max(m, 2)))))))

    def _n_bins(self):
        nb = getattr(self, "n_bins", None)
        nb = N_BINS if nb is None else int(nb)
        if not 2 <= nb <= 1024:
            raise ValueError(f"n_bins must be in [2, 1024], got {nb}")
        return nb

    def _try_features_count(self, n):
        tf = getattr(self, "try_features", None)
        if tf in (None, "none"):
            return None
        if tf == "sqrt":
            return max(1, int(np.sqrt(n)))
        if tf == "third":
            return max(1, n // 3)
        return max(1, int(tf))

    def _grow_forest(self, x: Array, stats_host, n_trees, bootstrap):
        """Grow the whole forest on x's device, one :func:`_forest_level`
        per level, reading nothing back; :meth:`_adopt_forest` does."""
        m, n = x.shape
        depth = self._effective_depth(m)
        n_bins = self._n_bins()
        try_features = self._try_features_count(n)
        xd = x._data
        dev, mp = xd.device, xd.shape[0]
        edges = _quantile_bins(xd, (m, n), n_bins)
        bx = _bin_data(xd, (m, n), edges)
        stats = torch.as_tensor(np.asarray(stats_host, np.float32),
                                device=dev)
        seed = self.random_state if self.random_state is not None \
            else np.random.randint(0, 2**31 - 1)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        valid = (torch.arange(mp, device=dev) < m).to(torch.float32)
        w = torch.ones((n_trees, mp), dtype=torch.float32, device=dev)
        if bootstrap:
            w = torch.poisson(w, generator=gen)
        w = w * valid[None, :]
        node = torch.zeros((n_trees, mp), dtype=torch.int32, device=dev)
        feats, tbins = [], []
        for lvl in range(depth):
            scores = None
            if try_features is not None and try_features < n:
                scores = torch.rand((n_trees, 2 ** lvl, n), generator=gen,
                                    device=dev)
            feat, tbin, _, node, _ = _forest_level(
                node, bx, w, stats, scores, 2 ** lvl, try_features, 0.0,
                self._criterion, n_bins)
            feats.append(feat)
            tbins.append(tbin)
        leaves, hvec = _leaf_stats(node, w, stats, 2 ** depth)
        return {"edges": edges, "feats": feats, "tbins": tbins,
                "depth": depth, "leaves": leaves, "n_features": n,
                "hvec": hvec}

    def _adopt_forest(self, grown):
        """Set the fitted attributes from a :meth:`_grow_forest` result.
        The per-level (T, 2^lvl) splits pad and stack to (T, depth,
        2^(depth-1)) host arrays.  This is the fit's first host read, so
        the leaves' health vector is judged here: a non-finite forest
        raises ``NumericalDivergence`` instead of serving NaN."""
        h = grown["hvec"].cpu().numpy()
        leaves = grown["leaves"]
        if h[0] > 0:
            first = int(h[_health.HEALTH_BASE_LEN + 1])
            info = {"count": int(h[_health.HEALTH_BASE_LEN]),
                    "first_index": first,
                    "coords": tuple(int(c) for c in np.unravel_index(
                        min(first, leaves.numel() - 1), tuple(leaves.shape)))}
            detail = {"hvec": h.tolist(), "carries": {"leaves": info}}
            raise _health.NumericalDivergence(
                "forest: health guard 'nonfinite' tripped at adoption — the "
                f"grown forest is not numerically usable (detail: {detail})",
                estimator="forest", guard="nonfinite", detail=detail)
        depth = grown["depth"]
        self._edges = grown["edges"]
        self._feats = _pack_levels(grown["feats"], depth).cpu().numpy()
        self._tbins = _pack_levels(grown["tbins"], depth).cpu().numpy()
        self._depth = depth
        self._leaves = leaves                           # (T, 2^depth, S)
        self.n_features_ = grown["n_features"]
        return self

    def fit(self, x: Array, y: Array, checkpoint=None, health=None):
        """Grow the forest on x's device and adopt it."""
        if checkpoint is not None or health is not None:
            raise NotImplementedError(
                f"{type(self).__name__}.fit checkpoint=/health=: the "
                "ChunkedFitLoop is not ported yet (ROADMAP.md A.12)")
        self._fit_finalize(self._fit_async(x, y))
        return self

    # async trial protocol: growth reads nothing back; the handle is the
    # grown-forest dict.  The label / target encoding reads the INPUT y
    # (prep, not fit results) at dispatch time.
    def _fit_async(self, x, y=None):
        if y is None:
            raise ValueError(f"{type(self).__name__} requires y")
        # a SparseArray densifies through its budget-guarded lazy
        # backing, as the reference's x._data does
        x = dense_input(x, type(self).__name__)
        stats = self._encode_stats(x, y)
        n_trees, bootstrap = self._fit_spec()
        return self._grow_forest(x, stats, n_trees, bootstrap)

    def _fit_finalize(self, state):
        if state is not None:
            self._adopt_forest(state)

    def _apply(self, x: Array):
        """Leaf index of every row of x in every tree: (T, m_pad)."""
        edges, feats, tbins = self._predict_leaves(
            x.device, self._edges, self._feats, self._tbins)
        return _forest_apply_core(x._data, x.shape, edges, feats.long(),
                                  tbins, self._depth)

    def _leaf_values(self, grown, x: Array) -> torch.Tensor:
        """Per-tree leaf stats of every row of x under a grown (not yet
        adopted) forest, (T, m_pad, S), on the device."""
        depth = grown["depth"]
        leaf = _forest_apply_core(
            x._data, x.shape, grown["edges"],
            _pack_levels(grown["feats"], depth).long(),
            _pack_levels(grown["tbins"], depth), depth)
        return torch.take_along_dim(grown["leaves"], leaf[:, :, None], dim=1)

    def _carry_in(self, arrays: dict, device):
        """Hold a forest given as NumPy arrays under the reference's
        attribute names (``_edges``, ``_feats``, ``_tbins``, ``_depth``,
        ``_leaves``, ``n_features_`` and, for a classifier, ``classes_``);
        the edges and leaves land on ``device``."""
        # copies: the arrays may be read-only views of another package's
        self._edges = torch.as_tensor(np.array(arrays["_edges"]),
                                      device=device)
        self._feats = np.asarray(arrays["_feats"], np.int32)
        self._tbins = np.asarray(arrays["_tbins"], np.int32)
        self._depth = int(arrays["_depth"])
        self._leaves = torch.as_tensor(np.array(arrays["_leaves"],
                                                np.float32), device=device)
        self.n_features_ = int(arrays["n_features_"])
        if self._criterion == "gini":
            self.classes_ = np.asarray(arrays["classes_"])

    def _check_fitted(self):
        if not hasattr(self, "_leaves"):
            raise RuntimeError(f"{type(self).__name__} is not fitted")
