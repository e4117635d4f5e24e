"""Random forests and single decision trees: the sklearn-style API, label
handling and voting.

Counterpart of ``dislib_tpu/trees/forest.py``; the growth machinery is in
``decision_tree.py``.  The reference builds its predictions as lazy fused
nodes of its array graph; here they run eagerly on the query's device and
the result is wrapped with ``Array._from_padded``.

:func:`~dislib_tpu_torch.base.from_fitted_arrays` (exported here too)
builds a fitted port estimator from a fitted reference forest's arrays
(NumPy only), so both packages can predict with the same forest.  Each
mixin's ``_score_async`` scores a grown forest on the device (accuracy
through the kNN classifier's ``_score_codes``, or R²), for the search.
"""

from __future__ import annotations

import numpy as np
import torch

from dislib_tpu_torch.base import from_fitted_arrays
from dislib_tpu_torch.classification.knn import _score_codes
from dislib_tpu_torch.data.array import Array, _padded_dim, _place_region
from dislib_tpu_torch.data.sparse import dense_input
from dislib_tpu_torch.parallel import mesh as _mesh
from dislib_tpu_torch.trees.decision_tree import _BaseTreeEnsemble


def _cls_enc(counts: torch.Tensor, hard: bool) -> torch.Tensor:
    """Winning class code per query from per-tree leaf counts (T, m, K)."""
    if hard:
        votes = torch.argmax(counts, dim=2)                 # (T, m)
        tally = torch.nn.functional.one_hot(
            votes, counts.shape[2]).sum(dim=0)
        return torch.argmax(tally, dim=1)
    probs = counts / torch.clamp_min(counts.sum(dim=2, keepdim=True), 1e-12)
    return torch.argmax(probs.mean(dim=0), dim=1)


def _reg_mean(stats: torch.Tensor) -> torch.Tensor:
    """Forest-mean prediction from per-tree leaf [w, wy, wy²] stats."""
    return (stats[:, :, 1] / torch.clamp_min(stats[:, :, 0], 1e-12)).mean(
        dim=0)


def _mask_rows(vals: torch.Tensor, m: int) -> torch.Tensor:
    """Zero rows at or past the logical row count: padded rows walk the
    trees too and land in some leaf."""
    if vals.shape[0] > m:
        vals = vals.clone()
        vals[m:] = 0
    return vals


class _ClassifierMixin:
    _criterion = "gini"

    def _encode_labels(self, x: Array, y: Array):
        mp = x._data.shape[0]
        y_host = np.asarray(y.collect()).ravel()
        self.classes_ = np.unique(y_host)
        enc = np.searchsorted(self.classes_, y_host)
        onehot = np.zeros((mp, len(self.classes_)), np.float32)
        onehot[np.arange(len(enc)), enc] = 1.0
        return onehot

    _encode_stats = _encode_labels

    def _votes(self, x: Array) -> torch.Tensor:
        """Per-tree leaf counts of every query row: (T, mq_pad, K)."""
        (leaves,) = self._predict_leaves(x.device, self._leaves)
        leaf = self._apply(x)
        return torch.take_along_dim(leaves, leaf[:, :, None], dim=1)

    def predict_proba(self, x: Array) -> Array:
        self._check_fitted()
        x = dense_input(x, type(self).__name__)
        k = len(self.classes_)
        counts = self._votes(x)
        probs = counts / torch.clamp_min(counts.sum(dim=2, keepdim=True),
                                         1e-12)
        mean = _mask_rows(probs.mean(dim=0), x.shape[0])     # (mq_pad, K)
        out_pshape = (x._pshape[0], _padded_dim(k, _mesh.pad_quantum(
            x._mesh)))
        return Array._from_padded(_place_region(mean, out_pshape),
                                  (x.shape[0], k), x._mesh)

    def predict(self, x: Array) -> Array:
        """Class label per row, (m, 1): int32 for integer classes, else
        float32."""
        self._check_fitted()
        (classes,) = self._predict_leaves(x.device, self._classes_leaf())
        enc = _cls_enc(self._votes(x), bool(getattr(self, "hard_vote",
                                                    False)))
        pred = _mask_rows(classes[enc][:, None], x.shape[0])
        return Array._from_padded(pred.contiguous(), (x.shape[0], 1),
                                  x._mesh)

    def score(self, x: Array, y: Array) -> float:
        """Accuracy."""
        pred = self.predict(x).collect().ravel()
        truth = np.asarray(y.collect()).ravel()
        return float(np.mean(pred == truth))

    def _score_async(self, state, x, y=None):
        if state is None or y is None:
            return super()._score_async(state, x, y)
        enc = _cls_enc(self._leaf_values(state, x),
                       bool(getattr(self, "hard_vote", False)))
        classes_dev = torch.as_tensor(np.asarray(self.classes_),
                                      dtype=y._data.dtype, device=y.device)
        codes = torch.arange(len(self.classes_), dtype=torch.int32,
                             device=y.device)
        return _score_codes(enc.to(torch.int32), y._data, classes_dev, codes,
                            x.shape[0])


class _RegressorMixin:
    _criterion = "mse"

    def _encode_targets(self, x: Array, y: Array):
        mp = x._data.shape[0]
        y_host = np.asarray(y.collect()).ravel().astype(np.float32)
        stats = np.zeros((mp, 3), np.float32)               # [w, wy, wy²]
        stats[: len(y_host), 0] = 1.0
        stats[: len(y_host), 1] = y_host
        stats[: len(y_host), 2] = y_host * y_host
        return stats

    _encode_stats = _encode_targets

    def predict(self, x: Array) -> Array:
        self._check_fitted()
        (leaves,) = self._predict_leaves(x.device, self._leaves)
        stats = torch.take_along_dim(leaves, self._apply(x)[:, :, None],
                                     dim=1)
        pred = _mask_rows(_reg_mean(stats)[:, None], x.shape[0])
        return Array._from_padded(pred.contiguous(), (x.shape[0], 1),
                                  x._mesh)

    def score(self, x: Array, y: Array) -> float:
        """R² (sklearn convention)."""
        pred = self.predict(x).collect().ravel()
        truth = np.asarray(y.collect()).ravel()
        ss_res = float(np.sum((truth - pred) ** 2))
        ss_tot = float(np.sum((truth - truth.mean()) ** 2))
        return 1.0 - ss_res / max(ss_tot, 1e-12)

    def _score_async(self, state, x, y=None):
        """R² of a grown forest, a device scalar."""
        if state is None or y is None:
            return super()._score_async(state, x, y)
        pred = _reg_mean(self._leaf_values(state, x))          # (mq_pad,)
        yv = y._data[: pred.shape[0], 0]
        w = (torch.arange(pred.shape[0], device=pred.device)
             < x.shape[0]).to(yv.dtype)
        resid = torch.sum(((yv - pred) * w) ** 2)
        ymean = torch.sum(yv * w) / x.shape[0]
        total = torch.sum(((yv - ymean) * w) ** 2)
        return 1.0 - resid / torch.clamp_min(total, 1e-12)


class RandomForestClassifier(_ClassifierMixin, _BaseTreeEnsemble):
    """Bootstrap ensemble of histogram decision trees (classification).

    Parameters (reference parity; ``distr_depth``, ``sklearn_max``
    accepted and ignored)
    ----------
    n_estimators : int, default 10
    try_features : 'sqrt' (default), 'third', int, or None (all features)
    max_depth : int or np.inf — clamped to 12 (a finite request above the
        cap warns).
    hard_vote : bool, default False — majority of per-tree votes instead of
        averaged probabilities.
    random_state : int or None
    n_bins : int, default 32 — quantile bin edges per feature.
    """

    def __init__(self, n_estimators=10, try_features="sqrt", max_depth=np.inf,
                 distr_depth="auto", sklearn_max=1e8, hard_vote=False,
                 random_state=None, n_bins=32):
        self.n_estimators = n_estimators
        self.try_features = try_features
        self.max_depth = max_depth
        self.distr_depth = distr_depth
        self.sklearn_max = sklearn_max
        self.hard_vote = hard_vote
        self.random_state = random_state
        self.n_bins = n_bins

    def _fit_spec(self):
        return self.n_estimators, True


class RandomForestRegressor(_RegressorMixin, _BaseTreeEnsemble):
    """Bootstrap ensemble of histogram decision trees (regression).

    Same knobs as :class:`RandomForestClassifier` minus ``hard_vote``.
    """

    def __init__(self, n_estimators=10, try_features="sqrt", max_depth=np.inf,
                 distr_depth="auto", sklearn_max=1e8, random_state=None,
                 n_bins=32):
        self.n_estimators = n_estimators
        self.try_features = try_features
        self.max_depth = max_depth
        self.distr_depth = distr_depth
        self.sklearn_max = sklearn_max
        self.random_state = random_state
        self.n_bins = n_bins

    def _fit_spec(self):
        return self.n_estimators, True


class DecisionTreeClassifier(_ClassifierMixin, _BaseTreeEnsemble):
    """Single histogram decision tree (no bootstrap, all features)."""

    def __init__(self, max_depth=np.inf, try_features=None, random_state=None,
                 n_bins=32):
        self.max_depth = max_depth
        self.try_features = try_features
        self.random_state = random_state
        self.n_bins = n_bins

    def _fit_spec(self):
        return 1, False


class DecisionTreeRegressor(_RegressorMixin, _BaseTreeEnsemble):
    """Single histogram regression tree (no bootstrap, all features)."""

    def __init__(self, max_depth=np.inf, try_features=None, random_state=None,
                 n_bins=32):
        self.max_depth = max_depth
        self.try_features = try_features
        self.random_state = random_state
        self.n_bins = n_bins

    def _fit_spec(self):
        return 1, False


__all__ = ["RandomForestClassifier", "RandomForestRegressor",
           "DecisionTreeClassifier", "DecisionTreeRegressor",
           "from_fitted_arrays"]
