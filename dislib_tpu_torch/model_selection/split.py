"""K-fold splitting.

Counterpart of ``dislib_tpu/model_selection/split.py``: folds are row index
ranges, optionally shuffled by a NumPy ``RandomState`` (the reference's
draw), and each fold is a row gather of the ds-array on its device
(``Array.__getitem__``).
"""

from __future__ import annotations

import numpy as np

from dislib_tpu_torch.base import BaseEstimator
from dislib_tpu_torch.data.array import Array


class KFold(BaseEstimator):
    """K-fold cross-validator over ds-array rows."""

    def __init__(self, n_splits=5, shuffle=False, random_state=None):
        self.n_splits = n_splits
        self.shuffle = shuffle
        self.random_state = random_state

    def get_n_splits(self):
        return self.n_splits

    def split(self, x: Array, y: Array | None = None):
        """Yield (train_x, train_y, test_x, test_y) tuples (y entries None if
        y is None)."""
        n = x.shape[0]
        if self.n_splits < 2 or self.n_splits > n:
            raise ValueError(f"n_splits must be in [2, {n}]")
        idx = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.random_state).shuffle(idx)
        fold_sizes = np.full(self.n_splits, n // self.n_splits, int)
        fold_sizes[: n % self.n_splits] += 1
        start = 0
        for size in fold_sizes:
            test = idx[start:start + size]
            train = np.concatenate([idx[:start], idx[start + size:]])
            start += size
            xt, xv = x[train, :], x[test, :]
            if y is None:
                yield xt, None, xv, None
            else:
                yield xt, y[train, :], xv, y[test, :]
