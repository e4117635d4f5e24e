"""Global shuffle and train/test split.

Counterpart of ``dislib_tpu/utils/base.py`` on one rank: the permutation
is the reference's host ``RandomState`` draw, and the data movement is one
row gather on the device per output (``Array.__getitem__``).  A
``SparseArray`` permutes through its row indexing and stays sparse, as in
the reference.  The reference's multi-rank exchange (one ``all_to_all``
over the mesh 'rows' axis) waits for the multi-GPU mesh, ROADMAP.md
A.2/A.11.
"""

from __future__ import annotations

import numpy as np

from dislib_tpu_torch.data.array import Array


def _check_input(x, who):
    # imported here: data/sparse imports this package (utils.profiling)
    from dislib_tpu_torch.data.sparse import check_input
    check_input(x, who)


def shuffle(x: Array, y: Array | None = None, random_state=None):
    """Randomly permute rows of ``x`` (and ``y`` with the same
    permutation)."""
    _check_input(x, "shuffle")
    rng = random_state if isinstance(random_state, np.random.RandomState) \
        else np.random.RandomState(random_state)
    perm = rng.permutation(x.shape[0])
    if y is None:
        return x[perm, :]
    if y.shape[0] != x.shape[0]:
        raise ValueError("x and y must have the same number of rows")
    return x[perm, :], y[perm, :]


def train_test_split(x: Array, y: Array | None = None, test_size: float = 0.25,
                     train_size: float | None = None, random_state=None):
    """Split rows into train/test ds-arrays (sklearn-style convenience):
    rows ``perm[:n_train]`` and ``perm[n_train:n_train + n_test]`` of one
    ``RandomState(random_state).permutation``."""
    _check_input(x, "train_test_split")
    n = x.shape[0]
    n_test = int(round(n * test_size))
    n_train = n - n_test if train_size is None else int(round(n * train_size))
    perm = np.random.RandomState(random_state).permutation(n)
    train, test = perm[:n_train], perm[n_train:n_train + n_test]
    if y is None:
        return x[train, :], x[test, :]
    if y.shape[0] != n:
        raise ValueError("x and y must have the same number of rows")
    return x[train, :], x[test, :], y[train, :], y[test, :]
