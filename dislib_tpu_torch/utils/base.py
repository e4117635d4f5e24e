"""Global shuffle and train/test split.

Counterpart of ``dislib_tpu/utils/base.py``.  The permutation is the
reference's host ``RandomState`` draw.  On one rank the data movement is
one row gather on the device per output (``Array.__getitem__``); a
``SparseArray`` permutes through its row indexing and stays sparse, as in
the reference.  On a mesh of several ranks it is the reference's
exchange: the routing plan (``data/array._routing``, the reference's
``_routing``) is made on the host, and ONE ``all_to_all`` over 'rows'
moves the rows (``data/array._gather_rows``); ``y`` reuses ``x``'s plan.
A ``SparseArray`` moves its entries by one ``all_to_all`` of its own
(``SparseArray._gather_rows``).
The rows are copied, never computed, so the result is bit-equal to the
NumPy permutation.
"""

from __future__ import annotations

import numpy as np

from dislib_tpu_torch.data.array import Array, _gather_rows
from dislib_tpu_torch.parallel import distributed as _dist


def _check_input(x, who):
    # imported here: data/sparse imports this package (utils.profiling)
    from dislib_tpu_torch.data.sparse import check_input
    check_input(x, who)


def _take(x, y, idx):
    """``(x[idx], y[idx])`` (``y`` may be None); across ranks one exchange
    plan serves both."""
    if x._mesh.world == 1:
        return x[idx, :], None if y is None else y[idx, :]
    if y is not None and y._mesh != x._mesh:
        raise ValueError("x and y live on different meshes")
    if not isinstance(x, Array):          # a SparseArray: its entries move
        return x[idx], None if y is None else _gather_rows(y, idx)[0]
    xs, plan = _gather_rows(x, idx)
    if y is None:
        return xs, None
    return xs, _gather_rows(y, idx, plan)[0]


def shuffle(x: Array, y: Array | None = None, random_state=None):
    """Randomly permute rows of ``x`` (and ``y`` with the same
    permutation)."""
    _check_input(x, "shuffle")
    rng = random_state if isinstance(random_state, np.random.RandomState) \
        else np.random.RandomState(_dist.agreed_seed(random_state, x._mesh))
    perm = rng.permutation(x.shape[0])
    if y is not None and y.shape[0] != x.shape[0]:
        raise ValueError("x and y must have the same number of rows")
    xs, ys = _take(x, y, perm)
    return xs if y is None else (xs, ys)


def train_test_split(x: Array, y: Array | None = None, test_size: float = 0.25,
                     train_size: float | None = None, random_state=None):
    """Split rows into train/test ds-arrays (sklearn-style convenience):
    rows ``perm[:n_train]`` and ``perm[n_train:n_train + n_test]`` of one
    ``RandomState(random_state).permutation``."""
    _check_input(x, "train_test_split")
    n = x.shape[0]
    n_test = int(round(n * test_size))
    n_train = n - n_test if train_size is None else int(round(n * train_size))
    perm = np.random.RandomState(_dist.agreed_seed(
        random_state, x._mesh)).permutation(n)
    train, test = perm[:n_train], perm[n_train:n_train + n_test]
    if y is not None and y.shape[0] != n:
        raise ValueError("x and y must have the same number of rows")
    x_tr, y_tr = _take(x, y, train)
    x_te, y_te = _take(x, y, test)
    if y is None:
        return x_tr, x_te
    return x_tr, x_te, y_tr, y_te
