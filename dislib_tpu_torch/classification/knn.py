"""k-nearest-neighbours classifier.

Counterpart of ``dislib_tpu/classification/knn.py``: the neighbour search
is ``neighbors/base._kneighbors_rows`` (the hand kernel ``distances_sq`` on a
card) and the vote a weighted count per class, then the class with the
most weight, the lowest class code on a tie, on the device.
``weights="distance"`` weighs each neighbour by ``1 / max(dist, 1e-10)``.

Where the port departs: the reference maps labels to class codes on the
host, a read of the labels in every fit; the port maps them on the device
(a sort of the labels and a running count of the distinct values) and
reads only ``classes_``, in ``_fit_finalize`` (counted in
``utils/profiling.HOST_READS["results"]``).  So ``_fit_async`` reads
nothing, and a search's trials queue behind each other on the card.  The
class count is not known on the host before that read, so the vote needs
none: each neighbour's class weight is the sum over the neighbours of its
class, the reference's one-hot sum read at that neighbour's code.
``_score_async`` returns the accuracy as a device scalar, which a search
reads only after it has dispatched the next fold; ``predict`` maps the
winning codes back to labels on the host.

A sparse fit set or sparse queries (a ``SparseArray``) go through the
sparse neighbour stream ``neighbors/base._kneighbors_sparse`` and the same
vote, as in the reference: ``_kneighbors_rows`` runs that stream on each
rank's query rows, on one rank on the whole arrays.

Across ranks the fit all-gathers ``y`` once and every rank maps all the
labels to codes, so the vote can read any neighbour's code; the
neighbour search is ``neighbors/base._kneighbors_rows`` on this rank's
query rows (the ring at ``_RING_MIN`` fit rows and more on a mesh of
several rows, else the gathered fit set), the vote is local,
``predict`` returns a row-sharded label array and ``_score_async``'s
hit count is one ``psum`` over 'rows'.  The reads stay as on one rank.
"""

from __future__ import annotations

import numpy as np
import torch

from dislib_tpu_torch.base import BaseEstimator, carried_array
from dislib_tpu_torch.data.array import Array
from dislib_tpu_torch.data.sparse import SparseArray, check_input
from dislib_tpu_torch.neighbors import base as _nb
from dislib_tpu_torch.parallel import distributed as _dist
from dislib_tpu_torch.parallel import mesh as _mesh
from dislib_tpu_torch.utils.profiling import count_read


class KNeighborsClassifier(BaseEstimator):
    """Majority-vote kNN classifier.

    Attributes
    ----------
    classes_ : ndarray of unique labels.
    """

    _private_fitted_attrs = ("_fit_x", "_codes")

    def __init__(self, n_neighbors=5, weights="uniform"):
        self.n_neighbors = n_neighbors
        self.weights = weights

    def fit(self, x: Array, y: Array):
        self._fit_finalize(self._fit_async(x, y))
        return self

    def _check_predict(self, x):
        if not hasattr(self, "_fit_x"):
            raise RuntimeError("KNeighborsClassifier is not fitted")
        if self.weights not in ("uniform", "distance"):
            raise ValueError(f"bad weights {self.weights!r}")
        if self.n_neighbors > self._fit_x.shape[0]:
            raise ValueError(f"n_neighbors {self.n_neighbors} > fitted "
                             f"samples {self._fit_x.shape[0]}")
        check_input(x, "KNeighborsClassifier")

    def _predict_codes(self, x: Array) -> torch.Tensor:
        """Winning class code of each query row this rank holds (every
        padded query row on one rank; the rows of its row block across
        ranks, from global row ``x._at[0]``), int32, 0 on padded rows."""
        dist_k, idx, row0 = _nb._kneighbors_rows(x, self._fit_x,
                                                 self.n_neighbors)
        winner = _vote(dist_k, idx, self._codes, self.weights == "distance")
        winner[max(0, x.shape[0] - row0):] = 0
        return winner

    def predict(self, x: Array) -> Array:
        """Label per row, (m, 1): int32 for integer classes, else
        float32."""
        self._check_predict(x)
        live = max(0, min(_rows_held(x), x.shape[0] - x._at[0]))
        codes = self._predict_codes(x)[:live].cpu().numpy()
        labels = self.classes_[codes]
        dt = np.int32 if np.issubdtype(labels.dtype, np.integer) \
            else np.float32
        return Array._from_rows(
            torch.as_tensor(labels.astype(dt)[:, None], device=x.device),
            (x.shape[0], 1), x._mesh)

    def score(self, x: Array, y: Array) -> float:
        pred = self.predict(x).collect().ravel()
        return float((pred == y.collect().ravel()).mean())

    def _fit_async(self, x, y=None):
        """The fit without a host read: the class codes of ``y`` on its
        device.  Returns the sorted labels and their codes, the state
        ``_fit_finalize`` reads ``classes_`` from."""
        if y is None:
            raise ValueError("KNeighborsClassifier requires y")
        check_input(x, "KNeighborsClassifier")
        if x.shape[0] != y.shape[0]:
            raise ValueError("x and y row counts differ")
        self._fit_x = x
        # every label on every rank: the vote reads any neighbour's code
        yv = y._gathered()[: y.shape[0], : y.shape[1]].reshape(-1)
        self._codes, self._sorted = _label_codes(yv.to(x.device))
        return self._sorted

    def _fit_finalize(self, state):
        """``classes_``, the distinct training labels: the fit's one
        read."""
        count_read("results")
        self.classes_ = np.unique(state[0].cpu().numpy())

    def _score_async(self, state, x, y=None):
        if state is None or y is None:
            return super()._score_async(state, x, y)
        self._check_predict(x)
        # labels compared in y's dtype, as the reference compares classes_
        labels, codes = self._sorted
        yp = y._row_block()
        return _score_codes(self._predict_codes(x), yp, labels.to(yp.dtype),
                            codes, x.shape[0], x._at[0], x._mesh)

    def _carry_in(self, arrays: dict, device):
        # copies: the arrays may be read-only views of another package's
        self._fit_x = carried_array(arrays["_fit_x"], device)
        self._codes = torch.as_tensor(np.array(arrays["_codes"], np.int32),
                                      device=device)
        self.classes_ = np.asarray(arrays["classes_"])
        n = len(self.classes_)
        self._sorted = (torch.as_tensor(np.array(self.classes_),
                                        device=device),
                        torch.arange(n, dtype=torch.int32, device=device))


def _rows_held(x) -> int:
    """The rows of ``x``'s block on this rank (padding included)."""
    return x._m_local if isinstance(x, SparseArray) else x._local.shape[0]


def _label_codes(yv):
    """Class codes (m,) int32 of the labels ``yv`` (m,), the rank of each
    label among the distinct ones (``np.searchsorted(np.unique(y), y)``),
    with no host read; and the sorted labels with their codes."""
    labels, order = torch.sort(yv)
    new = torch.ones(labels.shape, dtype=torch.int32, device=yv.device)
    new[1:] = labels[1:] != labels[:-1]
    sorted_codes = torch.cumsum(new, 0, dtype=torch.int32) - 1
    codes = torch.empty_like(sorted_codes).scatter_(0, order, sorted_codes)
    return codes, (labels, sorted_codes)


def _vote(dist_k, idx, codes, use_dist):
    """Winning class code per row from the (dist, idx) neighbour lists:
    the weight of neighbour j's class is the sum, in float32, of the
    weights (1, or 1/max(dist, 1e-10) for ``use_dist``) of the neighbours
    that share its code; the winner is the heaviest class, the lowest code
    on a tie (the reference's one-hot sum and first maximum)."""
    c = codes[idx.long()]                                   # (rows, k)
    w = (1.0 / torch.clamp_min(dist_k, 1e-10)) if use_dist \
        else torch.ones_like(dist_k)
    same = (c[:, :, None] == c[:, None, :]).to(torch.float32)
    weight = torch.sum(same * w[:, :, None], dim=1)         # (rows, k)
    top = weight == torch.amax(weight, dim=1, keepdim=True)
    return torch.amin(torch.where(top, c, torch.iinfo(torch.int32).max),
                      dim=1).to(torch.int32)


def _codes_of(yv, labels, codes):
    """Map label values into class-code space by the sorted training
    ``labels`` and their ``codes``; the round-trip equality marks labels
    unseen at fit time (they never count as correct)."""
    pos = torch.clamp(torch.searchsorted(labels, yv), 0,
                      labels.shape[0] - 1)
    return codes[pos], labels[pos] == yv


def _hit_count(pred, yp, labels, codes, mq, row0=0, mesh=None):
    """The number of rows, a device int64 scalar, whose predicted class
    code in ``pred`` (rows,) matches the label in ``yp`` (rows, 1); the
    rows start at global row ``row0``, and on a ``mesh`` the hits are
    summed over 'rows'."""
    yv = yp[: pred.shape[0], 0].to(labels.dtype).contiguous()
    yc, seen = _codes_of(yv, labels, codes)
    valid = torch.arange(pred.shape[0], device=pred.device) < mq - row0
    hits = torch.sum((pred == yc) & seen & valid)
    if mesh is not None:
        hits = _dist.psum(hits, _mesh.ROWS, mesh)
    return hits


def _score_codes(pred, yp, labels, codes, mq, row0=0, mesh=None):
    """Accuracy, a device float32 scalar: :func:`_hit_count` over ``mq``."""
    return _hit_count(pred, yp, labels, codes, mq, row0, mesh).to(
        torch.float32) / mq

