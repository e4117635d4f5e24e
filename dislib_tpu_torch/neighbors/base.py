"""Nearest neighbours.

Counterpart of ``dislib_tpu/neighbors/base.py``.  The all-pairs
block product is the distance ‖q‖² − 2q·xᵀ + ‖x‖² and the k-best merge a
top-k.  A fit set of at most 2·``_CHUNK`` rows takes the direct path (one
(mq, mf) distance block); a larger one streams in fitted-row chunks of
``_CHUNK`` rows with a running top-k (the chunk's k smallest merged with
the carried k), so peak memory is O(mq·(k + chunk)), never O(mq·mf).
Each chunk is a row slice of the fit set, made contiguous once per call,
and every distance block is ``ops/base.distances_sq(..., use_kernel=True)``:
on a card the hand kernel ``distances_sq``, on CPU tensors its plain
version.  Ties go to the lower fit index, as the reference's
``lax.top_k`` merges give (``ops/base.merge_smallest``).  Padded fit rows
(none on one card) are never neighbours; padded query rows return 0.

``ring``: the reference takes the ring schedule of ``ops/ring.py`` only on
a mesh of more than one row (``ring_kneighbors`` is not inner-tiled; with
one row it would materialise the whole (mq, mf) block).  The port's mesh
has one row until ROADMAP.md A.2, so every setting takes the path above;
``ring=True`` says so in a warning.  The ring stays reachable by a direct
call.

Sparse fit sets and queries (the reference's ``_kneighbors_sparse`` and
``_stream_topk``) never densify a whole matrix: the fit set streams as
dense (``chunk``, n) windows, ``chunk`` = ``min(_CHUNK, mf)``.  A sparse
fit set's windows come from its ``row_steps`` (steps bounded by rows and
by entries), each densified by one scatter of distinct positions, with
its row norms as a fixed-order segment sum; a dense fit set is sliced
into the same row windows.  The cross term is one GEMM with TF32 off for
dense queries (outside any kernel, as in the reference) and
``ops/spmm.spmm_rows`` against the window's transpose for sparse
queries.  The running merge is ``ops/base.merge_smallest``, ties to the
lower index.  The reference's ``shard_map`` variants exist only for a
mesh of more than one row (ROADMAP.md A.2); on one rank a sharded-backed
query takes the same stream.
"""

from __future__ import annotations

import warnings

import torch

from dislib_tpu_torch.base import BaseEstimator, carried_array
from dislib_tpu_torch.data.array import Array
from dislib_tpu_torch.data.sparse import SparseArray, check_input
from dislib_tpu_torch.ops.base import distances_sq, merge_smallest, \
    precise, split_keys
from dislib_tpu_torch.ops.spmm import seg_sum, spmm_rows

# fitted-row chunk of the streaming path; fit sets up to 2×_CHUNK rows
# take the direct path (module-level so tests can shrink it)
_CHUNK = 4096


class NearestNeighbors(BaseEstimator):
    """Exact brute-force kNN index over a ds-array.

    ``ring``: the reference's ring switch; on the port's one-row mesh no
    setting takes the ring schedule (``ring=True`` warns).
    """

    _private_fitted_attrs = ("_fit_data",)

    def __init__(self, n_neighbors=5, ring=None):
        self.n_neighbors = n_neighbors
        self.ring = ring

    def fit(self, x: Array, y=None):
        check_input(x, "NearestNeighbors")
        self._fit_data = x
        return self

    def kneighbors(self, x: Array, n_neighbors=None, return_distance=True):
        """Distances (mq, k) float32 and indices (mq, k) int32 ds-arrays of
        the k nearest fitted rows of each query row, nearest first."""
        if not hasattr(self, "_fit_data"):
            raise RuntimeError("NearestNeighbors is not fitted")
        k = self.n_neighbors if n_neighbors is None else n_neighbors
        f = self._fit_data
        if not 1 <= k <= f.shape[0]:
            raise ValueError(f"n_neighbors {k} not in [1, {f.shape[0]}]")
        check_input(x, "NearestNeighbors.kneighbors")
        if self.ring:
            warnings.warn("NearestNeighbors(ring=True): the ring schedule "
                          "needs a mesh of more than one row (ROADMAP.md "
                          "A.2); the chunked path runs", UserWarning,
                          stacklevel=2)
        if isinstance(f, SparseArray) or isinstance(x, SparseArray):
            d, idx = _kneighbors_sparse(x, f, k)
        else:
            d, idx = _kneighbors(x._data, f._data, x.shape, f.shape, k,
                                 chunk=_CHUNK)
        shape = (x.shape[0], k)
        i_arr = Array._from_padded(idx, shape, x._mesh)
        if return_distance:
            return Array._from_padded(d, shape, x._mesh), i_arr
        return i_arr

    def _carry_in(self, arrays: dict, device):
        self._fit_data = carried_array(arrays["_fit_data"], device)


def _finish(d2, idx, mq):
    """Distances ``sqrt(max(d², 0))``; 0 and index 0 on padded query
    rows."""
    dist = torch.sqrt(torch.clamp_min(d2, 0.0))
    if dist.shape[0] > mq:
        dist[mq:] = 0.0
        idx[mq:] = 0
    return dist, idx


@precise
def _kneighbors(qp, fp, q_shape, f_shape, k, chunk=None):
    """(distances (mq_pad, k) float32, indices (mq_pad, k) int32) of the
    ``k`` nearest of the first ``f_shape[0]`` rows of ``fp`` for each row
    of ``qp``: one distance block when the fit set has at most ``2·chunk``
    rows, else a running top-k over chunks of ``chunk`` rows in index
    order."""
    mq, d = q_shape
    mf = f_shape[0]
    chunk = _CHUNK if chunk is None else chunk
    qv = qp[:, :d].contiguous()
    fv = fp[:mf, :d].contiguous()
    step = mf if mf <= 2 * chunk else chunk
    best = None
    for off in range(0, mf, step):
        best = merge_smallest(best, distances_sq(qv, fv[off: off + step],
                                                 use_kernel=True), k, off)
    return _finish(*split_keys(best), mq)


def _fit_windows(f, chunk):
    """The fit set as dense (``chunk``, n) row windows in index order:
    yields ``(row_off, rows_in, window (rows_in, n), row norms
    (rows_in,))``.  A ``SparseArray`` streams its ``row_steps`` (duplicate
    entries summed first), each step's entries scattered onto a zero
    window, its padding slots onto a sink column that is cut off; a dense
    ds-array is sliced."""
    n = f.shape[1]
    if isinstance(f, SparseArray):
        f = f._distinct()
        plan, _ = f.row_step_plan(chunk)
        data, lrows, cols = f.row_steps(chunk)[:3]
        row_nnz = torch.from_numpy(f._row_nnz()).to(f.device)
        for i, (ro, rc, nlo, nhi) in enumerate(plan):
            live = nhi - nlo
            c = cols[i].to(torch.int64)
            c[live:] = n                            # padding → the sink
            win = torch.zeros((rc, n + 1), dtype=data.dtype,
                              device=data.device)
            win[lrows[i].to(torch.int64), c] = data[i]
            v = data[i, :live]
            yield ro, rc, win[:, :n], seg_sum(v * v, row_nnz[ro:ro + rc])
        return
    fv = f._data[: f.shape[0], :n]
    for ro in range(0, f.shape[0], chunk):
        win = fv[ro: ro + chunk]
        yield ro, win.shape[0], win, torch.sum(win * win, dim=1)


@precise
def _kneighbors_sparse(x, f, k):
    """(distances (mq, k) float32, indices (mq, k) int32) of the ``k``
    nearest rows of ``f`` for each row of ``x``, one or both a
    ``SparseArray``: a running top-k over the fit set's windows
    (:func:`_fit_windows`), whose cross term against the queries is one
    GEMM (dense queries) or one SpMM (sparse queries)."""
    mq = x.shape[0]
    chunk = min(_CHUNK, max(1, f.shape[0]))
    if isinstance(x, SparseArray):
        q = x._distinct()
        q_sq = q.row_norms_sq()

        def cross(win):
            return spmm_rows(q._row_len, q._cols, q._vals,
                             win.T.contiguous())
    else:
        qv = x._data[:mq, : x.shape[1]]
        q_sq = torch.sum(qv * qv, dim=1)

        def cross(win):
            return qv @ win.T
    best = None
    for ro, rc, win, f_sq in _fit_windows(f, chunk):
        if rc == 0:
            continue
        d2 = torch.clamp_min(q_sq[:, None] - 2.0 * cross(win)
                             + f_sq[None, :], 0.0)
        best = merge_smallest(best, d2, k, ro)
    return _finish(*split_keys(best), mq)
