"""Sparse fold-in serving — padded sparse batches through the
PredictServer bucket ladder.

Counterpart of ``dislib_tpu/serving/sparse.py`` (``pack_sparse_rows``
and ``SparseFoldInPipeline`` with its bundle capture).  A
recommender's request is sparse: a user arrives as a handful of (item,
rating) pairs, and the served computation is the ALS fold-in — solve
the user's normal equations against the FROZEN item factors and score
every item — with no refit and no dense (n_items,) request vector.

**The padded-sparse request encoding.**  One request row is the fixed
width ``[cols | vals]`` — ``nse_cap`` column ids followed by ``nse_cap``
values, pads at (column 0, value 0), all float32.  A sparse batch is then
a plain (k, 2·nse_cap) host matrix, so the dense serving machinery —
:class:`PredictServer` micro-batching, the bucket ladder, hot-swap pools
— applies unchanged: ``nse_cap`` is the pipeline's feature-width analog,
and a padded row is a zero-observation user whose fold-in solves
λI·u = 0 → zero predictions the response slicing drops.  Column ids ride
float32 exactly below 2²⁴ — guarded at construction.

The hot path is one CUDA-graph replay a bucket of
``recommendation.als._als_fold_in_packed`` (split, gather, normal
equations, a batched Cholesky by ``cholesky_ex`` and two triangular
solves, the predict GEMM, and the top-n when ranking), with the item
factors cached on the device per model.
"""

from __future__ import annotations

import numpy as np
import torch

from dislib_tpu_torch.ops import precision as px
from dislib_tpu_torch.parallel import mesh as _mesh
from dislib_tpu_torch.runtime.elastic import fetch as _fetch
from dislib_tpu_torch.serving.pipeline import ProgramHost, declared

__all__ = ["SparseFoldInPipeline", "pack_sparse_rows"]

_COL_ID_CEIL = 1 << 24        # float32 carries integers exactly below this


def _pack_rows(dense: torch.Tensor, nse_cap: int) -> torch.Tensor:
    """``[cols | vals | count]`` rows of a dense (k, n_items) request
    block, on its device: observed columns in ascending order (a top-k
    over the key ``n_items − col``, unobserved slots keyed 0 so they sort
    last), pads (0, 0), and the per-row observed count as one extra
    column, so the host pays one fetch for data and overflow check."""
    n_items = dense.shape[1]
    observed = dense != 0
    col = torch.arange(n_items, dtype=torch.int32,
                       device=dense.device).expand(dense.shape)
    key = torch.where(observed, n_items - col, 0)
    kk = min(int(nse_cap), int(n_items))
    topkey, pos = torch.topk(key, kk, dim=1)
    valid = topkey > 0
    cols = torch.where(valid, pos, 0)
    vals = torch.where(valid, torch.gather(dense, 1, pos), 0.0)
    if kk < int(nse_cap):
        padw = (0, int(nse_cap) - kk)
        cols = torch.nn.functional.pad(cols, padw)
        vals = torch.nn.functional.pad(vals, padw)
    counts = torch.sum(observed, dim=1)
    return torch.cat([cols.to(torch.float32), vals,
                      counts.to(torch.float32)[:, None]], dim=1)


def pack_sparse_rows(rows, nse_cap, n_items=None):
    """Pack per-user sparse ratings into the ``[cols | vals]`` request
    encoding: ``rows`` is a scipy sparse matrix, a list of ``(cols,
    vals)`` pairs, or a dense (k, n_items) ndarray (0 = unobserved).
    Returns the (k, 2·nse_cap) float32 request block a
    :class:`PredictServer` over a :class:`SparseFoldInPipeline`
    accepts.  A user with more than ``nse_cap`` observed ratings is a
    typed error (pick the cap at deployment like a bucket ladder).

    The dense-ndarray path packs on the default mesh's device with one
    fetch; scipy and pair inputs are host metadata and pack in a host
    loop."""
    import scipy.sparse as sp
    if isinstance(rows, np.ndarray):
        dense = np.atleast_2d(np.asarray(rows, np.float32))
        if dense.shape[1] >= _COL_ID_CEIL:
            raise ValueError("item ids ≥ 2^24 don't ride float32 exactly")
        if n_items is not None and dense.shape[1] > n_items:
            bad = np.nonzero((dense[:, n_items:] != 0).any(axis=1))[0]
            if bad.size:
                raise ValueError(
                    f"request row {int(bad[0])}: item ids out of range")
            dense = dense[:, :n_items]
        dev = _mesh.get_mesh().device
        host = _fetch(_pack_rows(torch.from_numpy(
            np.ascontiguousarray(dense)).to(dev), int(nse_cap)))
        counts = host[:, -1].astype(np.int64)
        over = np.nonzero(counts > int(nse_cap))[0]
        if over.size:
            i = int(over[0])
            raise ValueError(
                f"request row {i} has {int(counts[i])} observed ratings > "
                f"nse_cap={nse_cap} — raise the pipeline's cap")
        return np.ascontiguousarray(host[:, :-1])
    if sp.issparse(rows):
        csr = rows.tocsr()
        pairs = [(csr.indices[csr.indptr[i]:csr.indptr[i + 1]],
                  csr.data[csr.indptr[i]:csr.indptr[i + 1]])
                 for i in range(csr.shape[0])]
        if n_items is None:
            n_items = csr.shape[1]
    else:
        pairs = list(rows)
    pairs = [(np.asarray(c), np.asarray(v, np.float32)) for c, v in pairs]
    out = np.zeros((len(pairs), 2 * int(nse_cap)), np.float32)
    for i, (cols, vals) in enumerate(pairs):
        k = cols.size
        if k > nse_cap:
            raise ValueError(
                f"request row {i} has {k} observed ratings > "
                f"nse_cap={nse_cap} — raise the pipeline's cap")
        if k and (cols.min() < 0 or (n_items is not None
                                     and cols.max() >= n_items)):
            raise ValueError(f"request row {i}: item ids out of range")
        if k and cols.max() >= _COL_ID_CEIL:
            raise ValueError("item ids ≥ 2^24 don't ride float32 exactly")
        out[i, :k] = cols                   # ndarray assignment casts
        out[i, nse_cap:nse_cap + k] = vals
    return out


class SparseFoldInPipeline(ProgramHost):
    """A fitted ALS model served as fold-in scoring over padded sparse
    batches — the drop-in ``pipeline=`` for :class:`PredictServer` (the
    ``n_features`` / ``predict_bucket`` surface of ``ServePipeline``, so
    bucket warming, micro-batching and hot-swap pools apply unchanged).

    Parameters
    ----------
    model : fitted :class:`~dislib_tpu_torch.recommendation.ALS` (or any
        model exposing ``items_`` (n_items, f), ``lambda_`` and ``n_f``).
    nse_cap : int — observed ratings capacity per request row; the
        request width is ``2·nse_cap``.
    precision : mixed-precision policy for the fold-in contractions
        (None → the ``DSLIB_MATMUL_PRECISION`` default).
    top_n : int or None — rank inside the same replay and serve
        ``[item_ids | scores]`` rows of width ``2·top_n`` instead of the
        full score matrix.
    """

    _where = "SparseFoldInPipeline"

    def __init__(self, model, nse_cap=64, precision=None, top_n=None):
        if not hasattr(model, "items_"):
            raise ValueError("SparseFoldInPipeline needs a FITTED ALS "
                             "model (missing items_)")
        if model.items_.shape[0] >= _COL_ID_CEIL:
            raise ValueError("item count ≥ 2^24 doesn't ride the float32 "
                             "packed encoding")
        self.model = model
        self.nse_cap = int(nse_cap)
        self.n_features = 2 * self.nse_cap      # the packed request width
        self.policy = px.resolve(precision)
        self.top_n = None if top_n is None else int(top_n)
        self.out_cols = 2 * self.top_n if self.top_n \
            else int(model.items_.shape[0])
        self._init_programs()

    def pack(self, rows):
        """:func:`pack_sparse_rows` at this pipeline's cap."""
        return pack_sparse_rows(rows, self.nse_cap,
                                self.model.items_.shape[0])

    def _steps(self):
        return [(f"{type(self.model).__name__}.fold_in",
                 declared(self.model, "fold_in"))]

    def _objs(self):
        return (self.model,)

    def _chain(self, xin: torch.Tensor, bucket: int) -> torch.Tensor:
        from dislib_tpu_torch.recommendation.als import _als_fold_in_packed
        self._step = "recommendation.als._als_fold_in_packed"
        (items,) = self.model._predict_leaves(xin.device, self.model.items_)
        _, preds = _als_fold_in_packed(xin, items, float(self.model.lambda_),
                                       int(self.model.n_f), self.policy,
                                       top_n=int(self.top_n or 0))
        if self.top_n:
            ids, scores = preds
            return torch.cat([ids.to(torch.float32), scores], dim=1)
        return preds

    def _check(self, rows):
        if rows.shape[1] != self.n_features:
            raise ValueError(
                f"request width {rows.shape[1]} != 2·nse_cap="
                f"{self.n_features} — pack requests with pipeline.pack()")

    # -- deployment-bundle capture ------------------------------------------

    def capture_bucket(self, bucket: int) -> dict:
        """What :func:`~dislib_tpu_torch.serving.bundle.export_bundle`
        stores for ``bucket``, WITHOUT executing the fold-in: the
        ``spec`` (the cap, ``top_n``, the policy, the model's class and
        hyperparameters) and the ``leaves`` — the request canvas (the
        input slot) and the frozen item factors, so the bundle carries the
        model."""
        from dislib_tpu_torch.utils.saving import _encode
        m = self.model
        leaves = [np.zeros((int(bucket), self.n_features), np.float32),
                  np.ascontiguousarray(np.asarray(m.items_, np.float32))]
        spec = {"kind": "sparse_fold_in", "nse_cap": self.nse_cap,
                "top_n": self.top_n, "precision": self.policy.name,
                "model": {"module": type(m).__module__,
                          "cls": type(m).__qualname__,
                          "params": {k: _encode(v) for k, v in
                                     m.get_params().items()}}}
        return {"spec": spec, "leaves": leaves, "input_slot": 0,
                "out_cols": self.out_cols,
                "pshape": [int(bucket), self.n_features]}

    @classmethod
    def _from_capture(cls, spec, leaves):
        """The pipeline a :meth:`capture_bucket` spec describes: the
        model's class with its hyperparameters and the carried item
        factors."""
        from dislib_tpu_torch.utils.saving import _decode, _estimator_class
        mspec = spec["model"]
        model = _estimator_class(mspec)(**{
            k: _decode(v) for k, v in mspec["params"].items()})
        model.items_ = np.array(leaves[1], np.float32)
        return cls(model, nse_cap=spec["nse_cap"],
                   precision=spec["precision"], top_n=spec["top_n"])
