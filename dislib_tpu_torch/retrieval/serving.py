"""Retrieval serving — IVF search through the PredictServer bucket
ladder.

Counterpart of ``dislib_tpu/retrieval/serving.py`` (its
``RetrievalPipeline`` with the bundle capture).
:class:`RetrievalPipeline` is the ``pipeline=`` drop-in for
:class:`~dislib_tpu_torch.serving.server.PredictServer`: a request row
is a query embedding (``n_features = index.d``), a response row is
``[ids | scores]`` — the k retrieved catalog ids (float32-encoded, exact
below 2²⁴, guarded at construction) followed by their k distances.
``predict_bucket`` is the dense serving contract: stage into the
bucket's canvas, ONE CUDA-graph replay of the search
(``retrieval.ivf._ivf_topk``: the centroid product — the hand
``panel_gemm`` under ``overlap="kernel"`` — the probe top-k, the chunked
scan and merge, the square root), one fetch, slice.

The overlap schedule is resolved when the pipeline is built
(``overlap=``, else ``DSLIB_OVERLAP``), not per call as in the
reference: a captured graph fixes the route it was captured with.
"""

from __future__ import annotations

import numpy as np
import torch

from dislib_tpu_torch.data.array import _padded_shape
from dislib_tpu_torch.ops import overlap as _ov
from dislib_tpu_torch.ops import precision as px
from dislib_tpu_torch.parallel import mesh as _mesh
from dislib_tpu_torch.retrieval.ivf import IVFIndex, _ivf_topk
from dislib_tpu_torch.serving.pipeline import ProgramHost, declared
from dislib_tpu_torch.utils import profiling as _prof

__all__ = ["RetrievalPipeline"]

_ID_CEIL = 1 << 24          # float32 carries integers exactly below this


class RetrievalPipeline(ProgramHost):
    """A fitted :class:`~dislib_tpu_torch.retrieval.IVFIndex` served as
    ``[ids | scores]`` rows (the ``n_features`` / ``predict_bucket`` /
    ``out_cols`` surface of ``ServePipeline``, so micro-batching, the
    bucket ladder, tenancy, canaries and quotas compose unchanged).

    Parameters
    ----------
    index : fitted :class:`IVFIndex`.
    k : int, default 10 — retrieved candidates per query; the response
        width is ``2·k``.
    nprobe : int or None — lists probed per query (None → the index's
        default).
    precision : policy for the scoring contractions (None → the
        ``DSLIB_MATMUL_PRECISION`` default).
    overlap : the schedule of ``ops/overlap.resolve`` (None →
        ``DSLIB_OVERLAP``); ``"kernel"`` puts the centroid product on
        ``panel_gemm``.

    Unfillable slots carry id −1 and score +inf (``IVFIndex.search``'s
    contract).
    """

    _where = "RetrievalPipeline"

    def __init__(self, index: IVFIndex, k=10, nprobe=None, precision=None,
                 overlap=None):
        index._check_fitted()
        if index.n_items >= _ID_CEIL:
            raise ValueError("catalog ids ≥ 2^24 don't ride the float32 "
                             "[ids|scores] response encoding")
        self.index = index
        self.k = int(k)
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        nprobe = index.nprobe if nprobe is None else int(nprobe)
        self.nprobe = max(1, min(nprobe, index.n_lists_))
        self.policy = px.resolve(precision)
        self.overlap = _ov.resolve(overlap)
        self.n_features = int(index.d)
        self.out_cols = 2 * self.k
        self._init_programs()

    def _pshape(self, bucket: int):
        return _padded_shape((bucket, self.n_features), _mesh.pad_quantum())

    def rebind_mesh(self, mesh):
        """The reference's elastic rebind: delegate the index's
        re-stripe.  A mesh of the index's own shape is accepted (nothing
        to re-lay, returns False); another raises, naming ROADMAP.md
        A.11."""
        return self.index.rebind_mesh(mesh)

    def _steps(self):
        return [(f"{type(self.index).__name__}.search",
                 declared(self.index, "search"))]

    def _objs(self):
        return (self.index,)

    def _chain(self, xin: torch.Tensor, bucket: int) -> torch.Tensor:
        ix = self.index
        self._step = f"retrieval.ivf._ivf_topk (overlap={self.overlap!r})"
        d2, idx = _ivf_topk(
            xin[:, : self.n_features].contiguous(), ix._vecs, ix._ids,
            ix._vsq, ix._offs, ix._cnts, ix._cents_t, ix._c_sq, self.k,
            self.nprobe, ix._cap, self.overlap, self.policy)
        return torch.cat([idx.to(torch.float32), torch.sqrt(d2)], dim=1)

    def _check(self, rows):
        if rows.shape[1] != self.n_features:
            raise ValueError(f"request has {rows.shape[1]} features, the "
                             f"index holds {self.n_features}")

    # -- deployment-bundle capture ------------------------------------------

    def capture_bucket(self, bucket: int) -> dict:
        """What :func:`~dislib_tpu_torch.serving.bundle.export_bundle`
        stores for ``bucket``, WITHOUT executing the search: the
        ``spec`` (``k``, ``nprobe``, the policy, the overlap route, the
        index's class, hyperparameters and geometry) and the ``leaves`` —
        the query canvas (the input slot) and the WHOLE index as served
        (list buffers, ids, norms, offsets, counts, centroids), so the
        loaded index searches bit for bit as this one does."""
        from dislib_tpu_torch.utils.saving import _encode
        ix = self.index
        ix._check_fitted()
        pshape = self._pshape(bucket)
        leaves = [np.zeros(pshape, np.float32)] + [
            b.detach().cpu().numpy() for b in ix._served_buffers()]
        _prof.count_read("bundle")
        spec = {"kind": "retrieval", "k": self.k, "nprobe": self.nprobe,
                "precision": self.policy.name, "overlap": self.overlap,
                "index": {"module": type(ix).__module__,
                          "cls": type(ix).__qualname__,
                          "params": {k: _encode(v) for k, v in
                                     ix.get_params().items()},
                          "cap": int(ix._cap), "n_items": int(ix.n_items)}}
        return {"spec": spec, "leaves": leaves, "input_slot": 0,
                "out_cols": self.out_cols, "pshape": list(pshape)}

    @classmethod
    def _from_capture(cls, spec, leaves):
        """The pipeline a :meth:`capture_bucket` spec describes, its index
        adopting the carried buffers on the default mesh's device."""
        from dislib_tpu_torch.utils.saving import _decode, _estimator_class
        ispec = spec["index"]
        index = _estimator_class(ispec)(**{
            k: _decode(v) for k, v in ispec["params"].items()})
        index._adopt_served(leaves[1:], ispec["cap"], ispec["n_items"])
        return cls(index, k=spec["k"], nprobe=spec["nprobe"],
                   precision=spec["precision"], overlap=spec["overlap"])

    def predict_bucket(self, rows, bucket: int):
        """Serve one query batch: stage, ONE replay of the search, one
        fetch, slice — the dense ``ServePipeline.predict_bucket``
        contract."""
        self.index._check_fitted()
        _prof.count_schedule("ivf_search", self.overlap)
        return super().predict_bucket(rows, bucket)
