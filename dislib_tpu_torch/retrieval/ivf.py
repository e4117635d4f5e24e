"""IVF approximate nearest-neighbour index on one card.

Counterpart of ``dislib_tpu/retrieval/ivf.py``.  ``fit`` clusters the
catalog with the port's :class:`~dislib_tpu_torch.cluster.KMeans` (its
E-step is the hand kernel ``distances_sq``), then lays the inverted lists
out on the host as the reference's ``_build`` does, with one shard
(p = 1): the catalog rows ordered by (list, row id), each list padded to
a multiple of the list quantum (``list_quantum``, else
``DSLIB_IVF_LIST_QUANTUM``, else 8) with pad slots of id −1, zero vector
and zero norm.  ``pad_waste`` measures what the padding costs.

``search`` is the reference's ``_ivf_topk`` at one rank:

- (a) the centroid distances ‖q‖² − 2q·cᵀ + ‖c‖², the cross term on the
  hand kernel ``panel_gemm`` (FLOAT32) under ``overlap="kernel"`` (or its
  alias ``pallas``, the reference's ``overlap == "pallas"`` branch) and
  ``ops/precision.pdot`` under ``db``/``seq``, as in ``ops/ring.py``;
- (b) the ``nprobe`` nearest lists of each query by ``torch.topk``;
- (c) the probed lists scanned in chunks of ``pc`` probes
  (``pc·cap ≤`` :data:`PROBE_BLOCK` slots, cap the longest padded list):
  each chunk gathers the probed lists' entries, scores them with one
  batched product ``qd,qcd->qc`` through ``ops/precision.peinsum``, masks
  the dead slots (``slot < count`` and ``id ≥ 0``, else +∞ and id −1) and
  merges the chunk into the running top-k (``ops/base.merge_keyed``
  over the gathered ids: ties go to the lower catalog id).  The scan
  runs in blocks of query rows whose gathered (rows, pc·cap, d) panel
  holds at most :data:`PANEL_BYTES` (at 4,096 queries, lists of ~1,000
  rows and d = 64, one chunk of every query would gather ~1 GB);
- (d) ``sqrt`` of the clamped d².  Slots the probed lists cannot fill
  carry +∞ and id −1.

On one rank the reference's ring over striped shards
(``ops/overlap.panel_pipeline``) has one step, so the scan runs once over
the one shard and ``db`` and ``seq`` are the same computation; the
striped shards and their ring hop over NCCL are ROADMAP.md A.2.  Where
the port departs: a d² below 0 (cancellation) ranks as 0, as in
``ops/ring.py``, and the lists and the merge keys are float32 (the
reference keeps a float64 catalog in float64).

``fit(checkpoint=, health=)`` hands both to the quantizer's KMeans fit
loop.  ``retrieval/serving.RetrievalPipeline`` serves the search as one
CUDA-graph replay a batch.  Not ported: ``rebind_mesh`` onto any mesh
but (1, 1) (ROADMAP.md A.2).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from dislib_tpu_torch.base import BaseEstimator
from dislib_tpu_torch.data.array import Array, array as _mk_array
from dislib_tpu_torch.ops import kernels as _k
from dislib_tpu_torch.ops import overlap as _ov
from dislib_tpu_torch.ops import precision as px
from dislib_tpu_torch.ops.base import _keys, merge_keyed, precise, \
    split_keys
from dislib_tpu_torch.parallel import mesh as _mesh

__all__ = ["IVFIndex"]

_DEFAULT_LIST_QUANTUM = 8

#: list slots gathered per probe chunk, as in the reference
PROBE_BLOCK = 1024

#: bytes of the gathered (query rows, pc·cap, d) panel of one probe chunk
#: (module-level so tests can shrink it)
PANEL_BYTES = 1 << 30


def _list_quantum(explicit=None) -> int:
    """The list pad quantum: ``explicit`` wins, else
    ``DSLIB_IVF_LIST_QUANTUM``, else 8."""
    q = int(explicit) if explicit is not None else int(
        os.environ.get("DSLIB_IVF_LIST_QUANTUM", str(_DEFAULT_LIST_QUANTUM)))
    if q < 1:
        raise ValueError(f"list quantum must be >= 1, got {q}")
    return q


class IVFIndex(BaseEstimator):
    """Inverted-file ANN index over a catalog of item vectors.

    Parameters
    ----------
    n_lists : int or None — inverted-list count (the KMeans cluster
        count); None → ``round(sqrt(n_items))`` at fit time.
    nprobe : int, default 8 — lists scanned per query (``search`` takes
        a per-call override).
    list_quantum : int or None — the list pad quantum; None →
        ``DSLIB_IVF_LIST_QUANTUM`` (default 8).
    kmeans_max_iter, random_state, verbose — passed to the quantizer's
        :class:`~dislib_tpu_torch.cluster.KMeans`.

    Attributes
    ----------
    quantizer_ : the fitted KMeans (None when built through ``_build``).
    n_lists_, n_items, d : the fitted geometry.
    pad_waste : dict — logical ``entries``, ``buffer_rows``, the quantum
        pad (``list_pad_entries``) and the shard-balance pad
        (``balance_pad_rows``, 0 on one shard), ``waste_frac``, the scan
        width ``cap``, ``quantum`` and ``per_shard_entries``.
    """

    # the host layout inputs: load_model rebuilds the lists from them
    _private_fitted_attrs = ("_items_h", "_labels_h", "_centers_h")

    # the served search (retrieval/serving.py: ``_ivf_topk`` on a staged
    # query batch) has no host read; ``search`` itself wraps its results
    _capturable = frozenset({"search"})

    def __init__(self, n_lists=None, nprobe=8, list_quantum=None,
                 kmeans_max_iter=10, random_state=None, verbose=False):
        self.n_lists = None if n_lists is None else int(n_lists)
        self.nprobe = int(nprobe)
        self.list_quantum = None if list_quantum is None \
            else int(list_quantum)
        self.kmeans_max_iter = int(kmeans_max_iter)
        self.random_state = random_state
        self.verbose = verbose
        self.quantizer_ = None

    # -- build ---------------------------------------------------------------

    def fit(self, items, y=None, checkpoint=None, health=None):
        """Build the index: the KMeans quantizer on the catalog's device
        (its fit loop takes ``checkpoint=``/``health=``, as any KMeans
        fit), one labels pass, then the host layout of the lists."""
        from dislib_tpu_torch.cluster import KMeans
        arr = items if isinstance(items, Array) \
            else _mk_array(np.atleast_2d(np.asarray(items, np.float32)))
        if arr._mesh.world > 1:
            raise NotImplementedError(
                "IVFIndex over a catalog sharded across ranks: the lists "
                "striped over the row shards are ROADMAP.md A.2c")
        n = arr.shape[0]
        if n < 1:
            raise ValueError("cannot index an empty catalog")
        nlist = self.n_lists if self.n_lists is not None \
            else max(1, int(round(math.sqrt(n))))
        nlist = min(int(nlist), n)
        km = KMeans(n_clusters=nlist, max_iter=self.kmeans_max_iter,
                    random_state=self.random_state, verbose=self.verbose)
        km.fit(arr, checkpoint=checkpoint, health=health)
        labels = km.predict(arr).collect().ravel()
        self._build(arr.collect(), labels, km.centers_, device=arr.device)
        self.quantizer_ = km
        return self

    def _build(self, items_h, labels_h, centers_h, device=None):
        """The layout seam: host items, labels and centroids in, device
        lists out (``device``: the default mesh's when None).  Every
        length and offset is computed on the host."""
        items_h = np.atleast_2d(np.asarray(items_h))
        labels_h = np.asarray(labels_h).ravel().astype(np.int64)
        centers_h = np.atleast_2d(np.asarray(centers_h))
        n, d = items_h.shape
        nlist = centers_h.shape[0]
        if labels_h.shape[0] != n:
            raise ValueError(f"{n} items but {labels_h.shape[0]} labels")
        if centers_h.shape[1] != d:
            raise ValueError(f"centroid width {centers_h.shape[1]} != "
                             f"item width {d}")
        if n and (labels_h.min() < 0 or labels_h.max() >= nlist):
            raise ValueError(f"labels must lie in [0, {nlist})")
        quantum = _list_quantum(self.list_quantum)
        mesh = _mesh.get_mesh() if device is None \
            else _mesh.local_mesh(device)

        counts_l = np.bincount(labels_h, minlength=nlist)       # (nlist,)
        pad_l = -(-counts_l // quantum) * quantum
        cap = max(int(pad_l.max(initial=0)), quantum)
        offs_l = np.zeros(nlist, np.int64)
        offs_l[1:] = np.cumsum(pad_l)[:-1]
        e_pad = max(int(pad_l.sum()), cap)
        # entries ordered by (list, row id): rank j of list l → slot
        # offs[l] + j
        order = np.argsort(labels_h, kind="stable")
        lbl_sorted = labels_h[order]
        starts = np.zeros(nlist + 1, np.int64)
        starts[1:] = np.cumsum(counts_l)
        slot = offs_l[lbl_sorted] + np.arange(n) - starts[lbl_sorted]
        vecs_h = np.zeros((e_pad, d), np.float32)
        ids_h = np.full(e_pad, -1, np.int32)
        vecs_h[slot] = items_h[order]
        ids_h[slot] = order

        dev = mesh.device
        self._vecs = torch.from_numpy(vecs_h).to(dev)
        self._ids = torch.from_numpy(ids_h).to(dev)
        self._vsq = torch.sum(self._vecs * self._vecs, dim=1)  # pads: 0
        self._offs = torch.from_numpy(offs_l).to(dev)
        self._cnts = torch.from_numpy(counts_l.astype(np.int64)).to(dev)
        cents = torch.from_numpy(centers_h.astype(np.float32)).to(dev)
        self._cents_t = cents.T.contiguous()        # (d, nlist) row-major
        self._c_sq = torch.sum(cents * cents, dim=1)
        self._cap = int(cap)
        self._mesh = mesh
        self.d = int(d)
        self.n_items = int(n)
        self.n_lists_ = int(nlist)
        self._items_h = items_h
        self._labels_h = labels_h
        self._centers_h = centers_h
        self.pad_waste = {
            "entries": int(n),
            "buffer_rows": int(e_pad),
            "list_pad_entries": int(pad_l.sum() - n),
            "balance_pad_rows": int(e_pad - pad_l.sum()),
            "waste_frac": float(1.0 - n / float(e_pad)),
            "cap": int(cap),
            "quantum": int(quantum),
            "per_shard_entries": [int(n)],
        }
        return self

    def _carry_in(self, arrays: dict, device):
        self.quantizer_ = arrays.get("quantizer_")
        if "_items_h" in arrays:
            self._build(arrays["_items_h"], arrays["_labels_h"],
                        arrays["_centers_h"], device=device)

    # the served buffers, in the order a deployment bundle carries them
    _SERVED = ("_vecs", "_ids", "_vsq", "_offs", "_cnts", "_cents_t",
               "_c_sq")

    def _served_buffers(self):
        return [getattr(self, name) for name in self._SERVED]

    def _adopt_served(self, buffers, cap, n_items, device=None):
        """The fitted index from its served buffers (host arrays in
        :data:`_SERVED` order, as ``RetrievalPipeline.capture_bucket``
        takes them): the same lists, ids and norms, with no layout pass
        (``device``: the default mesh's when None).  The host layout
        inputs are not carried, so ``save_model`` of such an index holds
        no lists."""
        mesh = _mesh.get_mesh() if device is None \
            else _mesh.local_mesh(device)
        for name, b in zip(self._SERVED, buffers, strict=True):
            setattr(self, name, torch.from_numpy(
                np.ascontiguousarray(b)).to(mesh.device))
        self._cap = int(cap)
        self._mesh = mesh
        self.d = int(self._vecs.shape[1])
        self.n_items = int(n_items)
        self.n_lists_ = int(self._c_sq.shape[0])
        return self

    def rebind_mesh(self, mesh) -> bool:
        """The reference's elastic re-stripe onto another mesh.  One card
        has one mesh shape: ``None`` and a (1, 1) mesh re-lay nothing
        (returns False); any other mesh raises."""
        if mesh is None or getattr(self, "n_items", None) is None:
            return False
        shape = _mesh.mesh_shape(mesh)
        if shape != (1, 1):
            raise NotImplementedError(
                f"IVFIndex.rebind_mesh onto a {shape} mesh: the port runs "
                "one device; striped lists over several ranks are "
                "ROADMAP.md A.2")
        return False

    def _check_fitted(self):
        if getattr(self, "n_items", None) is None:
            raise RuntimeError("IVFIndex is not fitted — call fit() first")

    # -- query ---------------------------------------------------------------

    def search(self, queries, k=10, nprobe=None, precision=None,
               overlap=None):
        """Approximate k nearest catalog rows of each query: ``(distances,
        ids)``, both (n_queries, k) ds-arrays (euclidean distance float32,
        catalog row ids int32), nearest first.  Slots the probed lists
        cannot fill carry id −1 and distance +∞.  ``nprobe=n_lists_``
        scans every list (the exact result, ties to the lower id);
        ``precision=`` and ``overlap=`` route as in the reference
        (``overlap="kernel"``/``"pallas"``: the centroid product on the
        hand kernel ``panel_gemm``)."""
        self._check_fitted()
        if isinstance(queries, Array):
            if queries.device != self._mesh.device:
                raise ValueError(f"queries live on {queries.device}, the "
                                 f"index on {self._mesh.device}")
            mq, d = queries.shape
            qv = queries._data[:mq, :d]
        else:
            qv = torch.as_tensor(np.atleast_2d(np.asarray(queries)),
                                 device=self._mesh.device)
            mq, d = qv.shape
        if d != self.d:
            raise ValueError(f"queries have {d} features, the index holds "
                             f"{self.d}")
        k = int(k)
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        nprobe = self.nprobe if nprobe is None else int(nprobe)
        nprobe = max(1, min(nprobe, self.n_lists_))
        d2, idx = _ivf_topk(
            qv.to(torch.float32).contiguous(), self._vecs, self._ids,
            self._vsq, self._offs, self._cnts, self._cents_t, self._c_sq,
            k, nprobe, self._cap, _ov.resolve(overlap),
            px.resolve(precision))
        return (Array._from_logical(torch.sqrt(d2), self._mesh),
                Array._from_logical(idx, self._mesh))


def _dead_keys(rows, k, device) -> torch.Tensor:
    """Merge keys (rows, k) of empty slots: distance +∞, id −1."""
    inf = torch.full((rows, k), float("inf"), device=device)
    return _keys(inf, torch.full((rows, k), 0xFFFFFFFF, dtype=torch.int64,
                                 device=device))


@precise
def _ivf_topk(q, vecs, ids, vsq, offs, cnts, cents_t, c_sq, k, nprobe, cap,
              overlap="db", policy=px.FLOAT32):
    """(d² (mq, k) float32 ≥ 0, ids (mq, k) int32) of the approximate k
    nearest catalog rows of each query row of ``q`` (mq, d) float32: the
    probe, the chunked scan and the merge of the module docstring.
    ``overlap`` is a canonical schedule of ``ops/overlap.SCHEDULES``."""
    mq, d = q.shape
    e_pad = vecs.shape[0]
    q_sq = torch.sum(q * q, dim=1)
    # (a) the coarse quantizer, (b) the probes
    if overlap == "kernel":
        cpart = _k.panel_gemm(q, cents_t, px.FLOAT32)
    else:
        cpart = px.pdot(q, cents_t, policy)
    cd = q_sq[:, None] - 2.0 * cpart + c_sq[None, :]
    probes = torch.topk(cd, nprobe, dim=1, largest=False,
                        sorted=True).indices                 # (mq, nprobe)

    # (c) the scan, pc probes a chunk; padded probe slots repeat list 0
    # with count 0, so they seat nothing
    pc = max(1, min(nprobe, PROBE_BLOCK // max(cap, 1)))
    n_chunks = -(-nprobe // pc)
    probes = torch.nn.functional.pad(probes, (0, n_chunks * pc - nprobe))
    probe_ok = torch.arange(n_chunks * pc, device=q.device) < nprobe
    slot = torch.arange(cap, device=q.device)
    rows_per_block = max(1, PANEL_BYTES // (pc * cap * d * 4))

    def scan(r0, best):
        qb = q[r0: r0 + rows_per_block]
        b = qb.shape[0]
        for c in range(n_chunks):
            pr = probes[r0: r0 + b, c * pc:(c + 1) * pc]      # (b, pc)
            cnt = torch.where(probe_ok[c * pc:(c + 1) * pc], cnts[pr], 0)
            flat = (offs[pr][:, :, None] + slot).clamp_(0, e_pad - 1) \
                .reshape(b, pc * cap)
            cross = px.peinsum("qd,qcd->qc", qb, vecs[flat], policy)
            d2 = q_sq[r0: r0 + b, None] - 2.0 * cross + vsq[flat]
            gi = ids[flat]
            live = (slot < cnt[:, :, None]).reshape(b, pc * cap) & (gi >= 0)
            best = merge_keyed(
                best, torch.where(live, d2, float("inf")).clamp_min_(0.0),
                torch.where(live, gi, -1), k)
        return best

    keys = _dead_keys(mq, k, q.device)
    for r0 in range(0, mq, rows_per_block):
        keys[r0: r0 + rows_per_block] = scan(
            r0, keys[r0: r0 + rows_per_block])
    return split_keys(keys)
