"""IVF approximate nearest-neighbour index.

Counterpart of ``dislib_tpu/retrieval/ivf.py``.  ``fit`` clusters the
catalog with the port's :class:`~dislib_tpu_torch.cluster.KMeans` (its
E-step is the hand kernel ``distances_sq``), then lays the inverted lists
out on the host as the reference's ``_build`` does, striped over the p
row shards of the mesh (p = the mesh's rows; 1 on one card): entry j of
list ℓ (in row-id order) goes to shard j % p, each (shard, list)
sub-list padded to a multiple of the list quantum (``list_quantum``, else
``DSLIB_IVF_LIST_QUANTUM``, else 8) with pad slots of id −1, zero vector
and zero norm.  ``pad_waste`` measures what the padding costs.  Across
ranks each rank keeps only its mesh row's stripe, its features split over
'cols' as the reference's ``P(ROWS, COLS)``; the whole catalog and the
labels are collected once for the host layout.

``search`` is the reference's ``_ivf_topk``:

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

Across ranks the queries stay on their rank (its block of rows and
features): the norms and the centroid cross term are per rank and
``psum``-ed over 'cols' (the cross term on ``panel_gemm`` under
``kernel``), and the stripes go round the 'rows' ring by ``ppermute``,
R − 1 hops through ``ops/overlap.panel_pipeline`` (under ``db`` the next
stripe is in flight while this one is scanned); each hop's scan merges
into the running top-k, ties to the lower id whatever the hop order (the
reference's ring keeps the earlier arrival).  On one rank the ring has
one step, so ``db`` and ``seq`` are the same computation.  Where the port
departs: a d² below 0 (cancellation) ranks as 0, as in ``ops/ring.py``,
and the lists and the merge keys are float32 (the reference keeps a
float64 catalog in float64).

``fit(checkpoint=, health=)`` hands both to the quantizer's KMeans fit
loop.  ``retrieval/serving.RetrievalPipeline`` serves the search as one
CUDA-graph replay a batch.  Not ported: ``rebind_mesh`` onto another
mesh shape than the index's (the elastic re-stripe, ROADMAP.md A.11).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from dislib_tpu_torch.base import BaseEstimator
from dislib_tpu_torch.data.array import Array, _block_with, \
    _padded_shape, array as _mk_array
from dislib_tpu_torch.ops import kernels as _k
from dislib_tpu_torch.ops import overlap as _ov
from dislib_tpu_torch.ops import precision as px
from dislib_tpu_torch.ops.base import _keys, merge_keyed, precise, \
    split_keys
from dislib_tpu_torch.parallel import distributed as _dist
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
        """Build the index: the KMeans quantizer on the catalog's mesh
        (its fit loop takes ``checkpoint=``/``health=``, as any KMeans
        fit), one labels pass, then the host layout of the lists (across
        ranks the catalog and the labels collected on every rank)."""
        from dislib_tpu_torch.cluster import KMeans
        arr = items if isinstance(items, Array) \
            else _mk_array(np.atleast_2d(np.asarray(items, np.float32)))
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
        self._build(arr.collect(), labels, km.centers_, mesh=arr._mesh)
        self.quantizer_ = km
        return self

    def _build(self, items_h, labels_h, centers_h, device=None, mesh=None):
        """The layout seam: host items, labels and centroids in, device
        lists out, striped over ``mesh``'s row shards (default: the
        default mesh, or a one-rank mesh on ``device`` when given); this
        rank keeps its stripe.  Every length and offset is computed on
        the host."""
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
        if mesh is None:
            mesh = _mesh.get_mesh() if device is None \
                else _mesh.local_mesh(device)
        p, s = mesh.rows, mesh.coord[0]
        d_pad = _padded_shape((1, d), _mesh.pad_quantum(mesh))[1]
        d_loc = d_pad // mesh.cols
        c0 = mesh.coord[1] * d_loc

        # striped sub-list lengths: entry rank j of list l → shard j % p
        counts_l = np.bincount(labels_h, minlength=nlist)       # (nlist,)
        sh = np.arange(p, dtype=np.int64)
        cnt_ls = np.clip((counts_l[:, None] - sh[None, :] + p - 1) // p, 0,
                         None)                                  # (nlist, p)
        pad_ls = -(-cnt_ls // quantum) * quantum
        cap = max(int(pad_ls.max(initial=0)), quantum)
        offs_ls = np.zeros((nlist, p), np.int64)
        offs_ls[1:] = np.cumsum(pad_ls, axis=0)[:-1]
        e_pad = max(int(pad_ls.sum(axis=0).max(initial=0)), cap)
        # entries ordered by (list, row id): rank j of list l → slot
        # offs[l, j % p] + j // p of shard j % p; this rank keeps shard s
        order = np.argsort(labels_h, kind="stable")
        lbl_sorted = labels_h[order]
        starts = np.zeros(nlist + 1, np.int64)
        starts[1:] = np.cumsum(counts_l)
        rank = np.arange(n, dtype=np.int64) - starts[lbl_sorted]
        mine = rank % p == s
        slot = offs_ls[lbl_sorted[mine], s] + rank[mine] // p
        vecs_h = np.zeros((e_pad, d_pad), np.float32)
        ids_h = np.full(e_pad, -1, np.int32)
        vecs_h[slot, :d] = items_h[order[mine]]
        ids_h[slot] = order[mine]

        dev = mesh.device
        vecs = torch.from_numpy(vecs_h).to(dev)
        self._vsq = torch.sum(vecs * vecs, dim=1)           # pads: 0
        self._vecs = vecs[:, c0:c0 + d_loc].contiguous()   # its features
        self._ids = torch.from_numpy(ids_h).to(dev)
        self._offs = torch.from_numpy(offs_ls[:, s].copy()).to(dev)
        self._cnts = torch.from_numpy(cnt_ls[:, s].astype(np.int64)).to(dev)
        cents_h = np.zeros((nlist, d_pad), np.float32)
        cents_h[:, :d] = centers_h
        cents = torch.from_numpy(cents_h).to(dev)
        self._c_sq = torch.sum(cents * cents, dim=1)
        # (d_loc, nlist) row-major: this rank's features
        self._cents_t = cents[:, c0:c0 + d_loc].T.contiguous()
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
            "buffer_rows": int(p * e_pad),
            "list_pad_entries": int(pad_ls.sum() - n),
            "balance_pad_rows": int(p * e_pad - pad_ls.sum()),
            "waste_frac": float(1.0 - n / float(p * e_pad)),
            "cap": int(cap),
            "quantum": int(quantum),
            "per_shard_entries": [int(v) for v in cnt_ls.sum(axis=0)],
        }
        return self

    def _carry_in(self, arrays: dict, device):
        # onto the default mesh when it is on ``device`` (across ranks the
        # lists stripe onto the job's mesh), else one rank on ``device``
        self.quantizer_ = arrays.get("quantizer_")
        if "_items_h" in arrays:
            mesh = _mesh.get_mesh()
            self._build(arrays["_items_h"], arrays["_labels_h"],
                        arrays["_centers_h"],
                        mesh=mesh if mesh.device == torch.device(device)
                        else _mesh.local_mesh(device))

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
        """The reference's elastic re-stripe onto another mesh: ``None``
        and a mesh of the index's own shape re-lay nothing (returns
        False); another shape raises, naming ROADMAP.md A.11."""
        if mesh is None or getattr(self, "n_items", None) is None:
            return False
        shape = _mesh.mesh_shape(mesh)
        if shape != _mesh.mesh_shape(self._mesh):
            raise NotImplementedError(
                f"IVFIndex.rebind_mesh onto a {shape} mesh from the "
                f"{_mesh.mesh_shape(self._mesh)} it was striped for: the "
                "elastic re-stripe is ROADMAP.md A.11")
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
        mesh = self._mesh
        if not isinstance(queries, Array) and mesh.world > 1:
            queries = Array._from_logical(torch.as_tensor(np.atleast_2d(
                np.asarray(queries, np.float32))), mesh)
        if isinstance(queries, Array):
            if queries.device != mesh.device:
                raise ValueError(f"queries live on {queries.device}, the "
                                 f"index on {mesh.device}")
            if mesh.world > 1 and queries._mesh != mesh:
                raise ValueError("the queries and the index live on "
                                 "different meshes")
            mq, d = queries.shape
            # across ranks this rank's block: its query rows, its features
            qv = queries._local if mesh.world > 1 else queries._data[:mq, :d]
        else:
            qv = torch.as_tensor(np.atleast_2d(np.asarray(queries)),
                                 device=mesh.device)
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
            px.resolve(precision), mesh=mesh)
        if mesh.world > 1:      # this rank's query rows, row-sharded
            at = (queries._at[0], 0)
            return (Array(_block_with(torch.sqrt(d2), at, (mq, k), mesh),
                          (mq, k), mesh),
                    Array(_block_with(idx, at, (mq, k), mesh), (mq, k),
                          mesh))
        return (Array._from_logical(torch.sqrt(d2), mesh),
                Array._from_logical(idx, mesh))


def _dead_keys(rows, k, device) -> torch.Tensor:
    """Merge keys (rows, k) of empty slots: distance +∞, id −1."""
    inf = torch.full((rows, k), float("inf"), device=device)
    return _keys(inf, torch.full((rows, k), 0xFFFFFFFF, dtype=torch.int64,
                                 device=device))


@precise
def _ivf_topk(q, vecs, ids, vsq, offs, cnts, cents_t, c_sq, k, nprobe, cap,
              overlap="db", policy=px.FLOAT32, mesh=None):
    """(d² (mq, k) float32 ≥ 0, ids (mq, k) int32) of the approximate k
    nearest catalog rows of each query row of ``q`` (mq, d) float32: the
    probe, the chunked scan and the merge of the module docstring.
    ``overlap`` is a canonical schedule of ``ops/overlap.SCHEDULES``.  On
    a ``mesh`` with a process group ``q`` and the stripe are this rank's
    (its features), the feature sums are ``psum``-ed over 'cols' and the
    stripes go round the 'rows' ring."""
    mq, d = q.shape
    ranks = mesh is not None and mesh.groups is not None

    def cols_sum(t):
        return _dist.psum(t, _mesh.COLS, mesh) if ranks else t

    q_sq = cols_sum(torch.sum(q * q, dim=1))
    # (a) the coarse quantizer, (b) the probes
    if overlap == "kernel":
        cpart = _k.panel_gemm(q, cents_t, px.FLOAT32)
    else:
        cpart = px.pdot(q, cents_t, policy)
    cd = q_sq[:, None] - 2.0 * cols_sum(cpart) + c_sq[None, :]
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

    def scan(stripe, r0, best):
        vecs, ids, vsq, offs, cnts = stripe
        e_pad = vecs.shape[0]
        qb = q[r0: r0 + rows_per_block]
        b = qb.shape[0]
        for c in range(n_chunks):
            pr = probes[r0: r0 + b, c * pc:(c + 1) * pc]      # (b, pc)
            cnt = torch.where(probe_ok[c * pc:(c + 1) * pc], cnts[pr], 0)
            flat = (offs[pr][:, :, None] + slot).clamp_(0, e_pad - 1) \
                .reshape(b, pc * cap)
            cross = cols_sum(px.peinsum("qd,qcd->qc", qb, vecs[flat],
                                        policy))
            d2 = q_sq[r0: r0 + b, None] - 2.0 * cross + vsq[flat]
            gi = ids[flat]
            live = (slot < cnt[:, :, None]).reshape(b, pc * cap) & (gi >= 0)
            best = merge_keyed(
                best, torch.where(live, d2, float("inf")).clamp_min_(0.0),
                torch.where(live, gi, -1), k)
        return best

    def fetch(t, prev):
        # one hop: the stripe of the rank t places back along 'rows'
        return tuple(_dist.ppermute(p, _mesh.ROWS, 1, mesh, async_op=True)
                     for p in _ov.landed(prev))

    def consume(t, keys, pan):
        stripe = _ov.landed(pan)
        for r0 in range(0, mq, rows_per_block):
            keys[r0: r0 + rows_per_block] = scan(
                stripe, r0, keys[r0: r0 + rows_per_block])
        return keys

    keys = _ov.panel_pipeline(
        mesh.rows if ranks else 1, (vecs, ids, vsq, offs, cnts), fetch,
        consume, _dead_keys(mq, k, q.device), _ov.overlapped(overlap))
    return split_keys(keys)
