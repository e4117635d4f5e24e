"""Mini-batch K-means with a streaming ``partial_fit``.

Counterpart of ``dislib_tpu/cluster/minibatch.py``.  Each
``partial_fit(batch)`` is one :func:`_mbk_step` on the batch's device
(assign with the hand CUDA kernel ``distances_sq`` on a card, per-center
batch mass and means, the online center update) and one packed read of
the new centers, counts, the batch inertia and the step's health
vector.  ``counts_`` carries the accumulated per-center sample mass, so
the update is the standard c_j ← c_j + (m_j/counts_j)·(mean_j − c_j),
the learning rate decaying as mass accumulates (Sculley 2010).  ``fit``
streams row slices of a ds-array through ``partial_fit`` for ``epochs``
passes.

Each batch runs through the stream's
:meth:`~dislib_tpu_torch.runtime.ChunkedFitLoop.run_one`, as in the
reference: the first ``partial_fit`` call configures the stream's
``checkpoint``/``health`` (later calls reuse them) and restores from the
checkpoint when it holds a snapshot; the loop judges each batch's health
vector (a non-finite batch raises ``NumericalDivergence`` with guard
``'input-nonfinite'``), rolls back, snapshots every ``every`` batches and
polls the preemption flag.  ``fit`` resumes a preempted stream at the
snapshot's batch position (``runtime.fitloop.stream_state``), never
re-feeding a consumed batch.  ``history_`` is the stream's batch
inertias.  A batch must be dense: the reference turns a batch that is
not a ds-array into one with ``np.asarray``, which a sparse matrix (scipy, or a
``SparseArray``, whose ``fit`` slices are sparse too) fails with
``ValueError``; the port raises that type, naming the cause.  ``predict``
and ``score`` are KMeans', sparse queries included.

Across ranks ``fit``'s row slice is a row gather (one ``all_to_all``
over 'rows', ``data/array._gather_rows``), the batch's rows and order
unchanged; each rank assigns its rows of the batch (``distances_sq`` at
the per-rank batch shape), ONE packed ``psum`` over 'rows' carries the
per-center masses, sums and the inertia, and every rank makes the same
online update.  The stream's health verdict is agreed across ranks
(``ChunkedFitLoop(mesh=)``); ``checkpoint=`` raises there, naming
ROADMAP.md A.11, as ``KMeans(checkpoint=)`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from dislib_tpu_torch.cluster.kmeans import KMeans, _crop
from dislib_tpu_torch.data.sparse import SparseArray
from dislib_tpu_torch.data.array import Array, array as _ds_array
from dislib_tpu_torch.ops.base import distances_sq as _distances_sq, precise
from dislib_tpu_torch.parallel import distributed as _dist
from dislib_tpu_torch.parallel import mesh as _mesh
from dislib_tpu_torch.runtime import fitloop as _fitloop
from dislib_tpu_torch.runtime import health as _health
from dislib_tpu_torch.runtime.elastic import fetch_packed


class MiniBatchKMeans(KMeans):
    """Mini-batch K-means with a streaming ``partial_fit``.

    Parameters
    ----------
    n_clusters : int, default 8
    init : 'random' or ndarray (n_clusters, n_features) — fresh centers
        come from the FIRST batch's rows under 'random'.
    batch_size : int, default 256 — row slice width used by ``fit``.
    epochs : int, default 1 — passes over the data in ``fit``.
    random_state : int or None

    Attributes
    ----------
    centers_ : ndarray (n_clusters, n_features)
    counts_ : ndarray (n_clusters,) — per-center accumulated sample mass.
    n_batches_ : int — batches consumed by the stream so far.
    inertia_ : float — the last batch's within-cluster sum of squares.
    history_ : ndarray (n_batches_,) — every batch's inertia.
    """

    def __init__(self, n_clusters=8, init="random", batch_size=256,
                 epochs=1, random_state=None, verbose=False):
        self.n_clusters = n_clusters
        self.init = init
        self.batch_size = int(batch_size)
        self.epochs = int(epochs)
        self.random_state = random_state
        self.verbose = verbose
        self._loop = None

    def partial_fit(self, x, y=None, checkpoint=None, health=None):
        """Consume one batch (a ds-array, or host data that becomes one on
        the default mesh).  The first call configures the stream's
        resilience (``checkpoint``/``health`` are stream-wide; later
        calls reuse them) and restores from the checkpoint if it holds a
        snapshot — a preempted stream resumes where it snapshot."""
        if not isinstance(x, Array):
            import scipy.sparse as sp
            if sp.issparse(x) or isinstance(x, SparseArray):
                raise ValueError(
                    f"MiniBatchKMeans on {type(x).__name__}: batches must be "
                    "dense (a ds-array or host rows); densify a sparse "
                    "batch first (to_dense())")
            x = _ds_array(x, dtype=np.float32)
        k = self.n_clusters
        if x._mesh.world > 1 and (checkpoint is not None or (
                self._loop is not None and self._loop.checkpoint is not None)):
            raise NotImplementedError(
                "MiniBatchKMeans(checkpoint=...) on a ds-array sharded over "
                "several ranks: snapshots of a multi-rank fit are "
                "ROADMAP.md A.11")
        if self._loop is None:
            self._batch = {}
            self._loop = _fitloop.ChunkedFitLoop(
                "minibatch_kmeans", checkpoint=checkpoint, health=health,
                carry_names=("centers", "counts"),
                carry_shapes=((k, x.shape[1]), (k,)),
                save_every=checkpoint.every if checkpoint is not None else 1,
                elastic=_fitloop.data_rebind(self._batch), mesh=x._mesh)
        batch, loop = self._batch, self._loop
        batch["x"] = x
        # THIS batch's width defines what a compatible snapshot holds
        loop.snapshot_expect = {"centers": (k, x.shape[1]), "counts": (k,)}

        def init(rem):
            centers = rem.perturb(self._init_centers(batch["x"]))
            return _fitloop.LoopState(
                (centers, torch.zeros((k,), dtype=torch.float32,
                                      device=batch["x"].device)))

        def restore(snap, rem):
            dev = batch["x"].device
            c, n = (torch.from_numpy(np.asarray(rem.perturb(
                np.asarray(snap[key], np.float32)))).to(dev)
                for key in ("centers", "counts"))
            return _fitloop.LoopState((c, n), it=int(snap["n_batches"]),
                                      extra=(float(snap.get("inertia",
                                                            np.nan)),
                                             np.asarray(snap["centers"]),
                                             np.asarray(snap["counts"])))

        def step(st, chunk):
            xd = batch["x"]
            out = _mbk_step(xd._row_block(), xd.shape, *st.carries,
                            mesh=xd._mesh, row0=xd._at[0])
            pack = fetch_packed(*out)

            def commit():
                c_h, n_h, inertia, _ = pack.result()
                return _fitloop.LoopState(out[:2], st.it + 1,
                                          extra=(float(inertia), c_h, n_h))

            return _fitloop.ChunkOutcome(
                commit, hvec=pack.part(3),
                history=lambda: (float(pack.result()[2]),))

        def snapshot(st):
            inertia, c_h, n_h = st.extra
            return {"centers": c_h, "counts": n_h, "n_batches": st.it,
                    "inertia": inertia}

        st = loop.run_one(init=init, step=step, restore=restore,
                          snapshot=snapshot)
        inertia, self.centers_, self.counts_ = st.extra
        self.n_batches_ = self.n_iter_ = st.it
        self.inertia_ = float(inertia)
        self.history_ = np.asarray(loop.history, dtype=np.float64)
        self.fit_info_ = loop.info
        return self

    def fit(self, x: Array, y=None, checkpoint=None, health=None):
        """Stream ``x`` through ``partial_fit`` in ``batch_size`` row
        slices, ``epochs`` passes, from a fresh stream — EXCEPT when
        ``checkpoint`` already holds a snapshot: the stream then resumes
        at the snapshot's batch position (the preemption-recovery re-run)
        and lands on the uninterrupted run's model."""
        self._loop = None
        start, snap = _fitloop.stream_state(checkpoint)
        m = x.shape[0]
        g = 0                           # global batch index across epochs
        for _ in range(max(1, self.epochs)):
            for s in range(0, m, self.batch_size):
                g += 1
                if g <= start:
                    continue            # already consumed by the snapshot
                self.partial_fit(x[s: min(s + self.batch_size, m), :],
                                 checkpoint=checkpoint, health=health)
        if start and g <= start:
            # the snapshot already covers the whole stream: adopt it
            self.centers_ = np.asarray(snap["centers"])
            self.counts_ = np.asarray(snap["counts"])
            self.n_batches_ = self.n_iter_ = int(snap["n_batches"])
            self.inertia_ = float(snap.get("inertia", np.nan))
            self.history_ = np.asarray([], dtype=np.float64)
            self.fit_info_ = {"chunks": 0, "rollbacks": 0,
                              "mesh_shrinks": 0, "escalations": {}}
        elif checkpoint is not None:
            # the final snapshot is on disk before fit returns
            checkpoint.flush()
        return self

    def _carry_in(self, arrays: dict, device):
        self.centers_ = np.array(arrays["centers_"], np.float32)
        self.counts_ = np.array(arrays["counts_"], np.float32)


@precise
def _mbk_step(xp, shape, centers, counts, mesh=None, row0=0):
    """One mini-batch update: assign (``distances_sq``), per-center batch
    mass and means, the online center update.  Returns ``(centers,
    counts, inertia, hvec)`` as device tensors; the health vector guards
    the new carries and the batch (no loss history: consecutive batches
    are different data, so their inertias are no monotone trajectory).
    ``xp`` is the batch's padded backing, or this rank's rows of it (the
    first global row ``row0``): the masses, sums and inertia are then one
    packed ``psum`` over 'rows'."""
    xv, w = _crop(xp, shape, row0)
    k, n = centers.shape
    d = _distances_sq(xv, centers, use_kernel=True)
    min_d, labels = torch.min(d, dim=1)      # first index on ties
    onehot = (labels[:, None] == torch.arange(k, device=xv.device)).to(
        xv.dtype) * w[:, None]
    bc = onehot.sum(dim=0)                   # (k,) batch mass
    sums = onehot.T @ xv
    inertia = torch.sum(min_d * w)
    if mesh is not None and mesh.groups is not None:
        packed = _dist.psum(torch.cat([bc, sums.reshape(-1),
                                       inertia.reshape(1)]), _mesh.ROWS, mesh)
        bc, sums, inertia = packed[:k], packed[k:k + k * n].view(k, n), \
            packed[-1]
    bmean = sums / torch.clamp_min(bc, 1.0)[:, None]
    new_counts = counts + bc
    eta = (bc / torch.clamp_min(new_counts, 1.0))[:, None]
    new_centers = torch.where(bc[:, None] > 0,
                              centers + eta * (bmean - centers), centers)
    hvec = _health.health_vec(carries=(new_centers, new_counts),
                              inputs=(xv,))
    return new_centers.contiguous(), new_counts, inertia, hvec
