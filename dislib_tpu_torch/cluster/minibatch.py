"""Mini-batch K-means with a streaming ``partial_fit``.

Counterpart of ``dislib_tpu/cluster/minibatch.py``.  Each
``partial_fit(batch)`` is one :func:`_mbk_step` on the batch's device
(assign with the hand CUDA kernel ``distances_sq`` on a card, per-center
batch mass and means, the online center update) and one read of the new
centers, counts and the batch inertia.  ``counts_`` carries the
accumulated per-center sample mass, so the update is the standard
c_j ← c_j + (m_j/counts_j)·(mean_j − c_j), the learning rate decaying as
mass accumulates (Sculley 2010).  ``fit`` streams row slices of a
ds-array through ``partial_fit`` for ``epochs`` passes.

The reference runs each batch through its ``ChunkedFitLoop.run_one``
(rollback, watchdog, snapshots, preemption); the port calls the step
directly, and ``history_`` is the stream's batch inertias.
``checkpoint=``/``health=`` raise ``NotImplementedError`` (ROADMAP.md
A.12).  A batch must be dense: the reference turns a batch that is not a
ds-array into one with ``np.asarray``, which a sparse matrix (scipy, or a
``SparseArray``, whose ``fit`` slices are sparse too) fails with
``ValueError``; the port raises that type, naming the cause.  ``predict``
and ``score`` are KMeans', sparse queries included.
"""

from __future__ import annotations

import numpy as np
import torch

from dislib_tpu_torch.cluster.kmeans import KMeans, _crop, _to_host
from dislib_tpu_torch.data.sparse import SparseArray
from dislib_tpu_torch.data.array import Array, array as _ds_array
from dislib_tpu_torch.ops.base import distances_sq as _distances_sq, precise


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
        self._stream = None

    def partial_fit(self, x, y=None, checkpoint=None, health=None):
        """Consume one batch (a ds-array, or host data that becomes one on
        the default mesh)."""
        if checkpoint is not None or health is not None:
            raise NotImplementedError(
                "MiniBatchKMeans.partial_fit checkpoint=/health=: the "
                "ChunkedFitLoop is not ported yet (ROADMAP.md A.12)")
        if not isinstance(x, Array):
            import scipy.sparse as sp
            if sp.issparse(x) or isinstance(x, SparseArray):
                raise ValueError(
                    f"MiniBatchKMeans on {type(x).__name__}: batches must be "
                    "dense (a ds-array or host rows); densify a sparse "
                    "batch first (to_dense())")
            x = _ds_array(x, dtype=np.float32)
        if self._stream is None:
            # the stream's carries stay on the device between batches
            self._stream = {
                "centers": self._init_centers(x),
                "counts": torch.zeros((self.n_clusters,),
                                      dtype=torch.float32, device=x.device),
                "n_batches": 0, "history": []}
        st = self._stream
        st["centers"], st["counts"], inertia = _mbk_step(
            x._data, x.shape, st["centers"], st["counts"])
        st["n_batches"] += 1
        centers, counts, inertia = _to_host(st["centers"], st["counts"],
                                            inertia)
        st["history"].append(float(inertia))
        self.centers_ = centers
        self.counts_ = counts
        self.n_batches_ = self.n_iter_ = st["n_batches"]
        self.inertia_ = float(inertia)
        self.history_ = np.asarray(st["history"], dtype=np.float64)
        return self

    def fit(self, x: Array, y=None, checkpoint=None, health=None):
        """Stream ``x`` through ``partial_fit`` in ``batch_size`` row
        slices, ``epochs`` passes, from a fresh stream."""
        self._stream = None
        m = x.shape[0]
        for _ in range(max(1, self.epochs)):
            for s in range(0, m, self.batch_size):
                self.partial_fit(x[s: min(s + self.batch_size, m), :],
                                 checkpoint=checkpoint, health=health)
        return self

    def _carry_in(self, arrays: dict, device):
        self.centers_ = np.array(arrays["centers_"], np.float32)
        self.counts_ = np.array(arrays["counts_"], np.float32)


@precise
def _mbk_step(xp, shape, centers, counts):
    """One mini-batch update: assign (``distances_sq``), per-center batch
    mass and means, the online center update.  Returns ``(centers,
    counts, inertia)`` as device tensors."""
    xv, w = _crop(xp, shape)
    k = centers.shape[0]
    d = _distances_sq(xv, centers, use_kernel=True)
    min_d, labels = torch.min(d, dim=1)      # first index on ties
    onehot = (labels[:, None] == torch.arange(k, device=xv.device)).to(
        xv.dtype) * w[:, None]
    bc = onehot.sum(dim=0)                   # (k,) batch mass
    bmean = (onehot.T @ xv) / torch.clamp_min(bc, 1.0)[:, None]
    new_counts = counts + bc
    eta = (bc / torch.clamp_min(new_counts, 1.0))[:, None]
    new_centers = torch.where(bc[:, None] > 0,
                              centers + eta * (bmean - centers), centers)
    return new_centers.contiguous(), new_counts, torch.sum(min_d * w)
