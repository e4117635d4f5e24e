"""Daura / GROMOS conformational clustering.

Counterpart of ``dislib_tpu/cluster/daura.py``.  Frames are rows of
3·n_atoms coordinates (the layout ``load_mdcrd_file`` gives); RMSD(i, j) =
√(‖x_i − x_j‖² / n_atoms), without superposition, as the reference.  The
greedy loop: count every active frame's active neighbours (RMSD ≤
cutoff, itself included), take the frame with the most as the medoid (the
first on ties, as ``jnp.argmax`` and ``torch.argmax`` both take), peel its
active neighbourhood off as one cluster, repeat until no frame is active.

The tiers are DBSCAN's (``cluster/dbscan.py``), chosen the same way:

- **dense** (padded rows ≤ :data:`_DENSE_MAX`): one (m, m) distance matrix
  through the hand ``distances_sq`` kernel, a resident adjacency
  (``d² / n_atoms ≤ cutoff²``), and a round is a masked count, an argmax
  and a row gather;
- **tiled**: each round's counts are one streamed ε-pass of
  ``ops/tiled.neigh_count_min`` (``d² ≤ cutoff²·n_atoms``, the
  reference's tiled test) and the medoid's neighbourhood is one distance
  column ``distances_sq(x, x_medoid)``, on the kernel too;
- **ring**: the tiled tier's passes through
  ``ops/ring.ring_neigh_count_min``.

The reference loops until no frame is active with no host read.  A dense
round is cheap, so rounds run masked in chunks of ``loop.EVERY``
(``runtime/loop.run_chunked``, one read of ``any(active)`` a chunk, site
``"daura"``): a round with nothing active changes nothing.  A tiled or
ring round is a whole O(m²) ε-pass, so those tiers read once per
extracted cluster.  Labels, medoids and the input's non-finite count come
back in one read.  Non-finite input raises ``NumericalDivergence``
(``"input-nonfinite"``), as the reference's default guard does;
``checkpoint=``/``health=`` raise, naming ROADMAP.md A.12.
"""

from __future__ import annotations

import numpy as np
import torch

from dislib_tpu_torch.base import BaseEstimator
from dislib_tpu_torch.cluster.dbscan import (
    check_finite, f32, labels_array, refuse_fit_options,
)
from dislib_tpu_torch.cluster.kmeans import _to_host
from dislib_tpu_torch.data.array import Array
from dislib_tpu_torch.data.sparse import dense_input
from dislib_tpu_torch.ops import kernels as _k
from dislib_tpu_torch.ops import overlap as _ov
from dislib_tpu_torch.ops import tiled as _tiled
from dislib_tpu_torch.ops.ring import ring_auto, ring_neigh_count_min
from dislib_tpu_torch.runtime.loop import run_chunked
from dislib_tpu_torch.utils.profiling import host_read

# padded frame counts above this stream the RMSD adjacency in tiles
# (module-level so tests can force the path)
_DENSE_MAX = 16384

# ring-distribute the streamed passes (None = auto: >1 row shard and past
# _DENSE_MAX; module-level so tests can force it)
_RING = None


class Daura(BaseEstimator):
    """GROMOS clustering of MD trajectory frames.

    Parameters
    ----------
    cutoff : float — RMSD threshold for two frames to be neighbours.

    Attributes
    ----------
    clusters_ : list of ndarray — one per cluster, frame indices with the
        medoid first; ordered by extraction (largest neighbourhoods first).
    labels_ : ndarray (n_frames,) int64 — cluster id per frame.
    """

    def __init__(self, cutoff=1.0):
        self.cutoff = cutoff

    def fit(self, x: Array, y=None, checkpoint=None, health=None):
        refuse_fit_options("Daura", checkpoint, health)
        x = dense_input(x, "Daura")
        if x.shape[1] % 3 != 0:
            raise ValueError("Daura expects rows of 3*n_atoms coordinates")
        n_atoms = x.shape[1] // 3
        m, n = x.shape
        mesh = x._mesh
        cutoff = float(self.cutoff)
        xv = _tiled.pad_cols(x._data[:m, :n])
        if ring_auto(_RING, mesh, x._data.shape[0] > _DENSE_MAX):
            sched = _ov.resolve()
            labels, medoids = _daura_fit_streamed(
                xv, cutoff, n_atoms, lambda *a, **kw: ring_neigh_count_min(
                    *a, mesh=mesh, overlap=sched, **kw))
        elif x._data.shape[0] <= _DENSE_MAX:
            labels, medoids = _daura_fit(xv, cutoff, n_atoms)
        else:
            tile = _tiled.TILE
            labels, medoids = _daura_fit_streamed(
                xv, cutoff, n_atoms, lambda *a, **kw: _tiled.neigh_count_min(
                    *a, tile, **kw))
        n_bad = (~torch.isfinite(xv)).sum()
        labels, medoids, n_bad = _to_host(labels, medoids, n_bad)
        check_finite(n_bad, "daura")
        self.labels_ = labels.astype(np.int64)
        clusters = []
        for cid in range(int(labels.max()) + 1 if labels.size else 0):
            members = np.nonzero(labels == cid)[0]
            med = int(medoids[cid])
            clusters.append(np.concatenate(([med], members[members != med])))
        self.clusters_ = clusters
        return self

    def fit_predict(self, x: Array, y=None) -> Array:
        self.fit(x)
        return labels_array(self.labels_, x._mesh)


def _daura_fit(xv, cutoff, n_atoms):
    """The dense tier on the (m, n) frames ``xv``: (labels int32, medoids
    int32 (m,), −1 past the last cluster)."""
    m = xv.shape[0]
    dev = xv.device
    cut2 = f32(f32(cutoff) * f32(cutoff))
    adj = _k.distances_sq(xv, xv).div_(n_atoms) <= cut2
    # structural self-loops: every frame is its own neighbour, so each
    # round removes at least one frame
    adj.fill_diagonal_(True)
    ids = torch.arange(m, dtype=torch.int32, device=dev)
    st = {"active": torch.ones(m, dtype=torch.bool, device=dev),
          "labels": torch.full((m,), -1, dtype=torch.int32, device=dev),
          "medoids": torch.full((m,), -1, dtype=torch.int32, device=dev),
          "cid": torch.zeros((), dtype=torch.int32, device=dev)}

    def step(t):
        active, cid = st["active"], st["cid"]
        running = active.any()
        counts = (adj & active[None, :]).sum(1)       # active neighbours
        counts = torch.where(active, counts, -1)
        medoid = torch.argmax(counts)                 # the first maximum
        # nothing is active once the loop has ended: members is empty
        members = adj[medoid] & active
        st["labels"] = torch.where(members, cid, st["labels"])
        slot = cid.clamp(max=m - 1).to(torch.int64)
        st["medoids"][slot] = torch.where(running, medoid.to(torch.int32),
                                          st["medoids"][slot])
        st["active"] = active & ~members
        st["cid"] = cid + running.to(torch.int32)

    run_chunked(step, lambda: st["active"].any(), m, "daura")
    return st["labels"], st["medoids"]


def _daura_fit_streamed(xv, cutoff, n_atoms, ncm):
    """The tiled and ring tiers: one ε-pass ``ncm`` (as in
    ``cluster/dbscan._dbscan_fit_streamed``) and one host read per
    extracted cluster."""
    m = xv.shape[0]
    dev = xv.device
    cut2 = f32(f32(f32(cutoff) * f32(cutoff)) * n_atoms)
    ids = torch.arange(m, dtype=torch.int32, device=dev)
    active = torch.ones(m, dtype=torch.bool, device=dev)
    labels = torch.full((m,), -1, dtype=torch.int32, device=dev)
    medoids = torch.full((m,), -1, dtype=torch.int32, device=dev)
    cid = 0
    while True:
        counts, _ = ncm(xv, cut2, ids, active, m, mins=False)
        counts = torch.where(active, counts, -1)
        medoid = torch.argmax(counts)
        # the medoid's neighbourhood: one distance column on the kernel
        mrow = _k.distances_sq(xv, xv.index_select(0, medoid.view(1)))[:, 0]
        members = ((mrow <= cut2) | (ids == medoid)) & active
        labels = torch.where(members, cid, labels)
        medoids[cid] = medoid.to(torch.int32)
        active = active & ~members
        cid += 1
        if not host_read(active.any(), "daura"):
            break
    return labels, medoids
