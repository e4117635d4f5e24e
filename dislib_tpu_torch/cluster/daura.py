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
extracted cluster.

The fit runs through :class:`~dislib_tpu_torch.runtime.ChunkedFitLoop`,
as DBSCAN's does (``cluster/dbscan.one_chunk_fit`` and ``checked_fit``):
unchecked, one chunk whose labels, medoids and input health vector come
back in one read (non-finite input raises ``NumericalDivergence``,
``"input-nonfinite"``); with ``checkpoint=FitCheckpoint(path, every=k)``
the streamed tier extracts k clusters a chunk and snapshots the greedy
state (active mask, labels, medoids, cluster counter).  The greedy loop
is deterministic in that state, so a resumed fit ends where the
uninterrupted one does.
"""

from __future__ import annotations

import numpy as np
import torch

from dislib_tpu_torch.base import BaseEstimator
from dislib_tpu_torch.cluster.dbscan import (
    checked_fit, f32, labels_array, one_chunk_fit,
)
from dislib_tpu_torch.data.array import Array
from dislib_tpu_torch.data.sparse import dense_input
from dislib_tpu_torch.ops import kernels as _k
from dislib_tpu_torch.ops import overlap as _ov
from dislib_tpu_torch.ops import tiled as _tiled
from dislib_tpu_torch.ops.ring import ring_auto, ring_neigh_count_min
from dislib_tpu_torch.runtime.elastic import fetch_packed
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
        """Fit.  With ``checkpoint=FitCheckpoint(path, every=k)`` the
        greedy state snapshots every k extracted clusters of the streamed
        tier; a re-run resumes the extraction.  ``health``: the loop's
        guard policy (it watches the input frames)."""
        x = dense_input(x, "Daura")
        if x.shape[1] % 3 != 0:
            raise ValueError("Daura expects rows of 3*n_atoms coordinates")
        n_atoms = x.shape[1] // 3
        m, n = x.shape
        mesh = x._mesh
        cutoff = float(self.cutoff)
        xv = _tiled.pad_cols(x._data[:m, :n])
        ring = ring_auto(_RING, mesh, x._data.shape[0] > _DENSE_MAX)
        if ring:
            sched = _ov.resolve()

            def ncm(*a, **kw):
                return ring_neigh_count_min(*a, mesh=mesh, overlap=sched,
                                            **kw)
        else:
            def ncm(*a, **kw):
                return _tiled.neigh_count_min(*a, _tiled.TILE, **kw)
        if checkpoint is not None:
            labels, medoids = self._fit_checkpointed(x, xv, n_atoms, ncm,
                                                     checkpoint, health)
        else:
            if ring or x._data.shape[0] > _DENSE_MAX:
                def run():
                    return _daura_fit_streamed(xv, cutoff, n_atoms, ncm)
            else:
                def run():
                    return _daura_fit(xv, cutoff, n_atoms)
            (labels, medoids), self.fit_info_ = one_chunk_fit(
                "daura", health, run, xv)
        self.labels_ = labels.astype(np.int64)
        clusters = []
        for cid in range(int(labels.max()) + 1 if labels.size else 0):
            members = np.nonzero(labels == cid)[0]
            med = int(medoids[cid])
            clusters.append(np.concatenate(([med], members[members != med])))
        self.clusters_ = clusters
        return self

    def _fit_checkpointed(self, x, xv, n_atoms, ncm, checkpoint, health):
        """The streamed extraction in chunks of ``every`` clusters, the
        greedy state snapshotted between chunks; returns the host
        (labels, medoids)."""
        m = xv.shape[0]
        cutoff = float(self.cutoff)
        cut2 = f32(f32(f32(cutoff) * f32(cutoff)) * n_atoms)
        dev = xv.device
        fp = np.asarray([x.shape[0], x.shape[1], cutoff], np.float64)

        def init():
            return (torch.ones(m, dtype=torch.bool, device=dev),
                    torch.full((m,), -1, dtype=torch.int32, device=dev),
                    torch.full((m,), -1, dtype=torch.int32, device=dev), 0)

        def restore(snap):
            act, lab, med = (torch.from_numpy(np.asarray(snap[k])[:m].astype(
                dt)).to(dev) for k, dt in (("active", bool),
                                           ("labels", np.int32),
                                           ("medoids", np.int32)))
            return act, lab, med, int(snap["cid"])

        def chunk(state, read):
            active, labels, medoids, cid = state
            active, labels, medoids, cid, left = _daura_extract(
                xv, cut2, ncm, active, labels, medoids, cid,
                checkpoint.every, read)
            return (active, labels, medoids, cid), not left

        def snapshot(state):
            act, lab, med = fetch_packed(*state[:3], site="fetch").result()
            return {"active": act, "labels": lab, "medoids": med,
                    "cid": state[3]}

        (_, labels, medoids, _), self.fit_info_ = checked_fit(
            "daura", checkpoint, health, x, fp, init, chunk, snapshot,
            restore)
        return fetch_packed(labels, medoids).result()

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


def _daura_extract(xv, cut2, ncm, active, labels, medoids, cid, max_new,
                   read):
    """Up to ``max_new`` greedy extractions of the streamed tiers, one
    ε-pass, one distance column and one read of ``any(active)`` each.
    Returns ``(active, labels, medoids, cid, any_left)``; ``medoids`` is
    updated in place."""
    m = xv.shape[0]
    ids = torch.arange(m, dtype=torch.int32, device=xv.device)
    left = True
    for _ in range(max_new):
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
        left = bool(read(active.any(), "daura"))
        if not left:
            break
    return active, labels, medoids, cid, left


def _daura_fit_streamed(xv, cutoff, n_atoms, ncm):
    """The tiled and ring tiers: one ε-pass ``ncm`` (as in
    ``cluster/dbscan._dbscan_fit_streamed``) and one host read per
    extracted cluster."""
    m = xv.shape[0]
    dev = xv.device
    cut2 = f32(f32(f32(cutoff) * f32(cutoff)) * n_atoms)
    active = torch.ones(m, dtype=torch.bool, device=dev)
    labels = torch.full((m,), -1, dtype=torch.int32, device=dev)
    medoids = torch.full((m,), -1, dtype=torch.int32, device=dev)
    cid, left = 0, True
    while left:
        active, labels, medoids, cid, left = _daura_extract(
            xv, cut2, ncm, active, labels, medoids, cid, 1, host_read)
    return labels, medoids
