"""DBSCAN — density-based clustering.

Counterpart of ``dislib_tpu/cluster/dbscan.py``: core points from the
ε-neighbour counts, clusters as the connected components of the core-core
graph by min-label propagation with pointer jumping (O(log n) rounds),
border points joined to the least label among their core neighbours, the
rest noise (−1).  The reference's grid knobs (``n_regions``,
``dimensions``, ``max_samples``) are accepted and ignored, as there.

Three tiers, chosen as the reference chooses them:

- **dense** (padded rows ≤ :data:`_DENSE_MAX`): one (m, m) distance matrix
  through the hand ``distances_sq`` kernel, a resident boolean adjacency,
  and a round is a masked min-reduce over it;
- **tiled** (above it): every reduce is a streamed ε-pass of
  ``ops/tiled.neigh_count_min`` — one for the core counts, one per
  propagation round, one for the border labels — so memory is
  O(tile · m), never O(m²);
- **ring** (``ring_auto``: forced by :data:`_RING`, or a mesh of more
  than one row above :data:`_DENSE_MAX`): the tiled tier's passes through
  ``ops/ring.ring_neigh_count_min``.

The reference's ``lax.while_loop`` stops when a round changes no label;
here the host reads that flag (``utils/profiling.host_read``, site
``"dbscan"``).  The tiers read it differently because their rounds cost
differently.  A dense round is a cheap masked reduce over the resident
adjacency, so rounds run in chunks of ``loop.EVERY`` through
``runtime/loop.run_chunked`` with one read a chunk; a round past the
fixpoint changes nothing.  A tiled or ring round is a whole O(m²) ε-pass,
and a round past the stop would pay a full pass, so they read once per
round.  The labels, the core mask and the input's non-finite count come
back in one read (``"results"``).

The fit runs through :class:`~dislib_tpu_torch.runtime.ChunkedFitLoop`,
as the reference's does.  Unchecked, it is one chunk: the whole fit on
the tier above, its health vector over the INPUT (labels are integral:
there is no numeric trajectory to diverge), read with the labels and the
core mask in one transfer; a non-finite coordinate, which makes every
ε-comparison false, raises ``NumericalDivergence`` (guard
``"input-nonfinite"``).  With ``checkpoint=FitCheckpoint(path, every=k)``
the fit runs the streamed passes (ring where the plain fit would take
it, tiled otherwise, at any size): setup, then chunks of k propagation
rounds, each snapshotting the label vector and the core mask, then the
border pass.  Min-label propagation converges to the same labels from
any intermediate state, so a resumed fit ends where the uninterrupted
one does.
"""

from __future__ import annotations

import numpy as np
import torch

from dislib_tpu_torch.base import BaseEstimator
from dislib_tpu_torch.data.array import Array
from dislib_tpu_torch.data.sparse import dense_input
from dislib_tpu_torch.ops import kernels as _k
from dislib_tpu_torch.ops import overlap as _ov
from dislib_tpu_torch.ops import tiled as _tiled
from dislib_tpu_torch.ops.ring import ring_auto, ring_neigh_count_min
from dislib_tpu_torch.runtime import fitloop as _fitloop
from dislib_tpu_torch.runtime import health as _health
from dislib_tpu_torch.runtime.elastic import fetch_packed
from dislib_tpu_torch.runtime.loop import run_chunked
from dislib_tpu_torch.utils.profiling import host_read

# padded row counts above this stream the adjacency in tiles instead of
# materialising the m×m matrix (module-level so tests can force the path)
_DENSE_MAX = 16384

# ring-distribute the streamed passes: None = auto (a mesh of more than one
# row shard and past _DENSE_MAX), True/False force (module-level so tests
# can force the path)
_RING = None


def one_chunk_fit(name, health, run, xv):
    """The unchecked fit of DBSCAN and Daura: one chunk of the fit loop
    running ``run()`` (a tuple of device tensors), judged on the health
    vector over the input ``xv`` (a non-finite coordinate raises
    ``NumericalDivergence``, guard ``"input-nonfinite"``), read with the
    results in one transfer.  Returns ``(host results, fit_info)``."""
    loop = _fitloop.ChunkedFitLoop(name, health=health)

    def step(st, chunk):
        out = run()
        pack = fetch_packed(*out, _health.health_vec(inputs=(xv,)))
        return _fitloop.ChunkOutcome(
            lambda: _fitloop.LoopState((), 0, True,
                                       extra=pack.result()[:-1]),
            hvec=pack.part(len(out)))

    st = loop.run(init=lambda rem: _fitloop.LoopState(()), step=step)
    return st.extra, loop.info


def checked_fit(name, checkpoint, health, x, fp, init, chunk, snapshot,
                restore):
    """The checkpointed fit of DBSCAN and Daura: chunks of ``chunk(state,
    read) -> (state, done)`` from ``init()`` or ``restore(snap)``, each
    judged on the input's health vector and snapshotted as
    ``snapshot(state)`` (plus ``fp`` and the data digest).  Returns
    ``(final state, fit_info)``."""
    from dislib_tpu_torch.utils.checkpoint import (data_digest,
                                                   validate_snapshot)
    xv = x._data[: x.shape[0], : x.shape[1]]
    digest = data_digest(x._data)
    loop = _fitloop.ChunkedFitLoop(name, checkpoint=checkpoint,
                                   health=health,
                                   elastic=_fitloop.data_rebind({"x": x}))

    def _restore(snap, rem):
        validate_snapshot(snap, fp, digest)
        return _fitloop.LoopState((), extra=restore(snap))

    def step(st, n):
        state, done = chunk(st.extra, loop.guard.read)
        return _fitloop.ChunkOutcome(
            _fitloop.LoopState((), st.it + 1, done, extra=state),
            hvec=_health.health_vec(inputs=(xv,)))

    def _snapshot(st):
        return {**snapshot(st.extra), "fp": fp, "digest": digest}

    st = loop.run(init=lambda rem: _fitloop.LoopState((), extra=init()),
                  step=step, restore=_restore, snapshot=_snapshot)
    return st.extra, loop.info


def labels_array(labels: np.ndarray, mesh) -> Array:
    """Per-row labels as an (m, 1) int32 ds-array (``fit_predict``)."""
    lab = torch.from_numpy(labels.astype(np.int32)[:, None])
    return Array._from_logical(lab, mesh)


def f32(v) -> float:
    """``v`` rounded to float32, as the reference's traced scalars are."""
    return float(np.float32(v))


class DBSCAN(BaseEstimator):
    """Density-based clustering.

    Parameters (reference parity)
    ----------
    eps : float, default 0.5 — ε-neighbourhood radius.
    min_samples : int, default 5 — neighbours (incl. self) to be a core
        point.
    n_regions, dimensions, max_samples — accepted and ignored.

    Attributes
    ----------
    labels_ : ndarray (n_samples,) int64 — cluster ids 0..k−1, noise −1,
        numbered by first appearance.
    n_clusters_ : int
    core_sample_indices_ : ndarray int — indices of core points.
    """

    def __init__(self, eps=0.5, min_samples=5, n_regions=1, dimensions=None,
                 max_samples=None):
        self.eps = eps
        self.min_samples = min_samples
        self.n_regions = n_regions
        self.dimensions = dimensions
        self.max_samples = max_samples

    def fit(self, x: Array, y=None, checkpoint=None, health=None):
        """Fit.  With ``checkpoint=FitCheckpoint(path, every=k)`` the label
        vector snapshots every k propagation rounds of the streamed tier,
        and a re-run resumes the propagation from the snapshot.
        ``health``: the loop's guard policy (it watches the input)."""
        x = dense_input(x, "DBSCAN")
        m, n = x.shape
        mesh = x._mesh
        eps, ms = float(self.eps), int(self.min_samples)
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
            raw, core = self._fit_checkpointed(x, xv, ncm, checkpoint,
                                               health)
        else:
            if ring or x._data.shape[0] > _DENSE_MAX:
                def run():
                    return _dbscan_fit_streamed(xv, eps, ms, ncm)
            else:
                def run():
                    return _dbscan_fit(xv, eps, ms)
            (raw, core), self.fit_info_ = one_chunk_fit("dbscan", health,
                                                        run, xv)
        # renumber root labels compactly in order of first appearance
        clustered = raw >= 0
        roots, first, inverse = np.unique(raw[clustered], return_index=True,
                                          return_inverse=True)
        rank = np.empty(len(roots), dtype=np.int64)
        rank[np.argsort(first, kind="stable")] = np.arange(len(roots))
        labels = np.full(m, -1, dtype=np.int64)
        labels[clustered] = rank[inverse]
        self.labels_ = labels
        self.n_clusters_ = len(roots)
        self.core_sample_indices_ = np.nonzero(core)[0]
        return self

    def _fit_checkpointed(self, x, xv, ncm, checkpoint, health):
        """The streamed passes in chunks of ``every`` propagation rounds,
        the (label, core) state snapshotted between chunks; returns the
        host (raw labels, core mask)."""
        eps, ms = float(self.eps), int(self.min_samples)
        m = xv.shape[0]
        eps2 = f32(f32(eps) * f32(eps))
        fp = np.asarray([x.shape[0], x.shape[1], eps, ms], np.float64)

        def init():
            return _streamed_setup(xv, eps2, ms, ncm)

        def restore(snap):
            lab = np.asarray(snap["label"])[:m]
            # labels are core row ids (< m) with "no label" = the
            # writer's sentinel: re-base it to this fit's (m)
            lab = np.where(lab < m, lab, m).astype(np.int32)
            return (torch.from_numpy(lab).to(xv.device),
                    torch.from_numpy(np.asarray(snap["core"])[:m]
                                     .astype(bool)).to(xv.device))

        def chunk(state, read):
            label, core = state
            label, changed = _streamed_rounds(xv, eps2, label, core, ncm,
                                              checkpoint.every, read)
            return (label, core), not changed

        def snapshot(state):
            lab, core = fetch_packed(*state, site="fetch").result()
            return {"label": lab, "core": core}

        (label, core), self.fit_info_ = checked_fit(
            "dbscan", checkpoint, health, x, fp, init, chunk, snapshot,
            restore)
        _, border = ncm(xv, eps2, label, core, m, counts=False)
        return fetch_packed(_final(label, core, border, m), core).result()

    def fit_predict(self, x: Array, y=None) -> Array:
        self.fit(x)
        return labels_array(self.labels_, x._mesh)


def _jump(new, sentinel):
    """Pointer jump: follow each label one hop, ``new[min(new, mp − 1)]``
    where it is below the sentinel (gathered at int64)."""
    hop = new[new.clamp(max=new.shape[0] - 1).to(torch.int64)]
    return torch.minimum(new, torch.where(new < sentinel, hop, sentinel))


def _final(label, core, border, sentinel):
    """Core points keep their root, the rest take their border label; no
    label is −1."""
    final = torch.where(core, label, border)
    return torch.where(final < sentinel, final, -1)


def _dbscan_fit(xv, eps, min_samples):
    """The dense tier on the (m, n) rows ``xv``: returns (raw root labels
    int32 with −1 for noise, core mask)."""
    m = xv.shape[0]
    dev = xv.device
    sentinel = m
    eps2 = f32(f32(eps) * f32(eps))
    adj = _k.distances_sq(xv, xv) <= eps2
    # self-distance is 0: make the diagonal structurally True
    adj.fill_diagonal_(True)
    core = adj.sum(1) >= min_samples
    core_adj = adj & core[:, None] & core[None, :]
    ids = torch.arange(m, dtype=torch.int32, device=dev)
    state = {"label": torch.where(core, ids, sentinel),
             "changed": torch.ones((), dtype=torch.bool, device=dev)}
    sent = torch.tensor(sentinel, dtype=torch.int32, device=dev)

    def step(t):
        label = state["label"]
        # min label among core neighbours (row i of core_adj is all-False
        # for non-core i, so non-core labels stay at the sentinel); the
        # (m, m) int32 block is freed when the round ends
        neigh = torch.where(core_adj, label[None, :], sent).amin(1)
        new = _jump(torch.minimum(label, neigh), sentinel)
        state["changed"] = (new != label).any()
        state["label"] = new

    run_chunked(step, lambda: state["changed"], m + 1, "dbscan")
    del core_adj
    label = state["label"]
    border = torch.where(adj & core[None, :], label[None, :], sent).amin(1)
    return _final(label, core, border, sentinel), core


def _streamed_setup(xv, eps2, min_samples, ncm):
    """The streamed tiers' setup: one ε-pass for the core counts; returns
    ``(label, core)`` with every core point its own label."""
    m = xv.shape[0]
    ids = torch.arange(m, dtype=torch.int32, device=xv.device)
    valid = torch.ones(m, dtype=torch.bool, device=xv.device)
    counts, _ = ncm(xv, eps2, ids, valid, m, mins=False)
    core = counts >= min_samples
    return torch.where(core, ids, m), core


def _streamed_rounds(xv, eps2, label, core, ncm, max_rounds, read):
    """Up to ``max_rounds`` propagation rounds, one ε-pass and one read of
    ``changed`` each; returns ``(label, changed)`` (``changed`` False once
    a round changed nothing)."""
    m = xv.shape[0]
    changed = True
    for _ in range(max_rounds):
        _, neigh = ncm(xv, eps2, label, core, m, counts=False)
        new = _jump(torch.where(core, torch.minimum(label, neigh), m), m)
        flag = (new != label).any()
        label = new
        changed = bool(read(flag, "dbscan"))
        if not changed:
            break
    return label, changed


def _dbscan_fit_streamed(xv, eps, min_samples, ncm):
    """The tiled and ring tiers: setup (one ε-pass for the core counts),
    propagation (one pass and one host read per round), finalize (one
    pass for the border labels).  ``ncm(xv, eps2, vals, colmask,
    sentinel, counts=, mins=)`` is the ε-pass."""
    m = xv.shape[0]
    eps2 = f32(f32(eps) * f32(eps))
    label, core = _streamed_setup(xv, eps2, min_samples, ncm)
    changed = True
    while changed:
        label, changed = _streamed_rounds(xv, eps2, label, core, ncm, 1,
                                          host_read)
    _, border = ncm(xv, eps2, label, core, m, counts=False)
    return _final(label, core, border, m), core
