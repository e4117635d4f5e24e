"""KMeans — the north-star estimator.

Counterpart of ``dislib_tpu/cluster/kmeans.py`` (dense).  Lloyd's iteration
runs on the device as the reference's ``lax.while_loop`` does, through
:func:`runtime.loop.run_chunked`: :func:`_kmeans_fit` enqueues masked steps
in chunks of ``loop.EVERY`` and reads ``shift >= tol`` once after each
chunk, so a fit stops at most ``EVERY − 1`` steps past convergence (at
``tol <= 0`` it runs ``max_iter`` steps with no read).  A step
is active only while ``shift >= tol``; an inactive step keeps the centers,
does not advance ``n_iter`` and does not write ``hist``, so the results
equal the reference's early-exiting loop.  ``fit`` reads them all back in
one transfer at the end.

Per step: the E-step is the hand CUDA kernel ``distances_sq``
(``ops/base.distances_sq(..., use_kernel=True)``), then argmin; the M-step
is ``onehotᵀ @ x`` as a plain f32-faithful product (it sits outside any
kernel of the reference too).  ``predict`` and ``score`` run the same
kernel.  ``fast_distance`` (or ``DSLIB_KMEANS_FAST_DISTANCE=1``) is the
reference's fast mode: the fit stores x once as bfloat16
(``ops/kernels.bf16_rows``) and hoists ‖x‖² once from the float32 x; the
E-step is the kernel's bf16-operand variant
(``ops/kernels.distances_sq_bf16``: the centers rounded to bf16 for the
cross term, their norms float32), while the M-step reads the float32 x, so
the centers stay exact sums; ``predict`` and ``score`` stay float32.
Padded rows (none on the one-device mesh) carry weight 0.
``fit`` is ``_fit_finalize(_fit_async(x))``: the async-trial hooks of the
search split it at its one transfer, and ``_score_async`` scores the
device centers as a device scalar.

A :class:`~data.sparse.SparseArray` takes the reference's native sparse
path (``_kmeans_fit_sparse``): the E-step's cross term is an SpMM with
``centersᵀ`` (``ops/spmm.spmm_rows``: each row's products summed in entry
order) beside the fixed-order row norms, and the M-step's per-cluster
sums are a fixed-order column reduce over a column-sorted copy of the
entries made once per fit — no atomics, so two fits with one seed are
bit-identical on the card.  The loop is ``run_chunked``, as the dense
fit's; ``predict`` and ``score`` take a SparseArray too.  The random
init gathers its k rows from the array's host CSR mirror, as the
reference gathers them from its host triplets (across ranks from their
owner ranks, ``SparseArray._dense_rows``).

``fit`` runs through :class:`~dislib_tpu_torch.runtime.ChunkedFitLoop`,
checkpointed or not, as the reference's does: one chunk of ``max_iter``
steps without a checkpoint, chunks of ``every`` steps with
``checkpoint=FitCheckpoint(path, every=k)``.  Each chunk is one call of
:func:`_kmeans_fit` (or :func:`_kmeans_fit_sparse`) from the carried
centers, and ONE packed read (``runtime.fetch_packed``) of its centers,
step count, inertia, shift, history and health vector: the guard judges
the health part under its watchdog, the deferred commit and the snapshot
take the rest from the same host buffer.  So an unchecked fit still
makes one read, and a NaN in the data raises ``NumericalDivergence``
(guard ``'nonfinite'``) instead of returning NaN centers.  ``fit_info_``
is the loop's resilience summary.

On a mesh of several ranks (the reference's ``_kmeans_fit``, its rows
sharded and its columns replicated): the fit all-gathers each rank's row
block over 'cols' once; the E-step runs ``distances_sq`` on the rank's
rows; ONE packed ``psum`` over 'rows' a step carries (sums, counts,
inertia), so the centers are the same on every rank, and so are the
shift, the health vector and every decision taken from them; the loop's
preemption flag is agreed across ranks (``distributed.any_rank``).
``predict`` returns a row-sharded label array and ``score`` is a
``psum``; the search hooks run the same sharded fit and score.
The sparse fit runs the same way on each rank's entries (the
reference's ``_kmeans_fit_sparse_sharded``): the E-step's SpMM on the
rank's rows against the replicated centersᵀ, the per-cluster column sums
local and in a fixed order, then the one packed ``psum``.
``checkpoint=`` raises there, naming ROADMAP.md A.11 (snapshots of
several ranks).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from dislib_tpu_torch.base import BaseEstimator
from dislib_tpu_torch.data.array import Array, _block_with
from dislib_tpu_torch.data.sparse import SparseArray
from dislib_tpu_torch.ops import kernels as _k
from dislib_tpu_torch.ops.base import distances_sq as _distances_sq, precise
from dislib_tpu_torch.ops.spmm import seg_sum, spmm_rows
from dislib_tpu_torch.parallel import distributed as _dist
from dislib_tpu_torch.parallel import mesh as _mesh
from dislib_tpu_torch.runtime import fitloop as _fitloop
from dislib_tpu_torch.runtime import health as _health
from dislib_tpu_torch.runtime.elastic import fetch as _fetch, fetch_packed
from dislib_tpu_torch.runtime.loop import run_chunked
from dislib_tpu_torch.utils.dlog import verbose_logger


class KMeans(BaseEstimator):
    """Lloyd's K-means.

    Parameters (reference parity; ``arity`` accepted and ignored)
    ----------
    n_clusters : int, default 8
    init : 'random' or ndarray (n_clusters, n_features)
    max_iter : int, default 10
    tol : float, default 1e-4 — convergence on ‖Δcenters‖².
    arity : int — ignored (reference reduction-tree fan-in).
    random_state : int or None
    verbose : bool — accepted for parity; the fit reads only its loop
        condition until it ends, so there is no per-iteration log.
    fast_distance : bool or None — the E-step on bf16 operands with
        float32 sums and norms (an assignment-only speed knob: a point
        near a tie may flip); None reads ``DSLIB_KMEANS_FAST_DISTANCE``.

    Attributes
    ----------
    centers_ : ndarray (n_clusters, n_features)
    n_iter_ : int
    inertia_ : float — within-cluster sum of squared distances.
    history_ : ndarray (n_iter_,) — per-iteration inertia.
    """

    _capturable = frozenset({"predict"})

    def __init__(self, n_clusters=8, init="random", max_iter=10, tol=1e-4,
                 arity=50, random_state=None, verbose=False,
                 fast_distance=None):
        self.n_clusters = n_clusters
        self.init = init
        self.max_iter = max_iter
        self.tol = tol
        self.arity = arity
        self.random_state = random_state
        self.verbose = verbose
        self.fast_distance = fast_distance

    def _fast(self) -> bool:
        if self.fast_distance is not None:
            return bool(self.fast_distance)
        return os.environ.get("DSLIB_KMEANS_FAST_DISTANCE", "0") == "1"

    def _check_supported(self, x):
        if not isinstance(x, (Array, SparseArray)):
            raise TypeError(
                f"KMeans on {type(x).__name__}: pass a ds-array (dense, or "
                "a SparseArray for sparse data)")

    # -- fitting -------------------------------------------------------------

    def _init_centers(self, x: Array) -> torch.Tensor:
        k, n = self.n_clusters, x.shape[1]
        if isinstance(self.init, (np.ndarray, list)):
            c = np.asarray(self.init, dtype=np.float32)
            if c.shape != (k, n):
                raise ValueError(f"init centers must be {(k, n)}, "
                                 f"got {c.shape}")
            return torch.from_numpy(c).to(x.device)
        if self.init != "random":
            raise ValueError(f"unsupported init {self.init!r}")
        rng = np.random.RandomState(_dist.agreed_seed(self.random_state,
                                                      x._mesh))
        # sample k distinct rows — the same draw as the reference
        idx = rng.choice(x.shape[0], size=min(k, x.shape[0]), replace=False)
        if isinstance(x, SparseArray):
            # the k chosen rows, duplicates summed, from their owner ranks
            rows = x._dense_rows(np.sort(idx)).to(torch.float32)
        else:
            rows = x[np.sort(idx), :]._gathered()[: len(idx), : n]
        if len(idx) < k:  # fewer samples than clusters: top up with jitter
            pick = torch.as_tensor(rng.randint(0, len(idx), k - len(idx)),
                                   device=rows.device)
            rows = torch.cat([rows, rows[pick] + 1e-3], dim=0)
        return rows

    def fit(self, x: Array, y=None, checkpoint=None, health=None):
        """Fit on ``x``: Lloyd steps on the device until ``shift < tol`` or
        ``max_iter``.  With ``checkpoint=FitCheckpoint(path, every=k)``
        the steps run in k-step chunks, each snapshotting (centers,
        n_iter); a re-run resumes from the snapshot.  ``health``: a
        :class:`~dislib_tpu_torch.runtime.HealthPolicy` (or a fault
        injector) for the chunk guard; the loop owns rollback, the
        watchdog and the preemption poll."""
        self._check_supported(x)
        sparse_in = isinstance(x, SparseArray)
        if checkpoint is not None and x._mesh.world > 1:
            raise NotImplementedError(
                "KMeans(checkpoint=...) on a ds-array sharded over several "
                "ranks: snapshots of a multi-rank fit are ROADMAP.md A.11")
        k, n = self.n_clusters, x.shape[1]
        box = {"x": x, "inertia": None}
        log = verbose_logger("kmeans", self.verbose)
        loop = _fitloop.ChunkedFitLoop(
            "kmeans", checkpoint=checkpoint, health=health,
            max_iter=self.max_iter, carry_names=("centers",),
            carry_shapes=((k, n),), snapshot_expect={"centers": (k, n)},
            elastic=_fitloop.data_rebind(box), mesh=x._mesh)

        def init(rem):
            box["inertia"] = None
            return _fitloop.LoopState(
                (rem.perturb(self._init_centers(box["x"])),))

        def restore(snap, rem):
            # centers' shape is judged by the rollback funnel
            # (snapshot_expect); a faulted chunk's inertia must not leak
            box["inertia"] = None
            centers = torch.from_numpy(np.asarray(
                rem.perturb(np.asarray(snap["centers"], np.float32))))
            return _fitloop.LoopState(
                (centers.to(box["x"].device),), it=int(snap["n_iter"]),
                done=bool(snap.get("converged", False)))

        def step(st, chunk):
            (centers,) = st.carries
            xd = box["x"]
            if sparse_in:
                out = _kmeans_fit_sparse(xd, centers, chunk,
                                         float(self.tol),
                                         read=loop.guard.read)
            else:
                out = _kmeans_fit(xd._row_block(), xd.shape, centers, chunk,
                                  float(self.tol), fast=self._fast(),
                                  read=loop.guard.read, mesh=xd._mesh,
                                  row0=xd._at[0])
            # the chunk's one read: results and health vector together
            pack = fetch_packed(*out)

            def commit():
                c_h, n_done, inertia, shift, _, _ = pack.result()
                box["inertia"] = float(inertia)
                it = st.it + int(n_done)
                log.info("iter %d: inertia=%.6g shift=%.3g", it,
                         float(inertia), float(shift))
                return _fitloop.LoopState((out[0],), it,
                                          float(shift) < self.tol,
                                          extra=c_h)

            def history():
                _, n_done, _, _, hist, _ = pack.result()
                return hist[: int(n_done)]

            return _fitloop.ChunkOutcome(commit, hvec=pack.part(5),
                                         history=history)

        def snapshot(st):
            # the host centers of the chunk's own read: no extra transfer
            return {"centers": st.extra, "n_iter": st.it,
                    "converged": st.done}

        st = loop.run(init=init, step=step, restore=restore,
                      snapshot=snapshot)
        # a resumed, already finished fit ran no chunk: its centers are
        # the snapshot's, on the device
        self.centers_ = st.extra if st.extra is not None \
            else _fetch(st.carries[0])
        self.n_iter_ = st.it
        self.history_ = np.asarray(loop.history, dtype=np.float64)
        self.fit_info_ = loop.info
        self.inertia_ = float(box["inertia"]) \
            if box["inertia"] is not None else -self.score(box["x"])
        return self

    # async trial protocol: the fit runs on the device with no host read
    # at tol <= 0; at tol > 0 its loop reads the stop condition once per
    # chunk of steps (runtime/loop.run_chunked, counted in HOST_READS),
    # where the reference's lax.while_loop reads nothing
    def _fit_async(self, x, y=None):
        self._check_supported(x)
        if isinstance(x, SparseArray):
            return _kmeans_fit_sparse(x, self._init_centers(x),
                                      int(self.max_iter), float(self.tol))
        return _kmeans_fit(x._row_block(), x.shape, self._init_centers(x),
                           int(self.max_iter), float(self.tol),
                           fast=self._fast(), mesh=x._mesh, row0=x._at[0])

    def _fit_finalize(self, state):
        if state is None:
            return
        centers, n_iter, inertia, _, hist, _ = _to_host(*state)
        self.centers_ = centers
        self.n_iter_ = int(n_iter)
        self.inertia_ = float(inertia)
        self.history_ = np.asarray(hist[: self.n_iter_], dtype=np.float64)

    def _score_async(self, state, x, y=None):
        if state is None:
            return super()._score_async(state, x, y)
        self._check_supported(x)
        if isinstance(x, SparseArray):
            return _sparse_score(x, state[0])
        return _dist.psum(_kmeans_score(x._row_block(), x.shape, state[0],
                                        x._at[0]), _mesh.ROWS, x._mesh)

    def fit_predict(self, x: Array, y=None) -> Array:
        return self.fit(x).predict(x)

    def predict(self, x: Array) -> Array:
        """Cluster index per row, an (m, 1) int32 ds-array."""
        self._check_fitted()
        self._check_supported(x)
        if isinstance(x, SparseArray):
            d = _sparse_distances(x, self._centers_on(x))
            labels = torch.argmin(d, dim=1).to(torch.int32)[:, None]
            # this rank's rows, pad rows zeroed
            return Array._from_rows(labels, (x.shape[0], 1), x._mesh)
        labels = _kmeans_predict(x._row_block(), x.shape, self._centers_on(x),
                                 x._at[0])
        if x._mesh.world > 1:
            return Array(_block_with(labels, (x._at[0], 0), (x.shape[0], 1),
                                     x._mesh),
                         (x.shape[0], 1), x._mesh)
        return Array._from_padded(labels, (x.shape[0], 1), x._mesh)

    def score(self, x: Array, y=None) -> float:
        """Negative inertia on x (sklearn convention)."""
        self._check_fitted()
        self._check_supported(x)
        if isinstance(x, SparseArray):
            return float(_sparse_score(x, self._centers_on(x)))
        return float(_dist.psum(
            _kmeans_score(x._row_block(), x.shape, self._centers_on(x),
                          x._at[0]), _mesh.ROWS, x._mesh))

    def _carry_in(self, arrays: dict, device):
        self.centers_ = np.array(arrays["centers_"], np.float32)

    def _centers_on(self, x: Array) -> torch.Tensor:
        # the device copy is cached per model (no host → device copy in a
        # warm predict, so a served predict can be captured)
        (centers,) = self._predict_leaves(x.device, self.centers_)
        return centers

    def _check_fitted(self):
        if not hasattr(self, "centers_"):
            raise RuntimeError("KMeans is not fitted")


def _to_host(*tensors):
    """Read device tensors back in ONE transfer (``runtime.fetch_packed``:
    packed into float64, exact for float32 and int32 values), counted as
    one host read under ``"results"``."""
    return fetch_packed(*tensors).result()


# ---------------------------------------------------------------------------
# device kernels
# ---------------------------------------------------------------------------

def _crop(xp: torch.Tensor, shape, row0=0):
    """Crop padded columns (the kernel takes contiguous rows) and weight
    padded rows 0; ``xp``'s first row is global row ``row0``."""
    m, n = shape
    xv = xp[:, :n]
    if not xv.is_contiguous():
        xv = xv.contiguous()
    w = (torch.arange(xv.shape[0], device=xv.device) < m - row0).to(xv.dtype)
    return xv, w


@precise
def _kmeans_fit(xp, shape, centers0, max_iter, tol, fast=False, read=None,
                mesh=None, row0=0):
    """Lloyd steps on the padded backing ``xp`` of logical ``shape`` from
    ``centers0`` until ``shift < tol`` or ``max_iter`` (the reference's
    ``cond``), in chunks of masked steps (:func:`run_chunked`).  ``fast``:
    the E-step on the bf16 copy of x stored here once, with ‖x‖² hoisted
    from the float32 x.  Returns ``(centers, n_iter, inertia, shift, hist,
    hvec)`` as device tensors — the reference's 6-tuple.  ``read``: the
    loop's stop-flag read (``run_chunked``'s).  On a ``mesh`` with a
    process group ``xp`` is this rank's rows (the first is global row
    ``row0``) and each step's (sums, counts, inertia) is one packed
    ``psum`` over 'rows'."""
    xv, w = _crop(xp, shape, row0)
    ranks = mesh is not None and mesh.groups is not None
    if fast:
        x16 = _k.bf16_rows(xv)
        x_sq = torch.sum(xv * xv, dim=1)
    k, n = centers0.shape
    dev, dt = xv.device, xv.dtype
    centers = centers0.to(device=dev, dtype=dt).contiguous()
    cluster_ids = torch.arange(k, device=dev)
    shift = torch.full((), float("inf"), dtype=dt, device=dev)
    n_iter = torch.zeros((), dtype=torch.int32, device=dev)
    inertia = torch.zeros((), dtype=dt, device=dev)
    hist = torch.zeros((max_iter,), dtype=dt, device=dev)

    def step(t):
        nonlocal centers, shift, n_iter, inertia
        active = shift >= tol
        d = _k.distances_sq_bf16(x16, x_sq, centers) if fast else \
            _distances_sq(xv, centers, use_kernel=True)
        min_d, labels = torch.min(d, dim=1)   # first index on ties
        onehot = (labels[:, None] == cluster_ids).to(dt) * w[:, None]
        sums = onehot.T @ xv                  # (k, n)
        counts = onehot.sum(dim=0)            # (k,)
        step_inertia = torch.sum(min_d * w)
        if ranks:
            packed = _dist.psum(torch.cat([sums.reshape(-1), counts,
                                           step_inertia.reshape(1)]),
                                _mesh.ROWS, mesh)
            sums = packed[: k * n].view(k, n)
            counts, step_inertia = packed[k * n: k * n + k], packed[-1]
        new_centers = torch.where(
            counts[:, None] > 0,
            sums / torch.clamp_min(counts, 1.0)[:, None], centers)
        step_shift = torch.sum((new_centers - centers) ** 2)
        centers = torch.where(active, new_centers, centers).contiguous()
        shift = torch.where(active, step_shift, shift)
        inertia = torch.where(active, step_inertia, inertia)
        hist[t] = torch.where(active, step_inertia, hist[t])
        n_iter = n_iter + active.to(torch.int32)

    # at tol <= 0 only a NaN shift stops the loop, and the masks already
    # freeze the state after one
    run_chunked(step, None if tol <= 0 else lambda: shift >= tol, max_iter,
                "kmeans", read=read)
    hvec = _health.health_vec(carries=(centers,), hist=hist, n_done=n_iter)
    return centers, n_iter, inertia, shift, hist, hvec


@precise
def _kmeans_predict(xp, shape, centers, row0=0):
    xv, w = _crop(xp, shape, row0)
    d = _distances_sq(xv, centers.to(xv.dtype).contiguous(), use_kernel=True)
    # labels stay int32; padded rows get label 0 (the Array invariant)
    labels = torch.argmin(d, dim=1).to(torch.int32) * w.to(torch.int32)
    return labels[:, None].contiguous()


@precise
def _kmeans_score(xp, shape, centers, row0=0):
    xv, w = _crop(xp, shape, row0)
    d = _distances_sq(xv, centers.to(xv.dtype).contiguous(), use_kernel=True)
    return -torch.sum(torch.min(d, dim=1).values * w)


# ---------------------------------------------------------------------------
# the sparse path
# ---------------------------------------------------------------------------

def _sparse_distances(x: SparseArray, centers, rowsq=None):
    """Squared distances (m, k) of the rows of ``x`` to ``centers``: the
    cross term one SpMM with ``centersᵀ``, clamped at zero."""
    centers = centers.to(torch.float32)
    if rowsq is None:
        rowsq = x.row_norms_sq()
    c_sq = torch.sum(centers * centers, dim=1)
    cross = spmm_rows(x._row_len, x._cols, x._vals, centers.T.contiguous())
    return torch.clamp_min(rowsq[:, None] - 2.0 * cross + c_sq[None, :], 0.0)


def _row_weights(x: SparseArray):
    """(m_local,) 1 on this rank's rows of the matrix, 0 on its padding
    rows (on one rank all 1: no padding rows)."""
    return (torch.arange(x._m_local, device=x.device)
            < x._live_rows()).to(torch.float32)


def _sparse_score(x: SparseArray, centers):
    """Negative inertia of the sparse ``x`` (a device scalar; across
    ranks each rank's rows, then one ``psum`` over 'rows')."""
    d = _sparse_distances(x, centers).amin(1)
    w = _row_weights(x)
    return -_dist.psum(torch.sum(d * w).reshape(1), _mesh.ROWS, x._mesh)[0]


def _kmeans_fit_sparse(x: SparseArray, centers0, max_iter, tol, read=None):
    """Lloyd steps on the sparse ``x`` (the reference's
    ``_kmeans_fit_sparse_sharded``), masked and chunked as
    :func:`_kmeans_fit`.  The per-cluster sums ``xᵀ onehot`` are one
    fixed-order column reduce: the entries sorted by column once, each
    column's products summed in order.  On every mesh each rank runs the
    E-step on its rows (padding rows weighted 0) and ONE packed ``psum``
    over 'rows' a step carries (sums, counts, inertia): the identity on
    one rank.  Returns the reference's 6-tuple."""
    dev, dt = x.device, torch.float32
    mesh = x._mesh
    w = _row_weights(x)
    k, n = centers0.shape
    rowsq = x.row_norms_sq()
    c_rows, _, c_vals, col_len = x._by_col()
    c_rows = c_rows.to(torch.int64)
    centers = centers0.to(device=dev, dtype=dt).contiguous()
    cluster_ids = torch.arange(k, device=dev)
    shift = torch.full((), float("inf"), dtype=dt, device=dev)
    n_iter = torch.zeros((), dtype=torch.int32, device=dev)
    inertia = torch.zeros((), dtype=dt, device=dev)
    hist = torch.zeros((max_iter,), dtype=dt, device=dev)

    def step(t):
        nonlocal centers, shift, n_iter, inertia
        active = shift >= tol
        d = _sparse_distances(x, centers, rowsq)
        min_d, labels = torch.min(d, dim=1)   # first index on ties
        onehot = (labels[:, None] == cluster_ids).to(dt)
        onehot = onehot * w[:, None]
        counts = onehot.sum(dim=0)
        # sums[c] = Σ over the entries of column c of val · onehot[row]
        # (padding rows have no entries)
        part = (labels[c_rows][:, None] == cluster_ids).to(dt) \
            * c_vals[:, None]
        sums = seg_sum(part, col_len).T                   # (k, n)
        step_inertia = torch.sum(min_d * w)
        packed = _dist.psum(torch.cat([sums.reshape(-1), counts,
                                       step_inertia.reshape(1)]),
                            _mesh.ROWS, mesh)
        sums = packed[: k * n].view(k, n)
        counts, step_inertia = packed[k * n: k * n + k], packed[-1]
        new_centers = torch.where(
            counts[:, None] > 0,
            sums / torch.clamp_min(counts, 1.0)[:, None], centers)
        step_shift = torch.sum((new_centers - centers) ** 2)
        centers = torch.where(active, new_centers, centers).contiguous()
        shift = torch.where(active, step_shift, shift)
        inertia = torch.where(active, step_inertia, inertia)
        hist[t] = torch.where(active, step_inertia, hist[t])
        n_iter = n_iter + active.to(torch.int32)

    run_chunked(step, None if tol <= 0 else lambda: shift >= tol, max_iter,
                "kmeans", read=read)
    hvec = _health.health_vec(carries=(centers,), hist=hist, n_done=n_iter)
    return centers, n_iter, inertia, shift, hist, hvec
