"""ALS collaborative filtering on one card.

Counterpart of ``dislib_tpu/recommendation/als.py``.  Each sweep solves
every user's regularised normal equations against the item factors, then
every item's against the new user factors, with the reference's weighted
ridge λ·max(n_u, 1) (Zhou et al.).  A rating of 0 is unobserved, in the
dense mask and in the sparse entries alike.

- **Dense ratings** (``_solve_factors``, the reference's): counts = the
  mask's row sums, ``b = r @ v``, ``a = mask @ (v ⊗ v)`` as one
  (m, n)×(n, f²) product, ``a += λ·max(count, 1)·I``, then a batched
  Cholesky solve.  The reference computes this with XLA and no Pallas
  kernel, so here it is cuBLAS products through ``ops/precision.pdot``
  (TF32 off) and cuSOLVER's batched Cholesky.
- **A SparseArray** (``_als_fit_sparse``, the reference's sparse path at
  one rank) never densifies the ratings.  The user half-step sums over
  the row-sorted entries, the item half-step over the column-sorted copy
  (``SparseArray._by_col``).  Each row's Σ g gᵀ (g = V[col]·w, w =
  ``value != 0``) and Σ r·g are ``torch.segment_reduce`` sums over the
  row's contiguous entries, in entry order, so two fits with one seed give
  the same bits on the card (never ``index_add_``, whose CUDA atomics add
  in a varying order).  The (nnz, f²) outer products are formed in
  row-aligned chunks of at most :data:`SPARSE_BUDGET_BYTES` (no row is
  split, so a row's sum never spans two chunks).  The reference's cap,
  2²² elements, was set for a TPU's memory; an H100 has 80 GB, and 1 GiB
  of products a chunk keeps the intermediate near 1% of it while each
  ``segment_reduce`` covers ~10⁶ entries at f = 16 (10 chunks a half-step
  at 10⁷ ratings).
- **The fit loop.** The reference's ``lax.while_loop`` until
  |ΔRMSE| < tol becomes masked steps under ``runtime/loop.run_chunked``:
  one host read per chunk of ``loop.EVERY`` sweeps, none at tol ≤ 0; a
  sweep past convergence leaves the factors, the RMSE, ``n_iter`` and the
  history as they were, as the reference's ``cond`` stops it.  The
  results come back in one transfer (``HOST_READS["results"]``); a
  sparse fit also reads its row and column entry counts once each
  (``HOST_READS["sparse"]``) to plan its chunks.
- **Random draws.** V₀ is :func:`_draw_items` at the logical (n, f), a
  uniform draw from a ``torch.Generator`` seeded with ``random_state``
  (the reference draws threefry ``uniform``; the parity tests hand that
  draw in here), the same on every mesh.  U₀ is never read before the
  first user half-step overwrites it.
- **Fold-in** (``fold_in``, ``_fold_in_device``, ``_fold_in_body``):
  new users' normal equations against the frozen item factors, solved
  and scored in one pass, the top ``top_n`` items picked in the same
  call.  ``_als_fold_in_packed`` unpacks the serving form ``[cols |
  vals]``, which ``serving/sparse.SparseFoldInPipeline`` replays as one
  CUDA graph a batch (the batched Cholesky is ``cholesky_ex`` and two
  triangular solves, with no host check).

- **The chunked fit.** ``fit`` runs through
  :class:`~dislib_tpu_torch.runtime.ChunkedFitLoop`, as the reference's
  does: one chunk of ``max_iter`` sweeps without a checkpoint,
  ``every``-sweep chunks with ``checkpoint=FitCheckpoint(...)``, each
  chunk starting from the carried factors and RMSE.  Each chunk's
  factors, RMSE, counters, history and health vector come back in ONE
  packed read, so an unchecked fit still reads once, a NaN rating raises
  ``NumericalDivergence`` (guard ``'nonfinite'``), and a snapshot's
  factors (with the logical ``m``, ``n``) are the chunk's own host
  copies.  The ``'halve'`` action scales λ by ``rem.damping``.

- **Across ranks** (a mesh of several ranks, and a world of one, whose
  collectives run over groups of one).  Dense (the reference's
  ``_als_fit`` with the ratings held to the data sharding): each rank's
  (m_local, n_local) block of ratings and mask; the user half-step's
  ``mask @ (v ⊗ v)``, ``r @ v`` and counts are ONE packed ``psum`` over
  'cols', the item half-step's ``maskᵀ @ (u ⊗ u)``, ``rᵀ @ u`` and counts
  one over 'rows'; V (n, f) is replicated (each rank's solved items
  all-gathered over 'cols'), U holds the mesh row's users.  Sparse (the
  reference's ``_als_fit_sparse``): the user half-step is local to the
  rank, whose entries are its users'; the item half-step sums the rank's
  column-sorted partials (A, b), then one ``psum`` over 'rows' (the item
  counts once a fit).  The RMSE's sums are ``psum``-ed, so every rank
  takes the same stop decision.  At the end U is all-gathered over
  'rows': ``users_`` and ``items_`` are the full host arrays on every
  rank.  ``checkpoint=`` across ranks raises (ROADMAP.md A.11).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dislib_tpu_torch.base import BaseEstimator
from dislib_tpu_torch.cluster.kmeans import _to_host
from dislib_tpu_torch.data.array import Array, _block_geom
from dislib_tpu_torch.data.sparse import SparseArray, nse_quantum
from dislib_tpu_torch.ops import precision as px
from dislib_tpu_torch.ops.base import cholesky_nan, precise
from dislib_tpu_torch.ops.spmm import seg_sum
from dislib_tpu_torch.parallel import distributed as _dist
from dislib_tpu_torch.parallel import mesh as _mesh
from dislib_tpu_torch.runtime import fitloop as _fitloop
from dislib_tpu_torch.runtime import health as _health
from dislib_tpu_torch.runtime.elastic import fetch as _fetch, fetch_packed
from dislib_tpu_torch.runtime.loop import run_chunked
from dislib_tpu_torch.utils.dlog import verbose_logger
from dislib_tpu_torch.utils.profiling import count_read

#: bytes of (entries, f²) float32 outer products one chunk of a sparse
#: half-step may hold (module-level so tests can shrink it)
SPARSE_BUDGET_BYTES = 1 << 30


class ALS(BaseEstimator):
    """Alternating Least Squares matrix factorisation.

    Parameters (reference parity: ``dislib_tpu.recommendation.ALS``)
    ----------
    n_f : int, default 8 — number of latent factors.
    lambda_ : float, default 0.065 — ridge strength, weighted by each
        row's rating count.
    tol : float, default 1e-4 — convergence on |ΔRMSE| between sweeps.
    max_iter : int, default 100
    random_state : int or None
    verbose : bool — logs each chunk's RMSE under ``dslib.als``.
    arity : int — accepted and ignored.

    Attributes
    ----------
    users_ : ndarray (n_users, n_f)
    items_ : ndarray (n_items, n_f)
    converged_ : bool
    n_iter_ : int
    rmse_ : float — the RMSE over the convergence ratings at the last
        sweep.
    history_ : ndarray (n_iter_,) — the per-sweep RMSE.
    """

    # the served fold-in (serving/sparse.py: ``_als_fold_in_packed`` on
    # a staged packed batch) has no host read once the item factors are
    # on the device; ``fold_in`` itself packs and reads on the host
    _capturable = frozenset({"fold_in"})

    def __init__(self, n_f=8, lambda_=0.065, tol=1e-4, max_iter=100,
                 random_state=None, verbose=False, arity=48):
        self.n_f = n_f
        self.lambda_ = lambda_
        self.tol = tol
        self.max_iter = max_iter
        self.random_state = random_state
        self.verbose = verbose
        self.arity = arity

    def fit(self, x, test=None, checkpoint=None, health=None):
        """Factorise the ratings ``x`` (users × items, 0 = unobserved), a
        ds-array or a :class:`SparseArray`.  ``test``: held-out ratings of
        the same shape (ndarray, scipy sparse, ds-array or SparseArray;
        0 = unobserved) whose RMSE decides convergence instead of the
        training ratings'.  ``checkpoint``: a ``FitCheckpoint`` — sweeps
        run in ``every``-sweep chunks, each snapshotting (users, items,
        rmse, n_iter, the logical m and n); a re-run resumes from it.
        ``health``: the chunk guard's policy; ``'halve'`` doubles
        ``lambda_`` per restart."""
        if self.max_iter < 1:
            raise ValueError("max_iter must be >= 1")
        sparse_in = isinstance(x, SparseArray)
        if not sparse_in and not isinstance(x, Array):
            raise TypeError(f"ALS takes a ds-array or a SparseArray, got "
                            f"{type(x).__name__}")
        if checkpoint is not None and x._mesh.world > 1:
            raise NotImplementedError(
                "ALS(checkpoint=...) on ratings sharded over several ranks: "
                "snapshots of a multi-rank fit are ROADMAP.md A.11")
        m, n = x.shape
        nf = int(self.n_f)
        seed = self.random_state if self.random_state is not None else 0
        if sparse_in:
            t = x if test is None else _test_sparse(test, x)
            rows_u, rows_v = m, n
        else:
            t = x._local if test is None else _test_dense(test, x)
            rows_u, rows_v = x._pshape
        box = {"lam": float(self.lambda_), "rmse": np.inf}
        log = verbose_logger("als", self.verbose)
        loop = _fitloop.ChunkedFitLoop(
            "als", checkpoint=checkpoint, health=health,
            max_iter=self.max_iter, carry_names=("users", "items"),
            carry_shapes=((m, nf), (n, nf)),
            # the stored factor rows may carry another padding: only the
            # logical dims and the factor width are pinned
            snapshot_expect={"m": int(m), "n": int(n),
                             "users": (None, nf), "items": (None, nf)},
            elastic=_fitloop.data_rebind({"x": x}), mesh=x._mesh)

        def init(rem):
            box["lam"] = float(self.lambda_) * rem.damping
            box["rmse"] = np.inf
            return _fitloop.LoopState(())   # fresh: the fit draws V0

        def restore(snap, rem):
            box["lam"] = float(self.lambda_) * rem.damping
            box["rmse"] = float(snap["rmse"])
            sm, sn = int(snap["m"]), int(snap["n"])
            u = _repad(rem.perturb(np.asarray(snap["users"], np.float32)),
                       sm, rows_u)
            v = _repad(rem.perturb(np.asarray(snap["items"], np.float32)),
                       sn, rows_v)
            return _fitloop.LoopState(
                (torch.from_numpy(u).to(x.device),
                 torch.from_numpy(v).to(x.device)),
                it=int(snap["n_iter"]),
                done=bool(snap.get("converged", False)),
                extra=(box["rmse"], None, None))

        def step(st, chunk):
            state = (*st.carries, st.extra[0]) if st.carries else None
            args = (nf, box["lam"], float(self.tol), int(chunk), int(seed))
            if sparse_in:
                out = _als_fit_sparse(x, t, *args, init_state=state,
                                      read=loop.guard.read)
            else:
                out = _als_fit(x._local, t, *args, init_state=state,
                               read=loop.guard.read, shape=x.shape,
                               mesh=x._mesh)
            pack = fetch_packed(*out)

            def commit():
                u, v, rmse, n_done, conv, _, _ = pack.result()
                box["rmse"] = float(rmse)
                it = st.it + int(n_done)
                log.info("iter %d: rmse=%.6g", it, box["rmse"])
                # the chunk's own host factors ride along for the
                # snapshot and the fitted attributes
                return _fitloop.LoopState(out[:2], it, bool(conv),
                                          extra=(box["rmse"], u, v))

            def history():
                res = pack.result()
                return res[5][: int(res[3])]

            return _fitloop.ChunkOutcome(commit, hvec=pack.part(6),
                                         history=history)

        def snapshot(st):
            rmse, u, v = st.extra
            return {"users": u, "items": v, "m": m, "n": n, "rmse": rmse,
                    "n_iter": st.it, "converged": st.done}

        st = loop.run(init=init, step=step, restore=restore,
                      snapshot=snapshot)
        _, u, v = st.extra
        if u is None:                   # a resumed, finished fit
            u, v = (_fetch(c) for c in st.carries)
        self.users_ = u[:m]
        self.items_ = v[:n]
        self.rmse_ = float(box["rmse"])
        self.n_iter_ = st.it
        self.converged_ = st.done
        self.history_ = np.asarray(loop.history, dtype=np.float64)
        self.fit_info_ = loop.info
        return self

    # async trial protocol: the fit runs on the device with no host read
    # at tol <= 0 (a sparse fit reads its entry counts once each to plan
    # its chunks); the handle is the device outputs and the logical shape
    def _fit_async(self, x, y=None, test=None):
        if self.max_iter < 1:
            raise ValueError("max_iter must be >= 1")
        seed = self.random_state if self.random_state is not None else 0
        args = (int(self.n_f), float(self.lambda_), float(self.tol),
                int(self.max_iter), int(seed))
        if isinstance(x, SparseArray):
            t = x if test is None else _test_sparse(test, x)
            out = _als_fit_sparse(x, t, *args)
        elif isinstance(x, Array):
            test_p = x._local if test is None else _test_dense(test, x)
            out = _als_fit(x._local, test_p, *args, shape=x.shape,
                           mesh=x._mesh)
        else:
            raise TypeError(f"ALS takes a ds-array or a SparseArray, got "
                            f"{type(x).__name__}")
        return out, x.shape

    def _fit_finalize(self, state):
        if state is None:
            return
        out, (m, n) = state
        u, v, rmse, n_iter, conv, hist, _ = _to_host(*out)
        self.users_ = u[:m]
        self.items_ = v[:n]
        self.rmse_ = float(rmse)
        self.n_iter_ = int(n_iter)
        self.converged_ = bool(conv)
        self.history_ = np.asarray(hist[: self.n_iter_], dtype=np.float64)

    def _carry_in(self, arrays: dict, device):
        self.users_ = np.array(arrays["users_"], np.float32)
        self.items_ = np.array(arrays["items_"], np.float32)

    def predict_user(self, user_id: int) -> np.ndarray:
        """Predicted ratings of every item for one user."""
        self._check_fitted()
        if not 0 <= user_id < self.users_.shape[0]:
            raise IndexError(f"user_id {user_id} out of range")
        return self.users_[user_id] @ self.items_.T

    def fold_in(self, ratings, top_n=None):
        """Score new users against the frozen ``items_`` with no refit:
        solve each one's ``(Σ_{j∈Ω} v_j v_jᵀ + λ·max(n, 1)·I) u = Σ_j r_j
        v_j`` and predict every item, in one pass on the device.

        ``ratings``: one user's ratings or a (k, n_items) batch — a
        SparseArray, scipy sparse, an ndarray (0 = unobserved), or a pair
        ``(cols, vals)`` of shape (k, s) padded with (column 0, value 0).
        Returns the (k, n_items) predicted ratings, or with ``top_n`` the
        pair ``(item_ids, scores)`` of (k, top_n) ndarrays, picked in the
        same call."""
        out = self._fold_in_device(ratings, top_n=top_n)
        count_read("results")
        if top_n is not None:
            ids, scores = out
            return ids.cpu().numpy(), scores.cpu().numpy()
        return out.cpu().numpy()

    def _fold_in_device(self, ratings, precision=None, top_n=None):
        """The device half of :meth:`fold_in`: the predictions (or the
        ``(ids, scores)`` pair) as device tensors, unread."""
        self._check_fitted()
        n_items = self.items_.shape[0]
        if isinstance(ratings, tuple) and len(ratings) == 2:
            cols, vals = ratings
            device = cols.device if isinstance(cols, torch.Tensor) \
                else _mesh.get_mesh().device
            cols = torch.as_tensor(cols, device=device)
            vals = torch.as_tensor(vals, device=device)
            if cols.is_floating_point():
                # the serving form carries ids as float32 (exact below
                # 2^24); the gather needs integer indices
                cols = cols.to(torch.int32)
        else:
            device = ratings.device if isinstance(ratings, SparseArray) \
                else _mesh.get_mesh().device
            cols, vals = _fold_in_pack(ratings, n_items, device)
        if cols.dim() == 1:
            cols, vals = cols[None, :], vals[None, :]
        (items,) = self._predict_leaves(device, self.items_)
        _, preds = _fold_in_body(vals, cols, items, float(self.lambda_),
                                 int(self.n_f), px.resolve(precision),
                                 top_n=int(top_n or 0))
        return preds

    def _check_fitted(self):
        if not hasattr(self, "users_"):
            raise RuntimeError("ALS is not fitted")


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _host_ratings(t):
    """Held-out ratings as a host ndarray or scipy matrix."""
    import scipy.sparse as sp
    if isinstance(t, SparseArray):
        return t.collect()
    if isinstance(t, Array):
        t = t.collect()
    return t if sp.issparse(t) else np.asarray(t, np.float32)


def _test_dense(test, x: Array) -> torch.Tensor:
    """Held-out ratings on ``x``'s device as ``x``'s block of the padded
    shape (zero outside the logical region; every rank its block)."""
    import scipy.sparse as sp
    if isinstance(test, Array) and test._mesh == x._mesh \
            and test.shape == x.shape:
        return test._local.to(x.dtype)
    t = _host_ratings(test)
    t = np.asarray(t.toarray() if sp.issparse(t) else t, np.float32)
    if t.shape != tuple(x.shape):
        raise ValueError(f"test ratings shape {t.shape} != ratings shape "
                         f"{tuple(x.shape)}")
    return Array._from_logical(torch.from_numpy(t), x._mesh)._local.to(
        x.dtype)


def _test_sparse(test, x: SparseArray) -> SparseArray:
    """Held-out ratings as a SparseArray on ``x``'s device, never
    densifying a sparse input."""
    import scipy.sparse as sp
    if isinstance(test, SparseArray):
        t = test
    else:
        h = _host_ratings(test)
        t = SparseArray._on_mesh(h if sp.issparse(h) else sp.csr_matrix(h),
                                 x._mesh)
    if tuple(t.shape) != tuple(x.shape):
        raise ValueError(f"test ratings shape {tuple(t.shape)} != ratings "
                         f"shape {tuple(x.shape)}")
    if t.device != x.device or t._mesh != x._mesh:
        raise ValueError(f"test ratings live on {t.device}, the ratings on "
                         f"{x.device} (or on another mesh)")
    return t


def _fold_in_pack(ratings, n_items, device):
    """New-user ratings as padded ``(cols, vals)`` (k, s) tensors on
    ``device``: s = the densest row's entry count rounded up to the
    ``nse_quantum``, pads (column 0, value 0), which add nothing to the
    normal equations."""
    import scipy.sparse as sp
    t = ratings.collect() if isinstance(ratings, SparseArray) else ratings
    if not sp.issparse(t):
        t = sp.csr_matrix(np.atleast_2d(np.asarray(t, np.float32)))
    t = t.tocsr()
    if t.shape[1] != n_items:
        raise ValueError(f"fold_in ratings have {t.shape[1]} items, the "
                         f"model was trained on {n_items}")
    k = t.shape[0]
    row_nnz = np.diff(t.indptr)
    q = nse_quantum()
    s = int(math.ceil(max(int(row_nnz.max(initial=1)), 1) / q) * q)
    # entry e of row i lands in slot e − indptr[i]
    rows = np.repeat(np.arange(k), row_nnz)
    slot = np.arange(t.nnz) - t.indptr[rows]
    cols = np.zeros((k, s), np.int32)
    vals = np.zeros((k, s), np.float32)
    cols[rows, slot] = t.indices
    vals[rows, slot] = t.data
    return (torch.from_numpy(cols).to(device),
            torch.from_numpy(vals).to(device))


# ---------------------------------------------------------------------------
# device functions
# ---------------------------------------------------------------------------

def _repad(a: np.ndarray, logical: int, target: int) -> np.ndarray:
    """A snapshot's factor rows for this fit: the first ``logical`` rows
    (pad rows are zero), zero-filled to ``target``."""
    if a.shape[0] < logical:
        raise ValueError(
            f"snapshot factors have {a.shape[0]} rows but the fit needs "
            f"{logical} — stale or foreign snapshot")
    out = np.zeros((target,) + a.shape[1:], a.dtype)
    out[:logical] = a[:logical]
    return out


def _draw_items(seed, n, n_f, device) -> torch.Tensor:
    """The starting item factors V₀: uniform [0, 1) of shape (n, n_f) from
    a ``torch.Generator`` seeded with ``seed`` (the reference draws
    ``jax.random.uniform`` with the second key of ``split(PRNGKey(seed))``;
    the parity tests hand that draw in here)."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    return torch.rand((n, n_f), generator=g, device=device)


def _chol_solve(a, b):
    """Solutions of the batched systems ``a`` (k, f, f) x = ``b`` (k, f) by
    Cholesky; NaN where a matrix is not positive definite, as the
    reference's ``cho_factor``.  Two triangular solves, not
    ``cholesky_solve``: on CUDA a batched ``cholesky_solve`` may take
    MAGMA's path, which checks its status on the host, and the served
    fold-in runs inside a CUDA graph."""
    low = cholesky_nan(a)
    y = torch.linalg.solve_triangular(low, b[..., None], upper=False)
    return torch.linalg.solve_triangular(low.mT, y, upper=True)[..., 0]


def _solve_factors(r, mask, v, lambda_, n_f, reduce=None):
    """Every row's regularised least squares at once: ``a = mask @ (v ⊗
    v)`` as one (m, n)×(n, f²) product, ``b = r @ v``, then the batched
    Cholesky solve.  ``reduce``: across ranks, sums a block's partials
    (a, b and the counts, packed in one vector) over the ranks that hold
    the row's other blocks — one ``psum``."""
    counts = torch.sum(mask, dim=1)
    b = px.pdot(r, v)                                     # (m, f)
    vv = (v[:, :, None] * v[:, None, :]).reshape(v.shape[0], n_f * n_f)
    a = px.pdot(mask, vv)
    if reduce is not None:
        k = r.shape[0]
        packed = reduce(torch.cat([a.reshape(-1), b.reshape(-1), counts]))
        a = packed[: k * n_f * n_f]
        b = packed[k * n_f * n_f: k * n_f * (n_f + 1)].reshape(k, n_f)
        counts = packed[k * n_f * (n_f + 1):]
    reg = lambda_ * torch.clamp_min(counts, 1.0)
    a = a.reshape(-1, n_f, n_f) + reg[:, None, None] * torch.eye(
        n_f, dtype=a.dtype, device=a.device)
    return _chol_solve(a, b)


def _sweeps(solve, rmse, u, v, tol, max_iter, prev0=None, read=None,
            finish=None):
    """The fit loop: ``solve(v) -> (u, v)`` one sweep, ``rmse(u, v)`` its
    convergence RMSE; masked sweeps in chunks (:func:`run_chunked`) until
    |ΔRMSE| < tol or ``max_iter``.  ``prev0``: the RMSE the first sweep is
    compared with (a resumed chunk's); ``read``: the loop's stop-flag
    read; ``finish``: maps the rank's U to the whole U at the end (across
    ranks).  Returns the reference's ``(u, v, rmse, n_iter, converged,
    hist, hvec)`` as device tensors."""
    dev, dt = v.device, v.dtype
    prev = torch.full((), float("inf") if prev0 is None else prev0,
                      dtype=dt, device=dev)
    n_iter = torch.zeros((), dtype=torch.int32, device=dev)
    conv = torch.zeros((), dtype=torch.bool, device=dev)
    hist = torch.zeros((max_iter,), dtype=dt, device=dev)

    def step(t):
        nonlocal u, v, prev, n_iter, conv
        active = ~conv
        u_new, v_new = solve(v)
        cur = rmse(u_new, v_new)
        u = torch.where(active, u_new, u)
        v = torch.where(active, v_new, v)
        conv = torch.where(active, torch.abs(prev - cur) < tol, conv)
        prev = torch.where(active, cur, prev)
        hist[t] = torch.where(active, cur, hist[t])
        n_iter = n_iter + active.to(torch.int32)

    # at tol <= 0 |ΔRMSE| < tol never holds (a NaN neither), so the fit
    # runs max_iter sweeps with no read
    run_chunked(step, None if tol <= 0 else lambda: ~conv, max_iter, "als",
                read=read)
    if finish is not None:
        u = finish(u)
    hvec = _health.health_vec(carries=(u, v), hist=hist, n_done=n_iter)
    return u, v, prev, n_iter, conv, hist, hvec


@precise
def _als_fit(rp, test_p, n_f, lambda_, tol, max_iter, seed, init_state=None,
             read=None, shape=None, mesh=None):
    """The dense fit on the padded ratings ``rp`` (zero = unobserved, the
    padding included) with held-out ratings ``test_p`` of the same shape.
    ``init_state``: ``(u, v, rmse)`` to resume from (a chunk of the
    checked fit), else V₀ is drawn from ``seed``.  ``shape``: the logical
    (m, n).  On a ``mesh`` of several ranks (or a world of one) ``rp`` and
    ``test_p`` are this rank's blocks and each half-step's partials are
    reduced over the ranks (:func:`_solve_factors`' ``reduce``); U comes
    back whole.  With no process group the collectives are the
    identity."""
    dt = rp.dtype
    mask = (rp != 0).to(dt)
    tmask = (test_p != 0).to(dt)
    mesh = _mesh.local_mesh(rp.device) if mesh is None else mesh
    m, n = shape if shape is not None else rp.shape
    r0, c0, m_loc, n_loc = _block_geom((m, n), mesh)
    n_pad = n_loc * mesh.cols
    t_count = torch.clamp_min(_dist.psum(torch.sum(tmask).reshape(1),
                                         _dist.ALL, mesh)[0], 1.0)
    u0, v0, prev0 = _start(init_state, m_loc, n_pad, n_f, seed, dt,
                           rp.device, n, r0)

    def solve(v):
        u = _solve_factors(rp, mask, v[c0:c0 + n_loc], lambda_, n_f,
                           lambda t: _dist.psum(t, _mesh.COLS, mesh))
        vb = _solve_factors(rp.T, mask.T, u, lambda_, n_f,
                            lambda t: _dist.psum(t, _mesh.ROWS, mesh))
        return u, _dist.all_gather(vb, _mesh.COLS, 0, mesh)

    def rmse(u, v):
        se = ((px.pdot(u, v[c0:c0 + n_loc].T) - test_p) * tmask) ** 2
        tot = _dist.psum(torch.sum(se).reshape(1), _dist.ALL, mesh)[0]
        return torch.sqrt(tot / t_count)

    return _sweeps(solve, rmse, u0, v0, tol, max_iter, prev0, read,
                   finish=lambda u: _dist.all_gather(u, _mesh.ROWS, 0, mesh))


def _start(init_state, m, n, n_f, seed, dt, device, n_draw=None, row0=0):
    """``(u0, v0, prev_rmse)`` of a fit or chunk of ``m`` user rows and
    ``n`` item rows: the carried state (its U cut to the rows from
    ``row0``), or zeros, the seeded V₀ draw at the logical ``n_draw``
    items (zero rows past them) and no previous RMSE.  U₀ is never read
    before the first user half-step overwrites it."""
    if init_state is not None:
        u, v, prev = init_state
        return u[row0:row0 + m].to(dt), v.to(dt), float(prev)
    n_draw = n if n_draw is None else int(n_draw)
    v0 = torch.zeros((n, n_f), dtype=dt, device=device)
    v0[:n_draw] = _draw_items(seed, n_draw, n_f, device).to(dt)
    return torch.zeros((m, n_f), dtype=dt, device=device), v0, None


def _row_chunks(lengths: np.ndarray, max_entries: int):
    """Host plan of row-aligned chunks over a stream of entries sorted by
    row, row i holding ``lengths[i]`` entries: ``(r0, r1, e0, e1)`` tuples
    tiling rows and entries in order, each with at most ``max_entries``
    entries unless a single row holds more (it then takes a chunk of its
    own).  No row is split."""
    nseg = int(lengths.shape[0])
    starts = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    chunks, r = [], 0
    while r < nseg:
        hi = int(np.searchsorted(starts, starts[r] + max_entries,
                                 side="right")) - 1
        r1 = min(nseg, max(r + 1, hi))
        chunks.append((r, r1, int(starts[r]), int(starts[r1])))
        r = r1
    return chunks


class _HalfStep:
    """One side of the sparse fit: the normal equations of each of
    ``lengths.shape[0]`` rows, whose entries lie contiguous and in order
    in ``other_idx`` (the other factor's row of each entry), ``vals`` and
    ``w``.  ``mesh``: the item side's, whose rows' entries are spread
    over the mesh rows, so the partials and counts are ``psum``-ed over
    'rows'; None for the user side, whose rows are this rank's."""

    def __init__(self, lengths_dev, lengths_host, other_idx, vals, w,
                 n_f, lambda_, mesh=None):
        self.lengths = lengths_dev
        self.idx = other_idx.to(torch.int64)
        self.w = w
        self.vw = vals * w
        self.n_f = n_f
        self.mesh = mesh
        self.chunks = _row_chunks(lengths_host, max(
            1, SPARSE_BUDGET_BYTES // (4 * n_f * n_f)))
        count = seg_sum(w, lengths_dev)
        if mesh is not None:            # the item side: counts over ranks
            count = _dist.psum(count, _mesh.ROWS, mesh)
        reg = lambda_ * torch.clamp_min(count, 1.0)
        self.reg = reg[:, None, None] * torch.eye(n_f, dtype=w.dtype,
                                                  device=w.device)

    def solve(self, other):
        f = self.n_f
        a_parts, b_parts = [], []
        for r0, r1, e0, e1 in self.chunks:
            g = other[self.idx[e0:e1]] * self.w[e0:e1, None]   # (e, f)
            lens = self.lengths[r0:r1]
            outer = (g[:, :, None] * g[:, None, :]).reshape(-1, f * f)
            a_parts.append(seg_sum(outer, lens))
            b_parts.append(seg_sum(self.vw[e0:e1, None] * g, lens))
        nseg = self.reg.shape[0]
        a = torch.cat(a_parts) if a_parts else other.new_zeros((nseg, f * f))
        b = torch.cat(b_parts) if b_parts else other.new_zeros((nseg, f))
        if self.mesh is not None:
            # the rank's partials, then ONE psum over 'rows'
            packed = _dist.psum(torch.cat([a.reshape(-1), b.reshape(-1)]),
                                _mesh.ROWS, self.mesh)
            a = packed[: nseg * f * f]
            b = packed[nseg * f * f:].reshape(nseg, f)
        return _chol_solve(a.reshape(nseg, f, f) + self.reg, b)


def _half_steps(x: SparseArray, n_f, lambda_):
    """The user and the item :class:`_HalfStep` of the sparse fit on the
    entries of ``x`` (this rank's): the row-sorted entries, and the
    column-sorted copy (one read of its column counts, to plan the
    chunks).  The item half-step is reduced over 'rows' (the identity with
    no process group)."""
    users = _HalfStep(x._row_len, x._row_nnz(), x._cols, x._vals,
                      (x._vals != 0).to(x.dtype), n_f, lambda_)
    c_rows, _, c_vals, col_len = x._by_col()
    count_read("sparse")
    items = _HalfStep(col_len, col_len.cpu().numpy(), c_rows, c_vals,
                      (c_vals != 0).to(x.dtype), n_f, lambda_, x._mesh)
    return users, items


@precise
def _als_fit_sparse(x: SparseArray, t: SparseArray, n_f, lambda_, tol,
                    max_iter, seed, init_state=None, read=None):
    """The sparse fit on the entries of ``x`` (weight ``value != 0``),
    convergence RMSE over the entries of ``t`` (``x`` itself without
    held-out ratings)."""
    m, n = x.shape
    dev, mesh = x.device, x._mesh
    users, items = _half_steps(x, n_f, lambda_)
    t_rows = t._rows.to(torch.int64)
    t_cols = t._cols.to(torch.int64)
    tw = (t._vals != 0).to(t.dtype)
    t_count = torch.clamp_min(_dist.psum(torch.sum(tw).reshape(1),
                                         _mesh.ROWS, mesh)[0], 1.0)
    u0, v0, prev0 = _start(init_state, x._m_local, n, n_f, seed, x.dtype,
                           dev, row0=x._row0)

    def solve(v):
        u = users.solve(v)
        return u, items.solve(u)

    def rmse(u, v):
        pred = torch.sum(u[t_rows] * v[t_cols], dim=1)
        se = _dist.psum(torch.sum(tw * (pred - t._vals) ** 2).reshape(1),
                        _mesh.ROWS, mesh)[0]
        return torch.sqrt(se / t_count)

    return _sweeps(solve, rmse, u0, v0, tol, max_iter, prev0, read,
                   finish=lambda u: _dist.all_gather(u, _mesh.ROWS, 0, mesh))


@precise
def _fold_in_body(vals, cols, items, lambda_, n_f, policy, top_n=0):
    """The fold-in: per-user regularised normal equations against the
    frozen ``items`` (n_items, f), a batched Cholesky solve and one
    predict product; with ``top_n`` > 0 the top ``top_n`` items of each
    user.  An entry's weight is ``(vals != 0) & in_range``: the pads
    (value 0) and an out-of-range column add nothing.  Returns ``(factors,
    preds)`` or ``(factors, (ids int32, scores))``."""
    n_items = items.shape[0]
    in_range = (cols >= 0) & (cols < n_items)
    w = ((vals != 0) & in_range).to(items.dtype)
    g = items[cols.clamp(0, n_items - 1).to(torch.int64)] * w[..., None]
    a = px.peinsum("ksf,ksg->kfg", g, g, policy)              # (k, f, f)
    reg = lambda_ * torch.clamp_min(torch.sum(w, dim=1), 1.0)
    a = a + reg[:, None, None] * torch.eye(n_f, dtype=a.dtype,
                                           device=a.device)
    b = px.peinsum("ks,ksf->kf", vals.to(items.dtype) * w, g, policy)
    factors = _chol_solve(a, b)
    preds = px.pdot(factors, items.T, policy)                 # (k, n_items)
    if top_n:
        scores, ids = torch.topk(preds, int(top_n), dim=1, sorted=True)
        return factors, (ids.to(torch.int32), scores)
    return factors, preds


def _als_fold_in_packed(buf, items, lambda_, n_f, policy, top_n=0):
    """The serving form: each row of ``buf`` (k, 2s) is ``[cols | vals]``
    with the column ids as floats (exact below 2^24) and pads (0, 0),
    split and passed to :func:`_fold_in_body`."""
    s = buf.shape[1] // 2
    return _fold_in_body(buf[:, s:], buf[:, :s].to(torch.int32), items,
                         lambda_, n_f, policy, top_n=top_n)
