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
- **Random draws.** V₀ is :func:`_draw_items`, a uniform draw from a
  ``torch.Generator`` seeded with ``random_state`` (the reference draws
  threefry ``uniform``; the parity tests hand that draw in here).  U₀ is
  never read before the first user half-step overwrites it.
- **Fold-in** (``fold_in``, ``_fold_in_device``, ``_fold_in_body``):
  new users' normal equations against the frozen item factors, solved
  and scored in one pass, the top ``top_n`` items picked in the same
  call.  ``_als_fold_in_packed`` unpacks the serving form ``[cols |
  vals]``; its serving wrapper (``dislib_tpu/serving/sparse.py``) is
  ROADMAP.md A.12's serving half.

Not ported: ``checkpoint=``/``health=`` (the ``ChunkedFitLoop``,
ROADMAP.md A.12), which raise ``NotImplementedError``, and the multi-rank
sparse fit (the reference's ``shard_map`` with one ``psum`` per item
half-step, A.2).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dislib_tpu_torch.base import BaseEstimator
from dislib_tpu_torch.cluster.kmeans import _to_host
from dislib_tpu_torch.data.array import Array
from dislib_tpu_torch.data.sparse import SparseArray, nse_quantum
from dislib_tpu_torch.ops import precision as px
from dislib_tpu_torch.ops.base import cholesky_nan, precise
from dislib_tpu_torch.ops.spmm import seg_sum
from dislib_tpu_torch.parallel import mesh as _mesh
from dislib_tpu_torch.runtime.loop import run_chunked
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
    verbose : bool — accepted for parity; the fit reads only its loop
        condition until it ends, so there is no per-iteration log.
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
        training ratings'."""
        if checkpoint is not None or health is not None:
            raise NotImplementedError(
                "ALS.fit checkpoint=/health=: the ChunkedFitLoop is not "
                "ported yet (ROADMAP.md A.12)")
        self._fit_finalize(self._fit_async(x, test=test))
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
            test_p = x._data if test is None else _test_dense(test, x)
            out = _als_fit(x._data, test_p, *args)
        else:
            raise TypeError(f"ALS takes a ds-array or a SparseArray, got "
                            f"{type(x).__name__}")
        return out, x.shape

    def _fit_finalize(self, state):
        if state is None:
            return
        out, (m, n) = state
        u, v, rmse, n_iter, conv, hist = _to_host(*out)
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
    """Held-out ratings on ``x``'s device at its padded shape (zero
    outside the logical region)."""
    import scipy.sparse as sp
    t = _host_ratings(test)
    t = np.asarray(t.toarray() if sp.issparse(t) else t, np.float32)
    if t.shape != tuple(x.shape):
        raise ValueError(f"test ratings shape {t.shape} != ratings shape "
                         f"{tuple(x.shape)}")
    out = torch.zeros(x._data.shape, dtype=x._data.dtype, device=x.device)
    out[: t.shape[0], : t.shape[1]] = torch.from_numpy(t).to(x.device)
    return out


def _test_sparse(test, x: SparseArray) -> SparseArray:
    """Held-out ratings as a SparseArray on ``x``'s device, never
    densifying a sparse input."""
    import scipy.sparse as sp
    if isinstance(test, SparseArray):
        t = test
    else:
        h = _host_ratings(test)
        t = SparseArray.from_scipy(h if sp.issparse(h)
                                   else sp.csr_matrix(h), device=x.device)
    if tuple(t.shape) != tuple(x.shape):
        raise ValueError(f"test ratings shape {tuple(t.shape)} != ratings "
                         f"shape {tuple(x.shape)}")
    if t.device != x.device:
        raise ValueError(f"test ratings live on {t.device}, the ratings on "
                         f"{x.device}")
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
    reference's ``cho_factor``."""
    return torch.cholesky_solve(b[..., None], cholesky_nan(a))[..., 0]


def _solve_factors(r, mask, v, lambda_, n_f):
    """Every row's regularised least squares at once: ``a = mask @ (v ⊗
    v)`` as one (m, n)×(n, f²) product, ``b = r @ v``, then the batched
    Cholesky solve."""
    counts = torch.sum(mask, dim=1)
    b = px.pdot(r, v)                                     # (m, f)
    vv = (v[:, :, None] * v[:, None, :]).reshape(v.shape[0], n_f * n_f)
    a = px.pdot(mask, vv).reshape(-1, n_f, n_f)
    reg = lambda_ * torch.clamp_min(counts, 1.0)
    a = a + reg[:, None, None] * torch.eye(n_f, dtype=a.dtype,
                                           device=a.device)
    return _chol_solve(a, b)


def _sweeps(solve, rmse, u, v, tol, max_iter):
    """The fit loop: ``solve(v) -> (u, v)`` one sweep, ``rmse(u, v)`` its
    convergence RMSE; masked sweeps in chunks (:func:`run_chunked`) until
    |ΔRMSE| < tol or ``max_iter``.  Returns the reference's ``(u, v,
    rmse, n_iter, converged, hist)`` as device tensors."""
    dev, dt = v.device, v.dtype
    prev = torch.full((), float("inf"), dtype=dt, device=dev)
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
    run_chunked(step, None if tol <= 0 else lambda: ~conv, max_iter, "als")
    return u, v, prev, n_iter, conv, hist


@precise
def _als_fit(rp, test_p, n_f, lambda_, tol, max_iter, seed):
    """The dense fit on the padded ratings ``rp`` (zero = unobserved, the
    padding included) with held-out ratings ``test_p`` of the same shape."""
    dt = rp.dtype
    mask = (rp != 0).to(dt)
    tmask = (test_p != 0).to(dt)
    t_count = torch.clamp_min(torch.sum(tmask), 1.0)
    v0 = _draw_items(seed, rp.shape[1], n_f, rp.device).to(dt)
    u0 = torch.zeros((rp.shape[0], n_f), dtype=dt, device=rp.device)

    def solve(v):
        u = _solve_factors(rp, mask, v, lambda_, n_f)
        return u, _solve_factors(rp.T, mask.T, u, lambda_, n_f)

    def rmse(u, v):
        se = ((px.pdot(u, v.T) - test_p) * tmask) ** 2
        return torch.sqrt(torch.sum(se) / t_count)

    return _sweeps(solve, rmse, u0, v0, tol, max_iter)


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
    ``w``."""

    def __init__(self, lengths_dev, lengths_host, other_idx, vals, w,
                 n_f, lambda_):
        self.lengths = lengths_dev
        self.idx = other_idx.to(torch.int64)
        self.w = w
        self.vw = vals * w
        self.n_f = n_f
        self.chunks = _row_chunks(lengths_host, max(
            1, SPARSE_BUDGET_BYTES // (4 * n_f * n_f)))
        reg = lambda_ * torch.clamp_min(seg_sum(w, lengths_dev), 1.0)
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
        a = (torch.cat(a_parts) if a_parts else other.new_zeros(
            (nseg, f * f))).reshape(nseg, f, f) + self.reg
        b = torch.cat(b_parts) if b_parts else other.new_zeros((nseg, f))
        return _chol_solve(a, b)


def _half_steps(x: SparseArray, n_f, lambda_):
    """The user and the item :class:`_HalfStep` of the sparse fit on the
    entries of ``x``: the row-sorted entries, and the column-sorted copy
    (one read of its column counts, to plan the chunks)."""
    users = _HalfStep(x._row_len, x._row_nnz(), x._cols, x._vals,
                      (x._vals != 0).to(x.dtype), n_f, lambda_)
    c_rows, _, c_vals, col_len = x._by_col()
    count_read("sparse")
    items = _HalfStep(col_len, col_len.cpu().numpy(), c_rows, c_vals,
                      (c_vals != 0).to(x.dtype), n_f, lambda_)
    return users, items


@precise
def _als_fit_sparse(x: SparseArray, t: SparseArray, n_f, lambda_, tol,
                    max_iter, seed):
    """The sparse fit on the entries of ``x`` (weight ``value != 0``),
    convergence RMSE over the entries of ``t`` (``x`` itself without
    held-out ratings)."""
    m, n = x.shape
    dev = x.device
    users, items = _half_steps(x, n_f, lambda_)
    t_rows = t._rows.to(torch.int64)
    t_cols = t._cols.to(torch.int64)
    tw = (t._vals != 0).to(t.dtype)
    t_count = torch.clamp_min(torch.sum(tw), 1.0)
    v0 = _draw_items(seed, n, n_f, dev).to(x.dtype)
    u0 = torch.zeros((m, n_f), dtype=x.dtype, device=dev)

    def solve(v):
        u = users.solve(v)
        return u, items.solve(u)

    def rmse(u, v):
        pred = torch.sum(u[t_rows] * v[t_cols], dim=1)
        return torch.sqrt(torch.sum(tw * (pred - t._vals) ** 2) / t_count)

    return _sweeps(solve, rmse, u0, v0, tol, max_iter)


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
