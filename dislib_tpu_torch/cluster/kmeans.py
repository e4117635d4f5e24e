"""KMeans — the north-star estimator.

Counterpart of ``dislib_tpu/cluster/kmeans.py`` (dense).  Lloyd's iteration
runs on the device with ONE host sync per fit, as in the reference's
``lax.while_loop``: :func:`_kmeans_fit` enqueues ``max_iter`` steps without
reading anything back, and a step is active only while ``shift >= tol``.
An inactive step keeps the centers, does not advance ``n_iter`` and does not
write ``hist``, so the results equal the reference's early-exiting loop.
``fit`` reads them all back in one transfer at the end.

Per step: the E-step is the hand CUDA kernel ``distances_sq``
(``ops/base.distances_sq(..., use_kernel=True)``), then argmin; the M-step
is ``onehotᵀ @ x`` as a plain f32-faithful product (it sits outside any
kernel of the reference too).  ``predict`` and ``score`` run the same
kernel.  Padded rows (none on the one-device mesh) carry weight 0.

Not ported yet: ``checkpoint=``/``health=`` (the ``ChunkedFitLoop``,
ROADMAP.md A.12), sparse input (A.10) and ``fast_distance=True`` (a
bf16-operand cross term with f32 norms, A.6) — each raises
``NotImplementedError``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from dislib_tpu_torch.base import BaseEstimator
from dislib_tpu_torch.data.array import Array
from dislib_tpu_torch.ops.base import distances_sq as _distances_sq, precise
from dislib_tpu_torch.runtime import health as _health


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
    verbose : bool — accepted for parity; the fit reads nothing back until
        it ends, so there is no per-iteration log.

    Attributes
    ----------
    centers_ : ndarray (n_clusters, n_features)
    n_iter_ : int
    inertia_ : float — within-cluster sum of squared distances.
    history_ : ndarray (n_iter_,) — per-iteration inertia.
    """

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

    def _check_supported(self, x):
        fast = self.fast_distance if self.fast_distance is not None \
            else os.environ.get("DSLIB_KMEANS_FAST_DISTANCE", "0") == "1"
        if fast:
            raise NotImplementedError(
                "KMeans fast_distance: the bf16-operand distance kernel is "
                "not ported yet (ROADMAP.md A.6)")
        if not isinstance(x, Array):
            raise NotImplementedError(
                f"KMeans on {type(x).__name__}: the port takes dense "
                "ds-arrays; sparse input is ROADMAP.md A.10")

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
        rng = np.random.RandomState(self.random_state)
        # sample k distinct rows — the same draw as the reference
        idx = rng.choice(x.shape[0], size=min(k, x.shape[0]), replace=False)
        rows = x[np.sort(idx), :]._data[: len(idx), : n]
        if len(idx) < k:  # fewer samples than clusters: top up with jitter
            pick = torch.as_tensor(rng.randint(0, len(idx), k - len(idx)),
                                   device=rows.device)
            rows = torch.cat([rows, rows[pick] + 1e-3], dim=0)
        return rows

    def fit(self, x: Array, y=None, checkpoint=None, health=None):
        """Fit on ``x``: ``max_iter`` Lloyd steps on the device, one host
        read at the end."""
        if checkpoint is not None or health is not None:
            raise NotImplementedError(
                "KMeans.fit checkpoint=/health=: the ChunkedFitLoop is not "
                "ported yet (ROADMAP.md A.12)")
        self._check_supported(x)
        out = _kmeans_fit(x._data, x.shape, self._init_centers(x),
                          int(self.max_iter), float(self.tol))
        centers, n_iter, inertia, _, hist, _ = _to_host(*out)
        self.centers_ = centers
        self.n_iter_ = int(n_iter)
        self.inertia_ = float(inertia)
        self.history_ = np.asarray(hist[: self.n_iter_], dtype=np.float64)
        return self

    def fit_predict(self, x: Array, y=None) -> Array:
        return self.fit(x).predict(x)

    def predict(self, x: Array) -> Array:
        """Cluster index per row, an (m, 1) int32 ds-array."""
        self._check_fitted()
        self._check_supported(x)
        labels = _kmeans_predict(x._data, x.shape, self._centers_on(x))
        return Array._from_padded(labels, (x.shape[0], 1), x._mesh)

    def score(self, x: Array, y=None) -> float:
        """Negative inertia on x (sklearn convention)."""
        self._check_fitted()
        self._check_supported(x)
        return float(_kmeans_score(x._data, x.shape, self._centers_on(x)))

    def _centers_on(self, x: Array) -> torch.Tensor:
        return torch.as_tensor(self.centers_, device=x.device)

    def _check_fitted(self):
        if not hasattr(self, "centers_"):
            raise RuntimeError("KMeans is not fitted")


def _to_host(*tensors):
    """Read device tensors back in ONE transfer: pack into float64 (exact
    for float32 and int32 values), copy, split."""
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    host = flat.cpu().numpy()
    out, pos = [], 0
    for t in tensors:
        part = host[pos: pos + t.numel()].reshape(tuple(t.shape))
        out.append(part.astype(str(t.dtype).removeprefix("torch.")))
        pos += t.numel()
    return out


# ---------------------------------------------------------------------------
# device kernels
# ---------------------------------------------------------------------------

def _crop(xp: torch.Tensor, shape):
    """Crop padded columns (the kernel takes contiguous rows) and weight
    padded rows 0."""
    m, n = shape
    xv = xp[:, :n]
    if not xv.is_contiguous():
        xv = xv.contiguous()
    w = (torch.arange(xv.shape[0], device=xv.device) < m).to(xv.dtype)
    return xv, w


@precise
def _kmeans_fit(xp, shape, centers0, max_iter, tol):
    """``max_iter`` Lloyd steps on the padded backing ``xp`` of logical
    ``shape`` from ``centers0``.  Returns ``(centers, n_iter, inertia,
    shift, hist, hvec)`` as device tensors — the reference's 6-tuple."""
    xv, w = _crop(xp, shape)
    k = centers0.shape[0]
    dev, dt = xv.device, xv.dtype
    centers = centers0.to(device=dev, dtype=dt).contiguous()
    cluster_ids = torch.arange(k, device=dev)
    shift = torch.full((), float("inf"), dtype=dt, device=dev)
    n_iter = torch.zeros((), dtype=torch.int32, device=dev)
    inertia = torch.zeros((), dtype=dt, device=dev)
    hist = torch.zeros((max_iter,), dtype=dt, device=dev)
    for t in range(max_iter):
        active = shift >= tol
        d = _distances_sq(xv, centers, use_kernel=True)
        min_d, labels = torch.min(d, dim=1)   # first index on ties
        onehot = (labels[:, None] == cluster_ids).to(dt) * w[:, None]
        sums = onehot.T @ xv                  # (k, n)
        counts = onehot.sum(dim=0)            # (k,)
        new_centers = torch.where(
            counts[:, None] > 0,
            sums / torch.clamp_min(counts, 1.0)[:, None], centers)
        step_shift = torch.sum((new_centers - centers) ** 2)
        step_inertia = torch.sum(min_d * w)
        centers = torch.where(active, new_centers, centers).contiguous()
        shift = torch.where(active, step_shift, shift)
        inertia = torch.where(active, step_inertia, inertia)
        hist[t] = torch.where(active, step_inertia, hist[t])
        n_iter = n_iter + active.to(torch.int32)
    hvec = _health.health_vec(carries=(centers,), hist=hist, n_done=n_iter)
    return centers, n_iter, inertia, shift, hist, hvec


@precise
def _kmeans_predict(xp, shape, centers):
    xv, w = _crop(xp, shape)
    d = _distances_sq(xv, centers.to(xv.dtype).contiguous(), use_kernel=True)
    # labels stay int32; padded rows get label 0 (the Array invariant)
    labels = torch.argmin(d, dim=1).to(torch.int32) * w.to(torch.int32)
    return labels[:, None].contiguous()


@precise
def _kmeans_score(xp, shape, centers):
    xv, w = _crop(xp, shape)
    d = _distances_sq(xv, centers.to(xv.dtype).contiguous(), use_kernel=True)
    return -torch.sum(torch.min(d, dim=1).values * w)
