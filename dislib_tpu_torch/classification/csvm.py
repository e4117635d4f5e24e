"""Cascade SVM.

Counterpart of ``dislib_tpu/classification/csvm.py``.  The local solver is
the reference's dual SVM without an equality constraint: maximize
``W(α) = Σα − ½ αᵀQα`` s.t. ``0 ≤ α ≤ C`` with ``Q = (K + 1) ∘ yyᵀ`` (the
``+ 1`` absorbs the bias), by projected gradient ascent
``α ← clip(α + η(1 − Qα), 0, C)`` with ``η = 1/max_row_sum(|Q|)``, or by
FISTA with adaptive restart (``DSLIB_CSVM_SOLVER=fista``).  A cascade node
is a (-1)-padded vector of sample indices of a power-of-two capacity;
padded slots get ``C = 0``, so their α stays 0.  Level-0 partitions are
the row blocks, capped at ``DSLIB_CSVM_MAX_PARTITION`` rows; each level's
nodes merge their support vectors by ``cascade_arity``; the top node's
support vectors are fed back into every partition for the next iteration.

Each level is solved for all its nodes at once (the reference's ``vmap``),
in batches bounded by ``DSLIB_CSVM_SOLVE_BUDGET`` bytes:

- **dense** staging gathers each node's rows, (B, cap, n), from the fit
  set (its columns padded once a fit to a multiple of 4 on a card) and
  computes the B sub-Grams ``exp(−γ·d²) + 1`` with ONE launch of the hand
  kernel ``ops/kernels.distances_sq_batched`` (``csrc/distances_sq.cu``,
  a grid dimension over the nodes; the plain ``bmm`` formula on CPU
  tensors); the linear kernel is one ``bmm`` with TF32 off;
- **sparse on the device**: a ``SparseArray`` whose ``ell()`` buffers fit
  their budget densifies each node's rows from them by a scatter along
  the row (an ELL row holds each column once, so the scatter has no sums;
  padding slots go to a sink column that is cut off), then as above;
- **host CSR**, when ``ell()`` returns None: each node's (cap, cap) kernel
  block is computed with scipy on the host (the reference's
  ``_host_gram``) and the solves run on the device.  Where the port
  departs (ROADMAP.md C.12): the reference's host-CSR blocks are zero at
  a node's padded slots, while its dense and ELL staging gather row 0
  there; the padded rows enter the step size ``η``, so the reference's
  CSR fallback runs another iteration than its dense fit and, where 500
  steps do not converge, lands on other α.  The port stages a padded slot
  as row 0 on every path, so the three stagings solve the same ``Q``.

The reference runs the dual ascent as a ``vmap`` of ``lax.while_loop``:
every node steps until all have stopped, and a node freezes once its own
``delta ≤ 1e-6``.  The port steps all nodes of a batch together, one
``bmm`` GEMV a step, each node's state updated only while its own
condition holds, under :func:`runtime.loop.run_chunked`: at most 500
steps, the condition read once per chunk of ``EVERY`` steps
(``HOST_READS["csvm"]``).  Each level's α and objectives come back in one
read (also ``"csvm"``).  ``decision_function`` is eager: dense queries
take the 2-D ``distances_sq`` kernel against the support vectors, sparse
queries an ``ops/spmm`` cross term.  ``random_state`` is unused, as in
the reference: the fit is deterministic.

The cascade iterations run through
:class:`~dislib_tpu_torch.runtime.ChunkedFitLoop`, one iteration a chunk,
as the reference's do: the state (SV indices, their α, the last
objective) lives on the host, so the guard judges it with ``check_host``
(a non-finite α or objective trips ``'nonfinite'``), and with
``checkpoint=FitCheckpoint(path, every=k)`` it snapshots every k
iterations under a fingerprint of the hyperparameters and the composite
digest ``versioned_digest(Σx, Σ row·x, Σy, Σ y·row)``.  A level's node
batches go through ``ops/overlap.host_pipeline`` (batch b+1 dispatched
before batch b's read under the overlapped schedules; the schedules are
bit-equal).
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from dislib_tpu_torch.base import BaseEstimator
from dislib_tpu_torch.data.array import Array
from dislib_tpu_torch.data.sparse import SparseArray, check_input
from dislib_tpu_torch.ops import kernels as _k
from dislib_tpu_torch.ops import overlap as _ov
from dislib_tpu_torch.ops.precision import precise
from dislib_tpu_torch.runtime import fitloop as _fitloop
from dislib_tpu_torch.runtime.elastic import fetch_packed
from dislib_tpu_torch.ops.spmm import spmm_rows
from dislib_tpu_torch.runtime.loop import run_chunked
from dislib_tpu_torch.utils.dlog import verbose_logger
from dislib_tpu_torch.utils import profiling as _prof
from dislib_tpu_torch.utils.profiling import count_read

#: the dual ascent's step cap and stopping threshold (the reference's)
MAX_STEPS, DELTA_TOL = 500, 1e-6


class CascadeSVM(BaseEstimator):
    """Binary SVM trained by cascades of partial solves.

    Parameters
    ----------
    cascade_arity : int, default 2 — fan-in of the SV merge tree.
    max_iter : int, default 5 — global cascade iterations.
    tol : float, default 1e-3 — relative change of the dual objective.
    kernel : 'rbf' or 'linear'.
    c : float, default 1.0 — box constraint.
    gamma : 'auto' or float — rbf width; 'auto' = 1/n_features.
    check_convergence : bool, default True.
    random_state : unused (the fit is deterministic); kept for parity.

    Attributes
    ----------
    classes_ : ndarray (2,) — original labels, index = predicted class.
    converged_ : bool
    iterations_n : int (alias n_iter_)
    support_vectors_count_ : int
    """

    _private_fitted_attrs = ("_sv_x", "_sv_y", "_sv_alpha", "_sv_idx",
                             "_gamma_fit")

    def __init__(self, cascade_arity=2, max_iter=5, tol=1e-3, kernel="rbf",
                 c=1.0, gamma="auto", check_convergence=True,
                 random_state=None, verbose=False):
        self.cascade_arity = cascade_arity
        self.max_iter = max_iter
        self.tol = tol
        self.kernel = kernel
        self.c = c
        self.gamma = gamma
        self.check_convergence = check_convergence
        self.random_state = random_state
        self.verbose = verbose

    def _gamma_value(self, n_features):
        if self.gamma == "auto":
            return 1.0 / n_features
        return float(self.gamma)

    # -- fitting -------------------------------------------------------------

    def fit(self, x, y, checkpoint=None, health=None):
        """Fit the cascade on ``x``'s device: a dense ds-array or a
        ``SparseArray`` (ELL staging on the device, or the host-CSR
        fallback past ``DSLIB_SPARSE_ELL_BUDGET``).  ``checkpoint``:
        snapshots of the SV state every ``every`` iterations, resumed on
        a re-run; ``health``: the loop's guard policy."""
        from dislib_tpu_torch.utils.checkpoint import (
            digest_sums, validate_snapshot, versioned_digest)
        if self.kernel not in ("rbf", "linear"):
            raise ValueError(f"unsupported kernel {self.kernel!r}")
        if self.max_iter < 1:
            raise ValueError("max_iter must be >= 1")
        check_input(x, "CascadeSVM")
        m, n = x.shape
        y_host = np.asarray(y.collect()).ravel()
        classes = np.unique(y_host)
        if len(classes) != 2:
            raise ValueError("CascadeSVM is a binary classifier; got "
                             f"{len(classes)} classes")
        self.classes_ = classes
        y_pm = np.where(y_host == classes[1], 1.0, -1.0).astype(np.float32)
        gamma = self._gamma_value(n)
        solver = "fista" if _use_fista() else "pg"
        stage = _Staging(x, self.kernel, gamma)
        yv = torch.as_tensor(y_pm, device=x.device)

        part = min(max(1, x._reg_shape[0]), _max_partition())
        nodes0 = _pack_nodes([np.arange(s, min(s + part, m))
                              for s in range(0, m, part)])
        log = verbose_logger("csvm", self.verbose)
        box = {"sv_idx": None, "sv_alpha": None, "last_w": None}
        fp = digest = None
        if checkpoint is not None:
            # everything the fed-back SV state depends on: shape,
            # hyperparameters, the level-0 partitioning (exact), and the
            # data digests (plain and row-weighted sums of x and y)
            fp = np.asarray([m, n, float(gamma), float(self.c),
                             float(self.cascade_arity),
                             float(("rbf", "linear").index(self.kernel)),
                             float(part)], np.float64)
            if isinstance(x, SparseArray):
                rows, vals = fetch_packed(x._rows, x._vals,
                                          site="digest").result()
                vals = vals.astype(np.float64)
                x_sum, x_rowsum = float(vals.sum()), float(vals @ rows)
            else:
                x_sum, x_rowsum = digest_sums(x._data)
            digest = versioned_digest(
                x_sum, x_rowsum, float(y_pm.sum()),
                float(y_pm @ np.arange(m, dtype=np.float64)))
        loop = _fitloop.ChunkedFitLoop(
            "csvm", checkpoint=checkpoint, health=health,
            max_iter=self.max_iter, chunk_iters=1,
            save_every=checkpoint.every if checkpoint is not None else 1,
            elastic=_fitloop.data_rebind({"x": x}))

        def init(rem):
            box.update(sv_idx=None, sv_alpha=None, last_w=None)
            return _fitloop.LoopState(())   # the state is host-side

        def restore(snap, rem):
            validate_snapshot(snap, fp, digest)
            box["sv_idx"] = np.asarray(snap["sv_idx"], np.int64)
            box["sv_alpha"] = np.asarray(snap["sv_alpha"], np.float32)
            box["last_w"] = float(snap["last_w"])
            # a converged snapshot only ends the fit when THIS fit checks
            # convergence
            return _fitloop.LoopState((), it=int(snap["n_iter"]),
                                      done=bool(snap["converged"])
                                      and self.check_convergence)

        def step(st, chunk):
            it = st.it + 1
            sv_idx = box["sv_idx"]
            if sv_idx is not None and len(sv_idx):
                # feed the global SVs back into every level-0 partition
                nodes = _pack_nodes([np.unique(np.r_[r[r >= 0], sv_idx])
                                     for r in nodes0])
            else:
                nodes = nodes0
            while True:
                alphas, objs = _solve_level_batched(
                    stage, yv, nodes, float(self.c), n, solver)
                if nodes.shape[0] == 1:
                    break
                nodes = self._merge_level(nodes, alphas)
            top_idx, top_alpha = nodes[0], alphas[0]

            def commit():
                # behind the verdict: a faulted iteration never leaves
                # its values in the box
                keep = (top_alpha > 1e-8) & (top_idx >= 0)
                if not keep.any():
                    warnings.warn("CascadeSVM: no support vector exceeded "
                                  "alpha=1e-8; retaining the max-alpha "
                                  "sample", RuntimeWarning, stacklevel=2)
                    keep[int(np.argmax(np.where(top_idx >= 0, top_alpha,
                                                -np.inf)))] = True
                w = float(objs[0])
                done = bool(self.check_convergence
                            and box["last_w"] is not None
                            and abs(w - box["last_w"])
                            <= self.tol * max(abs(w), 1e-12))
                box.update(sv_idx=top_idx[keep], last_w=w,
                           sv_alpha=top_alpha[keep].astype(np.float32))
                log.info("iter %d: W=%.6f, SVs=%d", it, w,
                         len(box["sv_idx"]))
                return _fitloop.LoopState((), it, done)

            return _fitloop.ChunkOutcome(
                commit, host_values={"sv_alpha": top_alpha,
                                     "objective": np.asarray(objs[0])})

        def snapshot(st):
            return {"sv_idx": np.asarray(box["sv_idx"], np.int64),
                    "sv_alpha": box["sv_alpha"], "last_w": box["last_w"],
                    "n_iter": st.it, "fp": fp, "digest": digest,
                    "converged": st.done}

        st = loop.run(init=init, step=step, restore=restore,
                      snapshot=snapshot)
        sv_idx = box["sv_idx"]
        self.iterations_n = self.n_iter_ = st.it
        self.converged_ = st.done
        self.fit_info_ = loop.info
        self._sv_idx = sv_idx
        self._sv_alpha = box["sv_alpha"]
        self._sv_x = stage.rows(sv_idx, n)
        self._sv_y = y_pm[sv_idx]
        self._gamma_fit = gamma
        self.support_vectors_count_ = len(sv_idx)
        return self

    def _merge_level(self, nodes, alphas):
        """Group nodes by cascade_arity; each group's (deduped) SV indices
        form one next-level node."""
        a = self.cascade_arity
        rows = []
        for g0 in range(0, nodes.shape[0], a):
            sv = []
            for ni in range(g0, min(g0 + a, nodes.shape[0])):
                keep = (alphas[ni] > 1e-8) & (nodes[ni] >= 0)
                sv.extend(nodes[ni][keep].tolist())
            # never emit an empty node
            rows.append(np.unique(sv) if sv
                        else np.asarray([int(nodes[g0][0])]))
        return _pack_nodes(rows)

    # -- inference -----------------------------------------------------------

    def decision_function(self, x) -> Array:
        """Signed margin per row, an (m, 1) float32 ds-array."""
        self._check_fitted()
        sv_x, sv_y, sv_alpha = self._predict_leaves(
            x.device, self._sv_x, self._sv_y, self._sv_alpha)
        dec = _decision(x, sv_x, sv_y * sv_alpha, self.kernel,
                        self._gamma_fit)
        return Array._from_padded(dec[:, None], (x.shape[0], 1), x._mesh)

    def predict(self, x) -> Array:
        """Class label per row, (m, 1): int32 for integer classes, else
        float32."""
        dec = self.decision_function(x)._data[: x.shape[0], 0]
        count_read("results")
        labels = self._classes_leaf()[(dec > 0).cpu().numpy().astype(
            np.int64)]
        return Array._from_padded(
            torch.as_tensor(labels[:, None], device=x.device),
            (x.shape[0], 1), x._mesh)

    def score(self, x, y) -> float:
        pred = self.predict(x).collect().ravel()
        truth = np.asarray(y.collect()).ravel()
        return float(np.mean(pred == truth))

    def _carry_in(self, arrays: dict, device):
        self._sv_x = np.array(arrays["_sv_x"], np.float32)
        self._sv_y = np.array(arrays["_sv_y"], np.float32)
        self._sv_alpha = np.array(arrays["_sv_alpha"], np.float32)
        self._sv_idx = np.array(arrays["_sv_idx"], np.int64)
        self._gamma_fit = float(arrays["_gamma_fit"])
        self.classes_ = np.asarray(arrays["classes_"])

    def _check_fitted(self):
        if not hasattr(self, "_sv_x"):
            raise RuntimeError("CascadeSVM is not fitted")


def _max_partition() -> int:
    return int(os.environ.get("DSLIB_CSVM_MAX_PARTITION", 4096))


def _solve_budget() -> int:
    return int(os.environ.get("DSLIB_CSVM_SOLVE_BUDGET", 2 << 30))


def _use_fista() -> bool:
    """Solver policy: DSLIB_CSVM_SOLVER in {auto (default), pg, fista};
    'auto' is plain PG, as in the reference."""
    v = os.environ.get("DSLIB_CSVM_SOLVER", "auto")
    if v not in ("auto", "pg", "fista"):
        raise ValueError(
            f"DSLIB_CSVM_SOLVER={v!r} — expected auto, pg or fista")
    return v == "fista"


def _pack_nodes(rows):
    """Stack variable-length index rows into a (-1)-padded matrix whose cap
    is rounded up to a power of two."""
    cap = max(1, max(len(r) for r in rows))
    cap = 1 << (cap - 1).bit_length()
    out = np.full((len(rows), cap), -1, np.int64)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


class _Staging:
    """Where a fit's node rows come from: ``"dense"`` (the fit set on its
    device), ``"ell"`` (a SparseArray's ELL buffers) or ``"csr"`` (a host
    CSR, kernel blocks computed with scipy)."""

    def __init__(self, x, kernel, gamma):
        self.kernel, self.gamma, self.device = kernel, gamma, x.device
        m, n = x.shape
        # rows of a multiple of 16 bytes on a card: the kernel's stream
        self.width = n if x.device.type != "cuda" else -(-n // 4) * 4
        self.r = 0
        if not isinstance(x, SparseArray):
            self.mode = "dense"
            xv = x._data[:m, :n].to(torch.float32)
            if self.width != n:
                xv = torch.nn.functional.pad(xv, (0, self.width - n))
            self.xv = xv.contiguous()
            return
        xs = x._distinct()
        ell = xs.ell()
        if ell is not None:
            self.mode = "ell"
            self.ev, self.ec = ell
            self.elen = xs._row_len
            self.r = int(self.ev.shape[1])
            return
        self.mode = "csr"
        self.csr = x.collect().tocsr()
        self.rowsq = np.asarray(self.csr.multiply(self.csr).sum(axis=1),
                                dtype=np.float32).ravel()

    def gather(self, safe):
        """(B, cap, width) float32 rows ``safe`` (B, cap) of the fit set."""
        if self.mode == "dense":
            return self.xv[safe]
        v = self.ev[safe]
        c = self.ec[safe].to(torch.int64)
        pad = torch.arange(self.r, device=v.device) >= \
            self.elen[safe][..., None]
        out = torch.zeros(safe.shape + (self.width + 1,), dtype=v.dtype,
                          device=v.device)
        out.scatter_(-1, c.masked_fill_(pad, self.width), v)
        return out[..., : self.width].contiguous()

    def host_gram(self, safe):
        """(w, cap, cap) kernel blocks of the rows ``safe`` (w, cap) of
        each node, from the host CSR with scipy (the reference's
        ``_host_gram``)."""
        w, cap = safe.shape
        k = np.empty((w, cap, cap), np.float32)
        for t in range(w):
            sub = self.csr[safe[t]]
            cross = np.asarray((sub @ sub.T).todense(), dtype=np.float32)
            if self.kernel == "rbf":
                rq = self.rowsq[safe[t]]
                cross = np.exp(-self.gamma * np.maximum(
                    rq[:, None] + rq[None, :] - 2.0 * cross, 0.0))
            k[t] = cross
        return k

    def rows(self, idx, n):
        """Host (len(idx), n) float32 rows ``idx`` (the support
        vectors)."""
        if self.mode == "csr":
            return np.asarray(self.csr[idx].toarray(), np.float32)
        safe = torch.as_tensor(np.asarray(idx, np.int64),
                               device=self.device)[None]
        count_read("results")
        return self.gather(safe)[0, :, :n].cpu().numpy()


@precise
def _gram(x_sub, kernel, gamma):
    """(B, cap, cap) kernel values of the nodes' rows ``x_sub``."""
    if kernel == "rbf":
        return torch.exp(-gamma * _k.distances_sq_batched(x_sub, x_sub))
    return torch.bmm(x_sub, x_sub.transpose(1, 2))


@precise
def _solve_nodes(stage, yv, nodes, c, solver):
    """(alpha (w, cap), objective (w,)) of the boxed dual of every node of
    ``nodes`` (w, cap), on the device."""
    idx = torch.as_tensor(nodes, device=yv.device)
    valid = idx >= 0
    safe = idx.clamp_min(0)
    # a padded slot stages row 0: it enters the step size, not the
    # solution (C = 0)
    if stage.mode == "csr":
        k_sub = torch.as_tensor(stage.host_gram(np.maximum(nodes, 0)),
                                device=yv.device) + 1.0
    else:
        k_sub = _gram(stage.gather(safe), stage.kernel, stage.gamma) + 1.0
    y_sub = yv[safe]
    q = k_sub * (y_sub[:, :, None] * y_sub[:, None, :])
    c_vec = torch.where(valid, c, 0.0).to(torch.float32)
    return _dual_ascent(q, c_vec, solver)


def _solve_level_batched(stage, yv, nodes, c, n_feat, solver):
    """One cascade level in node batches bounded by
    ``DSLIB_CSVM_SOLVE_BUDGET``: ~3 (cap, cap) float32 buffers a node, plus
    its gathered rows (and ELL staging); a batch past the first is padded
    with all-invalid nodes to the batch's size.  The batches go through
    ``ops/overlap.host_pipeline``.  Returns host ``(alphas,
    objectives)``, read once a batch (``HOST_READS["csvm"]``)."""
    n_nodes, cap = nodes.shape
    per_node = 3 * cap * cap * 4
    if stage.mode != "csr":
        per_node += cap * n_feat * 4
    if stage.mode == "ell":
        per_node += cap * stage.r * 8
    batch = min(n_nodes, max(1, _solve_budget() // per_node))

    def issue(b):
        chunk = nodes[b * batch: (b + 1) * batch]
        if chunk.shape[0] < batch:
            chunk = np.concatenate(
                [chunk, np.full((batch - chunk.shape[0], cap), -1, np.int64)])
        a, o = _solve_nodes(stage, yv, chunk, c, solver)
        return fetch_packed(a, o, site="csvm")

    def drain(b, pack):
        return pack.result()

    sched = _ov.resolve()
    _prof.count_schedule("csvm_levels", sched)
    res = _ov.host_pipeline(-(-n_nodes // batch), issue, drain,
                            overlap=_ov.overlapped(sched))
    return (np.concatenate([a for a, _ in res])[:n_nodes],
            np.concatenate([o for _, o in res])[:n_nodes])


def _clip(v, c_vec):
    """``jnp.clip(v, 0, c_vec)``: the lower bound first, then the
    upper."""
    return torch.minimum(torch.clamp_min(v, 0.0), c_vec)


def _dual_ascent(q, c_vec, solver="pg"):
    """Box-constrained dual maximization of every node of ``q`` (B, cap,
    cap) with bounds ``c_vec`` (B, cap): masked steps under
    :func:`run_chunked`, a node's state frozen once its ``delta`` is at
    most ``DELTA_TOL`` (the reference's per-node ``while_loop``).  Returns
    ``(alpha (B, cap), objective (B,))``, the objective on the ``q`` the
    solve holds."""
    eta = (1.0 / torch.clamp_min(torch.amax(torch.sum(torch.abs(q), dim=2),
                                            dim=1), 1e-12))[:, None]
    alpha = torch.zeros_like(c_vec)
    st = {"alpha": alpha, "delta": torch.full(
        (q.shape[0],), float("inf"), dtype=q.dtype, device=q.device)}
    if solver == "fista":
        st["z"] = alpha
        st["t"] = torch.ones((q.shape[0],), dtype=q.dtype, device=q.device)

    def gemv(v):
        return torch.bmm(q, v[:, :, None])[:, :, 0]

    def step(_):
        on = st["delta"] > DELTA_TOL
        a = st["alpha"]
        if solver == "fista":
            z, t = st["z"], st["t"]
            new = _clip(z + eta * (1.0 - gemv(z)), c_vec)
            # restart when the update opposes the momentum direction
            restart = torch.sum((z - new) * (new - a), dim=1) > 0.0
            t_next = torch.where(
                restart, 1.0, (1.0 + torch.sqrt(1.0 + 4.0 * t * t)) / 2.0)
            beta = torch.where(restart, 0.0, (t - 1.0) / t_next)
            st["z"] = torch.where(on[:, None],
                                  new + beta[:, None] * (new - a), z)
            st["t"] = torch.where(on, t_next, t)
        else:
            new = _clip(a + eta * (1.0 - gemv(a)), c_vec)
        st["alpha"] = torch.where(on[:, None], new, a)
        st["delta"] = torch.where(
            on, torch.amax(torch.abs(new - a), dim=1), st["delta"])

    run_chunked(step, lambda: torch.any(st["delta"] > DELTA_TOL), MAX_STEPS,
                "csvm")
    alpha = st["alpha"]
    return alpha, torch.sum(alpha, dim=1) - 0.5 * torch.sum(
        alpha * gemv(alpha), dim=1)


@precise
def _decision(x, sv_x, coef, kernel, gamma):
    """(m,) decision values ``(K(x, SV) + 1) @ (α·y)``: dense queries
    through the 2-D ``distances_sq`` kernel (rbf) or one GEMM (linear),
    sparse queries through one SpMM cross term."""
    if isinstance(x, SparseArray):
        q = x._distinct()
        cross = spmm_rows(q._row_len, q._cols, q._vals,
                          sv_x.T.contiguous())
        if kernel == "rbf":
            sv_sq = torch.sum(sv_x * sv_x, dim=1)
            k = torch.exp(-gamma * torch.clamp_min(
                q.row_norms_sq()[:, None] - 2.0 * cross + sv_sq[None, :],
                0.0))
        else:
            k = cross
    else:
        qv = x._data[: x.shape[0], : x.shape[1]].contiguous()
        if kernel == "rbf":
            k = torch.exp(-gamma * _k.distances_sq(qv, sv_x))
        else:
            k = qv @ sv_x.T
    return (k + 1.0) @ coef
