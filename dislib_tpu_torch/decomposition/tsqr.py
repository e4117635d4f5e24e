"""Tall-skinny QR.

Counterpart of ``dislib_tpu/decomposition/tsqr.py``.  The reference runs one
``shard_map`` over the mesh's row axis: each of the p shards factors its
rows (A_i = Q1_i R_i), ONE ``all_gather`` stacks the p R factors, every
shard factors the (p·n, n) stack (R_stack = Q2 R) and forms
Q_i = Q1_i · Q2[i].  :func:`_tsqr_ranks` runs it over the ranks of a
``torch.distributed`` job: each factors its row block and ONE
``all_gather`` over 'rows' stacks the R factors; on the one-card
``(1, 1)`` mesh p = 1 and the gather is the identity.
:func:`_tsqr_shardmap` keeps the algorithm for p row shards of one
backing (random_svd's replicated (n, sketch) factor, the 8-shard parity
test); ``math/qr``'s panels run :func:`_tsqr_ranks`.

The local factorisation is the batched Householder reduction tree
(:func:`_local_tsqr`) or CholeskyQR2 (:func:`_cholqr2`), chosen by
``DSLIB_TSQR_CHOLQR`` (:func:`_use_cholqr`).  CholeskyQR2 reads ONE
scalar on the host per local QR to decide whether its result is usable;
when it is not, the Householder tree runs instead — never an error.
Across ranks that decision is agreed (``distributed.any_rank``).
"""

from __future__ import annotations

import os

import torch

from dislib_tpu_torch.data.array import Array
from dislib_tpu_torch.ops import precision as px
from dislib_tpu_torch.parallel import distributed as _dist
from dislib_tpu_torch.parallel import mesh as _mesh
from dislib_tpu_torch.utils.profiling import host_read


def tsqr(a: Array, mode: str = "reduced", indexes=None, precision=None):
    """Tall-skinny QR.

    mode='reduced' → (Q (m, n), R (n, n));  mode='r' → R only.
    ``indexes`` (reference parity): restrict the returned Q to these
    column indices after factorisation.

    ``precision``: mixed-precision policy (None → the
    ``DSLIB_MATMUL_PRECISION`` default).  The policy governs the Q
    assembly GEMMs; the local factorisations and the R-stack merge stay
    float32 — bounds in ``ops/precision.ERROR_BOUNDS``.
    """
    if mode not in ("reduced", "r"):
        raise ValueError(f"unsupported mode {mode!r}")
    policy = px.resolve(precision)
    m, n = a.shape
    if m < n:
        raise ValueError("tsqr requires a tall-skinny array (m >= n)")
    mesh = a._mesh
    if indexes is not None and mesh.world > 1:
        raise NotImplementedError(
            "tsqr(indexes=...) of a ds-array sharded over several ranks "
            "needs column indexing (ROADMAP.md A.11)")
    # this rank's rows (the whole padded backing on one rank), padded
    # rows kept (zeros), columns cropped
    av = px.f32(a._row_block()[:, :n])
    q_rows, r = _tsqr_ranks(av, mesh, cholqr=_use_cholqr(av.device),
                            policy=policy)
    if mode == "r":
        return Array._from_logical(r, mesh)
    q = Array._from_rows(q_rows, (m, n), mesh, a._reg_shape)
    if indexes is not None:
        q = q[:, list(indexes)]
    return q, Array._from_logical(r, mesh)


@px.precise
def _tsqr_ranks(av: torch.Tensor, mesh, *, cholqr: bool,
                policy=px.FLOAT32):
    """tsQR over the ranks of ``mesh``'s 'rows' axis, ``av`` this rank's
    rows (mesh row i of p; the whole array on one rank, p = 1): a local
    QR, ONE ``all_gather`` of the (n, n) R factors over 'rows' (the
    reference's), one QR of the (p·n, n) stack on every rank, and
    Q_i = Q1_i · Q2[i].  A block shorter than n rows is padded with zero
    rows, which leave Q's rows and R exact.  Returns (Q_i with ``av``'s
    rows, R).  At a world of one the gather runs over a group of one and
    the factors equal those with no process group, bit for bit."""
    rows, n = av.shape
    if rows < n:
        av = torch.nn.functional.pad(av, (0, 0, 0, n - rows))
    q1, r1 = _local_qr(av, cholqr, policy, mesh)
    # (p·n, n), contiguous as a gathered stack is, whatever the route
    r_stack = _dist.all_gather(r1.contiguous(), _mesh.ROWS, 0, mesh)
    q2, r = _local_qr(r_stack, cholqr, policy, mesh)
    i = mesh.coord[0]
    q = px.pdot(q1, q2[i * n:(i + 1) * n], policy)
    return q[:rows], r


def _use_cholqr(device) -> bool:
    """The local factorisation: ``DSLIB_TSQR_CHOLQR`` in {auto (default),
    1, 0}.  'auto' takes CholeskyQR2 on a CUDA device, where its GEMMs and
    triangular solve beat the column-sequential Householder QR (timed
    both ways at 65536 × 256 by ``chip_smoke.py``; PERF.md), and the
    Householder tree on the CPU, the route the reference takes there."""
    v = os.environ.get("DSLIB_TSQR_CHOLQR", "auto")
    if v == "auto":
        return torch.device(device).type == "cuda"
    return v == "1"


def _cholqr2(a: torch.Tensor):
    """CholeskyQR2: two rounds of Gram → Cholesky → triangular solve.

    Returns (Q, R, ok) with ``ok`` a device bool: False when a Gram
    Cholesky broke down (``cholesky_ex``'s ``info`` ≠ 0, or a non-finite
    factor) or when round 1's orthogonality error ‖R₂ᵀR₂ − I‖_max — read
    off the second factor, since R₂ᵀR₂ = Q₁ᵀQ₁ — is 0.1 or more, where
    round 2 no longer restores orthogonality to O(u)."""
    def one_round(q):
        g = q.T @ q
        ell, info = torch.linalg.cholesky_ex(g)          # G = L Lᵀ, R = Lᵀ
        q_next = torch.linalg.solve_triangular(ell, q.T, upper=False).T
        return q_next, ell.T, info

    q1, r1, info1 = one_round(a)
    q2, r2, info2 = one_round(q1)
    r = r2 @ r1
    n = a.shape[1]
    eye = torch.eye(n, dtype=r2.dtype, device=r2.device)
    round1_err = torch.max(torch.abs(r2.T @ r2 - eye))
    ok = (torch.isfinite(q2).all() & torch.isfinite(r).all()
          & (round1_err < 0.1) & (info1 == 0) & (info2 == 0))
    return q2, r, ok


def _local_qr(a: torch.Tensor, cholqr: bool, policy=px.FLOAT32,
              mesh=None):
    """One shard's tall-skinny QR: CholeskyQR2 when ``cholqr``, falling
    back to the Householder tree when its ``ok`` (one host read) is
    False; the tree otherwise.  ``policy`` governs only the tree's batched
    Q-apply GEMMs.  On a ``mesh`` of a ``torch.distributed`` job the
    route is agreed: the tree runs on every rank when ``ok`` is False on
    any (``distributed.any_rank``), so the ranks' R factors come from one
    route."""
    if cholqr:
        q_c, r_c, ok = _cholqr2(a)
        bad = not host_read(ok, "cholqr2_ok")
        if mesh is not None and mesh.groups is not None:
            bad = _dist.any_rank(bad, mesh)
        if not bad:
            return q_c, r_c
    return _local_tsqr(a, policy)


def _split_count(rows: int, n: int, target: int = 8) -> int:
    """Largest power-of-two ``s`` dividing ``rows`` with panels ≥
    target·n tall."""
    s = 1
    while rows % (2 * s) == 0 and rows // (2 * s) >= target * max(n, 1):
        s *= 2
    return s


def _local_tsqr(a: torch.Tensor, policy=px.FLOAT32):
    """Shard-local tall-skinny QR as a batched reduction tree: factor
    ``s`` sub-panels as ONE batched QR, then recurse on the (s·n, n)
    R-stack until it is too short to split; a plain QR when ``a`` is."""
    rows, n = a.shape
    s = _split_count(rows, n)
    if s == 1:
        q, r = torch.linalg.qr(a, mode="reduced")
        return q, r
    q0, r0 = torch.linalg.qr(a.reshape(s, rows // s, n), mode="reduced")
    q1, r = _local_tsqr(r0.reshape(s * n, n), policy)
    q = px.pdot(q0, q1.reshape(s, n, n), policy)             # batched GEMM
    return q.reshape(rows, n), r


@px.precise
def _tsqr_shardmap(av: torch.Tensor, mesh, p: int, *, cholqr: bool,
                   policy=px.FLOAT32):
    """tsQR over the ``p`` row shards of ``av`` (the rows of ``mesh``):
    a local QR per shard, the R factors stacked (the reference's
    ``all_gather``; the identity at p = 1), one QR of the stack, and each
    shard's Q1 times its (n, n) slice of Q2.  ``cholqr`` is required so
    every caller resolves :func:`_use_cholqr` itself."""
    rows, n = av.shape
    shards = av.reshape(p, rows // p, n)
    local = [_local_qr(shards[i], cholqr, policy, mesh) for i in range(p)]
    r_stack = torch.cat([r1 for _, r1 in local], dim=0)      # (p·n, n)
    q2, r = _local_qr(r_stack, cholqr, policy, mesh)
    q = torch.cat([px.pdot(q1, q2[i * n:(i + 1) * n], policy)
                   for i, (q1, _) in enumerate(local)], dim=0)
    return q, r
