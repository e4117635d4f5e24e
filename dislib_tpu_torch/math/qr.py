"""QR decomposition.

Counterpart of ``dislib_tpu/math/qr.py``: the same routing and the same
algorithms on one device.

- Economic/'r' factorisations wider than one panel run the right-looking
  panel loop :func:`_qr_blocked`: each panel is re-orthogonalised against
  the accumulated Q, tsQR-factored (``decomposition/tsqr``), and the
  trailing columns are updated with GEMMs — block Gram–Schmidt with a
  second projection ("twice is enough").
- mode='full' at blocked sizes (m − n > one panel) builds the orthonormal
  complement from a Gaussian block projected twice against Q₁ and
  factored by the same panel loop (:func:`_qr_full_distributed`).
- Everything else is one Householder QR of the logical block
  (:func:`_qr_kernel`).

Modes follow the reference: 'full' (Q m×m, R m×n), 'economic' (Q m×k,
R k×n), 'r' (R only).

Across ranks the panel loop runs on each rank's rows (its blocks
all-gathered over 'cols', none on a one-column mesh): the projections
QᵀP and QₛᵀT are local products plus one ``psum`` over 'rows' each, each
panel is factored by the tsQR over the ranks
(``decomposition/tsqr._tsqr_ranks``) and the trailing update is local;
the complement's Gaussian block is drawn once at the padded height and
each rank keeps its rows.  The Householder QR of a small or short-wide
array factors the all-gathered array on every rank, as the reference's
replicated fallback does, and each rank keeps its blocks.
"""

from __future__ import annotations

import torch

from dislib_tpu_torch.data.array import Array, _block_geom, _padded_shape
from dislib_tpu_torch.decomposition.tsqr import _tsqr_ranks, _use_cholqr
from dislib_tpu_torch.math.base import grow_canvas
from dislib_tpu_torch.ops import precision as px
from dislib_tpu_torch.parallel import distributed as _dist
from dislib_tpu_torch.parallel import mesh as _mesh

# panel width for the blocked path (module-level so tests can shrink it)
_PANEL = 256


@px.precise
def _qr_kernel(a: torch.Tensor, mode: str):
    q, r = torch.linalg.qr(a, mode=mode)
    return q, r


def qr(a: Array, mode: str = "full", overwrite_a: bool = False,
       precision=None):
    """QR factorisation of a ds-array.

    mode='full':     returns (Q, R) with Q (m, m), R (m, n)
    mode='economic': returns (Q, R) with Q (m, k), R (k, n), k=min(m,n)
    mode='r':        returns R (k, n)

    ``precision``: mixed-precision policy (None → the
    ``DSLIB_MATMUL_PRECISION`` default) for the blocked path's projection
    and trailing-update GEMMs; panel factorisations stay float32, and the
    small/short-wide Householder QR ignores the policy.  Bounds in
    ``ops/precision.ERROR_BOUNDS``.
    """
    del overwrite_a
    if mode not in ("full", "economic", "r"):
        raise ValueError(f"unsupported mode {mode!r}")
    policy = px.resolve(precision)
    m, n = a.shape
    mesh = a._mesh
    p = mesh.rows
    mp = _padded_shape(a.shape, _mesh.pad_quantum(mesh))[0]
    blocked_ok = m >= n and n > _PANEL and mp // p >= _PANEL and mp % p == 0
    cholqr = _use_cholqr(a.device)
    if mode in ("economic", "r") and blocked_ok:
        q_rows, r = _qr_blocked(a._row_block(), (m, n), mesh, _PANEL,
                                cholqr=cholqr, policy=policy)
        if mode == "r":
            return Array._from_logical(r[:n, :n], mesh)
        return (Array._from_rows(q_rows, (m, n), mesh, a._reg_shape),
                Array._from_logical(r[:n, :n], mesh))
    if mode == "full" and blocked_ok and m - n > _PANEL:
        return _qr_full_distributed(a, m, n, mesh, policy)
    # every rank factors the whole array (the all-gather is the backing
    # itself on one rank) and keeps its blocks
    av = px.f32(a._gathered()[:m, :n])
    if mode == "full":
        q, r = _qr_kernel(av, "complete")
        return Array._from_logical(q, mesh), Array._from_logical(r, mesh)
    q, r = _qr_kernel(av, "reduced")
    if mode == "r":
        return Array._from_logical(r, mesh)
    return Array._from_logical(q, mesh), Array._from_logical(r, mesh)


def _qr_full_distributed(a: Array, m, n, mesh, policy=px.FLOAT32):
    """mode='full' by the panel loop: Q₁ from the economic loop, then an
    orthonormal complement Q₂ from a Gaussian block projected against Q₁
    (twice) and factored by the loop.  Rank-deficient A carries the same
    caveat as the economic path (Gram–Schmidt panels).

    Unlike the reference, Q₂ is then projected against Q₁ once more, in
    float32, and factored again.  The seed is a near-square Gaussian in
    the (m − n)-dimensional complement, so its factorisation amplifies
    the projections' residual Q₁ᵀG by cond(G): at 4096 × 512 one pass
    left ‖QᵀQ − I‖ at 6.3e-5 (float32) and 0.106 (bfloat16) on an H100,
    2.1e-3 and 0.144 on the CPU, against ``qr_orth`` 1e-4 and 4e-2
    (``tools/torch_linalg_diag.py``).  Q₂ is well conditioned, so the
    second pass brings it to the working precision of its GEMMs
    (ROADMAP.md C.5).  Across ranks every factor is this rank's rows."""
    cholqr = _use_cholqr(a.device)
    q1, r = _qr_blocked(a._row_block(), (m, n), mesh, _PANEL, cholqr=cholqr,
                        policy=policy)
    k = m - n
    g = _qr_complement_seed(q1, (m, n), k, mesh, policy)
    q2, _ = _qr_blocked(g, (m, k), mesh, _PANEL, cholqr=cholqr,
                        policy=policy)
    with px.precise():
        q2 = q2 - px.pdot(q1, _dist.psum(px.pdot(q1.T, q2), _mesh.ROWS,
                                         mesh))
    q2, _ = _qr_blocked(q2, (m, k), mesh, _PANEL, cholqr=cholqr,
                        policy=policy)
    q_rows = torch.cat([q1[:, :n], q2[:, :k]], dim=1)
    r_full = torch.zeros((m, n), dtype=torch.float32, device=q1.device)
    r_full[:n, :n] = r[:n, :n]
    return (Array._from_rows(q_rows, (m, m), mesh, a._reg_shape),
            Array._from_logical(r_full, mesh))


def _complement_draw(mp: int, k: int, device) -> torch.Tensor:
    """The complement's Gaussian block, from a fixed seed (0) so a full
    QR is deterministic.  It draws from a ``torch.Generator``: the same
    block every call in this package, not the reference's (threefry)
    draw."""
    g = torch.Generator(device=device).manual_seed(0)
    return torch.randn((mp, k), generator=g, dtype=torch.float32,
                       device=device)


@px.precise
def _qr_complement_seed(q1: torch.Tensor, shape, k: int, mesh,
                        policy=px.FLOAT32) -> torch.Tensor:
    """(rows, k) Gaussian block orthogonal to q1's columns up to roundoff:
    two projection passes I − Q₁Q₁ᵀ, on this rank's rows (the whole
    padded height on one rank) of one draw at the padded height.  q1's
    padded columns (≥ n) are zero, so they drop out of the
    projections."""
    m, _ = shape
    r0, _, ml, _ = _block_geom(shape, mesh)
    mp = _padded_shape(shape, _mesh.pad_quantum(mesh))[0]
    g = _complement_draw(mp, k, q1.device)[r0:r0 + ml].clone()
    g[max(0, m - r0):] = 0.0
    for _ in range(2):
        g = g - px.pdot(q1, _dist.psum(px.pdot(q1.T, g, policy),
                                       _mesh.ROWS, mesh), policy)
    return g


@px.precise
def _qr_blocked(ap: torch.Tensor, shape, mesh, panel, *, cholqr,
                policy=px.FLOAT32):
    """Right-looking blocked QR over the padded operand, or over this
    rank's rows of it (the projections then summed over 'rows', each
    panel tsQR-factored over the ranks).

    At panel j (offset off = j·panel): Q's columns < off are final and
    its columns ≥ off zero; the trailing matrix T's columns ≥ off hold
    every previous panel's update.  The panel is projected against Q's
    first ``off`` columns (the re-orthogonalisation pass), tsQR-factored,
    and the columns after it are updated.  Products touch only the
    columns that are non-zero, which is the reference's full-width
    products less their exact zeros."""
    m, n = shape
    b = panel
    n_panels = -(-n // b)
    n_pad = n_panels * b
    rows = ap.shape[0]
    r0 = _block_geom(shape, mesh)[0]
    # the panel canvas is zero-grown AND re-masked past the logical columns
    t = grow_canvas(px.f32(ap), (rows, n_pad), valid=(rows, n))
    q = torch.zeros((rows, n_pad), dtype=torch.float32, device=ap.device)
    r = torch.zeros((n_pad, n_pad), dtype=torch.float32, device=ap.device)
    for j in range(n_panels):
        off = j * b
        p_blk = t[:, off:off + b]
        if off:
            c = _dist.psum(px.pdot(q[:, :off].T, p_blk, policy), _mesh.ROWS,
                       mesh)
            p_blk = p_blk - px.pdot(q[:, :off], c, policy)
            r[:off, off:off + b] += c
        qs, rs = _tsqr_ranks(p_blk, mesh, cholqr=cholqr)
        r[off:off + b, off:off + b] = rs
        if off + b < n_pad:
            g = _dist.psum(px.pdot(qs.T, t[:, off + b:], policy),
                           _mesh.ROWS, mesh)
            t[:, off + b:] -= px.pdot(qs, g, policy)
            r[off:off + b, off + b:] = g
        q[:, off:off + b] = qs
    # a fully padded shard's local QR can leave garbage in Q's pad rows
    q[max(0, m - r0):] = 0.0
    q[:, n:] = 0.0
    return q, r
