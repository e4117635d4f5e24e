"""Blocked math: the distributed GEMM, ``kron`` and ``svd``.

Counterpart of ``dislib_tpu/math/base.py``.  ``matmul`` is one entry with
two dense schedules:

- ``"xla"``: one product of the whole padded operands through
  ``ops/precision.pdot`` — a plain product, which the reference also
  leaves to its compiler (the name is kept so ``algorithm=`` and
  ``DSLIB_MATMUL_ALGO`` mean the same in both packages);
- ``"summa"``: the explicit panel schedule (``ops/summa``) under the
  ``DSLIB_OVERLAP`` schedule; ``kernel``/``pallas`` runs its panel GEMM on
  the hand CUDA kernel.

On a mesh of several ranks ``auto`` keeps the reference's rule (SUMMA on
a 2-D mesh at ``_summa_min_dim`` and above) and ``xla`` multiplies this
rank's rows of A by its columns of B, each all-gathered once
(:func:`_matmul_ranks`, the one place of that rule); of the transposed
forms, AᵀB of two row-sharded arrays of one height and A·Bᵀ with a
small B run there (random_svd's and PCA's), the others raise.

``kron`` builds its output from the index lattice; ``svd`` is the
reference's one-sided Jacobi in both tiers (scalar Givens pairs below two
column blocks, column-block pairs above), its sweeps driven from the host
with ONE scalar read per sweep.  Across ranks ``kron`` all-gathers both
operands and each rank computes its block of the lattice; ``svd``
rotates each rank's rows (its blocks all-gathered over 'cols'): a
round's 2×2 Grams are one batched ``psum`` over 'rows' (scalar tier),
its pair QRs a tsQR tree, local QRs plus one ``all_gather`` of the
(2b, 2b) R factors (block tier), the sweep's convergence value is
``pmax``-reduced and V is computed on every rank.

A sparse lhs (``data/sparse.SparseArray``) takes the reference's second
router, ``algorithm="auto"|"spmm"|"densify"``: ``spmm`` is
``ops/spmm.spmm``; ``densify`` materialises the dense operand on the
device (budget-guarded) and takes the dense route; ``auto`` picks spmm at
or below ``DSLIB_SPMM_MAX_DENSITY`` (default 0.1) or whenever densifying
would pass ``DSLIB_SPARSE_DENSIFY_BUDGET``, densify otherwise.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from dislib_tpu_torch.data.array import Array, _block_geom, \
    _padded_shape
from dislib_tpu_torch.ops import overlap as _ov
from dislib_tpu_torch.ops import precision as px
from dislib_tpu_torch.ops.summa import summa_matmul, summa_supported
from dislib_tpu_torch.parallel import distributed as _dist
from dislib_tpu_torch.parallel import mesh as _mesh
from dislib_tpu_torch.utils.profiling import host_read

# auto-SUMMA size gate: below this min logical dimension an explicit panel
# schedule buys nothing over one product (``DSLIB_SUMMA_MIN_DIM``
# overrides at runtime, as in the reference)
_SUMMA_MIN_DIM = 256


def _summa_min_dim() -> int:
    env = os.environ.get("DSLIB_SUMMA_MIN_DIM")
    return int(env) if env else _SUMMA_MIN_DIM


def _pick_algorithm(algorithm, a, b, a_shape, b_shape, transpose_a,
                    transpose_b):
    """The matmul routing rule: an explicit ``algorithm=`` wins; ``"auto"``
    consults ``DSLIB_MATMUL_ALGO``, then picks ``"summa"`` on a genuinely
    2-D mesh for untransposed operands whose every logical dim is at least
    ``_SUMMA_MIN_DIM``, and ``"xla"`` otherwise."""
    if algorithm not in ("auto", "summa", "xla"):
        raise ValueError(f"unknown matmul algorithm {algorithm!r}: "
                         "expected 'auto', 'summa' or 'xla'")
    if algorithm == "auto":
        env = os.environ.get("DSLIB_MATMUL_ALGO", "auto")
        if env not in ("auto", "summa", "xla"):
            raise ValueError(f"bad DSLIB_MATMUL_ALGO={env!r}")
        algorithm = env
    if algorithm == "auto":
        big = min(a_shape[0], a_shape[1], b_shape[1]) >= _summa_min_dim()
        return "summa" if (big and summa_supported(a._mesh)
                           and not (transpose_a or transpose_b)) else "xla"
    return algorithm


def matmul(a: Array, b: Array, transpose_a: bool = False,
           transpose_b: bool = False, *, algorithm: str = "auto",
           precision=None) -> Array:
    """Distributed GEMM (reference: ``dislib_tpu.math.matmul``).

    ``precision``: the mixed-precision policy (None → the
    ``DSLIB_MATMUL_PRECISION`` default) — ``"bfloat16"`` contracts
    bf16-compute / f32-accumulate within ``ERROR_BOUNDS``; the default is
    float32-faithful.  A sparse lhs takes the spmm/densify router (see the
    module docstring)."""
    from dislib_tpu_torch.data.sparse import SparseArray
    if isinstance(a, SparseArray) or isinstance(b, SparseArray):
        return _matmul_sparse(a, b, transpose_a, transpose_b, algorithm,
                              precision)
    if type(a) is not Array or type(b) is not Array:
        raise TypeError(
            f"matmul of {type(a).__name__} @ {type(b).__name__}: the "
            "operands must be ds-arrays")
    if a.device != b.device:
        raise ValueError(f"matmul operands live on different devices: "
                         f"{a.device} vs {b.device}")
    policy = px.resolve(precision)
    a_shape = (a.shape[1], a.shape[0]) if transpose_a else a.shape
    b_shape = (b.shape[1], b.shape[0]) if transpose_b else b.shape
    if a_shape[1] != b_shape[0]:
        raise ValueError(f"matmul shape mismatch: {a_shape} @ {b_shape}")
    out_shape = (a_shape[0], b_shape[1])
    reg = (a._reg_shape[1] if transpose_a else a._reg_shape[0],
           b._reg_shape[0] if transpose_b else b._reg_shape[1])
    algo = _pick_algorithm(algorithm, a, b, a_shape, b_shape, transpose_a,
                           transpose_b)
    if a._mesh.world > 1 or b._mesh.world > 1:
        return _matmul_ranks(a, b, transpose_a, transpose_b, algo, policy,
                             out_shape, reg)
    if algo == "summa":
        return _matmul_summa(a, b, transpose_a, transpose_b, policy,
                             out_shape, reg)
    ad, bd = _match_inner(a._data, b._data, transpose_a, transpose_b)
    # zero-padding invariant => padded contraction == logical contraction
    out = px.pdot(ad.T if transpose_a else ad, bd.T if transpose_b else bd,
                  policy)
    return Array(_crop_or_keep(out, out_shape), out_shape, a._mesh, reg)


def _spmm_max_density() -> float:
    """The density at which auto stops preferring SpMM over one dense
    GEMM (``DSLIB_SPMM_MAX_DENSITY``, default 0.1)."""
    return float(os.environ.get("DSLIB_SPMM_MAX_DENSITY", "0.1"))


def _pick_sparse_algorithm(a, algorithm):
    """The sparse matmul routing rule: an explicit ``algorithm=`` wins;
    auto takes spmm at or below the density threshold, densify above it
    unless the dense operand would pass the byte budget."""
    from dislib_tpu_torch.data.sparse import densify_budget_bytes
    if algorithm not in ("auto", "spmm", "densify"):
        raise ValueError(
            f"unknown sparse matmul algorithm {algorithm!r}: expected "
            "'auto', 'spmm' or 'densify'")
    if algorithm != "auto":
        return algorithm
    m, n = a.shape
    if a.nnz / max(m * n, 1) <= _spmm_max_density():
        return "spmm"
    pm, pn = _padded_shape(a.shape, _mesh.pad_quantum(a._mesh))
    return "spmm" if 4 * pm * pn > densify_budget_bytes() else "densify"


def _matmul_sparse(a, b, transpose_a, transpose_b, algorithm, precision):
    """SparseArray @ dense ds-array through the spmm/densify router.
    Transposed and sparse-rhs forms raise, as in the reference."""
    from dislib_tpu_torch.data.sparse import SparseArray
    from dislib_tpu_torch.ops.spmm import spmm
    if isinstance(b, SparseArray) or not isinstance(a, SparseArray) \
            or transpose_a or transpose_b:
        raise TypeError(
            "the sparse matmul fast path covers sparse @ dense with no "
            "transposes — transpose via SparseArray.T (sparse, O(nnz)) "
            "or densify explicitly with .to_dense() for other forms")
    if not isinstance(b, Array):
        raise TypeError(f"matmul rhs must be a dense ds-array, "
                        f"got {type(b).__name__}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul shape mismatch: {a.shape} @ {b.shape}")
    if _pick_sparse_algorithm(a, algorithm) == "spmm":
        return spmm(a, b, precision=precision)
    return matmul(a.to_dense(), b, precision=precision)


def _matmul_summa(a, b, transpose_a, transpose_b, policy, out_shape, reg):
    """The SUMMA route.  Requested transposes materialise first."""
    if transpose_a:
        a = a.transpose()
    if transpose_b:
        b = b.transpose()
    ad, bd = _match_inner(a._data, b._data, False, False)
    out = summa_matmul(ad, bd, a._mesh, policy, overlap=_ov.resolve())
    return Array(_crop_or_keep(out, out_shape), out_shape, a._mesh, reg)


def _matmul_ranks(a, b, transpose_a, transpose_b, algo, policy, out_shape,
                  reg):
    """The product of two ds-arrays sharded over one mesh of several
    ranks, into this rank's block of C.  ``summa``: the panel schedule.
    ``xla``: this rank's rows of A (its block all-gathered over 'cols')
    times its columns of B (all-gathered over 'rows') — what GSPMD plans
    for the reference's sharded dot; on a one-column mesh only B
    moves.  Two transposed forms: ``transpose_a`` (AᵀB of two arrays
    that share their rows) is each rank's rows' AᵢᵀBᵢ, summed by one
    ``psum`` over 'rows'; ``transpose_b`` gathers the whole of B (the
    small operand, as PCA's components) on every rank and multiplies the
    rank's rows by Bᵀ.  Every other transposed form needs the transpose's
    exchange and raises."""
    mesh = a._mesh
    if b._mesh != mesh:
        raise ValueError("matmul operands live on different meshes")
    if (transpose_a or transpose_b) and (
            algo == "summa" or (transpose_a and transpose_b)):
        raise NotImplementedError(
            "this transposed matmul of ds-arrays sharded over several "
            "ranks needs the transpose's exchange (ROADMAP.md A.11)")
    r0, c0, ml, nl = _block_geom(out_shape, mesh)
    if transpose_a:
        out = _dist.psum(px.pdot(a._row_block().T, b._row_block(), policy),
                         _mesh.ROWS, mesh)
        return Array(out[r0:r0 + ml, c0:c0 + nl].contiguous(), out_shape,
                     mesh, reg)
    if transpose_b:
        out = px.pdot(a._row_block(), b._gathered().T, policy)
        return Array(out[:, c0:c0 + nl].contiguous(), out_shape, mesh, reg)
    if algo == "summa":
        out = summa_matmul(a._local, b._local, mesh, policy,
                           overlap=_ov.resolve())
    else:
        out = px.pdot(a._row_block(),
                      _dist.all_gather(b._local, _mesh.ROWS, 0, mesh), policy)
    return Array(out, out_shape, mesh, reg)


def _match_inner(ad, bd, transpose_a, transpose_b):
    """Equalize the padded contraction dims of the two backings (operands
    padded to different quanta)."""
    inner_a = ad.shape[0] if transpose_a else ad.shape[1]
    inner_b = bd.shape[1] if transpose_b else bd.shape[0]
    if inner_a != inner_b:
        pad_to = max(inner_a, inner_b)
        if transpose_a:
            ad = grow_canvas(ad, (pad_to, ad.shape[1]))
        else:
            ad = grow_canvas(ad, (ad.shape[0], pad_to))
        if transpose_b:
            bd = grow_canvas(bd, (bd.shape[0], pad_to))
        else:
            bd = grow_canvas(bd, (pad_to, bd.shape[1]))
    return ad, bd


def grow_canvas(data: torch.Tensor, shape, valid=None) -> torch.Tensor:
    """THE shared pad/crop helper: place ``data`` on a zero canvas of
    ``shape`` and — when ``valid`` = (rows, cols) is given — re-zero
    everything outside the valid region.  Every blocked-linalg routine that
    grows an operand (QR panels, block-Jacobi column blocks, matmul
    quantum repads) goes through here, so a padded tail never enters a
    reduced-precision accumulation as garbage (zero is exact in every
    policy dtype)."""
    grown = data
    if tuple(data.shape) != tuple(shape):
        grown = torch.zeros(tuple(shape), dtype=data.dtype,
                            device=data.device)
        src = data[: shape[0], : shape[1]]
        grown[: src.shape[0], : src.shape[1]] = src
    if valid is not None:
        r = torch.arange(grown.shape[0], device=grown.device) < valid[0]
        c = torch.arange(grown.shape[1], device=grown.device) < valid[1]
        grown = torch.where(r[:, None] & c[None, :], grown,
                            torch.zeros((), dtype=grown.dtype,
                                        device=grown.device))
    return grown


def _crop_or_keep(padded, logical_shape):
    """The product of two quantum-padded operands is already
    quantum-padded for the output logical shape."""
    del logical_shape
    return padded


# ---------------------------------------------------------------------------
# kron
# ---------------------------------------------------------------------------

def kron(a: Array, b: Array, block_size=None) -> Array:
    """Kronecker product (reference: ``dislib_tpu.math.kron``), computed
    straight into the output through the index lattice
    ``out[r, c] = a[r // mb, c // nb] · b[r % mb, c % nb]`` — row and column
    gathers of the operands, never the 4-D broadcast.  Across ranks both
    operands are all-gathered and each rank computes the lattice of its
    own block; every entry is one float product, so the result does not
    depend on the mesh."""
    if a.device != b.device:
        raise ValueError(f"kron operands live on different devices: "
                         f"{a.device} vs {b.device}")
    (ma, na), (mb, nb) = a.shape, b.shape
    shape = (ma * mb, na * nb)
    mesh = a._mesh
    if b._mesh != mesh:
        raise ValueError("kron operands live on different meshes")
    r0, c0, ml, nl = _block_geom(shape, mesh)
    out = _kron_kernel(a._gathered(), b._gathered(), (a.shape, b.shape),
                       (ml, nl), (r0, c0))
    return Array(out, shape, mesh, reg_shape=block_size)


def _kron_kernel(ap, bp, shapes, pshape, at):
    """The ``pshape`` block at global offset ``at`` of the Kronecker
    product of the logical regions of ``ap`` and ``bp``, zero past the
    logical shape."""
    (ma, na), (mb, nb) = shapes
    av, bv = ap[:ma, :na], bp[:mb, :nb]
    ri = at[0] + torch.arange(pshape[0], device=ap.device)
    ci = at[1] + torch.arange(pshape[1], device=ap.device)
    # clamp keeps the pad-region gathers in bounds; the mask re-zeroes them
    a_exp = av[torch.clamp(ri // mb, 0, ma - 1)][
        :, torch.clamp(ci // nb, 0, na - 1)]
    b_til = bv[ri % mb][:, ci % nb]
    valid = (ri < ma * mb)[:, None] & (ci < na * nb)[None, :]
    return torch.where(valid, a_exp * b_til, 0.0)


# ---------------------------------------------------------------------------
# svd — one-sided Jacobi, the reference's two tiers
# ---------------------------------------------------------------------------

# per-policy convergence floors: the off-diagonal measure cannot fall below
# the pair-update GEMMs' own rounding (~2^-9 per operand under bfloat16)
_SVD_EPS_FLOOR = {"float32": 1e-6, "bfloat16": 5e-3}
_JACOBI_BLOCK = 64


def svd(a: Array, compute_uv: bool = True, sort: bool = True,
        copy: bool = True, eps: float = 1e-6, max_sweeps: int = 30,
        precision=None):
    """One-sided Jacobi SVD (reference: ``dislib_tpu.math.svd``).

    Returns (U, S, V) ds-arrays with S of shape (1, n) — or S alone when
    ``compute_uv=False``.  Two tiers, both rotating every disjoint pair of
    a round-robin round at once:

    - n < 2·64 (or m < 2·64): scalar column pairs, one Givens rotation per
      pair, always float32;
    - otherwise the column-BLOCK pairing: per pair of 64-column blocks one
      batched tall QR, a small SVD of R and a tall GEMM apply.  The two
      pair-update GEMMs follow ``precision`` (``px.peinsum``); the QR, the
      convergence Gram and the small SVD stay float32.

    A sweep ends with ONE host read of its largest off-diagonal measure
    (``utils.profiling.host_read``), and the loop stops at the sweep where
    the reference's ``while_loop`` stops.  ``eps`` below 1e-6 is clamped
    with a warning (float32's pairwise-orthogonality floor); under
    bfloat16 the block tier's floor is 5e-3.  Bounds:
    ``ERROR_BOUNDS[("svd_values"|"svd_resid", policy)]``.  The tiers are
    chosen on the padded shape, so a mesh of ranks takes the tier the
    reference takes on it."""
    del copy
    policy = px.resolve(precision)
    m, n = a.shape
    mesh = a._mesh
    if float(eps) < 1e-6:
        warnings.warn(
            f"svd: eps={eps:g} is below the float32 convergence floor; "
            "clamping to 1e-6 (the 1e-9-style defaults presume float64 "
            "blocks)", RuntimeWarning, stacklevel=2)
    eps = max(float(eps), 1e-6)
    # the pad rows/cols are zero, so they add nothing to the column dot
    # products; re-masking at ingest keeps a poisoned tail out of them
    rows = a._row_block()
    av = grow_canvas(px.f32(rows), rows.shape,
                     valid=(max(0, m - a._at[0]), n))
    pm, pn = _padded_shape(a.shape, _mesh.pad_quantum(mesh))
    with px.precise():
        if pn >= 2 * _JACOBI_BLOCK and pm >= 2 * _JACOBI_BLOCK:
            eps = max(eps, _SVD_EPS_FLOOR.get(policy.name, 1e-6))
            u, s, v = _jacobi_svd_block(av, n, sort, eps, max_sweeps,
                                        policy, mesh)
        else:
            u, s, v = _jacobi_svd(av, n, sort, eps, max_sweeps, mesh)
    s_arr = Array._from_logical(s[:n].reshape(1, -1), mesh)
    if not compute_uv:
        return s_arr
    return (Array._from_rows(u, (m, n), mesh), s_arr,
            Array._from_logical(v[:n, :n].contiguous(), mesh))


def _sweep_rounds(n, device):
    """The round-robin schedule as (i, j) index tensors per round."""
    pairs = torch.as_tensor(_round_robin_pairs(n), device=device)
    return [(pr[:, 0], pr[:, 1]) for pr in pairs]


def _col_norms(u, mesh):
    """The norms of ``u``'s columns, whose rows are spread over the rows
    of ``mesh`` (on a mesh of one row ``u`` holds every row)."""
    if mesh.rows == 1:
        return torch.linalg.norm(u, dim=0)
    return torch.sqrt(_dist.psum(torch.sum(u * u, dim=0), _mesh.ROWS, mesh))


def _sweep_off(offs, mesh):
    """The sweep's largest off-diagonal measure, ``pmax``-reduced over
    every rank, read on the host once."""
    off = _dist.pmax(torch.stack(offs).max(), _dist.ALL, mesh)
    return host_read(off, "svd_sweep")


def _jacobi_svd(a, n_valid, sort, eps, max_sweeps, mesh):
    """Scalar tier: one Givens rotation per disjoint column pair, every
    pair of a round from the pre-round matrix.  ``a`` is a fresh canvas
    (``svd``'s ingest copy) and is rotated in place; across ranks it is
    this rank's rows, and each round's 2×2 Grams are one ``psum``."""
    m, n = a.shape
    rounds = _sweep_rounds(n, a.device)
    u = a
    v = torch.eye(n, dtype=a.dtype, device=a.device)
    off, it = float("inf"), 0
    while off > eps and it < max_sweeps:
        offs = []
        for i, j in rounds:
            ui, uj = u[:, i], u[:, j]
            aii, ajj, aij = _dist.psum(torch.stack([
                torch.sum(ui * ui, dim=0), torch.sum(uj * uj, dim=0),
                torch.sum(ui * uj, dim=0)]), _mesh.ROWS, mesh).unbind()
            tau = (ajj - aii) / (2.0 * torch.where(aij.abs() < 1e-30,
                                                   1e-30, aij))
            t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s_ = c * t
            off_r = aij.abs() / torch.sqrt(torch.clamp(aii * ajj, min=1e-30))
            c = torch.where(off_r < eps, 1.0, c)
            s_ = torch.where(off_r < eps, 0.0, s_)
            u[:, i] = c * ui - s_ * uj
            u[:, j] = s_ * ui + c * uj
            vi, vj = v[:, i], v[:, j]
            v[:, i] = c * vi - s_ * vj
            v[:, j] = s_ * vi + c * vj
            offs.append(off_r.max())
        off = _sweep_off(offs, mesh)
        it += 1
    s = _col_norms(u, mesh)
    u = u / torch.where(s < 1e-30, 1.0, s)[None, :]
    # V's pad diagonal starts at 1 (eye) and must not leak out
    col_ok = torch.arange(n, device=a.device) < n_valid
    s = torch.where(col_ok, s, 0.0)
    u = u * col_ok[None, :].to(u.dtype)
    v = v * (col_ok[None, :] & col_ok[:, None]).to(v.dtype)
    if sort:
        order = torch.argsort(-s, stable=True)  # pad zeros stay behind
        s, u, v = s[order], u[:, order], v[:, order]
    return u, s, v


def _pair_qr(w, mesh):
    """The batched tall QR of the round's column-block pairs ``w`` (pairs,
    rows, 2b).  On a mesh of several rows (``w`` this rank's rows) it is
    the tsQR tree:
    local QRs, ONE ``all_gather`` of the (2b, 2b) R factors over 'rows',
    one QR of each pair's stack on every rank, and the local Q times its
    slice of the stack's Q.  A block shorter than 2b rows is padded with
    zero rows, which leave Q's rows and R exact."""
    if mesh.rows == 1:
        return torch.linalg.qr(w, mode="reduced")
    rows, c = w.shape[1], w.shape[2]
    if rows < c:
        w = torch.nn.functional.pad(w, (0, 0, 0, c - rows))
    q1, r1 = torch.linalg.qr(w, mode="reduced")
    stack = _dist.all_gather(r1.contiguous(), _mesh.ROWS, 1, mesh)
    q2, r = torch.linalg.qr(stack, mode="reduced")
    i = mesh.coord[0]
    return (q1 @ q2[:, i * c:(i + 1) * c])[:, :rows], r


def _jacobi_svd_block(a, n_valid, sort, eps, max_sweeps, policy, mesh):
    """Block tier: round-robin over column blocks of width b.

    Per disjoint block pair (I, J), batched over the round's pairs:
    W = [U_I | U_J] = Q_w R (one batched tall QR, :func:`_pair_qr`),
    R = U_r Σ V_rᵀ (one batched (2b, 2b) SVD), then U_pair ← Q_w U_r Σ and
    V_pair ← V_pair V_r.  The new columns are orthogonal to working
    precision whatever the pair's conditioning (R's SVD is σ-relative);
    R comes from the QR, never from the pair's Gram, which would square
    the condition number.  Convergence is measured on G = RᵀR.  Zero
    (pad) columns stay zero; V starts with pad columns zeroed; positions
    ≥ n_valid are re-masked after the final sort.  Across ranks ``a`` is
    this rank's rows and V is computed on every rank from the same R."""
    m, n_in = a.shape
    b = _JACOBI_BLOCK
    nb = -(-n_in // b)
    n = nb * b
    u = grow_canvas(a, (m, n), valid=(m, n_valid))
    col_ok0 = torch.arange(n, device=a.device) < n_valid
    v = torch.eye(n, dtype=a.dtype, device=a.device) \
        * col_ok0[None, :].to(a.dtype)
    rounds = _sweep_rounds(nb, a.device)
    diag = torch.eye(2 * b, dtype=torch.bool, device=a.device)[None]
    off, it = float("inf"), 0
    while off > eps and it < max_sweeps:
        offs = []
        for i, j in rounds:
            ur = u.view(m, nb, b)
            vr = v.view(n, nb, b)
            w_u = torch.cat([ur[:, i], ur[:, j]], dim=-1)      # (m, w, 2b)
            qw, r = _pair_qr(w_u.transpose(0, 1), mesh)
            g = torch.einsum("wki,wkj->wij", r, r)             # G = RᵀR
            d = torch.diagonal(g, dim1=1, dim2=2)
            # clamp the PRODUCT: clamped factors of 1e-30 underflow to 0
            denom = torch.sqrt(torch.clamp(d[:, :, None] * d[:, None, :],
                                           min=1e-30))
            offs.append(torch.where(diag, 0.0, g.abs() / denom).max())
            u_r, s_r, vh = _pair_svd(r)                        # (w, 2b, 2b)
            u_new = px.peinsum("wmi,wij->mwj", qw, u_r * s_r[:, None, :],
                               policy)
            w_v = torch.cat([vr[:, i], vr[:, j]], dim=-1)
            v_new = px.peinsum("nwi,wji->nwj", w_v, vh, policy)  # V · V_r
            # a duplicated (padding) pair writes identical values twice
            ur[:, i] = u_new[..., :b]
            ur[:, j] = u_new[..., b:]
            vr[:, i] = v_new[..., :b]
            vr[:, j] = v_new[..., b:]
        off = _sweep_off(offs, mesh)
        it += 1
    s = _col_norms(u, mesh)
    u = u / torch.where(s < 1e-30, 1.0, s)[None, :]
    if sort:
        order = torch.argsort(-s, stable=True)
        s, u, v = s[order], u[:, order], v[:, order]
    keep = torch.arange(n, device=a.device) < n_valid
    s = torch.where(keep, s, 0.0)
    u = u * keep[None, :].to(u.dtype)
    v = v * (keep[None, :] & keep[:, None]).to(v.dtype)
    return u[:, :n_in], s[:n_in], v[:n_in, :n_in]


def _orthonormal(f: torch.Tensor) -> torch.Tensor:
    """The Q factor of a batch of square matrices, signed so it is the
    nearest orthogonal matrix to a nearly orthogonal ``f``."""
    q, r = torch.linalg.qr(f)
    d = torch.sign(torch.diagonal(r, dim1=1, dim2=2))
    return q * torch.where(d == 0, 1.0, d)[:, None, :]


def _pair_svd(r: torch.Tensor):
    """SVD of the batched (2b, 2b) pair factors to float32 working
    precision on every device.

    On CUDA, ``torch.linalg.svd`` runs cuSOLVER's Jacobi (gesvdj), whose
    factors of a general (128, 128) R came out orthogonal only to 3.6e-5
    on an H100 (LAPACK on the CPU: 8e-7); the pair update Q_w·U_r·Σ
    carries that error into every round, and at 4096 × 512 the factors'
    residual reached 1.4e-4, past ``ERROR_BOUNDS``
    (``tools/torch_linalg_diag.py``).  So the first factors are
    orthonormalised and the remainder U₁ᵀ R V₁ — nearly diagonal —
    factored again, which the Jacobi method does to working precision."""
    u1, _, vh1 = torch.linalg.svd(r)
    u1 = _orthonormal(u1)
    v1 = _orthonormal(vh1.transpose(1, 2))
    u2, s, vh2 = torch.linalg.svd(u1.transpose(1, 2) @ r @ v1)
    return u1 @ u2, s, (v1 @ vh2.transpose(1, 2)).transpose(1, 2)


def _round_robin_pairs(n) -> np.ndarray:
    """Static round-robin schedule: (n-1) rounds × (n//2) disjoint pairs,
    short rounds padded by repeating their last pair (both copies compute
    the same rotation from the same pre-round columns and write the same
    values, so the duplicate is idempotent)."""
    m = n if n % 2 == 0 else n + 1
    idx = list(range(m))
    rounds = []
    for _ in range(m - 1):
        pr = [(idx[k], idx[m - 1 - k]) for k in range(m // 2)]
        pr = [(min(i, j), max(i, j)) for i, j in pr if i < n and j < n]
        rounds.append(pr)
        idx = [idx[0]] + [idx[-1]] + idx[1:-1]
    width = max(len(r) for r in rounds)
    padded = []
    for r in rounds:
        while len(r) < width:
            r = r + [r[-1]]
        padded.append(r)
    return np.array(padded, dtype=np.int64)
