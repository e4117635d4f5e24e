"""SUMMA — the explicitly scheduled GEMM over the 2-D device mesh.

Counterpart of ``dislib_tpu/ops/summa.py``.  The (R x C) grid steps over
panels of the contraction dimension; at each step the owner of the A panel
broadcasts it along the mesh rows, the owner of the B panel along the mesh
columns, and every device accumulates one local GEMM.

Each rank holds its ``(M/R, K/C)`` block of A and ``(K/R, N/C)`` block of
B (``data/array.py``); there are lcm(R, C) steps of ``kb = K/steps``
columns.  At step t the A panel's owner along 'cols' (index ``off //
(K/C)``) broadcasts it over the ranks of its mesh row, and the B panel's
owner along 'rows' (``off // (K/R)``) over the ranks of its mesh column:
``parallel/distributed.broadcast_from`` in place of the reference's
masked ``psum`` (``dislib_tpu/ops/summa.py:129-149``).  The loop runs
through :func:`ops.overlap.panel_pipeline`; a fetch returns the two
broadcasts in flight (``distributed.Pending``), and under ``db`` panel
t+1's broadcasts are issued before panel t's GEMM, which waits on its
own panel only.  On a one-rank mesh the broadcasts are the identity and
the one panel is the whole K.

The consume step is the hand kernel ``ops/kernels.panel_gemm`` under the
``kernel`` schedule and ``ops/precision.pdot`` otherwise.  The accumulator
is float32 (the policy's accumulation dtype; float64 for float64 operands
under the float32 floor).  Zero padding is exact in every dtype, so the
padded contraction equals the logical one with no masking.
"""

from __future__ import annotations

import math

import torch

from dislib_tpu_torch.ops import kernels as _k
from dislib_tpu_torch.ops import overlap as _ov
from dislib_tpu_torch.ops import precision as px
from dislib_tpu_torch.parallel import distributed as _dist
from dislib_tpu_torch.parallel import mesh as _mesh


def summa_supported(mesh=None) -> bool:
    """True when both mesh axes are > 1 (a genuine 2-D processor grid)."""
    r, c = _mesh.mesh_shape(mesh)
    return r > 1 and c > 1


def summa_steps(mesh=None) -> int:
    """Panel count of the SUMMA schedule on ``mesh``: lcm(rows, cols)."""
    r, c = _mesh.mesh_shape(mesh)
    return r * c // math.gcd(r, c)


@px.precise
def summa_matmul(ap: torch.Tensor, bp: torch.Tensor, mesh, policy,
                 overlap: str = "db") -> torch.Tensor:
    """C = A @ B over padded operands on ``mesh``.

    ``ap`` and ``bp`` are this rank's blocks, (M_pad/R, K_pad/C) and
    (K_pad/R, N_pad/C) (the whole padded operands on one rank); they must
    agree on K_pad and carry the zero-pad invariant.  ``overlap`` is the
    resolved panel schedule (``ops/overlap.resolve``).  Returns this
    rank's (M_pad/R, N_pad/C) block of the product in the accumulation
    dtype."""
    k_pad = ap.shape[1]
    if bp.shape[0] != k_pad * mesh.cols // mesh.rows:
        raise ValueError(
            f"summa: padded contraction dims differ ({k_pad * mesh.cols} vs "
            f"{bp.shape[0] * mesh.rows}) — repad before the kernel")
    steps = summa_steps(mesh)
    kb = k_pad * mesh.cols // steps        # the panel's K, of the global K
    ka, kb_loc = ap.shape[1], bp.shape[0]  # this rank's K of A and of B
    my_r, my_c = mesh.coord
    ac = px.to_compute(ap, policy)
    bc = px.to_compute(bp, policy)

    def fetch(t, prev):
        del prev                 # broadcast panels slice by step
        off = t * kb
        own_c, own_r = off // ka, off // kb_loc
        a_pan = ac[:, off - own_c * ka: off - own_c * ka + kb].contiguous() \
            if my_c == own_c else ac.new_empty((ac.shape[0], kb))
        b_pan = bc[off - own_r * kb_loc: off - own_r * kb_loc + kb, :] \
            .contiguous() if my_r == own_r else bc.new_empty((kb, bc.shape[1]))
        return (_dist.broadcast_from(a_pan, own_c, _mesh.COLS, mesh,
                                     async_op=True),
                _dist.broadcast_from(b_pan, own_r, _mesh.ROWS, mesh,
                                     async_op=True))

    def consume(t, acc, pan):
        a_pan, b_pan = _ov.landed(pan)
        if overlap == "kernel":
            return acc.add_(_k.panel_gemm(a_pan, b_pan, policy))
        return acc.add_(px.pdot(a_pan, b_pan, policy))

    # in-place accumulation: the accumulator is created here and never
    # escapes until the loop ends
    acc0 = torch.zeros((ap.shape[0], bp.shape[1]),
                       dtype=px.result_dtype(ac, bc, policy),
                       device=ap.device)
    return _ov.panel_pipeline(steps, fetch(0, None), fetch, consume, acc0,
                              _ov.overlapped(overlap))
