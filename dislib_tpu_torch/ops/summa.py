"""SUMMA — the explicitly scheduled GEMM over the 2-D device mesh.

Counterpart of ``dislib_tpu/ops/summa.py``.  The (R x C) grid steps over
panels of the contraction dimension; at each step the owner of the A panel
broadcasts it along the mesh rows, the owner of the B panel along the mesh
columns, and every device accumulates one local GEMM.

This slice runs on one device: the mesh is ``(1, 1)``, so
:func:`summa_steps` is 1 and the panel is the whole K.  The panel loop
still runs through :func:`ops.overlap.panel_pipeline`, so the multi-GPU
slice (ROADMAP.md A.2) only has to make ``fetch`` an NCCL broadcast.

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

    ``ap`` (M_pad, K_pad) and ``bp`` (K_pad, N_pad) must agree on K_pad and
    carry the zero-pad invariant.  ``overlap`` is the resolved panel
    schedule (``ops/overlap.resolve``).  Returns the (M_pad, N_pad)
    product in the accumulation dtype."""
    if _mesh.mesh_shape(mesh) != (1, 1):
        raise NotImplementedError(
            "summa_matmul runs on the one-device (1, 1) mesh in this slice; "
            "the NCCL panel broadcasts are ROADMAP.md A.2")
    k_pad = ap.shape[1]
    if bp.shape[0] != k_pad:
        raise ValueError(
            f"summa: padded contraction dims differ ({k_pad} vs "
            f"{bp.shape[0]}) — repad before the kernel")
    steps = summa_steps(mesh)
    kb = k_pad // steps
    ac = px.to_compute(ap, policy)
    bc = px.to_compute(bp, policy)

    def fetch(t, prev):
        del prev                 # broadcast panels slice by step
        off = t * kb
        return (ac[:, off:off + kb].contiguous(),
                bc[off:off + kb, :].contiguous())

    def consume(t, acc, pan):
        a_pan, b_pan = pan
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
