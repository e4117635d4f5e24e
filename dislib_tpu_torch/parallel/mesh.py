"""Device-mesh management for the port.

Counterpart of ``dislib_tpu/parallel/mesh.py``.  The mesh keeps the
reference's two named axes — ``"rows"`` (the data axis) and ``"cols"``
(the model/feature axis) — and its pad rule (:func:`pad_quantum`).  This
slice runs on ONE device, so the only mesh is ``(1, 1)``; a larger grid is
the multi-GPU item of ROADMAP.md (A.2: the mesh over NCCL).

Entry points run on ``cuda`` unless the caller asks for the CPU:
:func:`init` with no ``device`` picks ``"cuda"`` and raises when there is no
card — it never quietly picks the CPU.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import torch

ROWS = "rows"
COLS = "cols"
AXIS_NAMES = (ROWS, COLS)


@dataclass(frozen=True)
class Mesh:
    """A ``(rows, cols)`` device grid.  ``shape`` is keyed by axis name, as
    a ``jax.sharding.Mesh``'s is."""

    rows: int
    cols: int
    device: torch.device

    @property
    def shape(self) -> dict:
        return {ROWS: self.rows, COLS: self.cols}


_default_mesh: Mesh | None = None


def _resolve_device(device) -> torch.device:
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dislib_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to init() or array() to run the "
            "plain PyTorch versions on the CPU")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(mesh_shape=(1, 1), device=None) -> Mesh:
    """A mesh over ``device`` (default ``cuda``) without installing it as
    the library default."""
    r, c = (int(s) for s in mesh_shape)
    if (r, c) != (1, 1):
        raise NotImplementedError(
            f"mesh_shape {(r, c)}: this slice of the port runs on one "
            "device only — the multi-GPU mesh over NCCL is ROADMAP.md A.2")
    return Mesh(r, c, _resolve_device(device))


def init(mesh_shape: tuple[int, int] | None = None, device=None) -> Mesh:
    """Initialise (or re-initialise) the library-wide default mesh.

    ``mesh_shape=None`` reads ``DSLIB_MESH`` (``"1,1"``) and otherwise
    defaults to ``(1, 1)``.  ``device=None`` means ``"cuda"``; without a
    card that raises ``RuntimeError``.  Tests pass ``device="cpu"``.
    """
    global _default_mesh
    if mesh_shape is None:
        env = os.environ.get("DSLIB_MESH")
        mesh_shape = tuple(int(s) for s in env.split(",")) if env else (1, 1)
    _default_mesh = make_mesh(mesh_shape, device)
    return _default_mesh


def get_mesh() -> Mesh:
    """Return the default mesh, creating the ``cuda`` default lazily."""
    if _default_mesh is None:
        init()
    return _default_mesh


def mesh_shape(mesh: Mesh | None = None) -> tuple[int, int]:
    mesh = mesh or get_mesh()
    return (mesh.rows, mesh.cols)


def pad_quantum(mesh: Mesh | None = None) -> int:
    """Every ds-array dimension is padded to a multiple of this:
    lcm(rows, cols), so either logical dimension can be split over either
    mesh axis without remainder."""
    r, c = mesh_shape(mesh)
    return r * c // math.gcd(r, c)
