"""Device-mesh management for the port.

Counterpart of ``dislib_tpu/parallel/mesh.py``.  The mesh keeps the
reference's two named axes — ``"rows"`` (the data axis) and ``"cols"``
(the model/feature axis) — and its pad rule (:func:`pad_quantum`).  In a
one-process job the only mesh is ``(1, 1)`` on one device.  In a
``torch.distributed`` job (``parallel/distributed.initialize``) a mesh
is a ``(rows, cols)`` grid of ranks laid out row-major, one card each:
a :class:`Mesh` then carries
this rank's coordinate and the process groups of its two axes, and
:func:`init` defaults to ``(world, 1)``, as the reference's defaults to
``(n_devices, 1)``.  Mind the names: a collective "over 'cols'" (the
reference's ``lax.psum(x, "cols")``) runs over the ranks of one mesh
ROW, the group ``groups["cols"]``.

Entry points run on ``cuda`` unless the caller asks for the CPU:
:func:`init` with no ``device`` picks ``"cuda"`` and raises when there is no
card — it never quietly picks the CPU.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field

import torch

from dislib_tpu_torch.parallel import distributed as _dist

ROWS = "rows"
COLS = "cols"
AXIS_NAMES = (ROWS, COLS)


@dataclass(frozen=True)
class Mesh:
    """A ``(rows, cols)`` grid.  ``shape`` is keyed by axis name, as a
    ``jax.sharding.Mesh``'s is.  ``device`` is this rank's device;
    ``rank`` its place in the row-major grid; ``groups`` the axis groups
    (``parallel/distributed.grid_groups``), None outside a
    ``torch.distributed`` job."""

    rows: int
    cols: int
    device: torch.device
    rank: int = 0
    groups: dict | None = field(default=None, compare=False, hash=False,
                                repr=False)
    backend: str | None = None

    @property
    def shape(self) -> dict:
        return {ROWS: self.rows, COLS: self.cols}

    @property
    def world(self) -> int:
        """The number of ranks the grid spans."""
        return self.rows * self.cols

    @property
    def coord(self) -> tuple[int, int]:
        """This rank's ``(row, col)`` on the grid."""
        return divmod(self.rank, self.cols)


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


def _needs_job(r, c):
    return NotImplementedError(
        f"mesh_shape {(r, c)} spans {r * c} ranks and this process is not "
        "in a torch.distributed job: start one rank per card (torchrun, or "
        "the DSLIB_* variables) and call parallel.initialize() first "
        "(ROADMAP.md A.2)")


def make_mesh(mesh_shape=(1, 1), device=None) -> Mesh:
    """A mesh without installing it as the library default.  Outside a
    ``torch.distributed`` job it is ``(1, 1)`` over ``device`` (default
    ``cuda``); inside one, the ``(rows, cols)`` grid of the job's ranks
    (``rows * cols`` must be the world size) over this rank's device."""
    r, c = (int(s) for s in mesh_shape)
    if r < 1 or c < 1:
        raise ValueError(f"mesh_shape {(r, c)}: both axes must be >= 1")
    if not _dist.is_initialized():
        if (r, c) != (1, 1):
            raise _needs_job(r, c)
        return Mesh(r, c, _resolve_device(device))
    rank, world = _dist.process_info()
    if r * c != world:
        raise ValueError(f"mesh_shape {(r, c)} needs {r * c} ranks and the "
                         f"job has {world}")
    dev = _resolve_device(device if device is not None
                          else _dist.rank_device())
    return Mesh(r, c, dev, rank, _dist.grid_groups(r, c), _dist.backend())


def local_mesh(device=None) -> Mesh:
    """A one-rank mesh over ``device`` with no process group, in any job:
    an array placed on it is one whole tensor on this rank's device."""
    return Mesh(1, 1, _resolve_device(device))


def init(mesh_shape: tuple[int, int] | None = None, device=None) -> Mesh:
    """Initialise (or re-initialise) the library-wide default mesh.

    ``mesh_shape=None`` reads ``DSLIB_MESH`` (``"4,2"``) and otherwise
    defaults to ``(world, 1)`` — ``(1, 1)`` outside a ``torch.distributed``
    job.  ``device=None`` means the rank's device in a job and ``"cuda"``
    outside one; without a card that raises ``RuntimeError``.  Tests pass
    ``device="cpu"``.
    """
    global _default_mesh
    if mesh_shape is None:
        env = os.environ.get("DSLIB_MESH")
        mesh_shape = tuple(int(s) for s in env.split(",")) if env \
            else (_dist.process_info()[1], 1)
    _default_mesh = make_mesh(mesh_shape, device)
    return _default_mesh


def set_mesh(mesh: Mesh) -> None:
    """Install ``mesh`` as the library-wide default (reference:
    ``dislib_tpu/parallel/mesh.set_mesh``).  A grid of several ranks must
    come from :func:`make_mesh` in a ``torch.distributed`` job."""
    global _default_mesh
    if not isinstance(mesh, Mesh):
        raise TypeError(f"set_mesh takes a Mesh, got {type(mesh).__name__}")
    if mesh.world > 1 and mesh.groups is None:
        raise _needs_job(mesh.rows, mesh.cols)
    _default_mesh = mesh


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
