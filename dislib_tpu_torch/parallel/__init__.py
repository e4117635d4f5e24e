"""The mesh of ranks and its collectives (counterpart of
``dislib_tpu/parallel``; ``parallel/hosts.py`` is ROADMAP.md A.11)."""

from dislib_tpu_torch.parallel.mesh import (
    ROWS, COLS, init, get_mesh, set_mesh, mesh_shape, pad_quantum,
)
from dislib_tpu_torch.parallel.distributed import (
    initialize, is_initialized, process_info, shutdown,
)

__all__ = [
    "ROWS", "COLS", "init", "get_mesh", "set_mesh", "mesh_shape",
    "pad_quantum", "initialize", "is_initialized", "process_info",
    "shutdown",
]
