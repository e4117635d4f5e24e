"""dislib_tpu_torch — the PyTorch/CUDA port of ``dislib_tpu``.

The JAX package ``dislib_tpu`` stays the reference; this package mirrors it
module by module (each module's docstring names its counterpart) and runs on
one NVIDIA Hopper card.  The kernels the reference wrote in Pallas are
written by hand in CUDA C++ (``csrc/``), built by ``nvcc`` at first use.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``init(device="cpu")`` or ``array(x, device="cpu")``), where every kernel
wrapper runs its plain PyTorch version.  This package imports neither
``jax`` nor any module of ``dislib_tpu``.
"""

from dislib_tpu_torch.parallel.mesh import init, get_mesh
from dislib_tpu_torch.data.array import Array, array, zeros
from dislib_tpu_torch.math.base import matmul
from dislib_tpu_torch.cluster.kmeans import KMeans
from dislib_tpu_torch import cluster, trees

__all__ = ["init", "get_mesh", "Array", "array", "zeros", "matmul",
           "KMeans", "cluster", "trees"]
