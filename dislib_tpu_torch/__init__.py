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
from dislib_tpu_torch.data.array import (
    Array, array, random_array, zeros, full, ones, identity, eye,
    apply_along_axis, concat_rows, concat_cols, rechunk, ensure_canonical,
)
from dislib_tpu_torch.math import matmul, kron, svd, qr, polar
from dislib_tpu_torch.decomposition import tsqr, random_svd, lanczos_svd, PCA
from dislib_tpu_torch.cluster.kmeans import KMeans
from dislib_tpu_torch import cluster, decomposition, math, trees

__all__ = ["init", "get_mesh", "Array", "array", "random_array", "zeros",
           "full", "ones", "identity", "eye", "apply_along_axis",
           "concat_rows", "concat_cols", "rechunk", "ensure_canonical",
           "matmul", "kron", "svd", "qr", "polar",
           "tsqr", "random_svd", "lanczos_svd", "PCA",
           "KMeans", "cluster", "decomposition", "math", "trees"]
