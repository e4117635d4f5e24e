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

from dislib_tpu_torch.parallel.mesh import init, get_mesh, set_mesh
from dislib_tpu_torch.data.array import (
    Array, array, random_array, zeros, full, ones, identity, eye,
    apply_along_axis, concat_rows, concat_cols, rechunk, ensure_canonical,
)
from dislib_tpu_torch.data.sparse import SparseArray
from dislib_tpu_torch.data.io import (
    load_txt_file, load_svmlight_file, load_npy_file, load_mdcrd_file,
    save_txt, QuarantineLedger, QuarantineReport, last_quarantine_report,
    quarantine_ledger, quarantine_batch,
)
from dislib_tpu_torch.math import matmul, kron, svd, qr, polar
from dislib_tpu_torch.ops.overlap import resolve as overlap_schedule
from dislib_tpu_torch.decomposition import tsqr, random_svd, lanczos_svd, PCA
from dislib_tpu_torch.base import from_fitted_arrays
from dislib_tpu_torch.utils.base import shuffle, train_test_split
from dislib_tpu_torch.utils.saving import save_model, load_model
from dislib_tpu_torch import cluster, classification, decomposition, \
    math, model_selection, neighbors, trees, preprocessing, regression, \
    optimization, recommendation, retrieval, runtime  # noqa: E402,F401

# estimator classes re-exported at top level, as the reference does
# (their canonical homes stay the submodules above)
from dislib_tpu_torch.cluster import (
    KMeans, MiniBatchKMeans, GaussianMixture, DBSCAN, Daura,
)
from dislib_tpu_torch.trees import (
    RandomForestClassifier, RandomForestRegressor,
    DecisionTreeClassifier, DecisionTreeRegressor,
)
from dislib_tpu_torch.regression import LinearRegression, Lasso
from dislib_tpu_torch.optimization import ADMM
from dislib_tpu_torch.preprocessing import StandardScaler, MinMaxScaler
from dislib_tpu_torch.classification import CascadeSVM, KNeighborsClassifier
from dislib_tpu_torch.neighbors import NearestNeighbors
from dislib_tpu_torch.model_selection import (
    KFold, GridSearchCV, RandomizedSearchCV,
)
from dislib_tpu_torch.recommendation import ALS
from dislib_tpu_torch.retrieval import IVFIndex

__all__ = ["init", "get_mesh", "set_mesh", "Array", "array", "random_array", "zeros",
           "full", "ones", "identity", "eye", "apply_along_axis",
           "concat_rows", "concat_cols", "rechunk", "ensure_canonical",
           "SparseArray", "load_txt_file", "load_svmlight_file", "load_npy_file",
           "load_mdcrd_file", "save_txt", "QuarantineReport",
           "QuarantineLedger", "last_quarantine_report",
           "quarantine_ledger", "quarantine_batch",
           "matmul", "kron", "svd", "qr", "polar", "overlap_schedule",
           "tsqr", "random_svd", "lanczos_svd", "PCA", "from_fitted_arrays",
           "shuffle", "train_test_split", "save_model", "load_model",
           "KMeans", "MiniBatchKMeans", "GaussianMixture", "DBSCAN", "Daura",
           "CascadeSVM", "KNeighborsClassifier",
           "RandomForestClassifier", "RandomForestRegressor",
           "DecisionTreeClassifier", "DecisionTreeRegressor",
           "NearestNeighbors", "LinearRegression", "Lasso", "ADMM", "ALS",
           "IVFIndex",
           "StandardScaler", "MinMaxScaler",
           "KFold", "GridSearchCV", "RandomizedSearchCV",
           "cluster", "classification", "decomposition", "math",
           "model_selection", "neighbors", "trees", "preprocessing",
           "regression", "optimization", "recommendation", "retrieval",
           "runtime"]
