#!/usr/bin/env python3
"""Drive the PyTorch port (``dislib_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``dislib_tpu_torch/csrc``, holds each
kernel against its plain PyTorch version on the card, then drives the main
path through the entry points a user calls — ``KMeans`` fit/predict/score on
a 1,000,000 x 100 ds-array with k = 10, ``matmul(..., algorithm="summa")``
of two 16384 x 16384 ds-arrays under both precision policies with
``DSLIB_OVERLAP=pallas`` (``panel_gemm`` on the tensor cores: one bf16
product, or the float32-faithful 3xTF32 product, which must also come
within 1/8 of a single-pass TF32 product's error), a 16-tree
``RandomForestClassifier`` at the default depth on 1,000,000 x 100 rows, a
``DecisionTreeClassifier`` fitted on the card and on the CPU, and an 8-tree
``RandomForestRegressor`` (two fits with one seed must be identical);
KMeans with ``tol > 0`` (it must stop within a chunk of its convergence),
``MiniBatchKMeans`` over the KMeans data in 4096-row batches (each update
against a float64 NumPy replay), ``GaussianMixture`` at BASELINE config 5
(1,000,000 x 50, k = 16, full covariances; one EM step against bench.py's
NumPy EM step in float64), ``StandardScaler``/``MinMaxScaler``,
``LinearRegression`` and ``Lasso`` on 1,000,000 x 100 against float64
NumPy, ``matmul``'s default route under both policies — then the blocked
linear algebra at bench.py's
full widths under both precision policies (``tsqr`` 65536 x 256 by both
local-QR routes, ``qr`` economic 32768 x 1024 and full 4096 x 512,
``random_svd`` and ``PCA`` on 32768 x 1024, ``svd`` 4096 x 512 and
4096 x 100, ``polar`` 16384 x 1024, ``lanczos_svd`` and ``kron``), each
against a float64 NumPy oracle within its ``ERROR_BOUNDS`` row and with
its host reads and one profiled call — then ``NearestNeighbors`` at
bench_knn's sizes (1,000,000 x 10 fit rows, 10,000 queries, k = 10;
against a float64 brute force on 512 queries), the single-rank ring kNN
with its cross term on ``panel_gemm`` (against the chunked path),
``GridSearchCV`` over KMeans and over ``KNeighborsClassifier`` at
bench_gridsearch's 200,000 x 20 (each split score against a sequential
fit and score) and ``shuffle``/``train_test_split`` of the KMeans data
(bit-equal to NumPy's permutation) — then the ingest (the KMeans data
through ``load_npy_file``, refitted bit-equal; 100,000 of its rows as text
through ``load_txt_file`` and the native parser; a 10,000-frame mdcrd
trajectory; a dense svmlight file; a planted NaN row quarantined), every
model fitted above saved in json, cbor and npz and loaded back onto the
card (predictions bit-equal), and ``KMeans(fast_distance=True)`` on the
KMeans data (the bf16-operand ``distances_sq`` against a float64 oracle on
the rounded operands, timed in turns with the float32 path) — then
``DBSCAN`` and ``Daura`` at bench.py's sizes (DBSCAN's core partition
against bench's NumPy same-algorithm proxy at 20,000 x 10 on the tiled
tier and 16,000 x 10 on the dense tier, the ring tier equal to the tiled
one, timed at 200,000 x 10; Daura against the NumPy greedy proxy at
20,000 x 15, timed at 50,000 x 15), a 100,000 x 10,000 svmlight file
loaded as a ``SparseArray``, SpMM at 16,384 x 8,192 (1 %) x (8,192, 64)
against float64 and the densify route (two calls bit-identical) and
sparse KMeans on the loaded array (its first step against float64 NumPy,
two fits bit-identical) — then the sparse kNN on the loaded array (1,000
of its rows as sparse and as dense queries, k = 10, against a float64
scipy oracle; the kNN classifier's score), ``CascadeSVM`` at
bench_csvm's 20,000 x 20 under both dual solvers (predictions against a
float64 NumPy cascade, two fits bit-identical; the batched
``distances_sq`` entry at level 0's shape), CascadeSVM on 8,192 x 10,000
svmlight-style sparse rows through the ELL staging and the host-CSR
fallback (each equal to the dense fit), and a scaler, ``shuffle``,
``LinearRegression`` and a forest on a ``SparseArray`` against the same
calls on the densified array (and ``MemoryError`` past the densify
budget) — then ``ALS`` at bench_als_sparse's 100,000 x 10,000 with 100
ratings a user on a ``SparseArray`` (a user and an item half-step against
a float64 solve on a subset, the dense fit on the densified ratings equal
to the sparse fit, two sparse fits bit-identical, the RMSE decreasing,
``fold_in`` of 8 and of 4,096 users against float64) and the
``IVFIndex`` at bench_ann's 1,000,000 x 64, 4,096 queries, 1,024 lists,
nprobe 32 (its quantizer's E-step on ``distances_sq``, the lists against
a NumPy bucketing of the quantizer's labels, recall@10 ≥ 0.95 against
float64 under ``db`` and under ``kernel``, whose centroid product is
``panel_gemm``, the exact ``kneighbors`` timed beside it, ``nprobe =
n_lists`` against the exact kNN on a 20,000-row cut) — then the
checkpointed fit (``resilience``) and the serving layer (``serving``: the
KMeans main path behind a ``StandardScaler`` through ``PredictServer``
over the 1/8/64/512 ladder, 20,000 requests from 8 client threads, every
response against a direct predict, one CUDA-graph replay per bucket
piece and no capture or kernel build after warm; a ``ModelPool``
following a checkpointed KMeans fit continued during the traffic, a
non-finite generation refused; two tenants and a 10 % canary behind a
``ModelRouter``; the IVF index's queries through ``RetrievalPipeline``
and the ALS model's fold-in through ``SparseFoldInPipeline``; each
replay bit-equal to its eager chain) and the deployment bundles
(``deploy``: the three served pipelines exported, each loaded by a fresh
``python3`` child with an empty build directory and ``build_all``
refusing, which serves every bucket bit-equal to the live pipeline with
no ``nvcc`` build and one capture a bucket; a child without a bundle
that builds the kernels, as the yardstick; ``ContinuousTrainer`` over
``MiniBatchKMeans`` for four generations under client traffic, a torn
export and a tripped canary among them) — then the mesh of ranks
(``mesh``: NCCL at a world of one in this process, SUMMA, KMeans, tsqr
and GaussianMixture bit-equal to the same calls with no process group;
two NCCL processes on one card, which ``initialize`` must refuse; then
4 gloo ranks on this one card, each ``python3 chip_smoke.py --mesh-rank
R DIR``: SUMMA 16384² under both policies and tsqr on a (2, 2) grid;
tsqr, KMeans, the ring kNN at bench_knn's sizes, the shuffle and the
scalers of the KMeans data, random_svd and PCA at bench_randomsvd's
size and GaussianMixture at bench_gmm's on (4, 1), each rank's blocks
against the one-rank results, each rank's kernels timed while the
others wait) — and checks every result.  Each
phase prints one JSON line; the line before the last lists every kernel
with its launches on the main path, its error against the plain version,
its time, the plain version's and the library call's time, and the least
time the card could take (``bound_ms``).  The last line is::

    {"ok": true, "device": {"platform": "gpu", "kind": "<card>", "count": 1}}

Any failed check raises, and the script exits non-zero without that line.
It also exits non-zero, printing no result, when there is no CUDA device or
the port is not importable next to it.  It needs no network and imports no
JAX.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

# published peaks of one H100 SXM at its full 700 W power limit (NVIDIA's
# data sheet, dense): FP32 outside the tensor cores, bf16 and TF32 tensor
# cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
# the kernel torch.cuda._sleep launches; it marks a profiled window's start
WINDOW_MARK = "spin_kernel"
PROFILE_SESSIONS = 5    # profiler sessions a profiled call may take
PROFILE_PRIME = 300     # spin kernels that open each profiler session
PROFILE_LOG = []        # each profiled call's sessions and clock gap

KM_M, KM_N, KM_K = 1_000_000, 100, 10
GEMM_N = 16384
# the forest: bench.py's bench_forest data at 1M x 100, 16 trees
RF_M, RF_N, RF_T = 1_000_000, 100, 16
# the tree fitted on the card and on the CPU: bench.py's full forest shape
DT_M, DT_N = 100_000, 20
# the plain node_histogram timed on the host at a CPU fit's level size
HIST_CPU_M = 20_000
# node_histogram shapes held against the plain version: (T, m, n,
# n_nodes, n_bins, S)
HIST_RAGGED = [(3, 1000, 7, 4, 32, 2),        # ragged m, several chunks
               (2, 50_001, 5, 2048, 32, 2),   # the deepest level: slices
               (1, 20_011, 3, 64, 1024, 2),   # n_bins 1024
               (2, 30_000, 4, 8, 32, 5),      # S 5
               (1, 123_457, 10, 1, 32, 2),    # T 1, every row in one node
               (16, 40_000, 6, 16, 32, 2),    # T 16
               (16, 200_000, 20, 2, 32, 2)]   # private copies per warp
# node layouts at a deep level's shape that stress the partition: every
# row in one node, half the nodes empty, rows dropped for node -1, a NaN
# stat on a weight-0 row (kept and added: 0·NaN is NaN)
HIST_LAYOUTS = ["one-node", "half-empty", "node-minus-1",
                "nan-on-zero-weight"]
# distances_sq: feature widths (100 aligned takes the bulk-copy stream,
# the rest the slices), k across the chunk of 16, an unaligned view of a
DIST_D, DIST_K = [1, 3, 33, 100], [1, 10, 17, 257]
# distances_sq's gate against its plain version: max |D - D_ref| over
# max ‖a‖² + max ‖b‖², the magnitudes that cancel
DIST_TOL = 1e-5
# panel_gemm shapes held against the plain version: ragged in every
# dimension, the last two over many K stages and several tiles each way
GEMM_RAGGED = [(1000, 77, 33), (129, 257, 130), (1, 5, 300),
               (300, 1000, 520), (4097, 2053, 259)]
# node_histogram's parts in a profiled call
HIST_PARTS = {"partition": ("part_count", "part_scan", "part_scatter"),
              "histogram": ("hist_kernel",)}
# device kernels by kind, for the profiled panel_gemm and matmul calls
GEMM_PARTS = {"panel_gemm_mainloop": ("gemm_kernel",),
              "panel_gemm_prep": ("split_rows", "transpose_prep"),
              "to_compute_and_copies": ("copy",),
              "acc_add": ("_add",),
              "zero_fill": ("Fill",)}
DEVICE = "cuda:0"
# the blocked linear algebra at bench.py's full widths: tsqr_65536x256,
# randomsvd_32768x1024 (nsv 64, iters 2), svd_4096x512, polar_16384x1024;
# qr economic over 4 panels of 256, qr full through the complement
# (m - n > 256), the scalar svd tier (n < 128), and lanczos and kron at
# sizes a float64 oracle checks in seconds
TSQR = (65536, 256)
QR_ECON, QR_FULL = (32768, 1024), (4096, 512)
RSVD, RSVD_NSV, RSVD_ITERS = (32768, 1024), 64, 2
SVD_BLOCK, SVD_SCALAR = (4096, 512), (4096, 100)
POLAR = (16384, 1024)
LANCZOS, LANCZOS_K = (8192, 512), 6
KRON = ((64, 64), (64, 64))
POLICIES = ("float32", "bfloat16")
# GaussianMixture: BASELINE config 5 / bench.py's bench_gmm, 5 EM
# iterations from the random init, full covariances
GM_M, GM_N, GM_K, GM_ITERS = 1_000_000, 50, 16, 5
# MiniBatchKMeans on the KMeans data: one epoch of 4096-row batches
MBK_BATCH = 4096
# the scalers (column means near 1000) and the regressions
SC_M, SC_N = 1_000_000, 100
LR_M, LR_N = 1_000_000, 100
# Lasso: kappa = lmbd / rho = 0.05; the solution is about the soft
# threshold of beta at lmbd / ||x_j||² ≈ 0.005, so the zero and the small
# coefficients of beta come out 0
LASSO_LMBD, LASSO_RHO, LASSO_ITERS = 5e3, 1e5, 500
# the regressor's node_histogram: 8 trees, 1M x 100, depth 8, [w, wy, wy²]
RR_T, RR_DEPTH, RR_S = 8, 8, 3
# kNN at bench_knn's sizes (bench.py:3112): 1M fit rows x 10 features,
# 10,000 queries, k = 10, the gate on 512 queries; the single-rank ring
# at 65,536 fit rows (it holds the whole (queries, fit rows) block)
KNN_MF, KNN_N, KNN_MQ, KNN_K, KNN_GATE_Q = 1_000_000, 10, 10_000, 10, 512
RING_MF = 65_536
# the searches at bench_gridsearch's size (bench.py:3090), KMeans on its
# rand(200000, 20) draw and the kNN classifier on _blobs(200000, 20, 8);
# shuffle and train_test_split of the KMeans data
GS_M, GS_N = 200_000, 20
SPLIT_M, SPLIT_N = 1_000_000, 100
# ingest: the KMeans data as .npy (all of it) and as text (TXT_M rows,
# full width: the rows are cut for the run's time limit), NumPy's parse of
# TXT_YARDSTICK of those rows as a yardstick; a peptide-sized trajectory of
# MD_FRAMES frames of MD_ATOMS atoms; the row NAN_ROW of 1,000 poisoned;
# the saved models predict on SAVE_Q fresh rows
TXT_M, TXT_YARDSTICK = 100_000, 10_000
MD_FRAMES, MD_ATOMS = 10_000, 300
NAN_ROW = 17
SAVE_Q = 10_000
# density clustering at bench.py's sizes (bench.py:3106-3108): DBSCAN on
# _blobs(k=16), eps 0.35, min_samples 5, gated at 20,000 rows (the tiled
# tier) and 16,000 (the dense tier), timed at 200,000; Daura on
# _blobs(k=12, std=0.05), cutoff 0.3 (5 atoms a frame), gated at 20,000,
# timed at 50,000
DB_GATE_M, DB_DENSE_M, DB_M, DB_N, DB_EPS, DB_MIN = \
    20_000, 16_000, 200_000, 10, 0.35, 5
DA_GATE_M, DA_M, DA_N, DA_CUT = 20_000, 50_000, 15, 0.3
# the sparse ds-array: a svmlight file at bench_als_sparse's shape
# (bench.py:3119, 100 entries a row), SpMM at bench_sparse's
# (bench.py:3126), KMeans k = 10 on the loaded array
SV_M, SV_N, SV_NNZ = 100_000, 10_000, 100
SPMM_M, SPMM_K, SPMM_N, SPMM_DENSITY = 16_384, 8_192, 64, 0.01
SKM_K, SKM_ITERS = 10, 20
# CascadeSVM at bench_csvm's problem (bench.py:1990): 20,000 x 20 blobs at
# +-2 in every feature, part 1024, 3 iterations, rbf with gamma 1/20, C 1
CSVM_M, CSVM_N, CSVM_PART, CSVM_ITERS = 20_000, 20, 1024, 3
# CascadeSVM on rows drawn as the svmlight file's (10,000 columns, 100 a
# row), labels the sign of a planted linear score, one iteration.  Rows
# this sparse share about one column a pair, so every row is a support
# vector and the top node holds them all (its kernel block, and the host
# CSR fallback's scipy product, grow as rows squared): CSVM_SP_M rows,
# cut from 20,000 for the phase's time
CSVM_SP_M, CSVM_SP_ITERS = 8_192, 1
# the sparse kNN on the svmlight array: SKNN_Q of its rows as queries, k
SKNN_Q, SKNN_K = 1_000, 10
# sparse input to the other estimators: svmlight-style rows, SI_NNZ of
# SI_N columns each
SI_M, SI_N, SI_NNZ = 100_000, 200, 10
# ALS at bench_als_sparse's size (bench.py:2524, run at :3119): 100,000
# users x 10,000 items, 100 draws of an item a user (duplicates summed),
# n_f 16, lambda 0.065, 3 sweeps; the half-steps held on ALS_HOLD_U users
# and ALS_HOLD_I items; fold-in batches of ALS_FOLD users, top 10
ALS_M, ALS_N, ALS_NNZ, ALS_F, ALS_LAM, ALS_ITERS = \
    100_000, 10_000, 100, 16, 0.065, 3
ALS_HOLD_U, ALS_HOLD_I = 2_000, 500
ALS_FOLD, ALS_TOP = (8, 4_096), 10
# the IVF index at bench_ann's size (bench.py:2434, run at :3113): a
# 1,000,000 x 64 catalog of 1,024 blobs (centres x4), 4,096 queries,
# k 10, 1,024 lists, nprobe 32, 5 KMeans iterations; recall@10 against
# float64 on IVF_GATE_Q queries; nprobe = n_lists against the exact kNN on
# an IVF_CUT_M-row cut of IVF_CUT_LISTS lists
IVF_M, IVF_D, IVF_Q, IVF_K, IVF_LISTS, IVF_PROBE, IVF_ITERS = \
    1_000_000, 64, 4_096, 10, 1_024, 32, 5
IVF_GATE_Q, IVF_CUT_M, IVF_CUT_LISTS = 512, 20_000, 64
# the resilience phase (the checkpointed fit): KMeans at the main path's
# size, 50 steps in chunks of 10 (chunks of 5 for the SIGTERM drill, so
# the signal from the snapshot worker has 8 boundaries to land on); the
# forest in snapshots every 4 levels; GaussianMixture 6 EM steps from the
# random init, 2 a chunk; the MiniBatchKMeans stream snapshotted every 50
# batches; CascadeSVM cut from 20,000 to 4,096 rows (3 iterations at
# 20,000 take 12 s a fit, and the phase fits it 3 times); DBSCAN and
# Daura at their gate sizes (20,000 rows)
RES_KM_ITERS, RES_KM_EVERY, RES_KM_SIGTERM_EVERY = 50, 10, 5
RES_RF_EVERY, RES_GM_ITERS, RES_MBK_EVERY = 4, 6, 50
RES_CSVM_M, RES_DB_M, RES_DA_M = 4_096, 20_000, 20_000


# the serving phase (dislib_tpu_torch/serving): the main path's KMeans
# behind a StandardScaler fitted on its rows, served over the default
# bucket ladder; SERVE_REQ requests of 1 to SERVE_MAX_ROWS rows from
# SERVE_THREADS client threads, each keeping SERVE_WINDOW requests in
# flight; the hot-swap drill continues a checkpointed KMeans fit for
# SERVE_SWAP_ROUNDS rounds of one step while the clients send traffic;
# SERVE_ROUTER_REQ keyed requests through the router; the IVF index's
# queries and SERVE_FOLD_USERS users of the ALS ratings, each in requests
# of 1 to SERVE_MAX_ROWS rows
SERVE_BUCKETS = (1, 8, 64, 512)
SERVE_REQ, SERVE_MAX_ROWS, SERVE_THREADS, SERVE_WINDOW = 20_000, 64, 8, 4
SERVE_SWAP_ROUNDS, SERVE_ROUTER_REQ = 12, 400
SERVE_FOLD_USERS, SERVE_NSE_CAP = 4_096, 128


_T0 = time.perf_counter()
# the models the phases fit, by class name, with their input width, for
# the saving phase
MODELS = {}
# the one-rank fits of the forest, density and cascade phases, keyed by
# estimator and sizes: the mesh phase holds its ranks to them
MESH_ONE = {}
# what the main path, the ivf and the als phases leave for the serving
# phase
SERVED = {}
# the served pipelines and their request rows, which the serving phase
# leaves for the deploy phase
DEPLOY = {}
# the trainer in the deploy phase: DEPLOY_GENS generations of
# DEPLOY_BATCHES MiniBatchKMeans batches of MBK_BATCH rows of the KMeans
# data, under client requests of 1 to SERVE_MAX_ROWS rows
DEPLOY_GENS, DEPLOY_BATCHES = 4, 8
# the loading child's time limit, seconds
DEPLOY_CHILD_S = 300


def emit(obj) -> None:
    """One JSON line, with the seconds since the script started."""
    print(json.dumps({**obj, "t_s": round(time.perf_counter() - _T0, 1)}),
          flush=True)


def check(cond, what) -> None:
    if not cond:
        raise AssertionError(what)


def bound(flops, nbytes, peak_flops):
    """(bound_ms, bound_by): the larger of the operations over the peak
    rate for their type and the bytes over the memory rate."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


DIST_BOUND_BASIS = ("the cross term's 2mkd at the tensor cores' rate (three "
                    "TF32 passes at 495 TFLOP/s for f32 operands, one bf16 "
                    "pass at 989 for bf16), the norms and the combine on "
                    "the CUDA cores at 67; each input read once, the output "
                    "written once, at 3.35 TB/s")


def dist_bound(m, k, d, nbytes, bf16=False, batch=1):
    """(bound_ms, bound_by) of ``batch`` (m, d)×(k, d) squared-distance
    blocks moving ``nbytes``: the cross term as the card's fastest
    product that keeps the operands' precision (3xTF32 for f32, one bf16
    pass for bf16), the rest at the float32 rate."""
    cross = batch * 2.0 * m * k * d
    rest = batch * (2.0 * (m + k) * d + 3.0 * m * k)
    t_ops = (cross / PEAK_BF16_FLOPS if bf16 else 3 * cross / PEAK_TF32_FLOPS)
    t_ops += rest / PEAK_FP32_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def blobs(m, n, k, seed=0, std=0.08):
    """bench.py's ``_blobs``: k gaussian blobs on the unit cube."""
    import numpy as np
    rng = np.random.RandomState(seed)
    centers = rng.rand(k, n).astype(np.float32)
    lab = rng.randint(0, k, m)
    x = centers[lab] + std * rng.standard_normal((m, n)).astype(np.float32)
    return x.astype(np.float32), lab.astype(np.int64)


def forest_data(m, n):
    """bench_forest's draw: ``blobs(m, n, 8, seed=5)``, the classifier's
    labels (the blob's parity) and the regressor's smooth target."""
    import numpy as np
    x, lab = blobs(m, n, 8, seed=5)
    y = (lab % 2).astype(np.float32)[:, None]
    yr = (np.sin(6.0 * x[:, 0]) + 2.0 * x[:, 1] ** 2
          + x[:, 2]).astype(np.float32)[:, None]
    return x, y, yr


def csvm_data(m, n):
    """bench_csvm's problem (seed 0): two blobs at ±2 in every feature,
    labels ±1, rows shuffled."""
    import numpy as np
    rng = np.random.RandomState(0)
    half = m // 2
    x = np.vstack([rng.randn(half, n) + 2.0,
                   rng.randn(m - half, n) - 2.0]).astype(np.float32)
    y = np.r_[np.ones(half), -np.ones(m - half)].astype(np.float32)
    perm = rng.permutation(m)
    return x[perm], y[perm]


def lr_data(m, n):
    """The regressions' draw (seed 8): x, y = x·beta + 0.5 + noise for
    LinearRegression and yl = x·beta + noise for Lasso, beta with half
    its entries 0 and a tenth 1e-3 (under the Lasso's threshold)."""
    import numpy as np
    rng = np.random.RandomState(8)
    x = rng.standard_normal((m, n)).astype(np.float32)
    beta = rng.standard_normal(n)
    beta[::2] = 0.0
    beta[1::10] = 1e-3
    noise = 0.1 * rng.standard_normal(m)
    y = (x @ beta + 0.5 + noise).astype(np.float32)[:, None]
    yl = (x @ beta + noise).astype(np.float32)[:, None]
    return x, y, yl


def numpy_leaf_stats(est, xq):
    """A NumPy walk of a fitted forest: every query row's leaf stats in
    every tree, (T, q, S), from the fitted edges, splits and leaves."""
    import numpy as np
    edges = est._edges.cpu().numpy()
    leaves = est._leaves.cpu().numpy()
    bq = (xq[:, :, None] > edges[None]).sum(2)
    r = np.arange(len(xq))
    out = []
    for t in range(est._feats.shape[0]):
        node = np.zeros(len(xq), np.int64)
        for lvl in range(est._depth):
            f = est._feats[t, lvl][node]
            b = est._tbins[t, lvl][node]
            node = node * 2 + (bq[r, f] > b)
        out.append(leaves[t][node])
    return np.stack(out)


def same_forest(a, b) -> bool:
    import numpy as np
    import torch
    return (torch.equal(a._edges, b._edges) and torch.equal(a._leaves,
                                                            b._leaves)
            and np.array_equal(a._feats, b._feats)
            and np.array_equal(a._tbins, b._tbins))


def profile_device(fn):
    """Run ``fn`` under torch.profiler; return the wall time, the device's
    busy time (the union of its kernel spans) and the spans (start_us,
    end_us, name) in start order.

    Late in a long run the profiler can drop a leading stretch of a
    session's device work (up to ~0.13 s of it in the runs seen).  So ``fn`` runs once
    untimed, then ``PROFILE_PRIME`` spin kernels (``torch.cuda._sleep``,
    ~1 ms each on an H100) give the loss something else to take, then a
    short spin kernel marks the window, and only the device spans of the
    timed call that follows it are kept: the window is cut on the
    device's own clock, which the host's, as the profiler aligns them,
    can miss by ms.  The loss being a leading stretch, a recorded marker
    shows that all of the call was recorded; a session without it is taken
    again, at most ``PROFILE_SESSIONS`` in all.  ``PROFILE_LOG`` gets, for
    each call, the sessions taken, the spins the last one lost and the
    marker's start on the device less its launch on the host (a launch's
    latency plus the two clocks' disagreement)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    host_mark = "chip_smoke:window"
    for session in range(1, PROFILE_SESSIONS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            for _ in range(PROFILE_PRIME):
                torch.cuda._sleep(2_000_000)
            torch.cuda.synchronize()
            with record_function(host_mark):
                torch.cuda._sleep(1000)        # the window's marker
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.events()
        device = [(e.time_range.start, e.time_range.end, e.name)
                  for e in events
                  if e.device_type == DeviceType.CUDA and e.name != host_mark]
        spins = [sp for sp in device if WINDOW_MARK in sp[2]]
        marks = [sp for sp in spins if sp[1] - sp[0] < 100.0]     # µs
        if len(marks) == 1:
            break
    check(len(marks) == 1, f"{PROFILE_SESSIONS} profiler sessions recorded "
          f"no window marker (the last: {len(device)} device spans)")
    launched = min(e.time_range.start for e in events
                   if e.name == host_mark and e.device_type == DeviceType.CPU)
    PROFILE_LOG.append({"sessions": session,
                        "spins_lost": PROFILE_PRIME + 1 - len(spins),
                        "clock_gap_us": marks[0][0] - launched})
    spans = sorted(sp for sp in device
                   if sp[0] >= marks[0][0] and WINDOW_MARK not in sp[2])
    check(spans, "the profiler recorded no device work")
    busy, end = 0.0, float("-inf")
    for s, e, _ in spans:
        busy += max(0.0, e - max(s, end))      # union of the spans
        end = max(end, e)
    return wall_us, busy, spans


def top_kernels(spans, n=8, per=1.0):
    per_kernel = {}
    for s, e, name in spans:
        per_kernel[name[:90]] = per_kernel.get(name[:90], 0.0) + (e - s)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:n]
    return {name: t / per / 1e3 for name, t in top}


def by_part(spans, parts=GEMM_PARTS):
    """Device ms of each kind of kernel in ``spans`` (first matching
    substring wins; the rest under "other")."""
    out = {k: 0.0 for k in parts}
    out["other"] = 0.0
    for s, e, name in spans:
        kind = next((k for k, subs in parts.items()
                     if any(x in name for x in subs)), "other")
        out[kind] += (e - s) / 1e3
    return out


def split_calls(spans, first):
    """The spans cut into calls, each starting at a kernel whose name holds
    ``first``; spans before the first such kernel are dropped."""
    calls = []
    for sp in spans:
        if first in sp[2]:
            calls.append([])
        if calls:
            calls[-1].append(sp)
    return calls


def sass_counts(lib_path, nvcc, ops=("HGMMA", "UTMALDG")):
    """Lines of each instruction in ``ops`` (by default HGMMA, wgmma, and
    UTMALDG, a TMA load) in the SASS of a built kernel library, by
    ``cuobjdump`` from nvcc's toolkit."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    lines = sass.splitlines()
    return {op: sum(op in ln for ln in lines) for op in ops}


def med_s(fn, reps=5):
    """Median wall seconds of ``fn`` over ``reps`` synchronised calls."""
    import numpy as np
    import torch
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def numpy_random_svd(x, sketch, iters, seed=0):
    """bench.py's ``_numpy_random_svd``: the same algorithm in NumPy, the
    proxy of ``bench_randomsvd``'s 1% gate."""
    import numpy as np
    rng = np.random.RandomState(seed)
    omega = rng.standard_normal((x.shape[1], sketch)).astype(np.float32)
    q, _ = np.linalg.qr(x @ omega)
    for _ in range(iters):
        qz, _ = np.linalg.qr(x.T @ q)
        q, _ = np.linalg.qr(x @ qz)
    b = q.T @ x
    ub, s, vt = np.linalg.svd(b, full_matrices=False)
    return q @ ub, s, vt


def orth_err(q):
    """‖QᵀQ − I‖_max in float64 on the host."""
    import numpy as np
    q = q.astype(np.float64)
    return float(np.abs(q.T @ q - np.eye(q.shape[1])).max())


def rel_resid(approx, x):
    """‖approx − X‖_F / ‖X‖_F in float64 on the host."""
    import numpy as np
    x = x.astype(np.float64)
    return float(np.linalg.norm(approx - x) / np.linalg.norm(x))


def numpy_gmm_iter(x, weights, means, covs, reg=1e-6):
    """bench.py's ``_numpy_gmm_iter``: one full-covariance EM iteration
    (log-domain responsibilities), here in the dtype of its inputs
    (float64 in the gate)."""
    import numpy as np
    m, n = x.shape
    k = means.shape[0]
    log_prob = np.empty((m, k), x.dtype)
    for j in range(k):
        chol = np.linalg.cholesky(covs[j])
        dev = np.linalg.solve(chol, (x - means[j]).T)
        log_det = 2.0 * np.log(np.diag(chol)).sum()
        log_prob[:, j] = -0.5 * (n * np.log(2 * np.pi) + log_det
                                 + (dev * dev).sum(0))
    wlp = log_prob + np.log(weights)[None]
    norm = wlp.max(1, keepdims=True)
    resp = np.exp(wlp - norm)
    resp /= resp.sum(1, keepdims=True)
    nk = resp.sum(0) + 1e-10
    means = resp.T @ x / nk[:, None]
    covs = np.empty_like(covs)
    for j in range(k):
        diff = x - means[j]
        covs[j] = (resp[:, j, None] * diff).T @ diff / nk[j] \
            + reg * np.eye(n, dtype=x.dtype)
    return nk / m, means, covs


def numpy_admm(x, y, rho, kappa, abstol, reltol, max_iter):
    """Consensus ADMM with one agent and the soft-threshold prox in
    float64 NumPy, the port's iteration and stopping test
    (``optimization/admm.py``).  Returns (z, n_iter, converged)."""
    import numpy as np
    n = x.shape[1]
    chol = np.linalg.cholesky(x.T @ x + rho * np.eye(n))
    atb = x.T @ y[:, 0]
    z, u = np.zeros(n), np.zeros(n)
    for it in range(1, max_iter + 1):
        xi = np.linalg.solve(chol.T, np.linalg.solve(chol, atb + rho * (z - u)))
        z_old = z
        v = xi + u
        z = np.sign(v) * np.maximum(np.abs(v) - kappa, 0.0)
        u = u + xi - z
        r = np.linalg.norm(xi - z)
        s = rho * np.linalg.norm(z - z_old)
        e_pri = np.sqrt(n) * abstol + reltol * max(np.linalg.norm(xi),
                                                   np.linalg.norm(z))
        e_dual = np.sqrt(n) * abstol + reltol * np.linalg.norm(rho * u)
        if r < e_pri and s < e_dual:
            return z, it, True
    return z, max_iter, False


def nondecreasing(hist, what):
    """The EM lower bound is finite and does not fall (beyond f32
    rounding of a mean over 1M rows: 1e-6 of its size)."""
    import numpy as np
    h = np.asarray(hist, np.float64)
    check(len(h) and np.isfinite(h).all(), f"{what}: lower bound not finite")
    drop = float(np.max(h[:-1] - h[1:])) if len(h) > 1 else 0.0
    check(drop <= 1e-6 * max(1.0, float(np.abs(h).max())),
          f"{what}: lower bound fell by {drop}")
    return drop


def gm_phase(dev, cuda_ms):
    """GaussianMixture at BASELINE config 5 (bench_gmm): 1M x 50, k = 16,
    full covariances.  Gate: one EM step from explicit inits against a
    float64 NumPy step; timing as bench_gmm (the median of 5 fits of 5
    iterations from the random init, tol = 0); the default KMeans init
    once (at most 11 distances_sq launches); each other covariance type
    with tol = 1e-3; one profiled fit.  Returns the kernel entry of
    distances_sq at the init's shape."""
    import numpy as np
    import torch
    import dislib_tpu_torch as dst
    from dislib_tpu_torch.ops import kernels as K
    from dislib_tpu_torch.runtime.loop import EVERY
    from dislib_tpu_torch.utils import profiling as prof
    rng = np.random.RandomState(0)
    x_host = rng.standard_normal((GM_M, GM_N)).astype(np.float32)
    means0 = x_host[rng.choice(GM_M, GM_K, replace=False)].copy()
    X = dst.array(x_host)
    w0 = np.full(GM_K, 1.0 / GM_K, np.float32)
    covs0 = np.tile(np.eye(GM_N, dtype=np.float32)[None], (GM_K, 1, 1))
    t0 = time.perf_counter()
    want = numpy_gmm_iter(x_host.astype(np.float64), w0.astype(np.float64),
                          means0.astype(np.float64), covs0.astype(np.float64))
    numpy_step_s = time.perf_counter() - t0
    one = dst.GaussianMixture(
        n_components=GM_K, max_iter=1, tol=0.0, init_params="random",
        random_state=0, weights_init=w0, means_init=means0,
        precisions_init=covs0).fit(X)
    # f32 sums over 1M rows against float64: 1e-4 absolute and relative
    errs = {}
    for name, got, ref in (("weights", one.weights_, want[0]),
                           ("means", one.means_, want[1]),
                           ("covariances", one.covariances_, want[2])):
        errs[name] = float(np.max(np.abs(got - ref)
                                  / (1e-4 + 1e-4 * np.abs(ref))))
        check(errs[name] <= 1.0, f"gm: one EM step's {name} off the float64 "
              f"NumPy step by {errs[name]} of 1e-4 + 1e-4·|ref|")

    def fit_bench():
        return dst.GaussianMixture(n_components=GM_K, max_iter=GM_ITERS,
                                   tol=0.0, init_params="random",
                                   random_state=0).fit(X)

    fit_bench()                                            # warm
    times = []
    for _ in range(5):
        prof.reset_host_reads()
        K.reset_launches()
        t0 = time.perf_counter()
        gm = fit_bench()
        times.append(time.perf_counter() - t0)
    bench_s = float(np.median(times))
    reads_bench = dict(prof.HOST_READS)
    check(gm.n_iter_ == GM_ITERS and np.isfinite(gm.lower_bound_),
          f"gm bench fit: n_iter {gm.n_iter_}, lower bound {gm.lower_bound_}")
    drop_bench = nondecreasing(gm.history_, "gm bench fit")
    score = gm.score(X)
    check(np.isfinite(score), f"gm score {score} not finite")
    labels = gm.predict(X)
    lab = labels._data[:, 0]
    check(labels.shape == (GM_M, 1) and int(lab.min()) >= 0
          and int(lab.max()) < GM_K, "gm predict labels: shape / range")
    wall_us, busy, spans = profile_device(fit_bench)
    # the default KMeans init, once: <= 10 Lloyd steps and one predict
    prof.reset_host_reads()
    K.reset_launches()
    t0 = time.perf_counter()
    gk = dst.GaussianMixture(n_components=GM_K, random_state=0).fit(X)
    MODELS["GaussianMixture"] = (gk, GM_N)
    torch.cuda.synchronize()
    kmeans_init_s = time.perf_counter() - t0
    launches_init = dict(K.LAUNCHES)
    reads_init = dict(prof.HOST_READS)
    check(1 <= launches_init["distances_sq"] <= 11,
          f"gm kmeans init launched distances_sq "
          f"{launches_init['distances_sq']} times (<= 11)")
    drop_init = nondecreasing(gk.history_, "gm kmeans-init fit")
    check(reads_init.get("gm", 0) + 1 <= -(-gk.max_iter // EVERY) + 1,
          f"gm: {reads_init} host reads")
    types = {"full": {"seconds": kmeans_init_s, "n_iter": gk.n_iter_,
                      "converged": gk.converged_,
                      "lower_bound": gk.lower_bound_,
                      "host_reads": reads_init,
                      "launches": launches_init,
                      "largest_drop": drop_init}}
    for cov in ("tied", "diag", "spherical"):
        prof.reset_host_reads()
        K.reset_launches()
        t0 = time.perf_counter()
        g2 = dst.GaussianMixture(n_components=GM_K, covariance_type=cov,
                                 tol=1e-3, random_state=0).fit(X)
        torch.cuda.synchronize()
        types[cov] = {"seconds": time.perf_counter() - t0,
                      "n_iter": g2.n_iter_, "converged": g2.converged_,
                      "lower_bound": g2.lower_bound_,
                      "host_reads": dict(prof.HOST_READS),
                      "launches": dict(K.LAUNCHES),
                      "largest_drop": nondecreasing(g2.history_,
                                                    f"gm {cov}")}
    emit({"phase": "gm", "shape": [GM_M, GM_N], "k": GM_K,
          "covariance_type": "full", "iterations": GM_ITERS,
          "gate_one_em_step_vs_numpy_f64": errs,
          "numpy_f64_em_step_s": numpy_step_s,
          "bench_fit_s_median": bench_s, "bench_fit_s_mean":
          float(np.mean(times)), "bench_fits_s": times,
          "s_per_em_iteration": bench_s / GM_ITERS,
          "bench_host_reads": reads_bench, "score": score,
          "bench_largest_lb_drop": drop_bench,
          "profiled_fit": {"wall_ms": wall_us / 1e3,
                           "device_busy_ms": busy / 1e3,
                           "device_idle_share": 1.0 - busy / wall_us,
                           "kernels_ms": top_kernels(spans, n=10)},
          "by_covariance_type_tol_1e-3": types})
    # distances_sq at the KMeans init's shape: d = 50 takes the slices
    xd = X._data
    cd = torch.from_numpy(means0).to(dev)
    entry = dist_entry(K, "gm_init", xd, cd, cuda_ms, 20)
    check(entry["plan"]["rows"] == 0,
          "distances_sq at d = 50 should take the slices")
    entry["launches"] = launches_init["distances_sq"]
    return entry


@contextlib.contextmanager
def daura_launches(K, first=None):
    """Inside the block, count each ``K.distances_sq`` call's launches
    (the counter's rise across the call) by where the call is made: inside
    an ε-pass of the streamed tiers (``ops/ring.ring_neigh_count_min`` or
    ``ops/tiled.neigh_count_min``, as ``cluster/dbscan.streamed_setup``
    calls them) under ``"eps"``, outside one (Daura's medoid columns)
    under ``"col"``.  Yields the counts; ``first`` keeps each kind's first
    inputs."""
    from dislib_tpu_torch.cluster import dbscan
    from dislib_tpu_torch.ops import tiled
    split, inside = {"eps": 0, "col": 0}, [0]
    orig = (K.distances_sq, dbscan.ring_neigh_count_min,
            tiled.neigh_count_min)

    def dist(*a, **kw):
        key = "eps" if inside[0] else "col"
        if first is not None:
            first.setdefault(key, a)
        before = K.LAUNCHES["distances_sq"]
        try:
            return orig[0](*a, **kw)
        finally:
            split[key] += K.LAUNCHES["distances_sq"] - before

    def eps_pass(fn):
        def wrapped(*a, **kw):
            inside[0] += 1
            try:
                return fn(*a, **kw)
            finally:
                inside[0] -= 1
        return wrapped

    K.distances_sq = dist
    dbscan.ring_neigh_count_min = eps_pass(orig[1])
    tiled.neigh_count_min = eps_pass(orig[2])
    try:
        yield split
    finally:
        K.distances_sq, dbscan.ring_neigh_count_min, \
            tiled.neigh_count_min = orig


def dist_entry(K, tag, a, b, cuda_ms, reps):
    """The kernels-line entry of distances_sq at the shape of ``a`` (m, d)
    and ``b`` (k, d): the kernel held against its plain version (1e-5 of
    max ‖a‖² + max ‖b‖², the magnitudes that cancel), its time, the plain
    version's and ``torch.cdist``'s (the same clamped GEMM formulation,
    then a square root), and the bound."""
    import torch
    from dislib_tpu_torch.ops import precision as px
    (m, d), k = a.shape, b.shape[0]
    out = K.distances_sq(a, b)
    plain = K.distances_sq_plain(a, b, "highest")
    scale = float((a.double() ** 2).sum(1).max()
                  + (b.double() ** 2).sum(1).max())
    err = float((out.double() - plain.double()).abs().max()) / scale
    check(err <= 1e-5, f"distances_sq at the {tag} shape: error {err}")
    check(bool((out >= 0).all()), f"distances_sq at the {tag} shape: "
          "negative distance")
    max_abs = float((out - plain).abs().max())
    del out, plain

    def cdist():
        with px.precise():
            return torch.cdist(a, b, compute_mode="use_mm_for_euclid_dist")

    bound_ms, bound_by = dist_bound(m, k, d, 4.0 * (m * d + k * d + m * k))
    n_sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    return {"name": "distances_sq", "at": tag, "route": "cuda",
            "source": "dislib_tpu_torch/csrc/distances_sq.cu",
            "replaces": "dislib_tpu/ops/pallas_kernels.py:112",
            "plan": K.dist_plan(m, d, a.data_ptr(), n_sms)._asdict(),
            "shape": [m, k, d], "max_abs_err": max_abs,
            "normalized_err_vs_plain": err,
            "ms": cuda_ms(lambda: K.distances_sq(a, b), reps),
            "plain_ms": cuda_ms(lambda: K.distances_sq_plain(a, b,
                                                             "highest"), reps),
            "library_ms": cuda_ms(cdist, reps),
            "library_call": "torch.cdist(a, b, compute_mode="
                            "'use_mm_for_euclid_dist'), TF32 off (includes "
                            "a square root)",
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_basis": DIST_BOUND_BASIS}


def minibatch_phase(X, x_host, init, dev, cuda_ms):
    """MiniBatchKMeans on the KMeans data: one epoch of MBK_BATCH-row
    batches through ``fit``.  Gate: a replay, batch by batch, of each
    update in float64 NumPy given the port's labels (the distance kernel
    on the port's previous centers), the labels equal to float64 NumPy's
    on rows that are not near ties.  Returns the kernel entry of
    distances_sq at the batch's shape."""
    import numpy as np
    import torch
    import dislib_tpu_torch as dst
    from dislib_tpu_torch.ops import kernels as K
    from dislib_tpu_torch.utils import profiling as prof
    m, k = x_host.shape[0], init.shape[0]
    n_batches = -(-m // MBK_BATCH)

    def est():
        return dst.MiniBatchKMeans(n_clusters=k, init=init,
                                   batch_size=MBK_BATCH)

    est().partial_fit(X[:MBK_BATCH, :])                     # warm
    torch.cuda.synchronize()
    prof.reset_host_reads()
    K.reset_launches()
    t0 = time.perf_counter()
    mbk = est().fit(X)
    fit_s = time.perf_counter() - t0
    MODELS["MiniBatchKMeans"] = (mbk, KM_N)
    launches = dict(K.LAUNCHES)
    reads = dict(prof.HOST_READS)
    check(mbk.n_batches_ == n_batches and launches["distances_sq"]
          == n_batches, f"minibatch: {mbk.n_batches_} batches, "
          f"{launches['distances_sq']} distances_sq launches")
    # the replay
    rep = est()
    centers, counts = init.astype(np.float64), np.zeros(k)
    worst, clear_rows, rows = 0.0, 0, 0
    for s in range(0, m, MBK_BATCH):
        xb = x_host[s: s + MBK_BATCH].astype(np.float64)
        prev = torch.as_tensor(rep.centers_ if s else init, device=dev)
        lab = K.distances_sq(X._data[s: s + MBK_BATCH], prev).argmin(1) \
            .cpu().numpy()
        rep.partial_fit(X[s: s + MBK_BATCH, :])
        p64 = prev.double().cpu().numpy()
        bc = np.bincount(lab, minlength=k).astype(np.float64)
        bmean = np.zeros_like(p64)
        np.add.at(bmean, lab, xb)
        bmean /= np.maximum(bc, 1.0)[:, None]
        counts = counts + bc
        eta = (bc / np.maximum(counts, 1.0))[:, None]
        centers = np.where(bc[:, None] > 0, p64 + eta * (bmean - p64), p64)
        check(np.array_equal(rep.counts_, counts),
              f"minibatch batch at row {s}: counts differ")
        # f32 batch means of 4096 rows against float64: 2e-5 absolute
        worst = max(worst, float(np.abs(rep.centers_ - centers).max()))
        check(worst <= 2e-5, f"minibatch batch at row {s}: centers off the "
              f"float64 replay by {worst}")
        d = ((xb[:, None, :] - p64[None]) ** 2).sum(-1)
        two = np.sort(d, axis=1)[:, :2]
        clear = two[:, 1] - two[:, 0] > 1e-4 * ((xb ** 2).sum(1)
                                                + (p64 ** 2).sum(1).max())
        check(np.array_equal(lab[clear], d.argmin(1)[clear]),
              f"minibatch batch at row {s}: labels differ from NumPy")
        clear_rows += int(clear.sum())
        rows += len(xb)
    check(np.array_equal(rep.centers_, mbk.centers_),
          "minibatch: the replayed stream differs from fit")
    emit({"phase": "minibatch_kmeans", "shape": [m, x_host.shape[1]],
          "k": k, "batch_size": MBK_BATCH, "epochs": 1,
          "batches": n_batches, "fit_s": fit_s,
          "ms_per_batch": 1e3 * fit_s / n_batches, "host_reads": reads,
          "launches": launches, "inertia_last_batch": mbk.inertia_,
          "gate_centers_max_abs_vs_f64_replay": worst,
          "gate_label_rows_clear": clear_rows, "gate_label_rows": rows})
    xb = X._data[:MBK_BATCH]
    entry = dist_entry(K, "minibatch", xb, torch.as_tensor(init, device=dev),
                       cuda_ms, 200)
    entry["launches"] = launches["distances_sq"]
    return entry


def scalers_and_regression_phases(dev):
    """StandardScaler and MinMaxScaler on 1M x 100 with column means near
    1000, LinearRegression and Lasso on 1M x 100 with a sparse beta, each
    against float64 NumPy."""
    import numpy as np
    import torch
    import dislib_tpu_torch as dst
    from dislib_tpu_torch.ops import kernels as K
    from dislib_tpu_torch.utils import profiling as prof
    rng = np.random.RandomState(7)
    x = (1000.0 + rng.uniform(-5, 5, SC_N)
         + rng.standard_normal((SC_M, SC_N))).astype(np.float32)
    X = dst.array(x)
    x64 = x.astype(np.float64)
    res = {}
    for cls in (dst.StandardScaler, dst.MinMaxScaler):
        cls().fit(X)                                        # warm
        t0 = time.perf_counter()
        sc = cls().fit(X)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        MODELS[cls.__name__] = (sc, SC_N)
        t0 = time.perf_counter()
        t = sc.transform(X)
        torch.cuda.synchronize()
        transform_s = time.perf_counter() - t0
        back = sc.inverse_transform(t).collect()
        # f32 values near 1000 carry 6.1e-5 ulps: the round trip within 5
        round_trip = float(np.abs(back - x).max())
        check(round_trip <= 3e-4, f"{cls.__name__} round trip off by "
              f"{round_trip}")
        if cls is dst.StandardScaler:
            mean_err = float(np.abs(sc.mean_.collect().ravel()
                                    - x64.mean(0)).max() / 1000.0)
            var_err = float(np.max(np.abs(sc.var_.collect().ravel()
                                          - x64.var(0)) / x64.var(0)))
            # the two-pass variance in f32 at |mean| 1000: 1e-4 relative
            check(mean_err <= 1e-6 and var_err <= 1e-4,
                  f"StandardScaler mean {mean_err}, var {var_err} vs "
                  "float64")
            tc = t.collect()
            errs = {"mean_rel_err": mean_err, "var_rel_err": var_err,
                    "transform_std": float(tc.std())}
        else:
            check(np.array_equal(sc.data_min_.collect().ravel(), x.min(0))
                  and np.array_equal(sc.data_max_.collect().ravel(),
                                     x.max(0)), "MinMaxScaler min/max")
            errs = {"min_max_exact": True}
        res[cls.__name__] = {"fit_s": fit_s, "transform_s": transform_s,
                             "round_trip_max_abs": round_trip, **errs}
        del t
    emit({"phase": "scalers", "shape": [SC_M, SC_N], **res})
    del X, x, x64
    # LinearRegression and Lasso: y = x·beta + noise, beta half zeros
    x, y, yl = lr_data(LR_M, LR_N)
    X, Y = dst.array(x), dst.array(y)
    x64 = x.astype(np.float64)
    dst.LinearRegression().fit(X, Y)                        # warm
    t0 = time.perf_counter()
    lr = dst.LinearRegression().fit(X, Y)
    lr_s = time.perf_counter() - t0
    MODELS["LinearRegression"] = (lr, LR_N)
    xa = np.concatenate([x64, np.ones((LR_M, 1))], 1)
    sol = np.linalg.lstsq(xa, y.astype(np.float64), rcond=None)[0]
    lr_err = float(max(np.abs(lr.coef_ - sol[:-1]).max(),
                       np.abs(lr.intercept_ - sol[-1]).max()))
    # f32 normal equations over 1M rows: 1e-4
    check(lr_err <= 1e-4, f"LinearRegression off lstsq by {lr_err}")
    r2 = lr.score(X, Y)
    del xa
    emit({"phase": "linear_regression", "shape": [LR_M, LR_N],
          "fit_s": lr_s, "coef_max_abs_err_vs_lstsq": lr_err, "r2": r2})
    Yl = dst.array(yl)

    def lasso():
        return dst.Lasso(lmbd=LASSO_LMBD, rho=LASSO_RHO,
                         max_iter=LASSO_ITERS).fit(X, Yl)

    lasso()                                                # warm
    prof.reset_host_reads()
    K.reset_launches()
    t0 = time.perf_counter()
    la = lasso()
    la_s = time.perf_counter() - t0
    MODELS["Lasso"] = (la, LR_N)
    reads = dict(prof.HOST_READS)
    z, n_iter, conv = numpy_admm(x64, yl.astype(np.float64), LASSO_RHO,
                                 LASSO_LMBD / LASSO_RHO, 1e-4, 1e-2,
                                 LASSO_ITERS)
    la_err = float(np.abs(la.coef_ - z).max())
    check(la.n_iter_ == n_iter and la.converged_ == conv,
          f"Lasso: {la.n_iter_} iterations (converged {la.converged_}), "
          f"the float64 NumPy ADMM {n_iter} ({conv})")
    check(la_err <= 1e-4, f"Lasso coef off the float64 ADMM by {la_err}")
    zeros = int((la.coef_ == 0).sum())
    check(0 < zeros < LR_N and zeros == int((z == 0).sum()),
          f"Lasso: {zeros} zero coefficients, NumPy {(z == 0).sum()}")
    pred = la.predict(X).collect()
    check(pred.shape == (LR_M, 1) and np.isfinite(pred).all(),
          "Lasso predict")
    emit({"phase": "lasso", "shape": [LR_M, LR_N], "lmbd": LASSO_LMBD,
          "rho": LASSO_RHO, "fit_s": la_s, "n_iter": la.n_iter_,
          "numpy_n_iter": n_iter, "converged": la.converged_,
          "zero_coefs": zeros, "coef_max_abs_err_vs_numpy_admm": la_err,
          "host_reads": reads, "r2": la.score(X, Yl),
          "launches": dict(K.LAUNCHES)})


def linalg_phases(dev):
    """The ds-array's blocked linear algebra through its entry points at
    bench.py's full widths, under both precision policies.  Each result
    is checked on the host against a float64 NumPy oracle within its
    ``ERROR_BOUNDS`` row (and bench.py's own gate where the row has one).
    Each entry point prints its first and its timed (second) call's wall
    time, synchronised, the timed call's host reads and kernel launches
    (none: this slice runs no hand kernel), and one profiled FLOAT32
    call's device busy/idle and top kernels.  Returns the tsqr route A/B
    and the wall times."""
    import importlib
    import numpy as np
    import torch
    import dislib_tpu_torch as dst
    from dislib_tpu_torch.ops import kernels as K
    from dislib_tpu_torch.ops import precision as px
    from dislib_tpu_torch.utils import profiling as prof
    bounds = px.ERROR_BOUNDS
    summary, launches = {}, {}

    def drive(name, fn, gate, policies=POLICIES, profiled=POLICIES[:1]):
        res = {}
        for pol in policies:
            t0 = time.perf_counter()
            out = fn(pol)
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            gates = gate(out, pol)
            del out
            prof.reset_host_reads()
            K.reset_launches()
            t0 = time.perf_counter()
            out = fn(pol)
            torch.cuda.synchronize()
            res[pol] = {"first_call_s": first,
                        "seconds": time.perf_counter() - t0,
                        "host_reads": dict(prof.HOST_READS),
                        "launches": dict(K.LAUNCHES), **gates}
            for k, n in K.LAUNCHES.items():
                launches[k] = launches.get(k, 0) + n
            del out
        for pol in profiled:
            wall_us, busy, spans = profile_device(lambda: fn(pol))
            res["profiled_" + pol] = {
                "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
                "device_idle_share": 1.0 - busy / wall_us,
                "kernels_ms": top_kernels(spans)}
        emit({"phase": "linalg", "entry": name, **res})
        summary[name] = {pol: res[pol]["seconds"] for pol in policies}
        torch.cuda.empty_cache()
        return res

    def qr_gate(key, x):
        def gate(out, pol):
            q, r = (a.collect() for a in out)
            o = orth_err(q)
            rr = rel_resid(q.astype(np.float64) @ r, x)
            check(o <= bounds[(key + "_orth", pol)]
                  and rr <= bounds[(key + "_resid", pol)],
                  f"{key} {pol} {x.shape}: orth {o}, resid {rr} outside "
                  "ERROR_BOUNDS")
            return {"orth_err": o, "resid": rr}
        return gate

    # -- tsqr: bench_tsqr's data, both local-QR routes ------------------------
    rng = np.random.RandomState(0)
    x = rng.standard_normal(TSQR).astype(np.float32)
    X = dst.array(x)
    tsqr_gate = qr_gate("tsqr", x)

    def tsqr_bench_gate(out, pol):
        got = tsqr_gate(out, pol)
        q, r = (a.collect() for a in out)
        # bench_tsqr's own gate
        np.testing.assert_allclose(q @ r, x, rtol=1e-2, atol=1e-2)
        np.testing.assert_allclose(q.T @ q, np.eye(TSQR[1]), atol=1e-2)
        return got

    routes = {}
    saved = os.environ.get("DSLIB_TSQR_CHOLQR")
    try:
        for route, flag in (("tree", "0"), ("cholqr2", "1")):
            os.environ["DSLIB_TSQR_CHOLQR"] = flag
            drive(f"tsqr[{route}]",
                  lambda pol: dst.tsqr(X, precision=pol), tsqr_bench_gate)
            routes[route] = med_s(lambda: dst.tsqr(X))
    finally:
        if saved is None:
            os.environ.pop("DSLIB_TSQR_CHOLQR", None)
        else:
            os.environ["DSLIB_TSQR_CHOLQR"] = saved
    tsqr_mod = importlib.import_module("dislib_tpu_torch.decomposition.tsqr")
    auto = "cholqr2" if tsqr_mod._use_cholqr(dev) else "tree"
    # do batched factorisations run as one call or loop over the batch?
    g = torch.Generator(device=dev).manual_seed(1)
    panels = torch.randn((32, 2048, 256), generator=g, device=dev)
    pairs = torch.randn((4, 128, 128), generator=g, device=dev)
    batched = {
        "qr_32x2048x256": {
            "batched_s": med_s(lambda: torch.linalg.qr(panels)),
            "one_panel_s": med_s(lambda: torch.linalg.qr(panels[0])),
            "loop_s": med_s(lambda: [torch.linalg.qr(p) for p in panels])},
        "svd_4x128x128": {
            "batched_s": med_s(lambda: torch.linalg.svd(pairs)),
            "one_s": med_s(lambda: torch.linalg.svd(pairs[0])),
            "loop_s": med_s(lambda: [torch.linalg.svd(p) for p in pairs])}}
    del panels, pairs
    # the route DSLIB_TSQR_CHOLQR=auto takes on the card must be the faster
    check(routes[auto] <= min(routes.values()),
          f"tsqr: auto takes {auto}, but the routes measured {routes}")
    emit({"phase": "tsqr_routes", "shape": list(TSQR),
          "median_s": routes, "auto_route": auto,
          "batched_factorisations": batched})
    del X

    # -- qr: the blocked panel loop (economic) and the complement (full) ------
    x = rng.standard_normal(QR_ECON).astype(np.float32)
    X = dst.array(x)
    drive("qr[economic]", lambda pol: dst.qr(X, mode="economic",
                                              precision=pol),
          qr_gate("qr", x))
    x = rng.standard_normal(QR_FULL).astype(np.float32)
    X = dst.array(x)

    def full_gate(out, pol):
        got = qr_gate("qr", x)(out, pol)
        check(out[0].shape == (QR_FULL[0], QR_FULL[0]) and out[1].shape
              == QR_FULL, f"qr full shapes {out[0].shape}, {out[1].shape}")
        return got

    drive("qr[full]", lambda pol: dst.qr(X, mode="full", precision=pol),
          full_gate)

    # -- random_svd and PCA on bench_randomsvd's data ------------------------
    rng = np.random.RandomState(0)
    x = (rng.standard_normal(RSVD) * 0.95 ** np.arange(RSVD[1])).astype(
        np.float32)
    x64 = x.astype(np.float64)
    mu = x64.mean(0)
    gram = x64.T @ x64
    s_exact = np.sqrt(np.maximum(np.linalg.eigvalsh(gram)[::-1], 0.0))
    var_exact = np.linalg.eigvalsh((gram - RSVD[0] * np.outer(mu, mu))
                                   / (RSVD[0] - 1))[::-1]
    del gram
    _, s_proxy, _ = numpy_random_svd(x, RSVD_NSV + 10, RSVD_ITERS)
    X = dst.array(x)

    def rsvd_gate(out, pol):
        u, s, v = out
        s = s.collect().ravel()
        check(u.shape == (RSVD[0], RSVD_NSV) and v.shape == (RSVD[1],
                                                             RSVD_NSV),
              f"random_svd shapes {u.shape}, {v.shape}")
        # bench_randomsvd's gate, then the bound on the same 16 values
        np.testing.assert_allclose(s[:16], s_proxy[:16], rtol=1e-2)
        err = float(np.abs(s[:16] - s_exact[:16]).max() / s_exact[0])
        check(err <= bounds[("randomsvd_values", pol)],
              f"random_svd {pol}: top-16 error {err} > ERROR_BOUNDS")
        return {"top16_err_vs_exact": err,
                "top16_rel_vs_numpy_proxy": float(np.max(np.abs(
                    s[:16] - s_proxy[:16]) / s_proxy[:16]))}

    drive("random_svd", lambda pol: dst.random_svd(
        X, iters=RSVD_ITERS, nsv=RSVD_NSV, oversample=10, random_state=0,
        precision=pol), rsvd_gate, profiled=POLICIES)

    def pca_gate(method):
        def gate(est, pol):
            var = est.explained_variance_.collect().ravel()
            err = float(np.abs(var[:RSVD_NSV] - var_exact[:RSVD_NSV]).max()
                        / var_exact[0])
            # the reference's PCA policy bound: 2e-2 under bfloat16
            tol = 1e-4 if pol == "float32" else 2e-2
            back = est.inverse_transform(est.transform(X)).collect()
            recon = rel_resid(back.astype(np.float64), x)
            check(err <= tol and recon <= tol,
                  f"PCA {method} {pol}: variance error {err}, "
                  f"reconstruction {recon} > {tol}")
            return {"top64_var_err_vs_f64_eigh": err,
                    "reconstruction_err": recon}
        return gate

    for method in ("eig", "svd"):
        drive(f"PCA[{method}]", lambda pol: dst.PCA(
            method=method, precision=pol).fit(X), pca_gate(method))
    MODELS["PCA"] = (dst.PCA(method="eig").fit(X), X.shape[1])
    del X, x64

    # -- svd: the block tier (bench_svd's data) and the scalar tier ----------
    for shape, tier in ((SVD_BLOCK, "block"), (SVD_SCALAR, "scalar")):
        x = np.random.RandomState(0).rand(*shape).astype(np.float32)
        s64 = np.linalg.svd(x.astype(np.float64), compute_uv=False)
        X = dst.array(x)

        def svd_gate(out, pol):
            u, s, v = (a.collect() for a in out)
            s = s.ravel()
            # bench_svd's gate, then the bounds
            np.testing.assert_allclose(s, s64, rtol=1e-3, atol=1e-3 * s64[0])
            verr = float(np.abs(s - s64).max() / s64[0])
            rr = rel_resid((u.astype(np.float64) * s) @ v.T, x)
            check(verr <= bounds[("svd_values", pol)]
                  and rr <= bounds[("svd_resid", pol)],
                  f"svd {shape} {pol}: values {verr}, resid {rr} outside "
                  "ERROR_BOUNDS")
            return {"values_err": verr, "resid": rr}

        drive(f"svd[{tier}]", lambda pol: dst.svd(X, precision=pol),
              svd_gate)

    # -- polar: bench_polar's data and gates ----------------------------------
    x = np.random.RandomState(0).standard_normal(POLAR).astype(np.float32)
    X = dst.array(x)

    def polar_gate(out, pol):
        u, h, nfo = out
        uh = u.collect()
        o = orth_err(uh)
        rr = rel_resid(uh.astype(np.float64) @ h.collect(), x)
        check(o <= bounds[("polar_orth", pol)]
              and rr <= bounds[("polar_resid", pol)],
              f"polar {pol}: orth {o}, resid {rr} outside ERROR_BOUNDS")
        if pol == "float32":      # bench_polar's gates
            check(o <= bounds[("polar_orth", pol)] * 10 and rr <= 1e-4,
                  f"polar: bench gate, orth {o}, recon {rr}")
        return {"orth_err": o, "resid": rr, "iterations": nfo["iterations"],
                "reported_ortho_err": nfo["ortho_err"]}

    drive("polar", lambda pol: dst.polar(X, precision=pol, info=True),
          polar_gate, profiled=POLICIES)

    # -- lanczos_svd and kron --------------------------------------------------
    rng = np.random.RandomState(6)
    x = (rng.standard_normal(LANCZOS) * 0.9 ** np.arange(LANCZOS[1])).astype(
        np.float32)
    s64 = np.linalg.svd(x.astype(np.float64), compute_uv=False)
    X = dst.array(x)

    def lanczos_gate(out, pol):
        s = out[1].collect().ravel()
        err = float(np.abs(s - s64[:LANCZOS_K]).max() / s64[0])
        check(err <= bounds[("lanczos_values", pol)],
              f"lanczos_svd {pol}: values error {err} > ERROR_BOUNDS")
        return {"values_err": err}

    drive("lanczos_svd", lambda pol: dst.lanczos_svd(
        X, k=LANCZOS_K, random_state=0, precision=pol), lanczos_gate)
    a = rng.standard_normal(KRON[0]).astype(np.float32)
    b = rng.standard_normal(KRON[1]).astype(np.float32)
    A, Bk = dst.array(a), dst.array(b)

    def kron_gate(out, pol):
        check(np.array_equal(out.collect(), np.kron(a, b)),
              "kron differs from np.kron")
        return {"bit_equal_to_np_kron": True}

    drive("kron", lambda pol: dst.kron(A, Bk), kron_gate,
          policies=("float32",))
    return {"tsqr_routes_s": routes, "tsqr_auto_route": auto,
            "seconds": summary, "launches_in_timed_calls": launches}


def knn_phases(dev, cuda_ms):
    """The seventh slice: ``NearestNeighbors`` at bench_knn's sizes, the
    single-rank ring with its cross term on ``panel_gemm``, GridSearchCV
    over KMeans (bench_gridsearch) and over the kNN classifier, and
    shuffle / train_test_split of the KMeans data.  Returns the kernel
    entries of ``distances_sq`` at a kNN chunk and at a search chunk, and
    of ``panel_gemm`` at the ring's cross term."""
    import numpy as np
    import torch
    import dislib_tpu_torch as dst
    from dislib_tpu_torch.neighbors import base as nb
    from dislib_tpu_torch.ops import kernels as K
    from dislib_tpu_torch.ops import precision as px
    from dislib_tpu_torch.ops.ring import ring_kneighbors
    from dislib_tpu_torch.utils import profiling as prof
    entries = {}
    # -- knn: bench_knn's draws, through ds.array --------------------------
    rng = np.random.RandomState(1)
    fit_host = rng.rand(KNN_MF, KNN_N).astype(np.float32)
    q_host = rng.rand(KNN_MQ, KNN_N).astype(np.float32)
    F, Q = dst.array(fit_host), dst.array(q_host)
    nn = dst.NearestNeighbors(n_neighbors=KNN_K).fit(F)
    MODELS["NearestNeighbors"] = (nn, KNN_N)
    nn.kneighbors(Q)                                       # warm
    torch.cuda.synchronize()
    K.reset_launches()
    d_arr, i_arr = nn.kneighbors(Q)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    n_chunks = -(-KNN_MF // nb._CHUNK)
    check(launches["distances_sq"] == n_chunks,
          f"knn: {launches['distances_sq']} distances_sq launches in one "
          f"kneighbors call, expected {n_chunks}")
    dist, idx = d_arr.collect(), i_arr.collect()
    check(dist.shape == (KNN_MQ, KNN_K) and idx.dtype == np.int32,
          f"knn: distances {dist.shape}, indices {idx.dtype}")
    # gate: a float64 NumPy brute force on the first KNN_GATE_Q queries
    f64 = fit_host.astype(np.float64)
    fsq = (f64 * f64).sum(1)
    d_err = 0.0
    for s in range(0, KNN_GATE_Q, 64):
        q64 = q_host[s: s + 64].astype(np.float64)
        d2 = np.maximum((q64 * q64).sum(1)[:, None] - 2.0 * (q64 @ f64.T)
                        + fsq[None], 0.0)
        top = np.sqrt(np.sort(np.partition(d2, KNN_K - 1, axis=1)
                              [:, :KNN_K], axis=1))
        d_err = max(d_err, float(np.abs(dist[s: s + 64] - top).max()))
        got = np.sqrt(d2[np.arange(len(q64))[:, None], idx[s: s + 64]])
        check(bool((got <= top[:, -1:] + 1e-4).all()),
              f"knn: an index of queries {s}..{s + 63} is farther than the "
              "oracle's 10th distance + 1e-4")
        del d2
    check(d_err <= 1e-4, f"knn: distances off the float64 brute force by "
          f"{d_err}")
    del f64, fsq
    call_s = med_s(lambda: nn.kneighbors(Q), 5)
    wall_us, busy, spans = profile_device(lambda: nn.kneighbors(Q))
    dist_spans = [sp for sp in spans if "dist_" in sp[2]]
    emit({"phase": "knn", "fit_rows": KNN_MF, "n_features": KNN_N,
          "queries": KNN_MQ, "k": KNN_K, "chunk": nb._CHUNK,
          "gate_queries": KNN_GATE_Q, "gate_max_abs_dist_err_vs_f64": d_err,
          "queries_per_s": KNN_MQ / call_s, "call_s_median_of_5": call_s,
          "launches_per_call": launches,
          "profiled_call": {
              "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
              "device_idle_share": 1.0 - busy / wall_us,
              "distances_sq_launches": len(dist_spans),
              "distances_sq_ms_per_launch": sum(e - s_ for s_, e, _
                                                in dist_spans)
              / max(1, len(dist_spans)) / 1e3,
              "kernels_ms": top_kernels(spans, n=10)}})
    qd = Q._data
    entries["distances_sq/knn"] = dist_entry(K, "knn", qd, F._data[:nb._CHUNK],
                                             cuda_ms, 50)
    entries["distances_sq/knn"]["launches"] = launches["distances_sq"]
    del nn, d_arr, i_arr
    # -- knn_ring: one rank, the cross term on panel_gemm -------------------
    fr = F._data[:RING_MF]
    K.reset_launches()
    d2r, idxr = ring_kneighbors(qd, fr, dst.get_mesh(), KNN_K, RING_MF,
                                overlap="kernel")
    torch.cuda.synchronize()
    launches_ring = dict(K.LAUNCHES)
    check(launches_ring["panel_gemm"] >= 1,
          f"knn_ring launched panel_gemm {launches_ring['panel_gemm']} times")
    od, oi = dst.NearestNeighbors(n_neighbors=KNN_K + 1).fit(
        dst.array(fit_host[:RING_MF])).kneighbors(Q)
    od, oi = od.collect(), oi.collect()
    rd, ri = torch.sqrt(d2r).cpu().numpy(), idxr.cpu().numpy()
    ring_err = float(np.abs(rd - od[:, :KNN_K]).max())
    check(ring_err <= 1e-5, f"knn_ring: distances off the chunked path by "
          f"{ring_err}")
    # position j is clear when the oracle's distances j-1, j, j+1 differ
    # by more than 1e-5
    gap = np.diff(od, axis=1) > 1e-5
    clear = np.concatenate([gap[:, :1], gap[:, :-1] & gap[:, 1:]], axis=1)
    check(np.array_equal(ri[clear], oi[:, :KNN_K][clear]),
          f"knn_ring: indices differ from the chunked path at "
          f"{int((ri[clear] != oi[:, :KNN_K][clear]).sum())} clear places")
    ring_s = med_s(lambda: ring_kneighbors(qd, fr, dst.get_mesh(), KNN_K,
                                           RING_MF, overlap="kernel"), 3)
    emit({"phase": "knn_ring", "queries": KNN_MQ, "fit_rows": RING_MF,
          "k": KNN_K, "overlap": "kernel", "launches": launches_ring,
          "gate_max_abs_dist_err_vs_chunked": ring_err,
          "gate_clear_places": int(clear.sum()),
          "call_s_median_of_3": ring_s})
    del d2r, idxr, od, oi
    ft = fr.T.contiguous()
    out = K.panel_gemm(qd, ft, px.FLOAT32)
    plain = K.panel_gemm_plain(qd, ft, px.FLOAT32)
    scale = float(torch.linalg.norm(qd.double()) * torch.linalg.norm(
        ft.double()) / KNN_N ** 0.5)
    g_err = float((out.double() - plain.double()).abs().max()) / scale
    check(g_err <= px.ERROR_BOUNDS[("matmul", "float32")],
          f"panel_gemm at the ring's shape: normalized error {g_err}")
    g_abs = float((out - plain).abs().max())
    del out, plain

    def mm():
        with px.precise():
            return torch.mm(qd, ft)

    m_, n_ = KNN_MQ, RING_MF
    bound_ms, bound_by = bound(3 * 2.0 * m_ * n_ * KNN_N,
                               4.0 * (m_ * KNN_N + KNN_N * n_ + m_ * n_),
                               PEAK_TF32_FLOPS)
    entries["panel_gemm/ring"] = {
        "name": "panel_gemm", "at": "ring", "policy": "float32",
        "route": "cuda", "source": "dislib_tpu_torch/csrc/panel_gemm.cu",
        "replaces": "dislib_tpu/ops/pallas_kernels.py:76",
        "shape": [m_, KNN_N, n_], "launches": launches_ring["panel_gemm"],
        "max_abs_err": g_abs, "normalized_err_vs_plain": g_err,
        "ms": cuda_ms(lambda: K.panel_gemm(qd, ft, px.FLOAT32), 20),
        "plain_ms": cuda_ms(lambda: K.panel_gemm_plain(qd, ft, px.FLOAT32),
                            20),
        "library_ms": cuda_ms(mm, 20),
        "library_call": "torch.mm (f32, TF32 off)",
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_basis": "3xTF32 at 495 TFLOP/s against 4 bytes per element "
                       "of q, f^T and the product"}
    emit({"phase": "kernel", **entries["panel_gemm/ring"]})
    del F, Q, qd, fr, ft, fit_host, q_host
    torch.cuda.empty_cache()
    # -- search: bench_gridsearch over KMeans, then the kNN classifier ------
    rng = np.random.RandomState(0)
    XG = dst.array(rng.rand(GS_M, GS_N).astype(np.float32))
    km_kw = dict(random_state=0, max_iter=10, tol=0.0)
    km_grid = {"n_clusters": [4, 8, 12]}

    def km_search():
        return dst.GridSearchCV(dst.KMeans(**km_kw), km_grid, cv=3,
                                refit=False).fit(XG)

    xb, lab = blobs(GS_M, GS_N, 8)
    XB, YB = dst.array(xb), dst.array(lab.astype(np.float32)[:, None])
    knn_grid = {"n_neighbors": [5, 15], "weights": ["uniform", "distance"]}

    def knn_search():
        return dst.GridSearchCV(dst.KNeighborsClassifier(), knn_grid,
                                cv=3).fit(XB, YB)

    # one kNN trial, fit and score, queues on the card with no
    # synchronisation at all (torch raises on any in "error" mode)
    xt, yt, xv, yv = next(dst.KFold(3).split(XB, YB))
    trial = dst.KNeighborsClassifier(n_neighbors=5)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        v = trial._score_async(trial._fit_async(xt, yt), xv, yv)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(isinstance(v, torch.Tensor) and v.device.type == dev.type,
          "search knn: a trial's score is not a tensor on the card")
    del xt, yt, xv, yv, trial, v
    res = {}
    # reads: the scores, in the search's own loop; the kNN refit reads
    # its classes_ once (HOST_READS["results"])
    for name, run, X, Y, est, refit_reads in (
            ("kmeans", km_search, XG, None,
             lambda p: dst.KMeans(**km_kw, **p), {}),
            ("knn", knn_search, XB, YB,
             lambda p: dst.KNeighborsClassifier(**p), {"results": 1})):
        run()                                             # warm
        torch.cuda.synchronize()
        walls = []
        for rep in range(3):
            prof.reset_host_reads()
            K.reset_launches()
            t0 = time.perf_counter()
            gs = run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if rep == 0:
                reads, launches_gs = dict(prof.HOST_READS), dict(K.LAUNCHES)
        n_trials = len(gs.cv_results_["params"]) * 3
        if name == "knn":
            MODELS["KNeighborsClassifier"] = (gs.best_estimator_, GS_N)
        check(reads == {"search": n_trials, **refit_reads},
              f"search {name}: host reads {reads}, expected the "
              f"{n_trials} scores and the refit's {refit_reads}")
        # gate: each split score equals a sequential fit, then score
        worst = 0.0
        for j, (xt, yt, xv, yv) in enumerate(dst.KFold(3).split(X, Y)):
            for ci, p in enumerate(gs.cv_results_["params"]):
                e = est(p).fit(xt) if Y is None else est(p).fit(xt, yt)
                want = e.score(xv) if Y is None else e.score(xv, yv)
                got = gs.cv_results_[f"split{j}_test_score"][ci]
                worst = max(worst, abs(got - want) / max(1.0, abs(want)))
        check(worst <= 1e-6, f"search {name}: a split score is off the "
              f"sequential fit and score by {worst}")
        wall_us, busy, spans = profile_device(run)
        res[name] = {"wall_s_median_of_3": float(np.median(walls)),
                     "profiled": {"wall_ms": wall_us / 1e3,
                                  "device_busy_ms": busy / 1e3,
                                  "device_idle_share": 1.0 - busy / wall_us,
                                  "kernels_ms": top_kernels(spans, n=8)},
                     "walls_s": walls, "trials": n_trials,
                     "host_reads": reads, "launches": launches_gs,
                     "best_params": gs.best_params_,
                     "best_score": gs.best_score_,
                     "gate_max_rel_err_vs_sequential": worst}
    check(res["knn"]["best_score"] >= 0.95,
          f"search knn: best score {res['knn']['best_score']} < 0.95")
    emit({"phase": "search", "kmeans_shape": [GS_M, GS_N],
          "knn_shape": [GS_M, GS_N], "cv": 3, **res})
    xt, _, xv, _ = next(dst.KFold(3).split(XB))
    entries["distances_sq/knn_search"] = dist_entry(
        K, "knn_search", xv._data, xt._data[:nb._CHUNK], cuda_ms, 20)
    entries["distances_sq/knn_search"]["launches"] = \
        res["knn"]["launches"]["distances_sq"]
    del XG, XB, YB, xb, xt, xv
    torch.cuda.empty_cache()
    # -- split: shuffle and train_test_split of the KMeans data -------------
    x_host = np.random.RandomState(0).rand(SPLIT_M, SPLIT_N).astype(
        np.float32)
    X = dst.array(x_host)
    Y = dst.array(np.arange(SPLIT_M, dtype=np.float32)[:, None])
    dst.shuffle(X, random_state=1)                          # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xs, ys = dst.shuffle(X, Y, random_state=3)
    torch.cuda.synchronize()
    shuffle_s = time.perf_counter() - t0
    perm = np.random.RandomState(3).permutation(SPLIT_M)
    check(np.array_equal(xs.collect(), x_host[perm])
          and np.array_equal(ys.collect().ravel(), perm.astype(np.float32)),
          "shuffle differs from NumPy's x[RandomState(3).permutation(m)]")
    del xs, ys
    t0 = time.perf_counter()
    tr, te, ytr, yte = dst.train_test_split(X, Y, random_state=4)
    torch.cuda.synchronize()
    split_s = time.perf_counter() - t0
    perm = np.random.RandomState(4).permutation(SPLIT_M)
    n_test = int(round(SPLIT_M * 0.25))
    n_train = SPLIT_M - n_test
    check(np.array_equal(tr.collect(), x_host[perm[:n_train]])
          and np.array_equal(te.collect(), x_host[perm[n_train:]])
          and np.array_equal(yte.collect().ravel(),
                             perm[n_train:].astype(np.float32)),
          "train_test_split differs from NumPy's permuted rows")
    emit({"phase": "split", "shape": [SPLIT_M, SPLIT_N],
          "shuffle_x_and_y_s": shuffle_s, "train_test_split_s": split_s,
          "train_rows": n_train, "test_rows": n_test,
          "bit_equal_to_numpy_permutation": True})
    return entries


def io_phase(dev, tmp, init):
    """The ingest: bench.py's KMeans data written as .npy, loaded with
    ``load_npy_file`` and fitted with the main KMeans phase's model
    (centers bit-equal to the in-memory fit's); 100,000 of its rows as
    comma-separated text (full width, rows cut for the run's time limit)
    through ``load_txt_file`` and the native parser (within rtol 2e-7 of
    NumPy's parse, equal to the float32 values written); a synthetic
    peptide-sized .mdcrd (10,000 frames x 300 atoms); a small svmlight file
    (dense); a planted NaN row, which the quarantine isolates.  Writing the
    files is set-up, not timed.  Returns the loaded KMeans ds-array."""
    import numpy as np
    import torch
    import dislib_tpu_torch as dst
    from dislib_tpu_torch import native
    rng = np.random.RandomState(0)
    x_host = rng.rand(KM_M, KM_N).astype(np.float32)
    res = {}

    def timed(what, nbytes, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res[what] = {"wall_s": wall, "file_mb": nbytes / 1e6,
                     "mb_per_s": nbytes / 1e6 / wall}
        return out

    npy = os.path.join(tmp, "kmeans.npy")
    np.save(npy, x_host)
    X = timed("load_npy_file", os.path.getsize(npy),
              lambda: dst.load_npy_file(npy))
    check(X.device == dev and X.shape == (KM_M, KM_N)
          and X.quarantine_ is None and torch.equal(
              X._data, torch.from_numpy(x_host).to(dev)),
          "load_npy_file: the loaded array differs from the data written")
    km = dst.KMeans(n_clusters=KM_K, init=init, max_iter=500,
                    tol=0.0).fit(X)
    main = MODELS["KMeans"][0]
    check(np.array_equal(km.centers_, main.centers_)
          and km.n_iter_ == main.n_iter_,
          "KMeans on the loaded .npy differs from the in-memory fit")
    # text: full width, TXT_M rows, 9 significant digits (a float32 round
    # trip)
    txt = os.path.join(tmp, "kmeans.csv")
    np.savetxt(txt, x_host[:TXT_M], fmt="%.9g", delimiter=",")
    # the parser's g++ build is set-up too
    t0 = time.perf_counter()
    native.get_lib()
    build_s = time.perf_counter() - t0
    before = native.PARSES["parse_text"]
    T = timed("load_txt_file", os.path.getsize(txt),
              lambda: dst.load_txt_file(txt))
    check(native.build_error() is None and native.get_lib() is not None,
          f"the native parser did not build: {native.build_error()}")
    check(native.PARSES["parse_text"] == before + 1,
          "load_txt_file did not go through the native parser")
    got = T.collect()
    check(np.array_equal(got, x_host[:TXT_M]),
          "load_txt_file: not the float32 values written")
    with open(txt) as f:
        first = [next(f) for _ in range(TXT_YARDSTICK)]
    nbytes = sum(len(ln) for ln in first)
    t0 = time.perf_counter()
    ref = np.loadtxt(first, delimiter=",", dtype=np.float32, ndmin=2)
    np_s = time.perf_counter() - t0
    res["numpy_loadtxt_yardstick"] = {
        "rows": TXT_YARDSTICK, "wall_s": np_s, "file_mb": nbytes / 1e6,
        "mb_per_s": nbytes / 1e6 / np_s}
    np.testing.assert_allclose(got[:TXT_YARDSTICK], ref, rtol=2e-7)
    del T, got, ref, first
    # mdcrd: 10 values of 8 characters a line, 90 lines a frame
    frames = np.random.RandomState(3).uniform(
        -99, 99, (MD_FRAMES, MD_ATOMS * 3))
    md = os.path.join(tmp, "peptide.mdcrd")
    with open(md, "w") as f:
        f.write("synthetic peptide trajectory\n")
        np.savetxt(f, frames.reshape(-1, 10), fmt="%8.3f", delimiter="")
    before = native.PARSES["parse_mdcrd"]
    M = timed("load_mdcrd_file", os.path.getsize(md),
              lambda: dst.load_mdcrd_file(md, n_atoms=MD_ATOMS))
    check(native.PARSES["parse_mdcrd"] == before + 1 and M.shape == (
        MD_FRAMES, MD_ATOMS * 3) and np.allclose(M.collect(), frames,
                                                 atol=5.1e-4),
          "load_mdcrd_file: wrong trajectory or not the native parser")
    del M, frames
    # svmlight, dense: 1000 rows, 20 features, a third of them set
    srng = np.random.RandomState(4)
    dense = np.where(srng.rand(1000, 20) < 1 / 3,
                     srng.standard_normal((1000, 20)), 0).astype(np.float32)
    labels = srng.randint(0, 3, 1000)
    svm = os.path.join(tmp, "small.svm")
    with open(svm, "w") as f:
        for lab, row in zip(labels, dense):
            nz = np.nonzero(row)[0]
            f.write(f"{lab} " + " ".join(f"{j + 1}:{row[j]:.9g}" for j in nz)
                    + "\n")
    before = native.PARSES["parse_svmlight"]
    sx, sy = timed("load_svmlight_file", os.path.getsize(svm),
                   lambda: dst.load_svmlight_file(svm, n_features=20,
                                                  store_sparse=False))
    check(native.PARSES["parse_svmlight"] == before + 1
          and np.array_equal(sx.collect(), dense)
          and np.array_equal(sy.collect().ravel(), labels.astype(np.float32)),
          "load_svmlight_file: wrong rows or not the native parser")
    # the quarantine: one NaN row planted in 1,000 rows of text
    dirty = x_host[:1000].copy()
    dirty[NAN_ROW, 3] = np.nan
    dpath = os.path.join(tmp, "dirty.csv")
    np.savetxt(dpath, dirty, fmt="%.9g", delimiter=",")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        D = dst.load_txt_file(dpath)
    rep = D.quarantine_
    check(rep is not None and rep.rows.tolist() == [NAN_ROW]
          and D.shape == (999, KM_N) and np.array_equal(
              D.collect(), dirty[rep.keep_mask]) and len(caught) == 1
          and bool(torch.isfinite(D._data).all()),
          "the quarantine did not isolate the planted NaN row")
    emit({"phase": "io", "loaders": res, "native_parser_ran": True,
          "native_build_error": native.build_error(),
          "native_build_s": build_s,
          "native_parses": dict(native.PARSES),
          "text_rows": TXT_M, "text_reduced": f"{TXT_M} of {KM_M} rows, "
          "full width (the run's time limit)",
          "text_equals_written_float32": True,
          "text_vs_numpy_rtol": 2e-7,
          "mdcrd_frames_atoms": [MD_FRAMES, MD_ATOMS],
          "svmlight_shape": list(dense.shape),
          "quarantined_rows": rep.rows.tolist(),
          "kmeans_on_loaded_npy_bit_equal": True})
    return X


def saving_phase(dev, tmp):
    """Every model fitted by the earlier phases saved in json, cbor and
    npz, loaded onto the card: predict / transform / kneighbors bit-equal
    to the original's on 10,000 fresh rows of its width."""
    import numpy as np
    import torch
    import dislib_tpu_torch as dst
    from dislib_tpu_torch.utils import profiling as prof

    def outputs(name, est, q):
        if name == "NearestNeighbors":
            return list(est.kneighbors(q))
        if name in ("PCA", "StandardScaler", "MinMaxScaler"):
            return [est.transform(q)]
        out = [est.predict(q)]
        if name == "RandomForestClassifier":
            out.append(est.predict_proba(q))
        return out

    rows, res = {}, {}
    for name, (est, n) in sorted(MODELS.items()):
        q = rows.setdefault(n, dst.array(np.random.RandomState(n).rand(
            SAVE_Q, n).astype(np.float32)))
        want = outputs(name, est, q)
        res[name] = {}
        for fmt in ("json", "cbor", "npz"):
            path = os.path.join(tmp, f"{name}.{fmt}")
            prof.reset_host_reads()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dst.save_model(est, path, save_format=fmt)
            save_s = time.perf_counter() - t0
            reads = dict(prof.HOST_READS)
            t0 = time.perf_counter()
            back = dst.load_model(path, device=dev)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            got = outputs(name, back, q)
            check(type(back) is type(est) and all(
                g.device == dev and torch.equal(g._data, w._data)
                for g, w in zip(got, want)),
                  f"saving: {name} loaded from {fmt} does not predict "
                  "bit-equal on the card")
            res[name][fmt] = {"file_mb": os.path.getsize(path) / 1e6,
                              "save_s": save_s, "load_s": load_s,
                              "save_host_reads": reads}
            os.remove(path)
            del back, got
        del want
    largest = max(res, key=lambda k: res[k]["json"]["file_mb"])
    emit({"phase": "saving", "models": sorted(res), "bit_equal_on_card": True,
          "largest_state": largest, "largest": res[largest], "all": res})
    MODELS.clear()
    torch.cuda.empty_cache()


def kmeans_fast_phase(dev, X, init, f32, cuda_ms):
    """KMeans(fast_distance=True) on the KMeans data, k = 10, tol = 0, 10
    and 500 iterations, timed in turns with the float32 path.  Gates: the
    first iteration's distances within 1e-5·(‖x‖² + ‖c‖²) of float64
    NumPy on the bf16-rounded operands with float32 norms; the kernel's
    labels equal that oracle's on every row whose two smallest oracle
    distances are more than twice that tolerance apart; labels equal to the
    float32 path's on at least 99 % of rows (rows within the bf16 rounding
    of a tie flip, about 0.5 % of this uniform data; the share is
    printed).  Returns the kernel
    entry of the bf16-operand distances_sq.  ``f32`` is the main KMeans
    phase's fitted model."""
    import numpy as np
    import torch
    import dislib_tpu_torch as dst
    from dislib_tpu_torch.ops import kernels as K

    def fit(fast, iters):
        return dst.KMeans(n_clusters=KM_K, init=init, max_iter=iters,
                          tol=0.0, fast_distance=fast).fit(X)

    fit(True, 2)                                          # warm
    torch.cuda.synchronize()
    K.reset_launches()
    fast = fit(True, 500)
    launches = dict(K.LAUNCHES)
    check(launches["distances_sq"] == 500 and fast.n_iter_ == 500,
          f"kmeans_fast: {launches['distances_sq']} distances_sq launches "
          "in 500 iterations")
    walls = {"float32": [], "fast": []}
    for kind in ("float32", "fast", "fast", "float32"):
        for iters in (10, 500):
            t0 = time.perf_counter()
            fit(kind == "fast", iters)
            walls[kind].append((iters, time.perf_counter() - t0))
    rate = {k: {f"iter_per_s_{i}": [i / t for it, t in v if it == i]
                for i in (10, 500)} for k, v in walls.items()}
    # the first iteration's distances against float64 on the rounded
    # operands
    xd = X._data
    cd = torch.from_numpy(init).to(dev)
    x16, x_sq = K.bf16_rows(xd), torch.sum(xd * xd, dim=1)
    got = K.distances_sq_bf16(x16, x_sq, cd)
    xr = x16[:, :KM_N].double().cpu().numpy()
    cr = cd.to(torch.bfloat16).double().cpu().numpy()
    xs = x_sq.double().cpu().numpy()
    cs = (init.astype(np.float32) ** 2).sum(1, dtype=np.float32).astype(
        np.float64)
    want = np.maximum(xs[:, None] - 2.0 * xr @ cr.T + cs[None], 0.0)
    err = np.abs(got.double().cpu().numpy() - want) / (xs[:, None]
                                                       + cs[None])
    worst = float(err.max())
    check(worst <= 1e-5, f"kmeans_fast: first-iteration distances off the "
          f"float64 oracle by {worst} of ‖x‖² + ‖c‖²")
    lab = got.argmin(1).cpu().numpy()
    two = np.partition(want, 1, axis=1)[:, :2]
    clear = two[:, 1] - two[:, 0] > 2e-5 * (xs + cs.max())
    check(np.array_equal(lab[clear], want.argmin(1)[clear]),
          "kmeans_fast: the kernel's labels differ from the float64 oracle's "
          "on rows clear of a tie")
    d32 = K.distances_sq(xd, cd)
    agree_first = float((got.argmin(1) == d32.argmin(1)).double().mean())
    # the fitted models (both predict in float32) after 500 iterations:
    # the two trajectories part on unstructured data, so reported only
    agree_final = float((fast.predict(X)._data == f32.predict(X)._data)
                        .double().mean())
    check(agree_first >= 0.99, f"kmeans_fast: first E-step labels agree "
          f"with the float32 path's on only {agree_first} of rows")
    plain = K.distances_sq_bf16_plain(x16, x_sq, cd)
    max_abs = float((got - plain).abs().max())
    scale = float((xd.double() ** 2).sum(1).max() + (cd.double() ** 2)
                  .sum(1).max())
    check(float((got.double() - plain.double()).abs().max()) / scale <= 1e-5,
          "kmeans_fast: the bf16 kernel disagrees with its plain version")
    del want, err, xr, plain, d32
    c16 = torch.nn.functional.pad(cd.to(torch.bfloat16),
                                  (0, x16.shape[1] - KM_N))
    m, k, d = KM_M, KM_K, KM_N
    bound_ms, bound_by = dist_bound(m, k, d,
                                    2.0 * m * d + 4.0 * (m + k * d + m * k),
                                    bf16=True)
    entry = {
        "name": "distances_sq", "at": "kmeans_fast (bf16 operands)",
        "route": "cuda", "source": "dislib_tpu_torch/csrc/distances_sq.cu",
        "entry": "dslib_distances_sq_bf16",
        "replaces": "dislib_tpu/ops/pallas_kernels.py:112",
        "shape": [m, k, d], "stored_row_values": int(x16.shape[1]),
        "launches": launches["distances_sq"], "max_abs_err": max_abs,
        "ms": cuda_ms(lambda: K.distances_sq_bf16(x16, x_sq, cd), 20),
        "plain_ms": cuda_ms(lambda: K.distances_sq_bf16_plain(x16, x_sq,
                                                              cd), 5),
        "float32_kernel_ms": cuda_ms(lambda: K.distances_sq(xd, cd), 20),
        "library_ms": None,
        "library_call": "none: no single PyTorch call computes this "
                        "function; cross_term_mm_ms is the cross term "
                        "alone, torch.mm(bf16 x, bf16 c^T, "
                        "out_dtype=float32)",
        "cross_term_mm_ms": cuda_ms(lambda: torch.mm(
            x16, c16.T, out_dtype=torch.float32), 20),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_basis": DIST_BOUND_BASIS + "; 2·m·d bytes of bf16 x "
                       "(unpadded), 4·m of norms, 4·m·k of distances out"}
    emit({"phase": "kmeans_fast", "shape": [KM_M, KM_N], "k": KM_K,
          "tol": 0.0, "fast_vs_float32_in_turns": rate, "walls_s": walls,
          "first_iter_err_vs_f64_rounded": worst,
          "oracle_clear_rows": int(clear.sum()),
          "labels_agree_first_estep": agree_first,
          "labels_agree_fitted": agree_final,
          "inertia_fast": fast.inertia_, "inertia_float32": f32.inertia_,
          "launches": launches, "kernel": entry})
    return entry


def numpy_dbscan(x, eps, min_samples, chunk=4096):
    """bench.py's ``_numpy_dbscan`` (its wall clock left out): the chunked
    ε-graph, connected components of the core-core graph, border points
    joined to their first core neighbour, labels renumbered compactly."""
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components
    m = x.shape[0]
    eps2 = eps * eps
    xsq = (x * x).sum(1)
    pr, pc = [], []
    for s in range(0, m, chunk):
        d = xsq[s:s + chunk, None] - 2.0 * (x[s:s + chunk] @ x.T) + xsq[None]
        r, c = np.nonzero(d <= eps2)
        pr.append(r + s)
        pc.append(c)
    pr = np.concatenate(pr)
    pc = np.concatenate(pc)
    counts = np.bincount(pr, minlength=m)
    core = counts >= min_samples
    to_core = core[pc]
    rows = pr[to_core & core[pr]]
    cols = pc[to_core & core[pr]]
    border_to = np.full(m, -1, np.int64)
    bsel = to_core & ~core[pr]
    border_to[pr[bsel][::-1]] = pc[bsel][::-1]
    g = sp.csr_matrix((np.ones(len(rows), np.int8), (rows, cols)),
                      shape=(m, m))
    _, comp = connected_components(g, directed=False)
    labels = np.full(m, -1, np.int64)
    labels[core] = comp[core]
    join = (~core) & (border_to >= 0)
    labels[join] = comp[border_to[join]]
    _, inv = np.unique(labels[labels >= 0], return_inverse=True)
    labels[labels >= 0] = inv
    return labels


def same_partition_on_core(lab_a, lab_b, core_mask):
    """bench.py's ``_same_partition_on_core``: the two labelings induce
    the same partition of the core points."""
    a, b = lab_a[core_mask], lab_b[core_mask]
    if (a < 0).any() or (b < 0).any():
        return False
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(p[0] for p in pairs)) == \
        len(set(p[1] for p in pairs))


def numpy_daura(x, cutoff, chunk=2048):
    """bench.py's ``_numpy_daura``: the greedy GROMOS loop on a dense
    RMSD adjacency."""
    import numpy as np
    m = x.shape[0]
    eps2 = cutoff * cutoff * (x.shape[1] // 3)
    xsq = (x * x).sum(1)
    adj = np.zeros((m, m), bool)
    for s in range(0, m, chunk):
        d = xsq[s:s + chunk, None] - 2.0 * (x[s:s + chunk] @ x.T) + xsq[None]
        adj[s:s + chunk] = d <= eps2
    active = np.ones(m, bool)
    labels = np.full(m, -1, np.int64)
    cid = 0
    while active.any():
        counts = (adj & active[None, :]).sum(1)
        counts[~active] = -1
        medoid = int(np.argmax(counts))
        members = active & adj[medoid]
        members[medoid] = True
        labels[members] = cid
        active &= ~members
        cid += 1
    return labels


def eps_entries(K, tag, xc, x_raw, cuda_ms, launches):
    """The kernels-line entry of ``distances_sq`` at an ε-pass block, a
    column chunk of all rows (``xc``, columns padded to a multiple of 4)
    against a row tile: the stream's time, with the slices' time on the
    unpadded rows (``x_raw``) beside it."""
    import torch
    from dislib_tpu_torch.ops import tiled
    tile = min(tiled.TILE, xc.shape[0])
    e = dist_entry(K, tag, xc, xc[:tile], cuda_ms, 10)
    a10, b10 = x_raw, x_raw[:tile].contiguous()
    n_sms = torch.cuda.get_device_properties(a10.device).multi_processor_count
    e["unpadded_plan"] = K.dist_plan(a10.shape[0], a10.shape[1],
                                     a10.data_ptr(), n_sms)._asdict()
    e["unpadded_ms"] = cuda_ms(lambda: K.distances_sq(a10, b10), 10)
    e["launches"] = launches
    return e


def dbscan_phase(dev, cuda_ms):
    """DBSCAN at bench.py's sizes: the tiled tier at 20,000 x 10 and the
    dense tier at 16,000 x 10 against the NumPy proxy, the ring tier
    equal to the tiled one, then timed at 200,000 x 10."""
    import numpy as np
    import torch
    import dislib_tpu_torch as dst
    from dislib_tpu_torch.cluster import DBSCAN
    from dislib_tpu_torch.cluster import dbscan as db_mod
    from dislib_tpu_torch.ops import kernels as K
    from dislib_tpu_torch.ops import tiled
    from dislib_tpu_torch.utils import profiling as prof
    eps, ms = DB_EPS, DB_MIN

    def fit(X):
        # the counts are set to 0 just before the fit and read just after
        K.reset_launches()
        prof.reset_host_reads()
        t0 = time.perf_counter()
        est = DBSCAN(eps=eps, min_samples=ms).fit(X)
        torch.cuda.synchronize()
        return est, time.perf_counter() - t0, K.LAUNCHES["distances_sq"], \
            prof.HOST_READS.get("dbscan", 0)

    def gate(x_host, est, what):
        lab = numpy_dbscan(x_host, eps, ms)
        core = np.zeros(len(x_host), bool)
        core[est.core_sample_indices_] = True
        check(same_partition_on_core(est.labels_, lab, core),
              f"dbscan {what}: the core partition differs from NumPy's")
        nd, npx = int((est.labels_ < 0).sum()), int((lab < 0).sum())
        check(abs(nd - npx) <= max(5, 0.01 * len(x_host)),
              f"dbscan {what}: noise {nd} vs NumPy's {npx}")
        return {"clusters": est.n_clusters_, "core": int(core.sum()),
                "noise": nd, "noise_numpy": npx}

    out = {}
    # the tiled tier (20,000 > _DENSE_MAX) and the ring tier, forced
    xg, _ = blobs(DB_GATE_M, DB_N, 16, seed=3)
    Xg = dst.array(xg)
    tl, t_tl, l_tl, r_tl = fit(Xg)
    per_pass = -(-DB_GATE_M // tiled.TILE)
    check(l_tl == per_pass * (r_tl + 2),
          f"dbscan tiled: {l_tl} distances_sq launches for {r_tl} rounds")
    out["tiled_gate"] = {"shape": [DB_GATE_M, DB_N], "fit_s": t_tl,
                         "rounds": r_tl, "launches": l_tl,
                         **gate(xg, tl, "tiled")}
    db_mod._RING = True
    try:
        rg, t_rg, l_rg, r_rg = fit(Xg)
    finally:
        db_mod._RING = None
    check(np.array_equal(rg.labels_, tl.labels_)
          and np.array_equal(rg.core_sample_indices_,
                             tl.core_sample_indices_),
          "dbscan: the ring tier differs from the tiled tier")
    out["ring_vs_tiled"] = {"equal": True, "fit_s": t_rg, "rounds": r_rg,
                            "launches": l_rg}
    # the dense tier
    xd, _ = blobs(DB_DENSE_M, DB_N, 16, seed=3)
    Xd = dst.array(xd)
    dn, t_dn, l_dn, r_dn = fit(Xd)
    check(l_dn == 1, f"dbscan dense: {l_dn} distances_sq launches")
    out["dense_gate"] = {"shape": [DB_DENSE_M, DB_N], "fit_s": t_dn,
                         "host_reads": r_dn, "launches": l_dn,
                         **gate(xd, dn, "dense")}
    xc16 = tiled.pad_cols(Xd._data)
    dense_entry = dist_entry(K, "dbscan dense", xc16, xc16, cuda_ms, 5)
    dense_entry["launches"] = l_dn
    del Xd, Xg, xc16
    torch.cuda.empty_cache()
    # timed at bench.py's 200,000 x 10 (the tiled tier)
    x, _ = blobs(DB_M, DB_N, 16, seed=4)
    X = dst.array(x)
    DBSCAN(eps=eps, min_samples=ms).fit(X)                   # warm
    est, t1, launches, rounds = fit(X)
    check(launches == -(-DB_M // tiled.TILE) * (rounds + 2),
          f"dbscan 200k: {launches} launches for {rounds} rounds")
    check(1 < est.n_clusters_ <= 64 and est.labels_.shape == (DB_M,),
          f"dbscan 200k: {est.n_clusters_} clusters")
    MESH_ONE[("dbscan", DB_M, DB_N)] = est
    walls = [t1] + [fit(X)[1] for _ in range(2)]
    wall_us, busy, spans = profile_device(
        lambda: DBSCAN(eps=eps, min_samples=ms).fit(X))
    out["timed"] = {"shape": [DB_M, DB_N], "wall_s_median_of_3":
                    float(np.median(walls)), "walls_s": walls,
                    "rounds": rounds,
                    "host_reads": {"dbscan": rounds, "results": 1},
                    "distances_sq_launches": launches,
                    "launches_per_pass": -(-DB_M // tiled.TILE),
                    "clusters": est.n_clusters_,
                    "noise": int((est.labels_ < 0).sum()),
                    "core": int(len(est.core_sample_indices_)),
                    "profiled": {"wall_ms": wall_us / 1e3,
                                 "device_busy_ms": busy / 1e3,
                                 "device_idle_share": 1.0 - busy / wall_us,
                                 "kernels_ms": top_kernels(spans)}}
    emit({"phase": "dbscan", "eps": eps, "min_samples": ms, **out})
    xc = tiled.pad_cols(X._data)
    entries = {"distances_sq/dbscan_eps_block": eps_entries(
        K, "dbscan eps-block", xc, X._data, cuda_ms, launches),
        "distances_sq/dbscan_dense": dense_entry}
    return entries


def daura_phase(dev, cuda_ms):
    """Daura at bench.py's sizes: the tiled tier at 20,000 x 15 against
    the NumPy greedy proxy, then timed at 50,000 x 15."""
    import numpy as np
    import torch
    import dislib_tpu_torch as dst
    from dislib_tpu_torch.cluster import Daura
    from dislib_tpu_torch.ops import kernels as K
    from dislib_tpu_torch.ops import tiled
    from dislib_tpu_torch.utils import profiling as prof

    split = {}

    def fit(X):
        K.reset_launches()
        prof.reset_host_reads()
        t0 = time.perf_counter()
        with daura_launches(K) as got:
            est = Daura(cutoff=DA_CUT).fit(X)
        torch.cuda.synchronize()
        split.update(got)
        return est, time.perf_counter() - t0, K.LAUNCHES["distances_sq"], \
            prof.HOST_READS.get("daura", 0)

    xg, _ = blobs(DA_GATE_M, DA_N, 12, seed=6, std=0.05)
    gate_est, t_g, l_g, r_g = fit(dst.array(xg))
    n_cl = len(gate_est.clusters_)
    check(gate_est.labels_.min() >= 0, "daura: an unlabelled frame")
    check(same_partition_on_core(gate_est.labels_, numpy_daura(xg, DA_CUT),
                                 np.ones(DA_GATE_M, bool)),
          "daura: the partition differs from the NumPy greedy proxy")
    check(r_g == n_cl and l_g == n_cl * (-(-DA_GATE_M // tiled.TILE) + 1),
          f"daura gate: {l_g} launches, {r_g} reads for {n_cl} clusters")
    x, _ = blobs(DA_M, DA_N, 12, seed=7, std=0.05)
    X = dst.array(x)
    Daura(cutoff=DA_CUT).fit(X)                              # warm
    est, t1, launches, reads = fit(X)
    by_block = dict(split)
    check(sum(by_block.values()) == launches,
          f"daura 50k: launches by block {by_block} do not add up to "
          f"{launches}")
    n_clusters = len(est.clusters_)
    check(1 < n_clusters < DA_M // 10,
          f"daura 50k: {n_clusters} clusters")
    check(all(est.labels_[c[0]] == i for i, c in enumerate(est.clusters_)),
          "daura 50k: a medoid outside its cluster")
    MESH_ONE[("daura", DA_M, DA_N)] = est
    walls = [t1] + [fit(X)[1] for _ in range(2)]
    emit({"phase": "daura", "cutoff": DA_CUT,
          "gate": {"shape": [DA_GATE_M, DA_N], "clusters": n_cl,
                   "fit_s": t_g, "host_reads": r_g, "launches": l_g,
                   "same_partition_as_numpy": True},
          "timed": {"shape": [DA_M, DA_N], "wall_s_median_of_3":
                    float(np.median(walls)), "walls_s": walls,
                    "clusters": n_clusters, "host_reads": reads,
                    "distances_sq_launches": launches,
                    "distances_sq_launches_by_block": by_block}})
    xc = tiled.pad_cols(X._data)
    block = eps_entries(K, "daura eps-block", xc, X._data, cuda_ms,
                        by_block["eps"])
    col = dist_entry(K, "daura medoid column", xc, xc[:1].contiguous(),
                     cuda_ms, 20)
    col["launches"] = by_block["col"]
    return {"distances_sq/daura_eps_block": block,
            "distances_sq/daura_medoid": col}


def svmlight_draw(m, n, per_row, seed):
    """``m`` seeded rows with ``per_row`` distinct columns each (one drawn
    in each band of n / per_row columns) and values that are multiples of
    1/8, exact in float32 and in text: (cols, vals, labels) as NumPy
    (m, per_row) and (m,) arrays."""
    import numpy as np
    rng = np.random.RandomState(seed)
    band = n // per_row
    cols = np.arange(per_row) * band + rng.randint(0, band, (m, per_row))
    vals = rng.randint(1, 1000, (m, per_row)) / 8.0
    return cols, vals, rng.randint(0, 2, m)


def draw_csr(cols, vals, n):
    import numpy as np
    import scipy.sparse as sp
    m, per_row = cols.shape
    return sp.csr_matrix((vals.ravel().astype(np.float32),
                          (np.repeat(np.arange(m), per_row), cols.ravel())),
                         shape=(m, n))


def write_svmlight(path, m, n, per_row, seed):
    """A seeded svmlight file of :func:`svmlight_draw`'s rows.  Returns
    the CSR the file holds and its labels."""
    import numpy as np
    cols, vals, labels = svmlight_draw(m, n, per_row, seed)
    table = np.empty((m, 1 + 2 * per_row))
    table[:, 0] = labels
    table[:, 1::2] = cols + 1                       # svmlight is 1-based
    table[:, 2::2] = vals
    np.savetxt(path, table, fmt="%d" + " %d:%.6g" * per_row)
    return draw_csr(cols, vals, n), labels.astype(np.float32)


def sparse_phase(dev, tmp):
    """The sparse ds-array: svmlight ingest at bench_als_sparse's shape,
    SpMM at bench_sparse's, sparse KMeans on the loaded array."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    import dislib_tpu_torch as dst
    from dislib_tpu_torch.cluster import KMeans
    from dislib_tpu_torch.cluster import kmeans as km_mod
    from dislib_tpu_torch.ops import precision as px
    from dislib_tpu_torch.ops.spmm import spmm

    # -- ingest --------------------------------------------------------------
    path = os.path.join(tmp, "sparse.svm")
    t0 = time.perf_counter()
    want, y_want = write_svmlight(path, SV_M, SV_N, SV_NNZ, seed=8)
    write_s = time.perf_counter() - t0
    mb = os.path.getsize(path) / 1e6
    t0 = time.perf_counter()
    x, y = dst.load_svmlight_file(path, n_features=SV_N)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check(isinstance(x, dst.SparseArray) and x.shape == (SV_M, SV_N)
          and x.nnz == want.nnz and x.device == dev,
          f"svmlight: {type(x).__name__} {x.shape} nnz {x.nnz}")
    coo = want.tocoo()
    check(np.array_equal(x._rows.cpu().numpy(), coo.row)
          and np.array_equal(x._cols.cpu().numpy(), coo.col)
          and np.array_equal(x._vals.cpu().numpy(), coo.data)
          and np.array_equal(y.collect().ravel(), y_want),
          "svmlight: the loaded entries differ from the file's")
    emit({"phase": "sparse_ingest", "shape": [SV_M, SV_N], "nnz": x.nnz,
          "file_mb": mb, "write_s": write_s, "load_s": load_s,
          "mb_per_s": mb / load_s, "store_sparse": True})

    # -- spmm ------------------------------------------------------------------
    mat = sp.random(SPMM_M, SPMM_K, density=SPMM_DENSITY, random_state=0,
                    dtype=np.float32).tocsr()
    b = np.random.RandomState(0).rand(SPMM_K, SPMM_N).astype(np.float32)
    xs, B = dst.SparseArray.from_scipy(mat), dst.array(b)
    want64 = mat.astype(np.float64) @ b.astype(np.float64)
    scale = np.linalg.norm(mat.data) * np.linalg.norm(b) / np.sqrt(SPMM_K)
    errs, spmm_ms = {}, {}
    for pol in ("float32", "bfloat16"):
        c1 = spmm(xs, B, precision=pol)._data
        c2 = spmm(xs, B, precision=pol)._data
        check(torch.equal(c1, c2), f"spmm {pol}: two calls differ")
        errs[pol] = float(np.abs(c1.cpu().numpy() - want64).max() / scale)
        check(errs[pol] <= px.ERROR_BOUNDS[("matmul", pol)],
              f"spmm {pol}: normalized error {errs[pol]} > ERROR_BOUNDS")
        spmm_ms[pol] = med_s(lambda: spmm(xs, B, precision=pol), 7) * 1e3
    dens = dst.matmul(xs, B, algorithm="densify")._data
    c1 = spmm(xs, B)._data
    dens_err = float((dens - c1).abs().max().item() / scale)
    check(dens_err <= px.ERROR_BOUNDS[("matmul", "float32")],
          f"spmm vs the densify route: {dens_err}")
    auto = dst.matmul(xs, B)._data
    check(torch.equal(auto, c1), "matmul auto did not take spmm at 1 %")
    densify_ms = med_s(lambda: dst.matmul(xs, B, algorithm="densify"),
                       7) * 1e3
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # CSR tensors are "beta"
        ts = torch.sparse_csr_tensor(
            torch.from_numpy(mat.indptr).to(dev), torch.from_numpy(
                mat.indices).to(dev), torch.from_numpy(mat.data).to(dev),
            size=mat.shape)
    with px.precise(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref_lib = torch.sparse.mm(ts, B._data)
        lib_ms = med_s(lambda: torch.sparse.mm(ts, B._data), 7) * 1e3
    lib_err = float((ref_lib - c1).abs().max().item() / scale)
    emit({"phase": "spmm", "shape": [SPMM_M, SPMM_K, SPMM_N],
          "density": SPMM_DENSITY, "nnz": int(mat.nnz),
          "normalized_err_vs_f64": errs, "vs_densify": dens_err,
          "two_calls_bit_identical": True, "spmm_ms": spmm_ms,
          "densify_ms": densify_ms, "torch_sparse_mm_ms": lib_ms,
          "torch_sparse_mm_vs_spmm": lib_err,
          "bound_ms": 1e3 * (4.0 * (2 * mat.nnz + SPMM_M + 1
                                    + SPMM_K * SPMM_N + SPMM_M * SPMM_N)
                             / PEAK_BYTES)})
    del xs, B, dens, c1, auto, ts, ref_lib
    torch.cuda.empty_cache()

    # -- sparse KMeans on the loaded array --------------------------------------
    c0 = KMeans(n_clusters=SKM_K, random_state=0)._init_centers(x)
    d = km_mod._sparse_distances(x, c0)
    lab = torch.argmin(d, dim=1).cpu().numpy()
    del d
    x64 = want.astype(np.float64)
    c064 = c0.cpu().numpy().astype(np.float64)
    d64 = (np.asarray(x64.multiply(x64).sum(1)) - 2.0 * (x64 @ c064.T)
           + (c064 ** 2).sum(1)[None, :])
    part = np.sort(d64, axis=1)
    clear = part[:, 1] - part[:, 0] > 1e-4 * np.abs(part[:, 0]).max()
    check(np.array_equal(lab[clear], d64.argmin(1)[clear]),
          "sparse kmeans: first E-step labels differ from float64 NumPy")
    one = KMeans(n_clusters=SKM_K, init=c0.cpu().numpy(), max_iter=1,
                 tol=0.0).fit(x)
    onehot = sp.csr_matrix((np.ones(SV_M), (lab, np.arange(SV_M))),
                           shape=(SKM_K, SV_M))
    counts = np.asarray(onehot.sum(1)).ravel()
    sums = np.asarray((onehot @ x64).todense())
    step64 = np.where(counts[:, None] > 0,
                      sums / np.maximum(counts, 1)[:, None], c064)
    check(np.allclose(one.centers_, step64, rtol=1e-4,
                      atol=1e-5 * np.abs(step64).max()),
          "sparse kmeans: the first Lloyd step differs from float64 NumPy")

    def fit():
        t0 = time.perf_counter()
        km = KMeans(n_clusters=SKM_K, init=c0.cpu().numpy(),
                    max_iter=SKM_ITERS, tol=0.0).fit(x)
        torch.cuda.synchronize()
        return km, time.perf_counter() - t0

    fit()                                                       # warm
    (k1, t1), (k2, t2) = fit(), fit()
    check(np.array_equal(k1.centers_, k2.centers_)
          and k1.inertia_ == k2.inertia_ and k1.n_iter_ == k2.n_iter_
          == SKM_ITERS, "sparse kmeans: two fits differ")
    emit({"phase": "sparse_kmeans", "shape": [SV_M, SV_N], "nnz": x.nnz,
          "k": SKM_K, "iters": SKM_ITERS, "first_step_rows_clear":
          int(clear.sum()), "fit_s": [t1, t2],
          "iter_per_s": SKM_ITERS / min(t1, t2),
          "two_fits_bit_identical": True, "inertia": k1.inertia_})
    return x, want, y


def phase_wall(name, t0):
    """A phase's wall time, on a line of its own."""
    emit({"phase": "phase_wall", "name": name,
          "seconds": time.perf_counter() - t0})


def numpy_csvm(x, y_pm, part, c, gamma, max_iter, arity=2):
    """The float64 NumPy cascade, modelled on bench.py's
    ``_numpy_csvm_fit``: the K+1 boxed dual by projected gradient ascent
    (Gershgorin step, at most 500 steps, stop at delta <= 1e-6), the
    support vectors merged up an arity tree and fed back each
    iteration.  Returns (support vector indices, their alphas)."""
    import numpy as np
    m = x.shape[0]

    def solve(idx):
        xs = x[idx]
        sq = (xs * xs).sum(1)
        d = np.maximum(sq[:, None] - 2.0 * (xs @ xs.T) + sq[None, :], 0.0)
        q = (np.exp(-gamma * d) + 1.0) * np.outer(y_pm[idx], y_pm[idx])
        eta = 1.0 / max(np.abs(q).sum(1).max(), 1e-12)
        a = np.zeros(len(idx))
        for _ in range(500):
            new = np.clip(a + eta * (1.0 - q @ a), 0.0, c)
            delta = np.abs(new - a).max()
            a = new
            if delta <= 1e-6:
                break
        return a

    sv = alpha = None
    for _ in range(max_iter):
        nodes = [np.arange(s, min(s + part, m)) for s in range(0, m, part)]
        if sv is not None and len(sv):
            nodes = [np.unique(np.r_[nd, sv]) for nd in nodes]
        while True:
            res = [solve(nd) for nd in nodes]
            if len(nodes) == 1:
                break
            merged = []
            for i in range(0, len(nodes), arity):
                grp = []
                for j in range(i, min(i + arity, len(nodes))):
                    grp.extend(nodes[j][res[j] > 1e-8].tolist())
                merged.append(np.unique(grp) if grp else nodes[i][:1])
            nodes = merged
        keep = res[0] > 1e-8
        sv, alpha = nodes[0][keep], res[0][keep]
    return sv, alpha


def csvm_phase(dev, cuda_ms):
    """CascadeSVM at bench_csvm's problem under both dual solvers, against
    a float64 NumPy cascade, two fits bit-identical; the batched
    ``distances_sq`` entry at level 0's shape and the 2-D entry at the
    decision block's.  Returns their kernels-line entries."""
    import numpy as np
    import torch
    import dislib_tpu_torch as dst
    from dislib_tpu_torch.classification import CascadeSVM
    from dislib_tpu_torch.ops import kernels as K
    from dislib_tpu_torch.ops import precision as px
    from dislib_tpu_torch.utils import profiling as prof
    t_phase = time.perf_counter()
    m, n = CSVM_M, CSVM_N
    x, y = csvm_data(m, n)
    gamma = 1.0 / n
    X = dst.array(x, block_size=(CSVM_PART, n))
    Y = dst.array(y[:, None], block_size=(CSVM_PART, 1))

    def oracle():
        t0 = time.perf_counter()
        x64 = x.astype(np.float64)
        sv64, a64 = numpy_csvm(x64, y.astype(np.float64), CSVM_PART, 1.0,
                               gamma, CSVM_ITERS)
        sq = (x64 * x64).sum(1)
        k64 = np.exp(-gamma * np.maximum(
            sq[:, None] - 2.0 * x64 @ x64[sv64].T + sq[sv64][None],
            0.0)) + 1.0
        return (np.where(k64 @ (a64 * y[sv64]) > 0, 1.0, -1.0), len(sv64),
                time.perf_counter() - t0)

    # the NumPy cascade runs on the host while the card fits (its BLAS
    # calls release the GIL); its result is read before any gate
    pool = ThreadPoolExecutor(max_workers=1)
    pending = pool.submit(oracle)

    def fit():
        est = CascadeSVM(kernel="rbf", c=1.0, gamma=gamma,
                         max_iter=CSVM_ITERS, check_convergence=False)
        est.fit(X, Y)
        torch.cuda.synchronize()
        return est

    solvers, main, preds = {}, {}, {}
    old = os.environ.get("DSLIB_CSVM_SOLVER")
    try:
        # the card is warm from the earlier phases: no warm-up fit
        for solver in ("pg", "fista"):
            os.environ["DSLIB_CSVM_SOLVER"] = solver
            K.reset_launches()
            prof.reset_host_reads()
            t0 = time.perf_counter()
            est = fit()
            fit_s = time.perf_counter() - t0
            # the fit launches only the batched entry, the decision only
            # the 2-D one
            launches = {"fit": dict(K.LAUNCHES)}
            K.reset_launches()
            preds[solver] = est.predict(X).collect().ravel()
            launches["predict"] = dict(K.LAUNCHES)
            reads = dict(prof.HOST_READS)
            check(launches["fit"]["distances_sq"] >= 1
                  and launches["predict"]["distances_sq"] == 1,
                  f"csvm {solver}: launches {launches}")
            solvers[solver] = {
                "fit_s": fit_s, "n_sv": est.support_vectors_count_,
                "launches": launches, "host_reads": reads}
            if solver == "pg":
                main = {"est": est, "launches": launches}
        os.environ["DSLIB_CSVM_SOLVER"] = "pg"
        a, b = main["est"], fit()
        MESH_ONE[("csvm", m, n, CSVM_PART, CSVM_ITERS)] = a
        check(np.array_equal(a._sv_idx, b._sv_idx)
              and np.array_equal(a._sv_alpha, b._sv_alpha)
              and np.array_equal(a._sv_x, b._sv_x),
              "csvm: two fits differ")
    finally:
        if old is None:
            os.environ.pop("DSLIB_CSVM_SOLVER", None)
        else:
            os.environ["DSLIB_CSVM_SOLVER"] = old
        pred64, n_sv64, numpy_s = pending.result()
        pool.shutdown()
    for solver, pred in preds.items():
        acc = float(np.mean(pred == y))
        agree = float(np.mean(pred == pred64))
        check(acc > 0.95, f"csvm {solver}: train accuracy {acc}")
        check(agree >= 0.999, f"csvm {solver}: predictions agree with "
              f"the float64 NumPy cascade on {agree} of rows")
        solvers[solver].update(train_accuracy=acc,
                               agree_with_numpy_f64=agree)
    emit({"phase": "csvm", "shape": [m, n], "part": CSVM_PART,
          "max_iter": CSVM_ITERS, "gamma": gamma, "c": 1.0,
          "numpy_f64_s": numpy_s, "numpy_n_sv": int(n_sv64),
          "two_fits_bit_identical": True, **solvers})

    # the batched entry at level 0's shape: the nodes' gathered rows (the
    # last node padded with row 0, as the fit pads it)
    nodes = -(-m // CSVM_PART)
    idx = np.arange(nodes * CSVM_PART)
    idx[idx >= m] = 0
    ga = X._data[torch.as_tensor(idx, device=dev)].view(
        nodes, CSVM_PART, n).contiguous()
    out = K.distances_sq_batched(ga, ga)
    plain = K.distances_sq_batched_plain(ga, ga)
    scale = float(2.0 * (ga.double() ** 2).sum(2).max())
    err = float((out.double() - plain.double()).abs().max()) / scale
    check(err <= 1e-5, f"distances_sq_batched at level 0: error {err}")
    check(bool((out >= 0).all()), "distances_sq_batched: negative distance")
    max_abs = float((out - plain).abs().max())
    del out, plain

    def cdist():
        with px.precise():
            return torch.cdist(ga, ga,
                               compute_mode="use_mm_for_euclid_dist").square()

    mm, cap = nodes * CSVM_PART, CSVM_PART
    bound_ms, bound_by = dist_bound(cap, cap, n,
                                    4.0 * (2 * mm * n + mm * cap),
                                    batch=nodes)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gram = {"name": "distances_sq", "at": "csvm_gram (batched entry, level "
            "0)", "route": "cuda",
            "source": "dislib_tpu_torch/csrc/distances_sq.cu",
            "replaces": "dislib_tpu/ops/pallas_kernels.py:112",
            "entry": "dslib_distances_sq_f32_batched",
            "plan": K.dist_batched_plan(nodes, cap, n, ga.data_ptr(),
                                        n_sms)._asdict(),
            "shape": [nodes, cap, cap, n], "max_abs_err": max_abs,
            "normalized_err_vs_plain": err,
            "ms": cuda_ms(lambda: K.distances_sq_batched(ga, ga), 20),
            "plain_ms": cuda_ms(lambda: K.distances_sq_batched_plain(ga, ga),
                                20),
            "library_ms": cuda_ms(cdist, 20),
            "library_call": "torch.cdist(a, a, compute_mode="
                            "'use_mm_for_euclid_dist').square(), batched, "
                            "TF32 off",
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_basis": DIST_BOUND_BASIS,
            "launches": main["launches"]["fit"]["distances_sq"]}
    emit({"phase": "kernel", **gram})
    est = main["est"]
    sv = torch.as_tensor(est._sv_x, device=dev)
    dec = dist_entry(K, f"csvm_decision ({m} queries x "
                        f"{est.support_vectors_count_} SVs)",
                     X._data, sv, cuda_ms, 20)
    dec["launches"] = main["launches"]["predict"]["distances_sq"]
    emit({"phase": "kernel", **dec})
    del ga, sv, X, Y
    torch.cuda.empty_cache()
    phase_wall("csvm", t_phase)
    return {"distances_sq/csvm_gram": gram, "distances_sq/csvm_decision": dec}


def csvm_sparse_phase(dev):
    """CascadeSVM on a SparseArray through the ELL staging and through the
    host-CSR fallback, each equal to the fit on its ``to_dense()``."""
    import numpy as np
    import torch
    import dislib_tpu_torch as dst
    from dislib_tpu_torch.classification import CascadeSVM
    from dislib_tpu_torch.ops import kernels as K
    t_phase = time.perf_counter()
    cols, vals, _ = svmlight_draw(CSVM_SP_M, SV_N, SV_NNZ, seed=12)
    csr = draw_csr(cols, vals, SV_N)
    score = csr @ np.random.RandomState(13).randn(SV_N)
    y = (score > np.median(score)).astype(np.float32)[:, None]
    xs = dst.SparseArray.from_scipy(csr, block_size=(CSVM_PART, SV_N))
    xd = xs.to_dense()
    Y = dst.array(y)
    fits, walls, launches = {}, {}, {}
    old = os.environ.get("DSLIB_SPARSE_ELL_BUDGET")
    try:
        for name, x in (("dense", xd), ("ell", xs), ("csr", xs)):
            if name == "csr":
                os.environ["DSLIB_SPARSE_ELL_BUDGET"] = "1"
                check(xs.ell() is None, "csvm_sparse: ell() under a 1-byte "
                      "budget")
            else:
                check(name == "dense" or xs.ell() is not None,
                      "csvm_sparse: ell() refused at the default budget")
            K.reset_launches()
            t0 = time.perf_counter()
            fits[name] = CascadeSVM(max_iter=CSVM_SP_ITERS,
                                    check_convergence=False).fit(x, Y)
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            launches[name] = dict(K.LAUNCHES)
    finally:
        if old is None:
            os.environ.pop("DSLIB_SPARSE_ELL_BUDGET", None)
        else:
            os.environ["DSLIB_SPARSE_ELL_BUDGET"] = old
    d, e, c = fits["dense"], fits["ell"], fits["csr"]
    check(launches["ell"]["distances_sq"] >= 1
          and launches["csr"]["distances_sq"] == 0,
          f"csvm_sparse: launches {launches}")
    check(np.array_equal(e._sv_idx, d._sv_idx)
          and np.array_equal(e._sv_alpha, d._sv_alpha),
          "csvm_sparse: the ELL fit differs from the dense fit")
    alpha_err = float(np.abs(c._sv_alpha - d._sv_alpha).max()) \
        if np.array_equal(c._sv_idx, d._sv_idx) else float("inf")
    check(alpha_err <= 1e-4, "csvm_sparse: the host-CSR fit's support "
          f"vectors or alphas differ from the dense fit's ({alpha_err})")
    emit({"phase": "csvm_sparse", "shape": [CSVM_SP_M, SV_N],
          "nnz": int(csr.nnz), "max_iter": CSVM_SP_ITERS,
          "n_sv": d.support_vectors_count_, "fit_s": walls,
          "ell_equal_to_dense": True, "csr_alpha_max_abs_err": alpha_err,
          "launches": launches})
    del xs, xd, fits
    torch.cuda.empty_cache()
    phase_wall("csvm_sparse", t_phase)


def sparse_knn_phase(dev, x, want, y):
    """The sparse kNN on the loaded svmlight array: SKNN_Q of its rows as
    sparse and as dense queries against a float64 scipy oracle, and the
    kNN classifier's score."""
    import numpy as np
    import torch
    import dislib_tpu_torch as dst
    from dislib_tpu_torch.ops import kernels as K
    t_phase = time.perf_counter()
    rows = np.sort(np.random.RandomState(9).choice(x.shape[0], SKNN_Q,
                                                   replace=False))
    qs = x[rows, :]
    qd = qs.to_dense()
    # the oracle: float64 scipy distances, the k + 1 smallest of each row
    t0 = time.perf_counter()
    w64 = want.astype(np.float64)
    x_sq = np.asarray(w64.multiply(w64).sum(1)).ravel()
    q64 = w64[rows]
    d2_or = np.empty((SKNN_Q, SKNN_K + 1))
    i_or = np.empty((SKNN_Q, SKNN_K + 1), np.int64)
    for s in range(0, SKNN_Q, 250):
        qc = q64[s:s + 250]
        d2 = (x_sq[rows[s:s + 250]][:, None] + x_sq[None, :]
              - 2.0 * (qc @ w64.T).toarray())
        part = np.argpartition(d2, SKNN_K + 1, axis=1)[:, :SKNN_K + 1]
        pd = np.take_along_axis(d2, part, 1)
        order = np.argsort(pd, axis=1, kind="stable")
        d2_or[s:s + 250] = np.take_along_axis(pd, order, 1)
        i_or[s:s + 250] = np.take_along_axis(part, order, 1)
    oracle_s = time.perf_counter() - t0
    scale = float(x_sq.max())
    # a neighbour is held where its distance is clear of the next one's
    clear = np.diff(d2_or, axis=1) > 1e-5 * scale
    clear = np.minimum(clear[:, :-1], clear[:, 1:])
    clear = np.concatenate([np.diff(d2_or[:, :2], axis=1)
                            > 1e-5 * scale, clear], axis=1)
    nn = dst.NearestNeighbors(n_neighbors=SKNN_K).fit(x)
    res = {}
    for name, q in (("sparse_queries", qs), ("dense_queries", qd)):
        nn.kneighbors(q)                                          # warm
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        d_arr, i_arr = nn.kneighbors(q)
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        idx, dist = i_arr.collect(), d_arr.collect().astype(np.float64)
        check(np.array_equal(idx[clear], i_or[:, :SKNN_K][clear]),
              f"sparse knn {name}: indices differ from the float64 oracle "
              f"on {int((idx[clear] != i_or[:, :SKNN_K][clear]).sum())} "
              "clear neighbours")
        # squared distances within 1e-5 of 2 max |x|^2 (the magnitudes
        # that cancel in |q|^2 - 2 q.x + |x|^2: a query's own row comes
        # out near, not at, 0), and distances off 0 within rtol 1e-4
        d2_err = float(np.abs(dist ** 2 - d2_or[:, :SKNN_K]).max()
                       / (2.0 * scale))
        d_or = np.sqrt(np.maximum(d2_or[:, :SKNN_K], 0.0))
        far = d_or > 0
        rel = float((np.abs(dist - d_or)[far] / d_or[far]).max())
        check(d2_err <= 1e-5 and rel <= 1e-4,
              f"sparse knn {name}: squared distances off the oracle by "
              f"{d2_err} (normalized), distances by rtol {rel}")
        res[name] = {"seconds": t, "queries_per_s": SKNN_Q / t,
                     "launches": dict(K.LAUNCHES),
                     "d2_normalized_err_vs_f64": d2_err,
                     "d_rel_err_vs_f64": rel,
                     "clear_neighbours": int(clear.sum())}
    knn = dst.KNeighborsClassifier(n_neighbors=SKNN_K).fit(x, y)
    t0 = time.perf_counter()
    acc = knn.score(qs, y[rows, :])
    score_s = time.perf_counter() - t0
    # the classifier's votes against a NumPy vote over the neighbours the
    # stream returned (uniform weights, the lowest class on a tie)
    labels = y.collect().ravel()
    votes = labels[i_arr.collect()]
    want_pred = np.where((votes == 1).sum(1) > (votes == 0).sum(1), 1.0,
                         0.0)
    got_pred = knn.predict(qs).collect().ravel()
    check(np.array_equal(got_pred, want_pred), "sparse knn classifier: "
          "predictions differ from a vote over the neighbours")
    check(abs(acc - float(np.mean(want_pred == labels[rows]))) < 1e-12,
          f"sparse knn classifier: score {acc}")
    emit({"phase": "sparse_knn", "fit_shape": list(x.shape),
          "fit_nnz": x.nnz, "queries": SKNN_Q, "k": SKNN_K,
          "oracle_f64_s": oracle_s, "knn_classifier_score": acc,
          "knn_classifier_score_s": score_s, **res})
    phase_wall("sparse_knn", t_phase)


def sparse_inputs_phase(dev):
    """Sparse input to StandardScaler(with_mean=False), shuffle,
    LinearRegression and a forest, each against the same call on the
    densified array; MemoryError past the densify budget."""
    import numpy as np
    import torch
    import dislib_tpu_torch as dst
    from dislib_tpu_torch.ops import kernels as K
    t_phase = time.perf_counter()
    cols, vals, labels = svmlight_draw(SI_M, SI_N, SI_NNZ, seed=14)
    csr = draw_csr(cols, vals, SI_N)
    xs = dst.SparseArray.from_scipy(csr)
    xd = xs.to_dense()
    out = {}
    # the scaler: one-pass moments on the nonzeros against the dense
    # two-pass fit, within 1e-5 of E[x^2]
    t0 = time.perf_counter()
    s_sp = dst.StandardScaler(with_mean=False).fit(xs)
    s_de = dst.StandardScaler(with_mean=False).fit(xd)
    ex2 = xs.square().mean(axis=0).collect()
    err = float((np.abs(s_sp.var_.collect() - s_de.var_.collect())
                 / np.maximum(ex2, 1e-30)).max())
    check(err <= 1e-5 and np.allclose(s_sp.mean_.collect(),
                                      s_de.mean_.collect(), rtol=1e-5),
          f"sparse scaler: moments off the dense fit by {err}")
    t_sp = s_sp.transform(xs)
    check(isinstance(t_sp, dst.SparseArray) and t_sp.nnz == xs.nnz,
          "sparse scaler: transform did not stay sparse")
    t_err = float((t_sp.to_dense()._data - s_de.transform(xd)._data).abs()
                  .max() / xd._data.abs().max())
    check(t_err <= 1e-4, f"sparse scaler: transform off by {t_err}")
    out["scaler"] = {"seconds": time.perf_counter() - t0, "var_rel_err":
                     err, "transform_rel_err": t_err}
    # shuffle: the same rows as the dense shuffle, bit for bit
    t0 = time.perf_counter()
    sh_sp = dst.shuffle(xs, random_state=5)
    sh_de = dst.shuffle(xd, random_state=5)
    check(isinstance(sh_sp, dst.SparseArray)
          and torch.equal(sh_sp.to_dense()._data, sh_de._data),
          "sparse shuffle differs from the dense shuffle")
    out["shuffle"] = {"seconds": time.perf_counter() - t0}
    # the densify route: bit for bit the fit on the dense array
    beta = np.random.RandomState(15).randn(SI_N, 1)
    Yr = dst.array((csr @ beta).astype(np.float32))
    Yc = dst.array(labels.astype(np.float32)[:, None])
    t0 = time.perf_counter()
    lr_sp, lr_de = dst.LinearRegression().fit(xs, Yr), \
        dst.LinearRegression().fit(xd, Yr)
    check(np.array_equal(lr_sp.coef_, lr_de.coef_)
          and np.array_equal(lr_sp.intercept_, lr_de.intercept_),
          "sparse LinearRegression differs from the dense fit")
    out["linear_regression"] = {"seconds": time.perf_counter() - t0}
    K.reset_launches()
    t0 = time.perf_counter()
    rf_sp = dst.RandomForestClassifier(n_estimators=4, max_depth=8,
                                       random_state=0).fit(xs, Yc)
    launches = dict(K.LAUNCHES)
    rf_de = dst.RandomForestClassifier(n_estimators=4, max_depth=8,
                                       random_state=0).fit(xd, Yc)
    check(same_forest(rf_sp, rf_de), "sparse forest differs from the dense "
          "fit")
    check(launches["node_histogram"] == rf_sp._depth,
          f"sparse forest: node_histogram launches {launches}")
    out["forest"] = {"seconds": time.perf_counter() - t0,
                     "depth": rf_sp._depth, "launches": launches}
    old = os.environ.get("DSLIB_SPARSE_DENSIFY_BUDGET")
    os.environ["DSLIB_SPARSE_DENSIFY_BUDGET"] = str(2 * SI_M * SI_N)
    try:
        dst.LinearRegression().fit(dst.SparseArray.from_scipy(csr), Yr)
        raised = False
    except MemoryError:
        raised = True
    finally:
        if old is None:
            os.environ.pop("DSLIB_SPARSE_DENSIFY_BUDGET", None)
        else:
            os.environ["DSLIB_SPARSE_DENSIFY_BUDGET"] = old
    check(raised, "sparse LinearRegression past the densify budget did not "
          "raise MemoryError")
    emit({"phase": "sparse_inputs", "shape": [SI_M, SI_N],
          "nnz": int(csr.nnz), "memory_error_past_budget": True, **out})
    del xs, xd
    torch.cuda.empty_cache()
    phase_wall("sparse_inputs", t_phase)


def numpy_normal_solve(entries, other, lam):
    """Float64 solutions of the regularised normal equations of each row:
    ``entries`` a list of (cols, vals) per row, ``other`` the other
    factor; an entry of value 0 is unobserved."""
    import numpy as np
    f = other.shape[1]
    out = np.zeros((len(entries), f))
    for i, (c, v) in enumerate(entries):
        keep = v != 0
        g = other[c[keep]]
        a = g.T @ g + lam * max(int(keep.sum()), 1) * np.eye(f)
        out[i] = np.linalg.solve(a, g.T @ v[keep])
    return out


def rel_err(got, want):
    """max |got - want| over max(1, max |want|)."""
    import numpy as np
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(1.0, float(np.abs(want).max())))


def als_floors(m, n, nnz, f):
    """The least time of one user half-step by each route's design: the
    sparse route writes the (nnz, f²) outer products once and reads them
    once in the segment sum; the dense route is the (m, n)×(n, f²) GEMM
    and r @ v at the float32 CUDA-core rate (TF32 off), reading the
    ratings and the mask once."""
    sparse = 8.0 * nnz * f * f / PEAK_BYTES
    dense = max((2.0 * m * n * f * f + 2.0 * m * n * f) / PEAK_FP32_FLOPS,
                8.0 * m * n / PEAK_BYTES)
    return {"sparse": 1e3 * sparse, "dense": 1e3 * dense}


def ivf_floor(mq, nprobe, cap, d):
    """The least time of one search's probe scan by its design: the gather
    reads ``nprobe·cap`` catalog rows a query and writes them into the
    panel, and the product reads the panel: three passes over
    mq·nprobe·cap·d float32."""
    return 1e3 * 3 * 4.0 * mq * nprobe * cap * d / PEAK_BYTES


def als_ratings(m=ALS_M, n=ALS_N, nnz=ALS_NNZ, f=ALS_F):
    """bench_als_sparse's draw: 100 random items a user, a planted rank-16
    score plus noise; the CSR sums the repeated (user, item) draws."""
    import numpy as np
    import scipy.sparse as sp
    rng = np.random.RandomState(2)
    rows = np.repeat(np.arange(m), nnz)
    cols = rng.randint(0, n, rows.shape[0])
    u_true = rng.standard_normal((m, f)).astype(np.float32)
    v_true = rng.standard_normal((n, f)).astype(np.float32)
    vals = (u_true[rows] * v_true[cols]).sum(1) + \
        0.1 * rng.standard_normal(rows.shape[0]).astype(np.float32)
    return sp.csr_matrix((vals, (rows, cols)), shape=(m, n),
                         dtype=np.float32)


def als_phase(dev, cuda_ms):
    """ALS at bench_als_sparse's size on a SparseArray: one user and one
    item half-step against a float64 NumPy solve of the same normal
    equations on a subset, the dense fit on the densified ratings against
    the sparse fit, two sparse fits bit-identical, the RMSE history
    decreasing, the fit's host reads; then fold-in batches against a
    float64 NumPy fold-in.  ALS launches none of the port's kernels."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    import dislib_tpu_torch as dst
    from dislib_tpu_torch.recommendation import ALS
    from dislib_tpu_torch.recommendation import als as als_mod
    from dislib_tpu_torch.ops import kernels as K
    from dislib_tpu_torch.utils import profiling as prof
    t_phase = time.perf_counter()
    m, n, f, lam = ALS_M, ALS_N, ALS_F, ALS_LAM
    csr = als_ratings()
    x = dst.SparseArray.from_scipy(csr)
    t_data = time.perf_counter() - t_phase

    def fit(data):
        est = ALS(n_f=f, lambda_=lam, tol=0.0, max_iter=ALS_ITERS,
                  random_state=0)
        t0 = time.perf_counter()
        est.fit(data)                 # ends in the results read
        return est, time.perf_counter() - t0

    K.reset_launches()
    first, first_s = fit(x)
    prof.reset_host_reads()
    sparse, sparse_s = fit(x)
    reads = dict(prof.HOST_READS)
    check(reads == {"sparse": 1, "results": 1}, f"als: a sparse fit at "
          f"tol 0 read {reads}, expected its column counts and results")
    check(np.array_equal(first.users_, sparse.users_)
          and np.array_equal(first.items_, sparse.items_)
          and np.array_equal(first.history_, sparse.history_),
          "als: two sparse fits with one seed differ")
    hist = sparse.history_
    check(hist.shape == (ALS_ITERS,) and bool(np.all(np.diff(hist) < 0))
          and bool(np.isfinite(hist).all()),
          f"als: the RMSE history does not decrease: {hist}")

    # the half-steps against float64 on a subset: each row's solve needs
    # only its own entries and the other factor
    users, items = als_mod._half_steps(x, f, lam)
    v_dev = torch.from_numpy(sparse.items_).to(dev)
    u_dev = torch.from_numpy(sparse.users_).to(dev)
    hold_u = np.sort(np.random.RandomState(5).choice(m, ALS_HOLD_U,
                                                     replace=False))
    hold_i = np.sort(np.random.RandomState(6).choice(n, ALS_HOLD_I,
                                                     replace=False))
    got_u = users.solve(v_dev)[torch.as_tensor(hold_u, device=dev)]
    got_i = items.solve(u_dev)[torch.as_tensor(hold_i, device=dev)]
    v64, u64 = sparse.items_.astype(np.float64), \
        sparse.users_.astype(np.float64)
    want_u = numpy_normal_solve(
        [(csr.indices[csr.indptr[i]:csr.indptr[i + 1]],
          csr.data[csr.indptr[i]:csr.indptr[i + 1]].astype(np.float64))
         for i in hold_u], v64, lam)
    csc = csr[:, hold_i].tocsc()
    want_i = numpy_normal_solve(
        [(csc.indices[csc.indptr[j]:csc.indptr[j + 1]],
          csc.data[csc.indptr[j]:csc.indptr[j + 1]].astype(np.float64))
         for j in range(len(hold_i))], u64, lam)
    err_u = rel_err(got_u.cpu().numpy(), want_u)
    err_i = rel_err(got_i.cpu().numpy(), want_i)
    check(err_u <= 1e-4 and err_i <= 1e-4, f"als: half-steps off the "
          f"float64 solve by {err_u} (users), {err_i} (items) > 1e-4")
    half_ms = {"users": cuda_ms(lambda: users.solve(v_dev), 3),
               "items": cuda_ms(lambda: items.solve(u_dev), 3)}

    # the dense fit on the densified ratings (on the card, 4 GB)
    xd = x.to_dense()
    fit(xd)                                          # warm
    dense, dense_s = fit(xd)
    err_dense = max(rel_err(dense.users_, sparse.users_),
                    rel_err(dense.items_, sparse.items_))
    check(err_dense <= 1e-4, f"als: the dense fit differs from the sparse "
          f"fit by {err_dense} > 1e-4")
    rp = xd._data
    mask = (rp != 0).to(rp.dtype)
    dense_half_ms = {
        "users": cuda_ms(lambda: als_mod._solve_factors(
            rp, mask, v_dev, lam, f), 3),
        "items": cuda_ms(lambda: als_mod._solve_factors(
            rp.T, mask.T, u_dev, lam, f), 3)}
    del xd, rp, mask
    torch.cuda.empty_cache()
    check(sum(K.LAUNCHES.values()) == 0, f"als launched {K.LAUNCHES}")

    # fold-in of new users (rows of the ratings) against float64 NumPy
    folds = {}
    for k in ALS_FOLD:
        batch = csr[:k]
        want_f = numpy_normal_solve(
            [(batch.indices[batch.indptr[i]:batch.indptr[i + 1]],
              batch.data[batch.indptr[i]:batch.indptr[i + 1]].astype(
                  np.float64)) for i in range(k)], v64, lam)
        want_p = want_f @ v64.T                            # (k, n)
        top = k > ALS_FOLD[0]
        out = sparse.fold_in(batch, top_n=ALS_TOP if top else None)
        if top:
            ids, scores = out
            order = np.argsort(-want_p, axis=1)[:, : ALS_TOP + 1]
            want_s = np.take_along_axis(want_p, order, axis=1)
            err = rel_err(scores, want_s[:, :ALS_TOP])
            # ids equal wherever the float64 scores around them are apart
            gap = 1e-3 * max(1.0, float(np.abs(want_s).max()))
            d = -np.diff(want_s, axis=1)                   # (k, top)
            apart = (d[:, :ALS_TOP] > gap) & np.concatenate(
                [np.ones((k, 1), bool), d[:, : ALS_TOP - 1] > gap], axis=1)
            bad = int(((ids != order[:, :ALS_TOP]) & apart).sum())
            check(bad == 0, f"als fold-in top {ALS_TOP}: {bad} ids differ "
                  "from float64 where the scores are apart")
        else:
            err = rel_err(out, want_p)
        check(err <= 1e-4, f"als fold-in of {k} users: off float64 by "
              f"{err} > 1e-4")
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            sparse.fold_in(batch, top_n=ALS_TOP if top else None)
            walls.append(time.perf_counter() - t0)
        folds[str(k)] = {"top_n": ALS_TOP if top else None,
                         "err_vs_f64": err,
                         "wall_ms_median": 1e3 * float(np.median(walls))}
    emit({"phase": "als", "shape": [m, n], "nnz": int(csr.nnz),
          "n_f": f, "lambda": lam, "sweeps": ALS_ITERS,
          "data_s": t_data, "sparse_fit_s": sparse_s,
          "sparse_first_fit_s": first_s, "dense_fit_s": dense_s,
          "rmse_history": hist.tolist(), "host_reads_per_fit": reads,
          "two_sparse_fits_bit_identical": True,
          "half_step_err_vs_f64": {"users": err_u, "items": err_i},
          "half_step_ms": {"sparse": half_ms, "dense": dense_half_ms},
          "chunks_per_half_step": {"users": len(users.chunks),
                                   "items": len(items.chunks)},
          "dense_vs_sparse_err": err_dense, "fold_in": folds,
          "half_step_floor_ms": als_floors(m, n, int(csr.nnz), f)})
    # the fitted model and the users the serving phase folds in
    SERVED["als"] = (sparse, csr[:SERVE_FOLD_USERS])
    del x, csr, users, items, v_dev, u_dev
    torch.cuda.empty_cache()
    phase_wall("als", t_phase)


def ivf_draw(m, d, nq, lists):
    """bench_ann's catalog (m, d) of ``lists`` blobs (centres x4) and ``nq``
    queries drawn from the same blobs (seed 3)."""
    import numpy as np
    rng = np.random.RandomState(3)
    centers = rng.standard_normal((lists, d)).astype(np.float32) * 4.0
    x = (centers[rng.randint(0, lists, m)]
         + rng.standard_normal((m, d))).astype(np.float32)
    q = (centers[rng.randint(0, lists, nq)]
         + rng.standard_normal((nq, d))).astype(np.float32)
    return x, q


def ivf_kth(x, q, k, dev, block=128):
    """The float64 k-th smallest squared distance of each query row of
    ``q`` to the catalog ``x`` (host arrays), on ``dev``: the threshold of
    the tie-tolerant recall@k."""
    import torch
    x64 = torch.from_numpy(x).to(dev).double()
    x_sq = (x64 * x64).sum(1)
    out = []
    for s0 in range(0, q.shape[0], block):
        q64 = torch.from_numpy(q[s0:s0 + block]).to(dev).double()
        d2 = (q64 * q64).sum(1)[:, None] - 2.0 * q64 @ x64.T + x_sq[None]
        out.append(torch.kthvalue(d2, k, dim=1).values)
    return torch.cat(out).cpu().numpy()


def ivf_recall(x, q, ids, kth):
    """Recall@k of the found ``ids`` (rows of q, -1 unfilled) against the
    float64 thresholds ``kth`` of the first ``len(kth)`` queries: a found
    row counts where its float64 distance is within ``kth`` (+1e-4)."""
    import numpy as np
    g = len(kth)
    found = ids[:g].astype(np.int64)
    d = ((q[:g, None, :].astype(np.float64)
          - x[np.maximum(found, 0)].astype(np.float64)) ** 2).sum(-1)
    return float(((d <= kth[:, None] + 1e-4) & (found >= 0)).mean())


def ivf_phase(dev, cuda_ms):
    """The IVF index at bench_ann's size: the fit (its quantizer's E-step
    on ``distances_sq``), the lists against a NumPy bucketing of the
    quantizer's labels, recall@10 against float64 under ``db`` and under
    ``kernel`` (the centroid product on ``panel_gemm``), queries/s beside
    the exact ``kneighbors``; ``nprobe = n_lists`` against the exact kNN on
    a cut.  Returns the two kernels' line entries."""
    import numpy as np
    import torch
    import dislib_tpu_torch as dst
    from dislib_tpu_torch.ops import kernels as K
    from dislib_tpu_torch.ops import precision as px
    from dislib_tpu_torch.retrieval import IVFIndex
    t_phase = time.perf_counter()
    x, q = ivf_draw(IVF_M, IVF_D, IVF_Q, IVF_LISTS)
    X, Q = dst.array(x), dst.array(q)
    xd, qd = X._data, Q._data

    # the float64 oracle on the card: the k-th distance² of the gate
    # queries, for bench's tie-tolerant recall
    x64 = xd.double()
    x64_sq = (x64 * x64).sum(1)
    kth = []
    for s in range(0, IVF_GATE_Q, 128):
        q64 = qd[s: min(s + 128, IVF_GATE_Q)].double()
        d2 = (q64 * q64).sum(1)[:, None] - 2.0 * q64 @ x64.T + x64_sq[None]
        kth.append(torch.kthvalue(d2, IVF_K, dim=1).values)
        del d2
    kth = torch.cat(kth)
    del x64_sq

    def recall(idx):
        found = idx[:IVF_GATE_Q].to(torch.int64)
        live = found >= 0
        fv = x64[found.clamp_min(0)]
        qg = qd[:IVF_GATE_Q].double()
        d_found = ((qg[:, None, :] - fv) ** 2).sum(-1)
        return float(((d_found <= kth[:, None] + 1e-4) & live).double()
                     .mean())

    K.reset_launches()
    t0 = time.perf_counter()
    ix = IVFIndex(n_lists=IVF_LISTS, nprobe=IVF_PROBE,
                  kmeans_max_iter=IVF_ITERS, random_state=0).fit(X)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = dict(K.LAUNCHES)
    check(fit_launches["distances_sq"] >= IVF_ITERS, f"ivf fit: "
          f"distances_sq launched {fit_launches}")

    # the lists hold exactly the NumPy bucketing of the quantizer's labels
    labels = ix.quantizer_.predict(X).collect().ravel()
    ids = ix._ids.cpu().numpy()
    offs, cnts = ix._offs.cpu().numpy(), ix._cnts.cpu().numpy()
    check(np.array_equal(cnts, np.bincount(labels, minlength=IVF_LISTS)),
          "ivf: list lengths differ from the labels' counts")
    live = np.concatenate([np.arange(o, o + c) for o, c in zip(offs, cnts)])
    check(np.array_equal(ids[live], np.argsort(labels, kind="stable")),
          "ivf: list membership differs from a NumPy bucketing of the "
          "quantizer's labels")
    check(int((ids >= 0).sum()) == IVF_M, "ivf: pad slots hold ids")

    routes = {}
    for route in ("db", "kernel"):
        _, idx = ix.search(Q, k=IVF_K, overlap=route)       # warm
        K.reset_launches()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            dist, idx = ix.search(Q, k=IVF_K, overlap=route)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        launches = {k_: v // 5 for k_, v in K.LAUNCHES.items()}
        want = {"panel_gemm": 1 if route == "kernel" else 0,
                "distances_sq": 0, "node_histogram": 0}
        check(launches == want, f"ivf search {route}: launches {launches}")
        r = recall(idx._data)
        check(r >= 0.95, f"ivf {route}: recall@{IVF_K} {r} < 0.95")
        check(bool(torch.isfinite(dist._data).all()), f"ivf {route}: "
              "non-finite distances")
        t = float(np.median(walls))
        routes[route] = {"recall": r, "wall_s": t,
                         "queries_per_s": IVF_Q / t,
                         "launches_per_search": launches}
    check(abs(routes["kernel"]["recall"] - routes["db"]["recall"]) <= 0.002,
          f"ivf: the kernel route's recall {routes['kernel']['recall']} is "
          f"off db's {routes['db']['recall']} by more than 0.002")

    # the exact kneighbors on the same catalog
    nn = dst.NearestNeighbors(n_neighbors=IVF_K).fit(X)
    nn.kneighbors(Q)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        nn.kneighbors(Q)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    exact_s = float(np.median(walls))

    # nprobe = n_lists on a cut: the exact kNN's ids wherever its distances
    # leave no near tie (the two compute d² in float32 in another order)
    xc = dst.array(x[:IVF_CUT_M])
    cut = IVFIndex(n_lists=IVF_CUT_LISTS, kmeans_max_iter=IVF_ITERS,
                   random_state=0).fit(xc)
    qc = dst.array(q[:IVF_GATE_Q])
    _, ci = cut.search(qc, k=IVF_K, nprobe=IVF_CUT_LISTS)
    ed, ei = dst.NearestNeighbors(n_neighbors=IVF_K + 1).fit(xc) \
        .kneighbors(qc)
    ci, ei, ed2 = ci.collect(), ei.collect(), ed.collect() ** 2
    scale = float((q[:IVF_GATE_Q] ** 2).sum(1).max()
                  + (x[:IVF_CUT_M] ** 2).sum(1).max())
    gap = np.diff(ed2, axis=1) > 1e-5 * scale             # (q, k)
    apart = gap[:, :IVF_K] & np.concatenate(
        [np.ones((IVF_GATE_Q, 1), bool), gap[:, : IVF_K - 1]], axis=1)
    bad = int(((ci != ei[:, :IVF_K]) & apart).sum())
    check(bad == 0, f"ivf nprobe = n_lists: {bad} ids differ from the "
          "exact kNN where its distances are apart")

    # the kernels at their new shapes, against their plain versions
    gemm_tol = px.ERROR_BOUNDS[("matmul", "float32")]
    ct = ix._cents_t
    out = K.panel_gemm(qd, ct, px.FLOAT32)
    plain = K.panel_gemm_plain(qd, ct, px.FLOAT32)
    scale = (torch.linalg.norm(qd.double()) * torch.linalg.norm(ct.double())
             / float(qd.shape[1]) ** 0.5)
    err = float((out.double() - plain.double()).abs().max() / scale)
    check(err <= gemm_tol, f"panel_gemm at the IVF centroid shape: "
          f"normalized error {err} > {gemm_tol}")
    max_abs = float((out - plain).abs().max())

    def lib():
        with px.precise():
            return torch.mm(qd, ct)

    mq, kk, nl = IVF_Q, IVF_D, IVF_LISTS
    gemm = {"name": "panel_gemm", "at": "ivf", "policy": "float32",
            "route": "cuda", "source": "dislib_tpu_torch/csrc/panel_gemm.cu",
            "replaces": "dislib_tpu/ops/pallas_kernels.py:76",
            "shape": [mq, kk, nl], "max_abs_err": max_abs,
            "normalized_err_vs_plain": err,
            "ms": cuda_ms(lambda: K.panel_gemm(qd, ct, px.FLOAT32), 50),
            "plain_ms": cuda_ms(lambda: K.panel_gemm_plain(
                qd, ct, px.FLOAT32), 50),
            "library_ms": cuda_ms(lib, 50),
            "library_call": "torch.mm (f32, TF32 off)",
            "launches": routes["kernel"]["launches_per_search"]["panel_gemm"],
            "bound_basis": "3xTF32: three 2mkn TF32 tensor-core products "
                           "at 495 TFLOP/s; each operand read once, C "
                           "written once"}
    gemm["bound_ms"], gemm["bound_by"] = bound(
        3 * 2.0 * mq * kk * nl, 4.0 * (mq * kk + kk * nl + mq * nl),
        PEAK_TF32_FLOPS)
    emit({"phase": "kernel", **gemm})
    cents = torch.from_numpy(ix.quantizer_.centers_).to(dev)
    dist = dist_entry(K, "ivf_kmeans", xd, cents, cuda_ms, 10)
    dist["launches"] = fit_launches["distances_sq"]
    emit({"phase": "kernel", **dist})
    emit({"phase": "ivf", "catalog": [IVF_M, IVF_D], "queries": IVF_Q,
          "k": IVF_K, "n_lists": IVF_LISTS, "nprobe": IVF_PROBE,
          "kmeans_max_iter": IVF_ITERS, "fit_s": fit_s,
          "fit_launches": fit_launches, "routes": routes,
          "exact_kneighbors_s": exact_s,
          "exact_queries_per_s": IVF_Q / exact_s,
          "pad_waste": ix.pad_waste,
          "cap": ix._cap, "mean_list": IVF_M / IVF_LISTS,
          "scan_floor_ms": ivf_floor(IVF_Q, IVF_PROBE, ix._cap, IVF_D),
          "scan_floor_ms_at_mean_list": ivf_floor(
              IVF_Q, IVF_PROBE, IVF_M / IVF_LISTS, IVF_D),
          "cut": {"rows": IVF_CUT_M, "n_lists": IVF_CUT_LISTS,
                  "ids_equal_where_apart": True}})
    # the index and its queries, for the serving phase
    SERVED["ivf"] = (ix, q)
    del X, Q, xd, qd, x64, ix, nn, cut, out, plain, cents
    torch.cuda.empty_cache()
    phase_wall("ivf", t_phase)
    return {"panel_gemm/ivf": gemm, "distances_sq/ivf_kmeans": dist}


def resilience_tools():
    """The resilience phase's timed checkpoint and kill switch, built on
    the port's classes (imported here: the module imports nothing of the
    port at load)."""
    import numpy as np
    from dislib_tpu_torch.runtime import health, preemption
    from dislib_tpu_torch.utils import checkpoint as ck

    class TimedCheckpoint(ck.FitCheckpoint):
        """A FitCheckpoint that times each save on the snapshot worker:
        the wait for its device→host copies, a separate CRC-32 pass over
        the arrays (the save's own checksum is inside ``write_ms``), and
        the save (checksum, npz, fsync, rotation)."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.log = []

        def save(self, state):
            t0 = time.perf_counter()
            host = {k: np.asarray(v.result() if hasattr(v, "result") else v)
                    for k, v in state.items()}
            t1 = time.perf_counter()
            ck._state_crc(host)
            t2 = time.perf_counter()
            super().save(host)
            t3 = time.perf_counter()
            self.log.append({"bytes": os.path.getsize(self.path),
                             "d2h_ms": 1e3 * (t1 - t0),
                             "checksum_ms": 1e3 * (t2 - t1),
                             "write_ms": 1e3 * (t3 - t2)})

    class PreemptAtChunk(health.HealthPolicy):
        """Requests preemption in the main thread when chunk ``at_chunk``
        is admitted: the fit snapshots that chunk and raises ``Preempted``
        at its boundary (a signal from the snapshot worker would land at a
        boundary that depends on the disk's speed)."""

        def __init__(self, at_chunk, **kw):
            super().__init__(**kw)
            self.at_chunk = int(at_chunk)

        def make_guard(self, name, checkpoint=None):
            at = self.at_chunk

            class Guard(health.ChunkGuard):
                def admit(self, *carries):
                    carries = super().admit(*carries)
                    if self.chunk_index == at:
                        preemption.request_preemption()
                    return carries

            return Guard(name, self, checkpoint)

    return TimedCheckpoint, PreemptAtChunk


def kill_and_resume(name, make, args, every, at_chunk, tmp, same,
                    position):
    """Fit ``make()`` uninterrupted, then checkpointed and preempted at
    chunk ``at_chunk``, then resumed by a fresh estimator on a fresh
    FitCheckpoint; the resumed fit must equal the uninterrupted one
    (``same``).  ``position(snapshot)`` is the snapshot's resume point.
    Returns the walls, the snapshots' sizes and times, the resumed fit's
    launches and ``fit_info_``."""
    import torch
    from dislib_tpu_torch.ops import kernels as K
    from dislib_tpu_torch.runtime import Preempted, clear_preemption
    from dislib_tpu_torch.utils.checkpoint import FitCheckpoint
    Timed, PreemptAt = resilience_tools()
    t0 = time.perf_counter()
    plain = make().fit(*args)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    path = os.path.join(tmp, f"{name}.npz")
    ck = Timed(path, every=every)
    t0 = time.perf_counter()
    try:
        make().fit(*args, checkpoint=ck, health=PreemptAt(at_chunk))
        raise AssertionError(f"resilience {name}: the fit was not preempted")
    except Preempted:
        pass
    finally:
        clear_preemption()
    t_killed = time.perf_counter() - t0
    at = position(FitCheckpoint(path).load())
    K.reset_launches()
    t0 = time.perf_counter()
    resumed = make().fit(*args, checkpoint=FitCheckpoint(path, every=every))
    torch.cuda.synchronize()
    t_resumed = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    check(same(plain, resumed), f"resilience {name}: the resumed fit "
          "differs from the uninterrupted one")
    return {"fit_s": t_plain, "killed_fit_s": t_killed,
            "resumed_fit_s": t_resumed, "resumed_from": at,
            "snapshots": ck.log, "resumed_launches": launches,
            "resumed_fit_info": resumed.fit_info_, "bit_identical": True}


def resilience_phase(dev, card):
    """The checkpointed fit on the card (PR 12): KMeans at 1M × 100 —
    checked and unchecked bit-identical, SIGTERM after the second save
    and a bit-identical resume, a NaN chunk healed by one rollback, a
    hung chunk tripping the watchdog once, a NaN row raising on the
    unchecked fit — then a kill and a resume of the forest (1M × 100, 16
    trees), ALS (bench_als_sparse's size), GaussianMixture (1M × 50,
    k = 16), MiniBatchKMeans (245 batches of 4,096), CascadeSVM, DBSCAN
    and Daura.  Returns the launches of distances_sq and node_histogram
    in the checked and resumed KMeans and forest fits."""
    import numpy as np
    import torch
    import dislib_tpu_torch as dst
    from dislib_tpu_torch.ops import kernels as K
    from dislib_tpu_torch.runtime import (NumericalDivergence, Preempted,
                                          PreemptionWatcher,
                                          clear_preemption)
    from dislib_tpu_torch.trees import RandomForestClassifier
    from dislib_tpu_torch.utils import faults
    from dislib_tpu_torch.utils import profiling as prof
    from dislib_tpu_torch.utils.checkpoint import FitCheckpoint
    t_phase = time.perf_counter()
    Timed, _ = resilience_tools()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    res = {"card": card}
    out = {}
    try:
        # -- KMeans, the main path: 1M x 100, k = 10, 50 steps ---------------
        rng = np.random.RandomState(0)
        x_host = rng.rand(KM_M, KM_N).astype(np.float32)
        init = x_host[rng.choice(KM_M, KM_K, replace=False)].copy()
        x = dst.array(x_host)
        del x_host

        def km():
            return dst.KMeans(n_clusters=KM_K, init=init,
                              max_iter=RES_KM_ITERS, tol=0.0)

        def fit_km(**kw):
            K.reset_launches()
            prof.reset_host_reads()
            t0 = time.perf_counter()
            est = km().fit(x, **kw)
            wall = time.perf_counter() - t0
            return est, wall, dict(K.LAUNCHES), dict(prof.HOST_READS)

        km().fit(x)                                   # warm
        plain, t_plain, l_plain, r_plain = fit_km()
        ck = Timed(os.path.join(tmp, "km.npz"), every=RES_KM_EVERY)
        checked, t_checked, l_checked, r_checked = fit_km(checkpoint=ck)
        check(r_plain == {"results": 1}, f"resilience kmeans: the unchecked "
              f"fit read {r_plain}, expected its one results read")
        check(np.array_equal(checked.centers_, plain.centers_)
              and checked.n_iter_ == plain.n_iter_ == RES_KM_ITERS,
              "resilience kmeans: the checked fit differs from the "
              "unchecked one")
        check(checked.fit_info_["chunks"] == RES_KM_ITERS // RES_KM_EVERY,
              f"resilience kmeans: fit_info_ {checked.fit_info_}")
        check(l_plain.get("distances_sq") == RES_KM_ITERS
              and l_checked.get("distances_sq") == RES_KM_ITERS,
              f"resilience kmeans: distances_sq launched {l_plain} / "
              f"{l_checked} times in {RES_KM_ITERS} steps")
        out["distances_sq"] = l_checked["distances_sq"]
        res["kmeans"] = {
            "shape": [KM_M, KM_N], "k": KM_K, "iterations": RES_KM_ITERS,
            "every": RES_KM_EVERY, "unchecked_fit_s": t_plain,
            "checked_fit_s": t_checked,
            "checked_overhead": t_checked / t_plain - 1.0,
            "host_reads_unchecked": r_plain, "host_reads_checked": r_checked,
            "launches_checked": l_checked, "snapshots": ck.log,
            "fit_info_checked": checked.fit_info_, "bit_identical": True}

        # SIGTERM after the second save, the resume on a fresh checkpoint
        path = os.path.join(tmp, "km_sigterm.npz")
        t0 = time.perf_counter()
        try:
            with PreemptionWatcher():
                km().fit(x, checkpoint=faults.SigtermAtNthSave(
                    path, every=RES_KM_SIGTERM_EVERY, after=2))
            raise AssertionError("resilience kmeans: SIGTERM after the "
                                 "second save did not preempt the fit")
        except Preempted as e:
            check(e.checkpoint_path == path and os.path.exists(path),
                  "resilience kmeans: Preempted without its snapshot")
        finally:
            clear_preemption()
        t_killed = time.perf_counter() - t0
        done = int(FitCheckpoint(path).load()["n_iter"])
        resumed, t_res, l_res, _ = fit_km(checkpoint=FitCheckpoint(
            path, every=RES_KM_SIGTERM_EVERY))
        check(np.array_equal(resumed.centers_, plain.centers_),
              "resilience kmeans: the resumed fit differs from the "
              "uninterrupted one")
        check(l_res.get("distances_sq") == RES_KM_ITERS - done,
              f"resilience kmeans: the resume launched distances_sq "
              f"{l_res} times for {RES_KM_ITERS - done} steps left")
        out["distances_sq_resumed"] = l_res["distances_sq"]
        res["kmeans_sigterm"] = {
            "every": RES_KM_SIGTERM_EVERY, "after_save": 2,
            "snapshot_n_iter": done, "killed_fit_s": t_killed,
            "resumed_fit_s": t_res, "resumed_launches": l_res,
            "bit_identical": True}

        # a NaN chunk heals by one rollback
        nan, t_nan, _, _ = fit_km(
            checkpoint=FitCheckpoint(os.path.join(tmp, "km_nan.npz"),
                                     every=RES_KM_EVERY),
            health=faults.NaNAtChunk(at_chunk=3))
        check(nan.fit_info_["rollbacks"] == 1
              and np.array_equal(nan.centers_, plain.centers_),
              f"resilience kmeans: NaNAtChunk did not heal to the same "
              f"bits ({nan.fit_info_})")
        # a hung chunk trips the watchdog once and heals
        prof.reset_counters()
        hang, t_hang, _, _ = fit_km(
            checkpoint=FitCheckpoint(os.path.join(tmp, "km_hang.npz"),
                                     every=RES_KM_EVERY),
            health=faults.HangAtChunk(at_chunk=2, hang_s=0.5,
                                      deadline_s=0.1))
        trips = prof.resilience_counters().get("watchdog_trips", 0)
        check(trips == 1 and np.array_equal(hang.centers_, plain.centers_),
              f"resilience kmeans: HangAtChunk tripped {trips} times")
        # C.14: a NaN row raises on the unchecked fit
        keep = x._data[17, 3].clone()
        x._data[17, 3] = float("nan")
        try:
            km().fit(x)
            raise AssertionError("resilience kmeans: a NaN row did not "
                                 "raise NumericalDivergence")
        except NumericalDivergence as e:
            check(e.guard == "nonfinite", f"resilience kmeans: guard "
                  f"{e.guard!r}")
        finally:
            x._data[17, 3] = keep
        res["kmeans_faults"] = {
            "nan_at_chunk_fit_s": t_nan, "nan_fit_info": nan.fit_info_,
            "hang_fit_s": t_hang, "watchdog_trips": trips,
            "nan_row_raises": "nonfinite"}

        # MiniBatchKMeans: the 245-batch stream, preempted at batch 100
        def mbk():
            return dst.MiniBatchKMeans(n_clusters=KM_K, init=init,
                                       batch_size=MBK_BATCH)

        res["minibatch"] = kill_and_resume(
            "minibatch", mbk, (x,), RES_MBK_EVERY, 100, tmp,
            lambda a, b: np.array_equal(a.centers_, b.centers_)
            and np.array_equal(a.counts_, b.counts_),
            lambda s: int(s["n_batches"]))
        del x
        torch.cuda.empty_cache()

        # -- the forest: 1M x 100, 16 trees, 12 levels -----------------------
        x_f, lab_f = blobs(RF_M, RF_N, 8, seed=5)
        X, Y = dst.array(x_f), dst.array((lab_f % 2).astype(
            np.float32)[:, None])
        del x_f, lab_f

        def rf():
            return RandomForestClassifier(n_estimators=RF_T, random_state=0)

        res["forest"] = kill_and_resume(
            "forest", rf, (X, Y), RES_RF_EVERY, RES_RF_EVERY, tmp,
            same_forest, lambda s: int(s["lvl"]))
        lvl = res["forest"]["resumed_from"]
        n_hist = res["forest"]["resumed_launches"].get("node_histogram")
        check(n_hist == 12 - lvl, f"resilience forest: the resume from "
              f"level {lvl} launched node_histogram {n_hist} times")
        out["node_histogram_resumed"] = n_hist
        K.reset_launches()
        rf().fit(X, Y, checkpoint=FitCheckpoint(os.path.join(
            tmp, "rf_checked.npz"), every=RES_RF_EVERY))
        out["node_histogram"] = K.LAUNCHES["node_histogram"]
        check(out["node_histogram"] == 12, f"resilience forest: a checked "
              f"fit launched node_histogram {out['node_histogram']} times")
        del X, Y
        torch.cuda.empty_cache()

        # -- ALS at bench_als_sparse's size, one sweep a chunk ----------------
        xs = dst.SparseArray.from_scipy(als_ratings())

        def als():
            return dst.ALS(n_f=ALS_F, lambda_=ALS_LAM, tol=0.0,
                           max_iter=ALS_ITERS, random_state=0)

        res["als"] = kill_and_resume(
            "als", als, (xs,), 1, 2, tmp,
            lambda a, b: np.array_equal(a.users_, b.users_)
            and np.array_equal(a.items_, b.items_),
            lambda s: int(s["n_iter"]))
        del xs
        torch.cuda.empty_cache()

        # -- GaussianMixture, BASELINE config 5, 6 EM steps -------------------
        xg, _ = blobs(GM_M, GM_N, GM_K, seed=3)
        Xg = dst.array(xg)
        del xg

        def gm():
            return dst.GaussianMixture(n_components=GM_K, max_iter=
                                       RES_GM_ITERS, tol=0.0,
                                       init_params="random", random_state=0)

        res["gm"] = kill_and_resume(
            "gm", gm, (Xg,), 2, 2, tmp,
            lambda a, b: np.array_equal(a.means_, b.means_)
            and np.array_equal(a.covariances_, b.covariances_),
            lambda s: int(s["n_iter"]))
        del Xg
        torch.cuda.empty_cache()

        # -- CascadeSVM, DBSCAN and Daura, cut for the phase's time ----------
        rng = np.random.RandomState(0)
        half = RES_CSVM_M // 2
        xc = np.vstack([rng.randn(half, CSVM_N) + 2.0,
                        rng.randn(RES_CSVM_M - half, CSVM_N) - 2.0]).astype(
            np.float32)
        yc = np.r_[np.ones(half), -np.ones(RES_CSVM_M - half)].astype(
            np.float32)[:, None]
        Xc = dst.array(xc, block_size=(CSVM_PART, CSVM_N))
        Yc = dst.array(yc, block_size=(CSVM_PART, 1))
        res["csvm"] = kill_and_resume(
            "csvm", lambda: dst.CascadeSVM(max_iter=CSVM_ITERS,
                                           check_convergence=False),
            (Xc, Yc), 1, 1, tmp,
            lambda a, b: np.array_equal(a._sv_idx, b._sv_idx)
            and np.array_equal(a._sv_alpha, b._sv_alpha),
            lambda s: int(s["n_iter"]))
        xd, _ = blobs(RES_DB_M, DB_N, 16, seed=4)
        res["dbscan"] = kill_and_resume(
            "dbscan", lambda: dst.DBSCAN(eps=DB_EPS, min_samples=DB_MIN),
            (dst.array(xd),), 1, 2, tmp,
            lambda a, b: np.array_equal(a.labels_, b.labels_),
            lambda s: int(np.unique(s["label"]).size))
        xa, _ = blobs(RES_DA_M, DA_N, 12, seed=6, std=0.05)
        res["daura"] = kill_and_resume(
            "daura", lambda: dst.Daura(cutoff=DA_CUT), (dst.array(xa),), 2,
            2, tmp, lambda a, b: np.array_equal(a.labels_, b.labels_),
            lambda s: int(s["cid"]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "resilience", **res})
    return out


def drive_clients(submit, n, stop=None, threads=SERVE_THREADS,
                  window=SERVE_WINDOW):
    """Requests 0..n-1 from ``threads`` client threads (client t sends t,
    t + threads, ...), each keeping ``window`` in flight; ``submit(i)``
    returns request i's Future.  With ``stop``, a client sends no new
    request once it is set.  Returns the responses by request (None for
    one never sent); the first client error is raised."""
    import threading
    from collections import deque
    out = [None] * n
    errs = []

    def client(t):
        pending = deque()
        try:
            for i in range(t, n, threads):
                if stop is not None and stop.is_set():
                    break
                pending.append((i, submit(i)))
                if len(pending) >= window:
                    j, f = pending.popleft()
                    out[j] = f.result(timeout=300)
            while pending:
                j, f = pending.popleft()
                out[j] = f.result(timeout=300)
        except Exception as exc:        # noqa: BLE001 — re-raised below
            errs.append(exc)

    ths = [threading.Thread(target=client, args=(t,))
           for t in range(threads)]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    if errs:
        raise errs[0]
    return out


def cover_sizes(n, max_rows, seed):
    """Request sizes of 1 to ``max_rows`` rows, drawn from ``seed``,
    that cover ``n`` rows exactly, and their starts."""
    import numpy as np
    rng = np.random.RandomState(seed)
    sizes = []
    while sum(sizes) < n:
        sizes.append(min(int(rng.randint(1, max_rows + 1)), n - sum(sizes)))
    return np.cumsum([0] + sizes[:-1]), np.asarray(sizes)


def graph_ms(fn, cuda_ms, reps):
    """CUDA-event time of ``fn`` replayed from a CUDA graph captured as
    the serving layer captures (a side stream, ``thread_local``); the
    capture's launches are recorded, not counted."""
    import torch
    from dislib_tpu_torch.ops import kernels as K
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with K.recording_launches(capturing=True) as rec:
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return cuda_ms(graph.replay, reps), out, dict(rec)


def serving_phase(dev, cuda_ms, card):
    """The serving layer on the card: the main path's KMeans (1M × 100,
    k = 10) behind a StandardScaler fitted on its rows, served by
    ``PredictServer`` over the default ladder to SERVE_REQ requests from
    SERVE_THREADS client threads — every response against a direct
    predict, one CUDA-graph replay per bucket piece, no capture and no
    kernel build after warm; a ``ModelPool`` following a checkpointed
    KMeans fit continued during the traffic (no torn response, a
    non-finite generation refused while serving goes on); two tenants
    and a 10 % canary behind a ``ModelRouter``; the IVF index's 4,096
    queries through ``RetrievalPipeline`` under ``kernel`` (ids equal to
    ``IVFIndex.search``); the ALS model's fold-in of SERVE_FOLD_USERS
    users through ``SparseFoldInPipeline`` against ``ALS.fold_in``.
    Returns the kernels-line entries of ``distances_sq`` and
    ``panel_gemm`` at the served shapes."""
    import tempfile as _tf
    import threading
    import numpy as np
    import torch
    import dislib_tpu_torch as dst
    from dislib_tpu_torch.ops import kernels as K
    from dislib_tpu_torch.ops import precision as px
    from dislib_tpu_torch.retrieval import RetrievalPipeline
    from dislib_tpu_torch.runtime import AdoptionRejected
    from dislib_tpu_torch.serving import (ModelPool, ModelRouter,
                                          PredictServer, ServePipeline,
                                          SparseFoldInPipeline,
                                          TenantQuotaExceeded)
    from dislib_tpu_torch.utils import profiling as prof
    from dislib_tpu_torch.utils.checkpoint import FitCheckpoint
    t_phase = time.perf_counter()
    res = {"card": card, "buckets": list(SERVE_BUCKETS)}

    # -- the main path's KMeans behind a scaler fitted on its rows ----------
    rng = np.random.RandomState(0)
    x_host = rng.rand(KM_M, KM_N).astype(np.float32)
    init = x_host[rng.choice(KM_M, KM_K, replace=False)].copy()
    X = dst.array(x_host)
    km = SERVED.pop("kmeans")
    sc = dst.StandardScaler().fit(X)
    XS = sc.transform(X)
    labels_all = km.predict(XS).collect().ravel()
    pipe = ServePipeline(km, transforms=(sc,))
    draw = np.random.RandomState(13)
    sizes = draw.randint(1, SERVE_MAX_ROWS + 1, SERVE_REQ)
    starts = draw.randint(0, KM_M - SERVE_MAX_ROWS, SERVE_REQ)
    srv = PredictServer(pipeline=pipe, buckets=SERVE_BUCKETS, name="km")
    t0 = time.perf_counter()
    srv.start()                     # warm: one capture a bucket
    warm_s = time.perf_counter() - t0
    check(all(pipe.program(b).mode == "graph" for b in SERVE_BUCKETS),
          "serving: the scaler → KMeans chain was not captured")
    warm = srv.cache.stats()
    # the main path: counts zeroed just before, read just after
    K.reset_launches()
    prof.reset_counters()
    t0 = time.perf_counter()
    resp = drive_clients(lambda i: srv.submit(
        x_host[starts[i]: starts[i] + sizes[i]]), SERVE_REQ)
    traffic_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    counters = prof.counters()
    st = srv.stats()
    srv.stop()
    bad = sum(not np.array_equal(r.values.ravel(),
                                 labels_all[s: s + k])
              for r, s, k in zip(resp, starts, sizes))
    check(bad == 0, f"serving: {bad} responses differ from the direct "
          "predict of their rows")
    for i in draw.choice(SERVE_REQ, 64, replace=False):
        rows = x_host[starts[i]: starts[i] + sizes[i]]
        check(np.array_equal(resp[i].values, km.predict(sc.transform(
            dst.array(rows))).collect()), "serving: a response differs "
            "from a direct predict of the same rows")
    batches = st["batches"]
    check(st["dispatches_per_batch_max"] == 1
          and st["dispatches_per_batch_mean"] == 1.0,
          f"serving: a batch took more than one replay: {st}")
    check(counters["dispatch_by"] == {"fused_chain": batches},
          f"serving: dispatches {counters['dispatch_by']} for {batches} "
          "batches")
    check(counters["traces"] == 0, f"serving: captures or builds after "
          f"warm: {counters['trace_by']}")
    check(launches["distances_sq"] == batches, f"serving: distances_sq "
          f"launched {launches['distances_sq']} times in {batches} replays")
    per_bucket = {}
    for b in SERVE_BUCKETS:
        prog = pipe.program(b)
        check(torch.equal(prog.replay_device().clone(), prog.eager_device()),
              f"serving: bucket {b}'s replay differs from its eager chain")
        per_bucket[str(b)] = {"replay_ms": cuda_ms(prog.replay_device, 50),
                              "eager_ms": cuda_ms(prog.eager_device, 20),
                              "kernels_per_replay": prog.kernels}
    res["kmeans"] = {
        "requests": SERVE_REQ, "threads": SERVE_THREADS,
        "window": SERVE_WINDOW, "rows": int(sizes.sum()),
        "warm_s": warm_s, "traffic_s": traffic_s,
        "p50_ms": st["p50_ms"], "p95_ms": st["p95_ms"],
        "p99_ms": st["p99_ms"], "rows_per_s": st["rows_per_s"],
        "qps": st["qps"], "batches": batches,
        "bucket_cost_ms": st["bucket_cost_ms"],
        "dispatches_per_batch_max": st["dispatches_per_batch_max"],
        "traces_after_warm": counters["traces"], "launches": launches,
        "warm": warm, "per_bucket": per_bucket,
        "responses_equal_direct_predict": True}
    emit({"phase": "serving_kmeans", **res["kmeans"]})
    dist_launches, dist_batches = launches["distances_sq"], batches

    # -- hot-swap: a ModelPool following a continued checkpointed fit -------
    tmp = _tf.mkdtemp(prefix="chip_smoke_serve_")
    try:
        path = os.path.join(tmp, "km.npz")
        init_s = sc.transform(dst.array(init)).collect()

        def fit_round(r):
            # each round resumes from the snapshot and takes one step
            dst.KMeans(n_clusters=KM_K, init=init_s, max_iter=r,
                       tol=0.0).fit(XS, checkpoint=FitCheckpoint(
                           path, every=1))

        def build(state):
            g = dst.KMeans(n_clusters=KM_K)
            g.centers_ = np.asarray(state["centers"], np.float32)
            return ServePipeline(g, transforms=(sc,), n_features=KM_N)

        fit_round(1)
        pool = ModelPool(FitCheckpoint(path), build, buckets=SERVE_BUCKETS,
                         poll_interval_s=0.0)
        gens = {}
        current = pool.current

        def recorded():
            tok, p = current()
            if p is not None:
                gens.setdefault(tok, p.model.centers_)
            return tok, p

        pool.current = recorded
        psrv = PredictServer(pool=pool, name="pool").start()
        K.reset_launches()
        prof.reset_counters()
        a0 = pool.adoptions
        stop = threading.Event()
        t_err = []

        def trainer():
            try:
                for r in range(2, SERVE_SWAP_ROUNDS + 2):
                    fit_round(r)
                    time.sleep(0.1)
            except Exception as exc:    # noqa: BLE001 — checked below
                t_err.append(exc)
            finally:
                stop.set()

        n_max = 400 * SERVE_SWAP_ROUNDS * SERVE_THREADS
        h_sizes = draw.randint(1, SERVE_MAX_ROWS + 1, n_max)
        h_starts = draw.randint(0, KM_M - SERVE_MAX_ROWS, n_max)
        th = threading.Thread(target=trainer)
        th.start()
        t0 = time.perf_counter()
        hresp = drive_clients(lambda i: psrv.submit(
            x_host[h_starts[i]: h_starts[i] + h_sizes[i]]), n_max, stop=stop)
        th.join()
        swap_s = time.perf_counter() - t0
        check(not t_err, f"serving: the trainer failed: {t_err}")
        pool.poll(force=True)
        swaps = pool.adoptions - a0
        swap_counters = prof.counters()
        # a non-finite generation is refused, and serving goes on
        FitCheckpoint(path).save({
            "centers": np.full((KM_K, KM_N), np.nan, np.float32),
            "n_iter": np.asarray(10_000), "converged": np.asarray(False)})
        before = pool.current()[0]
        check(not pool.poll(force=True) and isinstance(
            pool.last_rejection, AdoptionRejected), "serving: the "
            f"non-finite generation was not refused: {pool.last_rejection}")
        after = psrv.submit(x_host[:64]).result(timeout=60)
        check(after.generation == before, "serving: the refused "
              "generation was served")
        hst = psrv.stats()
        psrv.stop()
        sent = [(r, s, k) for r, s, k in zip(hresp, h_starts, h_sizes)
                if r is not None] + [(after, 0, 64)]
        gen_labels = {}
        for tok, centers in gens.items():
            g = dst.KMeans(n_clusters=KM_K)
            g.centers_ = centers
            gen_labels[tok] = g.predict(XS).collect().ravel()
        torn = sum(not np.array_equal(r.values.ravel(),
                                      gen_labels[r.generation][s: s + k])
                   for r, s, k in sent)
        check(torn == 0, f"serving: {torn} hot-swap responses differ from "
              "their generation's direct predict")
        served_gens = {r.generation for r, _, _ in sent}
        check(swaps >= 2 and len(served_gens) >= 2, f"serving: {swaps} "
              f"swaps, {len(served_gens)} generations served")
        cap = swap_counters["trace_by"]
        check(set(cap) <= {"cuda_graph"} and cap.get("cuda_graph", 0)
              == swaps * len(SERVE_BUCKETS), "serving: a swap built a "
              f"kernel or captured off warm: {cap}, {swaps} swaps")
        res["hotswap"] = {
            "rounds": SERVE_SWAP_ROUNDS, "requests": len(sent),
            "seconds": swap_s, "swaps": swaps,
            "generations_served": len(served_gens),
            "captures": cap.get("cuda_graph", 0), "builds": 0,
            "rejections": pool.rejections,
            "rejected": type(pool.last_rejection).__name__,
            "p50_ms": hst["p50_ms"], "p99_ms": hst["p99_ms"],
            "torn_responses": 0}
        emit({"phase": "serving_hotswap", **res["hotswap"]})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- two tenants and a canary behind the router -------------------------
    last = max(gens.items(), key=lambda kv: kv[0][2])   # newest mtime
    cpipe = build({"centers": last[1]})
    primary = PredictServer(pipeline=pipe, name="primary")
    canary = PredictServer(pipeline=cpipe, name="canary")
    router = ModelRouter()
    router.add_tenant("bulk", primary, quota_rows=64)
    router.add_tenant("ui", primary)
    with router:
        primary.deadline_s = 1.0
        f1 = router.submit(x_host[:64], "bulk")
        try:
            router.submit(x_host[64:65], "bulk")
            shed = False
        except TenantQuotaExceeded:
            shed = True
        f2 = router.submit(x_host[:8], "ui")
        primary.deadline_s = 0.005
        check(shed and np.array_equal(f1.result(timeout=60).values.ravel(),
                                      labels_all[:64])
              and np.array_equal(f2.result(timeout=60).values.ravel(),
                                 labels_all[:8]),
              "serving: the quota did not shed the offender alone")
        router.set_canary("ui", canary, fraction=0.1)
        r_starts = draw.randint(0, KM_M - 8, SERVE_ROUTER_REQ)
        arms = [router.route("ui", x_host[s: s + 8], key=f"user{i}")[1]
                for i, s in enumerate(r_starts)]
        futs = [router.submit(x_host[s: s + 8], "ui", key=f"user{i}")
                for i, s in enumerate(r_starts)]
        c_labels = gen_labels[last[0]]
        for arm, s, f in zip(arms, r_starts, futs):
            want = c_labels if arm == "ui:canary" else labels_all
            check(np.array_equal(f.result(timeout=60).values.ravel(),
                                 want[s: s + 8]),
                  f"serving: a {arm} response differs from its model")
        share = arms.count("ui:canary") / len(arms)
        check(0.04 <= share <= 0.2, f"serving: canary share {share}")
        router.promote("ui")
        check(router.route("ui", x_host[:8], key="user0")[0] is canary,
              "serving: promote did not move the tenant")
        rst = router.stats()
    res["router"] = {"quota_shed": rst["bulk"]["quota_shed"],
                     "canary_fraction": 0.1, "canary_share": share,
                     "requests": SERVE_ROUTER_REQ,
                     "promotions": rst["ui"]["promotions"]}
    emit({"phase": "serving_router", **res["router"]})
    DEPLOY.update(x_host=x_host, kmeans=(pipe, sc, km, x_host[:max(
        SERVE_BUCKETS)].copy()))
    del X, XS, x_host, resp, hresp, sent, gen_labels, labels_all
    torch.cuda.empty_cache()

    # -- IVF retrieval under kernel ------------------------------------------
    ix, q = SERVED.pop("ivf")
    rpipe = RetrievalPipeline(ix, k=IVF_K, nprobe=IVF_PROBE,
                              overlap="kernel")
    want_d, want_i = (a.collect() for a in ix.search(
        q, k=IVF_K, nprobe=IVF_PROBE, overlap="kernel"))
    q_starts, q_sizes = cover_sizes(IVF_Q, SERVE_MAX_ROWS, 17)
    with PredictServer(pipeline=rpipe, name="ivf") as isrv:
        K.reset_launches()
        prof.reset_counters()
        t0 = time.perf_counter()
        iresp = drive_clients(lambda i: isrv.submit(
            q[q_starts[i]: q_starts[i] + q_sizes[i]]), len(q_sizes))
        ivf_s = time.perf_counter() - t0
        ilaunch = dict(K.LAUNCHES)
        ist = isrv.stats()
        ic = prof.counters()
    got = np.concatenate([r.values for r in iresp])
    check(np.array_equal(got[:, :IVF_K].astype(np.int32), want_i),
          "serving: IVF ids differ from IVFIndex.search")
    scale = float((q.astype(np.float64) ** 2).sum(1).max())
    d_err = float(np.abs(got[:, IVF_K:].astype(np.float64) ** 2
                         - want_d.astype(np.float64) ** 2).max())
    check(d_err <= 1e-5 * max(1.0, scale), f"serving: IVF d² off by {d_err}")
    check(ic["traces"] == 0 and ilaunch["panel_gemm"] == ist["batches"]
          and ist["dispatches_per_batch_max"] == 1,
          f"serving: IVF replays {ic}, launches {ilaunch}")
    for b in SERVE_BUCKETS:
        prog = rpipe.program(b)
        check(prog.mode == "graph" and torch.equal(
            prog.replay_device().clone(), prog.eager_device()),
            f"serving: IVF bucket {b}'s replay differs from its eager chain")
    res["ivf"] = {"queries": IVF_Q, "requests": len(q_sizes),
                  "seconds": ivf_s, "queries_per_s": IVF_Q / ivf_s,
                  "p50_ms": ist["p50_ms"], "p99_ms": ist["p99_ms"],
                  "batches": ist["batches"],
                  "bucket_cost_ms": ist["bucket_cost_ms"],
                  "launches": ilaunch, "d2_max_abs_err": d_err,
                  "ids_equal_search": True}
    emit({"phase": "serving_ivf", **res["ivf"]})
    gemm_launches, gemm_batches = ilaunch["panel_gemm"], ist["batches"]
    DEPLOY["ivf"] = (rpipe, q[:max(SERVE_BUCKETS)].copy())
    del ix, rpipe, iresp
    torch.cuda.empty_cache()

    # -- ALS fold-in ---------------------------------------------------------
    als, users = SERVED.pop("als")
    fpipe = SparseFoldInPipeline(als, nse_cap=SERVE_NSE_CAP, top_n=ALS_TOP)
    packed = fpipe.pack(users)
    want_ids, want_sc = als.fold_in(users, top_n=ALS_TOP)
    u_starts, u_sizes = cover_sizes(SERVE_FOLD_USERS, SERVE_MAX_ROWS, 19)
    with PredictServer(pipeline=fpipe, name="fold_in") as fsrv:
        prof.reset_counters()
        t0 = time.perf_counter()
        fresp = drive_clients(lambda i: fsrv.submit(
            packed[u_starts[i]: u_starts[i] + u_sizes[i]]), len(u_sizes))
        fold_s = time.perf_counter() - t0
        fst = fsrv.stats()
        fc = prof.counters()
    got = np.concatenate([r.values for r in fresp])
    sc_err = rel_err(got[:, ALS_TOP:], want_sc)
    check(sc_err <= 1e-4, f"serving: fold-in scores off ALS.fold_in by "
          f"{sc_err}")
    srt = want_sc.astype(np.float64)
    gap = 1e-3 * max(1.0, float(np.abs(srt).max()))
    d = -np.diff(srt, axis=1)
    apart = np.concatenate([d > gap, np.ones((len(srt), 1), bool)], axis=1) \
        & np.concatenate([np.ones((len(srt), 1), bool), d > gap], axis=1)
    bad = int(((got[:, :ALS_TOP].astype(np.int32) != want_ids)
               & apart).sum())
    check(bad == 0, f"serving: {bad} fold-in ids differ where apart")
    check(fc["traces"] == 0 and fst["dispatches_per_batch_max"] == 1,
          f"serving: fold-in replays {fc}")
    for b in SERVE_BUCKETS:
        prog = fpipe.program(b)
        check(prog.mode == "graph" and torch.equal(
            prog.replay_device().clone(), prog.eager_device()),
            f"serving: fold-in bucket {b}'s replay differs from eager")
    res["fold_in"] = {"users": SERVE_FOLD_USERS, "nse_cap": SERVE_NSE_CAP,
                      "top_n": ALS_TOP, "requests": len(u_sizes),
                      "seconds": fold_s, "users_per_s":
                      SERVE_FOLD_USERS / fold_s, "p50_ms": fst["p50_ms"],
                      "p99_ms": fst["p99_ms"], "batches": fst["batches"],
                      "score_err_vs_fold_in": sc_err}
    emit({"phase": "serving_fold_in", **res["fold_in"]})
    DEPLOY["fold_in"] = (fpipe, packed[:max(SERVE_BUCKETS)].copy())
    del als, users, fpipe, fresp

    # -- the two kernels at the served shapes, in and out of a graph --------
    g = torch.Generator(device=dev).manual_seed(5)
    cents = torch.from_numpy(np.asarray(km.centers_)).to(dev)
    shapes = {}
    for m in (1, SERVE_BUCKETS[-1]):
        a = torch.randn((m, KM_N), generator=g, device=dev)
        in_ms, gout, rec = graph_ms(lambda: K.distances_sq(a, cents),
                                    cuda_ms, 200)
        check(rec == {"distances_sq": 1}, f"serving: graph records {rec}")
        plain = K.distances_sq_plain(a, cents, "highest")
        scale = float((a.double() ** 2).sum(1).max()
                      + (cents.double() ** 2).sum(1).max())
        err = float((gout.double() - plain.double()).abs().max()) / scale
        check(err <= 1e-5 and torch.equal(gout, K.distances_sq(a, cents)),
              f"serving: distances_sq in a graph at m = {m}: error {err}")

        def cdist():
            with px.precise():
                return torch.cdist(a, cents,
                                   compute_mode="use_mm_for_euclid_dist")

        bms, bby = dist_bound(m, KM_K, KM_N,
                              4.0 * (m * KM_N + KM_K * KM_N + m * KM_K))
        shapes[f"{m}x{KM_K}x{KM_N}"] = {
            "ms_in_graph": in_ms,
            "ms_out_of_graph": cuda_ms(lambda: K.distances_sq(a, cents),
                                       200),
            "plain_ms": cuda_ms(lambda: K.distances_sq_plain(
                a, cents, "highest"), 200),
            "library_ms": cuda_ms(cdist, 200),
            "max_abs_err": float((gout - plain).abs().max()),
            "normalized_err_vs_plain": err,
            "bound_ms": bms, "bound_by": bby}
    big = shapes[f"{SERVE_BUCKETS[-1]}x{KM_K}x{KM_N}"]
    dist = {"name": "distances_sq", "at": "serving", "route": "cuda",
            "source": "dislib_tpu_torch/csrc/distances_sq.cu",
            "replaces": "dislib_tpu/ops/pallas_kernels.py:112",
            "shape": [SERVE_BUCKETS[-1], KM_K, KM_N],
            "launches": dist_launches,
            "launches_per_batch": dist_launches / max(1, dist_batches),
            "max_abs_err": big["max_abs_err"], "ms": big["ms_in_graph"],
            "ms_out_of_graph": big["ms_out_of_graph"],
            "plain_ms": big["plain_ms"], "library_ms": big["library_ms"],
            "library_call": "torch.cdist(a, b, compute_mode="
                            "'use_mm_for_euclid_dist'), TF32 off (includes "
                            "a square root)",
            "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
            "bound_basis": DIST_BOUND_BASIS, "by_shape": shapes,
            "card": card}
    emit({"phase": "kernel", **dist})
    ix_cents = torch.randn((IVF_D, IVF_LISTS), generator=g, device=dev)
    qa = torch.randn((SERVE_BUCKETS[-1], IVF_D), generator=g, device=dev)
    in_ms, gout, rec = graph_ms(lambda: K.panel_gemm(qa, ix_cents,
                                                     px.FLOAT32),
                                cuda_ms, 200)
    check(rec == {"panel_gemm": 1}, f"serving: graph records {rec}")
    plain = K.panel_gemm_plain(qa, ix_cents, px.FLOAT32)
    gscale = (torch.linalg.norm(qa.double())
              * torch.linalg.norm(ix_cents.double()) / IVF_D ** 0.5)
    gerr = float((gout.double() - plain.double()).abs().max() / gscale)
    gemm_tol = px.ERROR_BOUNDS[("matmul", "float32")]
    check(gerr <= gemm_tol and torch.equal(
        gout, K.panel_gemm(qa, ix_cents, px.FLOAT32)),
        f"serving: panel_gemm in a graph: normalized error {gerr}")

    def mm():
        with px.precise():
            return torch.mm(qa, ix_cents)

    mq, kk, nl = SERVE_BUCKETS[-1], IVF_D, IVF_LISTS
    gb_ms, gb_by = bound(3 * 2.0 * mq * kk * nl,
                         4.0 * (mq * kk + kk * nl + mq * nl),
                         PEAK_TF32_FLOPS)
    gemm = {"name": "panel_gemm", "at": "serving", "policy": "float32",
            "route": "cuda", "source": "dislib_tpu_torch/csrc/panel_gemm.cu",
            "replaces": "dislib_tpu/ops/pallas_kernels.py:76",
            "shape": [mq, kk, nl], "launches": gemm_launches,
            "launches_per_batch": gemm_launches / max(1, gemm_batches),
            "max_abs_err": float((gout - plain).abs().max()),
            "normalized_err_vs_plain": gerr, "ms": in_ms,
            "ms_out_of_graph": cuda_ms(lambda: K.panel_gemm(
                qa, ix_cents, px.FLOAT32), 200),
            "plain_ms": cuda_ms(lambda: K.panel_gemm_plain(
                qa, ix_cents, px.FLOAT32), 200),
            "library_ms": cuda_ms(mm, 200),
            "library_call": "torch.mm (f32, TF32 off)",
            "bound_ms": gb_ms, "bound_by": gb_by,
            "bound_basis": "3xTF32: three 2mkn TF32 tensor-core products "
                           "at 495 TFLOP/s; each operand read once, C "
                           "written once", "card": card}
    emit({"phase": "kernel", **gemm})
    emit({"phase": "serving", "seconds": time.perf_counter() - t_phase,
          **{k: v for k, v in res.items() if k in ("card", "buckets")}})
    phase_wall("serving", t_phase)
    return {"distances_sq/serving": dist, "panel_gemm/serving": gemm}


# the fresh process of the deploy phase: it loads one bundle (``bundle``
# mode, with an empty build directory and ``build_all`` refusing) or a
# saved scaler and model (``cold`` mode, building the kernels itself),
# serves the fixed rows at every bucket and prints one JSON line
DEPLOY_CHILD = r'''
import time
T0 = time.perf_counter()
import json
import sys
import tempfile
job = json.loads(sys.argv[1])
from dislib_tpu_torch import _build
_build.BUILD_DIR = tempfile.mkdtemp(prefix="chip_smoke_child_build_")
CALLS = []
if job["mode"] == "bundle":
    def _refuse():
        CALLS.append(1)
        raise RuntimeError("build_all called in a process that loads a "
                           "bundle")
    _build.build_all = _refuse
import numpy as np
import torch
import dislib_tpu_torch as dst
from dislib_tpu_torch.ops import kernels as K
from dislib_tpu_torch.utils import profiling as prof
t_import = time.perf_counter() - T0
dst.init(device=job["device"])
torch.zeros(1, device=job["device"]).sum().item()   # the device is up
t_device = time.perf_counter() - T0
rows = np.load(job["rows"])
if job["mode"] == "bundle":
    from dislib_tpu_torch.serving import load_bundle
    loaded = load_bundle(job["bundle"])
    pipe, buckets = loaded.pipeline, list(loaded.buckets)
else:
    from dislib_tpu_torch.serving import ServePipeline
    from dislib_tpu_torch.utils.saving import load_model
    pipe = ServePipeline(load_model(job["model"]),
                         transforms=(load_model(job["scaler"]),))
    buckets = job["buckets"]
    for b in buckets:
        pipe.program(b)
t_loaded = time.perf_counter() - T0
first = pipe.predict_bucket(rows[:buckets[0]], buckets[0])
t_first = time.perf_counter() - T0
want = np.load(job["want"])
equal = {str(b): bool(np.array_equal(pipe.predict_bucket(rows[:b], b),
                                      want[str(b)])) for b in buckets}
print(json.dumps({
    "mode": job["mode"], "import_s": t_import,
    "import_to_device_s": t_device, "import_to_loaded_s": t_loaded,
    "import_to_first_response_s": t_first, "bit_equal": equal,
    "first_equal": bool(np.array_equal(first, want[str(buckets[0])])),
    "build_all_calls": len(CALLS), "trace_by": prof.counters()["trace_by"],
    "modes": {str(b): pipe.program(b).mode for b in buckets},
    "launches": dict(K.LAUNCHES),
    "libraries": {name: path.startswith(_build.BUILD_DIR)
                  for name, path in _build._LOADED_FROM.items()}}),
    flush=True)
'''


def run_child(job, cwd):
    """Run DEPLOY_CHILD on ``job`` in a fresh ``python3`` from the
    checkout's root; (its JSON line, the process's wall seconds)."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-c", DEPLOY_CHILD, json.dumps(job)],
        capture_output=True, text=True, cwd=cwd, timeout=DEPLOY_CHILD_S,
        env=dict(os.environ, PYTHONPATH=os.path.dirname(
            os.path.abspath(__file__))))
    wall = time.perf_counter() - t0
    check(res.returncode == 0, f"deploy: the {job['mode']} child failed "
          f"(exit {res.returncode}):\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1]), wall


def deploy_phase(dev, card):
    """The deployment bundles and the continuous trainer on the card.

    Bundles: the serving phase's three pipelines (StandardScaler →
    KMeans 1M × 100 k = 10; the IVF index 1M × 64, 1,024 lists, nprobe 32,
    k 10 under ``kernel``; the ALS fold-in, n_f 16, 10,000 items,
    ``nse_cap`` 128, top 10) exported over the 1/8/64/512 ladder; each
    loaded by a fresh ``python3`` child whose build directory is empty
    and whose ``build_all`` refuses.  Gates: every bucket's response
    bit-equal to the live pipeline's, no ``nvcc`` build, ``build_all``
    never called, one capture a bucket, every program a graph.  The
    yardstick: a child with an empty build directory and no bundle that
    loads the saved scaler and KMeans (``load_model``), builds the kernels
    and captures the ladder (its responses bit-equal too).

    Trainer: ``ContinuousTrainer`` over ``MiniBatchKMeans(k=10)``,
    DEPLOY_BATCHES scaled 4096-row batches of the KMeans data a
    generation, DEPLOY_GENS generations, a ``FitCheckpoint``, scaler →
    model bundles, a ``ModelRouter`` tenant and a probe, with client
    requests through the router from the second generation on;
    ``TornBundleWrite(failures=1)`` in generation 2 and
    ``CanaryGateTrip(times=1)`` in generation 3.  Gates: the verdicts
    promoted, promoted (one export retry), rejected, promoted; the served
    generation monotone; every response equal to the direct predict of
    a generation exported so far (none torn); every ledger checksum its
    file's CRC; no ``nvcc`` build after the first generation.  Returns
    the launches of the deploy path's kernels: the trainer's and, per
    kernel, the loading children's."""
    import threading
    import numpy as np
    import torch
    import dislib_tpu_torch as dst
    from dislib_tpu_torch.cluster import MiniBatchKMeans
    from dislib_tpu_torch.ops import kernels as K
    from dislib_tpu_torch.runtime import ContinuousTrainer, read_bundle
    from dislib_tpu_torch.runtime.bundle_io import file_crc
    from dislib_tpu_torch.serving import ModelRouter, export_bundle
    from dislib_tpu_torch.serving import bundle as bundle_mod
    from dislib_tpu_torch.utils import faults
    from dislib_tpu_torch.utils import profiling as prof
    from dislib_tpu_torch.utils.checkpoint import FitCheckpoint
    from dislib_tpu_torch.utils.saving import save_model
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_deploy_")
    out = {"card": card, "buckets": list(SERVE_BUCKETS)}
    child_launches = {}
    try:
        # -- export, then a fresh process per bundle ---------------------
        bundles = {}
        pipe, sc, km, km_rows = DEPLOY["kmeans"]
        # the hand kernels each served chain launches (the fold-in's
        # products are library calls)
        for name, (live, rows), kernels_of in (
                ("kmeans", (pipe, km_rows), {"distances_sq"}),
                ("ivf", DEPLOY.pop("ivf"), {"panel_gemm"}),
                ("fold_in", DEPLOY.pop("fold_in"), set())):
            path = os.path.join(tmp, f"{name}.dsb.npz")
            t0 = time.perf_counter()
            man = export_bundle(live, path, buckets=SERVE_BUCKETS)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            crc = file_crc(path)
            crc_s = time.perf_counter() - t0
            want = {str(b): live.predict_bucket(rows[:b], b)
                    for b in SERVE_BUCKETS}
            np.save(os.path.join(tmp, f"{name}_rows.npy"), rows)
            np.savez(os.path.join(tmp, f"{name}_want.npz"), **want)
            job = {"mode": "bundle", "bundle": path, "device": str(dev),
                   "rows": os.path.join(tmp, f"{name}_rows.npy"),
                   "want": os.path.join(tmp, f"{name}_want.npz")}
            got, wall = run_child(job, root)
            check(all(got["bit_equal"].values()) and got["first_equal"],
                  f"deploy: the loaded {name} bundle differs from the live "
                  f"pipeline: {got['bit_equal']}")
            check(got["build_all_calls"] == 0 and got["trace_by"] ==
                  {"cuda_graph": len(SERVE_BUCKETS)}, f"deploy: the {name} "
                  f"child built or captured off the ladder: {got}")
            check(set(got["modes"].values()) == {"graph"},
                  f"deploy: {name} programs {got['modes']}")
            check(all(got["libraries"].values())
                  and kernels_of <= set(got["libraries"])
                  <= set(man["libraries"]),
                  f"deploy: the {name} child's libraries (installed from "
                  f"the bundle?) {got['libraries']}")
            for k, n in got["launches"].items():
                child_launches[k] = child_launches.get(k, 0) + n
            bundles[name] = {
                "bytes": os.path.getsize(path), "crc": crc,
                "export_s": export_s, "capture_s": man["walls"]["capture_s"],
                "write_s": man["walls"]["write_s"], "crc_s": crc_s,
                "library_bytes": {k: v["bytes"] for k, v in
                                  man["libraries"].items()},
                "child_wall_s": wall, "import_s": got["import_s"],
                "import_to_device_s": got["import_to_device_s"],
                "import_to_loaded_s": got["import_to_loaded_s"],
                "import_to_first_response_s":
                    got["import_to_first_response_s"],
                "captures": got["trace_by"].get("cuda_graph", 0),
                "nvcc_builds": 0, "launches": got["launches"],
                "bit_equal_to_live": True}
            emit({"phase": "deploy_bundle", "name": name, **bundles[name]})
        out["bundles"] = bundles

        # -- the yardstick: a cold start with no bundle -------------------
        for obj, fn in ((sc, "scaler.json"), (km, "kmeans.json")):
            save_model(obj, os.path.join(tmp, fn))
        job = {"mode": "cold", "device": str(dev),
               "scaler": os.path.join(tmp, "scaler.json"),
               "model": os.path.join(tmp, "kmeans.json"),
               "buckets": list(SERVE_BUCKETS),
               "rows": os.path.join(tmp, "kmeans_rows.npy"),
               "want": os.path.join(tmp, "kmeans_want.npz")}
        got, wall = run_child(job, root)
        check(all(got["bit_equal"].values()), "deploy: the cold child's "
              f"responses differ from the live pipeline: {got['bit_equal']}")
        builds = {k: n for k, n in got["trace_by"].items()
                  if k.startswith("nvcc:")}
        out["cold_start"] = {
            "child_wall_s": wall, "import_s": got["import_s"],
            "import_to_device_s": got["import_to_device_s"],
            "import_to_loaded_s": got["import_to_loaded_s"],
            "import_to_first_response_s": got["import_to_first_response_s"],
            "nvcc_builds": sum(builds.values()), "builds": builds,
            "captures": got["trace_by"].get("cuda_graph", 0)}
        emit({"phase": "deploy_cold_start", **out["cold_start"]})

        # -- the continuous trainer under client traffic --------------------
        x_host = DEPLOY.pop("x_host")
        n_batches = DEPLOY_GENS * DEPLOY_BATCHES

        def stream():
            for i in range(n_batches):
                rows = x_host[i * MBK_BATCH:(i + 1) * MBK_BATCH]
                yield sc.transform(dst.array(rows)).collect()

        est = MiniBatchKMeans(n_clusters=KM_K,
                              init=sc.transform(dst.array(
                                  x_host[:KM_K])).collect())
        router = ModelRouter(name="deploy")
        tr = ContinuousTrainer(
            est, stream(), FitCheckpoint(os.path.join(tmp, "ck.npz"),
                                         every=1, keep=2),
            lambda e, g: dst.serving.ServePipeline(
                e, transforms=(sc,), n_features=KM_N),
            os.path.join(tmp, "trainer"), router=router, tenant="km",
            buckets=SERVE_BUCKETS, batches_per_generation=DEPLOY_BATCHES,
            probe=x_host[-64:], name="deploy")
        draw = np.random.RandomState(23)
        n_max = 400_000
        sizes = draw.randint(1, SERVE_MAX_ROWS + 1, n_max)
        starts = draw.randint(0, KM_M - SERVE_MAX_ROWS, n_max)
        t_sub = np.zeros(n_max)
        stop = threading.Event()

        def submit(i):
            t_sub[i] = time.perf_counter()
            return router.submit(x_host[starts[i]: starts[i] + sizes[i]],
                                 "km", key=f"c{i}")

        box = {}

        def clients():
            try:
                box["resp"] = drive_clients(submit, n_max, stop=stop)
            except Exception as exc:    # noqa: BLE001 — checked below
                box["err"] = exc

        K.reset_launches()
        prof.reset_counters()
        records, windows, torn_writer = [], [], None
        real_write = bundle_mod.write_bundle
        th = threading.Thread(target=clients)
        with router:
            t0 = time.perf_counter()
            for g in range(1, DEPLOY_GENS + 1):
                if g == 2:
                    torn_writer = faults.TornBundleWrite(failures=1)
                    bundle_mod.write_bundle = torn_writer
                if g == 3:
                    tr.health_gate = faults.CanaryGateTrip(times=1)
                check(tr.train_generation(), "deploy: the stream ended")
                w0 = time.perf_counter()
                try:
                    records.append(tr.publish_generation())
                finally:
                    bundle_mod.write_bundle = real_write
                windows.append((w0, time.perf_counter()))
                if g == 1:
                    nvcc_gen1 = {k: n for k, n in
                                 prof.counters()["trace_by"].items()
                                 if k.startswith("nvcc:")}
                    th.start()
            train_s = time.perf_counter() - t0
            stop.set()
            th.join()
            launches = dict(K.LAUNCHES)
            counters = prof.counters()
            rstats = router.stats()
            tr.close()
        check("err" not in box, f"deploy: a client failed: {box.get('err')}")
        verdicts = [r["verdict"] for r in records]
        check(verdicts == ["promoted", "promoted", "rejected", "promoted"],
              f"deploy: trainer verdicts {verdicts}")
        check(records[1]["counters"]["export_retries"] == 1
              and torn_writer.calls == 2, "deploy: the torn export was not "
              f"retried once: {records[1]['counters']}")
        served = [r["served"] for r in records]
        check(served == sorted(served) == [1, 2, 2, 4],
              f"deploy: served generations {served}")
        for r in records:
            check(r["checksum"] == file_crc(r["path"]),
                  f"deploy: generation {r['generation']}'s ledger checksum")
        nvcc_after = {k: n - nvcc_gen1.get(k, 0) for k, n in
                      counters["trace_by"].items() if k.startswith("nvcc:")}
        check(not any(nvcc_after.values()), f"deploy: the trainer built "
              f"kernels after the first generation: {nvcc_after}")
        # every response against the direct predict of each generation
        XS = sc.transform(dst.array(x_host))
        gen_labels = {}
        for r in records:
            g = dst.KMeans(n_clusters=KM_K)
            g.centers_ = np.asarray(read_bundle(r["path"])[
                "state__centers"], np.float32)
            gen_labels[r["generation"]] = g.predict(XS).collect().ravel()
        del XS
        sent = [(i, r) for i, r in enumerate(box["resp"]) if r is not None]
        torn, answered = 0, {}
        lat, lat_promo = [], []
        for i, r in sent:
            s, k = starts[i], sizes[i]
            gens = [g for g, lab in gen_labels.items()
                    if np.array_equal(r.values.ravel(), lab[s: s + k])]
            if not gens:
                torn += 1
            for g in gens:
                answered[g] = answered.get(g, 0) + 1
            lat.append(r.latency_s)
            done = t_sub[i] + r.latency_s
            if any(a <= done <= b for a, b in windows[1:]):
                lat_promo.append(r.latency_s)
        check(torn == 0, f"deploy: {torn} responses match no generation's "
              "direct predict")
        check(len(sent) > 0 and lat_promo, "deploy: no client traffic "
              "during the promotions")
        out["trainer"] = {
            "generations": DEPLOY_GENS, "batches_per_generation":
            DEPLOY_BATCHES, "batch_rows": MBK_BATCH, "verdicts": verdicts,
            "served": served, "seconds": train_s,
            "export_s": [r["export_s"] for r in records],
            "promote_s": [r.get("promote_s") for r in records],
            "requests": len(sent), "torn_responses": 0,
            "responses_matching_generation": answered,
            "p50_ms": 1e3 * float(np.percentile(lat, 50)),
            "p99_ms": 1e3 * float(np.percentile(lat, 99)),
            "p99_ms_during_promotions":
                1e3 * float(np.percentile(lat_promo, 99)),
            "requests_during_promotions": len(lat_promo),
            "export_retries": records[-1]["counters"]["export_retries"],
            "canary_rejections":
                records[-1]["counters"]["canary_rejections"],
            "nvcc_builds_first_generation": sum(nvcc_gen1.values()),
            "nvcc_builds_after": 0, "captures": counters["trace_by"].get(
                "cuda_graph", 0), "launches": launches,
            "router": rstats.get("km", {})}
        emit({"phase": "deploy_trainer", **out["trainer"]})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    DEPLOY.clear()
    emit({"phase": "deploy", "seconds": time.perf_counter() - t_phase,
          "card": card})
    phase_wall("deploy", t_phase)
    return {"trainer": out["trainer"]["launches"], "children": child_launches}


# -- the mesh of ranks -----------------------------------------------------------

# the multi-rank phase: 4 gloo ranks on one card (NCCL takes one rank per
# card, so a world above one cannot run on a one-card machine); SUMMA at
# GEMM_N² and tsqr on (2, 2), KMeans (MESH_KM_ITERS steps, tol 0) and the
# ring kNN at bench_knn's sizes, the shuffle and the scalers of the KMeans
# data, tsqr at TSQR, random_svd and PCA at RSVD, and GaussianMixture at
# bench_gmm's size (MESH_GM_ITERS EM steps from the kmeans init, tol 0)
# on (4, 1)
MESH_WORLD = 4
MESH_KM_ITERS = 20
MESH_GM_ITERS = 5
# A.2b's calls against one rank's: R up to row signs and the scalers'
# statistics and rows within MESH_QR_TOL / MESH_SCALER_TOL (relative);
# the top singular values, the explained variance (relative to the
# largest), every component up to sign, the lower bound of GM from the
# kmeans init, and GM's weights, means, covariances and lower bound from
# one rank's kmeans init within MESH_A2B_TOL (absolute and relative)
MESH_QR_TOL = 1e-5
MESH_SCALER_TOL = 1e-5
MESH_A2B_TOL = 1e-4
MESH_RANK_S = 600          # the ranks' time limit, seconds
MESH_BACKEND = "gloo (one card, staged through the host)"
# one KMeans step from the same init against the one rank's: the centers
# within MESH_KM_TOL (the sums' order differs); a 20-step fit's inertia
# within MESH_KM_INERTIA (its centers drift apart as near-tie rows flip)
MESH_KM_TOL = 1e-4
MESH_KM_INERTIA = 1e-4
# A.2b's second part on (4, 1), each held to one rank's result under the
# CPU tests' gates (tests/test_torch_distributed.py): LinearRegression's
# coefficients and R² and MiniBatchKMeans' centers within MESH_A2B2_TOL
# (of the largest coefficient, absolutely for the centers and Lasso's
# coefficients), qr's R and the singular values (lanczos_svd's too)
# within MESH_QR_TOL of the largest, polar's U and H within ERROR_BOUNDS;
# the MiniBatchKMeans stream is MESH_MBK_BATCHES batches of MBK_BATCH
# rows, one epoch of the KMeans data; the search is the search phase's
# kNN grid (4 candidates × 3 folds) on _blobs(GS_M, GS_N, 8)
MESH_A2B2_TOL = 1e-5
MESH_MBK_BATCHES = -(-KM_M // MBK_BATCH)
# A.2b's part (ii) on (4, 1) at the main path's sizes, each held to one
# rank's fit under the CPU tests' gates: the 16-tree forest on
# bench_forest's 1M x 100 bit-equal, the 8-tree depth-8 regressor's
# edges bit-equal, each first differing split (all its ancestors equal)
# a near tie within MESH_A2B3_TOL of the node's sum of w·y², and its
# predictions within MESH_A2B3_TOL (absolutely and relatively) on the
# rows whose paths cross no differing split (its leaves are not
# compared: below a differing split the trees differ), DBSCAN
# the same partition of the core points (noise within 1 %), Daura's
# labels equal, and CascadeSVM's support vectors and iterations equal,
# α and the decision values within MESH_A2B3_TOL · 10
MESH_RF_T = RF_T
MESH_A2B3_TOL = 1e-5
MESH_GS_GRID = {"n_neighbors": [5, 15], "weights": ["uniform", "distance"]}
# A.2c at the one-card phases' sizes (bench.py's), each held to one rank's
# call in the same run: the SpMM (on (2, 2), B's columns split over
# 'cols', and on (4, 1)) within MESH_A2C_SPMM of the largest entry; sparse
# KMeans' first step within MESH_KM_TOL and a 20-step fit's inertia within
# MESH_KM_INERTIA; the sparse kNN's squared distances within 1e-5 of
# 2 max |x|² (the magnitudes that cancel) and its indices where the k-th
# and (k+1)-th distances stand apart; ALS's factors and RMSE, and an item
# half-step against float64, within MESH_A2C_ALS; the IVF search from one
# rank's labels and centers (ids at clear places, squared distances within
# DIST_TOL of max |q|² + max |x|²) and the full fit's recall@10 at least
# 0.95 and within MESH_A2C_RECALL of one rank's; sparse CascadeSVM's SVs
# and iterations equal and α within MESH_A2C_ALS
MESH_A2C_SPMM = 1e-5
MESH_A2C_ALS = 1e-4
MESH_A2C_RECALL = 0.01


def mesh_sizes():
    """The mesh phase's sizes, handed to the ranks in their job file."""
    return {"gemm_n": GEMM_N, "km_m": KM_M, "km_n": KM_N, "km_k": KM_K,
            "km_iters": MESH_KM_ITERS, "knn_mf": KNN_MF, "knn_n": KNN_N,
            "knn_mq": KNN_MQ, "knn_k": KNN_K, "tsqr": list(TSQR),
            "rsvd": list(RSVD), "rsvd_nsv": RSVD_NSV,
            "rsvd_iters": RSVD_ITERS, "gm_m": GM_M, "gm_n": GM_N,
            "gm_k": GM_K, "gm_iters": MESH_GM_ITERS, "lr": [LR_M, LR_N],
            "lasso": [LASSO_LMBD, LASSO_RHO, LASSO_ITERS],
            "mbk_batch": MBK_BATCH, "mbk_batches": MESH_MBK_BATCHES,
            "qr": list(QR_ECON), "svd": list(SVD_BLOCK),
            "polar": list(POLAR), "lanczos": list(LANCZOS),
            "lanczos_k": LANCZOS_K, "kron": [list(k) for k in KRON],
            "gs_m": GS_M, "gs_n": GS_N,
            "rf": [RF_M, RF_N, MESH_RF_T], "rr": [RR_T, RR_DEPTH],
            "db": [DB_M, DB_N, DB_EPS, DB_MIN], "da": [DA_M, DA_N, DA_CUT],
            "csvm": [CSVM_M, CSVM_N, CSVM_PART, CSVM_ITERS],
            "spmm": [SPMM_M, SPMM_K, SPMM_N, SPMM_DENSITY],
            "sv": [SV_M, SV_N, SV_NNZ], "skm": [SKM_K, SKM_ITERS],
            "sknn": [SKNN_Q, SKNN_K],
            "als": [ALS_M, ALS_N, ALS_NNZ, ALS_F, ALS_LAM, ALS_ITERS,
                    ALS_HOLD_I],
            "ivf": [IVF_M, IVF_D, IVF_Q, IVF_K, IVF_LISTS, IVF_PROBE,
                    IVF_ITERS, IVF_GATE_Q],
            "ssv": [CSVM_SP_M, CSVM_PART, CSVM_SP_ITERS]}


def mesh_data(which, z):
    """The mesh phase's host inputs at sizes ``z``, the same in the parent
    and in every rank: the KMeans data and init (bench.py's draw, seed
    0), the kNN fit rows and queries (bench_knn's, seed 1), tsqr's,
    random_svd's and GaussianMixture's data (bench_tsqr's,
    bench_randomsvd's and bench_gmm's draws, seed 0), the regressions'
    (:func:`lr_data`), qr's, polar's and svd's (bench_svd's rand, seed 0),
    lanczos_svd's (the linalg phase's, seed 6), kron's operands (seed 7)
    and the search's blobs."""
    import numpy as np
    if which == "kmeans":
        rng = np.random.RandomState(0)
        x = rng.rand(z["km_m"], z["km_n"]).astype(np.float32)
        return x, x[rng.choice(z["km_m"], z["km_k"], replace=False)].copy()
    if which == "tsqr":
        return np.random.RandomState(0).standard_normal(z["tsqr"]).astype(
            np.float32)
    if which == "rsvd":
        return (np.random.RandomState(0).standard_normal(z["rsvd"])
                * 0.95 ** np.arange(z["rsvd"][1])).astype(np.float32)
    if which == "gm":
        return np.random.RandomState(0).standard_normal(
            (z["gm_m"], z["gm_n"])).astype(np.float32)
    if which == "lr":
        return lr_data(*z["lr"])
    if which in ("qr", "polar"):
        return np.random.RandomState(0).standard_normal(z[which]).astype(
            np.float32)
    if which == "svd":                  # bench_svd's draw
        return np.random.RandomState(0).rand(*z["svd"]).astype(np.float32)
    if which == "lanczos":
        return (np.random.RandomState(6).standard_normal(z["lanczos"])
                * 0.9 ** np.arange(z["lanczos"][1])).astype(np.float32)
    if which == "kron":
        rng = np.random.RandomState(7)
        return tuple(rng.standard_normal(k).astype(np.float32)
                     for k in z["kron"])
    if which == "search":
        return blobs(z["gs_m"], z["gs_n"], 8)
    rng = np.random.RandomState(1)
    return (rng.rand(z["knn_mf"], z["knn_n"]).astype(np.float32),
            rng.rand(z["knn_mq"], z["knn_n"]).astype(np.float32))


def mesh_a2b3_data(z):
    """A.2b's part (ii)'s host inputs at sizes ``z``: the forest's draw
    (:func:`forest_data`), DBSCAN's ``blobs(m, n, 16, seed=4)``, Daura's
    ``blobs(m, n, 12, seed=7, std=0.05)`` and CascadeSVM's
    (:func:`csvm_data`) — the dbscan, daura and csvm phases' data."""
    return {"forest": forest_data(*z["rf"][:2]),
            "db": blobs(z["db"][0], z["db"][1], 16, seed=4)[0],
            "da": blobs(z["da"][0], z["da"][1], 12, seed=7, std=0.05)[0],
            "sv": csvm_data(*z["csvm"][:2])}


def mesh_a2b3_keys(z):
    """The :data:`MESH_ONE` key of each of A.2b's part (ii)'s fits."""
    return {"rf": ("rf", *z["rf"]), "rr": ("rr", *z["rf"][:2]),
            "db": ("dbscan", *z["db"][:2]), "da": ("daura", *z["da"][:2]),
            "sv": ("csvm", *z["csvm"])}


def mesh_a2b3_fits(dst, z, data, only=None):
    """The forest, the regressor, DBSCAN, Daura and CascadeSVM fitted on
    the default mesh as the main path's phases fit them (``only``: the
    names to fit)."""
    from dislib_tpu_torch.classification import CascadeSVM
    from dislib_tpu_torch.cluster import DBSCAN, Daura
    from dislib_tpu_torch.trees import (RandomForestClassifier,
                                        RandomForestRegressor)
    only = {"rf", "rr", "db", "da", "sv"} if only is None else set(only)
    out = {}
    x, y, yr = data["forest"]
    if only & {"rf", "rr"}:
        X = dst.array(x)
    if "rf" in only:
        out["rf"] = RandomForestClassifier(
            n_estimators=z["rf"][2], random_state=0).fit(X, dst.array(y))
    if "rr" in only:
        out["rr"] = RandomForestRegressor(
            n_estimators=z["rr"][0], max_depth=z["rr"][1],
            random_state=0).fit(X, dst.array(yr))
    if "db" in only:
        out["db"] = DBSCAN(eps=z["db"][2], min_samples=z["db"][3]).fit(
            dst.array(data["db"]))
    if "da" in only:
        out["da"] = Daura(cutoff=z["da"][2]).fit(dst.array(data["da"]))
    if "sv" in only:
        sx, sy = data["sv"]
        part, iters = z["csvm"][2:]
        out["sv"] = CascadeSVM(
            kernel="rbf", c=1.0, gamma=1.0 / sx.shape[1], max_iter=iters,
            check_convergence=False).fit(
                dst.array(sx, block_size=(part, sx.shape[1])),
                dst.array(sy[:, None], block_size=(part, 1)))
    return out


def mesh_a2b3_arrays(fits):
    """The fitted arrays of :func:`mesh_a2b3_fits`'s estimators as NumPy,
    the ones a world of one must reproduce bit for bit."""
    import numpy as np
    out = {}
    for k in ("rf", "rr"):
        est = fits[k]
        out[f"{k}_edges"] = est._edges.cpu().numpy()
        out[f"{k}_leaves"] = est._leaves.cpu().numpy()
        out[f"{k}_feats"], out[f"{k}_tbins"] = est._feats, est._tbins
    out["db_labels"] = fits["db"].labels_
    out["db_core"] = fits["db"].core_sample_indices_
    out["da_labels"] = fits["da"].labels_
    sv = fits["sv"]
    out["sv_idx"], out["sv_alpha"], out["sv_x"] = (sv._sv_idx, sv._sv_alpha,
                                                   sv._sv_x)
    out["sv_n_iter"] = np.int64(sv.n_iter_)
    return out


def mesh_a2c_data(z):
    """A.2c's host inputs at sizes ``z``, the same in the parent and in
    every rank: the sparse phase's SpMM operands (seed 0), the svmlight
    rows (seed 8) for sparse KMeans and the sparse kNN (its query rows,
    seed 9), bench_als_sparse's ratings, bench_ann's catalog and queries,
    and the sparse CascadeSVM's rows and labels (seeds 12, 13)."""
    import numpy as np
    import scipy.sparse as sp
    m, k, n, dens = z["spmm"]
    sm, sn, snnz = z["sv"]
    cols, vals, _ = svmlight_draw(sm, sn, snnz, seed=8)
    ivf_x, ivf_q = ivf_draw(*z["ivf"][:3], z["ivf"][4])
    cm = z["ssv"][0]
    c_cols, c_vals, _ = svmlight_draw(cm, sn, snnz, seed=12)
    ssv = draw_csr(c_cols, c_vals, sn)
    score = ssv @ np.random.RandomState(13).randn(sn)
    return {"spmm": sp.random(m, k, density=dens, random_state=0,
                              dtype=np.float32).tocsr(),
            "spmm_b": np.random.RandomState(0).rand(k, n).astype(np.float32),
            "sv": draw_csr(cols, vals, sn),
            "sknn_rows": np.sort(np.random.RandomState(9).choice(
                sm, z["sknn"][0], replace=False)),
            "als": als_ratings(*z["als"][:4]), "ivf_x": ivf_x,
            "ivf_q": ivf_q, "ssv": ssv,
            "ssv_y": (score > np.median(score)).astype(np.float32)[:, None]}


def mesh_a2c_fits(dst, z, data):
    """A.2c's calls on the default mesh, as the ranks make them: the SpMM,
    sparse KMeans (its init, one step from it, the fit), the sparse kNN
    (k + 1 neighbours, sparse and dense queries), ALS sparse and dense,
    the IVF index (fit, then searches under ``db`` and ``kernel``, k + 1)
    and sparse CascadeSVM.  Returns NumPy arrays, the ones a world of one
    must reproduce bit for bit, and the IVF index."""
    from dislib_tpu_torch.classification import CascadeSVM
    from dislib_tpu_torch.cluster import KMeans
    from dislib_tpu_torch.ops.spmm import spmm
    from dislib_tpu_torch.recommendation import ALS
    from dislib_tpu_torch.retrieval import IVFIndex
    out = {"spmm": spmm(dst.SparseArray.from_scipy(data["spmm"]),
                        dst.array(data["spmm_b"])).collect()}
    x = dst.SparseArray.from_scipy(data["sv"])
    k, iters = z["skm"]
    c0 = KMeans(n_clusters=k, random_state=0)._init_centers(x)
    out["skm_c0"] = c0.cpu().numpy()
    out["skm_centers1"] = KMeans(n_clusters=k, init=out["skm_c0"],
                                 max_iter=1, tol=0.0).fit(x).centers_
    km = KMeans(n_clusters=k, random_state=0, max_iter=iters,
                tol=0.0).fit(x)
    out["skm_centers"], out["skm_inertia"] = km.centers_, km.inertia_
    qs = x[data["sknn_rows"]]
    nn = dst.NearestNeighbors(n_neighbors=z["sknn"][1] + 1).fit(x)
    for name, q in (("sparse", qs), ("dense", qs.to_dense())):
        d, i = nn.kneighbors(q)
        out[f"sknn_{name}_d"], out[f"sknn_{name}_i"] = (d.collect(),
                                                        i.collect())
    a = dst.SparseArray.from_scipy(data["als"])
    _, _, _, f, lam, sweeps, _ = z["als"]
    for name, arr in (("sparse", a), ("dense", a.to_dense())):
        als = ALS(n_f=f, lambda_=lam, tol=0.0, max_iter=sweeps,
                  random_state=0).fit(arr)
        out[f"als_{name}_u"], out[f"als_{name}_v"] = als.users_, als.items_
        out[f"als_{name}_hist"] = als.history_
    _, _, _, kq, lists, nprobe, ivf_iters, _ = z["ivf"]
    ix = IVFIndex(n_lists=lists, nprobe=nprobe, kmeans_max_iter=ivf_iters,
                  random_state=0).fit(dst.array(data["ivf_x"]))
    out["ivf_labels"], out["ivf_centers"] = ix._labels_h, ix._centers_h
    q = dst.array(data["ivf_q"])
    for route in ("db", "kernel"):
        d, i = ix.search(q, k=kq + 1, overlap=route)
        out[f"ivf_{route}_d"], out[f"ivf_{route}_i"] = (d.collect(),
                                                        i.collect())
    cm, part, sv_iters = z["ssv"]
    sv = CascadeSVM(max_iter=sv_iters, check_convergence=False).fit(
        dst.SparseArray.from_scipy(data["ssv"], block_size=(
            part, data["ssv"].shape[1])), dst.array(data["ssv_y"]))
    out["ssv_idx"], out["ssv_alpha"] = sv._sv_idx, sv._sv_alpha
    out["ssv_n_iter"] = sv.n_iter_
    return out, ix


def mesh_operands(dev, n):
    """SUMMA's operands, drawn on ``dev`` from seed 11: the same tensors
    in every process on one kind of card."""
    import torch
    g = torch.Generator(device=dev).manual_seed(11)
    return (torch.randn((n, n), generator=g, device=dev),
            torch.randn((n, n), generator=g, device=dev))


def mesh_clear(od):
    """Positions j of the one-rank (k+1)-neighbour distances ``od`` whose
    neighbours j-1, j, j+1 are more than 1e-5 apart: where the index is
    the same whatever order sums the distance."""
    import numpy as np
    gap = np.diff(od, axis=1) > 1e-5
    return np.concatenate([gap[:, :1], gap[:, :-1] & gap[:, 1:]], axis=1)


def mesh_tie_gaps(rows, centers, got, want):
    """``|d²(x, c_got) − d²(x, c_want)|`` in float64 for each row ``x`` of
    ``rows`` whose label is ``got`` here and ``want`` on one rank: small
    where the two centers are a near tie for the row."""
    import numpy as np
    rows = np.asarray(rows, np.float64)
    d = ((rows[:, None, :] - np.asarray(centers, np.float64)[None]) ** 2
         ).sum(-1)
    i = np.arange(len(rows))
    return np.abs(d[i, got] - d[i, want])


def mesh_close(got, want, tol):
    """The largest ``|got − want| / (tol + tol·|want|)``: at most 1 when
    ``got`` is within ``tol`` of ``want``, absolutely and relatively."""
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / (tol + tol * np.abs(want))))


def mesh_signed_rows(r):
    """R with its rows signed so that its diagonal is non-negative."""
    import numpy as np
    r = np.asarray(r, np.float64)
    return r * np.where(np.diag(r) < 0, -1.0, 1.0)[:, None]


def mesh_signed_rows_by_max(c):
    """Each row of ``c`` signed so that its largest entry is positive."""
    import numpy as np
    c = np.asarray(c, np.float64)
    idx = np.abs(c).argmax(1)
    return c * np.where(c[np.arange(len(c)), idx] < 0, -1.0, 1.0)[:, None]


def mesh_timer(dev):
    """``ms(fn, reps)``: CUDA-event milliseconds a call on a card, wall
    milliseconds on the CPU (a rehearsal)."""
    import torch

    def ms(fn, reps):
        fn()
        if dev.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            return (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    return ms


def mesh_mbk_stream(dst, X, init, z, states=None, batches=None):
    """MiniBatchKMeans (k = ``len(init)``, from ``init``) over the first
    ``z["mbk_batches"]`` row slices of ``z["mbk_batch"]`` rows of ``X``,
    one ``partial_fit`` a slice; ``states`` (a list) collects the
    (centers, counts) after each batch, the host copies ``partial_fit``
    already read, and ``batches`` (a list) each slice's block on this
    rank, the rows the step consumed."""
    est = dst.MiniBatchKMeans(n_clusters=len(init), init=init,
                              batch_size=z["mbk_batch"])
    b = z["mbk_batch"]
    rows = min(X.shape[0], z["mbk_batches"] * b)
    for s0 in range(0, rows, b):
        xb = X[s0:min(s0 + b, rows), :]
        est.partial_fit(xb)
        if states is not None:
            states.append((est.centers_, est.counts_))
        if batches is not None:
            batches.append(xb._local)
    return est


def mesh_rank(argv) -> int:
    """One rank of the mesh phase (``chip_smoke.py --mesh-rank RANK DIR``):
    joins the gloo job of ``DIR/job.json``, runs the (2, 2) and (4, 1)
    scenarios against the parent's one-rank results (``DIR/*.npz``) and
    writes ``DIR/rank<RANK>.json``.  Every check raises, and the rank
    exits non-zero."""
    rank, work = int(argv[0]), argv[1]
    with open(os.path.join(work, "job.json")) as f:
        job = json.load(f)
    z = job["sizes"]
    import numpy as np
    import torch
    import torch.distributed as tdist
    import dislib_tpu_torch as dst
    from dislib_tpu_torch.ops import kernels as K
    from dislib_tpu_torch.ops import precision as px
    from dislib_tpu_torch.parallel import distributed as dd
    dev = torch.device(job["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    ms = mesh_timer(dev)
    out = {"rank": rank, "phases": {}, "windows": {}}
    dd.initialize(f"file://{os.path.join(work, 'store')}", job["world"], rank,
                  backend="gloo", device=dev, timeout=job["timeout_s"])

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def window(name, fns, reps):
        """Time ``fns`` (label -> call) on this rank while the others wait:
        the ranks take the card in turn, so the times are uncontended
        (the first barrier lets every rank finish its work before rank 0
        starts)."""
        sync()
        tdist.barrier()
        for r in range(job["world"]):
            if r == rank:
                out["windows"][name] = {k: ms(f, reps)
                                        for k, f in fns.items()}
            tdist.barrier()

    def run(name, fn):
        """Run a scenario with the launch counts set to 0 just before it
        and read just after; record its wall time, launches and
        collectives."""
        tdist.barrier()
        dd.reset_comm_stats()
        K.reset_launches()
        t0 = time.perf_counter()
        res = fn()
        sync()
        out["phases"][name] = {"wall_s": time.perf_counter() - t0,
                               "launches": dict(K.LAUNCHES),
                               "collectives": dd.comm_stats(), **res}

    # -- SUMMA on (2, 2) ---------------------------------------------------------
    mesh = dst.init((2, 2))
    r, c = mesh.coord
    n = z["gemm_n"]
    a_h, b_h = mesh_operands(dev, n)
    A, B = dst.array(a_h), dst.array(b_h)
    rs = slice(r * (n // 2), (r + 1) * (n // 2))
    cs = slice(c * (n // 2), (c + 1) * (n // 2))
    scale = float(torch.linalg.norm(a_h.double()) * torch.linalg.norm(
        b_h.double()) / n ** 0.5)
    for pol in (px.FLOAT32, px.BFLOAT16):
        box = {}

        def summa():
            box["c"] = dst.matmul(A, B, algorithm="summa", precision=pol)
            return {"shape": [n, n, n], "mesh": [2, 2]}

        run(f"summa_{pol.name}", summa)
        got = box.pop("c")._local
        # the one-rank product of this rank's rows and columns: one
        # panel_gemm over the whole K, what the one-rank SUMMA runs
        want = K.panel_gemm(a_h[rs].contiguous(), b_h[:, cs].contiguous(),
                            pol)
        err = float((got.double() - want.double()).abs().max()) / scale
        check(err <= px.ERROR_BOUNDS[("matmul", pol.name)],
              f"rank {rank}: SUMMA {pol.name} block off the one-rank "
              f"product by {err} (normalized)")
        out["phases"][f"summa_{pol.name}"]["normalized_err_vs_one_rank"] = err
        if dev.type == "cuda":
            check(out["phases"][f"summa_{pol.name}"]["launches"][
                "panel_gemm"] >= 2, f"rank {rank}: SUMMA {pol.name} did not "
                "launch panel_gemm per panel")
        del got, want
        # the kernel at the panel's shape, with the card to itself
        a_p = A._local.contiguous()
        b_p = B._local.contiguous()
        kern = K.panel_gemm(a_p, b_p, pol)
        plain = K.panel_gemm_plain(a_p, b_p, pol)
        # the difference in f32: four ranks share the card's memory
        g_abs = float((kern - plain).abs().max())
        g_err = g_abs / float(torch.linalg.norm(a_p.double())
                              * torch.linalg.norm(b_p.double())
                              / a_p.shape[1] ** 0.5)
        check(g_err <= px.ERROR_BOUNDS[("matmul", pol.name)],
              f"rank {rank}: panel_gemm {pol.name} at SUMMA's panel "
              f"{list(a_p.shape)}x{list(b_p.shape)}: normalized error "
              f"{g_err} vs plain > ERROR_BOUNDS")
        out["windows"][f"panel_gemm_{pol.name}_err"] = {
            "max_abs_err": g_abs, "normalized_err_vs_plain": g_err}
        del kern, plain
        if pol is px.FLOAT32:
            def lib(a=a_p, b=b_p):
                with px.precise():
                    return torch.matmul(a, b)
        else:
            a16, b16 = a_p.to(torch.bfloat16), b_p.to(torch.bfloat16)

            def lib(a=a16, b=b16):
                if dev.type == "cuda":
                    return torch.mm(a, b, out_dtype=torch.float32)
                return torch.mm(a.float(), b.float())
        window(f"panel_gemm_{pol.name}", {
            "ms": lambda: K.panel_gemm(a_p, b_p, pol),
            "plain_ms": lambda: K.panel_gemm_plain(a_p, b_p, pol),
            "library_ms": lib}, 3)
        del a_p, b_p, lib
    del A, B, a_h, b_h
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- tsqr on (2, 2) and on (4, 1) ---------------------------------------------
    one = dict(np.load(os.path.join(work, "a2b.npz")))
    x_t = mesh_data("tsqr", z)

    def tsqr_on(shape):
        """tsqr of bench_tsqr's data on a ``shape`` mesh: orthogonality
        and residual from each rank's rows (one ``psum`` each), R
        against one rank's up to row signs."""
        mesh = dst.init(shape)
        T = dst.array(x_t)
        name = f"tsqr_{shape[0]}x{shape[1]}"
        t0 = time.perf_counter()
        dst.tsqr(T)                 # the rank's first factorisations: warm
        sync()
        first_s = time.perf_counter() - t0

        def call():
            box[name] = dst.tsqr(T)
            return {"shape": z["tsqr"], "mesh": list(shape),
                    "first_call_s": first_s}

        run(name, call)
        q, r = box.pop(name)
        qr_rows = q._row_block().double()[:, :z["tsqr"][1]]
        r_t = torch.from_numpy(r.collect()).to(dev).double()
        a_rows = T._row_block().double()[:, :z["tsqr"][1]]
        gram = dd.psum(qr_rows.T @ qr_rows, "rows", mesh)
        sq = dd.psum(torch.stack([((qr_rows @ r_t - a_rows) ** 2).sum(),
                                  (a_rows ** 2).sum()]), "rows", mesh)
        orth = float((gram - torch.eye(gram.shape[0], device=dev,
                                       dtype=gram.dtype)).abs().max())
        resid = float(torch.sqrt(sq[0] / sq[1]))
        r_err = float(np.abs(mesh_signed_rows(r.collect())
                             - mesh_signed_rows(one["tsqr_r"])).max()
                      / np.abs(one["tsqr_r"]).max())
        check(orth <= px.ERROR_BOUNDS[("tsqr_orth", "float32")]
              and resid <= px.ERROR_BOUNDS[("tsqr_resid", "float32")]
              and r_err <= MESH_QR_TOL,
              f"rank {rank}: tsqr on {shape}: orth {orth}, resid {resid}, "
              f"R off one rank's by {r_err}")
        out["phases"][name].update(orth_err=orth, resid=resid,
                                   r_rel_err_vs_one_rank=r_err)

    tsqr_on((2, 2))
    tsqr_on((4, 1))
    del x_t

    # -- KMeans, the ring kNN and the shuffle on (4, 1) -------------------------
    dst.init((4, 1))
    x_h, init = mesh_data("kmeans", z)
    km_m, km_k = z["km_m"], z["km_k"]
    X = dst.array(x_h)
    row0, m_loc = X._at[0], X._local.shape[0]
    ref = np.load(os.path.join(work, "kmeans.npz"))
    box = {}

    def kmeans():
        box["km"] = dst.KMeans(n_clusters=km_k, init=init, max_iter=z[
            "km_iters"], tol=0.0).fit(X)
        return {"shape": list(x_h.shape), "k": km_k, "mesh": [4, 1],
                "iters": z["km_iters"]}

    run("kmeans", kmeans)
    km = box.pop("km")
    c_err = float(np.abs(km.centers_ - ref["centers"]).max())
    inertia_err = abs(km.inertia_ - float(ref["inertia"])) / float(
        ref["inertia"])
    check(inertia_err <= MESH_KM_INERTIA, f"rank {rank}: a {z['km_iters']}"
          f"-step fit's inertia off the one-rank fit's by {inertia_err}")
    # the gate: one step from the same init against the one rank's step
    km1 = dst.KMeans(n_clusters=km_k, init=init, max_iter=1, tol=0.0).fit(X)
    c1_err = float(np.abs(km1.centers_ - ref["centers1"]).max())
    check(c1_err <= MESH_KM_TOL, f"rank {rank}: one KMeans step's centers "
          f"off the one-rank step's by {c1_err}")
    labels = km1.predict(X)._local[:, 0].cpu().numpy()
    live = max(0, min(m_loc, km_m - row0))
    lab_ref = ref["labels1"][row0:row0 + live]
    diff = np.nonzero(labels[:live] != lab_ref)[0]
    # a differing label must be a near tie of the two centers
    if len(diff):
        gap = mesh_tie_gaps(x_h[row0 + diff], km1.centers_, labels[diff],
                            lab_ref[diff])
        check(bool((gap <= 1e-4).all()), f"rank {rank}: {len(diff)} labels "
              f"differ from the one-rank step's, gaps up to {gap.max()}")
    del km1
    if dev.type == "cuda":
        check(out["phases"]["kmeans"]["launches"]["distances_sq"]
              >= z["km_iters"], f"rank {rank}: KMeans did not launch "
              "distances_sq once a step")
    out["phases"]["kmeans"].update(
        centers_max_abs_diff_vs_one_rank=c_err,
        one_step_centers_max_abs_err_vs_one_rank=c1_err,
        one_step_labels_differing=len(diff),
        inertia_rel_err_vs_one_rank=inertia_err, rows=live)
    xl = X._local.contiguous()
    centers = torch.from_numpy(km.centers_).to(dev)
    kern, plain = K.distances_sq(xl, centers), K.distances_sq_plain(
        xl, centers, "highest")
    d_scale = float((xl.double() ** 2).sum(1).max()
                    + (centers.double() ** 2).sum(1).max())
    k_err = float((kern.double() - plain.double()).abs().max()) / d_scale
    check(k_err <= DIST_TOL, f"rank {rank}: distances_sq at "
          f"{list(xl.shape)}x{list(centers.shape)}: error {k_err} vs plain "
          f"> {DIST_TOL}")
    out["windows"]["distances_sq_err"] = {
        "max_abs_err": float((kern - plain).abs().max()),
        "normalized_err_vs_plain": k_err}
    del kern, plain

    def cdist():
        with px.precise():
            return torch.cdist(xl, centers,
                               compute_mode="use_mm_for_euclid_dist")

    window("distances_sq", {
        "ms": lambda: K.distances_sq(xl, centers),
        "plain_ms": lambda: K.distances_sq_plain(xl, centers, "highest"),
        "library_ms": cdist}, 20)
    del xl

    def shuffle():
        box["xs"] = dst.shuffle(X, random_state=0)
        return {"shape": list(x_h.shape), "mesh": [4, 1]}

    run("shuffle", shuffle)
    perm = np.random.RandomState(0).permutation(km_m)
    got = box.pop("xs")._local[:live, :z["km_n"]].cpu().numpy()
    check(np.array_equal(got, x_h[perm[row0:row0 + live]]),
          f"rank {rank}: the shuffle's rows are not NumPy's permutation")
    del got

    # the scalers: their statistics against one rank's, and this rank's
    # rows against the same transform in float64 from one rank's
    # statistics
    def scalers():
        box["std"] = dst.StandardScaler()
        box["std_t"] = box["std"].fit_transform(X)
        box["mm"] = dst.MinMaxScaler()
        box["mm_t"] = box["mm"].fit_transform(X)
        return {"shape": list(x_h.shape), "mesh": [4, 1]}

    run("scalers", scalers)
    rows64 = x_h[row0:row0 + live].astype(np.float64)
    std, mm = box.pop("std"), box.pop("mm")
    sc = {"std_mean": mesh_close(std.mean_.collect(), one["std_mean"],
                                 MESH_SCALER_TOL),
          "std_var": mesh_close(std.var_.collect(), one["std_var"],
                                MESH_SCALER_TOL),
          "mm_min": mesh_close(mm.data_min_.collect(), one["mm_min"],
                               MESH_SCALER_TOL),
          "mm_max": mesh_close(mm.data_max_.collect(), one["mm_max"],
                               MESH_SCALER_TOL),
          "std_rows": mesh_close(
              box.pop("std_t")._local[:live, :z["km_n"]].cpu().numpy(),
              (rows64 - one["std_mean"]) / np.sqrt(one["std_var"]),
              MESH_SCALER_TOL),
          "mm_rows": mesh_close(
              box.pop("mm_t")._local[:live, :z["km_n"]].cpu().numpy(),
              (rows64 - one["mm_min"]) / (one["mm_max"] - one["mm_min"]),
              MESH_SCALER_TOL)}
    check(max(sc.values()) <= 1.0, f"rank {rank}: the scalers off one "
          f"rank's by {sc} of {MESH_SCALER_TOL} (absolute and relative)")
    out["phases"]["scalers"]["err_of_tol_vs_one_rank"] = sc
    del X, x_h, rows64, std, mm
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    f_h, q_h = mesh_data("knn", z)
    knn_k = z["knn_k"]
    F, Q = dst.array(f_h), dst.array(q_h)
    ref = np.load(os.path.join(work, "knn.npz"))
    q0 = Q._at[0]
    q_loc = max(0, min(Q._local.shape[0], z["knn_mq"] - q0))

    def ring():
        box["nn"] = dst.NearestNeighbors(n_neighbors=knn_k).fit(
            F).kneighbors(Q)
        return {"fit_rows": z["knn_mf"], "queries": z["knn_mq"], "k": knn_k,
                "mesh": [4, 1]}

    run("ring_knn", ring)
    d_arr, i_arr = box.pop("nn")
    rd = d_arr._local[:q_loc, :knn_k].cpu().numpy()
    ri = i_arr._local[:q_loc, :knn_k].cpu().numpy()
    od, oi = ref["dist"][q0:q0 + q_loc], ref["idx"][q0:q0 + q_loc]
    d_err = float(np.abs(rd - od[:, :knn_k]).max())
    check(d_err <= 1e-5, f"rank {rank}: ring distances off the one-rank "
          f"kneighbors by {d_err}")
    clear = mesh_clear(od)
    check(np.array_equal(ri[clear], oi[:, :knn_k][clear]),
          f"rank {rank}: ring indices differ from the one-rank kneighbors "
          f"at {int((ri[clear] != oi[:, :knn_k][clear]).sum())} clear places")
    if dev.type == "cuda":
        check(out["phases"]["ring_knn"]["launches"]["panel_gemm"]
              == job["world"], f"rank {rank}: the ring did not launch "
              "panel_gemm once a hop")
    out["phases"]["ring_knn"].update(max_abs_dist_err_vs_one_rank=d_err,
                                     clear_places=int(clear.sum()))
    qd = Q._local.contiguous()
    ft = F._local.T.contiguous()
    kern = K.panel_gemm(qd, ft, px.FLOAT32)
    plain = K.panel_gemm_plain(qd, ft, px.FLOAT32)
    g_abs = float((kern - plain).abs().max())
    g_err = g_abs / float(torch.linalg.norm(qd.double())
                          * torch.linalg.norm(ft.double())
                          / qd.shape[1] ** 0.5)
    check(g_err <= px.ERROR_BOUNDS[("matmul", "float32")],
          f"rank {rank}: panel_gemm at the ring's {list(qd.shape)}x"
          f"{list(ft.shape)}: normalized error {g_err} vs plain > "
          "ERROR_BOUNDS")
    out["windows"]["panel_gemm_ring_err"] = {
        "max_abs_err": g_abs, "normalized_err_vs_plain": g_err}
    del kern, plain

    def mm():
        with px.precise():
            return torch.mm(qd, ft)

    window("panel_gemm_ring", {
        "ms": lambda: K.panel_gemm(qd, ft, px.FLOAT32),
        "plain_ms": lambda: K.panel_gemm_plain(qd, ft, px.FLOAT32),
        "library_ms": mm}, 10)
    ring_shape = [int(qd.shape[0]), int(qd.shape[1]), int(ft.shape[1])]
    del F, Q, qd, ft
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- random_svd and PCA on bench_randomsvd's data, (4, 1) -------------------
    S = dst.array(mesh_data("rsvd", z))
    nsv = z["rsvd_nsv"]

    def rsvd():
        box["svd"] = dst.random_svd(S, iters=z["rsvd_iters"], nsv=nsv,
                                    oversample=10, random_state=0)
        return {"shape": z["rsvd"], "nsv": nsv, "mesh": [4, 1]}

    run("random_svd", rsvd)
    sv = box.pop("svd")[1].collect().ravel()
    s_err = float(np.abs(sv - one["rsvd_s"]).max() / one["rsvd_s"][0])
    check(s_err <= MESH_A2B_TOL, f"rank {rank}: random_svd's {nsv} values "
          f"off one rank's by {s_err} of the largest")
    out["phases"]["random_svd"]["values_rel_err_vs_one_rank"] = s_err

    def pca():
        box["pca"] = dst.PCA(n_components=nsv).fit(S)
        return {"shape": z["rsvd"], "n_components": nsv, "mesh": [4, 1]}

    run("pca", pca)
    est = box.pop("pca")
    var = est.explained_variance_.collect().ravel()
    v_err = float(np.abs(var - one["pca_var"]).max() / one["pca_var"][0])
    c_diff = np.abs(mesh_signed_rows_by_max(est.components_.collect())
                    - mesh_signed_rows_by_max(one["pca_comp"])).max(1)
    c_err = float(c_diff.max())
    check(v_err <= MESH_A2B_TOL and c_err <= MESH_A2B_TOL,
          f"rank {rank}: PCA's explained variance off one rank's by {v_err} "
          f"of the largest, its components by {c_err}")
    out["phases"]["pca"].update(
        variance_rel_err_vs_one_rank=v_err,
        components_max_abs_err_vs_one_rank=c_err)
    del S, est

    # -- GaussianMixture at bench_gmm's size, (4, 1) -----------------------------
    # from the kmeans init (the main path), held by its lower bound; then
    # the init against one rank's (its first Lloyd step's centers, every
    # differing label a near tie, and the labels it ends with, counted),
    # and EM from one rank's init responsibilities, held whole: the fit
    # differs from one rank's through its init alone
    from dislib_tpu_torch.cluster import gm as gm_mod
    G = dst.array(mesh_data("gm", z))
    gm_k, gm_n = z["gm_k"], z["gm_n"]
    row0 = G._at[0]
    live = max(0, min(G._local.shape[0], z["gm_m"] - row0))

    def gm():
        box["gm"] = dst.GaussianMixture(n_components=gm_k, max_iter=z[
            "gm_iters"], tol=0.0, random_state=0).fit(G)
        return {"shape": [z["gm_m"], gm_n], "k": gm_k, "mesh": [4, 1],
                "iters": z["gm_iters"], "init": "kmeans",
                "covariance_type": "full"}

    run("gm", gm)
    est = box.pop("gm")
    lb_err = mesh_close(est.lower_bound_, one["gm_lb"], MESH_A2B_TOL)
    check(lb_err <= 1.0 and est.n_iter_ == z["gm_iters"],
          f"rank {rank}: GaussianMixture's lower bound off one rank's by "
          f"{lb_err} of {MESH_A2B_TOL}, n_iter {est.n_iter_}")
    gm_launch = out["phases"]["gm"]["launches"]["distances_sq"]
    if dev.type == "cuda":
        check(1 <= gm_launch <= 11, f"rank {rank}: GM's kmeans init "
              f"launched distances_sq {gm_launch} times (1 to 11)")
    out["phases"]["gm"].update(
        lower_bound_err_of_tol_vs_one_rank=lb_err,
        max_abs_diff_vs_one_rank={
            "weights": float(np.abs(est.weights_ - one["gm_weights"]).max()),
            "means": float(np.abs(est.means_ - one["gm_means"]).max()),
            "covariances": float(np.abs(est.covariances_
                                        - one["gm_covs"]).max())})
    c0 = dst.KMeans(n_clusters=gm_k, max_iter=10, tol=1e-4,
                    random_state=0)._init_centers(G).cpu().numpy()
    check(np.array_equal(c0, one["gmi_c0"]), f"rank {rank}: GM's kmeans "
          "init starts from other centers than one rank's")
    step1 = dst.KMeans(n_clusters=gm_k, init=c0, max_iter=1, tol=0.0).fit(G)
    i_err = float(np.abs(step1.centers_ - one["gmi_centers1"]).max())
    check(i_err <= MESH_KM_TOL, f"rank {rank}: the GM init's first Lloyd "
          f"step's centers off the one-rank step's by {i_err}")
    lab = step1.predict(G)._local[:live, 0].cpu().numpy()
    lab_ref = one["gmi_labels1"][row0:row0 + live].astype(np.int64)
    diff = np.nonzero(lab != lab_ref)[0]
    gap = mesh_tie_gaps(G._local[diff][:, :gm_n].cpu().numpy(),
                        step1.centers_, lab[diff], lab_ref[diff]) \
        if len(diff) else np.zeros(1)
    check(bool((gap <= 1e-4).all()), f"rank {rank}: {len(diff)} labels of "
          f"the GM init's first step differ from one rank's, gaps up to "
          f"{gap.max()}")
    resp_own = est._init_resp(G)[:live].argmax(1).cpu().numpy()
    lab_init = one["gmi_labels"][row0:row0 + live].astype(np.int64)
    init_diff = int((resp_own != lab_init).sum())
    resp = torch.zeros((G._local.shape[0], gm_k), device=dev)
    resp[:live] = torch.nn.functional.one_hot(
        torch.from_numpy(lab_init).to(dev), gm_k).to(torch.float32)

    def gm_one_init():
        box["gmo"] = gm_mod._gm_fit(
            G._row_block(), G.shape, resp, "full", float(est.reg_covar),
            0.0, z["gm_iters"], mesh=G._mesh, row0=row0)[:5]
        return {"shape": [z["gm_m"], gm_n], "k": gm_k, "mesh": [4, 1],
                "iters": z["gm_iters"], "init": "one rank's kmeans init",
                "covariance_type": "full"}

    run("gm_from_one_rank_init", gm_one_init)
    w, mu, cv, lb, n_it = (t.cpu().numpy() for t in box.pop("gmo"))
    g_err = {"weights": mesh_close(w, one["gm_weights"], MESH_A2B_TOL),
             "means": mesh_close(mu, one["gm_means"], MESH_A2B_TOL),
             "covariances": mesh_close(cv, one["gm_covs"], MESH_A2B_TOL),
             "lower_bound": mesh_close(lb, one["gm_lb"], MESH_A2B_TOL)}
    check(max(g_err.values()) <= 1.0 and int(n_it) == z["gm_iters"],
          f"rank {rank}: GaussianMixture from one rank's kmeans init off "
          f"one rank's fit by {g_err} of {MESH_A2B_TOL} (absolute and "
          f"relative), n_iter {int(n_it)}")
    out["phases"]["gm_from_one_rank_init"]["err_of_tol_vs_one_rank"] = g_err
    out["phases"]["gm"]["init_vs_one_rank"] = {
        "rows": live, "first_step_centers_max_abs_err": i_err,
        "first_step_labels_differing": len(diff),
        "first_step_max_tie_gap": float(gap.max()),
        "labels_differing_after_init": init_diff}
    del resp, step1
    # distances_sq at the kmeans init's per-rank shape (d = 50: the
    # slices), held to its plain version and timed with the card to itself
    xg = G._local[:, :gm_n].contiguous()
    cg = torch.from_numpy(est.means_).to(dev).contiguous()
    kern, plain = K.distances_sq(xg, cg), K.distances_sq_plain(
        xg, cg, "highest")
    g_scale = float((xg.double() ** 2).sum(1).max()
                    + (cg.double() ** 2).sum(1).max())
    k_err = float((kern.double() - plain.double()).abs().max()) / g_scale
    check(k_err <= DIST_TOL, f"rank {rank}: distances_sq at "
          f"{list(xg.shape)}x{list(cg.shape)}: error {k_err} vs plain > "
          f"{DIST_TOL}")
    out["windows"]["distances_sq_gm_err"] = {
        "max_abs_err": float((kern - plain).abs().max()),
        "normalized_err_vs_plain": k_err}
    del kern, plain

    def cdist_gm():
        with px.precise():
            return torch.cdist(xg, cg, compute_mode="use_mm_for_euclid_dist")

    window("distances_sq_gm", {
        "ms": lambda: K.distances_sq(xg, cg),
        "plain_ms": lambda: K.distances_sq_plain(xg, cg, "highest"),
        "library_ms": cdist_gm}, 20)
    xg_shape = tuple(xg.shape)
    del xg, cg, G, est
    shapes = mesh_rank_a2b2(rank, z, dev, work, run, window, out)
    shapes.update(mesh_rank_a2b3(rank, z, dev, work, run, window, out))
    shapes.update(mesh_rank_a2c(rank, z, dev, work, run, window, out))
    out["shapes"] = {"summa_panel": [n // 2] * 3,
                     "kmeans": [m_loc, km_k, z["km_n"]],
                     "ring": ring_shape,
                     "gm_init": [int(xg_shape[0]), gm_k, gm_n], **shapes}
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dd.shutdown()
    return 0


def mesh_rank_a2b2(rank, z, dev, work, run, window, out):
    """A.2b's second part on (4, 1), in one rank of the mesh phase, each
    call held to the one-rank result of ``work/a2b2.npz`` under the CPU
    tests' gates: LinearRegression and Lasso (the one-rank fit with the
    same 4 agents, equal ``n_iter_``), the MiniBatchKMeans stream, qr's
    panel loop, svd's block tier, polar, lanczos_svd, kron (bit-equal to
    ``np.kron``) and the search over the kNN classifier (its scores and
    host reads); ``distances_sq`` at the stream's per-rank batch and
    ``panel_gemm`` at the search's ring hop against their plain versions,
    timed with the card to this rank.  ``run``/``window``/``out`` are
    :func:`mesh_rank`'s.  Returns the two per-rank kernel shapes."""
    import numpy as np
    import torch
    import dislib_tpu_torch as dst
    from dislib_tpu_torch.ops import kernels as K
    from dislib_tpu_torch.ops import precision as px
    from dislib_tpu_torch.parallel import distributed as dd
    from dislib_tpu_torch.utils import profiling as prof
    one = dict(np.load(os.path.join(work, "a2b2.npz")))
    mesh = dst.init((4, 1))
    box = {}
    ph = out["phases"]

    def rel(got, want):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        return float(np.abs(got - want).max() / np.abs(want).max())

    # -- LinearRegression and Lasso on LR_M x LR_N ---------------------------
    lx, ly, lyl = mesh_data("lr", z)
    LX, LY, LYL = dst.array(lx), dst.array(ly), dst.array(lyl)
    del lx, ly, lyl

    def lr():
        box["lr"] = dst.LinearRegression().fit(LX, LY)
        return {"shape": z["lr"], "mesh": [4, 1]}

    run("linear_regression", lr)
    est = box.pop("lr")
    c_err = rel(np.concatenate([est.coef_.ravel(), est.intercept_.ravel()]),
                np.concatenate([one["lr_coef"].ravel(),
                                one["lr_intercept"].ravel()]))
    r2_err = rel(est.score(LX, LY), one["lr_r2"])
    check(c_err <= MESH_A2B2_TOL and r2_err <= MESH_A2B2_TOL,
          f"rank {rank}: LinearRegression off one rank's by {c_err} "
          f"(coefficients, of the largest), {r2_err} (R², relative)")
    ph["linear_regression"].update(coef_rel_err_vs_one_rank=c_err,
                                   r2_rel_err_vs_one_rank=r2_err)

    def lasso():
        box["la"] = dst.Lasso(lmbd=z["lasso"][0], rho=z["lasso"][1],
                              max_iter=int(z["lasso"][2])).fit(LX, LYL)
        return {"shape": z["lr"], "mesh": [4, 1], "agents": 4}

    run("lasso", lasso)
    la = box.pop("la")
    l_err = float(np.abs(la.coef_ - one["lasso_coef"]).max())
    check(la.n_iter_ == int(one["lasso_n_iter"]) and l_err <= MESH_A2B2_TOL,
          f"rank {rank}: Lasso ran {la.n_iter_} iterations (one rank with "
          f"4 agents {int(one['lasso_n_iter'])}), coef off by {l_err}")
    ph["lasso"].update(n_iter=la.n_iter_, coef_max_abs_err_vs_one_rank=l_err)
    del LX, LY, LYL, est, la

    # -- the MiniBatchKMeans stream over the KMeans data ---------------------
    x_h, init = mesh_data("kmeans", z)
    X = dst.array(x_h)

    mbk_batches = []

    def mbk():
        box["mbk"] = mesh_mbk_stream(dst, X, init, z, batches=mbk_batches)
        return {"shape": [z["km_m"], z["km_n"]], "mesh": [4, 1],
                "batch": z["mbk_batch"], "batches": z["mbk_batches"]}

    run("minibatch_kmeans", mbk)
    est = box.pop("mbk")
    n_rows = min(z["km_m"], z["mbk_batches"] * z["mbk_batch"])
    check(est.n_batches_ == z["mbk_batches"] and np.isfinite(
        est.centers_).all() and float(est.counts_.sum()) == n_rows,
          f"rank {rank}: MiniBatchKMeans ran {est.n_batches_} batches, "
          f"counts summing to {est.counts_.sum()} of {n_rows} rows")
    launched = ph["minibatch_kmeans"]["launches"].get("distances_sq", 0)
    if dev.type == "cuda":
        check(launched == z["mbk_batches"], f"rank {rank}: the stream "
              f"launched distances_sq {launched} times, not once a batch")
    # the row gather: each batch's block on this rank holds exactly the
    # rows of the slice it owns, zero past them
    mbk_mod = importlib.import_module("dislib_tpu_torch.cluster.minibatch")
    block_geom = importlib.import_module(
        "dislib_tpu_torch.data.array")._block_geom
    path_c, path_n = one["mbk_path_centers"], one["mbk_path_counts"]
    b, n_f = z["mbk_batch"], z["km_n"]
    bad_gathers = []
    for i, blk in enumerate(mbk_batches):
        s0 = i * b
        m_b = min(b, n_rows - s0)
        r0, _, ml, _ = block_geom((m_b, n_f), mesh)
        live = max(0, min(ml, m_b - r0))
        want = np.zeros((ml, blk.shape[1]), np.float32)
        want[:live, :n_f] = x_h[s0 + r0:s0 + r0 + live]
        if not np.array_equal(blk.cpu().numpy(), want):
            bad_gathers.append(i)
    check(len(mbk_batches) == z["mbk_batches"] and not bad_gathers,
          f"rank {rank}: the stream's row gather gave wrong rows in "
          f"batches {bad_gathers[:8]} of {len(mbk_batches)}")
    # the free stream drifts from one rank's as near-tie rows flip (each
    # flip moves a center, and the next batches' ties fall elsewhere), so
    # every batch's step is held: from one rank's state before the batch,
    # on the rows the stream gathered for it, against one rank's state
    # after it, within MESH_A2B2_TOL with the same counts; and the free
    # stream's batch inertias (its history_) within MESH_KM_INERTIA of
    # one rank's, relatively, as the KMeans fit's inertia is held
    step_err, step_ndiff = 0.0, 0.0
    for i, blk in enumerate(mbk_batches):
        m_b = min(b, n_rows - i * b)
        r0 = block_geom((m_b, n_f), mesh)[0]
        c0 = torch.from_numpy(init if i == 0 else path_c[i - 1]).to(dev)
        n0 = torch.from_numpy(np.zeros(len(init), np.float32) if i == 0
                              else path_n[i - 1]).to(dev)
        c1, n1 = (t.cpu().numpy() for t in mbk_mod._mbk_step(
            blk, (m_b, n_f), c0, n0, mesh=mesh, row0=r0)[:2])
        step_err = max(step_err, float(np.abs(c1 - path_c[i]).max()))
        step_ndiff = max(step_ndiff, float(np.abs(n1 - path_n[i]).max()))
    m_err = float(np.abs(est.centers_ - one["mbk_centers"]).max())
    n_diff = float(np.abs(est.counts_ - one["mbk_counts"]).max())
    h1 = one["mbk_history"]
    h_rel = float((np.abs(est.history_ - h1) / np.abs(h1)).max()) \
        if est.history_.shape == h1.shape else float("inf")
    check(step_err <= MESH_A2B2_TOL and step_ndiff == 0,
          f"rank {rank}: a MiniBatchKMeans step from one rank's state off "
          f"one rank's next state by {step_err}, counts by {step_ndiff}")
    check(h_rel <= MESH_KM_INERTIA,
          f"rank {rank}: the stream's batch inertias off one rank's by "
          f"{h_rel} relatively > {MESH_KM_INERTIA}")
    ph["minibatch_kmeans"].update(
        gathered_batches_exact=len(mbk_batches),
        steps_from_one_rank_state={"batches": z["mbk_batches"],
                                   "centers_max_abs_err": step_err,
                                   "counts_max_abs_diff": step_ndiff},
        stream_centers_max_abs_diff_vs_one_rank=m_err,
        stream_counts_max_abs_diff_vs_one_rank=n_diff,
        stream_history_max_rel_diff_vs_one_rank=h_rel,
        stream_last_inertia_rel_diff_vs_one_rank=float(
            abs(est.inertia_ - h1[-1]) / abs(h1[-1])))
    del mbk_batches
    # distances_sq at a batch's rows on this rank, against its plain version
    xb = X[0:z["mbk_batch"], :]._local[:, :z["km_n"]].contiguous()
    cb = torch.from_numpy(est.centers_).to(dev).contiguous()
    kern, plain = K.distances_sq(xb, cb), K.distances_sq_plain(
        xb, cb, "highest")
    b_scale = float((xb.double() ** 2).sum(1).max()
                    + (cb.double() ** 2).sum(1).max())
    k_err = float((kern.double() - plain.double()).abs().max()) / b_scale
    check(k_err <= DIST_TOL, f"rank {rank}: distances_sq at "
          f"{list(xb.shape)}x{list(cb.shape)}: error {k_err} vs plain > "
          f"{DIST_TOL}")
    out["windows"]["distances_sq_mbk_err"] = {
        "max_abs_err": float((kern - plain).abs().max()),
        "normalized_err_vs_plain": k_err}

    def cdist_mbk():
        with px.precise():
            return torch.cdist(xb, cb, compute_mode="use_mm_for_euclid_dist")

    window("distances_sq_mbk", {
        "ms": lambda: K.distances_sq(xb, cb),
        "plain_ms": lambda: K.distances_sq_plain(xb, cb, "highest"),
        "library_ms": cdist_mbk}, 20)
    mbk_shape = [int(xb.shape[0]), int(cb.shape[0]), int(xb.shape[1])]
    del X, x_h, est, xb, cb, kern, plain

    # -- qr, svd and polar at bench.py's rows --------------------------------
    def rows_check(a_arr, factors):
        """(‖QᵀQ − I‖_max, ‖Q·F − A‖_F / ‖A‖_F) from this rank's rows of
        Q (the first factor), the replicated ``factors`` product and A,
        each summed over the ranks in float64."""
        n = a_arr.shape[1]
        q_rows = factors[0]._row_block().double()[:, :n]
        a_rows = a_arr._row_block().double()[:, :n]
        gram = dd.psum(q_rows.T @ q_rows, "rows", mesh)
        sq = dd.psum(torch.stack([((q_rows @ factors[1] - a_rows) ** 2).sum(),
                                  (a_rows ** 2).sum()]), "rows", mesh)
        eye = torch.eye(n, device=dev, dtype=gram.dtype)
        return (float((gram - eye).abs().max()),
                float(torch.sqrt(sq[0] / sq[1])))

    A = dst.array(mesh_data("qr", z))

    def qr():
        box["qr"] = dst.qr(A, mode="economic")
        return {"shape": z["qr"], "mesh": [4, 1], "mode": "economic"}

    run("qr", qr)
    q, r = box.pop("qr")
    orth, resid = rows_check(A, (q, torch.from_numpy(r.collect()).to(
        dev).double()))
    r_err = float(np.abs(mesh_signed_rows(r.collect())
                         - mesh_signed_rows(one["qr_r"])).max()
                  / np.abs(one["qr_r"]).max())
    check(orth <= px.ERROR_BOUNDS[("qr_orth", "float32")]
          and resid <= px.ERROR_BOUNDS[("qr_resid", "float32")]
          and r_err <= MESH_QR_TOL, f"rank {rank}: qr: orth {orth}, resid "
          f"{resid}, R off one rank's by {r_err}")
    ph["qr"].update(orth_err=orth, resid=resid, r_rel_err_vs_one_rank=r_err)
    del A, q, r
    A = dst.array(mesh_data("svd", z))

    def svd():
        box["svd"] = dst.svd(A)
        return {"shape": z["svd"], "mesh": [4, 1], "tier": "block"}

    run("svd", svd)
    u, sv, v = box.pop("svd")
    s_h = sv.collect().ravel()
    # U·(S·Vᵀ) against A, and UᵀU
    orth, resid = rows_check(A, (u, torch.from_numpy(
        s_h[:, None] * v.collect().T).to(dev).double()))
    s_err = float(np.abs(s_h - one["svd_s"]).max() / one["svd_s"][0])
    check(s_err <= MESH_QR_TOL
          and resid <= px.ERROR_BOUNDS[("svd_resid", "float32")],
          f"rank {rank}: svd values off one rank's by {s_err} of the "
          f"largest, resid {resid}")
    ph["svd"].update(values_rel_err_vs_one_rank=s_err, resid=resid,
                     u_orth_err=orth)
    del A, u, sv, v
    A = dst.array(mesh_data("polar", z))

    def polar():
        box["polar"] = dst.polar(A, info=True)
        return {"shape": z["polar"], "mesh": [4, 1]}

    run("polar", polar)
    u, h, nfo = box.pop("polar")
    orth, resid = rows_check(A, (u, torch.from_numpy(h.collect()).to(
        dev).double()))
    row0 = A._at[0]
    live = max(0, min(A._local.shape[0], A.shape[0] - row0))
    u_one = np.load(os.path.join(work, "polar_u.npy"), mmap_mode="r")
    u_err = float(np.abs(u._local[:live, :A.shape[1]].cpu().numpy()
                         - u_one[row0:row0 + live]).max())
    h_err = rel(h.collect(), one["polar_h"])
    check(nfo["iterations"] == int(one["polar_iters"])
          and u_err <= px.ERROR_BOUNDS[("polar_orth", "float32")]
          and h_err <= px.ERROR_BOUNDS[("polar_resid", "float32")]
          and orth <= px.ERROR_BOUNDS[("polar_orth", "float32")]
          and resid <= px.ERROR_BOUNDS[("polar_resid", "float32")],
          f"rank {rank}: polar: {nfo['iterations']} iterations (one rank "
          f"{int(one['polar_iters'])}), U off one rank's by {u_err}, H by "
          f"{h_err}, orth {orth}, resid {resid}")
    ph["polar"].update(iterations=nfo["iterations"], orth_err=orth,
                       resid=resid, u_max_abs_err_vs_one_rank=u_err,
                       h_rel_err_vs_one_rank=h_err)
    del A, u, h, u_one

    # -- lanczos_svd and kron -------------------------------------------------
    A = dst.array(mesh_data("lanczos", z))

    def lanczos():
        box["lz"] = dst.lanczos_svd(A, k=z["lanczos_k"], random_state=0)
        return {"shape": z["lanczos"], "mesh": [4, 1], "k": z["lanczos_k"]}

    run("lanczos_svd", lanczos)
    lz = box.pop("lz")[1].collect().ravel()
    lz_err = float(np.abs(lz - one["lanczos_s"]).max()
                   / one["lanczos_s"][0])
    check(lz_err <= MESH_QR_TOL, f"rank {rank}: lanczos_svd's values off "
          f"one rank's by {lz_err} of the largest")
    ph["lanczos_svd"]["values_rel_err_vs_one_rank"] = lz_err
    del A
    ka, kb = mesh_data("kron", z)
    KA, KB = dst.array(ka), dst.array(kb)

    def kron():
        box["kron"] = dst.kron(KA, KB)
        return {"shapes": z["kron"], "mesh": [4, 1]}

    run("kron", kron)
    kr = box.pop("kron")
    (r0, c0), blk = kr._at, kr._local.cpu().numpy()
    want = np.zeros_like(blk)
    full = np.kron(ka, kb)[r0:r0 + blk.shape[0], c0:c0 + blk.shape[1]]
    want[:full.shape[0], :full.shape[1]] = full
    check(np.array_equal(blk, want), f"rank {rank}: kron's block differs "
          "from np.kron's")
    ph["kron"]["block_bit_equal_to_np_kron"] = True
    del KA, KB, kr, blk, want, full

    # -- the search over the kNN classifier -----------------------------------
    xs, lab = mesh_data("search", z)
    XB, YB = dst.array(xs), dst.array(lab.astype(np.float32)[:, None])
    del xs, lab
    n_trials = len(MESH_GS_GRID["n_neighbors"]) \
        * len(MESH_GS_GRID["weights"]) * 3

    def search():
        prof.reset_host_reads()
        box["gs"] = dst.GridSearchCV(dst.KNeighborsClassifier(),
                                     MESH_GS_GRID, cv=3, refit=False).fit(
                                         XB, YB)
        box["reads"] = dict(prof.HOST_READS)
        return {"shape": [z["gs_m"], z["gs_n"]], "mesh": [4, 1],
                "trials": n_trials}

    run("search_knn", search)
    gs, reads = box.pop("gs"), box.pop("reads")
    scores = np.stack([gs.cv_results_[f"split{j}_test_score"]
                       for j in range(3)])
    g_err = float(np.max(np.abs(scores - one["gs_scores"])
                         / np.abs(one["gs_scores"])))
    best = json.dumps(gs.best_params_, sort_keys=True)
    check(g_err <= MESH_A2B2_TOL and best == str(one["gs_best"])
          and reads == json.loads(str(one["gs_reads"]))
          and reads == {"search": n_trials},
          f"rank {rank}: the kNN search's scores off one rank's by {g_err}, "
          f"best {best} (one rank {one['gs_best']}), host reads {reads} "
          f"(one rank {one['gs_reads']})")
    hops = ph["search_knn"]["launches"].get("panel_gemm", 0)
    if dev.type == "cuda":
        check(hops == n_trials * MESH_WORLD, f"rank {rank}: the search's "
              f"ring launched panel_gemm {hops} times, not once a hop")
    ph["search_knn"].update(scores_rel_err_vs_one_rank=g_err,
                            best_params=gs.best_params_, host_reads=reads)
    # the ring's cross term at the first fold's shapes on this rank
    xt, _, xv, _ = next(dst.KFold(3).split(XB))
    qd = xv._local.contiguous()
    ft = xt._local.T.contiguous()
    kern = K.panel_gemm(qd, ft, px.FLOAT32)
    plain = K.panel_gemm_plain(qd, ft, px.FLOAT32)
    g_abs = float((kern - plain).abs().max())
    p_err = g_abs / float(torch.linalg.norm(qd.double())
                          * torch.linalg.norm(ft.double())
                          / qd.shape[1] ** 0.5)
    check(p_err <= px.ERROR_BOUNDS[("matmul", "float32")],
          f"rank {rank}: panel_gemm at the search's ring hop "
          f"{list(qd.shape)}x{list(ft.shape)}: normalized error {p_err} vs "
          "plain > ERROR_BOUNDS")
    out["windows"]["panel_gemm_search_ring_err"] = {
        "max_abs_err": g_abs, "normalized_err_vs_plain": p_err}
    del kern, plain

    def mm():
        with px.precise():
            return torch.mm(qd, ft)

    window("panel_gemm_search_ring", {
        "ms": lambda: K.panel_gemm(qd, ft, px.FLOAT32),
        "plain_ms": lambda: K.panel_gemm_plain(qd, ft, px.FLOAT32),
        "library_ms": mm}, 10)
    return {"mbk": mbk_shape,
            "search_ring": [int(qd.shape[0]), int(qd.shape[1]),
                            int(ft.shape[1])]}


def mesh_rank_a2b3(rank, z, dev, work, run, window, out):
    """A.2b's part (ii) on (4, 1), in one rank of the mesh phase, each fit
    held to one rank's of ``work/a2b3.npz`` under the CPU tests' gates:
    the forest bit-equal (edges, splits, leaves) with its score, the
    regressor's edges bit-equal, each first differing split a near tie
    within MESH_A2B3_TOL of the node's sum of w·y² (on the rank that
    searched the node), and this rank's predictions within MESH_A2B3_TOL
    on the rows whose paths cross no differing split, DBSCAN the same
    partition of the core points,
    Daura's labels equal, CascadeSVM's support vectors and iterations
    equal and α and this rank's decision values within 10·MESH_A2B3_TOL.
    Each kernel at its per-rank shape on this path — ``node_histogram``
    at both forests' deepest level, ``distances_sq`` at the ring's ε-step
    of DBSCAN and Daura and at Daura's medoid column,
    ``distances_sq_batched`` at an owner's node batch and ``distances_sq``
    at the cascade's decision block, each with the inputs the fit gave
    it — against its plain version, timed with the card to this rank.
    ``run``/``window``/``out`` are :func:`mesh_rank`'s.  Returns the
    per-rank kernel shapes."""
    import numpy as np
    import torch
    import dislib_tpu_torch as dst
    from dislib_tpu_torch.ops import kernels as K
    from dislib_tpu_torch.ops import precision as px
    one = dict(np.load(os.path.join(work, "a2b3.npz")))
    mesh = dst.init((4, 1))
    box, seen, shapes = {}, {}, {}
    ph = out["phases"]
    data = mesh_a2b3_data(z)

    def spy(name, keep):
        """Wrap ``K.<name>`` so that ``keep(args)`` sees each call's
        inputs (the wrapper still counts its launches); returns the undo."""
        orig = getattr(K, name)

        def wrapped(*a, **kw):
            keep(a, kw)
            return orig(*a, **kw)

        setattr(K, name, wrapped)
        return lambda: setattr(K, name, orig)

    def last_hist(key):
        # the deepest level's inputs (node is updated in place after)
        def keep(a, kw):
            seen[key] = (a[0].clone(), *a[1:], kw)
        return keep

    def bits_equal(a, b):
        a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
        return a.shape == b.shape and np.array_equal(a.view(np.uint8),
                                                     b.view(np.uint8))

    # -- the forest and the regressor on bench_forest's rows -----------------
    x, y, yr = data["forest"]
    X, Y, YR = dst.array(x), dst.array(y), dst.array(yr)
    r0 = X._at[0]
    rows = slice(r0, min(r0 + X._local.shape[0], x.shape[0]))
    del x, y, yr

    def rf():
        undo = spy("node_histogram", last_hist("rf"))
        try:
            box["rf"] = dst.RandomForestClassifier(
                n_estimators=z["rf"][2], random_state=0).fit(X, Y)
        finally:
            undo()
        return {"shape": z["rf"][:2], "mesh": [4, 1],
                "n_estimators": z["rf"][2], "depth": box["rf"]._depth}

    run("forest", rf)
    est = box.pop("rf")
    same = {k: bits_equal(v, one[f"rf_{k}"]) for k, v in (
        ("edges", est._edges.cpu().numpy()), ("feats", est._feats),
        ("tbins", est._tbins), ("leaves", est._leaves.cpu().numpy()))}
    check(all(same.values()), f"rank {rank}: the forest differs from one "
          f"rank's: {same}")
    score = est.score(X, Y)
    check(abs(score - float(one["rf_score"])) <= 1e-6,
          f"rank {rank}: forest score {score} vs one rank's "
          f"{float(one['rf_score'])}")
    ph["forest"].update(bit_equal_to_one_rank=True, score=score)
    if dev.type == "cuda":
        check(ph["forest"]["launches"]["node_histogram"] == est._depth,
              f"rank {rank}: the forest launched node_histogram "
              f"{ph['forest']['launches']['node_histogram']} times")
    del est

    dt = importlib.import_module("dislib_tpu_torch.trees.decision_tree")
    splits_of = dt._splits
    level_gains = []

    def gains_spy(hist, scores, tf, min_gain, crit, nb):
        # this rank's slice of a level: the gains as the search sees them
        # and the nodes' stat totals
        g, tot = dt._gain_and_split(hist, crit)
        g = dt._mask_features(g, scores, tf)
        level_gains.append((g.reshape(*g.shape[:2], -1), tot))
        return splits_of(hist, scores, tf, min_gain, crit, nb)

    def rr():
        undo = spy("node_histogram", last_hist("rr"))
        dt._splits = gains_spy
        try:
            box["rr"] = dst.RandomForestRegressor(
                n_estimators=z["rr"][0], max_depth=z["rr"][1],
                random_state=0).fit(X, YR)
        finally:
            undo()
            dt._splits = splits_of
        return {"shape": z["rf"][:2], "mesh": [4, 1],
                "n_estimators": z["rr"][0], "depth": z["rr"][1]}

    run("forest_regressor", rr)
    est = box.pop("rr")
    check(bits_equal(est._edges.cpu().numpy(), one["rr_edges"]),
          f"rank {rank}: the regressor's edges differ from one rank's")
    # the float sums are added in another order than one rank's, so a
    # split whose best gains are a near tie may go the other way: every
    # split that differs where all its ancestors agree must be a near tie
    # by this rank's gains (within MESH_A2B3_TOL of the node's sum of
    # w·y²); below it the trees are not comparable
    depth, nb = est._depth, int(est._edges.shape[1]) + 1
    differs = (est._feats != one["rr_feats"]) | (est._tbins
                                                 != one["rr_tbins"])
    first = differs.copy()
    for lvl in range(1, depth):
        first[:, lvl] &= ~_ancestors_differ(differs, lvl)
    ties, worst = 0, 0.0
    for t, lvl, node in np.argwhere(first):
        g, tot = level_gains[lvl]
        lo = mesh.coord[0] * g.shape[1]
        if not lo <= node < lo + g.shape[1]:
            continue                    # another rank searched this node
        g, scale = g[t, node - lo], float(tot[t, node - lo, 2])
        f1, b1 = int(one["rr_feats"][t, lvl, node]), int(
            one["rr_tbins"][t, lvl, node])
        g1 = float(g[f1 * nb + b1]) if b1 < nb - 1 else 0.0
        gap = (float(g.max()) - max(g1, 0.0)) / max(scale, 1e-30)
        worst = max(worst, gap)
        ties += 1
        check(gap <= MESH_A2B3_TOL, f"rank {rank}: the regressor's split "
              f"(tree {t}, level {lvl}, node {node}) differs from one "
              f"rank's and is no near tie: gap {gap} of the node's sum "
              "of w·y²")
    # the rows whose paths cross no differing split: the same leaves,
    # their predictions within MESH_A2B3_TOL
    ref = dst.from_fitted_arrays(dst.RandomForestRegressor, {
        "_edges": one["rr_edges"], "_feats": one["rr_feats"],
        "_tbins": one["rr_tbins"], "_depth": depth,
        "_leaves": one["rr_leaves"], "n_features_": z["rf"][1]})
    leaf = est._apply(X).cpu().numpy()[:, : rows.stop - rows.start]
    clean = np.ones(leaf.shape[1], bool)
    for lvl in range(depth):
        node = leaf >> (depth - lvl)
        clean &= ~np.take_along_axis(differs[:, lvl], node, axis=1).any(0)
    pred = est.predict(X)._local[: leaf.shape[1], 0].cpu().numpy()
    want = ref.predict(X)._local[: leaf.shape[1], 0].cpu().numpy()
    p_err = mesh_close(pred[clean], want[clean], MESH_A2B3_TOL) \
        if clean.any() else 0.0
    check(p_err <= 1.0, f"rank {rank}: the regressor's predictions off one "
          f"rank's by {p_err} of the tolerance on rows of equal paths")
    del ref
    ph["forest_regressor"].update(
        splits_differing=int(differs.sum()), first_differing=int(
            first.sum()), near_ties_checked_here=ties,
        worst_tie_gap=worst, rows_on_equal_paths=int(clean.sum()),
        rows=int(clean.size), pred_close_vs_one_rank=p_err)
    del est, X, Y, YR, level_gains

    # -- DBSCAN and Daura on the ring ----------------------------------------
    db_x = dst.array(data["db"])

    def first_dist(key):
        def keep(a, kw):
            if key not in seen:
                seen[key] = a
        return keep

    def dbscan():
        undo = spy("distances_sq", first_dist("db"))
        try:
            box["db"] = dst.DBSCAN(eps=z["db"][2],
                                   min_samples=z["db"][3]).fit(db_x)
        finally:
            undo()
        return {"shape": z["db"][:2], "mesh": [4, 1]}

    run("dbscan", dbscan)
    est = box.pop("db")
    core = np.zeros(z["db"][0], bool)
    core[one["db_core"]] = True
    nd, n1 = int((est.labels_ < 0).sum()), int((one["db_labels"] < 0).sum())
    check(same_partition_on_core(est.labels_, one["db_labels"], core)
          and abs(nd - n1) <= max(5, 0.01 * z["db"][0]),
          f"rank {rank}: DBSCAN's core partition differs from one rank's "
          f"(noise {nd} vs {n1})")
    ph["dbscan"].update(
        same_core_partition=True, clusters=est.n_clusters_, noise=nd,
        labels_equal=bool(np.array_equal(est.labels_, one["db_labels"])),
        core_equal=bool(np.array_equal(est.core_sample_indices_,
                                       one["db_core"])))
    del est, db_x
    da_x = dst.array(data["da"])

    first, split = {}, {}

    def daura():
        with daura_launches(K, first) as got:
            box["da"] = dst.Daura(cutoff=z["da"][2]).fit(da_x)
        split.update(da=got["eps"], da_col=got["col"])
        return {"shape": z["da"][:2], "mesh": [4, 1]}

    run("daura", daura)
    seen.update(da=first["eps"], da_col=first["col"])
    ph["daura"]["distances_sq_launches_by_block"] = dict(split)
    check(sum(split.values()) == ph["daura"]["launches"]["distances_sq"],
          f"rank {rank}: Daura's distances_sq launches by block {split} "
          f"do not add up to the phase's "
          f"{ph['daura']['launches']['distances_sq']}")
    est = box.pop("da")
    check(np.array_equal(est.labels_, one["da_labels"]),
          f"rank {rank}: Daura's labels differ from one rank's on "
          f"{int((est.labels_ != one['da_labels']).sum())} frames")
    n_clusters = len(est.clusters_)
    ph["daura"].update(labels_equal=True, clusters=n_clusters)
    del est, da_x

    # -- dense CascadeSVM ----------------------------------------------------
    sx, sy = data["sv"]
    part, iters = z["csvm"][2:]
    SX = dst.array(sx, block_size=(part, sx.shape[1]))
    SY = dst.array(sy[:, None], block_size=(part, 1))

    def csvm():
        undo = spy("distances_sq_batched", first_dist("sv"))
        try:
            box["sv"] = dst.CascadeSVM(
                kernel="rbf", c=1.0, gamma=1.0 / sx.shape[1],
                max_iter=iters, check_convergence=False).fit(SX, SY)
        finally:
            undo()
        return {"shape": z["csvm"][:2], "mesh": [4, 1], "part": part,
                "iterations": iters}

    run("csvm", csvm)
    est = box.pop("sv")
    a_err = float(np.abs(est._sv_alpha - one["sv_alpha"]).max()) \
        if est._sv_alpha.shape == one["sv_alpha"].shape else float("inf")
    check(np.array_equal(est._sv_idx, one["sv_idx"])
          and est.n_iter_ == int(one["sv_n_iter"])
          and a_err <= 10 * MESH_A2B3_TOL,
          f"rank {rank}: CascadeSVM's {len(est._sv_idx)} support vectors "
          f"(one rank: {len(one['sv_idx'])}), {est.n_iter_} iterations, "
          f"alpha off by {a_err}")

    def csvm_predict():
        undo = spy("distances_sq", first_dist("sv_dec"))
        try:
            box["dec"] = est.decision_function(SX)
        finally:
            undo()
        return {"queries": z["csvm"][0], "mesh": [4, 1]}

    run("csvm_decision", csvm_predict)
    dec = box.pop("dec")._local[: mesh_rows_of(SX), 0].cpu().numpy()
    s_rows = slice(SX._at[0], SX._at[0] + len(dec))
    d_err = float(np.abs(dec - one["sv_dec"][s_rows]).max())
    check(d_err <= 10 * MESH_A2B3_TOL, f"rank {rank}: CascadeSVM's "
          f"decision values off one rank's by {d_err}")
    ph["csvm"].update(n_sv=len(est._sv_idx), n_iter=est.n_iter_,
                      alpha_max_abs_err_vs_one_rank=a_err,
                      decision_max_abs_err_vs_one_rank=d_err)
    del est, SX, SY

    # -- the kernels at their per-rank shapes, each against its plain -------
    for key in ("rf", "rr"):
        node, bx, w, st, nn, nb, kw = seen.pop(key)
        integer = bool(kw.get("integer", False))
        got = K.node_histogram(node, bx, w, st, nn, nb, integer=integer)
        plain = K.node_histogram_plain(node, bx, w, st, nn, nb,
                                       integer=integer)
        if integer:
            check(torch.equal(got, plain), f"rank {rank}: node_histogram "
                  f"at the {key} deepest level: not bit-equal to plain")
        else:
            exact = K.node_histogram_plain(node, bx, w.double(),
                                           st.double(), nn, nb)
            scale = K.node_histogram_plain(node, bx, w, st.abs(), nn, nb)
            check(bool(((got.double() - exact).abs() <= 1e-5 * scale).all()),
                  f"rank {rank}: node_histogram at the {key} deepest level "
                  "off the f64 sums by more than 1e-5 of sum |w*stats|")
            del exact, scale
        out["windows"][f"node_histogram_{key}_err"] = {
            "max_abs_err": float((got - plain).abs().max())}
        del got, plain
        T, m_loc = node.shape
        n, S = bx.shape[1], st.shape[1]
        bins = bx.long()
        feat = torch.arange(n, device=dev)[None, :].expand(m_loc, n)
        contrib = w[:, :, None] * st[None]
        lib_out = torch.zeros((T, nn, n, nb, S), device=dev)

        def lib():
            for t in range(T):
                lib_out[t].index_put_(
                    (node[t].long()[:, None].expand(m_loc, n), feat, bins),
                    contrib[t][:, None, :].expand(m_loc, n, S),
                    accumulate=True)

        window(f"node_histogram_{key}", {
            "ms": lambda: K.node_histogram(node, bx, w, st, nn, nb,
                                           integer=integer),
            "plain_ms": lambda: K.node_histogram_plain(
                node, bx, w, st, nn, nb, integer=integer),
            "library_ms": lib}, 2)
        shapes[f"hist_{key}"] = [T, m_loc, n, nn, nb, S, int(integer)]
        del node, bx, w, st, bins, feat, contrib, lib_out
    for key in ("db", "da", "da_col", "sv_dec"):
        a, b = seen.pop(key)[:2]
        got, plain = K.distances_sq(a, b), K.distances_sq_plain(
            a, b, "highest")
        scale = float((a.double() ** 2).sum(1).max()
                      + (b.double() ** 2).sum(1).max())
        err = float((got.double() - plain.double()).abs().max()) / scale
        check(err <= DIST_TOL, f"rank {rank}: distances_sq at "
              f"{list(a.shape)}x{list(b.shape)} ({key}): error {err} vs "
              f"plain > {DIST_TOL}")
        out["windows"][f"distances_sq_{key}_err"] = {
            "max_abs_err": float((got - plain).abs().max()),
            "normalized_err_vs_plain": err}
        del got, plain

        def cdist(a=a, b=b):
            with px.precise():
                return torch.cdist(a, b,
                                   compute_mode="use_mm_for_euclid_dist")

        window(f"distances_sq_{key}", {
            "ms": lambda a=a, b=b: K.distances_sq(a, b),
            "plain_ms": lambda a=a, b=b: K.distances_sq_plain(a, b,
                                                              "highest"),
            "library_ms": cdist}, 10)
        shapes[f"dist_{key}"] = [int(a.shape[0]), int(b.shape[0]),
                                 int(a.shape[1])]
    ga = seen.pop("sv")[0]
    got = K.distances_sq_batched(ga, ga)
    plain = K.distances_sq_batched_plain(ga, ga)
    scale = float(2.0 * (ga.double() ** 2).sum(2).max())
    err = float((got.double() - plain.double()).abs().max()) / scale
    check(err <= DIST_TOL, f"rank {rank}: distances_sq_batched at "
          f"{list(ga.shape)}: error {err} vs plain > {DIST_TOL}")
    out["windows"]["distances_sq_sv_gram_err"] = {
        "max_abs_err": float((got - plain).abs().max()),
        "normalized_err_vs_plain": err}
    del got, plain

    def cdist_b():
        with px.precise():
            return torch.cdist(ga, ga,
                               compute_mode="use_mm_for_euclid_dist").square()

    window("distances_sq_sv_gram", {
        "ms": lambda: K.distances_sq_batched(ga, ga),
        "plain_ms": lambda: K.distances_sq_batched_plain(ga, ga),
        "library_ms": cdist_b}, 20)
    shapes["dist_sv_gram"] = [int(s) for s in ga.shape]
    return shapes


def mesh_rank_a2c(rank, z, dev, work, run, window, out):
    """A.2c in one rank of the mesh phase, each call held to one rank's of
    ``work/a2c.npz`` (:data:`MESH_A2C_SPMM` and the gates beside it): the
    SpMM at bench_sparse's size on (2, 2) and on (4, 1); on (4, 1) sparse
    KMeans on the svmlight rows (its init one rank's to the bit), the
    sparse kNN (1,000 of those rows as sparse and dense queries), ALS at
    bench_als_sparse's size sparse and dense (with one item half-step
    against float64), the IVF index at bench_ann's size (the full fit
    searched under ``db`` and ``kernel``, then a layout from one rank's
    labels and centers), and sparse CascadeSVM.  ``panel_gemm`` and
    ``distances_sq`` at the IVF's per-rank shapes are held against their
    plain versions and timed with the card to this rank.
    ``run``/``window``/``out`` are :func:`mesh_rank`'s.  Returns the
    per-rank kernel shapes."""
    import numpy as np
    import torch
    import dislib_tpu_torch as dst
    from dislib_tpu_torch.classification import CascadeSVM
    from dislib_tpu_torch.cluster import KMeans
    from dislib_tpu_torch.ops import kernels as K
    from dislib_tpu_torch.ops import precision as px
    from dislib_tpu_torch.ops.spmm import spmm, spmm_steps
    from dislib_tpu_torch.recommendation import ALS
    from dislib_tpu_torch.recommendation import als as als_mod
    from dislib_tpu_torch.retrieval import IVFIndex
    one = dict(np.load(os.path.join(work, "a2c.npz")))
    data = mesh_a2c_data(z)
    ph = out["phases"]
    box, shapes = {}, {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def free():
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    def rows_of(a):
        """(first global row, live rows) of this rank's block of ``a``."""
        r0 = a._at[0]
        held = a._m_local if isinstance(a, dst.SparseArray) \
            else a._local.shape[0]
        return r0, max(0, min(held, a.shape[0] - r0))

    def clear_of(od, k):
        """Where the one-rank (k+1)-neighbour distances ``od`` leave the
        k-th and (k+1)-th (and each neighbour's next) apart: 1e-5 of the
        largest distance."""
        gap = np.diff(od, axis=1) > 1e-5 * max(float(od.max()), 1e-30)
        return np.concatenate([gap[:, :1], gap[:, :-1] & gap[:, 1:]],
                              axis=1)[:, :k]

    # -- the SpMM on (2, 2), B's columns over 'cols', and on (4, 1) ---------
    m, kk, nb, dens = z["spmm"]
    want = one["spmm"]
    scale = float(np.abs(want).max())
    for shape in ((2, 2), (4, 1)):
        dst.init(shape)
        X = dst.SparseArray.from_scipy(data["spmm"])
        B = dst.array(data["spmm_b"])
        name = f"spmm_{shape[0]}x{shape[1]}"
        t0 = time.perf_counter()
        spmm(X, B)               # the shard and its panel view, built once
        sync()
        first_s = time.perf_counter() - t0

        def call(X=X, B=B, shape=shape, first_s=first_s):
            box["c"] = spmm(X, B)
            return {"shape": [m, kk, nb], "density": dens,
                    "mesh": list(shape), "panels": spmm_steps(),
                    "first_call_s": first_s}

        run(name, call)
        c = box.pop("c")
        (r0, c0), blk = c._at, c._local.cpu().numpy()
        got = blk[: max(0, min(blk.shape[0], m - r0)),
                  : max(0, min(blk.shape[1], nb - c0))]
        err = float(np.abs(got - want[r0:r0 + got.shape[0],
                                      c0:c0 + got.shape[1]]).max()) / scale
        check(err <= MESH_A2C_SPMM, f"rank {rank}: SpMM on {shape} off one "
              f"rank's by {err} of the largest entry")
        ph[name]["max_abs_err_of_largest_vs_one_rank"] = err
        del X, B, c
    free()

    # -- sparse KMeans on the svmlight rows, (4, 1) ----------------------------
    S = dst.SparseArray.from_scipy(data["sv"])
    k, iters = z["skm"]

    def skm():
        box["km"] = KMeans(n_clusters=k, random_state=0, max_iter=iters,
                           tol=0.0).fit(S)
        return {"shape": list(S.shape), "nnz": S.nnz, "k": k,
                "iters": iters, "mesh": [4, 1]}

    run("sparse_kmeans", skm)
    km = box.pop("km")
    c0 = KMeans(n_clusters=k, random_state=0)._init_centers(S).cpu().numpy()
    check(np.array_equal(c0, one["skm_c0"]), f"rank {rank}: sparse KMeans' "
          "init rows differ from one rank's")
    km1 = KMeans(n_clusters=k, init=one["skm_c0"], max_iter=1,
                 tol=0.0).fit(S)
    c1_err = float(np.abs(km1.centers_ - one["skm_centers1"]).max())
    i_err = abs(km.inertia_ - float(one["skm_inertia"])) / float(
        one["skm_inertia"])
    check(c1_err <= MESH_KM_TOL and i_err <= MESH_KM_INERTIA,
          f"rank {rank}: sparse KMeans' first step off one rank's by "
          f"{c1_err}, its {iters}-step inertia by {i_err}")
    ph["sparse_kmeans"].update(one_step_centers_max_abs_err_vs_one_rank=c1_err,
                               inertia_rel_err_vs_one_rank=i_err)

    # -- the sparse kNN: the array as the fit set, 1,000 of its rows --------
    kq = z["sknn"][1]

    def sknn():
        qs = S[data["sknn_rows"]]
        nn = dst.NearestNeighbors(n_neighbors=kq).fit(S)
        box["sparse"], box["dense"] = nn.kneighbors(qs), \
            nn.kneighbors(qs.to_dense())
        return {"fit_shape": list(S.shape), "queries": z["sknn"][0],
                "k": kq, "mesh": [4, 1]}

    run("sparse_knn", sknn)
    # squared distances against 2 max |x|², the magnitudes that cancel in
    # |q|² − 2 q·x + |x|² (a query's own row comes out near, not at, 0,
    # and the GEMM of a rank's 250 dense query rows rounds otherwise than
    # one rank's 1,000), as the sparse_knn phase holds them; and, as that
    # phase does, the distances clear of that cancellation (one rank's
    # squared distance at least 1e-2 of 2 max |x|²) to a relative 1e-5
    sv = data["sv"]
    d_scale = 2.0 * float(np.asarray(sv.multiply(sv).sum(1)).max())
    res = {}
    for name in ("sparse", "dense"):
        d_arr, i_arr = box.pop(name)
        q0, live = rows_of(d_arr)
        od = one[f"sknn_{name}_d"][q0:q0 + live].astype(np.float64)
        oi = one[f"sknn_{name}_i"][q0:q0 + live]
        gd = d_arr._local[:live, :kq].cpu().numpy().astype(np.float64)
        gi = i_arr._local[:live, :kq].cpu().numpy()
        d2_err = float(np.abs(gd ** 2 - od[:, :kq] ** 2).max()) / d_scale \
            if live else 0.0
        far = od[:, :kq] ** 2 >= 1e-2 * d_scale
        rel = float((np.abs(gd - od[:, :kq])[far] / od[:, :kq][far]).max()) \
            if far.any() else 0.0
        clear = clear_of(od, kq)
        bad = int((gi[clear] != oi[:, :kq][clear]).sum())
        check(d2_err <= 1e-5 and rel <= 1e-5 and bad == 0
              and (far.any() or not live),
              f"rank {rank}: the sparse kNN ({name} queries) off one "
              f"rank's: squared distances by {d2_err} of 2 max |x|^2, "
              f"distances clear of 0 by rtol {rel}, {bad} indices at clear "
              "places")
        res[name] = {"d2_err_of_2_max_row_sq_vs_one_rank": d2_err,
                     "d_rel_err_vs_one_rank": rel,
                     "max_abs_dist_err_vs_one_rank": float(np.abs(
                         gd - od[:, :kq]).max()) if live else 0.0,
                     "far_places": int(far.sum()),
                     "clear_places": int(clear.sum()), "rows": live}
    ph["sparse_knn"]["vs_one_rank"] = res
    del S
    free()

    # -- ALS at bench_als_sparse's size, sparse and dense (1 GB a rank) -----
    am, an, _, f, lam, sweeps, hold = z["als"]
    A = dst.SparseArray.from_scipy(data["als"])
    Ad = A.to_dense()
    for name, arr in (("sparse", A), ("dense", Ad)):
        def fit(arr=arr, name=name):
            box["als"] = ALS(n_f=f, lambda_=lam, tol=0.0, max_iter=sweeps,
                             random_state=0).fit(arr)
            return {"shape": [am, an], "n_f": f, "sweeps": sweeps,
                    "ratings": name, "mesh": [4, 1]}

        run(f"als_{name}", fit)
        est = box.pop("als")
        errs = {"users": rel_err(est.users_, one[f"als_{name}_u"]),
                "items": rel_err(est.items_, one[f"als_{name}_v"]),
                "rmse": rel_err(est.history_, one[f"als_{name}_hist"])}
        check(max(errs.values()) <= MESH_A2C_ALS, f"rank {rank}: ALS "
              f"({name}) off one rank's by {errs}")
        ph[f"als_{name}"]["rel_err_vs_one_rank"] = errs
    del Ad
    free()
    # one item half-step (the psum over 'rows') against float64 NumPy
    users, items = als_mod._half_steps(A, f, lam)
    r0, live = rows_of(A)
    u_loc = torch.zeros((A._m_local, f), device=dev)
    u_loc[:live] = torch.from_numpy(one["als_sparse_u"][r0:r0 + live]).to(
        dev)
    hold_i = np.sort(np.random.RandomState(6).choice(an, hold,
                                                     replace=False))
    got_i = items.solve(u_loc)[torch.as_tensor(hold_i, device=dev)]
    csc = data["als"][:, hold_i].tocsc()
    want_i = numpy_normal_solve(
        [(csc.indices[csc.indptr[j]:csc.indptr[j + 1]],
          csc.data[csc.indptr[j]:csc.indptr[j + 1]].astype(np.float64))
         for j in range(len(hold_i))],
        one["als_sparse_u"].astype(np.float64), lam)
    h_err = rel_err(got_i.cpu().numpy(), want_i)
    check(h_err <= MESH_A2C_ALS, f"rank {rank}: the item half-step across "
          f"ranks off float64 by {h_err}")
    ph["als_sparse"]["item_half_step_err_vs_f64"] = h_err
    del A, users, items, u_loc
    free()

    # -- the IVF index at bench_ann's size --------------------------------------
    _, d_ivf, nq, k_ivf, lists, nprobe, ivf_iters, _ = z["ivf"]
    x_h, q_h = data["ivf_x"], data["ivf_q"]
    X, Q = dst.array(x_h), dst.array(q_h)

    def ivf():
        ix = box["ix"] = IVFIndex(n_lists=lists, nprobe=nprobe,
                                  kmeans_max_iter=ivf_iters,
                                  random_state=0).fit(X)
        for route in ("db", "kernel"):
            box[route] = ix.search(Q, k=k_ivf, overlap=route)
        return {"catalog": [int(X.shape[0]), d_ivf], "queries": nq,
                "k": k_ivf, "n_lists": lists, "nprobe": nprobe,
                "kmeans_max_iter": ivf_iters, "mesh": [4, 1]}

    run("ivf", ivf)
    ix = box.pop("ix")
    if dev.type == "cuda":
        la = ph["ivf"]["launches"]
        check(la["distances_sq"] >= ivf_iters and la["panel_gemm"] == 1,
              f"rank {rank}: the IVF fit and searches launched {la}")
    rec = {}
    for route in ("db", "kernel"):
        ids = box.pop(route)[1].collect()
        rec[route] = ivf_recall(x_h, q_h, ids, one["ivf_kth"])
        gap = abs(rec[route] - float(one[f"ivf_{route}_recall"]))
        check(rec[route] >= 0.95 and gap <= MESH_A2C_RECALL,
              f"rank {rank}: IVF recall@{k_ivf} ({route}) {rec[route]}, "
              f"one rank's {float(one[f'ivf_{route}_recall'])}")
    ph["ivf"].update(recall=rec, one_rank_recall={
        r: float(one[f"ivf_{r}_recall"]) for r in ("db", "kernel")},
        pad_waste=ix.pad_waste)
    # the search from one rank's labels and centers: one rank's results
    seam = IVFIndex(n_lists=lists, nprobe=nprobe)._build(
        x_h, one["ivf_labels"], one["ivf_centers"])

    def seam_search():
        for route in ("db", "kernel"):
            box[route] = seam.search(Q, k=k_ivf, overlap=route)
        return {"queries": nq, "k": k_ivf, "nprobe": nprobe,
                "layout": "one rank's labels and centers", "mesh": [4, 1]}

    run("ivf_from_one_rank_layout", seam_search)
    # squared distances against max |q|² + max |x|² (DIST_TOL's scale)
    d_scale = float((q_h.astype(np.float64) ** 2).sum(1).max()
                    + (x_h.astype(np.float64) ** 2).sum(1).max())
    res = {}
    for route in ("db", "kernel"):
        d_arr, i_arr = box.pop(route)
        q0, live = rows_of(d_arr)
        od = one[f"ivf_{route}_d"][q0:q0 + live].astype(np.float64)
        oi = one[f"ivf_{route}_i"][q0:q0 + live]
        gd = d_arr._local[:live, :k_ivf].cpu().numpy().astype(np.float64)
        gi = i_arr._local[:live, :k_ivf].cpu().numpy()
        d2_err = float(np.abs(gd ** 2 - od[:, :k_ivf] ** 2).max()) / d_scale
        clear = clear_of(od, k_ivf)
        bad = int((gi[clear] != oi[:, :k_ivf][clear]).sum())
        check(d2_err <= DIST_TOL and bad == 0, f"rank {rank}: the IVF "
              f"search ({route}) from one rank's layout: squared distances "
              f"off by {d2_err} of max |q|^2 + max |x|^2, {bad} ids at "
              "clear places")
        res[route] = {"d2_err_of_scale_vs_one_rank": d2_err,
                      "max_abs_dist_err_vs_one_rank": float(np.abs(
                          gd - od[:, :k_ivf]).max()),
                      "clear_places": int(clear.sum()), "rows": live}
    ph["ivf_from_one_rank_layout"]["vs_one_rank"] = res
    # the kernels at the IVF's per-rank shapes, with the card to this rank
    qd, ct = Q._local.contiguous(), ix._cents_t
    kern = K.panel_gemm(qd, ct, px.FLOAT32)
    plain = K.panel_gemm_plain(qd, ct, px.FLOAT32)
    g_abs = float((kern - plain).abs().max())
    g_err = g_abs / float(torch.linalg.norm(qd.double())
                          * torch.linalg.norm(ct.double())
                          / qd.shape[1] ** 0.5)
    check(g_err <= px.ERROR_BOUNDS[("matmul", "float32")],
          f"rank {rank}: panel_gemm at the IVF's {list(qd.shape)}x"
          f"{list(ct.shape)}: normalized error {g_err} vs plain")
    out["windows"]["panel_gemm_ivf_err"] = {
        "max_abs_err": g_abs, "normalized_err_vs_plain": g_err}

    def mm():
        with px.precise():
            return torch.mm(qd, ct)

    window("panel_gemm_ivf", {
        "ms": lambda: K.panel_gemm(qd, ct, px.FLOAT32),
        "plain_ms": lambda: K.panel_gemm_plain(qd, ct, px.FLOAT32),
        "library_ms": mm}, 50)
    shapes["ivf_gemm"] = [int(qd.shape[0]), int(qd.shape[1]),
                          int(ct.shape[1])]
    xl = X._local[:, :d_ivf].contiguous()
    cent = torch.from_numpy(ix.quantizer_.centers_).to(dev).contiguous()
    kern, plain = K.distances_sq(xl, cent), K.distances_sq_plain(
        xl, cent, "highest")
    d_scale = float((xl.double() ** 2).sum(1).max()
                    + (cent.double() ** 2).sum(1).max())
    k_err = float((kern.double() - plain.double()).abs().max()) / d_scale
    check(k_err <= DIST_TOL, f"rank {rank}: distances_sq at the IVF "
          f"quantizer's {list(xl.shape)}x{list(cent.shape)}: error {k_err} "
          f"vs plain > {DIST_TOL}")
    out["windows"]["distances_sq_ivf_err"] = {
        "max_abs_err": float((kern - plain).abs().max()),
        "normalized_err_vs_plain": k_err}
    del kern, plain

    def cdist():
        with px.precise():
            return torch.cdist(xl, cent,
                               compute_mode="use_mm_for_euclid_dist")

    window("distances_sq_ivf", {
        "ms": lambda: K.distances_sq(xl, cent),
        "plain_ms": lambda: K.distances_sq_plain(xl, cent, "highest"),
        "library_ms": cdist}, 10)
    shapes["ivf_dist"] = [int(xl.shape[0]), int(cent.shape[0]), d_ivf]
    del X, Q, ix, seam, qd, ct, xl, cent
    free()

    # -- sparse CascadeSVM on 8,192 svmlight-style rows ---------------------
    cm, part, sv_iters = z["ssv"]
    xs = dst.SparseArray.from_scipy(data["ssv"], block_size=(
        part, data["ssv"].shape[1]))
    ys = dst.array(data["ssv_y"])

    def csvm():
        box["sv"] = CascadeSVM(max_iter=sv_iters,
                               check_convergence=False).fit(xs, ys)
        return {"shape": list(xs.shape), "nnz": xs.nnz, "part": part,
                "max_iter": sv_iters, "mesh": [4, 1]}

    run("csvm_sparse", csvm)
    sv = box.pop("sv")
    same = np.array_equal(sv._sv_idx, one["ssv_idx"]) \
        and sv.n_iter_ == int(one["ssv_n_iter"])
    a_err = float(np.abs(sv._sv_alpha - one["ssv_alpha"]).max()) \
        if same else float("inf")
    check(same and a_err <= MESH_A2C_ALS, f"rank {rank}: sparse CascadeSVM "
          f"off one rank's (SVs and iterations equal: {same}, α by {a_err})")
    ph["csvm_sparse"].update(n_sv=int(len(sv._sv_idx)),
                             alpha_max_abs_err_vs_one_rank=a_err)
    del xs, ys, sv
    free()
    return shapes


def _ancestors_differ(differs, lvl):
    """(T, width): whether an ancestor of each node of level ``lvl``
    differs in ``differs`` (T, depth, width)."""
    import numpy as np
    out = np.zeros((differs.shape[0], differs.shape[2]), bool)
    node = np.arange(differs.shape[2])
    for up in range(1, lvl + 1):
        anc = node >> up
        out |= differs[:, lvl - up][:, anc]
    return out


def mesh_rows_of(a) -> int:
    """The logical rows of the ds-array ``a`` on this rank's block."""
    return max(0, min(a._local.shape[0], a.shape[0] - a._at[0]))


def mesh_nccl_pair(argv) -> int:
    """One of two processes that both ask for NCCL on one card
    (``chip_smoke.py --mesh-nccl-pair RANK DIR``): ``initialize`` must
    raise, naming the one card, before NCCL's own error; exit 0 then."""
    rank, work = int(argv[0]), argv[1]
    from dislib_tpu_torch.parallel import distributed as dd
    try:
        dd.initialize(f"file://{os.path.join(work, 'store_pair')}", 2, rank,
                      device="cuda:0", timeout=60)
    except RuntimeError as exc:
        print(json.dumps({"rank": rank, "raised": str(exc)}), flush=True)
        return 0 if "one card" in str(exc) else 1
    print(json.dumps({"rank": rank, "raised": None}), flush=True)
    return 1


def mesh_spawn(args, n, work, timeout_s):
    """Run ``n`` copies of this script with ``args + [rank, work]`` to
    their end (killed at ``timeout_s``); returns each one's (exit code,
    output)."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)), OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), *args, str(r), work],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout_s)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, log) for p, log in zip(procs, logs)]


def mesh_phase(dev, card):
    """The mesh of ranks on the card.

    First NCCL with a world of one in this process: SUMMA (under
    ``DSLIB_OVERLAP=pallas``, both policies), KMeans, tsqr and a
    GaussianMixture fit over groups of one rank must be bit-equal to the
    same calls with no process group.  Then the one-rank results the
    ranks are held to (the KMeans fit, the (k+1)-neighbour kneighbors,
    tsqr's R, GM's parameters, random_svd's values, PCA's variances and
    components, the scalers' statistics; A.2b's second part: the
    regressions, Lasso with the ranks' 4 agents, the MiniBatchKMeans
    stream, qr's R, svd's values, polar's U and H, lanczos_svd's values
    and the kNN search), and 4 gloo ranks on this one card
    (``--mesh-rank``): SUMMA at GEMM_N² and tsqr on (2, 2); tsqr,
    KMeans, the ring kNN, the shuffle, the scalers, random_svd, PCA, GM,
    LinearRegression, Lasso, MiniBatchKMeans, qr, svd, polar,
    lanczos_svd, kron and the search over the kNN classifier on (4, 1),
    each rank's blocks against the one-rank results.  The world of one
    also holds LinearRegression, Lasso, the MiniBatchKMeans stream, qr,
    svd and polar bit-equal, and (A.2c) the SpMM, sparse KMeans, the
    sparse kNN, ALS sparse and dense, the IVF index and sparse
    CascadeSVM, whose one-rank results the ranks are held to
    (:func:`mesh_rank_a2c`: the SpMM on (2, 2) and (4, 1), the rest on
    (4, 1)).  Returns the kernels-line entries at the per-rank shapes."""
    import numpy as np
    import torch
    import dislib_tpu_torch as dst
    from dislib_tpu_torch.ops import precision as px
    from dislib_tpu_torch.parallel import distributed as dd
    from dislib_tpu_torch.utils import profiling as prof
    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    overlap = os.environ.get("DSLIB_OVERLAP")
    os.environ["DSLIB_OVERLAP"] = "pallas"
    try:
        # -- NCCL with a world of one: bit-equal to no process group ----------
        z = mesh_sizes()
        a_h, b_h = mesh_operands(dev, z["gemm_n"])
        x_h, init = mesh_data("kmeans", z)
        t_h, g_h = mesh_data("tsqr", z), mesh_data("gm", z)
        lx, ly, lyl = mesh_data("lr", z)
        q_h, s_h, p_h = (mesh_data(w, z) for w in ("qr", "svd", "polar"))

        def one_rank():
            A, B, X = dst.array(a_h), dst.array(b_h), dst.array(x_h)
            res = {pol.name: dst.matmul(A, B, algorithm="summa",
                                        precision=pol)._data
                   for pol in (px.FLOAT32, px.BFLOAT16)}
            km = dst.KMeans(n_clusters=z["km_k"], init=init,
                            max_iter=z["km_iters"], tol=0.0).fit(X)
            res["centers"] = torch.from_numpy(km.centers_)
            res["labels"] = km.predict(X)._data
            res["inertia"] = torch.tensor(km.inertia_)
            q, r = dst.tsqr(dst.array(t_h))
            res["tsqr_q"], res["tsqr_r"] = q._data, r._data
            gm = dst.GaussianMixture(n_components=z["gm_k"], max_iter=z[
                "gm_iters"], tol=0.0, random_state=0).fit(dst.array(g_h))
            res["gm_weights"] = torch.from_numpy(gm.weights_)
            res["gm_means"] = torch.from_numpy(gm.means_)
            res["gm_covs"] = torch.from_numpy(gm.covariances_)
            res["gm_lb"] = torch.tensor(gm.lower_bound_)
            # A.2b's second part: the linear models on LR_M x LR_N, the
            # MiniBatchKMeans stream, qr's panel loop, svd's block tier
            # and polar at bench.py's rows
            LX, LY = dst.array(lx), dst.array(ly)
            lr = dst.LinearRegression().fit(LX, LY)
            res["lr_coef"] = torch.from_numpy(lr.coef_)
            res["lr_intercept"] = torch.from_numpy(lr.intercept_)
            la = dst.Lasso(lmbd=z["lasso"][0], rho=z["lasso"][1],
                           max_iter=int(z["lasso"][2])).fit(
                               LX, dst.array(lyl))
            res["lasso_coef"] = torch.from_numpy(la.coef_)
            res["lasso_n_iter"] = torch.tensor(la.n_iter_)
            mbk = mesh_mbk_stream(dst, X, init, z, states=mbk_states)
            res["mbk_centers"] = torch.from_numpy(mbk.centers_)
            res["mbk_counts"] = torch.from_numpy(mbk.counts_)
            res["mbk_history"] = torch.from_numpy(mbk.history_)
            q, r = dst.qr(dst.array(q_h), mode="economic")
            res["qr_q"], res["qr_r"] = q._data, r._data
            u, sv, v = dst.svd(dst.array(s_h))
            res["svd_u"], res["svd_s"], res["svd_v"] = (u._data, sv._data,
                                                       v._data)
            u, h, nfo = dst.polar(dst.array(p_h), info=True)
            res["polar_u"], res["polar_h"] = u._data, h._data
            res["polar_iters"] = torch.tensor(nfo["iterations"])
            return res, km

        mbk_states = []
        plain, km = one_rank()
        mbk_path = [np.stack([c for c, _ in mbk_states]),
                    np.stack([n for _, n in mbk_states])]
        # A.2b's part (ii) on one rank: the main path's fits where the
        # phases left them (MESH_ONE), else fitted here
        data3 = mesh_a2b3_data(z)
        keys3 = mesh_a2b3_keys(z)
        one3 = {k: MESH_ONE[key] for k, key in keys3.items()
                if key in MESH_ONE}
        one3.update(mesh_a2b3_fits(dst, z, data3, only=set(keys3) - set(
            one3)))
        # A.2c on one rank: the oracle of the ranks and of the world of one
        data_c = mesh_a2c_data(z)
        t_c = time.perf_counter()
        one_c, _ = mesh_a2c_fits(dst, z, data_c)
        one_c_s = time.perf_counter() - t_c
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dd.reset_comm_stats()
        dd.initialize(f"file://{os.path.join(work, 'store1')}", 1, 0,
                      device=dev, timeout=120)
        try:
            mesh = dst.init()
            check(mesh.backend == backend and mesh.groups is not None,
                  f"the world of one runs {mesh.backend}, not {backend}")
            job1, _ = one_rank()
            comm1 = dd.comm_stats()
            dd.reset_comm_stats()
            t3 = time.perf_counter()
            job3 = mesh_a2b3_arrays(mesh_a2b3_fits(dst, z, data3))
            t3 = time.perf_counter() - t3
            comm3 = dd.comm_stats()
            dd.reset_comm_stats()
            t_c = time.perf_counter()
            job_c, _ = mesh_a2c_fits(dst, z, data_c)
            t_c = time.perf_counter() - t_c
            comm_c = dd.comm_stats()
        finally:
            dd.shutdown()
            dst.init(device=dev)
        arrays3 = mesh_a2b3_arrays(one3)
        for key, want in arrays3.items():
            got = job3[key]
            check(got.shape == want.shape and np.array_equal(
                np.ascontiguousarray(got).view(np.uint8),
                np.ascontiguousarray(want).view(np.uint8)),
                f"mesh: A.2b part (ii)'s {key} under a {backend} world of "
                "one differs from no process group")
        check(comm3.get("reduce_scatter", {}).get("calls", 0) >= 1
              and comm3.get("all_to_all", {}).get("calls", 0) >= 1,
              f"the world of one's forest and cascade ran no exchange: "
              f"{comm3}")
        emit({"phase": "mesh_world_of_one_a2b3", "backend": backend,
              "bit_equal": sorted(arrays3), "fits_s": t3,
              "collectives": comm3})
        del job3
        for key, want in one_c.items():
            got = np.asarray(job_c[key])
            want = np.asarray(want)
            check(got.shape == want.shape and np.array_equal(
                np.ascontiguousarray(got).view(np.uint8),
                np.ascontiguousarray(want).view(np.uint8)),
                f"mesh: A.2c's {key} under a {backend} world of one "
                "differs from no process group")
        check(all(comm_c.get(name, {}).get("calls", 0) >= 1
                  for name in ("psum", "all_gather", "all_to_all")),
              f"the world of one's A.2c calls ran no collective: {comm_c}")
        emit({"phase": "mesh_world_of_one_a2c", "backend": backend,
              "bit_equal": sorted(one_c), "one_rank_s": one_c_s,
              "fits_s": t_c, "collectives": comm_c})
        del job_c
        for key, want in plain.items():
            check(torch.equal(job1[key], want), f"mesh: {key} under a "
                  f"{backend} world of one differs from no process group")
        check(comm1.get("broadcast", {}).get("calls", 0) == 4
              and comm1.get("psum", {}).get("calls", 0) >= z["km_iters"]
              + z["gm_iters"]
              and comm1.get("all_gather", {}).get("calls", 0) >= 1,
              f"the world of one ran no collective: {comm1}")
        emit({"phase": "mesh_world_of_one", "backend": backend,
              "bit_equal": sorted(plain), "collectives": comm1})
        if dev.type == "cuda":
            # two NCCL ranks on one card: initialize raises on both
            pair = mesh_spawn(["--mesh-nccl-pair"], 2, work, 120)
            for r, (rc, log) in enumerate(pair):
                check(rc == 0, f"mesh: NCCL rank {r} of two on one card did "
                      f"not raise as it should (exit {rc}):\n{log[-2000:]}")
            emit({"phase": "mesh_nccl_two_ranks_one_card",
                  "raised": [json.loads(next(
                      ln for ln in log.splitlines()
                      if ln.startswith('{"rank"')))["raised"]
                      for _, log in pair]})
        # -- the one-rank results the ranks are held to ------------------------
        rs = mesh_data("rsvd", z)
        S = dst.array(rs)
        sv = dst.random_svd(S, iters=z["rsvd_iters"], nsv=z["rsvd_nsv"],
                            oversample=10, random_state=0)[1]
        pca = dst.PCA(n_components=z["rsvd_nsv"]).fit(S)
        X = dst.array(x_h)
        std, mm = dst.StandardScaler().fit(X), dst.MinMaxScaler().fit(X)
        # GM's kmeans init on one rank: its start, its first Lloyd step
        # (centers and labels) and the labels it ends with
        G1 = dst.array(g_h)
        gi_c0 = dst.KMeans(n_clusters=z["gm_k"], max_iter=10, tol=1e-4,
                           random_state=0)._init_centers(G1).cpu().numpy()
        gi1 = dst.KMeans(n_clusters=z["gm_k"], init=gi_c0, max_iter=1,
                         tol=0.0).fit(G1)
        gi_lab = dst.GaussianMixture(
            n_components=z["gm_k"], random_state=0)._init_resp(G1)[
                : z["gm_m"]].argmax(1).to(torch.int8).cpu().numpy()
        np.savez(os.path.join(work, "a2b.npz"),
                 tsqr_r=plain["tsqr_r"].cpu().numpy(),
                 gm_weights=plain["gm_weights"].numpy(),
                 gm_means=plain["gm_means"].numpy(),
                 gm_covs=plain["gm_covs"].numpy(),
                 gm_lb=plain["gm_lb"].numpy(),
                 gmi_c0=gi_c0, gmi_centers1=gi1.centers_,
                 gmi_labels1=gi1.predict(G1).collect()[:, 0].astype(np.int8),
                 gmi_labels=gi_lab,
                 rsvd_s=sv.collect().ravel(),
                 pca_var=pca.explained_variance_.collect().ravel(),
                 pca_comp=pca.components_.collect(),
                 std_mean=std.mean_.collect(), std_var=std.var_.collect(),
                 mm_min=mm.data_min_.collect(), mm_max=mm.data_max_.collect())
        # A.2b's second part: Lasso on one rank with the ranks' 4 agents
        # (the consensus of 4 row blocks, kappa = lmbd / (rho · 4)), the
        # R² of the regression, lanczos_svd, and the kNN search over the
        # classifier with its host reads
        admm = importlib.import_module("dislib_tpu_torch.optimization.admm")
        agents = admm._agents
        admm._agents = lambda: MESH_WORLD
        try:
            la4 = dst.Lasso(lmbd=z["lasso"][0], rho=z["lasso"][1],
                            max_iter=int(z["lasso"][2])).fit(
                                dst.array(lx), dst.array(lyl))
        finally:
            admm._agents = agents
        lr_r2 = dst.LinearRegression().fit(dst.array(lx), dst.array(
            ly)).score(dst.array(lx), dst.array(ly))
        lz_s = dst.lanczos_svd(dst.array(mesh_data("lanczos", z)),
                               k=z["lanczos_k"], random_state=0)[1]
        xb, lab = mesh_data("search", z)
        prof.reset_host_reads()
        gs = dst.GridSearchCV(dst.KNeighborsClassifier(), MESH_GS_GRID,
                              cv=3, refit=False).fit(
                                  dst.array(xb), dst.array(
                                      lab.astype(np.float32)[:, None]))
        gs_reads = dict(prof.HOST_READS)
        np.savez(os.path.join(work, "a2b2.npz"),
                 lr_coef=plain["lr_coef"].numpy(),
                 lr_intercept=plain["lr_intercept"].numpy(), lr_r2=lr_r2,
                 lasso_coef=la4.coef_, lasso_n_iter=la4.n_iter_,
                 mbk_centers=plain["mbk_centers"].numpy(),
                 mbk_counts=plain["mbk_counts"].numpy(),
                 mbk_path_centers=mbk_path[0], mbk_path_counts=mbk_path[1],
                 mbk_history=plain["mbk_history"].numpy(),
                 qr_r=plain["qr_r"].cpu().numpy(),
                 svd_s=plain["svd_s"].cpu().numpy().ravel(),
                 polar_h=plain["polar_h"].cpu().numpy(),
                 polar_iters=plain["polar_iters"].numpy(),
                 lanczos_s=lz_s.collect().ravel(),
                 gs_scores=np.stack([gs.cv_results_[f"split{j}_test_score"]
                                     for j in range(3)]),
                 gs_best=json.dumps(gs.best_params_, sort_keys=True),
                 gs_reads=json.dumps(gs_reads, sort_keys=True))
        # polar's U, which each rank reads its rows of
        np.save(os.path.join(work, "polar_u.npy"),
                plain["polar_u"].cpu().numpy())
        # A.2b's part (ii): one rank's fitted arrays, the forest's score
        # and CascadeSVM's decision values
        x3, y3, _ = data3["forest"]
        X3 = dst.array(x3)
        np.savez(os.path.join(work, "a2b3.npz"), **arrays3,
                 rf_score=one3["rf"].score(X3, dst.array(y3)),
                 sv_dec=one3["sv"].decision_function(dst.array(
                     data3["sv"][0])).collect()[:, 0])
        del X3, x3, y3, one3, data3, arrays3
        # A.2c: one rank's results, the IVF gate queries' float64 k-th
        # distances and one rank's recall under each route
        kq, gate_q = z["ivf"][3], z["ivf"][7]
        kth = ivf_kth(data_c["ivf_x"], data_c["ivf_q"][:gate_q], kq, dev)
        np.savez(os.path.join(work, "a2c.npz"), **one_c, ivf_kth=kth,
                 **{f"ivf_{r}_recall": ivf_recall(
                     data_c["ivf_x"], data_c["ivf_q"],
                     one_c[f"ivf_{r}_i"][:, :kq], kth)
                    for r in ("db", "kernel")})
        del one_c, data_c, kth
        del job1, plain, a_h, b_h, t_h, g_h, rs, S, sv, pca, X, std, mm
        del G1, gi1, gi_lab, lx, ly, lyl, q_h, s_h, p_h, la4, xb, lab, gs
        X = dst.array(x_h)
        km1 = dst.KMeans(n_clusters=z["km_k"], init=init, max_iter=1,
                         tol=0.0).fit(X)
        np.savez(os.path.join(work, "kmeans.npz"), centers=km.centers_,
                 inertia=km.inertia_, centers1=km1.centers_,
                 labels1=km1.predict(X).collect()[:, 0])
        del km, km1, X, x_h
        f_h, q_h = mesh_data("knn", z)
        od, oi = dst.NearestNeighbors(n_neighbors=z["knn_k"] + 1).fit(
            dst.array(f_h)).kneighbors(dst.array(q_h))
        np.savez(os.path.join(work, "knn.npz"), dist=od.collect(),
                 idx=oi.collect())
        del od, oi, f_h, q_h
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        # -- 4 gloo ranks on this card ----------------------------------------
        with open(os.path.join(work, "job.json"), "w") as f:
            json.dump({"world": MESH_WORLD, "device": str(dev), "sizes": z,
                       "timeout_s": MESH_RANK_S}, f)
        t0 = time.perf_counter()
        done = mesh_spawn(["--mesh-rank"], MESH_WORLD, work, MESH_RANK_S)
        ranks_s = time.perf_counter() - t0
        for r, (rc, log) in enumerate(done):
            check(rc == 0, f"mesh: rank {r} failed (exit {rc}):\n"
                  f"{log[-4000:]}")
        ranks = []
        for r in range(MESH_WORLD):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        if overlap is None:
            del os.environ["DSLIB_OVERLAP"]
        else:
            os.environ["DSLIB_OVERLAP"] = overlap
        shutil.rmtree(work, ignore_errors=True)
    for name in ranks[0]["phases"]:
        emit({"phase": f"mesh_{name}", "backend": MESH_BACKEND,
              "card": card, "ranks": [{
                  "rank": rr["rank"], **rr["phases"][name]} for rr in ranks]})
    emit({"phase": "mesh_kernel_windows", "backend": MESH_BACKEND,
          "card": card, "ranks": [{"rank": rr["rank"], **rr["windows"]}
                                  for rr in ranks]})
    # -- the kernels line's rows at the per-rank shapes (rank 0's windows) --
    w0, shapes = ranks[0]["windows"], ranks[0]["shapes"]

    def launches(phase, name):
        return sum(rr["phases"][phase]["launches"][name] for rr in ranks)

    entries = {}
    h = shapes["summa_panel"][0]
    for pol, ops, peak, basis in (
            ("float32", 3 * 2.0 * h ** 3, PEAK_TF32_FLOPS,
             "3xTF32: three 2n^3 TF32 tensor-core products at 495 TFLOP/s"),
            ("bfloat16", 2.0 * h ** 3, PEAK_BF16_FLOPS,
             "one 2n^3 bf16 tensor-core product at 989 TFLOP/s")):
        bound_ms, bound_by = bound(ops, 3 * 4.0 * h * h, peak)
        entries[f"panel_gemm/mesh_{pol}"] = {
            "name": "panel_gemm", "at": "mesh (2, 2): SUMMA's panel on each "
            "rank", "policy": pol, "route": "cuda",
            "source": "dislib_tpu_torch/csrc/panel_gemm.cu",
            "replaces": "dislib_tpu/ops/pallas_kernels.py:76",
            "shape": shapes["summa_panel"],
            "launches": launches(f"summa_{pol}", "panel_gemm"),
            "launches_by_rank": [rr["phases"][f"summa_{pol}"]["launches"][
                "panel_gemm"] for rr in ranks],
            **w0[f"panel_gemm_{pol}_err"], **w0[f"panel_gemm_{pol}"],
            "library_call": "torch.matmul (f32, TF32 off)" if pol ==
            "float32" else "torch.mm(bf16, bf16, out_dtype=float32)",
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_basis": basis,
            "times_from": "rank 0, the card to itself (the ranks in turn)"}
    m, k, d = shapes["kmeans"]
    bound_ms, bound_by = dist_bound(m, k, d, 4.0 * (m * d + k * d + m * k))
    entries["distances_sq/mesh_kmeans"] = {
        "name": "distances_sq", "at": "mesh (4, 1): KMeans' E-step on each "
        "rank's rows", "route": "cuda",
        "source": "dislib_tpu_torch/csrc/distances_sq.cu",
        "replaces": "dislib_tpu/ops/pallas_kernels.py:112",
        "shape": [m, k, d], "launches": launches("kmeans", "distances_sq"),
        "launches_by_rank": [rr["phases"]["kmeans"]["launches"][
            "distances_sq"] for rr in ranks],
        **w0["distances_sq_err"], **w0["distances_sq"],
        "library_call": "torch.cdist(a, b, compute_mode="
                        "'use_mm_for_euclid_dist'), TF32 off (includes a "
                        "square root)",
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_basis": DIST_BOUND_BASIS,
        "times_from": "rank 0, the card to itself (the ranks in turn)"}
    m, k, d = shapes["gm_init"]
    bound_ms, bound_by = dist_bound(m, k, d, 4.0 * (m * d + k * d + m * k))
    entries["distances_sq/mesh_gm_init"] = {
        "name": "distances_sq", "at": "mesh (4, 1): GaussianMixture's "
        "kmeans init on each rank's rows", "route": "cuda",
        "source": "dislib_tpu_torch/csrc/distances_sq.cu",
        "replaces": "dislib_tpu/ops/pallas_kernels.py:112",
        "shape": [m, k, d], "launches": launches("gm", "distances_sq"),
        "launches_by_rank": [rr["phases"]["gm"]["launches"][
            "distances_sq"] for rr in ranks],
        **w0["distances_sq_gm_err"], **w0["distances_sq_gm"],
        "library_call": "torch.cdist(a, b, compute_mode="
                        "'use_mm_for_euclid_dist'), TF32 off (includes a "
                        "square root)",
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_basis": DIST_BOUND_BASIS,
        "times_from": "rank 0, the card to itself (the ranks in turn)"}
    mq, kq, nf = shapes["ring"]
    bound_ms, bound_by = bound(3 * 2.0 * mq * nf * kq,
                               4.0 * (mq * kq + kq * nf + mq * nf),
                               PEAK_TF32_FLOPS)
    entries["panel_gemm/mesh_ring"] = {
        "name": "panel_gemm", "at": "mesh (4, 1): the ring's cross term a "
        "hop", "policy": "float32", "route": "cuda",
        "source": "dislib_tpu_torch/csrc/panel_gemm.cu",
        "replaces": "dislib_tpu/ops/pallas_kernels.py:76",
        "shape": shapes["ring"], "launches": launches("ring_knn",
                                                      "panel_gemm"),
        "launches_by_rank": [rr["phases"]["ring_knn"]["launches"][
            "panel_gemm"] for rr in ranks],
        **w0["panel_gemm_ring_err"], **w0["panel_gemm_ring"],
        "library_call": "torch.mm (f32, TF32 off)",
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_basis": "3xTF32 at 495 TFLOP/s against 4 bytes per element "
                       "of q, f^T and the product",
        "times_from": "rank 0, the card to itself (the ranks in turn)"}
    m, k, d = shapes["mbk"]
    bound_ms, bound_by = dist_bound(m, k, d, 4.0 * (m * d + k * d + m * k))
    entries["distances_sq/mesh_minibatch"] = {
        "name": "distances_sq", "at": "mesh (4, 1): MiniBatchKMeans' "
        "assignment on each rank's rows of a batch", "route": "cuda",
        "source": "dislib_tpu_torch/csrc/distances_sq.cu",
        "replaces": "dislib_tpu/ops/pallas_kernels.py:112",
        "shape": [m, k, d],
        "launches": launches("minibatch_kmeans", "distances_sq"),
        "launches_by_rank": [rr["phases"]["minibatch_kmeans"]["launches"][
            "distances_sq"] for rr in ranks],
        **w0["distances_sq_mbk_err"], **w0["distances_sq_mbk"],
        "library_call": "torch.cdist(a, b, compute_mode="
                        "'use_mm_for_euclid_dist'), TF32 off (includes a "
                        "square root)",
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_basis": DIST_BOUND_BASIS,
        "times_from": "rank 0, the card to itself (the ranks in turn)"}
    mq, kq, nf = shapes["search_ring"]
    bound_ms, bound_by = bound(3 * 2.0 * mq * nf * kq,
                               4.0 * (mq * kq + kq * nf + mq * nf),
                               PEAK_TF32_FLOPS)
    entries["panel_gemm/mesh_search_ring"] = {
        "name": "panel_gemm", "at": "mesh (4, 1): the ring's cross term a "
        "hop in the kNN classifier's search", "policy": "float32",
        "route": "cuda", "source": "dislib_tpu_torch/csrc/panel_gemm.cu",
        "replaces": "dislib_tpu/ops/pallas_kernels.py:76",
        "shape": shapes["search_ring"],
        "launches": launches("search_knn", "panel_gemm"),
        "launches_by_rank": [rr["phases"]["search_knn"]["launches"][
            "panel_gemm"] for rr in ranks],
        **w0["panel_gemm_search_ring_err"], **w0["panel_gemm_search_ring"],
        "library_call": "torch.mm (f32, TF32 off)",
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_basis": "3xTF32 at 495 TFLOP/s against 4 bytes per element "
                       "of q, f^T and the product",
        "times_from": "rank 0, the card to itself (the ranks in turn)"}
    # A.2b's part (ii): node_histogram at both forests' deepest level on
    # a rank's rows, distances_sq at the ring's ε-step, Daura's medoid
    # column and the cascade's decision block, the batched entry at an
    # owner's node batch
    for key, phase, at in (
            ("rf", "forest", "the forest's deepest level"),
            ("rr", "forest_regressor", "the regressor's deepest level")):
        T, m, n, nn, nb, S, integer = shapes[f"hist_{key}"]
        bound_ms, bound_by = bound(T * m * (n + 1) * S, 4.0 * (
            m * n + 2 * T * m + m * S + T * nn * n * nb * S),
            PEAK_FP32_FLOPS)
        entries[f"node_histogram/mesh_{key}"] = {
            "name": "node_histogram", "at": f"mesh (4, 1): {at} on each "
            "rank's rows", "route": "cuda",
            "source": "dislib_tpu_torch/csrc/node_histogram.cu",
            "replaces": "dislib_tpu/ops/pallas_kernels.py:149",
            "shape": [T, m, n, nn, nb, S], "fixed_order": not integer,
            "launches": launches(phase, "node_histogram"),
            "launches_by_rank": [rr["phases"][phase]["launches"][
                "node_histogram"] for rr in ranks],
            **w0[f"node_histogram_{key}_err"], **w0[f"node_histogram_{key}"],
            "library_call": "Tensor.index_put_(accumulate=True), one per "
                            "tree",
            "reduce_scatter": [rr["phases"][phase]["collectives"].get(
                "reduce_scatter") for rr in ranks],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "times_from": "rank 0, the card to itself (the ranks in turn)"}
    for key, phase, at in (
            ("db", "dbscan", "DBSCAN's ring ε-step (a visiting block "
             "against a row tile)"),
            ("da", "daura", "Daura's ring ε-step (a visiting block against "
             "a row tile)"),
            ("da_col", "daura", "Daura's medoid column on a rank's rows"),
            ("sv_dec", "csvm_decision", "CascadeSVM's decision block on a "
             "rank's rows")):
        m, k, d = shapes[f"dist_{key}"]
        bound_ms, bound_by = dist_bound(m, k, d,
                                        4.0 * (m * d + k * d + m * k))
        if phase == "daura":
            by_rank = [rr["phases"][phase][
                "distances_sq_launches_by_block"][key] for rr in ranks]
        else:
            by_rank = [rr["phases"][phase]["launches"]["distances_sq"]
                       for rr in ranks]
        entries[f"distances_sq/mesh_{key}"] = {
            "name": "distances_sq", "at": f"mesh (4, 1): {at}",
            "route": "cuda",
            "source": "dislib_tpu_torch/csrc/distances_sq.cu",
            "replaces": "dislib_tpu/ops/pallas_kernels.py:112",
            "shape": [m, k, d], "launches": sum(by_rank),
            "launches_by_rank": by_rank,
            **w0[f"distances_sq_{key}_err"], **w0[f"distances_sq_{key}"],
            "library_call": "torch.cdist(a, b, compute_mode="
                            "'use_mm_for_euclid_dist'), TF32 off (includes "
                            "a square root)",
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_basis": DIST_BOUND_BASIS,
            "times_from": "rank 0, the card to itself (the ranks in turn)"}
    nb_, cap, d = shapes["dist_sv_gram"]
    bound_ms, bound_by = dist_bound(cap, cap, d, 4.0 * (
        2 * nb_ * cap * d + nb_ * cap * cap), batch=nb_)
    entries["distances_sq/mesh_csvm_gram"] = {
        "name": "distances_sq", "at": "mesh (4, 1): CascadeSVM's sub-Grams "
        "of an owner's node batch (batched entry, level 0)",
        "route": "cuda", "source": "dislib_tpu_torch/csrc/distances_sq.cu",
        "replaces": "dislib_tpu/ops/pallas_kernels.py:112",
        "entry": "dslib_distances_sq_f32_batched",
        "shape": [nb_, cap, cap, d], "launches": launches("csvm",
                                                          "distances_sq"),
        "launches_by_rank": [rr["phases"]["csvm"]["launches"][
            "distances_sq"] for rr in ranks],
        **w0["distances_sq_sv_gram_err"], **w0["distances_sq_sv_gram"],
        "library_call": "torch.cdist(a, a, compute_mode="
                        "'use_mm_for_euclid_dist').square(), batched",
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_basis": DIST_BOUND_BASIS,
        "times_from": "rank 0, the card to itself (the ranks in turn)"}
    # A.2c: the IVF's centroid product and its quantizer's E-step on a
    # rank's queries and rows
    mq, kk, nl = shapes["ivf_gemm"]
    bound_ms, bound_by = bound(3 * 2.0 * mq * kk * nl,
                               4.0 * (mq * kk + kk * nl + mq * nl),
                               PEAK_TF32_FLOPS)
    entries["panel_gemm/mesh_ivf"] = {
        "name": "panel_gemm", "at": "mesh (4, 1): the IVF centroid product "
        "on each rank's queries (overlap='kernel')", "policy": "float32",
        "route": "cuda", "source": "dislib_tpu_torch/csrc/panel_gemm.cu",
        "replaces": "dislib_tpu/ops/pallas_kernels.py:76",
        "shape": shapes["ivf_gemm"], "launches": launches("ivf",
                                                          "panel_gemm"),
        "launches_by_rank": [rr["phases"]["ivf"]["launches"]["panel_gemm"]
                             for rr in ranks],
        **w0["panel_gemm_ivf_err"], **w0["panel_gemm_ivf"],
        "library_call": "torch.mm (f32, TF32 off)",
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_basis": "3xTF32 at 495 TFLOP/s against 4 bytes per element "
                       "of q, the centroids^T and the product",
        "times_from": "rank 0, the card to itself (the ranks in turn)"}
    m, k, d = shapes["ivf_dist"]
    bound_ms, bound_by = dist_bound(m, k, d, 4.0 * (m * d + k * d + m * k))
    entries["distances_sq/mesh_ivf_kmeans"] = {
        "name": "distances_sq", "at": "mesh (4, 1): the IVF quantizer's "
        "E-step on each rank's catalog rows", "route": "cuda",
        "source": "dislib_tpu_torch/csrc/distances_sq.cu",
        "replaces": "dislib_tpu/ops/pallas_kernels.py:112",
        "shape": [m, k, d], "launches": launches("ivf", "distances_sq"),
        "launches_by_rank": [rr["phases"]["ivf"]["launches"][
            "distances_sq"] for rr in ranks],
        **w0["distances_sq_ivf_err"], **w0["distances_sq_ivf"],
        "library_call": "torch.cdist(a, b, compute_mode="
                        "'use_mm_for_euclid_dist'), TF32 off (includes a "
                        "square root)",
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_basis": DIST_BOUND_BASIS,
        "times_from": "rank 0, the card to itself (the ranks in turn)"}
    for e in entries.values():
        emit({"phase": "kernel", **e})
    emit({"phase": "mesh_summary", "backend": MESH_BACKEND, "card": card,
          "ranks_s": ranks_s, "seconds": time.perf_counter() - t_phase,
          "nccl_world_above_one": "not run: one card, and NCCL takes one "
                                  "rank per card"})
    return entries


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one "
              "NVIDIA card", file=sys.stderr)
        return 1
    try:
        import dislib_tpu_torch as dst
    except ImportError as exc:
        print(f"chip_smoke: cannot import dislib_tpu_torch ({exc}); run "
              "from the root of a checkout", file=sys.stderr)
        return 1
    import numpy as np
    from dislib_tpu_torch import _build
    from dislib_tpu_torch.cluster import kmeans as km_mod
    from dislib_tpu_torch.ops import kernels as K
    from dislib_tpu_torch.ops import precision as px
    from dislib_tpu_torch.runtime.loop import EVERY
    from dislib_tpu_torch.utils import profiling as prof

    dev = torch.device(DEVICE)
    torch.cuda.set_device(dev)
    dst.init(device=dev)

    def cuda_ms(fn, reps):
        """Mean device time of ``fn`` over ``reps`` launches after one
        warm-up, by CUDA events."""
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def gemm_err(c, ref, a, b):
        """ERROR_BOUNDS' matmul metric: max |C - C_ref| /
        (||A||_F ||B||_F / sqrt(k))."""
        scale = (torch.linalg.norm(a.double()) * torch.linalg.norm(b.double())
                 / float(a.shape[1]) ** 0.5)
        return float((c.double() - ref.double()).abs().max() / scale)

    def dist_err(d, ref, a, b):
        """Distance error relative to the magnitudes that cancel in
        ‖a‖² − 2a·b + ‖b‖²: max |D - D_ref| / (max ‖a‖² + max ‖b‖²)."""
        scale = float((a.double() ** 2).sum(1).max()
                      + (b.double() ** 2).sum(1).max())
        return float((d.double() - ref.double()).abs().max()) / scale

    # -- (0) the card ----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "card", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # -- (1) the build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.SIGNATURES:
        _build.library(name)
    build_s = time.perf_counter() - t0
    # the panel_gemm library must hold wgmma and TMA instructions, and the
    # wrapper's launch plan must be the compiled one
    gemm_sass = sass_counts(_build.BUILD_INFO["panel_gemm"]["path"],
                            _build.find_nvcc())
    check(all(gemm_sass.values()), f"panel_gemm SASS lacks wgmma or TMA: "
          f"{gemm_sass}")
    for dt in (torch.float32, torch.bfloat16):
        p = K.gemm_plan(GEMM_N, GEMM_N, GEMM_N, dt)
        check(K.gemm_compiled_plan(dt) == (p.bm, p.bn, p.bk, p.stages,
                                           p.smem_bytes),
              f"panel_gemm {dt}: compiled plan {K.gemm_compiled_plan(dt)} "
              f"differs from gemm_plan {p}")
    # the bulk copies of distances_sq, the shared atomics of node_histogram
    other_sass = {name: sass_counts(_build.BUILD_INFO[name]["path"],
                                    _build.find_nvcc(), ops)
                  for name, ops in (("distances_sq", ("UBLKCP", "SYNCS")),
                                    ("node_histogram",
                                     ("ATOMS.CAST", "ATOMS.ADD", "MATCH")))}
    emit({"phase": "build", "seconds": build_s,
          "panel_gemm_sass": gemm_sass, "other_sass": other_sass,
          "kernels": {n: {"seconds": i["seconds"], "cached": i["cached"],
                          "ptxas": [ln.strip() for ln in i["log"].splitlines()
                                    if "registers" in ln or "spill" in ln]}
                      for n, i in _build.BUILD_INFO.items()}})

    # -- (2) each kernel against its plain version on the card --------------------
    g = torch.Generator(device=dev).manual_seed(0)
    gemm_tol = px.ERROR_BOUNDS[("matmul", "float32")]
    dist_tol = DIST_TOL
    for (m, k, n) in GEMM_RAGGED:
        a = torch.randn((m, k), generator=g, device=dev)
        b = torch.randn((k, n), generator=g, device=dev)
        for pol in (px.FLOAT32, px.BFLOAT16):
            err = gemm_err(K.panel_gemm(a, b, pol),
                           K.panel_gemm_plain(a, b, pol), a, b)
            check(err <= gemm_tol, f"panel_gemm {pol.name} {(m, k, n)}: "
                  f"normalized error {err} vs plain > {gemm_tol}")
        bt = b.T.contiguous()
        err = dist_err(K.distances_sq(a, bt), K.distances_sq_plain(a, bt),
                       a, bt)
        check(err <= dist_tol, f"distances_sq {(m, k, n)}: error {err} vs "
              f"plain > {dist_tol}")
    for d in DIST_D:
        for k in DIST_K:
            for offset in (0, 1):
                base = torch.randn(3001 * d + offset, generator=g, device=dev)
                a = base[offset:].view(3001, d)
                b = torch.randn((k, d), generator=g, device=dev)
                err = dist_err(K.distances_sq(a, b),
                               K.distances_sq_plain(a, b, "highest"), a, b)
                check(err <= dist_tol, f"distances_sq d={d} k={k} offset="
                      f"{offset}: error {err} vs plain > {dist_tol}")
            # the bf16 operands: the same exact products summed in another
            # order than the plain version's
            a16, a_sq = K.bf16_rows(a), (a * a).sum(1)
            err = dist_err(K.distances_sq_bf16(a16, a_sq, b),
                           K.distances_sq_bf16_plain(a16, a_sq, b), a, b)
            check(err <= dist_tol, f"distances_sq_bf16 d={d} k={k}: error "
                  f"{err} vs plain > {dist_tol}")
    a = torch.ones((1000, 100), device=dev)
    a[513, 2] = float("nan")
    got = K.distances_sq(a, torch.zeros((10, 100), device=dev))
    check(bool(torch.isnan(got[513]).all()) and not bool(
        torch.isnan(got[torch.arange(1000, device=dev) != 513]).any()),
          "distances_sq: NaN not passed through on the stream")
    # node_histogram: bit-equal to the plain version for integer
    # contributions (sums of integers below 2^24 are exact in any order);
    # for non-integer stats within 1e-5 of the f64 sums relative to each
    # cell's sum of |w·stats| (the atomics add in a varying order, so an
    # f32 sum of N terms strays by ~sqrt(N)·2^-24 of it, ~1e-6 here)
    hist_tol = 1e-5

    def hist_inputs(T, m, n, n_nodes, n_bins, S):
        node = torch.randint(0, n_nodes, (T, m), generator=g, device=dev,
                             dtype=torch.int32)
        bx = torch.randint(0, n_bins, (m, n), generator=g, device=dev,
                           dtype=torch.int32)
        w = torch.poisson(torch.ones((T, m), device=dev), generator=g)
        return node, bx, w

    # both orders of the sums: the integer path (atomics, any order) and
    # the fixed-order path, which must also repeat its bits call to call
    for (T, m, n, nn, nb, S) in HIST_RAGGED:
        node, bx, w = hist_inputs(T, m, n, nn, nb, S)
        st = torch.randint(0, 3, (m, S), generator=g, device=dev).float()
        want = K.node_histogram_plain(node, bx, w, st, nn, nb)
        for integer in (True, False):
            check(torch.equal(K.node_histogram(node, bx, w, st, nn, nb,
                                               integer=integer), want),
                  f"node_histogram {(T, m, n, nn, nb, S)} integer={integer}"
                  ": not bit-equal to plain for integer contributions")
        st = torch.randn((m, S), generator=g, device=dev)
        exact = K.node_histogram_plain(node, bx, w.double(), st.double(),
                                       nn, nb)
        scale = K.node_histogram_plain(node, bx, w, st.abs(), nn, nb)
        for integer in (True, False):
            got = K.node_histogram(node, bx, w, st, nn, nb, integer=integer)
            check(bool(((got.double() - exact).abs()
                        <= hist_tol * scale).all()),
                  f"node_histogram {(T, m, n, nn, nb, S)} integer={integer}"
                  f": non-integer stats off by more than {hist_tol} of sum "
                  "|w*stats|")
        check(torch.equal(got, K.node_histogram(node, bx, w, st, nn, nb)),
              f"node_histogram {(T, m, n, nn, nb, S)}: the fixed-order "
              "sums differ between two calls")
    for kind in HIST_LAYOUTS:
        T, m, n, nn, nb, S = 2, 60_001, 7, 2048, 32, 2
        node, bx, w = hist_inputs(T, m, n, nn, nb, S)
        st = torch.randint(0, 3, (m, S), generator=g, device=dev).float()
        if kind == "one-node":
            node.fill_(1234)
        elif kind == "half-empty":
            node.mul_(2).remainder_(nn)
        elif kind == "node-minus-1":
            node[:, ::3] = -1
        else:
            w[:, 17] = 0
            st[17, 1] = float("nan")
        want = K.node_histogram_plain(node, bx, w, st, nn, nb)
        for integer in (True, False):
            got = K.node_histogram(node, bx, w, st, nn, nb, integer=integer)
            check(torch.equal(torch.nan_to_num(got, nan=-1.0),
                              torch.nan_to_num(want, nan=-1.0))
                  and bool(torch.isnan(got).any()) == (kind ==
                                                       "nan-on-zero-weight"),
                  f"node_histogram layout {kind} integer={integer}: not "
                  "bit-equal to plain")
    torch.cuda.synchronize()
    emit({"phase": "ragged", "ok": True, "panel_gemm_shapes": GEMM_RAGGED,
          "distances_sq_d": DIST_D, "distances_sq_k": DIST_K,
          "distances_sq_bf16_d": DIST_D, "distances_sq_bf16_k": DIST_K,
          "distances_sq_unaligned": True,
          "node_histogram_layouts": HIST_LAYOUTS,
          "node_histogram_bit_equal_integer": len(HIST_RAGGED),
          "node_histogram_non_integer_tol": hist_tol,
          "node_histogram_fixed_order_bit_identical": len(HIST_RAGGED)})

    kernels = {}
    # panel_gemm at the main path's shape: SUMMA's one panel on one card
    a = torch.randn((GEMM_N, GEMM_N), generator=g, device=dev)
    b = torch.randn((GEMM_N, GEMM_N), generator=g, device=dev)
    rows = torch.randperm(GEMM_N, generator=g, device=dev)[:256]
    ref_rows = a[rows].double() @ b.double()
    # the faithfulness yardstick: a single-pass TF32 product of the same
    # rows (cuBLAS with TF32 allowed), timed nowhere
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        err_tf32 = gemm_err(torch.matmul(a[rows], b), ref_rows, a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    flops = 2.0 * GEMM_N ** 3
    nbytes = 3 * 4.0 * GEMM_N ** 2
    # FLOAT32 is the 3xTF32 product: three TF32 tensor-core products
    for pol, ops, peak, basis in (
            (px.FLOAT32, 3 * flops, PEAK_TF32_FLOPS,
             "3xTF32: three 2n^3 TF32 tensor-core products at 495 TFLOP/s"),
            (px.BFLOAT16, flops, PEAK_BF16_FLOPS,
             "one 2n^3 bf16 tensor-core product at 989 TFLOP/s")):
        out = K.panel_gemm(a, b, pol)
        plain = K.panel_gemm_plain(a, b, pol)
        err_plain = gemm_err(out, plain, a, b)
        err_f64 = gemm_err(out[rows], ref_rows, a, b)
        check(err_plain <= gemm_tol, f"panel_gemm {pol.name}: normalized "
              f"error {err_plain} vs plain > {gemm_tol}")
        check(err_f64 <= px.ERROR_BOUNDS[("matmul", pol.name)],
              f"panel_gemm {pol.name}: normalized error {err_f64} vs f64 "
              "rows > ERROR_BOUNDS")
        if pol is px.FLOAT32:
            check(err_f64 <= err_tf32 / 8, f"panel_gemm float32 is not "
                  f"float32-faithful: error {err_f64} vs f64 rows > 1/8 of "
                  f"a single-pass TF32 product's {err_tf32}")
        max_abs = float((out - plain).abs().max())
        del out, plain
        ms = cuda_ms(lambda: K.panel_gemm(a, b, pol), 3)
        _, _, spans = profile_device(lambda: K.panel_gemm(a, b, pol))
        parts = by_part(spans)
        plain_ms = cuda_ms(lambda: K.panel_gemm_plain(a, b, pol), 3)
        if pol is px.FLOAT32:
            lib_call = "torch.matmul (f32, TF32 off)"

            def lib():
                with px.precise():
                    return torch.matmul(a, b)
        else:
            a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
            try:
                torch.mm(a16[:8, :8], b16[:8, :8], out_dtype=torch.float32)
                lib_call = "torch.mm(bf16, bf16, out_dtype=float32)"

                def lib():
                    return torch.mm(a16, b16, out_dtype=torch.float32)
            except (TypeError, RuntimeError):  # no out_dtype here
                lib_call = "torch.matmul(bf16, bf16) (bf16 output)"

                def lib():
                    return torch.matmul(a16, b16)
        library_ms = cuda_ms(lib, 3)
        bound_ms, bound_by = bound(ops, nbytes, peak)
        kernels[f"panel_gemm/{pol.name}"] = {
            "name": "panel_gemm", "policy": pol.name, "route": "cuda",
            "source": "dislib_tpu_torch/csrc/panel_gemm.cu",
            "replaces": "dislib_tpu/ops/pallas_kernels.py:76",
            "shape": [GEMM_N, GEMM_N, GEMM_N],
            "max_abs_err": max_abs, "normalized_err_vs_plain": err_plain,
            "normalized_err_vs_f64_rows": err_f64,
            "tf32_single_pass_err_vs_f64_rows": err_tf32, "ms": ms,
            "ms_by_part_profiled": parts, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_call": lib_call,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_basis": basis}
        emit({"phase": "kernel", **kernels[f"panel_gemm/{pol.name}"]})
    del a, b, a16, b16, ref_rows
    torch.cuda.empty_cache()

    # KMeans data — bench.py's draw: rand(1M, 100) and k rows from seed 0
    rng = np.random.RandomState(0)
    x_host = rng.rand(KM_M, KM_N).astype(np.float32)
    init = x_host[rng.choice(KM_M, KM_K, replace=False)].copy()
    xd = torch.from_numpy(x_host).to(dev)
    cd = torch.from_numpy(init).to(dev)
    kernels["distances_sq"] = dist_entry(K, "kmeans", xd, cd, cuda_ms, 20)
    emit({"phase": "kernel", **kernels["distances_sq"]})
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    del xd

    # node_histogram at the forest's deepest level on the main path: 16
    # trees, 1M rows x 100 features, 2048 nodes x 32 bins, one-hot labels
    # times Poisson weights
    T, m, n, nn, nb, S = RF_T, RF_M, RF_N, 2048, 32, 2
    node, bx, w = hist_inputs(T, m, n, nn, nb, S)
    st = torch.nn.functional.one_hot(
        torch.randint(0, S, (m,), generator=g, device=dev), S).float()
    out = K.node_histogram(node, bx, w, st, nn, nb, integer=True)
    plain = K.node_histogram_plain(node, bx, w, st, nn, nb, integer=True)
    check(torch.equal(out, plain), "node_histogram at the deepest level: "
          "not bit-equal to plain")
    check(torch.equal(plain, K.node_histogram_plain(node, bx, w, st, nn, nb)),
          "node_histogram_plain at the deepest level: the fixed-order sums "
          "differ from the integer scatter")
    max_abs = float((out - plain).abs().max())
    del out, plain
    ms = cuda_ms(lambda: K.node_histogram(node, bx, w, st, nn, nb, integer=True), 5)

    plain_ms = cuda_ms(lambda: K.node_histogram_plain(
        node, bx, w, st, nn, nb, integer=True), 2)
    # the plain version's other sum order, the fixed-order sort path that
    # float contributions take: the reason the integer declaration keeps
    # the scatter is its time over a fit's levels
    plain_fixed_ms = cuda_ms(lambda: K.node_histogram_plain(
        node, bx, w, st, nn, nb), 2)

    def host_ms(fn, reps=3):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps

    # both sum orders on the host, where the plain version is the path a
    # fit takes (``device="cpu"``): a level of 64 nodes of a 16-tree
    # forest on 20,000 x 20 rows
    hc = [t[:, :HIST_CPU_M].cpu() for t in (node % 64, w)]
    hbx, hst = bx[:HIST_CPU_M, :20].cpu(), st[:HIST_CPU_M].cpu()
    plain_cpu = {
        "shape": [T, HIST_CPU_M, 20, 64, nb, S],
        "threads": torch.get_num_threads(),
        "scatter_ms": host_ms(lambda: K.node_histogram_plain(
            hc[0], hbx, hc[1], hst, 64, nb, integer=True)),
        "fixed_order_ms": host_ms(lambda: K.node_histogram_plain(
            hc[0], hbx, hc[1], hst, 64, nb))}
    del hc, hbx, hst
    # the plain version takes the kernel's integer declaration (its
    # index_put_ path); the library call is that same index_put_(accumulate=
    # True), one per tree (one over the whole forest would need T·m·n int64
    # indices, 12.8 GB, and their sort buffers), here on prebuilt indices
    bins = bx.long()
    feat = torch.arange(n, device=dev)[None, :].expand(m, n)
    contrib = w[:, :, None] * st[None]

    def library_ms_at(node_t, n_nodes, reps):
        node_l = node_t.long()
        lib_out = torch.zeros((T, n_nodes, n, nb, S), device=dev)

        def lib():
            for t in range(T):
                lib_out[t].index_put_(
                    (node_l[t][:, None].expand(m, n), feat, bins),
                    contrib[t][:, None, :].expand(m, n, S), accumulate=True)

        return cuda_ms(lib, reps)

    library_ms = library_ms_at(node, nn, 2)

    def hist_bound(n_nodes):
        nbytes = 4.0 * (m * n + 2 * T * m + m * S
                        + T * n_nodes * n * nb * S)
        return bound(T * m * (n + 1) * S, nbytes, PEAK_FP32_FLOPS)

    bound_ms, bound_by = hist_bound(nn)
    # the kernel at each level's shape of a default-depth fit (nodes drawn
    # uniformly: at level 0 every row is in the one node)
    def other_copies(node_t, bx_t, n_nodes):
        """The plan's time and that of the other choice of histogram
        copies (one per warp where the plan shares one, and back), through
        the wrapper with the plan's choice forced."""
        plan_hist = K.hist_plan
        nf = bx_t.shape[1]
        private = plan_hist(T, m, nf, n_nodes, nb, S, n_sms).private
        plan_ms = cuda_ms(lambda: K.node_histogram(
            node_t, bx_t, w, st, n_nodes, nb, integer=True), 3)
        K.hist_plan = lambda *a, **kw: plan_hist(*a, **kw,
                                                 private=not private)
        try:
            other = K.hist_plan(T, m, nf, n_nodes, nb, S, n_sms)
            check(torch.equal(
                K.node_histogram(node_t, bx_t, w, st, n_nodes, nb,
                                 integer=True),
                K.node_histogram_plain(node_t, bx_t, w, st, n_nodes, nb,
                                       integer=True)),
                f"node_histogram, {nf} features, {n_nodes} nodes, the other"
                " copies: not bit-equal to plain")
            return {"plan_private": private, "plan_ms": plan_ms,
                    "other_plan": other._asdict(),
                    "other_ms": cuda_ms(lambda: K.node_histogram(
                        node_t, bx_t, w, st, n_nodes, nb, integer=True), 3)}
        finally:
            K.hist_plan = plan_hist

    per_level, per_level_bound, plain_level, lib_level = {}, {}, {}, {}
    plain_fixed_level = {}
    lnodes, private_level = [], {}
    for lvl in range(12):
        lnode = torch.randint(0, 2 ** lvl, (T, m), generator=g, device=dev,
                              dtype=torch.int32)
        lnodes.append(lnode)
        per_level[2 ** lvl] = cuda_ms(
            lambda: K.node_histogram(lnode, bx, w, st, 2 ** lvl, nb,
                                     integer=True), 3)
        private_level[2 ** lvl] = other_copies(lnode, bx, 2 ** lvl)
        plain_level[2 ** lvl] = cuda_ms(
            lambda: K.node_histogram_plain(lnode, bx, w, st, 2 ** lvl, nb,
                                           integer=True), 1)
        plain_fixed_level[2 ** lvl] = cuda_ms(
            lambda: K.node_histogram_plain(lnode, bx, w, st, 2 ** lvl, nb), 1)
        lib_level[2 ** lvl] = library_ms_at(lnode, 2 ** lvl, 1)
        per_level_bound[2 ** lvl] = hist_bound(2 ** lvl)[0]
    # the partition and the histogram at each level: one profiled pass
    # over the 12 level shapes (one profiler session; many in a row can
    # record nothing), split where each call's part_count starts
    _, _, spans = profile_device(
        lambda: [K.node_histogram(ln, bx, w, st, ln_n, nb, integer=True)
                 for ln, ln_n in zip(lnodes, per_level)])
    calls = split_calls(spans, "part_count")
    check(len(calls) == len(per_level), f"profiled {len(calls)} of "
          f"{len(per_level)} node_histogram calls")
    parts_level = {ln_n: by_part(c, HIST_PARTS)
                   for ln_n, c in zip(per_level, calls)}
    parts = parts_level[nn]
    # the same choice at 20 features, where eight copies fit in one group
    bx20 = bx[:, :20].contiguous()
    private_20 = {ln_n: other_copies(ln, bx20, ln_n)
                  for ln, ln_n in zip(lnodes, per_level) if ln_n in (1, 64)}
    del bx20
    del lnode, lnodes, bins, feat, contrib
    kernels["node_histogram"] = {
        "name": "node_histogram", "route": "cuda",
        "source": "dislib_tpu_torch/csrc/node_histogram.cu",
        "replaces": "dislib_tpu/ops/pallas_kernels.py:149",
        "shape": [T, m, n, nn, nb, S], "updates": T * m * n * S,
        "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms,
        "library_call": "Tensor.index_put_(accumulate=True), one per tree "
                        "(the plain version's call)",
        "bound_ms": bound_ms, "bound_by": bound_by,
        "ms_by_n_nodes": per_level, "bound_ms_by_n_nodes": per_level_bound,
        "plain_ms_by_n_nodes": plain_level,
        "plain_fixed_order_ms": plain_fixed_ms,
        "plain_fixed_order_ms_by_n_nodes": plain_fixed_level,
        "plain_fixed_order_ms_fit_levels": sum(plain_fixed_level.values()),
        "plain_on_host": plain_cpu,
        "library_ms_by_n_nodes": lib_level,
        "ms_fit_levels": sum(per_level.values()),
        "bound_ms_fit_levels": sum(per_level_bound.values()),
        "plain_ms_fit_levels": sum(plain_level.values()),
        "library_ms_fit_levels": sum(lib_level.values()),
        "plan": K.hist_plan(T, m, n, nn, nb, S, n_sms)._asdict(),
        "blocks_per_sm": K.hist_occupancy(K.hist_plan(T, m, n, nn, nb, S,
                                                      n_sms)),
        "ms_by_part_profiled": parts,
        "ms_by_part_by_n_nodes": parts_level,
        "profile": PROFILE_LOG[-1],
        "other_copies_ms_by_n_nodes": private_level,
        "other_copies_ms_at_20_features": private_20}
    emit({"phase": "kernel", **kernels["node_histogram"]})
    del node, w, st

    # the regressor's levels (8 trees, depth 8, [w, wy, wy²]): the
    # fixed-order sums it runs now against the atomics it ran before
    # (the integer path, whose adds vary in order for non-integer stats)
    Tr, nnr = RR_T, 2 ** (RR_DEPTH - 1)
    wr = torch.poisson(torch.ones((Tr, m), device=dev), generator=g)
    yr = torch.rand((m,), generator=g, device=dev)
    str_ = torch.stack([torch.ones_like(yr), yr, yr * yr], dim=1)
    rr_level, rr_level_atomic, rr_bound, rr_err = {}, {}, {}, {}

    def hold_rr(lnode, nn, split):
        """The fixed-order sums at one level: equal between two calls and
        within hist_tol of sum |w*stats| of the float64 sums; ``split``:
        the plan must cut some node into several row chunks, so that the
        partial slots and reduce_partials run."""
        what = f"node_histogram at the regressor's level of {nn} nodes"
        plan = K.hist_plan(Tr, m, n, nn, nb, RR_S, n_sms, fixed_order=True)
        rows = int(torch.stack([torch.bincount(lnode[t].long(), minlength=nn)
                                for t in range(Tr)]).max())
        check((-(-rows // plan.rows_per_item) > 1) == split,
              f"{what}: {rows} rows in a node, {plan.rows_per_item} per "
              f"item: expected split={split}")
        out = K.node_histogram(lnode, bx, wr, str_, nn, nb)
        check(torch.equal(out, K.node_histogram(lnode, bx, wr, str_, nn, nb)),
              f"{what}: the fixed-order sums differ between two calls")
        exact = K.node_histogram_plain(lnode, bx, wr.double(), str_.double(),
                                       nn, nb)
        scale = K.node_histogram_plain(lnode, bx, wr, str_.abs(), nn, nb)
        check(bool(((out.double() - exact).abs() <= hist_tol * scale).all()),
              f"{what}: off the f64 sums by more than {hist_tol} of "
              "sum |w*stats|")
        rr_err[nn] = float((out - K.node_histogram_plain(
            lnode, bx, wr, str_, nn, nb)).abs().max())

    for lvl in range(RR_DEPTH):
        lnode = torch.randint(0, 2 ** lvl, (Tr, m), generator=g,
                              device=dev, dtype=torch.int32)
        rr_level[2 ** lvl] = cuda_ms(lambda: K.node_histogram(
            lnode, bx, wr, str_, 2 ** lvl, nb), 3)
        rr_level_atomic[2 ** lvl] = cuda_ms(lambda: K.node_histogram(
            lnode, bx, wr, str_, 2 ** lvl, nb, integer=True), 3)
        rr_bound[2 ** lvl] = bound(
            Tr * m * (n + 1) * RR_S, 4.0 * (m * n + 2 * Tr * m + m * RR_S
                                            + Tr * 2 ** lvl * n * nb * RR_S),
            PEAK_FP32_FLOPS)[0]
        # the first levels split nodes into row chunks (partials summed by
        # reduce_partials); at the deepest, each node is one item
        if 2 ** lvl in (1, 16, nnr):
            hold_rr(lnode, 2 ** lvl, split=2 ** lvl < nnr)
    max_abs = max(rr_err.values())
    bins = bx.long()
    feat = torch.arange(n, device=dev)[None, :].expand(m, n)
    contrib = wr[:, :, None] * str_[None]
    lib_out = torch.zeros((Tr, nnr, n, nb, RR_S), device=dev)

    def lib_rr():
        for t in range(Tr):
            lib_out[t].index_put_(
                (lnode[t].long()[:, None].expand(m, n), feat, bins),
                contrib[t][:, None, :].expand(m, n, RR_S), accumulate=True)

    kernels["node_histogram/regressor"] = {
        "name": "node_histogram", "at": "regressor", "route": "cuda",
        "source": "dislib_tpu_torch/csrc/node_histogram.cu",
        "replaces": "dislib_tpu/ops/pallas_kernels.py:149",
        "shape": [Tr, m, n, nnr, nb, RR_S], "fixed_order": True,
        "max_abs_err": max_abs, "ms": rr_level[nnr],
        "ms_integer_path_atomics": rr_level_atomic[nnr],
        "plain_ms": cuda_ms(lambda: K.node_histogram_plain(
            lnode, bx, wr, str_, nnr, nb), 1),
        "library_ms": cuda_ms(lib_rr, 1),
        "library_call": "Tensor.index_put_(accumulate=True), one per tree",
        "bound_ms": rr_bound[nnr], "bound_by": bound(
            Tr * m * (n + 1) * RR_S, 4.0 * (m * n + 2 * Tr * m + m * RR_S
                                            + Tr * nnr * n * nb * RR_S),
            PEAK_FP32_FLOPS)[1],
        "ms_by_n_nodes": rr_level,
        "ms_integer_path_by_n_nodes": rr_level_atomic,
        "max_abs_err_by_n_nodes": rr_err,
        "bound_ms_by_n_nodes": rr_bound,
        "ms_fit_levels": sum(rr_level.values()),
        "ms_integer_path_fit_levels": sum(rr_level_atomic.values()),
        "plan": K.hist_plan(Tr, m, n, nnr, nb, RR_S, n_sms,
                            fixed_order=True)._asdict(),
        "plan_first_level": K.hist_plan(Tr, m, n, 1, nb, RR_S, n_sms,
                                        fixed_order=True)._asdict()}
    emit({"phase": "kernel", **kernels["node_histogram/regressor"]})
    del lnode, bx, wr, yr, str_, bins, feat, contrib, lib_out
    torch.cuda.empty_cache()

    # -- (3) KMeans, 1M x 100, k = 10 -----------------------------------------------
    x = dst.array(x_host)
    check(x.device == dev, f"ds.array landed on {x.device}")
    # gate: one device iteration against a NumPy float64 Lloyd iteration
    x64, c64 = x_host.astype(np.float64), init.astype(np.float64)
    d64 = ((x64 * x64).sum(1)[:, None] - 2.0 * (x64 @ c64.T)
           + (c64 * c64).sum(1)[None])
    lab64 = d64.argmin(1)
    onehot = np.zeros((KM_M, KM_K))
    onehot[np.arange(KM_M), lab64] = 1.0
    counts = onehot.sum(0)
    sums = onehot.T @ x64
    want = np.where(counts[:, None] > 0,
                    sums / np.maximum(counts, 1)[:, None], c64)
    del x64, d64, onehot
    got = km_mod._kmeans_fit(x._data, x.shape, cd, 1, 0.0)[0].cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    dst.KMeans(n_clusters=KM_K, init=init, max_iter=2, tol=0.0).fit(x)  # warm

    K.reset_launches()
    prof.reset_host_reads()
    t0 = time.perf_counter()
    km10 = dst.KMeans(n_clusters=KM_K, init=init, max_iter=10,
                      tol=0.0).fit(x)
    t10 = time.perf_counter() - t0
    reads10 = dict(prof.HOST_READS)
    prof.reset_host_reads()
    t0 = time.perf_counter()
    km = dst.KMeans(n_clusters=KM_K, init=init, max_iter=500, tol=0.0).fit(x)
    t500 = time.perf_counter() - t0
    MODELS["KMeans"] = (km, KM_N)
    SERVED["kmeans"] = km           # MODELS is emptied after the saving
    reads500 = dict(prof.HOST_READS)
    labels = km.predict(x)
    score = km.score(x)
    launches_km = dict(K.LAUNCHES)

    check(km10.n_iter_ == 10 and km.n_iter_ == 500,
          f"n_iter {km10.n_iter_}, {km.n_iter_}")
    check(launches_km["distances_sq"] >= 10 + 500,
          f"distances_sq launched {launches_km['distances_sq']} times in "
          "510 KMeans iterations")
    check(np.isfinite(km.centers_).all() and km.centers_.shape == (KM_K, KM_N),
          "KMeans centers not finite / wrong shape")
    check(np.isfinite(km.history_).all() and len(km.history_) == 500,
          "KMeans history")
    lab = labels._data[:, 0]
    check(labels.shape == (KM_M, 1) and lab.dtype == torch.int32
          and int(lab.min()) >= 0 and int(lab.max()) < KM_K,
          "predict labels: shape / dtype / range")
    c_fit = torch.from_numpy(km.centers_).to(dev)
    d_plain = K.distances_sq_plain(x._data, c_fit, "highest")
    agree = float((d_plain.argmin(1).to(torch.int32) == lab).double().mean())
    check(agree >= 0.999, f"predict agrees with the plain argmin on only "
          f"{agree} of rows")
    want_score = -float(d_plain.min(1).values.double().sum())
    check(np.isfinite(score) and abs(score - want_score) <= 1e-4 *
          abs(want_score), f"score {score} vs plain {want_score}")
    # where the time of an iteration goes: 50 iterations under
    # torch.profiler, device spans summed by kernel, the busy share of the
    # wall time (the profiler's own host cost lowers it)
    iters = 50
    wall_us, busy, spans = profile_device(
        lambda: dst.KMeans(n_clusters=KM_K, init=init, max_iter=iters,
                           tol=0.0).fit(x))
    emit({"phase": "kmeans_profile", "iterations": iters,
          "wall_ms_per_iter": wall_us / iters / 1e3,
          "device_busy_ms_per_iter": busy / iters / 1e3,
          "device_idle_share": 1.0 - busy / wall_us,
          "kernels_ms_per_iter": top_kernels(spans, per=iters)})

    emit({"phase": "kmeans", "shape": [KM_M, KM_N], "k": KM_K,
          "gate_1iter_vs_numpy_f64": "rtol/atol 2e-3 passed",
          "iter_per_s_10": 10 / t10, "iter_per_s_500": 500 / t500,
          "fit10_s": t10, "fit500_s": t500, "inertia": km.inertia_,
          "score": score, "predict_agrees_with_plain": agree,
          "launches": launches_km, "loop_every": EVERY,
          "host_reads_fit10": reads10, "host_reads_fit500": reads500})
    del labels, d_plain, c_fit, cd

    # -- (3b) KMeans with tol > 0: the fit stops within a chunk -------------
    K.reset_launches()
    prof.reset_host_reads()
    t0 = time.perf_counter()
    kt = dst.KMeans(n_clusters=KM_K, init=init, max_iter=300,
                    tol=1e-4).fit(x)
    t_tol = time.perf_counter() - t0
    steps = K.LAUNCHES["distances_sq"]
    reads = sum(prof.HOST_READS.values())    # the loop's and the results'
    check(kt.n_iter_ <= steps <= kt.n_iter_ + EVERY - 1,
          f"kmeans tol=1e-4: {steps} steps run for n_iter {kt.n_iter_}")
    check(reads <= -(-300 // EVERY) + 1,
          f"kmeans tol=1e-4: {reads} host reads")
    emit({"phase": "kmeans_tol", "shape": [KM_M, KM_N], "k": KM_K,
          "tol": 1e-4, "max_iter": 300, "n_iter": kt.n_iter_,
          "steps_run": steps, "loop_every": EVERY, "host_reads": reads,
          "fit_s": t_tol, "iter_per_s": steps / t_tol})

    # -- (3c) MiniBatchKMeans on the same data -------------------------------
    mbk_entry = minibatch_phase(x, x_host, init, dev, cuda_ms)
    del x, x_host
    torch.cuda.empty_cache()

    # -- (3d) GaussianMixture, BASELINE config 5 --------------------------------
    gm_entry = gm_phase(dev, cuda_ms)
    torch.cuda.empty_cache()

    # -- (3e) the scalers, LinearRegression and Lasso -----------------------------
    scalers_and_regression_phases(dev)
    torch.cuda.empty_cache()

    # -- (4) matmul, 16384^2, SUMMA with the kernel consume step ------------------
    os.environ["DSLIB_OVERLAP"] = "pallas"
    ga = torch.randn((GEMM_N, GEMM_N), generator=g, device=dev)
    gb = torch.randn((GEMM_N, GEMM_N), generator=g, device=dev)
    rows = torch.randperm(GEMM_N, generator=g, device=dev)[:256]
    ref_rows = ga[rows].double() @ gb.double()
    A, B = dst.array(ga), dst.array(gb)
    launches_mm = {}
    for pol in ("float32", "bfloat16"):
        dst.matmul(A, B, algorithm="summa", precision=pol)      # warm
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        C = dst.matmul(A, B, algorithm="summa", precision=pol)
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        launches_mm[pol] = dict(K.LAUNCHES)
        err = gemm_err(C._data[rows], ref_rows, ga, gb)
        check(err <= px.ERROR_BOUNDS[("matmul", pol)],
              f"matmul {pol}: normalized error {err} > ERROR_BOUNDS")
        check(launches_mm[pol]["panel_gemm"] >= 1,
              f"matmul {pol} did not launch panel_gemm")
        check(C.shape == (GEMM_N, GEMM_N) and C.dtype == torch.float32,
              f"matmul {pol}: shape {C.shape} dtype {C.dtype}")
        del C
        # where a call's time goes: one profiled call, device spans by kind
        wall_us, busy, spans = profile_device(
            lambda: dst.matmul(A, B, algorithm="summa", precision=pol))
        emit({"phase": "matmul", "policy": pol, "n": GEMM_N,
              "algorithm": "summa", "overlap": "pallas", "seconds": t,
              "gflops": 2.0 * GEMM_N ** 3 / t / 1e9,
              "normalized_err_vs_f64_rows": err,
              "launches": launches_mm[pol],
              "profiled": {"wall_ms": wall_us / 1e3,
                           "device_busy_ms": busy / 1e3,
                           "device_idle_share": 1.0 - busy / wall_us,
                           "ms_by_part": by_part(spans),
                           "kernels_ms": top_kernels(spans)}})

    # the default route, algorithm="auto": on one card it picks xla, the
    # policy product pdot (FLOAT32 with TF32 off; BFLOAT16 a native bf16
    # product with a float32 result)
    auto = {}
    for pol in ("float32", "bfloat16"):
        dst.matmul(A, B, precision=pol)                         # warm
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        C = dst.matmul(A, B, precision=pol)
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        err = gemm_err(C._data[rows], ref_rows, ga, gb)
        check(err <= px.ERROR_BOUNDS[("matmul", pol)],
              f"matmul auto {pol}: normalized error {err} > ERROR_BOUNDS")
        del C
        auto[pol] = {"seconds": t, "seconds_median_of_3": med_s(
            lambda: dst.matmul(A, B, precision=pol), 3),
            "gflops": 2.0 * GEMM_N ** 3 / t / 1e9,
            "normalized_err_vs_f64_rows": err, "launches": dict(K.LAUNCHES)}
    emit({"phase": "matmul_auto", "n": GEMM_N, "algorithm": "auto",
          "route": "xla (one card)", **auto})

    del A, B, ga, gb, ref_rows
    torch.cuda.empty_cache()

    # -- (5) RandomForestClassifier, 1M x 100, 16 trees, default depth --------
    from dislib_tpu_torch.trees import (DecisionTreeClassifier,
                                        RandomForestClassifier,
                                        RandomForestRegressor)
    x_f, y_f, y_r = forest_data(RF_M, RF_N)
    X, Y = dst.array(x_f), dst.array(y_f)
    torch.cuda.synchronize()

    def fit_rf():
        return RandomForestClassifier(n_estimators=RF_T,
                                      random_state=0).fit(X, Y)

    K.reset_launches()
    t0 = time.perf_counter()
    rf = fit_rf()
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    MODELS["RandomForestClassifier"] = (rf, RF_N)
    MESH_ONE[("rf", RF_M, RF_N, RF_T)] = rf
    launches_rf = dict(K.LAUNCHES)
    check(rf._depth == 12, f"default depth on 1M rows is {rf._depth}")
    check(launches_rf["node_histogram"] == rf._depth,
          f"node_histogram launched {launches_rf['node_histogram']} times "
          f"in a fit of {rf._depth} levels")
    t0 = time.perf_counter()
    pred = rf.predict(X)
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    t0 = time.perf_counter()
    proba = rf.predict_proba(X)
    torch.cuda.synchronize()
    t_proba = time.perf_counter() - t0
    t0 = time.perf_counter()
    acc = rf.score(X, Y)
    t_score = time.perf_counter() - t0
    check(acc >= 0.95, f"forest train accuracy {acc} < 0.95")
    check(proba.shape == (RF_M, 2) and bool(torch.isfinite(
        proba._data).all()), "predict_proba: shape / finite")
    # a NumPy walk of the fitted trees on sampled rows: the same soft vote
    # in f64; rows whose two classes are within 1e-6 are near ties
    rows = np.sort(np.random.RandomState(1).choice(RF_M, min(RF_M, 2000),
                                                   replace=False))
    c = numpy_leaf_stats(rf, x_f[rows]).astype(np.float64)
    mean = (c / np.maximum(c.sum(2, keepdims=True), 1e-12)).mean(0)
    clear = np.abs(mean[:, 0] - mean[:, 1]) > 1e-6
    want = rf.classes_[mean.argmax(1)]
    got = pred.collect().ravel()[rows]
    check(np.array_equal(got[clear], want[clear]),
          f"predict disagrees with the NumPy walk on "
          f"{int((got[clear] != want[clear]).sum())} of {int(clear.sum())} "
          "sampled rows")
    rf2 = fit_rf()
    check(same_forest(rf, rf2), "two fits with random_state=0 differ")
    del pred, proba, rf2
    # where a fit's time goes
    wall_us, busy, spans = profile_device(fit_rf)
    hist_spans = [sp for sp in spans
                  if any(x in sp[2] for subs in HIST_PARTS.values()
                         for x in subs)]
    hist_parts_fit = by_part(hist_spans, HIST_PARTS)
    hist_levels = [sum(e - s_ for s_, e, _ in c) / 1e3
                   for c in split_calls(hist_spans, "part_count")]
    emit({"phase": "forest_profile", "wall_ms": wall_us / 1e3,
          "device_busy_ms": busy / 1e3, "device_idle_share":
          1.0 - busy / wall_us, "node_histogram_ms_by_level": hist_levels,
          "node_histogram_ms": sum(hist_parts_fit.values()),
          "node_histogram_ms_by_part": hist_parts_fit,
          "kernels_ms": top_kernels(spans, n=10)})
    emit({"phase": "forest", "estimator": "RandomForestClassifier",
          "shape": [RF_M, RF_N], "n_estimators": RF_T, "depth": rf._depth,
          "fit_s": t_fit, "predict_s": t_pred, "predict_proba_s": t_proba,
          "score_s": t_score, "train_accuracy": acc,
          "numpy_walk_rows": int(clear.sum()),
          "numpy_walk_near_ties": int((~clear).sum()),
          "same_seed_bit_identical": True, "launches": launches_rf})

    # -- (6) DecisionTreeClassifier: the card against the CPU ------------------
    x_d, lab_d = blobs(DT_M, DT_N, 8, seed=5)
    y_d = (lab_d % 2).astype(np.float32)[:, None]
    K.reset_launches()
    t0 = time.perf_counter()
    gpu = DecisionTreeClassifier().fit(dst.array(x_d), dst.array(y_d))
    t_gpu = time.perf_counter() - t0
    launches_dt = dict(K.LAUNCHES)
    t0 = time.perf_counter()
    cpu = DecisionTreeClassifier().fit(dst.array(x_d, device="cpu"),
                                       dst.array(y_d, device="cpu"))
    t_cpu = time.perf_counter() - t0
    check(launches_dt["node_histogram"] == gpu._depth,
          f"node_histogram launched {launches_dt['node_histogram']} times "
          f"in a tree of {gpu._depth} levels")
    for name in ("_feats", "_tbins"):
        a, b = getattr(gpu, name), getattr(cpu, name)
        if not np.array_equal(a, b):
            first = tuple(int(i) for i in np.argwhere(a != b)[0])
            raise AssertionError(f"decision tree {name} differ between the "
                                 f"card and the CPU, first at (tree, "
                                 f"level, node) {first}")
    check(torch.equal(gpu._edges.cpu(), cpu._edges)
          and torch.equal(gpu._leaves.cpu(), cpu._leaves),
          "decision tree edges / leaves differ between the card and the CPU")
    emit({"phase": "tree_card_vs_cpu", "shape": [DT_M, DT_N],
          "depth": gpu._depth, "identical": True, "fit_card_s": t_gpu,
          "fit_cpu_s": t_cpu, "launches": launches_dt})
    del gpu, cpu

    # -- (7) RandomForestRegressor, 8 trees, depth 8, same x --------------------
    Yr = dst.array(y_r)

    def fit_rr():
        return RandomForestRegressor(n_estimators=8, max_depth=8,
                                     random_state=0).fit(X, Yr)

    K.reset_launches()
    t0 = time.perf_counter()
    rr = fit_rr()
    torch.cuda.synchronize()
    t_rfit = time.perf_counter() - t0
    launches_rr = dict(K.LAUNCHES)
    r2 = rr.score(X, Yr)
    # NumPy oracle of the fitted trees on 100,000 sampled rows
    rows = np.sort(np.random.RandomState(2).choice(RF_M, min(RF_M, 100_000),
                                                   replace=False))
    st = numpy_leaf_stats(rr, x_f[rows]).astype(np.float64)
    want = (st[:, :, 1] / np.maximum(st[:, :, 0], 1e-12)).mean(0)
    got = rr.predict(X).collect().ravel()[rows].astype(np.float64)
    truth = y_r.ravel()[rows].astype(np.float64)

    def r2_of(p):
        return 1.0 - ((truth - p) ** 2).sum() / ((truth - truth.mean())
                                                  ** 2).sum()

    check(launches_rr["node_histogram"] == rr._depth == 8,
          f"node_histogram launched {launches_rr['node_histogram']} times "
          f"in a regressor of {rr._depth} levels")
    check(np.allclose(got, want, rtol=1e-5, atol=1e-5),
          "regressor predict disagrees with the NumPy walk")
    check(abs(r2_of(got) - r2_of(want)) <= 1e-5,
          f"regressor R² {r2_of(got)} vs NumPy oracle {r2_of(want)}")
    check(r2 >= 0.5, f"regressor R² {r2} < 0.5")
    MESH_ONE[("rr", RF_M, RF_N)] = rr
    rr2 = fit_rr()
    # the fixed-order sums of node_histogram and of the leaves make a
    # regressor fitted on the card reproducible per seed
    check(same_forest(rr, rr2), "two regressor fits with random_state=0 "
          "differ")
    emit({"phase": "forest_regressor", "shape": [RF_M, RF_N],
          "n_estimators": 8, "depth": rr._depth, "fit_s": t_rfit, "r2": r2,
          "r2_sample_port": r2_of(got), "r2_sample_numpy": r2_of(want),
          "same_seed_bit_identical": True, "launches": launches_rr})

    # -- (8) the blocked linear algebra ------------------------------------------
    del X, Y, Yr, x_f, y_r
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    la = linalg_phases(dev)
    emit({"phase": "linalg_summary", "seconds": time.perf_counter() - t0,
          **la})

    # -- (9) kNN, the ring, the searches and the splits ---------------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kernels.update(knn_phases(dev, cuda_ms))
    emit({"phase": "knn_summary", "seconds": time.perf_counter() - t0})

    # -- (10) ingest, model saving and KMeans fast_distance ----------------------
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t0 = time.perf_counter()
        X = io_phase(dev, tmp, init)
        km_f32 = MODELS["KMeans"][0]
        saving_phase(dev, tmp)
        kernels["distances_sq/bf16"] = kmeans_fast_phase(dev, X, init,
                                                         km_f32, cuda_ms)
        emit({"phase": "io_saving_fast_summary",
              "seconds": time.perf_counter() - t0})
        del X, km_f32
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- (11) density clustering and the sparse ds-array --------------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kernels.update(dbscan_phase(dev, cuda_ms))
    torch.cuda.empty_cache()
    kernels.update(daura_phase(dev, cuda_ms))
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        x_sv, csr_sv, y_sv = sparse_phase(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "density_sparse_summary",
          "seconds": time.perf_counter() - t0})

    # -- (12) CascadeSVM, the sparse kNN and sparse input ------------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sparse_knn_phase(dev, x_sv, csr_sv, y_sv)
    del x_sv, csr_sv, y_sv
    torch.cuda.empty_cache()
    kernels.update(csvm_phase(dev, cuda_ms))
    csvm_sparse_phase(dev)
    sparse_inputs_phase(dev)
    emit({"phase": "csvm_sparse_knn_inputs_summary",
          "seconds": time.perf_counter() - t0})

    # -- (13) ALS and the IVF index -------------------------------------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    als_phase(dev, cuda_ms)
    kernels.update(ivf_phase(dev, cuda_ms))
    emit({"phase": "als_ivf_summary", "seconds": time.perf_counter() - t0})

    # -- (14) the checkpointed fit: snapshots, kills and resumes ------------------
    torch.cuda.empty_cache()
    res = resilience_phase(dev, smi)
    for name, entry in (("distances_sq", "distances_sq"),
                        ("node_histogram", "node_histogram")):
        kernels[f"{name}/resilience"] = {
            **kernels[entry], "at": "resilience (checked fit; the kernel's "
            "times are the main path's entry at the same shape)",
            "launches": res[name],
            "launches_resumed": res[f"{name}_resumed"]}

    # -- (15) serving: one CUDA-graph replay a batch ---------------------------------
    torch.cuda.empty_cache()
    kernels.update(serving_phase(dev, cuda_ms, smi))

    # -- (16) deployment bundles and the continuous trainer ------------------
    torch.cuda.empty_cache()
    dep = deploy_phase(dev, smi)
    check(dep["trainer"]["distances_sq"] > 0
          and dep["children"]["distances_sq"] > 0
          and dep["children"]["panel_gemm"] > 0,
          f"deploy: a kernel of the path did not launch: {dep}")
    kernels["distances_sq/deploy_trainer"] = {
        **mbk_entry, "at": "deploy (the trainer's "
        "partial_fit batches and the batches its generations served; the "
        "kernel's times are the minibatch entry's at the same shape)",
        "launches": dep["trainer"]["distances_sq"]}
    for name in ("distances_sq", "panel_gemm"):
        kernels[f"{name}/deploy_loaded"] = {
            **kernels[f"{name}/serving"], "at": "deploy (the fresh "
            "processes that loaded the bundles: warm runs and replays; the "
            "kernel's times are the serving entry's at the same shapes)",
            "launches": dep["children"][name]}

    # -- (17) the mesh of ranks: NCCL at a world of one, 4 gloo ranks ------
    torch.cuda.empty_cache()
    kernels.update(mesh_phase(dev, smi))

    # -- (18) the kernels line, then the result ------------------------------
    kernels["node_histogram"]["launches"] = launches_rf["node_histogram"]
    kernels["node_histogram/regressor"]["launches"] = \
        launches_rr["node_histogram"]
    kernels["distances_sq"]["launches"] = launches_km["distances_sq"]
    kernels["distances_sq/gm_init"] = gm_entry
    kernels["distances_sq/minibatch"] = mbk_entry
    for pol in ("float32", "bfloat16"):
        kernels[f"panel_gemm/{pol}"]["launches"] = \
            launches_mm[pol]["panel_gemm"]
    emit({"phase": "profiler", "calls": PROFILE_LOG})
    emit({"phase": "end"})
    print(json.dumps({"kernels": list(kernels.values()),
                      "held_against_plain": True}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank(sys.argv[2:]))
    if sys.argv[1:2] == ["--mesh-nccl-pair"]:
        sys.exit(mesh_nccl_pair(sys.argv[2:]))
    sys.exit(main())
