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
n_lists`` against the exact kNN on a 20,000-row cut) — and checks every
result.  Each
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


_T0 = time.perf_counter()
# the models the phases fit, by class name, with their input width, for
# the saving phase
MODELS = {}


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
    rng = np.random.RandomState(8)
    x = rng.standard_normal((LR_M, LR_N)).astype(np.float32)
    beta = rng.standard_normal(LR_N)
    beta[::2] = 0.0
    beta[1::10] = 1e-3                      # under the Lasso's threshold
    noise = 0.1 * rng.standard_normal(LR_M)
    y = (x @ beta + 0.5 + noise).astype(np.float32)[:, None]
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
    yl = (x @ beta + noise).astype(np.float32)[:, None]
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

    def fit(X):
        K.reset_launches()
        prof.reset_host_reads()
        t0 = time.perf_counter()
        est = Daura(cutoff=DA_CUT).fit(X)
        torch.cuda.synchronize()
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
    n_clusters = len(est.clusters_)
    check(1 < n_clusters < DA_M // 10,
          f"daura 50k: {n_clusters} clusters")
    check(all(est.labels_[c[0]] == i for i, c in enumerate(est.clusters_)),
          "daura 50k: a medoid outside its cluster")
    walls = [t1] + [fit(X)[1] for _ in range(2)]
    emit({"phase": "daura", "cutoff": DA_CUT,
          "gate": {"shape": [DA_GATE_M, DA_N], "clusters": n_cl,
                   "fit_s": t_g, "host_reads": r_g, "launches": l_g,
                   "same_partition_as_numpy": True},
          "timed": {"shape": [DA_M, DA_N], "wall_s_median_of_3":
                    float(np.median(walls)), "walls_s": walls,
                    "clusters": n_clusters, "host_reads": reads,
                    "distances_sq_launches": launches}})
    xc = tiled.pad_cols(X._data)
    block = eps_entries(K, "daura eps-block", xc, X._data, cuda_ms,
                        launches - n_clusters)
    col = dist_entry(K, "daura medoid column", xc, xc[:1].contiguous(),
                     cuda_ms, 20)
    col["launches"] = n_clusters
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
    rng = np.random.RandomState(0)
    m, n, half = CSVM_M, CSVM_N, CSVM_M // 2
    x = np.vstack([rng.randn(half, n) + 2.0,
                   rng.randn(m - half, n) - 2.0]).astype(np.float32)
    y = np.r_[np.ones(half), -np.ones(m - half)].astype(np.float32)
    perm = rng.permutation(m)
    x, y = x[perm], y[perm]
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


def als_ratings():
    """bench_als_sparse's draw: 100 random items a user, a planted rank-16
    score plus noise; the CSR sums the repeated (user, item) draws."""
    import numpy as np
    import scipy.sparse as sp
    m, n, f = ALS_M, ALS_N, ALS_F
    rng = np.random.RandomState(2)
    rows = np.repeat(np.arange(m), ALS_NNZ)
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
    del x, csr, users, items, v_dev, u_dev
    torch.cuda.empty_cache()
    phase_wall("als", t_phase)


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
    rng = np.random.RandomState(3)
    centers = rng.standard_normal((IVF_LISTS, IVF_D)).astype(np.float32) \
        * 4.0
    x = (centers[rng.randint(0, IVF_LISTS, IVF_M)]
         + rng.standard_normal((IVF_M, IVF_D))).astype(np.float32)
    q = (centers[rng.randint(0, IVF_LISTS, IVF_Q)]
         + rng.standard_normal((IVF_Q, IVF_D))).astype(np.float32)
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
    dist_tol = 1e-5
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
    x_f, lab_f = blobs(RF_M, RF_N, 8, seed=5)
    y_f = (lab_f % 2).astype(np.float32)[:, None]
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
    y_r = (np.sin(6.0 * x_f[:, 0]) + 2.0 * x_f[:, 1] ** 2
           + x_f[:, 2]).astype(np.float32)[:, None]
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

    # -- (15) the kernels line, then the result --------------------------------------
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
    sys.exit(main())
