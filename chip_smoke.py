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
``RandomForestRegressor`` — and checks every result.  Each phase prints one
JSON line; the line before the last lists every kernel with its launches on
the main path, its error against the plain version, its time, the plain
version's and the library call's time, and the least time the card could
take (``bound_ms``).  The last line is::

    {"ok": true, "device": {"platform": "gpu", "kind": "<card>", "count": 1}}

Any failed check raises, and the script exits non-zero without that line.
It also exits non-zero, printing no result, when there is no CUDA device or
the port is not importable next to it.  It needs no network and imports no
JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# published peaks of one H100 SXM at its full 700 W power limit (NVIDIA's
# data sheet, dense): FP32 outside the tensor cores, bf16 and TF32 tensor
# cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12

KM_M, KM_N, KM_K = 1_000_000, 100, 10
GEMM_N = 16384
# the forest: bench.py's bench_forest data at 1M x 100, 16 trees
RF_M, RF_N, RF_T = 1_000_000, 100, 16
# the tree fitted on the card and on the CPU: bench.py's full forest shape
DT_M, DT_N = 100_000, 20
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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, what) -> None:
    if not cond:
        raise AssertionError(what)


def bound(flops, nbytes, peak_flops):
    """(bound_ms, bound_by): the larger of the operations over the peak
    rate for their type and the bytes over the memory rate."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
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

    The profiler's first kernels after it starts can go unrecorded or run
    slow, so ``fn`` runs once untimed inside it first; only the device
    spans that start inside the marked, timed second call are kept."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    mark = "chip_smoke:window"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        with record_function(mark):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    opened = min(e.time_range.start for e in events
                 if e.name == mark and e.device_type == DeviceType.CPU)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events
                   if e.device_type == DeviceType.CUDA and e.name != mark
                   and e.time_range.start >= opened)
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

    for (T, m, n, nn, nb, S) in HIST_RAGGED:
        node, bx, w = hist_inputs(T, m, n, nn, nb, S)
        st = torch.randint(0, 3, (m, S), generator=g, device=dev).float()
        check(torch.equal(K.node_histogram(node, bx, w, st, nn, nb),
                          K.node_histogram_plain(node, bx, w, st, nn, nb)),
              f"node_histogram {(T, m, n, nn, nb, S)}: not bit-equal to "
              "plain for integer contributions")
        st = torch.randn((m, S), generator=g, device=dev)
        got = K.node_histogram(node, bx, w, st, nn, nb).double()
        exact = K.node_histogram_plain(node, bx, w.double(), st.double(),
                                       nn, nb)
        scale = K.node_histogram_plain(node, bx, w, st.abs(), nn, nb)
        check(bool(((got - exact).abs() <= hist_tol * scale).all()),
              f"node_histogram {(T, m, n, nn, nb, S)}: non-integer stats "
              f"off by more than {hist_tol} of sum |w*stats|")
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
        got = K.node_histogram(node, bx, w, st, nn, nb)
        want = K.node_histogram_plain(node, bx, w, st, nn, nb)
        check(torch.equal(torch.nan_to_num(got, nan=-1.0),
                          torch.nan_to_num(want, nan=-1.0))
              and bool(torch.isnan(got).any()) == (kind ==
                                                   "nan-on-zero-weight"),
              f"node_histogram layout {kind}: not bit-equal to plain")
    torch.cuda.synchronize()
    emit({"phase": "ragged", "ok": True, "panel_gemm_shapes": GEMM_RAGGED,
          "distances_sq_d": DIST_D, "distances_sq_k": DIST_K,
          "distances_sq_unaligned": True,
          "node_histogram_layouts": HIST_LAYOUTS,
          "node_histogram_bit_equal_integer": len(HIST_RAGGED),
          "node_histogram_non_integer_tol": hist_tol})

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
    out = K.distances_sq(xd, cd)
    plain = K.distances_sq_plain(xd, cd, precision="highest")
    err = dist_err(out, plain, xd, cd)
    check(err <= dist_tol, f"distances_sq: error {err} vs plain > {dist_tol}")
    check(bool((out >= 0).all()), "distances_sq: negative distance")
    max_abs = float((out - plain).abs().max())
    del out, plain
    ms = cuda_ms(lambda: K.distances_sq(xd, cd), 20)
    plain_ms = cuda_ms(lambda: K.distances_sq_plain(xd, cd, "highest"), 20)
    bound_ms, bound_by = bound(
        2.0 * KM_M * KM_K * KM_N + 2.0 * (KM_M + KM_K) * KM_N
        + 3.0 * KM_M * KM_K,
        4.0 * (KM_M * KM_N + KM_K * KM_N + KM_M * KM_K), PEAK_FP32_FLOPS)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    kernels["distances_sq"] = {
        "name": "distances_sq", "route": "cuda",
        "source": "dislib_tpu_torch/csrc/distances_sq.cu",
        "replaces": "dislib_tpu/ops/pallas_kernels.py:112",
        "plan": K.dist_plan(KM_M, KM_N, xd.data_ptr(), n_sms)._asdict(),
        "shape": [KM_M, KM_K, KM_N], "max_abs_err": max_abs,
        "normalized_err_vs_plain": err, "ms": ms, "plain_ms": plain_ms,
        "library_ms": None, "library_call": None, "bound_ms": bound_ms,
        "bound_by": bound_by}
    emit({"phase": "kernel", **kernels["distances_sq"]})
    del xd

    # node_histogram at the forest's deepest level on the main path: 16
    # trees, 1M rows x 100 features, 2048 nodes x 32 bins, one-hot labels
    # times Poisson weights
    T, m, n, nn, nb, S = RF_T, RF_M, RF_N, 2048, 32, 2
    node, bx, w = hist_inputs(T, m, n, nn, nb, S)
    st = torch.nn.functional.one_hot(
        torch.randint(0, S, (m,), generator=g, device=dev), S).float()
    out = K.node_histogram(node, bx, w, st, nn, nb)
    plain = K.node_histogram_plain(node, bx, w, st, nn, nb)
    check(torch.equal(out, plain), "node_histogram at the deepest level: "
          "not bit-equal to plain")
    max_abs = float((out - plain).abs().max())
    del out, plain
    ms = cuda_ms(lambda: K.node_histogram(node, bx, w, st, nn, nb), 5)

    plain_ms = cuda_ms(
        lambda: K.node_histogram_plain(node, bx, w, st, nn, nb), 2)
    # the library call is the plain version's own: index_put_(accumulate=
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
        plan_ms = cuda_ms(
            lambda: K.node_histogram(node_t, bx_t, w, st, n_nodes, nb), 3)
        K.hist_plan = lambda *a, **kw: plan_hist(*a, **kw,
                                                 private=not private)
        try:
            other = K.hist_plan(T, m, nf, n_nodes, nb, S, n_sms)
            check(torch.equal(
                K.node_histogram(node_t, bx_t, w, st, n_nodes, nb),
                K.node_histogram_plain(node_t, bx_t, w, st, n_nodes, nb)),
                f"node_histogram, {nf} features, {n_nodes} nodes, the other"
                " copies: not bit-equal to plain")
            return {"plan_private": private, "plan_ms": plan_ms,
                    "other_plan": other._asdict(),
                    "other_ms": cuda_ms(lambda: K.node_histogram(
                        node_t, bx_t, w, st, n_nodes, nb), 3)}
        finally:
            K.hist_plan = plan_hist

    per_level, per_level_bound, plain_level, lib_level = {}, {}, {}, {}
    lnodes, private_level = [], {}
    for lvl in range(12):
        lnode = torch.randint(0, 2 ** lvl, (T, m), generator=g, device=dev,
                              dtype=torch.int32)
        lnodes.append(lnode)
        per_level[2 ** lvl] = cuda_ms(
            lambda: K.node_histogram(lnode, bx, w, st, 2 ** lvl, nb), 3)
        private_level[2 ** lvl] = other_copies(lnode, bx, 2 ** lvl)
        plain_level[2 ** lvl] = cuda_ms(
            lambda: K.node_histogram_plain(lnode, bx, w, st, 2 ** lvl, nb), 1)
        lib_level[2 ** lvl] = library_ms_at(lnode, 2 ** lvl, 1)
        per_level_bound[2 ** lvl] = hist_bound(2 ** lvl)[0]
    # the partition and the histogram at each level: one profiled pass
    # over the 12 level shapes (one profiler session; many in a row can
    # record nothing), split where each call's part_count starts
    _, _, spans = profile_device(
        lambda: [K.node_histogram(ln, bx, w, st, ln_n, nb)
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
        "other_copies_ms_by_n_nodes": private_level,
        "other_copies_ms_at_20_features": private_20}
    emit({"phase": "kernel", **kernels["node_histogram"]})
    del node, bx, w, st
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
    t0 = time.perf_counter()
    km10 = dst.KMeans(n_clusters=KM_K, init=init, max_iter=10,
                      tol=0.0).fit(x)
    t10 = time.perf_counter() - t0
    t0 = time.perf_counter()
    km = dst.KMeans(n_clusters=KM_K, init=init, max_iter=500, tol=0.0).fit(x)
    t500 = time.perf_counter() - t0
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
          "launches": launches_km})
    del x, labels, d_plain, c_fit, cd
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
    emit({"phase": "forest_regressor", "shape": [RF_M, RF_N],
          "n_estimators": 8, "depth": rr._depth, "fit_s": t_rfit, "r2": r2,
          "r2_sample_port": r2_of(got), "r2_sample_numpy": r2_of(want),
          "same_seed_bit_identical": same_forest(rr, rr2),
          "launches": launches_rr})

    # -- (8) the kernels line, then the result --------------------------------------
    kernels["node_histogram"]["launches"] = launches_rf["node_histogram"]
    kernels["distances_sq"]["launches"] = launches_km["distances_sq"]
    for pol in ("float32", "bfloat16"):
        kernels[f"panel_gemm/{pol}"]["launches"] = \
            launches_mm[pol]["panel_gemm"]
    emit({"kernels": list(kernels.values()), "held_against_plain": True})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
