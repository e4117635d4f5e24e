#!/usr/bin/env python3
"""Measure what two repairs in the port's linear algebra guard against, and
time the calls a change can move, in one fresh process.

Run from the root of a checkout::

    PYTHONPATH=. python3 tools/torch_linalg_diag.py         # on the card
    PYTHONPATH=. python3 tools/torch_linalg_diag.py --cpu   # on the CPU
    PYTHONPATH=. python3 <this file> --ab          # from any checkout's root
    PYTHONPATH=. python3 tools/torch_linalg_diag.py --loop-every

The default mode prints one JSON line per measurement, after the card's
name and power limit:

- ``pair_svd``: the (4, 128, 128) R factors of the block-Jacobi SVD's first
  round on ``bench_svd``'s data (uniform 4096 x 512, seed 0), factored by
  ``torch.linalg.svd`` alone and by ``math.base._pair_svd``: max |UᵀU − I|,
  max |VVᵀ − I| and the reconstruction error relative to max |R|;
- ``svd``: that data through ``svd`` with ``_pair_svd`` and with
  ``torch.linalg.svd`` in its place: the values' error relative to σ₁ and
  the residual ‖A − U S Vᵀ‖_F / ‖A‖_F against float64 NumPy, and sweeps;
- ``qr_full``: ``qr(mode="full")`` of a standard normal 4096 x 512 (seed 0)
  with the complement projected against Q₁ once (the reference's
  algorithm) and twice (the port's), under both policies: ‖QᵀQ − I‖_max
  and max |Q₁ᵀQ₂|.

``--ab`` prints one JSON line of timings, to compare two checkouts: run it
from the root of each in turns on one card (parent, change, change,
parent).  It imports the package and ``chip_smoke.py`` (for its
``profile_device`` and ``med_s``) found first on the path, so the file may
come from either checkout:

- ``kmeans``: KMeans on 1,000,000 x 100 (bench.py's draw), k = 10,
  ``tol=0``: iterations per second of a 500-iteration fit;
- ``random_svd`` (32768 x 1024, nsv 64, iters 2), ``polar``
  (16384 x 1024) and ``lanczos_svd`` (8192 x 512, k 6), under each policy:
  the median wall time of 5 calls, and the wall and device busy time of
  one profiled call;
- ``svd_block`` (4096 x 512), ``svd_scalar`` (4096 x 100) and ``qr_full``
  (4096 x 512), float32: the median wall time of 3 calls;
- ``forest``: the wall times of four fits of a 16-tree
  ``RandomForestClassifier`` on 1,000,000 x 100 rows (``bench.py``'s
  ``bench_forest`` draw), the first carrying the process's first-call
  costs, and the device busy time of one more.

``--loop-every`` times that KMeans at ``tol=1e-4`` (``max_iter`` 300) and
at ``tol=1e-30`` (a read after every chunk, 500 steps) with
``runtime.loop.EVERY`` set to 1, 2, 4, 8 and 16 in turn, and at ``tol=0``
(no reads): seconds, steps run, ``n_iter_`` and host reads of each fit.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time

import numpy as np
import torch


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def synced(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _km_data():
    rng = np.random.RandomState(0)
    x = rng.rand(1_000_000, 100).astype(np.float32)
    return x, x[rng.choice(len(x), 10, replace=False)].copy()


def ab(dev) -> None:
    import chip_smoke as cs
    import dislib_tpu_torch as dst
    from dislib_tpu_torch import _build
    from dislib_tpu_torch.trees import RandomForestClassifier
    dst.init(device=dev)
    _build.build_all()
    out = {"package": dst.__file__}
    x, init = _km_data()
    X = dst.array(x)
    dst.KMeans(n_clusters=10, init=init, max_iter=5, tol=0.0).fit(X)
    t0 = time.perf_counter()
    dst.KMeans(n_clusters=10, init=init, max_iter=500, tol=0.0).fit(X)
    out["kmeans_iter_per_s_500"] = 500 / (time.perf_counter() - t0)
    del X
    rng = np.random.RandomState(0)
    xr = (rng.standard_normal((32768, 1024)) * 0.95 ** np.arange(1024)) \
        .astype(np.float32)
    xp = np.random.RandomState(0).standard_normal((16384, 1024)).astype(
        np.float32)
    rng = np.random.RandomState(6)
    xl = (rng.standard_normal((8192, 512)) * 0.9 ** np.arange(512)).astype(
        np.float32)
    R, P, L = dst.array(xr), dst.array(xp), dst.array(xl)
    for pol in ("float32", "bfloat16"):
        calls = {
            "random_svd": lambda: dst.random_svd(
                R, iters=2, nsv=64, oversample=10, random_state=0,
                precision=pol),
            "polar": lambda: dst.polar(P, precision=pol),
            "lanczos_svd": lambda: dst.lanczos_svd(
                L, k=6, random_state=0, precision=pol)}
        for name, fn in calls.items():
            fn()
            wall_us, busy_us, _ = cs.profile_device(fn)
            out[f"{name}_{pol}"] = {"median_s": cs.med_s(fn, 5),
                                    "profiled_wall_ms": wall_us / 1e3,
                                    "device_busy_ms": busy_us / 1e3}
    del R, P, L
    # the launch-bound calls: the block and scalar SVD tiers (bench_svd's
    # uniform draw) and qr full, float32, the median of 3
    xs = np.random.RandomState(0).rand(4096, 512).astype(np.float32)
    xq = np.random.RandomState(0).standard_normal((4096, 512)).astype(
        np.float32)
    S, S1, Q = dst.array(xs), dst.array(xs[:, :100].copy()), dst.array(xq)
    for name, fn in (("svd_block", lambda: dst.svd(S)),
                     ("svd_scalar", lambda: dst.svd(S1)),
                     ("qr_full", lambda: dst.qr(Q, mode="full"))):
        fn()
        out[f"{name}_float32"] = {"median_s": cs.med_s(fn, 3)}
    del S, S1, Q
    rng = np.random.RandomState(5)              # bench.py's _blobs
    centers = rng.rand(8, 100).astype(np.float32)
    lab = rng.randint(0, 8, 1_000_000)
    xf = (centers[lab] + 0.08 * rng.standard_normal(
        (1_000_000, 100)).astype(np.float32)).astype(np.float32)
    XF = dst.array(xf)
    YF = dst.array((lab % 2).astype(np.float32)[:, None])

    def fit():
        RandomForestClassifier(n_estimators=16, random_state=0).fit(XF, YF)

    synced(dev)
    fits = [cs.med_s(fit, 1) for _ in range(4)]
    out["forest_fit"] = {"fits_s": fits,
                         "device_busy_ms": cs.profile_device(fit)[1] / 1e3}
    emit(out)


def loop_every(dev) -> None:
    import dislib_tpu_torch as dst
    from dislib_tpu_torch import _build
    from dislib_tpu_torch.ops import kernels as K
    from dislib_tpu_torch.runtime import loop
    from dislib_tpu_torch.utils import profiling as prof
    dst.init(device=dev)
    _build.build_all()
    x, init = _km_data()
    X = dst.array(x)
    dst.KMeans(n_clusters=10, init=init, max_iter=5, tol=0.0).fit(X)

    def fit(tol, max_iter):
        K.reset_launches()
        prof.reset_host_reads()
        synced(dev)
        t0 = time.perf_counter()
        km = dst.KMeans(n_clusters=10, init=init, max_iter=max_iter,
                        tol=tol).fit(X)
        return {"seconds": time.perf_counter() - t0, "n_iter": km.n_iter_,
                "steps_run": K.LAUNCHES["distances_sq"],
                "host_reads": dict(prof.HOST_READS)}

    every = loop.EVERY
    try:
        emit({"loop_every": "none", "tol_0": fit(0.0, 500)})
        for e in (1, 2, 4, 8, 16):
            loop.EVERY = e
            emit({"loop_every": e, "tol_1e-4": fit(1e-4, 300),
                  "tol_1e-30": fit(1e-30, 500)})
    finally:
        loop.EVERY = every


def _orth(q: torch.Tensor) -> float:
    eye = torch.eye(q.shape[-1], dtype=q.dtype, device=q.device)
    return float((q.transpose(-2, -1) @ q - eye).abs().max())


def pair_svd(dev, x) -> None:
    from dislib_tpu_torch.math import base
    from dislib_tpu_torch.ops import precision as px
    a = torch.from_numpy(x).to(dev)
    i, j = (torch.as_tensor(base._round_robin_pairs(8)[0], device=dev).T)
    blocks = a.view(a.shape[0], 8, 64)
    w = torch.cat([blocks[:, i], blocks[:, j]], dim=-1).transpose(0, 1)
    with px.precise():
        _, r = torch.linalg.qr(w)
        for name, fn in (("torch.linalg.svd", torch.linalg.svd),
                         ("_pair_svd", base._pair_svd)):
            u, s, vh = fn(r)
            rec = float(((u * s[:, None, :]) @ vh - r).abs().max()
                        / r.abs().max())
            emit({"measure": "pair_svd", "factoring": name,
                  "orth_u": _orth(u), "orth_v": _orth(vh.transpose(1, 2)),
                  "reconstruction": rec})


def svd(dev, x) -> None:
    import dislib_tpu_torch as dst
    from dislib_tpu_torch.math import base
    from dislib_tpu_torch.utils import profiling as prof
    s64 = np.linalg.svd(x.astype(np.float64), compute_uv=False)
    refined = base._pair_svd
    try:
        for name, fn in (("_pair_svd", refined),
                         ("torch.linalg.svd", torch.linalg.svd)):
            base._pair_svd = fn
            prof.reset_host_reads()
            u, s, v = (t.collect().astype(np.float64)
                       for t in dst.svd(dst.array(x, device=dev)))
            s = s.ravel()
            emit({"measure": "svd", "shape": list(x.shape),
                  "pair_factoring": name,
                  "values_err": float(np.abs(s - s64).max() / s64[0]),
                  "resid": float(np.linalg.norm((u * s) @ v.T - x)
                                 / np.linalg.norm(x)),
                  "sweeps": prof.HOST_READS.get("svd_sweep")})
    finally:
        base._pair_svd = refined


def qr_full(dev) -> None:
    import dislib_tpu_torch as dst
    from dislib_tpu_torch.ops import precision as px
    qr_mod = importlib.import_module("dislib_tpu_torch.math.qr")
    twice = qr_mod._qr_full_distributed

    def once(a, m, n, mesh, policy=px.FLOAT32):
        """The reference's algorithm: one projection pass of the seed."""
        cholqr = qr_mod._use_cholqr(a.device)
        q1, r = qr_mod._qr_blocked(a._data, (m, n), mesh, qr_mod._PANEL,
                                   cholqr=cholqr, policy=policy)
        g = qr_mod._qr_complement_seed(q1, (m, n), m - n, mesh, policy)
        q2, _ = qr_mod._qr_blocked(g, (m, m - n), mesh, qr_mod._PANEL,
                                   cholqr=cholqr, policy=policy)
        q = torch.cat([q1[:, :n], q2[:, :m - n]], dim=1)[:m]
        return dst.Array._from_logical(q, mesh), None

    x = np.random.RandomState(0).standard_normal((4096, 512)).astype(
        np.float32)
    n = x.shape[1]
    try:
        for name, fn in (("once", once), ("twice", twice)):
            qr_mod._qr_full_distributed = fn
            for pol in ("float32", "bfloat16"):
                q = dst.qr(dst.array(x, device=dev),
                           precision=pol)[0].collect().astype(np.float64)
                emit({"measure": "qr_full", "shape": list(x.shape),
                      "complement_passes": name, "policy": pol,
                      "orth": float(np.abs(q.T @ q - np.eye(q.shape[0]))
                                    .max()),
                      "q1_q2": float(np.abs(q[:, :n].T @ q[:, n:]).max())})
    finally:
        qr_mod._qr_full_distributed = twice


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--ab", action="store_true",
                      help="time KMeans, three linalg calls and a forest")
    mode.add_argument("--loop-every", action="store_true",
                      help="time KMeans fits at several loop.EVERY")
    args = ap.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA device; pass --cpu", file=sys.stderr)
        return 1
    dev = torch.device("cpu" if args.cpu else "cuda:0")
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip(), flush=True)
    if args.ab or args.loop_every:
        (ab if args.ab else loop_every)(dev)
        return 0
    x = np.random.RandomState(0).rand(4096, 512).astype(np.float32)
    pair_svd(dev, x)
    svd(dev, x)
    qr_full(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
