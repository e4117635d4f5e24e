#!/usr/bin/env python3
"""Time the port's kNN top-k and its kNN phases on the card, in one fresh
process.

Run from the root of a checkout::

    PYTHONPATH=. python3 tools/torch_knn_diag.py --topk
    PYTHONPATH=. python3 <this file> --phases      # from any checkout's root

Both modes print the card's name and power limit first.

``--topk`` prints one JSON line per chunk shape, (10000, 4096) with k = 10
(a ``kneighbors`` chunk at bench_knn's size) and (66667, 4096) with k = 15
(a chunk of the kNN search): the CUDA-event mean time of

- ``int64_keys``: every candidate of the chunk keyed ``bits(d²)·2^32 +
  index`` and one int64 ``torch.topk`` over the chunk (the tie rule's
  first form);
- ``chunk_smallest``: ``ops/base.chunk_smallest``, the float32 top-k with
  its tie count (the form the port keeps);
- ``f32_topk``: the float32 ``torch.topk`` alone;
- ``tie_count_int32_in_place``: the compare written as int32 and scanned
  in place (the count the port keeps);
- ``tie_count_bool_cumsum``: ``cumsum(d2 == v, dtype=int32)``, a bool
  compare and a cast pass before the scan;

after checking that ``int64_keys`` and ``chunk_smallest`` give the same
keys on uniform distances and on distances with many exact ties.

``--phases`` builds the kernels and runs ``chip_smoke.knn_phases`` (the
``knn``, ``knn_ring``, ``search`` and ``split`` phases) alone, printing
their JSON lines and then the kernel entries.  It imports the package and
``chip_smoke.py`` found first on the path, so the file may come from
either checkout: run it from the root of each in turns on one card
(parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch


def _card() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)


def _cuda_ms(fn, reps: int = 20) -> float:
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


def _int64_keys(d2, k, off):
    ids = torch.arange(off, off + d2.shape[1], dtype=torch.int32,
                       device=d2.device)
    keys = torch.add(ids.to(torch.int64), d2.view(torch.int32),
                     alpha=1 << 32)
    return torch.topk(keys, k, dim=1, largest=False, sorted=True).values


def topk(dev) -> None:
    from dislib_tpu_torch.ops.base import chunk_smallest
    g = torch.Generator(device=dev).manual_seed(0)
    for mq, n, k in ((10_000, 4096, 10), (66_667, 4096, 15)):
        d2 = torch.rand((mq, n), generator=g, device=dev) * 3.0
        tied = torch.round(d2 * 64) / 64
        for x in (d2, tied):
            if not torch.equal(_int64_keys(x, k, 4096),
                               chunk_smallest(x, k, 4096)):
                raise AssertionError(f"chunk_smallest differs from the "
                                     f"int64 keys at {(mq, n, k)}")
        v = torch.topk(d2, k, dim=1, largest=False).values[:, -1:]

        def in_place():
            return torch.eq(d2, v, out=torch.empty(
                d2.shape, dtype=torch.int32, device=dev)).cumsum_(1)

        print(json.dumps({
            "shape": [mq, n], "k": k,
            "int64_keys_ms": _cuda_ms(lambda: _int64_keys(d2, k, 4096)),
            "chunk_smallest_ms": _cuda_ms(lambda: chunk_smallest(d2, k,
                                                                 4096)),
            "chunk_smallest_tied_ms": _cuda_ms(
                lambda: chunk_smallest(tied, k, 4096)),
            "f32_topk_ms": _cuda_ms(lambda: torch.topk(
                d2, k, dim=1, largest=False, sorted=True)),
            "tie_count_int32_in_place_ms": _cuda_ms(in_place),
            "tie_count_bool_cumsum_ms": _cuda_ms(lambda: torch.cumsum(
                d2 == v, dim=1, dtype=torch.int32))}), flush=True)


def phases(dev) -> None:
    import chip_smoke
    import dislib_tpu_torch as dst
    from dislib_tpu_torch import _build
    dst.init(device=dev)
    _build.build_all()
    for name in _build.SIGNATURES:
        _build.library(name)
    entries = chip_smoke.knn_phases(dev, _cuda_ms)
    print(json.dumps({"kernels": list(entries.values())}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--topk", action="store_true")
    mode.add_argument("--phases", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_knn_diag: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    _card()
    if args.topk:
        topk(dev)
    else:
        phases(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
