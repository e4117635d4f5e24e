"""ProgramCache — the (model generation, bucket) ledger of warmed
programs, and the warmup that fills it.

Counterpart of ``dislib_tpu/serving/cache.py``.  The reference's
executables live in jax's jit cache and its ledger only accounts for
them; the port's programs are CUDA graphs that each pipeline captures
for itself (``serving/pipeline.BucketProgram``), and an entry here holds
the bucket's program — the graph with its static input and output
buffers, or the eager chain and why — beside the warm wall time and the
captures and kernel builds the warm made (the reference records traces).

The never-capture-on-the-hot-path guarantees are structural, as in the
reference: a static server warms its whole ladder in ``start()``, a
ModelPool warms every bucket of a candidate inside the adoption probe
before the swap, and ``PredictServer`` refuses at construction a ladder
wider than its pool's.  Unlike the reference, a new generation captures
its own graphs at warm (a graph replays the buffers it was captured
with); what a swap must not do is build a kernel — ``builds_at_warm``
stays 0 after the first generation.
"""

from __future__ import annotations

import time

import numpy as np

from dislib_tpu_torch.utils import profiling as _prof


class _Entry:
    __slots__ = ("warm_wall_s", "traces", "captures", "builds", "program",
                 "hits")

    def __init__(self, warm_wall_s, traces, captures, builds, program):
        self.warm_wall_s = warm_wall_s
        self.traces = traces
        self.captures = captures
        self.builds = builds
        self.program = program
        self.hits = 0


class ProgramCache:
    """Warmed-program ledger; one per server (or per standalone pipeline
    user).  Keys are ``(generation_token, bucket_rows)``."""

    def __init__(self):
        self._entries: dict[tuple, _Entry] = {}

    def is_warm(self, generation, bucket: int) -> bool:
        return (generation, int(bucket)) in self._entries

    def record_hit(self, generation, bucket: int) -> None:
        e = self._entries.get((generation, int(bucket)))
        if e is not None:
            e.hits += 1

    def warm(self, pipeline, generation, buckets) -> np.ndarray:
        """Warm ``pipeline`` for every bucket under ``generation``: one
        zero batch per bucket (capturing its program, or building it
        eagerly, when the bucket is cold) and return the concatenated
        flat outputs — the caller feeds them to the adoption health gate,
        so warmup and the non-finite check are one pass over the same
        programs.  Re-warming a warm bucket is a cheap probe (one
        dispatch, no capture)."""
        outs = []
        for b in buckets:
            b = int(b)
            t0 = time.perf_counter()
            c0 = _prof.counters()["trace_by"]
            out = pipeline.predict_bucket(
                np.zeros((b, pipeline.n_features), np.float32), b)
            c1 = _prof.counters()["trace_by"]
            delta = {k: n - c0.get(k, 0) for k, n in c1.items()
                     if n != c0.get(k, 0)}
            self._entries[(generation, b)] = _Entry(
                time.perf_counter() - t0, sum(delta.values()),
                delta.get("cuda_graph", 0),
                sum(n for k, n in delta.items() if k.startswith("nvcc:")),
                pipeline.program(b) if hasattr(pipeline, "program")
                else None)
            outs.append(np.asarray(out, np.float64).ravel())
        return np.concatenate(outs) if outs else np.zeros((0,))

    def rekey(self, old_generation, new_generation) -> None:
        """Move every bucket entry from a provisional generation key to
        the real one (hot-swap warms a candidate before its adoption
        token exists — ``ModelPool._warm_probe``) and EVICT every other
        generation's entries: one generation serves at a time, and the
        evicted programs' graphs are freed with their last reference."""
        self._entries = {
            (new_generation, b): e
            for (g, b), e in self._entries.items()
            if g in (old_generation, new_generation)}

    def stats(self) -> dict:
        """Per-entry snapshot, string keys: warm wall, traces (captures
        and builds) at warm, hits, and the program's ``mode``
        (``"graph"`` or ``"eager"``) with the reason for an eager one."""
        return {f"gen={g!r}/bucket={b}": {
                    "warm_wall_s": round(e.warm_wall_s, 6),
                    "traces_at_warm": e.traces,
                    "captures_at_warm": e.captures,
                    "builds_at_warm": e.builds, "hits": e.hits,
                    "mode": getattr(e.program, "mode", None),
                    "eager_reason": getattr(e.program, "reason", None)}
                for (g, b), e in self._entries.items()}

    def __len__(self):
        return len(self._entries)
