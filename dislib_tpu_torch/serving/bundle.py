"""Deployment bundles — a served model as one artifact, and a fresh
process that serves it without building a kernel.

Counterpart of ``dislib_tpu/serving/bundle.py``.  The reference
serializes its compiled XLA executables and rehydrates them with zero
traces.  The port has no such object (a ``torch.cuda.CUDAGraph`` cannot
be serialized), so its bundle carries the two things a fresh process
would otherwise have to make:

1. **the compiled device code** — the bytes of every kernel library
   (``_build.loaded_libraries``), keyed by the digest of their source and
   ``NVCC_FLAGS``.  :func:`load_bundle` checks each one's SHA-256 and
   installs it (``_build.install_library``), so the loading process never
   runs ``nvcc`` and needs no toolkit;
2. **what the graphs are captured from** — the pipeline's spec and
   leaves (``capture_bucket``: each step's fitted state in the
   ``save_model`` encoding, the fold-in's item factors, the IVF index's
   buffers), the bucket ladder, and the checksum-verified model state.
   :func:`load_bundle` rebuilds the pipeline and warms and captures every
   bucket (``serving/pipeline.build_program``) before it returns, so the
   first request is a replay.

Failure discipline, typed and loud:

- damaged bytes (truncation, bit rot, a foreign file) raise
  ``SnapshotCorrupt`` from the verified reader;
- a fingerprint mismatch (torch or CUDA version, platform, device name,
  capability or count, mesh shape, pad quantum, the kernels' digest), a
  library whose bytes fail their SHA-256, or a bundle of the JAX
  reference (a ``jax`` fingerprint, no pipeline spec) raises
  :class:`~dislib_tpu_torch.runtime.BundleIncompatible`; pass ``build=``
  to fall back LOUDLY to a pipeline built from the bundle's embedded
  model state instead.  There is never a silent rebuild.

All artifact bytes flow through ``runtime.bundle_io`` and checkpoint
state through the ``runtime.adoption`` gate (the serving lint in
``tests/test_torch_serving.py``).
"""

from __future__ import annotations

import json
import os
import time
import warnings

import numpy as np

from dislib_tpu_torch.parallel import mesh as _mesh
from dislib_tpu_torch.runtime.adoption import adopt_latest
from dislib_tpu_torch.runtime.bundle_io import (BundleIncompatible,
                                                BundleShardCorrupt, file_crc,
                                                read_bundle, shard_path,
                                                write_bundle)
from dislib_tpu_torch.serving.buckets import bucket_ladder
from dislib_tpu_torch.utils import profiling as _prof

__all__ = ["export_bundle", "load_bundle", "BundlePipeline", "LoadedBundle",
           "runtime_fingerprint"]

BUNDLE_FORMAT = "dislib_tpu_torch/1"

# the manifest entry; everything else is a leaf (``leaf_<i>``), a kernel
# library (``lib__<name>``) or model state (``state__<key>``)
_META_KEY = "bundle_meta"
_STATE_PREFIX = "state__"
_LIB_PREFIX = "lib__"

# fingerprint keys that must match for the bundle's libraries and
# buffers to serve here; ``statics`` is informational
_HARD_KEYS = ("format", "torch", "cuda", "platform", "device_kind",
              "capability", "n_devices", "mesh_shape", "pad_quantum",
              "kernels")

# a sharded bundle pins the mesh contract instead of the global shape
_SHARD_HARD_KEYS = tuple(k for k in _HARD_KEYS
                         if k not in ("n_devices", "mesh_shape"))


def runtime_fingerprint() -> dict:
    """The compatibility identity of THIS process: the bundle format,
    torch and CUDA versions, the default mesh's platform (``cuda`` or
    ``cpu``) with the device's name, compute capability and the device
    count, the mesh shape and pad quantum, and the kernels' digest
    (``csrc/*.cu`` and ``NVCC_FLAGS``).  ``statics`` (the overlap route
    and the ladder's env) is informational."""
    import torch

    from dislib_tpu_torch import _build
    dev = _mesh.get_mesh().device
    if dev.type == "cuda":
        kind = torch.cuda.get_device_name(dev)
        capability = list(torch.cuda.get_device_capability(dev))
        n = torch.cuda.device_count()
    else:
        kind, capability, n = dev.type, None, 1
    return {
        "format": BUNDLE_FORMAT,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "platform": dev.type,
        "device_kind": kind,
        "capability": capability,
        "n_devices": n,
        "mesh_shape": list(_mesh.mesh_shape(None)),
        "pad_quantum": int(_mesh.pad_quantum()),
        "kernels": _build.kernels_digest(),
        "statics": {
            "overlap": os.environ.get("DSLIB_OVERLAP", "db"),
            "buckets": os.environ.get("DSLIB_SERVE_BUCKETS", ""),
        },
    }


def _kinds() -> dict:
    from dislib_tpu_torch.retrieval.serving import RetrievalPipeline
    from dislib_tpu_torch.serving.pipeline import ServePipeline
    from dislib_tpu_torch.serving.sparse import SparseFoldInPipeline
    return {"serve": ServePipeline, "sparse_fold_in": SparseFoldInPipeline,
            "retrieval": RetrievalPipeline}


def _resolve_state(checkpoint, state):
    if checkpoint is not None and state is not None:
        raise ValueError("pass at most one of checkpoint= or state=")
    if checkpoint is not None:
        adoption = adopt_latest(checkpoint, build=lambda s: s,
                                name="bundle-export")
        if adoption is None:
            raise ValueError(
                "checkpoint has no generation to embed — save one before "
                "exporting a bundle")
        state = adoption.state
    return state


def _capture_entries(pipeline, buckets):
    """The leaf entries, the per-bucket manifest and the spec: every
    bucket's ``capture_bucket``, the leaves stored once (one bundle holds
    one model, whatever the bucket)."""
    entries, per_bucket, spec = {}, {}, None
    for b in buckets:
        cap = pipeline.capture_bucket(b)
        if spec is None:
            spec, n_leaves = cap["spec"], len(cap["leaves"])
            for i, leaf in enumerate(cap["leaves"]):
                if i != cap["input_slot"]:
                    entries[f"leaf_{i}"] = np.asarray(leaf)
        elif cap["spec"] != spec or len(cap["leaves"]) != n_leaves:
            raise RuntimeError(
                f"bucket {b}: the pipeline's spec differs from bucket "
                f"{buckets[0]}'s — one bundle holds one model")
        per_bucket[str(b)] = {"input_slot": cap["input_slot"],
                              "n_leaves": len(cap["leaves"]),
                              "out_cols": cap["out_cols"],
                              "pshape": cap["pshape"]}
    return entries, per_bucket, spec


def _library_entries(platform):
    """On ``cuda``, every kernel library (loaded first, built if this
    process has not yet) as ``lib__<name>`` entries and their manifest
    records; nothing on the CPU, which runs the plain versions."""
    if platform != "cuda":
        return {}, {}
    from dislib_tpu_torch import _build
    for name in _build.SIGNATURES:
        _build.library(name)
    entries, records = {}, {}
    for name, lib in _build.loaded_libraries().items():
        entries[_LIB_PREFIX + name] = np.frombuffer(lib["bytes"], np.uint8)
        records[name] = {"key": lib["key"], "sha256": lib["sha256"],
                         "bytes": len(lib["bytes"])}
    return entries, records


def _assemble(pipeline, buckets, state):
    fingerprint = runtime_fingerprint()
    entries, per_bucket, spec = _capture_entries(pipeline, buckets)
    libs, records = _library_entries(fingerprint["platform"])
    entries.update(libs)
    if state is not None:
        for k, v in state.items():
            entries[_STATE_PREFIX + k] = np.asarray(v)
    manifest = {"format": BUNDLE_FORMAT, "fingerprint": fingerprint,
                "buckets": list(buckets),
                "n_features": int(pipeline.n_features),
                "spec": spec, "per_bucket": per_bucket,
                "libraries": records}
    return entries, manifest


def export_bundle(pipeline, path: str, buckets=None, checkpoint=None,
                  state=None, hosts=None) -> dict:
    """Write ``pipeline`` as ONE versioned deployment artifact at ``path``.

    Parameters
    ----------
    pipeline : ServePipeline, SparseFoldInPipeline or RetrievalPipeline
        — anything with ``capture_bucket`` and a ``_from_capture`` kind.
        Nothing is executed: each bucket's spec and leaves are read.
    path : str — artifact file (atomic write, embedded checksum).
    buckets : bucket ladder; default per
        :func:`~dislib_tpu_torch.serving.buckets.bucket_ladder`.
    checkpoint : FitCheckpoint, optional — embed the newest generation's
        model state, read THROUGH the ``runtime.adoption`` gate.
    state : dict, optional — embed an explicit state dict instead.
    hosts : int, optional — write a SHARDED bundle: one
        ``<path>.shard<r>`` artifact per host plus the manifest at
        ``path`` (per-shard checksums, fingerprint, mesh contract).  The
        port writes every shard from one process (the reference's mock
        fleet); a job of several ``torch.distributed`` processes raises
        ``NotImplementedError`` (the coordinated barrier is ROADMAP.md
        A.11).

    On ``cuda`` the bundle carries every kernel library.  Returns the
    manifest (also embedded in the artifact) plus ``walls``: the
    ``capture_s`` and ``write_s`` of this export.
    """
    state = _resolve_state(checkpoint, state)
    buckets = bucket_ladder(buckets)
    if hosts is not None:
        return _export_sharded(pipeline, path, buckets, state, int(hosts))
    t0 = time.perf_counter()
    entries, manifest = _assemble(pipeline, buckets, state)
    entries[_META_KEY] = np.asarray(json.dumps(manifest))
    t1 = time.perf_counter()
    write_bundle(path, entries)
    return dict(manifest, walls={"capture_s": t1 - t0,
                                 "write_s": time.perf_counter() - t1})


def _one_process(what):
    """The port's sharded bundle is the one-process form; a job of
    several ``torch.distributed`` processes needs the coordinated
    barrier."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            f"{what} in a job of {dist.get_world_size()} processes: the "
            "coordinated bundle barrier across processes (runtime/coord, "
            "RankDead, the barrier timeout) is ROADMAP.md A.11; the port "
            "writes and verifies every shard in one process")


def _export_sharded(pipeline, path, buckets, state, hosts: int) -> dict:
    _one_process("export_bundle(hosts=...)")
    if hosts < 1:
        raise ValueError(f"export_bundle(hosts={hosts}): need >= 1")
    t0 = time.perf_counter()
    entries, common = _assemble(pipeline, buckets, state)
    # one process stands in for the fleet: each mock host holds this
    # process's devices
    common.update(sharded=True, hosts=hosts, mesh_contract={
        "hosts": hosts,
        "devices_per_host": common["fingerprint"]["n_devices"],
        "mesh_shape": common["fingerprint"]["mesh_shape"],
        "pad_quantum": common["fingerprint"]["pad_quantum"]})
    t1 = time.perf_counter()
    for r in range(hosts):
        shard = dict(entries)
        shard[_META_KEY] = np.asarray(json.dumps(dict(common, host=r)))
        write_bundle(shard_path(path, r), shard)
    manifest = dict(common, shard_crcs=[file_crc(shard_path(path, r))
                                        for r in range(hosts)])
    write_bundle(path, {_META_KEY: np.asarray(json.dumps(manifest))})
    return dict(manifest, walls={"capture_s": t1 - t0,
                                 "write_s": time.perf_counter() - t1})


class BundlePipeline:
    """A ``PredictServer``-ready pipeline rebuilt from a deployment
    bundle: the ``predict_bucket`` contract of the reference's, over the
    rebuilt pipeline whose every bucket was warmed and captured at load.
    A served batch is one CUDA-graph replay on the card, counted as one
    ``bundle_exec`` dispatch (on the CPU, where the chain runs eagerly,
    ``bundle_exec`` is counted beside the eager chain's operations).
    Serves exactly the bundle's ladder.

    Not thread-safe (the ``ServePipeline`` contract): the serving worker
    or one caller drives it.
    """

    def __init__(self, pipeline, buckets):
        self.pipeline = pipeline
        self.buckets = tuple(int(b) for b in buckets)
        self.n_features = int(pipeline.n_features)

    @property
    def out_cols(self):
        return self.pipeline.out_cols

    def program(self, bucket: int):
        bucket = int(bucket)
        if bucket not in self.buckets:
            raise ValueError(
                f"bucket {bucket} is not in the bundle's ladder "
                f"{self.buckets} — a bundle serves exactly the shapes it "
                "was exported for")
        return self.pipeline.program(bucket)

    def predict_bucket(self, rows: np.ndarray, bucket: int) -> np.ndarray:
        if self.program(bucket).mode != "graph":
            _prof.count_dispatch("bundle_exec")
        return self.pipeline.predict_bucket(rows, int(bucket))


class LoadedBundle:
    """:func:`load_bundle`'s result: the servable ``pipeline`` (a
    :class:`BundlePipeline`, or ``build(state)``'s pipeline when
    ``fallback`` is True), the embedded checksum-verified ``state``, the
    ``buckets`` ladder, the exporting process's ``fingerprint``, and
    ``fallback``.  For a SHARDED bundle, ``hosts`` is the fleet size and
    ``host`` the shard this process serves (None for a flat bundle)."""

    __slots__ = ("pipeline", "state", "buckets", "fingerprint", "fallback",
                 "hosts", "host")

    def __init__(self, pipeline, state, buckets, fingerprint, fallback,
                 hosts=None, host=None):
        self.pipeline = pipeline
        self.state = state
        self.buckets = tuple(buckets)
        self.fingerprint = fingerprint
        self.fallback = fallback
        self.hosts = hosts
        self.host = host

    def __repr__(self):
        shard = f", host={self.host}/{self.hosts}" \
            if self.hosts is not None else ""
        return (f"LoadedBundle(buckets={self.buckets}, "
                f"fallback={self.fallback}{shard})")


def _fallback(build, state, meta, err):
    """The loud typed fallback: the bundle cannot serve here as exported,
    but its model state is checksum-verified — build a fresh pipeline
    from it when the caller passed ``build``, else raise."""
    if build is None:
        raise err
    if not state:
        raise BundleIncompatible(
            f"{err} — and the bundle embeds no model state to rebuild "
            "from (export with checkpoint= or state=)",
            expected=err.expected, found=err.found) from err
    warnings.warn(
        f"deployment bundle unusable here ({err}); falling back to a "
        "pipeline built from the bundle's embedded model state — its "
        "kernels build and its graphs capture in this process",
        RuntimeWarning, stacklevel=3)
    return LoadedBundle(build(state), state, meta.get("buckets", ()),
                        meta.get("fingerprint", {}), fallback=True)


def _incompatibility(path, meta, hard_keys):
    """The :class:`BundleIncompatible` of a bundle that cannot serve
    here as exported, or None."""
    here = runtime_fingerprint()
    theirs = meta.get("fingerprint", {})
    if "spec" not in meta:
        who = "the JAX reference" if "jax" in theirs else "another library"
        return BundleIncompatible(
            f"bundle {path} was exported by {who}: it carries no pipeline "
            "spec of dislib_tpu_torch", expected=theirs, found=here)
    mismatched = [k for k in hard_keys if theirs.get(k) != here.get(k)]
    if mismatched:
        diff = {k: {"bundle": theirs.get(k), "here": here.get(k)}
                for k in mismatched}
        return BundleIncompatible(
            f"bundle {path} was exported under a different runtime "
            f"({diff}) — its kernels and buffers cannot serve here",
            expected=theirs, found=here)
    return None


def _install_libraries(path, raw, meta):
    """Install every kernel library of a ``cuda`` bundle from its bytes
    (SHA-256 checked), so nothing builds; BundleIncompatible when one is
    missing or fails its digest."""
    if meta["fingerprint"]["platform"] != "cuda":
        return None
    from dislib_tpu_torch import _build
    records = meta.get("libraries", {})
    missing = sorted(set(_build.SIGNATURES) - set(records))
    try:
        if missing:
            raise ValueError(f"no library for {missing}")
        for name, rec in sorted(records.items()):
            _build.install_library(name, rec["key"],
                                   raw[_LIB_PREFIX + name].tobytes(),
                                   rec["sha256"])
    except (ValueError, KeyError) as e:
        return BundleIncompatible(
            f"bundle {path}: its kernel libraries cannot be installed "
            f"({e})", expected=meta["fingerprint"],
            found=runtime_fingerprint())
    return None


def _rebuild(raw, meta):
    """The bundle's pipeline, from its spec and leaves (nothing run)."""
    spec = meta["spec"]
    first = meta["per_bucket"][str(meta["buckets"][0])]
    leaves = [raw.get(f"leaf_{i}") for i in range(first["n_leaves"])]
    leaves[first["input_slot"]] = np.zeros(first["pshape"], np.float32)
    inner = _kinds()[spec["kind"]]._from_capture(spec, leaves)
    return BundlePipeline(inner, meta["buckets"])


def _serve(path, raw, meta, state, build, hard_keys, **shard):
    err = _incompatibility(path, meta, hard_keys) \
        or _install_libraries(path, raw, meta)
    if err is not None:
        return _fallback(build, state, meta, err)
    try:
        pipe = _rebuild(raw, meta)
    except (KeyError, ValueError, TypeError, ImportError,
            AttributeError) as e:
        return _fallback(build, state, meta, BundleIncompatible(
            f"bundle {path}: its pipeline spec does not rebuild here "
            f"({type(e).__name__}: {e})", expected=meta["fingerprint"],
            found=runtime_fingerprint()))
    # warm and capture every bucket now: the first request is a replay
    for b in pipe.buckets:
        prog = pipe.program(b)
        if prog.mode == "graph":
            prog.label = "bundle_exec"
    return LoadedBundle(pipe, state, meta["buckets"], meta["fingerprint"],
                        fallback=False, **shard)


def _state_of(raw) -> dict:
    return {k[len(_STATE_PREFIX):]: v for k, v in raw.items()
            if k.startswith(_STATE_PREFIX)}


def load_bundle(path: str, build=None, timeout: float | None = None) \
        -> LoadedBundle:
    """Load a deployment bundle into a ``PredictServer``-ready pipeline
    that builds no kernel.

    In order: the verified read (``SnapshotCorrupt`` on any damage), the
    fingerprint check (:func:`runtime_fingerprint`'s hard keys), the
    kernel libraries installed from their bytes on ``cuda``, the pipeline
    rebuilt from its spec and leaves, and every bucket warmed and
    captured — the first request is a replay.  A mismatch, a library that
    fails its SHA-256, or a bundle of the JAX reference raises
    :class:`~dislib_tpu_torch.runtime.BundleIncompatible`; with ``build``
    (``state_dict -> pipeline``) it falls back loudly to
    ``build(state)`` instead (a ``RuntimeWarning``, ``fallback=True``).

    A SHARDED bundle (``export_bundle(hosts=N)``; ``path`` names the
    manifest) first verifies every shard against the manifest's CRC and
    its own checksum; one bad shard raises
    :class:`~dislib_tpu_torch.runtime.BundleShardCorrupt` naming its host,
    and no pipeline is built.  The votes are tallied in this process:
    ``timeout`` bounds the reference's cross-process barrier, which is
    ROADMAP.md A.11 (a job of several ``torch.distributed`` processes
    raises ``NotImplementedError``); it is accepted and unused here.
    """
    raw = read_bundle(path)
    if _META_KEY not in raw:
        raise BundleIncompatible(
            f"{path} verifies but carries no bundle manifest — not a "
            "deployment bundle")
    meta = json.loads(str(raw[_META_KEY][()]))
    if meta.get("sharded"):
        return _load_sharded(path, meta, build)
    return _serve(path, raw, meta, _state_of(raw), build, _HARD_KEYS)


def _verify_shard(path, manifest, r):
    """One shard's verification: the manifest's CRC over the artifact
    bytes, then the checksum-verified read.  ``(vote, raw)``."""
    from dislib_tpu_torch.utils.checkpoint import SnapshotCorrupt
    sp = shard_path(path, r)
    try:
        crc = file_crc(sp)
    except OSError as e:
        return {"ok": False, "reason": f"shard unreadable: {e}"}, None
    want = int(manifest["shard_crcs"][r])
    if crc != want:
        return {"ok": False,
                "reason": f"shard CRC {crc:#010x} != manifest "
                          f"{want:#010x} — damaged or replaced"}, None
    try:
        raw = read_bundle(sp)
    except SnapshotCorrupt as e:
        return {"ok": False, "reason": f"shard fails its embedded "
                                       f"checksum: {e}"}, None
    return {"ok": True}, raw


def _load_sharded(path, manifest, build) -> LoadedBundle:
    _one_process("load_bundle of a sharded bundle")
    hosts = int(manifest["hosts"])
    votes, raws = {}, {}
    for r in range(hosts):
        votes[r], raws[r] = _verify_shard(path, manifest, r)
    bad = sorted(r for r, v in votes.items() if not v["ok"])
    if bad:
        _prof.count_resilience("bundle_barrier_abort")
        r0 = bad[0]
        reason = votes[r0]["reason"]
        raise BundleShardCorrupt(
            f"sharded bundle {path}: host {r0} failed shard verification "
            f"({reason}) — the load barrier aborts, zero hosts serve "
            f"(failed hosts: {bad})", host=r0, reason=reason)
    _prof.count_resilience("bundle_barrier_ok")
    return _serve(path, raws[0], manifest, _state_of(raws[0]), build,
                  _SHARD_HARD_KEYS, hosts=hosts, host=0)
