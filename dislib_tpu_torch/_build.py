"""Build and load the port's hand-written CUDA kernels.

No counterpart in the reference (Pallas kernels need no build step).  At
first use every ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, one ``nvcc``
process per source, all started together, and loaded with ``ctypes``.
Libraries land in ``dislib_tpu_torch/_build/`` under a name that carries
the digest of the source and the flags (:func:`source_key`), so an edited
source rebuilds and an unchanged one is reused — by a process with no
toolkit too: :func:`library` loads a library that is already there
without looking for ``nvcc``.

A deployment bundle (``serving/bundle.py``) carries the libraries a
process loaded (:func:`loaded_libraries`) and the loading process
installs them from those bytes (:func:`install_library`), checked
against their SHA-256 and written under their key, so it never builds.

A missing ``nvcc`` or a failed build raises with the compiler's output.
There is no fallback: a CUDA tensor either reaches its kernel or the call
raises.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

from dislib_tpu_torch.utils.profiling import count_trace

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C entry points of each source: name -> (argtypes, restype).  Pointers
# and the stream are c_void_p (a bare Python int would be cut to 32 bits).
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "panel_gemm": {
        "dslib_panel_gemm_f32": ([_P] * 7 + [_I] * 4 + [_P], _I),
        "dslib_panel_gemm_bf16": ([_P] * 4 + [_I] * 4 + [_P], _I),
        "dslib_panel_gemm_config": ([_I, ctypes.POINTER(_I)], _I),
    },
    "distances_sq": {
        "dslib_distances_sq_f32": ([_P] * 3 + [_I] * 6 + [_P], _I),
        "dslib_distances_sq_bf16": ([_P] * 4 + [_I] * 7 + [_P], _I),
        "dslib_distances_sq_f32_batched": ([_P] * 3 + [_I] * 7 + [_P], _I),
    },
    "node_histogram": {
        "dslib_node_histogram_f32": ([_P] * 7 + [_I] * 17 + [_P], _I),
        "dslib_node_histogram_occupancy": ([_I] * 3 + [ctypes.POINTER(_I)],
                                           _I),
    },
}

_LIBS: dict = {}
#: name -> the file each loaded library was loaded from
_LOADED_FROM: dict = {}
_LOCK = threading.Lock()
#: name -> {"seconds", "log", "path", "cached"} of the last build
BUILD_INFO: dict = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: PyTorch's CUDA_HOME first, then PATH."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (CUDA_HOME is unset and nvcc is not on PATH): the "
        "port's CUDA kernels are compiled from dislib_tpu_torch/csrc at "
        "first use and need the CUDA toolkit")


def _sources() -> dict:
    return {os.path.splitext(os.path.basename(p))[0]: p
            for p in sorted(glob.glob(os.path.join(CSRC, "*.cu")))}


def source_key(name: str) -> str:
    """SHA-256 (hex) of source ``name`` and :data:`NVCC_FLAGS`: the
    identity of what its library was compiled from."""
    h = hashlib.sha256()
    with open(_sources()[name], "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def kernels_digest() -> str:
    """SHA-256 (hex) over every source's :func:`source_key`, in name
    order: the kernels a process of this checkout runs."""
    h = hashlib.sha256()
    for name in _sources():
        h.update(f"{name}:{source_key(name)};".encode())
    return h.hexdigest()


def _target(name: str, key: str | None = None) -> str:
    key = source_key(name) if key is None else key
    return os.path.join(BUILD_DIR, f"{name}-{key[:16]}.so")


def build_all() -> dict:
    """Compile every stale source in parallel; return name -> library path.

    Raises ``RuntimeError`` with the compiler's output if any build fails.
    """
    paths = {name: _target(name) for name in _sources()}
    stale = [name for name, out in paths.items() if not os.path.exists(out)]
    for name in set(paths) - set(stale):
        # keep the record of a build this process made
        BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": "",
                                     "path": paths[name], "cached": True})
    if not stale:
        return paths
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in stale:
        src, out = _sources()[name], paths[name]
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "log": log,
                            "path": out, "cached": False}
        if proc.returncode != 0:
            failures.append(f"--- {name} (nvcc exit {proc.returncode}) ---"
                            f"\n{log}")
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        os.replace(tmp, out)   # atomic: a concurrent loader sees old or new
        count_trace(f"nvcc:{name}")
    if failures:
        raise RuntimeError("building the CUDA kernels failed:\n"
                           + "\n".join(failures))
    return paths


def _bind(name: str, path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    _LIBS[name] = lib
    _LOADED_FROM[name] = path
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, with ``argtypes``/``restype``
    set on its entry points: the library already built or installed
    under its key, else every stale source built first."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if name not in SIGNATURES:
                raise KeyError(f"no CUDA kernel library named {name!r}")
            path = _target(name)
            if not os.path.exists(path):
                path = build_all()[name]
            lib = _bind(name, path)
        return lib


def loaded_libraries() -> dict:
    """name -> ``{"key", "sha256", "bytes"}`` of every kernel library
    this process has loaded: what a deployment bundle carries."""
    with _LOCK:
        paths = dict(_LOADED_FROM)
    out = {}
    for name, path in sorted(paths.items()):
        with open(path, "rb") as f:
            data = f.read()
        out[name] = {"key": source_key(name),
                     "sha256": hashlib.sha256(data).hexdigest(),
                     "bytes": data}
    return out


def install_library(name: str, key: str, data: bytes, sha256: str) -> str:
    """Install library ``name`` from ``data`` under ``key`` without
    ``nvcc``; return its path.  ``key`` must be this checkout's
    :func:`source_key` and ``data`` must hash to ``sha256``, else
    ``ValueError``.  The file is written atomically (tmp + rename), a file
    already there under the key is reused, and a library this process has
    already loaded is never replaced."""
    if name not in SIGNATURES:
        raise ValueError(f"no CUDA kernel library named {name!r}")
    if key != source_key(name):
        raise ValueError(
            f"library {name!r} was compiled from another source or other "
            f"flags (key {key[:16]}, this checkout's "
            f"{source_key(name)[:16]})")
    if hashlib.sha256(data).hexdigest() != sha256:
        raise ValueError(f"library {name!r}: its bytes do not hash to the "
                         f"recorded SHA-256 {sha256[:16]}")
    with _LOCK:
        if name in _LIBS:
            return _LOADED_FROM[name]
        out = _target(name, key)
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, out)
        return out
