"""Build and load the port's hand-written CUDA kernels.

No counterpart in the reference (Pallas kernels need no build step).  At
first use every ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, one ``nvcc``
process per source, all started together, and loaded with ``ctypes``.
Libraries land in ``dislib_tpu_torch/_build/`` under a name that carries
the hash of the source and the flags, so an edited source rebuilds and an
unchanged one is reused.

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
    },
    "node_histogram": {
        "dslib_node_histogram_f32": ([_P] * 6 + [_I] * 16 + [_P], _I),
        "dslib_node_histogram_occupancy": ([_I] * 3 + [ctypes.POINTER(_I)],
                                           _I),
    },
}

_LIBS: dict = {}
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


def _target(name: str, src: str, nvcc: str) -> str:
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join((nvcc,) + NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build_all() -> dict:
    """Compile every stale source in parallel; return name -> library path.

    Raises ``RuntimeError`` with the compiler's output if any build fails.
    """
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths, procs = {}, {}
    t0 = time.perf_counter()
    for name, src in _sources().items():
        out = _target(name, src, nvcc)
        paths[name] = out
        if os.path.exists(out):
            # keep the record of a build this process made
            BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": "",
                                         "path": out, "cached": True})
            continue
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
    if failures:
        raise RuntimeError("building the CUDA kernels failed:\n"
                           + "\n".join(failures))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (building every source first if
    any is missing), with ``argtypes``/``restype`` set on its entry
    points."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if name not in SIGNATURES:
                raise KeyError(f"no CUDA kernel library named {name!r}")
            lib = ctypes.CDLL(build_all()[name])
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LIBS[name] = lib
        return lib
