"""The host text parser (C++), built at first use and bound with ctypes.

Counterpart of ``dislib_tpu/native/__init__.py``.  ``fastio.cpp`` (the
port's own copy of the reference's source) is compiled by ``g++`` into
``dislib_tpu_torch/_build/`` under a name that carries the hash of the
source and the command, so an edited source rebuilds and an unchanged one
is reused; nothing is written into the package's source directories.

The loaders in :mod:`dislib_tpu_torch.data.io` use the parser where it is
available and fall back to NumPy otherwise: every entry point raises
:class:`NativeUnavailable` when the library is missing or the input is
malformed, and NumPy then parses, or raises the user-facing error.
``DSLIB_NO_NATIVE=1`` turns the parser off.  A failed build is kept, not
swallowed: :func:`build_error` returns the compiler's message, and it is
logged once under ``dslib.native``.  :data:`PARSES` counts each parser's
successful calls, so a run can show that the loaders went through it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fastio.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")
_lock = threading.Lock()
_lib = None
_tried = False
_error: str | None = None
#: successful parses per entry point
PARSES = {"parse_text": 0, "parse_svmlight": 0, "parse_mdcrd": 0}


class NativeUnavailable(RuntimeError):
    pass


def library_path() -> str:
    """Where the built parser lives: ``_build/fastio-<hash>.so``, the hash
    of the source and the compiler command."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(("g++",) + CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"fastio-{h.hexdigest()[:16]}.so")


def _build_and_load():
    so = library_path()
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run(["g++", *CXX_FLAGS, _SRC, "-o", tmp],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"g++ exit {proc.returncode}: "
                               f"{proc.stderr.strip()}")
        os.replace(tmp, so)          # atomic: concurrent builds race safely
    lib = ctypes.CDLL(so)

    i64 = ctypes.c_int64
    pi64 = ctypes.POINTER(i64)
    pf32 = ctypes.POINTER(ctypes.c_float)
    lib.fastio_parse_text.restype = pf32
    lib.fastio_parse_text.argtypes = [ctypes.c_char_p, i64, ctypes.c_char,
                                      ctypes.c_int, pi64, pi64]
    lib.fastio_parse_svmlight.restype = ctypes.c_int
    lib.fastio_parse_svmlight.argtypes = [
        ctypes.c_char_p, i64, ctypes.POINTER(pf32), ctypes.POINTER(pi64),
        ctypes.POINTER(pi64), ctypes.POINTER(pf32), pi64, pi64]
    lib.fastio_parse_mdcrd.restype = pf32
    lib.fastio_parse_mdcrd.argtypes = [ctypes.c_char_p, i64, pi64]
    lib.fastio_free.restype = None
    lib.fastio_free.argtypes = [ctypes.c_void_p]
    return lib


def get_lib():
    """The loaded parser library, or None when it is turned off
    (``DSLIB_NO_NATIVE``) or did not build (see :func:`build_error`)."""
    global _lib, _tried, _error
    if os.environ.get("DSLIB_NO_NATIVE"):
        return None
    with _lock:
        if not _tried:
            _tried = True
            try:
                _lib = _build_and_load()
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                _lib, _error = None, f"{type(e).__name__}: {e}"
                from dislib_tpu_torch.utils.dlog import get_logger
                get_logger("native").warning(
                    "the native text parser did not build; the loaders "
                    "parse with NumPy: %s", _error)
    return _lib


def build_error() -> str | None:
    """The build's error message, or None if it built (or was not tried
    yet)."""
    return _error


def _take(lib, ptr, count, dtype):
    """Copy `count` elements out of a native buffer, then free it."""
    arr = np.ctypeslib.as_array(ptr, shape=(count,)).astype(dtype, copy=True)
    lib.fastio_free(ptr)
    return arr


def parse_text(buf: bytes, delimiter: str = ",", nthreads: int | None = None):
    """Parse delimited text → float32 (rows, cols) ndarray, or raise
    NativeUnavailable (caller falls back to np.loadtxt)."""
    lib = get_lib()
    if lib is None:
        raise NativeUnavailable
    if nthreads is None:
        nthreads = min(os.cpu_count() or 1, 16)
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    ptr = lib.fastio_parse_text(buf, len(buf),
                                delimiter.encode()[:1] or b",",
                                nthreads, ctypes.byref(rows),
                                ctypes.byref(cols))
    if rows.value < 0:
        raise NativeUnavailable("ragged rows — deferring to np.loadtxt")
    PARSES["parse_text"] += 1
    if not ptr:
        return np.zeros((0, 0), np.float32)
    flat = _take(lib, ptr, rows.value * cols.value, np.float32)
    return flat.reshape(rows.value, cols.value)


def parse_svmlight(buf: bytes):
    """Parse svmlight text → (labels, indptr, indices, data, n_features) in
    CSR form, or raise NativeUnavailable."""
    lib = get_lib()
    if lib is None:
        raise NativeUnavailable
    pf32 = ctypes.POINTER(ctypes.c_float)
    pi64 = ctypes.POINTER(ctypes.c_int64)
    labels_p, data_p = pf32(), pf32()
    indptr_p, indices_p = pi64(), pi64()
    nrows = ctypes.c_int64()
    nfeat = ctypes.c_int64()
    rc = lib.fastio_parse_svmlight(buf, len(buf),
                                   ctypes.byref(labels_p),
                                   ctypes.byref(indptr_p),
                                   ctypes.byref(indices_p),
                                   ctypes.byref(data_p),
                                   ctypes.byref(nrows), ctypes.byref(nfeat))
    n = nrows.value
    if rc != 0 or n == 0:
        for p in (labels_p, indptr_p, indices_p, data_p):
            if p:
                lib.fastio_free(p)
        if rc != 0:
            raise NativeUnavailable("malformed svmlight — deferring to "
                                    "Python")
        PARSES["parse_svmlight"] += 1
        return (np.zeros(0, np.float32), np.zeros(1, np.int64),
                np.zeros(0, np.int64), np.zeros(0, np.float32), 0)
    labels = _take(lib, labels_p, n, np.float32)
    indptr = _take(lib, indptr_p, n + 1, np.int64)
    nnz = int(indptr[-1])
    indices = _take(lib, indices_p, nnz, np.int64)
    data = _take(lib, data_p, nnz, np.float32)
    PARSES["parse_svmlight"] += 1
    return labels, indptr, indices, data, int(nfeat.value)


def parse_mdcrd(buf: bytes):
    """Parse AMBER mdcrd body → flat float32 values, or raise
    NativeUnavailable."""
    lib = get_lib()
    if lib is None:
        raise NativeUnavailable
    nvals = ctypes.c_int64()
    ptr = lib.fastio_parse_mdcrd(buf, len(buf), ctypes.byref(nvals))
    if nvals.value < 0:
        raise NativeUnavailable("mdcrd allocation failure")
    PARSES["parse_mdcrd"] += 1
    if not ptr:
        return np.zeros(0, np.float32)
    return _take(lib, ptr, nvals.value, np.float32)
