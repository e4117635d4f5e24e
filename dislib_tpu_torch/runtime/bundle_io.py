"""Verified byte-level IO for deployment bundles.

Counterpart of ``dislib_tpu/runtime/bundle_io.py``, the whole file.  A
deployment bundle is ONE versioned artifact holding what a fresh serving
process needs to serve its first batch with no kernel build: the kernel
libraries the exporting process loaded, each served pipeline's spec and
operand leaves (the model's fitted arrays), the bucket ladder, and the
checksum-verified model state.  The *assembly* of that artifact lives in
``dislib_tpu_torch.serving.bundle``; THIS module owns the bytes — the
same split as checkpoints (``utils.checkpoint`` owns the format,
``runtime.adoption`` gates the read).

The serving package is lint-bound to never touch snapshot or model bytes
directly (no raw ``open()``/``np.load``/``np.savez`` —
``tests/test_torch_serving.py``), so bundle reads and writes flow through
here and inherit the checkpoint format's integrity discipline:

- writes are atomic (unique tmp file + fsync + rename, directory fsync)
  and embed a CRC-32 over every entry's name/dtype/shape/bytes;
- reads verify that checksum and raise a typed
  :class:`~dislib_tpu_torch.utils.checkpoint.SnapshotCorrupt` on
  truncation, bit rot, or a foreign file.

The container is the checkpoint format, which is byte-compatible with
the reference's: a bundle file either package writes verifies under the
other's :func:`read_bundle`.  Whether its contents can run here is the
layer above (:class:`BundleIncompatible`, raised by ``serving.bundle``).
"""

from __future__ import annotations

import os
import tempfile
import zlib

import numpy as np

from dislib_tpu_torch.utils.checkpoint import (_CRC_KEY, _fsync_dir,
                                               _load_verified, _state_crc)

__all__ = ["BundleIncompatible", "BundleShardCorrupt", "read_bundle",
           "write_bundle", "shard_path", "file_crc"]


class BundleIncompatible(RuntimeError):
    """A deployment bundle that cannot serve in this process as exported:
    the torch or CUDA version, the platform, the device name, capability
    or count, the mesh shape, the pad quantum or the kernels' digest
    differ from the exporting process's, its kernel libraries fail their
    SHA-256, or it is no bundle of this package.  Carries the
    ``expected`` (bundle) and ``found`` (this process) fingerprint dicts.
    The model STATE inside the bundle is still checksum-verified —
    ``load_bundle(..., build=)`` falls back to it, loudly."""

    def __init__(self, message, expected=None, found=None):
        super().__init__(message)
        self.expected = expected or {}
        self.found = found or {}


class BundleShardCorrupt(RuntimeError):
    """A SHARDED bundle failed its load barrier: some host's shard is
    damaged, missing, or fails the manifest's per-shard checksum — so NO
    host serves.  ``host`` is the shard that failed (-1 when unknown) and
    ``reason`` its diagnosis."""

    def __init__(self, message, host=-1, reason=""):
        super().__init__(message)
        self.host = int(host)
        self.reason = str(reason)


def shard_path(path: str, host: int) -> str:
    """The per-host shard artifact of a sharded bundle whose manifest is
    ``path``: ``<path>.shard<host>``."""
    return f"{path}.shard{int(host)}"


def file_crc(path: str) -> int:
    """CRC-32 over a file's raw bytes — the manifest's per-shard
    integrity record, and the trainer ledger's checksum."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                return crc & 0xFFFFFFFF
            crc = zlib.crc32(chunk, crc)


def write_bundle(path: str, arrays: dict) -> None:
    """Atomically persist a bundle entry dict (ndarrays only; library
    bytes travel as uint8 arrays, metadata as str arrays) with the
    checkpoint format's embedded CRC-32: unique tmp in the target
    directory, fsync before the rename, directory fsync after — a torn
    write can never leave a file that :func:`read_bundle` would trust."""
    arrs = {k: np.asarray(v) for k, v in arrays.items()}
    if _CRC_KEY in arrs:
        raise ValueError(f"{_CRC_KEY!r} is a reserved bundle key")
    arrs[_CRC_KEY] = np.asarray([_state_crc(arrs)], np.uint32)
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(suffix=".npz", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrs)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(d)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def read_bundle(path: str) -> dict:
    """Checksum-verified read of a bundle artifact.  Raises the typed
    :class:`~dislib_tpu_torch.utils.checkpoint.SnapshotCorrupt` when the
    file is truncated, bit-corrupt, or foreign (no integrity record)."""
    return _load_verified(path)
