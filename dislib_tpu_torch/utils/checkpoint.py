"""Mid-fit checkpointing: crash-consistent rotating snapshots.

Counterpart of ``dislib_tpu/utils/checkpoint.py``, the whole file.  A
failure of the card (or of the process that drives it) kills the whole
fit, so mid-fit checkpointing of the iteration state is first-class:
iterative estimators (``KMeans``, ``GaussianMixture``, ``ALS``,
``MiniBatchKMeans``, the forest, ``CascadeSVM``, ``DBSCAN``, ``Daura``)
accept ``checkpoint=FitCheckpoint(path, every=k)`` and then run their
device loop in k-iteration chunks (``runtime.ChunkedFitLoop``),
snapshotting the host-readable iteration state after each chunk.  A
re-run with the same checkpoint resumes from the snapshot and produces
the same result as an uninterrupted fit.

Format: ``.npz`` written atomically (tmp file + fsync + rename), no
pickle, byte-compatible with the reference's: every snapshot embeds a
CRC-32 over its arrays under ``_dslib_crc32``, so a file written by
either package loads and verifies in the other.  The last ``keep``
generations rotate (``path`` newest, ``path.1`` previous, ...), and
``load()`` detects a truncated, corrupt or foreign file and falls back to
the newest good generation.

Where the port departs: the rotation tolerates a generation that
vanished between its ``exists()`` and its ``os.replace()`` (a concurrent
save on the same path rotated it first), where the reference's raises
``FileNotFoundError`` (ROADMAP.md C.4).  :func:`digest_sums` is a torch
reduction on the data's device.
"""

from __future__ import annotations

import os
import threading
import warnings
import zipfile
import zlib

import numpy as np

# npz entry holding the CRC-32 of every other entry; reserved key
_CRC_KEY = "_dslib_crc32"


class SnapshotCorrupt(ValueError):
    """A snapshot file that cannot be trusted: truncated/corrupt ``.npz``,
    checksum mismatch (bit corruption), or a foreign ``.npz`` with no
    integrity record."""


def _state_crc(arrs: dict) -> int:
    """CRC-32 over every entry's name, dtype, shape, and raw bytes, in
    key order — what `save` embeds and `load` verifies."""
    crc = 0
    for k in sorted(arrs):
        if k == _CRC_KEY:
            continue
        a = np.ascontiguousarray(arrs[k])
        for piece in (k.encode(), a.dtype.str.encode(),
                      np.asarray(a.shape, np.int64).tobytes()):
            crc = zlib.crc32(piece, crc)
        try:
            # zlib takes the array's buffer directly — no tobytes() copy
            # of what may be a multi-GB factor matrix
            crc = zlib.crc32(a, crc)
        except (TypeError, ValueError, BufferError):
            crc = zlib.crc32(a.tobytes(), crc)  # exotic dtypes
    return crc & 0xFFFFFFFF


def _fsync_dir(path: str) -> None:
    """Best-effort directory fsync so a rename survives power loss."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _load_verified(path: str) -> dict:
    """Read one generation, verifying npz integrity AND the embedded
    checksum; raises :class:`SnapshotCorrupt` on any damage.  A
    ``FileNotFoundError`` propagates UNWRAPPED: the file vanishing
    between the caller's ``exists()`` and the open here means a
    concurrent ``save`` is mid-rotation (hot-swap readers poll live
    checkpoints) — that is "look at the next generation", not
    corruption, and it must never reach the corrupt-file cleanup, which
    would otherwise ``os.remove`` the name a racing writer has just
    re-pointed at a brand-new good generation."""
    try:
        with np.load(path, allow_pickle=False) as z:
            state = {k: z[k] for k in z.files}
    except FileNotFoundError:
        raise
    except (zipfile.BadZipFile, EOFError, OSError, ValueError, KeyError) as e:
        raise SnapshotCorrupt(
            f"snapshot {path} is truncated or corrupt ({e})") from e
    crc = state.pop(_CRC_KEY, None)
    if crc is None:
        raise SnapshotCorrupt(
            f"snapshot {path} has no integrity record — foreign .npz or "
            "written by a pre-rotation library version")
    if int(np.asarray(crc).ravel()[0]) != _state_crc(state):
        raise SnapshotCorrupt(
            f"snapshot {path} failed its checksum — bit corruption on disk")
    return state


class _PendingSave:
    """Handle for one in-flight `save_async`; `wait()` blocks until the
    snapshot is on disk and re-raises any write-side failure."""

    def __init__(self):
        self._done = threading.Event()
        self._exc: BaseException | None = None

    def wait(self) -> None:
        self._done.wait()
        if self._exc is not None:
            raise self._exc


# One in-flight async write per PATH, across FitCheckpoint instances: a
# preemption-recovery re-run builds a FRESH FitCheckpoint on the same
# file, and its load() must not read around the PREVIOUS fit's still-
# in-flight save — the resumed stream reads the checkpoint twice
# (stream_state, then the loop's restore) and a write landing between
# the two makes them disagree, re-consuming a batch (review-found flaky
# resume).  flush() drains the registered write before any read; the
# owning instance still re-raises its own write failure.
_PENDING_BY_PATH: dict = {}
_PENDING_LOCK = threading.Lock()


class FitCheckpoint:
    """Snapshot/restore of in-flight fit state.

    Parameters
    ----------
    path : str — target ``.npz`` file (newest generation; older ones
        rotate to ``path.1``, ``path.2``, ...).
    every : int, default 10 — checkpoint every `every` iterations.
    keep : int, default 2 — generations retained; ``load()`` falls back
        to the newest generation that verifies.

    ``save`` blocks until the snapshot is on disk; checkpointed fit loops
    use :meth:`save_async` instead, which runs the SAME save (device→host
    resolution of any ``AsyncFetch`` values, checksum, atomic write,
    rotation) on a worker thread so it overlaps the next chunk's device
    compute.  At most one write is in flight per checkpoint — the next
    ``save_async`` (and ``load``/``delete``/:meth:`flush`) waits for it
    first, so generation rotation order and the crash-consistency
    guarantees are exactly those of the blocking path.
    """

    def __init__(self, path: str, every: int = 10, keep: int = 2):
        self.path = str(path)
        self.every = int(every)
        self.keep = int(keep)
        self._pending: _PendingSave | None = None
        self._pending_thread: threading.Thread | None = None
        if self.every < 1:
            raise ValueError("every must be >= 1")
        if self.keep < 1:
            raise ValueError("keep must be >= 1")

    def _gen_path(self, i: int) -> str:
        return self.path if i == 0 else f"{self.path}.{i}"

    def save_async(self, state: dict) -> _PendingSave:
        """Start :meth:`save` on a worker thread and return immediately.

        Waits for any previous in-flight save first (writes never
        reorder), then hands ``state`` — ndarrays, scalars, or
        ``AsyncFetch`` handles whose device→host copies are already in
        flight — to the worker.  A failed write surfaces at the next
        ``flush()``/``save_async()``/``load()``, i.e. still inside
        ``fit``."""
        self.flush()
        pending = _PendingSave()

        def run():
            try:
                self.save(state)
            except BaseException as e:  # noqa: BLE001 — re-raised at flush
                pending._exc = e
            finally:
                pending._done.set()

        worker = threading.Thread(target=run, name="dslib-snapshot",
                                  daemon=True)
        self._pending = pending
        self._pending_thread = worker
        with _PENDING_LOCK:
            _PENDING_BY_PATH[os.path.abspath(self.path)] = (worker, pending)
        worker.start()
        return pending

    def flush(self) -> None:
        """Block until the in-flight `save_async` (if any) is on disk;
        re-raises its failure.  Estimators call this at fit exit and
        before raising `Preempted`, so the snapshot-first contract holds
        with the write off the hot path.  A no-op on the snapshot worker
        itself (its `save` re-enters here and must not wait on its own
        completion).  Also waits out a write started by ANOTHER
        FitCheckpoint on the same path (the re-run-on-a-fresh-instance
        case) — without adopting its failure, which the owning instance
        re-raises at its own next flush."""
        if self._pending_thread is threading.current_thread():
            return
        with _PENDING_LOCK:
            entry = _PENDING_BY_PATH.pop(os.path.abspath(self.path), None)
        if entry is not None:
            thread, foreign = entry
            if thread is not threading.current_thread() \
                    and thread is not self._pending_thread:
                foreign._done.wait()
        pending, self._pending = self._pending, None
        self._pending_thread = None
        if pending is not None:
            pending.wait()

    def save(self, state: dict) -> None:
        """Atomically persist a dict of ndarrays/scalars, embedding a
        checksum and rotating the previous generations.

        A unique tmp file (mkstemp) in the target directory keeps concurrent
        fits sharing a path from clobbering each other's staging file, and
        the fsync-before-replace ensures the rename never lands ahead of the
        data on power loss.  Rotation shifts oldest-first, so a crash
        between renames leaves every file a complete snapshot of SOME
        generation — `load()` takes the newest that verifies."""
        import tempfile
        # mixing the blocking and async APIs on one checkpoint must not
        # race the rotation chain: wait out any in-flight async write
        # first (no-op when this call IS the async worker's)
        self.flush()
        arrs = {k: np.asarray(v.result() if hasattr(v, "result") else v)
                for k, v in state.items()}
        if _CRC_KEY in arrs:
            raise ValueError(f"{_CRC_KEY!r} is a reserved snapshot key")
        arrs[_CRC_KEY] = np.asarray([_state_crc(arrs)], np.uint32)
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        fd, tmp = tempfile.mkstemp(suffix=".npz", dir=d)
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **arrs)
                f.flush()
                os.fsync(f.fileno())
            for i in range(self.keep - 1, 0, -1):
                src = self._gen_path(i - 1)
                try:
                    os.replace(src, self._gen_path(i))
                except FileNotFoundError:
                    # no such generation yet, or a concurrent save on
                    # this path rotated it away first: nothing to shift
                    pass
            os.replace(tmp, self.path)
            _fsync_dir(d)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise

    def load(self) -> dict | None:
        """Return the newest snapshot generation that verifies, or None if
        no generation exists at all.  A corrupt/truncated/foreign newest
        file falls back (with a warning) to the previous generation;
        :class:`SnapshotCorrupt` raises only when EVERY generation on disk
        is damaged."""
        self.flush()                    # never read around an in-flight write
        seen = 0
        first_err: SnapshotCorrupt | None = None
        bad: list[tuple[str, tuple]] = []
        for i in range(self.keep):
            p = self._gen_path(i)
            if not os.path.exists(p):
                continue
            try:
                read_stat = os.stat(p)
                state = _load_verified(p)
            except FileNotFoundError:
                # vanished between exists() and open(): a concurrent
                # save's rotation is in flight (hot-swap reader on a live
                # checkpoint).  Not corruption and not "seen" — the next
                # generation (or the next poll) holds a complete file.
                continue
            except SnapshotCorrupt as e:
                seen += 1
                if first_err is None:
                    first_err = e
                bad.append((p, (read_stat.st_ino, read_stat.st_mtime_ns)))
                continue
            seen += 1
            if first_err is not None:
                warnings.warn(
                    f"checkpoint {self.path}: newest snapshot unusable "
                    f"({first_err}); falling back to generation {i}",
                    RuntimeWarning, stacklevel=2)
                # drop the corrupt newer generation(s) NOW: otherwise the
                # next save() would rotate a known-corrupt file over this
                # good one, and a crash mid-save would then leave nothing
                # usable — exactly the >1-generation loss save() promises
                # never to cause.  Guard: only remove the exact inode we
                # read as corrupt — a racing writer may have re-pointed
                # the name at a brand-new good generation since.
                for b, (ino, mt) in bad:
                    try:
                        st = os.stat(b)
                        if (st.st_ino, st.st_mtime_ns) == (ino, mt):
                            os.remove(b)
                    except OSError:
                        pass
            return state
        if seen == 0:
            return None
        raise SnapshotCorrupt(
            f"checkpoint {self.path}: all {seen} snapshot generation(s) are "
            "corrupt, truncated, or foreign — delete the file(s) to restart "
            "the fit from scratch") from first_err

    def delete(self) -> None:
        self.flush()
        for i in range(self.keep):
            p = self._gen_path(i)
            if os.path.exists(p):
                os.remove(p)


def data_digest(xp, stats=None):
    """Order-sensitive float64 digest of a (padded) device matrix — plain
    and index-weighted sums, so a row permutation changes it.  Pad rows are
    zero under the pad-and-mask invariant, so padded sums equal logical
    sums.  Best-effort (a tiny relative perturbation at very large m can
    evade a sum digest); NaN digests never match → NaN data fails closed.
    ``stats`` (host per-row stats, e.g. tree label encodings) contributes
    the same two sums when given.  The digest array leads with a format
    version so a snapshot written under an older formula fails validation
    with an accurate message instead of blaming the user's data."""
    total, wsum = digest_sums(xp)
    extras = []
    if stats is not None:
        extras = [float(np.sum(stats)),
                  float(np.arange(stats.shape[0]) @ np.sum(stats, axis=1))]
    return versioned_digest(total, wsum, *extras)


def versioned_digest(*vals):
    """Assemble a digest array in the shared version-led layout
    ``[_DIGEST_VERSION, *vals]`` — the ONE place that owns the format, so
    estimators composing their own digest terms (e.g. CSVM's x+y sums)
    cannot drift from it."""
    return np.asarray([_DIGEST_VERSION, *vals], np.float64)


# v2: index weights split into high/low f32 parts (2026-08-01).  v1 (no
# version element) used a single f32 iota, which collides adjacent indices
# above ~2^24 rows.
_DIGEST_VERSION = 2.0

def digest_sums(xp):
    """``(plain sum, index-weighted sum)`` of a device matrix as host
    floats — the shared order-sensitive reduction for checkpoint digests
    (also used directly by estimators that build composite digests, e.g.
    CSVM).  The index weights are split as i = 4096*hi + lo, as in the
    reference: a single float32 iota collides adjacent indices above
    ~2^24 rows; each part stays exactly representable (lo < 4096,
    hi < m/4096).  Three float32 reductions on the device, read in one
    transfer, recombined in float64 on the host."""
    import torch
    from dislib_tpu_torch.runtime.elastic import fetch_packed
    x = torch.as_tensor(xp).to(torch.float32)
    x = x.reshape(x.shape[0], -1)
    r = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
    hi = (r // 4096).to(torch.float32)
    lo = (r % 4096).to(torch.float32)
    rows = x.sum(dim=1)
    total, shi, slo = (float(v) for v in fetch_packed(
        x.sum(), (rows * hi).sum(), (rows * lo).sum(), site="digest").result())
    return total, 4096.0 * shi + slo


def validate_snapshot(snap, fp, digest):
    """Refuse a snapshot whose fingerprint/digest doesn't match this fit —
    shared by every checkpointed estimator so the guard can't drift.
    Foreign .npz files (missing keys) fail the same way."""
    ok = ("fp" in snap and "digest" in snap
          and np.array_equal(snap["fp"], fp)
          and np.shape(snap["digest"]) == np.shape(digest)
          and np.allclose(snap["digest"], digest, rtol=1e-5, atol=1e-6))
    if not ok:
        # a LENGTH mismatch from a snapshot that does NOT lead with the
        # current version element means the formula itself changed between
        # library versions (v1's unversioned 2/4-element digests vs v2's
        # version-led ones).  A length mismatch WITH a current version
        # lead is a cross-estimator snapshot (e.g. a DBSCAN checkpoint
        # path reused for a forest fit) — that keeps the generic message,
        # as do value mismatches at equal length.
        # (fp length is NOT used here: fp widths legitimately differ
        # ACROSS estimators, so a length mismatch can't distinguish a
        # version change from cross-estimator path reuse — an estimator
        # that widens its own fp raises the version error at its call
        # site, where its fp history is known; see trees._grow_forest)
        old = ("digest" in snap and np.ndim(snap["digest"]) == 1
               and np.size(snap["digest"]) != np.size(digest)
               and not (np.size(snap["digest"]) >= 1
                        and snap["digest"][0] == _DIGEST_VERSION))
        if old:
            raise ValueError(
                "checkpoint was written by a different library version "
                "(data-digest format changed) — delete the snapshot file "
                "to restart the fit from scratch")
        raise ValueError(
            "checkpoint does not match this data/estimator (shape, data "
            "content or hyperparameters differ) — stale or foreign snapshot")
