"""Data ingest and export.

Counterpart of ``dislib_tpu/data/io.py``, single process:
:func:`load_txt_file`, :func:`load_npy_file`, :func:`load_svmlight_file`
(dense, ``store_sparse=False``), :func:`load_mdcrd_file` (AMBER mdcrd MD
trajectories) and :func:`save_txt`.  Parsing stays on the host, through
the port's native parser (:mod:`dislib_tpu_torch.native`, C++) where it is
available and the target dtype is float32, else NumPy; the clean rows then
go to the device once, through :func:`~dislib_tpu_torch.data.array.array`,
on ``device`` (default: the default mesh's, ``cuda``).

**Ingest quarantine.**  A single NaN row in a loaded file would poison
every distance and sum it takes part in.  The loaders detect non-finite
rows at parse time, isolate them into a :class:`QuarantineReport`
(attached to the returned array as ``.quarantine_`` and readable through
:func:`last_quarantine_report`; every report also joins the process-wide
:class:`QuarantineLedger`), and build the ds-array from the clean rows
only.  Opt out per call (``quarantine=False``) or globally
(``DSLIB_QUARANTINE=0``) to load the raw rows.

Not ported yet: the multi-process sharded ingest (each process parsing
only the row slab its shards cover; ROADMAP.md A.11), which raises
``NotImplementedError`` when ``torch.distributed`` runs more than one
process.
"""

from __future__ import annotations

import functools
import io as _io
import os
import warnings

import numpy as np

from dislib_tpu_torch.data.array import array as _ds_array


class QuarantineReport:
    """What the ingest quarantine isolated from one load: the 0-based
    ``rows`` (in the file's row order), the offending ``values`` rows
    themselves (for offline triage), the ``labels`` that rode along
    (svmlight), the ``source`` path, and ``n_loaded`` clean rows.

    **Paired files.** Dropping rows changes row numbering, so arrays
    loaded from SEPARATE files that pair row-by-row (features.csv +
    labels.csv) silently misalign if either file quarantined rows.
    ``load_svmlight_file`` keeps its own x/y aligned; for separately
    loaded pairs, apply this report's :attr:`keep_mask` to the partner
    (``y = y[report.keep_mask, :]``) — and the partner's report to this
    array — or load both with ``quarantine=False``."""

    def __init__(self, source, rows, values, n_loaded, labels=None):
        self.source = str(source)
        self.rows = np.asarray(rows, np.int64)
        self.values = values
        self.labels = labels
        self.n_loaded = int(n_loaded)

    @property
    def n_quarantined(self):
        return int(self.rows.size)

    @property
    def n_total(self):
        """Rows in the source file (loaded + quarantined)."""
        return self.n_loaded + self.n_quarantined

    @property
    def keep_mask(self):
        """Boolean mask over the ORIGINAL file's rows (True = kept) —
        apply it to a row-paired array from another file to restore
        row correspondence after this load's quarantine."""
        mask = np.ones(self.n_total, bool)
        mask[self.rows] = False
        return mask

    def __repr__(self):
        return (f"QuarantineReport(source={self.source!r}, "
                f"n_quarantined={self.n_quarantined}, "
                f"n_loaded={self.n_loaded}, rows={self.rows.tolist()})")


class QuarantineLedger:
    """Stream-wide accumulation of ingest quarantines: every load that
    quarantines rows appends its :class:`QuarantineReport` here, in
    arrival order, so a streaming job (repeated ``load → partial_fit``
    batches) can audit total losses and re-align the affected row-paired
    batches.  :meth:`reset` is the escape hatch between logically
    separate streams.

    The COUNT totals (``n_quarantined``/``n_loaded``) are exact for the
    whole stream, while ``reports`` (which pin each load's offending-row
    values) retain only the newest ``max_reports``
    (``DSLIB_QUARANTINE_LEDGER_CAP``, default 256)."""

    def __init__(self, max_reports=None):
        self.reports: list[QuarantineReport] = []
        self.max_reports = int(os.environ.get(
            "DSLIB_QUARANTINE_LEDGER_CAP", 256)) \
            if max_reports is None else int(max_reports)
        self._totals = [0, 0]

    def append(self, report: QuarantineReport) -> None:
        self.reports.append(report)
        self._totals[0] += report.n_quarantined
        self._totals[1] += report.n_loaded
        del self.reports[: max(0, len(self.reports) - self.max_reports)]

    @property
    def n_quarantined(self) -> int:
        """Total rows quarantined across every load since the last reset
        (exact even past the retained-report cap)."""
        return self._totals[0]

    @property
    def n_loaded(self) -> int:
        """Total clean rows loaded by the quarantining loads."""
        return self._totals[1]

    @property
    def keep_masks(self) -> list:
        """Per-report keep-masks of the RETAINED reports, in load order."""
        return [r.keep_mask for r in self.reports]

    def keep_mask_all(self):
        """The retained reports' masks concatenated in load order.  Loads
        that quarantined nothing never enter the ledger, so this spans
        only the affected batches: re-align a mixed stream batch by batch
        (match each report's ``source`` to its partner batch)."""
        masks = self.keep_masks
        return np.concatenate(masks) if masks else np.zeros(0, bool)

    def reset(self) -> None:
        self.reports.clear()
        self._totals = [0, 0]

    def __repr__(self):
        return (f"QuarantineLedger(loads={len(self.reports)}, "
                f"n_quarantined={self.n_quarantined}, "
                f"n_loaded={self.n_loaded})")


_LAST_QUARANTINE: QuarantineReport | None = None
_LEDGER = QuarantineLedger()


def last_quarantine_report() -> QuarantineReport | None:
    """The :class:`QuarantineReport` of the most recent load that
    quarantined rows in this process, or None."""
    return _LAST_QUARANTINE


def quarantine_ledger() -> QuarantineLedger:
    """The process-wide :class:`QuarantineLedger`, with ``reset()`` as the
    escape hatch."""
    return _LEDGER


def _quarantine_enabled(opt) -> bool:
    if opt is not None:
        return bool(opt)
    return os.environ.get("DSLIB_QUARANTINE", "1") != "0"


def _emit_quarantine(source, rows, bad_values, n_clean, bad_labels=None):
    """The shared report/warn/refuse tail of both quarantine paths (dense
    rows and CSR)."""
    global _LAST_QUARANTINE
    report = QuarantineReport(source, rows, bad_values, n_clean,
                              labels=bad_labels)
    _LAST_QUARANTINE = report
    _LEDGER.append(report)
    warnings.warn(
        f"{source}: quarantined {report.n_quarantined} bad row(s) "
        "(non-finite values/labels, or out-of-range feature indices) "
        f"(indices {rows[:8].tolist()}{'...' if len(rows) > 8 else ''}) — "
        "see last_quarantine_report() / the returned array's .quarantine_; "
        "pass quarantine=False (or DSLIB_QUARANTINE=0) to load them raw. "
        "If this file pairs row-by-row with another (features/labels), "
        "re-align the partner with report.keep_mask or row numbering "
        "silently shifts",
        RuntimeWarning, stacklevel=4)
    if n_clean == 0:
        raise ValueError(
            f"{source}: every row is non-finite — nothing left to load "
            "after quarantine (pass quarantine=False to load raw)")
    return report


def _quarantine_rows(data, source, opt, labels=None):
    """Split non-finite rows out of a parsed host matrix (and the labels
    vector riding along, svmlight).  Returns ``(clean, clean_labels,
    report_or_None)``."""
    if not _quarantine_enabled(opt) or data.size == 0:
        return data, labels, None
    bad = ~np.isfinite(data).all(axis=1)
    if labels is not None:
        bad |= ~np.isfinite(np.asarray(labels, np.float64)).ravel()
    if not bad.any():
        return data, labels, None
    rows = np.nonzero(bad)[0]
    clean = data[~bad]
    clean_labels = labels[~bad] if labels is not None else None
    report = _emit_quarantine(
        source, rows, data[bad], clean.shape[0],
        bad_labels=None if labels is None else labels[bad])
    return clean, clean_labels, report


def quarantine_batch(batch, source="stream", quarantine=None):
    """Screen one host batch of a streaming fit through the ingest
    quarantine: non-finite rows are split out and reported to the
    process-wide :class:`QuarantineLedger`.  Returns ``(clean_rows,
    report_or_None)``; raises ``ValueError`` when EVERY row is dirty.  1-D
    input is treated as a single row."""
    data = np.asarray(batch, np.float32)
    if data.ndim == 1:
        data = data.reshape(1, -1)
    clean, _, report = _quarantine_rows(data, source, quarantine)
    return clean, report


def _single_process(what):
    """Raise for a job of several ``torch.distributed`` processes: the
    reference's sharded ingest (each process parsing only its row slab)
    is not ported yet."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            f"{what} in a job of {dist.get_world_size()} processes: the "
            "sharded multi-process ingest is ROADMAP.md A.11; load in one "
            "process")


def _retrying_loader(fn):
    """Retry a whole loader under the env-tunable transient-failure policy
    (:class:`~dislib_tpu_torch.runtime.retry.Retry`): a flaky shared
    filesystem (EIO, connection reset, stale NFS handle) re-reads; parse
    errors and missing files classify fatal and raise immediately.
    Loaders are pure (parse, then one copy to the device), so a re-run is
    safe.  The port ingests in one process, so every call is retried."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        from dislib_tpu_torch.runtime.retry import Retry
        return Retry.from_env(attempts=3, backoff=0.25).call(
            fn, *args, **kwargs)
    return wrapped


def _native_parse(parser_name, path):
    """Run a native parser over a whole file, or return None when the
    parser is unavailable or defers (malformed input — the Python fallback
    then raises the user-facing error)."""
    from dislib_tpu_torch import native as _native
    if _native.get_lib() is None:
        return None
    try:
        with open(path, "rb") as f:
            return getattr(_native, parser_name)(f.read())
    except _native.NativeUnavailable:
        return None


def _parse_txt_buf(buf, delimiter, dtype):
    """Parse a delimited-text byte buffer: the native multi-threaded parser
    when it is available and the target dtype is float32, NumPy
    otherwise."""
    if not buf.strip():
        return np.zeros((0, 0), dtype=dtype)
    if np.dtype(dtype) == np.float32:
        from dislib_tpu_torch import native as _native
        if _native.get_lib() is not None:
            try:
                return _native.parse_text(buf, delimiter=delimiter)
            except _native.NativeUnavailable:
                pass     # ragged/malformed: np.loadtxt raises the real error
    return np.loadtxt(_io.BytesIO(buf), delimiter=delimiter, dtype=dtype,
                      ndmin=2)


@_retrying_loader
def load_txt_file(path, block_size=None, delimiter=",", dtype=np.float32,
                  quarantine=None, device=None):
    """Load a delimited text file into a ds-array (reference:
    ``load_txt_file``) on ``device`` (default: the default mesh's).

    ``quarantine`` — non-finite rows are isolated into the returned
    array's ``.quarantine_`` report (module docstring); ``False`` loads
    them raw, ``None`` reads ``DSLIB_QUARANTINE``."""
    _single_process("load_txt_file")
    with open(path, "rb") as f:
        data = _parse_txt_buf(f.read(), delimiter, dtype)
    if data.size == 0:
        data = np.loadtxt(path, delimiter=delimiter, dtype=dtype, ndmin=2)
    data, _, report = _quarantine_rows(data, path, quarantine)
    out = _ds_array(data, block_size=block_size, dtype=dtype, device=device)
    out.quarantine_ = report
    return out


@_retrying_loader
def load_npy_file(path, block_size=None, dtype=None, quarantine=None,
                  device=None):
    """Load a 2-D .npy file into a ds-array (reference: ``load_npy_file``)
    on ``device``.  ``dtype=None`` keeps the file's dtype, narrowing
    float64 to float32 with a warning, as :func:`array` does.
    ``quarantine``: see :func:`load_txt_file`."""
    _single_process("load_npy_file")
    mm = np.load(path, allow_pickle=False, mmap_mode="r")
    if mm.ndim != 2:
        raise ValueError("load_npy_file expects a 2-D array")
    # a copy in memory: a CPU ds-array must not alias the read-only map
    data, _, report = _quarantine_rows(np.array(mm), path, quarantine)
    out = _ds_array(data, block_size=block_size, dtype=dtype, device=device)
    out.quarantine_ = report
    return out


def _parse_svmlight_text(lines):
    """Pure-Python svmlight parse of an iterable of text lines →
    (rows: list of {feat: val}, labels, max_feat).  Duplicate feature
    indices sum (CSR semantics, = sklearn's loader)."""
    rows, labels = [], []
    max_feat = 0
    for line in lines:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        labels.append(float(parts[0]))
        feats = {}
        for tok in parts[1:]:
            if tok.startswith("#"):
                break
            k, v = tok.split(":")
            feats[int(k)] = feats.get(int(k), 0.0) + float(v)
        if feats:
            max_feat = max(max_feat, max(feats))
        rows.append(feats)
    return rows, labels, max_feat


def _require_in_range(csr, source):
    """A raw (quarantine-off) load may still not ship out-of-range
    indices to the device — they would alias wrong columns or crash the
    dense scatter.  Raise the typed ingest error instead."""
    if csr.nnz and (int(csr.indices.min(initial=0)) < 0
                    or int(csr.indices.max(initial=0)) >= csr.shape[1]):
        raise ValueError(
            f"{source}: feature indices outside n_features={csr.shape[1]} "
            "— raise n_features, or enable quarantine to isolate the "
            "offending rows")


def _quarantine_csr(csr, labels, source, opt):
    """CSR-path quarantine: a row is bad when any stored value — or its
    label — is non-finite, OR any stored column index falls outside the
    declared shape (a truncating ``n_features=``).  Returns
    (clean_csr, clean_labels, report)."""
    if not _quarantine_enabled(opt) or csr.shape[0] == 0:
        return csr, labels, None
    bad_rows = np.zeros(csr.shape[0], bool)
    bad_ent = np.nonzero(~np.isfinite(csr.data)
                         | (csr.indices < 0)
                         | (csr.indices >= csr.shape[1]))[0]
    if bad_ent.size:
        # entry i lives in the row whose indptr window contains i
        bad_rows[np.searchsorted(csr.indptr, bad_ent, side="right") - 1] = \
            True
    bad_rows |= ~np.isfinite(np.asarray(labels, np.float64))
    if not bad_rows.any():
        return csr, labels, None
    rows = np.nonzero(bad_rows)[0]
    # row selection by raw indptr surgery, NOT csr[mask]: scipy's indexed
    # slicing validates through code paths that may choke on the very
    # out-of-range indices being quarantined
    clean = _csr_take_rows(csr, ~bad_rows)
    bad = _csr_take_rows(csr, bad_rows, clip=True)
    report = _emit_quarantine(source, rows, bad, clean.shape[0],
                              bad_labels=labels[bad_rows])
    return clean, labels[~bad_rows], report


def _csr_take_rows(csr, mask, clip=False):
    """Row subset of a CSR by direct indptr/indices surgery (no scipy
    fancy indexing — see `_quarantine_csr`).  ``clip`` clamps column
    indices into range so the OFFENDING-rows matrix is still a valid
    scipy object for offline triage."""
    import scipy.sparse as sp
    keep = np.nonzero(mask)[0]
    lens = np.diff(csr.indptr)[keep]
    indptr = np.concatenate([[0], np.cumsum(lens)])
    sel = np.concatenate([np.arange(csr.indptr[r], csr.indptr[r + 1])
                          for r in keep]) if keep.size else \
        np.zeros(0, np.int64)
    indices = csr.indices[sel]
    if clip:
        indices = np.clip(indices, 0, csr.shape[1] - 1)
    return sp.csr_matrix((csr.data[sel], indices, indptr),
                         shape=(keep.size, csr.shape[1]))


def _svmlight_csr(path, n_features):
    """(csr, labels) of a svmlight file at the declared width: the native
    single-pass CSR parser, or the pure-Python one.  The CSR is built at
    the DECLARED width first, so a truncating ``n_features=`` leaves
    out-of-range entries visible for the quarantine to isolate per row."""
    import scipy.sparse as sp
    parsed = _native_parse("parse_svmlight", path)
    if parsed is not None:
        labels, indptr, indices, data, nfeat = parsed
        m = n_features if n_features is not None else nfeat
        return sp.csr_matrix((data, indices, indptr),
                             shape=(labels.shape[0], m)), labels
    with open(path) as f:
        rows, labels, max_feat = _parse_svmlight_text(f)
    m = n_features if n_features is not None else max_feat
    indptr = np.zeros(len(rows) + 1, np.int64)
    idx_l, dat_l = [], []
    for i, feats in enumerate(rows):
        idx_l.extend(k - 1 for k in feats)      # svmlight is 1-indexed
        dat_l.extend(feats.values())
        indptr[i + 1] = len(idx_l)
    csr = sp.csr_matrix((np.asarray(dat_l, np.float32),
                         np.asarray(idx_l, np.int64), indptr),
                        shape=(len(rows), m))
    return csr, np.asarray(labels, np.float32)


@_retrying_loader
def load_svmlight_file(path, block_size=None, n_features=None,
                       store_sparse=True, quarantine=None, device=None):
    """Load a svmlight/libsvm file → (x, y) ds-arrays on ``device``
    (reference: ``load_svmlight_file``).

    Parsed by the native single-pass CSR parser where available, else in
    pure Python; duplicate feature indices sum (CSR semantics, as
    sklearn's loader) on both paths.  ``store_sparse=True``, the
    reference's default, gives ``x`` as a ``data/sparse.SparseArray``
    built from the (quarantined) CSR; ``store_sparse=False`` a dense
    ds-array.  A job of several processes raises (ROADMAP.md A.11)."""
    _single_process("load_svmlight_file")
    csr, labels = _svmlight_csr(path, n_features)
    csr, labels, report = _quarantine_csr(csr, labels, path, quarantine)
    _require_in_range(csr, path)
    if store_sparse:
        from dislib_tpu_torch.data.sparse import SparseArray
        x = SparseArray.from_scipy(csr, block_size=block_size,
                                   device=device)
    else:
        x = _ds_array(csr.toarray().astype(np.float32),
                      block_size=block_size, device=device)
    x.quarantine_ = report
    y = _ds_array(labels.reshape(-1, 1),
                  block_size=(block_size[0], 1) if block_size else None,
                  device=device)
    return x, y


@_retrying_loader
def load_mdcrd_file(path, block_size=None, n_atoms=None, copy_first=False,
                    quarantine=None, device=None):
    """Load an AMBER .mdcrd trajectory on ``device``: one row per frame,
    3·n_atoms coordinates (reference: ``load_mdcrd_file``, for the Daura/MD
    pipeline).  ``quarantine``: non-finite FRAMES are isolated (see
    :func:`load_txt_file`); the ``copy_first`` duplicate is taken from the
    cleaned trajectory."""
    if n_atoms is None:
        raise ValueError("n_atoms is required for mdcrd parsing")
    _single_process("load_mdcrd_file")
    values = _native_parse("parse_mdcrd", path)
    if values is None:
        vals = []
        with open(path) as f:
            next(f)  # title line
            for line in f:
                vals.extend(float(line[i:i + 8])
                            for i in range(0, len(line.rstrip("\n")), 8)
                            if line[i:i + 8].strip())
        values = np.asarray(vals, dtype=np.float32)
    per_frame = 3 * n_atoms
    n_frames = len(values) // per_frame
    data = np.asarray(values[: n_frames * per_frame], dtype=np.float32)
    data = data.reshape(n_frames, per_frame)
    data, _, report = _quarantine_rows(data, path, quarantine)
    if copy_first and data.shape[0] > 0:
        data = np.vstack([data, data[:1]])
    out = _ds_array(data, block_size=block_size, device=device)
    out.quarantine_ = report
    return out


def save_txt(x, path, merge_rows=True, delimiter=","):
    """Save a ds-array to text (reference: ``save_txt``).
    ``merge_rows=True`` writes one file; ``False`` writes one file per
    row-block stripe, the reference's per-block layout."""
    data = x.collect()
    if merge_rows:
        np.savetxt(path, data, delimiter=delimiter)
    else:
        os.makedirs(path, exist_ok=True)
        step = x._reg_shape[0]
        for bi, start in enumerate(range(0, data.shape[0], step)):
            np.savetxt(os.path.join(path, f"{bi}"), data[start:start + step],
                       delimiter=delimiter)
