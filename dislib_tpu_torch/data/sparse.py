"""The sparse ds-array.

Counterpart of ``dislib_tpu/data/sparse.py``.  The reference stores a
BCOO and, for its fast paths, the row-panel-sharded rectangular buffers of
:class:`ShardedSparse`.  The port keeps the entries as three torch tensors
on the array's device — rows and columns int32, values float32 — sorted by
row (stable, so a row keeps its entries' order), with each row's entry
count.  That order is what makes every sum fixed-order: a per-row sum is a
``torch.segment_reduce`` over the row's contiguous segment, and a
per-column sum goes through a column-sorted copy made once
(:meth:`SparseArray._by_col`).  ``index_add_`` is not used for float sums:
on CUDA it adds with atomics in a varying order.

On a mesh of R x C ranks (a ``torch.distributed`` job) each rank holds
the row-sorted entries of its mesh row's rows, with row ids LOCAL to the
rank: the canonical row split ``m_local = padded_rows(m) / R`` of a dense
ds-array, and ranks of one mesh row hold the same entries (the
reference's ``P('rows')``).  The global per-row entry counts and the
global column stream stay host metadata (known at ingest, else gathered
once), so no device read decides a shape.  Across ranks: every rank takes
its rows of the same global input (:meth:`SparseArray.from_scipy`);
``collect`` is one all-gather of the entries; ``to_dense`` densifies each
rank's block; ``sum``/``mean`` reduce locally, then ``psum`` over
'rows'; the elementwise ops stay local; a row index moves the entries by
one ``all_to_all`` over 'rows' (:meth:`SparseArray._gather_rows`).  The
code of one card runs on a rank's rows through :meth:`SparseArray._local_view`
(a one-rank array of those rows) and on the whole matrix through
:meth:`SparseArray._gathered_view` (the entries all-gathered once and kept).

:class:`ShardedSparse` is the reference's rectangular layout (``build``,
``rowsq``, ``host_triplets``, ``panel_view``): per row shard the entries
row-sorted and tail-padded to a common :func:`nse_quantum` multiple with
(value 0, row 0, column 0); across ranks each rank keeps its own shard.
``panel_view`` re-sorts a shard's entries into per-panel slot ranges on
the device, the layout of the multi-panel SpMM (``ops/spmm.py``).

The estimator staging layouts are built on the device from the
row-sorted triplets: ``row_steps`` (the sparse kNN's skew-bounded row
steps) and ``ell`` (CascadeSVM's padded row-gather layout), on the
:class:`SparseArray` and on its :class:`ShardedSparse` buffers alike, over
a rank's own rows.  Each is one scatter of distinct destinations (no
sums), so two builds are bit-identical.  Not ported: the on-device
reshard (``resharded``, ``ops/rechunk.reshard_sparse``), and across ranks
the transpose and column indexing, ROADMAP.md A.11.  Each raises
``NotImplementedError``.
"""

from __future__ import annotations

import math
import os
from collections import namedtuple

import numpy as np
import torch

from dislib_tpu_torch.data.array import (
    Array, _mesh_for, _normalize_index, _padded_shape, _split_key,
    _whole_array_guard,
)
from dislib_tpu_torch.ops.spmm import seg_sum
from dislib_tpu_torch.parallel import distributed as _dist
from dislib_tpu_torch.parallel import mesh as _mesh
from dislib_tpu_torch.utils.profiling import count_read

__all__ = ["SparseArray", "ShardedSparse", "SparsePanelView", "nse_quantum",
           "densify_budget_bytes", "ell_budget_bytes", "dense_input",
           "check_input"]


def nse_quantum() -> int:
    """The stored-entry pad quantum of :class:`ShardedSparse`
    (``DSLIB_SPARSE_NSE_QUANTUM``, default 64)."""
    return max(1, int(os.environ.get("DSLIB_SPARSE_NSE_QUANTUM", "64")))


def densify_budget_bytes() -> int:
    """The byte budget above which densifying a SparseArray raises
    (``DSLIB_SPARSE_DENSIFY_BUDGET``, default 4 GiB): read by the lazy
    dense backing and by ``math.matmul``'s spmm/densify router."""
    return int(os.environ.get("DSLIB_SPARSE_DENSIFY_BUDGET", 4 << 30))


def ell_budget_bytes() -> int:
    """The byte budget of the padded ELL buffers (values and columns)
    above which :meth:`SparseArray.ell` returns None
    (``DSLIB_SPARSE_ELL_BUDGET``, default 2 GiB)."""
    return int(os.environ.get("DSLIB_SPARSE_ELL_BUDGET", 2 << 30))


def check_input(x, who: str) -> bool:
    """Whether ``x`` is a :class:`SparseArray`; a dense ds-array gives
    False, anything else raises ``TypeError`` naming ``who``."""
    if isinstance(x, SparseArray):
        return True
    if isinstance(x, Array):
        return False
    raise TypeError(f"{who} takes a ds-array or a SparseArray, got "
                    f"{type(x).__name__}")


def dense_input(x, who: str) -> Array:
    """``x`` as the dense ds-array an estimator with no sparse-native path
    works on: a :class:`SparseArray` through its budget-guarded dense
    backing (:meth:`SparseArray.as_dense`, ``MemoryError`` past
    :func:`densify_budget_bytes`; across ranks each rank densifies its
    block), a dense ds-array as it is."""
    return x.as_dense() if check_input(x, who) else x


def _round_nse(nse_min, explicit=None):
    q = nse_quantum()
    need = max(int(nse_min), 1)
    if explicit is not None:
        if int(explicit) < need:
            raise ValueError(
                f"requested nse {explicit} < the densest shard's "
                f"{need} live entries")
        need = int(explicit)
    return int(math.ceil(need / q) * q)


def _row_geom(m, mesh):
    """(row0, m_local) of this rank's rows of an m-row array: the
    canonical split of the padded rows over the mesh rows; (0, m) on one
    rank."""
    if mesh.world == 1:
        return 0, int(m)
    m_local = _padded_shape((m, 1), _mesh.pad_quantum(mesh))[0] // mesh.rows
    return mesh.coord[0] * m_local, m_local


def _shard_counts(row_nnz, m_local, p):
    """Host (p,) live entries of each row shard from the global per-row
    counts."""
    shard = np.arange(row_nnz.shape[0]) // m_local
    return np.bincount(shard, weights=row_nnz, minlength=p).astype(np.int64)


def _pack(rows, cols, vals):
    """(nnz, 2 + w) int32: rows, columns and the values' bits, so one
    collective moves an entry stream."""
    v = vals.contiguous().view(torch.int32).reshape(
        vals.shape[0], vals.element_size() // 4)
    return torch.cat([rows.to(torch.int32)[:, None],
                      cols.to(torch.int32)[:, None], v], dim=1)


def _unpack(p, dtype):
    return (p[:, 0].contiguous(), p[:, 1].contiguous(),
            p[:, 2:].contiguous().view(dtype).reshape(-1))


def _gather_entries(rows, cols, vals, counts, mesh):
    """Every mesh row's entries on every rank, in rank order: ``rows``
    (this rank's, already global), ``counts`` the host live count of each
    mesh row.  One ``all_gather`` over 'rows' of the packed streams,
    padded to the largest count."""
    cap = max(1, int(max(counts)))
    buf = torch.zeros((cap, 2 + vals.element_size() // 4), dtype=torch.int32,
                      device=vals.device)
    buf[: rows.shape[0]] = _pack(rows, cols, vals)
    got = _dist.all_gather(buf[None], _mesh.ROWS, 0, mesh)
    live = torch.cat([got[s, : int(c)] for s, c in enumerate(counts)])
    return _unpack(live, vals.dtype)


def _unported(what, item):
    raise NotImplementedError(
        f"{what}: this layout is not ported yet (ROADMAP.md {item})")


def _across_ranks(what):
    return NotImplementedError(
        f"{what} of a SparseArray sharded over several ranks is not ported "
        "yet (ROADMAP.md A.11)")


# ---------------------------------------------------------------------------
# the estimator staging layouts, built on the device from row-sorted entries
# ---------------------------------------------------------------------------

def row_step_plan(row_nnz, chunk):
    """Host ``(steps, budget)`` greedy row-step packing from the row
    entry counts ``row_nnz`` (m,) alone, the reference's plan: steps take
    at most ``chunk`` rows and at most ``budget`` entries, ``budget`` being
    4x the average chunk's entries and never below the densest row (nor
    64).  Each step is ``(row_off, rows_in, nnz_lo, nnz_hi)`` over the
    row-sorted entry stream; steps tile the stream contiguously."""
    m = int(row_nnz.shape[0])
    chunk = int(chunk)
    row_start = np.concatenate([[0], np.cumsum(row_nnz)]).astype(np.int64)
    avg_chunk_nnz = max(1, int(np.ceil(int(row_start[-1]) * chunk
                                       / max(m, 1))))
    budget = max(64, 4 * avg_chunk_nnz, int(row_nnz.max(initial=1)))
    steps = []
    r = 0
    while r < m:
        # the furthest row end within the entry budget (at least one row),
        # then the row cap
        hi = int(np.searchsorted(row_start, row_start[r] + budget,
                                 side="right")) - 1
        r_end = min(m, r + chunk, max(r + 1, hi))
        steps.append((r, r_end - r, int(row_start[r]),
                      int(row_start[r_end])))
        r = r_end
    if not steps:
        steps = [(0, 0, 0, 0)]
    return steps, budget


def _row_step_buffers(rows, cols, vals, plan, budget):
    """The kNN streaming buffers ``(data (s, budget), local_rows, cols,
    row_off (s,), rows_in (s,))`` of the row-sorted entries: entry g of
    step i lands in slot ``g - nnz_lo[i]`` of row i; pads are (value 0,
    row 0, column 0).  One scatter of distinct slots per buffer."""
    dev = vals.device
    s = len(plan)
    row_off = torch.tensor([st[0] for st in plan], dtype=torch.int32,
                           device=dev)
    rows_in = torch.tensor([st[1] for st in plan], dtype=torch.int32,
                           device=dev)
    nlo = torch.tensor([st[2] for st in plan], dtype=torch.int64,
                       device=dev)
    g = torch.arange(vals.shape[0], device=dev)
    step = (torch.searchsorted(nlo, g, right=True) - 1).clamp_(0, s - 1)
    dest = step * budget + (g - nlo[step])

    def scatter(src, dtype):
        out = torch.zeros(s * budget, dtype=dtype, device=dev)
        out[dest] = src.to(dtype)
        return out.view(s, budget)

    return (scatter(vals, vals.dtype),
            scatter(rows - row_off[step], torch.int32),
            scatter(cols, torch.int32), row_off, rows_in)


def _ell_buffers(rows, cols, vals, lengths, m_rows, r):
    """Padded ELL ``(vals (m_rows, r), cols (m_rows, r))`` of the
    row-sorted entries with ``lengths`` (m,) entries a row: entry g of row
    i lands in slot g − (the row's first entry); pads are (value 0,
    column 0).  One scatter of distinct slots per buffer."""
    dev = vals.device
    rows64 = rows.to(torch.int64)
    first = torch.cumsum(lengths, 0) - lengths
    slot = torch.arange(vals.shape[0], device=dev) - first[rows64]
    dest = rows64 * r + slot
    ev = torch.zeros(m_rows * r, dtype=vals.dtype, device=dev)
    ec = torch.zeros(m_rows * r, dtype=torch.int32, device=dev)
    ev[dest] = vals
    ec[dest] = cols.to(torch.int32)
    return ev.view(m_rows, r), ec.view(m_rows, r)


SparsePanelView = namedtuple(
    "SparsePanelView",
    ("data", "lrows", "cols", "counts_dev", "nse_p", "steps", "h"))
SparsePanelView.__doc__ = """The column-partitioned view of this rank's
shard of a :class:`ShardedSparse` (:meth:`ShardedSparse.panel_view`):
``data``/``lrows``/``cols`` (1, steps·nse_p), panel t's live entries in
slots [t·nse_p, t·nse_p + counts_dev[0, t]), row-sorted, with
PANEL-LOCAL columns (col − t·h); ``counts_dev`` (1, steps)."""


class ShardedSparse:
    """The reference's row-panel-sharded sparse layout.

    Device buffers of this rank's shard (of p = the mesh's rows): ``data``
    (1, nse) float32, ``lrows`` and ``cols`` (1, nse) int32 (shard-local
    rows), ``counts_dev`` (1,) int32 its live entries.  Live entries are
    row-sorted in slots ``[0, counts[s])``; the tail holds (0, row 0,
    column 0), and ``nse`` is the same on every shard.  Host metadata:
    ``counts`` (every shard's), ``row_nnz`` (int64 (m,), global) and
    ``cols_host`` (the global live column stream)."""

    __slots__ = ("data", "lrows", "cols", "counts_dev", "counts",
                 "row_nnz", "shape", "mesh", "m_local", "nse", "_rowsq",
                 "cols_host", "_ell", "_rsteps", "_pviews", "_p", "_shard")

    def __init__(self, data, lrows, cols, counts, row_nnz, shape, mesh,
                 cols_host=None):
        self.data, self.lrows, self.cols = data, lrows, cols
        self.counts = tuple(int(c) for c in counts)
        self._p = mesh.rows
        self._shard = mesh.coord[0]
        self.counts_dev = torch.tensor([self.counts[self._shard]],
                                       dtype=torch.int32, device=data.device)
        self.row_nnz = row_nnz
        self.shape = (int(shape[0]), int(shape[1]))
        self.mesh = mesh
        self.m_local = _padded_shape(self.shape,
                                     _mesh.pad_quantum(mesh))[0] // self._p
        self.nse = int(data.shape[1])
        self._rowsq = None
        self._ell = None
        self._rsteps = {}
        self._pviews = {}
        self.cols_host = None if cols_host is None \
            else np.asarray(cols_host, np.int32)

    @property
    def p(self) -> int:
        return self._p

    @property
    def nnz(self) -> int:
        return int(sum(self.counts))

    def __repr__(self):
        return (f"ShardedSparse(shape={self.shape}, p={self.p}, "
                f"nse={self.nse}, nnz={self.nnz})")

    @classmethod
    def build(cls, rows, cols, vals, shape, mesh=None, nse=None):
        """Bucket host global (row, col, val) triplets into the layout of
        ``mesh`` (the reference's ``build``); this rank keeps its shard."""
        mesh = mesh or _mesh.get_mesh()
        p = mesh.rows
        m, n = (int(s) for s in shape)
        m_local = _padded_shape((m, n), _mesh.pad_quantum(mesh))[0] // p
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals, np.float32)
        if rows.size and (rows.min() < 0 or rows.max() >= m
                          or cols.min() < 0 or cols.max() >= n):
            raise ValueError(
                f"sparse indices out of range for shape {(m, n)} — "
                "quarantine the offending rows at ingest "
                "(load_svmlight_file / SparseArray.from_scipy do)")
        order = np.argsort(rows, kind="stable")
        rows, cols, vals = rows[order], cols[order], vals[order]
        row_nnz = np.bincount(rows, minlength=m).astype(np.int64)
        counts = _shard_counts(row_nnz, m_local, p)
        nse = _round_nse(int(counts.max(initial=0)), nse)
        s = mesh.coord[0]
        lo = int(counts[:s].sum())
        k = int(counts[s])
        data = np.zeros((1, nse), np.float32)
        lr = np.zeros((1, nse), np.int32)
        cc = np.zeros((1, nse), np.int32)
        data[0, :k] = vals[lo:lo + k]
        lr[0, :k] = rows[lo:lo + k] - s * m_local
        cc[0, :k] = cols[lo:lo + k]
        dev = mesh.device
        return cls(torch.from_numpy(data).to(dev),
                   torch.from_numpy(lr).to(dev),
                   torch.from_numpy(cc).to(dev), counts, row_nnz, (m, n),
                   mesh, cols_host=cols.astype(np.int32))

    def _local_lengths(self) -> torch.Tensor:
        """Device (m_local,) int64 entries of each of this shard's rows."""
        r0 = self._shard * self.m_local
        out = np.zeros(self.m_local, np.int64)
        live = self.row_nnz[r0:r0 + self.m_local]
        out[: live.shape[0]] = live
        return torch.from_numpy(out).to(self.data.device)

    def rowsq(self) -> torch.Tensor:
        """Device (1, m_local) per-row ‖x_i‖² of this shard, summed in
        entry order."""
        if self._rowsq is None:
            v = self._live()[2]
            self._rowsq = seg_sum(v * v, self._local_lengths())[None]
        return self._rowsq

    def host_triplets(self):
        """(rows, cols, vals) host global triplets of the live entries
        (one read, counted under ``"sparse"``; across ranks the shards
        all-gathered first)."""
        rows, cols, vals = self._live()
        rows = rows.to(torch.int64) + self._shard * self.m_local
        if self.mesh.world > 1:
            rows, cols, vals = _gather_entries(rows, cols, vals,
                                               self.counts, self.mesh)
        count_read("sparse")
        return (rows.cpu().numpy().astype(np.int64),
                cols.cpu().numpy().astype(np.int64), vals.cpu().numpy())

    def _live(self):
        """(rows, cols, vals) device views of this shard's live entries."""
        k = self.counts[self._shard]
        return self.lrows[0, :k], self.cols[0, :k], self.data[0, :k]

    # -- the column-partitioned panel view (the SpMM's slot ranges) -----------

    def panel_counts(self, steps, h):
        """Host (p, steps) live entries of each shard in each panel (panel
        t holds columns [t·h, (t+1)·h)), from ``cols_host`` and
        ``counts``: no device read decides the view's shape."""
        start = np.concatenate([[0], np.cumsum(self.counts)]).astype(np.int64)
        pc = np.zeros((self.p, steps), np.int64)
        for s in range(self.p):
            seg = self.cols_host[start[s]:start[s + 1]] // h
            if seg.size:
                pc[s, :] = np.bincount(seg, minlength=steps)[:steps]
        return pc

    def panel_view(self, steps, h):
        """The :class:`SparsePanelView` of this rank's shard for a
        ``steps``-panel schedule of ``h`` columns a panel (the reference's
        ``panel_view``): the live entries re-sorted stably by panel, so a
        panel's entries stay row-sorted; panel t's slot range is
        ``[t·nse_p, (t+1)·nse_p)``, nse_p the :func:`nse_quantum`-rounded
        largest (shard, panel) count; columns panel-local; pads (value 0,
        row 0, column 0).  Built on the device, kept per (steps, h)."""
        key = (int(steps), int(h))
        if key not in self._pviews:
            steps, h = key
            pc = self.panel_counts(steps, h)
            nse_p = _round_nse(int(pc.max(initial=0)))
            rows, cols, vals = self._live()
            dev = vals.device
            pan = cols.to(torch.int64) // h
            order = torch.argsort(pan, stable=True)
            starts = torch.from_numpy(np.concatenate(
                [[0], np.cumsum(pc[self._shard])[:-1]])).to(dev)
            ps = pan[order]
            dest = ps * nse_p + (torch.arange(ps.shape[0], device=dev)
                                 - starts[ps])

            def scat(src, dtype):
                out = torch.zeros(steps * nse_p, dtype=dtype, device=dev)
                out[dest] = src[order].to(dtype)
                return out[None]

            self._pviews[key] = SparsePanelView(
                scat(vals, vals.dtype), scat(rows, torch.int32),
                scat(cols - pan * h, torch.int32),
                torch.from_numpy(pc[self._shard:self._shard + 1].astype(
                    np.int32)).to(dev), nse_p, steps, h)
        return self._pviews[key]

    # -- the estimator staging layouts, on this shard's rows ----------------

    def ell_buffers(self):
        """Padded ELL ``(vals (m_local, r), cols (m_local, r))`` of this
        shard's rows with r the largest row's entry count, built on the
        device from the live entries; rows past the logical m are all
        zero.  Cached."""
        if self._ell is None:
            r = max(1, int(self.row_nnz.max(initial=1)))
            self._ell = _ell_buffers(*self._live(), self._local_lengths(),
                                     self.m_local, r)
        return self._ell

    def _local_row_nnz(self) -> np.ndarray:
        r0 = self._shard * self.m_local
        return self.row_nnz[r0:min(r0 + self.m_local, self.shape[0])]

    def row_step_plan(self, chunk):
        """Host ``(steps, budget)`` of :func:`row_step_plan` over this
        shard's rows, from the host ``row_nnz``: no device read decides
        the step shapes."""
        return row_step_plan(self._local_row_nnz(), chunk)

    def row_step_buffers(self, chunk):
        """The kNN streaming buffers ``(data (s, budget), local_rows, cols,
        row_off (s,), rows_in (s,))`` of this shard's rows, gathered on
        the device, the reference's plan and entry order.  Cached per
        chunk."""
        key = int(chunk)
        if key not in self._rsteps:
            plan, budget = self.row_step_plan(key)
            self._rsteps[key] = _row_step_buffers(*self._live(), plan,
                                                  budget)
        return self._rsteps[key]


class SparseArray:
    """A 2-D sparse matrix on the device.

    ``rows``/``cols`` int32 and ``vals`` float32 (nnz,) tensors on one
    device, sorted by row — across ranks this rank's entries with local
    rows; build one with :meth:`from_scipy` or :meth:`from_dense`.
    ``row_nnz``/``cols_host``: the global host metadata (per-row entry
    counts, the column stream in row order), None when not known."""

    def __init__(self, rows, cols, vals, shape, mesh, reg_shape=None,
                 row_nnz=None, cols_host=None):
        self._rows, self._cols, self._vals = rows, cols, vals
        self._shape = (int(shape[0]), int(shape[1]))
        self._mesh = mesh
        self._reg_shape = tuple(reg_shape) if reg_shape else self._shape
        self._sparse = True
        self._row0, self._m_local = _row_geom(self._shape[0], mesh)
        self._row_len = torch.bincount(
            rows.to(torch.int64), minlength=self._m_local)
        self._meta = None if row_nnz is None else (
            np.asarray(row_nnz, np.int64),
            None if cols_host is None else np.asarray(cols_host, np.int32))
        self._col_cache = None
        self._dense_cache = None
        self._csr_cache = None
        self._sharded_rep = None
        self._row_nnz_host = None
        self._distinct_rep = None
        self._ell_cache = None
        self._rsteps = {}
        self._views = {}

    @classmethod
    def _from_triplets(cls, rows, cols, vals, shape, mesh, reg_shape=None,
                       sorted_rows=False):
        """From device triplets: sort by row (stable) unless they are."""
        if not sorted_rows and rows.numel():
            order = torch.argsort(rows, stable=True)
            rows, cols, vals = rows[order], cols[order], vals[order]
        return cls(rows.to(torch.int32).contiguous(),
                   cols.to(torch.int32).contiguous(),
                   vals.contiguous(), shape, mesh, reg_shape)

    # -- construction --------------------------------------------------------

    @classmethod
    def from_scipy(cls, mat, block_size=None, dtype=None, quarantine=False,
                   labels=None, device=None):
        """Build from a scipy sparse matrix on ``device`` (the default
        mesh's when None; across ranks each rank takes its rows of the
        same matrix).  ``dtype``: float32, or float64 when asked.
        ``quarantine=True`` runs the ingest hygiene of
        ``data/io._quarantine_csr`` (non-finite values or out-of-range
        columns quarantine their row); ``labels`` then come back
        row-aligned as ``(array, clean_labels)``."""
        report = None
        if quarantine:
            from dislib_tpu_torch.data.io import _quarantine_csr
            mat = mat.tocsr()
            y = np.zeros(mat.shape[0], np.float32) if labels is None \
                else np.asarray(labels)
            mat, y, report = _quarantine_csr(mat, y, "SparseArray.from_scipy",
                                             True)
            labels = None if labels is None else y
        out = cls._on_mesh(mat, _mesh_for(device), dtype, block_size)
        out.quarantine_ = report
        return out if labels is None else (out, labels)

    @classmethod
    def _on_mesh(cls, mat, mesh, dtype=None, block_size=None):
        """A scipy matrix on ``mesh``: on one rank every entry, across
        ranks this rank's rows of it (with the global host metadata)."""
        coo = mat.tocoo()
        dt = np.float64 if (dtype is not None
                            and np.dtype(dtype) == np.float64) else np.float32
        dev = mesh.device
        if mesh.world == 1:
            return cls._from_triplets(
                torch.from_numpy(coo.row.astype(np.int32)).to(dev),
                torch.from_numpy(coo.col.astype(np.int32)).to(dev),
                torch.from_numpy(coo.data.astype(dt)).to(dev), mat.shape,
                mesh, block_size)
        order = np.argsort(coo.row, kind="stable")
        rows = coo.row[order].astype(np.int64)
        cols = coo.col[order].astype(np.int32)
        vals = coo.data[order].astype(dt)
        r0, ml = _row_geom(mat.shape[0], mesh)
        lo, hi = np.searchsorted(rows, [r0, r0 + ml])
        return cls(torch.from_numpy((rows[lo:hi] - r0).astype(
            np.int32)).to(dev), torch.from_numpy(cols[lo:hi]).to(dev),
            torch.from_numpy(vals[lo:hi]).to(dev), mat.shape, mesh,
            block_size, np.bincount(rows, minlength=mat.shape[0]), cols)

    @classmethod
    def from_dense(cls, x, block_size=None, dtype=None, device=None):
        import scipy.sparse as sp
        dt = np.float64 if (dtype is not None
                            and np.dtype(dtype) == np.float64) else np.float32
        return cls.from_scipy(sp.coo_matrix(np.asarray(x, dtype=dt)),
                              block_size, dtype, device=device)

    # -- metadata ------------------------------------------------------------

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self) -> torch.dtype:
        return self._vals.dtype

    @property
    def device(self) -> torch.device:
        return self._vals.device

    @property
    def nnz(self) -> int:
        """The stored entries of the whole matrix (across ranks, of every
        mesh row)."""
        if self._mesh.world == 1:
            return int(self._vals.shape[0])
        return int(self._global_row_nnz().sum())

    @property
    def block_size(self):
        return self._reg_shape

    def __repr__(self):
        # across ranks the count is the metadata's (no collective here)
        nnz = self.nnz if self._mesh.world == 1 or self._meta is not None \
            else "?"
        return (f"dslib.SparseArray(shape={self._shape}, nnz={nnz}, "
                f"dtype={self.dtype}, device={self.device})")

    # -- the ranks -----------------------------------------------------------

    def _global_row_nnz(self) -> np.ndarray:
        """Host (m,) entries of each row of the whole matrix: the
        metadata given at construction, else read once (across ranks one
        ``all_gather`` of the rows' counts over 'rows'), kept."""
        if self._meta is None:
            if self._mesh.world == 1:
                row_nnz = self._row_nnz()
            else:
                lens = _dist.all_gather(self._row_len[None], _mesh.ROWS, 0,
                                        self._mesh)
                count_read("sparse")
                row_nnz = lens.reshape(-1)[: self._shape[0]].cpu().numpy()
            self._meta = (row_nnz.astype(np.int64), None)
        return self._meta[0]

    def _global_cols(self) -> np.ndarray:
        """Host global column stream in row order (the metadata, else one
        read of the gathered entries), kept."""
        row_nnz = self._global_row_nnz()
        if self._meta[1] is None:
            cols = self._gathered_view()._cols
            count_read("sparse")
            self._meta = (row_nnz, cols.cpu().numpy().astype(np.int32))
        return self._meta[1]

    def _counts(self):
        """Host live entries of each mesh row."""
        return _shard_counts(self._global_row_nnz(), self._m_local,
                             self._mesh.rows)

    def _local_view(self) -> "SparseArray":
        """This rank's rows as a one-rank array on its device (shape
        (m_local, n), the last rows padding with no entries); the array
        itself on one rank."""
        if self._mesh.world == 1:
            return self
        if "local" not in self._views:
            self._views["local"] = SparseArray(
                self._rows, self._cols, self._vals,
                (self._m_local, self._shape[1]),
                _mesh.local_mesh(self.device), self._reg_shape)
        return self._views["local"]

    def _gathered_view(self) -> "SparseArray":
        """The whole matrix as a one-rank array on this rank's device: the
        entries of every mesh row all-gathered over 'rows' once, with
        global rows, and kept; the array itself on one rank."""
        if self._mesh.world == 1:
            return self
        if "gathered" not in self._views:
            counts = self._counts()
            rows, cols, vals = _gather_entries(
                self._rows.to(torch.int64) + self._row0, self._cols,
                self._vals, counts, self._mesh)
            self._views["gathered"] = SparseArray(
                rows, cols, vals, self._shape, _mesh.local_mesh(self.device),
                self._reg_shape)
        return self._views["gathered"]

    @property
    def _at(self) -> tuple[int, int]:
        """The global (row, col) of this rank's first entry slot: its first
        row, every column (``Array._at``'s meaning)."""
        return (self._row0, 0)

    def _live_rows(self) -> int:
        """This rank's rows that are rows of the matrix (not padding)."""
        return max(0, min(self._m_local, self._shape[0] - self._row0))

    def _like(self, rows, cols, vals, keep_meta=False) -> "SparseArray":
        """An array of this one's shape and mesh over new (local)
        entries; ``keep_meta``: the entries sit where this array's do."""
        meta = self._meta if keep_meta and self._meta is not None \
            else (None, None)
        return SparseArray(rows, cols, vals, self._shape, self._mesh,
                           self._reg_shape, *meta)

    # -- the fixed-order layouts ---------------------------------------------

    def _by_col(self):
        """(rows, cols, vals, col_len) sorted by column (stable: by row
        within a column), made once and kept."""
        if self._col_cache is None:
            order = torch.argsort(self._cols, stable=True)
            self._col_cache = (self._rows[order], self._cols[order],
                               self._vals[order],
                               torch.bincount(self._cols[order].to(
                                   torch.int64), minlength=self._shape[1]))
        return self._col_cache

    def _coalesced(self):
        """(rows, cols, vals) with duplicate (row, col) entries summed in
        entry order, sorted by (row, col)."""
        key = self._rows.to(torch.int64) * self._shape[1] + self._cols
        key, order = torch.sort(key, stable=True)
        uniq, counts = torch.unique_consecutive(key, return_counts=True)
        vals = seg_sum(self._vals[order], counts)
        return ((uniq // self._shape[1]).to(torch.int32),
                (uniq % self._shape[1]).to(torch.int32), vals)

    # -- the sharded layout --------------------------------------------------

    def sharded(self, mesh=None) -> ShardedSparse:
        """The :class:`ShardedSparse` buffers for ``mesh`` (default: this
        array's), built once from the global host triplets (across ranks
        all-gathered once) and kept; this rank keeps its shard."""
        mesh = mesh or self._mesh
        if self._sharded_rep is None or self._sharded_rep.mesh != mesh:
            self._sharded_rep = ShardedSparse.build(
                *self._host_triplets(), self._shape, mesh)
        return self._sharded_rep

    def resharded(self, mesh=None, *, schedule="auto", nse=None,
                  overlap=None):
        _unported("SparseArray.resharded (the on-device sparse reshard)",
                  "A.11")

    def sharded_rows(self, mesh=None):
        """(data, local_rows, cols, rowsq) of this rank's shard of the
        :class:`ShardedSparse` buffers (pads (value 0, row 0, column
        0))."""
        rep = self.sharded(mesh)
        return rep.data, rep.lrows, rep.cols, rep.rowsq()

    # -- the estimator staging layouts (this rank's rows) --------------------

    def _row_nnz(self) -> np.ndarray:
        """Host entries of each of this rank's rows (m_local,; every row
        on one rank): from the host metadata, else one read (counted
        under ``"sparse"``), kept."""
        if self._row_nnz_host is None:
            if self._meta is not None:
                out = np.zeros(self._m_local, np.int64)
                live = self._meta[0][self._row0:self._row0 + self._m_local]
                out[: live.shape[0]] = live
                self._row_nnz_host = out
            else:
                count_read("sparse")
                self._row_nnz_host = self._row_len.cpu().numpy()
        return self._row_nnz_host

    def _distinct(self) -> "SparseArray":
        """This array with duplicate (row, column) entries summed in entry
        order: itself when it has none (checked once, one read; across
        ranks on every rank).  The staging layouts of the kNN and
        CascadeSVM densify rows by a scatter of distinct positions, which
        needs distinct entries."""
        if self._distinct_rep is None:
            rows, cols, vals = self._coalesced()
            dup = torch.tensor([int(rows.shape[0] != self._vals.shape[0])],
                               device=self.device)
            if self._mesh.world > 1:
                dup = _dist.pmax(dup, _dist.ALL, self._mesh)
            count_read("sparse")
            self._distinct_rep = self if not int(dup[0]) else \
                self._like(rows, cols, vals)
        return self._distinct_rep

    def ell(self, budget=None):
        """Padded ELL buffers ``(vals (m, r), cols (m, r))`` of this rank's
        rows with r their largest row's entry count, built on the device:
        ``vals[i]`` and ``cols[i]`` densify row i by one scatter, so an
        estimator that gathers arbitrary row subsets (CascadeSVM's node
        staging) does it on the device.  Pads are (value 0, column 0).
        Returns None when the buffers' bytes exceed ``budget`` (default
        :func:`ell_budget_bytes`): the caller then stages from a host CSR.
        The budget is checked on every call, against the kept buffers
        too."""
        budget = ell_budget_bytes() if budget is None else int(budget)
        m = self._m_local
        r = max(1, int(self._row_nnz().max(initial=1)))
        if m * r * 8 > budget:
            return None
        if self._ell_cache is None:
            self._ell_cache = _ell_buffers(
                self._rows, self._cols, self._vals, self._row_len, m, r)
        return self._ell_cache

    def row_step_plan(self, chunk):
        """Host ``(steps, budget)`` of :func:`row_step_plan` over this
        rank's rows."""
        return row_step_plan(self._row_nnz(), chunk)

    def row_steps(self, chunk):
        """Equal-shape per-step entry buffers for streaming bounded dense
        windows of this rank's rows (the sparse kNN): ``(data (s,
        budget), local_rows, cols, row_off (s,), rows_in (s,))`` with the
        steps of :meth:`row_step_plan` and pads (value 0, row 0, column
        0).  Built on the device; kept per chunk."""
        key = int(chunk)
        if key not in self._rsteps:
            plan, budget = self.row_step_plan(key)
            self._rsteps[key] = _row_step_buffers(
                self._rows, self._cols, self._vals, plan, budget)
        return self._rsteps[key]

    # -- the dense escape hatch ----------------------------------------------

    def _check_densify_budget(self):
        pm, pn = _padded_shape(self._shape, _mesh.pad_quantum(self._mesh))
        need = 4 * pm * pn
        budget = densify_budget_bytes()
        if need > budget:
            raise MemoryError(
                f"densifying this {self._shape} SparseArray needs "
                f"~{need / 2**30:.1f} GiB (> budget "
                f"{budget / 2**30:.1f} GiB). This estimator has no "
                "sparse-native path; use a sparse-aware one (KMeans, "
                "NearestNeighbors, KNeighborsClassifier, CascadeSVM, "
                "ALS, scalers) or raise DSLIB_SPARSE_DENSIFY_BUDGET to "
                "densify anyway.")

    def as_dense(self) -> Array:
        """The dense ds-array of this matrix (the budget-guarded backing,
        made once and kept): the input of an estimator with no
        sparse-native path.  The guard counts the padded global bytes;
        across ranks each rank densifies its block."""
        if self._dense_cache is None:
            self._check_densify_budget()
            self._dense_cache = self.to_dense()
        return self._dense_cache

    @property
    def _data(self) -> torch.Tensor:
        """Lazy padded dense backing (the reference's ``.toarray()``
        escape hatch), guarded by :func:`densify_budget_bytes`; on a mesh
        of several ranks it raises, as a dense ds-array's does."""
        if self._mesh.world > 1:
            raise _whole_array_guard(self._mesh)
        return self.as_dense()._data

    def to_dense(self) -> Array:
        """Densify on the device: duplicates summed in entry order, then
        one scatter of distinct positions onto zeros (across ranks, each
        rank's (rows, columns) block)."""
        rows, cols, vals = self._coalesced()
        if self._mesh.world == 1:
            pshape = _padded_shape(self._shape, _mesh.pad_quantum(self._mesh))
            out = torch.zeros(pshape, dtype=vals.dtype, device=vals.device)
            out[rows.to(torch.int64), cols.to(torch.int64)] = vals
            return Array(out, self._shape, self._mesh, self._reg_shape)
        nl = _padded_shape(self._shape, _mesh.pad_quantum(self._mesh))[1] \
            // self._mesh.cols
        c0 = self._mesh.coord[1] * nl
        mine = (cols >= c0) & (cols < c0 + nl)
        out = torch.zeros((self._m_local, nl), dtype=vals.dtype,
                          device=vals.device)
        out[rows[mine].to(torch.int64), (cols[mine] - c0).to(torch.int64)] \
            = vals[mine]
        return Array(out, self._shape, self._mesh, self._reg_shape)

    # -- sync / conversion ---------------------------------------------------

    def _host_triplets(self):
        """Host global (rows, cols, vals), one read counted under
        ``"sparse"`` (across ranks of the gathered entries)."""
        g = self._gathered_view()
        count_read("sparse")
        return (g._rows.cpu().numpy(), g._cols.cpu().numpy(),
                g._vals.cpu().numpy())

    def collect(self):
        """The matrix on the host as scipy CSR (duplicates summed), on
        every rank."""
        import scipy.sparse as sp
        r, c, v = self._host_triplets()
        return sp.csr_matrix((v, (r, c)), shape=self._shape)

    def _csr(self):
        """Cached host CSR mirror, the staging layout of row selection."""
        if self._csr_cache is None:
            self._csr_cache = self.collect().tocsr()
        return self._csr_cache

    def _dense_rows(self, idx) -> torch.Tensor:
        """The rows ``idx`` (distinct global ids) densified, (len(idx),
        n), duplicates summed, on every rank: each rank scatters the rows it holds, and
        one ``psum`` over 'rows' adds them (each row held by one mesh
        row: exact, up to the sign of a zero)."""
        idx = np.asarray(idx, np.int64)
        rows, cols, vals = self._coalesced()
        pos = np.full(self._m_local, -1, np.int64)
        mine = (idx >= self._row0) & (idx < self._row0 + self._m_local)
        pos[idx[mine] - self._row0] = np.nonzero(mine)[0]
        dest = torch.from_numpy(pos).to(self.device)[rows.to(torch.int64)]
        keep = dest >= 0
        out = torch.zeros((len(idx), self._shape[1]), dtype=vals.dtype,
                          device=self.device)
        out[dest[keep], cols[keep].to(torch.int64)] = vals[keep]
        return _dist.psum(out, _mesh.ROWS, self._mesh)

    def __getitem__(self, key) -> "SparseArray":
        """Slice / fancy-index rows and columns, staying sparse (through
        the host CSR mirror, as in the reference); across ranks rows only,
        by one ``all_to_all`` of entries (:meth:`_gather_rows`)."""
        rows, cols = _split_key(key)
        r_idx, _ = _normalize_index(rows, self._shape[0])
        c_idx, _ = _normalize_index(cols, self._shape[1])
        if self._mesh.world > 1:
            if c_idx != slice(0, self._shape[1], 1):
                raise _across_ranks("column indexing")
            src = np.arange(self._shape[0])[r_idx] \
                if isinstance(r_idx, slice) else np.asarray(r_idx)
            return self._gather_rows(src)
        sub = self._csr()[r_idx][:, c_idx]
        return SparseArray.from_scipy(sub.tocsr(), device=self.device)

    def _gather_rows(self, src, dst=None, n_out=None) -> "SparseArray":
        """``x[src]`` across ranks: row i of the result is row ``src[i]``
        (with ``dst``, row ``dst[i]`` of an ``n_out``-row result whose
        other rows are empty).  Every rank computes the routing from the
        host metadata alike (which entries each mesh row sends to each),
        gathers the entries it sends, ONE ``all_to_all`` over 'rows' moves
        them (rows, columns and values' bits packed in one int32 stream),
        and each rank sorts what it receives by row (stable: a row keeps
        its entries' order).  The entries are copied, never computed."""
        mesh = self._mesh
        p, s = mesh.rows, mesh.coord[0]
        src = np.asarray(src, np.int64).reshape(-1)
        dst = np.arange(src.shape[0]) if dst is None \
            else np.asarray(dst, np.int64).reshape(-1)
        n_out = src.shape[0] if n_out is None else int(n_out)
        row_nnz = self._global_row_nnz()
        cols_h = self._meta[1]
        out_ml = _row_geom(n_out, mesh)[1]
        start = np.concatenate([[0], np.cumsum(row_nnz)]).astype(np.int64)
        lens = row_nnz[src]
        # every (source shard, destination shard) pair's entry count
        s_of, d_of = src // self._m_local, dst // out_ml
        counts = np.zeros((p, p), np.int64)
        np.add.at(counts, (s_of, d_of), lens)
        cap = max(1, int(counts.max(initial=0)))
        # this rank's sends, grouped by target, in output-row order
        sel = np.nonzero(s_of == s)[0]
        sel = sel[np.argsort(d_of[sel], kind="stable")]
        ln = lens[sel]
        tot = int(ln.sum())
        first = np.repeat(start[src[sel]]
                          - start[min(s * self._m_local, row_nnz.shape[0])]
                          - np.concatenate([[0], np.cumsum(ln)[:-1]]), ln)
        pos = first + np.arange(tot)
        tgt = np.repeat(d_of[sel], ln)
        new_row = np.repeat(dst[sel] % out_ml, ln)
        slot = np.arange(tot) - np.concatenate(
            [[0], np.cumsum(counts[s])])[tgt]
        w = 2 + self._vals.element_size() // 4
        dev = self.device
        send = torch.zeros((p * cap, w), dtype=torch.int32, device=dev)
        if tot:
            pos_t = torch.from_numpy(pos).to(dev)
            send[torch.from_numpy(tgt * cap + slot).to(dev)] = _pack(
                torch.from_numpy(new_row).to(dev), self._cols[pos_t],
                self._vals[pos_t])
        recv = _dist.all_to_all(send.view(p, cap, w), _mesh.ROWS, mesh)
        d = mesh.coord[0]
        live = torch.cat([recv[q, : int(counts[q, d])] for q in range(p)])
        rows, cols, vals = _unpack(live, self.dtype)
        order = torch.argsort(rows, stable=True)
        # the result's host metadata: its rows' counts and column stream
        out_nnz = np.zeros(n_out, np.int64)
        out_nnz[dst] = lens
        at = np.argsort(dst, kind="stable")
        g = np.repeat(start[src[at]] - np.concatenate(
            [[0], np.cumsum(lens[at])[:-1]]), lens[at]) \
            + np.arange(int(lens.sum()))
        return SparseArray(rows[order], cols[order], vals[order],
                           (n_out, self._shape[1]), mesh, None, out_nnz,
                           None if cols_h is None else cols_h[g])

    # -- ops -----------------------------------------------------------------

    def transpose(self) -> "SparseArray":
        if self._mesh.world > 1:
            raise _across_ranks("the transpose")
        return SparseArray._from_triplets(
            self._cols, self._rows, self._vals,
            (self._shape[1], self._shape[0]), self._mesh,
            (self._reg_shape[1], self._reg_shape[0]))

    @property
    def T(self) -> "SparseArray":
        return self.transpose()

    def __matmul__(self, other):
        """sparse @ dense → dense Array, through ``math.matmul``'s
        spmm/densify router."""
        from dislib_tpu_torch.math.base import matmul
        if not isinstance(other, Array):
            other = Array._from_logical(torch.as_tensor(
                np.asarray(other, dtype=np.float32)), self._mesh)
        return matmul(self, other)

    def sum(self, axis=0) -> Array:
        """Fixed-order sums over ``axis`` as a dense ds-array (across
        ranks each rank's partial, then one ``psum`` over 'rows')."""
        if axis not in (0, 1, None):
            raise ValueError("axis must be 0, 1 or None")
        if axis == 1:
            out = seg_sum(self._vals, self._row_len).reshape(-1, 1)
            return Array._from_rows(out, (self._shape[0], 1), self._mesh)
        if axis is None:
            out = self._vals.sum().reshape(1, 1)
        else:
            _, _, vals, col_len = self._by_col()
            out = seg_sum(vals, col_len).reshape(1, -1)
        out = _dist.psum(out, _mesh.ROWS, self._mesh)
        return Array._from_logical(out, self._mesh)

    def mean(self, axis=0) -> Array:
        denom = self._shape[0] if axis == 0 else \
            self._shape[1] if axis == 1 else self._shape[0] * self._shape[1]
        return self.sum(axis) * (1.0 / denom)

    def row_norms_sq(self) -> torch.Tensor:
        """Device per-row ‖x_i‖² of this rank's rows (every row on one
        rank), summed in entry order."""
        return seg_sum(self._vals * self._vals, self._row_len)

    def _with_vals(self, vals) -> "SparseArray":
        return self._like(self._rows, self._cols, vals, keep_meta=True)

    def square(self) -> "SparseArray":
        """Elementwise x² — sparsity-preserving (0² = 0)."""
        return self._with_vals(self._vals * self._vals)

    def scale_cols(self, v) -> "SparseArray":
        """Column-wise scaling x[:, j] · v[j], sparsity-preserving."""
        v = (v if isinstance(v, torch.Tensor) else torch.as_tensor(
            np.asarray(v))).to(self.device).reshape(-1)
        if v.shape[0] != self._shape[1]:
            raise ValueError(f"scale vector length {v.shape[0]} != "
                             f"{self._shape[1]} columns")
        return self._with_vals(self._vals * v.to(self.dtype)[
            self._cols.to(torch.int64)])

    def _scaled(self, factor) -> "SparseArray":
        f = torch.tensor(np.float32(factor), device=self.device)
        return self._with_vals(self._vals * f.to(self.dtype))

    def __mul__(self, other):
        if np.isscalar(other):
            return self._scaled(other)
        return NotImplemented

    __rmul__ = __mul__

    def __truediv__(self, other):
        if np.isscalar(other):
            return self._scaled(1.0 / other)
        return NotImplemented

    def __neg__(self):
        return self._scaled(-1.0)

    def __add__(self, other):
        """sparse + sparse stays sparse (duplicates summed); sparse +
        dense is dense."""
        if isinstance(other, SparseArray):
            if other.shape != self.shape:
                raise ValueError(f"shape mismatch {self.shape} + "
                                 f"{other.shape}")
            cat = self._like(torch.cat((self._rows, other._rows)),
                             torch.cat((self._cols, other._cols)),
                             torch.cat((self._vals, other._vals)))
            return self._like(*cat._coalesced())
        if isinstance(other, Array):
            return self.to_dense() + other
        return NotImplemented

    def __sub__(self, other):
        if isinstance(other, SparseArray):
            return self + other._scaled(-1.0)
        if isinstance(other, Array):
            return self.to_dense() - other
        return NotImplemented
