"""The sparse ds-array on one card.

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

:class:`ShardedSparse` is the reference's rectangular layout on a (1, 1)
mesh (``build``, ``rowsq``, ``host_triplets``): one shard, its entries
row-sorted and tail-padded to an :func:`nse_quantum` multiple with (value
0, row 0, column 0).

The estimator staging layouts are built on the device from the
row-sorted triplets: ``row_steps`` (the sparse kNN's skew-bounded row
steps) and ``ell`` (CascadeSVM's padded row-gather layout), on the
:class:`SparseArray` and on its :class:`ShardedSparse` buffers alike.
Each is one scatter of distinct destinations (no sums), so two builds are
bit-identical.  Not ported: ``panel_view`` (the layout of the reference's
multi-panel SpMM, which bounds the panel bytes in flight across mesh
ranks: ROADMAP.md A.2) and the on-device reshard (``resharded``,
``ops/rechunk.reshard_sparse``), A.11.  Each raises
``NotImplementedError``.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from dislib_tpu_torch.data.array import (
    Array, _mesh_for, _normalize_index, _padded_shape, _split_key,
)
from dislib_tpu_torch.ops.spmm import seg_sum
from dislib_tpu_torch.parallel import mesh as _mesh
from dislib_tpu_torch.utils.profiling import count_read

__all__ = ["SparseArray", "ShardedSparse", "nse_quantum",
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
    works on: a :class:`SparseArray` through its budget-guarded lazy dense
    backing (:meth:`SparseArray.as_dense`, ``MemoryError`` past
    :func:`densify_budget_bytes`), a dense ds-array as it is."""
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


def _unported(what, item):
    raise NotImplementedError(
        f"{what}: the port runs one card; this layout waits for its "
        f"consumers (ROADMAP.md {item})")


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


class ShardedSparse:
    """The reference's row-panel-sharded sparse layout, on one shard.

    Device buffers (p = 1): ``data`` (p, nse) float32, ``lrows`` and
    ``cols`` (p, nse) int32, ``counts_dev`` (p,) int32 live entries per
    shard.  Live entries are row-sorted in slots ``[0, counts[s])``; the
    tail holds (0, row 0, column 0).  Host metadata: ``counts``,
    ``row_nnz`` (int64 (m,)) and ``cols_host`` (the live column stream).
    """

    __slots__ = ("data", "lrows", "cols", "counts_dev", "counts",
                 "row_nnz", "shape", "mesh", "m_local", "nse", "_rowsq",
                 "cols_host", "_ell", "_rsteps")

    def __init__(self, data, lrows, cols, counts, row_nnz, shape, mesh,
                 cols_host=None):
        self.data, self.lrows, self.cols = data, lrows, cols
        self.counts = tuple(int(c) for c in counts)
        self.counts_dev = torch.tensor(self.counts, dtype=torch.int32,
                                       device=data.device)
        self.row_nnz = row_nnz
        self.shape = (int(shape[0]), int(shape[1]))
        self.mesh = mesh
        self.m_local = _padded_shape(self.shape,
                                     _mesh.pad_quantum(mesh))[0] \
            // int(data.shape[0])
        self.nse = int(data.shape[1])
        self._rowsq = None
        self._ell = None
        self._rsteps = {}
        self.cols_host = None if cols_host is None \
            else np.asarray(cols_host, np.int32)

    @property
    def p(self) -> int:
        return int(self.data.shape[0])

    @property
    def nnz(self) -> int:
        return int(sum(self.counts))

    def __repr__(self):
        return (f"ShardedSparse(shape={self.shape}, p={self.p}, "
                f"nse={self.nse}, nnz={self.nnz})")

    @classmethod
    def build(cls, rows, cols, vals, shape, mesh=None, nse=None):
        """Bucket host (row, col, val) triplets into the layout."""
        mesh = mesh or _mesh.get_mesh()
        p = mesh.shape[_mesh.ROWS]
        if p != 1:
            raise NotImplementedError(
                f"ShardedSparse over {p} row shards: the port runs one "
                "rank (ROADMAP.md A.2)")
        m, n = (int(s) for s in shape)
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
        nse = _round_nse(rows.size, nse)
        data = np.zeros((1, nse), np.float32)
        lr = np.zeros((1, nse), np.int32)
        cc = np.zeros((1, nse), np.int32)
        data[0, :rows.size] = vals
        lr[0, :rows.size] = rows
        cc[0, :rows.size] = cols
        dev = mesh.device
        return cls(torch.from_numpy(data).to(dev),
                   torch.from_numpy(lr).to(dev),
                   torch.from_numpy(cc).to(dev), (rows.size,),
                   np.bincount(rows, minlength=m).astype(np.int64), (m, n),
                   mesh, cols_host=cols.astype(np.int32))

    def rowsq(self) -> torch.Tensor:
        """Device (p, m_local) per-row ‖x_i‖², summed in entry order."""
        if self._rowsq is None:
            k = self.counts[0]
            v = self.data[0, :k]
            lengths = torch.from_numpy(self.row_nnz).to(self.data.device)
            out = torch.zeros((1, self.m_local), dtype=v.dtype,
                              device=v.device)
            out[0, :self.shape[0]] = seg_sum(v * v, lengths)
            self._rowsq = out
        return self._rowsq

    def host_triplets(self):
        """(rows, cols, vals) host triplets of the live entries (one read,
        counted under ``"sparse"``)."""
        count_read("sparse")
        k = self.counts[0]
        return (self.lrows[0, :k].cpu().numpy().astype(np.int64),
                self.cols[0, :k].cpu().numpy().astype(np.int64),
                self.data[0, :k].cpu().numpy())

    def _live(self):
        """(rows, cols, vals) device views of the live entries."""
        k = self.counts[0]
        return self.lrows[0, :k], self.cols[0, :k], self.data[0, :k]

    def panel_view(self, steps, h):
        _unported("ShardedSparse.panel_view (the layout of the multi-panel "
                  "SpMM, spmm_steps/spmm_panels, which bounds the panel "
                  "bytes in flight across mesh ranks)", "A.2")

    def ell_buffers(self):
        """Padded ELL ``(vals (p·m_local, r), cols (p·m_local, r))`` with
        r the largest row's entry count, built on the device from the
        live entries; rows past the logical m are all zero.  Cached."""
        if self._ell is None:
            r = max(1, int(self.row_nnz.max(initial=1)))
            lengths = torch.zeros(self.p * self.m_local, dtype=torch.int64,
                                  device=self.data.device)
            lengths[:self.shape[0]] = torch.from_numpy(self.row_nnz).to(
                self.data.device)
            self._ell = _ell_buffers(*self._live(), lengths,
                                     self.p * self.m_local, r)
        return self._ell

    def row_step_plan(self, chunk):
        """Host ``(steps, budget)`` of :func:`row_step_plan` from the host
        ``row_nnz``: no device read decides the step shapes."""
        return row_step_plan(self.row_nnz, chunk)

    def row_step_buffers(self, chunk):
        """The kNN streaming buffers ``(data (s, budget), local_rows, cols,
        row_off (s,), rows_in (s,))`` gathered on the device, the
        reference's plan and entry order.  Cached per chunk."""
        key = int(chunk)
        if key not in self._rsteps:
            plan, budget = self.row_step_plan(key)
            self._rsteps[key] = _row_step_buffers(*self._live(), plan,
                                                  budget)
        return self._rsteps[key]


class SparseArray:
    """A 2-D sparse matrix on the device.

    ``rows``/``cols`` int32 and ``vals`` float32 (nnz,) tensors on one
    device, sorted by row; build one with :meth:`from_scipy` or
    :meth:`from_dense`."""

    def __init__(self, rows, cols, vals, shape, mesh, reg_shape=None):
        self._rows, self._cols, self._vals = rows, cols, vals
        self._shape = (int(shape[0]), int(shape[1]))
        self._mesh = mesh
        self._reg_shape = tuple(reg_shape) if reg_shape else self._shape
        self._sparse = True
        self._row_len = torch.bincount(
            rows.to(torch.int64), minlength=self._shape[0])
        self._col_cache = None
        self._dense_cache = None
        self._csr_cache = None
        self._sharded_rep = None
        self._row_nnz_host = None
        self._distinct_rep = None
        self._ell_cache = None
        self._rsteps = {}

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
        mesh's when None).  ``dtype``: float32, or float64 when asked.
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
        mesh = _mesh_for(device)
        coo = mat.tocoo()
        dt = np.float64 if (dtype is not None
                            and np.dtype(dtype) == np.float64) else np.float32
        dev = mesh.device
        out = cls._from_triplets(
            torch.from_numpy(coo.row.astype(np.int32)).to(dev),
            torch.from_numpy(coo.col.astype(np.int32)).to(dev),
            torch.from_numpy(coo.data.astype(dt)).to(dev), mat.shape, mesh,
            block_size)
        out.quarantine_ = report
        return out if labels is None else (out, labels)

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
        return int(self._vals.shape[0])

    @property
    def block_size(self):
        return self._reg_shape

    def __repr__(self):
        return (f"dslib.SparseArray(shape={self._shape}, nnz={self.nnz}, "
                f"dtype={self.dtype}, device={self.device})")

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
        array's), built once from the host triplets and kept."""
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
        """(data, local_rows, cols, rowsq) of the :class:`ShardedSparse`
        buffers (leading axis the shard; pads (value 0, row 0, column
        0))."""
        rep = self.sharded(mesh)
        return rep.data, rep.lrows, rep.cols, rep.rowsq()

    # -- the estimator staging layouts ----------------------------------------

    def _row_nnz(self) -> np.ndarray:
        """Host (m,) entries per row (one read, counted under
        ``"sparse"``), kept."""
        if self._row_nnz_host is None:
            count_read("sparse")
            self._row_nnz_host = self._row_len.cpu().numpy()
        return self._row_nnz_host

    def _distinct(self) -> "SparseArray":
        """This array with duplicate (row, column) entries summed in entry
        order: itself when it has none (checked once, one read).  The
        staging layouts of the kNN and CascadeSVM densify rows by a scatter
        of distinct positions, which needs distinct entries."""
        if self._distinct_rep is None:
            rows, cols, vals = self._coalesced()
            count_read("sparse")
            self._distinct_rep = self if rows.shape[0] == self.nnz else \
                SparseArray(rows, cols, vals, self._shape, self._mesh,
                            self._reg_shape)
        return self._distinct_rep

    def ell(self, budget=None):
        """Padded ELL buffers ``(vals (m, r), cols (m, r))`` with r the
        largest row's entry count, built on the device: ``vals[i]`` and
        ``cols[i]`` densify row i by one scatter, so an estimator that
        gathers arbitrary row subsets (CascadeSVM's node staging) does it
        on the device.  Pads are (value 0, column 0).  Returns None when
        the buffers' bytes exceed ``budget`` (default
        :func:`ell_budget_bytes`): the caller then stages from a host CSR.
        The budget is checked on every call, against the kept buffers
        too."""
        budget = ell_budget_bytes() if budget is None else int(budget)
        m = self._shape[0]
        r = max(1, int(self._row_nnz().max(initial=1)))
        if m * r * 8 > budget:
            return None
        if self._ell_cache is None:
            self._ell_cache = _ell_buffers(
                self._rows, self._cols, self._vals, self._row_len, m, r)
        return self._ell_cache

    def row_step_plan(self, chunk):
        """Host ``(steps, budget)`` of :func:`row_step_plan`."""
        return row_step_plan(self._row_nnz(), chunk)

    def row_steps(self, chunk):
        """Equal-shape per-step entry buffers for streaming bounded dense
        windows of the matrix (the sparse kNN): ``(data (s, budget),
        local_rows, cols, row_off (s,), rows_in (s,))`` with the steps of
        :meth:`row_step_plan` and pads (value 0, row 0, column 0).  Built on
        the device; kept per chunk."""
        key = int(chunk)
        if key not in self._rsteps:
            plan, budget = self.row_step_plan(key)
            self._rsteps[key] = _row_step_buffers(
                self._rows, self._cols, self._vals, plan, budget)
        return self._rsteps[key]

    # -- the dense escape hatch ----------------------------------------------

    def as_dense(self) -> Array:
        """The dense ds-array over :attr:`_data` (the budget-guarded lazy
        backing): the input of an estimator with no sparse-native
        path."""
        return Array(self._data, self._shape, self._mesh, self._reg_shape)

    @property
    def _data(self) -> torch.Tensor:
        """Lazy padded dense backing (the reference's ``.toarray()``
        escape hatch), guarded by :func:`densify_budget_bytes`."""
        if self._dense_cache is None:
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
                    "scalers) or raise DSLIB_SPARSE_DENSIFY_BUDGET to "
                    "densify anyway.")
            self._dense_cache = self.to_dense()._data
        return self._dense_cache

    def to_dense(self) -> Array:
        """Densify on the device: duplicates summed in entry order, then
        one scatter of distinct positions onto zeros."""
        rows, cols, vals = self._coalesced()
        pshape = _padded_shape(self._shape, _mesh.pad_quantum(self._mesh))
        out = torch.zeros(pshape, dtype=vals.dtype, device=vals.device)
        out[rows.to(torch.int64), cols.to(torch.int64)] = vals
        return Array(out, self._shape, self._mesh, self._reg_shape)

    # -- sync / conversion ---------------------------------------------------

    def _host_triplets(self):
        count_read("sparse")
        return (self._rows.cpu().numpy(), self._cols.cpu().numpy(),
                self._vals.cpu().numpy())

    def collect(self):
        """The matrix on the host as scipy CSR (duplicates summed)."""
        import scipy.sparse as sp
        r, c, v = self._host_triplets()
        return sp.csr_matrix((v, (r, c)), shape=self._shape)

    def _csr(self):
        """Cached host CSR mirror, the staging layout of row selection."""
        if self._csr_cache is None:
            self._csr_cache = self.collect().tocsr()
        return self._csr_cache

    def __getitem__(self, key) -> "SparseArray":
        """Slice / fancy-index rows and columns, staying sparse (through
        the host CSR mirror, as in the reference)."""
        rows, cols = _split_key(key)
        r_idx, _ = _normalize_index(rows, self._shape[0])
        c_idx, _ = _normalize_index(cols, self._shape[1])
        sub = self._csr()[r_idx][:, c_idx]
        return SparseArray.from_scipy(sub.tocsr(), device=self.device)

    # -- ops -----------------------------------------------------------------

    def transpose(self) -> "SparseArray":
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
        """Fixed-order sums over ``axis`` as a dense ds-array."""
        if axis not in (0, 1, None):
            raise ValueError("axis must be 0, 1 or None")
        if axis is None:
            out = self._vals.sum().reshape(1, 1)
        elif axis == 1:
            out = seg_sum(self._vals, self._row_len).reshape(-1, 1)
        else:
            _, _, vals, col_len = self._by_col()
            out = seg_sum(vals, col_len).reshape(1, -1)
        return Array._from_logical(out, self._mesh)

    def mean(self, axis=0) -> Array:
        denom = self._shape[0] if axis == 0 else \
            self._shape[1] if axis == 1 else self._shape[0] * self._shape[1]
        return self.sum(axis) * (1.0 / denom)

    def row_norms_sq(self) -> torch.Tensor:
        """Device (m,) per-row ‖x_i‖², summed in entry order."""
        return seg_sum(self._vals * self._vals, self._row_len)

    def _with_vals(self, vals) -> "SparseArray":
        return SparseArray(self._rows, self._cols, vals, self._shape,
                           self._mesh, self._reg_shape)

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
            cat = SparseArray(torch.cat((self._rows, other._rows)),
                              torch.cat((self._cols, other._cols)),
                              torch.cat((self._vals, other._vals)),
                              self._shape, self._mesh, self._reg_shape)
            rows, cols, vals = cat._coalesced()
            return SparseArray(rows, cols, vals, self._shape, self._mesh,
                               self._reg_shape)
        if isinstance(other, Array):
            return self.to_dense() + other
        return NotImplemented

    def __sub__(self, other):
        if isinstance(other, SparseArray):
            return self + other._scaled(-1.0)
        if isinstance(other, Array):
            return self.to_dense() - other
        return NotImplemented

