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

Not ported: the layouts that wait for their consumers —
``panel_view`` (the multi-panel SpMM layout, with ALS), ``ell`` (CSVM) and
``row_steps`` (the sparse kNN), ROADMAP.md A.10 — and the on-device
reshard (``resharded``, ``ops/rechunk.reshard_sparse``), A.11.  Each
raises ``NotImplementedError``.
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
           "densify_budget_bytes"]


def nse_quantum() -> int:
    """The stored-entry pad quantum of :class:`ShardedSparse`
    (``DSLIB_SPARSE_NSE_QUANTUM``, default 64)."""
    return max(1, int(os.environ.get("DSLIB_SPARSE_NSE_QUANTUM", "64")))


def densify_budget_bytes() -> int:
    """The byte budget above which densifying a SparseArray raises
    (``DSLIB_SPARSE_DENSIFY_BUDGET``, default 4 GiB): read by the lazy
    dense backing and by ``math.matmul``'s spmm/densify router."""
    return int(os.environ.get("DSLIB_SPARSE_DENSIFY_BUDGET", 4 << 30))


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
                 "cols_host")

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

    def panel_view(self, steps, h):
        _unported("ShardedSparse.panel_view", "A.10")

    def ell_buffers(self):
        _unported("ShardedSparse.ell_buffers", "A.10")

    def row_step_buffers(self, chunk):
        _unported("ShardedSparse.row_step_buffers", "A.10")


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

    def ell(self, budget=None):
        _unported("SparseArray.ell", "A.10")

    def row_steps(self, chunk):
        _unported("SparseArray.row_steps", "A.10")

    # -- the dense escape hatch ----------------------------------------------

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
                    "sparse-native path; use a sparse-aware one (KMeans) "
                    "or raise DSLIB_SPARSE_DENSIFY_BUDGET to densify "
                    "anyway.")
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
        v = torch.as_tensor(np.asarray(v), device=self.device).reshape(-1)
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

