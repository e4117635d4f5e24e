"""The distributed array (ds-array) — the port's single data structure.

Counterpart of ``dislib_tpu/data/array.py``, eager half.  The matrix is
padded so every dimension is a multiple of the mesh pad quantum, and the
region outside the logical ``shape`` is ALWAYS ZERO, which keeps
contractions exact with no masking; ``min``/``max`` mask the pad and
``mean`` divides by the logical count.  ``block_size`` survives as a hint
(``_reg_shape``) for API parity.

On a one-rank mesh the padded matrix is ONE torch tensor on the mesh's
device.  On a mesh of R x C ranks (a ``torch.distributed`` job, see
``parallel/distributed.py``) each rank holds its ``(M_pad/R, N_pad/C)``
block of it — the reference's ``P(ROWS, COLS)`` placement — and the
global logical shape.  Ported code reads the rank's block through
``_local``; ``_data``, the whole padded tensor, exists only on a one-rank
mesh and raises on a larger one, naming ROADMAP.md A.11
(:func:`_whole_array_guard`): every module not yet ported to the mesh
reads ``_data``, so none of them computes on one rank's rows without
knowing it.  Across ranks run the ds-array and the sparse ds-array, and
every estimator of the package (the guard's message lists them); A.11
holds the re-layouts, the snapshots of a multi-rank fit and serving
across ranks.  Across ranks: the constructors place
blocks (each rank takes its block of the same global input or draw),
``collect`` all-gathers them, the elementwise ops of equal shapes and
scalars stay local, a (1, n), (m, 1) or (1, 1) operand of a broadcast
op comes to each rank by one broadcast from the first mesh row (column)
(:func:`_spread`), the reductions reduce locally and then over the
reduced mesh axis, a row index gathers rows by one ``all_to_all``
over 'rows' (:func:`_gather_rows`), and so do ``concat_rows`` and the
iterator's row stripes; ``concat_cols``, ``apply_along_axis`` and the
column stripes work on each rank's rows or columns.  Everything else
raises ``NotImplementedError`` at world > 1, naming the ROADMAP.md item
that ports it.

Every op runs eagerly — what the reference does under ``DSLIB_EAGER=1``:
``is_lazy`` is always False, ``force()`` returns the array, and
``block_until_ready()`` waits for its device work.
A scipy sparse matrix given to :func:`array` is densified, as in the
reference, and the array keeps the reference's ``_sparse`` flag:
``collect`` gives a scipy CSR, and the flag follows the ops that keep
zeros zero (as the reference's does).  The sparse ds-array is
``data/sparse.SparseArray``.  Not ported
yet: the lazy fusion graph (``_LazyExpr``, ``fused_kernel``) and
multi-rank ``rechunk`` schedules (ROADMAP.md A.11).
"""

from __future__ import annotations

import math
import warnings
from numbers import Number

import numpy as np
import torch

from dislib_tpu_torch.parallel import distributed as _dist
from dislib_tpu_torch.parallel import mesh as _mesh

__all__ = ["Array", "array", "random_array", "zeros", "full", "ones",
           "identity", "eye", "apply_along_axis", "concat_rows",
           "concat_cols", "rechunk", "ensure_canonical"]


# ---------------------------------------------------------------------------
# padding helpers
# ---------------------------------------------------------------------------

def _padded_dim(n: int, quantum: int) -> int:
    return max(quantum, int(math.ceil(n / quantum)) * quantum)


def _padded_shape(shape, quantum):
    return tuple(_padded_dim(int(s), quantum) for s in shape)


def _zero_pad(data: torch.Tensor, logical_shape, at=(0, 0)) -> torch.Tensor:
    """Force the padding region to zero (the core Array invariant).
    ``at``: the global (row, col) of ``data[0, 0]`` when ``data`` is one
    rank's block."""
    rows = max(0, logical_shape[0] - at[0])
    cols = max(0, logical_shape[1] - at[1])
    if rows >= data.shape[0] and cols >= data.shape[1]:
        return data
    out = data.clone()
    out[rows:, :] = 0
    out[:, cols:] = 0
    return out


def _place(data: torch.Tensor, padded_shape, logical_shape) -> torch.Tensor:
    """Pad ``data`` (logical region) up to ``padded_shape`` with zeros."""
    out = torch.zeros(padded_shape, dtype=data.dtype, device=data.device)
    out[:logical_shape[0], :logical_shape[1]] = \
        data[:logical_shape[0], :logical_shape[1]]
    return out


def _pad_mask(padded_shape, logical_shape, device, at=(0, 0)) -> torch.Tensor:
    """Boolean mask: True inside the logical region (``at`` as in
    :func:`_zero_pad`)."""
    r = torch.arange(padded_shape[0], device=device) < logical_shape[0] - at[0]
    c = torch.arange(padded_shape[1], device=device) < logical_shape[1] - at[1]
    return r[:, None] & c[None, :]


def _repad(logical_data: torch.Tensor, shape, mesh) -> torch.Tensor:
    """Pad logical(-region) data out to the mesh quantum, zero-filled."""
    pshape = _padded_shape(shape, _mesh.pad_quantum(mesh))
    cropped = logical_data[: shape[0], : shape[1]]
    if tuple(cropped.shape) == pshape:
        return cropped
    return _place(cropped, pshape, shape)


def _place_region(v: torch.Tensor, pshape) -> torch.Tensor:
    """Zero canvas of ``pshape`` with ``v`` written at (0, 0) — the
    padded backing of a result whose logical region is ``v``."""
    if tuple(v.shape) == tuple(pshape):
        return v
    out = torch.zeros(pshape, dtype=v.dtype, device=v.device)
    out[: v.shape[0], : v.shape[1]] = v
    return out


# ---------------------------------------------------------------------------
# blocks on a mesh of several ranks
# ---------------------------------------------------------------------------

def _block_geom(shape, mesh):
    """(row0, col0, rows, cols) of this rank's block of a ds-array of
    logical ``shape`` on ``mesh``: the global offset and the extent."""
    pm, pn = _padded_shape(shape, _mesh.pad_quantum(mesh))
    r, c = mesh.coord
    ml, nl = pm // mesh.rows, pn // mesh.cols
    return r * ml, c * nl, ml, nl


def _block_with(vals: torch.Tensor, at, shape, mesh) -> torch.Tensor:
    """This rank's block of the ds-array of logical ``shape`` that is zero
    except ``vals`` at global offset ``at`` (cut to the logical region)."""
    r0, c0, ml, nl = _block_geom(shape, mesh)
    out = torch.zeros((ml, nl), dtype=vals.dtype, device=mesh.device)
    i0, j0 = at
    a = max(i0, r0)
    b = min(i0 + vals.shape[0], r0 + ml, shape[0])
    lo = max(j0, c0)
    hi = min(j0 + vals.shape[1], c0 + nl, shape[1])
    if a < b and lo < hi:
        out[a - r0: b - r0, lo - c0: hi - c0] = \
            vals[a - i0: b - i0, lo - j0: hi - j0]
    return out


def _sharded(mesh) -> bool:
    return mesh.world > 1


def _spread(x: "Array", out_shape) -> torch.Tensor:
    """The operand ``x`` of a broadcast elementwise op whose result has
    ``out_shape``, as this rank's part of it: its own block along an axis
    it spans, and its one logical row (column) along an axis of length 1
    that the result spans.  That row lives in the blocks of mesh row 0,
    whose column blocks line up with the result's (the same length and
    quantum), so it comes from there by one broadcast over 'rows'
    (a column over 'cols'); a (1, 1) operand takes both."""
    t, mesh = x._local, x._mesh
    if x._shape[0] == 1 and out_shape[0] > 1:
        own = mesh.coord[0] == 0
        t = _dist.broadcast_from(t[:1].contiguous() if own else torch.empty(
            (1, t.shape[1]), dtype=t.dtype, device=t.device), 0,
            _mesh.ROWS, mesh)
    if x._shape[1] == 1 and out_shape[1] > 1:
        own = mesh.coord[1] == 0
        t = _dist.broadcast_from(t[:, :1].contiguous() if own else
                                 torch.empty((t.shape[0], 1), dtype=t.dtype,
                                             device=t.device), 0,
                                 _mesh.COLS, mesh)
    return t


def _guard(what, item="A.11"):
    return NotImplementedError(
        f"{what} of a ds-array sharded over several ranks is not ported "
        f"yet (ROADMAP.md {item})")


def _whole_array_guard(mesh):
    """The error of an operation that reads the whole padded backing
    (``_data``) of an array sharded over several ranks: a module not
    ported to the mesh."""
    return NotImplementedError(
        "this operation reads the whole ds-array and the array is sharded "
        f"over a {(mesh.rows, mesh.cols)} mesh of ranks; across ranks run "
        "so far: the ds-array and its helpers, the sparse ds-array "
        "(SparseArray), matmul and the SpMM, kron, qr, svd, polar, tsqr, "
        "random_svd, lanczos_svd, PCA, KMeans (dense and sparse), "
        "MiniBatchKMeans, GaussianMixture, the scalers, LinearRegression, "
        "ADMM/Lasso, NearestNeighbors (dense and sparse), "
        "KNeighborsClassifier, the decision trees and random forests, "
        "DBSCAN, Daura, CascadeSVM (dense and sparse), ALS, IVFIndex, the "
        "searches and the shuffle (ROADMAP.md A.11 ports the re-layouts, "
        "the snapshots of a multi-rank fit and serving across ranks)")


def _routing(src, m_in_loc, m_out_loc, p, dst=None):
    """Host routing plan of ``out[dst[i]] = x[src[i]]`` (``dst`` default
    ``arange``: ``out[i] = x[src[i]]``) between contiguous row shards,
    ``m_in_loc`` rows a shard of ``x`` and ``m_out_loc`` of ``out`` (the
    reference's ``utils/base._routing``, which has one height for both).
    Returns (send_idx, dst_idx), both (p, p, cap) int64: ``send_idx[s, d,
    c]`` the local row of ``x`` that shard s sends as its c-th row to
    shard d (padding slots repeat row 0); ``dst_idx[d, s, c]`` the local
    row of ``out`` it lands on (padding slots hold ``m_out_loc``, a sink
    row that is cut off)."""
    src = np.asarray(src, np.int64)
    m = len(src)
    i = np.arange(m) if dst is None else np.asarray(dst, np.int64)
    s_shard = src // m_in_loc
    d_shard = i // m_out_loc
    order = np.lexsort((i, d_shard, s_shard))   # by (s, d), stable in i
    s_sorted, d_sorted = s_shard[order], d_shard[order]
    counts = np.zeros((p, p), np.int64)
    np.add.at(counts, (s_sorted, d_sorted), 1)
    cap = max(1, int(counts.max()))
    send_idx = np.zeros((p, p, cap), np.int64)
    dst_idx = np.full((p, p, cap), m_out_loc, np.int64)
    flat = s_sorted * p + d_sorted
    starts = np.concatenate([[0], np.cumsum(
        np.bincount(flat, minlength=p * p))[:-1]])
    slot = np.arange(m) - starts[flat]
    send_idx[s_sorted, d_sorted, slot] = src[order] % m_in_loc
    dst_idx[d_sorted, s_sorted, slot] = i[order] % m_out_loc
    return send_idx, dst_idx


def _gather_rows(x: "Array", src, plan=None, dst=None, out_shape=None,
                 out=None):
    """``x[src, :]`` on a sharded ``x``: every rank gathers the rows it
    sends, ONE ``all_to_all`` over 'rows' moves them, every rank scatters
    what it receives into its block (the reference's shuffle exchange).
    Returns (Array, plan); a ``plan`` from an earlier call of the same
    ``src`` on an array of the same height is reused.  With ``dst``, row
    ``src[i]`` lands on row ``dst[i]`` of an ``out_shape`` array, written
    into the block ``out`` (this rank's (rows + 1, cols) canvas, its last
    row a sink) when one is given, so several calls can fill one
    result."""
    mesh = x._mesh
    p = mesh.rows
    if out_shape is None:
        out_shape = (len(src), x._shape[1])
    m_in_loc = x._local.shape[0]
    m_out_loc = _block_geom(out_shape, mesh)[2]
    if plan is None:
        send_idx, dst_idx = _routing(src, m_in_loc, m_out_loc, p, dst)
        plan = (torch.from_numpy(send_idx).to(mesh.device),
                torch.from_numpy(dst_idx).to(mesh.device))
    r = mesh.coord[0]
    send_idx, dst_idx = plan[0][r], plan[1][r]
    local = x._local
    recv = _dist.all_to_all(local[send_idx], "rows", mesh)  # (p, cap, nl)
    if out is None:
        out = torch.zeros((m_out_loc + 1, local.shape[1]), dtype=local.dtype,
                          device=local.device)
    out[dst_idx.reshape(-1)] = recv.reshape(-1, local.shape[1]).to(out.dtype)
    arr = Array(out[:m_out_loc], out_shape, mesh, sparse=x._sparse)
    return arr, plan


def _default_block_size(shape, mesh):
    r, c = _mesh.mesh_shape(mesh)
    return (max(1, -(-shape[0] // r)), max(1, -(-shape[1] // c)))


class Array:
    """A 2-D matrix on the device mesh.

    Users build Arrays with :func:`array` or :func:`zeros`, or as results
    of library operations.  ``data`` is this rank's block of the padded
    backing (zero outside the logical ``shape``) — the whole backing on a
    one-rank mesh; ``mesh`` is the mesh it lives on.
    """

    def __init__(self, data: torch.Tensor, shape, mesh, reg_shape=None,
                 sparse=False):
        self._local = data
        self._sparse = bool(sparse)
        self._mesh = mesh
        self._shape = (int(shape[0]), int(shape[1]))
        if reg_shape is None:
            reg_shape = _default_block_size(self._shape, mesh)
        self._reg_shape = (int(reg_shape[0]), int(reg_shape[1]))

    @classmethod
    def _from_logical(cls, data: torch.Tensor, mesh,
                      reg_shape=None) -> "Array":
        """Wrap a logically shaped (unpadded) tensor, placing it on the
        mesh's device and padding it to the mesh quantum."""
        shape = tuple(data.shape)
        if _sharded(mesh):
            return cls(_block_with(data.to(mesh.device), (0, 0), shape, mesh),
                       shape, mesh, reg_shape=reg_shape)
        data = data.to(mesh.device)
        pshape = _padded_shape(shape, _mesh.pad_quantum(mesh))
        if shape != pshape:
            data = _place(data, pshape, shape)
        return cls(data.contiguous(), shape, mesh, reg_shape=reg_shape)

    @classmethod
    def _from_padded(cls, padded: torch.Tensor, shape, mesh,
                     reg_shape=None) -> "Array":
        """Wrap a backing that may hold the logical region plus anything
        in its padding: re-zero the padding so the invariant holds."""
        pshape = _padded_shape(shape, _mesh.pad_quantum(mesh))
        if tuple(padded.shape) != pshape:
            padded = _place(padded, pshape, shape)
        return cls(_zero_pad(padded, shape), shape, mesh, reg_shape)

    @classmethod
    def _from_logical_padded(cls, padded_data: torch.Tensor, shape, mesh,
                             reg_shape=None, sparse=False) -> "Array":
        """Wrap data already padded and zeroed for ``shape``."""
        return cls(padded_data.to(mesh.device), shape, mesh, reg_shape,
                   sparse)

    @classmethod
    def _from_rows(cls, rows: torch.Tensor, shape, mesh, reg_shape=None,
                   sparse=False) -> "Array":
        """Wrap this rank's rows of a result of logical ``shape``: ``rows``
        holds the rows of the rank's block (its first row is the block's,
        the global row ``_block_geom(shape, mesh)[0]``) with the columns
        from 0 on, as many as it has; the rank keeps its columns and the
        pad is zeroed.  On one rank ``rows`` is the whole result."""
        r0, c0, ml, nl = _block_geom(shape, mesh)
        t = rows[:ml, c0:c0 + nl]
        if tuple(t.shape) != (ml, nl):
            out = torch.zeros((ml, nl), dtype=rows.dtype, device=rows.device)
            out[: t.shape[0], : t.shape[1]] = t
            t = out
        return cls(_zero_pad(t.contiguous(), shape, (r0, c0)), shape, mesh,
                   reg_shape, sparse)

    # -- metadata ------------------------------------------------------------

    @property
    def shape(self) -> tuple[int, int]:
        return self._shape

    @property
    def _data(self) -> torch.Tensor:
        """The whole padded backing — on a one-rank mesh only.  A module
        not yet ported to the mesh reads this, so on a mesh of several
        ranks it raises instead of computing on one rank's block."""
        if _sharded(self._mesh):
            raise _whole_array_guard(self._mesh)
        return self._local

    @property
    def dtype(self) -> torch.dtype:
        return self._local.dtype

    @property
    def device(self) -> torch.device:
        return self._local.device

    @property
    def _pshape(self) -> tuple[int, int]:
        if _sharded(self._mesh):
            return _padded_shape(self._shape, _mesh.pad_quantum(self._mesh))
        return tuple(self._local.shape)

    @property
    def _at(self) -> tuple[int, int]:
        """The global (row, col) of this rank's block's first element."""
        if not _sharded(self._mesh):
            return (0, 0)
        return _block_geom(self._shape, self._mesh)[:2]

    def _gathered(self) -> torch.Tensor:
        """The whole padded backing on every rank: the blocks all-gathered
        over 'cols', then over 'rows' (the backing itself on one rank)."""
        if not _sharded(self._mesh):
            return self._local
        t = _dist.all_gather(self._local, _mesh.COLS, 1, self._mesh)
        return _dist.all_gather(t, _mesh.ROWS, 0, self._mesh)

    def _row_block(self) -> torch.Tensor:
        """This rank's rows with every column: its block all-gathered over
        'cols' (the reference's ``row_sharding`` constraint); the first
        row is global row ``_at[0]``."""
        if not _sharded(self._mesh):
            return self._local
        return _dist.all_gather(self._local, _mesh.COLS, 1, self._mesh)

    @property
    def _n_blocks(self) -> tuple[int, int]:
        return (-(-self._shape[0] // self._reg_shape[0]),
                -(-self._shape[1] // self._reg_shape[1]))

    @property
    def block_size(self) -> tuple[int, int]:
        return self._reg_shape

    def __repr__(self):
        return (f"dslib.Array(shape={self._shape}, block_size="
                f"{self._reg_shape}, dtype={self.dtype}, "
                f"device={self.device})")

    # -- sync points -----------------------------------------------------------

    @property
    def is_lazy(self) -> bool:
        """False: the port runs every op eagerly, so no array is a
        deferred op chain."""
        return False

    def force(self) -> "Array":
        """Return self: there is no deferred chain to materialise (the
        reference's ``force`` on a concrete array is a no-op too)."""
        return self

    def block_until_ready(self) -> "Array":
        """Wait until the device work queued before this call (on the
        current stream, which produced this array) is done, and return
        self: a sync, not a read."""
        if self._local.device.type == "cuda":
            torch.cuda.current_stream(self._local.device).synchronize()
        return self

    def collect(self) -> np.ndarray:
        """Materialise the logical region on the host as a NumPy array
        (on every rank, from the all-gathered blocks, on a mesh of
        several ranks)."""
        out = self._gathered()[: self._shape[0], : self._shape[1]]
        if out.dtype == torch.bfloat16:       # numpy has no bfloat16
            out = out.to(torch.float32)
        out = out.cpu().numpy()
        if self._sparse:
            import scipy.sparse as sp
            return sp.csr_matrix(out)
        return out

    def __float__(self) -> float:
        """Host scalar of a (1, 1) array."""
        if self._shape != (1, 1):
            raise TypeError(
                f"only a (1, 1) ds-array converts to float, got {self._shape}")
        return float(self._gathered()[0, 0].item())

    # -- layout ----------------------------------------------------------------

    def rechunk(self, block_size) -> "Array":
        """Change the block-size hint (see :func:`rechunk`)."""
        return rechunk(self, block_size)

    def astype(self, dtype) -> "Array":
        return Array(self._local.to(_torch_dtype(dtype)), self._shape,
                     self._mesh, self._reg_shape, self._sparse)

    def copy(self) -> "Array":
        return Array(self._local.clone(), self._shape, self._mesh,
                     self._reg_shape, self._sparse)

    def transpose(self) -> "Array":
        if _sharded(self._mesh):
            raise _guard("transpose")
        shape = (self._shape[1], self._shape[0])
        reg = (self._reg_shape[1], self._reg_shape[0])
        return Array(self._data.T.contiguous(), shape, self._mesh, reg,
                     self._sparse)

    @property
    def T(self) -> "Array":
        return self.transpose()

    # -- indexing --------------------------------------------------------------

    def __getitem__(self, key) -> "Array":
        """Basic (int/slice) and fancy (int array / boolean mask) indexing
        on either axis — ``x[idx, :]`` is the row gather KMeans' random
        init uses."""
        rows, cols = _split_key(key)
        r_idx, r_len = _normalize_index(rows, self._shape[0])
        c_idx, c_len = _normalize_index(cols, self._shape[1])
        if _sharded(self._mesh):
            if c_idx != slice(0, self._shape[1], 1):
                raise _guard("column indexing")
            src = np.arange(self._shape[0])[r_idx] \
                if isinstance(r_idx, slice) else r_idx
            return _gather_rows(self, src)[0]
        data = self._data
        data = data[r_idx, :] if isinstance(r_idx, slice) else \
            data[torch.as_tensor(r_idx, device=data.device), :]
        data = data[:, c_idx] if isinstance(c_idx, slice) else \
            data[:, torch.as_tensor(c_idx, device=data.device)]
        out = Array._from_padded(data.contiguous(), (r_len, c_len),
                                 self._mesh)
        out._sparse = self._sparse
        return out

    # -- elementwise -------------------------------------------------------------

    def _coerce(self, other):
        if isinstance(other, Array):
            if other._shape != self._shape \
                    and not _broadcastable(other._shape, self._shape):
                raise ValueError(
                    f"shape mismatch {self._shape} vs {other._shape}")
            return other
        if isinstance(other, Number):
            return other
        return NotImplemented

    def _ew(self, other, op):
        other = self._coerce(other)
        if other is NotImplemented:
            return NotImplemented
        if isinstance(other, Array):
            if other.device != self.device:
                raise ValueError(f"operands live on different devices: "
                                 f"{self.device} vs {other.device}")
            out_shape = _broadcast_shape(self._shape, other._shape)
            if _sharded(self._mesh) or _sharded(other._mesh):
                if other._mesh != self._mesh:
                    raise ValueError("operands live on different meshes")
                # 0/0 and 0**0 would leave the pad non-zero: re-zero it
                data = _BINOPS[op](_spread(self, out_shape),
                                   _spread(other, out_shape))
                return Array(_zero_pad(data, out_shape, _block_geom(
                    out_shape, self._mesh)[:2]), out_shape, self._mesh,
                    self._reg_shape, self._sparse and other._sparse)
            data = _ew_array_body(self._data, other._data, self._shape,
                                  other._shape, op)
            return Array(data, out_shape, self._mesh, self._reg_shape,
                         self._sparse and other._sparse)
        scalar = float(other) if not isinstance(other, bool) else other
        data = _ew_scalar_body(self._local, scalar, self._shape, op,
                               self._at)
        # the ops that map zero to zero keep the sparse flag (exp does not)
        preserves = op != "exp_" and (
            op in ("mul", "div", "pow", "abs_", "sqrt_")
            or float(other) == 0.0)
        return Array(data, self._shape, self._mesh, self._reg_shape,
                     self._sparse and preserves)

    def __add__(self, o):  return self._ew(o, "add")
    def __radd__(self, o): return self._ew(o, "add")
    def __sub__(self, o):  return self._ew(o, "sub")
    def __rsub__(self, o): return self._ew(o, "rsub")
    def __mul__(self, o):  return self._ew(o, "mul")
    def __rmul__(self, o): return self._ew(o, "mul")
    def __truediv__(self, o):  return self._ew(o, "div")
    def __rtruediv__(self, o): return self._ew(o, "rdiv")
    def __pow__(self, o):  return self._ew(o, "pow")
    def __neg__(self):     return self._ew(-1.0, "mul")

    def __abs__(self):
        return self._ew(0.0, "abs_")

    def sqrt(self) -> "Array":
        return self._ew(0.0, "sqrt_")

    def exp(self) -> "Array":
        return self._ew(0.0, "exp_")

    def __matmul__(self, other):
        from dislib_tpu_torch.math.base import matmul
        return matmul(self, other)

    # -- reductions ----------------------------------------------------------------

    def _reduce(self, kind: str, axis=0) -> "Array":
        if axis not in (0, 1, None):
            raise ValueError("axis must be 0, 1 or None")
        if axis is None:
            shape = (1, 1)
        elif axis == 0:
            shape = (1, self._shape[1])
        else:
            shape = (self._shape[0], 1)
        if _sharded(self._mesh):
            return self._reduce_sharded(kind, axis, shape)
        data = _reduce_body(self._data, self._shape, kind, axis)
        return Array._from_logical_padded(_repad(data, shape, self._mesh),
                                          shape, self._mesh)

    def _reduce_sharded(self, kind, axis, shape) -> "Array":
        """The block's masked reduction, then ``psum``/``pmin``/``pmax``
        over the reduced mesh axis; the result lands in the blocks of
        the ranks that hold its logical region."""
        a, at = self._local, self._at
        over = {0: _mesh.ROWS, 1: _mesh.COLS, None: _dist.ALL}[axis]
        red = _reduce_body(a, self._shape, "sum" if kind == "mean" else kind,
                           axis, at, finish=False)
        if kind in ("sum", "norm", "mean"):
            red = _dist.psum(red, over, self._mesh)
        else:
            red = (_dist.pmin if kind == "min" else _dist.pmax)(
                red, over, self._mesh)
        if kind == "mean":
            red = red / (self._shape[axis] if axis is not None
                         else self._shape[0] * self._shape[1])
        if kind == "norm":
            red = torch.sqrt(red)
        out_at = (0, at[1]) if axis == 0 else (at[0], 0) if axis == 1 \
            else (0, 0)
        return Array(_block_with(red, out_at, shape, self._mesh), shape,
                     self._mesh)

    def sum(self, axis=0):  return self._reduce("sum", axis)
    def mean(self, axis=0): return self._reduce("mean", axis)
    def min(self, axis=0):  return self._reduce("min", axis)
    def max(self, axis=0):  return self._reduce("max", axis)

    def norm(self, axis=0):
        return self._reduce("norm", axis)

    # -- iteration over logical blocks -------------------------------------------

    def iterator(self, axis=0):
        """Yield row-block (axis=0) or col-block (axis=1) sub-arrays, one
        per ``block_size`` stripe (reference ``Array.iterator``).  Across
        ranks each stripe is a ds-array on the same mesh: a row stripe is
        a row gather (one ``all_to_all`` over 'rows'), a column stripe
        this rank's rows of those columns."""
        n = self._shape[axis]
        step = self._reg_shape[axis]
        m = self._shape[0]
        for start in range(0, n, step):
            stop = min(start + step, n)
            if axis == 0:
                yield _gather_rows(self, np.arange(start, stop))[0]
            else:
                yield Array._from_rows(
                    self._row_block()[:, start:stop], (m, stop - start),
                    self._mesh, sparse=self._sparse)


def _broadcastable(a, b):
    return all(x == y or x == 1 or y == 1 for x, y in zip(a, b))


def _broadcast_shape(a, b):
    return tuple(max(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# op bodies (the reference's eager kernels)
# ---------------------------------------------------------------------------

_BINOPS = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "rsub": lambda a, b: b - a,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
    "rdiv": lambda a, b: b / a,
    "pow": lambda a, b: a ** b,
    "exp_": lambda a, b: torch.exp(a),
    "abs_": lambda a, b: torch.abs(a),
    "sqrt_": lambda a, b: torch.sqrt(a),
}


def _ew_array_body(a, b, a_shape, b_shape, op):
    """Crop each operand to its logical region, broadcast, and place the
    result on a zero canvas as large as the larger backing — a (1, n)
    operand's padded rows never meet the other operand's rows."""
    out = _BINOPS[op](a[: a_shape[0], : a_shape[1]],
                      b[: b_shape[0], : b_shape[1]])
    return _place_region(out, (max(a.shape[0], b.shape[0]),
                               max(a.shape[1], b.shape[1])))


def _ew_scalar_body(a, scalar, shape, op, at=(0, 0)):
    """The scalar is cast to the array's dtype first, as in the reference;
    the padding is re-zeroed after (``0/0`` and ``x + c`` leave it
    non-zero)."""
    out = _BINOPS[op](a, torch.as_tensor(scalar, dtype=a.dtype,
                                         device=a.device))
    return _zero_pad(out, shape, at)


def _reduce_body(a, shape, kind, axis, at=(0, 0), finish=True):
    """The masked reduction of ``a`` (a block at ``at``).  ``finish=False``
    stops before ``norm``'s square root and ``mean``'s division: the
    caller sums the blocks' partials first."""
    mask = _pad_mask(a.shape, shape, a.device, at)
    if kind in ("sum", "norm", "mean"):
        x = torch.where(mask, a, torch.zeros((), dtype=a.dtype,
                                             device=a.device))
        if kind == "norm":
            x = x * x
        red = x.sum(dim=axis, keepdim=True, dtype=x.dtype) \
            if axis is not None else x.sum(dtype=x.dtype).reshape(1, 1)
        if not finish:
            return red
        if kind == "mean":
            red = red / (shape[axis] if axis is not None
                         else shape[0] * shape[1])
        if kind == "norm":
            red = torch.sqrt(red)
        return red
    # min/max: the pad takes the value that never wins
    if a.dtype.is_floating_point:
        fill = float("inf") if kind == "min" else float("-inf")
    else:
        info = torch.iinfo(a.dtype)
        fill = info.max if kind == "min" else info.min
    x = torch.where(mask, a, torch.full((), fill, dtype=a.dtype,
                                        device=a.device))
    fn = torch.amin if kind == "min" else torch.amax
    return fn(x, dim=axis, keepdim=True) if axis is not None \
        else fn(x).reshape(1, 1)


def _split_key(key):
    if isinstance(key, tuple):
        if len(key) != 2:
            raise IndexError("ds-arrays are 2-D: index with at most two axes")
        return key
    return key, slice(None)


def _normalize_index(idx, dim):
    """Return (index object over the padded array, result length)."""
    if isinstance(idx, (int, np.integer)):
        i = int(idx)
        if i < 0:
            i += dim
        if not 0 <= i < dim:
            raise IndexError(f"index {idx} out of bounds for dim {dim}")
        return slice(i, i + 1), 1
    if isinstance(idx, slice):
        start, stop, step = idx.indices(dim)
        if step <= 0:
            raise IndexError("negative slice steps not supported")
        length = max(0, -(-(stop - start) // step))
        return slice(start, stop, step), length
    arr = np.asarray(idx)
    if arr.dtype == bool:
        if arr.shape[0] != dim:
            raise IndexError("boolean index length mismatch")
        arr = np.nonzero(arr)[0]
    if arr.size and not np.issubdtype(arr.dtype, np.integer):
        # silent float->int truncation would index the wrong rows; an empty
        # selection (np.asarray([]) is float64) stays valid, as in NumPy
        raise IndexError(f"fancy index must be integer or boolean, got "
                         f"dtype {arr.dtype}")
    arr = arr.astype(np.int64)
    arr = np.where(arr < 0, arr + dim, arr)
    if arr.size and (arr.min() < 0 or arr.max() >= dim):
        raise IndexError("fancy index out of bounds")
    return arr, int(arr.shape[0])


# ---------------------------------------------------------------------------
# public constructors
# ---------------------------------------------------------------------------

def _mesh_for(device):
    """The default mesh, or a one-rank mesh on an explicitly requested
    device (``device="cpu"`` runs the plain versions), in any job."""
    return _mesh.get_mesh() if device is None else _mesh.local_mesh(device)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


def array(x, block_size=None, dtype=None, device=None) -> Array:
    """Build a ds-array from host data (ndarray, nested lists) or a torch
    tensor.

    ``dtype=None`` keeps the float32 default but WARNS when that narrows
    float64 input; an explicit ``dtype=`` is honoured (float64 included).
    ``device=None`` places the array on the default mesh's device —
    ``cuda``, which raises without a card; ``device="cpu"`` asks for the
    CPU.  A scipy sparse matrix is densified, as the reference does
    (``SparseArray.from_scipy`` keeps it sparse)."""
    import scipy.sparse as sp
    sparse = sp.issparse(x)
    if sparse:
        x = x.toarray()
    mesh = _mesh_for(device)
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        if x.dtype == np.float64 and dtype is None:
            _warn_f64_narrowing()
            x = x.astype(np.float32)
        x = torch.from_numpy(np.ascontiguousarray(x))
    elif x.dtype == torch.float64 and dtype is None:
        _warn_f64_narrowing()
        x = x.to(torch.float32)
    if dtype is not None:
        x = x.to(_torch_dtype(dtype))
    if x.dim() == 1:
        x = x.reshape(1, -1)
    if x.dim() != 2:
        raise ValueError("ds-arrays are 2-dimensional")
    if block_size is None:
        block_size = _default_block_size(tuple(x.shape), mesh)
    block_size = _check_block_size(tuple(x.shape), block_size)
    out = Array._from_logical(x, mesh, reg_shape=block_size)
    out._sparse = sparse
    return out


def _warn_f64_narrowing():
    warnings.warn(
        "ds.array received float64 data and is narrowing it to float32 "
        "(the library default). Pass dtype=np.float32 to silence, or "
        "dtype=np.float64 to keep full precision.",
        UserWarning, stacklevel=3)


def _check_block_size(shape, block_size):
    """Validate and return the effective block size: oversized blocks
    clamp to the logical shape."""
    br, bc = block_size
    if br <= 0 or bc <= 0:
        raise ValueError("block_size entries must be positive")
    return (min(br, shape[0]) if shape[0] > 0 else br,
            min(bc, shape[1]) if shape[1] > 0 else bc)


def zeros(shape, block_size=None, dtype=torch.float32, device=None) -> Array:
    """All-zeros ds-array."""
    mesh = _mesh_for(device)
    shape = (int(shape[0]), int(shape[1]))
    pshape = _local_pshape(shape, mesh)
    data = torch.zeros(pshape, dtype=_torch_dtype(dtype), device=mesh.device)
    return Array(data, shape, mesh, reg_shape=block_size)


def _local_pshape(shape, mesh):
    """The shape of this rank's block (the padded shape on one rank)."""
    return _block_geom(shape, mesh)[2:]


def random_array(shape, block_size=None, random_state=None,
                 dtype=torch.float32, device=None) -> Array:
    """Uniform [0, 1) ds-array, deterministic per seed (seeded for the
    whole array, as in the reference): its logical values do not depend
    on the mesh; on a mesh of several ranks each rank draws the whole
    array and keeps its block."""
    mesh = _mesh_for(device)
    shape = (int(shape[0]), int(shape[1]))
    pshape = _padded_shape(shape, _mesh.pad_quantum(mesh))
    data = _random_uniform(_seed_from(_dist.agreed_seed(random_state, mesh)),
                           pshape, shape,
                           _torch_dtype(dtype), mesh.device)
    if _sharded(mesh):
        data = _block_with(data, (0, 0), shape, mesh)
    return Array(data, shape, mesh, reg_shape=block_size)


def _random_uniform(seed, pshape, shape, dtype, device) -> torch.Tensor:
    """The ds-array's one uniform draw, at the logical ``shape``, placed on
    a zero canvas of ``pshape``.  It draws from a ``torch.Generator``
    seeded with ``seed``: the same seed gives the same array in this
    package, not the reference's (threefry) draw."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    vals = torch.rand(shape, generator=g, dtype=dtype, device=device)
    return _place_region(vals, pshape)


def _seed_from(random_state):
    if random_state is None:
        return np.random.randint(0, 2**31 - 1)
    if isinstance(random_state, (int, np.integer)):
        return int(random_state)
    if isinstance(random_state, np.random.RandomState):
        return int(random_state.randint(0, 2**31 - 1))
    raise TypeError(f"bad random_state: {random_state!r}")


def full(shape, fill_value, block_size=None, dtype=torch.float32,
         device=None) -> Array:
    """Constant-filled ds-array."""
    mesh = _mesh_for(device)
    shape = (int(shape[0]), int(shape[1]))
    data = torch.full(_local_pshape(shape, mesh), float(fill_value),
                      dtype=_torch_dtype(dtype), device=mesh.device)
    return Array(_zero_pad(data, shape, _block_geom(shape, mesh)[:2]), shape,
                 mesh, reg_shape=block_size)


def ones(shape, block_size=None, dtype=torch.float32, device=None) -> Array:
    """All-ones ds-array."""
    return full(shape, 1.0, block_size, dtype, device)


def identity(n, block_size=None, dtype=torch.float32, device=None) -> Array:
    """n×n identity ds-array."""
    return eye(n, n, block_size, dtype, device)


def eye(n, m=None, block_size=None, dtype=torch.float32,
        device=None) -> Array:
    """n×m ds-array with ones on the main diagonal."""
    m = n if m is None else m
    mesh = _mesh_for(device)
    shape = (int(n), int(m))
    r0, c0, ml, nl = _block_geom(shape, mesh)
    data = torch.zeros((ml, nl), dtype=_torch_dtype(dtype),
                       device=mesh.device)
    # the diagonal entries that fall in this rank's block: none when the
    # block misses the diagonal (or holds only padding)
    lo, hi = max(r0, c0), min(r0 + ml, c0 + nl, min(shape))
    if lo < hi:
        diag = torch.arange(lo, hi, device=mesh.device)
        data[diag - r0, diag - c0] = 1
    return Array(data, shape, mesh, reg_shape=block_size)


def rechunk(x: Array, new_blocks=None, mesh=None, *, schedule="auto",
            panels=None, overlap=None, nse=None) -> Array:
    """Re-lay a ds-array out for a new block-size hint and/or mesh, on one
    rank.

    ``mesh=None`` is the library default mesh.  Under ``schedule="auto"``
    a backing already on the target's device at its pad quantum is shared
    (the hint is metadata); otherwise, and always under ``"xla"``, the
    backing is re-quantized (:func:`ops.rechunk.requantize_body`), which
    re-zeroes whatever its pad held; ``"deviceput"`` is the same move
    across devices.  The multi-rank ``"panels"`` and ``"dcn"`` schedules
    (and so ``panels`` and ``overlap``, their knobs) are ROADMAP.md A.11;
    ``nse`` re-pads a sparse array's stored entries and, as in the
    reference, is not read for a dense one.  A ``SparseArray`` goes to its
    ``resharded``, the on-device sparse reshard, which is A.11."""
    from dislib_tpu_torch.ops.rechunk import requantize_body
    from dislib_tpu_torch.data.sparse import SparseArray
    if isinstance(x, SparseArray):
        return x.resharded(mesh, schedule=schedule, nse=nse, overlap=overlap)
    if not isinstance(x, Array):
        raise TypeError(f"rechunk needs a ds-array, got {type(x).__name__}")
    if schedule in ("panels", "dcn"):
        raise NotImplementedError(
            f"schedule={schedule!r} is a multi-rank exchange (ROADMAP.md "
            "A.11); one rank re-quantizes with 'auto'/'xla'")
    if schedule not in ("auto", "xla", "deviceput"):
        raise ValueError(f"unknown rechunk schedule {schedule!r}: expected "
                         "'auto', 'xla', 'panels', 'dcn' or 'deviceput'")
    del panels, overlap, nse
    reg = _check_block_size(x._shape, new_blocks) if new_blocks is not None \
        else x._reg_shape
    target = mesh if mesh is not None else _mesh.get_mesh()
    if _sharded(x._mesh) or _sharded(target):
        if target is x._mesh and schedule == "auto":
            return Array(x._local, x._shape, target, reg, x._sparse)
        raise _guard("a re-layout")
    out_pshape = _padded_shape(x._shape, _mesh.pad_quantum(target))
    data = x._data
    if schedule == "auto" and data.device == target.device \
            and tuple(data.shape) == out_pshape:
        return Array(data, x._shape, target, reg)
    data = requantize_body(data.to(target.device), x._shape, out_pshape)
    return Array(data, x._shape, target, reg)


def ensure_canonical(x: Array) -> Array:
    """``x`` unchanged when its backing is on the default mesh's device at
    its pad quantum; otherwise :func:`rechunk` onto that mesh."""
    mesh = _mesh.get_mesh()
    if x._mesh is mesh and _sharded(mesh):
        return x
    pshape = _padded_shape(x._shape, _mesh.pad_quantum(mesh))
    if tuple(x._data.shape) == pshape and x.device == mesh.device:
        return x
    return rechunk(x)


def apply_along_axis(func, axis, x: Array, *args, **kwargs) -> Array:
    """Apply ``func`` to the 1-D slices of ``x`` along ``axis``, as
    ``np.apply_along_axis`` does (reference:
    ``dislib_tpu.data.array.apply_along_axis``).

    Two tiers, fastest first: a ``func`` of torch operations runs on the
    device, vectorised over the slices with ``torch.func.vmap``; any other
    ``func`` (one ``vmap`` cannot trace) runs ``np.apply_along_axis`` on the
    host and WARNS, since the device→host→device round trip is far
    slower.  A 1-D result becomes a row (axis 0) or a column (axis 1).

    Across ranks each rank applies ``func`` to the slices it holds whole
    and keeps its block of the result: along axis 1 its rows (its block
    all-gathered over 'cols', none on a one-column mesh), along axis 0 its
    columns (its block all-gathered over 'rows').  A slice of padding
    gives a result the block's pad then drops."""
    if axis not in (0, 1):
        raise ValueError("axis must be 0 or 1")
    m, n = x._shape
    mesh = x._mesh
    if axis == 1:
        rows = x._row_block()[:, :n]
        out = _apply_slices(func, 1, rows, args, kwargs)
        return Array._from_rows(out, (m, out.shape[1]), mesh)
    cols = _dist.all_gather(x._local, _mesh.ROWS, 0, mesh)[:m]
    out = _apply_slices(func, 0, cols, args, kwargs)
    shape = (out.shape[0], n)
    return Array(_block_with(out, (0, x._at[1]), shape, mesh), shape, mesh)


def _apply_slices(func, axis, logical, args, kwargs) -> torch.Tensor:
    """``func`` over the 1-D slices of the 2-D ``logical`` along ``axis``
    (vmap, else the host tier with a warning), as a 2-D result."""
    try:
        out = torch.func.vmap(lambda v: func(v, *args, **kwargs),
                              in_dims=1 - axis)(logical)
        if not isinstance(out, torch.Tensor):
            raise TypeError(f"func returned {type(out).__name__}, not a "
                            "tensor")
        if out.dim() == 2 and axis == 0:
            out = out.T                 # the slice results run down axis 0
    except Exception as e:  # noqa: BLE001 — any trace failure → host tier
        warnings.warn(
            f"apply_along_axis: {getattr(func, '__name__', func)!r} does "
            f"not run under torch.func.vmap ({type(e).__name__}: {e}); "
            "falling back to host NumPy (device->host->device round trip, "
            "far slower)", UserWarning, stacklevel=3)
        host = logical.to(torch.float32) if logical.dtype == torch.bfloat16 \
            else logical
        out = torch.as_tensor(np.apply_along_axis(
            func, axis, host.cpu().numpy(), *args, **kwargs)).to(
                logical.device)
    if out.dim() == 1:
        out = out.reshape(1, -1) if axis == 0 else out.reshape(-1, 1)
    if out.dim() != 2:
        raise ValueError(f"apply_along_axis: func produced a {out.dim()}-D "
                         "result; ds-arrays are 2-D")
    return out


def concat_rows(arrays) -> Array:
    """Stack ds-arrays vertically (logical concatenation).  Across ranks
    each input's rows go to their ranks in the result by the shuffle's
    routing plan (one ``all_to_all`` over 'rows' an input)."""
    arrays = list(arrays)
    if not arrays:
        raise ValueError("concat_rows needs at least one array")
    cols = {a.shape[1] for a in arrays}
    if len(cols) > 1:
        raise ValueError(f"concat_rows: column counts differ: {sorted(cols)}")
    mesh = arrays[0]._mesh
    if any(a._mesh != mesh for a in arrays):
        raise ValueError("concat_rows: arrays live on different meshes")
    shape = (sum(a.shape[0] for a in arrays), arrays[0].shape[1])
    dt = arrays[0].dtype
    for a in arrays[1:]:
        dt = torch.promote_types(dt, a.dtype)
    out = torch.zeros((_block_geom(shape, mesh)[2] + 1,
                       arrays[0]._local.shape[1]), dtype=dt,
                      device=mesh.device)
    off = 0
    for a in arrays:
        rows = np.arange(a.shape[0])
        _gather_rows(a, rows, dst=off + rows, out_shape=shape, out=out)
        off += a.shape[0]
    return Array(out[:-1], shape, mesh, reg_shape=arrays[0]._reg_shape)


def concat_cols(arrays) -> Array:
    """Concatenate ds-arrays along columns.  Across ranks the inputs'
    row blocks line up (one height), so each rank joins its rows (each
    block all-gathered over 'cols' first, none on a one-column mesh)."""
    arrays = list(arrays)
    if not arrays:
        raise ValueError("concat_cols needs at least one array")
    rows = {a.shape[0] for a in arrays}
    if len(rows) > 1:
        raise ValueError(f"concat_cols: row counts differ: {sorted(rows)}")
    mesh = arrays[0]._mesh
    if any(a._mesh != mesh for a in arrays):
        raise ValueError("concat_cols: arrays live on different meshes")
    out = torch.cat([a._row_block()[:, : a._shape[1]] for a in arrays], dim=1)
    return Array._from_rows(out, (arrays[0].shape[0], out.shape[1]), mesh,
                            reg_shape=arrays[0]._reg_shape)
