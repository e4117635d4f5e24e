"""The distributed array (ds-array) — the port's single data structure.

Counterpart of ``dislib_tpu/data/array.py``, eager half.  The whole matrix
is ONE torch tensor on the mesh's device.  The reference's irregular blocks
become pad-and-mask metadata: ``_data`` is padded so every dimension is a
multiple of the mesh pad quantum, and the region outside the logical
``shape`` is ALWAYS ZERO, which keeps contractions exact with no masking;
``min``/``max`` mask the pad and ``mean`` divides by the logical count.
On this slice's ``(1, 1)`` mesh the quantum is 1, so nothing is padded, but
the invariant is kept so the multi-GPU slice changes no caller.
``block_size`` survives as a hint (``_reg_shape``) for API parity.

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


def _zero_pad(data: torch.Tensor, logical_shape) -> torch.Tensor:
    """Force the padding region to zero (the core Array invariant)."""
    if tuple(data.shape) == tuple(logical_shape):
        return data
    out = data.clone()
    out[logical_shape[0]:, :] = 0
    out[:, logical_shape[1]:] = 0
    return out


def _place(data: torch.Tensor, padded_shape, logical_shape) -> torch.Tensor:
    """Pad ``data`` (logical region) up to ``padded_shape`` with zeros."""
    out = torch.zeros(padded_shape, dtype=data.dtype, device=data.device)
    out[:logical_shape[0], :logical_shape[1]] = \
        data[:logical_shape[0], :logical_shape[1]]
    return out


def _pad_mask(padded_shape, logical_shape, device) -> torch.Tensor:
    """Boolean mask: True inside the logical region."""
    r = torch.arange(padded_shape[0], device=device) < logical_shape[0]
    c = torch.arange(padded_shape[1], device=device) < logical_shape[1]
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


def _default_block_size(shape, mesh):
    r, c = _mesh.mesh_shape(mesh)
    return (max(1, -(-shape[0] // r)), max(1, -(-shape[1] // c)))


class Array:
    """A 2-D matrix on the device mesh.

    Users build Arrays with :func:`array` or :func:`zeros`, or as results
    of library operations.  ``data`` is the padded backing (zero outside
    the logical ``shape``); ``mesh`` is the mesh it lives on.
    """

    def __init__(self, data: torch.Tensor, shape, mesh, reg_shape=None,
                 sparse=False):
        self._data = data
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

    # -- metadata ------------------------------------------------------------

    @property
    def shape(self) -> tuple[int, int]:
        return self._shape

    @property
    def dtype(self) -> torch.dtype:
        return self._data.dtype

    @property
    def device(self) -> torch.device:
        return self._data.device

    @property
    def _pshape(self) -> tuple[int, int]:
        return tuple(self._data.shape)

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
        if self._data.device.type == "cuda":
            torch.cuda.current_stream(self._data.device).synchronize()
        return self

    def collect(self) -> np.ndarray:
        """Materialise the logical region on the host as a NumPy array."""
        out = self._data[: self._shape[0], : self._shape[1]]
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
        return float(self._data[0, 0].item())

    # -- layout ----------------------------------------------------------------

    def rechunk(self, block_size) -> "Array":
        """Change the block-size hint (see :func:`rechunk`)."""
        return rechunk(self, block_size)

    def astype(self, dtype) -> "Array":
        return Array(self._data.to(_torch_dtype(dtype)), self._shape,
                     self._mesh, self._reg_shape, self._sparse)

    def copy(self) -> "Array":
        return Array(self._data.clone(), self._shape, self._mesh,
                     self._reg_shape, self._sparse)

    def transpose(self) -> "Array":
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
            data = _ew_array_body(self._data, other._data, self._shape,
                                  other._shape, op)
            return Array(data, out_shape, self._mesh, self._reg_shape,
                         self._sparse and other._sparse)
        scalar = float(other) if not isinstance(other, bool) else other
        data = _ew_scalar_body(self._data, scalar, self._shape, op)
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
        data = _reduce_body(self._data, self._shape, kind, axis)
        return Array._from_logical_padded(_repad(data, shape, self._mesh),
                                          shape, self._mesh)

    def sum(self, axis=0):  return self._reduce("sum", axis)
    def mean(self, axis=0): return self._reduce("mean", axis)
    def min(self, axis=0):  return self._reduce("min", axis)
    def max(self, axis=0):  return self._reduce("max", axis)

    def norm(self, axis=0):
        return self._reduce("norm", axis)

    # -- iteration over logical blocks -------------------------------------------

    def iterator(self, axis=0):
        """Yield row-block (axis=0) or col-block (axis=1) sub-arrays, one
        per ``block_size`` stripe (reference ``Array.iterator``)."""
        n = self._shape[axis]
        step = self._reg_shape[axis]
        m, c = self._shape
        for start in range(0, n, step):
            stop = min(start + step, n)
            if axis == 0:
                logical = self._data[start:stop, :c]
                shape = (stop - start, c)
            else:
                logical = self._data[:m, start:stop]
                shape = (m, stop - start)
            yield Array._from_logical_padded(
                _repad(logical, shape, self._mesh), shape, self._mesh,
                sparse=self._sparse)


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


def _ew_scalar_body(a, scalar, shape, op):
    """The scalar is cast to the array's dtype first, as in the reference;
    the padding is re-zeroed after (``0/0`` and ``x + c`` leave it
    non-zero)."""
    out = _BINOPS[op](a, torch.as_tensor(scalar, dtype=a.dtype,
                                         device=a.device))
    return _zero_pad(out, shape)


def _reduce_body(a, shape, kind, axis):
    mask = _pad_mask(a.shape, shape, a.device)
    if kind in ("sum", "norm", "mean"):
        x = torch.where(mask, a, torch.zeros((), dtype=a.dtype,
                                             device=a.device))
        if kind == "norm":
            x = x * x
        red = x.sum(dim=axis, keepdim=True, dtype=x.dtype) \
            if axis is not None else x.sum(dtype=x.dtype).reshape(1, 1)
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
    """The default mesh, or a one-device mesh on an explicitly requested
    device (``device="cpu"`` runs the plain versions)."""
    return _mesh.get_mesh() if device is None else _mesh.make_mesh(
        (1, 1), device)


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
    pshape = _padded_shape(shape, _mesh.pad_quantum(mesh))
    data = torch.zeros(pshape, dtype=_torch_dtype(dtype), device=mesh.device)
    return Array(data, shape, mesh, reg_shape=block_size)


def random_array(shape, block_size=None, random_state=None,
                 dtype=torch.float32, device=None) -> Array:
    """Uniform [0, 1) ds-array, deterministic per seed (seeded for the
    whole array, as in the reference)."""
    mesh = _mesh_for(device)
    shape = (int(shape[0]), int(shape[1]))
    pshape = _padded_shape(shape, _mesh.pad_quantum(mesh))
    data = _random_uniform(_seed_from(random_state), pshape, shape,
                           _torch_dtype(dtype), mesh.device)
    return Array(data, shape, mesh, reg_shape=block_size)


def _random_uniform(seed, pshape, shape, dtype, device) -> torch.Tensor:
    """The ds-array's one uniform draw.  It draws from a
    ``torch.Generator`` seeded with ``seed``: the same seed gives the same
    array in this package, not the reference's (threefry) draw."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    vals = torch.rand(pshape, generator=g, dtype=dtype, device=device)
    return _zero_pad(vals, shape)


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
    pshape = _padded_shape(shape, _mesh.pad_quantum(mesh))
    data = torch.full(pshape, float(fill_value), dtype=_torch_dtype(dtype),
                      device=mesh.device)
    return Array(_zero_pad(data, shape), shape, mesh, reg_shape=block_size)


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
    pshape = _padded_shape(shape, _mesh.pad_quantum(mesh))
    data = torch.zeros(pshape, dtype=_torch_dtype(dtype), device=mesh.device)
    diag = torch.arange(min(shape), device=mesh.device)
    data[diag, diag] = 1
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
    slower.  A 1-D result becomes a row (axis 0) or a column (axis 1)."""
    if axis not in (0, 1):
        raise ValueError("axis must be 0 or 1")
    logical = x._data[: x._shape[0], : x._shape[1]]
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
            "far slower)", UserWarning, stacklevel=2)
        host = logical.to(torch.float32) if logical.dtype == torch.bfloat16 \
            else logical
        out = torch.as_tensor(np.apply_along_axis(
            func, axis, host.cpu().numpy(), *args, **kwargs))
    if out.dim() == 1:
        out = out.reshape(1, -1) if axis == 0 else out.reshape(-1, 1)
    if out.dim() != 2:
        raise ValueError(f"apply_along_axis: func produced a {out.dim()}-D "
                         "result; ds-arrays are 2-D")
    return Array._from_logical(out.contiguous(), x._mesh)


def concat_rows(arrays) -> Array:
    """Stack ds-arrays vertically (logical concatenation)."""
    arrays = list(arrays)
    if not arrays:
        raise ValueError("concat_rows needs at least one array")
    cols = {a.shape[1] for a in arrays}
    if len(cols) > 1:
        raise ValueError(f"concat_rows: column counts differ: {sorted(cols)}")
    out = torch.cat([a._data[: a._shape[0], : a._shape[1]] for a in arrays],
                    dim=0)
    return Array._from_logical(out, arrays[0]._mesh,
                               reg_shape=arrays[0]._reg_shape)


def concat_cols(arrays) -> Array:
    """Concatenate ds-arrays along columns."""
    arrays = list(arrays)
    if not arrays:
        raise ValueError("concat_cols needs at least one array")
    rows = {a.shape[0] for a in arrays}
    if len(rows) > 1:
        raise ValueError(f"concat_cols: row counts differ: {sorted(rows)}")
    out = torch.cat([a._data[: a._shape[0], : a._shape[1]] for a in arrays],
                    dim=1)
    return Array._from_logical(out, arrays[0]._mesh,
                               reg_shape=arrays[0]._reg_shape)
