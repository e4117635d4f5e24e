"""The distributed array (ds-array) — the port's single data structure.

Counterpart of ``dislib_tpu/data/array.py`` (core, eager).  The whole matrix
is ONE torch tensor on the mesh's device.  The reference's irregular blocks
become pad-and-mask metadata: ``_data`` is padded so every dimension is a
multiple of the mesh pad quantum, and the region outside the logical
``shape`` is ALWAYS ZERO, which keeps contractions exact with no masking.
On this slice's ``(1, 1)`` mesh the quantum is 1, so nothing is padded, but
the invariant is kept so the multi-GPU slice changes no caller.
``block_size`` survives as a hint (``_reg_shape``) for API parity.

Not ported yet (ROADMAP.md A.4): the lazy fusion graph (``_LazyExpr``,
``fused_kernel``), elementwise ops and reductions, slicing with steps into
the fusion graph, ``random_array``/``full``/``ones``/``identity``/``eye``,
``concat_rows``/``concat_cols``, ``apply_along_axis``, ``rechunk`` and
sparse backings.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from dislib_tpu_torch.parallel import mesh as _mesh

__all__ = ["Array", "array", "zeros"]


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

    def __init__(self, data: torch.Tensor, shape, mesh, reg_shape=None):
        self._data = data
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

    # -- sync point ------------------------------------------------------------

    def collect(self) -> np.ndarray:
        """Materialise the logical region on the host as a NumPy array."""
        out = self._data[: self._shape[0], : self._shape[1]]
        if out.dtype == torch.bfloat16:       # numpy has no bfloat16
            out = out.to(torch.float32)
        return out.cpu().numpy()

    # -- layout ----------------------------------------------------------------

    def transpose(self) -> "Array":
        shape = (self._shape[1], self._shape[0])
        reg = (self._reg_shape[1], self._reg_shape[0])
        return Array(self._data.T.contiguous(), shape, self._mesh, reg)

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
        return Array._from_padded(data.contiguous(), (r_len, c_len),
                                  self._mesh)


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
    CPU.  Scipy sparse input is not ported yet (ROADMAP.md A.10)."""
    import scipy.sparse as sp
    if sp.issparse(x):
        raise NotImplementedError(
            "sparse ds-arrays are not ported yet (ROADMAP.md A.10)")
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
    return Array._from_logical(x, mesh, reg_shape=block_size)


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
