"""Streamed ε-neighbourhood passes.

Counterpart of ``dislib_tpu/ops/tiled.py``.  DBSCAN and Daura need per-row
reductions over the ε-adjacency relation of the whole dataset.  For each
row i::

    count_i = |{ j : adj(i,j) ∧ colmask_j }|
    min_i   = min{ vals_j : adj(i,j) ∧ colmask_j }      (sentinel if empty)

where adj(i,j) = (‖x_i − x_j‖² ≤ eps2) ∨ (i = j): the structural diagonal
keeps every point its own neighbour whatever the rounding.

The reference scans (tile × tile) pieces inside one XLA program.  Done the
same way from Python that is ⌈m / tile⌉² blocks of a handful of launches
each (9,604 blocks a pass at 200,000 rows), and the pass is host-bound.
The port takes a row tile of ``tile`` rows against column chunks as wide
as :data:`BLOCK_BYTES` of distances allow (all 200,000 columns at the
default sizes): ⌈m / tile⌉ distance launches a pass.  The counts and mins
are exact integer reductions, so the blocking does not change them.

Each block is ``ops/kernels.distances_sq(columns, rows)``: on CUDA tensors
the hand kernel (or a raise), on CPU tensors its plain version.  The block
is laid out (columns, rows) — the transposed block — because the kernel
streams the rows of its first operand: the wide column chunk keeps every
SM busy, where a (tile, all) block would give the kernel ``tile`` rows to
stream.  ‖x_j‖² − 2x_j·x_i + ‖x_i‖² rounds like the reference's
‖x_i‖² − 2x_i·x_j + ‖x_j‖² up to the order of two additions, so a pair
within rounding of eps2 may fall the other way.  :func:`pad_cols` gives
the kernel rows of a multiple of 16 bytes (its bulk-copy stream) in one
copy per fit.
"""

from __future__ import annotations

import torch

from dislib_tpu_torch.ops import kernels as _k

# rows of a tile of the streamed passes (module-level so tests can shrink
# it, as the reference's tests shrink its TILE)
TILE = 2048

#: bytes of float32 distances one block may hold: a row tile meets column
#: chunks of at most BLOCK_BYTES / (4 · tile) columns (module-level so
#: tests can force several chunks)
BLOCK_BYTES = 1 << 31


def pad_to_tiles(xv: torch.Tensor, tile: int):
    """Zero-pad rows to a tile multiple; returns (padded, n_tiles)."""
    n_tiles = -(-xv.shape[0] // tile)
    pad = n_tiles * tile - xv.shape[0]
    if pad:
        xv = torch.nn.functional.pad(xv, (0, 0, 0, pad))
    return xv, n_tiles


def pad_cols(xv: torch.Tensor) -> torch.Tensor:
    """``xv`` as one contiguous float32 tensor whose rows are a multiple
    of 16 bytes on a card: zero columns up to a multiple of 4.  Zero
    columns change neither a norm nor a cross term.  CPU tensors are only
    made contiguous (their plain version needs no alignment)."""
    xv = xv.to(torch.float32)
    d = xv.shape[1]
    if xv.device.type != "cuda" or d % 4 == 0:
        return xv.contiguous()
    out = torch.zeros((xv.shape[0], -(-d // 4) * 4), dtype=torch.float32,
                      device=xv.device)
    out[:, :d] = xv
    return out


def neigh_count_min(xv, eps2, vals, colmask, sentinel, tile, counts=True,
                    mins=True):
    """Per-row (count int32 (mp,), min (mp,) of ``vals.dtype``) over the
    ε-adjacency of the rows of ``xv`` (mp, n) against themselves.

    ``vals``/``colmask``: (mp,).  Rows are NOT masked — callers mask
    invalid rows in their own domain.  ``mp`` need not be a multiple of
    ``tile`` (the last tile is ragged).  ``counts=False`` or
    ``mins=False`` skips a reduction the caller does not read and
    returns None in its place."""
    return neigh_count_min_pair(xv, 0, xv, 0, eps2, vals, colmask, sentinel,
                                tile, counts=counts, mins=mins)


def neigh_count_min_pair(xr, row0, xc, col0, eps2, vals, colmask, sentinel,
                         tile, counts=True, mins=True, acc=None):
    """The home rows ``xr`` (mr, n) against a visiting block ``xc`` (mc,
    n): per home row (count int32 (mr,), min (mr,) of ``vals.dtype``) over
    the ε-adjacency to the visiting rows, ``vals``/``colmask`` (mc,) the
    visiting rows'.  The rows carry their global ids as the offsets
    ``row0`` and ``col0`` (home row i is global row ``row0 + i``, visiting
    row j ``col0 + j``), so the structural diagonal is where the ids are
    equal — the reference ring's ``pair_pass``.  ``acc``: a running
    (count, min) to fold into (updated in place), else zeros and the
    sentinel.  Each (column chunk, row tile) piece is one
    ``distances_sq`` launch."""
    mr, mc = xr.shape[0], xc.shape[0]
    dev = xr.device
    xr, xc = xr.contiguous(), xc.contiguous()
    colmask = colmask.to(torch.bool)
    sent = torch.tensor(sentinel, dtype=vals.dtype, device=dev)
    if acc is None:
        cnt = torch.zeros(mr, dtype=torch.int32, device=dev) \
            if counts else None
        mn = torch.full((mr,), sentinel, dtype=vals.dtype, device=dev) \
            if mins else None
    else:
        cnt, mn = acc
    # a masked column can never give the min: fold the mask into vals
    vmask = torch.where(colmask, vals, sent) if mins else None
    chunk = max(1, int(BLOCK_BYTES) // (4 * tile))
    for r0 in range(0, mr, tile):
        r1 = min(r0 + tile, mr)
        rows = xr[r0:r1]
        for c0 in range(0, mc, chunk):
            c1 = min(c0 + chunk, mc)
            adj = _k.distances_sq(xc[c0:c1], rows) <= eps2   # (cols, rows)
            # the structural diagonal: global ids equal
            lo = max(row0 + r0, col0 + c0)
            hi = min(row0 + r1, col0 + c1)
            if lo < hi:
                g = torch.arange(lo, hi, device=dev)
                adj[g - col0 - c0, g - row0 - r0] = True
            if counts:
                cnt[r0:r1] += (adj & colmask[c0:c1, None]).sum(
                    0, dtype=torch.int32)
            if mins:
                blk = torch.where(adj, vmask[c0:c1, None], sent).amin(0)
                torch.minimum(mn[r0:r1], blk, out=mn[r0:r1])
            del adj
    return cnt, mn
