"""Padded batch buckets — the fixed shape ladder the served programs are
captured for.

Counterpart of ``dislib_tpu/serving/buckets.py`` (host code, kept as a
copy of its own).  The reference compiles one XLA program per bucket; the
port captures one CUDA graph per bucket, and a graph replays only at the
shapes it was captured at.  The ladder quantizes every request batch up
to a handful of row counts, so the whole serving lifetime touches
``len(ladder)`` shapes — all captured at warmup, none on the request
path.

Pad correctness: predict is row-independent for every served estimator,
and the staging buffer is zero-filled, so a padded row is a zero-row
prediction that the response slicing drops.
"""

from __future__ import annotations

import os

import numpy as np

DEFAULT_BUCKETS = (1, 8, 64, 512)


class BucketLadderError(ValueError):
    """``DSLIB_SERVE_BUCKETS`` failed validation at parse time: a token
    is not an integer, a bucket is non-positive, or the ladder is not
    strictly increasing (duplicates included).  Typed so a deployment
    with a mistyped variable fails at startup with the offending value in
    the message."""


def _ladder_from_env(env: str):
    """Strict parse of ``DSLIB_SERVE_BUCKETS``: a comma-separated,
    strictly increasing list of positive row counts.  Unlike a
    programmatic ``buckets=`` argument (normalised by
    :func:`bucket_ladder`), a variable is deployment configuration, so
    any deviation raises :class:`BucketLadderError` naming the value."""
    ladder = []
    for tok in env.split(","):
        tok = tok.strip()
        if not tok:
            continue
        try:
            b = int(tok)
        except ValueError:
            raise BucketLadderError(
                f"DSLIB_SERVE_BUCKETS={env!r}: {tok!r} is not an integer "
                "row count") from None
        if b < 1:
            raise BucketLadderError(
                f"DSLIB_SERVE_BUCKETS={env!r}: bucket {b} is not positive")
        if ladder and b <= ladder[-1]:
            raise BucketLadderError(
                f"DSLIB_SERVE_BUCKETS={env!r}: ladder must be strictly "
                f"increasing ({b} after {ladder[-1]} — duplicates count)")
        ladder.append(b)
    if not ladder:
        raise BucketLadderError(
            f"DSLIB_SERVE_BUCKETS={env!r}: no buckets parsed")
    return tuple(ladder)


def bucket_ladder(buckets=None):
    """Normalised, ascending bucket ladder.  ``None`` reads
    ``DSLIB_SERVE_BUCKETS`` (validated strictly, see
    :class:`BucketLadderError`) and falls back to
    :data:`DEFAULT_BUCKETS`."""
    if buckets is None:
        env = os.environ.get("DSLIB_SERVE_BUCKETS", "")
        if env.strip():
            return _ladder_from_env(env)
        buckets = DEFAULT_BUCKETS
    ladder = tuple(sorted({int(b) for b in buckets}))
    if not ladder or ladder[0] < 1:
        raise ValueError(f"bucket ladder must be positive row counts, got "
                         f"{buckets!r}")
    return ladder


def bucket_for(n_rows: int, ladder) -> int | None:
    """Smallest bucket covering ``n_rows``, or None when it exceeds the
    largest bucket (the caller splits with :func:`split_rows`)."""
    for b in ladder:
        if n_rows <= b:
            return b
    return None


def split_rows(n_rows: int, ladder):
    """Chunk an oversize request into full largest-bucket pieces plus one
    remainder piece — e.g. 1100 rows on (1, 8, 64, 512) serve as pieces
    of 512 + 512 + 76, the last padded into its covering 512 bucket.
    Each piece costs one dispatch."""
    top = ladder[-1]
    sizes = []
    left = int(n_rows)
    while left > top:
        sizes.append(top)
        left -= top
    if left:
        sizes.append(left)
    return sizes


class BucketTemplate:
    """Preallocated zeroed host staging buffer for one bucket's padded
    shape.  ``fill`` writes the request rows and re-zeroes only the rows
    the previous batch dirtied (high-water tracking), so the hot path
    never re-allocates or re-zeroes the whole canvas.

    ``pinned=True`` (the served path on ``cuda``) puts the buffer in
    page-locked host memory: ``tensor`` is that memory as a torch tensor,
    and its copy to the card is asynchronous."""

    def __init__(self, pshape, dtype=np.float32, pinned=False):
        self.pshape = tuple(int(s) for s in pshape)
        self.buf = np.zeros(self.pshape, dtype)
        self.tensor = None
        if pinned:
            import torch
            self.tensor = torch.from_numpy(self.buf).pin_memory()
            self.buf = self.tensor.numpy()
        self._dirty_rows = 0
        self._dirty_cols = 0

    def fill(self, rows: np.ndarray) -> np.ndarray:
        k, n = rows.shape
        if k > self.pshape[0] or n > self.pshape[1]:
            raise ValueError(f"batch {rows.shape} exceeds bucket canvas "
                             f"{self.pshape}")
        if self._dirty_rows > k:
            self.buf[k:self._dirty_rows, : self._dirty_cols] = 0.0
        if self._dirty_cols > n:        # never in serving use: the
            self.buf[:k, n:self._dirty_cols] = 0.0  # pipeline pins one
        self.buf[:k, :n] = rows                     # feature width
        self._dirty_rows, self._dirty_cols = k, n
        return self.buf
