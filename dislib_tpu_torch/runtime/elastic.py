"""Device→host reads for snapshots and health checks, synchronous or
deferred.

Counterpart of ``dislib_tpu/runtime/elastic.py``, its one-process part:
:func:`fetch` and :class:`AsyncFetch`.  ``fetch(x)`` copies a device
tensor (or a ds-array's backing) to a host ndarray, with transient
failures retried under ``Retry.from_env()``.  ``fetch(x,
blocking=False)`` enqueues the copy and returns an :class:`AsyncFetch`
whose :meth:`~AsyncFetch.result` waits for it: the copy is a
``non_blocking`` copy into pinned host memory on the CURRENT stream,
followed by a recorded CUDA event.  Kernels a fit enqueues after the
fetch on that stream are ordered after the copy, so a chunk that updates
a carry in place cannot change the bytes a snapshot taken before it
reads.  A CPU tensor is copied at once.

:func:`fetch_packed` is the one read of a fit chunk: every result tensor
and the chunk's health vector packed into one float64 buffer (exact for
float32, int32 and bool values) and copied in ONE transfer; the health
guard resolves the health vector's part under its watchdog, and the
deferred commit reads the other parts from the same host buffer.

Not ported yet: ``repad_rows`` (the re-pad of row-padded state onto
another mesh, ROADMAP.md A.11); the port's one-card mesh never changes
its pad quantum.
"""

from __future__ import annotations

import numpy as np
import torch

from dislib_tpu_torch.utils.profiling import count_read, count_transfer

__all__ = ["fetch", "AsyncFetch", "fetch_packed"]


def _tensor(x):
    return x._data if hasattr(x, "_data") else x


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


class AsyncFetch:
    """A deferred device→host read started by ``fetch(x,
    blocking=False)``: the copy is enqueued at construction, and
    :meth:`result` waits for it, counts one transfer (and one host read
    under ``site``) and caches the ndarray."""

    def __init__(self, x, site: str = "fetch"):
        self.site = site
        self._value = None
        self._event = None
        t = _tensor(x)
        if not isinstance(t, torch.Tensor):
            self._value = np.asarray(t)
            self._host = None
            return
        if t.device.type == "cuda":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t.detach(), non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
            self._host = host
        else:
            # a CPU tensor resolves at once: a copy, which a later
            # in-place update of the carry cannot reach
            self._host = t.detach().clone()

    def result(self) -> np.ndarray:
        if self._host is not None:
            from dislib_tpu_torch.runtime.retry import Retry
            if self._event is not None:
                Retry.from_env().call(self._event.synchronize)
            count_transfer()
            count_read(self.site)
            self._value = _numpy(self._host)
            self._host = self._event = None
        return self._value


def fetch(x, blocking: bool = True):
    """Device→host read of a tensor or a ds-array's padded backing, as an
    ndarray; ``blocking=False`` returns an :class:`AsyncFetch` instead."""
    handle = AsyncFetch(x)
    return handle if not blocking else handle.result()


class _Part:
    """One tensor's slice of a :class:`PackedFetch`, with ``result()``."""

    __slots__ = ("_pack", "_i")

    def __init__(self, pack, i):
        self._pack, self._i = pack, i

    def result(self) -> np.ndarray:
        return self._pack.result()[self._i]


class PackedFetch:
    """Several device tensors read back in ONE transfer (see
    :func:`fetch_packed`); ``result()`` is the list of host arrays in
    their own dtypes and shapes, ``part(i)`` a handle on the i-th."""

    def __init__(self, tensors, site: str = "results"):
        tensors = [torch.as_tensor(t) for t in tensors]
        self._meta = [(tuple(t.shape), t.dtype) for t in tensors]
        flat = torch.cat([t.detach().reshape(-1).to(torch.float64)
                          for t in tensors]) if tensors else \
            torch.zeros(0, dtype=torch.float64)
        self._fetch = AsyncFetch(flat, site=site)
        self._out = None

    def part(self, i: int) -> _Part:
        return _Part(self, i)

    def result(self) -> list:
        if self._out is None:
            host = self._fetch.result()
            out, pos = [], 0
            for shape, dt in self._meta:
                size = int(np.prod(shape, dtype=np.int64))
                part = host[pos: pos + size].reshape(shape)
                out.append(part.astype(str(dt).removeprefix("torch.")))
                pos += size
            self._out = out
        return self._out


def fetch_packed(*tensors, site: str = "results") -> PackedFetch:
    """Enqueue one packed float64 copy of ``tensors`` (float32, int32,
    bool and small integers are exact in float64) and return its
    :class:`PackedFetch`.  Counted as one host read under ``site`` when
    resolved."""
    return PackedFetch(tensors, site=site)
