"""Multi-process jobs: the process group and the mesh-axis collectives.

Counterpart of ``dislib_tpu/parallel/distributed.py``.  The reference is
one controller over ``jax.devices()``; the port is SPMD, PyTorch's own
model: one process per card, joined by ``torch.distributed``.  A mesh
"device" of the reference is a rank here, and a ds-array's shard is the
block its rank holds (``data/array.py``).

Usage (one process per card)::

    torchrun --nproc-per-node=4 my_job.py        # or the DSLIB_* env vars

    import dislib_tpu_torch as dst
    dst.parallel.initialize()    # reads RANK / WORLD_SIZE / MASTER_ADDR ...
    dst.init((2, 2))             # default: (world, 1)

:func:`initialize` takes its arguments, else ``DSLIB_COORDINATOR`` /
``DSLIB_NUM_PROCS`` / ``DSLIB_PROC_ID`` (the reference's launch interface),
else torchrun's ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``;
with none of them it is a no-op (a one-process job).  The join runs under
``runtime.retry.Retry`` as the reference's does.  ``backend=None`` is
``nccl`` for a ``cuda`` device and ``gloo`` for ``cpu``; a failed NCCL
join raises, and nothing ever picks gloo for a card by itself.  A job
that maps two NCCL ranks to one card raises before NCCL's own
"Duplicate GPU detected" does.  On a card, rank 0 builds any stale
kernel library before the other ranks load one (``_build``), so several
ranks never run ``nvcc`` into one directory.

The axis collectives are named after the ``lax`` op each replaces, and
take a mesh (``parallel/mesh.Mesh``) and an axis name (``"rows"``,
``"cols"``, or ``ALL`` for both):

- :func:`psum` / :func:`pmax` / :func:`pmin` — ``lax.psum`` / ``pmax`` /
  ``pmin``;
- :func:`broadcast_from` — the reference's masked-``psum`` broadcast;
- :func:`all_gather` — ``lax.all_gather(..., tiled=True)``;
- :func:`ppermute` — ``lax.ppermute`` by a shift, by ``batch_isend_irecv``;
- :func:`all_to_all` — ``lax.all_to_all`` by ``all_to_all_single``;
- :func:`reduce_scatter` — ``lax.psum_scatter`` over the leading
  dimension, by one ``all_to_all_single``, the partials added in rank
  order;
- :func:`psum_ordered` — a ``psum`` whose float sum adds the ranks'
  partials in rank order (an ``all_gather``, then the sum);
- :func:`masked_broadcast` — the reference's masked-``psum`` broadcast
  itself, for an owner known only on the device;
- :func:`argmax` — ``jnp.argmax`` of a vector sharded over an axis, ties
  to the lower global index.

On a mesh with no process group (the one-process job) each is the
identity on a one-rank mesh and raises, naming ROADMAP.md A.2, on any
other.  Gloo moves host tensors; a CUDA tensor under gloo is staged
through pinned host memory in ONE place, :func:`_staged`: a property of
the transport, not a fallback (the compute stays on the card, and the
times are the host's, not a fabric's).  Every collective adds its bytes
and host seconds to :data:`COMM` (:func:`comm_stats`).
"""

from __future__ import annotations

import os
import socket
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

ALL = ("rows", "cols")

# seconds a collective (and the join) may wait before it fails; the
# tests shorten it so that a deadlock fails in seconds
DEFAULT_TIMEOUT_S = 600.0

_STATE: dict = {}

# name -> {"calls", "bytes", "seconds"}: every collective since the last
# reset_comm_stats (the bytes this rank sends)
COMM: dict = {}


# ---------------------------------------------------------------------------
# the job
# ---------------------------------------------------------------------------

def _env_int(*names):
    for name in names:
        if os.environ.get(name, "") != "":
            return int(os.environ[name])
    return None


def _address(coordinator_address):
    addr = coordinator_address or os.environ.get("DSLIB_COORDINATOR")
    if addr is None and os.environ.get("MASTER_ADDR"):
        addr = (f"{os.environ['MASTER_ADDR']}:"
                f"{os.environ.get('MASTER_PORT', '29500')}")
    if addr is not None and "://" not in addr:
        addr = f"tcp://{addr}"
    return addr


def _rank_device(device, process_id):
    """The rank's device: ``device`` when given, else ``cuda:LOCAL_RANK``
    (``LOCAL_RANK`` defaults to the process id).  Raises without a card
    or for an index past the cards this host has."""
    from dislib_tpu_torch.parallel.mesh import _resolve_device
    if device is None:
        local = _env_int("LOCAL_RANK")
        device = torch.device("cuda", process_id if local is None else local)
    device = torch.device(device)
    if device.type == "cuda" and device.index is not None \
            and torch.cuda.is_available() \
            and device.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"rank {process_id} maps to {device}, and this host has "
            f"{torch.cuda.device_count()} CUDA device(s): pass device= or "
            "set LOCAL_RANK")
    return _resolve_device(device)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               device=None, timeout: float | None = None) -> bool:
    """Join (or form) a multi-process job; True once joined, False for a
    one-process job (no argument and no launch variable asks for one).

    ``coordinator_address``: ``host:port`` (TCP), or any
    ``init_process_group`` URL (``tcp://``, ``file://``).  ``backend``:
    None picks ``nccl`` on a card and ``gloo`` on the CPU.  ``device``:
    the rank's device (default ``cuda:LOCAL_RANK``).  ``timeout``: seconds
    the join and each collective may wait (default
    :data:`DEFAULT_TIMEOUT_S`)."""
    if _STATE:
        return True
    addr = _address(coordinator_address)
    if num_processes is None:
        num_processes = _env_int("DSLIB_NUM_PROCS", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("DSLIB_PROC_ID", "RANK")
    if addr is None and num_processes is None:
        return False                     # a one-process job: nothing to join
    if addr is None or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process job needs a coordinator address, the number "
            f"of processes and this process's id (got {addr!r}, "
            f"{num_processes!r}, {process_id!r})")
    num_processes, process_id = int(num_processes), int(process_id)
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} not in [0, "
                         f"{num_processes})")
    dev = _rank_device(device, process_id)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}: 'nccl' or 'gloo'")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"backend 'nccl' needs a CUDA device, got {dev}")
        if not dist.is_nccl_available():
            raise RuntimeError("backend 'nccl' is not available in this "
                               "PyTorch build")
        torch.cuda.set_device(dev)
    if timeout is None:
        timeout = DEFAULT_TIMEOUT_S
    from dislib_tpu_torch.runtime.retry import Retry
    Retry.from_env(attempts=5, backoff=1.0, max_backoff=15.0).call(
        dist.init_process_group, backend=backend, init_method=addr,
        world_size=num_processes, rank=process_id,
        timeout=timedelta(seconds=timeout))
    try:
        store = dist.distributed_c10d._get_default_store()
        if backend == "nccl":
            card = (f"{socket.gethostname()}/"
                    f"{torch.cuda.get_device_properties(dev).uuid}")
            _check_one_rank_per_card(store, process_id, num_processes, card)
        if dev.type == "cuda":
            _build_before_load(store, process_id)
    except BaseException:
        dist.destroy_process_group()
        raise
    _STATE.update(backend=backend, device=dev, rank=process_id,
                  world=num_processes)
    return True


def _check_one_rank_per_card(store, rank, world, card):
    """NCCL takes one rank per card: raise, on every rank, when two ranks
    of the job name one ``card`` (host and card id, compared through the
    job's store before any NCCL communicator exists)."""
    store.set(f"dslib/card/{rank}", card)
    cards = [store.get(f"dslib/card/{r}").decode() for r in range(world)]
    shared = sorted({c for c in cards if cards.count(c) > 1})
    if shared:
        raise RuntimeError(
            f"two NCCL ranks of this job map to one card ({shared[0]}): "
            "NCCL takes one rank per card; give each rank its own device, "
            "or pass backend='gloo'")


def _build_before_load(store, rank):
    """Rank 0 builds every stale kernel library; the others wait for its
    word, so several ranks never run ``nvcc`` into one directory."""
    from dislib_tpu_torch import _build
    key = "dslib/kernels_built"
    if rank == 0:
        try:
            _build.build_all()
        except BaseException as exc:
            store.set(key, f"error: {exc}")
            raise
        store.set(key, "ok")
        return
    store.wait([key])
    word = store.get(key).decode()
    if word != "ok":
        raise RuntimeError(f"rank 0 failed to build the kernels: {word}")


def is_initialized() -> bool:
    """True once this process has joined a multi-process job."""
    return bool(_STATE)


def process_info() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) outside a job."""
    return (_STATE["rank"], _STATE["world"]) if _STATE else (0, 1)


def backend() -> str | None:
    """The job's backend (``"nccl"``/``"gloo"``), None outside a job."""
    return _STATE.get("backend")


def rank_device() -> torch.device | None:
    """The device this rank computes on, None outside a job."""
    return _STATE.get("device")


def shutdown() -> None:
    """Leave the job: destroy the process group and drop the default mesh
    (its groups die with the job)."""
    if not _STATE:
        return
    from dislib_tpu_torch.parallel import mesh as _mesh
    _mesh._default_mesh = None
    _GROUPS.clear()
    _STATE.clear()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the grid's groups
# ---------------------------------------------------------------------------

class AxisGroup:
    """One mesh axis as seen from this rank: its process group, the global
    ranks along it in coordinate order, and this rank's index there."""

    __slots__ = ("group", "ranks", "index")

    def __init__(self, group, ranks, index):
        self.group = group
        self.ranks = tuple(ranks)
        self.index = int(index)

    @property
    def size(self) -> int:
        return len(self.ranks)


_GROUPS: dict = {}


def grid_groups(rows: int, cols: int) -> dict:
    """``{"rows": AxisGroup, "cols": AxisGroup, ALL: AxisGroup}`` of this
    rank on a (rows, cols) grid laid out row-major (rank = r·cols + c).
    The ``"rows"`` axis is the ranks that share this rank's column (the
    group of ``lax.psum(x, "rows")``); ``"cols"`` those that share its
    row.  Every rank creates every group in one order, as ``new_group``
    requires; a grid's groups are made once per job."""
    if (rows, cols) in _GROUPS:
        return _GROUPS[(rows, cols)]
    rank = dist.get_rank()
    r, c = divmod(rank, cols)
    out = {}
    for j in range(cols):
        ranks = [i * cols + j for i in range(rows)]
        g = dist.new_group(ranks)
        if j == c:
            out["rows"] = AxisGroup(g, ranks, r)
    for i in range(rows):
        ranks = [i * cols + j for j in range(cols)]
        g = dist.new_group(ranks)
        if i == r:
            out["cols"] = AxisGroup(g, ranks, c)
    out[ALL] = AxisGroup(dist.group.WORLD, range(rows * cols), rank)
    _GROUPS[(rows, cols)] = out
    return out


def _axis(mesh, axis):
    """The AxisGroup of ``axis`` on ``mesh``, or None where the collective
    is the identity: on a one-rank mesh with no process group, and on a
    grid of several ranks along an axis of one rank.  A job of ONE rank
    runs its collectives over groups of one: that is how a one-card job
    checks its transport end to end."""
    if mesh.groups is None:
        if mesh.rows * mesh.cols != 1:
            raise NotImplementedError(
                f"a ({mesh.rows}, {mesh.cols}) mesh needs a torch.distributed "
                f"job of {mesh.rows * mesh.cols} ranks: build it with init() "
                "after parallel.initialize() (ROADMAP.md A.2)")
        return None
    ax = mesh.groups[ALL if isinstance(axis, tuple) else axis]
    return None if ax.size == 1 and mesh.world > 1 else ax


# ---------------------------------------------------------------------------
# the transport
# ---------------------------------------------------------------------------

def _staged(t: torch.Tensor, mesh, fill: bool = True) -> torch.Tensor:
    """The tensor the backend moves.  NCCL moves the CUDA tensor itself;
    gloo moves host memory, so a CUDA tensor is copied into a pinned host
    buffer here — the one place the port stages a collective.  ``fill``
    False: the buffer only receives, so ``t`` is not copied into it."""
    if t.device.type == "cuda" and mesh.backend == "gloo":
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        if fill:
            h.copy_(t)
        return h
    return t


def _unstaged(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``h`` back on ``like``'s device (the identity when not staged)."""
    return h if h.device == like.device else h.to(like.device)


def _count(name, nbytes, seconds):
    s = COMM.setdefault(name, {"calls": 0, "bytes": 0, "seconds": 0.0})
    s["calls"] += 1
    s["bytes"] += int(nbytes)
    s["seconds"] += seconds


def comm_stats() -> dict:
    """A copy of :data:`COMM`."""
    return {k: dict(v) for k, v in COMM.items()}


def reset_comm_stats() -> None:
    COMM.clear()


class Pending:
    """An in-flight collective: ``wait()`` returns its result on the
    caller's device.  Under NCCL the wait orders the current stream and
    returns at once; under gloo it blocks the host, then copies the
    staged buffer to the card."""

    __slots__ = ("_works", "_buf", "_like", "_name", "_nbytes", "_t0",
                 "_out")

    def __init__(self, works, buf, like, name, nbytes, t0):
        self._works = works
        self._buf = buf
        self._like = like
        self._name = name
        self._nbytes = nbytes
        self._t0 = t0
        self._out = None

    def wait(self) -> torch.Tensor:
        if self._out is None:
            for w in self._works:
                w.wait()
            self._out = _unstaged(self._buf, self._like)
            _count(self._name, self._nbytes, time.perf_counter() - self._t0)
        return self._out


def _done(t):
    """A finished :class:`Pending` around ``t`` (a one-rank axis)."""
    p = Pending((), t, t, "", 0, 0.0)
    p._out = t
    return p


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

def _reduce(t, axis, mesh, op, name, async_op=False):
    ax = _axis(mesh, axis)
    if ax is None:
        return _done(t) if async_op else t
    t0 = time.perf_counter()
    buf = _staged(t, mesh)
    buf = buf.clone() if buf is t else buf
    work = dist.all_reduce(buf, op=op, group=ax.group, async_op=True)
    p = Pending((work,), buf, t, name, t.numel() * t.element_size(), t0)
    return p if async_op else p.wait()


def psum(t: torch.Tensor, axis, mesh, async_op: bool = False):
    """The sum of ``t`` over the ranks along ``axis`` (``lax.psum``),
    on every one of them; ``async_op`` returns a :class:`Pending`."""
    return _reduce(t, axis, mesh, dist.ReduceOp.SUM, "psum", async_op)


def pmax(t: torch.Tensor, axis, mesh) -> torch.Tensor:
    return _reduce(t, axis, mesh, dist.ReduceOp.MAX, "pmax")


def pmin(t: torch.Tensor, axis, mesh) -> torch.Tensor:
    return _reduce(t, axis, mesh, dist.ReduceOp.MIN, "pmin")


def any_rank(flag: bool, mesh) -> bool:
    """True on every rank when ``flag`` is True on any: the agreement a
    loop needs before it stops or raises, so that no rank is left
    waiting in a collective its peers never enter."""
    if mesh.groups is None:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                     device=mesh.device)
    return bool(pmax(t, ALL, mesh).item())


def agreed_seed(random_state, mesh):
    """``random_state`` for a host draw that every rank of ``mesh`` must
    make alike: as given, except that None (a fresh seed) becomes rank
    0's fresh seed on a mesh of several ranks, so that the ranks do not
    draw apart."""
    if random_state is not None or mesh.groups is None or mesh.world == 1:
        return random_state
    seed = torch.tensor([np.random.randint(0, 2**31 - 1)],
                        dtype=torch.int64, device=mesh.device)
    return int(broadcast_from(seed, 0, ALL, mesh)[0])


def broadcast_from(t: torch.Tensor, owner: int, axis, mesh,
                   async_op: bool = False):
    """``t`` of the rank at index ``owner`` along ``axis``, on every rank
    of the axis.  Every rank passes a tensor of one shape and dtype: the
    owner its data, the others a buffer to receive into.  ``async_op``
    returns a :class:`Pending`."""
    ax = _axis(mesh, axis)
    if ax is None:
        return _done(t) if async_op else t
    t0 = time.perf_counter()
    buf = _staged(t, mesh, fill=ax.index == owner)
    work = dist.broadcast(buf, src=ax.ranks[owner], group=ax.group,
                          async_op=True)
    nbytes = t.numel() * t.element_size() if ax.index == owner else 0
    p = Pending((work,), buf, t, "broadcast", nbytes, t0)
    return p if async_op else p.wait()


def all_gather(t: torch.Tensor, axis, dim: int, mesh) -> torch.Tensor:
    """The ranks' ``t`` along ``axis`` concatenated along ``dim`` in
    coordinate order (``lax.all_gather(..., tiled=True)``)."""
    ax = _axis(mesh, axis)
    if ax is None:
        return t
    t0 = time.perf_counter()
    buf = _staged(t.contiguous(), mesh)
    parts = [torch.empty_like(buf) for _ in range(ax.size)]
    dist.all_gather(parts, buf, group=ax.group)
    out = _unstaged(torch.cat(parts, dim=dim), t)
    _count("all_gather", t.numel() * t.element_size(),
           time.perf_counter() - t0)
    return out


def ppermute(t: torch.Tensor, axis, shift: int, mesh,
             async_op: bool = False):
    """``t`` of the rank ``shift`` places back along ``axis`` (cyclic):
    each rank sends to index ``i + shift`` and receives from ``i − shift``
    (``lax.ppermute`` with ``perm = [(i, (i + shift) % n)]``), by one
    ``batch_isend_irecv``."""
    ax = _axis(mesh, axis)
    n = 1 if ax is None else ax.size
    if n == 1 or shift % n == 0:
        return _done(t) if async_op else t
    t0 = time.perf_counter()
    send = _staged(t.contiguous(), mesh)
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, ax.ranks[(ax.index + shift) % n],
                      group=ax.group),
           dist.P2POp(dist.irecv, recv, ax.ranks[(ax.index - shift) % n],
                      group=ax.group)]
    works = dist.batch_isend_irecv(ops)
    p = Pending(works, recv, t, "ppermute", t.numel() * t.element_size(),
                t0)
    return p if async_op else p.wait()


def all_to_all(t: torch.Tensor, axis, mesh) -> torch.Tensor:
    """``t`` (n, ...) with ``t[d]`` sent to the rank at index d along
    ``axis``; returns (n, ...) with ``out[s]`` from the rank at index s
    (``lax.all_to_all(split_axis=0, concat_axis=0)``)."""
    ax = _axis(mesh, axis)
    if ax is None:
        return t
    if t.shape[0] != ax.size:
        raise ValueError(f"all_to_all: leading dim {t.shape[0]} is not the "
                         f"axis size {ax.size}")
    t0 = time.perf_counter()
    send = _staged(t.contiguous(), mesh)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=ax.group)
    out = _unstaged(recv, t)
    _count("all_to_all", t.numel() * t.element_size(),
           time.perf_counter() - t0)
    return out


def reduce_scatter(t: torch.Tensor, axis, mesh) -> torch.Tensor:
    """This rank's slice of the sum of ``t`` over the ranks along
    ``axis`` (``lax.psum_scatter(..., scatter_dimension=0, tiled=True)``):
    ``t`` (R·s, ...) is cut into R slices of s along its leading
    dimension, slice d goes to the rank at index d by one
    ``all_to_all_single``, and each rank adds the R partials it receives
    in rank order, so the float sum does not depend on the backend's
    summation order.  Each byte crosses the wire once, where an
    all-reduce moves it twice.  The identity where the axis has one rank
    (a world of one runs the exchange: the transport check)."""
    ax = _axis(mesh, axis)
    if ax is None:
        return t
    n = ax.size
    if t.shape[0] % n:
        raise ValueError(f"reduce_scatter: leading dim {t.shape[0]} is not "
                         f"a multiple of the axis size {n}")
    t0 = time.perf_counter()
    send = _staged(t.contiguous(), mesh)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=ax.group)
    parts = _unstaged(recv, t).reshape(n, t.shape[0] // n, *t.shape[1:])
    out = parts[0].clone()
    for s in range(1, n):
        out += parts[s]
    _count("reduce_scatter", t.numel() * t.element_size(),
           time.perf_counter() - t0)
    return out


def psum_ordered(t: torch.Tensor, axis, mesh) -> torch.Tensor:
    """:func:`psum` with the ranks' partials added in rank order (one
    ``all_gather``, then the sum): the same bits on every rank and on
    every run, whatever order the backend's all-reduce takes.  For the
    small float sums whose order a caller pins (a regressor's leaves)."""
    ax = _axis(mesh, axis)
    if ax is None:
        return t
    parts = all_gather(t.unsqueeze(0), axis, 0, mesh)
    out = parts[0].clone()
    for s in range(1, parts.shape[0]):
        out += parts[s]
    return out


def masked_broadcast(t: torch.Tensor, owns, axis, mesh) -> torch.Tensor:
    """``t`` of the rank along ``axis`` whose ``owns`` (a device bool) is
    True, on every rank of the axis: one ``psum`` in which every other
    rank adds zeros — the reference's masked-``psum`` broadcast, for an
    owner that only the device knows (a medoid's row), so that no host
    read is needed to name it.  Exactly one rank of the axis must own;
    the sum is then exact, except that a −0.0 arrives as +0.0."""
    if _axis(mesh, axis) is None:
        return t
    return psum(torch.where(owns, t, torch.zeros_like(t)), axis, mesh)


def argmax(v: torch.Tensor, offset: int, axis, mesh) -> torch.Tensor:
    """The global index (an int64 device scalar) of the largest entry of
    a vector sharded over ``axis``, ``v`` this rank's slice starting at
    global index ``offset``; ties go to the lower global index, which is
    what ``jnp.argmax`` and ``torch.argmax`` on the whole vector return.
    The value is ``pmax``-ed, then the index ``pmin``-ed among the ranks
    that hold it."""
    loc = torch.argmax(v)
    if _axis(mesh, axis) is None:
        return loc + offset
    best = pmax(v[loc].reshape(1), axis, mesh)
    big = torch.iinfo(torch.int64).max
    idx = torch.where(v[loc] == best[0], loc + offset,
                      torch.full_like(loc, big))
    return pmin(idx.reshape(1), axis, mesh)[0]
