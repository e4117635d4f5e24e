"""The port's hand-written CUDA kernels and their plain PyTorch versions.

Counterpart of ``dislib_tpu/ops/pallas_kernels.py``:

- :func:`panel_gemm` — SUMMA's panel GEMM on the tensor cores
  (``csrc/panel_gemm.cu``; launch plan :func:`gemm_plan`);
- :func:`distances_sq` — ‖a‖² − 2a·bᵀ + ‖b‖² clamped at zero
  (``csrc/distances_sq.cu``; plan :func:`dist_plan`), the KMeans E-step,
  predict and score; its bf16-operand variant
  :func:`distances_sq_bf16` (plan :func:`dist_bf16_plan`), the E-step of
  KMeans ``fast_distance`` and ``precision="default"``; and its batched
  entry :func:`distances_sq_batched` (plan :func:`dist_batched_plan`),
  CascadeSVM's per-node sub-Grams of a cascade level in one launch;
- :func:`node_histogram` — the forest's per-level weighted (node, feature,
  bin) histogram, for every tree in one call (``csrc/node_histogram.cu``;
  plan :func:`hist_plan`).

Each wrapper takes its plain version ONLY when the operands are CPU
tensors — the CPU tests run that way.  On CUDA tensors it checks device,
dtype, shape and contiguity, launches on the current stream, checks the
launch's return code, and raises on anything the kernel does not take.
There is no fallback from a CUDA tensor to the plain version.

:data:`LAUNCHES` counts kernel launches per wrapper, so a run can show that
its main path went through the kernels: one per call that reaches the
CUDA code of a source, whatever number of CUDA kernels the call runs
(node_histogram runs four); ``"distances_sq"`` counts all three of its
entry points (float32, bf16 operands, batched).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from dislib_tpu_torch import _build
from dislib_tpu_torch.ops import precision as px

#: kernel launches per wrapper, one per call that reaches the CUDA code
#: (plain-version calls are not counted)
LAUNCHES = {"panel_gemm": 0, "distances_sq": 0, "node_histogram": 0}

_INT_MAX = 2**31 - 1
# precisions the distance kernel implements: None inherits the scope, and
# on that kernel every scope is f32 FMA, the float32-faithful contraction;
# "default" is the reference's one bf16 pass (the bf16-operand variant)
_F32_PRECISIONS = (None, "highest", "float32")
_BF16_PRECISIONS = ("default", "bfloat16")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _check_cuda(name, *ts, ndim=2):
    dev = ts[0].device
    for t in ts:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"{name}: operands must all be CPU tensors (plain version) "
                f"or all on one CUDA device (kernel); got "
                f"{[str(x.device) for x in ts]}")
        if t.dim() != ndim:
            raise ValueError(f"{name}: operands must be {ndim}-D, got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes row-major "
                             "contiguous operands; call .contiguous()")
        if any(s > _INT_MAX for s in t.shape):
            raise ValueError(f"{name}: dimension too large for the kernel's "
                             f"32-bit sizes: {tuple(t.shape)}")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _cdiv(a, b) * b


def _raise_on_error(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError_t {rc}")


# ---------------------------------------------------------------------------
# panel_gemm
# ---------------------------------------------------------------------------

#: shared memory a block may use on Hopper (227 KB)
GEMM_SMEM_LIMIT = 232_448
# the kernel's tile plan per operand dtype (``Gemm<T>`` in the source):
# rows of C per block, columns, K per stage (128 bytes), stages, operand
# parts (FLOAT32 keeps hi and lo)
_GEMM_TILES = {torch.bfloat16: (128, 256, 64, 4, 1),
               torch.float32: (128, 128, 32, 3, 2)}


class GemmPlan(NamedTuple):
    """How one ``panel_gemm`` launch cuts C = A @ B (``csrc/panel_gemm.cu``).
    """
    k_pad: int        # k rounded up so a K-major row is a multiple of 16 B
    bm: int           # rows of C per block
    bn: int           # columns of C per block
    bk: int           # K per stage, elements (128 bytes)
    stages: int       # depth of the shared-memory ring
    tiles_m: int
    tiles_n: int
    k_tiles: int      # stages a block consumes; the last may run past k_pad
    smem_bytes: int   # dynamic shared memory of a block (1 KB for alignment)
    pad_a: bool       # BFLOAT16: A is copied into a zero-padded buffer first


def gemm_plan(m: int, n: int, k: int, dtype: torch.dtype,
              a_ptr: int = 0) -> GemmPlan:
    """The launch plan of ``panel_gemm`` for (m, k) @ (k, n) operands of
    ``dtype`` (float32 or bfloat16, after the policy's rounding).

    TMA needs a 16-byte aligned base and row strides that are multiples of
    16 bytes: every K-major operand the kernel reads has ``k_pad`` columns,
    k rounded up to 4 f32 or 8 bf16 values, zero past k.  The FLOAT32 prep
    pass always writes fresh buffers; a bfloat16 A is read in place unless
    k needs padding or ``a_ptr`` is not 16-byte aligned (``pad_a``)."""
    if dtype not in _GEMM_TILES:
        raise TypeError(f"panel_gemm: no kernel plan for {dtype}")
    bm, bn, bk, stages, split = _GEMM_TILES[dtype]
    esize = torch.empty((), dtype=dtype).element_size()
    per16 = 16 // esize
    k_pad = -(-k // per16) * per16
    tiles_m, tiles_n = -(-m // bm), -(-n // bn)
    smem = stages * split * (bm + bn) * 128 + 1024
    plan = GemmPlan(k_pad, bm, bn, bk, stages, tiles_m, tiles_n,
                    -(-k_pad // bk), smem, dtype == torch.bfloat16
                    and (k_pad != k or a_ptr % 16 != 0))
    if max(m, n, k_pad) > _INT_MAX or tiles_m * tiles_n > _INT_MAX:
        raise ValueError(f"panel_gemm: (m, n, k) = {(m, n, k)} exceeds the "
                         "kernel's 32-bit sizes")
    return plan


def panel_gemm_plain(a: torch.Tensor, b: torch.Tensor,
                     policy: px.Policy = px.FLOAT32) -> torch.Tensor:
    """``A @ B`` in plain PyTorch: :func:`~px.pdot`'s contract — operands
    rounded to the policy compute dtype, f32 accumulation (f64 for f64
    operands under the float32 floor), output the accumulation dtype."""
    return px.pdot(a, b, policy)


def panel_gemm(a: torch.Tensor, b: torch.Tensor,
               policy: px.Policy = px.FLOAT32) -> torch.Tensor:
    """``A @ B`` — the SUMMA panel GEMM (reference:
    ``pallas_kernels.panel_gemm``), on the tensor cores.  The wrapper
    rounds the operands with ``to_compute(policy)`` and allocates the
    float32 output and the kernel's K-major scratch operands.  BFLOAT16: one
    bf16 wgmma product.  FLOAT32: the float32-faithful 3xTF32 product (each
    operand split into TF32 hi and lo, lo·hi + hi·lo + hi·hi accumulated in
    f32).  A float64 CUDA operand raises ``TypeError`` (the plain version
    keeps f64)."""
    if _on_cpu(a, b):
        return panel_gemm_plain(a, b, policy)
    _check_cuda("panel_gemm", a, b)
    a = px.to_compute(a, policy)
    b = px.to_compute(b, policy)
    if a.dtype != b.dtype or a.dtype not in _GEMM_TILES:
        raise TypeError(
            f"panel_gemm: the CUDA kernel takes float32 or bfloat16 "
            f"operands of one dtype after the {policy.name} policy's "
            f"rounding, got {a.dtype} and {b.dtype}")
    (m, k), (k2, n) = a.shape, b.shape
    if k != k2:
        raise ValueError(f"panel_gemm: inner dimensions differ: "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    dev = a.device
    out = torch.empty((m, n), dtype=px.accum_dtype(policy), device=dev)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    plan = gemm_plan(m, n, k, a.dtype, a.data_ptr())
    lib = _build.library("panel_gemm")

    def scratch(rows):
        return torch.empty((rows, plan.k_pad), dtype=a.dtype, device=dev)

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if a.dtype == torch.float32:
            a_hi, a_lo, bt_hi, bt_lo = scratch(m), scratch(m), scratch(n), \
                scratch(n)
            rc = lib.dslib_panel_gemm_f32(
                a.data_ptr(), b.data_ptr(), a_hi.data_ptr(), a_lo.data_ptr(),
                bt_hi.data_ptr(), bt_lo.data_ptr(), out.data_ptr(), m, n, k,
                plan.k_pad, stream)
        else:
            if plan.pad_a:
                a = torch.nn.functional.pad(a, (0, plan.k_pad - k))
            bt = scratch(n)
            rc = lib.dslib_panel_gemm_bf16(
                a.data_ptr(), b.data_ptr(), bt.data_ptr(), out.data_ptr(), m,
                n, k, plan.k_pad, stream)
    if rc >= 1000:
        raise RuntimeError(
            "panel_gemm: " + ("cuTensorMapEncodeTiled not found in the "
                              "driver" if rc < 2000 else
                              f"the TMA descriptor was refused (CUresult "
                              f"{rc - 2000})"))
    _raise_on_error("panel_gemm", rc)
    LAUNCHES["panel_gemm"] += 1
    return out


def gemm_compiled_plan(dtype: torch.dtype) -> tuple:
    """(bm, bn, bk, stages, smem_bytes) as compiled into the kernel
    library, to hold :func:`gemm_plan` against on a card."""
    out = (ctypes.c_int * 5)()
    _build.library("panel_gemm").dslib_panel_gemm_config(
        int(dtype == torch.float32), out)
    return tuple(out)


# ---------------------------------------------------------------------------
# distances_sq
# ---------------------------------------------------------------------------

def check_precision(precision) -> None:
    """The distance kernels implement the float32-faithful contraction
    (None, ``"highest"``, ``"float32"``) and one bf16 pass
    (``"default"`` or its alias ``"bfloat16"``, the bf16-operand
    variant), as JAX names them; ``"high"`` (three bf16 passes) is not
    implemented."""
    if precision not in _F32_PRECISIONS + _BF16_PRECISIONS:
        raise NotImplementedError(
            f"distances_sq precision={precision!r}: the port implements "
            f"{_F32_PRECISIONS} (float32-faithful) and {_BF16_PRECISIONS} "
            "(bf16 operands, float32 sums)")


def bf16_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` (m, d) as the bf16-operand variant stores it: (m, dp)
    bfloat16, rounded to nearest even, each row padded with zero columns
    to dp, d rounded up to a multiple of 8 values (16 bytes)."""
    m, d = x.shape
    out = torch.empty((m, _round_up(d, 8)), dtype=torch.bfloat16,
                      device=x.device)
    out[:, d:].zero_()
    out[:, :d].copy_(x)
    return out


def distances_sq_bf16_plain(a16: torch.Tensor, a_sq: torch.Tensor,
                            b: torch.Tensor) -> torch.Tensor:
    """The bf16-operand distances in plain PyTorch: the float32
    contraction of the bf16 rows ``a16`` (m, dp; the first d columns are
    a's) with ``b`` (k, d) rounded to bf16, and the float32 norms ``a_sq``
    (m,) and ``‖b‖²`` of the unrounded operands: ``max(a_sq − 2a·bᵀ +
    ‖b‖², 0)``, float32 (m, k)."""
    d = b.shape[1]
    b = b.to(torch.float32)
    with px.precise():
        cross = torch.matmul(a16[:, :d].to(torch.float32),
                             b.to(torch.bfloat16).to(torch.float32).T)
    b_sq = torch.sum(b * b, dim=1)
    return torch.clamp_min(a_sq.to(torch.float32)[:, None] - 2.0 * cross
                           + b_sq[None, :], 0.0)


def distances_sq_plain(a: torch.Tensor, b: torch.Tensor,
                       precision=None) -> torch.Tensor:
    """Pairwise squared euclidean distances (m, k) in plain PyTorch: one
    GEMM and two row norms, ``max(‖a‖² − 2a·bᵀ + ‖b‖², 0)``, in the
    operands' promoted float dtype; ``precision="default"``: the
    bf16-operand variant (:func:`distances_sq_bf16_plain`), float32."""
    check_precision(precision)
    if precision in _BF16_PRECISIONS:
        a = a.to(torch.float32)
        return distances_sq_bf16_plain(a.to(torch.bfloat16),
                                       torch.sum(a * a, dim=1), b)
    dt = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dt), b.to(dt)
    a_sq = torch.sum(a * a, dim=1, keepdim=True)
    b_sq = torch.sum(b * b, dim=1)
    if precision is None:
        cross = torch.matmul(a, b.T)
    else:
        with px.precise():
            cross = torch.matmul(a, b.T)
    return torch.clamp_min(a_sq - 2.0 * cross + b_sq[None, :], 0.0)


#: shared memory a distances_sq block may use (Hopper allows 227 KB)
DIST_SMEM_LIMIT = 232_448
# the stream's compiled constants (``csrc/distances_sq.cu``): threads (and
# rows of a tile at most), stages, bytes before the stages, rows of b per
# chunk, row stride of the staged output
_DIST_THREADS, _DIST_STAGES, _DIST_HEAD = 256, 2, 128
_DIST_KC, _DIST_OST = 16, 17
# a tile of fewer rows leaves most of a block idle: the slices instead
_DIST_MIN_ROWS = 32


class DistPlan(NamedTuple):
    """How one ``distances_sq`` launch runs (``csrc/distances_sq.cu``)."""
    rows: int         # rows of a tile on the stream; 0: the slices
    grid: int         # persistent blocks of the stream
    smem_bytes: int   # dynamic shared memory of a stream block


def dist_plan(m: int, d: int, a_ptr: int, n_sms: int) -> DistPlan:
    """The stream (bulk copies of contiguous row tiles) needs a 16-byte
    aligned ``a`` with rows of a multiple of 16 bytes, and a two-stage ring
    of at least ``_DIST_MIN_ROWS`` rows beside the chunk of b and the
    staged output; every other shape takes the slices."""
    fixed = _DIST_HEAD + 4 * (d * _DIST_KC + _DIST_KC)
    per_row = 4 * (_DIST_STAGES * d + _DIST_OST)
    rows = min(_DIST_THREADS, (DIST_SMEM_LIMIT - fixed) // per_row)
    if d % 4 or a_ptr % 16 or rows < _DIST_MIN_ROWS:
        return DistPlan(0, 0, 0)
    smem = fixed + per_row * rows
    per_sm = max(1, min(8, DIST_SMEM_LIMIT // (smem + 1024)))
    return DistPlan(rows, max(1, min(_cdiv(m, rows), n_sms * per_sm)), smem)


def distances_sq(a: torch.Tensor, b: torch.Tensor,
                 precision=None) -> torch.Tensor:
    """Pairwise squared euclidean distances of the rows of ``a`` (m, d)
    and ``b`` (k, d), clamped at zero (reference:
    ``pallas_kernels.distances_sq``).  ``precision`` ∈ {None,
    ``"highest"``, ``"float32"``}: the kernel's cross term is f32 FMA;
    ``"default"``: one bf16 pass, through :func:`distances_sq_bf16` on a
    bf16 copy of ``a`` made here (a caller that reuses ``a`` stores the
    copy once, as KMeans does).  CUDA operands must be float32; the launch
    plan is :func:`dist_plan`."""
    if _on_cpu(a, b):
        return distances_sq_plain(a, b, precision)
    check_precision(precision)
    _check_cuda("distances_sq", a, b)
    if precision in _BF16_PRECISIONS and a.dtype == torch.float32:
        return distances_sq_bf16(bf16_rows(a), torch.sum(a * a, dim=1), b)
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"distances_sq: the CUDA kernel takes float32 "
                        f"operands, got {a.dtype} and {b.dtype}")
    (m, d), (k, d2) = a.shape, b.shape
    if d != d2:
        raise ValueError(f"distances_sq: feature dimensions differ: "
                         f"{tuple(a.shape)} vs {tuple(b.shape)}")
    out = torch.empty((m, k), dtype=torch.float32, device=a.device)
    if m == 0 or k == 0:
        return out
    plan = dist_plan(m, d, a.data_ptr(), torch.cuda.get_device_properties(
        a.device).multi_processor_count)
    lib = _build.library("distances_sq")
    with torch.cuda.device(a.device):
        rc = lib.dslib_distances_sq_f32(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, d, *plan,
            torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on_error("distances_sq", rc)
    LAUNCHES["distances_sq"] += 1
    return out


def distances_sq_batched_plain(a: torch.Tensor,
                               b: torch.Tensor) -> torch.Tensor:
    """The batched version's plain formulation: (nb, m, k) squared
    distances of ``a`` (nb, m, d) and ``b`` (nb, k, d), one float32
    ``bmm`` with TF32 off, clamped at zero."""
    a_sq = torch.sum(a * a, dim=2, keepdim=True)
    b_sq = torch.sum(b * b, dim=2)
    with px.precise():
        cross = torch.bmm(a, b.transpose(1, 2))
    return torch.clamp_min(a_sq - 2.0 * cross + b_sq[:, None, :], 0.0)


def dist_batched_plan(nb: int, m: int, d: int, a_ptr: int,
                      n_sms: int) -> DistPlan:
    """One problem's :func:`dist_plan`, its persistent blocks cut so that
    the ``nb`` problems together fill the SMs once (each block walks its
    problem's tiles, so any count of at least one is right)."""
    plan = dist_plan(m, d, a_ptr, n_sms)
    if not plan.rows:
        return plan
    per_sm = max(1, min(8, DIST_SMEM_LIMIT // (plan.smem_bytes + 1024)))
    return plan._replace(grid=max(1, min(plan.grid,
                                         _cdiv(n_sms * per_sm, nb))))


def distances_sq_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances (nb, m, k) float32, clamped at zero, of
    ``nb`` equal-shape problems: the rows of ``a`` (nb, m, d) against the
    rows of ``b`` (nb, k, d), all in one launch of the float32 kernel with
    a grid dimension over the problems (no reference kernel of its own:
    the reference computes each cascade node's ``distances_sq`` inside a
    ``vmap``).  CPU tensors take :func:`distances_sq_batched_plain`; CUDA
    tensors must be float32 and contiguous, ``nb`` at most 65,535."""
    if _on_cpu(a, b):
        return distances_sq_batched_plain(a, b)
    _check_cuda("distances_sq_batched", a, b, ndim=3)
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"distances_sq_batched: the CUDA kernel takes "
                        f"float32 operands, got {a.dtype} and {b.dtype}")
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] \
            or a.shape[2] != b.shape[2]:
        raise ValueError(f"distances_sq_batched: shapes {tuple(a.shape)} "
                         f"and {tuple(b.shape)} are not (nb, m, d) and "
                         "(nb, k, d)")
    (nb, m, d), k = a.shape, b.shape[1]
    if nb > 65535:
        raise ValueError(f"distances_sq_batched: {nb} problems > 65535")
    out = torch.empty((nb, m, k), dtype=torch.float32, device=a.device)
    if nb == 0 or m == 0 or k == 0:
        return out
    plan = dist_batched_plan(nb, m, d, a.data_ptr(),
                             torch.cuda.get_device_properties(
                                 a.device).multi_processor_count)
    lib = _build.library("distances_sq")
    with torch.cuda.device(a.device):
        rc = lib.dslib_distances_sq_f32_batched(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), nb, m, k, d, *plan,
            torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on_error("distances_sq_batched", rc)
    LAUNCHES["distances_sq"] += 1
    return out


class DistBf16Plan(NamedTuple):
    """How one ``distances_sq_bf16`` launch runs (``dist_bf16`` in
    ``csrc/distances_sq.cu``)."""
    rows: int         # threads of a block and rows of its tile
    grid: int         # persistent blocks
    smem_bytes: int   # dynamic shared memory of a block


# rows of a bf16 tile at most (``BF_MAX_ROWS`` in the source)
_BF16_MAX_ROWS = 128


def dist_bf16_plan(m: int, dp: int, n_sms: int) -> DistBf16Plan:
    """A block streams tiles of ``rows`` bf16 rows of ``dp`` values (at
    most 128, a multiple of 32, as many as fit) through a two-stage ring,
    beside the chunk of b (dp x 16 float32), its norms and the staged
    (rows, 17) output; as many persistent blocks as fit on the SMs (at most
    8 an SM), no more than there are tiles."""
    fixed = _DIST_HEAD + 4 * (dp * _DIST_KC + _DIST_KC)
    per_row = 2 * _DIST_STAGES * dp + 4 * _DIST_OST
    rows = min(_BF16_MAX_ROWS, (DIST_SMEM_LIMIT - fixed) // per_row // 32
               * 32)
    if rows < 32:
        raise ValueError(f"distances_sq_bf16: rows of {dp} values are too "
                         "wide for a 32-row tile in shared memory")
    smem = fixed + per_row * rows
    per_sm = max(1, min(8, DIST_SMEM_LIMIT // (smem + 1024)))
    return DistBf16Plan(rows, max(1, min(_cdiv(m, rows), n_sms * per_sm)),
                        smem)


def distances_sq_bf16(a16: torch.Tensor, a_sq: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances (m, k) float32, clamped at zero, from
    bf16 operands (KMeans ``fast_distance``, the reference's
    ``precision="default"``): ``a16`` (m, dp) bfloat16 as
    :func:`bf16_rows` stores it (dp a multiple of 8, columns past d zero),
    ``a_sq`` (m,) float32 the norms of the unrounded rows, ``b`` (k, d)
    float32, rounded to bf16 for the cross term, its norms taken unrounded.
    The cross term sums the exact bf16 products in float32.  CPU tensors
    take :func:`distances_sq_bf16_plain`; CUDA tensors the kernel
    (``dslib_distances_sq_bf16``), which also needs ``a16`` 16-byte
    aligned."""
    if _on_cpu(a16, a_sq, b):
        return distances_sq_bf16_plain(a16, a_sq, b)
    _check_cuda("distances_sq_bf16", a16, b)
    if a_sq.device != a16.device or not a_sq.is_contiguous():
        raise ValueError("distances_sq_bf16: a_sq must be contiguous and on "
                         f"{a16.device}, got {a_sq.device}")
    if a16.dtype != torch.bfloat16 or a_sq.dtype != torch.float32 \
            or b.dtype != torch.float32:
        raise TypeError(f"distances_sq_bf16: the CUDA kernel takes bfloat16 "
                        f"a, float32 a_sq and float32 b, got {a16.dtype}, "
                        f"{a_sq.dtype} and {b.dtype}")
    (m, dp), (k, d) = a16.shape, b.shape
    if a_sq.shape != (m,) or d > dp or dp % 8 or d == 0:
        raise ValueError(
            f"distances_sq_bf16: shapes a16 {tuple(a16.shape)}, a_sq "
            f"{tuple(a_sq.shape)}, b {tuple(b.shape)}: a16 must be (m, dp), "
            "dp a multiple of 8 and at least b's d > 0 (bf16_rows), a_sq "
            "(m,)")
    if a16.data_ptr() % 16:
        raise ValueError("distances_sq_bf16: a16 must be 16-byte aligned "
                         "(a fresh bf16_rows copy is)")
    out = torch.empty((m, k), dtype=torch.float32, device=a16.device)
    if m == 0 or k == 0:
        return out
    plan = dist_bf16_plan(m, dp, torch.cuda.get_device_properties(
        a16.device).multi_processor_count)
    lib = _build.library("distances_sq")
    with torch.cuda.device(a16.device):
        rc = lib.dslib_distances_sq_bf16(
            a16.data_ptr(), a_sq.data_ptr(), b.data_ptr(), out.data_ptr(), m,
            k, d, dp, *plan, torch.cuda.current_stream(a16.device).cuda_stream)
    _raise_on_error("distances_sq_bf16", rc)
    LAUNCHES["distances_sq"] += 1
    return out


# ---------------------------------------------------------------------------
# node_histogram
# ---------------------------------------------------------------------------

#: warps of a partition block and of a histogram block (``PWARPS`` and
#: ``HWARPS`` in the source)
_PART_WARPS = _HIST_WARPS = 8
#: histogram blocks per SM the kernel is compiled for (``HBLOCKS``)
_HIST_BLOCKS_PER_SM = 4
#: shared memory the histogram copies of one block may use
HIST_SMEM_BYTES = 96 * 1024
# the flush's 32 x 9 float transpose tile of each histogram warp
_HIST_TILE_BYTES = 4 * 32 * 9 * _HIST_WARPS
#: nodes the partition's shared counters hold (8 warps x n_nodes int32
#: in part_scatter); the estimators reach 2048 (depth 12)
HIST_MAX_NODES = 4096
# rows per node (m / n_nodes) from which each warp keeps its own copy of
# the histogram and adds without atomics
_HIST_PRIVATE_ROWS = 16384
# rows a partition warp owns, at most and at least
_PART_MAX_ROWS, _PART_MIN_ROWS = 2048, 256
# rows of a histogram item at least
_HIST_MIN_ITEM_ROWS = 256


class HistPlan(NamedTuple):
    """How one ``node_histogram`` call cuts its work (see
    ``csrc/node_histogram.cu``): the partition's chunks, then the
    histogram's items of (node, row chunk, feature group, slice)."""
    rows_per_warp: int    # partition: rows a warp owns
    n_pchunks: int        # partition chunks per tree (8 warps each)
    J: int                # feature slots per lane (features per group / 32)
    fgs: int              # features per group
    n_fgroups: int
    slice_len: int        # (bin, stat) entries of a feature per item
    n_slices: int
    private: int          # 1: a histogram copy per warp, plain adds
    rows_per_item: int    # rows of a node an item takes at most
    grid_x: int           # persistent histogram blocks per tree


def hist_smem_bytes(plan: HistPlan) -> int:
    """Dynamic shared memory of one histogram block: the histogram copies,
    then the flush's transpose tiles (``_HIST_TILE_BYTES``)."""
    copies = _HIST_WARPS if plan.private else 1
    return 4 * copies * plan.J * plan.slice_len * 32 + _HIST_TILE_BYTES


def hist_plan(T, m, n, n_nodes, n_bins, S, n_sms,
              smem_bytes=HIST_SMEM_BYTES, private=None,
              fixed_order=False) -> HistPlan:
    """The plan of one call.  A node's histogram of one feature has
    ``n_bins·S`` entries and a block keeps ``32·J`` features (one per lane
    and slot, J ≤ 4) of them in ``smem_bytes``: features are cut into
    groups until they fit, then a feature's entries into slices (a multiple
    of 4 entries).  Where nodes hold many rows (``m / n_nodes ≥
    _HIST_PRIVATE_ROWS``, and enough of them to fill the card) and eight
    copies fit without more feature groups, each warp keeps its own: at
    100 features eight copies would need four groups, which an H100
    measured slower than one shared copy at every level, while at 20
    features they measured faster (``chip_smoke.py``, PERF.md).
    ``private`` True or False forces the choice (True cuts feature groups
    until eight copies fit), to measure the other one.  ``fixed_order``
    (the sums of non-integer contributions) always keeps eight copies,
    cutting feature groups until they fit, as ``private=True`` does
    (narrower slices of entries instead measured 3× slower at the
    regressor's deepest level on an H100: each slice reads its rows' bins
    again; PERF.md).  The grid is eight blocks for each resident slot,
    split evenly among the trees; items take at most ``rows_per_item`` rows of a node, sized
    so that the first levels give about eight items for each slot; a deep
    level's nodes are then one item each, which stores plainly."""
    cap = smem_bytes // 4
    E = n_bins * S
    E4 = -(-E // 4) * 4
    J = min(4, _cdiv(n, 32))
    while J > 1 and J * 32 * E4 > cap:
        J -= 1
    if fixed_order:
        if private is False:
            raise ValueError("node_histogram: the fixed-order sums need a "
                             "histogram copy per warp")
        private = True
    elif private is None:
        # and enough rows for private items (at least a quarter of
        # _HIST_PRIVATE_ROWS each) to give two blocks per SM
        private = m // n_nodes >= _HIST_PRIVATE_ROWS \
            and T * m >= _HIST_PRIVATE_ROWS // 4 * 2 * n_sms \
            and _HIST_WARPS * J * 32 * E4 <= cap
    copies = _HIST_WARPS if private else 1
    while J > 1 and copies * J * 32 * E4 > cap:
        J -= 1
    n_fgroups = -(-n // (32 * J))
    fgs = -(-n // n_fgroups)
    J = -(-fgs // 32)
    slice_len = min(E4, cap // (copies * J * 32) // 4 * 4)
    if slice_len < 4:
        raise ValueError(f"node_histogram: {smem_bytes} bytes of shared "
                         "memory hold no slice")
    n_slices = -(-E // slice_len)
    smem = 4 * copies * J * slice_len * 32 + _HIST_TILE_BYTES
    per_sm = max(1, min(_HIST_BLOCKS_PER_SM, 228 * 1024 // (smem + 1024)))
    per_chunk = n_fgroups * n_slices
    # eight blocks for each resident slot, split evenly among the trees,
    # and about eight items for each slot at the first levels: on an H100
    # the time fell as the grid grew to that (chip_smoke.py, PERF.md)
    slots = n_sms * per_sm
    # private copies pay eight zeroings and a sum of eight per item
    rows_per_item = max(_HIST_MIN_ITEM_ROWS,
                        _HIST_PRIVATE_ROWS // 4 if private else 0,
                        _round_up(_cdiv(T * m * per_chunk, 8 * slots), 32))
    grid_x = max(1, min(_cdiv(8 * slots, T),
                        (_cdiv(m, rows_per_item) + n_nodes) * per_chunk))
    rows_per_warp = min(_PART_MAX_ROWS, max(_PART_MIN_ROWS, _round_up(
        _cdiv(T * m, 4 * n_sms * _PART_WARPS), 32)))
    n_pchunks = _cdiv(m, _PART_WARPS * rows_per_warp)
    plan = HistPlan(rows_per_warp, n_pchunks, J, fgs, n_fgroups, slice_len,
                    n_slices, int(private), rows_per_item, grid_x)
    if max(plan) > _INT_MAX or T * m + T * n_nodes * n_pchunks > _INT_MAX:
        raise ValueError(f"node_histogram: plan {plan} exceeds the "
                         "kernel's 32-bit sizes")
    return plan


def hist_occupancy(plan: HistPlan) -> int:
    """Histogram blocks resident per SM for ``plan``, by the CUDA runtime
    (needs a card)."""
    out = ctypes.c_int()
    _raise_on_error("node_histogram", _build.library("node_histogram")
                    .dslib_node_histogram_occupancy(
                        plan.J, plan.private, hist_smem_bytes(plan),
                        ctypes.byref(out)))
    return out.value


def hist_scratch_len(T, m, n_nodes, plan: HistPlan) -> int:
    """int32 entries of the call's scratch: the sorted row indices (T, m),
    the (node, chunk) counts, and the per-node first row, first item and
    first partial slot."""
    return T * m + T * n_nodes * plan.n_pchunks + 3 * T * (n_nodes + 1)


def hist_partial_slots(m, plan: HistPlan) -> int:
    """Partial slots a tree needs on the fixed-order path, at most: the
    row chunks of its nodes of several chunks.  A node of r > rows_per_item
    rows has ceil(r / rows_per_item) < 2r / rows_per_item chunks, and the
    rows of a tree are at most m."""
    return 2 * _cdiv(m, plan.rows_per_item)


def node_histogram_plain(node: torch.Tensor, bx: torch.Tensor,
                         w: torch.Tensor, stats: torch.Tensor,
                         n_nodes: int, n_bins: int,
                         integer: bool = False) -> torch.Tensor:
    """The level histogram in plain PyTorch: the reference's scatter-add
    (``trees/decision_tree._node_histogram``) with the tree dimension
    written out.  ``node`` (T, m) int, ``bx`` (m, n) int in [0, n_bins),
    ``w`` (T, m), ``stats`` (m, S) → (T, n_nodes, n, n_bins, S), f32 or
    f64 for f64 operands.  A row whose node is not in ``[0, n_nodes)`` is
    dropped, as the kernel and the reference's one-hot Pallas kernel drop
    it.  One tree at a time: one call over the whole forest would
    materialise T·m·n int64 indices (12.8 GB at the main path's deepest
    level) and their sort buffers.

    The default sums each cell in a fixed order, the port's rule for a
    float sum: each tree's (row, feature) items are keyed by their
    (node, feature, bin) cell, stably sorted (so a cell keeps row order)
    and summed by ``torch.segment_reduce`` over the sorted keys; the
    dropped rows' items go to a sink cell past the last.  Two calls give
    the same bits on any number of CPU threads.  ``integer=True`` is the
    caller's declaration that every ``w·stats`` is an integer and every
    sum stays below 2^24, so any order gives the same bits: each tree is
    then one ``index_put_(accumulate=True)``, with a dropped row's
    contribution made +0 (which leaves every sum's bits unchanged)."""
    T, m = node.shape
    n = bx.shape[1]
    S = stats.shape[1]
    dt = torch.promote_types(torch.float32,
                             torch.promote_types(w.dtype, stats.dtype))
    cells = n_nodes * n * n_bins
    out = torch.zeros((T, n_nodes, n, n_bins, S), dtype=dt,
                      device=stats.device)
    if m == 0:
        return out
    bins = bx.long()
    if integer:
        feat = torch.arange(n, device=bx.device)[None, :].expand(m, n)
    else:
        # the (feature, bin) part of each item's cell, shared by the trees
        fb = (torch.arange(n, device=bx.device)[None, :] * n_bins
              + bins).reshape(-1)
    for t in range(T):
        nt = node[t].long()
        kept = (nt >= 0) & (nt < n_nodes)
        contrib = torch.where(kept[:, None], (w[t, :, None] * stats).to(dt),
                              0.0)                            # (m, S)
        if integer:
            out[t].index_put_((nt.clamp(0, n_nodes - 1)[:, None]
                               .expand(m, n), feat, bins),
                              contrib[:, None, :].expand(m, n, S),
                              accumulate=True)
            continue
        cell = torch.where(kept, nt * (n * n_bins), cells)    # sink: cells
        key = cell.repeat_interleave(n) + fb                  # (m·n,)
        key, order = torch.sort(key, stable=True)
        lengths = torch.bincount(key, minlength=cells + n * n_bins)
        sums = torch.segment_reduce(contrib[order // n], "sum",
                                    lengths=lengths, axis=0)
        out[t] = sums[:cells].reshape(n_nodes, n, n_bins, S)
    return out


def node_histogram(node: torch.Tensor, bx: torch.Tensor, w: torch.Tensor,
                   stats: torch.Tensor, n_nodes: int, n_bins: int,
                   integer: bool = False) -> torch.Tensor:
    """The weighted (node, feature, bin) histogram of one tree level for
    every tree (reference: ``pallas_kernels.node_histogram``, vmapped over
    trees): ``out[t, p, f, b] = Σ w[t, i]·stats[i]`` over the rows ``i``
    with ``node[t, i] == p`` and ``bx[i, f] == b``; rows whose node is not
    in ``[0, n_nodes)`` are dropped.  CUDA operands: node and bx int32, w
    and stats float32, all contiguous, ``n_nodes ≤ HIST_MAX_NODES``.  One
    call launches the kernel's parts (partition count, scan and scatter,
    the histogram, and on the fixed-order path the sum of the partials)
    and counts as one launch in :data:`LAUNCHES`.

    How the sums are ordered is the caller's declaration: ``integer=True``
    says every ``w·stats`` is an integer and every sum stays below 2^24
    (the classifier's Poisson weights times one-hot classes).  Any order
    of the adds then gives the same bits, bit-equal to the plain version,
    and the kernel adds with shared and global atomics.  Otherwise (the
    default) the sums run in a fixed order (``hist_plan(...,
    fixed_order=True)``; ``csrc/node_histogram.cu``): the same inputs
    give the same bits on every call, within f32 rounding of the plain
    version's row-order sums.  On CPU tensors the plain version runs, with
the same declaration (:func:`node_histogram_plain`)."""
    if _on_cpu(node, bx, w, stats):
        return node_histogram_plain(node, bx, w, stats, n_nodes, n_bins,
                                    integer)
    _check_cuda("node_histogram", node, bx, w, stats)
    if node.dtype != torch.int32 or bx.dtype != torch.int32 \
            or w.dtype != torch.float32 or stats.dtype != torch.float32:
        raise TypeError(
            "node_histogram: the CUDA kernel takes int32 node and bx and "
            f"float32 w and stats, got {node.dtype}, {bx.dtype}, {w.dtype},"
            f" {stats.dtype}")
    (T, m), (m2, n), (S, ) = node.shape, bx.shape, stats.shape[1:]
    if w.shape != node.shape or m2 != m or stats.shape[0] != m:
        raise ValueError(
            f"node_histogram: shapes node {tuple(node.shape)}, bx "
            f"{tuple(bx.shape)}, w {tuple(w.shape)}, stats "
            f"{tuple(stats.shape)} do not share T and m")
    if n_nodes < 1 or n_bins < 1:
        raise ValueError(f"node_histogram: n_nodes {n_nodes} and n_bins "
                         f"{n_bins} must be positive")
    if n_nodes > HIST_MAX_NODES:
        raise ValueError(f"node_histogram: the CUDA kernel's partition "
                         f"holds at most {HIST_MAX_NODES} nodes, got "
                         f"{n_nodes}")
    shape = (T, n_nodes, n, n_bins, S)
    dev = node.device
    if m == 0 or 0 in shape:
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    plan = hist_plan(T, m, n, n_nodes, n_bins, S, torch.cuda
                     .get_device_properties(dev).multi_processor_count,
                     fixed_order=not integer)
    # every entry is stored by its item or the sum of its partials, or
    # zeroed by the partition first
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    scratch = torch.empty(hist_scratch_len(T, m, n_nodes, plan),
                          dtype=torch.int32, device=dev)
    slots = 0 if integer else hist_partial_slots(m, plan)
    partial = torch.empty((T, slots, n * n_bins * S) if slots else (0,),
                          dtype=torch.float32, device=dev)
    lib = _build.library("node_histogram")
    with torch.cuda.device(dev):
        rc = lib.dslib_node_histogram_f32(
            node.data_ptr(), bx.data_ptr(), w.data_ptr(), stats.data_ptr(),
            out.data_ptr(), scratch.data_ptr(),
            partial.data_ptr() if slots else None, T, m, n, n_nodes, n_bins,
            S, slots, *plan, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on_error("node_histogram", rc)
    LAUNCHES["node_histogram"] += 1
    return out
