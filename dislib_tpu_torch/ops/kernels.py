"""The port's hand-written CUDA kernels and their plain PyTorch versions.

Counterpart of ``dislib_tpu/ops/pallas_kernels.py``:

- :func:`panel_gemm` — SUMMA's panel GEMM (``csrc/panel_gemm.cu``);
- :func:`distances_sq` — ‖a‖² − 2a·bᵀ + ‖b‖² clamped at zero
  (``csrc/distances_sq.cu``), the KMeans E-step, predict and score;
- :func:`node_histogram` — the forest's per-level weighted (node, feature,
  bin) histogram, for every tree in one launch (``csrc/node_histogram.cu``).

Each wrapper takes its plain version ONLY when the operands are CPU
tensors — the CPU tests run that way.  On CUDA tensors it checks device,
dtype, shape and contiguity, launches on the current stream, checks the
launch's return code, and raises on anything the kernel does not take.
There is no fallback from a CUDA tensor to the plain version.

:data:`LAUNCHES` counts kernel launches per wrapper, so a run can show that
its main path went through the kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dislib_tpu_torch import _build
from dislib_tpu_torch.ops import precision as px

#: kernel launches per wrapper (plain-version calls are not counted)
LAUNCHES = {"panel_gemm": 0, "distances_sq": 0, "node_histogram": 0}

_INT_MAX = 2**31 - 1
# grid.y of panel_gemm tiles the columns in 128s; 65535 is CUDA's limit
_GEMM_MAX_N = 65535 * 128
# precisions the f32 kernel implements: None inherits the scope, and on
# this kernel every scope is f32 FMA, the float32-faithful contraction
_F32_PRECISIONS = (None, "highest", "float32")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _check_cuda(name, *ts):
    dev = ts[0].device
    for t in ts:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"{name}: operands must all be CPU tensors (plain version) "
                f"or all on one CUDA device (kernel); got "
                f"{[str(x.device) for x in ts]}")
        if t.dim() != 2:
            raise ValueError(f"{name}: operands must be 2-D, got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes row-major "
                             "contiguous operands; call .contiguous()")
        if any(s > _INT_MAX for s in t.shape):
            raise ValueError(f"{name}: dimension too large for the kernel's "
                             f"32-bit sizes: {tuple(t.shape)}")


def _raise_on_error(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError_t {rc}")


# ---------------------------------------------------------------------------
# panel_gemm
# ---------------------------------------------------------------------------

def panel_gemm_plain(a: torch.Tensor, b: torch.Tensor,
                     policy: px.Policy = px.FLOAT32) -> torch.Tensor:
    """``A @ B`` in plain PyTorch: :func:`~px.pdot`'s contract — operands
    rounded to the policy compute dtype, f32 accumulation (f64 for f64
    operands under the float32 floor), output the accumulation dtype."""
    return px.pdot(a, b, policy)


def panel_gemm(a: torch.Tensor, b: torch.Tensor,
               policy: px.Policy = px.FLOAT32) -> torch.Tensor:
    """``A @ B`` — the SUMMA panel GEMM (reference:
    ``pallas_kernels.panel_gemm``).  The wrapper rounds the operands with
    ``to_compute(policy)`` and allocates the float32 output; the kernel
    accumulates in f32 FMA.  A float64 CUDA operand raises ``TypeError``
    (the plain version keeps f64)."""
    if _on_cpu(a, b):
        return panel_gemm_plain(a, b, policy)
    _check_cuda("panel_gemm", a, b)
    a = px.to_compute(a, policy)
    b = px.to_compute(b, policy)
    if a.dtype != b.dtype or a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(
            f"panel_gemm: the CUDA kernel takes float32 or bfloat16 "
            f"operands of one dtype after the {policy.name} policy's "
            f"rounding, got {a.dtype} and {b.dtype}")
    (m, k), (k2, n) = a.shape, b.shape
    if k != k2:
        raise ValueError(f"panel_gemm: inner dimensions differ: "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if n > _GEMM_MAX_N:
        raise ValueError(f"panel_gemm: n = {n} exceeds the kernel's grid "
                         f"limit {_GEMM_MAX_N}")
    out = torch.empty((m, n), dtype=px.accum_dtype(policy), device=a.device)
    if m == 0 or n == 0:
        return out
    lib = _build.library("panel_gemm")
    fn = lib.dslib_panel_gemm_f32 if a.dtype == torch.float32 \
        else lib.dslib_panel_gemm_bf16
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on_error("panel_gemm", rc)
    LAUNCHES["panel_gemm"] += 1
    return out


# ---------------------------------------------------------------------------
# distances_sq
# ---------------------------------------------------------------------------

def check_precision(precision) -> None:
    """The distance kernels implement the float32-faithful contraction
    only; the bf16-operand variant (KMeans ``fast_distance``) is
    ROADMAP.md A.6."""
    if precision not in _F32_PRECISIONS:
        raise NotImplementedError(
            f"distances_sq precision={precision!r}: the port implements "
            f"{_F32_PRECISIONS} (float32-faithful); the bf16-operand "
            "variant is ROADMAP.md A.6")


def distances_sq_plain(a: torch.Tensor, b: torch.Tensor,
                       precision=None) -> torch.Tensor:
    """Pairwise squared euclidean distances (m, k) in plain PyTorch: one
    GEMM and two row norms, ``max(‖a‖² − 2a·bᵀ + ‖b‖², 0)``, in the
    operands' promoted float dtype."""
    check_precision(precision)
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


def distances_sq(a: torch.Tensor, b: torch.Tensor,
                 precision=None) -> torch.Tensor:
    """Pairwise squared euclidean distances of the rows of ``a`` (m, d)
    and ``b`` (k, d), clamped at zero (reference:
    ``pallas_kernels.distances_sq``).  ``precision`` ∈ {None,
    ``"highest"``, ``"float32"``}: the kernel's cross term is always f32
    FMA.  CUDA operands must be float32."""
    if _on_cpu(a, b):
        return distances_sq_plain(a, b, precision)
    check_precision(precision)
    _check_cuda("distances_sq", a, b)
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
    lib = _build.library("distances_sq")
    with torch.cuda.device(a.device):
        rc = lib.dslib_distances_sq_f32(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, d,
            torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on_error("distances_sq", rc)
    LAUNCHES["distances_sq"] += 1
    return out


# ---------------------------------------------------------------------------
# node_histogram
# ---------------------------------------------------------------------------

#: threads of a node_histogram block (``THREADS`` in the source)
_HIST_THREADS = 1024
#: shared memory one node_histogram block may use (Hopper allows 227 KB)
HIST_SMEM_BYTES = 200 * 1024
# a chunk of rows is at least this long, so that zeroing and writing out a
# block's shared histogram stays small against its adds
_HIST_MIN_ROWS = 8 * _HIST_THREADS


class HistPlan(NamedTuple):
    """How one ``node_histogram`` launch cuts its work into items of
    (tree, feature group, slice, row chunk); see ``csrc/node_histogram.cu``.
    """
    fg: int               # features per item
    slice_len: int        # (node, bin, stat) entries per feature per item
    n_slices: int
    n_fgroups: int
    n_chunks: int
    rows_per_chunk: int
    direct: int           # 1: one chunk, items store; 0: atomics into zeros


def hist_plan(T, m, n, n_nodes, n_bins, S, n_sms,
              smem_bytes=HIST_SMEM_BYTES) -> HistPlan:
    """The work items of one launch.  A feature's histogram has
    ``n_nodes·n_bins·S`` entries; the slice is all of them when they fit
    in ``smem_bytes`` (and then as many features share a block as fit),
    else the entries are cut into slices.  Row chunks are added until
    there are about eight items per SM."""
    cap = smem_bytes // 4
    per_feat = n_nodes * n_bins * S
    slice_len = min(per_feat, cap)
    fg = max(1, min(n, cap // slice_len))
    n_slices = -(-per_feat // slice_len)
    n_fgroups = -(-n // fg)
    want = -(-8 * n_sms // (T * n_fgroups * n_slices))
    n_chunks = max(1, min(want, -(-m // _HIST_MIN_ROWS)))
    rows = -(-m // n_chunks)
    n_chunks = -(-m // rows)                     # no empty chunk
    plan = HistPlan(fg, slice_len, n_slices, n_fgroups, n_chunks, rows,
                    int(n_chunks == 1))
    if max(plan) > _INT_MAX:
        raise ValueError(f"node_histogram: plan {plan} exceeds the "
                         "kernel's 32-bit sizes")
    return plan


def node_histogram_plain(node: torch.Tensor, bx: torch.Tensor,
                         w: torch.Tensor, stats: torch.Tensor,
                         n_nodes: int, n_bins: int) -> torch.Tensor:
    """The level histogram in plain PyTorch: the reference's scatter-add
    (``trees/decision_tree._node_histogram``) with the tree dimension
    written out.  ``node`` (T, m) int, ``bx`` (m, n) int in [0, n_bins),
    ``w`` (T, m), ``stats`` (m, S) → (T, n_nodes, n, n_bins, S), f32 or
    f64 for f64 operands.  Each tree's ``w·stats`` is formed by one
    multiply and added with one ``index_put_(accumulate=True)``: one call
    over the whole forest would materialise T·m·n int64 indices (12.8 GB
    at the main path's deepest level) and their sort buffers."""
    T, m = node.shape
    n = bx.shape[1]
    S = stats.shape[1]
    dt = torch.promote_types(torch.float32,
                             torch.promote_types(w.dtype, stats.dtype))
    out = torch.zeros((T, n_nodes, n, n_bins, S), dtype=dt,
                      device=stats.device)
    feat = torch.arange(n, device=bx.device)[None, :].expand(m, n)
    bins = bx.long()
    for t in range(T):
        contrib = (w[t, :, None] * stats).to(dt)              # (m, S)
        out[t].index_put_((node[t].long()[:, None].expand(m, n), feat, bins),
                          contrib[:, None, :].expand(m, n, S),
                          accumulate=True)
    return out


def node_histogram(node: torch.Tensor, bx: torch.Tensor, w: torch.Tensor,
                   stats: torch.Tensor, n_nodes: int,
                   n_bins: int) -> torch.Tensor:
    """The weighted (node, feature, bin) histogram of one tree level for
    every tree (reference: ``pallas_kernels.node_histogram``, vmapped over
    trees): ``out[t, p, f, b] = Σ w[t, i]·stats[i]`` over the rows ``i``
    with ``node[t, i] == p`` and ``bx[i, f] == b``.  CUDA operands: node
    and bx int32, w and stats float32, all contiguous.  Bit-equal to the
    plain version when every ``w·stats`` is an integer and every sum stays
    below 2^24; otherwise the atomics' order varies from run to run."""
    if _on_cpu(node, bx, w, stats):
        return node_histogram_plain(node, bx, w, stats, n_nodes, n_bins)
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
    shape = (T, n_nodes, n, n_bins, S)
    if m == 0 or 0 in shape:
        return torch.zeros(shape, dtype=torch.float32, device=node.device)
    plan = hist_plan(T, m, n, n_nodes, n_bins, S, torch.cuda
                     .get_device_properties(node.device).multi_processor_count)
    out = torch.empty(shape, dtype=torch.float32, device=node.device) \
        if plan.direct else torch.zeros(shape, dtype=torch.float32,
                                        device=node.device)
    lib = _build.library("node_histogram")
    with torch.cuda.device(node.device):
        rc = lib.dslib_node_histogram_f32(
            node.data_ptr(), bx.data_ptr(), w.data_ptr(), stats.data_ptr(),
            out.data_ptr(), T, m, n, n_nodes, n_bins, S, *plan,
            torch.cuda.current_stream(node.device).cuda_stream)
    _raise_on_error("node_histogram", rc)
    LAUNCHES["node_histogram"] += 1
    return out
