"""ServePipeline — a fitted preprocessing + estimator chain as one CUDA
graph replay per served bucket.

Counterpart of ``dislib_tpu/serving/pipeline.py``.  The reference
linearizes the chain (scaler transform → estimator predict) through its
fusion layer into ONE cached XLA program per bucket.  The port has no
fusion graph; its counterpart is a CUDA graph, captured once per
(pipeline, bucket) at warmup over a static input and a static output
buffer, and replayed per batch.  The hot path on ``cuda`` is

    pinned staging buffer → async copy into the static input → ONE graph
    replay → ``runtime.fetch`` of the static output → slice

with no per-request capture, no pad kernel (the staging buffer is padded
on the host) and no model transfer (leaves are cached on the device per
model by ``BaseEstimator._predict_leaves``).

Whether a chain is captured is DECLARED, never found out by catching a
failed capture: every step's class lists the methods it may be captured
in (``BaseEstimator._capturable``).  A declared chain whose capture fails
raises at warmup, naming the step.  A chain with an undeclared step runs
eagerly on ``cuda``, and every chain runs eagerly on the CPU (the plain
versions of the kernels); an eager call counts its ATen operations and
hand-kernel launches as its dispatches (``"eager_chain"``), a replay
counts one (``"fused_chain"``).  :class:`BucketProgram` is the unit the
other served pipelines (``serving/sparse.py``, ``retrieval/serving.py``)
build on.
"""

from __future__ import annotations

import gc

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dislib_tpu_torch.data.array import Array, _padded_shape
from dislib_tpu_torch.ops import kernels as _k
from dislib_tpu_torch.parallel import mesh as _mesh
from dislib_tpu_torch.runtime.elastic import fetch as _fetch
from dislib_tpu_torch.serving.buckets import BucketTemplate
from dislib_tpu_torch.utils import profiling as _prof

# attributes probed, in order, to infer the feature width of a fitted
# model when the caller does not pass n_features explicitly
_FEATURE_ATTRS = ("centers_", "means_", "_sv_x")


def _infer_features(model, transforms):
    for t in transforms:
        # explicit None checks: `or` would probe ndarray truthiness
        m = getattr(t, "mean_", None)
        if m is None:
            m = getattr(t, "data_min_", None)
        if m is not None and hasattr(m, "shape"):
            return int(np.shape(m)[-1])
    for attr in _FEATURE_ATTRS:
        v = getattr(model, attr, None)
        if v is not None:
            return int(np.shape(v)[1])
    coef = getattr(model, "coef_", None)
    if coef is not None:
        return int(np.shape(coef)[0])
    nf = getattr(model, "n_features_", None)
    if nf is not None:
        return int(nf)
    raise ValueError(
        "could not infer the pipeline's feature width — pass "
        "n_features= to ServePipeline")


def declared(obj, method: str) -> bool:
    """Whether ``obj``'s class declares ``method`` capturable."""
    return method in getattr(type(obj), "_capturable", frozenset())


def _tensors_of(objs):
    """Every device tensor reachable from the attributes of ``objs``
    (ds-arrays' backings, tuples, lists and dict values two levels
    deep): the buffers a captured graph may read, which the program keeps
    alive."""
    out = []

    def walk(v, depth):
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, Array):
            out.append(v._data)
        elif depth and isinstance(v, (tuple, list)):
            for u in v:
                walk(u, depth - 1)
        elif depth and isinstance(v, dict):
            for u in v.values():
                walk(u, depth - 1)

    for o in objs:
        for v in getattr(o, "__dict__", {}).values():
            walk(v, 3)
    return out


class _OpCount(TorchDispatchMode):
    """Counts the ATen operations dispatched on this thread inside the
    block (an eager chain's dispatches)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


class BucketProgram:
    """One bucket's served program on one pipeline: its staging
    ``template`` (pinned on ``cuda``), the ``static_in`` device buffer
    and either a CUDA ``graph`` captured over it with its ``static_out``
    (``mode == "graph"``) or the chain run eagerly (``"eager"``, with
    the ``reason``).  ``kernels`` counts the hand kernels one replay
    launches, and ``label`` names the dispatch a replay counts
    (``"bundle_exec"`` for a loaded deployment bundle)."""

    __slots__ = ("bucket", "mode", "reason", "template", "static_in",
                 "graph", "static_out", "kernels", "label", "_chain",
                 "_pinned")

    def __init__(self, bucket, template, static_in, chain, mode="eager",
                 reason=None, graph=None, static_out=None, kernels=None,
                 pinned=()):
        self.bucket = int(bucket)
        self.template = template
        self.static_in = static_in
        self._chain = chain
        self.mode = mode
        self.reason = reason
        self.graph = graph
        self.static_out = static_out
        self.kernels = dict(kernels or {})
        self.label = "fused_chain"
        self._pinned = pinned

    def replay_device(self) -> torch.Tensor:
        """One replay on the current stream, unsynchronised (no staging,
        no fetch): the device half of :meth:`run`, for timing."""
        self.graph.replay()
        _k.add_launches(self.kernels)
        _prof.count_dispatch(self.label)
        return self.static_out

    def eager_device(self) -> torch.Tensor:
        """The chain run eagerly on the static input (the reference a
        replay is held against, and the eager program's device half)."""
        with _OpCount() as ops, _k.recording_launches() as rec:
            out = self._chain(self.static_in)
        _prof.count_dispatch("eager_chain", ops.n + sum(rec.values()))
        return out

    def run(self) -> np.ndarray:
        """Copy the filled template in, run, fetch the padded output."""
        src = self.template.tensor
        if src is None:
            src = torch.from_numpy(self.template.buf)
        self.static_in.copy_(src, non_blocking=src.is_pinned())
        out = self.replay_device() if self.mode == "graph" \
            else self.eager_device()
        return _fetch(out)


def build_program(bucket, pshape, chain, objs, steps, where,
                  step_of=lambda: "?"):
    """Warm and, where declared, capture one bucket's program.

    ``chain(x_static) -> tensor`` is the device work; ``objs`` the objects
    whose tensors it reads (kept alive with the graph); ``steps`` a list
    of ``(name, declared)`` per step; ``where`` names the pipeline in
    errors, and ``step_of()`` the step a failed capture was in.  The
    eager warm run comes first: it builds the kernels and copies the
    model's leaves to the device, which may not happen inside a
    capture."""
    dev = _mesh.get_mesh().device
    cuda = dev.type == "cuda"
    template = BucketTemplate(pshape, pinned=cuda)
    static_in = torch.zeros(pshape, dtype=torch.float32, device=dev)
    chain(static_in)                        # the eager warm run
    undeclared = [name for name, ok in steps if not ok]
    if not cuda or undeclared:
        reason = "cpu: the plain versions run eagerly" if not cuda else \
            "not declared capturable: " + ", ".join(undeclared)
        return BucketProgram(bucket, template, static_in, chain,
                             reason=reason)
    with torch.cuda.device(dev):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            chain(static_in)                # warm the capture stream
        torch.cuda.current_stream().wait_stream(side)
        side.synchronize()
        graph = torch.cuda.CUDAGraph()
        # no garbage collection inside the capture: a collected cycle may
        # free a pinned buffer (an earlier program's staging template),
        # and the host allocator's event calls invalidate the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with _k.recording_launches(capturing=True) as kernels:
                with torch.cuda.graph(graph, stream=side,
                                      capture_error_mode="thread_local"):
                    out = chain(static_in)
        except Exception as exc:
            raise RuntimeError(
                f"{where}: capturing bucket {bucket} failed in "
                f"{step_of()} ({type(exc).__name__}: {exc}) — the step is "
                "declared capturable (_capturable), so its device work "
                "must hold no host read, host → device copy or "
                "data-dependent shape once warm") from exc
        finally:
            if collecting:
                gc.enable()
    _prof.count_trace("cuda_graph")
    return BucketProgram(bucket, template, static_in, chain, mode="graph",
                         graph=graph, static_out=out, kernels=kernels,
                         pinned=_tensors_of(objs))


class ProgramHost:
    """The per-bucket program table and the ``predict_bucket`` hot path
    shared by the served pipelines.  A subclass gives ``n_features``,
    ``_pshape(bucket)``, ``_chain(x_static, bucket)``, ``_objs()``,
    ``_steps()`` and ``_check(rows, bucket)``."""

    _where = "pipeline"

    def _init_programs(self):
        self._programs: dict[int, BucketProgram] = {}
        self._step = "?"

    def _pshape(self, bucket: int):
        return (int(bucket), self.n_features)

    def program(self, bucket: int) -> BucketProgram:
        """The bucket's program, warmed (and captured) at first use."""
        bucket = int(bucket)
        prog = self._programs.get(bucket)
        if prog is None:
            prog = self._programs[bucket] = build_program(
                bucket, self._pshape(bucket),
                lambda xin, _b=bucket: self._chain(xin, _b), self._objs(),
                self._steps(), self._where, lambda: self._step)
        return prog

    def _check_rows(self, rows, bucket: int) -> np.ndarray:
        rows = np.asarray(rows, np.float32)
        if rows.ndim == 1:
            rows = rows.reshape(1, -1)
        self._check(rows)
        if rows.shape[0] > bucket:
            raise ValueError(f"{rows.shape[0]} rows exceed bucket {bucket}")
        return rows

    def predict_bucket(self, rows: np.ndarray, bucket: int) -> np.ndarray:
        """Serve one batch padded into ``bucket``: the logical
        (n_rows, out_cols) host result.  The one-dispatch hot path:
        stage, copy in, replay, fetch, slice."""
        rows = self._check_rows(rows, bucket)
        prog = self.program(bucket)
        prog.template.fill(rows)
        host = prog.run()
        return host[: rows.shape[0], : self.out_cols]


class ServePipeline(ProgramHost):
    """A fitted chain ``transforms → model.<method>`` served per bucket as
    one CUDA-graph replay (eagerly where not declared capturable, and on
    the CPU).

    Parameters
    ----------
    model : fitted estimator — its ``method`` (default ``"predict"``)
        must return a ds-array.
    transforms : sequence of fitted transformers applied in order
        (``.transform``), e.g. a StandardScaler.
    method : str — the model entry point: ``"predict"``,
        ``"predict_proba"``, ...
    n_features : int — request feature width; inferred from the fitted
        attributes when omitted.

    A captured graph reads the model's device tensors at the addresses
    they had at capture; the program keeps them alive, so refitting the
    model in place leaves the pipeline serving the captured model.  Not
    thread-safe: the serving worker (or one caller) drives it.
    """

    _where = "ServePipeline"

    def __init__(self, model, transforms=(), method="predict",
                 n_features=None):
        self.model = model
        self.transforms = tuple(transforms)
        self.method = method
        self.n_features = int(n_features) if n_features is not None \
            else _infer_features(model, self.transforms)
        self.out_cols: int | None = None    # discovered at first warm
        self._init_programs()

    def __call__(self, x: Array) -> Array:
        for t in self.transforms:
            x = t.transform(x)
        return getattr(self.model, self.method)(x)

    def _pshape(self, bucket: int):
        return _padded_shape((bucket, self.n_features),
                             _mesh.pad_quantum())

    def _steps(self):
        return [(f"{type(t).__name__}.transform", declared(t, "transform"))
                for t in self.transforms] + [
            (f"{type(self.model).__name__}.{self.method}",
             declared(self.model, self.method))]

    def _objs(self):
        return self.transforms + (self.model,)

    def _chain(self, xin: torch.Tensor, bucket: int) -> torch.Tensor:
        x = Array(xin, (bucket, self.n_features), _mesh.get_mesh())
        for t in self.transforms:
            self._step = f"{type(t).__name__}.transform"
            x = t.transform(x)
        self._step = f"{type(self.model).__name__}.{self.method}"
        out = getattr(self.model, self.method)(x)
        self.out_cols = out.shape[1]
        return out._data

    def _check(self, rows):
        if rows.shape[1] != self.n_features:
            raise ValueError(f"request has {rows.shape[1]} features, "
                             f"pipeline serves {self.n_features}")

    # -- deployment-bundle capture ------------------------------------------

    def capture_bucket(self, bucket: int) -> dict:
        """What :func:`~dislib_tpu_torch.serving.bundle.export_bundle`
        stores for ``bucket``, WITHOUT executing the chain: the ``spec``
        (each step's class, hyperparameters and fitted attributes in the
        ``save_model`` encoding, with every array as a leaf index), the
        ``leaves`` as NumPy (the request canvas at ``input_slot``, then
        the steps' arrays), ``out_cols`` (None before the first warm) and
        the padded ``pshape``.  ``load_bundle`` rebuilds the chain from
        them (:meth:`_from_capture`) and captures its graphs."""
        from dislib_tpu_torch.utils.saving import _estimator_state
        pshape = self._pshape(bucket)
        leaves = [np.zeros(pshape, np.float32)]
        steps = [_estimator_state(s, leaves)
                 for s in self.transforms + (self.model,)]
        return {"spec": {"kind": "serve", "method": self.method,
                         "n_features": self.n_features, "steps": steps},
                "leaves": leaves, "input_slot": 0,
                "out_cols": self.out_cols, "pshape": list(pshape)}

    @classmethod
    def _from_capture(cls, spec, leaves):
        """The pipeline a :meth:`capture_bucket` spec describes, on the
        default mesh's device."""
        from dislib_tpu_torch.utils.saving import _estimator_restore
        steps = [_estimator_restore(s, None, leaves) for s in spec["steps"]]
        return cls(steps[-1], transforms=steps[:-1], method=spec["method"],
                   n_features=spec["n_features"])
