"""Utilities (counterpart of ``dislib_tpu/utils``): ``shuffle`` and
``train_test_split``, model saving, mid-fit checkpointing
(:class:`FitCheckpoint`), host-read accounting, the counters and tracing
(``profiling``), the fault injectors (``faults``) and the ``dslib.*``
loggers.  ``profiled_jit`` and ``op_graph`` are JAX's and have no port;
``trace_count`` counts the port's CUDA-graph captures and kernel builds."""

from dislib_tpu_torch.utils.base import shuffle, train_test_split
from dislib_tpu_torch.utils.checkpoint import FitCheckpoint
from dislib_tpu_torch.utils.profiling import (
    annotate, counters, dispatch_count, memory_stats, reset_counters,
    start_trace, stop_trace, trace, trace_count,
)
from dislib_tpu_torch.utils.saving import save_model, load_model

__all__ = ["shuffle", "train_test_split", "save_model", "load_model",
           "FitCheckpoint", "annotate", "counters", "dispatch_count",
           "memory_stats", "reset_counters", "start_trace", "stop_trace",
           "trace", "trace_count"]
