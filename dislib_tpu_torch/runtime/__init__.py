"""Runtime layer (counterpart of ``dislib_tpu/runtime``), its one-process
part:

- **preemption** — the SIGTERM/sentinel-file watcher and the
  :class:`Preempted` contract checkpointed fits honour at chunk
  boundaries (``preemption.py``);
- **retry** — transient-vs-fatal classified retries with backoff
  (``retry.py``);
- **elastic** — :func:`fetch` / :class:`AsyncFetch`, the device→host
  reads of snapshots and health checks (``elastic.py``);
- **health** — fused numerical-health guards, the chunk watchdog,
  verdict-gated snapshots and rollback remediation (``health.py``);
- **fitloop** — :class:`ChunkedFitLoop`, the driver every iterative fit
  runs on (``fitloop.py``);
- **loop** — ``run_chunked``, the masked device loop inside one chunk,
  which stands for the reference's ``lax.while_loop`` (``loop.py``);
- **adoption** — the gated read side of model hot-swap:
  :func:`adopt_latest` over a rotating ``FitCheckpoint``, the serving
  layer's only way to read a model (``adoption.py``).

Snapshots live with their format in ``dislib_tpu_torch.utils.checkpoint``;
the fault injectors in ``dislib_tpu_torch.utils.faults``.  Not ported yet:
the capacity level, the coordination ledger and membership, and
``repad_rows`` (ROADMAP.md A.11); deployment bundles and the continuous
trainer (A.12's deployment half); ``xla_flags`` (JAX's).
"""

from dislib_tpu_torch.runtime import health  # noqa: F401
from dislib_tpu_torch.runtime.elastic import AsyncFetch, fetch
from dislib_tpu_torch.runtime.health import (ChunkGuard, HealthPolicy,
                                             NumericalDivergence,
                                             WatchdogTimeout)
from dislib_tpu_torch.runtime.preemption import (
    Preempted, PreemptionWatcher, clear_preemption, last_signal,
    preemption_requested, raise_if_preempted, request_preemption,
)
from dislib_tpu_torch.runtime.retry import Retry, is_transient_error, \
    retry_call
from dislib_tpu_torch.runtime.fitloop import (ChunkedFitLoop, ChunkOutcome,
                                              Escalation, EscalationLadder,
                                              LoopState)
from dislib_tpu_torch.runtime.adoption import (Adoption, AdoptionRejected,
                                               adopt_latest,
                                               generation_token)

__all__ = [
    "Preempted", "PreemptionWatcher", "preemption_requested",
    "request_preemption", "clear_preemption", "last_signal",
    "raise_if_preempted",
    "Retry", "retry_call", "is_transient_error",
    "fetch", "AsyncFetch",
    "HealthPolicy", "ChunkGuard", "NumericalDivergence", "WatchdogTimeout",
    "ChunkedFitLoop", "ChunkOutcome", "LoopState", "Escalation",
    "EscalationLadder",
    "Adoption", "AdoptionRejected", "adopt_latest", "generation_token",
    "health",
]
