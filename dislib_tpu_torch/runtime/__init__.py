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
  layer's only way to read a model (``adoption.py``);
- **bundle_io** — the deployment bundle's byte seam: atomic
  checksum-embedding writes and verified reads, the typed
  :class:`BundleIncompatible` and :class:`BundleShardCorrupt`
  (``bundle_io.py``; ``serving.bundle`` assembles the artifact);
- **trainer** — :class:`ContinuousTrainer`, train → bundle → canary →
  promote with every seam surviving its faults, and
  :class:`PromotionFailed` (``trainer.py``).

Snapshots live with their format in ``dislib_tpu_torch.utils.checkpoint``;
the fault injectors in ``dislib_tpu_torch.utils.faults``.  Not ported yet:
the capacity level, the coordination ledger and membership, and
``repad_rows`` (ROADMAP.md A.11).  ``xla_flags`` and ``compat`` get no
port: they set and patch JAX's own flags and APIs.
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
from dislib_tpu_torch.runtime.bundle_io import (BundleIncompatible,
                                                BundleShardCorrupt,
                                                read_bundle, write_bundle)
from dislib_tpu_torch.runtime.trainer import (ContinuousTrainer,
                                              PromotionFailed)

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
    "BundleIncompatible", "BundleShardCorrupt", "read_bundle",
    "write_bundle", "ContinuousTrainer", "PromotionFailed",
    "health",
]
