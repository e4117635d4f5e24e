"""dislib_tpu_torch.serving — the low-latency predict path on one card.

Counterpart of ``dislib_tpu/serving``.  One served batch costs one
CUDA-graph replay, from pieces that compose:

- **padded batch buckets** (``buckets.py``) — requests pad to a small
  ladder of fixed row counts (default 1/8/64/512,
  ``DSLIB_SERVE_BUCKETS``), so the serving lifetime touches a handful of
  shapes, all captured at warmup.  Predict is row-independent, so padded
  rows never affect real rows; their outputs are sliced away.
- **one-replay pipelines** (``pipeline.py``) — a scaler → estimator chain
  declared capturable is captured into ONE CUDA graph per bucket over a
  static input and output; the hot path is a pinned staging copy, one
  replay and one fetch.
- **program cache** (``cache.py``) — the (model generation, bucket)
  ledger of warmed programs: a generation serves only after every bucket
  is warmed and health-gated, so the request path never captures, never
  builds a kernel and never meets an unvalidated model.
- **micro-batching + hot-swap** (``server.py`` / ``hotswap.py``) —
  queued requests coalesce into the smallest covering bucket under a
  latency deadline (``DSLIB_SERVE_DEADLINE_MS``), and the served model
  follows a rotating ``FitCheckpoint`` through the ``runtime.adoption``
  gate: serve generation N while N+1 trains, adopting N+1 only after its
  checksum verifies and its warmup predict passes the health guard.
- **sparse fold-in serving** (``sparse.py``) — recommender requests as
  padded sparse ``[cols | vals]`` rows, one replay of the ALS fold-in a
  batch.
- **multi-tenant routing** (``router.py``) — ``ModelRouter`` maps
  tenants onto shared servers, with per-tenant quotas
  (``TenantQuotaExceeded`` sheds only the offender), canary/A-B hashing
  and a health-gated ``promote``.
- **deployment bundles** (``bundle.py``) — ``export_bundle`` writes a
  served pipeline as ONE checksummed artifact: the kernel libraries'
  bytes, the pipeline's spec and leaves, the ladder and the model state;
  ``load_bundle`` in a fresh process installs the libraries (no
  ``nvcc``), rebuilds the pipeline and captures every bucket before it
  returns — the first request is a replay.

IVF retrieval serves through ``retrieval.RetrievalPipeline`` on the same
server.
"""

from dislib_tpu_torch.serving.buckets import (DEFAULT_BUCKETS,
                                              BucketLadderError, bucket_for,
                                              bucket_ladder, split_rows)
from dislib_tpu_torch.serving.cache import ProgramCache
from dislib_tpu_torch.serving.hotswap import ModelPool
from dislib_tpu_torch.serving.pipeline import ServePipeline
from dislib_tpu_torch.serving.router import (DeadlineShed, ModelRouter,
                                             TenantQuotaExceeded)
from dislib_tpu_torch.serving.server import (PredictServer, QueueFull,
                                             ServeResponse, ShardDrained)
from dislib_tpu_torch.serving.sparse import (SparseFoldInPipeline,
                                             pack_sparse_rows)
from dislib_tpu_torch.serving.bundle import (BundlePipeline, LoadedBundle,
                                             export_bundle, load_bundle,
                                             runtime_fingerprint)

__all__ = [
    "DEFAULT_BUCKETS", "BucketLadderError", "bucket_ladder", "bucket_for",
    "split_rows",
    "ProgramCache", "ServePipeline", "PredictServer", "ServeResponse",
    "QueueFull", "ShardDrained", "ModelPool",
    "SparseFoldInPipeline", "pack_sparse_rows",
    "export_bundle", "load_bundle", "BundlePipeline", "LoadedBundle",
    "runtime_fingerprint",
    "ModelRouter", "TenantQuotaExceeded", "DeadlineShed",
]
