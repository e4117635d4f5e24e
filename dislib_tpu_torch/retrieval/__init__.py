"""Vector retrieval (counterpart of ``dislib_tpu/retrieval``): the IVF
approximate nearest-neighbour index on one card, and its serving
pipeline (``RetrievalPipeline``, ``[ids | scores]`` rows through the
``serving`` bucket ladder, one CUDA-graph replay a batch)."""

from dislib_tpu_torch.retrieval.ivf import IVFIndex
from dislib_tpu_torch.retrieval.serving import RetrievalPipeline

__all__ = ["IVFIndex", "RetrievalPipeline"]
