"""Vector retrieval (counterpart of ``dislib_tpu/retrieval``): the IVF
approximate nearest-neighbour index on one card.  The reference's serving
pipeline (``RetrievalPipeline``, ``retrieval/serving.py``) is not ported
yet: it comes after ``serving/server.py`` (ROADMAP.md A.12's serving
half)."""

from dislib_tpu_torch.retrieval.ivf import IVFIndex

__all__ = ["IVFIndex"]
