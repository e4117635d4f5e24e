"""Model selection (counterpart of ``dislib_tpu/model_selection``)."""

from dislib_tpu_torch.model_selection.split import KFold
from dislib_tpu_torch.model_selection.search import GridSearchCV, \
    RandomizedSearchCV

__all__ = ["KFold", "GridSearchCV", "RandomizedSearchCV"]
