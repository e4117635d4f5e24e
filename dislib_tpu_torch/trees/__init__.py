"""Trees (counterpart of ``dislib_tpu/trees``)."""

from dislib_tpu_torch.trees.forest import (
    RandomForestClassifier, RandomForestRegressor,
    DecisionTreeClassifier, DecisionTreeRegressor, from_fitted_arrays,
)

__all__ = [
    "RandomForestClassifier", "RandomForestRegressor",
    "DecisionTreeClassifier", "DecisionTreeRegressor", "from_fitted_arrays",
]
