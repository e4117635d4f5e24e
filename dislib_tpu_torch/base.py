"""sklearn-style estimator plumbing: get_params / set_params / clone.

Counterpart of ``dislib_tpu/base.py``.  The reference's async-trial hooks
(``_fit_async`` and friends, used by GridSearchCV) and its device-resident
predict-parameter cache are not ported in this slice (ROADMAP.md A.8).
"""

from __future__ import annotations

import inspect
from copy import deepcopy


class BaseEstimator:
    """Minimal sklearn-compatible base: constructor args are
    hyperparameters."""

    @classmethod
    def _param_names(cls):
        sig = inspect.signature(cls.__init__)
        return [p.name for p in sig.parameters.values()
                if p.name != "self"
                and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]

    def get_params(self, deep: bool = True) -> dict:
        return {name: getattr(self, name) for name in self._param_names()
                if hasattr(self, name)}

    def set_params(self, **params):
        valid = set(self._param_names())
        for k, v in params.items():
            if k not in valid:
                raise ValueError(f"invalid parameter {k!r} for "
                                 f"{type(self).__name__}")
            setattr(self, k, v)
        return self

    def __repr__(self):
        params = ", ".join(f"{k}={v!r}" for k, v in self.get_params().items())
        return f"{type(self).__name__}({params})"


def clone(estimator):
    """Fresh unfitted copy with the same hyperparameters (sklearn.clone)."""
    return type(estimator)(**deepcopy(estimator.get_params()))
