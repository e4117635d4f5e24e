"""sklearn-style estimator plumbing: get_params / set_params / clone.

Counterpart of ``dislib_tpu/base.py``.  The reference's async-trial hooks
(``_fit_async`` and friends, used by GridSearchCV) are not ported in this
slice (ROADMAP.md A.8).  Its predict-parameter cache is: a plain cache of
device copies per device (``_predict_leaves``), and ``_classes_leaf``.
"""

from __future__ import annotations

import inspect
from copy import deepcopy

import numpy as np
import torch


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

    # -- device-resident predict parameters ----------------------------------

    def _predict_leaves(self, device, *host_arrays):
        """Copies of this model's predict-time parameters on ``device``,
        cached by the device and the identity of the attribute objects, so
        a warm predict moves no model bytes.  Each entry pins its arrays,
        which keeps the identity key sound; reassigning an attribute (a
        new fit) misses the cache."""
        device = torch.device(device)
        cache = getattr(self, "_predict_leaf_cache", None)
        if cache is None:
            cache = self._predict_leaf_cache = {}
        key = (str(device),) + tuple(id(h) for h in host_arrays)
        hit = cache.get(key)
        if hit is not None:
            return hit[1]
        dev = tuple(torch.as_tensor(h, device=device) for h in host_arrays)
        if len(cache) >= 16:              # a model has a handful of tuples
            cache.clear()
        cache[key] = (tuple(host_arrays), dev)      # [0] is the id pin
        return dev

    def _classes_leaf(self):
        """``classes_`` cast to the serving label dtype (int32 for integer
        classes, exact to 2^31 where float32 is not past 2^24, else
        float32), cached by the identity of ``classes_``."""
        cached = getattr(self, "_classes_cast_cache", None)
        if cached is None or cached[0] is not self.classes_:
            dt = np.int32 if np.issubdtype(self.classes_.dtype, np.integer) \
                else np.float32
            self._classes_cast_cache = (self.classes_,
                                        self.classes_.astype(dt))
        return self._classes_cast_cache[1]

    def __repr__(self):
        params = ", ".join(f"{k}={v!r}" for k, v in self.get_params().items())
        return f"{type(self).__name__}({params})"


def from_fitted_arrays(cls, arrays: dict, device=None, **params):
    """A fitted ``cls`` built from a fitted reference estimator's
    attributes, given as NumPy arrays under the reference's names, so both
    packages predict and transform with the same model.  Each estimator's
    ``_carry_in`` takes its own: a forest's ``_edges``, ``_feats``,
    ``_tbins``, ``_depth``, ``_leaves``, ``n_features_`` (and
    ``classes_``); GaussianMixture's ``weights_``, ``means_``,
    ``covariances_`` and ``covariance_type``; MiniBatchKMeans'
    ``centers_`` and ``counts_``; LinearRegression's ``coef_`` and
    ``intercept_``; Lasso's ``coef_``; StandardScaler's ``mean_`` and
    ``var_``; MinMaxScaler's ``data_min_`` and ``data_max_``.  ``params``
    go to the constructor.  Device-resident attributes land on ``device``
    (default: the default mesh's, ``cuda``)."""
    from dislib_tpu_torch.parallel import mesh as _mesh
    dev = _mesh.get_mesh().device if device is None else torch.device(device)
    est = cls(**params)
    est._carry_in(arrays, dev)
    return est


def clone(estimator):
    """Fresh unfitted copy with the same hyperparameters (sklearn.clone)."""
    return type(estimator)(**deepcopy(estimator.get_params()))
