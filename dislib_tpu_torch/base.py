"""sklearn-style estimator plumbing: get_params / set_params / clone.

Counterpart of ``dislib_tpu/base.py``, with its async-trial protocol
(``_fit_async``, ``_fit_finalize``, ``_score_async``: ``model_selection``
dispatches every trial of a fold before it reads a score) and its
predict-parameter cache: a plain cache of device copies per device
(``_predict_leaves``), and ``_classes_leaf``.  ``_fitted_attrs`` names
what ``utils/saving.save_model`` writes, and :func:`from_fitted_arrays`
is how ``load_model`` (and the parity tests) build a fitted estimator.
"""

from __future__ import annotations

import inspect
from copy import deepcopy

import numpy as np
import torch

#: classes already reported as lacking an async fit path (notice once each)
_ASYNC_FALLBACK_NOTICED: set = set()


class BaseEstimator:
    """Minimal sklearn-compatible base: constructor args are
    hyperparameters."""

    #: extra (leading-underscore) fitted state a subclass needs persisted by
    #: ``save_model`` beyond the trailing-underscore convention
    _private_fitted_attrs: tuple = ()

    #: methods whose device work on a dense ds-array, once warm (kernels
    #: built, leaves on the device), has no host read, no host → device
    #: copy and no data-dependent shape: ``serving`` captures a chain of
    #: them in one CUDA graph a bucket, and runs any other chain eagerly
    _capturable: frozenset = frozenset()

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

    def _fitted_attrs(self) -> dict:
        out = {k: v for k, v in vars(self).items()
               if k.endswith("_") and not k.startswith("_")}
        for k in self._private_fitted_attrs:
            if hasattr(self, k):
                out[k] = getattr(self, k)
        return out

    # -- async trial protocol (GridSearchCV submits all fits of a fold
    # before waiting on any; estimators opt in by overriding these) ----------

    def _fit_async(self, x, y=None):
        """Enqueue this estimator's fit without reading device values back
        to the host, returning an opaque state handle for
        `_fit_finalize`/`_score_async`.  The default falls back to the
        synchronous `fit` and returns None (the card still runs the fits'
        kernels back to back; only the reads a fit makes serialise).  The
        fallback is logged once per class, so a search that serialises is
        visible."""
        cls = type(self).__name__
        if cls not in _ASYNC_FALLBACK_NOTICED:
            _ASYNC_FALLBACK_NOTICED.add(cls)
            from dislib_tpu_torch.utils.dlog import get_logger
            get_logger("search").info(
                "%s does not implement _fit_async; search trials over it run "
                "synchronous fits (device work still overlaps, cross-trial "
                "pipelining of host reads is lost)", cls)
        self.fit(x, y) if y is not None else self.fit(x)
        return None

    def _fit_finalize(self, state):
        """Set the fitted attributes from an async state handle (no-op for
        the synchronous fallback)."""

    def _score_async(self, state, x, y=None):
        """Score a trial from its async state; may return a device scalar,
        which the caller reads only after the next fold is dispatched.  The
        fallback sets the fitted attributes first, so an estimator with
        `_fit_async` but no `_score_async` of its own scores a fitted
        model."""
        if state is not None:
            self._fit_finalize(state)
        if not hasattr(self, "score"):
            raise TypeError(f"{type(self).__name__} has no score(); "
                            "pass scoring=")
        return self.score(x, y) if y is not None else self.score(x)

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
    ``var_``; MinMaxScaler's ``data_min_`` and ``data_max_``;
    NearestNeighbors' ``_fit_data``; KNeighborsClassifier's ``_fit_x``,
    ``_codes`` and ``classes_``; KMeans' ``centers_``; PCA's ``mean_``,
    ``components_`` and ``explained_variance_``; ADMM's ``z_``; a search's
    ``best_estimator_`` (an estimator of this package) and results.  A
    ds-array attribute may come as a NumPy array or as an ``Array`` (whose
    ``block_size`` it keeps).  ``params`` go to the constructor.
    Device-resident attributes land on ``device`` (default: the default
    mesh's, ``cuda``).  The trailing-underscore entries ``_carry_in`` does
    not set (``n_iter_``, ``history_``, ...) are kept as given, so a model
    loaded and saved again writes what was loaded."""
    from dislib_tpu_torch.parallel import mesh as _mesh
    dev = (_mesh.get_mesh() if device is None
           else _mesh.local_mesh(device)).device
    est = cls(**params)
    est._carry_in(arrays, dev)
    for k, v in arrays.items():
        if k.endswith("_") and not k.startswith("_") and not hasattr(est, k):
            setattr(est, k, v)
    return est


def carried_array(v, device):
    """A carried-in ds-array attribute on ``device``: an ``Array`` already
    there is kept as it is (a loaded model predicts with no extra copy),
    one elsewhere is copied over with its ``block_size``; host data (NumPy,
    copied; 1-D as one row) becomes a float32 ds-array."""
    from dislib_tpu_torch.data.array import Array, array
    if isinstance(v, Array):
        if v.device == device:
            return v
        return array(v._data[: v.shape[0], : v.shape[1]],
                     block_size=v.block_size, dtype=v.dtype, device=device)
    v = np.array(v, np.float32)
    return array(v.reshape(1, -1) if v.ndim == 1 else v, device=device)


def clone(estimator):
    """Fresh unfitted copy with the same hyperparameters (sklearn.clone)."""
    return type(estimator)(**deepcopy(estimator.get_params()))
