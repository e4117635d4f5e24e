"""Fitted-model saving: ``save_model``/``load_model``.

Counterpart of ``dislib_tpu/utils/saving.py``, with its payload layout key
for key: an estimator is ``{"__estimator__": {"module", "cls", "params",
"fitted"}}``, its hyperparameters and its fitted attributes (those ending
in ``_``, and the leading-underscore ones a class lists in
``_private_fitted_attrs``); a NumPy array or a tensor is ``{"__ndarray__":
{dtype, shape, data}}`` with the bytes in base64, a ds-array
``{"__dsarray__": {...}, "block_size": [...]}``, a list or tuple
``{"__seq__": [...], "tuple": bool}``, a dict ``{"__dict__": {...}}``.
Formats: 'json', 'cbor' (``cbor2`` when it can be imported, else
:mod:`~dislib_tpu_torch.utils.cbor_lite`) and 'npz' (the JSON bytes as one
uint8 array).  No pickle: npz files load with ``allow_pickle=False``, and
a truncated or foreign file raises ``ValueError``.

Saving reads the model's device state to the host: every tensor read and
every ds-array ``collect()`` counts in ``utils/profiling.HOST_READS``
under ``"save"``.  Loading decodes the payload and builds the estimator
through the carry-in path, :func:`~dislib_tpu_torch.base.
from_fitted_arrays`: device-resident state lands on ``device`` (default:
the default mesh's, ``cuda``).  Only classes of this package load
(``_ALLOWED_MODULES``); a file written by the JAX reference (module
``dislib_tpu.…``) is refused.
"""

from __future__ import annotations

import base64
import importlib
import json
import os
import struct
import zipfile

import numpy as np
import torch

from dislib_tpu_torch.data.array import Array, array as _make_array
from dislib_tpu_torch.utils.profiling import count_read

_ALLOWED_MODULES = ("dislib_tpu_torch.",)


def _encode(obj):
    if isinstance(obj, Array):
        count_read("save")
        return {"__dsarray__": _np_payload(obj.collect()),
                "block_size": list(obj._reg_shape)}
    if isinstance(obj, torch.Tensor):
        count_read("save")
        return {"__ndarray__": _np_payload(obj.detach().cpu().numpy())}
    if isinstance(obj, np.ndarray):
        return {"__ndarray__": _np_payload(obj)}
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (list, tuple)):
        return {"__seq__": [_encode(o) for o in obj],
                "tuple": isinstance(obj, tuple)}
    if isinstance(obj, dict):
        return {"__dict__": {k: _encode(v) for k, v in obj.items()}}
    if hasattr(obj, "get_params") and hasattr(obj, "_fitted_attrs"):
        return {"__estimator__": _estimator_state(obj)}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"cannot serialise {type(obj).__name__}")


def _np_payload(a):
    a = np.ascontiguousarray(a)
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "data": base64.b64encode(a.tobytes()).decode("ascii")}


def _np_restore(p):
    a = np.frombuffer(base64.b64decode(p["data"]), dtype=np.dtype(p["dtype"]))
    return a.reshape(p["shape"]).copy()


def _decode(obj, device=None):
    if isinstance(obj, dict):
        if "__dsarray__" in obj:
            a = _np_restore(obj["__dsarray__"])
            return _make_array(a, block_size=tuple(obj["block_size"]),
                               dtype=a.dtype, device=device)
        if "__ndarray__" in obj:
            return _np_restore(obj["__ndarray__"])
        if "__seq__" in obj:
            seq = [_decode(o, device) for o in obj["__seq__"]]
            return tuple(seq) if obj.get("tuple") else seq
        if "__dict__" in obj:
            return {k: _decode(v, device) for k, v in obj["__dict__"].items()}
        if "__estimator__" in obj:
            return _estimator_restore(obj["__estimator__"], device)
    return obj


def _estimator_state(model):
    cls = type(model)
    return {
        "module": cls.__module__,
        "cls": cls.__qualname__,
        "params": {k: _encode(v) for k, v in model.get_params().items()},
        "fitted": {k: _encode(v) for k, v in model._fitted_attrs().items()},
    }


def _estimator_restore(state, device=None):
    """The estimator of a decoded payload: its class from this package
    only, its hyperparameters, and (if fitted) its fitted attributes
    carried in on ``device`` by :func:`base.from_fitted_arrays`."""
    from dislib_tpu_torch.base import BaseEstimator, from_fitted_arrays
    module = state["module"]
    if not module.startswith(_ALLOWED_MODULES):
        raise ValueError(f"refusing to load estimator from module {module!r}")
    cls = getattr(importlib.import_module(module), state["cls"])
    if not (isinstance(cls, type) and issubclass(cls, BaseEstimator)):
        raise ValueError(f"{module}.{state['cls']} is not an estimator")
    params = {k: _decode(v, device) for k, v in state["params"].items()}
    fitted = {k: _decode(v, device) for k, v in state["fitted"].items()}
    if not fitted:
        return cls(**params)
    return from_fitted_arrays(cls, fitted, device, **params)


def _cbor():
    """cbor2 when available, else the in-tree RFC 8949 subset codec."""
    try:
        import cbor2
        return cbor2
    except ImportError:
        from dislib_tpu_torch.utils import cbor_lite
        return cbor_lite


def save_model(model, filepath: str, overwrite: bool = True,
               save_format: str = "json") -> None:
    """Save a fitted estimator of this package (reference:
    ``utils.saving.save_model``) as 'json', 'cbor' or 'npz'."""
    if os.path.exists(filepath) and not overwrite:
        raise FileExistsError(filepath)
    if save_format not in ("json", "cbor", "npz"):
        raise ValueError(f"unknown save_format {save_format!r}")
    state = {"__estimator__": _estimator_state(model)}
    if save_format == "json":
        with open(filepath, "w") as f:
            json.dump(state, f)
    elif save_format == "cbor":
        with open(filepath, "wb") as f:
            f.write(_cbor().dumps(state))
    else:
        flat = json.dumps(state).encode()
        # through the open file handle: np.savez_compressed APPENDS ".npz"
        # to a bare path, which would save `model` as `model.npz`
        with open(filepath, "wb") as f:
            np.savez_compressed(
                f, state=np.frombuffer(flat, dtype=np.uint8))


def load_model(filepath: str, load_format: str | None = None, device=None):
    """Load a model saved by :func:`save_model` onto ``device`` (default:
    the default mesh's, ``cuda``).  ``load_format=None`` goes by the
    extension (``.cbor``, ``.npz``, else json)."""
    if load_format is None:
        load_format = "json"
        if filepath.endswith(".cbor"):
            load_format = "cbor"
        elif filepath.endswith(".npz"):
            load_format = "npz"
    if load_format == "json":
        with open(filepath) as f:
            state = json.load(f)
    elif load_format == "cbor":
        with open(filepath, "rb") as f:
            raw = f.read()
        codec = _cbor()
        # cbor2's decode errors are not all ValueErrors (CBORDecodeEOF)
        errors = (ValueError, struct.error, UnicodeDecodeError, EOFError) \
            + ((codec.CBORError,) if hasattr(codec, "CBORError") else ())
        try:
            state = codec.loads(raw)
        except errors as e:
            raise ValueError(
                f"{filepath} is not a dislib_tpu_torch cbor model "
                f"(truncated or foreign file: {e})") from e
    elif load_format == "npz":
        # allow_pickle stays OFF: a model file must never be a
        # pickle-execution vector, and the payload is a plain uint8 buffer
        try:
            with np.load(filepath, allow_pickle=False) as z:
                raw = z["state"].tobytes()
        except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
            raise ValueError(
                f"{filepath} is not a dislib_tpu_torch npz model (truncated, "
                f"foreign, or pickled file: {e})") from e
        state = json.loads(raw.decode())
    else:
        raise ValueError(f"unknown load_format {load_format!r}")
    if not (isinstance(state, dict) and "__estimator__" in state):
        raise ValueError(f"{filepath} holds no estimator (foreign file)")
    return _decode(state, device)
