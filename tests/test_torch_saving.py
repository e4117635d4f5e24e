"""The port's model saving (``utils/saving.py``, ``utils/cbor_lite.py``)
against the reference's, on CPU.

- A reference estimator, fitted on numpy draws with a seed and carried into
  the port by ``from_fitted_arrays``, is saved by both packages: the two
  JSON trees must be equal key for key (dtypes, shapes, base64 payloads,
  block sizes, hyperparameters), apart from the ``module`` string.
- ``cbor_lite`` writes the reference codec's bytes.
- Every estimator the port has survives ``save_model``/``load_model`` in
  json, cbor and npz, predicting bit-equal afterwards.
- Truncated, foreign and pickled files raise ``ValueError``; a file the
  reference wrote (module ``dislib_tpu.…``) is refused.
"""

import json
import os

import numpy as np
import pytest
import torch

import dislib_tpu as ds
from dislib_tpu.utils import cbor_lite as ref_cbor
from dislib_tpu.utils.saving import save_model as ref_save

import dislib_tpu_torch as dst
from dislib_tpu_torch.base import BaseEstimator, from_fitted_arrays
from dislib_tpu_torch.utils import cbor_lite as port_cbor
from dislib_tpu_torch.utils import profiling
from dislib_tpu_torch.utils.saving import load_model, save_model

FORMATS = ["json", "cbor", "npz"]


@pytest.fixture(autouse=True)
def _port_on_cpu():
    dst.init(device="cpu")
    yield


def _data(seed=0, m=96, n=4):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, n).astype(np.float32)
    x[m // 2:] += 3.0
    y = (np.arange(m) >= m // 2).astype(np.float32)[:, None]
    yr = (x @ rng.randn(n, 1) + 0.1).astype(np.float32)
    return x, y, yr


def _fits(pkg):
    """One fitted estimator of each class both packages have, fitted by
    ``pkg`` on the same draws."""
    x, y, yr = _data()
    a, ya, yra = pkg.array(x), pkg.array(y), pkg.array(yr)
    c = pkg.cluster if pkg is ds else dst.cluster
    return {
        "KMeans": pkg.KMeans(n_clusters=2, random_state=0).fit(a),
        "MiniBatchKMeans": c.MiniBatchKMeans(
            n_clusters=2, batch_size=32, random_state=0).fit(a),
        "GaussianMixture": pkg.GaussianMixture(
            n_components=2, random_state=0).fit(a),
        "PCA": pkg.PCA(n_components=2).fit(a),
        "StandardScaler": pkg.preprocessing.StandardScaler().fit(a),
        "MinMaxScaler": pkg.preprocessing.MinMaxScaler().fit(a),
        "LinearRegression": pkg.regression.LinearRegression().fit(a, yra),
        "Lasso": pkg.regression.Lasso(lmbd=0.1).fit(a, yra),
        "ADMM": pkg.optimization.ADMM().fit(a, yra),
        "RandomForestClassifier": pkg.trees.RandomForestClassifier(
            n_estimators=2, max_depth=4, random_state=0).fit(a, ya),
        "RandomForestRegressor": pkg.trees.RandomForestRegressor(
            n_estimators=2, max_depth=4, random_state=0).fit(a, yra),
        "DecisionTreeClassifier": pkg.trees.DecisionTreeClassifier(
            max_depth=3, random_state=0).fit(a, ya),
        "DecisionTreeRegressor": pkg.trees.DecisionTreeRegressor(
            max_depth=3, random_state=0).fit(a, yra),
        "KNeighborsClassifier": pkg.classification.KNeighborsClassifier(
            n_neighbors=3).fit(a, ya),
        "NearestNeighbors": pkg.neighbors.NearestNeighbors(
            n_neighbors=2).fit(a),
        "GridSearchCV": pkg.model_selection.GridSearchCV(
            pkg.KMeans(max_iter=3, random_state=0),
            {"n_clusters": [2, 3]}, cv=2).fit(a),
    }


def _port_class(ref_est):
    name = type(ref_est).__name__
    for mod in (dst, dst.cluster, dst.preprocessing, dst.regression,
                dst.optimization, dst.trees, dst.classification,
                dst.neighbors, dst.model_selection):
        if hasattr(mod, name):
            return getattr(mod, name)
    raise KeyError(name)


def _carry(v):
    """A reference value as the port holds it: ds-arrays as port Arrays
    (with the reference's block size), device arrays as NumPy, estimators
    carried in by ``from_fitted_arrays``."""
    if isinstance(v, ds.Array):
        return dst.array(np.asarray(v.collect()), block_size=v.block_size,
                         device="cpu")
    if hasattr(v, "get_params") and hasattr(v, "_fitted_attrs"):
        params = {k: _carry(p) for k, p in v.get_params().items()}
        fitted = {k: _carry(f) for k, f in v._fitted_attrs().items()}
        if not fitted:
            return _port_class(v)(**params)
        return from_fitted_arrays(_port_class(v), fitted, "cpu", **params)
    if isinstance(v, dict):
        return {k: _carry(o) for k, o in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_carry(o) for o in v)
    if type(v).__module__.startswith("jax"):
        return np.asarray(v)
    return v


def _tree(path, module_from=None):
    with open(path) as f:
        text = f.read()
    if module_from:
        text = text.replace(f'"{module_from}.', '"dislib_tpu_torch.')
    return json.loads(text)


@pytest.fixture(scope="module")
def ref_models():
    return _fits(ds)


@pytest.fixture(scope="module")
def port_models():
    dst.init(device="cpu")
    return _fits(dst)


NAMES = ["KMeans", "MiniBatchKMeans", "GaussianMixture", "PCA",
         "StandardScaler", "MinMaxScaler", "LinearRegression", "Lasso",
         "ADMM", "RandomForestClassifier", "RandomForestRegressor",
         "DecisionTreeClassifier", "DecisionTreeRegressor",
         "KNeighborsClassifier", "NearestNeighbors", "GridSearchCV"]


@pytest.mark.parametrize("name", NAMES)
def test_json_tree_equals_the_references(ref_models, tmp_path, name):
    ref = ref_models[name]
    port = _carry(ref)
    assert isinstance(port, BaseEstimator)
    rp, pp = str(tmp_path / "ref.json"), str(tmp_path / "port.json")
    ref_save(ref, rp)
    save_model(port, pp)
    assert _tree(pp) == _tree(rp, module_from="dislib_tpu")
    # and the port loads what it wrote, which saves to the same bytes
    again = str(tmp_path / "again.json")
    save_model(load_model(pp, device="cpu"), again)
    assert open(again).read() == open(pp).read()


def test_cbor_lite_bytes_equal_the_reference_codec(ref_models, tmp_path):
    payload = {"k" * 30: [list(range(30)), "v" * 300, 2 ** 40, 1.25, -7,
                          None, True, False, -2 ** 63],
               "b": bytes(range(256)), "t": (1, 2.5e-300)}
    assert port_cbor.dumps(payload) == ref_cbor.dumps(payload)
    assert port_cbor.loads(ref_cbor.dumps(payload)) == \
        ref_cbor.loads(ref_cbor.dumps(payload))
    # a whole model file: the port's cbor bytes are the reference codec's
    # encoding of the same payload (the port's json tree of the model)
    rf = _carry(ref_models["RandomForestClassifier"])
    pj, pc = str(tmp_path / "p.json"), str(tmp_path / "p.cbor")
    save_model(rf, pj)
    save_model(rf, pc, save_format="cbor")
    assert open(pc, "rb").read() == ref_cbor.dumps(_tree(pj))
    enc = port_cbor.dumps(payload)
    for cut in range(0, len(enc), 37):
        with pytest.raises(ValueError):
            port_cbor.loads(enc[:cut])


def _outputs(name, est, x):
    """What a fitted estimator computes on ``x``, as NumPy arrays."""
    if name == "NearestNeighbors":
        return [o.collect() for o in est.kneighbors(x)]
    if name in ("PCA", "StandardScaler", "MinMaxScaler"):
        return [est.transform(x).collect()]
    if name == "GaussianMixture":
        return [est.predict(x).collect(), np.float64(est.score(x))]
    if name == "ADMM":
        return [np.asarray(est.z_)]
    out = [est.predict(x).collect()]
    if hasattr(est, "predict_proba"):
        out.append(est.predict_proba(x).collect())
    return out


@pytest.mark.parametrize("fmt", FORMATS)
def test_every_estimator_round_trips(port_models, tmp_path, fmt):
    x = dst.array(_data(seed=1, m=40)[0], device="cpu")
    assert set(port_models) >= {"KMeans", "GridSearchCV"}
    for name, est in port_models.items():
        path = str(tmp_path / f"{name}.{fmt}")
        save_model(est, path, save_format=fmt)
        back = load_model(path, device="cpu")
        assert type(back) is type(est)
        assert back.get_params().keys() == est.get_params().keys()
        for got, want in zip(_outputs(name, back, x), _outputs(name, est, x)):
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_loaded_state_lands_on_the_requested_device(port_models, tmp_path):
    path = str(tmp_path / "knn.json")
    save_model(port_models["KNeighborsClassifier"], path)
    back = load_model(path, device="cpu")
    assert back._fit_x.device == torch.device("cpu")
    assert back._codes.device == torch.device("cpu")
    assert back._fit_x.block_size == \
        port_models["KNeighborsClassifier"]._fit_x.block_size
    if not torch.cuda.is_available():     # the default is the card's
        dst.init(device="cpu")
        with pytest.raises(RuntimeError, match="CUDA device"):
            load_model(path, device="cuda")


def test_save_counts_its_host_reads(port_models, tmp_path):
    profiling.reset_host_reads()
    save_model(port_models["RandomForestClassifier"],
               str(tmp_path / "rf.json"))
    assert profiling.HOST_READS == {"save": 2}        # _edges, _leaves
    profiling.reset_host_reads()
    save_model(port_models["PCA"], str(tmp_path / "pca.json"))
    assert profiling.HOST_READS == {"save": 3}
    profiling.reset_host_reads()


def test_truncated_foreign_and_pickled_files_raise(port_models, tmp_path):
    rf = port_models["RandomForestClassifier"]
    for fmt in FORMATS:
        path = str(tmp_path / f"trunc.{fmt}")
        save_model(rf, path, save_format=fmt)
        raw = open(path, "rb").read()
        open(path, "wb").write(raw[: len(raw) // 3])
        with pytest.raises(ValueError):
            load_model(path)
    foreign = str(tmp_path / "foreign.npz")
    np.savez(foreign, junk=np.arange(3))
    with pytest.raises(ValueError, match="not a dislib_tpu_torch npz"):
        load_model(foreign)
    pickled = str(tmp_path / "pickled.npz")
    np.savez(pickled, state=np.asarray([{"a": 1}], dtype=object))
    with pytest.raises(ValueError, match="not a dislib_tpu_torch npz"):
        load_model(pickled)
    plain = str(tmp_path / "plain.json")
    with open(plain, "w") as f:
        json.dump({"a": [1, 2]}, f)
    with pytest.raises(ValueError, match="no estimator"):
        load_model(plain)
    evil = str(tmp_path / "evil.json")
    with open(evil, "w") as f:
        json.dump({"__estimator__": {"module": "os", "cls": "system",
                                     "params": {}, "fitted": {}}}, f)
    with pytest.raises(ValueError, match="refusing"):
        load_model(evil)
    with pytest.raises(FileExistsError):
        save_model(rf, evil, overwrite=False)
    with pytest.raises(ValueError, match="save_format"):
        save_model(rf, str(tmp_path / "x.bin"), save_format="pickle")


@pytest.mark.parametrize("fmt", FORMATS)
def test_a_reference_file_is_refused(ref_models, tmp_path, fmt):
    path = str(tmp_path / f"ref.{fmt}")
    ref_save(ref_models["KMeans"], path, save_format=fmt)
    with pytest.raises(ValueError, match="refusing to load estimator from "
                                         "module 'dislib_tpu.cluster"):
        load_model(path)


def test_an_extensionless_path_round_trips(port_models, tmp_path):
    km = port_models["KMeans"]
    for fmt in FORMATS:
        path = str(tmp_path / f"model_{fmt}")
        save_model(km, path, save_format=fmt)
        assert os.path.exists(path) and not os.path.exists(path + ".npz")
        back = load_model(path, load_format=fmt, device="cpu")
        np.testing.assert_array_equal(back.centers_, km.centers_)
        assert back.n_iter_ == km.n_iter_
        np.testing.assert_array_equal(back.history_, km.history_)
