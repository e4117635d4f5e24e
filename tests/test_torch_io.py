"""The port's ingest (``data/io.py``, ``native/``, ``runtime/retry.py``)
against the reference's, on CPU.

The same files, written from numpy draws with a seed, are loaded by
``dislib_tpu`` (8 virtual CPU devices) and by ``dislib_tpu_torch`` on the
CPU; every loaded array must be bit-equal to the reference's, with the
native parser on and off (``DSLIB_NO_NATIVE``), and so must the
quarantine's reports.  The port's parser is its own copy of the
reference's C++ source, built into ``dislib_tpu_torch/_build/``.
"""

import os
import warnings

import numpy as np
import pytest
import torch

import dislib_tpu as ds
from dislib_tpu import native as ref_native

import dislib_tpu_torch as dst
from dislib_tpu_torch import native as port_native
from dislib_tpu_torch.data import io as port_io
from dislib_tpu_torch.runtime.retry import Retry, is_transient_error


@pytest.fixture(autouse=True)
def _port_on_cpu():
    dst.init(device="cpu")
    port_io.quarantine_ledger().reset()
    yield


@pytest.fixture(params=["native", "numpy"])
def parser(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setenv("DSLIB_NO_NATIVE", "1")
    return request.param


def _csv(path, x, fmt="%.9g", extra=""):
    with open(path, "w") as f:
        f.write(extra)
        for row in x:
            f.write(",".join(fmt % v for v in row) + "\n")
    return str(path)


def _both(loader, *args, **kwargs):
    """(reference result, port result), each loader warning alike."""
    with warnings.catch_warnings(record=True) as wr:
        warnings.simplefilter("always")
        ref = getattr(ds, loader)(*args, **kwargs)
    with warnings.catch_warnings(record=True) as wp:
        warnings.simplefilter("always")
        port = getattr(dst, loader)(*args, **kwargs)
    assert [str(w.message) for w in wr] == [str(w.message) for w in wp]
    return ref, port


def _same_array(port, ref, block_size=None):
    """Bit-equal values; the same block size where the caller set one (the
    default is the mesh's: 8 row blocks on the reference's 8 devices, one
    on the port's one)."""
    assert isinstance(port, dst.Array) and port.device.type == "cpu"
    assert port.shape == ref.shape
    assert port.block_size == (port.shape if block_size is None
                               else ref.block_size)
    got, want = port.collect(), np.asarray(ref.collect())
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _same_report(port, ref):
    if ref is None:
        assert port is None
        return
    assert port.source == ref.source and port.n_loaded == ref.n_loaded
    np.testing.assert_array_equal(port.rows, ref.rows)
    np.testing.assert_array_equal(port.keep_mask, ref.keep_mask)
    assert port.n_total == ref.n_total
    if isinstance(ref.values, np.ndarray):
        np.testing.assert_array_equal(port.values, ref.values)
    else:        # the CSR rows of a svmlight load
        np.testing.assert_array_equal(port.values.toarray(),
                                      ref.values.toarray())
    if ref.labels is None:
        assert port.labels is None
    else:
        np.testing.assert_array_equal(port.labels, ref.labels)


# -- the native parser -------------------------------------------------------

def test_parse_text_bit_equal_to_the_reference():
    rng = np.random.RandomState(0)
    x = rng.standard_normal((257, 9)) * 10.0 ** rng.randint(-8, 8, (257, 9))
    buf = "\n".join(",".join(repr(float(v)) for v in row) for row in x)
    buf = (buf + "\n").encode()
    got, want = port_native.parse_text(buf), ref_native.parse_text(buf)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # and both are NumPy's float32 parse
    np.testing.assert_array_equal(got, np.loadtxt(
        buf.decode().splitlines(), delimiter=",", dtype=np.float32))
    for other in (b"1 2 3\n4 5 6\n",):
        np.testing.assert_array_equal(port_native.parse_text(other, " "),
                                      ref_native.parse_text(other, " "))


def test_parse_svmlight_and_mdcrd_bit_equal_to_the_reference():
    buf = b"1 1:0.5 3:2.25\n-1 2:1e-3 2:1 # note\n0\n"
    for got, want in zip(port_native.parse_svmlight(buf),
                         ref_native.parse_svmlight(buf)):
        np.testing.assert_array_equal(got, want)
    md = b"title\n   1.000  -2.500 100.125   3.250\n   0.001\n"
    np.testing.assert_array_equal(port_native.parse_mdcrd(md),
                                  ref_native.parse_mdcrd(md))
    with pytest.raises(port_native.NativeUnavailable):
        port_native.parse_text(b"1,2\n3\n")          # ragged: NumPy raises


def test_parser_builds_into_the_build_directory():
    lib = port_native.get_lib()
    assert lib is not None and port_native.build_error() is None
    so = port_native.library_path()
    assert os.path.dirname(so) == port_native.BUILD_DIR
    assert os.path.basename(os.path.dirname(so)) == "_build"
    assert os.path.isfile(so)
    here = os.path.dirname(port_native.__file__)
    assert not [f for f in os.listdir(here) if f.endswith(".so")]


def test_failed_build_is_recorded_and_the_loaders_fall_back(
        tmp_path, monkeypatch, caplog):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(port_native, "_SRC", str(bad))
    monkeypatch.setattr(port_native, "BUILD_DIR", str(tmp_path / "_build"))
    for name, val in (("_tried", False), ("_lib", None), ("_error", None)):
        monkeypatch.setattr(port_native, name, val)
    with caplog.at_level("WARNING", logger="dslib.native"):
        assert port_native.get_lib() is None
    assert "g++" in port_native.build_error()
    assert "did not build" in caplog.text
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    out = dst.load_txt_file(_csv(tmp_path / "x.csv", x))
    np.testing.assert_array_equal(out.collect(), x)


# -- load_txt_file --------------------------------------------------------------

def test_load_txt_file_matches_the_reference(tmp_path, parser):
    rng = np.random.RandomState(1)
    x = rng.standard_normal((203, 7)).astype(np.float32)
    path = _csv(tmp_path / "x.csv", x)
    for kw in ({}, {"block_size": (16, 3)}, {"dtype": np.float32}):
        ref, port = _both("load_txt_file", path, **kw)
        _same_array(port, ref, kw.get("block_size"))
        assert port.quarantine_ is None and ref.quarantine_ is None
    np.testing.assert_array_equal(port.collect(), x)


def test_load_txt_file_delimiter_blank_lines_and_comments(tmp_path, parser):
    path = tmp_path / "odd.txt"
    path.write_text("# header\n1 2 3\n\n4 5 6# trailing\n\n7 8 9\n")
    ref, port = _both("load_txt_file", str(path), delimiter=" ")
    _same_array(port, ref)
    np.testing.assert_array_equal(port.collect(),
                                  np.arange(1, 10, dtype=np.float32)
                                  .reshape(3, 3))


def test_load_txt_file_quarantines_a_nan_row(tmp_path, parser, monkeypatch):
    x = np.random.RandomState(2).rand(40, 5).astype(np.float32)
    x[7, 2] = np.nan
    x[31, 0] = np.inf
    path = _csv(tmp_path / "dirty.csv", x)
    ref, port = _both("load_txt_file", path)
    _same_array(port, ref)
    _same_report(port.quarantine_, ref.quarantine_)
    rep = port.quarantine_
    assert rep.n_quarantined == 2 and rep.rows.tolist() == [7, 31]
    assert dst.last_quarantine_report() is rep
    assert dst.quarantine_ledger().n_quarantined == 2
    np.testing.assert_array_equal(port.collect(), x[rep.keep_mask])
    # quarantine off: per call and by the environment, raw rows kept
    for kw, env in (({"quarantine": False}, None), ({}, "0")):
        if env is not None:
            monkeypatch.setenv("DSLIB_QUARANTINE", env)
        ref, port = _both("load_txt_file", path, **kw)
        _same_array(port, ref)
        assert port.quarantine_ is None
    assert dst.quarantine_ledger().n_quarantined == 2


def test_load_txt_file_errors_as_the_reference(tmp_path, parser):
    ragged = tmp_path / "ragged.csv"
    ragged.write_text("1,2,3\n4,5\n")
    bad = tmp_path / "bad.csv"
    bad.write_text("1,2\nx,4\n")
    nan_only = _csv(tmp_path / "nan.csv", np.full((3, 2), np.nan))
    for path, exc in ((str(ragged), ValueError), (str(bad), ValueError),
                      (str(tmp_path / "missing.csv"), FileNotFoundError),
                      (nan_only, ValueError)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.raises(exc) as want:
                ds.load_txt_file(path)
            with pytest.raises(exc) as got:
                dst.load_txt_file(path)
        assert type(got.value) is type(want.value)
        if exc is ValueError and path == nan_only:
            assert str(got.value) == str(want.value)


def test_loaders_default_to_the_default_mesh_and_take_a_device(tmp_path):
    x = np.ones((4, 2), np.float32)
    path = _csv(tmp_path / "x.csv", x)
    assert dst.load_txt_file(path).device == torch.device("cpu")
    assert dst.load_txt_file(path, device="cpu").device == torch.device("cpu")
    if not torch.cuda.is_available():     # "cuda" is asked for, and raises
        with pytest.raises(RuntimeError, match="CUDA device"):
            dst.load_txt_file(path, device="cuda")


# -- load_npy_file ----------------------------------------------------------------

def test_load_npy_file_matches_the_reference(tmp_path):
    rng = np.random.RandomState(3)
    x32 = rng.rand(99, 6).astype(np.float32)
    x32[5] = np.nan
    p32 = str(tmp_path / "x32.npy")
    np.save(p32, x32)
    ref, port = _both("load_npy_file", p32, block_size=(10, 6))
    _same_array(port, ref, (10, 6))
    _same_report(port.quarantine_, ref.quarantine_)
    # float64 narrows to float32 with the reference's warning
    p64 = str(tmp_path / "x64.npy")
    np.save(p64, rng.rand(20, 3))
    with pytest.warns(UserWarning, match="narrowing"):
        port = dst.load_npy_file(p64)
    with pytest.warns(UserWarning, match="narrowing"):
        ref = ds.load_npy_file(p64)
    _same_array(port, ref)
    # the port keeps float64 when asked for it
    assert dst.load_npy_file(p64, dtype=np.float64).dtype == torch.float64
    p3 = str(tmp_path / "x3.npy")
    np.save(p3, np.zeros((2, 2, 2), np.float32))
    for pkg in (ds, dst):
        with pytest.raises(ValueError, match="2-D"):
            pkg.load_npy_file(p3)


# -- load_mdcrd_file ------------------------------------------------------------

def _mdcrd(path, frames):
    """AMBER mdcrd: a title line, then 10 values of 8 characters a line,
    each frame starting on a new line."""
    with open(path, "w") as f:
        f.write("synthetic trajectory\n")
        for fr in frames:
            vals = fr.ravel()
            for i in range(0, len(vals), 10):
                f.write("".join(f"{v:8.3f}" for v in vals[i:i + 10]) + "\n")
    return str(path)


def test_load_mdcrd_file_matches_the_reference(tmp_path, parser):
    rng = np.random.RandomState(4)
    frames = rng.uniform(-99, 99, (12, 7, 3))
    frames[4, 2, 1] = np.nan
    path = _mdcrd(tmp_path / "t.mdcrd", frames)
    for kw in ({}, {"copy_first": True}, {"block_size": (5, 21)},
               {"quarantine": False}):
        ref, port = _both("load_mdcrd_file", path, n_atoms=7, **kw)
        _same_array(port, ref, kw.get("block_size"))
        _same_report(port.quarantine_, ref.quarantine_)
    assert port.shape == (12, 21)
    for pkg in (ds, dst):
        with pytest.raises(ValueError, match="n_atoms"):
            pkg.load_mdcrd_file(path)


# -- load_svmlight_file ------------------------------------------------------------

def test_load_svmlight_dense_matches_the_reference(tmp_path, parser):
    path = tmp_path / "d.svm"
    path.write_text("# comment\n1 1:0.5 3:2.25\n-1 2:1e-3 2:1 # tail\n"
                    "\n0 4:nan\n2 1:1 5:7\n3 3:1\n")
    for kw in ({}, {"n_features": 6}, {"block_size": (2, 3)},
               {"n_features": 4}, {"quarantine": False, "n_features": 5}):
        ref, port = _both("load_svmlight_file", str(path),
                          store_sparse=False, **kw)
        _same_array(port[0], ref[0], kw.get("block_size"))
        _same_array(port[1], ref[1], kw.get("block_size") and (2, 1))
        _same_report(port[0].quarantine_, ref[0].quarantine_)
    assert port[0].shape == (5, 5)
    # a truncating width with the quarantine off: the reference's error
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for pkg in (ds, dst):
            with pytest.raises(ValueError, match="outside n_features=3"):
                pkg.load_svmlight_file(str(path), n_features=3,
                                       store_sparse=False, quarantine=False)


def test_load_svmlight_sparse_names_the_roadmap_item(tmp_path, parser):
    # store_sparse=True, the default, is ported: x is a SparseArray with
    # the reference's triplets and quarantine report
    path = tmp_path / "s.svm"
    path.write_text("1 1:1 3:2.5\n-1 2:1e-3 2:1\n0 4:nan\n2 5:7\n")
    for kw in ({}, {"n_features": 6}, {"block_size": (2, 3)}):
        ref, port = _both("load_svmlight_file", str(path), **kw)
        assert isinstance(port[0], dst.SparseArray)
        assert port[0].shape == ref[0].shape
        assert port[0].block_size == ref[0].block_size
        np.testing.assert_array_equal(port[0].collect().toarray(),
                                      ref[0].collect().toarray())
        _same_array(port[1], ref[1], kw.get("block_size") and (2, 1))
        _same_report(port[0].quarantine_, ref[0].quarantine_)
    assert "store_sparse=True" in dst.load_svmlight_file.__doc__


def test_multi_process_ingest_names_the_roadmap_item(tmp_path, monkeypatch):
    import torch.distributed as dist
    path = _csv(tmp_path / "x.csv", np.ones((2, 2)))
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    with pytest.raises(NotImplementedError, match="A.11"):
        dst.load_txt_file(path)


# -- save_txt, the ledger, the batch screen ------------------------------------

def test_save_txt_matches_the_reference(tmp_path):
    x = np.random.RandomState(5).rand(23, 4).astype(np.float32)
    for merge in (True, False):
        rp, pp = str(tmp_path / f"ref{merge}"), str(tmp_path / f"port{merge}")
        ds.save_txt(ds.array(x, block_size=(5, 4)), rp, merge_rows=merge)
        dst.save_txt(dst.array(x, block_size=(5, 4)), pp, merge_rows=merge)
        if merge:
            assert open(rp).read() == open(pp).read()
        else:
            assert sorted(os.listdir(rp)) == sorted(os.listdir(pp)) \
                == [str(i) for i in range(5)]
            for f in os.listdir(rp):
                assert open(os.path.join(rp, f)).read() == \
                    open(os.path.join(pp, f)).read()
    back = dst.load_txt_file(str(tmp_path / "portTrue"))
    np.testing.assert_allclose(back.collect(), x, rtol=1e-7)


def test_ledger_and_quarantine_batch_match_the_reference():
    rng = np.random.RandomState(6)
    ds.quarantine_ledger().reset()
    batches = [rng.rand(8, 3).astype(np.float32) for _ in range(3)]
    batches[0][1] = np.nan
    batches[2][[0, 5]] = np.inf
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for b in batches:
            rc, rr = ds.quarantine_batch(b, source="s")
            pc, pr = dst.quarantine_batch(b, source="s")
            np.testing.assert_array_equal(pc, rc)
            _same_report(pr, rr)
        for pkg in (ds, dst):
            with pytest.raises(ValueError, match="every row"):
                pkg.quarantine_batch(np.full(3, np.nan))
    rl, pl = ds.quarantine_ledger(), dst.quarantine_ledger()
    assert (pl.n_quarantined, pl.n_loaded) == (rl.n_quarantined,
                                               rl.n_loaded) == (4, 13)
    np.testing.assert_array_equal(pl.keep_mask_all(), rl.keep_mask_all())
    capped = port_io.QuarantineLedger(max_reports=1)
    for r in pl.reports:
        capped.append(r)
    assert len(capped.reports) == 1 and capped.n_quarantined == 4
    pl.reset()
    assert pl.n_quarantined == 0 and pl.keep_mask_all().size == 0
    ds.quarantine_ledger().reset()


# -- the retry policy ------------------------------------------------------------

@pytest.mark.parametrize("exc,transient", [
    (ConnectionResetError(), True), (TimeoutError(), True),
    (OSError(5, "Input/output error"), True),
    (FileNotFoundError(), False), (PermissionError(), False),
    (ValueError("bad"), False), (RuntimeError("UNAVAILABLE: socket"), True),
    (RuntimeError("shape mismatch"), False), (KeyboardInterrupt(), False)])
def test_transient_classification_matches_the_reference(exc, transient):
    from dislib_tpu.runtime.retry import is_transient_error as ref_is
    assert is_transient_error(exc) is ref_is(exc) is transient


def test_loader_retries_a_transient_read(tmp_path, monkeypatch):
    x = np.ones((3, 2), np.float32)
    path = _csv(tmp_path / "x.csv", x)
    real_open, calls = open, []

    def flaky(p, *a, **k):
        if p == path and not calls:
            calls.append(p)
            raise OSError(5, "Input/output error")
        return real_open(p, *a, **k)

    monkeypatch.setenv("DSLIB_RETRY_BACKOFF", "0")
    monkeypatch.setattr("builtins.open", flaky)
    np.testing.assert_array_equal(dst.load_txt_file(path).collect(), x)
    assert calls == [path]
    slept = []
    r = Retry(attempts=3, backoff=0.5, jitter=0.0, sleep=slept.append)
    with pytest.raises(OSError):
        r.call(lambda: (_ for _ in ()).throw(OSError(5, "EIO")))
    assert slept == [0.5, 1.0]
