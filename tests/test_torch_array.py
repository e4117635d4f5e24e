"""The port's eager ds-array ops against the reference's, on CPU.

The same numpy inputs go through ``dislib_tpu`` run with ``DSLIB_EAGER=1``
(each op its own program, on the conftest's 8 virtual devices, so its
backings are row-padded to a multiple of 8) and through
``dislib_tpu_torch`` on the CPU.  Tolerances: bit-equal where both sides
do one correctly rounded IEEE operation per element (+, −, ×, ÷, neg, abs,
min, max, the constructors, slicing and concatenation); 1e-6 relative
where the library functions or the summation order differ (sqrt — XLA's
CPU sqrt is not correctly rounded —, exp, pow, sum, mean, norm).  The
port's own mesh has quantum 1, so the padded cases build a padded backing
by hand and hold the pad-and-mask invariant: ``min``/``max`` ignore the
pad, ``mean`` divides by the logical count, a ``0/0`` in the pad is
re-zeroed.
"""

import warnings

import numpy as np
import pytest
import torch

import dislib_tpu as ds
from dislib_tpu.data import util as ref_util
from dislib_tpu.ops import rechunk as ref_rechunk

import dislib_tpu_torch as dst
from dislib_tpu_torch.data import util as port_util
from dislib_tpu_torch.data.array import Array as PortArray
from dislib_tpu_torch.ops import rechunk as port_rechunk


@pytest.fixture(autouse=True)
def _port_on_cpu_reference_eager(monkeypatch):
    monkeypatch.setenv("DSLIB_EAGER", "1")
    dst.init(device="cpu")
    yield


def _mk(shape, seed=0, positive=False):
    x = np.random.RandomState(seed).standard_normal(shape).astype(np.float32)
    return np.abs(x) + 0.5 if positive else x


def _both(x, **kw):
    return ds.array(x, **kw), dst.array(x, **kw)


def _padded(x, pshape):
    """A port Array over ``x`` with a zero pad out to ``pshape``, built by
    hand (the port's own mesh pads nothing)."""
    data = torch.zeros(pshape, dtype=torch.float32)
    data[: x.shape[0], : x.shape[1]] = torch.from_numpy(x)
    return PortArray(data, x.shape, dst.get_mesh())


def _pad_is_zero(arr):
    d = arr._data
    m, n = arr.shape
    return bool((d[m:] == 0).all() and (d[:, n:] == 0).all())


EXACT_OPS = {
    "add": lambda a, b: a + b, "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b, "div": lambda a, b: a / b,
}
CLOSE_OPS = {"pow": lambda a, b: a ** b}


@pytest.mark.parametrize("op", sorted(EXACT_OPS) + sorted(CLOSE_OPS))
@pytest.mark.parametrize("rhs_shape", [(37, 11), (1, 11), (37, 1)],
                         ids=str)
def test_array_array_ops_match_reference(op, rhs_shape):
    fn = {**EXACT_OPS, **CLOSE_OPS}[op]
    x = _mk((37, 11), 1, positive=True)
    y = _mk(rhs_shape, 2, positive=True)
    (rx, px_), (ry, py) = _both(x), _both(y)
    want = fn(rx, ry).collect()
    got = fn(px_, py)
    assert got.shape == (37, 11) and _pad_is_zero(got)
    if op in EXACT_OPS:
        np.testing.assert_array_equal(got.collect(), want)
    else:
        np.testing.assert_allclose(got.collect(), want, rtol=1e-6)


SCALAR_OPS = {
    "add": lambda a: a + 1.5, "radd": lambda a: 1.5 + a,
    "sub": lambda a: a - 2.0, "rsub": lambda a: 2.0 - a,
    "mul": lambda a: a * 3.0, "rmul": lambda a: 3.0 * a,
    "div": lambda a: a / 7.0, "rdiv": lambda a: 7.0 / a,
    "neg": lambda a: -a, "abs": abs,
}
UNARY_CLOSE = {"sqrt": lambda a: a.sqrt(), "exp": lambda a: a.exp(),
               "pow": lambda a: a ** 1.7}


@pytest.mark.parametrize("op", sorted(SCALAR_OPS) + sorted(UNARY_CLOSE))
def test_scalar_and_unary_ops_match_reference(op):
    x = _mk((19, 6), 3, positive=op in ("sqrt", "pow"))
    rx, px_ = _both(x)
    if op in SCALAR_OPS:
        np.testing.assert_array_equal(SCALAR_OPS[op](px_).collect(),
                                      SCALAR_OPS[op](rx).collect())
    else:
        fn = UNARY_CLOSE[op]
        np.testing.assert_allclose(fn(px_).collect(), fn(rx).collect(),
                                   rtol=1e-6)


def test_int_array_scalar_is_cast_to_the_array_dtype():
    x = np.arange(12, dtype=np.int32).reshape(3, 4)
    rx, px_ = _both(x)
    np.testing.assert_array_equal((px_ * 2.5).collect(),
                                  (rx * 2.5).collect())     # 2.5 → 2
    got, want = (px_ / 4).collect(), (rx / 4).collect()     # true division
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_mismatched_shapes_raise():
    a = dst.array(_mk((4, 3)))
    with pytest.raises(ValueError, match="shape mismatch"):
        a + dst.array(_mk((4, 2)))
    assert a.__add__("x") is NotImplemented


@pytest.mark.parametrize("kind", ["sum", "mean", "min", "max", "norm"])
@pytest.mark.parametrize("axis", [0, 1, None])
def test_reductions_match_reference(kind, axis):
    x = _mk((37, 11), 4)
    rx, px_ = _both(x)
    want = getattr(rx, kind)(axis=axis).collect()
    got = getattr(px_, kind)(axis=axis)
    assert got.shape == want.shape
    if kind in ("min", "max"):
        np.testing.assert_array_equal(got.collect(), want)
    else:
        np.testing.assert_allclose(got.collect(), want, rtol=1e-6,
                                   atol=1e-6)


def test_matmul_operator_and_float():
    x, y = _mk((9, 5), 5), _mk((5, 4), 6)
    (rx, px_), (ry, py) = _both(x), _both(y)
    np.testing.assert_allclose((px_ @ py).collect(), (rx @ ry).collect(),
                               rtol=1e-6, atol=1e-6)
    assert float(px_.sum(axis=None)) == pytest.approx(
        float(rx.sum(axis=None)), rel=1e-6)
    with pytest.raises(TypeError, match=r"\(1, 1\)"):
        float(px_)


# -- the padded region --------------------------------------------------------

def test_padded_input_keeps_the_invariant():
    """A hand-padded backing (5 pad rows, 3 pad cols) gives the
    reference's logical results, and every result's pad is zero."""
    x = _mk((13, 6), 7, positive=True)
    xp, rx = _padded(x, (18, 9)), ds.array(x)
    for kind in ("sum", "mean", "min", "max", "norm"):
        for axis in (0, 1, None):
            got = getattr(xp, kind)(axis=axis)
            want = getattr(rx, kind)(axis=axis).collect()
            assert _pad_is_zero(got)
            np.testing.assert_allclose(got.collect(), want, rtol=1e-6)
    # negative data: a max that looked at the zero pad would return 0
    neg = _padded(-x, (18, 9))
    np.testing.assert_array_equal(neg.max(axis=None).collect(),
                                  [[-x.min()]])
    np.testing.assert_array_equal(xp.min(axis=None).collect(), [[x.min()]])
    # mean over the logical count, not the canvas
    np.testing.assert_allclose(xp.mean(axis=0).collect(),
                               x.mean(0, keepdims=True), rtol=1e-6)
    # 0/0 and c/0 in the pad re-zeroed; x + c leaves the pad at zero
    for out in (xp / 0.0, 1.0 / xp, xp + 3.0, xp - 1.0, xp.exp(),
                xp / xp, xp * dst.array(x[:1])):
        assert _pad_is_zero(out) and np.isfinite(out._data[
            out.shape[0]:].numpy()).all()
    np.testing.assert_array_equal((xp / xp).collect(), np.ones_like(x))
    np.testing.assert_array_equal((xp + 3.0).collect(), (rx + 3.0).collect())


def test_requantize_re_zeroes_a_poisoned_pad():
    x = _mk((5, 3), 8)
    data = torch.full((8, 4), 99.0)
    data[:5, :3] = torch.from_numpy(x)
    want = np.asarray(ref_rechunk.requantize_body(data.numpy(), (5, 3),
                                                  (6, 5), mesh=None))
    got = port_rechunk.requantize_body(data, (5, 3), (6, 5))
    np.testing.assert_array_equal(got.numpy(), want)
    got = dst.rechunk(PortArray(data, (5, 3), dst.get_mesh()),
                      schedule="xla")
    assert got._data.shape == (5, 3)
    np.testing.assert_array_equal(got.collect(), x)


@pytest.mark.parametrize("axis,logical,target", [(0, 3, 6), (1, 2, 2),
                                                 (1, 4, 7)])
def test_repad_axis_matches_reference(axis, logical, target):
    a = _mk((5, 4, 3), 9)
    want = np.asarray(ref_rechunk.repad_axis(a, logical, target, axis))
    got = port_rechunk.repad_axis(torch.from_numpy(a), logical, target, axis)
    np.testing.assert_array_equal(got.numpy(), want)


def test_rechunk_and_ensure_canonical():
    x = _mk((10, 7), 10)
    a = dst.array(x, block_size=(5, 7))
    b = dst.rechunk(a, (3, 2))
    assert b._data is a._data and b.block_size == (3, 2)    # metadata only
    assert a.rechunk((4, 4)).block_size == (4, 4)
    assert dst.ensure_canonical(a) is a
    padded = _padded(x, (12, 9))
    c = dst.ensure_canonical(padded)
    assert c._data.shape == (10, 7)
    np.testing.assert_array_equal(c.collect(), x)
    for sched, err in (("panels", NotImplementedError),
                       ("dcn", NotImplementedError), ("bogus", ValueError)):
        with pytest.raises(err):
            dst.rechunk(a, schedule=sched)
    # nse= is a sparse knob: a dense array's rechunk does not read it, as
    # in the reference; a SparseArray's rechunk is its reshard (A.11)
    got = dst.rechunk(a, (3, 2), nse=4)
    want = ds.rechunk(ds.array(x, block_size=(5, 7)), (3, 2), nse=4)
    np.testing.assert_array_equal(got.collect(), want.collect())
    assert got.block_size == want.block_size == (3, 2)
    with pytest.raises(NotImplementedError, match="A.11"):
        dst.rechunk(dst.SparseArray.from_dense(x), nse=4)


# -- constructors, copies, iteration ---------------------------------------------

@pytest.mark.parametrize("shape", [(5, 3), (4, 9), (1, 1)], ids=str)
def test_constructors_match_reference(shape):
    n, m = shape
    cases = [
        (ds.full(shape, 2.5), dst.full(shape, 2.5)),
        (ds.ones(shape), dst.ones(shape)),
        (ds.eye(n, m), dst.eye(n, m)),
        (ds.identity(n), dst.identity(n)),
        (ds.zeros(shape), dst.zeros(shape)),
    ]
    for ref, port in cases:
        assert port.shape == ref.shape and _pad_is_zero(port)
        np.testing.assert_array_equal(port.collect(), ref.collect())


def test_random_array_is_uniform_and_seeded():
    a = dst.random_array((300, 7), random_state=3)
    b = dst.random_array((300, 7), random_state=3)
    c = dst.random_array((300, 7), random_state=4)
    v = a.collect()
    assert v.shape == (300, 7) and v.dtype == np.float32
    assert v.min() >= 0.0 and v.max() < 1.0 and abs(v.mean() - 0.5) < 0.05
    np.testing.assert_array_equal(v, b.collect())
    assert not np.array_equal(v, c.collect())
    assert dst.random_array((2, 2), random_state=
                            np.random.RandomState(0)).shape == (2, 2)


def test_random_array_draw_is_one_function(monkeypatch):
    """Every uniform draw goes through ``_random_uniform``: replacing it
    replaces the array."""
    import importlib
    port_array = importlib.import_module("dislib_tpu_torch.data.array")
    monkeypatch.setattr(port_array, "_random_uniform",
                        lambda seed, pshape, shape, dtype, device:
                        torch.full(pshape, 0.25, dtype=dtype))
    np.testing.assert_array_equal(
        dst.random_array((3, 2), random_state=0).collect(),
        np.full((3, 2), 0.25, np.float32))


def test_astype_copy_iterator_match_reference():
    x = _mk((11, 5), 11)
    rx, px_ = _both(x, block_size=(4, 2))
    assert px_.astype(np.float64).dtype == torch.float64
    np.testing.assert_array_equal(px_.astype(np.int32).collect(),
                                  rx.astype(np.int32).collect())
    cp = px_.copy()
    cp._data.zero_()
    np.testing.assert_array_equal(px_.collect(), x)
    for axis in (0, 1):
        got = [b.collect() for b in px_.iterator(axis)]
        want = [b.collect() for b in rx.iterator(axis)]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_concat_matches_reference():
    xs = [_mk((3, 4), 12), _mk((5, 4), 13)]
    np.testing.assert_array_equal(
        dst.concat_rows([dst.array(v) for v in xs]).collect(),
        ds.concat_rows([ds.array(v) for v in xs]).collect())
    ys = [_mk((6, 2), 14), _mk((6, 3), 15)]
    np.testing.assert_array_equal(
        dst.concat_cols([dst.array(v) for v in ys]).collect(),
        ds.concat_cols([ds.array(v) for v in ys]).collect())
    with pytest.raises(ValueError, match="column counts"):
        dst.concat_rows([dst.array(xs[0]), dst.array(ys[0])])
    with pytest.raises(ValueError, match="at least one"):
        dst.concat_cols([])


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("name", ["double", "sum", "sq_pair"])
def test_apply_along_axis_matches_reference(name, axis):
    funcs = {"double": lambda v: v * 2.0, "sum": lambda v: v.sum(),
             "sq_pair": lambda v: (v * v)[:2]}
    x = _mk((7, 4), 16)
    rx, px_ = _both(x)
    want = ds.apply_along_axis(funcs[name], axis, rx).collect()
    with warnings.catch_warnings():
        warnings.simplefilter("error")        # the device tier: no warning
        got = dst.apply_along_axis(funcs[name], axis, px_)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.collect(), want, rtol=1e-6)


def test_apply_along_axis_host_tier_warns():
    x = _mk((6, 3), 17)
    rx, px_ = _both(x)

    def host_only(v):
        return float(np.median(np.asarray(v)))

    with pytest.warns(UserWarning, match="host NumPy"):
        want = ds.apply_along_axis(host_only, 0, rx).collect()
    with pytest.warns(UserWarning, match="host NumPy"):
        got = dst.apply_along_axis(host_only, 0, px_)
    np.testing.assert_allclose(got.collect(), want, rtol=1e-6)


def test_util_matches_reference():
    x = _mk((7, 5), 18)
    rx, px_ = _both(x, block_size=(3, 2))
    pairs = [
        (ref_util.pad(rx, ((1, 2), (0, 3)), 4.0),
         port_util.pad(px_, ((1, 2), (0, 3)), 4.0)),
        (ref_util.pad_last_blocks_with_zeros(rx),
         port_util.pad_last_blocks_with_zeros(px_)),
        (ref_util.remove_last_rows(rx, 2), port_util.remove_last_rows(px_, 2)),
        (ref_util.remove_last_columns(rx, 3),
         port_util.remove_last_columns(px_, 3)),
    ]
    for ref, port in pairs:
        np.testing.assert_array_equal(port.collect(), ref.collect())
    assert port_util.compute_bottom_right_shape(px_) == \
        ref_util.compute_bottom_right_shape(rx) == (1, 1)


# -- the distance and sync API (the rest of A.4) ---------------------------------

@pytest.mark.parametrize("precision", [None, "highest", "default"])
def test_array_distances_sq_matches_reference(precision):
    from dislib_tpu.ops.base import distances_sq as ref_dist
    from dislib_tpu_torch.ops.base import distances_sq as port_dist
    (ra, pa), (rb, pb) = _both(_mk((53, 9))), _both(_mk((6, 9), seed=1))
    ref = ref_dist(ra, rb, precision=precision)
    got = port_dist(pa, pb, precision=precision)
    assert isinstance(got, PortArray) and got.shape == ref.shape == (53, 6)
    assert got.dtype == torch.float32 and _pad_is_zero(got)
    want = np.asarray(ref.collect())
    scale = float((_mk((53, 9)) ** 2).sum(1).max()
                  + (_mk((6, 9), seed=1) ** 2).sum(1).max())
    # float32-faithful: the reference's 1e-5 formulation tolerance; "default"
    # is one bf16 pass in the port, where the reference's CPU backend runs
    # float32: within the bf16 rounding of the cross term (2^-8 of the
    # magnitudes that cancel)
    tol = 2.0 ** -8 if precision == "default" else 1e-5
    assert np.abs(got.collect() - want).max() <= tol * scale
    assert (got.collect() >= 0).all()


def test_array_distances_sq_raises_as_the_reference():
    from dislib_tpu.ops.base import distances_sq as ref_dist
    from dislib_tpu_torch.ops.base import distances_sq as port_dist
    (ra, pa), (rb, pb) = _both(_mk((5, 3))), _both(_mk((4, 2)))
    for dist, a, b in ((ref_dist, ra, rb), (port_dist, pa, pb)):
        with pytest.raises(ValueError, match=r"feature dims differ \(3 vs 2\)"):
            dist(a, b)
    import scipy.sparse as sp
    for dist, a in ((ref_dist, ra), (port_dist, pa)):
        for other in (_mk((4, 3)), sp.csr_matrix(_mk((4, 3)))):
            with pytest.raises(TypeError, match="BOTH operands"):
                dist(a, other)
    with pytest.raises(TypeError, match="BOTH operands"):
        port_dist(torch.from_numpy(_mk((4, 3))), pa)


def test_force_is_lazy_block_until_ready_as_an_eager_array():
    ra, pa = _both(_mk((7, 3)))
    rs, ps = ra + 1.0, pa + 1.0
    rs.force()
    assert ps.is_lazy is False and rs.is_lazy is False
    assert ps.force() is ps and ps.block_until_ready() is ps
    assert rs.block_until_ready() is rs
    np.testing.assert_array_equal(ps.collect(), np.asarray(rs.collect()))
