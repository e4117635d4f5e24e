"""The port's ds-array, precision policy and matmul against the reference's,
on CPU.

``matmul`` runs both of the port's routes — ``auto`` (one product through
``pdot``) and ``algorithm="summa"`` under ``DSLIB_OVERLAP=pallas`` (the panel
loop with the hand-kernel consume step, which on CPU tensors runs its plain
version).  Each result is held to ``ERROR_BOUNDS[("matmul", policy)]``
against a float64 NumPy product and to the reference's ``ds.matmul`` on its
default route (its Pallas-in-``shard_map`` route fails under the installed
jax, so it is no oracle here).
"""

import warnings

import numpy as np
import pytest
import torch

import dislib_tpu as ds
from dislib_tpu.ops import precision as ref_px

import dislib_tpu_torch as dst
from dislib_tpu_torch.ops import kernels as port_k
from dislib_tpu_torch.ops import overlap as port_ov
from dislib_tpu_torch.ops import precision as port_px


def _mk(shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    dst.init(device="cpu")
    port_k.reset_launches()
    yield


def _normalized_err(c, ref, a, b):
    """max |C - C_ref| / (‖A‖_F ‖B‖_F / sqrt(k)) — ERROR_BOUNDS' matmul
    metric."""
    k = a.shape[1]
    scale = np.linalg.norm(a) * np.linalg.norm(b) / np.sqrt(k)
    return np.abs(c - ref).max() / scale


# the reference's default route and the port both contract the same
# (policy-rounded) operands with f32 accumulation; the sums differ only in
# order, so they agree far inside the policy bound
_VS_REF = {"float32": 1e-5, "bfloat16": 1e-5}


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["auto", "summa"])
@pytest.mark.parametrize("ta,tb", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_matmul_matches_reference_and_f64(policy, route, ta, tb,
                                          monkeypatch):
    monkeypatch.setenv("DSLIB_OVERLAP", "pallas")
    a = _mk((50, 37) if ta else (37, 50))
    b = _mk((29, 50) if tb else (50, 29), seed=1)
    la, lb = (a.T if ta else a), (b.T if tb else b)
    want64 = la.astype(np.float64) @ lb.astype(np.float64)
    got = dst.matmul(dst.array(a), dst.array(b), ta, tb, algorithm=route,
                     precision=policy).collect()
    ref = ds.matmul(ds.array(a), ds.array(b), ta, tb,
                    precision=policy).collect()
    assert got.shape == ref.shape == (37, 29)
    assert got.dtype == ref.dtype
    assert _normalized_err(got, want64, la, lb) <= \
        port_px.ERROR_BOUNDS[("matmul", policy)]
    np.testing.assert_allclose(got, ref, rtol=_VS_REF[policy],
                               atol=_VS_REF[policy])
    assert port_k.LAUNCHES["panel_gemm"] == 0


@pytest.mark.parametrize("sched", ["db", "seq", "pallas"])
def test_summa_schedules_are_bit_equal(sched, monkeypatch):
    monkeypatch.setenv("DSLIB_OVERLAP", "db")
    a, b = dst.array(_mk((33, 20))), dst.array(_mk((20, 18), seed=1))
    base = dst.matmul(a, b, algorithm="summa").collect()
    monkeypatch.setenv("DSLIB_OVERLAP", sched)
    got = dst.matmul(a, b, algorithm="summa").collect()
    np.testing.assert_array_equal(got, base)


@pytest.mark.parametrize("steps", [1, 2, 5])
@pytest.mark.parametrize("overlap", [False, True])
def test_panel_pipeline_consumes_in_order(steps, overlap):
    seen = []
    acc = port_ov.panel_pipeline(
        steps, 0, lambda t, prev: t,
        lambda t, acc, pan: seen.append((t, pan)) or acc + [pan], [],
        overlap)
    assert acc == list(range(steps))
    assert seen == [(t, t) for t in range(steps)]


def test_overlap_resolve_aliases_and_errors(monkeypatch):
    assert port_ov.resolve("pallas") == "kernel"
    assert port_ov.resolve("seq") == "seq"
    monkeypatch.setenv("DSLIB_OVERLAP", "pallas")
    assert port_ov.resolve() == "kernel"
    with pytest.raises(ValueError, match="unknown overlap schedule"):
        port_ov.resolve("bogus")


def test_matmul_errors():
    a = dst.array(_mk((4, 3)))
    with pytest.raises(ValueError, match="shape mismatch"):
        dst.matmul(a, a)
    with pytest.raises(ValueError, match="unknown matmul algorithm"):
        dst.matmul(a, a, transpose_b=True, algorithm="bogus")


# -- (e) ds.array ---------------------------------------------------------------

@pytest.mark.parametrize("shape,block", [((37, 11), None), ((37, 11), (8, 4)),
                                         ((5, 3), (100, 100)), ((11,), None)])
def test_array_roundtrip_and_block_clamp(shape, block):
    # the default block size is the shape over the mesh grid: hold the
    # port's one-device mesh against the reference on a (1, 1) mesh
    ds.init((1, 1))
    x = _mk(shape)
    ref = ds.array(x, block_size=block)
    got = dst.array(x, block_size=block)
    assert got.shape == ref.shape
    assert got.block_size == ref.block_size
    np.testing.assert_array_equal(got.collect(), ref.collect())
    np.testing.assert_array_equal(got.T.collect(), ref.T.collect())
    idx = [4, 0, 2] if got.shape[0] > 4 else [0]
    np.testing.assert_array_equal(got[idx, :].collect(),
                                  ref[idx, :].collect())


def test_array_float64_policy():
    x = np.random.RandomState(0).rand(6, 4)
    for mod in (ds, dst):
        with pytest.warns(UserWarning, match="narrowing it to float32"):
            a = mod.array(x)
        assert a.collect().dtype == np.float32
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        a = dst.array(x, dtype=np.float32)
        b = dst.array(x, dtype=np.float64)
    assert a.dtype == torch.float32
    assert b.dtype == torch.float64
    np.testing.assert_array_equal(b.collect(), x)


def test_zeros_and_errors():
    z = dst.zeros((3, 5))
    assert z.shape == (3, 5) and not z.collect().any()
    x = dst.array(_mk((6, 4)))
    with pytest.raises(IndexError):
        x[[9], :]
    with pytest.raises(ValueError, match="2-dimensional"):
        dst.array(np.zeros((2, 2, 2), np.float32))
    with pytest.raises(ValueError, match="positive"):
        dst.array(_mk((3, 3)), block_size=(0, 1))


# -- (f) the policy table ---------------------------------------------------------

def test_policy_tables_equal_the_reference():
    assert port_px.ERROR_BOUNDS == ref_px.ERROR_BOUNDS
    assert tuple(port_px.FLOAT32) == tuple(ref_px.FLOAT32)
    assert tuple(port_px.BFLOAT16) == tuple(ref_px.BFLOAT16)
    assert port_px.Policy._fields == ref_px.Policy._fields
    assert port_px._ALIASES == ref_px._ALIASES


@pytest.mark.parametrize("name", ["f32", "fp32", "highest", "bf16",
                                  "BFLOAT16", None])
def test_resolve_matches_reference(name, monkeypatch):
    monkeypatch.setenv("DSLIB_MATMUL_PRECISION", "bf16")
    assert tuple(port_px.resolve(name)) == tuple(ref_px.resolve(name))


def test_precise_scopes_tf32_and_to_compute_floor():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with port_px.precise():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32

        @port_px.precise
        def inside():
            return torch.backends.cuda.matmul.allow_tf32
        assert inside() is False
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    x64 = torch.ones(2, dtype=torch.float64)
    assert port_px.to_compute(x64, port_px.FLOAT32).dtype == torch.float64
    assert port_px.to_compute(x64, port_px.BFLOAT16).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="unknown precision policy"):
        port_px.resolve("fp8")


@pytest.mark.parametrize("subscripts,sa,sb", [
    ("wmi,wij->mwj", (3, 5, 4), (3, 4, 6)),     # the block-Jacobi pair
    ("nwi,wji->nwj", (5, 3, 4), (3, 6, 4)),     # updates of math.base.svd
    ("ij,jk->ik", (3, 4), (4, 5)),
    ("bij,bjk->bik", (2, 3, 4), (2, 4, 5))])
def test_bfloat16_einsum_as_one_batched_product(subscripts, sa, sb):
    # BFLOAT16 on a card runs peinsum as one bmm with a float32 result
    # (aten::bmm.dtype, CUDA only); the layout around it is plain torch,
    # held here with a float64 bmm in its place
    from dislib_tpu_torch.ops import precision as px
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(sa, generator=g), torch.randn(sb, generator=g)

    def bmm(x, y):
        return torch.bmm(x.double(), y.double())

    got = px._einsum_as_bmm(subscripts, a, b, bmm=bmm)
    want = torch.einsum(subscripts, a.double(), b.double())
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("sa,sb", [((3, 4), (4,)), ((4,), (4, 5)),
                                   ((2, 3, 4), (2, 4, 5)),
                                   ((2, 3, 4), (4, 5)), ((3, 4), (2, 4, 5))])
def test_bfloat16_matmul_as_mm_or_bmm(sa, sb):
    # pdot's native bf16 route: torch.matmul's broadcasting through mm/bmm
    from dislib_tpu_torch.ops import precision as px
    g = torch.Generator().manual_seed(1)
    a, b = torch.randn(sa, generator=g), torch.randn(sb, generator=g)
    got = px._matmul_f32_out(
        a, b, mm=lambda x, y: torch.mm(x.double(), y.double()),
        bmm=lambda x, y: torch.bmm(x.double(), y.double()))
    want = torch.matmul(a.double(), b.double())
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_bfloat16_on_the_cpu_keeps_the_f32_contraction():
    # CPU torch has no aten::mm.dtype: CPU tensors upcast the bf16-rounded
    # operands and contract in f32, the same function
    from dislib_tpu_torch.ops import precision as px
    g = torch.Generator().manual_seed(2)
    a, b = torch.randn((7, 5), generator=g), torch.randn((5, 3), generator=g)
    got = px.pdot(a, b, px.BFLOAT16)
    want = a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)
