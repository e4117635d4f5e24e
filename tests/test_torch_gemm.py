"""``panel_gemm``'s tensor-core design on the CPU: its launch plan and the
FLOAT32 kernel's 3xTF32 arithmetic emulated in torch.

The CUDA kernel runs only on a card (``chip_smoke.py``, ``tests/
test_torch_cuda.py``).  What surrounds it is plain Python that runs here:
the plan (``ops/kernels.gemm_plan``: the padded K that TMA's 16-byte row
strides need, the tile counts, the shared memory a block takes).  The
FLOAT32 kernel splits each operand into TF32 hi = rna(x) and
lo = rna(x − hi) (``cvt.rna.tf32.f32``: round to 10 mantissa bits, ties
away from zero) and sums lo·hi + hi·lo + hi·hi in f32;
the emulation does the same with f32 matmuls on the CPU and is held against
the reference's ``panel_gemm`` FLOAT32 (Pallas interpret mode) within
``ERROR_BOUNDS[("matmul", "float32")]``.  A single-pass TF32 product's error
against float64 is shown to be more than 8× the 3xTF32 product's: the margin
the card gate (``chip_smoke.py``) asks of the kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dislib_tpu.ops import pallas_kernels as ref_pk
from dislib_tpu.ops import precision as ref_px

from dislib_tpu_torch.ops import kernels as K
from dislib_tpu_torch.ops import precision as px

# (m, k, n): the card tests' ragged shapes and the main path's
RAGGED = [(1, 5, 300), (129, 257, 130), (1000, 77, 33), (256, 128, 16),
          (300, 1000, 520), (4097, 2053, 259)]
MAIN = (16384, 16384, 16384)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("mkn", RAGGED + [MAIN], ids=str)
def test_gemm_plan(mkn, dt):
    m, k, n = mkn
    dtype = DTYPES[dt]
    esize = 4 if dtype == torch.float32 else 2
    p = K.gemm_plan(m, n, k, dtype)
    # TMA: K-major rows padded to a multiple of 16 bytes, by less than 16
    assert p.k_pad >= k and (p.k_pad * esize) % 16 == 0
    assert (p.k_pad - k) * esize < 16
    # one stage's K is one 128-byte swizzle span
    assert p.bk * esize == 128
    assert p.bm == 128 and p.bn in (128, 256)
    assert (p.tiles_m, p.tiles_n) == (_cdiv(m, p.bm), _cdiv(n, p.bn))
    assert (p.k_tiles - 1) * p.bk < p.k_pad <= p.k_tiles * p.bk
    # every stage holds hi (and lo) of a 128-row A tile and a bn-row Bt
    # tile; with the 1 KB kept for alignment and the mbarriers the block
    # fits in Hopper's 227 KB
    split = 2 if dtype == torch.float32 else 1
    assert p.smem_bytes == p.stages * split * (p.bm + p.bn) * 128 + 1024
    assert p.smem_bytes + 2 * 8 * p.stages <= K.GEMM_SMEM_LIMIT
    assert p.stages >= 3
    # bf16 A is read in place unless k needs padding; the main path's never
    assert p.pad_a == (dtype == torch.bfloat16 and k % 8 != 0)
    if mkn == MAIN:
        assert p.k_pad == k and not p.pad_a


def test_gemm_plan_copies_an_unaligned_bf16_a_only():
    assert K.gemm_plan(64, 64, 64, torch.bfloat16, a_ptr=8).pad_a
    assert not K.gemm_plan(64, 64, 64, torch.bfloat16, a_ptr=512).pad_a
    # the FLOAT32 prep pass writes fresh buffers whatever A's address
    assert not K.gemm_plan(64, 64, 61, torch.float32, a_ptr=8).pad_a


def test_gemm_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        K.gemm_plan(8, 8, 8, torch.float64)
    with pytest.raises(ValueError, match="32-bit"):
        K.gemm_plan(2**31, 8, 8, torch.float32)
    with pytest.raises(ValueError, match="32-bit"):
        K.gemm_plan(8, 8, 2**31 - 1, torch.bfloat16)


# -- the 3xTF32 arithmetic ---------------------------------------------------

def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on finite f32: keep 10 mantissa bits, rounding to
    nearest with ties away from zero (add half of the dropped range to the
    magnitude, then clear the 13 low bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def _gemm_3xtf32(a, b):
    (ah, al), (bh, bl) = _split(a), _split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def _normalized(c, ref, a, b):
    scale = np.linalg.norm(a) * np.linalg.norm(b) / np.sqrt(a.shape[1])
    return float(np.abs(np.asarray(c, np.float64) - ref).max() / scale)


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                      # TF32's ulp at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2**-23,
                      one + 3 * ulp / 2, 3.0, -0.0], dtype=torch.float32)
    want = [one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0, -0.0]
    got = _tf32_rna(x)
    assert got.tolist() == want
    assert bool(((got.view(torch.int32) & 0x1FFF) == 0).all())


def test_split_carries_22_bits():
    x = torch.from_numpy(np.random.RandomState(0).standard_normal(
        100_000).astype(np.float32))
    hi, lo = _split(x)
    for part in (hi, lo):
        assert bool(((part.view(torch.int32) & 0x1FFF) == 0).all())
    # hi + lo leaves less than 2^-21 of x (hi's rounding error is exact in
    # f32; lo keeps its leading 11 bits)
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -21 * x.double().abs()).all())


def test_3xtf32_matches_the_reference_and_is_8x_tighter_than_tf32():
    rng = np.random.RandomState(7)
    a = rng.standard_normal((256, 4096)).astype(np.float32)
    b = rng.standard_normal((4096, 256)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    want = np.asarray(ref_pk.panel_gemm(jnp.asarray(a), jnp.asarray(b),
                                        ref_px.FLOAT32))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = _gemm_3xtf32(ta, tb).numpy()
    bound = px.ERROR_BOUNDS[("matmul", "float32")]
    assert got.dtype == want.dtype == np.float32
    assert _normalized(got, want.astype(np.float64), a, b) <= bound
    err3 = _normalized(got, exact, a, b)
    err1 = _normalized((_tf32_rna(ta) @ _tf32_rna(tb)).numpy(), exact, a, b)
    assert err3 <= bound
    assert err1 > 8 * err3, (err1, err3)
    # the port's plain version (the CPU route of the wrapper) agrees too
    plain = K.panel_gemm(ta, tb, px.FLOAT32).numpy()
    assert _normalized(plain, exact, a, b) <= bound
