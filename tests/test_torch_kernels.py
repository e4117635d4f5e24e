"""The port's kernel module against the reference's Pallas kernels, on CPU.

The reference kernels (``dislib_tpu/ops/pallas_kernels.py``) run in Pallas
interpret mode, as the reference's own tests run them; the port's wrappers
receive CPU tensors and therefore run their plain PyTorch versions.  Inputs
are made with numpy from a seed and handed to both packages.  The CUDA
kernels themselves run only on a card (``chip_smoke.py``).

Also here: the port's import rule, its refusal to pick the CPU silently,
and the kernel build's error when ``nvcc`` is missing.
"""

import ast
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dislib_tpu.ops import base as ref_base
from dislib_tpu.ops import pallas_kernels as ref_pk
from dislib_tpu.ops import precision as ref_px

import dislib_tpu_torch as dst
from dislib_tpu_torch import _build
from dislib_tpu_torch.ops import base as port_base
from dislib_tpu_torch.ops import kernels as port_k
from dislib_tpu_torch.ops import precision as port_px
from dislib_tpu_torch.parallel import mesh as port_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mk(shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    dst.init(device="cpu")
    port_k.reset_launches()
    yield


# -- (a) panel_gemm ------------------------------------------------------------

# Both sides contract the same operands with f32 accumulation: under
# FLOAT32 the f32 inputs at f32-faithful precision; under BFLOAT16 the
# bf16-rounded inputs (identical on both sides, round-to-nearest-even),
# whose products are exact in f32.  Only the f32 summation order differs.
# Every case is held to ERROR_BOUNDS[("matmul", "float32")] — the bound of an
# f32-faithful product — between the two.  The tiled shape is also held
# elementwise (FLOAT32 at 1e-6, the reference's own pallas-vs-pdot
# tolerance; BFLOAT16 at 1e-5).  At the ragged shape's k = 70 with values
# up to ~20 an elementwise 1e-6 is below what two f32 summation orders can
# agree to (they differ by up to ~6e-6 there), so it is held to the
# normalized bound only.
_GEMM_TOL = {"float32": 1e-6, "bfloat16": 1e-5}


def _normalized_diff(x, y, a, b):
    scale = np.linalg.norm(a) * np.linalg.norm(b) / np.sqrt(a.shape[1])
    return np.abs(x - y).max() / scale


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
@pytest.mark.parametrize("shapes", [((48, 32), (32, 40)),
                                    ((130, 70), (70, 33))],
                         ids=["tiled", "ragged"])
def test_panel_gemm_plain_matches_pallas(policy, shapes, request):
    a, b = _mk(shapes[0]), _mk(shapes[1], seed=1)
    want = np.asarray(ref_pk.panel_gemm(jnp.asarray(a), jnp.asarray(b),
                                        ref_px.resolve(policy)))
    got_plain = port_k.panel_gemm_plain(torch.from_numpy(a),
                                        torch.from_numpy(b),
                                        port_px.resolve(policy)).numpy()
    got = port_k.panel_gemm(torch.from_numpy(a), torch.from_numpy(b),
                            port_px.resolve(policy)).numpy()
    for out in (got_plain, got):
        assert out.dtype == want.dtype
        assert _normalized_diff(out, want, a, b) <= \
            port_px.ERROR_BOUNDS[("matmul", "float32")]
        if "tiled" in request.node.callspec.id:
            tol = _GEMM_TOL[policy]
            np.testing.assert_allclose(out, want, rtol=tol, atol=tol)
    assert port_k.LAUNCHES == {"panel_gemm": 0, "distances_sq": 0,
                              "node_histogram": 0}


# -- (b) distances_sq ----------------------------------------------------------

@pytest.mark.parametrize("shapes", [((24, 6), (20, 6)), ((130, 77), (10, 77))],
                         ids=["small", "ragged"])
def test_distances_sq_matches_pallas(shapes):
    a, b = _mk(shapes[0]), _mk(shapes[1], seed=1)
    ref_pallas = np.asarray(ref_pk.distances_sq(jnp.asarray(a),
                                                jnp.asarray(b)))
    ref_plain = np.asarray(ref_base.distances_sq(a, b))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    outs = [port_k.distances_sq_plain(ta, tb),
            port_k.distances_sq(ta, tb, precision="highest"),
            port_base.distances_sq(ta, tb),
            port_base.distances_sq(ta, tb, use_kernel=True)]
    for out in outs:
        out = out.numpy()
        assert out.dtype == ref_pallas.dtype
        # the reference's own pallas-vs-formulation tolerance
        np.testing.assert_allclose(out, ref_pallas, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out, ref_plain, rtol=1e-5, atol=1e-5)
        assert (out >= 0).all()
    assert port_k.LAUNCHES["distances_sq"] == 0


def test_distances_sq_rejects_unported_precision():
    # "default"/"bfloat16" (one bf16 pass) is ported; three bf16 passes
    # ("high") are not
    t = torch.zeros((4, 3))
    with pytest.raises(NotImplementedError, match="'high'"):
        port_k.distances_sq(t, t, precision="high")


# -- the CUDA route's argument checks, reached without a card -----------------

def test_wrappers_reject_mixed_devices():
    cpu = torch.zeros((4, 3))
    meta = torch.zeros((3, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        port_k.panel_gemm(cpu, meta)
    with pytest.raises(ValueError, match="CUDA device"):
        port_k.distances_sq(cpu, meta.T)
    node = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        port_k.node_histogram(node, torch.zeros((4, 3), dtype=torch.int32),
                              torch.ones((2, 4), device="meta"),
                              torch.ones((4, 2)), 1, 8)


# -- (g) the import rule -------------------------------------------------------

def test_import_pulls_in_neither_jax_nor_the_reference():
    """Every module of the package, imported in a fresh interpreter,
    leaves neither JAX nor the reference in ``sys.modules``."""
    code = ("import importlib, pkgutil, sys, dislib_tpu_torch as p; "
            "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
            "'dislib_tpu_torch.')]; "
            "[importlib.import_module(m) for m in mods]; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'dislib_tpu' "
            "or m.startswith('dislib_tpu.')]; print(len(mods), bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    n_mods, bad = out.stdout.strip().split(" ", 1)
    assert bad == "[]", out.stdout
    on_disk = sum(f.endswith(".py") for _, _, files in
                  os.walk(os.path.join(REPO, "dislib_tpu_torch"))
                  for f in files) - 1       # the package's own __init__
    assert int(n_mods) == on_disk, out.stdout


def test_package_source_has_no_forbidden_import():
    root = os.path.join(REPO, "dislib_tpu_torch")
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, files in os.walk(root):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    offenders = []
    for path in paths:
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                if n.split(".")[0] in ("jax", "jaxlib", "dislib_tpu"):
                    offenders.append(f"{path}: {n}")
    assert not offenders, offenders


# -- (h) no silent CPU ---------------------------------------------------------

def test_default_device_is_cuda_and_never_silently_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(port_mesh, "_default_mesh", None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dst.init()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dst.array(np.ones((3, 2), np.float32))
    # asking for the CPU works, runs the plain versions, launches nothing
    x = dst.array(_mk((40, 5)), device="cpu")
    km = dst.KMeans(n_clusters=3, random_state=0, max_iter=3).fit(x)
    km.predict(x)
    km.score(x)
    dst.matmul(x, x, transpose_b=True, algorithm="summa")
    assert port_k.LAUNCHES == {"panel_gemm": 0, "distances_sq": 0,
                              "node_histogram": 0}


def test_non_unit_mesh_names_the_roadmap_item():
    with pytest.raises(NotImplementedError, match="A.2"):
        dst.init((2, 1), device="cpu")


# -- (i) the build ---------------------------------------------------------------

def test_build_raises_clearly_without_nvcc(monkeypatch):
    import torch.utils.cpp_extension as ce
    monkeypatch.setattr(ce, "CUDA_HOME", None)
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library("distances_sq")


def test_every_source_has_a_bound_library():
    srcs = {os.path.splitext(f)[0] for f in os.listdir(_build.CSRC)
            if f.endswith(".cu")}
    assert srcs == set(_build.SIGNATURES)
    assert set(port_k.LAUNCHES) == srcs
