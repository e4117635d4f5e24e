"""The port's CascadeSVM against the reference's, on CPU.

The same numpy inputs go through ``dislib_tpu`` (8 virtual CPU devices)
and ``dislib_tpu_torch`` on the CPU (its plain versions: the batched Gram
is a float32 ``bmm``).  Both run float32 dual solves that stop on
``delta ≤ 1e-6`` or at 500 steps; their GEMVs sum in different orders.
On these blobs (256 × 4, part 64, two iterations) the support-vector
sets are equal; tolerances: α within 1e-4 (α ≤ C = 1), the top node's
dual objective within rtol 1e-5 (read from each package's
``_solve_level_batched``), decision values within 1e-4, predictions
equal where |decision| > 1e-3.  The port's ELL path
gathers the same float32 values as its dense path, so the two fits are
equal; its host-CSR path computes the kernel blocks with scipy, so α is
held within 1e-4 and the support vectors equal (the port stages a
node's padded slots as row 0 on every path; the reference's host-CSR
path zeroes them, ROADMAP.md C.12, so its CSR fit is not held to).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import dislib_tpu as ds
from dislib_tpu.classification import CascadeSVM as RefSVM
from dislib_tpu.classification import csvm as ref_csvm
from dislib_tpu.data.sparse import SparseArray as RefSparse

import dislib_tpu_torch as dst
from dislib_tpu_torch.classification import CascadeSVM as PortSVM
from dislib_tpu_torch.classification import csvm as port_csvm
from dislib_tpu_torch.ops import kernels as K
from dislib_tpu_torch.utils import profiling as prof

ALPHA_TOL, OBJ_RTOL, DEC_TOL = 1e-4, 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _port_on_cpu():
    # one thread: the dual solves are many small ops, which threads only
    # slow down when the suite's workers share the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    dst.init(device="cpu")
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def objectives(monkeypatch):
    """The objectives of the last level each package solved (the top
    node's first): both packages' ``_solve_level_batched`` wrapped."""
    seen = {}
    for key, mod in (("ref", ref_csvm), ("port", port_csvm)):
        def wrapped(*a, _orig=mod._solve_level_batched, _key=key, **kw):
            out = _orig(*a, **kw)
            seen[_key] = np.asarray(out[1], np.float64)
            return out
        monkeypatch.setattr(mod, "_solve_level_batched", wrapped)
    return seen


def _blobs(seed=0, m=256, d=4, sep=2.5):
    rng = np.random.RandomState(seed)
    x = np.vstack([rng.randn(m // 2, d), rng.randn(m // 2, d) + sep])
    y = np.r_[np.zeros(m // 2), np.ones(m // 2)]
    p = rng.permutation(m)
    q = rng.randn(50, d) + sep / 2
    return (x[p].astype(np.float32), y[p].astype(np.float32)[:, None],
            q.astype(np.float32))


def _sparse_problem(seed=3, m=320, n=30, density=0.3):
    """Rows of ~9 nonzeros in (0, 3); labels the sign of a planted linear
    score, rows within half a standard deviation of the boundary
    dropped."""
    rng = np.random.RandomState(seed)
    mat = sp.random(m, n, density=density, random_state=rng,
                    format="csr", dtype=np.float32)
    mat.data *= np.float32(3.0)
    score = mat @ rng.randn(n)
    score -= np.median(score)
    keep = np.abs(score) > 0.5 * score.std()
    return mat[keep], (score[keep] > 0).astype(np.float32)[:, None]


def _hold(ref, port, q_ref, q_port):
    np.testing.assert_array_equal(port._sv_idx, ref._sv_idx)
    np.testing.assert_allclose(port._sv_alpha, ref._sv_alpha, rtol=0,
                               atol=ALPHA_TOL)
    np.testing.assert_allclose(port._sv_y, ref._sv_y)
    assert port.support_vectors_count_ == ref.support_vectors_count_
    assert port.n_iter_ == ref.n_iter_
    dr = ref.decision_function(q_ref).collect().ravel()
    dp = port.decision_function(q_port).collect().ravel()
    np.testing.assert_allclose(dp, dr, rtol=0, atol=DEC_TOL)
    clear = np.abs(dr) > 1e-3
    np.testing.assert_array_equal(
        port.predict(q_port).collect().ravel()[clear],
        ref.predict(q_ref).collect().ravel()[clear])


@pytest.mark.parametrize("solver", ["pg", "fista"])
@pytest.mark.parametrize("kernel", ["rbf", "linear"])
def test_dense_matches_reference(kernel, solver, monkeypatch, objectives):
    monkeypatch.setenv("DSLIB_CSVM_SOLVER", solver)
    x, y, q = _blobs()
    kw = dict(kernel=kernel, max_iter=2, check_convergence=False)
    if (kernel, solver) == ("rbf", "pg"):
        # integer labels and the convergence test (a loose tol stops the
        # second iteration), the rest as in the other cases
        y = np.where(y > 0, 7, -3).astype(np.int32)
        kw.update(check_convergence=True, tol=0.5)
    ref = RefSVM(**kw).fit(ds.array(x, block_size=(64, 4)), ds.array(y))
    prof.reset_host_reads()
    port = PortSVM(**kw).fit(dst.array(x, block_size=(64, 4)),
                             dst.array(y))
    # level reads, plus at most one read per chunk of 8 of 500 steps
    assert 0 < prof.HOST_READS["csvm"] <= 2 * 5 * (1 + 500 // 8)
    np.testing.assert_allclose(objectives["port"][0], objectives["ref"][0],
                               rtol=OBJ_RTOL)
    _hold(ref, port, ds.array(q), dst.array(q))
    assert port.score(dst.array(x), dst.array(y)) == \
        ref.score(ds.array(x), ds.array(y)) >= 0.97
    np.testing.assert_array_equal(port.classes_, ref.classes_)
    assert port.converged_ == ref.converged_
    assert port.iterations_n == ref.iterations_n
    assert port.predict(dst.array(q)).collect().dtype == \
        ref.predict(ds.array(q)).collect().dtype


def test_sparse_fits_equal_the_dense_fit(monkeypatch):
    """ELL staging (bit-equal to the dense fit), the host-CSR fallback
    (within the tolerances) and the reference's ELL fit."""
    mat, y = _sparse_problem()
    kw = dict(max_iter=2, check_convergence=False)
    dense = PortSVM(**kw).fit(dst.array(mat.toarray(), block_size=(64, 30)),
                              dst.array(y))
    xs = dst.SparseArray.from_scipy(mat, block_size=(64, 30))
    assert xs.ell() is not None
    ell = PortSVM(**kw).fit(xs, dst.array(y))
    for name in ("_sv_idx", "_sv_alpha", "_sv_x", "_sv_y"):
        np.testing.assert_array_equal(getattr(ell, name),
                                      getattr(dense, name))
    ref = RefSVM(**kw).fit(RefSparse.from_scipy(mat, block_size=(64, 30)),
                           ds.array(y))
    q = mat[:40]
    _hold(ref, ell, RefSparse.from_scipy(q), dst.SparseArray.from_scipy(q))
    monkeypatch.setenv("DSLIB_SPARSE_ELL_BUDGET", "64")
    assert xs.ell() is None                 # re-checked against the cache
    csr = PortSVM(**kw).fit(xs, dst.array(y))
    np.testing.assert_array_equal(csr._sv_idx, dense._sv_idx)
    np.testing.assert_allclose(csr._sv_alpha, dense._sv_alpha, rtol=0,
                               atol=ALPHA_TOL)
    np.testing.assert_array_equal(csr._sv_x, dense._sv_x)


@pytest.mark.parametrize("kernel", ["rbf", "linear"])
def test_sparse_queries_match_dense_queries(kernel):
    x, y, q = _blobs(seed=2)
    q[np.abs(q) < 0.6] = 0.0                        # some zeros to skip
    port = PortSVM(kernel=kernel, max_iter=1).fit(
        dst.array(x, block_size=(64, 4)), dst.array(y))
    qs = dst.SparseArray.from_scipy(sp.csr_matrix(q))
    d_sparse = port.decision_function(qs).collect().ravel()
    d_dense = port.decision_function(dst.array(q)).collect().ravel()
    np.testing.assert_allclose(d_sparse, d_dense, rtol=0, atol=DEC_TOL)
    np.testing.assert_array_equal(port.predict(qs).collect(),
                                  port.predict(dst.array(q)).collect())


@pytest.mark.parametrize("shape", [(3, 64, 4), (5, 16, 7), (1, 128, 20)],
                         ids=str)
def test_batched_gram_plain_matches_reference(shape):
    import jax
    import jax.numpy as jnp
    x = np.random.RandomState(shape[1]).randn(*shape).astype(np.float32)
    gamma = 1.0 / shape[2]
    want = np.asarray(jax.vmap(lambda a: ref_csvm._gram(
        a, a, "rbf", gamma))(jnp.asarray(x)))
    t = torch.from_numpy(x)
    got = torch.exp(-gamma * K.distances_sq_batched(t, t)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got, torch.exp(
        -gamma * K.distances_sq_batched_plain(t, t)).numpy())
    assert K.LAUNCHES["distances_sq"] == 0                  # CPU: plain


def test_two_fits_are_identical_and_refusals(tmp_path):
    from dislib_tpu_torch.utils.checkpoint import FitCheckpoint
    x, y, _ = _blobs(seed=4, m=160)
    a = PortSVM(max_iter=2).fit(dst.array(x, block_size=(32, 4)),
                                dst.array(y))
    b = PortSVM(max_iter=2).fit(dst.array(x, block_size=(32, 4)),
                                dst.array(y))
    for name in ("_sv_idx", "_sv_alpha", "_sv_x"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    # checkpoint= is ported: a checkpointed fit is the same fit
    c = PortSVM(max_iter=2).fit(
        dst.array(x, block_size=(32, 4)), dst.array(y),
        checkpoint=FitCheckpoint(str(tmp_path / "csvm.npz")))
    np.testing.assert_array_equal(c._sv_alpha, a._sv_alpha)
    with pytest.raises(ValueError, match="kernel"):
        PortSVM(kernel="poly").fit(dst.array(x), dst.array(y))
    with pytest.raises(ValueError, match="binary"):
        PortSVM().fit(dst.array(x),
                      dst.array(np.arange(160, dtype=np.float32)[:, None]))
    with pytest.raises(RuntimeError, match="not fitted"):
        PortSVM().predict(dst.array(x))
    with pytest.raises(TypeError):
        PortSVM().fit(x, dst.array(y))
    assert dst.CascadeSVM is PortSVM
