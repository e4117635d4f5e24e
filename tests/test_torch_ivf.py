"""The port's IVF index against the reference's, on CPU.

The same numpy catalog goes through ``dislib_tpu`` (8 virtual CPU
devices) and ``dislib_tpu_torch`` on the CPU, where the quantizer's
``distances_sq`` and the search's ``panel_gemm`` (under
``overlap="kernel"``) run their plain versions.  The reference stripes
its lists over 8 shards and the port keeps one, so the layouts are held
by membership (the catalog ids of each list), not by buffer.

Tolerances: list membership equal; the quantizer's centroids within
1e-4; search ids equal on tie-free data; d² within 1e-5 of the
magnitudes that cancel in ‖q‖² − 2q·x + ‖x‖² (max ‖q‖² + max ‖x‖²; both
packages compute that form in float32, in another order);
``nprobe = n_lists`` equal in ids to the port's exact
``NearestNeighbors``; unfillable slots (+∞, −1) exactly.
"""

import numpy as np
import pytest
import torch

import dislib_tpu as ds
from dislib_tpu.retrieval import IVFIndex as RefIVF

import dislib_tpu_torch as dst
from dislib_tpu_torch.ops import kernels as port_k
from dislib_tpu_torch.parallel import mesh as port_mesh
from dislib_tpu_torch.retrieval import IVFIndex
from dislib_tpu_torch.retrieval import ivf as port_ivf

D, NL = 16, 4


@pytest.fixture(autouse=True)
def _port_on_cpu():
    dst.init(device="cpu")
    port_k.reset_launches()
    yield
    assert port_k.LAUNCHES == {"panel_gemm": 0, "distances_sq": 0,
                               "node_histogram": 0}


@pytest.fixture(scope="module")
def blobs():
    """``tests/test_retrieval.py``'s clustered catalog (4 blobs, 128 rows)
    and queries drawn from the same blobs."""
    rng = np.random.RandomState(7)
    centers = rng.randn(NL, D).astype(np.float32) * 20
    x = (centers[rng.randint(0, NL, 128)]
         + rng.randn(128, D)).astype(np.float32)
    q = (centers[rng.randint(0, NL, 24)]
         + rng.randn(24, D)).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def fitted(blobs):
    x, _ = blobs
    dst.init(device="cpu")
    ref = RefIVF(n_lists=NL, kmeans_max_iter=5, random_state=0).fit(x)
    port = IVFIndex(n_lists=NL, kmeans_max_iter=5, random_state=0).fit(
        dst.array(x, device="cpu"))
    return ref, port


def _members(ix):
    """{list: sorted catalog ids} of the port's layout."""
    ids = ix._ids.numpy()
    offs, cnts = ix._offs.numpy(), ix._cnts.numpy()
    return {l: sorted(ids[offs[l]: offs[l] + cnts[l]].tolist())
            for l in range(ix.n_lists_)}


def _scale(q, x):
    return float((q.astype(np.float64) ** 2).sum(1).max()
                 + (x.astype(np.float64) ** 2).sum(1).max())


def test_lists_and_quantizer_match_the_reference(blobs, fitted):
    x, _ = blobs
    ref, port = fitted
    assert (port.n_lists_, port.n_items, port.d) == (NL, 128, D)
    np.testing.assert_allclose(port.quantizer_.centers_,
                               ref.quantizer_.centers_, rtol=0, atol=1e-4)
    want = {l: sorted(np.flatnonzero(ref._labels_h == l).tolist())
            for l in range(NL)}
    assert _members(port) == want
    # pads: id -1, zero vector and norm; every list padded to the quantum
    ids = port._ids.numpy()
    assert (port._vecs.numpy()[ids < 0] == 0).all()
    assert (port._vsq.numpy()[ids < 0] == 0).all()
    assert (port._offs.numpy() % 8 == 0).all()
    pw = port.pad_waste
    assert pw["entries"] == 128 and pw["buffer_rows"] == len(ids)
    assert pw["list_pad_entries"] == len(ids) - 128
    assert pw["cap"] == max(-(-c // 8) * 8 for c in port._cnts.tolist())


@pytest.mark.parametrize("overlap", ["db", "seq", "kernel"])
@pytest.mark.parametrize("nprobe", [1, 2, NL])
def test_search_matches_the_reference(blobs, fitted, overlap, nprobe):
    x, q = blobs
    ref, port = fitted
    # the reference's Pallas route fails inside shard_map under the
    # installed jax (ROADMAP.md C.1): every port route is held to its db
    rd, ri = ref.search(ds.array(q), k=5, nprobe=nprobe, overlap="db")
    pd, pi = port.search(dst.array(q, device="cpu"), k=5, nprobe=nprobe,
                         overlap=overlap)
    ri, pi = ri.collect(), pi.collect()
    assert pi.dtype == np.int32 and pi.shape == (24, 5)
    # tie-free: every query's candidate d² are distinct in float64
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_allclose(pd.collect() ** 2, rd.collect() ** 2,
                               rtol=0, atol=1e-5 * _scale(q, x))


def test_full_probe_equals_the_exact_kneighbors(blobs, fitted):
    x, q = blobs
    _, port = fitted
    nn = dst.NearestNeighbors(n_neighbors=7).fit(dst.array(x, device="cpu"))
    ed, ei = nn.kneighbors(dst.array(q, device="cpu"))
    pd, pi = port.search(q, k=7, nprobe=NL)
    np.testing.assert_array_equal(pi.collect(), ei.collect())
    np.testing.assert_allclose(pd.collect() ** 2, ed.collect() ** 2,
                               rtol=0, atol=1e-5 * _scale(q, x))


def test_probe_chunks_and_query_blocks_change_nothing(blobs, fitted,
                                                      monkeypatch):
    _, q = blobs
    _, port = fitted
    d0, i0 = (a.collect() for a in port.search(q, k=5, nprobe=3))
    # one probe a chunk (PROBE_BLOCK below cap), three query rows a block
    monkeypatch.setattr(port_ivf, "PROBE_BLOCK", 1)
    monkeypatch.setattr(port_ivf, "PANEL_BYTES", 3 * port._cap * D * 4)
    d1, i1 = (a.collect() for a in port.search(q, k=5, nprobe=3))
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_array_equal(d0, d1)


def test_unfillable_slots_and_empty_lists_match_the_reference():
    # crafted through the layout seam: list 2 empty, list 0 with 3 rows;
    # k = 6 > the 3 + pad slots that nprobe = 1 reaches from list 0
    rng = np.random.RandomState(3)
    x = rng.randn(40, 5).astype(np.float32)
    labels = np.r_[[0, 0, 0], rng.choice([1, 3], 37)]
    cents = np.stack([x[labels == l].mean(0) if (labels == l).any()
                      else np.full(5, 50.0) for l in range(4)]).astype(
                          np.float32)
    ref = RefIVF(n_lists=4)._build(x, labels, cents)
    port = IVFIndex(n_lists=4)._build(x, labels, cents, device="cpu")
    # queries at list 0's centroid: one probe reaches its 3 rows only
    q = cents[0] + np.array([[0.0], [0.01], [-0.01]], np.float32)
    for nprobe in (1, 4):
        rd, ri = (a.collect() for a in ref.search(ds.array(q), k=6,
                                                  nprobe=nprobe))
        pd, pi = (a.collect() for a in port.search(q, k=6, nprobe=nprobe))
        np.testing.assert_array_equal(pi, ri)
        np.testing.assert_array_equal(np.isinf(pd), np.isinf(rd))
        fin = np.isfinite(rd)
        np.testing.assert_allclose(pd[fin] ** 2, rd[fin] ** 2, rtol=0,
                                   atol=1e-5 * _scale(q, x))
    assert (pi != -1).all()                      # nprobe = 4 fills all
    pd1, pi1 = (a.collect() for a in port.search(q, k=6, nprobe=1))
    assert (pi1[:, 3:] == -1).all() and np.isinf(pd1[:, 3:]).all()
    assert (np.sort(pi1[:, :3], axis=1) == [0, 1, 2]).all()


def test_default_n_lists_and_errors(blobs):
    x, _ = blobs
    ix = IVFIndex(kmeans_max_iter=2, random_state=0).fit(
        dst.array(x[:64], device="cpu"))
    assert ix.n_lists_ == 8 and ix.quantizer_.n_clusters == 8
    with pytest.raises(ValueError, match="features"):
        ix.search(x[:2, :5])
    with pytest.raises(ValueError, match="k must be"):
        ix.search(x[:2], k=0)
    with pytest.raises(RuntimeError, match="not fitted"):
        IVFIndex().search(x[:2])
    with pytest.raises(NotImplementedError, match="A.12"):
        IVFIndex().fit(x, checkpoint=object())
    with pytest.raises(NotImplementedError, match="A.2"):
        ix.rebind_mesh(port_mesh.Mesh(2, 1, torch.device("cpu")))
    assert ix.rebind_mesh(port_mesh.make_mesh((1, 1), "cpu")) is False
    with pytest.raises(ValueError, match="list quantum"):
        IVFIndex(list_quantum=0)._build(x, np.zeros(128), x[:1])


@pytest.mark.parametrize("fmt", ["json", "npz"])
def test_save_load_round_trip(blobs, fitted, tmp_path, fmt):
    _, q = blobs
    _, port = fitted
    path = str(tmp_path / f"ivf.{fmt}")
    dst.save_model(port, path, save_format=fmt)
    back = dst.load_model(path, device="cpu")
    assert isinstance(back, IVFIndex) and back.get_params() == \
        port.get_params()
    assert back.pad_waste == port.pad_waste
    np.testing.assert_array_equal(back.quantizer_.centers_,
                                  port.quantizer_.centers_)
    for a, b in zip(back.search(q, k=5, nprobe=2),
                    port.search(q, k=5, nprobe=2)):
        np.testing.assert_array_equal(a.collect(), b.collect())
