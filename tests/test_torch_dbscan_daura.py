"""The port's DBSCAN, Daura and ε-passes against the reference's, on CPU.

The same numpy inputs go through ``dislib_tpu`` (8 virtual CPU devices) and
``dislib_tpu_torch`` on the CPU, where every distance block runs the plain
version of the ``distances_sq`` kernel.  ``labels_``,
``core_sample_indices_``, ``n_clusters_`` and ``clusters_`` must be equal,
on each tier: dense, tiled (``_DENSE_MAX`` and ``TILE`` shrunk in both
packages, and the port's ``BLOCK_BYTES`` shrunk so a row tile meets
several column chunks) and ring (``_RING=True``).

The two packages round ``d² ≤ eps²`` differently (the port's blocks are
(columns, rows), and its float32 sums run in another order), so a pair
within rounding of the threshold could fall either way.  That is the
nature of the comparison, not a defect: the data here keep every pairwise
float64 d² at least :data:`MARGIN` away from the threshold, and each test
asserts it.
"""

import numpy as np
import pytest
import torch

import dislib_tpu as ds
from dislib_tpu.cluster import DBSCAN as RefDBSCAN
from dislib_tpu.cluster import Daura as RefDaura
from dislib_tpu.cluster import daura as ref_daura
from dislib_tpu.cluster import dbscan as ref_dbscan
from dislib_tpu.ops import ring as ref_ring
from dislib_tpu.ops import tiled as ref_tiled
from dislib_tpu.parallel import mesh as ref_mesh
from dislib_tpu.runtime.health import NumericalDivergence as RefDivergence

import dislib_tpu_torch as dst
from dislib_tpu_torch.cluster import DBSCAN as PortDBSCAN
from dislib_tpu_torch.cluster import Daura as PortDaura
from dislib_tpu_torch.cluster import daura as port_daura
from dislib_tpu_torch.cluster import dbscan as port_dbscan
from dislib_tpu_torch.ops import kernels as port_k
from dislib_tpu_torch.ops import ring as port_ring
from dislib_tpu_torch.ops import tiled as port_tiled
from dislib_tpu_torch.parallel import mesh as port_mesh
from dislib_tpu_torch.runtime.health import NumericalDivergence
from dislib_tpu_torch.runtime.loop import EVERY
from dislib_tpu_torch.utils import profiling as prof

#: least |d²(i, j) − threshold| (float64) of any pair in the data
MARGIN = 1e-3


@pytest.fixture(autouse=True)
def _port_on_cpu():
    dst.init(device="cpu")
    port_k.reset_launches()
    prof.reset_host_reads()
    yield


def _d2(x):
    x = x.astype(np.float64)
    sq = (x * x).sum(1)
    return np.maximum(sq[:, None] - 2.0 * x @ x.T + sq[None, :], 0.0)


def _with_margin(x, thr):
    """Drop the rows of ``x`` in a pair within MARGIN of ``thr`` (d²), then
    assert the margin holds."""
    while True:
        near = np.abs(_d2(x) - thr) < MARGIN
        np.fill_diagonal(near, False)
        if not near.any():
            return x
        x = np.delete(x, np.nonzero(near.any(1))[0][:1], axis=0)


def _blob_data(seed=0, n=120):
    """Two rings, a little noise (the reference's scale-path data)."""
    rng = np.random.RandomState(seed)
    t = rng.rand(n // 2) * 2 * np.pi
    c1 = np.c_[np.cos(t), np.sin(t)] + 0.05 * rng.randn(n // 2, 2)
    c2 = np.c_[np.cos(t) + 6.0, np.sin(t)] + 0.05 * rng.randn(n // 2, 2)
    noise = rng.rand(6, 2) * 2 + np.array([2.5, 4.0])
    return np.vstack([c1, c2, noise]).astype(np.float32)


def _dbscan_sets():
    blobs = _with_margin(_blob_data(), 0.4 ** 2)
    # a 1-D chain over many tiles: the worst case for propagation depth
    chain = np.c_[np.arange(70) * 0.5, np.zeros(70)].astype(np.float32)
    rng = np.random.RandomState(3)
    c = rng.rand(5, 10).astype(np.float32)
    wide = _with_margin((c[rng.randint(0, 5, 90)] + 0.06 * rng.standard_normal(
        (90, 10))).astype(np.float32), 0.3 ** 2)
    return {"blobs": (blobs, 0.4, 5), "chain": (chain, 0.6, 2),
            "wide": (wide, 0.3, 4)}


DBSCAN_SETS = _dbscan_sets()


def _frames(seed=1, m=70, n_atoms=4):
    rng = np.random.RandomState(seed)
    c = rng.randn(6, 3 * n_atoms) * 2
    x = (c[rng.randint(0, 6, m)] + 0.4 * rng.randn(m, 3 * n_atoms))
    return _with_margin(x.astype(np.float32), 1.5 ** 2 * n_atoms), 1.5


def _tier(monkeypatch, tier, ref_mod, port_mod, tile=16):
    if tier == "tiled":
        monkeypatch.setattr(ref_mod, "_DENSE_MAX", 0)
        monkeypatch.setattr(port_mod, "_DENSE_MAX", 0)
        monkeypatch.setattr(ref_tiled, "TILE", tile)
        monkeypatch.setattr(port_tiled, "TILE", tile)
        # three tiles of columns a block: several chunks per row tile
        monkeypatch.setattr(port_tiled, "BLOCK_BYTES", 4 * tile * 3 * tile)
    elif tier == "ring":
        monkeypatch.setattr(ref_mod, "_RING", True)
        monkeypatch.setattr(port_mod, "_RING", True)
        monkeypatch.setattr(port_ring, "RING_TILE", tile)


# -- DBSCAN ----------------------------------------------------------------------

@pytest.mark.parametrize("tier", ["dense", "tiled", "ring"])
@pytest.mark.parametrize("data", sorted(DBSCAN_SETS))
def test_dbscan_matches_reference(monkeypatch, tier, data):
    x, eps, ms = DBSCAN_SETS[data]
    if data != "chain":
        d = np.abs(_d2(x) - eps ** 2)
        np.fill_diagonal(d, np.inf)
        assert d.min() >= MARGIN
    _tier(monkeypatch, tier, ref_dbscan, port_dbscan)
    ref = RefDBSCAN(eps=eps, min_samples=ms).fit(ds.array(x))
    port = PortDBSCAN(eps=eps, min_samples=ms).fit(dst.array(x))
    np.testing.assert_array_equal(port.labels_, ref.labels_)
    np.testing.assert_array_equal(port.core_sample_indices_,
                                  ref.core_sample_indices_)
    assert port.n_clusters_ == ref.n_clusters_
    assert port.labels_.dtype == np.int64
    if data == "chain":
        assert port.n_clusters_ == 1 and (port.labels_ == 0).all()
    # the dense tier reads its flag once per chunk of EVERY rounds, the
    # streamed tiers once per round
    reads = prof.HOST_READS["dbscan"]
    if tier == "dense":
        assert reads <= -(-x.shape[0] // EVERY)
    else:
        assert reads >= 2
    assert prof.HOST_READS["results"] == 1
    np.testing.assert_array_equal(
        PortDBSCAN(eps=eps, min_samples=ms).fit_predict(
            dst.array(x)).collect().ravel(), ref.labels_)


def test_dbscan_all_noise_and_one_cluster():
    rng = np.random.RandomState(4)
    sparse_pts = (rng.rand(30, 2) * 100).astype(np.float32)
    dense_pts = (rng.rand(30, 2) * 0.01).astype(np.float32)
    for x in (sparse_pts, dense_pts):
        ref = RefDBSCAN(eps=0.5, min_samples=3).fit(ds.array(x))
        port = PortDBSCAN(eps=0.5, min_samples=3).fit(dst.array(x))
        np.testing.assert_array_equal(port.labels_, ref.labels_)
        assert port.n_clusters_ == ref.n_clusters_


# -- Daura -----------------------------------------------------------------------

@pytest.mark.parametrize("tier", ["dense", "tiled", "ring"])
def test_daura_matches_reference(monkeypatch, tier):
    x, cutoff = _frames()
    n_atoms = x.shape[1] // 3
    d = np.abs(_d2(x) - cutoff ** 2 * n_atoms)
    np.fill_diagonal(d, np.inf)
    assert d.min() >= MARGIN
    _tier(monkeypatch, tier, ref_daura, port_daura)
    ref = RefDaura(cutoff=cutoff).fit(ds.array(x))
    port = PortDaura(cutoff=cutoff).fit(dst.array(x))
    np.testing.assert_array_equal(port.labels_, ref.labels_)
    assert len(port.clusters_) == len(ref.clusters_) > 1
    for a, b in zip(port.clusters_, ref.clusters_):
        np.testing.assert_array_equal(a, b)
    reads = prof.HOST_READS["daura"]
    if tier == "dense":
        assert reads <= -(-len(ref.clusters_) // EVERY)
    else:
        assert reads == len(ref.clusters_)
    np.testing.assert_array_equal(
        PortDaura(cutoff=cutoff).fit_predict(dst.array(x)).collect().ravel(),
        ref.labels_)


@pytest.mark.parametrize("tier", ["dense", "tiled"])
def test_daura_argmax_takes_the_first_tie(monkeypatch, tier):
    # two pairs of frames, each pair within the cutoff: counts tie at 2
    x = np.zeros((4, 3), np.float32)
    x[1, 0] = 0.5
    x[2, 0], x[3, 0] = 10.0, 10.5
    _tier(monkeypatch, tier, ref_daura, port_daura, tile=2)
    ref = RefDaura(cutoff=1.0).fit(ds.array(x))
    port = PortDaura(cutoff=1.0).fit(dst.array(x))
    assert [c.tolist() for c in port.clusters_] == \
        [c.tolist() for c in ref.clusters_] == [[0, 1], [2, 3]]


# -- the ε-passes ----------------------------------------------------------------

def _pass_inputs(seed=5, mp=64, n=6):
    rng = np.random.RandomState(seed)
    x = _with_margin(rng.rand(mp + 8, n).astype(np.float32), 0.5)[:mp]
    vals = rng.permutation(mp).astype(np.int32)
    colmask = rng.rand(mp) < 0.7
    return x, vals, colmask


def test_neigh_count_min_matches_reference(monkeypatch):
    x, vals, colmask = _pass_inputs()
    ref = ref_tiled.neigh_count_min(x, 0.5, vals, colmask, 99, 16)
    for block in (port_tiled.BLOCK_BYTES, 4 * 16 * 20):
        monkeypatch.setattr(port_tiled, "BLOCK_BYTES", block)
        for tile in (16, 13):           # the ragged last tile too
            cnt, mn = port_tiled.neigh_count_min(
                torch.from_numpy(x), 0.5, torch.from_numpy(vals),
                torch.from_numpy(colmask), 99, tile)
            np.testing.assert_array_equal(cnt.numpy(), np.asarray(ref[0]))
            np.testing.assert_array_equal(mn.numpy(), np.asarray(ref[1]))
    cnt, mn = port_tiled.neigh_count_min(
        torch.from_numpy(x), 0.5, torch.from_numpy(vals),
        torch.from_numpy(colmask), 99, 16, counts=False)
    assert cnt is None
    np.testing.assert_array_equal(mn.numpy(), np.asarray(ref[1]))
    xp, nt = port_tiled.pad_to_tiles(torch.from_numpy(x[:50]), 16)
    assert nt == 4 and tuple(xp.shape) == (64, 6) and not xp[50:].any()
    assert port_tiled.pad_cols(torch.from_numpy(x)).shape == x.shape


@pytest.mark.parametrize("overlap", ["db", "seq"])
def test_ring_neigh_count_min_matches_reference(overlap):
    x, vals, colmask = _pass_inputs(seed=6)
    ref = ref_ring.ring_neigh_count_min(x, np.float32(0.5), vals, colmask,
                                        99, ref_mesh.get_mesh(),
                                        overlap=overlap)
    cnt, mn = port_ring.ring_neigh_count_min(
        torch.from_numpy(x), 0.5, torch.from_numpy(vals),
        torch.from_numpy(colmask), 99, port_mesh.get_mesh(), overlap=overlap)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(mn.numpy(), np.asarray(ref[1]))


# -- refusals --------------------------------------------------------------------

def test_refusals_name_the_roadmap_items():
    x = dst.array(np.zeros((6, 3), np.float32))
    for est in (PortDBSCAN(), PortDaura()):
        for kw in ({"checkpoint": object()}, {"health": object()}):
            with pytest.raises(NotImplementedError, match="A.12"):
                est.fit(x, **kw)
    with pytest.raises(NotImplementedError, match="A.2"):
        port_ring.ring_neigh_count_min(
            torch.zeros((4, 2)), 1.0, torch.zeros(4, dtype=torch.int32),
            torch.ones(4, dtype=torch.bool), 4,
            port_mesh.Mesh(2, 1, torch.device("cpu")))
    for est in (PortDaura(), RefDaura()):
        with pytest.raises(ValueError, match="3\\*n_atoms"):
            est.fit((dst if isinstance(est, PortDaura) else ds).array(
                np.zeros((5, 4), np.float32)))


def test_non_finite_input_raises_as_the_reference():
    x = np.random.RandomState(7).rand(20, 3).astype(np.float32)
    x[4, 1] = np.nan
    for ref_est, port_est in ((RefDBSCAN(eps=0.3), PortDBSCAN(eps=0.3)),
                              (RefDaura(cutoff=0.3), PortDaura(cutoff=0.3))):
        with pytest.raises(RefDivergence) as r:
            ref_est.fit(ds.array(x))
        with pytest.raises(NumericalDivergence) as p:
            port_est.fit(dst.array(x))
        assert p.value.guard == r.value.guard == "input-nonfinite"
