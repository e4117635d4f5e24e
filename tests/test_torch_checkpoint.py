"""The port's snapshot format against the reference's, on the CPU.

``dislib_tpu_torch.utils.checkpoint`` keeps the reference's ``.npz``
format with its ``_dslib_crc32`` record, so a file written by either
package loads and verifies in the other; corrupt generations fall back
the same way; the rotation tolerates a generation that a concurrent save
rotated away (ROADMAP.md C.4, which the port does not copy); and
``digest_sums`` equals the reference's within rtol 1e-6.  Host-only
except the one ``digest_sums`` case, which runs the reference's jitted
reduction.
"""

import os
import threading

import numpy as np
import pytest
import torch

from dislib_tpu.utils import checkpoint as ref_ck
from dislib_tpu.utils import faults as ref_faults

from dislib_tpu_torch.utils import checkpoint as port_ck
from dislib_tpu_torch.utils import faults as port_faults
from dislib_tpu_torch.runtime.elastic import AsyncFetch, fetch

PACKAGES = {"ref": (ref_ck, ref_faults), "port": (port_ck, port_faults)}


def _state(seed=0):
    rng = np.random.RandomState(seed)
    return {"centers": rng.rand(4, 3).astype(np.float32),
            "n_iter": 7, "converged": False,
            "node": rng.randint(0, 9, (2, 5)).astype(np.int32),
            "digest": np.asarray([2.0, 1.5, -3.25], np.float64)}


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port"),
                                           ("port", "port")])
def test_snapshot_written_by_one_package_loads_in_the_other(tmp_path, writer,
                                                            reader):
    path = str(tmp_path / "s.npz")
    PACKAGES[writer][0].FitCheckpoint(path).save(_state())
    got = PACKAGES[reader][0].FitCheckpoint(path).load()
    _same(got, {k: np.asarray(v) for k, v in _state().items()})
    # the two packages' checksums agree byte for byte
    assert ref_ck._state_crc(got) == port_ck._state_crc(got)


@pytest.mark.parametrize("mode", ["flip", "truncate", "foreign"])
@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_corrupt_newest_generation_falls_back(tmp_path, mode, pkg):
    ck_mod, faults = PACKAGES[pkg]
    path = str(tmp_path / "s.npz")
    ck = ck_mod.FitCheckpoint(path, keep=2)
    ck.save(_state(0))
    ck.save(_state(1))
    faults.corrupt_snapshot(path, mode=mode)
    # the port's loader falls back exactly as the reference's does
    with pytest.warns(RuntimeWarning, match="falling back"):
        got = port_ck.FitCheckpoint(path, keep=2).load()
    _same(got, {k: np.asarray(v) for k, v in _state(0).items()})
    assert not os.path.exists(path)     # the corrupt generation is gone


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_all_generations_corrupt_raises(tmp_path, pkg):
    ck_mod, faults = PACKAGES[pkg]
    path = str(tmp_path / "s.npz")
    ck = ck_mod.FitCheckpoint(path, keep=2)
    ck.save(_state(0))
    ck.save(_state(1))
    faults.corrupt_snapshot(path, mode="truncate")
    faults.corrupt_snapshot(path + ".1", mode="flip")
    for mod in (ref_ck, port_ck):
        with pytest.raises(mod.SnapshotCorrupt, match="all 2"):
            mod.FitCheckpoint(path, keep=2).load()


def test_keep_rotation_and_delete(tmp_path):
    path = str(tmp_path / "s.npz")
    ck = port_ck.FitCheckpoint(path, keep=3)
    for i in range(4):
        ck.save({"i": i})
    assert [int(np.load(p)["i"]) for p in
            (path, path + ".1", path + ".2")] == [3, 2, 1]
    assert not os.path.exists(path + ".3")
    ck.delete()
    assert not any(os.path.exists(p) for p in (path, path + ".1",
                                               path + ".2"))
    with pytest.raises(ValueError, match="reserved"):
        ck.save({"_dslib_crc32": 1})


def test_concurrent_saves_never_lose_a_generation(tmp_path):
    # the C.4 case: two writers on one path with keep=2 rotate each
    # other's generations away between exists() and os.replace()
    path = str(tmp_path / "s.npz")
    errors = []

    def writer(base):
        ck = port_ck.FitCheckpoint(path, keep=2)
        try:
            for i in range(40):
                ck.save({"v": np.full(64, base + i, np.int64)})
        except BaseException as e:          # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(b,))
               for b in (0, 1000)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    snap = port_ck.FitCheckpoint(path, keep=2).load()
    v = snap["v"]
    assert (v == v[0]).all() and v[0] % 1000 < 40


def test_save_async_resolves_fetch_handles_on_the_worker(tmp_path):
    path = str(tmp_path / "s.npz")
    ck = port_ck.FitCheckpoint(path)
    carry = torch.arange(6, dtype=torch.float32)
    handle = fetch(carry, blocking=False)
    carry.add_(100.0)                   # the carry moves on in place
    assert isinstance(handle, AsyncFetch)
    ck.save_async({"c": handle, "n": 3})
    ck.flush()
    np.testing.assert_array_equal(ck.load()["c"], np.arange(6))
    # a failed write surfaces at the next flush
    ck.save_async({"_dslib_crc32": 0})
    with pytest.raises(ValueError, match="reserved"):
        ck.flush()


def test_digest_sums_matches_the_reference_and_sees_a_row_swap():
    # positive data: a float32 sum of cancelling terms has no relative
    # accuracy to compare (the two packages sum in different orders)
    import jax.numpy as jnp
    x = np.random.RandomState(3).rand(9000, 5).astype(np.float32) + 0.5
    ref = ref_ck.digest_sums(jnp.asarray(x))
    got = port_ck.digest_sums(torch.from_numpy(x))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    swapped = x.copy()
    swapped[[10, 8500]] = swapped[[8500, 10]]
    got2 = port_ck.digest_sums(torch.from_numpy(swapped))
    assert got2[0] == pytest.approx(got[0], rel=1e-6)
    # the index-weighted sum moves by (8500 - 10)·Σ(row difference)
    want = 8490.0 * float(x[10].astype(np.float64).sum()
                          - x[8500].astype(np.float64).sum())
    assert got2[1] - got[1] == pytest.approx(want, rel=0.05)
    d = port_ck.data_digest(torch.from_numpy(x),
                            stats=np.ones((9000, 2), np.float32))
    assert d[0] == port_ck._DIGEST_VERSION and d.shape == (5,)


def test_validate_snapshot_refuses_stale_and_old_versions():
    fp = np.asarray([3.0, 4.0])
    dig = port_ck.versioned_digest(1.0, 2.0)
    port_ck.validate_snapshot({"fp": fp, "digest": dig}, fp, dig)
    with pytest.raises(ValueError, match="stale or foreign"):
        port_ck.validate_snapshot({"fp": fp + 1, "digest": dig}, fp, dig)
    with pytest.raises(ValueError, match="different library version"):
        port_ck.validate_snapshot({"fp": fp, "digest": dig[1:]}, fp, dig)
