"""The port's root API against the reference's.

``dislib_tpu_torch.__all__`` must hold every name of
``dislib_tpu.__all__`` that the port implements; the reference entries
still unported are named in :data:`UNPORTED`.  The port may export more
(its subpackages, ``from_fitted_arrays``, ``IVFIndex``).  ``set_mesh``
takes the one-card mesh only, and ``overlap_schedule`` routes as the
reference's ``ops/overlap.resolve`` does (``pallas`` is the port's
``kernel``).
"""

import pytest

import dislib_tpu as ds

import dislib_tpu_torch as dst
from dislib_tpu_torch.parallel import mesh as port_mesh

# the reference's root entries with no port yet: the resilience runtime
# and the serving layer (ROADMAP.md A.12)
UNPORTED = ["runtime", "serving"]


def test_all_holds_every_ported_reference_name():
    ref = set(ds.__all__)
    port = set(dst.__all__)
    assert set(UNPORTED) <= ref
    assert not set(UNPORTED) & port
    assert sorted(ref - port) == sorted(UNPORTED)
    for name in dst.__all__:
        assert hasattr(dst, name), name


def test_star_import_gives_the_slice_names():
    ns = {}
    exec("from dislib_tpu_torch import *", ns)
    for name in ("CascadeSVM", "ALS", "IVFIndex", "set_mesh",
                 "overlap_schedule"):
        assert name in ns, name
    assert ns["retrieval"].IVFIndex is dst.IVFIndex
    assert ns["recommendation"].ALS is dst.ALS


def test_set_mesh_takes_the_one_card_mesh_only(monkeypatch):
    # the test's default mesh is put back afterwards
    monkeypatch.setattr(port_mesh, "_default_mesh", port_mesh._default_mesh)
    mesh = port_mesh.make_mesh((1, 1), "cpu")
    dst.set_mesh(mesh)
    assert dst.get_mesh() is mesh
    with pytest.raises(NotImplementedError, match="A.2"):
        dst.set_mesh(port_mesh.Mesh(2, 1, mesh.device))
    assert dst.get_mesh() is mesh
    with pytest.raises(TypeError):
        dst.set_mesh((1, 1))


@pytest.mark.parametrize("value,want", [
    (None, "db"), ("db", "db"), ("seq", "seq"), ("off", "seq"),
    ("pallas", "kernel"), ("kernel", "kernel")])
def test_overlap_schedule_routes_as_the_reference(value, want, monkeypatch):
    monkeypatch.delenv("DSLIB_OVERLAP", raising=False)
    assert dst.overlap_schedule(value) == want
    if value != "kernel":
        ref = ds.overlap_schedule(value)
        assert want == ("kernel" if ref == "pallas" else ref)
    monkeypatch.setenv("DSLIB_OVERLAP", "seq")
    assert dst.overlap_schedule() == "seq"
    with pytest.raises(ValueError, match="overlap"):
        dst.overlap_schedule("bogus")
