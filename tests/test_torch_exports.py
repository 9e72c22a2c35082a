"""The port's public names against the JAX package's, subpackage by
subpackage (``core``, ``ops``, ``spatial``, ``utils``, ``stats``,
``annotation``, ``plotting``, ``parallel``, the modules ``nmf``, ``diffusion`` and ``r_bridge``, and
the top level): every name the reference exports is exported by the port
too, unless it is still queued for porting (ROADMAP Queue 1), and every
name the port exports resolves. A porting PR moves names out of the queued lists; a name
may not be both queued and exported.
"""

import importlib

import pytest
import torch

import spatialcore_tpu  # noqa: F401  (the reference's subpackages below)

# One intra-op thread: xdist runs several test workers at once, and torch's
# default of one thread per core in each slows small ops several-fold.
torch.set_num_threads(1)

#: ROADMAP Queue 1 item 14, the annotation subpackage: all ported
ITEM_14 = set()

#: names of the reference's ``__all__`` not ported yet, by subpackage or
#: module, each set under its ROADMAP Queue 1 item
QUEUED = {
    "core": set(),
    "ops": set(),
    "spatial": set(),
    "utils": set(),
    "stats": set(),
    "nmf": set(),
    "diffusion": set(),
    "r_bridge": set(),
    "annotation": ITEM_14,
    "plotting": set(),
    "parallel": set(),
}


@pytest.mark.parametrize("sub", sorted(QUEUED))
def test_port_exports_the_reference_names(sub):
    ref = importlib.import_module(f"spatialcore_tpu.{sub}")
    port = importlib.import_module(f"spatialcore_tpu_torch.{sub}")
    queued = QUEUED[sub]
    assert queued <= set(ref.__all__), sorted(queued - set(ref.__all__))
    missing = set(ref.__all__) - queued - set(port.__all__)
    assert not missing, f"not exported by the port: {sorted(missing)}"
    ported = queued & set(port.__all__)
    assert not ported, f"ported, so no longer queued: {sorted(ported)}"
    unresolved = [n for n in port.__all__ if not hasattr(port, n)]
    assert not unresolved, unresolved
    assert len(set(port.__all__)) == len(port.__all__)


def test_top_level_exports_h5ad_io():
    import spatialcore_tpu_torch as port

    for name in ("read_h5ad", "write_h5ad", "SpatialData"):
        assert name in port.__all__ and hasattr(port, name)
    assert port.read_h5ad is importlib.import_module(
        "spatialcore_tpu_torch.core").read_h5ad


#: the top level's names not ported yet, each under its ROADMAP Queue 1
#: item: none are left
TOP_LEVEL_QUEUED = set()


def test_top_level_all_is_the_reference_less_the_queued():
    import spatialcore_tpu_torch as port

    assert set(port.__all__) == set(spatialcore_tpu.__all__) - TOP_LEVEL_QUEUED
    assert TOP_LEVEL_QUEUED <= set(spatialcore_tpu.__all__)
    assert len(set(port.__all__)) == len(port.__all__)
    assert all(hasattr(port, n) for n in port.__all__)
    assert not any(hasattr(port, n) for n in TOP_LEVEL_QUEUED)
    assert port.available_modules() == ["core"] + [
        m for m in spatialcore_tpu._OPTIONAL_MODULES
        if m not in TOP_LEVEL_QUEUED]


@pytest.mark.parametrize("name", ["stats", "annotation", "nmf", "diffusion",
                                  "core", "ops", "spatial", "utils",
                                  "r_bridge", "plotting", "parallel"])
def test_top_level_exposes_the_ported_modules(name):
    import spatialcore_tpu_torch as port

    assert name in port.__all__
    assert getattr(port, name) is importlib.import_module(
        f"spatialcore_tpu_torch.{name}")
