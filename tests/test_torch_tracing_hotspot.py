"""The spans of the Gi* hot-spot and local Geary paths
(``spatialcore_tpu_torch.utils.profiling``) and the launch shape their
draw steps take:

- ``ops.getis.getis_ord`` (the exact Gi* pass), ``post.hotspot`` (BH and
  the hot / cold classes of the compact route) and ``post.geary`` (local
  Geary's compact post-pass) record while tracing is on, as
  ``spatialcore.*`` ranges under the profiler, and not at all while it is
  off;
- at the 1M-cell cells' shape (B 256, k 6, tiles of 256 genes) the
  chooser gives the getis_star draw step on int16 counters and the geary
  one the moran tail's 128-gene CTAs, and Lee's its 64;
- the plain versions the CPU runs launch nothing.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from spatialcore_tpu_torch.core import SpatialData
from spatialcore_tpu_torch.kernels import lisa_count as kern_lisa
from spatialcore_tpu_torch.spatial import getis_ord_gi, local_gearys_c
from spatialcore_tpu_torch.utils import profiling as prof

torch.set_num_threads(1)

N, G = 1500, 12


@pytest.fixture(autouse=True)
def _clean():
    prof.reset()
    yield
    prof.reset()


def _adata(device="cpu"):
    r = np.random.default_rng(11)
    c = r.uniform(0, 120, (N, 2)).astype(np.float32)
    X = r.poisson(1.0 + np.sin(c[:, :1] / 10.0) ** 2, (N, G)).astype(np.float32)
    a = SpatialData(X=torch.as_tensor(X, device=device))
    a.obsm["spatial"] = c
    return a


def _gi(a, device="cpu", P=9):
    getis_ord_gi(a, n_permutations=P, seed=3, null_method="banded_int8",
                 output_mode="compact", device=device)


def _geary(a, device="cpu", P=9):
    local_gearys_c(a, n_permutations=P, seed=3, null="total",
                   null_method="banded_int8", output_mode="compact",
                   device=device)


def _names():
    return [d["name"] for d in prof.spans()]


def test_spans_record_while_tracing_and_not_when_off():
    a = _adata()
    _gi(a)
    _geary(a)
    assert prof.spans() == []
    with prof.tracing():
        _gi(a)
    sp = prof.spans()
    by_id = {d["id"]: d["name"] for d in sp}
    names = _names()
    # one gene tile: one exact pass and one post-pass
    assert names.count("ops.getis.getis_ord") == 1
    assert names.count("post.hotspot") == 1
    for d in sp:
        if d["name"] in ("ops.getis.getis_ord", "post.hotspot"):
            assert by_id[d["parent"]] == "ops.streaming.streaming_local_null"
    prof.reset()
    with prof.tracing():
        _geary(a)
    assert _names().count("post.geary") == 1
    assert "post.hotspot" not in _names()


def test_spans_are_profiler_ranges(tmp_path):
    a = _adata()
    with prof.profile_trace(tmp_path) as path:
        _gi(a)
        _geary(a)
    events = [e["name"] for e in json.loads(Path(path).read_text())
              ["traceEvents"] if e.get("ph") == "X"]
    for name in ("ops.getis.getis_ord", "post.hotspot", "post.geary"):
        assert events.count("spatialcore." + name) == _names().count(name) == 1


@pytest.mark.parametrize("stat,cnt_bytes,tile", [
    ("moran", 1, 128), ("geary", 1, 128), ("getis_star", 2, 128),
    ("lee", 1, 64)])
def test_chooser_tiles_at_the_cells_shape(stat, cnt_bytes, tile):
    # 1,000,192 padded rows: 3,907 blocks of 256; a compact tile of 256
    t = kern_lisa.lisa_tiles(256, 6, stat, kern_lisa._FAR_ROWS, cnt_bytes,
                             256, 3907)
    assert t.tile == tile
    assert 256 % t.tile == 0


def test_plain_versions_count_no_launch():
    a = _adata()
    _gi(a, P=130)                      # int16 counters on the CPU
    _geary(a)
    c = prof.counters()
    assert not any(kern_lisa.LAUNCHES.values())
    assert "kernels.lisa_count.indirect" not in c
