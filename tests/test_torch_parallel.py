"""The port's ``parallel/`` on four spawned gloo ranks, held against the
port's single-device functions (bitwise wherever the reference claims
bitwise) and against the JAX package's sharded functions on the 8-device
CPU mesh (the tolerances of the other torch parity tests).

One module-scoped run of ``_torch_parallel_ranks.py`` (four processes,
torch and the port only) builds a (1, 4) and a (2, 2) mesh and writes its
gathered results to files; each test reads its part. The ranks are joined
with a deadline and killed on timeout, so a hung collective fails here.
The cases mirror ``tests/test_parallel.py``.
"""

import functools
import os
import subprocess
import sys
import time

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp
import spatialcore_tpu.parallel as jpar
from spatialcore_tpu.ops import banded as jb
from spatialcore_tpu.ops import graph as jg
from spatialcore_tpu.ops import moran as jm

import spatialcore_tpu_torch as sctt
from spatialcore_tpu_torch import parallel as tpar
from spatialcore_tpu_torch.ops import banded as tb
from spatialcore_tpu_torch.ops import getis as tgetis
from spatialcore_tpu_torch.ops import graph as tg
from spatialcore_tpu_torch.ops import lee as tl
from spatialcore_tpu_torch.ops import moran as tm

# One intra-op thread: xdist runs several test workers at once, and torch's
# default of one thread per core in each slows small ops several-fold.
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import _torch_parallel_ranks as W  # noqa: E402

WORLD = 4
DEADLINE_S = 240


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(HERE), os.environ.get("PYTHONPATH", "")]))
    env.pop("LOCAL_WORLD_SIZE", None)
    logs = [open(out / f"log{r}", "w") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_parallel_ranks.py"),
         str(r), str(WORLD), str(out / "store"), str(out)],
        env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    deadline = time.monotonic() + DEADLINE_S
    refs = _jax_references()              # while the ranks run
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [p for p in procs if p.poll() is None]
        for p in hung:
            p.kill()
            p.wait()
        for f in logs:
            f.close()
    tails = "\n".join(f"--- rank {r}:\n" + (out / f"log{r}").read_text()[-3000:]
                      for r in range(WORLD))
    if hung:
        pytest.fail(f"{len(hung)} ranks still running after {DEADLINE_S} s "
                    f"(a hung collective?)\n{tails}")
    if any(p.returncode for p in procs):
        pytest.fail(f"rank exit codes {[p.returncode for p in procs]}\n{tails}")
    res = torch.load(out / "results.pt", weights_only=False)
    shapes = [torch.load(out / f"shapes{r}.pt", weights_only=False)
              for r in range(WORLD)]
    return res, shapes, refs


def _jax_references() -> dict:
    """The JAX package's sharded results on its 8-device CPU mesh."""
    import spatialcore_tpu as sct

    coords, X = W.world_data()
    S0 = float(len(X))
    g = jg.build_graph(coords, n_neighbors=6)
    Zj, _ = jm.standardize(jnp.asarray(X))
    plan = jb.build_null_plan(g, block=64)
    mesh, mesh22 = jpar.auto_mesh(), jpar.auto_mesh(cell_shards=2)
    ref = {"idx": np.asarray(g.neighbor_idx)}
    ref["moran"] = jpar.sharded_moran(g, jnp.asarray(X), S0, mesh)
    ref["perm"] = jpar.sharded_permutation_test(g, jnp.asarray(X), S0, seed=7,
                                                n_permutations=25, mesh=mesh)
    ref["lisa"] = jpar.sharded_local_moran(g, jnp.asarray(X), seed=3,
                                           n_permutations=10, mesh=mesh)
    ref["lee"] = jpar.sharded_lees_l(g, Zj[:, :8], Zj[:, 8:16], seed=2,
                                     n_permutations=20, mesh=mesh)
    ref["banded_int8"] = jpar.sharded_banded_permutation_test(
        plan, Zj, S0, jm.moran_observed(g, Zj, S0), seed=3, n_permutations=20,
        mesh=mesh, band_impl="xla", precision="int8")
    ref["banded_lisa"] = jpar.sharded_banded_local_moran(
        plan, g, Zj, seed=7, n_permutations=20, mesh=mesh)
    c2, X2 = W.tile_data(4)
    g2 = jg.build_graph(c2, n_neighbors=5)
    Z2 = jm.standardize(jnp.asarray(X2))[0]
    ref["lag_2d"] = jg.spatial_lag(g2, Z2)
    ref["lisa_2d"] = jpar.sharded_local_moran_2d(g2, Z2, seed=3,
                                                 n_permutations=23, mesh=mesh22)
    kc = np.random.default_rng(5).uniform(0, 2000, (3000, 2)).astype(np.float32)
    ref["knn"] = jg.knn_grid(kc, 6)
    ca, Xa = W.adata_data()
    a = sct.SpatialData(
        X=Xa.copy(), obs=pd.DataFrame(index=[f"c{i}" for i in range(len(Xa))]),
        var=pd.DataFrame(index=[f"g{i}" for i in range(Xa.shape[1])]))
    a.obsm["spatial"] = ca
    sct.spatial.morans_i(a, n_permutations=25, seed=3, null_method="banded_int8",
                         mesh=mesh, gene_batch_size=10)
    ref["morans_i"] = a.uns["morans_i"]
    return ref


@pytest.fixture(scope="module")
def world():
    coords, X = W.world_data()
    graph = tg.build_graph(coords, n_neighbors=6, device="cpu")
    Xt = torch.as_tensor(X)
    Z, _ = tm.standardize(Xt)
    return dict(coords=coords, X=X, Xt=Xt, Z=Z, graph=graph, S0=float(len(X)),
                plan=tb.build_null_plan(graph, block=64))


def _eq(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _eq(g, w)
        return
    np.testing.assert_array_equal(np.asarray(got), want.numpy())


def _counts(p, P):
    return np.rint(np.asarray(p, np.float64) * (P + 1) - 1).astype(np.int64)


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------


def test_auto_mesh_shapes(ranks):
    res, _, ref = ranks
    assert res["mesh_shapes"] == ((1, 4), (2, 2), ("cells", "genes"))
    assert "cell_shards=3 does not divide 4 devices" in res["cell_shards_3"]


def test_auto_mesh_multi_host_rule(ranks):
    """LOCAL_WORLD_SIZE=2 on four ranks: two hosts fold into ``cells``."""
    res, _, ref = ranks
    shape, err3, err4 = res["multi_host"]
    assert shape == (2, 2)
    assert "multiple of the host count 2" in err3
    assert "does not tile 2 hosts" in err4


def test_auto_mesh_in_process_without_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
    try:
        mesh = tpar.auto_mesh(device="cpu")
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert tuple(mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("cells", "genes")
        with pytest.raises(ValueError, match="does not divide 1 devices"):
            tpar.auto_mesh(cell_shards=2)
        from torch.distributed.tensor import Replicate, Shard
        assert tpar.gene_sharding(mesh) == (Replicate(), Shard(1))
        assert tpar.cell_sharding(mesh) == (Shard(0), Replicate())
        assert tpar.replicated(mesh) == (Replicate(), Replicate())
        # one rank: the public path equals the call without a mesh
        a, b = W._adata(), W._adata()
        sctt.spatial.morans_i(a, n_permutations=9, seed=1, device="cpu")
        sctt.spatial.morans_i(b, n_permutations=9, seed=1, device="cpu",
                              mesh=mesh)
        pd.testing.assert_frame_equal(a.uns["morans_i"], b.uns["morans_i"])
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Gene-sharded
# ---------------------------------------------------------------------------


def test_sharded_moran_matches_single_device(ranks, world):
    res, _, ref = ranks
    _eq(res["moran"], tm.moran_observed(world["graph"], world["Z"], world["S0"]))
    np.testing.assert_array_equal(world["graph"].neighbor_idx.numpy(),
                                  ref["idx"])
    np.testing.assert_allclose(res["moran"], np.asarray(ref["moran"]),
                               rtol=1e-5, atol=1e-7)


def test_sharded_permutations_bitwise_match(ranks, world):
    res, _, ref = ranks
    g, Z, S0 = world["graph"], world["Z"], world["S0"]
    obs = tm.moran_observed(g, Z, S0)
    _eq(res["perm"], tm.permutation_test_global(g, Z, S0, obs, 7, 25))
    pj, mj, _ = ref["perm"]
    assert np.abs(_counts(res["perm"][0], 25) - _counts(pj, 25)).max() <= 1
    np.testing.assert_allclose(res["perm"][1], np.asarray(mj), atol=1e-5)


def test_sharded_local_moran(ranks, world):
    res, _, ref = ranks
    _eq(res["lisa"], tm.local_moran(world["graph"], world["Z"], 3, 10))
    want = ref["lisa"]
    np.testing.assert_allclose(res["lisa"].local_I, np.asarray(want.local_I),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(res["lisa"].p_value, np.asarray(want.p_value))


def test_cell_sharded_lag(ranks):
    """The (2, 2) LISA tiles' lag is the single-device lag, bitwise."""
    res, _, ref = ranks
    c2, X2 = W.tile_data(4)
    g2 = tg.build_graph(c2, n_neighbors=5, device="cpu")
    Z2, _ = tm.standardize(torch.as_tensor(X2))
    _eq(res["lisa_2d"].lag, tg.spatial_lag(g2, Z2))
    np.testing.assert_allclose(res["lisa_2d"].lag, np.asarray(ref["lag_2d"]),
                               atol=1e-6)


@pytest.mark.parametrize("mesh", ["knn", "knn_22"])
def test_sharded_knn_matches_single_device(ranks, mesh):
    res, _, ref = ranks
    coords = np.random.default_rng(5).uniform(0, 2000, (3000, 2)).astype(
        np.float32)
    _eq(res[mesh], tg.knn_grid(torch.as_tensor(coords), 6))
    idx_j, dist_j = ref["knn"]
    np.testing.assert_allclose(np.sort(res[mesh][1], axis=1),
                               np.sort(np.asarray(dist_j), axis=1),
                               rtol=1e-4, atol=1e-5)
    same = (np.sort(res[mesh][0], axis=1)
            == np.sort(np.asarray(idx_j), axis=1)).mean()
    assert same > 0.999


def test_sharded_build_graph(ranks):
    res, _, ref = ranks
    idx, w = res["knn_graph"]
    np.testing.assert_array_equal(idx, res["knn"][0])
    np.testing.assert_allclose(w.sum(axis=1), 1.0, rtol=1e-6)


def test_sharded_lees_l_matches_single_device(ranks, world):
    res, _, ref = ranks
    Z = world["Z"]
    _eq(res["lee"], tl.lees_l_pairs(world["graph"], Z[:, :8], Z[:, 8:], 2, 20,
                                    compute_cell_pvalues=True))
    want = ref["lee"]
    np.testing.assert_allclose(res["lee"].L_global, np.asarray(want.L_global),
                               rtol=1e-5)
    np.testing.assert_array_equal(res["lee"].p_global,
                                  np.asarray(want.p_global))


def test_sharded_getis_ord(ranks, world):
    res, _, ref = ranks
    Xraw = world["Z"].abs() + 0.1
    want = tgetis.getis_ord(world["graph"], Xraw, seed=7, n_permutations=13)
    np.testing.assert_array_equal(res["getis"].p_sim, want.p_sim.numpy())
    np.testing.assert_allclose(res["getis"].G, want.G.numpy(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(res["getis"].z_score, want.z_score.numpy(),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# The public global functions with a mesh
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _without_mesh(fn, null_method, x):
    return getattr(sctt.spatial, fn)(W._adata(x), n_permutations=25, seed=3,
                                     null_method=null_method,
                                     gene_batch_size=10, device="cpu").uns


@pytest.mark.parametrize("mesh,x", [("14", "numpy"), ("14", "torch"),
                                    ("22", "numpy")])
@pytest.mark.parametrize("null_method", ["slots", "banded", "banded_int8"])
@pytest.mark.parametrize("fn", ["morans_i", "gearys_c",
                                "global_autocorrelation"])
def test_global_with_mesh_equals_without(ranks, mesh, null_method, fn, x):
    """Tables bitwise those of the mesh-less call (10-gene batches: the
    16 genes pad to 12 and 4 columns over the gene shards), with X as
    numpy (column-major batches) and as a tensor (row-major)."""
    res, _, ref = ranks
    got = res["tables"][(mesh, null_method, fn, x)]
    want = _without_mesh(fn, null_method, x)
    for key, table in got.items():
        pd.testing.assert_frame_equal(table, want[key], check_exact=True)


def test_morans_i_with_mesh_matches_reference(ranks):
    """The JAX package's morans_i(mesh=...) on the same data: I within
    rtol 1e-5, p within one draw."""
    res, _, ref = ranks
    got = res["tables"][("14", "banded_int8", "morans_i", "numpy")]["morans_i"]
    want = ref["morans_i"]
    np.testing.assert_allclose(got["I"], want["I"], rtol=1e-5, atol=1e-7)
    assert np.abs(_counts(got["p_value"], 25)
                  - _counts(want["p_value"], 25)).max() <= 1


# ---------------------------------------------------------------------------
# Cells × genes
# ---------------------------------------------------------------------------


def test_local_moran_2d_sharding_bitwise(ranks):
    res, shapes, ref = ranks
    c2, X2 = W.tile_data(4)
    g2 = tg.build_graph(c2, n_neighbors=5, device="cpu")
    Z2, _ = tm.standardize(torch.as_tensor(X2))
    want = tm.local_moran(g2, Z2, 3, 23)
    _eq(res["lisa_2d"], want)
    _eq(res["lisa_2d_dtensor"], want)
    assert shapes[0]["placements"] == ("S(0)", "S(1)")
    jref = ref["lisa_2d"]
    np.testing.assert_allclose(res["lisa_2d"].local_I, np.asarray(jref.local_I),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(res["lisa_2d"].p_value,
                                  np.asarray(jref.p_value))


@pytest.mark.parametrize("name,shape", [
    ("local_moran_2d", (256, 4)), ("local_geary_2d", (256, 4)),
    ("lees_l_2d", (256, 2)), ("getis_2d", (256, 4))])
def test_2d_tiles_hold_only_their_block(ranks, name, shape):
    """Every rank of the (2, 2) mesh holds an [N/2, G/2] tile."""
    _, shapes, _ = ranks
    assert [s[name] for s in shapes] == [shape] * WORLD


def test_local_family_2d_sharding(ranks):
    """Local Geary and local Lee bitwise; Lee's global L within the
    reference's rtol 1e-6 / atol 1e-7 (float32 parts added across cell
    shards); Getis' G / z bitwise on integer counts, whose float64 column
    sums are exact, within the reference's tolerances on float data, and
    p_sim bitwise."""
    res, _, ref = ranks
    c6, X6 = W.tile_data(6)
    g6 = tg.build_graph(c6, n_neighbors=5, device="cpu")
    Z6, _ = tm.standardize(torch.as_tensor(X6))
    _eq(res["geary_2d"], tm.local_geary(g6, Z6, 2, 19))
    ref = tl.lees_l_pairs(g6, Z6[:, :4], Z6[:, 4:], 5, 17,
                          compute_cell_pvalues=True)
    for f in ("L_local", "lag_zy", "p_local", "p_global"):
        _eq(getattr(res["lee_2d"], f), getattr(ref, f))
    np.testing.assert_allclose(res["lee_2d"].L_global, ref.L_global.numpy(),
                               rtol=1e-6, atol=1e-7)
    go = tgetis.getis_ord(g6, torch.as_tensor(X6), seed=7, n_permutations=13)
    np.testing.assert_allclose(res["getis_2d"].G, go.G.numpy(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(res["getis_2d"].z_score, go.z_score.numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(res["getis_2d"].p_sim, go.p_sim.numpy())
    counts = torch.as_tensor(np.random.default_rng(8).poisson(3.0, (512, 8)),
                             dtype=torch.float32)
    _eq(res["getis_2d_counts"], tgetis.getis_ord(g6, counts, seed=7,
                                                 n_permutations=13))


# ---------------------------------------------------------------------------
# Banded nulls, gene-sharded
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,kw", [
    ("bf16_xla", dict(band_impl="xla")), ("bf16", {}),
    ("int8", dict(precision="int8")),
    ("int8_xla", dict(precision="int8", band_impl="xla")),
    ("int8_win", dict(precision="int8", coords=True)),
    ("int4", dict(precision="int4", coords=True))])
def test_banded_sharded_matches_single_device(ranks, world, name, kw):
    """p and the null moments bitwise: each rank launches at the whole
    table's shape (``launch_genes``) and sums Σz² in one order."""
    res, _, ref = ranks
    kw = dict(kw)
    plan = (tb.build_null_plan(world["graph"], torch.as_tensor(world["coords"]),
                               block=64) if kw.pop("coords", False)
            else world["plan"])
    g, Z, S0 = world["graph"], world["Z"], world["S0"]
    p, m, s = tb.banded_permutation_test(plan, Z, S0,
                                         tm.moran_observed(g, Z, S0), 3, 20,
                                         **kw)
    _eq(res[f"banded_{name}"], (p, m, s))


def test_banded_sharded_int8_matches_reference(ranks, world):
    res, _, ref = ranks
    pj, _, _ = ref["banded_int8"]
    assert np.abs(_counts(res["banded_int8"][0], 20) - _counts(pj, 20)).max() <= 1


def test_sharded_fused_moran_geary_bitwise(ranks, world):
    res, _, ref = ranks
    g, Z, S0 = world["graph"], world["Z"], world["S0"]
    obs = torch.stack([tm.moran_observed(g, Z, S0), tm.geary_observed(g, Z, S0)])
    p, m, s = tb.banded_permutation_test(
        world["plan"], Z, S0, obs, 7, 20, stat="moran_geary",
        alternative=("greater", "less"), band_impl="xla")
    got = res["banded_fused"]
    assert got[0].shape == (2, 16)
    np.testing.assert_array_equal(got[0], p.numpy())
    np.testing.assert_allclose(got[1], m.numpy(), atol=1e-6)
    np.testing.assert_allclose(got[2], s.numpy(), atol=2e-5)


def test_sharded_banded_local_moran_int8(ranks, world):
    res, _, ref = ranks
    want = tb.banded_local_moran(world["plan"], world["graph"], world["Z"], 7,
                                 20, precision="int8")
    _eq(res["banded_lisa"], want)
    jref = ref["banded_lisa"]
    np.testing.assert_array_equal(res["banded_lisa"].p_value,
                                  np.asarray(jref.p_value))


def test_sharded_banded_family_bitwise(ranks, world):
    res, _, ref = ranks
    plan, Z = world["plan"], world["Z"]
    _eq(res["banded_geary"], tb.banded_local_geary(plan, Z, 3, 16))
    _eq(res["banded_getis"], tb.banded_getis(plan, Z.abs() + 0.1, 3, 16))
    _eq(res["banded_lee"], tb.banded_lees_l(plan, Z[:, :8], Z[:, 8:], 3, 16,
                                            compute_cell_pvalues=True))


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,per_call", [
    ("perm", 0), ("banded_int8", 0), ("banded_lisa", 0),
    ("lisa_2d_dtensor", 1), ("lee_2d", 1), ("morans_i", 1)])
def test_no_collective_in_the_draw_loop(ranks, name, per_call):
    """A call issues the same collectives at 5 draws as at 50: the
    gene-sharded nulls none, the 2D forms one gather of a DTensor input
    or one all-reduce of the global parts, morans_i one gather a batch."""
    res, _, ref = ranks
    assert res["comm"][(name, 5)] == res["comm"][(name, 50)] == per_call
