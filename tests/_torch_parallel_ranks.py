"""One rank of the gloo process group that ``test_torch_parallel.py``
spawns: ``python _torch_parallel_ranks.py RANK WORLD STORE OUT``.

Imports only torch and the port. Every rank runs every sharded function
on the same seeded inputs over a (1, 4) and a (2, 2) mesh; rank 0 writes
the gathered results, and every rank its 2D tiles' local shapes, with
``torch.save`` into OUT.
"""

import os
import sys
from datetime import timedelta

import numpy as np
import pandas as pd
import torch
import torch.distributed as dist

torch.set_num_threads(1)

from torch.distributed.tensor import Shard, distribute_tensor  # noqa: E402
from torch.distributed.tensor.debug import CommDebugMode  # noqa: E402

import spatialcore_tpu_torch as sctt  # noqa: E402
from spatialcore_tpu_torch import parallel as par  # noqa: E402
from spatialcore_tpu_torch.ops.banded import build_null_plan  # noqa: E402
from spatialcore_tpu_torch.ops.graph import build_graph  # noqa: E402
from spatialcore_tpu_torch.ops.moran import (geary_observed,  # noqa: E402
                                             moran_observed, standardize)


def world_data():
    """The reference test's 512 × 16 world (tests/test_parallel.py)."""
    rng = np.random.default_rng(0)
    coords = rng.uniform(0, 1000, (512, 2)).astype(np.float32)
    X = rng.standard_normal((512, 16)).astype(np.float32)
    return coords, X


def tile_data(seed):
    """The reference's 2D tests' 512 × 8 data on an 80 × 80 square."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, 80, (512, 2)).astype(np.float32)
    X = rng.normal(0, 1, (512, 8)).astype(np.float32)
    return coords, X


def adata_data():
    """The reference's public mesh test data: 600 cells × 16 genes."""
    rng = np.random.default_rng(5)
    coords = rng.uniform(0, 800, (600, 2)).astype(np.float32)
    X = rng.standard_normal((600, 16)).astype(np.float32)
    X[:, 0] += np.sin(coords[:, 0] / 40) * 2
    X[:, 5] = 2.0                                   # zero variance
    return coords, X


def _full(x):
    if hasattr(x, "full_tensor"):
        return x.full_tensor()
    if isinstance(x, tuple):
        return type(x)(*map(_full, x)) if hasattr(x, "_fields") else tuple(
            map(_full, x))
    return x


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, tuple):
        parts = [_numpy(t) for t in x]
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
    return x


def comm_count(fn):
    with CommDebugMode() as cm:
        fn()
    return cm.get_total_counts()


def main(rank, world, store, out):
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=90))
    res, shapes = {}, {}
    mesh14 = par.auto_mesh()
    mesh22 = par.auto_mesh(cell_shards=2)
    res["mesh_shapes"] = (tuple(mesh14.shape), tuple(mesh22.shape),
                          mesh14.mesh_dim_names)
    try:
        par.auto_mesh(cell_shards=3)
        res["cell_shards_3"] = "no error"
    except ValueError as e:
        res["cell_shards_3"] = str(e)

    os.environ["LOCAL_WORLD_SIZE"] = "2"          # two hosts of two ranks
    errors = []
    for cs in (3, 6):
        try:
            par.auto_mesh(cell_shards=cs)
        except ValueError as e:
            errors.append(str(e))
    res["multi_host"] = (tuple(par.auto_mesh().shape), *errors)
    del os.environ["LOCAL_WORLD_SIZE"]

    coords, X = world_data()
    graph = build_graph(coords, n_neighbors=6, device="cpu")
    Xt = torch.as_tensor(X)
    S0 = float(X.shape[0])
    Z, _ = standardize(Xt)
    plan = build_null_plan(graph, block=64)
    plan_c = build_null_plan(graph, torch.as_tensor(coords), block=64)
    obs = moran_observed(graph, Z, S0)
    Zx, Zy = Z[:, :8], Z[:, 8:16]
    Xraw = Z.abs() + 0.1

    res["moran"] = par.sharded_moran(graph, Xt, S0, mesh14)
    res["perm"] = par.sharded_permutation_test(graph, Xt, S0, 7, 25, mesh14)
    res["lisa"] = par.sharded_local_moran(graph, Xt, 3, 10, mesh14)
    res["lee"] = par.sharded_lees_l(graph, Zx, Zy, 2, 20, mesh14,
                                    compute_cell_pvalues=True)
    res["getis"] = par.sharded_getis_ord(graph, Xraw, mesh14, seed=7,
                                         n_permutations=13)
    for name, kw in (("bf16_xla", dict(band_impl="xla")),
                     ("bf16", {}),
                     ("int8", dict(precision="int8")),
                     ("int8_xla", dict(precision="int8", band_impl="xla")),
                     ("int8_win", dict(precision="int8", plan=plan_c)),
                     ("int4", dict(precision="int4", plan=plan_c))):
        kw = dict(kw)
        res[f"banded_{name}"] = par.sharded_banded_permutation_test(
            kw.pop("plan", plan), Z, S0, obs, 3, 20, mesh14, **kw)
    obs2 = torch.stack([obs, geary_observed(graph, Z, S0)])
    res["banded_fused"] = par.sharded_banded_permutation_test(
        plan, Z, S0, obs2, 7, 20, mesh14, stat="moran_geary",
        alternative=("greater", "less"), band_impl="xla")
    res["banded_lisa"] = par.sharded_banded_local_moran(plan, graph, Z, 7, 20,
                                                        mesh14)
    res["banded_geary"] = par.sharded_banded_local_geary(plan, graph, Z, 3, 16,
                                                         mesh14)
    res["banded_getis"] = par.sharded_banded_getis(plan, graph, Xraw, 3, 16,
                                                   mesh14)
    res["banded_lee"] = par.sharded_banded_lees_l(
        plan, graph, Zx, Zy, 3, 16, mesh14, compute_cell_pvalues=True)

    # cells × genes
    c2, X2 = tile_data(4)
    g2 = build_graph(c2, n_neighbors=5, device="cpu")
    Z2, _ = standardize(torch.as_tensor(X2))
    lm = par.sharded_local_moran_2d(g2, Z2, 3, 23, mesh22)
    shapes["local_moran_2d"] = tuple(lm.local_I.to_local().shape)
    shapes["placements"] = tuple(str(p) for p in lm.local_I.placements)
    res["lisa_2d"] = lm
    Zd = distribute_tensor(Z2, mesh22, (Shard(0), Shard(1)))
    res["lisa_2d_dtensor"] = par.sharded_local_moran_2d(g2, Zd, 3, 23, mesh22)
    c6, X6 = tile_data(6)
    g6 = build_graph(c6, n_neighbors=5, device="cpu")
    Z6, _ = standardize(torch.as_tensor(X6))
    lg = par.sharded_local_geary_2d(g6, Z6, 2, 19, mesh22)
    shapes["local_geary_2d"] = tuple(lg.local_C.to_local().shape)
    res["geary_2d"] = lg
    ll = par.sharded_lees_l_2d(g6, Z6[:, :4], Z6[:, 4:], 5, 17, mesh22,
                               compute_cell_pvalues=True)
    shapes["lees_l_2d"] = tuple(ll.L_local.to_local().shape)
    res["lee_2d"] = ll
    X6t = torch.as_tensor(X6)
    go = par.sharded_getis_ord_2d(g6, X6t, mesh22, seed=7, n_permutations=13)
    shapes["getis_2d"] = tuple(go.G.to_local().shape)
    res["getis_2d"] = go
    counts = torch.as_tensor(np.random.default_rng(8).poisson(3.0, (512, 8)),
                             dtype=torch.float32)
    res["getis_2d_counts"] = par.sharded_getis_ord_2d(
        g6, counts, mesh22, seed=7, n_permutations=13)

    # collectives a call issues, at 5 and at 50 draws (128 cells × 8 genes)
    rng = np.random.default_rng(9)
    cs_, Xs = rng.uniform(0, 300, (128, 2)).astype(np.float32), torch.as_tensor(
        rng.standard_normal((128, 8)).astype(np.float32))
    gs_ = build_graph(cs_, n_neighbors=6, device="cpu")
    Zs, _ = standardize(Xs)
    ps_ = build_null_plan(gs_, block=64)
    obs_s = moran_observed(gs_, Zs, 128.0)
    Zsd = distribute_tensor(Zs, mesh22, (Shard(0), Shard(1)))
    small = sctt.SpatialData(X=Xs.numpy().copy())
    small.obsm["spatial"] = cs_
    comm = {}
    for P in (5, 50):
        comm[("perm", P)] = comm_count(lambda: par.sharded_permutation_test(
            gs_, Xs, 128.0, 7, P, mesh14))
        comm[("banded_int8", P)] = comm_count(
            lambda: par.sharded_banded_permutation_test(
                ps_, Zs, 128.0, obs_s, 3, P, mesh14, precision="int8"))
        comm[("banded_lisa", P)] = comm_count(
            lambda: par.sharded_banded_local_moran(ps_, gs_, Zs, 7, P, mesh14))
        comm[("lisa_2d_dtensor", P)] = comm_count(
            lambda: par.sharded_local_moran_2d(gs_, Zsd, 3, P, mesh22))
        comm[("lee_2d", P)] = comm_count(
            lambda: par.sharded_lees_l_2d(gs_, Zs[:, :4], Zs[:, 4:], 5, P,
                                          mesh22))
        comm[("morans_i", P)] = comm_count(
            lambda: sctt.spatial.morans_i(small.copy(), n_permutations=P,
                                          seed=3, mesh=mesh14, device="cpu"))
    res["comm"] = comm

    # kNN
    kc = np.random.default_rng(5).uniform(0, 2000, (3000, 2)).astype(np.float32)
    res["knn"] = par.sharded_knn(kc, 6, mesh14, tile=256)
    res["knn_22"] = par.sharded_knn(kc, 6, mesh22, tile=256)
    g = par.sharded_build_graph(kc, mesh14, n_neighbors=6)
    res["knn_graph"] = (g.neighbor_idx, g.neighbor_w)

    # the public global functions with a mesh
    tables = {}
    for mname, mesh in (("14", mesh14), ("22", mesh22)):
        for nm in ("slots", "banded", "banded_int8"):
            for fn in ("morans_i", "gearys_c", "global_autocorrelation"):
                for x in ("numpy", "torch") if mname == "14" else ("numpy",):
                    a = getattr(sctt.spatial, fn)(
                        _adata(x), n_permutations=25, seed=3, null_method=nm,
                        mesh=mesh, gene_batch_size=10, device="cpu")
                    keys = (("morans_i", "gearys_c")
                            if fn == "global_autocorrelation" else (fn,))
                    tables[(mname, nm, fn, x)] = {k: a.uns[k] for k in keys}
    res["tables"] = tables

    plain = ("comm", "tables", "mesh_shapes", "cell_shards_3", "multi_host")
    res = {k: v if k in plain else _numpy(_full(v)) for k, v in res.items()}
    torch.save(shapes, f"{out}/shapes{rank}.pt")
    if rank == 0:
        torch.save(res, f"{out}/results.pt")
    dist.barrier()
    dist.destroy_process_group()


def _adata(x="numpy"):
    """The data as an adata whose X is a numpy array (its gene batches
    come column-major) or a CPU tensor (row-major)."""
    coords, X = adata_data()
    a = sctt.SpatialData(
        X=X.copy() if x == "numpy" else torch.as_tensor(X), obs=pd.DataFrame(index=[f"c{i}" for i in range(len(X))]),
        var=pd.DataFrame(index=[f"g{i}" for i in range(X.shape[1])]))
    a.obsm["spatial"] = coords
    return a


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
