"""The bf16 wide-tile recipe of ``streaming_local_null`` (keys mode, LISA,
int8) in the port against its own float32-obs run and the JAX package's
bf16 run, on the CPU.

Tolerances, and why:
- p and p_adj: bitwise against both (the same integer counts, and p =
  (count + 1)·f32(1/(P+1)) per post chunk);
- z: bitwise the f32-obs run's compact z (one bf16 rounding of the same
  float32 z); lag and I within bf16 resolution of the f32-obs run's, cell
  by cell: 2⁻⁸ of Σ_j w_ij|z_j| and of |lag| (each neighbour's z and each
  compact cast round once to bf16), and for I = z·lag the product of those;
  and all three within one bf16 ulp of the reference's bf16 run (the same
  bf16 z; the lag's float32 sum can round to a neighbouring bf16), plus,
  for lag and I, the float32 sum's own rounding where it cancels to ~0;
- quadrants: equal to the reference's bf16 run; against the f32-obs run,
  equal except where |z| or |lag| lies below bf16 resolution of the
  comparison (their signs can flip there), and those cells are counted.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialcore_tpu.ops import banded as jb
from spatialcore_tpu.ops import graph as jg
from spatialcore_tpu.ops import streaming as js
from spatialcore_tpu_torch.ops import banded as tb
from spatialcore_tpu_torch.ops import graph as tg
from spatialcore_tpu_torch.ops import streaming as ts

# One intra-op thread: xdist runs several test workers at once, and torch's
# default of one thread per core in each slows small ops several-fold.
torch.set_num_threads(1)

KEYS = ("I", "z", "lag", "p", "p_adj", "quadrant")
P = 29


def _f32(x):
    x = x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32)
    return np.asarray(x)


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(5)
    n, g = 1500, 16
    c = rng.uniform(0, 120, (n, 2)).astype(np.float32)
    X = np.concatenate(
        [2 * np.sin(c[:, :1] / 10.0) + rng.normal(0, 0.5, (n, 1))
         for _ in range(g // 2)] + [rng.normal(0, 1, (n, g // 2))],
        axis=1).astype(np.float32)
    X[:, 5] = 3.0                                   # zero variance
    gj = jg.build_graph(c, n_neighbors=6)
    pj = jb.build_null_plan(gj, c, block=64)
    gt = tg.graph_from_numpy(gj, device="cpu")
    pt = tb.plan_from_numpy(pj, "cpu")
    kw = dict(stat="moran", seed=3, n_permutations=P, tile=8, post_chunk=4,
              keys=KEYS, alpha=0.3)
    out = {}
    for dt in ("f32", "bf16"):
        sink, fin = ts.device_local_sink(g, KEYS)
        ts.streaming_local_null(gt, pt, lambda s, w: X[:, s:s + w], g, sink,
                                obs_dtype=dt, device="cpu", **kw)
        out[dt] = fin()
    sink, fin = js.device_local_sink(g, KEYS)
    js.streaming_local_null(gj, pj, lambda s, w: X[:, s:s + w], g, sink,
                            obs_dtype="bf16", **kw)
    out["ref"] = fin()
    out["idx"] = np.asarray(gj.neighbor_idx)
    out["w"] = np.asarray(gj.neighbor_w)
    return out


def test_bf16_p_bitwise(runs):
    for k in ("p", "p_adj"):
        got = runs["bf16"][k]
        assert got.dtype == torch.float16
        np.testing.assert_array_equal(_f32(got), _f32(runs["f32"][k]), err_msg=k)
        np.testing.assert_array_equal(_f32(got), _f32(runs["ref"][k]), err_msg=k)
    assert (_f32(runs["bf16"]["p"])[:, 5] == 1).all()


def test_bf16_planes_within_bf16_resolution(runs):
    """z is the same bf16 rounding of the same float32 z in both runs; lag
    and I carry the bf16 rounding of every neighbour's z (2⁻⁹ relative
    each) and the compact casts (2⁻⁹ each), bounded cell by cell."""
    np.testing.assert_array_equal(_f32(runs["bf16"]["z"]), _f32(runs["f32"]["z"]))
    z, lag, I = (_f32(runs["f32"][k]) for k in ("z", "lag", "I"))
    abs_lag = np.zeros_like(z)                      # Σ_j w_ij |z_j|
    for j in range(runs["idx"].shape[1]):
        abs_lag += runs["w"][:, j:j + 1] * np.abs(z[runs["idx"][:, j]])
    eps = 2.0 ** -8
    bound = {"lag": eps * (abs_lag + np.abs(lag)),
             "I": np.abs(z) * eps * (abs_lag + 2 * np.abs(lag)) + eps * np.abs(I)}
    for k in ("I", "lag", "z"):
        got, ref = _f32(runs["bf16"][k]), _f32(runs["ref"][k])
        assert runs["bf16"][k].dtype == torch.bfloat16
        if k != "z":
            assert (np.abs(got - _f32(runs["f32"][k])) <= bound[k] + 1e-30).all(), k
        ulp = np.spacing(np.abs(ref).astype(np.float32)) * 2.0 ** 16
        # the float32 lag sums in another order: where they cancel to ~0
        # their rounding (2⁻²² of Σ_j w_ij|z_j|) outweighs a bf16 ulp
        f32_sum = 2.0 ** -22 * abs_lag * (np.abs(z) if k == "I" else 1.0)
        assert (np.abs(got - ref) <= ulp + f32_sum * (k != "z")).all(), k
    assert (_f32(runs["bf16"]["I"])[:, 5] == 0).all()


def test_bf16_quadrants(runs):
    got = runs["bf16"]["quadrant"].numpy()
    np.testing.assert_array_equal(got, np.asarray(runs["ref"]["quadrant"]))
    f32 = runs["f32"]["quadrant"].numpy()
    z, lag = _f32(runs["f32"]["z"]), _f32(runs["f32"]["lag"])
    small = (np.abs(z) < 2.0 ** -7) | (np.abs(lag) < 2.0 ** -7)
    differ = got != f32
    assert not (differ & ~small).any()
    assert differ.sum() <= small.sum()
    assert (got[:, :8] != 0).mean() > 0.05          # the smooth genes cluster


@pytest.mark.parametrize("width", [1, 7, 512])
def test_standardize_is_width_invariant(width):
    """The bf16 recipe standardizes 512 genes at a time, the f32-obs run a
    whole tile: p can be bitwise only if a gene's z does not depend on the
    genes standardized with it. torch's own column reductions order their
    adds by the width (on the CPU a 1-column mean differs from the same
    column's in a 2,048-wide one; on the card, 512 from 2,048), so the
    column sums run in one fixed pairwise order."""
    from spatialcore_tpu_torch.ops.moran import standardize

    g = torch.Generator().manual_seed(width)
    X = torch.randn((4000, 1100), generator=g) * 3 + 5
    Z, zv = standardize(X)
    for s in range(0, 1100, width * 97):
        Zc, zc = standardize(X[:, s:s + width])
        assert torch.equal(Zc, Z[:, s:s + width]) and torch.equal(zc, zv[s:s + width])
