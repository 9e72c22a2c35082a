"""CPU parity of the port's training half of annotation against the JAX
package.

* ``adamw_step`` against ``optax.adamw`` on the same gradients: bitwise
  (parameters and both moments) over 300 steps; the bias corrections
  ``1 − b**count`` bitwise at every count up to 100,000 but two (b2 at
  counts 2,958 and 3,606, one ulp off: the port raises the float32 decay
  to the count in float64, the reference's CPU run calls ``powf``).
* ``train_cell_type_model``: three steps (one epoch of three 600-cell
  batches, the tail dropped) within 1e-6 of max|W|; five epochs of 2,000
  cells × 40 genes × 4 types within 1e-5 of max|W| (b too) with equal
  predicted labels; the scaler and the classes bitwise. float32 products in
  another order keep it from bitwise. The class counts are unequal: where a
  batch holds equal counts of every class, the bias gradient at the first
  step is zero in exact arithmetic and rounding noise in both packages,
  which Adam's first update scales to ±learning_rate.
* Models trained by one package score in the other's ``annotate_cells``
  with equal labels.
* Checkpoints: a resumed run bitwise the uninterrupted one, checkpointing
  leaves training bitwise unchanged, two checkpoints kept, and an error on
  a directory of foreign step folders.
* ``combine_references`` (X bitwise, obs equal), ``_source_targets``,
  ``_resolve_target_totals``, ``subsample_balanced`` (equal cells) and
  ``train_celltypist_model`` with ``feature_selection`` (equal genes).
"""

import numpy as np
import optax
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

import spatialcore_tpu as sct
import spatialcore_tpu.annotation as ja
import spatialcore_tpu_torch as pt
import spatialcore_tpu_torch.annotation as pa
from spatialcore_tpu.annotation import training as jt
from spatialcore_tpu_torch.annotation import training as ptr

# One intra-op thread: xdist runs several test workers at once, and torch's
# default of one thread per core in each slows small ops several-fold.
torch.set_num_threads(1)

TYPES = ["T cell", "B cell", "Macrophage", "Fibroblast"]


def _expression(counts=(620, 480, 530, 370), n_genes=40, seed=0, lam=3.0):
    """log1p-normalized expression of four types with marker blocks."""
    rng = np.random.default_rng(seed)
    lab = np.repeat(np.arange(len(counts)), counts)
    c = rng.poisson(1.0, (lab.size, n_genes)).astype(np.float32)
    for t in range(len(counts)):
        rows = lab == t
        c[rows, t * 8:t * 8 + 8] += rng.poisson(lam, (int(rows.sum()), 8))
    X = np.log1p(c / c.sum(1, keepdims=True) * 1e4).astype(np.float32)
    obs = pd.DataFrame({"cell_type": np.array(TYPES)[lab]},
                       index=[f"c{i}" for i in range(lab.size)])
    var = pd.DataFrame(index=[f"G{j}" for j in range(n_genes)])
    return X, obs, var


def _pair(X, obs, var):
    return (sct.SpatialData(X=X.copy(), obs=obs.copy(), var=var.copy()),
            pt.SpatialData(X=X.copy(), obs=obs.copy(), var=var.copy()))


def test_adamw_step_bitwise_against_optax():
    rng = np.random.default_rng(0)
    lr, l2 = 0.05, 1e-4
    opt = optax.adamw(lr, weight_decay=l2)
    params = (jnp.asarray(rng.normal(0, 1, (300, 7)).astype(np.float32)),
              jnp.asarray(rng.normal(0, 1, 7).astype(np.float32)))
    state = opt.init(params)

    @jax.jit
    def step(params, state, grads):
        u, state = opt.update(grads, state, params)
        return optax.apply_updates(params, u), state

    P = [torch.tensor(np.asarray(p)) for p in params]
    mu = [torch.zeros_like(p) for p in P]
    nu = [torch.zeros_like(p) for p in P]
    count = 0
    for _ in range(300):
        grads = tuple(rng.normal(0, 10 ** rng.uniform(-4, 1), p.shape)
                      .astype(np.float32) for p in P)
        params, state = step(params, state, tuple(map(jnp.asarray, grads)))
        count = ptr.adamw_step(P, [torch.tensor(g) for g in grads], mu, nu,
                               count, lr, l2)
        for i in range(2):
            assert np.array_equal(P[i].numpy(), np.asarray(params[i]))
            assert np.array_equal(mu[i].numpy(), np.asarray(state[0].mu[i]))
            assert np.array_equal(nu[i].numpy(), np.asarray(state[0].nu[i]))
    assert count == int(state[0].count) == 300


@pytest.mark.parametrize("decay,off", [(0.9, []), (0.999, [2958, 3606])])
def test_bias_correction_against_optax(decay, off):
    n = 100_000
    want = np.asarray(jax.jit(lambda c: 1 - decay ** c)(
        jnp.arange(1, n + 1, dtype=jnp.int32)))
    got = np.array([ptr._bias_correction(decay, c) for c in range(1, n + 1)],
                   np.float32)
    bad = np.nonzero(got != want)[0] + 1
    assert bad.tolist() == off
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1


def _train_both(X, obs, var, **kw):
    a, b = _pair(X, obs, var)
    return (ja.train_cell_type_model(a, **kw),
            pa.train_cell_type_model(b, device="cpu", **kw))


def test_three_steps_tight():
    X, obs, var = _expression()
    jm, pm = _train_both(X, obs, var, epochs=1, batch_size=600, seed=4)
    scale = float(np.abs(jm.W).max())
    np.testing.assert_allclose(pm.W, jm.W, rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(pm.b, jm.b, rtol=0, atol=1e-6 * scale)
    assert pm.metadata["batch_size"] == 600
    np.testing.assert_allclose(pm.metadata["final_loss"],
                               jm.metadata["final_loss"], rtol=1e-6)


@pytest.mark.parametrize("seed,balance", [(0, True), (1, False)])
def test_five_epochs_weights_and_labels(seed, balance):
    X, obs, var = _expression(seed=seed)
    jm, pm = _train_both(X, obs, var, epochs=5, batch_size=128, seed=seed,
                         balance_cell_type=balance)
    scale = float(np.abs(jm.W).max())
    np.testing.assert_allclose(pm.W, jm.W, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(pm.b, jm.b, rtol=0, atol=1e-5 * scale)
    assert np.array_equal(pm.scaler_mean, jm.scaler_mean)
    assert np.array_equal(pm.scaler_std, jm.scaler_std)
    assert pm.classes == jm.classes and pm.genes == jm.genes
    lj, _ = jm.predict(X)
    lp, _ = pm.predict(X, device="cpu")
    assert np.array_equal(lp, lj)
    assert (lp == obs["cell_type"].to_numpy()).mean() > 0.95
    keys = set(jm.metadata) - {"trained_at"}
    assert keys == set(pm.metadata) - {"trained_at"}
    assert all(pm.metadata[k] == jm.metadata[k] for k in keys
               if k != "final_loss")


def test_sparse_and_tensor_inputs_train_alike():
    X, obs, var = _expression(seed=2)
    ref = pa.train_cell_type_model(pt.SpatialData(X=X, obs=obs, var=var),
                                   epochs=2, batch_size=256, device="cpu")
    for Xin in (sp.csr_matrix(X), torch.tensor(X)):
        m = pa.train_cell_type_model(pt.SpatialData(X=Xin, obs=obs, var=var),
                                     epochs=2, batch_size=256, device="cpu")
        assert np.array_equal(m.W, ref.W)
        assert np.array_equal(m.scaler_std, ref.scaler_std)


def test_models_score_across_packages(tmp_path):
    X, obs, var = _expression(seed=3)
    jm, pm = _train_both(X, obs, var, epochs=5, batch_size=256, seed=3)
    pm_path = pa.save_model_artifacts(pm, tmp_path / "p", "port_model")["model"]
    jm_path = ja.save_model_artifacts(jm, tmp_path / "j", "jax_model")["model"]
    Xq, obsq, _ = _expression(counts=(80, 90, 70, 60), seed=9)
    obsq = obsq.drop(columns=["cell_type"])
    labels = []
    for path in (pm_path, jm_path):
        a, b = _pair(Xq, obsq, var)
        ja.annotate_cells(a, ja.CellTypeModel.load(path))
        pa.annotate_cells(b, pa.CellTypeModel.load(path), device="cpu")
        assert a.obs["cell_type"].astype(str).equals(
            b.obs["cell_type"].astype(str))
        labels.append(b.obs["cell_type"].astype(str).to_numpy())
    assert np.array_equal(labels[0], labels[1])


def test_device_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' runs there")
    X, obs, var = _expression(counts=(30, 30, 30, 30))
    with pytest.raises((RuntimeError, AssertionError)):
        pa.train_cell_type_model(pt.SpatialData(X=X, obs=obs, var=var),
                                 epochs=1)


def _ckpt_ref(n_per=120, seed=0):
    """The checkpoint tests' reference: three types over 24 genes, raw
    counts normalized through ``ensure_normalized``."""
    rng = np.random.default_rng(seed)
    n = n_per * 3
    c = rng.poisson(1.0, (n, 24)).astype(np.float32)
    for t in range(3):
        c[t * n_per:(t + 1) * n_per, t * 6:t * 6 + 6] += rng.poisson(
            7.0, (n_per, 6))
    a = pt.SpatialData(X=sp.csr_matrix(c), obs=pd.DataFrame(
        {"cell_type": np.repeat(["A", "B", "C"], n_per)},
        index=[f"c{i}" for i in range(n)]))
    a.layers["counts"] = sp.csr_matrix(c)
    pa.ensure_normalized(a)
    return a


def test_resume_matches_uninterrupted(tmp_path):
    a = _ckpt_ref()
    full = pa.train_cell_type_model(a, epochs=16, seed=0, device="cpu")
    ck = tmp_path / "ck"
    pa.train_cell_type_model(a, epochs=8, seed=0, checkpoint_dir=ck,
                             checkpoint_every=4, device="cpu")
    assert sorted(p.name for p in ck.iterdir()) == ["3", "7"]
    state = torch.load(ck / "7" / ptr.CHECKPOINT_FILE, weights_only=True)
    assert state["epoch"] == 7 and state["count"] == 8 * 1
    resumed = pa.train_cell_type_model(a, epochs=16, seed=0, checkpoint_dir=ck,
                                       checkpoint_every=4, resume=True,
                                       device="cpu")
    assert np.array_equal(resumed.W, full.W)
    assert np.array_equal(resumed.b, full.b)
    # keep two: 11 and 15 remain
    assert sorted(int(p.name) for p in ck.iterdir()) == [11, 15]
    # fully resumed: no update, the forward loss over all the data
    again = pa.train_cell_type_model(a, epochs=16, seed=0, checkpoint_dir=ck,
                                     device="cpu")
    assert np.array_equal(again.W, full.W)
    assert np.isfinite(again.metadata["final_loss"])


def test_checkpointing_does_not_perturb_training(tmp_path):
    a = _ckpt_ref(seed=1)
    plain = pa.train_cell_type_model(a, epochs=10, seed=3, device="cpu")
    ckpt = pa.train_cell_type_model(a, epochs=10, seed=3,
                                    checkpoint_dir=tmp_path / "ck2",
                                    checkpoint_every=3, device="cpu")
    assert np.array_equal(plain.W, ckpt.W)
    assert sorted(int(p.name) for p in (tmp_path / "ck2").iterdir()) == [8, 9]


def test_foreign_checkpoint_directory_raises(tmp_path):
    a = _ckpt_ref(n_per=40)
    (tmp_path / "ck" / "4" / "default").mkdir(parents=True)   # an orbax step
    with pytest.raises(ValueError, match="cannot be resumed"):
        pa.train_cell_type_model(a, epochs=2, checkpoint_dir=tmp_path / "ck",
                                 device="cpu")


def _raw_reference(n_per_type=200, n_genes=40, seed=0, source="refA"):
    rng = np.random.default_rng(seed)
    n = n_per_type * len(TYPES)
    counts = rng.poisson(1.0, size=(n, n_genes)).astype(np.float32)
    for t in range(len(TYPES)):
        counts[t * n_per_type:(t + 1) * n_per_type, t * 8:t * 8 + 8] += \
            rng.poisson(8.0, size=(n_per_type, 8))
    obs = pd.DataFrame({"cell_type": np.repeat(TYPES, n_per_type)},
                       index=[f"{source}_{i}" for i in range(n)])
    var = pd.DataFrame(index=[f"G{j}" for j in range(n_genes)])
    return counts, obs, var


def _refs(pkg):
    out = []
    for seed, n, src in ((0, 200, "refA"), (1, 100, "refB")):
        counts, obs, var = _raw_reference(n, seed=seed, source=src)
        if src == "refB":
            labels = obs["cell_type"].to_numpy(object)
            labels[:30] = "Unknown"
            labels[30:33] = "Rare"
            obs["cell_type"] = labels
            var = var.iloc[2:]
            counts = counts[:, 2:]
        d = pkg.SpatialData(X=sp.csr_matrix(counts), obs=obs.copy(),
                            var=var.copy())
        d.layers["counts"] = sp.csr_matrix(counts)
        d.uns["reference_name"] = src
        out.append(d)
    return out


def test_combine_references_and_balancing_equal():
    kw = dict(label_columns="cell_type", output_column="cell_type",
              target_genes=[f"G{j}" for j in range(36)], max_cells_per_ref=700)
    cj = ja.combine_references(_refs(sct), **kw)
    cp = pa.combine_references(_refs(pt), **kw)
    assert list(cp.var_names) == list(cj.var_names)
    assert list(cp.obs_names) == list(cj.obs_names)
    pd.testing.assert_frame_equal(cp.obs, cj.obs)
    assert (cp.X != cj.X).nnz == 0
    assert (cp.obs["cell_type"] != "Unknown").all()
    assert "Rare" not in set(cp.obs["cell_type"])
    for kw in ({"source_balance": "equal"}, {"source_balance": "proportional"},
               {"target_proportions": {"T cell": 0.4}},
               {"group_by_column": "reference_source"}):
        sj = ja.subsample_balanced(cj, max_cells_per_type=150,
                                   min_cells_per_type=20, seed=2, **kw)
        sp_ = pa.subsample_balanced(cp, max_cells_per_type=150,
                                    min_cells_per_type=20, seed=2, **kw)
        assert list(sp_.obs_names) == list(sj.obs_names), kw
    with pytest.raises(ValueError, match="At least one"):
        pa.combine_references([])


def test_subsample_balanced_keeps_ungrouped_cells():
    X, obs, var = _expression(counts=(50, 50, 50, 50))
    a, b = _pair(X, obs, var)
    ids = np.full(200, None, dtype=object)
    ids[:50] = "CL:0000236"
    for d in (a, b):
        d.obs["cell_type_ontology_term_id"] = pd.array(ids, dtype=object)
    sub = pa.subsample_balanced(b, max_cells_per_type=5000,
                                group_by_column="cell_type_ontology_term_id")
    assert sub.n_obs == 200


@pytest.mark.parametrize("counts,total,balance", [
    ({"a": 1000, "b": 30, "c": 1000}, 500, "equal"),
    ({"a": 3000, "b": 800, "c": 200}, 600, "proportional"),
    ({"a": 3000, "b": 100, "c": 200}, 600, "proportional"),
    ({"x": 7}, 5, "equal"),
])
def test_source_targets_equal(counts, total, balance):
    got = ptr._source_targets(counts, total, 50, balance)
    assert got == jt._source_targets(counts, total, 50, balance)
    if counts == {"a": 1000, "b": 30, "c": 1000}:
        assert got == {"a": 167 + 137, "b": 30, "c": 166}
    with pytest.raises(ValueError, match="source_balance"):
        ptr._source_targets(counts, total, 50, "weird")


@pytest.mark.parametrize("counts,props", [
    ({"A": 10000, "B": 30, "C": 600}, None),
    ({"A": 10000, "B": 30, "C": 600}, {"A": 0.5}),
    ({"A": 400, "B": 30, "C": 600}, {"A": 0.5}),
    ({"A": 900, "B": 800, "C": 20}, {"A": 0.3, "B": 0.2}),
])
def test_resolve_target_totals_equal(counts, props):
    got = ptr._resolve_target_totals(counts, 50, 5000, props)
    assert got == jt._resolve_target_totals(counts, 50, 5000, props)


@pytest.mark.parametrize("args,match", [
    (({"A": 100}, 10, 50, {"Z": 0.5}), "not found in data"),
    (({"A": 100, "B": 100}, 10, 50, {"A": 0.9, "B": 0.9}), "must be <= 1.0"),
    (({"A": 100, "B": 100}, 10, 50, {"A": 1.0}), "sum to 1.0"),
])
def test_resolve_target_totals_errors(args, match):
    with pytest.raises(ValueError, match=match):
        ptr._resolve_target_totals(*args)


def test_celltypist_feature_selection_equal(tmp_path):
    X, obs, var = _expression(counts=(260, 200, 230, 150), n_genes=360,
                              seed=5, lam=4.0)
    a, b = _pair(X, obs, var)
    kw = dict(label_column="cell_type", feature_selection=True, epochs=3,
              batch_size=64, batch_number=5, random_state=1)
    jm = ja.train_celltypist_model(a, **kw)
    pm = pa.train_celltypist_model(b, output_path=tmp_path, device="cpu", **kw)
    assert pm.genes == jm.genes and 300 <= pm.n_genes < 360
    assert pm.metadata["feature_selection"] is True
    assert pm.metadata["batch_size"] == jm.metadata["batch_size"] == 168
    assert (tmp_path / "custom_model.npz").exists()
    assert (tmp_path / "custom_model_colors.json").exists()
    scale = float(np.abs(jm.W).max())
    np.testing.assert_allclose(pm.W, jm.W, rtol=0, atol=1e-5 * scale)


def test_artifact_helpers_equal():
    assert pa.DEFAULT_EXCLUDE_LABELS == ja.DEFAULT_EXCLUDE_LABELS
    assert pa.HIGH_CONTRAST_PALETTE == ja.HIGH_CONTRAST_PALETTE
    types = [f"t{i}" for i in range(25)]
    assert pa.generate_color_scheme(types, custom_colors={"t3": "#000000"}) \
        == ja.generate_color_scheme(types, custom_colors={"t3": "#000000"})
    X, obs, var = _expression(counts=(30, 20, 25, 15))
    a, b = _pair(X, obs, var)
    pd.testing.assert_frame_equal(pa.get_training_summary(b),
                                  ja.get_training_summary(a))
    assert pa.get_panel_genes(b) == ja.get_panel_genes(a)
