"""CPU parity of the port's label tools against the JAX package: the
pattern table, the tokenizer and the scorer, ``search_ontology_index`` on
the 103 labels of ``fixtures/reference_ontology_mapping.json`` (CL IDs,
names, scores and match types equal), ``add_ontology_ids`` (every column
equal, the mapping artifacts equal), ``create_mapping_table``,
``has_ontology_ids``, label validation (equal issues) and the consistency
check; and the cases of ``tests/test_ontology.py`` on the port. String
work, so everything is compared exactly.
"""

import json
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import spatialcore_tpu as sct
import spatialcore_tpu.annotation as ja
import spatialcore_tpu_torch as pt
import spatialcore_tpu_torch.annotation as pa
from spatialcore_tpu.annotation import ontology as jo
from spatialcore_tpu_torch.annotation import ontology as po

# One intra-op thread: xdist runs several test workers at once, and torch's
# default of one thread per core in each slows small ops several-fold.
torch.set_num_threads(1)

FIXTURE = Path(__file__).parent / "fixtures" / "reference_ontology_mapping.json"
LABELS = list(json.loads(FIXTURE.read_text())["labels"])


def _pair(n_obs, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.poisson(2.0, (n_obs, 5)).astype(np.float32)
    obs = pd.DataFrame(index=[f"cell_{i}" for i in range(n_obs)])
    return sct.SpatialData(X=X.copy(), obs=obs.copy()), \
        pt.SpatialData(X=X.copy(), obs=obs.copy())


def test_pattern_table_and_canonical_terms():
    assert [(p.pattern, t) for p, t in pa.CELL_TYPE_PATTERNS] == \
        [(p.pattern, t) for p, t in ja.CELL_TYPE_PATTERNS]
    for label in LABELS + ["totally mysterious", "Tregs", "pDC", "γδ T"]:
        assert pa.get_canonical_term(label) == ja.get_canonical_term(label)
    assert pa.get_canonical_term("CD8+ T cells") == \
        "cd8-positive, alpha-beta t cell"
    assert pa.get_canonical_term("totally mysterious") is None


def test_tokens_and_scores_equal():
    idx = pa.load_ontology_index()
    assert idx == ja.load_ontology_index()
    assert po.BLACKLISTED_CL_IDS == jo.BLACKLISTED_CL_IDS
    assert po.SKIP_LABELS == jo.SKIP_LABELS
    terms = list(idx["cl"])[:60]
    for label in LABELS[:40]:
        tp, tj = (pa.extract_biological_tokens(label),
                  ja.extract_biological_tokens(label))
        assert tp == tj
        s = label.lower()
        for term in terms:
            for pat in (False, True):
                assert po.score_match(s, term, tp, pat) == \
                    jo.score_match(s, term, tj, pat)
    t = pa.extract_biological_tokens("CD4+ memory T cells")
    assert t["markers"] == ["cd4"] and "t" in t["core_words"]
    assert "memory" in t["modifiers"]


@pytest.mark.parametrize("annotation_type", ["cell_type", "pathology"])
def test_search_ontology_index_equal_on_fixture(annotation_type):
    got = pa.search_ontology_index(LABELS, annotation_type=annotation_type)
    want = ja.search_ontology_index(LABELS, annotation_type=annotation_type)
    assert got == want
    assert sum(bool(m) for m in got.values()) > len(LABELS) // 2


def test_search_tiers_and_blacklist():
    res = pa.search_ontology_index(["B cell", "B-cells", "CD8+ cytotoxic T cells",
                                    "hepatocytes", "flux capacitor"])
    assert res["B cell"][0]["id"] == "CL:0000236"
    assert res["B cell"][0]["match_type"] == "tier1_exact"
    assert res["B-cells"][0]["match_type"] == "tier0_pattern"
    assert res["CD8+ cytotoxic T cells"][0]["id"] == "CL:0000625"
    assert res["hepatocytes"][0]["id"] == "CL:0000182"
    assert res["flux capacitor"] == []
    scores = [m["score"] for m in res["hepatocytes"]]
    assert scores == sorted(scores, reverse=True)
    for matches in pa.search_ontology_index(["cell", "native cell"]).values():
        assert all(m["id"] not in pa.BLACKLISTED_CL_IDS for m in matches)


def _labelled_pair(n=600, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.choice(LABELS[:30] + ["Unassigned", "doublet", "flux capacitor"],
                        n)
    native = np.full(n, None, object)
    native[:25] = "CL:9999999"
    a, b = _pair(n, seed)
    for d in (a, b):
        d.obs["cell_type"] = labels
        d.obs["cell_type_ontology_term_id"] = pd.array(native.copy(),
                                                       dtype=object)
    return a, b


@pytest.mark.parametrize("skip_if_exists", [True, False])
def test_add_ontology_ids_equal(tmp_path, skip_if_exists):
    a, b = _labelled_pair()
    _, mj, rj = ja.add_ontology_ids(a, save_mapping=tmp_path / "j",
                                    dataset_name="demo",
                                    skip_if_exists=skip_if_exists)
    _, mp, rp = pa.add_ontology_ids(b, save_mapping=tmp_path / "p",
                                    dataset_name="demo",
                                    skip_if_exists=skip_if_exists)
    assert mp == mj
    for col in ("cell_type_ontology_term_id", "cell_type_ontology_label",
                "cell_type_ontology_tier"):
        assert b.obs[col].astype(object).equals(a.obs[col].astype(object)), col
    np.testing.assert_array_equal(b.obs["cell_type_ontology_score"].to_numpy(),
                                  a.obs["cell_type_ontology_score"].to_numpy())
    pd.testing.assert_frame_equal(rp.table, rj.table)
    assert rp.errors == rj.errors
    assert rp.metadata["summary"] == rj.metadata["summary"]
    assert (tmp_path / "p" / "demo_ontology_mapping.csv").read_text() == \
        (tmp_path / "j" / "demo_ontology_mapping.csv").read_text()


def test_add_ontology_ids_native_and_skipped(tmp_path):
    _, b = _pair(90)
    b.obs["cell_type"] = ["B cells"] * 30 + ["CD8 T cells"] * 30 + \
        ["Unassigned"] * 30
    native = np.full(90, None, object)
    native[:10] = "CL:9999999"
    b.obs["cell_type_ontology_term_id"] = native
    b, mappings, result = pa.add_ontology_ids(b, save_mapping=tmp_path,
                                              dataset_name="demo")
    ids = b.obs["cell_type_ontology_term_id"].to_numpy()
    assert (ids[:10] == "CL:9999999").all()
    assert (ids[10:30] == "CL:0000236").all()
    assert (ids[30:60] == "CL:0000625").all()
    assert (ids[60:] == "skipped").all()
    tiers = b.obs["cell_type_ontology_tier"]
    assert (tiers.iloc[:10] == "native").all()
    assert (tiers.iloc[60:] == "skipped").all()
    assert mappings["B cells"][0]["id"] == "CL:0000236"
    assert (tmp_path / "demo_ontology_mapping_metadata.json").exists()
    assert result.metadata["summary"]["mapped"] == 2


def test_create_mapping_table_and_coverage_equal():
    mappings = pa.search_ontology_index(["B cells", "flux capacitor"])
    args = (mappings, {"B cells": 100, "flux capacitor": 3})
    got = pa.create_mapping_table(*args, skipped_labels=["Unassigned"])
    want = ja.create_mapping_table(*args, skipped_labels=["Unassigned"])
    pd.testing.assert_frame_equal(got.table, want.table)
    assert got.errors == want.errors
    assert got.metadata["tier_breakdown"] == want.metadata["tier_breakdown"]
    a, b = _pair(40)
    assert pa.has_ontology_ids(b) == ja.has_ontology_ids(a)
    ids = ["CL:0000236"] * 10 + [None] * 30
    for d in (a, b):
        d.obs["cell_type_ontology_term_id"] = pd.array(ids, dtype=object)
        d.obs["reference_source"] = ["a"] * 20 + ["b"] * 20
    st = pa.has_ontology_ids(b)
    assert st == ja.has_ontology_ids(a)
    assert st["by_source"] == {"a": 0.5, "b": 0.0}


def _issues(res):
    return [(i.severity, i.message) for i in res.issues]


@pytest.mark.parametrize("column,kw", [
    ("good", {}), ("clusters", {}), ("nully", {}), ("nully", {"allow_nulls": True}),
    ("imbalanced", {"imbalance_warn_ratio": 10.0}), ("missing", {}),
    ("good", {"min_cells_per_type": 200, "max_cell_types": 1}),
])
def test_validate_cell_type_column_equal(column, kw):
    a, b = _pair(300)
    for d in (a, b):
        d.obs["good"] = ["T cell"] * 150 + ["B cell"] * 150
        d.obs["clusters"] = [f"cluster_{i % 5}" for i in range(300)]
        d.obs["nully"] = pd.array(["T cell"] * 200 + [None] * 100, dtype=object)
        d.obs["imbalanced"] = ["T cell"] * 295 + ["B cell"] * 5
    rp = pa.validate_cell_type_column(b, column, **kw)
    rj = ja.validate_cell_type_column(a, column, **kw)
    assert (rp.valid, rp.n_types, rp.n_cells, rp.type_counts) == \
        (rj.valid, rj.n_types, rj.n_cells, rj.type_counts)
    assert _issues(rp) == _issues(rj)
    assert rp.summary() == rj.summary()
    if column == "missing":
        with pytest.raises(ValueError):
            pa.validate_cell_type_column(b, column, raise_on_error=True)


def test_validate_multiple_and_consistency_equal():
    a, b = _pair(60)
    for d in (a, b):
        d.obs["cell_type"] = ["A"] * 30 + ["B"] * 30
        d.obs["cell_type_ontology_term_id"] = ["CL:1"] * 15 + ["CL:2"] * 15 + \
            ["CL:3"] * 30
        d.obs["other"] = [f"c{i % 3}" for i in range(60)]
    assert str(pa.ValidationIssue("info", "x")) == \
        str(ja.ValidationIssue("info", "x")) == "[info] x"
    got = pa.check_label_ontology_consistency(b)
    assert [(i.severity, i.message) for i in got] == \
        [(i.severity, i.message) for i in ja.check_label_ontology_consistency(a)]
    assert any("multiple" in i.message for i in got)
    res_p = pa.validate_multiple_columns(b, ["cell_type", "other"])
    res_j = ja.validate_multiple_columns(a, ["cell_type", "other"])
    assert {k: _issues(v) for k, v in res_p.items()} == \
        {k: _issues(v) for k, v in res_j.items()}
    with pytest.raises(ValueError, match="Validation failed"):
        pa.validate_multiple_columns([b, b], ["cell_type", "other"])
    with pytest.raises(ValueError, match="must match"):
        pa.validate_multiple_columns([b], ["cell_type", "other"])


def test_search_results_are_kept_per_loaded_index(tmp_path):
    """A label searched again in the same loaded index returns a copy of
    its first result (equal to the reference's; a caller's edits do not
    reach the kept one); a re-read index, or one passed in, searches
    afresh."""
    labels = ["B cells", "Macrophages", "flux capacitor"]
    first = pa.search_ontology_index(labels)
    first["B cells"][0]["id"] = "edited"
    again = pa.search_ontology_index(labels)
    assert again == ja.search_ontology_index(labels)
    assert again["B cells"][0]["id"] == "CL:0000236"
    idx = {"metadata": {}, "cl": {"b cell": {"id": "CL:0000999",
                                             "name": "B cell"}}}
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(idx))
    assert pa.search_ontology_index(["B cell"], index_path=path)[
        "B cell"][0]["id"] == "CL:0000999"
    idx["cl"]["b cell"]["id"] = "CL:0000998"
    path.write_text(json.dumps(idx))
    pa.load_ontology_index(path, use_cache=False)
    assert pa.search_ontology_index(["B cell"], index_path=path)[
        "B cell"][0]["id"] == "CL:0000998"
    assert pa.search_ontology_index(["B cell"], ontology_index=idx)[
        "B cell"][0]["id"] == "CL:0000998"
