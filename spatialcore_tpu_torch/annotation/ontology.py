"""Label → Cell Ontology ID mapping: a four-tier fuzzy matcher and
``add_ontology_ids``.

Port of ``spatialcore_tpu/annotation/ontology.py`` (string work on the
host, so a copy): the biological tokenizer, the tiered scorer (exact →
symbol-stripped → word-boundary containment → token match with penalties
and bonuses → Jaccard), ``search_ontology_index`` (per-label sorted match
lists with ``tier0_pattern`` / ``tier1_exact`` / ``tier2_token`` /
``tier3_overlap`` types, ID-deduplicated), ``create_mapping_table``
returning an ``OntologyMappingResult`` (table, metadata, errors), and
``add_ontology_ids`` returning ``(adata, mappings, result)`` with
``skip_if_exists`` keeping native IDs, the ``SKIP_LABELS`` placeholders
and ``{...}_tier`` / ``{...}_score`` provenance columns. The bundled index
(``data/ontology/cl_index.json``) is the reference's file; a full
CL / NCIT / UBERON export can be passed as ``index_path`` and chosen with
``annotation_type``. ``add_ontology_ids`` searches each unique label once
and writes the rows through the labels' categorical codes, so its cost
grows with the number of labels, not of cells; ``search_ontology_index``
keeps each label's result for the loaded index, so a label searched again
(the pipeline maps its training labels, then the same labels predicted)
costs a copy.
"""

from __future__ import annotations

import copy
import json
import re
from dataclasses import dataclass, field
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import pandas as pd

from ..core.compat import param_aliases
from ..core.logging import get_logger
from ..core.metadata import update_metadata
from .patterns import get_canonical_term

logger = get_logger("annotation.ontology")

_BUILTIN_INDEX = Path(__file__).parent.parent / "data" / "ontology" / \
    "cl_index.json"

GENERIC_TERMS = {"cell", "cells", "type", "like"}

BLACKLISTED_CL_IDS = {"CL:0000000", "CL:0000003", "CL:0000255"}

MODIFIER_TERMS = {
    "positive", "negative", "high", "low", "like", "type", "mature",
    "immature", "activated", "resting", "proliferating", "pro", "pre",
    "post", "inflammatory", "naive", "memory", "effector", "resident",
    "circulating",
}

MEANINGFUL_SHORT_TOKENS = {
    "b", "t", "nk", "dc", "ec", "ve", "ta", "m1", "m2", "cd", "th", "ilc",
}

# Placeholder labels that should never be ontology-mapped.
SKIP_LABELS = {
    "unassigned", "unknown", "doublet", "multiplet", "na", "n/a", "nan",
    "none", "other", "ambiguous", "low quality", "filtered",
}

_INDEX_CACHE: Dict[str, Dict] = {}
#: search results by (index path, annotation type, min_score, label), for
#: searches of an index that ``load_ontology_index`` holds; a re-read of
#: that index drops its entries
_SEARCH_CACHE: Dict[Tuple[str, str, float, str], List[Dict]] = {}

UNKNOWN_CELL_TYPE_ID = "unknown"
UNKNOWN_CELL_TYPE_NAME = "Unknown"


@dataclass
class OntologyMappingResult:
    """Structured output of a mapping run: table + metadata + errors.

    ``table`` columns: input_label, ontology_name, ontology_id, match_tier,
    score, n_cells, canonical_term.
    """

    table: pd.DataFrame
    metadata: Dict[str, Any] = field(default_factory=dict)
    errors: List[Dict[str, Any]] = field(default_factory=list)

    def to_json(self, path: Union[str, Path]) -> Path:
        """Write the metadata dict as JSON; returns the path."""
        path = Path(path)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.metadata, f, indent=2, default=str)
        return path

    def to_csv(self, path: Union[str, Path]) -> Path:
        """Write the mapping table as CSV; returns the path."""
        path = Path(path)
        self.table.to_csv(path, index=False)
        return path


@param_aliases(path="index_path")
def load_ontology_index(
    index_path: Optional[Union[str, Path]] = None,
    use_cache: bool = True,
) -> Dict:
    """Load the ontology index: {"metadata", "cl": {label: {id, name}}, …}.

    ``use_cache=False`` forces a re-read (the cache is keyed per path, so
    distinct ``index_path`` values never collide).
    """
    index_path = Path(index_path) if index_path else _BUILTIN_INDEX
    key = str(index_path)
    if not use_cache:
        _INDEX_CACHE.pop(key, None)
    if key not in _INDEX_CACHE:
        for k in [k for k in _SEARCH_CACHE if k[0] == key]:
            del _SEARCH_CACHE[k]
        with open(index_path) as f:
            idx = json.load(f)
        if "cl" not in idx:
            raise ValueError(f"Ontology index {index_path} has no 'cl' "
                             "section")
        _INDEX_CACHE[key] = idx
        logger.info(f"Loaded ontology index: {len(idx['cl']):,} CL terms "
                    f"({index_path.name})")
    return _INDEX_CACHE[key]


def extract_biological_tokens(label: str) -> Dict[str, List[str]]:
    """Split a label into CD markers, protein names, core words, modifiers."""
    low = str(label).lower().strip()
    tokens = {"markers": [], "proteins": [], "core_words": [], "modifiers": []}
    tokens["markers"] = re.findall(r"cd\d+", low)
    tokens["proteins"] = [m.lower() for m in re.findall(r"ig[gamed]", low)]
    tokens["proteins"] += [m[:-1].lower()
                           for m in re.findall(r"\b[A-Z0-9]{3,}\+", str(label))]
    cleaned = re.sub(r"cd\d+|ig[gamed]", "", low)
    cleaned = re.sub(r"[+\-]", " ", cleaned)
    cleaned = re.sub(r"\d+", "", cleaned)
    for word in re.sub(r"\s+", " ", cleaned).strip().split():
        if word in MODIFIER_TERMS:
            tokens["modifiers"].append(word)
        elif word in GENERIC_TERMS:
            continue
        elif word in MEANINGFUL_SHORT_TOKENS or len(word) > 1:
            tokens["core_words"].append(word)
    return tokens


def _strip_symbols(s: str) -> str:
    return re.sub(r"\s+", " ", re.sub(r"[+\-,]", " ", s)).strip()


def score_match(search_label: str, term_label: str,
                tokens: Dict[str, List[str]],
                is_pattern_match: bool) -> float:
    """Tiered similarity in [0, 1] between a query label and a CL term."""
    s = search_label.lower().strip()
    t = term_label.lower().strip()
    if s == t:                                    # tier 1: exact
        return 0.95 if is_pattern_match else 1.0
    if _strip_symbols(s) == _strip_symbols(t):    # tier 1b: symbols stripped
        return 0.92 if is_pattern_match else 0.95
    if len(s) >= 4:                               # tier 1c: word-boundary ⊂
        if re.search(rf"\b{re.escape(s)}\b", t):
            return 0.88 if is_pattern_match else 0.90
        if re.search(rf"\b{re.escape(t)}\b", s):
            return 0.86 if is_pattern_match else 0.88

    term_words = set(t.replace("-", " ").replace(",", " ").split())
    core = tokens.get("core_words", [])
    if core and all(w in term_words for w in core):   # tier 2: all core words
        score = 0.70
        if len(core) == 1 and len(core[0]) <= 2:
            score -= 0.15                 # single short token is ambiguous
        bad_prefixes = ("pro", "pre", "post", "immature", "ecto", "endo")
        if any(p in t for p in bad_prefixes) and \
                not any(p in s for p in bad_prefixes):
            score -= 0.15                 # term is a precursor, label isn't
        if tokens.get("markers") and any(m in t for m in tokens["markers"]):
            score = max(score, 0.75)
        if len(core) >= 2:
            score = min(score + 0.05, 0.85)
        return max(score, 0.0)

    label_words = set(s.replace("-", " ").replace(",", " ").split())
    label_words -= GENERIC_TERMS
    if label_words and term_words and (label_words & term_words):
        # tier 3: Jaccard — requires at least one shared word (a zero-overlap
        # pair must score 0, not the formula's 0.5 floor)
        jac = len(label_words & term_words) / len(label_words | term_words)
        return 0.5 + 0.4 * jac
    return 0.0


def ontology_provenance_columns(target_col: str) -> Tuple[str, str]:
    """(tier_col, score_col) names derived from the ID column name.

    "…_term_id" → "…_tier"/"…_score", else "…_id" → same, else suffixes —
    the reference's convention.
    """
    if "_term_id" in target_col:
        return (target_col.replace("_term_id", "_tier"),
                target_col.replace("_term_id", "_score"))
    if target_col.endswith("_id"):
        return target_col[:-3] + "_tier", target_col[:-3] + "_score"
    return target_col + "_tier", target_col + "_score"


_ANNOTATION_ONTOLOGIES = {
    "cell_type": ["cl"],
    "pathology": ["ncit", "cl"],
    "anatomy": ["uberon", "cl"],
}


def search_ontology_index(
    labels: List[str],
    ontology_index: Optional[Dict] = None,
    index_path: Optional[Union[str, Path]] = None,
    annotation_type: str = "cell_type",
    min_score: float = 0.7,
) -> Dict[str, List[Dict]]:
    """Sorted ontology matches per label: {label: [{id, name, ontology,
    score, match_type}, …]}.

    Tier 0 first canonicalizes via the pattern table; scoring then runs the
    canonicalized and the raw label against every index term. Matches are
    ID-deduplicated and sorted by descending score; blacklisted root terms
    are never returned. ``annotation_type`` selects which ontology sections
    to search ("cell_type" → CL; "pathology" → NCIT then CL; "anatomy" →
    UBERON then CL; anything else → all three); sections absent from the
    index are skipped. A CL match ≥0.8 stops the fallback to other
    ontologies. A label searched before in the same loaded index (not one
    passed as ``ontology_index``) returns a copy of its earlier result.
    """
    index = ontology_index or load_ontology_index(index_path)
    index_key = None if ontology_index else str(
        Path(index_path) if index_path else _BUILTIN_INDEX)
    ontologies = _ANNOTATION_ONTOLOGIES.get(
        annotation_type, ["cl", "ncit", "uberon"])
    out: Dict[str, List[Dict]] = {}
    for label in labels:
        key = (index_key, annotation_type, min_score, str(label))
        if index_key is not None and key in _SEARCH_CACHE:
            out[label] = copy.deepcopy(_SEARCH_CACHE[key])
            continue
        raw = str(label).strip().replace("_", " ")
        candidates = [(raw.lower(), False)]
        canonical = get_canonical_term(raw)
        if canonical:
            candidates.insert(0, (canonical, True))
        matches: List[Dict] = []
        for onto in ontologies:
            section = index.get(onto)
            if not section:
                continue
            prefix = onto.upper()
            for search, is_pattern in candidates:
                tokens = extract_biological_tokens(search)
                hit = section.get(search)
                if hit and hit["id"] not in BLACKLISTED_CL_IDS:
                    matches.append({
                        "id": hit["id"], "name": hit["name"],
                        "ontology": onto,
                        "score": 0.95 if is_pattern else 1.0,
                        "match_type": ("tier0_pattern" if is_pattern
                                       else "tier1_exact"),
                    })
                    continue
                for term_label, term in section.items():
                    # fuzzy phase searches proper, current terms only —
                    # full releases carry imported GO/UBERON/PR terms and
                    # obsolete labels
                    if not term["id"].startswith(prefix + ":"):
                        continue
                    if term["id"] in BLACKLISTED_CL_IDS:
                        continue
                    if "obsolete" in term["name"].lower():
                        continue
                    sc = score_match(search, term_label, tokens, is_pattern)
                    if sc >= min_score:
                        matches.append({
                            "id": term["id"], "name": term["name"],
                            "ontology": onto, "score": sc,
                            "match_type": ("tier0_pattern" if is_pattern
                                           else "tier2_token" if sc >= 0.7
                                           else "tier3_overlap"),
                        })
            if onto == "cl" and any(m["score"] >= 0.8 for m in matches):
                break  # good CL hit — skip fallback ontologies
        seen: set = set()
        unique: List[Dict] = []
        for m in sorted(matches, key=lambda m: m["score"], reverse=True):
            if m["id"] not in seen:
                seen.add(m["id"])
                unique.append(m)
        out[label] = unique
        if index_key is not None:
            _SEARCH_CACHE[key] = copy.deepcopy(unique)
    return out


def create_mapping_table(
    mappings: Dict[str, List[Dict]],
    cell_counts: Dict[str, int],
    skipped_labels: Optional[List[str]] = None,
    index_source: Optional[str] = None,
    min_score: float = 0.7,
    dataset_name: str = "ontology_mapping",
) -> OntologyMappingResult:
    """Structure search results into a table + JSON-ready metadata.

    One row per input label (mapped, unmapped, and skipped); tier counts
    and match rate in ``metadata``.
    """
    skipped_labels = list(skipped_labels or [])
    rows: List[Dict] = []
    errors: List[Dict] = []
    tier_counts = {"tier0_pattern": 0, "tier1_exact": 0, "tier2_token": 0,
                   "tier3_overlap": 0, "unmapped": 0, "skipped": 0}

    for label, matches in mappings.items():
        n_cells = int(cell_counts.get(label, 0))
        canonical = get_canonical_term(label)
        if matches:
            best = matches[0]
            tier = best.get("match_type", "unknown")
            tier_counts[tier] = tier_counts.get(tier, 0) + 1
            rows.append({
                "input_label": label,
                "ontology_name": best["name"],
                "ontology_id": best["id"],
                "match_tier": tier,
                "score": round(float(best["score"]), 3),
                "n_cells": n_cells,
                "canonical_term": canonical,
            })
        else:
            tier_counts["unmapped"] += 1
            errors.append({"label": label, "n_cells": n_cells,
                           "issue": "no match above min_score"})
            rows.append({
                "input_label": label,
                "ontology_name": UNKNOWN_CELL_TYPE_NAME,
                "ontology_id": UNKNOWN_CELL_TYPE_ID,
                "match_tier": "unmapped",
                "score": 0.0,
                "n_cells": n_cells,
                "canonical_term": canonical,
            })
    for label in skipped_labels:
        tier_counts["skipped"] += 1
        rows.append({
            "input_label": label, "ontology_name": label,
            "ontology_id": "skipped", "match_tier": "skipped",
            "score": None, "n_cells": int(cell_counts.get(label, 0)),
            "canonical_term": None,
        })

    table = pd.DataFrame(
        rows, columns=["input_label", "ontology_name", "ontology_id",
                       "match_tier", "score", "n_cells", "canonical_term"])
    n_mapped = sum(1 for r in rows if r["match_tier"] not in
                   ("unmapped", "skipped"))
    metadata = {
        "dataset": dataset_name,
        "created_at": datetime.now().isoformat(),
        "index_source": index_source,
        "min_score": min_score,
        "summary": {
            "total_labels": len(mappings) + len(skipped_labels),
            "mapped": n_mapped,
            "unmapped": tier_counts["unmapped"],
            "skipped": tier_counts["skipped"],
            "match_rate": (round(n_mapped / len(mappings), 3)
                           if mappings else 0.0),
        },
        "tier_breakdown": tier_counts,
        "mappings": [r for r in rows if r["match_tier"] != "skipped"],
    }
    return OntologyMappingResult(table=table, metadata=metadata,
                                 errors=errors)


@param_aliases(cell_type_column="source_col", target_column="target_col",
               name_column="name_col", mapping_output="save_mapping")
def add_ontology_ids(
    adata,
    source_col: str = "cell_type",
    target_col: str = "cell_type_ontology_term_id",
    name_col: Optional[str] = "cell_type_ontology_label",
    min_score: float = 0.7,
    index_path: Optional[Union[str, Path]] = None,
    save_mapping: Optional[Union[str, Path]] = None,
    dataset_name: Optional[str] = None,
    skip_labels: Optional[set] = None,
    skip_if_exists: bool = True,
    copy: bool = False,
) -> Tuple[Any, Dict[str, List[Dict]], Optional[OntologyMappingResult]]:
    """Fill CL IDs for every label in ``source_col``.

    Returns ``(adata, mappings, result)`` — the mapping dict straight from
    ``search_ontology_index`` and, when ``save_mapping`` (a directory) is
    given, an ``OntologyMappingResult`` whose table/metadata are also
    written as ``{dataset_name}_ontology_mapping.csv`` / ``…_metadata.json``.
    ``skip_if_exists`` keeps rows whose
    ``target_col`` already carries a CURIE (native CellxGene annotations
    win, tier "native"). Unmapped labels get id ``"unknown"``, skipped
    placeholder labels get ``"skipped"``. Writes ``*_tier`` / ``*_score``
    provenance columns (named by replacing ``_term_id``/``_id``).
    """
    if copy:
        adata = adata.copy()
    if source_col not in adata.obs.columns:
        raise ValueError(f"Column '{source_col}' not found in obs")
    skip = {s.lower() for s in (skip_labels if skip_labels is not None
                                else SKIP_LABELS)}

    labels = adata.obs[source_col].astype(str)
    unique = labels.unique().tolist()
    skipped = [l for l in unique if l.strip().lower() in skip]
    to_map = [l for l in unique if l.strip().lower() not in skip]
    mappings = search_ontology_index(to_map, index_path=index_path,
                                     annotation_type="cell_type",
                                     min_score=min_score)
    n_hit = sum(1 for m in mappings.values() if m)
    logger.info(f"add_ontology_ids: matched {n_hit}/{len(to_map)} labels "
                f"(min_score={min_score})")

    existing = None
    if skip_if_exists and target_col in adata.obs.columns:
        existing = adata.obs[target_col].astype(str)
        has_native = existing.str.match(r"^[A-Z]+:[0-9]+$", na=False)
    else:
        has_native = pd.Series(False, index=adata.obs.index)

    # one entry per unique label, broadcast to the rows by their codes
    codes = pd.Categorical(labels, categories=unique).codes
    per_label = {}
    for label, matches in mappings.items():
        if matches:
            best = matches[0]
            per_label[label] = (best["id"], best["name"],
                                best.get("match_type", "unknown"),
                                round(float(best["score"]), 3))
        else:
            per_label[label] = (UNKNOWN_CELL_TYPE_ID, UNKNOWN_CELL_TYPE_NAME,
                                "unmapped", 0.0)
    for label in skipped:
        per_label[label] = ("skipped", label, "skipped", np.nan)
    table = [per_label[label] for label in unique]
    ids = np.array([t[0] for t in table], object)[codes]
    names = np.array([t[1] for t in table], object)[codes]
    tiers = np.array([t[2] for t in table], object)[codes]
    scores = np.array([t[3] for t in table], float)[codes]
    native_rows = has_native.to_numpy()
    if native_rows.any():
        ids[native_rows] = existing[native_rows]
        tiers[native_rows] = "native"
        scores[native_rows] = 1.0
        logger.info(f"  kept {int(native_rows.sum()):,} native IDs "
                    "(skip_if_exists)")

    adata.obs[target_col] = pd.array(ids, dtype=object)
    if name_col:
        adata.obs[name_col] = pd.array(names, dtype=object)
    tier_col, score_col = ontology_provenance_columns(target_col)
    adata.obs[tier_col] = pd.array(tiers, dtype=object)
    adata.obs[score_col] = scores

    result: Optional[OntologyMappingResult] = None
    if save_mapping:
        save_dir = Path(save_mapping)
        save_dir.mkdir(parents=True, exist_ok=True)
        cell_counts = labels.value_counts().to_dict()
        name = dataset_name or "ontology_mapping"
        result = create_mapping_table(
            mappings=mappings, cell_counts=cell_counts,
            skipped_labels=skipped,
            index_source=str(index_path) if index_path else None,
            min_score=min_score, dataset_name=name)
        result.to_csv(save_dir / f"{name}_ontology_mapping.csv")
        result.to_json(save_dir / f"{name}_ontology_mapping_metadata.json")
        logger.info(f"  wrote mapping artifacts → {save_dir}")

    update_metadata(
        adata, "add_ontology_ids",
        parameters={"source_col": source_col,
                    "target_col": target_col,
                    "min_score": min_score,
                    "skip_if_exists": skip_if_exists,
                    "n_labels_matched": n_hit,
                    "n_labels_total": len(to_map)},
        outputs={"obs": [target_col, tier_col, score_col]})
    return adata, mappings, result


@param_aliases(column="id_col")
def has_ontology_ids(
    adata,
    id_col: str = "cell_type_ontology_term_id",
    label_col: str = "cell_type",
) -> Dict[str, Any]:
    """Existing-ID coverage report: decide whether harmonization is needed.

    Returns {has_column, coverage, n_with_ids, n_without_ids, unique_ids,
    by_source} — ``by_source`` is per-``reference_source`` coverage when
    that obs column exists. ``label_col`` is accepted for signature parity
    and unused.
    """
    del label_col  # signature parity: reserved, unused
    result: Dict[str, Any] = {
        "has_column": False, "coverage": 0.0, "n_with_ids": 0,
        "n_without_ids": int(adata.n_obs), "unique_ids": [],
        "by_source": {},
    }
    if id_col not in adata.obs.columns:
        logger.info(f"Column '{id_col}' not found in adata.obs")
        return result
    result["has_column"] = True
    ids = adata.obs[id_col]
    valid = ids.notna() & ids.astype(str).str.match(r"^CL:[0-9]+$")
    result["n_with_ids"] = int(valid.sum())
    result["n_without_ids"] = int((~valid).sum())
    result["coverage"] = (result["n_with_ids"] / adata.n_obs
                          if adata.n_obs else 0.0)
    result["unique_ids"] = ids[valid].unique().tolist()
    if "reference_source" in adata.obs.columns:
        for source, grp in valid.groupby(
                adata.obs["reference_source"], observed=True):
            result["by_source"][str(source)] = float(grp.mean())
    return result
