"""Cell-type label column validation.

Port of ``spatialcore_tpu/annotation/validation.py`` (host pandas, so a
copy): ``validate_cell_type_column`` (existence, null fraction, label
cardinality, per-type minimums, suspicious cluster-id patterns,
imbalance), ``check_label_ontology_consistency`` and
``validate_multiple_columns``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List

from ..core.compat import param_aliases
from ..core.logging import get_logger

logger = get_logger("annotation.validation")

SUSPICIOUS_PATTERNS = [
    (re.compile(r"^(cluster|c)[\s_\-]?\d+$", re.IGNORECASE), "cluster id"),
    (re.compile(r"^(leiden|louvain)[\s_\-]?\d*$", re.IGNORECASE),
     "clustering-algorithm label"),
    (re.compile(r"^\d+$"), "numeric-only label"),
]


@dataclass
class ValidationIssue:
    severity: str           # "error" | "warning" | "info"
    message: str

    def __str__(self):
        return f"[{self.severity}] {self.message}"


@dataclass
class CellTypeValidationResult:
    column: str
    valid: bool
    n_types: int
    n_cells: int
    issues: List[ValidationIssue] = field(default_factory=list)
    type_counts: Dict[str, int] = field(default_factory=dict)

    @property
    def errors(self) -> List[ValidationIssue]:
        return [i for i in self.issues if i.severity == "error"]

    @property
    def warnings(self) -> List[ValidationIssue]:
        return [i for i in self.issues if i.severity == "warning"]

    def summary(self) -> str:
        lines = [f"Column '{self.column}': "
                 f"{'OK' if self.valid else 'INVALID'} "
                 f"({self.n_types} types, {self.n_cells:,} cells)"]
        lines += [f"  {i}" for i in self.issues]
        return "\n".join(lines)


@param_aliases(min_types="min_cell_types", max_types="max_cell_types")
def validate_cell_type_column(
    adata,
    column: str = "cell_type",
    min_cells_per_type: int = 10,
    max_cell_types: int = 500,
    min_cell_types: int = 1,
    allow_nulls: bool = False,
    max_null_fraction: float = 0.05,
    check_suspicious_patterns: bool = True,
    imbalance_warn_ratio: float = 1000.0,
    raise_on_error: bool = False,
) -> CellTypeValidationResult:
    """Validate a label column for use as training/annotation ground truth.

    ``allow_nulls`` downgrades any null fraction to informational;
    ``check_suspicious_patterns`` toggles the cluster-id heuristics.
    """
    issues: List[ValidationIssue] = []
    if column not in adata.obs.columns:
        res = CellTypeValidationResult(
            column=column, valid=False, n_types=0, n_cells=adata.n_obs,
            issues=[ValidationIssue(
                "error", f"Column '{column}' not found in adata.obs")])
        if raise_on_error:
            raise ValueError(res.summary())
        return res

    series = adata.obs[column]
    null_frac = float(series.isna().mean())
    if null_frac > max_null_fraction and not allow_nulls:
        issues.append(ValidationIssue(
            "error", f"{null_frac:.1%} null labels "
            f"(> {max_null_fraction:.0%} allowed)"))
    elif null_frac > 0:
        issues.append(ValidationIssue(
            "info", f"{null_frac:.2%} null labels"))

    labels = series.dropna().astype(str)
    counts = labels.value_counts()
    n_types = len(counts)
    if n_types < min_cell_types:
        issues.append(ValidationIssue(
            "error", f"Only {n_types} cell types (min {min_cell_types})"))
    if n_types > max_cell_types:
        issues.append(ValidationIssue(
            "error", f"{n_types} cell types exceeds {max_cell_types} — is "
            "this a cluster column?"))

    small = counts[counts < min_cells_per_type]
    if len(small):
        issues.append(ValidationIssue(
            "warning", f"{len(small)} types below {min_cells_per_type} "
            f"cells: {sorted(small.index)[:5]}"))

    suspicious = []
    if check_suspicious_patterns:
        for lab in counts.index:
            for pat, why in SUSPICIOUS_PATTERNS:
                if pat.match(lab):
                    suspicious.append((lab, why))
                    break
    if suspicious:
        frac = len(suspicious) / n_types
        sev = "error" if frac > 0.5 else "warning"
        issues.append(ValidationIssue(
            sev, f"{len(suspicious)}/{n_types} labels look like cluster ids "
            f"({suspicious[0][0]!r}: {suspicious[0][1]}); cell-type NAMES "
            "are required"))

    if n_types >= 2 and counts.iloc[-1] > 0:
        ratio = counts.iloc[0] / counts.iloc[-1]
        if ratio > imbalance_warn_ratio:
            issues.append(ValidationIssue(
                "warning", f"Extreme imbalance: largest/smallest type "
                f"ratio {ratio:.0f}x"))

    valid = not any(i.severity == "error" for i in issues)
    res = CellTypeValidationResult(
        column=column, valid=valid, n_types=n_types, n_cells=adata.n_obs,
        issues=issues, type_counts=counts.to_dict())
    if not valid and raise_on_error:
        raise ValueError(res.summary())
    for i in issues:
        (logger.error if i.severity == "error" else logger.warning
         if i.severity == "warning" else logger.info)(f"{column}: {i.message}")
    return res


def check_label_ontology_consistency(
    adata,
    label_column: str = "cell_type",
    ontology_column: str = "cell_type_ontology_term_id",
    detect_hierarchy: bool = True,
) -> List[ValidationIssue]:
    """Flag labels mapped to multiple IDs and IDs shared by many labels.

    ``detect_hierarchy`` toggles the informational shared-ID check.
    """
    issues: List[ValidationIssue] = []
    if ontology_column not in adata.obs.columns:
        return [ValidationIssue(
            "info", f"No ontology column '{ontology_column}' to check")]
    df = adata.obs[[label_column, ontology_column]].dropna().astype(str)
    per_label = df.groupby(label_column)[ontology_column].nunique()
    multi = per_label[per_label > 1]
    if len(multi):
        issues.append(ValidationIssue(
            "warning", f"{len(multi)} labels map to multiple ontology IDs: "
            f"{sorted(multi.index)[:5]}"))
    if detect_hierarchy:
        per_id = df.groupby(ontology_column)[label_column].nunique()
        coarse = per_id[per_id > 3]
        if len(coarse):
            issues.append(ValidationIssue(
                "info", f"{len(coarse)} ontology IDs cover >3 distinct "
                "labels (hierarchical collapsing)"))
    return issues


@param_aliases(adata="adatas")
def validate_multiple_columns(
    adatas,
    columns: List[str],
    raise_on_error: bool = True,
    **kwargs,
):
    """Validate label columns across several references before combining.

    ``adatas`` a list paired with per-reference ``columns``: returns a list
    of results and raises when any reference has errors
    (``raise_on_error``). Passing a single container instead validates each
    of ``columns`` on it and returns a ``{column: result}`` dict (never
    raising unless asked through kwargs).
    """
    if not isinstance(adatas, (list, tuple)):
        return {c: validate_cell_type_column(adatas, c, **kwargs)
                for c in columns}
    if len(adatas) != len(columns):
        raise ValueError(
            f"Number of adatas ({len(adatas)}) must match columns "
            f"({len(columns)})")
    results = [validate_cell_type_column(a, c, **kwargs)
               for a, c in zip(adatas, columns)]
    failed = [r for r in results if r.errors]
    if failed and raise_on_error:
        raise ValueError(
            f"Validation failed for {len(failed)} reference(s):\n"
            + "\n".join(f"{r.column}: {e.message}"
                        for r in failed for e in r.errors))
    return results
