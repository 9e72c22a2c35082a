"""End-to-end annotation pipeline: references → model → annotated cells.

Port of ``spatialcore_tpu/annotation/pipeline.py``: ``train_and_annotate``
and its stages — panel genes → combine references → ontology IDs →
balanced subsample → train (on ``device``) → annotate (on ``device``) →
map prediction IDs → QC plots → confidence threshold (applied after
plotting so figures show all cells) → the optional quality benchmark — and
``TrainingConfig``, the YAML dataclass. ``device`` is a keyword of the two
entry points, not a config field, so a YAML written by either package
loads in the other. The plotting module is not ported yet: with
``make_plots`` and an ``output_dir`` the plot stage warns and the pipeline
goes on, as it does when plots fail. ``yaml`` is imported inside the calls
that read or write a config.
"""

from __future__ import annotations

import time
from dataclasses import asdict, dataclass, field, fields
from pathlib import Path
from typing import List, Optional, Sequence, Union

import torch

from ..core.logging import get_logger
from ..core.metadata import update_metadata
from .annotate import annotate_cells
from .confidence import filter_low_confidence
from .ontology import add_ontology_ids
from .training import (
    combine_references, ensure_normalized, save_model_artifacts,
    subsample_balanced, train_cell_type_model)
from .validation import validate_cell_type_column

logger = get_logger("annotation.pipeline")

Device = Union[str, torch.device]


@dataclass
class TrainingConfig:
    """Configuration for train_and_annotate (YAML-roundtrippable)."""

    references: List[str] = field(default_factory=list)
    cell_type_column: str = "cell_type"
    max_cells_per_reference: Optional[int] = None
    max_cells_per_type: int = 5000
    min_cells_per_source: int = 50
    min_cells_per_type: int = 10
    exclude_labels: Optional[List[str]] = None
    epochs: int = 30
    batch_size: int = 1024
    learning_rate: float = 0.05
    l2: float = 1e-4
    balance_cell_type: bool = True
    confidence_method: str = "zscore"
    confidence_threshold: float = 0.8
    model_name: str = "spatialcore_tpu_model"
    output_dir: Optional[str] = None
    seed: int = 0
    make_plots: bool = True
    compute_benchmark: bool = False  # 7-metric quality table in uns

    def validate(self) -> None:
        if not self.references:
            raise ValueError("TrainingConfig.references must be non-empty")
        if not (0.0 <= self.confidence_threshold <= 1.0):
            raise ValueError("confidence_threshold must be in [0, 1]")
        if self.epochs < 1 or self.batch_size < 1:
            raise ValueError("epochs and batch_size must be >= 1")
        if self.confidence_method not in ("raw", "zscore", "softmax",
                                          "minmax"):
            raise ValueError(
                f"Unknown confidence_method '{self.confidence_method}'")

    @classmethod
    def from_yaml(cls, path: Union[str, Path]) -> "TrainingConfig":
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f) or {}
        cfg = cls(**data)
        cfg.validate()
        return cfg

    def to_yaml(self, path: Union[str, Path]) -> Path:
        import yaml

        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            yaml.safe_dump(asdict(self), f, sort_keys=False)
        return path


def train_and_annotate(
    adata,
    references: Optional[Sequence] = None,
    config: Optional[TrainingConfig] = None,
    copy: bool = False,
    device: Device = "cuda",
    **overrides,
):
    """Train a panel-specific classifier on references and annotate adata,
    training and scoring on ``device``.

    Stages:
      1. panel genes = adata.var_names
      2. combine_references (panel subset, re-normalize, label filters)
      3. add_ontology_ids on the training labels (skip_if_exists)
      4. subsample_balanced grouped by CL ID
      5. train_cell_type_model (the LR, on ``device``)
      6. ensure_normalized + annotate_cells
      7. add_ontology_ids on the predictions
      8. QC plots (before thresholding, so figures show all cells)
      9. confidence threshold → "Unassigned"; uns provenance
    """
    start = time.time()
    if copy:
        adata = adata.copy()
    if config is None:
        config = TrainingConfig(references=list(references or []))
    for k, v in overrides.items():
        if not hasattr(config, k):
            raise ValueError(f"Unknown config field '{k}'")
        setattr(config, k, v)
    if references is not None:
        config.references = list(references)
    config.validate()

    out_dir = Path(config.output_dir) if config.output_dir else None

    # S1: panel genes
    panel_genes = list(adata.var_names)
    logger.info(f"Stage 1: panel has {len(panel_genes)} genes")

    # S2: combine references
    logger.info("Stage 2: combining references")
    combined = combine_references(
        config.references,
        cell_type_column=config.cell_type_column,
        panel_genes=panel_genes,
        max_cells_per_reference=config.max_cells_per_reference,
        exclude_labels=config.exclude_labels,
        min_cells_per_type=config.min_cells_per_type,
        seed=config.seed)
    validate_cell_type_column(combined, config.cell_type_column,
                              raise_on_error=True)

    # S3: ontology IDs on training labels
    logger.info("Stage 3: mapping training labels to CL IDs")
    combined, _, _ = add_ontology_ids(
        combined, source_col=config.cell_type_column,
        skip_if_exists=True)

    # S4: balanced subsample grouped by CL ID
    logger.info("Stage 4: Cap & Fill balancing")
    mapped_any = (combined.obs["cell_type_ontology_term_id"].astype(str)
                  .str.match(r"^CL:[0-9]+$").any())
    group_col = ("cell_type_ontology_term_id" if mapped_any
                 else config.cell_type_column)
    combined = subsample_balanced(
        combined, cell_type_column=config.cell_type_column,
        max_cells_per_type=config.max_cells_per_type,
        min_cells_per_source=config.min_cells_per_source,
        group_by_column=group_col, seed=config.seed)

    # S5: train
    logger.info("Stage 5: training classifier")
    model = train_cell_type_model(
        combined, cell_type_column=config.cell_type_column,
        epochs=config.epochs, batch_size=config.batch_size,
        learning_rate=config.learning_rate, l2=config.l2,
        balance_cell_type=config.balance_cell_type, seed=config.seed,
        model_name=config.model_name, device=device)
    artifacts = {}
    if out_dir:
        artifacts = {k: str(v) for k, v in
                     save_model_artifacts(model, out_dir).items()}

    # S6: annotate the query
    logger.info("Stage 6: annotating query cells")
    ensure_normalized(adata)
    adata = annotate_cells(adata, model,
                           confidence_method=config.confidence_method,
                           device=device)

    # S7: ontology IDs on predictions
    logger.info("Stage 7: mapping predictions to CL IDs")
    adata, _, _ = add_ontology_ids(adata, source_col="cell_type",
                                   skip_if_exists=False)

    # S8: QC plots (before thresholding so figures show all cells)
    if config.make_plots and out_dir:
        logger.info("Stage 8: QC plots")
        # plots must never kill the pipeline
        logger.warning("QC plot generation skipped: the plotting module is "
                       "not ported yet (ROADMAP Queue 1 item 14d)")

    # S9: confidence threshold
    logger.info("Stage 9: confidence thresholding")
    adata = filter_low_confidence(
        adata, threshold=config.confidence_threshold)

    # S10 (optional): the seven-metric quality table over the final
    # labels (annotation/benchmark.py)
    if config.compute_benchmark:
        logger.info("Stage 10: annotation quality benchmark")
        try:
            from .benchmark import benchmark_annotation

            benchmark_annotation(
                adata, "cell_type", model_genes=model.genes,
                confidence_column="cell_type_confidence",
                confidence_threshold=config.confidence_threshold,
                device=device)
        except Exception as e:  # metrics must never kill the pipeline
            logger.warning(f"quality benchmark failed: {e}")

    n_unassigned = int((adata.obs["cell_type"] == "Unassigned").sum())
    adata.uns["spatialcore_annotation"] = {
        "model_name": config.model_name,
        "n_training_cells": model.metadata.get("n_training_cells"),
        "n_types": model.n_classes,
        "classes": model.classes,
        "confidence_method": config.confidence_method,
        "confidence_threshold": config.confidence_threshold,
        "n_unassigned": n_unassigned,
        "unassigned_pct": round(100.0 * n_unassigned / adata.n_obs, 3),
        "artifacts": artifacts,
        "elapsed_seconds": round(time.time() - start, 1),
    }
    logger.info(
        f"train_and_annotate done in {time.time() - start:.1f}s — "
        f"{n_unassigned:,}/{adata.n_obs:,} unassigned "
        f"({100 * n_unassigned / adata.n_obs:.2f}%)")
    update_metadata(
        adata, "train_and_annotate",
        # the fields one by one: asdict would deep-copy in-memory references
        parameters={f.name: getattr(config, f.name) for f in fields(config)
                    if f.name != "references"} | {
            "n_references": len(config.references)},
        outputs={"obs": ["cell_type", "cell_type_confidence"],
                 "uns": "spatialcore_annotation"})
    return adata, model


def train_and_annotate_config(adata, config_path: Union[str, Path],
                              device: Device = "cuda", **overrides):
    """YAML entry point: load TrainingConfig and run train_and_annotate."""
    config = TrainingConfig.from_yaml(config_path)
    return train_and_annotate(adata, config=config, device=device,
                              **overrides)
