"""Cell-type classifier model: multinomial logistic regression, scored on
the card.

Port of ``spatialcore_tpu/annotation/model.py`` (``CellTypeModel``
:30-134): a plain parameter container (genes, classes, per-gene scaler,
weights) with batched scoring. ``save`` / ``load`` write and read the
reference's artifact unchanged, ``.npz`` plus a sidecar JSON (no pickle),
so a model saved by either package loads in the other. Scoring is
``clip((x − mean) / std, ±10) @ W + b`` in full float32 (``torch.matmul``
with TF32 off) on ``device``; training lives in ``annotation.training``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..core.compat import full_f32_matmul
from ..core.container import dense_f32
from ..core.logging import get_logger

logger = get_logger("annotation.model")

Device = Union[str, torch.device]

_CLIP_Z = 10.0  # standardized-expression clip, stabilizes LR scores


@dataclass
class CellTypeModel:
    """Multinomial LR over standardized log1p expression."""

    genes: List[str]
    classes: List[str]
    W: np.ndarray                 # [G, C] float32
    b: np.ndarray                 # [C] float32
    scaler_mean: np.ndarray       # [G] float32
    scaler_std: np.ndarray        # [G] float32
    metadata: Dict = field(default_factory=dict)

    @property
    def n_genes(self) -> int:
        return len(self.genes)

    @property
    def n_classes(self) -> int:
        return len(self.classes)

    # -- persistence ------------------------------------------------------

    def save(self, path: Union[str, Path]) -> Path:
        path = Path(path)
        if path.suffix != ".npz":
            path = path.with_suffix(".npz")
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            path, W=np.asarray(self.W, np.float32),
            b=np.asarray(self.b, np.float32),
            scaler_mean=np.asarray(self.scaler_mean, np.float32),
            scaler_std=np.asarray(self.scaler_std, np.float32),
            genes=np.array(self.genes, dtype=object),
            classes=np.array(self.classes, dtype=object))
        with open(path.with_suffix(".json"), "w") as f:
            json.dump({"n_genes": self.n_genes, "n_classes": self.n_classes,
                       "classes": self.classes, **self.metadata}, f, indent=2)
        logger.info(f"Saved model → {path} ({self.n_genes} genes, "
                    f"{self.n_classes} classes)")
        return path

    @classmethod
    def load(cls, path: Union[str, Path]) -> "CellTypeModel":
        path = Path(path)
        if path.suffix != ".npz":
            path = path.with_suffix(".npz")
        with np.load(path, allow_pickle=True) as z:
            model = cls(
                genes=[str(g) for g in z["genes"]],
                classes=[str(c) for c in z["classes"]],
                W=z["W"], b=z["b"],
                scaler_mean=z["scaler_mean"], scaler_std=z["scaler_std"])
        meta_path = path.with_suffix(".json")
        if meta_path.exists():
            with open(meta_path) as f:
                model.metadata = json.load(f)
        return model

    # -- inference ----------------------------------------------------------

    def decision_scores(self, X, gene_idx: Optional[np.ndarray] = None,
                        batch_size: int = 65536,
                        device: Device = "cuda") -> torch.Tensor:
        """Logit scores [N, C] (float32) for log1p-normalized expression
        X [N, G'], on ``device`` (X's own device when X is a tensor).

        ``gene_idx`` maps model genes into X's columns (−1 = absent, scored
        as the scaler mean, i.e. z = 0: the scores of the overlapping
        panel genes alone).
        """
        if isinstance(X, torch.Tensor):
            device = X.device
        params = [torch.as_tensor(np.asarray(a, np.float32), device=device)
                  for a in (self.W, self.b, self.scaler_mean, self.scaler_std)]
        mean = params[2]
        cols = absent = None
        if gene_idx is not None:
            gene_idx = np.asarray(gene_idx)
            cols = np.where(gene_idx >= 0, gene_idx, 0)
            absent = torch.as_tensor(gene_idx < 0, device=device)[None, :]
        n = X.shape[0]
        out = torch.empty((n, self.n_classes), dtype=torch.float32,
                          device=device)
        for s in range(0, n, batch_size):
            xb = dense_f32(X, device, rows=np.arange(s, min(s + batch_size, n)),
                           cols=cols)
            if absent is not None:
                xb = torch.where(absent, mean[None, :], xb)
            out[s:s + batch_size] = _score_batch(xb, *params)
        return out

    def predict(self, X, gene_idx: Optional[np.ndarray] = None,
                batch_size: int = 65536, device: Device = "cuda"):
        """(labels, decision_scores) for log1p expression."""
        scores = self.decision_scores(X, gene_idx, batch_size, device)
        idx = scores.argmax(dim=1).cpu().numpy()
        return np.asarray(self.classes, object)[idx], scores


def _score_batch(xb, W, b, mean, std):
    z = torch.clamp((xb - mean[None, :]) / std[None, :], -_CLIP_Z, _CLIP_Z)
    with full_f32_matmul():
        return z @ W + b
