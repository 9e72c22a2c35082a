"""Annotation benchmarking figures: method comparison and agreement.

Port of ``spatialcore_tpu/plotting/benchmark.py``, after the original
spatialcore's plotting/benchmark.py (method comparison :29, confusion
matrix :132, classification report :239, agreement heatmap :313,
silhouette by type :393) — same public signatures. The label-array
functions additionally accept an AnnData in first position with obs column
names, and ``classification_report_table`` / ``agreement_metrics`` are
extras of this package.

The numbers run in torch on ``device``, without sklearn: the confusion and
per-class counts are integer ``bincount``s, NMI is sklearn's arithmetic
normalization in float64 and ARI ``spatial.neighborhoods.
adjusted_rand_score``'s exact integer form, both from one contingency
table on ``device``, and the silhouette comes from
float64 pairwise distances on the seeded ≤ ``sample_size`` subsample.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import pandas as pd
import torch

from ..core.compat import param_aliases
from ..core.rng import np_rng
from .utils import (despine, format_axis_labels, generate_celltype_palette,
                    save_figure, to_host, _grid)


def _is_adata(obj) -> bool:
    return hasattr(obj, "obs") and hasattr(obj, "n_obs")


def _label_codes(y, labels, device) -> torch.Tensor:
    """int64 codes of the labels ``y`` in ``labels`` (−1 where absent)."""
    codes = pd.Categorical(np.asarray(y), categories=list(labels)).codes
    return torch.as_tensor(codes.astype(np.int64), device=device)


def confusion_counts(yt, yp, labels, device="cuda") -> torch.Tensor:
    """int64 [L, L] counts of (true, predicted) pairs over ``labels``
    (pairs with a label outside ``labels`` are not counted)."""
    L = len(labels)
    t = _label_codes(yt, labels, device)
    p = _label_codes(yp, labels, device)
    keep = (t >= 0) & (p >= 0)
    return torch.bincount(t[keep] * L + p[keep],
                          minlength=L * L).reshape(L, L)


def _per_class(yt, yp, labels, device):
    """(tp, fp, fn) host int arrays per label, from the confusion counts
    over every label either side uses."""
    union = sorted(set(yt) | set(yp))
    cm = confusion_counts(yt, yp, union, device)
    sel = torch.as_tensor([union.index(lab) for lab in labels],
                          dtype=torch.int64, device=cm.device)
    tp = cm.diagonal()[sel]
    fp = cm.sum(dim=0)[sel] - tp
    fn = cm.sum(dim=1)[sel] - tp
    return tp.cpu().numpy(), fp.cpu().numpy(), fn.cpu().numpy()


@param_aliases(path="save")
def plot_method_comparison(
    df: pd.DataFrame,
    metrics: Optional[List[str]] = None,
    method_column: str = "method",
    figsize: tuple = (10, 6),
    title: Optional[str] = None,
    save: Optional[Union[str, Path]] = None,
):
    """Grouped bars of metric scores per annotation method.

    ``df`` has one row per method (named in ``method_column``) and one
    numeric column per metric; default metrics = all numeric columns
    (ref benchmark.py:29-129).
    """
    if not isinstance(df, pd.DataFrame):
        raise ValueError(
            "plot_method_comparison takes a metrics DataFrame (one row per "
            "method); build one from your own scores, e.g. via "
            "classification_report_table")
    if method_column not in df.columns:
        raise ValueError(f"Method column '{method_column}' not found")
    if metrics is None:
        metrics = [c for c in df.columns if c != method_column
                   and np.issubdtype(df[c].dtype, np.number)]
    if not metrics:
        raise ValueError("No numeric metrics found")
    methods = df[method_column].astype(str).tolist()
    x = np.arange(len(metrics))
    width = 0.8 / len(methods)
    palette = generate_celltype_palette(methods)
    fig, axes = _grid(figsize=figsize)
    ax = axes[0, 0]
    for i, method in enumerate(methods):
        vals = df.loc[df[method_column].astype(str) == method,
                      metrics].to_numpy().flatten()
        offset = (i - len(methods) / 2 + 0.5) * width
        bars = ax.bar(x + offset, vals, width, label=method,
                      color=palette.get(method, "#888888"))
        for bar, val in zip(bars, vals):
            ax.text(bar.get_x() + bar.get_width() / 2,
                    bar.get_height() + 0.01, f"{val:.2f}",
                    ha="center", va="bottom", fontsize=8)
    ax.set_xticks(x)
    ax.set_xticklabels(metrics)
    ax.set_ylabel("Score")
    ax.legend(frameon=False, fontsize=8)
    despine(ax)
    ax.set_title(title or "Method Comparison")
    fig.tight_layout()
    if save:
        return save_figure(fig, save)
    return fig


@param_aliases(path="save")
def plot_confusion_matrix(
    true_labels,
    pred_labels,
    labels: Optional[List[str]] = None,
    normalize: bool = True,
    cmap: str = "Blues",
    figsize: Optional[tuple] = None,
    title: Optional[str] = None,
    save: Optional[Union[str, Path]] = None,
    device="cuda",
):
    """Confusion matrix between true and predicted labels.

    Reference form takes two label arrays (ref benchmark.py:132-238);
    also accepts ``(adata, true_column, pred_column)``. The counts run on
    ``device``.
    """
    if _is_adata(true_labels):
        if not (isinstance(pred_labels, str) and isinstance(labels, str)):
            raise ValueError(
                "AnnData form: plot_confusion_matrix(adata, true_column, "
                "pred_column)")
        yt = true_labels.obs[pred_labels].astype(str).to_numpy()
        yp = true_labels.obs[labels].astype(str).to_numpy()
        labels = None
    else:
        yt = to_host(true_labels).astype(str)
        yp = to_host(pred_labels).astype(str)
    if labels is None:
        labels = sorted(set(yt) | set(yp))
    cm = confusion_counts(yt, yp, labels, device).cpu().numpy().astype(float)
    if normalize:
        cm = np.nan_to_num(cm / np.maximum(cm.sum(axis=1, keepdims=True), 1))
    n = len(labels)
    if figsize is None:
        figsize = (max(8, n * 0.5), max(6, n * 0.5))
    fig, axes = _grid(figsize=figsize)
    ax = axes[0, 0]
    im = ax.imshow(cm, cmap=cmap, aspect="auto",
                   vmin=0, vmax=1 if normalize else None)
    cbar = fig.colorbar(im, ax=ax)
    cbar.set_label("Fraction" if normalize else "Count")
    if n <= 30:  # annotate only when readable
        thresh = cm.max() / 2 if cm.max() > 0 else 0.5
        for i in range(n):
            for j in range(n):
                txt = f"{cm[i, j]:.2f}" if normalize else f"{int(cm[i, j])}"
                ax.text(j, i, txt, ha="center", va="center", fontsize=8,
                        color="white" if cm[i, j] > thresh else "black")
    ax.set_xticks(range(n))
    ax.set_yticks(range(n))
    ax.set_xticklabels(labels, rotation=45, ha="right", fontsize=7)
    ax.set_yticklabels(labels, fontsize=7)
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    ax.set_title(title or "Confusion Matrix")
    fig.tight_layout()
    if save:
        return save_figure(fig, save)
    return fig


def classification_report_table(
    adata,
    true_column: str,
    pred_column: str,
    device="cuda",
) -> pd.DataFrame:
    """Per-class precision / recall / F1 / support as a DataFrame; the
    counts run on ``device``."""
    yt = adata.obs[true_column].astype(str).to_numpy()
    yp = adata.obs[pred_column].astype(str).to_numpy()
    labels = sorted(set(yt))
    rows = []
    for lab, tp, fp, fn in zip(labels, *_per_class(yt, yp, labels, device)):
        prec = tp / max(tp + fp, 1)
        rec = tp / max(tp + fn, 1)
        f1 = 2 * prec * rec / max(prec + rec, 1e-9)
        rows.append({"cell_type": lab, "precision": round(prec, 3),
                     "recall": round(rec, 3), "f1": round(f1, 3),
                     "support": int(tp + fn)})
    df = pd.DataFrame(rows)
    acc = (yt == yp).mean()
    df.attrs["accuracy"] = float(acc)
    return df


@param_aliases(path="save")
def plot_classification_report(
    true_labels,
    pred_labels,
    labels: Optional[List[str]] = None,
    figsize: Optional[tuple] = None,
    title: Optional[str] = None,
    save: Optional[Union[str, Path]] = None,
    device="cuda",
):
    """Per-class precision / recall / F1 bars.

    Reference form takes two label arrays (ref benchmark.py:239-311);
    also accepts ``(adata, true_column, pred_column)``. The counts run on
    ``device``.
    """
    if _is_adata(true_labels):
        if not isinstance(labels, str):
            raise ValueError(
                "AnnData form: plot_classification_report(adata, "
                "true_column, pred_column)")
        yt = true_labels.obs[pred_labels].astype(str).to_numpy()
        yp = true_labels.obs[labels].astype(str).to_numpy()
        labels = None
    else:
        yt = to_host(true_labels).astype(str)
        yp = to_host(pred_labels).astype(str)
    if labels is None:
        labels = sorted(set(yt) | set(yp))
    prec, rec, f1 = [], [], []
    for tp, fp, fn in zip(*_per_class(yt, yp, labels, device)):
        p = tp / max(tp + fp, 1)
        r = tp / max(tp + fn, 1)
        prec.append(p)
        rec.append(r)
        f1.append(2 * p * r / max(p + r, 1e-9))
    n = len(labels)
    if figsize is None:
        figsize = (max(10, n * 0.5), 6)
    fig, axes = _grid(figsize=figsize)
    ax = axes[0, 0]
    x = np.arange(n)
    width = 0.25
    ax.bar(x - width, prec, width, label="Precision", color="#3784FE")
    ax.bar(x, rec, width, label="Recall", color="#33CC66")
    ax.bar(x + width, f1, width, label="F1", color="#FF6B6B")
    ax.set_xticks(x)
    ax.set_xticklabels(labels, rotation=45, ha="right", fontsize=7)
    ax.set_ylabel("Score")
    ax.set_ylim(0, 1.1)
    ax.legend(frameon=False, fontsize=8)
    despine(ax)
    acc = (yt == yp).mean()
    ax.set_title(title or
                 f"Classification Metrics by Class (accuracy={acc:.3f})")
    fig.tight_layout()
    if save:
        return save_figure(fig, save)
    return fig


def _codes_of(y, device):
    """Dense int64 codes of a labeling, in the sorted order of its values
    (a tensor keeps its device)."""
    if isinstance(y, torch.Tensor):
        return torch.unique(y.reshape(-1), return_inverse=True)[1]
    codes, _ = pd.factorize(np.asarray(y).ravel(), sort=True)
    return torch.as_tensor(codes.astype(np.int64), device=device)


def _entropy(counts: torch.Tensor) -> torch.Tensor:
    pi = counts[counts > 0].to(torch.float64)
    if pi.numel() <= 1:
        return torch.zeros((), dtype=torch.float64, device=counts.device)
    total = pi.sum()
    return -((pi / total) * (torch.log(pi) - torch.log(total))).sum()


def _contingency(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[na, nb] int64 counts of the code pairs of two labelings, on
    ``a``'s device."""
    b = b.to(a.device)
    if a.shape != b.shape:
        raise ValueError(f"labelings differ in length: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    na = int(a.max()) + 1 if a.numel() else 0
    nb = int(b.max()) + 1 if b.numel() else 0
    return torch.bincount(a * nb + b, minlength=na * nb).reshape(na, nb)


def _nmi(cont: torch.Tensor) -> float:
    na, nb = cont.shape
    if na == nb and na <= 1:
        return 1.0
    pi, pj = cont.sum(dim=1), cont.sum(dim=0)
    if na == 1 or nb == 1:
        return 0.0
    nzx, nzy = torch.nonzero(cont, as_tuple=True)
    nz = cont[nzx, nzy].to(torch.float64)
    total = nz.sum()
    c_nm = nz / total
    outer = pi[nzx] * pj[nzy]                      # int64, exact
    log_outer = (-torch.log(outer.to(torch.float64))
                 + torch.log(pi.sum().to(torch.float64))
                 + torch.log(pj.sum().to(torch.float64)))
    mi = c_nm * (torch.log(nz) - torch.log(total)) + c_nm * log_outer
    mi = torch.where(mi.abs() < torch.finfo(torch.float64).eps,
                     torch.zeros_like(mi), mi)
    mi = float(torch.clamp_min(mi.sum(), 0.0))
    if mi == 0.0:
        return 0.0
    return mi / float((_entropy(pi) + _entropy(pj)) / 2)


def _ari(cont: torch.Tensor) -> float:
    """The adjusted Rand index from the contingency table, as
    ``spatial.neighborhoods.adjusted_rand_score``: the pair confusion
    matrix from int64 sums of squares on the table's device, then the
    ratio in exact integers."""
    n = int(cont.sum())
    if n == 0:
        return 1.0
    ss = int((cont * cont).sum())
    fp = int((cont.sum(dim=0) ** 2).sum()) - ss
    fn = int((cont.sum(dim=1) ** 2).sum()) - ss
    tp, tn = ss - n, n * n - fp - fn - ss
    if fn == 0 and fp == 0:
        return 1.0
    return 2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn) + (tp + fp) * (fp + tn))


def normalized_mutual_info(y_a, y_b, device="cuda") -> float:
    """NMI with the arithmetic-mean normalization, as
    ``sklearn.metrics.normalized_mutual_info_score`` computes it: mutual
    information from the contingency table in float64 over the entropies'
    mean, 1.0 when neither labeling splits the cells, 0.0 when the mutual
    information is 0."""
    return _nmi(_contingency(_codes_of(y_a, device), _codes_of(y_b, device)))


def agreement_metrics(y_a, y_b, device="cuda") -> Dict[str, float]:
    """NMI and ARI between two labelings (the reference's Python-vs-R
    validation metrics, SURVEY.md §6), both from one contingency table on
    ``device`` (a tensor labeling's own device)."""
    cont = _contingency(_codes_of(y_a, device), _codes_of(y_b, device))
    return {"nmi": _nmi(cont), "ari": _ari(cont)}


@param_aliases(path="save")
def plot_agreement_heatmap(
    adata,
    columns,
    figsize: Optional[tuple] = None,
    cmap: str = "Greens",
    title: Optional[str] = None,
    save: Optional[Union[str, Path]] = None,
    column_b: Optional[str] = None,
    device="cuda",
):
    """Pairwise exact-agreement matrix across ≥2 labeling columns
    (ref benchmark.py:313-391).  The historical two-column form
    ``(adata, column_a, column_b)`` still works and adds NMI/ARI to the
    title.
    """
    if isinstance(columns, str):
        if isinstance(figsize, str) and column_b is None:  # old positional
            column_b, figsize = figsize, None
        if column_b is None:
            raise ValueError("columns must be a list of ≥2 obs columns")
        columns = [columns, column_b]
    columns = list(columns)
    for col in columns:
        if col not in adata.obs.columns:
            raise ValueError(f"Column '{col}' not found")
    n = len(columns)
    agreement = np.zeros((n, n))
    for i, a in enumerate(columns):
        for j, b in enumerate(columns):
            agreement[i, j] = float(
                (adata.obs[a].astype(str).to_numpy()
                 == adata.obs[b].astype(str).to_numpy()).mean())
    if figsize is None:
        figsize = (max(6, n * 1.2), max(5, n))
    fig, axes = _grid(figsize=figsize)
    ax = axes[0, 0]
    im = ax.imshow(agreement, cmap=cmap, vmin=0, vmax=1)
    fig.colorbar(im, ax=ax, label="Agreement")
    for i in range(n):
        for j in range(n):
            ax.text(j, i, f"{agreement[i, j]:.2f}", ha="center",
                    va="center",
                    color="white" if agreement[i, j] > 0.5 else "black")
    ax.set_xticks(range(n))
    ax.set_yticks(range(n))
    ax.set_xticklabels(columns, rotation=45, ha="right", fontsize=8)
    ax.set_yticklabels(columns, fontsize=8)
    if title is None:
        title = "Method Agreement"
        if n == 2:
            met = agreement_metrics(adata.obs[columns[0]].astype(str),
                                    adata.obs[columns[1]].astype(str),
                                    device=device)
            title += f" (NMI={met['nmi']:.3f}  ARI={met['ari']:.3f})"
    ax.set_title(title)
    fig.tight_layout()
    if save:
        return save_figure(fig, save)
    return fig


@param_aliases(cell_type_column="label_column", use_rep="embedding_key",
               max_cells="sample_size", seed="random_state", path="save")
def plot_silhouette_by_type(
    adata,
    label_column: str = "cell_type",
    embedding_key: str = "X_pca",
    sample_size: int = 5000,
    random_state: int = 42,
    figsize: tuple = (10, 6),
    title: Optional[str] = None,
    save: Optional[Union[str, Path]] = None,
    device="cuda",
):
    """Mean silhouette per cell type on a seeded subsample
    (ref benchmark.py:393-477; falls back to ``X`` when the embedding is
    absent, and the subsample is counter-seeded for placement-independent
    reproducibility). The silhouettes run on ``device``
    (:func:`silhouette_samples`); a tensor embedding is subsampled where
    it lies."""
    import scipy.sparse as sp

    if label_column not in adata.obs.columns:
        raise ValueError(f"Label column '{label_column}' not found")
    X = adata.obsm[embedding_key] if embedding_key in adata.obsm else adata.X
    if sp.issparse(X):
        X = np.asarray(X.todense())
    labels = adata.obs[label_column].astype(str).to_numpy()
    n = X.shape[0]
    idx = np.arange(n)
    if n > sample_size:
        idx = np_rng(random_state, "silhouette").choice(
            n, sample_size, replace=False)
    labels = labels[idx]
    keep = pd.Series(labels).map(
        pd.Series(labels).value_counts() >= 2).to_numpy()
    idx, labels = idx[keep], labels[keep]
    if len(set(labels)) < 2:
        raise ValueError("Silhouette needs ≥2 types with ≥2 cells")
    if isinstance(X, torch.Tensor):
        Xs = X[torch.as_tensor(idx, device=X.device)]
    else:
        Xs = torch.as_tensor(np.asarray(X, np.float32)[idx], device=device)
    sil = silhouette_samples(Xs.to(torch.float32), labels).cpu().numpy()
    df = pd.DataFrame({"label": labels, "silhouette": sil})
    type_scores = df.groupby("label")["silhouette"].mean().sort_values()
    fig, axes = _grid(figsize=figsize)
    ax = axes[0, 0]
    palette = generate_celltype_palette(type_scores.index.tolist())
    y_pos = np.arange(len(type_scores))
    ax.barh(y_pos, type_scores.values,
            color=[palette.get(ct, "#888888") for ct in type_scores.index])
    ax.set_yticks(y_pos)
    ax.set_yticklabels(type_scores.index, fontsize=8)
    ax.axvline(0, color="gray", linestyle="--", lw=0.8)
    format_axis_labels(ax, xlabel="Silhouette Score")
    despine(ax)
    ax.set_title(title or "Silhouette Scores by Cell Type"
                 f"\n(mean={sil.mean():.3f})")
    fig.tight_layout()
    if save:
        return save_figure(fig, save)
    return fig


def silhouette_samples(X: torch.Tensor, labels, chunk: int = 1024
                       ) -> torch.Tensor:
    """Per-cell silhouette (b − a) / max(a, b) with Euclidean distances,
    as ``sklearn.metrics.silhouette_samples``: a the mean distance to the
    cell's own type (itself excluded), b the least mean distance to
    another type, 0 for a type of one cell. float64 distances in row
    chunks of ``chunk`` on ``X``'s device; a cell's distance to itself is
    0. Returns float64 [n]."""
    X = X.to(torch.float64)
    n = X.shape[0]
    codes = _codes_of(labels, X.device).to(X.device)
    L = int(codes.max()) + 1
    counts = torch.bincount(codes, minlength=L).to(torch.float64)
    sums = torch.zeros((n, L), dtype=torch.float64, device=X.device)
    for r0 in range(0, n, chunk):
        r1 = min(r0 + chunk, n)
        D = torch.cdist(X[r0:r1], X)
        D[torch.arange(r1 - r0, device=X.device),
          torch.arange(r0, r1, device=X.device)] = 0.0
        sums[r0:r1].index_add_(1, codes, D)
    rows = torch.arange(n, device=X.device)
    own = counts[codes]
    a = sums[rows, codes] / torch.clamp_min(own - 1, 1)
    other = sums / counts[None, :]
    other[rows, codes] = float("inf")
    b = other.min(dim=1).values
    s = (b - a) / torch.maximum(a, b)
    return torch.where((own > 1) & torch.isfinite(s), s, torch.zeros_like(s))
