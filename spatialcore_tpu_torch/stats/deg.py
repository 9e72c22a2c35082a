"""Differential expression: the Wilcoxon rank-sum test per gene, each
group against the rest.

Port of ``spatialcore_tpu/stats/deg.py`` (``rank_genes_groups``,
``_rank_stats`` :30-64), with the scanpy-shaped ``uns`` output (names,
scores, pvals, pvals_adj, logfoldchanges per group). The reference maps one
gene at a time; here tiles of genes are sorted as one batch
(``torch.sort(stable=True)``), a cell's rank is the average position of
its tie run, and every group's rank sum is one column of one product with
the group masks.

The reference sums tie-run positions and rank sums in float32, which
rounds once a sum passes 2²⁴. Here they are exact: a run's average rank
is (first + last)/2 + 1, held as twice that in int64, and the rank sums
are float64 products of half-integers (exact below 2⁵³), each rounded to
float32 once. Below 2²⁴ both are exact, so the ranks and the rank sums
are bitwise the reference's; above it the port's stay exact. z divides
by a correctly rounded square root; the reference's CPU run multiplies by
XLA's reciprocal square root instead (a hardware estimate refined by a
Newton step, within one ulp of the correctly rounded value and not the
same on every CPU), so z agrees within 2 ulp. The root is
``core/rng._sqrt32``, correctly rounded on every device (torch's CPU
float32 ``sqrt`` is not always), so z is the same on the card and the
CPU. The tie term is summed in
float64 and rounded once (the reference sums it in float32). The group
means for the fold changes are float64 sums.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..core.container import dense_f32
from ..core.logging import get_logger
from ..core.rng import _sqrt32
from ..core.metadata import update_metadata
from ..ops.fdr import apply_fdr
from .thresholding import _recip32

logger = get_logger("stats.deg")

Device = Union[str, torch.device]

#: values of one [gene tile, cells] sort
_TILE_ELEMS = 1 << 25


def _tie_ranks(x: torch.Tensor):
    """Twice the average 1-based rank of each value in each row of
    ``x`` [g, n] (int64; ties share their run's average), and each row's
    Σ (c³ − c) over its tie runs of size c (float64)."""
    g, n = x.shape
    sx, order = torch.sort(x, dim=1, stable=True)
    pos = torch.arange(n, device=x.device).expand(g, n)
    new_run = torch.ones_like(sx, dtype=torch.bool)
    new_run[:, 1:] = sx[:, 1:] != sx[:, :-1]
    start = torch.where(new_run, pos, 0).cummax(dim=1).values
    run_end = torch.ones_like(new_run)
    run_end[:, :-1] = new_run[:, 1:]
    end = torch.where(run_end, pos, n).flip(1).cummin(dim=1).values.flip(1)
    twice = torch.empty_like(start).scatter_(1, order, start + end + 2)
    cnt = (end - start + 1).to(torch.float64)
    tie = torch.where(new_run, cnt ** 3 - cnt, 0.0).sum(dim=1)
    return twice, tie


def _rank_sums(X: torch.Tensor, masks: torch.Tensor):
    """Each group's rank sum [G, K] and each gene's tie term
    Σ(c³ − c) / (n(n − 1)) [G], float32, each rounded once.

    ``X`` [N, G] and ``masks`` [N, K] (float32 0/1) on one device. Ranks
    depend only on X, so they are computed once per gene tile, and each
    group's rank sum is a column of one [g, N] @ [N, K] float64 product.
    """
    n, G = X.shape
    tile = max(1, min(G, _TILE_ELEMS // max(n, 1)))
    m64 = masks.to(torch.float64)
    R1, tie = [], []
    for g0 in range(0, G, tile):
        twice, t = _tie_ranks(X[:, g0:g0 + tile].T)
        R1.append((twice.to(torch.float64) @ m64) / 2)
        tie.append(t)
        del twice
    return (torch.cat(R1).to(torch.float32),
            (torch.cat(tie) * (1.0 / (n * (n - 1.0)))).to(torch.float32))


def _rank_stats(X: torch.Tensor, masks: torch.Tensor,
                tie_correct: bool = False) -> torch.Tensor:
    """Wilcoxon rank-sum z [G, K] for K groups against the rest."""
    n = X.shape[0]
    R1, tie = _rank_sums(X, masks)
    n1 = masks.sum(dim=0)                                       # [K]
    n2 = n - n1
    expected = n1 * (n + 1) * 0.5
    if tie_correct:
        var = (n1 * n2 * _recip32(12))[None, :] * ((n + 1.0) - tie[:, None])
    else:
        var = (n1 * n2 * (n + 1.0) * _recip32(12))[None, :].expand_as(R1)
    return (R1 - expected[None, :]) / _sqrt32(torch.clamp_min(var, 1e-9))


def _group_means(X: torch.Tensor, masks: torch.Tensor):
    """float64 per-group sums [K, G] and the column totals [G]."""
    n, G = X.shape
    tile = max(1, min(G, _TILE_ELEMS // max(n, 1)))
    m64 = masks.to(torch.float64)
    sums, total = [], []
    for g0 in range(0, G, tile):
        x = X[:, g0:g0 + tile].to(torch.float64)
        sums.append(m64.T @ x)
        total.append(x.sum(dim=0))
    return torch.cat(sums, dim=1), torch.cat(total)


def rank_genes_groups(
    adata,
    groupby: str,
    groups: Optional[Sequence[str]] = None,
    reference: str = "rest",
    method: str = "wilcoxon",
    n_genes: Optional[int] = None,
    tie_correct: bool = False,
    min_cells: int = 2,
    key_added: str = "rank_genes_groups",
    copy: bool = False,
    device: Device = "cuda",
):
    """Per-group marker ranking (group vs rest), scanpy-compatible output.

    ``uns[key_added]``: a dict with each group's ordered ``names``,
    ``scores`` (z), ``pvals``, ``pvals_adj`` (BH), ``logfoldchanges``
    (log2 of expm1-mean ratios, the scanpy convention). Cells with a null
    label take no part. The ranks and sums run on ``device``.
    """
    from scipy.stats import norm as scipy_norm

    start = time.time()
    if copy:
        adata = adata.copy()
    if groupby not in adata.obs.columns:
        raise ValueError(f"Column '{groupby}' not found in obs")
    if method != "wilcoxon":
        raise ValueError(
            f"Only method='wilcoxon' is implemented, got '{method}'")
    if reference != "rest":
        raise ValueError("Only reference='rest' is implemented")

    raw = adata.obs[groupby]
    na = raw.isna().to_numpy()
    if na.any():
        logger.info(f"rank_genes_groups: excluding {int(na.sum()):,} "
                    f"cells with null '{groupby}'")
    labels = raw[~na].astype(str)
    all_groups = [g for g, c in labels.value_counts().items()
                  if c >= min_cells]
    if groups is not None:
        missing = [g for g in groups if g not in set(labels.unique())]
        if missing:
            raise ValueError(f"Groups not present: {missing}")
        too_small = [g for g in groups if g not in all_groups
                     and g not in missing]
        if too_small:
            raise ValueError(
                f"Requested groups below min_cells={min_cells}: "
                f"{too_small}")
        use_groups = list(groups)
    else:
        use_groups = sorted(all_groups)
    if len(use_groups) < 1 or labels.nunique() < 2:
        raise ValueError("Need ≥2 groups with enough cells for DEG")

    X = dense_f32(adata.X, device, rows=np.flatnonzero(~na) if na.any()
                  else None)
    var_names = np.asarray(adata.var_names, object)
    n_top = n_genes or X.shape[1]

    result = {"params": {"groupby": groupby, "reference": reference,
                         "method": method, "tie_correct": tie_correct},
              "names": {}, "scores": {}, "pvals": {}, "pvals_adj": {},
              "logfoldchanges": {}}
    masks_np = np.stack([(labels == grp).to_numpy()
                         for grp in use_groups], axis=1).astype(np.float32)
    masks = torch.as_tensor(masks_np, device=X.device)
    z_all = _rank_stats(X, masks, tie_correct=tie_correct).cpu().numpy()
    sums, total = _group_means(X, masks)
    sums, total = sums.cpu().numpy(), total.cpu().numpy()
    n_kept = X.shape[0]
    del X, masks
    for ki, grp in enumerate(use_groups):
        z = z_all[:, ki]
        pvals = 2.0 * scipy_norm.sf(np.abs(z))
        padj = apply_fdr(pvals, method="bh").numpy()
        n1 = int(masks_np[:, ki].sum())
        mean_in = (sums[ki] / n1).astype(np.float32)
        mean_out = ((total - sums[ki]) / max(n_kept - n1, 1)).astype(np.float32)
        lfc = np.log2((np.expm1(mean_in) + 1e-9)
                      / (np.expm1(mean_out) + 1e-9))
        order = np.argsort(-z)[:n_top]
        result["names"][grp] = var_names[order].tolist()
        result["scores"][grp] = z[order].tolist()
        result["pvals"][grp] = pvals[order].tolist()
        result["pvals_adj"][grp] = padj[order].tolist()
        result["logfoldchanges"][grp] = lfc[order].tolist()

    adata.uns[key_added] = result
    logger.info(f"rank_genes_groups: {len(use_groups)} groups × "
                f"{len(var_names)} genes ({time.time() - start:.1f}s)")
    update_metadata(adata, "rank_genes_groups",
                    parameters={"groupby": groupby, "method": method,
                                "n_groups": len(use_groups)},
                    outputs={"uns": key_added})
    return adata
