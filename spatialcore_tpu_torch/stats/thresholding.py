"""Threshold detection on scores: metagenes, the KS-style threshold and
1-D Gaussian mixtures, in torch ops on the card.

Port of ``spatialcore_tpu/stats/thresholding.py``:

- ``compute_metagene_score`` (:36-62). Bitwise the reference's CPU run:
  ``exp`` and ``log`` are XLA's float32 CPU approximations
  (``core/rng._exp32`` / ``_log32``),
  a row mean is XLA's tree-ordered sum times the float32 reciprocal of
  the count (``ops/kmeans._tree_sum``), and ``median``
  averages the two middle values as ``jnp.median`` does (``torch.median``
  returns the lower one).
- ``threshold_ks`` (:72-124): the background normal's CDF
  (``torch.special.ndtr``) and the argmax of ``ecdf − expected`` over the
  sorted scores; the linear quantiles are read from the sorted scores
  directly (``torch.quantile`` refuses more than 2²⁴ values).
- ``fit_gmm1d`` (:127-205): every restart starts at
  ``choice(key_for(seed, "gmm", r), n, (K,), replace=False)``, bitwise
  (``core/rng._choice``). The ``n_init`` restarts run as one batch; each
  freezes at its own stopping iteration, as the reference's ``lax.map`` of
  ``while_loop`` s stops each, and the batch reads one flag back to the
  host every ``_CHECK_EVERY`` steps, not every step.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple, Union

import numpy as np
import torch

from ..core.rng import _choice, _exp32, _log32, key_for
from ..ops.kmeans import _tree_sum

Device = Union[str, torch.device]

MetageneMethod = (
    "shifted_geometric_mean", "geometric_mean", "arithmetic_mean",
    "median", "minimum",
)

#: EM steps between two reads of the restarts' "still running" flag
_CHECK_EVERY = 16


def _recip32(c: float) -> float:
    """f32(1/c). The reference's CPU run multiplies by it where it divides
    by a constant; an explicit multiply is also the same on every device
    (torch's CUDA division by a Python scalar multiplies by its
    reciprocal, its CPU one divides)."""
    return float(np.float32(1.0) / np.float32(c))


def _as_f32(x, device: Device) -> torch.Tensor:
    """A float32 tensor: a tensor stays on its device, anything else goes
    to ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _row_mean(X: torch.Tensor) -> torch.Tensor:
    """Mean over axis 1 as the reference's CPU run forms it: XLA's
    tree-ordered row sum times the float32 reciprocal of the count."""
    return _tree_sum(X) * _recip32(X.shape[1])


def _median_rows(X: torch.Tensor) -> torch.Tensor:
    """``jnp.median(X, axis=1)``: the middle value, or the mean of the two
    middle values for an even count (NaN where a row holds NaN)."""
    s = torch.sort(X, dim=1).values
    f = X.shape[1]
    lo, hi = s[:, (f - 1) // 2], s[:, f // 2]
    med = lo if f % 2 else (lo + hi) * 0.5
    return torch.where(torch.isnan(X).any(dim=1),
                       torch.full_like(med, math.nan), med)


def compute_metagene_score(feature_values, method: str = "shifted_geometric_mean",
                           pseudocount: float = 0.1,
                           device: Device = "cuda") -> torch.Tensor:
    """Aggregate [N, F] features into a joint-elevation score per cell.

    Multiplicative methods (geometric / shifted-geometric / minimum) are
    high only when ALL markers are elevated. ``shifted_geometric_mean`` is
    exp(mean(log(x + c))) − c with pseudocount c. A tensor input stays on
    its device; other inputs go to ``device``. Returns float32 [N].
    """
    X = _as_f32(feature_values, device)
    if X.ndim == 1:
        X = X[:, None]
    if method == "shifted_geometric_mean":
        c = float(np.float32(pseudocount))
        return _exp32(_row_mean(_log32(X + c))) - c
    if method == "geometric_mean":
        g = _exp32(_row_mean(_log32(torch.clamp_min(X, 1e-30))))
        return g * (X > 0).all(dim=1)
    if method == "arithmetic_mean":
        return _row_mean(X)
    if method == "median":
        return _median_rows(X)
    if method == "minimum":
        return X.min(dim=1).values
    raise ValueError(f"Unknown metagene method '{method}'. "
                     f"Choose one of {MetageneMethod}.")


# ---------------------------------------------------------------------------
# KS-style threshold
# ---------------------------------------------------------------------------


def _quantile_sorted(s: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(s, q)`` (linear) of an already sorted float32 vector."""
    n = s.shape[0]
    pos = float(np.float32(q) * np.float32(n - 1))
    lo = min(max(math.floor(pos), 0), n - 1)
    hi = min(max(math.ceil(pos), 0), n - 1)
    w_hi = np.float32(pos - math.floor(pos))
    w_lo = np.float32(1.0) - w_hi
    return s[lo] * float(w_lo) + s[hi] * float(w_hi)


def _ks_core(scores: torch.Tensor, background_quantile: float):
    s = torch.sort(scores).values
    n = s.shape[0]
    bg = s[:max(int(n * background_quantile), 10)]
    bg_mean = bg.mean()
    bg_std = bg.std(unbiased=False)
    # zero-variance fallbacks: IQR/1.35, then 10% of range (floored)
    iqr = _quantile_sorted(s, 0.75) - _quantile_sorted(s, 0.25)
    range_std = torch.clamp_min((s[-1] - s[0]) * 0.1, 1e-6)
    bg_std = torch.where(bg_std >= 1e-10, bg_std,
                         torch.where(iqr > 1e-10, iqr * _recip32(1.35),
                                     range_std))
    ecdf = torch.arange(1, n + 1, dtype=torch.float32,
                        device=s.device) * _recip32(n)
    expected = torch.special.ndtr((s - bg_mean) / bg_std)
    idx = torch.argmax(ecdf - expected)
    threshold = s[idx]
    # sanity floor: the threshold must sit above the background mean
    threshold = torch.where(threshold <= bg_mean, _quantile_sorted(s, 0.9),
                            threshold)
    score_range = torch.clamp_min(s[-1] - threshold, 1e-10)
    deviation = torch.clamp((scores - threshold) / score_range, 0.0, 1.0)
    return threshold, deviation, bg_mean, bg_std, idx


def threshold_ks(scores, background_quantile: float = 0.5,
                 device: Device = "cuda") -> Tuple[float, np.ndarray, Dict]:
    """Threshold where the empirical CDF most exceeds a background normal
    fitted to the lower ``background_quantile`` of the data.

    Returns (threshold, deviation scores in [0, 1], params): ≥ 10
    background samples, the IQR fallback for a zero-variance background,
    the P90 sanity floor. A tensor input stays on its device.
    """
    scores = _as_f32(scores, device)
    thr, dev, bg_mean, bg_std, _ = _ks_core(scores, background_quantile)
    params = {
        "background_mean": float(bg_mean),
        "background_std": float(bg_std),
        "background_quantile": background_quantile,
    }
    return float(thr), dev.cpu().numpy(), params


# ---------------------------------------------------------------------------
# 1D Gaussian mixture EM
# ---------------------------------------------------------------------------


class GMM1D(NamedTuple):
    """Fitted 1D Gaussian mixture (component order as fitted)."""

    means: torch.Tensor     # [K]
    stds: torch.Tensor      # [K]
    weights: torch.Tensor   # [K]
    log_lik: torch.Tensor   # scalar


def _log_prob(x, means, stds, weights):
    """[..., N, K] log(w_k · N(x; mu_k, sigma_k)) for x [N] and parameters
    [..., K], in the reference's order (``jax.scipy.stats.norm.logpdf``)."""
    var = (stds * stds)[..., None, :]
    log_norm = torch.log(2 * math.pi * var)
    quad = (x[:, None] - means[..., None, :]) ** 2 / var
    return torch.log(weights)[..., None, :] + (log_norm + quad) / -2.0


def _em_step(x, state, min_std: float):
    means, stds, weights, _, ll_prev, it = state
    lp = _log_prob(x, means, stds, weights)                   # [R, N, K]
    ll = torch.logsumexp(lp, dim=-1).mean(dim=-1)
    resp = torch.softmax(lp, dim=-1)
    nk = resp.sum(dim=-2) + 1e-10
    means = (resp * x[:, None]).sum(dim=-2) / nk
    var = (resp * (x[:, None] - means[..., None, :]) ** 2).sum(dim=-2) / nk
    stds = torch.sqrt(torch.clamp_min(var, min_std ** 2))
    weights = nk * _recip32(x.shape[0])
    return means, stds, weights, ll_prev, ll, it + 1


def _running(state, tol: float, max_iter: int) -> torch.Tensor:
    _, _, _, prev, ll, it = state
    return ((ll - prev).abs() > tol) & (it < max_iter)


def _em_fit(x, means0, stds0, weights0, max_iter: int, tol: float,
            min_std: float):
    """EM for every restart of [R, K] starts at once; restart r stops at
    the first step where |Δll| ≤ tol or ``max_iter`` steps ran, and its
    state stays frozen from there while the others go on."""
    R = means0.shape[0]
    dev = x.device
    state = (means0, stds0, weights0,
             torch.full((R,), -math.inf, device=dev),
             torch.full((R,), math.inf, device=dev),
             torch.zeros(R, dtype=torch.int32, device=dev))
    state = _em_step(x, state, min_std)          # gives ll a real value
    run = _running(state, tol, max_iter)
    while bool(run.any()):
        for _ in range(_CHECK_EVERY):
            new = _em_step(x, state, min_std)
            state = tuple(torch.where(run.view((R,) + (1,) * (a.ndim - 1)), a, b)
                          for a, b in zip(new, state))
            run = run & _running(state, tol, max_iter)
    means, stds, weights = state[:3]
    ll = torch.logsumexp(_log_prob(x, means, stds, weights), dim=-1).mean(-1)
    return means, stds, weights, ll


def fit_gmm1d(x, n_components: int = 2, seed: int = 42, n_init: int = 10,
              max_iter: int = 200, tol: float = 1e-4,
              device: Device = "cuda") -> GMM1D:
    """Fit a 1D GMM by EM, best of ``n_init`` deterministic restarts.

    Restart r starts its means at data points drawn with the counter-based
    key (seed, "gmm", r), its stds at the global std and its weights
    uniform, then runs EM to convergence. The restart of the highest mean
    log-likelihood wins (sklearn's ``n_init`` protocol). A tensor input
    stays on its device.
    """
    x = _as_f32(x, device)
    n = x.shape[0]
    gstd = torch.clamp_min(x.std(unbiased=False), 1e-6)
    idx = torch.stack([_choice(key_for(seed, "gmm", r), n, n_components,
                               x.device) for r in range(n_init)])
    means0 = x[idx]                                           # [R, K]
    stds0 = gstd.expand(n_init, n_components).clone()
    weights0 = torch.full((n_init, n_components), 1.0 / n_components,
                          device=x.device)
    means, stds, weights, ll = _em_fit(x, means0, stds0, weights0, max_iter,
                                       tol, 1e-4)
    best = torch.argmax(ll)
    return GMM1D(means[best], stds[best], weights[best], ll[best])


def gmm_posterior(scores, model: GMM1D) -> torch.Tensor:
    """Posterior responsibilities [N, K] under a fitted model (for reuse on
    the full dataset after a subsampled fit), on the model's device."""
    scores = _as_f32(scores, model.means.device).to(model.means.device)
    lp = _log_prob(scores, model.means, model.stds, model.weights)
    return torch.softmax(lp, dim=-1)


def _linspace32(start: float, stop: float, num: int, dev) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in float32: start·(1 − t) +
    stop·t with t = i / (num − 1), the endpoint appended."""
    t = torch.arange(num - 1, dtype=torch.float32, device=dev) * \
        _recip32(num - 1)
    a = torch.tensor(start, dtype=torch.float32, device=dev)
    b = torch.tensor(stop, dtype=torch.float32, device=dev)
    return torch.cat([a * (1 - t) + b * t, b[None]])


def threshold_gmm(scores, probability_cutoff: float = 0.3,
                  n_components: int = 2, seed: int = 42, n_init: int = 10,
                  device: Device = "cuda"
                  ) -> Tuple[float, np.ndarray, np.ndarray, Dict]:
    """GMM threshold separating low/high populations.

    2-component: the threshold where P(high|x) crosses 0.5 on a 1000-point
    grid between the component means (midpoint fallback). 3-component
    "trimodal spatial" mode: components sorted by mean, threshold =
    midpoint(background, first signal), P(high) = sum of non-background
    posteriors. Returns (threshold, cluster_labels, probability_high,
    params) with the fitted model under ``params["gmm_model"]``.
    """
    scores_t = _as_f32(scores, device)
    model = fit_gmm1d(scores_t, n_components=n_components, seed=seed,
                      n_init=n_init)
    means = model.means.cpu().numpy()
    stds = model.stds.cpu().numpy()
    order = np.argsort(means)
    post_all = gmm_posterior(scores_t, model)

    if n_components == 2:
        high = int(np.argmax(means))
        low = 1 - high
        grid = _linspace32(float(means[low]), float(means[high]), 1000,
                           scores_t.device)
        pg = gmm_posterior(grid, model)[:, high].cpu().numpy()
        crossings = np.where(np.diff(np.sign(pg - 0.5)))[0]
        if crossings.size:
            threshold = float(grid[int(crossings[0])])
        else:
            threshold = float((means[low] + means[high]) / 2)
        probability_high = post_all[:, high]
        high_component = high
    else:
        threshold = float((means[order[0]] + means[order[1]]) / 2)
        probability_high = post_all[:, torch.as_tensor(
            order[1:], device=post_all.device)].sum(dim=1)
        high_component = int(order[1])

    probability_high = probability_high.cpu().numpy()
    cluster_labels = (probability_high > probability_cutoff).astype(int)
    params = {
        "gmm_means": means.tolist(),
        "gmm_stds": stds.tolist(),
        "gmm_weights": model.weights.cpu().numpy().tolist(),
        "n_components": n_components,
        "sorted_component_indices": order.tolist(),
        "high_component_idx": high_component,
        "probability_cutoff": probability_cutoff,
        "gmm_model": model,
    }
    return threshold, cluster_labels, probability_high, params
