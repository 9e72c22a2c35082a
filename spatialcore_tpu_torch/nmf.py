"""Non-negative matrix factorization on the card (multiplicative updates).

Port of ``spatialcore_tpu/nmf.py`` (``nmf_fit`` :37-70, ``run_nmf``,
``NMFResult``): Lee-Seung multiplicative updates in full float32 matrix
products, Frobenius-loss early stopping (the norms accumulated in
float64), and the reference's counter-based init: ``split(key_for(seed,
"nmf"))`` and two ``uniform`` draws, bitwise the reference's
(``core/rng``), times √(mean(X)/k + 1e-9) formed as the reference's CPU
run forms it (the sum times the product of the two float32 reciprocals).
The sum itself is float64 rounded once, where the reference adds float32
in XLA's order, so the scale can differ from the reference's in its last
bit.

The stopping rule is checked on the card after every step: a finished
fit keeps its state while the loop runs on to the next read of the flag,
every ``_CHECK_EVERY`` steps, so the result is the one the reference's
``while_loop`` stops at.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from .core.compat import full_f32_matmul
from .core.container import dense_f32
from .core.logging import get_logger
from .core.metadata import update_metadata
from .core.rng import key_for, split, uniform

logger = get_logger("nmf")

Device = Union[str, torch.device]

_EPS = 1e-9
#: multiplicative updates between two reads of the "still running" flag
_CHECK_EVERY = 8


class NMFResult(NamedTuple):
    W: torch.Tensor        # [N, k] cell loadings
    H: torch.Tensor        # [k, G] gene programs
    loss: torch.Tensor     # final relative Frobenius loss
    n_iter: torch.Tensor


def _norm(A: torch.Tensor) -> torch.Tensor:
    """Frobenius norm accumulated in float64, rounded to float32: a float32
    sum over N·G terms drifts with the reduction's order (on the CPU by
    ~1e-4 between memory layouts of one matrix at 20,000 × 377)."""
    return torch.linalg.vector_norm(A, dtype=torch.float64).to(torch.float32)


def init_scale(X: torch.Tensor, n_components: int) -> float:
    """√(mean(X)/k + 1e-9) in float32 as the reference's CPU run forms it:
    the sum of X (float64, rounded once) times the float32 product of the
    reciprocals of X's size and of k."""
    n, g = X.shape
    inv = np.float32(np.float32(1.0) / np.float32(n * g)) * \
        np.float32(np.float32(1.0) / np.float32(n_components))
    total = np.float32(float(X.to(torch.float64).sum()))
    return float(np.sqrt(np.float32(total * inv) + np.float32(_EPS)))


def nmf_init(X: torch.Tensor, n_components: int, seed: int = 0):
    """The reference's init: uniform [N, k] and [k, G] draws on X's device
    from ``split(key_for(seed, "nmf"))``, times :func:`init_scale`."""
    n, g = X.shape
    kw, kh = split(key_for(seed, "nmf"))
    scale = init_scale(X, n_components)
    W0 = uniform(kw, (n, n_components), device=X.device) * scale
    H0 = uniform(kh, (n_components, g), device=X.device) * scale
    return W0, H0


def nmf_fit(X, n_components: int, seed: int = 0, max_iter: int = 200,
            tol: float = 1e-4, device: Device = "cuda") -> NMFResult:
    """Factor non-negative X [N, G] ≈ W @ H with multiplicative updates
    until the relative loss stalls (``prev − cur ≤ tol·prev``) or
    ``max_iter`` steps. A tensor input stays on its device."""
    X = X.to(torch.float32) if isinstance(X, torch.Tensor) else \
        torch.as_tensor(np.asarray(X, np.float32), device=device)
    W, H = nmf_init(X, n_components, seed)
    dev = X.device
    with full_f32_matmul():
        x_norm = torch.clamp_min(_norm(X), _EPS)

        def loss_of(W, H):
            return _norm(X - W @ H) / x_norm

        def step(W, H):
            H = H * (W.T @ X) / (W.T @ W @ H + _EPS)
            W = W * (X @ H.T) / (W @ (H @ H.T) + _EPS)
            return W, H

        prev = loss_of(W, H)
        W, H = step(W, H)
        cur = loss_of(W, H)
        it = torch.ones((), dtype=torch.int32, device=dev)
        run = (it < max_iter) & (prev - cur > tol * prev)
        while bool(run):
            for _ in range(_CHECK_EVERY):
                W2, H2 = step(W, H)
                W = torch.where(run, W2, W)
                H = torch.where(run, H2, H)
                new = loss_of(W, H)
                prev = torch.where(run, cur, prev)
                cur = torch.where(run, new, cur)
                it = it + run.to(torch.int32)
                run = run & (it < max_iter) & (prev - cur > tol * prev)
    return NMFResult(W, H, cur, it)


def run_nmf(
    adata,
    n_components: int = 10,
    layer: Optional[str] = None,
    max_iter: int = 200,
    tol: float = 1e-4,
    seed: int = 0,
    key_added: str = "nmf",
    copy: bool = False,
    device: Device = "cuda",
):
    """NMF gene programs: ``obsm['X_nmf']`` loadings, ``varm`` programs.

    Requires non-negative input (log1p-normalized or raw counts). Stores
    each program's top genes in ``uns[f"{key_added}_params"]``. The fit
    runs on ``device``.
    """
    start = time.time()
    if copy:
        adata = adata.copy()
    X = dense_f32(adata.layers[layer] if layer else adata.X, device)
    if bool((X < 0).any()):
        raise ValueError("NMF requires non-negative input; X has negatives.")
    if n_components < 1 or n_components > min(X.shape):
        raise ValueError(
            f"n_components must be in [1, {min(X.shape)}], got {n_components}")

    res = nmf_fit(X, n_components, seed=seed, max_iter=max_iter, tol=tol)
    del X
    W = res.W.cpu().numpy()
    H = res.H.cpu().numpy()
    adata.obsm[f"X_{key_added}"] = W
    adata.varm[f"{key_added}_components"] = H.T
    var_names = np.asarray(adata.var_names, object)
    top_genes = {f"program_{c + 1}": var_names[np.argsort(-H[c])[:10]].tolist()
                 for c in range(n_components)}
    adata.uns[f"{key_added}_params"] = {
        "n_components": n_components,
        "final_relative_loss": float(res.loss),
        "n_iter": int(res.n_iter),
        "seed": seed,
        "top_genes": top_genes,
    }
    logger.info(f"NMF: {W.shape[0]:,}×{H.shape[1]} → {n_components} "
                f"programs, loss={float(res.loss):.4f} "
                f"({int(res.n_iter)} iters, {time.time() - start:.1f}s)")
    update_metadata(adata, "run_nmf",
                    parameters={"n_components": n_components, "seed": seed,
                                "max_iter": max_iter},
                    outputs={"obsm": f"X_{key_added}",
                             "uns": f"{key_added}_params"})
    return adata


__all__ = ["run_nmf", "nmf_fit", "NMFResult"]
