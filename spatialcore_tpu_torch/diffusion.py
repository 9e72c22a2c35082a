"""Graph diffusion: expression smoothing and diffusion-map embeddings.

Port of ``spatialcore_tpu/diffusion.py`` (``smooth_expression`` :39-95,
``diffusion_map`` :98-162) on the fixed-degree spatial graph: every
operation is a sequence of ``spatial_lag`` gathers (``ops.graph``), so no
N×N matrix is formed; the diffusion-map eigenvectors come from orthogonal
(subspace) iteration with a tall-skinny QR (``torch.linalg.qr``) on the
card. The start block is ``normal(key_for(seed, "diffmap"))``
(``core/rng.normal``, the reference's draws). The QR's signs and rounding
are the library's, so the embedding agrees with the reference's up to the
sign of each eigenvector, within a tolerance; the eigenvalues agree.
"""

from __future__ import annotations

import time
from typing import Optional, Union

import numpy as np
import torch

from .core.compat import full_f32_matmul
from .core.container import dense_f32
from .core.logging import get_logger
from .core.metadata import update_metadata
from .core.rng import key_for, normal
from .ops.graph import spatial_lag

logger = get_logger("diffusion")

Device = Union[str, torch.device]


def _get_graph(adata, n_neighbors, spatial_key, device: Device):
    from .spatial.autocorrelation import _load_stored_graph, build_spatial_weights

    g = _load_stored_graph(adata, device)
    if g is not None:
        return g
    return build_spatial_weights(adata, n_neighbors=n_neighbors,
                                 spatial_key=spatial_key, device=device)


def smooth_expression(
    adata,
    n_steps: int = 3,
    alpha: float = 0.5,
    genes=None,
    layer: Optional[str] = None,
    n_neighbors: int = 6,
    spatial_key: str = "spatial",
    key_added: str = "diffused",
    copy: bool = False,
    device: Device = "cuda",
):
    """Graph-diffusion smoothing: X ← (1−α)·X + α·W·X, ``n_steps`` times.

    Writes the smoothed matrix to ``layers[key_added]`` (or
    ``obsm[key_added]`` when a gene subset is given): a tensor on the card
    where X is a CUDA tensor, else numpy. The steps run on ``device``.
    """
    start = time.time()
    if copy:
        adata = adata.copy()
    if not (0.0 < alpha <= 1.0):
        raise ValueError(f"alpha must be in (0, 1], got {alpha}")
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    graph = _get_graph(adata, n_neighbors, spatial_key, device)

    cols = None
    if genes is not None:
        cols = adata.var_names.get_indexer(list(genes))
        if (cols < 0).any():
            raise ValueError("Some genes not found in var_names")
    X = adata.layers[layer] if layer else adata.X
    Y = dense_f32(X, device, cols=cols)
    for _ in range(n_steps):
        Y = (1.0 - alpha) * Y + alpha * spatial_lag(graph, Y)
    if not (isinstance(X, torch.Tensor) and X.is_cuda):
        Y = Y.cpu().numpy()
    if genes is not None:
        adata.obsm[key_added] = Y
        adata.uns[f"{key_added}_genes"] = list(genes)
        where = {"obsm": key_added}
    else:
        adata.layers[key_added] = Y
        where = {"layers": key_added}
    logger.info(f"smooth_expression: {n_steps} steps, alpha={alpha} "
                f"({time.time() - start:.1f}s)")
    update_metadata(adata, "smooth_expression",
                    parameters={"n_steps": n_steps, "alpha": alpha,
                                "n_neighbors": n_neighbors}, outputs=where)
    return adata


def diffusion_map(
    adata,
    n_components: int = 10,
    n_iter: int = 60,
    n_neighbors: int = 15,
    spatial_key: str = "spatial",
    seed: int = 0,
    key_added: str = "X_diffmap",
    copy: bool = False,
    device: Device = "cuda",
):
    """Diffusion-map embedding of the spatial graph (gathers only).

    Top eigenvectors of the row-stochastic transition operator W by
    orthogonal iteration, Q ← QR(W·Q), each step k gathers and an [N, m]
    QR on ``device``. The constant (trivial) mode is projected out;
    ``obsm[key_added]`` gets the eigenvectors scaled by their eigenvalues,
    ``uns`` the eigenvalue spectrum.
    """
    start = time.time()
    if copy:
        adata = adata.copy()
    graph = _get_graph(adata, n_neighbors, spatial_key, device)
    dev = graph.neighbor_idx.device

    def deflate(Y):
        # remove the trivial stationary mode (the global constant)
        return Y - Y.mean(dim=0, keepdim=True)

    Q = deflate(normal(key_for(seed, "diffmap"), (adata.n_obs, n_components),
                       device=dev))
    with full_f32_matmul():
        Q = torch.linalg.qr(Q).Q
        for _ in range(n_iter):
            Q = torch.linalg.qr(deflate(spatial_lag(graph, Q))).Q
        B = Q.T @ deflate(spatial_lag(graph, Q))
    # Rayleigh-Ritz on the small, possibly nonsymmetric projected operator
    # separates near-degenerate eigenspaces (one λ≈1 mode per connected
    # component) that plain orthogonal iteration leaves mixed.
    w, V = np.linalg.eig(B.cpu().numpy())
    order = np.argsort(-np.abs(w.real))
    evals = w.real[order]
    with full_f32_matmul():
        vecs = Q @ torch.as_tensor(V.real[:, order], device=dev)
    vecs = vecs / torch.clamp_min(torch.linalg.norm(vecs, dim=0, keepdim=True),
                                  1e-12)
    emb = vecs * torch.as_tensor(evals, device=dev)[None, :]
    adata.obsm[key_added] = emb.cpu().numpy()
    adata.uns[f"{key_added}_evals"] = evals.tolist()
    logger.info(f"diffusion_map: {n_components} components, "
                f"λ₁={evals[0]:.4f} ({time.time() - start:.1f}s)")
    update_metadata(adata, "diffusion_map",
                    parameters={"n_components": n_components,
                                "n_iter": n_iter,
                                "n_neighbors": n_neighbors, "seed": seed},
                    outputs={"obsm": key_added})
    return adata


__all__ = ["smooth_expression", "diffusion_map"]
