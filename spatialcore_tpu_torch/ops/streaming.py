"""Gene-tile schedule, and the streaming local-statistic nulls (local
Moran, local Geary, Getis-Ord).

Port of ``tile_widths`` and of the local Moran, local Geary and Getis-Ord
parts of ``streaming_local_null`` (``spatialcore_tpu/ops/streaming.py:46-68,
279-745``): gene tiles flow through the banded local nulls and each tile's
[N, tile] output planes go to a sink, so 1M cells × thousands of genes of
local nulls never hold the full [N, G] float32 planes at once.

Not ported yet (``NotImplementedError``, ROADMAP Queue 1 item 10): the
``stat`` "lee", which comes with K7's lee tail, and ``obs_dtype="bf16"``,
the wide-tile recipe that fits a 16 GB chip by keeping only int8 codes and
a bf16 copy of Z per tile.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

#: compact device dtypes of the local outputs: p as float16 keeps a
#: 1/(P+1)-grained value to < 0.1%, quadrant is categorical, observed
#: statistics downcast to bf16 (the precision class of the int8 null)
_COMPACT_DTYPES = {
    "I": torch.bfloat16, "z": torch.bfloat16, "lag": torch.bfloat16,
    "C": torch.bfloat16, "G": torch.bfloat16, "z_score": torch.bfloat16,
    "L": torch.bfloat16,
    "p": torch.float16, "p_adj": torch.float16, "p_sim": torch.float16,
    "quadrant": torch.int8, "hotspot": torch.int8,
}

_ALL_KEYS = {"moran": ("I", "z", "lag", "p", "p_adj", "quadrant"),
             "geary": ("C", "p", "p_adj"),
             "getis": ("G", "z_score", "p", "p_sim", "p_adj", "hotspot"),
             "lee": ("L", "lag", "p", "p_adj", "quadrant")}

Device = Union[str, torch.device]


def tile_widths(n_genes: int, tile: int) -> list:
    """Tile-quantized gene schedule.

    Full ``tile``-wide tiles; a tail next to full tiles rounds up to the
    full tile (the per-draw row gather costs about the same at any width,
    so one tile width serves every call); a lone tail uses tile/2 when it
    fits.
    """
    widths = []
    rem = n_genes
    while rem > 0:
        if rem >= tile:
            widths.append(tile)
            rem -= tile
        elif widths:
            widths.append(tile)
            rem = 0
        else:
            widths.append(tile // 2 if rem <= tile // 2 else tile)
            rem = 0
    return widths


def host_local_sink(n_cells: int, n_genes: int):
    """(sink, store) pair flushing each tile's outputs to host numpy.

    The store maps key -> [N, n_genes] float32 (int8 for quadrants) numpy
    arrays, allocated on the first tile.
    """
    store: Dict[str, np.ndarray] = {}

    def sink(start: int, avail: int, outs: Dict[str, torch.Tensor]) -> None:
        for key, arr in outs.items():
            if key not in store:
                dt = np.int8 if key == "quadrant" else np.float32
                fill = np.ones if key.startswith("p") else np.zeros
                store[key] = fill((n_cells, n_genes), dt)
            store[key][:, start:start + avail] = (
                arr[:, :avail].cpu().numpy().astype(store[key].dtype))

    return sink, store


def device_local_sink(n_genes: int, keys: Optional[tuple] = None):
    """(sink, finalize) pair keeping outputs on the device in compact dtypes
    (:data:`_COMPACT_DTYPES`).

    ``keys`` limits what is kept; ``None`` keeps everything the statistic
    produces. ``finalize()`` returns the concatenated [N, n_genes] tensors,
    freeing the per-tile parts as they are consumed.
    """
    parts: Dict[str, list] = {}

    def sink(start: int, avail: int, outs: Dict[str, torch.Tensor]) -> None:
        for key, arr in outs.items():
            if keys is not None and key not in keys:
                continue
            dt = _COMPACT_DTYPES.get(key, torch.bfloat16)
            parts.setdefault(key, []).append(arr[:, :avail].to(dt))

    def finalize() -> Dict[str, torch.Tensor]:
        out = {}
        for key in list(parts):
            cols = parts.pop(key)
            out[key] = cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)
            cols.clear()
        return out

    return sink, finalize


def _moran_planes(graph, Z, p, zero_var, n_permutations: int, fdr: str,
                  alpha: float) -> Dict[str, torch.Tensor]:
    """The six LISA output planes of one set of gene columns: observed
    I/z/lag from one exact lag pass, p and its per-gene FDR, quadrants;
    zero-variance genes masked to 0 / p 1 / NS."""
    from .fdr import apply_fdr
    from .moran import classify_quadrants, local_moran

    zv = zero_var[None, :]
    obs = local_moran(graph, Z, 0, 0)
    p = torch.where(zv, 1.0, p)
    p_adj = apply_fdr(p, fdr, axis=0, n_levels=n_permutations + 1)
    quad = classify_quadrants(obs.z, obs.lag, p_adj, alpha)
    return {"I": torch.where(zv, 0.0, obs.local_I),
            "z": torch.where(zv, 0.0, obs.z),
            "lag": torch.where(zv, 0.0, obs.lag),
            "p": p, "p_adj": p_adj,
            "quadrant": torch.where(zv, torch.zeros_like(quad), quad)}


def _geary_planes(graph, Z, p, zero_var, n_permutations: int, fdr: str
                  ) -> Dict[str, torch.Tensor]:
    """The three local Geary planes of one set of gene columns: observed C
    from one exact pass, p and its per-gene FDR; zero-variance genes
    masked to 0 / p 1."""
    from .fdr import apply_fdr
    from .moran import local_geary

    zv = zero_var[None, :]
    p = torch.where(zv, 1.0, p)
    return {"C": torch.where(zv, 0.0, local_geary(graph, Z, 0, 0).local_C),
            "p": p,
            "p_adj": apply_fdr(p, fdr, axis=0, n_levels=n_permutations + 1)}


def _getis_planes(graph, X, p_sim, n_permutations: int, fdr: str, alpha: float,
                  star: bool, alternative: str) -> Dict[str, torch.Tensor]:
    """The six Getis-Ord planes of one set of raw gene columns: observed G,
    z and analytic p from one exact pass, p_sim and its per-gene FDR, and
    the hotspot code (1 hot / −1 cold where p_adj < alpha, else 0)."""
    from .fdr import apply_fdr
    from .getis import getis_ord

    obs = getis_ord(graph, X, star=star, alternative=alternative)
    p_adj = apply_fdr(p_sim, fdr, axis=0, n_levels=n_permutations + 1)
    hot = torch.where(p_adj < alpha, torch.sign(obs.z_score).to(torch.int8),
                      torch.zeros((), dtype=torch.int8, device=X.device))
    return {"G": obs.G, "z_score": obs.z_score, "p": obs.p_value,
            "p_sim": p_sim, "p_adj": p_adj, "hotspot": hot}


def streaming_local_null(
    graph,
    plan,
    get_tile: Callable[[int, int], object],
    n_genes: int,
    sink: Callable[[int, int, Dict[str, torch.Tensor]], None],
    stat: str = "moran",
    seed: int = 0,
    n_permutations: int = 100,
    tile: int = 512,
    fdr: str = "fdr_bh",
    alpha: float = 0.05,
    star: bool = True,
    alternative: str = "two-sided",
    precision: str = "int8",
    keys: Optional[Tuple[str, ...]] = None,
    post_chunk: int = 128,
    obs_dtype: str = "f32",
    device: Device = "cuda",
) -> None:
    """Local-statistic permutation nulls over a streamed gene axis.

    Runs LISA (``stat="moran"``), local Geary (``"geary"``) or Getis-Ord
    Gi* / Gi (``"getis"``, with ``star`` and ``alternative``) in
    ``tile``-wide gene tiles through the banded nulls (``ops.banded``; int8
    by default, the Hopper draw-step kernel on the card) and hands each
    tile's [N, tile] outputs to ``sink(start, avail, outs)``. Tiles come
    from ``get_tile(start, width)`` (numpy or a tensor) and are moved to
    ``device``.

    * the last tile is as wide as the genes left (the reference pads it to
      ``tile`` so one compiled program serves every tile; eager PyTorch
      compiles nothing, and every output is per gene, so an unpadded tile
      gives exactly the columns a full-width batch of the same genes does);
    * draw d of every tile uses the permutation keyed by (seed, d), so
      results do not depend on the tile split;
    * the per-gene FDR (axis 0) is tile-separable and computed on device;
    * the host waits once per tile, which bounds the memory in flight.

    Output keys: moran -> I, z, lag, p, p_adj, quadrant; geary -> C, p,
    p_adj; getis -> G, z_score, p (analytic), p_sim, p_adj (BH over
    p_sim), hotspot (int8: 1 hot / −1 cold after FDR at ``alpha``, 0 NS).
    Moran and Geary standardize each tile; Getis works on raw values.
    ``keys`` selects the lean path: only the named planes are kept,
    computed ``post_chunk`` gene columns at a time and emitted already in
    the compact dtypes of :data:`_COMPACT_DTYPES`; p-values are the same
    kernel call, bitwise.
    """
    from .banded import (banded_getis, banded_local_geary, banded_local_moran,
                         banded_local_moran_pvalues)
    from .moran import standardize

    if stat not in _ALL_KEYS:
        raise ValueError(f"stat must be 'moran', 'geary', 'getis' or 'lee', "
                         f"got {stat!r}")
    if stat == "lee":
        raise NotImplementedError(
            "streaming_local_null(stat='lee') is not ported yet (ROADMAP "
            "Queue 1 item 10: Lee's L comes with K7's lee tail)")
    if obs_dtype not in ("f32", "bf16"):
        raise ValueError(f"obs_dtype must be 'f32' or 'bf16', got {obs_dtype!r}")
    if obs_dtype == "bf16":
        raise NotImplementedError(
            "obs_dtype='bf16' (the wide-tile recipe for a 16 GB chip) is not "
            "ported yet (ROADMAP Queue 1 item 10)")
    if keys is not None:
        bad = [k for k in keys if k not in _ALL_KEYS[stat]]
        if bad:
            raise ValueError(f"unknown keys {bad} for stat={stat!r}; "
                             f"available: {_ALL_KEYS[stat]}")
    n_cells = graph.neighbor_idx.shape[0]
    c = max(1, post_chunk)

    def p_of(Z):
        """The tile's raw p (p_sim for Getis) from the banded null."""
        if stat == "geary":
            return banded_local_geary(plan, Z, seed, n_permutations,
                                      precision=precision)[1]
        if stat == "getis":
            return banded_getis(plan, Z, seed, n_permutations, star=star,
                                alternative=alternative, precision=precision)
        if precision == "int8":
            return banded_local_moran_pvalues(plan, Z, seed, n_permutations)
        return banded_local_moran(plan, graph, Z, seed, n_permutations,
                                  precision=precision).p_value

    def planes(Z, p, zero_var):
        if stat == "geary":
            return _geary_planes(graph, Z, p, zero_var, n_permutations, fdr)
        if stat == "getis":
            return _getis_planes(graph, Z, p, n_permutations, fdr, alpha, star,
                                 alternative)
        return _moran_planes(graph, Z, p, zero_var, n_permutations, fdr, alpha)

    for start in range(0, n_genes, tile):
        avail = min(tile, n_genes - start)
        X = torch.as_tensor(get_tile(start, avail)).to(device=device,
                                                       dtype=torch.float32)
        if stat == "getis":
            Z, zero_var = X, None
        else:
            Z, zero_var = standardize(X)
        del X
        Z_dev = Z.device
        p_raw = p_of(Z)
        if keys is None:
            outs = planes(Z, p_raw, zero_var)
        else:
            outs = {k: torch.empty((n_cells, avail), dtype=_COMPACT_DTYPES[k],
                                   device=Z.device) for k in keys}
            for s in range(0, avail, c):
                part = planes(Z[:, s:s + c], p_raw[:, s:s + c],
                              None if zero_var is None else zero_var[s:s + c])
                for k in keys:
                    outs[k][:, s:s + c] = part[k].to(_COMPACT_DTYPES[k])
                del part
        del Z, p_raw
        if Z_dev.type == "cuda":
            torch.cuda.synchronize(Z_dev)   # one host wait per tile
        sink(start, avail, outs)
        del outs
