"""Gene-tile schedule, the streaming global null (Moran's I / Geary's C)
and the streaming local-statistic nulls (local Moran, local Geary,
Getis-Ord, local Lee's L).

Port of ``spatialcore_tpu/ops/streaming.py``: ``tile_widths``,
``streaming_moran_null`` (gene tiles through the banded global null, so
1M cells × 18k genes need one tile's table on the device, not the whole
expression) and ``streaming_local_null`` (gene or gene-pair tiles through
the banded local nulls, each tile's [N, tile] output planes to a sink, so
1M cells × thousands of genes of local nulls never hold the full [N, G]
float32 planes at once).

``streaming_local_null(obs_dtype="bf16")`` is the reference's wide-tile
recipe (keys mode, LISA, int8): each tile keeps only int8 codes, a bf16
copy of Z and the kernel's integer counts, never a float32 [N, tile]
plane.
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


def _prep_chunk(graph, X: torch.Tensor, S0: float, stat: str, precision: str):
    """One prep chunk of :func:`streaming_moran_null`: standardize, den =
    Σz², the observed I (or C), and the null table: int8 codes ("int8"),
    UNPACKED int4 codes ("int4": the tile packs across chunks), else bf16
    Z. Returns (table, den, obs, s)."""
    from .banded import _quantize_z, _quantize_z4_codes
    from .moran import geary_observed, moran_observed, standardize

    Z, _ = standardize(X)
    den = (Z * Z).sum(dim=0)
    den = torch.where(den > 0, den, torch.ones_like(den))
    obs = (moran_observed if stat == "moran" else geary_observed)(graph, Z, S0)
    if precision == "int8":
        Zq, s_z = _quantize_z(Z)
        return Zq, den, obs, s_z
    if precision == "int4":
        codes, s_z = _quantize_z4_codes(Z)
        return codes, den, obs, s_z
    return Z.to(torch.bfloat16), den, obs, torch.ones_like(den)


def streaming_moran_null(
    graph,
    plan,
    get_tile: Callable[[int, int, int], object],
    n_genes: int,
    S0: float,
    seed: int = 0,
    n_permutations: int = 1000,
    tile: int = 2048,
    prep_chunk: int = 1024,
    chunk: int = 200,
    stat: str = "moran",
    alternative: str = "greater",
    band_impl: str = "auto",
    precision: str = "bf16",
    device: Device = "cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Banded Moran/Geary permutation null over a streamed gene axis
    (reference ``streaming_moran_null``, spatialcore_tpu/ops/streaming.py:71).

    ``get_tile(start, width, chunk_index)`` returns the raw [N, width]
    expression of genes [start, start + width) (numpy or a tensor; moved to
    ``device``). Genes go in ``tile_widths(n_genes, tile)`` tiles; each
    tile is prepped in ``prep_chunk``-gene chunks (standardize, den, the
    observed statistic, the null table), then its draws run
    in ``chunk``-draw calls of ``ops.banded.banded_permutation_test``
    keyed by the global draw index (``draw_offset``), with ``band_impl``
    passed through. Draw d of every tile is the same permutation, so the
    output is bitwise the same at any tile or chunk split. Tail columns
    past ``n_genes`` are zero (inert zero-variance genes) and dropped.

    ``precision``: "bf16" (the table is bf16 Z; "f32" runs the same bf16
    table, as the reference), "int8" (per-gene codes; ``tile=4096`` halves
    the bytes of a bf16 tile of the same width) or "int4" (two codes a
    byte: chunk pairs at half-tile offsets pack together, so tile widths
    must be multiples of 256 and, above ``prep_chunk``, hold an even
    chunk count).

    Returns host arrays ``(I_obs, p, null_mean, null_std)`` of length
    ``n_genes`` (``I_obs`` is C for ``stat="geary"``). Peak device memory
    is one tile's table, the plan, and one prep chunk's float32 temps.
    """
    from .banded import _pack_codes, banded_permutation_test

    if stat not in ("moran", "geary"):
        raise ValueError(f"stat must be 'moran' or 'geary', got {stat!r}")
    widths = tile_widths(n_genes, tile)
    if precision == "int4":
        bad = [w for w in widths
               if w % 256 or (w > prep_chunk and w % (2 * prep_chunk))]
        if bad:
            raise ValueError(
                f"precision='int4' needs 256-multiple tile widths that hold "
                f"an even prep-chunk count (split-half nibble packing); "
                f"schedule {widths} at prep_chunk={prep_chunk} violates "
                f"that — use a 512-multiple tile (got {tile})")
    n_cells = graph.neighbor_idx.shape[0]
    quantized = precision in ("int8", "int4")
    outs = ([], [], [], [])
    start = 0
    for w in widths:
        parts = []
        for ci, s in enumerate(range(0, w, prep_chunk)):
            g = min(prep_chunk, w - s)
            avail = max(0, min(g, n_genes - (start + s)))
            if avail > 0:
                X = torch.as_tensor(get_tile(start + s, avail, ci)).to(
                    device=device, dtype=torch.float32)
                if avail < g:      # tail: inert zero-variance columns
                    X = torch.nn.functional.pad(X, (0, g - avail))
            else:
                X = torch.zeros((n_cells, g), dtype=torch.float32, device=device)
            parts.append(_prep_chunk(graph, X, S0, stat, precision))
            del X
        if precision == "int4":
            if len(parts) > 1 and len(parts) % 2:
                raise ValueError(
                    f"precision='int4' tiles above prep_chunk must hold an "
                    f"even chunk count (w % (2*prep_chunk) == 0); got width "
                    f"{w} at prep_chunk={prep_chunk}")
            # half-offset chunk pairs: packed column j pairs gene j with
            # gene j + w/2, without the full-width unpacked code matrix
            h = len(parts) // 2
            Zb = (_pack_codes(parts[0][0]) if len(parts) == 1 else torch.cat(
                [_pack_codes(parts[i][0], parts[i + h][0]) for i in range(h)],
                dim=1))
        else:
            Zb = torch.cat([p[0] for p in parts], dim=1)
        den, obs, szv = (torch.cat([p[i] for p in parts]) for i in (1, 2, 3))
        del parts
        count = torch.zeros(w, dtype=torch.float32, device=Zb.device)
        mean_acc = torch.zeros_like(count)
        m2_acc = torch.zeros_like(count)
        for s in range(0, n_permutations, chunk):
            pc = min(chunk, n_permutations - s)
            p, m, sd = banded_permutation_test(
                plan, Zb, S0, obs, seed=seed, n_permutations=pc, den=den,
                stat=stat, alternative=alternative, band_impl=band_impl,
                precision=precision, sz=szv if quantized else None,
                draw_offset=s)
            count += torch.round(p * (pc + 1.0) - 1.0)
            mean_acc += m * pc
            m2_acc += (sd * sd + m * m) * pc
        del Zb
        P = n_permutations
        mean = mean_acc / P
        res = (obs, (count + 1.0) / (P + 1.0), mean,
               torch.sqrt(torch.clamp_min(m2_acc / P - mean ** 2, 0.0)))
        for lst, arr in zip(outs, res):
            lst.append(arr.cpu().numpy())
        start += w
    return tuple(np.concatenate(parts)[:n_genes] for parts in outs)


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


def _lee_planes(graph, Zx, Zy, p, zero_var, n_permutations: int, fdr: str,
                alpha: float) -> Dict[str, torch.Tensor]:
    """The five local Lee planes of one set of gene pairs: observed L and
    lag(Zy) from one exact pass, p and its per-pair FDR, quadrants of Zx
    against lag(Zy) (the ``lees_l_local`` convention); pairs with a
    zero-variance gene masked to 0 / p 1 / NS."""
    from .fdr import apply_fdr
    from .lee import lees_l_pairs
    from .moran import classify_quadrants

    zv = zero_var[None, :]
    res = lees_l_pairs(graph, Zx, Zy, 0, 0)
    p = torch.where(zv, 1.0, p)
    p_adj = apply_fdr(p, fdr, axis=0, n_levels=n_permutations + 1)
    quad = classify_quadrants(Zx, res.lag_zy, p_adj, alpha)
    return {"L": torch.where(zv, 0.0, res.L_local),
            "lag": torch.where(zv, 0.0, res.lag_zy),
            "p": p, "p_adj": p_adj,
            "quadrant": torch.where(zv, torch.zeros_like(quad), quad)}


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

    Runs LISA (``stat="moran"``), local Geary (``"geary"``), Getis-Ord
    Gi* / Gi (``"getis"``, with ``star`` and ``alternative``) or local
    Lee's L (``"lee"``: ``get_tile`` then returns an ``(X, Y)`` pair of
    tiles, the pairs' x and y genes, and ``n_genes`` counts pairs) in
    ``tile``-wide tiles through the banded nulls (``ops.banded``; int8 by
    default, the Hopper draw-step kernel on the card) and hands each
    tile's [N, tile] outputs to ``sink(start, avail, outs)``. Tiles come
    from ``get_tile(start, width)`` (numpy or tensors) and are moved to
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
    p_sim), hotspot (int8: 1 hot / −1 cold after FDR at ``alpha``, 0 NS);
    lee -> L, lag, p, p_adj, quadrant (Zx against lag(Zy); a pair with a
    zero-variance gene in either tile is masked). Moran, Geary and Lee
    standardize each tile; Getis works on raw values.
    ``keys`` selects the lean path: only the named planes are kept,
    computed ``post_chunk`` gene columns at a time and emitted already in
    the compact dtypes of :data:`_COMPACT_DTYPES`; p-values are the same
    kernel call, bitwise.

    ``obs_dtype="bf16"`` (keys mode, ``stat="moran"``, ``precision="int8"``
    only) is the wide-tile recipe: each tile is standardized 512 genes at a
    time into int8 codes and a bf16 copy of Z, the draw-step kernel returns
    integer counts (``banded_local_moran_pvalues(return_counts=True)``) and
    p = (count + 1)/(P + 1) is formed per post chunk, so no float32 [N,
    tile] plane stays resident. p and p_adj equal the f32-obs run's bitwise
    (the same counts); I, z, lag and quadrants come from the bf16 Z.
    """
    from .banded import (_p_from_counts, _quantize_z, banded_getis,
                         banded_lees_l, banded_local_geary, banded_local_moran,
                         banded_local_moran_pvalues)
    from .moran import standardize

    if stat not in _ALL_KEYS:
        raise ValueError(f"stat must be 'moran', 'geary', 'getis' or 'lee', "
                         f"got {stat!r}")
    if obs_dtype not in ("f32", "bf16"):
        raise ValueError(f"obs_dtype must be 'f32' or 'bf16', got {obs_dtype!r}")
    counts_in = obs_dtype == "bf16"
    if counts_in and (stat != "moran" or precision != "int8" or keys is None):
        raise ValueError("obs_dtype='bf16' is the wide-tile moran recipe: "
                         "requires stat='moran', precision='int8' and "
                         "keys-mode")
    if keys is not None:
        bad = [k for k in keys if k not in _ALL_KEYS[stat]]
        if bad:
            raise ValueError(f"unknown keys {bad} for stat={stat!r}; "
                             f"available: {_ALL_KEYS[stat]}")
    n_cells = graph.neighbor_idx.shape[0]
    c = max(1, post_chunk)

    def p_of(cols):
        """The tile's raw p (p_sim for Getis) from the banded null; ``cols``
        holds the tile (Lee: the (Zx, Zy) pair)."""
        if stat == "lee":
            return banded_lees_l(plan, *cols, seed, n_permutations,
                                 precision=precision,
                                 compute_cell_pvalues=True)[1]
        Z = cols[0]
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

    def planes(cols, p, zero_var):
        if counts_in:        # bf16 Z and integer counts, one column chunk
            cols = (cols[0].to(torch.float32),)
            p = _p_from_counts(p, n_permutations)
        if stat == "lee":
            return _lee_planes(graph, *cols, p, zero_var, n_permutations, fdr,
                               alpha)
        Z = cols[0]
        if stat == "geary":
            return _geary_planes(graph, Z, p, zero_var, n_permutations, fdr)
        if stat == "getis":
            return _getis_planes(graph, Z, p, n_permutations, fdr, alpha, star,
                                 alternative)
        return _moran_planes(graph, Z, p, zero_var, n_permutations, fdr, alpha)

    def load(X):
        return torch.as_tensor(X).to(device=device, dtype=torch.float32)

    def prep_codes(start, avail):
        """The bf16 recipe's tile: int8 codes, a bf16 copy of Z and the
        zero-variance mask, standardized 512 genes at a time, and the
        kernel's integer counts; no float32 [N, tile] plane is kept."""
        parts = []
        for s in range(0, avail, min(512, tile)):
            Zc, zvc = standardize(load(get_tile(start + s,
                                                min(512, tile, avail - s))))
            parts.append((_quantize_z(Zc)[0], Zc.to(torch.bfloat16), zvc))
            del Zc
        Zq, Zb = (torch.cat([p[i] for p in parts], dim=1) for i in (0, 1))
        zero_var = torch.cat([p[2] for p in parts])
        del parts
        cnt = banded_local_moran_pvalues(plan, Zq, seed, n_permutations,
                                         return_counts=True)
        return (Zb,), zero_var, cnt

    def prep(start, avail):
        """(Z columns, zero-variance mask, the tile's raw p)."""
        if counts_in:
            return prep_codes(start, avail)
        tiles = get_tile(start, avail)
        if stat == "lee":               # Z: the (Zx, Zy) pair of tiles
            if not (isinstance(tiles, (tuple, list)) and len(tiles) == 2):
                raise ValueError("stat='lee' needs get_tile to return an "
                                 "(X, Y) pair of tiles")
            (Zx, zvx), (Zy, zvy) = (standardize(load(t)) for t in tiles)
            Z, zero_var = (Zx, Zy), zvx | zvy
            del Zx, Zy
        elif stat == "getis":
            Z, zero_var = (load(tiles),), None
        else:
            Zs, zero_var = standardize(load(tiles))
            Z = (Zs,)
            del Zs
        del tiles
        return Z, zero_var, p_of(Z)

    for start in range(0, n_genes, tile):
        avail = min(tile, n_genes - start)
        Z, zero_var, p_raw = prep(start, avail)
        Z_dev = Z[0].device
        if keys is None:
            outs = planes(Z, p_raw, zero_var)
        else:
            outs = {k: torch.empty((n_cells, avail), dtype=_COMPACT_DTYPES[k],
                                   device=Z_dev) for k in keys}
            for s in range(0, avail, c):
                part = planes(tuple(t[:, s:s + c] for t in Z), p_raw[:, s:s + c],
                              None if zero_var is None else zero_var[s:s + c])
                for k in keys:
                    outs[k][:, s:s + c] = part[k].to(_COMPACT_DTYPES[k])
                del part
        del Z, p_raw
        if Z_dev.type == "cuda":
            torch.cuda.synchronize(Z_dev)   # one host wait per tile
        sink(start, avail, outs)
        del outs
