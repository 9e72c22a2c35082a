"""Gene-tile schedule shared by the streaming driver and the benchmarks.

Port of ``tile_widths`` from ``spatialcore_tpu/ops/streaming.py:46-68``;
the streaming null itself is not ported yet (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations


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
