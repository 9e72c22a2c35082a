"""Canonical marker-gene sets for marker-based validation.

Port of ``spatialcore_tpu/annotation/markers.py`` (pure Python): the
bundled table is a copy of the reference's
(``spatialcore_tpu_torch/data/markers/canonical_markers.json``, wrapped
format ``{"metadata", "markers"}``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Union

from ..core.compat import param_aliases
from ..core.logging import get_logger

logger = get_logger("annotation.markers")

_BUILTIN = Path(__file__).parent.parent / "data" / "markers" / \
    "canonical_markers.json"


@param_aliases(config_path="path")
def load_canonical_markers(
    path: Optional[Union[str, Path]] = None,
) -> Dict[str, List[str]]:
    """Cell type → marker gene list; accepts wrapped or bare JSON."""
    path = Path(path) if path else _BUILTIN
    with open(path) as f:
        data = json.load(f)
    markers = data.get("markers", data)
    if not isinstance(markers, dict):
        raise ValueError(f"Marker file {path} is not a mapping")
    out = {str(k): [str(g) for g in v] for k, v in markers.items()}
    logger.info(f"Loaded markers for {len(out)} cell types from {path.name}")
    return out


def get_markers_for_type(cell_type: str,
                         markers: Optional[Dict[str, List[str]]] = None
                         ) -> List[str]:
    """Markers for one type; case-insensitive exact match, [] if unknown."""
    markers = markers or load_canonical_markers()
    if cell_type in markers:
        return markers[cell_type]
    low = {k.lower(): v for k, v in markers.items()}
    return low.get(cell_type.lower(), [])


def list_available_cell_types(markers=None, path=None):
    """Cell types with defined markers: from a marker dict, a path to a
    marker JSON (also accepted positionally), or the bundled table."""
    if isinstance(markers, (str, Path)):
        markers, path = None, markers
    if markers is None:
        markers = load_canonical_markers(path)
    return sorted(markers)


_NON_TYPES = {"Unassigned", "Unknown", "unknown", "cell", "", None}


@param_aliases(cell_type="label")
def match_to_canonical(
    label: str,
    markers: Optional[Dict[str, List[str]]] = None,
) -> Optional[str]:
    """Exact case-insensitive match of a label to a canonical marker type;
    None when unmatched (no fuzzy matching, by design)."""
    if label in _NON_TYPES:
        return None
    if markers is None:
        markers = load_canonical_markers()
    low = str(label).lower().strip()
    for canonical in markers:
        if canonical.lower() == low:
            return canonical
    return None
