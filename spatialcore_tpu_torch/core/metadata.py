"""Provenance ledger stored in ``uns["spatialcore_metadata"]``.

Port of ``spatialcore_tpu/core/metadata.py`` (``update_metadata`` and the
parameter serializer it needs): each public operation appends a record
with timestamp, function, parameters, outputs and package version.
"""

from __future__ import annotations

import json
from datetime import datetime, timezone
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

METADATA_KEY = "spatialcore_metadata"


def _serialize_param(value: Any) -> Any:
    """Make a parameter JSON-friendly (Path → str, arrays → lists, etc.)."""
    if isinstance(value, Path):
        return str(value)
    if isinstance(value, np.integer):
        return int(value)
    if isinstance(value, np.floating):
        return float(value)
    if isinstance(value, np.ndarray):
        return value.tolist() if value.size <= 64 else f"<array shape={value.shape}>"
    if isinstance(value, (list, tuple)):
        return [_serialize_param(v) for v in value]
    if isinstance(value, dict):
        return {str(k): _serialize_param(v) for k, v in value.items()}
    if hasattr(value, "n_obs") and hasattr(value, "n_vars"):  # container
        return f"<SpatialData {value.n_obs}x{value.n_vars}>"
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    return repr(value)


def update_metadata(
    adata,
    function_name: str,
    parameters: Optional[Dict[str, Any]] = None,
    outputs: Optional[Dict[str, Any]] = None,
) -> None:
    """Append one operation record to ``adata.uns['spatialcore_metadata']``."""
    from spatialcore_tpu_torch import __version__

    op = {
        "timestamp": datetime.now(timezone.utc).isoformat(),
        "function": function_name,
        "parameters": _serialize_param(parameters or {}),
        "outputs": _serialize_param(outputs or {}),
        "version": __version__,
    }
    meta = adata.uns.setdefault(METADATA_KEY, {"operations": []})
    if isinstance(meta, str):
        # ledger JSON-stringified for h5ad and reopened: restore first
        meta = json.loads(meta)
        adata.uns[METADATA_KEY] = meta
    meta.setdefault("operations", []).append(op)


def get_operations(adata) -> list:
    """Return the list of recorded operations (empty if none)."""
    meta = adata.uns.get(METADATA_KEY, {})
    if isinstance(meta, str):
        meta = json.loads(meta)
    return list(meta.get("operations", []))
