"""Provenance ledger stored in ``uns["spatialcore_metadata"]``.

Port of ``spatialcore_tpu/core/metadata.py``: each public operation
appends a record with timestamp, function, parameters, outputs and package
version (this package's ``__version__``), and ``prepare_metadata_for_h5ad``
JSON-stringifies the ledger so it round-trips through HDF5.
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


class MetadataTracker:
    """Accumulates operation records and flushes them onto a container.

    ``MetadataTracker(adata, json_path)`` initializes the uns ledger on
    construction, ``record`` appends straight to the bound adata, and
    ``json_path`` mirrors the ledger to disk on every flush. The unbound
    form (no arguments) accumulates records for a later explicit
    ``flush(adata)``.
    """

    def __init__(self, adata=None, json_path=None) -> None:
        self.operations = []
        self.adata = adata
        self.json_path = Path(json_path) if json_path else None
        if adata is not None:
            meta = adata.uns.setdefault(METADATA_KEY, {
                "created": datetime.now(timezone.utc).isoformat(),
                "operations": [],
            })
            if isinstance(meta, str):
                adata.uns[METADATA_KEY] = json.loads(meta)
            elif not isinstance(meta.get("operations", []), list):
                meta["operations"] = list(meta["operations"])

    def record(
        self,
        function_name: str,
        parameters: Optional[Dict[str, Any]] = None,
        outputs: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        from spatialcore_tpu_torch import __version__

        op = {
            "timestamp": datetime.now(timezone.utc).isoformat(),
            "function": function_name,
            "parameters": _serialize_param(parameters or {}),
            "outputs": _serialize_param(outputs or {}),
            "version": __version__,
        }
        self.operations.append(op)
        if self.adata is not None:
            self.flush(self.adata)
        return op

    def flush(self, adata=None) -> None:
        if adata is None:
            adata = self.adata
        if adata is None:
            raise ValueError("flush() needs an adata (none bound)")
        meta = adata.uns.setdefault(METADATA_KEY, {"operations": []})
        if isinstance(meta, str):
            # ledger JSON-stringified for h5ad and the file reopened:
            # restore before appending
            meta = json.loads(meta)
            adata.uns[METADATA_KEY] = meta
        meta.setdefault("operations", []).extend(self.operations)
        self.operations = []
        if self.json_path is not None:
            self.json_path.parent.mkdir(parents=True, exist_ok=True)
            self.json_path.write_text(json.dumps(meta, indent=2, default=str))


def update_metadata(
    adata,
    function_name: str,
    parameters: Optional[Dict[str, Any]] = None,
    outputs: Optional[Dict[str, Any]] = None,
) -> None:
    """Append one operation record to ``adata.uns['spatialcore_metadata']``."""
    tracker = MetadataTracker()
    tracker.record(function_name, parameters, outputs)
    tracker.flush(adata)


def get_operations(adata) -> list:
    """Return the list of recorded operations (empty if none)."""
    meta = adata.uns.get(METADATA_KEY, {})
    if isinstance(meta, str):
        meta = json.loads(meta)
    return list(meta.get("operations", []))


def prepare_metadata_for_h5ad(adata) -> None:
    """JSON-stringify the ledger in place so it survives HDF5 serialization."""
    if METADATA_KEY in adata.uns and not isinstance(adata.uns[METADATA_KEY], str):
        adata.uns[METADATA_KEY] = json.dumps(adata.uns[METADATA_KEY])


def restore_metadata_from_h5ad(adata) -> None:
    """Inverse of :func:`prepare_metadata_for_h5ad`."""
    if METADATA_KEY in adata.uns and isinstance(adata.uns[METADATA_KEY], str):
        adata.uns[METADATA_KEY] = json.loads(adata.uns[METADATA_KEY])
