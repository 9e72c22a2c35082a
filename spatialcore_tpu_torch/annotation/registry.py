"""Model registry: named model artifacts resolvable from local dirs or URIs.

Port of ``spatialcore_tpu/annotation/registry.py``. The distributable
artifact is the ``.npz`` + sidecar JSON that :meth:`CellTypeModel.save`
writes in either package; the registry maps model NAMES (the strings in
``TISSUE_MODEL_PRESETS``) to artifact URIs (local paths, ``file://``,
``gs://``, ``s3://``), resolved through
:func:`annotation.acquisition.resolve_uri_to_local` with caching. The
default models directory and registry file are the reference's, so models
it published resolve here too.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Union

from ..core.logging import get_logger
from .model import CellTypeModel

logger = get_logger("annotation.registry")

DEFAULT_MODELS_DIR = Path.home() / ".spatialcore_tpu" / "models"
REGISTRY_PATH = Path.home() / ".spatialcore_tpu" / "model_registry.json"


def load_registry(path: Optional[Union[str, Path]] = None) -> Dict[str, str]:
    """{model name → artifact URI}; empty when no registry file exists."""
    p = Path(path) if path else REGISTRY_PATH
    if not p.exists():
        return {}
    with open(p) as f:
        reg = json.load(f)
    if not isinstance(reg, dict):
        raise ValueError(f"Registry {p} must be a JSON object of name→URI")
    return {str(k): str(v) for k, v in reg.items()}


def register_model(name: str, uri: str,
                   path: Optional[Union[str, Path]] = None) -> None:
    """Add/overwrite a name→URI entry in the registry file."""
    p = Path(path) if path else REGISTRY_PATH
    reg = load_registry(p)
    reg[name] = uri
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "w") as f:
        json.dump(reg, f, indent=2, sort_keys=True)
    logger.info(f"Registered model '{name}' → {uri}")


def publish_model(
    model: CellTypeModel,
    name: str,
    models_dir: Optional[Union[str, Path]] = None,
    registry_path: Optional[Union[str, Path]] = None,
) -> Path:
    """Save a model under ``name`` and register it: writes
    ``<models_dir>/<name>.npz`` (+ sidecar JSON) and records its location
    so ``annotate_cells(models=name)`` resolves it."""
    d = Path(models_dir) if models_dir else DEFAULT_MODELS_DIR
    path = model.save(d / name)
    register_model(name, str(path), path=registry_path)
    return path


def resolve_model(
    name_or_uri: Union[str, Path],
    models_dir: Optional[Union[str, Path]] = None,
    registry_path: Optional[Union[str, Path]] = None,
) -> CellTypeModel:
    """Resolve a model name/path/URI to a loaded :class:`CellTypeModel`.

    Order: explicit path → ``<models_dir>/<name>.npz`` → registry URI
    (downloaded and cached via ``resolve_uri_to_local``). Raises
    ``FileNotFoundError`` with the publishing recipe otherwise.
    """
    m = str(name_or_uri)
    d = Path(models_dir) if models_dir else DEFAULT_MODELS_DIR
    p = Path(m)
    if "://" not in m:
        if p.exists() or p.with_suffix(".npz").exists():
            return CellTypeModel.load(p)
        cand = d / f"{m}.npz"
        if cand.exists():
            return CellTypeModel.load(cand)
    uri = m if "://" in m else load_registry(registry_path).get(m)
    if uri:
        from .acquisition import resolve_uri_to_local

        return CellTypeModel.load(resolve_uri_to_local(uri))
    raise FileNotFoundError(
        f"Model '{m}' not found: no file at '{p}', no artifact at "
        f"'{d / (m + '.npz')}', and no registry entry in "
        f"'{Path(registry_path) if registry_path else REGISTRY_PATH}'. "
        "Publish a trained model with annotation.publish_model(model, "
        "name), or register a remote artifact with "
        "annotation.register_model(name, 'gs://...npz').")
