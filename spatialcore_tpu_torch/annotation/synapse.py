"""Synapse.org downloads (gated on the optional synapseclient SDK).

Port of ``spatialcore_tpu/annotation/synapse.py`` (host Python, so a
copy): token auth, entity download and folder listing. The keyword
spellings ``synapse_id``, ``auth_token`` and ``output_dir`` are accepted
as aliases of this module's names.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Union

from ..core.compat import param_aliases
from ..core.logging import get_logger

logger = get_logger("annotation.synapse")

SYNAPSE_TOKEN_ENV = "SYNAPSE_AUTH_TOKEN"


def _require_synapse():
    try:
        import synapseclient

        return synapseclient
    except ImportError as e:
        raise ImportError(
            "Synapse access requires the optional 'synapseclient' "
            "dependency (network access needed). Download the entity "
            "manually and pass a local path instead.") from e


def _login(token: Optional[str] = None):
    synapseclient = _require_synapse()
    token = token or os.environ.get(SYNAPSE_TOKEN_ENV)
    if not token:
        raise ValueError(
            f"Synapse auth token required: set {SYNAPSE_TOKEN_ENV} or pass "
            "token=...")
    syn = synapseclient.Synapse()
    syn.login(authToken=token, silent=True)
    return syn


def _name_matches(name: str, file_types: Optional[List[str]]) -> bool:
    return file_types is None or any(name.endswith(t) for t in file_types)


@param_aliases(synapse_id="entity_id", auth_token="token",
               output_dir="output_path")
def download_synapse_reference(
    entity_id: str,
    output_path: Union[str, Path],
    token: Optional[str] = None,
    force: bool = False,
) -> Path:
    """Download one Synapse entity (syn12345678) to ``output_path``.

    ``force=False`` skips the download when the target already exists.
    """
    out = Path(output_path)
    if out.exists() and not force:
        logger.info(f"Synapse target exists, skipping: {out}")
        return out
    syn = _login(token)
    out.parent.mkdir(parents=True, exist_ok=True)
    logger.info(f"Synapse download {entity_id} → {out}")
    entity = syn.get(entity_id, downloadLocation=str(out.parent))
    got = Path(entity.path)
    if got != out:
        got.rename(out)
    return out


@param_aliases(auth_token="token")
def list_synapse_folder(
    folder_id: str,
    token: Optional[str] = None,
    file_types: Optional[List[str]] = None,
) -> List[dict]:
    """List child entities (id, name, type) of a Synapse folder,
    optionally filtered by filename suffixes."""
    syn = _login(token)
    return [{"id": c["id"], "name": c["name"], "type": c["type"]}
            for c in syn.getChildren(folder_id)
            if _name_matches(c["name"], file_types)]


@param_aliases(auth_token="token")
def download_synapse_folder(
    folder_id: str,
    output_dir: Union[str, Path],
    token: Optional[str] = None,
    file_types: Optional[List[str]] = None,
    force: bool = False,
    pattern: Optional[str] = None,
) -> List[Path]:
    """Download all matching files in a folder.

    ``file_types`` filters by suffix; ``pattern`` is a substring filter.
    """
    syn = _login(token)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths = []
    for child in syn.getChildren(folder_id):
        name = child["name"]
        if not _name_matches(name, file_types):
            continue
        if pattern is not None and pattern not in name:
            continue
        target = out / name
        if target.exists() and not force:
            paths.append(target)
            continue
        entity = syn.get(child["id"], downloadLocation=str(out))
        paths.append(Path(entity.path))
    logger.info(f"Downloaded {len(paths)} files from {folder_id}")
    return paths


@param_aliases(auth_token="token")
def authenticate_synapse(token: Optional[str] = None):
    """Login and return the Synapse client."""
    return _login(token)


@param_aliases(synapse_id="entity_id", auth_token="token")
def get_synapse_entity_info(entity_id: str, token: Optional[str] = None) -> dict:
    """Name/type/size metadata for a Synapse entity without downloading."""
    syn = _login(token)
    e = syn.get(entity_id, downloadFile=False)
    return {"id": entity_id, "name": getattr(e, "name", None),
            "type": type(e).__name__,
            "size": getattr(e, "fileSize", None)}
