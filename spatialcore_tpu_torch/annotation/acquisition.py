"""Reference acquisition: URI → local file with caching.

Port of ``spatialcore_tpu/annotation/acquisition.py``
(``resolve_uri_to_local``, ``acquire_reference`` and the cloud transfers;
host Python, so a copy). Cloud SDKs (gcsfs, boto3, cellxgene-census,
synapseclient) are optional: local paths and ``file://`` URIs always work;
cloud schemes raise a clear error naming the missing dependency when the
SDK (or the network) is unavailable. ``synapse://`` and ``cellxgene://``
route through the ``synapse`` and ``cellxgene`` clients.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Optional, Union

from ..core.compat import param_aliases
from ..core.logging import get_logger

logger = get_logger("annotation.acquisition")

DEFAULT_CACHE_DIR = Path.home() / ".spatialcore_tpu" / "cache" / "references"


def _require(module: str, scheme: str):
    try:
        return __import__(module)
    except ImportError as e:
        raise ImportError(
            f"URI scheme '{scheme}://' requires the optional dependency "
            f"'{module}', which is not installed. Install it or download "
            "the file manually and pass a local path.") from e


def resolve_uri_to_local(
    uri: str,
    cache_dir: Optional[Union[str, Path]] = None,
    force: bool = False,
) -> Path:
    """Return a local path for a URI, downloading into the cache if needed.

    Supported: local paths, ``file://``, ``gs://`` (gcsfs), ``s3://``
    (boto3), ``synapse://`` (synapseclient), ``cellxgene://`` (census).
    Cached downloads are reused unless ``force``.
    """
    cache = Path(cache_dir) if cache_dir else DEFAULT_CACHE_DIR
    if "://" not in uri:
        p = Path(uri)
        if not p.exists():
            raise FileNotFoundError(f"Local reference not found: {uri}")
        return p
    scheme, rest = uri.split("://", 1)
    if scheme == "file":
        p = Path(rest)
        if not p.exists():
            raise FileNotFoundError(f"Local reference not found: {uri}")
        return p

    cache.mkdir(parents=True, exist_ok=True)
    safe = rest.replace("/", "_")
    target = cache / safe
    if target.exists() and not force:
        logger.info(f"Using cached {uri} → {target}")
        return target

    if scheme == "gs":
        fs = _require("gcsfs", "gs").GCSFileSystem()
        logger.info(f"Downloading {uri} → {target}")
        fs.get(rest, str(target))
        return target
    if scheme == "s3":
        boto3 = _require("boto3", "s3")
        bucket, _, key = rest.partition("/")
        logger.info(f"Downloading {uri} → {target}")
        boto3.client("s3").download_file(bucket, key, str(target))
        return target
    if scheme == "synapse":
        from .synapse import download_synapse_reference

        return download_synapse_reference(rest, target)
    if scheme == "cellxgene":
        from .cellxgene import download_cellxgene_reference

        return download_cellxgene_reference(rest, target.parent)
    raise ValueError(f"Unknown URI scheme '{scheme}://' in '{uri}'")


def _upload(local: Path, uri: str) -> None:
    scheme, rest = uri.split("://", 1)
    if scheme == "gs":
        fs = _require("gcsfs", "gs").GCSFileSystem()
        fs.put(str(local), rest)
    elif scheme == "s3":
        boto3 = _require("boto3", "s3")
        bucket, _, key = rest.partition("/")
        boto3.client("s3").upload_file(str(local), bucket, key)
    else:
        raise ValueError(f"Cannot upload to scheme '{scheme}://'")


@param_aliases(source="source_uri", output="output_path")
def acquire_reference(
    source_uri: str,
    output_path: Union[str, Path],
    cache_dir: Optional[Union[str, Path]] = None,
    force: bool = False,
) -> Union[Path, str]:
    """Fetch a reference to ``output_path`` (local, ``gs://`` or ``s3://``).

    Existing outputs are skipped unless ``force``.
    """
    out_is_remote = "://" in str(output_path) and \
        not str(output_path).startswith("file://")
    if not out_is_remote:
        out = Path(str(output_path).replace("file://", ""))
        if out.exists() and not force:
            logger.info(f"Output exists, skipping: {out}")
            return out
    local = resolve_uri_to_local(source_uri, cache_dir=cache_dir,
                                 force=force)
    if out_is_remote:
        logger.info(f"Uploading {local} → {output_path}")
        _upload(local, str(output_path))
        return str(output_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    if local != out:
        shutil.copyfile(local, out)
    logger.info(f"Acquired {source_uri} → {out}")
    return out
