"""Reference acquisition: URI → local file with caching.

Port of ``spatialcore_tpu/annotation/acquisition.py``
(``resolve_uri_to_local``; ``acquire_reference`` is not ported yet, ROADMAP
Queue 1 item 14). Local paths and ``file://`` URIs always work; ``gs://``
and ``s3://`` need their optional SDKs (gcsfs, boto3) and raise a clear
error naming the missing one; ``synapse://`` and ``cellxgene://`` need the
port's Synapse and CELLxGENE modules, which are not ported yet.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

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

    Supported: local paths, ``file://``, ``gs://`` (gcsfs) and ``s3://``
    (boto3). Cached downloads are reused unless ``force``.
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
    if scheme in ("synapse", "cellxgene"):
        raise NotImplementedError(
            f"'{scheme}://' URIs download through the {scheme} module, which "
            "is not ported yet (ROADMAP Queue 1 item 14); download the file "
            "and pass a local path")
    if scheme not in ("gs", "s3"):
        raise ValueError(f"Unknown URI scheme '{scheme}://' in '{uri}'")

    cache.mkdir(parents=True, exist_ok=True)
    target = cache / rest.replace("/", "_")
    if target.exists() and not force:
        logger.info(f"Using cached {uri} → {target}")
        return target
    logger.info(f"Downloading {uri} → {target}")
    if scheme == "gs":
        _require("gcsfs", "gs").GCSFileSystem().get(rest, str(target))
    else:
        bucket, _, key = rest.partition("/")
        _require("boto3", "s3").client("s3").download_file(
            bucket, key, str(target))
    return target
