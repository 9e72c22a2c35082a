"""Content-addressed result caching.

Port of ``spatialcore_tpu/core/cache.py``: container-returning functions
are cached as ``.cache/<name>_<md5-of-args>.h5ad`` and replayed on
identical calls.
"""

from __future__ import annotations

import functools
import hashlib
import shutil
from pathlib import Path
from typing import Callable, Optional, Union

from .logging import get_logger

logger = get_logger("core.cache")

DEFAULT_CACHE_DIR = Path(".cache")


def _hash_args(args, kwargs) -> str:
    h = hashlib.md5()
    for a in args:
        if hasattr(a, "n_obs") and hasattr(a, "n_vars"):
            h.update(f"SpatialData:{a.n_obs}x{a.n_vars}".encode())
        else:
            h.update(repr(a).encode())
    for k in sorted(kwargs):
        h.update(f"{k}={kwargs[k]!r}".encode())
    return h.hexdigest()[:12]


def get_cache_path(name: str, args=(), kwargs=None,
                   cache_dir: Union[str, Path] = DEFAULT_CACHE_DIR) -> Path:
    digest = _hash_args(args, kwargs or {})
    return Path(cache_dir) / f"{name}_{digest}.h5ad"


def cache_result(name: Optional[str] = None,
                 cache_dir: Union[str, Path] = DEFAULT_CACHE_DIR) -> Callable:
    """Decorator caching a SpatialData-returning function to .h5ad on disk."""

    def decorator(fn: Callable) -> Callable:
        cache_name = name or fn.__name__

        @functools.wraps(fn)
        def wrapper(*args, use_cache: bool = True, **kwargs):
            from .io import read_h5ad, write_h5ad

            path = get_cache_path(cache_name, args, kwargs, cache_dir)
            if use_cache and path.exists():
                logger.info(f"Cache hit: {path}")
                return read_h5ad(path)
            result = fn(*args, **kwargs)
            if use_cache and result is not None and hasattr(result, "obs"):
                path.parent.mkdir(parents=True, exist_ok=True)
                write_h5ad(result, path)
                logger.info(f"Cached result → {path}")
            return result

        return wrapper

    return decorator


def clear_cache(cache_dir: Union[str, Path] = DEFAULT_CACHE_DIR,
                name: Optional[str] = None) -> int:
    """Remove cached files (all, or those for one function name)."""
    cache_dir = Path(cache_dir)
    if not cache_dir.exists():
        return 0
    if name is None:
        n = len(list(cache_dir.glob("*.h5ad")))
        shutil.rmtree(cache_dir)
        return n
    files = list(cache_dir.glob(f"{name}_*.h5ad"))
    for f in files:
        f.unlink()
    return len(files)
