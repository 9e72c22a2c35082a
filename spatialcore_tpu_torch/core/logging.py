"""Package logging for spatialcore_tpu_torch.

Port of ``spatialcore_tpu/core/logging.py``: a package-level
``spatialcore_tpu_torch`` logger with a stdout handler attached on first
use, so log records are never silently dropped, an idempotent
``setup_logging`` and an optional file handler.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path
from typing import Optional, Union

from .compat import param_aliases

_ROOT_NAME = "spatialcore_tpu_torch"
_DEFAULT_FORMAT = "%(asctime)s | %(levelname)-7s | %(name)s | %(message)s"
_DATE_FORMAT = "%H:%M:%S"


def _auto_init() -> None:
    """Attach a stdout handler to the package root logger once."""
    root = logging.getLogger(_ROOT_NAME)
    if not root.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(_DEFAULT_FORMAT, _DATE_FORMAT))
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False


def get_logger(name: Optional[str] = None) -> logging.Logger:
    """Return a logger under the ``spatialcore_tpu_torch`` hierarchy.

    ``get_logger("ops.banded")`` and
    ``get_logger("spatialcore_tpu_torch.ops.banded")`` name the same logger.
    """
    _auto_init()
    if not name:
        return logging.getLogger(_ROOT_NAME)
    if not name.startswith(_ROOT_NAME):
        name = f"{_ROOT_NAME}.{name}"
    return logging.getLogger(name)


@param_aliases(format_string="fmt")
def setup_logging(
    level: Union[int, str] = logging.INFO,
    fmt: str = _DEFAULT_FORMAT,
    datefmt: str = _DATE_FORMAT,
    stream=None,
) -> logging.Logger:
    """(Re)configure package logging. Idempotent: replaces prior handlers."""
    _auto_init()
    root = logging.getLogger(_ROOT_NAME)
    if isinstance(level, str):
        level = getattr(logging, level.upper())
    for h in list(root.handlers):
        if isinstance(h, logging.StreamHandler) and not isinstance(h, logging.FileHandler):
            root.removeHandler(h)
    handler = logging.StreamHandler(stream or sys.stdout)
    handler.setFormatter(logging.Formatter(fmt, datefmt))
    root.addHandler(handler)
    root.setLevel(level)
    return root


def setup_file_logging(
    path: Union[str, Path],
    level: Union[int, str] = logging.DEBUG,
    fmt: str = _DEFAULT_FORMAT,
) -> logging.Logger:
    """Add a file handler that captures package logs to ``path``."""
    _auto_init()
    root = logging.getLogger(_ROOT_NAME)
    if isinstance(level, str):
        level = getattr(logging, level.upper())
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    handler = logging.FileHandler(path)
    handler.setLevel(level)
    handler.setFormatter(logging.Formatter(fmt))
    root.addHandler(handler)
    if root.level > level:
        root.setLevel(level)
    return root
