"""Package logging for spatialcore_tpu_torch.

Port of ``spatialcore_tpu/core/logging.py``: a package-level
``spatialcore_tpu_torch`` logger with a stdout handler attached on first
use, so log records are never silently dropped.
"""

from __future__ import annotations

import logging
import sys
from typing import Optional

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
