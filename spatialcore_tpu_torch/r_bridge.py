"""R execution utilities: a compatibility layer.

Port of ``spatialcore_tpu/r_bridge.py`` (no JAX there, so a copy). The
domain pipeline that once shelled out to R/sf runs as a raster pass on the
card (``ops/geometry.py``), so nothing in this package needs R; the module
keeps user code that imported the generic R helpers working. The four
functions are minimal ``Rscript`` subprocess wrappers with typed
exceptions.
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence, Union

from .core.logging import get_logger

logger = get_logger("r_bridge")


class RBridgeError(Exception):
    """Base error for R execution problems."""


class RNotFoundError(RBridgeError):
    """Rscript is not installed / not on PATH."""


class RExecutionError(RBridgeError):
    """The R process exited non-zero."""

    def __init__(self, message: str, stdout: str = "", stderr: str = "",
                 returncode: Optional[int] = None):
        super().__init__(message)
        self.stdout = stdout
        self.stderr = stderr
        self.returncode = returncode


class RTimeoutError(RBridgeError):
    """The R process exceeded the timeout."""


def check_r_available() -> bool:
    """True if ``Rscript`` is on PATH."""
    return shutil.which("Rscript") is not None


def get_r_version() -> str:
    """The installed R version string (raises :class:`RNotFoundError`)."""
    if not check_r_available():
        raise RNotFoundError(
            "Rscript not found on PATH. Note: spatialcore_tpu_torch itself "
            "never needs R: spatial domains run as a raster pass on the card.")
    out = subprocess.run(["Rscript", "--version"], capture_output=True,
                         text=True)
    return (out.stderr or out.stdout).strip()


def run_r_script(script_path: Union[str, Path],
                 args: Sequence[str] = (),
                 timeout: float = 300.0) -> str:
    """Run an R script file with ``Rscript``; returns stdout."""
    path = Path(script_path)
    if not path.exists():
        raise RBridgeError(f"R script not found: {path}")
    if not check_r_available():
        raise RNotFoundError("Rscript not found on PATH")
    try:
        out = subprocess.run(["Rscript", str(path), *map(str, args)],
                             capture_output=True, text=True,
                             timeout=timeout)
    except subprocess.TimeoutExpired as e:
        raise RTimeoutError(
            f"R script {path} exceeded {timeout}s") from e
    if out.returncode != 0:
        raise RExecutionError(
            f"R script {path} failed (rc={out.returncode}):\n{out.stderr}",
            stdout=out.stdout, stderr=out.stderr,
            returncode=out.returncode)
    return out.stdout


def run_r_code(code: str, timeout: float = 300.0) -> str:
    """Run a string of R code with ``Rscript -e``; returns stdout."""
    if not check_r_available():
        raise RNotFoundError("Rscript not found on PATH")
    try:
        out = subprocess.run(["Rscript", "-e", code], capture_output=True,
                             text=True, timeout=timeout)
    except subprocess.TimeoutExpired as e:
        raise RTimeoutError(f"R code exceeded {timeout}s") from e
    if out.returncode != 0:
        raise RExecutionError(
            f"R code failed (rc={out.returncode}):\n{out.stderr}",
            stdout=out.stdout, stderr=out.stderr,
            returncode=out.returncode)
    return out.stdout


__all__ = [
    "check_r_available", "get_r_version", "run_r_script", "run_r_code",
    "RBridgeError", "RNotFoundError", "RExecutionError", "RTimeoutError",
]
