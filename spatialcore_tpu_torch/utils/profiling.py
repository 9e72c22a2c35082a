"""Profiling hooks: torch.profiler traces and wall-clock timing.

Port of ``spatialcore_tpu/utils/profiling.py``. ``profile_trace`` records
a ``torch.profiler`` trace of the enclosed block (host and, where a card
is present, CUDA activity) and writes it as a Chrome trace; ``timer`` and
``timed`` log wall-clock seconds, synchronizing the card first where the
reference waits for JAX's pending effects.
"""

from __future__ import annotations

import contextlib
import functools
import tempfile
import time
from pathlib import Path
from typing import Optional, Union

import torch

from ..core.logging import get_logger

logger = get_logger("utils.profiling")


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def profile_trace(log_dir: Optional[Union[str, Path]] = None):
    """Capture a ``torch.profiler`` trace of the enclosed block.

    Writes ``<log_dir>/trace.json`` (Chrome trace format; open it in
    ``chrome://tracing`` or Perfetto) and yields that path. ``log_dir``
    defaults to a new temporary directory. CUDA activity is recorded when
    a card is present.
    """
    from torch.profiler import ProfilerActivity, profile

    path = Path(log_dir) if log_dir is not None else Path(
        tempfile.mkdtemp(prefix="spatialcore_trace_"))
    path.mkdir(parents=True, exist_ok=True)
    trace = path / "trace.json"
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    logger.info(f"profiler trace → {trace}")
    with profile(activities=activities) as prof:
        try:
            yield str(trace)
        finally:
            _sync()
    prof.export_chrome_trace(str(trace))


@contextlib.contextmanager
def timer(label: str, sync: bool = True, store: Optional[dict] = None):
    """Wall-clock a block; waits for the card's queued work when ``sync``."""
    t0 = time.time()
    yield
    if sync:
        _sync()
    elapsed = time.time() - t0
    logger.info(f"[timer] {label}: {elapsed:.3f}s")
    if store is not None:
        store[label] = elapsed


def timed(fn=None, *, label: Optional[str] = None):
    """Decorator: log the wall-clock of each call (card-synced)."""
    def wrap(f):
        name = label or f.__qualname__

        @functools.wraps(f)
        def inner(*args, **kwargs):
            with timer(name):
                return f(*args, **kwargs)

        return inner

    return wrap(fn) if fn is not None else wrap
