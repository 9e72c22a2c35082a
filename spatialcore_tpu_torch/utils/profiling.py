"""The program's tracing: spans, counters, read-backs, torch.profiler traces
and wall-clock timers.

Port of ``spatialcore_tpu/utils/profiling.py``, grown into the port's one
tracing module.

- :func:`span` marks a layer boundary (a public entry, set-up, prep, the
  draw loop, one draw, the Feistel rows, a gather, a kernel, the
  post-pass). A span records only while tracing is on: inside
  :func:`tracing`, or while a ``torch.profiler`` is recording. Off, it costs
  one flag check and returns a shared no-op context. While a profiler
  records, a span also opens ``record_function("spatialcore." + name)``, so
  it sits in the profiler's trace beside the card's kernels, on the
  trace's clock. :func:`spans` reads the records.
- :func:`count` adds to a named counter and :func:`set_count` sets one
  that holds a size (a plan's rows, slots and far edges, a graph's
  isolated cells: the last one built); counters are always on (a dict
  update) and read with :func:`counters`. The kernels' launch counts
  live here too (:class:`CounterGroup`), and counts a kernel keeps on the
  card are folded in when the counters are read (:func:`fold_on_read`).
- :func:`read_back` is the one way the null path reads a tensor back to
  the host (and :func:`synchronize` the one way it waits for the card):
  each counts ``host_syncs`` and, while tracing is on, adds the time it
  blocked to the innermost open span's ``wait_ns``.
- :func:`profile_trace` records a ``torch.profiler`` trace of a block and
  writes it as a Chrome trace; :func:`timer` and :func:`timed` log
  wall-clock seconds (a timer is a span that also logs), synchronizing the
  card first where the reference waits for JAX's pending effects.
"""

from __future__ import annotations

import contextlib
import functools
import tempfile
import threading
import time
from collections.abc import MutableMapping
from pathlib import Path
from typing import Iterable, Optional, Union

import torch

from ..core.logging import get_logger

logger = get_logger("utils.profiling")

#: whether a torch.profiler is recording on this thread (~0.1 µs a check)
_profiler_enabled = torch._C._autograd._profiler_enabled

_tracing = 0            # depth of open tracing() blocks
_records: list = []     # every recorded span, in the order opened
_counts: dict = {}      # counter name -> int
_folds: list = []       # callables that fold counts kept on the card in
_calls = 0              # the last call id handed to a root span
_ids = 0                # spans opened since the process started
_local = threading.local()
_OFF = contextlib.nullcontext()


def _stack() -> list:
    """This thread's open spans, innermost last."""
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Span:
    """One recorded span; the record itself (see :func:`spans`)."""

    __slots__ = ("name", "id", "call", "parent", "start_ns", "end_ns",
                 "wait_ns", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _calls, _ids
        st = _stack()
        if st:
            self.parent, self.call = st[-1].id, st[-1].call
        else:                       # a root span opens a new call
            _calls += 1
            self.parent, self.call = None, _calls
        _ids += 1
        self.id = _ids
        self.wait_ns = 0
        self.end_ns = None
        _records.append(self)
        st.append(self)
        self._rf = None
        if _profiler_enabled():
            self._rf = torch.profiler.record_function("spatialcore." + self.name)
            self._rf.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        elif self in st:            # spans an exception left open inside
            del st[st.index(self):]
        return False


def span(name: str):
    """Context manager marking one layer boundary (see the module's
    docstring). Records name, call id, parent span, host start and end
    (``time.perf_counter_ns``) and the host's blocked time while tracing is
    on; otherwise a shared no-op context."""
    if not (_tracing or _profiler_enabled()):
        return _OFF
    return _Span(name)


def traced(name: str):
    """Decorator: each call of the function runs inside ``span(name)``."""
    def wrap(f):
        @functools.wraps(f)
        def inner(*args, **kwargs):
            with span(name):
                return f(*args, **kwargs)

        return inner

    return wrap


@contextlib.contextmanager
def tracing():
    """Record spans (and read-back waits) inside the block, with or without
    a profiler. Read them with :func:`spans`; :func:`reset` clears them."""
    global _tracing
    _tracing += 1
    try:
        yield
    finally:
        _tracing -= 1


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (always on; a plain dict update,
    not locked against other threads)."""
    _counts[name] = _counts.get(name, 0) + n


def set_count(name: str, n: int) -> None:
    """Set the counter ``name`` to ``n`` (always on): a size of the last
    structure built, where :func:`count` tallies events."""
    _counts[name] = int(n)


def _blocking(fn, arg):
    """``fn(arg)``, a call that blocks the host on the card: counted in
    ``host_syncs``, and while tracing is on its time added to the innermost
    open span's ``wait_ns``."""
    _counts["host_syncs"] = _counts.get("host_syncs", 0) + 1
    if not (_tracing or _profiler_enabled()):
        return fn(arg)
    t0 = time.perf_counter_ns()
    out = fn(arg)
    st = _stack()
    if st:
        st[-1].wait_ns += time.perf_counter_ns() - t0
    return out


def read_back(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host (``t.cpu()``), counted and timed as a blocking call.
    Adds no synchronization of its own: a card tensor's copy waits for the
    work queued before it, a host tensor comes back as is."""
    return _blocking(torch.Tensor.cpu, t)


def synchronize(device) -> None:
    """``torch.cuda.synchronize(device)``, counted and timed as a blocking
    call."""
    _blocking(torch.cuda.synchronize, device)


def fold_on_read(fold) -> None:
    """Register ``fold()``, called whenever the counters are read or reset:
    it adds counts that a kernel keeps on the card (with :func:`count`),
    reading them back itself, so that no draw waits for them. The read
    waits for the card: reading or resetting the counters in the middle of
    a call stalls the host until the work queued so far has run, and that
    wait is not counted in ``host_syncs``."""
    _folds.append(fold)


def counters() -> dict:
    """A copy of every counter: ``draws``, ``tiles``, ``rng.feistel_calls``,
    ``rng.feistel_passes``, ``host_syncs``, the kernels' launches
    (``kernels.<module>.<mode>``), and the sizes of the last null plan
    (``plan.rows``, ``plan.slots``, ``plan.live_slots``, ``plan.far_edges``)
    and radius graph (``graph.radius_isolated``) built, Lee's L pair
    columns (``lee.pairs``: the columns built, ``lee.x_genes`` /
    ``lee.y_genes``: the distinct x and y genes among each set built,
    summed), the value-table rows the draw loops gather
    (``ops.banded.gather_rows``), with the counts kept on the card folded
    in first. Folding them reads them back, so the call waits for the work
    queued on the card (see :func:`fold_on_read`)."""
    for fold in _folds:
        fold()
    return dict(_counts)


def spans() -> list:
    """The recorded spans in the order opened, as dicts: ``id``, ``name``,
    ``call``, ``parent`` (an id or None), ``start_ns``, ``end_ns`` (None
    while open), ``wait_ns`` (blocked in read-backs directly inside),
    ``self_ns`` (its time less its children's) and ``total_wait_ns`` (its
    own wait and every descendant's)."""
    out = [{"id": r.id, "name": r.name, "call": r.call, "parent": r.parent,
            "start_ns": r.start_ns, "end_ns": r.end_ns, "wait_ns": r.wait_ns,
            "self_ns": (None if r.end_ns is None else r.end_ns - r.start_ns),
            "total_wait_ns": r.wait_ns} for r in list(_records)]
    by_id = {d["id"]: d for d in out}
    for d in reversed(out):         # children are opened after their parent
        up = by_id.get(d["parent"])
        if up is None:
            continue
        up["total_wait_ns"] += d["total_wait_ns"]
        if up["self_ns"] is not None and d["end_ns"] is not None:
            up["self_ns"] -= d["end_ns"] - d["start_ns"]
    return out


def reset() -> None:
    """Clear the recorded spans and every counter (counts kept on the card
    up to now included, which waits for the card as :func:`counters`
    does)."""
    global _calls
    for fold in _folds:
        fold()
    _records.clear()
    _counts.clear()
    _calls = 0


class CounterGroup(MutableMapping):
    """Counters ``<prefix>.<key>`` of the registry, read and written as a
    dict of ``key`` (the kernels' ``LAUNCHES``); a key not yet counted
    reads 0."""

    def __init__(self, prefix: str, keys: Iterable[str]):
        self._prefix = prefix + "."
        self._keys = tuple(keys)

    def _name(self, key: str) -> str:
        if key not in self._keys:
            raise KeyError(key)
        return self._prefix + key

    def __getitem__(self, key: str) -> int:
        return _counts.get(self._name(key), 0)

    def __setitem__(self, key: str, value: int) -> None:
        _counts[self._name(key)] = value

    def __delitem__(self, key: str) -> None:
        _counts.pop(self._name(key), None)

    def __iter__(self):
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)

    def clear(self) -> None:
        for key in self._keys:
            del self[key]

    def __repr__(self) -> str:
        return repr(dict(self))


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def profile_trace(log_dir: Optional[Union[str, Path]] = None):
    """Capture a ``torch.profiler`` trace of the enclosed block.

    Writes ``<log_dir>/trace.json`` (Chrome trace format; open it in
    ``chrome://tracing`` or Perfetto) and yields that path. ``log_dir``
    defaults to a new temporary directory. CUDA activity is recorded when
    a card is present; the program's spans appear in it as
    ``spatialcore.<name>`` ranges.
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
    """Wall-clock a block; waits for the card's queued work when ``sync``.
    The block is a span named ``label``."""
    with span(label):
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
