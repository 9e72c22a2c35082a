"""The traced run: ranges the harness wraps around the program, the device
trace of a stretch of consecutive draws, and its reduction.

In a ``--trace 1`` run the harness replaces ``ops.banded.feistel_apply``
(a module global that the draw loops look up at every call) with a
wrapper that runs each call inside a ``portbench.feistel`` profiler range,
times the draws outside the profiled stretches on the host clock, and
steps the profiler once a draw (``Tracer``). Each trace is reduced to the
traced window's length, the union of device activity, the kernels by
name, and the device's idle gaps labelled by the host operation that
encloses them. Nothing here runs in a ``--trace 0`` run.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


def _short(name: str, width: int = 100) -> str:
    """A kernel's or an operation's name without its argument list."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0][:width]


def reduce_events(events: list, steps: int = 0) -> Optional[dict]:
    """Summary of a chrome-trace event list: the window spanned by the
    profiler's step ranges (a trace without them, device activity only:
    from the first runtime call to the last device activity, over
    ``steps`` draws), busy seconds (the union of device activity in it),
    kernels by name, device time by name, idle time by host label."""
    step_ev = [e for e in events if e.get("ph") == "X"
               and str(e.get("name", "")).startswith("ProfilerStep#")]
    if step_ev:
        t0 = min(e["ts"] for e in step_ev)
        t1 = max(e["ts"] + e["dur"] for e in step_ev)
        steps = len(step_ev)
    else:
        span = [e for e in events if e.get("ph") == "X" and e.get("cat")
                in DEVICE_CATS + ("cuda_runtime", "cuda_driver")]
        if not span or not steps:
            return None
        t0 = min(e["ts"] for e in span)
        t1 = max(e["ts"] + e["dur"] for e in span)
    # a device-only trace can list an activity twice: keep one a launch
    dev = sorted({(e.get("args") or {}).get("correlation") or
                  (e["ts"], e["dur"], e["name"]): e for e in events
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
                  and e["ts"] < t1 and e["ts"] + e["dur"] > t0}.values(),
                 key=lambda e: e["ts"])
    kernels = defaultdict(list)
    by_name = defaultdict(float)
    spans = []
    for e in dev:
        a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
        spans.append((a, b))
        if e["cat"] == "kernel" and t0 <= e["ts"] < t1:
            kernels[e["name"]].append(e["dur"] * 1e-6)
        by_name[_short(e["name"])] += (b - a) * 1e-6
    busy, gaps, cur_a, cur_b = 0.0, [], None, None
    last = t0
    for a, b in spans:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
            gap_start = t0 if cur_b is None else cur_b
            if a > gap_start:
                gaps.append((gap_start, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy += cur_b - cur_a
        last = cur_b
    if t1 > last:
        gaps.append((last, t1))
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in HOST_CATS
            and not str(e.get("name", "")).startswith("ProfilerStep#")]
    host.sort(key=lambda e: e["ts"])
    starts = [e["ts"] for e in host]
    idle = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        # nested ranges: walking back from the last one that starts before
        # the gap, the first that is still open is the innermost
        label = "host, outside any op"
        for i in range(bisect.bisect_right(starts, mid) - 1,
                       max(-1, bisect.bisect_right(starts, mid) - 5001), -1):
            if host[i]["ts"] + host[i]["dur"] >= mid:
                label = _short(host[i]["name"])
                break
        idle[label] += (b - a) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:10]]
    return {"window_s": (t1 - t0) * 1e-6, "busy_s": busy * 1e-6,
            "steps": steps, "kernels": dict(kernels),
            "n_kernels": sum(len(v) for v in kernels.values()),
            "breakdown": {"device_ops": top(by_name), "idle_gaps": top(idle)}}


class Tracer:
    """Wraps the program's Feistel row stream and traces two stretches of
    ``active`` consecutive draws, the first after ``skip`` draws.

    The first stretch records device activity alone (CUPTI's kernels,
    copies and runtime calls), which adds little to a draw: its window,
    busy time and kernels give the device metrics (``summary``). The
    second records host operations too, which lengthens a draw several
    times over: it gives only the ``breakdown`` (device time by kernel,
    idle time by the host operation it falls in). Every draw outside the
    two stretches first drains the device and then times the stream on
    the host clock (``host_s`` over ``calls``): its own cost, without the
    wait for the previous draw that its first read-back would otherwise
    take, and without the profiler's."""

    def __init__(self, skip: int = 4, active: int = 24):
        self.skip, self.active = skip, active
        self.steps = 0
        self.calls = 0
        self.host_s = 0.0
        self.summary = None
        self.breakdown = None
        self._prof = None
        self._phase = 0
        self._orig = None

    def _reduce(self, prof, host: bool):
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                s = reduce_events(json.load(f)["traceEvents"], self.active)
        finally:
            os.unlink(path)
        if host:
            self.breakdown = s["breakdown"] if s else None
            if self.summary is None:
                self.summary = s
        else:
            self.summary = s

    def _profile(self, host: bool, skip: int):
        import torch

        P = torch.profiler.ProfilerActivity
        cuda = torch.cuda.is_available()
        acts = ([P.CPU] if host or not cuda else []) + ([P.CUDA] if cuda else [])
        prof = torch.profiler.profile(
            activities=acts,
            on_trace_ready=lambda p: self._reduce(p, host or not cuda),
            schedule=torch.profiler.schedule(skip_first=skip, wait=0, warmup=1,
                                             active=self.active, repeat=1))
        prof.__enter__()
        return prof

    def _step(self) -> bool:
        """Step the profiler a draw; whether this draw is timed."""
        self._prof.step()
        self.steps += 1
        first_end = self.skip + self.active + 2
        if self._phase == 0 and self.steps > first_end:
            self._prof.__exit__(None, None, None)
            self._prof = self._profile(host=True, skip=1)
            self._prof.step()
            self._phase = 1
        return not (self.skip <= self.steps <= first_end + self.active + 4)

    def __enter__(self):
        import torch
        from spatialcore_tpu_torch.ops import banded

        self._prof = self._profile(host=False, skip=self.skip)
        orig = self._orig = banded.feistel_apply
        tracer = self

        def feistel_apply(k, idx, n):
            timed = tracer._step()
            if timed:
                if idx.is_cuda:
                    torch.cuda.synchronize()
                t = time.perf_counter()
            with torch.profiler.record_function("portbench.feistel"):
                out = orig(k, idx, n)
            if timed:       # the stream ends on a read-back: nothing in flight
                tracer.host_s += time.perf_counter() - t
                tracer.calls += 1
            return out

        banded.feistel_apply = feistel_apply
        return self

    def __exit__(self, *exc):
        from spatialcore_tpu_torch.ops import banded

        banded.feistel_apply = self._orig
        self._prof.__exit__(*exc)
        return False
