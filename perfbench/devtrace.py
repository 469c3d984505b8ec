"""The traced window: ``torch.profiler`` on the device, the port's own
spans on the host, and their reduction to busy time, kernel time by name
and idle gaps by what the host was doing.

The window is one ``record_function`` range; its start is also read on
the host clock, which puts the port's spans (``repro_torch.obs.trace``,
``perf_counter_ns``) on the profiler's time line.  A gap in device
activity is charged to the innermost span the harness thread was in at
the gap's middle: ``vsw.iter`` alone means the host program (plan, pre,
apply), which has no span of its own.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

__all__ = ["DeviceTrace", "capture"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_MARK = "perfbench.window"
NO_SPAN = "no span (harness, between runs)"


@dataclasses.dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    ops: Dict[str, float]  # device operation name -> seconds
    idle_by_host: Dict[str, float]  # host span -> idle device seconds

    def kernel_s(self, pattern: str) -> float:
        """Seconds of the device operations whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(s for name, s in self.ops.items() if rx.search(name))

    def breakdown(self) -> dict:
        top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                   key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(self.ops), "idle_gaps": top(self.idle_by_host)}


class _Capture:
    trace: Optional[DeviceTrace] = None


@contextlib.contextmanager
def capture(enabled: bool, device: torch.device):
    """Profile the block when ``enabled``; afterwards ``.trace`` holds the
    reduction (``None`` when not enabled)."""
    cap = _Capture()
    if not enabled:
        yield cap
        return
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.obs import trace as spans

    on_card = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    tracer = spans.Tracer(capacity=1 << 20)
    with profile(activities=acts) as prof:
        with spans.tracing(tracer), record_function(WINDOW_MARK):
            t0_ns = time.perf_counter_ns()
            yield cap
            if on_card:
                torch.cuda.synchronize(device)
    with tempfile.TemporaryDirectory(prefix="perfbench-trace-") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    cap.trace = reduce(events, t0_ns, tracer.export_chrome()["traceEvents"],
                       tracer.epoch_ns, threading.get_ident())


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce(events, t0_ns: int, host_events, host_epoch_ns: int,
           host_tid: int) -> DeviceTrace:
    """Busy time, device time by name and idle gaps by host span, in the
    window of the ``WINDOW_MARK`` range (profiler times in microseconds)."""
    mark = next(e for e in events if e.get("ph") == "X"
                and e.get("name") == WINDOW_MARK
                and e.get("cat") == "user_annotation")
    w0, w1 = float(mark["ts"]), float(mark["ts"]) + float(mark["dur"])
    offset = w0 - t0_ns / 1e3  # profiler time - host perf_counter time, us
    ops: Dict[str, float] = {}
    busy: List[Tuple[float, float]] = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        ops[e["name"]] = ops.get(e["name"], 0.0) + (b - a) / 1e6
        busy.append((a, b))
    merged = _union(busy)
    spans = sorted(
        (host_epoch_ns / 1e3 + e["ts"] + offset,
         host_epoch_ns / 1e3 + e["ts"] + e["dur"] + offset, e["name"])
        for e in host_events if e.get("ph") == "X" and e.get("tid") == host_tid)
    gaps, edge = [], w0
    for a, b in merged + [(w1, w1)]:
        if a > edge:
            gaps.append(((edge + a) / 2, (a - edge) / 1e6))
        edge = max(edge, b)
    idle: Dict[str, float] = {}
    for label, s in _label(spans, gaps):
        idle[label] = idle.get(label, 0.0) + s
    return DeviceTrace(window_s=(w1 - w0) / 1e6,
                       busy_s=sum(b - a for a, b in merged) / 1e6,
                       ops=ops, idle_by_host=idle)


def _label(spans, gaps):
    """``(innermost host span at the gap's middle, gap seconds)`` for each
    gap, in one sweep: the spans of one thread nest, so the open ones form
    a stack."""
    stack, j = [], 0
    for t, seconds in sorted(gaps):
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] < spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        yield (stack[-1][2] if stack else NO_SPAN), seconds
