"""Structured tracer: nestable spans on per-thread ring buffers.

The storage, pipeline and executor layers wrap their work in
``span("shard.load", shard=i)`` calls.  With no :class:`Tracer` installed,
``span()`` returns a shared no-op context manager: the cost at every call
site is one global read and a ``None`` check.  With a tracer installed the
spans land in a per-thread ring (one writer thread per ring, so no lock on
the record path) and :meth:`Tracer.export_chrome` renders them as
Chrome-trace / Perfetto JSON, one lane per thread.  ``counter()`` and
``instant()`` follow the same discipline: with no tracer installed they
return after one global read.

Span names used by the engine::

    vsw.run / vsw.init / vsw.iter / vsw.pre / vsw.apply / vsw.activity /
    vsw.stats / sweep.plan / bloom.build
    shard.load / shard.next / shard.wait / shard.read / shard.decode /
    shard.to_device
    store.read / store.write / cache.get / cache.put
    exec.dispatch / exec.stage / exec.copy_back
    sweep.iter / batch.form / service.admit / service.fusion_set /
    service.retire

and instant events ``lane.retire`` and ``service.cache_hit``.

An engine iteration nests as ``vsw.run > vsw.iter > {sweep.plan, vsw.pre,
shard.next > shard.wait, exec.stage, exec.dispatch > exec.copy_back,
vsw.apply}``, then ``vsw.run > {vsw.activity, vsw.stats}``; ``vsw.init``
opens the run.  The steps that ``IterStats`` counts are clocked with
:func:`timed`, so their seconds are there with tracing off too.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = ["NULL_SPAN", "Span", "Tracer", "active", "counter",
           "dropped_events", "install", "instant", "publish_drops", "span",
           "timed", "tracing", "uninstall"]


class _NullSpan:
    """Shared no-op span returned while tracing is disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def set(self, **attrs: Any) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()

_ACTIVE: Optional["Tracer"] = None


def active() -> Optional["Tracer"]:
    """The currently installed tracer, or None when tracing is disabled."""
    return _ACTIVE


def span(name: str, **attrs: Any) -> Any:
    """Open a span if tracing is enabled; otherwise return the no-op span."""
    t = _ACTIVE
    if t is None:
        return NULL_SPAN
    return t.span(name, **attrs)


class Timed:
    """A :func:`span` that also clocks its block; see :func:`timed`."""

    __slots__ = ("_span", "_t0", "s")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self._span = span(name, **attrs)
        self.s = 0.0

    def __enter__(self) -> "Timed":
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> bool:
        self.s = time.perf_counter() - self._t0
        return self._span.__exit__(*exc)


def timed(name: str, **attrs: Any) -> Timed:
    """:func:`span` that also clocks its block, tracing on or off:
    ``with timed("vsw.pre") as t: ...`` leaves the block's wall seconds in
    ``t.s`` (``perf_counter``), for the stats that count the step."""
    return Timed(name, attrs)


def counter(name: str, value: float, **attrs: Any) -> None:
    """Record a counter sample ("C" event) if tracing is enabled."""
    t = _ACTIVE
    if t is not None:
        t.counter(name, value, **attrs)


def instant(name: str, **attrs: Any) -> None:
    """Record an instant event ("i") if tracing is enabled."""
    t = _ACTIVE
    if t is not None:
        t.instant(name, **attrs)


def dropped_events() -> int:
    """Events dropped so far by the active tracer's rings (0 when tracing
    is disabled)."""
    t = _ACTIVE
    return t.dropped_events() if t is not None else 0


def publish_drops(registry: Any) -> int:
    """Mirror the active tracer's drop count into ``registry`` as the
    ``trace.dropped_events`` counter (created on the first drop only).
    Returns the total."""
    d = dropped_events()
    if d > 0:
        c = registry.counter("trace.dropped_events")
        if d > c.value:
            c.add(d - c.value)
    return d


def install(tracer: "Tracer") -> "Tracer":
    """Install ``tracer`` as the process-wide active tracer."""
    global _ACTIVE
    _ACTIVE = tracer
    return tracer


def uninstall() -> None:
    """Disable tracing (``span()`` reverts to the no-op path)."""
    global _ACTIVE
    _ACTIVE = None


@contextmanager
def tracing(tracer: Optional["Tracer"] = None) -> Iterator["Tracer"]:
    """Install a tracer for the block, restore the previous one on exit."""
    t = tracer if tracer is not None else Tracer()
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = t
    try:
        yield t
    finally:
        _ACTIVE = prev


class _ThreadRing:
    """Fixed-capacity event ring with exactly one writer thread.

    ``n`` counts all events ever written, so ``n - capacity`` (when
    positive) is the number of dropped-oldest events.
    """

    __slots__ = ("tid", "name", "capacity", "buf", "n", "depth")

    def __init__(self, tid: int, name: str, capacity: int):
        self.tid = tid
        self.name = name
        self.capacity = capacity
        self.buf: List[Optional[tuple]] = [None] * capacity
        self.n = 0
        self.depth = 0  # currently-open spans on this thread

    def push(self, ev: tuple) -> None:
        self.buf[self.n % self.capacity] = ev
        self.n += 1

    def snapshot(self) -> Tuple[List[tuple], int]:
        n = self.n
        if n <= self.capacity:
            return [e for e in self.buf[:n] if e is not None], 0
        cut = n % self.capacity
        out = self.buf[cut:] + self.buf[:cut]
        return [e for e in out if e is not None], n - self.capacity


class Span:
    """A single open span; records a completed event on exit.  An exception
    propagating through the span marks it with an ``error`` attribute."""

    __slots__ = ("_ring", "_name", "_attrs", "_t0")

    def __init__(self, ring: _ThreadRing, name: str,
                 attrs: Optional[Dict[str, Any]]):
        self._ring = ring
        self._name = name
        self._attrs = attrs
        self._t0 = 0

    def set(self, **attrs: Any) -> "Span":
        """Attach/overwrite attributes on an open span."""
        if self._attrs is None:
            self._attrs = attrs
        else:
            self._attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self._ring.depth += 1
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        dur = time.perf_counter_ns() - self._t0
        self._ring.depth -= 1
        if exc is not None:
            self.set(error=repr(exc))
        self._ring.push(("X", self._name, self._t0, dur, self._attrs))
        return False


class Tracer:
    """Collects spans, counters and instants into per-thread rings of
    ``capacity`` events each; the oldest events are dropped beyond that
    (the drop count is reported in the export's ``otherData``)."""

    def __init__(self, capacity: int = 1 << 16):
        if capacity <= 0:
            raise ValueError("tracer capacity must be positive")
        self.capacity = int(capacity)
        self.epoch_ns = time.perf_counter_ns()
        self._local = threading.local()
        self._rings: List[_ThreadRing] = []
        self._reg_lock = threading.Lock()

    def _ring(self) -> _ThreadRing:
        ring = getattr(self._local, "ring", None)
        if ring is None:
            th = threading.current_thread()
            ring = _ThreadRing(th.ident or 0, th.name, self.capacity)
            with self._reg_lock:
                self._rings.append(ring)
            self._local.ring = ring
        return ring

    def span(self, name: str, **attrs: Any) -> Span:
        return Span(self._ring(), name, attrs or None)

    def counter(self, name: str, value: float, **attrs: Any) -> None:
        self._ring().push(("C", name, time.perf_counter_ns(), value,
                           attrs or None))

    def instant(self, name: str, **attrs: Any) -> None:
        self._ring().push(("i", name, time.perf_counter_ns(), 0,
                           attrs or None))

    def open_span_count(self) -> int:
        """Number of spans currently entered but not yet exited."""
        with self._reg_lock:
            return sum(r.depth for r in self._rings)

    def event_count(self) -> int:
        """Events currently held across all rings."""
        with self._reg_lock:
            return sum(min(r.n, r.capacity) for r in self._rings)

    def thread_names(self) -> List[str]:
        """The name of each thread that recorded an event, in first-event
        order."""
        with self._reg_lock:
            return [r.name for r in self._rings]

    def dropped_events(self) -> int:
        """Oldest-event drops across all rings."""
        with self._reg_lock:
            return sum(max(0, r.n - r.capacity) for r in self._rings)

    def export_chrome(self, path: Optional[str] = None) -> Dict[str, Any]:
        """Render all recorded events as a Chrome-trace JSON object (and
        write it to ``path`` when given).  Loadable by Perfetto or
        ``chrome://tracing``."""
        pid = os.getpid()
        with self._reg_lock:
            rings = list(self._rings)
        events: List[Dict[str, Any]] = []
        dropped_total = 0
        for ring in rings:
            events.append({"ph": "M", "pid": pid, "tid": ring.tid,
                           "name": "thread_name",
                           "args": {"name": ring.name}})
            evs, dropped = ring.snapshot()
            dropped_total += dropped
            for ph, name, t_ns, dur_or_val, attrs in evs:
                rec: Dict[str, Any] = {
                    "ph": ph, "pid": pid, "tid": ring.tid, "name": name,
                    "ts": (t_ns - self.epoch_ns) / 1000.0,
                }
                if ph == "X":
                    rec["dur"] = dur_or_val / 1000.0
                    if attrs:
                        rec["args"] = _jsonable(attrs)
                elif ph == "C":
                    args = {"value": dur_or_val}
                    if attrs:
                        args.update(_jsonable(attrs))
                    rec["args"] = args
                else:  # an instant event
                    rec["s"] = "t"
                    if attrs:
                        rec["args"] = _jsonable(attrs)
                events.append(rec)
        out = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"tracer": "graphscope",
                          "dropped_events": dropped_total,
                          "ring_capacity": self.capacity},
        }
        if dropped_total > 0:
            # A truncated timeline is misleading evidence: say so.
            out["otherData"]["warning"] = (
                f"ring overflow: {dropped_total} oldest events dropped "
                f"(per-thread capacity {self.capacity}); the timeline is "
                f"truncated at its start — raise Tracer(capacity=...) to "
                f"capture the full run")
        if path is not None:
            with open(path, "w") as f:
                json.dump(out, f)
        return out


def _jsonable(attrs: Dict[str, Any]) -> Dict[str, Any]:
    """Coerce span attrs to JSON-safe scalars (numpy ints etc. appear)."""
    out: Dict[str, Any] = {}
    for k, v in attrs.items():
        if isinstance(v, (str, bool, int, float)) or v is None:
            out[k] = v
        else:
            try:
                out[k] = int(v)
            except (TypeError, ValueError):
                try:
                    out[k] = float(v)
                except (TypeError, ValueError):
                    out[k] = str(v)
    return out
