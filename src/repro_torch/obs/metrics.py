"""Metrics: typed instruments + conservation checking (DESIGN.md §11).

:class:`MetricsRegistry` absorbs the port's stats dataclasses via
:meth:`MetricsRegistry.ingest` into namespaced typed instruments
(:class:`Counter` / :class:`Gauge` / :class:`Histogram`) and *declares the
class's conservation invariants at ingest time*, so one shared
:meth:`MetricsRegistry.verify_conservation` replays them all:

=================  ======================================================
class              invariants declared on ingest
=================  ======================================================
IOStats            reads==0 -> bytes_read==0 (and same for writes)
CacheStats         counters non-negative
PipelineStats      counters non-negative
ExecStats          ragged_dispatches <= batches <= dispatches,
                   sum(group_lanes.values()) == ragged_lanes
IterStats          counters non-negative
SweepIterStats     ragged_dispatches <= batches <= dispatches
IngestStats        spill + shard + meta bytes == bytes_written_total,
                   spill bytes read back exactly once
CompactionStats    counters non-negative
=================  ======================================================

The reference's ``CollectiveStats`` adapter and its mesh identities
(per-device shards, dispatches and bytes) come with the multi-device port
(ROADMAP Queue 1 item 8).  Adapters dispatch on ``type(obj).__name__`` so
this module imports nothing of the engine.

Histograms are fixed log-bucket streaming estimators: ~7% bucket growth
gives ≲3.5% relative quantile error at O(1) memory, enough for the
p50/p95/p99 tail-latency numbers ``GraphService.metrics_snapshot()``
surfaces into ``BENCH_graphmp.json``.
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "HistogramState",
    "HistogramWindow",
    "MetricsRegistry",
    "ConservationError",
]

#: log-bucket growth factor; quantile relative error ~ sqrt(growth) - 1.
_GROWTH = 1.07
_LOG_GROWTH = math.log(_GROWTH)


class ConservationError(AssertionError):
    """Raised by verify_conservation(strict=True) with all violations."""


class Counter:
    """Monotonic accumulator."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def add(self, v: float) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name}: negative increment {v}")
        self.value += v


class Gauge:
    """Last-value instrument."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Streaming log-bucket histogram with quantile extraction.

    Values are bucketed at ``floor(log(x) / log(1.07))`` into a sparse dict;
    exact min/max/sum are kept so extreme quantiles clamp to observed
    bounds. Thread-safe (one small lock per record — this sits on serving
    control paths, never per-edge paths).
    """

    __slots__ = ("name", "_buckets", "count", "total", "min", "max", "zeros", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._buckets: Dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.zeros = 0  # values <= 0 (clock jitter can yield 0.0 durations)
        self._lock = threading.Lock()

    def record(self, x: float) -> None:
        with self._lock:
            self.count += 1
            self.total += x
            if x < self.min:
                self.min = x
            if x > self.max:
                self.max = x
            if x <= 0.0:
                self.zeros += 1
                return
            idx = int(math.floor(math.log(x) / _LOG_GROWTH))
            self._buckets[idx] = self._buckets.get(idx, 0) + 1

    def merge(self, other: "Histogram") -> None:
        with self._lock:
            self.count += other.count
            self.total += other.total
            self.min = min(self.min, other.min)
            self.max = max(self.max, other.max)
            self.zeros += other.zeros
            for idx, n in other._buckets.items():
                self._buckets[idx] = self._buckets.get(idx, 0) + n

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (q in [0, 1]); 0.0 when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        with self._lock:
            if self.count == 0:
                return 0.0
            rank = q * self.count
            if rank <= self.zeros:
                return max(0.0, min(self.min, 0.0))
            cum = self.zeros
            for idx in sorted(self._buckets):
                cum += self._buckets[idx]
                if cum >= rank:
                    mid = math.exp((idx + 0.5) * _LOG_GROWTH)
                    return min(max(mid, self.min), self.max)
            return self.max

    def percentiles(self) -> Dict[str, float]:
        """The standard snapshot block: count/mean/p50/p95/p99/max."""
        return {
            "count": self.count,
            "mean": self.mean,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
        }

    # -- windowing (GraphPulse, DESIGN.md §13) -----------------------------

    def reset(self) -> None:
        """Clear all recorded samples (hard reset-on-window semantics)."""
        with self._lock:
            self._buckets.clear()
            self.count = 0
            self.total = 0.0
            self.min = math.inf
            self.max = -math.inf
            self.zeros = 0

    def state(self) -> "HistogramState":
        """Immutable cumulative snapshot, cheap to keep as a window mark."""
        with self._lock:
            return HistogramState(
                buckets=dict(self._buckets),
                count=self.count,
                total=self.total,
                zeros=self.zeros,
                min=self.min,
                max=self.max,
            )

    def window_since(self, prev: Optional["HistogramState"]) -> "HistogramWindow":
        """The histogram of samples recorded AFTER ``prev`` was taken.

        Implemented as a bucket-count diff against the cumulative state, so
        the live histogram keeps its lifetime data (``metrics_snapshot()``
        stays all-time) while callers get logical reset-on-window
        percentiles.  With ``prev=None`` the window is the full lifetime
        (exact min/max); otherwise window min/max are bucket-edge estimates.
        """
        cur = self.state()
        return cur.diff(prev)


class HistogramState:
    """Frozen cumulative histogram snapshot (a window mark).

    Two states taken from the same histogram diff into a
    :class:`HistogramWindow` — the samples recorded between the marks.
    """

    __slots__ = ("buckets", "count", "total", "zeros", "min", "max")

    def __init__(self, *, buckets: Dict[int, int], count: int, total: float,
                 zeros: int, min: float, max: float):
        self.buckets = buckets
        self.count = count
        self.total = total
        self.zeros = zeros
        self.min = min
        self.max = max

    def diff(self, prev: Optional["HistogramState"]) -> "HistogramWindow":
        """Samples recorded after ``prev`` (cumulative-count subtraction)."""
        if prev is None or prev.count == 0:
            return HistogramWindow(
                buckets=dict(self.buckets),
                count=self.count,
                total=self.total,
                zeros=self.zeros,
                lo=self.min if self.count else 0.0,
                hi=self.max if self.count else 0.0,
            )
        buckets = {
            idx: n - prev.buckets.get(idx, 0)
            for idx, n in self.buckets.items()
            if n - prev.buckets.get(idx, 0) > 0
        }
        count = self.count - prev.count
        zeros = self.zeros - prev.zeros
        if count <= 0:
            return HistogramWindow(buckets={}, count=0, total=0.0, zeros=0,
                                   lo=0.0, hi=0.0)
        # Window min/max cannot be recovered exactly from cumulative state;
        # clamp to the occupied window buckets (0 when only zeros landed).
        if buckets:
            idxs = sorted(buckets)
            lo = 0.0 if zeros > 0 else math.exp(idxs[0] * _LOG_GROWTH)
            hi = min(math.exp((idxs[-1] + 1) * _LOG_GROWTH), self.max)
        else:
            lo = hi = 0.0
        return HistogramWindow(
            buckets=buckets,
            count=count,
            total=self.total - prev.total,
            zeros=max(0, zeros),
            lo=lo,
            hi=hi,
        )


class HistogramWindow:
    """Samples recorded within one window, with the same quantile engine.

    Unlike :class:`Histogram` this is an immutable value object — safe to
    stash in a time-series ring and merge across windows (multi-window SLO
    burn rates merge the short windows that make up a long one).
    """

    __slots__ = ("buckets", "count", "total", "zeros", "lo", "hi")

    def __init__(self, *, buckets: Dict[int, int], count: int, total: float,
                 zeros: int, lo: float, hi: float):
        self.buckets = buckets
        self.count = count
        self.total = total
        self.zeros = zeros
        self.lo = lo
        self.hi = hi

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if self.count == 0:
            return 0.0
        rank = q * self.count
        if rank <= self.zeros:
            return 0.0
        cum = self.zeros
        for idx in sorted(self.buckets):
            cum += self.buckets[idx]
            if cum >= rank:
                mid = math.exp((idx + 0.5) * _LOG_GROWTH)
                return min(max(mid, self.lo), self.hi)
        return self.hi

    def fraction_above(self, x: float) -> float:
        """Fraction of window samples whose value exceeds ``x`` (bucket
        resolution: a bucket counts as above iff its midpoint is)."""
        if self.count == 0:
            return 0.0
        above = sum(
            n for idx, n in self.buckets.items()
            if math.exp((idx + 0.5) * _LOG_GROWTH) > x
        )
        return above / self.count

    def merge(self, other: "HistogramWindow") -> "HistogramWindow":
        buckets = dict(self.buckets)
        for idx, n in other.buckets.items():
            buckets[idx] = buckets.get(idx, 0) + n
        if self.count and other.count:
            lo, hi = min(self.lo, other.lo), max(self.hi, other.hi)
        else:
            nz = self if self.count else other
            lo, hi = nz.lo, nz.hi
        return HistogramWindow(
            buckets=buckets,
            count=self.count + other.count,
            total=self.total + other.total,
            zeros=self.zeros + other.zeros,
            lo=lo,
            hi=hi,
        )

    def percentiles(self) -> Dict[str, float]:
        """Same block shape as :meth:`Histogram.percentiles`."""
        return {
            "count": self.count,
            "mean": self.mean,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
            "min": self.lo if self.count else 0.0,
            "max": self.hi if self.count else 0.0,
        }


class MetricsRegistry:
    """Named typed instruments + declared conservation invariants.

    ``ingest(stats_obj)`` absorbs any of the port's stats classes (adapters
    keyed by class name), accumulating counters under a namespaced prefix
    (``io.bytes_read``, ``exec.dispatches``, ...) and appending the class's
    conservation checks — evaluated against *that object's* values — to the
    registry. ``verify_conservation()`` then replays every declared check.
    """

    def __init__(self, max_checks: int = 8192):
        self._instruments: Dict[str, Any] = {}
        # Bounded: a long-running service ingests stats forever; verification
        # covers the most recent `max_checks` declared identities.
        self._checks: "deque[Tuple[str, float, float, float]]" = deque(
            maxlen=max_checks
        )
        self._lock = threading.Lock()

    # -- instruments -------------------------------------------------------

    def _get(self, name: str, cls: type) -> Any:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"instrument {name!r} already exists as "
                    f"{type(inst).__name__}, requested {cls.__name__}"
                )
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def value(self, name: str) -> float:
        inst = self._instruments[name]
        return inst.value if not isinstance(inst, Histogram) else inst.mean

    def instruments(self) -> Dict[str, Any]:
        """Point-in-time copy of the name -> instrument map (the objects
        themselves are shared; used by the time-series snapshotter)."""
        with self._lock:
            return dict(self._instruments)

    # -- conservation ------------------------------------------------------

    def check(self, label: str, lhs: float, rhs: float, tol: float = 0.0) -> None:
        """Declare one conservation identity ``lhs == rhs`` (within tol)."""
        with self._lock:
            self._checks.append((label, float(lhs), float(rhs), float(tol)))

    def verify_conservation(self, strict: bool = True) -> List[str]:
        """Replay every declared invariant; return (or raise) violations."""
        violations: List[str] = []
        with self._lock:
            checks = list(self._checks)
        for label, lhs, rhs, tol in checks:
            bound = tol * max(1.0, abs(lhs), abs(rhs)) if tol else 0.0
            if abs(lhs - rhs) > bound:
                violations.append(f"{label}: {lhs} != {rhs} (tol={tol})")
        if violations and strict:
            raise ConservationError(
                "conservation violated:\n  " + "\n  ".join(violations)
            )
        return violations

    @property
    def num_checks(self) -> int:
        with self._lock:
            return len(self._checks)

    # -- ingestion of the port's stats classes -------------------------------

    def ingest(self, stats: Any, prefix: Optional[str] = None) -> None:
        """Absorb one stats object (dispatch on its class name)."""
        adapter = _ADAPTERS.get(type(stats).__name__)
        if adapter is None:
            raise TypeError(
                f"no metrics adapter for {type(stats).__name__}; "
                f"known: {sorted(_ADAPTERS)}"
            )
        adapter(self, stats, prefix)

    def snapshot(self) -> Dict[str, Any]:
        """All instrument values; histograms render as percentile blocks."""
        with self._lock:
            items = list(self._instruments.items())
        out: Dict[str, Any] = {}
        for name, inst in items:
            out[name] = inst.percentiles() if isinstance(inst, Histogram) else inst.value
        return out

    # adapter helpers ------------------------------------------------------

    def _bump(self, prefix: str, stats: Any, fields: Tuple[str, ...]) -> None:
        for f in fields:
            v = getattr(stats, f)
            self.counter(f"{prefix}.{f}").add(max(0.0, float(v)))
            if v < 0:
                self.check(f"{prefix}.{f} >= 0", float(v), 0.0)


# -- the adapters --------------------------------------------------------


def _ingest_io(reg: MetricsRegistry, s: Any, prefix: Optional[str]) -> None:
    p = prefix or "io"
    reg._bump(p, s, ("bytes_read", "bytes_written", "reads", "writes"))
    if s.reads == 0:
        reg.check(f"{p}: no reads -> no bytes_read", s.bytes_read, 0)
    if s.writes == 0:
        reg.check(f"{p}: no writes -> no bytes_written", s.bytes_written, 0)


def _ingest_cache(reg: MetricsRegistry, s: Any, prefix: Optional[str]) -> None:
    p = prefix or "cache"
    reg._bump(
        p,
        s,
        (
            "hits",
            "misses",
            "evictions",
            "inserted_bytes_raw",
            "inserted_bytes_stored",
            "compress_time_s",
            "decompress_time_s",
        ),
    )


def _ingest_pipeline(reg: MetricsRegistry, s: Any, prefix: Optional[str]) -> None:
    p = prefix or "pipeline"
    reg._bump(p, s, ("shards_loaded", "load_total_s", "wait_s", "to_device_s"))


def _ingest_exec(reg: MetricsRegistry, s: Any, prefix: Optional[str]) -> None:
    p = prefix or "exec"
    reg._bump(
        p,
        s,
        (
            "dispatches",
            "batches",
            "ragged_dispatches",
            "ragged_lanes",
            "overlap_s",
            "shards_executed",
            "exec_s",
        ),
    )
    # RaggedFuse conservation (DESIGN.md §14): a ragged flush is exactly one
    # dispatch per batch, and the ragged lane axis is the disjoint union of
    # the per-group lane blocks.
    reg.check(
        f"{p}: ragged_dispatches <= batches",
        min(s.ragged_dispatches, s.batches),
        s.ragged_dispatches,
    )
    reg.check(
        f"{p}: batches <= dispatches",
        min(s.batches, s.dispatches),
        s.batches,
    )
    if s.group_lanes:
        reg.check(
            f"{p}: sum(group_lanes) == ragged_lanes",
            sum(s.group_lanes.values()),
            s.ragged_lanes,
        )


def _ingest_iter(reg: MetricsRegistry, s: Any, prefix: Optional[str]) -> None:
    p = prefix or "iter"
    reg._bump(
        p,
        s,
        (
            "shards_processed",
            "shards_skipped",
            "bytes_read",
            "cache_hits",
            "cache_misses",
            "load_total_s",
            "load_wait_s",
            "exec_s",
            "dispatches",
        ),
    )
    reg.histogram(f"{p}.time_s").record(s.time_s)


def _ingest_sweep_iter(reg: MetricsRegistry, s: Any, prefix: Optional[str]) -> None:
    p = prefix or "sweep"
    reg._bump(
        p,
        s,
        (
            "shards_processed",
            "shards_skipped",
            "bytes_read",
            "retired",
            "backfilled",
            "lane_rows_skipped",
            "load_total_s",
            "load_wait_s",
            "exec_s",
            "dispatches",
            "batches",
            "ragged_dispatches",
            "overlap_s",
            "kernel_s",
        ),
    )
    reg.histogram(f"{p}.time_s").record(s.time_s)
    reg.gauge(f"{p}.live_lanes").set(s.live_lanes)
    reg.gauge(f"{p}.groups").set(s.groups)
    # RaggedFuse (DESIGN.md §14): every flushed batch costs at least one
    # dispatch; the ragged path makes it exactly one.
    reg.check(
        f"{p}[{s.iteration}]: batches <= dispatches",
        min(s.batches, s.dispatches),
        s.batches,
    )
    reg.check(
        f"{p}[{s.iteration}]: ragged_dispatches <= batches",
        min(s.ragged_dispatches, s.batches),
        s.ragged_dispatches,
    )


def _ingest_ingest(reg: MetricsRegistry, s: Any, prefix: Optional[str]) -> None:
    p = prefix or "ingest"
    reg._bump(
        p,
        s,
        (
            "num_edges",
            "spills",
            "runs",
            "spill_bytes_written",
            "spill_bytes_read",
            "shard_bytes_written",
            "meta_bytes_written",
        ),
    )
    reg.check(
        f"{p}: spill+shard+meta == bytes_written_total",
        s.spill_bytes_written + s.shard_bytes_written + s.meta_bytes_written,
        s.bytes_written_total,
    )
    reg.check(
        f"{p}: spill bytes read back exactly once",
        s.spill_bytes_read,
        s.spill_bytes_written,
    )


def _ingest_compaction(reg: MetricsRegistry, s: Any, prefix: Optional[str]) -> None:
    p = prefix or "compact"
    reg._bump(
        p,
        s,
        (
            "shards_compacted",
            "runs_absorbed",
            "inserts_applied",
            "tombstones_applied",
            "shard_bytes_written",
        ),
    )


_ADAPTERS: Dict[str, Callable[[MetricsRegistry, Any, Optional[str]], None]] = {
    "IOStats": _ingest_io,
    "CacheStats": _ingest_cache,
    "PipelineStats": _ingest_pipeline,
    "ExecStats": _ingest_exec,
    "IterStats": _ingest_iter,
    "SweepIterStats": _ingest_sweep_iter,
    "IngestStats": _ingest_ingest,
    "CompactionStats": _ingest_compaction,
}
