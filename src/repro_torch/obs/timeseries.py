"""Time series: cadenced *windowed* views of a MetricsRegistry.

:class:`~repro_torch.obs.metrics.MetricsRegistry` instruments accumulate for the
lifetime of the service — exactly right for conservation identities, wrong
for operating a service, where "p99 latency" must mean *p99 over the last
few seconds*, not since boot.  :class:`TimeSeriesRegistry` closes that gap:
``tick()`` snapshots the registry into a :class:`WindowSample` —

- **counters** are diffed against the previous tick's marks, so each
  sample carries the per-window increment (and ``rate()`` divides by the
  window duration);
- **histograms** are logically reset-on-window via
  :meth:`~repro_torch.obs.metrics.Histogram.window_since` bucket diffs — the
  live histogram keeps its lifetime data, the sample sees only the
  window's records;
- **gauges** are sampled as-is (they are already point-in-time).

Samples land in a bounded ring (``capacity`` windows), so a long-lived
service holds O(capacity) telemetry regardless of uptime.  ``start()``
runs the tick loop on a daemon thread at ``interval_s`` cadence;
``tick()`` may equally be driven by an external clock (tests drive it
manually, :meth:`repro_torch.serve.service.GraphService.start_telemetry` owns
the thread in production).

Window-delta conservation: for every counter, the sum of all window
deltas ever emitted plus the current mark equals the live counter value
(``tests/test_torch_pulse.py`` asserts this while a fused workload is
mid-sweep: the torn-read guard for concurrent ticks).

:class:`~repro_torch.obs.slo.SLOMonitor` consumes the ring via :meth:`merged`,
which folds the last-``T``-seconds of samples into one
:class:`~repro_torch.obs.metrics.HistogramWindow` per histogram (plus summed
counter deltas) — the long/short windows of multi-window burn-rate
evaluation are re-aggregations of the same ring, not separate collectors.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Dict, List, Mapping, Optional, Tuple

from .metrics import Gauge, Histogram, HistogramState, HistogramWindow, MetricsRegistry

__all__ = ["TimeSeriesRegistry", "WindowSample", "MergedWindow"]


@dataclasses.dataclass(frozen=True)
class WindowSample:
    """One closed telemetry window: deltas since the previous tick."""

    index: int
    t_start: float  # perf_counter seconds (monotonic, same clock as t_end)
    t_end: float
    wall_ts: float  # time.time() at window close, for export timestamps
    counters: Mapping[str, float]  # per-window increments
    gauges: Mapping[str, float]  # point-in-time values at window close
    histograms: Mapping[str, HistogramWindow]  # per-window sample sets

    @property
    def duration_s(self) -> float:
        return max(self.t_end - self.t_start, 0.0)

    def rate(self, name: str) -> float:
        """Per-second rate of one counter over this window (0 if absent)."""
        dur = self.duration_s
        return self.counters.get(name, 0.0) / dur if dur > 0 else 0.0


@dataclasses.dataclass(frozen=True)
class MergedWindow:
    """Several consecutive samples folded into one evaluation window."""

    t_start: float
    t_end: float
    samples: int
    counters: Dict[str, float]
    histograms: Dict[str, HistogramWindow]

    @property
    def duration_s(self) -> float:
        return max(self.t_end - self.t_start, 0.0)


class TimeSeriesRegistry:
    """Bounded ring of windowed MetricsRegistry snapshots.

    Thread-safety: ``tick()`` is serialized by an internal lock and safe to
    call while worker threads are recording into the registry — counter
    float reads are atomic under the GIL and histogram state copies take
    the histogram's own lock, so a window can straddle a recording but
    never tear one.
    """

    def __init__(self, registry: MetricsRegistry, *, capacity: int = 1024,
                 interval_s: float = 0.5):
        if capacity <= 0:
            raise ValueError("time-series capacity must be positive")
        if interval_s <= 0:
            raise ValueError("tick interval must be positive")
        self.registry = registry
        self.capacity = int(capacity)
        self.interval_s = float(interval_s)
        self._samples: "deque[WindowSample]" = deque(maxlen=self.capacity)
        self._counter_marks: Dict[str, float] = {}
        self._hist_marks: Dict[str, HistogramState] = {}
        self._lock = threading.Lock()
        self._t_mark = time.perf_counter()
        self._index = 0
        self._dropped = 0  # samples evicted from the ring
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------- ticking
    def tick(self) -> WindowSample:
        """Close the current window: diff counters, window histograms."""
        with self._lock:
            t_end = time.perf_counter()
            counters: Dict[str, float] = {}
            gauges: Dict[str, float] = {}
            hists: Dict[str, HistogramWindow] = {}
            for name, inst in self.registry.instruments().items():
                if isinstance(inst, Histogram):
                    win = inst.window_since(self._hist_marks.get(name))
                    hists[name] = win
                    self._hist_marks[name] = inst.state()
                elif isinstance(inst, Gauge):
                    gauges[name] = inst.value
                else:  # Counter
                    v = float(inst.value)
                    prev = self._counter_marks.get(name, 0.0)
                    # Monotonic by construction; clamp defensively so a
                    # replaced instrument can never emit a negative window.
                    counters[name] = max(v - prev, 0.0)
                    self._counter_marks[name] = v
            sample = WindowSample(
                index=self._index,
                t_start=self._t_mark,
                t_end=t_end,
                wall_ts=time.time(),
                counters=counters,
                gauges=gauges,
                histograms=hists,
            )
            self._index += 1
            self._t_mark = t_end
            if len(self._samples) == self.capacity:
                self._dropped += 1
            self._samples.append(sample)
            return sample

    # ------------------------------------------------------------ querying
    def samples(self) -> List[WindowSample]:
        with self._lock:
            return list(self._samples)

    def latest(self) -> Optional[WindowSample]:
        with self._lock:
            return self._samples[-1] if self._samples else None

    @property
    def num_windows(self) -> int:
        """Windows ever closed (>= len(samples()) once the ring wraps)."""
        with self._lock:
            return self._index

    @property
    def dropped_samples(self) -> int:
        with self._lock:
            return self._dropped

    def series(self, name: str) -> List[Tuple[float, float]]:
        """(wall_ts, value) pairs for one counter (window deltas) or gauge."""
        out = []
        for s in self.samples():
            if name in s.counters:
                out.append((s.wall_ts, s.counters[name]))
            elif name in s.gauges:
                out.append((s.wall_ts, s.gauges[name]))
        return out

    def merged(self, last_s: float) -> MergedWindow:
        """Fold the samples whose windows END within the last ``last_s``
        seconds into one evaluation window (SLO burn-rate input).  Returns
        an empty window when no sample qualifies."""
        now = time.perf_counter()
        picked = [s for s in self.samples() if now - s.t_end <= last_s]
        if not picked:
            return MergedWindow(t_start=now, t_end=now, samples=0,
                                counters={}, histograms={})
        counters: Dict[str, float] = {}
        hists: Dict[str, HistogramWindow] = {}
        for s in picked:
            for k, v in s.counters.items():
                counters[k] = counters.get(k, 0.0) + v
            for k, w in s.histograms.items():
                hists[k] = hists[k].merge(w) if k in hists else w
        return MergedWindow(
            t_start=picked[0].t_start,
            t_end=picked[-1].t_end,
            samples=len(picked),
            counters=counters,
            histograms=hists,
        )

    # ----------------------------------------------------- background loop
    def start(self) -> "TimeSeriesRegistry":
        """Tick on a daemon thread every ``interval_s`` until ``stop()``."""
        if self._thread is not None:
            raise RuntimeError("time-series ticker already running")
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(self.interval_s):
                self.tick()

        self._thread = threading.Thread(
            target=loop, name="graphpulse-ticker", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, *, final_tick: bool = True) -> None:
        """Stop the ticker (idempotent); optionally close a last window so
        the tail of the run is never lost to cadence truncation."""
        th, self._thread = self._thread, None
        if th is not None:
            self._stop.set()
            th.join()
            if final_tick:
                self.tick()

    def __enter__(self) -> "TimeSeriesRegistry":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
