"""Observability for the port: tracing, metrics and time-series telemetry.

- :mod:`repro_torch.obs.trace` — structured tracer with nestable spans,
  counters and instants on lock-free per-thread ring buffers, exporting
  Chrome-trace/Perfetto JSON.  Disabled (the default) it is a guard-flag
  no-op.
- :mod:`repro_torch.obs.metrics` — typed Counter/Gauge/Histogram
  instruments, a :class:`MetricsRegistry` that absorbs the port's stats
  dataclasses, one shared ``verify_conservation()``, and windowed
  histogram snapshots (:class:`HistogramWindow`).
- :mod:`repro_torch.obs.timeseries` — :class:`TimeSeriesRegistry`:
  cadenced windowed snapshots of a registry into a bounded ring (counters
  diffed, histograms logically reset-on-window).
- :mod:`repro_torch.obs.slo` — declared objectives evaluated as
  multi-window burn rates over the ring, emitting typed
  :class:`SLOViolation` records; :mod:`repro_torch.obs.export` renders
  Prometheus text exposition and JSONL time series.
"""

from . import trace
from .export import (
    jsonl_lines,
    parse_prometheus,
    prometheus_text,
    read_jsonl,
    write_jsonl,
)
from .metrics import (
    ConservationError,
    Counter,
    Gauge,
    Histogram,
    HistogramState,
    HistogramWindow,
    MetricsRegistry,
)
from .slo import (
    SLO,
    SLOMonitor,
    SLOViolation,
    error_rate_slo,
    latency_slo,
    share_slo,
)
from .timeseries import MergedWindow, TimeSeriesRegistry, WindowSample
from .trace import (
    NULL_SPAN,
    Span,
    Tracer,
    active,
    counter,
    dropped_events,
    install,
    instant,
    publish_drops,
    span,
    tracing,
    uninstall,
)

__all__ = [
    "trace",
    "ConservationError",
    "Counter",
    "Gauge",
    "Histogram",
    "HistogramState",
    "HistogramWindow",
    "MetricsRegistry",
    "MergedWindow",
    "TimeSeriesRegistry",
    "WindowSample",
    "SLO",
    "SLOMonitor",
    "SLOViolation",
    "latency_slo",
    "error_rate_slo",
    "share_slo",
    "prometheus_text",
    "parse_prometheus",
    "jsonl_lines",
    "write_jsonl",
    "read_jsonl",
    "NULL_SPAN",
    "Span",
    "Tracer",
    "active",
    "counter",
    "dropped_events",
    "install",
    "instant",
    "publish_drops",
    "span",
    "tracing",
    "uninstall",
]
