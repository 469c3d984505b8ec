"""Exporters: Prometheus text exposition + JSONL time series.

Two formats, two audiences:

- :func:`prometheus_text` renders a :class:`MetricsRegistry` (or a
  pre-taken ``snapshot()`` dict) in the Prometheus text exposition format
  (version 0.0.4): counters and gauges as single samples, histograms as
  summaries (``{quantile="0.5|0.95|0.99"}`` plus ``_sum`` / ``_count``).
  Instrument names are namespaced and sanitized (``query.latency_s`` ->
  ``graphmp_query_latency_s``), so the output drops straight into a
  Prometheus scrape or ``promtool check metrics``.
- :func:`jsonl_lines` / :func:`write_jsonl` flatten a
  :class:`~repro_torch.obs.timeseries.TimeSeriesRegistry` ring into one JSON
  object per line, one line per closed window — the consolidated-bench
  and offline-analysis format (every line parses independently, files
  append across runs).

Both have round-trip parsers (:func:`parse_prometheus`,
:func:`read_jsonl`) used by the tests and ``chip_smoke.py``'s ``pulse``
phase to prove the exports are machine-readable, not just printable.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, Iterable, Iterator, List, Union

from .metrics import Histogram, MetricsRegistry
from .timeseries import TimeSeriesRegistry, WindowSample

__all__ = [
    "prometheus_text",
    "parse_prometheus",
    "jsonl_lines",
    "write_jsonl",
    "read_jsonl",
]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_QUANTS = ((0.5, "0.5"), (0.95, "0.95"), (0.99, "0.99"))


def _metric_name(namespace: str, name: str) -> str:
    out = _NAME_RE.sub("_", f"{namespace}_{name}" if namespace else name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _fmt(v: float) -> str:
    """Prometheus sample value: plain float, inf/nan spelled out."""
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return repr(float(v))


def prometheus_text(
    source: Union[MetricsRegistry, Dict[str, Any]],
    *,
    namespace: str = "graphmp",
) -> str:
    """Render instruments in the Prometheus text exposition format."""
    lines: List[str] = []
    if isinstance(source, MetricsRegistry):
        items = sorted(source.instruments().items())
        for name, inst in items:
            mname = _metric_name(namespace, name)
            if isinstance(inst, Histogram):
                lines.append(f"# TYPE {mname} summary")
                for q, label in _QUANTS:
                    lines.append(
                        f'{mname}{{quantile="{label}"}} {_fmt(inst.quantile(q))}'
                    )
                lines.append(f"{mname}_sum {_fmt(inst.total)}")
                lines.append(f"{mname}_count {_fmt(inst.count)}")
            else:
                kind = "gauge" if type(inst).__name__ == "Gauge" else "counter"
                lines.append(f"# TYPE {mname} {kind}")
                lines.append(f"{mname} {_fmt(inst.value)}")
        return "\n".join(lines) + "\n"
    # a snapshot() dict: histograms appear as percentile blocks
    pct_key = {"0.5": "p50", "0.95": "p95", "0.99": "p99"}
    for name, val in sorted(source.items()):
        mname = _metric_name(namespace, name)
        if isinstance(val, dict):
            lines.append(f"# TYPE {mname} summary")
            for q, label in _QUANTS:
                lines.append(
                    f'{mname}{{quantile="{label}"}} '
                    f"{_fmt(val.get(pct_key[label], 0.0))}"
                )
            mean = float(val.get("mean", 0.0))
            count = float(val.get("count", 0))
            lines.append(f"{mname}_sum {_fmt(mean * count)}")
            lines.append(f"{mname}_count {_fmt(count)}")
        else:
            lines.append(f"# TYPE {mname} untyped")
            lines.append(f"{mname} {_fmt(float(val))}")
    return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$"
)


def parse_prometheus(text: str) -> Dict[str, float]:
    """Parse exposition text back to ``{name{labels}: value}`` samples.

    A validating round-trip for tests/benchmarks: raises ``ValueError`` on
    any line that is neither a comment nor a well-formed sample.
    """
    out: Dict[str, float] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: not a prometheus sample: {line!r}")
        key = m.group("name")
        if m.group("labels"):
            key += "{" + m.group("labels") + "}"
        v = m.group("value")
        out[key] = float("inf") if v == "+Inf" else (
            float("-inf") if v == "-Inf" else float(v)
        )
    return out


# --------------------------------------------------------------- JSONL side


def _sample_doc(s: WindowSample) -> Dict[str, Any]:
    return {
        "index": s.index,
        "wall_ts": s.wall_ts,
        "duration_s": s.duration_s,
        "counters": dict(s.counters),
        "gauges": dict(s.gauges),
        "histograms": {k: w.percentiles() for k, w in s.histograms.items()},
    }


def jsonl_lines(
    ts: Union[TimeSeriesRegistry, Iterable[WindowSample]]
) -> Iterator[str]:
    """One compact JSON object per closed window, oldest first."""
    samples = ts.samples() if isinstance(ts, TimeSeriesRegistry) else ts
    for s in samples:
        yield json.dumps(_sample_doc(s), separators=(",", ":"))


def write_jsonl(
    path: str,
    ts: Union[TimeSeriesRegistry, Iterable[WindowSample]],
    *,
    append: bool = False,
) -> int:
    """Write the ring as JSONL; returns the number of lines written."""
    n = 0
    with open(path, "a" if append else "w") as f:
        for line in jsonl_lines(ts):
            f.write(line + "\n")
            n += 1
    return n


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Parse a JSONL export back to window dicts (validates every line)."""
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            doc = json.loads(line)
            for req in ("index", "wall_ts", "duration_s", "counters",
                        "gauges", "histograms"):
                if req not in doc:
                    raise ValueError(
                        f"{path}:{lineno}: window missing {req!r}"
                    )
            out.append(doc)
    return out
