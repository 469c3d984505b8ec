"""SLO objectives evaluated as multi-window burn rates over the time series.

An SLO here is "at most a ``budget`` fraction of the service's traffic may
be *bad*", with three notions of bad (matching what the serving stack can
actually measure from :class:`~repro_torch.obs.metrics.MetricsRegistry`):

``latency``
    A query is bad when its latency exceeds ``threshold_s``.  The bad
    fraction comes from :meth:`HistogramWindow.fraction_above` on the
    windowed latency histogram — e.g. budget 0.01 + threshold 50 ms reads
    "p99 latency <= 50 ms".
``error_rate``
    Bad = the window's increments of ``bad_counters`` (rejections, shard
    load failures); total = increments of ``total_counters``.
``share``
    A *time* share instead of an event share: windowed
    ``sum(num_hist) / sum(den_hist)`` must stay under ``budget`` — e.g.
    queue-wait seconds as a share of total latency seconds.

Burn rate = measured bad fraction / budget: 1.0 means the error budget is
being consumed exactly at the sustainable pace, ``k`` means ``k``-times
too fast.  Following the multi-window SRE discipline, a violation fires
only when BOTH a long window and its paired short window burn at >=
``factor`` — the long window filters blips, the short window proves the
problem is still live (so old incidents cannot page forever).  Windows
are re-aggregations of the :class:`~repro_torch.obs.timeseries.TimeSeriesRegistry`
ring via :meth:`~repro_torch.obs.timeseries.TimeSeriesRegistry.merged`.

Violations are typed :class:`SLOViolation` records: kept on the monitor
(bounded), counted in the registry (``slo.violations``), and surfaced by
``GraphService.metrics_snapshot()``.  Evaluation is edge-triggered per
(objective, window pair): a condition that stays bad emits ONE record
until it recovers and trips again.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .timeseries import MergedWindow, TimeSeriesRegistry

__all__ = [
    "SLO",
    "SLOMonitor",
    "SLOViolation",
    "latency_slo",
    "error_rate_slo",
    "share_slo",
    "DEFAULT_WINDOWS",
]

#: (long_s, short_s, burn factor) pairs.  The classic SRE 1h/5m + 6h/30m
#: alerts scaled to single-process bench runs: a sustained burn over tens
#: of seconds, confirmed live over the last few.
DEFAULT_WINDOWS: Tuple[Tuple[float, float, float], ...] = (
    (30.0, 5.0, 2.0),
    (120.0, 10.0, 1.0),
)


@dataclasses.dataclass(frozen=True)
class SLO:
    """One declared objective (see module docstring for the kinds)."""

    name: str
    kind: str  # "latency" | "error_rate" | "share"
    budget: float  # allowed bad fraction, in (0, 1]
    threshold_s: float = 0.0  # latency kind: the per-query latency bound
    hist: str = "query.latency_s"  # latency kind: windowed histogram name
    bad_counters: Tuple[str, ...] = ()  # error_rate kind
    total_counters: Tuple[str, ...] = ()  # error_rate kind
    num_hist: str = ""  # share kind: numerator time histogram
    den_hist: str = ""  # share kind: denominator time histogram
    min_events: int = 10  # below this many window events: not evaluated

    def __post_init__(self) -> None:
        if not 0.0 < self.budget <= 1.0:
            raise ValueError(f"SLO {self.name}: budget must be in (0, 1]")
        if self.kind not in ("latency", "error_rate", "share"):
            raise ValueError(f"SLO {self.name}: unknown kind {self.kind!r}")

    # -- measurement -------------------------------------------------------

    def bad_fraction(self, w: MergedWindow) -> Optional[float]:
        """Measured bad fraction over one merged window; None = not enough
        data to evaluate (too few events — never a violation)."""
        if self.kind == "latency":
            h = w.histograms.get(self.hist)
            if h is None or h.count < self.min_events:
                return None
            return h.fraction_above(self.threshold_s)
        if self.kind == "error_rate":
            bad = sum(w.counters.get(c, 0.0) for c in self.bad_counters)
            total = sum(w.counters.get(c, 0.0) for c in self.total_counters)
            if total < self.min_events:
                return None
            return bad / total
        num = w.histograms.get(self.num_hist)
        den = w.histograms.get(self.den_hist)
        if den is None or den.count < self.min_events or den.total <= 0.0:
            return None
        return (num.total if num is not None else 0.0) / den.total

    def burn_rate(self, w: MergedWindow) -> Optional[float]:
        frac = self.bad_fraction(w)
        return None if frac is None else frac / self.budget


def latency_slo(name: str, *, threshold_s: float, budget: float = 0.01,
                hist: str = "query.latency_s", min_events: int = 10) -> SLO:
    """"All but ``budget`` of queries answer within ``threshold_s``"."""
    return SLO(name=name, kind="latency", budget=budget,
               threshold_s=threshold_s, hist=hist, min_events=min_events)


def error_rate_slo(
    name: str, *, budget: float = 0.01,
    bad: Sequence[str] = ("query.rejected", "shard.load_error"),
    total: Sequence[str] = ("query.completed", "query.rejected"),
    min_events: int = 10,
) -> SLO:
    """"At most ``budget`` of admissions end in rejection or error"."""
    return SLO(name=name, kind="error_rate", budget=budget,
               bad_counters=tuple(bad), total_counters=tuple(total),
               min_events=min_events)


def share_slo(name: str, *, budget: float,
              num_hist: str = "query.queue_wait_s",
              den_hist: str = "query.latency_s", min_events: int = 10) -> SLO:
    """"``num_hist`` time stays under a ``budget`` share of ``den_hist``"."""
    return SLO(name=name, kind="share", budget=budget, num_hist=num_hist,
               den_hist=den_hist, min_events=min_events)


@dataclasses.dataclass(frozen=True)
class SLOViolation:
    """One edge-triggered burn-rate trip (typed, export-friendly)."""

    slo: str
    kind: str
    wall_ts: float
    long_s: float
    short_s: float
    factor: float  # the burn factor this window pair alerts at
    burn_long: float
    burn_short: float
    bad_fraction: float  # measured over the long window
    budget: float
    threshold_s: float

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class SLOMonitor:
    """Evaluates declared objectives over a time-series ring.

    ``evaluate()`` is meant to be called once per telemetry tick (the
    service's cadence thread does); each call re-derives every
    (objective, window-pair) burn rate from the ring and emits new
    :class:`SLOViolation` records on rising edges.  All mutation happens
    on the calling thread; readers get copies.
    """

    def __init__(
        self,
        timeseries: TimeSeriesRegistry,
        slos: Sequence[SLO],
        *,
        windows: Sequence[Tuple[float, float, float]] = DEFAULT_WINDOWS,
        max_records: int = 1024,
    ):
        names = [s.name for s in slos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self.timeseries = timeseries
        self.slos: Tuple[SLO, ...] = tuple(slos)
        self.windows: Tuple[Tuple[float, float, float], ...] = tuple(
            (float(l), float(s), float(f)) for l, s, f in windows
        )
        for long_s, short_s, _ in self.windows:
            if short_s > long_s:
                raise ValueError(
                    f"short window {short_s}s exceeds long window {long_s}s"
                )
        self._records: "deque[SLOViolation]" = deque(maxlen=max_records)
        self._active: set = set()  # (slo.name, long_s) currently tripped
        self._evaluations = 0
        # last-computed burn rates, keyed (slo.name, long_s) -> (long, short)
        self._burns: Dict[Tuple[str, float], Tuple[Optional[float], Optional[float]]] = {}

    def evaluate(self, *, wall_ts: Optional[float] = None) -> List[SLOViolation]:
        """One evaluation pass; returns only the NEW violations."""
        wall_ts = time.time() if wall_ts is None else wall_ts
        self._evaluations += 1
        merged: Dict[float, MergedWindow] = {}
        for long_s, short_s, _ in self.windows:
            for w in (long_s, short_s):
                if w not in merged:
                    merged[w] = self.timeseries.merged(w)
        new: List[SLOViolation] = []
        for slo in self.slos:
            for long_s, short_s, factor in self.windows:
                burn_long = slo.burn_rate(merged[long_s])
                burn_short = slo.burn_rate(merged[short_s])
                self._burns[(slo.name, long_s)] = (burn_long, burn_short)
                tripped = (
                    burn_long is not None
                    and burn_short is not None
                    and burn_long >= factor
                    and burn_short >= factor
                )
                key = (slo.name, long_s)
                if tripped and key not in self._active:
                    self._active.add(key)
                    v = SLOViolation(
                        slo=slo.name,
                        kind=slo.kind,
                        wall_ts=wall_ts,
                        long_s=long_s,
                        short_s=short_s,
                        factor=factor,
                        burn_long=burn_long,
                        burn_short=burn_short,
                        bad_fraction=burn_long * slo.budget,
                        budget=slo.budget,
                        threshold_s=slo.threshold_s,
                    )
                    self._records.append(v)
                    new.append(v)
                    self.timeseries.registry.counter("slo.violations").add(1)
                elif not tripped and key in self._active:
                    self._active.discard(key)
        return new

    # -- introspection -----------------------------------------------------

    @property
    def violations(self) -> List[SLOViolation]:
        return list(self._records)

    def snapshot(self) -> Dict[str, Any]:
        """The block ``GraphService.metrics_snapshot()`` embeds."""
        objectives = []
        for slo in self.slos:
            burns = {}
            for long_s, short_s, factor in self.windows:
                bl, bs = self._burns.get((slo.name, long_s), (None, None))
                burns[f"{long_s:g}s/{short_s:g}s"] = {
                    "factor": factor,
                    "burn_long": bl,
                    "burn_short": bs,
                }
            objectives.append({
                "name": slo.name,
                "kind": slo.kind,
                "budget": slo.budget,
                "threshold_s": slo.threshold_s,
                "burn_rates": burns,
            })
        return {
            "objectives": objectives,
            "evaluations": self._evaluations,
            "violations": [v.to_dict() for v in self._records],
            "active": sorted(f"{n}@{w:g}s" for n, w in self._active),
        }
