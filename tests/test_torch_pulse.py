"""The port's windowed telemetry, SLO burn rates, exports and load harness.

Carried from ``tests/test_pulse.py`` (guarantee families, DESIGN.md §13):

1. **Windowed histograms** — ``Histogram.reset()``/``state()``/
   ``window_since()`` give logical reset-on-window semantics without
   destroying lifetime data.
2. **Time series** — ``TimeSeriesRegistry.tick()`` emits per-window
   counter deltas and histogram windows into a bounded ring; window-delta
   conservation holds even when ticks race a live fused workload.
3. **SLO burn rates** — multi-window evaluation fires on bad traffic,
   stays silent on healthy traffic, dedups via edge-triggering, and
   refuses to judge sparse data.
4. **Typed error paths** — ServiceOverloaded and ShardLoadError become
   ``query.rejected`` / ``shard.load_error`` counters; tracer ring
   overflow surfaces as ``trace.dropped_events`` + an export warning.
5. **Load harness** — closed/open-loop replay is schedule-deterministic,
   phase-correct, and every recorded result is bitwise a solo oracle's.

Against the reference, on the same inputs (every comparison exact):
``Workload.plan`` arrays and the Poisson arrival gaps for several seeds,
``prometheus_text`` as strings, ``SLOMonitor`` verdicts and burn rates on
the same filled windows, and every completed load-generator record of the
port's service against the reference's solo numpy ``VSWEngine`` at the
record's graph version (``edge_state_at_version``).  On the ``cuda``
backend (the kernels' plain versions here) PPR sums in the kernels' fold
order, not numpy's: its records are bitwise the port's own solo ``cuda``
engine and within rtol=1e-5, atol=1e-9 of the reference's, as in
``tests/test_torch_serve.py``; BFS/SSSP/WCC are bitwise the reference's.
"""

import threading
import time

import numpy as np
import pytest
import torch

from repro.core import apps as ref_apps
from repro.core.graph import from_edge_list as ref_from_edge_list
from repro.core.vsw import VSWEngine as RefEngine
from repro.obs import MetricsRegistry as RefRegistry
from repro.obs import SLOMonitor as RefMonitor
from repro.obs import TimeSeriesRegistry as RefSeries
from repro.obs import error_rate_slo as ref_error_rate_slo
from repro.obs import latency_slo as ref_latency_slo
from repro.obs import prometheus_text as ref_prometheus_text
from repro.obs import share_slo as ref_share_slo
from repro.serve import LoadGenerator as RefLoadGenerator
from repro.serve import QueryClass as RefQueryClass
from repro.serve import Workload as RefWorkload
from repro_torch.core import apps
from repro_torch.core.graph import from_edge_list, rmat_graph
from repro_torch.core.vsw import VSWEngine
from repro_torch.obs import (
    Histogram,
    MetricsRegistry,
    SLOMonitor,
    TimeSeriesRegistry,
    Tracer,
    error_rate_slo,
    jsonl_lines,
    latency_slo,
    parse_prometheus,
    prometheus_text,
    read_jsonl,
    share_slo,
    trace,
    write_jsonl,
)
from repro_torch.serve import (
    GraphService,
    LoadGenerator,
    QueryClass,
    ServiceOverloaded,
    Workload,
    edge_state_at_version,
    oracle_kwargs,
)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _norm(v):
    return np.nan_to_num(v, posinf=1e30)


def _mk_service(tmp_path, tag, g, **kw):
    kw.setdefault("num_shards", 6)
    kw.setdefault("window", 128)
    kw.setdefault("k", 16)
    kw.setdefault("backend", "numpy")
    return GraphService.from_graph(g, str(tmp_path / tag), device="cpu", **kw)


MIX = (
    QueryClass("bfs", weight=2.0, max_iters=8),
    QueryClass("sssp", weight=1.0, max_iters=8),
    QueryClass("wcc", weight=1.0, max_iters=8),
    QueryClass("ppr", weight=1.0, max_iters=6, params={"damping": 0.85}),
)
REF_MIX = tuple(RefQueryClass(c.program, weight=c.weight, max_iters=c.max_iters,
                              params=c.params) for c in MIX)


# ------------------------------------------------------ windowed histograms
def test_histogram_reset_clears_everything():
    h = Histogram("h")
    for x in (0.5, 1.0, 2.0, 0.0, -3.0):
        h.record(x)
    assert h.count == 5
    h.reset()
    assert h.count == 0 and h.total == 0.0
    assert h.quantile(0.99) == 0.0
    assert h.percentiles()["max"] == 0.0
    h.record(7.0)  # usable after reset
    assert h.count == 1


def test_window_since_sees_only_new_records():
    rng = np.random.default_rng(3)
    first = rng.lognormal(-6, 1.2, 4000)
    second = rng.lognormal(-4, 0.8, 6000)
    h = Histogram("h")
    for x in first:
        h.record(float(x))
    mark = h.state()
    w0 = h.window_since(None)  # full-lifetime window
    assert w0.count == len(first)
    for x in second:
        h.record(float(x))
    w = h.window_since(mark)
    assert w.count == len(second)
    assert w.mean == pytest.approx(second.mean(), rel=1e-6)
    for q in (0.5, 0.95, 0.99):
        exact = float(np.quantile(second, q))
        assert abs(w.quantile(q) - exact) / exact < 0.10, q
    # the live histogram keeps its lifetime data
    assert h.count == len(first) + len(second)
    # empty diff
    we = h.window_since(h.state())
    assert we.count == 0 and we.quantile(0.99) == 0.0


def test_window_merge_and_fraction_above():
    h = Histogram("h")
    lows, highs = [0.01] * 80, [1.0] * 20
    for x in lows:
        h.record(x)
    mark = h.state()
    w1 = h.window_since(None)
    for x in highs:
        h.record(x)
    w2 = h.window_since(mark)
    m = w1.merge(w2)
    assert m.count == 100
    assert m.total == pytest.approx(sum(lows) + sum(highs), rel=1e-9)
    assert w2.fraction_above(0.1) == pytest.approx(1.0)
    assert m.fraction_above(0.1) == pytest.approx(0.2)
    assert m.fraction_above(10.0) == 0.0
    p = m.percentiles()
    assert p["count"] == 100 and p["p50"] <= p["p99"]


# ------------------------------------------------------------- time series
def test_timeseries_counter_deltas_and_ring_bound():
    reg = MetricsRegistry()
    c = reg.counter("ops")
    h = reg.histogram("lat")
    ts = TimeSeriesRegistry(reg, capacity=4, interval_s=0.01)
    for k in range(6):
        c.add(10)
        h.record(0.1 * (k + 1))
        s = ts.tick()
        assert s.counters["ops"] == pytest.approx(10.0)
        assert s.histograms["lat"].count == 1
    assert ts.num_windows == 6
    assert len(ts.samples()) == 4  # bounded ring
    assert ts.dropped_samples == 2
    # window-delta conservation over the retained + dropped history
    assert c.value == pytest.approx(60.0)
    m = ts.merged(last_s=3600.0)
    assert m.samples == 4
    assert m.counters["ops"] == pytest.approx(40.0)  # 4 retained windows
    assert m.histograms["lat"].count == 4
    assert ts.series("ops") == [(s.wall_ts, 10.0) for s in ts.samples()]


def test_timeseries_background_ticker():
    reg = MetricsRegistry()
    reg.counter("x").add(1)
    ts = TimeSeriesRegistry(reg, interval_s=0.02)
    with ts.start():
        with pytest.raises(RuntimeError):
            ts.start()
        # poll to a deadline rather than sleep a fixed time: a loaded
        # machine may tick late, never early
        deadline = time.monotonic() + 30.0
        while ts.num_windows < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
    ts.stop()  # idempotent
    assert ts.num_windows >= 3
    assert sum(s.counters.get("x", 0.0) for s in ts.samples()) == 1.0


# ---------------------------------------------------------------- SLO gates
def _fill(reg, ts, *, n, bad_frac, lat=0.01, bad_lat=1.0, ticks=4):
    for _ in range(ticks):
        for i in range(n // ticks):
            is_bad = (i / max(n // ticks, 1)) < bad_frac
            reg.histogram("query.latency_s").record(
                bad_lat if is_bad else lat
            )
            reg.counter("query.completed").add(1)
        ts.tick()


def test_slo_no_false_violations_on_healthy_traffic():
    reg = MetricsRegistry()
    ts = TimeSeriesRegistry(reg, interval_s=0.05)
    mon = SLOMonitor(ts, [
        latency_slo("lat", threshold_s=0.5, budget=0.01),
        error_rate_slo("err", budget=0.01,
                       total=("query.completed",)),
        share_slo("qw", budget=0.9),
    ])
    _fill(reg, ts, n=400, bad_frac=0.0)
    for _ in range(3):
        assert mon.evaluate() == []
    assert mon.violations == []
    snap = mon.snapshot()
    assert snap["active"] == [] and len(snap["objectives"]) == 3


def test_slo_fires_on_sustained_burn_and_dedups():
    reg = MetricsRegistry()
    ts = TimeSeriesRegistry(reg, interval_s=0.05)
    mon = SLOMonitor(
        ts,
        [latency_slo("lat", threshold_s=0.5, budget=0.01)],
        windows=((10.0, 2.0, 2.0),),
    )
    # 20% of queries blow the threshold: burn = 0.2/0.01 = 20 >> 2
    _fill(reg, ts, n=400, bad_frac=0.2)
    new = mon.evaluate()
    assert len(new) == 1
    v = new[0]
    assert v.slo == "lat" and v.kind == "latency"
    assert v.burn_long >= 2.0 and v.burn_short >= 2.0
    assert v.bad_fraction == pytest.approx(0.2, abs=0.05)
    assert reg.counter("slo.violations").value == 1
    # still bad: edge-triggered, no second record
    assert mon.evaluate() == []
    assert len(mon.violations) == 1
    d = v.to_dict()
    assert d["slo"] == "lat" and d["long_s"] == 10.0


def test_slo_min_events_guard_and_recovery():
    reg = MetricsRegistry()
    ts = TimeSeriesRegistry(reg, interval_s=0.05)
    slo = latency_slo("lat", threshold_s=0.5, budget=0.01, min_events=50)
    mon = SLOMonitor(ts, [slo], windows=((0.4, 0.4, 2.0),))
    # only 10 (all-bad) events: below min_events -> never a violation
    for _ in range(10):
        reg.histogram("query.latency_s").record(1.0)
    ts.tick()
    assert mon.evaluate() == []
    # plenty of bad events -> trips; then healthy windows age it out
    _fill(reg, ts, n=200, bad_frac=1.0, ticks=2)
    assert len(mon.evaluate()) == 1
    time.sleep(0.5)  # the 0.4 s window now holds only what comes next
    _fill(reg, ts, n=200, bad_frac=0.0, ticks=2)
    assert mon.evaluate() == []  # recovered, _active cleared
    _fill(reg, ts, n=200, bad_frac=1.0, ticks=2)
    assert len(mon.evaluate()) == 1  # re-trips after recovery


def test_slo_validation():
    reg = MetricsRegistry()
    ts = TimeSeriesRegistry(reg)
    with pytest.raises(ValueError):
        latency_slo("x", threshold_s=1.0, budget=0.0)
    with pytest.raises(ValueError):
        SLOMonitor(ts, [latency_slo("a", threshold_s=1.0),
                        latency_slo("a", threshold_s=2.0)])
    with pytest.raises(ValueError):
        SLOMonitor(ts, [latency_slo("a", threshold_s=1.0)],
                   windows=((5.0, 10.0, 2.0),))


@pytest.mark.parametrize("bad_frac", [0.0, 0.004, 0.2, 1.0])
def test_slo_verdicts_and_burn_rates_match_the_reference(bad_frac):
    """The same records in the same windows: both monitors trip on the
    same objectives with the same burn rates and violation records."""
    rng = np.random.default_rng(int(bad_frac * 1000) + 1)
    lat = rng.lognormal(-5.0, 0.5, 600)
    bad = rng.random(600) < bad_frac
    sides = []
    for Reg, Series, Mon, lat_slo, err_slo, sh_slo in (
            (MetricsRegistry, TimeSeriesRegistry, SLOMonitor, latency_slo,
             error_rate_slo, share_slo),
            (RefRegistry, RefSeries, RefMonitor, ref_latency_slo,
             ref_error_rate_slo, ref_share_slo)):
        reg = Reg()
        ts = Series(reg, interval_s=0.05)
        mon = Mon(ts, [lat_slo("lat", threshold_s=0.5, budget=0.01),
                       err_slo("err", budget=0.05),
                       sh_slo("qw", budget=0.3)],
                  windows=((3600.0, 1800.0, 2.0), (3600.0, 3600.0, 1.0)))
        verdicts = []
        for w in range(6):
            for i in range(w * 100, (w + 1) * 100):
                x = 2.0 if bad[i] else float(lat[i])
                reg.histogram("query.latency_s").record(x)
                reg.histogram("query.queue_wait_s").record(x * 0.25)
                reg.counter("query.rejected" if bad[i] and i % 2
                            else "query.completed").add(1)
            ts.tick()
            verdicts.append([v.to_dict() for v in mon.evaluate(wall_ts=w)])
        sides.append((verdicts, mon.snapshot(), reg.counter(
            "slo.violations").value if mon.violations else 0.0))
    assert sides[0] == sides[1]
    assert bool(sides[0][1]["violations"]) == (bad_frac >= 0.2)


# ------------------------------------------------------------------ exports
def test_prometheus_roundtrip_registry_and_snapshot():
    reg = MetricsRegistry()
    reg.counter("query.completed").add(7)
    reg.gauge("queue.depth").set(3.0)
    h = reg.histogram("query.latency_s")
    for x in (0.01, 0.02, 0.05):
        h.record(x)
    text = prometheus_text(reg)
    parsed = parse_prometheus(text)
    assert parsed["graphmp_query_completed"] == 7.0
    assert parsed["graphmp_queue_depth"] == 3.0
    assert parsed["graphmp_query_latency_s_count"] == 3.0
    assert parsed['graphmp_query_latency_s{quantile="0.99"}'] == \
        pytest.approx(0.05, rel=0.10)
    # snapshot-dict form (histograms as percentile blocks)
    snap = {"lat": h.percentiles(), "done": 7.0}
    parsed2 = parse_prometheus(prometheus_text(snap, namespace="svc"))
    assert parsed2["svc_done"] == 7.0
    assert parsed2['svc_lat{quantile="0.5"}'] == \
        pytest.approx(h.quantile(0.5))
    with pytest.raises(ValueError):
        parse_prometheus("this is { not a sample\n")


@pytest.mark.parametrize("seed", [0, 5])
def test_prometheus_text_matches_the_reference(seed):
    """The same instruments recorded in both packages render to the same
    exposition text, from the registry and from its snapshot."""
    rng = np.random.default_rng(seed)
    regs = (MetricsRegistry(), RefRegistry())
    values = rng.lognormal(-4.0, 2.0, 500)
    for reg in regs:
        reg.counter("query.completed").add(17 + seed)
        reg.counter("9lives").add(0.5)
        reg.gauge("sweep.live_lanes").set(12)
        reg.gauge("weird-name/x").set(-3.25)
        h = reg.histogram("query.latency_s")
        for x in values:
            h.record(float(x))
        h.record(0.0)
        reg.histogram("empty.h")
    mine, ref = regs
    assert prometheus_text(mine) == ref_prometheus_text(ref)
    assert prometheus_text(mine.snapshot(), namespace="svc") == \
        ref_prometheus_text(ref.snapshot(), namespace="svc")


def test_jsonl_roundtrip(tmp_path):
    reg = MetricsRegistry()
    ts = TimeSeriesRegistry(reg, interval_s=0.01)
    for k in range(3):
        reg.counter("ops").add(k + 1)
        reg.histogram("lat").record(0.01 * (k + 1))
        ts.tick()
    path = str(tmp_path / "pulse.jsonl")
    assert write_jsonl(path, ts) == 3
    docs = read_jsonl(path)
    assert [d["index"] for d in docs] == [0, 1, 2]
    assert docs[1]["counters"]["ops"] == 2.0
    assert docs[2]["histograms"]["lat"]["count"] == 1
    assert write_jsonl(path, ts, append=True) == 3
    assert len(read_jsonl(path)) == 6
    assert len(list(jsonl_lines(ts.samples()))) == 3
    (tmp_path / "bad.jsonl").write_text('{"index": 0}\n')
    with pytest.raises(ValueError):
        read_jsonl(str(tmp_path / "bad.jsonl"))


# ------------------------------------------------- typed errors + trace drops
def test_tracer_ring_overflow_is_loud():
    t = Tracer(capacity=8)
    with trace.tracing(t):
        for i in range(50):
            trace.instant("tick", i=i)
        assert trace.dropped_events() == 42
        reg = MetricsRegistry()
        assert trace.publish_drops(reg) == 42
        assert reg.counter("trace.dropped_events").value == 42
        trace.publish_drops(reg)  # idempotent mirror, not double-count
        assert reg.counter("trace.dropped_events").value == 42
    doc = t.export_chrome()
    assert doc["otherData"]["dropped_events"] == 42
    assert "truncated" in doc["otherData"]["warning"]
    # healthy tracer: no warning key, no counter created
    t2 = Tracer(capacity=64)
    with trace.tracing(t2):
        trace.instant("ok")
        reg2 = MetricsRegistry()
        trace.publish_drops(reg2)
        assert "trace.dropped_events" not in reg2.snapshot()
    assert "warning" not in t2.export_chrome()["otherData"]
    assert trace.dropped_events() == 0  # tracing disabled -> 0


def test_rejection_counts_as_typed_metric(tmp_path):
    g = rmat_graph(400, 4000, seed=2)
    svc = _mk_service(tmp_path, "svc", g, max_pending=1, max_lanes=2,
                      session_entries=0)
    rejected = 0
    with svc.submit_batch():  # worker blocked: queue must overflow
        futs = []
        for s in range(8):
            try:
                futs.append(svc.submit("bfs", s, max_iters=4))
            except ServiceOverloaded:
                rejected += 1
    for f in futs:
        f.result(timeout=60)
    assert rejected > 0
    snap = svc.metrics_snapshot()
    assert snap["errors"]["rejected"] == rejected
    assert snap["errors"]["completed"] == len(futs)
    svc.close()


def test_shard_load_error_counts_as_typed_metric(tmp_path):
    g = rmat_graph(400, 4000, seed=2)
    svc = _mk_service(tmp_path, "svc", g, session_entries=0)
    eng = svc.engine
    orig = eng.store.shard_bytes

    def poisoned(p, fmt="csr"):
        if p == 1:
            raise OSError(f"disk hole at shard {p}")
        return orig(p, fmt)

    eng.store.shard_bytes = poisoned
    eng.pipeline.cache = None
    eng.pipeline.resident = None
    with pytest.raises(Exception):
        svc.query("bfs", 0, max_iters=4)
    snap = svc.metrics_snapshot()
    assert snap["errors"]["shard_load_errors"] >= 1
    eng.store.shard_bytes = orig
    svc.close()


# --------------------------------------------- service telemetry lifecycle
def test_service_telemetry_lifecycle_and_windowed_snapshot(tmp_path):
    g = rmat_graph(500, 5000, seed=5)
    svc = _mk_service(tmp_path, "svc", g)
    ts = svc.start_telemetry(interval_s=0.03)
    assert svc.timeseries is ts and svc.slo_monitor is None
    with pytest.raises(RuntimeError):
        svc.start_telemetry()
    for s in range(6):
        svc.query("bfs", s, max_iters=6)
    deadline = time.monotonic() + 30.0
    while ts.num_windows < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    w1 = svc.metrics_snapshot(window=True)
    assert w1["query_latency_s"]["count"] >= 6
    svc.query("bfs", 100, max_iters=6)
    w2 = svc.metrics_snapshot(window=True)
    assert w2["query_latency_s"]["count"] == 1  # only the new record
    life = svc.metrics_snapshot()  # lifetime view unaffected by windowing
    assert life["query_latency_s"]["count"] >= 7
    assert "timeseries" in life and life["timeseries"]["windows"] >= 2
    assert "slo" not in life
    got = svc.stop_telemetry()
    assert got is ts and svc.stop_telemetry() is None  # idempotent
    assert svc.timeseries is None
    assert "timeseries" not in svc.metrics_snapshot()
    svc.start_telemetry(interval_s=0.05)  # restart allowed after stop
    svc.close()  # close stops telemetry
    assert svc.timeseries is None


def test_service_telemetry_with_slos_names_its_thread(tmp_path):
    """The ticker runs on ``graphpulse-ticker`` and evaluates the SLOs each
    tick; the snapshot's ``slo`` block is the monitor's."""
    g = rmat_graph(300, 3000, seed=6)
    with _mk_service(tmp_path, "svc", g, backend="cuda") as svc:
        ts = svc.start_telemetry(interval_s=0.02, slos=[
            latency_slo("lat", threshold_s=60.0, budget=0.01),
            error_rate_slo("err", budget=0.05)])
        assert any(t.name == "graphpulse-ticker" for t in threading.enumerate())
        for s in range(4):
            svc.query("sssp", s, max_iters=5)
        mon = svc.slo_monitor
        deadline = time.monotonic() + 30.0
        while mon.snapshot()["evaluations"] < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        snap = svc.metrics_snapshot()
        assert snap["slo"]["evaluations"] >= 2
        assert [o["name"] for o in snap["slo"]["objectives"]] == ["lat", "err"]
        assert snap["slo"]["violations"] == []
        assert svc.stop_telemetry(final_tick=True) is ts
        assert sum(s.counters.get("query.completed", 0.0)
                   for s in ts.samples()) == 4.0
    assert not any(t.name == "graphpulse-ticker" and t.is_alive()
                   for t in threading.enumerate())


# ------------------------------------- concurrent snapshotting (no tearing)
_CONCURRENT_VALS = {}  # traced -> stacked result values (cross-param check)


@pytest.mark.parametrize("traced", [False, True])
def test_concurrent_snapshots_mid_sweep(tmp_path, traced):
    """metrics_snapshot() + external ticks from a second thread while a
    fused workload runs: no exceptions, window-delta conservation exact,
    and the traced run's values bitwise-match the untraced run's."""
    g = rmat_graph(800, 12_000, seed=9)
    svc = _mk_service(tmp_path, f"svc{traced}", g, session_entries=0,
                      max_lanes=8, backend="cuda")
    # capacity must hold every window of the run: the conservation check
    # below sums ALL deltas, so nothing may fall off the ring
    ts = TimeSeriesRegistry(svc.metrics, capacity=1 << 16,
                            interval_s=0.005)
    stop = threading.Event()
    errors = []

    def hammer():
        while not stop.is_set():
            try:
                ts.tick()
                svc.metrics_snapshot()
                time.sleep(0.001)
            except Exception as exc:  # pragma: no cover
                errors.append(exc)

    th = threading.Thread(target=hammer, daemon=True)
    th.start()
    tracer = Tracer() if traced else None
    sources = list(range(0, 64, 4))
    try:
        if traced:
            trace.install(tracer)
        futs = [svc.submit("sssp", s, max_iters=10) for s in sources]
        vals = {s: f.result(timeout=120).values for s, f in
                zip(sources, futs)}
    finally:
        if traced:
            trace.uninstall()
        stop.set()
        th.join()
    assert not errors
    ts.tick()  # close the final window
    # conservation: all window deltas sum to the live counter, exactly
    done = svc.metrics.counter("query.completed").value
    deltas = sum(s.counters.get("query.completed", 0.0)
                 for s in ts.samples())
    assert ts.dropped_samples == 0
    assert deltas == pytest.approx(done, abs=0)
    assert done == len(sources)
    assert len(svc.metrics_snapshot()["conservation_violations"]) == 0
    svc.close()
    _CONCURRENT_VALS[traced] = np.stack([vals[s] for s in sources])
    if traced and False in _CONCURRENT_VALS:
        # traced == untraced, bitwise: observation changed nothing
        assert np.array_equal(_norm(_CONCURRENT_VALS[False]),
                              _norm(_CONCURRENT_VALS[True]))


# ------------------------------------------------------------- load harness
def test_workload_plan_is_deterministic():
    wl = Workload(classes=MIX, seed=11, update_every=8, update_batch=4)
    p1 = wl.plan(1000, 32)
    p2 = wl.plan(1000, 32)
    assert np.array_equal(p1.cls_idx, p2.cls_idx)
    assert np.array_equal(p1.sources, p2.sources)
    assert len(p1.updates) == 4
    for a, b in zip(p1.updates, p2.updates):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError):
        Workload(classes=())
    with pytest.raises(ValueError):
        QueryClass("bfs", weight=0.0)


@pytest.mark.parametrize("seed,total,every", [(0, 32, 8), (29, 24, 12),
                                              (11, 64, 0), (12345, 7, 3)])
def test_workload_plan_and_arrivals_match_the_reference(seed, total, every):
    """Bit for bit the reference's schedule: the same classes, sources and
    update batches, and the same even and Poisson arrival gaps."""
    kw = dict(seed=seed, update_every=every, update_batch=16)
    mine = Workload(classes=MIX, **kw).plan(2 << 20, total)
    ref = RefWorkload(classes=REF_MIX, **kw).plan(2 << 20, total)
    assert np.array_equal(mine.cls_idx, ref.cls_idx)
    assert np.array_equal(mine.sources, ref.sources)
    assert mine.cls_idx.dtype == ref.cls_idx.dtype
    assert len(mine.updates) == len(ref.updates) == (total // every
                                                     if every else 0)
    for a, b in zip(mine.updates, ref.updates):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for poisson in (False, True):
        gen = LoadGenerator(None, Workload(classes=MIX, **kw), mode="open",
                            target_qps=3.5, poisson=poisson, total_ops=total)
        ref_gen = RefLoadGenerator(None, RefWorkload(classes=REF_MIX, **kw),
                                   mode="open", target_qps=3.5,
                                   poisson=poisson, total_ops=total)
        assert np.array_equal(gen._arrival_gaps(), ref_gen._arrival_gaps())


def test_closed_loop_phases_and_report(tmp_path):
    g = rmat_graph(600, 8000, seed=8)
    svc = _mk_service(tmp_path, "svc", g, max_lanes=8)
    wl = Workload(classes=MIX, seed=21)
    rep = LoadGenerator(svc, wl, mode="closed", concurrency=3,
                        batch_size=2, total_ops=24, warmup_ops=6).run()
    assert rep.mode == "closed"
    assert rep.warmup_records == 6
    assert rep.submitted == 18  # measure phase only
    assert rep.completed == 18 and rep.errors == 0 and rep.rejected == 0
    assert rep.qps > 0 and rep.latency["count"] == 18
    assert sum(rep.per_class.values()) == 18
    assert 0.0 <= rep.queue_wait_share <= 1.0
    assert len(rep.records) == 24  # warmup kept in the raw records
    summ = rep.summary()
    assert "records" not in summ and summ["qps"] == rep.qps
    svc.close()


def test_open_loop_records_rejections(tmp_path):
    g = rmat_graph(600, 8000, seed=8)
    svc = _mk_service(tmp_path, "svc", g, max_lanes=2, max_pending=1,
                      session_entries=0)
    wl = Workload(classes=(QueryClass("ppr", max_iters=6,
                                      params={"damping": 0.85}),), seed=3)
    rep = LoadGenerator(svc, wl, mode="open", target_qps=500.0,
                        total_ops=30).run()
    assert rep.submitted == 30
    assert rep.completed + rep.rejected == 30
    assert rep.rejected > 0  # the cap must have pushed back
    for r in rep.records:
        if r.rejected:
            assert not r.ok and r.values is None
    # rejections are typed, not silent
    assert svc.metrics_snapshot()["errors"]["rejected"] == rep.rejected
    svc.close()


def test_loadgen_bitwise_oracle_across_versions(tmp_path):
    """The harness's own determinism contract: every completed query,
    under a live mutation stream, equals a solo engine run at exactly its
    graph version."""
    rng = np.random.default_rng(17)
    n = 500
    edges = rng.integers(0, n, size=(6000, 2)).astype(np.int64)
    g = from_edge_list(edges, n)
    svc = _mk_service(tmp_path, "svc", g, max_lanes=8)
    wl = Workload(classes=MIX, seed=5, update_every=10, update_batch=6)
    rep = LoadGenerator(svc, wl, mode="closed", concurrency=4,
                        total_ops=30).run()
    svc.close()
    assert rep.updates_published >= 1  # the stream actually mutated
    recs = [r for r in rep.records if r.ok]
    assert len(recs) == 30
    versions = sorted({r.graph_version for r in recs})
    assert len(versions) >= 2  # queries spanned a publish
    for v in versions:
        g_v = from_edge_list(
            edge_state_at_version(edges, rep.updates, v), n
        )
        eng = VSWEngine.from_graph(
            g_v, str(tmp_path / f"oracle{v}"), num_shards=6,
            window=128, k=16, backend="numpy", device="cpu",
        )
        for r in recs:
            if r.graph_version != v:
                continue
            solo = eng.run(apps.get_program(r.program, **oracle_kwargs(r)),
                           max_iters=r.max_iters)
            assert np.array_equal(_norm(solo.values), _norm(r.values)), (
                v, r.program, r.source)
        eng.close()


@pytest.mark.parametrize("backend,mode", [("numpy", "closed"),
                                          ("numpy", "open"),
                                          ("cuda", "closed"),
                                          ("cuda", "open")])
def test_loadgen_records_match_the_reference_solo_engine(tmp_path, backend,
                                                         mode):
    """Every completed record of the port's service, closed or open loop
    under a mutation stream, against the REFERENCE's solo numpy engine
    built at the record's version (see the module docstring for PPR on
    the ``cuda`` backend)."""
    rng = np.random.default_rng(23)
    n = 600
    edges = rng.integers(0, n, size=(7000, 2)).astype(np.int64)
    svc = _mk_service(tmp_path, "svc", from_edge_list(edges, n), max_lanes=8,
                      backend=backend, session_entries=0)
    wl = Workload(classes=MIX, seed=31, update_every=8, update_batch=5)
    kw = (dict(concurrency=4) if mode == "closed"
          else dict(target_qps=20.0, poisson=True))
    rep = LoadGenerator(svc, wl, mode=mode, total_ops=24, warmup_ops=4,
                        **kw).run()
    svc.close()
    recs = [r for r in rep.records if r.ok]
    assert len(recs) == 24 and rep.updates_published == 3
    if mode == "open":  # paced arrivals: sweeps end between publishes
        assert len({r.graph_version for r in recs}) >= 2
    for v in sorted({r.graph_version for r in recs}):
        edges_v = edge_state_at_version(edges, rep.updates, v)
        ref = RefEngine.from_graph(ref_from_edge_list(edges_v, n),
                                   str(tmp_path / f"ref{v}"), num_shards=6,
                                   window=128, k=16, backend="numpy")
        own = None
        if backend == "cuda":
            own = VSWEngine.from_graph(from_edge_list(edges_v, n),
                                       str(tmp_path / f"own{v}"), num_shards=6,
                                       window=128, k=16, backend="cuda",
                                       device="cpu")
        for r in recs:
            if r.graph_version != v:
                continue
            want = ref.run(ref_apps.get_program(r.program, **oracle_kwargs(r)),
                           max_iters=r.max_iters)
            where = (v, r.program, r.source)
            if backend == "cuda" and r.program == "ppr":
                solo = own.run(apps.get_program(r.program, **oracle_kwargs(r)),
                               max_iters=r.max_iters)
                assert np.array_equal(solo.values, r.values), where
                assert np.allclose(r.values, want.values, rtol=1e-5,
                                   atol=1e-9), where
            else:
                assert np.array_equal(_norm(want.values), _norm(r.values)), where
            assert (r.iterations, r.converged) == (want.num_iterations,
                                                   want.converged), where
        ref.close()
        if own is not None:
            own.close()


def test_loadgen_validation(tmp_path):
    g = rmat_graph(200, 1000, seed=1)
    svc = _mk_service(tmp_path, "svc", g)
    wl = Workload(classes=MIX)
    with pytest.raises(ValueError):
        LoadGenerator(svc, wl, mode="weird")
    with pytest.raises(ValueError):
        LoadGenerator(svc, wl, mode="open")  # needs target_qps
    with pytest.raises(ValueError):
        LoadGenerator(svc, wl, warmup_ops=9, total_ops=9)
    with pytest.raises(ValueError):
        LoadGenerator(svc, wl, batch_size=0)
    svc.close()
