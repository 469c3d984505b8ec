"""The port's observability: trace well-formedness and metric conservation.

Carried from ``tests/test_obs.py`` (the mesh sweep's conservation test
waits for the multi-device port, ROADMAP Queue 1 item 8):

1. **Trace well-formedness** — a traced ``GraphService`` run on a mixed
   fused workload exports valid Chrome-trace JSON: every span closed,
   per-thread timestamps monotonic, durations non-negative, and the
   admit -> plan -> load -> decode -> dispatch -> retire story visible
   across at least three thread lanes.
2. **Conservation** — ``MetricsRegistry.ingest`` declares each stats
   class's identities (the reference's nine classes, ``CollectiveStats``
   the dry run's collective counts) and one shared
   ``verify_conservation()`` replays them.
3. **Zero-cost disabled path** — with no tracer installed every call site
   returns the shared no-op span; results are unchanged.

Against the reference, on the same inputs: the ``IngestStats``,
``CompactionStats`` and ``CollectiveStats`` adapters give the reference's
snapshot and the same conservation verdicts (equal as values: no sum is
involved).
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.ingest import IngestStats as RefIngestStats
from repro.delta.recompact import CompactionStats as RefCompactionStats
from repro.obs import MetricsRegistry as RefRegistry
from repro_torch.core.cache import CacheStats
from repro_torch.core.executor import ExecStats
from repro_torch.core.graph import rmat_graph
from repro_torch.core.ingest import IngestStats
from repro_torch.core.pipeline import PipelineStats, ShardLoadError
from repro_torch.core.storage import IOStats
from repro_torch.core.vsw import IterStats, VSWEngine
from repro_torch.delta.recompact import CompactionStats
from repro_torch.roofline.analysis import CollectiveStats
from repro_torch.obs import (
    NULL_SPAN,
    ConservationError,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Tracer,
    trace,
)
from repro_torch.serve import GraphService
from repro_torch.serve.sweep import SweepIterStats


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mk_service(tmp_path, tag, g, **kw):
    kw.setdefault("num_shards", 6)
    kw.setdefault("window", 128)
    kw.setdefault("k", 16)
    kw.setdefault("backend", "cuda")
    return GraphService.from_graph(g, str(tmp_path / tag), device="cpu", **kw)


def _mk_engine(tmp_path, tag, g, **kw):
    kw.setdefault("num_shards", 6)
    kw.setdefault("window", 128)
    kw.setdefault("k", 16)
    kw.setdefault("backend", "cuda")
    return VSWEngine.from_graph(g, str(tmp_path / tag), device="cpu", **kw)


# ---------------------------------------------------------------- histogram
def test_histogram_quantiles_match_numpy():
    rng = np.random.default_rng(0)
    xs = rng.lognormal(mean=-6.0, sigma=1.5, size=20_000)
    h = Histogram("lat")
    for x in xs:
        h.record(float(x))
    for q in (0.5, 0.95, 0.99):
        exact = float(np.quantile(xs, q))
        est = h.quantile(q)
        assert abs(est - exact) / exact < 0.10, (q, est, exact)
    p = h.percentiles()
    assert p["count"] == len(xs)
    assert p["min"] == pytest.approx(xs.min())
    assert p["max"] == pytest.approx(xs.max())
    assert p["p50"] <= p["p95"] <= p["p99"] <= p["max"]


def test_histogram_edge_cases():
    h = Histogram("h")
    assert h.quantile(0.5) == 0.0  # empty
    h.record(0.0)  # zero-duration sample must not blow up log()
    h.record(-1.0)
    h.record(5.0)
    assert h.count == 3
    assert h.quantile(1.0) == pytest.approx(5.0, rel=0.07)  # bucket width
    with pytest.raises(ValueError):
        h.quantile(1.5)
    h2 = Histogram("h2")
    h2.record(10.0)
    h.merge(h2)
    assert h.count == 4 and h.max == 10.0


# ----------------------------------------------------------------- registry
def test_registry_typed_instruments():
    reg = MetricsRegistry()
    c = reg.counter("a")
    assert isinstance(c, Counter) and reg.counter("a") is c
    c.add(3)
    assert reg.value("a") == 3
    with pytest.raises(ValueError):
        c.add(-1)
    g = reg.gauge("g")
    assert isinstance(g, Gauge)
    g.set(7)
    assert reg.value("g") == 7
    with pytest.raises(TypeError):
        reg.histogram("a")  # name already bound to a Counter


def test_registry_ingests_all_eight_stats_classes():
    """The reference's nine stats classes: the eight of the engine, and
    ``CollectiveStats`` (the dry run's), the ninth.  ``IngestStats``,
    ``CompactionStats`` and ``CollectiveStats`` raised ``TypeError: no
    metrics adapter`` before their adapters were ported."""
    reg = MetricsRegistry()
    reg.ingest(IOStats(bytes_read=10, reads=1))
    reg.ingest(CacheStats(hits=2, misses=3))
    reg.ingest(PipelineStats(shards_loaded=5))
    reg.ingest(ExecStats(dispatches=2, shards_executed=4, batches=2,
                         ragged_dispatches=1, ragged_lanes=6,
                         group_lanes={0: 4, 1: 2}))
    reg.ingest(IterStats(
        iteration=0, time_s=0.1, shards_processed=4, shards_skipped=2,
        bytes_read=100, cache_hits=1, cache_misses=3, active_count=7,
        active_ratio=0.5, selective_on=True, dispatches=2))
    reg.ingest(SweepIterStats(
        iteration=0, live_lanes=4, shards_processed=4, shards_skipped=0,
        bytes_read=64, selective_on=False, retired=1, backfilled=0,
        time_s=0.05, dispatches=2, batches=2))
    reg.ingest(IngestStats(
        num_edges=10, spill_bytes_written=8, spill_bytes_read=8,
        shard_bytes_written=100, meta_bytes_written=20))
    reg.ingest(CompactionStats(shards_compacted=1, runs_absorbed=2))
    reg.ingest(CollectiveStats({"all-gather": 64, "all-reduce": 8},
                               {"all-gather": 1, "all-reduce": 1}))
    assert reg.verify_conservation() == []
    assert reg.num_checks > 0
    snap = reg.snapshot()
    assert snap["collective.bytes.all-gather"] == 64
    assert snap["io.bytes_read"] == 10
    assert snap["cache.hits"] == 2
    assert snap["ingest.num_edges"] == 10
    assert snap["compact.runs_absorbed"] == 2
    assert isinstance(snap["iter.time_s"], dict)
    with pytest.raises(TypeError):
        reg.ingest(object())


def test_verify_conservation_catches_violation():
    reg = MetricsRegistry()
    # sum(group_lanes) != ragged_lanes: a mis-attributed ragged lane axis.
    reg.ingest(ExecStats(dispatches=1, batches=1, ragged_dispatches=1,
                         ragged_lanes=5, group_lanes={0: 2, 1: 2}))
    with pytest.raises(ConservationError, match="group_lanes"):
        reg.verify_conservation()
    assert len(reg.verify_conservation(strict=False)) == 1
    # identities can also be declared directly
    reg2 = MetricsRegistry()
    reg2.check("bytes split", 99.9999999, 100.0, tol=1e-6)
    assert reg2.verify_conservation() == []
    reg2.check("bad", 1.0, 2.0)
    with pytest.raises(ConservationError, match="bad"):
        reg2.verify_conservation()


_INGEST_CASES = [
    dict(num_edges=10, spill_bytes_written=8, spill_bytes_read=8,
         shard_bytes_written=100, meta_bytes_written=20, spills=1, runs=3),
    dict(num_edges=7, spill_bytes_written=64, spill_bytes_read=32,
         shard_bytes_written=5, meta_bytes_written=0),  # half read back
]


@pytest.mark.parametrize("case", range(len(_INGEST_CASES)))
def test_ingest_and_compaction_adapters_match_the_reference(case):
    """The same IngestStats / CompactionStats fields through either
    package's registry: the same snapshot and the same violations."""
    kw = _INGEST_CASES[case]
    ckw = dict(shards_compacted=3, runs_absorbed=5, inserts_applied=40,
               tombstones_applied=9, shard_bytes_written=4096 + case)
    mine, ref = MetricsRegistry(), RefRegistry()
    mine.ingest(IngestStats(**kw))
    ref.ingest(RefIngestStats(**kw))
    mine.ingest(CompactionStats(**ckw), prefix="rc")
    ref.ingest(RefCompactionStats(**ckw), prefix="rc")
    assert mine.snapshot() == ref.snapshot()
    assert mine.num_checks == ref.num_checks
    got = mine.verify_conservation(strict=False)
    assert got == ref.verify_conservation(strict=False)
    assert bool(got) == (case == 1)


def test_collective_adapter_matches_the_reference():
    """The same CollectiveStats through either package's registry: the same
    snapshot and the same (passing) identity."""
    from repro.roofline.analysis import CollectiveStats as RefCollectiveStats

    by = {"all-gather": 4096, "all-reduce": 120, "reduce-scatter": 0,
          "all-to-all": 7, "collective-permute": 0}
    count = {"all-gather": 2, "all-reduce": 1, "reduce-scatter": 0,
             "all-to-all": 1, "collective-permute": 0}
    mine, ref = MetricsRegistry(), RefRegistry()
    mine.ingest(CollectiveStats(dict(by), dict(count)), prefix="dry")
    ref.ingest(RefCollectiveStats(dict(by), dict(count)), prefix="dry")
    assert mine.snapshot() == ref.snapshot()
    assert mine.num_checks == ref.num_checks
    assert mine.verify_conservation() == ref.verify_conservation() == []


# ------------------------------------------------------------- tracer basics
def test_disabled_tracing_is_noop():
    assert trace.active() is None
    sp = trace.span("anything", shard=3)
    assert sp is NULL_SPAN
    with sp:
        pass  # no state, no error
    trace.counter("c", 1.0)
    trace.instant("i")


def test_span_nesting_and_wellformedness():
    tr = Tracer()
    with trace.tracing(tr):
        with trace.span("outer", a=1):
            with trace.span("inner"):
                pass
            with trace.span("inner"):
                pass
        assert tr.open_span_count() == 0
    assert trace.active() is None
    out = tr.export_chrome()
    xs = [e for e in out["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in xs] == ["inner", "inner", "outer"]
    outer = xs[-1]
    for inner in xs[:2]:
        assert outer["ts"] <= inner["ts"]
        assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3
    assert outer["args"] == {"a": 1}


def test_counter_events_export_as_chrome_counters():
    tr = Tracer()
    with trace.tracing(tr):
        trace.counter("queue.depth", 3, group=1)
        trace.counter("queue.depth", 5.5)
        trace.instant("tick", n=np.int64(2))
    assert tr.event_count() == 3
    evs = [e for e in tr.export_chrome()["traceEvents"] if e["ph"] != "M"]
    assert [e["ph"] for e in evs] == ["C", "C", "i"]
    assert evs[0]["args"] == {"value": 3, "group": 1}
    assert evs[1]["args"] == {"value": 5.5}
    assert evs[2]["args"] == {"n": 2} and evs[2]["s"] == "t"
    assert evs[0]["ts"] <= evs[1]["ts"] <= evs[2]["ts"]
    json.dumps(tr.export_chrome())


def test_span_error_attribute_and_propagation():
    tr = Tracer()
    with trace.tracing(tr):
        with pytest.raises(RuntimeError, match="boom"):
            with trace.span("fail", shard=9):
                raise RuntimeError("boom")
    assert tr.open_span_count() == 0
    ev = [e for e in tr.export_chrome()["traceEvents"] if e["ph"] == "X"][0]
    assert ev["args"]["shard"] == 9
    assert "boom" in ev["args"]["error"]


def test_ring_overflow_keeps_newest_and_counts_dropped():
    tr = Tracer(capacity=16)
    with trace.tracing(tr):
        for i in range(50):
            with trace.span("s", i=i):
                pass
    out = tr.export_chrome()
    xs = [e for e in out["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == 16
    assert [e["args"]["i"] for e in xs] == list(range(34, 50))
    assert out["otherData"]["dropped_events"] == 34


def test_tracer_thread_rings_are_per_thread():
    tr = Tracer()

    def work():
        # _ACTIVE is a module global: the installed tracer is visible from
        # every thread without per-thread setup.
        with trace.span("t"):
            pass

    th = threading.Thread(target=work, name="obs-test-thread")
    with trace.tracing(tr):
        with trace.span("main"):
            th.start()
            th.join()
    names = tr.thread_names()
    assert "obs-test-thread" in names and len(names) == 2


# ------------------------------------------- end-to-end trace of the service
def _chrome_wellformed(doc, tr):
    """Shared schema assertions for an exported Chrome trace."""
    text = json.dumps(doc)  # must be JSON-serializable as produced
    doc = json.loads(text)
    assert tr.open_span_count() == 0  # every span closed
    evs = doc["traceEvents"]
    assert isinstance(evs, list) and evs
    by_tid = {}
    for e in evs:
        assert e["ph"] in ("M", "X", "C", "i")
        assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
        assert isinstance(e["name"], str) and e["name"]
        if e["ph"] == "M":
            continue
        assert e["ts"] >= 0.0
        if e["ph"] == "X":
            assert e["dur"] >= 0.0
            by_tid.setdefault(e["tid"], []).append(e)
    for tid, xs in by_tid.items():
        # Ring order is record (= close) order per thread: end timestamps
        # are monotonic within a lane.
        ends = [e["ts"] + e["dur"] for e in xs]
        assert all(a <= b + 1e-3 for a, b in zip(ends, ends[1:])), tid
    return doc


def test_traced_mixed_fused_service_run(tmp_path):
    g = rmat_graph(800, 12000, seed=7)
    tr = Tracer()
    with trace.tracing(tr):
        with _mk_service(
            tmp_path, "traced", g,
            max_lanes=4, max_groups=2, auto_compact_runs=1, prefetch_depth=2,
        ) as svc:
            with svc.submit_batch():
                futs = [
                    svc.submit("bfs", 0),
                    svc.submit("sssp", 3),
                    svc.submit("ppr", 5, max_iters=8),
                    svc.submit("bfs", 7),
                ]
            for f in futs:
                f.result()
            svc.apply_updates(inserts=[(1, 2), (3, 4)]).result()
            svc.submit("bfs", 1).result()
            snap = svc.metrics_snapshot()
    doc = _chrome_wellformed(tr.export_chrome(str(tmp_path / "t.json")), tr)
    evs = doc["traceEvents"]
    span_names = {e["name"] for e in evs if e["ph"] == "X"}
    # the admit -> plan -> load -> decode -> dispatch -> retire story
    for required in (
        "service.admit", "sweep.plan", "shard.load", "shard.decode",
        "exec.dispatch", "service.retire", "service.fusion_set",
        "service.publish", "overlay.merge", "store.read",
    ):
        assert required in span_names, required
    # >= 3 thread lanes actually carrying spans
    lanes = {e["tid"] for e in evs if e["ph"] == "X"}
    assert len(lanes) >= 3
    tnames = {e["args"]["name"] for e in evs if e["ph"] == "M"}
    assert "graphserve-worker" in tnames
    assert any(n.startswith("shard-prefetch") for n in tnames)
    # the file on disk is the same valid JSON
    on_disk = json.load(open(tmp_path / "t.json"))
    assert on_disk["traceEvents"]
    # metrics snapshot carries the latency decomposition
    assert snap["query_latency_s"]["count"] == 5
    assert snap["query_latency_s"]["p99"] > 0
    assert snap["conservation_violations"] == []


def test_engine_run_traced_matches_untraced(tmp_path):
    """Tracing must not perturb results: same sweep, bitwise outputs."""
    from repro_torch.core.apps import bfs

    g = rmat_graph(500, 7000, seed=11)
    with _mk_engine(tmp_path, "a", g, prefetch_depth=2) as eng:
        base = eng.run(bfs(0), max_iters=20)
    tr = Tracer()
    with trace.tracing(tr):
        with _mk_engine(tmp_path, "b", g, prefetch_depth=2) as eng:
            traced = eng.run(bfs(0), max_iters=20)
    assert np.array_equal(base.values, traced.values)
    assert base.converged == traced.converged
    assert tr.event_count() > 0


# ------------------------------------------------------ queue-wait split
def test_query_latency_decomposition(tmp_path):
    g = rmat_graph(600, 9000, seed=3)
    # max_lanes=1: later queries MUST wait for a slot, so queue_wait > 0.
    with _mk_service(tmp_path, "lat", g, max_lanes=1, max_groups=1,
                     session_entries=0) as svc:
        with svc.submit_batch():
            futs = [svc.submit("bfs", s) for s in (0, 3, 9)]
        rs = [f.result() for f in futs]
    for r in rs:
        assert r.queue_wait_s >= 0.0 and r.sweep_s >= 0.0
        assert r.latency_s == pytest.approx(
            r.queue_wait_s + r.sweep_s, rel=1e-6, abs=1e-6
        )
    # the last-served query waited for earlier sweeps/backfills
    assert max(r.queue_wait_s for r in rs) > 0.0


def test_cached_hit_reports_zero_queue_wait(tmp_path):
    g = rmat_graph(400, 5000, seed=5)
    with _mk_service(tmp_path, "cache", g) as svc:
        first = svc.query("bfs", 2)
        assert not first.cached
        hit = svc.query("bfs", 2)
    assert hit.cached
    assert hit.queue_wait_s == 0.0 and hit.sweep_s == 0.0
    assert hit.latency_s >= 0.0


# -------------------------------------------- prefetch exception propagation
def _poison(eng, bad_shard):
    """Make one shard unreadable, forcing every load through the store."""
    orig = eng.store.shard_bytes

    def poisoned(p, fmt="csr"):
        if p == bad_shard:
            raise OSError(f"disk hole at shard {p}")
        return orig(p, fmt)

    eng.store.shard_bytes = poisoned
    eng.pipeline.cache = None  # no warm-cache bypass of the store
    eng.pipeline.resident = None


@pytest.mark.parametrize("depth", [0, 2])
def test_shard_load_error_carries_shard_id(tmp_path, depth):
    from repro_torch.core.apps import bfs

    g = rmat_graph(500, 7000, seed=13)
    with _mk_engine(tmp_path, f"err{depth}", g, prefetch_depth=depth,
                    selective=False) as eng:
        _poison(eng, bad_shard=4)
        with pytest.raises(ShardLoadError) as ei:
            eng.run(bfs(0), max_iters=3)
    assert ei.value.shard_id == 4
    assert isinstance(ei.value.__cause__, OSError)
    assert "shard 4" in str(ei.value)


def test_shard_load_error_span_recorded(tmp_path):
    from repro_torch.core.apps import bfs

    g = rmat_graph(500, 7000, seed=13)
    tr = Tracer()
    with trace.tracing(tr):
        with _mk_engine(tmp_path, "errspan", g, prefetch_depth=2,
                        selective=False) as eng:
            _poison(eng, bad_shard=2)
            with pytest.raises(ShardLoadError):
                eng.run(bfs(0), max_iters=3)
    # close() shuts the prefetch pool down without waiting; give in-flight
    # loads (whose shard.load spans are open on the prefetch threads) a
    # moment to drain before asserting everything closed.
    deadline = time.monotonic() + 5.0
    while tr.open_span_count() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert tr.open_span_count() == 0  # error paths still close spans
    evs = tr.export_chrome()["traceEvents"]
    errs = [
        e for e in evs
        if e["ph"] == "X" and e["name"] == "shard.load"
        and "error" in e.get("args", {})
    ]
    assert errs and any(e["args"]["shard"] == 2 for e in errs)


# ---------------------------------- conservation on a fused mesh sweep + updates
@pytest.mark.parametrize("backend", ["numpy", "cuda"])
def test_conservation_fused_mesh_sweep_with_updates(tmp_path, backend):
    g = rmat_graph(900, 14000, seed=21)
    with _mk_service(
        tmp_path, "mesh", g,
        backend=backend, mesh=4, max_lanes=4, max_groups=2,
        session_entries=0,
    ) as svc:
        with svc.submit_batch():
            futs = [
                svc.submit("bfs", 0),
                svc.submit("sssp", 5),
                svc.submit("ppr", 9, max_iters=6),
            ]
        for f in futs:
            f.result()
        svc.apply_updates(inserts=[(10, 11), (12, 13)],
                          deletes=[(0, 1)]).result()
        with svc.submit_batch():
            futs = [svc.submit("bfs", 2), svc.submit("wcc", 0)]
        for f in futs:
            f.result()
    # close() joined the worker: every sweep has booked its stats.  Mesh
    # sweeps declared per-iteration device identities; replaying them is
    # THE shared conservation check.
    snap = svc.metrics_snapshot()
    assert svc.metrics.num_checks > 0
    assert any("device_shards" in c[0] for c in svc.metrics._checks)
    assert svc.metrics.verify_conservation() == []
    assert snap["conservation_violations"] == []
    assert snap["stages"]["iter_s"]["count"] > 0
    assert snap["query_latency_s"]["count"] == 5
    assert snap["queue_wait_s"]["count"] == 5


def test_device_identities_catch_violations():
    """The mesh identities of IterStats, SweepIterStats and ExecStats."""
    base = dict(iteration=0, shards_processed=3, shards_skipped=0,
                bytes_read=300)
    it = dict(time_s=0.1, cache_hits=0, cache_misses=0, active_count=1,
              active_ratio=0.1, selective_on=False, dispatches=2)
    sw = dict(live_lanes=2, selective_on=False, retired=0, backfilled=0,
              time_s=0.1)
    good = dict(device_shards=(2, 1), device_bytes=(200.0, 100.0),
                device_dispatches=(1, 1))
    ok = MetricsRegistry()
    ok.ingest(IterStats(**base, **it, **good))
    ok.ingest(SweepIterStats(**base, **sw, **good))
    ok.ingest(ExecStats(dispatches=2, shards_executed=3,
                        device_shards={0: 2, 1: 1},
                        device_dispatches={0: 1, 1: 1}))
    assert ok.verify_conservation() == []
    for bad in (dict(good, device_shards=(2, 2)),
                dict(good, device_bytes=(200.0, 99.0))):
        for cls, kw in ((IterStats, it), (SweepIterStats, sw)):
            reg = MetricsRegistry()
            reg.ingest(cls(**base, **kw, **bad))
            with pytest.raises(ConservationError):
                reg.verify_conservation()
    reg = MetricsRegistry()
    reg.ingest(IterStats(**base, **it, **dict(good, device_dispatches=(2, 1))))
    reg.ingest(ExecStats(dispatches=1, shards_executed=3,
                         device_shards={0: 2, 1: 1},
                         device_dispatches={0: 1, 1: 1}))
    assert len(reg.verify_conservation(strict=False)) == 2
