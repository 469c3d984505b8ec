"""The port's GraphService: lane-batched sweeps must be invisible in the
results, and the service must answer as the reference's does.

Against the reference, on ONE store (written by the reference):
- ``numpy`` service vs ``numpy`` service: every query bitwise (values,
  iterations, converged) — contract (b);
- the port's ``cuda`` service (the kernels' plain versions on the CPU) vs
  the reference's ``jnp`` service: BFS/SSSP bitwise, PPR within rtol=1e-5,
  atol=1e-9 — contract (c).

Inside the port (carried from ``tests/test_serve.py``): every lane equals
the same query run alone on a single-query engine, across programs,
backends, shard batching, retirement and backfill; the service survives
concurrent submission.  The delta-backed pieces (updates, compaction,
graph versions, warm restarts) have their own tests in
``tests/test_torch_delta.py`` and ``tests/test_torch_warm_state.py``.
"""

import os
import threading

import numpy as np
import pytest
import torch

from repro.core.graph import rmat_graph as ref_rmat_graph
from repro.core.vsw import VSWEngine as RefEngine
from repro.serve import GraphService as RefService
from repro_torch.core import apps
from repro_torch.core.graph import chain_graph, rmat_graph
from repro_torch.core.vsw import VSWEngine
from repro_torch.serve import (
    GraphService,
    LaneBatcher,
    LaneSeed,
    LaneSweep,
    ServiceOverloaded,
    SessionCache,
    pad_lanes,
)

PROGRAMS = [("bfs", 0), ("bfs", 7), ("sssp", 3), ("ppr", 5), ("ppr", 11)]
STORE = dict(num_shards=6, window=128, k=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _norm(v):
    return np.nan_to_num(v, posinf=1e30)


def _mk_service(tmp_path, tag, g, **kw):
    for key, val in STORE.items():
        kw.setdefault(key, val)
    return GraphService.from_graph(g, str(tmp_path / tag), device="cpu", **kw)


def _mk_engine(tmp_path, tag, g, **kw):
    for key, val in STORE.items():
        kw.setdefault(key, val)
    return VSWEngine.from_graph(g, str(tmp_path / tag), device="cpu", **kw)


def _prog(name, source):
    return apps.get_program(name, **({} if name == "wcc" else {"source": source}))


def _ask(svc, cases, iters):
    with svc.submit_batch():
        futs = [svc.submit(p, s, max_iters=iters) for p, s in cases]
    return [f.result(timeout=300) for f in futs]


# ------------------------------------------------- against the reference
@pytest.fixture(scope="module")
def ref_store(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_parity") / "store"
    RefEngine.from_graph(ref_rmat_graph(700, 9000, seed=61), str(root),
                         backend="numpy", **STORE).close()
    return str(root)


PARITY_CASES = [("bfs", 0), ("sssp", 3), ("ppr", 5), ("wcc", 0), ("bfs", 9),
                ("ppr", 1), ("sssp", 600)]


@pytest.mark.parametrize("lane_selective", [True, False])
def test_numpy_service_bitwise_reference(ref_store, lane_selective):
    kw = dict(backend="numpy", max_lanes=2, lane_selective=lane_selective)
    with RefService.from_store(ref_store, **kw) as ref:
        want = _ask(ref, PARITY_CASES, 25)
    with GraphService.from_store(ref_store, device="cpu", **kw) as svc:
        got = _ask(svc, PARITY_CASES, 25)
        stats = svc.stats()
    for (p, s), a, b in zip(PARITY_CASES, got, want):
        assert np.array_equal(_norm(a.values), _norm(b.values)), (p, s)
        assert (a.iterations, a.converged) == (b.iterations, b.converged)
        assert (a.bytes_read, a.shard_loads, a.lanes, a.groups) == (
            b.bytes_read, b.shard_loads, b.lanes, b.groups), (p, s)
    assert stats["queries_completed"] == len(PARITY_CASES)


@pytest.mark.parametrize("ragged", [True, False])
def test_cuda_service_matches_reference_jnp(ref_store, ragged):
    kw = dict(max_lanes=4, batch_shards=3, ragged=ragged)
    with RefService.from_store(ref_store, backend="jnp", **kw) as ref:
        want = _ask(ref, PARITY_CASES, 12)
    with GraphService.from_store(ref_store, backend="cuda", device="cpu",
                                 **kw) as svc:
        got = _ask(svc, PARITY_CASES, 12)
    for (p, s), a, b in zip(PARITY_CASES, got, want):
        if p == "ppr":
            assert np.allclose(a.values, b.values, rtol=1e-5, atol=1e-9), (p, s)
        else:
            assert np.array_equal(_norm(a.values), _norm(b.values)), (p, s)
            assert (a.iterations, a.converged) == (b.iterations, b.converged)


# ------------------------------------------------ bitwise solo equivalence
def test_lane_sweep_bitwise_equals_oracle_every_program(tmp_path):
    """K concurrent lanes == K independent single-query numpy-oracle runs,
    bitwise, for every program."""
    g = rmat_graph(500, 6000, seed=41)
    svc = _mk_service(tmp_path, "svc", g, backend="numpy", max_lanes=8)
    eng = _mk_engine(tmp_path, "eng", g, backend="numpy")
    futs = [svc.submit(p, s, max_iters=25) for p, s in PROGRAMS]
    for (p, s), f in zip(PROGRAMS, futs):
        qr = f.result(timeout=120)
        ref = eng.run(_prog(p, s), max_iters=25)
        assert np.array_equal(_norm(qr.values), _norm(ref.values)), (p, s)
        assert qr.iterations == ref.num_iterations
        assert qr.converged == ref.converged
    svc.close()
    eng.close()


@pytest.mark.parametrize("backend,batch_shards", [("torch", 1), ("cuda", 3),
                                                  ("cuda", 1)])
def test_lane_sweep_bitwise_matches_single_backend(tmp_path, backend,
                                                   batch_shards):
    """Lane + shard batching are invisible on the ELL backends too: each
    lane equals the same backend's single-query run bitwise."""
    g = rmat_graph(300, 3500, seed=42)
    svc = _mk_service(tmp_path, f"s{backend}", g, num_shards=5,
                      backend=backend, max_lanes=4, batch_shards=batch_shards)
    eng = _mk_engine(tmp_path, f"e{backend}", g, num_shards=5,
                     backend=backend, batch_shards=batch_shards)
    cases = [("sssp", 2), ("ppr", 3), ("bfs", 0), ("wcc", 0)]
    futs = [svc.submit(p, s, max_iters=12) for p, s in cases]
    for (p, s), f in zip(cases, futs):
        qr = f.result(timeout=240)
        ref = eng.run(_prog(p, s), max_iters=12)
        assert np.array_equal(_norm(qr.values), _norm(ref.values)), (p, s)
        assert qr.iterations == ref.num_iterations
    svc.close()
    eng.close()


# ------------------------------------------------- retirement and backfill
def test_lane_retirement_and_backfill_mid_flight(tmp_path):
    """Lanes converge at different iterations; freed slots are refilled
    mid-sweep and every result still matches its solo oracle run."""
    g = chain_graph(64)
    eng = _mk_engine(tmp_path, "chain", g, num_shards=4, backend="numpy")
    queue = [LaneSeed(source=s, max_iters=200, token=s) for s in (40, 0)]

    def backfill(n_free):
        out = queue[:n_free]
        del queue[:n_free]
        return out

    sweep = LaneSweep(eng, apps.lane_bfs())
    results = sweep.run([LaneSeed(source=60, max_iters=200, token=60),
                         LaneSeed(source=55, max_iters=200, token=55)],
                        backfill=backfill)
    assert sorted(r.token for r in results) == [0, 40, 55, 60]
    assert sum(s.backfilled for s in sweep.iter_stats) == 2
    assert sum(s.retired for s in sweep.iter_stats) == 4
    assert any(s.retired and s.live_lanes > 1 for s in sweep.iter_stats)
    for r in results:
        ref = eng.run(apps.bfs(source=r.token), max_iters=200)
        assert np.array_equal(_norm(r.values), _norm(ref.values)), r.token
        assert r.iterations == ref.num_iterations and r.converged
    eng.close()


def test_service_backfills_within_one_sweep(tmp_path):
    """More compatible queries than lanes: early retirees make room, so one
    sweep serves them all (no second cold start)."""
    g = chain_graph(48)
    svc = _mk_service(tmp_path, "bf", g, num_shards=4, backend="numpy",
                      max_lanes=2)
    with svc.submit_batch():
        futs = [svc.submit("bfs", s, max_iters=100) for s in (44, 40, 20, 1)]
    for f in futs:
        assert f.result(timeout=120).converged
    # A future resolves inside its sweep, before the sweep books its stats:
    # close() joins the worker, so the counters are final after it.
    svc.close()
    assert svc.stats()["sweeps"] == 1
    assert svc.stats()["queries_completed"] == 4


# --------------------------------------------------------------- threading
def test_multithreaded_submit_stress(tmp_path):
    g = rmat_graph(400, 5000, seed=43)
    svc = _mk_service(tmp_path, "mt", g, backend="numpy", max_lanes=8)
    eng = _mk_engine(tmp_path, "mtref", g, backend="numpy")
    refs = {(p, s): eng.run(_prog(p, s), max_iters=15).values
            for p, s in PROGRAMS}
    errors = []

    def client(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(5):
                p, s = PROGRAMS[int(rng.integers(len(PROGRAMS)))]
                qr = svc.submit(p, s, max_iters=15).result(timeout=240)
                if not np.array_equal(_norm(qr.values), _norm(refs[(p, s)])):
                    errors.append((p, s))
        except Exception as e:  # pragma: no cover
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    st = svc.stats()
    assert st["queries_completed"] + st["session_hits"] == 6 * 5
    svc.close()
    eng.close()


# ------------------------------------------------- sessions, admission, etc
def test_session_cache_hits_and_params(tmp_path):
    g = rmat_graph(300, 3000, seed=44)
    svc = _mk_service(tmp_path, "sess", g, backend="numpy", max_lanes=4)
    a = svc.query("bfs", 3, max_iters=50)
    b = svc.query("bfs", 3, max_iters=50)
    assert not a.cached and b.cached
    assert np.array_equal(_norm(a.values), _norm(b.values))
    assert b.shard_loads == 0.0  # cache hits cost no I/O
    # different static params are a different session key
    c = svc.query("ppr", 3, max_iters=10, damping=0.85)
    d = svc.query("ppr", 3, max_iters=10, damping=0.5)
    assert not c.cached and not d.cached
    assert not np.array_equal(c.values, d.values)
    svc.close()


def test_zero_iteration_budget_matches_engine(tmp_path):
    """max_iters=0: zero iterations, init values, not converged — exactly
    what ``VSWEngine.run(..., max_iters=0)`` returns."""
    g = rmat_graph(200, 2000, seed=49)
    svc = _mk_service(tmp_path, "zi", g, backend="numpy", max_lanes=2)
    eng = _mk_engine(tmp_path, "ziref", g, backend="numpy")
    qr = svc.query("sssp", 5, max_iters=0)
    ref = eng.run(apps.sssp(5), max_iters=0)
    assert qr.iterations == 0 and not qr.converged
    assert np.array_equal(_norm(qr.values), _norm(ref.values))
    svc.close()
    eng.close()


def test_cached_values_survive_caller_mutation(tmp_path):
    g = rmat_graph(200, 2000, seed=50)
    svc = _mk_service(tmp_path, "mut", g, backend="numpy", max_lanes=2)
    a = svc.query("bfs", 2, max_iters=30)
    pristine = a.values.copy()
    a.values[:] = -1.0  # caller-side in-place mutation
    b = svc.query("bfs", 2, max_iters=30)
    assert b.cached
    assert np.array_equal(_norm(b.values), _norm(pristine))
    svc.close()


def test_session_cache_predicate_counts_unsuitable_as_miss():
    cache = SessionCache(capacity=4)
    cache.put("k", 10)
    assert cache.get("k", lambda v: v > 50) is None  # present but unsuitable
    assert cache.hits == 0 and cache.misses == 1
    assert cache.get("k", lambda v: v > 5) == 10
    assert cache.hits == 1 and cache.misses == 1


def test_session_cache_lru_eviction_and_stale_versions():
    cache = SessionCache(capacity=2)
    cache.put("a", 1)
    cache.put("b", 2)
    assert cache.get("a") == 1  # refreshes recency
    cache.put("c", 3)  # evicts b
    assert cache.get("b") is None
    assert cache.get("a") == 1 and cache.get("c") == 3
    assert len(cache) == 2
    cache.put(("k", 1, 0), 1)
    assert cache.drop_stale_versions(1) == 1
    cache.clear()
    assert len(cache) == 0


def test_admission_cap_raises(tmp_path):
    g = rmat_graph(200, 2000, seed=45)
    svc = _mk_service(tmp_path, "cap", g, backend="numpy", max_lanes=2,
                      max_pending=0)
    with pytest.raises(ServiceOverloaded):
        svc.submit("bfs", 0)
    assert svc.metrics_snapshot()["errors"]["rejected"] == 1
    with pytest.raises(ValueError):
        svc.submit("bfs", 10_000)
    svc.close()


def test_batcher_grouping_and_padding():
    from collections import deque
    import dataclasses

    @dataclasses.dataclass
    class P:
        key: tuple
        n: int

    pending = deque([P(("bfs",), 0), P(("ppr", 0.85), 1), P(("bfs",), 2),
                     P(("ppr", 0.85), 3), P(("bfs",), 4)])
    b = LaneBatcher(max_lanes=2)
    batch = b.form(pending)
    assert [p.n for p in batch] == [0, 2]  # oldest key, FIFO, capped at 2
    assert [p.n for p in pending] == [1, 3, 4]  # others keep order
    assert b.capacity(3) == 4 and b.capacity(1) == 1
    assert [pad_lanes(n) for n in (0, 1, 2, 3, 5, 16)] == [1, 1, 2, 4, 8, 16]


def test_union_plan_is_superset_of_each_lane(tmp_path):
    """Scheduler contract: a shard is skipped only when NO lane needs it."""
    g = rmat_graph(600, 4000, seed=46)
    eng = _mk_engine(tmp_path, "union", g, num_shards=8, backend="numpy",
                     threshold=1.0)
    ids_a = np.array([3], dtype=np.int64)
    ids_b = np.array([577], dtype=np.int64)
    union = np.union1d(ids_a, ids_b)
    pa, pb, pu = (eng.scheduler.plan(i) for i in (ids_a, ids_b, union))
    assert set(pa.shards) | set(pb.shards) <= set(pu.shards)
    eng.close()


# ---------------------------------------------------------------- lifecycle
def test_close_idempotent_and_context_managers(tmp_path):
    g = rmat_graph(200, 2000, seed=47)
    with _mk_service(tmp_path, "ctx_svc", g, backend="numpy",
                     max_lanes=2) as svc:
        assert svc.query("bfs", 0, max_iters=20).converged
    svc.close()
    svc.close()
    with pytest.raises(RuntimeError):
        svc.submit("bfs", 1)


def test_shard_load_amortization(tmp_path):
    """K lanes share every load: attributed loads/query drop about K-fold
    for a dense-activity program with a fixed iteration budget."""
    g = rmat_graph(400, 6000, seed=48)
    loads = {}
    for k in (1, 8):
        svc = _mk_service(tmp_path, f"amort{k}", g, backend="numpy",
                          max_lanes=k, session_entries=0)
        with svc.submit_batch():
            futs = [svc.submit("ppr", s, max_iters=4) for s in range(8)]
        for f in futs:
            f.result(timeout=240)
        loads[k] = svc.stats()["loads_per_query"]
        svc.close()
    assert loads[1] >= 4 * loads[8]  # exact ratio: 8x


def test_unported_pieces_raise_with_their_roadmap_item(tmp_path):
    """Only mesh serving (item 8) still raises; item 6's pieces (updates,
    compaction, versions, warm restarts, background compaction) run since
    the delta port, and item 7's telemetry ticker since the observability
    port (``tests/test_torch_pulse.py`` holds it to the reference)."""
    g = rmat_graph(200, 2000, seed=51)
    svc = _mk_service(tmp_path, "np", g, backend="numpy", max_lanes=2)
    root = str(tmp_path / "np")
    upd = svc.apply_updates(inserts=([0], [1])).result(timeout=120)
    assert upd.graph_version == 1 and upd.edges_inserted == 1
    assert svc.compact().shards_compacted == 1
    assert svc.bump_graph_version() == 2
    ckpt = svc.save_warm_state(str(tmp_path / "warm"))
    assert os.path.basename(ckpt).startswith("warm_")
    ts = svc.start_telemetry(interval_s=0.05)
    assert svc.timeseries is ts
    assert svc.stop_telemetry() is ts and svc.timeseries is None
    assert ts.num_windows >= 1  # the final tick closed a window
    svc.close()
    with GraphService.from_store(root, device="cpu", backend="numpy",
                                 warm_state=str(tmp_path / "warm")) as warm:
        assert warm.warm_restore_report["valid"]
    with GraphService.from_store(root, device="cpu", backend="numpy",
                                 auto_compact_runs=1) as auto:
        assert auto.stats()["shards_compacted"] == 0
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        GraphService.from_store(root, device="cpu", mesh=2)


def test_default_device_is_the_card(tmp_path):
    """The service's factories default to CUDA; without a card they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    g = rmat_graph(100, 500, seed=52)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphService.from_graph(g, str(tmp_path / "a"), num_shards=2)
    _mk_engine(tmp_path, "b", g, num_shards=2, backend="numpy").close()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphService.from_store(str(tmp_path / "b"))
