"""Cross-query fusion in the port: heterogeneous programs on one shard
stream (carried from ``tests/test_fusion.py``).

Mixing programs in a sweep — same-algebra programs FUSED into one lane
table, different algebra groups INTERLEAVED on one stream — must be
invisible in the results: every query bitwise-equals the same query run
alone, across programs, backends (``numpy``, ``torch``, ``cuda`` with the
kernels' plain versions on the CPU), retirement and cross-group backfill.
Cost attribution is mask-aware and conserved, and the port's fused sweep
plans, reads and attributes exactly as the reference's does.
"""

import dataclasses
import math
from collections import deque

import numpy as np
import pytest
import torch

from repro.core import apps as ref_apps
from repro.core.graph import chain_graph as ref_chain_graph
from repro.core.vsw import VSWEngine as RefEngine
from repro.serve import FusedSweep as RefFusedSweep
from repro.serve import LaneSeed as RefLaneSeed
from repro_torch.core import apps
from repro_torch.core.csr import csr_to_ell, ell_to_device
from repro_torch.core.executor import ExecStats, make_lane_executor
from repro_torch.core.graph import chain_graph, rmat_graph
from repro_torch.core.pipeline import LoadedShard
from repro_torch.core.sharding import preprocess
from repro_torch.core.vsw import VSWEngine
from repro_torch.serve import FusedSweep, GraphService, LaneBatcher, LaneSeed

# (program, source) workloads mixing all three min-algebra programs + PPR
MIXED = [("bfs", 0), ("sssp", 3), ("wcc", 1), ("ppr", 5), ("bfs", 7),
         ("ppr", 11), ("sssp", 2), ("wcc", 9)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _norm(v):
    return np.nan_to_num(v, posinf=1e30)


def _store_kw(kw):
    kw.setdefault("num_shards", 6)
    kw.setdefault("window", 128)
    kw.setdefault("k", 16)
    return kw


def _mk_service(tmp_path, tag, g, **kw):
    return GraphService.from_graph(g, str(tmp_path / tag), device="cpu",
                                   **_store_kw(kw))


def _mk_engine(tmp_path, tag, g, **kw):
    return VSWEngine.from_graph(g, str(tmp_path / tag), device="cpu",
                                **_store_kw(kw))


def _solo(eng, program, source, max_iters):
    kw = {} if program == "wcc" else {"source": source}
    return eng.run(apps.get_program(program, **kw), max_iters=max_iters)


# ------------------------------------------------------------ program keys
def test_combine_key_splits_from_program_key():
    bfs, sssp, wcc = apps.lane_bfs(), apps.lane_sssp(), apps.lane_wcc()
    ppr1, ppr2 = apps.lane_ppr(0.85), apps.lane_ppr(0.5)
    assert bfs.combine_key == sssp.combine_key == wcc.combine_key == ("min",)
    assert len({bfs.key, sssp.key, wcc.key}) == 3
    assert ppr1.combine_key == ppr2.combine_key == ("sum",)
    assert ppr1.key != ppr2.key
    assert ppr1.combine_key != bfs.combine_key
    assert bfs.identity == np.inf and ppr1.identity == 0.0


def test_lane_wcc_matches_vertex_program_oracle(tmp_path):
    g = rmat_graph(300, 3000, seed=60)
    eng = _mk_engine(tmp_path, "wccref", g, backend="numpy")
    svc = _mk_service(tmp_path, "wccsvc", g, backend="numpy", max_lanes=4)
    qr = svc.query("wcc", 0, max_iters=50)
    ref = eng.run(apps.wcc(), max_iters=50)
    assert np.array_equal(_norm(qr.values), _norm(ref.values))
    assert qr.converged == ref.converged
    svc.close()
    eng.close()


# -------------------------------------------------------- batcher formation
def test_batcher_forms_fusion_sets():
    @dataclasses.dataclass
    class P:
        key: tuple
        combine_key: tuple
        n: int

    def mk(name, ck, n):
        return P((name,), ck, n)

    pending = deque([
        mk("bfs", ("min",), 0), mk("ppr", ("sum",), 1),
        mk("sssp", ("min",), 2), mk("wcc", ("min",), 3),
        mk("ppr", ("sum",), 4), mk("bfs", ("min",), 5),
    ])
    b = LaneBatcher(max_lanes=3, max_groups=2)
    groups = b.form_fused(pending)
    assert [p.n for p in groups[0]] == [0, 2, 3]
    assert [p.n for p in groups[1]] == [1, 4]
    assert [p.n for p in pending] == [5]  # leftover keeps order

    # key-only mode: identical program keys only
    pending = deque([
        mk("bfs", ("min",), 0), mk("sssp", ("min",), 1),
        mk("bfs", ("min",), 2),
    ])
    b = LaneBatcher(max_lanes=4, max_groups=1, fuse_programs=False)
    groups = b.form_fused(pending)
    assert [p.n for p in groups[0]] == [0, 2]
    assert [p.n for p in pending] == [1]
    with pytest.raises(ValueError):
        LaneBatcher(max_lanes=0)


# ------------------------------------------------- fused same-algebra sweeps
def test_fused_min_programs_single_sweep_bitwise(tmp_path):
    g = rmat_graph(500, 6000, seed=61)
    svc = _mk_service(tmp_path, "svc", g, backend="numpy", max_lanes=8,
                      max_groups=1)
    eng = _mk_engine(tmp_path, "eng", g, backend="numpy")
    cases = [(p, s) for p, s in MIXED if p != "ppr"]
    with svc.submit_batch():
        futs = [svc.submit(p, s, max_iters=25) for p, s in cases]
    for (p, s), f in zip(cases, futs):
        qr = f.result(timeout=120)
        ref = _solo(eng, p, s, 25)
        assert np.array_equal(_norm(qr.values), _norm(ref.values)), (p, s)
        assert qr.iterations == ref.num_iterations
        assert qr.converged == ref.converged
    assert svc.stats()["sweeps"] == 1  # all three programs fused
    svc.close()
    eng.close()


def test_interleaved_groups_single_sweep_bitwise(tmp_path):
    g = rmat_graph(500, 6000, seed=62)
    svc = _mk_service(tmp_path, "svc", g, backend="numpy", max_lanes=8,
                      max_groups=2)
    eng = _mk_engine(tmp_path, "eng", g, backend="numpy")
    with svc.submit_batch():
        futs = [svc.submit(p, s, max_iters=20) for p, s in MIXED]
    for (p, s), f in zip(MIXED, futs):
        qr = f.result(timeout=120)
        ref = _solo(eng, p, s, 20)
        assert np.array_equal(_norm(qr.values), _norm(ref.values)), (p, s)
        assert qr.groups == 2
    st = svc.stats()
    assert st["sweeps"] == 1 and st["multi_group_sweeps"] == 1
    svc.close()
    eng.close()


@pytest.mark.parametrize("backend,batch_shards,ragged", [
    ("torch", 1, True), ("torch", 3, False), ("cuda", 2, True),
    ("cuda", 2, False), ("cuda", 1, True)])
def test_interleaved_groups_bitwise_ell_backends(tmp_path, backend,
                                                 batch_shards, ragged):
    """Fusion + interleaving + shard batching on the ELL backends: each
    query equals the same backend's single-query run bitwise."""
    g = rmat_graph(300, 3500, seed=63)
    tag = f"{backend}{batch_shards}{ragged}"
    svc = _mk_service(tmp_path, "s" + tag, g, num_shards=5, backend=backend,
                      max_lanes=8, max_groups=2, batch_shards=batch_shards,
                      ragged=ragged)
    eng = _mk_engine(tmp_path, "e" + tag, g, num_shards=5, backend=backend,
                     batch_shards=batch_shards)
    cases = [("bfs", 2), ("wcc", 0), ("ppr", 3), ("sssp", 1), ("ppr", 9)]
    with svc.submit_batch():
        futs = [svc.submit(p, s, max_iters=12) for p, s in cases]
    for (p, s), f in zip(cases, futs):
        qr = f.result(timeout=240)
        ref = _solo(eng, p, s, 12)
        assert np.array_equal(_norm(qr.values), _norm(ref.values)), (p, s)
    assert svc.stats()["sweeps"] == 1
    assert svc.metrics_snapshot()["conservation_violations"] == []
    svc.close()
    eng.close()


# -------------------------------------------- retirement / cross-group fill
def test_retirement_and_backfill_across_groups(tmp_path):
    g = chain_graph(64)
    svc = _mk_service(tmp_path, "bf", g, num_shards=4, backend="numpy",
                      max_lanes=3, max_groups=2)
    cases = [("bfs", 60), ("ppr", 0), ("bfs", 55), ("ppr", 1),
             ("bfs", 40), ("ppr", 2), ("bfs", 0)]
    with svc.submit_batch():
        futs = [svc.submit(p, s, max_iters=200 if p == "bfs" else 6)
                for p, s in cases]
    eng = _mk_engine(tmp_path, "bfref", g, num_shards=4, backend="numpy")
    for (p, s), f in zip(cases, futs):
        qr = f.result(timeout=240)
        ref = _solo(eng, p, s, 200 if p == "bfs" else 6)
        assert np.array_equal(_norm(qr.values), _norm(ref.values)), (p, s)
    st = svc.stats()
    assert st["sweeps"] == 1 and st["queries_completed"] == 7
    svc.close()
    eng.close()


def test_fused_sweep_direct_backfill_and_zero_budget(tmp_path):
    g = chain_graph(48)
    eng = _mk_engine(tmp_path, "direct", g, num_shards=4, backend="numpy")
    bfs, ppr = apps.lane_bfs(), apps.lane_ppr()
    queues = {
        0: [LaneSeed(source=20, max_iters=0, token="z1", program=bfs),
            LaneSeed(source=1, max_iters=200, token="b1", program=bfs)],
        1: [LaneSeed(source=3, max_iters=0, token="z2", program=ppr)],
    }

    def backfill(group, n_free):
        out = queues[group][:n_free]
        del queues[group][:n_free]
        return out

    sweep = FusedSweep(eng)
    results = sweep.run(
        [[LaneSeed(source=44, max_iters=200, token="b0", program=bfs),
          LaneSeed(source=40, max_iters=0, token="z0", program=bfs)],
         [LaneSeed(source=0, max_iters=4, token="p0", program=ppr)]],
        backfill=backfill,
    )
    by_token = {r.token: r for r in results}
    assert set(by_token) == {"b0", "b1", "p0", "z0", "z1", "z2"}
    for tok, src, prog in (("z0", 40, "bfs"), ("z1", 20, "bfs"),
                           ("z2", 3, "ppr")):
        r = by_token[tok]
        assert r.iterations == 0 and not r.converged
        assert r.bytes_read == 0.0 and r.shard_loads == 0.0
        ref = _solo(eng, prog, src, 0)
        assert np.array_equal(_norm(r.values), _norm(ref.values))
    for tok, src, prog, iters in (("b0", 44, "bfs", 200),
                                  ("b1", 1, "bfs", 200), ("p0", 0, "ppr", 4)):
        ref = _solo(eng, prog, src, iters)
        assert np.array_equal(_norm(by_token[tok].values), _norm(ref.values))
    assert sum(s.backfilled for s in sweep.iter_stats) == 1  # only b1
    with pytest.raises(ValueError, match="cannot join"):
        FusedSweep(eng).run([[LaneSeed(source=0, program=bfs),
                              LaneSeed(source=1, program=ppr)]])
    eng.close()


def test_service_zero_budget_matches_engine(tmp_path):
    g = rmat_graph(200, 2000, seed=64)
    svc = _mk_service(tmp_path, "zb", g, backend="numpy", max_lanes=2)
    eng = _mk_engine(tmp_path, "zbref", g, backend="numpy")
    qr = svc.query("wcc", 5, max_iters=0)
    ref = eng.run(apps.wcc(), max_iters=0)
    assert qr.iterations == 0 and not qr.converged
    assert np.array_equal(_norm(qr.values), _norm(ref.values))
    svc.close()
    eng.close()


# ----------------------------------------------------- cost attribution
def _cost_sweep(make_engine, make_sweep, seed_cls, lane_apps, root):
    eng = make_engine(root)
    bfs, wcc = lane_apps.lane_bfs(), lane_apps.lane_wcc()
    sweep = make_sweep(eng)
    results = sweep.run(
        [[seed_cls(source=90, max_iters=300, token="fast", program=bfs),
          seed_cls(source=0, max_iters=300, token="slow", program=bfs),
          seed_cls(source=1, max_iters=300, token="dense", program=wcc)]])
    eng.close()
    return sweep, {r.token: r for r in results}


def test_cost_attribution_conserved_mask_aware_and_as_reference(tmp_path):
    """Per-lane bytes/loads sum to the sweep totals exactly, a lane masked
    out of most of the stream is charged less, and plans, reads, skipped
    lane rows and attribution equal the reference's fused sweep."""
    root = str(tmp_path / "cost")
    RefEngine.from_graph(ref_chain_graph(96), root, backend="numpy",
                         num_shards=6, window=128, k=16).close()
    kw = dict(backend="numpy", threshold=1.0, cache_bytes=0)
    sweep, by = _cost_sweep(
        lambda r: VSWEngine.from_store(r, device="cpu", **kw), FusedSweep,
        LaneSeed, apps, root)
    ref_sweep, ref_by = _cost_sweep(
        lambda r: RefEngine.from_store(r, **kw), RefFusedSweep, RefLaneSeed,
        ref_apps, root)
    total_loads = sum(s.shards_processed for s in sweep.iter_stats)
    total_bytes = sum(s.bytes_read for s in sweep.iter_stats)
    assert math.isclose(sum(r.shard_loads for r in by.values()), total_loads,
                        rel_tol=1e-9)
    assert math.isclose(sum(r.bytes_read for r in by.values()), total_bytes,
                        rel_tol=1e-9)
    assert by["fast"].shard_loads < by["dense"].shard_loads
    assert sum(s.lane_rows_skipped for s in sweep.iter_stats) > 0
    fields = ("live_lanes", "shards_processed", "shards_skipped", "bytes_read",
              "selective_on", "retired", "lane_rows_skipped", "dispatches")
    assert [[getattr(s, f) for f in fields] for s in sweep.iter_stats] == [
        [getattr(s, f) for f in fields] for s in ref_sweep.iter_stats]
    for tok, r in by.items():
        want = ref_by[tok]
        assert np.array_equal(_norm(r.values), _norm(want.values))
        assert (r.iterations, r.converged, r.shard_loads, r.bytes_read) == (
            want.iterations, want.converged, want.shard_loads, want.bytes_read)


def test_plan_lane_shares_sum_to_planned(tmp_path):
    g = rmat_graph(600, 4000, seed=65)
    eng = _mk_engine(tmp_path, "shares", g, num_shards=8, backend="numpy",
                     threshold=1.0)
    lane_active = [np.array([3], dtype=np.int64),
                   np.array([577], dtype=np.int64),
                   np.arange(0, 600, 7, dtype=np.int64)]
    union = np.unique(np.concatenate(lane_active))
    plan = eng.scheduler.plan(union, lane_active=lane_active)
    shares = plan.lane_shares(3)
    assert shares.shape == (3,)
    assert math.isclose(shares.sum(), plan.num_planned, rel_tol=1e-9)
    assert all(plan.lane_masks[p].any() for p in plan.shards)
    full = eng.scheduler.plan(np.arange(600, dtype=np.int64))
    assert full.lane_masks is None
    assert np.allclose(full.lane_shares(4), full.num_planned / 4)
    assert full.lane_shares(0).shape == (0,)
    eng.close()


# ------------------------------------------------------- property stress
@pytest.mark.parametrize("backend", ["numpy", "cuda"])
def test_property_mixed_workload_stress(tmp_path, backend):
    """Seeded random mixed workloads with more queries than lanes (forcing
    retirement + backfill across groups) stay bitwise vs solo."""
    g = rmat_graph(400, 5000, seed=67)
    bs = 1 if backend == "numpy" else 2
    eng = _mk_engine(tmp_path, "stressref", g, backend=backend, batch_shards=bs)
    refs = {}
    progs = ["bfs", "sssp", "wcc", "ppr"]
    for trial in range(2):
        rng = np.random.default_rng(100 + trial)
        svc = _mk_service(tmp_path, f"stress{trial}", g, backend=backend,
                          batch_shards=bs, max_lanes=4, max_groups=2,
                          session_entries=0)
        cases = [(progs[int(rng.integers(len(progs)))],
                  int(rng.integers(g.num_vertices)), int(rng.integers(0, 18)))
                 for _ in range(10)]
        with svc.submit_batch():
            futs = [svc.submit(p, s, max_iters=it) for p, s, it in cases]
        for ck, f in zip(cases, futs):
            qr = f.result(timeout=240)
            if ck not in refs:
                refs[ck] = _solo(eng, *ck)
            assert np.array_equal(_norm(qr.values), _norm(refs[ck].values)), ck
            assert qr.iterations == refs[ck].num_iterations
        svc.close()
    eng.close()


# ------------------------------------------------------- executor layer
def test_run_groups_matches_per_group_run():
    """PerShardExecutor.run_groups == one run() per group, bitwise; None
    entries produce no dispatch."""
    g = rmat_graph(300, 4000, seed=70)
    meta, shards = preprocess(g, num_shards=3)
    rng = np.random.default_rng(2)
    msgs_a = rng.random((4, meta.num_vertices)).astype(np.float32)
    msgs_b = rng.random((2, meta.num_vertices)).astype(np.float32)
    loaded = [LoadedShard(s.shard_id, s, None) for s in shards]
    ex = make_lane_executor("numpy", device="cpu")
    stats = ExecStats()
    got = {}
    for gi, res in ex.run_groups(loaded, [(msgs_a, "min"), None,
                                          (msgs_b, "sum")], stats):
        got.setdefault(gi, []).append(res)
    assert set(got) == {0, 2}
    assert stats.dispatches == 2 * len(shards)
    for gi, msgs, combine in ((0, msgs_a, "min"), (2, msgs_b, "sum")):
        solo = list(ex.run(loaded, msgs, combine))
        for a, b in zip(got[gi], solo):
            assert a.shard_id == b.shard_id
            assert np.array_equal(a.acc, b.acc)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("ragged", [True, False])
def test_batched_run_groups_matches_per_group_run(backend, ragged):
    """BatchedEllExecutor.run_groups (G launches, or one ragged launch per
    batch) is bitwise the per-group batched dispatch, and its stats hold
    the ragged identities."""
    g = rmat_graph(250, 3000, seed=71)
    meta, shards = preprocess(g, num_shards=4)
    loaded = [LoadedShard(s.shard_id, None, ell_to_device(csr_to_ell(
        s, meta.num_vertices, window=64, k=8, tr=8), "cpu")) for s in shards]
    rng = np.random.default_rng(3)
    msgs_a = rng.random((2, meta.num_vertices)).astype(np.float32)
    msgs_b = rng.random((4, meta.num_vertices)).astype(np.float32)
    ex = make_lane_executor(backend, batch_shards=3, ragged=ragged,
                            device="cpu")
    stats = ExecStats()
    got = {}
    for gi, res in ex.run_groups(loaded, [(msgs_a, "sum"), None,
                                          (msgs_b, "min")], stats):
        got.setdefault(gi, []).append(res)
    assert set(got) == {0, 2}
    assert stats.batches == 2 and stats.shards_executed == 8
    if ragged:
        assert stats.dispatches == stats.ragged_dispatches == 2
        assert stats.ragged_lanes == 12 and stats.group_lanes == {0: 4, 2: 8}
    else:
        assert stats.dispatches == 4 and stats.ragged_dispatches == 0
    for gi, msgs, combine in ((0, msgs_a, "sum"), (2, msgs_b, "min")):
        solo = list(ex.run(loaded, msgs, combine))
        for a, b in zip(got[gi], solo):
            assert a.shard_id == b.shard_id and a.batch_size == b.batch_size
            assert np.array_equal(a.acc, b.acc)


# ------------------------------------------------------------- amortization
def test_fused_sweep_reads_less_than_per_group_sweeps(tmp_path):
    """A mixed workload served fused+interleaved reads fewer bytes per
    query than key-equality batching (per-group sweeps)."""
    g = rmat_graph(400, 6000, seed=72)
    workload = [("bfs", 0), ("sssp", 1), ("ppr", 2), ("bfs", 3),
                ("ppr", 4), ("sssp", 5), ("wcc", 6), ("ppr", 7)]
    bytes_per_query = {}
    for mode, kw in (
        ("baseline", dict(fuse_programs=False, max_groups=1)),
        ("fused", dict(fuse_programs=True, max_groups=1)),
        ("interleaved", dict(fuse_programs=True, max_groups=2)),
    ):
        svc = _mk_service(tmp_path, mode, g, backend="numpy", max_lanes=8,
                          session_entries=0, cache_bytes=0, **kw)
        with svc.submit_batch():
            futs = [svc.submit(p, s, max_iters=6) for p, s in workload]
        for f in futs:
            f.result(timeout=240)
        bytes_per_query[mode] = svc.stats()["bytes_read_total"] / len(workload)
        svc.close()
    assert bytes_per_query["fused"] < bytes_per_query["baseline"]
    assert bytes_per_query["interleaved"] < bytes_per_query["baseline"]
    assert bytes_per_query["interleaved"] < bytes_per_query["fused"]
