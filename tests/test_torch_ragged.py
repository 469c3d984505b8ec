"""Ragged dispatch in the port: one ragged launch per shard batch covering
ALL fusion groups (DESIGN.md §14), carried from ``tests/test_ragged.py``.

1. **Padding algebra** — :func:`ragged_lane_pad` never wastes more lanes
   than the per-group power-of-two padding; :func:`ragged_lane_concat`
   lays groups out contiguously with per-lane arm ids.
2. **Bitwise updates** — ``ell_update_lanes_ragged`` equals
   ``ell_update_lanes_multi`` bit for bit per group (on the CPU the
   kernels' plain versions run).
3. **Bitwise sweeps** — ``FusedSweep(ragged=True)`` reproduces the
   ``ragged=False`` results exactly through masked groups, retirement and
   backfill, and the ragged service matches the reference's ragged
   service (BFS/SSSP/WCC bitwise, PPR within rtol=1e-5, atol=1e-9).
4. **Conserved accounting** — a ragged sweep books one dispatch per
   flushed batch, and the declared identities replay clean through
   ``MetricsRegistry.verify_conservation``.
5. **Mesh** — on an engine booted with ``mesh=D`` a ragged sweep books
   one dispatch per flush and stays bitwise the single-device run.
"""

import time

import numpy as np
import pytest
import torch

from repro.core.vsw import VSWEngine as RefEngine
from repro.core.graph import rmat_graph as ref_rmat_graph
from repro.serve import GraphService as RefService
from repro_torch.core import apps
from repro_torch.core.csr import (
    csr_to_ell,
    ell_to_device,
    next_pow2,
    ragged_lane_concat,
    ragged_lane_pad,
)
from repro_torch.core.executor import ExecStats
from repro_torch.core.graph import rmat_graph
from repro_torch.core.sharding import preprocess
from repro_torch.core.vsw import VSWEngine
from repro_torch.kernels.spmv_ell import ops as spmv_ops
from repro_torch.obs.metrics import ConservationError, MetricsRegistry
from repro_torch.serve import FusedSweep, GraphService, LaneSeed, SweepIterStats

MIXED = [("bfs", 0), ("ppr", 5), ("sssp", 3), ("ppr", 11), ("wcc", 1)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _norm(v):
    return np.nan_to_num(v, posinf=1e30, neginf=-1e30)


def _store_kw(kw):
    kw.setdefault("num_shards", 6)
    kw.setdefault("window", 128)
    kw.setdefault("k", 16)
    return kw


def _mk_engine(tmp_path, tag, g, **kw):
    return VSWEngine.from_graph(g, str(tmp_path / tag), device="cpu",
                                **_store_kw(kw))


def _mk_service(tmp_path, tag, g, **kw):
    return GraphService.from_graph(g, str(tmp_path / tag), device="cpu",
                                   **_store_kw(kw))


def _solo(eng, program, source, max_iters):
    kw = {} if program == "wcc" else {"source": source}
    return eng.run(apps.get_program(program, **kw), max_iters=max_iters)


# ------------------------------------------------------- padding algebra
def test_ragged_lane_pad_never_worse_than_per_group_pow2():
    rng = np.random.default_rng(140)
    for _ in range(300):
        counts = rng.integers(0, 33, size=rng.integers(1, 7)).tolist()
        k_total = sum(counts)
        pad = ragged_lane_pad(counts)
        per_group = sum(next_pow2(max(k, 1)) for k in counts)
        assert pad >= max(k_total, 1)
        assert pad <= per_group, (counts, pad, per_group)
    assert ragged_lane_pad([1, 1, 1]) == 3  # beats next_pow2(3) == 4
    assert ragged_lane_pad([3, 2, 5]) == 14  # == 4+2+8, beats pow2(10)=16


def test_ragged_lane_concat_layout_and_arm_dedup():
    rng = np.random.default_rng(141)
    groups = [rng.random((k, 10)).astype(np.float32) for k in (3, 1, 2)]
    msgs_all, cids, combines_set, slices = ragged_lane_concat(
        groups, ["sum", "min", "sum"])
    assert combines_set == ("sum", "min")  # duplicates share ONE arm
    assert msgs_all.shape[0] == ragged_lane_pad([3, 1, 2])
    for m, sl in zip(groups, slices):
        assert np.array_equal(msgs_all[sl], m)
    assert cids[slices[0]].tolist() == [0, 0, 0]
    assert cids[slices[1]].tolist() == [1]
    assert cids[slices[2]].tolist() == [0, 0]
    n_live = sum(m.shape[0] for m in groups)
    assert np.all(msgs_all[n_live:] == 0.0)
    assert np.all(cids[n_live:] == len(combines_set))
    with pytest.raises(ValueError):
        ragged_lane_concat(groups, ["sum", "min"])
    with pytest.raises(ValueError):
        ragged_lane_concat([], [])


# ------------------------------------------------------- update bitwise
@pytest.mark.parametrize("combines", [
    ("sum", "min", "max"),
    ("min", "sum"),
    ("sum", "min", "sum"),   # duplicated monoid -> shared arm
    ("min",),                # single group: ragged degenerates to multi
])
def test_ragged_ops_bitwise_vs_multi(combines):
    g = rmat_graph(600, 7000, seed=142)
    _, shards = preprocess(g, num_shards=3)
    ells = [ell_to_device(csr_to_ell(s, g.num_vertices, window=128, k=16,
                                     tr=8), "cpu") for s in shards]
    rng = np.random.default_rng(142)
    msgs_by_group = []
    for gi, c in enumerate(combines):
        m = rng.random((gi + 1, g.num_vertices)).astype(np.float32)
        if c in ("min", "max"):  # inf-heavy lanes
            m[m > 0.6] = np.inf if c == "min" else -np.inf
        msgs_by_group.append(m)
    ref = spmv_ops.ell_update_lanes_multi(ells, msgs_by_group, list(combines))
    out = spmv_ops.ell_update_lanes_ragged(ells, msgs_by_group, list(combines))
    assert len(out) == len(ref) == len(combines)
    for gi, (accs_r, accs_m) in enumerate(zip(out, ref)):
        assert len(accs_r) == len(accs_m) == len(ells)
        for si, (a, b) in enumerate(zip(accs_r, accs_m)):
            assert a.shape == b.shape
            assert np.array_equal(_norm(a), _norm(b)), (gi, si)
    assert spmv_ops.ell_update_lanes_ragged([], msgs_by_group,
                                            list(combines)) == \
        [[] for _ in combines]


# -------------------------------------------------------- sweep bitwise
@pytest.mark.parametrize("backend,batch_shards,lane_selective", [
    ("torch", 1, True), ("torch", 3, True), ("cuda", 2, True),
    ("cuda", 2, False), ("cuda", 1, True)])
def test_ragged_sweep_bitwise_vs_multi(tmp_path, backend, batch_shards,
                                       lane_selective):
    """FusedSweep(ragged=True) == FusedSweep(ragged=False) bitwise per lane
    through masked groups and mid-sweep retirement/backfill — and the
    ragged run books ONE dispatch per batch where multi pays G."""
    g = rmat_graph(400, 4500, seed=143)
    eng = _mk_engine(tmp_path, f"e{backend}{batch_shards}", g, num_shards=5,
                     backend=backend, batch_shards=batch_shards)
    bfs, sssp, ppr = apps.lane_bfs(), apps.lane_sssp(), apps.lane_ppr()
    queue = [LaneSeed(source=9, max_iters=12, token="b2", program=bfs)]

    def mk_seeds():
        return [
            [LaneSeed(source=0, max_iters=3, token="b0", program=bfs),
             LaneSeed(source=3, max_iters=12, token="s0", program=sssp)],
            [LaneSeed(source=5, max_iters=8, token="p0", program=ppr),
             LaneSeed(source=11, max_iters=2, token="p1", program=ppr)],
        ]

    def mk_backfill(q):
        def backfill(group, n_free):
            if group != 0:
                return []
            out = q[:n_free]
            del q[:n_free]
            return out
        return backfill

    runs = {}
    for ragged in (True, False):
        sweep = FusedSweep(eng, batch_shards=batch_shards,
                           lane_selective=lane_selective, ragged=ragged)
        res = sweep.run(mk_seeds(), backfill=mk_backfill(list(queue)))
        runs[ragged] = ({r.token: r for r in res}, sweep.iter_stats)
    by_r, stats_r = runs[True]
    by_m, stats_m = runs[False]
    assert set(by_r) == set(by_m) == {"b0", "s0", "p0", "p1", "b2"}
    for tok in by_m:
        assert np.array_equal(_norm(by_r[tok].values),
                              _norm(by_m[tok].values)), tok
        assert by_r[tok].iterations == by_m[tok].iterations
        assert by_r[tok].converged == by_m[tok].converged
    assert sum(s.dispatches for s in stats_r) > 0
    for s in stats_r:
        assert s.dispatches == s.batches == s.ragged_dispatches, s
        assert s.overlap_s >= 0.0
    assert sum(s.dispatches for s in stats_m) > \
        sum(s.dispatches for s in stats_r)
    assert all(s.ragged_dispatches == 0 for s in stats_m)
    if batch_shards > 1:  # batch_shards=1 multi runs per shard (no batches)
        assert sum(s.batches for s in stats_m) == \
            sum(s.batches for s in stats_r)
    eng.close()


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_ragged_service_mixed_workload_bitwise(tmp_path, backend):
    """Service level: ragged on (default) vs off, mixed-algebra workload
    with lane retirement — every query bitwise-equal to its solo run."""
    g = rmat_graph(300, 3500, seed=144)
    eng = _mk_engine(tmp_path, "ref", g, num_shards=5, backend=backend)
    refs = {c: _solo(eng, *c, 12) for c in MIXED}
    eng.close()
    for ragged in (True, False):
        svc = _mk_service(tmp_path, f"svc{ragged}", g, num_shards=5,
                          backend=backend, max_lanes=8, max_groups=2,
                          batch_shards=2, ragged=ragged)
        with svc.submit_batch():
            futs = [svc.submit(p, s, max_iters=12) for p, s in MIXED]
        for c, f in zip(MIXED, futs):
            qr = f.result(timeout=240)
            assert np.array_equal(_norm(qr.values),
                                  _norm(refs[c].values)), (ragged, c)
        deadline = time.monotonic() + 30
        while svc.stats()["sweeps"] < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert svc.stats()["sweeps"] == 1
        svc.close()


def test_ragged_service_matches_reference_ragged_service(tmp_path):
    """The port's ragged cuda service against the reference's ragged
    pallas service (interpret mode) on one store: contract (c)."""
    root = str(tmp_path / "store")
    RefEngine.from_graph(ref_rmat_graph(300, 3500, seed=145), root,
                         backend="numpy", num_shards=5, window=128,
                         k=16).close()
    kw = dict(max_lanes=4, max_groups=2, batch_shards=2)
    out = {}
    for name, svc in (
            ("ref", RefService.from_store(root, backend="pallas", **kw)),
            ("port", GraphService.from_store(root, backend="cuda",
                                             device="cpu", **kw))):
        with svc:
            with svc.submit_batch():
                futs = [svc.submit(p, s, max_iters=8) for p, s in MIXED]
            out[name] = [f.result(timeout=300) for f in futs]
    for (p, s), a, b in zip(MIXED, out["port"], out["ref"]):
        if p == "ppr":
            assert np.allclose(a.values, b.values, rtol=1e-5, atol=1e-9)
        else:
            assert np.array_equal(_norm(a.values), _norm(b.values)), (p, s)
            assert (a.iterations, a.converged) == (b.iterations, b.converged)


# ---------------------------------------------------------- conservation
def test_ragged_metrics_conservation(tmp_path):
    g = rmat_graph(250, 2500, seed=147)
    eng = _mk_engine(tmp_path, "cons", g, backend="cuda", batch_shards=2)
    bfs, ppr = apps.lane_bfs(), apps.lane_ppr()
    sweep = FusedSweep(eng, batch_shards=2, ragged=True)
    sweep.run([
        [LaneSeed(source=0, max_iters=8, token="b", program=bfs)],
        [LaneSeed(source=1, max_iters=8, token="p", program=ppr)],
    ])
    reg = MetricsRegistry()
    for s in sweep.iter_stats:
        reg.ingest(s)
    assert reg.verify_conservation() == []
    snap = reg.snapshot()
    assert snap["sweep.batches"] == snap["sweep.dispatches"] == \
        snap["sweep.ragged_dispatches"]
    eng.close()

    for kw in (dict(dispatches=1, batches=2),
               dict(dispatches=2, batches=1, ragged_dispatches=2)):
        bad = MetricsRegistry()
        bad.ingest(SweepIterStats(
            iteration=0, live_lanes=2, shards_processed=1, shards_skipped=0,
            bytes_read=0, selective_on=False, retired=0, backfilled=0,
            time_s=0.0, **kw))
        with pytest.raises(ConservationError):
            bad.verify_conservation()


def test_ragged_exec_stats_identities():
    reg = MetricsRegistry()
    reg.ingest(ExecStats(
        dispatches=4, batches=4, ragged_dispatches=4, ragged_lanes=20,
        group_lanes={0: 12, 1: 8}, shards_executed=8, overlap_s=0.01,
    ))
    assert reg.verify_conservation() == []
    snap = reg.snapshot()
    assert snap["exec.ragged_dispatches"] == 4
    assert snap["exec.ragged_lanes"] == 20

    bad = MetricsRegistry()
    bad.ingest(ExecStats(
        dispatches=2, batches=2, ragged_dispatches=2, ragged_lanes=9,
        group_lanes={0: 4, 1: 4}, shards_executed=4,
    ))
    with pytest.raises(ConservationError):
        bad.verify_conservation()


# ------------------------------------------------------------------- mesh
@pytest.mark.parametrize("backend", ["numpy", "cuda"])
@pytest.mark.parametrize("D", [1, 2, 8])
def test_ragged_mesh_bitwise(tmp_path, backend, D):
    """A ragged mesh sweep books one dispatch per flush (each slot holding
    shards one more) and stays bitwise the single-device engine, the
    ``numpy`` emulation as the reference's does."""
    g = rmat_graph(300, 3000, seed=145)
    eng = _mk_engine(tmp_path, f"m{D}", g, backend=backend, mesh=D,
                     batch_shards=2)
    ref = _mk_engine(tmp_path, "mref", g, backend=backend)
    bfs, ppr = apps.lane_bfs(), apps.lane_ppr()
    sweep = FusedSweep(eng, ragged=True, batch_shards=2)
    res = sweep.run([
        [LaneSeed(source=2, max_iters=10, token="b", program=bfs)],
        [LaneSeed(source=7, max_iters=6, token="p", program=ppr)],
    ])
    by_tok = {r.token: r for r in res}
    for tok, src, prog, iters in (("b", 2, "bfs", 10), ("p", 7, "ppr", 6)):
        sr = _solo(ref, prog, src, iters)
        assert np.array_equal(_norm(by_tok[tok].values), _norm(sr.values))
    for s in sweep.iter_stats:
        assert s.dispatches == s.batches == s.ragged_dispatches
        assert len(s.device_dispatches) == D
        assert sum(s.device_dispatches) >= s.dispatches
    eng.close()
    ref.close()
