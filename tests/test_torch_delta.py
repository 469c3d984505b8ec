"""Live edge mutations on the port stay bitwise-correct, and byte for byte
the reference's.

The reference's delta tests re-pointed at the port (``device="cpu"``):
after any interleaving of insert/delete batches, overlay-merged decodes
(CSR and ELL) of every shard, post-recompaction base shards, sweeps on
every backend (``numpy``, ``torch`` and ``cuda``, whose kernels run their
plain versions here) and the persisted degree / edge-count metadata equal
a from-scratch build of the mutated edge list on the same intervals, and a
live ``GraphService`` never returns a result mixing two graph versions.

Across packages (ROADMAP North star (a)): the same mutation script leaves
the same files byte for byte at every commit point of every publish and
compaction, and a store either package mutated opens, recovers and goes on
mutating in the other.  On the device path: a shard with pending runs is
never served from the resident device copy, and compaction brings the
resident path back.
"""

import os
import shutil
import threading
import time

import numpy as np
import pytest

from repro.core.storage import ShardStore as RefStore
from repro.delta import EdgeLog as RefEdgeLog
from repro.delta import Recompactor as RefRecompactor
from repro.delta import set_crash_hook as ref_set_crash_hook
from repro_torch.core import apps
from repro_torch.core.csr import csr_to_ell
from repro_torch.core.graph import Graph, rmat_graph, small_world_graph
from repro_torch.core.ingest import (
    csr_from_keys,
    ingest_edge_file,
    keys_of_csr,
    pack_keys,
    write_edge_file,
)
from repro_torch.core.sharding import build_shards, preprocess
from repro_torch.core.storage import ShardStore
from repro_torch.core.vsw import VSWEngine
from repro_torch.delta import (
    CRASH_POINTS,
    EdgeLog,
    Recompactor,
    apply_run,
    set_crash_hook,
)
from repro_torch.delta.edgelog import _norm_edges
from repro_torch.obs import trace
from repro_torch.obs.trace import Tracer

WINDOW, K, TR = 64, 8, 4
CPU = dict(device="cpu")


# --------------------------------------------------------------------------
# Oracle machinery
# --------------------------------------------------------------------------


def _apply_batch_oracle(src, dst, batch):
    """Reference semantics on a plain edge list: deletes (ALL copies of the
    named edges) first, then inserts appended."""
    ins, dels = batch
    if dels is not None:
        tomb = np.unique(pack_keys(
            np.asarray(dels[0], np.int64), np.asarray(dels[1], np.int64)))
        keys = pack_keys(src.astype(np.int64), dst.astype(np.int64))
        pos = np.minimum(np.searchsorted(tomb, keys), len(tomb) - 1)
        keep = tomb[pos] != keys
        src, dst = src[keep], dst[keep]
    if ins is not None:
        src = np.concatenate([src, np.asarray(ins[0], np.int32)])
        dst = np.concatenate([dst, np.asarray(ins[1], np.int32)])
    return src.astype(np.int32), dst.astype(np.int32)


def _mk_store(tmp, g, num_shards, sub="s", via="preprocess", store_cls=ShardStore):
    root = os.path.join(tmp, sub)
    if via == "preprocess":
        meta, shards = preprocess(g, num_shards=num_shards)
        store = store_cls(root)
        store.write_meta(meta, ell_params={"window": WINDOW, "k": K, "tr": TR})
        for s in shards:
            store.write_shard(s, num_vertices=meta.num_vertices,
                              window=WINDOW, k=K, tr=TR)
    else:  # streamed ingest with a tiny chunk to exercise the spill path
        path = os.path.join(tmp, f"{sub}_edges.bin")
        write_edge_file(path, g.src, g.dst)
        store = store_cls(root)
        meta, _ = ingest_edge_file(
            store, path, num_shards=num_shards, num_vertices=g.num_vertices,
            chunk_edges=257, mem_budget_bytes=1 << 12, window=WINDOW, k=K, tr=TR)
    return store, meta


def _rand_batch(rng, g_src, g_dst, n):
    """Random mutation batch: duplicate inserts, deletes of existing AND
    absent edges, overlapping insert/delete keys."""
    kind = rng.integers(0, 3)
    ins = dels = None
    if kind in (0, 2):
        i_src = rng.integers(0, n, rng.integers(1, 40))
        i_dst = rng.integers(0, n, len(i_src))
        if len(g_src) and rng.integers(0, 2):
            j = rng.integers(0, len(g_src))
            i_src = np.append(i_src, g_src[j])
            i_dst = np.append(i_dst, g_dst[j])
        ins = (i_src, i_dst)
    if kind in (1, 2):
        d_src = rng.integers(0, n, rng.integers(1, 20))
        d_dst = rng.integers(0, n, len(d_src))
        if len(g_src):
            take = rng.choice(len(g_src), min(15, len(g_src)), replace=False)
            d_src = np.concatenate([d_src, g_src[take]])
            d_dst = np.concatenate([d_dst, g_dst[take]])
        dels = (d_src, d_dst)
    return ins, dels


def _assert_logical_equal(store, meta, mg):
    """Every logical shard (CSR + ELL) and the metadata vs a from-scratch
    build of the mutated graph on the SAME intervals (either package's
    store: their decodes share the layout)."""
    ref_shards = build_shards(mg, meta.intervals)
    for p in range(meta.num_shards):
        got = store.load_shard(p, "csr")
        ref = ref_shards[p]
        assert np.array_equal(got.row, ref.row), f"shard {p} row"
        assert np.array_equal(got.col, ref.col), f"shard {p} col"
        got_e = store.load_shard(p, "ell")
        ref_e = csr_to_ell(ref, mg.num_vertices, window=WINDOW, k=K, tr=TR)
        assert np.array_equal(got_e.ell_idx, ref_e.ell_idx), f"shard {p} ell"
        assert np.array_equal(got_e.ell_mask, ref_e.ell_mask)
        assert np.array_equal(got_e.seg, ref_e.seg)
        assert got_e.nnz == ref_e.nnz
    disk = store.read_meta()
    assert disk.num_edges == mg.num_edges
    assert np.array_equal(disk.in_deg, mg.in_degrees())
    assert np.array_equal(disk.out_deg, mg.out_degrees())


# --------------------------------------------------------------------------
# Unit: fold semantics
# --------------------------------------------------------------------------


def test_apply_run_fold_unit():
    keys = np.array([1, 5, 5, 9], dtype=np.int64)
    out = apply_run(keys, tombs=np.array([5], np.int64),
                    ins=np.array([2, 9], np.int64))
    assert out.tolist() == [1, 2, 9, 9]
    out = apply_run(out, tombs=np.array([4], np.int64), ins=np.empty(0, np.int64))
    assert out.tolist() == [1, 2, 9, 9]
    out = apply_run(np.empty(0, np.int64), np.array([1], np.int64),
                    np.array([3], np.int64))
    assert out.tolist() == [3]


def test_keys_roundtrip_unit():
    g = rmat_graph(100, 400, seed=7)
    _, shards = preprocess(g, num_shards=3)
    for s in shards:
        keys = keys_of_csr(s)
        assert np.all(np.diff(keys) >= 0)
        back = csr_from_keys(s.shard_id, s.v0, s.v1, keys)
        assert np.array_equal(back.row, s.row)
        assert np.array_equal(back.col, s.col)


def test_norm_edges_validation_unit():
    assert _norm_edges(None, 10, "x") is None
    assert _norm_edges((np.array([]), np.array([])), 10, "x") is None
    with pytest.raises(ValueError, match="out of range"):
        _norm_edges((np.array([0]), np.array([10])), 10, "x")
    with pytest.raises(ValueError, match="out of range"):
        _norm_edges((np.array([-1]), np.array([0])), 10, "x")
    with pytest.raises(ValueError, match="mismatch"):
        _norm_edges((np.array([1, 2]), np.array([1])), 10, "x")
    s, d = _norm_edges(np.array([[1, 2], [3, 4]]), 10, "x")
    assert s.tolist() == [1, 3] and d.tolist() == [2, 4]


def test_edgelog_rejects_out_of_range(tmp_path):
    store, _ = _mk_store(str(tmp_path), rmat_graph(50, 200, seed=1), 2)
    log = EdgeLog(store)
    with pytest.raises(ValueError):
        log.append(inserts=(np.array([0]), np.array([50])))
    assert log.staged_batches == 0


# --------------------------------------------------------------------------
# Property: overlay + recompaction bitwise vs from-scratch build
# --------------------------------------------------------------------------


@pytest.mark.parametrize("via", ["preprocess", "ingest"])
@pytest.mark.parametrize("seed", range(6))
def test_overlay_and_compaction_bitwise(tmp_path, seed, via):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(40, 300))
    m = int(rng.integers(0, 900))
    g = rmat_graph(n, m, seed=seed + 100)
    num_shards = int(rng.integers(1, 7))
    store, meta = _mk_store(str(tmp_path), g, num_shards, via=via)

    src, dst = g.src, g.dst
    log = EdgeLog(store, chunk_edges=int(rng.integers(1, 64)))
    for round_ in range(3):
        for _ in range(int(rng.integers(1, 3))):
            batch = _rand_batch(rng, src, dst, n)
            log.append(inserts=batch[0], deletes=batch[1])
            src, dst = _apply_batch_oracle(src, dst, batch)
        pub = log.publish()
        mg = Graph(n, src, dst)
        assert store.read_meta().num_edges == mg.num_edges, pub
        _assert_logical_equal(store, meta, mg)
        if round_ == 1:
            Recompactor(store).compact()
            assert store.delta.dirty_shards() == []
            _assert_logical_equal(store, meta, mg)
    Recompactor(store).compact()
    _assert_logical_equal(store, meta, Graph(n, src, dst))
    assert store.delta.dirty_shards() == []


def test_publish_sequencing_semantics(tmp_path):
    g = Graph(10, np.array([1, 1, 2], np.int32), np.array([3, 3, 4], np.int32))
    store, _ = _mk_store(str(tmp_path), g, 1)
    log = EdgeLog(store)
    log.append(inserts=(np.array([1]), np.array([3])),
               deletes=(np.array([1]), np.array([3])))
    log.publish()
    keys = keys_of_csr(store.load_shard(0, "csr"))
    assert keys.tolist() == pack_keys(
        np.array([1, 2], np.int64), np.array([3, 4], np.int64)).tolist()
    log.append(inserts=(np.array([5]), np.array([6])))
    log.append(deletes=(np.array([5]), np.array([6])))
    log.publish()
    keys = keys_of_csr(store.load_shard(0, "csr"))
    assert pack_keys(np.array([5], np.int64), np.array([6], np.int64))[0] not in keys
    m2 = store.read_meta()
    ref = Graph(10, np.array([1, 2], np.int32), np.array([3, 4], np.int32))
    assert np.array_equal(m2.in_deg, ref.in_degrees())
    assert np.array_equal(m2.out_deg, ref.out_degrees())
    assert m2.num_edges == 2


def test_empty_publish_and_noop_batches(tmp_path):
    g = rmat_graph(30, 100, seed=2)
    store, meta = _mk_store(str(tmp_path), g, 2)
    log = EdgeLog(store)
    assert log.publish().version == 0
    log.append()
    assert log.staged_batches == 0
    log.append(inserts=(np.array([1]), np.array([2])))
    log.append(deletes=(np.array([1]), np.array([2])))
    pub = log.publish()
    src, dst = _apply_batch_oracle(g.src, g.dst,
                                   ((np.array([1]), np.array([2])), None))
    src, dst = _apply_batch_oracle(src, dst, (None, (np.array([1]), np.array([2]))))
    _assert_logical_equal(store, meta, Graph(30, src, dst))
    assert pub.version == 1


def test_manifest_recovery_dirty_reopen(tmp_path):
    g = rmat_graph(80, 400, seed=3)
    store, meta = _mk_store(str(tmp_path), g, 3)
    log = EdgeLog(store)
    ins = (np.array([1, 2, 3]), np.array([4, 5, 6]))
    log.append(inserts=ins)
    pub = log.publish()
    orphan = os.path.join(store.root, "delta_run_00000_0000099.npz")
    with open(orphan, "wb") as f:
        f.write(b"garbage")
    store2 = ShardStore(store.root)
    assert store2.delta is not None
    assert store2.delta.version == pub.version
    assert not os.path.exists(orphan)
    src, dst = _apply_batch_oracle(g.src, g.dst, (ins, None))
    _assert_logical_equal(store2, meta, Graph(80, src, dst))


def test_load_shards_logical_bulk_matches_the_reference(tmp_path):
    """``load_shards`` decodes clean shards from the base and dirty ones
    through the overlay, at one version, as the reference's does."""
    g = rmat_graph(120, 900, seed=23)
    store, _ = _mk_store(str(tmp_path), g, 4)
    log = EdgeLog(store)
    log.append(inserts=(np.array([1, 2]), np.array([0, 1])))
    log.publish()
    assert 0 < len(store.delta.dirty_shards()) < 4
    ref = RefStore(store.root)
    for fmt, fields in (("csr", ("row", "col")),
                        ("ell", ("ell_idx", "ell_mask", "seg", "tile_window"))):
        got, want = store.load_shards(range(4), fmt), ref.load_shards(range(4), fmt)
        assert sorted(got) == sorted(want) == [0, 1, 2, 3]
        for p in range(4):
            for f in fields:
                assert np.array_equal(getattr(got[p], f), getattr(want[p], f))
                assert np.array_equal(getattr(got[p], f),
                                      getattr(store.load_shard(p, fmt), f))


def test_reingest_clears_stale_delta_state(tmp_path):
    g = rmat_graph(60, 300, seed=4)
    store, _ = _mk_store(str(tmp_path), g, 2, via="ingest")
    log = EdgeLog(store)
    log.append(inserts=(np.array([1]), np.array([2])))
    log.publish()
    assert store.delta is not None and store.delta.version == 1
    g2 = rmat_graph(60, 300, seed=5)
    path = os.path.join(str(tmp_path), "re.bin")
    write_edge_file(path, g2.src, g2.dst)
    meta2, stats = ingest_edge_file(store, path, num_shards=2, num_vertices=60,
                                    window=WINDOW, k=K, tr=TR)
    assert stats.stale_delta_runs_removed >= 1
    assert store.delta is None
    _assert_logical_equal(store, meta2, g2)


def test_compaction_trigger_batches_runs(tmp_path):
    store, _ = _mk_store(str(tmp_path), rmat_graph(60, 300, seed=20), 2)
    log = EdgeLog(store)
    log.append(inserts=(np.array([1]), np.array([2])))
    log.publish()
    rc = Recompactor(store, min_runs=3)
    assert not any(rc.should_compact(p) for p in rc.dirty_shards())
    assert rc.compact().shards_compacted == 0
    for _ in range(2):
        log.append(inserts=(np.array([1]), np.array([2])))
        log.publish()
    assert any(rc.should_compact(p) for p in rc.dirty_shards())
    assert rc.compact().shards_compacted >= 1
    log.append(inserts=(np.array([1, 2, 3]), np.array([2, 3, 4])))
    log.publish()
    rc2 = Recompactor(store, min_runs=100, min_delta_frac=1e-9)
    assert any(rc2.should_compact(p) for p in rc2.dirty_shards())


def test_write_meta_preserves_ell_block_fresh_process(tmp_path):
    import json

    g = rmat_graph(40, 200, seed=21)
    store, _ = _mk_store(str(tmp_path), g, 2, via="ingest")
    fresh = ShardStore(store.root)
    fresh.write_meta(fresh.read_meta())
    prop = json.loads(fresh.read_bytes("property.json"))
    assert prop["ell"] == {"window": WINDOW, "k": K, "tr": TR}
    log = EdgeLog(fresh)
    log.append(inserts=(np.array([1]), np.array([2])))
    log.publish()
    assert fresh.ell_params()["window"] == WINDOW
    fresh.load_shard(fresh.read_meta().shard_of_vertex(2), "ell")


def test_failed_publish_leaves_no_orphan_runs(tmp_path, monkeypatch):
    g = rmat_graph(80, 500, seed=22)
    store, meta = _mk_store(str(tmp_path), g, 4)
    log = EdgeLog(store)
    log.append(inserts=(np.arange(20) % 80, (np.arange(20) * 7) % 80))
    real_write = store.write_bytes
    writes = {"n": 0}

    def failing_write(name, raw):
        if name.startswith("delta_run_"):
            writes["n"] += 1
            if writes["n"] == 2:
                raise OSError("disk full")
        return real_write(name, raw)

    monkeypatch.setattr(store, "write_bytes", failing_write)
    with pytest.raises(OSError):
        log.publish()
    monkeypatch.setattr(store, "write_bytes", real_write)
    assert [f for f in os.listdir(store.root) if f.startswith("delta_run_")] == []
    assert store.delta.version == 0
    log.append(inserts=(np.array([3]), np.array([4])))
    assert log.publish().version == 1
    src, dst = _apply_batch_oracle(g.src, g.dst,
                                   ((np.array([3]), np.array([4])), None))
    _assert_logical_equal(store, meta, Graph(80, src, dst))


def test_pin_blocks_compaction_until_release(tmp_path):
    store, _ = _mk_store(str(tmp_path), rmat_graph(50, 300, seed=6), 2)
    log = EdgeLog(store)
    log.append(inserts=(np.array([1, 2]), np.array([3, 4])))
    log.publish()
    overlay = store.delta
    pin = overlay.acquire_pin()
    log.append(inserts=(np.array([5]), np.array([6])))
    log.publish()
    done = threading.Event()

    def compact():
        Recompactor(store).compact()
        done.set()

    t = threading.Thread(target=compact)
    t.start()
    assert not done.wait(0.3)
    overlay.release_pin(pin)
    assert done.wait(5.0)
    t.join()
    assert overlay.dirty_shards() == []


# --------------------------------------------------------------------------
# Parallel finalize + ingest-time warmup
# --------------------------------------------------------------------------


def _ingest_with(tmp, g, sub, **kw):
    path = os.path.join(tmp, f"{sub}.bin")
    write_edge_file(path, g.src, g.dst)
    store = ShardStore(os.path.join(tmp, sub))
    meta, stats = ingest_edge_file(
        store, path, num_shards=5, num_vertices=g.num_vertices,
        chunk_edges=313, mem_budget_bytes=1 << 12, window=WINDOW, k=K, tr=TR, **kw)
    return store, meta, stats


def test_parallel_finalize_bitwise_and_stats(tmp_path):
    g = rmat_graph(300, 4000, seed=8)
    s1, m1, st1 = _ingest_with(str(tmp_path), g, "w1", finalize_workers=1)
    s4, _, st4 = _ingest_with(str(tmp_path), g, "w4", finalize_workers=4)
    assert st4.finalize_workers == 4
    for p in range(m1.num_shards):
        a, b = s1.load_shard(p, "csr"), s4.load_shard(p, "csr")
        assert np.array_equal(a.row, b.row) and np.array_equal(a.col, b.col)
        ea, eb = s1.load_shard(p, "ell"), s4.load_shard(p, "ell")
        assert np.array_equal(ea.ell_idx, eb.ell_idx)
    for st, store in ((st1, s1), (st4, s4)):
        assert store.io.bytes_written == st.bytes_written_total
    assert st1.shard_bytes_written == st4.shard_bytes_written
    assert st1.spill_bytes_written == st4.spill_bytes_written
    _, _, st0 = _ingest_with(str(tmp_path), g, "w0", finalize_workers=0)
    assert st0.finalize_workers >= 1


def test_ingest_warmup_sources_deposited(tmp_path):
    g = rmat_graph(200, 2000, seed=9)
    store, meta, stats = _ingest_with(str(tmp_path), g, "warm")
    assert stats.warm_sources_built == meta.num_shards
    _, shards = preprocess(g, num_shards=5)
    for s in shards:
        warm = store.warm_sources(s.shard_id)
        assert warm is not None
        assert np.array_equal(warm, np.unique(s.col))
    store2, _, st2 = _ingest_with(str(tmp_path), g, "warmraw", warm_bytes=1 << 30)
    assert st2.warm_raw_bytes > 0
    assert store2.warm_raw(0, "csr") == store2.shard_bytes(0, "csr")
    store3, _, st3 = _ingest_with(str(tmp_path), g, "cold", warm_sources=False)
    assert st3.warm_sources_built == 0 and store3.warm_sources(0) is None


def test_ingest_warmup_skips_boot_reads_e2e(tmp_path):
    g = rmat_graph(200, 2000, seed=10)
    store, meta, _ = _ingest_with(str(tmp_path), g, "boot", warm_bytes=1 << 30)
    io0 = store.io.snapshot()
    eng = VSWEngine(store, cache_bytes=1 << 22, backend="cuda", **CPU)
    assert (store.io - io0).reads < meta.num_shards
    cold = ShardStore(store.root)
    io1 = cold.io.snapshot()
    eng_cold = VSWEngine(cold, cache_bytes=1 << 22, backend="cuda", **CPU)
    assert (cold.io - io1).reads >= meta.num_shards
    a = eng.run(apps.pagerank(), max_iters=5)
    b = eng_cold.run(apps.pagerank(), max_iters=5)
    assert np.array_equal(a.values, b.values)
    eng.close()
    eng_cold.close()


def test_session_cache_drop_stale_versions_unit():
    from repro_torch.serve.session import SessionCache

    c = SessionCache(16)
    c.put(("k", 1, 0), "a")
    c.put(("k", 2, 0), "b")
    c.put(("k", 1, 1), "c")
    assert c.drop_stale_versions(1) == 2
    assert c.get(("k", 1, 1)) == "c"
    assert c.get(("k", 1, 0)) is None


# --------------------------------------------------------------------------
# Engine-level sweeps on mutated stores
# --------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["numpy", "torch", "cuda"])
def test_engine_sweep_matches_fresh_preprocess_e2e(tmp_path, backend):
    rng = np.random.default_rng(11)
    g = rmat_graph(250, 1500, seed=11)
    store, _ = _mk_store(str(tmp_path), g, 5)
    src, dst = g.src, g.dst
    log = EdgeLog(store)
    for _ in range(2):
        batch = _rand_batch(rng, src, dst, 250)
        log.append(inserts=batch[0], deletes=batch[1])
        src, dst = _apply_batch_oracle(src, dst, batch)
    log.publish()
    mg = Graph(250, src, dst)
    fresh = VSWEngine.from_graph(
        mg, os.path.join(str(tmp_path), f"fresh_{backend}"), num_shards=5,
        window=WINDOW, k=K, tr=TR, backend=backend, **CPU)
    live = VSWEngine(store, backend=backend, cache_bytes=1 << 20,
                     batch_shards=2 if backend != "numpy" else 1, **CPU)
    for prog in ("pagerank", "bfs", "sssp"):
        ref = fresh.run(apps.get_program(prog), max_iters=12)
        got = live.run(apps.get_program(prog), max_iters=12)
        assert np.array_equal(got.values, ref.values), (backend, prog)
    Recompactor(store).compact()
    for prog in ("pagerank", "bfs"):
        ref = fresh.run(apps.get_program(prog), max_iters=12)
        got = live.run(apps.get_program(prog), max_iters=12)
        assert np.array_equal(got.values, ref.values), (backend, prog, "compacted")
    fresh.close()
    live.close()


@pytest.mark.parametrize("backend,batch_shards", [
    ("numpy", 1), ("torch", 1), ("torch", 3), ("cuda", 2),
])
def test_lane_mask_bitwise_vs_solo_e2e(tmp_path, backend, batch_shards):
    from repro_torch.serve.sweep import LaneSeed, LaneSweep

    g = small_world_graph(600, k=2, shortcuts=0.01, seed=12)
    root = os.path.join(str(tmp_path), f"lm_{backend}{batch_shards}")
    eng = VSWEngine.from_graph(g, root, num_shards=8, window=WINDOW, k=K, tr=TR,
                               threshold=0.5, backend=backend, **CPU)
    sources = [3, 150, 300, 450]
    sweep = LaneSweep(eng, apps.lane_bfs(), lane_selective=True,
                      batch_shards=batch_shards)
    results = sweep.run([LaneSeed(source=s) for s in sources])
    assert sum(it.lane_rows_skipped for it in sweep.iter_stats) > 0
    by_src = {r.source: r for r in results}
    for s in sources:
        ref = eng.run(apps.bfs(s), max_iters=100)
        assert np.array_equal(by_src[s].values, ref.values), s
    sweep_off = LaneSweep(eng, apps.lane_bfs(), lane_selective=False,
                          batch_shards=batch_shards)
    for r in sweep_off.run([LaneSeed(source=s) for s in sources]):
        assert np.array_equal(r.values, by_src[r.source].values)
    eng.close()


# --------------------------------------------------------------------------
# The device path: dirty shards never come from the resident copy
# --------------------------------------------------------------------------


def _load_spans(tracer):
    return [e["args"] for e in tracer.export_chrome()["traceEvents"]
            if e.get("name") == "shard.load" and "args" in e]


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_resident_engine_never_serves_a_dirty_shard(tmp_path, backend):
    """A resident engine after a publish: the dirty shards' pre-mutation
    device copies are dropped, their logical decodes are copied to the
    device each sweep and never kept; a pre-mutation copy put back in the
    resident map (as an in-flight copy racing the publish would) is never
    served, since the pipeline asks the overlay first.  Compaction brings
    every shard back to the resident map.  Every sweep is bitwise a
    from-scratch build of the mutated graph."""
    g = rmat_graph(400, 5000, seed=41)
    store, meta = _mk_store(str(tmp_path), g, 4)
    eng = VSWEngine(store, backend=backend, device_resident=True,
                    batch_shards=2, **CPU)
    eng.run(apps.pagerank(), max_iters=1)
    assert sorted(eng._device_shards) == [0, 1, 2, 3]
    stale = dict(eng._device_shards)
    hub = int(np.argmax(g.in_degrees()))
    ins = (np.arange(50) % 400, np.full(50, hub))
    log = EdgeLog(store)
    log.append(inserts=ins)
    pub = log.publish()
    dirty = set(pub.shards_touched)
    assert dirty and len(dirty) < 4
    assert not dirty & set(eng._device_shards)
    src, dst = _apply_batch_oracle(g.src, g.dst, (ins, None))
    fresh = VSWEngine.from_graph(Graph(400, src, dst), str(tmp_path / "fresh"),
                                 num_shards=4, window=WINDOW, k=K, tr=TR,
                                 backend=backend, **CPU)
    want = {p: fresh.run(apps.get_program(p), max_iters=6).values
            for p in ("pagerank", "bfs", "wcc")}
    for p in dirty:  # the racing copy lands after the invalidation
        eng._device_shards[p] = stale[p]
    with trace.tracing(Tracer()) as tr:
        for p in ("pagerank", "bfs", "wcc"):
            got = eng.run(apps.get_program(p), max_iters=6).values
            assert np.array_equal(got, want[p]), p
    spans = _load_spans(tr)
    assert spans
    for a in spans:
        assert a["logical"] == (a["shard"] in dirty)
        assert not (a["from_resident"] and a["shard"] in dirty)
    assert any(a["from_resident"] for a in spans)
    assert all(eng._device_shards[p] is stale[p] for p in dirty)  # never kept
    assert Recompactor(store).compact().shards_compacted == len(dirty)
    assert not dirty & set(eng._device_shards)  # compaction dropped them
    got = eng.run(apps.pagerank(), max_iters=6).values
    assert np.array_equal(got, want["pagerank"])
    assert sorted(eng._device_shards) == [0, 1, 2, 3]
    with trace.tracing(Tracer()) as tr:
        got = eng.run(apps.bfs(), max_iters=6).values
    assert np.array_equal(got, want["bfs"])
    spans = _load_spans(tr)
    assert spans and all(a["from_resident"] and not a["logical"] for a in spans)
    eng.close()
    fresh.close()


# --------------------------------------------------------------------------
# Serving: update-during-serve
# --------------------------------------------------------------------------


def _oracle_values(cache, tmp, states, version, source, max_iters=100):
    """Solo-engine BFS oracle for (version, source), memoized."""
    key = (version, source)
    if key not in cache:
        src, dst = states[version]
        eng = VSWEngine.from_graph(
            Graph(states["n"], src, dst),
            os.path.join(tmp, f"oracle_v{version}_{source}"),
            num_shards=4, window=WINDOW, k=K, tr=TR, backend="numpy", **CPU)
        cache[key] = eng.run(apps.bfs(source), max_iters=max_iters).values
        eng.close()
    return cache[key]


def test_service_update_during_serve_stress_e2e(tmp_path):
    """Concurrent apply_updates + queries: every result matches a
    from-scratch oracle of the edge state AT ITS REPORTED VERSION."""
    from repro_torch.serve import GraphService

    rng = np.random.default_rng(13)
    n = 300
    g = small_world_graph(n, k=2, shortcuts=0.02, seed=13)
    states = {"n": n, 0: (g.src, g.dst)}
    tmp = str(tmp_path)
    svc = GraphService.from_graph(
        g, os.path.join(tmp, "svc"), num_shards=4, window=WINDOW, k=K, tr=TR,
        max_lanes=4, session_entries=64, backend="numpy", **CPU)
    sources = [1, 77, 150, 222]
    results = []
    res_lock = threading.Lock()
    stop = threading.Event()

    def querier():
        while not stop.is_set():
            s = sources[rng.integers(0, len(sources))]
            qr = svc.query("bfs", int(s))
            with res_lock:
                results.append(qr)

    threads = [threading.Thread(target=querier) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        src, dst = g.src, g.dst
        for v in range(1, 4):
            time.sleep(0.05)
            batch = _rand_batch(rng, src, dst, n)
            src, dst = _apply_batch_oracle(src, dst, batch)
            upd = svc.apply_updates(inserts=batch[0], deletes=batch[1]).result()
            assert upd.graph_version == v
            states[v] = (src, dst)
        time.sleep(0.15)
    finally:
        stop.set()
        for t in threads:
            t.join()

    final = [svc.query("bfs", s) for s in sources]
    svc.close()
    oracle_cache = {}
    assert len(results) > 0
    # session-cache hits repeat one answer many times: check each distinct
    # (version, source, values) once
    seen = {}
    for qr in results + final:
        seen.setdefault((qr.graph_version, qr.source, qr.values.tobytes()), qr)
    for qr in seen.values():
        assert qr.graph_version in states, qr.graph_version
        ref = _oracle_values(oracle_cache, tmp, states, qr.graph_version, qr.source)
        assert np.array_equal(qr.values, ref), (
            f"source {qr.source} @ v{qr.graph_version} (cached={qr.cached})")
    for qr in final:
        assert qr.graph_version == 3


def test_service_auto_compact_during_serve_e2e(tmp_path):
    from repro_torch.serve import GraphService

    n = 200
    g = small_world_graph(n, k=2, shortcuts=0.02, seed=14)
    tmp = str(tmp_path)
    svc = GraphService.from_graph(
        g, os.path.join(tmp, "svc"), num_shards=4, window=WINDOW, k=K, tr=TR,
        max_lanes=4, auto_compact_runs=1, backend="numpy", **CPU)
    states = {"n": n, 0: (g.src, g.dst)}
    src, dst = g.src, g.dst
    rng = np.random.default_rng(15)
    for v in range(1, 4):
        batch = _rand_batch(rng, src, dst, n)
        src, dst = _apply_batch_oracle(src, dst, batch)
        svc.apply_updates(inserts=batch[0], deletes=batch[1]).result()
        states[v] = (src, dst)
        qr = svc.query("bfs", 5)
        ref = _oracle_values({}, tmp, states, qr.graph_version, 5)
        assert np.array_equal(qr.values, ref), f"v{qr.graph_version}"
    deadline = time.time() + 10
    while svc.engine.store.delta.dirty_shards() and time.time() < deadline:
        time.sleep(0.05)
    assert svc.engine.store.delta.dirty_shards() == []
    assert svc.stats()["shards_compacted"] >= 1
    qr = svc.query("bfs", 5)
    assert np.array_equal(qr.values, _oracle_values({}, tmp, states, 3, 5))
    svc.close()


def test_service_from_dirty_store_boot_e2e(tmp_path):
    from repro_torch.serve import GraphService

    g = rmat_graph(150, 900, seed=16)
    store, _ = _mk_store(str(tmp_path), g, 4)
    log = EdgeLog(store)
    ins = (np.array([3, 4, 5]), np.array([10, 11, 12]))
    log.append(inserts=ins)
    log.publish()
    src, dst = _apply_batch_oracle(g.src, g.dst, (ins, None))
    svc = GraphService.from_store(store.root, max_lanes=4, backend="cuda", **CPU)
    qr = svc.query("bfs", 3)
    ref_eng = VSWEngine.from_graph(
        Graph(150, src, dst), os.path.join(str(tmp_path), "oracle"),
        num_shards=4, window=WINDOW, k=K, tr=TR, backend="numpy", **CPU)
    ref = ref_eng.run(apps.bfs(3), max_iters=100)
    assert np.array_equal(qr.values, ref.values)
    ref_eng.close()
    svc.close()


# --------------------------------------------------------------------------
# Crash windows: failed-publish cleanup + journaled metadata
# --------------------------------------------------------------------------


def _fail_nth_delta_write(store, nth):
    orig = store.write_bytes
    seen = {"n": 0}

    def failing(name, data):
        if name.startswith("delta_run_") or name.startswith("delta_journal_"):
            seen["n"] += 1
            if seen["n"] == nth:
                raise OSError(f"injected failure at delta write #{nth}")
        return orig(name, data)

    store.write_bytes = failing
    return lambda: setattr(store, "write_bytes", orig)


@pytest.mark.parametrize("fail_at", ["second_run", "journal"])
def test_failed_publish_scrubs_every_partial_file(tmp_path, fail_at):
    g = rmat_graph(200, 3000, seed=3)
    store, meta = _mk_store(str(tmp_path), g, 4)
    log = EdgeLog(store)
    rng = np.random.default_rng(5)
    ins = (rng.integers(0, 200, 60), rng.integers(0, 200, 60))
    log.append(inserts=ins)
    touched = len({np.searchsorted(meta.intervals[1:], d, side="right")
                   for d in ins[1]})
    assert touched >= 2
    nth = 2 if fail_at == "second_run" else touched + 1
    restore = _fail_nth_delta_write(store, nth)
    with pytest.raises(OSError, match="injected"):
        log.publish()
    restore()
    assert store.delta.version == 0
    leftovers = [f for f in os.listdir(store.root)
                 if f.startswith(("delta_run_", "delta_journal_"))]
    assert not leftovers, leftovers
    assert store.read_meta().num_edges == g.num_edges
    log.append(inserts=ins)
    assert log.publish().version == 1
    src, dst = _apply_batch_oracle(g.src, g.dst, (ins, None))
    _assert_logical_equal(store, meta, Graph(200, src, dst))


def test_publish_meta_write_failure_recovers_on_reopen(tmp_path):
    g = rmat_graph(150, 2000, seed=11)
    store, meta = _mk_store(str(tmp_path), g, 4)
    log = EdgeLog(store)
    ins = (np.array([1, 2, 3, 7]), np.array([4, 5, 6, 9]))
    log.append(inserts=ins)
    orig = store.write_meta

    def failing_meta(m, **kw):
        raise OSError("injected metadata write failure")

    store.write_meta = failing_meta
    with pytest.raises(OSError, match="injected"):
        log.publish()
    store.write_meta = orig
    assert store.delta.version == 1
    store2 = ShardStore(store.root)
    assert store2.delta.last_recovery.journal_replayed
    src, dst = _apply_batch_oracle(g.src, g.dst, (ins, None))
    _assert_logical_equal(store2, meta, Graph(150, src, dst))
    assert not ShardStore(store.root).delta.last_recovery.acted


# --------------------------------------------------------------------------
# Across packages
# --------------------------------------------------------------------------


def _tree(root):
    """Every file under ``root`` (the stage dir included), name -> bytes."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return dict(sorted(out.items()))


def _mutation_script(tmp, tag, pkg, g, batches, snaps):
    """Build, publish each batch, compact: with ``pkg``'s classes, a
    snapshot of every file at each commit point and after each step."""
    store_cls, log_cls, rc_cls, hook = pkg
    store, _ = _mk_store(tmp, g, 4, sub=tag, store_cls=store_cls)
    hook(lambda name: snaps.append((name, _tree(store.root))))
    try:
        log = log_cls(store, chunk_edges=37)
        for ins, dels in batches:
            log.append(inserts=ins, deletes=dels)
            log.publish()
            snaps.append(("published", _tree(store.root)))
        rc_cls(store, min_runs=1).compact()
        snaps.append(("compacted", _tree(store.root)))
    finally:
        hook(None)


@pytest.mark.parametrize("seed", range(3))
def test_mutation_script_byte_identical_across_packages(tmp_path, monkeypatch, seed):
    """The same mutation script run by each package leaves the same files
    byte for byte at every commit point of every publish and compaction:
    run files, journals, manifest, ``property.json``, ``vertexinfo.npz``,
    staged and compacted containers.  (npz members carry the write time,
    so the clock is pinned for both.)"""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    rng = np.random.default_rng(seed)
    g = rmat_graph(300, 3000, seed=60 + seed)
    src, dst = g.src, g.dst
    batches = []
    for _ in range(3):
        batches.append(_rand_batch(rng, src, dst, 300))
        src, dst = _apply_batch_oracle(src, dst, batches[-1])
    tmp = str(tmp_path)
    ref, pt = [], []
    _mutation_script(tmp, "ref", (RefStore, RefEdgeLog, RefRecompactor,
                                  ref_set_crash_hook), g, batches, ref)
    _mutation_script(tmp, "pt", (ShardStore, EdgeLog, Recompactor,
                                 set_crash_hook), g, batches, pt)
    assert [n for n, _ in pt] == [n for n, _ in ref]
    assert {n for n, _ in pt} >= set(CRASH_POINTS) | {"published", "compacted"}
    for (name, a), (_, b) in zip(ref, pt):
        assert list(a) == list(b), name
        for f in a:
            assert a[f] == b[f], (name, f)
    names = {f for _, snap in pt for f in snap}
    assert any(f.startswith("delta_journal_") for f in names)
    assert any(f.startswith("delta_stage") for f in names)


@pytest.mark.parametrize("writer", ["ref", "pt"])
def test_store_mutated_by_one_package_goes_on_in_the_other(tmp_path, writer):
    """A store one package mutated (two publishes, left dirty) opens in the
    other at the same version with the same logical shards; the other
    publishes a third batch and compacts, and the first reopens it
    bitwise the oracle."""
    first = ((RefStore, RefEdgeLog, RefRecompactor) if writer == "ref"
             else (ShardStore, EdgeLog, Recompactor))
    second = ((ShardStore, EdgeLog, Recompactor) if writer == "ref"
              else (RefStore, RefEdgeLog, RefRecompactor))
    rng = np.random.default_rng(70)
    g = rmat_graph(250, 2500, seed=71)
    store, meta = _mk_store(str(tmp_path), g, 4, store_cls=first[0])
    src, dst = g.src, g.dst
    log = first[1](store)
    for _ in range(2):
        batch = _rand_batch(rng, src, dst, 250)
        log.append(inserts=batch[0], deletes=batch[1])
        log.publish()
        src, dst = _apply_batch_oracle(src, dst, batch)
    other = second[0](store.root)
    assert other.delta.version == 2
    assert other.delta.dirty_shards() == store.delta.dirty_shards()
    _assert_logical_equal(other, meta, Graph(250, src, dst))
    batch = _rand_batch(rng, src, dst, 250)
    log2 = second[1](other)
    log2.append(inserts=batch[0], deletes=batch[1])
    log2.publish()
    src, dst = _apply_batch_oracle(src, dst, batch)
    second[2](other).compact()
    back = first[0](store.root)
    assert back.delta.version == 3 and back.delta.dirty_shards() == []
    _assert_logical_equal(back, meta, Graph(250, src, dst))
    shutil.rmtree(store.root)
