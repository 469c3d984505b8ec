"""Streamed out-of-core ingestion of the port, against both packages.

The reference's ingest tests re-pointed at the port (``device="cpu"``):
:func:`repro_torch.core.ingest.ingest_edge_file` gives bitwise the
``GraphMeta`` and shards of the in-memory ``preprocess`` for every chunk
size, spill cadence and edge-file format, with peak memory O(chunk + one
shard).  Then across packages (ROADMAP North star (a), (b)): the same edge
file ingested by the reference and by the port gives the same store byte
for byte — both formats, spilling or not, one finalize worker or four —
and the same ``IngestStats``.
"""

import dataclasses
import gc
import os
import tempfile
import time
import tracemalloc

import numpy as np
import pytest

try:
    from hypothesis import HealthCheck, given, settings, strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

from repro.core import apps as ref_apps
from repro.core.ingest import ingest_edge_file as ref_ingest_edge_file
from repro.core.ingest import write_edge_file as ref_write_edge_file
from repro.core.storage import ShardStore as RefStore
from repro.core.vsw import VSWEngine as RefEngine
from repro_torch.core import apps
from repro_torch.core.cache import ShardCache
from repro_torch.core.graph import Graph, rmat_graph, star_graph
from repro_torch.core.ingest import (
    ingest_edge_file,
    iter_edge_chunks,
    kway_merge,
    write_edge_file,
)
from repro_torch.core.sharding import preprocess
from repro_torch.core.storage import ShardStore
from repro_torch.core.vsw import VSWEngine

CPU = dict(device="cpu")

if HAVE_HYPOTHESIS:

    @st.composite
    def graphs(draw, max_v=60, max_e=300):
        n = draw(st.integers(min_value=2, max_value=max_v))
        m = draw(st.integers(min_value=1, max_value=max_e))
        src = draw(st.lists(st.integers(0, n - 1), min_size=m, max_size=m))
        dst = draw(st.lists(st.integers(0, n - 1), min_size=m, max_size=m))
        return Graph(n, np.array(src, np.int32), np.array(dst, np.int32))


def _seeded_graph(seed, max_v=60, max_e=300):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, max_v + 1))
    m = int(rng.integers(1, max_e + 1))
    return Graph(
        n,
        rng.integers(0, n, m).astype(np.int32),
        rng.integers(0, n, m).astype(np.int32),
    )


def _property(arg_fn, n_examples, hyp_decorators):
    """Hypothesis when available, else a seeded parametrize (same checks)."""

    def deco(check):
        if HAVE_HYPOTHESIS:
            f = check
            for d in reversed(hyp_decorators):
                f = d(f)
            return f

        @pytest.mark.parametrize("seed", range(n_examples))
        def wrapper(seed):
            check(*arg_fn(seed))

        wrapper.__name__ = check.__name__
        return wrapper

    return deco


# --------------------------------------------------------------------------
# The oracle comparison
# --------------------------------------------------------------------------


def _ingest_into(d, g, *, fmt, chunk_edges, mem_budget_bytes, **part):
    """Write g's edges to a file, stream-ingest, return (store, meta, stats)."""
    ext = ".txt" if fmt == "text" else ".bin"
    edge_path = os.path.join(d, f"edges{ext}")
    write_edge_file(edge_path, g.src, g.dst, fmt=fmt)
    store = ShardStore(os.path.join(d, "store"))
    meta, stats = ingest_edge_file(
        store, edge_path, num_vertices=g.num_vertices, chunk_edges=chunk_edges,
        mem_budget_bytes=mem_budget_bytes, window=64, k=8, tr=4, **part,
    )
    return store, meta, stats


def _assert_bitwise_equal(store, meta, g, **part):
    """meta + every shard from the store vs in-memory preprocess, bitwise."""
    ref_meta, ref_shards = preprocess(g, **part)
    assert meta.num_vertices == ref_meta.num_vertices
    assert meta.num_edges == ref_meta.num_edges
    assert meta.num_shards == ref_meta.num_shards
    assert meta.intervals.dtype == ref_meta.intervals.dtype
    assert np.array_equal(meta.intervals, ref_meta.intervals)
    assert np.array_equal(meta.in_deg, ref_meta.in_deg)
    assert np.array_equal(meta.out_deg, ref_meta.out_deg)
    disk_meta = store.read_meta()
    assert np.array_equal(disk_meta.intervals, ref_meta.intervals)
    assert np.array_equal(disk_meta.in_deg, ref_meta.in_deg)
    for s in ref_shards:
        got = store.load_shard(s.shard_id, "csr")
        assert got.v0 == s.v0 and got.v1 == s.v1
        assert got.row.dtype == s.row.dtype and got.col.dtype == s.col.dtype
        assert np.array_equal(got.row, s.row)
        assert np.array_equal(got.col, s.col)


@_property(
    lambda seed: (_seeded_graph(seed), 1 + seed % 6, seed),
    n_examples=25,
    hyp_decorators=[
        settings(max_examples=25, deadline=None,
                 suppress_health_check=[HealthCheck.too_slow]),
        given(graphs(), st.integers(1, 6), st.integers(0, 10**6)),
    ] if HAVE_HYPOTHESIS else [],
)
def test_ingest_bitwise_matches_preprocess(g, p, salt):
    """Across chunk sizes (1, tiny, > |E|), spill cadences and formats."""
    cases = [
        (1, 64, "bin"),
        (7, 256, "text"),
        (g.num_edges + 5, 1 << 30, "bin"),
        (max(1, g.num_edges // 3), 512, "bin"),
    ]
    chunk, budget, fmt = cases[salt % len(cases)]
    with tempfile.TemporaryDirectory() as d:
        store, meta, stats = _ingest_into(
            d, g, fmt=fmt, chunk_edges=chunk, mem_budget_bytes=budget,
            num_shards=p)
        _assert_bitwise_equal(store, meta, g, num_shards=p)
        if chunk > g.num_edges:
            assert stats.runs == 0


@_property(
    lambda seed: (_seeded_graph(100 + seed), 4 + (seed * 13) % 60),
    n_examples=15,
    hyp_decorators=[
        settings(max_examples=15, deadline=None,
                 suppress_health_check=[HealthCheck.too_slow]),
        given(graphs(), st.integers(4, 64)),
    ] if HAVE_HYPOTHESIS else [],
)
def test_ingest_edges_per_shard_matches_preprocess(g, eps):
    with tempfile.TemporaryDirectory() as d:
        store, meta, _ = _ingest_into(
            d, g, fmt="bin", chunk_edges=11, mem_budget_bytes=128,
            edges_per_shard=eps)
        _assert_bitwise_equal(store, meta, g, edges_per_shard=eps)


def test_ingest_empty_graph_and_empty_shards():
    g = Graph(20, np.array([], np.int32), np.array([], np.int32))
    with tempfile.TemporaryDirectory() as d:
        store, meta, stats = _ingest_into(
            d, g, fmt="bin", chunk_edges=4, mem_budget_bytes=64, num_shards=2)
        _assert_bitwise_equal(store, meta, g, num_shards=2)
        assert stats.num_edges == 0 and stats.runs == 0
    g = star_graph(50)
    with tempfile.TemporaryDirectory() as d:
        store, meta, _ = _ingest_into(
            d, g, fmt="text", chunk_edges=3, mem_budget_bytes=64, num_shards=4)
        _assert_bitwise_equal(store, meta, g, num_shards=4)
    g = Graph(40, np.array([0, 1, 2, 3], np.int32),
              np.array([5, 5, 6, 0], np.int32))
    with tempfile.TemporaryDirectory() as d:
        store, meta, _ = _ingest_into(
            d, g, fmt="bin", chunk_edges=2, mem_budget_bytes=32, num_shards=4)
        _assert_bitwise_equal(store, meta, g, num_shards=4)


def test_ingest_infers_num_vertices():
    g = _seeded_graph(7)
    n_used = int(max(g.src.max(), g.dst.max())) + 1
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "e.bin")
        write_edge_file(path, g.src, g.dst)
        store = ShardStore(os.path.join(d, "store"))
        meta, _ = store.ingest(path, num_shards=3, chunk_edges=17,
                               mem_budget_bytes=256, window=64, k=8, tr=4)
        assert meta.num_vertices == n_used
        _assert_bitwise_equal(store, meta, Graph(n_used, g.src, g.dst),
                              num_shards=3)


def test_ingest_rejects_out_of_range_ids():
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "e.bin")
        write_edge_file(path, np.array([0, 5], np.int32), np.array([1, 2], np.int32))
        store = ShardStore(os.path.join(d, "store"))
        with pytest.raises(ValueError, match="out of range"):
            store.ingest(path, num_shards=2, num_vertices=4)


def test_invalid_arguments_fail_fast():
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "e.bin")
        with pytest.raises(ValueError, match="chunk_edges"):
            write_edge_file(path, np.array([0], np.int32),
                            np.array([1], np.int32), chunk_edges=0)
        write_edge_file(path, np.array([0], np.int32), np.array([1], np.int32))
        store = ShardStore(os.path.join(d, "store"))
        with pytest.raises(ValueError, match="exactly one"):
            store.ingest(path)
        with pytest.raises(ValueError, match="exactly one"):
            store.ingest(path, num_shards=2, edges_per_shard=10)


def test_ingest_removes_orphaned_spill_runs():
    g = _seeded_graph(21)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "e.bin")
        write_edge_file(path, g.src, g.dst)
        store = ShardStore(os.path.join(d, "store"))
        store.write_bytes("ingest_run_00007_00003.bin", b"\x00" * 64)
        meta, stats = store.ingest(path, num_shards=2,
                                   num_vertices=g.num_vertices,
                                   window=64, k=8, tr=4)
        assert stats.orphan_runs_removed == 1
        assert not store.exists("ingest_run_00007_00003.bin")
        _assert_bitwise_equal(store, meta, g, num_shards=2)


def test_text_format_comments_and_blank_lines():
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "e.txt")
        with open(path, "w") as f:
            f.write("# a SNAP-style header\n\n0 1\n1 2   # trailing comment\n\n2 0\n")
        chunks = list(iter_edge_chunks(path, chunk_edges=2))
        src = np.concatenate([c[0] for c in chunks])
        dst = np.concatenate([c[1] for c in chunks])
        assert src.tolist() == [0, 1, 2]
        assert dst.tolist() == [1, 2, 0]
        assert all(len(c[0]) <= 2 for c in chunks)


def test_kway_merge_is_sorted_union():
    rng = np.random.default_rng(0)
    runs = [np.sort(rng.integers(0, 1000, size=rng.integers(0, 50)))
            for _ in range(9)] + [np.empty(0, np.int64)]
    merged = kway_merge([r.astype(np.int64) for r in runs])
    ref = np.sort(np.concatenate(runs)).astype(np.int64)
    assert np.array_equal(merged, ref)
    assert len(kway_merge([])) == 0


# --------------------------------------------------------------------------
# I/O accounting
# --------------------------------------------------------------------------


def test_iostats_accounts_every_ingest_byte():
    g = rmat_graph(300, 5000, seed=9)
    with tempfile.TemporaryDirectory() as d:
        store, meta, stats = _ingest_into(
            d, g, fmt="bin", chunk_edges=64, mem_budget_bytes=1024, num_shards=5)
        assert stats.spills > 0 and stats.runs > 0
        assert stats.spill_bytes_written > 0
        assert stats.shard_bytes_written > 0
        assert stats.meta_bytes_written > 0
        assert store.io.bytes_written == (
            stats.spill_bytes_written + stats.shard_bytes_written
            + stats.meta_bytes_written)
        assert stats.spill_bytes_read == stats.spill_bytes_written
        assert store.io.bytes_read == stats.spill_bytes_read
        leftovers = [f for f in os.listdir(store.root) if f.startswith("ingest_run_")]
        assert leftovers == []
        assert stats.spill_bytes_written <= 8 * g.num_edges


def test_ingest_no_spill_when_budget_fits():
    g = rmat_graph(200, 1000, seed=10)
    with tempfile.TemporaryDirectory() as d:
        store, _, stats = _ingest_into(
            d, g, fmt="bin", chunk_edges=10**6, mem_budget_bytes=1 << 30,
            num_shards=3)
        assert stats.spill_bytes_written == 0 and stats.runs == 0
        assert store.io.bytes_written == (
            stats.shard_bytes_written + stats.meta_bytes_written)


# --------------------------------------------------------------------------
# Bounded memory
# --------------------------------------------------------------------------


_MEM_V = 50_000
_MEM_CHUNK = 20_000
_MEM_BUDGET = 512 << 10
_MEM_EPS = 60_000


def _traced_ingest_peak(num_e, seed):
    g = rmat_graph(_MEM_V, num_e, seed=seed)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "e.bin")
        write_edge_file(path, g.src, g.dst)
        store = ShardStore(os.path.join(d, "store"))
        del g
        gc.collect()
        tracemalloc.start()
        try:
            tracemalloc.reset_peak()
            meta, stats = store.ingest(
                path, edges_per_shard=_MEM_EPS, num_vertices=_MEM_V,
                chunk_edges=_MEM_CHUNK, mem_budget_bytes=_MEM_BUDGET,
                window=256, k=16, tr=8)
            peak = tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()
    assert meta.num_edges == num_e
    return peak, stats


def test_ingest_memory_bounded_as_edges_scale():
    """Peak traced allocation stays O(chunk + budget + one shard): flat as
    |E| scales 4x past the chunk/budget (the O(|E|) regression guard)."""
    small_e, big_e = 600_000, 2_400_000
    peak_small, stats_small = _traced_ingest_peak(small_e, seed=11)
    peak_big, stats_big = _traced_ingest_peak(big_e, seed=12)
    assert stats_small.spills > 1 and stats_big.spills > 4
    assert stats_big.runs > stats_small.runs
    for stats in (stats_small, stats_big):
        assert stats.peak_buffered_bytes <= _MEM_BUDGET + 8 * _MEM_CHUNK
    assert peak_big < 1.6 * peak_small, (
        f"peak grew with |E|: {peak_small} -> {peak_big} (x4 edges)")
    assert peak_big < (2 * 8 * big_e) / 2, (
        f"peak {peak_big} not meaningfully below O(|E|) materialization")


# --------------------------------------------------------------------------
# Overwrite invalidation
# --------------------------------------------------------------------------


def test_write_shard_overwrite_invalidates_registered_caches():
    g1 = rmat_graph(100, 600, seed=12)
    g2 = rmat_graph(100, 600, seed=13)
    _, shards1 = preprocess(g1, num_shards=2)
    _, shards2 = preprocess(g2, num_shards=2)
    with tempfile.TemporaryDirectory() as d:
        store = ShardStore(d)
        cache = ShardCache(1 << 20)
        seen = []
        store.register_invalidation(lambda p: (cache.invalidate(p), seen.append(p)))
        for s in shards1:
            store.write_shard(s, num_vertices=100, window=64, k=8, tr=4)
        assert seen == []
        cache.put(0, store.shard_bytes(0, "csr"))
        store.write_shard(shards2[0], num_vertices=100, window=64, k=8, tr=4)
        assert seen == [0]
        assert cache.get(0) is None
        fresh = store.load_shard(0, "csr")
        assert np.array_equal(fresh.col, shards2[0].col)


def test_pipeline_discards_bytes_read_before_concurrent_overwrite():
    """The read->invalidate->put race: a loader that read the OLD bytes
    just before an overwrite must not re-cache them afterwards.  The port
    keeps only device copies resident, so the CSR pipeline checks the
    byte cache."""
    from repro_torch.core.pipeline import ShardPipeline

    g1 = rmat_graph(100, 600, seed=19)
    g2 = rmat_graph(100, 600, seed=20)
    _, shards1 = preprocess(g1, num_shards=2)
    _, shards2 = preprocess(g2, num_shards=2)
    with tempfile.TemporaryDirectory() as d:
        store = ShardStore(d)
        for s in shards1:
            store.write_shard(s, num_vertices=100, window=64, k=8, tr=4)
        cache = ShardCache(1 << 20)
        store.register_invalidation(cache.invalidate)
        pipe = ShardPipeline(store, "csr", cache=cache, depth=0)
        orig_read = store.shard_bytes

        def read_then_lose_race(p, fmt="csr"):
            raw = orig_read(p, fmt)
            store.shard_bytes = orig_read
            store.write_shard(shards2[p], num_vertices=100, window=64, k=8, tr=4)
            return raw

        store.shard_bytes = read_then_lose_race
        ls = pipe.load(0)
        assert np.array_equal(ls.csr.col, shards1[0].col)
        cached = cache.get(0)
        if cached is not None:
            assert np.array_equal(ShardStore.decode_csr(0, cached).col,
                                  shards2[0].col)
        assert np.array_equal(pipe.load(0).csr.col, shards2[0].col)


def test_shard_cache_invalidate_releases_bytes():
    cache = ShardCache(1 << 16)
    cache.put(3, b"x" * 100)
    before = cache.stored_bytes
    assert cache.invalidate(3) is True
    assert cache.stored_bytes == before - 100
    assert cache.invalidate(3) is False
    assert len(cache) == 0


def test_reingest_into_existing_dir_e2e():
    g1 = rmat_graph(300, 3000, seed=14)
    g2 = rmat_graph(250, 1200, seed=15)
    with tempfile.TemporaryDirectory() as d:
        root = os.path.join(d, "store")
        p1, p2 = os.path.join(d, "g1.bin"), os.path.join(d, "g2.bin")
        write_edge_file(p1, g1.src, g1.dst)
        write_edge_file(p2, g2.src, g2.dst)
        store = ShardStore(root)
        meta1, _ = store.ingest(p1, num_shards=6, num_vertices=g1.num_vertices,
                                chunk_edges=128, mem_budget_bytes=2048,
                                window=64, k=8, tr=4)
        eng = VSWEngine(store, backend="numpy", cache_bytes=1 << 20,
                        selective=False, **CPU)
        eng.run(apps.pagerank(), max_iters=3)
        assert len(eng.cache) > 0
        meta2, stats = store.ingest(p2, num_shards=3,
                                    num_vertices=g2.num_vertices,
                                    chunk_edges=128, mem_budget_bytes=2048,
                                    window=64, k=8, tr=4)
        assert stats.stale_shards_removed == meta1.num_shards - meta2.num_shards
        for p in range(meta2.num_shards, meta1.num_shards):
            assert not store.exists(store.shard_name(p, "csr"))
            assert not store.exists(store.shard_name(p, "ell"))
        eng.close()
        eng2 = VSWEngine.from_store(root, backend="numpy", cache_bytes=1 << 20,
                                    selective=False, **CPU)
        got = eng2.run(apps.pagerank(), max_iters=5)
        ref_eng = VSWEngine.from_graph(g2, os.path.join(d, "ref"), num_shards=3,
                                       window=64, k=8, selective=False,
                                       backend="numpy", **CPU)
        ref = ref_eng.run(apps.pagerank(), max_iters=5)
        assert np.array_equal(got.values, ref.values)
        eng2.close()
        ref_eng.close()


def test_engine_collectable_without_close_e2e():
    import weakref

    g = rmat_graph(100, 600, seed=22)
    meta, shards = preprocess(g, num_shards=2)
    with tempfile.TemporaryDirectory() as d:
        store = ShardStore(d)
        store.write_meta(meta)
        for s in shards:
            store.write_shard(s, num_vertices=100, window=64, k=8, tr=4)
        eng = VSWEngine(store, backend="numpy", cache_bytes=1 << 16, **CPU)
        ref = weakref.ref(eng)
        del eng
        gc.collect()
        assert ref() is None
        assert store._invalidation_hooks == []


# --------------------------------------------------------------------------
# SessionCache across bump_graph_version
# --------------------------------------------------------------------------


def test_session_cache_stale_version_misses_e2e():
    from repro_torch.serve import GraphService

    g = rmat_graph(200, 1500, seed=16)
    with tempfile.TemporaryDirectory() as d:
        with GraphService.from_graph(g, d, num_shards=3, window=64, k=8,
                                     max_lanes=4, session_entries=32,
                                     backend="numpy", **CPU) as svc:
            r1 = svc.query("bfs", 5, max_iters=30)
            assert not r1.cached
            r2 = svc.query("bfs", 5, max_iters=30)
            assert r2.cached
            assert np.array_equal(r1.values, r2.values)
            misses_before = svc.sessions.misses
            svc.bump_graph_version()
            r3 = svc.query("bfs", 5, max_iters=30)
            assert not r3.cached
            assert svc.sessions.misses > misses_before
            assert np.array_equal(r3.values, r1.values)
            r4 = svc.query("bfs", 5, max_iters=30)
            assert r4.cached


def test_session_cache_version_keys_unit():
    from repro_torch.serve import SessionCache

    c = SessionCache(capacity=8)
    c.put(("bfs", 5, 0), "v0-result")
    assert c.get(("bfs", 5, 0)) == "v0-result"
    assert c.get(("bfs", 5, 1)) is None
    assert c.hits == 1 and c.misses == 1
    c.put(("bfs", 5, 1), "v1-result")
    assert c.get(("bfs", 5, 1)) == "v1-result"
    assert c.get(("bfs", 5, 1), lambda v: False) is None
    assert c.misses == 2


# --------------------------------------------------------------------------
# End-to-end: engines and the service boot from an ingested dir
# --------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["numpy", "torch", "cuda"])
def test_engine_from_ingested_store_matches_in_memory_e2e(backend):
    g = rmat_graph(200, 1500, seed=17)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "e.bin")
        write_edge_file(path, g.src, g.dst)
        mem = VSWEngine.from_graph(g, os.path.join(d, "mem"), num_shards=3,
                                   window=64, k=8, backend=backend, **CPU)
        ing = VSWEngine.from_edge_file(
            path, os.path.join(d, "ing"), num_shards=3,
            num_vertices=g.num_vertices, chunk_edges=100,
            mem_budget_bytes=1024, window=64, k=8, backend=backend, **CPU)
        for prog, iters in ((apps.pagerank(), 8), (apps.bfs(0), 30)):
            rm = mem.run(prog, max_iters=iters)
            rs = ing.run(prog, max_iters=iters)
            assert np.array_equal(rm.values, rs.values)
            assert rm.converged == rs.converged
        mem.close()
        ing.close()


def test_service_from_ingested_store_matches_in_memory_e2e():
    from repro_torch.serve import GraphService

    g = rmat_graph(250, 2000, seed=18)
    sources = [0, 7, 42]
    kw = dict(num_shards=4, window=64, k=8, max_lanes=4, session_entries=0,
              backend="cuda", **CPU)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "e.bin")
        write_edge_file(path, g.src, g.dst)
        with GraphService.from_graph(g, os.path.join(d, "mem"), **kw) as svc_mem:
            ref = {(prog, s): svc_mem.query(prog, s, max_iters=40).values
                   for prog in ("bfs", "ppr") for s in sources}
        with GraphService.from_edge_file(
                path, os.path.join(d, "ing"), num_vertices=g.num_vertices,
                chunk_edges=128, mem_budget_bytes=2048, **kw) as svc_ing:
            for (prog, s), want in ref.items():
                got = svc_ing.query(prog, s, max_iters=40).values
                assert np.array_equal(got, want), (prog, s)


def test_from_edge_file_defaults_to_the_card(tmp_path):
    """The ingest factories default to CUDA; without a card they raise
    before any ingest work."""
    import torch

    from repro_torch.serve import GraphService

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    path = str(tmp_path / "e.bin")
    write_edge_file(path, np.array([0, 1], np.int32), np.array([1, 0], np.int32))
    for factory in (VSWEngine.from_edge_file, GraphService.from_edge_file):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            factory(path, str(tmp_path / "s"), num_shards=1)
        assert not (tmp_path / "s" / "property.json").exists()


# --------------------------------------------------------------------------
# Across packages: the same edge file, the same store byte for byte
# --------------------------------------------------------------------------


def _files(root):
    return {f: open(os.path.join(root, f), "rb").read()
            for f in sorted(os.listdir(root))}


@pytest.mark.parametrize("fmt,budget,workers", [
    ("bin", 1 << 12, 1),      # spilling, one finalize worker
    ("bin", 1 << 12, 4),      # spilling, four workers
    ("text", 1 << 30, 1),     # no spill
    ("text", 1 << 13, 3),
    ("bin", 1 << 30, 4),
])
def test_ingest_store_byte_identical_across_packages(tmp_path, monkeypatch,
                                                     fmt, budget, workers):
    """The reference's ``ingest_edge_file`` and the port's give the same
    files byte for byte (npz members carry the write time, so the clock is
    pinned for both writers) and the same ``IngestStats``."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    g = rmat_graph(700, 9000, seed=31)
    ext = ".txt" if fmt == "text" else ".bin"
    edges = str(tmp_path / f"edges{ext}")
    assert write_edge_file(edges, g.src, g.dst) == ref_write_edge_file(
        str(tmp_path / f"ref{ext}"), g.src, g.dst)
    assert open(edges, "rb").read() == open(tmp_path / f"ref{ext}", "rb").read()
    kw = dict(num_shards=5, chunk_edges=777, mem_budget_bytes=budget,
              window=128, k=16, tr=8, finalize_workers=workers, warm_bytes=1 << 20)
    ref_store = RefStore(str(tmp_path / "ref"))
    pt_store = ShardStore(str(tmp_path / "pt"))
    ref_meta, ref_stats = ref_ingest_edge_file(ref_store, edges, **kw)
    meta, stats = ingest_edge_file(pt_store, edges, **kw)
    assert dataclasses.asdict(stats) == dataclasses.asdict(ref_stats)
    assert (stats.runs > 0) == (budget < 1 << 20)
    assert np.array_equal(meta.intervals, ref_meta.intervals)
    a, b = _files(tmp_path / "ref"), _files(tmp_path / "pt")
    assert list(a) == list(b) and len(a) == 2 + 2 * meta.num_shards
    for name in a:
        assert a[name] == b[name], name
    assert vars(pt_store.io) == vars(ref_store.io)
    for p in range(meta.num_shards):
        assert np.array_equal(pt_store.warm_sources(p), ref_store.warm_sources(p))
        for f in ("csr", "ell"):
            assert pt_store.warm_raw(p, f) == ref_store.warm_raw(p, f)


@pytest.mark.parametrize("writer", ["ref", "pt"])
def test_ingested_store_serves_in_the_other_package(tmp_path, writer):
    """A store either package ingested boots an engine in the other, and
    both packages' numpy engines give the same values and bytes read."""
    g = rmat_graph(500, 6000, seed=32)
    edges = str(tmp_path / "e.bin")
    write_edge_file(edges, g.src, g.dst)
    root = str(tmp_path / "s")
    store = RefStore(root) if writer == "ref" else ShardStore(root)
    store.ingest(edges, num_shards=4, chunk_edges=1000, mem_budget_bytes=4096,
                 window=128, k=16, tr=8)
    kw = dict(backend="numpy", selective=False)
    pt = VSWEngine.from_store(root, **CPU, **kw)
    ref = RefEngine.from_store(root, **kw)
    for prog, ref_prog in ((apps.pagerank(), ref_apps.pagerank()),
                           (apps.bfs(3), ref_apps.bfs(3))):
        r1, r2 = pt.run(prog, max_iters=6), ref.run(ref_prog, max_iters=6)
        assert np.array_equal(r1.values, r2.values)
        assert r1.total_bytes_read == r2.total_bytes_read
    pt.close()
    ref.close()

