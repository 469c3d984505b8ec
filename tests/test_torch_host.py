"""Host modules of the port against the reference package: the same numpy
inputs from a seed give array-equal outputs (generators, sharding, ELL
conversion, programs, Bloom filters, the shard cache)."""

import dataclasses

import numpy as np
import pytest

import repro.core.apps as ref_apps
import repro.core.bloom as ref_bloom
import repro.core.cache as ref_cache
import repro.core.csr as ref_csr
import repro.core.graph as ref_graph
import repro.core.sharding as ref_sharding
import repro_torch.core.apps as pt_apps
import repro_torch.core.bloom as pt_bloom
import repro_torch.core.cache as pt_cache
import repro_torch.core.csr as pt_csr
import repro_torch.core.graph as pt_graph
import repro_torch.core.sharding as pt_sharding


def _assert_same_fields(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("gen,args,kw", [
    ("rmat_graph", (3000, 40000), {"seed": 5}),
    ("rmat_graph", (1000, 9000), {"seed": 6, "dedup": True}),
    ("uniform_graph", (700, 5000), {"seed": 7}),
    ("chain_graph", (257,), {}),
    ("star_graph", (1000,), {}),
    ("small_world_graph", (600,), {"seed": 8}),
])
def test_generators_same_edges(gen, args, kw):
    a = getattr(ref_graph, gen)(*args, **kw)
    b = getattr(pt_graph, gen)(*args, **kw)
    _assert_same_fields(a, b)


def test_from_edge_list_and_graph_methods():
    edges = [(0, 1), (2, 1), (1, 3), (3, 0), (2, 1)]
    a = ref_graph.from_edge_list(edges, num_vertices=5)
    b = pt_graph.from_edge_list(edges, num_vertices=5)
    _assert_same_fields(a, b)
    _assert_same_fields(a.dedup(), b.dedup())
    _assert_same_fields(a.reverse(), b.reverse())
    assert np.array_equal(a.in_degrees(), b.in_degrees())
    assert np.array_equal(a.out_degrees(), b.out_degrees())
    with pytest.raises(ValueError):
        pt_graph.from_edge_list([(0, 9)], num_vertices=3)


@pytest.mark.parametrize("kw", [{"num_shards": 1}, {"num_shards": 7},
                                {"edges_per_shard": 3000}])
def test_preprocess_same_shards(kw):
    g = ref_graph.rmat_graph(2000, 25000, seed=9)
    meta_a, shards_a = ref_sharding.preprocess(g, **kw)
    meta_b, shards_b = pt_sharding.preprocess(
        pt_graph.Graph(g.num_vertices, g.src, g.dst), **kw)
    _assert_same_fields(meta_a, meta_b)
    assert len(shards_a) == len(shards_b)
    for a, b in zip(shards_a, shards_b):
        _assert_same_fields(a, b)


@pytest.mark.parametrize("window,k,tr", [(256, 8, 8), (512, 32, 8),
                                         (1024, 128, 8), (1 << 16, 16, 4)])
def test_csr_to_ell_same_arrays(window, k, tr):
    g = ref_graph.rmat_graph(1500, 20000, seed=42)
    _, shards = ref_sharding.preprocess(g, num_shards=3)
    for s in shards:
        a = ref_csr.csr_to_ell(s, g.num_vertices, window=window, k=k, tr=tr)
        b = pt_csr.csr_to_ell(s, g.num_vertices, window=window, k=k, tr=tr)
        _assert_same_fields(a, b)
        assert a.padding_ratio() == b.padding_ratio()
        assert np.array_equal(a.global_idx(), b.global_idx())


def test_concat_pad_bucket_same():
    """The host batch concatenation gives the reference's arrays (the port
    drops the reference's pow2 row bucketing and padding, which exist only
    to bound jit retraces)."""
    g = ref_graph.rmat_graph(900, 9000, seed=3)
    _, shards = ref_sharding.preprocess(g, num_shards=4)
    ea = [ref_csr.csr_to_ell(s, g.num_vertices, window=128, k=16, tr=8)
          for s in shards]
    eb = [pt_csr.csr_to_ell(s, g.num_vertices, window=128, k=16, tr=8)
          for s in shards]
    ba, bb = ref_csr.concat_ells(ea), pt_csr.concat_ells(eb)
    _assert_same_fields(ba, bb)
    for x, y in zip(ref_csr.concat_ells(ea).split(np.arange(ba.rows_total)),
                    bb.split(np.arange(bb.rows_total))):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("name,kw", [
    ("pagerank", {}), ("sssp", {"source": 3}), ("wcc", {}), ("bfs", {"source": 1}),
    ("ppr", {"source": 5}), ("degree", {}),
])
def test_programs_same_algebra(name, kw):
    g = ref_graph.rmat_graph(300, 3000, seed=2)
    meta, _ = ref_sharding.preprocess(g, num_shards=2)
    pa, pb = ref_apps.get_program(name, **kw), pt_apps.get_program(name, **kw)
    assert (pa.name, pa.combine, pa.identity) == (pb.name, pb.combine, pb.identity)
    va, aa = pa.init(meta)
    vb, ab = pb.init(meta)
    assert np.array_equal(va, vb) and np.array_equal(aa, ab)
    rng = np.random.default_rng(0)
    vals = rng.random(meta.num_vertices).astype(np.float32)
    ma, mb = pa.pre(vals, meta.out_deg), pb.pre(vals, meta.out_deg)
    assert np.array_equal(ma, mb)
    acc = rng.random(100).astype(np.float32)
    old = rng.random(100).astype(np.float32)
    assert np.array_equal(pa.apply(acc, old, meta, 0), pb.apply(acc, old, meta, 0))
    assert np.array_equal(pa.is_active(acc, old), pb.is_active(acc, old))


def test_bloom_filters_bit_identical():
    rng = np.random.default_rng(11)
    items = rng.choice(1 << 20, 3000, replace=False)
    queries = rng.integers(0, 1 << 20, 5000)
    for cls in ("BloomFilter", "BloomFilter32"):
        a = getattr(ref_bloom, cls).build(items, num_hashes=4)
        b = getattr(pt_bloom, cls).build(items, num_hashes=4)
        _assert_same_fields(a, b)
        assert np.array_equal(a.contains(queries), b.contains(queries))
        assert b.any_member(items[:3]) and not b.any_member(np.array([], np.int64))
    assert pt_bloom.optimal_num_bits(1000) == ref_bloom.optimal_num_bits(1000)


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_cache_modes_and_lru_same(mode):
    blobs = {p: bytes(np.random.default_rng(p).integers(0, 4, 3000, np.uint8))
             for p in range(6)}
    a, b = ref_cache.ShardCache(8000, mode), pt_cache.ShardCache(8000, mode)
    for p in (0, 1, 2, 0, 3, 4, 1, 5):
        for c in (a, b):
            if c.get(p) is None:
                c.put(p, blobs[p])
    assert a.keys() == b.keys()
    assert (a.stats.hits, a.stats.misses, a.stats.evictions) == (
        b.stats.hits, b.stats.misses, b.stats.evictions)
    for p in b.keys():
        assert b.get(p) == blobs[p]
    sample = bytes(np.arange(20000, dtype=np.uint8) % 7)
    assert pt_cache.select_cache_mode(sample, 1 << 30, 1 << 20) == 1
    assert pt_cache.mode_iteration_cost(2.0, 1e-9, 1e-9, 100, 1000) == \
        ref_cache.mode_iteration_cost(2.0, 1e-9, 1e-9, 100, 1000)
