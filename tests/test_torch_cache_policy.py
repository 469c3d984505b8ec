"""The edge cache's admission policies (``repro_torch.core.cache``): LRU,
the reference's, never hits on a scan in plan order that is larger than
itself; ``keep``, the paper's fixed subset, hits on the share it holds.
Neither changes a value the engine computes."""

import numpy as np
import pytest

from repro_torch.core import apps
from repro_torch.core.cache import ShardCache
from repro_torch.core.graph import rmat_graph
from repro_torch.core.vsw import VSWEngine

SHARDS = 16
SIZE = 1000


def _scan(cache, sweeps):
    """Hits per sweep of shards ``0..SHARDS-1`` in order, each miss put
    back as the pipeline does."""
    hits = []
    for _ in range(sweeps):
        h0 = cache.stats.hits
        for p in range(SHARDS):
            if cache.get(p) is None:
                cache.put(p, bytes([p]) * SIZE)
        hits.append(cache.stats.hits - h0)
    return hits


@pytest.mark.parametrize("mode", [1, 2])
def test_a_plan_order_scan_hits_under_keep_and_never_under_lru(mode):
    # room for 4 of the 16 shards (compressed or not: mode 2 stores
    # each shard in far fewer bytes, so give it the room of 4 blobs)
    blob = len(ShardCache(1, mode).mode.compress(bytes(SIZE)))
    keep = ShardCache(4 * blob, mode, policy="keep")
    lru = ShardCache(4 * blob, mode)
    assert _scan(keep, 4) == [0, 4, 4, 4]
    assert keep.keys() == [0, 1, 2, 3] and keep.stats.evictions == 0
    assert _scan(lru, 4) == [0, 0, 0, 0]
    assert len(lru) == 4 and lru.stats.evictions == 4 * SHARDS - 4
    assert keep.stats.misses == 4 * SHARDS - 12


def test_invalidate_frees_room_the_next_miss_fills():
    cache = ShardCache(4 * SIZE, policy="keep")
    _scan(cache, 1)
    assert cache.keys() == [0, 1, 2, 3]
    assert not cache.put(9, bytes(SIZE))  # full: admits nothing
    assert cache.invalidate(2) and cache.stored_bytes == 3 * SIZE
    assert cache.stats.evictions == 0
    assert cache.put(9, bytes(SIZE))
    assert cache.keys() == [0, 1, 3, 9] and cache.stored_bytes == 4 * SIZE
    assert not cache.put(10, bytes(SIZE))
    cache.clear()
    assert cache.put(10, bytes(SIZE)) and cache.keys() == [10]


def test_an_unknown_policy_is_refused():
    with pytest.raises(ValueError, match="policy"):
        ShardCache(1 << 20, policy="mru")


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("policy") / "store"
    g = rmat_graph(3000, 40000, seed=31)
    VSWEngine.from_graph(g, str(root), backend="numpy", device="cpu",
                         num_shards=8, window=256, k=16).close()
    return str(root)


def _run(store, **cache):
    with VSWEngine.from_store(store, backend="torch", device="cpu",
                              batch_shards=2, **cache) as eng:
        ell = sum(eng.store.file_size(eng.store.shard_name(p, "ell"))
                  for p in range(eng.meta.num_shards))
        return eng.run(apps.pagerank(), max_iters=6), ell


def test_values_are_bitwise_the_same_with_no_cache_lru_and_keep(store):
    plain, ell = _run(store)
    room = ell // 3  # the cache holds about a third of the store
    lru, _ = _run(store, cache_bytes=room)
    keep, _ = _run(store, cache_bytes=room, cache_policy="keep")
    for r in (lru, keep):
        assert np.array_equal(r.values, plain.values)
        assert r.num_iterations == plain.num_iterations == 6
    # the cache was warmed when the engine opened; the scan in plan order
    # evicts every shard under LRU before it comes back to it
    assert all(i.cache_hits == 0 and i.cache_bytes == 0 for i in lru.iterations)
    hits = {(i.cache_hits, i.cache_bytes) for i in keep.iterations}
    assert len(hits) == 1
    (n_hits, served), = hits
    assert 0 < n_hits < 8 and 0 < served <= room
    for r in (plain, lru, keep):
        assert all(i.bytes_read + i.cache_bytes == ell for i in r.iterations)
