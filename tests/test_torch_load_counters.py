"""The clocks and counts of the semi-external path (``IterStats.read_s``,
``decode_s``, ``cache_bytes``, ``to_device_bytes``) and the span
``shard.read``, on the CPU: each is a part of what it splits, the bytes
add up to the shards' containers and device planes, and a resident
iteration reads as 0."""

import numpy as np
import pytest

from repro_torch.core import apps
from repro_torch.core.csr import ell_to_device
from repro_torch.core.graph import rmat_graph
from repro_torch.core.storage import ShardStore
from repro_torch.core.vsw import VSWEngine
from repro_torch.delta import EdgeLog
from repro_torch.obs import trace

FIELDS = ("read_s", "decode_s", "cache_bytes", "to_device_bytes")


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("counters") / "store"
    g = rmat_graph(3000, 40000, seed=37)
    VSWEngine.from_graph(g, str(root), backend="numpy", device="cpu",
                         num_shards=8, window=256, k=16).close()
    return str(root)


def _engine(store, **kw):
    return VSWEngine.from_store(store, backend="cuda", device="cpu",
                                batch_shards=2, **kw)


def _copied(host):
    """Bytes of the device planes of a host ELL shard: ``idx``, ``mask``,
    ``tile_window`` as the DeviceEll holds them, and ``seg``, which
    ``ell_to_device`` copies to build the combine order."""
    dev = ell_to_device(host, "cpu")
    return (dev.idx.nbytes + dev.mask.nbytes + dev.tile_window.nbytes
            + 4 * dev.n_ell)


def _planes(store, p):
    return _copied(store.decode_ell(p, store.shard_bytes(p, "ell")))


@pytest.mark.parametrize("cache", [{}, {"cache_bytes": 60_000},
                                   {"cache_bytes": 60_000,
                                    "cache_policy": "keep"}],
                         ids=["no-cache", "lru", "keep"])
@pytest.mark.parametrize("depth", [0, 2])
def test_loads_split_into_read_and_decode_and_their_bytes_add_up(
        store, cache, depth):
    with _engine(store, prefetch_depth=depth, **cache) as eng:
        s = eng.store
        n = eng.meta.num_shards
        container = sum(s.file_size(s.shard_name(p, "ell")) for p in range(n))
        planes = sum(_planes(s, p) for p in range(n))
        r = eng.run(apps.pagerank(), max_iters=4)
    for i in r.iterations:
        assert i.shards_processed == n and i.shards_skipped == 0
        assert 0 < i.read_s and 0 < i.decode_s
        assert i.read_s + i.decode_s <= i.load_total_s
        assert i.bytes_read + i.cache_bytes == container
        assert i.to_device_bytes == planes
        assert (i.cache_bytes > 0) == (i.cache_hits > 0)
        if cache.get("cache_policy") == "keep":
            assert i.cache_hits > 0


def test_a_resident_iteration_reads_nothing(store):
    with _engine(store, device_resident=True, cache_bytes=1 << 20) as eng:
        r = eng.run(apps.pagerank(), max_iters=4)
    first, *rest = r.iterations
    assert first.to_device_bytes > 0 and first.decode_s > 0
    for i in rest:
        assert all(getattr(i, f) == 0 for f in FIELDS), i
        assert i.bytes_read == 0


def test_a_logical_load_counts_only_its_copy_to_the_device(tmp_path):
    """A shard with a pending delta is decoded through the overlay: its
    read, decode and cache hit count in none of the clocks and bytes, its
    copy to the device in ``to_device_bytes``."""
    root = str(tmp_path / "store")
    g = rmat_graph(3000, 40000, seed=37)
    VSWEngine.from_graph(g, root, backend="numpy", device="cpu",
                         num_shards=8, window=256, k=16).close()
    store = ShardStore(root)
    hub = int(np.argmax(g.in_degrees()))
    log = EdgeLog(store)
    log.append(inserts=(np.arange(50), np.full(50, hub)))
    dirty = sorted(log.publish().shards_touched)
    n = store.read_meta().num_shards
    assert dirty and len(dirty) < n
    clean = [p for p in range(n) if p not in dirty]
    logical = {p: _copied(store.delta.load_logical(p, "ell")[0])
               for p in dirty}
    with VSWEngine(store, backend="cuda", device="cpu", batch_shards=2,
                   cache_bytes=1 << 24, cache_policy="keep") as eng:
        for p in dirty:
            ls = eng.pipeline.load(p)
            assert ls.logical and ls.to_device_bytes == logical[p]
            assert ls.read_s == ls.decode_s == ls.cache_bytes == 0
        r = eng.run(apps.pagerank(), max_iters=3)
    container = sum(store.file_size(store.shard_name(p, "ell"))
                    for p in clean)
    planes = sum(_planes(store, p) for p in clean) + sum(logical.values())
    for i in r.iterations:
        assert i.shards_processed == n and i.cache_hits == n
        assert i.bytes_read == 0 and i.cache_bytes == container
        assert i.to_device_bytes == planes


def test_spans_carry_the_bytes_read_and_copied(store):
    tracer = trace.Tracer()
    with _engine(store, cache_bytes=60_000, cache_policy="keep") as eng:
        with trace.tracing(tracer):
            r = eng.run(apps.pagerank(), max_iters=3)
        s = eng.store
        sizes = {s.file_size(s.shard_name(p, "ell"))
                 for p in range(eng.meta.num_shards)}
    events = [e for e in tracer.export_chrome()["traceEvents"]
              if e["ph"] == "X"]
    reads = [e for e in events if e["name"] == "shard.read"]
    assert reads and all(e["args"]["bytes"] in sizes for e in reads)
    assert sum(e["args"]["bytes"] for e in reads) == \
        sum(i.bytes_read for i in r.iterations)
    iters = sorted((e for e in events if e["name"] == "vsw.iter"),
                   key=lambda e: e["args"]["iteration"])
    assert [e["args"]["cache_bytes"] for e in iters] == \
        [i.cache_bytes for i in r.iterations]
    assert [e["args"]["to_device_bytes"] for e in iters] == \
        [i.to_device_bytes for i in r.iterations]
    assert np.all(np.isfinite(r.values))
