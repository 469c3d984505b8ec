"""Storage tier of the port against the reference: the same files byte for
byte, and stores open across packages — stores carrying live-mutation
files, and the streamed ingest, included."""

import os
import shutil
import time

import numpy as np
import pytest

from repro.core import apps as ref_apps
from repro.core.graph import rmat_graph
from repro.core.sharding import preprocess
from repro.core.storage import ShardStore as RefStore
from repro.core.vsw import VSWEngine as RefEngine
from repro_torch.core import apps
from repro_torch.core.storage import IOStats, ShardStore
from repro_torch.core.vsw import VSWEngine

PARAMS = dict(window=128, k=16, tr=8)


def _write(store_cls, root, graph, num_shards=4):
    meta, shards = preprocess(graph, num_shards=num_shards)
    store = store_cls(str(root))
    store.write_meta(meta)
    for s in shards:
        store.write_shard(s, num_vertices=meta.num_vertices, **PARAMS)
    return store


def _files(root):
    return {f: open(os.path.join(root, f), "rb").read()
            for f in sorted(os.listdir(root))}


def test_store_files_byte_identical(tmp_path, monkeypatch):
    """Same graph, same clock -> the same bytes in every file (npz members
    carry the write time, so the clock is pinned for both writers)."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    g = rmat_graph(800, 9000, seed=4)
    _write(RefStore, tmp_path / "ref", g)
    _write(ShardStore, tmp_path / "pt", g)
    a, b = _files(tmp_path / "ref"), _files(tmp_path / "pt")
    assert list(a) == list(b) and len(a) == 2 + 2 * 4
    for name in a:
        assert a[name] == b[name], name


@pytest.mark.parametrize("writer", ["ref", "pt"])
def test_store_opens_in_other_package(tmp_path, writer):
    g = rmat_graph(600, 7000, seed=8)
    root = tmp_path / "s"
    _write(RefStore if writer == "ref" else ShardStore, root, g)
    reader = ShardStore(str(root)) if writer == "ref" else RefStore(str(root))
    other = RefStore(str(root)) if writer == "ref" else ShardStore(str(root))
    ma, mb = reader.read_meta(), other.read_meta()
    assert ma.num_vertices == mb.num_vertices and ma.num_edges == mb.num_edges
    assert np.array_equal(ma.intervals, mb.intervals)
    assert (reader if writer == "pt" else other).ell_params() == PARAMS
    for p in range(ma.num_shards):
        for fmt in ("csr", "ell"):
            x, y = reader.load_shard(p, fmt), other.load_shard(p, fmt)
            for f in ("row", "col") if fmt == "csr" else (
                    "ell_idx", "ell_mask", "seg", "tile_window"):
                assert np.array_equal(getattr(x, f), getattr(y, f)), (p, f)
    # and an engine boots on it with the oracle backend, matching the other
    kw = dict(backend="numpy", selective=False)
    pt = VSWEngine.from_store(str(root), device="cpu", **kw)
    ref = RefEngine.from_store(str(root), **kw)
    r1 = pt.run(apps.pagerank(), max_iters=4)
    r2 = ref.run(ref_apps.pagerank(), max_iters=4)
    assert np.array_equal(r1.values, r2.values)
    assert r1.total_bytes_read == r2.total_bytes_read
    pt.close()
    ref.close()


@pytest.mark.parametrize("artifact", ["delta_run_00001.npz",
                                      "delta_journal_00001.json",
                                      "delta_manifest.json", "delta_stage/"])
def test_store_with_delta_files_refuses_to_open(tmp_path, artifact):
    """A store carrying live-mutation files used to be refused; since the
    delta port it opens with its overlay attached and recovered, exactly as
    the reference opens it, and serves the base graph (none of these files
    is a committed publish)."""
    g = rmat_graph(300, 2000, seed=1)
    root = tmp_path / "s"
    _write(ShardStore, root, g, num_shards=2)
    if artifact.endswith("/"):
        os.makedirs(root / artifact)
    else:
        (root / artifact).write_bytes(b"{}")
    shutil.copytree(root, tmp_path / "r")
    store = ShardStore(str(root))
    assert store.delta is not None and store.delta.version == 0
    assert store.delta.dirty_shards() == []
    ref = RefStore(str(tmp_path / "r"))
    assert ref.delta is not None and ref.delta.version == 0
    assert vars(store.delta.last_recovery) == vars(ref.delta.last_recovery)
    assert sorted(os.listdir(root)) == sorted(os.listdir(tmp_path / "r"))
    kw = dict(backend="numpy", selective=False)
    with VSWEngine.from_store(str(root), device="cpu", **kw) as pt:
        r1 = pt.run(apps.pagerank(), max_iters=3)
    r2 = RefEngine.from_store(str(root), **kw).run(ref_apps.pagerank(),
                                                   max_iters=3)
    assert np.array_equal(r1.values, r2.values)


def test_ingest_not_ported_yet(tmp_path):
    """``ShardStore.ingest`` used to raise; since the ingest port it builds
    the store from an edge file, the shards those of ``preprocess``."""
    from repro_torch.core.ingest import write_edge_file

    g = rmat_graph(300, 2000, seed=2)
    path = str(tmp_path / "edges.bin")
    write_edge_file(path, g.src, g.dst)
    store = ShardStore(str(tmp_path / "s"))
    meta, stats = store.ingest(path, num_shards=2, **PARAMS)
    assert stats.num_edges == g.num_edges and meta.num_shards == 2
    ref_meta, ref_shards = preprocess(g, num_shards=2)
    assert np.array_equal(meta.intervals, ref_meta.intervals)
    for s in ref_shards:
        got = store.load_shard(s.shard_id, "csr")
        assert np.array_equal(got.row, s.row) and np.array_equal(got.col, s.col)
    assert store.ell_params() == PARAMS


def test_io_accounting_and_throttle(tmp_path):
    store = ShardStore(str(tmp_path / "s"), emulate_bw=2e6)
    t0 = time.monotonic()
    store.write_bytes("blob.bin", b"x" * 20_000)
    raw = store.read_bytes("blob.bin")
    assert raw == b"x" * 20_000
    assert time.monotonic() - t0 >= 0.015  # 40 kB over a 2 MB/s channel
    snap = store.io.snapshot()
    assert (snap.bytes_read, snap.bytes_written, snap.reads, snap.writes) == (
        20_000, 20_000, 1, 1)
    assert (store.io - IOStats(10, 0, 1, 0)).bytes_read == 19_990
    bulk = store.shard_bytes_bulk([], "csr")
    assert bulk == {}


def test_overwrite_fires_invalidation_hooks(tmp_path):
    g = rmat_graph(300, 2000, seed=1)
    store = _write(ShardStore, tmp_path / "s", g, num_shards=2)
    seen = []
    store.register_invalidation(seen.append)
    meta, shards = preprocess(g, num_shards=2)
    gen0 = store.shard_generation(1)
    store.write_shard(shards[1], num_vertices=meta.num_vertices, **PARAMS)
    assert seen == [1] and store.shard_generation(1) == gen0 + 1
    store.unregister_invalidation(seen.append)
    store.write_shard(shards[0], num_vertices=meta.num_vertices, **PARAMS)
    assert seen == [1]
