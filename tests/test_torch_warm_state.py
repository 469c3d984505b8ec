"""Warm-restart checkpoints of the port, across packages.

The reference's warm-state tests re-pointed at the port (``device="cpu"``):
a warm boot is a pure TIME optimisation — the store on disk is always
authoritative, and every query a warm-booted service answers is bitwise
what a cold-booted one returns.  The snapshot may be stale, partially
stale, corrupt, or describe a different store; the worst legal outcome is
a cold boot.  Across packages: the same service history gives the same
checkpoint byte for byte, and a checkpoint either package saved restores
in the other.
"""

import os
import time

import numpy as np
import pytest

from repro.serve import GraphService as RefService
from repro_torch.checkpoint.warm_state import (
    WarmStateCheckpointer,
    apply_warm_state,
    capture_warm_state,
)
from repro_torch.core.graph import rmat_graph
from repro_torch.core.storage import ShardStore
from repro_torch.serve import GraphService

N, M, SHARDS = 400, 5000, 4
CPU = dict(device="cpu", backend="numpy")


def _mk_service(tmp_path, tag, g=None, **kw):
    g = g if g is not None else rmat_graph(N, M, seed=9)
    kw.setdefault("num_shards", SHARDS)
    kw.setdefault("window", 128)
    kw.setdefault("k", 16)
    return GraphService.from_graph(g, str(tmp_path / tag), **CPU, **kw)


def _boot(root, **kw):
    return GraphService.from_store(root, **CPU, **kw)


# ------------------------------------------------------------ checkpointer
def test_checkpointer_roundtrip_retention_and_integrity(tmp_path):
    svc = _mk_service(tmp_path, "ck", cache_bytes=1 << 20)
    svc.query("bfs", 3)
    ws = capture_warm_state(svc)
    ck = WarmStateCheckpointer(str(tmp_path / "warm"), keep=2)
    for _ in range(3):
        ck.save(ws)
    assert ck.steps() == [1, 2]
    got = ck.restore()
    assert got.store_version == ws.store_version
    assert got.graph_version == ws.graph_version
    assert np.array_equal(got.intervals, ws.intervals)
    assert got.floors == ws.floors
    assert got.shard_sizes == ws.shard_sizes
    assert got.cache_shards == ws.cache_shards
    assert set(got.bloom_sources) == set(ws.bloom_sources)
    for p in ws.bloom_sources:
        assert np.array_equal(got.bloom_sources[p], ws.bloom_sources[p])
    assert len(got.sessions) == len(ws.sessions)
    for a, b in zip(got.sessions, ws.sessions):
        assert (a.program, a.key, a.source) == (b.program, b.key, b.source)
        assert np.array_equal(a.values, b.values)
    svc.close()
    step_dir = ck._dir(2)
    with open(os.path.join(step_dir, "state.npz"), "r+b") as f:
        f.seek(10)
        byte = f.read(1)
        f.seek(10)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(IOError, match="corrupt"):
        ck.restore(2)


def test_restore_empty_directory_raises(tmp_path):
    ck = WarmStateCheckpointer(str(tmp_path / "none"))
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore()


# -------------------------------------------------------------- warm boot
def test_warm_boot_skips_reads_and_is_bitwise_cold(tmp_path):
    g = rmat_graph(N, M, seed=9)
    svc = _mk_service(tmp_path, "wb", g, cache_bytes=1 << 20)
    root = svc.engine.store.root
    svc.apply_updates(inserts=(np.array([1, 2]), np.array([3, 4]))).result()
    r_bfs = svc.query("bfs", 5)
    ckdir = svc.save_warm_state(str(tmp_path / "warm"))
    svc.close()

    warm = _boot(root, warm_state=str(tmp_path / "warm"), cache_bytes=1 << 20)
    rep = warm.warm_restore_report
    assert rep["valid"] and rep["shards_warm"] == SHARDS
    assert rep["sessions_valid"] and rep["sessions_restored"] >= 1
    assert warm.engine.loading_io.reads == 0
    assert warm.engine.loading_io.bytes_read == 0
    assert os.path.basename(ckdir).startswith("warm_")
    cold = _boot(root, cache_bytes=1 << 20)
    assert cold.engine.loading_io.reads > 0
    hit = warm.query("bfs", 5)
    assert hit.cached
    assert np.array_equal(hit.values, r_bfs.values)
    for prog, src in (("bfs", 17), ("sssp", 23), ("ppr", 3)):
        a = warm.query(prog, src)
        b = cold.query(prog, src)
        assert np.array_equal(a.values, b.values), (prog, src)
    warm.close()
    cold.close()


def test_warm_boot_accepts_warmstate_object_and_prewarms_cache(tmp_path):
    svc = _mk_service(tmp_path, "obj", cache_bytes=1 << 20)
    root = svc.engine.store.root
    svc.query("bfs", 1)
    ws = capture_warm_state(svc)
    assert ws.cache_shards
    svc.close()
    warm = _boot(root, warm_state=ws, cache_bytes=1 << 20, prewarm_cache=True)
    rep = warm.warm_restore_report
    assert rep["cache_prewarmed"] == len(ws.cache_shards)
    assert set(warm.engine.cache.keys()) == set(ws.cache_shards)
    warm.close()


# ------------------------------------------------------------- staleness
def test_publish_after_snapshot_invalidates_touched_shards_only(tmp_path):
    svc = _mk_service(tmp_path, "stale", cache_bytes=1 << 20)
    root = svc.engine.store.root
    svc.query("bfs", 2)
    svc.save_warm_state(str(tmp_path / "warm"))
    svc.apply_updates(inserts=(np.array([0]), np.array([1]))).result()
    svc.close()
    warm = _boot(root, warm_state=str(tmp_path / "warm"))
    rep = warm.warm_restore_report
    assert rep["valid"]
    assert rep["shards_stale"] >= 1
    assert rep["shards_warm"] == SHARDS - rep["shards_stale"]
    assert not rep["sessions_valid"]
    assert rep["sessions_restored"] == 0
    cold = _boot(root)
    a = warm.query("bfs", 2)
    b = cold.query("bfs", 2)
    assert not a.cached
    assert np.array_equal(a.values, b.values)
    warm.close()
    cold.close()


def test_compaction_after_snapshot_keeps_sources_valid(tmp_path):
    svc = _mk_service(tmp_path, "comp", cache_bytes=1 << 20)
    root = svc.engine.store.root
    svc.apply_updates(inserts=(np.array([5, 6]), np.array([7, 8]))).result()
    r = svc.query("bfs", 5)
    svc.save_warm_state(str(tmp_path / "warm"))
    svc.compact()
    svc.close()
    warm = _boot(root, warm_state=str(tmp_path / "warm"))
    rep = warm.warm_restore_report
    assert rep["valid"] and rep["shards_stale"] == 0
    assert rep["sessions_valid"]
    hit = warm.query("bfs", 5)
    assert hit.cached and np.array_equal(hit.values, r.values)
    warm.close()


def test_reingested_store_rejects_snapshot_entirely(tmp_path):
    from repro_torch.core.sharding import preprocess

    g1 = rmat_graph(N, M, seed=9)
    g2 = rmat_graph(N, M, seed=10)
    svc = _mk_service(tmp_path, "re", g1, cache_bytes=1 << 20)
    root = svc.engine.store.root
    svc.save_warm_state(str(tmp_path / "warm"))
    svc.close()
    meta, shards = preprocess(g2, num_shards=SHARDS)
    store = ShardStore(root)
    store.write_meta(meta, ell_params=store.ell_params())
    for s in shards:
        ep = store.ell_params()
        store.write_shard(s, num_vertices=meta.num_vertices,
                          window=ep["window"], k=ep["k"], tr=ep["tr"])
    ws = WarmStateCheckpointer(str(tmp_path / "warm")).restore()
    rep = apply_warm_state(store, ws)
    assert not rep["valid"]
    assert rep["shards_warm"] == 0
    warm = _boot(root, warm_state=ws)
    assert not warm.warm_restore_report["valid"]
    cold = _boot(root)
    assert np.array_equal(warm.query("bfs", 4).values, cold.query("bfs", 4).values)
    warm.close()
    cold.close()


def test_wiped_delta_history_rejects_snapshot(tmp_path):
    svc = _mk_service(tmp_path, "wipe", cache_bytes=1 << 20)
    root = svc.engine.store.root
    svc.apply_updates(inserts=(np.array([1]), np.array([2]))).result()
    svc.compact()
    svc.save_warm_state(str(tmp_path / "warm"))
    svc.close()
    os.remove(os.path.join(root, "delta_manifest.json"))
    store = ShardStore(root)
    ws = WarmStateCheckpointer(str(tmp_path / "warm")).restore()
    rep = apply_warm_state(store, ws)
    assert not rep["valid"] and "behind snapshot" in rep["reason"]
    assert rep["shards_warm"] == 0 and not rep["sessions_valid"]


# ----------------------------------------------------------- across packages
def _history(svc):
    """One service history: a publish, three queries, a snapshot."""
    svc.apply_updates(inserts=(np.array([1, 2, 9]), np.array([3, 4, 7])),
                      deletes=(np.array([0]), np.array([1]))).result()
    return [svc.query(p, s) for p, s in (("bfs", 5), ("sssp", 11), ("ppr", 3))]


def _checkpoint_files(d):
    step = os.path.join(d, sorted(os.listdir(d))[-1])
    return {f: open(os.path.join(step, f), "rb").read()
            for f in sorted(os.listdir(step))}


def test_checkpoint_byte_identical_across_packages(tmp_path, monkeypatch):
    """The same store and service history give the same checkpoint files
    (``state.npz``, ``MANIFEST.json`` and its SHA-256) byte for byte.
    (npz members carry the write time, so the clock is pinned.)"""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    g = rmat_graph(N, M, seed=9)
    kw = dict(num_shards=SHARDS, window=128, k=16, cache_bytes=1 << 20)
    ref = RefService.from_graph(g, str(tmp_path / "ref"), backend="numpy", **kw)
    pt = GraphService.from_graph(g, str(tmp_path / "pt"), **CPU, **kw)
    for svc in (ref, pt):
        _history(svc)
    ref.save_warm_state(str(tmp_path / "w_ref"))
    pt.save_warm_state(str(tmp_path / "w_pt"))
    ref.close()
    pt.close()
    a, b = _checkpoint_files(tmp_path / "w_ref"), _checkpoint_files(tmp_path / "w_pt")
    assert list(a) == list(b) == ["MANIFEST.json", "state.npz"]
    assert a == b


@pytest.mark.parametrize("saver", ["ref", "pt"])
def test_checkpoint_restores_in_the_other_package(tmp_path, saver):
    """A checkpoint saved by either package's service warm-boots the
    other's: every shard's sources restored (the filter build reads
    nothing), the session cache answers the repeat queries bitwise, and a
    new query is bitwise the cold boot's."""
    g = rmat_graph(N, M, seed=9)
    kw = dict(num_shards=SHARDS, window=128, k=16, cache_bytes=1 << 20)
    root = str(tmp_path / "s")
    if saver == "ref":
        svc = RefService.from_graph(g, root, backend="numpy", **kw)
    else:
        svc = GraphService.from_graph(g, root, **CPU, **kw)
    answers = _history(svc)
    svc.save_warm_state(str(tmp_path / "warm"))
    svc.close()
    boot_kw = dict(warm_state=str(tmp_path / "warm"), cache_bytes=1 << 20)
    if saver == "ref":
        warm, cold = _boot(root, **boot_kw), _boot(root)
    else:
        warm = RefService.from_store(root, backend="numpy", **boot_kw)
        cold = RefService.from_store(root, backend="numpy")
    rep = warm.warm_restore_report
    assert rep["valid"] and rep["shards_warm"] == SHARDS
    assert rep["sessions_restored"] == len(answers)
    assert warm.engine.loading_io.reads == 0
    for qr in answers:
        hit = warm.query(qr.program, qr.source)
        assert hit.cached and np.array_equal(hit.values, qr.values)
        assert hit.graph_version == qr.graph_version == 1
    a, b = warm.query("sssp", 42), cold.query("sssp", 42)
    assert not a.cached and np.array_equal(a.values, b.values)
    warm.close()
    cold.close()
