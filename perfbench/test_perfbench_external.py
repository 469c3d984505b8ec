"""The semi-external cell ``kron21-external-pagerank`` on the CPU at a tiny
size: its files run correct with every metric the cell lists, the edge
cache serves a share of the bytes under ``keep`` and none under LRU, the
comparison fails a broken path and the control; and the cell's readers
(``metrics/{read,decode,to_device}_ms.py``, ``cache_hit_pct.py``,
``h2d_roofline.py``, ``transfer.py``) by hand, silent on a port without
their fields."""

import json
import time
import types

import pytest

from perfbench import devtrace, harness, parts, transfer
from perfbench.conftest import REPO
from perfbench.graphs import GraphCounts
from perfbench.record import RunRecord
from perfbench.test_perfbench_harness import _altered, _unchanged

CELL = "kron21-external-pagerank"
CONFIG = "perfbench/configs/kron21-external.json"
SEED = 2**32 + 1709
#: reader -> the IterStats field it reads per iteration
STEPS = {"read_ms": "read_s", "decode_ms": "decode_s",
         "to_device_ms": "to_device_s"}
READERS = [*STEPS, "cache_hit_pct", "h2d_roofline"]


def _run(root, trace=False, control=False, seconds=0.2):
    return harness.run_cell(root, CELL, SEED, seconds, trace,
                            t_start=time.perf_counter(), device="cpu",
                            control=control)


def _engine(root, **engine):
    """Set keys of the tiny configuration's engine."""
    cfg = json.loads((root / CONFIG).read_text())
    cfg["engine"].update(engine)
    (root / CONFIG).write_text(json.dumps(cfg))


def test_the_config_is_the_resident_graph_with_the_external_engine():
    ext = json.loads((REPO / CONFIG).read_text())
    res = json.loads((REPO / "perfbench/configs/kron21-resident.json").read_text())
    for key in ("generator", "scale", "edge_factor", "initiator",
                "structure_seed", "symmetric"):
        assert ext[key] == res[key], key
    assert ext["engine"] == dict(res["engine"], device_resident=False,
                                 cache_mode=1, cache_policy="keep")
    assert set(ext["reduced"]) == {"scale", "symmetric", "cache_bytes"}


def test_the_cell_runs_correct_with_its_metrics(tiny_root):
    # room for a part of the tiny store, as 1 GiB is of the real one
    _engine(tiny_root, cache_bytes=50_000)
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    out = _run(tiny_root, control=True)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"iter_ms", "setup_s"}
    # the limit lies between the program's reading and the control's
    limit = out["compared"]["max_rel_err"]["limit"]
    assert out["compared"]["max_rel_err"]["value"] < limit
    assert out["control"]["max_rel_err"] > limit
    traced = _run(tiny_root, trace=True)
    per_layer = {m["name"] for m in spec["per_layer"]
                 if CELL in m.get("workloads", [CELL])}
    assert {f"{r}.pr" for r in READERS} <= per_layer
    # on the CPU the readers of the device trace find nothing to read
    assert set(traced["metrics"]) == {
        m for m in per_layer if "roofline" not in m and "idle" not in m}
    m = {k: v["value"] for k, v in traced["metrics"].items()}
    assert 0 < m["cache_hit_pct.pr"] < 100
    assert m["read_ms.pr"] > 0 and m["decode_ms.pr"] > 0
    assert m["to_device_ms.pr"] > 0 and traced["correct"]


def test_lru_serves_nothing_on_the_same_scan(tiny_root):
    _engine(tiny_root, cache_bytes=50_000, cache_policy="lru")
    traced = _run(tiny_root, trace=True)
    assert traced["correct"]
    assert traced["metrics"]["cache_hit_pct.pr"]["value"] == 0.0


@pytest.mark.parametrize("fault", [_unchanged, _altered])
def test_a_broken_path_comes_out_not_correct(tiny_root, monkeypatch, fault):
    fault(monkeypatch)
    out = _run(tiny_root, seconds=0.05)
    assert not out["correct"] and out["failed"] >= 1


def _iters():
    from repro_torch.core.vsw import IterStats

    base = dict(shards_processed=4, shards_skipped=0, cache_hits=1,
                cache_misses=3, active_count=1, active_ratio=1.0,
                selective_on=False, time_s=2.0)
    return [
        IterStats(iteration=0, bytes_read=300, cache_bytes=100, read_s=0.4,
                  decode_s=1.2, to_device_s=0.5, **base),
        IterStats(iteration=1, bytes_read=200, cache_bytes=200, read_s=0.2,
                  decode_s=1.0, to_device_s=0.7, **base),
    ]


def _record(iters, trace=None, counts=GraphCounts(8, 16, 8, 6)):
    return RunRecord(setup_s=1.0, preprocess_s=0.5, window_s=4.0, requests=1,
                     converged=0, iters=iters, counts=counts, trace=trace)


@pytest.mark.parametrize("name", list(STEPS))
def test_each_step_reader_reads_its_field_per_iteration(name):
    iters = _iters()
    got = parts.load(REPO, "metrics", name).read(_record(iters))
    want = 1e3 * sum(getattr(i, STEPS[name]) for i in iters) / len(iters)
    assert got == pytest.approx(want)


def test_cache_hit_share_is_of_the_bytes_loaded():
    read = parts.load(REPO, "metrics", "cache_hit_pct").read
    assert read(_record(_iters())) == pytest.approx(100 * 300 / 800)
    resident = [types.SimpleNamespace(bytes_read=0, cache_bytes=0)]
    assert read(_record(resident)) is None  # nothing loaded


def test_h2d_share_by_hand():
    # 2 sweeps of 16 edges and 6 destinations: 2 * (4 * 16 + 4 * 6) B,
    # copied in 4x the link's least time
    nbytes = 2 * (4 * 16 + 4 * 6)
    assert transfer.sweep_bytes(GraphCounts(8, 16, 8, 6)) == 88
    trace = devtrace.DeviceTrace(window_s=1.0, busy_s=0.5, ops={
        "Memcpy HtoD (Pageable -> Device)": 3 * nbytes / transfer.H2D_BW,
        "Memcpy HtoD (Pinned -> Device)": nbytes / transfer.H2D_BW,
        "Memcpy DtoH (Device -> Pageable)": 1.0,
        "void ell_partials_masked_kernel<short, 8, 0>(Args)": 1.0},
        idle_by_host={})
    read = parts.load(REPO, "metrics", "h2d_roofline").read
    assert read(_record(_iters(), trace)) == pytest.approx(25.0)
    skipped = _iters()
    skipped[1].shards_skipped = 1
    assert read(_record(skipped, trace)) is None
    assert read(_record(_iters())) is None  # no device trace
    no_copies = devtrace.DeviceTrace(1.0, 0.5, {"k": 1.0}, {})
    assert read(_record(_iters(), no_copies)) is None


@pytest.mark.parametrize("name", READERS)
def test_a_port_without_the_fields_reads_as_nothing(name):
    """An engine whose ``IterStats`` lacks the field (the parent's lacks
    ``read_s``, ``decode_s`` and ``cache_bytes``) gives no value, and the
    reader does not raise."""
    field = STEPS.get(name, {"cache_hit_pct": "cache_bytes",
                             "h2d_roofline": "shards_skipped"}.get(name))
    have = dict(time_s=2.0, exec_s=0.1, load_wait_s=0.5, to_device_s=0.5,
                read_s=0.4, decode_s=1.2, bytes_read=300, cache_bytes=100,
                shards_skipped=0)
    del have[field]
    trace = devtrace.DeviceTrace(1.0, 0.5, {"Memcpy HtoD": 1.0}, {})
    reader = parts.load(REPO, "metrics", name).read
    assert reader(_record([types.SimpleNamespace(**have)], trace)) is None
    assert reader(_record([], trace)) is None
