"""The readers of the engine's clocked host steps (``perfbench/steps.py``,
``metrics/{plan,pre,apply,activity,host_other,stage,copy_back}_ms.py``):
by hand on made-up iterations, silent on a port without the fields, and
present on a traced tiny cell."""

import time
import types

import pytest

from perfbench import harness, parts
from perfbench.conftest import REPO
from perfbench.graphs import GraphCounts
from perfbench.record import RunRecord

#: reader -> the IterStats field it reads
FIELDS = {
    "plan_ms": "plan_s",
    "pre_ms": "pre_s",
    "apply_ms": "apply_s",
    "activity_ms": "activity_s",
    "stage_ms": "stage_s",
    "copy_back_ms": "copy_back_s",
}
READERS = [*FIELDS, "host_other_ms"]
CELLS = ["kron21-pagerank", "urand21-pagerank"]


def _iters():
    from repro_torch.core.vsw import IterStats

    base = dict(shards_processed=4, shards_skipped=0, bytes_read=0,
                cache_hits=0, cache_misses=0, active_count=1,
                active_ratio=1.0, selective_on=False)
    return [
        IterStats(iteration=0, time_s=0.040, exec_s=0.006, stage_s=0.001,
                  copy_back_s=0.002, load_wait_s=0.002, to_device_s=0.0,
                  plan_s=0.0005, pre_s=0.008, apply_s=0.010,
                  activity_s=0.007, **base),
        IterStats(iteration=1, time_s=0.030, exec_s=0.004, stage_s=0.0015,
                  copy_back_s=0.001, load_wait_s=0.001, to_device_s=0.0005,
                  plan_s=0.0003, pre_s=0.006, apply_s=0.009,
                  activity_s=0.005, **base),
    ]


def _record(iters):
    return RunRecord(setup_s=1.0, preprocess_s=0.5, window_s=0.07,
                     requests=1, converged=1, iters=iters,
                     counts=GraphCounts(8, 16, 8, 8))


@pytest.mark.parametrize("name", list(FIELDS))
def test_each_step_reader_reads_its_field_per_iteration(name):
    iters = _iters()
    got = parts.load(REPO, "metrics", name).read(_record(iters))
    want = 1e3 * sum(getattr(i, FIELDS[name]) for i in iters) / len(iters)
    assert got == pytest.approx(want)


def test_host_other_is_what_no_clock_names():
    iters = _iters()
    got = parts.load(REPO, "metrics", "host_other_ms").read(_record(iters))
    rest = [i.time_s - i.exec_s - i.load_wait_s - i.to_device_s - i.plan_s
            - i.pre_s - i.apply_s - i.activity_s for i in iters]
    assert got == pytest.approx(1e3 * sum(rest) / len(rest))
    # with host_ms: host_ms = plan + pre + apply + activity + other
    host = parts.load(REPO, "metrics", "host_ms").read(_record(iters))
    named = sum(parts.load(REPO, "metrics", n).read(_record(iters))
                for n in ("plan_ms", "pre_ms", "apply_ms", "activity_ms"))
    assert host == pytest.approx(named + got)


@pytest.mark.parametrize("name", READERS)
def test_a_port_without_the_fields_reads_as_nothing(name):
    """An engine whose ``IterStats`` has no step clocks (an older port)
    gives no value, and the reader does not raise."""
    old = types.SimpleNamespace(time_s=0.04, exec_s=0.006, load_wait_s=0.002,
                                to_device_s=0.0, shards_skipped=0)
    reader = parts.load(REPO, "metrics", name).read
    assert reader(_record([old])) is None
    assert reader(_record([])) is None


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_tiny_cell_reports_every_step(tiny_root, cell):
    out = harness.run_cell(tiny_root, cell, 2**31 + 977, 0.2, True,
                           t_start=time.perf_counter(), device="cpu")
    assert out["correct"]
    for name in READERS:
        assert out["metrics"][f"{name}.pr"]["value"] >= 0, name
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert m["stage_ms.pr"] + m["copy_back_ms.pr"] <= m["exec_ms.pr"]
    assert m["host_other_ms.pr"] <= m["host_ms.pr"] + 1e-9
