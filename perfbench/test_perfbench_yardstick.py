"""The yardstick: byte counts by hand on a 3-shard toy graph, the share of
the bound, and the reduction of a device trace to busy time, kernel time
and idle gaps by host span."""

import pytest
import torch

from perfbench import devtrace, graphs, roofline
from perfbench.record import COMBINE_KERNELS, PARTIALS_KERNELS, RunRecord

# 6 vertices; in 3 shards of 2 destinations each: shard 0 holds the edges
# into 0-1, shard 1 into 2-3, shard 2 into 4-5 (5 has no in-edge)
SRC = torch.tensor([1, 2, 2, 3, 0, 0, 1, 2])
DST = torch.tensor([0, 0, 1, 1, 2, 3, 4, 4])


def test_byte_counts_by_hand_on_three_shards():
    from repro_torch.core import Graph, preprocess

    c = graphs.counts_of(6, SRC, DST)
    assert (c.vertices, c.edges, c.sources, c.destinations) == (6, 8, 4, 5)
    meta, shards = preprocess(Graph(6, SRC.numpy(), DST.numpy()), num_shards=3)
    assert len(shards) == 3
    # whole sweep: every shard's edges, each message (sources 0-3) once,
    # each destination with an in-edge (0-4) once
    per_shard_edges = [s.nnz for s in shards]
    assert sum(per_shard_edges) == 8
    assert roofline.partials_bytes(c) == 4 * 8 + 4 * 4 + 4 * 5 == 68
    # the combine reads the 5 partials, writes all 6 accumulators
    assert roofline.combine_bytes(c) == 4 * 5 + 4 * 6 == 44


def test_share_and_its_guards():
    assert roofline.share_pct(3.35e12, 1.0) == pytest.approx(100.0)
    assert roofline.share_pct(3.35e9, 0.002) == pytest.approx(50.0)

    class It:  # the IterStats fields the readers use
        def __init__(self, skipped):
            self.shards_skipped = skipped
            self.shards_processed = 3 - skipped

    trace = devtrace.DeviceTrace(window_s=1.0, busy_s=0.25, ops={
        "void ell_partials_masked_kernel<short, 8, 0>(Args)": 68 / 3.35e12 * 4,
        "void ell_partials_lanes_kernel<1>(Args)": 1.0,
        "void segment_combine_kernel<0>(Args)": 44 / 3.35e12 * 2,
        "Memcpy DtoH (Device -> Pageable)": 0.1}, idle_by_host={})
    c = graphs.counts_of(6, SRC, DST)
    rec = RunRecord(setup_s=1.0, preprocess_s=0.5, window_s=1.0, requests=1,
                    converged=1, iters=[It(0), It(0)], counts=c, trace=trace)
    # two whole sweeps in 4x / 2x the bound's time
    assert rec.roofline_pct(PARTIALS_KERNELS, roofline.partials_bytes) == \
        pytest.approx(50.0)
    assert rec.roofline_pct(COMBINE_KERNELS, roofline.combine_bytes) == \
        pytest.approx(100.0)
    assert rec.idle_pct() == pytest.approx(75.0)
    # a sweep that skipped shards has no whole-sweep byte count
    rec.iters = [It(0), It(1)]
    assert rec.roofline_pct(PARTIALS_KERNELS, roofline.partials_bytes) is None
    rec.trace = None
    assert rec.idle_pct() is None
    assert rec.roofline_pct(COMBINE_KERNELS, roofline.combine_bytes) is None


def test_reduce_busy_kernels_and_gaps_by_host_span():
    # profiler time = host time + 1000 us; window 100..200 us on the host
    events = [
        {"ph": "X", "cat": "user_annotation", "name": devtrace.WINDOW_MARK,
         "ts": 1100.0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 1090.0, "dur": 20.0},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 1105.0, "dur": 10.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 1150.0,
         "dur": 10.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1120.0,
         "dur": 50.0},
    ]
    # host spans, microseconds from the tracer's epoch (epoch = 50 us)
    host = [
        {"ph": "X", "tid": 1, "name": "vsw.iter", "ts": 10.0, "dur": 100.0},
        {"ph": "X", "tid": 1, "name": "exec.dispatch", "ts": 55.0,
         "dur": 20.0},
        {"ph": "X", "tid": 2, "name": "shard.load", "ts": 50.0, "dur": 150.0},
    ]
    t = devtrace.reduce(events, 100_000, host, 50_000, host_tid=1)
    assert t.window_s == pytest.approx(100e-6)
    # busy: 1100-1115 (k1 clipped to the window, k2 inside it), 1150-1160
    assert t.busy_s == pytest.approx(25e-6)
    assert t.ops == pytest.approx({"k1": 10e-6, "k2": 10e-6, "copy": 10e-6})
    # gaps: 1115-1150 (middle 1132.5 us: host 132.5, in vsw.iter only),
    # 1160-1200 (middle 1180: host 180, past every span of thread 1)
    assert t.idle_by_host == pytest.approx(
        {"vsw.iter": 35e-6, devtrace.NO_SPAN: 40e-6})
    assert t.kernel_s(r"^k") == pytest.approx(20e-6)
    bd = t.breakdown()
    assert bd["device_ops"][0][0] in ("k1", "copy")
    assert bd["idle_gaps"][0] == [devtrace.NO_SPAN, pytest.approx(40e-6)]
