"""The lane and ragged ELL updates of the port against the reference's
(TPU kernels in interpret mode), and the port's own lane contracts.

On the CPU the port's wrappers run the kernels' plain versions; the CUDA
kernels are held against those on the card by ``tests/test_torch_cuda.py``.
Against the reference: min/max bitwise, sum within rtol=1e-4 (atol=1e-5,
the reference's kernel tolerance: the reduction order over K differs).
Inside the port: lane ``l`` is bitwise the single-lane update on row
``l``, ragged is bitwise multi, padding lanes are 0.
"""

import numpy as np
import pytest
import torch

from repro.core.csr import csr_to_ell as ref_csr_to_ell
from repro.core.csr import ragged_lane_concat as ref_ragged_lane_concat
from repro.core.csr import ragged_lane_pad as ref_ragged_lane_pad
from repro.core import apps as ref_apps
from repro.core.graph import rmat_graph
from repro.core.sharding import preprocess as ref_preprocess
from repro.kernels.spmv_ell import ops as ref_ops
from repro_torch.core import apps
from repro_torch.core.csr import (
    csr_to_ell,
    ell_to_device,
    next_pow2,
    ragged_lane_concat,
    ragged_lane_pad,
)
from repro_torch.core.executor import (
    BatchedEllExecutor,
    PerShardExecutor,
    make_lane_executor,
    update_shard_numpy,
    update_shard_numpy_lanes,
)
from repro_torch.core.sharding import preprocess
from repro_torch.kernels.spmv_ell import kernel as K
from repro_torch.kernels.spmv_ell import ops

SHAPES = [(64, 8, 8), (128, 16, 8)]
COMBINES = ["sum", "min", "max"]
GROUPS = [((3, 5), ("min", "sum")), ((1, 1, 1), ("sum", "min", "max")),
          ((2, 4), ("min", "min"))]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, combine):
    a = np.nan_to_num(np.asarray(a, np.float32), posinf=1e30, neginf=-1e30)
    b = np.nan_to_num(np.asarray(b, np.float32), posinf=1e30, neginf=-1e30)
    if combine == "sum":
        return np.allclose(a, b, rtol=1e-4, atol=1e-5)
    return np.array_equal(a, b)


def _msgs(lanes, n, combine, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((lanes, n)).astype(np.float32)
    if combine != "sum":  # identities among the messages, as SSSP carries
        x[rng.random(x.shape) < 0.1] = np.inf if combine == "min" else -np.inf
    return x


@pytest.fixture(scope="module")
def graph():
    g = rmat_graph(1200, 15000, seed=31)
    return g, ref_preprocess(g, num_shards=3)[1]


def _both(g, shards, window, k, tr):
    ref = [ref_csr_to_ell(s, g.num_vertices, window=window, k=k, tr=tr)
           for s in shards]
    return ref, [ell_to_device(e, "cpu") for e in ref]


# ------------------------------------------------- against the reference
@pytest.mark.parametrize("window,k,tr", SHAPES)
@pytest.mark.parametrize("combine", COMBINES)
def test_lanes_batched_matches_reference(graph, window, k, tr, combine):
    g, shards = graph
    ref, dev = _both(g, shards, window, k, tr)
    msgs = _msgs(4, g.num_vertices, combine)
    want = ref_ops.ell_update_lanes_batched(ref, msgs, combine, interpret=True)
    n_pad = dev[0].num_windows * dev[0].window
    got = ops.split_rows(dev, ops.ell_update_lanes_batched(
        dev, ops.stage_lanes(msgs, n_pad, "cpu"), combine).numpy())
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert _close(a, b, combine)


@pytest.mark.parametrize("counts,combines", GROUPS)
def test_multi_and_ragged_match_reference(graph, counts, combines):
    g, shards = graph
    ref, dev = _both(g, shards, 128, 16, 8)
    groups = [_msgs(c, g.num_vertices, comb, seed=i)
              for i, (c, comb) in enumerate(zip(counts, combines))]
    want = ref_ops.ell_update_lanes_ragged(ref, groups, combines, interpret=True)
    for fn in (ops.ell_update_lanes_multi, ops.ell_update_lanes_ragged):
        got = fn(dev, groups, combines)
        for gw, gg, comb in zip(want, got, combines):
            for a, b in zip(gg, gw):
                assert a.shape == b.shape and _close(a, b, comb), fn.__name__


def test_single_shard_lanes_matches_reference(graph):
    g, shards = graph
    ref, dev = _both(g, shards, 64, 8, 8)
    msgs = _msgs(3, g.num_vertices, "min")
    for r, d in zip(ref, dev):
        want = np.asarray(ref_ops.ell_update_lanes(r, msgs, "min"))
        n_pad = d.num_windows * d.window
        got = ops.ell_update_lanes(d, ops.stage_lanes(msgs, n_pad, "cpu"), "min")
        assert np.array_equal(got.numpy(), want[:, : d.rows])


# ------------------------------------------------------ inside the port
@pytest.mark.parametrize("window,k,tr", SHAPES)
@pytest.mark.parametrize("combine", COMBINES)
def test_lane_is_bitwise_single_lane(graph, window, k, tr, combine):
    g, shards = graph
    _, dev = _both(g, shards, window, k, tr)
    n_pad = dev[0].num_windows * dev[0].window
    msgs = _msgs(5, g.num_vertices, combine, seed=7)
    acc = ops.ell_update_lanes_batched(dev, ops.stage_lanes(msgs, n_pad, "cpu"),
                                       combine)
    for l in range(5):
        one = ops.ell_update_batched(dev, ops.stage_messages(msgs[l], n_pad, "cpu"),
                                     combine)
        assert torch.equal(acc[l], one)


@pytest.mark.parametrize("counts,combines", GROUPS)
def test_ragged_is_bitwise_multi_and_pads_zero(graph, counts, combines):
    g, shards = graph
    _, dev = _both(g, shards, 128, 16, 8)
    groups = [_msgs(c, g.num_vertices, comb, seed=i)
              for i, (c, comb) in enumerate(zip(counts, combines))]
    multi = ops.ell_update_lanes_multi(dev, groups, combines)
    ragged = ops.ell_update_lanes_ragged(dev, groups, combines)
    for gm, gr in zip(multi, ragged):
        for a, b in zip(gm, gr):
            assert np.array_equal(a, b)
    ctx = ops.ragged_stage_lanes(groups, combines,
                                 dev[0].num_windows * dev[0].window, "cpu")
    assert ctx["k_pad"] == ragged_lane_pad(counts) >= ctx["k_total"]
    acc = ops.ragged_dispatch(dev, ctx)
    assert acc.shape == (ctx["k_pad"], sum(d.rows for d in dev))
    assert not acc[ctx["k_total"]:].any()
    part = K.ell_partials_ragged(
        [d.idx for d in dev], [d.mask for d in dev], [d.tile_window for d in dev],
        ctx["cids"], ctx["msgs"], window=128, tr=8, combines=ctx["combines"])
    assert not part[ctx["k_total"]:].any()


def test_wrappers_count_no_launch_on_the_cpu(graph):
    g, shards = graph
    _, dev = _both(g, shards, 64, 8, 8)
    before = (K.ell_partials_lanes.launches, K.ell_partials_ragged.launches,
              K.segment_combine_lanes.launches)
    ops.ell_update_lanes_ragged(dev, [_msgs(2, g.num_vertices, "sum")], ["sum"])
    ops.ell_update_lanes_multi(dev, [_msgs(2, g.num_vertices, "sum")], ["sum"])
    assert (K.ell_partials_lanes.launches, K.ell_partials_ragged.launches,
            K.segment_combine_lanes.launches) == before


def test_lane_messages_vertex_major_layout():
    rows = torch.arange(3 * 10, dtype=torch.float32).view(3, 10)
    lm = K.LaneMessages(rows)
    vm = lm.vertex_major()
    assert vm.shape == (10, 4) and K.lane_chunk(3) == 4
    assert torch.equal(vm[:, :3], rows.t()) and not vm[:, 3].any()
    assert lm.vertex_major() is vm  # staged once
    assert [K.lane_chunk(n) for n in (1, 2, 4, 5, 32)] == [1, 4, 4, 8, 8]
    with pytest.raises(ValueError):
        K.LaneMessages(torch.zeros(4))


def test_lane_update_rejects_bad_inputs(graph):
    g, shards = graph
    _, dev = _both(g, shards, 64, 8, 8)
    with pytest.raises(ValueError):
        ops.stage_lanes(np.zeros(10, np.float32), 64, "cpu")
    with pytest.raises(ValueError):
        ops.ell_update_lanes_multi(dev, [np.zeros((1, 5), np.float32)], [])
    with pytest.raises(ValueError):
        ops.ragged_stage_lanes([np.zeros(5, np.float32)], ["sum"], 64, "cpu")
    with pytest.raises(ValueError, match="1..8"):
        K._arm_ops(["sum"] * 9)


# ------------------------------------------------- host pieces of the lanes
@pytest.mark.parametrize("counts", [(1,), (1, 1, 1), (3, 5), (16, 16), (5, 9, 2)])
def test_ragged_lane_pad_and_concat_match_reference(counts):
    assert ragged_lane_pad(counts) == ref_ragged_lane_pad(counts)
    assert ragged_lane_pad(counts) <= sum(next_pow2(c) for c in counts)
    rng = np.random.default_rng(sum(counts))
    groups = [rng.random((c, 37)).astype(np.float32) for c in counts]
    combines = ["sum", "min", "sum", "max", "min"][: len(counts)]
    got = ragged_lane_concat(groups, combines, n_cols=40)
    want = ref_ragged_lane_concat(groups, combines, n_cols=40)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert got[2] == want[2] and got[3] == want[3]


def test_ragged_lane_concat_into_preallocated_buffer():
    groups = [np.ones((3, 5), np.float32), np.full((2, 3), 2, np.float32)]
    out = np.full((6, 8), 9, np.float32)  # pad(3, 2) = 6: one padding lane
    msgs, cids, arms, slices = ragged_lane_concat(groups, ["min", "min"],
                                                  n_cols=8, out=out)
    assert msgs is out and arms == ("min",)
    assert cids.tolist() == [0, 0, 0, 0, 0, 1]
    assert slices == [slice(0, 3), slice(3, 5)]
    assert out[0, :5].tolist() == [1] * 5 and not out[0, 5:].any()
    assert not out[5].any()
    with pytest.raises(ValueError):
        ragged_lane_concat(groups, ["min", "min"], n_cols=8,
                           out=np.zeros((2, 8), np.float32))


@pytest.mark.parametrize("name", ["bfs", "sssp", "wcc", "ppr"])
def test_lane_programs_match_reference(graph, name):
    g, _ = graph
    from repro.core.sharding import preprocess as rp

    meta = rp(g, num_shards=2)[0]
    mine, theirs = apps.get_lane_program(name), ref_apps.get_lane_program(name)
    assert (mine.combine, mine.key, mine.combine_key) == (
        theirs.combine, theirs.key, theirs.combine_key)
    rng = np.random.default_rng(3)
    vals = rng.random((3, meta.num_vertices)).astype(np.float32)
    assert np.array_equal(mine.pre(vals, meta.out_deg),
                          theirs.pre(vals, meta.out_deg))
    acc = rng.random((3, 50)).astype(np.float32)
    src = np.array([5, 60, 120])
    assert np.array_equal(mine.apply(acc, vals[:, 100:150], meta, 100, src),
                          theirs.apply(acc, vals[:, 100:150], meta, 100, src))
    for a, b in zip(mine.init_lane(meta, 7), theirs.init_lane(meta, 7)):
        assert np.array_equal(a, b)
    with pytest.raises(KeyError):
        apps.get_lane_program("pagerank")


def test_lane_backend_rows_are_bitwise_single_lane():
    """The numpy lane oracle and the ELL lane backends row by row."""
    g = rmat_graph(300, 4000, seed=40)
    meta, shards = preprocess(g, num_shards=3)
    msgs = np.random.default_rng(1).random((4, meta.num_vertices)).astype(np.float32)
    for combine in COMBINES:
        for s in shards:
            lanes_np = update_shard_numpy_lanes(s, None, msgs, combine)
            d = ell_to_device(csr_to_ell(s, meta.num_vertices, window=64, k=8,
                                         tr=8), "cpu")
            n_pad = d.num_windows * d.window
            staged = ops.stage_lanes(msgs, n_pad, "cpu")
            for backend in ("torch", "cuda"):
                ex = PerShardExecutor(backend, lanes=True, device="cpu")
                acc = ex._lane_fn([d], staged, combine)
                for l in range(4):
                    assert np.array_equal(
                        lanes_np[l], update_shard_numpy(s, None, msgs[l], combine))
                    one = ex._fn([d], ops.stage_messages(msgs[l], n_pad, "cpu"),
                                 combine)
                    assert torch.equal(acc[l], one), (backend, combine)


def test_make_lane_executor_selection():
    assert isinstance(make_lane_executor("numpy", batch_shards=4, device="cpu"),
                      PerShardExecutor)
    ex = make_lane_executor("cuda", batch_shards=2, device="cpu")
    assert isinstance(ex, BatchedEllExecutor) and ex.lanes and ex.ragged
    ex = make_lane_executor("torch", batch_shards=1, device="cpu")
    assert isinstance(ex, BatchedEllExecutor) and ex.ragged  # ragged wants it
    ex = make_lane_executor("torch", batch_shards=1, ragged=False, device="cpu")
    assert isinstance(ex, PerShardExecutor) and ex.lanes
    with pytest.raises(ValueError):
        make_lane_executor("nope", device="cpu")
    with pytest.raises(RuntimeError, match="lane executor"):
        list(BatchedEllExecutor("cuda", 2, device="cpu").run_groups(iter([]), []))


def test_lane_minor_table_for_the_lane_combine():
    """The lane combine reads lane-minor partials: the lane kernels' own
    output (an ``[L, n_ell]`` view of an ``[n_ell, S]`` table) goes through
    as it is, any other layout is copied to one."""
    table = torch.arange(10 * 8, dtype=torch.float32).view(10, 8)
    view = table.t()[:5]
    got, stride = K._lane_minor(view)
    assert got is view and stride == 8
    dense = view.contiguous()
    got, stride = K._lane_minor(dense)
    assert stride == 8 and got.shape == (10, 8)
    assert torch.equal(got[:, :5], table[:, :5]) and not got[:, 5:].any()
    one = torch.arange(6, dtype=torch.float32).view(1, 6)
    assert K._lane_minor(one) == (one, 1)
    got, stride = K._lane_minor(torch.ones(3, 7))
    assert stride == 4 and got.shape == (7, 4) and not got[:, 3].any()
