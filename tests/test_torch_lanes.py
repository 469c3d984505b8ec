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
    assert stride == 5 and got.shape == (10, 5)
    assert torch.equal(got, table[:, :5])
    one = torch.arange(6, dtype=torch.float32).view(1, 6)
    assert K._lane_minor(one) == (one, 1)
    got, stride = K._lane_minor(torch.ones(3, 7))
    assert stride == 3 and got.shape == (7, 3) and got.is_contiguous()


# ------------------------------------------------ the lane kernel's fold order
# A model of the two CUDA partials bodies for one row and one lane
# (``csrc/spmv_ell.cu``), in float32 with the card's fold arithmetic: the
# single-lane kernel spreads a row over P threads, thread ``sub`` folding
# its 16-slot groups sub, sub + P, ... in slot order, then an xor-shuffle
# tree folds the threads; the lane kernel reads the row once, folds slot s
# into accumulator (s // 16) % P, then folds the P accumulators in the
# same tree, leaving out each fold with an accumulator nothing was folded
# into (it holds the identity, and an accumulator is never -0.0 nor, for
# min/max, NaN, so such a fold changes no bit).
_FOLD = {"sum": lambda a, b: np.float32(a + b), "min": np.fmin, "max": np.fmax}
_IDENTITY = {"sum": np.float32(0.0), "min": np.float32(np.inf),
             "max": np.float32(-np.inf)}


def _threads_a_row(k):
    """``lanes_per_row`` of the C source: 16-slot groups rounded up to a
    power of two, at most 32."""
    p = 1
    while p < k // 16 and p < 32:
        p <<= 1
    return p


def _single_lane_fold(vals, mask, combine):
    k, p, fold = len(vals), _threads_a_row(len(vals)), _FOLD[combine]
    acc = [_IDENTITY[combine]] * p
    for sub in range(p):
        for c in range(sub * 16, k, p * 16):
            for s in range(c, c + 16):
                if mask[s]:
                    acc[sub] = fold(acc[sub], vals[s])
    off = p // 2
    while off:  # every thread t folds its partner t ^ off
        acc = [fold(acc[t], acc[t ^ off]) for t in range(p)]
        off //= 2
    return acc[0]


def _lane_row_fold(vals, mask, combine):
    k, p, fold = len(vals), _threads_a_row(len(vals)), _FOLD[combine]
    acc = [_IDENTITY[combine]] * p
    touched = [False] * p
    units = k // 16
    for rd in range(-(-units // p)):  # rounds of P units
        for m in range(p):
            u = rd * p + m
            for s in range(16 * u, 16 * u + 16 if u < units else 0):
                if mask[s]:
                    acc[m] = fold(acc[m], vals[s])
                    touched[m] = True
    off = p // 2
    while off:  # folds with an accumulator still at the identity are left out
        for t in range(off):
            if touched[t + off]:
                acc[t] = fold(acc[t], acc[t + off])
            touched[t] = touched[t] or touched[t + off]
        off //= 2
    return acc[0]


def _masked_item_fold(vals, mask, combine):
    """The masked kernel: an item for each accumulator p with a set slot,
    each on its own thread, folding units p, p + P, ... that hold a set
    slot in slot order from the identity, an unset slot of such a unit
    as the identity; then the row's thread folds the items' accumulators
    in the tree, less its folds with an accumulator that holds no item (an
    empty row is the identity)."""
    k, p, fold = len(vals), _threads_a_row(len(vals)), _FOLD[combine]
    units = k // 16
    items = [q for q in range(p)
             if any(mask[16 * u:16 * u + 16].any() for u in range(q, units, p))]
    accs = {}
    for q in items:
        acc = _IDENTITY[combine]
        for u in range(q, units, p):
            if mask[16 * u:16 * u + 16].any():
                for s in range(16 * u, 16 * u + 16):
                    acc = fold(acc, vals[s] if mask[s] else _IDENTITY[combine])
        accs[q] = acc
    if items == [0]:  # accumulator 0 alone: no fold of the tree is left
        return accs[0]
    acc = [accs.get(q, _IDENTITY[combine]) for q in range(p)]
    held = [q in accs for q in range(p)]
    off = p // 2
    while off:
        for t in range(off):
            if held[t + off]:
                acc[t] = fold(acc[t], acc[t + off])
            held[t] = held[t] or held[t + off]
        off //= 2
    return acc[0]


@pytest.mark.parametrize("k,rows", [(16, 200), (32, 200), (128, 90), (1024, 8)])
@pytest.mark.parametrize("combine", COMBINES)
def test_masked_kernel_fold_order_is_the_single_lane_order(k, rows, combine):
    """The masked kernel's order (one thread an item, the identity folded
    for an item's unset slots, then the tree without its folds of
    accumulators that hold no item) gives the single-lane order's bits, on
    the rows of the lane kernel's test; a plain slot-order fold does not,
    so the check can fail."""
    rng = np.random.default_rng(k + 1)
    special = np.float32([-0.0, 0.0, np.inf, -np.inf, np.nan])
    differs = 0
    with np.errstate(invalid="ignore", over="ignore"):  # inf - inf, NaN
        for r in range(rows):
            differs += _check_fold_order(rng, k, r, special, combine, _masked_item_fold)
    if combine == "sum" and k > 16:
        assert differs > 0


@pytest.mark.parametrize("k,rows", [(16, 200), (32, 200), (128, 90), (1024, 8)])
@pytest.mark.parametrize("combine", COMBINES)
def test_lane_kernel_fold_order_is_the_single_lane_order(k, rows, combine):
    """The lane kernel's order (P accumulators, then a P-way tree without
    its folds of untouched accumulators) gives the single-lane kernel's
    bits on rows holding -0.0, +-inf and NaN among values of mixed
    magnitude, full, front-packed, scattered and empty masks; a plain
    slot-order fold does not, so the check can fail."""
    rng = np.random.default_rng(k)
    special = np.float32([-0.0, 0.0, np.inf, -np.inf, np.nan])
    differs = 0
    with np.errstate(invalid="ignore", over="ignore"):  # inf - inf, NaN
        for r in range(rows):
            differs += _check_fold_order(rng, k, r, special, combine)
    if combine == "sum" and k > 16:
        assert differs > 0


def _check_fold_order(rng, k, r, special, combine, model=_lane_row_fold):
    """One row: asserts ``model``'s bits are the single-lane order's;
    returns whether a plain slot-order fold gives other bits."""
    vals = (rng.standard_normal(k) * 10.0 ** rng.integers(-6, 7, k)).astype(np.float32)
    pick = rng.random(k) < (0.0, 0.01, 0.15)[r % 3]  # some rows all finite
    vals[pick] = rng.choice(special, int(pick.sum()))
    if r % 4 == 0:
        mask = np.ones(k, bool)
    elif r % 4 == 1:
        mask = np.arange(k) < rng.integers(0, k + 1)
    else:
        mask = rng.random(k) < rng.random()
    want = _single_lane_fold(vals, mask, combine)
    got = model(vals, mask, combine)
    assert np.float32(got).view(np.uint32) == np.float32(want).view(np.uint32), (r, got, want)
    flat = _IDENTITY[combine]
    for v in vals[mask]:
        flat = _FOLD[combine](flat, v)
    return bool(np.float32(flat).view(np.uint32) != np.float32(want).view(np.uint32))
