"""The CUDA kernels on the card: each against its plain PyTorch version and
the numpy oracle, and the engine's ``cuda`` backend against its ``torch``
backend.  Every test here skips where torch sees no CUDA card; the file
imports only the port, so it also runs where jax is not installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

min/max bitwise; sum within rtol=1e-4, atol=1e-5 for one update (the
reduction order over K differs) and rtol=1e-5, atol=1e-9 for PageRank
values after 15 iterations.
"""

import dataclasses
import functools
import time

import numpy as np
import pytest
import torch

from repro_torch.core import apps, csr_to_ell, ell_to_device, preprocess
from repro_torch.core.executor import update_shard_numpy
from repro_torch.core.graph import from_edge_list, rmat_graph, star_graph
from repro_torch.core.vsw import VSWEngine
from repro_torch.kernels.spmv_ell import kernel as K
from repro_torch.kernels.spmv_ell import ops

pytestmark = pytest.mark.cuda

COMBINES = ["sum", "min", "max"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _close(a, b, combine, rtol=1e-4, atol=1e-5):
    a = np.nan_to_num(np.asarray(a, np.float64), posinf=1e30, neginf=-1e30)
    b = np.nan_to_num(np.asarray(b, np.float64), posinf=1e30, neginf=-1e30)
    if combine == "sum":
        return np.allclose(a, b, rtol=rtol, atol=atol)
    return np.array_equal(a, b)


def _cases():
    g = rmat_graph(1500, 20000, seed=42)
    _, shards = preprocess(g, num_shards=3)
    out = [(s, g.num_vertices) for s in shards]
    g = star_graph(10_000)
    out += [(s, g.num_vertices) for s in preprocess(g, num_shards=1)[1]]
    g = from_edge_list([(0, 1)], num_vertices=64)
    out += [(s, 64) for s in preprocess(g, num_shards=2)[1]]
    return out


@pytest.mark.parametrize("window,k,tr", [(256, 8, 8), (512, 32, 8),
                                         (1024, 128, 8), (16384, 128, 8),
                                         (1 << 16, 16, 8)])
@pytest.mark.parametrize("combine", COMBINES)
def test_kernels_match_plain_and_oracle(dev, window, k, tr, combine):
    rng = np.random.default_rng(5)
    before = (K.ell_partials_masked.launches, K.segment_combine.launches)
    cases = _cases()
    for shard, nv in cases:
        e = csr_to_ell(shard, nv, window=window, k=k, tr=tr)
        d = ell_to_device(e, dev)
        x = rng.random(nv).astype(np.float32)
        if combine != "sum":
            x[rng.random(nv) < 0.1] = np.inf if combine == "min" else -np.inf
        mp = torch.zeros(d.num_windows * d.window, device=dev)
        mp[:nv] = torch.from_numpy(x).to(dev)
        kw = dict(window=window, tr=tr, combine=combine)
        part = K.ell_partials_masked(d.idx, d.mask, d.tile_window, mp, **kw)
        plain = K.ell_partials_masked_plain(d.idx, d.mask, d.tile_window, mp, **kw)
        assert _close(part.cpu(), plain.cpu(), combine)
        acc = K.segment_combine(part, d.perm, d.row_ptr, combine)
        want = K.segment_combine_plain(part, d.perm, d.row_ptr, combine)
        assert _close(acc.cpu(), want.cpu(), combine)
        assert _close(acc.cpu(), update_shard_numpy(shard, None, x, combine),
                      combine)
    after = (K.ell_partials_masked.launches, K.segment_combine.launches)
    assert after == (before[0] + len(cases), before[1] + len(cases))


@pytest.mark.parametrize("combine", COMBINES)
def test_batched_launch_bitwise_per_shard(dev, combine):
    g = rmat_graph(3000, 40000, seed=9)
    _, shards = preprocess(g, num_shards=5)
    devs = [ell_to_device(csr_to_ell(s, g.num_vertices, window=512, k=32,
                                     tr=8), dev) for s in shards]
    mp = torch.rand(devs[0].num_windows * devs[0].window, device=dev)
    single = torch.cat([ops.ell_update(d, mp, combine) for d in devs])
    assert torch.equal(single, ops.ell_update_batched(devs, mp, combine))


@pytest.mark.parametrize("combine", COMBINES)
def test_partials_vector_path_matches_scalar_path(dev, combine):
    """K % 16 == 0 on 16 B aligned planes takes the 16-slots-a-lane path;
    misaligned planes take the warp-per-row path.  Both give the plain
    version's values (min/max bitwise)."""
    g = star_graph(5000)
    e = csr_to_ell(preprocess(g, num_shards=1)[1][0], g.num_vertices,
                   window=1024, k=128, tr=8)
    d = ell_to_device(e, dev)

    def misaligned(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    mp = torch.rand(d.num_windows * d.window, device=dev)
    kw = dict(window=d.window, tr=d.tr, combine=combine)
    vec = K.ell_partials_masked(d.idx, d.mask, d.tile_window, mp, **kw)
    scalar = K.ell_partials_masked(misaligned(d.idx), misaligned(d.mask),
                                   d.tile_window, mp, **kw)
    plain = K.ell_partials_masked_plain(d.idx, d.mask, d.tile_window, mp, **kw)
    assert _close(vec.cpu(), plain.cpu(), combine)
    assert _close(scalar.cpu(), plain.cpu(), combine)


def test_wrappers_reject_bad_inputs(dev):
    e = csr_to_ell(preprocess(rmat_graph(300, 2000, seed=1), num_shards=1)[1][0],
                   300, window=64, k=8, tr=8)
    d = ell_to_device(e, dev)
    mp = torch.zeros(d.num_windows * d.window, device=dev)
    kw = dict(window=64, tr=8, combine="sum")
    with pytest.raises(TypeError):
        K.ell_partials_masked(d.idx, d.mask, d.tile_window, mp.double(), **kw)
    with pytest.raises(ValueError):
        K.ell_partials_masked(d.idx, d.mask, d.tile_window, mp[:-1], **kw)
    with pytest.raises(ValueError):
        K.ell_partials_masked(d.idx, d.mask, d.tile_window, mp.cpu(), **kw)
    with pytest.raises(ValueError):
        K.segment_combine(mp[:d.n_ell - 1], d.perm, d.row_ptr, "sum")
    n = K.MAX_BATCH + 1
    with pytest.raises(ValueError, match="at most"):
        K.ell_partials_masked([d.idx] * n, [d.mask] * n, [d.tile_window] * n,
                              mp, **kw)


@pytest.mark.parametrize("name", ["pagerank", "sssp", "wcc", "bfs", "ppr"])
def test_engine_cuda_matches_torch_backend(dev, tmp_path, name):
    g = rmat_graph(20000, 300000, seed=23)
    root = str(tmp_path / "s")
    VSWEngine.from_graph(g, root, backend="numpy", device=dev, num_shards=6,
                         window=2048, k=32).close()
    out = {}
    for backend, resident in (("cuda", False), ("cuda", True), ("torch", False)):
        with VSWEngine.from_store(root, backend=backend, device=dev,
                                  batch_shards=3,
                                  device_resident=resident) as eng:
            out[backend, resident] = eng.run(apps.get_program(name),
                                             max_iters=15)
    ref = out["torch", False].values
    for key in (("cuda", False), ("cuda", True)):
        assert _close(out[key].values, ref, apps.get_program(name).combine,
                      rtol=1e-5, atol=1e-9), key
        # the device path: nothing staged, nothing copied back
        assert all(i.on_device and i.stage_s == i.copy_back_s == 0 < i.exec_s
                   for i in out[key].iterations)


@pytest.mark.parametrize("name", ["pagerank", "sssp"])
def test_engine_device_path_bitwise_host_path_on_the_card(dev, tmp_path, name):
    """A resident cuda engine keeps its vertex arrays on the card: bitwise
    the host path (the program without its device forms) on the card,
    which stages the messages and copies each accumulator back."""
    g = rmat_graph(1 << 16, 1 << 20, seed=7)
    root = str(tmp_path / "s")
    VSWEngine.from_graph(g, root, backend="numpy", device=dev, num_shards=8,
                         window=4096, k=128).close()
    program = apps.get_program(name)
    host = dataclasses.replace(program, pre_device=None, apply_device=None)
    with VSWEngine.from_store(root, backend="cuda", device=dev, batch_shards=4,
                              device_resident=True) as eng:
        on_card = eng.run(program, max_iters=20)
        on_host = eng.run(host, max_iters=20)
    assert on_card.values.tobytes() == on_host.values.tobytes()
    assert len(on_card.iterations) == len(on_host.iterations) > 1
    assert all(i.on_device and i.stage_s == i.copy_back_s == 0
               for i in on_card.iterations)
    assert not any(i.on_device for i in on_host.iterations)
    assert all(0 < i.stage_s + i.copy_back_s <= i.exec_s
               for i in on_host.iterations if i.shards_processed)
    assert all(i.ids_to_host == 0 for i in on_card.iterations if not i.selective_on)


# ------------------------------------------------------------------- lanes
def _lane_shards(dev, window, k, tr, n_shards=3, seed=42, graph="rmat"):
    g = rmat_graph(1500, 20000, seed=seed) if graph == "rmat" else star_graph(10_000)
    _, shards = preprocess(g, num_shards=n_shards)
    return g.num_vertices, [ell_to_device(csr_to_ell(s, g.num_vertices,
                                                     window=window, k=k, tr=tr),
                                          dev) for s in shards]


def _lane_msgs(dev, n_lanes, n_pad, combine, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.random((n_lanes, n_pad)).astype(np.float32)
    if combine != "sum":
        x[rng.random(x.shape) < 0.1] = np.inf if combine == "min" else -np.inf
    return torch.from_numpy(x).to(dev)


def _misaligned(t):
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


#: (graph, window, K, TR): the star hub fills its K=128 rows, so all 8
#: 16-slot groups hold values, and its K=1024 rows, where a thread of the
#: single-lane kernel folds two groups; W = 65536 takes int32 indices
LANE_CASES = [("rmat", 256, 8, 8), ("rmat", 512, 32, 8), ("rmat", 1024, 128, 8),
              ("star", 1024, 128, 8), ("star", 1024, 1024, 8),
              ("rmat", 1 << 16, 128, 8)]


@pytest.mark.parametrize("graph,window,k,tr", LANE_CASES)
@pytest.mark.parametrize("n_lanes", [1, 3, 8, 13, 16, 32, 33, 64])
@pytest.mark.parametrize("combine", COMBINES)
def test_lane_kernels_bitwise_single_lane_and_plain(dev, graph, window, k, tr,
                                                    n_lanes, combine):
    """Lane l of the lane kernels is bitwise the single-lane kernels on
    message row l (sum included), on the vector path and on the
    warp-per-row path, and matches the plain versions; 33 and 64 lanes
    cross a warp's 32."""
    _, ds = _lane_shards(dev, window, k, tr, n_shards=2 if graph == "star" else 3,
                         graph=graph)
    n_pad = ds[0].num_windows * ds[0].window
    msgs = _lane_msgs(dev, n_lanes, n_pad, combine)
    kw = dict(window=window, tr=tr, combine=combine)
    for planes in ((lambda t: t), _misaligned):
        idx = [planes(d.idx) for d in ds]
        mask = [planes(d.mask) for d in ds]
        tw = [d.tile_window for d in ds]
        part = K.ell_partials_lanes(idx, mask, tw, msgs, **kw)
        single = torch.stack([K.ell_partials_masked(idx, mask, tw, msgs[l], **kw)
                              for l in range(n_lanes)])
        assert torch.equal(part, single)
        plain = K.ell_partials_lanes_plain(idx, mask, tw, msgs, **kw)
        assert _close(part.cpu(), plain.cpu(), combine)
        perm, ptr = [d.perm for d in ds], [d.row_ptr for d in ds]
        acc = K.segment_combine_lanes(part, perm, ptr, (combine,))
        want = torch.stack([K.segment_combine(part[l].contiguous(), perm, ptr, combine)
                            for l in range(n_lanes)])
        assert torch.equal(acc, want)
        plain_acc = K.segment_combine_lanes_plain(
            part, perm, ptr, (combine,),
            torch.zeros(n_lanes, dtype=torch.int32, device=dev))
        assert _close(acc.cpu(), plain_acc.cpu(), combine)


def test_lane_stride_past_shared_memory_is_refused(dev):
    """At K=512 a warp of the lane partials keeps 32 accumulators of every
    lane in shared memory: 1,800 lanes fit a block's 227 KB and stay
    bitwise the single-lane kernel; 2,048 are refused before any launch,
    with the reason, and leave no error behind."""
    _, ds = _lane_shards(dev, 1024, 512, 8)
    n_pad = ds[0].num_windows * ds[0].window
    planes = ([d.idx for d in ds], [d.mask for d in ds], [d.tile_window for d in ds])
    kw = dict(window=1024, tr=8, combine="sum")
    msgs = _lane_msgs(dev, 1800, n_pad, "sum")
    part = K.ell_partials_lanes(*planes, msgs, **kw)
    for l in (0, 1, 1799):
        assert torch.equal(part[l], K.ell_partials_masked(*planes, msgs[l], **kw))
    before = K.ell_partials_lanes.launches
    with pytest.raises(RuntimeError, match="CUDA error 9: a lane stride of 2048 at K=512"):
        K.ell_partials_lanes(*planes, _lane_msgs(dev, 2048, n_pad, "sum"), **kw)
    assert K.ell_partials_lanes.launches == before
    assert torch.equal(K.ell_partials_lanes(*planes, msgs[:3], **kw), part[:3])


@pytest.mark.parametrize("counts,combines", [
    ((3, 5), ("min", "sum")), ((1, 1, 1), ("sum", "min", "max")),
    ((16, 16), ("min", "sum")), ((2, 4), ("min", "min")),
    ((2, 3, 4), ("min", "sum", "max"))])
def test_ragged_bitwise_multi_and_padding_zero(dev, counts, combines):
    """Ragged is bitwise the per-group launches and each lane bitwise the
    single-lane kernel with its arm; padding lanes are 0.  (2, 3, 4) puts
    three arms and a padding lane (10 lanes for 9) in one warp."""
    _, ds = _lane_shards(dev, 512, 32, 8, n_shards=4)
    n = ds[0].num_vertices
    rng = np.random.default_rng(11)
    groups = [rng.random((c, n)).astype(np.float32) for c in counts]
    before = (K.ell_partials_ragged.launches, K.segment_combine_lanes.launches)
    ragged = ops.ell_update_lanes_ragged(ds, groups, combines)
    assert (K.ell_partials_ragged.launches, K.segment_combine_lanes.launches) == (
        before[0] + 1, before[1] + 1)
    multi = ops.ell_update_lanes_multi(ds, groups, combines)
    for gr, gm in zip(ragged, multi):
        for a, b in zip(gr, gm):
            assert np.array_equal(a, b)
    ctx = ops.ragged_stage_lanes(groups, combines,
                                 ds[0].num_windows * ds[0].window, dev)
    acc = ops.ragged_dispatch(ds, ctx)
    assert ctx["k_pad"] >= ctx["k_total"]
    assert torch.count_nonzero(acc[ctx["k_total"]:]) == 0
    part = K.ell_partials_ragged([d.idx for d in ds], [d.mask for d in ds],
                                 [d.tile_window for d in ds], ctx["cids"],
                                 ctx["msgs"], window=512, tr=8,
                                 combines=ctx["combines"])
    assert torch.count_nonzero(part[ctx["k_total"]:]) == 0
    plain = K.ell_partials_ragged_plain(
        [d.idx for d in ds], [d.mask for d in ds], [d.tile_window for d in ds],
        ctx["cids"], ctx["msgs"], window=512, tr=8, combines=ctx["combines"])
    planes = ([d.idx for d in ds], [d.mask for d in ds], [d.tile_window for d in ds])
    for l, c in enumerate(K._lane_combines(ctx["cids"].cpu(), ctx["combines"])):
        assert _close(part[l].cpu(), plain[l].cpu(), c or "min")
        if c is not None:
            assert torch.equal(part[l], K.ell_partials_masked(
                *planes, ctx["msgs"].rows[l], window=512, tr=8, combine=c))


def _bits(t):
    """A float tensor's bits, so NaNs compare too."""
    return t.contiguous().view(torch.int32)


def _combine_case(dev, n_lanes, seed=13):
    """Lane-minor partials over a star hub (one destination row of 79
    partials, 9,999 empty rows) and a 20-shard R-MAT batch, with -0.0,
    +-inf and NaN among them: (part, perm, row_ptr) per case."""
    rng = np.random.default_rng(seed)
    cases = []
    for graph, n_shards in (("star", 1), ("rmat", 20)):
        _, ds = _lane_shards(dev, 1024, 128, 8, n_shards=n_shards, graph=graph)
        n_ell = sum(d.n_ell for d in ds)
        stride = -(-n_lanes // K.lane_chunk(n_lanes)) * K.lane_chunk(n_lanes)
        x = rng.standard_normal((n_ell, stride)).astype(np.float32)
        pick = rng.random(x.shape) < 0.02
        x[pick] = rng.choice(np.float32([-0.0, np.inf, -np.inf, np.nan]), int(pick.sum()))
        part = torch.from_numpy(x).to(dev).t()[:n_lanes]  # the lane kernels' layout
        cases.append((part, [d.perm for d in ds], [d.row_ptr for d in ds]))
    return cases


@pytest.mark.parametrize("n_lanes", [1, 3, 16, 31, 32, 33, 64, 100])
def test_lane_combine_bitwise_per_lane_segment_combine(dev, n_lanes):
    """Lane l of the lane combine is bitwise segment_combine on lane l, with
    one arm (each combine) and ragged (three arms cycling, the last lane
    padding, written as 0); a star hub's row folds 79 partials (over a
    batch of 32) and its other rows are empty; 20 shards in one launch.
    Against the plain version too (min/max bitwise)."""
    arms = ("min", "sum", "max")
    ids = [l % 3 for l in range(n_lanes - 1)] + [len(arms) if n_lanes > 1 else 0]
    cids = torch.tensor(ids, dtype=torch.int32, device=dev)
    lane_c = [arms[i] if i < len(arms) else None for i in ids]
    for part, perm, ptr in _combine_case(dev, n_lanes):
        for c in COMBINES:
            before = K.segment_combine_lanes.launches
            acc = K.segment_combine_lanes(part, perm, ptr, (c,))
            assert K.segment_combine_lanes.launches == before + 1
            want = torch.stack([K.segment_combine(part[l].contiguous(), perm, ptr, c)
                                for l in range(n_lanes)])
            assert torch.equal(_bits(acc), _bits(want))
            # a dense [L, n_ell] copy goes through the same kernel
            assert torch.equal(_bits(K.segment_combine_lanes(part.contiguous(), perm, ptr,
                                                             (c,))), _bits(want))
        acc = K.segment_combine_lanes(part, perm, ptr, arms, cids)
        plain = K.segment_combine_lanes_plain(part, perm, ptr, arms, cids)
        for l, c in enumerate(lane_c):
            if c is None:
                assert not acc[l].any()
                continue
            want = K.segment_combine(part[l].contiguous(), perm, ptr, c)
            assert torch.equal(_bits(acc[l]), _bits(want))
            # the plain min/max keep a NaN that fminf/fmaxf pass over, and
            # sums of standard normals need an absolute slack
            fin = torch.isfinite(want) & torch.isfinite(plain[l])
            assert _close(acc[l][fin].cpu(), plain[l][fin].cpu(), c, atol=1e-4)


#: (window, K): K = 16, 32 and 128 take the masked kernel's thread a row,
#: 512 and 1024 its vector body; W = 65536 takes int32 indices
MASKED_CASES = [(w, k) for k in (16, 32, 128, 512, 1024) for w in (1024, 1 << 16)]


@functools.lru_cache(maxsize=2)
def _masked_graphs(k):
    """A 4-shard R-MAT graph with tens of thousands of 32-row sets a shard
    (more warps than the card holds at once; fewer edges at larger K, so
    the mask plane stays under about 100 MB), and a star hub that fills
    whole rows: (graph, shards) pairs."""
    ne = 1 << 22 if k <= 32 else 1 << 20 if k <= 128 else 1 << 18
    out = []
    for g, n in ((rmat_graph(ne >> 4, ne, seed=31), 4), (star_graph(20_000), 1)):
        out.append((g, preprocess(g, num_shards=n)[1]))
    return out


@pytest.mark.parametrize("window,k", MASKED_CASES)
@pytest.mark.parametrize("combine", COMBINES)
def test_masked_partials_bitwise_lanes_sentinel_per_shard(dev, window, k, combine):
    """The masked partials (a thread a row at K <= 128, the vector body
    beyond) on a 4-shard R-MAT batch and a star hub: bitwise the lane
    kernel's lane rows, the sentinel kernel and one launch per shard; the
    plain version's values (min/max bitwise)."""
    for g, shards in _masked_graphs(k):
        ds = [ell_to_device(csr_to_ell(s, g.num_vertices, window=window, k=k, tr=8), dev)
              for s in shards]
        assert ds[0].idx.dtype == (torch.int16 if window <= 32767 else torch.int32)
        msgs = _lane_msgs(dev, 3, ds[0].num_windows * window, combine)
        planes = ([d.idx for d in ds], [d.mask for d in ds], [d.tile_window for d in ds])
        kw = dict(window=window, tr=8, combine=combine)
        part = K.ell_partials_masked(*planes, msgs[0], **kw)
        per_shard = torch.cat([K.ell_partials_masked(d.idx, d.mask, d.tile_window,
                                                     msgs[0], **kw) for d in ds])
        assert torch.equal(part, per_shard)
        lanes = K.ell_partials_lanes(*planes, msgs, **kw)
        for l in range(3):
            assert torch.equal(lanes[l], K.ell_partials_masked(*planes, msgs[l], **kw))
        table = ops.extend_windows(msgs[0], window, combine)
        sentinel = K.ell_partials_sentinel(
            [d.sentinel_idx() for d in ds], planes[2], table,
            window=window + ops.SENTINEL_PAD, tr=8, combine=combine)
        assert torch.equal(part, sentinel)
        plain = K.ell_partials_masked_plain(*planes, msgs[0], **kw)
        assert _close(part.cpu(), plain.cpu(), combine)


@pytest.mark.parametrize("combine", COMBINES)
def test_masked_partials_64_shards_one_launch(dev, combine):
    """64 shards (the most a launch takes) in one masked launch: bitwise
    one launch per shard, and the update bitwise too."""
    g = rmat_graph(40_000, 600_000, seed=17)
    _, shards = preprocess(g, num_shards=64)
    ds = [ell_to_device(csr_to_ell(s, g.num_vertices, window=1024, k=32, tr=8), dev)
          for s in shards]
    x = _lane_msgs(dev, 1, ds[0].num_windows * 1024, combine)[0]
    kw = dict(window=1024, tr=8, combine=combine)
    before = K.ell_partials_masked.launches
    part = K.ell_partials_masked([d.idx for d in ds], [d.mask for d in ds],
                                 [d.tile_window for d in ds], x, **kw)
    assert K.ell_partials_masked.launches == before + 1
    single = torch.cat([K.ell_partials_masked(d.idx, d.mask, d.tile_window, x, **kw)
                        for d in ds])
    assert torch.equal(part, single)
    assert torch.equal(ops.ell_update_batched(ds, x, combine),
                       torch.cat([ops.ell_update(d, x, combine) for d in ds]))


def test_service_on_the_card_ragged_multi_solo(dev, tmp_path):
    """The cuda service: ragged == multi bitwise, each query == its solo
    cuda engine run bitwise, and the launches equal the dispatches."""
    from repro_torch.serve import GraphService

    g = rmat_graph(20000, 300000, seed=29)
    root = str(tmp_path / "s")
    VSWEngine.from_graph(g, root, backend="numpy", device=dev, num_shards=6,
                         window=2048, k=32).close()
    cases = [("bfs", 3), ("sssp", 7), ("ppr", 11), ("wcc", 0), ("ppr", 5),
             ("bfs", 100)]
    out = {}
    for ragged in (True, False):
        K.ell_partials_ragged.launches = K.ell_partials_lanes.launches = 0
        with GraphService.from_store(root, backend="cuda", device=dev,
                                     batch_shards=4, max_lanes=4,
                                     ragged=ragged) as svc:
            with svc.submit_batch():
                futs = [svc.submit(p, s, max_iters=12) for p, s in cases]
            out[ragged] = [f.result(timeout=600) for f in futs]
            # a future resolves inside its sweep, before the sweep books
            # its stats
            deadline = time.monotonic() + 60
            while svc.stats()["sweeps"] < 1 and time.monotonic() < deadline:
                time.sleep(0.005)
            st = svc.last_sweep_stats
            assert svc.metrics_snapshot()["conservation_violations"] == []
        if ragged:
            assert K.ell_partials_ragged.launches == sum(
                s.ragged_dispatches for s in st)
        else:
            assert K.ell_partials_lanes.launches == sum(s.dispatches for s in st)
    f = lambda v: np.nan_to_num(v, posinf=1e30)
    for a, b in zip(out[True], out[False]):
        assert np.array_equal(f(a.values), f(b.values))
        assert (a.iterations, a.converged) == (b.iterations, b.converged)
    with VSWEngine.from_store(root, backend="cuda", device=dev,
                              batch_shards=4) as eng:
        for (p, s), qr in zip(cases, out[True]):
            kw = {} if p == "wcc" else {"source": s}
            ref = eng.run(apps.get_program(p, **kw), max_iters=12)
            assert np.array_equal(f(qr.values), f(ref.values)), (p, s)
            assert qr.iterations == ref.num_iterations


# ------------------------------------------------- live mutations, ingest
def _pack(src, dst):
    return (np.asarray(dst, np.int64) << 32) | np.asarray(src, np.int64)


def _mutate(src, dst, ins, dels):
    """Deletes (every copy) first, then inserts: the delta batch semantics."""
    tomb = np.unique(_pack(*dels))
    keep = ~np.isin(_pack(src, dst), tomb)
    return (np.concatenate([src[keep], np.asarray(ins[0], np.int32)]),
            np.concatenate([dst[keep], np.asarray(ins[1], np.int32)]))


def test_resident_service_with_updates_then_compaction(dev, tmp_path):
    """A resident cuda service after ``apply_updates``: every answer
    bitwise the numpy oracle on a from-scratch build of the mutated graph
    (PPR within rtol=1e-4, atol=1e-9), no dirty shard served from the
    resident map; after ``compact()`` every shard resident again and the
    answers unchanged."""
    from repro_torch.core.graph import Graph
    from repro_torch.obs import trace
    from repro_torch.obs.trace import Tracer
    from repro_torch.serve import GraphService

    g = rmat_graph(2000, 30000, seed=61)
    rng = np.random.default_rng(62)
    ins = (rng.integers(0, 2000, 300), rng.integers(0, 2000, 300))
    take = rng.choice(g.num_edges, 100, replace=False)
    dels = (g.src[take], g.dst[take])
    src, dst = _mutate(g.src, g.dst, ins, dels)
    cases = [("bfs", 3), ("sssp", 7), ("wcc", 0), ("ppr", 11), ("bfs", 500)]
    oracle = {}
    with VSWEngine.from_graph(Graph(2000, src, dst), str(tmp_path / "o"),
                              num_shards=6, window=256, k=16, backend="numpy",
                              device=dev) as eng:
        for p, v in cases:
            kw = {} if p == "wcc" else {"source": v}
            oracle[p, v] = eng.run(apps.get_program(p, **kw), max_iters=15).values
    f = lambda v: np.nan_to_num(v, posinf=1e30)

    def check(res):
        for (p, v), qr in zip(cases, res):
            if p == "ppr":
                assert np.allclose(qr.values, oracle[p, v], rtol=1e-4, atol=1e-9)
            else:
                assert np.array_equal(f(qr.values), f(oracle[p, v])), (p, v)

    def ask(svc):
        with svc.submit_batch():
            futs = [svc.submit(p, v, max_iters=15) for p, v in cases]
        return [fut.result(timeout=600) for fut in futs]

    svc = GraphService.from_graph(g, str(tmp_path / "s"), num_shards=6,
                                  window=256, k=16, backend="cuda", device=dev,
                                  device_resident=True, batch_shards=4,
                                  max_lanes=8, session_entries=0)
    try:
        ask(svc)
        assert sorted(svc.engine._device_shards) == list(range(6))
        upd = svc.apply_updates(inserts=ins, deletes=dels).result(timeout=600)
        dirty = set(upd.shards_touched)
        assert upd.graph_version == 1 and dirty
        with trace.tracing(Tracer()) as tr:
            res = ask(svc)
        check(res)
        loads = [e["args"] for e in tr.export_chrome()["traceEvents"]
                 if e.get("name") == "shard.load"]
        assert loads and all(a["logical"] == (a["shard"] in dirty) for a in loads)
        assert not any(a["from_resident"] and a["shard"] in dirty for a in loads)
        assert not dirty & set(svc.engine._device_shards)
        assert svc.compact().shards_compacted == len(dirty)
        assert svc.stats()["dirty_shards"] == 0
        svc.bump_graph_version()
        res2 = ask(svc)
        check(res2)
        for a, b in zip(res, res2):
            assert np.array_equal(f(a.values), f(b.values))
        assert sorted(svc.engine._device_shards) == list(range(6))
        with trace.tracing(Tracer()) as tr:
            check(ask(svc))
        loads = [e["args"] for e in tr.export_chrome()["traceEvents"]
                 if e.get("name") == "shard.load"]
        assert loads and all(a["from_resident"] for a in loads)
    finally:
        svc.close()


def test_from_edge_file_on_the_card_equals_from_graph(dev, tmp_path):
    from repro_torch.core.ingest import write_edge_file

    g = rmat_graph(2000, 30000, seed=63)
    path = str(tmp_path / "e.bin")
    write_edge_file(path, g.src, g.dst)
    kw = dict(num_shards=5, window=256, k=16, backend="cuda", device=dev,
              batch_shards=2)
    with VSWEngine.from_graph(g, str(tmp_path / "m"), **kw) as mem, \
            VSWEngine.from_edge_file(path, str(tmp_path / "i"), chunk_edges=4096,
                                     mem_budget_bytes=1 << 14,
                                     num_vertices=g.num_vertices, **kw) as ing:
        for prog in (apps.pagerank(), apps.bfs(0), apps.wcc()):
            a, b = mem.run(prog, max_iters=10), ing.run(prog, max_iters=10)
            assert np.array_equal(a.values, b.values)
            assert a.num_iterations == b.num_iterations


def test_pulse_closed_loop_on_a_resident_service_is_bitwise_solo(dev, tmp_path):
    """The load harness's closed loop against a card-resident ``cuda``
    service with the telemetry ticker and SLOs on: every record bitwise a
    solo resident ``cuda`` engine on the same store, the lane kernels
    launched, no conservation violation, the exports parse."""
    from repro_torch.obs import (error_rate_slo, latency_slo, parse_prometheus,
                                 prometheus_text)
    from repro_torch.serve import (GraphService, LoadGenerator, QueryClass,
                                   Workload, oracle_kwargs)

    g = rmat_graph(4000, 60000, seed=64)
    root = str(tmp_path / "s")
    kw = dict(backend="cuda", device=dev, device_resident=True, batch_shards=4)
    svc = GraphService.from_graph(g, root, num_shards=6, window=256, k=16,
                                  max_lanes=16, max_groups=2,
                                  session_entries=0, **kw)
    wl = Workload(classes=(QueryClass("bfs", weight=2.0, max_iters=6),
                           QueryClass("sssp", max_iters=6),
                           QueryClass("wcc", max_iters=6),
                           QueryClass("ppr", max_iters=6,
                                      params={"damping": 0.85})), seed=29)
    lanes = (K.ell_partials_ragged.launches, K.segment_combine_lanes.launches)
    try:
        svc.start_telemetry(interval_s=0.05, slos=[
            latency_slo("latency_p99", threshold_s=60.0, budget=0.01),
            error_rate_slo("admission_errors", budget=0.05)])
        rep = LoadGenerator(svc, wl, mode="closed", concurrency=8, batch_size=4,
                            total_ops=48, warmup_ops=8).run()
        ts = svc.stop_telemetry()
        snap = svc.metrics_snapshot()
        prom = parse_prometheus(prometheus_text(svc.metrics))
    finally:
        svc.close()
    assert rep.completed == 40 and rep.errors == 0 and ts.num_windows >= 1
    assert K.ell_partials_ragged.launches > lanes[0]
    assert K.segment_combine_lanes.launches > lanes[1]
    assert snap["conservation_violations"] == []
    assert prom["graphmp_query_completed"] == 48.0
    f = lambda v: np.nan_to_num(v, posinf=1e30)
    with VSWEngine.from_store(root, **kw) as solo:
        for r in rep.records:
            want = solo.run(apps.get_program(r.program, **oracle_kwargs(r)),
                            max_iters=r.max_iters)
            assert r.ok and np.array_equal(f(r.values), f(want.values)), (
                r.program, r.source)
            assert (r.iterations, r.converged) == (want.num_iterations,
                                                   want.converged)


# --------------------------------------------------------- flash attention
FLASH_TOL = {torch.float32: 2e-3, torch.bfloat16: 5e-2}  # tests/test_kernels.py
#: bf16 outputs also within two bf16 ulps at the top of their range: the
#: absolute 5e-2 is loose against outputs that average many values
BF16_TOP_ULPS = 2.0 ** -6


def _check_flash(out, want, dtype):
    """Kernel vs plain: the reference's tolerance and, for bf16, the
    tighter max |out - want| <= 2^-6 max |want|."""
    a, b = out.float(), want.float()
    assert out.dtype == dtype and out.shape == want.shape
    assert torch.isfinite(a).all()
    tol = FLASH_TOL[dtype]
    err = float((a - b).abs().max())
    assert torch.allclose(a, b, rtol=tol, atol=tol), err
    if dtype == torch.bfloat16:
        assert err <= BF16_TOP_ULPS * float(b.abs().max()), err


def _misaligned(t):
    """``t``'s values in a view 2 bytes off a 16 B boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return buf.view(t.shape).copy_(t)


def _flash_inputs(dev, dtype, B, Hq, Hkv, Sq, Skv, D, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g).to(dev, dtype)
    return mk(B, Hq, Sq, D), mk(B, Hkv, Skv, D), mk(B, Hkv, Skv, D)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D", [
    (2, 16, 2, 24, 24, 128), (1, 16, 2, 512, 512, 128),
    (1, 8, 1, 100, 300, 128), (2, 4, 4, 65, 65, 64), (1, 4, 2, 33, 33, 16),
    (1, 2, 1, 70, 70, 100), (1, 4, 1, 130, 130, 256)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(dev, B, Hq, Hkv, Sq, Skv, D,
                                              causal, dtype):
    from repro_torch.kernels.flash_attention import kernel as FK

    q, k, v = _flash_inputs(dev, dtype, B, Hq, Hkv, Sq, Skv, D)
    before = FK.flash_attention.launches
    before_tc = FK.flash_attention.tc_launches
    out = FK.flash_attention(q, k, v, causal=causal)
    assert FK.flash_attention.launches == before + 1
    tc = dtype == torch.bfloat16 and D in FK.TC_HEAD_DIMS
    assert FK.flash_attention.tc_launches == before_tc + tc
    want = FK.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    _check_flash(out, want, dtype)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal", [
    (1, 8, 1, 100, 300, 64, True), (2, 16, 2, 130, 130, 128, True),
    (2, 16, 2, 130, 200, 128, False), (1, 4, 1, 77, 333, 256, True),
    (1, 4, 2, 200, 70, 256, False), (2, 8, 1, 64, 64, 128, False),
    (1, 2, 1, 1, 65, 128, True), (1, 16, 2, 700, 700, 128, True),
    (1, 8, 1, 768, 768, 256, True), (2, 16, 16, 1, 300, 256, True),
    (1, 16, 16, 100, 333, 256, False), (2, 4, 2, 70, 70, 256, True)])
def test_flash_attention_tensor_core_path(dev, B, Hq, Hkv, Sq, Skv, D, causal):
    """The bf16 tensor-core kernel: ragged Sq and Skv, queries as the key
    suffix, GQA 8:1, D 64/128 on one warpgroup a CTA and 256 on two (MQA
    8:1 at PaliGemma's S=768, MHA at Sq=1 and at Sq < Skv non-causal, a
    ragged tail of 70 keys); the model's transposed views and a repeat
    bitwise the same; only calls on the dispatch rule count."""
    from repro_torch.kernels.flash_attention import kernel as FK

    q, k, v = _flash_inputs(dev, torch.bfloat16, B, Hq, Hkv, Sq, Skv, D, seed=3)
    tc = D in FK.TC_HEAD_DIMS
    before, before_tc = FK.flash_attention.launches, FK.flash_attention.tc_launches
    out = FK.flash_attention(q, k, v, causal=causal)
    assert FK.flash_attention.tc_launches == before_tc + tc
    _check_flash(out, FK.flash_attention_plain(q, k, v, causal=causal), torch.bfloat16)
    assert torch.equal(out, FK.flash_attention(q, k, v, causal=causal))
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
    assert torch.equal(out, FK.flash_attention(*views, causal=causal))
    assert FK.flash_attention.tc_launches == before_tc + 3 * tc
    # off the rule: the scalar kernel, the same function
    off = FK.flash_attention(q, _misaligned(k), v, causal=causal)
    _check_flash(off, out, torch.bfloat16)
    FK.flash_attention(q.float(), k.float(), v.float(), causal=causal)
    assert FK.flash_attention.tc_launches == before_tc + 3 * tc
    assert FK.flash_attention.launches == before + 5


def test_flash_attention_strided_views_and_rejects(dev):
    """The model's transposed views go in without a copy and give the
    contiguous inputs' bits; bad inputs raise on the card."""
    from repro_torch.kernels.flash_attention import kernel as FK

    q, k, v = _flash_inputs(dev, torch.bfloat16, 2, 8, 2, 40, 40, 64)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
    assert not views[0].is_contiguous()
    assert torch.equal(FK.flash_attention(*views), FK.flash_attention(q, k, v))
    with pytest.raises(TypeError):
        FK.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head dim"):
        FK.flash_attention(*_flash_inputs(dev, torch.float32, 1, 2, 1, 8, 8, 300))
    with pytest.raises(ValueError, match="more queries"):
        FK.flash_attention(torch.cat([q, q], dim=2), k, v, causal=True)
    with pytest.raises(ValueError, match="different devices"):
        FK.flash_attention(q.cpu(), k, v)


def test_lm_prefill_cuda_matches_torch_on_the_card(dev):
    """A smoke-config prefill through the kernel and through the plain path,
    on the same weights: the kernel is launched once a layer."""
    from repro_torch import configs
    from repro_torch.config import smoke_config
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch import serve as S
    from repro_torch.models import model as M

    cfg = smoke_config(configs.get_config("qwen2.5-3b"))
    params = M.init_params(0, cfg, dtype=torch.float32, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (4, 200), device=dev)
    FK.flash_attention.launches = 0
    got, gc = M.prefill(params, {"tokens": tokens}, cfg, ShardingCtx(attn_impl="cuda"))
    assert FK.flash_attention.launches == cfg.num_layers
    want, wc = M.prefill(params, {"tokens": tokens}, cfg, ShardingCtx(attn_impl="torch"))
    assert FK.flash_attention.launches == cfg.num_layers
    assert torch.allclose(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    prompts = S.make_prompts(cfg, 3, 24, seed=0)
    a = S.serve(params, cfg, ShardingCtx(), prompts, batch=2, gen_len=6)
    b = S.serve(params, cfg, ShardingCtx(), prompts, batch=2, gen_len=6)
    assert all(np.array_equal(x, y) for x, y in zip(a.done, b.done))


def test_flash_kernel_raises_under_gradients(dev):
    """The kernel has no backward: on CUDA inputs that require gradients the
    cuda entry raises (nothing launched, no fall back to the plain path);
    without gradients it runs as before."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import attention

    q, k, v = _flash_inputs(dev, torch.bfloat16, 2, 8, 2, 64, 64, 64)
    before = FK.flash_attention.launches
    for t in (q, k, v):
        qg, kg, vg = (x.clone().requires_grad_(x is t) for x in (q, k, v))
        with pytest.raises(RuntimeError, match="no backward"):
            attention(qg, kg, vg, impl="cuda")
    assert FK.flash_attention.launches == before
    qg = q.clone().requires_grad_(True)
    with torch.no_grad():
        assert torch.equal(attention(qg, k, v, impl="cuda"), FK.flash_attention(q, k, v))
    assert FK.flash_attention.launches == before + 2
    out = attention(qg, k, v, impl="torch")  # the plain path trains
    out.float().sum().backward()
    assert qg.grad is not None and torch.isfinite(qg.grad.float()).all()


def test_train_step_on_the_card_matches_the_cpu(dev):
    """One step at the smoke width on the card and on the CPU from the same
    parameters, step-3 moments and batch: loss rtol 1e-3, grad_norm rtol
    1e-2, and what the step changed in each parameter, m and v leaf (p - p0,
    m - b1 m0, v - b2 v0) within 0.1 x its largest change plus 2 ulps of the
    value (bf16 activations: tests/test_torch_train.py)."""
    from repro_torch import configs
    from repro_torch.config import smoke_config
    from repro_torch.data.tokens import DataConfig, make_batch
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step

    cfg = smoke_config(configs.get_config("qwen2.5-3b"))
    batch = make_batch(DataConfig(seq_len=64, global_batch=4,
                                  vocab_size=cfg.vocab_size, seed=7), 0)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=12)
    out = {}
    for device in ("cpu", dev):
        model = M.init_params(7, cfg, dtype=torch.float32, device="cpu")
        gen = torch.Generator().manual_seed(7)
        named = dict(model.named_parameters())
        state = adamw.init(named)
        for n, p in named.items():
            state.m[n].copy_(torch.randn(p.shape, generator=gen) * 1e-4)
            state.v[n].copy_(1e-4 * (1 + torch.rand(p.shape, generator=gen)))
        state.step = 3
        base = {"params": {n: p.clone() for n, p in named.items()},
                "m": {n: opt.b1 * t for n, t in state.m.items()},
                "v": {n: opt.b2 * t for n, t in state.v.items()}}
        model = model.to(device)
        state.m = {n: t.to(device) for n, t in state.m.items()}
        state.v = {n: t.to(device) for n, t in state.v.items()}
        step = make_train_step(cfg, ShardingCtx(attn_impl="torch"), opt)
        _, state, _, met = step(model, state, None, batch)
        out[str(device)] = (met, {k: {n: t.detach().cpu() for n, t in ts.items()}
                                  for k, ts in (("params", dict(model.named_parameters())),
                                                ("m", state.m), ("v", state.v))})
    (cm, ct), (gm, gt) = out["cpu"], out[str(dev)]
    assert np.isclose(float(gm["loss"]), float(cm["loss"]), rtol=1e-3, atol=0)
    assert np.isclose(float(gm["grad_norm"]), float(cm["grad_norm"]), rtol=1e-2, atol=0)
    for kind in ct:
        for n, want in ct[kind].items():
            top = float((want - base[kind][n]).abs().max())
            err = (gt[kind][n] - want).abs() - 2 * torch.from_numpy(
                np.spacing(want.abs().numpy()))
            assert float(err.max()) <= 0.1 * top, (kind, n, float(err.max()), top)
    with pytest.raises(ValueError, match="no backward"):
        make_train_step(cfg, ShardingCtx(attn_impl="cuda"), adamw.AdamWConfig())


def _routes(run, record=None):
    """``run()``'s MoE routings (each call's top-k experts), or ``run()``
    with each call routed to ``record``'s experts, gates from its own
    probabilities."""
    from repro_torch.models import moe as MOE

    inner, calls = MOE._route, []

    def route(x, router_w, cfg):
        probs, gates, eidx = inner(x, router_w, cfg)
        if record is None:
            calls.append(eidx)
            return probs, gates, eidx
        want = record[len(calls)]
        calls.append(want)
        g = probs.gather(-1, want)
        return probs, g / g.sum(-1, keepdim=True).clamp(min=1e-9), want

    MOE._route = route
    try:
        out = run()
    finally:
        MOE._route = inner
    return calls if record is None else out


FAMILIES = ["jamba-1.5-large-398b", "moonshot-v1-16b-a3b", "paligemma-3b",
            "phi3.5-moe-42b-a6.6b", "whisper-large-v3", "xlstm-350m"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_lm_family_serves_on_the_card(dev, arch):
    """Each arch's smoke config through the launcher on the card: prefill
    logits with the kernel against the plain attention on the same
    weights and frontend inputs; one flash launch per self-attention layer
    at prefill, plus whisper's encoder layers and its cross-attention at
    prefill and at every decode step, each on the arm its head dim names;
    the MoE archs repeat bitwise."""
    from repro_torch import configs
    from repro_torch.config import smoke_config
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch import serve as S
    from repro_torch.models import model as M

    cfg = smoke_config(configs.get_config(arch))
    params = M.init_params(0, cfg, dtype=torch.float32, device=dev)

    def run():
        rng = np.random.default_rng(0)
        prompts = S.make_prompts(cfg, 3, 40, rng)
        return prompts, S.serve(params, cfg, ShardingCtx(attn_impl="cuda"), prompts,
                                batch=2, gen_len=5, keep_logits=True, rng=rng)

    FK.flash_attention.launches = FK.flash_attention.tc_launches = 0
    prompts, res = run()
    attn = sum(cfg.layer_kind(i % cfg.group_period)[0] == "attn"
               for i in range(cfg.num_layers))
    cross = attn if cfg.encdec else 0
    want = res.batches * (attn + cfg.num_encoder_layers * cfg.encdec + cross + 4 * cross)
    assert FK.flash_attention.launches == want
    assert FK.flash_attention.tc_launches == (want if cfg.head_dim in FK.TC_HEAD_DIMS
                                              else 0)
    rng = np.random.default_rng(0)
    S.make_prompts(cfg, 3, 40, rng)
    first = {"tokens": torch.from_numpy(np.stack(prompts[::-1][:2])).to(dev)}
    first.update((k, torch.from_numpy(v).to(dev))
                 for k, v in S.frontend_inputs(cfg, rng, 2).items())
    with torch.inference_mode():
        if cfg.num_experts:
            # the plain run takes the kernel run's experts (its own gates):
            # a near tie in the router's top-k turns a one-ulp difference of
            # the two attention paths into another expert
            routes = _routes(lambda: M.prefill(params, first, cfg,
                                               ShardingCtx(attn_impl="cuda")))
            ref = _routes(lambda: M.prefill(params, first, cfg,
                                            ShardingCtx(attn_impl="torch")), routes)[0]
        else:
            ref, _ = M.prefill(params, first, cfg, ShardingCtx(attn_impl="torch"))
    got, ref = res.logits[0][0], ref.float().cpu().numpy()
    assert np.isfinite(got).all()
    assert np.allclose(got, ref, rtol=2e-2, atol=2e-2 * max(1.0, np.abs(ref).max()))
    if cfg.num_experts:
        _, again = run()
        assert all(np.array_equal(x, y) for x, y in zip(res.done, again.done))
        assert all(np.array_equal(x, y) for bx, by in zip(res.logits, again.logits)
                   for x, y in zip(bx, by))


# ----------------------------------------------------------- entry kernels
@pytest.mark.parametrize("window,k,tr", [(256, 8, 8), (512, 32, 8),
                                         (16384, 128, 8)])
@pytest.mark.parametrize("combine", COMBINES)
def test_sentinel_bitwise_masked_and_batched(dev, window, k, tr, combine):
    """Sentinel partials and updates are bitwise the masked ones, against
    the plain version too; a batch is bitwise one launch per shard."""
    nv, shards = _lane_shards(dev, window, k, tr)
    x = _lane_msgs(dev, 1, shards[0].num_windows * window, combine)[0]
    table = ops.extend_windows(x, window, combine)
    kw = dict(window=window + ops.SENTINEL_PAD, tr=tr, combine=combine)
    for d in shards:
        before = K.ell_partials_sentinel.launches
        part = K.ell_partials_sentinel(d.sentinel_idx(), d.tile_window, table, **kw)
        assert K.ell_partials_sentinel.launches == before + 1
        masked = K.ell_partials_masked(d.idx, d.mask, d.tile_window, x,
                                       window=window, tr=tr, combine=combine)
        assert torch.equal(part, masked)
        plain = K.ell_partials_sentinel_plain(d.sentinel_idx(), d.tile_window,
                                              table, **kw)
        assert _close(part.cpu(), plain.cpu(), combine)
    batched = ops.ell_update_batched(shards, x, combine, variant="sentinel")
    single = torch.cat([ops.ell_update(d, x, combine, variant="sentinel")
                        for d in shards])
    assert torch.equal(batched, single)
    assert torch.equal(batched, ops.ell_update_batched(shards, x, combine))


def _bloom_filters(n_filters=5, seed=8):
    from repro_torch.core.bloom import BloomFilter32

    rng = np.random.default_rng(seed)
    return [BloomFilter32.build(rng.choice(1 << 22, n, replace=False),
                                num_hashes=h)
            for n, h in zip(rng.integers(50, 20000, n_filters), (2, 4, 4, 7, 8) * 20)]


def test_bloom_kernel_bitwise_plain_and_host(dev):
    from repro_torch.kernels.bloom import kernel as BK
    from repro_torch.kernels.bloom import ops as bops

    rng = np.random.default_rng(9)
    filters = _bloom_filters()
    ids = np.concatenate([[0, -1, -2**31, 2**31 - 1],
                          rng.integers(-2**31, 2**31, 10_003, dtype=np.int64)]
                         ).astype(np.int32)
    staged = bops.stage_filters(filters, dev)
    items = torch.from_numpy(ids).to(dev)
    kw = dict(num_bits=staged.num_bits, num_hashes=staged.num_hashes)
    before = BK.bloom_contains.launches
    bits = BK.bloom_contains(staged.words, items, **kw)
    assert BK.bloom_contains.launches == before + 1
    assert torch.equal(bits, BK.bloom_contains_plain(staged.words, items, **kw))
    for p, f in enumerate(filters):
        assert np.array_equal(bits[p].cpu().numpy(), f.contains(ids))
        assert np.array_equal(bops.contains(f, ids, device=dev), f.contains(ids))
    assert bops.contains(filters[0], np.array([], np.int32), device=dev).shape == (0,)


@pytest.mark.parametrize("n_filters,n_ids", [(5, 1), (5, 3000), (70, 100_000),
                                             (40, 2_000_000)])
def test_any_active_one_launch_equals_per_filter(dev, n_filters, n_ids):
    from repro_torch.kernels.bloom import kernel as BK
    from repro_torch.kernels.bloom import ops as bops

    filters = _bloom_filters(n_filters)
    ids = np.random.default_rng(10).integers(0, 1 << 22, n_ids).astype(np.int32)
    before = BK.bloom_contains.launches
    out = bops.any_active_shards(filters, ids, device=dev)
    assert BK.bloom_contains.launches == before + -(-n_filters // BK.MAX_FILTERS)
    assert np.array_equal(out, [f.any_member(ids) for f in filters])
    staged = bops.stage_filters(filters, dev)
    items = torch.from_numpy(ids).to(dev)
    loop = [bool(BK.bloom_contains(w, items, num_bits=b, num_hashes=h).any())
            for w, b, h in zip(staged.words, staged.num_bits, staged.num_hashes)]
    assert out.tolist() == loop
    assert not bops.any_active_shards(filters, np.array([], np.int32), device=dev).any()


def _decode_inputs(dev, dtype, BH, G, S, D, lens, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g).to(dev, dtype)
    valid = torch.arange(S)[None, :] < torch.tensor(lens)[:, None]
    return mk(BH, G, D), mk(BH, S, D), mk(BH, S, D), valid.to(dev)


@pytest.mark.parametrize("BH,G,S,D,lens", [
    (8, 8, 544, 128, [513] * 8), (8, 8, 5000, 128, [1, 5000, 0, 2500, 4999, 7, 128, 129]),
    (2, 1, 1, 128, [1, 0]), (3, 4, 384, 64, [384, 0, 100]), (2, 16, 300, 256, [300, 37]),
    (2, 5, 77, 80, [77, 3]), (1, 32, 130, 64, [130])])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_matches_plain(dev, BH, G, S, D, lens, dtype):
    from repro_torch.kernels.flash_attention import kernel as FK

    q, k, v, valid = _decode_inputs(dev, dtype, BH, G, S, D, lens)
    before, before_tc = FK.flash_decode.launches, FK.flash_decode.tc_launches
    out = FK.flash_decode(q, k, v, valid)
    assert FK.flash_decode.launches == before + 1
    tc = dtype == torch.bfloat16 and D in FK.DECODE_TC_HEAD_DIMS and G <= 16
    assert FK.flash_decode.tc_launches == before_tc + tc
    want = FK.flash_decode_plain(q, k, v, valid)
    torch.cuda.synchronize()
    _check_flash(out, want, dtype)
    for b, n in enumerate(lens):
        if n == 0:
            assert not out[b].any()
    assert torch.equal(out, FK.flash_decode(q, k, v, valid))  # deterministic


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_fused_merge_repeats_across_streams(dev, dtype):
    """One launch merges the splits (the last CTA of a row, by ticket):
    bitwise the same on repeat and on two streams used in turn, whose
    tickets are apart; an all-invalid row gives 0."""
    from repro_torch.kernels.flash_attention import kernel as FK

    BH, G, S, D = 8, 8, 32768, 128
    lens = [S, 0, 1, 12345, 64, 65, S - 1, 30000]
    q, k, v, valid = _decode_inputs(dev, dtype, BH, G, S, D, lens, seed=4)
    assert FK.decode_splits(S, BH, D)[0] > 1
    before = FK.flash_decode.launches
    first = FK.flash_decode(q, k, v, valid)
    assert FK.flash_decode.launches == before + 1
    _check_flash(first, FK.flash_decode_plain(q, k, v, valid), dtype)
    assert not first[1].any()
    outs = []
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    torch.cuda.synchronize()
    for i in range(6):
        with torch.cuda.stream(streams[i % 2]):
            outs.append(FK.flash_decode(q, k, v, valid))
    torch.cuda.synchronize()
    for out in outs:
        assert torch.equal(out, first)
    assert torch.equal(first, FK.flash_decode(q, k, v, valid))


def test_flash_decode_misaligned_views(dev):
    """q, k or v 2 bytes off a 16 B boundary: the scalar kernel, the plain
    version's result; the ring kernel is not launched."""
    from repro_torch.kernels.flash_attention import kernel as FK

    q, k, v, valid = _decode_inputs(dev, torch.bfloat16, 4, 8, 700, 128,
                                    [700, 0, 333, 64], seed=5)
    want = FK.flash_decode_plain(q, k, v, valid)
    before_tc = FK.flash_decode.tc_launches
    for args in ((_misaligned(q), k, v), (q, _misaligned(k), v), (q, k, _misaligned(v))):
        assert not FK.decode_uses_tensor_cores(*args)
        _check_flash(FK.flash_decode(*args, valid), want, torch.bfloat16)
    assert FK.flash_decode.tc_launches == before_tc
    _check_flash(FK.flash_decode(q, k, v, valid), want, torch.bfloat16)
    assert FK.flash_decode.tc_launches == before_tc + 1


def test_entry_kernels_reject_bad_inputs(dev):
    from repro_torch.kernels.bloom import kernel as BK
    from repro_torch.kernels.flash_attention import kernel as FK

    q, k, v, valid = _decode_inputs(dev, torch.float32, 2, 4, 16, 64, [16, 3])
    with pytest.raises(TypeError):
        FK.flash_decode(q.half(), k.half(), v.half(), valid)
    with pytest.raises(ValueError, match="contiguous"):
        FK.flash_decode(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, valid)
    with pytest.raises(ValueError, match="group"):
        FK.flash_decode(q.repeat(1, 9, 1), k, v, valid)
    with pytest.raises(ValueError, match="different devices"):
        FK.flash_decode(q.cpu(), k, v, valid)
    words = torch.zeros(4, dtype=torch.int32, device=dev)
    items = torch.zeros(8, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        BK.bloom_contains(words, items.long(), num_bits=128, num_hashes=4)
    with pytest.raises(ValueError, match="power of two"):
        BK.bloom_contains(words, items, num_bits=96, num_hashes=4)
    with pytest.raises(ValueError, match="table"):
        BK.bloom_contains(words, items, num_bits=256, num_hashes=4)
    with pytest.raises(ValueError, match="num_hashes"):
        BK.bloom_contains(words, items, num_bits=128, num_hashes=17)
    nv, shards = _lane_shards(dev, 256, 8, 8, n_shards=1)
    d = shards[0]
    table = ops.extend_windows(torch.zeros(d.num_windows * 256, device=dev), 256, "sum")
    with pytest.raises(TypeError):
        K.ell_partials_sentinel(d.sentinel_idx(), d.tile_window, table.double(),
                                window=256 + ops.SENTINEL_PAD, tr=8, combine="sum")
    with pytest.raises(ValueError, match="whole windows"):
        K.ell_partials_sentinel(d.sentinel_idx(), d.tile_window, table[:-1],
                                window=256 + ops.SENTINEL_PAD, tr=8, combine="sum")
    with pytest.raises(ValueError):
        K.ell_partials_sentinel(d.sentinel_idx()[:3], d.tile_window, table,
                                window=256 + ops.SENTINEL_PAD, tr=8, combine="sum")


@functools.lru_cache(maxsize=1)
def _combine_graphs():
    """A star hub whose destination row folds about 1,000 partials (its
    other rows empty) and a 64-shard R-MAT graph (the most shards a launch
    takes; rows of every length up to hundreds): (graph, shards) pairs."""
    out = []
    for g, n in ((star_graph(128_001), 1), (rmat_graph(40_000, 600_000, seed=23), 64)):
        out.append((g, preprocess(g, num_shards=n)[1]))
    return out


@pytest.mark.parametrize("combine", COMBINES)
def test_segment_combine_bitwise_lane_form_per_shard_and_plain(dev, combine):
    """segment_combine (4 threads a row, the warp a long one) on a
    1,000-partial hub row with empty rows around it and on 64 shards in one
    launch, partials with -0.0, +-inf and NaN: bitwise the lane combine at
    one lane (the warp-per-row order) and one launch per shard; against
    the plain version min/max bitwise where both are finite or infinite
    (the plain version keeps a NaN that fminf/fmaxf pass over), sum within
    tolerance."""
    rng = np.random.default_rng(29)
    for g, shards in _combine_graphs():
        ds = [ell_to_device(csr_to_ell(s, g.num_vertices, window=1024, k=128, tr=8), dev)
              for s in shards]
        perm, ptr = [d.perm for d in ds], [d.row_ptr for d in ds]
        longest = max(int((d.row_ptr[1:] - d.row_ptr[:-1]).max()) for d in ds)
        if len(ds) == 1:
            assert longest >= 1000 and int((ds[0].row_ptr[1:] == ds[0].row_ptr[:-1]).sum()) > 0
        n_ell = sum(d.n_ell for d in ds)
        x = (rng.standard_normal(n_ell) * 10.0 ** rng.integers(-3, 4, n_ell)).astype(np.float32)
        pick = rng.random(n_ell) < 0.02
        x[pick] = rng.choice(np.float32([-0.0, np.inf, -np.inf, np.nan]), int(pick.sum()))
        part = torch.from_numpy(x).to(dev)
        before = K.segment_combine.launches
        acc = K.segment_combine(part, perm, ptr, combine)
        assert K.segment_combine.launches == before + 1
        lanes = K.segment_combine_lanes(part[None], perm, ptr, (combine,))
        assert torch.equal(_bits(acc), _bits(lanes[0]))
        starts = np.cumsum([0] + [d.n_ell for d in ds])
        single = torch.cat([K.segment_combine(part[a:b], [d.perm], [d.row_ptr], combine)
                            for d, a, b in zip(ds, starts[:-1], starts[1:])])
        assert torch.equal(_bits(acc), _bits(single))
        plain = K.segment_combine_plain(part, perm, ptr, combine)
        fin = ~torch.isnan(acc) & ~torch.isnan(plain)
        assert _close(acc[fin].cpu(), plain[fin].cpu(), combine, atol=1e-2)


def _bloom_sized_filters(n_filters, seed=31):
    """Filters of 2^10 to 2^23 bits, num_hashes cycling 1, 4, 16, each
    over a random member set filling about a third of its bits: (filters,
    member sets)."""
    from repro_torch.core.bloom import BloomFilter32

    rng = np.random.default_rng(seed)
    out, members = [], []
    for p in range(n_filters):
        nb, nh = 1 << int(10 + p % 14), (1, 4, 16)[p % 3]
        f = BloomFilter32(words=np.zeros(nb // 32, dtype=np.uint32), num_bits=nb,
                          num_hashes=nh)
        members.append(rng.integers(-2**31, 2**31, max(1, nb // (3 * nh)),
                                    dtype=np.int64).astype(np.int32))
        f.add(members[-1])
        out.append(f)
    return out, members


@pytest.mark.parametrize("n", [1, 31, 1025, (1 << 16) + 3, 1 << 21])
@pytest.mark.parametrize("n_filters", [1, 64])
def test_bloom_bits_bit_exact_with_host_filters(dev, n, n_filters):
    """The bits for n from 1 to 2^21 ids, one filter and 64 in one launch,
    tables of 2^10 to 2^23 bits, num_hashes 1/4/16: bit-exact with the
    host filters (the first four filters, and every filter where n is
    small) and with the plain version (every filter)."""
    from repro_torch.kernels.bloom import kernel as BK
    from repro_torch.kernels.bloom import ops as bops

    filters, members = _bloom_sized_filters(n_filters)
    rng = np.random.default_rng(n)
    ids = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    ids[: n // 4] = rng.choice(np.concatenate(members), n // 4)  # hits too
    staged = bops.stage_filters(filters, dev)
    items = torch.from_numpy(ids).to(dev)
    kw = dict(num_bits=staged.num_bits, num_hashes=staged.num_hashes)
    before = BK.bloom_contains.launches
    bits = BK.bloom_contains(staged.words, items, **kw)
    assert BK.bloom_contains.launches == before + 1
    assert torch.equal(bits, BK.bloom_contains_plain(staged.words, items, **kw))
    for p, f in enumerate(filters[: 4 if n > 1 << 16 else len(filters)]):
        assert np.array_equal(bits[p].cpu().numpy(), f.contains(ids)), p
    # a view 4 B past an aligned start gives the same bits
    view = torch.cat([items.new_zeros(1), items])[1:]
    assert torch.equal(BK.bloom_contains(staged.words, view, **kw), bits)


@pytest.mark.parametrize("two_streams", [False, True])
def test_bloom_any_alternating_hit_and_no_hit(dev, two_streams):
    """100 any-reductions alternating between filters every id hits and
    empty ones, on one stream and on two in turn with nothing waited for
    between them: each call's flags are its own (the state each launch
    leaves behind is clean, and the streams' states are their own)."""
    from repro_torch.kernels.bloom import kernel as BK
    from repro_torch.kernels.bloom import ops as bops

    filters = _bloom_filters(16)
    ids = np.random.default_rng(12).integers(0, 1 << 22, 1 << 18).astype(np.int32)
    staged = bops.stage_filters(filters, dev)
    empty = [torch.zeros_like(w) for w in staged.words]
    items = torch.from_numpy(ids).to(dev)
    kw = dict(num_bits=staged.num_bits, num_hashes=staged.num_hashes)
    want = torch.tensor([f.any_member(ids) for f in filters], device=dev)
    assert want.all()
    streams = [torch.cuda.Stream(dev) for _ in range(2 if two_streams else 1)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(dev))
    outs = []
    for i in range(100):
        with torch.cuda.stream(streams[i % len(streams)]):
            outs.append(BK.bloom_contains(staged.words if i % 2 == 0 else empty, items,
                                          reduce_any=True, **kw))
    torch.cuda.synchronize(dev)
    for i, out in enumerate(outs):
        assert torch.equal(out, want if i % 2 == 0 else torch.zeros_like(want)), i


# --------------------------------------------------------------------- mesh
def test_mesh_engine_and_service_at_one_slot_are_bitwise_single_device(
        dev, tmp_path):
    """``mesh=1`` on the card: the engine and the service bitwise the
    single-device ones, and each kernel's launches equal
    ``sum(device_dispatches)`` (one slot: the dispatches).  A mesh of more
    cards than the machine has raises the uniform error from the engine."""
    from repro_torch.serve import GraphService

    g = rmat_graph(3000, 40000, seed=17)
    kw = dict(num_shards=6, window=512, k=32, backend="cuda", device="cuda",
              batch_shards=2, device_resident=True)
    root = str(tmp_path / "store")
    solo = VSWEngine.from_graph(g, root, **kw)
    kw.pop("num_shards"), kw.pop("window"), kw.pop("k")
    meshy = VSWEngine.from_store(root, mesh=1, **kw)
    assert meshy.executor.__class__.__name__ == "MeshLaneExecutor"
    for prog in (apps.pagerank(), apps.sssp(0), apps.wcc()):
        want = solo.run(prog, max_iters=5)
        before = (K.ell_partials_masked.launches, K.segment_combine.launches)
        got = meshy.run(prog, max_iters=5)
        launches = (K.ell_partials_masked.launches - before[0],
                    K.segment_combine.launches - before[1])
        assert np.array_equal(got.values, want.values), prog.name
        disp = sum(i.dispatches for i in got.iterations)
        assert launches == (disp, disp)
        assert disp == sum(sum(i.device_dispatches) for i in got.iterations)
        for i in got.iterations:
            assert i.device_shards == (i.shards_processed,)
            assert i.device_bytes == (float(i.bytes_read),)
    cases = [("bfs", 1), ("sssp", 2), ("wcc", 0), ("ppr", 3)]
    svc = GraphService(meshy, max_lanes=8, max_groups=2, batch_shards=2)
    before = (K.ell_partials_ragged.launches, K.segment_combine_lanes.launches)
    with svc.submit_batch():
        futs = [svc.submit(p, s, max_iters=5) for p, s in cases]
    res = [f.result(timeout=300) for f in futs]
    svc.close(close_engine=False)
    launches = (K.ell_partials_ragged.launches - before[0],
                K.segment_combine_lanes.launches - before[1])
    disp = int(svc.metrics.counter("sweep.dispatches").value)
    assert launches == (disp, disp) and disp > 0
    assert svc.stats()["mesh_devices"] == 1
    assert svc.metrics_snapshot()["conservation_violations"] == []
    for (p, s), qr in zip(cases, res):
        want = solo.run(apps.get_program(p, **({} if p == "wcc" else
                                               {"source": s})), max_iters=5)
        assert np.array_equal(np.nan_to_num(qr.values, posinf=1e30),
                              np.nan_to_num(want.values, posinf=1e30)), p
    meshy.close()
    solo.close()
    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match=f"needs {n} devices, have {n - 1}"):
        VSWEngine.from_store(root, mesh=n, **kw)


def test_run_distributed_on_a_one_rank_nccl_group(dev, tmp_path):
    """The superstep over NCCL (one rank, ``file://`` rendezvous) against
    the single-device ``cuda`` engine: min programs bitwise, PageRank within
    rtol 1e-4, atol 1e-9; its sums fold through the segment_combine
    kernel."""
    import torch.distributed as dist

    from repro_torch.core.distributed import run_distributed

    g = rmat_graph(3000, 40000, seed=11)
    eng = VSWEngine.from_graph(g, str(tmp_path / "s"), num_shards=4,
                               window=4096, k=32, backend="cuda",
                               device="cuda", selective=False)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1)
    try:
        for prog, iters in ((apps.pagerank(), 10), (apps.sssp(0), 100),
                            (apps.wcc(), 100)):
            before = K.segment_combine.launches
            got, it = run_distributed(g, prog, max_iters=iters)
            launches = K.segment_combine.launches - before
            want = eng.run(prog, max_iters=iters).values
            if prog.combine == "sum":
                assert launches == it
                assert np.allclose(got, want, rtol=1e-4, atol=1e-9)
            else:
                assert np.array_equal(np.nan_to_num(got, posinf=1e30),
                                      np.nan_to_num(want, posinf=1e30))
    finally:
        dist.destroy_process_group()
        eng.close()


# ------------------------------------------------------------ model meshes
@pytest.fixture
def one_rank_mesh(dev, tmp_path):
    """A (1, 1) ``("data", "model")`` DeviceMesh over a one-rank NCCL group
    and its ``SINGLE_POD_RULES`` context (plain attention)."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import SINGLE_POD_RULES, ShardingCtx
    from repro_torch.launch.mesh import make_model_mesh

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdzv_mm",
                            rank=0, world_size=1)
    try:
        mesh = make_model_mesh((1, 1), ("data", "model"), device_type="cuda")
        yield ShardingCtx(mesh=mesh, rules=dict(SINGLE_POD_RULES), attn_impl="torch")
    finally:
        dist.destroy_process_group()


def _smoke_state(cfg, seed=7):
    """Parameters from ``seed`` and step-3 moments, on the card."""
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    model = M.init_params(seed, cfg, dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    named = dict(model.named_parameters())
    state = adamw.init(named)
    for n, p in named.items():
        state.m[n].copy_(torch.randn(p.shape, generator=gen) * 1e-4)
        state.v[n].copy_(1e-4 * (1 + torch.rand(p.shape, generator=gen)))
    state.step = 3
    model = model.to("cuda")
    state.m = {n: t.cuda() for n, t in state.m.items()}
    state.v = {n: t.cuda() for n, t in state.v.items()}
    return model, state


def test_model_mesh_train_step_matches_the_unsharded_step(one_rank_mesh):
    """The smoke config's step on the (1, 1) mesh against the unsharded step
    from the same parameters, moments and batch: bitwise expected; else
    within the smoke's TRAIN_TOL (bf16 activations: loss rtol 1e-3,
    grad_norm 1e-2, each leaf's change within 0.1 of its largest)."""
    from torch.distributed.tensor import DTensor

    from repro_torch import configs
    from repro_torch.config import smoke_config
    from repro_torch.data.tokens import DataConfig, make_batch
    from repro_torch.distributed.fault_tolerance import elastic_reshard
    from repro_torch.distributed.sharding import ShardingCtx, distribute_module
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step

    cfg = smoke_config(configs.get_config("qwen2.5-3b"))
    specs = M.param_specs(cfg)
    batch = make_batch(DataConfig(seq_len=64, global_batch=4,
                                  vocab_size=cfg.vocab_size, seed=7), 0)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=12)
    whole = lambda t: (t.full_tensor() if isinstance(t, DTensor) else t).detach()
    out = []
    for ctx in (ShardingCtx(attn_impl="torch"), one_rank_mesh):
        model, state = _smoke_state(cfg)
        base = {n: p.detach().cpu().numpy() for n, p in model.named_parameters()}
        if ctx.mesh is not None:
            distribute_module(model, ctx, ctx.param_sharding(specs))
            state.m = elastic_reshard(state.m, specs, ctx)
            state.v = elastic_reshard(state.v, specs, ctx)
            assert all(isinstance(p, DTensor) for p in model.parameters())
        _, state, _, met = make_train_step(cfg, ctx, opt)(model, state, None, batch)
        out.append(({k: float(v) for k, v in met.items()},
                    {n: whole(p).cpu().numpy() for n, p in model.named_parameters()},
                    {n: whole(t).cpu().numpy() for n, t in state.v.items()}, base))
    (m1, p1, v1, base), (m2, p2, v2, _) = out
    if m1 == m2 and all(np.array_equal(p1[n], p2[n]) and np.array_equal(v1[n], v2[n])
                        for n in p1):
        return  # bitwise
    assert np.isclose(m2["loss"], m1["loss"], rtol=1e-3, atol=0)
    assert np.isclose(m2["grad_norm"], m1["grad_norm"], rtol=1e-2, atol=0)
    for n in p1:
        top = max(float(np.abs(p1[n] - base[n]).max()), 1e-30)
        err = np.abs(p2[n] - p1[n]) - 2 * np.spacing(np.abs(p1[n]))
        assert float(err.max()) <= 0.1 * top, n


def test_model_mesh_reshard_of_a_checkpoint_is_bitwise(one_rank_mesh, tmp_path):
    """A checkpoint of the smoke parameters restored and placed on the
    (1, 1) mesh by their logical axes: every leaf a DTensor of that mesh,
    bitwise the saved one."""
    from torch.distributed.tensor import DTensor

    from repro_torch import configs
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.config import smoke_config
    from repro_torch.distributed.fault_tolerance import elastic_reshard
    from repro_torch.models import model as M
    from repro_torch.models.params import reference_specs, reference_tree

    cfg = smoke_config(configs.get_config("qwen2.5-3b"))
    named = dict(M.init_params(7, cfg, dtype=torch.float32,
                               device="cuda").named_parameters())
    tree = reference_tree(named, cfg, device="cpu")
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(1, tree)
    placed = elastic_reshard(ck.restore(1, reference_tree(named, cfg, device="meta")),
                             reference_specs(M.param_specs(cfg), cfg), one_rank_mesh)

    def walk(got, want):
        for k, v in want.items():
            if isinstance(v, dict):
                walk(got[k], v)
            else:
                assert isinstance(got[k], DTensor)
                assert tuple(got[k].device_mesh.shape) == (1, 1)
                assert torch.equal(got[k].full_tensor().cpu(), v)
    walk(placed, tree)
