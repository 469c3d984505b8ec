"""The CUDA kernels on the card: each against its plain PyTorch version and
the numpy oracle, and the engine's ``cuda`` backend against its ``torch``
backend.  Every test here skips where torch sees no CUDA card; the file
imports only the port, so it also runs where jax is not installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

min/max bitwise; sum within rtol=1e-4, atol=1e-5 for one update (the
reduction order over K differs) and rtol=1e-5, atol=1e-9 for PageRank
values after 15 iterations.
"""

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
        assert all(i.kernel_s > 0 for i in out[key].iterations)


# ------------------------------------------------------------------- lanes
def _lane_shards(dev, window, k, tr, n_shards=3, seed=42):
    g = rmat_graph(1500, 20000, seed=seed)
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


@pytest.mark.parametrize("window,k,tr", [(256, 8, 8), (512, 32, 8),
                                         (1024, 128, 8)])
@pytest.mark.parametrize("n_lanes", [1, 3, 8, 13, 32])
@pytest.mark.parametrize("combine", COMBINES)
def test_lane_kernels_bitwise_single_lane_and_plain(dev, window, k, tr,
                                                    n_lanes, combine):
    """Lane l of the lane kernels is bitwise the single-lane kernels on
    message row l (sum included), on the vector path and on the
    warp-per-row path, and matches the plain versions."""
    _, ds = _lane_shards(dev, window, k, tr)
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


@pytest.mark.parametrize("counts,combines", [
    ((3, 5), ("min", "sum")), ((1, 1, 1), ("sum", "min", "max")),
    ((16, 16), ("min", "sum")), ((2, 4), ("min", "min"))])
def test_ragged_bitwise_multi_and_padding_zero(dev, counts, combines):
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
    for l, c in enumerate(K._lane_combines(ctx["cids"].cpu(), ctx["combines"])):
        assert _close(part[l].cpu(), plain[l].cpu(), c or "min")


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
