"""The CUDA kernels on the card: each against its plain PyTorch version and
the numpy oracle, and the engine's ``cuda`` backend against its ``torch``
backend.  Every test here skips where torch sees no CUDA card; the file
imports only the port, so it also runs where jax is not installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

min/max bitwise; sum within rtol=1e-4, atol=1e-5 for one update (the
reduction order over K differs) and rtol=1e-5, atol=1e-9 for PageRank
values after 15 iterations.
"""

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
