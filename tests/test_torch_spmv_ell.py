"""The ELL pull-update of the port against the reference's TPU kernel (in
interpret mode) and its jnp oracle, on the same numpy inputs, over the
shapes and combines of the reference's own kernel tests.

min/max match bitwise; sum within rtol=1e-4, atol=1e-5 (the reference's
kernel tolerance: the reduction order over K differs).  On the CPU the
wrappers run the kernels' plain versions; the CUDA kernels themselves are
held against those on the card by ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.csr import csr_to_ell
from repro.core.graph import from_edge_list, rmat_graph, star_graph
from repro.core.sharding import preprocess
from repro.core.vsw import update_shard_numpy
from repro.kernels.spmv_ell import kernel as ref_kernel
from repro.kernels.spmv_ell import ops as ref_ops
from repro.kernels.spmv_ell import ref as ref_ref
from repro_torch.core.csr import ell_to_device
from repro_torch.kernels.spmv_ell import kernel as K
from repro_torch.kernels.spmv_ell import ops, ref

SHAPES = [(256, 8, 8), (512, 32, 8), (1024, 128, 8)]
COMBINES = ["sum", "min", "max"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps the suite's parallel
    workers from oversubscribing the cores."""
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


def _msgs(n, combine, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random(n).astype(np.float32)
    if combine != "sum":  # identities among the messages, as SSSP carries
        x[rng.random(n) < 0.1] = np.inf if combine == "min" else -np.inf
    return x


def _padded(ell, msgs):
    out = np.zeros(ell.num_windows * ell.window, np.float32)
    out[: msgs.shape[0]] = msgs
    return out


@pytest.fixture(scope="module")
def rmat_shards():
    g = rmat_graph(1500, 20000, seed=42)
    _, shards = preprocess(g, num_shards=3)
    return g, shards


@pytest.mark.parametrize("window,k,tr", SHAPES)
@pytest.mark.parametrize("combine", COMBINES)
def test_partials_match_tpu_kernel(rmat_shards, window, k, tr, combine):
    g, shards = rmat_shards
    msgs = _msgs(g.num_vertices, combine)
    for s in shards:
        e = csr_to_ell(s, g.num_vertices, window=window, k=k, tr=tr)
        mp = _padded(e, msgs)
        want = ref_kernel.ell_partials_masked(
            jnp.asarray(e.ell_idx), jnp.asarray(e.ell_mask),
            jnp.asarray(e.tile_window), jnp.asarray(mp),
            window=window, tr=tr, combine=combine, interpret=True)
        d = ell_to_device(e, "cpu")
        got = K.ell_partials_masked(d.idx, d.mask, d.tile_window,
                                    torch.from_numpy(mp), window=window,
                                    tr=tr, combine=combine)
        assert _close(got.numpy(), want, combine), (s.shard_id, combine)
        mine = ref.partials_ref(d.idx, d.mask, d.tile_window,
                                torch.from_numpy(mp), window=window, tr=tr,
                                combine=combine)
        theirs = ref_ref.partials_ref(
            jnp.asarray(e.ell_idx), jnp.asarray(e.ell_mask),
            jnp.asarray(e.tile_window), jnp.asarray(mp),
            window=window, tr=tr, combine=combine)
        assert _close(mine.numpy(), theirs, combine)


@pytest.mark.parametrize("window,k,tr", SHAPES)
@pytest.mark.parametrize("combine", COMBINES)
def test_update_matches_reference_and_oracle(rmat_shards, window, k, tr,
                                             combine):
    g, shards = rmat_shards
    msgs = _msgs(g.num_vertices, combine, seed=1)
    for s in shards:
        e = csr_to_ell(s, g.num_vertices, window=window, k=k, tr=tr)
        d = ell_to_device(e, "cpu")
        mp = torch.from_numpy(_padded(e, msgs))
        got = ops.ell_update(d, mp, combine).numpy()
        assert got.shape == (s.rows,)
        pallas = np.asarray(ref_ops.ell_update(e, msgs, combine))
        assert _close(got, pallas, combine), (s.shard_id, combine)
        oracle = update_shard_numpy(s, None, msgs, combine)
        assert _close(got, oracle, combine)
        seg_ref = ref.ell_update_ref(
            d.idx, d.mask, torch.from_numpy(e.seg), d.tile_window, mp,
            window=window, tr=tr, rows=e.rows, combine=combine)
        jnp_ref = ref_ref.ell_update_ref(
            jnp.asarray(e.ell_idx), jnp.asarray(e.ell_mask),
            jnp.asarray(e.seg), jnp.asarray(e.tile_window),
            jnp.asarray(mp.numpy()), window=window, tr=tr, rows=e.rows,
            combine=combine)
        assert _close(seg_ref.numpy(), jnp_ref, combine)
        assert _close(seg_ref.numpy(), got, combine)


def test_int32_indices_wide_window():
    """W > 2^15 stores int32 indices; the update takes them unchanged."""
    g = rmat_graph(80_000, 30_000, seed=3)
    _, shards = preprocess(g, num_shards=2)
    msgs = _msgs(g.num_vertices, "sum", seed=2)
    for s in shards:
        e = csr_to_ell(s, g.num_vertices, window=1 << 16, k=16, tr=8)
        d = ell_to_device(e, "cpu")
        assert d.idx.dtype == torch.int32
        got = ops.ell_update(d, torch.from_numpy(_padded(e, msgs)), "sum")
        assert _close(got.numpy(), update_shard_numpy(s, None, msgs, "sum"),
                      "sum")


def test_hub_vertex_row_split():
    """A 10k-in-degree hub exercises row splitting across many ELL rows."""
    g = star_graph(10_000)
    _, shards = preprocess(g, num_shards=1)
    e = csr_to_ell(shards[0], g.num_vertices, window=2048, k=64, tr=8)
    d = ell_to_device(e, "cpu")
    assert int(d.row_ptr[1] - d.row_ptr[0]) > 100  # many ELL rows for row 0
    acc = ops.ell_update(d, torch.ones(e.num_windows * e.window), "sum")
    assert float(acc[0]) == 9999.0
    assert float(acc[1:].abs().max()) == 0.0


@pytest.mark.parametrize("combine", COMBINES)
def test_empty_shard_gets_identity(combine):
    g = from_edge_list([(0, 1)], num_vertices=64)
    _, shards = preprocess(g, num_shards=2)
    for s in shards:
        e = csr_to_ell(s, 64, window=32, k=8, tr=8)
        d = ell_to_device(e, "cpu")
        acc = ops.ell_update(d, torch.ones(64), combine).numpy()
        want = update_shard_numpy(s, None, np.ones(64, np.float32), combine)
        assert acc.shape == (s.rows,) and _close(acc, want, combine)


@pytest.mark.parametrize("combine", COMBINES)
def test_combine_order_and_batched_bitwise(rmat_shards, combine):
    """perm/row_ptr give each destination row exactly its non-padding ELL
    rows, ascending; a batch is bitwise the per-shard runs."""
    g, shards = rmat_shards
    ells = [csr_to_ell(s, g.num_vertices, window=256, k=16, tr=8)
            for s in shards]
    devs = [ell_to_device(e, "cpu") for e in ells]
    for e, d in zip(ells, devs):
        assert d.perm.numel() == e.n_ell and d.row_ptr.numel() == e.rows + 1
        live = e.ell_mask.any(1)
        assert int(d.row_ptr[-1]) == int(live.sum())
        perm = d.perm.numpy()
        for r in range(e.rows):
            run = perm[d.row_ptr[r]:d.row_ptr[r + 1]]
            assert np.array_equal(run, np.flatnonzero((e.seg == r) & live))
    mp = torch.from_numpy(_padded(ells[0], _msgs(g.num_vertices, combine)))
    single = [ops.ell_update(d, mp, combine).numpy() for d in devs]
    batched = ops.ell_update_batched(devs, mp, combine)
    assert batched.shape == (g.num_vertices,)
    assert np.array_equal(np.concatenate(single), batched.numpy())
    with pytest.raises(ValueError, match="share"):
        ops.ell_update_batched(
            [devs[0], ell_to_device(csr_to_ell(shards[1], g.num_vertices,
                                               window=128, k=16, tr=8), "cpu")],
            mp, combine)


def test_ell_to_device_validates():
    g = rmat_graph(300, 2000, seed=1)
    _, shards = preprocess(g, num_shards=1)
    e = csr_to_ell(shards[0], g.num_vertices, window=64, k=8, tr=8)
    e.tile_window = e.tile_window.copy()
    e.tile_window[0] = e.num_windows
    with pytest.raises(ValueError, match="tile_window"):
        ell_to_device(e, "cpu")


def test_wrappers_refuse_mixed_devices():
    x = torch.zeros(8, dtype=torch.int16).reshape(1, 8)
    with pytest.raises(ValueError, match="different devices"):
        K._on_cpu(x, torch.zeros(1, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        K._on_cpu(torch.zeros(1, device="meta"))


def test_stage_messages_pads_whole_windows():
    x = np.arange(5, dtype=np.float32)
    t = ops.stage_messages(x, 8, "cpu")
    assert t.dtype == torch.float32 and t.tolist() == [0, 1, 2, 3, 4, 0, 0, 0]
    with pytest.raises(ValueError):
        ops.stage_messages(x, 4, "cpu")
