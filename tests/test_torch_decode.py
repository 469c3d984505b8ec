"""Single-token decode attention of the port against the reference's TPU
kernel (Pallas, in interpret mode) and its jnp helpers, on the same numpy
inputs, over the shapes of the reference's own kernel tests.

Tolerances are the reference's (``tests/test_kernels.py``): rtol = atol =
2e-3 for the decode output in f32 (the softmax is summed in another
order), 1e-5 / 1e-6 for the split combine, 5e-2 for bf16 (the output is
rounded to bf16).  The f32 partials agree within rtol 1e-5, atol 1e-5.  On
the CPU ``flash_decode`` runs the kernel's plain version; the CUDA kernel
itself is held against that on the card by ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import kernel as ref_kernel
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.models.attention import _attend_with_cache

F32_TOL = dict(rtol=2e-3, atol=2e-3)
COMBINE_TOL = dict(rtol=1e-5, atol=1e-6)
PARTIALS_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, BH, G, S, D, lens=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((BH, G, D), dtype=np.float32)
    k = rng.standard_normal((BH, S, D), dtype=np.float32)
    v = rng.standard_normal((BH, S, D), dtype=np.float32)
    if lens is None:
        lens = rng.integers(1, S + 1, BH)
    valid = np.arange(S)[None, :] < np.asarray(lens)[:, None]
    return q, k, v, valid


def _port(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _jax(arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("BH,G,S,D,bk", [
    (4, 8, 1024, 64, 256),
    (2, 1, 512, 128, 128),   # MHA-style group of 1
    (3, 4, 384, 64, 512),    # S < block_k (single padded block)
])
def test_flash_decode_matches_tpu_kernel(BH, G, S, D, bk):
    arrs = _inputs(11, BH, G, S, D)
    want = np.asarray(ref_kernel.flash_decode(*_jax(arrs), block_k=bk))
    got = K.flash_decode(*_port(arrs))
    assert got.dtype == torch.float32 and got.shape == (BH, G, D)
    assert np.allclose(got.numpy(), want, **F32_TOL)
    o, m, l = ref_kernel.decode_partials_ref(*_jax(arrs))
    oracle = np.asarray(o) / np.maximum(np.asarray(l), 1e-30)[..., None]
    assert np.allclose(got.numpy(), oracle, **F32_TOL)


def test_decode_partials_match_reference():
    arrs = _inputs(12, 4, 8, 700, 64)
    got = K.decode_partials_ref(*_port(arrs))
    want = ref_kernel.decode_partials_ref(*_jax(arrs))
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        assert np.allclose(a.numpy(), np.asarray(b), **PARTIALS_TOL)


def test_all_invalid_row_and_odd_lengths():
    """A row with no valid slot gives 0 (l clamped at 1e-30), and S that
    is a multiple of no block (77, 1) needs no padding."""
    for S, lens in ((77, [0, 77, 1, 40]), (1, [1, 0, 1, 1]), (130, [0, 0, 0, 0])):
        arrs = _inputs(13, 4, 4, S, 64, lens=lens)
        got = K.flash_decode(*_port(arrs)).numpy()
        want = np.asarray(ref_kernel.flash_decode(*_jax(arrs), block_k=128))
        assert np.isfinite(got).all()
        assert np.allclose(got, want, **F32_TOL)
        for b, n in enumerate(lens):
            if n == 0:
                assert not got[b].any() and not want[b].any()


def test_flash_decode_bf16_matches_tpu_kernel():
    q, k, v, valid = _inputs(14, 4, 8, 300, 128)
    port = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = K.flash_decode(*port, torch.from_numpy(valid))
    assert got.dtype == torch.bfloat16
    want = ref_kernel.flash_decode(*[jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)],
                                   jnp.asarray(valid), block_k=128)
    assert np.allclose(got.float().numpy(), np.asarray(want, np.float32), **BF16_TOL)


def test_split_combine_exact():
    """Partial-softmax merge over cache shards == full softmax, the algebra
    the kernel's second pass uses; port and reference combines agree."""
    BH, G, S, D, N = 4, 8, 1024, 64, 4
    q, k, v, _ = _inputs(12, BH, G, S, D)
    valid = np.arange(S)[None, :] < np.array([700, S, 1, 512])[:, None]
    arrs = (q, k, v, valid)
    o, m, l = K.decode_partials_ref(*_port(arrs))
    full = (o / l.clamp_min(1e-30)[..., None]).numpy()
    sl = [slice(i * S // N, (i + 1) * S // N) for i in range(N)]
    parts = [K.decode_partials_ref(*_port((q, k[:, s], v[:, s], valid[:, s])))
             for s in sl]
    stacks = [torch.stack([p[i] for p in parts]) for i in range(3)]
    comb = K.flash_decode_combine(*stacks).numpy()
    assert np.allclose(comb, full, **COMBINE_TOL)
    want = ref_kernel.flash_decode_combine(*[jnp.asarray(t.numpy()) for t in stacks])
    assert np.allclose(comb, np.asarray(want), **COMBINE_TOL)


@pytest.mark.parametrize("BH,S,D", [(8, 1, 128), (8, 544, 128), (8, 32768, 128),
                                    (3, 1000, 64), (1, 300, 256), (40, 5000, 80)])
def test_decode_splits_cover_the_cache(BH, S, D):
    splits, per, tile = K.decode_splits(S, BH, D)
    span = per * tile
    assert splits * span >= S and (splits - 1) * span < S
    assert splits * BH <= max(BH, 512 + BH)


def test_split_merge_schedule_equals_plain():
    """The kernel's schedule in plain PyTorch: partials over each split of
    ``decode_splits``, merged in order, equal the whole-cache result."""
    BH, G, S, D = 2, 8, 3000, 64
    q, k, v, valid = _port(_inputs(15, BH, G, S, D, lens=[0, 2100]))
    splits, per, tile = K.decode_splits(S, BH, D)
    parts = [K.decode_partials_ref(q, k[:, i * per * tile:(i + 1) * per * tile],
                                   v[:, i * per * tile:(i + 1) * per * tile],
                                   valid[:, i * per * tile:(i + 1) * per * tile])
             for i in range(splits)]
    merged = K.flash_decode_combine(*[torch.stack([p[i] for p in parts])
                                      for i in range(3)])
    assert splits > 1
    assert np.allclose(merged.numpy(), K.flash_decode_plain(q, k, v, valid).numpy(),
                       **COMBINE_TOL)
    assert not merged[0].any()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
def test_flash_decode_equals_model_cache_attention(dtype, tol):
    """The model's decode attention over its ``[B, Smax, Hkv, hd]`` cache,
    reshaped to the kernel's layout, as chip_smoke.py checks it on
    Qwen2.5-3B's real cache."""
    B, H, Hkv, hd, Smax, valid_len = 2, 8, 2, 64, 40, 29
    rng = np.random.default_rng(16)
    q = torch.from_numpy(rng.standard_normal((B, 1, H, hd), dtype=np.float32)).to(dtype)
    ck = torch.zeros((B, Smax, Hkv, hd), dtype=dtype)
    cv = torch.zeros_like(ck)
    ck[:, :valid_len] = torch.from_numpy(
        rng.standard_normal((B, valid_len, Hkv, hd), dtype=np.float32)).to(dtype)
    cv[:, :valid_len] = torch.from_numpy(
        rng.standard_normal((B, valid_len, Hkv, hd), dtype=np.float32)).to(dtype)
    want = _attend_with_cache(q, ck, cv, valid_len)
    G = H // Hkv
    kq = q.reshape(B, Hkv, G, hd).reshape(B * Hkv, G, hd)
    kk = ck.permute(0, 2, 1, 3).reshape(B * Hkv, Smax, hd)
    kv = cv.permute(0, 2, 1, 3).reshape(B * Hkv, Smax, hd)
    valid = (torch.arange(Smax) < valid_len).expand(B * Hkv, Smax)
    got = K.flash_decode(kq, kk, kv, valid).reshape(B, 1, H, hd)
    assert got.dtype == dtype
    assert torch.allclose(got.float(), want.float(), **tol)


def test_flash_decode_rejects_bad_inputs():
    q, k, v, valid = _port(_inputs(17, 2, 4, 16, 32))
    with pytest.raises(ValueError):
        K.flash_decode(q, k[:, :8], v, valid)
    with pytest.raises(ValueError):
        K.flash_decode(q, k, v, valid[:, :8])
    with pytest.raises(TypeError):
        K.flash_decode(q, k, v, valid.to(torch.uint8))
    with pytest.raises(TypeError):
        K.flash_decode(q.double(), k, v, valid)
    with pytest.raises(ValueError):
        K.flash_decode(q, k[:, :0], v[:, :0], valid[:, :0])
