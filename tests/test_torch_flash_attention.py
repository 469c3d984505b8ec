"""The port's attention against the reference's flash kernel (Pallas, in
interpret mode) and its jnp oracle, on the same numpy inputs, over the
shapes of the reference's own kernel tests.

Tolerances are the reference's (``tests/test_kernels.py``): rtol = atol =
2e-3 for f32 (the softmax is summed in another order) and 5e-2 for bf16
(the output is rounded to bf16).  On the CPU ``attention(impl="cuda")``
runs the kernel's plain version; the CUDA kernel itself is held against
that on the card by ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import ops as ref_ops
from repro.kernels.flash_attention.ref import mha_ref as jax_mha_ref
from repro.models.attention import blocked_attention as jax_blocked
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import mha_ref
from repro_torch.models.attention import blocked_attention

F32_TOL = dict(rtol=2e-3, atol=2e-3)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed, B, Hq, Hkv, Sq, Skv, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, Sq, D), dtype=np.float32),
            rng.standard_normal((B, Hkv, Skv, D), dtype=np.float32),
            rng.standard_normal((B, Hkv, Skv, D), dtype=np.float32))


def _port(arrs, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


def _jax(arrs, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrs]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("B,Hq,Hkv,S,D", [
    (1, 4, 4, 256, 64),     # MHA
    (2, 8, 2, 128, 64),     # GQA 4:1
    (1, 2, 1, 384, 128),    # MQA
])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_matches_reference_flash_kernel(B, Hq, Hkv, S, D, causal):
    arrs = _qkv(5, B, Hq, Hkv, S, S, D)
    want = _f32(ref_ops.attention(*_jax(arrs), causal=causal, impl="pallas"))
    want_ref = _f32(jax_mha_ref(*_jax(arrs), causal=causal))
    before = K.flash_attention.launches
    got = ops.attention(*_port(arrs), causal=causal, impl="cuda")
    assert K.flash_attention.launches == before  # no kernel on the CPU
    assert got.shape == (B, Hq, S, D) and got.dtype == torch.float32
    assert np.allclose(_f32(got), want, **F32_TOL)
    ref = ops.attention(*_port(arrs), causal=causal, impl="torch")
    assert np.allclose(_f32(ref), want_ref, **F32_TOL)
    assert np.allclose(_f32(ref), want, **F32_TOL)


def test_attention_bf16_matches_reference_flash_kernel():
    arrs = _qkv(6, 1, 2, 2, 256, 256, 64)
    want = _f32(ref_ops.attention(*_jax(arrs, jnp.bfloat16), causal=True,
                                  impl="pallas"))
    got = ops.attention(*_port(arrs, torch.bfloat16), causal=True, impl="cuda")
    assert got.dtype == torch.bfloat16
    assert np.allclose(_f32(got), want, **BF16_TOL)
    ref = mha_ref(*_port(arrs, torch.bfloat16), causal=True)
    assert np.allclose(_f32(ref), want, **BF16_TOL)


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_attention_suffix_alignment_matches_reference(impl):
    """Sq < Skv: queries are the suffix (KV-cache decode convention)."""
    arrs = _qkv(7, 1, 2, 2, 128, 512, 64)
    want = _f32(ref_ops.attention(*_jax(arrs), causal=True, impl="pallas"))
    got = ops.attention(*_port(arrs), causal=True, impl=impl)
    assert np.allclose(_f32(got), want, **F32_TOL)


@pytest.mark.parametrize("Sq,Skv", [(24, 24), (200, 200), (13, 200)])
@pytest.mark.parametrize("causal", [True, False])
def test_ragged_lengths_match_reference_oracle(Sq, Skv, causal):
    """Lengths no 128-row block divides: the Pallas kernel refuses them,
    the function (``mha_ref``) is defined for every length."""
    arrs = _qkv(8, 2, 8, 1, Sq, Skv, 64)
    want = _f32(jax_mha_ref(*_jax(arrs), causal=causal))
    for impl in ("cuda", "torch"):
        got = ops.attention(*_port(arrs), causal=causal, impl=impl)
        assert np.allclose(_f32(got), want, **F32_TOL), impl


def test_bf16_probs_matches_reference_oracle():
    arrs = _qkv(9, 1, 4, 2, 96, 96, 32)
    want = _f32(jax_mha_ref(*_jax(arrs, jnp.bfloat16), causal=True,
                            bf16_probs=True))
    got = mha_ref(*_port(arrs, torch.bfloat16), causal=True, bf16_probs=True)
    assert got.dtype == torch.bfloat16
    assert np.allclose(_f32(got), want, **BF16_TOL)


@pytest.mark.parametrize("S,block_k", [(200, 64), (256, 128)])
def test_blocked_attention_matches_reference(S, block_k):
    rng = np.random.default_rng(10)
    q = rng.standard_normal((2, S, 4, 32), dtype=np.float32)
    k = rng.standard_normal((2, S, 2, 32), dtype=np.float32)
    v = rng.standard_normal((2, S, 2, 32), dtype=np.float32)
    want = _f32(jax_blocked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            block_k=block_k))
    got = blocked_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), block_k=block_k)
    assert np.allclose(_f32(got), want, **F32_TOL)


def test_strided_views_give_the_contiguous_result():
    """The model hands over transposed views ([B, S, H, D] memory)."""
    arrs = _qkv(11, 2, 4, 2, 40, 40, 16)
    q, k, v = [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))
               .transpose(1, 2) for a in arrs]
    assert not q.is_contiguous()
    got = K.flash_attention(q, k, v, causal=True)
    want = K.flash_attention(*_port(arrs), causal=True)
    assert torch.equal(got, want)


def test_wrapper_rejects_bad_inputs():
    q, k, v = _port(_qkv(12, 1, 4, 2, 8, 8, 16))
    with pytest.raises(ValueError, match="multiple"):
        K.flash_attention(q[:, :3], k, v)
    with pytest.raises(ValueError, match="more queries"):
        K.flash_attention(torch.cat([q, q], dim=2), k, v, causal=True)
    K.flash_attention(torch.cat([q, q], dim=2), k, v, causal=False)
    with pytest.raises(TypeError):
        K.flash_attention(q.double(), k, v)
    with pytest.raises(ValueError):
        K.flash_attention(q, k[:, :, :4], v)
    with pytest.raises(ValueError, match="unknown attention impl"):
        ops.attention(q, k, v, impl="pallas")


def _call_tensors(dtype, D, B=2, Hq=4, Hkv=2, S=40):
    """q, k, v as the model hands them over (transposed views of [B, S, H,
    D]) and the output as the wrapper allocates it."""
    q = torch.zeros(B, S, Hq, D, dtype=dtype).transpose(1, 2)
    k = torch.zeros(B, S, Hkv, D, dtype=dtype).transpose(1, 2)
    v = torch.zeros(B, S, Hkv, D, dtype=dtype).transpose(1, 2)
    out = torch.empty(B, S, Hq, D, dtype=dtype).permute(0, 2, 1, 3)
    return q, k, v, out


@pytest.mark.parametrize("dtype,D,expect", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 128, True),
    (torch.bfloat16, 256, False), (torch.bfloat16, 100, False),
    (torch.bfloat16, 16, False), (torch.float32, 128, False),
    (torch.float32, 64, False)])
def test_dispatch_rule_by_dtype_and_head_dim(dtype, D, expect):
    """bf16 at head dim 64 or 128 takes the tensor-core kernel; f32 keeps
    full f32 products on the scalar kernel, as does every other head dim."""
    assert K.uses_tensor_cores(*_call_tensors(dtype, D)) is expect
    assert K.TC_HEAD_DIMS == (64, 128)


def test_dispatch_rule_by_layout():
    """Contiguous tensors and the model's views are on the rule; a last
    stride other than 1, a base pointer or a row stride off 16 B is not."""
    q, k, v, out = _call_tensors(torch.bfloat16, 128)
    assert K.uses_tensor_cores(q.contiguous(), k.contiguous(), v.contiguous(), out)
    wide = torch.zeros(2, 2, 40, 256, dtype=torch.bfloat16)
    assert not K.uses_tensor_cores(q, wide[..., ::2], v, out)       # last stride 2
    buf = torch.zeros(k.numel() + 1, dtype=torch.bfloat16)
    off = buf[1:].view(k.shape)                                       # 2 B off
    assert not K.uses_tensor_cores(q, k, off, out)
    pad = torch.zeros(2, 2, 40, 132, dtype=torch.bfloat16)[..., :128]  # rows 264 B
    assert not K.uses_tensor_cores(q, pad, v, out)
    pad8 = torch.zeros(2, 2, 40, 136, dtype=torch.bfloat16)[..., :128]  # rows 272 B
    assert K.uses_tensor_cores(q, pad8, v, out)
    assert not K.uses_tensor_cores(q.float(), k, v, out)  # dtypes differ


def test_dispatch_leaves_cpu_calls_and_counters_alone():
    """On the CPU the plain version runs: no launch is counted."""
    arrs = _port(_qkv(13, 1, 4, 2, 70, 70, 64), torch.bfloat16)
    before = (K.flash_attention.launches, K.flash_attention.tc_launches)
    got = K.flash_attention(*arrs, causal=True)
    assert (K.flash_attention.launches, K.flash_attention.tc_launches) == before
    assert torch.equal(got, K.flash_attention_plain(*arrs, causal=True))
