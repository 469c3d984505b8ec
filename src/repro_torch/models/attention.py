"""GQA attention block: projections, RoPE, KV cache, cross-attention.

The score/softmax/value computation of prefill is delegated to
``repro_torch.kernels.flash_attention.ops.attention`` (impl selectable:
``"torch"`` for the plain path, ``"cuda"`` for the kernel).  A decode step
attends with plain PyTorch over the static cache, as the reference does
(its decode path reaches no kernel either).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..config import ModelConfig
from ..distributed.sharding import is_dtensor, on_local_shards, whole_heads
from ..kernels.flash_attention.ops import attention
from . import common as C

__all__ = ["Attention", "attn_specs", "blocked_attention", "self_attention",
           "cross_attention", "on_local_heads"]


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, *, gen: Optional[torch.Generator] = None,
                 device, dtype=torch.float32):
        super().__init__()
        d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.wq = C.Linear(d, qd, bias=cfg.qkv_bias, **kw)
        self.wk = C.Linear(d, kvd, bias=cfg.qkv_bias, **kw)
        self.wv = C.Linear(d, kvd, bias=cfg.qkv_bias, **kw)
        self.wo = C.Linear(qd, d, **kw)


def attn_specs(cfg: ModelConfig) -> dict:
    return {
        "wq": C.linear_specs("embed", "qkv", bias=cfg.qkv_bias),
        "wk": C.linear_specs("embed", "qkv", bias=cfg.qkv_bias),
        "wv": C.linear_specs("embed", "qkv", bias=cfg.qkv_bias),
        "wo": C.linear_specs("qkv", "embed"),
    }


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    b, s, _ = x.shape
    return whole_heads(x, n).reshape(b, s, n, hd)


def blocked_attention(
    q: torch.Tensor,  # [B, Sq, H, hd]
    k: torch.Tensor,  # [B, Skv, Hkv, hd]
    v: torch.Tensor,  # [B, Skv, Hkv, hd]
    *,
    block_k: int,
    causal: bool = True,
) -> torch.Tensor:
    """Online-softmax attention over kv blocks of ``block_k``: memory
    O(Sq * block_k) instead of O(Sq * Skv).  The reference's ``lax.scan``
    is a Python loop here."""
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    scale = hd ** -0.5
    qf = (q.float() * scale).reshape(B, Sq, Hkv, group, hd)
    qpos = (Skv - Sq) + torch.arange(Sq, device=q.device)  # suffix-aligned
    m = torch.full((B, Sq, Hkv, group), float("-inf"), device=q.device)
    l = torch.zeros((B, Sq, Hkv, group), device=q.device)
    acc = torch.zeros((B, Sq, Hkv, group, hd), device=q.device)
    for k0 in range(0, Skv, block_k):
        kb = k[:, k0:k0 + block_k].float()
        vb = v[:, k0:k0 + block_k].float()
        s = torch.einsum("bqngd,bknd->bqngk", qf, kb)  # [B,Sq,Hkv,group,bk]
        kpos = k0 + torch.arange(kb.shape[1], device=q.device)
        valid = torch.ones((Sq, kb.shape[1]), dtype=torch.bool, device=q.device)
        if causal:
            valid = qpos[:, None] >= kpos[None, :]
        s = s.masked_fill(~valid[None, :, None, None, :], float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked rows (m_new = -inf): exp(-inf - -inf) -> nan
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        alpha = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bqngk,bknd->bqngd", p, vb)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def self_attention(
    params: Attention,
    x: torch.Tensor,  # [B, S, d]
    positions: torch.Tensor,  # [B, S]
    cfg: ModelConfig,
    *,
    causal: bool = True,
    use_rope: bool = True,
    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # [B,Smax,Hkv,hd] x2
    cache_index: Optional[int] = None,  # write offset
    impl: str = "torch",
    block_k: int = 0,
    ac=None,
    bf16_probs: bool = False,
):
    """Returns (out [B,S,d], new_kv_cache).  With a cache, K/V of the S new
    tokens are written into it in place (the reference donates it) and
    the cache is returned."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _split_heads(C.linear(params.wq, x), H, hd)
    k = _split_heads(C.linear(params.wk, x), Hkv, hd)
    v = _split_heads(C.linear(params.wv, x), Hkv, hd)
    if use_rope:
        q = C.apply_rope(q, positions, cfg.rope_theta)
        k = C.apply_rope(k, positions, cfg.rope_theta)

    if kv_cache is not None:
        ck, cv = kv_cache
        i = int(cache_index)
        if is_dtensor(ck):
            _write_sharded(ck, k, i)
            _write_sharded(cv, v, i)
        else:
            ck[:, i:i + S] = k.to(ck.dtype)
            cv[:, i:i + S] = v.to(cv.dtype)
        # static cache shape; validity expressed via absolute-position mask
        out = _attend_with_cache(q, ck, cv, i + S)
        return C.linear(params.wo, out.reshape(B, S, H * hd)), (ck, cv)

    if block_k and S > block_k and impl == "torch":
        out = on_local_heads(lambda q, k, v: blocked_attention(
            q, k, v, block_k=block_k, causal=causal), q, k, v)
    else:
        out = on_local_heads(lambda q, k, v: attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, impl=impl, ac=ac,
            bf16_probs=bf16_probs,
        ).transpose(1, 2), q, k, v)
    return C.linear(params.wo, out.reshape(B, S, H * hd)), None


def on_local_heads(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """``fn(q, k, v)`` (``[B, S, heads, hd]`` each) on one device; under a
    model mesh, on each rank's own batch rows and query heads
    (``distributed.sharding.on_local_shards``), K/V split the same way;
    where the mesh splits the query heads finer than the KV heads divide
    (two KV heads on a 16-wide axis), each query head first takes its own
    copy of its KV head (``_repeat_heads``)."""
    if not is_dtensor(q):
        return fn(q, k, v)
    from torch.distributed.tensor import Shard

    split = 1
    for d, p in enumerate(q.placements):
        if p == Shard(2):
            split *= q.device_mesh.size(d)
    H, Hkv = q.shape[2], k.shape[2]
    if Hkv % split:
        k, v = _repeat_heads(k, H // Hkv, 2), _repeat_heads(v, H // Hkv, 2)
    return on_local_shards(fn, (q, k, v), (2, 2, 2), (2,))


def _repeat_heads(x: torch.Tensor, group: int, dim: int) -> torch.Tensor:
    """Each head of ``x``'s ``dim`` repeated ``group`` times, in place (head
    ``h`` becomes heads ``h * group .. h * group + group - 1``): grouped-query
    K/V brought to the query heads, for a mesh whose query heads are split
    where the KV heads cannot be (two KV heads on a 16-wide axis)."""
    shape = list(x.shape)
    x = x.unsqueeze(dim + 1).expand(*shape[:dim + 1], group, *shape[dim + 1:])
    return x.reshape(*shape[:dim], shape[dim] * group, *shape[dim + 1:])


def _write_sharded(cache: torch.Tensor, new: torch.Tensor, i: int) -> None:
    """``cache[:, i:i + S] = new`` for a cache that is a DTensor sharded
    along its sequence (the decode cells' flash-decoding layout): a slice
    of a sharded dim has no DTensor rule, so the new rows, brought to the
    cache's placements but the sequence, are selected by position, each
    rank writing its own shard (the whole cache is read and written
    once)."""
    from torch.distributed.tensor import Replicate

    S, Smax = new.shape[1], cache.shape[1]
    # the cache's placements but the sequence (a partial sum is reduced on
    # the few new rows)
    rows = [Replicate() if getattr(p, "dim", None) == 1 else p
            for p in cache.placements]
    new = new.to(cache.dtype).redistribute(cache.device_mesh, rows)
    if S > 1:  # rows i .. i + S of a cache-long tensor (decode writes one)
        B, _, H, D = new.shape
        new = torch.cat([new.new_zeros((B, i, H, D)), new,
                         new.new_zeros((B, Smax - i - S, H, D))], dim=1)
    pos = torch.arange(Smax, device=new.device)
    sel = ((pos >= i) & (pos < i + S))[None, :, None, None]
    cache.copy_(torch.where(sel, new, cache))


def _attend_with_cache(q, ck, cv, valid_len: int) -> torch.Tensor:
    """Decode-style attention over a static-size cache with masking.

    q: [B, S, H, hd] (S = tokens being appended, usually 1)
    ck/cv: [B, Smax, Hkv, hd]; positions < valid_len are valid.
    """
    B, S, H, hd = q.shape
    Smax, Hkv = ck.shape[1], ck.shape[2]
    group = H // Hkv
    if is_dtensor(q):
        # a model mesh: the few query rows whole but for the cache's batch
        # split, before the grouped reshape (a head split regrouped there
        # would leave the product a strided placement to plan around)
        from torch.distributed.tensor import Replicate

        q = q.redistribute(q.device_mesh, [
            p if getattr(p, "dim", None) == 0 else Replicate() for p in ck.placements])
    qf = q.float().reshape(B, S, Hkv, group, hd)
    s = torch.einsum("bsngd,bknd->bsngk", qf, ck.float()) * (hd ** -0.5)
    kpos = torch.arange(Smax, device=q.device)
    qpos = valid_len - S + torch.arange(S, device=q.device)
    mask = kpos[None, :] <= qpos[:, None]  # [S, Smax]
    s = s.masked_fill(~mask[None, :, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bsngk,bknd->bsngd", p, cv.float())
    return o.reshape(B, S, H, hd).to(q.dtype)


def cross_attention(
    params: Attention,
    x: torch.Tensor,  # [B, S, d] decoder states
    memory: torch.Tensor,  # [B, T, d] encoder output
    cfg: ModelConfig,
    *,
    impl: str = "torch",
    ac=None,
    bf16_probs: bool = False,
) -> torch.Tensor:
    B, S, _ = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _split_heads(C.linear(params.wq, x), H, hd)
    k = _split_heads(C.linear(params.wk, memory), Hkv, hd)
    v = _split_heads(C.linear(params.wv, memory), Hkv, hd)
    out = on_local_heads(lambda q, k, v: attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=False, impl=impl, ac=ac,
        bf16_probs=bf16_probs,
    ).transpose(1, 2), q, k, v)
    return C.linear(params.wo, out.reshape(B, S, H * hd))
