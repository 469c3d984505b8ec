"""Decoder assembly for the dense family: attention + dense MLP blocks.

The reference stacks each group's parameters as ``[num_groups, ...]`` and
runs the stack as one ``lax.scan``; here the layers are an
``nn.ModuleList`` walked by a Python loop.  Caches keep the reference's
stacked layout at the model's public functions: ``{"layer_0": {"k", "v"}}``
with leaves ``[num_layers, B, S, Hkv, hd]`` (group period 1).

Three modes: ``train`` (no caches), ``prefill`` (returns the stacked
caches), ``decode`` (writes each layer's slice of the caches in place,
static cache shapes, position-masked attention).

Only the ``attn`` mixer with a dense MLP is ported.  The ``ssd``,
``mlstm`` and ``slstm`` mixers, MoE, encoder-decoder and the vision
frontend raise ``NotImplementedError`` (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ..config import ModelConfig
from ..distributed.sharding import ShardingCtx
from . import common as C
from .attention import Attention, self_attention
from .mlp import MLP, mlp

__all__ = ["check_supported", "Block", "block_apply", "run_stack"]

_LATER = "is not ported yet (ROADMAP Queue 1 item 10)"


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless every layer of ``cfg`` is
    attention + dense MLP with no encoder and no vision frontend."""
    if cfg.encdec:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder {_LATER}")
    if cfg.frontend == "vision_stub":
        raise NotImplementedError(f"{cfg.name}: the vision frontend {_LATER}")
    for i in range(cfg.group_period):
        mixer, mlp_kind = cfg.layer_kind(i)
        if mixer != "attn":
            raise NotImplementedError(f"{cfg.name}: the {mixer} mixer {_LATER}")
        if mlp_kind != "dense":
            raise NotImplementedError(f"{cfg.name}: the {mlp_kind} MLP {_LATER}")


class Block(nn.Module):
    """One decoder layer: ``ln1``, ``attn``, ``ln2``, ``mlp``."""

    def __init__(self, cfg: ModelConfig, *, gen: Optional[torch.Generator] = None,
                 device, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln1 = C.RMSNorm(cfg.d_model, **kw)
        self.attn = Attention(cfg, gen=gen, **kw)
        self.ln2 = C.RMSNorm(cfg.d_model, **kw)
        self.mlp = MLP(cfg.d_model, cfg.dense_d_ff or cfg.d_ff, cfg.mlp_type,
                       gen=gen, **kw)


def block_apply(
    params: Block,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    ctx: ShardingCtx,
    layer_in_group: int,
    *,
    mode: str,  # train | prefill | decode
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_index: Optional[int] = None,
    memory: Optional[torch.Tensor] = None,
):
    """Returns (x, new_cache, aux_loss) for an attention + dense MLP layer
    (``run_stack`` checks that ``cfg`` has only those)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache: Dict[str, Any] = {}
    h = C.rmsnorm(params.ln1, x, cfg.norm_eps)
    if mode == "decode":
        out, kvc = self_attention(
            params.attn, h, positions, cfg,
            kv_cache=(cache["k"], cache["v"]), cache_index=cache_index,
            impl=ctx.attn_impl,
        )
        new_cache = {"k": kvc[0], "v": kvc[1]}
    else:
        out, _ = self_attention(
            params.attn, h, positions, cfg, impl=ctx.attn_impl,
            block_k=ctx.attn_block_k,
            ac=ctx.ac if ctx.attn_seq_shard else None,
            bf16_probs=ctx.attn_bf16_probs,
        )
        if mode == "prefill":
            # cache = computed K/V, written densely at positions 0..S (a
            # second projection, as the reference computes it)
            B, S, _ = h.shape
            kh = C.linear(params.attn.wk, h).reshape(B, S, cfg.num_kv_heads,
                                                     cfg.head_dim)
            kh = C.apply_rope(kh, positions, cfg.rope_theta)
            vh = C.linear(params.attn.wv, h).reshape(B, S, cfg.num_kv_heads,
                                                     cfg.head_dim)
            new_cache = {"k": kh, "v": vh}
    x = x + out
    h2 = C.rmsnorm(params.ln2, x, cfg.norm_eps)
    x = x + mlp(params.mlp, h2, cfg.mlp_type)
    x = ctx.ac(x, "batch", None, None)
    return x, new_cache, aux


def run_stack(
    layers: nn.ModuleList,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    ctx: ShardingCtx,
    *,
    mode: str,
    caches=None,  # stacked {"layer_0": {"k", "v"}} (decode), None otherwise
    cache_index: Optional[int] = None,
    memory: Optional[torch.Tensor] = None,
):
    """Walk the layers.  Returns (x, new_caches, aux_total): ``prefill``
    stacks the layers' K/V, ``decode`` returns ``caches`` written in place,
    ``train`` returns empty caches."""
    check_supported(cfg)
    if memory is not None:
        raise NotImplementedError(f"{cfg.name}: cross-attention memory {_LATER}")
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    built = []
    for i, layer in enumerate(layers):
        cache = None
        if mode == "decode":
            cache = {n: caches["layer_0"][n][i] for n in ("k", "v")}
        x, nc, aux = block_apply(layer, x, positions, cfg, ctx, 0, mode=mode,
                                 cache=cache, cache_index=cache_index,
                                 memory=memory)
        aux_total = aux_total + aux
        built.append(nc)
    if mode == "decode":
        return x, caches, aux_total
    if mode == "prefill":
        return x, {"layer_0": {n: torch.stack([c[n] for c in built])
                               for n in ("k", "v")}}, aux_total
    return x, {"layer_0": {}}, aux_total
