"""Decoder assembly: heterogeneous blocks, the group stack, KV/SSM caches.

All ten architectures are assembled from the same machinery, as in the
reference:

- ``cfg.layer_kind(j)`` decides each layer's mixer (attn / ssd / mlstm /
  slstm) and MLP (dense / moe / none).  Layer kinds repeat with period
  ``cfg.group_period`` (1 for homogeneous stacks, 8 for Jamba, 4 for
  xLSTM).  The reference stacks each group's parameters as
  ``[num_groups, ...]`` and runs the stack as one ``lax.scan``; here the
  layers are an ``nn.ModuleList`` walked by a Python loop, layer
  ``g * period + j`` playing ``layer_j`` of group ``g``.
- Caches keep the reference's stacked layout at the model's public
  functions: ``{"layer_j": {...}}`` with leaves ``[num_groups, ...]``
  (attention ``k``/``v [G, B, S, Hkv, hd]``; SSD and mLSTM ``h``, ``conv``;
  sLSTM ``h``, ``c``).
- Three modes: ``train`` (no caches), ``prefill`` (returns the stacked
  caches), ``decode`` (writes each layer's slice of the caches in place,
  static cache shapes, position-masked attention).
- Under a model mesh the residual stream is constrained to ``("batch",
  None, None)`` after the mixer as well as at the block's end (the
  reference constrains it at the end only; GSPMD reduces the mixer's
  partial sums before the MLP by itself, DTensor would instead gather the
  MLP's weights whole and compute on the partial sums).  Without a mesh
  ``ac`` is the identity.
- ``remat`` (train mode, under autograd): each layer runs under
  ``torch.utils.checkpoint``, so the backward pass recomputes one layer at
  a time, the bf16 casts of its weights included, instead of keeping every
  layer's activations: the reference's per-group and nested per-layer
  ``jax.checkpoint``.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig
from ..distributed.sharding import ShardingCtx
from . import common as C
from . import moe as MOE
from . import ssm as SSM
from .attention import (Attention, _split_heads, attn_specs, cross_attention,
                        self_attention)
from .mlp import MLP, mlp, mlp_specs

__all__ = ["Block", "block_apply", "block_cache_init", "block_specs", "run_stack",
           "stacked_cache_init", "stacked_cache_specs", "stacked_group_specs"]

_MIXERS = {"ssd": (SSM.SSD, SSM.ssd_block, SSM.ssd_state_init, SSM.ssd_specs),
           "mlstm": (SSM.MLSTM, SSM.mlstm_block, SSM.mlstm_state_init,
                     SSM.mlstm_specs),
           "slstm": (SSM.SLSTM, SSM.slstm_block, SSM.slstm_state_init,
                     SSM.slstm_specs)}


class Block(nn.Module):
    """One layer of kind ``cfg.layer_kind(layer_in_group)``: ``ln1`` and
    the mixer (``attn``, plus ``ln_x`` and ``xattn`` for an
    encoder-decoder; or ``ssd``, ``mlstm``, ``slstm``), then ``ln2`` and
    ``mlp`` or ``moe`` unless the MLP is ``none``."""

    def __init__(self, cfg: ModelConfig, layer_in_group: int, *,
                 gen: Optional[torch.Generator] = None, device, dtype=torch.float32):
        super().__init__()
        mixer, mlp_kind = cfg.layer_kind(layer_in_group)
        kw = dict(device=device, dtype=dtype)
        self.ln1 = C.RMSNorm(cfg.d_model, **kw)
        if mixer == "attn":
            self.attn = Attention(cfg, gen=gen, **kw)
            if cfg.encdec:
                self.ln_x = C.RMSNorm(cfg.d_model, **kw)
                self.xattn = Attention(cfg, gen=gen, **kw)
        else:
            setattr(self, mixer, _MIXERS[mixer][0](cfg, gen=gen, **kw))
        if mlp_kind == "dense":
            self.ln2 = C.RMSNorm(cfg.d_model, **kw)
            self.mlp = MLP(cfg.d_model, cfg.dense_d_ff or cfg.d_ff, cfg.mlp_type,
                           gen=gen, **kw)
        elif mlp_kind == "moe":
            self.ln2 = C.RMSNorm(cfg.d_model, **kw)
            self.moe = MOE.MoE(cfg, gen=gen, **kw)


def block_specs(cfg: ModelConfig, layer_in_group: int) -> dict:
    """Logical axes of one :class:`Block`'s parameters (no group axis)."""
    mixer, mlp_kind = cfg.layer_kind(layer_in_group)
    p: Dict[str, Any] = {"ln1": C.rmsnorm_specs()}
    if mixer == "attn":
        p["attn"] = attn_specs(cfg)
        if cfg.encdec:
            p["ln_x"] = C.rmsnorm_specs()
            p["xattn"] = attn_specs(cfg)
    else:
        p[mixer] = _MIXERS[mixer][3](cfg)
    if mlp_kind == "dense":
        p["ln2"] = C.rmsnorm_specs()
        p["mlp"] = mlp_specs(cfg.mlp_type)
    elif mlp_kind == "moe":
        p["ln2"] = C.rmsnorm_specs()
        p["moe"] = MOE.moe_specs(cfg)
    return p


def stacked_group_specs(cfg: ModelConfig) -> dict:
    """The reference's stacked layout: ``{"layer_j": specs}`` with the
    group axis ``"layers"`` in front of every leaf."""
    def stack(tree):
        return {k: stack(v) if isinstance(v, dict) else ("layers",) + v
                for k, v in tree.items()}

    return {f"layer_{j}": stack(block_specs(cfg, j))
            for j in range(cfg.group_period)}


def _block_cache_specs(cfg: ModelConfig, layer_in_group: int) -> dict:
    """Logical axes of one block's decode cache, stacked over the groups
    (mirrors :func:`block_cache_init`)."""
    mixer, _ = cfg.layer_kind(layer_in_group)
    if mixer == "attn":
        kv = ("layers", "batch", "kvseq", "heads_kv", None)
        return {"k": kv, "v": kv}
    if mixer in ("ssd", "mlstm"):
        return {"h": ("layers", "batch", "heads", None, None),
                "conv": ("layers", "batch", None, "inner")}
    return {"h": ("layers", "batch", "heads", None),
            "c": ("layers", "batch", "heads", None)}


def stacked_cache_specs(cfg: ModelConfig) -> dict:
    return {f"layer_{j}": _block_cache_specs(cfg, j)
            for j in range(cfg.group_period)}


def block_cache_init(cfg: ModelConfig, layer_in_group: int, batch: int,
                     max_seq: int, dtype=torch.bfloat16, *, device) -> dict:
    """Static-shape cache for one block (decode mode)."""
    mixer, _ = cfg.layer_kind(layer_in_group)
    if mixer == "attn":
        shape = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
        return {n: torch.zeros(shape, dtype=dtype, device=device) for n in ("k", "v")}
    return _MIXERS[mixer][2](cfg, batch, dtype, device=device)


def stacked_cache_init(cfg: ModelConfig, batch: int, max_seq: int,
                       dtype=torch.bfloat16, *, device) -> dict:
    """``{"layer_j": {name: [num_groups, ...]}}`` of zeros."""
    out = {}
    for j in range(cfg.group_period):
        one = block_cache_init(cfg, j, batch, max_seq, dtype, device=device)
        out[f"layer_{j}"] = {n: t[None].repeat(cfg.num_groups, *([1] * t.dim()))
                             for n, t in one.items()}
    return out


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
    memory: Optional[torch.Tensor] = None,  # enc-dec cross-attention memory
):
    """Returns (x, new_cache, aux_loss)."""
    mixer, mlp_kind = cfg.layer_kind(layer_in_group)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache: Dict[str, Any] = {}
    h = C.rmsnorm(params.ln1, x, cfg.norm_eps)

    if mixer == "attn":
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
                bf16_probs=ctx.attn_bf16_probs,
            )
            if mode == "prefill":
                # cache = computed K/V, written densely at positions 0..S (a
                # second projection, as the reference computes it)
                B, S, _ = h.shape
                kh = _split_heads(C.linear(params.attn.wk, h), cfg.num_kv_heads,
                                  cfg.head_dim)
                kh = C.apply_rope(kh, positions, cfg.rope_theta)
                vh = _split_heads(C.linear(params.attn.wv, h), cfg.num_kv_heads,
                                  cfg.head_dim)
                new_cache = {"k": kh, "v": vh}
        x = ctx.ac(x + out, "batch", None, None)
        if cfg.encdec and memory is not None:
            hx = C.rmsnorm(params.ln_x, x, cfg.norm_eps)
            x = ctx.ac(x + cross_attention(params.xattn, hx, memory, cfg,
                                           impl=ctx.attn_impl,
                                           bf16_probs=ctx.attn_bf16_probs),
                       "batch", None, None)
    else:
        out, st = _MIXERS[mixer][1](getattr(params, mixer), h, cfg, ctx,
                                    state=cache if mode == "decode" else None)
        if mode != "train":
            new_cache = st
        x = ctx.ac(x + out, "batch", None, None)

    if mlp_kind == "dense":
        h2 = C.rmsnorm(params.ln2, x, cfg.norm_eps)
        x = x + mlp(params.mlp, h2, cfg.mlp_type)
    elif mlp_kind == "moe":
        h2 = C.rmsnorm(params.ln2, x, cfg.norm_eps)
        y, aux = MOE.moe_ffn(params.moe, h2, cfg, ctx)
        x = x + y
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
    caches=None,  # stacked {"layer_j": {name: [G, ...]}} (decode), else None
    cache_index: Optional[int] = None,
    memory: Optional[torch.Tensor] = None,
    remat: bool = True,
):
    """Walk the layers, layer ``g * period + j`` as ``layer_j`` of group
    ``g``.  Returns (x, new_caches, aux_total): ``prefill`` stacks each
    ``layer_j``'s caches over the groups, ``decode`` returns ``caches``
    with each layer's slice written in place, ``train`` empty caches.
    ``aux_total`` sums the aux loss of each group's last layer only: the
    reference's group body adds the ``aux`` its layer loop ends with, so
    Jamba's (period 8) counts layer 7 of each group, as it does there (kept
    for parity in training too).  ``remat``: see the module docstring."""
    period = cfg.group_period
    use_remat = remat and mode == "train" and torch.is_grad_enabled()
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    built = []
    for i, layer in enumerate(layers):
        g, j = divmod(i, period)
        cache = None
        if mode == "decode":
            cache = {n: t[g] for n, t in caches[f"layer_{j}"].items()}
        fn = functools.partial(block_apply, layer, cfg=cfg, ctx=ctx,
                               layer_in_group=j, mode=mode, cache=cache,
                               cache_index=cache_index)
        if use_remat:
            x, nc, aux = checkpoint(fn, x, positions, memory=memory,
                                    use_reentrant=False)
        else:
            x, nc, aux = fn(x, positions, memory=memory)
        if j == period - 1:
            aux_total = aux_total + aux
        if mode == "decode":
            for n, t in nc.items():
                if t is not cache[n]:  # an SSM state: attention wrote K/V in place
                    cache[n].copy_(t)
        built.append(nc)
    if mode == "decode":
        return x, caches, aux_total
    if mode == "prefill":
        stacked = {}
        for j in range(period):
            group = built[j::period]
            stacked[f"layer_{j}"] = {n: torch.stack([c[n] for c in group])
                                     for n in group[0]}
        return x, stacked, aux_total
    return x, {f"layer_{j}": {} for j in range(period)}, aux_total
