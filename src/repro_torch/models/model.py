"""Top-level model API: init / forward / prefill / decode_step, dense family.

The entry points the serving launcher uses.  Batch layouts, as in the
reference::

    prefill: {"tokens": [B,S] integer}
    decode:  tokens [B,1], cache_index int, the caches pytree

Cache layout: ``{"stack": {"layer_0": {"k", "v"}}, "memory": None}`` with
K/V leaves ``[num_layers, B, S, Hkv, hd]`` in bf16.  ``decode_step``
writes the new token's K/V into the caches in place (the reference donates
the cache buffers) and returns the same dict.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ..config import ModelConfig
from ..core.executor import resolve_device
from ..distributed.sharding import ShardingCtx
from . import common as C
from . import transformer as T

__all__ = ["Model", "init_params", "forward", "prefill", "decode_step",
           "init_decode_caches", "pad_caches"]


class Model(nn.Module):
    """The parameters of a dense decoder: ``embed``, ``layers`` (one
    :class:`~repro_torch.models.transformer.Block` each), ``final_norm``
    and, unless the embeddings are tied, ``lm_head``.  Drawn from ``gen``
    in that order, or left uninitialised (to be loaded) without one."""

    def __init__(self, cfg: ModelConfig, *, gen: Optional[torch.Generator] = None,
                 device, dtype=torch.float32):
        super().__init__()
        T.check_supported(cfg)
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embed = C.Embedding(cfg.vocab_size, cfg.d_model, gen=gen, **kw)
        self.layers = nn.ModuleList(T.Block(cfg, gen=gen, **kw)
                                    for _ in range(cfg.num_layers))
        self.final_norm = C.RMSNorm(cfg.d_model, **kw)
        self.lm_head = (None if cfg.tie_embeddings else
                        C.Linear(cfg.d_model, cfg.vocab_size, gen=gen, **kw))


# ------------------------------------------------------------------- init
def init_params(seed: int, cfg: ModelConfig, dtype=torch.bfloat16, *,
                device="cuda") -> Model:
    """Random parameters from a generator on ``device`` seeded with
    ``seed``: he-normal weights (``N(0, 1/fan_in)``), ``N(0, 0.02^2)``
    embeddings, zero biases, unit norms (the reference's distributions, not
    its numbers)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return Model(cfg, gen=gen, device=dev, dtype=dtype)


# --------------------------------------------------------------- backbone
def _embed_inputs(params: Model, batch, cfg: ModelConfig, ctx: ShardingCtx):
    """Token embeddings and positions."""
    tokens = torch.as_tensor(batch["tokens"], device=params.embed.table.device).long()
    x = C.embed(params.embed, tokens)
    if cfg.family in ("vlm",) or cfg.name.startswith("gemma"):
        # gemma-family embedding scaling, in the activation dtype
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    x = ctx.ac(x, "batch", None, None)
    return x, positions


def _head(params: Model, x: torch.Tensor, cfg: ModelConfig, ctx: ShardingCtx):
    x = C.rmsnorm(params.final_norm, x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params.embed.table.T.to(x.dtype)
    else:
        logits = C.linear(params.lm_head, x)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return ctx.ac(logits, "batch", None, "vocab")


def forward(
    params: Model, batch, cfg: ModelConfig, ctx: ShardingCtx, *, mode: str,
    caches=None, cache_index: Optional[int] = None, remat: bool = True,
    memory=None,
):
    """Shared backbone.  Returns (logits, new_caches, aux).  ``remat`` is
    accepted for the reference's signature; nothing is trained here."""
    x, positions = _embed_inputs(params, batch, cfg, ctx)
    if mode == "decode" and cache_index is not None:
        B, S = x.shape[0], x.shape[1]
        positions = int(cache_index) + torch.arange(
            S, dtype=torch.int32, device=x.device).expand(B, S)
    x, new_caches, aux = T.run_stack(
        params.layers, x, positions, cfg, ctx,
        mode=mode, caches=caches, cache_index=cache_index, memory=memory,
    )
    logits = _head(params, x, cfg, ctx)
    return logits, new_caches, aux


# ---------------------------------------------------------------- serving
def prefill(params: Model, batch, cfg: ModelConfig, ctx: ShardingCtx):
    """Full-sequence forward; returns (last_logits, caches)."""
    logits, stack, _ = forward(params, batch, cfg, ctx, mode="prefill")
    return logits[:, -1], {"stack": stack, "memory": None}


def decode_step(params: Model, tokens, caches, cache_index: int,
                cfg: ModelConfig, ctx: ShardingCtx):
    """One token step.  tokens: [B,1]; returns (logits [B,V], caches), the
    caches written in place."""
    logits, new_stack, _ = forward(
        params, {"tokens": tokens}, cfg, ctx, mode="decode",
        caches=caches["stack"], cache_index=cache_index,
        memory=caches.get("memory"),
    )
    return logits[:, -1], {"stack": new_stack, "memory": caches.get("memory")}


def init_decode_caches(cfg: ModelConfig, batch: int, max_seq: int,
                       dtype=torch.bfloat16, *, device="cuda") -> Dict[str, Any]:
    T.check_supported(cfg)
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    kv = {n: torch.zeros(shape, dtype=dtype, device=dev) for n in ("k", "v")}
    return {"stack": {"layer_0": kv}, "memory": None}


def pad_caches(caches, cfg: ModelConfig, *, max_seq: int):
    """Grow prefill KV caches ([L,B,S,...]) to a decode budget of max_seq
    (zeros after the prompt); other leaves pass through."""

    def one(name, leaf):
        if name in ("k", "v") and isinstance(leaf, torch.Tensor) and leaf.dim() == 5:
            pad = max_seq - leaf.shape[2]
            if pad <= 0:
                return leaf
            return torch.nn.functional.pad(leaf, (0, 0, 0, 0, 0, pad))
        if isinstance(leaf, dict):
            return {k: one(k, v) for k, v in leaf.items()}
        return leaf

    return {k: one(k, v) for k, v in caches.items()}
