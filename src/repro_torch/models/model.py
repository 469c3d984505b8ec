"""Top-level model API: init / forward / train_loss / prefill / decode_step.

The entry points the serving launcher and the training step use, for
every registered arch.  Batch layouts, as in the reference::

    train:   {"tokens": [B,S] integer, "labels": [B,S] integer}
             (+ the frontend inputs below)
    prefill: {"tokens": [B,S] integer}
             (+ "patch_embeds": [B,prefix,d] (vlm) | "frames": [B,T,d] (audio))
    decode:  tokens [B,1], cache_index int, the caches pytree

Cache layout: ``{"stack": {"layer_j": {...}}, "memory": enc_out | None}``.
``stack`` holds one entry for each layer of a group (``j <
cfg.group_period``), its leaves stacked over the groups ``[num_groups,
...]``: attention ``k``/``v [G, B, S, Hkv, hd]`` in bf16, SSD and mLSTM
``h`` (f32) and ``conv [G, B, 3, d_inner]``, sLSTM ``h``/``c [G, B, H, P]``
(f32).  ``memory`` is whisper's encoder output, computed once at prefill
and carried so decode steps never re-run the encoder.  ``decode_step``
writes each layer's new K/V or state into the caches in place (the
reference donates the cache buffers) and returns the same dict.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..config import ModelConfig
from ..core.executor import resolve_device
from ..distributed.sharding import ShardingCtx, fsdp_gather, is_dtensor
from . import common as C
from . import transformer as T
from .attention import self_attention
from .mlp import mlp

__all__ = ["Model", "init_params", "param_specs", "forward", "train_loss", "prefill",
           "decode_step", "init_decode_caches", "pad_caches"]


class Encoder(nn.Module):
    """Whisper's encoder: ``layers`` (attention + gelu MLP blocks of
    :func:`_encoder_cfg`) and ``final_norm``."""

    def __init__(self, cfg: ModelConfig, *, gen: Optional[torch.Generator] = None,
                 device, dtype=torch.float32):
        super().__init__()
        enc = _encoder_cfg(cfg)
        kw = dict(device=device, dtype=dtype)
        self.layers = nn.ModuleList(T.Block(enc, 0, gen=gen, **kw)
                                    for _ in range(enc.num_layers))
        self.final_norm = C.RMSNorm(cfg.d_model, **kw)


class Model(nn.Module):
    """The parameters of a model: ``embed``, ``layers`` (layer ``i`` a
    :class:`~repro_torch.models.transformer.Block` of kind
    ``cfg.layer_kind(i % cfg.group_period)``), ``final_norm``, ``lm_head``
    unless the embeddings are tied, and ``encoder`` for an
    encoder-decoder.  Drawn from ``gen`` in that order, or left
    uninitialised (to be loaded) without one."""

    def __init__(self, cfg: ModelConfig, *, gen: Optional[torch.Generator] = None,
                 device, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embed = C.Embedding(cfg.vocab_size, cfg.d_model, gen=gen, **kw)
        self.layers = nn.ModuleList(T.Block(cfg, i % cfg.group_period, gen=gen, **kw)
                                    for i in range(cfg.num_layers))
        self.final_norm = C.RMSNorm(cfg.d_model, **kw)
        self.lm_head = (None if cfg.tie_embeddings else
                        C.Linear(cfg.d_model, cfg.vocab_size, gen=gen, **kw))
        self.encoder = Encoder(cfg, gen=gen, **kw) if cfg.encdec else None


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


def param_specs(cfg: ModelConfig) -> Dict[str, tuple]:
    """Each of :class:`Model`'s parameter names -> its logical axes.  A
    layer's tensor has no group axis, so its spec is the reference's
    without the leading ``"layers"`` (which every rule set replicates);
    ``models/params.py``'s ``reference_path`` maps it back."""
    p: Dict[str, Any] = {
        "embed": C.embedding_specs(),
        "layers": {str(i): T.block_specs(cfg, i % cfg.group_period)
                   for i in range(cfg.num_layers)},
        "final_norm": C.rmsnorm_specs(),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = C.linear_specs("embed", "vocab")
    if cfg.encdec:
        enc = _encoder_cfg(cfg)
        p["encoder"] = {
            "layers": {str(i): T.block_specs(enc, i % enc.group_period)
                       for i in range(enc.num_layers)},
            "final_norm": C.rmsnorm_specs(),
        }
    return C.flat_specs(p)


def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(
        cfg,
        num_layers=cfg.num_encoder_layers,
        encdec=False,
        num_experts=0,
        attn_every=0,
        mlp_type="gelu",
    )


# --------------------------------------------------------------- backbone
def _input(params: Model, x) -> torch.Tensor:
    """A float input (numpy or torch) on the parameters' device, in f32."""
    return torch.as_tensor(x, device=params.embed.table.device).float()


def _embed_inputs(params: Model, batch, cfg: ModelConfig, ctx: ShardingCtx):
    """Token embeddings (+ the vision prefix) and positions."""
    tokens = torch.as_tensor(batch["tokens"], device=params.embed.table.device).long()
    x = C.embed(params.embed, tokens)
    if cfg.frontend == "vision_stub" and "patch_embeds" in batch:
        # precomputed patch embeddings prefix the token sequence
        # (PaliGemma-style prefix-LM, causal mask retained)
        x = torch.cat([_input(params, batch["patch_embeds"]).to(x.dtype), x], dim=1)
    if cfg.family in ("vlm",) or cfg.name.startswith("gemma"):
        # gemma-family embedding scaling, in the activation dtype
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    x = ctx.ac(x, "batch", None, None)
    return x, positions


def _encode(params: Model, batch, cfg: ModelConfig, ctx: ShardingCtx):
    """Whisper-style encoder over (stub) audio frame embeddings ``frames
    [B, T, d]``: bf16 frames plus sinusoidal positions, non-causal
    attention + gelu blocks, the final norm."""
    enc_cfg = _encoder_cfg(cfg)
    x = _input(params, batch["frames"]).to(torch.bfloat16)
    x = x + C.sinusoidal_positions(x.shape[1], cfg.d_model, x.device).to(x.dtype)
    x = _run_encoder_stack(params.encoder.layers, x, enc_cfg, ctx)
    return C.rmsnorm(params.encoder.final_norm, x, cfg.norm_eps)


def _run_encoder_stack(layers: nn.ModuleList, x: torch.Tensor,
                       enc_cfg: ModelConfig, ctx: ShardingCtx) -> torch.Tensor:
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    for blk in layers:
        h = C.rmsnorm(blk.ln1, x, enc_cfg.norm_eps)
        out, _ = self_attention(
            blk.attn, h, positions, enc_cfg, causal=False, impl=ctx.attn_impl,
            bf16_probs=ctx.attn_bf16_probs,
        )
        x = x + out
        h2 = C.rmsnorm(blk.ln2, x, enc_cfg.norm_eps)
        x = x + mlp(blk.mlp, h2, enc_cfg.mlp_type)
    return x


def _head(params: Model, x: torch.Tensor, cfg: ModelConfig, ctx: ShardingCtx):
    x = C.rmsnorm(params.final_norm, x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ fsdp_gather(params.embed.table).T.to(x.dtype)
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
    """Shared backbone.  Returns (logits, new_caches, aux).  ``remat``: in
    train mode under autograd, each layer is recomputed in the backward
    pass (``transformer.run_stack``)."""
    if cfg.encdec and memory is None and mode != "decode":
        memory = _encode(params, batch, cfg, ctx)
    x, positions = _embed_inputs(params, batch, cfg, ctx)
    if mode == "decode" and cache_index is not None:
        B, S = x.shape[0], x.shape[1]
        positions = int(cache_index) + torch.arange(
            S, dtype=torch.int32, device=x.device).expand(B, S)
    x, new_caches, aux = T.run_stack(
        params.layers, x, positions, cfg, ctx,
        mode=mode, caches=caches, cache_index=cache_index, memory=memory,
        remat=remat,
    )
    logits = _head(params, x, cfg, ctx)
    return logits, new_caches, aux


# ------------------------------------------------------------------ losses
def train_loss(
    params: Model, batch, cfg: ModelConfig, ctx: ShardingCtx, *,
    aux_coef: float = 0.01, remat: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token NLL over the positions with ``labels >= 0`` (the
    vision prefix carries none), plus ``aux_coef`` x the MoE aux loss.
    Returns (total, {"loss", "aux", "tokens"})."""
    logits, _, aux = forward(params, batch, cfg, ctx, mode="train", remat=remat)
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    if cfg.frontend == "vision_stub" and "patch_embeds" in batch:
        # prefix positions carry no next-token loss
        logits = logits[:, batch["patch_embeds"].shape[1]:]
    if is_dtensor(logits):
        nll = _sharded_nll(logits.float(), labels.clamp(min=0))
    else:
        logp = torch.log_softmax(logits.float(), dim=-1)
        # masked labels pick any finite entry: the mask zeroes it
        nll = -torch.gather(logp, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    total = loss + aux_coef * aux
    return total, {"loss": loss, "aux": aux, "tokens": mask.sum()}


def _sharded_nll(lf: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``-log_softmax(lf)[label]`` of DTensor logits ``[B, S, V]`` whose
    vocabulary a model mesh may split: each rank works on its own rows
    and vocabulary slice (Megatron's vocab-parallel cross-entropy), the
    max, the sum of exponentials and the label's logit all-reduced over
    the mesh dims that split the vocabulary.  DTensor's own log-softmax
    would gather the whole vocabulary, and its backward placements
    gathered the batch.  Returns a DTensor ``[B, S]``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh, vdim = lf.device_mesh, lf.dim() - 1
    rows = [Replicate() if isinstance(p, Shard) and p.dim == vdim else
            (Replicate() if not isinstance(p, Shard) else p) for p in lf.placements]
    lf = lf.redistribute(mesh, [p if isinstance(p, Shard) else Replicate()
                                for p in lf.placements])
    split = [d for d, p in enumerate(lf.placements)
             if isinstance(p, Shard) and p.dim == vdim]
    _, offset = compute_local_shape_and_global_offset(lf.shape, mesh, lf.placements)
    labels = labels.redistribute(mesh, rows) if is_dtensor(labels) else \
        DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                           run_check=False).redistribute(mesh, rows)
    out = _VocabNLL.apply(lf.to_local(), labels.to_local(), offset[vdim],
                          [(mesh, d) for d in split])
    return DTensor.from_local(out, mesh, rows, run_check=False, shape=labels.shape,
                              stride=labels.stride())


class _VocabNLL(torch.autograd.Function):
    """The local half of :func:`_sharded_nll`: ``local [b, S, v]`` f32
    logits of vocabulary ids ``v0 .. v0 + v``, ``labels [b, S]``, and the
    (mesh, dim) groups the vocabulary is split over."""

    @staticmethod
    def forward(ctx, local, labels, v0, groups):
        import torch.distributed._functional_collectives as funcol

        def reduce(t, op):
            for g in groups:
                t = funcol.wait_tensor(funcol.all_reduce(t, op, g))
            return t

        m = reduce(local.amax(dim=-1, keepdim=True), "max")
        z = local - m
        e = torch.exp(z)
        se = reduce(e.sum(dim=-1, keepdim=True), "sum")
        idx = labels - v0
        inside = (idx >= 0) & (idx < local.shape[-1])
        idx = idx.clamp(0, local.shape[-1] - 1)
        picked = torch.where(inside, torch.gather(z, -1, idx[..., None])[..., 0], 0.0)
        picked = reduce(picked, "sum")
        ctx.save_for_backward(e, se, idx, inside)
        return torch.log(se[..., 0]) - picked

    @staticmethod
    def backward(ctx, g):
        e, se, idx, inside = ctx.saved_tensors
        grad = e / se * g[..., None]
        hit = torch.where(inside, g, 0.0)
        grad = grad.scatter_add(-1, idx[..., None], -hit[..., None])
        return grad, None, None, None


# ---------------------------------------------------------------- serving
def prefill(params: Model, batch, cfg: ModelConfig, ctx: ShardingCtx):
    """Full-sequence forward; returns (last_logits, caches)."""
    memory = _encode(params, batch, cfg, ctx) if cfg.encdec else None
    logits, stack, _ = forward(params, batch, cfg, ctx, mode="prefill",
                               memory=memory)
    return logits[:, -1], {"stack": stack, "memory": memory}


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
    """Zero caches in the layout of the module docstring: attention K/V of
    ``max_seq`` positions, SSM states, and for an encoder-decoder a zero
    ``memory [batch, encoder_seq, d]`` (the reference's placeholder)."""
    dev = resolve_device(device)
    memory = None
    if cfg.encdec:
        memory = torch.zeros((batch, cfg.encoder_seq, cfg.d_model), dtype=dtype,
                             device=dev)
    return {"stack": T.stacked_cache_init(cfg, batch, max_seq, dtype, device=dev),
            "memory": memory}


def pad_caches(caches, cfg: ModelConfig, *, max_seq: int):
    """Grow prefill KV caches (``[G,B,S,Hkv,hd]``) to a decode budget of
    max_seq (zeros after the prompt).  Only the 5-D attention ``k``/``v``
    leaves have a sequence axis; SSM states (the 5-D ``h`` included), conv
    states and ``memory`` pass through unchanged."""

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
