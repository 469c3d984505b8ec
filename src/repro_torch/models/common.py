"""Shared model components: RMS norm, RoPE, linear, embeddings, init.

Parameters live in small ``nn.Module`` containers whose attribute names are
the reference's pytree keys (``attn.wq.w``, ``ln1.scale``, ...), so a
reference parameter tree loads by path (``models/params.py``).  The
functions keep the reference's functional form, ``linear(params, x)``, and
its dtype rules: activations in bf16, norms and RoPE in f32, weights cast
to the activation dtype at each use.  Parameters are created without
gradients; the training step (``train/step.py``) turns them on for its
backward pass only, so serving never builds a graph.

Every parameter container has a mirror ``*_specs`` function that gives
the same keys with *logical axis* tuples in place of tensors, as the
reference's do; ``repro_torch.distributed.sharding`` maps logical axes to
mesh axes.  Logical axis names used across the model zoo:

- ``"embed"``: d_model dims (FSDP axis: data, pod)
- ``"qkv"``, ``"mlp"``, ``"vocab"``, ``"inner"``: head, d_ff, vocabulary
  and SSM inner dims (TP axis: model)
- ``"expert"``: the MoE expert dim (expert parallel, the model axis)
- ``None``: replicated
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..distributed.sharding import fsdp_gather, is_dtensor

__all__ = ["he_init", "RMSNorm", "Linear", "Embedding", "rmsnorm",
           "rope_frequencies", "apply_rope", "sinusoidal_positions", "linear",
           "embed", "param", "sigmoid", "silu", "gelu_tanh", "rmsnorm_specs",
           "layernorm_specs", "linear_specs", "embedding_specs", "flat_specs",
           "tree_congruent"]


def param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def he_init(gen: Optional[torch.Generator], shape, fan_in: int, *, device,
            dtype=torch.float32) -> torch.Tensor:
    """``N(0, 1 / fan_in)`` drawn in f32 from ``gen``, then cast; without a
    generator, uninitialised storage (to be loaded)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(np.sqrt(1.0 / max(fan_in, 1))).to(dtype)


# --------------------------------------------------------------------- norms
class RMSNorm(nn.Module):
    def __init__(self, d: int, *, device, dtype=torch.float32):
        super().__init__()
        self.scale = param(torch.ones(d, dtype=dtype, device=device))


def rmsnorm(params: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * fsdp_gather(params.scale).float()
    return out.to(x.dtype)


def rmsnorm_specs() -> dict:
    return {"scale": ("embed",)}


def layernorm_specs() -> dict:
    return {"scale": ("embed",), "bias": ("embed",)}


# ---------------------------------------------------------------------- rope
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: [..., S] integer."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)  # [D/2]
    ang = positions[..., :, None, None].float() * freqs  # [..., S, 1, D/2]
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    """``[seq, d]`` f32: sines then cosines of ``pos / 10000^(2i/d)``,
    built in numpy (float64) as the reference builds them."""
    pos = np.arange(seq)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10_000.0, 2 * i / d)
    out = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(out.astype(np.float32)).to(device)


# -------------------------------------------------------------- activations
# The reference's activations round after every operation in their dtype
# (XLA's expansion of ``logistic`` and ``jax.nn.gelu``'s jaxpr; its
# constants are rounded to the dtype first).  In bf16 that differs from
# torch's fused ``F.silu``/``F.gelu`` in about a third of the values; a
# router's top-k turns such a difference into another expert, so the
# blocks written after the dense family use these forms.
def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return 1 / (1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * sigmoid(x)


#: jax.nn.gelu's constants 0.044715 and sqrt(2/pi), rounded to each dtype
_GELU_C = {dt: tuple(float(c) for c in torch.tensor(
    [0.044715, np.sqrt(2 / np.pi)], dtype=torch.float64).to(dt))
    for dt in (torch.float32, torch.bfloat16, torch.float16)}


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)``, op by op."""
    c1, c2 = _GELU_C[x.dtype]
    inner = x + c1 * (x * x * x)
    return x * (0.5 * (1.0 + torch.tanh(c2 * inner)))


# ------------------------------------------------------------------- linear
class Linear(nn.Module):
    """``w [d_in, d_out]`` (the reference's layout: ``y = x @ w``), optional
    bias ``b [d_out]`` initialised to zero."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 gen: Optional[torch.Generator] = None, device, dtype=torch.float32):
        super().__init__()
        self.w = param(he_init(gen, (d_in, d_out), d_in, device=device, dtype=dtype))
        self.b = (param(torch.zeros(d_out, dtype=dtype, device=device))
                  if bias else None)


def linear_specs(ax_in: Optional[str], ax_out: Optional[str], *,
                 bias: bool = False) -> dict:
    p = {"w": (ax_in, ax_out)}
    if bias:
        p["b"] = (ax_out,)
    return p


def linear(params: Linear, x: torch.Tensor) -> torch.Tensor:
    y = x @ fsdp_gather(params.w).to(x.dtype)
    if params.b is not None:
        y = y + fsdp_gather(params.b).to(x.dtype)
    return y


# ---------------------------------------------------------------- embedding
class Embedding(nn.Module):
    """``table [vocab, d]``, ``N(0, 0.02^2)``."""

    def __init__(self, vocab: int, d: int, *, gen: Optional[torch.Generator] = None,
                 device, dtype=torch.float32):
        super().__init__()
        if gen is None:
            t = torch.empty((vocab, d), dtype=dtype, device=device)
        else:
            t = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                            device=device).mul_(0.02).to(dtype)
        self.table = param(t)


def embed(params: Embedding, tokens: torch.Tensor,
          dtype=torch.bfloat16) -> torch.Tensor:
    table = fsdp_gather(params.table)
    if is_dtensor(table):
        return _sharded_embed(table, tokens, dtype)
    return table[tokens].to(dtype)


def _sharded_embed(table: torch.Tensor, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """``table[tokens]`` for a DTensor table ``[V, d]`` whose vocabulary a
    model mesh may split (Megatron's vocab-parallel embedding): each rank
    looks its own rows' tokens up in its vocabulary slice, zero outside
    it, and the rows are summed over the mesh dims that split the
    vocabulary.  DTensor's own rules fail here: indexing's backward (an
    index_put of a batch-split gradient) on PyTorch 2.11, and its
    embedding rule's masked partial sum meets a plain one in the
    backward.  Returns a DTensor ``[*tokens.shape, d]`` split as the
    tokens' rows."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = table.device_mesh
    vocab = [d for d, p in enumerate(table.placements) if p == Shard(0)]
    table = table.redistribute(mesh, [Shard(0) if d in vocab else Replicate()
                                      for d in range(mesh.ndim)])
    if not is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    rows = [Shard(0) if p == Shard(0) and d not in vocab else Replicate()
            for d, p in enumerate(tokens.placements)]
    tok = tokens.redistribute(mesh, rows).to_local()
    _, offset = compute_local_shape_and_global_offset(table.shape, mesh, table.placements)
    # the slice's gradient: the rank's rows' partial sum on the batch split
    local = table.to_local(grad_placements=[
        Shard(0) if d in vocab else Partial() if rows[d] == Shard(0) else Replicate()
        for d in range(mesh.ndim)])
    out = _VocabEmbed.apply(local, tok, offset[0], [(mesh, d) for d in vocab]).to(dtype)
    shape = torch.Size((*tokens.shape, table.shape[1]))
    return DTensor.from_local(out, mesh, rows, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


class _VocabEmbed(torch.autograd.Function):
    """The local half of :func:`_sharded_embed`: ``local [v, d]`` holds
    vocabulary ids ``v0 .. v0 + v``; ``groups`` are the (mesh, dim)
    groups the vocabulary is split over."""

    @staticmethod
    def forward(ctx, local, tokens, v0, groups):
        import torch.distributed._functional_collectives as funcol

        idx = tokens - v0
        inside = (idx >= 0) & (idx < local.shape[0])
        idx = torch.where(inside, idx, 0)
        out = torch.where(inside[..., None], local[idx], 0.0)
        for g in groups:
            out = funcol.wait_tensor(funcol.all_reduce(out, "sum", g))
        ctx.save_for_backward(idx, inside)
        ctx.rows = local.shape[0]
        return out

    @staticmethod
    def backward(ctx, g):
        idx, inside = ctx.saved_tensors
        grad = g.new_zeros((ctx.rows, g.shape[-1]))
        grad.index_put_((idx,), torch.where(inside[..., None], g, 0.0), accumulate=True)
        return grad, None, None, None


def embedding_specs() -> dict:
    return {"table": ("vocab", "embed")}


# ------------------------------------------------------------ tree utilities
def flat_specs(specs, prefix: str = "") -> dict:
    """A nested spec dict as ``{"a.b.c": logical tuple}`` (parameter names)."""
    out = {}
    for k, v in specs.items():
        if isinstance(v, dict):
            out.update(flat_specs(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def tree_congruent(params, specs) -> bool:
    """Same leaves: ``params`` (a module, or nested dicts of tensors) and
    ``specs`` (nested or flat dicts of logical tuples) name the same
    parameters."""
    if isinstance(params, nn.Module):
        names = {n for n, _ in params.named_parameters()}
    else:
        names = {n for n, v in flat_specs(params).items() if v is not None}
    return names == set(flat_specs(specs))
