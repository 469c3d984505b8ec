"""Mixture-of-Experts FFN with sort-based capacity dispatch.

The port of ``repro/models/moe.py``.  Routing is the reference's, batched
over B in place of its ``vmap``: an f32 router, softmax, top-k, gates
renormalised, a stable sort of the (token, choice) pairs by expert, each
pair's rank within its expert, and a drop past the GShard capacity
``C = ceil8(S * top_k / E * capacity_factor)`` (at least 8).

Dispatch and combine move no float through an atomic, so a run repeats
bitwise on the card: tokens are scattered (plain writes, each kept slot
written once) into an ``[B, E*C + 1, d]`` buffer whose last row is the
drop bin; the combine gathers each token's k expert outputs through the
inverse of the sort and adds them in the sorted (expert) order, the
order the reference's ``.at[tok].add`` applies its updates.  The einsums
and the router are plain PyTorch: the reference computes them outside
any Pallas kernel.

Under a model mesh the routing, the dispatch into the buffer and the
combine run on each rank's own batch rows (``sharding.on_local_shards``):
each row routes alone, DTensor has no rule for ``searchsorted``, and the
buffer is a new tensor each rank fills.  The expert einsums are DTensor
ops on the buffer split over the ``expert`` axis.

Returns the Switch load-balancing auxiliary loss beside the outputs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..config import ModelConfig
from ..distributed.sharding import ShardingCtx, fsdp_gather, is_dtensor, on_local_shards
from . import common as C

__all__ = ["MoE", "moe_ffn", "moe_specs"]


class MoE(nn.Module):
    """``router.w [d, E]``, ``wg``/``wu [E, d, ff]`` (no ``wg`` for gelu),
    ``wd [E, ff, d]``."""

    def __init__(self, cfg: ModelConfig, *, gen: Optional[torch.Generator] = None,
                 device, dtype=torch.float32):
        super().__init__()
        d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
        kw = dict(device=device, dtype=dtype)
        self.router = C.Linear(d, E, gen=gen, **kw)
        self.wg = (None if cfg.mlp_type == "gelu" else
                   C.param(C.he_init(gen, (E, d, ff), d, **kw)))
        self.wu = C.param(C.he_init(gen, (E, d, ff), d, **kw))
        self.wd = C.param(C.he_init(gen, (E, ff, d), ff, **kw))


def moe_specs(cfg: ModelConfig) -> dict:
    p = {
        "router": {"w": ("embed", None)},
        "wg": ("expert", "embed_expert", "mlp_expert"),
        "wu": ("expert", "embed_expert", "mlp_expert"),
        "wd": ("expert", "mlp_expert", "embed_expert"),
    }
    if cfg.mlp_type == "gelu":
        p.pop("wg")
    return p


def _capacity(seq: int, cfg: ModelConfig) -> int:
    c = int(seq * cfg.top_k / cfg.num_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)  # >=8 and a multiple of 8, as the reference


def _route(x: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig):
    """The f32 router: ``probs [B, S, E]``, then each token's top-k
    experts ``eidx [B, S, k]`` (descending) and their gates renormalised
    to sum to 1."""
    logits = x.float() @ router_w.float()  # [B, S, E]
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, eidx


def _dispatch(x: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig, cap: int):
    """Every batch row: route, sort by expert, rank within capacity.
    Returns ``slot, tok, keep, gate_sorted`` ``[B, S*k]`` (sorted order),
    the aux loss ``[B]`` and the sort's order."""
    B, S, _ = x.shape
    E, k = cfg.num_experts, cfg.top_k
    probs, gates, eidx = _route(x, router_w, cfg)

    flat_e = eidx.reshape(B, S * k)
    order = torch.sort(flat_e, dim=-1, stable=True).indices
    se = torch.gather(flat_e, 1, order)
    tok = order // k
    experts = torch.arange(E, device=x.device).expand(B, E).contiguous()
    starts = torch.searchsorted(se, experts, side="left")  # [B, E]
    rank = torch.arange(S * k, device=x.device) - torch.gather(starts, 1, se)
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, E * cap)  # E*cap = drop bin

    # load-balance aux (Switch): E * sum_e f_e * P_e; integer counts
    counts = (flat_e[:, :, None] == experts[:, None, :]).sum(dim=1)  # [B, E]
    f = counts.float() / (S * k)
    aux = E * (f * probs.mean(dim=1)).sum(dim=-1)
    gate_sorted = torch.gather(gates.reshape(B, S * k), 1, order)
    return slot, tok, keep, gate_sorted, aux, order


def _fill(x: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig, cap: int):
    """Route ``x``'s rows and scatter each kept token into its expert's
    slot: ``buf [B, E, cap, d]`` and what the combine needs."""
    B, S, d = x.shape
    E = cfg.num_experts
    slot, tok, keep, gate_sorted, aux, order = _dispatch(x, router_w, cfg, cap)
    buf = torch.zeros((B, E * cap + 1, d), dtype=x.dtype, device=x.device)
    buf.scatter_(1, _rows(slot, d), torch.gather(x, 1, _rows(tok, d)))
    return buf[:, :E * cap].reshape(B, E, cap, d), slot, keep, gate_sorted, aux, order


def _rows(idx: torch.Tensor, d: int) -> torch.Tensor:
    return idx[..., None].expand(*idx.shape, d)


def _combine(out_flat, slot, keep, gate_sorted, order, k: int) -> torch.Tensor:
    """Each token's k expert outputs ``out_flat [B, E*cap, d]``, weighted by
    their gates (a dropped one by 0), added in sorted order: ``[B, S, d]``."""
    B, n, d = out_flat.shape
    S = slot.shape[1] // k
    contrib = torch.gather(out_flat, 1, _rows(torch.clamp(slot, max=n - 1), d))
    weighted = contrib * (gate_sorted * keep).to(out_flat.dtype)[..., None]  # [B, S*k, d]
    # each token's k entries: their sorted positions, in sorted order
    pos = torch.argsort(order, dim=-1).reshape(B, S, k).sort(dim=-1).values
    picked = torch.gather(weighted, 1, _rows(pos.reshape(B, S * k), d)).reshape(B, S, k, d)
    y = torch.zeros((B, S, d), dtype=out_flat.dtype, device=out_flat.device)
    for j in range(k):
        y = y + picked[:, :, j]
    return y


def _whole_router(router_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The router's whole weight on each rank, to route its own rows of
    ``x``: its gradient there is a partial sum over the mesh dims that
    split ``x``'s rows, and the same on the others."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = router_w.device_mesh
    whole = router_w.redistribute(mesh, [Replicate()] * mesh.ndim)
    return whole.to_local(grad_placements=[
        Partial() if p == Shard(0) else Replicate() for p in x.placements])


def moe_ffn(params: MoE, x: torch.Tensor, cfg: ModelConfig,
            ctx: ShardingCtx) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d].  Returns (y [B, S, d], aux_loss scalar)."""
    B, S, d = x.shape
    E, k, cap = cfg.num_experts, cfg.top_k, _capacity(S, cfg)
    router_w = fsdp_gather(params.router.w)
    if is_dtensor(x):
        rw = _whole_router(router_w, x)
        buf, slot, keep, gate_sorted, aux, order = on_local_shards(
            lambda xl: _fill(xl, rw, cfg, cap), (x,), None, None)
    else:
        buf, slot, keep, gate_sorted, aux, order = _fill(x, router_w, cfg, cap)
    buf = ctx.ac(buf, "batch", "expert", None, None)

    wd = fsdp_gather(params.wd).to(x.dtype)
    if cfg.mlp_type == "gelu":
        h = torch.einsum("becd,edf->becf", buf, fsdp_gather(params.wu).to(x.dtype))
        h = C.gelu_tanh(h)
    else:
        g = torch.einsum("becd,edf->becf", buf, fsdp_gather(params.wg).to(x.dtype))
        u = torch.einsum("becd,edf->becf", buf, fsdp_gather(params.wu).to(x.dtype))
        act = C.silu(g) if cfg.mlp_type == "swiglu" else C.gelu_tanh(g)
        h = act * u
    out = torch.einsum("becf,efd->becd", h, wd)  # [B, E, cap, d]
    out_flat = ctx.ac(out, "batch", "expert", None, None).reshape(B, E * cap, d)
    args = (out_flat, slot, keep, gate_sorted, order)
    y = (on_local_shards(lambda *a: _combine(*a, k), args, None, None)
         if is_dtensor(out_flat) else _combine(*args, k))
    return y, aux.mean()
