"""AdamW + schedules + global-norm clipping over named tensors.

The port of ``repro/optim/adamw.py``.  Where the reference maps a pytree,
the port takes a dict of name -> tensor: a model's ``named_parameters()``
(``"layers.3.attn.wq.w"``), or any other names.  The moments ``m`` and
``v`` are dicts of the same names, so the checkpointer treats optimiser
state exactly like parameters.

:func:`apply_updates` works in place on the parameters and the moments: a
full-width model has no room for a second copy of either.  Its arithmetic
is the reference's, operation by operation, in f32.

**The decay rule follows the reference's layout.**  The reference decays
leaves with ``ndim >= 2``, and stacks every per-layer leaf as
``[num_groups, ...]``, so a layer's RMSNorm scale, its qkv bias and the
SSM vectors are 2-D there and are decayed.  The port keeps one tensor per
layer: a name under ``layers.<i>.`` or ``encoder.layers.<i>.`` counts one
dimension more (:func:`decays`).  The top-level final norms stay
undecayed, as there.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Mapping, Tuple

import torch

__all__ = ["AdamWConfig", "AdamWState", "lr_at", "init", "decays", "global_norm",
           "apply_updates"]

#: a per-layer tensor: one group's slice of a leaf the reference stacks
_LAYER = re.compile(r"^(encoder\.)?layers\.\d+\.")


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    schedule: str = "cosine"  # cosine | linear | constant


@dataclasses.dataclass
class AdamWState:
    """The step count and the moments, named as the parameters."""

    step: int
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (0-d f32 on the CPU): linear warmup,
    then cosine or linear decay to ``min_lr_ratio``, or constant."""
    if cfg.schedule not in ("cosine", "linear", "constant"):
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    frac = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1 + torch.cos(math.pi * frac))
    else:
        decay = 1.0 - frac
    decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * decay
    return cfg.lr * warm * decay


def init(params: Mapping[str, torch.Tensor], dtype=torch.float32) -> AdamWState:
    """Zero moments beside each parameter.  ``dtype``: the moments' dtype
    (bf16 halves the optimiser's memory; the update still runs in f32).
    A DTensor parameter's moments are DTensors of its placements."""
    zeros = lambda: {n: torch.zeros_like(p, dtype=dtype, requires_grad=False)
                     for n, p in params.items()}
    return AdamWState(step=0, m=zeros(), v=zeros())


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether decoupled weight decay applies: rank >= 2 in the
    reference's layout (a per-layer tensor counts its group axis)."""
    return p.dim() + (1 if _LAYER.match(name) else 0) >= 2


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every tensor's f32 squares.  The reference sums
    one square sum per stacked leaf in its leaf order; the port's per-layer
    tensors group the same terms differently, so the two agree within a
    float tolerance, not bitwise."""
    total = 0
    for x in tree.values():
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


@torch.no_grad()
def apply_updates(
    params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
    state: AdamWState, cfg: AdamWConfig,
) -> Tuple[Mapping[str, torch.Tensor], AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place on ``params`` and ``state``; returns
    (params, state, metrics) with ``grad_norm`` (before clipping) and
    ``lr``."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    state.step += 1
    s = torch.tensor(state.step, dtype=torch.float32)
    lr = lr_at(cfg, state.step)
    # f32 scalars, as the reference computes them; a Python float holding an
    # f32 value enters each product unchanged
    lr_f = float(lr)
    bc1 = float(1 - torch.tensor(cfg.b1, dtype=torch.float32) ** s)
    bc2 = float(1 - torch.tensor(cfg.b2, dtype=torch.float32) ** s)
    for name, p in params.items():
        m, v = state.m[name], state.v[name]
        gf = grads[name].float() * scale
        m2 = cfg.b1 * m.float()
        m2 += (1 - cfg.b1) * gf
        v2 = cfg.b2 * v.float()
        v2 += (1 - cfg.b2) * gf * gf
        del gf
        delta = m2 / bc1
        delta /= torch.sqrt(v2 / bc2) + cfg.eps
        if decays(name, p):
            delta += cfg.weight_decay * p.float()
        p.copy_(p.float() - lr_f * delta)
        m.copy_(m2)
        v.copy_(v2)
    return params, state, {"grad_norm": gnorm, "lr": lr}
