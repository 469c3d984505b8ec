"""Plain PyTorch oracle: multi-head attention with optional causal mask and GQA.

The contract for the CUDA flash kernel and for the model zoo's ``"torch"``
attention path.  Computes in f32 regardless of input dtype (bf16 inputs,
f32 softmax and accumulation).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["mha_ref"]


def mha_ref(
    q: torch.Tensor,  # [B, Hq, Sq, D]
    k: torch.Tensor,  # [B, Hkv, Skv, D]
    v: torch.Tensor,  # [B, Hkv, Skv, D]
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    ac=None,  # accepted for the reference's signature; no mesh, no constraint
    bf16_probs: bool = False,
) -> torch.Tensor:
    """Grouped-query attention; Hq must be a multiple of Hkv.  Causal
    queries are the suffix of the keys (``qpos = arange(Sq) + Skv - Sq``)."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    group = Hq // Hkv
    scale = (D ** -0.5) if scale is None else scale

    qf = q.float().reshape(B, Hkv, group, Sq, D)
    kf = k.float()
    vf = v.float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * scale
    if causal:
        # decode convention: the last Sq queries align with the last Sq keys
        qpos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
        kpos = torch.arange(Skv, device=q.device)[None, :]
        s = s.masked_fill(qpos < kpos, float("-inf"))
    p = torch.softmax(s, dim=-1)
    if bf16_probs:
        p = p.to(torch.bfloat16)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, vf.to(p.dtype))
    return o.reshape(B, Hq, Sq, D).to(q.dtype)
