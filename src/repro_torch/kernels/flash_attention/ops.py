"""Public attention entry point with selectable implementation.

``attention(..., impl=)``:
- ``"torch"`` — the plain PyTorch reference path (the reference's
  ``"xla"``), also the numerics oracle.
- ``"cuda"``  — the flash kernel (the reference's ``"pallas"``): the CUDA
  kernel for CUDA tensors, its plain version for CPU tensors.  The kernel
  has no backward, as the reference's has none: on CUDA tensors that
  require gradients it raises rather than fall back to the plain path.

Both accept GQA layouts [B, Hq, S, D] x [B, Hkv, S, D].  The kernel reads
the KV head of each query head by index; nothing is expanded.
"""

from __future__ import annotations

import torch

from .kernel import flash_attention
from .ref import mha_ref

__all__ = ["attention"]


def attention(
    q: torch.Tensor,  # [B, Hq, Sq, D]
    k: torch.Tensor,  # [B, Hkv, Skv, D]
    v: torch.Tensor,  # [B, Hkv, Skv, D]
    *,
    causal: bool = True,
    impl: str = "torch",
    ac=None,
    bf16_probs: bool = False,
) -> torch.Tensor:
    if impl == "torch":
        return mha_ref(q, k, v, causal=causal, ac=ac, bf16_probs=bf16_probs)
    if impl != "cuda":
        raise ValueError(f"unknown attention impl {impl!r}")
    return flash_attention(q, k, v, causal=causal)
