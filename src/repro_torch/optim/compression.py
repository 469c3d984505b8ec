"""Gradient compression with error feedback.

The port of ``repro/optim/compression.py``, over dicts of name -> tensor.
In the reference the compressors run inside the compiled step around the
cross-pod gradient reduction, where inter-pod links are about 10x slower
than in-pod ones.  On one card there is no pod axis: the step compresses
the gradients after the backward pass and before AdamW, so training sees
exactly the gradients a pod reduction would carry.  Two compressors, both
with error feedback (the part not sent is kept and added to the next
step's gradient, so the noise does not bias the sum):

- ``topk``: keep the entries whose magnitude reaches the k-th largest
  (ties included), k = ``topk_ratio`` of each tensor.
- ``int8``: per-tensor symmetric quantisation, rounding half to even.

"Each tensor" is each leaf of the reference's layout: the reference stacks
a layer's tensors over the groups, ``[num_groups, ...]``, and takes one
threshold or one scale over the whole stack.  The port's per-layer tensors
are passed as ``groups`` (``models/params.py::reference_groups``), each
group compressed as one tensor.  Under a model mesh the gradients are
DTensors, and the threshold or scale is still that of the whole leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from ..distributed.sharding import full_tensor

__all__ = ["CompressionConfig", "init_error_state", "compress_tree",
           "wire_bytes_ratio"]


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    kind: str = "none"  # none | topk | int8
    topk_ratio: float = 0.01  # fraction of entries kept
    error_feedback: bool = True


def init_error_state(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: torch.zeros_like(p, dtype=torch.float32, requires_grad=False)
            for n, p in params.items()}



def _topk_threshold(parts: Sequence[torch.Tensor], ratio: float) -> torch.Tensor:
    """The k-th largest magnitude over ``parts`` taken as one tensor: the
    reference's ``lax.top_k(...)[0][-1]``."""
    flat = torch.cat([full_tensor(x).reshape(-1).abs() for x in parts])
    k = max(1, int(flat.shape[0] * ratio))
    return torch.topk(flat, k).values[-1]


def _topk_mask(x: torch.Tensor, ratio: float) -> torch.Tensor:
    """1 where ``|x|`` reaches the k-th largest magnitude, ties included."""
    return (x.abs() >= _topk_threshold([x], ratio)).to(x.dtype)


def compress_tree(grads: Mapping[str, torch.Tensor], err: Mapping[str, torch.Tensor],
                  cfg: CompressionConfig,
                  groups: Optional[List[List[str]]] = None,
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(sent gradients, new error state), both named as ``grads``: what
    crosses the wire, and the residual kept for the next step.  ``groups``
    lists the names compressed as one tensor (default: each its own)."""
    if cfg.kind == "none":
        return dict(grads), dict(err)
    if cfg.kind not in ("topk", "int8"):
        raise ValueError(cfg.kind)
    sent, resid = {}, {}
    for names in groups or [[n] for n in grads]:
        gfs = [grads[n].float() + (err[n] if cfg.error_feedback else 0.0)
               for n in names]
        if cfg.kind == "topk":
            thresh = _topk_threshold(gfs, cfg.topk_ratio)
            ss = [gf * (gf.abs() >= thresh).to(gf.dtype) for gf in gfs]
        else:
            top = torch.stack([full_tensor(gf.abs().max()) for gf in gfs]).max()
            scale = torch.clamp(top, min=1e-12) / 127.0
            ss = [torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
                  .float() * scale for gf in gfs]
        for n, gf, s in zip(names, gfs, ss):
            sent[n], resid[n] = s.to(grads[n].dtype), gf - s
    return sent, resid


def wire_bytes_ratio(cfg: CompressionConfig, dtype_bytes: int = 2) -> float:
    """Analytic wire-volume multiplier for the roofline collective term."""
    if cfg.kind == "none":
        return 1.0
    if cfg.kind == "int8":
        return 1.0 / dtype_bytes
    if cfg.kind == "topk":
        # index (4B) + value (dtype) per kept entry
        return cfg.topk_ratio * (4 + dtype_bytes) / dtype_bytes
    raise ValueError(cfg.kind)
