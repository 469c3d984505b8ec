"""Plain PyTorch references of the paper's programs, from the edge list.

They work from the edge list the benchmark made and nothing else: no
store, no shard, no table of the port.  They import neither the port nor
the JAX package.

- ``pagerank``: the paper's PageRank (Algorithm 2): ``x' = (1 - d) / |V| +
  d * sum over in-edges (u, v) of x[u] / max(outdeg(u), 1)``, from ``x =
  1 / |V|``, in float64.  With ``store_dtype`` the values and the
  messages are rounded to that type between steps and summed in float32:
  the control in the next precision below the port's float32.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["pagerank"]


def pagerank(src: torch.Tensor, dst: torch.Tensor, n: int, damping: float,
             iterations: int,
             store_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """PageRank values after ``iterations`` steps, float64."""
    acc_dtype = torch.float64 if store_dtype is None else torch.float32
    out_deg = torch.bincount(src, minlength=n).clamp_(min=1).to(acc_dtype)
    x = torch.full((n,), 1.0 / n, dtype=acc_dtype, device=src.device)
    for _ in range(iterations):
        if store_dtype is not None:
            x = x.to(store_dtype).to(acc_dtype)
        msgs = x / out_deg
        if store_dtype is not None:
            msgs = msgs.to(store_dtype).to(acc_dtype)
        acc = torch.zeros(n, dtype=acc_dtype, device=src.device)
        acc.index_add_(0, dst, msgs[src])
        x = (1.0 - damping) / n + damping * acc
    if store_dtype is not None:
        x = x.to(store_dtype)
    return x.to(torch.float64)

