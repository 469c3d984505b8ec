"""Feed-forward blocks: SwiGLU (llama/qwen/yi), GeGLU (gemma), GELU (whisper)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import common as C

__all__ = ["MLP", "mlp", "mlp_specs"]


class MLP(nn.Module):
    def __init__(self, d: int, ff: int, mlp_type: str, *,
                 gen: Optional[torch.Generator] = None, device,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(gen=gen, device=device, dtype=dtype)
        if mlp_type in ("swiglu", "geglu"):
            self.wg = C.Linear(d, ff, **kw)
            self.wu = C.Linear(d, ff, **kw)
            self.wd = C.Linear(ff, d, **kw)
        else:  # plain gelu
            self.wu = C.Linear(d, ff, bias=True, **kw)
            self.wd = C.Linear(ff, d, bias=True, **kw)


def mlp_specs(mlp_type: str) -> dict:
    if mlp_type in ("swiglu", "geglu"):
        return {
            "wg": C.linear_specs("embed", "mlp"),
            "wu": C.linear_specs("embed", "mlp"),
            "wd": C.linear_specs("mlp", "embed"),
        }
    return {
        "wu": C.linear_specs("embed", "mlp", bias=True),
        "wd": C.linear_specs("mlp", "embed", bias=True),
    }


def mlp(params: MLP, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    if mlp_type == "swiglu":
        return C.linear(params.wd,
                        F.silu(C.linear(params.wg, x)) * C.linear(params.wu, x))
    if mlp_type == "geglu":
        return C.linear(params.wd,
                        F.gelu(C.linear(params.wg, x), approximate="tanh")
                        * C.linear(params.wu, x))
    # jax.nn.gelu's default is the tanh approximation
    return C.linear(params.wd, F.gelu(C.linear(params.wu, x), approximate="tanh"))
