"""The runtime context threaded through the model code.

The port of ``repro/distributed/sharding.py`` keeps only what one card
needs: :class:`ShardingCtx` with its attention settings, and ``ac`` as the
identity.  The graph engine's mesh path (``VSWEngine(mesh=...)``) drives
its devices from one process and needs no partition specs, so there is no
``graph_ctx``.  Logical-axis rules and meshes for a *model* belong to the
sharded dry run and training of ROADMAP Queue 1 item 10; asking for either
raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

__all__ = ["ShardingCtx", "LOCAL_CTX"]


@dataclasses.dataclass
class ShardingCtx:
    """Runtime context threaded through model code (one device)."""

    mesh: Optional[Any] = None
    rules: Optional[Any] = None
    #: ``"torch"``: the plain path (the reference's ``"xla"``); ``"cuda"``:
    #: the hand-written kernel (the reference's ``"pallas"``)
    attn_impl: str = "cuda"
    #: kv-block size for the memory-bounded blocked attention path (0 =
    #: full materialization); used by the ``"torch"`` path only
    attn_block_k: int = 0
    #: the reference's sequence-parallel scores; with no mesh it changes
    #: nothing, as ``ac`` is the identity
    attn_seq_shard: bool = False
    #: store attention probabilities in bf16 (f32 softmax stats kept);
    #: the ``"torch"`` path only, as in the reference
    attn_bf16_probs: bool = False

    def __post_init__(self):
        if self.mesh is not None or self.rules is not None:
            raise NotImplementedError(
                "model meshes and sharding rules are not ported yet "
                "(ROADMAP Queue 1 item 10)")

    def ac(self, x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
        """Activation sharding constraint: the identity without a mesh."""
        return x


LOCAL_CTX = ShardingCtx()  # one device, the kernel path
