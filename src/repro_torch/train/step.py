"""train_step / serve_step factories.

The port of ``repro/train/step.py``.  :func:`make_train_step` returns

    step(params, opt_state, err_state, batch) -> (params, opt_state, err_state, metrics)

with the loss, the backward pass, optional gradient compression and AdamW
in one call, and optional microbatch gradient accumulation.  ``params`` is
a :class:`~repro_torch.models.model.Model`; it and ``opt_state`` are
updated in place and returned (a full-width model has no room for a
second copy).  The parameters require gradients only inside the step.

Under a model mesh (``ctx.mesh``) the parameters and moments are
DTensors (``distributed.sharding.distribute_module``); the step places a
plain batch on the mesh by its logical axes, runs in ``ctx.scope()``,
brings each gradient to its parameter's placements (the reduction the
reference's GSPMD inserts), and returns plain metrics.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from ..config import ModelConfig
from ..distributed.sharding import ShardingCtx, full_tensor
from ..models import model as M
from ..models.params import reference_groups
from ..optim import adamw
from ..optim.compression import CompressionConfig, compress_tree

__all__ = ["make_train_step", "make_serve_steps"]


@contextlib.contextmanager
def _trainable(tensors):
    before = [t.requires_grad for t in tensors]
    for t in tensors:
        t.requires_grad_(True)
    try:
        yield
    finally:
        for t, flag in zip(tensors, before):
            t.requires_grad_(flag)


def make_train_step(
    cfg: ModelConfig,
    ctx: ShardingCtx,
    opt_cfg: adamw.AdamWConfig,
    *,
    microbatches: int = 1,
    compression: Optional[CompressionConfig] = None,
    pod_axis: Optional[str] = None,
    accum_dtype=torch.float32,
):
    """Build the train step.

    ``microbatches`` splits the batch's leading axis into that many equal
    parts, run one after another, their gradients summed in explicit
    ``accum_dtype`` accumulators (``.grad`` would sum in the parameters'
    dtype), then divided by the count.  As in the reference, the
    microbatched ``loss`` is the mean of the totals (the NLL plus the aux
    term); unsplit, it is the NLL.  ``pod_axis`` names the cross-pod axis;
    as in the reference it is accepted and changes nothing (the reduction
    over every batch axis happens in the backward pass, and compression
    acts on the reduced gradients).

    The flash kernel has no backward (the reference's Pallas kernel has
    none either; it trains on ``"xla"``), so a context with ``attn_impl``
    ``"cuda"`` is rejected here, on any device."""
    if ctx.attn_impl == "cuda":
        raise ValueError("the flash kernel has no backward: train with "
                         "ShardingCtx(attn_impl='torch')")

    def grads_of(params, named, batch):
        total, metrics = M.train_loss(params, _placed(batch, ctx), cfg, ctx)
        gs = torch.autograd.grad(total, list(named.values()), allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else _like(g, p)
                 for (n, p), g in zip(named.items(), gs)}
        return total.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def step(params: M.Model, opt_state: adamw.AdamWState,
             err_state: Optional[Dict[str, torch.Tensor]], batch):
        with ctx.scope():
            return _step(params, opt_state, err_state, batch)

    def _step(params, opt_state, err_state, batch):
        named = dict(params.named_parameters())
        dev = params.embed.table.device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        with _trainable(list(named.values())):
            if microbatches > 1:
                b = next(iter(batch.values())).shape[0] // microbatches
                grads = {n: torch.zeros_like(p, dtype=accum_dtype)
                         for n, p in named.items()}
                loss_sum, aux_sum, tokens = 0.0, 0.0, 0.0
                for i in range(microbatches):
                    mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
                    total, m, g = grads_of(params, named, mb)
                    for n, acc in grads.items():
                        acc += g[n].to(accum_dtype)
                    del g
                    loss_sum = loss_sum + total
                    aux_sum = aux_sum + m["aux"]
                    tokens = tokens + m["tokens"]
                grads = {n: acc / microbatches for n, acc in grads.items()}
                metrics = {"loss": loss_sum / microbatches,
                           "aux": aux_sum / microbatches, "tokens": tokens}
            else:
                _, metrics, grads = grads_of(params, named, batch)

        if compression is not None and compression.kind != "none":
            # one threshold / scale over each leaf the reference stacks
            groups = list(reference_groups(named, cfg).values())
            grads, err_state = compress_tree(grads, err_state, compression, groups)

        _, opt_state, opt_metrics = adamw.apply_updates(named, grads, opt_state,
                                                        opt_cfg)
        metrics = {k: full_tensor(v) for k, v in {**metrics, **opt_metrics}.items()}
        return params, opt_state, err_state, metrics

    return step


def _placed(batch, ctx: ShardingCtx):
    """A plain batch as DTensors on ``ctx.mesh``, its leading dim on the
    ``batch`` axes (every rank holds the same batch, so this splits it
    locally); as it is without a mesh."""
    if ctx.mesh is None:
        return batch
    return {k: ctx.ac(v, "batch", *([None] * (v.dim() - 1)))
            for k, v in batch.items()}


def _like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A gradient in its parameter's placements: the backward leaves a
    DTensor gradient partial (a sum still to reduce over the batch axes)
    or replicated; the reduction is a reduce-scatter or an all-reduce."""
    from torch.distributed.tensor import DTensor

    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_serve_steps(cfg: ModelConfig, ctx: ShardingCtx):
    def prefill_fn(params, batch):
        return M.prefill(params, batch, cfg, ctx)

    def decode_fn(params, tokens, caches, cache_index):
        return M.decode_step(params, tokens, caches, cache_index, cfg, ctx)

    return prefill_fn, decode_fn
