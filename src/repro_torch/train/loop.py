"""The fault-tolerant training loop.

The port of ``repro/train/loop.py``.  It wires together the data
(stateless resume: step k's batch depends on k only), the train step,
async sharded checkpointing, the preemption guard and the straggler
monitor.  Used by ``launch/train.py``.

Checkpoints hold ``{"params", "m", "v"}`` in the reference's stacked
layout (``models/params.py::reference_tree``) and the step number, so
either package resumes the other's run.

Under a model mesh (``ctx.mesh``, one rank per card) every rank draws the
same parameters from the seed and keeps its shards
(``distributed.sharding.distribute_module``); every rank reads the same
batch and the step keeps its part.  A checkpoint gathers the whole
tensors one at a time (every rank takes part) and only rank 0 keeps them
and writes them; on resume every rank reads the file and moves only its
shards to its card.  So rank 0's host holds the whole f32 state, 12 bytes
a parameter (``params``, ``m``, ``v``), and ``np.savez`` buffers it once
more, as in the reference: mesh checkpoints work up to models whose
24 bytes a parameter fit that host's memory (about 80 B parameters on a
2 TB host); past that each rank would write its own shards.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from ..checkpoint.checkpointer import Checkpointer
from ..config import ModelConfig
from ..core.executor import resolve_device
from ..data.tokens import DataConfig, add_frontend_stub, make_batch
from ..distributed.fault_tolerance import PreemptionGuard, StragglerMonitor
from ..distributed.sharding import ShardingCtx, distribute_module
from ..models import model as M
from ..models.params import load_reference_tree, reference_tree
from ..optim import adamw
from ..optim.compression import CompressionConfig, init_error_state
from .step import make_train_step

__all__ = ["LoopConfig", "LoopResult", "train"]


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    log_every: int = 10
    microbatches: int = 1
    seed: int = 0


@dataclasses.dataclass
class LoopResult:
    """The reference's fields, then each step's ``grad_norm`` and ``lr``
    and the trained model."""

    final_step: int
    losses: List[float]
    step_times: List[float]
    straggler_events: int
    resumed_from: Optional[int]
    preempted: bool
    grad_norms: List[float] = dataclasses.field(default_factory=list)
    lrs: List[float] = dataclasses.field(default_factory=list)
    params: Optional[M.Model] = None


def _state_tree(named: Dict[str, torch.Tensor], opt_state: adamw.AdamWState,
                cfg: ModelConfig, device, keep: bool = True) -> Optional[Dict]:
    """``{"params", "m", "v"}`` in the reference's layout, a new tensor on
    ``device`` for each leaf (``meta``: shapes and dtypes only);
    ``keep=False``: join the gathers, keep nothing (``reference_tree``)."""
    tree = {k: reference_tree(ts, cfg, device, keep=keep)
            for k, ts in (("params", named), ("m", opt_state.m), ("v", opt_state.v))}
    return tree if keep else None


def _writer() -> bool:
    """Whether this process writes checkpoints: rank 0 of a launch of
    several ranks, the one process otherwise."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def train(
    cfg: ModelConfig,
    data_cfg: DataConfig,
    loop_cfg: LoopConfig,
    opt_cfg: adamw.AdamWConfig,
    *,
    ctx: Optional[ShardingCtx] = None,
    checkpoint_dir: Optional[str] = None,
    compression: Optional[CompressionConfig] = None,
    preemption: Optional[PreemptionGuard] = None,
    param_dtype=None,
    device="cuda",
) -> LoopResult:
    """Train ``loop_cfg.total_steps`` steps from parameters drawn from
    ``loop_cfg.seed`` on ``device``, or from the newest checkpoint in
    ``checkpoint_dir``.  The default context trains on the plain attention
    (``attn_impl="torch"``, the reference's default ``"xla"``)."""
    ctx = ctx or ShardingCtx(attn_impl="torch")
    dev = resolve_device(device)
    params = M.init_params(loop_cfg.seed, cfg, dtype=param_dtype or torch.float32,
                           device=dev)
    if ctx.mesh is not None:
        distribute_module(params, ctx, ctx.param_sharding(M.param_specs(cfg)))
    named = dict(params.named_parameters())
    opt_state = adamw.init(named)
    err_state = init_error_state(named) if compression else None

    ckpt = Checkpointer(checkpoint_dir) if checkpoint_dir else None
    start_step = 0
    resumed_from = None
    if ckpt is not None:
        latest = ckpt.latest_step()
        if latest is not None:
            restored = ckpt.restore(latest, _state_tree(named, opt_state, cfg, "meta"))
            load_reference_tree(named, restored["params"], cfg)
            load_reference_tree(opt_state.m, restored["m"], cfg)
            load_reference_tree(opt_state.v, restored["v"], cfg)
            opt_state.step = latest
            start_step = latest
            resumed_from = latest

    step_fn = make_train_step(cfg, ctx, opt_cfg, microbatches=loop_cfg.microbatches,
                              compression=compression)

    monitor = StragglerMonitor()
    res = LoopResult(final_step=start_step, losses=[], step_times=[],
                     straggler_events=0, resumed_from=resumed_from, preempted=False)
    step = start_step

    while step < loop_cfg.total_steps:
        monitor.start_step()
        batch_np = make_batch(data_cfg, step)
        if cfg.frontend != "none":
            batch_np = add_frontend_stub(batch_np, cfg, step)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
        params, opt_state, err_state, metrics = step_fn(
            params, opt_state, err_state, batch
        )
        loss = float(metrics["loss"])  # waits for the step
        res.losses.append(loss)
        res.grad_norms.append(float(metrics["grad_norm"]))
        res.lrs.append(float(metrics["lr"]))
        step += 1
        res.step_times.append(monitor.end_step(step))

        if loop_cfg.log_every and step % loop_cfg.log_every == 0:
            print(
                f"step {step:6d}  loss {loss:.4f}  "
                f"gnorm {res.grad_norms[-1]:.3f}  "
                f"lr {res.lrs[-1]:.2e}  "
                f"t {res.step_times[-1]*1e3:.0f}ms"
            )
        want_ckpt = ckpt is not None and (
            step % loop_cfg.checkpoint_every == 0 or step == loop_cfg.total_steps
        )
        if preemption is not None and preemption.preempted:
            want_ckpt = ckpt is not None
            res.preempted = True
        if want_ckpt:
            tree = _state_tree(named, opt_state, cfg, "cpu", keep=_writer())
            if tree is not None:
                ckpt.save_async(step, tree, copy=False, extra={"loss": loss})
        if res.preempted:
            break

    if ckpt is not None:
        ckpt.wait()
        import torch.distributed as dist

        if dist.is_initialized():
            dist.barrier()  # the checkpoint is on disk before any rank returns
    res.final_step = step
    res.straggler_events = len(monitor.events)
    res.params = params
    return res
