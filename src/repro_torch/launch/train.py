"""Training launcher.

The port of ``repro/launch/train.py``: selects an architecture, builds the
context, and runs the fault-tolerant training loop on the card (``--device
cpu`` off it).  ``--smoke`` trains the arch's reduced config, as in the
reference; without it, the full config.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --smoke --device cpu --steps 6 --ckpt-dir /tmp/ck

A model mesh spans the ranks of a ``torchrun`` launch, one rank per card
(NCCL; gloo with ``--device cpu``), as the reference's spans its devices:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch yi-6b \
        --smoke --steps 10

One process trains on one card, however many the machine has.
"""

from __future__ import annotations

import argparse
import os

import torch

from .. import configs
from ..config import smoke_config
from ..core.executor import resolve_device
from ..data.tokens import DataConfig
from ..distributed.fault_tolerance import PreemptionGuard
from ..distributed.sharding import DEFAULT_RULES, SINGLE_POD_RULES, ShardingCtx
from ..optim import adamw
from ..optim.compression import CompressionConfig
from ..train.loop import LoopConfig, LoopResult, train

__all__ = ["build_ctx", "main"]


def _init_ranks(device: str) -> int:
    """Join the launch's process group (``torchrun``'s environment: NCCL
    with each rank on card ``LOCAL_RANK``, gloo on the CPU); the number
    of ranks (1 outside a launch of several)."""
    import torch.distributed as dist

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not dist.is_initialized():
        on_cuda = torch.device(device).type == "cuda"
        if on_cuda:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if on_cuda else "gloo")
    return world


def build_ctx(args) -> ShardingCtx:
    """The reference's contexts over the ranks of the launch: no mesh on
    one rank or with ``--no-mesh``; the production 2x16x16 ``("pod",
    "data", "model")`` mesh from 512 ranks; else an ``(n // d, d)``
    ``("data", "model")`` mesh, ``d`` the largest power of two whose
    square is at most ``n``.  Attention is the plain path."""
    from .mesh import make_model_mesh, make_production_model_mesh

    n = _init_ranks(args.device)
    if n == 1 or args.no_mesh:
        return ShardingCtx(attn_impl="torch")
    kind = torch.device(args.device).type
    if n >= 512:
        mesh = make_production_model_mesh(multi_pod=True, device_type=kind)
        return ShardingCtx(mesh=mesh, rules=dict(DEFAULT_RULES), attn_impl="torch")
    # small meshes: (data, model) as square as possible
    d = 1
    while d * d <= n:
        d *= 2
    d //= 2
    mesh = make_model_mesh((max(n // d, 1), d), ("data", "model"), device_type=kind)
    return ShardingCtx(mesh=mesh, rules=dict(SINGLE_POD_RULES), attn_impl="torch")


def main(argv=None) -> LoopResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b", choices=configs.list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU dev host)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--compress", default="none",
                    choices=["none", "topk", "int8"],
                    help="gradient compression (with error feedback)")
    ap.add_argument("--no-mesh", action="store_true",
                    help="no model mesh, even under a launch of several ranks")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the initial parameters")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu.  A model mesh spans the ranks "
                         "of a torchrun launch; one process trains on one "
                         "card, however many the machine has")
    args = ap.parse_args(argv)

    cfg = configs.get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    ctx = build_ctx(args)
    mesh = "none" if ctx.mesh is None else dict(zip(ctx.mesh.mesh_dim_names,
                                                    ctx.mesh.shape))
    print(f"arch={cfg.name} params~{cfg.param_count/1e6:.1f}M "
          f"device={resolve_device(args.device)} mesh={mesh}")

    data_cfg = DataConfig(seq_len=args.seq, global_batch=args.batch,
                          vocab_size=cfg.vocab_size)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                                total_steps=args.steps)
    comp = (CompressionConfig(kind=args.compress)
            if args.compress != "none" else None)

    with PreemptionGuard() as guard:
        result = train(
            cfg, data_cfg,
            LoopConfig(total_steps=args.steps,
                       checkpoint_every=args.checkpoint_every,
                       log_every=10, microbatches=args.microbatches,
                       seed=args.seed),
            opt_cfg, ctx=ctx, checkpoint_dir=args.ckpt_dir,
            compression=comp, preemption=guard, device=args.device,
        )
    print(f"final: step={result.final_step} loss={result.losses[-1]:.4f} "
          f"resumed_from={result.resumed_from} preempted={result.preempted}")
    return result


if __name__ == "__main__":
    main()
