"""Training launcher.

The port of ``repro/launch/train.py``: selects an architecture, builds the
context, and runs the fault-tolerant training loop on the card (``--device
cpu`` off it).  ``--smoke`` trains the arch's reduced config, as in the
reference; without it, the full config.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --smoke --device cpu --steps 6 --ckpt-dir /tmp/ck

Model meshes are not ported yet: with more than one visible card and no
``--no-mesh`` the launcher raises rather than train on one card.
"""

from __future__ import annotations

import argparse

import torch

from .. import configs
from ..config import smoke_config
from ..core.executor import resolve_device
from ..data.tokens import DataConfig
from ..distributed.fault_tolerance import PreemptionGuard
from ..distributed.sharding import ShardingCtx
from ..optim import adamw
from ..optim.compression import CompressionConfig
from ..train.loop import LoopConfig, LoopResult, train

__all__ = ["build_ctx", "main"]


def build_ctx(args) -> ShardingCtx:
    """The plain-attention context on one device; a mesh over several
    cards (``ShardingCtx(mesh=...)``, which raises until it is ported)."""
    dev = resolve_device(args.device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n == 1 or args.no_mesh:
        return ShardingCtx(attn_impl="torch")
    return ShardingCtx(mesh=[torch.device("cuda", i) for i in range(n)],
                       attn_impl="torch")


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
    ap.add_argument("--no-mesh", action="store_true")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the initial parameters")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = configs.get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    ctx = build_ctx(args)
    print(f"arch={cfg.name} params~{cfg.param_count/1e6:.1f}M "
          f"device={resolve_device(args.device)}")

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
