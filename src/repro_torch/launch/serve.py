"""Serving launcher: batched prefill + greedy decode (dense family).

A miniature serving runtime around ``prefill`` and ``decode_step``: a
request queue, batched prefill, KV caches written in place, and
per-request completion.  :func:`serve` serves given prompts with given
parameters; :func:`main` is the command line.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --requests 8 --gen-len 24                # --device cpu off the card

``--no-smoke`` serves the arch's full config (``--smoke``, the default,
serves its reduced smoke config).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import configs
from ..config import ModelConfig, smoke_config
from ..distributed.sharding import LOCAL_CTX, ShardingCtx
from ..models import model as M

__all__ = ["ServeResult", "make_prompts", "serve", "main"]


@dataclasses.dataclass
class ServeResult:
    """What :func:`serve` did.  ``done`` holds one row of ``gen_len`` token
    ids per served row, padding rows of the last batch included (as the
    reference's loop keeps them).  Times are host seconds; on the card each
    phase ends in a synchronise."""

    done: List[np.ndarray]
    tokens_out: int
    seconds: float
    prefill_s: List[float]  # per batch
    decode_s: List[float]  # per batch, all of its decode steps
    #: per batch, ``gen_len`` float32 ``[batch, vocab]`` logits (the
    #: prefill's last position, then each decode step); with ``keep_logits``
    logits: Optional[List[List[np.ndarray]]] = None

    @property
    def batches(self) -> int:
        return len(self.prefill_s)


def make_prompts(cfg: ModelConfig, requests: int, prompt_len: int,
                 seed: int) -> List[np.ndarray]:
    """The launcher's request queue: ``requests`` prompts of uniform token
    ids from ``np.random.default_rng(seed)``, as the reference draws them."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, prompt_len).astype(np.int32)
            for _ in range(requests)]


def serve(params: M.Model, cfg: ModelConfig, ctx: ShardingCtx,
          prompts: Sequence[np.ndarray], *, batch: int, gen_len: int,
          keep_logits: bool = False) -> ServeResult:
    """Serve ``prompts`` (equal lengths) in fixed-size batches: requests
    leave the queue from its end, the last batch is padded with its last
    prompt; each batch is prefilled, then decoded greedily for
    ``gen_len - 1`` steps on the parameters' device."""
    if gen_len < 1 or batch < 1:
        raise ValueError("need gen_len >= 1 and batch >= 1")
    queue = list(prompts)
    dev = params.embed.table.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    prompt_len = int(queue[0].shape[0]) if queue else 0
    max_seq = prompt_len + gen_len
    res = ServeResult(done=[], tokens_out=0, seconds=0.0, prefill_s=[],
                      decode_s=[], logits=[] if keep_logits else None)
    with torch.inference_mode():
        sync()
        t_start = time.perf_counter()
        while queue:
            batch_prompts = [queue.pop() for _ in range(min(batch, len(queue)))]
            while len(batch_prompts) < batch:  # pad the batch
                batch_prompts.append(batch_prompts[-1])
            tokens = torch.from_numpy(np.stack(batch_prompts)).to(dev)
            t0 = time.perf_counter()
            logits, caches = M.prefill(params, {"tokens": tokens}, cfg, ctx)
            caches = M.pad_caches(caches, cfg, max_seq=max_seq)
            toks = torch.argmax(logits, dim=-1)[:, None]
            kept = [logits] if keep_logits else None
            sync()
            t1 = time.perf_counter()
            outs = [toks]
            for step in range(gen_len - 1):
                logits, caches = M.decode_step(params, toks, caches,
                                               prompt_len + step, cfg, ctx)
                toks = torch.argmax(logits, dim=-1)[:, None]
                outs.append(toks)
                if keep_logits:
                    kept.append(logits)
            gen = torch.cat(outs, dim=1).cpu().numpy()
            sync()
            res.prefill_s.append(t1 - t0)
            res.decode_s.append(time.perf_counter() - t1)
            if keep_logits:
                res.logits.append([x.float().cpu().numpy() for x in kept])
            res.done.extend(gen[: len(batch_prompts)])
            res.tokens_out += gen.size
        res.seconds = time.perf_counter() - t_start
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2.5-3b", choices=configs.list_archs())
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = smoke_config(configs.get_config(args.arch)) if args.smoke else \
        configs.get_config(args.arch)
    params = M.init_params(args.seed, cfg, dtype=torch.float32, device=args.device)
    prompts = make_prompts(cfg, args.requests, args.prompt_len, args.seed)
    res = serve(params, cfg, LOCAL_CTX, prompts, batch=args.batch,
                gen_len=args.gen_len)
    dt = res.seconds
    print(f"arch={cfg.name} served {len(res.done)} requests, "
          f"{res.tokens_out} tokens in {dt:.2f}s ({res.tokens_out/dt:.0f} tok/s)")
    print(f"sample: {res.done[0][:12].tolist()}")


if __name__ == "__main__":
    main()
