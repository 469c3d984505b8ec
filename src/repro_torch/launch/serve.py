"""Serving launcher: batched prefill + greedy decode, every registered arch.

A miniature serving runtime around ``prefill`` and ``decode_step``: a
request queue, batched prefill, KV caches written in place, and
per-request completion.  :func:`serve` serves given prompts with given
parameters; :func:`main` is the command line.  As in the reference, one
``np.random.default_rng(seed)`` draws the prompts and then, batch by
batch, the stub frontends' inputs: ``patch_embeds [batch, prefix_len, d]``
(vision prefix), then ``frames [batch, encoder_seq, d]`` (audio encoder).

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

__all__ = ["ServeResult", "frontend_inputs", "make_prompts", "prefix_len", "serve",
           "main"]


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
                 seed) -> List[np.ndarray]:
    """The launcher's request queue: ``requests`` prompts of uniform token
    ids from ``np.random.default_rng(seed)``, as the reference draws them
    (``seed`` may be that generator, to draw the frontends' inputs after)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, prompt_len).astype(np.int32)
            for _ in range(requests)]


def prefix_len(cfg: ModelConfig) -> int:
    """Positions the vision prefix puts before the prompt (0 without one)."""
    return cfg.prefix_len if cfg.frontend == "vision_stub" else 0


def frontend_inputs(cfg: ModelConfig, rng: Optional[np.random.Generator],
                    batch: int) -> dict:
    """One batch's stub frontend inputs (f32), drawn from ``rng`` in the
    reference's order; empty for an arch with neither."""
    out = {}
    if (cfg.frontend == "vision_stub" or cfg.encdec) and rng is None:
        raise ValueError(f"{cfg.name} draws its frontend inputs from the "
                         f"prompts' generator: pass rng")
    if cfg.frontend == "vision_stub":
        out["patch_embeds"] = rng.standard_normal(
            (batch, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    if cfg.encdec:
        out["frames"] = rng.standard_normal(
            (batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def serve(params: M.Model, cfg: ModelConfig, ctx: ShardingCtx,
          prompts: Sequence[np.ndarray], *, batch: int, gen_len: int,
          keep_logits: bool = False,
          rng: Optional[np.random.Generator] = None) -> ServeResult:
    """Serve ``prompts`` (equal lengths) in fixed-size batches: requests
    leave the queue from its end, the last batch is padded with its last
    prompt; each batch is prefilled, then decoded greedily for
    ``gen_len - 1`` steps on the parameters' device.  Archs with a stub
    frontend draw each batch's inputs from ``rng`` (the generator that
    drew the prompts) before the batch's prefill."""
    if gen_len < 1 or batch < 1:
        raise ValueError("need gen_len >= 1 and batch >= 1")
    queue = list(prompts)
    dev = params.embed.table.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    prompt_len = int(queue[0].shape[0]) if queue else 0
    prefix = prefix_len(cfg)
    max_seq = prompt_len + gen_len + prefix
    res = ServeResult(done=[], tokens_out=0, seconds=0.0, prefill_s=[],
                      decode_s=[], logits=[] if keep_logits else None)
    with torch.inference_mode():
        sync()
        t_start = time.perf_counter()
        while queue:
            batch_prompts = [queue.pop() for _ in range(min(batch, len(queue)))]
            while len(batch_prompts) < batch:  # pad the batch
                batch_prompts.append(batch_prompts[-1])
            inputs = {"tokens": torch.from_numpy(np.stack(batch_prompts)).to(dev)}
            inputs.update((k, torch.from_numpy(v).to(dev))
                          for k, v in frontend_inputs(cfg, rng, batch).items())
            t0 = time.perf_counter()
            logits, caches = M.prefill(params, inputs, cfg, ctx)
            caches = M.pad_caches(caches, cfg, max_seq=max_seq)
            toks = torch.argmax(logits, dim=-1)[:, None]
            kept = [logits] if keep_logits else None
            sync()
            t1 = time.perf_counter()
            outs = [toks]
            for step in range(gen_len - 1):
                logits, caches = M.decode_step(params, toks, caches,
                                               prompt_len + prefix + step, cfg, ctx)
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
    rng = np.random.default_rng(args.seed)
    prompts = make_prompts(cfg, args.requests, args.prompt_len, rng)
    res = serve(params, cfg, LOCAL_CTX, prompts, batch=args.batch,
                gen_len=args.gen_len, rng=rng)
    dt = res.seconds
    print(f"arch={cfg.name} served {len(res.done)} requests, "
          f"{res.tokens_out} tokens in {dt:.2f}s ({res.tokens_out/dt:.0f} tok/s)")
    print(f"sample: {res.done[0][:12].tolist()}")


if __name__ == "__main__":
    main()
