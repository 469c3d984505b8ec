#!/usr/bin/env python3
"""PaliGemma-3B's prefill on the card: steady milliseconds and one trace.

    python3 tools/pali_prefill.py [TREE] [LABEL]

TREE (default: this checkout) is the root of a checkout whose port is
timed, so two commits unpacked side by side can be compared in one call.
The published config (18 layers, f32 master weights from seed 7, bf16
activations), 4 prompts of 512 tokens with their 256 patch embeddings
drawn as the launcher draws them, attn_impl "cuda": one warm-up prefill,
8 timed ones (host clock around a synchronised call), then one under
torch.profiler (``chip_smoke.device_trace``): the card's busy share and the
flash kernel's device ms and launches.  Prints one ``PALI {...}`` line.
"""

import json
import sys
import time
from pathlib import Path

tree = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parents[1])
label = sys.argv[2] if len(sys.argv) > 2 else "tree"
sys.path.insert(0, str(tree))
sys.path.insert(0, str(tree / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed.sharding import ShardingCtx  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.launch import serve as S  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

REPS = 8


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    build.build(["flash_attention"])
    cfg = configs.get_config("paligemma-3b")
    params = M.init_params(7, cfg, dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(7)
    prompts = S.make_prompts(cfg, 4, 512, rng)
    batch = {"tokens": torch.from_numpy(np.stack(prompts[:4])).cuda()}
    batch.update((k, torch.from_numpy(v).cuda())
                 for k, v in S.frontend_inputs(cfg, rng, 4).items())
    ctx = ShardingCtx(attn_impl="cuda")
    times = []
    with torch.inference_mode():
        M.prefill(params, batch, cfg, ctx)
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            M.prefill(params, batch, cfg, ctx)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        FK.flash_attention.tc_launches = 0
        trace_path = Path(CS.ROOT) / "build" / f"trace_pali_{label}.json"
        trace_path.parent.mkdir(parents=True, exist_ok=True)
        rep, _ = CS.device_trace(torch, lambda: M.prefill(params, batch, cfg, ctx),
                                 trace_path)
    flash = [v for k, v in rep["by_name"].items() if "flash" in k]
    print("PALI " + json.dumps({
        "label": label, "prefill_ms": times, "median_ms": float(np.median(times)),
        "traced_wall_s": rep["wall_s"], "device_busy_s": rep["device_busy_s"],
        "busy_share": rep["busy_share"],
        "flash_ms": sum(v["ms"] for v in flash),
        "flash_launches": sum(v["launches"] for v in flash),
        "tc_launches": FK.flash_attention.tc_launches}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
