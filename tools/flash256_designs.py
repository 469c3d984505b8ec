#!/usr/bin/env python3
"""Time three designs of the flash kernel's head-dim 256 arm on the card.

    python3 tools/flash256_designs.py        # from the root of a checkout, on the card

Builds ``src/repro_torch/csrc/flash_attention.cu`` with
``tools/flash256_designs.cuh`` appended (two other designs of the arm) into
``build/``, prints ptxas's registers and spills for each, holds each
against the plain version at PaliGemma's and Gemma-7B's prefill shapes and
the ragged ones of ``tests/test_torch_cuda.py`` (bf16 within 5e-2 and
2^-6 x max |plain|, bitwise on repeat), then times them in turns with one
SDPA call as ``chip_smoke.py`` times a kernel (CUDA events, L2 flushed,
the card backlogged).  The designs: 0 the committed arm (two warpgroups,
each owning 64 query rows and every column); 1 "cols" (64 rows, each
warpgroup half the columns, both computing the whole score tile); 2
"split" (the same, each warpgroup summing the scores over half of D and
the two exchanging partial scores through shared memory).
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402  (puts src on the path)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402

DESIGNS = {0: "committed", 1: "cols", 2: "split"}
TIMED = {"paligemma B=4 Hq=8 Hkv=1 S=768": (4, 8, 1, 768, 768),
         "gemma-7b B=4 H=16 S=512": (4, 16, 16, 512, 512)}
CHECKED = [(4, 8, 1, 768, 768, True), (4, 16, 16, 512, 512, True),
           (1, 4, 1, 77, 333, True), (1, 4, 2, 200, 70, False),
           (2, 16, 16, 1, 300, True), (1, 16, 16, 100, 333, False),
           (2, 4, 2, 70, 70, True)]


def compile_designs() -> ctypes.CDLL:
    out = build.build_dir() / "flash256_designs"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "flash256_designs.cu"
    src.write_text((ROOT / "src/repro_torch/csrc/flash_attention.cu").read_text()
                   + (ROOT / "tools/flash256_designs.cuh").read_text())
    lib = out / "libflash256_designs.so"
    r = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                        str(ROOT / "src/repro_torch/csrc"), "-o", str(lib), str(src)],
                       capture_output=True, text=True)
    lines = (r.stdout + r.stderr).splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and (
                "tcx" in line or "flash_fwd_tc_kernelILi256E" in line):
            print(line.split("'")[1][:90], " ".join(x.strip() for x in lines[i + 2:i + 4]))
    if r.returncode != 0:
        raise SystemExit("\n".join(lines[-40:]))
    return ctypes.CDLL(str(lib))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    fn = compile_designs().flash256_design
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]

    def run(design, q, k, v, causal):
        B, Hq, Sq, D = q.shape
        out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device="cuda").permute(0, 2, 1, 3)
        st = (ctypes.c_longlong * 16)(*q.stride(), *k.stride(), *v.stride(), *out.stride())
        rc = fn(design, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
                k.shape[1], Sq, k.shape[2], D, st, int(causal), D ** -0.5,
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise RuntimeError(f"design {design}: CUDA error {rc}")
        return out

    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)
    bad = []
    for B, Hq, Hkv, Sq, Skv, causal in CHECKED:
        q, k, v = mk(B, Hq, Sq, 256), mk(B, Hkv, Skv, 256), mk(B, Hkv, Skv, 256)
        want = FK.flash_attention_plain(q, k, v, causal=causal).float()
        for d, name in DESIGNS.items():
            out = run(d, q, k, v, causal)
            err = float((out.float() - want).abs().max())
            top = CS.BF16_TOP_ULPS * float(want.abs().max())
            ok = (bool(torch.isfinite(out.float()).all()) and err <= min(top, 5e-2)
                  and torch.equal(out, run(d, q, k, v, causal)))
            if not ok:
                bad.append((name, B, Hq, Hkv, Sq, Skv, causal, err))
    print("checks:", "all designs within bf16 5e-2 and 2^-6 x max |plain|, bitwise on "
          "repeat" if not bad else bad)
    smoke = CS.Smoke(torch, CS.parse_args([]))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for label, (B, Hq, Hkv, Sq, Skv) in TIMED.items():
        q, k, v = mk(B, Hq, Sq, 256), mk(B, Hkv, Skv, 256), mk(B, Hkv, Skv, 256)
        ms = {name: [] for name in DESIGNS.values()}
        ms["sdpa"] = []
        for order in (list(DESIGNS), list(DESIGNS)[::-1]):
            for d in order:
                ms[DESIGNS[d]].append(smoke.timed(lambda: run(d, q, k, v, True), 20))
            ms["sdpa"].append(smoke.timed(lambda: sdpa(q, k, v, is_causal=True,
                                                       enable_gqa=Hq != Hkv), 20))
        print(f"{label} causal bf16 ms, two turns: {json.dumps(ms)}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
