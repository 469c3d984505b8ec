#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of GraphMP on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure makes the exit code non-zero and suppresses the last
line):

1. build    compile ``src/repro_torch/csrc/*.cu`` for sm_90a into ``build/``.
2. kernels  hold each ELL kernel against its plain PyTorch version on the card,
            for sum/min/max, at the default W=16384/K=128/TR=8 on an R-MAT
            shard, on a star-graph hub that needs row splitting, and on an
            empty shard.  min/max must match bitwise; sum within
            rtol=1e-4, atol=1e-5 (the reference's own kernel tolerance).
            The lane kernels (3, 8, 32 and 64 lanes) also match the
            single-lane kernels on each message row bitwise, and padding
            lanes of a ragged launch are 0.
            A small engine run of the ``cuda`` backend is held against the
            ``numpy`` oracle (bitwise for min/max programs).
3. lm_kernels  the flash-attention kernel against its plain version (GQA
            8:1, D=128; S = 24, 512, 8192, Sq < Skv, non-causal; f32 within
            2e-3, bf16 within 5e-2, the reference's kernel tolerances, and
            bf16 also within 2^-6 x max |plain|, two bf16 ulps at the top of
            the output's range); every bf16 call runs the tensor-core kernel
            (tc_launches), every f32 call the scalar one.  Then timed at
            B=4 S=512 and B=1 S=8192 (bf16, causal) beside its bound (the
            larger of 4 B Hq S^2 D / 2 flops over 989 TFLOP/s and q+k+v+o
            bytes over 3.35 TB/s), the plain version and one SDPA call; the
            f32 scalar kernel is timed once at B=4 S=512.
4. lm_serve the LM serving launcher at Qwen2.5-3B's full width and depth
            (36 layers, f32 master weights from the seed, 12.3 GB): 8
            requests of 512 tokens in batches of 4, 32 tokens each, and one
            request at the launcher's defaults (24 tokens, 16 out), with
            attn_impl "cuda".  The flash kernel's launches must equal 36 x
            the prefill batches, every one on the tensor-core kernel; the
            first batch's last-position logits must match attn_impl "torch"
            on the same weights (rtol 2e-2, atol 2e-2 x max(1, max |logit|);
            the error and its margin are printed); token ids in range; a
            second run from the same seed bitwise the same.  A prefill and a
            decode step are traced (diagnostic: the prefill's flash device
            time and the card's busy share); one decode step's cache
            attention is recorded, layer by layer.
5. lm_decode  the flash-decode kernel on that real cache (B=4, Hq=16,
            Hkv=2, D=128, bf16, S=544 with 513 valid), each layer's q and
            cache reshaped to the kernel's [BHkv, G, D] / [BHkv, S, D]
            layout, against the model's cache attention (bf16 within 5e-2);
            its 36 launches, all on the tensor-core ring kernel, are the
            ones counted.  Then against its plain version at S=32768
            (Qwen2.5-3B's context length) with ragged rows and an empty
            one, f32 within 2e-3 and bf16 within rtol 5e-2, atol 5e-2 x
            max |output| (random values over thousands of keys average to
            about 0.01, so a fixed 5e-2 would hold nothing) and within
            2^-6 x max |output|; bitwise the same on repeat; one device
            kernel a call (a traced run, where the profiler works); and
            timed at S=544 and S=32768 beside its bound (K and V rows of
            valid slots, q, o and the mask over 3.35 TB/s), the plain
            version and one masked SDPA call.
6. main     the engine's main path at 2^21 vertices / 2^25 R-MAT edges
            (Graph500 parameters, seed 7), 16 shards, batch_shards=4,
            prefetch_depth=2, cache_bytes=1 GiB: PageRank (5 iterations),
            SSSP and WCC on backend ``cuda``, once with
            device_resident=False and once with True, each held against
            backend ``torch`` on the card (min/max bitwise, PageRank within
            rtol=1e-4, atol=1e-9).  The kernels' launch counters must equal
            the executor's dispatches.
7. serve    the serving path on the same store: ``GraphService`` with
            backend ``cuda``, device_resident=True, batch_shards=4,
            max_lanes=16, max_groups=2 answers 32 BFS/SSSP/PPR queries
            (max_iters=20) in one fusion set through the ragged lane
            kernels; a ``ragged=False`` service on the same engine answers
            them through the lane kernel, bitwise the same; one query per
            program equals its solo ``VSWEngine.run`` bitwise; a service
            with device_resident=False answers 4 queries (max_iters=3)
            from the store; a ``torch`` backend service agrees (BFS/SSSP
            bitwise, PPR within rtol=1e-4, atol=1e-9).  Launch counters
            must equal the sweeps' dispatches, and the service's metrics
            must show no conservation violation.
8. timing   each ELL kernel, its plain version and a one-call library yardstick
            timed with CUDA events, L2 flushed before each call, on the
            main path's first batch of shards (the lane kernels at 16 and
            32 lanes), beside its bound: the bytes the function must move
            over 3.35 TB/s.  For the partials that is the whole mask plane,
            the 32 B sectors of idx that hold valid slots, the message
            sectors they gather, tile_window and the output (see
            spmv_ell.cu).  segment_combine and index_add_ take turns,
            200 calls each: their medians and spreads.  The lane combine
            is timed ragged and with one arm.  Earlier designs' times (the
            lane partials, the masked partials, the lane combine) are
            recorded beside the new ones.  The window staging probe times
            the masked and the lanes kernels with every tile gathering
            from window 0, which stays in L2.
9. sentinel ell_update(variant="sentinel") on the main path's first batch
            (shards 0-3) with PageRank's first messages, sum/min/max: its
            3 launches counted; partials and update bitwise the masked
            ones for each combine; against the plain version min/max
            bitwise, sum within rtol=1e-4, atol=1e-4 x max |partial| (the
            messages are below 2^-21: a fixed atol would hold nothing);
            timed beside the masked kernel, its bound the whole index
            plane, the gathered message sectors, tile_window and the output.
10. bloom   one BloomFilter32 per shard over the scheduler's exact source
            sets; active sets of 2^10 and 2^16 random vertices and every
            vertex: contains per filter and any_active_shards (48 + 3
            launches counted) bitwise against the host filters, no shard
            with an exact active source reported inactive; the one-launch
            any-reduction over 16 filters at every vertex timed beside
            its bound: the work of an in-order scan that stops once every
            filter has a hit (its ids, touched 32 B sectors and flags over
            3.35 TB/s, or its 32-bit operations over 67 TOP/s, the larger);
            and over 16 empty tables of the same sizes, where it must scan
            every id against every filter.
11. trace   (diagnostic: a profiler error leaves "not measured" and does
            not fail the run) one resident PageRank run of 3 iterations and
            one resident fusion set of 32 queries (max_iters=5) under
            torch.profiler: each kernel's device time as the engine
            launches it, beside the engine's kernel_s, and the card's busy
            share of the run.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak
SUM_RTOL, SUM_ATOL = 1e-4, 1e-5  # kernel vs plain, sum combine
PR_RTOL, PR_ATOL = 1e-4, 1e-9  # engine cuda vs torch, PageRank values
SERVE_QUERIES, SERVE_ITERS = 32, 20
SLEEP_CYCLES = 100_000_000  # about 50 ms of card time ahead of timed calls
SEGMENT_REPS = 200  # segment_combine and index_add_, in turns
L2_FLUSH_BYTES = 256 << 20  # written before each timed call; the L2 holds 50 MB
COMBINES = ("sum", "min", "max")
LANE_CHECK_COUNTS = (3, 8, 32, 64)  # 64: more lanes than a warp has threads
SPMV_CU = "src/repro_torch/csrc/spmv_ell.cu"
FLASH_CU = "src/repro_torch/csrc/flash_attention.cu"
DECODE_CU = "src/repro_torch/csrc/flash_decode.cu"
BLOOM_CU = "src/repro_torch/csrc/bloom.cu"
#: kernel -> the TPU kernel (or XLA step) it replaces, the shape of the
#: timing phase that stands for it in the kernels line, and its source
KERNELS = {
    "ell_partials_masked": ("src/repro/kernels/spmv_ell/kernel.py:63", "", SPMV_CU),
    "segment_combine": ("src/repro/kernels/spmv_ell/ops.py:40", "", SPMV_CU),
    "ell_partials_lanes": ("src/repro/kernels/spmv_ell/ops.py:72", " L=16", SPMV_CU),
    "ell_partials_ragged": ("src/repro/kernels/spmv_ell/kernel.py:123", " L=32",
                            SPMV_CU),
    "segment_combine_lanes": ("src/repro/kernels/spmv_ell/ops.py:301", " L=32",
                              SPMV_CU),
    "flash_attention": ("src/repro/kernels/flash_attention/kernel.py:212",
                        " B=4 S=512", FLASH_CU),
    "ell_partials_sentinel": ("src/repro/kernels/spmv_ell/kernel.py:177", "",
                              SPMV_CU),
    "bloom_contains": ("src/repro/kernels/bloom/kernel.py:44", " any", BLOOM_CU),
    "flash_decode": ("src/repro/kernels/flash_attention/kernel.py:129",
                     " S=32768", DECODE_CU),
}
#: earlier designs' times in this script's timing phase on the same batch
#: (NVIDIA H100 80GB HBM3 at 700 W), kept beside the new times: the lane
#: partials' first design (lanes in register chunks of 8, the row walked
#: again for each chunk); the masked partials' warp-set-and-exit design and
#: the lane combine's warp a row in chunks of 8 lanes, as redesigned since
EARLIER_MS = {"ell_partials_lanes L=16": 1.0867, "ell_partials_lanes L=32": 1.9869,
              "ell_partials_ragged L=16": 1.1250, "ell_partials_ragged L=32": 2.0670,
              "ell_partials_masked": 0.1973,
              "segment_combine_lanes L=16": 0.1253, "segment_combine_lanes L=32": 0.2334}
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
#: H100 SXM float32 outside the tensor cores; the bound of 32-bit integer
#: work too (its published rate is no higher), so the bound stays a least time
F32_OPS_PER_S = 67e12
DECODE_B, DECODE_HQ, DECODE_HKV, DECODE_D = 4, 16, 2, 128  # Qwen2.5-3B
DECODE_LONG = 32768  # the config's longest context
BLOOM_SETS = (1 << 10, 1 << 16)  # random active sets; plus every vertex
#: flash kernel vs its plain version (tests/test_kernels.py:125,137,148)
FLASH_TOL = {"float32": 2e-3, "bfloat16": 5e-2}
#: bf16 outputs also within two bf16 ulps at the top of their range: the
#: absolute 5e-2 is loose against outputs that average many values
BF16_TOP_ULPS = 2.0 ** -6
LM_ARCH = "qwen2.5-3b"
LM_REQUESTS, LM_BATCH, LM_PROMPT, LM_GEN = 8, 4, 512, 32
LM_DEFAULT_PROMPT, LM_DEFAULT_GEN = 24, 16  # the launcher's defaults
#: last-position prefill logits, attn_impl "cuda" vs "torch" on the same
#: weights: the activations are bf16, and the two paths differ only in the
#: attention's f32 summation order before each layer's output is rounded
#: to bf16 (2^-8 relative), so a rounding may flip and travel up the 36
#: layers.  The parity tests' bf16 tolerance: rtol 2e-2, atol 2e-2 x
#: max(1, max |logit|) (tests/test_torch_lm.py).
LM_RTOL = LM_ATOL = 2e-2


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--vertices", type=int, default=1 << 21)
    ap.add_argument("--edges", type=int, default=1 << 25)
    ap.add_argument("--shards", type=int, default=16)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "chip_smoke.json"))
    return ap.parse_args(argv)


class Smoke:
    """Runs the phases, collects failures and the numbers to report."""

    def __init__(self, torch, args):
        self.torch = torch
        self.args = args
        self.failures = []
        self.report = {"phases": {}}
        self.errs = dict.fromkeys(KERNELS, 0.0)
        self.launches = dict.fromkeys(KERNELS, 0)
        self.l2_flush = None
        self.serve_engine = None
        self.timings = {}
        self.lm_timings = {}
        self.entry_timings = {}
        self.lm_decode_calls = None

    def phase(self, name, fn):
        t0 = time.perf_counter()
        print(f"== {name}", flush=True)
        try:
            fn()
            ok = True
        except Exception:
            traceback.print_exc()
            self.failures.append(name)
            ok = False
        dt = time.perf_counter() - t0
        self.report["phases"][name] = {"ok": ok, "seconds": dt}
        print(f"== {name}: {'ok' if ok else 'FAILED'} in {dt:.1f} s", flush=True)

    # ------------------------------------------------------------ helpers
    def compare(self, name, got, want, combine, where, atol=SUM_ATOL):
        """Kernel vs plain: bitwise for min/max, tolerance for sum (``atol``
        for data far below 1, whose sums the default ``SUM_ATOL`` would
        not hold)."""
        import numpy as np

        a = got.detach().cpu().numpy()
        b = want.detach().cpu().numpy()
        if a.shape != b.shape:
            raise AssertionError(f"{name} {where}: shape {a.shape} != {b.shape}")
        fin = np.isfinite(a) & np.isfinite(b)
        if not np.array_equal(np.isfinite(a), np.isfinite(b)) or not (
                np.array_equal(a[~fin], b[~fin])):
            raise AssertionError(f"{name} {where} {combine}: non-finite mismatch")
        err = float(np.abs(a[fin] - b[fin]).max()) if fin.any() else 0.0
        self.errs[name] = max(self.errs[name], err)
        if combine == "sum":
            if not np.allclose(a, b, rtol=SUM_RTOL, atol=atol):
                raise AssertionError(f"{name} {where} sum: max err {err}")
        elif not np.array_equal(a, b):
            raise AssertionError(f"{name} {where} {combine}: not bitwise equal "
                                 f"(max err {err})")
        return err

    def timed(self, fn, reps):
        """Device ms per call, each call after the L2 cache is flushed: the
        main path meets a kernel's index planes cold.  A sleep kernel keeps
        the card busy while the host queues the calls, so the wrappers'
        host time is not counted (a call that waits on the card still is)."""
        torch = self.torch
        if self.l2_flush is None:
            self.l2_flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
        fn()  # warm-up
        torch.cuda.synchronize()
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        torch.cuda._sleep(SLEEP_CYCLES)
        for start, end in pairs:
            self.l2_flush.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / reps

    def timed_each(self, fns, reps):
        """Device ms of every call, the functions (name -> fn) taking turns
        call by call, each call after the L2 flush and behind the sleep
        kernel as in :meth:`timed`: name -> ``reps`` times."""
        torch = self.torch
        if self.l2_flush is None:
            self.l2_flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
        for fn in fns.values():
            fn()  # warm-up
        torch.cuda.synchronize()
        events = {n: [(torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
                  for n in fns}
        torch.cuda._sleep(SLEEP_CYCLES)
        for i in range(reps):
            for n, fn in fns.items():
                self.l2_flush.zero_()
                events[n][i][0].record()
                fn()
                events[n][i][1].record()
        torch.cuda.synchronize()
        return {n: [a.elapsed_time(b) for a, b in ev] for n, ev in events.items()}

    # ------------------------------------------------------------- phases
    def build(self):
        from repro_torch.kernels import build

        t0 = time.perf_counter()
        libs = build.build()
        self.report["build_s"] = time.perf_counter() - t0
        for name, path in libs.items():
            log = Path(str(path) + ".log")
            text = log.read_text(errors="replace") if log.exists() else ""
            print(f"built {name}: {path.name}")
            for line in text.splitlines():
                if "registers" in line or "spill" in line or "Compiling" in line:
                    print("  " + line.strip())

    def kernel_checks(self):
        import numpy as np
        torch = self.torch
        from repro_torch.core import csr_to_ell, ell_to_device, preprocess
        from repro_torch.core.graph import from_edge_list, rmat_graph, star_graph
        from repro_torch.kernels.spmv_ell import kernel as K

        dev = torch.device("cuda")
        rng = np.random.default_rng(self.args.seed)
        cases = []
        g = rmat_graph(1 << 17, 1 << 21, seed=self.args.seed)
        _, shards = preprocess(g, num_shards=2)
        cases.append(("rmat W=16384 K=128 TR=8", shards[0], g.num_vertices))
        g = star_graph(200_000)
        _, shards = preprocess(g, num_shards=1)
        cases.append(("star hub (row split)", shards[0], g.num_vertices))
        g = from_edge_list([(0, 1)], num_vertices=64)
        _, shards = preprocess(g, num_shards=2)
        empty = [s for s in shards if s.nnz == 0][0]
        cases.append(("empty shard", empty, g.num_vertices))
        for where, shard, nv in cases:
            ell = csr_to_ell(shard, nv)
            dell = ell_to_device(ell, dev)
            n_pad = dell.num_windows * dell.window
            for combine in ("sum", "min", "max"):
                x = rng.random(n_pad).astype(np.float32)
                if combine != "sum":
                    x[rng.random(n_pad) < 0.1] = np.inf if combine == "min" else -np.inf
                msgs = torch.from_numpy(x).to(dev)
                kw = dict(window=dell.window, tr=dell.tr, combine=combine)
                part = K.ell_partials_masked(dell.idx, dell.mask,
                                             dell.tile_window, msgs, **kw)
                plain = K.ell_partials_masked_plain(dell.idx, dell.mask,
                                                    dell.tile_window, msgs, **kw)
                torch.cuda.synchronize()
                e1 = self.compare("ell_partials_masked", part, plain, combine, where)
                acc = K.segment_combine(part, dell.perm, dell.row_ptr, combine)
                acc_plain = K.segment_combine_plain(part, dell.perm,
                                                    dell.row_ptr, combine)
                torch.cuda.synchronize()
                e2 = self.compare("segment_combine", acc, acc_plain, combine, where)
                print(f"  {where:26s} {combine}: n_ell={dell.n_ell} "
                      f"rows={dell.rows} err partials={e1:.3g} combine={e2:.3g}")
            self.lane_checks(K, dell, rng, where)
        # the star hub's row 0 gathers every spoke
        star = cases[1]
        ell = ell_to_device(csr_to_ell(star[1], star[2]), dev)
        ones = torch.ones(ell.num_windows * ell.window, device=dev)
        hub = K.segment_combine(
            K.ell_partials_masked(ell.idx, ell.mask, ell.tile_window, ones,
                                  window=ell.window, tr=ell.tr, combine="sum"),
            ell.perm, ell.row_ptr, "sum")
        if float(hub[0]) != star[2] - 1 or float(hub[1:].abs().max()) != 0.0:
            raise AssertionError(f"star hub sum {float(hub[0])} != {star[2] - 1}")

    def compare_lanes(self, name, got, want, combines, where):
        """Row-by-row :meth:`compare` with each lane's combine; a padding
        lane (combine None) must be 0."""
        for l, c in enumerate(combines):
            if c is None:
                if self.torch.count_nonzero(got[l]):
                    raise AssertionError(f"{name} {where}: padding lane {l} not 0")
            else:
                self.compare(name, got[l], want[l], c, where)

    def lane_checks(self, K, dell, rng, where):
        """The lane kernels against the single-lane kernels (bitwise, row
        by row) and against their plain versions."""
        import numpy as np
        torch = self.torch
        n_pad = dell.num_windows * dell.window
        planes = ([dell.idx], [dell.mask], [dell.tile_window])
        seg = ([dell.perm], [dell.row_ptr])
        kw = dict(window=dell.window, tr=dell.tr)
        for n_lanes in LANE_CHECK_COUNTS:
            x = rng.random((n_lanes, n_pad)).astype(np.float32)
            x[rng.random(x.shape) < 0.1] = np.inf
            msgs = torch.from_numpy(x).to("cuda")
            for combine in ("sum", "min"):
                part = K.ell_partials_lanes(*planes, msgs, combine=combine, **kw)
                one = torch.stack([K.ell_partials_masked(*planes, msgs[l],
                                                         combine=combine, **kw)
                                   for l in range(n_lanes)])
                self.compare_lanes("ell_partials_lanes", part, K.ell_partials_lanes_plain(
                    *planes, msgs, combine=combine, **kw), [combine] * n_lanes, where)
                acc = K.segment_combine_lanes(part, *seg, (combine,))
                one_acc = torch.stack([K.segment_combine(part[l].contiguous(), *seg, combine)
                                       for l in range(n_lanes)])
                if not (torch.equal(part, one) and torch.equal(acc, one_acc)):
                    raise AssertionError(f"lanes {where} {combine}: a lane is not "
                                         f"bitwise its single-lane launch")
            # ragged: three arms cycling over the lanes, the last lane padding
            arms = ("min", "sum", "max")
            ids = [l % 3 for l in range(n_lanes - 1)] + [len(arms)]
            cids = torch.tensor(ids, dtype=torch.int32, device="cuda")
            lane_c = [arms[i] if i < len(arms) else None for i in ids]
            part = K.ell_partials_ragged(*planes, cids, msgs, combines=arms, **kw)
            self.compare_lanes("ell_partials_ragged", part, K.ell_partials_ragged_plain(
                *planes, cids, msgs, combines=arms, **kw), lane_c, where)
            acc = K.segment_combine_lanes(part, *seg, arms, cids)
            self.compare_lanes("segment_combine_lanes", acc, K.segment_combine_lanes_plain(
                part, *seg, arms, cids), lane_c, where)
            for l, c in enumerate(lane_c[:-1]):
                if not torch.equal(part[l], K.ell_partials_masked(
                        *planes, msgs[l], combine=c, **kw)):
                    raise AssertionError(f"ragged {where}: lane {l} is not "
                                         f"bitwise its single-lane launch")
        print(f"  {where:26s} lanes {'/'.join(map(str, LANE_CHECK_COUNTS))}: "
              f"== single-lane launches bitwise")

    def small_engine(self):
        """cuda backend vs the numpy oracle on a small graph."""
        import numpy as np
        from repro_torch.core import VSWEngine, apps, rmat_graph

        g = rmat_graph(1 << 15, 1 << 19, seed=self.args.seed + 1)
        with tempfile.TemporaryDirectory() as d:
            out = {}
            for backend in ("numpy", "cuda"):
                eng = VSWEngine.from_graph(
                    g, f"{d}/{backend}", num_shards=6, backend=backend,
                    batch_shards=3, device="cuda")
                with eng:
                    for name, prog in (("pagerank", apps.pagerank()),
                                       ("sssp", apps.sssp(0)), ("wcc", apps.wcc())):
                        out[backend, name] = eng.run(prog, max_iters=20).values
        f = lambda v: np.nan_to_num(v, posinf=1e30)
        for name in ("sssp", "wcc"):
            if not np.array_equal(f(out["numpy", name]), f(out["cuda", name])):
                raise AssertionError(f"small {name}: cuda != numpy oracle")
        a, b = out["cuda", "pagerank"], out["numpy", "pagerank"]
        if not np.allclose(a, b, rtol=1e-5, atol=1e-9):
            raise AssertionError(f"small pagerank: max err {np.abs(a - b).max()}")
        print(f"  small graph ({g.num_vertices} v, {g.num_edges} e): cuda == "
              f"numpy (sssp, wcc bitwise; pagerank max err "
              f"{float(np.abs(a - b).max()):.3g})")

    def main_path(self):
        import numpy as np
        torch = self.torch
        from repro_torch.core import VSWEngine, apps, rmat_graph
        from repro_torch.kernels.spmv_ell import kernel as K

        a = self.args
        t0 = time.perf_counter()
        g = rmat_graph(a.vertices, a.edges, seed=a.seed)
        gen_s = time.perf_counter() - t0
        self.tmp = tempfile.TemporaryDirectory()
        root = self.tmp.name + "/store"
        t0 = time.perf_counter()
        eng = VSWEngine.from_graph(
            g, root, num_shards=a.shards, backend="cuda", batch_shards=4,
            prefetch_depth=2, cache_bytes=1 << 30, device="cuda")
        eng.close()
        prep_s = time.perf_counter() - t0
        del g
        store_bytes = sum(p.stat().st_size for p in Path(root).iterdir())
        print(f"  graph {a.vertices} v / {a.edges} e: generate {gen_s:.1f} s, "
              f"preprocess+write {prep_s:.1f} s, store {store_bytes} B")
        self.report["main"] = {"generate_s": gen_s, "preprocess_s": prep_s,
                               "store_bytes": store_bytes, "runs": {}}
        self.root = root
        programs = [("pagerank", apps.pagerank, 5), ("sssp", lambda: apps.sssp(0), 30),
                    ("wcc", apps.wcc, 30)]
        values = {}
        runs = [("cuda", False), ("cuda", True), ("torch", True)]
        for backend, resident in runs:
            eng = VSWEngine.from_store(
                root, backend=backend, device="cuda", batch_shards=4,
                prefetch_depth=2, cache_bytes=1 << 30,
                device_resident=resident)
            with eng:
                for name, prog, iters in programs:
                    if backend == "cuda":
                        K.ell_partials_masked.launches = 0
                        K.segment_combine.launches = 0
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    r = eng.run(prog(), max_iters=iters)
                    wall = time.perf_counter() - t0
                    dispatches = sum(i.dispatches for i in r.iterations)
                    launches = (K.ell_partials_masked.launches,
                                K.segment_combine.launches)
                    key = f"{backend} resident={resident} {name}"
                    values[backend, resident, name] = r.values
                    self.report["main"]["runs"][key] = {
                        "wall_s": wall, "iterations": len(r.iterations),
                        "converged": r.converged, "dispatches": dispatches,
                        "launches": list(launches),
                        "iters": [vars(i) for i in r.iterations],
                    }
                    print(f"  {key}: {len(r.iterations)} iterations, "
                          f"converged={r.converged}, {wall:.2f} s, "
                          f"dispatches={dispatches}")
                    for i in r.iterations:
                        print(f"    it{i.iteration:<2d} time_s={i.time_s:.4f} "
                              f"bytes_read={i.bytes_read} "
                              f"load_wait_s={i.load_wait_s:.4f} "
                              f"to_device_s={i.to_device_s:.4f} "
                              f"exec_s={i.exec_s:.4f} kernel_s={i.kernel_s:.5f} "
                              f"launches={i.dispatches} "
                              f"padding_ratio={i.padding_ratio:.4f} "
                              f"shards={i.shards_processed}")
                    steady = r.iterations[1:] or r.iterations
                    med = {k: float(np.median([getattr(i, k) for i in steady]))
                           for k in ("time_s", "load_wait_s", "to_device_s",
                                     "exec_s", "kernel_s", "bytes_read")}
                    self.report["main"]["runs"][key]["steady_median"] = med
                    print(f"    median over iterations 1..: {json.dumps(med)}")
                    if backend == "cuda":
                        if launches != (dispatches, dispatches):
                            raise AssertionError(
                                f"{key}: kernel launches {launches} != "
                                f"dispatches {dispatches}")
                        if not resident:  # the main path's own launches
                            for kname, n in zip(self.launches, launches):
                                self.launches[kname] += n
        f = lambda v: np.nan_to_num(v, posinf=1e30)
        for resident in (False, True):
            for name in ("sssp", "wcc"):
                if not np.array_equal(f(values["cuda", resident, name]),
                                      f(values["torch", True, name])):
                    raise AssertionError(f"{name} resident={resident}: cuda != torch")
            x, y = values["cuda", resident, "pagerank"], values["torch", True, "pagerank"]
            err = float(np.abs(x - y).max())
            if not np.allclose(x, y, rtol=PR_RTOL, atol=PR_ATOL):
                raise AssertionError(f"pagerank resident={resident}: max err {err}")
            print(f"  resident={resident}: cuda == torch (sssp, wcc bitwise; "
                  f"pagerank max err {err:.3g})")
        for key, v in values.items():
            if v.shape != (a.vertices,) or not np.all(np.isfinite(v) | (v == np.inf)):
                raise AssertionError(f"{key}: wrong shape, NaN or -inf in values")

    def serve(self):
        """The serving path at full size: see the module docstring."""
        import numpy as np
        torch = self.torch
        from repro_torch.core import ShardStore, VSWEngine, apps
        from repro_torch.kernels.spmv_ell import kernel as K
        from repro_torch.serve import GraphService

        a = self.args
        meta = ShardStore(self.root).read_meta()
        rng = np.random.default_rng(a.seed)
        srcs = rng.choice(np.flatnonzero(meta.out_deg > 0), size=SERVE_QUERIES,
                          replace=False)
        progs = ("bfs", "sssp", "ppr")  # examples/serve_quickstart.py's mix
        queries = [(progs[i % 3], int(v)) for i, v in enumerate(srcs)]
        self.queries = queries
        lanes_k = ("ell_partials_ragged", "ell_partials_lanes", "segment_combine_lanes")
        common = dict(batch_shards=4, max_lanes=16, max_groups=2)
        eng_kw = dict(device="cuda", prefetch_depth=2)
        rep = self.report["serve"] = {"queries": queries, "runs": {}}

        def drive(label, svc, qs, iters, ragged):
            for n in lanes_k:
                getattr(K, n).launches = 0
            ctr = lambda k: int(svc.metrics.counter(f"sweep.{k}").value)
            c0 = {k: ctr(k) for k in ("dispatches", "ragged_dispatches", "batches")}
            sweeps0 = svc.stats()["sweeps"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with svc.submit_batch():
                futs = [svc.submit(p, v, max_iters=iters) for p, v in qs]
            res = [f.result(timeout=1200) for f in futs]
            wall = time.perf_counter() - t0
            sweeps = settle(svc, sweeps0)
            launches = {n: getattr(K, n).launches for n in lanes_k}
            counts = {k: ctr(k) - c0[k] for k in c0}
            snap = svc.metrics_snapshot()
            if snap["conservation_violations"]:
                raise AssertionError(f"{label}: {snap['conservation_violations']}")
            if sweeps != 1:
                raise AssertionError(f"{label}: {sweeps} fusion sets, not 1")
            st = svc.last_sweep_stats
            lat = np.array([r.latency_s for r in res])
            med = {k: float(np.median([getattr(i, k) for i in st]))
                   for k in ("time_s", "exec_s", "kernel_s", "dispatches",
                             "batches", "overlap_s", "live_lanes")}
            summary = {
                "wall_s": wall, "queries_per_s": len(qs) / wall,
                "latency_p50_s": float(np.percentile(lat, 50)),
                "latency_p99_s": float(np.percentile(lat, 99)),
                "fusion_sets": sweeps, "iterations": len(st),
                "launches": launches, "sweep_counts": counts,
                "iter_median": med, "iters": [vars(i) for i in st]}
            rep["runs"][label] = summary
            print(f"  {label}: {len(qs)} queries in {wall:.2f} s "
                  f"({len(qs) / wall:.2f} q/s), latency p50 "
                  f"{summary['latency_p50_s']:.3f} s p99 "
                  f"{summary['latency_p99_s']:.3f} s, {sweeps} fusion set(s), "
                  f"{len(st)} iterations, launches {launches}, counts {counts}")
            print(f"    per-iteration median: {json.dumps(med)}")
            if svc.engine.backend_name == "cuda":
                lane_k, other = (("ell_partials_ragged", "ell_partials_lanes")
                                 if ragged else
                                 ("ell_partials_lanes", "ell_partials_ragged"))
                n = counts["dispatches"]
                if not (n > 0 and launches[lane_k] == n and launches[other] == 0
                        and launches["segment_combine_lanes"] == n
                        and (not ragged or counts["ragged_dispatches"] == n)):
                    raise AssertionError(f"{label}: launches {launches} != "
                                         f"sweep counts {counts}")
                for name in lanes_k:
                    self.launches[name] += launches[name]
            return res

        f = lambda v: np.nan_to_num(v, posinf=1e30)
        svc = GraphService.from_store(self.root, backend="cuda", device_resident=True,
                                      **eng_kw, **common)
        self.serve_engine = svc.engine
        svc.engine.run(apps.pagerank(), max_iters=1)  # every shard onto the card
        ragged = drive("cuda ragged resident", svc, queries, SERVE_ITERS, True)
        svc.close(close_engine=False)
        multi_svc = GraphService(self.serve_engine, ragged=False, **common)
        multi = drive("cuda multi resident", multi_svc, queries, SERVE_ITERS, False)
        multi_svc.close(close_engine=False)
        for (p, v), x, y in zip(queries, ragged, multi):
            if not (np.array_equal(f(x.values), f(y.values))
                    and (x.iterations, x.converged) == (y.iterations, y.converged)):
                raise AssertionError(f"{p} {v}: ragged != multi")
        print(f"  ragged == multi bitwise for all {len(queries)} queries "
              f"(values, iterations, converged)")

        short = queries[:4]
        store_svc = GraphService.from_store(self.root, backend="cuda",
                                            device_resident=False, **eng_kw, **common)
        with store_svc:
            from_store = drive("cuda ragged from store", store_svc, short, 3, True)
        with VSWEngine.from_store(self.root, backend="cuda", batch_shards=4,
                                  device_resident=True, **eng_kw) as solo:
            checks = [(i, SERVE_ITERS, ragged[i]) for i in range(3)]
            checks += [(i, 3, r) for i, r in enumerate(from_store)]
            for i, iters, qr in checks:
                p, v = queries[i]
                want = solo.run(apps.get_program(p, source=v), max_iters=iters)
                if not (np.array_equal(f(qr.values), f(want.values))
                        and qr.iterations == want.num_iterations
                        and qr.converged == want.converged):
                    raise AssertionError(f"{p} {v} max_iters={iters}: lane != solo run")
        print("  one query per program == its solo cuda VSWEngine.run bitwise; "
              "the 4 queries from the store too")

        with GraphService.from_store(self.root, backend="torch", device_resident=True,
                                     **eng_kw, **common) as torch_svc:
            ref = drive("torch ragged resident", torch_svc, queries, SERVE_ITERS, True)
        worst = 0.0
        for (p, v), x, y in zip(queries, ragged, ref):
            if p == "ppr":
                err = float(np.abs(x.values - y.values).max())
                worst = max(worst, err)
                if not np.allclose(x.values, y.values, rtol=PR_RTOL, atol=PR_ATOL):
                    raise AssertionError(f"ppr {v}: cuda vs torch max err {err}")
            elif not (np.array_equal(f(x.values), f(y.values))
                      and x.iterations == y.iterations):
                raise AssertionError(f"{p} {v}: cuda != torch")
        for key, r in (("ragged", ragged), ("multi", multi)):
            for qr in r:
                if qr.values.shape != (a.vertices,) or np.isnan(qr.values).any() or (
                        qr.values == -np.inf).any():
                    raise AssertionError(f"{key} {qr.program} {qr.source}: bad values")
        rep["ppr_max_err_vs_torch"] = worst
        print(f"  cuda == torch (bfs, sssp bitwise; ppr max err {worst:.3g})")

    def trace(self):
        from repro_torch.core import VSWEngine, apps

        torch = self.torch
        eng = VSWEngine.from_store(
            self.root, backend="cuda", device="cuda", batch_shards=4,
            prefetch_depth=2, cache_bytes=1 << 30, device_resident=True)
        out = Path(self.args.out).parent / "trace_resident_pagerank.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        with eng:
            eng.run(apps.pagerank(), max_iters=1)  # puts every shard on the card
            torch.cuda.synchronize()
            try:
                rep, r = device_trace(
                    torch, lambda: eng.run(apps.pagerank(), max_iters=3), out)
            except Exception as exc:  # a diagnostic: report, do not fail
                rep, r = {"not measured": repr(exc)}, None
        if r is not None:
            rep["engine_kernel_s"] = sum(i.kernel_s for i in r.iterations)
            rep["engine_exec_s"] = sum(i.exec_s for i in r.iterations)
            rep["engine_time_s"] = sum(i.time_s for i in r.iterations)
            rep["by_name"] = dict(sorted(rep["by_name"].items(),
                                         key=lambda kv: -kv[1]["ms"])[:12])
        self.report["trace"] = rep
        print(f"  {json.dumps(rep)}")
        if self.serve_engine is not None:
            self.trace_fusion_set()

    def trace_fusion_set(self):
        """One resident fusion set of the serve phase's 32 queries
        (max_iters=5) under the profiler."""
        from repro_torch.serve import GraphService

        svc = GraphService(self.serve_engine, batch_shards=4, max_lanes=16,
                           max_groups=2, session_entries=0)
        out = Path(self.args.out).parent / "trace_resident_fusion_set.json"

        def run():
            with svc.submit_batch():
                futs = [svc.submit(p, v, max_iters=5) for p, v in self.queries]
            [f.result(timeout=600) for f in futs]
            settle(svc, 0)
            return svc.last_sweep_stats

        try:
            rep, st = device_trace(self.torch, run, out)
        except Exception as exc:  # a diagnostic: report, do not fail
            rep, st = {"not measured": repr(exc)}, None
        finally:
            svc.close(close_engine=False)
        if st is not None:
            rep["sweep_kernel_s"] = sum(i.kernel_s for i in st)
            rep["sweep_exec_s"] = sum(i.exec_s for i in st)
            rep["sweep_time_s"] = sum(i.time_s for i in st)
            rep["by_name"] = dict(sorted(rep["by_name"].items(),
                                         key=lambda kv: -kv[1]["ms"])[:12])
        self.report["trace_fusion_set"] = rep
        print(f"  fusion set: {json.dumps(rep)}")

    @staticmethod
    def partials_bytes(torch, idxs, masks, tws, window, tr):
        """Bytes the partials function must move on this data: every mask
        byte, the 32 B idx sectors holding a valid slot, the 32 B message
        sectors the valid slots gather (once per launch), tile_window, and
        4 B out per ELL row."""
        total, msg_sectors = 0, []
        for idx, mask, tw in zip(idxs, masks, tws):
            n_ell, k = idx.shape
            total += mask.numel() + 4 * tw.numel() + 4 * n_ell
            r, c = mask.nonzero(as_tuple=True)
            byte = (r * k + c) * idx.element_size()
            total += 32 * torch.unique(byte // 32).numel()
            col = idx[r, c].long().clamp_(0, window - 1)
            msg_sectors.append((tw.long()[r // tr] * window + col) // 8)
        return total + 32 * torch.unique(torch.cat(msg_sectors)).numel()

    def timing(self):
        import numpy as np
        torch = self.torch
        from repro_torch.core import ShardStore, ell_to_device
        from repro_torch.kernels.spmv_ell import kernel as K

        dev = torch.device("cuda")
        store = ShardStore(self.root)
        ells = [store.load_shard(p, "ell") for p in range(4)]
        shards = [ell_to_device(e, dev) for e in ells]
        offs = np.cumsum([0] + [e.rows for e in ells])
        seg = torch.from_numpy(np.concatenate(
            [e.seg.astype(np.int64) + o for e, o in zip(ells, offs)])).to(dev)
        del ells
        first = shards[0]
        idxs = [d.idx for d in shards]
        masks = [d.mask for d in shards]
        tws = [d.tile_window for d in shards]
        perms = [d.perm for d in shards]
        ptrs = [d.row_ptr for d in shards]
        rng = np.random.default_rng(self.args.seed)
        n_pad = first.num_windows * first.window
        msgs = torch.from_numpy(rng.random(n_pad).astype(np.float32)).to(dev)
        kw = dict(window=first.window, tr=first.tr, combine="sum")
        args = (idxs, masks, tws, msgs)
        part = K.ell_partials_masked(*args, **kw)
        self.compare("ell_partials_masked", part,
                     K.ell_partials_masked_plain(*args, **kw), "sum", "main batch")
        acc = K.segment_combine(part, perms, ptrs, "sum")
        self.compare("segment_combine", acc,
                     K.segment_combine_plain(part, perms, ptrs, "sum"),
                     "sum", "main batch")
        n_ell = sum(d.n_ell for d in shards)
        rows = sum(d.rows for d in shards)
        n_valid = sum(int(d.row_ptr[-1]) for d in shards)
        nnz = sum(d.nnz for d in shards)
        t = {}
        t["ell_partials_masked"] = dict(
            ms=self.timed(lambda: K.ell_partials_masked(*args, **kw), 20),
            plain_ms=self.timed(lambda: K.ell_partials_masked_plain(*args, **kw), 3),
            library_ms=None,
            bytes=self.partials_bytes(torch, idxs, masks, tws, first.window,
                                      first.tr))
        lib_out = torch.zeros(rows, device=dev)
        each = self.timed_each({
            "kernel": lambda: K.segment_combine(part, perms, ptrs, "sum"),
            "index_add_": lambda: lib_out.zero_().index_add_(0, seg, part)},
            SEGMENT_REPS)
        spread = {n: spread_of(ms) for n, ms in each.items()}
        self.report["segment_combine_vs_index_add"] = spread
        t["segment_combine"] = dict(
            ms=spread["kernel"]["median"],
            plain_ms=self.timed(lambda: K.segment_combine_plain(
                part, perms, ptrs, "sum"), 10),
            library_ms=spread["index_add_"]["median"],
            bytes=4 * (2 * n_valid + 2 * rows + 1))
        for kname, d in t.items():
            d["bound_ms"] = d["bytes"] / HBM_BYTES_PER_S * 1e3
        slots = sum(d.idx.numel() for d in shards)
        self.report["timing_shape"] = {
            "shards": [d.shard_id for d in shards], "n_ell": n_ell,
            "k": first.k, "rows": rows, "nnz": nnz, "valid_ell_rows": n_valid,
            "padding_ratio": 1.0 - nnz / slots,
            "ell_bytes": sum(d.idx.numel() * d.idx.element_size()
                             + d.mask.numel() for d in shards)}
        self.timings = t
        print(f"  batch of shards {self.report['timing_shape']['shards']}: "
              f"n_ell={n_ell} valid rows={n_valid} rows={rows} nnz={nnz} "
              f"padding={1.0 - nnz / slots:.4f}")
        for kname, d in t.items():
            print(f"  {kname}: {json.dumps(d)}")
        # Window-staging probe: the same rows with every tile pointed at
        # window 0, so all gathers hit one table that stays on chip (64 KB;
        # 1-2 MB for the lanes kernel at 16-32 lanes, in lane_timing).  The
        # gap to the real run bounds what staging each window could save.
        tw0 = [torch.zeros_like(tw) for tw in tws]
        self.report["window_staging_probe"] = {
            "ms_real_windows": t["ell_partials_masked"]["ms"],
            "ms_one_window": self.timed(lambda: K.ell_partials_masked(
                idxs, masks, tw0, msgs, **kw), 20)}
        print(f"  window staging probe: "
              f"{json.dumps(self.report['window_staging_probe'])}")
        self.lane_timing(K, first, idxs, masks, tws, tw0, perms, ptrs, seg,
                         n_valid, rows, rng)
        # the min combine (SSSP/WCC) at the same shape, for the record
        kmin = dict(kw, combine="min")
        self.report["timing_min"] = {
            "ell_partials_masked_ms": self.timed(
                lambda: K.ell_partials_masked(*args, **kmin), 20),
            "segment_combine_ms": self.timed(lambda: K.segment_combine(
                part, perms, ptrs, "min"), 50)}
        print(f"  min combine: {json.dumps(self.report['timing_min'])}")

    def lane_timing(self, K, first, idxs, masks, tws, tw0, perms, ptrs, seg,
                    n_valid, rows, rng):
        """The lane kernels on the same batch at 16 and 32 lanes: the lanes
        kernel with the sum combine; the ragged kernel and the lane combine
        with half the lanes on a min arm and half on a sum arm, as a fusion
        set of BFS/SSSP and PPR lanes; the lane combine also with one sum
        arm on the lanes kernel's partials, as a per-group sweep."""
        import numpy as np
        torch = self.torch
        dev = first.idx.device
        window, tr = first.window, first.tr
        n_pad = first.num_windows * first.window
        t = self.timings
        arms = ("min", "sum")
        for L in (16, 32):
            x = torch.from_numpy(rng.random((L, n_pad)).astype(np.float32)).to(dev)
            lanes = K.LaneMessages(x)
            lanes.vertex_major()  # staged once an iteration on the path
            cids = torch.tensor([0] * (L // 2) + [1] * (L - L // 2),
                                dtype=torch.int32, device=dev)
            lane_c = [arms[i] for i in cids.tolist()]
            kw = dict(window=window, tr=tr)
            args = (idxs, masks, tws)
            part = K.ell_partials_lanes(*args, lanes, combine="sum", **kw)
            self.compare_lanes("ell_partials_lanes", part, K.ell_partials_lanes_plain(
                *args, lanes, combine="sum", **kw), ["sum"] * L, "main batch")
            rpart = K.ell_partials_ragged(*args, cids, lanes, combines=arms, **kw)
            self.compare_lanes("ell_partials_ragged", rpart, K.ell_partials_ragged_plain(
                *args, cids, lanes, combines=arms, **kw), lane_c, "main batch")
            acc = K.segment_combine_lanes(rpart, perms, ptrs, arms, cids)
            self.compare_lanes("segment_combine_lanes", acc,
                               K.segment_combine_lanes_plain(rpart, perms, ptrs,
                                                             arms, cids),
                               lane_c, "main batch")
            pbytes = self.lane_partials_bytes(torch, idxs, masks, tws, window, tr, L)
            lib = torch.zeros((L, rows), device=dev)
            t[f"ell_partials_lanes L={L}"] = dict(
                ms=self.timed(lambda: K.ell_partials_lanes(
                    *args, lanes, combine="sum", **kw), 20),
                plain_ms=self.timed(lambda: K.ell_partials_lanes_plain(
                    *args, lanes, combine="sum", **kw), 1),
                library_ms=None, bytes=pbytes)
            self.report["window_staging_probe"][f"lanes_L={L}_ms_one_window"] = \
                self.timed(lambda: K.ell_partials_lanes(
                    idxs, masks, tw0, lanes, combine="sum", **kw), 20)
            t[f"ell_partials_ragged L={L}"] = dict(
                ms=self.timed(lambda: K.ell_partials_ragged(
                    *args, cids, lanes, combines=arms, **kw), 20),
                plain_ms=self.timed(lambda: K.ell_partials_ragged_plain(
                    *args, cids, lanes, combines=arms, **kw), 1),
                library_ms=None, bytes=pbytes)
            cbytes = 4 * (L * n_valid + n_valid + rows + len(ptrs) + L * rows + L)
            library_ms = self.timed(lambda: lib.zero_().index_add_(1, seg, part), 20)
            t[f"segment_combine_lanes L={L}"] = dict(
                ms=self.timed(lambda: K.segment_combine_lanes(
                    rpart, perms, ptrs, arms, cids), 20),
                plain_ms=self.timed(lambda: K.segment_combine_lanes_plain(
                    rpart, perms, ptrs, arms, cids), 2),
                library_ms=library_ms, bytes=cbytes)
            # one arm, as the per-group sweeps launch it: a compile-time combine
            acc = K.segment_combine_lanes(part, perms, ptrs, ("sum",))
            self.compare_lanes("segment_combine_lanes", acc, K.segment_combine_lanes_plain(
                part, perms, ptrs, ("sum",), lanes.uniform_ids()), ["sum"] * L, "main batch")
            t[f"segment_combine_lanes one arm L={L}"] = dict(
                ms=self.timed(lambda: K.segment_combine_lanes(
                    part, perms, ptrs, ("sum",)), 20),
                plain_ms=self.timed(lambda: K.segment_combine_lanes_plain(
                    part, perms, ptrs, ("sum",), lanes.uniform_ids()), 2),
                library_ms=library_ms, bytes=cbytes)
            del x, lanes, part, rpart, acc, lib
        for kname, d in t.items():
            d["bound_ms"] = d["bytes"] / HBM_BYTES_PER_S * 1e3
            if kname in EARLIER_MS:
                d["earlier_ms"] = EARLIER_MS[kname]
            if " L=" in kname:
                print(f"  {kname}: {json.dumps(d)}")
        self.report["lane_timing"] = {k: d for k, d in t.items() if " L=" in k}

    # ------------------------------------------------------------ LM path
    def lm_kernels(self):
        """The flash kernel against its plain version on the card (GQA 8:1,
        D=128; ragged, long, suffix-aligned and non-causal shapes; f32 and
        bf16), then timed at the serving path's shapes."""
        torch = self.torch
        from repro_torch.kernels.flash_attention import kernel as FK

        gen = torch.Generator(device="cuda")
        gen.manual_seed(self.args.seed)

        def qkv(B, Sq, Skv, dtype, Hq=16, Hkv=2, D=128):
            mk = lambda *shape: torch.randn(*shape, generator=gen, device="cuda").to(dtype)
            return mk(B, Hq, Sq, D), mk(B, Hkv, Skv, D), mk(B, Hkv, Skv, D)

        cases = [(4, 24, 24, True), (4, 512, 512, True), (1, 8192, 8192, True),
                 (2, 200, 1000, True), (4, 512, 512, False), (2, 24, 600, False)]
        rep = self.report["lm_kernels"] = {"checks": [], "timing": {}}
        lib = FK.library("flash_attention")
        rep["tc_ctas_per_sm"] = {D: lib.flash_attention_tc_ctas_per_sm(D)
                                 for D in FK.TC_HEAD_DIMS}
        print(f"  tensor-core kernel, CTAs an SM by head dim: {rep['tc_ctas_per_sm']}")
        for dtype in (torch.float32, torch.bfloat16):
            tol = FLASH_TOL[str(dtype).split(".")[1]]
            for B, Sq, Skv, causal in cases:
                q, k, v = qkv(B, Sq, Skv, dtype)
                tc0 = FK.flash_attention.tc_launches
                out = FK.flash_attention(q, k, v, causal=causal)
                tc = FK.flash_attention.tc_launches - tc0
                want = FK.flash_attention_plain(q, k, v, causal=causal)
                torch.cuda.synchronize()
                a, b = out.float(), want.float()
                if out.dtype != dtype or a.shape != b.shape or not torch.isfinite(a).all():
                    raise AssertionError(f"flash {dtype} {B, Sq, Skv, causal}: "
                                         f"bad output")
                err = float((a - b).abs().max())
                top = BF16_TOP_ULPS * float(b.abs().max())
                self.errs["flash_attention"] = max(self.errs["flash_attention"], err)
                where = dict(dtype=str(dtype), B=B, Hq=16, Hkv=2, Sq=Sq, Skv=Skv,
                             D=128, causal=causal, kernel="tc" if tc else "scalar",
                             max_abs_err=err)
                if dtype == torch.bfloat16:
                    where["top_ulps_bound"] = top
                rep["checks"].append(where)
                print(f"  flash {json.dumps(where)}")
                if not torch.allclose(a, b, rtol=tol, atol=tol):
                    raise AssertionError(f"flash {where}: beyond {tol}")
                if dtype == torch.bfloat16 and err > top:
                    raise AssertionError(f"flash {where}: beyond 2^-6 x max |plain|")
                if tc != (dtype == torch.bfloat16):
                    raise AssertionError(f"flash {where}: the dispatch rule took "
                                         f"the wrong kernel")
                del q, k, v, out, want, a, b
        sdpa = torch.nn.functional.scaled_dot_product_attention
        for B, S, reps, plain_reps in ((4, 512, 20, 5), (1, 8192, 5, 2)):
            q, k, v = qkv(B, S, S, torch.bfloat16)
            flops = 4 * B * 16 * S * S * 128 / 2  # causal: half the pairs
            nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())  # q, k, v, o
            bound = {"operations": flops / BF16_FLOPS_PER_S * 1e3,
                     "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
            by = max(bound, key=bound.get)
            d = dict(
                ms=self.timed(lambda: FK.flash_attention(q, k, v, causal=True), reps),
                plain_ms=self.timed(lambda: FK.flash_attention_plain(
                    q, k, v, causal=True), plain_reps),
                # Sq == Skv: SDPA's top-left causal mask is the suffix one
                library_ms=self.timed(lambda: sdpa(q, k, v, is_causal=True,
                                                   enable_gqa=True), reps),
                bound_ms=bound[by], bound_by=by, flops=flops, bytes=nbytes)
            if B == 4:  # the scalar kernel once, in f32
                qf, kf, vf = q.float(), k.float(), v.float()
                d["scalar_f32_ms"] = self.timed(
                    lambda: FK.flash_attention(qf, kf, vf, causal=True), reps)
                del qf, kf, vf
            self.lm_timings[f"flash_attention B={B} S={S}"] = d
            rep["timing"][f"B={B} S={S}"] = d
            print(f"  flash_attention B={B} Hq=16 Hkv=2 S={S} D=128 bf16 causal: "
                  f"{json.dumps(d)}")
            del q, k, v

    def lm_serve(self):
        """The LM serving launcher at Qwen2.5-3B's full width and depth: see
        the module docstring."""
        import numpy as np
        torch = self.torch
        from repro_torch import configs
        from repro_torch.distributed.sharding import ShardingCtx
        from repro_torch.kernels.flash_attention import kernel as FK
        from repro_torch.launch import serve as S
        from repro_torch.models import model as M

        a = self.args
        cfg = configs.get_config(LM_ARCH)
        cuda, plain = ShardingCtx(attn_impl="cuda"), ShardingCtx(attn_impl="torch")
        rep = self.report["lm_serve"] = {"arch": cfg.name}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = M.init_params(a.seed, cfg, dtype=torch.float32, device="cuda")
        torch.cuda.synchronize()
        rep["init_s"] = time.perf_counter() - t0
        rep["params"] = sum(p.numel() for p in params.parameters())
        rep["param_bytes"] = sum(p.numel() * p.element_size()
                                 for p in params.parameters())
        prompts = S.make_prompts(cfg, LM_REQUESTS, LM_PROMPT, a.seed)
        short = S.make_prompts(cfg, 1, LM_DEFAULT_PROMPT, a.seed + 1)
        print(f"  {cfg.name}: {rep['params']} parameters in f32 "
              f"({rep['param_bytes']} B) initialised in {rep['init_s']:.2f} s")

        FK.flash_attention.launches = FK.flash_attention.tc_launches = 0
        res = S.serve(params, cfg, cuda, prompts, batch=LM_BATCH, gen_len=LM_GEN,
                      keep_logits=True)
        res_short = S.serve(params, cfg, cuda, short, batch=LM_BATCH,
                            gen_len=LM_DEFAULT_GEN)
        launches = FK.flash_attention.launches
        tc_launches = FK.flash_attention.tc_launches
        batches = res.batches + res_short.batches
        self.launches["flash_attention"] += launches
        for label, r, n_req, plen, glen in (
                ("B=4 S=512", res, LM_REQUESTS, LM_PROMPT, LM_GEN),
                ("B=4 S=24 (launcher defaults)", res_short, 1, LM_DEFAULT_PROMPT,
                 LM_DEFAULT_GEN)):
            d = {"requests": n_req, "batch": LM_BATCH, "prompt_len": plen,
                 "gen_len": glen, "batches": r.batches, "seconds": r.seconds,
                 "tokens_out": r.tokens_out, "tokens_per_s": r.tokens_out / r.seconds,
                 "prefill_ms": [x * 1e3 for x in r.prefill_s],
                 "decode_ms_per_step": [x * 1e3 / max(glen - 1, 1) for x in r.decode_s]}
            rep[label] = d
            print(f"  {label}: {n_req} requests, {r.tokens_out} tokens in "
                  f"{r.seconds:.3f} s ({d['tokens_per_s']:.1f} tok/s); prefill ms "
                  f"{[round(x, 3) for x in d['prefill_ms']]}; decode ms a step "
                  f"{[round(x, 3) for x in d['decode_ms_per_step']]}")
            for row in r.done:
                if row.shape != (glen,) or row.min() < 0 or row.max() >= cfg.vocab_size:
                    raise AssertionError(f"{label}: token ids out of range: {row}")
        rep["flash_launches"] = launches
        rep["flash_tc_launches"] = tc_launches
        print(f"  flash_attention launches {launches} = {cfg.num_layers} layers x "
              f"{batches} prefill batches: {launches == cfg.num_layers * batches}; "
              f"on the tensor-core kernel: {tc_launches}")
        if launches != cfg.num_layers * batches:
            raise AssertionError(f"flash launches {launches} != "
                                 f"{cfg.num_layers} x {batches}")
        if tc_launches != launches:
            raise AssertionError(f"{launches - tc_launches} flash launches off the "
                                 f"tensor-core kernel")

        # the first batch again through the plain attention, same weights
        first = np.stack(prompts[::-1][:LM_BATCH])
        with torch.inference_mode():
            want, _ = M.prefill(params, {"tokens": torch.from_numpy(first).cuda()},
                                cfg, plain)
        want = want.float().cpu().numpy()
        got = res.logits[0][0]
        err = float(np.abs(got - want).max())
        atol = LM_ATOL * max(1.0, float(np.abs(want).max()))
        # the tightest element: |got - want| against atol + rtol |want|
        margin = float((atol + LM_RTOL * np.abs(want) - np.abs(got - want)).min())
        rep["cuda_vs_torch"] = {
            "max_abs_err": err, "atol": atol, "rtol": LM_RTOL, "margin": margin,
            "max_abs_logit": float(np.abs(want).max()),
            "argmax_agree": float((got.argmax(-1) == want.argmax(-1)).mean())}
        print(f"  prefill logits cuda vs torch: {json.dumps(rep['cuda_vs_torch'])}")
        if not (np.isfinite(got).all() and np.allclose(got, want, rtol=LM_RTOL,
                                                       atol=atol)):
            raise AssertionError(f"prefill logits cuda vs torch: max err {err}")

        # one prefill batch and one decode step under the profiler: where
        # their device time goes, and the card's busy share
        tokens = torch.from_numpy(first).cuda()
        with torch.inference_mode():
            _, caches = M.prefill(params, {"tokens": tokens}, cfg, cuda)
            caches = M.pad_caches(caches, cfg, max_seq=LM_PROMPT + LM_GEN)
            # one decode step with each layer's cache attention recorded,
            # for the lm_decode phase
            self.lm_decode_calls = record_cache_attention(
                lambda: M.decode_step(params, tokens[:, :1], caches, LM_PROMPT,
                                      cfg, cuda))
        if len(self.lm_decode_calls) != cfg.num_layers:
            raise AssertionError(f"{len(self.lm_decode_calls)} cache attentions "
                                 f"recorded for {cfg.num_layers} layers")
        runs = {"prefill": lambda: M.prefill(params, {"tokens": tokens}, cfg, cuda),
                "decode_step": lambda: M.decode_step(params, tokens[:, :1], caches,
                                                     LM_PROMPT, cfg, cuda)}
        for name, run in runs.items():
            out = Path(a.out).parent / f"trace_lm_{name}.json"
            out.parent.mkdir(parents=True, exist_ok=True)
            try:
                with torch.inference_mode():
                    trace, _ = device_trace(torch, run, out)
                flash = [v for k, v in trace["by_name"].items() if "flash" in k]
                trace["flash_ms"] = sum(v["ms"] for v in flash)
                trace["flash_launches"] = sum(v["launches"] for v in flash)
                trace["by_name"] = dict(sorted(trace["by_name"].items(),
                                               key=lambda kv: -kv[1]["ms"])[:12])
            except Exception as exc:  # a diagnostic: report, do not fail
                trace = {"not measured": repr(exc)}
            rep[f"trace_{name}"] = trace
            print(f"  {name} trace: {json.dumps(trace)}")
        del caches

        # the same seed again: new weights, the same bits
        del params
        torch.cuda.empty_cache()
        params = M.init_params(a.seed, cfg, dtype=torch.float32, device="cuda")
        again = S.serve(params, cfg, cuda, prompts, batch=LM_BATCH, gen_len=LM_GEN,
                        keep_logits=True)
        same = (all(np.array_equal(x, y) for x, y in zip(res.done, again.done))
                and all(np.array_equal(x, y) for bx, by in zip(res.logits, again.logits)
                        for x, y in zip(bx, by)))
        rep["repeat_bitwise"] = same
        print(f"  same seed again: tokens and logits bitwise equal: {same}")
        if not same:
            raise AssertionError("the LM run does not repeat bitwise")
        del params
        torch.cuda.empty_cache()

    def lm_decode(self):
        """flash_decode on Qwen2.5-3B's real cache after lm_serve's prefill
        (each layer's q and cache, reshaped to the kernel's layout outside
        the counted run) against the model's cache attention; then against
        its plain version, timed at S=544 (that cache) and S=32768."""
        torch = self.torch
        from repro_torch.kernels.flash_attention import kernel as FK

        rep = self.report["lm_decode"] = {}
        if not self.lm_decode_calls:
            raise AssertionError("lm_serve recorded no decode step")
        with torch.inference_mode():
            cases = []
            for q, ck, cv, n, out in self.lm_decode_calls:
                B, _, H, hd = q.shape
                Smax, Hkv = ck.shape[1], ck.shape[2]
                lay = lambda c: c.permute(0, 2, 1, 3).reshape(B * Hkv, Smax, hd).contiguous()
                valid = (torch.arange(Smax, device=q.device) < n).expand(
                    B * Hkv, Smax).contiguous()
                cases.append((q.reshape(B * Hkv, H // Hkv, hd).contiguous(), lay(ck),
                              lay(cv), valid, out.reshape(B * Hkv, H // Hkv, hd)))
            FK.flash_decode.launches = FK.flash_decode.tc_launches = 0
            outs = [FK.flash_decode(*c[:4]) for c in cases]
            torch.cuda.synchronize()
            launches = FK.flash_decode.launches
            if launches != len(cases):
                raise AssertionError(f"flash_decode launches {launches} != "
                                     f"{len(cases)} layers")
            if FK.flash_decode.tc_launches != launches:
                raise AssertionError(f"{launches - FK.flash_decode.tc_launches} "
                                     f"flash_decode launches off the ring kernel")
            self.launches["flash_decode"] += launches
            tol = FLASH_TOL["bfloat16"]
            worst = 0.0
            for got, c in zip(outs, cases):
                a, b = got.float(), c[4].float()
                if got.dtype != c[0].dtype or not torch.isfinite(a).all():
                    raise AssertionError("flash_decode on the real cache: bad output")
                worst = max(worst, float((a - b).abs().max()))
                if not torch.allclose(a, b, rtol=tol, atol=tol):
                    raise AssertionError(f"flash_decode vs the model's cache "
                                         f"attention: max err {worst}")
            self.errs["flash_decode"] = max(self.errs["flash_decode"], worst)
            rep["real_cache"] = {"layers": len(cases), "launches": launches,
                                 "tc_launches": FK.flash_decode.tc_launches,
                                 "shape": list(cases[0][1].shape),
                                 "valid_len": self.lm_decode_calls[0][3],
                                 "max_abs_err_vs_model": worst, "tol": tol}
            print(f"  real cache: {json.dumps(rep['real_cache'])}")
            self.decode_checks_and_timing(FK, cases[0], rep)
        self.lm_decode_calls = None

    def decode_checks_and_timing(self, FK, real, rep):
        """The kernel against its plain version (f32, bf16; ragged rows and
        an all-invalid row at S=32768), timed at S=544 (the real cache's
        layer 0) and S=32768 beside its bound and one SDPA call."""
        import numpy as np
        torch = self.torch
        B, Hkv, D = DECODE_B, DECODE_HKV, DECODE_D
        G, BH = DECODE_HQ // Hkv, DECODE_B * DECODE_HKV
        gen = torch.Generator(device="cuda")
        gen.manual_seed(self.args.seed)
        rng = np.random.default_rng(self.args.seed)
        lens = rng.integers(1, DECODE_LONG + 1, B)
        lens[1] = 0  # an all-invalid batch row
        valid = (torch.arange(DECODE_LONG, device="cuda")[None, :]
                 < torch.from_numpy(np.repeat(lens, Hkv)).cuda()[:, None])
        mk = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
        synth = {dt: (mk(BH, G, D).to(dt), mk(BH, DECODE_LONG, D).to(dt),
                      mk(BH, DECODE_LONG, D).to(dt), valid)
                 for dt in (torch.float32, torch.bfloat16)}
        rep["checks"] = []
        where = f"S={DECODE_LONG} ragged"
        lib = FK.library("flash_decode")
        rep["ring_ctas_per_sm"] = {D: lib.flash_decode_ring_ctas_per_sm(D)
                                   for D in FK.DECODE_TC_HEAD_DIMS}
        print(f"  ring kernel, CTAs an SM by head dim: {rep['ring_ctas_per_sm']}")
        for dt, x in synth.items():
            out = FK.flash_decode(*x)
            got, want = out.float(), FK.flash_decode_plain(*x).float()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            tol = FLASH_TOL[str(dt).split(".")[1]]
            # the outputs average thousands of random values (about 0.01):
            # scale bf16's atol to them, else an all-zero output would pass
            atol = tol if dt == torch.float32 else tol * float(want.abs().max())
            top = BF16_TOP_ULPS * float(want.abs().max())
            self.errs["flash_decode"] = max(self.errs["flash_decode"], err)
            rep["checks"].append({"dtype": str(dt), "where": where, "max_abs_err": err,
                                  "rtol": tol, "atol": atol, "top_ulps_bound": top})
            if not torch.isfinite(got).all() or not torch.allclose(got, want, rtol=tol,
                                                                   atol=atol):
                raise AssertionError(f"flash_decode {dt} {where}: max err {err}")
            if dt == torch.bfloat16 and err > top:
                raise AssertionError(f"flash_decode {dt} {where}: max err {err} "
                                     f"beyond 2^-6 x max |plain| = {top}")
            if got[Hkv:2 * Hkv].any():
                raise AssertionError("flash_decode: an all-invalid row is not 0")
            if not all(torch.equal(out, FK.flash_decode(*x)) for _ in range(3)):
                raise AssertionError(f"flash_decode {dt}: not bitwise the same on repeat")
        # one device kernel a call (the splits merged in the same launch)
        x = synth[torch.bfloat16]
        try:
            trace, _ = device_trace(
                torch, lambda: [FK.flash_decode(*x) for _ in range(10)],
                Path(self.args.out).parent / "trace_flash_decode.json")
            rep["kernels_per_call"] = trace["device_events"] / 10
        except Exception as exc:  # a diagnostic: report, do not fail
            rep["kernels_per_call"] = f"not measured: {exc!r}"
        print(f"  device kernels a flash_decode call: {rep['kernels_per_call']}")
        if isinstance(rep["kernels_per_call"], float) and rep["kernels_per_call"] != 1.0:
            raise AssertionError(f"flash_decode: {rep['kernels_per_call']} kernels a call")
        sdpa = torch.nn.functional.scaled_dot_product_attention
        for label, (q, k, v, vd) in ((f"S={real[1].shape[1]}", real[:4]),
                                     (f"S={DECODE_LONG}", synth[torch.bfloat16])):
            S = k.shape[1]
            qs = q.view(B, Hkv * G, 1, D)
            ks, vs = k.view(B, Hkv, S, D), v.view(B, Hkv, S, D)
            mask = vd.view(B, Hkv, 1, 1, S).expand(B, Hkv, G, 1, S).reshape(B, Hkv * G, 1, S)
            n_valid = int(vd.sum())
            nbytes = 2 * (2 * q.numel() + 2 * n_valid * D) + vd.numel()
            flops = 4 * G * D * n_valid
            bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                     "operations": flops / BF16_FLOPS_PER_S * 1e3}
            by = max(bound, key=bound.get)
            d = dict(
                ms=self.timed(lambda: FK.flash_decode(q, k, v, vd), 50),
                plain_ms=self.timed(lambda: FK.flash_decode_plain(q, k, v, vd), 10),
                library_ms=self.timed(lambda: sdpa(qs, ks, vs, attn_mask=mask,
                                                   enable_gqa=True), 50),
                bound_ms=bound[by], bound_by=by, bytes=nbytes, flops=flops,
                valid_slots=n_valid, splits=FK.decode_splits(S, BH, D)[0])
            self.entry_timings[f"flash_decode {label}"] = d
            rep[label] = d
            print(f"  flash_decode BHkv={BH} G={G} D={D} {label} bf16: {json.dumps(d)}")

    def sentinel(self):
        """ell_update(variant="sentinel") on the main path's first batch
        (shards 0-3) with PageRank's first messages, each combine: bitwise
        the masked update; its kernel against its plain version and the
        masked kernel, timed beside the masked kernel and its bound."""
        import numpy as np
        torch = self.torch
        from repro_torch.core import ShardStore, ell_to_device
        from repro_torch.kernels.spmv_ell import kernel as K
        from repro_torch.kernels.spmv_ell import ops

        dev = torch.device("cuda")
        store = ShardStore(self.root)
        meta = store.read_meta()
        shards = [ell_to_device(store.load_shard(p, "ell"), dev) for p in range(4)]
        first = shards[0]
        W, tr, pad = first.window, first.tr, ops.SENTINEL_PAD
        planes = [d.sentinel_idx() for d in shards]  # built once, as the path keeps it
        tws = [d.tile_window for d in shards]
        deg = meta.out_deg.astype(np.float64)
        x = np.where(deg > 0, 1.0 / (meta.num_vertices * np.maximum(deg, 1)), 0.0)
        msgs = ops.stage_messages(x.astype(np.float32), first.num_windows * W, dev)
        torch.cuda.synchronize()
        K.ell_partials_sentinel.launches = 0
        acc = {c: ops.ell_update_batched(shards, msgs, c, variant="sentinel")
               for c in COMBINES}
        torch.cuda.synchronize()
        launches = K.ell_partials_sentinel.launches
        if launches != len(COMBINES):
            raise AssertionError(f"sentinel launches {launches} != {len(COMBINES)}")
        self.launches["ell_partials_sentinel"] += launches
        rep = self.report["sentinel"] = {"launches": launches}
        for c in COMBINES:
            masked = ops.ell_update_batched(shards, msgs, c)
            table = ops.extend_windows(msgs, W, c)
            part = K.ell_partials_sentinel(planes, tws, table, window=W + pad, tr=tr,
                                           combine=c)
            plain = K.ell_partials_sentinel_plain(planes, tws, table, window=W + pad,
                                                  tr=tr, combine=c)
            # PageRank's messages are below 2^-21, so a fixed atol would hold
            # nothing: scale it to the data (min/max are held bitwise)
            atol = SUM_RTOL * float(plain.abs().max()) if c == "sum" else 0.0
            self.compare("ell_partials_sentinel", part, plain, c, "main batch", atol)
            self.compare("ell_partials_sentinel", acc[c], K.segment_combine_plain(
                plain, [d.perm for d in shards], [d.row_ptr for d in shards], c),
                c, "update vs plain", atol)
            mpart = K.ell_partials_masked([d.idx for d in shards],
                                          [d.mask for d in shards], tws, msgs,
                                          window=W, tr=tr, combine=c)
            # one templated body: the same slots in the same order
            if not (torch.equal(part, mpart) and torch.equal(acc[c], masked)):
                raise AssertionError(f"sentinel {c} is not bitwise the masked update")
            if c == "sum":
                rep["sum_atol"] = atol
        print(f"  sentinel == masked (partials and update) bitwise for "
              f"{', '.join(COMBINES)}; against the plain version min/max bitwise, "
              f"sum within rtol {SUM_RTOL}, atol {rep['sum_atol']:.3g}")
        table = ops.extend_windows(msgs, W, "sum")
        kw = dict(window=W + pad, tr=tr, combine="sum")
        mkw = dict(window=W, tr=tr, combine="sum")
        masks = [d.mask for d in shards]
        idxs = [d.idx for d in shards]
        plane_bytes = sum(p.numel() * p.element_size() for p in planes)
        nbytes = self.sentinel_bytes(torch, planes, masks, tws, W, pad, tr)
        d = dict(
            ms=self.timed(lambda: K.ell_partials_sentinel(planes, tws, table, **kw), 20),
            plain_ms=self.timed(lambda: K.ell_partials_sentinel_plain(
                planes, tws, table, **kw), 3),
            library_ms=None, bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes", plane_bytes=plane_bytes,
            plane_dtype=str(planes[0].dtype),
            masked_ms=self.timed(lambda: K.ell_partials_masked(
                idxs, masks, tws, msgs, **mkw), 20),
            masked_bound_ms=self.partials_bytes(torch, idxs, masks, tws, W, tr)
            / HBM_BYTES_PER_S * 1e3,
            staging_ms=self.timed(lambda: ops.extend_windows(msgs, W, "sum"), 20))
        self.entry_timings["ell_partials_sentinel"] = d
        rep["timing"] = d
        print(f"  ell_partials_sentinel (shards 0-3, sum): {json.dumps(d)}")

    @staticmethod
    def sentinel_bytes(torch, planes, masks, tws, window, pad, tr):
        """Bytes the sentinel partials must move on this data: the whole
        index plane, the 32 B message sectors its slots gather in the
        extended table (the valid slots' and the identity sector of each
        window with a padding slot), tile_window and 4 B out per row."""
        ext = window + pad
        total, sectors = 0, []
        for plane, mask, tw in zip(planes, masks, tws):
            total += plane.numel() * plane.element_size() + 4 * tw.numel() + 4 * plane.shape[0]
            r, c = mask.nonzero(as_tuple=True)
            sectors.append((tw.long()[r // tr] * ext + plane[r, c].long()) // 8)
            padded = (~mask.all(dim=1)).nonzero(as_tuple=True)[0]
            sectors.append((tw.long()[padded // tr] * ext + window) // 8)
        return total + 32 * torch.unique(torch.cat(sectors)).numel()

    def bloom(self):
        """Shard filters (BloomFilter32 over each shard's exact sources, as
        the scheduler keeps them) against random active sets and every
        vertex: contains and any_active_shards bitwise against the host
        filters, no truly active shard skipped; timed at every vertex."""
        import numpy as np
        torch = self.torch
        from repro_torch.core import ShardStore, VSWEngine
        from repro_torch.core.bloom import BloomFilter32
        from repro_torch.kernels.bloom import kernel as BK
        from repro_torch.kernels.bloom import ops as bops

        if self.serve_engine is not None:
            exact = self.serve_engine.scheduler.exact_sources
        else:  # the scheduler scans the store when an engine opens
            with VSWEngine.from_store(self.root, backend="cuda", device="cuda",
                                      cache_bytes=0) as eng:
                exact = eng.scheduler.exact_sources
        nv = ShardStore(self.root).read_meta().num_vertices
        t0 = time.perf_counter()
        filters = [BloomFilter32.build(e) for e in exact]
        build_s = time.perf_counter() - t0
        rng = np.random.default_rng(self.args.seed)
        sets = {n: rng.choice(nv, n, replace=False).astype(np.int32) for n in BLOOM_SETS}
        sets[nv] = np.arange(nv, dtype=np.int32)  # PageRank's first iteration
        torch.cuda.synchronize()
        BK.bloom_contains.launches = 0
        got = {n: ([bops.contains(f, ids) for f in filters],
                   bops.any_active_shards(filters, ids)) for n, ids in sets.items()}
        launches = BK.bloom_contains.launches
        want_launches = len(sets) * (len(filters) + -(-len(filters) // BK.MAX_FILTERS))
        if launches != want_launches:
            raise AssertionError(f"bloom launches {launches} != {want_launches}")
        self.launches["bloom_contains"] += launches
        rep = self.report["bloom"] = {
            "filters": len(filters), "build_s": build_s, "launches": launches,
            "items": [int(f.n_items) for f in filters],
            "table_bytes": [int(f.words.nbytes) for f in filters], "sets": {}}
        for n, ids in sets.items():
            bits, active = got[n]
            for f, b in zip(filters, bits):
                if not np.array_equal(b, f.contains(ids)):
                    raise AssertionError(f"bloom contains n={n}: not the host filter's")
            host = np.array([f.any_member(ids) for f in filters])
            truly = np.array([np.isin(ids, e).any() for e in exact])
            if not np.array_equal(active, host):
                raise AssertionError(f"any_active_shards n={n}: {active} != host {host}")
            if (truly & ~active).any():
                raise AssertionError(f"any_active_shards n={n}: a truly active shard "
                                     f"reported inactive")
            rep["sets"][n] = {"active": int(active.sum()), "truly_active": int(truly.sum()),
                              "member_share": float(np.mean([b.mean() for b in bits]))}
        print(f"  {len(filters)} filters ({sum(rep['table_bytes'])} B) built in "
              f"{build_s:.1f} s; launches {launches}; {json.dumps(rep['sets'])}")
        staged = bops.stage_filters(filters, "cuda")
        items = torch.from_numpy(sets[nv]).cuda()
        kw = dict(num_bits=staged.num_bits, num_hashes=staged.num_hashes)
        out = BK.bloom_contains(staged.words, items, reduce_any=True, **kw)
        self.errs["bloom_contains"] = float(
            (out != BK.bloom_contains_plain(staged.words, items, reduce_any=True,
                                            **kw)).sum())
        if self.errs["bloom_contains"]:
            raise AssertionError("bloom kernel != plain version")
        nbytes, ops_n, probes, scanned = self.bloom_work(torch, staged, items)
        bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                 "operations": ops_n / F32_OPS_PER_S * 1e3}
        by = max(bound, key=bound.get)
        d = dict(
            ms=self.timed(lambda: BK.bloom_contains(staged.words, items,
                                                    reduce_any=True, **kw), 20),
            plain_ms=self.timed(lambda: BK.bloom_contains_plain(
                staged.words, items, reduce_any=True, **kw), 3),
            library_ms=None, bound_ms=bound[by], bound_by=by, bytes=nbytes,
            operations=ops_n, probes=probes, ids_scanned=scanned,
            contains_one_filter_ms=self.timed(lambda: BK.bloom_contains(
                staged.words[0], items, num_bits=staged.num_bits[0],
                num_hashes=staged.num_hashes[0]), 20))
        # the other extreme: empty tables of the same sizes, so no filter is
        # ever hit and the scan reads every id against every filter
        empty = [torch.zeros(w.numel(), dtype=torch.int32, device=w.device)
                 for w in staged.words]
        if BK.bloom_contains(empty, items, reduce_any=True, **kw).any():
            raise AssertionError("bloom any: an empty filter reported hit")
        e_bytes, e_ops, _, _ = self.bloom_work(torch, bops.DeviceFilters(
            empty, staged.num_bits, staged.num_hashes), items)
        d["full_scan_ms"] = self.timed(lambda: BK.bloom_contains(
            empty, items, reduce_any=True, **kw), 20)
        d["full_scan_bound_ms"] = max(e_bytes / HBM_BYTES_PER_S,
                                      e_ops / F32_OPS_PER_S) * 1e3
        self.entry_timings["bloom_contains any"] = d
        rep["timing"] = d
        print(f"  bloom_contains any, {len(filters)} filters, n={nv}: {json.dumps(d)}")

    @staticmethod
    def bloom_work(torch, staged, items):
        """What the any-reduction needs on this data: an in-order scan of
        the ids may stop at the id that gives the last filter its first hit
        (it reads every id when some filter has none), and probes each
        filter, up to each id's first clear bit, only until that filter's
        own first hit.  Returns bytes (the ids scanned, each touched 32 B
        word sector once, one flag a filter), integer operations (8 to hash
        an id, 6 a probe), the probes and the ids scanned."""
        from repro_torch.kernels.bloom.ref import (bloom_contains_ref, hash2_u32,
                                                   words_as_int64)

        filters = list(zip(staged.words, staged.num_bits, staged.num_hashes))
        n, upto = items.numel(), []  # ids each filter is probed at
        for w, nb, nh in filters:
            first = bloom_contains_ref(w, items, num_bits=nb, num_hashes=nh).nonzero()
            upto.append(int(first[0, 0]) + 1 if first.numel() else n)
        scanned = max(upto)
        h1, h2 = hash2_u32(items[:scanned])
        nbytes, probes = 4 * scanned + len(filters), 0
        for (w, nb, nh), m in zip(filters, upto):
            table = words_as_int64(w)
            live = torch.arange(m, device=items.device)
            sectors = []
            for i in range(nh):  # the ids whose probes so far all hit
                pos = (h1[live] + i * h2[live]) & (nb - 1)
                probes += pos.numel()
                sectors.append(torch.unique(pos >> 8))  # 256 bits = one 32 B sector
                live = live[((table[pos >> 5] >> (pos & 31)) & 1) != 0]
            nbytes += 32 * torch.unique(torch.cat(sectors)).numel()
        return nbytes, 8 * scanned + 6 * probes, probes, scanned

    @staticmethod
    def lane_partials_bytes(torch, idxs, masks, tws, window, tr, n_lanes):
        """Bytes the lane partials must move on this data: the mask plane
        and the idx sectors of valid slots once (not once a lane), the
        whole 32 B sectors of each distinct gathered source's L lanes in
        the vertex-major table, tile_window, the lane ids and L floats out
        per ELL row."""
        total, srcs = 4 * n_lanes, []
        for idx, mask, tw in zip(idxs, masks, tws):
            n_ell, k = idx.shape
            total += mask.numel() + 4 * tw.numel() + 4 * n_lanes * n_ell
            r, c = mask.nonzero(as_tuple=True)
            byte = (r * k + c) * idx.element_size()
            total += 32 * torch.unique(byte // 32).numel()
            col = idx[r, c].long().clamp_(0, window - 1)
            srcs.append(tw.long()[r // tr] * window + col)
        run = -(-4 * n_lanes // 32) * 32
        return total + run * torch.unique(torch.cat(srcs)).numel()


def spread_of(ms):
    """Median, quartiles and extremes of a list of times."""
    import numpy as np

    q = np.percentile(ms, [0, 25, 50, 75, 100])
    return {"reps": len(ms), "median": float(q[2]), "p25": float(q[1]),
            "p75": float(q[3]), "min": float(q[0]), "max": float(q[4])}


def settle(svc, sweeps0, timeout=120.0):
    """Fusion sets the service finished since it had finished ``sweeps0``.
    A query's future resolves inside its sweep, before the sweep books its
    stats, so this waits (up to ``timeout``) for the first one to book."""
    deadline = time.monotonic() + timeout
    while svc.stats()["sweeps"] == sweeps0 and time.monotonic() < deadline:
        time.sleep(0.005)
    return svc.stats()["sweeps"] - sweeps0


def record_cache_attention(run):
    """Run ``run()`` with the model's cache attention recorded: for each
    call (one a layer of a decode step) copies of its q, k/v caches, the
    valid length and the output."""
    from repro_torch.models import attention as A

    calls, inner = [], A._attend_with_cache

    def recorded(q, ck, cv, valid_len):
        out = inner(q, ck, cv, valid_len)
        calls.append((q.clone(), ck.clone(), cv.clone(), int(valid_len), out.clone()))
        return out

    A._attend_with_cache = recorded
    try:
        run()
    finally:
        A._attend_with_cache = inner
    return calls


def device_trace(torch, run, trace_path):
    """Run ``run()`` under torch.profiler and read the exported trace: per
    device kernel name, launches and ms; the union of device activity
    over the host wall time of ``run``.  ``run`` returns what it wants
    kept."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        kept = run()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(Path(trace_path).read_text()).get("traceEvents", [])
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")]
    by_name = {}
    for e in dev:
        d = by_name.setdefault(e["name"][:80], {"launches": 0, "ms": 0.0})
        d["launches"] += 1
        d["ms"] += e["dur"] / 1e3
    busy, end = 0.0, float("-inf")
    for ts, dur in sorted((e["ts"], e["dur"]) for e in dev):
        busy += max(0.0, ts + dur - max(ts, end))
        end = max(end, ts + dur)
    return {"wall_s": wall, "device_busy_s": busy / 1e6,
            "busy_share": busy / 1e6 / wall if dev else None,
            "device_events": len(dev), "by_name": by_name}, kept


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core  # noqa: F401  (fails outside a checkout)

    # f32 products in full f32: the plain versions are the references
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    smoke = Smoke(torch, args)
    t_all = time.perf_counter()
    smoke.phase("build", smoke.build)
    if not smoke.failures:
        smoke.phase("kernels", smoke.kernel_checks)
        smoke.phase("lm_kernels", smoke.lm_kernels)
        smoke.phase("lm_serve", smoke.lm_serve)
        smoke.phase("lm_decode", smoke.lm_decode)
        smoke.phase("small_engine", smoke.small_engine)
        smoke.phase("main", smoke.main_path)
        if "main" not in smoke.failures:
            smoke.phase("serve", smoke.serve)
            smoke.phase("timing", smoke.timing)
            smoke.phase("sentinel", smoke.sentinel)
            smoke.phase("bloom", smoke.bloom)
            smoke.phase("trace", smoke.trace)
    if smoke.serve_engine is not None:
        smoke.serve_engine.close()
    smoke.report["total_s"] = time.perf_counter() - t_all
    smoke.report["card"] = card
    if getattr(smoke, "tmp", None) is not None:
        smoke.tmp.cleanup()
    if not card:
        smoke.failures.append("nvidia-smi")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(smoke.report, indent=1, default=str))
    if smoke.failures:
        print(f"chip_smoke: FAILED phases {smoke.failures}", file=sys.stderr)
        return 1
    kernels = []
    timings = {**smoke.timings, **smoke.lm_timings, **smoke.entry_timings}
    for name, (rep, shape, source) in KERNELS.items():
        d = timings[name + shape]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": rep,
            "launches": smoke.launches[name],
            "max_abs_err": smoke.errs[name], "ms": d["ms"],
            "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
            "bound_by": d.get("bound_by", "bytes"), "library_ms": d["library_ms"]})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
