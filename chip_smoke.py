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
            operation a call (the nodes of a CUDA graph of one call); and
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
            from the store; a ``torch`` backend service agrees on those 4
            (BFS/SSSP bitwise, PPR within rtol=1e-4, atol=1e-9).  Launch counters
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
            one device operation a call (the nodes of a CUDA graph of one
            call); over 16 empty tables of the same sizes, where it must
            scan every id against every filter; hit and no-hit calls in
            turn on one stream; and contains on one filter at each set
            size beside its bound (ids, touched sectors and bytes out, or
            its operations).
11. trace   (diagnostic: a profiler error leaves "not measured" and does
            not fail the run) one resident PageRank run of 3 iterations and
            one resident fusion set of 32 queries (max_iters=5) under
            torch.profiler: each kernel's device time as the engine
            launches it, beside the engine's kernel_s, and the card's busy
            share of the run.
12. ingest  the main phase's graph written as a binary edge file
            (``write_edge_file``, 8 B an edge) and stream-ingested
            (``ShardStore.ingest``, the default 64 MiB spill budget, one
            finalize worker) into a second store by a child process: every
            shard container and ``vertexinfo.npz`` byte-identical (SHA-256)
            to the main phase's store, ``property.json`` the same but for
            the ELL block that only ingest writes; the pass-1, pass-2 and
            finalize seconds (trace spans), ``IngestStats`` and the child's
            peak RSS are recorded.  npz members carry their write time, so
            the script pins the zip clock for every store it writes.
13. delta   live mutations on the ingested copy: a resident ``cuda``
            ``GraphService`` (batch_shards=4, max_lanes=16, max_groups=2)
            answers 16 BFS/SSSP/WCC/PPR queries (max_iters=3; version 0),
            then two batches of 2^15 uniform inserts and 2^13 deletes of
            existing edges publish through ``apply_updates`` (versions 1
            and 2, every shard touched); at each version the queries are asked
            again under the tracer: no dirty shard is served from the
            resident map (``shard.load`` spans), at least one answer moved,
            two queries (BFS and SSSP at version 1, WCC and PPR at version
            2) are bitwise a solo non-resident ``cuda`` ``VSWEngine`` opened
            after the publish, and at version 1 a ``torch`` service agrees
            (BFS/SSSP/WCC bitwise, PPR within rtol=1e-4, atol=1e-9).
            ``compact()`` leaves no dirty shard; after ``bump_graph_version``
            the queries are bitwise version 2's and each shard is read from
            the store once, every other load served resident.
            Shard 0 and shard P/2 after compaction are byte-identical to
            ``encode_shard`` of a from-scratch build of the mutated edge
            list on the same intervals.  Then ``save_warm_state``, close, and
            a warm boot: every shard's sources restored, no shard read by the
            filter build, a repeated query answered from the session cache
            bitwise, a new query bitwise the cold service's.  Publish,
            sweep, compaction and boot seconds are recorded (host work on
            the card's machine: dirty shards decode on the host).
14. pulse   the load harness on the ingested copy (after ``delta``): a
            resident ``cuda`` ``GraphService`` (batch_shards=4, max_lanes=16,
            max_groups=2, no session cache) with the telemetry ticker
            (0.5 s windows) and three SLOs (latency p99 under 60 s, budget
            0.01; admission errors, 0.05; queue-wait share, 0.95) answers
            ``benchmarks/bench_graphmp.py``'s fig_qps mix (BFS weight 2,
            SSSP, WCC, PPR at damping 0.85; max_iters=4, cut from 6; seed
            29).  A closed loop (8 workers, submit_batch chunks of 4, 64
            ops, 16 of them warm-up, no mutations): every record bitwise a solo
            resident ``cuda`` ``VSWEngine``.  An open loop under the tracer
            (Poisson arrivals at half the closed loop's rate, 24 ops, 4
            warm-up, 16 random inserts after every 12th op): each record at
            the pre-stream version bitwise that solo engine; at the last
            published version, per program the record with the fewest
            iterations (within 40 s) bitwise a solo non-resident ``cuda``
            engine opened after the drain (the stream's last batch rides
            the last op, so when no record came after it the fewest-
            iteration op is asked once more); no shard an insert touched
            served from the resident map after its publish (``shard.load``
            spans).  Then no conservation violation, an ``slo`` block with
            no admission-error violation in the closed loop, the Prometheus
            text equal to the registry's values, and every retained window
            through JSONL and back; the lane kernels launched.  Qps,
            latency and queue-wait percentiles, iterations an op, burn
            rates and window counts are recorded; the trace goes to
            ``chiprun_out/trace_pulse.json``.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
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
#: the lane combine's warp a row in chunks of 8 lanes; the single-lane
#: combine's warp a row; the Bloom kernel's thread an id (bits) and its
#: three-operation "any" call, as redesigned since
EARLIER_MS = {"ell_partials_lanes L=16": 1.0867, "ell_partials_lanes L=32": 1.9869,
              "ell_partials_ragged L=16": 1.1250, "ell_partials_ragged L=32": 2.0670,
              "ell_partials_masked": 0.1973,
              "segment_combine_lanes L=16": 0.1253, "segment_combine_lanes L=32": 0.2334,
              "segment_combine": 0.02301, "bloom_contains any": 0.0206,
              "bloom_contains any full scan": 0.2825,
              f"bloom_contains n={1 << 21}": 0.0351}
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
#: npz members carry their write time; every store this script writes gets
#: this one, so two stores of the same graph can be compared byte for byte
ZIP_CLOCK = 1_700_000_000.0
DELTA_PROGS = ("bfs", "sssp", "wcc", "ppr")
DELTA_QUERIES = 16  # 4 a program
#: cut from 5: every dirty sweep iteration decodes all 16 shards on the
#: host (about 4 s on the H100's machine), and at 5 the phase took 400 s
#: of the smoke's time limit
DELTA_ITERS = 3
DELTA_INSERTS, DELTA_DELETES = 1 << 15, 1 << 13  # a batch; two batches
DELTA_PREFETCH = 8  # loader threads: dirty shards decode on the host
#: the pulse phase's mix is benchmarks/bench_graphmp.py's fig_qps (seed 29);
#: max_iters cut from its 6: a fusion set formed with one query keeps one
#: lane, so the open loop's queries after a publish ride dirty iterations
#: (about 2.3 s each on the H100's machine) one at a time, and at 6 the
#: phase took 155 s of its 150 s
PULSE_SEED, PULSE_ITERS = 29, 4
PULSE_SOLO_BUDGET_S = 40.0  # non-resident solo runs at the last version


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--vertices", type=int, default=1 << 21)
    ap.add_argument("--edges", type=int, default=1 << 25)
    ap.add_argument("--shards", type=int, default=16)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "chip_smoke.json"))
    ap.add_argument("--ingest-child", nargs=2, metavar=("EDGES", "ROOT"),
                    help=argparse.SUPPRESS)  # the ingest phase's child process
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

        # the torch cross-check at the from-store run's depth (cut from the
        # 32 queries at SERVE_ITERS, about 45 s, to pay for the pulse phase)
        with GraphService.from_store(self.root, backend="torch", device_resident=True,
                                     **eng_kw, **common) as torch_svc:
            ref = drive("torch ragged resident", torch_svc, short, 3, True)
        worst = 0.0
        for (p, v), x, y in zip(short, from_store, ref):
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

    # ------------------------------------------------- ingest and delta
    def ingest(self):
        """The main phase's graph through the streamed external build, in a
        child process: see the module docstring."""
        import numpy as np
        from repro_torch.core import rmat_graph, write_edge_file

        a = self.args
        t0 = time.perf_counter()
        g = rmat_graph(a.vertices, a.edges, seed=a.seed)
        self.graph = (g.src, g.dst)
        edges = self.tmp.name + "/edges.bin"
        nbytes = write_edge_file(edges, g.src, g.dst)
        write_s = time.perf_counter() - t0
        del g
        root = self.tmp.name + "/ingested"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--shards",
             str(a.shards), "--vertices", str(a.vertices), "--ingest-child",
             edges, root],
            capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"ingest child failed ({proc.returncode}):\n"
                                 f"{proc.stderr[-3000:]}")
        child = json.loads(proc.stdout.strip().splitlines()[-1])
        Path(edges).unlink()
        same, differ = [], []
        for f in sorted(p.name for p in Path(self.root).iterdir()):
            if f == "property.json":
                continue
            (same if sha256_of(Path(self.root, f)) == sha256_of(Path(root, f))
             else differ).append(f)
        if differ or sorted(p.name for p in Path(root).iterdir()) != sorted(
                p.name for p in Path(self.root).iterdir()):
            raise AssertionError(f"ingested store differs from the preprocess "
                                 f"store: {differ[:5]}")
        want = json.loads(Path(self.root, "property.json").read_text())
        got = json.loads(Path(root, "property.json").read_text())
        ell = got.pop("ell", None)
        if got != want or ell != {"window": 1 << 14, "k": 128, "tr": 8}:
            raise AssertionError(f"property.json: {got} {ell} != {want}")
        self.ingest_root = root
        rep = self.report["ingest"] = {
            "edge_file_bytes": nbytes, "generate_and_write_s": write_s,
            "child_wall_s": wall, "files_sha256_equal": len(same),
            "preprocess_s": self.report["main"]["preprocess_s"], **child}
        print(f"  edge file {nbytes} B ({write_s:.1f} s with the graph); ingest "
              f"child {wall:.1f} s: pass 1 {child['pass1_s']:.2f} s, pass 2 "
              f"{child['pass2_s']:.2f} s, finalize {child['finalize_s']:.2f} s, "
              f"peak RSS {child['peak_rss_bytes']} B, {child['rss_before_bytes']} "
              f"B before the ingest (None: not measured); main phase's "
              f"preprocess {rep['preprocess_s']:.1f} s")
        print(f"  stats {json.dumps(child['stats'])}")
        print(f"  {len(same)} files SHA-256 equal to the preprocess store; "
              f"property.json equal but for its ELL block {ell}")

    def delta(self):
        """Live mutations, compaction and a warm restart on the ingested
        copy: see the module docstring."""
        import numpy as np
        torch = self.torch
        from repro_torch.core import ShardStore, VSWEngine, apps
        from repro_torch.core.graph import Graph
        from repro_torch.core.sharding import build_shards
        from repro_torch.kernels.spmv_ell import kernel as K
        from repro_torch.obs import trace
        from repro_torch.obs.trace import Tracer
        from repro_torch.serve import GraphService

        a = self.args
        root = self.ingest_root
        meta = ShardStore(root).read_meta()
        P = meta.num_shards
        rng = np.random.default_rng(a.seed + 2)
        srcs = rng.choice(np.flatnonzero(meta.out_deg > 0), size=DELTA_QUERIES,
                          replace=False)
        queries = [(DELTA_PROGS[i % 4], int(v)) for i, v in enumerate(srcs)]
        new_query = ("sssp", int(rng.choice(np.flatnonzero(meta.out_deg > 0))))
        # one query a program over the two versions (cut from one a program
        # at each version, about 47 s, to pay for the pulse phase)
        solo_at = {1: [0, 1], 2: [2, 3]}
        svc_kw = dict(device="cuda", device_resident=True, batch_shards=4,
                      max_lanes=16, max_groups=2, prefetch_depth=DELTA_PREFETCH)
        f = lambda v: np.nan_to_num(v, posinf=1e30)
        rep = self.report["delta"] = {"queries": queries, "versions": {}}
        lane_k = ("ell_partials_ragged", "segment_combine_lanes")

        def ask(svc, label, traced=False):
            for n in lane_k:
                getattr(K, n).launches = 0
            sweeps0 = svc.stats()["sweeps"]
            tracer = Tracer() if traced else None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with trace.tracing(tracer) if traced else contextlib.nullcontext():
                with svc.submit_batch():
                    futs = [svc.submit(p, v, max_iters=DELTA_ITERS)
                            for p, v in queries]
                res = [fu.result(timeout=1200) for fu in futs]
                settle(svc, sweeps0)
            wall = time.perf_counter() - t0
            st = svc.last_sweep_stats
            loads = ([e["args"] for e in tracer.export_chrome()["traceEvents"]
                      if e.get("name") == "shard.load"] if traced else [])
            d = {"wall_s": wall, "iterations": len(st),
                 "iter_time_s": [i.time_s for i in st],
                 "load_wait_s": [i.load_wait_s for i in st],
                 "launches": {n: getattr(K, n).launches for n in lane_k},
                 "cached": sum(r.cached for r in res)}
            if traced:
                d["loads"] = {"total": len(loads),
                              "logical": sum(x["logical"] for x in loads),
                              "resident": sum(x["from_resident"] for x in loads)}
            print(f"  {label}: {len(res)} queries in {wall:.2f} s, "
                  f"{len(st)} iterations {[round(t, 3) for t in d['iter_time_s']]}"
                  f" s, launches {d['launches']}"
                  + (f", loads {d['loads']}" if traced else ""))
            return res, d, loads

        def same(xs, ys, label, ppr_tol=False):
            for (p, v), x, y in zip(queries, xs, ys):
                if ppr_tol and p == "ppr":
                    if not np.allclose(x.values, y.values, rtol=PR_RTOL,
                                       atol=PR_ATOL):
                        raise AssertionError(f"{label} {p} {v}: max err "
                                             f"{np.abs(x.values - y.values).max()}")
                elif not np.array_equal(f(x.values), f(y.values)):
                    raise AssertionError(f"{label} {p} {v}: not bitwise equal")

        t0 = time.perf_counter()
        svc = GraphService.from_store(root, backend="cuda", **svc_kw)
        rep["cold_boot_s"] = time.perf_counter() - t0
        rep["cold_boot_reads"] = svc.engine.loading_io.reads
        print(f"  cold boot {rep['cold_boot_s']:.2f} s "
              f"({svc.engine.loading_io.reads} reads)")
        try:
            v0, d, _ = ask(svc, "version 0")
            rep["versions"][0] = d
            cur_src, cur_dst = self.graph
            answers = {0: v0}
            for version in (1, 2):
                ins = (rng.integers(0, meta.num_vertices, DELTA_INSERTS),
                       rng.integers(0, meta.num_vertices, DELTA_INSERTS))
                take = rng.choice(len(cur_src), DELTA_DELETES, replace=False)
                dels = (cur_src[take], cur_dst[take])
                cur_src, cur_dst = mutate(cur_src, cur_dst, ins, dels)
                t0 = time.perf_counter()
                upd = svc.apply_updates(inserts=ins, deletes=dels).result(
                    timeout=1200)
                publish_s = time.perf_counter() - t0
                if upd.graph_version != version or len(upd.shards_touched) != P:
                    raise AssertionError(f"publish {version}: {upd}")
                dirty = set(upd.shards_touched)
                res, d, loads = ask(svc, f"version {version}", traced=True)
                bad = [x for x in loads if x["shard"] in dirty
                       and (x["from_resident"] or not x["logical"])]
                if bad or not loads:
                    raise AssertionError(f"version {version}: a dirty shard not "
                                         f"decoded through the overlay: {bad[:3]}")
                if set(svc.engine._device_shards) & dirty:
                    raise AssertionError("a dirty shard's decode was kept resident")
                if d["launches"]["ell_partials_ragged"] == 0:
                    raise AssertionError("the mutated graph ran no ragged kernel")
                if all(np.array_equal(f(x.values), f(y.values))
                       for x, y in zip(res, answers[0])):
                    raise AssertionError(f"version {version}: no answer moved")
                t0 = time.perf_counter()
                K.ell_partials_masked.launches = 0
                with VSWEngine.from_store(root, backend="cuda", device="cuda",
                                          device_resident=False, batch_shards=4,
                                          prefetch_depth=DELTA_PREFETCH) as solo:
                    if solo.store.delta.version != version:
                        raise AssertionError("solo engine opened another version")
                    for i in solo_at[version]:
                        p, v = queries[i]
                        kw = {} if p == "wcc" else {"source": v}
                        want = solo.run(apps.get_program(p, **kw),
                                        max_iters=DELTA_ITERS)
                        qr = res[i]
                        if not (np.array_equal(f(qr.values), f(want.values))
                                and qr.iterations == want.num_iterations
                                and qr.converged == want.converged):
                            raise AssertionError(f"version {version} {p} {v}: "
                                                 f"lane != solo run")
                d["solo_s"] = time.perf_counter() - t0
                d["solo_masked_launches"] = K.ell_partials_masked.launches
                if version == 1:  # cut at version 2 (about 23 s) for the pulse
                    t0 = time.perf_counter()
                    with GraphService.from_store(root, backend="torch",
                                                 **svc_kw) as tsvc:
                        tres, _, _ = ask(tsvc, f"version {version} torch")
                    same(res, tres, f"version {version} cuda vs torch",
                         ppr_tol=True)
                    d["torch_s"] = time.perf_counter() - t0
                d["publish_s"] = publish_s
                d["update"] = {"inserted": upd.edges_inserted,
                               "removed": upd.edges_removed,
                               "shards_touched": len(upd.shards_touched),
                               "latency_s": upd.latency_s}
                rep["versions"][version] = d
                answers[version] = res
                print(f"    publish {publish_s:.2f} s ({upd.edges_inserted} in, "
                      f"{upd.edges_removed} out, {P} shards); no dirty shard "
                      f"resident; {len(solo_at[version])} solo runs bitwise "
                      f"({d['solo_s']:.1f} s)" + (f"; torch agrees ({d['torch_s']:.1f}"
                                                 f" s)" if "torch_s" in d else ""))

            t0 = time.perf_counter()
            cst = svc.compact()
            rep["compact_s"] = time.perf_counter() - t0
            rep["compaction"] = vars(cst)
            if svc.stats()["dirty_shards"] != 0 or cst.shards_compacted != P:
                raise AssertionError(f"compaction left dirty shards: {cst}")
            svc.bump_graph_version()
            res, d, loads = ask(svc, "compacted", traced=True)
            same(res, answers[2], "compacted vs version 2")
            store_reads = {}
            for x in loads:
                if not x["from_resident"]:
                    store_reads[x["shard"]] = store_reads.get(x["shard"], 0) + 1
            if (any(x["logical"] for x in loads) or sorted(store_reads) != list(
                    range(P)) or max(store_reads.values()) != 1
                    or sorted(svc.engine._device_shards) != list(range(P))):
                raise AssertionError(f"compacted: shards not resident again "
                                     f"{store_reads}")
            rep["versions"]["compacted"] = d
            print(f"    compact {rep['compact_s']:.2f} s ({cst.runs_absorbed} runs, "
                  f"{cst.shard_bytes_written} B); answers == version 2 bitwise; "
                  f"each shard read once, then resident")

            g = Graph(meta.num_vertices, cur_src, cur_dst)
            store = svc.engine.store
            ep = store.ell_params()
            for p in (0, P // 2):
                v0_, v1_ = (int(x) for x in meta.interval_of(p))
                m = (g.dst >= v0_) & (g.dst < v1_)
                sub = Graph(meta.num_vertices, g.src[m], g.dst[m])
                shard = dataclasses.replace(
                    build_shards(sub, np.array([v0_, v1_]))[0], shard_id=p)
                csr_raw, ell_raw, _ = store.encode_shard(
                    shard, num_vertices=meta.num_vertices, **ep)
                for fmt, raw in (("csr", csr_raw), ("ell", ell_raw)):
                    disk = Path(root, store.shard_name(p, fmt)).read_bytes()
                    if hashlib.sha256(disk).digest() != hashlib.sha256(raw).digest():
                        raise AssertionError(f"compacted shard {p} {fmt} differs "
                                             f"from a from-scratch build")
            rep["compacted_bytes_checked"] = [0, P // 2]
            print(f"    shards 0 and {P // 2}: compacted CSR and ELL containers "
                  f"byte-identical to a from-scratch build")

            ckpt = self.tmp.name + "/warm"
            t0 = time.perf_counter()
            svc.save_warm_state(ckpt)
            rep["save_warm_s"] = time.perf_counter() - t0
            cold_new = svc.query(*new_query, max_iters=DELTA_ITERS)
        finally:
            svc.close()

        t0 = time.perf_counter()
        warm = GraphService.from_store(root, backend="cuda", warm_state=ckpt,
                                       **svc_kw)
        rep["warm_boot_s"] = time.perf_counter() - t0
        with warm:
            wr = warm.warm_restore_report
            rep["warm_restore_report"] = wr
            rep["warm_boot_reads"] = warm.engine.loading_io.reads
            if not (wr["valid"] and wr["shards_warm"] == P
                    and warm.engine.loading_io.reads == 0
                    and wr["sessions_restored"] >= DELTA_QUERIES):
                raise AssertionError(f"warm restore: {wr}, reads "
                                     f"{warm.engine.loading_io.reads}")
            p, v = queries[0]
            hit = warm.query(p, v, max_iters=DELTA_ITERS)
            if not (hit.cached and np.array_equal(f(hit.values), f(res[0].values))):
                raise AssertionError("warm: the repeated query missed the cache")
            t0 = time.perf_counter()
            new = warm.query(*new_query, max_iters=DELTA_ITERS)
            rep["warm_new_query_s"] = time.perf_counter() - t0
            if new.cached or not np.array_equal(f(new.values), f(cold_new.values)):
                raise AssertionError("warm: the new query != the cold service's")
        print(f"  warm boot {rep['warm_boot_s']:.2f} s (cold "
              f"{rep['cold_boot_s']:.2f} s): {wr['shards_warm']} shards' sources "
              f"restored, 0 reads, {wr['sessions_restored']} sessions; repeated "
              f"query cached bitwise; new query bitwise the cold service's")

    def pulse(self):
        """The load harness under telemetry on the ingested copy: see the
        module docstring."""
        import numpy as np
        torch = self.torch
        from repro_torch.core import ShardStore, VSWEngine, apps
        from repro_torch.kernels.spmv_ell import kernel as K
        from repro_torch.obs import (Tracer, error_rate_slo, jsonl_lines,
                                     latency_slo, parse_prometheus,
                                     prometheus_text, read_jsonl, share_slo,
                                     trace, write_jsonl)
        from repro_torch.serve import (GraphService, LoadGenerator, QueryClass,
                                       Workload, oracle_kwargs)

        root = self.ingest_root
        meta = ShardStore(root).read_meta()
        out_dir = Path(self.args.out).parent
        out_dir.mkdir(parents=True, exist_ok=True)
        lanes_k = ("ell_partials_ragged", "ell_partials_lanes",
                   "segment_combine_lanes")
        classes = tuple(
            QueryClass(p, weight=w, max_iters=PULSE_ITERS, params=kw)
            for p, w, kw in (("bfs", 2.0, {}), ("sssp", 1.0, {}),
                             ("wcc", 1.0, {}), ("ppr", 1.0, {"damping": 0.85})))
        eng_kw = dict(backend="cuda", device="cuda", batch_shards=4,
                      prefetch_depth=DELTA_PREFETCH)
        f = lambda v: np.nan_to_num(v, posinf=1e30)
        rep = self.report["pulse"] = {}

        def same(r, want, label):
            if not (np.array_equal(f(r.values), f(want.values))
                    and (r.iterations, r.converged) == (want.num_iterations,
                                                        want.converged)):
                raise AssertionError(f"{label} {r.program} {r.source} at v"
                                     f"{r.graph_version}: not bitwise solo")

        def summary(lg):
            iters = [r.iterations for r in lg.records if r.ok]
            return {**lg.summary(), "iterations_per_op": float(np.mean(iters)),
                    "iterations_hist": np.bincount(iters).tolist()}

        for n in lanes_k:
            getattr(K, n).launches = 0
        svc = GraphService.from_store(root, device_resident=True, max_lanes=16,
                                      max_groups=2, session_entries=0, **eng_kw)
        solo = None
        try:
            svc.start_telemetry(interval_s=0.5, slos=[
                latency_slo("latency_p99", threshold_s=60.0, budget=0.01),
                error_rate_slo("admission_errors", budget=0.05),
                share_slo("queue_wait_share", budget=0.95)])
            t0 = time.perf_counter()
            closed = LoadGenerator(
                svc, Workload(classes=classes, seed=PULSE_SEED), mode="closed",
                concurrency=8, batch_size=4, total_ops=64, warmup_ops=16).run()
            rep["closed_s"] = time.perf_counter() - t0
            quiesce(svc)
            c_snap = svc.metrics_snapshot()
            rep["closed"] = c = summary(closed)
            rep["closed_slo"] = c_snap.get("slo")
            if "slo" not in c_snap or any(v["slo"] == "admission_errors" for v
                                          in c_snap["slo"]["violations"]):
                raise AssertionError(f"closed loop: slo block {c_snap.get('slo')}")
            if closed.completed != 48 or closed.errors or closed.rejected:
                raise AssertionError(f"closed loop: {c}")
            print(f"  closed loop (8 x 4, 64 ops, 16 warm-up): {c['qps']:.3f} q/s "
                  f"({c['iterations_per_op']:.2f} iterations an op), latency p50 "
                  f"{c['latency']['p50']:.3f} s p99 {c['latency']['p99']:.3f} s, "
                  f"queue wait p99 {c['queue_wait']['p99']:.3f} s, share "
                  f"{c['queue_wait_share']:.3f}, mix {c['per_class']}")

            t0 = time.perf_counter()
            solo = VSWEngine.from_store(root, device_resident=True, **eng_kw)
            for r in closed.records:
                same(r, solo.run(apps.get_program(r.program, **oracle_kwargs(r)),
                                 max_iters=r.max_iters), "closed")
                r.values = None
            rep["closed_oracle"] = {"checked": len(closed.records),
                                    "seconds": time.perf_counter() - t0}
            print(f"  all {len(closed.records)} closed-loop records bitwise a solo "
                  f"resident cuda engine ({rep['closed_oracle']['seconds']:.1f} s)")

            v_pre = svc.graph_version
            target = 0.5 * closed.qps
            tracer = Tracer()
            t0 = time.perf_counter()
            with trace.tracing(tracer):
                opened = LoadGenerator(
                    svc, Workload(classes=classes, seed=PULSE_SEED,
                                  update_every=12, update_batch=16),
                    mode="open", target_qps=target, poisson=True, total_ops=24,
                    warmup_ops=4).run()
                quiesce(svc)
            rep["open_s"] = time.perf_counter() - t0
            if tracer.open_span_count() != 0:
                raise AssertionError(f"{tracer.open_span_count()} spans left open")
            doc = tracer.export_chrome(str(out_dir / "trace_pulse.json"))
            rep["open"] = o = summary(opened)
            o["versions"] = {str(v): sum(r.graph_version == v for r in opened.records)
                             for v in sorted({r.graph_version for r in opened.records})}
            o["trace"] = {"events": tracer.event_count(),
                          "dropped_events": tracer.dropped_events(),
                          "threads": tracer.thread_names()}
            v_last = svc.graph_version
            if (opened.completed + opened.rejected != 20 or opened.errors
                    or opened.updates_published != 2 or v_last != v_pre + 2):
                raise AssertionError(f"open loop: {o}")
            print(f"  open loop (Poisson, 24 ops, 4 warm-up, 2 x 16 inserts): "
                  f"offered {o['offered_qps']:.3f} q/s (target {target:.3f}), "
                  f"achieved {o['qps']:.3f} q/s, latency p50 "
                  f"{o['latency']['p50']:.3f} s p99 {o['latency']['p99']:.3f} s, "
                  f"{o['rejected']} rejected, records by version {o['versions']}")

            # no dirty shard from the resident map: a load that starts after
            # publish k of a shard an insert batch <= k touched is a logical
            # decode through the overlay
            ev = doc["traceEvents"]
            pubs = sorted(e["ts"] + e["dur"] for e in ev
                          if e.get("name") == "service.publish")
            loads = [e for e in ev if e.get("name") == "shard.load"]
            batches = sorted((u for u in opened.updates if u.ok),
                             key=lambda u: u.graph_version)
            dirty, bad, logical = set(), [], 0
            for k, (t_pub, u) in enumerate(zip(pubs, batches)):
                dirty |= set((np.searchsorted(meta.intervals, u.inserts[:, 1],
                                              side="right") - 1).tolist())
                t_next = pubs[k + 1] if k + 1 < len(pubs) else float("inf")
                for e in loads:
                    a = e["args"]
                    if t_pub <= e["ts"] < t_next and a["shard"] in dirty:
                        logical += 1
                        if a["from_resident"] or not a["logical"]:
                            bad.append(a)
            if len(pubs) != 2 or bad or not logical or (
                    set(svc.engine._device_shards) & dirty):
                raise AssertionError(f"open loop: a dirty shard not decoded "
                                     f"through the overlay: {bad[:3]}")
            o["dirty_shards"] = sorted(dirty)
            o["dirty_loads_logical"] = logical

            t0 = time.perf_counter()
            pre = [r for r in opened.records if r.ok and r.graph_version == v_pre]
            for r in pre:
                same(r, solo.run(apps.get_program(r.program, **oracle_kwargs(r)),
                                 max_iters=r.max_iters), "open")
                r.values = None
            solo.close()
            solo = None
            last = [r for r in opened.records if r.ok and r.graph_version == v_last]
            if not last:
                # the stream's last batch rides the schedule's last op, so
                # every record may have been answered before it published:
                # ask the fewest-iteration measured op again at that version
                r = min((r for r in opened.records if r.ok and r.phase == "measure"),
                        key=lambda r: r.iterations)
                qr = svc.submit(r.program, r.source, max_iters=r.max_iters,
                                **dict(r.params)).result(timeout=600)
                if qr.graph_version != v_last:
                    raise AssertionError(f"asked again at v{qr.graph_version}")
                r = dataclasses.replace(r, values=qr.values, iterations=qr.iterations,
                                        converged=qr.converged,
                                        graph_version=qr.graph_version)
                last, o["last_version_asked_again"] = [r], 1
            fewest = {}
            for r in sorted(last, key=lambda r: r.iterations):
                fewest.setdefault(r.program, r)
            checked = []
            t1 = time.perf_counter()
            with VSWEngine.from_store(root, device_resident=False, **eng_kw) as late:
                if late.store.delta.version != svc.engine.store.delta.version:
                    raise AssertionError("the solo engine opened another version")
                for r in sorted(fewest.values(), key=lambda r: r.iterations):
                    if checked and time.perf_counter() - t1 > PULSE_SOLO_BUDGET_S:
                        break
                    same(r, late.run(apps.get_program(r.program, **oracle_kwargs(r)),
                                     max_iters=r.max_iters), "open")
                    checked.append(f"{r.program} {r.source} ({r.iterations} it)")
            for r in opened.records:
                r.values = None
            rep["open_oracle"] = {"pre_stream": len(pre), "last_version": checked,
                                  "seconds": time.perf_counter() - t0}
            print(f"  open loop: {len(pre)} records at the pre-stream version v"
                  f"{v_pre} bitwise the solo resident engine; at the last version "
                  f"v{v_last} bitwise a solo non-resident engine opened after the "
                  f"drain: {checked}; no dirty shard of {sorted(dirty)} served "
                  f"resident ({logical} logical loads)")

            snap = svc.metrics_snapshot()
            scalars = {k: v for k, v in svc.metrics.snapshot().items()
                       if not isinstance(v, dict)}
            prom = parse_prometheus(prometheus_text(svc.metrics))
            if snap["conservation_violations"] or "slo" not in snap:
                raise AssertionError(f"{snap['conservation_violations'][:3]}, "
                                     f"slo block {'slo' in snap}")
            differ = [k for k, v in scalars.items()
                      if prom["graphmp_" + k.replace(".", "_")] != v]
            if differ or prom["graphmp_query_completed"] != snap["errors"]["completed"]:
                raise AssertionError(f"prometheus text != the snapshot: {differ[:5]}")
            (out_dir / "pulse.prom").write_text(prometheus_text(svc.metrics))
            ts = svc.stop_telemetry()
            path = str(out_dir / "pulse.jsonl")
            n = write_jsonl(path, ts)
            back = read_jsonl(path)
            if n != len(ts.samples()) or back != [json.loads(x)
                                                  for x in jsonl_lines(ts)]:
                raise AssertionError(f"jsonl: {n} lines, {len(back)} read back")
            rep["slo"] = snap["slo"]
            rep["timeseries"] = {**snap["timeseries"], "jsonl_windows": len(back),
                                 "windows_after_stop": ts.num_windows}
            rep["prometheus_samples"] = len(prom)
            print(f"  SLOs: {snap['slo']['evaluations']} evaluations, violations "
                  f"{[v['slo'] for v in snap['slo']['violations']]}; "
                  f"{json.dumps({o_['name']: o_['burn_rates'] for o_ in snap['slo']['objectives']})}")
            print(f"  {len(back)} windows round-trip through JSONL, {len(prom)} "
                  f"Prometheus samples equal to the registry, no conservation "
                  f"violation")
        finally:
            if solo is not None:
                solo.close()
            svc.close()
        launches = {n: getattr(K, n).launches for n in lanes_k}
        rep["launches"] = launches
        if not (launches["ell_partials_ragged"] and launches["segment_combine_lanes"]):
            raise AssertionError(f"the pulse ran no lane kernel: {launches}")
        print(f"  lane kernel launches during the phase (solo runs' single-lane "
              f"kernels aside): {launches}")

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

    @staticmethod
    def combine_sectors(torch, perms, ptrs, rows):
        """Bytes segment_combine moves counted in whole 32 B sectors: each
        distinct sector its gathers touch in the partials, and the sectors
        of perm's valid entries, of row_ptr and of the output."""
        ell0, gathered, total = 0, [], 0
        for pm, rp in zip(perms, ptrs):
            n = int(rp[-1])
            gathered.append((pm[:n].long() + ell0) // 8)
            total += 32 * (-(-4 * n // 32) + -(-4 * rp.numel() // 32))
            ell0 += pm.numel()
        return total + 32 * (torch.unique(torch.cat(gathered)).numel() + -(-4 * rows // 32))

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
            bytes=4 * (2 * n_valid + 2 * rows + 1),
            min_ms=spread["kernel"]["min"],
            ratio_to_index_add=spread["kernel"]["median"] / spread["index_add_"]["median"],
            sector_bound_ms=self.combine_sectors(torch, perms, ptrs, rows)
            / HBM_BYTES_PER_S * 1e3)
        for kname, d in t.items():
            d["bound_ms"] = d["bytes"] / HBM_BYTES_PER_S * 1e3
        slots = sum(d.idx.numel() for d in shards)
        lens = torch.cat([(d.row_ptr[1:] - d.row_ptr[:-1]).long() for d in shards])
        self.report["combine_rows"] = {  # how skewed the combine's rows are
            "longest": int(lens.max()), "row_0": int(lens[0]),
            "rows_1_31": [int(lens[1:32].min()), int(lens[1:32].max())],
            "share_of_rows_over_32": float((lens > 32).float().mean()),
            "share_of_partials_in_rows_over_32": float(lens[lens > 32].sum() / lens.sum()),
            "share_of_rows_over_128": float((lens > 128).float().mean())}
        print(f"  combine rows: {json.dumps(self.report['combine_rows'])}")
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
        # one device operation a call (the splits merged in the same launch)
        x = synth[torch.bfloat16]
        rep["kernels_per_call"] = graph_device_ops(torch, lambda: FK.flash_decode(*x))
        print(f"  device operations a flash_decode call: {rep['kernels_per_call']}")
        if rep["kernels_per_call"] != 1:
            raise AssertionError(f"flash_decode: {rep['kernels_per_call']} device "
                                 f"operations a call")
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
            earlier_ms=EARLIER_MS["bloom_contains any"])
        # the bits of one filter (contains) at each set size, beside their bound
        one = (staged.words[0], staged.num_bits[0], staged.num_hashes[0])
        d["contains_one_filter"] = {}
        for n, ids in sets.items():
            dev_ids = torch.from_numpy(ids).cuda()
            nb_, ops_, probes_ = self.bloom_bits_work(torch, *one, dev_ids)
            bnd = {"bytes": nb_ / HBM_BYTES_PER_S * 1e3, "operations": ops_ / F32_OPS_PER_S * 1e3}
            b_by = max(bnd, key=bnd.get)
            d["contains_one_filter"][n] = dict(
                ms=self.timed(lambda: BK.bloom_contains(
                    one[0], dev_ids, num_bits=one[1], num_hashes=one[2]), 20),
                bound_ms=bnd[b_by], bound_by=b_by, bytes=nb_, operations=ops_,
                probes=probes_, earlier_ms=EARLIER_MS.get(f"bloom_contains n={n}"))
        # device operations an "any" call makes (one launch, no clearing)
        d["device_ops_per_any_call"] = graph_device_ops(
            torch, lambda: BK.bloom_contains(staged.words, items, reduce_any=True, **kw))
        print(f"  device operations a bloom any call: {d['device_ops_per_any_call']}")
        if d["device_ops_per_any_call"] != 1:
            raise AssertionError(f"bloom any: {d['device_ops_per_any_call']} device "
                                 f"operations a call")
        # the other extreme: empty tables of the same sizes, so no filter is
        # ever hit and the scan reads every id against every filter
        empty = [torch.zeros(w.numel(), dtype=torch.int32, device=w.device)
                 for w in staged.words]
        if BK.bloom_contains(empty, items, reduce_any=True, **kw).any():
            raise AssertionError("bloom any: an empty filter reported hit")
        e_bytes, e_ops, e_probes, _ = self.bloom_work(torch, bops.DeviceFilters(
            empty, staged.num_bits, staged.num_hashes), items)
        d["full_scan_ms"] = self.timed(lambda: BK.bloom_contains(
            empty, items, reduce_any=True, **kw), 20)
        d["full_scan_bound_ms"] = max(e_bytes / HBM_BYTES_PER_S,
                                      e_ops / F32_OPS_PER_S) * 1e3
        d["full_scan_earlier_ms"] = EARLIER_MS["bloom_contains any full scan"]
        # the rate of random 32 B L2 sectors the scan and the bits reach
        d["full_scan_probes"] = e_probes
        d["full_scan_probes_per_s"] = e_probes / (d["full_scan_ms"] * 1e-3)
        big = d["contains_one_filter"][nv]
        big["probes_per_s"] = big["probes"] / (big["ms"] * 1e-3)
        # any call after a no-hit call on the same stream: the state is clean
        for _ in range(3):
            if not torch.equal(BK.bloom_contains(staged.words, items, reduce_any=True, **kw),
                               out) or BK.bloom_contains(empty, items, reduce_any=True,
                                                         **kw).any():
                raise AssertionError("bloom any: hit and no-hit calls in turn disagree")
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
    def bloom_bits_work(torch, words, num_bits, num_hashes, items):
        """What the bits of one filter need on this data: each id read once
        and its byte written once, each 32 B word sector its probes touch
        (every id probed up to its first clear bit) once; 8 integer
        operations to hash an id and 6 a probe.  Returns bytes, operations
        and probes."""
        from repro_torch.kernels.bloom.ref import hash2_u32, words_as_int64

        h1, h2 = hash2_u32(items)
        table = words_as_int64(words)
        live = torch.arange(items.numel(), device=items.device)
        sectors, probes = [], 0
        for i in range(num_hashes):
            pos = (h1[live] + i * h2[live]) & (num_bits - 1)
            probes += pos.numel()
            sectors.append(torch.unique(pos >> 8))
            live = live[((table[pos >> 5] >> (pos & 31)) & 1) != 0]
        n = items.numel()
        return (5 * n + 32 * torch.unique(torch.cat(sectors)).numel(),
                8 * n + 6 * probes, probes)

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


def sha256_of(path):
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def mutate(src, dst, ins, dels):
    """The delta batch semantics on a plain edge list: every copy of each
    deleted edge removed, then the inserts appended."""
    import numpy as np

    pack = lambda s, d: (np.asarray(d, np.int64) << 32) | np.asarray(s, np.int64)
    keep = ~np.isin(pack(src, dst), np.unique(pack(*dels)))
    return (np.concatenate([src[keep], np.asarray(ins[0], np.int32)]),
            np.concatenate([dst[keep], np.asarray(ins[1], np.int32)]))


def pin_zip_clock():
    """Give every npz member this script writes the same write time: the
    only bytes of a store that depend on the clock."""
    import types
    import zipfile

    zipfile.time = types.SimpleNamespace(time=lambda: ZIP_CLOCK,
                                         localtime=time.localtime)


class RssSampler:
    """Peak resident set size of this process, sampled from
    ``/proc/self/statm`` every 10 ms on a thread (``ru_maxrss`` keeps the
    parent's high-water mark across the exec, and the card's machine has
    no VmHWM).  ``peak`` is None where statm cannot be read."""

    def __init__(self):
        import os
        import threading

        self.page = os.sysconf("SC_PAGE_SIZE")
        self.start = self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _rss(self):
        try:
            return int(Path("/proc/self/statm").read_text().split()[1]) * self.page
        except (OSError, ValueError, IndexError):
            return None

    def _run(self):
        while not self._stop.wait(0.01):
            rss = self._rss()
            if rss is not None and self.peak is not None:
                self.peak = max(self.peak, rss)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def ingest_child(args) -> int:
    """The ingest phase's child: stream-ingest the edge file, print the
    stats, the three passes' seconds and this process's peak RSS."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import ShardStore
    from repro_torch.obs import trace
    from repro_torch.obs.trace import Tracer

    pin_zip_clock()
    edges, root = args.ingest_child
    t0 = time.perf_counter()
    with RssSampler() as rss, trace.tracing(Tracer()) as tr:
        meta, stats = ShardStore(root).ingest(
            edges, num_shards=args.shards, num_vertices=args.vertices,
            window=1 << 14, k=128, tr=8)
    wall = time.perf_counter() - t0
    spans = {e["name"]: e["dur"] / 1e6 for e in tr.export_chrome()["traceEvents"]
             if e.get("name", "").startswith("ingest.") and "dur" in e}
    print(json.dumps({
        "ingest_s": wall, "pass1_s": spans["ingest.scan"],
        "pass2_s": spans["ingest.scatter"], "finalize_s": spans["ingest.finalize"],
        "peak_rss_bytes": rss.peak, "rss_before_bytes": rss.start,
        "stats": dataclasses.asdict(stats)}))
    return 0


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


def quiesce(svc, timeout=120.0, still_s=1.0):
    """Wait until the service's worker has booked every fusion set it ran:
    nothing pending and the count of booked sets unchanged for ``still_s``
    (a query's future resolves inside its sweep, before the sweep books its
    stats: see ``settle``)."""
    deadline = time.monotonic() + timeout
    last, since = None, time.monotonic()
    while time.monotonic() < deadline:
        st = svc.stats()
        key = (st["sweeps"], st["pending"], st["updates_pending"])
        if key != last:
            last, since = key, time.monotonic()
        elif not (st["pending"] or st["updates_pending"]) and (
                time.monotonic() - since >= still_s):
            return st["sweeps"]
        time.sleep(0.01)
    raise AssertionError(f"the service did not quiesce: {last}")


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


def graph_device_ops(torch, fn):
    """Device operations (kernels, memsets, copies) one call of ``fn``
    makes: the nodes of a CUDA graph that captures a call, after a warm-up
    call on the capturing stream.  (A profiler trace of a few calls came
    back empty after the process's earlier traces on the card.)"""
    import ctypes

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    stream.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
        fn()
    n = ctypes.c_size_t(0)
    rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUDA error {rc}")
    return int(n.value)


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
    if args.ingest_child:
        return ingest_child(args)
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
    pin_zip_clock()
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
            smoke.phase("ingest", smoke.ingest)
            if "ingest" not in smoke.failures:
                smoke.phase("delta", smoke.delta)
                smoke.phase("pulse", smoke.pulse)
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
