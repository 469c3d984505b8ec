#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of GraphMP on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure makes the exit code non-zero and suppresses the last
line):

1. build    compile ``src/repro_torch/csrc/*.cu`` for sm_90a into ``build/``.
2. kernels  hold each kernel against its plain PyTorch version on the card,
            for sum/min/max, at the default W=16384/K=128/TR=8 on an R-MAT
            shard, on a star-graph hub that needs row splitting, and on an
            empty shard.  min/max must match bitwise; sum within
            rtol=1e-4, atol=1e-5 (the reference's own kernel tolerance).
            The lane kernels (3, 8 and 32 lanes) also match the
            single-lane kernels on each message row bitwise, and padding
            lanes of a ragged launch are 0.
            A small engine run of the ``cuda`` backend is held against the
            ``numpy`` oracle (bitwise for min/max programs).
3. main     the engine's main path at 2^21 vertices / 2^25 R-MAT edges
            (Graph500 parameters, seed 7), 16 shards, batch_shards=4,
            prefetch_depth=2, cache_bytes=1 GiB: PageRank (5 iterations),
            SSSP and WCC on backend ``cuda``, once with
            device_resident=False and once with True, each held against
            backend ``torch`` on the card (min/max bitwise, PageRank within
            rtol=1e-4, atol=1e-9).  The kernels' launch counters must equal
            the executor's dispatches.
4. serve    the serving path on the same store: ``GraphService`` with
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
5. timing   each kernel, its plain version and a one-call library yardstick
            timed with CUDA events, L2 flushed before each call, on the
            main path's first batch of shards (the lane kernels at 16 and
            32 lanes), beside its bound: the bytes the function must move
            over 3.35 TB/s.  For the partials that is the whole mask plane,
            the 32 B sectors of idx that hold valid slots, the message
            sectors they gather, tile_window and the output (see
            spmv_ell.cu).
6. trace    (diagnostic: a profiler error leaves "not measured" and does
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
L2_FLUSH_BYTES = 256 << 20  # written before each timed call; the L2 holds 50 MB
COMBINES = ("sum", "min", "max")
#: kernel -> the TPU kernel (or XLA step) it replaces, and the shape of the
#: timing phase that stands for it in the kernels line
KERNELS = {
    "ell_partials_masked": ("src/repro/kernels/spmv_ell/kernel.py:63", ""),
    "segment_combine": ("src/repro/kernels/spmv_ell/ops.py:40", ""),
    "ell_partials_lanes": ("src/repro/kernels/spmv_ell/ops.py:72", " L=16"),
    "ell_partials_ragged": ("src/repro/kernels/spmv_ell/kernel.py:123", " L=32"),
    "segment_combine_lanes": ("src/repro/kernels/spmv_ell/ops.py:301", " L=32"),
}


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
    def compare(self, name, got, want, combine, where):
        """Kernel vs plain: bitwise for min/max, tolerance for sum."""
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
            if not np.allclose(a, b, rtol=SUM_RTOL, atol=SUM_ATOL):
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
        for n_lanes in (3, 8, 32):
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
        print(f"  {where:26s} lanes 3/8/32: == single-lane launches bitwise")

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
        t["segment_combine"] = dict(
            ms=self.timed(lambda: K.segment_combine(part, perms, ptrs, "sum"), 50),
            plain_ms=self.timed(lambda: K.segment_combine_plain(
                part, perms, ptrs, "sum"), 10),
            library_ms=self.timed(
                lambda: lib_out.zero_().index_add_(0, seg, part), 50),
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
        # window 0, so all gathers hit one 64 KB table that stays on chip.
        # The gap to the real run bounds what staging each window in
        # shared memory could save.
        tw0 = [torch.zeros_like(tw) for tw in tws]
        self.report["window_staging_probe"] = {
            "ms_real_windows": t["ell_partials_masked"]["ms"],
            "ms_one_window": self.timed(lambda: K.ell_partials_masked(
                idxs, masks, tw0, msgs, **kw), 20)}
        print(f"  window staging probe: "
              f"{json.dumps(self.report['window_staging_probe'])}")
        self.lane_timing(K, first, idxs, masks, tws, perms, ptrs, seg, n_valid,
                         rows, rng)
        # the min combine (SSSP/WCC) at the same shape, for the record
        kmin = dict(kw, combine="min")
        self.report["timing_min"] = {
            "ell_partials_masked_ms": self.timed(
                lambda: K.ell_partials_masked(*args, **kmin), 20),
            "segment_combine_ms": self.timed(lambda: K.segment_combine(
                part, perms, ptrs, "min"), 50)}
        print(f"  min combine: {json.dumps(self.report['timing_min'])}")

    def lane_timing(self, K, first, idxs, masks, tws, perms, ptrs, seg, n_valid,
                    rows, rng):
        """The lane kernels on the same batch at 16 and 32 lanes: the lanes
        kernel with the sum combine; the ragged kernel and the lane combine
        with half the lanes on a min arm and half on a sum arm, as a fusion
        set of BFS/SSSP and PPR lanes."""
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
                    *args, lanes, combine="sum", **kw), 10),
                plain_ms=self.timed(lambda: K.ell_partials_lanes_plain(
                    *args, lanes, combine="sum", **kw), 1),
                library_ms=None, bytes=pbytes)
            t[f"ell_partials_ragged L={L}"] = dict(
                ms=self.timed(lambda: K.ell_partials_ragged(
                    *args, cids, lanes, combines=arms, **kw), 10),
                plain_ms=self.timed(lambda: K.ell_partials_ragged_plain(
                    *args, cids, lanes, combines=arms, **kw), 1),
                library_ms=None, bytes=pbytes)
            t[f"segment_combine_lanes L={L}"] = dict(
                ms=self.timed(lambda: K.segment_combine_lanes(
                    rpart, perms, ptrs, arms, cids), 20),
                plain_ms=self.timed(lambda: K.segment_combine_lanes_plain(
                    rpart, perms, ptrs, arms, cids), 2),
                library_ms=self.timed(
                    lambda: lib.zero_().index_add_(1, seg, part), 20),
                bytes=4 * (L * n_valid + n_valid + rows + len(ptrs) + L * rows + L))
            del x, lanes, part, rpart, acc, lib
        for kname, d in t.items():
            d["bound_ms"] = d["bytes"] / HBM_BYTES_PER_S * 1e3
            if " L=" in kname:
                print(f"  {kname}: {json.dumps(d)}")

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


def settle(svc, sweeps0, timeout=120.0):
    """Fusion sets the service finished since it had finished ``sweeps0``.
    A query's future resolves inside its sweep, before the sweep books its
    stats, so this waits (up to ``timeout``) for the first one to book."""
    deadline = time.monotonic() + timeout
    while svc.stats()["sweeps"] == sweeps0 and time.monotonic() < deadline:
        time.sleep(0.005)
    return svc.stats()["sweeps"] - sweeps0


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
        smoke.phase("small_engine", smoke.small_engine)
        smoke.phase("main", smoke.main_path)
        if "main" not in smoke.failures:
            smoke.phase("serve", smoke.serve)
            smoke.phase("timing", smoke.timing)
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
    for name, (rep, shape) in KERNELS.items():
        d = smoke.timings[name + shape]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/spmv_ell.cu", "replaces": rep,
            "launches": smoke.launches[name],
            "max_abs_err": smoke.errs[name], "ms": d["ms"],
            "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
            "bound_by": "bytes", "library_ms": d["library_ms"]})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
