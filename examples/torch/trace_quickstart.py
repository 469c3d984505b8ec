"""Tracing quickstart on the port: trace a serving run, open it in Perfetto.

Starts an in-process :class:`GraphService` with a :class:`Tracer`
installed, runs a mixed BFS / SSSP / personalized-PageRank workload with
one live edge-update batch in the middle, then:

1. exports a Chrome-trace JSON (``trace_quickstart.json``) — load it at
   https://ui.perfetto.dev (or ``chrome://tracing``) to see the
   admit -> plan -> prefetch -> load -> decode -> dispatch -> retire
   timeline, with one lane per thread (service worker, shard
   prefetchers, the delta recompactor);
2. prints the service's metrics snapshot: p50/p95/p99 query latency
   split into queue-wait vs sweep time, per-stage sweep timings, and the
   result of replaying every declared conservation identity.

Run:  PYTHONPATH=src python examples/torch/trace_quickstart.py [--device cpu]
"""

import argparse
import json
import tempfile

import numpy as np

from repro_torch.core.graph import rmat_graph
from repro_torch.obs import Tracer, trace
from repro_torch.serve import GraphService

N_QUERIES = 24
OUT = "trace_quickstart.json"


def _mixed_queries(num_vertices, seed=0):
    rng = np.random.default_rng(seed)
    programs = ["bfs", "sssp", "ppr"]
    return [
        (programs[i % len(programs)], int(rng.integers(num_vertices)))
        for i in range(N_QUERIES)
    ]


def _fmt_pct(name, p):
    return (f"  {name:14} n={p['count']:<4d} p50={p['p50'] * 1e3:8.2f}ms  "
            f"p95={p['p95'] * 1e3:8.2f}ms  p99={p['p99'] * 1e3:8.2f}ms")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args()
    print("== tracing quickstart ==")
    g = rmat_graph(num_vertices=4_000, num_edges=60_000, seed=0)
    queries = _mixed_queries(g.num_vertices)
    tracer = Tracer()

    with trace.tracing(tracer):  # installs the tracer for every thread
        with tempfile.TemporaryDirectory() as root:
            with GraphService.from_graph(
                g, root,
                num_shards=8,
                backend="cuda",
                device=args.device,
                max_lanes=8,
                max_groups=2,         # fuse bfs/sssp with ppr on one stream
                auto_compact_runs=1,  # so the recompactor lane shows up
            ) as service:
                half = N_QUERIES // 2
                futs = [service.submit(p, s, max_iters=20)
                        for p, s in queries[:half]]
                for f in futs:
                    f.result()

                # a live update between sweeps: overlay.merge + compact.shard
                # spans appear, later queries run on the new graph version
                service.apply_updates(
                    inserts=[(1, 2), (3, 4), (5, 6)], deletes=[(0, 1)]
                ).result()

                futs = [service.submit(p, s, max_iters=20)
                        for p, s in queries[half:]]
                for f in futs:
                    f.result()

                snap = service.metrics_snapshot()

    doc = tracer.export_chrome(OUT)
    lanes = sorted(tracer.thread_names())
    spans = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    print(f"\nwrote {OUT}: {len(doc['traceEvents'])} events, "
          f"{len(lanes)} thread lanes "
          f"(dropped={doc['otherData']['dropped_events']})")
    print("  lanes:", ", ".join(lanes))
    print("  spans:", ", ".join(sorted(spans)))
    print("open in https://ui.perfetto.dev or chrome://tracing")

    print("\nquery latency (submit -> result):")
    print(_fmt_pct("total", snap["query_latency_s"]))
    print(_fmt_pct("queue wait", snap["queue_wait_s"]))
    print(_fmt_pct("sweep", snap["sweep_s"]))
    print("per-stage sweep timings:")
    for stage, p in snap["stages"].items():
        print(_fmt_pct(stage, p))
    bad = snap["conservation_violations"]
    print(f"conservation: {'OK' if not bad else bad} "
          f"({service.metrics.num_checks} identities replayed)")

    with open(OUT) as f:
        json.load(f)  # the artifact round-trips as valid JSON
    print("\ndone.")


if __name__ == "__main__":
    main()
