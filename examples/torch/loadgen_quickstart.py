"""Load-harness quickstart on the port: load-test a live service, watch
the SLOs.

Starts an in-process :class:`GraphService` with the telemetry ticker and
an SLO monitor running, then replays a seeded mixed BFS / SSSP / WCC /
PPR workload with a concurrent mutation stream in both load-gen modes:

1. **closed loop** — 4 workers, ``submit_batch`` chunks of 4: sustained
   QPS with exact p50/p99 and the queue-wait vs sweep split;
2. **open loop** — arrival-scheduled at a target QPS with Poisson
   inter-arrivals: offered vs achieved rate, queueing delay measured
   rather than hidden.

Afterwards it prints the SLO burn rates (healthy run: no violations),
writes the telemetry ring as JSONL (``loadgen_quickstart.jsonl``, one
JSON object per closed window) and a Prometheus text exposition
(``loadgen_quickstart.prom`` — feed it to ``promtool check metrics``),
and replays a few completed queries on a solo engine built at their exact
graph version to show the bitwise-reproducibility contract.

Run:  PYTHONPATH=src python examples/torch/loadgen_quickstart.py [--device cpu]
"""

import argparse
import tempfile

import numpy as np

from repro_torch.core import apps
from repro_torch.core.graph import from_edge_list
from repro_torch.core.vsw import VSWEngine
from repro_torch.obs import (
    error_rate_slo,
    latency_slo,
    prometheus_text,
    share_slo,
    write_jsonl,
)
from repro_torch.serve import (
    GraphService,
    LoadGenerator,
    QueryClass,
    Workload,
    edge_state_at_version,
    oracle_kwargs,
)

JSONL_OUT = "loadgen_quickstart.jsonl"
PROM_OUT = "loadgen_quickstart.prom"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args()
    rng = np.random.default_rng(0)
    n, m = 5_000, 80_000
    edges = rng.integers(0, n, size=(m, 2)).astype(np.int64)
    g = from_edge_list(edges, n)

    workload = Workload(
        classes=(
            QueryClass("bfs", weight=2.0, max_iters=6),
            QueryClass("sssp", weight=1.0, max_iters=6),
            QueryClass("wcc", weight=1.0, max_iters=6),
            QueryClass("ppr", weight=1.0, max_iters=5,
                       params={"damping": 0.85}),
        ),
        seed=42,
        update_every=16,   # one mutation batch every 16 queries
        update_batch=32,   # of 32 random inserted edges
    )
    engine_kw = dict(num_shards=6, backend="cuda", device=args.device)

    with tempfile.TemporaryDirectory() as d:
        with GraphService.from_graph(g, f"{d}/store", max_lanes=16,
                                     **engine_kw) as svc:
            svc.start_telemetry(interval_s=0.1, slos=[
                latency_slo("latency_p99", threshold_s=10.0, budget=0.01),
                error_rate_slo("admission_errors", budget=0.05),
                share_slo("queue_wait_share", budget=0.95),
            ])

            print("== closed loop: 4 workers, submit_batch chunks of 4 ==")
            rep = LoadGenerator(
                svc, workload, mode="closed", concurrency=4, batch_size=4,
                total_ops=64, warmup_ops=12,
            ).run()
            print(f"  qps={rep.qps:.1f}  completed={rep.completed}"
                  f"  rejected={rep.rejected}  mix={rep.per_class}")
            print(f"  p50={rep.latency['p50']*1e3:.1f}ms"
                  f"  p99={rep.latency['p99']*1e3:.1f}ms"
                  f"  queue-wait share={rep.queue_wait_share:.0%}"
                  f"  updates published={rep.updates_published}")

            print("== open loop: 150 QPS offered, Poisson arrivals ==")
            rep_o = LoadGenerator(
                svc, workload, mode="open", target_qps=150.0, poisson=True,
                total_ops=32, warmup_ops=6,
            ).run()
            print(f"  offered={rep_o.offered_qps:.1f}"
                  f"  achieved={rep_o.qps:.1f}"
                  f"  p99={rep_o.latency['p99']*1e3:.1f}ms"
                  f"  rejected={rep_o.rejected}")

            snap = svc.metrics_snapshot()
            print("== SLOs ==")
            for obj in snap["slo"]["objectives"]:
                burns = {
                    k: (f"{v['burn_long']:.2f}"
                        if v["burn_long"] is not None else "n/a")
                    for k, v in obj["burn_rates"].items()
                }
                print(f"  {obj['name']} ({obj['kind']},"
                      f" budget={obj['budget']}): burn {burns}")
            print(f"  violations: {len(snap['slo']['violations'])}"
                  f"  errors: {snap['errors']}")

            with open(PROM_OUT, "w") as f:
                f.write(prometheus_text(svc.metrics))
            ts = svc.stop_telemetry()
            n_windows = write_jsonl(JSONL_OUT, ts)
            print(f"wrote {PROM_OUT} and {JSONL_OUT} ({n_windows} windows)")

        # the reproducibility contract: any record replays bitwise on a
        # solo engine (same backend) built at exactly its graph version
        print("== oracle replay (bitwise) ==")
        done = [r for r in rep.records if r.ok][:4]
        norm = lambda v: np.nan_to_num(v, posinf=1e30)
        for r in done:
            g_v = from_edge_list(
                edge_state_at_version(edges, rep.updates, r.graph_version), n
            )
            with VSWEngine.from_graph(g_v, f"{d}/oracle{r.index}",
                                      **engine_kw) as eng:
                solo = eng.run(apps.get_program(r.program, **oracle_kwargs(r)),
                               max_iters=r.max_iters)
            match = bool(np.array_equal(norm(solo.values), norm(r.values)))
            print(f"  {r.program}@{r.source} v{r.graph_version}: "
                  f"{'bitwise-equal' if match else 'MISMATCH'}")
            assert match


if __name__ == "__main__":
    main()
