"""Live edge mutations on the port: update a graph served from the card.

1. stream-ingest an edge file and serve it with a resident ``cuda``
   engine and background recompaction (``auto_compact_runs``),
2. answer a BFS query, then ``apply_updates()`` — insert a shortcut edge
   and delete a ring edge — and watch the same query return a different
   (correct) answer at the new graph version; the touched shard is decoded
   on the host through the delta overlay, never served from its stale
   resident device copy,
3. show that repeat queries are version-tagged session-cache hits,
4. churn updates until the recompactor folds the delta runs back into the
   base shards, which then live on the card again.

Run:  PYTHONPATH=src python examples/torch/update_quickstart.py [--device cpu]
"""

import argparse
import os
import tempfile
import time

import numpy as np

from repro_torch.core.graph import small_world_graph
from repro_torch.core.ingest import write_edge_file
from repro_torch.serve import GraphService


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    num_v = 20_000
    with tempfile.TemporaryDirectory() as d:
        edge_path = os.path.join(d, "edges.bin")
        root = os.path.join(d, "store")

        g = small_world_graph(num_v, k=2, shortcuts=0.0002, seed=7)
        write_edge_file(edge_path, g.src, g.dst)
        svc = GraphService.from_edge_file(
            edge_path, root, num_shards=8, num_vertices=num_v,
            backend="cuda", device=args.device, device_resident=True,
            batch_shards=4, max_lanes=8, auto_compact_runs=4)
        print(f"serving {num_v} vertices / {g.num_edges} edges from {root}")

        src, far = 0, 100  # 50 ring hops apart
        r0 = svc.query("bfs", src)
        print(f"v{r0.graph_version}: dist({src} -> {far}) = "
              f"{r0.values[far]:.0f}  (iters={r0.iterations})")

        upd = svc.apply_updates(inserts=(np.array([src]), np.array([far])),
                                deletes=(np.array([src]), np.array([1]))).result()
        print(f"published v{upd.graph_version}: +{upd.edges_inserted} "
              f"-{upd.edges_removed} edges, shards {upd.shards_touched}")
        r1 = svc.query("bfs", src)
        assert r1.graph_version == upd.graph_version
        assert r1.values[far] == 1.0, "shortcut must be visible immediately"
        print(f"v{r1.graph_version}: dist({src} -> {far}) = "
              f"{r1.values[far]:.0f}  <- shortcut live, no re-preprocess")
        resident = sorted(svc.engine._device_shards)
        print(f"shards resident on the device: {resident} (dirty: "
              f"{svc.engine.store.delta.dirty_shards()})")

        r2 = svc.query("bfs", src)
        print(f"repeat query: cached={r2.cached} at v{r2.graph_version}")
        assert r2.cached and r2.graph_version == r1.graph_version

        rng = np.random.default_rng(0)
        for _ in range(8):
            svc.apply_updates(inserts=(rng.integers(0, num_v, 200),
                                       rng.integers(0, num_v, 200))).result()
        deadline = time.time() + 10
        while (svc.stats().get("shards_compacted", 0) == 0
               and time.time() < deadline):
            time.sleep(0.05)
        st = svc.stats()
        print(f"after churn: graph_version={st['graph_version']} "
              f"dirty_shards={st['dirty_shards']} "
              f"shards_compacted={st.get('shards_compacted')}")
        assert st.get("shards_compacted", 0) >= 1, "background compaction"

        svc.compact()
        assert svc.stats()["dirty_shards"] == 0
        r3 = svc.query("bfs", src)
        assert r3.values[far] == 1.0  # the shortcut survived recompaction
        print(f"v{r3.graph_version}: dist({src} -> {far}) = {r3.values[far]:.0f}"
              f"  (compacted base shards, resident: "
              f"{len(svc.engine._device_shards)} of 8)")
        svc.close()
        print("done.")


if __name__ == "__main__":
    main()
