"""Out-of-core boot on the port: stream an edge file into a store, then
serve it from the card.

1. write a raw binary edge file (8 bytes an edge),
2. stream-ingest it with a deliberately small chunk and spill budget, so
   the two-pass external build actually spills and merges,
3. boot a ``VSWEngine`` straight from the store directory — no Graph
   object — and run PageRank on the ``cuda`` backend,
4. boot a ``GraphService`` from the same directory and answer queries.

Run:  PYTHONPATH=src python examples/torch/ingest_quickstart.py [--device cpu]
(the card by default; on the CPU the CUDA kernels' plain versions run).
"""

import argparse
import os
import tempfile

import numpy as np

from repro_torch.core import apps
from repro_torch.core.graph import rmat_graph
from repro_torch.core.ingest import write_edge_file
from repro_torch.core.storage import ShardStore
from repro_torch.core.vsw import VSWEngine
from repro_torch.serve import GraphService


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    num_v, num_e = 50_000, 1_000_000
    with tempfile.TemporaryDirectory() as d:
        edge_path = os.path.join(d, "edges.bin")
        root = os.path.join(d, "store")

        g = rmat_graph(num_v, num_e, seed=0)
        nbytes = write_edge_file(edge_path, g.src, g.dst)
        del g  # from here on, nothing holds the edge list
        print(f"edge file: {num_e:,} edges, {nbytes / 1e6:.1f} MB")

        store = ShardStore(root)
        meta, stats = store.ingest(edge_path, edges_per_shard=60_000,
                                   num_vertices=num_v, chunk_edges=25_000,
                                   mem_budget_bytes=1 << 20)
        print(f"ingested: {meta.num_shards} shards | {stats.spills} spills, "
              f"{stats.runs} runs, {stats.spill_bytes_written / 1e6:.1f} MB "
              f"spilled | peak scatter buffer "
              f"{stats.peak_buffered_bytes / 1e6:.2f} MB")

        with VSWEngine.from_store(root, backend="cuda", device=args.device,
                                  batch_shards=4, cache_bytes=64 << 20) as engine:
            r = engine.run(apps.pagerank(), max_iters=10)
            top = np.argsort(r.values)[-3:][::-1]
            print(f"pagerank top-3 vertices: {top.tolist()}")

        with GraphService.from_store(root, backend="cuda", device=args.device,
                                     max_lanes=8, batch_shards=4) as svc:
            futs = [svc.submit("bfs", int(s), max_iters=50) for s in (0, 7, 99)]
            for f in futs:
                q = f.result()
                reached = int(np.isfinite(q.values).sum())
                print(f"bfs from {q.source}: reached {reached:,} vertices "
                      f"in {q.iterations} iterations")


if __name__ == "__main__":
    main()
