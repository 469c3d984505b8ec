"""Warm restarts on the port: boot the next serving process without
re-reading the store.

1. serve from the card, apply an update, answer a query, then
   ``save_warm_state()`` and close,
2. cold-boot a fresh service and count its boot reads,
3. warm-boot from the checkpoint: zero boot reads, the repeat query is a
   session-cache hit, fresh queries are bitwise the cold service's,
4. mutate the store behind the snapshot and warm-boot again: the touched
   shard is rejected (the store is authoritative), answers stay correct.

The checkpoint layout is the reference package's: either package restores
the other's.  An ``emulate_bw`` throttle makes the boot-time difference
visible on a small example.

Run:  PYTHONPATH=src python examples/torch/restart_quickstart.py [--device cpu]
"""

import argparse
import os
import tempfile
import time

import numpy as np

from repro_torch.core.graph import rmat_graph
from repro_torch.serve import GraphService

BW = 200e6  # emulated disk bandwidth, bytes/s: boot reads cost time


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    kw = dict(backend="cuda", device=args.device, cache_bytes=64 << 20,
              batch_shards=4)
    num_v, num_e, shards = 20_000, 200_000, 8
    with tempfile.TemporaryDirectory() as d:
        root = os.path.join(d, "store")
        ckdir = os.path.join(d, "warm")

        g = rmat_graph(num_v, num_e, seed=3)
        svc = GraphService.from_graph(g, root, num_shards=shards, **kw)
        svc.apply_updates(inserts=(np.array([1, 2]), np.array([3, 4]))).result()
        r0 = svc.query("bfs", 0)
        svc.save_warm_state(ckdir)
        svc.close()
        print(f"snapshot saved to {ckdir} at store version "
              f"{svc.engine.store.delta.version}")

        t0 = time.perf_counter()
        cold = GraphService.from_store(root, emulate_bw=BW, **kw)
        cold_wall = time.perf_counter() - t0
        io = cold.engine.loading_io
        print(f"cold boot: {cold_wall * 1e3:7.1f} ms  "
              f"({io.reads} reads, {io.bytes_read} bytes)")

        t0 = time.perf_counter()
        warm = GraphService.from_store(root, warm_state=ckdir, emulate_bw=BW, **kw)
        warm_wall = time.perf_counter() - t0
        rep = warm.warm_restore_report
        io = warm.engine.loading_io
        print(f"warm boot: {warm_wall * 1e3:7.1f} ms  "
              f"({io.reads} reads, {io.bytes_read} bytes)  "
              f"shards_warm={rep['shards_warm']}/{shards} "
              f"sessions={rep['sessions_restored']}")
        assert rep["valid"] and io.reads == 0

        hit = warm.query("bfs", 0)
        assert hit.cached and np.array_equal(hit.values, r0.values)
        print(f"repeat query after warm boot: cached={hit.cached}")
        a, b = warm.query("sssp", 7), cold.query("sssp", 7)
        assert np.array_equal(a.values, b.values)  # warm == cold, bitwise
        warm.close()

        cold.apply_updates(inserts=(np.array([5]), np.array([6]))).result()
        r_new = cold.query("bfs", 0)
        cold.close()
        stale = GraphService.from_store(root, warm_state=ckdir, **kw)
        rep = stale.warm_restore_report
        print(f"stale snapshot: shards_warm={rep['shards_warm']} "
              f"shards_stale={rep['shards_stale']} "
              f"sessions={rep['sessions_restored']}")
        assert rep["valid"] and rep["shards_stale"] >= 1
        assert rep["sessions_restored"] == 0
        r = stale.query("bfs", 0)
        assert not r.cached and np.array_equal(r.values, r_new.values)
        print("stale shards rejected, answers still correct: the store is "
              "authoritative.")
        stale.close()
        print("done.")


if __name__ == "__main__":
    main()
