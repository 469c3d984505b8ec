"""Out-of-core baseline engines: PSW (GraphChi), ESG (X-Stream), DSW (GridGraph).

The paper's headline claim is that VSW needs ``θ·D·|E|`` read + 0 write per
iteration while the baselines move vertices AND edge values through disk
every iteration (Table II).  To reproduce the comparison honestly these
engines perform *real* reads and writes through the same accounted
:class:`~repro_torch.core.storage.ShardStore` channel as VSW, and produce
*identical numerical results* (tests assert so).

They reproduce each system's **I/O schedule** — which files cross the disk
boundary, when, and how large — not its internal thread/buffer machinery.
Two deliberate deviations:

- GraphChi supports asynchronous (Gauss-Seidel) execution; we run its I/O
  schedule synchronously (Jacobi) so all engines compute identical
  per-iteration values.  I/O volume is unaffected.
- GridGraph uses a √P x √P grid; we derive √P chunks from the same VSW
  intervals so its ``C·√P·|V|`` vertex traffic term is reproduced.

Edge records are D = 8 bytes (src, dst int32), vertex/edge values C = 4
bytes (float32) — matching the paper's unweighted-graph setting.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List

import numpy as np

from ..apps import COMBINE_IDENTITY, VertexProgram
from ..graph import Graph
from ..sharding import GraphMeta, preprocess
from ..storage import ShardStore
from ..vsw import IterStats, RunResult

__all__ = ["PSWEngine", "ESGEngine", "DSWEngine", "prepare_baseline_store"]


def _scatter_reduce(acc: np.ndarray, idx: np.ndarray, vals: np.ndarray, combine: str):
    if combine == "sum":
        np.add.at(acc, idx, vals)
    elif combine == "min":
        np.minimum.at(acc, idx, vals)
    else:
        np.maximum.at(acc, idx, vals)


def _chunk_bounds(intervals: np.ndarray, q: int) -> np.ndarray:
    """Coarsen P interval boundaries into q chunk boundaries."""
    P = len(intervals) - 1
    picks = np.linspace(0, P, q + 1).round().astype(int)
    return intervals[picks]


def prepare_baseline_store(
    graph: Graph, root: str, *, num_shards: int, emulate_bw=None
) -> ShardStore:
    """Preprocess a graph into baseline-format files.

    Per (src-interval p, dst-interval q): ``blk_p_q`` with (src, dst) —
    PSW's shard blocks.  Per (src-chunk i, dst-chunk j) over √P chunks:
    ``dsw_grid_i_j`` — GridGraph's grid cells.  Per interval p:
    ``esg_out_p`` (out-edges of p) — X-Stream's streaming partitions.
    """
    meta, _ = preprocess(graph, num_shards=num_shards)
    store = ShardStore(root, emulate_bw=emulate_bw)
    store.write_meta(meta)
    iv = meta.intervals
    P = meta.num_shards
    Q = max(1, int(np.ceil(np.sqrt(P))))
    chunks = _chunk_bounds(iv, Q)
    store.write_aux("dsw_chunks", bounds=chunks)

    src_iv = np.searchsorted(iv, graph.src, side="right") - 1
    dst_iv = np.searchsorted(iv, graph.dst, side="right") - 1
    src_ch = np.searchsorted(chunks, graph.src, side="right") - 1
    dst_ch = np.searchsorted(chunks, graph.dst, side="right") - 1

    for p in range(P):
        m2 = src_iv == p
        store.write_aux(f"esg_out_{p}", src=graph.src[m2], dst=graph.dst[m2])
        for q in range(P):
            mb = m2 & (dst_iv == q)
            store.write_aux(f"blk_{p}_{q}", src=graph.src[mb], dst=graph.dst[mb])
    for i in range(Q):
        mi = src_ch == i
        for j in range(Q):
            mb = mi & (dst_ch == j)
            store.write_aux(f"dsw_grid_{i}_{j}", src=graph.src[mb], dst=graph.dst[mb])
    return store


class _BaselineBase:
    #: bounds key, vertex-file prefix
    def __init__(self, store: ShardStore):
        self.store = store
        self.meta = store.read_meta()

    # vertex files over arbitrary boundary arrays -------------------------
    def _init_vertex_files(
        self, program: VertexProgram, bounds: np.ndarray, prefix: str
    ) -> np.ndarray:
        vals, _ = program.init(self.meta)
        vals = vals.astype(np.float32)
        for p in range(len(bounds) - 1):
            self.store.write_aux(
                f"{prefix}_{p}", vals=vals[int(bounds[p]) : int(bounds[p + 1])]
            )
        return vals

    def _read_v(self, prefix: str, p: int) -> np.ndarray:
        return self.store.read_aux(f"{prefix}_{p}")["vals"]

    def _write_v(self, prefix: str, p: int, vals: np.ndarray) -> None:
        self.store.write_aux(f"{prefix}_{p}", vals=vals.astype(np.float32))

    def _finish_iter(self, it, t0, io0, old_vals, new_vals, processed) -> IterStats:
        dio = self.store.io - io0
        active = int((new_vals != old_vals).sum())
        return IterStats(
            iteration=it,
            time_s=time.perf_counter() - t0,
            shards_processed=processed,
            shards_skipped=0,
            bytes_read=dio.bytes_read,
            cache_hits=0,
            cache_misses=0,
            active_count=active,
            active_ratio=active / max(self.meta.num_vertices, 1),
            selective_on=False,
        )


class PSWEngine(_BaselineBase):
    """GraphChi's parallel-sliding-window I/O schedule (run synchronously).

    Edge records carry their message value inline (C+D bytes).  Gather pass:
    for each destination interval read its vertices + all column blocks with
    values.  Scatter pass: for each source interval, read-modify-write all
    row blocks with the new messages, and write the interval's vertices.
    Every edge is read twice and written twice per iteration at (C+D) bytes
    -> Table II row 1.
    """

    def run(self, program: VertexProgram, *, max_iters: int = 100) -> RunResult:
        meta, store, P = self.meta, self.store, self.meta.num_shards
        iv = meta.intervals
        vals = self._init_vertex_files(program, iv, "psw_vtx")
        # Data-loading scatter: edge values = pre(init vals) (not counted in iters).
        msgs0 = program.pre(vals, meta.out_deg).astype(np.float32)
        for p in range(P):
            for q in range(P):
                blk = store.read_aux(f"blk_{p}_{q}")
                store.write_aux(
                    f"psw_blk_{p}_{q}",
                    src=blk["src"], dst=blk["dst"], val=msgs0[blk["src"]],
                )
        stats: List[IterStats] = []
        converged = False

        for it in range(max_iters):
            t0, io0 = time.perf_counter(), store.io.snapshot()
            old_vals = vals.copy()
            new_vals = vals.copy()
            # ---- gather + update (reads edges once, with values)
            for q in range(P):
                v0, v1 = int(iv[q]), int(iv[q + 1])
                ivals = self._read_v("psw_vtx", q)
                acc = np.full(v1 - v0, COMBINE_IDENTITY[program.combine], np.float32)
                for p in range(P):
                    blk = store.read_aux(f"psw_blk_{p}_{q}")
                    _scatter_reduce(acc, blk["dst"] - v0, blk["val"], program.combine)
                upd = program.apply(acc, ivals, meta, v0)
                new_vals[v0:v1] = upd
                self._write_v("psw_vtx", q, upd)
            # ---- scatter (read-modify-writes edges once more, with values)
            full_msgs = program.pre(new_vals, meta.out_deg).astype(np.float32)
            for p in range(P):
                for q in range(P):
                    blk = store.read_aux(f"psw_blk_{p}_{q}")
                    store.write_aux(
                        f"psw_blk_{p}_{q}",
                        src=blk["src"], dst=blk["dst"], val=full_msgs[blk["src"]],
                    )
            vals = new_vals
            stats.append(self._finish_iter(it, t0, io0, old_vals, vals, P))
            if stats[-1].active_count == 0:
                converged = True
                break
        return RunResult(values=vals, iterations=stats, converged=converged)


class ESGEngine(_BaselineBase):
    """X-Stream's edge-centric scatter-gather I/O schedule.

    Phase 1 (scatter): per partition, read vertices, stream out-edges,
    spill (dst, msg) updates to each destination partition's update file.
    Phase 2 (gather): per partition, read its updates + vertices, apply,
    write vertices.
    """

    def run(self, program: VertexProgram, *, max_iters: int = 100) -> RunResult:
        meta, store, P = self.meta, self.store, self.meta.num_shards
        iv = meta.intervals
        vals = self._init_vertex_files(program, iv, "esg_vtx")
        stats: List[IterStats] = []
        converged = False

        for it in range(max_iters):
            t0, io0 = time.perf_counter(), store.io.snapshot()
            old_vals = vals.copy()
            # ---- scatter
            pending: Dict[int, list] = {q: [] for q in range(P)}
            for p in range(P):
                v0, v1 = int(iv[p]), int(iv[p + 1])
                pv = self._read_v("esg_vtx", p)
                full = np.zeros(meta.num_vertices, np.float32)
                full[v0:v1] = pv
                out = store.read_aux(f"esg_out_{p}")
                msgs = program.pre(full, meta.out_deg)[out["src"]]
                dst_iv = np.searchsorted(iv, out["dst"], "right") - 1
                for q in range(P):
                    m = dst_iv == q
                    if m.any():
                        pending[q].append((out["dst"][m], msgs[m]))
            for q in range(P):  # updates cross the disk boundary
                if pending[q]:
                    d = np.concatenate([x[0] for x in pending[q]])
                    u = np.concatenate([x[1] for x in pending[q]])
                else:
                    d, u = np.zeros(0, np.int32), np.zeros(0, np.float32)
                store.write_aux(f"esg_upd_{q}", dst=d, msg=u)
            # ---- gather
            new_vals = vals.copy()
            for q in range(P):
                v0, v1 = int(iv[q]), int(iv[q + 1])
                upd = store.read_aux(f"esg_upd_{q}")
                acc = np.full(v1 - v0, COMBINE_IDENTITY[program.combine], np.float32)
                _scatter_reduce(acc, upd["dst"] - v0, upd["msg"], program.combine)
                res = program.apply(acc, self._read_v("esg_vtx", q), meta, v0)
                new_vals[v0:v1] = res
                self._write_v("esg_vtx", q, res)
            vals = new_vals
            stats.append(self._finish_iter(it, t0, io0, old_vals, vals, P))
            if stats[-1].active_count == 0:
                converged = True
                break
        return RunResult(values=vals, iterations=stats, converged=converged)


class DSWEngine(_BaselineBase):
    """GridGraph's dual-sliding-window I/O schedule, column-major over a
    √P x √P grid.  Per destination chunk j: read chunk j, then for each
    source chunk i read vertices(i) and stream grid block (i, j); write
    chunk j once per column (the favourable write order — GridGraph's own;
    Table II's ``C√P|V|`` write is its worst case, see EXPERIMENTS.md)."""

    def run(self, program: VertexProgram, *, max_iters: int = 100) -> RunResult:
        meta, store = self.meta, self.store
        chunks = store.read_aux("dsw_chunks")["bounds"]
        Q = len(chunks) - 1
        vals = self._init_vertex_files(program, chunks, "dsw_vtx")
        stats: List[IterStats] = []
        converged = False

        for it in range(max_iters):
            t0, io0 = time.perf_counter(), store.io.snapshot()
            old_vals = vals.copy()
            new_vals = vals.copy()
            for j in range(Q):
                v0, v1 = int(chunks[j]), int(chunks[j + 1])
                dvals = self._read_v("dsw_vtx", j)
                acc = np.full(v1 - v0, COMBINE_IDENTITY[program.combine], np.float32)
                for i in range(Q):
                    u0, u1 = int(chunks[i]), int(chunks[i + 1])
                    svals = self._read_v("dsw_vtx", i)
                    full = np.zeros(meta.num_vertices, np.float32)
                    full[u0:u1] = svals
                    blk = store.read_aux(f"dsw_grid_{i}_{j}")
                    msgs = program.pre(full, meta.out_deg)[blk["src"]]
                    _scatter_reduce(acc, blk["dst"] - v0, msgs, program.combine)
                res = program.apply(acc, dvals, meta, v0)
                new_vals[v0:v1] = res
                # Double-buffered write: later columns must still read this
                # iteration's *input* values for chunk j (Jacobi semantics).
                self._write_v("dsw_vtx_new", j, res)
            for j in range(Q):  # publish: rename is metadata-only, no data I/O
                os.replace(
                    store._path(f"aux_dsw_vtx_new_{j}.npz"),
                    store._path(f"aux_dsw_vtx_{j}.npz"),
                )
            vals = new_vals
            stats.append(self._finish_iter(it, t0, io0, old_vals, vals, Q * Q))
            if stats[-1].active_count == 0:
                converged = True
                break
        return RunResult(values=vals, iterations=stats, converged=converged)
