"""Graph sharding and preprocessing (GraphMP paper §II-B).

The input graph's vertices are divided into ``P`` disjoint intervals.  Each
interval is associated with a *shard* holding every edge whose destination
vertex lies in that interval, grouped by destination and stored in CSR
(row-offset + column-index) form.  Intervals are chosen so that

1. any shard can be completely loaded into (V)MEM, and
2. the number of edges per shard is balanced.

The paper's four preprocessing steps map 1:1 onto :func:`preprocess`:

1. scan the graph, record in/out degrees            -> ``Graph.in_degrees`` etc.
2. compute vertex intervals (balance + size cap)    -> :func:`compute_intervals`
3. append each edge to a shard by destination       -> :func:`build_shards`
4. transform shards to CSR, persist metadata        -> :class:`ShardCSR`, stores

On top of the paper's CSR we also derive the device format (blocked-ELL
with source windows, see ``csr.py``) during preprocessing, so the runtime
engine never touches raw edge lists.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from .graph import Graph

__all__ = [
    "ShardCSR",
    "GraphMeta",
    "compute_intervals",
    "build_shards",
    "preprocess",
]


@dataclasses.dataclass
class ShardCSR:
    """One destination-interval shard in CSR form.

    ``row`` has ``(v1 - v0) + 1`` entries; the incoming adjacency list of
    vertex ``v`` (``v0 <= v < v1``) is ``col[row[v - v0] : row[v - v0 + 1]]``
    — exactly the paper's ``Γ_in(v)`` access equation.
    """

    shard_id: int
    v0: int  # interval start (inclusive)
    v1: int  # interval end (exclusive)
    row: np.ndarray  # int64 [rows + 1]
    col: np.ndarray  # int32 [nnz] source vertex ids, grouped by destination

    @property
    def rows(self) -> int:
        return self.v1 - self.v0

    @property
    def nnz(self) -> int:
        return int(self.col.shape[0])

    @property
    def nbytes(self) -> int:
        return int(self.row.nbytes + self.col.nbytes)

    def in_neighbors(self, v: int) -> np.ndarray:
        """Γ_in(v) = col[row[v - v0] : row[v - v0 + 1]]."""
        if not (self.v0 <= v < self.v1):
            raise IndexError(f"vertex {v} outside interval [{self.v0}, {self.v1})")
        lo = int(self.row[v - self.v0])
        hi = int(self.row[v - self.v0 + 1])
        return self.col[lo:hi]

    def unique_sources(self) -> np.ndarray:
        return np.unique(self.col)


@dataclasses.dataclass
class GraphMeta:
    """The paper's 'property file' + 'vertex information file' contents."""

    num_vertices: int
    num_edges: int
    num_shards: int
    intervals: np.ndarray  # int64 [num_shards + 1], interval p = [iv[p], iv[p+1])
    in_deg: np.ndarray  # int64 [num_vertices]
    out_deg: np.ndarray  # int64 [num_vertices]

    def interval_of(self, p: int) -> tuple:
        return int(self.intervals[p]), int(self.intervals[p + 1])

    def shard_of_vertex(self, v: int) -> int:
        return int(np.searchsorted(self.intervals, v, side="right") - 1)


def compute_intervals(
    in_deg: np.ndarray,
    *,
    num_shards: Optional[int] = None,
    edges_per_shard: Optional[int] = None,
) -> np.ndarray:
    """Choose interval boundaries so each shard holds ~equal numbers of edges.

    Exactly one of ``num_shards`` / ``edges_per_shard`` must be given (the
    paper targets 18-22M edges so one shard ~= 80MB; tests use far smaller
    targets).  A single vertex whose in-degree exceeds the target still gets
    its own interval — shards may exceed the target by at most one vertex's
    in-degree, as in GraphChi-style sharding.
    """
    num_vertices = int(in_deg.shape[0])
    num_edges = int(in_deg.sum())
    if (num_shards is None) == (edges_per_shard is None):
        raise ValueError("specify exactly one of num_shards / edges_per_shard")
    if num_shards is None:
        num_shards = max(1, int(np.ceil(num_edges / max(edges_per_shard, 1))))
    num_shards = min(num_shards, max(num_vertices, 1))

    if num_shards == 1 or num_edges == 0:
        # Degenerate: everything in one shard (still balanced vacuously).
        bounds = np.linspace(0, num_vertices, num_shards + 1).astype(np.int64)
        bounds[0], bounds[-1] = 0, num_vertices
        return np.unique(bounds) if len(np.unique(bounds)) == num_shards + 1 else np.array(
            [0, num_vertices], dtype=np.int64
        )

    target = num_edges / num_shards
    cum = np.cumsum(in_deg, dtype=np.int64)
    # boundary p = first vertex where cumulative edges >= p * target
    marks = (np.arange(1, num_shards, dtype=np.float64) * target).astype(np.int64)
    cuts = np.searchsorted(cum, marks, side="left") + 1
    bounds = np.concatenate([[0], cuts, [num_vertices]]).astype(np.int64)
    bounds = np.maximum.accumulate(bounds)  # monotone
    bounds = np.unique(bounds)
    if bounds[0] != 0:
        bounds = np.concatenate([[0], bounds])
    if bounds[-1] != num_vertices:
        bounds = np.concatenate([bounds, [num_vertices]])
    return bounds.astype(np.int64)


def build_shards(graph: Graph, intervals: np.ndarray) -> List[ShardCSR]:
    """Steps 3+4: route edges to shards by destination, emit CSR per shard.

    Edges inside a shard are grouped by destination (GraphMP groups by
    destination, unlike GraphChi's source order) with sources sorted within
    each destination for determinism.
    """
    order = np.lexsort((graph.src, graph.dst))
    dst_sorted = graph.dst[order]
    src_sorted = graph.src[order]
    num_shards = len(intervals) - 1

    # Per-vertex incoming counts -> global row offsets.
    in_deg = np.bincount(graph.dst, minlength=graph.num_vertices).astype(np.int64)
    global_row = np.concatenate([[0], np.cumsum(in_deg)])

    shards: List[ShardCSR] = []
    for p in range(num_shards):
        v0, v1 = int(intervals[p]), int(intervals[p + 1])
        lo, hi = int(global_row[v0]), int(global_row[v1])
        row = (global_row[v0 : v1 + 1] - global_row[v0]).astype(np.int64)
        col = src_sorted[lo:hi].astype(np.int32)
        # dst_sorted[lo:hi] is guaranteed to lie in [v0, v1) by construction.
        assert hi == lo or (dst_sorted[lo] >= v0 and dst_sorted[hi - 1] < v1)
        shards.append(ShardCSR(shard_id=p, v0=v0, v1=v1, row=row, col=col))
    return shards


def preprocess(
    graph: Graph,
    *,
    num_shards: Optional[int] = None,
    edges_per_shard: Optional[int] = None,
) -> tuple:
    """Full preprocessing: returns ``(GraphMeta, [ShardCSR])``."""
    graph.validate()
    in_deg = graph.in_degrees()
    out_deg = graph.out_degrees()
    intervals = compute_intervals(
        in_deg, num_shards=num_shards, edges_per_shard=edges_per_shard
    )
    shards = build_shards(graph, intervals)
    meta = GraphMeta(
        num_vertices=graph.num_vertices,
        num_edges=graph.num_edges,
        num_shards=len(shards),
        intervals=intervals,
        in_deg=in_deg,
        out_deg=out_deg,
    )
    # Invariants the rest of the system relies on.
    assert sum(s.nnz for s in shards) == graph.num_edges
    assert all(shards[p].v1 == shards[p + 1].v0 for p in range(len(shards) - 1))
    return meta, shards
