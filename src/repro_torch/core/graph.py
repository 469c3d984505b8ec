"""Graph container and synthetic graph generators.

A :class:`Graph` is the in-memory edge-list representation used by the
preprocessing phase (GraphMP paper §II-B).  Vertex ids are dense ``int32``
in ``[0, num_vertices)``.  Graphs are unweighted, exactly as in the paper
(``val(u, v) = 1`` for every edge).

Generators produce the power-law graphs the paper evaluates on (Twitter,
UK-2007, ... are power-law web/social graphs); we use RMAT with the standard
(a, b, c, d) = (0.57, 0.19, 0.19, 0.05) parameters plus a uniform generator
for non-skewed baselines.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = [
    "Graph",
    "rmat_graph",
    "uniform_graph",
    "chain_graph",
    "star_graph",
    "from_edge_list",
]


@dataclasses.dataclass
class Graph:
    """An unweighted directed graph as parallel ``src``/``dst`` arrays."""

    num_vertices: int
    src: np.ndarray  # int32 [num_edges]
    dst: np.ndarray  # int32 [num_edges]

    def __post_init__(self) -> None:
        self.src = np.asarray(self.src, dtype=np.int32)
        self.dst = np.asarray(self.dst, dtype=np.int32)
        if self.src.shape != self.dst.shape:
            raise ValueError(
                f"src/dst length mismatch: {self.src.shape} vs {self.dst.shape}"
            )

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def avg_degree(self) -> float:
        return self.num_edges / max(self.num_vertices, 1)

    def out_degrees(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.num_vertices).astype(np.int64)

    def in_degrees(self) -> np.ndarray:
        return np.bincount(self.dst, minlength=self.num_vertices).astype(np.int64)

    def dedup(self) -> "Graph":
        """Remove duplicate edges (and self-loops are kept, as in the paper)."""
        key = self.src.astype(np.int64) * self.num_vertices + self.dst
        _, idx = np.unique(key, return_index=True)
        return Graph(self.num_vertices, self.src[idx], self.dst[idx])

    def reverse(self) -> "Graph":
        return Graph(self.num_vertices, self.dst.copy(), self.src.copy())

    def validate(self) -> None:
        if self.num_edges:
            for name, arr in (("src", self.src), ("dst", self.dst)):
                lo, hi = int(arr.min()), int(arr.max())
                if lo < 0 or hi >= self.num_vertices:
                    raise ValueError(
                        f"{name} ids out of range [0, {self.num_vertices}): "
                        f"min={lo} max={hi}"
                    )


def from_edge_list(edges, num_vertices: Optional[int] = None) -> Graph:
    """Build a graph from an iterable of ``(src, dst)`` pairs."""
    arr = np.asarray(list(edges), dtype=np.int64)
    if arr.size == 0:
        arr = arr.reshape(0, 2)
    n = int(num_vertices if num_vertices is not None else (arr.max() + 1 if arr.size else 0))
    g = Graph(n, arr[:, 0].astype(np.int32), arr[:, 1].astype(np.int32))
    g.validate()
    return g


def rmat_graph(
    num_vertices: int,
    num_edges: int,
    *,
    seed: int = 0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    dedup: bool = False,
) -> Graph:
    """RMAT power-law generator (Graph500 parameters by default).

    Vertex count is rounded up to a power of two internally; ids above
    ``num_vertices - 1`` are folded back with a modulo so the advertised
    vertex count is exact.
    """
    rng = np.random.default_rng(seed)
    scale = max(int(np.ceil(np.log2(max(num_vertices, 2)))), 1)
    src = np.zeros(num_edges, dtype=np.int64)
    dst = np.zeros(num_edges, dtype=np.int64)
    ab, abc = a + b, a + b + c
    for level in range(scale):
        r = rng.random(num_edges)
        right = r >= ab  # quadrants c or d -> src bit set
        lower = ((r >= a) & (r < ab)) | (r >= abc)  # quadrants b or d -> dst bit set
        src |= right.astype(np.int64) << level
        dst |= lower.astype(np.int64) << level
    src %= num_vertices
    dst %= num_vertices
    g = Graph(num_vertices, src.astype(np.int32), dst.astype(np.int32))
    if dedup:
        g = g.dedup()
    return g


def uniform_graph(num_vertices: int, num_edges: int, *, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_vertices, size=num_edges, dtype=np.int64)
    dst = rng.integers(0, num_vertices, size=num_edges, dtype=np.int64)
    return Graph(num_vertices, src.astype(np.int32), dst.astype(np.int32))


def chain_graph(num_vertices: int) -> Graph:
    """0 -> 1 -> 2 -> ... — worst case for label-propagation convergence."""
    src = np.arange(num_vertices - 1, dtype=np.int32)
    return Graph(num_vertices, src, src + 1)


def star_graph(num_vertices: int) -> Graph:
    """All vertices point at vertex 0 — a single max-in-degree hub."""
    src = np.arange(1, num_vertices, dtype=np.int32)
    dst = np.zeros(num_vertices - 1, dtype=np.int32)
    return Graph(num_vertices, src, dst)


def small_world_graph(
    num_vertices: int, k: int = 4, shortcuts: float = 0.01, *, seed: int = 0
) -> Graph:
    """Ring + k-nearest + sparse random shortcuts (Watts-Strogatz-ish).

    High diameter (O(n / (n*shortcuts)) hops) makes SSSP/WCC run for many
    iterations with a travelling activity frontier — the regime where the
    paper's selective scheduling shines (Fig. 5b/5c).
    """
    rng = np.random.default_rng(seed)
    base = np.arange(num_vertices, dtype=np.int64)
    srcs, dsts = [], []
    for off in range(1, k + 1):
        srcs.append(base)
        dsts.append((base + off) % num_vertices)
        srcs.append((base + off) % num_vertices)
        dsts.append(base)
    n_short = int(num_vertices * shortcuts)
    if n_short:
        s = rng.integers(0, num_vertices, n_short)
        d = rng.integers(0, num_vertices, n_short)
        srcs.append(s)
        dsts.append(d)
    return Graph(
        num_vertices,
        np.concatenate(srcs).astype(np.int32),
        np.concatenate(dsts).astype(np.int32),
    )
