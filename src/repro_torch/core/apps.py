"""Vertex programs (paper Algorithm 2): PageRank, SSSP, WCC (+ extras).

GraphMP's user API is a pull-mode ``Update(v, SrcVertexArray)`` returning the
new value and an activity bit.  All three of the paper's applications share
one algebraic shape::

    acc(v)  = COMBINE_{u in Γ_in(v)}  pre(val(u))     # gather along in-edges
    new(v)  = apply(acc(v), val(v))                   # vertex update
    active  = new(v) != val(v)

where COMBINE is an associative/commutative monoid (sum for PageRank, min
for SSSP/WCC).  We factor the per-edge message into an O(|V|) elementwise
``pre`` pass over the source array (e.g. PageRank's ``val/out_deg`` division
is hoisted out of the edge loop — same math as Alg. 2 line 3, one divide per
vertex instead of per edge), so the per-shard hot loop is a pure
gather+combine that the device kernels implement.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np

from .sharding import GraphMeta

__all__ = ["VertexProgram", "pagerank", "sssp", "wcc", "bfs",
           "personalized_pagerank", "degree_centrality", "get_program",
           "COMBINE_IDENTITY"]

COMBINE_IDENTITY = {"sum": 0.0, "min": np.inf, "max": -np.inf}


@dataclasses.dataclass
class VertexProgram:
    """One pull-mode graph application.

    Attributes:
      combine: monoid over in-edge messages ("sum" | "min" | "max").
      pre:     (src_vals, out_deg) -> per-source message values, O(|V|).
      apply:   (acc, old_vals, meta, v0) -> new interval values (v0 = the
               interval's first global vertex id, for index-aware apps).
      init:    meta -> (initial values [|V|], initial active mask [|V|]).
      is_active: (new, old) -> bool mask; the paper uses exact inequality.
    """

    name: str
    combine: str
    pre: Callable[[np.ndarray, np.ndarray], np.ndarray]
    apply: Callable[[np.ndarray, np.ndarray, GraphMeta], np.ndarray]
    init: Callable[[GraphMeta], Tuple[np.ndarray, np.ndarray]]
    is_active: Callable[[np.ndarray, np.ndarray], np.ndarray] = (
        lambda new, old: new != old
    )
    dtype: type = np.float32

    @property
    def identity(self) -> float:
        return COMBINE_IDENTITY[self.combine]


def pagerank(damping: float = 0.85) -> VertexProgram:
    """acc = Σ val(u)/out_deg(u);  new = (1-d)/|V| + d·acc  (Alg. 2 lines 1-5)."""

    def pre(src_vals: np.ndarray, out_deg: np.ndarray) -> np.ndarray:
        return src_vals / np.maximum(out_deg, 1).astype(src_vals.dtype)

    def apply(acc: np.ndarray, old: np.ndarray, meta: GraphMeta, v0: int = 0) -> np.ndarray:
        base = np.asarray((1.0 - damping) / meta.num_vertices, dtype=acc.dtype)
        return (base + damping * acc).astype(old.dtype)

    def init(meta: GraphMeta):
        vals = np.full(meta.num_vertices, 1.0 / meta.num_vertices, dtype=np.float32)
        return vals, np.ones(meta.num_vertices, dtype=bool)

    return VertexProgram("pagerank", "sum", pre, apply, init)


def sssp(source: int = 0) -> VertexProgram:
    """Unit-weight SSSP (paper: val(u,v)=1): new = min(min_u d(u)+1, old)."""

    def pre(src_vals: np.ndarray, out_deg: np.ndarray) -> np.ndarray:
        return src_vals + np.asarray(1.0, dtype=src_vals.dtype)

    def apply(acc: np.ndarray, old: np.ndarray, meta: GraphMeta, v0: int = 0) -> np.ndarray:
        return np.minimum(acc, old).astype(old.dtype)

    def init(meta: GraphMeta):
        vals = np.full(meta.num_vertices, np.inf, dtype=np.float32)
        vals[source] = 0.0
        active = np.zeros(meta.num_vertices, dtype=bool)
        active[source] = True
        return vals, active

    return VertexProgram(f"sssp", "min", pre, apply, init)


def wcc() -> VertexProgram:
    """Weakly-connected components by label propagation of the min id.

    Note: as in the paper's Alg. 2, labels propagate along *in-edges* of the
    (directed) shard layout; run on a symmetrised graph for true WCC.
    """

    def pre(src_vals: np.ndarray, out_deg: np.ndarray) -> np.ndarray:
        return src_vals

    def apply(acc: np.ndarray, old: np.ndarray, meta: GraphMeta, v0: int = 0) -> np.ndarray:
        return np.minimum(acc, old).astype(old.dtype)

    def init(meta: GraphMeta):
        vals = np.arange(meta.num_vertices, dtype=np.float32)
        return vals, np.ones(meta.num_vertices, dtype=bool)

    return VertexProgram("wcc", "min", pre, apply, init)


def bfs(source: int = 0) -> VertexProgram:
    """BFS levels — identical algebra to unit-weight SSSP."""
    p = sssp(source)
    return dataclasses.replace(p, name="bfs")


def personalized_pagerank(
    source: int = 0, damping: float = 0.85
) -> VertexProgram:
    """PPR: the teleport mass returns to ``source`` instead of spreading
    uniformly — exercises the paper's claim that the Update API covers
    arbitrary vertex-centric applications (§II-C-2)."""

    def pre(src_vals: np.ndarray, out_deg: np.ndarray) -> np.ndarray:
        return src_vals / np.maximum(out_deg, 1).astype(src_vals.dtype)

    def apply(acc: np.ndarray, old: np.ndarray, meta: GraphMeta, v0: int = 0) -> np.ndarray:
        return (damping * acc).astype(old.dtype)  # base added at source only

    def init(meta: GraphMeta):
        vals = np.zeros(meta.num_vertices, dtype=np.float32)
        vals[source] = 1.0
        return vals, np.ones(meta.num_vertices, dtype=bool)

    def apply_with_teleport(acc, old, meta, v0=0):
        out = (damping * acc).astype(old.dtype)
        idx = source - v0
        if 0 <= idx < len(out):
            out[idx] = out[idx] + np.float32(1.0 - damping)
        return out

    return VertexProgram("ppr", "sum", pre, apply_with_teleport, init)


def degree_centrality() -> VertexProgram:
    """In-degree counting as a one-iteration pull program (sanity app)."""

    def pre(src_vals: np.ndarray, out_deg: np.ndarray) -> np.ndarray:
        return np.ones_like(src_vals)

    def apply(acc: np.ndarray, old: np.ndarray, meta: GraphMeta, v0: int = 0) -> np.ndarray:
        return acc.astype(old.dtype)

    def init(meta: GraphMeta):
        return (
            np.zeros(meta.num_vertices, dtype=np.float32),
            np.ones(meta.num_vertices, dtype=bool),
        )

    return VertexProgram("degree", "sum", pre, apply, init)


_REGISTRY: Dict[str, Callable[..., VertexProgram]] = {
    "pagerank": pagerank,
    "sssp": sssp,
    "wcc": wcc,
    "bfs": bfs,
    "ppr": personalized_pagerank,
    "degree": degree_centrality,
}


def get_program(name: str, **kwargs) -> VertexProgram:
    if name not in _REGISTRY:
        raise KeyError(f"unknown program {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)
