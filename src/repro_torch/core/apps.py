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
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from .sharding import GraphMeta

__all__ = ["VertexProgram", "pagerank", "sssp", "wcc", "bfs",
           "personalized_pagerank", "degree_centrality", "get_program",
           "COMBINE_IDENTITY", "LaneProgram", "lane_sssp", "lane_bfs",
           "lane_wcc", "lane_ppr", "get_lane_program"]

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


# --------------------------------------------------------------------------
# Lane-vectorized programs (serving layer)
# --------------------------------------------------------------------------
# A serving sweep runs K per-source queries as K *lanes* of one sweep:
# vertex state is (K, n) and one shard load feeds every lane.  The source
# vertex is carried explicitly through ``apply`` so lanes can retire and be
# backfilled mid-sweep.  Lanes of different programs sharing a combine
# algebra (``combine_key``) share one lane matrix — the lane table applies
# each lane's own ``pre``/``apply`` — so BFS, SSSP and WCC fuse.


@dataclasses.dataclass
class LaneProgram:
    """One per-source graph application, vectorized over K query lanes.

    Attributes:
      combine:   monoid over in-edge messages (same as VertexProgram).
      key:       full static identity (program name and static parameters,
                 e.g. PPR damping); the session cache and the lane table's
                 ``pre``/``apply`` grouping key on it.
      combine_key: fusion key, coarser than ``key``: lanes whose programs
                 share it may share one lane matrix.  Defaults to
                 ``(combine,)``.
      pre:       (vals [K, n], out_deg [n]) -> messages [K, n].
      apply:     (acc [K, rows], old [K, rows], meta, v0, sources [K]) ->
                 new [K, rows]; ``sources[k]`` is lane k's query source.
      init_lane: (meta, source) -> (vals [n], active [n]) for ONE lane.
      is_active: (new, old) -> bool [K, n]; exact inequality.
    """

    name: str
    combine: str
    key: Tuple
    pre: Callable[[np.ndarray, np.ndarray], np.ndarray]
    apply: Callable[..., np.ndarray]
    init_lane: Callable[[GraphMeta, int], Tuple[np.ndarray, np.ndarray]]
    combine_key: Optional[Tuple] = None
    is_active: Callable[[np.ndarray, np.ndarray], np.ndarray] = (
        lambda new, old: new != old
    )

    def __post_init__(self) -> None:
        if self.combine_key is None:
            self.combine_key = (self.combine,)

    @property
    def identity(self) -> float:
        return COMBINE_IDENTITY[self.combine]


def _lane_min_distance(name: str) -> LaneProgram:
    """Shared lane algebra of unit-weight SSSP / BFS levels."""

    def pre(vals: np.ndarray, out_deg: np.ndarray) -> np.ndarray:
        return vals + np.asarray(1.0, dtype=vals.dtype)

    def apply(acc, old, meta, v0=0, sources=None):
        return np.minimum(acc, old).astype(old.dtype)

    def init_lane(meta: GraphMeta, source: int):
        vals = np.full(meta.num_vertices, np.inf, dtype=np.float32)
        vals[source] = 0.0
        active = np.zeros(meta.num_vertices, dtype=bool)
        active[source] = True
        return vals, active

    return LaneProgram(name, "min", (name,), pre, apply, init_lane)


def lane_sssp() -> LaneProgram:
    """Lane-vectorized unit-weight SSSP (one source per lane)."""
    return _lane_min_distance("sssp")


def lane_bfs() -> LaneProgram:
    """Lane-vectorized BFS levels — identical algebra to unit-weight SSSP."""
    return _lane_min_distance("bfs")


def lane_wcc() -> LaneProgram:
    """Lane-vectorized WCC label propagation (min component id).  The query
    ``source`` is ignored: every lane computes the full labelling, op for
    op as :func:`wcc`, and fuses with BFS/SSSP."""

    def pre(vals: np.ndarray, out_deg: np.ndarray) -> np.ndarray:
        return vals

    def apply(acc, old, meta, v0=0, sources=None):
        return np.minimum(acc, old).astype(old.dtype)

    def init_lane(meta: GraphMeta, source: int):
        vals = np.arange(meta.num_vertices, dtype=np.float32)
        return vals, np.ones(meta.num_vertices, dtype=bool)

    return LaneProgram("wcc", "min", ("wcc",), pre, apply, init_lane)


def lane_ppr(damping: float = 0.85) -> LaneProgram:
    """Lane-vectorized personalized PageRank: each lane's teleport mass
    returns to that lane's source.  Op for op as
    :func:`personalized_pagerank` (same multiply, same in-place add at the
    source slot), so a lane is bitwise its single-query run."""

    def pre(vals: np.ndarray, out_deg: np.ndarray) -> np.ndarray:
        return vals / np.maximum(out_deg, 1).astype(vals.dtype)

    def apply(acc, old, meta, v0=0, sources=None):
        out = (damping * acc).astype(old.dtype)
        if sources is not None:
            local = np.asarray(sources, dtype=np.int64) - v0
            lanes = np.flatnonzero((local >= 0) & (local < out.shape[1]))
            out[lanes, local[lanes]] += np.float32(1.0 - damping)
        return out

    def init_lane(meta: GraphMeta, source: int):
        vals = np.zeros(meta.num_vertices, dtype=np.float32)
        vals[source] = 1.0
        return vals, np.ones(meta.num_vertices, dtype=bool)

    return LaneProgram("ppr", "sum", ("ppr", float(damping)), pre, apply,
                       init_lane)


LANE_PROGRAMS: Dict[str, Callable[..., LaneProgram]] = {
    "bfs": lane_bfs,
    "sssp": lane_sssp,
    "wcc": lane_wcc,
    "ppr": lane_ppr,
}


def get_lane_program(name: str, **kwargs) -> LaneProgram:
    """Factory for lane-vectorized per-source programs (serving layer)."""
    if name not in LANE_PROGRAMS:
        raise KeyError(
            f"unknown lane program {name!r}; have {sorted(LANE_PROGRAMS)}"
        )
    return LANE_PROGRAMS[name](**kwargs)


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
