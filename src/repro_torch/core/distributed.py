"""Distributed VSW: the paper's engine over several devices.

GraphMP is a single-machine system; its SEM contract ("all vertices resident
in fast memory, edges streamed") maps onto D devices as follows (DESIGN.md
§5, §10):

- ``SrcVertexArray`` / ``DstVertexArray`` are **split by vertex interval**
  over the devices (:func:`equal_device_bounds`): each device owns
  ``|V| / D`` destination vertices and all edge shards whose destination
  interval falls in its slice.  The paper's lock-free property survives:
  each destination vertex is updated by exactly one device.
- Per superstep, the per-source messages (``pre(src_vals)``) are computed
  on each device's slice and **all-gathered**, so every device holds the
  full message array — the distributed analogue of "all vertices in
  memory".
- Each device then runs the gather/combine over its own edge block; the
  iteration's activity count is summed over the devices.

Two ways to run it:

- the host part (:class:`MeshPartition`, :func:`build_device_graph`,
  :func:`build_device_graph_from_store`) is numpy, bitwise the reference's
  on the same store; the engine's and the service's ``mesh=`` path
  (:class:`~repro_torch.core.executor.MeshLaneExecutor`) use it from one
  process that drives every device;
- :func:`make_superstep` / :func:`run_distributed` run one rank per device
  over ``torch.distributed`` (gloo on the CPU, NCCL on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs import trace
from .apps import VertexProgram
from .csr import csr_to_ell
from .graph import Graph
from .sharding import GraphMeta, ShardCSR, build_shards

__all__ = [
    "DeviceGraph",
    "MeshPartition",
    "equal_device_bounds",
    "build_device_graph",
    "build_device_graph_from_store",
    "preprocess_with_bounds",
    "device_graph_specs",
    "make_superstep",
    "run_distributed",
]


@dataclasses.dataclass
class DeviceGraph:
    """Per-device-stacked ELL arrays + vertex metadata (all padded/equal)."""

    num_vertices: int  # padded to n_dev * rows_per_dev
    num_vertices_real: int
    rows_per_dev: int
    n_dev: int
    window: int
    k: int
    tr: int
    n_ell_per_dev: int
    ell_idx: np.ndarray  # [n_dev * n_ell_per_dev, K] int32 (global src ids)
    ell_valid: np.ndarray  # [n_dev * n_ell_per_dev, K] bool
    seg: np.ndarray  # [n_dev * n_ell_per_dev] int32 local dst row
    out_deg: np.ndarray  # [num_vertices] int32 (padded with 1)


def equal_device_bounds(num_vertices: int, n_dev: int):
    """THE device vertex layout: ``(rows_per_dev, nv_pad, bounds)``.

    Every mesh consumer — the in-memory builder, the store-backed builder
    and the engine's :class:`MeshPartition` — derives its destination
    interval ownership from this one function.  Bounds are clipped to the
    real vertex count; trailing devices own the (edge-free) padding rows.
    """
    if n_dev < 1:
        raise ValueError("n_dev must be >= 1")
    rows_per_dev = -(-num_vertices // n_dev)
    nv_pad = rows_per_dev * n_dev
    bounds = np.minimum(
        np.arange(n_dev + 1, dtype=np.int64) * rows_per_dev, num_vertices
    )
    return rows_per_dev, nv_pad, bounds


@dataclasses.dataclass(frozen=True)
class MeshPartition:
    """Shard -> device ownership for mesh sweeps over an existing store.

    The store's destination intervals are NOT re-cut: every store shard is
    owned by exactly ONE device (the one whose equal vertex slice holds the
    shard's interval start), so device ``d`` alone writes the destination
    rows of the shards it owns, and the host reads each shard once per
    sweep and routes it to one device slot — "1 host read, D device
    slices" (DESIGN.md §10).
    """

    n_dev: int
    num_shards: int
    owner: np.ndarray  # [num_shards] int32 owning device per shard

    @classmethod
    def from_meta(cls, meta, n_dev: int) -> "MeshPartition":
        """Own each shard by the equal device slice holding its interval
        start (:func:`equal_device_bounds` on ``meta.num_vertices``)."""
        rows_per_dev, _, _ = equal_device_bounds(meta.num_vertices, n_dev)
        starts = np.asarray(meta.intervals[:-1], dtype=np.int64)
        owner = np.minimum(starts // rows_per_dev, n_dev - 1).astype(np.int32)
        return cls(n_dev=n_dev, num_shards=int(meta.num_shards), owner=owner)

    def device_of(self, shard_id: int) -> int:
        return int(self.owner[shard_id])

    def group(self, shard_ids: Sequence[int]) -> List[List[int]]:
        """Split an ordered shard list into per-device ordered sublists;
        devices whose shards were all pruned get an empty list."""
        out: List[List[int]] = [[] for _ in range(self.n_dev)]
        for p in shard_ids:
            out[int(self.owner[p])].append(p)
        return out

    @staticmethod
    def interleave(device_lists: Sequence[Sequence[int]]) -> List[int]:
        """Round-robin merge (d0[0], d1[0], ..., d0[1], ...) so a streaming
        consumer that buffers shards per device fills every device's slot
        before it flushes a round."""
        out: List[int] = []
        longest = max((len(g) for g in device_lists), default=0)
        for i in range(longest):
            for g in device_lists:
                if i < len(g):
                    out.append(g[i])
        return out


def build_device_graph(
    graph: Graph,
    n_dev: int,
    *,
    window: int = 1 << 14,
    k: int = 128,
    tr: int = 8,
) -> DeviceGraph:
    """Partition a real graph into equal per-device ELL blocks."""
    rows_per_dev, nv_pad, bounds = equal_device_bounds(graph.num_vertices, n_dev)
    _, shards = preprocess_with_bounds(graph, bounds)
    return _device_graph_from_shards(
        shards, graph.num_vertices, rows_per_dev, nv_pad, n_dev,
        graph.out_degrees(), window=window, k=k, tr=tr,
    )


def _device_graph_from_shards(
    shards, num_vertices: int, rows_per_dev: int, nv_pad: int, n_dev: int,
    out_degrees: np.ndarray, *, window: int, k: int, tr: int,
) -> DeviceGraph:
    """Shared tail of both builders: per-device CSR shards -> stacked ELL."""
    ells = [csr_to_ell(s, nv_pad, window=window, k=k, tr=tr) for s in shards]
    n_ell_max = max(e.n_ell for e in ells)
    n_ell_pad = -(-n_ell_max // tr) * tr

    idx = np.zeros((n_dev, n_ell_pad, k), dtype=np.int32)
    valid = np.zeros((n_dev, n_ell_pad, k), dtype=bool)
    seg = np.zeros((n_dev, n_ell_pad), dtype=np.int32)
    for d, e in enumerate(ells):
        gi = e.global_idx().astype(np.int32)
        idx[d, : e.n_ell] = np.where(e.ell_mask, gi, 0)
        valid[d, : e.n_ell] = e.ell_mask
        seg[d, : e.n_ell] = e.seg

    out_deg = np.ones(nv_pad, dtype=np.int32)
    out_deg[:num_vertices] = out_degrees.astype(np.int32)

    return DeviceGraph(
        num_vertices=nv_pad,
        num_vertices_real=num_vertices,
        rows_per_dev=rows_per_dev,
        n_dev=n_dev,
        window=window,
        k=k,
        tr=tr,
        n_ell_per_dev=n_ell_pad,
        ell_idx=idx.reshape(n_dev * n_ell_pad, k),
        ell_valid=valid.reshape(n_dev * n_ell_pad, k),
        seg=seg.reshape(n_dev * n_ell_pad),
        out_deg=out_deg,
    )


def build_device_graph_from_store(
    store,
    n_dev: int,
    *,
    window: Optional[int] = None,
    k: Optional[int] = None,
    tr: Optional[int] = None,
) -> DeviceGraph:
    """Per-device ELL blocks straight from a :class:`ShardStore` — no
    ``Graph`` object, no full edge list in memory.

    Store shards are decoded ONE at a time and their destination rows are
    re-cut along :func:`equal_device_bounds`; each store shard's row/col
    slices land in at most two adjacent device shards (intervals are
    ordered), so the concatenated per-device CSR is bitwise the one
    :func:`build_device_graph` builds from the same edges.  ELL parameters
    default to the store's own (``store.ell_params()``).
    """
    with trace.span("mesh.build_device_graph", devices=n_dev):
        meta = store.read_meta()
        if window is None or k is None or tr is None:
            ep = store.ell_params()
            window = ep["window"] if window is None else window
            k = ep["k"] if k is None else k
            tr = ep["tr"] if tr is None else tr
        rows_per_dev, nv_pad, bounds = equal_device_bounds(meta.num_vertices,
                                                           n_dev)
        # Per-device CSR accumulators (row counts first, then columns).
        dev_counts = [np.zeros(int(bounds[d + 1] - bounds[d]), dtype=np.int64)
                      for d in range(n_dev)]
        dev_cols: List[List[np.ndarray]] = [[] for _ in range(n_dev)]
        for p in range(meta.num_shards):
            csr = store.load_shard(p, "csr")
            counts = np.diff(csr.row)
            # Destination rows of this store shard, split by device boundary.
            d_lo = int(np.searchsorted(bounds, csr.v0, side="right") - 1)
            d_hi = int(np.searchsorted(bounds, max(csr.v1 - 1, csr.v0),
                                       side="right") - 1)
            for d in range(d_lo, min(d_hi, n_dev - 1) + 1):
                lo = max(csr.v0, int(bounds[d]))
                hi = min(csr.v1, int(bounds[d + 1]))
                if hi <= lo:
                    continue
                r0, r1 = lo - csr.v0, hi - csr.v0
                dev_counts[d][lo - int(bounds[d]): hi - int(bounds[d])] = \
                    counts[r0:r1]
                e0, e1 = int(csr.row[r0]), int(csr.row[r1])
                if e1 > e0:
                    dev_cols[d].append(csr.col[e0:e1])

        shards = []
        for d in range(n_dev):
            row = np.zeros(len(dev_counts[d]) + 1, dtype=np.int64)
            np.cumsum(dev_counts[d], out=row[1:])
            col = (np.concatenate(dev_cols[d]).astype(np.int32)
                   if dev_cols[d] else np.zeros(0, dtype=np.int32))
            shards.append(ShardCSR(shard_id=d, v0=int(bounds[d]),
                                   v1=int(bounds[d + 1]), row=row, col=col))
        return _device_graph_from_shards(
            shards, meta.num_vertices, rows_per_dev, nv_pad, n_dev,
            meta.out_deg, window=window, k=k, tr=tr,
        )


def preprocess_with_bounds(graph: Graph, bounds: np.ndarray):
    """Preprocess with externally fixed interval bounds (equal vertex slices)."""
    shards = build_shards(graph, bounds)
    meta = GraphMeta(
        num_vertices=graph.num_vertices,
        num_edges=graph.num_edges,
        num_shards=len(shards),
        intervals=bounds,
        in_deg=graph.in_degrees(),
        out_deg=graph.out_degrees(),
    )
    return meta, shards


def device_graph_specs(
    num_vertices: int,
    num_edges: int,
    n_dev: int,
    *,
    k: int = 128,
    tr: int = 8,
    pad_factor: float = 1.30,
    index_dtype: torch.dtype = torch.int32,
    sentinel: bool = False,
) -> dict:
    """Shape and dtype stand-ins (``device="meta"`` tensors) for a graph of
    the given size.  ``pad_factor`` models ELL padding waste (about 1.1-1.3
    on R-MAT); ``sentinel`` drops the validity plane (see make_superstep)."""
    rows_per_dev = -(-num_vertices // n_dev)
    nv_pad = rows_per_dev * n_dev
    edges_per_dev = -(-num_edges // n_dev)
    n_ell = int(-(-edges_per_dev * pad_factor // k))
    n_ell = max(-(-n_ell // tr) * tr, tr)
    S = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")
    out = dict(
        src_vals=S((nv_pad,), torch.float32),
        ell_idx=S((n_dev * n_ell, k), index_dtype),
        ell_valid=S((n_dev * n_ell, k), torch.bool),
        seg=S((n_dev * n_ell,), torch.int32),
        out_deg=S((nv_pad,), torch.int32),
    )
    if sentinel:
        out.pop("ell_valid")
    return out


# --------------------------------------------------------------------------
# SPMD: one rank per device over torch.distributed
# --------------------------------------------------------------------------


def _pre_apply_fns(program_name: str, num_vertices: int, damping: float = 0.85):
    """Tensor versions of the paper's three applications (Alg. 2)."""
    if program_name == "pagerank":
        pre = lambda v, od: v / od.clamp(min=1).to(v.dtype)
        apply = lambda acc, old: (1.0 - damping) / num_vertices + damping * acc
        combine = "sum"
    elif program_name in ("sssp", "bfs"):
        pre = lambda v, od: v + 1.0
        apply = lambda acc, old: torch.minimum(acc, old)
        combine = "min"
    elif program_name == "wcc":
        pre = lambda v, od: v
        apply = lambda acc, old: torch.minimum(acc, old)
        combine = "min"
    else:
        raise ValueError(program_name)
    return pre, apply, combine


def _group_device(group) -> torch.device:
    """The device a rank of ``group`` computes on: its card under NCCL,
    the CPU under gloo."""
    import torch.distributed as dist

    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_superstep(
    group,
    program_name: str,
    num_vertices: int,
    rows_per_dev: int,
    *,
    damping: float = 0.85,
    msg_dtype: torch.dtype = torch.float32,
    sentinel: bool = False,
) -> Callable:
    """The superstep of one rank of ``group`` (a ``torch.distributed``
    process group, one rank per device).

    Returns ``step(src_local, ell_idx, [ell_valid,] seg, out_deg_local) ->
    (new_local, n_active)`` on the rank's vertex slice and ELL block:
    ``pre`` on the slice, an all-gather of the message slices (the SEM
    working set), the rank's ELL block against it
    (:func:`~repro_torch.kernels.spmv_ell.ops.ell_update_arrays`: a plain
    gather, sums through the ``segment_combine`` kernel), then ``apply``
    and a summed count of changed vertices.

    Variants: ``msg_dtype=torch.bfloat16`` halves the gathered working set
    on the wire (values re-cast to f32 before accumulation);
    ``sentinel=True`` has no validity plane: padding slots carry an index
    past the message array, and one identity slot after it answers them.
    """
    import torch.distributed as dist

    from ..kernels.spmv_ell.ops import ell_update_arrays

    pre, apply_fn, combine = _pre_apply_fns(program_name, num_vertices, damping)
    world = dist.get_world_size(group)

    def step(src_local, idx, *rest):
        if sentinel:
            valid, (seg, out_deg_local) = None, rest
        else:
            valid, seg, out_deg_local = rest
        # pre(): elementwise on the local vertex slice (no communication).
        msgs_local = pre(src_local, out_deg_local).to(msg_dtype).contiguous()
        # SEM working set: every rank needs the full message array.
        msgs = torch.empty(world * msgs_local.numel(), dtype=msg_dtype,
                           device=msgs_local.device)
        dist.all_gather_into_tensor(msgs, msgs_local, group=group)
        acc = ell_update_arrays(idx, valid, seg, msgs.to(torch.float32),
                                rows_per_dev, combine)
        new_local = apply_fn(acc, src_local).to(src_local.dtype)
        n_active = (new_local != src_local).sum()
        dist.all_reduce(n_active, group=group)
        return new_local, n_active

    return step


def run_distributed(
    graph: Graph,
    program: VertexProgram,
    group=None,
    *,
    max_iters: int = 100,
    window: int = 1 << 12,
    k: int = 32,
    tr: int = 8,
    damping: float = 0.85,
) -> Tuple[np.ndarray, int]:
    """Run the distributed engine on this rank of ``group`` (the default
    group when None): every rank builds the same device graph, keeps its
    block, and the result is gathered on every rank.  Returns ``(values,
    iterations)``."""
    import torch.distributed as dist

    n_dev = dist.get_world_size(group)
    rank = dist.get_rank(group)
    device = _group_device(group)
    dg = build_device_graph(graph, n_dev, window=window, k=k, tr=tr)
    step = make_superstep(group, program.name, dg.num_vertices_real,
                          dg.rows_per_dev, damping=damping)

    meta = GraphMeta(
        num_vertices=graph.num_vertices,
        num_edges=graph.num_edges,
        num_shards=n_dev,
        intervals=np.arange(n_dev + 1) * dg.rows_per_dev,
        in_deg=np.zeros(graph.num_vertices, np.int64),
        out_deg=graph.out_degrees(),
    )
    vals0, _ = program.init(meta)
    # Padding vertices have no in/out edges; their value never matters.
    pad = dg.num_vertices - graph.num_vertices
    vals = np.concatenate([vals0.astype(np.float32), np.zeros(pad, np.float32)])

    rpd, ne = dg.rows_per_dev, dg.n_ell_per_dev
    rows = slice(rank * rpd, (rank + 1) * rpd)
    ells = slice(rank * ne, (rank + 1) * ne)
    on = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    local = on(vals[rows])
    args = [on(dg.ell_idx[ells]), on(dg.ell_valid[ells]), on(dg.seg[ells]),
            on(dg.out_deg[rows])]
    iters = 0
    for it in range(max_iters):
        local, n_active = step(local, *args)
        iters = it + 1
        if int(n_active) == 0:
            break
    full = torch.empty(n_dev * rpd, dtype=local.dtype, device=device)
    dist.all_gather_into_tensor(full, local, group=group)
    return full.cpu().numpy()[: graph.num_vertices], iters
