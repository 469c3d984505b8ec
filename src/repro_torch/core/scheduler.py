"""Shard scheduling: *what to run this iteration* (DESIGN.md §3).

First layer of the engine stack.  The scheduler owns selective scheduling
(paper §II-D-1): it builds the per-shard Bloom filters (or exact source
sets) during the loading-phase scan and, each iteration, turns the active
vertex set into an ordered :class:`ShardPlan` — the shards that can
possibly produce updates.  The plan is an explicit value so the pipeline's
loader threads know the next shards before the current one finishes.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..obs import trace
from .bloom import BloomFilter
from .cache import ShardCache
from .sharding import GraphMeta
from .storage import IOStats, ShardStore

__all__ = ["ShardPlan", "ShardScheduler"]


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Ordered work list for one iteration, in interval order (shard p
    writes ``DstVertexArray`` interval p; consecutive planned ELL shards
    are what the batched executor concatenates).

    ``lane_masks`` (lane-aware selective scheduling, serving layer): when
    the planner was given per-lane active sets, ``lane_masks[p][l]`` says
    whether lane ``l`` may produce updates from shard ``p``.  A planned
    shard always has at least one True lane; lanes masked False carry their
    previous interval values (DESIGN.md §6).  ``None`` means every lane
    needs every planned shard.  For a fused sweep the lane axis is every
    live lane of every program group, in group order.
    """

    shards: List[int]
    skipped: List[int]
    selective_on: bool
    active_ratio: float
    plan_time_s: float
    lane_masks: Optional[Dict[int, np.ndarray]] = None
    #: mesh plans only (the scheduler has a partition): planned shards
    #: grouped by owning device, interval order within each device;
    #: ``shards`` is then the round-robin interleave of these groups so the
    #: executor's per-device buffers fill evenly.  A device whose
    #: destination intervals are all inactive gets an EMPTY group and no
    #: host read.  ``None`` on single-device plans.
    device_shards: Optional[List[List[int]]] = None

    @property
    def num_planned(self) -> int:
        return len(self.shards)

    @property
    def num_skipped(self) -> int:
        return len(self.skipped)

    def device_stats(self, bytes_read: int, device_dispatches: Dict[int, int]):
        """``(device_shards, device_dispatches, device_bytes)`` of a mesh
        iteration (empty tuples on single-device plans): planned shards
        per device, the executor's dispatches per device, and the
        iteration's ``bytes_read`` split by planned shards (multiplied
        first, so a device that owns every shard gets all of it)."""
        if self.device_shards is None:
            return (), (), ()
        n = self.num_planned
        return (tuple(len(g) for g in self.device_shards),
                tuple(device_dispatches.get(d, 0)
                      for d in range(len(self.device_shards))),
                tuple(len(g) * bytes_read / n if n else 0.0
                      for g in self.device_shards))

    def lane_shares(self, n_lanes: int) -> np.ndarray:
        """Mask-aware per-lane share of this plan's shard loads: each
        planned shard's one load is split over only the lanes it was
        dispatched for (evenly over all lanes without masks).  The shares
        sum to ``num_planned``, so attribution built on them is conserved."""
        shares = np.zeros(n_lanes, dtype=np.float64)
        if n_lanes == 0:
            return shares
        if self.lane_masks is None:
            shares[:] = self.num_planned / n_lanes
            return shares
        for p in self.shards:
            mask = self.lane_masks[p]
            shares[mask] += 1.0 / int(mask.sum())
        return shares


class ShardScheduler:
    """Selective scheduling over destination-interval shards."""

    def __init__(
        self,
        meta: GraphMeta,
        *,
        selective: bool = True,
        threshold: float = 1e-3,
        bloom_fp: float = 0.01,
        exact_selective: bool = False,
    ):
        self.meta = meta
        self.selective = selective
        self.threshold = threshold
        self.bloom_fp = bloom_fp
        self.exact_selective = exact_selective
        self.filters: Optional[List[BloomFilter]] = None
        self.exact_sources: Optional[List[np.ndarray]] = None
        self.loading_io: Optional[IOStats] = None
        #: set by the engine's mesh boot path (a
        #: :class:`~repro_torch.core.distributed.MeshPartition`); planning
        #: stays on the host — the partition only regroups the planned list.
        self.partition = None

    # ------------------------------------------------------------- loading
    def build_filters(
        self,
        store: ShardStore,
        *,
        warm_cache: Optional[ShardCache] = None,
        cache_fmt: str = "csr",
    ) -> None:
        """Data-loading phase: scan shards once to build Bloom filters and
        optionally warm the cache (paper §IV-B: 'during the data loading
        phase, GraphMP scans all edges to construct Bloom filters, and
        places processed shards in the cache if possible')."""
        with trace.span("bloom.build", shards=self.meta.num_shards):
            io0 = store.io.snapshot()  # loading-phase I/O isn't per-iteration
            ps = list(range(self.meta.num_shards))
            delta = store.delta
            # Shards whose unique-source arrays were left warm (by ingest,
            # a recompaction or a warm restart) need no read at all;
            # container bytes left warm seed the cache without a read-back
            # either.  Shards with pending deltas are never cache-warmed
            # here: their cache slot belongs to the overlay's CSR path, and
            # their pending insert sources are patched in by the engine's
            # delta refresh right after construction.
            need_read = [p for p in ps if store.warm_sources(p) is None]
            src_of: Dict[int, np.ndarray] = {}
            # Chunked bulk reads: a handful of shards resident at a time —
            # the graph may exceed RAM.
            chunk = 8
            for lo in range(0, len(need_read), chunk):
                part = need_read[lo: lo + chunk]
                csr_raws = store.shard_bytes_bulk(part, "csr")
                if warm_cache is not None and cache_fmt != "csr":
                    warm_raws = store.shard_bytes_bulk(part, cache_fmt)
                else:
                    warm_raws = csr_raws  # no second read of the same bytes
                for p in part:
                    src_of[p] = store.decode_csr(p, csr_raws[p]).unique_sources()
                    if warm_cache is not None and not (
                            delta is not None and delta.has_pending(p)):
                        warm_cache.put(p, warm_raws[p])
            filters: List[BloomFilter] = []
            exact: List[np.ndarray] = []
            for p in ps:
                srcs = src_of.get(p)
                if srcs is None:
                    srcs = store.warm_sources(p)
                    if warm_cache is not None and not (
                            delta is not None and delta.has_pending(p)):
                        raw = store.warm_raw(p, cache_fmt)
                        if raw is not None:
                            warm_cache.put(p, raw)
                filters.append(BloomFilter.build(srcs, fp_rate=self.bloom_fp))
                exact.append(srcs)
            self.filters = filters
            self.exact_sources = exact
            self.loading_io = store.io - io0

    def refresh_shard_sources(self, p: int, srcs: np.ndarray) -> None:
        """Rebuild one shard's Bloom/exact filter after a delta publish or
        recompaction (``srcs`` = the CURRENT unique sources of the logical
        shard, or any superset — supersets cost wasted loads, never
        correctness).  Host numpy, as in the reference."""
        if self.filters is not None:
            self.filters[p] = BloomFilter.build(srcs, fp_rate=self.bloom_fp)
        if self.exact_sources is not None:
            self.exact_sources[p] = srcs

    # ----------------------------------------------------------- decisions
    def shard_is_active(self, p: int, active_ids: np.ndarray) -> bool:
        """May shard ``p`` produce an update given the active set?  Bloom
        false positives cost a wasted load, never correctness."""
        if self.exact_selective:
            srcs = self.exact_sources[p]
            return bool(np.isin(active_ids, srcs, assume_unique=False).any())
        return self.filters[p].any_member(active_ids)

    def tests_shards(self, active_count: int) -> bool:
        """Will a plan for ``active_count`` active vertices test shards
        against their ids (selective scheduling engaged)?"""
        return (
            self.selective
            and active_count / max(self.meta.num_vertices, 1) < self.threshold
            and self.filters is not None
        )

    def plan(
        self,
        active_ids: Optional[np.ndarray],
        *,
        lane_active: Optional[Sequence[np.ndarray]] = None,
        active_count: Optional[int] = None,
    ) -> ShardPlan:
        """Emit this iteration's ordered shard plan.

        ``active_ids`` is the (union) active vertex set.  It may be None
        with ``active_count`` given where :meth:`tests_shards` is False for
        that count: a plan that tests no shard needs only the count.
        ``lane_active`` optionally carries the per-lane active sets of a
        lane sweep; when selective scheduling engages (which implies every
        lane is below the threshold too), the plan then also holds a
        per-shard lane mask.
        """
        with trace.span("sweep.plan") as sp:
            t0 = time.perf_counter()
            if active_ids is not None:
                active_count = len(active_ids)
            active_ratio = active_count / max(self.meta.num_vertices, 1)
            use_selective = self.tests_shards(active_count)
            if use_selective and active_ids is None:
                raise ValueError("a selective plan needs the active ids")
            planned: List[int] = []
            skipped: List[int] = []
            lane_masks: Optional[Dict[int, np.ndarray]] = None
            if use_selective and lane_active is not None and len(lane_active) > 1:
                lane_masks = {}
                for p in range(self.meta.num_shards):
                    mask = np.fromiter(
                        (self.shard_is_active(p, ids) for ids in lane_active),
                        dtype=bool, count=len(lane_active))
                    if mask.any():
                        planned.append(p)
                        lane_masks[p] = mask
                    else:
                        skipped.append(p)
            else:
                for p in range(self.meta.num_shards):
                    if not use_selective or self.shard_is_active(p, active_ids):
                        planned.append(p)
                    else:
                        skipped.append(p)
            # With a mesh partition, group the planned list by owning
            # device and interleave it round-robin.  Reordering is safe:
            # per-shard accumulators touch disjoint destination intervals,
            # and lane_shares/lane_masks are order-free.
            device_shards = None
            if self.partition is not None:
                device_shards = self.partition.group(planned)
                planned = self.partition.interleave(device_shards)
            out = ShardPlan(
                shards=planned,
                skipped=skipped,
                selective_on=use_selective,
                active_ratio=active_ratio,
                plan_time_s=time.perf_counter() - t0,
                lane_masks=lane_masks,
                device_shards=device_shards,
            )
            sp.set(shards=len(planned), skipped=len(skipped),
                   selective=use_selective)
            return out
