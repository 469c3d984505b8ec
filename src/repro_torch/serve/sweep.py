"""Fused lane sweeps: heterogeneous query programs on ONE shard stream.

A :class:`FusedSweep` reuses a warm :class:`~repro_torch.core.vsw.VSWEngine`'s
scheduler, pipeline and store to drive G concurrent **program groups**,
each a :class:`LaneTable` — a ``(capacity, n)`` lane matrix whose lanes
share one combine algebra (:attr:`~repro_torch.core.apps.LaneProgram.
combine_key`) but may run *different programs* (BFS, SSSP and WCC fuse
into one table; ``pre``/``apply``/``is_active`` are applied per lane,
grouped by full program key).  Every loaded shard is dispatched for every
live group through the lane executor's ``run_groups``: one launch per
group and batch, or (``ragged=True``, the default) ONE ragged launch per
batch for all groups.

Scheduling uses the UNION of the per-lane active sets across every group:
a shard is skipped only when *no* lane's Bloom filter matches.  This
preserves per-lane results bitwise (DESIGN.md §6/§9): the union plan is a
superset of each lane's own plan, and recomputing a shard whose
in-messages did not change reproduces the carried-over value exactly —
for monotone ``min`` programs because ``min(acc, old) == old``, and for
the ``sum`` programs because ``apply`` is a deterministic function of an
unchanged ``acc``.  Each lane's messages come from its own program's
``pre`` on its own row, lane ``l`` of a lane kernel is bitwise the
single-lane kernel on row ``l``, and ``apply`` runs per lane.

Lanes retire as soon as their own active set empties (or their iteration
budget runs out) and the freed slot is backfilled from the service queue,
per group.  I/O cost is attributed mask-aware
(:meth:`~repro_torch.core.scheduler.ShardPlan.lane_shares`).

:class:`LaneSweep` is the single-program wrapper: one program, one group.
Mesh sweeps (``MeshSweep``) wait for the multi-device port (ROADMAP
Queue 1 item 8).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..core.apps import LaneProgram
from ..core.executor import ExecStats, make_lane_executor
from ..core.pipeline import PipelineStats
from ..core.scheduler import ShardPlan
from ..core.vsw import VSWEngine
from ..obs import trace
from .batcher import pad_lanes

__all__ = ["LaneSeed", "LaneResult", "SweepIterStats", "LaneTable",
           "FusedSweep", "LaneSweep", "MeshSweep"]


@dataclasses.dataclass
class LaneSeed:
    """One admitted query: where it starts, how long it may run, and (for
    fused sweeps) which lane program it runs.  ``program=None`` is only
    valid through :class:`LaneSweep`, which fills in its single program."""

    source: int
    max_iters: int = 100
    token: Any = None  # opaque caller payload (the service's pending entry)
    program: Optional[LaneProgram] = None


@dataclasses.dataclass
class LaneResult:
    """One retired lane: final values plus attributed cost (the lane's
    mask-aware *share* of the sweep's shard loads and bytes)."""

    token: Any
    source: int
    values: np.ndarray  # [n] final vertex values for this query
    iterations: int
    converged: bool
    bytes_read: float
    shard_loads: float
    group: int = 0  # fusion-group index within the sweep
    program: str = ""


@dataclasses.dataclass
class SweepIterStats:
    iteration: int
    live_lanes: int
    shards_processed: int
    shards_skipped: int
    bytes_read: int
    selective_on: bool
    retired: int
    backfilled: int
    time_s: float
    # lane-aware selective scheduling: dispatch rows (shard x lane pairs)
    # skipped because the lane had no active source in the shard
    lane_rows_skipped: int = 0
    # per-stage decomposition: load work done by prefetch threads, the
    # slice of it exposed on the critical path, and dispatch wall time
    load_total_s: float = 0.0
    load_wait_s: float = 0.0
    exec_s: float = 0.0
    # device time of the updates (CUDA events; 0.0 off the card)
    kernel_s: float = 0.0
    # program groups live this iteration (1 for plain lane sweeps)
    groups: int = 1
    # kernel dispatches and shard batches this iteration.  Ragged sweeps
    # hold dispatches == batches == ragged_dispatches (one launch per
    # batch covers every group); the multi path pays groups x batches.
    # Conservation: batches <= dispatches.
    dispatches: int = 0
    batches: int = 0
    ragged_dispatches: int = 0
    # double-buffer overlap: wall time launches stayed in flight while the
    # host staged the next batch.
    overlap_s: float = 0.0


class LaneTable:
    """Slot state for ONE fusion group: lanes sharing a combine algebra.

    The table owns everything per-slot — values, active masks, the lane's
    :class:`LaneProgram`, its seed, iteration/cost counters — and the
    admission / retirement lifecycle.  Row-wise stages (``pre`` /
    ``apply`` / ``is_active``) run per program-key run of slots, so each
    lane's computation is exactly its solo program's.
    """

    def __init__(self, meta, combine: str, capacity: int, *, group: int = 0):
        self.meta = meta
        self.combine = combine
        self.capacity = capacity
        self.group = group
        n = meta.num_vertices
        self.vals = np.zeros((capacity, n), dtype=np.float32)
        self.active = np.zeros((capacity, n), dtype=bool)
        self.live = np.zeros(capacity, dtype=bool)
        self.sources = np.full(capacity, -1, dtype=np.int64)
        self.lane_iters = np.zeros(capacity, dtype=np.int64)
        self.lane_bytes = np.zeros(capacity, dtype=np.float64)
        self.lane_loads = np.zeros(capacity, dtype=np.float64)
        self.progs: List[Optional[LaneProgram]] = [None] * capacity
        self.seeds: List[Optional[LaneSeed]] = [None] * capacity

    # ---------------------------------------------------------- admission
    def admit(self, seed: LaneSeed) -> Optional[LaneResult]:
        """THE admission path — initial seeds and mid-sweep backfill alike.

        A seed with ``max_iters <= 0`` never takes a slot: its finished
        :class:`LaneResult` (init values, zero iterations, not converged,
        as ``VSWEngine.run``) is returned.  Otherwise the seed occupies a
        free slot and ``None`` is returned.
        """
        prog = seed.program
        if prog is None:
            raise ValueError("LaneSeed.program is required (fused sweeps)")
        if prog.combine != self.combine:
            raise ValueError(
                f"program {prog.name!r} ({prog.combine}) cannot join a "
                f"{self.combine!r} lane table"
            )
        if seed.max_iters <= 0:
            v, _ = prog.init_lane(self.meta, seed.source)
            return LaneResult(
                token=seed.token, source=seed.source,
                values=v.astype(np.float32), iterations=0, converged=False,
                bytes_read=0.0, shard_loads=0.0,
                group=self.group, program=prog.name,
            )
        free = np.flatnonzero(~self.live)
        if not len(free):
            raise RuntimeError("lane table is full")
        slot = int(free[0])
        v, a = prog.init_lane(self.meta, seed.source)
        self.vals[slot] = v
        self.active[slot] = a
        self.live[slot] = True
        self.sources[slot] = seed.source
        self.lane_iters[slot] = 0
        self.lane_bytes[slot] = 0.0
        self.lane_loads[slot] = 0.0
        self.progs[slot] = prog
        self.seeds[slot] = seed
        return None

    def live_slots(self) -> np.ndarray:
        return np.flatnonzero(self.live)

    def free_count(self) -> int:
        return int((~self.live).sum())

    # ------------------------------------------------- per-program stages
    def _prog_runs(
        self, slots: np.ndarray
    ) -> Iterator[Tuple[np.ndarray, LaneProgram]]:
        """Partition ``slots`` into runs sharing a full program key."""
        runs: Dict[Tuple, Tuple[List[int], LaneProgram]] = {}
        for i, k in enumerate(slots):
            prog = self.progs[int(k)]
            runs.setdefault(prog.key, ([], prog))[0].append(i)
        for rows, prog in runs.values():
            yield np.asarray(rows, dtype=np.int64), prog

    def messages(self, out_deg: np.ndarray) -> np.ndarray:
        """Per-lane ``pre`` over the live slots (each lane's own program);
        dead/free rows stay zero — they are never applied."""
        msgs = np.zeros_like(self.vals)
        slots = self.live_slots()
        for rows, prog in self._prog_runs(slots):
            sl = slots[rows]
            msgs[sl] = prog.pre(self.vals[sl], out_deg).astype(np.float32)
        return msgs

    def apply_rows(self, acc: np.ndarray, slots: np.ndarray, v0: int, v1: int,
                   dst: np.ndarray) -> None:
        """Per-lane ``apply`` for one shard interval: row ``i`` of ``acc``
        belongs to slot ``slots[i]``; results land in ``dst``."""
        for rows, prog in self._prog_runs(slots):
            sl = slots[rows]
            dst[sl, v0:v1] = prog.apply(
                acc[rows], self.vals[sl, v0:v1], self.meta, v0,
                self.sources[sl],
            )

    def advance(self, dst: np.ndarray) -> None:
        """Commit one iteration: per-lane ``is_active`` against the old
        values, then swap in ``dst`` and bump live lanes' iteration
        counters."""
        slots = self.live_slots()
        new_active = np.zeros_like(self.active)
        for rows, prog in self._prog_runs(slots):
            sl = slots[rows]
            new_active[sl] = prog.is_active(dst[sl], self.vals[sl])
        self.vals = dst
        self.active = new_active
        self.lane_iters[self.live] += 1

    def attribute(self, shares: np.ndarray, bytes_per_load: float) -> None:
        """Add this iteration's mask-aware cost shares (aligned with
        ``live_slots()``) to the lanes' running totals."""
        slots = self.live_slots()
        self.lane_loads[slots] += shares
        self.lane_bytes[slots] += shares * bytes_per_load

    # --------------------------------------------------------- retirement
    def retire(self, emit: Callable[[LaneResult], None]) -> int:
        """Free every lane that converged or exhausted its budget; ``emit``
        fires per retired lane (the service resolves futures here)."""
        retired = 0
        for k in self.live_slots():
            k = int(k)
            seed = self.seeds[k]
            converged = not self.active[k].any()
            if not converged and self.lane_iters[k] < seed.max_iters:
                continue
            self.live[k] = False
            self.active[k] = False
            retired += 1
            emit(LaneResult(
                token=seed.token,
                source=seed.source,
                values=self.vals[k].copy(),
                iterations=int(self.lane_iters[k]),
                converged=converged,
                bytes_read=float(self.lane_bytes[k]),
                shard_loads=float(self.lane_loads[k]),
                group=self.group,
                program=self.progs[k].name,
            ))
            self.progs[k] = None
            self.seeds[k] = None
        return retired


class FusedSweep:
    """Drive G program groups over ONE shard stream.

    Each iteration plans the union active set across every group, loads
    each planned shard once, and dispatches it for every live group
    through the lane executor — with per-(group, lane) masks under
    lane-aware selective scheduling.  The executor runs on the engine's
    backend and device.
    """

    def __init__(
        self,
        engine: VSWEngine,
        *,
        batch_shards: int = 1,
        pad_pow2: bool = True,
        lane_selective: bool = True,
        ragged: bool = True,
    ):
        self.engine = engine
        self.pad_pow2 = pad_pow2
        # Lane-aware selective scheduling: when the union plan is selective,
        # also skip dispatch ROWS for lanes whose Bloom filter matches no
        # active vertex of the shard — and whole GROUPS whose lanes are all
        # masked (the shard still loads once).  Same bitwise argument as
        # whole-shard skipping, per lane (DESIGN.md §6).
        self.lane_selective = lane_selective
        # Ragged (DESIGN.md §14): the torch/cuda lane executors concatenate
        # every live group along the lane axis and launch ONE ragged update
        # per shard batch (instead of G), collecting batch i only after
        # batch i+1 is dispatched.  Bitwise equal per group; the numpy
        # oracle always runs per group.
        self.ragged = ragged
        self.executor = make_lane_executor(
            engine.backend_name, batch_shards=batch_shards, ragged=ragged,
            device=engine.device,
        )
        self.iter_stats: List[SweepIterStats] = []

    # ------------------------------------------------------------------ run
    def run(
        self,
        seed_groups: Sequence[Sequence[LaneSeed]],
        *,
        backfill: Optional[Callable[[int, int], Sequence[LaneSeed]]] = None,
        on_retire: Optional[Callable[[LaneResult], None]] = None,
    ) -> List[LaneResult]:
        """Sweep until every group's lanes have retired and ``backfill``
        is dry.

        ``seed_groups[g]`` seeds group ``g``; every seed carries its own
        program and all programs within a group must share a combine
        algebra.  ``backfill(g, n_free)`` is called whenever group ``g``
        has free slots; it may return up to ``n_free`` new seeds (same
        combine algebra) which start their own iteration 0 mid-sweep.
        ``on_retire`` fires the moment a lane finishes.
        """
        results: List[LaneResult] = []

        def emit(res: LaneResult) -> None:
            results.append(res)
            trace.instant("lane.retire", group=res.group, source=res.source,
                          program=res.program, iterations=res.iterations)
            if on_retire is not None:
                on_retire(res)

        engine = self.engine
        meta = engine.meta
        n = meta.num_vertices

        tables: List[LaneTable] = []
        pending_admits: List[Tuple[LaneTable, LaneSeed]] = []
        for gi, seeds in enumerate(seed_groups):
            seeds = list(seeds)
            if not seeds:
                continue
            combine = seeds[0].program.combine
            n_live = sum(1 for s in seeds if s.max_iters > 0)
            capacity = pad_lanes(n_live) if self.pad_pow2 else max(n_live, 1)
            table = LaneTable(meta, combine, capacity, group=gi)
            tables.append(table)
            pending_admits.extend((table, s) for s in seeds)
        for table, seed in pending_admits:
            res = table.admit(seed)
            if res is not None:
                emit(res)  # zero-budget: finished at admission
        if not any(t.live.any() for t in tables):
            return results

        pstats = PipelineStats()
        xstats = ExecStats()
        it = 0
        with engine._sweep_session():
            while any(t.live.any() for t in tables):
                with trace.span("sweep.iter", iteration=it) as it_sp:
                    t0 = time.perf_counter()
                    io0 = engine.store.io.snapshot()
                    pstats.reset()
                    xstats.reset()

                    group_live = [t.live_slots() for t in tables]
                    total_live = int(sum(len(sl) for sl in group_live))
                    n_groups_live = sum(1 for sl in group_live if len(sl))
                    union_any = np.zeros(n, dtype=bool)
                    for t, sl in zip(tables, group_live):
                        if len(sl):
                            union_any |= t.active[sl].any(axis=0)
                    union_ids = np.flatnonzero(union_any).astype(np.int64)
                    lane_active = None
                    if self.lane_selective and total_live > 1:
                        lane_active = [
                            np.flatnonzero(t.active[k]).astype(np.int64)
                            for t, sl in zip(tables, group_live)
                            for k in sl
                        ]
                    plan = engine.scheduler.plan(union_ids,
                                                 lane_active=lane_active)
                    msgs = [
                        t.messages(meta.out_deg) if len(sl) else None
                        for t, sl in zip(tables, group_live)
                    ]
                    # carried for skipped shards / masked lanes / dead rows
                    dst = [t.vals.copy() for t in tables]

                    loaded = engine.pipeline.iter_shards(plan.shards,
                                                         stats=pstats)
                    rows_skipped = 0
                    try:
                        if plan.lane_masks is None:
                            groups_args = [
                                (m, t.combine) if m is not None else None
                                for m, t in zip(msgs, tables)
                            ]
                            for gi, res in self.executor.run_groups(
                                loaded, groups_args, xstats
                            ):
                                sl = group_live[gi]
                                acc = np.asarray(res.acc, dtype=np.float32)[sl]
                                tables[gi].apply_rows(acc, sl, res.v0, res.v1,
                                                      dst[gi])
                        else:
                            rows_skipped = self._run_masked(
                                plan, loaded, tables, group_live, msgs, dst,
                                xstats,
                            )
                    finally:
                        # Deterministic drain on failure: cancel+await the
                        # prefetch window now, so the NEXT sweep on this
                        # engine sees idle loader threads.
                        loaded.close()

                    # -------------------------------- commit + attribution
                    dio = engine.store.io - io0
                    shares = plan.lane_shares(total_live)
                    bytes_per_load = (dio.bytes_read / plan.num_planned
                                      if plan.num_planned else 0.0)
                    offset = 0
                    for gi, (t, sl) in enumerate(zip(tables, group_live)):
                        if not len(sl):
                            continue
                        t.attribute(shares[offset:offset + len(sl)],
                                    bytes_per_load)
                        offset += len(sl)
                        t.advance(dst[gi])

                    # ------------------------------- retirement + backfill
                    retired = sum(t.retire(emit) for t in tables)
                    backfilled = 0
                    if backfill is not None:
                        for t in tables:
                            while True:
                                n_free = t.free_count()
                                if n_free == 0:
                                    break
                                got = list(backfill(t.group, n_free))
                                if not got:
                                    break
                                for seed in got:
                                    res = t.admit(seed)
                                    if res is not None:
                                        emit(res)  # zero-budget, slot free
                                    else:
                                        backfilled += 1

                    self.iter_stats.append(SweepIterStats(
                        iteration=it,
                        live_lanes=total_live,
                        shards_processed=plan.num_planned,
                        shards_skipped=plan.num_skipped,
                        bytes_read=dio.bytes_read,
                        selective_on=plan.selective_on,
                        retired=retired,
                        backfilled=backfilled,
                        time_s=time.perf_counter() - t0,
                        lane_rows_skipped=rows_skipped,
                        load_total_s=pstats.load_total_s,
                        load_wait_s=pstats.wait_s,
                        exec_s=xstats.exec_s,
                        kernel_s=xstats.kernel_s,
                        groups=n_groups_live,
                        dispatches=xstats.dispatches,
                        batches=xstats.batches,
                        ragged_dispatches=xstats.ragged_dispatches,
                        overlap_s=xstats.overlap_s,
                    ))
                    it_sp.set(shards=plan.num_planned, live_lanes=total_live,
                              groups=n_groups_live, retired=retired,
                              backfilled=backfilled)
                it += 1
        return results

    # ------------------------------------------------- lane-masked dispatch
    def _run_masked(
        self,
        plan: ShardPlan,
        loaded,
        tables: List[LaneTable],
        group_live: List[np.ndarray],
        msgs: List[Optional[np.ndarray]],
        dst: List[np.ndarray],
        xstats: ExecStats,
    ) -> int:
        """Execute the plan with per-shard lane masks: consecutive shards
        sharing a mask are dispatched together (preserving shard batching)
        on ONLY the masked lanes' message rows, per group; a group whose
        lanes are all masked for the run is skipped without a dispatch.
        Unmasked lanes keep their carried values.  Returns skipped
        dispatch rows.

        Message sub-matrices are padded to pow2 lane counts, as the
        reference pads them; padding rows are zeros and their results are
        discarded.  The sub-matrices are cached per (group, lane mask) for
        the iteration, and so are their device copies (the executor keys
        its staging cache on the sub-matrix): a recurring mask is staged
        once.  Lane values are fixed within the iteration, and the caches
        die with the call.
        """
        batch = getattr(self.executor, "batch_shards", 1)
        rows_skipped = 0
        buf: List = []
        buf_mask: Optional[np.ndarray] = None
        staged: Dict[Tuple[int, bytes], np.ndarray] = {}
        device_staged: dict = {}

        def flush() -> None:
            nonlocal buf, buf_mask, rows_skipped
            if not buf:
                return
            groups_args: List[Optional[Tuple[np.ndarray, str]]] = []
            group_slots: List[Optional[np.ndarray]] = []
            offset = 0
            for gi, (t, sl, m) in enumerate(zip(tables, group_live, msgs)):
                sub = buf_mask[offset:offset + len(sl)]
                offset += len(sl)
                dsl = sl[sub] if len(sl) else sl
                rows_skipped += (len(sl) - len(dsl)) * len(buf)
                if not len(dsl):
                    groups_args.append(None)
                    group_slots.append(None)
                    continue
                key = (gi, dsl.tobytes())
                subm = staged.get(key)
                if subm is None:
                    k = len(dsl)
                    cap_sub = pad_lanes(k) if self.pad_pow2 else k
                    subm = np.zeros((cap_sub, m.shape[1]), dtype=m.dtype)
                    subm[:k] = m[dsl]
                    staged[key] = subm
                groups_args.append((subm, t.combine))
                group_slots.append(dsl)
            for gi, res in self.executor.run_groups(
                iter(buf), groups_args, xstats, staged=device_staged
            ):
                dsl = group_slots[gi]
                acc = np.asarray(res.acc, dtype=np.float32)[: len(dsl)]
                tables[gi].apply_rows(acc, dsl, res.v0, res.v1, dst[gi])
            buf, buf_mask = [], None

        for ls in loaded:
            mask = plan.lane_masks[ls.shard_id]
            if buf and (len(buf) >= batch or not np.array_equal(mask, buf_mask)):
                flush()
            buf_mask = mask
            buf.append(ls)
        flush()
        return rows_skipped


class MeshSweep(FusedSweep):
    """A fused sweep over several devices: waits for the multi-device port
    (ROADMAP Queue 1 item 8)."""

    def __init__(self, engine: VSWEngine, **kwargs):
        raise NotImplementedError(
            "MeshSweep (multi-device sweeps) is ROADMAP Queue 1 item 8, "
            "not ported yet")


class LaneSweep:
    """Run per-source queries of ONE program as lanes of one sweep: a thin
    wrapper over :class:`FusedSweep` with a single fusion group.  Seeds
    without an explicit program get this sweep's, and ``backfill(n_free)``
    keeps a group-less signature."""

    def __init__(
        self,
        engine: VSWEngine,
        program: LaneProgram,
        *,
        batch_shards: int = 1,
        pad_pow2: bool = True,
        lane_selective: bool = True,
        ragged: bool = True,
    ):
        self.engine = engine
        self.program = program
        self._fused = FusedSweep(engine, batch_shards=batch_shards,
                                 pad_pow2=pad_pow2,
                                 lane_selective=lane_selective, ragged=ragged)

    @property
    def pad_pow2(self) -> bool:
        return self._fused.pad_pow2

    @property
    def lane_selective(self) -> bool:
        return self._fused.lane_selective

    @property
    def executor(self):
        return self._fused.executor

    @property
    def iter_stats(self) -> List[SweepIterStats]:
        return self._fused.iter_stats

    def _with_program(self, seeds: Sequence[LaneSeed]) -> List[LaneSeed]:
        return [s if s.program is not None
                else dataclasses.replace(s, program=self.program)
                for s in seeds]

    def run(
        self,
        seeds: Sequence[LaneSeed],
        *,
        backfill: Optional[Callable[[int], Sequence[LaneSeed]]] = None,
        on_retire: Optional[Callable[[LaneResult], None]] = None,
    ) -> List[LaneResult]:
        """Sweep until every lane has retired and ``backfill`` is dry."""
        if not seeds:
            return []
        fused_backfill = None
        if backfill is not None:
            def fused_backfill(_group: int, n_free: int):
                return self._with_program(backfill(n_free))
        return self._fused.run([self._with_program(seeds)],
                               backfill=fused_backfill, on_retire=on_retire)
