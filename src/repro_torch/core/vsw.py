"""The Vertex-centric Sliding Window engine (paper Algorithm 1).

Semantics reproduced exactly:

- two resident vertex arrays, ``SrcVertexArray`` (iteration input) and
  ``DstVertexArray`` (iteration output); vertices NEVER touch disk,
- the window slides over destination-interval shards; each shard is loaded
  (cache -> disk), processed once, and its interval of ``DstVertexArray``
  written by that step alone,
- selective scheduling: when the active ratio drops below the threshold
  (paper: 0.001), shards whose Bloom filter matches no active vertex are
  skipped — no disk read, no compute (§II-D-1),
- compressed edge cache consulted before every disk read (§II-D-2), under
  the reference's LRU policy or the paper's fixed subset
  (``cache_policy="keep"``, :mod:`repro_torch.core.cache`),
- termination when an iteration produces zero active vertices.

The engine is a thin orchestrator over three layers (DESIGN.md §3):

==========  ===============================================================
scheduler   :class:`~repro_torch.core.scheduler.ShardScheduler` — Bloom/
            exact filters and the per-iteration ordered shard plan.
pipeline    :class:`~repro_torch.core.pipeline.ShardPipeline` — walks the
            plan with ``prefetch_depth`` loader threads; the consumer moves
            ELL shards to the device.
executor    :mod:`repro_torch.core.executor` — backend dispatch; with
            ``batch_shards > 1`` the ELL backends fuse consecutive planned
            shards into one launch.  An engine booted with ``mesh=``
            routes each shard to its owning device slot
            (:class:`~repro_torch.core.executor.MeshLaneExecutor`).
==========  ===============================================================

All layer combinations produce bit-identical values: the plan fixes the
processing order, only the consumer thread touches the vertex arrays, and
batched dispatch is a pure concatenation (DESIGN.md §5).

Where the vertex arrays live follows from what the engine sees.  On an ELL
backend (``torch``, ``cuda``) without a mesh, a program with device forms
(every built-in one) runs with both vertex arrays, the degree term and the
padded message buffer on ``device`` for the whole run: ``pre``, ``apply``
and the activity test are device passes, the executor takes the messages
and hands back the accumulators on the device, and only the count of
changed vertices (and, in an iteration that plans selectively, their ids)
comes to the host.  The spans ``vsw.pre`` and ``vsw.apply`` then time
launches, and ``vsw.activity`` holds the iteration's wait for the device.
The ``numpy`` oracle, the mesh engines and a program without device forms
keep the vertex arrays and the programs in numpy on the host; the ``torch``
and ``cuda`` backends still run the per-shard update on ``device``.
Both paths give bitwise the same values.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from ..launch.mesh import make_host_mesh
from ..obs import trace
from .apps import VertexProgram
from .cache import ShardCache, select_cache_mode
from .csr import DeviceEll
from .distributed import MeshPartition
from .executor import (BACKENDS, ELL_BACKENDS, ExecStats, MeshLaneExecutor,
                       make_executor, resolve_device)
from .graph import Graph
from .pipeline import PipelineStats, ShardPipeline
from .scheduler import ShardScheduler
from .sharding import preprocess
from .storage import ShardStore

__all__ = ["IterStats", "RunResult", "VSWEngine", "BACKENDS"]


@dataclasses.dataclass
class IterStats:
    """One engine iteration.  ``time_s`` is its wall time, which the
    clocked steps below split as ``exec_s + load_wait_s + to_device_s +
    plan_s + pre_s + apply_s + activity_s`` plus what no step names (the
    bookkeeping, the generators' own overhead).  ``exec_s`` is the
    executor's whole share in every executor: staging the messages, the
    launches, the wait, the copy back and the split; ``stage_s`` and
    ``copy_back_s`` are parts of it (:class:`~repro_torch.core.executor.
    ExecStats`).  Each step is also a span of :mod:`repro_torch.obs.trace`
    (``sweep.plan``, ``vsw.pre``, ``vsw.apply``, ``vsw.activity``,
    ``exec.stage``, ``exec.copy_back``).  ``on_device`` says the iteration
    kept its vertex arrays on the device (``stage_s`` and ``copy_back_s``
    are then 0); ``ids_to_host`` counts the active ids its plan took on the
    host, 0 where the plan needed only their count; both are attributes of
    the ``vsw.iter`` span too.

    The loads from the store or the byte cache (the semi-external path)
    take ``load_total_s``, the prefetch threads' wall time summed; of it,
    ``read_s`` (the cache's ``get``, and on a miss the store read, span
    ``shard.read``) and ``decode_s`` (span ``shard.decode``) are the
    loading threads' CPU time (``time.thread_time``), so waits for the
    interpreter lock or the disk count in neither.  ``bytes_read +
    cache_bytes`` is the container bytes of the shards loaded so, and
    ``to_device_bytes`` the host planes of every shard copied to the
    device.  A shard served from the resident map counts in none of the
    four.  A logical decode through a delta overlay counts only in
    ``to_device_bytes`` (and in ``bytes_read`` where it read the store):
    while a delta is pending, ``bytes_read + cache_bytes`` leaves out its
    cache hits.  ``cache_bytes`` and ``to_device_bytes`` are attributes
    of the ``vsw.iter`` span."""

    iteration: int
    time_s: float
    shards_processed: int
    shards_skipped: int
    bytes_read: int
    cache_hits: int
    cache_misses: int
    active_count: int
    active_ratio: float
    selective_on: bool
    load_total_s: float = 0.0  # sum of in-thread load+decode durations
    read_s: float = 0.0  # thread CPU time of cache gets and store reads
    decode_s: float = 0.0  # thread CPU time of npz parse and mask unpack
    cache_bytes: int = 0  # container bytes served by the byte cache
    to_device_bytes: int = 0  # shard bytes copied host -> device
    load_wait_s: float = 0.0  # critical-path stall waiting on loads
    load_overlap_s: float = 0.0  # load work hidden behind compute
    to_device_s: float = 0.0  # consumer-side host->device shard copies
    exec_s: float = 0.0  # backend dispatch wall time
    stage_s: float = 0.0  # of exec_s: messages staged on the device
    copy_back_s: float = 0.0  # of exec_s: accumulators to the host
    plan_s: float = 0.0  # the scheduler's plan (ShardPlan.plan_time_s)
    pre_s: float = 0.0  # program.pre and the carried-over copy
    apply_s: float = 0.0  # program.apply and its writes, all shards
    activity_s: float = 0.0  # program.is_active and the active ids
    on_device: bool = False  # vertex arrays on the device (module docstring)
    ids_to_host: int = 0  # active ids the plan took on the host (device path)
    dispatches: int = 0  # kernel dispatches (< processed when batching)
    padding_ratio: float = 0.0  # of the dispatched ELL slots
    prefetch_depth: int = 0
    # ---- mesh runs (DESIGN.md §10); empty tuples on single-device runs.
    # sum(device_shards) == shards_processed and sum(device_bytes) ==
    # bytes_read: the host read each shard ONCE and attribution splits it
    # by owning device, never multiplies it by D.
    device_shards: tuple = ()  # planned shards owned per device
    device_dispatches: tuple = ()  # dispatches that carried work per device
    device_bytes: tuple = ()  # bytes_read attributed per device


@dataclasses.dataclass
class RunResult:
    values: np.ndarray
    iterations: List[IterStats]
    converged: bool

    @property
    def num_iterations(self) -> int:
        return len(self.iterations)

    @property
    def total_bytes_read(self) -> int:
        return sum(i.bytes_read for i in self.iterations)

    @property
    def total_time_s(self) -> float:
        return sum(i.time_s for i in self.iterations)

    @property
    def total_load_overlap_s(self) -> float:
        return sum(i.load_overlap_s for i in self.iterations)


class VSWEngine:
    """GraphMP: semi-external-memory vertex-centric engine."""

    def __init__(
        self,
        store: ShardStore,
        *,
        backend: str = "cuda",
        device="cuda",
        selective: bool = True,
        threshold: float = 1e-3,
        cache_bytes: int = 0,
        cache_mode: int = 1,  # 1-4, or 0 = GraphH-style auto-select
        cache_policy: str = "lru",  # or "keep": the paper's fixed subset
        bloom_fp: float = 0.01,
        exact_selective: bool = False,
        device_resident: bool = False,
        prefetch_depth: int = 2,
        batch_shards: int = 1,
        mesh=None,
    ):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend}; have {sorted(BACKENDS)}")
        self.device = resolve_device(device)
        self.store = store
        self.meta = store.read_meta()
        self.backend_name = backend
        # ---- mesh boot path (DESIGN.md §10).  ``mesh`` is a device count
        # or a ready Mesh.  numpy + a count is the device-free mesh
        # EMULATION (same partition, plan and accounting, oracle compute);
        # the ELL backends build a host mesh of the count on this engine's
        # device type, which raises launch.mesh's uniform error when there
        # are too few devices.
        self.partition = None
        self.mesh = None
        if mesh is not None:
            if isinstance(mesh, (int, np.integer)):
                n_dev = int(mesh)
                if backend != "numpy":
                    self.mesh = make_host_mesh((n_dev,), ("dev",),
                                               device=self.device.type)
            else:
                self.mesh = mesh
                n_dev = mesh.size
            if self.mesh is not None and any(
                    d.type != self.device.type for d in self.mesh.device_list()):
                raise ValueError(f"a mesh of {self.mesh.device_list()} for an "
                                 f"engine on {self.device}")
            self.partition = MeshPartition.from_meta(self.meta, n_dev)
        if cache_bytes > 0 and cache_mode == 0:
            # GraphH-style auto mode selection on a sample shard (§II-D-2)
            sample = store.shard_bytes(0, self._fmt)
            total = sum(
                store.file_size(store.shard_name(p, self._fmt))
                for p in range(self.meta.num_shards)
            )
            cache_mode = select_cache_mode(sample, cache_bytes, total)
        self.cache = (ShardCache(cache_bytes, cache_mode, cache_policy)
                      if cache_bytes > 0 else None)
        # Beyond-paper: keep the device copies of ELL shards resident —
        # skips read, decode AND the host->device copy on every revisit.
        self.device_resident = device_resident and backend != "numpy"
        self._device_shards: Dict[int, DeviceEll] = {}

        # ---- the three layers ------------------------------------------
        self.scheduler = ShardScheduler(
            self.meta,
            selective=selective,
            threshold=threshold,
            bloom_fp=bloom_fp,
            exact_selective=exact_selective,
        )
        self.scheduler.partition = self.partition
        self.scheduler.build_filters(
            store, warm_cache=self.cache, cache_fmt=self._fmt
        )
        self.pipeline = ShardPipeline(
            store,
            self._fmt,
            cache=self.cache,
            depth=prefetch_depth,
            device=None if backend == "numpy" else self.device,
            resident=self._device_shards if self.device_resident else None,
            shard_device=self._owner_device if self.mesh is not None else None,
        )
        if self.partition is not None:
            self.executor = MeshLaneExecutor(
                backend, self.partition, self.mesh,
                batch_shards=batch_shards, lanes=False, device=self.device)
        else:
            self.executor = make_executor(backend, batch_shards=batch_shards,
                                          device=self.device)

        # A shard overwrite on the live store must not leave stale copies
        # in this engine's byte cache or resident map.  The hook holds only
        # a weakref, so a long-lived store does not pin dead engines.
        self_ref = weakref.ref(self)

        def _hook(p: int, _ref=self_ref) -> None:
            eng = _ref()
            if eng is not None:
                eng._on_shard_invalidated(p)

        self._hook_finalizer = weakref.finalize(
            self, store.unregister_invalidation, _hook
        )
        store.register_invalidation(_hook)
        # Live-mutation state (repro_torch.delta): the last overlay version
        # whose metadata/filter changes this engine has absorbed.
        # Refreshing at sweep start (never mid-sweep) keeps a sweep's
        # degrees, filters and shard decodes on ONE graph version.
        self._delta_seen = -1
        self._refresh_delta_state()

    def _owner_device(self, p: int):
        """The device of the mesh slot that owns shard ``p``."""
        return self.mesh.devices.flat[self.partition.device_of(p)]

    def _on_shard_invalidated(self, p: int) -> None:
        """Store callback: shard ``p`` was overwritten, removed, compacted
        or changed by a delta publish — drop its cached bytes and its
        resident device copy."""
        if self.cache is not None:
            self.cache.invalidate(p)
        self.pipeline.drop_resident(p)

    # ------------------------------------------------------- live mutations
    def _refresh_delta_state(self) -> None:
        """Absorb graph mutations published since this engine's last sweep:
        refresh the degree arrays / edge count IN PLACE (the scheduler and
        any live lane sweep share ``meta``, and ``pre`` divides by
        out-degree) and rebuild the Bloom/exact filters of every shard a
        publish touched — base sources (warm, or one read) plus pending
        insert sources.  Deleted sources stay until the shard recompacts:
        a superset filter costs a wasted load, never correctness.  Called
        only between sweeps."""
        delta = self.store.delta
        if delta is None:
            return
        v = delta.version
        if v == self._delta_seen:
            return
        m = self.store.read_meta()
        self.meta.in_deg[:] = m.in_deg
        self.meta.out_deg[:] = m.out_deg
        self.meta.num_edges = m.num_edges
        for p in delta.publishes_since(self._delta_seen):
            srcs = self.store.warm_sources(p)
            if srcs is None:
                srcs = self.store.decode_csr(
                    p, self.store.shard_bytes(p, "csr")).unique_sources()
                self.store.set_warm_sources(p, srcs)
            pend = delta.pending_insert_sources(p, v)
            if len(pend):
                srcs = np.union1d(srcs, pend)
            self.scheduler.refresh_shard_sources(p, srcs)
        self._delta_seen = v

    # ------------------------------------------------------------- factory
    @classmethod
    def from_graph(
        cls,
        graph: Graph,
        root: str,
        *,
        num_shards: Optional[int] = None,
        edges_per_shard: Optional[int] = None,
        window: int = 1 << 14,
        k: int = 128,
        tr: int = 8,
        emulate_bw: Optional[float] = None,
        device="cuda",
        **engine_kwargs,
    ) -> "VSWEngine":
        """Preprocess ``graph`` into ``root`` then open an engine on it."""
        resolve_device(device)  # fail before the preprocessing work
        meta, shards = preprocess(
            graph, num_shards=num_shards, edges_per_shard=edges_per_shard
        )
        store = ShardStore(root, emulate_bw=emulate_bw)
        store.write_meta(meta)
        for s in shards:
            store.write_shard(
                s, num_vertices=meta.num_vertices, window=window, k=k, tr=tr
            )
        return cls(store, device=device, **engine_kwargs)

    @classmethod
    def from_store(
        cls,
        root: str,
        *,
        emulate_bw: Optional[float] = None,
        **engine_kwargs,
    ) -> "VSWEngine":
        """Open an engine on an already-populated store directory (either
        package's)."""
        return cls(ShardStore(root, emulate_bw=emulate_bw), **engine_kwargs)

    @property
    def _fmt(self) -> str:
        """Which on-disk representation this backend consumes."""
        return "csr" if self.backend_name == "numpy" else "ell"

    @classmethod
    def from_edge_file(
        cls,
        path: str,
        root: str,
        *,
        edges_per_shard: Optional[int] = None,
        num_shards: Optional[int] = None,
        num_vertices: Optional[int] = None,
        chunk_edges: int = 1 << 20,
        mem_budget_bytes: int = 64 << 20,
        window: int = 1 << 14,
        k: int = 128,
        tr: int = 8,
        fmt: Optional[str] = None,
        emulate_bw: Optional[float] = None,
        device="cuda",
        **engine_kwargs,
    ) -> "VSWEngine":
        """Stream-ingest an on-disk edge file into ``root`` (bounded-memory
        external build, :mod:`repro_torch.core.ingest`) and open an engine
        on it.  The full edge list is never resident."""
        resolve_device(device)  # fail before the ingest work
        store = ShardStore(root, emulate_bw=emulate_bw)
        store.ingest(
            path, edges_per_shard=edges_per_shard, num_shards=num_shards,
            num_vertices=num_vertices, chunk_edges=chunk_edges,
            mem_budget_bytes=mem_budget_bytes, window=window, k=k, tr=tr,
            fmt=fmt,
        )
        return cls(store, device=device, **engine_kwargs)

    @contextlib.contextmanager
    def _sweep_session(self):
        """One sweep's delta scope: absorb published mutations, then pin the
        overlay version so every shard decode in the sweep — prefetch
        threads included — sees the same snapshot, and background
        recompaction cannot absorb runs this sweep still needs."""
        self._refresh_delta_state()
        delta = self.store.delta
        if delta is None:
            yield None
            return
        pin = delta.acquire_pin()
        self.pipeline.pin = pin
        try:
            yield pin
        finally:
            self.pipeline.pin = None
            delta.release_pin(pin)

    @property
    def loading_io(self):
        return self.scheduler.loading_io

    def close(self) -> None:
        """Shut down the prefetch thread pool.  Idempotent."""
        self.pipeline.close()
        self._hook_finalizer()  # unregisters the invalidation hook once

    def __enter__(self) -> "VSWEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------ run
    def run(self, program: VertexProgram, *, max_iters: int = 100) -> RunResult:
        with trace.span("vsw.run", program=program.name,
                        backend=self.backend_name):
            with self._sweep_session():
                return self._run(program, max_iters=max_iters)

    def _arrays_on_device(self, program: VertexProgram) -> bool:
        """The device path: an ELL backend, no mesh, and a program with
        device forms."""
        return (self.backend_name in ELL_BACKENDS and self.partition is None
                and program.has_device_forms)

    def _run(self, program: VertexProgram, *, max_iters: int) -> RunResult:
        meta = self.meta
        with trace.span("vsw.init"):
            src_vals, active_mask = program.init(meta)
            src_vals = src_vals.astype(np.float32)
            if self._arrays_on_device(program):
                arrays = _DeviceArrays(program, meta, src_vals, active_mask,
                                       self.scheduler, self.device,
                                       self.store.ell_params()["window"])
            else:
                arrays = _HostArrays(program, meta, src_vals, active_mask)
        stats: List[IterStats] = []
        converged = False
        pstats = PipelineStats()
        xstats = ExecStats()

        for it in range(max_iters):
            t0 = time.perf_counter()
            io0 = self.store.io.snapshot()
            cache_h0 = self.cache.stats.hits if self.cache else 0
            cache_m0 = self.cache.stats.misses if self.cache else 0
            pstats.reset()
            xstats.reset()

            with trace.span("vsw.iter", iteration=it) as it_sp:
                ids_to_host = arrays.ids_to_host
                plan = arrays.plan(self.scheduler)
                with trace.timed("vsw.pre") as pre:
                    msgs = arrays.pre(plan)

                apply_s = 0.0
                loaded = self.pipeline.iter_shards(plan.shards, stats=pstats)
                try:
                    for res in self.executor.run(
                        loaded, msgs, program.combine, xstats
                    ):
                        with trace.timed("vsw.apply", shard=res.shard_id) as ap:
                            arrays.apply(res)
                        apply_s += ap.s
                finally:
                    # Deterministic drain: on a failure the prefetch window
                    # is cancelled+awaited NOW, not at GC.
                    loaded.close()
                it_sp.set(shards=plan.num_planned, skipped=plan.num_skipped,
                          on_device=arrays.on_device, ids_to_host=ids_to_host,
                          cache_bytes=pstats.cache_bytes,
                          to_device_bytes=pstats.to_device_bytes)

            with trace.timed("vsw.activity") as act:
                arrays.activity(self.scheduler)

            with trace.span("vsw.stats"):
                dio = self.store.io - io0
                dev_shards, dev_disp, dev_bytes = plan.device_stats(
                    dio.bytes_read, xstats.device_dispatches)
                cache = self.cache.stats if self.cache else None
                stats.append(IterStats(
                    iteration=it,
                    time_s=time.perf_counter() - t0,
                    shards_processed=plan.num_planned,
                    shards_skipped=plan.num_skipped,
                    bytes_read=dio.bytes_read,
                    cache_hits=cache.hits - cache_h0 if cache else 0,
                    cache_misses=cache.misses - cache_m0 if cache else 0,
                    active_count=arrays.count,
                    active_ratio=arrays.count / max(meta.num_vertices, 1),
                    selective_on=plan.selective_on,
                    load_total_s=pstats.load_total_s,
                    read_s=pstats.read_s,
                    decode_s=pstats.decode_s,
                    cache_bytes=pstats.cache_bytes,
                    to_device_bytes=pstats.to_device_bytes,
                    load_wait_s=pstats.wait_s,
                    load_overlap_s=pstats.overlap_s,
                    to_device_s=pstats.to_device_s,
                    exec_s=xstats.exec_s,
                    stage_s=xstats.stage_s,
                    copy_back_s=xstats.copy_back_s,
                    plan_s=plan.plan_time_s,
                    pre_s=pre.s,
                    apply_s=apply_s,
                    activity_s=act.s,
                    on_device=arrays.on_device,
                    ids_to_host=ids_to_host,
                    dispatches=xstats.dispatches,
                    padding_ratio=xstats.padding_ratio,
                    prefetch_depth=self.pipeline.depth,
                    device_shards=dev_shards,
                    device_dispatches=dev_disp,
                    device_bytes=dev_bytes,
                ))
            if arrays.count == 0:
                converged = True
                break

        return RunResult(values=arrays.values(), iterations=stats,
                         converged=converged)


class _HostArrays:
    """The vertex arrays and the program's steps in numpy on the host."""

    on_device = False
    ids_to_host = 0

    def __init__(self, program: VertexProgram, meta, vals: np.ndarray,
                 active_mask: np.ndarray):
        self.program, self.meta = program, meta
        self.src = vals
        self.dst = None
        self.ids = np.flatnonzero(active_mask).astype(np.int64)

    @property
    def count(self) -> int:
        return len(self.ids)

    def plan(self, scheduler: ShardScheduler):
        return scheduler.plan(self.ids)

    def pre(self, plan) -> np.ndarray:
        msgs = self.program.pre(self.src, self.meta.out_deg).astype(np.float32)
        self.dst = self.src.copy()  # carried over for skipped shards
        return msgs

    def apply(self, res) -> None:
        self.dst[res.v0: res.v1] = self.program.apply(
            np.asarray(res.acc, dtype=self.src.dtype),
            self.src[res.v0: res.v1], self.meta, res.v0)

    def activity(self, scheduler: ShardScheduler) -> None:
        new_active = self.program.is_active(self.dst, self.src)
        self.ids = np.flatnonzero(new_active).astype(np.int64)
        self.src = self.dst

    def values(self) -> np.ndarray:
        return self.src


class _DeviceArrays:
    """Both vertex arrays, the degree term ``float32(max(out_deg, 1))`` and
    the message buffer (zero-padded to whole windows, the length the
    executor stages to) on ``device`` for one run; the program's device
    forms write them in place.  The host holds the count of active
    vertices, and their ids only for a plan that tests shards against
    them.  ``arrays[cur]`` is the iteration's input and the
    other its output; ``views[i][p]`` is shard ``p``'s interval of
    ``arrays[i]``, made once a run: a slice is a host op of its own, paid
    per shard and iteration otherwise."""

    on_device = True

    def __init__(self, program: VertexProgram, meta, vals: np.ndarray,
                 active_mask: np.ndarray, scheduler: ShardScheduler,
                 device: torch.device, window: int):
        self.program, self.meta = program, meta
        first = torch.from_numpy(vals).to(device)
        self.arrays = (first, first.clone())
        self.cur = 0
        iv = meta.intervals.tolist()
        self.views = [[a[v0: v1] for v0, v1 in zip(iv[:-1], iv[1:])]
                      for a in self.arrays]
        self.deg = torch.from_numpy(
            np.maximum(meta.out_deg, 1).astype(np.float32)).to(device)
        n_pad = max(1, -(-meta.num_vertices // window)) * window
        self.msgs = torch.zeros(n_pad, dtype=torch.float32, device=device)
        self.msgs_out = self.msgs[: meta.num_vertices]  # pre's; the rest stays 0
        self.count = int(np.count_nonzero(active_mask))
        self.ids = (np.flatnonzero(active_mask).astype(np.int64)
                    if scheduler.tests_shards(self.count) else None)

    @property
    def ids_to_host(self) -> int:
        return 0 if self.ids is None else len(self.ids)

    def plan(self, scheduler: ShardScheduler):
        return scheduler.plan(self.ids, active_count=self.count)

    def pre(self, plan) -> torch.Tensor:
        src, dst = self.views[self.cur], self.views[1 - self.cur]
        self.program.pre_device(self.arrays[self.cur], self.deg, self.msgs_out)
        for p in plan.skipped:  # the carried values of skipped intervals
            dst[p].copy_(src[p])
        return self.msgs

    def apply(self, res) -> None:
        p = res.shard_id
        self.program.apply_device(res.acc, self.views[self.cur][p],
                                  self.views[1 - self.cur][p], self.meta,
                                  res.v0)

    def activity(self, scheduler: ShardScheduler) -> None:
        changed = self.program.is_active(self.arrays[1 - self.cur],
                                         self.arrays[self.cur])
        # the iteration's one wait for the device
        self.count = int(torch.count_nonzero(changed).item())
        self.ids = (torch.nonzero(changed).view(-1).cpu().numpy()
                    if self.count and scheduler.tests_shards(self.count)
                    else None)
        self.cur = 1 - self.cur

    def values(self) -> np.ndarray:
        return self.arrays[self.cur].cpu().numpy()
