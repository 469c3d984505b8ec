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
- compressed edge cache consulted before every disk read (§II-D-2),
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
            shards into one launch.
==========  ===============================================================

All layer combinations produce bit-identical values: the plan fixes the
processing order, only the consumer thread touches the vertex arrays, and
batched dispatch is a pure concatenation (DESIGN.md §5).

The vertex arrays and the programs stay numpy on the host; the ``torch``
and ``cuda`` backends run the per-shard update on ``device``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import weakref
from typing import Dict, List, Optional

import numpy as np

from ..obs import trace
from .apps import VertexProgram
from .cache import ShardCache, select_cache_mode
from .csr import DeviceEll
from .executor import BACKENDS, ExecStats, make_executor, resolve_device
from .graph import Graph
from .pipeline import PipelineStats, ShardPipeline
from .scheduler import ShardScheduler
from .sharding import preprocess
from .storage import ShardStore

__all__ = ["IterStats", "RunResult", "VSWEngine", "BACKENDS"]


@dataclasses.dataclass
class IterStats:
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
    load_wait_s: float = 0.0  # critical-path stall waiting on loads
    load_overlap_s: float = 0.0  # load work hidden behind compute
    to_device_s: float = 0.0  # consumer-side host->device shard copies
    exec_s: float = 0.0  # backend dispatch wall time
    kernel_s: float = 0.0  # device time of the updates (CUDA events)
    dispatches: int = 0  # kernel dispatches (< processed when batching)
    padding_ratio: float = 0.0  # of the dispatched ELL slots
    prefetch_depth: int = 0


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
        bloom_fp: float = 0.01,
        exact_selective: bool = False,
        device_resident: bool = False,
        prefetch_depth: int = 2,
        batch_shards: int = 1,
        mesh=None,
    ):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend}; have {sorted(BACKENDS)}")
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (multi-device sweeps) is ROADMAP Queue 1 item 8, "
                "not ported yet")
        self.device = resolve_device(device)
        self.store = store
        self.meta = store.read_meta()
        self.backend_name = backend
        if cache_bytes > 0 and cache_mode == 0:
            # GraphH-style auto mode selection on a sample shard (§II-D-2)
            sample = store.shard_bytes(0, self._fmt)
            total = sum(
                store.file_size(store.shard_name(p, self._fmt))
                for p in range(self.meta.num_shards)
            )
            cache_mode = select_cache_mode(sample, cache_bytes, total)
        self.cache = ShardCache(cache_bytes, cache_mode) if cache_bytes > 0 else None
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
        )
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

    def _on_shard_invalidated(self, p: int) -> None:
        """Store callback: shard ``p`` was overwritten on disk."""
        if self.cache is not None:
            self.cache.invalidate(p)
        self.pipeline.drop_resident(p)

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

    @contextlib.contextmanager
    def _sweep_session(self):
        """One sweep's delta scope.  The reference pins a delta overlay
        version here; the port's stores carry no delta files (the store
        refuses them, ROADMAP Queue 1 item 6), so there is nothing to pin."""
        yield None

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
            return self._run(program, max_iters=max_iters)

    def _run(self, program: VertexProgram, *, max_iters: int) -> RunResult:
        meta = self.meta
        src_vals, active_mask = program.init(meta)
        src_vals = src_vals.astype(np.float32)
        active_ids = np.flatnonzero(active_mask).astype(np.int64)
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
                plan = self.scheduler.plan(active_ids)
                msgs = program.pre(src_vals, meta.out_deg).astype(np.float32)
                dst_vals = src_vals.copy()  # carried over for skipped shards

                loaded = self.pipeline.iter_shards(plan.shards, stats=pstats)
                try:
                    for res in self.executor.run(
                        loaded, msgs, program.combine, xstats
                    ):
                        new = program.apply(
                            np.asarray(res.acc, dtype=src_vals.dtype),
                            src_vals[res.v0: res.v1],
                            meta,
                            res.v0,
                        )
                        dst_vals[res.v0: res.v1] = new
                finally:
                    # Deterministic drain: on a failure the prefetch window
                    # is cancelled+awaited NOW, not at GC.
                    loaded.close()
                it_sp.set(shards=plan.num_planned, skipped=plan.num_skipped)

            new_active = program.is_active(dst_vals, src_vals)
            active_ids = np.flatnonzero(new_active).astype(np.int64)
            src_vals = dst_vals
            dio = self.store.io - io0

            stats.append(
                IterStats(
                    iteration=it,
                    time_s=time.perf_counter() - t0,
                    shards_processed=plan.num_planned,
                    shards_skipped=plan.num_skipped,
                    bytes_read=dio.bytes_read,
                    cache_hits=(self.cache.stats.hits - cache_h0) if self.cache else 0,
                    cache_misses=(self.cache.stats.misses - cache_m0)
                    if self.cache
                    else 0,
                    active_count=len(active_ids),
                    active_ratio=len(active_ids) / max(meta.num_vertices, 1),
                    selective_on=plan.selective_on,
                    load_total_s=pstats.load_total_s,
                    load_wait_s=pstats.wait_s,
                    load_overlap_s=pstats.overlap_s,
                    to_device_s=pstats.to_device_s,
                    exec_s=xstats.exec_s,
                    kernel_s=xstats.kernel_s,
                    dispatches=xstats.dispatches,
                    padding_ratio=xstats.padding_ratio,
                    prefetch_depth=self.pipeline.depth,
                )
            )
            if len(active_ids) == 0:
                converged = True
                break

        return RunResult(values=src_vals, iterations=stats, converged=converged)
