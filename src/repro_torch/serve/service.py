"""GraphService: a warm, concurrent multi-query serving front end.

One resident :class:`~repro_torch.core.vsw.VSWEngine` (Bloom filters built
once, cache warm, prefetch pool up) answers a stream of per-source
queries.  Callers ``submit()`` from any thread and get a ``Future``; a
single serve worker forms *fusion sets* from the pending queue
(:class:`~repro_torch.serve.batcher.LaneBatcher`): requests sharing a
combine algebra — BFS, SSSP and WCC together, PPR at any damping together
— fuse into one lane table, and up to ``max_groups`` algebra groups
interleave on ONE shard stream (:class:`~repro_torch.serve.sweep.
FusedSweep`).  Each future resolves the moment its lane retires, and lanes
freed by early convergence are backfilled from the queue mid-sweep, per
group.

Admission control is the lane budget: at most ``max_lanes`` queries per
group and ``max_groups`` groups ride one sweep, and (optionally) at most
``max_pending`` may queue — :class:`ServiceOverloaded` is the
back-pressure signal.  Finished results land in a
:class:`~repro_torch.serve.session.SessionCache` keyed by (program,
source, graph-version), so repeat queries bypass the queue.

The engine runs on ``device`` (default ``"cuda"``; pass ``device="cpu"``
to serve on the CPU, where the kernels' plain versions run).  Live edge
mutations (:meth:`GraphService.apply_updates`) publish between sweeps as
delta runs (:mod:`repro_torch.delta`); a shard with pending runs is decoded
on the host through the overlay and never served from the resident device
copy until compaction folds the runs into its base.  Warm restarts
(``from_store(warm_state=)``, :meth:`GraphService.save_warm_state`) use
:mod:`repro_torch.checkpoint.warm_state`.  :meth:`GraphService.
start_telemetry` runs a ticker that closes time-series windows of the
service's metrics and evaluates SLO burn rates (:mod:`repro_torch.obs`).
Mesh serving (DESIGN.md §10): ``mesh=`` passes through every factory to
:class:`~repro_torch.core.vsw.VSWEngine`, and every sweep then dispatches
per-device slices ("1 host read, G x D slices"); results are bitwise the
single-device service's, and ``stats()["mesh_devices"]`` reports D.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np

from ..core.apps import LaneProgram, get_lane_program
from ..core.graph import Graph
from ..core.pipeline import ShardLoadError
from ..core.vsw import VSWEngine
from ..obs import trace
from ..obs.metrics import MetricsRegistry
from .batcher import LaneBatcher
from .session import SessionCache
from .sweep import FusedSweep, LaneResult, LaneSeed

__all__ = ["GraphService", "QueryResult", "ServiceOverloaded", "UpdateResult"]


class ServiceOverloaded(RuntimeError):
    """Raised by ``submit`` when the pending queue is at its admission cap."""


@dataclasses.dataclass
class QueryResult:
    """One answered query plus its attributed cost."""

    request_id: int
    program: str
    source: int
    values: np.ndarray  # [n] final vertex values
    iterations: int
    converged: bool
    latency_s: float  # submit -> future resolution (queue wait + sweep)
    # Mask-aware cost shares: each planned shard's load (and the bytes
    # behind it) is split over only the lanes it was dispatched for.
    bytes_read: float  # this query's share of sweep disk bytes
    shard_loads: float  # this query's share of shard fetches
    lanes: int  # lane capacity of the fusion GROUP that served it
    # ``latency_s == queue_wait_s + sweep_s`` for lane-served results; both
    # are 0.0 for session-cache hits.
    queue_wait_s: float = 0.0
    sweep_s: float = 0.0
    cached: bool = False  # served from the session cache
    groups: int = 1  # program groups interleaved on the serving sweep
    # The graph version this result was computed at.  Every sweep runs
    # pinned to ONE version (updates publish strictly between sweeps), so a
    # result is never a mix of two edge states.
    graph_version: int = 0


@dataclasses.dataclass
class UpdateResult:
    """One applied mutation batch: the version that made it visible.

    ``edges_inserted`` / ``edges_removed`` / ``shards_touched`` describe
    the PUBLISH GROUP the batch rode in: batches staged while the worker
    was busy are folded into one publish (one version bump), and every
    batch's future reports that group's aggregate extent.
    """

    graph_version: int
    edges_inserted: int
    edges_removed: int
    shards_touched: Tuple[int, ...]
    latency_s: float


@dataclasses.dataclass
class _PendingUpdate:
    """One staged ``apply_updates`` batch awaiting the next publish point."""

    inserts: Optional[Tuple]
    deletes: Optional[Tuple]
    future: "Future[UpdateResult]"
    t_submit: float


@dataclasses.dataclass
class _Pending:
    """Queue entry; doubles as the sweep's lane token."""

    request_id: int
    program: str
    source: int
    max_iters: int
    prog: LaneProgram
    future: "Future[QueryResult]"
    t_submit: float
    t_admit: float = 0.0  # set when a fusion set takes the entry

    @property
    def key(self) -> Tuple:
        return self.prog.key

    @property
    def combine_key(self) -> Tuple:
        return self.prog.combine_key


class GraphService:
    """Serve concurrent BFS / SSSP / WCC / PPR queries from one warm
    engine, fusing and interleaving them onto shared shard streams."""

    def __init__(
        self,
        engine: VSWEngine,
        *,
        max_lanes: int = 16,
        pad_pow2: bool = True,
        batch_shards: int = 1,
        session_entries: int = 256,
        max_pending: Optional[int] = None,
        graph_version: int = 0,
        lane_selective: bool = True,
        auto_compact_runs: Optional[int] = None,
        max_groups: int = 2,
        fuse_programs: bool = True,
        ragged: bool = True,
    ):
        self.engine = engine
        self.batcher = LaneBatcher(max_lanes, pad_pow2=pad_pow2,
                                   max_groups=max_groups,
                                   fuse_programs=fuse_programs)
        self.sessions = SessionCache(session_entries)
        self.batch_shards = batch_shards
        self.max_pending = max_pending
        self.graph_version = graph_version
        self.lane_selective = lane_selective
        # Ragged (DESIGN.md §14): one ragged launch per shard batch covers
        # every fusion group (torch/cuda lane executors).
        self.ragged = ragged
        # Set by ``from_store(warm_state=...)``: the apply_warm_state report
        # (None = no warm restore was attempted).
        self.warm_restore_report: Optional[Dict[str, Any]] = None

        # Latency histograms fed at retirement, sweep stats ingested after
        # every fusion set, so ``metrics_snapshot()`` reports tail latency
        # and stage timings and ``metrics.verify_conservation()`` covers
        # live sweeps.  Outcome counters exist from the start.
        self.metrics = MetricsRegistry()
        self.metrics.counter("query.completed")
        self.metrics.counter("query.rejected")
        self.metrics.counter("shard.load_error")
        # The telemetry ticker (``start_telemetry``): a cadenced thread
        # closing TimeSeriesRegistry windows + optional SLO evaluation.
        self._telemetry = None  # (ts, monitor, thread, stop_event)
        self._telemetry_lock = threading.Lock()
        # Window marks for ``metrics_snapshot(window=True)``.
        self._window_marks: Dict[str, Any] = {}
        #: the per-iteration stats of the last fusion set the worker ran
        self.last_sweep_stats: List[Any] = []

        self._pending: Deque[_Pending] = deque()
        self._updates: Deque[_PendingUpdate] = deque()
        self._edge_log = None  # lazy: most services never mutate
        self._cond = threading.Condition()
        self._closed = False
        self._engine_closed = False
        self._close_lock = threading.Lock()
        self._ids = itertools.count()
        # aggregate counters (worker-thread writes, snapshot under the lock)
        self._queries_done = 0
        self._sweeps = 0
        self._multi_group_sweeps = 0
        self._bytes_read = 0.0
        self._shard_loads = 0.0
        self._updates_done = 0
        # LSM-style background maintenance: absorb pending delta runs into
        # base shards once a shard accumulates ``auto_compact_runs`` runs.
        # The recompactor coordinates with sweeps through overlay pins, so
        # it is safe while queries are in flight.
        self._recompactor = None
        if auto_compact_runs is not None:
            from ..delta import Recompactor

            self._recompactor = Recompactor(engine.store,
                                            min_runs=auto_compact_runs)
            self._recompactor.start()
        self._worker = threading.Thread(target=self._serve_loop,
                                        name="graphserve-worker", daemon=True)
        self._worker.start()

    # ------------------------------------------------------------- factory
    #
    # Service-level options are consumed here, everything else flows to the
    # engine constructor (``device=`` included).  ``__init__`` stays the
    # single source of the default values.
    _SERVICE_KWARGS = (
        "max_lanes",
        "pad_pow2",
        "batch_shards",
        "session_entries",
        "max_pending",
        "graph_version",
        "lane_selective",
        "auto_compact_runs",
        "max_groups",
        "fuse_programs",
        "ragged",
    )

    @classmethod
    def _split(cls, kwargs: Dict[str, Any]) -> Dict[str, Any]:
        """Pop the service-level options the caller actually passed."""
        return {k: kwargs.pop(k) for k in cls._SERVICE_KWARGS if k in kwargs}

    @classmethod
    def from_graph(cls, graph: Graph, root: str, **kwargs) -> "GraphService":
        """Preprocess ``graph`` into ``root``, warm an engine, start serving.

        Service options (``max_lanes``, ``pad_pow2``, ``batch_shards``, ...)
        are consumed here; the rest (``device=``, default ``"cuda"``, among
        them) go to :meth:`VSWEngine.from_graph`.
        """
        service_kw = cls._split(kwargs)
        return cls(VSWEngine.from_graph(graph, root, **kwargs), **service_kw)

    @classmethod
    def from_store(cls, root: str, *, warm_state=None,
                   prewarm_cache: bool = False, **kwargs) -> "GraphService":
        """Serve from an already-populated store directory (either
        package's, e.g. one built by ``ShardStore.ingest``).

        ``warm_state`` (DESIGN.md §12) restores a warm-restart checkpoint:
        a :class:`~repro_torch.checkpoint.warm_state.WarmState` or a
        checkpoint directory (its latest snapshot; either package's).
        Still-valid per-shard source arrays are deposited before the engine
        builds its filters — those shards are not read at boot — and, when
        the store's graph content is unchanged since the snapshot, the
        session cache is repopulated.  The store on disk is ALWAYS
        authoritative: a stale or mismatched snapshot degrades to a cold
        boot (see ``warm_restore_report``), never to wrong answers.
        ``prewarm_cache=True`` also re-reads the snapshot's byte-cache warm
        set into the new engine's cache.
        """
        service_kw = cls._split(kwargs)
        if warm_state is None:
            return cls(VSWEngine.from_store(root, **kwargs), **service_kw)
        from ..checkpoint import warm_state as _ws
        from ..core.storage import ShardStore

        ws = warm_state
        if isinstance(ws, (str, os.PathLike)):
            ws = _ws.WarmStateCheckpointer(str(ws)).restore()
        store = ShardStore(root, emulate_bw=kwargs.pop("emulate_bw", None))
        report = _ws.apply_warm_state(store, ws)
        engine = VSWEngine(store, **kwargs)
        if prewarm_cache:
            report["cache_prewarmed"] = _ws.prewarm_cache(engine, ws)
        if report["valid"]:
            service_kw.setdefault("graph_version", ws.graph_version)
        svc = cls(engine, **service_kw)
        report["sessions_restored"] = svc._restore_warm_sessions(ws, report)
        svc.warm_restore_report = report
        return svc

    @classmethod
    def from_edge_file(cls, path: str, root: str, **kwargs) -> "GraphService":
        """Stream-ingest an edge file into ``root`` (bounded-memory external
        build) and start serving from it; ``device=`` (default ``"cuda"``)
        goes to the engine with the other engine options."""
        service_kw = cls._split(kwargs)
        return cls(VSWEngine.from_edge_file(path, root, **kwargs), **service_kw)

    # -------------------------------------------------------------- submit
    def submit(self, program: str, source: int, *, max_iters: int = 100,
               **params) -> "Future[QueryResult]":
        """Queue one query; the future resolves when its lane retires.

        Session-cache hits resolve immediately without occupying a lane.
        Raises :class:`ServiceOverloaded` when ``max_pending`` is reached.
        """
        if self._closed:
            raise RuntimeError("GraphService is closed")
        if not (0 <= source < self.engine.meta.num_vertices):
            raise ValueError(f"source {source} out of range")
        prog = get_lane_program(program, **params)
        t0 = time.perf_counter()
        fut: "Future[QueryResult]" = Future()

        cache_key = (prog.key, int(source), self.graph_version)
        # A cached result answers this request iff it converged within the
        # budget or ran exactly the requested budget; an unsuitable entry
        # counts as a miss (the query re-runs on a lane).
        cached = self.sessions.get(
            cache_key,
            lambda c: (c.converged and c.iterations <= max_iters)
            or c.iterations == max_iters,
        )
        if cached is not None:
            latency = time.perf_counter() - t0
            self.metrics.histogram("query.latency_s").record(latency)
            self.metrics.counter("query.completed").add(1)
            trace.instant("service.cache_hit", program=program, source=source)
            fut.set_result(dataclasses.replace(
                cached, request_id=next(self._ids),
                values=cached.values.copy(), latency_s=latency,
                queue_wait_s=0.0, sweep_s=0.0, bytes_read=0.0,
                shard_loads=0.0, cached=True))
            return fut

        entry = _Pending(request_id=next(self._ids), program=program,
                         source=int(source), max_iters=max_iters, prog=prog,
                         future=fut, t_submit=t0)
        with trace.span("service.admit", program=program, source=source):
            with self._cond:
                if self._closed:
                    raise RuntimeError("GraphService is closed")
                if (self.max_pending is not None
                        and len(self._pending) >= self.max_pending):
                    self.metrics.counter("query.rejected").add(1)
                    trace.instant("service.rejected", program=program,
                                  source=source)
                    raise ServiceOverloaded(
                        f"pending queue at admission cap ({self.max_pending})")
                self._pending.append(entry)
                self._cond.notify_all()
        return fut

    def query(self, program: str, source: int, *, max_iters: int = 100,
              **params) -> QueryResult:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(program, source, max_iters=max_iters,
                           **params).result()

    @contextlib.contextmanager
    def submit_batch(self):
        """Admit several queries atomically: while the block is open the
        serve worker cannot pop the queue, so everything submitted inside
        is eligible for ONE fusion set.  Do not block on
        ``Future.result()`` inside the block — the worker cannot run
        until it closes.
        """
        with self._cond:
            yield self

    # ------------------------------------------------------------- updates
    def apply_updates(self, inserts=None,
                      deletes=None) -> "Future[UpdateResult]":
        """Stage one edge-mutation batch; the future resolves once the
        batch is PUBLISHED (durable delta runs + a new graph version).

        Updates become visible atomically between sweeps: queries already
        riding a sweep finish on the version they started at; any fusion
        set formed after the publish runs on the new version.  Batch
        semantics (deletes before inserts, a delete removes all copies) are
        :class:`~repro_torch.delta.EdgeLog`'s.  Vertex ids must lie in the
        store's fixed ``[0, num_vertices)`` range.
        """
        if self._closed:
            raise RuntimeError("GraphService is closed")
        from ..delta.edgelog import _norm_edges  # validate on caller thread

        n = self.engine.meta.num_vertices
        ins = _norm_edges(inserts, n, "inserts")
        dels = _norm_edges(deletes, n, "deletes")
        fut: "Future[UpdateResult]" = Future()
        upd = _PendingUpdate(inserts=ins, deletes=dels, future=fut,
                             t_submit=time.perf_counter())
        with self._cond:
            if self._closed:
                raise RuntimeError("GraphService is closed")
            self._updates.append(upd)
            self._cond.notify_all()
        return fut

    def _publish_updates(self, updates: List[_PendingUpdate]) -> None:
        """Publish staged mutation batches (worker thread, between sweeps)."""
        if self._edge_log is None:
            from ..delta import EdgeLog

            self._edge_log = EdgeLog(self.engine.store)
        try:
            with trace.span("service.publish", batches=len(updates)):
                for u in updates:
                    self._edge_log.append(inserts=u.inserts, deletes=u.deletes)
                pub = self._edge_log.publish()
        except BaseException as exc:
            for u in updates:
                if not u.future.done():
                    u.future.set_exception(exc)
            return
        with self._cond:
            self.graph_version += 1
            version = self.graph_version
            self._updates_done += len(updates)
        self.sessions.drop_stale_versions(version)
        for u in updates:
            u.future.set_result(UpdateResult(
                graph_version=version, edges_inserted=pub.edges_inserted,
                edges_removed=pub.edges_removed,
                shards_touched=pub.shards_touched,
                latency_s=time.perf_counter() - u.t_submit))

    def bump_graph_version(self) -> int:
        """Invalidate all cached results (graph changed underneath).  For
        actual edge mutations use :meth:`apply_updates`, which bumps the
        version itself at the publish point."""
        with self._cond:
            self.graph_version += 1
            v = self.graph_version
        self.sessions.drop_stale_versions(v)
        return v

    def compact(self):
        """Synchronously absorb every pending delta run into the base
        shards (safe while serving — coordinates with sweeps through
        overlay pins).  Each compacted shard's resident device copy is
        dropped by the invalidation hook; the next sweep keeps the new
        base resident.  Returns :class:`~repro_torch.delta.CompactionStats`."""
        from ..delta import Recompactor

        rc = self._recompactor or Recompactor(self.engine.store)
        return rc.compact(rc.dirty_shards())

    def save_warm_state(self, directory: str, *, step: Optional[int] = None,
                        keep: int = 2) -> str:
        """Snapshot this service's warm state (Bloom sources, byte-cache
        warm set, delta coordinates, session-cache results) into an atomic
        on-disk checkpoint (DESIGN.md §12).  Safe while serving; restore
        with ``GraphService.from_store(root, warm_state=directory)``.
        Returns the committed snapshot directory."""
        from ..checkpoint.warm_state import (
            WarmStateCheckpointer,
            capture_warm_state,
        )

        state = capture_warm_state(self)
        return WarmStateCheckpointer(directory, keep=keep).save(state, step=step)

    def _restore_warm_sessions(self, ws, report) -> int:
        """Repopulate the session cache from a snapshot whose graph content
        provably matches the store (``report["sessions_valid"]``)."""
        if not report.get("valid") or not report.get("sessions_valid"):
            return 0
        n = 0
        for e in ws.sessions:
            qr = QueryResult(
                request_id=-1, program=e.program, source=e.source,
                values=np.asarray(e.values), iterations=e.iterations,
                converged=e.converged, latency_s=0.0, bytes_read=0.0,
                shard_loads=0.0, lanes=0, cached=True,
                graph_version=self.graph_version)
            self.sessions.put((tuple(e.key), int(e.source), self.graph_version),
                              qr)
            n += 1
        return n

    # ----------------------------------------------------------- telemetry
    def start_telemetry(self, *, interval_s: float = 0.25,
                        capacity: int = 2048, slos=None, windows=None):
        """Start the telemetry cadence: a daemon ticker that closes one
        :class:`~repro_torch.obs.timeseries.TimeSeriesRegistry` window every
        ``interval_s`` seconds (and mirrors tracer ring drops into the
        registry).  Pass ``slos`` (a list of :class:`~repro_torch.obs.slo.
        SLO`) to also evaluate multi-window burn rates each tick; violations
        then appear in ``metrics_snapshot()["slo"]``.

        Returns the :class:`TimeSeriesRegistry`; the optional monitor is at
        :attr:`slo_monitor`.  Starting twice raises (stop first), so two
        tickers can never double-diff the counter marks.
        """
        from ..obs.slo import SLOMonitor
        from ..obs.timeseries import TimeSeriesRegistry

        with self._telemetry_lock:
            if self._telemetry is not None:
                raise RuntimeError("telemetry already running")
            ts = TimeSeriesRegistry(self.metrics, capacity=capacity,
                                    interval_s=interval_s)
            monitor = None
            if slos:
                kw = {"windows": windows} if windows is not None else {}
                monitor = SLOMonitor(ts, slos, **kw)
            stop = threading.Event()

            def loop() -> None:
                while not stop.wait(interval_s):
                    trace.publish_drops(self.metrics)
                    ts.tick()
                    if monitor is not None:
                        monitor.evaluate()

            th = threading.Thread(target=loop, name="graphpulse-ticker",
                                  daemon=True)
            self._telemetry = (ts, monitor, th, stop)
            th.start()
            return ts

    def stop_telemetry(self, *, final_tick: bool = True):
        """Stop the telemetry ticker (no-op when not running); optionally
        close one last window so the run's tail isn't lost to cadence
        truncation.  Returns the (now quiescent) TimeSeriesRegistry or
        None."""
        with self._telemetry_lock:
            tel, self._telemetry = self._telemetry, None
        if tel is None:
            return None
        ts, monitor, th, stop = tel
        stop.set()
        th.join()
        if final_tick:
            trace.publish_drops(self.metrics)
            ts.tick()
            if monitor is not None:
                monitor.evaluate()
        return ts

    @property
    def timeseries(self):
        """The live TimeSeriesRegistry, or None when telemetry is off."""
        with self._telemetry_lock:
            return self._telemetry[0] if self._telemetry else None

    @property
    def slo_monitor(self):
        """The live SLOMonitor, or None (telemetry off / no SLOs given)."""
        with self._telemetry_lock:
            return self._telemetry[1] if self._telemetry else None

    # --------------------------------------------------------- worker loop
    def _serve_loop(self) -> None:
        while True:
            with self._cond:
                while (not self._pending and not self._updates
                       and not self._closed):
                    self._cond.wait()
                if not self._pending and not self._updates and self._closed:
                    return
                updates: List[_PendingUpdate] = list(self._updates)
                self._updates.clear()
                groups = (self.batcher.form_fused(self._pending)
                          if self._pending else [])
            if updates:
                # Publish BEFORE the next sweep: the fusion set just formed
                # (and everything after it) runs on the new version.
                # Sweeps and publishes share this worker thread, so they
                # never interleave.
                self._publish_updates(updates)
            if groups:
                self._run_fusion_set(groups)

    def _run_fusion_set(self, groups: List[List[_Pending]]) -> None:
        """Run one fusion set — up to ``max_groups`` algebra groups on one
        shared shard stream — resolving each future as its lane retires."""
        capacities = [self.batcher.capacity(len(g)) for g in groups]
        group_keys = [self.batcher.group_key(g[0]) for g in groups]
        n_groups = len(groups)
        resolved: set = set()
        admitted: List[_Pending] = [p for g in groups for p in g]
        t_admit0 = time.perf_counter()
        for p in admitted:
            p.t_admit = t_admit0
        # The whole sweep — lanes backfilled mid-flight included — runs at
        # this version: publishes only happen on this thread between sweeps.
        version = self.graph_version

        def backfill(group: int, n_free: int) -> List[LaneSeed]:
            with self._cond:
                taken = self.batcher.take_fusable(self._pending,
                                                  group_keys[group], n_free)
            t_admit = time.perf_counter()
            for p in taken:
                p.t_admit = t_admit
            admitted.extend(taken)
            return [LaneSeed(source=p.source, max_iters=p.max_iters, token=p,
                             program=p.prog) for p in taken]

        def on_retire(res: LaneResult) -> None:
            p: _Pending = res.token
            now = time.perf_counter()
            with trace.span("service.retire", program=p.program,
                            source=p.source, group=res.group):
                qr = QueryResult(
                    request_id=p.request_id,
                    program=p.program,
                    source=p.source,
                    values=res.values,
                    iterations=res.iterations,
                    converged=res.converged,
                    latency_s=now - p.t_submit,
                    queue_wait_s=p.t_admit - p.t_submit,
                    sweep_s=now - p.t_admit,
                    bytes_read=res.bytes_read,
                    shard_loads=res.shard_loads,
                    lanes=capacities[res.group],
                    graph_version=version,
                    groups=n_groups,
                )
                self.metrics.histogram("query.latency_s").record(qr.latency_s)
                self.metrics.histogram("query.queue_wait_s").record(
                    qr.queue_wait_s)
                self.metrics.histogram("query.sweep_s").record(qr.sweep_s)
                # Cache a private copy: the caller owns ``qr.values`` and may
                # mutate it; later hits must still see the computed result.
                self.sessions.put((p.prog.key, p.source, version),
                                  dataclasses.replace(qr, values=res.values.copy()))
                self.metrics.counter("query.completed").add(1)
                resolved.add(p.request_id)
                with self._cond:
                    self._queries_done += 1
                    self._bytes_read += res.bytes_read
                    self._shard_loads += res.shard_loads
                p.future.set_result(qr)

        seed_groups = [[LaneSeed(source=p.source, max_iters=p.max_iters,
                                 token=p, program=p.prog) for p in g]
                       for g in groups]
        sweep = FusedSweep(self.engine, batch_shards=self.batch_shards,
                           pad_pow2=self.batcher.pad_pow2,
                           lane_selective=self.lane_selective,
                           ragged=self.ragged)
        try:
            with trace.span("service.fusion_set", groups=n_groups,
                            lanes=sum(len(g) for g in groups)):
                sweep.run(seed_groups, backfill=backfill, on_retire=on_retire)
        except BaseException as exc:  # propagate to every unresolved caller
            if isinstance(exc, ShardLoadError):
                self.metrics.counter("shard.load_error").add(1)
            for p in admitted:
                if p.request_id not in resolved and not p.future.done():
                    p.future.set_exception(exc)
        finally:
            # Conservation identities (the mesh device splits included) get
            # declared per iteration and the stage-timing histograms feed
            # metrics_snapshot.
            for st in sweep.iter_stats:
                self.metrics.ingest(st)
                self.metrics.histogram("stage.load_s").record(st.load_total_s)
                self.metrics.histogram("stage.load_wait_s").record(
                    st.load_wait_s)
                self.metrics.histogram("stage.exec_s").record(st.exec_s)
            with self._cond:
                self._sweeps += 1
                if n_groups > 1:
                    self._multi_group_sweeps += 1
                self.last_sweep_stats = list(sweep.iter_stats)

    # --------------------------------------------------------------- stats
    def stats(self) -> Dict[str, Any]:
        """Aggregate serving counters (loads/bytes are lane-attributed)."""
        with self._cond:
            done = self._queries_done
            out = {
                "queries_completed": done,
                "sweeps": self._sweeps,
                "multi_group_sweeps": self._multi_group_sweeps,
                "pending": len(self._pending),
                "bytes_read_total": self._bytes_read,
                "shard_loads_total": self._shard_loads,
                "loads_per_query": self._shard_loads / done if done else 0.0,
                "session_hits": self.sessions.hits,
                "session_misses": self.sessions.misses,
                "updates_published": self._updates_done,
                "updates_pending": len(self._updates),
                "graph_version": self.graph_version,
                # the engine's mesh= boot path; 0 on single-device services
                "mesh_devices": (self.engine.partition.n_dev
                                 if self.engine.partition is not None else 0),
            }
        delta = self.engine.store.delta
        out["dirty_shards"] = len(delta.dirty_shards()) if delta else 0
        if self._recompactor is not None:
            out["shards_compacted"] = self._recompactor.total.shards_compacted
        return out

    def metrics_snapshot(self, *, window: bool = False) -> Dict[str, Any]:
        """Tail-latency + stage-timing snapshot (DESIGN.md §11).

        Percentile blocks are log-bucket estimates: per-query latency split
        into queue wait vs sweep time, per-sweep stage timings, an
        ``errors`` block of outcome counters, and the outcome of replaying
        every conservation identity declared by the sweeps ingested so far
        (empty list = all conserved).  ``window=True`` reports each
        histogram over the records since the previous windowed snapshot.
        While :meth:`start_telemetry` is active, ``timeseries`` and ``slo``
        blocks report ring occupancy and the SLO monitor's burn rates and
        violation records.
        """
        trace.publish_drops(self.metrics)

        def block(name: str) -> Dict[str, Any]:
            hist = self.metrics.histogram(name)
            if not window:
                return hist.percentiles()
            win = hist.window_since(self._window_marks.get(name))
            self._window_marks[name] = hist.state()
            return win.percentiles()

        out: Dict[str, Any] = {
            "query_latency_s": block("query.latency_s"),
            "queue_wait_s": block("query.queue_wait_s"),
            "sweep_s": block("query.sweep_s"),
            "stages": {
                "iter_s": block("sweep.time_s"),
                "load_s": block("stage.load_s"),
                "load_wait_s": block("stage.load_wait_s"),
                "exec_s": block("stage.exec_s"),
            },
            "errors": {
                "completed": self.metrics.counter("query.completed").value,
                "rejected": self.metrics.counter("query.rejected").value,
                "shard_load_errors": self.metrics.counter(
                    "shard.load_error").value,
                "trace_dropped_events": trace.dropped_events(),
            },
            "conservation_violations": self.metrics.verify_conservation(
                strict=False),
            "service": self.stats(),
        }
        with self._telemetry_lock:
            tel = self._telemetry
        if tel is not None:
            ts, monitor = tel[0], tel[1]
            out["timeseries"] = {
                "windows": ts.num_windows,
                "retained": len(ts.samples()),
                "dropped_samples": ts.dropped_samples,
                "interval_s": ts.interval_s,
            }
            if monitor is not None:
                out["slo"] = monitor.snapshot()
        return out

    # ----------------------------------------------------------- lifecycle
    def close(self, *, close_engine: bool = True) -> None:
        """Drain the queue, stop the worker, release the engine.
        Idempotent and thread-safe: every caller returns only once the
        telemetry ticker and the serve worker have exited AND any in-flight
        background compaction has been joined (it holds per-shard overlay
        locks mid-swap)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self.stop_telemetry(final_tick=False)
        with self._close_lock:
            if self._worker.is_alive():
                self._worker.join()  # drains queued queries and updates
            rc, self._recompactor = self._recompactor, None
            if rc is not None:
                rc.stop()  # joins the maintenance thread mid-compaction too
            if close_engine and not self._engine_closed:
                self._engine_closed = True
                self.engine.close()

    def __enter__(self) -> "GraphService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
