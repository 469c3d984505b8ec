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
mutations, warm restarts and compaction wait for the delta port (ROADMAP
Queue 1 item 6), the telemetry ticker for the observability port (item 7),
and mesh serving for the multi-device port (item 8): each raises
``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
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

__all__ = ["GraphService", "QueryResult", "ServiceOverloaded"]

_DELTA = "ROADMAP Queue 1 item 6"


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is {item}, not ported yet")


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
    graph_version: int = 0  # the graph version the result was computed at


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
        if auto_compact_runs is not None:
            raise _not_ported("auto_compact_runs (background compaction)",
                              _DELTA)
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

        # Latency histograms fed at retirement, sweep stats ingested after
        # every fusion set, so ``metrics_snapshot()`` reports tail latency
        # and stage timings and ``metrics.verify_conservation()`` covers
        # live sweeps.  Outcome counters exist from the start.
        self.metrics = MetricsRegistry()
        self.metrics.counter("query.completed")
        self.metrics.counter("query.rejected")
        self.metrics.counter("shard.load_error")
        self._window_marks: Dict[str, Any] = {}
        #: the per-iteration stats of the last fusion set the worker ran
        self.last_sweep_stats: List[Any] = []

        self._pending: Deque[_Pending] = deque()
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
        package's).  Warm restarts (``warm_state=``, ``prewarm_cache=``)
        wait for the delta port."""
        if warm_state is not None or prewarm_cache:
            raise _not_ported("warm_state= (warm restart)", _DELTA)
        service_kw = cls._split(kwargs)
        return cls(VSWEngine.from_store(root, **kwargs), **service_kw)

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
    def apply_updates(self, inserts=None, deletes=None):
        """Live edge mutations: wait for the delta port."""
        raise _not_ported("apply_updates (live edge mutations)", _DELTA)

    def compact(self):
        """Delta compaction: waits for the delta port."""
        raise _not_ported("compact (delta compaction)", _DELTA)

    def bump_graph_version(self) -> int:
        """Graph versions move with delta publishes: waits for the delta
        port."""
        raise _not_ported("bump_graph_version (graph versions)", _DELTA)

    def save_warm_state(self, directory: str, *, step: Optional[int] = None,
                        keep: int = 2) -> str:
        """Warm-restart checkpoints: wait for the delta port."""
        raise _not_ported("save_warm_state (warm restart)", _DELTA)

    def start_telemetry(self, **kwargs):
        """The telemetry ticker: waits for the observability port."""
        raise _not_ported("start_telemetry (time series and SLOs)",
                          "ROADMAP Queue 1 item 7")

    # --------------------------------------------------------- worker loop
    def _serve_loop(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._closed:
                    self._cond.wait()
                if not self._pending and self._closed:
                    return
                groups = self.batcher.form_fused(self._pending)
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
            # Conservation identities get declared per iteration and the
            # stage-timing histograms feed metrics_snapshot.
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
            return {
                "queries_completed": done,
                "sweeps": self._sweeps,
                "multi_group_sweeps": self._multi_group_sweeps,
                "pending": len(self._pending),
                "bytes_read_total": self._bytes_read,
                "shard_loads_total": self._shard_loads,
                "loads_per_query": self._shard_loads / done if done else 0.0,
                "session_hits": self.sessions.hits,
                "session_misses": self.sessions.misses,
                "graph_version": self.graph_version,
                "mesh_devices": 0,
            }

    def metrics_snapshot(self, *, window: bool = False) -> Dict[str, Any]:
        """Tail-latency + stage-timing snapshot (DESIGN.md §11).

        Percentile blocks are log-bucket estimates: per-query latency split
        into queue wait vs sweep time, per-sweep stage timings, an
        ``errors`` block of outcome counters, and the outcome of replaying
        every conservation identity declared by the sweeps ingested so far
        (empty list = all conserved).  ``window=True`` reports each
        histogram over the records since the previous windowed snapshot.
        """
        trace.publish_drops(self.metrics)

        def block(name: str) -> Dict[str, Any]:
            hist = self.metrics.histogram(name)
            if not window:
                return hist.percentiles()
            win = hist.window_since(self._window_marks.get(name))
            self._window_marks[name] = hist.state()
            return win.percentiles()

        return {
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

    # ----------------------------------------------------------- lifecycle
    def close(self, *, close_engine: bool = True) -> None:
        """Drain the queue, stop the worker, release the engine.
        Idempotent and thread-safe: every caller returns only once the
        serve worker has exited."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        with self._close_lock:
            if self._worker.is_alive():
                self._worker.join()  # drains queued queries
            if close_engine and not self._engine_closed:
                self._engine_closed = True
                self.engine.close()

    def __enter__(self) -> "GraphService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
