"""Load harness: closed- and open-loop query streams against a
:class:`~repro_torch.serve.service.GraphService`.

A :class:`Workload` declares a weighted mix of query classes (BFS / SSSP /
WCC / PPR, each with its own ``max_iters`` and program params) plus an
optional concurrent mutation stream; :class:`LoadGenerator` replays it in
one of two modes:

``closed``
    Fixed concurrency: ``concurrency`` worker threads each submit one
    query, block on its future, record the outcome, repeat.  Offered load
    adapts to service speed — the classic closed-loop benchmark shape,
    immune to coordinated omission *by construction only for what it
    measures* (per-query service latency at a fixed population).
``open``
    Arrival-scheduled: one dispatcher submits at ``target_qps`` (evenly
    spaced, or exponential inter-arrivals with ``poisson=True``) without
    waiting for completions, so queueing delay is *measured*, not hidden
    — the load does not slow down because the service did.  Back-pressure
    (:class:`~repro_torch.serve.service.ServiceOverloaded`) is recorded as a
    rejected operation, never retried silently.

Determinism discipline (the bitwise-oracle contract): the entire operation
schedule — per-op class, source, and every mutation batch's edge list —
is pre-generated from ``Workload.seed`` before any thread starts, so the
*set* of (program, source, params) queries and the exact edge state at
every graph version are reproducible no matter how threads interleave.
Each :class:`OpRecord` carries the answering ``graph_version`` and
(optionally) the result values; ``tests/test_torch_pulse.py`` and
``chip_smoke.py``'s ``pulse`` phase replay recorded ops on a solo engine
at exactly that version and assert ``np.array_equal``.

Phases: ops submitted during the first ``warmup_s`` seconds (or the first
``warmup_ops`` operations) are recorded but flagged ``phase="warmup"`` and
excluded from the report's rates/percentiles; submission stops when the
measure budget is exhausted; drain then waits for every in-flight future,
and those completions still land in their submission-time phase.  The
report therefore never truncates a tail latency mid-flight.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .service import GraphService, ServiceOverloaded

__all__ = [
    "LoadGenerator",
    "LoadReport",
    "OpRecord",
    "QueryClass",
    "UpdateRecord",
    "Workload",
]


@dataclasses.dataclass(frozen=True)
class QueryClass:
    """One weighted slice of the query mix."""

    program: str  # "bfs" | "sssp" | "wcc" | "ppr"
    weight: float = 1.0
    max_iters: int = 100
    params: Tuple[Tuple[str, Any], ...] = ()  # e.g. (("damping", 0.85),)

    def __post_init__(self) -> None:
        if self.weight <= 0:
            raise ValueError(f"class {self.program}: weight must be positive")
        if isinstance(self.params, dict):  # ergonomic: accept a dict
            object.__setattr__(
                self, "params", tuple(sorted(self.params.items()))
            )


@dataclasses.dataclass(frozen=True)
class Workload:
    """A declared mix + optional mutation stream, fully seeded."""

    classes: Tuple[QueryClass, ...]
    seed: int = 0
    #: every ``update_every`` queries, one ``apply_updates`` batch of
    #: ``update_batch`` random inserted edges rides along (0 = no stream).
    update_every: int = 0
    update_batch: int = 32

    def __post_init__(self) -> None:
        if not self.classes:
            raise ValueError("workload needs at least one query class")
        if isinstance(self.classes, list):
            object.__setattr__(self, "classes", tuple(self.classes))
        if self.update_every < 0 or self.update_batch <= 0:
            raise ValueError("bad update stream parameters")

    def plan(self, num_vertices: int, total_ops: int) -> "_Plan":
        """Pre-generate the deterministic operation schedule."""
        rng = np.random.default_rng(self.seed)
        w = np.asarray([c.weight for c in self.classes], dtype=np.float64)
        cls_idx = rng.choice(len(self.classes), size=total_ops, p=w / w.sum())
        sources = rng.integers(0, num_vertices, size=total_ops)
        updates: List[np.ndarray] = []
        if self.update_every > 0:
            n_upd = total_ops // self.update_every
            for _ in range(max(n_upd, 0)):
                updates.append(
                    rng.integers(
                        0, num_vertices, size=(self.update_batch, 2)
                    ).astype(np.int64)
                )
        return _Plan(
            cls_idx=cls_idx.astype(np.int64),
            sources=sources.astype(np.int64),
            updates=updates,
        )


@dataclasses.dataclass(frozen=True)
class _Plan:
    """The pre-generated schedule (immutable; shared across workers)."""

    cls_idx: np.ndarray  # [total] index into workload.classes
    sources: np.ndarray  # [total] query source vertices
    updates: List[np.ndarray]  # per-batch [b, 2] inserted edges


@dataclasses.dataclass
class OpRecord:
    """One submitted query and its outcome (success, rejection, or error)."""

    index: int  # position in the pre-generated schedule
    program: str
    source: int
    params: Tuple[Tuple[str, Any], ...]
    max_iters: int
    phase: str  # "warmup" | "measure"
    t_submit: float  # perf_counter at submit
    ok: bool = False
    rejected: bool = False
    error: Optional[str] = None
    latency_s: float = 0.0  # loadgen-observed: submit -> result available
    service_latency_s: float = 0.0  # service-attributed (QueryResult)
    queue_wait_s: float = 0.0
    sweep_s: float = 0.0
    cached: bool = False
    iterations: int = 0
    converged: bool = False
    graph_version: int = -1
    values: Optional[np.ndarray] = None  # kept when keep_values=True


@dataclasses.dataclass
class UpdateRecord:
    """One mutation batch: the edges inserted and the version that shows
    them — enough to rebuild the exact edge state at any version."""

    index: int  # which planned batch
    inserts: np.ndarray  # [b, 2] the actual edges
    t_submit: float
    ok: bool = False
    error: Optional[str] = None
    latency_s: float = 0.0
    graph_version: int = -1


@dataclasses.dataclass
class LoadReport:
    """Aggregates over the MEASURE phase + the full per-op record list."""

    mode: str
    concurrency: int
    target_qps: Optional[float]
    duration_s: float  # measure-phase wall span (first submit -> last done)
    submitted: int
    completed: int
    rejected: int
    errors: int
    cached: int
    qps: float  # completed measure-phase queries / duration_s
    offered_qps: float  # submitted measure-phase queries / submit span
    latency: Dict[str, float]  # exact percentiles over measure completions
    queue_wait: Dict[str, float]
    queue_wait_share: float  # sum(queue_wait) / sum(latency), measure phase
    per_class: Dict[str, int]  # measure-phase completions per program
    updates_submitted: int
    updates_published: int
    records: List[OpRecord]
    updates: List[UpdateRecord]
    warmup_records: int

    def summary(self) -> Dict[str, Any]:
        """The report minus the bulky record lists (export-friendly)."""
        out = dataclasses.asdict(self)
        out.pop("records")
        out.pop("updates")
        return out


def _percentiles(xs: List[float]) -> Dict[str, float]:
    """Exact (sorted-sample) percentiles, same keys as Histogram blocks."""
    if not xs:
        return {"count": 0, "mean": 0.0, "p50": 0.0, "p95": 0.0,
                "p99": 0.0, "max": 0.0}
    arr = np.sort(np.asarray(xs, dtype=np.float64))
    pick = lambda q: float(arr[min(int(q * (len(arr) - 1) + 0.5), len(arr) - 1)])
    return {
        "count": int(len(arr)),
        "mean": float(arr.mean()),
        "p50": pick(0.50),
        "p95": pick(0.95),
        "p99": pick(0.99),
        "max": float(arr[-1]),
    }


class LoadGenerator:
    """Replays a :class:`Workload` against a service; see module docstring.

    Parameters
    ----------
    service:
        The target (already serving).
    workload:
        The seeded mix.  The generator never mutates it.
    mode:
        ``"closed"`` (fixed concurrency) or ``"open"`` (arrival-scheduled).
    concurrency:
        Closed loop: worker-thread population.
    batch_size:
        Closed loop: ops each worker admits atomically per round via
        :meth:`GraphService.submit_batch` (1 = plain ``submit``).  A
        whole chunk is one fusion-set candidate, so this knob trades
        per-query latency for fusion width.
    target_qps:
        Open loop: mean arrival rate (required in open mode).
    poisson:
        Open loop: exponential inter-arrivals instead of even spacing
        (drawn from the workload seed — still deterministic).
    total_ops:
        Length of the pre-generated schedule; submission stops when the
        schedule is exhausted even if time remains.
    warmup_ops:
        Ops at the head of the schedule flagged ``warmup`` (excluded from
        report rates/percentiles, still validated for correctness).
    duration_s:
        Optional wall-clock cap on the submission phase (warmup included).
    keep_values:
        Retain each query's result vector on its record (the oracle
        replay needs them; drop for long memory-bounded soaks).
    """

    def __init__(
        self,
        service: GraphService,
        workload: Workload,
        *,
        mode: str = "closed",
        concurrency: int = 4,
        batch_size: int = 1,
        target_qps: Optional[float] = None,
        poisson: bool = False,
        total_ops: int = 64,
        warmup_ops: int = 0,
        duration_s: Optional[float] = None,
        keep_values: bool = True,
        drain_timeout_s: float = 120.0,
    ):
        if mode not in ("closed", "open"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "open" and (target_qps is None or target_qps <= 0):
            raise ValueError("open mode requires a positive target_qps")
        if mode == "closed" and concurrency <= 0:
            raise ValueError("closed mode requires positive concurrency")
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        if total_ops <= 0:
            raise ValueError("total_ops must be positive")
        if not 0 <= warmup_ops < total_ops:
            raise ValueError("warmup_ops must be in [0, total_ops)")
        self.service = service
        self.workload = workload
        self.mode = mode
        self.concurrency = int(concurrency)
        self.batch_size = int(batch_size)
        self.target_qps = float(target_qps) if target_qps else None
        self.poisson = bool(poisson)
        self.total_ops = int(total_ops)
        self.warmup_ops = int(warmup_ops)
        self.duration_s = duration_s
        self.keep_values = bool(keep_values)
        self.drain_timeout_s = float(drain_timeout_s)

    # ------------------------------------------------------------------ run
    def run(self) -> LoadReport:
        """Execute the workload; returns the full report after drain."""
        svc = self.service
        plan = self.workload.plan(
            svc.engine.meta.num_vertices, self.total_ops
        )
        records: List[Optional[OpRecord]] = [None] * self.total_ops
        upd_records: List[UpdateRecord] = []
        upd_futs: List[Any] = []
        upd_lock = threading.Lock()
        next_op = iter(range(self.total_ops))
        take_lock = threading.Lock()
        t_begin = time.perf_counter()
        deadline = (
            t_begin + self.duration_s if self.duration_s is not None else None
        )
        pending: List[Tuple["Any", OpRecord]] = []  # (future, record)
        pending_lock = threading.Lock()

        def cutoff() -> bool:
            return deadline is not None and time.perf_counter() >= deadline

        def take() -> Optional[int]:
            with take_lock:
                return next(next_op, None)

        def submit_op(i: int) -> Tuple[OpRecord, Optional[Any]]:
            """Submit schedule slot ``i``; returns (record, future|None)."""
            cls = self.workload.classes[int(plan.cls_idx[i])]
            rec = OpRecord(
                index=i,
                program=cls.program,
                source=int(plan.sources[i]),
                params=cls.params,
                max_iters=cls.max_iters,
                phase="warmup" if i < self.warmup_ops else "measure",
                t_submit=time.perf_counter(),
            )
            records[i] = rec
            fut = None
            try:
                fut = svc.submit(
                    cls.program,
                    rec.source,
                    max_iters=cls.max_iters,
                    **dict(cls.params),
                )
            except ServiceOverloaded:
                rec.rejected = True
                rec.latency_s = time.perf_counter() - rec.t_submit
            except Exception as exc:  # typed in the record, not raised
                rec.error = repr(exc)
                rec.latency_s = time.perf_counter() - rec.t_submit

            # interleaved mutation stream: op i triggers batch i/update_every
            ue = self.workload.update_every
            if ue > 0 and (i + 1) % ue == 0:
                bi = (i + 1) // ue - 1
                if bi < len(plan.updates):
                    _submit_update(bi)
            return rec, fut

        def _submit_update(bi: int) -> None:
            edges = plan.updates[bi]
            urec = UpdateRecord(
                index=bi, inserts=edges, t_submit=time.perf_counter()
            )
            with upd_lock:
                upd_records.append(urec)
            try:
                ufut = svc.apply_updates(inserts=edges)
            except Exception as exc:
                urec.error = repr(exc)
                return
            with upd_lock:
                upd_futs.append(ufut)

            def done(f, urec=urec) -> None:
                try:
                    ur = f.result()
                except Exception as exc:
                    urec.error = repr(exc)
                else:
                    urec.ok = True
                    urec.graph_version = ur.graph_version
                    urec.latency_s = ur.latency_s
                urec.latency_s = urec.latency_s or (
                    time.perf_counter() - urec.t_submit
                )

            ufut.add_done_callback(done)

        def _finish(rec: OpRecord, fut) -> None:
            try:
                qr = fut.result(timeout=self.drain_timeout_s)
            except Exception as exc:
                rec.error = repr(exc)
                rec.latency_s = time.perf_counter() - rec.t_submit
                return
            rec.ok = True
            rec.latency_s = time.perf_counter() - rec.t_submit
            rec.service_latency_s = qr.latency_s
            rec.queue_wait_s = qr.queue_wait_s
            rec.sweep_s = qr.sweep_s
            rec.cached = qr.cached
            rec.iterations = qr.iterations
            rec.converged = qr.converged
            rec.graph_version = qr.graph_version
            if self.keep_values:
                rec.values = qr.values

        if self.mode == "closed":
            def take_chunk() -> List[int]:
                with take_lock:
                    out = []
                    for _ in range(self.batch_size):
                        i = next(next_op, None)
                        if i is None:
                            break
                        out.append(i)
                    return out

            def worker() -> None:
                while not cutoff():
                    chunk = take_chunk()
                    if not chunk:
                        return
                    if len(chunk) == 1:
                        rec, fut = submit_op(chunk[0])
                        if fut is not None:
                            _finish(rec, fut)
                        continue
                    # admit the chunk atomically: one fusion-set candidate
                    batch: List[Tuple[OpRecord, Any]] = []
                    with svc.submit_batch():
                        for i in chunk:
                            rec, fut = submit_op(i)
                            if fut is not None:
                                batch.append((rec, fut))
                    for rec, fut in batch:
                        _finish(rec, fut)

            threads = [
                threading.Thread(
                    target=worker, name=f"loadgen-{k}", daemon=True
                )
                for k in range(self.concurrency)
            ]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
        else:
            # open loop: one dispatcher paced by the arrival schedule
            gaps = self._arrival_gaps()
            t_next = time.perf_counter()
            for i in range(self.total_ops):
                if cutoff():
                    break
                t_next += gaps[i]
                delay = t_next - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                rec, fut = submit_op(i)
                if fut is not None:
                    with pending_lock:
                        pending.append((fut, rec))
            # drain: every submitted future must resolve before reporting
            with pending_lock:
                outstanding = list(pending)
            for fut, rec in outstanding:
                _finish(rec, fut)

        # drain the mutation stream too: update records must carry their
        # published graph_version before the report (oracle replay input)
        with upd_lock:
            ufuts = list(upd_futs)
        for uf in ufuts:
            try:
                uf.result(timeout=self.drain_timeout_s)
            except Exception:
                pass  # the done-callback already typed the error

        return self._report([r for r in records if r is not None],
                            upd_records, t_begin)

    def _arrival_gaps(self) -> np.ndarray:
        """Inter-arrival seconds for the open loop (seeded, pre-drawn)."""
        mean_gap = 1.0 / float(self.target_qps)  # type: ignore[arg-type]
        if not self.poisson:
            return np.full(self.total_ops, mean_gap)
        # independent stream: offset seed so the op plan is unchanged
        rng = np.random.default_rng(self.workload.seed + 0x9E3779B9)
        return rng.exponential(mean_gap, size=self.total_ops)

    # --------------------------------------------------------------- report
    def _report(
        self,
        records: List[OpRecord],
        updates: List[UpdateRecord],
        t_begin: float,
    ) -> LoadReport:
        measure = [r for r in records if r.phase == "measure"]
        done = [r for r in measure if r.ok]
        lat = [r.latency_s for r in done]
        qw = [r.queue_wait_s for r in done]
        if done:
            span = max(
                max(r.t_submit + r.latency_s for r in done)
                - min(r.t_submit for r in done),
                1e-9,
            )
            sub_span = max(
                max(r.t_submit for r in measure)
                - min(r.t_submit for r in measure),
                1e-9,
            )
        else:
            span = sub_span = max(time.perf_counter() - t_begin, 1e-9)
        lat_sum = sum(r.latency_s for r in done)
        per_class: Dict[str, int] = {}
        for r in done:
            per_class[r.program] = per_class.get(r.program, 0) + 1
        return LoadReport(
            mode=self.mode,
            concurrency=self.concurrency if self.mode == "closed" else 1,
            target_qps=self.target_qps,
            duration_s=span,
            submitted=len(measure),
            completed=len(done),
            rejected=sum(1 for r in measure if r.rejected),
            errors=sum(1 for r in measure if r.error is not None),
            cached=sum(1 for r in done if r.cached),
            qps=len(done) / span,
            offered_qps=len(measure) / sub_span,
            latency=_percentiles(lat),
            queue_wait=_percentiles(qw),
            queue_wait_share=(sum(qw) / lat_sum) if lat_sum > 0 else 0.0,
            per_class=per_class,
            updates_submitted=len(updates),
            updates_published=sum(1 for u in updates if u.ok),
            records=records,
            updates=updates,
            warmup_records=sum(1 for r in records if r.phase == "warmup"),
        )


def oracle_kwargs(rec: OpRecord) -> Dict[str, Any]:
    """The :func:`repro_torch.core.apps.get_program` kwargs that make a solo
    engine answer exactly this record's query (WCC takes no source)."""
    kw: Dict[str, Any] = dict(rec.params)
    if rec.program != "wcc":
        kw["source"] = rec.source
    return kw


def edge_state_at_version(
    initial_edges: np.ndarray,
    updates: Sequence[UpdateRecord],
    version: int,
) -> np.ndarray:
    """Rebuild the exact edge list visible at ``version``: the initial
    edges plus every published insert batch with ``graph_version <=
    version`` (insert-only streams; order is append, matching
    :class:`repro_torch.delta.EdgeLog` semantics for inserts)."""
    parts = [np.asarray(initial_edges).reshape(-1, 2)]
    pubs = sorted(
        (u for u in updates if u.ok and 0 <= u.graph_version <= version),
        key=lambda u: u.graph_version,
    )
    parts.extend(u.inserts.reshape(-1, 2) for u in pubs)
    return np.concatenate(parts, axis=0)
