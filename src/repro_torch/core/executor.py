"""Shard executors: *how planned shards execute* (DESIGN.md §3-4).

Third layer of the engine stack.  An executor consumes the pipeline's
stream of loaded shards and yields per-shard accumulators; it owns the
backend dispatch.

- :class:`PerShardExecutor` — one backend call per shard (the paper's
  worker model; the only choice for the numpy oracle).
- :class:`BatchedEllExecutor` — runs up to ``batch_shards`` consecutive
  planned ELL shards through ONE launch of each kernel, which reads every
  shard's own tensors.  Bitwise equal to per-shard execution: every ELL
  row computes the same partial, and every destination row combines its
  partials in the same order.

With ``lanes=True`` (the serving layer, DESIGN.md §6, §9, §14) messages
are ``[L, |V|]`` and accumulators ``[L, rows]``: one shard load feeds every
in-flight query lane.  ``run_groups`` takes G program groups at once: the
per-group path launches once per live group and batch; the ragged path
(``ragged=True``, the default) concatenates every group's lanes once an
iteration and launches ONE ragged update per batch, collecting batch *i*
only after batch *i+1* is dispatched.  Both give each lane bitwise its
single-query result.

Backends:

=========  ==================================================================
numpy      ``np.add.at`` / ``np.minimum.at`` scatter-reduce over CSR — the
           bitwise oracle, on the host.
torch      plain gather + masked reduce + segment combine on tensors, the
           counterpart of the reference's ``jnp`` backend (it maps non-finite
           min/max results to the identity, as that backend does).
cuda       the hand-written kernels of ``repro_torch.kernels.spmv_ell`` —
           the counterpart of ``pallas`` and the production hot loop.  On
           CPU tensors their plain versions stand in.
=========  ==================================================================

For ``torch`` and ``cuda`` an iteration's messages are staged on the device
once (:func:`~repro_torch.kernels.spmv_ell.ops.stage_messages`, or
``stage_lanes`` / ``ragged_stage_lanes`` for lanes) and every dispatch
copies its accumulator back to the host once.
"""

from __future__ import annotations

import dataclasses
import time
from typing import (
    Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple,
)

import numpy as np
import torch

from ..kernels.spmv_ell import kernel as spmv_kernel
from ..kernels.spmv_ell import ops as spmv_ops
from ..obs import trace
from .apps import COMBINE_IDENTITY
from .csr import DeviceEll
from .pipeline import LoadedShard
from .sharding import ShardCSR

__all__ = [
    "BACKENDS",
    "ELL_BACKENDS",
    "LANE_BACKENDS",
    "GroupDispatch",
    "ExecResult",
    "ExecStats",
    "PerShardExecutor",
    "BatchedEllExecutor",
    "make_executor",
    "make_lane_executor",
    "resolve_device",
    "update_shard_numpy",
    "update_ell_torch",
    "update_ell_cuda",
    "update_shard_numpy_lanes",
    "update_ell_lanes_torch",
    "update_ell_lanes_cuda",
    "ragged_ell_torch",
    "ragged_ell_cuda",
]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch sees no CUDA device; "
                f"pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


# --------------------------------------------------------------------------
# Shard-update backends
# --------------------------------------------------------------------------


def update_shard_numpy(
    csr: ShardCSR, ell, msgs: np.ndarray, combine: str
) -> np.ndarray:
    """Scatter-reduce oracle over the CSR shard."""
    rows = csr.rows
    acc = np.full(rows, COMBINE_IDENTITY[combine], dtype=msgs.dtype)
    if csr.nnz == 0:
        return acc
    local_dst = np.repeat(np.arange(rows, dtype=np.int64), np.diff(csr.row))
    vals = msgs[csr.col]
    if combine == "sum":
        np.add.at(acc, local_dst, vals)
    elif combine == "min":
        np.minimum.at(acc, local_dst, vals)
    elif combine == "max":
        np.maximum.at(acc, local_dst, vals)
    else:  # pragma: no cover
        raise ValueError(combine)
    return acc


def update_ell_torch(ells: Sequence[DeviceEll], msgs: torch.Tensor,
                     combine: str) -> torch.Tensor:
    """Plain windowed-ELL gather/combine on tensors (any device)."""
    part = spmv_kernel.ell_partials_masked_plain(
        [e.idx for e in ells], [e.mask for e in ells],
        [e.tile_window for e in ells], msgs,
        window=ells[0].window, tr=ells[0].tr, combine=combine)
    acc = spmv_kernel.segment_combine_plain(
        part, [e.perm for e in ells], [e.row_ptr for e in ells], combine)
    if combine != "sum":
        acc = torch.where(torch.isfinite(acc), acc, COMBINE_IDENTITY[combine])
    return acc


def update_ell_cuda(ells: Sequence[DeviceEll], msgs: torch.Tensor,
                    combine: str) -> torch.Tensor:
    """The CUDA kernels (their plain versions on CPU tensors)."""
    return spmv_ops.ell_update_batched(ells, msgs, combine)


#: ELL backends: ``(shards, staged msgs, combine) -> acc [sum of their rows]``
ELL_BACKENDS: Dict[str, Callable] = {
    "torch": update_ell_torch,
    "cuda": update_ell_cuda,
}

BACKENDS = ("numpy", *ELL_BACKENDS)


# --------------------------------------------------------------------------
# Lane backends (serving layer): msgs [L, |V|], acc [L, rows]
# --------------------------------------------------------------------------


def update_shard_numpy_lanes(
    csr: ShardCSR, ell, msgs: np.ndarray, combine: str
) -> np.ndarray:
    """Lane-stacked scatter-reduce oracle: :func:`update_shard_numpy` per
    lane, so each lane's row is bitwise the single-query oracle."""
    return np.stack([update_shard_numpy(csr, ell, msgs[l], combine)
                     for l in range(msgs.shape[0])])


def update_ell_lanes_torch(ells: Sequence[DeviceEll], lanes,
                           combine: str) -> torch.Tensor:
    """:func:`update_ell_torch` per lane of staged lane messages."""
    return torch.stack([update_ell_torch(ells, row, combine)
                        for row in lanes.rows])


def update_ell_lanes_cuda(ells: Sequence[DeviceEll], lanes,
                          combine: str) -> torch.Tensor:
    """The lane kernels (their plain versions on CPU tensors)."""
    return spmv_ops.ell_update_lanes_batched(ells, lanes, combine)


def ragged_ell_torch(ells: Sequence[DeviceEll], lane_ctx) -> torch.Tensor:
    """Ragged update on plain tensor ops: each lane with its own combine,
    padding lanes zero."""
    rows = lane_ctx["msgs"].rows
    combines = lane_ctx["combines"]
    out = []
    for row, c in zip(rows, lane_ctx["cids"].tolist()):
        out.append(update_ell_torch(ells, row, combines[c])
                   if c < len(combines)
                   else torch.zeros(sum(e.rows for e in ells),
                                    device=rows.device))
    return torch.stack(out)


def ragged_ell_cuda(ells: Sequence[DeviceEll], lane_ctx) -> torch.Tensor:
    """One launch of the ragged partials kernel and one of the lane
    combine (plain versions on CPU tensors)."""
    return spmv_ops.ragged_dispatch(ells, lane_ctx)


#: lane ELL backends: ``(shards, staged lanes, combine) -> acc [L, rows]``
LANE_ELL_BACKENDS: Dict[str, Callable] = {
    "torch": update_ell_lanes_torch,
    "cuda": update_ell_lanes_cuda,
}
#: ragged backends: ``(shards, ragged lane context) -> acc [k_pad, rows]``
RAGGED_BACKENDS: Dict[str, Callable] = {
    "torch": ragged_ell_torch,
    "cuda": ragged_ell_cuda,
}
LANE_BACKENDS = ("numpy", *LANE_ELL_BACKENDS)

#: One program group's dispatch request for ``run_groups``: the group's
#: ``[K_g, |V|]`` message matrix and its combine, or None when the group has
#: nothing to dispatch for these shards (the shard stream is still consumed
#: once).
GroupDispatch = Optional[Tuple[np.ndarray, str]]


# --------------------------------------------------------------------------
# Executors
# --------------------------------------------------------------------------


@dataclasses.dataclass
class ExecResult:
    """One shard's accumulator plus which dispatch produced it."""

    shard_id: int
    v0: int
    v1: int
    acc: np.ndarray
    batch_size: int = 1  # shards sharing the kernel dispatch


@dataclasses.dataclass
class ExecStats:
    """Per-iteration dispatch accounting (reset each iteration)."""

    dispatches: int = 0
    shards_executed: int = 0
    exec_s: float = 0.0  # host wall time of the dispatches
    slots: int = 0  # ELL slots dispatched (K per ELL row)
    nnz: int = 0  # of which hold an edge
    #: shard batches flushed (a ragged flush is ONE dispatch per batch, the
    #: per-group path pays G): ragged_dispatches <= batches <= dispatches
    batches: int = 0
    ragged_dispatches: int = 0
    #: live lanes covered by ragged launches, summed per flush;
    #: sum(group_lanes.values()) == ragged_lanes
    ragged_lanes: int = 0
    group_lanes: Dict[int, int] = dataclasses.field(default_factory=dict)
    #: wall time a dispatched batch stayed in flight while the host staged
    #: the next one (the double-buffer overlap window)
    overlap_s: float = 0.0
    #: CUDA event pairs around each update on the card (partials + combine)
    events: List[tuple] = dataclasses.field(default_factory=list)

    @property
    def kernel_s(self) -> float:
        """Device time of the updates; 0.0 off the card.  Read it after
        the dispatches have finished (collecting an accumulator waits)."""
        return sum(a.elapsed_time(b) for a, b in self.events) / 1e3

    @property
    def padding_ratio(self) -> float:
        """Fraction of the dispatched ELL slots that carried no edge."""
        return 1.0 - self.nnz / self.slots if self.slots else 0.0

    def reset(self) -> None:
        self.dispatches = self.shards_executed = 0
        self.exec_s = 0.0
        self.slots = self.nnz = 0
        self.batches = self.ragged_dispatches = self.ragged_lanes = 0
        self.group_lanes = {}
        self.overlap_s = 0.0
        self.events = []


class _HostCopy:
    """An accumulator on its way to the host: on the card, an asynchronous
    copy into pinned memory and an event that :meth:`wait` waits on, so the
    launch after it is not held up."""

    def __init__(self, acc: torch.Tensor):
        self.event = None
        if acc.device.type == "cuda":
            self.host = torch.empty(acc.shape, dtype=acc.dtype, pin_memory=True)
            self.host.copy_(acc, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = acc

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def _cached(cache: Optional[dict], arrays: Tuple, make: Callable[[], Any]):
    """``make()`` once per tuple of host arrays (by identity) in ``cache``."""
    if cache is None:
        return make()
    key = tuple(map(id, arrays))
    hit = cache.get(key)
    if hit is not None and all(a is b for a, b in zip(hit[0], arrays)):
        return hit[1]
    value = make()
    cache[key] = (arrays, value)
    return value


def _live(groups: Sequence[GroupDispatch]):
    return [(gi, ga) for gi, ga in enumerate(groups) if ga is not None]


class _EllDispatch:
    """What both executors share for the ELL backends: stage the messages
    once per ``run`` (lanes: once per group and iteration), time the update
    on the card, copy the accumulator back once."""

    def __init__(self, backend: str, device, lanes: bool):
        self.backend_name = backend
        self.device = resolve_device(device)
        self.lanes = lanes
        self._fn = ELL_BACKENDS.get(backend)
        self._lane_fn = LANE_ELL_BACKENDS.get(backend)
        self._ragged_fn = RAGGED_BACKENDS.get(backend)

    def _stage(self, ell: DeviceEll, msgs: np.ndarray):
        n_pad = ell.num_windows * ell.window
        if msgs.ndim == 2:
            return spmv_ops.stage_lanes(msgs, n_pad, self.device)
        return spmv_ops.stage_messages(msgs, n_pad, self.device)

    def _launch(self, fn: Callable, ells: Sequence[DeviceEll], args,
                stats: Optional[ExecStats]) -> torch.Tensor:
        """One dispatch of ``ells``, timed on the card; the accumulator stays
        on the device."""
        timed = stats is not None and ells[0].device.type == "cuda"
        if timed:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        acc = fn(ells, *args)
        if timed:
            end.record()
            stats.events.append((start, end))
        if stats is not None:
            stats.slots += sum(e.idx.numel() for e in ells)
            stats.nnz += sum(e.nnz for e in ells)
        return acc

    def _update(self, ells: Sequence[DeviceEll], staged, combine: str,
                stats: Optional[ExecStats]) -> List[np.ndarray]:
        """One dispatch of ``ells``: each shard's accumulator, on the host."""
        lanes = isinstance(staged, spmv_kernel.LaneMessages)
        fn = self._lane_fn if lanes else self._fn
        acc = self._launch(fn, ells, (staged, combine), stats)
        return spmv_ops.split_rows(ells, acc.cpu().numpy())

    def _stage_group(self, cache, ell: DeviceEll, msgs: np.ndarray):
        return _cached(cache, (msgs,), lambda: self._stage(ell, msgs))


class PerShardExecutor(_EllDispatch):
    """One backend call per loaded shard (paper worker model).

    With ``lanes=True`` the call consumes ``[lanes, |V|]`` messages and
    yields ``[lanes, rows]`` accumulators.
    """

    def __init__(self, backend: str, *, lanes: bool = False, device="cuda"):
        table = LANE_BACKENDS if lanes else BACKENDS
        if backend not in table:
            raise ValueError(f"unknown backend {backend}; have {sorted(table)}")
        super().__init__(backend, device, lanes)

    def _one(self, ls: LoadedShard, msgs: np.ndarray, staged, combine: str,
             stats: Optional[ExecStats]) -> np.ndarray:
        if self._fn is None:  # the numpy oracle
            oracle = update_shard_numpy_lanes if msgs.ndim == 2 else update_shard_numpy
            return oracle(ls.csr, None, msgs, combine)
        acc, = self._update([ls.ell], staged, combine, stats)
        return acc

    def run(
        self,
        loaded: Iterable[LoadedShard],
        msgs: np.ndarray,
        combine: str,
        stats: Optional[ExecStats] = None,
    ) -> Iterator[ExecResult]:
        staged = None
        for ls in loaded:
            t0 = time.perf_counter()
            with trace.span(
                "exec.dispatch", shard=ls.shard_id, backend=self.backend_name
            ):
                if staged is None and self._fn is not None:
                    staged = self._stage(ls.ell, msgs)
                acc = self._one(ls, msgs, staged, combine, stats)
            if stats is not None:
                stats.dispatches += 1
                stats.shards_executed += 1
                stats.exec_s += time.perf_counter() - t0
            ref = ls.ref
            yield ExecResult(ls.shard_id, ref.v0, ref.v1, acc)

    def run_groups(
        self,
        loaded: Iterable[LoadedShard],
        groups: Sequence[GroupDispatch],
        stats: Optional[ExecStats] = None,
        staged: Optional[dict] = None,
    ) -> Iterator[Tuple[int, ExecResult]]:
        """Multi-group dispatch (fused sweeps): consume each loaded shard
        ONCE and dispatch it per live program group.  Yields
        ``(group_index, result)``; ``None`` groups get no dispatch.
        ``staged`` caches each group's staged messages across calls."""
        if not self.lanes:
            raise RuntimeError("run_groups needs a lane executor")
        cache = {} if staged is None else staged
        for ls in loaded:
            ref = ls.ref
            for gi, (msgs, combine) in _live(groups):
                t0 = time.perf_counter()
                with trace.span("exec.dispatch", shard=ls.shard_id, group=gi,
                                backend=self.backend_name):
                    lanes = (None if self._fn is None
                             else self._stage_group(cache, ls.ell, msgs))
                    acc = self._one(ls, msgs, lanes, combine, stats)
                if stats is not None:
                    stats.dispatches += 1
                    stats.shards_executed += 1
                    stats.exec_s += time.perf_counter() - t0
                yield gi, ExecResult(ls.shard_id, ref.v0, ref.v1, acc)


class BatchedEllExecutor(_EllDispatch):
    """Batch consecutive planned ELL shards into one launch of each kernel.

    With ``lanes=True`` each dispatch covers N shards x L query lanes; with
    ``ragged=True`` too, ``run_groups`` covers every live group with ONE
    ragged launch per batch.
    """

    def __init__(self, backend: str, batch_shards: int = 4, *,
                 lanes: bool = False, ragged: bool = True, device="cuda"):
        if backend not in ELL_BACKENDS:
            raise ValueError(
                f"batched execution needs an ELL backend, got {backend!r}"
            )
        if batch_shards < 1:
            raise ValueError("batch_shards must be >= 1")
        if backend == "cuda" and batch_shards > spmv_kernel.MAX_BATCH:
            raise ValueError(f"the cuda kernels take at most "
                             f"{spmv_kernel.MAX_BATCH} shards a launch")
        super().__init__(backend, device, lanes)
        self.batch_shards = batch_shards
        self.ragged = bool(ragged) and lanes

    def _batches(self, loaded: Iterable[LoadedShard]) -> Iterator[List[LoadedShard]]:
        buf: List[LoadedShard] = []
        for ls in loaded:
            buf.append(ls)
            if len(buf) >= self.batch_shards:
                yield buf
                buf = []
        if buf:
            yield buf

    def run(
        self,
        loaded: Iterable[LoadedShard],
        msgs: np.ndarray,
        combine: str,
        stats: Optional[ExecStats] = None,
    ) -> Iterator[ExecResult]:
        staged = None
        for buf in self._batches(loaded):
            if staged is None:
                staged = self._stage(buf[0].ell, msgs)
            t0 = time.perf_counter()
            with trace.span(
                "exec.dispatch", shards=len(buf), backend=self.backend_name
            ):
                accs = self._update([ls.ell for ls in buf], staged, combine,
                                    stats)
            if stats is not None:
                stats.dispatches += 1
                stats.shards_executed += len(buf)
                stats.exec_s += time.perf_counter() - t0
            for ls, acc in zip(buf, accs):
                yield ExecResult(ls.shard_id, ls.ell.v0, ls.ell.v1, acc,
                                 batch_size=len(buf))

    def run_groups(
        self,
        loaded: Iterable[LoadedShard],
        groups: Sequence[GroupDispatch],
        stats: Optional[ExecStats] = None,
        staged: Optional[dict] = None,
    ) -> Iterator[Tuple[int, ExecResult]]:
        """Multi-group batched dispatch: up to ``batch_shards`` consecutive
        shards per batch, dispatched once per live group (or, ragged, once
        for all).  ``staged`` caches the staged lane messages across calls
        (the sweep's lane-masked path reuses a mask's sub-matrices)."""
        if not self.lanes:
            raise RuntimeError("run_groups needs a lane executor")
        cache = {} if staged is None else staged
        live = _live(groups)
        if self.ragged:
            yield from self._run_groups_ragged(loaded, live, stats, cache)
            return
        for buf in self._batches(loaded):
            yield from self._flush_groups(buf, live, stats, cache)

    def _flush_groups(self, buf, live, stats, cache):
        if not live:
            return
        t0 = time.perf_counter()
        ells = [ls.ell for ls in buf]
        with trace.span("exec.dispatch", shards=len(buf), groups=len(live),
                        backend=self.backend_name):
            accs_by_group = [
                self._update(ells, self._stage_group(cache, ells[0], msgs),
                             combine, stats)
                for _, (msgs, combine) in live]
        if stats is not None:
            stats.dispatches += len(live)
            stats.batches += 1
            stats.shards_executed += len(buf) * len(live)
            stats.exec_s += time.perf_counter() - t0
        for (gi, _), accs in zip(live, accs_by_group):
            for ls, acc in zip(buf, accs):
                yield gi, ExecResult(ls.shard_id, ls.ell.v0, ls.ell.v1, acc,
                                     batch_size=len(buf))

    def _run_groups_ragged(self, loaded, live, stats, cache):
        """Ragged hot loop: 1 load, ONE launch of each kernel per batch
        covering every live group, with the collect of batch ``i`` deferred
        until batch ``i+1`` has been dispatched — the launch and its copy
        to the host stay in flight while the host stages the next batch."""
        if not live:
            for _ in loaded:  # consume the stream exactly like the G-path
                pass
            return
        msgs_live = tuple(ga[0] for _, ga in live)
        k_total = sum(int(m.shape[0]) for m in msgs_live)

        def dispatch(buf):
            t0 = time.perf_counter()
            ells = [ls.ell for ls in buf]
            with trace.span("exec.dispatch", shards=len(buf), groups=len(live),
                            backend=self.backend_name, ragged=True):
                lane_ctx = _cached(cache, ("ragged", *msgs_live), lambda: (
                    spmv_ops.ragged_stage_lanes(
                        msgs_live, [ga[1] for _, ga in live],
                        ells[0].num_windows * ells[0].window, self.device)))
                acc = self._launch(self._ragged_fn, ells, (lane_ctx,), stats)
                pending = _HostCopy(acc)
            if stats is not None:
                stats.dispatches += 1
                stats.ragged_dispatches += 1
                stats.batches += 1
                stats.shards_executed += len(buf) * len(live)
                stats.ragged_lanes += k_total
                for gi, ga in live:
                    stats.group_lanes[gi] = (
                        stats.group_lanes.get(gi, 0) + int(ga[0].shape[0]))
                stats.exec_s += time.perf_counter() - t0
            return buf, lane_ctx, pending, time.perf_counter()

        def collect(p):
            buf, lane_ctx, pending, t_launch = p
            if stats is not None:
                stats.overlap_s += time.perf_counter() - t_launch
            t0 = time.perf_counter()
            ells = [ls.ell for ls in buf]
            accs_by_group = spmv_ops.ragged_collect(ells, pending.wait(),
                                                    lane_ctx["slices"])
            if stats is not None:
                stats.exec_s += time.perf_counter() - t0
            for (gi, _), accs in zip(live, accs_by_group):
                for ls, acc in zip(buf, accs):
                    yield gi, ExecResult(ls.shard_id, ls.ell.v0, ls.ell.v1,
                                         acc, batch_size=len(buf))

        pending = None
        for buf in self._batches(loaded):
            nxt = dispatch(buf)
            if pending is not None:
                yield from collect(pending)
            pending = nxt
        if pending is not None:
            yield from collect(pending)


def make_executor(backend: str, *, batch_shards: int = 1, device="cuda"):
    """Pick the executor for a backend: batching only exists for the ELL
    backends; the numpy oracle always runs per shard."""
    if batch_shards < 1:
        raise ValueError("batch_shards must be >= 1")
    if batch_shards > 1 and backend in ELL_BACKENDS:
        return BatchedEllExecutor(backend, batch_shards, device=device)
    return PerShardExecutor(backend, device=device)


def make_lane_executor(backend: str, *, batch_shards: int = 1,
                       ragged: bool = True, device="cuda"):
    """Executor whose dispatches carry a lane (concurrent-query) axis: as
    :func:`make_executor`, except that ``ragged`` (on by default) also
    wants the batched executor at ``batch_shards=1`` — a ragged flush is
    still 1 launch where the per-shard path pays G."""
    if batch_shards < 1:
        raise ValueError("batch_shards must be >= 1")
    if backend in LANE_ELL_BACKENDS and (batch_shards > 1 or ragged):
        return BatchedEllExecutor(backend, batch_shards, lanes=True,
                                  ragged=ragged, device=device)
    return PerShardExecutor(backend, lanes=True, device=device)
