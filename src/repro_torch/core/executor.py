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
once (:func:`~repro_torch.kernels.spmv_ell.ops.stage_messages`) and every
dispatch copies its accumulator back to the host once.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence

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
    "ExecResult",
    "ExecStats",
    "PerShardExecutor",
    "BatchedEllExecutor",
    "make_executor",
    "resolve_device",
    "update_shard_numpy",
    "update_ell_torch",
    "update_ell_cuda",
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
        self.events = []


class _EllDispatch:
    """What both executors share for the ELL backends: stage the messages
    once per ``run``, time the update on the card, copy the accumulator
    back once."""

    def __init__(self, backend: str, device):
        self.backend_name = backend
        self.device = resolve_device(device)
        self._fn = ELL_BACKENDS.get(backend)

    def _stage(self, ell: DeviceEll, msgs: np.ndarray) -> torch.Tensor:
        return spmv_ops.stage_messages(msgs, ell.num_windows * ell.window,
                                       self.device)

    def _update(self, ells: Sequence[DeviceEll], msgs_t: torch.Tensor,
                combine: str, stats: Optional[ExecStats]) -> List[np.ndarray]:
        """One dispatch of ``ells``: each shard's accumulator, on the host."""
        timed = stats is not None and ells[0].device.type == "cuda"
        if timed:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        acc = self._fn(ells, msgs_t, combine)
        if timed:
            end.record()
            stats.events.append((start, end))
        if stats is not None:
            stats.slots += sum(e.idx.numel() for e in ells)
            stats.nnz += sum(e.nnz for e in ells)
        acc = acc.cpu().numpy()
        return np.split(acc, np.cumsum([e.rows for e in ells[:-1]]))


class PerShardExecutor(_EllDispatch):
    """One backend call per loaded shard (paper worker model)."""

    def __init__(self, backend: str, *, device="cuda"):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend}; have {sorted(BACKENDS)}")
        super().__init__(backend, device)

    def run(
        self,
        loaded: Iterable[LoadedShard],
        msgs: np.ndarray,
        combine: str,
        stats: Optional[ExecStats] = None,
    ) -> Iterator[ExecResult]:
        msgs_t = None
        for ls in loaded:
            t0 = time.perf_counter()
            with trace.span(
                "exec.dispatch", shard=ls.shard_id, backend=self.backend_name
            ):
                if self._fn is None:
                    acc = update_shard_numpy(ls.csr, None, msgs, combine)
                else:
                    if msgs_t is None:
                        msgs_t = self._stage(ls.ell, msgs)
                    acc, = self._update([ls.ell], msgs_t, combine, stats)
            if stats is not None:
                stats.dispatches += 1
                stats.shards_executed += 1
                stats.exec_s += time.perf_counter() - t0
            ref = ls.ref
            yield ExecResult(ls.shard_id, ref.v0, ref.v1, acc)


class BatchedEllExecutor(_EllDispatch):
    """Batch consecutive planned ELL shards into one launch of each kernel."""

    def __init__(self, backend: str, batch_shards: int = 4, *, device="cuda"):
        if backend not in ELL_BACKENDS:
            raise ValueError(
                f"batched execution needs an ELL backend, got {backend!r}"
            )
        if batch_shards < 1:
            raise ValueError("batch_shards must be >= 1")
        if backend == "cuda" and batch_shards > spmv_kernel.MAX_BATCH:
            raise ValueError(f"the cuda kernels take at most "
                             f"{spmv_kernel.MAX_BATCH} shards a launch")
        super().__init__(backend, device)
        self.batch_shards = batch_shards

    def run(
        self,
        loaded: Iterable[LoadedShard],
        msgs: np.ndarray,
        combine: str,
        stats: Optional[ExecStats] = None,
    ) -> Iterator[ExecResult]:
        msgs_t = None
        buf: List[LoadedShard] = []
        for ls in loaded:
            if msgs_t is None:
                msgs_t = self._stage(ls.ell, msgs)
            buf.append(ls)
            if len(buf) >= self.batch_shards:
                yield from self._flush(buf, msgs_t, combine, stats)
                buf = []
        if buf:
            yield from self._flush(buf, msgs_t, combine, stats)

    def _flush(self, buf, msgs_t, combine, stats) -> Iterator[ExecResult]:
        t0 = time.perf_counter()
        with trace.span(
            "exec.dispatch", shards=len(buf), backend=self.backend_name
        ):
            accs = self._update([ls.ell for ls in buf], msgs_t, combine, stats)
        if stats is not None:
            stats.dispatches += 1
            stats.shards_executed += len(buf)
            stats.exec_s += time.perf_counter() - t0
        for ls, acc in zip(buf, accs):
            yield ExecResult(ls.shard_id, ls.ell.v0, ls.ell.v1, acc,
                             batch_size=len(buf))


def make_executor(backend: str, *, batch_shards: int = 1, device="cuda"):
    """Pick the executor for a backend: batching only exists for the ELL
    backends; the numpy oracle always runs per shard."""
    if batch_shards < 1:
        raise ValueError("batch_shards must be >= 1")
    if batch_shards > 1 and backend in ELL_BACKENDS:
        return BatchedEllExecutor(backend, batch_shards, device=device)
    return PerShardExecutor(backend, device=device)
