"""Lane batching: form fusion sets from pending requests, pad lanes pow2.

Two requests may ride the same *lane table* (one lane matrix, one combine
kernel) iff their programs share a
:attr:`~repro_torch.core.apps.LaneProgram.combine_key` — the same combine
algebra.  BFS, SSSP and WCC all carry ``("min",)`` and fuse into one
table even though their per-lane ``pre``/``apply`` differ (the lane table
applies those per lane); two PPR requests with different damping fuse the
same way under ``("sum",)``.  Requests whose algebras differ cannot share
a lane matrix, but they CAN share the shard stream: :meth:`form_fused`
returns up to ``max_groups`` groups — a *fusion set* — that one
:class:`~repro_torch.serve.sweep.FusedSweep` interleaves over a single sweep
(one load per shard, one dispatch per group).

Formation is FIFO from the oldest request: the oldest pending request
defines group 0's combine key and takes up to ``max_lanes`` fusable
followers; the oldest *remaining* request defines group 1; and so on up
to ``max_groups``.  Everything else stays queued in order — no
starvation: the oldest request always rides the next sweep.

``fuse_programs=False`` restores key-equality batching (one group,
identical program keys only) — the baseline the fusion benchmarks compare
against.

Lane counts are padded to the next power of two (:func:`pad_lanes`): the
reference does so to bound its jit retraces; the port keeps the same
capacities so that both packages form the same lane tables (the lane
kernels take any lane count).
"""

from __future__ import annotations

from typing import Any, Callable, Deque, List

from ..core.csr import next_pow2
from ..obs import trace

__all__ = ["pad_lanes", "LaneBatcher"]


def pad_lanes(n: int) -> int:
    """Padded lane capacity for a batch of ``n`` requests (pow2, >= 1)."""
    return next_pow2(max(n, 1))


class LaneBatcher:
    """Forms lane batches / fusion sets from a FIFO of pending requests.

    Pending entries are duck-typed: anything with ``key`` and
    ``combine_key`` attributes (the service uses its internal ``_Pending``
    records).  The caller owns the deque's lock — the batcher only
    mutates, never blocks.
    """

    def __init__(
        self,
        max_lanes: int = 16,
        *,
        pad_pow2: bool = True,
        max_groups: int = 2,
        fuse_programs: bool = True,
    ):
        if max_lanes < 1:
            raise ValueError("max_lanes must be >= 1")
        if max_groups < 1:
            raise ValueError("max_groups must be >= 1")
        self.max_lanes = max_lanes
        self.pad_pow2 = pad_pow2
        self.max_groups = max_groups
        self.fuse_programs = fuse_programs

    def capacity(self, batch_size: int) -> int:
        """Lane-matrix extent allocated for a batch of ``batch_size``."""
        return pad_lanes(batch_size) if self.pad_pow2 else max(batch_size, 1)

    def _take(
        self, pending: Deque[Any], match: Callable[[Any], bool], limit: int
    ) -> List[Any]:
        """Remove and return up to ``limit`` matching entries, preserving
        the relative order of everything left queued."""
        if limit <= 0 or not pending:
            return []
        taken: List[Any] = []
        keep: List[Any] = []
        while pending:
            item = pending.popleft()
            if len(taken) < limit and match(item):
                taken.append(item)
            else:
                keep.append(item)
        pending.extend(keep)
        return taken

    def take_compatible(
        self, pending: Deque[Any], key: Any, limit: int
    ) -> List[Any]:
        """Up to ``limit`` entries with program key EQUAL to ``key`` (key
        compatibility batching — one program, identical static params)."""
        return self._take(pending, lambda item: item.key == key, limit)

    def take_fusable(
        self, pending: Deque[Any], combine_key: Any, limit: int
    ) -> List[Any]:
        """Up to ``limit`` entries whose programs FUSE with ``combine_key``
        — same algebra, any program/params (one lane table)."""
        if not self.fuse_programs:
            # key-only mode: a "fusable" follower must match exactly; the
            # caller passes the group's first key as the combine key.
            return self.take_compatible(pending, combine_key, limit)
        return self._take(
            pending, lambda item: item.combine_key == combine_key, limit
        )

    def group_key(self, entry: Any) -> Any:
        """The fusion identity of ``entry`` under the current policy."""
        return entry.combine_key if self.fuse_programs else entry.key

    def form(self, pending: Deque[Any]) -> List[Any]:
        """Single-program batching: the next batch — the oldest request plus up to
        ``max_lanes - 1`` followers with the identical program key."""
        if not pending:
            return []
        return self.take_compatible(pending, pending[0].key, self.max_lanes)

    def form_fused(self, pending: Deque[Any]) -> List[List[Any]]:
        """The next fusion set: up to ``max_groups`` groups, each up to
        ``max_lanes`` requests sharing a combine algebra, oldest-first."""
        with trace.span("batch.form") as sp:
            groups: List[List[Any]] = []
            while pending and len(groups) < self.max_groups:
                g = self.take_fusable(
                    pending, self.group_key(pending[0]), self.max_lanes
                )
                if not g:  # pragma: no cover — take of the head never misses
                    break
                groups.append(g)
            sp.set(groups=len(groups), lanes=sum(len(g) for g in groups))
            return groups
