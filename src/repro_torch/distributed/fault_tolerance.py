"""Fault-tolerance runtime pieces: preemption handling, straggler
detection, elastic re-placement.

The port of ``repro/distributed/fault_tolerance.py``, against
process-local signals and timing, so the training loop's recovery paths
are exercised by tests:

- :class:`PreemptionGuard` converts SIGTERM/SIGINT into a "checkpoint now
  and exit cleanly" flag the train loop polls each step.
- :class:`StragglerMonitor` tracks per-step wall times in a rolling
  window; steps slower than ``threshold`` x the median are flagged and
  fed to a callback.
- :func:`elastic_reshard` places a restored tree for a new context:
  on a model mesh, each leaf as a DTensor under the placements its
  logical-axis spec names there (the restore path when the job shrinks
  or grows); without one, a move to the one device.  Checkpoints store
  logical axes only, so this composes with
  :class:`repro_torch.checkpoint.checkpointer.Checkpointer` for elastic
  restart.
"""

from __future__ import annotations

import collections
import dataclasses
import signal
import statistics
import threading
from time import perf_counter
from typing import Callable, Deque, List, Optional

import torch

from ..core.executor import resolve_device
from .sharding import ShardingCtx, distribute_host

__all__ = ["PreemptionGuard", "StragglerEvent", "StragglerMonitor",
           "elastic_reshard"]


class PreemptionGuard:
    """SIGTERM/SIGINT -> graceful checkpoint-and-exit flag."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._flag = threading.Event()
        self._prev = {}
        self._signals = signals

    def __enter__(self):
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            signal.signal(s, h)
        return False

    def _handler(self, signum, frame):
        self._flag.set()

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()

    def trigger(self) -> None:  # for tests
        self._flag.set()


@dataclasses.dataclass
class StragglerEvent:
    step: int
    step_time_s: float
    median_s: float
    ratio: float


class StragglerMonitor:
    """Rolling-window step-time statistics with outlier flagging."""

    def __init__(self, window: int = 50, threshold: float = 2.0,
                 on_straggler: Optional[Callable[[StragglerEvent], None]] = None):
        self.window: Deque[float] = collections.deque(maxlen=window)
        self.threshold = threshold
        self.on_straggler = on_straggler
        self.events: List[StragglerEvent] = []
        self._t0: Optional[float] = None

    def start_step(self) -> None:
        self._t0 = perf_counter()

    def end_step(self, step: int) -> float:
        dt = perf_counter() - self._t0
        if len(self.window) >= 5:
            med = statistics.median(self.window)
            if dt > self.threshold * med:
                ev = StragglerEvent(step, dt, med, dt / med)
                self.events.append(ev)
                if self.on_straggler:
                    self.on_straggler(ev)
        self.window.append(dt)
        return dt

    @property
    def median(self) -> float:
        return statistics.median(self.window) if self.window else 0.0


def elastic_reshard(tree, specs_tree, new_ctx: ShardingCtx, *, device="cuda"):
    """Place a restored tree (nested dicts of tensors or host arrays) for
    ``new_ctx``.

    On a mesh, as the reference ``device_put``s each leaf with the
    NamedSharding its logical-axis spec names on the new mesh: each leaf
    becomes a DTensor on ``new_ctx.mesh`` under ``new_ctx.placements``
    of its spec (``specs_tree`` has the tree's keys, logical tuples at the
    leaves), each rank slicing its shard from the whole host leaf it
    restored and moving only that to its card
    (``sharding.distribute_host``).  A
    context without a mesh has one device, ``device``: every leaf moves
    there and ``specs_tree`` has nothing to decide."""
    if new_ctx.mesh is None:
        dev = resolve_device(device)

        def move(x):
            if isinstance(x, dict):
                return {k: move(v) for k, v in x.items()}
            return None if x is None else torch.as_tensor(x).to(dev)

        return move(tree)

    mesh = new_ctx.mesh
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device(mesh.device_type))

    def place(x, spec):
        if isinstance(x, dict):
            return {k: place(v, spec[k]) for k, v in x.items()}
        if x is None:
            return None
        return distribute_host(torch.as_tensor(x), mesh, new_ctx.placements(*spec), dev)

    return place(tree, specs_tree)
