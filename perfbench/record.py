"""What one run leaves for the metric readers (``metrics/<name>.py``)."""

from __future__ import annotations

import dataclasses
import statistics
from typing import Callable, List, Optional

from . import roofline
from .devtrace import DeviceTrace
from .graphs import GraphCounts

__all__ = ["RunRecord"]

#: the single-lane update's kernels, by the names the profiler reads
PARTIALS_KERNELS = r"ell_partials_(?!lanes)"
COMBINE_KERNELS = r"segment_combine_kernel"


@dataclasses.dataclass
class RunRecord:
    setup_s: float  # process start to the window's start
    preprocess_s: float  # the port's preprocess and store write
    window_s: float  # host clock, whole requests only
    requests: int  # completed in the window
    converged: int  # of which ran until no vertex was active
    iters: list  # the window's repro_torch IterStats, in order
    counts: GraphCounts
    trace: Optional[DeviceTrace] = None

    @property
    def iterations(self) -> int:
        return len(self.iters)

    def per_iteration_ms(self, fn: Callable) -> Optional[float]:
        """Mean over the window's iterations of ``fn(IterStats)``, in ms."""
        if not self.iters:
            return None
        return 1e3 * statistics.fmean(fn(i) for i in self.iters)

    def idle_pct(self) -> Optional[float]:
        if self.trace is None or self.trace.busy_s <= 0:
            return None
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.window_s)

    def roofline_pct(self, pattern: str,
                     bytes_of: Callable[[GraphCounts], int]) -> Optional[float]:
        """Share of the bound over the window's sweeps; ``None`` without a
        device trace, without such kernels, or where an iteration skipped
        shards (its bytes would not be one whole sweep)."""
        if self.trace is None or not self.iters:
            return None
        seconds = self.trace.kernel_s(pattern)
        if seconds <= 0 or any(i.shards_skipped for i in self.iters):
            return None
        return roofline.share_pct(bytes_of(self.counts) * len(self.iters),
                                  seconds)

    def host_ms(self) -> Optional[float]:
        """Host program time per iteration: what is left of the iteration
        after the executor, the wait for loads and the copies."""
        return self.per_iteration_ms(
            lambda i: i.time_s - i.exec_s - i.load_wait_s - i.to_device_s)
