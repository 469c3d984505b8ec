"""The yardstick of the host-to-device copy's roofline share: the bytes
one whole-graph sweep must carry to the card, counted from the graph the
benchmark made, and the card's host link.

As in ``roofline.py``, the count does not look at the port's layout (ELL
rows, padding, masks, index widths): a denser layout or a packed mask
moves the share, not the yardstick.  A sweep that reads its edges from
the host carries at the least each edge's source id (4 B) and each
destination's row extent (4 B per vertex with an in-edge).  The time is
the device time of every host-to-device copy in the trace.
"""

from __future__ import annotations

from typing import Optional

from .graphs import GraphCounts

__all__ = ["H2D_BW", "H2D_OPS", "sweep_bytes", "share_pct"]

#: NVIDIA H100 SXM5 data sheet: the host link, PCIe Gen5 x16, bytes/s
#: in one direction
H2D_BW = 64e9
#: the profiler's names of host-to-device copies (pageable or pinned)
H2D_OPS = r"Memcpy[ _]HtoD"
ID_BYTES = 4
EXTENT_BYTES = 4


def sweep_bytes(c: GraphCounts) -> int:
    return ID_BYTES * c.edges + EXTENT_BYTES * c.destinations


def share_pct(record) -> Optional[float]:
    """Percent of the host link's bound that the window's copies reach:
    ``sweep_bytes`` of each iteration over the device time of the copies;
    ``None`` without a device trace or such copies, or where an iteration
    skipped shards (its bytes would not be one whole sweep)."""
    if record.trace is None or not record.iters:
        return None
    seconds = record.trace.kernel_s(H2D_OPS)
    if seconds <= 0 or any(getattr(i, "shards_skipped", 1)
                           for i in record.iters):
        return None
    nbytes = sweep_bytes(record.counts) * len(record.iters)
    return 100.0 * nbytes / H2D_BW / seconds
