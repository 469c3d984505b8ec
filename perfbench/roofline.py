"""The yardstick of the kernels' roofline shares: the bytes one whole-graph
sweep of the update needs, counted from the graph the benchmark made, and
the card's peak.

The counts do not look at the port's layout (ELL rows, padding, tiles,
masks, index widths): a later layout moves the share, not the yardstick.
Every item is counted once, at the edge list's own widths (int32 ids,
float32 values):

- partials: each edge's source index read once, each message read once
  (one per vertex with an out-edge), each destination's partial written
  once (one per vertex with an in-edge);
- combine: each destination's partial read once, each vertex's
  accumulator written once.
"""

from __future__ import annotations

from .graphs import GraphCounts

__all__ = ["HBM_BW", "partials_bytes", "combine_bytes", "share_pct"]

#: NVIDIA H100 SXM5 80 GB, data sheet, at its 700 W limit: HBM3 bytes/s
HBM_BW = 3.35e12
ID_BYTES = 4
VALUE_BYTES = 4


def partials_bytes(c: GraphCounts) -> int:
    return ID_BYTES * c.edges + VALUE_BYTES * (c.sources + c.destinations)


def combine_bytes(c: GraphCounts) -> int:
    return VALUE_BYTES * (c.destinations + c.vertices)


def share_pct(nbytes: float, seconds: float) -> float:
    """Percent of the least time the card's memory could take."""
    return 100.0 * nbytes / HBM_BW / seconds
