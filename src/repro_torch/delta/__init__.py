"""GraphDelta: live edge mutations over the semi-external-memory store.

The base GraphMP design (paper §II-B) writes immutable destination-interval
shards once; this package makes the shard store *updatable* without ever
breaking the bitwise contract the rest of the system is tested against:

========================  ==================================================
:class:`EdgeLog`          stages insert/delete batches and publishes them as
                          per-shard destination-sorted *delta runs*
                          (``(dst << 32) | src`` keys, deletes as
                          tombstones) through the store's accounted channel.
:class:`DeltaOverlay`     merges base shard + pending runs at decode time,
                          behind ``ShardStore.load_shard`` and the shard
                          pipeline — engines, lane sweeps and executors see
                          one logical shard.  Versioned: sweeps pin the
                          publish sequence they start at and never observe a
                          mixed graph version.
:class:`Recompactor`      background (or synchronous) LSM-style maintenance:
                          k-way-merges pending runs into new base shards,
                          firing the shard-invalidation hooks and refreshing
                          warm Bloom-filter sources.
========================  ==================================================

See DESIGN.md §8 for the delta format, overlay decode, recompaction
triggers and version/snapshot semantics.  Everything here is host numpy,
as in the reference, and the files are the reference's byte for byte.  On
the card a shard with pending runs is decoded on the host and copied to
the device each sweep, never kept resident (``core/pipeline.py``).
"""

from .edgelog import EdgeLog, PublishResult
from .overlay import DeltaOverlay, DeltaRun, apply_run
from .recompact import CompactionStats, Recompactor
from .recovery import CRASH_POINTS, RecoveryReport, recover, set_crash_hook

__all__ = [
    "EdgeLog",
    "PublishResult",
    "DeltaOverlay",
    "DeltaRun",
    "apply_run",
    "CompactionStats",
    "Recompactor",
    "CRASH_POINTS",
    "RecoveryReport",
    "recover",
    "set_crash_hook",
]
