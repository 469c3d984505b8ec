"""Serving on the port: concurrent multi-query sweeps on a warm VSW engine.

K concurrent per-source queries (BFS / SSSP / WCC / personalized PageRank)
execute as *lanes* of one sweep: vertex state is ``(K, n)``, each shard is
loaded once per iteration and applied to every lane (DESIGN.md §6).
Same-algebra programs FUSE into one lane table, and different algebra
groups INTERLEAVE on one sweep (DESIGN.md §9); on the ``torch`` and
``cuda`` backends one ragged launch per shard batch covers every group
(DESIGN.md §14).

==========  ===============================================================
sweep       :class:`~repro_torch.serve.sweep.FusedSweep` — drives the
            engine's scheduler/pipeline for G program groups on one shard
            stream; each group is a :class:`~repro_torch.serve.sweep.
            LaneTable`.  :class:`~repro_torch.serve.sweep.LaneSweep` is the
            single-program wrapper.
batcher     :class:`~repro_torch.serve.batcher.LaneBatcher` — forms fusion
            sets, lane counts padded to powers of two.
session     :class:`~repro_torch.serve.session.SessionCache` — LRU result
            cache keyed by (program, source, graph-version).
service     :class:`~repro_torch.serve.service.GraphService` — request
            queue, admission by lane budget, worker thread, per-request
            latency / I/O attribution.
loadgen     :class:`~repro_torch.serve.loadgen.LoadGenerator` — closed- and
            open-loop replay of a seeded :class:`~repro_torch.serve.
            loadgen.Workload` (query mix + mutation stream) against a live
            service, with a bitwise-oracle record of every answer.
==========  ===============================================================

On an engine booted with ``mesh=`` (a device count or a
:class:`~repro_torch.launch.mesh.Mesh`), :class:`~repro_torch.serve.sweep.
MeshSweep` and every sweep of the service route each shard to its owning
device slot (DESIGN.md §10).
"""

from .batcher import LaneBatcher, pad_lanes
from .loadgen import (
    LoadGenerator,
    LoadReport,
    OpRecord,
    QueryClass,
    UpdateRecord,
    Workload,
    edge_state_at_version,
    oracle_kwargs,
)
from .service import GraphService, QueryResult, ServiceOverloaded, UpdateResult
from .session import SessionCache
from .sweep import (
    FusedSweep,
    LaneResult,
    LaneSeed,
    LaneSweep,
    LaneTable,
    MeshSweep,
    SweepIterStats,
)

__all__ = [
    "GraphService",
    "QueryResult",
    "UpdateResult",
    "ServiceOverloaded",
    "LaneBatcher",
    "pad_lanes",
    "SessionCache",
    "FusedSweep",
    "LaneTable",
    "LaneSweep",
    "LaneSeed",
    "LaneResult",
    "MeshSweep",
    "SweepIterStats",
    "LoadGenerator",
    "LoadReport",
    "OpRecord",
    "QueryClass",
    "UpdateRecord",
    "Workload",
    "edge_state_at_version",
    "oracle_kwargs",
]
