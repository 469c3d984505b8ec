"""GraphMP core on PyTorch: the paper's semi-external-memory engine.

Public API::

    from repro_torch.core import apps, VSWEngine, rmat_graph

    engine = VSWEngine.from_graph(rmat_graph(1 << 21, 1 << 25), root,
                                  num_shards=16, batch_shards=4,
                                  cache_bytes=1 << 30)   # backend/device: cuda
    result = engine.run(apps.pagerank(), max_iters=5)

Pass ``device="cpu"`` to run on the CPU (the kernels' plain versions).
"""

from . import apps
from .csr import DeviceEll, EllShard, csr_to_ell, ell_to_device
from .executor import (
    BACKENDS,
    LANE_BACKENDS,
    BatchedEllExecutor,
    PerShardExecutor,
    make_executor,
    make_lane_executor,
    resolve_device,
)
from .graph import (
    Graph,
    chain_graph,
    from_edge_list,
    rmat_graph,
    small_world_graph,
    star_graph,
    uniform_graph,
)
from .ingest import (
    IngestStats,
    csr_from_keys,
    ingest_edge_file,
    iter_edge_chunks,
    keys_of_csr,
    kway_merge,
    pack_keys,
    route_edges,
    write_edge_file,
)
from .pipeline import LoadedShard, PipelineStats, ShardPipeline
from .scheduler import ShardPlan, ShardScheduler
from .sharding import GraphMeta, ShardCSR, preprocess
from .storage import IOStats, ShardStore
from .vsw import IterStats, RunResult, VSWEngine

__all__ = [
    "apps",
    "Graph",
    "chain_graph",
    "from_edge_list",
    "rmat_graph",
    "small_world_graph",
    "star_graph",
    "uniform_graph",
    "GraphMeta",
    "ShardCSR",
    "preprocess",
    "EllShard",
    "DeviceEll",
    "csr_to_ell",
    "ell_to_device",
    "IOStats",
    "ShardStore",
    "BACKENDS",
    "LANE_BACKENDS",
    "IterStats",
    "RunResult",
    "VSWEngine",
    "ShardScheduler",
    "ShardPlan",
    "ShardPipeline",
    "PipelineStats",
    "LoadedShard",
    "PerShardExecutor",
    "BatchedEllExecutor",
    "make_executor",
    "make_lane_executor",
    "resolve_device",
    "IngestStats",
    "ingest_edge_file",
    "iter_edge_chunks",
    "write_edge_file",
    "pack_keys",
    "keys_of_csr",
    "csr_from_keys",
    "route_edges",
    "kway_merge",
]
