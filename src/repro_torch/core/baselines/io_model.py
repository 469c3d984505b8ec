"""Analytic I/O model — paper Table II.

Per-iteration disk read/write volume and memory usage for the five
computation models, as closed-form functions of:

    C  size of a vertex value record (bytes)
    D  size of one edge record (bytes)
    V  number of vertices, E number of edges
    P  number of shards / partitions / grid cells
    N  number of CPU cores (VSW memory term)
    theta  cache miss ratio (VSW read term), 0 <= theta <= 1
    d_avg  average degree (VSP's v-shard duplication factor delta)

``benchmarks/bench_io_model.py`` prints this table for the paper's datasets
and cross-checks the VSW/PSW/ESG/DSW rows against *measured* bytes from the
real engines on synthetic graphs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

__all__ = ["IOModel", "MODELS", "io_table"]


@dataclasses.dataclass(frozen=True)
class IOModel:
    name: str
    system: str
    read: object  # callable(params) -> bytes
    write: object
    memory: object


def _delta(d_avg: float, P: int) -> float:
    return (1.0 - math.exp(-d_avg / P)) * P


@dataclasses.dataclass
class IOParams:
    C: float
    D: float
    V: float
    E: float
    P: int
    N: int = 1
    theta: float = 1.0

    @property
    def d_avg(self) -> float:
        return self.E / max(self.V, 1)


MODELS: Dict[str, IOModel] = {
    "psw": IOModel(
        "PSW", "GraphChi",
        read=lambda p: p.C * p.V + 2 * (p.C + p.D) * p.E,
        write=lambda p: p.C * p.V + 2 * (p.C + p.D) * p.E,
        memory=lambda p: (p.C * p.V + 2 * (p.C + p.D) * p.E) / p.P,
    ),
    "esg": IOModel(
        "ESG", "X-Stream",
        read=lambda p: p.C * p.V + (p.C + p.D) * p.E,
        write=lambda p: p.C * p.V + p.C * p.E,
        memory=lambda p: p.C * p.V / p.P,
    ),
    "vsp": IOModel(
        "VSP", "VENUS",
        read=lambda p: p.C * (1 + _delta(p.d_avg, p.P)) * p.V + p.D * p.E,
        write=lambda p: p.C * p.V,
        memory=lambda p: p.C * (2 + _delta(p.d_avg, p.P)) * p.V / p.P,
    ),
    "dsw": IOModel(
        "DSW", "GridGraph",
        read=lambda p: p.C * math.sqrt(p.P) * p.V + p.D * p.E,
        write=lambda p: p.C * math.sqrt(p.P) * p.V,
        memory=lambda p: 2 * p.C * p.V / math.sqrt(p.P),
    ),
    "vsw": IOModel(
        "VSW", "GraphMP (ours)",
        read=lambda p: p.theta * p.D * p.E,
        write=lambda p: 0.0,
        memory=lambda p: 2 * p.C * p.V + p.N * p.D * p.E / p.P,
    ),
}


def io_table(params: IOParams) -> Dict[str, Dict[str, float]]:
    return {
        key: {
            "read": float(m.read(params)),
            "write": float(m.write(params)),
            "memory": float(m.memory(params)),
        }
        for key, m in MODELS.items()
    }
