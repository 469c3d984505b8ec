"""The benchmark's graphs: edge lists made on the device from a
``torch.Generator``, in a few large calls.

A configuration names its generator (``"generator": <kind>``), found as
``generators/<kind>.py`` with ``edges(config, gen, device) -> (src,
dst)``: ``kronecker`` (Graph500) and ``uniform`` (GAP's ``urand``).
Edges stay directed as drawn (the configurations say ``"symmetric":
false``); duplicates and self-loops are kept.

The edges are drawn from the configuration's own ``structure_seed``; the
run's seed draws the random permutation of the vertex ids.  Every seed
thus gets the same graph, numbered anew: other shards, windows and ELL
rows for the port, and the same work, so that runs with different seeds
differ by no more than runs of one seed.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

from . import parts

__all__ = ["GraphCounts", "make", "counts_of"]


@dataclasses.dataclass(frozen=True)
class GraphCounts:
    """What one whole-graph sweep of the update must touch at the least."""

    vertices: int
    edges: int
    sources: int  # vertices with at least one out-edge: messages read
    destinations: int  # vertices with at least one in-edge: partials


def make(config: dict, gen: torch.Generator, device,
         root: Path = parts.ROOT) -> tuple:
    """``(src, dst, perm)``: the configuration's graph, its vertex ids
    permuted by ``perm`` (structural id ``v`` is ``perm[v]``), drawn from
    ``gen``; the generator is found under ``root``."""
    structure = torch.Generator(device=device)
    structure.manual_seed(config["structure_seed"])
    generator = parts.load(root, "generators", config["generator"])
    src, dst = generator.edges(config, structure, device)
    perm = torch.randperm(1 << config["scale"], generator=gen, device=device)
    return perm[src], perm[dst], perm


def counts_of(n: int, src: torch.Tensor, dst: torch.Tensor) -> GraphCounts:
    out_deg = torch.bincount(src, minlength=n)
    in_deg = torch.bincount(dst, minlength=n)
    return GraphCounts(vertices=n, edges=int(src.numel()),
                       sources=int((out_deg > 0).sum()),
                       destinations=int((in_deg > 0).sum()))
