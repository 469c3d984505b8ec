"""The general generator of the benchmark's traffic.

A traffic file (``traffic/<name>.json``) holds only parameters.  Its
``program`` names the file ``programs/<program>.py`` that drives the
engine through a request at a time and compares every answer of the
window with the plain reference; the limits of that comparison are in the
traffic file, under ``limits``.  A program file defines ``Program``, a
``Mix`` built as ``Program(traffic, src, perm, gen)``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from . import parts

__all__ = ["Answer", "Compared", "Mix", "make"]


@dataclasses.dataclass
class Answer:
    """One request's answer as the timed path produced it."""

    key: int  # what the request asked for (a root); 0 where nothing
    values: np.ndarray
    converged: bool


@dataclasses.dataclass
class Compared:
    """One compared number, its limit, and the answers it failed."""

    name: str
    value: float
    limit: float
    failed: int = 0

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


class Mix:
    """The requests of one traffic file on one graph: the graph's edges
    ``src`` (permuted ids), the permutation ``perm`` (structural id ``v``
    is ``perm[v]``) and the run's generator ``gen``, for what the seed
    draws."""

    def __init__(self, traffic: dict, src: torch.Tensor, perm: torch.Tensor,
                 gen: torch.Generator):
        self.traffic = traffic
        self.limits: Dict[str, float] = traffic["limits"]

    def warm_up(self, engine) -> None:
        """Put every shard the requests use on the card, and run what
        compiles or warms up, before the window."""
        raise NotImplementedError

    def request(self, engine, i: int):
        """Request ``i`` on ``engine``: ``(Answer, RunResult)``."""
        raise NotImplementedError

    def compare(self, answers: List[Answer], src, dst, n,
                control: bool = False) -> List[Compared]:
        """The compared numbers of ``answers`` against the reference on
        the edges ``src -> dst``; with ``control``, of the control put in
        the program's place."""
        raise NotImplementedError


def make(traffic: dict, src: torch.Tensor, perm: torch.Tensor,
         gen: torch.Generator, root: Path = parts.ROOT) -> Mix:
    """The mix a traffic file describes, its program found under
    ``root``."""
    program = parts.load(root, "programs", traffic["program"])
    return program.Program(traffic, src, perm, gen)
