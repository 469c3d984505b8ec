"""The GAP suite's ``urand``: both endpoints of every edge uniform."""

import torch


def edges(config: dict, gen: torch.Generator, device) -> tuple:
    """``(src, dst)``: ``edge_factor * 2**scale`` edges."""
    n, m = 1 << config["scale"], config["edge_factor"] << config["scale"]
    ends = torch.randint(0, n, (2, m), generator=gen, device=device)
    return ends[0], ends[1]
