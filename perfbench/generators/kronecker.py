"""The Graph500 Kronecker generator (the specification's reference code,
``kronecker_generator.m``): each of ``scale`` levels draws two uniforms
per edge and sets one bit of the source and of the destination by the
initiator ``A, B, C`` (``D = 1 - A - B - C``).  The reference code's final
shuffle of the edge order is left out: the port's preprocessing sorts
edges by destination and source, so the order changes nothing it stores.
The random permutation of the vertex ids is ``graphs.make``'s."""

import torch


def edges(config: dict, gen: torch.Generator, device) -> tuple:
    """``(src, dst)`` int64 tensors of ``edge_factor * 2**scale`` edges."""
    scale = config["scale"]
    a, b, c = (float(x) for x in config["initiator"][:3])
    m = config["edge_factor"] << scale
    ab = a + b
    c_norm, a_norm = c / (1.0 - ab), a / ab
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for level in range(scale):
        r = torch.rand(2, m, generator=gen, device=device)
        ii = r[0] > ab
        jj = r[1] > torch.where(ii, c_norm, a_norm)
        src |= ii.to(torch.int64) << level
        dst |= jj.to(torch.int64) << level
        del r, ii, jj
    return src, dst
