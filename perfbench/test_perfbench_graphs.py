"""The benchmark's generators: deterministic per seed, one structure for
every seed, and the degree statistics of Graph500's Kronecker graph and of
GAP's urand at scale 10."""

import pytest
import torch

from perfbench import graphs, parts
from perfbench.conftest import REPO

KRON = {"generator": "kronecker", "scale": 10, "edge_factor": 16,
        "initiator": [0.57, 0.19, 0.19, 0.05], "structure_seed": 5}
URAND = {"generator": "uniform", "scale": 10, "edge_factor": 16,
         "structure_seed": 6}


def _make(config, seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return graphs.make(config, gen, "cpu")


@pytest.mark.parametrize("config", [KRON, URAND], ids=["kron", "urand"])
def test_same_seed_same_graph_other_seed_renumbers_it(config):
    s1, d1, p1 = _make(config, 2**31 + 7)
    s2, d2, p2 = _make(config, 2**31 + 7)
    assert torch.equal(s1, s2) and torch.equal(d1, d2) and torch.equal(p1, p2)
    s3, d3, p3 = _make(config, 2**32 + 9)
    assert not torch.equal(p1, p3)
    # the same structure: undo each permutation and the edge lists agree
    inv1, inv3 = torch.argsort(p1), torch.argsort(p3)
    assert torch.equal(inv1[s1], inv3[s3]) and torch.equal(inv1[d1], inv3[d3])
    assert s1.numel() == 16 << 10 and int(s1.max()) < 1 << 10


def test_kronecker_bits_follow_the_initiator():
    gen = torch.Generator()
    gen.manual_seed(11)
    src, dst = parts.load(REPO, "generators", "kronecker").edges(KRON, gen, "cpu")
    bits = torch.arange(10)
    src_bits = ((src[:, None] >> bits) & 1).float().mean()
    dst_bits = ((dst[:, None] >> bits) & 1).float().mean()
    both = (((src[:, None] >> bits) & (dst[:, None] >> bits)) & 1).float().mean()
    # P(src bit) = C + D, P(dst bit) = B + D, P(both) = D
    assert abs(float(src_bits) - 0.24) < 0.01
    assert abs(float(dst_bits) - 0.24) < 0.01
    assert abs(float(both) - 0.05) < 0.005


def test_degree_statistics_at_scale_10():
    ks, kd, _ = _make(KRON, 3)
    us, ud, _ = _make(URAND, 3)
    n = 1 << 10
    k_in = torch.bincount(kd, minlength=n)
    u_in = torch.bincount(ud, minlength=n)
    assert float(k_in.float().mean()) == float(u_in.float().mean()) == 16.0
    # Kronecker: hubs far above the mean, many vertices with no in-edge
    assert int(k_in.max()) > 20 * 16
    assert float((k_in == 0).float().mean()) > 0.15
    # urand: Poisson(16) in-degrees, no hubs, almost no empty vertex
    assert int(u_in.max()) < 45
    assert float((u_in == 0).float().mean()) < 0.01
    c = graphs.counts_of(n, ks, kd)
    assert c.vertices == n and c.edges == 16 * n
    assert c.sources == int((torch.bincount(ks, minlength=n) > 0).sum())
    assert c.destinations == int((k_in > 0).sum())

