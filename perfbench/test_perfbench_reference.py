"""The plain reference against answers worked out by hand."""

import math

import torch

from perfbench.reference import graph as ref

# 0 -> 1, 0 -> 2, 1 -> 2, 2 -> 0, 3 -> 2; vertex 4 has no edge
SRC = torch.tensor([0, 0, 1, 2, 3])
DST = torch.tensor([1, 2, 2, 0, 2])
N = 5


def test_pagerank_one_and_two_steps_by_hand():
    d = 0.85
    base = (1 - d) / N
    x0 = 1 / N
    # step 1: msgs 0: x0/2, 1: x0, 2: x0, 3: x0, 4: x0 (no out-edge)
    want1 = [base + d * x0, base + d * x0 / 2,
             base + d * (x0 / 2 + x0 + x0), base, base]
    got1 = ref.pagerank(SRC, DST, N, d, 1)
    assert torch.allclose(got1, torch.tensor(want1, dtype=torch.float64),
                          rtol=0, atol=1e-15)
    x = want1
    want2 = [base + d * x[2], base + d * x[0] / 2,
             base + d * (x[0] / 2 + x[1] + x[3]), base, base]
    got2 = ref.pagerank(SRC, DST, N, d, 2)
    assert torch.allclose(got2, torch.tensor(want2, dtype=torch.float64),
                          rtol=0, atol=1e-15)


def test_pagerank_control_is_bfloat16():
    exact = ref.pagerank(SRC, DST, N, 0.85, 3)
    low = ref.pagerank(SRC, DST, N, 0.85, 3, store_dtype=torch.bfloat16)
    assert torch.equal(low, low.to(torch.bfloat16).to(torch.float64))
    assert 1e-5 < float(((low - exact).abs() / exact).max()) < 1e-2

