"""The port's roofline: the H100 terms, the analytic FLOPs, and the counter
of dispatched collectives.

Against the reference (``repro.roofline``), on the same configs:
``model_flops`` and ``attention_analytic`` are equal (``==``) for every
arch, applicable shape and mode; ``RooflineTerms`` has the reference's
arithmetic on the H100 constants.  The collective counter runs on an
8-rank fake process group (``torch.testing._internal.distributed.fake_pg``)
in a child process, so no process group outlives the test.
"""

import os
import subprocess
import sys
import textwrap

import pytest

from repro import configs as ref_configs
from repro.config import SHAPES as REF_SHAPES
from repro.roofline import analysis as REF
from repro_torch import configs
from repro_torch.config import SHAPES
from repro_torch.roofline import hw
from repro_torch.roofline.analysis import (COLLECTIVES, RooflineTerms,
                                           attention_analytic, model_flops)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.mark.parametrize("arch", configs.list_archs())
def test_model_flops_and_attention_analytic_equal_the_reference(arch):
    cfg, rcfg = configs.get_config(arch), ref_configs.get_config(arch)
    assert configs.applicable_shapes(arch) == ref_configs.applicable_shapes(arch)
    for sname in configs.applicable_shapes(arch):
        shape, rshape = SHAPES[sname], REF_SHAPES[sname]
        for mode in ("train", "prefill", "decode"):
            assert model_flops(cfg, shape, mode) == REF.model_flops(rcfg, rshape, mode)
            assert attention_analytic(cfg, shape, mode) == REF.attention_analytic(
                rcfg, rshape, mode)


def test_roofline_terms_dominant():
    """The reference's test on the H100's constants (tolerance 1e-6 s)."""
    t = RooflineTerms(
        flops_per_dev=hw.PEAK_FLOPS_BF16,  # exactly 1 s of compute
        bytes_per_dev=hw.HBM_BW * 2,  # 2 s of memory
        collective_bytes_per_dev=hw.NVLINK_BW * 0.5,  # 0.5 s of collective
        n_chips=256,
    )
    assert abs(t.compute_s - 1.0) < 1e-6
    assert abs(t.memory_s - 2.0) < 1e-6
    assert abs(t.collective_s - 0.5) < 1e-6
    assert t.dominant == "memory"
    assert t.step_time_s == pytest.approx(3.5)
    assert t.step_time_overlap_s == pytest.approx(2.0)
    d = t.as_dict()
    assert d["dominant"] == "memory" and d["n_chips"] == 256
    assert hw.PEAK_FLOPS_BF16 == 989e12 and hw.HBM_BW == 3.35e12
    assert hw.chips((2, 16, 16)) == 2 * hw.CHIPS_PER_POD


def test_model_flops_modes():
    cfg = configs.get_config("yi-6b")
    tr = model_flops(cfg, SHAPES["train_4k"], "train")
    pf = model_flops(cfg, SHAPES["prefill_32k"], "prefill")
    dc = model_flops(cfg, SHAPES["decode_32k"], "decode")
    assert tr / pf == pytest.approx(3.0, rel=1e-6)
    assert dc < pf / 1000
    moe = configs.get_config("moonshot-v1-16b-a3b")
    assert model_flops(moe, SHAPES["train_4k"], "train") < 6 * moe.param_count * 4096 * 256


def test_applicable_shapes_skip_rules():
    assert "long_500k" in configs.applicable_shapes("jamba-1.5-large-398b")
    assert "long_500k" in configs.applicable_shapes("xlstm-350m")
    for arch in ("yi-6b", "gemma-7b", "whisper-large-v3", "paligemma-3b"):
        assert "long_500k" not in configs.applicable_shapes(arch)
    assert len(configs.list_archs()) == 10


def test_group_periods():
    assert configs.get_config("jamba-1.5-large-398b").group_period == 8
    assert configs.get_config("xlstm-350m").group_period == 4
    assert configs.get_config("yi-6b").group_period == 1
    assert configs.get_config("moonshot-v1-16b-a3b").group_period == 1
    for a in configs.list_archs():
        cfg = configs.get_config(a)
        assert cfg.num_layers % cfg.group_period == 0
        for i in range(cfg.group_period):
            mixer, mlp = cfg.layer_kind(i)
            assert mixer in ("attn", "ssd", "mlstm", "slstm")
            assert mlp in ("dense", "moe", "none")


def test_graph_workloads_are_the_references():
    from repro.configs import graphmp as ref_g
    from repro_torch.configs import graphmp as g

    assert {k: (w.num_vertices, w.num_edges) for k, w in g.WORKLOADS.items()} == {
        k: (w.num_vertices, w.num_edges) for k, w in ref_g.WORKLOADS.items()}


COUNTER = textwrap.dedent(
    """
    import torch, torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.tensor import distribute_tensor, Replicate, Shard
    from repro_torch.launch.mesh import make_model_mesh
    from repro_torch.roofline.analysis import CollectiveCounter

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    mesh = make_model_mesh((8,), ("data",), device_type="cpu")
    x = distribute_tensor(torch.zeros(64, 10), mesh, [Shard(0)],
                          src_data_rank=None)
    with CollectiveCounter() as c:
        y = x.redistribute(mesh, [Replicate()])
    assert tuple(y.to_local().shape) == (64, 10)
    s = c.stats
    print("GATHER", s.bytes_by_kind["all-gather"], s.count_by_kind["all-gather"],
          s.total_bytes)
    with CollectiveCounter() as c:
        z = torch.ones(3, 5, dtype=torch.float64)
        dist.all_reduce(z)
        p = x.sum(dim=0)  # partial over the ranks, reduced below
        q = p.redistribute(mesh, [Replicate()])
    s = c.stats
    print("REDUCE", s.bytes_by_kind["all-reduce"], s.count_by_kind["all-reduce"])
    """
)


def test_collective_counter_on_a_fake_group():
    """A ``Shard(0) -> Replicate()`` of a [64, 10] f32 tensor on 8 fake
    ranks is one all-gather of what lands on each rank (the whole tensor:
    2560 bytes); an all-reduce counts its output: 15 f64 (120 bytes) from
    ``torch.distributed``, 10 f32 (40 bytes) from DTensor's partial sum."""
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", COUNTER], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = {ln.split()[0]: [int(x) for x in ln.split()[1:]]
             for ln in r.stdout.splitlines() if ln.split()}
    assert lines["GATHER"] == [64 * 10 * 4, 1, 64 * 10 * 4]
    assert lines["REDUCE"] == [15 * 8 + 10 * 4, 2]
    assert set(COLLECTIVES) == {"all-gather", "all-reduce", "reduce-scatter",
                                "all-to-all", "collective-permute"}
