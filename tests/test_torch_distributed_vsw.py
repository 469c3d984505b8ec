"""The port's distributed superstep on gloo (one rank a process) must match
the reference's single-device engine, as ``tests/test_distributed_vsw.py``
holds the reference's: R-MAT 700 vertices / 9000 edges, seed 11; PageRank
15 iterations, SSSP 40, WCC 60; rtol 1e-4, atol 1e-8.

Each world size runs in its own processes, started here with their own
timeout; they meet through a ``file://`` rendezvous in the test's
directory, so parallel test workers never share a port.  Every rank also
checks the superstep's two variants on its block: ``sentinel`` (no
validity plane) is bitwise the masked step, and ``msg_dtype=bf16`` is the
f32 step on bf16-rounded messages.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro.core import apps as ref_apps
from repro.core.graph import rmat_graph as ref_rmat_graph
from repro.core.vsw import VSWEngine as RefEngine

PROGRAMS = (("pagerank", 15), ("sssp", 40), ("wcc", 60))

RANK = textwrap.dedent(
    """
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, rdzv, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank,
                            world_size=world)
    from repro_torch.core import apps
    from repro_torch.core.distributed import (build_device_graph, make_superstep,
                                              run_distributed)
    from repro_torch.core.graph import rmat_graph

    g = rmat_graph(700, 9000, seed=11)
    res = {"src": g.src, "dst": g.dst}
    for name, iters in (("pagerank", 15), ("sssp", 40), ("wcc", 60)):
        prog = {"pagerank": apps.pagerank(), "sssp": apps.sssp(0),
                "wcc": apps.wcc()}[name]
        res[name], res[name + "_iters"] = run_distributed(g, prog,
                                                          max_iters=iters)

    # the variants, one superstep on this rank's block
    dg = build_device_graph(g, world, window=1 << 12, k=32, tr=8)
    rpd, ne = dg.rows_per_dev, dg.n_ell_per_dev
    rows, ells = slice(rank * rpd, (rank + 1) * rpd), slice(rank * ne, (rank + 1) * ne)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    idx, valid, seg = t(dg.ell_idx[ells]), t(dg.ell_valid[ells]), t(dg.seg[ells])
    sent = torch.where(valid, idx, dg.num_vertices)  # padding past the end
    od = t(dg.out_deg[rows])
    vals = torch.rand(dg.num_vertices, generator=torch.Generator().manual_seed(3))
    vals = (vals * 8).floor()[rows].contiguous()  # small integers: exact in bf16
    for name in ("pagerank", "sssp", "wcc"):
        step = lambda **kw: make_superstep(None, name, 700, rpd, **kw)
        want, n_want = step()(vals, idx, valid, seg, od)
        got, n_got = step(sentinel=True)(vals, sent, seg, od)
        res[name + "_sentinel_bitwise"] = bool(torch.equal(got, want)
                                               and int(n_got) == int(n_want))
        bf, _ = step(msg_dtype=torch.bfloat16)(vals, idx, valid, seg, od)
        res[name + "_bf16_err"] = float((bf - want).abs().max())
    np.savez(out, **res)
    dist.destroy_process_group()
    """
)


@pytest.fixture(scope="module")
def reference():
    g = ref_rmat_graph(700, 9000, seed=11)
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        eng = RefEngine.from_graph(g, d, num_shards=4, window=4096, k=32,
                                   backend="numpy", selective=False)
        out = {name: eng.run({"pagerank": ref_apps.pagerank(),
                              "sssp": ref_apps.sssp(0),
                              "wcc": ref_apps.wcc()}[name],
                             max_iters=iters).values
               for name, iters in PROGRAMS}
        eng.close()
    return g, out


def _run_ranks(tmp_path, world):
    script = tmp_path / "rank.py"
    script.write_text(RANK)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world),
         str(tmp_path / "rdzv"), str(tmp_path / f"out{r}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(world)]
    try:
        errs = [p.communicate(timeout=240)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), [e[-3000:] for e in errs]
    return [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(world)]


@pytest.mark.parametrize("world", [2, 8])
def test_distributed_matches_single_device(tmp_path, reference, world):
    g_ref, want = reference
    outs = _run_ranks(tmp_path, world)
    first = outs[0]
    assert np.array_equal(first["src"], g_ref.src)
    assert np.array_equal(first["dst"], g_ref.dst)
    for name, iters in PROGRAMS:
        a = np.nan_to_num(first[name], posinf=1e30)
        b = np.nan_to_num(want[name], posinf=1e30)
        assert a.shape == (700,) and 1 <= int(first[name + "_iters"]) <= iters
        assert np.allclose(a, b, rtol=1e-4, atol=1e-8), name
        for o in outs[1:]:  # every rank gathered the same result
            assert np.array_equal(o[name], first[name], equal_nan=True)
    for o in outs:
        for name, _ in PROGRAMS:
            assert o[name + "_sentinel_bitwise"], name
            # integer values below 16: the bf16 wire is exact for min
            # programs; PageRank's divided messages round to 8 bits
            limit = 0.0 if name != "pagerank" else 2e-2
            assert o[name + "_bf16_err"] <= limit, name
