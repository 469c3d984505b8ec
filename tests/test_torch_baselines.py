"""The port's baseline engines (PSW/ESG/DSW: GraphChi, X-Stream, GridGraph
I/O schedules) against VSW and against the reference's.

Carried from the reference: each baseline equals VSW numerically, and the
measured I/O follows Table II's ordering (PSW > ESG > DSW > VSW).  Across
packages (ROADMAP North star (a), (b)): ``prepare_baseline_store`` writes
the same files byte for byte, each engine gives bitwise the reference's
values with the same bytes read and written per iteration, and
``io_table`` gives exactly the same floats.
"""

import dataclasses
import os
import time

import numpy as np
import pytest

from repro.core import apps as ref_apps
from repro.core.baselines import engines as ref_engines
from repro.core.baselines.io_model import IOParams as RefIOParams
from repro.core.baselines.io_model import io_table as ref_io_table
from repro_torch.core import apps
from repro_torch.core.baselines import (
    MODELS,
    DSWEngine,
    ESGEngine,
    IOParams,
    PSWEngine,
    io_table,
    prepare_baseline_store,
)
from repro_torch.core.graph import rmat_graph
from repro_torch.core.vsw import VSWEngine


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    g = rmat_graph(400, 5000, seed=7)
    d1 = tmp_path_factory.mktemp("vsw")
    d2 = tmp_path_factory.mktemp("base")
    vsw = VSWEngine.from_graph(g, str(d1), num_shards=6, window=128, k=16,
                               backend="numpy", selective=False, device="cpu")
    store = prepare_baseline_store(g, str(d2), num_shards=6)
    return g, vsw, store


@pytest.mark.parametrize("prog_name,iters", [
    ("pagerank", 10), ("sssp", 25), ("wcc", 40),
])
@pytest.mark.parametrize("engine_cls", [PSWEngine, ESGEngine, DSWEngine])
def test_baseline_matches_vsw(setup, prog_name, iters, engine_cls):
    g, vsw, store = setup
    prog = apps.get_program(prog_name) if prog_name != "sssp" else apps.sssp(0)
    ref = vsw.run(prog, max_iters=iters).values
    got = engine_cls(store).run(prog, max_iters=iters).values
    a = np.nan_to_num(got, posinf=1e30)
    b = np.nan_to_num(ref, posinf=1e30)
    assert np.allclose(a, b, atol=1e-6)


def test_io_ordering_matches_table2(setup):
    g, vsw, store = setup
    prog = apps.pagerank()
    reads = {}
    for name, cls in (("psw", PSWEngine), ("esg", ESGEngine), ("dsw", DSWEngine)):
        io0 = store.io.snapshot()
        r = cls(store).run(prog, max_iters=3)
        d = store.io - io0
        reads[name] = d.bytes_read / r.num_iterations
        if name == "psw":
            writes_psw = d.bytes_written / r.num_iterations
    rv = vsw.run(prog, max_iters=3)
    reads["vsw"] = rv.total_bytes_read / rv.num_iterations
    assert reads["psw"] > reads["esg"] > reads["dsw"] > 0
    assert reads["vsw"] < reads["dsw"]
    assert writes_psw > 0
    w0 = vsw.store.io.bytes_written
    vsw.run(prog, max_iters=2)
    assert vsw.store.io.bytes_written == w0


def test_analytic_model_rows():
    p = IOParams(C=4, D=8, V=1.1e9, E=91.8e9, P=4096, N=24, theta=0.3)
    t = io_table(p)
    assert t["vsw"]["write"] == 0
    assert t["vsw"]["read"] < t["dsw"]["read"] < t["esg"]["read"] < t["psw"]["read"]
    assert t["vsw"]["memory"] > t["esg"]["memory"]
    assert np.isclose(t["vsw"]["read"], 0.3 * 8 * 91.8e9)


def test_analytic_vs_measured_edge_term(setup):
    g, vsw, store = setup
    prog = apps.pagerank()
    P = store.read_meta().num_shards
    params = IOParams(C=4, D=8, V=g.num_vertices, E=g.num_edges, P=P)
    io0 = store.io.snapshot()
    r = ESGEngine(store).run(prog, max_iters=3)
    measured = (store.io - io0).bytes_read / r.num_iterations
    predicted = MODELS["esg"].read(params)
    assert 0.5 < measured / predicted < 2.5


# ----------------------------------------------------------- across packages
def _files(root):
    return {f: open(os.path.join(root, f), "rb").read()
            for f in sorted(os.listdir(root))}


@pytest.fixture(scope="module")
def both_stores(tmp_path_factory):
    """The same graph prepared by each package, the clock pinned (npz
    members carry the write time)."""
    g = rmat_graph(300, 3500, seed=17)
    d = tmp_path_factory.mktemp("pair")
    real_time = time.time
    time.time = lambda: 1_700_000_000.0
    try:
        ref = ref_engines.prepare_baseline_store(g, str(d / "ref"), num_shards=5)
        pt = prepare_baseline_store(g, str(d / "pt"), num_shards=5)
    finally:
        time.time = real_time
    return ref, pt


def test_baseline_store_byte_identical_across_packages(both_stores):
    ref, pt = both_stores
    a, b = _files(ref.root), _files(pt.root)
    assert list(a) == list(b)
    assert any(f.startswith("aux_dsw_grid_") for f in a)
    for name in a:
        assert a[name] == b[name], name
    assert vars(ref.io) == vars(pt.io)


@pytest.mark.parametrize("prog_name", ["pagerank", "sssp", "wcc"])
@pytest.mark.parametrize("engine", ["PSWEngine", "ESGEngine", "DSWEngine"])
def test_baseline_bitwise_the_reference(both_stores, engine, prog_name):
    """Values bitwise, and per iteration the same bytes read and written
    and the same activity, as the reference's engine."""
    ref_store, pt_store = both_stores
    kw = {"source": 0} if prog_name == "sssp" else {}
    iters = {"pagerank": 6, "sssp": 20, "wcc": 20}[prog_name]
    io_r, io_p = ref_store.io.snapshot(), pt_store.io.snapshot()
    want = getattr(ref_engines, engine)(ref_store).run(
        ref_apps.get_program(prog_name, **kw), max_iters=iters)
    got = {"PSWEngine": PSWEngine, "ESGEngine": ESGEngine,
           "DSWEngine": DSWEngine}[engine](pt_store).run(
        apps.get_program(prog_name, **kw), max_iters=iters)
    assert np.array_equal(got.values, want.values)
    assert got.converged == want.converged
    assert len(got.iterations) == len(want.iterations)
    for a, b in zip(got.iterations, want.iterations):
        assert (a.bytes_read, a.active_count, a.shards_processed) == (
            b.bytes_read, b.active_count, b.shards_processed)
    assert vars(pt_store.io - io_p) == vars(ref_store.io - io_r)


@pytest.mark.parametrize("params", [
    dict(C=4, D=8, V=1.1e9, E=91.8e9, P=4096, N=24, theta=0.3),
    dict(C=4, D=8, V=41.7e6, E=1.47e9, P=80, N=8, theta=1.0),
    dict(C=8, D=12, V=3.0, E=7.0, P=1),
])
def test_io_table_exactly_the_reference(params):
    got, want = io_table(IOParams(**params)), ref_io_table(RefIOParams(**params))
    assert got == want
    assert dataclasses.asdict(IOParams(**params)) == dataclasses.asdict(
        RefIOParams(**params))
