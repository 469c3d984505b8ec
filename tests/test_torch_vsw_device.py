"""The engine's device path (``repro_torch.core.vsw``): vertex arrays, the
programs' ``pre`` and ``apply`` and the activity test on the engine's
device, bitwise the host path.

Everything runs on device ``cpu``, so the programs' torch forms and the
``cuda`` backend's plain kernels run here.  The host path of the same
engine is the program with its device forms removed
(``dataclasses.replace``), which the engine runs in numpy on the host.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import apps
from repro_torch.core.executor import BatchedEllExecutor, PerShardExecutor
from repro_torch.core.graph import Graph, rmat_graph, small_world_graph
from repro_torch.core.scheduler import ShardScheduler
from repro_torch.core.vsw import VSWEngine
from repro_torch.delta import EdgeLog

PROGRAMS = {
    "pagerank": {},
    "ppr": {"source": 5},
    "sssp": {"source": 0},
    "bfs": {"source": 3},
    "wcc": {},
    "degree": {},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host(program):
    return dataclasses.replace(program, pre_device=None, apply_device=None)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("device") / "store"
    g = rmat_graph(1500, 20000, seed=23)
    VSWEngine.from_graph(g, str(root), backend="numpy", device="cpu",
                         num_shards=6, window=256, k=16).close()
    return str(root)


def _same_run(device, host):
    assert device.values.dtype == host.values.dtype == np.float32
    assert device.values.tobytes() == host.values.tobytes()
    assert device.converged == host.converged
    assert ([i.active_count for i in device.iterations]
            == [i.active_count for i in host.iterations])
    assert all(i.on_device for i in device.iterations)
    assert not any(i.on_device for i in host.iterations)


@pytest.mark.parametrize("batch_shards", [1, 4])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("name", list(PROGRAMS))
def test_every_program_bitwise_the_host_path(store, name, backend,
                                             batch_shards):
    program = apps.get_program(name, **PROGRAMS[name])
    assert program.has_device_forms
    with VSWEngine.from_store(store, device="cpu", backend=backend,
                              batch_shards=batch_shards) as eng:
        device = eng.run(program, max_iters=25)
        host = eng.run(_host(program), max_iters=25)
    _same_run(device, host)
    for it in device.iterations:
        assert it.stage_s == it.copy_back_s == 0.0


@pytest.mark.parametrize("threshold", [0.05, 0.005])
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_selective_frontier_skips_and_reads_the_same(tmp_path, backend, exact,
                                                     threshold):
    """A travelling SSSP frontier: both paths skip the same shards and read
    the same bytes, and active ids come to the host exactly in the
    iterations that plan selectively.  The frontier holds 4 of 600
    vertices: every iteration plans selectively under 0.05, only the first
    (one vertex) under 0.005."""
    g = small_world_graph(600, k=2, shortcuts=0.0, seed=3)
    root = str(tmp_path / "s")
    VSWEngine.from_graph(g, root, backend="numpy", device="cpu", num_shards=8,
                         window=128, k=16).close()
    kw = dict(backend=backend, exact_selective=exact, prefetch_depth=1,
              threshold=threshold)
    with VSWEngine.from_store(root, device="cpu", **kw) as eng:
        device = eng.run(apps.sssp(0), max_iters=400)
    with VSWEngine.from_store(root, device="cpu", **kw) as eng:
        host = eng.run(_host(apps.sssp(0)), max_iters=400)
    assert device.converged
    _same_run(device, host)
    skips = [i.shards_skipped for i in device.iterations]
    assert sum(skips) > 0
    assert skips == [i.shards_skipped for i in host.iterations]
    assert ([i.bytes_read for i in device.iterations]
            == [i.bytes_read for i in host.iterations])
    selective = [i.selective_on for i in device.iterations]
    assert selective == [i.selective_on for i in host.iterations]
    assert all(selective) if threshold == 0.05 else (
        selective[0] and not any(selective[1:]))
    for it in device.iterations:
        assert (it.ids_to_host > 0) == it.selective_on, it.iteration
    assert all(i.ids_to_host == 0 for i in host.iterations)


def test_pagerank_never_sends_ids_to_the_host(store):
    with VSWEngine.from_store(store, device="cpu", backend="cuda",
                              batch_shards=4) as eng:
        r = eng.run(apps.pagerank(), max_iters=8)
    assert all(i.on_device and i.ids_to_host == 0 and not i.selective_on
               for i in r.iterations)


def test_a_delta_published_between_sweeps_is_seen(tmp_path):
    """A live engine's device path after a publish that changes
    out-degrees equals both its own host path and an engine built from
    scratch on the mutated graph."""
    g = rmat_graph(400, 3000, seed=5)
    root = str(tmp_path / "live")
    kw = dict(num_shards=4, window=64, k=8, tr=4)
    live = VSWEngine.from_graph(g, root, backend="cuda", device="cpu",
                                batch_shards=2, **kw)
    try:
        before = live.run(apps.pagerank(), max_iters=10)
        rng = np.random.default_rng(2)
        ins = np.stack([rng.integers(0, 400, 300), rng.integers(0, 400, 300)],
                       axis=1).astype(np.int64)
        log = EdgeLog(live.store)
        log.append(inserts=ins)
        log.publish()
        mutated = Graph(400, np.concatenate([g.src, ins[:, 0]]),
                        np.concatenate([g.dst, ins[:, 1]]))
        with VSWEngine.from_graph(mutated, str(tmp_path / "fresh"),
                                  backend="cuda", device="cpu", batch_shards=2,
                                  **kw) as fresh:
            want = fresh.run(apps.pagerank(), max_iters=10)
        device = live.run(apps.pagerank(), max_iters=10)
        host = live.run(_host(apps.pagerank()), max_iters=10)
    finally:
        live.close()
    _same_run(device, host)
    assert device.values.tobytes() == want.values.tobytes()
    assert device.values.tobytes() != before.values.tobytes()


@pytest.mark.parametrize("kw", [dict(backend="numpy"),
                                dict(backend="torch", mesh=2),
                                dict(backend="numpy", mesh=2)],
                         ids=["numpy", "torch-mesh", "numpy-mesh"])
def test_oracle_and_mesh_keep_the_host_path(store, kw):
    with VSWEngine.from_store(store, device="cpu", batch_shards=2, **kw) as eng:
        r = eng.run(apps.sssp(0), max_iters=15)
    with VSWEngine.from_store(store, device="cpu", backend="torch",
                              batch_shards=2) as eng:
        solo = eng.run(apps.sssp(0), max_iters=15)
    assert not any(i.on_device for i in r.iterations)
    assert r.values.tobytes() == solo.values.tobytes()


def test_a_program_without_device_forms_runs_on_the_host(store):
    program = apps.pagerank()
    user = dataclasses.replace(program, name="user", pre_device=None)
    assert not user.has_device_forms
    with VSWEngine.from_store(store, device="cpu", backend="cuda") as eng:
        r = eng.run(user, max_iters=5)
        want = eng.run(program, max_iters=5)
    assert not any(i.on_device for i in r.iterations)
    assert r.values.tobytes() == want.values.tobytes()


@pytest.mark.parametrize("make", [
    lambda: PerShardExecutor("cuda", device="cpu"),
    lambda: BatchedEllExecutor("cuda", 2, device="cpu"),
], ids=["per_shard", "batched"])
def test_executor_refuses_unpadded_device_messages(store, make):
    with VSWEngine.from_store(store, device="cpu", backend="cuda") as eng:
        loaded = eng.pipeline.iter_shards([0, 1])
        try:
            with pytest.raises(ValueError, match="messages on the device"):
                next(make().run(loaded, torch.zeros(eng.meta.num_vertices),
                                "sum"))
        finally:
            loaded.close()


def test_scheduler_plans_from_a_count_unless_it_tests_shards(store):
    with VSWEngine.from_store(store, device="cpu", backend="cuda",
                              threshold=0.01) as eng:
        sched: ShardScheduler = eng.scheduler
        n = eng.meta.num_vertices
        assert not sched.tests_shards(n)
        plan = sched.plan(None, active_count=n)
        assert plan.shards == list(range(eng.meta.num_shards))
        assert not plan.selective_on and plan.active_ratio == 1.0
        assert sched.tests_shards(1)
        with pytest.raises(ValueError, match="active ids"):
            sched.plan(None, active_count=1)
        assert sched.plan(np.array([0]), active_count=99).active_ratio == 1 / n
