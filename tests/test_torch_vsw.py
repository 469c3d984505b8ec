"""VSWEngine.run of the port against the reference engine, and the port's
own bitwise contracts (DESIGN.md §5).

Both engines open ONE store (written by the reference, so cross-package
opening is exercised too) and run the same program:

- ``numpy`` (port) vs ``numpy`` (reference): bitwise;
- ``torch`` vs ``jnp`` and ``cuda`` vs ``pallas`` (interpret mode; on the
  CPU the port's wrappers run the kernels' plain versions): min/max
  programs bitwise, sum programs within rtol=1e-5, atol=1e-9
  (``tests/test_core_vsw.py``'s tolerance).

Graphs stay at 2k vertices or fewer on the Pallas paths.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import apps as ref_apps
from repro.core.graph import chain_graph, rmat_graph, small_world_graph
from repro.core.vsw import VSWEngine as RefEngine
from repro_torch.core import apps
from repro_torch.core.executor import (
    BatchedEllExecutor,
    PerShardExecutor,
    make_executor,
)
from repro_torch.core.vsw import VSWEngine

PROGRAMS = {
    "pagerank": ({}, 10),
    "sssp": ({"source": 0}, 100),
    "wcc": ({}, 100),
    "bfs": ({"source": 3}, 100),
    "ppr": ({"source": 5}, 10),
}
PAIRS = [("numpy", "numpy"), ("torch", "jnp"), ("cuda", "pallas")]
STORE = dict(num_shards=5, window=128, k=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps the suite's parallel
    workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f(v):
    return np.nan_to_num(np.asarray(v, np.float64), posinf=1e30)


@pytest.fixture(scope="module")
def ref_store(tmp_path_factory):
    root = tmp_path_factory.mktemp("parity") / "store"
    g = rmat_graph(600, 7000, seed=17)
    RefEngine.from_graph(g, str(root), backend="numpy", **STORE).close()
    return str(root)


@pytest.mark.parametrize("name", list(PROGRAMS))
@pytest.mark.parametrize("ours,theirs", PAIRS)
def test_engine_matches_reference(ref_store, name, ours, theirs):
    kw, iters = PROGRAMS[name]
    # one loader thread: with a cache that holds part of the store, the
    # order of concurrent puts would decide what is evicted
    common = dict(batch_shards=2, cache_bytes=1 << 16, prefetch_depth=1)
    with RefEngine.from_store(ref_store, backend=theirs, **common) as ref:
        want = ref.run(ref_apps.get_program(name, **kw), max_iters=iters)
    with VSWEngine.from_store(ref_store, backend=ours, device="cpu",
                              **common) as eng:
        got = eng.run(apps.get_program(name, **kw), max_iters=iters)
    assert got.num_iterations == want.num_iterations or (
        got.iterations[-1].active_count == want.iterations[-1].active_count)
    a, b = _f(got.values), _f(want.values)
    if ours == "numpy" or apps.get_program(name, **kw).combine != "sum":
        assert np.array_equal(a, b), name
    else:
        assert np.allclose(a, b, rtol=1e-5, atol=1e-9), np.abs(a - b).max()
    for x, y in zip(got.iterations, want.iterations):
        assert (x.shards_processed, x.shards_skipped, x.bytes_read,
                x.cache_hits, x.cache_misses, x.dispatches) == (
            y.shards_processed, y.shards_skipped, y.bytes_read,
            y.cache_hits, y.cache_misses, y.dispatches)


@pytest.mark.parametrize("backend,theirs", [("numpy", "numpy"), ("torch", "jnp")])
def test_selective_skips_and_bytes_match_reference(tmp_path, backend, theirs):
    """A travelling SSSP frontier drives selective scheduling: the same
    shards are skipped and the same bytes read as in the reference."""
    g = small_world_graph(600, k=2, shortcuts=0.0, seed=3)
    root = str(tmp_path / "s")
    RefEngine.from_graph(g, root, backend="numpy", num_shards=8, window=128,
                         k=16).close()
    for exact in (False, True):
        kw = dict(backend=backend, exact_selective=exact, prefetch_depth=1,
                  threshold=0.05)
        with VSWEngine.from_store(root, device="cpu", **kw) as eng:
            got = eng.run(apps.sssp(0), max_iters=400)
        kw["backend"] = theirs
        with RefEngine.from_store(root, **kw) as ref:
            want = ref.run(ref_apps.sssp(0), max_iters=400)
        assert got.converged and want.converged
        assert np.array_equal(_f(got.values), _f(want.values))
        skips = [i.shards_skipped for i in got.iterations]
        assert sum(skips) > 0
        assert skips == [i.shards_skipped for i in want.iterations]
        assert [i.bytes_read for i in got.iterations] == [
            i.bytes_read for i in want.iterations]
        assert got.total_bytes_read == want.total_bytes_read
        assert eng.loading_io.bytes_read == ref.loading_io.bytes_read


@pytest.fixture(scope="module")
def port_store(tmp_path_factory):
    root = tmp_path_factory.mktemp("port") / "store"
    g = rmat_graph(1500, 20000, seed=23)
    VSWEngine.from_graph(g, str(root), backend="numpy", device="cpu",
                         num_shards=6, window=256, k=16).close()
    return str(root)


def _run(root, program, **kw):
    with VSWEngine.from_store(root, device="cpu", **kw) as eng:
        return eng.run(program, max_iters=15)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("name", ["pagerank", "sssp", "wcc"])
def test_batched_equals_per_shard_bitwise(port_store, backend, name):
    base = _run(port_store, apps.get_program(name), backend=backend,
                batch_shards=1)
    for bs in (2, 4, 6):
        r = _run(port_store, apps.get_program(name), backend=backend,
                 batch_shards=bs)
        assert np.array_equal(_f(r.values), _f(base.values)), bs
        assert r.iterations[0].dispatches == -(-6 // bs)


@pytest.mark.parametrize("backend", ["numpy", "torch", "cuda"])
def test_prefetch_depth_has_no_effect(port_store, backend):
    runs = [_run(port_store, apps.pagerank(), backend=backend,
                 batch_shards=3 if backend != "numpy" else 1,
                 prefetch_depth=d)
            for d in (0, 1, 4)]
    for r in runs[1:]:
        assert np.array_equal(r.values, runs[0].values)
        assert r.total_bytes_read == runs[0].total_bytes_read


def test_device_resident_matches_and_skips_reads(port_store):
    plain = _run(port_store, apps.pagerank(), backend="cuda", batch_shards=3)
    with VSWEngine.from_store(port_store, device="cpu", backend="cuda",
                              batch_shards=3, device_resident=True) as eng:
        r = eng.run(apps.pagerank(), max_iters=15)
        assert len(eng._device_shards) == 6
    assert np.array_equal(r.values, plain.values)
    assert r.iterations[0].bytes_read > 0
    assert all(i.bytes_read == 0 for i in r.iterations[1:])
    assert all(i.to_device_s == 0.0 for i in r.iterations[1:])


@pytest.mark.parametrize("path", ["host", "device"])
def test_iteration_stats_of_ell_backend(port_store, path):
    """The host path (the program without its device forms) stages the
    messages and copies the accumulators back; the device path does
    neither."""
    program = apps.sssp(0)
    if path == "host":
        program = dataclasses.replace(program, pre_device=None,
                                      apply_device=None)
    r = _run(port_store, program, backend="cuda", batch_shards=2)
    it = r.iterations[0]
    assert it.dispatches == 3 and it.shards_processed == 6
    assert 0.0 < it.padding_ratio < 1.0
    if path == "host":
        assert 0.0 < it.stage_s + it.copy_back_s <= it.exec_s
        assert not it.on_device
    else:
        assert it.stage_s == it.copy_back_s == 0.0
        assert it.on_device
    assert it.exec_s > 0.0 and it.time_s >= it.exec_s


def test_chain_converges_like_reference(tmp_path):
    g = chain_graph(64)
    kw = dict(num_shards=3, window=16, k=4)
    with VSWEngine.from_graph(g, str(tmp_path / "a"), backend="torch",
                              device="cpu", **kw) as eng:
        r = eng.run(apps.bfs(0), max_iters=100)
    assert r.converged and r.values[-1] == 63.0
    assert r.num_iterations == 64


def test_executor_selection_and_errors():
    assert isinstance(make_executor("numpy", batch_shards=4, device="cpu"),
                      PerShardExecutor)
    assert isinstance(make_executor("cuda", batch_shards=4, device="cpu"),
                      BatchedEllExecutor)
    assert isinstance(make_executor("torch", batch_shards=1, device="cpu"),
                      PerShardExecutor)
    with pytest.raises(ValueError):
        BatchedEllExecutor("numpy", 2, device="cpu")
    with pytest.raises(ValueError):
        make_executor("jnp", device="cpu")
    with pytest.raises(ValueError):
        make_executor("cuda", batch_shards=0, device="cpu")


def test_mesh_not_ported_yet(port_store):
    """The mesh engines at D=2 (numpy emulation, plain torch) run bitwise
    the single-device engines (the name is kept from before the mesh was
    ported; ``tests/test_torch_mesh_sweep.py`` holds the rest)."""
    for backend in ("numpy", "torch"):
        want = _run(port_store, apps.sssp(0), backend=backend)
        got = _run(port_store, apps.sssp(0), backend=backend, mesh=2)
        assert np.array_equal(got.values, want.values), backend
        assert all(sum(i.device_shards) == i.shards_processed
                   for i in got.iterations)


def test_default_device_is_the_card(port_store):
    """Entry points default to CUDA; without a card they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    g = rmat_graph(50, 200, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VSWEngine.from_store(port_store)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VSWEngine.from_graph(g, port_store + "-never")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_executor("cuda", batch_shards=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PerShardExecutor("numpy")


def test_traced_run_is_bitwise_untraced(port_store):
    """Spans cost nothing to results: a traced run equals the untraced one,
    every span closes, and the export is JSON."""
    import json

    from repro_torch.obs import Tracer, trace

    kw = dict(backend="cuda", batch_shards=3, prefetch_depth=2,
              cache_bytes=1 << 20)
    plain = _run(port_store, apps.pagerank(), **kw)
    with trace.tracing(Tracer()) as tr:
        traced = _run(port_store, apps.pagerank(), **kw)
    assert trace.active() is None
    assert np.array_equal(plain.values, traced.values)
    assert tr.open_span_count() == 0
    out = json.loads(json.dumps(tr.export_chrome()))
    names = {e["name"] for e in out["traceEvents"] if e["ph"] == "X"}
    assert {"vsw.run", "vsw.iter", "sweep.plan", "shard.load", "shard.decode",
            "shard.to_device", "exec.dispatch", "store.read",
            "cache.get"} <= names
