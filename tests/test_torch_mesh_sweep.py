"""The port's mesh path (DESIGN.md §10): one host read, D device slices.

The counterpart of every test in ``tests/test_mesh_sweep.py``, held to
the reference where both packages run:

1. **Partition algebra** — ``equal_device_bounds``, ``MeshPartition`` and
   both device-graph builders are bitwise the reference's on the same
   store, and keep the reference's properties.
2. **Bitwise sweeps** — an engine or service booted with ``mesh=D`` (D in
   1, 2, 8, on ``device="cpu"``: every slot the CPU) gives results bitwise
   equal to the port's single-device run of the same backend, for BFS /
   SSSP / PPR / WCC, through retirement and backfill, ``apply_updates``
   between sweeps and a seeded stress.  The ``numpy`` mesh emulation is
   also bitwise the reference's emulation; the ``torch`` and ``cuda``
   backends (the kernels' plain versions here) hold min programs bitwise
   and sums within rtol 1e-4 of the reference's numpy oracle.
3. **Conserved attribution** — per-device shard/dispatch/bytes stats sum
   to the sweep totals.
"""

import numpy as np
import pytest
import torch

from repro.core import apps as ref_apps
from repro.core.distributed import MeshPartition as RefPartition
from repro.core.distributed import build_device_graph as ref_build_device_graph
from repro.core.distributed import \
    build_device_graph_from_store as ref_build_from_store
from repro.core.distributed import equal_device_bounds as ref_bounds
from repro.core.graph import rmat_graph as ref_rmat_graph
from repro.core.graph import uniform_graph as ref_uniform_graph
from repro.core.storage import ShardStore as RefStore
from repro.core.vsw import VSWEngine as RefEngine
from repro.serve import GraphService as RefService
from repro_torch.core import apps
from repro_torch.core.distributed import (
    MeshPartition,
    build_device_graph,
    build_device_graph_from_store,
    device_graph_specs,
    equal_device_bounds,
)
from repro_torch.core.graph import Graph, chain_graph, rmat_graph, uniform_graph
from repro_torch.core.ingest import pack_keys
from repro_torch.core.storage import ShardStore
from repro_torch.core.vsw import VSWEngine
from repro_torch.kernels.spmv_ell import ops as spmv_ops
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.serve import FusedSweep, GraphService, LaneSeed, MeshSweep

MESH_SIZES = (1, 2, 8)
BACKENDS = ("numpy", "torch", "cuda")
STORE = dict(num_shards=6, window=128, k=16)
CASES = [("bfs", 2), ("wcc", 0), ("ppr", 3), ("sssp", 1), ("ppr", 9)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _norm(v):
    return np.nan_to_num(v, posinf=1e30)


def _kw(kw):
    for key, val in STORE.items():
        kw.setdefault(key, val)
    return kw


def _mk_engine(tmp_path, tag, g, **kw):
    return VSWEngine.from_graph(g, str(tmp_path / tag), device="cpu", **_kw(kw))


def _mk_service(tmp_path, tag, g, **kw):
    return GraphService.from_graph(g, str(tmp_path / tag), device="cpu",
                                   **_kw(kw))


def _ref_service(tmp_path, tag, g, **kw):
    return RefService.from_graph(g, str(tmp_path / tag), **_kw(kw))


def _kwargs(prog, source):
    return {} if prog in ("wcc", "pagerank") else {"source": source}


def _against_oracle(got, want, sums, where):
    """Contract (c): min programs bitwise, sums within rtol 1e-4."""
    if sums:
        assert np.allclose(got, want, rtol=1e-4, atol=1e-8), where
    else:
        assert np.array_equal(_norm(got), _norm(want)), where


def _mutated(src, dst, ins, dels):
    """Edge-list semantics of apply_updates: delete ALL copies of the named
    edges, then append inserts."""
    tomb = np.unique(pack_keys(np.asarray(dels[0], np.int64),
                               np.asarray(dels[1], np.int64)))
    keys = pack_keys(src.astype(np.int64), dst.astype(np.int64))
    pos = np.minimum(np.searchsorted(tomb, keys), len(tomb) - 1)
    keep = tomb[pos] != keys
    src = np.concatenate([src[keep], np.asarray(ins[0], np.int32)])
    dst = np.concatenate([dst[keep], np.asarray(ins[1], np.int32)])
    return src.astype(np.int32), dst.astype(np.int32)


# ------------------------------------------------------- partition algebra
def test_equal_device_bounds_cover_and_order():
    for nv in (1, 7, 64, 1000):
        for d in (1, 2, 3, 8):
            got = equal_device_bounds(nv, d)
            want = ref_bounds(nv, d)
            assert got[:2] == want[:2] and np.array_equal(got[2], want[2])
            rows_per_dev, nv_pad, bounds = got
            assert bounds[0] == 0 and bounds[-1] == nv
            assert np.all(np.diff(bounds) >= 0)
            assert rows_per_dev * d == nv_pad >= nv
    with pytest.raises(ValueError):
        equal_device_bounds(10, 0)


def test_mesh_partition_owns_each_shard_once(tmp_path):
    g = ref_rmat_graph(400, 3000, seed=7)
    root = str(tmp_path / "own")
    RefEngine.from_graph(g, root, backend="numpy", **_kw({"num_shards": 7})
                         ).close()
    meta = ShardStore(root).read_meta()
    for d in (1, 2, 3, 8):
        part = MeshPartition.from_meta(meta, d)
        ref = RefPartition.from_meta(RefStore(root).read_meta(), d)
        assert np.array_equal(part.owner, ref.owner) and part.owner.dtype == np.int32
        assert part.owner.min() >= 0 and part.owner.max() < d
        assert np.all(np.diff(part.owner) >= 0)
        ids = list(range(meta.num_shards))
        groups = part.group(ids)
        assert groups == ref.group(ids)
        assert sorted(p for gr in groups for p in gr) == ids
        inter = MeshPartition.interleave(groups)
        assert inter == RefPartition.interleave(groups) and sorted(inter) == ids
        for dd, gr in enumerate(groups):
            assert all(part.device_of(p) == dd for p in gr)
            assert gr == sorted(gr)


def test_mesh_partition_seeded_stress():
    rng = np.random.default_rng(17)
    for _ in range(50):
        n_shards = int(rng.integers(1, 20))
        n_dev = int(rng.integers(1, 9))
        sub = rng.permutation(n_shards)[: int(rng.integers(0, n_shards + 1))]
        sub = sorted(int(p) for p in sub)
        owner = np.sort(rng.integers(0, n_dev, n_shards)).astype(np.int32)
        part = MeshPartition(n_dev=n_dev, num_shards=n_shards, owner=owner)
        ref = RefPartition(n_dev=n_dev, num_shards=n_shards, owner=owner)
        groups = part.group(sub)
        assert len(groups) == n_dev and groups == ref.group(sub)
        assert sorted(p for gr in groups for p in gr) == sub
        inter = MeshPartition.interleave(groups)
        assert inter == RefPartition.interleave(groups) and sorted(inter) == sub


@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
def test_device_graph_builders_agree_with_the_reference(tmp_path, d):
    """Both builders bitwise each other and the reference's, on one store
    (written by the reference) and one graph."""
    rg = ref_uniform_graph(300, 2500, seed=3)
    g = uniform_graph(300, 2500, seed=3)
    assert np.array_equal(g.src, rg.src) and np.array_equal(g.dst, rg.dst)
    root = str(tmp_path / "dg")
    RefEngine.from_graph(rg, root, backend="numpy", num_shards=5, window=256,
                         k=16).close()
    built = [build_device_graph(g, d, window=256, k=16, tr=8),
             build_device_graph_from_store(ShardStore(root), d)]
    want = ref_build_device_graph(rg, d, window=256, k=16, tr=8)
    assert all(_same_device_graph(dg, ref_build_from_store(RefStore(root), d))
               for dg in built)
    assert all(_same_device_graph(dg, want) for dg in built)


def _same_device_graph(a, b):
    arrays = ("ell_idx", "ell_valid", "seg", "out_deg")
    scalars = ("num_vertices", "num_vertices_real", "rows_per_dev", "n_dev",
               "window", "k", "tr", "n_ell_per_dev")
    return (all(np.array_equal(getattr(a, f), getattr(b, f))
                and getattr(a, f).dtype == getattr(b, f).dtype for f in arrays)
            and all(getattr(a, f) == getattr(b, f) for f in scalars))


@pytest.mark.parametrize("sentinel", [False, True])
def test_device_graph_specs_match_the_reference(sentinel):
    """Meta-device stand-ins of the reference's ShapeDtypeStructs."""
    from repro.core.distributed import device_graph_specs as ref_specs

    for nv, ne, d, k in ((1000, 9000, 4, 32), (1 << 20, 1 << 24, 8, 128)):
        got = device_graph_specs(nv, ne, d, k=k, tr=8, sentinel=sentinel)
        want = ref_specs(nv, ne, d, k=k, tr=8, sentinel=sentinel)
        assert sorted(got) == sorted(want)
        for name, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[name].shape), name
            assert str(t.dtype).split(".")[-1] == str(want[name].dtype), name


# ------------------------------------------------------------ device meshes
def test_mesh_device_errors_uniform():
    """Too few cards: the uniform error; on the CPU any count."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    need = have + 1
    with pytest.raises(RuntimeError,
                       match=f"needs {need} devices, have {have}") as e:
        make_host_mesh((need,), ("dev",), device="cuda")
    assert "device='cpu'" in str(e.value)
    with pytest.raises(RuntimeError, match=f"needs 256 devices, have {have}"):
        make_production_mesh(device="cuda")
    if have == 0:
        with pytest.raises(RuntimeError, match="needs 2 devices, have 0"):
            make_host_mesh((2,), ("dev",))  # the default device is the card
    m = make_host_mesh((4, 4), device="cpu")
    assert m.devices.shape == (4, 4) and m.axis_names == ("data", "model")
    assert all(d == torch.device("cpu") for d in m.device_list())
    assert make_production_mesh(multi_pod=True, device="cpu").size == 512
    with pytest.raises(ValueError):
        make_host_mesh((2, 2), ("dev",), device="cpu")


# --------------------------------------------------------------- mesh steps
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_mesh_steps_bitwise_single_device(tmp_path, backend):
    """The ops' mesh steps give each shard the single-device lane update's
    accumulator bitwise, and count the slots off their identity."""
    g = rmat_graph(400, 5000, seed=9)
    eng = _mk_engine(tmp_path, "ops", g, backend=backend, num_shards=6)
    ells = [eng.pipeline.load(p).ell for p in range(eng.meta.num_shards)]
    rng = np.random.default_rng(4)
    msgs = [rng.random((3, 400), dtype=np.float32),
            np.where(rng.random((2, 400)) < 0.5, np.inf,
                     rng.random((2, 400))).astype(np.float32)]
    combines = ["sum", "min"]
    want = spmv_ops.ell_update_lanes_multi(ells, msgs, combines)
    for D in (1, 2, 3):
        mesh = make_host_mesh((D,), ("dev",), device="cpu")
        dev_ells = [[e for i, e in enumerate(ells) if i % D == d]
                    for d in range(D)]
        got_r, touched = spmv_ops.ell_update_lanes_mesh_ragged(
            dev_ells, msgs, combines, mesh=mesh, backend=backend)
        got_m, touched_g = spmv_ops.ell_update_lanes_mesh_multi(
            dev_ells, msgs, combines, mesh=mesh, backend=backend)
        for gi in range(2):
            for d in range(D):
                for k, acc in enumerate(want[gi][d::D]):
                    assert np.array_equal(got_r[gi][d][k], acc)
                    assert np.array_equal(got_m[gi][d][k], acc)
        off = [sum(int((a != (0.0 if c == "sum" else np.inf)).sum())
                   for a in accs) for accs, c in zip(want, combines)]
        assert touched_g == off and touched == sum(off)
    empty, t = spmv_ops.ell_update_lanes_mesh_ragged(
        [[], []], msgs, combines, mesh=make_host_mesh((2,), ("dev",),
                                                      device="cpu"))
    assert empty == [[[], []], [[], []]] and t == 0
    eng.close()


@pytest.mark.parametrize("combine", ["sum", "min", "max"])
def test_ell_update_arrays_matches_the_reference(combine):
    """The superstep's global-index update against the reference's (jnp):
    min/max bitwise, sums within rtol 1e-5; the sentinel layout (no
    validity plane) bitwise the masked one."""
    import jax.numpy as jnp
    from repro.kernels.spmv_ell import ops as ref_ops

    g = rmat_graph(700, 9000, seed=11)
    dg = build_device_graph(g, 2, window=1 << 12, k=32, tr=8)
    rows, ne = dg.rows_per_dev, dg.n_ell_per_dev
    msgs = np.random.default_rng(2).random(dg.num_vertices).astype(np.float32)
    for d in range(2):
        blk = slice(d * ne, (d + 1) * ne)
        idx, valid, seg = dg.ell_idx[blk], dg.ell_valid[blk], dg.seg[blk]
        t = torch.from_numpy
        got = spmv_ops.ell_update_arrays(t(idx), t(valid), t(seg), t(msgs),
                                         rows, combine).numpy()
        want = np.asarray(ref_ops.ell_update_arrays(
            jnp.asarray(idx), jnp.asarray(valid), jnp.asarray(seg),
            jnp.asarray(msgs), rows, combine))
        if combine == "sum":
            assert np.allclose(got, want, rtol=1e-5, atol=1e-6)
        else:
            assert np.array_equal(got, want)
        sent = spmv_ops.ell_update_arrays(
            t(np.where(valid, idx, dg.num_vertices)), None, t(seg), t(msgs),
            rows, combine).numpy()
        assert np.array_equal(sent, got)


# ------------------------------------------------------------ engine sweeps
@pytest.mark.parametrize("backend", BACKENDS)
def test_engine_mesh_bitwise_and_conserved(tmp_path, backend):
    rg = ref_uniform_graph(500, 4000, seed=0)
    g = uniform_graph(500, 4000, seed=0)
    common = dict(backend=backend, batch_shards=2)
    solo = _mk_engine(tmp_path, "solo", g, num_shards=8, **common)
    oracle = RefEngine.from_graph(rg, str(tmp_path / "oracle"), num_shards=8,
                                  window=128, k=16, backend="numpy")
    progs = (("pagerank", 0), ("bfs", 0), ("sssp", 0), ("wcc", 0))
    wants = {p: oracle.run(ref_apps.get_program(p, **_kwargs(p, s)),
                           max_iters=20).values for p, s in progs}
    solos = {p: solo.run(apps.get_program(p, **_kwargs(p, s)),
                         max_iters=20).values for p, s in progs}
    for D in MESH_SIZES:
        meshy = _mk_engine(tmp_path, f"m{D}", g, num_shards=8, mesh=D, **common)
        ref_mesh = (RefEngine.from_store(str(tmp_path / f"m{D}"),
                                         backend="numpy", mesh=D)
                    if backend == "numpy" else None)
        for prog, s in progs:
            r = meshy.run(apps.get_program(prog, **_kwargs(prog, s)),
                          max_iters=20)
            assert np.array_equal(r.values, solos[prog]), (D, prog)
            _against_oracle(r.values, wants[prog], prog == "pagerank",
                            (backend, D, prog))
            if ref_mesh is not None:  # the reference's emulation
                want = ref_mesh.run(
                    ref_apps.get_program(prog, **_kwargs(prog, s)),
                    max_iters=20)
                assert np.array_equal(r.values, want.values), (D, prog)
                assert [i.device_shards for i in r.iterations] == \
                    [i.device_shards for i in want.iterations]
            for it in r.iterations:
                assert len(it.device_shards) == D
                assert sum(it.device_shards) == it.shards_processed
                assert abs(sum(it.device_bytes) - it.bytes_read) < 1e-6
                assert len(it.device_dispatches) == D
                busy = sum(1 for n in it.device_shards if n)
                assert it.dispatches <= sum(it.device_dispatches) \
                    <= busy * it.dispatches
        if ref_mesh is not None:
            ref_mesh.close()
        meshy.close()
    solo.close()
    oracle.close()


def test_mesh_plans_prune_idle_devices(tmp_path):
    """Selective plans leave devices whose destination intervals are all
    inactive with EMPTY groups — no host read for them."""
    g = chain_graph(256)
    eng = _mk_engine(tmp_path, "prune", g, num_shards=8, backend="numpy",
                     mesh=4, threshold=1.1, exact_selective=True)
    plan = eng.scheduler.plan(np.asarray([0], dtype=np.int64))
    assert plan.device_shards is not None and len(plan.device_shards) == 4
    assert all(len(gr) == 0 for gr in plan.device_shards[1:])
    assert sorted(p for gr in plan.device_shards for p in gr) \
        == sorted(plan.shards)
    solo = _mk_engine(tmp_path, "prune1", g, num_shards=8, backend="numpy",
                      threshold=1.1, exact_selective=True)
    assert solo.scheduler.plan(np.asarray([0])).device_shards is None
    eng.close()
    solo.close()


def test_mesh_engine_mesh_object_and_device_checks(tmp_path):
    g = rmat_graph(200, 1500, seed=5)
    mesh = make_host_mesh((3,), ("dev",), device="cpu")
    with _mk_engine(tmp_path, "obj", g, backend="torch", mesh=mesh) as eng:
        assert eng.mesh is mesh and eng.partition.n_dev == 3
        r = eng.run(apps.sssp(0), max_iters=8)
    with _mk_engine(tmp_path, "one", g, backend="torch") as solo:
        assert np.array_equal(_norm(r.values),
                              _norm(solo.run(apps.sssp(0), max_iters=8).values))
    with _mk_engine(tmp_path, "emu", g, backend="numpy", mesh=3) as emu:
        assert emu.mesh is None and emu.partition.n_dev == 3


# ------------------------------------------------------------ serving sweeps
@pytest.mark.parametrize("backend", BACKENDS)
def test_service_mesh_bitwise(tmp_path, backend):
    rg = ref_rmat_graph(300, 3500, seed=63)
    g = rmat_graph(300, 3500, seed=63)
    common = dict(backend=backend, max_lanes=8, max_groups=2, batch_shards=2)
    solo = _mk_service(tmp_path, "svsolo", g, **common)
    refs = {c: solo.query(*c, max_iters=12).values for c in CASES}
    solo.close()
    oracle = _ref_service(tmp_path, "oracle", rg, backend="numpy", max_lanes=8,
                          max_groups=2)
    wants = {c: oracle.query(*c, max_iters=12).values for c in CASES}
    oracle.close()
    for D in MESH_SIZES:
        svc = _mk_service(tmp_path, f"svm{D}", g, mesh=D, **common)
        with svc.submit_batch():
            futs = [svc.submit(p, s, max_iters=12) for p, s in CASES]
        for c, f in zip(CASES, futs):
            qr = f.result(timeout=240)
            assert np.array_equal(_norm(qr.values), _norm(refs[c])), (D, c)
            _against_oracle(qr.values, wants[c], c[0] == "ppr", (D, c))
            if backend == "numpy":  # the reference's numpy emulation
                assert np.array_equal(_norm(qr.values), _norm(wants[c]))
        assert svc.stats()["mesh_devices"] == D
        svc.close()
        assert svc.metrics_snapshot()["conservation_violations"] == []


@pytest.mark.parametrize("backend", BACKENDS)
def test_mesh_sweep_retirement_backfill_bitwise(tmp_path, backend):
    """Chain BFS sources converge at wildly different iterations; every
    result still equals the single-device solo run."""
    g = chain_graph(64)
    cases = [("bfs", 60), ("ppr", 0), ("bfs", 55), ("ppr", 1),
             ("bfs", 40), ("ppr", 2), ("bfs", 0)]
    common = dict(num_shards=4, backend=backend, max_lanes=3, max_groups=2)
    solo = _mk_service(tmp_path, "bfsolo", g, **common)
    refs = {(p, s): solo.query(p, s, max_iters=200 if p == "bfs" else 6).values
            for p, s in cases}
    solo.close()
    for D in (2, 8):
        svc = _mk_service(tmp_path, f"bf{D}", g, mesh=D, **common)
        with svc.submit_batch():
            futs = [svc.submit(p, s, max_iters=200 if p == "bfs" else 6)
                    for p, s in cases]
        for (p, s), f in zip(cases, futs):
            qr = f.result(timeout=240)
            assert np.array_equal(_norm(qr.values), _norm(refs[(p, s)])), \
                (D, p, s)
        svc.close()


@pytest.mark.parametrize("backend,ragged", [("numpy", True), ("cuda", True),
                                            ("cuda", False)])
def test_mesh_sweep_stats_conserved(tmp_path, backend, ragged):
    g = rmat_graph(300, 3500, seed=63)
    eng = _mk_engine(tmp_path, "cons", g, backend=backend, mesh=4,
                     batch_shards=2)
    sweep = MeshSweep(eng, ragged=ragged)
    seeds = [
        [LaneSeed(source=s, max_iters=12,
                  program=apps.get_lane_program("bfs")) for s in (0, 5, 9)],
        [LaneSeed(source=3, max_iters=6,
                  program=apps.get_lane_program("ppr"))],
    ]
    res = sweep.run(seeds)
    assert len(res) == 4 and sweep.iter_stats
    for it in sweep.iter_stats:
        assert len(it.device_shards) == 4
        assert sum(it.device_shards) == it.shards_processed
        assert abs(sum(it.device_bytes) - it.bytes_read) < 1e-6
        assert all(d <= it.groups * it.shards_processed
                   for d in it.device_dispatches)
        # a slot holding shards books one dispatch a flush (or G)
        assert it.dispatches <= sum(it.device_dispatches)
    total_bytes = sum(it.bytes_read for it in sweep.iter_stats)
    assert abs(sum(r.bytes_read for r in res) - total_bytes) < 1e-6
    eng.close()


def test_mesh_sweep_rejects_plain_engine(tmp_path):
    g = chain_graph(32)
    eng = _mk_engine(tmp_path, "plain", g, num_shards=2, backend="numpy")
    with pytest.raises(ValueError, match="mesh="):
        MeshSweep(eng)
    assert isinstance(FusedSweep(eng), FusedSweep)  # plain path unaffected
    eng.close()


@pytest.mark.parametrize("backend", ["numpy", "cuda"])
def test_mesh_apply_updates_between_sweeps(tmp_path, backend):
    """Live edge mutations between mesh sweeps: post-publish queries equal
    a fresh single-device service on the mutated graph, and (numpy) the
    reference's; dirty shards come from the pipeline's overlay path."""
    rng = np.random.default_rng(29)
    num_v, num_e = 250, 2200
    g = rmat_graph(num_v, num_e, seed=66)
    common = dict(num_shards=5, backend=backend, max_lanes=4,
                  session_entries=0)
    svc = _mk_service(tmp_path, "upd", g, max_groups=2, mesh=4,
                      device_resident=True, **common)
    cases = [("bfs", 3), ("wcc", 0), ("ppr", 7), ("sssp", 11)]
    pre = {c: svc.query(*c, max_iters=15) for c in cases}
    take = rng.choice(num_e, 200, replace=False)
    dels = (g.src[take], g.dst[take])
    ins = (rng.integers(0, num_v, 150).astype(np.int32),
           rng.integers(0, num_v, 150).astype(np.int32))
    upd = svc.apply_updates(inserts=ins, deletes=dels).result(timeout=240)
    assert upd.graph_version == 1
    post = {c: svc.query(*c, max_iters=15) for c in cases}
    svc.close()

    mg = Graph(num_v, *_mutated(g.src, g.dst, ins, dels))
    fresh = {0: _mk_service(tmp_path, "f0", g, **common),
             1: _mk_service(tmp_path, "f1", mg, **common)}
    for c in cases:
        for v, got in ((0, pre[c]), (1, post[c])):
            want = fresh[v].query(*c, max_iters=15).values
            assert np.array_equal(_norm(got.values), _norm(want)), (v, c)
    for s in fresh.values():
        s.close()
    if backend == "numpy":
        ref = _ref_service(tmp_path, "r1", Graph(num_v, mg.src, mg.dst),
                           backend="numpy", num_shards=5, max_lanes=4,
                           session_entries=0)
        for c in cases:
            assert np.array_equal(_norm(post[c].values),
                                  _norm(ref.query(*c, max_iters=15).values))
        ref.close()


@pytest.mark.parametrize("backend", ["numpy", "cuda"])
def test_mesh_seeded_property_stress(tmp_path, backend):
    """Random graphs x random mesh sizes x all four lane programs, mesh vs
    solo, every time bitwise."""
    rng = np.random.default_rng(41)
    for trial in range(3):
        n = int(rng.integers(60, 400))
        m = int(rng.integers(2 * n, 8 * n))
        g = rmat_graph(n, m, seed=int(rng.integers(1 << 30)))
        D = int(rng.choice([2, 3, 5, 8]))
        shards = int(rng.integers(2, 9))
        cases = [(p, int(rng.integers(0, n)))
                 for p in ("bfs", "sssp", "ppr", "wcc")]
        common = dict(num_shards=shards, backend=backend, max_lanes=4,
                      max_groups=2, batch_shards=int(rng.integers(1, 4)))
        solo = _mk_service(tmp_path, f"st{trial}s", g, **common)
        refs = {c: solo.query(*c, max_iters=10).values for c in cases}
        solo.close()
        svc = _mk_service(tmp_path, f"st{trial}m", g, mesh=D, **common)
        with svc.submit_batch():
            futs = [svc.submit(p, s, max_iters=10) for p, s in cases]
        for c, f in zip(cases, futs):
            assert np.array_equal(_norm(f.result(timeout=240).values),
                                  _norm(refs[c])), (trial, D, c)
        svc.close()
