"""Kill-during-commit crash-recovery matrix of the port, across packages.

For every named injection point in ``repro_torch.delta.recovery.
CRASH_POINTS``, a subprocess runs a deterministic publish/publish/compact
script against a copy of a pristine store and SIGKILLs itself at that
point — a real crash: no ``finally`` blocks, no atexit.  Two drivers run
the SAME scenario: the port's (this file's ``__main__`` block, which
imports only ``repro_torch``) and the reference's ``tests/crash_driver.py``,
run unchanged.  Then:

- the port recovers its own crashed store BITWISE to one of the
  per-version oracles (a from-scratch build of the edge list at version 0,
  1 or 2), the one the protocol's commit points decide; no protocol debris
  survives; recovery is idempotent; and the recovered store is usable
  (finishing the script converges to the never-crashed final state);
- the port recovers the reference's crashed store the same way, and the
  reference recovers the port's (ROADMAP North star (a)).

Usage of the driver:  python tests/test_torch_crash_recovery.py <root> <point|none>
"""

import os
import signal
import sys

import numpy as np

N_VERTICES = 300
N_EDGES = 2500
N_SHARDS = 4
SEED = 7


def base_graph():
    from repro_torch.core.graph import uniform_graph

    return uniform_graph(N_VERTICES, N_EDGES, seed=SEED)


def batches(g):
    """Two deterministic mutation batches (inserts + deletes of existing
    edges), each published separately: versions 1 and 2."""
    rng = np.random.default_rng(42)
    out = []
    for _ in range(2):
        i_src = rng.integers(0, N_VERTICES, 30)
        i_dst = rng.integers(0, N_VERTICES, 30)
        take = rng.choice(g.num_edges, 10, replace=False)
        out.append(((i_src, i_dst), (g.src[take], g.dst[take])))
    return out


def main(root: str, point: str) -> int:
    """The port's driver: the script, SIGKILLed at ``point``."""
    from repro_torch.core.storage import ShardStore
    from repro_torch.delta import EdgeLog, Recompactor, set_crash_hook

    if point != "none":

        def hook(name: str) -> None:
            if name == point:
                os.kill(os.getpid(), signal.SIGKILL)

        set_crash_hook(hook)

    store = ShardStore(root)
    g = base_graph()
    log = EdgeLog(store)
    for ins, dels in batches(g):
        log.append(inserts=ins, deletes=dels)
        log.publish()
    Recompactor(store, min_runs=1).compact()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))

# ---------------------------------------------------------------- the tests
import shutil  # noqa: E402
import subprocess  # noqa: E402

import pytest  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import crash_driver  # noqa: E402  (the reference's driver, run unchanged)
from test_torch_delta import (  # noqa: E402
    K,
    TR,
    WINDOW,
    _apply_batch_oracle,
    _assert_logical_equal,
)

from repro.core.storage import ShardStore as RefStore  # noqa: E402
from repro_torch.core.graph import Graph  # noqa: E402
from repro_torch.core.sharding import preprocess  # noqa: E402
from repro_torch.core.storage import (  # noqa: E402
    DELTA_JOURNAL_PREFIX,
    DELTA_RUN_PREFIX,
    DELTA_STAGE_DIR,
    ShardStore,
)
from repro_torch.delta import CRASH_POINTS, EdgeLog, Recompactor  # noqa: E402

_SRC = os.path.join(os.path.dirname(HERE), "src")

#: the version a store killed at each point must recover to: points
#: strictly before a COMMIT roll back, points at or after it roll forward
EXPECTED_VERSION = {
    "publish.first_run": 0,
    "publish.runs_written": 0,
    "publish.journal_written": 0,
    "publish.committed": 1,
    "publish.meta_written": 1,
    "compact.staged": 2,
    "compact.flipped": 2,
    "compact.csr_renamed": 2,
    "compact.renamed": 2,
    "none": 2,
}
POINTS = list(CRASH_POINTS) + ["none"]


def test_scenario_is_the_reference_drivers():
    import repro.delta

    assert CRASH_POINTS == repro.delta.CRASH_POINTS
    assert (N_VERTICES, N_EDGES, N_SHARDS, SEED) == (
        crash_driver.N_VERTICES, crash_driver.N_EDGES, crash_driver.N_SHARDS,
        crash_driver.SEED)
    g, rg = base_graph(), crash_driver.base_graph()
    assert np.array_equal(g.src, rg.src) and np.array_equal(g.dst, rg.dst)
    for (a_ins, a_del), (b_ins, b_del) in zip(batches(g), crash_driver.batches(rg)):
        for x, y in zip(a_ins + a_del, b_ins + b_del):
            assert np.array_equal(x, y)


@pytest.fixture(scope="module")
def pristine(tmp_path_factory):
    """One pristine store + the per-version oracle graphs, built once."""
    tmp = tmp_path_factory.mktemp("crash")
    root = os.path.join(str(tmp), "pristine")
    g = base_graph()
    meta, shards = preprocess(g, num_shards=N_SHARDS)
    store = ShardStore(root)
    store.write_meta(meta, ell_params={"window": WINDOW, "k": K, "tr": TR})
    for s in shards:
        store.write_shard(s, num_vertices=meta.num_vertices,
                          window=WINDOW, k=K, tr=TR)
    oracles = [g]
    src, dst = g.src, g.dst
    for ins, dels in batches(g):
        src, dst = _apply_batch_oracle(src, dst, (ins, dels))
        oracles.append(Graph(N_VERTICES, src, dst))
    return {"root": root, "meta": meta, "oracles": oracles,
            "tmp": str(tmp), "port_crashed": {}}


def _run_driver(script: str, root: str, point: str) -> int:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [_SRC, env.get("PYTHONPATH")]))
    proc = subprocess.run([sys.executable, script, root, point], env=env,
                          capture_output=True, text=True, timeout=120)
    if proc.returncode not in (0, -9):
        raise AssertionError(
            f"driver died unexpectedly ({proc.returncode}):\n{proc.stderr}")
    assert (proc.returncode == 0) == (point == "none"), (point, proc.returncode)
    return proc.returncode


def _crashed(pristine, tmp_path, point, driver):
    """A store copy the ``driver`` ("pt" or "ref") was killed on at
    ``point``.  The port's crashed stores are made once a point and
    copied: two tests recover each."""
    root = os.path.join(str(tmp_path), "store")
    if driver == "ref":
        shutil.copytree(pristine["root"], root)
        _run_driver(os.path.join(HERE, "crash_driver.py"), root, point)
        return root
    made = pristine["port_crashed"].get(point)
    if made is None:
        made = os.path.join(pristine["tmp"], f"pt_{point}")
        shutil.copytree(pristine["root"], made)
        _run_driver(os.path.abspath(__file__), made, point)
        pristine["port_crashed"][point] = made
    shutil.copytree(made, root)
    return root


def _assert_no_debris(root: str) -> None:
    files = os.listdir(root)
    assert not any(f.startswith(DELTA_JOURNAL_PREFIX) for f in files), files
    stage = os.path.join(root, DELTA_STAGE_DIR)
    assert not (os.path.isdir(stage) and os.listdir(stage))


def _assert_runs_consistent(store) -> None:
    """Every run file on disk is registered, published, and unabsorbed."""
    overlay = store.delta
    version = overlay.version if overlay else 0
    floors = overlay.floors() if overlay else {}
    for f in os.listdir(store.root):
        if not f.startswith(DELTA_RUN_PREFIX):
            continue
        p, seq = (int(x) for x in f[len(DELTA_RUN_PREFIX):-4].split("_"))
        assert seq <= version, f"orphan run past version: {f}"
        assert seq > floors.get(p, 0), f"absorbed run survived: {f}"


def _check_recovered(store_cls, root, pristine, point):
    """Recover with ``store_cls``: the expected version, bitwise its oracle,
    no debris, and idempotent (a second open in either package acts on
    nothing and sees the same state)."""
    meta, oracles = pristine["meta"], pristine["oracles"]
    store = store_cls(root)
    version = store.delta.version if store.delta is not None else 0
    assert version == EXPECTED_VERSION[point], point
    _assert_logical_equal(store, meta, oracles[version])
    _assert_no_debris(root)
    _assert_runs_consistent(store)
    for again_cls in (ShardStore, RefStore):
        again = again_cls(root)
        if again.delta is not None:
            assert not again.delta.last_recovery.acted
    return version


def _finish_script(root, version, pristine):
    """The recovered store is usable: the port finishes the interrupted
    script and the final state equals the never-crashed run's."""
    store = ShardStore(root)
    log = EdgeLog(store)
    for ins, dels in batches(base_graph())[version:]:
        log.append(inserts=ins, deletes=dels)
        log.publish()
    Recompactor(store, min_runs=1).compact()
    _assert_logical_equal(store, pristine["meta"], pristine["oracles"][-1])
    assert not store.delta.dirty_shards()
    _assert_no_debris(root)


@pytest.mark.parametrize("point", POINTS)
def test_kill_matrix_recovers_bitwise(pristine, tmp_path, point):
    root = _crashed(pristine, tmp_path, point, "pt")
    version = _check_recovered(ShardStore, root, pristine, point)
    _finish_script(root, version, pristine)


@pytest.mark.parametrize("point", POINTS)
def test_reference_crash_recovered_by_port(pristine, tmp_path, point):
    """The reference's driver, unchanged, killed at ``point``; the port
    recovers the store bitwise to the same oracle and goes on."""
    root = _crashed(pristine, tmp_path, point, "ref")
    version = _check_recovered(ShardStore, root, pristine, point)
    _finish_script(root, version, pristine)


@pytest.mark.parametrize("point", POINTS)
def test_port_crash_recovered_by_reference(pristine, tmp_path, point):
    """The port's driver killed at ``point``; the reference recovers the
    store bitwise to the oracle."""
    root = _crashed(pristine, tmp_path, point, "pt")
    _check_recovered(RefStore, root, pristine, point)
