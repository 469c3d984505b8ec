"""The engine's spans and step counters (``repro_torch.obs.trace``,
``IterStats``) on the CPU: each host step of an iteration is a span under
its parent, its counter is the span's own clock, and tracing changes no
value.

Runs PageRank and SSSP on the tiny store of ``tests/test_torch_vsw.py``
through the three executors (per shard, batched, and the mesh executor
over two CPU slots), with the ``cuda`` backend's plain versions, on the
host path (the programs without their device forms) and, for the two
single-device executors, on the device path (``-device`` cases), which
stages nothing and copies no accumulator back.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import apps
from repro_torch.core.graph import rmat_graph
from repro_torch.core.vsw import VSWEngine
from repro_torch.obs import trace

#: span -> the parents it may have (innermost enclosing span, one thread)
PARENTS = {
    "vsw.init": {"vsw.run"},
    "sweep.plan": {"vsw.iter"},
    "vsw.pre": {"vsw.iter"},
    "exec.stage": {"vsw.iter", "exec.dispatch"},
    "exec.copy_back": {"exec.dispatch"},
    "vsw.apply": {"vsw.iter"},
    "vsw.activity": {"vsw.run"},
    "vsw.stats": {"vsw.run"},
    "shard.next": {"vsw.iter"},
    "shard.wait": {"shard.next"},
}
#: IterStats counter -> the span it clocks
COUNTERS = {
    "plan_s": "sweep.plan",
    "pre_s": "vsw.pre",
    "apply_s": "vsw.apply",
    "activity_s": "vsw.activity",
    "stage_s": "exec.stage",
    "copy_back_s": "exec.copy_back",
}
EXECUTORS = {
    "per_shard": dict(batch_shards=1),
    "batched": dict(batch_shards=2),
    "mesh": dict(batch_shards=2, mesh=2),
}
PROGRAMS = {"pagerank": (apps.pagerank, 6), "sssp": (lambda: apps.sssp(0), 30)}
#: spans only the host path has
HOST_ONLY = {"exec.stage", "exec.copy_back"}
CASES = ([(p, x, "host") for p in PROGRAMS for x in EXECUTORS]
         + [(p, x, "device") for p in PROGRAMS for x in ("per_shard", "batched")])
IDS = [f"{p}-{x}" + ("-device" if path == "device" else "")
       for p, x, path in CASES]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("spans") / "store"
    g = rmat_graph(1500, 20000, seed=23)
    VSWEngine.from_graph(g, str(root), backend="numpy", device="cpu",
                         num_shards=6, window=256, k=16).close()
    return str(root)


def _run(store, program, executor, path, tracer=None):
    make, iters = PROGRAMS[program]
    prog = make()
    if path == "host":
        prog = dataclasses.replace(prog, pre_device=None, apply_device=None)
    with VSWEngine.from_store(store, device="cpu", backend="cuda",
                              **EXECUTORS[executor]) as eng:
        if tracer is None:
            return eng.run(prog, max_iters=iters)
        with trace.tracing(tracer):
            return eng.run(prog, max_iters=iters)


@pytest.fixture(scope="module")
def runs(store):
    """``(program, executor, path) -> (traced RunResult, its spans,
    untraced RunResult)``; a span is ``(name, start us, end us, parent,
    attrs)``.  The engines run under a short GIL switch interval: a loader
    thread that takes the GIL between a step's clock and its span's stamp
    would otherwise hold the engine up to 5 ms, far past the counters'
    200 us slack, on a loaded host."""
    out = {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for case in CASES:
            tracer = trace.Tracer()
            traced = _run(store, *case, tracer=tracer)
            out[case] = (traced, _spans(tracer), _run(store, *case))
    finally:
        sys.setswitchinterval(interval)
    return out


def _spans(tracer):
    """The engine thread's spans, each with its innermost enclosing one."""
    events = [e for e in tracer.export_chrome()["traceEvents"]
              if e["ph"] == "X"]
    run_tid = next(e["tid"] for e in events if e["name"] == "vsw.run")
    out, stack = [], []
    for e in sorted((e for e in events if e["tid"] == run_tid),
                    key=lambda e: (e["ts"], -e["dur"])):
        a, b = e["ts"], e["ts"] + e["dur"]
        while stack and stack[-1][1] <= a:
            stack.pop()
        parent = stack[-1][0] if stack else None
        out.append((e["name"], a, b, parent, e.get("args", {})))
        stack.append((e["name"], b))
    return out


def _by_iteration(spans):
    """Per iteration, its spans: those inside its ``vsw.iter``, then the
    ``vsw.run`` children up to the next ``vsw.iter``."""
    iters = [s for s in spans if s[0] == "vsw.iter"]
    out = []
    for i, (_, a, b, _, attrs) in enumerate(iters):
        assert attrs["iteration"] == i
        nxt = iters[i + 1][1] if i + 1 < len(iters) else float("inf")
        out.append([s for s in spans if a <= s[1] < nxt and s[0] != "vsw.iter"])
    return out


@pytest.mark.parametrize("program,executor,path", CASES, ids=IDS)
def test_each_span_nests_under_its_parent(runs, program, executor, path):
    result, spans, _ = runs[program, executor, path]
    names = {s[0] for s in spans}
    if path == "host":
        assert set(PARENTS) <= names
    else:
        assert set(PARENTS) - HOST_ONLY <= names
        assert not names & HOST_ONLY
    for name, _, _, parent, _ in spans:
        if name in PARENTS:
            assert parent in PARENTS[name], (name, parent)
    assert sum(s[0] == "vsw.init" for s in spans) == 1
    iters = [s[4] for s in spans if s[0] == "vsw.iter"]
    assert len(iters) == len(result.iterations)
    for attrs, it in zip(iters, result.iterations):
        assert attrs["on_device"] == it.on_device == (path == "device")
        assert attrs["ids_to_host"] == it.ids_to_host


@pytest.mark.parametrize("program,executor,path", CASES, ids=IDS)
def test_one_apply_span_per_processed_shard(runs, program, executor, path):
    result, spans, _ = runs[program, executor, path]
    per_iter = _by_iteration(spans)
    assert len(per_iter) == len(result.iterations)
    for it, group in zip(result.iterations, per_iter):
        applied = [s[4]["shard"] for s in group if s[0] == "vsw.apply"]
        assert len(applied) == it.shards_processed
        assert len(set(applied)) == len(applied)


@pytest.mark.parametrize("program,executor,path", CASES, ids=IDS)
def test_counters_match_their_spans(runs, program, executor, path):
    result, spans, _ = runs[program, executor, path]
    for it, group in zip(result.iterations, _by_iteration(spans)):
        for field, name in COUNTERS.items():
            span_s = sum(b - a for n, a, b, _, _ in group if n == name) / 1e6
            got = getattr(it, field)
            assert got <= span_s + 1e-6, (it.iteration, field)
            assert span_s - got <= max(0.1 * span_s, 200e-6), (
                it.iteration, field, got, span_s)


@pytest.mark.parametrize("program,executor,path", CASES, ids=IDS)
def test_named_parts_fit_in_the_iteration(runs, program, executor, path):
    result, _, plain = runs[program, executor, path]
    for r in (result, plain):
        for it in r.iterations:
            assert it.on_device == (path == "device")
            if path == "host":
                assert it.stage_s + it.copy_back_s <= it.exec_s
            else:
                assert it.stage_s == it.copy_back_s == 0.0
            named = (it.exec_s + it.load_wait_s + it.to_device_s + it.plan_s
                     + it.pre_s + it.apply_s + it.activity_s)
            assert named <= it.time_s


@pytest.mark.parametrize("program,executor,path", CASES, ids=IDS)
def test_tracing_off_gives_the_same_values_and_counts(runs, program,
                                                      executor, path):
    traced, _, plain = runs[program, executor, path]
    assert np.array_equal(plain.values, traced.values)
    assert len(plain.iterations) == len(traced.iterations)
    for a, b in zip(plain.iterations, traced.iterations):
        assert a.shards_processed == b.shards_processed
        assert a.active_count == b.active_count
        assert a.ids_to_host == b.ids_to_host
        assert a.plan_s > 0 and a.pre_s > 0 and a.activity_s > 0
        if path == "device":
            assert a.on_device and a.stage_s == a.copy_back_s == 0.0
            if a.shards_processed:
                assert a.apply_s > 0
        elif a.shards_processed:
            assert a.apply_s > 0 and a.copy_back_s > 0
    if path == "host":
        assert sum(i.stage_s for i in plain.iterations) > 0


def test_timed_clocks_with_tracing_off_and_on():
    with trace.timed("t.off") as t:
        sum(range(1000))
    assert t.s > 0
    with trace.tracing(trace.Tracer()) as tr:
        with trace.timed("t.on", k=1) as t:
            sum(range(1000))
    (ev,) = [e for e in tr.export_chrome()["traceEvents"] if e["ph"] == "X"]
    assert ev["name"] == "t.on" and ev["args"] == {"k": 1}
    assert 0 < t.s <= ev["dur"] / 1e6 + 1e-6
