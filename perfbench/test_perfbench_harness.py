"""The harness on the CPU at tiny sizes: cells found by name, the
comparison failing its faults and its controls, the card and import
checks of ``run.py``, and the form of ``BENCHMARK.json``."""

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.conftest import REPO, make_tiny_root

CELLS = ["kron21-pagerank", "urand21-pagerank"]
SEED = 2**31 + 977


def run(root, cell, trace=False, seconds=0.2, control=False):
    return harness.run_cell(root, cell, SEED, seconds, trace,
                            t_start=time.perf_counter(), device="cpu",
                            control=control)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_runs_correct_with_its_metrics(tiny_root, cell):
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    out = run(tiny_root, cell)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    want = {m["name"] for m in spec["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == want and "setup_s" in want
    assert list(out)[-1] == "compared"
    traced = run(tiny_root, cell, trace=True)
    # on the CPU the readers of the device trace find nothing to read
    per_layer = {m["name"] for m in spec["per_layer"]
                 if cell in m.get("workloads", [cell])}
    assert set(traced["metrics"]) == {
        m for m in per_layer if "roofline" not in m and "idle" not in m}
    assert traced["device"]["busy_s"] == 0.0
    assert traced["correct"]


def test_files_and_entries_alone_add_a_cell(tiny_root):
    """A configuration, a traffic mix and a metric added as new files and
    entries are found and run: no file of the harness changes."""
    bench = tiny_root / "perfbench"
    cfg = json.loads((bench / "configs" / "urand21-resident.json").read_text())
    cfg.update(name="urand9-tiny", scale=9, structure_seed=99)
    (bench / "configs" / "urand9-tiny.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "pagerank5.json").write_text(json.dumps(
        {"program": "pagerank", "damping": 0.5, "iterations": 5,
         "limits": {"max_rel_err": 1e-4}}))
    (bench / "metrics" / "requests_n.py").write_text(
        "def read(record):\n    return float(record.requests)\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "urand9-tiny", "source": "test",
                            "file": "perfbench/configs/urand9-tiny.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "urand9-pr5", "config": "urand9-tiny",
                              "traffic": "pagerank5", "chips": 1, "why": "t"})
    for m in spec["end_to_end"]:
        if m["name"] == "iter_ms":
            m["workloads"].append("urand9-pr5")
    spec["per_layer"].append({"name": "requests_n", "unit": "1",
                              "better": "higher", "source": "program_counter",
                              "layer": "host program", "moves": "iter_ms",
                              "workloads": ["urand9-pr5"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = run(tiny_root, "urand9-pr5")
    assert out["correct"] and set(out["metrics"]) == {"iter_ms", "setup_s"}
    traced = run(tiny_root, "urand9-pr5", trace=True)
    assert traced["metrics"]["requests_n"]["value"] == traced["attempted"]
    assert "host_ms.pr" not in traced["metrics"]  # listed for other cells


RING = '''"""Each vertex's out-edges to ``edge_factor`` others, drawn uniform."""
import torch


def edges(config, gen, device):
    n = 1 << config["scale"]
    v = torch.arange(n, device=device).repeat(config["edge_factor"])
    hop = torch.randint(1, n, (v.numel(),), generator=gen, device=device)
    return v, (v + hop) % n
'''

INDEGREE = '''"""In-degree counting, one step; compared exactly with a bincount."""
import numpy as np
import torch

from perfbench import mixes


class Program(mixes.Mix):
    def warm_up(self, engine):
        self.request(engine, 0)

    def request(self, engine, i):
        from repro_torch.core import apps

        r = engine.run(apps.degree_centrality(), max_iters=1)
        return mixes.Answer(0, r.values, r.converged), r

    def compare(self, answers, src, dst, n, control=False):
        want = torch.bincount(dst, minlength=n).cpu().numpy()
        if control:  # half of the edges left out
            half = torch.bincount(dst[: dst.numel() // 2], minlength=n)
            answers = [mixes.Answer(0, half.cpu().numpy(), True)]
        bad = [int(np.count_nonzero(a.values != want)) for a in answers]
        limit = self.limits["mismatches"]
        return [mixes.Compared("mismatches", max(bad), limit,
                               sum(b > limit for b in bad))]
'''


def test_files_and_entries_alone_add_a_program_and_a_generator(tiny_root):
    """A graph generator and a traffic program added as new files, and a
    per-layer split of a quantity that has its reader, are found and run:
    no file of the harness changes."""
    bench = tiny_root / "perfbench"
    (bench / "generators" / "ring.py").write_text(RING)
    (bench / "programs" / "indegree.py").write_text(INDEGREE)
    cfg = json.loads((bench / "configs" / "urand21-resident.json").read_text())
    cfg.update(name="ring9-tiny", generator="ring", scale=9, edge_factor=4)
    (bench / "configs" / "ring9-tiny.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "indegree.json").write_text(json.dumps(
        {"program": "indegree", "limits": {"mismatches": 0}}))
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "ring9-tiny", "source": "test",
                            "file": "perfbench/configs/ring9-tiny.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "ring9-indegree", "config": "ring9-tiny",
                              "traffic": "indegree", "chips": 1, "why": "t"})
    for m in spec["end_to_end"]:
        if m["name"] == "iter_ms":
            m["workloads"].append("ring9-indegree")
    spec["per_layer"].append({"name": "host_ms.indegree", "unit": "ms",
                              "better": "lower", "source": "program_span",
                              "layer": "host program", "moves": "iter_ms",
                              "workloads": ["ring9-indegree"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    assert not (bench / "metrics" / "host_ms.indegree.py").exists()
    out = run(tiny_root, "ring9-indegree", control=True)
    assert out["correct"] and out["compared"]["mismatches"]["value"] == 0
    assert out["control"]["mismatches"] > 0
    assert set(out["metrics"]) == {"iter_ms", "setup_s"}
    traced = run(tiny_root, "ring9-indegree", trace=True)
    assert traced["metrics"]["host_ms.indegree"]["value"] > 0
    assert "host_ms.pr" not in traced["metrics"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_comes_out_not_correct(tiny_root, cell):
    out = run(tiny_root, cell, control=True)
    assert out["correct"]
    limits = {k: v["limit"] for k, v in out["compared"].items()}
    assert any(out["control"][k] > limits[k] for k in limits)


def _unchanged(monkeypatch):
    """A run that returns its state unchanged: no iteration runs."""
    from repro_torch.core import VSWEngine

    orig = VSWEngine._run
    monkeypatch.setattr(VSWEngine, "_run", lambda self, program, max_iters:
                        orig(self, program, max_iters=0))


def _half_batch(monkeypatch):
    """Half of each launch's shards left out: their rows keep the
    identity."""
    from repro_torch.core import executor

    orig = executor.ELL_BACKENDS["cuda"]

    def half(ells, msgs, combine):
        acc = orig(ells, msgs, combine)
        keep = sum(e.v1 - e.v0 for e in ells[: (len(ells) + 1) // 2])
        acc[keep:] = 0.0 if combine == "sum" else float("inf")
        return acc

    monkeypatch.setitem(executor.ELL_BACKENDS, "cuda", half)


def _altered(monkeypatch):
    """One vertex's value altered where the run produces it."""
    from repro_torch.core import VSWEngine

    orig = VSWEngine._run

    def run_(self, program, max_iters):
        r = orig(self, program, max_iters=max_iters)
        v = int(np.flatnonzero(np.isfinite(r.values))[-1])
        r.values[v] = r.values[v] * 1.01 + 1.0
        return r

    monkeypatch.setattr(VSWEngine, "_run", run_)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_comes_out_not_correct(tiny_root, monkeypatch,
                                                   cell, fault):
    fault(monkeypatch)
    out = run(tiny_root, cell, seconds=0.05)
    assert not out["correct"] and out["failed"] >= 1


def _python(code, cwd):
    env = {"PYTHONPATH": "", "PATH": "/usr/bin:/bin:/usr/local/bin"}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    """run.py's imports and a whole traced run, in a process of their
    own: no loaded module's top-level name is jax, jaxlib, flax or repro
    (whole names: repro_torch is the port)."""
    root = make_tiny_root(tmp_path / "bench")
    code = f"""
import runpy, sys, time
sys.argv = ["run.py", "--help"]
mod = runpy.run_path({str(REPO / "perfbench" / "run.py")!r}, run_name="imports")
from perfbench import harness
from pathlib import Path
harness.run_cell(Path({str(root)!r}), "urand21-pagerank", 5, 0.1, True,
                 t_start=time.perf_counter(), device="cpu")
harness.run_cell(Path({str(root)!r}), "kron21-pagerank", 5, 0.1, False,
                 t_start=time.perf_counter(), device="cpu")
print(sorted({{m.split(".")[0] for m in sys.modules}}))
print(harness.forbidden_modules())
"""
    p = _python(code, REPO)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded, bad = p.stdout.strip().splitlines()[-2:]
    assert bad == "[]"
    top = eval(loaded)
    assert "repro_torch" in top and "torch" in top
    assert not {"jax", "jaxlib", "flax", "repro"} & set(top)


def test_run_without_a_card_or_without_the_port_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "kron21-pagerank", "--seed", "1", "--seconds", "1"],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 2 and p.stdout == ""
    assert "CUDA card" in p.stderr
    bare = tmp_path / "bare"
    (bare / "perfbench").mkdir(parents=True)
    for f in (REPO / "perfbench").glob("*.py"):
        (bare / "perfbench" / f.name).write_text(f.read_text())
    (bare / "BENCHMARK.json").write_text((REPO / "BENCHMARK.json").read_text())
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "kron21-pagerank", "--seed", "1", "--seconds", "1"],
                       cwd=bare, capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin:/usr/local/bin"})
    assert p.returncode != 0 and p.stdout == ""


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_is_well_formed():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "perfbench/run.py"]
    assert spec["paths"] == ["perfbench"] and 1 <= spec["run_seconds"] <= 51
    cells = {w["name"]: w for w in spec["workloads"]}
    configs = {c["name"]: c for c in spec["configs"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        cfg = json.loads((REPO / c["file"]).read_text())
        assert set(cfg["reduced"]) == set(c["reduced"])
        assert c["source"] == cfg["source"] and len(c["source"]) <= 200
        assert (REPO / "perfbench" / "generators" / f"{cfg['generator']}.py").exists()
    assert len({c["file"] for c in spec["configs"]}) == len(configs)
    assert {w["config"] for w in cells.values()} == set(configs)
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
        traffic = REPO / "perfbench" / "traffic" / f"{w['traffic']}.json"
        program = json.loads(traffic.read_text())["program"]
        assert (REPO / "perfbench" / "programs" / f"{program}.py").exists()
        reported = {m for m, e in e2e.items()
                    if w["name"] in e.get("workloads", [w["name"]])}
        assert "setup_s" in reported and len(reported) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in per_layer.values())
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in per_layer.values():
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for m in [*e2e.values(), *per_layer.values()]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        # a reader of its own, or of the quantity it splits by cells
        assert any((REPO / "perfbench" / "metrics" / f"{n}.py").exists()
                   for n in (m["name"], m["name"].split(".")[0]))
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline") and m["unit"] == "%"


@pytest.mark.cuda
def test_a_tiny_cell_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = make_tiny_root(tmp_path / "bench", scale=14)
    for cell in CELLS:
        out = harness.run_cell(root, cell, SEED, 1.0, True,
                               t_start=time.perf_counter(), device="cuda")
        assert out["correct"] and out["device"]["busy_s"] > 0
        for name, m in out["metrics"].items():
            if "roofline" in name:
                assert 0 < m["value"] <= 100
