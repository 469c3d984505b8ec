"""The port stands alone: it imports neither jax nor the reference package,
and it builds nothing when imported."""

import os
import re
import subprocess
import sys
from pathlib import Path

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"

_BLOCKED_IMPORT = """
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import repro_torch
import repro_torch.core
import repro_torch.core.vsw
import repro_torch.kernels.build
import repro_torch.kernels.spmv_ell.ops
import repro_torch.kernels.spmv_ell.ref
import repro_torch.obs
import repro_torch.obs.metrics
import repro_torch.serve
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
import torch
from repro_torch.core import VSWEngine, apps, rmat_graph
import tempfile
with tempfile.TemporaryDirectory() as d:
    g = rmat_graph(200, 1500, seed=1)
    with VSWEngine.from_graph(g, d, num_shards=2, window=64, k=8,
                              device="cpu") as eng:
        r = eng.run(apps.pagerank(), max_iters=3)
    assert r.values.shape == (200,)
    if not torch.cuda.is_available():
        try:
            VSWEngine.from_store(d)
        except RuntimeError as e:
            assert "no CUDA device" in str(e)
        else:
            raise AssertionError("default device ran without a card")
from repro_torch.serve import GraphService
with tempfile.TemporaryDirectory() as d:
    g = rmat_graph(200, 1500, seed=2)
    with GraphService.from_graph(g, d, num_shards=2, window=64, k=8,
                                 backend="cuda", device="cpu",
                                 max_lanes=2) as svc:
        with svc.submit_batch():
            futs = [svc.submit(p, 3, max_iters=4) for p in ("bfs", "ppr")]
        assert all(f.result(timeout=120).values.shape == (200,) for f in futs)
        assert svc.metrics_snapshot()["conservation_violations"] == []
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("isolated ok")
"""


def test_import_and_run_with_jax_and_reference_blocked(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(PORT.parent)
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "isolated ok" in out.stdout
    assert not (tmp_path / "build").exists()


def test_sources_never_name_jax_or_the_reference_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)
    files = sorted(PORT.rglob("*.py"))
    assert len(files) >= 21
    for f in files:
        assert not pat.search(f.read_text()), f
