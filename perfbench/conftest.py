"""Fixtures of the benchmark's CPU tests: a benchmark root whose cells run
the real traffic files and metric readers on tiny graphs."""

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips where torch sees none")


def make_tiny_root(root: Path, scale: int = 10) -> Path:
    """``root`` with this repository's ``BENCHMARK.json``, its traffic
    files, programs, generators and metric readers, and each configuration
    cut to ``2**scale`` vertices and a small engine (4 shards, W=256,
    K=16)."""
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for sub in ("metrics", "traffic", "programs", "generators"):
        shutil.copytree(REPO / "perfbench" / sub, root / "perfbench" / sub)
    (root / "perfbench" / "configs").mkdir(parents=True)
    for entry in spec["configs"]:
        config = json.loads((REPO / entry["file"]).read_text())
        config["scale"] = scale
        config["engine"].update(num_shards=4, window=256, k=16, tr=2,
                                cache_bytes=1 << 20)
        (root / entry["file"]).write_text(json.dumps(config))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path / "bench")
