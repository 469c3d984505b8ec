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
import repro_torch.models.model
import repro_torch.models.moe
import repro_torch.models.ssm
import repro_torch.launch.serve
import repro_torch.kernels.flash_attention.ops
import repro_torch.kernels.flash_attention.kernel
import repro_torch.kernels.bloom.ops
import repro_torch.kernels.bloom.kernel
import repro_torch.kernels.bloom.ref
import repro_torch.core.ingest
import repro_torch.core.baselines
import repro_torch.core.baselines.engines
import repro_torch.core.baselines.io_model
import repro_torch.delta
import repro_torch.delta.edgelog
import repro_torch.delta.overlay
import repro_torch.delta.recompact
import repro_torch.delta.recovery
import repro_torch.checkpoint
import repro_torch.checkpoint.warm_state
import repro_torch.core.distributed
import repro_torch.launch.mesh
import repro_torch.optim.adamw
import repro_torch.optim.compression
import repro_torch.data.tokens
import repro_torch.checkpoint.checkpointer
import repro_torch.distributed.fault_tolerance
import repro_torch.train.step
import repro_torch.train.loop
import repro_torch.launch.train
import repro_torch.configs.graphmp
import repro_torch.roofline.hw
import repro_torch.roofline.analysis
import repro_torch.roofline.report
import repro_torch.launch.dryrun
import repro_torch.distributed.sharding
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
    with VSWEngine.from_store(d, device="cpu", mesh=2) as eng:
        assert eng.run(apps.pagerank(), max_iters=3).values.shape == (200,)
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
from repro_torch import configs
from repro_torch.config import smoke_config
from repro_torch.distributed.sharding import LOCAL_CTX
from repro_torch.models import model as M
cfg = smoke_config(configs.get_config("qwen2.5-3b"))
params = M.init_params(0, cfg, device="cpu")
tokens = torch.arange(10).reshape(2, 5) % cfg.vocab_size
logits, caches = M.prefill(params, {"tokens": tokens}, cfg, LOCAL_CTX)
caches = M.pad_caches(caches, cfg, max_seq=6)
logits, caches = M.decode_step(params, logits.argmax(-1)[:, None], caches, 5, cfg,
                               LOCAL_CTX)
assert logits.shape == (2, cfg.vocab_size) and torch.isfinite(logits.float()).all()
for arch in ("moonshot-v1-16b-a3b", "xlstm-350m"):  # one MoE, one SSM prefill
    fam = smoke_config(configs.get_config(arch))
    logits, caches = M.prefill(M.init_params(0, fam, device="cpu"), {"tokens": tokens},
                               fam, LOCAL_CTX)
    assert logits.shape == (2, fam.vocab_size) and torch.isfinite(logits.float()).all()
if not torch.cuda.is_available():
    try:
        M.init_params(0, cfg)
    except RuntimeError as e:
        assert "no CUDA device" in str(e)
    else:
        raise AssertionError("default device ran without a card")
import numpy as np
from repro_torch.core.bloom import BloomFilter32
from repro_torch.kernels.bloom import ops as bloom_ops
from repro_torch.kernels.flash_attention.kernel import flash_decode
from repro_torch.kernels.spmv_ell import ops as spmv_ops
f = BloomFilter32.build(np.arange(0, 2000, 3))
ids = np.arange(50, dtype=np.int32)
assert np.array_equal(bloom_ops.contains(f, ids, device="cpu"), f.contains(ids))
assert bloom_ops.any_active_shards([f, f], ids, device="cpu").tolist() == [True, True]
if not torch.cuda.is_available():
    try:
        bloom_ops.contains(f, ids)
    except RuntimeError as e:
        assert "no CUDA device" in str(e)
    else:
        raise AssertionError("default device ran without a card")
q, k = torch.randn(4, 8, 64), torch.randn(4, 33, 64)
out = flash_decode(q, k, k, torch.ones(4, 33, dtype=torch.bool))
assert out.shape == (4, 8, 64) and torch.isfinite(out).all()
from repro_torch.core import csr_to_ell, ell_to_device, preprocess
g = rmat_graph(200, 1500, seed=3)
d = ell_to_device(csr_to_ell(preprocess(g, num_shards=1)[1][0], 200, window=64,
                             k=8, tr=8), "cpu")
m = torch.rand(d.num_windows * d.window)
assert torch.equal(spmv_ops.ell_update(d, m, "min", variant="sentinel"),
                   spmv_ops.ell_update(d, m, "min"))
import os
from repro_torch.core.baselines import ESGEngine, prepare_baseline_store
from repro_torch.core.ingest import write_edge_file
from repro_torch.delta import EdgeLog, Recompactor
with tempfile.TemporaryDirectory() as d:
    g = rmat_graph(200, 1500, seed=4)
    write_edge_file(os.path.join(d, "e.bin"), g.src, g.dst)
    with GraphService.from_edge_file(os.path.join(d, "e.bin"), os.path.join(d, "s"),
                                     num_shards=2, window=64, k=8, backend="cuda",
                                     device="cpu", device_resident=True) as svc:
        svc.apply_updates(inserts=([1, 2], [3, 4])).result(timeout=120)
        assert svc.query("bfs", 1, max_iters=4).graph_version == 1
        svc.compact()
        svc.save_warm_state(os.path.join(d, "warm"))
    with GraphService.from_store(os.path.join(d, "s"), device="cpu",
                                 warm_state=os.path.join(d, "warm")) as svc:
        assert svc.warm_restore_report["valid"]
    store = prepare_baseline_store(g, os.path.join(d, "b"), num_shards=2)
    assert ESGEngine(store).run(apps.pagerank(), max_iters=2).values.shape == (200,)
from repro_torch.data.tokens import DataConfig
from repro_torch.optim import adamw
from repro_torch.train.loop import LoopConfig, train
with tempfile.TemporaryDirectory() as d:
    res = train(cfg, DataConfig(seq_len=8, global_batch=2, vocab_size=cfg.vocab_size,
                                motif_len=4),
                LoopConfig(total_steps=2, checkpoint_every=1, log_every=0),
                adamw.AdamWConfig(), checkpoint_dir=d, device="cpu")
    assert res.final_step == 2 and sorted(os.listdir(d))[-1] == "step_00000002"
if not torch.cuda.is_available():
    try:
        train(cfg, DataConfig(seq_len=8, global_batch=2, vocab_size=cfg.vocab_size),
              LoopConfig(total_steps=1), adamw.AdamWConfig())
    except RuntimeError as e:
        assert "no CUDA device" in str(e)
    else:
        raise AssertionError("default device ran without a card")
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
