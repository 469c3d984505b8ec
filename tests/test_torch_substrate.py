"""The training substrate of the port against the reference's: AdamW,
gradient compression, token data, the checkpointer (its format crosses
packages both ways), fault tolerance and the training loop, which resumes
the reference's run.  The reference's own tests of ``tests/test_substrate.py``
run here as the port's copies.

Tolerances: compression, data and AdamW's update (the decay test) are
compared bitwise (equal inputs, the same f32 operations in the same
order); the schedules and ``grad_norm`` within rtol 1e-6 (torch's and
XLA's ``cos`` and sums may differ in the last bit); the port's resumed
losses against the reference's run within rtol 1e-3 (bf16 activations in
both; measured 2.5e-5 at most over steps 4-6).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.checkpoint.checkpointer import Checkpointer as RefCheckpointer
from repro.config import smoke_config as ref_smoke_config
from repro.data import tokens as RT
from repro.models import model as RM
from repro.optim import adamw as RA
from repro.optim import compression as RCo
from repro.train import loop as RL
from repro_torch import configs
from repro_torch.checkpoint.checkpointer import Checkpointer, _flatten_with_names
from repro_torch.config import smoke_config
from repro_torch.data.tokens import (DataConfig, PrefetchingLoader, add_frontend_stub,
                                     make_batch)
from repro_torch.distributed import fault_tolerance as FT
from repro_torch.distributed.fault_tolerance import (PreemptionGuard, StragglerMonitor,
                                                     elastic_reshard)
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.launch import train as LT
from repro_torch.models import model as M
from repro_torch.models.params import load_reference_tree, reference_tree
from repro_torch.optim import adamw
from repro_torch.optim.compression import (CompressionConfig, _topk_mask, compress_tree,
                                           init_error_state, wire_bytes_ratio)
from repro_torch.train.loop import LoopConfig, train


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------- optimizer
@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_at_is_the_reference_schedule(schedule):
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=100, schedule=schedule)
    cfg, rcfg = adamw.AdamWConfig(**kw), RA.AdamWConfig(**kw)
    got = [float(adamw.lr_at(cfg, s)) for s in range(0, 121)]
    want = [float(RA.lr_at(rcfg, jnp.asarray(s))) for s in range(0, 121)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="schedule"):
        adamw.lr_at(adamw.AdamWConfig(schedule="step"), 1)


def test_apply_updates_decays_stacked_layer_vectors_as_the_reference():
    """The reference decays leaves of rank >= 2 in its stacked layout, so a
    layer's norm scale ``[G, d]`` is decayed and the final norm ``[d]`` is
    not; the port's per-layer ``[d]`` tensors follow the stacked rank."""
    rng = np.random.default_rng(0)
    tree = {"final_norm": {"scale": rng.standard_normal(8).astype(np.float32)},
            "groups": {"layer_0": {"ln1": {"scale": rng.standard_normal((2, 8))},
                                   "attn": {"wq": {"w": rng.standard_normal((2, 8, 4)),
                                                   "b": rng.standard_normal((2, 4))}}}},
            "embed": {"table": rng.standard_normal((16, 8))}}
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)
    grads = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 1e-3).astype(np.float32), tree)
    kw = dict(lr=1e-2, weight_decay=0.5, warmup_steps=0, schedule="constant")
    rp, rs, rm = RA.apply_updates(tree, grads, RA.init(tree), RA.AdamWConfig(**kw))
    cfg = smoke_config(configs.get_config("qwen2.5-3b"))
    cfg = type(cfg)(**{**cfg.__dict__, "num_layers": 2})
    named = {"final_norm.scale": torch.tensor(tree["final_norm"]["scale"]),
             "embed.table": torch.tensor(tree["embed"]["table"])}
    for g in range(2):
        named[f"layers.{g}.ln1.scale"] = torch.tensor(tree["groups"]["layer_0"]["ln1"]["scale"][g])
        for n in ("w", "b"):
            named[f"layers.{g}.attn.wq.{n}"] = torch.tensor(
                tree["groups"]["layer_0"]["attn"]["wq"][n][g])
    gnamed = {n: torch.zeros_like(t) for n, t in named.items()}
    load_reference_tree(gnamed, grads, cfg)
    assert adamw.decays("layers.1.ln1.scale", named["layers.1.ln1.scale"])
    assert adamw.decays("encoder.layers.0.ln1.scale", named["layers.1.ln1.scale"])
    assert not adamw.decays("final_norm.scale", named["final_norm.scale"])
    before = {n: t.clone() for n, t in named.items()}
    state = adamw.init(named)
    _, state, met = adamw.apply_updates(named, gnamed, state, adamw.AdamWConfig(**kw))
    assert state.step == 1 and float(met["lr"]) == float(rm["lr"])
    np.testing.assert_allclose(float(met["grad_norm"]), float(rm["grad_norm"]), rtol=1e-6)
    got = reference_tree(named, cfg)
    for path in (("final_norm", "scale"), ("groups", "layer_0", "ln1", "scale"),
                 ("groups", "layer_0", "attn", "wq", "w"),
                 ("groups", "layer_0", "attn", "wq", "b"), ("embed", "table")):
        g, w = got, rp
        for k in path:
            g, w = g[k], w[k]
        np.testing.assert_array_equal(_np(g), np.asarray(w), err_msg=str(path))
    # decayed: a stacked layer's scale moved by more than its Adam step
    step = np.abs(_np(named["layers.0.ln1.scale"]) - _np(before["layers.0.ln1.scale"]))
    assert (step > 1e-2 + 1e-3).any()
    final = np.abs(_np(named["final_norm.scale"]) - _np(before["final_norm.scale"]))
    assert (final <= 1e-2 * 1.0001).all()


def test_adamw_reduces_quadratic_loss():
    params = {"w": torch.tensor([3.0, -2.0, 1.0])}
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                            total_steps=200, schedule="constant")
    state = adamw.init(params)
    for _ in range(150):
        g = {"w": 2 * params["w"]}
        params, state, _ = adamw.apply_updates(params, g, state, cfg)
    assert float((params["w"] ** 2).sum()) < 1e-3


def test_adamw_lr_schedule_shapes():
    cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
    lrs = [float(adamw.lr_at(cfg, s)) for s in range(101)]
    assert lrs[0] < lrs[9] <= 1.0  # warmup
    assert lrs[100] < lrs[50] < lrs[11]  # cosine decay
    assert lrs[100] >= cfg.lr * cfg.min_lr_ratio - 1e-6


def test_grad_clip_limits_update_norm():
    params = {"w": torch.zeros(4)}
    cfg = adamw.AdamWConfig(lr=1.0, grad_clip=0.5, weight_decay=0.0)
    _, _, metrics = adamw.apply_updates(params, {"w": torch.full((4,), 1e6)},
                                        adamw.init(params), cfg)
    assert float(metrics["grad_norm"]) > 1e5  # measured pre-clip


def test_bf16_moments_keep_their_dtype():
    params = {"w": torch.ones(3, 4)}
    state = adamw.init(params, dtype=torch.bfloat16)
    adamw.apply_updates(params, {"w": torch.full((3, 4), 0.5)}, state, adamw.AdamWConfig())
    assert state.m["w"].dtype == torch.bfloat16 and float(state.m["w"][0, 0]) != 0


# -------------------------------------------------------------- compression
@pytest.mark.parametrize("ratio", [0.01, 0.1, 0.37])
def test_topk_mask_is_the_reference_mask(ratio):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((40, 25)).astype(np.float32)
    x[3, :10] = x[0, 0]  # ties at some magnitude
    x[5, :4] = -x[0, 0]
    got = _topk_mask(torch.from_numpy(x), ratio).numpy()
    want = np.asarray(RCo._topk_mask(jnp.asarray(x), ratio))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("kind", ["topk", "int8"])
@pytest.mark.parametrize("error_feedback", [True, False])
def test_compress_tree_is_the_reference_bitwise(kind, error_feedback):
    """Five rounds with error feedback on equal inputs; int8 sees values at
    half quanta, where rounding half to even decides."""
    rng = np.random.default_rng(2)
    g = {"a": rng.standard_normal((30, 7)).astype(np.float32),
         "b": (rng.integers(-20, 20, 64) + 0.5).astype(np.float32)}
    g["b"][0] = 127.0
    cfg_kw = dict(kind=kind, topk_ratio=0.2, error_feedback=error_feedback)
    rerr = RCo.init_error_state(g)
    err = init_error_state({n: torch.from_numpy(v) for n, v in g.items()})
    for r in range(5):
        gr = {n: v * (1 + r) for n, v in g.items()}
        rsent, rerr = RCo.compress_tree({n: jnp.asarray(v) for n, v in gr.items()}, rerr,
                                        RCo.CompressionConfig(**cfg_kw))
        sent, err = compress_tree({n: torch.from_numpy(v) for n, v in gr.items()}, err,
                                  CompressionConfig(**cfg_kw))
        for n in g:
            assert np.array_equal(sent[n].numpy(), np.asarray(rsent[n])), (r, n)
            assert np.array_equal(err[n].numpy(), np.asarray(rerr[n])), (r, n)


def test_compress_tree_groups_take_one_threshold_and_scale():
    """A group compresses as one tensor: as the reference's stacked leaf."""
    rng = np.random.default_rng(3)
    stacked = rng.standard_normal((3, 50)).astype(np.float32)
    for kind in ("topk", "int8"):
        rsent, _ = RCo.compress_tree({"x": jnp.asarray(stacked)},
                                     {"x": jnp.zeros((3, 50))},
                                     RCo.CompressionConfig(kind=kind, topk_ratio=0.1))
        named = {f"x{i}": torch.from_numpy(stacked[i]) for i in range(3)}
        sent, _ = compress_tree(named, init_error_state(named),
                                CompressionConfig(kind=kind, topk_ratio=0.1),
                                groups=[["x0", "x1", "x2"]])
        got = np.stack([sent[f"x{i}"].numpy() for i in range(3)])
        assert np.array_equal(got, np.asarray(rsent["x"])), kind


@pytest.mark.parametrize("kind,rounds,tol", [("topk", 60, 0.25), ("int8", 30, 0.01)])
def test_compression_error_feedback_preserves_signal(kind, rounds, tol):
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.standard_normal(1000).astype(np.float32))}
    err = init_error_state(g)
    cfg = CompressionConfig(kind=kind, topk_ratio=0.1)
    total_sent = torch.zeros(1000)
    for _ in range(rounds):  # same gradient repeatedly
        sent, err = compress_tree(g, err, cfg)
        total_sent = total_sent + sent["w"]
    rel = float((total_sent / rounds - g["w"]).abs().max() / g["w"].abs().max())
    assert rel < tol, rel
    if kind == "topk":
        nef = CompressionConfig(kind=kind, topk_ratio=0.1, error_feedback=False)
        sent0, _ = compress_tree(g, init_error_state(g), nef)
        assert float((sent0["w"] == 0).float().mean()) > 0.8


def test_wire_bytes_ratio():
    for kind, ratio in (("none", 0.01), ("int8", 0.01), ("topk", 0.01), ("topk", 0.3)):
        for b in (2, 4):
            assert wire_bytes_ratio(CompressionConfig(kind, topk_ratio=ratio), b) == \
                RCo.wire_bytes_ratio(RCo.CompressionConfig(kind, topk_ratio=ratio), b)
    assert wire_bytes_ratio(CompressionConfig("int8")) == 0.5
    with pytest.raises(ValueError):
        wire_bytes_ratio(CompressionConfig("fp4"))


# --------------------------------------------------------------------- data
@pytest.mark.parametrize("kw", [dict(seq_len=32, global_batch=8, vocab_size=100, seed=1),
                                dict(seq_len=64, global_batch=8, vocab_size=512,
                                     num_hosts=2, host_id=1, motif_prob=1.0,
                                     motif_len=8),
                                dict(seq_len=17, global_batch=3, vocab_size=151936,
                                     seed=7, zipf_a=1.1)])
def test_make_batch_is_the_reference_batch_bitwise(kw):
    for step in (0, 3, 1000):
        got, want = make_batch(DataConfig(**kw), step), RT.make_batch(RT.DataConfig(**kw),
                                                                      step)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])


@pytest.mark.parametrize("arch", ["paligemma-3b", "whisper-large-v3", "yi-6b"])
def test_add_frontend_stub_is_the_reference_stub_bitwise(arch):
    cfg = smoke_config(configs.get_config(arch))
    rcfg = ref_smoke_config(ref_configs.get_config(arch))
    kw = dict(seq_len=16, global_batch=2, vocab_size=cfg.vocab_size)
    got = add_frontend_stub(make_batch(DataConfig(**kw), 5), cfg, 5)
    want = RT.add_frontend_stub(RT.make_batch(RT.DataConfig(**kw), 5), rcfg, 5)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in got)


def test_prefetching_loader_yields_the_batches_in_order():
    cfg = smoke_config(configs.get_config("paligemma-3b"))
    data = DataConfig(seq_len=32, global_batch=2, vocab_size=cfg.vocab_size)
    loader = PrefetchingLoader(data, cfg, start_step=4)
    try:
        for want_step in (4, 5, 6):
            step, b = next(loader)
            ref = add_frontend_stub(make_batch(data, step), cfg, step)
            assert step == want_step and all(np.array_equal(b[k], ref[k]) for k in ref)
    finally:
        loader.close()
    assert not loader._thread.is_alive()
    # a batch that cannot be made (motifs longer than the sequence) raises
    # in the consumer instead of leaving it waiting on a dead thread
    loader = PrefetchingLoader(DataConfig(seq_len=8, global_batch=2, vocab_size=100,
                                          motif_prob=1.0))
    try:
        with pytest.raises(ValueError):
            next(loader)
    finally:
        loader.close()
    assert not loader._thread.is_alive()


def test_data_deterministic_and_host_sharded():
    cfg = DataConfig(seq_len=32, global_batch=8, vocab_size=100, seed=1)
    assert np.array_equal(make_batch(cfg, 3)["tokens"], make_batch(cfg, 3)["tokens"])
    assert not np.array_equal(make_batch(cfg, 3)["tokens"], make_batch(cfg, 4)["tokens"])
    h0 = DataConfig(seq_len=32, global_batch=8, vocab_size=100, seed=1, num_hosts=2,
                    host_id=0)
    h1 = DataConfig(seq_len=32, global_batch=8, vocab_size=100, seed=1, num_hosts=2,
                    host_id=1)
    a, b = make_batch(h0, 0), make_batch(h1, 0)
    assert a["tokens"].shape[0] == 4
    assert not np.array_equal(a["tokens"], b["tokens"])


# ------------------------------------------------------------- checkpointer
def _tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.bfloat16)}}


def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = _tree()
    ck.save(7, t, extra={"loss": 1.5})
    out = ck.restore(7, t)
    assert torch.equal(out["a"], t["a"])
    assert out["b"]["c"].dtype == torch.bfloat16 and torch.equal(out["b"]["c"], t["b"]["c"])
    assert ck.read_extra(7) == {"loss": 1.5}
    meta = {"a": t["a"].to("meta"), "b": {"c": t["b"]["c"].to("meta")}}
    assert torch.equal(ck.restore(7, meta)["a"], t["a"])
    with pytest.raises(ValueError, match="other leaves"):
        ck.restore(7, {"a": t["a"], "b": {"d": t["b"]["c"]}})
    with pytest.raises(ValueError, match="shape"):
        ck.restore(7, {"a": t["a"][:2], "b": t["b"]})


def test_checkpoint_async_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    t = _tree()
    for s in (1, 2, 3, 4):
        ck.save_async(s, t)
        t["a"] += 1  # training goes on: the snapshot was taken at the call
        ck.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]
    assert ck.latest_step() == 4
    assert float(ck.restore(4, t)["a"][0, 0]) == 3.0


def test_loop_checkpoint_takes_one_host_copy(tmp_path):
    """The loop's state tree is one new host tensor per leaf, shared with no
    parameter or moment (training on the CPU updates those in place), and
    ``save_async(copy=False)`` writes it as it is."""
    from repro_torch.train.loop import _state_tree

    cfg = smoke_config(configs.get_config("qwen2.5-3b"))
    named = dict(M.init_params(0, cfg, dtype=torch.float32, device="cpu").named_parameters())
    state = adamw.init(named)
    tree = _state_tree(named, state, cfg, "cpu")
    live = {t.untyped_storage().data_ptr()
            for ts in (named, state.m, state.v) for t in ts.values()}
    leaves = [x for _, x in _flatten_with_names(tree)]
    assert not live & {t.untyped_storage().data_ptr() for t in leaves}
    want = {k: reference_tree(ts, cfg) for k, ts in
            (("params", named), ("m", state.m), ("v", state.v))}
    want = {n: x.clone() for n, x in _flatten_with_names(want)}
    ck = Checkpointer(str(tmp_path))
    ck.save_async(1, tree, copy=False)
    with torch.no_grad():
        for p in named.values():
            p.add_(1.0)  # training goes on
    ck.wait()
    got = _flatten_with_names(ck.restore(1, _state_tree(named, state, cfg, "meta")))
    assert [n for n, _ in got] == list(want)
    assert all(torch.equal(x, want[n]) for n, x in got)


def test_checkpoint_detects_corruption(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = _tree()
    path = ck.save(1, t)
    with open(os.path.join(path, "shard_00000.npz"), "r+b") as f:
        f.seek(100)
        f.write(b"\x00" * 8)
    with pytest.raises(IOError, match="corrupt"):
        ck.restore(1, t)


def test_checkpoint_crash_mid_write_keeps_previous(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = _tree()
    ck.save(5, t)
    os.makedirs(os.path.join(tmp_path, "step_00000009.tmp"))
    assert ck.latest_step() == 5
    ck.restore(5, t)


def _state_pair(arch="qwen2.5-3b"):
    """The reference's ``{"params", "m", "v"}`` of a smoke config (numpy),
    and the port's model and moments holding the same numbers."""
    rcfg = ref_smoke_config(ref_configs.get_config(arch))
    cfg = smoke_config(configs.get_config(arch))
    tree = jax.tree_util.tree_map(np.asarray,
                                  RM.init_params(jax.random.key(4), rcfg, dtype=jnp.float32))
    rng = np.random.default_rng(6)
    state = {"params": tree,
             "m": jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape)
                                         .astype(np.float32), tree),
             "v": jax.tree_util.tree_map(lambda a: rng.random(a.shape)
                                         .astype(np.float32), tree)}
    model = M.Model(cfg, device=torch.device("cpu"))
    named = dict(model.named_parameters())
    opt = adamw.init(named)
    for ts, key in ((named, "params"), (opt.m, "m"), (opt.v, "v")):
        load_reference_tree(ts, state[key], cfg)
    port = {k: reference_tree(ts, cfg) for k, ts in
            (("params", named), ("m", opt.m), ("v", opt.v))}
    return cfg, state, port


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "jamba-1.5-large-398b"])
def test_checkpoints_cross_packages_both_ways(tmp_path, arch):
    cfg, ref_state, port_state = _state_pair(arch)
    RefCheckpointer(str(tmp_path / "ref")).save(3, ref_state, extra={"loss": 2.0})
    Checkpointer(str(tmp_path / "port")).save(3, port_state, extra={"loss": 2.0})
    man = [json.loads((tmp_path / d / "step_00000003" / "manifest_00000.json").read_text())
           for d in ("ref", "port")]
    assert {k: v for k, v in man[0].items() if k != "shard_sha256"} == \
        {k: v for k, v in man[1].items() if k != "shard_sha256"}
    assert man[1]["leaf_names"][0] == "m/embed/table"
    # the port restores the reference's checkpoint ...
    got = Checkpointer(str(tmp_path / "ref")).restore(3, port_state)
    for (n, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got),
                              jax.tree_util.tree_leaves_with_path(ref_state)):
        assert np.array_equal(g.numpy(), w), n
    # ... and the reference the port's
    want = jax.tree_util.tree_map(jnp.asarray, ref_state)
    back = RefCheckpointer(str(tmp_path / "port")).restore(3, want)
    for g, w in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(ref_state)):
        assert np.array_equal(np.asarray(g), w)


# ---------------------------------------------------- fault tolerance units
def test_straggler_monitor_flags_outliers(monkeypatch):
    """The port's clock is patched: 2 ms steps, then one of 50 ms."""
    now = [0.0]
    monkeypatch.setattr(FT, "perf_counter", lambda: now[0])
    seen = []
    mon = StragglerMonitor(window=20, threshold=2.0, on_straggler=seen.append)
    for i, dt in enumerate([0.002] * 10 + [0.05] + [0.002] * 3):
        mon.start_step()
        now[0] += dt
        assert mon.end_step(i) == pytest.approx(dt)
    assert len(mon.events) == 1 and seen == mon.events
    ev = mon.events[0]
    assert ev.step == 10 and ev.ratio == pytest.approx(25.0)
    assert mon.median == pytest.approx(0.002)


def test_preemption_guard_flag():
    g = PreemptionGuard(signals=())
    assert not g.preempted
    g.trigger()
    assert g.preempted


def test_elastic_reshard_moves_a_tree_to_the_device():
    t = {"a": np.ones(3, np.float32), "b": {"c": torch.zeros(2)}}
    out = elastic_reshard(t, None, ShardingCtx(attn_impl="torch"), device="cpu")
    assert isinstance(out["a"], torch.Tensor) and out["b"]["c"].device.type == "cpu"
    # a mesh whose dims have no names cannot hold logical-axis rules
    with pytest.raises(ValueError, match="names"):
        ShardingCtx(mesh=type("Mesh", (), {"mesh_dim_names": None})())


# ------------------------------------------------------- end-to-end training
def _qwen_loop_setup():
    cfg = smoke_config(configs.get_config("qwen2.5-3b"))
    data_cfg = DataConfig(seq_len=32, global_batch=4, vocab_size=cfg.vocab_size)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=12)
    return cfg, data_cfg, opt_cfg


def test_train_loop_runs_resumes_and_repeats_bitwise(tmp_path):
    cfg, data_cfg, opt_cfg = _qwen_loop_setup()
    full = train(cfg, data_cfg, LoopConfig(total_steps=9, log_every=0), opt_cfg,
                 device="cpu")
    r1 = train(cfg, data_cfg, LoopConfig(total_steps=6, checkpoint_every=3, log_every=0),
               opt_cfg, checkpoint_dir=str(tmp_path), device="cpu")
    assert r1.final_step == 6 and np.isfinite(r1.losses).all()
    assert Checkpointer(str(tmp_path)).read_extra(3) == {"loss": r1.losses[2]}
    r2 = train(cfg, data_cfg, LoopConfig(total_steps=9, checkpoint_every=3, log_every=0),
               opt_cfg, checkpoint_dir=str(tmp_path), device="cpu")
    assert r2.resumed_from == 6 and r2.final_step == 9 and len(r2.losses) == 3
    # stateless data + exact restore: the resumed run is the uninterrupted one
    assert r1.losses + r2.losses == full.losses
    assert len(full.grad_norms) == len(full.lrs) == 9
    a, b = full.params.state_dict(), r2.params.state_dict()
    assert all(torch.equal(a[n], b[n]) for n in a)


def test_train_loop_resumes_the_reference_run(tmp_path):
    """The reference trains 6 steps with a checkpoint at 3; the port
    restores that step-3 checkpoint and trains steps 4-6."""
    cfg, data_cfg, opt_cfg = _qwen_loop_setup()
    rcfg = ref_smoke_config(ref_configs.get_config("qwen2.5-3b"))
    ref = RL.train(rcfg, RT.DataConfig(seq_len=32, global_batch=4,
                                       vocab_size=rcfg.vocab_size),
                   RL.LoopConfig(total_steps=6, checkpoint_every=3, log_every=0),
                   RA.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=12),
                   checkpoint_dir=str(tmp_path / "ref"))
    shutil.copytree(tmp_path / "ref" / "step_00000003", tmp_path / "port" / "step_00000003")
    got = train(cfg, data_cfg, LoopConfig(total_steps=6, checkpoint_every=3, log_every=0),
                opt_cfg, checkpoint_dir=str(tmp_path / "port"), device="cpu")
    assert got.resumed_from == 3 and got.final_step == 6
    np.testing.assert_allclose(got.losses, ref.losses[3:], rtol=1e-3, atol=0)
    # and the reference resumes the port's step-6 checkpoint
    shutil.rmtree(tmp_path / "ref")
    shutil.copytree(tmp_path / "port" / "step_00000006", tmp_path / "ref" / "step_00000006")
    again = RL.train(rcfg, RT.DataConfig(seq_len=32, global_batch=4,
                                         vocab_size=rcfg.vocab_size),
                     RL.LoopConfig(total_steps=7, log_every=0),
                     RA.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=12),
                     checkpoint_dir=str(tmp_path / "ref"))
    assert again.resumed_from == 6 and np.isfinite(again.losses).all()


def test_train_loop_preemption_checkpoints_and_stops(tmp_path):
    cfg = smoke_config(configs.get_config("yi-6b"))
    data_cfg = DataConfig(seq_len=16, global_batch=2, vocab_size=cfg.vocab_size)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, total_steps=100)
    guard = PreemptionGuard(signals=())
    guard.trigger()  # preempted before step 1 completes
    r = train(cfg, data_cfg,
              LoopConfig(total_steps=50, checkpoint_every=100, log_every=0),
              opt_cfg, checkpoint_dir=str(tmp_path), preemption=guard, device="cpu")
    assert r.preempted and r.final_step == 1
    assert Checkpointer(str(tmp_path)).latest_step() == 1  # emergency checkpoint


def test_train_loss_decreases_on_structured_data():
    cfg = smoke_config(configs.get_config("xlstm-350m"))
    data_cfg = DataConfig(seq_len=64, global_batch=8, vocab_size=cfg.vocab_size,
                          motif_prob=1.0, motif_len=8)
    opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=40,
                                weight_decay=0.0)
    r = train(cfg, data_cfg, LoopConfig(total_steps=30, log_every=0), opt_cfg,
              device="cpu")
    first, last = np.mean(r.losses[:5]), np.mean(r.losses[-5:])
    assert last < first - 0.1, (first, last)


def test_launcher_trains_on_the_cpu_and_refuses_a_silent_single_card(tmp_path, capsys,
                                                                     monkeypatch):
    res = LT.main(["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu", "--steps", "2",
                   "--seq", "16", "--batch", "2", "--ckpt-dir", str(tmp_path),
                   "--compress", "topk"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=qwen2.5-3b-smoke") and out[-1].startswith(
        "final: step=2 loss=")
    assert res.final_step == 2 and Checkpointer(str(tmp_path)).latest_step() == 2
    # more than one card: one process trains on one card, and says so in
    # its --help (a model mesh spans the ranks of a torchrun launch)
    monkeypatch.setattr(LT, "resolve_device", lambda d: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    args = type("A", (), {"device": "cuda", "no_mesh": False})
    ctx = LT.build_ctx(args)
    assert ctx.mesh is None and ctx.attn_impl == "torch"
    args.no_mesh = True
    assert LT.build_ctx(args).attn_impl == "torch"
    with pytest.raises(SystemExit):
        LT.main(["--help"])
    help_text = " ".join(capsys.readouterr().out.split())
    assert "one process trains on one card" in help_text and "torchrun" in help_text
