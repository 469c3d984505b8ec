"""One training step of the port against the reference's, on the same
parameters (the reference's ``smoke_config`` tree loaded with
``params_from_jax``), the same optimiser state and the same batch
(``data.tokens.make_batch``, bitwise the same in both packages).

Each parameter, ``m`` and ``v`` leaf is held by what the step changed:
``p - p0``, ``m - b1 m0`` and ``v - b2 v0`` of the port against the
reference's, each element within ``delta`` x the leaf's largest change plus
2 ulps of the stored value (what subtracting two f32 values can resolve: a
``v`` change of a few ulps is all its rounding).  A step that did nothing
reads 1 on every leaf, a sign-flipped update 2, and a leaf whose gradient is
zeroed 1 on ``m`` and ``v`` (and on ``params`` 0.24-0.36 of the change in its
least sensitive leaf, 0.77-0.92 in the median one, for the dense archs).

Tolerances:

- **f32 activations** (both packages' ``embed`` patched to f32, as in
  ``tests/test_torch_lm.py``): loss and ``grad_norm`` within rtol 1e-4;
  the parameters, ``m`` and ``v`` after the step within rtol 1e-4, atol
  1e-6, and their changes within ``delta`` 1e-3 (measured at most 1.7e-4,
  5.7e-5 and 6.6e-5, xlstm).  Two exceptions: jamba (rtol 1e-3 and
  ``delta`` 5e-3: its f32 forward already differs from the reference's by
  3e-4 through SSD and MoE layers of magnitude 35-45; measured changes
  8.9e-4, 9.7e-4 and 8.0e-4) and whisper, whose encoder runs in bf16 in
  both packages by design: the bf16 tolerance below, measured loss 1.1e-5,
  ``grad_norm`` 4.6e-4, changes 1.4e-2, 1.9e-2 and 2.9e-2 (encoder MLP
  biases).
- **bf16 activations** (the dense archs): loss rtol 1e-3, ``grad_norm``
  rtol 1e-2, each leaf's change within ``delta`` 0.1.  Measured: loss
  2.5e-4, ``grad_norm`` 2.6e-3, changes 3.5e-2 (parameters), 2.8e-2
  (``m``), 4.9e-2 (``v``) of the largest.  The MoE and SSM archs are held
  in f32 only: in bf16 a router's near tie moves a token to another expert,
  and the reference's jamba and xlstm disagree with themselves
  (``tests/test_torch_lm.py``).

The optimiser state is mid-training (step 3, moments drawn from a seed),
not zero: from zero moments Adam's first update is ``g / (|g| + eps)``,
about ``lr * sign(g)``, which turns an f32 rounding of a gradient entry
near 0 into a parameter difference of up to 2 lr.  ``v0`` (1e-4 to 2e-4)
makes the update linear in ``g``; ``m0`` (std 1e-4) stays below this step's
``(1 - b1) g`` so that the parameters' change shows the gradient.
``global_norm`` sums its squares in another grouping than the reference
(per layer, not per stacked leaf): a tolerance, not bitwise.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.checkpoint.checkpointer import _flatten_with_names as ref_flatten
from repro.config import smoke_config as ref_smoke_config
from repro.distributed.sharding import ShardingCtx as RefCtx
from repro.models import model as RM
from repro.optim import adamw as RA
from repro.optim.compression import CompressionConfig as RefCompression
from repro.optim.compression import init_error_state as ref_init_error_state
from repro.train import step as RS
from repro_torch import configs
from repro_torch.checkpoint.checkpointer import _flatten_with_names
from repro_torch.config import smoke_config
from repro_torch.data.tokens import DataConfig, add_frontend_stub, make_batch
from repro_torch.distributed.sharding import LOCAL_CTX, ShardingCtx
from repro_torch.launch import serve as S
from repro_torch.models import model as M
from repro_torch.models.params import (load_reference_tree, params_from_jax,
                                       reference_tree)
from repro_torch.optim import adamw
from repro_torch.optim.compression import CompressionConfig, init_error_state
from repro_torch.train.step import make_train_step

ARCHS = configs.list_archs()
DENSE = [a for a in ARCHS if configs.get_config(a).family == "dense"]
TORCH_CTX = ShardingCtx(attn_impl="torch")
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=12)
#: the step-3 first moment's std
M0_STD = 1e-4
#: loss and grad_norm rtol; each leaf's value (rtol, atol) or None; each
#: leaf's change within ``delta`` x its largest change (module docstring)
F32 = dict(loss=1e-4, grad_norm=1e-4, leaf=(1e-4, 1e-6), delta=1e-3)
BF16 = dict(loss=1e-3, grad_norm=1e-2, leaf=None, delta=0.1)
F32_TOL = {"jamba-1.5-large-398b": dict(loss=1e-3, grad_norm=1e-3, leaf=None,
                                        delta=5e-3),
           "whisper-large-v3": BF16}  # its encoder runs in bf16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def f32_activations(monkeypatch):
    from repro.models import common as RC
    from repro_torch.models import common as PC

    ref_embed, port_embed = RC.embed, PC.embed
    monkeypatch.setattr(RC, "embed", lambda p, t, dtype=None: ref_embed(p, t, jnp.float32))
    monkeypatch.setattr(PC, "embed",
                        lambda p, t, dtype=None: port_embed(p, t, torch.float32))


def _setup(arch, seed=1):
    """(cfg, ref cfg, ref tree, port model, batch, ref state, port state):
    mid-training moments at step 3 from one generator."""
    rcfg = ref_smoke_config(ref_configs.get_config(arch))
    cfg = smoke_config(configs.get_config(arch))
    tree = jax.tree_util.tree_map(
        np.asarray, RM.init_params(jax.random.key(seed), rcfg, dtype=jnp.float32))
    model = params_from_jax(tree, cfg, device="cpu")
    batch = make_batch(DataConfig(seq_len=16, global_batch=2, vocab_size=cfg.vocab_size,
                                  seed=3), 0)
    if cfg.frontend != "none":
        batch = add_frontend_stub(batch, cfg, 0)
    rng = np.random.default_rng(5)
    m0 = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * M0_STD).astype(np.float32), tree)
    v0 = jax.tree_util.tree_map(
        lambda a: (1e-4 * (1 + rng.random(a.shape))).astype(np.float32), tree)
    state = adamw.init(dict(model.named_parameters()))
    load_reference_tree(state.m, m0, cfg)
    load_reference_tree(state.v, v0, cfg)
    state.step = 3
    return cfg, rcfg, tree, model, batch, RA.AdamWState(jnp.int32(3), m0, v0), state


def _ref_step(rcfg, tree, rstate, batch, **kw):
    step = jax.jit(RS.make_train_step(rcfg, RefCtx(attn_impl="xla"), RA.AdamWConfig(**OPT),
                                      **kw))
    err = ref_init_error_state(tree) if kw.get("compression") else None
    p, s, e, m = step(tree, rstate, err, {k: jnp.asarray(v) for k, v in batch.items()})
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return to_np(p), to_np(s.m), to_np(s.v), None if e is None else to_np(e), m


def _leaves_equal_names(got, want):
    g = {n: np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x, np.float32)
         for n, x in _flatten_with_names(got)}
    w = {n: np.asarray(x, np.float32) for n, x in ref_flatten(want)}
    assert list(g) == list(w)
    return g, w


def _check_tree(label, got, want, base, tol):
    """Each leaf of ``got`` against ``want``, and the change from ``base``
    (reference layout; None: zeros) of each."""
    g, w = _leaves_equal_names(got, want)
    b = dict(ref_flatten(base)) if base is not None else {}
    for n in w:
        if tol["leaf"] is not None:
            rtol, atol = tol["leaf"]
            assert np.allclose(g[n], w[n], rtol=rtol, atol=atol), (
                label, n, float(np.abs(g[n] - w[n]).max()))
        change = w[n] - np.asarray(b.get(n, 0), np.float32)
        err = np.abs(g[n] - w[n]) - 2 * np.spacing(np.abs(w[n]))
        assert (err <= tol["delta"] * np.abs(change).max()).all(), (
            label, n, float(err.max()), float(np.abs(change).max()))


def _check_metric(name, got, want, tol):
    assert np.isclose(float(got), float(want), rtol=tol[name], atol=0), (
        name, float(got), float(want))


def _run_both(arch, tol, **kw):
    cfg, rcfg, tree, model, batch, rstate, state = _setup(arch)
    rp, rm, rv, rerr, rmet = _ref_step(rcfg, tree, rstate, batch, **kw)
    port_kw = dict(kw)
    if "compression" in kw:
        port_kw["compression"] = CompressionConfig(kw["compression"].kind,
                                                   kw["compression"].topk_ratio)
    named = dict(model.named_parameters())
    err = init_error_state(named) if "compression" in kw else None
    step = make_train_step(cfg, TORCH_CTX, adamw.AdamWConfig(**OPT), **port_kw)
    out, state, err, met = step(model, state, err, batch)
    assert out is model and state.step == 4
    assert not any(p.requires_grad for p in model.parameters())
    for name in ("loss", "grad_norm"):
        _check_metric(name, met[name], rmet[name], tol)
    assert float(met["lr"]) == float(rmet["lr"])
    if "tokens" in rmet:
        assert float(met["tokens"]) == float(rmet["tokens"])
        assert np.isclose(float(met["aux"]), float(rmet["aux"]), rtol=1e-3, atol=1e-6)
    opt = adamw.AdamWConfig(**OPT)
    scaled = lambda t, c: jax.tree_util.tree_map(lambda a: np.float32(c) * a, t)
    _check_tree("params", reference_tree(named, cfg), rp, tree, tol)
    _check_tree("m", reference_tree(state.m, cfg), rm, scaled(rstate.m, opt.b1), tol)
    _check_tree("v", reference_tree(state.v, cfg), rv, scaled(rstate.v, opt.b2), tol)
    if err is not None:
        _check_tree("err", reference_tree(err, cfg), rerr, None, tol)
    return met


@pytest.mark.parametrize("arch", ARCHS)
def test_step_matches_reference(arch, f32_activations):
    met = _run_both(arch, F32_TOL.get(arch, F32))
    assert set(met) == {"loss", "aux", "tokens", "grad_norm", "lr"}


@pytest.mark.parametrize("arch", DENSE)
def test_bf16_step_matches_reference(arch):
    _run_both(arch, BF16)


@pytest.mark.parametrize("kind,microbatches", [("topk", 2), ("int8", 1)])
def test_microbatches_and_compression_match_reference(kind, microbatches,
                                                      f32_activations):
    """Microbatches accumulated in f32, then compression with error
    feedback, then AdamW.  The reference's microbatched ``loss`` is the mean
    of the totals; its threshold (top-k) or scale (int8) is one over each
    stacked leaf, so the port takes one over the layers of that leaf.
    int8 rounds each entry to a quantum of max |g| / 127: with two
    microbatches the two packages' accumulated gradients, a few ulps apart,
    put one entry of qwen's ``wo`` on either side of a rounding boundary
    (its ``m`` then differs by a tenth of a quantum, 6.6e-6), so int8 is
    held here unsplit and bitwise on equal inputs in
    ``test_torch_substrate.py``."""
    comp = RefCompression(kind, topk_ratio=0.1)
    met = _run_both("qwen2.5-3b", F32, microbatches=microbatches, compression=comp)
    assert float(met["tokens"]) == 32


def test_remat_recomputes_the_same_gradients():
    cfg = smoke_config(configs.get_config("jamba-1.5-large-398b"))
    model = M.init_params(3, cfg, dtype=torch.float32, device="cpu")
    batch = make_batch(DataConfig(seq_len=16, global_batch=2, vocab_size=cfg.vocab_size), 0)
    params = list(model.parameters())
    grads = []
    for remat in (True, False):
        for p in params:
            p.requires_grad_(True)
        total, _ = M.train_loss(model, batch, cfg, TORCH_CTX, remat=remat)
        grads.append(torch.autograd.grad(total, params, allow_unused=True))
    for a, b in zip(*grads):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)


def test_train_step_rejects_the_flash_kernel_context():
    cfg = smoke_config(configs.get_config("qwen2.5-3b"))
    for ctx in (LOCAL_CTX, ShardingCtx(attn_impl="cuda")):
        with pytest.raises(ValueError, match="no backward"):
            make_train_step(cfg, ctx, adamw.AdamWConfig())
    # the cross-pod axis is accepted and changes nothing, as in the reference
    assert callable(make_train_step(cfg, TORCH_CTX, adamw.AdamWConfig(),
                                    pod_axis="pod"))


def test_serving_is_unchanged_by_the_trainable_switch():
    """Parameters require no gradient outside the step; serving's logits
    are bitwise the same with the switch on and after a step restored it."""
    cfg = smoke_config(configs.get_config("qwen2.5-3b"))
    model = M.init_params(2, cfg, dtype=torch.float32, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    prompts = S.make_prompts(cfg, 2, 12, 0)

    def logits():
        res = S.serve(model, cfg, LOCAL_CTX, prompts, batch=2, gen_len=3,
                      keep_logits=True)
        return [x for b in res.logits for x in b]

    before = logits()
    model.requires_grad_(True)
    assert all(np.array_equal(a, b) for a, b in zip(before, logits()))
    model.requires_grad_(False)
    step = make_train_step(cfg, TORCH_CTX, adamw.AdamWConfig())
    batch = make_batch(DataConfig(seq_len=12, global_batch=2, vocab_size=cfg.vocab_size), 0)
    step(model, adamw.init(dict(model.named_parameters())), None, batch)
    assert not any(p.requires_grad for p in model.parameters())
    after = logits()
    assert not all(np.array_equal(a, b) for a, b in zip(before, after))  # it trained
