"""The port's LM serving path against the reference on the same
parameters: the reference's parameter tree (``smoke_config`` of every
registered arch) is loaded into the port with ``params_from_jax``; batches
carry ``patch_embeds`` and ``frames`` where the arch takes them, drawn as
``tests/test_archs_smoke.py`` draws them.

Logits are bf16 activations in both packages, rounded at other places:
rtol = 2e-2 and atol = 2e-2 x max(1, max |logit|).  The 2e-2 is the
reference's own prefill/decode tolerance (``tests/test_archs_smoke.py``),
set for logits of order 1; the untied heads of qwen2.5-32b and yi-6b give
logits up to about 4, where the reference's compiled forward and the same
forward op by op (``jax.disable_jit``) already differ by up to 0.049, as
much as the port does (XLA keeps fused intermediates in f32).  So the
absolute part scales with the logits.  Greedy token ids are compared
wherever the reference's top-1/top-2 logit margin exceeds twice the
measured difference of the two logit rows (no such difference can flip
the argmax); past a near tie a row's later tokens may differ
legitimately, so its comparison stops there.  On the CPU ``attn_impl="cuda"`` runs the
flash kernel's plain version.

Four archs are compared with f32 activations (both packages' ``embed``
patched to f32, so every layer computes in f32; whisper's encoder stays
bf16 by design), at the same tolerance:

- the MoE archs (moonshot-v1-16b-a3b, phi3.5-moe-42b-a6.6b, and jamba):
  a router's top-k is discontinuous, so where two experts' probabilities
  nearly tie, a one-ulp bf16 difference upstream (the flash kernel's f32
  summation order, say) routes a token to another expert; in bf16 the
  launcher test's first logits of moonshot differed by 1.73 so.  Routing
  itself is held exactly on the same inputs in ``test_torch_families.py``.
- jamba-1.5-large-398b and xlstm-350m: in bf16 the reference does not
  meet the tolerance against itself.  On ``test_forward_matches_
  reference``'s batch its compiled forward and the same forward op by op
  (``jax.disable_jit``) differ by 2.69 (jamba, logits up to 4.19:
  tolerance 0.084) and 0.039 (xlstm, logits up to 0.66: tolerance 0.02).
  Jamba's residual stream reaches magnitude 35-45 through SSD and MoE
  layers, so a one-ulp difference grows layer by layer and flips
  routing; xlstm's head-wise norms rescale small mLSTM outputs.

With f32 activations the port's forward is within 3e-4 (jamba), 5e-6
(moonshot, phi) and 7e-6 (xlstm) of the reference's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.config import smoke_config as ref_smoke_config
from repro.distributed.sharding import LOCAL_CTX as REF_CTX
from repro.distributed.sharding import ShardingCtx as RefCtx
from repro.models import model as RM
from repro_torch import configs
from repro_torch.config import smoke_config
from repro_torch.distributed.sharding import LOCAL_CTX, ShardingCtx
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.launch import serve as S
from repro_torch.models import model as M
from repro_torch.models.params import params_from_jax

ARCHS = configs.list_archs()
DENSE = [a for a in ARCHS if configs.get_config(a).family == "dense"]
#: compared with f32 activations (see the module docstring)
F32_ARCHS = ("jamba-1.5-large-398b", "moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b",
             "xlstm-350m")
RTOL = ATOL = 2e-2
CPU_TORCH = ShardingCtx(attn_impl="torch")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def activations(monkeypatch):
    """``activations(arch)``: patch both packages' token embedding to f32
    for the archs of :data:`F32_ARCHS`."""
    from repro.models import common as RC
    from repro_torch.models import common as PC

    def use(arch):
        if arch in F32_ARCHS:
            ref_embed, port_embed = RC.embed, PC.embed
            monkeypatch.setattr(RC, "embed",
                                lambda p, t, dtype=None: ref_embed(p, t, jnp.float32))
            monkeypatch.setattr(PC, "embed",
                                lambda p, t, dtype=None: port_embed(p, t, torch.float32))

    return use


_CACHE = {}


def _pair(arch, seed=1):
    """(cfg, reference tree, port model) on the same numbers."""
    key = (arch, seed)
    if key not in _CACHE:
        rcfg = ref_smoke_config(ref_configs.get_config(arch))
        tree = RM.init_params(jax.random.key(seed), rcfg, dtype=jnp.float32)
        tree = jax.tree_util.tree_map(np.asarray, tree)
        cfg = smoke_config(configs.get_config(arch))
        _CACHE[key] = (cfg, rcfg, tree, params_from_jax(tree, cfg, device="cpu"))
    return _CACHE[key]


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _batch(cfg, B, S, seed=0):
    """Tokens, then ``patch_embeds`` and ``frames`` where the arch takes
    them, from one generator (numpy, f32)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    if cfg.encdec:
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _prefix(cfg):
    return cfg.prefix_len if cfg.frontend == "vision_stub" else 0


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _atol(want):
    return ATOL * max(1.0, float(np.abs(want).max()))


def _close(got, want):
    got, want = _f32(got), _f32(want)
    return np.allclose(got, want, rtol=RTOL, atol=_atol(want))


def _err(got, want):
    return float(np.abs(_f32(got) - _f32(want)).max())


def test_configs_are_the_reference_configs():
    assert configs.list_archs() == ref_configs.list_archs()
    for arch in configs.list_archs():
        a, b = configs.get_config(arch), ref_configs.get_config(arch)
        assert repr(a) == repr(b)
        assert repr(smoke_config(a)) == repr(ref_smoke_config(b))
    assert len(DENSE) == 4 and len(ARCHS) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, activations):
    activations(arch)
    cfg, rcfg, tree, model = _pair(arch)
    batch = _batch(cfg, 2, 32)
    want, _, waux = RM.forward(tree, _jnp(batch), rcfg, REF_CTX, mode="train")
    got, caches, aux = M.forward(model, batch, cfg, CPU_TORCH, mode="train")
    assert got.dtype == (torch.float32 if arch in F32_ARCHS else torch.bfloat16)
    assert got.shape == (2, 32 + _prefix(cfg), cfg.vocab_size)
    assert _close(got, want), _err(got, want)
    assert np.isclose(float(aux), float(waux), rtol=RTOL), (float(aux), float(waux))
    assert (float(aux) > 0) == (cfg.num_experts > 0)
    assert caches == {f"layer_{j}": {} for j in range(cfg.group_period)}


def test_reference_forward_differs_from_itself_beyond_the_unscaled_tolerance():
    """Why the absolute tolerance scales with the logits: the reference's
    compiled forward and the same forward op by op already differ by more
    than 2e-2 on qwen2.5-32b's logits of magnitude 4, and stay within the
    scaled tolerance."""
    cfg, rcfg, tree, model = _pair("qwen2.5-32b")
    batch = {"tokens": jnp.asarray(_tokens(cfg, 2, 32))}
    compiled, _, _ = RM.forward(tree, batch, rcfg, REF_CTX, mode="train")
    with jax.disable_jit():
        op_by_op, _, _ = RM.forward(tree, batch, rcfg, REF_CTX, mode="train")
    a, b = _f32(op_by_op), _f32(compiled)
    assert not np.allclose(a, b, rtol=RTOL, atol=ATOL), _err(a, b)
    assert _close(a, b), _err(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference_flash_kernel(arch, activations):
    """A 128-position prefill: the port's kernel path (plain version on
    the CPU) against the reference's Pallas kernel in interpret mode;
    caches (K/V and SSM states) and whisper's encoder memory too.  That
    kernel takes sequences in blocks of 128: paligemma's 8 patch
    positions leave 120 tokens, and whisper's smoke encoder (32 frames)
    takes 128 frames here."""
    activations(arch)
    cfg, rcfg, tree, model = _pair(arch)
    if cfg.encdec:
        cfg = dataclasses.replace(cfg, encoder_seq=128)
        rcfg = dataclasses.replace(rcfg, encoder_seq=128)
    batch = _batch(cfg, 2, 128 - _prefix(cfg), seed=3)
    want, wc = RM.prefill(tree, _jnp(batch), rcfg, RefCtx(attn_impl="pallas"))
    got, gc = M.prefill(model, batch, cfg, ShardingCtx(attn_impl="cuda"))
    assert _close(got, want), _err(got, want)
    if cfg.encdec:
        assert gc["memory"].shape == (2, cfg.encoder_seq, cfg.d_model)
        assert _close(gc["memory"], wc["memory"]), _err(gc["memory"], wc["memory"])
    else:
        assert gc["memory"] is None and wc["memory"] is None
    assert set(gc["stack"]) == set(wc["stack"])
    for name, leaves in wc["stack"].items():
        assert set(gc["stack"][name]) == set(leaves)
        for n, w in leaves.items():
            g = gc["stack"][name][n]
            assert tuple(g.shape) == tuple(w.shape), (name, n)
            if n in ("k", "v"):
                assert g.shape == (cfg.num_groups, 2, 128, cfg.num_kv_heads, cfg.head_dim)
                assert g.dtype == (torch.float32 if arch in F32_ARCHS else torch.bfloat16)
            assert _close(g, w), (name, n, _err(g, w))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """decode_step(t) logits match the full-forward logits at t, as the
    reference's own test has it; the kernel path and the plain path too."""
    cfg, _, _, model = _pair(arch, seed=2)
    B, Sx = 2, 16
    batch = _batch(cfg, B, Sx, seed=4)
    prefix = _prefix(cfg)
    full, _, _ = M.forward(model, batch, cfg, CPU_TORCH, mode="train")
    P0 = Sx - 4
    last, caches = M.prefill(model, dict(batch, tokens=batch["tokens"][:, :P0]), cfg,
                             LOCAL_CTX)
    assert _close(last, full[:, prefix + P0 - 1])
    caches = M.pad_caches(caches, cfg, max_seq=Sx + prefix)
    for leaves in caches["stack"].values():
        for n in ("k", "v"):
            if n in leaves:
                assert leaves[n].shape[2] == Sx + prefix
    for t in range(P0, Sx):
        logits, caches = M.decode_step(model, batch["tokens"][:, t:t + 1], caches,
                                       prefix + t, cfg, LOCAL_CTX)
        want = full[:, prefix + t]
        assert _close(logits, want), (t, _err(logits, want))


def test_decode_from_empty_caches_matches_forward():
    cfg, _, _, model = _pair("qwen2.5-3b", seed=2)
    tokens = _tokens(cfg, 2, 6, seed=5)
    full, _, _ = M.forward(model, {"tokens": tokens}, cfg, CPU_TORCH, mode="train")
    caches = M.init_decode_caches(cfg, 2, 8, device="cpu")
    for t in range(6):
        logits, caches = M.decode_step(model, tokens[:, t:t + 1], caches, t, cfg,
                                       CPU_TORCH)
        assert _close(logits, full[:, t]), (t, _err(logits, full[:, t]))
    assert not caches["stack"]["layer_0"]["k"][:, :, 6:].any()


def _reference_launcher_loop(tree, rcfg, prompts, batch, gen_len, rng):
    """The loop of ``repro/launch/serve.py`` on given parameters, prompts
    and generator (the reference's launcher draws its own and cannot be
    handed any): each batch draws ``patch_embeds`` then ``frames``."""
    prompts = list(prompts)
    prefix = _prefix(rcfg)
    max_seq = prompts[0].shape[0] + gen_len + prefix
    prefill = jax.jit(lambda p, b: RM.prefill(p, b, rcfg, REF_CTX))
    decode = jax.jit(lambda p, t, kv, i: RM.decode_step(p, t, kv, i, rcfg, REF_CTX))
    done, logits_out = [], []
    while prompts:
        batch_prompts = [prompts.pop() for _ in range(min(batch, len(prompts)))]
        while len(batch_prompts) < batch:
            batch_prompts.append(batch_prompts[-1])
        inputs = {"tokens": jnp.asarray(np.stack(batch_prompts))}
        if rcfg.frontend == "vision_stub":
            inputs["patch_embeds"] = jnp.asarray(
                rng.standard_normal((batch, rcfg.prefix_len, rcfg.d_model)), jnp.float32)
        if rcfg.encdec:
            inputs["frames"] = jnp.asarray(
                rng.standard_normal((batch, rcfg.encoder_seq, rcfg.d_model)), jnp.float32)
        logits, caches = prefill(tree, inputs)
        caches = RM.pad_caches(caches, rcfg, max_seq=max_seq)
        toks = jnp.argmax(logits, axis=-1)[:, None]
        outs, kept = [np.asarray(toks)], [_f32(logits)]
        for step in range(gen_len - 1):
            logits, caches = decode(tree, toks, caches,
                                    jnp.int32(batch_prompts[0].shape[0] + prefix + step))
            toks = jnp.argmax(logits, axis=-1)[:, None]
            outs.append(np.asarray(toks))
            kept.append(_f32(logits))
        done.extend(np.concatenate(outs, axis=1)[: len(batch_prompts)])
        logits_out.append(kept)
    return done, logits_out


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_matches_reference_loop(arch, activations):
    activations(arch)
    cfg, rcfg, tree, model = _pair(arch)
    rng_port, rng_ref = np.random.default_rng(0), np.random.default_rng(0)
    # 5 requests: 3 batches of 2, the last padded (yi-6b's smoke logits
    # have so many near ties that 3 requests leave 4 comparable tokens)
    prompts = S.make_prompts(cfg, 5, 24, rng_port)
    assert all(np.array_equal(a, b) for a, b in
               zip(prompts, S.make_prompts(cfg, 5, 24, rng_ref)))
    gen_len = 8
    res = S.serve(model, cfg, LOCAL_CTX, prompts, batch=2, gen_len=gen_len,
                  keep_logits=True, rng=rng_port)
    want_done, want_logits = _reference_launcher_loop(tree, rcfg, prompts, 2, gen_len,
                                                      rng_ref)
    assert len(res.done) == len(want_done) == 6  # last batch padded
    assert res.tokens_out == 6 * gen_len and res.batches == 3
    compared = 0
    for b, (got_b, want_b) in enumerate(zip(res.logits, want_logits)):
        for row in range(2):
            for t in range(gen_len):
                g, w = got_b[t][row], want_b[t][row]
                assert _close(g, w), (b, row, t, _err(g, w))
                top2 = np.sort(w)[-2:]
                if top2[1] - top2[0] <= 2 * _err(g, w):
                    break  # a near tie: later tokens may differ
                assert res.done[2 * b + row][t] == want_done[2 * b + row][t]
                compared += 1
    assert compared >= 8
    for row in res.done:
        assert row.shape == (gen_len,) and row.min() >= 0 and row.max() < cfg.vocab_size


def test_launcher_needs_the_generator_for_frontend_inputs():
    for arch in ("whisper-large-v3", "paligemma-3b"):
        cfg, _, _, model = _pair(arch)
        prompts = S.make_prompts(cfg, 1, 8, 0)
        with pytest.raises(ValueError, match="rng"):
            S.serve(model, cfg, LOCAL_CTX, prompts, batch=1, gen_len=2)


def test_launcher_main_prints_the_reference_lines(capsys):
    S.main(["--device", "cpu", "--requests", "3", "--batch", "2",
            "--gen-len", "4", "--prompt-len", "9"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=qwen2.5-3b-smoke served 4 requests, 16 tokens in")
    assert out[1].startswith("sample: [")


def test_launcher_no_smoke_reaches_the_full_config(monkeypatch):
    seen = []

    def fake_init(seed, cfg, dtype=None, device=None):
        seen.append(cfg)
        raise RuntimeError("stop")

    monkeypatch.setattr(M, "init_params", fake_init)
    for flag, name in (("--smoke", "qwen2.5-3b-smoke"), ("--no-smoke", "qwen2.5-3b")):
        with pytest.raises(RuntimeError, match="stop"):
            S.main(["--device", "cpu", flag])
        assert seen[-1].name == name
    assert seen[-1] == configs.get_config("qwen2.5-3b")


def test_init_params_is_seeded_and_has_the_reference_distributions():
    cfg = smoke_config(configs.get_config("qwen2.5-3b"))
    a = M.init_params(7, cfg, dtype=torch.float32, device="cpu")
    b = M.init_params(7, cfg, dtype=torch.float32, device="cpu")
    c = M.init_params(8, cfg, dtype=torch.float32, device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[n], sb[n]) for n in sa)
    assert not torch.equal(sa["embed.table"], sc["embed.table"])
    rcfg = ref_smoke_config(ref_configs.get_config("qwen2.5-3b"))
    tree = jax.tree_util.tree_map(np.asarray, RM.init_params(jax.random.key(0), rcfg,
                                                             dtype=jnp.float32))
    want = {"embed.table": tree["embed"]["table"]}
    for n in ("wq", "wk", "wv", "wo"):
        want[f"layers.0.attn.{n}.w"] = tree["groups"]["layer_0"]["attn"][n]["w"][0]
    want["layers.0.attn.wq.b"] = tree["groups"]["layer_0"]["attn"]["wq"]["b"][0]
    want["layers.0.ln1.scale"] = tree["groups"]["layer_0"]["ln1"]["scale"][0]
    for n, w in want.items():
        assert sa[n].shape == w.shape
        assert abs(float(sa[n].std()) - float(w.std())) <= 0.15 * float(w.std()) + 1e-6, n
        assert abs(float(sa[n].mean()) - float(w.mean())) <= 0.1 * float(w.std()) + 1e-6, n
    assert M.init_params(7, cfg, device="cpu").embed.table.dtype == torch.bfloat16


def test_params_from_jax_rejects_a_missing_or_misshapen_leaf():
    cfg, _, tree, _ = _pair("qwen2.5-3b")
    bad = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(KeyError, match="final_norm"):
        params_from_jax(bad, cfg, device="cpu")
    bad = dict(tree, embed={"table": tree["embed"]["table"][:-1]})
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(bad, cfg, device="cpu")


def test_mesh_context_raises():
    """A model mesh's dims need names (the rules name mesh axes)."""
    unnamed = type("Mesh", (), {"mesh_dim_names": None})()
    with pytest.raises(ValueError, match="names"):
        ShardingCtx(mesh=unnamed)
    named = type("Mesh", (), {"mesh_dim_names": ("data", "model")})()
    assert ShardingCtx(mesh=named, rules={}).spec("embed", None) == (None, None)


def test_prefill_reaches_the_kernel_wrapper_once_a_layer(monkeypatch):
    cfg, _, _, model = _pair("yi-6b")
    calls = []
    real = K.flash_attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape)))
        return real(q, k, v, **kw)

    monkeypatch.setattr("repro_torch.kernels.flash_attention.ops.flash_attention", spy)
    M.prefill(model, {"tokens": _tokens(cfg, 2, 24)}, cfg, LOCAL_CTX)
    assert calls == [((2, cfg.num_heads, 24, cfg.head_dim),
                      (2, cfg.num_kv_heads, 24, cfg.head_dim))] * cfg.num_layers
    calls.clear()
    M.prefill(model, {"tokens": _tokens(cfg, 2, 24)}, cfg, CPU_TORCH)
    assert not calls
