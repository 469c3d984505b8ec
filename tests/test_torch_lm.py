"""The port's dense LM serving path against the reference on the same
parameters: the reference's parameter tree (``smoke_config`` of every dense
arch) is loaded into the port with ``params_from_jax``.

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
"""

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

DENSE = [a for a in configs.list_archs()
         if configs.get_config(a).family == "dense"]
OTHER = [a for a in configs.list_archs() if a not in DENSE]
RTOL = ATOL = 2e-2
CPU_TORCH = ShardingCtx(attn_impl="torch")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    assert len(DENSE) == 4


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_reference(arch):
    cfg, rcfg, tree, model = _pair(arch)
    tokens = _tokens(cfg, 2, 32)
    want, _, _ = RM.forward(tree, {"tokens": jnp.asarray(tokens)}, rcfg, REF_CTX,
                            mode="train")
    got, caches, aux = M.forward(model, {"tokens": tokens}, cfg, CPU_TORCH,
                                 mode="train")
    assert got.dtype == torch.bfloat16 and got.shape == (2, 32, cfg.vocab_size)
    assert _close(got, want), _err(got, want)
    assert float(aux) == 0.0 and caches == {"layer_0": {}}


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


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_matches_reference_flash_kernel(arch):
    """S=128 prefill: the port's kernel path (plain version on the CPU)
    against the reference's Pallas kernel in interpret mode; caches too."""
    cfg, rcfg, tree, model = _pair(arch)
    tokens = _tokens(cfg, 2, 128, seed=3)
    want, wc = RM.prefill(tree, {"tokens": jnp.asarray(tokens)}, rcfg,
                          RefCtx(attn_impl="pallas"))
    got, gc = M.prefill(model, {"tokens": tokens}, cfg, ShardingCtx(attn_impl="cuda"))
    assert _close(got, want), _err(got, want)
    assert gc["memory"] is None and wc["memory"] is None
    for n in ("k", "v"):
        g, w = gc["stack"]["layer_0"][n], wc["stack"]["layer_0"][n]
        assert g.shape == w.shape == (cfg.num_layers, 2, 128, cfg.num_kv_heads,
                                      cfg.head_dim)
        assert g.dtype == torch.bfloat16
        assert _close(g, w), (n, _err(g, w))


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_consistency(arch):
    """decode_step(t) logits match the full-forward logits at t, as the
    reference's own test has it; the kernel path and the plain path too."""
    cfg, _, _, model = _pair(arch, seed=2)
    B, Sx = 2, 16
    tokens = _tokens(cfg, B, Sx, seed=4)
    full, _, _ = M.forward(model, {"tokens": tokens}, cfg, CPU_TORCH, mode="train")
    P0 = Sx - 4
    last, caches = M.prefill(model, {"tokens": tokens[:, :P0]}, cfg, LOCAL_CTX)
    assert _close(last, full[:, P0 - 1])
    caches = M.pad_caches(caches, cfg, max_seq=Sx)
    assert caches["stack"]["layer_0"]["k"].shape[2] == Sx
    for t in range(P0, Sx):
        logits, caches = M.decode_step(model, tokens[:, t:t + 1], caches, t, cfg,
                                       LOCAL_CTX)
        assert _close(logits, full[:, t]), (t, _err(logits, full[:, t]))


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


def _reference_launcher_loop(tree, rcfg, prompts, batch, gen_len):
    """The loop of ``repro/launch/serve.py`` on given parameters and prompts
    (the reference's launcher draws its own and cannot be handed any)."""
    prompts = list(prompts)
    max_seq = prompts[0].shape[0] + gen_len
    prefill = jax.jit(lambda p, b: RM.prefill(p, b, rcfg, REF_CTX))
    decode = jax.jit(lambda p, t, kv, i: RM.decode_step(p, t, kv, i, rcfg, REF_CTX))
    done, logits_out = [], []
    while prompts:
        batch_prompts = [prompts.pop() for _ in range(min(batch, len(prompts)))]
        while len(batch_prompts) < batch:
            batch_prompts.append(batch_prompts[-1])
        logits, caches = prefill(tree, {"tokens": jnp.asarray(np.stack(batch_prompts))})
        caches = RM.pad_caches(caches, rcfg, max_seq=max_seq)
        toks = jnp.argmax(logits, axis=-1)[:, None]
        outs, kept = [np.asarray(toks)], [_f32(logits)]
        for step in range(gen_len - 1):
            logits, caches = decode(tree, toks, caches,
                                    jnp.int32(batch_prompts[0].shape[0] + step))
            toks = jnp.argmax(logits, axis=-1)[:, None]
            outs.append(np.asarray(toks))
            kept.append(_f32(logits))
        done.extend(np.concatenate(outs, axis=1)[: len(batch_prompts)])
        logits_out.append(kept)
    return done, logits_out


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma-7b"])
def test_launcher_matches_reference_loop(arch):
    cfg, rcfg, tree, model = _pair(arch)
    prompts = S.make_prompts(cfg, 3, 24, seed=0)
    gen_len = 8
    res = S.serve(model, cfg, LOCAL_CTX, prompts, batch=2, gen_len=gen_len,
                  keep_logits=True)
    want_done, want_logits = _reference_launcher_loop(tree, rcfg, prompts, 2, gen_len)
    assert len(res.done) == len(want_done) == 4  # last batch padded
    assert res.tokens_out == 4 * gen_len and res.batches == 2
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


@pytest.mark.parametrize("arch", OTHER)
def test_other_families_raise(arch):
    cfg = smoke_config(configs.get_config(arch))
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        M.init_params(0, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        M.init_decode_caches(cfg, 1, 4, device="cpu")


def test_mesh_context_raises():
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        ShardingCtx(mesh=object())


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
