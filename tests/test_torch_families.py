"""The port's SSM, MoE, encoder and vision-prefix modules against the
reference's functions on the same numpy inputs and parameters.

Tolerances: the chunked recurrence and its decode step are f32 throughout
(rtol 1e-4, atol 1e-5: the state is summed in another order); routing is
exact (``slot``, ``tok``, ``keep`` equal); a block's bf16 output is held
to the LM parity tests' bf16 tolerance (rtol 2e-2, atol 2e-2 x max(1,
max |out|)), and an f32 state downstream of bf16 activations to rtol
1e-3, atol 1e-3 x max(1, max |state|).
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
from repro.models import model as RM
from repro.models import moe as RMOE
from repro.models import ssm as RSSM
from repro_torch import configs
from repro_torch.config import smoke_config
from repro_torch.distributed.sharding import LOCAL_CTX
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.params import _copy, _leaves, _target, params_from_jax

JAMBA, XLSTM, MOONSHOT = "jamba-1.5-large-398b", "xlstm-350m", "moonshot-v1-16b-a3b"
WHISPER, PALIGEMMA, PHI = "whisper-large-v3", "paligemma-3b", "phi3.5-moe-42b-a6.6b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    rcfg = dataclasses.replace(ref_smoke_config(ref_configs.get_config(arch)), **kw)
    cfg = dataclasses.replace(smoke_config(configs.get_config(arch)), **kw)
    return rcfg, cfg


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _bf16_close(got, want):
    got, want = _np(got), _np(want)
    atol = 2e-2 * max(1.0, float(np.abs(want).max()))
    return np.allclose(got, want, rtol=2e-2, atol=atol), float(np.abs(got - want).max())


def _state_close(got, want):
    got, want = _np(got), _np(want)
    atol = 1e-3 * max(1.0, float(np.abs(want).max()))
    return np.allclose(got, want, rtol=1e-3, atol=atol), float(np.abs(got - want).max())


def _load(module, tree):
    named = dict(module.named_parameters())
    for path, arr in _leaves(tree):
        _copy(_target(named, path), arr, path)
    return module


def _pair_bf16(x):
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


# ------------------------------------------------------------ the SSM core
@pytest.mark.parametrize("S", [37, 48])
@pytest.mark.parametrize("with_h0", [False, True])
def test_chunked_linear_rnn_matches_reference(S, with_h0):
    rng = np.random.default_rng(S)
    B, H, N, P = 2, 3, 8, 5
    q, k = rng.standard_normal((2, B, S, H, N)).astype(np.float32)
    v = rng.standard_normal((B, S, H, P)).astype(np.float32)
    ld = (-0.3 * np.abs(rng.standard_normal((B, S, H)))).astype(np.float32)
    sc = rng.random((B, S, H)).astype(np.float32)
    h0 = rng.standard_normal((B, H, N, P)).astype(np.float32) if with_h0 else None
    ref = jax.jit(RSSM.chunked_linear_rnn, static_argnums=5)
    wy, wh = ref(*map(jnp.asarray, (q, k, v, ld, sc)), 16,
                 None if h0 is None else jnp.asarray(h0))
    gy, gh = SSM.chunked_linear_rnn(*map(torch.from_numpy, (q, k, v, ld, sc)), 16,
                                    None if h0 is None else torch.from_numpy(h0))
    assert gy.shape == (B, S, H, P) and gh.shape == (B, H, N, P)
    assert gh.dtype == torch.float32
    np.testing.assert_allclose(_np(gy), _np(wy), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(gh), _np(wh), rtol=1e-4, atol=1e-5)
    # one decode step from that state
    q1, k1 = rng.standard_normal((2, B, H, N)).astype(np.float32)
    v1 = rng.standard_normal((B, H, P)).astype(np.float32)
    ld1, sc1 = ld[:, 0], sc[:, 0]
    wy1, wh1 = RSSM.linear_rnn_step(*map(jnp.asarray, (q1, k1, v1, ld1, sc1)), wh)
    gy1, gh1 = SSM.linear_rnn_step(*map(torch.from_numpy, (q1, k1, v1, ld1, sc1)), gh)
    np.testing.assert_allclose(_np(gy1), _np(wy1), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(gh1), _np(wh1), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference_bitwise(with_state):
    """bf16 taps summed op by op, as the reference sums them."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 32)).astype(np.float32)
    w = rng.standard_normal((4, 32)).astype(np.float32)
    st = rng.standard_normal((2, 3, 32)).astype(np.float32) if with_state else None
    xj, xt = _pair_bf16(x)
    wo, ws = RSSM._causal_conv(xj, jnp.asarray(w),
                               None if st is None else jnp.asarray(st, jnp.bfloat16))
    st_t = None if st is None else torch.from_numpy(st).to(torch.bfloat16)
    go, gs = SSM._causal_conv(xt, torch.from_numpy(w), st_t)
    assert np.array_equal(_np(go), _np(wo)) and np.array_equal(_np(gs), _np(ws))
    assert gs.shape == (2, 3, 32) and gs.dtype == torch.bfloat16


_BLOCKS = [(JAMBA, "ssd", SSM.SSD), (XLSTM, "mlstm", SSM.MLSTM),
           (XLSTM, "slstm", SSM.SLSTM)]


@pytest.mark.parametrize("arch,kind,cls", _BLOCKS)
def test_ssm_blocks_prefill_and_decode_match_reference(arch, kind, cls):
    """A ragged prefill (S=21, chunk 16), then one decode step from each
    package's own state, on the same bf16 inputs."""
    rcfg, cfg = _cfgs(arch)
    tree = jax.tree_util.tree_map(
        np.asarray, getattr(RSSM, f"{kind}_init")(jax.random.key(3), rcfg))
    block = _load(cls(cfg, device="cpu"), tree)
    ref_block = getattr(RSSM, f"{kind}_block")
    ref_fn = jax.jit(lambda t, x, state=None: ref_block(t, x, rcfg, REF_CTX, state=state))
    port_fn = getattr(SSM, f"{kind}_block")
    rng = np.random.default_rng(2)
    xj, xt = _pair_bf16(rng.standard_normal((2, 21, cfg.d_model)).astype(np.float32))
    wy, wst = ref_fn(tree, xj)
    gy, gst = port_fn(block, xt, cfg, LOCAL_CTX)
    assert gy.dtype == torch.bfloat16 and gy.shape == (2, 21, cfg.d_model)
    ok, err = _bf16_close(gy, wy)
    assert ok, err
    assert set(gst) == set(wst)
    for n in wst:
        assert tuple(gst[n].shape) == tuple(wst[n].shape), n
        ok, err = _state_close(gst[n], wst[n])
        assert ok, (n, err)
    # decode one token from the prefill's state; zero states match the
    # reference's state_init
    zr = getattr(RSSM, f"{kind}_state_init")(rcfg, 2)
    zp = getattr(SSM, f"{kind}_state_init")(cfg, 2, device="cpu")
    assert {n: (tuple(t.shape), str(t.dtype).split(".")[-1]) for n, t in zp.items()} == \
        {n: (tuple(t.shape), str(t.dtype)) for n, t in zr.items()}
    x1j, x1t = _pair_bf16(rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32))
    wy1, wst1 = ref_fn(tree, x1j, wst)
    gy1, gst1 = port_fn(block, x1t, cfg, LOCAL_CTX, state=gst)
    ok, err = _bf16_close(gy1, wy1)
    assert ok, err
    for n in wst1:
        ok, err = _state_close(gst1[n], wst1[n])
        assert ok, (n, err)


# --------------------------------------------------------------------- MoE
@pytest.mark.parametrize("capacity_factor", [16.0, 1.0])
@pytest.mark.parametrize("arch", [MOONSHOT, PHI])
def test_moe_routing_is_the_reference_routing(arch, capacity_factor):
    """slot, tok and keep equal the reference's exactly; at capacity factor
    1.0 tokens are dropped (and land in the drop bin)."""
    rcfg, cfg = _cfgs(arch, capacity_factor=capacity_factor)
    rng = np.random.default_rng(4)
    B, S = 3, 64
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((cfg.d_model, cfg.num_experts)).astype(np.float32)
    xj, xt = _pair_bf16(x)
    cap = MOE._capacity(S, cfg)
    assert cap == RMOE._capacity(S, rcfg)
    slot, tok, keep, gates, aux, _ = MOE._dispatch(xt, torch.from_numpy(w), cfg, cap)
    for b in range(B):
        ws, wt, wk, wg, wa = RMOE._dispatch_row(xj[b], jnp.asarray(w), rcfg, cap)
        assert np.array_equal(slot[b].numpy(), np.asarray(ws))
        assert np.array_equal(tok[b].numpy(), np.asarray(wt))
        assert np.array_equal(keep[b].numpy(), np.asarray(wk))
        np.testing.assert_allclose(gates[b].numpy(), np.asarray(wg), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(aux[b]), float(wa), rtol=1e-5)
    dropped = int((~keep).sum())
    assert (dropped > 0) == (capacity_factor == 1.0), dropped
    E = cfg.num_experts
    assert bool((slot[~keep] == E * cap).all()) and bool((slot[keep] < E * cap).all())


@pytest.mark.parametrize("capacity_factor", [16.0, 1.0])
@pytest.mark.parametrize("arch", [MOONSHOT, PHI, WHISPER])
def test_moe_ffn_matches_reference(arch, capacity_factor):
    """The expert FFN, dropless and dropping (whisper's config with 8
    experts stands for the gelu arm); bf16 in and out."""
    kw = dict(capacity_factor=capacity_factor)
    if arch == WHISPER:
        kw.update(num_experts=8, top_k=2)
    rcfg, cfg = _cfgs(arch, **kw)
    tree = jax.tree_util.tree_map(np.asarray, RMOE.moe_init(jax.random.key(5), rcfg))
    moe = _load(MOE.MoE(cfg, device="cpu"), tree)
    assert (moe.wg is None) == (cfg.mlp_type == "gelu")
    xj, xt = _pair_bf16(np.random.default_rng(6).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32))
    wy, waux = jax.jit(lambda t, x: RMOE.moe_ffn(t, x, rcfg, REF_CTX))(tree, xj)
    gy, gaux = MOE.moe_ffn(moe, xt, cfg, LOCAL_CTX)
    assert gy.dtype == torch.bfloat16 and gy.shape == xt.shape
    ok, err = _bf16_close(gy, wy)
    assert ok, err
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-5)


# --------------------------------------------------- encoder, vision prefix
def _model_pair(arch, seed=1):
    rcfg, cfg = _cfgs(arch)
    tree = jax.tree_util.tree_map(
        np.asarray, RM.init_params(jax.random.key(seed), rcfg, dtype=jnp.float32))
    return rcfg, cfg, tree, params_from_jax(tree, cfg, device="cpu")


def test_encode_matches_reference():
    rcfg, cfg, tree, model = _model_pair(WHISPER)
    frames = np.random.default_rng(7).standard_normal(
        (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    want = jax.jit(lambda t, b: RM._encode(t, b, rcfg, REF_CTX))(
        tree, {"frames": jnp.asarray(frames)})
    got = M._encode(model, {"frames": frames}, cfg, LOCAL_CTX)
    assert got.dtype == torch.bfloat16 and got.shape == (2, cfg.encoder_seq, cfg.d_model)
    ok, err = _bf16_close(got, want)
    assert ok, err
    pos = M.C.sinusoidal_positions(cfg.encoder_seq, cfg.d_model)
    from repro.models import common as RC
    assert np.array_equal(pos.numpy(), np.asarray(RC.sinusoidal_positions(
        cfg.encoder_seq, cfg.d_model)))


def test_vision_prefix_matches_reference():
    """patch_embeds prefix the token embeddings, and the whole sequence
    takes the gemma-family sqrt(d) scale: bitwise the reference's."""
    rcfg, cfg, tree, model = _model_pair(PALIGEMMA)
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    patches = rng.standard_normal((2, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    wx, wp = RM._embed_inputs(tree, {"tokens": jnp.asarray(tokens),
                                     "patch_embeds": jnp.asarray(patches)}, rcfg, REF_CTX)
    gx, gp = M._embed_inputs(model, {"tokens": tokens, "patch_embeds": patches},
                             cfg, LOCAL_CTX)
    assert gx.shape == (2, cfg.prefix_len + 12, cfg.d_model)
    assert np.array_equal(_np(gx), _np(wx))
    assert np.array_equal(gp.numpy(), np.asarray(wp))


# ------------------------------------------------------------------- caches
@pytest.mark.parametrize("arch", [JAMBA, XLSTM, WHISPER])
def test_decode_caches_have_the_reference_layout(arch):
    rcfg, cfg = _cfgs(arch)
    want = RM.init_decode_caches(rcfg, 2, 24)
    got = M.init_decode_caches(cfg, 2, 24, device="cpu")
    shapes = lambda tree: {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                           for k, v in tree.items()}
    assert set(got["stack"]) == set(want["stack"]) == {
        f"layer_{j}" for j in range(cfg.group_period)}
    for name in want["stack"]:
        assert shapes(got["stack"][name]) == shapes(want["stack"][name]), name
        assert not any(t.any() for t in got["stack"][name].values())
    if cfg.encdec:
        assert tuple(got["memory"].shape) == tuple(want["memory"].shape)
    else:
        assert got["memory"] is None and want["memory"] is None


@pytest.mark.parametrize("arch", [JAMBA, XLSTM])
def test_pad_caches_grows_only_kv(arch):
    """pad_caches on a prefill's stack: the 5-D k/v leaves grow to max_seq
    with zeros into the reference's decode layout, SSM and conv states
    (the 5-D ``h`` too) pass through."""
    rcfg, cfg = _cfgs(arch)
    model = M.init_params(0, cfg, dtype=torch.float32, device="cpu")
    tokens = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    _, caches = M.prefill(model, {"tokens": tokens}, cfg, LOCAL_CTX)
    padded = M.pad_caches(caches, cfg, max_seq=16)
    want = RM.init_decode_caches(rcfg, 2, 16)["stack"]
    for name, leaves in padded["stack"].items():
        for n, t in leaves.items():
            assert tuple(t.shape) == tuple(want[name][n].shape), (name, n)
            before = caches["stack"][name][n]
            if n in ("k", "v"):
                assert t.shape[2] == 16 and not t[:, :, 10:].any()
                assert torch.equal(t[:, :, :10], before)
            else:
                assert t is before
    assert any("h" in leaves for leaves in padded["stack"].values())


# ----------------------------------------------------------- params_from_jax
def test_params_from_jax_maps_groups_and_the_encoder():
    """Group g of ``layer_j`` lands in ``layers[g * period + j]``; the
    encoder's groups in ``encoder.layers``."""
    rcfg, cfg, tree, model = _model_pair(JAMBA)
    P = cfg.group_period
    assert P == 8 and len(model.layers) == 2 * P
    for g in range(2):
        for j in range(P):
            layer = model.layers[g * P + j]
            sub = tree["groups"][f"layer_{j}"]
            mixer, mlp_kind = cfg.layer_kind(j)
            name = "attn" if mixer == "attn" else mixer
            assert hasattr(layer, name) and hasattr(layer, "moe") == (mlp_kind == "moe")
            leaf = sub["attn"]["wq"]["w"] if mixer == "attn" else sub["ssd"]["in_proj"]["w"]
            got = layer.attn.wq.w if mixer == "attn" else layer.ssd.in_proj.w
            assert np.array_equal(got.numpy(), leaf[g])
            if mlp_kind == "moe":
                assert np.array_equal(layer.moe.wg.numpy(), sub["moe"]["wg"][g])
    _, wcfg, wtree, whisper = _model_pair(WHISPER)
    enc = wtree["encoder"]["groups"]["layer_0"]
    for i, blk in enumerate(whisper.encoder.layers):
        assert np.array_equal(blk.mlp.wu.b.numpy(), enc["mlp"]["wu"]["b"][i])
        assert not hasattr(blk, "xattn")
    assert hasattr(whisper.layers[0], "xattn")
    assert np.array_equal(whisper.encoder.final_norm.scale.numpy(),
                          wtree["encoder"]["final_norm"]["scale"])


def test_params_from_jax_rejects_bad_grouped_trees():
    rcfg, cfg, tree, _ = _model_pair(JAMBA)
    groups = dict(tree["groups"])
    groups["layer_8"] = groups.pop("layer_7")  # no layer 8 in a group of 8
    with pytest.raises(KeyError, match="layer_8"):
        params_from_jax(dict(tree, groups=groups), cfg, device="cpu")
    groups = dict(tree["groups"])
    del groups["layer_3"]
    with pytest.raises(KeyError, match="layers.3.ssd"):
        params_from_jax(dict(tree, groups=groups), cfg, device="cpu")
    one = jax.tree_util.tree_map(lambda a: a[:1], tree["groups"])
    with pytest.raises(ValueError, match="1 groups, 2"):
        params_from_jax(dict(tree, groups=one), cfg, device="cpu")
    _, wcfg, wtree, _ = _model_pair(WHISPER)
    bad = dict(wtree, encoder={"groups": wtree["encoder"]["groups"]})
    with pytest.raises(KeyError, match="encoder.final_norm"):
        params_from_jax(bad, wcfg, device="cpu")
    enc = jax.tree_util.tree_map(lambda a: a[:1], wtree["encoder"]["groups"])
    bad = dict(wtree, encoder=dict(wtree["encoder"], groups=enc))
    with pytest.raises(ValueError, match="groups"):
        params_from_jax(bad, wcfg, device="cpu")
