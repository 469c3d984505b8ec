"""State-space / recurrent mixers: SSD (Mamba-2 style) and xLSTM blocks.

The port of ``repro/models/ssm.py``.  One shared primitive,

    y_t = q_t . h_t        h_t = a_t * h_{t-1} + s_t * (k_t v_t^T)

with per-head scalar decay ``a_t`` and input scale ``s_t``, evaluated in
the chunked SSD form: within a chunk as causal-masked matmuls, across
chunks by carrying the ``[B, H, N, P]`` state.  The reference carries it
with ``jax.lax.associative_scan``; here a loop over the chunks does, in
f32 (the same state, summed in another order).  The mLSTM reuses the core
with sigmoid gates and a ones column appended to V for its normaliser;
the sLSTM is a loop over time steps, as the reference's ``lax.scan`` is.

No Pallas kernel is reached here in the reference, and none here: the
einsums, the conv and the gates are plain PyTorch.  Each block is an
``nn.Module`` of parameters (the reference's pytree keys) and a function.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from ..distributed.sharding import (ShardingCtx, fsdp_gather, grad_as_placed,
                                    is_dtensor, loop_reckoner, on_local_shards,
                                    whole_heads)
from . import common as C

__all__ = ["chunked_linear_rnn", "linear_rnn_step", "SSD", "ssd_block",
           "ssd_state_init", "MLSTM", "mlstm_block", "mlstm_state_init",
           "SLSTM", "slstm_block", "slstm_state_init", "ssd_specs", "mlstm_specs",
           "slstm_specs"]


# ----------------------------------------------------------- chunked core
def chunked_linear_rnn(
    q: torch.Tensor,  # [B, S, H, N]
    k: torch.Tensor,  # [B, S, H, N]
    v: torch.Tensor,  # [B, S, H, P]
    log_decay: torch.Tensor,  # [B, S, H]  (log a_t, <= 0)
    in_scale: torch.Tensor,  # [B, S, H]  (s_t)
    chunk: int,
    h0: Optional[torch.Tensor] = None,  # [B, H, N, P]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B,S,H,P] in v's dtype, h_final [B,H,N,P] f32).  Under a
    model mesh each rank runs it on its own batch rows and heads."""
    if is_dtensor(v):
        args = (v, q, k, log_decay, in_scale) + ((h0,) if h0 is not None else ())
        return on_local_shards(
            lambda v, q, k, ld, s, *h: chunked_linear_rnn(q, k, v, ld, s, chunk,
                                                          *h),
            args, (2, 2, 2, 2, 2, 1)[:len(args)], (2, 1))
    B, S, H, N = q.shape
    P = v.shape[-1]
    if S % chunk:
        # Pad to a chunk multiple with inert steps: decay=1 (log 0) and
        # in_scale=0 leave the state untouched; padded outputs are dropped.
        pad = chunk - S % chunk
        padf = lambda a: F.pad(a, [0, 0] * (a.dim() - 2) + [0, pad])
        y, h = chunked_linear_rnn(padf(q), padf(k), padf(v), padf(log_decay),
                                  padf(in_scale), chunk, h0)
        return y[:, :S], h
    nc, Q = S // chunk, chunk
    qc = q.reshape(B, nc, Q, H, N).float()
    kc = k.reshape(B, nc, Q, H, N).float()
    vc = v.reshape(B, nc, Q, H, P).float()
    ld = log_decay.reshape(B, nc, Q, H).float()
    sc = in_scale.reshape(B, nc, Q, H).float()

    L = torch.cumsum(ld, dim=2)  # [B,nc,Q,H] inclusive within-chunk log decay

    # ---- intra-chunk: causal masked matmuls
    smat = torch.einsum("bcqhn,bcjhn->bchqj", qc, kc)  # [B,nc,H,Q,Q]
    dl = L[:, :, :, None, :] - L[:, :, None, :, :]  # [B,nc,Q(i),Q(j),H]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=q.device).tril()
    gamma = torch.where(causal[None, None, :, :, None], torch.exp(dl), 0.0)
    w = (smat
         * gamma.permute(0, 1, 4, 2, 3)  # [B,nc,H,Q,Q]
         * sc.permute(0, 1, 3, 2)[:, :, :, None, :])  # s_j on the j axis
    y_intra = torch.einsum("bchqj,bcjhp->bcqhp", w, vc)

    # ---- per-chunk input state + decay to the chunk end
    to_end = torch.exp(L[:, :, -1:, :] - L)  # [B,nc,Q,H]
    u = torch.einsum("bcjhn,bcjhp->bchnp", kc * (sc * to_end)[..., None], vc)
    alpha = torch.exp(L[:, :, -1, :])  # [B,nc,H]

    # ---- inter-chunk state carry (the reference's associative scan)
    h = (torch.zeros((B, H, N, P), dtype=torch.float32, device=q.device)
         if h0 is None else h0.float())
    starts = []
    for c in range(nc):
        starts.append(h)
        h = alpha[:, c, :, None, None] * h + u[:, c]
    h_start = torch.stack(starts, dim=1)  # [B,nc,H,N,P]

    y_inter = torch.einsum("bcqhn,bchnp->bcqhp", qc * torch.exp(L)[..., None],
                           h_start)
    y = (y_intra + y_inter).reshape(B, S, H, P)
    return y.to(v.dtype), h


def linear_rnn_step(q, k, v, log_decay, in_scale, h):
    """Single decode step of the same recurrence: q/k ``[B,H,N]``, v
    ``[B,H,P]``, scalars ``[B,H]``, h ``[B,H,N,P]`` f32.  Under a model
    mesh each rank runs it on its own batch rows and heads of ``h`` (the
    einsum's merge of a split batch and head dim has no DTensor rule on
    PyTorch 2.11)."""
    if is_dtensor(h):
        return on_local_shards(
            lambda h, q, k, v, ld, s: linear_rnn_step(q, k, v, ld, s, h),
            (h, q, k, v, log_decay, in_scale), (1,) * 6, (1, 1))
    a = torch.exp(log_decay.float())[..., None, None]
    h = a * h + in_scale.float()[..., None, None] * torch.einsum(
        "bhn,bhp->bhnp", k.float(), v.float())
    y = torch.einsum("bhn,bhnp->bhp", q.float(), h)
    return y.to(v.dtype), h


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv, kernel 4.  x: [B,S,di]; state: [B,3,di]."""
    if state is None:
        pad = torch.zeros((x.shape[0], w.shape[0] - 1, x.shape[-1]),
                          dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i].to(x.dtype) for i in range(w.shape[0]))
    new_state = xp[:, -(w.shape[0] - 1):]
    return out, new_state


def _vec(fill, n: int, *, device, dtype) -> nn.Parameter:
    return C.param(torch.full((n,), fill, dtype=dtype, device=device))


# ------------------------------------------------------------- SSD block
class SSD(nn.Module):
    def __init__(self, cfg: ModelConfig, *, gen: Optional[torch.Generator] = None,
                 device, dtype=torch.float32):
        super().__init__()
        d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
        H = di // cfg.ssm_head_dim
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.in_proj = C.Linear(d, 2 * di, **kw)  # -> (x, z gate)
        self.conv_w = C.param(C.he_init(gen, (4, di), 4, device=device, dtype=dtype))
        self.bc_proj = C.Linear(d, 2 * N, **kw)  # shared B, C (1 group)
        self.dt_proj = C.Linear(d, H, **kw)
        self.dt_bias = _vec(0.0, H, device=device, dtype=dtype)
        self.a_log = _vec(0.0, H, device=device, dtype=dtype)  # A = -exp(a_log)
        self.d_skip = _vec(1.0, H, device=device, dtype=dtype)
        self.out_proj = C.Linear(di, d, **kw)


def ssd_specs(cfg: ModelConfig) -> dict:
    return {
        "in_proj": C.linear_specs("embed", "inner"),
        "conv_w": (None, "inner"),
        "bc_proj": C.linear_specs("embed", None),
        "dt_proj": C.linear_specs("embed", None),
        "dt_bias": (None,),
        "a_log": (None,),
        "d_skip": (None,),
        "out_proj": C.linear_specs("inner", "embed"),
    }


def ssd_block(params: SSD, x: torch.Tensor, cfg: ModelConfig, ctx: ShardingCtx,
              state: Optional[dict] = None):
    """x [B,S,d]; ``state`` (decode) ``{"h": [B,H,N,P], "conv": [B,3,di]}``.
    Returns (out [B,S,d], new_state)."""
    B, S, d = x.shape
    di, N, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    H = di // P
    xz = ctx.ac(C.linear(params.in_proj, x), "batch", None, "inner")
    xin, z = xz.chunk(2, dim=-1)
    conv_state = state["conv"] if state is not None else None
    xin, new_conv = _causal_conv(xin, fsdp_gather(params.conv_w), conv_state)
    xin = C.silu(xin)

    bc = C.linear(params.bc_proj, x).float()  # [B,S,2N]
    b_t, c_t = bc.chunk(2, dim=-1)
    dt = F.softplus(C.linear(params.dt_proj, x).float()
                    + fsdp_gather(params.dt_bias))  # [B,S,H]
    a = -torch.exp(fsdp_gather(params.a_log))  # [H]
    log_decay = dt * a  # [B,S,H]

    xh = whole_heads(xin, H).reshape(B, S, H, P)
    v = xh * dt[..., None].to(xh.dtype)  # fold dt into input
    qN = c_t[:, :, None, :].expand(B, S, H, N)
    kN = b_t[:, :, None, :].expand(B, S, H, N)

    if state is None:
        y, h = chunked_linear_rnn(qN, kN, v, log_decay, torch.ones_like(log_decay),
                                  cfg.ssm_chunk)
    else:
        yv, h = linear_rnn_step(qN[:, 0], kN[:, 0], v[:, 0], log_decay[:, 0],
                                torch.ones_like(log_decay[:, 0]), state["h"])
        y = yv[:, None]

    y = y + xh * fsdp_gather(params.d_skip)[None, None, :, None].to(y.dtype)
    y = y.reshape(B, S, di) * C.silu(z)
    return C.linear(params.out_proj, y), {"h": h, "conv": new_conv}


def ssd_state_init(cfg: ModelConfig, batch: int, dtype=torch.float32, *,
                   device) -> dict:
    di, N, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    return {"h": torch.zeros((batch, di // P, N, P), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, 3, di), dtype=dtype, device=device)}


# ------------------------------------------------------------ mLSTM block
class MLSTM(nn.Module):
    def __init__(self, cfg: ModelConfig, *, gen: Optional[torch.Generator] = None,
                 device, dtype=torch.float32):
        super().__init__()
        d, di, H = cfg.d_model, cfg.d_inner, cfg.num_heads
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.in_proj = C.Linear(d, 2 * di, **kw)  # -> (x, z gate)
        self.conv_w = C.param(C.he_init(gen, (4, di), 4, device=device, dtype=dtype))
        self.wq = C.Linear(di, di, **kw)
        self.wk = C.Linear(di, di, **kw)
        self.wv = C.Linear(di, di, **kw)
        self.w_if = C.Linear(di, 2 * H, bias=True, **kw)  # input/forget gates
        self.gn_scale = _vec(1.0, di, device=device, dtype=dtype)
        self.out_proj = C.Linear(di, d, **kw)


def mlstm_specs(cfg: ModelConfig) -> dict:
    return {
        "in_proj": C.linear_specs("embed", "inner"),
        "conv_w": (None, "inner"),
        # [di, di] square projections: shard the OUTPUT dim only (mapping
        # both dims to the TP axis would name one mesh axis twice)
        "wq": C.linear_specs(None, "inner"),
        "wk": C.linear_specs(None, "inner"),
        "wv": C.linear_specs(None, "inner"),
        "w_if": C.linear_specs("inner", None, bias=True),
        "gn_scale": ("inner",),
        "out_proj": C.linear_specs("inner", "embed"),
    }


def _headwise_rms(x: torch.Tensor, scale: torch.Tensor, H: int) -> torch.Tensor:
    """Group norm over each head's channels (xLSTM uses GN post-cell)."""
    B, S, di = x.shape
    xh = whole_heads(x, H).reshape(B, S, H, di // H).float()
    var = (xh * xh).mean(dim=-1, keepdim=True)
    xh = xh * torch.rsqrt(var + 1e-6)
    # the gradient comes split along di: whole heads before it is viewed
    return (grad_as_placed(xh.reshape(B, S, di)) * scale).to(x.dtype)


def mlstm_block(params: MLSTM, x: torch.Tensor, cfg: ModelConfig,
                ctx: ShardingCtx, state: Optional[dict] = None):
    """x [B,S,d]; ``state`` (decode) ``{"h": [B,H,P,P+1], "conv": [B,3,di]}``."""
    B, S, d = x.shape
    di, H = cfg.d_inner, cfg.num_heads
    P = di // H
    xz = ctx.ac(C.linear(params.in_proj, x), "batch", None, "inner")
    xin, z = xz.chunk(2, dim=-1)
    conv_state = state["conv"] if state is not None else None
    xc, new_conv = _causal_conv(xin, fsdp_gather(params.conv_w), conv_state)
    xc = C.silu(xc)

    q = whole_heads(C.linear(params.wq, xc), H).reshape(B, S, H, P) * (P ** -0.5)
    k = whole_heads(C.linear(params.wk, xc), H).reshape(B, S, H, P)
    v = whole_heads(C.linear(params.wv, xin), H).reshape(B, S, H, P)
    gates = C.linear(params.w_if, xc).float()  # [B,S,2H]
    i_g = torch.sigmoid(gates[..., :H])
    f_g = torch.sigmoid(gates[..., H:] + 3.0)  # forget bias -> long memory
    log_decay = torch.log(f_g + 1e-9)

    # normaliser: append a ones column to v -> last channel accumulates i*k.q
    v_ext = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    if state is None:
        y_ext, h = chunked_linear_rnn(q, k, v_ext, log_decay, i_g, cfg.ssm_chunk)
    else:
        y1, h = linear_rnn_step(q[:, 0], k[:, 0], v_ext[:, 0], log_decay[:, 0],
                                i_g[:, 0], state["h"])
        y_ext = y1[:, None]
    num, den = y_ext[..., :P], y_ext[..., P:]
    y = num / torch.clamp(den.abs(), min=1.0)
    y = _headwise_rms(y.reshape(B, S, di), fsdp_gather(params.gn_scale), H)
    y = y * C.silu(z)
    return C.linear(params.out_proj, y), {"h": h, "conv": new_conv}


def mlstm_state_init(cfg: ModelConfig, batch: int, dtype=torch.float32, *,
                     device) -> dict:
    di, H = cfg.d_inner, cfg.num_heads
    P = di // H
    return {"h": torch.zeros((batch, H, P, P + 1), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, 3, di), dtype=dtype, device=device)}


# ------------------------------------------------------------ sLSTM block
class SLSTM(nn.Module):
    def __init__(self, cfg: ModelConfig, *, gen: Optional[torch.Generator] = None,
                 device, dtype=torch.float32):
        super().__init__()
        d, di, H = cfg.d_model, cfg.d_inner, cfg.num_heads
        P = di // H
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.in_proj = C.Linear(d, di, **kw)
        self.w_gates = C.Linear(di, 4 * di, bias=True, **kw)
        # block-diagonal recurrent weights, a [P, 4P] block a head
        self.r_gates = C.param(C.he_init(gen, (H, P, 4 * P), P, device=device,
                                         dtype=dtype))
        self.out_proj = C.Linear(di, d, **kw)


def slstm_specs(cfg: ModelConfig) -> dict:
    return {
        "in_proj": C.linear_specs("embed", "inner"),
        # square gate projection: shard the output dim only (see mlstm_specs)
        "w_gates": C.linear_specs(None, "inner", bias=True),
        "r_gates": (None, None, None),
        "out_proj": C.linear_specs("inner", "embed"),
    }


def _slstm_step(gx: torch.Tensor, r: torch.Tensor, h: torch.Tensor,
                c: torch.Tensor, H: int, P: int):
    """One time step of the sLSTM (``gx [B, 4di]``, this token's input
    gates): the new ``(h, c)``."""
    rec = torch.einsum("bhp,hpq->bhq", h, r.to(h.dtype))  # [B,H,4P]
    g = gx.reshape(gx.shape[0], H, 4 * P) + rec
    i_g, f_g, z_g, o_g = g.chunk(4, dim=-1)
    c = torch.sigmoid(f_g + 1.0) * c + torch.sigmoid(i_g) * torch.tanh(z_g)
    h = torch.sigmoid(o_g) * torch.tanh(c)
    return h, c


def slstm_block(params: SLSTM, x: torch.Tensor, cfg: ModelConfig,
                ctx: ShardingCtx, state: Optional[dict] = None):
    """Sequential scalar LSTM with per-head recurrence, one step a token
    (a handful of launches a step on the card); ``state`` (decode)
    ``{"h": [B,H,P], "c": [B,H,P]}`` f32.  Under the dry run's counter
    (``loop_reckoner``) the steps between the first and the last are
    reckoned as one step counted S - 2 times; every other run walks every
    token."""
    B, S, d = x.shape
    di, H = cfg.d_inner, cfg.num_heads
    P = di // H
    xin = C.linear(params.in_proj, x)
    gates_x = whole_heads(C.linear(params.w_gates, xin).float(), H)  # [B,S,4di]
    if state is None:
        h = torch.zeros((B, H, P), dtype=torch.float32, device=x.device)
        c = torch.zeros((B, H, P), dtype=torch.float32, device=x.device)
    else:
        h, c = state["h"], state["c"]
    r = fsdp_gather(params.r_gates)
    counter = loop_reckoner()
    if counter is None or S < 3:
        ys = []
        for t in range(S):
            h, c = _slstm_step(gates_x[:, t], r, h, c, H, P)
            ys.append(h)
        y = torch.stack(ys, dim=1)
    else:
        # the first and last steps as they run, the S - 2 between as one
        # step counted S - 2 times, whose h stands for theirs in ys (a view
        # each: each entry's gradient is placed on its own, as each step's)
        h, c = _slstm_step(gates_x[:, 0], r, h, c, H, P)
        ys = [h]
        h, c = counter.trips(
            S - 2, lambda gx, r_, h_, c_: _slstm_step(gx[:, 1], r_, h_, c_, H, P),
            shared=(gates_x, r), carried=(h, c))
        ys += [h.view_as(h) for _ in range(S - 2)]
        h, c = _slstm_step(gates_x[:, S - 1], r, h, c, H, P)
        y = torch.stack(ys + [h], dim=1)
        counter.stacked(ys[1])
    # the output projection's gradient comes split along d_inner: whole
    # heads again before the backward views it as [B, S, H, P]
    y = grad_as_placed(y.reshape(B, S, di)).to(x.dtype)
    return C.linear(params.out_proj, y), {"h": h, "c": c}


def slstm_state_init(cfg: ModelConfig, batch: int, dtype=torch.float32, *,
                     device) -> dict:
    H = cfg.num_heads
    P = cfg.d_inner // H
    return {n: torch.zeros((batch, H, P), dtype=torch.float32, device=device)
            for n in ("h", "c")}
