"""Config system: model/arch configs, input shapes, and run settings.

The port's own copy of the reference's ``config.py`` (pure Python, no
change).  One frozen dataclass describes an architecture;
``repro_torch/configs/<id>.py`` instantiates it with the exact published
numbers.  ``ShapeConfig`` describes one of the assigned input-shape cells
(train_4k / prefill_32k / decode_32k / long_500k).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "smoke_config"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- block wiring -----------------------------------------------------
    mlp_type: str = "swiglu"  # swiglu | geglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    moe_every: int = 1  # MoE MLP on layers with (i % moe_every == moe_every-1)
    capacity_factor: float = 1.25
    dense_d_ff: int = 0  # d_ff of the non-MoE layers in a mixed model

    # --- hybrid (jamba) / ssm (xlstm) ---------------------------------------
    attn_every: int = 0  # attention on layers with (i % attn_every == attn_offset)
    attn_offset: int = 0
    ssm_kind: str = ""  # "ssd" (mamba-2 chunked) | "xlstm"
    ssm_state: int = 128  # N
    ssm_head_dim: int = 64  # P
    ssm_expand: int = 2  # d_inner = expand * d_model
    ssm_chunk: int = 128
    slstm_every: int = 0  # xlstm: sLSTM on layers with (i % slstm_every == slstm_every-1)

    # --- enc-dec (whisper) ---------------------------------------------------
    encdec: bool = False
    num_encoder_layers: int = 0
    encoder_seq: int = 0  # fixed frame count from the (stub) audio frontend

    # --- modality frontend stubs --------------------------------------------
    frontend: str = "none"  # none | audio_stub | vision_stub
    prefix_len: int = 0  # vision: number of patch-embedding positions

    # ------------------------------------------------------------------ props
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def group_period(self) -> int:
        """Layers per scan-group (1 for homogeneous stacks)."""
        periods = [p for p in (self.attn_every, self.moe_every, self.slstm_every) if p > 1]
        if not periods:
            return 1
        import math

        g = 1
        for p in periods:
            g = g * p // math.gcd(g, p)
        return g

    @property
    def num_groups(self) -> int:
        assert self.num_layers % self.group_period == 0, (
            self.name, self.num_layers, self.group_period)
        return self.num_layers // self.group_period

    def layer_kind(self, i: int) -> Tuple[str, str]:
        """(mixer, mlp) for layer i: mixer in {attn, ssd, mlstm, slstm},
        mlp in {dense, moe, none}."""
        if self.ssm_kind == "xlstm":
            mixer = "slstm" if (
                self.slstm_every and i % self.slstm_every == self.slstm_every - 1
            ) else "mlstm"
            return mixer, "none"  # xlstm blocks carry their own projections
        if self.attn_every:
            mixer = "attn" if i % self.attn_every == self.attn_offset else "ssd"
        else:
            mixer = "attn"
        if self.num_experts:
            mlp = "moe" if i % self.moe_every == self.moe_every - 1 else "dense"
        else:
            mlp = "dense"
        return mixer, mlp

    @property
    def param_count(self) -> int:
        """Approximate parameter count (for 6ND roofline math)."""
        d, ff, L = self.d_model, self.d_ff, self.num_layers
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = embed
        enc_layers = self.num_encoder_layers if self.encdec else 0
        for i in range(L):
            mixer, mlp = self.layer_kind(i)
            if mixer == "attn":
                total += d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
                if self.encdec:  # cross attention in decoder
                    total += d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
            elif mixer == "ssd":
                di = self.d_inner
                total += d * 2 * di + di * d + di * 4  # in/out proj + conv-ish
            elif mixer in ("mlstm", "slstm"):
                di = self.d_inner
                total += d * 2 * di + di * d + 3 * di * di // max(self.num_heads, 1)
            if mlp == "dense":
                f = self.dense_d_ff or ff
                mult = 3 if self.mlp_type in ("swiglu", "geglu") else 2
                total += mult * d * f
            elif mlp == "moe":
                mult = 3 if self.mlp_type in ("swiglu", "geglu") else 2
                total += self.num_experts * mult * d * ff + d * self.num_experts
        for _ in range(enc_layers):
            total += d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
            total += 2 * d * ff  # whisper encoder uses gelu mlp
        return total

    @property
    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if not self.num_experts:
            return self.param_count
        d, ff = self.d_model, self.d_ff
        mult = 3 if self.mlp_type in ("swiglu", "geglu") else 2
        dead = 0
        for i in range(self.num_layers):
            _, mlp = self.layer_kind(i)
            if mlp == "moe":
                dead += (self.num_experts - self.top_k) * mult * d * ff
        return self.param_count - dead


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (spec requirement)."""
    period = cfg.group_period
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=2 * period,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=16,
        d_ff=128,
        dense_d_ff=128 if cfg.dense_d_ff else 0,
        vocab_size=512,
        num_experts=min(cfg.num_experts, 8) if cfg.num_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        # dropless at smoke scale so prefill/decode consistency is exact
        # regardless of sequence-length-dependent capacity
        capacity_factor=16.0 if cfg.num_experts else cfg.capacity_factor,
        ssm_state=16 if cfg.ssm_kind else cfg.ssm_state,
        ssm_head_dim=16 if cfg.ssm_kind else cfg.ssm_head_dim,
        ssm_chunk=16 if cfg.ssm_kind else cfg.ssm_chunk,
        num_encoder_layers=2 if cfg.encdec else 0,
        encoder_seq=32 if cfg.encdec else 0,
        prefix_len=8 if cfg.frontend == "vision_stub" else 0,
    )
