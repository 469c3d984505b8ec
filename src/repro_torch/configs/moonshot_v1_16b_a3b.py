"""Moonlight-16B-A3B (kimi/moonshot): MoE 64 experts top-6.
[hf:moonshotai/Moonlight-16B-A3B; hf]  48L d=2048 16H kv=16 hd=128
expert ff=1408 vocab=163840; every layer MoE."""

from ..config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163840,
    mlp_type="swiglu",
    num_experts=64,
    top_k=6,
    moe_every=1,
)
