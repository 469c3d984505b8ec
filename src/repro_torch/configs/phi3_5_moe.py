"""Phi-3.5-MoE (42B total / 6.6B active): 16 experts top-2.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]  32L d=4096 32H kv=8 hd=128
expert ff=6400 vocab=32064."""

from ..config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    mlp_type="swiglu",
    num_experts=16,
    top_k=2,
    moe_every=1,
)
