"""Qwen2.5-32B: GQA with QKV bias. [hf:Qwen/Qwen2.5 family; hf]
64L d=5120 40H kv=8 hd=128 ff=27648 SwiGLU vocab=152064."""

from ..config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    mlp_type="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
