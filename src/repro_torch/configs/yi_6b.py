"""Yi-6B: llama-architecture GQA decoder. [arXiv:2403.04652; hf]
32L d=4096 32H kv=4 hd=128 ff=11008 SwiGLU vocab=64000."""

from ..config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    mlp_type="swiglu",
    rope_theta=5_000_000.0,
)
