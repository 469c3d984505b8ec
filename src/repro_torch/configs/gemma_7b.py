"""Gemma-7B: GeGLU, head_dim=256, MHA (kv=16). [arXiv:2403.08295; hf]
28L d=3072 16H kv=16 hd=256 ff=24576 vocab=256000, tied embeddings,
embeddings scaled by sqrt(d_model)."""

from ..config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    mlp_type="geglu",
    tie_embeddings=True,
)
