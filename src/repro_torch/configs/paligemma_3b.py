"""PaliGemma-3B backbone: SigLIP frontend (STUB) + Gemma-2B-class decoder.
[arXiv:2407.07726; hf]  18L d=2048 8H MQA(kv=1) hd=256 ff=16384 GeGLU
vocab=257216; vision patches enter as 256 precomputed prefix embeddings."""

from ..config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    mlp_type="geglu",
    tie_embeddings=True,
    frontend="vision_stub",
    prefix_len=256,
)
