"""Jamba-1.5-Large (398B total): Mamba+attention 7:1 interleave, MoE 16e
top-2 on every other layer. [arXiv:2403.19887; hf]
72L d=8192 64H kv=8 hd=128 ff=24576 vocab=65536.
TPU adaptation: Mamba-1 selective scan -> chunked SSD form (DESIGN.md §7).
"""

from ..config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    dense_d_ff=24576,
    vocab_size=65536,
    mlp_type="swiglu",
    num_experts=16,
    top_k=2,
    moe_every=2,
    attn_every=8,
    attn_offset=4,
    ssm_kind="ssd",
    ssm_state=128,
    ssm_head_dim=256,
    ssm_expand=2,
    ssm_chunk=128,
)
