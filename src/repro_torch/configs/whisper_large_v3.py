"""Whisper-large-v3 backbone: enc-dec transformer; conv audio frontend is a
STUB (input_specs supplies precomputed frame embeddings). [arXiv:2212.04356]
32+32L d=1280 20H kv=20 hd=64 ff=5120 GELU vocab=51866, encoder seq 1500."""

from ..config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    mlp_type="gelu",
    encdec=True,
    num_encoder_layers=32,
    encoder_seq=1500,
    frontend="audio_stub",
)
