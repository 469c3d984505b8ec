"""xLSTM-350M: sLSTM + mLSTM blocks (3:1 mLSTM:sLSTM interleave).
[arXiv:2405.04517]  24L d=1024 4H vocab=50304, d_ff=0 (blocks carry their
own up/down projections), tied embeddings."""

from ..config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50304,
    tie_embeddings=True,
    ssm_kind="xlstm",
    slstm_every=4,
    ssm_expand=2,
    ssm_chunk=128,
)
