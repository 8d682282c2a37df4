"""musicgen-medium [audio] — 48L d_model=1536 24H (MHA kv=24) d_ff=6144
vocab=2048 — decoder-only over EnCodec tokens [arXiv:2306.05284; hf]

Modality frontend is a STUB: the caller provides precomputed frame
embeddings (the sum of the 4 EnCodec codebook embeddings) at d_model.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab=2048,
    activation="gelu",
    norm="layernorm",
    rope_theta=10000.0,
    frontend="audio",
    family="audio",
    train_microbatches=4,
)
