"""command-r-plus-104b [dense] — 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000 — GQA, no-bias
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab=256000,
    activation="swiglu",
    norm="layernorm",          # Cohere uses LayerNorm without bias
    rope_theta=75_000_000.0,
    qk_norm=True,
    tie_embeddings=True,       # Cohere ties input/output embeddings
    family="dense",
    train_microbatches=8,
)
