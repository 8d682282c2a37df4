"""gemma-2b [dense] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=256000 — GeGLU, head_dim=256 [arXiv:2403.08295; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,              # MQA
    head_dim=256,
    d_ff=16384,
    vocab=256000,
    activation="geglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    tie_embeddings=True,
    train_microbatches=4,
)
