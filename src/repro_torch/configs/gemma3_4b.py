"""gemma3-4b [dense] — 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144 — 5:1 local:global, 128k context
[hf:google/gemma-3-1b-pt; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab=262144,
    activation="geglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    qk_norm=True,
    tie_embeddings=True,
    sliding_window=1024,
    local_global_pattern=5,    # 5 local layers per global layer
    family="dense",
    long_context_capable=True,
    train_microbatches=4,
)
