"""paligemma-3b [vlm] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=257216 — SigLIP + gemma [arXiv:2407.07726; hf]

Modality frontend is a STUB: the caller provides 256 precomputed SigLIP
patch embeddings (dim 1152), projected into the backbone by
``frontend_proj``; the image prefix attends bidirectionally (prefix-LM),
text is causal.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,              # MQA (gemma backbone)
    head_dim=256,
    d_ff=16384,
    vocab=257216,
    activation="geglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    tie_embeddings=True,
    frontend="vision",
    frontend_len=256,          # 224/14 = 16x16 patches
    frontend_dim=1152,         # SigLIP So400m width
    family="vlm",
    train_microbatches=4,
)
