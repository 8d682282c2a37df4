"""deepseek-67b [dense] — 95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400 — llama-arch [arXiv:2401.02954; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab=102400,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    family="dense",
    train_microbatches=8,
)
