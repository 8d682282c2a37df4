"""zamba2-1.2b [hybrid] — 38L d_model=2048 32H (kv=32) d_ff=8192,
ssm_state=64 — Mamba2 + shared attention blocks [arXiv:2411.15242; hf]

As in the reference: the shared transformer block (Zamba2 reuses one
block with per-invocation LoRA) is a regular attention + dense-geglu
block every 6th layer with its own parameters (32 Mamba-2 layers and 6
attention layers).
"""
from repro_torch.models.ssm import SSMConfig

from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=32000,
    activation="geglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_kernel=4,
                  chunk=128),
    attn_every=6,              # shared attention block cadence
    family="hybrid",
    long_context_capable=True,
    train_microbatches=2,
)
