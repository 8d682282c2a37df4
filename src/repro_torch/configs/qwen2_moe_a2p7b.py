"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (kv=16) d_ff=1408
vocab=151936, MoE 60e top-4 — 4 shared + 60 routed top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from repro_torch.models.moe import MoEConfig

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,                  # per-expert hidden
    vocab=151936,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_routed_experts=60, top_k=4, d_expert=1408,
                  n_shared_experts=4, shared_d_ff=5632,
                  capacity_factor=1.25, norm_topk_prob=True),
    family="moe",
)
