"""deepseek-v3-671b [moe] — 61L d_model=7168 128H d_ff=2048 (per expert)
vocab=129280, MoE 256e top-8 — MLA, 1 shared + 256 routed top-8
[arXiv:2412.19437; hf]

As in the reference: the sigmoid, group-limited routing is modeled as
softmax top-k; the multi-token prediction (MTP) head is left out (one
next-token head); the first 3 layers are dense with d_ff=18432.
"""
from repro_torch.models.mla import MLAConfig
from repro_torch.models.moe import MoEConfig

from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=18432,                 # dense layers (first 3)
    vocab=129280,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(n_routed_experts=256, top_k=8, d_expert=2048,
                  n_shared_experts=1, shared_d_ff=2048,
                  capacity_factor=1.25, norm_topk_prob=True,
                  first_k_dense=3),
    family="moe",
    long_context_capable=True,
    train_microbatches=8,
)
