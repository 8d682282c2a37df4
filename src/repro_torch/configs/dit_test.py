"""dit-test [diffusion] — reduced DiT for CPU tests: the block structure
of dit-xl-2 (adaLN + full attention + non-gated GELU MLP) at tiny dims:
2 blocks, d_model=64, 4 heads, 8x8 latent /2 patch -> 16 tokens, f32
params."""
from .dit import DiTConfig

CONFIG = DiTConfig(
    name="dit-test",
    n_layers=2,
    d_model=64,
    n_heads=4,
    patch_size=2,
    in_channels=4,
    input_size=8,
    mlp_ratio=2,
    n_classes=16,
    learn_sigma=False,
    freq_dim=32,
    param_dtype="float32",
)
