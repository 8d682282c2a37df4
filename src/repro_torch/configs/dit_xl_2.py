"""dit-xl-2 [diffusion] — DiT-XL/2 @ 512x512: 28 blocks, d_model=1152,
16 heads (head_dim 72), /2 patchify of the 64x64 VAE latent -> 1024
tokens (arXiv:2212.09748).  learn_sigma matches the released model;
samplers consume the eps half."""
from .dit import DiTConfig

CONFIG = DiTConfig(
    name="dit-xl-2",
    n_layers=28,
    d_model=1152,
    n_heads=16,
    patch_size=2,
    in_channels=4,
    input_size=64,             # 512px / 8 VAE downsampling
    mlp_ratio=4,
    n_classes=1000,
    learn_sigma=True,
)
