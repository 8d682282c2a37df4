"""Diffusion-transformer configuration schema (the port's copy of the
reference's ``DiTConfig``, ``repro/models/dit.py``)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class DiTConfig:
    """Shape of a DiT: depth/width plus the latent-patch geometry."""

    name: str
    n_layers: int                 # depth (XL/2: 28)
    d_model: int                  # hidden size (XL/2: 1152)
    n_heads: int                  # attention heads (XL/2: 16)
    patch_size: int = 2           # latent patchification (the "/2")
    in_channels: int = 4          # VAE latent channels
    input_size: int = 64          # latent spatial extent (512px / 8 VAE)
    mlp_ratio: int = 4
    n_classes: int = 1000         # ImageNet; +1 null class for CFG
    learn_sigma: bool = True      # predict (eps, sigma); samplers use eps
    freq_dim: int = 256           # sinusoidal timestep embedding width
    activation: str = "gelu"      # non-gated MLP (GELU-tanh)
    param_dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def d_ff(self) -> int:
        return self.mlp_ratio * self.d_model

    @property
    def tokens(self) -> int:
        return (self.input_size // self.patch_size) ** 2

    @property
    def out_channels(self) -> int:
        return self.in_channels * (2 if self.learn_sigma else 1)

    @property
    def null_class(self) -> int:
        """The classifier-free-guidance null label (last table row)."""
        return self.n_classes

    def param_count(self) -> int:
        d, L = self.d_model, self.n_layers
        per_block = 4 * d * d + 2 * d * self.d_ff + 6 * d * (d + 1)
        p2c = self.patch_size ** 2 * self.in_channels
        return int(L * per_block + p2c * d + self.freq_dim * d + d * d
                   + (self.n_classes + 1) * d
                   + 2 * d * (d + 1)
                   + d * self.patch_size ** 2 * self.out_channels)
