"""Diffusion Transformer (DiT) with adaLN conditioning on the INT8
pipeline (port of ``repro/models/dit.py``).

Structure (Peebles & Xie, arXiv:2212.09748, adaLN-Zero variant):
patchify -> linear patch embed -> timestep/label embedding -> N DiT
blocks -> adaLN final layer -> unpatchify.  Each block is

    mod = adaLN(c) -> 6*d (shift/scale/gate for attn and mlp)
    x  += gate_msa * attn(modulate(ln(x), shift_msa, scale_msa))
    x  += gate_mlp * mlp (modulate(ln(x), shift_mlp, scale_mlp))

with parameter-free LayerNorms.  Attention is full and bidirectional
over the fixed token grid (1024 tokens for XL/2), without RoPE or a
cache.

Under the full plan a block is 6 plan launches, as in the reference: the
adaLN GEMM (kernel 2 on f32 input, the bias in its epilogue), the wide
QKV GEMM, the out-projection (no residual: the gate multiplies the
branch before the add, so the gated residual stays elementwise), and
the 3-launch non-gated gelu MLP; beside them attention is one launch of
kernel 12 on the card (:func:`~repro_torch.models.attention.
cacheless_attention`).  The patch embed, the t and y embedders and the
final layer stay in the weights' dtype as plain products, as the
reference computes them outside any kernel.

Entry points of :class:`DiTModel`:
    init(generator, device)   -> self, weights drawn
    conditioning(t, y)        -> c [B, d]
    forward(x, t, y)          -> [B, out_channels, H, W]
    quantize(plan)            -> self, the blocks' plan applied in place
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.dit import DiTConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.ref import silu
from repro_torch.quant import tp as _tp
from repro_torch.quant.linear import QuantizedLinear, quantized_matmul
from repro_torch.quant.plan import FULL_INT8, apply_dit_plan
from .attention import Attention, attention_apply
from .layers import (MLP, embedding_apply, mlp_apply, truncated_normal_,
                     weight)


def _dtype(cfg: DiTConfig):
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# Patchify / timestep embedding primitives
# ---------------------------------------------------------------------------
def patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """Latents [B, C, H, W] -> patch tokens [B, (H/p)*(W/p), p*p*C]."""
    B, C, H, W = x.shape
    p = patch
    x = x.reshape(B, C, H // p, p, W // p, p)
    x = x.permute(0, 2, 4, 3, 5, 1)               # B, H/p, W/p, p, p, C
    return x.reshape(B, (H // p) * (W // p), p * p * C)


def unpatchify(tokens: torch.Tensor, patch: int, channels: int,
               size: int) -> torch.Tensor:
    """Inverse of :func:`patchify`: [B, T, p*p*C] -> [B, C, H, W]."""
    B = tokens.shape[0]
    p, g = patch, size // patch
    x = tokens.reshape(B, g, g, p, p, channels)
    x = x.permute(0, 5, 1, 3, 2, 4)               # B, C, g, p, g, p
    return x.reshape(B, channels, size, size)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep features: t [B] -> [B, dim] f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _ln(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Parameter-free LayerNorm (adaLN supplies scale and shift): f32
    mean, variance and rsqrt, cast back to x's dtype."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def _modulate(x: torch.Tensor, shift: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """adaLN modulation: x [B, T, d], shift/scale [B, d]."""
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


class Affine(nn.Module):
    """``kernel`` [in, out] in the weights' dtype (or a
    :class:`QuantizedLinear` once a plan covers it) and an f32 ``bias``
    [out], zero at init."""

    def __init__(self, d_in: int, d_out: int, dtype, device):
        super().__init__()
        self.kernel = weight((d_in, d_out), dtype, device)
        self.bias = weight((d_out,), torch.float32, device)

    def init_(self, generator: torch.Generator) -> None:
        truncated_normal_(self.kernel, generator,
                          1.0 / math.sqrt(self.kernel.shape[0]))
        with torch.no_grad():
            self.bias.zero_()


def adaln_apply(adaln: Affine, c: torch.Tensor,
                n_chunks: int) -> tuple[torch.Tensor, ...]:
    """adaLN modulation head: SiLU(c) in f32 -> Linear(d, n_chunks*d) ->
    split, each chunk f32 [B, d].  A quantized kernel is one launch of
    the fused GEMM on the f32 input with the bias in its epilogue;
    otherwise a plain product in the weights' dtype plus the bias."""
    h = silu(c.float())
    w = adaln.kernel
    if isinstance(w, QuantizedLinear):
        out = quantized_matmul(h, w, use_kernel=None, bias=adaln.bias)
    else:
        out = torch.matmul(h.to(w.dtype), w) + adaln.bias
    return torch.chunk(out.float(), n_chunks, dim=-1)


# ---------------------------------------------------------------------------
# DiT block
# ---------------------------------------------------------------------------
class DiTBlock(nn.Module):
    """Attention (H = KH heads, no RoPE), a non-gated MLP and the adaLN
    modulation ``Affine(d, 6d)``."""

    def __init__(self, cfg: DiTConfig, device):
        super().__init__()
        dtype = _dtype(cfg)
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_heads,
                              cfg.head_dim, dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, False, dtype, device)
        self.adaln = Affine(cfg.d_model, 6 * cfg.d_model, dtype, device)

    def init_(self, generator: torch.Generator) -> None:
        self.attn.init_(generator)
        self.mlp.init_(generator)
        self.adaln.init_(generator)


def dit_block_apply(block: DiTBlock, x: torch.Tensor, c: torch.Tensor,
                    cfg: DiTConfig, positions: torch.Tensor,
                    aligned_positions: bool = False) -> torch.Tensor:
    """One DiT block: x [B, T, d], c [B, d] -> [B, T, d].
    ``aligned_positions``: ``positions`` is ``arange(T)`` in every row
    (on the card attention is then one launch of kernel 12)."""
    (shift_msa, scale_msa, gate_msa,
     shift_mlp, scale_mlp, gate_mlp) = adaln_apply(block.adaln, c, 6)
    dt = x.dtype

    h = _modulate(_ln(x), shift_msa.to(dt), scale_msa.to(dt))
    attn_out = attention_apply(block.attn, h, positions, mask_kind="full",
                               use_rope=False,
                               aligned_positions=aligned_positions)
    x = x + gate_msa[:, None, :].to(dt) * attn_out

    h = _modulate(_ln(x), shift_mlp.to(dt), scale_mlp.to(dt))
    mlp_out = mlp_apply(block.mlp, h, cfg.activation).to(dt)
    return x + gate_mlp[:, None, :].to(dt) * mlp_out


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------
class _TimestepEmbedder(nn.Module):
    def __init__(self, cfg: DiTConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.w1 = weight((cfg.freq_dim, d), dtype, device)
        self.b1 = weight((d,), torch.float32, device)
        self.w2 = weight((d, d), dtype, device)
        self.b2 = weight((d,), torch.float32, device)

    def init_(self, generator: torch.Generator) -> None:
        for w, b in ((self.w1, self.b1), (self.w2, self.b2)):
            truncated_normal_(w, generator, 1.0 / math.sqrt(w.shape[0]))
            with torch.no_grad():
                b.zero_()


class _FinalLayer(nn.Module):
    def __init__(self, cfg: DiTConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.adaln = Affine(d, 2 * d, dtype, device)
        self.linear = Affine(d, cfg.patch_size ** 2 * cfg.out_channels,
                             dtype, device)

    def init_(self, generator: torch.Generator) -> None:
        self.adaln.init_(generator)
        self.linear.init_(generator)


class DiTModel(nn.Module):
    """The adaLN DiT holding its weights: build it on the ``meta``
    device, then draw them with :meth:`init` or load the reference's
    with :func:`repro_torch.convert.dit_params_from_jax`."""

    def __init__(self, cfg: DiTConfig, device="meta"):
        super().__init__()
        self.cfg = cfg
        dtype = _dtype(cfg)
        p2c = cfg.patch_size ** 2 * cfg.in_channels
        self.patch_embed = Affine(p2c, cfg.d_model, dtype, device)
        self.t_embed = _TimestepEmbedder(cfg, dtype, device)
        self.y_table = weight((cfg.n_classes + 1, cfg.d_model), dtype,
                              device)
        self.final = _FinalLayer(cfg, dtype, device)
        self.blocks = nn.ModuleList(DiTBlock(cfg, device)
                                    for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.y_table.device

    # -- parameters ------------------------------------------------------
    def init(self, generator: torch.Generator | int = 0,
             device=None, tp=None, plan=None) -> "DiTModel":
        """Allocate the weights on ``device`` (default: the card) and draw
        them: every matrix ``N(0, 1)`` truncated to [-2, 2] times
        1/sqrt(fan_in), the label table times 0.02, biases zero (the
        reference's init, not adaLN-Zero's zeros, so that random weights
        are not the identity).  An int ``generator`` seeds a fresh
        generator on that device.  ``tp`` and ``plan``: a rank's shards
        only, drawn leaf by leaf, as :meth:`repro_torch.models.Model.init`."""
        device = resolve_device(device)
        if isinstance(generator, int):
            generator = torch.Generator(device=device).manual_seed(generator)
        if tp is not None:
            from repro_torch.parallel.sharding import draw_sharded
            return draw_sharded(self, tp, generator, device, plan)
        self.to_empty(device=device)
        self.draw_(generator)
        return self

    def draw_(self, generator: torch.Generator) -> None:
        """Draw every weight, already allocated, from ``generator``, in
        ``init``'s order."""
        self.patch_embed.init_(generator)
        self.t_embed.init_(generator)
        truncated_normal_(self.y_table, generator, 0.02)
        self.final.init_(generator)
        for block in self.blocks:
            block.init_(generator)

    def quantize(self, plan=None) -> "DiTModel":
        """Apply a :class:`~repro_torch.quant.plan.QuantPlan` (default:
        the full plan) to the blocks in place; the patch embed, the
        embedders and the final layer stay as they are."""
        return apply_dit_plan(self, FULL_INT8 if plan is None else plan)

    # -- forward ----------------------------------------------------------
    def conditioning(self, t: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Timestep + label embedding: (t [B], y [B] int) -> c [B, d]."""
        te = self.t_embed
        h = timestep_embedding(t, self.cfg.freq_dim)
        h = silu(torch.matmul(h, te.w1.float()) + te.b1)
        h = torch.matmul(h, te.w2.float()) + te.b2
        group = (_tp.group_of(self) if "y_table" in
                 self.__dict__.get("_tp_cut", ()) else None)
        ye = embedding_apply(self.y_table, y.long(), group)
        return (h + ye.float()).to(_dtype(self.cfg))

    def forward(self, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One denoise evaluation: latents x [B, C, H, W], timesteps t [B],
        labels y [B] -> [B, out_channels, H, W] f32.  With the default
        positions (``arange(T)``) attention runs on kernel 12 on the card;
        explicit positions take the plain dense path (its reference)."""
        cfg = self.cfg
        dtype = _dtype(cfg)
        c = self.conditioning(t, y)
        pe = self.patch_embed
        tok = patchify(x.to(dtype), cfg.patch_size)
        tok = torch.matmul(tok, pe.kernel) + pe.bias.to(dtype)
        B, T, _ = tok.shape
        aligned = positions is None
        if aligned:
            positions = torch.arange(T, device=tok.device).expand(B, T)
        for block in self.blocks:
            tok = dit_block_apply(block, tok, c, cfg, positions, aligned)
        fin = self.final
        shift, scale = adaln_apply(fin.adaln, c, 2)
        h = _modulate(_ln(tok), shift.to(dtype), scale.to(dtype))
        out = torch.matmul(h, fin.linear.kernel) + fin.linear.bias.to(dtype)
        return unpatchify(out.float(), cfg.patch_size, cfg.out_channels,
                          cfg.input_size)
