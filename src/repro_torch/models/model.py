"""Causal LM assembly for attention stacks with dense or MoE FFNs (port
of ``repro/models/model.py``).

The reference scans stacked layer groups; here every layer is its own
:class:`Block` in an ``nn.ModuleList`` and runs eagerly.  A
:class:`Model` holds its weights: build it on the ``meta`` device, then
fill it with :meth:`Model.init` (torch's own truncated-normal draw) or
load the reference's weights with :func:`repro_torch.convert.
params_from_jax`.

Entry points:
    init(generator, device)              -> self, weights filled
    forward(tokens, caches, positions)   -> logits
    prefill_padded(tokens, caches, lengths[, offset])
                                         -> last real token's logits
    decode_step(tokens, caches)          -> logits
    init_cache(batch, max_len, kv_dtype) -> per-layer cache dicts
    init_paged_cache(batch, num_blocks, block_size, max_blocks, kv_dtype)
                                         -> per-layer paged cache dicts
    quantize(plan)                       -> self, plan applied in place
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.quant.plan import FULL_INT8, apply_plan
from . import attention as attn_mod
from .layers import (MLP, embedding_apply, embedding_attend, lm_head_apply,
                     mlp_apply, rmsnorm_apply, truncated_normal_, weight)
from .moe import MoE, moe_apply


def _dtype(cfg: ModelConfig):
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


class Block(nn.Module):
    """One (attn | attn_local) x (dense | moe) decoder block."""

    def __init__(self, spec: tuple[str, str], cfg: ModelConfig, device):
        super().__init__()
        mixer, ffn = spec
        if mixer not in ("attn", "attn_local") or ffn not in ("dense",
                                                              "moe"):
            raise NotImplementedError(f"block {spec} is not ported yet")
        if cfg.norm != "rmsnorm":
            raise NotImplementedError(f"norm {cfg.norm!r} is not ported yet")
        self.spec = spec
        dtype = _dtype(cfg)
        self.mixer_norm = weight((cfg.d_model,), torch.float32, device)
        self.attn = attn_mod.Attention(cfg.d_model, cfg.n_heads,
                                       cfg.n_kv_heads, cfg.head_dim, dtype,
                                       device)
        self.ffn_norm = weight((cfg.d_model,), torch.float32, device)
        if ffn == "moe":
            self.moe = MoE(cfg.d_model, cfg.moe, cfg.gated, dtype, device)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.gated, dtype, device)

    def init_(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.mixer_norm.fill_(1.0)
            self.ffn_norm.fill_(1.0)
        self.attn.init_(generator)
        (self.moe if self.spec[1] == "moe" else self.mlp).init_(generator)


def block_apply(block: Block, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor,
                cache: Optional[dict]) -> torch.Tensor:
    mixer, _ = block.spec
    kind, window = "causal", None
    if mixer == "attn_local":
        kind, window = "sliding", cfg.sliding_window
    h = rmsnorm_apply(block.mixer_norm, x)
    # the skip connection rides into the out-projection's epilogue
    x = attn_mod.attention_apply(block.attn, h, positions, mask_kind=kind,
                                 window=window, rope_theta=cfg.rope_theta,
                                 cache=cache, residual=x)
    h = rmsnorm_apply(block.ffn_norm, x)
    if block.spec[1] == "moe":
        # as the reference: the residual is added here, not fused into
        # the shared expert's down GEMM
        return x + moe_apply(block.moe, h, cfg.moe, cfg.activation)
    return mlp_apply(block.mlp, h, cfg.activation, residual=x)


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device="meta"):
        super().__init__()
        self.cfg = cfg
        self.embed = weight((cfg.vocab, cfg.d_model), _dtype(cfg), device)
        if not cfg.tie_embeddings:
            self.head = weight((cfg.d_model, cfg.vocab), _dtype(cfg), device)
        self.final_norm = weight((cfg.d_model,), torch.float32, device)
        self.layers = nn.ModuleList(Block(spec, cfg, device)
                                    for spec in cfg.layer_specs())

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -- parameters ------------------------------------------------------
    def init(self, generator: torch.Generator | int = 0,
             device=None) -> "Model":
        """Allocate the weights on ``device`` (default: the card) and draw
        them: every matrix ``N(0, 1)`` truncated to [-2, 2] times
        1/sqrt(fan_in) (the embedding unscaled), norms at 1.  An int
        ``generator`` seeds a fresh generator on that device."""
        device = resolve_device(device)
        if isinstance(generator, int):
            generator = torch.Generator(device=device).manual_seed(generator)
        self.to_empty(device=device)
        truncated_normal_(self.embed, generator, 1.0)
        if hasattr(self, "head"):
            truncated_normal_(self.head, generator,
                              1.0 / self.cfg.d_model ** 0.5)
        with torch.no_grad():
            self.final_norm.fill_(1.0)
        for block in self.layers:
            block.init_(generator)
        return self

    def quantize(self, plan=None) -> "Model":
        """Apply a :class:`~repro_torch.quant.plan.QuantPlan` (default:
        the full plan) in place: covered weights become int8
        :class:`~repro_torch.quant.linear.QuantizedLinear` leaves."""
        return apply_plan(self, FULL_INT8 if plan is None else plan)

    # -- forward ----------------------------------------------------------
    def forward(self, tokens: torch.Tensor,
                caches: Optional[list] = None,
                positions: Optional[torch.Tensor] = None,
                last_index: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens [B, S] -> logits f32 [B, S, vocab] (or [B, 1, vocab] at
        each row's ``last_index``)."""
        B, S = tokens.shape
        if positions is None:
            positions = torch.arange(S, device=tokens.device).expand(B, S)
        x = embedding_apply(self.embed, tokens)
        for i, block in enumerate(self.layers):
            x = block_apply(block, self.cfg, x, positions,
                            None if caches is None else caches[i])
        x = rmsnorm_apply(self.final_norm, x)
        if last_index is not None:
            rows = torch.arange(B, device=x.device)
            x = x[rows, last_index.long()][:, None]
        if hasattr(self, "head"):
            return lm_head_apply(self.head, x)
        return embedding_attend(self.embed, x)

    # -- serving -------------------------------------------------------------
    def prefill_padded(self, tokens: torch.Tensor, caches: list,
                       lengths: torch.Tensor,
                       offset: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """Prefill bucket-padded prompts without leaking pad tokens.

        Positions at or beyond ``lengths`` [B] get the empty-slot sentinel
        (2**30), so pad entries written into the cache are masked like
        empty slots.  ``offset`` [B] (default zeros) starts each row's
        positions and cache writes at ``offset[b]``: the paged engine
        feeds a long prompt through here one chunk at a time, ``lengths``
        being the valid length within the chunk.  Returns the logits at
        each row's last real token ([B, 1, vocab]) and leaves every
        cache's write index at ``offset + lengths``.

        The reference writes a chunk from the cache's current index, so
        a paged slot reused after another sequence ended there writes its
        first chunk from that sequence's end, past its own blocks, where
        the writes are dropped; here the index is set to ``offset``
        first.
        """
        B, S = tokens.shape
        lengths = lengths.to(device=tokens.device, dtype=torch.int32)
        rel = torch.arange(S, dtype=torch.int32,
                           device=tokens.device).expand(B, S)
        end = lengths
        if offset is not None:
            off = offset.to(device=tokens.device, dtype=torch.int32)
            rel = rel + off[:, None]
            end = off + lengths
            for c in caches:
                c["index"].copy_(off)
        pos = torch.where(rel < end[:, None], rel,
                          torch.full_like(rel, attn_mod.EMPTY_SLOT))
        logits = self.forward(tokens, caches, positions=pos,
                              last_index=lengths - 1)
        for c in caches:
            c["index"].copy_(end)
        return logits

    def decode_step(self, tokens: torch.Tensor, caches: list) -> torch.Tensor:
        """One new token per row against the caches: tokens [B, S]."""
        S = tokens.shape[1]
        idx = caches[0]["index"]
        positions = (idx[:, None] + torch.arange(
            S, device=idx.device)[None, :]).to(torch.int32)
        return self.forward(tokens, caches, positions=positions)

    # -- caches ---------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int,
                   kv_dtype: Optional[str] = None) -> list:
        """One ring cache dict per layer; ``kv_dtype="int8"`` overrides
        ``cfg.kv_cache_dtype``.  Sliding-window layers hold only the
        window."""
        kv = kv_dtype or self.cfg.kv_cache_dtype
        dt = torch.int8 if kv == "int8" else torch.bfloat16
        caches = []
        for block in self.layers:
            span = max_len
            if block.spec[0] == "attn_local":
                span = min(max_len, self.cfg.sliding_window or max_len)
            caches.append(attn_mod.init_kv_cache(
                batch, span, self.cfg.n_kv_heads, self.cfg.head_dim,
                dtype=dt, device=self.device))
        return caches

    def init_paged_cache(self, batch: int, num_blocks: int, block_size: int,
                         max_blocks: int,
                         kv_dtype: Optional[str] = None) -> list:
        """Paged KV caches for the continuously batched engine: every
        layer gets its own pools of ``num_blocks`` blocks of
        ``block_size`` slots (block 0 the all-empty null block) and its
        own write index; all layers share one [batch, max_blocks] block
        table tensor, which the engine fills once per step."""
        kv = kv_dtype or self.cfg.kv_cache_dtype
        dt = torch.int8 if kv == "int8" else torch.bfloat16
        tables = torch.zeros((batch, max_blocks), dtype=torch.int32,
                             device=self.device)
        caches = []
        for block in self.layers:
            if block.spec[0] not in ("attn", "attn_local"):
                raise NotImplementedError(
                    f"paged KV cache: unsupported mixer {block.spec[0]!r}")
            caches.append(attn_mod.init_paged_kv_cache(
                num_blocks, block_size, self.cfg.n_kv_heads,
                self.cfg.head_dim, tables,
                torch.zeros((batch,), dtype=torch.int32,
                            device=self.device), dtype=dt,
                device=self.device))
        return caches
