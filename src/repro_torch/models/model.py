"""Causal LM assembly for attention or MLA stacks with dense or MoE FFNs,
Mamba-2 hybrids and xLSTM stacks, with the reference's stub frontends
(port of ``repro/models/model.py``).

The reference scans stacked layer groups; here every layer is its own
:class:`Block` in an ``nn.ModuleList`` and runs eagerly.  A
:class:`Model` holds its weights: build it on the ``meta`` device, then
fill it with :meth:`Model.init` (torch's own truncated-normal draw) or
load the reference's weights with :func:`repro_torch.convert.
params_from_jax`.

Entry points (each also takes ``patch_embeddings=`` for a vision
config or ``frame_embeddings=`` for an audio one, see :meth:`Model.
forward`):
    init(generator, device)              -> self, weights filled
    forward(tokens, caches, positions)   -> logits
    trainable()                          -> self, float weights with grad
    loss(batch)                          -> (loss, {"nll", "aux", "tokens"})
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
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.quant import tp as _tp
from repro_torch.quant.linear import QuantizedLinear
from repro_torch.quant.plan import FULL_INT8, apply_plan
from . import attention as attn_mod
from .layers import (MLP, embedding_apply, embedding_attend, lm_head_apply,
                     mlp_apply, norm_apply, truncated_normal_, weight)
from .mla import MLA, init_mla_cache, mla_apply
from .moe import MoE, load_balance_aux, moe_apply, route
from .ssm import Mamba2, init_ssm_cache, mamba2_apply
from .xlstm import (MLSTMBlock, SLSTMBlock, init_mlstm_cache,
                    init_slstm_cache, mlstm_block_apply, slstm_block_apply)

# mixers with no FFN: the block is the mixer, its output added to x
RECURRENT = ("mamba2", "mlstm", "slstm")
# a block's attribute holding its mixer (the reference's key in a group)
MIXER_ATTR = {"attn": "attn", "attn_local": "attn", "mla": "mla",
              "mamba2": "mamba", "mlstm": "mlstm", "slstm": "slstm"}


def _dtype(cfg: ModelConfig):
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def _norm(kind: str, scale: torch.Tensor, x: torch.Tensor,
          owner: nn.Module, name: str) -> torch.Tensor:
    """The config's norm with ``scale``, and the bias ``owner`` holds as
    ``<name>_bias`` when a converted tree carried one (the reference's
    layernorm may have a bias; none of its configs draws one)."""
    return norm_apply(kind, scale, x, getattr(owner, name + "_bias", None))


class Block(nn.Module):
    """One (attn | attn_local | mla) x (dense | moe) decoder block, or a
    recurrent block with no FFN: ("mamba2" | "mlstm" | "slstm", "none").
    Its norms are the config's (rmsnorm or layernorm, a scale [d] f32
    each).  The mixer is the attribute of its kind: ``attn``, ``mla``,
    ``mamba``, ``mlstm`` or ``slstm``."""

    def __init__(self, spec: tuple[str, str], cfg: ModelConfig, device):
        super().__init__()
        mixer, ffn = spec
        if not ((mixer in RECURRENT and ffn == "none")
                or (mixer in ("attn", "attn_local", "mla")
                    and ffn in ("dense", "moe"))):
            raise NotImplementedError(f"block {spec} is not ported yet")
        if cfg.norm not in ("rmsnorm", "layernorm"):
            raise ValueError(f"unknown norm {cfg.norm!r}")
        self.spec = spec
        dtype = _dtype(cfg)
        self.mixer_norm = weight((cfg.d_model,), torch.float32, device)
        if mixer == "mamba2":
            self.mamba = Mamba2(cfg.d_model, cfg.ssm, dtype, device)
        elif mixer == "mlstm":
            self.mlstm = MLSTMBlock(cfg.d_model, cfg.xlstm, dtype, device)
        elif mixer == "slstm":
            self.slstm = SLSTMBlock(cfg.d_model, cfg.xlstm, dtype, device)
        elif mixer == "mla":
            self.mla = MLA(cfg.d_model, cfg.n_heads, cfg.mla, dtype, device)
        else:
            self.attn = attn_mod.Attention(cfg.d_model, cfg.n_heads,
                                           cfg.n_kv_heads, cfg.head_dim,
                                           dtype, device,
                                           qk_norm=cfg.qk_norm)
        if ffn == "none":
            return
        self.ffn_norm = weight((cfg.d_model,), torch.float32, device)
        if ffn == "moe":
            self.moe = MoE(cfg.d_model, cfg.moe, cfg.gated, dtype, device)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.gated, dtype, device)

    @property
    def mixer(self) -> nn.Module:
        return getattr(self, MIXER_ATTR[self.spec[0]])

    def init_(self, generator: torch.Generator) -> None:
        """Norms at 1, then the mixer's draws, then the FFN's."""
        with torch.no_grad():
            self.mixer_norm.fill_(1.0)
        self.mixer.init_(generator)
        if self.spec[1] == "none":
            return
        with torch.no_grad():
            self.ffn_norm.fill_(1.0)
        (self.moe if self.spec[1] == "moe" else self.mlp).init_(generator)


def block_apply(block: Block, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, cache: Optional[dict],
                aligned_positions: bool = False,
                prefix_len: Optional[int] = None) -> torch.Tensor:
    """One decoder block.  ``aligned_positions``: ``positions`` is
    ``arange(S)`` in every row (a cacheless forward above 2048 tokens
    then attends on kernel 12).  The global (``"attn"``) layers of a
    vision config attend under the ``"prefix"`` mask with
    ``prefix_len``.  Every mixer but attention adds its output to x, as
    the reference does (attention fuses it into its out-projection)."""
    x = _mixer_apply(block, cfg, x, positions, cache, aligned_positions,
                     prefix_len)
    # a recurrent block has no FFN: the mixer's output is the update
    if block.spec[0] in RECURRENT:
        return x
    return _ffn_apply(block, cfg, x)


def _mixer_apply(block: Block, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, cache: Optional[dict],
                 aligned_positions: bool,
                 prefix_len: Optional[int]) -> torch.Tensor:
    """The block's mixer on its norm of x, the residual included."""
    mixer, _ = block.spec
    h = _norm(cfg.norm, block.mixer_norm, x, block, "mixer_norm")
    if mixer == "mamba2":
        return x + mamba2_apply(block.mamba, h, cfg.ssm, cache)
    if mixer == "mlstm":
        return x + mlstm_block_apply(block.mlstm, h, cfg.xlstm, cache)
    if mixer == "slstm":
        return x + slstm_block_apply(block.slstm, h, cfg.xlstm, cache)
    if mixer == "mla":
        return x + mla_apply(block.mla, h, positions, cfg.mla,
                             rope_theta=cfg.rope_theta, cache=cache,
                             aligned_positions=aligned_positions)
    kind, window = "causal", None
    if mixer == "attn_local":
        kind, window = "sliding", cfg.sliding_window
    elif cfg.frontend == "vision":
        kind = "prefix"
    # the skip connection rides into the out-projection's epilogue
    return attn_mod.attention_apply(block.attn, h, positions, mask_kind=kind,
                                    window=window, rope_theta=cfg.rope_theta,
                                    cache=cache, residual=x,
                                    aligned_positions=aligned_positions,
                                    prefix_len=prefix_len)


def _ffn_apply(block: Block, cfg: ModelConfig,
               x: torch.Tensor) -> torch.Tensor:
    """The block's FFN on its norm of x, the residual included."""
    h = _norm(cfg.norm, block.ffn_norm, x, block, "ffn_norm")
    if block.spec[1] == "moe":
        # as the reference: the residual is added here, not fused into
        # the shared expert's down GEMM
        return x + moe_apply(block.moe, h, cfg.moe, cfg.activation)
    return mlp_apply(block.mlp, h, cfg.activation, residual=x)


def _train_block_apply(block: Block, cfg: ModelConfig, x: torch.Tensor,
                       positions: torch.Tensor, aligned_positions: bool,
                       prefix_len: Optional[int]):
    """A training loss's layer: :func:`block_apply` without a cache, and
    the block's MoE load-balance auxiliary (f32; zero for a block
    without a MoE FFN), the reference's ``block_apply``'s third
    output.  Returns (x, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if block.spec[1] != "moe":
        return block_apply(block, cfg, x, positions, None,
                           aligned_positions, prefix_len), aux
    x = _mixer_apply(block, cfg, x, positions, None, aligned_positions,
                     prefix_len)
    h = _norm(cfg.norm, block.ffn_norm, x, block, "ffn_norm")
    r = route(block.moe.router, h, cfg.moe)
    x = x + moe_apply(block.moe, h, cfg.moe, cfg.activation, routing=r)
    return x, aux + load_balance_aux(r, cfg.moe)


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device="meta"):
        super().__init__()
        self.cfg = cfg
        self.embed = weight((cfg.vocab, cfg.d_model), _dtype(cfg), device)
        if not cfg.tie_embeddings:
            self.head = weight((cfg.d_model, cfg.vocab), _dtype(cfg), device)
        self.final_norm = weight((cfg.d_model,), torch.float32, device)
        if cfg.frontend == "vision" and cfg.frontend_dim:
            # the patch embeddings' projection: a plain bf16 product,
            # outside the plan (the reference's plan does not cover it)
            self.frontend_proj = weight((cfg.frontend_dim, cfg.d_model),
                                        _dtype(cfg), device)
        self.layers = nn.ModuleList(Block(spec, cfg, device)
                                    for spec in cfg.layer_specs())

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -- parameters ------------------------------------------------------
    def init(self, generator: torch.Generator | int = 0,
             device=None, tp=None, plan=None) -> "Model":
        """Allocate the weights on ``device`` (default: the card) and draw
        them: every matrix ``N(0, 1)`` truncated to [-2, 2] times
        1/sqrt(fan_in) (the embedding unscaled), norms at 1.  An int
        ``generator`` seeds a fresh generator on that device.  The draws
        run in a fixed order (:meth:`draw_`).

        With ``tp`` (a tensor-parallel group) the model must still be on
        the meta device: each leaf is drawn, quantized under ``plan``
        (default: the full plan) and cut to the rank's shard before the
        next is drawn (:func:`repro_torch.parallel.sharding.draw_sharded`),
        so the rank never holds the whole model; the bits are the whole
        draw's, quantized and sharded."""
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
        """Draw every weight, already allocated, from ``generator``:
        :meth:`init_outer`, then each block."""
        self.init_outer(generator)
        for block in self.layers:
            block.init_(generator)

    def init_outer(self, generator: torch.Generator) -> None:
        """Draw the weights outside the blocks, already allocated: the
        embedding, the untied head, the final norm and ``frontend_proj``
        (a caller that allocates and draws the blocks one at a time calls
        this first, then ``block.init_`` in order, and gets
        :meth:`init`'s weights)."""
        truncated_normal_(self.embed, generator, 1.0)
        if hasattr(self, "head"):
            truncated_normal_(self.head, generator,
                              1.0 / self.cfg.d_model ** 0.5)
        with torch.no_grad():
            self.final_norm.fill_(1.0)
        if hasattr(self, "frontend_proj"):
            truncated_normal_(self.frontend_proj, generator,
                              1.0 / self.cfg.frontend_dim ** 0.5)

    def quantize(self, plan=None) -> "Model":
        """Apply a :class:`~repro_torch.quant.plan.QuantPlan` (default:
        the full plan) in place: covered weights become int8
        :class:`~repro_torch.quant.linear.QuantizedLinear` leaves."""
        return apply_plan(self, FULL_INT8 if plan is None else plan)

    # -- forward ----------------------------------------------------------
    def _embed_inputs(self, tokens, patch_embeddings, frame_embeddings
                      ) -> tuple[torch.Tensor, Optional[int]]:
        """The reference's ``_embed_inputs``: (x [B, S, d], prefix_len).
        Audio: the frame embeddings in the weights' dtype, no token
        lookup.  Vision: patch embeddings [B, P, frontend_dim] projected
        by ``frontend_proj`` and put before the text tokens' embeddings,
        ``prefix_len`` P; text alone (a continuation whose image prefix
        is in the cache) keeps ``prefix_len`` = ``frontend_len``."""
        cfg = self.cfg
        if cfg.frontend == "audio":
            if frame_embeddings is None:
                raise ValueError(f"{cfg.name} takes frame_embeddings "
                                 f"[B, S, {cfg.d_model}], not tokens")
            return frame_embeddings.to(_dtype(cfg)), None
        if frame_embeddings is not None:
            raise ValueError(f"{cfg.name} has no audio frontend")
        if patch_embeddings is not None and cfg.frontend != "vision":
            raise ValueError(f"{cfg.name} has no vision frontend")
        x = embedding_apply(self.embed, tokens, self._vocab_group())
        if cfg.frontend != "vision":
            return x, None
        if patch_embeddings is None:
            return x, cfg.frontend_len
        img = patch_embeddings.to(_dtype(cfg))
        if hasattr(self, "frontend_proj"):
            img = torch.matmul(img, self.frontend_proj)
        return torch.cat([img, x], dim=1), img.shape[1]

    def _stack_inputs(self, tokens, positions, patch_embeddings,
                      frame_embeddings):
        """(x embedded, positions, aligned, prefix_len): positions
        default to ``arange(S)`` in every row, and are then aligned."""
        x, prefix_len = self._embed_inputs(tokens, patch_embeddings,
                                           frame_embeddings)
        B, S = x.shape[:2]
        aligned = positions is None
        if aligned:
            positions = torch.arange(S, device=x.device).expand(B, S)
        return x, positions, aligned, prefix_len

    def features(self, tokens: Optional[torch.Tensor] = None,
                 caches: Optional[list] = None,
                 positions: Optional[torch.Tensor] = None, *,
                 patch_embeddings: Optional[torch.Tensor] = None,
                 frame_embeddings: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
        """The stack and the final norm, without the head: x [B, S, d]
        (the reference's ``forward(head=False)``)."""
        x, positions, aligned, prefix_len = self._stack_inputs(
            tokens, positions, patch_embeddings, frame_embeddings)
        for i, block in enumerate(self.layers):
            x = block_apply(block, self.cfg, x, positions,
                            None if caches is None else caches[i], aligned,
                            prefix_len)
        return _norm(self.cfg.norm, self.final_norm, x, self, "final_norm")

    def _train_features(self, batch: dict,
                        positions: Optional[torch.Tensor]):
        """:meth:`features` of a training batch, without caches, and the
        blocks' summed MoE auxiliary (f32).  With ``cfg.remat`` and grad
        mode on, each layer is recomputed in the backward
        (``torch.utils.checkpoint``), the reference's ``jax.checkpoint``
        of a layer group's body.  Returns (x, aux)."""
        x, positions, aligned, prefix_len = self._stack_inputs(
            batch.get("inputs"), positions, batch.get("patch_embeddings"),
            batch.get("frame_embeddings"))
        remat = self.cfg.remat and torch.is_grad_enabled()
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for block in self.layers:
            args = (block, self.cfg, x, positions, aligned, prefix_len)
            # nothing in a block draws random numbers: no RNG state to
            # carry into the recompute
            x, a = (checkpoint(_train_block_apply, *args, use_reentrant=False,
                               preserve_rng_state=False) if remat
                    else _train_block_apply(*args))
            aux = aux + a
        x = _norm(self.cfg.norm, self.final_norm, x, self, "final_norm")
        return x, aux

    def _vocab_group(self):
        """The current tensor-parallel group when this rank holds only its
        rows of the vocabulary (``parallel.sharding.vocab_cuts``), else
        None."""
        if "embed" not in self.__dict__.get("_tp_cut", ()):
            return None
        return _tp.group_of(self)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        group = self._vocab_group()
        if hasattr(self, "head"):
            return lm_head_apply(self.head, x, group)
        return embedding_attend(self.embed, x, group)

    def forward(self, tokens: Optional[torch.Tensor] = None,
                caches: Optional[list] = None,
                positions: Optional[torch.Tensor] = None,
                last_index: Optional[torch.Tensor] = None, *,
                patch_embeddings: Optional[torch.Tensor] = None,
                frame_embeddings: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """tokens [B, S] -> logits f32 [B, S, vocab] (or [B, 1, vocab] at
        each row's ``last_index``).  A vision config also takes
        ``patch_embeddings`` [B, P, frontend_dim] (the sequence is then
        the P patches followed by the tokens), an audio config takes
        ``frame_embeddings`` [B, S, d_model] instead of tokens.  Without
        caches, a sequence longer than ``DENSE_SEQ_THRESHOLD`` attends
        blockwise; with the default positions (``arange(S)``) that is
        kernel 12 on the card."""
        x = self.features(tokens, caches, positions,
                          patch_embeddings=patch_embeddings,
                          frame_embeddings=frame_embeddings)
        if last_index is not None:
            rows = torch.arange(x.shape[0], device=x.device)
            x = x[rows, last_index.long()][:, None]
        return self._head(x)

    # -- training ----------------------------------------------------------
    LOSS_CHUNK_BUDGET = 2 ** 26   # logits elements per chunk

    def trainable(self) -> "Model":
        """Turn on ``requires_grad`` for the weights the reference
        differentiates: every parameter of an unquantized model (all are
        float).  A model under a quantization plan is not trained (its
        int8 leaves have no gradient, its kernels no backward)."""
        for name, mod in self.named_modules():
            if isinstance(mod, QuantizedLinear):
                raise NotImplementedError(
                    f"{name}: a quantized model is not trained")
        for p in self.parameters():
            p.requires_grad_(True)
        return self

    def _nll(self, feats, targets, mask):
        """(sum of the token NLLs, their count) of one chunk, f32."""
        logp = torch.log_softmax(self._head(feats), dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
        if mask is not None:
            return torch.sum(nll * mask), torch.sum(mask)
        return torch.sum(nll), torch.tensor(float(nll.numel()),
                                            device=nll.device)

    def loss(self, batch: dict, positions: Optional[torch.Tensor] = None):
        """The reference's ``Model.loss``: cross entropy with a
        sequence-chunked head plus the MoE auxiliary.  ``batch`` holds
        tensors on the model's device: ``targets`` [B, T] and the
        forward's inputs (``inputs``, ``patch_embeddings``,
        ``frame_embeddings``), optionally ``loss_mask`` [B, T].
        ``positions`` go to the forward as :meth:`forward`'s do (None:
        ``arange(S)``, so a long sequence attends on kernel 12 on the
        card; given, it attends blockwise, as on the CPU).  The
        [B, S, vocab] logits are never built whole: the chunk count is
        the smallest power of two dividing S that keeps a chunk within
        ``LOSS_CHUNK_BUDGET`` logits, and each chunk is recomputed in the
        backward.  A vision config scores the last T positions (the text
        after the image prefix).  Returns (loss + aux, {"nll", "aux",
        "tokens"})."""
        cfg = self.cfg
        feats, aux = self._train_features(batch, positions)
        targets = batch["targets"]
        if cfg.frontend == "vision":
            feats = feats[:, -targets.shape[1]:]
        mask = batch.get("loss_mask")
        B, S, _ = feats.shape
        n_chunks = 1
        while (S % (n_chunks * 2) == 0 and
               B * (S // n_chunks) * cfg.vocab > self.LOSS_CHUNK_BUDGET):
            n_chunks *= 2
        if n_chunks == 1:
            total, count = self._nll(feats, targets, mask)
        else:
            C = S // n_chunks
            if mask is None:
                mask = torch.ones(targets.shape, dtype=torch.float32,
                                  device=feats.device)
            total = count = torch.zeros((), dtype=torch.float32,
                                        device=feats.device)
            for c in range(n_chunks):
                cut = slice(c * C, (c + 1) * C)
                s, n = checkpoint(self._nll, feats[:, cut], targets[:, cut],
                                  mask[:, cut], use_reentrant=False,
                                  preserve_rng_state=False)
                total, count = total + s, count + n
        loss = total / torch.clamp_min(count, 1.0)
        return loss + aux, {"nll": loss, "aux": aux, "tokens": count}

    # -- serving -------------------------------------------------------------
    def prefill_padded(self, tokens: Optional[torch.Tensor], caches: list,
                       lengths: torch.Tensor,
                       offset: Optional[torch.Tensor] = None, *,
                       patch_embeddings: Optional[torch.Tensor] = None,
                       frame_embeddings: Optional[torch.Tensor] = None
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

        With ``patch_embeddings`` [B, P, frontend_dim] the prompt is the P
        patches then the tokens, and ``lengths`` counts the tokens: each
        row's valid length is P + lengths.  An audio config takes
        ``frame_embeddings`` [B, S, d_model] in place of tokens.
        """
        first = tokens if frame_embeddings is None else frame_embeddings
        dev = first.device
        B, S = first.shape[:2]
        lengths = lengths.to(device=dev, dtype=torch.int32)
        if patch_embeddings is not None:
            S += patch_embeddings.shape[1]
            lengths = lengths + patch_embeddings.shape[1]
        rel = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
        end = lengths
        if offset is not None:
            off = offset.to(device=dev, dtype=torch.int32)
            rel = rel + off[:, None]
            end = off + lengths
            for c in caches:
                c["index"].copy_(off)
        pos = torch.where(rel < end[:, None], rel,
                          torch.full_like(rel, attn_mod.EMPTY_SLOT))
        logits = self.forward(tokens, caches, positions=pos,
                              last_index=lengths - 1,
                              patch_embeddings=patch_embeddings,
                              frame_embeddings=frame_embeddings)
        for c in caches:
            c["index"].copy_(end)
        return logits

    def decode_step(self, tokens: Optional[torch.Tensor], caches: list, *,
                    frame_embeddings: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        """One new token per row against the caches: tokens [B, S] (an
        audio config: ``frame_embeddings`` [B, S, d_model]).  The
        positions come from the first layer's write index, whatever its
        mixer (every layer's index advances alike)."""
        S = (tokens if frame_embeddings is None else frame_embeddings
             ).shape[1]
        idx = caches[0]["index"]
        positions = (idx[:, None] + torch.arange(
            S, device=idx.device)[None, :]).to(torch.int32)
        return self.forward(tokens, caches, positions=positions,
                            frame_embeddings=frame_embeddings)

    # -- caches ---------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int,
                   kv_dtype: Optional[str] = None) -> list:
        """One ring cache dict per layer, over the heads each layer holds
        (a tensor-parallel rank's shard); ``kv_dtype="int8"`` overrides
        ``cfg.kv_cache_dtype``.  Sliding-window layers hold only the
        window; a Mamba-2 layer holds its conv tail and state
        (``init_ssm_cache``), an MLA layer its bf16 latent cache of
        ``max_len`` slots whatever ``kv_dtype`` says (``init_mla_cache``,
        as the reference), an xLSTM layer its state (``init_mlstm_cache``,
        ``init_slstm_cache``).

        On a model sharded by ``parallel.sharding.shard_model`` (rank r of
        p) a ring or latent cache whose ``kv_seq`` axis binds the model
        axis (``parallel.sharding.seq_cut_slots``: the KV heads cannot
        take it and p divides the capacity) holds only the rank's slots
        ``[r cap / p, (r + 1) cap / p)``, recorded on its ``k`` or
        ``c_kv`` leaf (``parallel.sharding.record_slot_range``); the
        write index stays whole and keeps its global meaning (slot =
        position % cap)."""
        from repro_torch.parallel.sharding import (cache_span,
                                                   record_slot_range,
                                                   seq_cut_slots)
        kv = kv_dtype or self.cfg.kv_cache_dtype
        dt = torch.int8 if kv == "int8" else torch.bfloat16
        cfg, dev = self.cfg, self.device
        size = getattr(self, "tp_size", 1)
        caches = []
        for block in self.layers:
            mixer = block.spec[0]
            if mixer == "mamba2":
                caches.append(init_ssm_cache(
                    batch, cfg.d_model, cfg.ssm, device=dev,
                    n_heads=block.mamba.a_log.shape[0],
                    conv_dim=block.mamba.conv_w.shape[1]))
                continue
            if mixer == "mlstm":
                caches.append(init_mlstm_cache(
                    batch, cfg.d_model, cfg.xlstm, device=dev,
                    n_heads=block.mlstm.q.shape[1]))
                continue
            if mixer == "slstm":
                caches.append(init_slstm_cache(
                    batch, cfg.d_model, cfg.xlstm, device=dev,
                    n_heads=block.slstm.r.shape[1]))
                continue
            span = cache_span(cfg, mixer, max_len)
            cut = seq_cut_slots(cfg, mixer, size, max_len)
            slots = span if cut is None else cut
            if mixer == "mla":
                cache = init_mla_cache(batch, slots, cfg.mla, device=dev)
                leaf = cache["c_kv"]
            else:
                cache = attn_mod.init_kv_cache(
                    batch, slots, block.attn.n_kv_heads, cfg.head_dim,
                    dtype=dt, device=dev)
                leaf = cache["k"]
            if cut is not None:
                record_slot_range(leaf, self.tp_rank * cut, span)
            caches.append(cache)
        return caches

    def init_paged_cache(self, batch: int, num_blocks: int, block_size: int,
                         max_blocks: int,
                         kv_dtype: Optional[str] = None) -> list:
        """Paged KV caches for the continuously batched engine: every
        layer gets its own pools of ``num_blocks`` blocks of
        ``block_size`` slots (block 0 the all-empty null block) and its
        own write index; all layers share one [batch, max_blocks] block
        table tensor, which the engine fills once per step.  Only
        attention layers page: MLA and the recurrent mixers are refused,
        as the reference refuses them."""
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
                num_blocks, block_size, block.attn.n_kv_heads,
                self.cfg.head_dim, tables,
                torch.zeros((batch,), dtype=torch.int32,
                            device=self.device), dtype=dt,
                device=self.device))
        return caches
