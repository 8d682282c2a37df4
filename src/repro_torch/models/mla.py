"""Multi-head Latent Attention, DeepSeek-V3's mixer (port of
``repro/models/mla.py``; arXiv:2412.19437).

Two paths share one parameter set, as in the reference:

* without a cache the latents are up-projected to per-head K (nope and
  the shared rope key, ``qk_head_dim``) and V (``v_head_dim``) and
  attend as standard MHA through
  :func:`~repro_torch.models.attention.cacheless_attention`: dense up to
  2048 tokens, above it kernel 12 on the card (given the model's own
  positions) or the blockwise online softmax;
* with a cache (prefill and decode alike) the *absorbed* form: ``c_kv``
  and ``k_rope`` are written into the latent cache in place at
  ``index``, the queries are folded through ``W_uk`` and scored in f32
  against the latent cache plus the rope key, and the probabilities, cast
  to the cache's dtype, are folded back through ``W_uv``.

Every projection and the absorbed decode are bf16 ``torch`` products, as
the reference computes them with plain ``einsum`` outside any Pallas
kernel; no plan kind covers them (``quant/plan.py covered_kinds``).  The
casts are the reference's: they decide the bf16 roundings.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from repro_torch.kernels.ref import NEG_INF
from repro_torch.quant import tp as _tp
from . import attention as attn_mod
from .layers import apply_rope, rmsnorm_apply, truncated_normal_, weight


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


class MLA(nn.Module):
    """The reference's ``mla_init`` leaves: ``q_down`` [d, q_lora],
    ``q_norm.scale`` [q_lora] (f32), ``q_up`` [q_lora, H, nope + rope],
    ``kv_down`` [d, kv_lora + rope] (``c_kv`` then the shared rope key),
    ``kv_norm.scale`` [kv_lora] (f32), ``kv_up`` [kv_lora, H, nope + v]
    and ``o`` [H, v, d]."""

    def __init__(self, d_model: int, n_heads: int, cfg: MLAConfig, dtype,
                 device):
        super().__init__()
        nope, rope, vdim = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                            cfg.v_head_dim)
        self.q_down = weight((d_model, cfg.q_lora_rank), dtype, device)
        self.q_norm = nn.Module()
        self.q_norm.scale = weight((cfg.q_lora_rank,), torch.float32, device)
        self.q_up = weight((cfg.q_lora_rank, n_heads, nope + rope), dtype,
                           device)
        self.kv_down = weight((d_model, cfg.kv_lora_rank + rope), dtype,
                              device)
        self.kv_norm = nn.Module()
        self.kv_norm.scale = weight((cfg.kv_lora_rank,), torch.float32,
                                    device)
        self.kv_up = weight((cfg.kv_lora_rank, n_heads, nope + vdim), dtype,
                            device)
        self.o = weight((n_heads, vdim, d_model), dtype, device)

    def init_(self, generator: torch.Generator) -> None:
        """``mla_init``'s scales: each projection ``N(0, 1)`` truncated to
        [-2, 2] over sqrt(fan_in) (``o``'s fan-in is H · v), norms at 1."""
        for p in (self.q_down, self.q_up, self.kv_down, self.kv_up):
            truncated_normal_(p, generator, 1.0 / math.sqrt(p.shape[0]))
        H, vdim, _ = self.o.shape
        truncated_normal_(self.o, generator, 1.0 / math.sqrt(H * vdim))
        with torch.no_grad():
            self.q_norm.scale.fill_(1.0)
            self.kv_norm.scale.fill_(1.0)


def _project_q(m: MLA, x, cfg: MLAConfig, positions, rope_theta):
    cq = torch.einsum("bsd,dr->bsr", x, m.q_down)
    cq = rmsnorm_apply(m.q_norm.scale, cq)
    q = torch.einsum("bsr,rhk->bshk", cq, m.q_up)
    q_nope = q[..., :cfg.qk_nope_head_dim]
    q_rope = apply_rope(q[..., cfg.qk_nope_head_dim:], positions, rope_theta)
    return q_nope, q_rope


def _project_kv_latent(m: MLA, x, cfg: MLAConfig, positions, rope_theta):
    ckv = torch.einsum("bsd,dr->bsr", x, m.kv_down)
    c_kv = rmsnorm_apply(m.kv_norm.scale, ckv[..., :cfg.kv_lora_rank])
    k_rope = ckv[..., cfg.kv_lora_rank:][:, :, None, :]     # shared head
    k_rope = apply_rope(k_rope, positions, rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _write_latent(buf: torch.Tensor, new: torch.Tensor,
                  idx: torch.Tensor,
                  seq: Optional[tuple[int, int]] = None) -> None:
    """``buf[b, idx[b]:idx[b] + S] = new[b]`` in place, the start clamped
    into [0, T - S] as ``jax.lax.dynamic_update_slice`` clamps it.
    ``seq`` = (first slot, T): ``buf`` holds a tensor-parallel rank's
    slots ``[first, first + L)`` of a cache of T slots (cut by sequence)
    and takes the whole write restricted to them."""
    B, S = new.shape[:2]
    L = buf.shape[1]
    lo, T = (0, L) if seq is None else seq
    rows = torch.arange(B, device=buf.device)
    start = torch.clamp(idx.long(), 0, T - S)
    new = new.to(buf.dtype)
    if seq is None:
        cols = start[:, None] + torch.arange(S, device=buf.device)[None]
        buf[rows[:, None], cols] = new
        return
    if S == 1:
        attn_mod.write_held_slot(buf, start - lo, new[:, 0])
        return
    e = (lo + torch.arange(L, device=buf.device))[None] - start[:, None]
    hit = (e >= 0) & (e < S)                                  # [B, L]
    src = torch.where(hit, e, torch.zeros_like(e))
    buf.copy_(torch.where(hit[..., None], new[rows[:, None], src], buf))


def _latent_scores(q_lat, q_rope, c, rk, first, positions, idx, S, scale):
    """Every head's f32 scores [B, H, S, L] of the queries against the
    latent slots ``[first, first + L)`` (``c`` [B, L, r], ``rk`` [B, L,
    rope]), a slot past a query's position or the rows' written slots
    masked to NEG_INF."""
    s = (torch.einsum("bshr,btr->bhst", q_lat.float(), c.float())
         + torch.einsum("bshk,btk->bhst", q_rope.float(), rk.float())
         ) * scale
    t_pos = (first + torch.arange(c.shape[1], device=s.device)
             )[None, None, None, :]
    valid = t_pos <= positions[:, None, :, None]
    valid &= t_pos < (idx[:, None, None, None] + S)
    return torch.where(valid, s, torch.full_like(s, NEG_INF))


def _latent_attend(q_lat, q_rope, c_cache, r_cache, positions, idx, S,
                   scale) -> torch.Tensor:
    """The reference's absorbed attention over a whole latent cache: the
    scores' softmax, cast to the cache's dtype, times the latent in the
    cache's dtype.  Returns o_lat [B, S, H, r]."""
    probs = torch.softmax(_latent_scores(q_lat, q_rope, c_cache, r_cache, 0,
                                         positions, idx, S, scale), dim=-1)
    return torch.einsum("bhst,btr->bshr", probs.to(c_cache.dtype), c_cache)


def _merge_states(ml: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The ranks' softmax states ml [p, B, H, 1, 2] (each rank's max m
    and its sum l of exp(s - m)), in rank order, merged into the row's
    max m_g and sum l_g = sum_k l_k exp(m_k - m_g), added in ascending
    rank."""
    m_g = ml[..., 0:1].amax(0)
    w = torch.exp(ml[..., 0:1] - m_g)
    l_g = ml[0, ..., 1:] * w[0]
    for k in range(1, ml.shape[0]):
        l_g = l_g + ml[k, ..., 1:] * w[k]
    return m_g, l_g


def _latent_decode(q_lat, q_rope, c_cache, r_cache, positions, idx, scale,
                   seq, heads_group=None) -> torch.Tensor:
    """The absorbed one-token attention over a latent cache walked by
    sequence (``seq``, a :class:`repro_torch.quant.tp.SeqCut`: this
    rank's slots, or a whole cache walked as ``seq.ranks`` chunks merged
    alike; ``heads_group``: the rank holds only its heads).  In the
    reference's roundings as far as a rank's slots allow: every head's
    f32 scores over the slots (the heads' ``q_lat`` and ``q_rope``
    gathered first when the rank holds only its heads), the ranks'
    softmax states (m, l) gathered and merged into the row's max and sum
    (:func:`_merge_states`), each slot's probability exp(s - m) / l
    rounded to the cache's dtype as the reference rounds its softmax,
    the rank's f32 sum of probability times latent, and the ranks' sums
    gathered, added in ascending rank and rounded to the cache's dtype
    (the reference's one bf16 product accumulates in f32 and rounds
    once).  The reference has no kernel here: plain torch.  Returns the
    rank's heads' o_lat [B, 1, H_r, r]: the whole cache's walk as ranks
    bit for bit, and within the order of the f32 sums (the row's sum
    and the latent's) of :func:`_latent_attend`."""
    r = q_lat.shape[-1]
    H_r = q_lat.shape[2]
    both = torch.cat([q_lat, q_rope], -1)
    if heads_group is not None:
        both = _tp.gather_heads(heads_group, both, 2)
    q_lat, q_rope = both[..., :r], both[..., r:]
    group = seq.group
    if group is None:
        L = c_cache.shape[1] // seq.ranks
        pieces = [(c_cache[:, k * L:(k + 1) * L].contiguous(),
                   r_cache[:, k * L:(k + 1) * L].contiguous(), k * L)
                  for k in range(seq.ranks)]
    else:
        pieces = [(c_cache, r_cache, seq.first)]

    def ranks_of(ts):
        """The ranks' tensors stacked in rank order."""
        if group is None:
            return torch.stack(ts)
        return group.all_gather(ts[0].contiguous()).reshape(
            group.size, *ts[0].shape)
    scores, states = [], []
    for c, rk, first in pieces:
        s = _latent_scores(q_lat, q_rope, c, rk, first, positions, idx, 1,
                           scale)
        m = s.amax(-1, keepdim=True)                          # [B, H, 1, 1]
        scores.append(s)
        states.append(torch.cat([m, torch.exp(s - m).sum(-1, keepdim=True)],
                                -1))
    m_g, l_g = _merge_states(ranks_of(states))
    parts = [torch.einsum("bhst,btr->bshr",
                          (torch.exp(s - m_g) / l_g).to(c.dtype).float(),
                          c.float())
             for s, (c, _, _) in zip(scores, pieces)]
    parts = ranks_of(parts)
    acc = parts[0]
    for k in range(1, parts.shape[0]):
        acc = acc + parts[k]
    if heads_group is not None:
        rank = heads_group.rank
        acc = acc[:, :, rank * H_r:(rank + 1) * H_r]
    return acc.to(c_cache.dtype)


def mla_apply(m: MLA, x: torch.Tensor, positions: torch.Tensor,
              cfg: MLAConfig, *, rope_theta: float = 10000.0,
              cache: Optional[dict] = None,
              aligned_positions: bool = False) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d] in x's dtype.  ``cache`` ({"c_kv" [B, T,
    kv_lora], "k_rope" [B, T, rope], "index" [B] int32}) is written in
    place and its index advanced by S.  ``aligned_positions``:
    ``positions`` is ``arange(S)`` in every row (the cacheless path may
    then attend on kernel 12).

    A tensor-parallel rank's layer holds its heads of ``q_up`` and
    ``kv_up`` (:func:`repro_torch.parallel.sharding.mla_cuts`); the
    down-projections and ``o`` stay whole, and the heads' outputs are
    gathered (one all-gather) before ``o``.  Its latent cache may hold
    only the rank's slots (cut by sequence, ``Model.init_cache``): a
    prefill then gathers the rows' slots whole (one gather, the
    unsharded function bit for bit), a decode step merges the ranks'
    softmax states and latent sums (:func:`_latent_decode`: three
    gathers, within the order of two f32 sums; bitwise an unsharded run
    under ``kernels.decode_attention.walk_as_ranks``)."""
    B, S, _ = x.shape
    nope = cfg.qk_nope_head_dim
    scale = 1.0 / math.sqrt(cfg.qk_head_dim)
    group = _tp.group_of(m)

    q_nope, q_rope = _project_q(m, x, cfg, positions, rope_theta)
    c_kv, k_rope = _project_kv_latent(m, x, cfg, positions, rope_theta)

    if cache is None:
        # materialized: standard MHA over up-projected K/V
        kv = torch.einsum("bsr,rhk->bshk", c_kv, m.kv_up)
        H = kv.shape[2]
        k = torch.cat([kv[..., :nope], k_rope[:, :, None, :].expand(
            B, S, H, cfg.qk_rope_head_dim)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        out = attn_mod.cacheless_attention(
            q, k, kv[..., nope:], positions, "causal",
            aligned_positions=aligned_positions)
        return _out_proj(m, out.to(x.dtype), group)

    # absorbed: score and fold values directly against the latent cache
    idx = cache["index"].clone()
    c_cache, r_cache = cache["c_kv"], cache["k_rope"]
    # a tensor-parallel rank's slots of a latent cut by sequence (or a
    # whole latent walked as the ranks walk theirs), else None
    seq = _tp.seq_cut("c_kv", c_cache)
    at = None if seq is None else seq.held
    _write_latent(c_cache, c_kv, idx, at)
    _write_latent(r_cache, k_rope, idx, at)
    cache["index"] += S

    w_uk = m.kv_up[..., :nope]                  # [r, H, nope]
    w_uv = m.kv_up[..., nope:]                  # [r, H, v]
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, w_uk)
    if S == 1 and seq is not None:
        o_lat = _latent_decode(q_lat, q_rope, c_cache, r_cache, positions,
                               idx, scale, seq, group)
    else:
        if seq is not None:
            # a prefill: the rows' latent slots gathered whole (one gather)
            c_cache, r_cache = _tp.gather_slots(seq, [c_cache, r_cache])
        o_lat = _latent_attend(q_lat, q_rope, c_cache, r_cache, positions,
                               idx, S, scale)
    out = torch.einsum("bshr,rhv->bshv", o_lat, w_uv)
    return _out_proj(m, out.to(x.dtype), group)


def _out_proj(m: MLA, out: torch.Tensor, group) -> torch.Tensor:
    """The heads' outputs [B, S, H, v] (a rank's heads gathered first)
    through the whole ``o``."""
    if group is not None:
        out = _tp.gather_heads(group, out, 2)
    return torch.einsum("bshv,hvd->bsd", out, m.o)


def init_mla_cache(batch: int, max_len: int, cfg: MLAConfig,
                   dtype=torch.bfloat16, device=None) -> dict:
    return {
        "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                              dtype=dtype, device=device),
        "index": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
