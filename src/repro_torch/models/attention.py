"""Attention over the ring and the paged KV cache (port of
``repro/models/attention.py``).

Shapes: q [B, Sq, H, D]; k/v [B, Skv, KH, D]; GQA groups G = H // KH are
kept factored so KV is never repeated in memory.

The cache is a dict of tensors per layer that this module updates **in
place** (the reference returns a new cache; here the engine hands in
views of its batched cache and the writes land in it directly).  A
paged cache dict shares its pools among all rows and reads them through
``block_tables``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels.flash_attention import row_lse
from repro_torch.kernels.ref import NEG_INF, div
from repro_torch.quant import tp as _tp
from repro_torch.quant.linear import (QuantizedLinear, _resolve_use_kernel,
                                      quantized_out_proj, quantized_qkv_proj)
from .layers import apply_rope, rmsnorm_apply, truncated_normal_, weight

EMPTY_SLOT = 2 ** 30
# without a cache, sequences longer than this attend blockwise (the
# reference's rule): dense scores would grow as S**2
DENSE_SEQ_THRESHOLD = 2048


class Attention(nn.Module):
    """Projection weights: ``q`` [d, H, Dh], ``k``/``v`` [d, KH, Dh],
    ``o`` [H, Dh, d]; under a plan covering attention, ``qkv`` and ``o``
    become :class:`QuantizedLinear` leaves.  ``n_kv_heads`` is the number
    of KV heads this rank holds (all of them unless tensor parallelism
    sharded them): the KV cache's head count.  With ``qk_norm`` the layer
    also holds ``q_norm`` and ``k_norm`` [Dh] f32: the scales of an
    rmsnorm of each q and k head, taken before RoPE."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int,
                 head_dim: int, dtype, device, qk_norm: bool = False):
        super().__init__()
        self.n_kv_heads = n_kv_heads
        self.q = weight((d_model, n_heads, head_dim), dtype, device)
        self.k = weight((d_model, n_kv_heads, head_dim), dtype, device)
        self.v = weight((d_model, n_kv_heads, head_dim), dtype, device)
        self.o = weight((n_heads, head_dim, d_model), dtype, device)
        if qk_norm:
            self.q_norm = weight((head_dim,), torch.float32, device)
            self.k_norm = weight((head_dim,), torch.float32, device)

    def init_(self, generator: torch.Generator) -> None:
        d = self.q.shape[0]
        for p in (self.q, self.k, self.v):
            truncated_normal_(p, generator, 1.0 / math.sqrt(d))
        H, Dh, _ = self.o.shape
        truncated_normal_(self.o, generator, 1.0 / math.sqrt(H * Dh))
        if hasattr(self, "q_norm"):
            with torch.no_grad():
                self.q_norm.fill_(1.0)
                self.k_norm.fill_(1.0)


# ---------------------------------------------------------------------------
# Masks + dense attention (prefill / multi-token path)
# ---------------------------------------------------------------------------
def _mask_bias(q_pos: torch.Tensor, kv_pos: torch.Tensor, kind: str,
               window: Optional[int] = None,
               prefix_len: Optional[int] = None) -> torch.Tensor:
    """Additive bias [..., Sq, Skv]; 0 where attending is allowed.
    ``"prefix"``: bidirectional among the keys before ``prefix_len``,
    causal elsewhere."""
    q = q_pos[..., :, None]
    k = kv_pos[..., None, :]
    if kind == "causal":
        ok = k <= q
    elif kind == "sliding":
        ok = (k <= q) & (k > q - window)
    elif kind == "prefix":
        ok = (k <= q) | (k < prefix_len)
    elif kind == "full":
        ok = k < 2 ** 29  # everything except padding/empty sentinel slots
    else:
        raise ValueError(f"unknown mask kind {kind!r}")
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, kv_pos: torch.Tensor, kind: str,
                    window: Optional[int] = None,
                    prefix_len: Optional[int] = None) -> torch.Tensor:
    B, Sq, H, D = q.shape
    KH = k.shape[2]
    Dv = v.shape[-1]
    G = H // KH
    qg = q.reshape(B, Sq, KH, G, D)
    scale = 1.0 / math.sqrt(D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * scale
    bias = _mask_bias(q_pos, kv_pos, kind, window, prefix_len)
    scores = scores + bias[:, None, None]
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, H, Dv)


# ---------------------------------------------------------------------------
# Blockwise attention (online softmax over KV blocks) and its backward:
# the reference's custom VJP
# ---------------------------------------------------------------------------
def _pad_blocks(a: torch.Tensor, n: int, value=0.0) -> torch.Tensor:
    """``a`` padded with ``value`` along dim 1 to ``n`` entries."""
    if a.shape[1] == n:
        return a
    pad = [0, 0] * (a.dim() - 2) + [0, n - a.shape[1]]
    return torch.nn.functional.pad(a, pad, value=value)


def blockwise_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, kv_pos: torch.Tensor, kind: str,
                      window: Optional[int] = None,
                      prefix_len: Optional[int] = None, q_block: int = 512,
                      kv_block: int = 1024
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``blockwise_attention`` forward (its ``_fwd_impl``):
    q blocks of ``q_block`` rows, each sweeping KV blocks of ``kv_block``
    keys with the online-softmax state (m, l, acc) in f32, so no [Sq,
    Skv] score matrix is built.  Padded queries get position -1 and
    padded keys the 2**30 sentinel; the mask is the additive -1e30 bias
    on f32 positions.  The rounding is the reference's: the score einsum
    runs in q's dtype and is then cast to f32, the PV einsum in v's dtype
    (p rounded to it) is added to the f32 accumulator.  Returns (out f32
    [B, Sq, H, Dv] before the cast to q's dtype, lse [B, H, Sq]: m +
    log(l), or 1e30 for a row with no visible key, kernel 12's rule)."""
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // KH
    scale = 1.0 / math.sqrt(D)
    q_block = min(q_block, Sq)
    kv_block = min(kv_block, Skv)
    nq = -(-Sq // q_block)
    nk = -(-Skv // kv_block)
    q = _pad_blocks(q, nq * q_block)
    q_pos = _pad_blocks(q_pos, nq * q_block, -1)
    k = _pad_blocks(k, nk * kv_block)
    v = _pad_blocks(v, nk * kv_block)
    kv_pos = _pad_blocks(kv_pos, nk * kv_block, EMPTY_SLOT)
    qp, kp = q_pos.float(), kv_pos.float()
    outs, lses = [], []
    for i in range(nq):
        rows = slice(i * q_block, (i + 1) * q_block)
        qg = q[:, rows].reshape(B, q_block, KH, G, D)
        m = torch.full((B, KH, G, q_block), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, KH, G, q_block, Dv), dtype=torch.float32,
                          device=q.device)
        for j in range(nk):
            keys = slice(j * kv_block, (j + 1) * kv_block)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qg,
                             k[:, keys]).float() * scale
            s = s + _mask_bias(qp[:, rows], kp[:, keys], kind,
                               window, prefix_len)[:, None, None]
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype), v[:, keys])
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, q_block, H, Dv))
        lses.append(row_lse(m, l).reshape(B, H, q_block))
    return (torch.cat(outs, dim=1)[:, :Sq],
            torch.cat(lses, dim=2)[..., :Sq])


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_pos: torch.Tensor, kv_pos: torch.Tensor, kind: str,
                        window: Optional[int] = None,
                        prefix_len: Optional[int] = None, q_block: int = 512,
                        kv_block: int = 1024) -> torch.Tensor:
    """:func:`blockwise_forward`'s output in q's dtype: the plain version
    of the path that :func:`attention_apply` gives kernel 12."""
    return blockwise_forward(q, k, v, q_pos, kv_pos, kind, window,
                             prefix_len, q_block, kv_block)[0].to(q.dtype)


def _block_sees_keys(kind: str, window, prefix_len, r0: int, r1: int,
                     c0: int, c1: int) -> bool:
    """Whether any query of positions [r0, r1] sees a key of [c0, c1]
    under ``kind`` (aligned positions: query i and key i at position
    i)."""
    if kind == "full":
        return True
    if kind == "sliding":
        return c0 <= r1 and c1 > r0 - window
    return c0 <= r1 or (kind == "prefix" and c0 < (prefix_len or 0))


def _heads_major(a: torch.Tensor, KH: int, blk: int) -> torch.Tensor:
    """[B, n * blk, KH * G, d] -> [n, B, KH, G * blk, d] contiguous: the
    rows of a block of each KV head's G query heads side by side, so one
    batched product covers a block's whole GQA group."""
    B, S, H, d = a.shape
    G = H // KH
    a = a.reshape(B, S // blk, blk, KH, G, d).permute(1, 0, 3, 4, 2, 5)
    return a.reshape(S // blk, B, KH, G * blk, d).contiguous()


def blockwise_backward(q, k, v, q_pos, kv_pos, lse, do, kind: str,
                       window: Optional[int] = None,
                       prefix_len: Optional[int] = None,
                       f32_scores: bool = False, q_block: int = 512,
                       kv_block: int = 1024):
    """The reference's ``fa_bwd`` (``attention.py:203``-``:250``) in f32,
    block by block: for each q block, over the KV blocks its queries
    see, p = exp(s - lse) and dp = do v^T; then delta = rowsum(p dp);
    then for each of those KV blocks dv += p^T do, ds = p (dp - delta) /
    sqrt(D), dq += ds k, dk += ds^T q.  ``lse`` [B, H, Sq] is the
    forward's rows' log-sum-exp.  Only the [q_block, Skv] p and dp of one
    q block exist at a time, each KV head's G query heads stacked in
    their rows (batched products over B x KH, no permute inside the
    loop).

    delta is rowsum(do . o) in exact arithmetic, and the reference takes
    it from the forward's output o.  That o was summed from p rounded to
    bf16, so its delta misses the backward's own p by ~2**-9 of |do| |o|,
    and the rows of ds no longer sum to zero: dq gains that error times
    the rows' attention-weighted mean key, which is large when the keys
    share a component, as a trained layer's do.  Summed from the p and
    dp that ds uses, the rows of ds sum to zero and dq keeps the
    accuracy of dk and dv.

    The scores are recomputed as the forward computed them: in f32 from
    f32 operands after kernel 12 (``f32_scores``; its positions are then
    ``arange``, so a block pair no query of which sees a key of is
    skipped: its p is exp(-1e30 - lse) = 0 exactly), else the
    reference's product in q's dtype.  Returns (dq, dk, dv) in q's, k's
    and v's dtypes."""
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = 1.0 / math.sqrt(D)
    q_block = min(q_block, Sq)
    kv_block = min(kv_block, Skv)
    nq = -(-Sq // q_block)
    nk = -(-Skv // kv_block)
    Sqp, Skp = nq * q_block, nk * kv_block
    # padded rows: do = 0 and lse = 1e30 (p = 0), so they add nothing
    qp = _pad_blocks(q_pos, Sqp, -1).float()
    kp = _pad_blocks(kv_pos, Skp, EMPTY_SLOT).float()
    qh = _heads_major(_pad_blocks(q, Sqp), KH, q_block)    # q's dtype
    q32 = qh.float()
    doh = _heads_major(_pad_blocks(do.float(), Sqp), KH, q_block)
    # [nq, B, KH, G * q_block, 1]: the rows' lse
    lse = _heads_major(_pad_blocks(lse.transpose(1, 2)[..., None], Sqp,
                                   1e30), KH, q_block)
    kh = _heads_major(_pad_blocks(k, Skp), KH, kv_block)   # [nk,B,KH,kb,D]
    k32 = kh.float()
    v32 = _heads_major(_pad_blocks(v.float(), Skp), KH, kv_block)
    dq = torch.zeros_like(q32)
    dk = torch.zeros_like(k32)
    dv = torch.zeros_like(v32)
    for i in range(nq):
        r0 = i * q_block
        seen = []
        for j in range(nk):
            c0 = j * kv_block
            if f32_scores and not _block_sees_keys(
                    kind, window, prefix_len, r0, r0 + q_block - 1, c0,
                    c0 + kv_block - 1):
                continue
            if f32_scores:
                s = torch.matmul(q32[i], k32[j].transpose(-1, -2))
            else:
                s = torch.matmul(qh[i], kh[j].transpose(-1, -2)).float()
            bias = _mask_bias(qp[:, r0:r0 + q_block],
                              kp[:, c0:c0 + kv_block], kind, window,
                              prefix_len)
            s = (s * scale).view(B, KH, G, q_block, kv_block) \
                + bias[:, None, None]
            p = torch.exp(s.view(B, KH, G * q_block, kv_block) - lse[i])
            dp = torch.matmul(doh[i], v32[j].transpose(-1, -2))
            seen.append((j, p, dp))
        delta = 0.0
        for _, p, dp in seen:
            delta = delta + (p * dp).sum(-1, keepdim=True)
        for j, p, dp in seen:
            dv[j] += torch.matmul(p.transpose(-1, -2), doh[i])
            ds = p * (dp - delta) * scale
            dq[i] += torch.matmul(ds, k32[j])
            dk[j] += torch.matmul(ds.transpose(-1, -2), q32[i])
        del seen

    def back(a, S, heads, blk):   # [n, B, KH, G * blk, d] -> [B, S, H, d]
        n, _, _, _, d = a.shape
        g = heads // KH
        a = a.reshape(n, B, KH, g, blk, d).permute(1, 0, 4, 2, 3, 5)
        return a.reshape(B, n * blk, heads, d)[:, :S]
    return (back(dq, Sq, H, q_block).to(q.dtype),
            back(dk, Skv, KH, kv_block).to(k.dtype),
            back(dv, Skv, KH, kv_block).to(v.dtype))


class CachelessAttention(torch.autograd.Function):
    """Differentiable cacheless attention above ``DENSE_SEQ_THRESHOLD``:
    the reference's ``blockwise_attention`` with its custom VJP.

    Forward: kernel 12 with ``lse`` (``kernel``: the card with aligned
    positions; also its plain version on CPU tensors) or
    :func:`blockwise_forward`; both give (out, lse), and only lse and
    the inputs are kept for the backward (O(S D), never O(S^2)).
    Backward: :func:`blockwise_backward` in plain torch (the reference
    computes it outside any Pallas kernel).  Grad mode is off inside
    ``forward``, so kernel 12 launches there whatever its inputs
    require.  ``kernel`` takes v at q's head size (the caller pads a
    narrower v)."""

    @staticmethod
    def forward(ctx, q, k, v, positions, kind, window, prefix_len, kernel):
        if kernel:
            out, lse = _fa.flash_attention(
                q.contiguous(), k.contiguous(), v.contiguous(),
                causal=kind != "full",
                window=window if kind == "sliding" else None,
                prefix_len=prefix_len if kind == "prefix" else 0,
                return_lse=True)
        else:
            out, lse = blockwise_forward(q, k, v, positions, positions,
                                         kind, window, prefix_len)
            out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, positions, lse)
        ctx.mask = (kind, window, prefix_len, kernel)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, positions, lse = ctx.saved_tensors
        kind, window, prefix_len, kernel = ctx.mask
        dq, dk, dv = blockwise_backward(q, k, v, positions, positions, lse,
                                        do, kind, window, prefix_len,
                                        f32_scores=kernel)
        return dq, dk, dv, None, None, None, None, None


def cacheless_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        positions: torch.Tensor, kind: str,
                        window: Optional[int] = None,
                        aligned_positions: bool = False,
                        prefix_len: Optional[int] = None) -> torch.Tensor:
    """Attention of a whole sequence over itself, without a cache, as the
    reference: :func:`dense_attention` up to ``DENSE_SEQ_THRESHOLD``
    tokens, the online softmax over KV blocks above it.

    A CUDA call with the model's own positions (``aligned_positions``:
    ``arange(S)`` in every row) is one launch of kernel 12, whose causal
    mask is aligned top-left: a ``"full"`` mask (DiT) at every length, a
    causal, sliding or prefix one above the threshold.  The kernel takes
    no positions operand, so caller-given positions take the dense or
    blockwise path on either device, as CPU tensors do: a dispatch on
    the input, not a fallback on failure.  Above the threshold a call
    that needs a gradient goes through :class:`CachelessAttention` (the
    same forward, and the reference's backward); at or below it the
    dense path is plain autograd.

    The kernel takes v at q's head size; a narrower v (MLA: q and k at
    192, v at 128) is padded with zero columns for the launch and the
    output cut back to v's width, which is exact: a zero column adds
    nothing to the others."""
    kernel = aligned_positions and q.is_cuda
    long = q.shape[1] > DENSE_SEQ_THRESHOLD
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    Dv = v.shape[-1]
    if kernel and Dv < q.shape[-1] and (long or kind == "full"):
        v = torch.nn.functional.pad(v, (0, q.shape[-1] - Dv))
    if long and grad:
        return CachelessAttention.apply(q, k, v, positions, kind, window,
                                        prefix_len, kernel)[..., :Dv]
    if kernel and (kind == "full" or (
            long and kind in ("causal", "sliding", "prefix"))):
        out = _fa.flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(),
            causal=kind != "full",
            window=window if kind == "sliding" else None,
            prefix_len=prefix_len if kind == "prefix" else 0)
        return out[..., :Dv]
    if q.shape[1] <= DENSE_SEQ_THRESHOLD:
        return dense_attention(q, k, v, positions, positions, kind, window,
                               prefix_len)
    return blockwise_attention(q, k, v, positions, positions, kind, window,
                               prefix_len)


# ---------------------------------------------------------------------------
# Ring-buffer cache update (in place)
# ---------------------------------------------------------------------------
def write_held_slot(buf: torch.Tensor, at: torch.Tensor,
                    new: torch.Tensor) -> None:
    """``buf[b, at[b]] = new[b]`` in place for the rows whose slot ``at``
    lies in ``buf``'s [0, L) (a rank's slots of a cache cut by
    sequence), the others untouched: each row writes its own slot, the
    value it holds where the slot is another rank's, with no host
    sync."""
    B, L = buf.shape[:2]
    rows = torch.arange(B, device=buf.device)
    mine = (at >= 0) & (at < L)
    at = torch.where(mine, at, torch.zeros_like(at))
    keep = mine.reshape(B, *([1] * (new.dim() - 1)))
    buf[rows, at] = torch.where(keep, new, buf[rows, at])


def _ring_update(buf: torch.Tensor, new: torch.Tensor, idx: torch.Tensor,
                 valid_len: Optional[torch.Tensor] = None,
                 seq: Optional[tuple[int, int]] = None) -> None:
    """Write ``new`` (S entries starting at logical position ``idx[b]``)
    into the capacity-``cap`` ring ``buf`` at ``slot = position % cap``,
    in place.

    ``valid_len`` [B] (default S) counts the leading valid entries:
    bucket-padded prefill marks its pad suffix invalid so pads never
    consume ring capacity.  Three paths, as in the reference:
      * S == 1 (decode): one slot per row;
      * S >= cap: the last ``cap`` valid entries, aligned to their slots;
      * otherwise a scatter where invalid entries keep the slot's old
        content (the reference's ``mode="drop"``; torch has no drop mode,
        and the S < cap slots of a row are distinct, so writing the old
        value back is the same).

    ``seq`` = (first slot, cap): ``buf`` holds a tensor-parallel rank's
    slots ``[first, first + L)`` of a ring of ``cap`` slots (cut by
    sequence), and receives exactly the whole ring's write restricted to
    them on each path: the one slot if it is the rank's, the rank's
    range of the whole shifted ring, and each held slot's entry (by
    gather, so no two writes meet).
    """
    L = buf.shape[1]
    lo, cap = (0, L) if seq is None else seq
    B, S = new.shape[:2]
    new = new.to(buf.dtype)
    rows = torch.arange(B, device=buf.device)
    start = idx.long() % cap
    if S == 1:
        if seq is None:
            buf[rows, start] = new[:, 0]
        else:
            write_held_slot(buf, start - lo, new[:, 0])
        return
    if S >= cap:
        if valid_len is None:
            s0 = torch.full_like(start, S - cap)
        else:
            s0 = torch.clamp(valid_len.long() - cap, 0, S - cap)
        shift = (idx.long() + s0) % cap
        j = torch.arange(lo, lo + L, device=buf.device)
        src = s0[:, None] + (j[None, :] - shift[:, None]) % cap   # [B, L]
        buf.copy_(new[rows[:, None], src])
        return
    if seq is not None:
        # the entry landing on each held slot, if any
        g = torch.arange(lo, lo + L, device=buf.device)
        e = (g[None, :] - start[:, None]) % cap                   # [B, L]
        hit = e < (S if valid_len is None else
                   torch.clamp(valid_len.long(), max=S)[:, None])
        src = torch.where(hit, e, torch.zeros_like(e))
        keep = hit.reshape(B, L, *([1] * (new.dim() - 2)))
        buf.copy_(torch.where(keep, new[rows[:, None], src], buf))
        return
    ar = torch.arange(S, device=buf.device)
    slots = (start[:, None] + ar[None, :]) % cap                 # [B, S]
    vals = new
    if valid_len is not None:
        keep = ar[None, :] < valid_len.long()[:, None]
        keep = keep.reshape(B, S, *([1] * (new.dim() - 2)))
        vals = torch.where(keep, new, buf[rows[:, None], slots])
    buf[rows[:, None], slots] = vals


# ---------------------------------------------------------------------------
# Paged (block-table) cache update (in place)
# ---------------------------------------------------------------------------
def _paged_slots(block_tables: torch.Tensor, idx: torch.Tensor, S: int,
                 bs: int, valid_len: Optional[torch.Tensor] = None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pool addresses of S writes per row starting at logical position
    ``idx[b]``: (block, offset, invalid), each [B, S].

    Position p lands in pool block ``block_tables[b, p // bs]`` at offset
    ``p % bs``.  Invalid writes — pad entries beyond ``valid_len``,
    positions past the table (sentinel-index rows), and entries whose
    logical block is unallocated (table entry 0, the null block) — get
    block 0; :func:`_paged_write` makes them leave the pool untouched."""
    nb = block_tables.shape[1]
    dev = block_tables.device
    p = idx.long()[:, None] + torch.arange(S, device=dev)[None]
    logical = torch.div(p, bs, rounding_mode="floor")
    offs = p % bs
    phys = torch.gather(block_tables.long(), 1, logical.clamp(0, nb - 1))
    invalid = (logical >= nb) | (logical < 0) | (phys <= 0)
    if valid_len is not None:
        invalid |= (torch.arange(S, device=dev)[None]
                    >= valid_len.long()[:, None])
    return phys.masked_fill(invalid, 0), offs, invalid


def _paged_write(pool: torch.Tensor, new: torch.Tensor, slots) -> None:
    """Write ``new`` [B, S, ...] into ``pool`` [NB, bs, ...] in place at
    the addresses of :func:`_paged_slots`.

    The reference drops invalid writes with ``mode="drop"``.  torch has
    no drop mode, and a boolean filter would sync the host on every
    layer, so each invalid write goes to ``(block 0, offset)`` carrying
    the value the null block already holds there: only invalid writes
    land in block 0, they all write the same value, and valid writes
    never collide because blocks belong to one sequence."""
    phys, offs, invalid = slots
    keep = invalid.reshape(*invalid.shape, *([1] * (new.dim() - 2)))
    pool[phys, offs] = torch.where(keep, pool[0][offs], new.to(pool.dtype))


def _paged_update(pool: torch.Tensor, new: torch.Tensor,
                  block_tables: torch.Tensor, idx: torch.Tensor,
                  valid_len: Optional[torch.Tensor] = None) -> None:
    """Write ``new`` (S entries starting at logical position ``idx[b]``
    per batch row) into a shared block pool [NB, bs, ...] through the
    per-row block tables [B, nb], in place; invalid writes leave the
    pool untouched (the reference's ``_paged_update``)."""
    _paged_write(pool, new, _paged_slots(block_tables, idx, new.shape[1],
                                         pool.shape[1], valid_len))


def _gather_paged(pool: torch.Tensor, block_tables: torch.Tensor
                  ) -> torch.Tensor:
    """A row-linear [B, nb*bs, ...] copy of a block pool (the chunked
    prefill's plain path; unallocated table entries read the all-empty
    null block and self-mask)."""
    B, nb = block_tables.shape
    g = pool[block_tables.long()]
    return g.reshape(B, nb * pool.shape[1], *pool.shape[2:])


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, position, head) symmetric int8: x [B, S, KH, D] ->
    (q int8, scale [B, S, KH]) with ``scale = amax / 127 + 1e-12``."""
    x32 = x.float()
    amax = torch.amax(torch.abs(x32), dim=-1, keepdim=True)
    scale = div(amax, 127.0) + 1e-12
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale[..., 0]


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[..., None]


def _decode_attention_cached(q, ck, cv, cpos, q_pos, k_scale, v_scale,
                             window):
    """One-token decode over the ring cache on the flash-decode kernel
    (its plain version for CPU tensors).  q [B, 1, H, D]; ck/cv
    [B, S, KH, D]; returns [B, 1, H, D].  Under tensor parallelism H and
    KH are this rank's heads and the call is the same
    (:func:`repro_torch.quant.tp.decode_attn`)."""
    B, _, H, D = q.shape
    KH = ck.shape[2]
    q4 = q[:, 0].reshape(B, KH, H // KH, D)
    out4 = _tp.decode_attn(q4, ck, cv, cpos, q_pos.to(torch.int32),
                           k_scale, v_scale, window=window,
                           use_kernel=_resolve_use_kernel(None))
    return out4.reshape(B, 1, H, D).to(q.dtype)


def _decode_attention_seq(q, ck, cv, cpos, q_pos, k_scale, v_scale, window,
                          seq, heads_cut: bool) -> torch.Tensor:
    """One-token decode over a ring cache walked by sequence (``seq``, a
    :class:`repro_torch.quant.tp.SeqCut`): kernel 9 over the rank's
    slots, the ranks' partials gathered, kernel 10 merging them
    (:func:`repro_torch.quant.tp.decode_attn_seq`).  q [B, 1, H, D]
    (``heads_cut``: the rank's query heads); ck/cv [B, L, KH, D] the
    rank's slots; returns [B, 1, H, D]."""
    B, _, H, D = q.shape
    KH = ck.shape[2]
    q4 = q[:, 0].reshape(B, KH, H // KH, D)
    out4 = _tp.decode_attn_seq(seq, q4, ck, cv, cpos,
                               q_pos.to(torch.int32), k_scale, v_scale,
                               window=window, heads_cut=heads_cut,
                               use_kernel=_resolve_use_kernel(None))
    return out4.reshape(B, 1, H, D).to(q.dtype)


def _decode_attention_paged_cached(q, ck, cv, cpos, bt, q_pos, k_scale,
                                   v_scale, window):
    """One-token decode over the paged cache on the paged flash-decode
    kernel (its plain version for CPU tensors).  q [B, 1, H, D]; pools
    [NB, bs, KH, D]; bt [B, nb]; returns [B, 1, H, D].  Under tensor
    parallelism H and KH are this rank's heads, as in
    :func:`_decode_attention_cached`."""
    B, _, H, D = q.shape
    KH = ck.shape[2]
    q4 = q[:, 0].reshape(B, KH, H // KH, D)
    out4 = _tp.decode_attn_paged(q4, ck, cv, cpos, bt, q_pos.to(torch.int32),
                                 k_scale, v_scale, window=window,
                                 use_kernel=_resolve_use_kernel(None))
    return out4.reshape(B, 1, H, D).to(q.dtype)


def _paged_cache_apply(cache: dict, k, v, positions, q, mask_kind,
                       window, prefix_len=None) -> torch.Tensor:
    """Cache write + attend for a paged (block-table) cache dict, in
    place.  A single token attends on the paged kernel; more tokens (a
    prefill chunk) gather the pools, dequantize and run
    :func:`dense_attention`, as in the reference.  Under the ``"prefix"``
    mask a chunk sees only the prefix keys already written (ROADMAP
    C.12, as the reference)."""
    idx = cache["index"]
    bt = cache["block_tables"]
    S = positions.shape[1]
    valid_len = torch.sum(positions < 2 ** 29, dim=1).to(torch.int32)
    quantized = cache["k_pages"].dtype == torch.int8
    # one set of write addresses for every pool of the layer
    slots = _paged_slots(bt, idx, S, cache["k_pages"].shape[1], valid_len)
    cks = cvs = None
    if quantized:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        _paged_write(cache["k_pages"], kq, slots)
        _paged_write(cache["v_pages"], vq, slots)
        _paged_write(cache["k_scale_pages"], ks, slots)
        _paged_write(cache["v_scale_pages"], vs, slots)
        cks, cvs = cache["k_scale_pages"], cache["v_scale_pages"]
    else:
        _paged_write(cache["k_pages"], k, slots)
        _paged_write(cache["v_pages"], v, slots)
    _paged_write(cache["pos_pages"], positions.to(torch.int32), slots)
    ck, cv, cpos = cache["k_pages"], cache["v_pages"], cache["pos_pages"]
    cache["index"] += S
    if S == 1:
        return _decode_attention_paged_cached(
            q, ck, cv, cpos, bt, positions[:, 0], cks, cvs,
            window if mask_kind == "sliding" else None)
    k_lin = _gather_paged(ck, bt)
    v_lin = _gather_paged(cv, bt)
    pos_lin = _gather_paged(cpos, bt)
    if quantized:
        k_lin = _dequantize_kv(k_lin, _gather_paged(cks, bt)).to(q.dtype)
        v_lin = _dequantize_kv(v_lin, _gather_paged(cvs, bt)).to(q.dtype)
    return dense_attention(q, k_lin, v_lin, positions, pos_lin, mask_kind,
                           window, prefix_len)


# ---------------------------------------------------------------------------
# Full module apply
# ---------------------------------------------------------------------------
def attention_apply(attn: Attention, x: torch.Tensor,
                    positions: torch.Tensor, *, mask_kind: str = "causal",
                    window: Optional[int] = None,
                    rope_theta: float = 10000.0,
                    cache: Optional[dict] = None,
                    use_rope: bool = True,
                    residual: Optional[torch.Tensor] = None,
                    aligned_positions: bool = False,
                    prefix_len: Optional[int] = None) -> torch.Tensor:
    """Self-attention over ``x`` [B, S, d]; returns [B, S, d].

    ``cache`` — a ring dict ({"k", "v", "pos", "index"[, "k_scale",
    "v_scale"]}) or a paged dict ({"k_pages", "v_pages", "pos_pages",
    "block_tables", "index"[, "k_scale_pages", "v_scale_pages"]}) — is
    written in place and attended over.  ``residual`` is added to the
    output, inside the out-projection's epilogue on the quantized path.
    Without a cache the sequence attends over itself
    (:func:`cacheless_attention`); ``aligned_positions`` says that
    ``positions`` is ``arange(S)`` in every row.  ``use_rope=False``
    leaves q and k unrotated (DiT's attention).  ``prefix_len`` is the
    ``"prefix"`` mask's bidirectional span; a one-token decode under it
    walks as causal (every cached key is at or before the query), as in
    the reference.  A layer with ``q_norm``/``k_norm`` rmsnorms each q
    and k head after the projection (the wide int8 output is cast to
    x's dtype and split first) and before RoPE.
    """
    B, S, _ = x.shape
    qkv_w = getattr(attn, "qkv", None)
    if isinstance(qkv_w, QuantizedLinear):
        o_w = attn.o
        H = (o_w.q if isinstance(o_w, QuantizedLinear) else o_w).shape[0]
        KH = (qkv_w.q.shape[1] - H) // 2
        wide = quantized_qkv_proj(qkv_w, x).to(x.dtype)
        q, k, v = torch.split(wide, (H, KH, KH), dim=2)
    else:
        q = torch.einsum("bsd,dhk->bshk", x, attn.q)
        k = torch.einsum("bsd,dhk->bshk", x, attn.k)
        v = torch.einsum("bsd,dhk->bshk", x, attn.v)
    if hasattr(attn, "q_norm"):
        q = rmsnorm_apply(attn.q_norm, q)
        k = rmsnorm_apply(attn.k_norm, k)
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)

    if cache is not None and "block_tables" in cache:
        # Paged cache: fixed-size blocks from a shared pool, routed per
        # row by the block table (serving/paged_cache.py).
        out = _paged_cache_apply(cache, k, v, positions, q, mask_kind,
                                 window, prefix_len)
    elif cache is not None:
        # Ring-buffer cache: slot = position % capacity; per-slot true
        # positions drive masking.
        # a tensor-parallel rank's slots of a ring cut by sequence (or a
        # whole ring walked as the ranks walk theirs), else None
        seq = _tp.seq_cut("k", cache["k"])
        at = None if seq is None else seq.held
        idx = cache["index"]
        valid_len = torch.sum(positions < 2 ** 29, dim=1).to(torch.int32)
        quantized = cache["k"].dtype == torch.int8
        cks = cvs = None
        if quantized:
            # int8 at write time: the cache never holds widened KV
            kq, ks = _quantize_kv(k)
            vq, vs = _quantize_kv(v)
            _ring_update(cache["k"], kq, idx, valid_len, at)
            _ring_update(cache["v"], vq, idx, valid_len, at)
            _ring_update(cache["k_scale"], ks, idx, valid_len, at)
            _ring_update(cache["v_scale"], vs, idx, valid_len, at)
            cks, cvs = cache["k_scale"], cache["v_scale"]
        else:
            _ring_update(cache["k"], k, idx, valid_len, at)
            _ring_update(cache["v"], v, idx, valid_len, at)
        _ring_update(cache["pos"], positions.to(torch.int32), idx, valid_len,
                     at)
        ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
        cache["index"] += S
        win = window if mask_kind == "sliding" else None
        if S == 1 and seq is not None:
            # the rank's slots walked by kernel 9, the ranks' partials
            # merged by kernel 10
            out = _decode_attention_seq(
                q, ck, cv, cpos, positions[:, 0], cks, cvs, win, seq,
                heads_cut=getattr(qkv_w, "tp_size", None) is not None)
        elif S == 1:
            # single-token decode: the flash-decode kernel streams the
            # (possibly int8) cache directly, dequantizing in-kernel
            out = _decode_attention_cached(
                q, ck, cv, cpos, positions[:, 0], cks, cvs, win)
        else:
            # multi-token (prefill) path: plain dense attention over the
            # dequantized cache, as in the reference; a rank's slots are
            # gathered whole first (these rows, this layer, one gather)
            if seq is not None:
                ck, cv, cpos, cks, cvs = _tp.gather_slots(
                    seq, [ck, cv, cpos, cks, cvs])
            if quantized:
                k_r = _dequantize_kv(ck, cks).to(q.dtype)
                v_r = _dequantize_kv(cv, cvs).to(q.dtype)
            else:
                k_r, v_r = ck, cv
            out = dense_attention(q, k_r, v_r, positions, cpos, mask_kind,
                                  window, prefix_len)
    else:
        out = cacheless_attention(q, k, v, positions, mask_kind, window,
                                  aligned_positions, prefix_len)

    o_w = attn.o
    if isinstance(o_w, QuantizedLinear):
        return quantized_out_proj(o_w, out, residual=residual).to(x.dtype)
    o = torch.einsum("bshk,hkd->bsd", out.to(x.dtype), o_w)
    return o if residual is None else residual + o


def init_kv_cache(batch: int, max_len: int, n_kv_heads: int, head_dim: int,
                  dtype=torch.bfloat16, device=None) -> dict:
    out = {
        "k": torch.zeros((batch, max_len, n_kv_heads, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, max_len, n_kv_heads, head_dim), dtype=dtype,
                         device=device),
        # true position held by each slot; 2**30 = empty
        "pos": torch.full((batch, max_len), EMPTY_SLOT, dtype=torch.int32,
                          device=device),
        # per-row write index (rows advance independently)
        "index": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    if dtype == torch.int8:
        out["k_scale"] = torch.zeros((batch, max_len, n_kv_heads),
                                     dtype=torch.float32, device=device)
        out["v_scale"] = torch.zeros((batch, max_len, n_kv_heads),
                                     dtype=torch.float32, device=device)
    return out


def init_paged_kv_cache(num_blocks: int, block_size: int, n_kv_heads: int,
                        head_dim: int, block_tables: torch.Tensor,
                        index: torch.Tensor, dtype=torch.bfloat16,
                        device=None) -> dict:
    """Paged KV state of one layer: shared fixed-size block pools plus
    the per-row ``block_tables`` [B, nb] and write ``index`` [B] given by
    the caller (the model hands every layer the same table tensor).
    Block 0 is the null block — never allocated, all positions
    empty-sentinel — so zeroed table entries read as fully masked."""
    shape = (num_blocks, block_size, n_kv_heads, head_dim)
    out = {
        "k_pages": torch.zeros(shape, dtype=dtype, device=device),
        "v_pages": torch.zeros(shape, dtype=dtype, device=device),
        "pos_pages": torch.full((num_blocks, block_size), EMPTY_SLOT,
                                dtype=torch.int32, device=device),
        "block_tables": block_tables,
        "index": index,
    }
    if dtype == torch.int8:
        out["k_scale_pages"] = torch.zeros(shape[:3], dtype=torch.float32,
                                           device=device)
        out["v_scale_pages"] = torch.zeros(shape[:3], dtype=torch.float32,
                                           device=device)
    return out
