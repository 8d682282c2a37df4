"""Public kernel entry points (port of ``repro/kernels/ops.py``).

Dispatch is by tensor device: CPU tensors run the plain versions, CUDA
tensors launch the hand-written kernels or raise.  The reference's
dispatch rules are kept: activations are quantized inside the GEMM when
``K <= MAX_FUSED_QUANT_K``, and the MLP's hidden state (dense or per
expert) is re-quantized in the up/gated GEMM's epilogue
(``quantize_out``) only when ``d_ff <= MAX_FUSED_QUANT_N``, else by a
separate row-quantize launch; decode attention takes the split-KV walk
above ``SPLIT_MIN_SLOTS`` slots.  The reference's padding to 256-row /
32-row / CORE_K / CORE_N multiples is TPU tiling and has no counterpart
here: the kernels mask ragged edges.  Flash attention, the SSD scan and
the softmax keep the reference's block arguments and their divisibility
checks as the public contract; their kernels use tiles of their own.

The three INT8 pipelines take ``gate=`` (the flag of
:func:`finite_screen`) and ``out=``: the degraded mode's fallback, the
same pipeline on gated launches that do nothing when the screen passed
and otherwise read their float operands through ``nan_to_num``, the
last one writing ``out`` in place.  The fallback's hidden state is
always re-quantized by a gated row-quantize launch (never in the
epilogue: the same bits, and no gated requant kernels to build).
"""
from __future__ import annotations

import torch

from . import decode_attention as _da
from . import flash_attention as _fa
from . import online_softmax as _sm
from . import ref
from . import ssd_scan as _ssd
from .cim_gemm import (MAX_FUSED_QUANT_K, MAX_FUSED_QUANT_N,
                       cim_gated_gemm_int8, cim_gemm_int8,
                       cim_gemm_int8_fused,
                       cim_gemm_int8_fused_qin, cim_grouped_gated_gemm_int8,
                       cim_grouped_gemm_int8, finite_screen,
                       quantize_rows_int8)
from .decode_attention import SPLIT_STEP, split_len, walk_as_ranks

__all__ = ["quantize_weights_int8", "quantize_rows_int8",
           "cim_quantized_matmul", "cim_quantized_matmul_fused",
           "cim_int8_gemm_acc", "cim_hidden_int8", "cim_quantized_mlp",
           "cim_quantized_grouped_mlp", "finite_screen",
           "decode_attention", "decode_attention_splitkv",
           "decode_attention_partial", "decode_attention_combine",
           "decode_attention_paged", "n_splits_for", "split_len",
           "walk_as_ranks", "flash_attention",
           "ssd_scan", "online_softmax", "ref",
           "MAX_FUSED_QUANT_K", "MAX_FUSED_QUANT_N"]

# Above this many cache slots decode attention takes the split walk.
SPLIT_MIN_SLOTS = 2048
MAX_SPLITS = 8


# f32 elements a stack's quantization holds at once (1 GiB a temporary)
QUANT_CHUNK_ELEMS = 2 ** 28


def _quantize_int8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    w32 = w.float()
    amax = torch.amax(torch.abs(w32), dim=-2) + 1e-12
    scale = ref.div(amax, 127.0)
    w_q = torch.clamp(torch.round(w32 / scale.unsqueeze(-2)), -127,
                      127).to(torch.int8)
    return w_q, scale


def quantize_weights_int8(w: torch.Tensor) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Per-output-channel symmetric int8: w [K, N] -> (w_q, scale [N]);
    a stack [E, K, N] quantizes per expert -> scale [E, N].  A stack is
    quantized over chunks of experts of at most ``QUANT_CHUNK_ELEMS``
    elements (at least one expert a chunk), so its f32 temporaries stay
    that small (deepseek-v3's [256, 7168, 2048] bf16 stack would
    otherwise need three 15 GB ones); the scales are per expert, so the
    bits are the whole stack's."""
    if w.dim() != 3 or w.numel() <= QUANT_CHUNK_ELEMS:
        return _quantize_int8(w)
    E = w.shape[0]
    step = max(1, QUANT_CHUNK_ELEMS // w[0].numel())
    w_q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty((E, w.shape[2]), dtype=torch.float32,
                        device=w.device)
    for e in range(0, E, step):
        w_q[e:e + step], scale[e:e + step] = _quantize_int8(w[e:e + step])
    return w_q, scale


def _contig(t: torch.Tensor | None) -> torch.Tensor | None:
    return None if t is None else t.contiguous()


def cim_quantized_matmul(x: torch.Tensor, w_q: torch.Tensor,
                         w_scale: torch.Tensor) -> torch.Tensor:
    """Unfused quantized linear: row quantize, the int32 GEMM, then the
    dequant ``acc * x_scale * w_scale`` outside any kernel (two launches):
    x [M, K] bf16/f32; w_q [K, N] int8; w_scale [N] -> f32 [M, N]."""
    x_q, x_s = quantize_rows_int8(x.contiguous())
    return cim_gemm_int8(x_q, w_q).float() * x_s * w_scale[None, :]


def cim_int8_gemm_acc(x_q: torch.Tensor, w_q: torch.Tensor,
                      gate: torch.Tensor | None = None) -> torch.Tensor:
    """x_q [M, K] int8 @ w_q [K, N] int8 -> int32 [M, N], exactly: the
    row-parallel partial accumulator that tensor parallelism sums over
    the ranks before its one dequant/residual epilogue.  With ``gate``
    the degraded fallback's gated launch (nothing written at flag 0)."""
    return cim_gemm_int8(x_q.contiguous(), w_q, gate=gate)


def cim_hidden_int8(x_q: torch.Tensor, x_scale: torch.Tensor,
                    up_q: torch.Tensor, up_scale: torch.Tensor,
                    gate_q: torch.Tensor | None = None,
                    gate_scale: torch.Tensor | None = None,
                    activation: str = "gelu",
                    gate: torch.Tensor | None = None) -> torch.Tensor:
    """MLP front half from pre-quantized activations, f32 out, no
    requant: ``act(x@Wg) * (x@Wu)`` (or ``act(x@Wu)`` ungated).  The
    column shard of the tensor-parallel MLP: the requant runs outside,
    with the row absmax reduced over the ranks.  ``gate``: the degraded
    fallback's gated launch (the scales read through ``nan_to_num``)."""
    if gate_q is not None:
        return cim_gated_gemm_int8(x_q, gate_q, up_q, x_scale, gate_scale,
                                   up_scale, activation=activation,
                                   gate=gate)
    return cim_gemm_int8_fused(x_q, up_q, x_scale, up_scale,
                               activation=activation, gate=gate)


def cim_quantized_matmul_fused(x: torch.Tensor, w_q: torch.Tensor,
                               w_scale: torch.Tensor,
                               bias: torch.Tensor | None = None,
                               residual: torch.Tensor | None = None,
                               activation: str | None = None,
                               gate: torch.Tensor | None = None,
                               out: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """Quantized linear: x [M, K] bf16/f32; w_q [K, N] int8; w_scale [N];
    optional bias [N] f32, activation and residual [M, N], applied in
    the epilogue in that order -> f32 [M, N].  One launch when K fits
    ``MAX_FUSED_QUANT_K``, else quantize + GEMM (two launches); with
    ``gate``, the same launches gated, into ``out``."""
    x, residual = x.contiguous(), _contig(residual)
    if x.shape[1] <= MAX_FUSED_QUANT_K:
        return cim_gemm_int8_fused_qin(x, w_q, w_scale, bias=bias,
                                       residual=residual,
                                       activation=activation, gate=gate,
                                       out=out)
    x_q, x_s = quantize_rows_int8(x, gate=gate)
    return cim_gemm_int8_fused(x_q, w_q, x_s, w_scale, bias=bias,
                               residual=residual, activation=activation,
                               gate=gate, out=out)


def cim_quantized_mlp(x: torch.Tensor, up_q: torch.Tensor,
                      up_scale: torch.Tensor, down_q: torch.Tensor,
                      down_scale: torch.Tensor,
                      gate_q: torch.Tensor | None = None,
                      gate_scale: torch.Tensor | None = None,
                      residual: torch.Tensor | None = None,
                      activation: str = "gelu",
                      gate: torch.Tensor | None = None,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """INT8 MLP: quantize + (gated) up GEMM + down GEMM with the residual
    in the down GEMM's epilogue.  The hidden state is re-quantized by
    the up/gated GEMM when ``d_ff <= MAX_FUSED_QUANT_N``, else by one
    more row-quantize launch (gemma-2b's d_ff of 16384 takes this
    branch: 4 launches per MLP; narrower ones take 3).  With ``gate``
    the fallback: 4 gated launches whatever d_ff, into ``out``.  Returns
    f32 [M, N]."""
    x, residual = x.contiguous(), _contig(residual)
    fuse_requant = gate is None and up_q.shape[1] <= MAX_FUSED_QUANT_N
    x_q, x_s = quantize_rows_int8(x, gate=gate)
    if gate_q is not None:
        h = cim_gated_gemm_int8(x_q, gate_q, up_q, x_s, gate_scale, up_scale,
                                activation=activation,
                                quantize_out=fuse_requant, gate=gate)
    else:
        h = cim_gemm_int8_fused(x_q, up_q, x_s, up_scale,
                                activation=activation,
                                quantize_out=fuse_requant, gate=gate)
    h_q, h_s = h if fuse_requant else quantize_rows_int8(h, gate=gate)
    return cim_gemm_int8_fused(h_q, down_q, h_s, down_scale,
                               residual=residual, gate=gate, out=out)


def cim_quantized_grouped_mlp(x: torch.Tensor, up_q: torch.Tensor,
                              up_scale: torch.Tensor, down_q: torch.Tensor,
                              down_scale: torch.Tensor,
                              gate_q: torch.Tensor | None = None,
                              gate_scale: torch.Tensor | None = None,
                              expert_counts: torch.Tensor | None = None,
                              activation: str = "gelu",
                              gate: torch.Tensor | None = None,
                              out: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """INT8 MLPs of all E experts in a number of launches independent of
    E: one row quantize over the stacked [E * T, d] rows, one grouped
    (gated) GEMM that re-quantizes the hidden state in its epilogue when
    ``d_ff <= MAX_FUSED_QUANT_N`` (else one more row quantize), one
    grouped down GEMM.

    x [E, T, d] f32/bf16; up/gate [E, d, F] int8 with scales [E, F];
    down [E, F, d'] int8 with scale [E, d'] -> f32 [E, T, d'].
    ``expert_counts`` (int32 [E]) is the skip list: an expert with no
    tokens streams no weights in either grouped GEMM (same bits, its
    rows being zero).  With ``gate`` the fallback: 4 gated launches, the
    skip list kept, into ``out``."""
    E, T, d = x.shape
    F = up_q.shape[2]
    fuse_requant = gate is None and F <= MAX_FUSED_QUANT_N
    x_q, x_s = quantize_rows_int8(x.contiguous().reshape(E * T, d),
                                  gate=gate)
    x_q, x_s = x_q.reshape(E, T, d), x_s.reshape(E, T, 1)
    if gate_q is not None:
        h = cim_grouped_gated_gemm_int8(x_q, gate_q, up_q, x_s, gate_scale,
                                        up_scale, counts=expert_counts,
                                        activation=activation,
                                        quantize_out=fuse_requant, gate=gate)
    else:
        h = cim_grouped_gemm_int8(x_q, up_q, x_s, up_scale,
                                  counts=expert_counts,
                                  activation=activation,
                                  quantize_out=fuse_requant, gate=gate)
    if fuse_requant:
        h_q, h_s = h
    else:
        h_q, h_s = quantize_rows_int8(h.reshape(E * T, F), gate=gate)
        h_q, h_s = h_q.reshape(E, T, F), h_s.reshape(E, T, 1)
    return cim_grouped_gemm_int8(h_q, down_q, h_s, down_scale,
                                 counts=expert_counts, gate=gate, out=out)


def n_splits_for(S: int) -> int:
    """The reference's split rule: one walk up to ``SPLIT_MIN_SLOTS``
    slots, then one split per 2048 slots, at most ``MAX_SPLITS``."""
    return 1 if S <= SPLIT_MIN_SLOTS else min(MAX_SPLITS, S // 2048)


def decode_attention(q, k, v, pos, q_pos, k_scale=None, v_scale=None,
                     window=None, n_splits: int | None = None):
    """Flash-decode over a (possibly int8) ring-buffer KV cache.

    ``k_scale``/``v_scale`` [B, S, KH] f32 turn on the int8-KV path
    (dequantized inside the kernel).  ``n_splits`` picks the split-KV
    walk: None applies :func:`n_splits_for` (one launch up to 2048
    slots, else the partial and combine launches); 1 forces the single
    walk.  The reference then lowers the count until it divides its
    512-slot blocks; here splits end on the kernel's 64-slot steps, so
    the count is only capped at the number of steps.  An unquantized
    cache must have q's dtype."""
    S = k.shape[1]
    if n_splits is None:
        n_splits = n_splits_for(S)
    n_splits = min(n_splits, -(-S // SPLIT_STEP))
    if n_splits > 1:
        return decode_attention_splitkv(q, k, v, pos, q_pos, k_scale,
                                        v_scale, window, n_splits)
    return _da.decode_attention(q.contiguous(), k, v, pos, q_pos,
                                k_scale=k_scale, v_scale=v_scale,
                                window=window)


def decode_attention_splitkv(q, k, v, pos, q_pos, k_scale=None,
                             v_scale=None, window=None, n_splits: int = 2):
    """Explicit split-KV entry: the partial and the combine launch even
    at ``n_splits=1``, where the result equals the single walk's bit for
    bit (the combine's weights are exactly 1)."""
    o, m, l = _da.decode_attention_partial(q.contiguous(), k, v, pos, q_pos,
                                           k_scale=k_scale, v_scale=v_scale,
                                           window=window, n_splits=n_splits)
    return _da.decode_attention_combine(o, m, l, q.dtype)


def decode_attention_partial(q, k, v, pos, q_pos, k_scale=None,
                             v_scale=None, window=None, n_splits: int = 2,
                             cluster_slots: int | None = None):
    """The split walk's partials alone (kernel 9): raw (o, m, l) of
    ``n_splits`` slices of the cache, for a merge over more partials
    than one launch walks (tensor parallelism's sequence-cut ring);
    ``cluster_slots`` as :func:`~.decode_attention.walk_plan`."""
    return _da.decode_attention_partial(q.contiguous(), k, v, pos, q_pos,
                                        k_scale=k_scale, v_scale=v_scale,
                                        window=window, n_splits=n_splits,
                                        cluster_slots=cluster_slots)


def decode_attention_combine(o, m, l, out_dtype):
    """Kernel 10: partials [B, KH, NS, G, D] (m, l [.., 1]) merged in
    ascending split -> [B, KH, G, D] in ``out_dtype``."""
    return _da.decode_attention_combine(o, m, l, out_dtype)


def decode_attention_paged(q, k_pages, v_pages, pos_pages, block_tables,
                           q_pos, k_scale_pages=None, v_scale_pages=None,
                           window=None):
    """Flash-decode over a paged (block-table) KV cache.

    Pools [NB, bs, KH, D] hold fixed-size KV blocks shared by all
    sequences; ``block_tables`` [B, nb] int32 maps each row's logical
    blocks to pool blocks (0 = the all-empty null block).
    ``k_scale_pages``/``v_scale_pages`` [NB, bs, KH] f32 turn on the
    int8-KV path.  Bitwise equal to the single ring walk on the
    equivalent layout."""
    return _da.decode_attention_paged(
        q.contiguous(), k_pages, v_pages, pos_pages, block_tables, q_pos,
        k_scale_pages=k_scale_pages, v_scale_pages=v_scale_pages,
        window=window)


def _blocks_divide(what: str, n: int, block: int, name: str) -> int:
    """The reference's ``block = min(block, n); assert n % block == 0``."""
    block = min(block, n)
    if block < 1 or n % block:
        raise ValueError(f"{what}: {name}={block} does not divide {n}")
    return block


def flash_attention(q, k, v, causal=True, window=None, block_q=256,
                    block_k=512):
    """Prefill attention: q [B, Sq, H, D], k/v [B, Skv, KH, D] ->
    [B, Sq, H, D] in q's dtype; causal (aligned top-left) and/or a
    sliding ``window``, GQA by KV head ``h // (H // KH)``.  ``block_q``
    and ``block_k`` must divide Sq and Skv as in the reference (one
    launch)."""
    _blocks_divide("flash_attention", q.shape[1], block_q, "block_q")
    _blocks_divide("flash_attention", k.shape[1], block_k, "block_k")
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def ssd_scan(x, log_a, b, c, chunk=128):
    """Chunked Mamba-2 SSD from a zero state: x [BH, S, P], log_a
    [BH, S], b/c [BH, S, N] -> (y [BH, S, P], final state f32
    [BH, P, N]).  ``chunk`` (at most S) must divide S (one launch)."""
    chunk = _blocks_divide("ssd_scan", x.shape[1], chunk, "chunk")
    return _ssd.ssd_scan(x, log_a, b, c, chunk=chunk)


def online_softmax(x, block_r=256, block_c=2048):
    """Softmax over the last axis of x [R, C] in f32, returned in x's
    dtype.  ``block_r`` must divide R, and ``block_c`` C when C exceeds
    it, as in the reference; the kernel's regime comes from
    ``online_softmax.softmax_plan`` (one launch, two above 524288
    columns), not from the block arguments."""
    R, C = x.shape
    _blocks_divide("online_softmax", R, block_r, "block_r")
    if C > block_c:
        _blocks_divide("online_softmax", C, block_c, "block_c")
    return _sm.online_softmax(x)
