"""Flash-decode over the ring KV cache (port of
``repro/kernels/decode_attention.py::decode_attention``).

The CUDA kernel lives in ``csrc/decode_attention.cu``; its note says
what bounds it and how the design follows the reference (int8 K/V
dequantized in the kernel, position masks, online softmax).  The
wrapper takes the plain version (:func:`decode_attention_plain`) for
CPU tensors; for CUDA tensors it launches the kernel or raises.

q:   [B, KH, G, D]    (GQA groups factored)
k,v: [B, S, KH, D]    (bf16/f32, or int8 with [B, S, KH] f32 scales)
pos: [B, S] int32     (slot positions; 2**30 = empty)
q_pos: [B] int32      (current decode position)
out: [B, KH, G, D]    (q's dtype)
"""
from __future__ import annotations

import math

import torch

from . import ref
from ._launch import (DTYPE_CODE, F, I, P, bind, check, on_cpu, ptr,
                      require, stream)

NEG_INF = ref.NEG_INF
EMPTY_SLOT = 2 ** 30
# query rows per kv head the kernel holds (its MAXG)
MAX_GROUP = 16

_LIB = "decode_attention"


def decode_attention_plain(q, k, v, pos, q_pos, k_scale=None, v_scale=None,
                           window=None):
    return ref.decode_attention_ref(q, k, v, pos, q_pos, window=window,
                                    k_scale=k_scale, v_scale=v_scale)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor, q_pos: torch.Tensor,
                     k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None,
                     window: int | None = None) -> torch.Tensor:
    """One-token attention of q over the cache (see the module note).

    ``k_scale``/``v_scale`` turn on the int8-KV path (K/V must then be
    int8).  ``window`` masks slots at or before ``q_pos - window``.
    """
    quantized = k_scale is not None
    if on_cpu(q, k, v, pos, q_pos, k_scale, v_scale):
        return decode_attention_plain(q, k, v, pos, q_pos, k_scale, v_scale,
                                      window)
    B, KH, G, D = q.shape
    S = k.shape[1]
    require(q, "q", (torch.float32, torch.bfloat16))
    if quantized:
        kv_dtype = torch.int8
        require(k_scale, "k_scale", torch.float32, (B, S, KH))
        require(v_scale, "v_scale", torch.float32, (B, S, KH))
    else:
        kv_dtype = q.dtype
    require(k, "k", kv_dtype, (B, S, KH, D))
    require(v, "v", kv_dtype, (B, S, KH, D))
    require(pos, "pos", torch.int32, (B, S))
    require(q_pos, "q_pos", torch.int32, (B,))
    if D > 256 or 256 % D or G > MAX_GROUP:
        raise ValueError(f"decode_attention kernel takes 256 % D == 0 and "
                         f"G <= {MAX_GROUP}; got D={D}, G={G}")
    if window is not None and window <= 0:
        raise ValueError("window must be positive")
    out = torch.empty_like(q)
    fn = bind(_LIB, "decode_attention_launch",
              [P, I, P, P, I, P, P, P, P, P, I, I, I, I, I, I, F, P])
    check(_LIB, fn(ptr(q), DTYPE_CODE[q.dtype], ptr(k), ptr(v),
                   0 if quantized else DTYPE_CODE[q.dtype], ptr(pos),
                   ptr(q_pos), ptr(k_scale), ptr(v_scale), ptr(out),
                   B, S, KH, G, D, window or 0, 1.0 / math.sqrt(D),
                   stream(q)), "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
