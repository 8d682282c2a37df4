"""INT8 gradient compression for the data-parallel all-reduce (port of
``repro/optim/compress.py``).

Gradients are per-tensor scaled to int8 before crossing a slow link,
halving (against bf16) the collective's bytes, then decompressed for the
optimizer; the error stays bounded because AdamW normalizes by sqrt(v).
A tree is a tensor, or a dict or list of trees.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import div


def _leaf(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    g32 = g.float()
    amax = torch.amax(torch.abs(g32)) + 1e-12
    scale = div(amax, 127.0)
    q = torch.clamp(torch.round(g32 / scale), -127, 127)
    return q.to(torch.int8), scale


def int8_compress_grads(grads):
    """tree -> (int8 tree, f32 scales tree)."""
    if isinstance(grads, dict):
        parts = {k: int8_compress_grads(g) for k, g in grads.items()}
        return ({k: q for k, (q, _) in parts.items()},
                {k: s for k, (_, s) in parts.items()})
    if isinstance(grads, (list, tuple)):
        parts = [int8_compress_grads(g) for g in grads]
        return (type(grads)(q for q, _ in parts),
                type(grads)(s for _, s in parts))
    return _leaf(grads)


def int8_decompress_grads(qs, scales, dtype=torch.float32):
    if isinstance(qs, dict):
        return {k: int8_decompress_grads(q, scales[k], dtype)
                for k, q in qs.items()}
    if isinstance(qs, (list, tuple)):
        return type(qs)(int8_decompress_grads(q, s, dtype)
                        for q, s in zip(qs, scales))
    return qs.to(dtype) * scales.to(dtype)
