"""Shard placement for tensor parallelism (port of the divisibility
fallback of ``repro/parallel/sharding.py::resolve_spec`` for the
``heads``, ``kv_heads``, ``mlp`` and ``expert`` axes, and of
``Model.quantize(mesh=)``).

:func:`shard_model` cuts, in place, the int8 leaves of a quantized model
to one rank's shards; ``q`` and ``scale`` stay co-sharded on the
output-channel axis.  A dimension that the group size does not divide
keeps its leaves whole on every rank (the reference's replicate-on-
indivisible rule), and the layers then run the unsharded path.  The
embedding, the untied head, the norms and the router stay whole (the
reference places the vocabulary sharded, with the same bits).

Each rank's attention columns are laid out as [its q heads | its k
heads | its v heads]: q heads shard when ``H % p == 0``; K/V heads shard
when ``KH % p == 0``, and are otherwise computed whole on every rank (an
MQA head, ``KH == 1``; other indivisible KV counts keep the attention
whole).  Each rank then attends its own q heads, and its attention
output is the row-parallel out-projection's input shard.
"""
from __future__ import annotations

import logging
from typing import Callable

import torch

from repro_torch.quant.linear import QuantizedLinear
from .context import TPGroup

log = logging.getLogger(__name__)


def _cut(w: QuantizedLinear, q_index, scale_index, p: int) -> None:
    """Keep ``w.q[q_index]`` and ``w.scale[scale_index]`` (copies, so the
    whole tensors are released) and mark ``w`` sharded ``p`` ways."""
    w.q = w.q[q_index].clone(memory_format=torch.contiguous_format)
    w.scale = w.scale[scale_index].clone(memory_format=torch.contiguous_format)
    w.tp_size = p


def _span(n: int, group: TPGroup) -> slice:
    k = n // group.size
    return slice(group.rank * k, (group.rank + 1) * k)


def _shard_attention(attn, group: TPGroup) -> bool:
    qkv, o = getattr(attn, "qkv", None), attn.o
    if not (isinstance(qkv, QuantizedLinear)
            and isinstance(o, QuantizedLinear)):
        return False
    p = group.size
    H, KH = o.q.shape[0], attn.n_kv_heads
    kv_split = KH % p == 0
    if H % p or not (kv_split or KH == 1):
        return False
    heads = torch.arange(H + 2 * KH)
    kv = heads[_span(KH, group)] if kv_split else heads[:KH]
    idx = torch.cat([heads[_span(H, group)], H + kv, H + KH + kv])
    _cut(qkv, (slice(None), idx), idx, p)
    _cut(o, _span(H, group), slice(None), p)
    attn.n_kv_heads = len(kv)
    return True


def _shard_mlp(mlp, group: TPGroup) -> bool:
    """Up/gate column-parallel, down row-parallel."""
    if not isinstance(getattr(mlp, "up", None), QuantizedLinear):
        return False
    F = mlp.up.q.shape[1]
    if F % group.size:
        return False
    cols = _span(F, group)
    for name in ("up", "gate"):
        w = getattr(mlp, name, None)
        if w is not None:
            _cut(w, (slice(None), cols), cols, group.size)
    _cut(mlp.down, cols, slice(None), group.size)
    return True


def _shard_experts(moe, group: TPGroup) -> bool:
    """The routed expert stacks on their leading expert axis."""
    if not isinstance(moe.up, QuantizedLinear):
        return False
    E = moe.up.q.shape[0]
    if E % group.size:
        return False
    experts = _span(E, group)
    for name in ("up", "gate", "down"):
        w = getattr(moe, name, None)
        if w is not None:
            _cut(w, experts, experts, group.size)
    return True


def _sharded_ways(mod) -> int | None:
    ways = {w.tp_size for w in mod.children()
            if isinstance(w, QuantizedLinear) and w.tp_size is not None}
    return ways.pop() if ways else None


def shard_model(model, group: TPGroup):
    """Cut the quantized leaves of ``model`` to ``group.rank``'s shards,
    in place; returns the model.  Modules already sharded for a group of
    this size are left as they are (for another size: raises).  Each
    layer kind that stays whole (not quantized, or a dimension that
    ``group.size`` does not divide) is logged once.  A config with
    ``qk_norm``, layernorm or a frontend is refused: its sharded path has
    not been held against the unsharded one (ROADMAP A.3)."""
    cfg = model.cfg
    untested = [what for what, on in (
        ("qk_norm", cfg.qk_norm), ("layernorm", cfg.norm == "layernorm"),
        (f"the {cfg.frontend} frontend", cfg.frontend is not None)) if on]
    if untested:
        raise NotImplementedError(
            f"tensor parallelism of {cfg.name}: {', '.join(untested)} "
            f"not ported to the sharded path")
    whole = set()
    for block in model.layers:
        if block.spec[0] not in ("attn", "attn_local"):
            raise NotImplementedError(f"tensor parallelism: mixer "
                                      f"{block.spec[0]!r} is not ported")
        parts = [("attention", block.attn, _shard_attention)]
        if block.spec[1] == "moe":
            parts.append(("experts", block.moe, _shard_experts))
            if hasattr(block.moe, "shared"):
                parts.append(("shared mlp", block.moe.shared, _shard_mlp))
        else:
            parts.append(("mlp", block.mlp, _shard_mlp))
        for kind, mod, shard in parts:
            ways = _sharded_ways(mod)
            if ways is None:
                if not shard(mod, group):
                    whole.add(kind)
            elif ways != group.size:
                raise ValueError(f"{kind} is sharded {ways} ways, not "
                                 f"{group.size}")
    for kind in sorted(whole):
        log.info("tensor parallelism over %d ranks: the %s stays whole "
                 "(not quantized, or a dimension %d does not divide)",
                 group.size, kind, group.size)
    return model


def build_in_turns(group: TPGroup, build: Callable):
    """Run ``build()`` on one rank at a time, with a barrier between
    turns, and return its result: ranks that share one card then never
    hold two full-precision copies of a model at once.  ``build`` should
    leave only its result on the device."""
    out = None
    for turn in range(group.size):
        if group.rank == turn:
            out = build()
        group.barrier()
    return out
