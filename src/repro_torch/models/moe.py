"""Mixture-of-Experts FFN: shared + routed top-k experts (port of
``repro/models/moe.py``).

Sort-based dispatch, per batch row: the token-expert assignments of a
row are argsorted by expert (stably), each entry's position within its
expert comes from ``searchsorted``, entries at or beyond the capacity
``C = int(S * K / E * capacity_factor) + 1`` are dropped (GShard
semantics), and the kept tokens are scattered into per-expert capacity
buffers, run through the experts and gathered back with their gate
weights.  Capacity is per row of each forward, so bucket pad tokens are
routed and take capacity, as in the reference.

Where the reference builds ``[B, E, C, d]`` buffers and then stacks
them ``[E, B * C, d]`` for the experts, the port writes the kept tokens
straight into the stacked layout (row ``b * C + pos`` of expert ``e``):
the same rows, without the transpose.  Two orders matter on the card:

* dispatch writes only the kept entries, whose rows are unique (dropped
  entries go to one spare row that is never read): a non-accumulating
  write with duplicate indices is undefined on CUDA;
* the combine adds each token's K contributions in ascending expert id,
  from zero, rounding to x's dtype after each add, as the reference's
  in-order scatter of the sorted entries does; an atomic ``index_add_``
  would sum in an order that changes from run to run.

The per-expert token tally stays a device tensor: it is the skip list
of the grouped kernels (no ``.item()``, no host sync anywhere in the
routing).  The reference's load-balance auxiliary
(:func:`load_balance_aux`) is computed only when a training loss asks
for it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.quant.linear import QuantizedLinear, quantized_moe_apply
from .layers import MLP, _activate, mlp_apply, truncated_normal_, weight


@dataclass(frozen=True)
class MoEConfig:
    n_routed_experts: int
    top_k: int
    d_expert: int                  # per-expert FFN hidden size
    n_shared_experts: int = 0
    shared_d_ff: int = 0           # hidden size of the shared expert MLP
    capacity_factor: float = 1.25
    norm_topk_prob: bool = True
    aux_loss_coef: float = 0.001   # the load-balance auxiliary's weight
    first_k_dense: int = 0         # leading dense layers

    @property
    def shared_width(self) -> int:
        """Hidden size of the shared-expert MLP (0: none)."""
        if not self.n_shared_experts:
            return 0
        return self.shared_d_ff or self.d_expert * self.n_shared_experts


class MoE(nn.Module):
    """One MoE layer's weights: f32 ``router`` [d, E]; bf16 expert stacks
    ``up``/``gate`` [E, d, F] and ``down`` [E, F, d] (per-expert
    :class:`~repro_torch.quant.linear.QuantizedLinear` stacks once a plan
    covering ``moe_experts`` is applied); the shared experts as one
    :class:`~repro_torch.models.layers.MLP`."""

    def __init__(self, d_model: int, cfg: MoEConfig, gated: bool, dtype,
                 device):
        super().__init__()
        E, F = cfg.n_routed_experts, cfg.d_expert
        self.router = weight((d_model, E), torch.float32, device)
        self.up = weight((E, d_model, F), dtype, device)
        self.down = weight((E, F, d_model), dtype, device)
        if gated:
            self.gate = weight((E, d_model, F), dtype, device)
        if cfg.shared_width:
            self.shared = MLP(d_model, cfg.shared_width, gated, dtype,
                              device)

    def init_(self, generator: torch.Generator) -> None:
        """The reference's ``moe_init`` scales: router and up/gate
        1/sqrt(d), down 1/sqrt(F)."""
        d, F = self.router.shape[0], self.down.shape[1]
        truncated_normal_(self.router, generator, 1.0 / math.sqrt(d))
        truncated_normal_(self.up, generator, 1.0 / math.sqrt(d))
        truncated_normal_(self.down, generator, 1.0 / math.sqrt(F))
        if hasattr(self, "gate"):
            truncated_normal_(self.gate, generator, 1.0 / math.sqrt(d))
        if hasattr(self, "shared"):
            self.shared.init_(generator)


class Routing(NamedTuple):
    """One forward's dispatch, per batch row over its ``n = S * K``
    token-expert entries (``s*`` fields in expert-sorted order)."""
    probs: torch.Tensor         # [B, S, E] f32 router softmax
    expert_ids: torch.Tensor    # [B, S, K] int64, top-k order
    gates: torch.Tensor         # [B, S, K] f32, renormalized
    order: torch.Tensor         # [B, n] stable argsort by expert
    se: torch.Tensor            # [B, n] expert of each sorted entry
    st: torch.Tensor            # [B, n] token of each sorted entry
    sg: torch.Tensor            # [B, n] gate of each sorted entry
    pos: torch.Tensor           # [B, n] position within its expert
    keep: torch.Tensor          # [B, n] pos < capacity
    capacity: int


def route(router: torch.Tensor, x: torch.Tensor, cfg: MoEConfig) -> Routing:
    """f32 router logits, softmax, top-k (renormalized), and the stable
    sort-based dispatch of each batch row (``moe.py:85``–``:109`` of the
    reference)."""
    B, S, _ = x.shape
    E, K = cfg.n_routed_experts, cfg.top_k
    logits = torch.matmul(x.float(), router)
    probs = torch.softmax(logits, dim=-1)
    gates, expert_ids = torch.topk(probs, K, dim=-1)
    if cfg.norm_topk_prob:
        gates = gates / gates.sum(-1, keepdim=True)
    capacity = int(S * K / E * cfg.capacity_factor) + 1
    n = S * K
    flat_e = expert_ids.reshape(B, n)
    tok_of = (torch.arange(n, device=x.device) // K).expand(B, n)
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = flat_e.gather(1, order)
    st = tok_of.gather(1, order)
    sg = gates.reshape(B, n).gather(1, order)
    first = torch.searchsorted(se, se, side="left")
    pos = torch.arange(n, device=x.device)[None, :] - first
    return Routing(probs, expert_ids, gates, order, se, st, sg, pos,
                   pos < capacity, capacity)


def load_balance_aux(r: Routing, cfg: MoEConfig) -> torch.Tensor:
    """The reference's Switch-style auxiliary (``moe.py:94``–``:99``):
    ``coef * E * sum(me * ce)``, ``me`` the mean router probability of
    each expert, ``ce`` the fraction of token slots routed to it; f32.
    Its gradient reaches the router through ``me`` alone."""
    E = cfg.n_routed_experts
    me = torch.mean(r.probs, dim=(0, 1))
    ce = torch.mean(torch.sum(torch.nn.functional.one_hot(
        r.expert_ids, E).float(), dim=2), dim=(0, 1))
    return cfg.aux_loss_coef * E * torch.sum(me * ce)


def expert_counts(r: Routing, n_experts: int) -> torch.Tensor:
    """int32 [E] tokens routed to each expert (dropped ones included, as
    in the reference): zero exactly for the experts that have no kept
    row, since every expert's first entry fits its capacity."""
    ids = r.expert_ids.reshape(-1)
    return torch.zeros(n_experts, dtype=torch.int32,
                       device=ids.device).index_add_(
        0, ids, torch.ones_like(ids, dtype=torch.int32))


def moe_apply(moe: MoE, x: torch.Tensor, cfg: MoEConfig,
              activation: str = "swiglu",
              routing: Optional[Routing] = None) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d] in x's dtype: routed experts (grouped
    INT8 pipeline once the plan quantized them, bf16 batched products
    otherwise) plus the shared experts.  ``routing``: x's
    :func:`route`, when the caller needs it too (a training loss takes
    its :func:`load_balance_aux`)."""
    B, S, d = x.shape
    E, K = cfg.n_routed_experts, cfg.top_k
    r = route(moe.router, x, cfg) if routing is None else routing
    rows = B * r.capacity                       # capacity rows per expert
    spare = E * rows
    b_idx = torch.arange(B, device=x.device)[:, None]
    dest = r.se * rows + b_idx * r.capacity + r.pos
    dest = torch.where(r.keep, dest, torch.full_like(dest, spare))

    buf = x.new_zeros((spare + 1, d))
    buf[dest.reshape(-1)] = x[b_idx, r.st].reshape(-1, d)
    xg = buf[:spare].view(E, rows, d)

    if isinstance(moe.up, QuantizedLinear):
        ye = quantized_moe_apply(moe, xg, activation, use_kernel=None,
                                 expert_counts=expert_counts(r, E))
    else:
        up = torch.bmm(xg, moe.up)
        gate = getattr(moe, "gate", None)
        h = (_activate(activation, torch.bmm(xg, gate)) * up
             if gate is not None else _activate(activation, up))
        ye = torch.bmm(h, moe.down)

    # gate-weighted contributions of the sorted entries, then each
    # token's K of them in ascending expert id, summed in that order
    back = ye.reshape(spare, d)[dest.clamp(max=spare - 1)]   # [B, n, d]
    back = torch.where(r.keep[..., None], back, torch.zeros_like(back)) \
        * r.sg[..., None].to(ye.dtype)
    inv = torch.argsort(r.order, dim=1).reshape(B, S, K)     # top-k order
    by_expert = inv.gather(2, torch.argsort(r.expert_ids, dim=2))
    contrib = back[b_idx[..., None], by_expert]              # [B, S, K, d]
    out = torch.zeros((B, S, d), dtype=ye.dtype, device=x.device)
    for k in range(K):
        out = out + contrib[:, :, k]

    if hasattr(moe, "shared"):
        out = out + mlp_apply(moe.shared, x, activation)
    return out.to(x.dtype)
