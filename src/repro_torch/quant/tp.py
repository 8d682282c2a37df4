"""Tensor-parallel execution of the fused INT8 pipeline (port of
``repro/quant/tp.py``).

The reference runs each function under ``shard_map`` on a mesh; here
each rank is a process holding its shards of the weights (placed by
:func:`repro_torch.parallel.sharding.shard_model`) and calling the
collectives of its :class:`~repro_torch.parallel.context.TPGroup`
itself.  Every rank runs the same kernels on its slice, with the fewest
collectives the partition allows:

    column-parallel (QKV, MLP up/gate)
        Weights sharded on the output-channel axis; activations are
        replicated, so each rank's per-column math (the in-kernel row
        quantization included) is the unsharded pipeline's.  No
        collective; the output is this rank's columns.

    row-parallel (attention out-projection, MLP down)
        Weights sharded on the input-channel axis.  Three rules keep the
        result bit-identical to the unsharded pipeline: (1) the row
        absmax of the activations is max-reduced over the ranks before
        quantizing, so every rank uses the global row scale; (2) the
        int32 partial accumulators (kernel 6, ``cim_gemm_int8``) are
        sum-reduced, and integer addition is exact; (3) the
        dequant/residual epilogue runs once, on the summed accumulator,
        in the kernels' order of rounded multiplies and adds.

    expert-parallel (grouped MoE pipeline)
        The expert stacks are sharded on the expert axis; each rank runs
        the grouped pipeline on its E/p experts and its slice of the
        skip list (:func:`expert_rows`, in
        :func:`repro_torch.quant.linear.quantized_moe_apply`), and one
        all-gather in x's dtype returns every expert's output to every
        rank.

    head-parallel decode
        Each rank attends its own q heads over the KV heads it holds (its
        shard, or all of them for an MQA head).  Every head's softmax is
        independent: no collective.

    sequence-parallel decode (context parallelism)
        Where the KV heads cannot take the model axis, the ring cache is
        cut by sequence (``kv_seq``): a rank holds its slots of every
        KV head (:func:`seq_cut`).  Kernel 9 walks them in splits and
        emits each split's raw (o, m, l); one all-gather brings every
        rank's partials, in rank order on the split axis, and kernel 10
        merges all of them on every rank (:func:`decode_attn_seq`; where
        the ranks hold their own query heads, these are gathered first:
        one more all-gather).  A
        prefill over such a cache gathers the rows' slots whole first
        (:func:`gather_slots`).

    head-parallel bf16 mixers (MLA, Mamba-2, mLSTM, sLSTM)
        Each rank runs its heads; :func:`gather_heads` makes their
        outputs whole on every rank (one all-gather) before the whole
        out-projection, so the mixer computes the unsharded one's values.

    degraded mode
        A column shard's screen flag is max-reduced over the ranks (in
        ``quant/linear.py``); a row-parallel output is whole on every
        rank, and its fallback (:func:`row_fallback`,
        :func:`mlp_fallback`) sums the ranks' sanitized int32 partials
        (kernel 6's gated form) before the sanitized epilogue.

Per layer and forward a dense block makes 2 MAX and 2 SUM reductions, an
MoE block one gather more, a bf16 mixer one gather, a ring or latent
cache cut by sequence one gather at a prefill and two at a decode step
(the heads' queries, then the partials); degraded mode adds a
MAX for the QKV flag and a MAX + SUM for each row-parallel fallback.
``use_kernel`` picks the kernels or their plain versions, as elsewhere in
``quant``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.decode_attention import walked_ranks
from repro_torch.parallel.context import TPGroup, tp_group

__all__ = ["tp_group", "group_of", "SeqCut", "seq_cut", "gather_heads",
           "gather_slots", "matmul_column", "matmul_row", "mlp",
           "expert_rows", "decode_attn", "decode_attn_seq",
           "decode_attn_paged"]


def group_of(mod) -> TPGroup | None:
    """The current TP group if ``mod`` (a bf16 mixer) holds a rank's
    heads, None for a whole module.  A shard outside a group of its size
    raises: its layer cannot run alone."""
    ways = getattr(mod, "tp_size", None)
    if ways is None:
        return None
    group = tp_group()
    if group is None or group.size != ways:
        raise RuntimeError(
            f"a mixer sharded {ways} ways needs a tensor-parallel group of "
            f"that size current (tp_context), got "
            f"{None if group is None else group.size}")
    return group


class SeqCut(NamedTuple):
    """A ring or latent cache walked by sequence at a decode step: this
    rank's slots ``[first, first + slots / ranks)`` of a cache of
    ``slots`` cut over ``group`` (``ranks`` = its size), or, with
    ``group`` None, a whole cache walked as ``ranks`` ranks walk theirs
    (``kernels.decode_attention.walk_as_ranks``)."""
    group: Optional[TPGroup]
    ranks: int
    first: int
    slots: int

    @property
    def held(self) -> Optional[tuple[int, int]]:
        """(the first slot, the whole capacity) of a rank's cut, which
        its writes take; None for a whole cache."""
        return None if self.group is None else (self.first, self.slots)


def seq_cut(name: str, leaf: torch.Tensor) -> Optional[SeqCut]:
    """How a layer walks its cache by sequence, from the cache's ``k``
    (``name`` "k") or ``c_kv`` leaf: the rank's cut recorded on it
    (``parallel.sharding.slot_range``), under the current group, which
    must be of the cut's size (a rank's slots cannot be attended alone);
    else, inside ``walk_as_ranks(p)``, the whole cache that p ranks would
    cut (``parallel.sharding.leaf_seq_slots``); else None."""
    from repro_torch.parallel.sharding import leaf_seq_slots, slot_range
    held = slot_range(leaf)
    if held is not None:
        first, slots = held
        ways = slots // leaf.shape[1]
        group = tp_group()
        if group is None or group.size != ways:
            raise RuntimeError(
                f"a cache cut {ways} ways by sequence needs a tensor-"
                f"parallel group of that size current (tp_context), got "
                f"{None if group is None else group.size}")
        return SeqCut(group, ways, first, slots)
    p = walked_ranks()
    if p is not None and leaf_seq_slots(name, tuple(leaf.shape), p):
        return SeqCut(None, p, 0, leaf.shape[1])
    return None


def gather_slots(seq: SeqCut, leaves: list) -> list:
    """Each [B, L, ...] leaf of ``leaves`` (None passes through) with the
    ranks' slots concatenated in rank order on axis 1: the rows' whole
    ring, on every rank, in one all-gather of the leaves' bytes (a whole
    cache, ``seq.group`` None, as it is)."""
    group = seq.group
    if group is None:
        return leaves
    held = [t for t in leaves if t is not None]
    B, L = held[0].shape[:2]
    raw = [t.reshape(B, L, -1).contiguous().view(torch.uint8) for t in held]
    whole = group.all_gather(torch.cat(raw, dim=2).movedim(1, 0)
                             .contiguous()).movedim(0, 1)
    out = []
    parts = iter(torch.split(whole, [r.shape[2] for r in raw], dim=2))
    for t in leaves:
        if t is None:
            out.append(None)
            continue
        part = next(parts).contiguous().view(t.dtype)
        out.append(part.reshape(B, group.size * L, *t.shape[2:]))
    return out


def gather_heads(group: TPGroup, t: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' head blocks of ``t`` on axis ``dim`` concatenated in
    rank order (one all-gather): a bf16 mixer's heads' outputs, whole on
    every rank before its whole out-projection, so the sharded mixer
    computes the unsharded one's function.  Returned contiguous: the
    products that follow then take the unsharded operand's layout (a
    transposed one makes cuBLAS take another algorithm, and round
    apart)."""
    whole = group.all_gather(t.movedim(dim, 0).contiguous())
    return whole.movedim(0, dim).contiguous()


def _global_rowquant(group: TPGroup, x: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Row absmax int8 quantization with the absmax max-reduced over the
    ranks: every rank quantizes its input-channel slice with the global
    row scale, so ``q`` is the unsharded quantization's slice bit for bit
    (max is exact; the scalar chain is ``quantize_rows_int8``'s).  A NaN
    absmax enters the reduction as +inf, so a non-finite slice on any
    rank leaves every rank's output non-finite (a MAX need not order
    NaN), as the unsharded row's would be, and the screens trip alike."""
    x32 = x.float()
    amax = torch.amax(torch.abs(x32), dim=-1, keepdim=True)
    amax = torch.nan_to_num(amax, nan=float("inf"))
    amax = group.all_reduce_max(amax) + 1e-12
    scale = kref.div(amax, 127.0)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def matmul_column(group: TPGroup, x2: torch.Tensor, w_q: torch.Tensor,
                  w_scale: torch.Tensor, use_kernel: bool) -> torch.Tensor:
    """Column-parallel fused matmul: x2 [M, K] replicated, w_q [K, N/p]
    this rank's columns -> f32 [M, N/p].  No collective."""
    if use_kernel:
        return kops.cim_quantized_matmul_fused(x2, w_q, w_scale)
    return kref.fused_matmul_ref(x2, w_q, w_scale)


def _row_epilogue(group, x_q, x_s, w_q, w_scale, use_kernel, residual,
                  gate=None):
    acc = (kops.cim_int8_gemm_acc(x_q, w_q, gate=gate) if use_kernel
           else kref.cim_gemm_int8_ref(x_q, w_q))
    acc = group.all_reduce_sum(acc)
    out = acc.float() * x_s * w_scale[None, :]
    if residual is not None:
        out = out + residual.float()
    return out


def _san(t: torch.Tensor | None) -> torch.Tensor | None:
    return None if t is None else torch.nan_to_num(t, nan=0.0, posinf=0.0,
                                                   neginf=0.0)


def _write_if(flag: torch.Tensor, new: torch.Tensor,
              out: torch.Tensor) -> torch.Tensor:
    """``out`` replaced by ``new`` in place where the screen's ``flag`` is
    set, without reading the flag on the host."""
    return out.copy_(torch.where(flag.bool(), new, out))


def matmul_row(group: TPGroup, x2: torch.Tensor, w_q: torch.Tensor,
               w_scale: torch.Tensor, use_kernel: bool,
               residual: torch.Tensor | None = None) -> torch.Tensor:
    """Row-parallel fused matmul: x2 [M, K/p] and w_q [K/p, N] this
    rank's input channels -> f32 [M, N] on every rank; the int32 sum
    folds in before the dequant/residual epilogue."""
    x_q, x_s = _global_rowquant(group, x2)
    return _row_epilogue(group, x_q, x_s, w_q, w_scale, use_kernel,
                         residual)


def row_fallback(group: TPGroup, flag: torch.Tensor, x2: torch.Tensor,
                 w_q: torch.Tensor, w_scale: torch.Tensor,
                 residual: torch.Tensor | None,
                 out: torch.Tensor) -> torch.Tensor:
    """The degraded fallback of a row-parallel site (its output, on every
    rank alike, screened to ``flag``): the global row quantization of
    nan_to_num(x), kernel 6's gated partial, the int32 sum over the
    ranks, the epilogue on sanitized scales and residual, written into
    ``out`` where the flag is set.  The ranks' collectives run whatever
    the flag says (no rank reads it on the host): 1 MAX + 1 SUM more a
    site and forward.  Bitwise the unsharded fallback's output."""
    x_q, x_s = _global_rowquant(group, _san(x2))
    return _write_if(flag, _row_epilogue(group, x_q, x_s, w_q, _san(w_scale),
                                         True, _san(residual), gate=flag),
                     out)


def mlp_fallback(group: TPGroup, flag: torch.Tensor, x2: torch.Tensor,
                 mlp_mod, activation: str, residual: torch.Tensor | None,
                 out: torch.Tensor) -> torch.Tensor:
    """The degraded fallback of the tensor-parallel MLP (its output, alike
    on every rank, screened to ``flag``): the gated row quantize and
    gated column front on sanitized operands, the hidden state's global
    row quantization of nan_to_num(h), then :func:`row_fallback`'s down
    projection; 1 MAX + 1 SUM more a forward."""
    up, down = mlp_mod.up, mlp_mod.down
    gate = getattr(mlp_mod, "gate", None)
    x_q, x_s = kops.quantize_rows_int8(x2.contiguous(), gate=flag)
    h = kops.cim_hidden_int8(
        x_q, x_s, up.q, up.scale,
        gate_q=None if gate is None else gate.q,
        gate_scale=None if gate is None else gate.scale,
        activation=activation, gate=flag)
    h_q, h_s = _global_rowquant(group, _san(h))
    return _write_if(flag, _row_epilogue(group, h_q, h_s, down.q,
                                         _san(down.scale), True,
                                         _san(residual), gate=flag), out)


def mlp(group: TPGroup, x2: torch.Tensor, mlp_mod, activation: str,
        use_kernel: bool, residual: torch.Tensor | None = None
        ) -> torch.Tensor:
    """The INT8 MLP over the ranks: up/gate column-parallel (f32 hidden
    columns, no requant), the hidden requant with the max-reduced global
    row scale, down row-parallel with the int32 sum before the residual
    epilogue.  x2 [M, d] replicated -> f32 [M, d] on every rank.
    ``mlp_mod`` holds this rank's shards (``up``, ``down``[, ``gate``])."""
    up, down = mlp_mod.up, mlp_mod.down
    gate = getattr(mlp_mod, "gate", None)
    if use_kernel:
        x_q, x_s = kops.quantize_rows_int8(x2.contiguous())
        h = kops.cim_hidden_int8(
            x_q, x_s, up.q, up.scale,
            gate_q=None if gate is None else gate.q,
            gate_scale=None if gate is None else gate.scale,
            activation=activation)
    elif gate is not None:
        h = kref.gated_mlp_hidden_ref(x2, gate.q, gate.scale, up.q, up.scale,
                                      activation)
    else:
        h = kref.fused_matmul_ref(x2, up.q, up.scale, activation=activation)
    h_q, h_s = _global_rowquant(group, h)
    return _row_epilogue(group, h_q, h_s, down.q, down.scale, use_kernel,
                         residual)


def expert_rows(group: TPGroup, x: torch.Tensor, moe,
                expert_counts: torch.Tensor | None):
    """This rank's slice of the experts' capacity rows x [E, T, d] and of
    the skip list: the rows of the E/p experts whose stacks it holds."""
    n = moe.up.q.shape[0]
    mine = slice(group.rank * n, (group.rank + 1) * n)
    return x[mine], None if expert_counts is None else expert_counts[mine]


def decode_attn(q, k, v, pos, q_pos, k_scale=None, v_scale=None, *,
                window=None, use_kernel: bool = True) -> torch.Tensor:
    """Head-parallel flash-decode over the ring cache: q [B, KH_r, G_r, D]
    holds this rank's q heads grouped over the KV heads it holds, and
    k/v [B, S, KH_r, D] (+ [B, S, KH_r] scales on the int8 path) are its
    cache: 1/p of the KV cache when KH divides p, else all of it.  No
    collective."""
    if use_kernel:
        return kops.decode_attention(q, k, v, pos, q_pos, k_scale=k_scale,
                                     v_scale=v_scale, window=window)
    return kref.decode_attention_ref(q, k, v, pos, q_pos, window=window,
                                     k_scale=k_scale, v_scale=v_scale)


def decode_attn_seq(seq: SeqCut, q, k, v, pos, q_pos, k_scale=None,
                    v_scale=None, *, window=None, heads_cut: bool = False,
                    use_kernel: bool = True) -> torch.Tensor:
    """Sequence-parallel flash-decode over a ring cut by sequence: q
    [B, KH, G_r, D] the rank's query heads (``heads_cut``: the ranks
    hold G = p G_r heads between them, in rank order; else G_r = G, all
    of them); k/v [B, L, KH, D] (+ scales) and pos [B, L] this rank's
    slots of a ring of ``seq.slots`` = p L.  Returns the rank's heads'
    output [B, KH, G_r, D].

    With ``heads_cut`` the ranks' query heads are gathered first (one
    all-gather), since a rank's slots must be attended by every head.
    Kernel 9 walks the rank's slots in ``n_splits_for(L)`` splits (at
    least one), its launch planned for the whole ring's length, and
    emits their raw (o, m, l); one all-gather stacks the ranks' partials
    in rank order on the split axis (kernel 10 sums in ascending split,
    so the order is the ring's); kernel 10 merges all p s partials of
    the rank's heads.  Where L is a multiple of the split length the
    partials are the unsharded split walk's of p s splits (a head's bits
    do not depend on the heads beside it), so the output is that walk's
    bit for bit: the walk this function takes over a whole ring
    (``seq.group`` None, ``walk_as_ranks``).  A rank with no visible
    slot in a row walks its slots as an all-masked row (m = -1e30) and
    kernel 10 weighs it exp(-1e30 - m_g) = 0."""
    group = seq.group
    L, G_r, D = k.shape[1] // (seq.ranks if group is None else 1), \
        q.shape[2], q.shape[-1]
    n = kops.n_splits_for(L) * (seq.ranks if group is None else 1)
    if heads_cut:
        q = group.all_gather(q.movedim(2, 0).contiguous()).movedim(0, 2)
    if use_kernel:
        o, m, l = kops.decode_attention_partial(
            q, k, v, pos, q_pos, k_scale=k_scale, v_scale=v_scale,
            window=window, n_splits=n, cluster_slots=seq.slots)
    else:
        o, m, l = kref.decode_attention_partial_ref(
            q.contiguous(), k, v, pos, q_pos, n,
            kops.split_len(k.shape[1], n), window=window, k_scale=k_scale,
            v_scale=v_scale)
    if group is not None:
        part = torch.cat([o, m, l], dim=-1)           # [B, KH, n, G, D+2]
        whole = group.all_gather(part.movedim(2, 0).contiguous()
                                 ).movedim(0, 2)
        if heads_cut:
            whole = whole[:, :, :, group.rank * G_r:(group.rank + 1) * G_r]
        o, m, l = (t.contiguous()
                   for t in torch.split(whole, [D, 1, 1], -1))
    if use_kernel:
        return kops.decode_attention_combine(o, m, l, q.dtype)
    return kref.combine_partials_ref(o, m, l).to(q.dtype)


def decode_attn_paged(q, k_pages, v_pages, pos_pages, block_tables, q_pos,
                      k_scale_pages=None, v_scale_pages=None, *,
                      window=None, use_kernel: bool = True) -> torch.Tensor:
    """Head-parallel paged flash-decode: :func:`decode_attn` over block
    pools [NB, bs, KH_r, D] holding this rank's KV heads; the block
    tables and positions are the same on every rank.  No collective."""
    if use_kernel:
        return kops.decode_attention_paged(
            q, k_pages, v_pages, pos_pages, block_tables, q_pos,
            k_scale_pages=k_scale_pages, v_scale_pages=v_scale_pages,
            window=window)
    return kref.decode_attention_paged_ref(
        q, k_pages, v_pages, pos_pages, block_tables, q_pos, window=window,
        k_scale_pages=k_scale_pages, v_scale_pages=v_scale_pages)
