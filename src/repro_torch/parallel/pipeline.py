"""Pipeline parallelism: GPipe stages over a group of ranks (port of
``repro/parallel/pipeline.py``).

A model's layers split into ``P`` stages, one a rank of a
:class:`~repro_torch.parallel.context.TPGroup` (:func:`spawn` starts
them); microbatches stream through them GPipe-style.  The schedule is
the reference's: ``T = M + P - 1`` ticks; at tick ``t`` stage 0 takes
microbatch ``t``, a stage is active while ``0 <= t - stage < M``, hands
its output to the next stage, and the last stage records output
``t - (P - 1)``; the outputs are then replicated on every rank.  The
reference's ``ppermute`` over the ring becomes a send from each active
stage to the next (the last stage's hand-off to stage 0, which stage 0
never reads, is not sent), host-staged under gloo as the group's
collectives are (``TPGroup.send``, ``recv``), counted in
``group.hops``; the replication is a broadcast from the last stage
(``bcast``), where the reference sums zeros with a ``psum``.  An
inactive stage computes nothing, where the reference computes and
discards.

``stage_fn(params, x) -> x`` stays model-agnostic: ``params`` is this
rank's stage (the reference's stacked tree holds a leading stage axis,
sharded over the pipeline axis, so a device holds its own slice).
:func:`draw_stage` draws a rank's layers of an LM with the bits the
whole model's draw gives them, and :func:`block_stage_fn` runs them.
"""
from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Callable, Optional

import torch
from torch import nn

from .context import TPGroup


def gpipe_loop(stage_fn: Callable, stage_params, micro_x: torch.Tensor,
               group: TPGroup, hop_s: Optional[list] = None) -> torch.Tensor:
    """This rank's stage of the GPipe schedule.  ``micro_x`` [M, mb, ...]
    is read on stage 0 only (the other ranks pass a tensor of its shape
    and dtype); returns the outputs [M, mb, ...] on every rank.
    ``hop_s``, when given, gets the host seconds of each hand-off
    appended."""
    P, stage = group.size, group.rank
    M = micro_x.shape[0]
    outs = torch.zeros_like(micro_x)
    buf = torch.empty_like(micro_x[0])

    def hop(fn, *args):
        t0 = time.perf_counter()
        fn(*args)
        if hop_s is not None:
            hop_s.append(time.perf_counter() - t0)

    for t in range(M + P - 1):
        if not 0 <= t - stage < M:
            continue
        if stage == 0:
            x_in = micro_x[t]
        else:
            hop(group.recv, buf, stage - 1)
            x_in = buf
        y = stage_fn(stage_params, x_in)
        if stage == P - 1:
            outs[t - stage] = y
        else:
            hop(group.send, y, stage + 1)
    group.broadcast(outs, P - 1)
    return outs


def pipeline_apply(group: TPGroup, stage_fn: Callable, stage_params,
                   x: torch.Tensor, microbatches: int,
                   hop_s: Optional[list] = None) -> torch.Tensor:
    """x [B, ...] -> [B, ...] through the group's ``P`` stages, this rank
    running ``stage_fn(stage_params, .)``, in ``microbatches``
    microbatches of B / microbatches rows; the result on every rank."""
    B = x.shape[0]
    if B % microbatches:
        raise ValueError(f"a batch of {B} rows does not split into "
                         f"{microbatches} microbatches")
    micro = x.reshape(microbatches, B // microbatches, *x.shape[1:])
    out = gpipe_loop(stage_fn, stage_params, micro, group, hop_s=hop_s)
    return out.reshape(B, *out.shape[2:])


# ---------------------------------------------------------------------------
# An LM's decoder blocks as stages
# ---------------------------------------------------------------------------
def stage_layers(n_layers: int, stage: int, n_stages: int) -> range:
    """The layers of stage ``stage``: contiguous, the first
    ``n_layers % n_stages`` stages one layer longer."""
    base, extra = divmod(n_layers, n_stages)
    lo = stage * base + min(stage, extra)
    return range(lo, lo + base + (stage < extra))


def draw_stage(model, stage: int, n_stages: int,
               generator: torch.Generator, device, plan=None
               ) -> nn.ModuleList:
    """The blocks of stage ``stage`` of ``model`` (an LM on the meta
    device), allocated on ``device`` with the weights ``model.init``
    draws from ``generator``, then quantized under ``plan`` (None:
    left bf16).  Every other leaf is drawn into a temporary of its own
    shape and dropped, so the generator advances as in the whole draw:
    the rank holds its stage and one leaf's f32 temporary at most."""
    from repro_torch.models import layers
    from repro_torch.quant.plan import apply_plan

    blocks = nn.ModuleList(model.layers[i] for i in stage_layers(
        len(model.layers), stage, n_stages))
    for block in blocks:
        block.to_empty(device=device)

    def discard(p, gen, scale) -> None:
        tmp = torch.empty(p.shape, dtype=torch.float32, device=device)
        nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0, generator=gen)

    with layers.leaf_sink(discard):
        model.draw_(generator)
    if plan is not None:
        apply_plan(SimpleNamespace(layers=blocks), plan)
    return blocks


def block_stage_fn(cfg) -> Callable:
    """``stage_fn(blocks, x)``: x [mb, S, d] through ``blocks`` in order
    (``block_apply`` without a cache, the positions ``arange(S)`` in
    every row: a sequence above 2048 tokens attends on kernel 12 on the
    card)."""
    from repro_torch.models.model import block_apply

    def stage_fn(blocks, x: torch.Tensor) -> torch.Tensor:
        B, S = x.shape[:2]
        pos = torch.arange(S, device=x.device).expand(B, S)
        with torch.no_grad():
            for block in blocks:
                x = block_apply(block, cfg, x, pos, None,
                                aligned_positions=True)
        return x
    return stage_fn
