"""Rank-side work of ``tests/test_torch_pipeline_dp.py``: a pipeline
stage's share of a GPipe run and a data-parallel rank's train steps,
returned as numpy so that the parent test can hold them against the
stages run in sequence and the single-rank step.

Imports torch, numpy and the port only (no JAX): the ranks are processes
started with ``spawn`` and import this module by name.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import optim
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch.steps import build_train_step, optimizer_config
from repro_torch.models import Model
from repro_torch.parallel.context import rank_device
from repro_torch.parallel.pipeline import (block_stage_fn, draw_stage,
                                           pipeline_apply)
from repro_torch.quant import QuantPlan

ARCH = "gemma-2b"


def bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's raw bits (bf16 as int16), for bitwise comparison."""
    t = t.detach().contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def smoke_cfg():
    return reduced_config(get_config(ARCH))


def tanh_stages(group, case: dict) -> dict:
    """The reference's own case: stage i computes tanh(x @ w[i])."""
    ws = torch.from_numpy(case["ws"])
    out = pipeline_apply(group, lambda w, x: torch.tanh(x @ w),
                         ws[group.rank], torch.from_numpy(case["x"]),
                         case["microbatches"])
    return dict(out=bits(out), hops=group.hops, counts=dict(group.counts))


def block_stages(group, case: dict) -> dict:
    """gemma-2b-smoke's blocks as stages, each rank drawing only its own
    (the whole model's bits), under the full plan or none, on
    ``case["device"]`` (default the CPU; the card's ranks share it)."""
    cfg = smoke_cfg()
    dev = rank_device(case.get("device", "cpu"), group.backend, group.rank)
    gen = torch.Generator(device=dev).manual_seed(case["seed"])
    plan = QuantPlan.full() if case["full"] else None
    blocks = draw_stage(Model(cfg), group.rank, group.size, gen, dev, plan)
    x = torch.from_numpy(case["x"]).to(device=dev, dtype=torch.bfloat16)
    out = pipeline_apply(group, block_stage_fn(cfg), blocks, x,
                         case["microbatches"])
    return dict(out=bits(out.cpu()), hops=group.hops, layers=len(blocks),
                counts=dict(group.counts))


def train_steps(group, case: dict, dp: bool = True) -> dict:
    """gemma-2b-smoke from the seed, trained on ``case["batches"]`` by
    the data-parallel step over ``group`` (``dp``) or the single-rank
    step: each step's loss, the first step's mean f32 gradients, the
    parameters' bits after the last step, the moments' elements held."""
    cfg = smoke_cfg()
    model = Model(cfg).init(case["seed"], device="cpu")
    ocfg = optimizer_config(cfg)
    step = build_train_step(cfg, model, ocfg, dp=group if dp else None)
    state = optim.init(ocfg, step.shards)
    losses, grads = [], None
    if dp:
        group.reset_counts()
    for i, batch in enumerate(case["batches"]):
        met = step(state, batch)
        losses.append(float(met["loss"]))
        if i == 0:
            grads = {k: g.numpy().copy() for k, g in step.grads.items()}
    return dict(losses=losses, grads=grads,
                params={k: bits(p) for k, p in step.params.items()},
                moments=sum(m.numel() for m in state["mu"].values()),
                moment_shapes={k: tuple(m.shape)
                               for k, m in state["mu"].items()},
                counts=dict(group.counts) if dp else None)


def run_cases(group, cases: dict) -> dict:
    """``cases``: name -> (kind, case dict).  One thread per rank: the
    ranks share the host's cores, and the shapes are tiny."""
    torch.set_num_threads(1)
    todo = {"tanh": tanh_stages, "blocks": block_stages,
            "train": train_steps}
    return {name: todo[kind](group, case)
            for name, (kind, case) in cases.items()}
