"""The train step with gradient accumulation (port of the train half of
``repro/launch/steps.py``).

The reference builds a jitted, GSPMD-sharded step over a mesh; the port
has one device a process, so :func:`build_train_step` takes the model
and returns a step that runs on its device.  Microbatch gradients are
summed into f32 buffers, as the reference's scan sums them: torch adds a
second ``backward()`` into ``.grad`` in the parameter's dtype (bf16),
so each microbatch's gradients are added to the f32 sums and released.
The reference's ``build_prefill_step`` and ``build_decode_step`` have
no counterpart yet: the serving entry point is
:mod:`repro_torch.launch.serve`.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch import optim
from repro_torch.configs.base import ModelConfig
from repro_torch.training.trainer import (device_batch, grads_of,
                                          simple_train_step,
                                          trained_parameters)


def optimizer_config(cfg: ModelConfig) -> optim.AdamWConfig:
    # XXL models keep moments in bf16 so training state fits memory.
    big = cfg.param_count() > 1e11
    return optim.AdamWConfig(learning_rate=3e-4,
                             moment_dtype="bfloat16" if big else "float32")


def build_train_step(cfg: ModelConfig, model,
                     ocfg: Optional[optim.AdamWConfig] = None) -> Callable:
    """``step(opt_state, batch) -> metrics`` for ``model`` (``cfg`` its
    config): :func:`~repro_torch.training.simple_train_step` when
    ``cfg.train_microbatches`` is 1, else the batch's rows split into
    that many microbatches, each one's loss and gradients summed in f32
    and divided by their count before one AdamW update; the metrics are
    the last microbatch's with the mean loss.  ``step.params`` holds the
    trained parameters by the reference's paths."""
    ocfg = ocfg or optimizer_config(cfg)
    mb = max(1, cfg.train_microbatches)
    if mb == 1:
        return simple_train_step(model, ocfg)
    params = trained_parameters(model)
    apply_update = optim.update(ocfg)
    gsum = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}

    def train_step(opt_state: dict, batch: dict) -> dict:
        b = device_batch(batch, model.device)
        rows = next(iter(b.values())).shape[0]
        if rows % mb:
            raise ValueError(f"a batch of {rows} rows does not split into "
                             f"{mb} microbatches")
        per = rows // mb
        for g in gsum.values():
            g.zero_()
        lsum = torch.zeros((), dtype=torch.float32, device=model.device)
        for i in range(mb):
            micro = {k: v[i * per: (i + 1) * per] for k, v in b.items()}
            for p in params.values():
                p.grad = None
            loss, metrics = model.loss(micro)
            loss.backward()
            for k, g in grads_of(params).items():
                gsum[k].add_(g)
            lsum = lsum + loss.detach()
        for p in params.values():
            p.grad = None
        grads = {k: g.div_(mb) for k, g in gsum.items()}
        om = apply_update(grads, opt_state, params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return dict(metrics, **om, loss=lsum / mb)

    train_step.params = params
    return train_step
