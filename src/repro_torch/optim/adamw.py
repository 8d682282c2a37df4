"""AdamW with dtype-configurable moments, global-norm clipping and
weight-decay masking (port of ``repro/optim/adamw.py``).

Parameters, gradients and moments are dicts keyed by the reference's
path of each leaf (:func:`repro_torch.convert.reference_paths` spells
them: ``['group_0']['attn']['q'][3]`` is layer 3 of the reference's
stacked leaf).  The decay mask reads that path, as the reference's
reads its tree path: the port's own attribute names (``mixer_norm``,
the sLSTM's ``b``) would decide differently.

:func:`update` applies the step to the parameters in place, under
``no_grad``, in the reference's arithmetic step for step (f32 moments
and update, the bias corrections in f32, the result cast back to each
parameter's dtype).  Moments are f32, or bf16 where the config says so
(the reference keeps them bf16 above 1e11 parameters).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch


@dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    moment_dtype: str = "float32"        # "bfloat16" for XXL configs


def _mdtype(cfg: AdamWConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.moment_dtype == "bfloat16" \
        else torch.float32


def init(cfg: AdamWConfig, params: dict) -> dict:
    """Zero moments beside each parameter, and the step count (an int32
    scalar on the parameters' device)."""
    dt = _mdtype(cfg)
    device = next(iter(params.values())).device
    return {
        "mu": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
               for k, p in params.items()},
        "nu": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
               for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum over tensors of each one's f32 sum of squares."""
    leaves = [torch.sum(torch.square(x.float())) for x in tensors]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def decay_mask(path: str) -> bool:
    """No weight decay on norms, scales and biases: the reference's
    ``_decay_mask`` on a leaf's path."""
    return not any(k in path for k in ("scale", "bias", "a_log", "dt_bias",
                                       "d_skip", "fgate_b"))


def update(cfg: AdamWConfig, schedule: Optional[Callable] = None):
    """Returns ``apply(grads, state, params, gnorm=None) -> metrics``: one
    AdamW step of ``params`` and ``state`` in place; ``grads``,
    ``state``'s moments and ``params`` are dicts with the same keys.
    ``schedule`` maps the new step (an int32 tensor) to the learning
    rate.  ``gnorm`` is the global norm to clip by where ``grads`` and
    ``params`` are a rank's shards of the leaves (the data-parallel
    step's moments, ZeRO-1): the norm of the whole gradients."""

    @torch.no_grad()
    def apply(grads: dict, state: dict, params: dict,
              gnorm: Optional[torch.Tensor] = None) -> dict:
        step = state["step"] + 1
        lr = cfg.learning_rate if schedule is None else schedule(step)
        if gnorm is None:
            gnorm = global_norm(grads.values())
        scale = None
        if cfg.clip_norm is not None:
            # a tensor numerator: torch turns ``float / tensor`` into a
            # reciprocal multiply
            scale = torch.clamp_max(
                torch.full_like(gnorm, cfg.clip_norm) / (gnorm + 1e-9), 1.0)
        b1, b2 = cfg.b1, cfg.b2
        one = torch.ones((), dtype=torch.float32, device=gnorm.device)
        bc1 = 1 - (one * b1) ** step.float()
        bc2 = 1 - (one * b2) ** step.float()
        dt = _mdtype(cfg)
        for key, p in params.items():
            # the reference scales g by an f32 array: the product is f32
            g32 = grads[key].float()
            if scale is not None:
                g32 = g32 * scale
            mu, nu = state["mu"][key], state["nu"][key]
            mu32 = mu.float() * b1 + (1 - b1) * g32
            nu32 = nu.float() * b2 + (1 - b2) * torch.square(g32)
            upd = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + cfg.eps)
            if cfg.weight_decay and decay_mask(key):
                upd = upd + cfg.weight_decay * p.float()
            p.copy_((p.float() - lr * upd).to(p.dtype))
            mu.copy_(mu32.to(dt))
            nu.copy_(nu32.to(dt))
        state["step"].copy_(step)
        lr_t = torch.as_tensor(lr, dtype=torch.float32, device=gnorm.device)
        return {"grad_norm": gnorm, "lr": lr_t}

    return apply


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1):
    """Linear warmup to ``peak_lr``, then a cosine down to ``floor`` of
    it at ``total``; the step is a tensor, the rate an f32 tensor."""
    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).float()
        warm = peak_lr * step / max(1, warmup)
        frac = torch.clamp((step - warmup) / max(1, total - warmup),
                           0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, peak_lr * cos)
    return schedule
