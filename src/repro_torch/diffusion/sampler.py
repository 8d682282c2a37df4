"""Samplers for DiT latent diffusion: DDIM and (t-space) Euler with
classifier-free guidance (port of ``repro/diffusion/sampler.py``).

Every sampler iteration is one full forward of the DiT over the fixed
latent token grid, so the sampler is a thin loop around
:meth:`repro_torch.models.dit.DiTModel.forward`:

* the timestep subsequence and the alpha-bar schedule are computed in
  numpy float64, so every per-step scalar is a host constant;
* classifier-free guidance runs the conditional and the null-label rows
  as ONE stacked batch of 2B rows (``guided_eps``), one launch sequence
  per step instead of two;
* ``num_steps`` 0 returns the initial noise unchanged, 1 step is a
  single DDIM jump to the x0 prediction.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class DiffusionSchedule:
    """Linear-beta DDPM schedule (ADM/DiT training defaults)."""

    n_train_steps: int = 1000
    beta_start: float = 1e-4
    beta_end: float = 0.02

    def betas(self) -> np.ndarray:
        """Per-step noise increments beta_t, t in [0, n_train_steps)."""
        return np.linspace(self.beta_start, self.beta_end,
                           self.n_train_steps, dtype=np.float64)

    def alpha_bars(self) -> np.ndarray:
        """Cumulative signal fraction alpha-bar_t."""
        return np.cumprod(1.0 - self.betas())

    def timesteps(self, num_steps: int) -> np.ndarray:
        """Evenly spaced descending timestep subsequence (int, length
        ``num_steps``); empty for 0 steps."""
        if num_steps <= 0:
            return np.zeros((0,), np.int64)
        return np.round(np.linspace(self.n_train_steps - 1, 0,
                                    num_steps)).astype(np.int64)


DEFAULT_SCHEDULE = DiffusionSchedule()


def _split_eps(model, out: torch.Tensor) -> torch.Tensor:
    """Keep the noise prediction; drop the learned-sigma channels."""
    C = model.cfg.in_channels
    return out[:, :C] if model.cfg.learn_sigma else out


def guided_eps(model, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor,
               cfg_scale: float = 0.0) -> torch.Tensor:
    """Noise prediction with classifier-free guidance.

    ``cfg_scale`` <= 0 runs one conditional pass.  Otherwise eps =
    eps_uncond + cfg_scale * (eps_cond - eps_uncond), with the
    conditional and null-label rows stacked into one 2B batch."""
    if cfg_scale <= 0.0:
        return _split_eps(model, model(x, t, y))
    null = torch.full_like(y, model.cfg.null_class)
    out = model(torch.cat([x, x]), torch.cat([t, t]), torch.cat([y, null]))
    eps_c, eps_u = torch.chunk(_split_eps(model, out), 2, dim=0)
    return eps_u + cfg_scale * (eps_c - eps_u)


@torch.no_grad()
def sample(model, y: torch.Tensor, *,
           generator: torch.Generator | None = None,
           x_init: torch.Tensor | None = None, num_steps: int = 8,
           cfg_scale: float = 0.0, method: str = "ddim",
           schedule: DiffusionSchedule = DEFAULT_SCHEDULE) -> torch.Tensor:
    """Generate latents for labels ``y`` [B] -> [B, C, H, W] f32 on y's
    device.

    ``x_init`` (the initial noise) or ``generator`` (drawn from on its
    device) must be given; fixed (noise, y, num_steps) is deterministic.
    ``method``:

    * ``"ddim"`` — eta=0: the exact jump through the x0 prediction;
    * ``"euler"`` — explicit first-order Euler on the VP
      probability-flow ODE in t-space, dx/dt = -beta(t)/2 * (x -
      eps/sqrt(1-alpha-bar_t)).
    """
    cfg = model.cfg
    if x_init is None:
        if generator is None:
            raise ValueError("sample() needs x_init or generator")
        x_init = torch.randn(
            (y.shape[0], cfg.in_channels, cfg.input_size, cfg.input_size),
            generator=generator, device=generator.device,
            dtype=torch.float32)
    if method not in ("ddim", "euler"):
        raise ValueError(f"unknown sampler method {method!r}")
    x = x_init.float()
    ab = schedule.alpha_bars()
    betas = schedule.betas()
    t_seq = schedule.timesteps(num_steps)

    for i, t in enumerate(t_seq):
        t_prev = int(t_seq[i + 1]) if i + 1 < len(t_seq) else None
        ab_t = float(ab[t])
        tb = torch.full((y.shape[0],), int(t), dtype=torch.int32,
                        device=x.device)
        eps = guided_eps(model, x, tb, y, cfg_scale).float()
        if method == "ddim":
            ab_prev = float(ab[t_prev]) if t_prev is not None else 1.0
            x0 = (x - float(np.sqrt(1.0 - ab_t)) * eps) / float(
                np.sqrt(ab_t))
            x = float(np.sqrt(ab_prev)) * x0 + float(
                np.sqrt(1.0 - ab_prev)) * eps
        else:  # first-order Euler on the VP probability-flow ODE
            dt = float((t_prev if t_prev is not None else 0) - t)
            beta_t = float(betas[t])
            drift = -0.5 * beta_t * (x - eps / float(np.sqrt(1.0 - ab_t)))
            x = x + dt * drift
    return x
