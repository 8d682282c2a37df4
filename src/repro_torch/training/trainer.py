"""Training loop with checkpoint/restart, straggler detection, and
failure-injection hooks: the fault-tolerance layer (port of
``repro/training/trainer.py``).

Mechanisms:
  * restart: checkpoints hold the model's parameters and the optimizer
    state; the data pipeline is stateless by step, so a killed run
    resumes bit for bit.
  * restore onto any device: the checkpointer reads tensors back on the
    device the caller names, and the trainer copies them into the model
    where it lives.
  * straggler mitigation: per-step wall-time watermark (EMA + k sigma);
    steps above it are logged and counted.  The policy object is
    injectable so tests can assert detection.
  * failure injection: an optional callable raising mid-run proves the
    restart path end to end.

A train step here updates the model's parameters and the optimizer
state in place (``step(opt_state, batch) -> metrics``), where the
reference's returns new trees.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import optim
from repro_torch.checkpoint import Checkpointer
from repro_torch.convert import reference_paths
from repro_torch.data import Pipeline


@dataclass
class StragglerPolicy:
    """EMA watermark over step times; flags steps k-sigma above it."""
    ema: float = 0.0
    var: float = 0.0
    beta: float = 0.9
    k: float = 3.0
    warmup: int = 5
    seen: int = 0
    flagged: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        self.seen += 1
        if self.seen <= self.warmup:
            self.ema = dt if self.ema == 0 else \
                self.beta * self.ema + (1 - self.beta) * dt
            return False
        straggler = dt > self.ema + self.k * (self.var ** 0.5 + 1e-9) \
            and dt > 1.5 * self.ema
        delta = dt - self.ema
        self.ema += (1 - self.beta) * delta
        self.var = self.beta * (self.var + (1 - self.beta) * delta * delta)
        if straggler:
            self.flagged.append((step, dt))
        return straggler


@dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    log_every: int = 10
    checkpoint_dir: str = "checkpoints"
    keep: int = 3
    async_checkpoint: bool = True


def _copy_into(dst, src) -> None:
    """Copy a restored tree into the live tensors of ``dst``, in place."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _copy_into(d, s)
    else:
        dst.copy_(src)


def _synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (the reference's
    ``block_until_ready``); nothing to wait for on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    def __init__(self, model, train_step: Callable, opt_state: dict,
                 pipeline: Pipeline, cfg: TrainerConfig,
                 failure_hook: Optional[Callable[[int], None]] = None):
        self.model = model
        self.train_step = train_step
        self.opt_state = opt_state
        self.pipeline = pipeline
        self.cfg = cfg
        self.failure_hook = failure_hook
        self.ckpt = Checkpointer(cfg.checkpoint_dir, keep=cfg.keep,
                                 async_writes=cfg.async_checkpoint)
        self.straggler = StragglerPolicy()
        self.history: list[dict] = []

    def _state(self) -> dict:
        return {"params": dict(self.model.named_parameters()),
                "opt": self.opt_state}

    # ------------------------------------------------------------------
    def maybe_restore(self) -> int:
        """Resume from the latest committed checkpoint, if any."""
        state = self._state()
        step, restored = self.ckpt.restore_latest(state)
        if step is None:
            return 0
        with torch.no_grad():
            _copy_into(state, restored)
        return step

    def run(self, start_step: Optional[int] = None) -> dict:
        step = self.maybe_restore() if start_step is None else start_step
        last_loss = float("nan")
        device = self.model.device
        while step < self.cfg.total_steps:
            if self.failure_hook is not None:
                self.failure_hook(step)   # may raise (simulated crash)
            batch = self.pipeline.batch_at(step)
            t0 = time.perf_counter()
            metrics = self.train_step(self.opt_state, batch)
            _synchronize(device)
            dt = time.perf_counter() - t0
            flagged = self.straggler.observe(step, dt)
            step += 1
            last_loss = float(metrics["loss"])
            if step % self.cfg.log_every == 0 or flagged:
                rec = {"step": step, "loss": last_loss, "dt": dt,
                       "straggler": flagged,
                       "grad_norm": float(metrics.get("grad_norm", 0.0))}
                self.history.append(rec)
            if step % self.cfg.checkpoint_every == 0:
                self.ckpt.save(step, self._state())
        self.ckpt.save(self.cfg.total_steps, self._state())
        self.ckpt.wait()
        return {"final_step": step, "final_loss": last_loss,
                "stragglers": list(self.straggler.flagged),
                "history": self.history}


def device_batch(batch: dict, device: torch.device) -> dict:
    """A pipeline batch (numpy) as tensors on ``device``: integer arrays
    as int64 (token ids, targets), float arrays as they are."""
    out = {}
    for k, v in batch.items():
        a = np.ascontiguousarray(v)
        t = torch.from_numpy(a)
        out[k] = (t.long() if a.dtype.kind in "iu" else t).to(device)
    return out


def trained_parameters(model) -> dict:
    """Turn on the model's trained weights (:meth:`Model.trainable`) and
    key them by the reference's paths, the optimizer's keys."""
    model.trainable()
    return reference_paths(model)


def grads_of(params: dict) -> dict:
    """Each parameter's gradient, zeros where the loss does not reach it
    (musicgen's token embedding: the reference's gradient there is a
    zero tree, and AdamW still decays the weight)."""
    return {k: p.grad if p.grad is not None else torch.zeros_like(p)
            for k, p in params.items()}


def simple_train_step(model, ocfg: optim.AdamWConfig,
                      schedule: Optional[Callable] = None) -> Callable:
    """Unsharded single-device train step: ``step(opt_state, batch) ->
    metrics``.  It zeroes the gradients, takes ``loss.backward()`` of
    ``model.loss``, applies the AdamW update in place and returns
    ``loss``, ``nll``, ``aux``, ``tokens``, ``grad_norm`` and ``lr``
    (tensors).  ``step.params`` holds the trained parameters by the
    reference's paths (``optim.init(ocfg, step.params)`` makes its
    state)."""
    params = trained_parameters(model)
    apply_update = optim.update(ocfg, schedule)

    def step(opt_state: dict, batch: dict) -> dict:
        b = device_batch(batch, model.device)
        for p in params.values():
            p.grad = None
        loss, metrics = model.loss(b)
        loss.backward()
        om = apply_update(grads_of(params), opt_state, params)
        for p in params.values():
            p.grad = None
        metrics = {k: v.detach() for k, v in metrics.items()}
        return dict(metrics, **om, loss=loss.detach())

    step.params = params
    return step
