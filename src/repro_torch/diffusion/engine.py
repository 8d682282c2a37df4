"""Batched image-generation serving: the DiT sibling of ``ServingEngine``
(port of ``repro/diffusion/engine.py``).

Diffusion inference has no KV cache and no per-token progress: every
request is ``num_steps`` full denoise evaluations over a fixed latent
token grid (1024 tokens for DiT-XL/2).  The engine therefore batches
whole requests: compatible queued requests (same step count, guidance
scale and sampler method, the batch key) are stacked into batches of
``batch_size`` latents and run through one :func:`sample` call; a short
batch pads by repeating its last row (padded rows are computed and
discarded, so every batch has one shape).

``quant_plan`` puts every denoise step on the INT8 pipeline (6 plan
launches per DiT block, plus kernel 12 for attention on the card).

The request lifecycle is the LM engine's
(:mod:`repro_torch.serving.lifecycle`): bounded-queue backpressure,
deadline expiry while queued, non-finite-latent health checks, and
loud stalls.

Each request's initial noise is drawn from a ``torch.Generator`` on the
engine's device, seeded from ``(seed, uid)``; the reference draws it
from ``jax.random``, so the two engines start from different noise for
the same request (same distribution).
"""
from __future__ import annotations

import contextlib
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.quant import degraded_mode
from repro_torch.serving.lifecycle import (EngineStallError, LifecycleMixin,
                                           RequestStatus)
from .sampler import DEFAULT_SCHEDULE, DiffusionSchedule, sample


@dataclass
class ImageRequest(LifecycleMixin):
    uid: int
    label: int                          # class id in [0, n_classes)
    num_steps: int = 8
    cfg_scale: float = 0.0              # 0 = unguided
    method: str = "ddim"
    seed: int = 0
    deadline_s: Optional[float] = None  # TTL from submission (engine clock)

    # filled by the engine (``done`` is the shared lifecycle property)
    latents: Optional[np.ndarray] = None   # [C, H, W] f32
    status: RequestStatus = RequestStatus.QUEUED
    error: Optional[str] = None
    submitted_at: float = 0.0
    finished_at: Optional[float] = None


@dataclass
class DiffusionStats:
    batches: int = 0
    denoise_steps: int = 0              # sampler steps (per batch)
    images_out: int = 0
    batch_occupancy: list = field(default_factory=list)
    wall_s: float = 0.0
    submitted: int = 0
    completed: int = 0
    failed: int = 0
    rejected: int = 0
    timed_out: int = 0


class DiffusionEngine:
    def __init__(self, model, batch_size: int = 4, quant_plan=None,
                 schedule: DiffusionSchedule = DEFAULT_SCHEDULE,
                 max_queue: Optional[int] = None, degraded: bool = False,
                 health_checks: bool = True,
                 fault_hook: Optional[Callable] = None, clock=None,
                 obs=None):
        """``model`` is a :class:`~repro_torch.models.dit.DiTModel`
        holding its weights; the engine runs on the model's device.  A
        ``quant_plan`` is applied to the model in place.

        * ``max_queue`` — bounded admission queue; when full, ``submit``
          returns ``RequestStatus.REJECTED``.
        * ``degraded`` — sample under
          :func:`repro_torch.quant.degraded_mode` (each quantized layer's
          finite screen and gated fallback).
        * ``health_checks`` — fail a request on non-finite latents.
        * ``fault_hook(phase, latents) -> latents | None`` — host-side
          interception point after every batch's fetch ("denoise", the
          padded batch's latents [batch_size, C, H, W]), as the
          reference calls it.
        * ``clock`` — injectable monotonic clock (seconds) for deadlines.
        * ``obs`` — a :class:`repro_torch.obs.Observability`: submit,
          denoise-batch and finish hooks on the host, each behind one
          ``obs is not None`` test (an engine without it runs the code it
          ran before).
        """
        self.model = model
        if quant_plan is not None:
            model.quantize(quant_plan)
        self.quant_plan = quant_plan
        self.device = model.device
        self.batch = batch_size
        self.schedule = schedule
        self.max_queue = max_queue
        self.degraded = degraded
        self.health_checks = health_checks
        self.fault_hook = fault_hook
        self.closed = False
        self._clock = clock if clock is not None else time.monotonic
        self.queue: deque[ImageRequest] = deque()
        self.stats = DiffusionStats()
        self.obs = obs
        if obs is not None:
            obs.bind_dit_engine(self)

    # ------------------------------------------------------------------
    def _finish(self, req: ImageRequest, status: RequestStatus,
                error: Optional[str] = None) -> RequestStatus:
        now = self._clock()
        req.finish(status, error, now=now)
        if status is RequestStatus.OK:
            self.stats.completed += 1
        elif status is RequestStatus.FAILED:
            self.stats.failed += 1
        elif status is RequestStatus.TIMED_OUT:
            self.stats.timed_out += 1
        else:
            self.stats.rejected += 1
        if self.obs is not None:
            self.obs.on_finish(req, status, req.error, now)
        return status

    def submit(self, req: ImageRequest) -> RequestStatus:
        """Queue a request; returns its (possibly terminal) status.

        Malformed requests raise ``ValueError`` (label outside the model's
        class space — the null class is reserved for CFG — or a bad step
        count or sampler method); capacity rejections (closed engine,
        bounded queue full) return ``RequestStatus.REJECTED``.
        """
        n_classes = self.model.cfg.n_classes
        if not (0 <= req.label < n_classes):
            self._finish(req, RequestStatus.REJECTED, "label out of range")
            raise ValueError(
                f"label {req.label} outside [0, {n_classes}) (the last "
                "embedding row is the reserved CFG null class)")
        if req.num_steps < 0:
            self._finish(req, RequestStatus.REJECTED, "negative num_steps")
            raise ValueError("num_steps must be >= 0")
        if req.method not in ("ddim", "euler"):
            self._finish(req, RequestStatus.REJECTED, "unknown method")
            raise ValueError(f"unknown sampler method {req.method!r}")
        if self.closed:
            return self._finish(req, RequestStatus.REJECTED,
                                "engine closed (draining or shut down)")
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            return self._finish(
                req, RequestStatus.REJECTED,
                f"queue full ({self.max_queue} waiting): backpressure")
        req.status = RequestStatus.QUEUED
        req.submitted_at = self._clock()
        self.queue.append(req)
        self.stats.submitted += 1
        if self.obs is not None:
            self.obs.on_submit(req, req.submitted_at, len(self.queue))
        return RequestStatus.QUEUED

    def _noise(self, req: ImageRequest) -> torch.Tensor:
        """The request's initial latents [C, H, W] f32 on the engine's
        device, from a generator seeded from ``(seed, uid)``."""
        cfg = self.model.cfg
        seed = np.random.SeedSequence((req.seed, req.uid)).generate_state(
            1, np.uint64)[0]
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return torch.randn((cfg.in_channels, cfg.input_size, cfg.input_size),
                           generator=gen, device=self.device,
                           dtype=torch.float32)

    def _purge_expired(self, now: float) -> None:
        if not any(r.deadline_s is not None for r in self.queue):
            return
        keep: deque[ImageRequest] = deque()
        while self.queue:
            r = self.queue.popleft()
            if r.expired(now):
                self._finish(r, RequestStatus.TIMED_OUT,
                             "deadline expired while queued")
            else:
                keep.append(r)
        self.queue = keep

    def step(self) -> None:
        """Run one batch: pop up to ``batch_size`` queued requests that
        share the head of the queue's key, pad, sample, deliver."""
        self._purge_expired(self._clock())
        if not self.queue:
            return
        head = self.queue[0]
        key = (head.num_steps, head.cfg_scale, head.method)
        batch: list[ImageRequest] = []
        rest: deque[ImageRequest] = deque()
        while self.queue and len(batch) < self.batch:
            r = self.queue.popleft()
            if (r.num_steps, r.cfg_scale, r.method) == key:
                r.status = RequestStatus.ACTIVE
                batch.append(r)
            else:
                rest.append(r)
        self.queue = rest + self.queue   # the skipped keep their order

        t0 = time.perf_counter()
        rows = batch + [batch[-1]] * (self.batch - len(batch))
        noise = torch.stack([self._noise(r) for r in rows])
        labels = torch.tensor([r.label for r in rows], dtype=torch.int32,
                              device=self.device)
        with (degraded_mode(True) if self.degraded
              else contextlib.nullcontext()):
            lat = sample(self.model, labels, x_init=noise,
                         num_steps=head.num_steps, cfg_scale=head.cfg_scale,
                         method=head.method, schedule=self.schedule)
        lat = lat.cpu().numpy()
        if self.fault_hook is not None:
            out = self.fault_hook("denoise", lat)
            if out is not None:
                lat = np.asarray(out)
        if self.obs is not None:
            # guidance stacks the conditional and null rows into one
            # batch of 2B: a guided image takes two evaluations a step
            evals = head.num_steps * (2 if head.cfg_scale > 0.0 else 1)
            self.obs.on_denoise_batch(batch, evals, self._clock())
        delivered = 0
        for i, r in enumerate(batch):
            if self.health_checks and not np.isfinite(lat[i]).all():
                self._finish(r, RequestStatus.FAILED, "non-finite latents")
                continue
            r.latents = lat[i]
            self._finish(r, RequestStatus.OK)
            delivered += 1
        self.stats.batches += 1
        self.stats.denoise_steps += head.num_steps
        self.stats.images_out += delivered
        self.stats.batch_occupancy.append(len(batch) / self.batch)
        self.stats.wall_s += time.perf_counter() - t0

    def pending(self) -> int:
        return len(self.queue)

    def run_until_done(self, max_iters: int = 10_000,
                       on_stall: str = "raise") -> None:
        """Step until the queue is empty; a stall is never silent."""
        if on_stall not in ("raise", "timeout"):
            raise ValueError(f"on_stall must be 'raise' or 'timeout', "
                             f"got {on_stall!r}")
        for _ in range(max_iters):
            if not self.queue:
                return
            self.step()
        if not self.queue:
            return
        if on_stall == "timeout":
            while self.queue:
                self._finish(self.queue.popleft(), RequestStatus.TIMED_OUT,
                             "engine stalled at max_iters")
            return
        raise EngineStallError(
            f"run_until_done hit max_iters={max_iters} with "
            f"{len(self.queue)} request(s) still queued")

    def drain(self, max_iters: int = 10_000,
              on_stall: str = "timeout") -> None:
        """Stop admitting new work and run the accepted queue dry."""
        self.closed = True
        self.run_until_done(max_iters, on_stall=on_stall)

    def shutdown(self, drain: bool = True, max_iters: int = 10_000) -> None:
        if drain:
            self.drain(max_iters)
            return
        self.closed = True
        while self.queue:
            self._finish(self.queue.popleft(), RequestStatus.REJECTED,
                         "engine shutdown")
