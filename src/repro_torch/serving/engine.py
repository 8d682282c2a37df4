"""Serving engine: continuous batching over fixed decode slots (port of
``repro/serving/engine.py::ServingEngine``, the ring-cache engine).

* ``n_slots`` concurrent sequences share one batched ring KV cache.
* Requests queue up; free slots are prefilled one request at a time
  (the slot's cache view is reset and written in place) and then join
  the batched decode step.
* Every decode step advances all active slots by one token; finished
  sequences free their slot immediately.
* Sampling runs on the host in numpy, seeded per ``(seed, uid, step)``,
  exactly as the reference samples, so equal logits give equal tokens.

Every request ends in exactly one terminal
:class:`~repro_torch.serving.lifecycle.RequestStatus`; the queue can be
bounded (typed ``REJECTED`` backpressure), deadlines expire queued and
active work, and health checks fail a request on non-finite logits.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.models.attention import EMPTY_SLOT
from .lifecycle import EngineStallError, LifecycleMixin, RequestStatus


@dataclass
class Request(LifecycleMixin):
    uid: int
    prompt: np.ndarray                  # [prompt_len] int32
    max_new_tokens: int = 32
    temperature: float = 0.0            # 0 = greedy
    top_k: int = 0
    eos_id: Optional[int] = None
    seed: int = 0
    deadline_s: Optional[float] = None  # TTL from submission (engine clock)

    generated: list = field(default_factory=list)
    status: RequestStatus = RequestStatus.QUEUED
    error: Optional[str] = None
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None


@dataclass
class EngineStats:
    prefills: int = 0
    decode_steps: int = 0
    tokens_out: int = 0
    batch_occupancy: list = field(default_factory=list)
    submitted: int = 0
    completed: int = 0          # reached OK
    failed: int = 0             # reached FAILED
    rejected: int = 0           # reached REJECTED
    timed_out: int = 0          # reached TIMED_OUT
    prefill_failures: int = 0   # health check tripped on prefill logits


class ServingEngine:
    def __init__(self, model, n_slots: int = 4, max_len: int = 512,
                 prefill_bucket: int = 64, quant_plan=None,
                 max_queue: Optional[int] = None,
                 health_checks: bool = True, clock=None):
        """``model`` is a :class:`~repro_torch.models.model.Model` holding
        its weights; the engine runs on the model's device.  A
        ``quant_plan`` is applied to the model in place (covered weights
        become int8) and, when it covers ``attn_kv``, the KV cache is
        stored int8.

        * ``max_queue`` — bounded admission queue; when full, ``submit``
          returns ``RequestStatus.REJECTED``.
        * ``health_checks`` — fail a slot's request on non-finite logits
          instead of sampling from them.
        * ``clock`` — injectable monotonic clock (seconds) for deadlines.
        """
        self.model = model
        if quant_plan is not None:
            model.quantize(quant_plan)
        self.quant_plan = quant_plan
        self.device = model.device
        self.n_slots = n_slots
        self.max_len = max_len
        self.bucket = prefill_bucket
        self.max_queue = max_queue
        self.health_checks = health_checks
        self.closed = False
        self._clock = clock if clock is not None else time.monotonic
        self.kv_dtype = ("int8" if quant_plan is not None
                         and quant_plan.attn_kv else None)
        self.cache = model.init_cache(n_slots, max_len, kv_dtype=self.kv_dtype)
        self.slot_req: list[Optional[Request]] = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, np.int32)
        self.slot_last = np.zeros(n_slots, np.int32)
        self.queue: deque[Request] = deque()
        self.stats = EngineStats()

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _prefill_one(self, tokens: np.ndarray, slot: int,
                     length: int) -> torch.Tensor:
        """Prefill one request into slot ``slot``: the slot's view of
        every layer's cache is reset (zeros, empty positions, index 0)
        and prefilled with batch 1, writing into the batched cache in
        place.  ``tokens`` is the bucket-padded prompt and ``length`` its
        true length.  Returns the last real token's logits [vocab]."""
        sub = [{k: v[slot:slot + 1] for k, v in c.items()}
               for c in self.cache]
        for c in sub:
            for v in c.values():
                v.zero_()
            c["pos"].fill_(EMPTY_SLOT)
        toks = torch.as_tensor(tokens, dtype=torch.long,
                               device=self.device)[None]
        lengths = torch.tensor([length], dtype=torch.int32,
                               device=self.device)
        return self.model.prefill_padded(toks, sub, lengths)[0, -1]

    @torch.no_grad()
    def _decode_all(self, last_tokens: np.ndarray) -> torch.Tensor:
        toks = torch.as_tensor(last_tokens, dtype=torch.long,
                               device=self.device)[:, None]
        return self.model.decode_step(toks, self.cache)[:, 0]

    @staticmethod
    def _to_host(logits: torch.Tensor) -> np.ndarray:
        return logits.float().cpu().numpy()

    # ------------------------------------------------------------------
    def _finish(self, req: Request, status: RequestStatus,
                error: Optional[str] = None) -> RequestStatus:
        req.finish(status, error, now=self._clock())
        if status is RequestStatus.OK:
            self.stats.completed += 1
        elif status is RequestStatus.FAILED:
            self.stats.failed += 1
        elif status is RequestStatus.TIMED_OUT:
            self.stats.timed_out += 1
        else:
            self.stats.rejected += 1
        return status

    def submit(self, req: Request) -> RequestStatus:
        """Queue a request; returns its (possibly terminal) status.

        Empty prompts and prompts whose bucket-padded length reaches
        ``max_len`` raise ``ValueError``; capacity rejections (closed
        engine, full queue) return ``RequestStatus.REJECTED``.
        """
        L = len(req.prompt)
        if L == 0:
            self._finish(req, RequestStatus.REJECTED, "empty prompt")
            raise ValueError("empty prompt: requests must contain at "
                             "least one token")
        padded = L + (-L) % self.bucket
        if padded >= self.max_len:
            self._finish(req, RequestStatus.REJECTED,
                         "padded prompt would wrap the ring cache")
            raise ValueError(
                f"prompt of length {L} pads to the {padded}-token prefill "
                f"bucket, but max_len={self.max_len}: the ring cache would "
                f"wrap and silently drop the oldest prompt tokens. Raise "
                f"max_len (or shrink prefill_bucket) so padded prompts "
                f"stay strictly below it.")
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
        return RequestStatus.QUEUED

    def _sample(self, req: Request, logits: np.ndarray, step: int) -> int:
        """Sample the next token; hardened against non-finite logits."""
        logits = np.asarray(logits)
        finite = np.isfinite(logits)
        if not finite.any():
            return 0
        masked = np.where(finite, logits, -np.inf)
        if req.temperature <= 0.0:
            return int(np.argmax(masked))
        rng = np.random.default_rng((req.seed, req.uid, step))
        x = masked.astype(np.float64) / req.temperature
        if req.top_k:
            kth = np.partition(x, -req.top_k)[-req.top_k]
            x = np.where(x < kth, -np.inf, x)
        m = x.max()
        if not np.isfinite(m):        # top-k landed entirely on -inf
            return int(np.argmax(masked))
        p = np.exp(x - m)
        p /= p.sum()
        return int(rng.choice(len(p), p=p))

    # ------------------------------------------------------------------
    def _admit(self, now: float) -> None:
        """Fill free slots from the queue (prefill path)."""
        for slot in range(self.n_slots):
            while self.slot_req[slot] is None and self.queue:
                req = self.queue.popleft()
                if req.expired(now):
                    self._finish(req, RequestStatus.TIMED_OUT,
                                 "deadline expired while queued")
                    continue
                L = len(req.prompt)
                pad = (-L) % self.bucket
                # pad to the bucket by repeating the final token; the pad
                # positions are masked inside prefill
                toks = np.concatenate(
                    [req.prompt,
                     np.full(pad, req.prompt[-1])]).astype(np.int32)
                logits = self._to_host(self._prefill_one(toks, slot, L))
                self.stats.prefills += 1
                if self.health_checks and not np.isfinite(logits).all():
                    self.stats.prefill_failures += 1
                    self._finish(req, RequestStatus.FAILED,
                                 "non-finite prefill logits")
                    continue
                nxt = self._sample(req, logits, 0)
                req.status = RequestStatus.ACTIVE
                req.generated.append(nxt)
                if req.first_token_at is None:
                    req.first_token_at = self._clock()
                self.slot_req[slot] = req
                self.slot_pos[slot] = L
                self.slot_last[slot] = nxt

    def _active(self) -> list[int]:
        return [i for i, r in enumerate(self.slot_req) if r is not None]

    def step(self) -> None:
        """One engine iteration: expire + admit + one batched decode."""
        now = self._clock()
        for slot in self._active():
            req = self.slot_req[slot]
            if req.expired(now):
                self._finish(req, RequestStatus.TIMED_OUT,
                             "deadline expired mid-decode")
                self.slot_req[slot] = None
        self._admit(now)
        active = self._active()
        if not active:
            return
        self.stats.batch_occupancy.append(len(active) / self.n_slots)
        logits = self._to_host(self._decode_all(self.slot_last))
        self.stats.decode_steps += 1
        for slot in active:
            req = self.slot_req[slot]
            if self.health_checks and not np.isfinite(logits[slot]).all():
                self._finish(req, RequestStatus.FAILED, "non-finite logits")
                self.slot_req[slot] = None    # cache reset on next prefill
                continue
            tok = self._sample(req, logits[slot], len(req.generated))
            req.generated.append(tok)
            self.stats.tokens_out += 1
            self.slot_last[slot] = tok
            self.slot_pos[slot] += 1
            if ((req.eos_id is not None and tok == req.eos_id)
                    or len(req.generated) >= req.max_new_tokens
                    or self.slot_pos[slot] >= self.max_len - 1):
                self._finish(req, RequestStatus.OK)
                self.slot_req[slot] = None    # slot freed immediately

    def pending(self) -> int:
        """Requests not yet terminal: queued + active."""
        return len(self.queue) + len(self._active())

    def run_until_done(self, max_iters: int = 10_000,
                       on_stall: str = "raise") -> None:
        """Step until every request is terminal; a stall raises
        :class:`EngineStallError` (``on_stall='raise'``) or times every
        pending request out (``on_stall='timeout'``)."""
        if on_stall not in ("raise", "timeout"):
            raise ValueError(f"on_stall must be 'raise' or 'timeout', "
                             f"got {on_stall!r}")
        for _ in range(max_iters):
            if not self.pending():
                return
            self.step()
        if not self.pending():
            return
        if on_stall == "timeout":
            self._expire_pending("engine stalled at max_iters")
            return
        raise EngineStallError(
            f"run_until_done hit max_iters={max_iters} with "
            f"{len(self.queue)} queued and {len(self._active())} active "
            f"request(s) still pending")

    def _expire_pending(self, why: str) -> None:
        while self.queue:
            self._finish(self.queue.popleft(), RequestStatus.TIMED_OUT, why)
        for slot in self._active():
            self._finish(self.slot_req[slot], RequestStatus.TIMED_OUT, why)
            self.slot_req[slot] = None

    def drain(self, max_iters: int = 10_000,
              on_stall: str = "timeout") -> None:
        """Stop admitting new work and run everything accepted to a
        terminal status."""
        self.closed = True
        self.run_until_done(max_iters, on_stall=on_stall)

    def shutdown(self, drain: bool = True, max_iters: int = 10_000) -> None:
        """Stop the engine; ``drain=False`` aborts (queued -> REJECTED,
        active -> FAILED)."""
        if drain:
            self.drain(max_iters)
            return
        self.closed = True
        while self.queue:
            self._finish(self.queue.popleft(), RequestStatus.REJECTED,
                         "engine shutdown")
        for slot in self._active():
            self._finish(self.slot_req[slot], RequestStatus.FAILED,
                         "engine shutdown with request in flight")
            self.slot_req[slot] = None
