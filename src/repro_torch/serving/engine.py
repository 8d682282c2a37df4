"""Serving engines: continuous batching over fixed decode slots (port of
``repro/serving/engine.py``): :class:`ServingEngine` over the ring KV
cache, and :class:`PagedServingEngine` over the paged one (block-table
pools, chunked prefill, preemption by recompute; see its note).

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

With ``tp`` (a :class:`~repro_torch.parallel.context.TPGroup`) every
rank runs an engine over its shards of the model: the same scheduler on
the same requests, the same logits on every rank, so the same tokens and
decisions; at the end of a run the ranks check that they agree.
"""
from __future__ import annotations

import contextlib
import hashlib
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.models.attention import EMPTY_SLOT
from repro_torch.parallel.context import tp_context
from repro_torch.parallel.sharding import shard_model
from repro_torch.quant import degraded_mode
from .lifecycle import EngineStallError, LifecycleMixin, RequestStatus
from .paged_cache import PagedKVCache, PoolExhausted


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
    # paged-engine counters (zero on the ring engine)
    preemptions: int = 0        # sequences evicted for blocks, requeued
    prefill_chunks: int = 0     # chunked-prefill forwards
    pool_exhaustions: int = 0   # KV pool allocation failures (grow/admit)
    evicted_blocks: int = 0     # blocks freed by preemption evictions
    cache_utilization: list = field(default_factory=list)


class ServingEngine:
    def __init__(self, model, n_slots: int = 4, max_len: int = 512,
                 prefill_bucket: int = 64, quant_plan=None,
                 max_queue: Optional[int] = None, degraded: bool = False,
                 health_checks: bool = True,
                 fault_hook: Optional[Callable] = None, clock=None,
                 tp=None, obs=None):
        """``model`` is a :class:`~repro_torch.models.model.Model` holding
        its weights; the engine runs on the model's device.  Prompts are
        tokens: a vision config serves text prompts whose first
        ``frontend_len`` positions form the bidirectional prefix, as in
        the reference; an audio config is refused.  A
        ``quant_plan`` is applied to the model in place (covered weights
        become int8) and, when it covers ``attn_kv``, the KV cache is
        stored int8.

        * ``tp`` — this rank's tensor-parallel group: the quantized
          leaves are cut to the rank's shards in place
          (:func:`~repro_torch.parallel.sharding.shard_model`, a
          ``quant_plan`` is required), the KV cache holds the rank's KV
          heads, and every forward runs under the group.  Each rank
          drives its own engine with the same requests; deadlines are
          decided by rank 0's clock (:meth:`_expired`).

        * ``max_queue`` — bounded admission queue; when full, ``submit``
          returns ``RequestStatus.REJECTED``.
        * ``degraded`` — run every forward under
          :func:`repro_torch.quant.degraded_mode`: each quantized layer
          screens its fused output on the device and falls back to the
          sanitized pipeline when it is non-finite (gated launches: a
          healthy step pays the screens, no host sync).
        * ``health_checks`` — fail a slot's request on non-finite logits
          instead of sampling from them.
        * ``fault_hook(phase, logits) -> logits | None`` — host-side
          interception point after every prefill ("prefill", the last
          token's logits [vocab]) and decode ("decode", [n_slots, vocab],
          empty slots included) fetch, as the reference calls it; the
          chaos harness (:mod:`repro_torch.reliability.chaos`) uses it.
        * ``clock`` — injectable monotonic clock (seconds) for deadlines.
        * ``obs`` — a :class:`repro_torch.obs.Observability`.  Every
          instrumentation point is on the host and behind one ``obs is
          not None`` test, so an engine without it runs the code it ran
          before (bitwise the same tokens and launches); the hooks read
          host values only, adding no device sync.

        ``degraded`` and ``fault_hook`` are not ported under ``tp`` yet
        (ROADMAP A.3) and raise ``NotImplementedError`` there.
        """
        if model.cfg.frontend == "audio":
            raise ValueError(f"{model.cfg.name}: an audio-frontend arch "
                             f"takes frame embeddings, not token prompts; "
                             f"drive Model.prefill_padded / decode_step "
                             f"with frame_embeddings=")
        self.model = model
        if tp is not None and quant_plan is None:
            raise ValueError("tensor parallelism runs the INT8 plan: pass "
                             "a quant_plan with tp")
        if tp is not None and (degraded or fault_hook is not None):
            raise NotImplementedError("degraded mode and fault hooks under "
                                      "tensor parallelism are not ported yet "
                                      "(ROADMAP A.3)")
        if quant_plan is not None:
            model.quantize(quant_plan)
        if tp is not None:
            shard_model(model, tp)
        self.tp = tp
        self._finished: list[tuple] = []    # (uid, status, tokens) under tp
        self.quant_plan = quant_plan
        self.device = model.device
        self.n_slots = n_slots
        self.max_len = max_len
        self.bucket = prefill_bucket
        self.max_queue = max_queue
        self.degraded = degraded
        self.health_checks = health_checks
        self.fault_hook = fault_hook
        self.closed = False
        self._clock = clock if clock is not None else time.monotonic
        self.kv_dtype = ("int8" if quant_plan is not None
                         and quant_plan.attn_kv else None)
        self.cache = self._init_cache()
        self.slot_req: list[Optional[Request]] = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, np.int32)
        self.slot_last = np.zeros(n_slots, np.int32)
        self.queue: deque[Request] = deque()
        self.stats = EngineStats()
        self.obs = obs
        if obs is not None:
            obs.bind_llm_engine(self)

    def _init_cache(self) -> list:
        """The KV cache; the paged engine overrides this with block pools
        and tables."""
        return self.model.init_cache(self.n_slots, self.max_len,
                                     kv_dtype=self.kv_dtype)

    @contextlib.contextmanager
    def _forward_ctx(self):
        """The context of every forward: the engine's tensor-parallel
        group (None: no group) and, with ``degraded``, the quantized
        layers' finite screen and fallback."""
        with tp_context(self.tp):
            if self.degraded:
                with degraded_mode(True):
                    yield
            else:
                yield

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _prefill_one(self, tokens: np.ndarray, slot: int,
                     length: int) -> torch.Tensor:
        """Prefill one request into slot ``slot``: the slot's view of
        every layer's cache is reset (zeros, empty positions, index 0)
        and prefilled with batch 1, writing into the batched cache in
        place.  ``tokens`` is the bucket-padded prompt and ``length`` its
        true length.  Returns the last real token's logits [vocab].  A
        recurrent (Mamba-2, mLSTM, sLSTM) layer has no position-keyed
        cache, so its state and conv tail take the pad tokens in, as the
        reference's do: padding there stays approximate (ROADMAP C.11).
        Every leaf is zeroed, as the reference's ``jnp.zeros_like`` reset
        does, so an xLSTM stabilizer ``m`` starts at 0 and not at
        ``init_cache``'s -1e30 (C.14).  An MLA layer's pads sit at
        positions no real query sees."""
        sub = [{k: v[slot:slot + 1] for k, v in c.items()}
               for c in self.cache]
        for c in sub:
            for v in c.values():
                v.zero_()
            if "pos" in c:        # only attention caches hold positions
                c["pos"].fill_(EMPTY_SLOT)
        toks = torch.as_tensor(tokens, dtype=torch.long,
                               device=self.device)[None]
        lengths = torch.tensor([length], dtype=torch.int32,
                               device=self.device)
        with self._forward_ctx():
            return self.model.prefill_padded(toks, sub, lengths)[0, -1]

    @torch.no_grad()
    def _decode_all(self, last_tokens: np.ndarray) -> torch.Tensor:
        toks = torch.as_tensor(last_tokens, dtype=torch.long,
                               device=self.device)[:, None]
        with self._forward_ctx():
            return self.model.decode_step(toks, self.cache)[:, 0]

    @staticmethod
    def _to_host(logits: torch.Tensor) -> np.ndarray:
        return logits.float().cpu().numpy()

    def _apply_fault_hook(self, phase: str, logits: np.ndarray) -> np.ndarray:
        if self.fault_hook is None:
            return logits
        out = self.fault_hook(phase, logits)
        return logits if out is None else np.asarray(out)

    def _obs_kv_slots(self) -> int:
        """Cache positions a decode walk streams per sequence: the
        manifest's split-KV discriminant (the paged engine overrides it
        with its block-table capacity)."""
        return self.max_len

    # ------------------------------------------------------------------
    def _finish(self, req: Request, status: RequestStatus,
                error: Optional[str] = None) -> RequestStatus:
        """Move ``req`` to a terminal status and book it.  The single
        terminal funnel: ``req.finish`` enforces the exactly-once
        transition, so the obs span close here fires exactly once per
        request on every terminal path."""
        now = self._clock()
        req.finish(status, error, now=now)
        if self.tp is not None:
            self._finished.append((req.uid, status.value,
                                   tuple(req.generated)))
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
        return self._enqueue(req)

    def _enqueue(self, req: Request) -> RequestStatus:
        """Shared admission tail: capacity rejections are typed, not
        raised (see :meth:`submit`)."""
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
    def _expired(self, now: float) -> set[int]:
        """``id()`` of every pending request (active, then queued) whose
        deadline has passed at ``now``.  Under tensor parallelism rank
        0's clock decides: when a pending request carries a deadline (a
        fact every rank shares), rank 0's verdicts reach every rank in
        one counted broadcast, so all ranks expire the same requests at
        the same step."""
        pending = [r for r in self.slot_req if r is not None]
        pending += self.queue
        verdicts = [r.expired(now) for r in pending]
        if self.tp is not None and any(r.deadline_s is not None
                                       for r in pending):
            verdicts = self.tp.broadcast_flags(verdicts)
        return {id(r) for r, v in zip(pending, verdicts) if v}

    def _expire_and_admit(self) -> float:
        """The head of every step: time out the active requests whose
        deadline has passed, then fill free slots (queued requests found
        expired on the way time out too).  Returns the step's clock
        reading (the obs hooks' time)."""
        now = self._clock()
        expired = self._expired(now)
        for slot in self._active():
            req = self.slot_req[slot]
            if id(req) in expired:
                self._finish(req, RequestStatus.TIMED_OUT,
                             "deadline expired mid-decode")
                self._clear_slot(slot)
        self._admit(expired, now)
        return now

    def _admit(self, expired: set[int], now: float) -> None:
        """Fill free slots from the queue (prefill path)."""
        for slot in range(self.n_slots):
            while self.slot_req[slot] is None and self.queue:
                req = self.queue.popleft()
                if id(req) in expired:
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
                if self.obs is not None:
                    self.obs.on_admit(req, slot, now)
                logits = self._to_host(self._prefill_one(toks, slot, L))
                self.stats.prefills += 1
                if self.obs is not None:
                    # the ring prefill computes the bucket-padded prompt
                    self.obs.on_prefill(req, len(toks), len(toks), now)
                    self.obs.on_prefill_done(req, now)
                logits = self._apply_fault_hook("prefill", logits)
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
                    if self.obs is not None:
                        self.obs.on_first_token(req, req.first_token_at)
                if self.obs is not None:
                    self.obs.on_token(req, nxt, now)
                self.slot_req[slot] = req
                self.slot_pos[slot] = L
                self.slot_last[slot] = nxt

    def _active(self) -> list[int]:
        return [i for i, r in enumerate(self.slot_req) if r is not None]

    def _clear_slot(self, slot: int) -> None:
        """Free a slot after its request went terminal (the paged engine
        also releases the slot's KV blocks here)."""
        self.slot_req[slot] = None

    def step(self) -> None:
        """One engine iteration: expire + admit + one batched decode."""
        now = self._expire_and_admit()
        if self.obs is not None:
            self.obs.queue_depth.set(len(self.queue))
        active = self._active()
        if not active:
            return
        self.stats.batch_occupancy.append(len(active) / self.n_slots)
        logits = self._to_host(self._decode_all(self.slot_last))
        logits = self._apply_fault_hook("decode", logits)
        self.stats.decode_steps += 1
        if self.obs is not None:
            self.obs.on_decode_rows(
                [(self.slot_req[s], int(self.slot_pos[s]) + 1)
                 for s in active], now)
        for slot in active:
            req = self.slot_req[slot]
            if self.health_checks and not np.isfinite(logits[slot]).all():
                self._finish(req, RequestStatus.FAILED, "non-finite logits")
                self._clear_slot(slot)        # cache reset on next prefill
                continue
            tok = self._sample(req, logits[slot], len(req.generated))
            req.generated.append(tok)
            self.stats.tokens_out += 1
            if self.obs is not None:
                self.obs.on_token(req, tok, now)
            self.slot_last[slot] = tok
            self.slot_pos[slot] += 1
            if ((req.eos_id is not None and tok == req.eos_id)
                    or len(req.generated) >= req.max_new_tokens
                    or self.slot_pos[slot] >= self.max_len - 1):
                self._finish(req, RequestStatus.OK)
                self._clear_slot(slot)        # slot freed immediately

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
                break
            self.step()
        if self.pending():
            if on_stall == "raise":
                raise EngineStallError(
                    f"run_until_done hit max_iters={max_iters} with "
                    f"{len(self.queue)} queued and {len(self._active())} "
                    f"active request(s) still pending")
            self._expire_pending("engine stalled at max_iters")
        self._check_ranks_agree()

    def _check_ranks_agree(self) -> None:
        """Under tensor parallelism: raise unless every rank ended the
        same requests with the same status and tokens since the last
        check."""
        if self.tp is None:
            return
        digest = hashlib.sha256(repr(sorted(self._finished)).encode())
        self._finished.clear()
        if not self.tp.agree(digest.digest()):
            raise RuntimeError(f"tensor-parallel rank {self.tp.rank}: the "
                               f"ranks' requests ended differently")

    def _expire_pending(self, why: str) -> None:
        while self.queue:
            self._finish(self.queue.popleft(), RequestStatus.TIMED_OUT, why)
        for slot in self._active():
            self._finish(self.slot_req[slot], RequestStatus.TIMED_OUT, why)
            self._clear_slot(slot)

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
            self._clear_slot(slot)


class PagedServingEngine(ServingEngine):
    """Continuously batched engine over the paged (block-table) KV cache
    (port of ``repro/serving/engine.py::PagedServingEngine``).

    * **Paged KV storage** — slots hold per-sequence block tables into
      shared fixed-size block pools (:mod:`.paged_cache`); a sequence
      consumes blocks for its actual length, not a ``max_len`` ring, and
      freed blocks recirculate every step.
    * **Chunked prefill** — prompts stream through
      ``Model.prefill_padded(offset=...)`` one ``prefill_chunk``-token
      chunk per engine step, interleaved with decode for the running
      slots.
    * **Preemption** — when the pool runs dry, the youngest sequence is
      evicted (blocks freed, request requeued at the front) and later
      resumed by recomputing prompt + generated-so-far.
    * **Block-granular admission** — ``submit`` bounds prompts by the
      block table (``max_blocks * block_size`` positions, one kept for
      the first decode write).  Admission claims a slot, not blocks:
      blocks are allocated chunk by chunk and token by token.

    The host numpy tables are the source of truth; their device copy
    (one tensor that every layer's cache dict references) is refreshed
    before a forward whenever they changed.  Scheduling never changes a
    row's result: each row attends only to its own logical KV content.
    """

    def __init__(self, model, n_slots: int = 8, max_len: int = 512,
                 prefill_bucket: int = 64, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None, **kw):
        mixers = {m for m, _ in model.cfg.layer_specs()}
        if not mixers <= {"attn", "attn_local"}:
            # refused before the plan rewrites the model in place
            raise NotImplementedError(
                f"paged KV cache: unsupported mixer(s) "
                f"{sorted(mixers - {'attn', 'attn_local'})} (only "
                f"attention layers hold a position-keyed cache)")
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.prefill_chunk = (prefill_chunk if prefill_chunk is not None
                              else prefill_bucket)
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be positive")
        # slot -> [resume tokens (prompt + generated), next chunk offset]
        self.slot_fill: dict[int, list] = {}
        self._slot_seq = np.zeros(n_slots, np.int64)   # admission order
        self._admit_order = 0
        self._tables_dirty = True
        super().__init__(model, n_slots=n_slots, max_len=max_len,
                         prefill_bucket=prefill_bucket, **kw)

    # -- cache ---------------------------------------------------------
    def _init_cache(self) -> list:
        self.paged = PagedKVCache(self.model, self.n_slots, self.max_len,
                                  self.block_size,
                                  num_blocks=self.num_blocks,
                                  kv_dtype=self.kv_dtype)
        return self.paged.cache

    def _sync_tables(self) -> None:
        """Copy the host block tables to their device tensor if they
        changed since the last forward."""
        if self._tables_dirty:
            self.cache[0]["block_tables"].copy_(
                torch.from_numpy(self.paged.tables))
            self._tables_dirty = False

    @torch.no_grad()
    def _prefill_chunk(self, tokens: np.ndarray, slot: int, length: int,
                       offset: int) -> torch.Tensor:
        """Prefill one chunk of one request into slot ``slot``.

        Unlike the ring engine's ``_prefill_one`` nothing is zeroed: only
        the block table and the write index are sliced to the slot, the
        pools are shared, and a fresh slot's blocks are already clean
        (positions scrubbed to the empty sentinel on release).
        ``tokens`` is the padded chunk, ``length`` its valid length,
        ``offset`` the position of its first token; the write index
        resumes at ``offset + length``.  Returns the last valid token's
        logits [vocab]."""
        self._sync_tables()
        sub = [{k: (v[slot:slot + 1] if k in ("block_tables", "index")
                    else v) for k, v in c.items()} for c in self.cache]
        toks = torch.as_tensor(tokens, dtype=torch.long,
                               device=self.device)[None]
        lengths = torch.tensor([length], dtype=torch.int32,
                               device=self.device)
        off = torch.tensor([offset], dtype=torch.int32, device=self.device)
        with self._forward_ctx():
            return self.model.prefill_padded(toks, sub, lengths,
                                             offset=off)[0, -1]

    @torch.no_grad()
    def _decode_masked(self, last_tokens: np.ndarray,
                       mask: np.ndarray) -> torch.Tensor:
        """One decode step for every slot in ``mask``.

        The write index of every other slot (empty or mid-prefill) is set
        to the empty sentinel in place first: its KV writes are then
        invalid and leave the pools untouched, its logits are thrown
        away on the host, and its next prefill chunk restores its index.
        """
        self._sync_tables()
        keep = torch.as_tensor(mask, device=self.device)
        for c in self.cache:
            c["index"].masked_fill_(~keep, EMPTY_SLOT)
        toks = torch.as_tensor(last_tokens, dtype=torch.long,
                               device=self.device)[:, None]
        with self._forward_ctx():
            return self.model.decode_step(toks, self.cache)[:, 0]

    # -- admission -----------------------------------------------------
    def submit(self, req: Request) -> RequestStatus:
        """Queue a request; block-granular admission bounds: the prompt
        plus one decode position must fit in the slot's block table
        (``paged.capacity_tokens`` positions)."""
        L = len(req.prompt)
        if L == 0:
            self._finish(req, RequestStatus.REJECTED, "empty prompt")
            raise ValueError("empty prompt: requests must contain at "
                             "least one token")
        cap = self.paged.capacity_tokens
        if L + 1 > cap:
            self._finish(req, RequestStatus.REJECTED,
                         "prompt exceeds the slot's block table")
            raise ValueError(
                f"prompt of length {L} (+1 decode position) needs "
                f"{self.paged.allocator.blocks_for(L + 1)} blocks but the "
                f"block table holds {self.paged.max_blocks} x "
                f"{self.block_size}-token blocks ({cap} positions). "
                f"Raise max_len (table width) or block_size.")
        return self._enqueue(req)

    def _obs_kv_slots(self) -> int:
        return self.paged.capacity_tokens

    def _used_tokens(self) -> int:
        """KV positions written across all slots (a filling slot counts
        its chunk offset, a decoding slot its position)."""
        used = 0
        for slot in self._active():
            if slot in self.slot_fill:
                used += int(self.slot_fill[slot][1])
            else:
                used += int(self.slot_pos[slot])
        return used

    def _clear_slot(self, slot: int) -> None:
        """Free the slot and its blocks; the freed blocks' positions are
        reset to the empty sentinel in every layer, so a reallocated
        block never exposes its previous sequence."""
        freed = self.paged.release(slot)
        if freed:
            ids = torch.as_tensor(freed, dtype=torch.long,
                                  device=self.device)
            for c in self.cache:
                c["pos_pages"][ids] = EMPTY_SLOT
            self._tables_dirty = True
        self.slot_req[slot] = None
        self.slot_fill.pop(slot, None)

    def _admit(self, expired: set[int], now: float) -> None:
        """Assign queued requests to free slots (FIFO, no reordering).

        Admission only claims the slot and stages the resume tokens
        (prompt + any generated before a preemption); the cache writes
        happen in the chunked-prefill phase of :meth:`step`.  It stops,
        keeping FIFO order, as soon as the head request's first-token
        block demand exceeds the free pool.
        """
        for slot in range(self.n_slots):
            if self.slot_req[slot] is not None:
                continue
            while self.queue:
                req = self.queue[0]
                if id(req) in expired:
                    self.queue.popleft()
                    self._finish(req, RequestStatus.TIMED_OUT,
                                 "deadline expired while queued")
                    continue
                toks = np.asarray(req.prompt, np.int32)
                if req.generated:    # resume by recompute after preemption
                    toks = np.concatenate(
                        [toks, np.asarray(req.generated, np.int32)])
                if not self.paged.can_fit(len(toks) + 1):
                    return
                self.queue.popleft()
                req.status = RequestStatus.ACTIVE
                self.slot_req[slot] = req
                self.slot_fill[slot] = [toks, 0]
                self._slot_seq[slot] = self._admit_order
                self._admit_order += 1
                if self.obs is not None:
                    self.obs.on_admit(req, slot, now,
                                      resumed=bool(req.generated))
                break

    # -- block pressure ------------------------------------------------
    def _pick_victim(self, requester: int) -> Optional[int]:
        cands = [s for s in self._active()
                 if s != requester and self.paged.n_blocks_of[s] > 0]
        if not cands:
            return None
        return max(cands, key=lambda s: self._slot_seq[s])

    def _preempt(self, slot: int) -> None:
        """Evict ``slot`` to free its blocks; the request requeues at the
        front and resumes later by recomputing prompt + generated."""
        req = self.slot_req[slot]
        freed = int(self.paged.n_blocks_of[slot])
        self._clear_slot(slot)
        req.status = RequestStatus.QUEUED
        self.queue.appendleft(req)
        self.stats.preemptions += 1
        self.stats.evicted_blocks += freed
        if self.obs is not None:
            self.obs.on_preempt(req, slot, freed, self._clock())

    def _ensure(self, slot: int, n_tokens: int) -> bool:
        """Grow ``slot`` to cover ``n_tokens`` positions, preempting
        younger sequences under pool pressure.  Returns False when
        ``slot`` itself went terminal (pool exhausted with no victim
        left: the request fails rather than stalling the engine)."""
        while True:
            try:
                if self.paged.ensure(slot, n_tokens):
                    self._tables_dirty = True
                return True
            except PoolExhausted:
                self.stats.pool_exhaustions += 1
                if self.obs is not None:
                    self.obs.on_pool_exhausted(self.slot_req[slot], slot,
                                               self._clock())
                victim = self._pick_victim(slot)
                if victim is None:
                    self._finish(self.slot_req[slot], RequestStatus.FAILED,
                                 "KV block pool exhausted")
                    self._clear_slot(slot)
                    return False
                self._preempt(victim)

    def _maybe_finish(self, slot: int, req: Request, tok: int) -> None:
        if ((req.eos_id is not None and tok == req.eos_id)
                or len(req.generated) >= req.max_new_tokens
                or self.slot_pos[slot] >= self.paged.capacity_tokens - 1):
            self._finish(req, RequestStatus.OK)
            self._clear_slot(slot)

    # -- the engine loop -----------------------------------------------
    def step(self) -> None:
        """One engine iteration: expire + admit + one prefill chunk per
        filling slot + one batched decode for every running slot."""
        now = self._expire_and_admit()

        # chunked prefill: one chunk per filling slot
        C = self.prefill_chunk
        for slot in sorted(self.slot_fill):
            if slot not in self.slot_fill:       # preempted this step
                continue
            req = self.slot_req[slot]
            toks, off = self.slot_fill[slot]
            chunk = toks[off:off + C]
            valid = len(chunk)
            if valid < C:                        # pad by repeating
                chunk = np.concatenate(
                    [chunk, np.full(C - valid, chunk[-1])]).astype(np.int32)
            if not self._ensure(slot, off + valid):
                continue
            logits = self._to_host(self._prefill_chunk(chunk, slot, valid,
                                                       off))
            self.stats.prefill_chunks += 1
            if self.obs is not None:
                # the forward computes C padded query positions at
                # ``off``, attending the off + C cached positions
                self.obs.on_prefill(req, len(chunk), off + len(chunk),
                                    now, chunk=True, offset=off)
            off += valid
            if off < len(toks):
                self.slot_fill[slot][1] = off
                continue
            # final chunk: the request joins the decode batch
            self.stats.prefills += 1
            if self.obs is not None:
                self.obs.on_prefill_done(req, now)
            logits = self._apply_fault_hook("prefill", logits)
            if self.health_checks and not np.isfinite(logits).all():
                self.stats.prefill_failures += 1
                self._finish(req, RequestStatus.FAILED,
                             "non-finite prefill logits")
                self._clear_slot(slot)
                continue
            tok = self._sample(req, logits, len(req.generated))
            req.generated.append(tok)
            if self.obs is not None:
                self.obs.on_token(req, tok, now)
            if req.first_token_at is None:
                req.first_token_at = self._clock()
                if self.obs is not None:
                    self.obs.on_first_token(req, req.first_token_at)
            del self.slot_fill[slot]
            self.slot_pos[slot] = len(toks)
            self.slot_last[slot] = tok
            self._maybe_finish(slot, req, tok)

        # batched decode over every slot that is past prefill
        ok = []
        for slot in self._active():
            if slot in self.slot_fill or self.slot_req[slot] is None:
                continue
            if self._ensure(slot, int(self.slot_pos[slot]) + 1):
                ok.append(slot)
        ok = [s for s in ok if self.slot_req[s] is not None
              and s not in self.slot_fill]       # drop preempted victims
        if ok:
            self.stats.batch_occupancy.append(len(ok) / self.n_slots)
            mask = np.zeros(self.n_slots, bool)
            mask[ok] = True
            logits = self._to_host(self._decode_masked(self.slot_last, mask))
            logits = self._apply_fault_hook("decode", logits)
            self.stats.decode_steps += 1
            if self.obs is not None:
                self.obs.on_decode_rows(
                    [(self.slot_req[s], int(self.slot_pos[s]) + 1)
                     for s in ok], now)
            for slot in ok:
                req = self.slot_req[slot]
                if self.health_checks \
                        and not np.isfinite(logits[slot]).all():
                    self._finish(req, RequestStatus.FAILED,
                                 "non-finite logits")
                    self._clear_slot(slot)
                    continue
                tok = self._sample(req, logits[slot], len(req.generated))
                req.generated.append(tok)
                self.stats.tokens_out += 1
                if self.obs is not None:
                    self.obs.on_token(req, tok, now)
                self.slot_last[slot] = tok
                self.slot_pos[slot] += 1
                self._maybe_finish(slot, req, tok)
        self.stats.cache_utilization.append(self.paged.utilization())
        if self.obs is not None:
            self.obs.on_kv_state(
                self.paged.utilization(),
                self.paged.fragmentation(self._used_tokens()))
            self.obs.queue_depth.set(len(self.queue))
