"""Per-request tracing: structured event log + request span records (a
copy of ``repro/obs/tracing.py``).

Every request served by an instrumented engine leaves two artifacts:

  * a stream of **events** in the engine-global :class:`EventLog` —
    plain dicts ``{"ts": <engine-clock>, "event": <name>, "uid": ...,
    ...}`` in emission order.  Timestamps come from the engine's
    injectable clock, so a step-clocked test or traffic harness gets a
    fully deterministic log (two seeded runs produce identical logs,
    pinned in tests/test_torch_obs.py);
  * a :class:`RequestTrace` — the request's span summary (queue-wait,
    prefill, decode, preemptions) plus its attributed tokens, modeled
    MACs, and joules by component.

The span-close contract: every request that enters the system emits
exactly one ``request_end`` event, on whichever terminal
:class:`~repro_torch.serving.lifecycle.RequestStatus` path it takes (finish,
deadline, stall-timeout, preempt-resume, chaos-failed slot, typed
rejection).  ``RequestTrace.close`` enforces single closure the same
way ``LifecycleMixin.finish`` enforces single terminal assignment.

Event names (the schema):

=================  ======================================================
event              fields beyond ``ts``/``uid``
=================  ======================================================
submit             queue_depth
admit              slot, resumed (preemption-resume re-admissions)
prefill            q_len, kv_len, chunk (bool), offset
first_token        ttft_steps
decode             kv_len (one per request per batched decode step)
token              token, n (1-based index into the generation)
preempt            slot, freed_blocks
pool_exhausted     slot
chaos              kind (weight_injection / logit_nan), detail fields
denoise_batch      evals, batch (diffusion engine)
request_end        status, error, tokens, joules, span close — exactly
                   once per request
=================  ======================================================
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional


class EventLog:
    """Append-only structured event stream (host-side dicts)."""

    def __init__(self, max_events: Optional[int] = None):
        self.events: list[dict] = []
        self.max_events = max_events
        self.dropped = 0

    def emit(self, event: str, ts: float, **fields) -> dict:
        # hot path (one call per decode row / token): reuse the kwargs
        # dict as the record instead of merging into a fresh one
        fields["ts"] = float(ts)
        fields["event"] = event
        if self.max_events is not None \
                and len(self.events) >= self.max_events:
            self.dropped += 1          # bounded log: drop, never grow
            return fields
        self.events.append(fields)
        return fields

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    def select(self, event: str, uid: Optional[int] = None) -> list:
        return [e for e in self.events if e["event"] == event
                and (uid is None or e.get("uid") == uid)]

    def to_jsonl(self) -> str:
        return "\n".join(json.dumps(e, sort_keys=True)
                         for e in self.events)

    def clear(self) -> None:
        self.events.clear()
        self.dropped = 0


@dataclass
class RequestTrace:
    """Span summary for one request (LLM token request or DiT image)."""

    uid: int
    submitted_at: float = 0.0
    admitted_at: Optional[float] = None    # first slot/batch admission
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    status: Optional[str] = None
    error: Optional[str] = None
    tokens: int = 0
    prefill_chunks: int = 0
    decode_steps: int = 0
    preemptions: int = 0
    # modeled attribution (core/energy.py pricing of this request's rows:
    # the paper's CIM-TPU model, not the card's energy)
    macs: float = 0.0
    mxu_j: float = 0.0
    vpu_j: float = 0.0
    memory_j: float = 0.0
    closed: bool = field(default=False, repr=False)

    @property
    def joules(self) -> float:
        return self.mxu_j + self.vpu_j + self.memory_j

    @property
    def queue_wait(self) -> Optional[float]:
        if self.admitted_at is None:
            return None
        return self.admitted_at - self.submitted_at

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    @property
    def itl(self) -> Optional[float]:
        """Mean inter-token latency over the decode span."""
        if (self.first_token_at is None or self.finished_at is None
                or self.tokens < 2):
            return None
        return (self.finished_at - self.first_token_at) / (self.tokens - 1)

    def add_energy(self, mxu_j: float, vpu_j: float, memory_j: float,
                   macs: float) -> None:
        self.mxu_j += mxu_j
        self.vpu_j += vpu_j
        self.memory_j += memory_j
        self.macs += macs

    def close(self, status: str, error: Optional[str], now: float) -> None:
        """Single-closure guard — the tracing mirror of
        ``LifecycleMixin.finish``."""
        if self.closed:
            raise RuntimeError(
                f"request {self.uid}: span already closed "
                f"({self.status}); refusing second close ({status})")
        self.closed = True
        self.status = status
        self.error = error
        self.finished_at = now

    def summary(self) -> dict:
        """JSON-able per-request record for snapshots/reports."""
        return {
            "uid": self.uid,
            "status": self.status,
            "error": self.error,
            "submitted_at": self.submitted_at,
            "queue_wait": self.queue_wait,
            "ttft": self.ttft,
            "itl": self.itl,
            "finished_at": self.finished_at,
            "tokens": self.tokens,
            "prefill_chunks": self.prefill_chunks,
            "decode_steps": self.decode_steps,
            "preemptions": self.preemptions,
            "macs": self.macs,
            "joules": self.joules,
            "mxu_j": self.mxu_j,
            "vpu_j": self.vpu_j,
            "memory_j": self.memory_j,
        }
