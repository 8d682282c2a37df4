"""Shared request lifecycle for both serving engines.

Every request — LLM token generation (``serving.engine.Request``) and
image generation (``diffusion.engine.ImageRequest``) — moves through one
state machine:

    QUEUED --admit--> ACTIVE --finish--> OK
       |                 |------------> FAILED     (non-finite outputs,
       |                 |                          shutdown in flight)
       |                 '------------> TIMED_OUT  (deadline expired)
       |---------------> TIMED_OUT                 (expired while queued)
       '---------------> REJECTED                  (backpressure/closed/
                                                    invalid — terminal
                                                    without ever queuing)

The four right-hand states are *terminal*: a request reaches exactly one
of them, exactly once (``LifecycleMixin.finish`` enforces single
assignment), and the engines' chaos-harness invariant is that every
submitted request terminates — no request is ever left QUEUED/ACTIVE
after ``run_until_done``/``drain`` returns.

``done`` is kept as a derived property for back-compatibility with the
pre-reliability engines' bare ``done`` flag (callers polled
``req.done``); it is simply ``status in TERMINAL_STATUSES``.
"""
from __future__ import annotations

import enum


class RequestStatus(enum.Enum):
    QUEUED = "queued"        # accepted, waiting for a slot/batch
    ACTIVE = "active"        # holds a decode slot / in a denoise batch
    OK = "ok"                # completed normally
    FAILED = "failed"        # health check tripped (e.g. non-finite
    #                          logits/latents) or shutdown in flight
    REJECTED = "rejected"    # never admitted: queue full, engine closed,
    #                          or invalid request
    TIMED_OUT = "timed_out"  # per-request deadline expired (queued or
    #                          active) or engine stall surfaced


TERMINAL_STATUSES = frozenset(
    {RequestStatus.OK, RequestStatus.FAILED, RequestStatus.REJECTED,
     RequestStatus.TIMED_OUT})


class EngineStallError(RuntimeError):
    """``run_until_done`` hit its iteration budget with requests still
    queued or active.  Raised instead of silently returning so a stalled
    engine (slot-accounting bug, undrainable queue) is never mistaken
    for a completed one."""


class LifecycleMixin:
    """Status plumbing shared by ``Request`` and ``ImageRequest``.

    Deliberately NOT a dataclass: the concrete request dataclasses
    declare the ``status`` / ``error`` / ``deadline_s`` / ``submitted_at``
    fields themselves (dataclass field-ordering rules make an inherited
    defaulted field awkward); this mixin only adds behavior on top.
    """

    def finish(self, status: RequestStatus, error: str | None = None,
               now: float | None = None) -> None:
        """Move to a terminal status — exactly once.  ``now`` (engine
        clock) stamps ``finished_at``, the span-close time the obs layer
        and the serving benchmarks read latencies from."""
        if status not in TERMINAL_STATUSES:
            raise ValueError(f"finish() requires a terminal status, "
                             f"got {status}")
        if self.status in TERMINAL_STATUSES:
            raise RuntimeError(
                f"request already terminal ({self.status.value}); "
                f"refusing to overwrite with {status.value}")
        self.status = status
        if error is not None:
            self.error = error
        if now is not None:
            self.finished_at = now

    def expired(self, now: float) -> bool:
        """True when a per-request deadline has passed (``deadline_s`` is
        seconds of engine-clock time from submission)."""
        return (self.deadline_s is not None
                and now - self.submitted_at >= self.deadline_s)

    @property
    def done(self) -> bool:
        """Back-compat with the pre-lifecycle bare ``done`` flag."""
        return self.status in TERMINAL_STATUSES

    @property
    def ok(self) -> bool:
        return self.status is RequestStatus.OK
