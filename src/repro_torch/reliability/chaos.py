"""Deterministic chaos harness for the serving engines (port of
``repro/reliability/chaos.py``).

A :class:`ChaosMonkey` attaches to a live engine and, fully seeded,

* periodically re-injects CIM weight-memory faults (faults.py) into the
  engine's model mid-serve, written into the resident int8 buffers in
  place (no buffer is reallocated), exactly how resident weights rot
  under a running server; and
* occasionally corrupts fetched logits with a NaN through the engine's
  ``fault_hook`` — the trigger for the non-finite health-check path.

:func:`chaos_soak` is the shared soak loop: submit a workload, unleash
the monkey at a swept bit-error rate, and audit the engine invariants —
every request terminal, slots freed, token conservation, monotone stats,
no hangs.  Everything is replayable bit for bit from the seeds, and the
draws are the reference's on the same fetches.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.serving.lifecycle import TERMINAL_STATUSES, RequestStatus
from .faults import (FaultConfig, inject_tree, load_leaves, protect_tree,
                     quantized_leaves)


@dataclass
class ChaosReport:
    weight_injections: int = 0   # weight fault campaigns applied
    bits_faulted: int = 0        # total bits/cells hit across campaigns
    logit_hits: int = 0          # NaNs planted in fetched logits


class ChaosMonkey:
    """Seeded mid-serve fault injector; installs itself as the engine's
    ``fault_hook`` so injections are clocked by engine activity.

    * ``fault.ber > 0``: every ``period`` fetches, a fresh fault
      campaign (seed advanced deterministically) is injected into the
      engine's model from the pristine host snapshot of its quantized
      leaves taken at attach time (:func:`quantized_leaves`) and written
      in place (:func:`load_leaves`) — faults move around rather than
      only accumulate, like scrubbing-less retention upsets.
      ``protect_fraction`` applies the outlier-channel guard after each
      campaign.
    * ``logit_nan_rate``: per fetch, with this probability one fetched
      logit row gets a NaN planted (exercises the health-check ->
      FAILED path end to end).
    """

    def __init__(self, engine, fault: FaultConfig,
                 period: int = 4, logit_nan_rate: float = 0.0,
                 protect_fraction: float = 0.0):
        self.engine = engine
        self.fault = fault
        self.period = max(1, period)
        self.logit_nan_rate = logit_nan_rate
        self.protect_fraction = protect_fraction
        self.report = ChaosReport()
        # the pristine weights: only a campaign needs (and writes) them
        self._clean = (quantized_leaves(engine.model) if fault.ber > 0.0
                       else None)
        self._rng = np.random.default_rng((fault.seed, 0xC4A05))
        self._fetches = 0
        self._prev_hook = engine.fault_hook
        engine.fault_hook = self._hook

    # ------------------------------------------------------------------
    def _obs_chaos(self, kind: str, **detail) -> None:
        obs = getattr(self.engine, "obs", None)
        if obs is not None:
            obs.on_chaos(kind, self.engine._clock(), **detail)

    def _hook(self, phase: str, logits: np.ndarray):
        self._fetches += 1
        if self.fault.ber > 0.0 and self._fetches % self.period == 0:
            campaign = dataclasses.replace(
                self.fault, seed=self.fault.seed + self._fetches)
            leaves, rep = inject_tree(self._clean, campaign)
            if self.protect_fraction > 0.0:
                leaves = protect_tree(self._clean, leaves,
                                      self.protect_fraction,
                                      getattr(self.engine, "tp", None))
            load_leaves(self.engine.model, leaves)  # same buffers
            self.report.weight_injections += 1
            self.report.bits_faulted += rep.faults
            self._obs_chaos("weight_injection", bits=rep.faults)
        if (self.logit_nan_rate > 0.0
                and self._rng.random() < self.logit_nan_rate):
            logits = np.array(logits, copy=True)
            flat = logits.reshape(-1, logits.shape[-1])
            row = int(self._rng.integers(flat.shape[0]))
            flat[row, int(self._rng.integers(flat.shape[1]))] = np.nan
            self.report.logit_hits += 1
            self._obs_chaos("logit_nan", phase=phase, row=row)
            return logits
        return None

    def detach(self, restore_params: bool = True) -> None:
        """Remove the hook and (by default) restore the pristine weights
        bit for bit."""
        self.engine.fault_hook = self._prev_hook
        if restore_params and self.report.weight_injections:
            load_leaves(self.engine.model, self._clean)


# ---------------------------------------------------------------------------
# Engine invariant audits (shared by tests and the chip smoke run)
# ---------------------------------------------------------------------------
def engine_invariant_violations(engine, requests,
                                baseline=None) -> list[str]:
    """Audit a (possibly mid-serve) LLM engine; [] means healthy.

    * slot accounting: every occupied slot holds an ACTIVE request with
      ``slot_pos == prompt_len + len(generated) - 1`` and ``slot_last``
      equal to its newest token; terminal requests hold no slot;
    * token conservation: every generated token is accounted for by
      exactly one successful prefill (the first token) or one counted
      decode sample — ``sum(len(generated)) ==
      (prefills - prefill_failures) + tokens_out``;
    * status bookkeeping: per-terminal-status stats counters match the
      actual request statuses.

    ``requests`` must be every request the engine has served since its
    stats were at ``baseline`` (an ``EngineStats`` snapshot; None means
    a fresh engine) — the counter checks run on deltas so one engine
    can be audited soak after soak.
    """
    errs: list[str] = []

    def delta(name):
        base = getattr(baseline, name) if baseline is not None else 0
        return getattr(engine.stats, name) - base
    live = {id(r) for r in requests}
    for slot, req in enumerate(engine.slot_req):
        if req is None:
            continue
        if req.status is not RequestStatus.ACTIVE:
            errs.append(f"slot {slot}: occupied by a "
                        f"{req.status.value} request")
        if not req.generated:
            errs.append(f"slot {slot}: active request with no tokens")
            continue
        expect = len(req.prompt) + len(req.generated) - 1
        if int(engine.slot_pos[slot]) != expect:
            errs.append(f"slot {slot}: slot_pos={int(engine.slot_pos[slot])}"
                        f" != prompt+generated-1={expect}")
        if int(engine.slot_last[slot]) != req.generated[-1]:
            errs.append(f"slot {slot}: slot_last != newest token")
        if id(req) not in live:
            errs.append(f"slot {slot}: holds an unknown request")
    produced = sum(len(r.generated) for r in requests)
    budget = (delta("prefills") - delta("prefill_failures")
              + delta("tokens_out"))
    if produced != budget:
        errs.append(f"token conservation: generated={produced} != "
                    f"(prefills-prefill_failures)+tokens_out={budget}")
    by_status = {st: sum(1 for r in requests if r.status is st)
                 for st in RequestStatus}
    for name, st in (("completed", RequestStatus.OK),
                     ("failed", RequestStatus.FAILED),
                     ("rejected", RequestStatus.REJECTED),
                     ("timed_out", RequestStatus.TIMED_OUT)):
        if delta(name) != by_status[st]:
            errs.append(f"stats.{name}(delta)={delta(name)} != "
                        f"{by_status[st]} requests with status {st.value}")
    return errs


def assert_all_terminal(requests) -> None:
    stuck = [r for r in requests if r.status not in TERMINAL_STATUSES]
    if stuck:
        raise AssertionError(
            f"{len(stuck)} request(s) never reached a terminal status: "
            + ", ".join(f"uid={r.uid}:{r.status.value}" for r in stuck))


# ---------------------------------------------------------------------------
# The soak loop
# ---------------------------------------------------------------------------
@dataclass
class SoakResult:
    ber: float
    statuses: dict = field(default_factory=dict)   # status value -> count
    chaos: Optional[ChaosReport] = None
    violations: list = field(default_factory=list)
    decode_steps: int = 0

    @property
    def healthy(self) -> bool:
        return not self.violations


def chaos_soak(engine, requests, ber: float, seed: int = 0,
               kind: str = "bit_flip", period: int = 3,
               logit_nan_rate: float = 0.0, protect_fraction: float = 0.0,
               max_iters: int = 2_000) -> SoakResult:
    """Submit ``requests``, serve them under seeded mid-serve faults at
    bit-error rate ``ber``, and audit the engine invariants.

    The engine must terminate on its own (deadlines + bounded
    generations); a stall raises ``EngineStallError`` — a soak never
    ends with silent pending work.  Detaches the monkey and restores
    the pristine weights before returning, so one engine can sweep
    BERs.
    """
    baseline = dataclasses.replace(engine.stats)
    steps0 = engine.stats.decode_steps
    for r in requests:
        engine.submit(r)
    monkey = ChaosMonkey(engine, FaultConfig(kind=kind, ber=ber, seed=seed),
                         period=period, logit_nan_rate=logit_nan_rate,
                         protect_fraction=protect_fraction)
    try:
        engine.run_until_done(max_iters=max_iters)
    finally:
        monkey.detach()
    assert_all_terminal(requests)
    result = SoakResult(
        ber=ber,
        statuses={st.value: sum(1 for r in requests if r.status is st)
                  for st in RequestStatus
                  if any(r.status is st for r in requests)},
        chaos=monkey.report,
        violations=engine_invariant_violations(engine, requests,
                                               baseline=baseline),
        decode_steps=engine.stats.decode_steps - steps0)
    return result
