"""Run model steps once and audit them against the manifest (port of
``repro/analysis/auditor.py``).

The reference traces a step abstractly and reads the jaxpr; the port
runs one step of a real model under a :class:`~.record.Recorder` —
on the card (the default) or on the CPU when asked — and holds what it
launched, and the aten ops around the launches, against the manifest.
Every entry point returns an :class:`AuditReport`; nothing here raises
on a contract violation (callers decide severity), only on misuse
(unknown arch or phase).
"""
from __future__ import annotations

import dataclasses

import torch

from . import manifest, passes
from .record import Recorder

_SEED = 0
_BLOCK = 16        # slots of a paged block, as the served engines use


@dataclasses.dataclass
class AuditReport:
    target: str                 # arch id
    phase: str        # prefill[_paged] | decode_ring | decode_paged | step
    sharded: bool
    expected: dict              # site class -> count (manifest)
    actual: dict                # site class -> count (launched)
    violations: list
    skipped: str | None = None  # reason, when the target has no contract
    launches: dict = dataclasses.field(default_factory=dict)  # by counter

    @property
    def ok(self) -> bool:
        return not self.violations

    @property
    def n_dispatches(self) -> int:
        return sum(self.actual.values())

    def to_dict(self) -> dict:
        return {
            "target": self.target, "phase": self.phase,
            "sharded": self.sharded, "ok": self.ok,
            "skipped": self.skipped,
            "dispatches": self.n_dispatches,
            "expected": dict(self.expected), "actual": dict(self.actual),
            "launches": dict(self.launches),
            "violations": [v.to_dict() for v in self.violations],
        }

    def diff_lines(self) -> list:
        """Human-readable diff vs the manifest, one finding per line."""
        tag = f"{self.target}/{self.phase}" + ("/tp" if self.sharded
                                               else "")
        if self.skipped:
            return [f"SKIP {tag}: {self.skipped}"]
        if self.ok:
            return [f"ok   {tag}: {self.n_dispatches} launches "
                    f"{dict(sorted(self.actual.items()))}"]
        lines = [f"FAIL {tag}:"]
        for cls in sorted(set(self.expected) | set(self.actual)):
            e, a = self.expected.get(cls, 0), self.actual.get(cls, 0)
            if e != a:
                lines.append(f"       {cls}: manifest {e} != launched {a}")
        for v in self.violations:
            if v.code != "count_mismatch":
                lines.append(f"       [{v.pass_name}/{v.code}] "
                             f"{v.site}: {v.message}")
        return lines


# ---------------------------------------------------------------------------
# Building and stepping a model
# ---------------------------------------------------------------------------
def _config(arch: str, reduced: bool):
    from repro_torch.configs import get_config, reduced_config
    cfg = get_config(arch)
    return reduced_config(cfg) if reduced else cfg


def _inputs(cfg, batch: int, steps: int, gen: torch.Generator,
            device) -> tuple:
    """(tokens, keyword inputs) of ``steps`` positions per row: an audio
    config takes frame embeddings instead of tokens."""
    if cfg.frontend == "audio":
        return None, {"frame_embeddings": torch.randn(
            (batch, steps, cfg.d_model), generator=gen, device=device)}
    return torch.randint(0, cfg.vocab, (batch, steps), generator=gen,
                         device=device), {}


def _caches(model, paged: bool, batch: int, kv_len: int):
    """int8 ring caches of ``kv_len`` slots, or paged pools holding
    ``kv_len // _BLOCK`` blocks for each row (block 0 the null block),
    rows' tables filled in order."""
    if not paged:
        return model.init_cache(batch, kv_len, kv_dtype="int8")
    nb = kv_len // _BLOCK
    caches = model.init_paged_cache(batch, batch * nb + 1, _BLOCK, nb,
                                    kv_dtype="int8")
    caches[0]["block_tables"].copy_(
        torch.arange(1, batch * nb + 1, dtype=torch.int32).reshape(batch,
                                                                   nb))
    return caches


def _kv_dtypes(caches) -> list:
    return [(f"layer_{i}/{k}", c[k].dtype) for i, c in enumerate(caches)
            for k in ("k", "v", "k_pages", "v_pages") if k in c]


@torch.no_grad()
def run_lm_step(model, phase: str, paged: bool = False, batch: int = 2,
                kv_len: int = 128, prompt_len: int = 32, group=None):
    """Run one full-plan step of ``model`` (quantized, and sharded for
    ``group``, a ``TPGroup``) under a recorder: a prefill of
    ``prompt_len`` tokens per row, or one decode step after such a
    prefill (not recorded).  Returns ``(record, caches)``."""
    from repro_torch.parallel.context import tp_context
    if phase not in ("prefill", "decode"):
        raise ValueError(f"unknown LM phase {phase!r}")
    gen = torch.Generator(device=model.device).manual_seed(_SEED)
    caches = _caches(model, paged, batch, kv_len)
    lengths = torch.full((batch,), prompt_len, dtype=torch.int32,
                         device=model.device)
    toks, kw = _inputs(model.cfg, batch, prompt_len, gen, model.device)
    with tp_context(group):
        if phase == "prefill":
            with Recorder(group) as rec:
                model.prefill_padded(toks, caches, lengths, **kw)
        else:
            model.prefill_padded(toks, caches, lengths, **kw)
            toks, kw = _inputs(model.cfg, batch, 1, gen, model.device)
            with Recorder(group) as rec:
                model.decode_step(toks, caches, **kw)
    return rec.record, caches


# ---------------------------------------------------------------------------
# Audit entry points
# ---------------------------------------------------------------------------
def audit_lm(arch: str, phase: str = "decode", paged: bool = False,
             tp: int = 1, kv_len: int = 128, reduced: bool = False,
             batch: int = 2, device=None, model=None) -> AuditReport:
    """Audit one arch x phase x layout cell: run one full-plan step with
    the launch counters read around it, hold its launches against the
    manifest's whole step (:func:`manifest.step_launches`: each layer its
    own launches) by counter and by site class, then run the dtype-flow
    and collective passes over the step's ops.

    The model of ``arch`` (its reduced config if asked) is drawn from a
    seed on ``device`` (default: the card) under the full plan; an
    unsharded audit can pass ``model``, one already drawn and quantized,
    instead.  ``tp > 1`` audits a tensor-parallel rank: one in-process
    rank of a trivial group (a ``TPGroup`` of size 1, whose collectives
    return their input and still count — a rank's launches and
    collectives do not depend on the group's size)."""
    from repro_torch.models import Model
    from repro_torch.parallel.context import TPGroup
    from repro_torch.parallel.sharding import shard_model
    from repro_torch.quant import QuantPlan
    if phase not in ("prefill", "decode"):
        raise ValueError(f"unknown LM phase {phase!r}")
    label = ("decode_paged" if paged else "decode_ring") \
        if phase == "decode" else ("prefill_paged" if paged else "prefill")
    sharded = tp > 1
    if sharded and model is not None:
        raise ValueError("a tensor-parallel audit draws its own model")
    cfg = model.cfg if model is not None else _config(arch, reduced)
    if not manifest.supports_full_plan(cfg):
        return AuditReport(arch, label, sharded, {}, {}, [],
                           skipped="no full-plan contract for this "
                                   "arch's mixers yet (ROADMAP A.3)")
    group = TPGroup() if sharded else None
    if model is None:
        model = Model(cfg).init(_SEED, device=device)
        model.quantize(QuantPlan.full())
        if sharded:
            shard_model(model, group)
    record, caches = run_lm_step(model, phase, paged=paged, batch=batch,
                                 kv_len=kv_len, group=group)
    want = manifest.step_launches(cfg, phase, sharded=sharded,
                                  kv_len=kv_len, paged=paged, tp=tp,
                                  block_size=_BLOCK)
    expected = passes.classify(want)
    violations = passes.dispatch_audit(record.launches, expected, want)
    violations += passes.dtype_flow_audit(record.ops, phase=phase,
                                          kv_dtypes=_kv_dtypes(caches))
    violations += passes.collective_audit(
        record.ops, sharded=sharded,
        expected=manifest.step_collectives(cfg) if sharded else None)
    return AuditReport(arch, label, sharded, dict(expected),
                       dict(passes.classify(record.launches)), violations,
                       launches=dict(record.launches))


@torch.no_grad()
def audit_dit(arch: str = "dit-xl-2", batch: int = 2,
              device=None) -> AuditReport:
    """Audit one DiT evaluation (the whole forward: every block) under
    the full plan: plan launches by site class against
    ``manifest.dit_sites`` times the depth, and by counter; kernel 12's
    launch on the card is outside the contract (``manifest.UNCONTRACTED``).
    ``dit-test`` is the registry's reduced config."""
    from repro_torch.configs import get_dit_config
    from repro_torch.models.dit import DiTModel
    from repro_torch.quant import QuantPlan
    model = DiTModel(get_dit_config(arch)).init(_SEED, device=device)
    model.quantize(QuantPlan.full())
    cfg = model.cfg
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(_SEED)
    hw = cfg.input_size
    x = torch.randn((batch, cfg.in_channels, hw, hw), generator=gen,
                    device=dev)
    t = torch.randint(0, 1000, (batch,), generator=gen, device=dev,
                      dtype=torch.int32)
    y = torch.randint(0, cfg.n_classes, (batch,), generator=gen, device=dev,
                      dtype=torch.int32)
    with Recorder() as rec:
        model(x, t, y)
    want = manifest.dit_step_launches(cfg)
    expected = passes.classify(want)
    violations = passes.dispatch_audit(rec.record.launches, expected, want)
    violations += passes.dtype_flow_audit(rec.record.ops, phase="step")
    violations += passes.collective_audit(rec.record.ops, sharded=False)
    return AuditReport(arch, "step", False, dict(expected),
                       dict(passes.classify(rec.record.launches)),
                       violations, launches=dict(rec.record.launches))


def full_plan_archs() -> list:
    """Every registered LM arch whose layer groups all have a contract
    entry (the audit matrix's rows)."""
    from repro_torch.configs import ARCH_IDS, get_config
    return [arch for arch in ARCH_IDS
            if manifest.supports_full_plan(get_config(arch))]


__all__ = ["AuditReport", "audit_dit", "audit_lm", "full_plan_archs",
           "run_lm_step"]

