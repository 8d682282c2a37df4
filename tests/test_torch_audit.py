"""The port's execution-contract auditor (``repro_torch.analysis``) on the
CPU.

* The manifest: ``block_sites``, ``model_sites``, ``dit_sites``,
  ``supports_full_plan`` and ``mlp_pipeline_dispatches`` equal the
  reference's for every registered config, at full and reduced width,
  sharded and unsharded, but for the combine a TP-2 rank adds on a ring
  cut by sequence (ROADMAP C, "The reference's manifest at TP"); the
  launches per layer pinned where the card's runs pin them (gemma-2b 7,
  qwen2-moe 9, 8192 slots 8, TP-2 7 on gemma-2b's sequence-cut ring, 6
  paged, 9 on qwen2-moe); the port's per-layer function classifies to
  ``block_sites`` except where the reference counts a combine that no
  code launches (ROADMAP C.15, and the paged pools, not cut by
  sequence).
* ``audit_lm`` on gemma-2b-smoke and qwen2-moe-smoke, prefill and
  decode, ring and paged, unsharded and at TP-2 (two gloo ranks, each
  auditing its step): clean, the launches (the wrappers' calls here)
  the manifest's per-layer counts.
* Mutations mirroring the reference's ``test_analysis.py``: a partial
  plan, an unknown kernel, an integer matmul outside the wrappers, an
  int32 partial read before its ``all_reduce``, a float SUM, an int8
  dequantized in a decode step — each flagged.
"""
from __future__ import annotations

from collections import Counter

import pytest
import torch

from repro.analysis import manifest as jman
from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import DIT_ARCH_IDS as JDIT_IDS
from repro.configs import get_config as jget
from repro.configs import get_dit_config as jget_dit
from repro.configs import reduced_config as jred
from repro.models import build_model

from repro_torch.analysis import (Recorder, audit_dit, audit_lm, classify,
                                  dispatch_audit, dtype_flow_audit,
                                  full_plan_archs, manifest, run_lm_step)
from repro_torch.analysis.passes import collective_audit
from repro_torch.configs import ARCH_IDS, DIT_ARCH_IDS, get_config
from repro_torch.configs import get_dit_config, reduced_config
from repro_torch.kernels import KERNELS, _launch, ops
from repro_torch.parallel.context import TPGroup
from repro_torch.quant import QuantPlan

KV_LENS = (0, 128, 2048, 2049, 8192)


def _configs(arch, reduced):
    jcfg, cfg = jget(arch), get_config(arch)
    return (jred(jcfg), reduced_config(cfg)) if reduced else (jcfg, cfg)


# ---------------------------------------------------------------------------
# the manifest against the reference's
# ---------------------------------------------------------------------------
def test_registries_agree():
    assert sorted(ARCH_IDS) == sorted(JARCH_IDS)
    assert sorted(DIT_ARCH_IDS) == sorted(JDIT_IDS)
    assert set(manifest.SITE_CLASSES) == set(jman.SITE_CLASSES)
    assert manifest.SPLITKV_THRESHOLD == jman.SPLITKV_THRESHOLD
    assert set(manifest.KERNEL_SITES.values()) == set(manifest.SITE_CLASSES)
    assert set(manifest.KERNEL_SITES) | manifest.UNCONTRACTED == \
        set(KERNELS)
    for name, fn in KERNELS.items():        # the recorder keys by name
        assert fn.__name__ == name


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_manifest_matches_reference(arch, reduced):
    jcfg, cfg = _configs(arch, reduced)
    jm = build_model(jcfg)
    assert manifest.supports_full_plan(cfg) == jman.supports_full_plan(jm)
    assert cfg.layer_groups() == [tuple(g) for g in jm.groups]
    if not manifest.supports_full_plan(cfg):
        with pytest.raises(ValueError, match="no full-plan contract"):
            manifest.step_launches(cfg, "decode")
        return
    for sharded in (False, True):
        for kv in KV_LENS:
            for phase in ("prefill", "decode"):
                extra = Counter()
                for spec, _ in cfg.layer_groups():
                    want = jman.block_sites(jcfg, spec, phase, sharded, kv)
                    # a TP-2 rank whose ring is cut by sequence walks it
                    # in splits and merges the ranks' partials: the
                    # reference's function counts one walk (ROADMAP C)
                    if (sharded and phase == "decode" and kv <= 2048
                            and manifest.seq_cut(cfg, spec[0], 2, kv)):
                        want["attn_combine"] += 1
                        extra["attn_combine"] += 1
                    assert manifest.block_sites(cfg, spec, phase, sharded,
                                                kv) == want
                assert manifest.model_sites(cfg, phase, sharded, kv) == \
                    jman.model_sites(jm, phase, sharded, kv) + extra


@pytest.mark.parametrize("arch", DIT_ARCH_IDS)
def test_dit_sites_match_reference(arch):
    cfg = get_dit_config(arch)
    assert manifest.dit_sites(cfg) == jman.dit_sites(jget_dit(arch))
    assert classify(manifest.dit_block_launches(cfg)) == \
        manifest.dit_sites(cfg)
    assert sum(manifest.dit_step_launches(cfg).values()) == \
        6 * cfg.n_layers
    with pytest.raises(ValueError):
        manifest.dit_sites(cfg, sharded=True)


def test_mlp_pipeline_dispatches_match_reference():
    for d_ff in (1, 255, 256, 257, 1408, 5632, 8191, 8192, 8193, 8320,
                 16384, 29568):
        for grouped in (False, True):
            assert manifest.mlp_pipeline_dispatches(d_ff, grouped) == \
                jman.mlp_pipeline_dispatches(d_ff, grouped)
            assert manifest.mlp_sites(d_ff, grouped) == \
                jman.mlp_sites(d_ff, grouped)
    for k in (1, 127, 2048, 4095, 4096, 4097, 8192, 12288):
        assert manifest.gemm_in_sites(k) == jman.gemm_in_sites(k)


def _per_layer(arch, phase="decode", **kw):
    cfg = get_config(arch)
    return sum(manifest.step_launches(cfg, phase, **kw).values()) \
        / cfg.n_layers


def test_launch_pins_at_full_width():
    assert _per_layer("gemma-2b", kv_len=1024) == 7
    assert _per_layer("gemma-2b", kv_len=1024, paged=True) == 7
    assert _per_layer("gemma-2b", kv_len=8192) == 8
    assert _per_layer("qwen2-moe-a2.7b", kv_len=1024) == 9
    assert _per_layer("qwen2-moe-a2.7b", "prefill") == 8
    # gemma-2b's MQA ring is cut by sequence at TP-2: kernels 9 and 10
    # in place of kernel 5 (the paged pools stay whole: kernel 11)
    assert _per_layer("gemma-2b", kv_len=1024, sharded=True, tp=2) == 7
    assert _per_layer("gemma-2b", kv_len=1024, sharded=True, tp=2,
                      paged=True) == 6
    assert _per_layer("qwen2-moe-a2.7b", kv_len=1024, sharded=True,
                      tp=2) == 9
    cfg = get_config("qwen2-moe-a2.7b")
    # the layers' and the vocabulary's: the lookup's SUM, the logits'
    # gather
    assert manifest.step_collectives(cfg) == Counter(
        max=2 * cfg.n_layers, sum=2 * cfg.n_layers + 1,
        gather=cfg.n_layers + 1)
    # gemma3-4b at 8192 slots: only its 5 global layers split
    g3 = get_config("gemma3-4b")
    got = manifest.step_launches(g3, "decode", kv_len=8192)
    assert got["decode_attention_combine"] == 5
    assert got["decode_attention"] == 29


@pytest.mark.parametrize("arch", full_plan_archs())
def test_layer_launches_classify_to_block_sites(arch):
    """What the port launches per layer is the reference's block profile,
    except the combine that ``block_sites`` adds to a sliding-window layer
    (a window-sized ring) and to a paged walk (which does not split)
    above 2048 slots (ROADMAP C.15)."""
    for reduced in (False, True):
        cfg = reduced_config(get_config(arch)) if reduced \
            else get_config(arch)
        for sharded, paged, kv, phase in (
                (s, p, k, ph) for s in (False, True) for p in (False, True)
                for k in (128, 1024, 2048, 4096, 8192)
                for ph in ("prefill", "decode")):
            for spec, _ in cfg.layer_groups():
                got = classify(manifest.layer_launches(
                    cfg, spec, phase, sharded=sharded, kv_len=kv,
                    paged=paged, tp=2))
                want = manifest.block_sites(cfg, spec, phase, sharded, kv)
                window = cfg.sliding_window if spec[0] == "attn_local" \
                    else None
                span = min(kv, window) if window else kv
                if phase == "decode" and kv > 2048 and (
                        paged or span <= 2048):
                    want["attn_combine"] -= 1       # C.15
                    want = +want
                elif (phase == "decode" and paged and sharded
                      and manifest.seq_cut(cfg, spec[0], 2, kv)):
                    # the paged pools are not cut by sequence
                    want["attn_combine"] -= 1
                    want = +want
                assert got == want, (cfg.name, spec, phase, sharded,
                                     paged, kv)


def test_c15_reference_manifest_over_counts_sliding_layers():
    """ROADMAP C.15, a fact of the reference: above 2048 slots its
    ``model_sites`` adds a combine to every layer group, while its own
    trace of gemma3-4b-smoke's decode step (sliding-window layers hold a
    window-sized ring) has one only on the global groups, and its paged
    decode step none; the port's manifest counts what the traces
    have."""
    from repro.analysis import auditor as jaud
    from repro.analysis import jaxpr_tools as jt
    jm = jaud._build("gemma3-4b", True)
    cfg = reduced_config(get_config("gemma3-4b"))
    n_global = sum(m == "attn" for m, _ in cfg.layer_specs())
    for kv in (1024, 4096):
        jaxpr, _ = jaud.trace_lm_step(jm, "decode", kv_len=kv)
        traced = sum(e.primitive.name == "pallas_call"
                     for e in jt.iter_eqns(jaxpr.jaxpr))
        ref = sum(jman.model_sites(jm, "decode", kv_len=kv).values())
        port = classify(manifest.step_launches(cfg, "decode", kv_len=kv))
        assert sum(port.values()) == traced      # one block a group here
        assert port["attn_combine"] == (n_global if kv > 2048 else 0)
        assert ref - traced == (cfg.n_layers - n_global if kv > 2048
                                else 0)
    # the paged walk never splits: one group of gemma-2b-smoke's layers
    jm = jaud._build("gemma-2b", True)
    cfg = reduced_config(get_config("gemma-2b"))
    (spec, _), = cfg.layer_groups()
    jaxpr, _ = jaud.trace_lm_step(jm, "decode", paged=True, kv_len=4096)
    traced = sum(e.primitive.name == "pallas_call"
                 for e in jt.iter_eqns(jaxpr.jaxpr))
    assert traced == sum(manifest.layer_launches(
        cfg, spec, "decode", kv_len=4096, paged=True).values())
    assert sum(jman.model_sites(jm, "decode", kv_len=4096).values()) == \
        traced + 1


def test_full_plan_archs():
    assert sorted(full_plan_archs()) == sorted(
        a for a in JARCH_IDS if jman.supports_full_plan(build_model(jget(a))))
    assert sorted(full_plan_archs()) == [
        "command-r-plus-104b", "deepseek-67b", "gemma-2b", "gemma3-4b",
        "musicgen-medium", "paligemma-3b", "qwen2-moe-a2.7b"]


# ---------------------------------------------------------------------------
# the audit on the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ["gemma-2b", "qwen2-moe-a2.7b"])
def test_audit_lm_clean_on_cpu(arch, phase, paged):
    rep = audit_lm(arch, phase, paged=paged, reduced=True, device="cpu")
    assert rep.ok, rep.diff_lines()
    cfg = reduced_config(get_config(arch))
    assert rep.launches == dict(manifest.step_launches(
        cfg, phase, kv_len=128, paged=paged))
    assert rep.actual == rep.expected == dict(classify(
        manifest.step_launches(cfg, phase, kv_len=128, paged=paged)))
    assert rep.to_dict()["ok"] and rep.n_dispatches > 0


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen2-moe-a2.7b"])
def test_audit_lm_tp_rank_clean_on_cpu(arch):
    rep = audit_lm(arch, "decode", tp=2, reduced=True, device="cpu")
    assert rep.ok and rep.sharded, rep.diff_lines()
    assert rep.actual["acc_gemm"] == 2 * reduced_config(
        get_config(arch)).n_layers


def test_audit_dit_and_skips_on_cpu():
    rep = audit_dit("dit-test", device="cpu")
    assert rep.ok, rep.diff_lines()
    assert rep.launches == dict(manifest.dit_step_launches(
        get_dit_config("dit-test")))
    for arch in ("zamba2-1.2b", "xlstm-350m", "deepseek-v3-671b"):
        rep = audit_lm(arch, reduced=True, device="cpu")
        assert rep.ok and rep.skipped
        assert rep.diff_lines()[0].startswith("SKIP")


# ---------------------------------------------------------------------------
# mutations: each breach is flagged
# ---------------------------------------------------------------------------
def _codes(violations):
    return {v.code for v in violations}


def test_partial_plan_flags_count_mismatch():
    from repro_torch.models import Model
    cfg = reduced_config(get_config("gemma-2b"))
    model = Model(cfg).init(0, device="cpu").quantize(QuantPlan(mlp=False))
    rec, _ = run_lm_step(model, "decode")
    want = manifest.step_launches(cfg, "decode", kv_len=128)
    found = dispatch_audit(rec.launches, classify(want), want)
    assert {"count_mismatch", "launch_mismatch"} <= _codes(found)
    assert any(v.site == "quantize" for v in found)


def test_unknown_kernel_flagged():
    found = dispatch_audit({"mystery_kernel": 2}, Counter())
    assert _codes(found) == {"unknown_kernel"}

    def mystery_kernel(x):              # a wrapper outside KERNELS
        _launch.on_cpu(x)
        return x + 1
    with Recorder() as rec:
        mystery_kernel(torch.ones(2))
    assert rec.record.launches == Counter(mystery_kernel=1)
    assert "unknown_kernel" in _codes(dispatch_audit(rec.record.launches,
                                                     Counter()))


def test_integer_matmul_outside_wrappers_flagged():
    x = torch.randint(-127, 128, (4, 16), dtype=torch.int8)
    w = torch.randint(-127, 128, (16, 8), dtype=torch.int8)
    with Recorder() as rec:
        torch.matmul(x.to(torch.int32), w.to(torch.int32))
        ops.cim_int8_gemm_acc(x, w)       # inside the wrapper: fine
    found = dtype_flow_audit(rec.record.ops, phase="prefill")
    assert _codes(found) >= {"int8_matmul"}
    assert sum(v.code == "int8_matmul" for v in found) == 1
    assert "test_torch_audit.py" in next(
        v.site for v in found if v.code == "int8_matmul")


def test_dequant_outside_wrappers_flagged_in_decode_only():
    w = torch.randint(-127, 128, (16, 8), dtype=torch.int8)
    with Recorder() as rec:
        w.float() * 0.5
    assert "dequant_leak" in _codes(dtype_flow_audit(rec.record.ops))
    assert not dtype_flow_audit(rec.record.ops, phase="prefill")
    assert "kv_not_int8" in _codes(dtype_flow_audit(
        [], kv_dtypes=[("layer_0/k", torch.bfloat16)]))


def test_int32_partial_read_before_all_reduce_flagged():
    x = torch.randint(-127, 128, (4, 16), dtype=torch.int8)
    w = torch.randint(-127, 128, (16, 8), dtype=torch.int8)
    group = TPGroup()
    with Recorder(group) as bad:
        acc = ops.cim_int8_gemm_acc(x, w)
        early = acc.float()               # read before the sum
        group.all_reduce_sum(acc)
    with Recorder(group) as good:
        acc = group.all_reduce_sum(ops.cim_int8_gemm_acc(x, w))
        acc.float()
    assert "int32_escape" in _codes(dtype_flow_audit(bad.record.ops))
    assert not dtype_flow_audit(good.record.ops)
    assert group.observer is None and early.dtype == torch.float32


def test_collective_breaches_flagged():
    group = TPGroup()
    with Recorder(group) as rec:
        group.all_reduce_sum(torch.ones(3))          # a float sum
        group.all_reduce_max(torch.ones(3))
    found = collective_audit(rec.record.ops, sharded=True,
                             expected=Counter(sum=1, max=2))
    assert _codes(found) == {"sum_not_int", "count_mismatch"}
    assert _codes(collective_audit(rec.record.ops, sharded=False)) == \
        {"unexpected_collective"}


def test_recorder_restores_hooks_and_refuses_nesting():
    with Recorder():
        with pytest.raises(RuntimeError, match="already active"):
            Recorder().__enter__()
    assert _launch.observer is None
