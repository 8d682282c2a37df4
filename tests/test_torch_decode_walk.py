"""The flash-decode walks' launch plan (``repro_torch.kernels.
decode_attention.walk_plan``), on the CPU: no card is needed to check it.

The plan picks, for every walk, the thread-block cluster size and the
dynamic shared-memory bytes; the stage count of the shared-memory ring is
the kernel's constant (``STAGES``).  The bitwise pins between the walks
(paged == ring, split NS 1 + combine == single walk, a head's bits
whatever the heads in the launch) need the cluster size to depend on S
and D only; the bytes must fit a block (232,448 on sm_90).
"""
from __future__ import annotations

import dataclasses
import inspect

import pytest
import torch

from repro_torch.kernels import _build

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops

KV = [torch.int8, torch.bfloat16, torch.float32]
# (model, D, G): gemma-2b's heads (8 query heads on one KV head of 256),
# qwen2-moe's (one query head a KV head of 128)
HEADS = [("gemma-2b", 256, 8), ("qwen2-moe-a2.7b", 128, 1)]


def _walks(S, D, G, kv):
    """The plan of every walk the serve paths launch over S slots."""
    plans = {"ring": da.walk_plan(S, D, G, kv, "ring"),
             "paged": da.walk_plan(S, D, G, kv, "paged", bs=16)}
    for ns in (1, 2, 4, 8):
        plans[f"split{ns}"] = da.walk_plan(S, D, G, kv, "split", ns)
    return plans


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("model,D,G", HEADS)
@pytest.mark.parametrize("S", [1024, 8192])
def test_served_plans_fit_shared_memory(model, D, G, kv, S):
    """Ring and paged walks at 1024 slots (the serve runs), the split
    walk and the single walk at 8192 (serve-long): every block's bytes
    fit, with the full ring of stages."""
    for name, plan in _walks(S, D, G, kv).items():
        assert 0 < plan.smem <= da.MAX_SMEM, (model, name, plan)
        assert plan.cluster in da.CLUSTERS, (model, name, plan)


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("D", [256, 128, 64, 16])
@pytest.mark.parametrize("S", [96, 1024, 2500, 8192])
def test_cluster_and_stages_depend_on_S_and_D_only(S, D, kv):
    """Across G (1 to 16), the walk (ring, paged, split at NS 1 to 8):
    one cluster size, the property the bitwise pins rest on, and the
    cluster size of the same S and D on every cache dtype; B and KH are
    not inputs of the plan at all, nor is the stage count (a constant of
    the kernel)."""
    seen = {p.cluster
            for G in (1, 2, 3, 4, 8, 16)
            for p in _walks(S, D, G, kv).values()}
    assert seen == {da.cluster_for(S, D)}, seen
    params = set(inspect.signature(da.walk_plan).parameters)
    assert not params & {"B", "KH", "batch", "kv_heads", "stages"}, params


def test_cluster_grows_with_the_walk():
    """One block up to 4 steps of 64 slots at D 256, then doubling to the
    portable maximum of 8; a narrower head needs fewer: gemma-2b's 1024
    slots take 4, qwen2-moe's 2, serve-long's 8192 take 8 (kernel 9: 16
    clusters of 8 blocks)."""
    assert [da.cluster_for(S, 256) for S in (64, 256, 257, 512, 1024, 2048,
                                             8192, 65536)] == \
        [1, 1, 2, 2, 4, 8, 8, 8]
    assert [da.cluster_for(S, 128) for S in (512, 1024, 2048, 8192)] == \
        [1, 2, 4, 8]
    assert da.cluster_for(1024, 64) == 1 and da.cluster_for(96, 16) == 1


def test_split_ranges_follow_the_single_walk():
    """A split covers whole 64-slot steps of the single walk, so its
    bitmask and step list are the single walk's restricted to it."""
    for S in (100, 1024, 2500, 8192):
        for ns in (1, 2, 3, 4, 8):
            L = da.split_len(S, ns)
            assert L % da.SPLIT_STEP == 0 and L * ns >= S
    assert da.split_len(8192, ops.n_splits_for(8192)) == 2048


def test_smem_counts_every_region():
    """The bytes grow with the range a block reads (bitmask and step
    list), with G (q, scores, probabilities) and with the paged walk's
    table row; the stage ring dominates at D 256."""
    base = da.smem_bytes(1, 256, 8, 1024)
    stage = 64 * (2 * 256 + 16) + 2 * 64 * 4
    assert base > da.STAGES * stage
    assert da.smem_bytes(1, 256, 8, 8192) - base == \
        (8192 - 1024) // 32 * 4 + (8192 - 1024) // 64 * 4
    assert da.smem_bytes(1, 256, 8, 1024, 64) - base == 64 * 4
    assert da.smem_bytes(1, 256, 16, 1024) > base


def test_forced_plan_and_its_limits():
    """Tests and timings force a cluster size through the plan; outside
    the block the rule is back; a walk too long for one block raises
    instead of launching."""
    rule = da.walk_plan(1024, 256, 8, torch.int8, "ring")
    with da.forced_plan(cluster=1):
        forced = da.walk_plan(1024, 256, 8, torch.int8, "paged", bs=16)
        assert forced.cluster == 1
        with da.forced_plan(cluster=8):
            assert da.walk_plan(1024, 256, 8, torch.int8,
                                "ring").cluster == 8
        assert da.walk_plan(1024, 256, 8, torch.int8, "ring").cluster == 1
    assert da.walk_plan(1024, 256, 8, torch.int8, "ring") == rule
    for bad in (3, 16, 0):
        with pytest.raises(ValueError):
            with da.forced_plan(cluster=bad):
                pass
    with pytest.raises(ValueError, match="shared memory"):
        da.walk_plan(2 ** 18, 256, 16, torch.float32, "ring")
    assert da.walk_plan(2 ** 17, 256, 16, torch.float32, "ring").smem <= \
        da.MAX_SMEM


def test_too_long_a_paged_walk_raises_before_any_launch(monkeypatch):
    """An int8 paged walk at gemma-2b's heads over 12,000 blocks of 16
    (192,000 slots: bitmask, step list and table row outgrow a block)
    no longer raises: the wrapper takes the plan's slices, one launch of
    the split walk over the gathered rows and one combine, and launches
    no paged walk; 11,000 blocks still plan as one walk.  Meta tensors,
    taken down the card's path, stand in for the card's: no memory, only
    shapes and dtypes; the two launches are recorded, not run."""
    def no_library(name):
        raise AssertionError(f"library {name} loaded")
    monkeypatch.setattr(_build, "load", no_library)
    monkeypatch.setattr(da, "on_cpu", lambda *tensors: False)
    B, KH, G, D, bs, NB = 2, 1, 8, 256, 16, 64
    meta = dict(device="meta")
    q = torch.empty(B, KH, G, D, dtype=torch.bfloat16, **meta)
    kp = torch.empty(NB, bs, KH, D, dtype=torch.int8, **meta)
    pp = torch.empty(NB, bs, dtype=torch.int32, **meta)
    sp = torch.empty(NB, bs, KH, dtype=torch.float32, **meta)
    qp = torch.empty(B, dtype=torch.int32, **meta)
    calls = []

    def partial(q, k, v, pos, q_pos, k_scale, v_scale, window, n_splits):
        calls.append(("partial", tuple(k.shape), tuple(pos.shape),
                      tuple(k_scale.shape), n_splits))
        part = torch.empty(B, KH, n_splits, G, 1, **meta)
        return torch.empty(B, KH, n_splits, G, D, **meta), part, part

    def combine(o, m, l, out_dtype):
        calls.append(("combine", tuple(o.shape), out_dtype))
        return torch.empty(B, KH, G, D, dtype=out_dtype, **meta)
    monkeypatch.setattr(da, "decode_attention_partial", partial)
    monkeypatch.setattr(da, "decode_attention_combine", combine)
    before = da.decode_attention_paged.launches
    tables = torch.empty(B, 12000, dtype=torch.int32, **meta)
    out = da.decode_attention_paged(q, kp, kp, pp, tables, qp, sp, sp)
    assert da.decode_attention_paged.launches == before
    plan = da.walk_plan(12000 * bs, D, G, torch.int8, "paged", bs=bs)
    S = 12000 * bs
    assert calls == [("partial", (B, S, KH, D), (B, S), (B, S, KH),
                      plan.splits),
                     ("combine", (B, KH, plan.splits, G, D),
                      torch.bfloat16)]
    assert out.shape == q.shape and out.dtype == q.dtype
    assert da.walk_plan(11000 * bs, D, G, torch.int8, "paged",
                        bs=bs).splits == 1


def test_long_paged_walk_plans_in_slices():
    """At 192,000 slots (gemma-2b's heads, int8, blocks of 16) the one
    walk needs more than a block's 232,448 bytes; the plan takes the
    fewest slices of whole 64-slot steps (whole pool blocks of 16) that
    fit, with the split walk's bytes and the cluster size of the whole
    walk's S and D, as the served splits have.  Up to 11,832 blocks
    (189,312 slots) one walk fits; from 11,833 the slices start."""
    D, G, bs = 256, 8, 16
    S = 12000 * bs
    plan = da.walk_plan(S, D, G, torch.int8, "paged", bs=bs)
    assert plan.splits == 2
    assert plan.cluster == da.cluster_for(S, D)
    L = da.split_len(S, plan.splits)
    assert L % da.SPLIT_STEP == 0 and L % bs == 0 and L * plan.splits >= S
    assert plan == dataclasses.replace(
        da.walk_plan(S, D, G, torch.int8, "split", plan.splits),
        splits=plan.splits)
    assert da.smem_bytes(1, D, G, S, S // bs) > da.MAX_SMEM >= plan.smem
    assert da.walk_plan(11832 * bs, D, G, torch.int8, "paged",
                        bs=bs).splits == 1
    assert da.walk_plan(11833 * bs, D, G, torch.int8, "paged",
                        bs=bs).splits == 2
    for S in (2 ** 20, 3 * 10 ** 6):
        plan = da.walk_plan(S, D, 16, torch.float32, "paged", bs=bs)
        assert plan.splits > 1 and plan.smem <= da.MAX_SMEM
        assert da.smem_bytes(4, D, 16, da.split_len(S, plan.splits - 1)) \
            > da.MAX_SMEM
