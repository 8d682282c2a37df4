"""The launch plan of the tensor-core int8 GEMM (kernels 2, 3, 4 and 6,
``repro_torch.kernels.cim_gemm.gemm_plan``), on the CPU: no card is
needed to check it; the grouped plan of kernels 7 and 8; and the plain
versions of the four kernels and of kernel 8 against the JAX package's
kernels in interpret mode at a ragged prefill shape.

The plan picks the tile shape (decode: W^T on the tensor cores' A side,
up to 16 rows; prefill: 128-row tiles), the cluster size that splits K
and the dynamic shared-memory bytes, from (M, K, N) and the body's
variant alone (int8 x for kernels 3 and 6, the gated pair for kernel 4,
f32 or bf16 x quantized in the kernel for kernel 2).  The kernel's own
count of the bytes is held against this one on the card
(``tests/test_torch_cuda.py``).
"""
from __future__ import annotations

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import cim_gemm as jcg
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import cim_gemm as cg
from torch_parity import rng, t, to_np

# served decode shapes (M = 8 slots) of kernels 3 and 6: gemma-2b's down
# GEMM, qwen2-moe's shared down GEMM and kernel 6's tensor-parallel
# partials at TP-2 (``chip_smoke.TP_GEMM_SHAPES``: gemma-2b's
# out-projection and down shards, qwen2-moe's shared down shard)
DECODE_SHAPES = [(8, 16384, 2048), (8, 5632, 2048), (8, 1024, 2048),
                 (8, 8192, 2048), (8, 2816, 2048)]
# served decode shapes of kernel 4 (gemma-2b's gated GEMM, qwen2-moe's
# shared gated GEMM with its requant, gemma-2b's TP-2 shard) and of kernel
# 2 (gemma-2b's QKV and out-projection, qwen2-moe's QKV), with the variant
SERVED_NEW = [("gated", 8, 2048, 16384), ("gated", 8, 2048, 5632),
              ("gated", 8, 2048, 8192), ("qin_bf16", 8, 2048, 2560),
              ("qin_bf16", 8, 2048, 2048), ("qin_bf16", 8, 2048, 6144),
              ("qin_f32", 8, 2048, 2560)]
RAGGED = [(1, 5, 4), (3, 100, 36), (13, 1030, 68), (16, 1030, 264),
          (17, 1030, 264), (33, 2048, 512), (130, 1030, 264)]
# the prefill shapes of forward-long: gemma-2b's QKV (kernel 2) and gated
# GEMM (kernel 4) at 4096 tokens, and a served prompt's
PREFILL_NEW = [("qin_bf16", 4096, 2048, 2560), ("gated", 4096, 2048, 16384),
               ("qin_bf16", 200, 2048, 2560), ("gated", 200, 2048, 16384)]


@pytest.mark.parametrize("variant", cg.VARIANTS)
@pytest.mark.parametrize("M", [1, 5, 8, 9, 16, 17, 33, 130, 200, 4096])
@pytest.mark.parametrize("K,N", [(16384, 2048), (1030, 264), (64, 4)])
def test_tile_shape_by_rows(M, K, N, variant):
    """The decode tile up to DECODE_MAX_M rows (8 rows of it up to 8),
    the prefill tile above; a gated tile has 64 output columns on both
    shapes (64 of each weight)."""
    plan = cg.gemm_plan(M, K, N, variant)
    assert plan.variant == variant and plan.var == cg.VARIANTS.index(
        variant)
    if M <= cg.DECODE_MAX_M:
        assert plan.kind == "decode" and plan.bm == (8 if M <= 8 else 16)
        assert (plan.bn, plan.bk) == (cg.DEC_BN, cg.DEC_BK)
        assert plan.shape == plan.bm // 8 - 1
    else:
        bn = cg.PRE_BN // 2 if variant == "gated" else cg.PRE_BN
        assert plan.kind == "prefill" and plan.shape == 2
        assert (plan.bm, plan.bn, plan.bk) == (cg.PRE_BM, bn, cg.PRE_BK)


def test_plan_is_a_function_of_m_k_n_only():
    """No dtype, epilogue, device or tensor enters the plan beyond the
    body's variant, the same (M, K, N, variant) always gives the same
    plan, and kernels 3 and 6 (the default variant) keep PR 18's plans:
    the int8 body's shared bytes and the rule's cluster."""
    assert list(inspect.signature(cg.gemm_plan).parameters) == [
        "M", "K", "N", "variant"]
    assert inspect.signature(cg.gemm_plan).parameters[
        "variant"].default == "int8"
    for M, K, N in DECODE_SHAPES + RAGGED + [(4096, 16384, 2048)]:
        for variant in cg.VARIANTS:
            assert cg.gemm_plan(M, K, N, variant) == cg.gemm_plan(
                M, K, N, variant)
        plan = cg.gemm_plan(M, K, N)
        assert plan == cg.gemm_plan(M, K, N, "int8")
        _, spr = cg.k_steps(K, cg.DEC_BK, plan.cluster)
        assert plan.smem == (
            4 * 128 * 64 + plan.bm * (spr * 128 + 16) + 1040
            if plan.kind == "decode" else
            max(4 * (128 * 64 + 64 * 128),
                128 * 132 * 4 if plan.cluster > 1 else 0) + 1040)
    assert [cg.gemm_plan(*s).cluster for s in DECODE_SHAPES] == [5, 5, 5,
                                                                 5, 5]
    with pytest.raises(ValueError, match="variant"):
        cg.gemm_plan(8, 64, 64, "fp8")


@pytest.mark.parametrize("variant", cg.VARIANTS)
@pytest.mark.parametrize("M,K,N", DECODE_SHAPES + RAGGED + [
    (200, 16384, 2048), (4096, 16384, 2048), (4096, 8192, 2048)] + [
    s[1:] for s in SERVED_NEW + PREFILL_NEW])
def test_split_gives_every_rank_whole_steps(M, K, N, variant):
    """Every plan the kernel takes splits K into whole steps of bk rows,
    contiguous and in rank order, every rank at least one; the last step
    is ragged (masked in the kernel) when bk does not divide K."""
    for plan in cg.gemm_plans(M, K, N, variant):
        steps = -(-K // plan.bk)
        # rank r's steps, as the kernel splits them
        spans = [(r * steps // plan.cluster, (r + 1) * steps // plan.cluster)
                 for r in range(plan.cluster)]
        assert spans[0][0] == 0 and spans[-1][1] == steps
        assert all(lo < hi for lo, hi in spans), (plan, spans)
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        assert max(hi - lo for lo, hi in spans) == \
            cg.k_steps(K, plan.bk, plan.cluster)[1]
        assert (steps * plan.bk - K) < plan.bk


@pytest.mark.parametrize("variant,M,K,N", [
    ("int8", *s) for s in DECODE_SHAPES] + SERVED_NEW)
def test_served_decode_grids_fill_the_card(variant, M, K, N):
    """At every served decode shape the rule's grid gives each of the
    132 SMs a weight stream (a gated block streams two), with the fewest
    blocks per cluster that do (at most RULE_MAX_CLUSTER): kernels 3 and
    6 split K over 5 blocks, kernel 4 takes no cluster at its served
    widths (256, 88 and 128 column tiles of 64)."""
    plan = cg.gemm_plan(M, K, N, variant)
    streams = 2 if variant == "gated" else 1
    assert plan.kind == "decode"
    assert plan.grid(M, N) * streams >= cg.SMS, plan
    assert 1 <= plan.cluster <= cg.RULE_MAX_CLUSTER
    assert plan.cluster == 1 or cg._plan_of(
        "decode", plan.cluster - 1, M, K, variant).grid(M, N) * streams \
        < cg.SMS
    if variant == "int8":
        assert plan.cluster > 1
    if variant == "gated":
        assert plan.cluster == 1


@pytest.mark.parametrize("variant", cg.VARIANTS)
@pytest.mark.parametrize("M,K,N", DECODE_SHAPES + RAGGED + [
    (16, 16384, 2048), (200, 16384, 2048), (4096, 16384, 2048),
    (8, 200000, 2048)] + [s[1:] for s in SERVED_NEW + PREFILL_NEW])
def test_shared_bytes_fit_a_block(M, K, N, variant):
    """The rule's plan and every plan the kernel takes fit 232,448 bytes;
    the decode bytes grow with the rank's x slice; the gated ring holds
    two weights' stages, the quantize-in prefill ring x as it is (f32 or
    bf16) beside the int8 tile."""
    assert cg.gemm_plan(M, K, N, variant).smem <= cg.MAX_SMEM == 232448
    for plan in cg.gemm_plans(M, K, N, variant):
        assert plan.smem <= cg.MAX_SMEM
    dec = [cg.smem_bytes("decode", 16, 16384, c, variant)
           for c in (1, 2, 4, 8)]
    assert dec == sorted(dec, reverse=True)
    assert dec[0] > cg.MAX_SMEM
    ring = {"int8": 32768, "gated": 65536, "qin_f32": 32768,
            "qin_bf16": 32768}[variant]
    assert cg.smem_bytes("decode", 8, 128, 1, variant) == \
        ring + 8 * (128 + 16) + 1040
    pre = {"int8": 65536, "gated": 65536, "qin_f32": 4 * 40960 + 8192,
           "qin_bf16": 4 * 24576 + 8192}[variant]
    assert cg.smem_bytes("prefill", 128, 2048, 1, variant) == pre + 1040


@pytest.mark.parametrize("variant", cg.VARIANTS)
def test_forced_plan_rejects_what_the_kernel_cannot_take(variant):
    """Forcing the plan works inside the block and ends with it, for every
    variant; a cluster size or tile the kernel does not have raises at
    once; a forced plan the shape does not allow raises in gemm_plan."""
    rule = cg.gemm_plan(8, 16384, 2048, variant)
    with cg.forced_gemm_plan(cluster=2):
        assert cg.gemm_plan(8, 16384, 2048, variant).cluster == 2
        with cg.forced_gemm_plan(kind="prefill"):
            forced = cg.gemm_plan(8, 16384, 2048, variant)
            assert (forced.kind, forced.cluster) == ("prefill", 2)
        assert cg.gemm_plan(8, 16384, 2048, variant).kind == "decode"
    assert cg.gemm_plan(8, 16384, 2048, variant) == rule
    for bad in (dict(cluster=0), dict(cluster=9), dict(kind="wgmma")):
        with pytest.raises(ValueError):
            with cg.forced_gemm_plan(**bad):
                pass
    with cg.forced_gemm_plan(kind="decode"):
        with pytest.raises(ValueError, match="at most 16 rows"):
            cg.gemm_plan(17, 1024, 64, variant)
    with cg.forced_gemm_plan(kind="decode", cluster=1):
        with pytest.raises(ValueError, match="shared memory"):
            cg.gemm_plan(16, 16384, 2048, variant)
    with cg.forced_gemm_plan(cluster=8):
        with pytest.raises(ValueError, match="without a K step"):
            cg.gemm_plan(8, 700, 64, variant)       # 6 steps of 128
    assert cg.gemm_plan(8, 700, 64, variant).cluster <= 6


@pytest.mark.parametrize("variant", cg.VARIANTS)
def test_every_plan_listed_is_one_gemm_plan_takes(variant):
    """``gemm_plans`` lists exactly the forced plans gemm_plan accepts."""
    for M, K, N in [(8, 1024, 2048), (16, 16384, 2048), (130, 1030, 264),
                    (8, 2048, 16384), (4096, 2048, 2560)]:
        plans = cg.gemm_plans(M, K, N, variant)
        for kind in ("decode", "prefill"):
            for c in cg.CLUSTERS:
                with cg.forced_gemm_plan(kind, c):
                    try:
                        got = cg.gemm_plan(M, K, N, variant)
                    except ValueError:
                        assert all((p.kind, p.cluster) != (kind, c)
                                   for p in plans)
                    else:
                        assert got in plans
        assert cg.gemm_plan(M, K, N, variant) in plans


# ---------------------------------------------------------------------------
# kernels 3 and 6 (plain versions) against the JAX kernels at a ragged
# prefill shape
# ---------------------------------------------------------------------------
RAGGED_PREFILL = (130, 1030, 264)


def _operands(seed):
    r = rng(seed)
    M, K, N = RAGGED_PREFILL
    xq = r.integers(-127, 128, (M, K)).astype(np.int8)
    xs = r.uniform(1e-3, 1e-2, (M, 1)).astype(np.float32)
    w = r.integers(-127, 128, (K, N)).astype(np.int8)
    ws = r.uniform(1e-3, 2e-2, N).astype(np.float32)
    b = r.standard_normal(N).astype(np.float32)
    res = r.standard_normal((M, N)).astype(np.float32)
    return xq, xs, w, ws, b, res


def test_cim_gemm_int8_matches_jax_at_ragged_prefill():
    """Kernel 6: the int32 stage is exact against the JAX kernel (padded
    to its blocks by ``ops.cim_int8_gemm_acc``, interpret mode)."""
    xq, _, w, *_ = _operands(40)
    want = jops.cim_int8_gemm_acc(jnp.asarray(xq), jnp.asarray(w),
                                  interpret=True)
    got = cg.cim_gemm_int8(t(xq), t(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(to_np(got), to_np(want))


@pytest.mark.parametrize("bias,residual", [(False, False), (True, True)])
def test_cim_gemm_int8_fused_matches_jax_at_ragged_prefill(bias, residual):
    """Kernel 3 without an activation against the JAX kernel (padded to
    its blocks, interpret mode): both sum exactly in int32 and round the
    epilogue in the same order, so the dequantized product is bitwise
    the reference's.  With a bias and a residual XLA's CPU compiler fuses
    each add with the product into one multiply-add (one rounding fewer
    than the reference's own order, which the port keeps), so those
    outputs are held within RTOL = 1e-6 of the largest |out|, the rule
    of ``tests/test_torch_kernels.py``."""
    xq, xs, w, ws, b, res = _operands(41)
    M, K, N = RAGGED_PREFILL
    x_p, w_p, ws_p, b_p, *_ = jops._pad_operands(
        jnp.asarray(xq), jnp.asarray(w), jnp.asarray(ws),
        jnp.asarray(b) if bias else None)
    xs_p, _ = jops._pad_to(jnp.asarray(xs), 0, 256)
    want = jcg.cim_gemm_int8_fused(
        x_p, w_p, xs_p, ws_p, bias=b_p,
        residual=jops._pad_residual(jnp.asarray(res)) if residual else None,
        interpret=True)[:M, :N]
    got = cg.cim_gemm_int8_fused(t(xq), t(w), t(xs), t(ws),
                                 bias=t(b) if bias else None,
                                 residual=t(res) if residual else None)
    assert got.dtype == torch.float32
    want, got = to_np(want), to_np(got)
    if not (bias or residual):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


# ---------------------------------------------------------------------------
# kernels 2 and 4 (plain versions) against the JAX kernels at the ragged
# prefill shape
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("act", [None, "gelu"])
def test_cim_gemm_int8_fused_qin_matches_jax_at_ragged_prefill(dtype, act):
    """Kernel 2 with f32 and bf16 x against the reference's oracle
    (``ref.fused_matmul_ref``): without an activation bitwise (the row
    codes and scales, the exact int32 sums and the epilogue's order
    agree); with gelu within RTOL = 1e-6 of the largest |out| (XLA's tanh
    against torch's).  Against the JAX kernel through ``ops`` (padded to
    its blocks, one dispatch, interpret mode): XLA folds the kernel's
    division by 127 into a multiply by the reciprocal, so its row scales
    sit one ulp from the oracle's in some rows and a bf16 x meets exact
    ties (x = amax / 2 gives 63.5) that the ulp breaks the other way; the
    JAX kernel's output is bitwise the port's product and epilogue
    (kernel 3's plain version) on the JAX row quantizer's own codes and
    scales, which lie within one step and one ulp of the port's."""
    r = rng(42)
    M, K, N = RAGGED_PREFILL
    x = r.standard_normal((M, K)).astype(np.float32)
    w = r.integers(-127, 128, (K, N)).astype(np.int8)
    ws = r.uniform(1e-3, 2e-2, N).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bf16"
                               else jnp.float32)
    tx = t(x, torch.bfloat16 if dtype == "bf16" else torch.float32)
    got = cg.cim_gemm_int8_fused_qin(tx, t(w), t(ws), activation=act)
    assert got.dtype == torch.float32
    got = to_np(got)
    oracle = to_np(jref.fused_matmul_ref(jx, jnp.asarray(w), jnp.asarray(ws),
                                         activation=act))
    if act is not None:
        np.testing.assert_allclose(got, oracle, rtol=0,
                                   atol=1e-6 * np.abs(oracle).max())
        return
    np.testing.assert_array_equal(got, oracle)
    want = to_np(jops.cim_quantized_matmul_fused(
        jx, jnp.asarray(w), jnp.asarray(ws), interpret=True))
    jq, js = jops.quantize_rows_int8(jops._pad_to(jx, 1, jcg.CORE_K)[0],
                                     interpret=True)
    jq, js = to_np(jq)[:, :K], to_np(js)
    np.testing.assert_array_equal(to_np(cg.cim_gemm_int8_fused_plain(
        t(jq), t(w), t(js), t(ws))), want)
    q, s = cg.quantize_rows_int8(tx)
    assert np.abs(to_np(q).astype(int) - jq.astype(int)).max() <= 1
    np.testing.assert_allclose(to_np(s), js, rtol=2e-7, atol=0)


def _gated_jax(xq, xs, wg, gs, wu, us, act, quantize_out):
    """The JAX gated kernel padded as ``ops.cim_hidden_int8`` pads it
    (rows to 256, K to CORE_K, N to CORE_N), interpret mode, sliced
    back."""
    M, _ = xq.shape
    N = wg.shape[1]
    x_p, _ = jops._pad_to(jnp.asarray(xq), 0, 256)
    x_p, _ = jops._pad_to(x_p, 1, jcg.CORE_K)
    s_p, _ = jops._pad_to(jnp.asarray(xs), 0, 256)
    g_p, gs_p, _ = jops._pad_weight(jnp.asarray(wg), jnp.asarray(gs))
    u_p, us_p, _ = jops._pad_weight(jnp.asarray(wu), jnp.asarray(us))
    out = jcg.cim_gated_gemm_int8(x_p, g_p, u_p, s_p, gs_p, us_p,
                                  activation=act, quantize_out=quantize_out,
                                  interpret=True)
    if quantize_out:
        return to_np(out[0][:M, :N]), to_np(out[1][:M])
    return to_np(out[:M, :N])


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_cim_gated_gemm_int8_matches_jax_at_ragged_prefill(act):
    """Kernel 4 against the JAX kernel at the ragged prefill shape: the
    f32 hidden state within RTOL = 1e-6 of its largest |h| (XLA's tanh
    and exp against torch's); with the requant the codes within one step
    (where an ulp of the activation crosses a rounding tie, as
    ``tests/test_torch_kernels.py`` states) and the scales within
    RTOL."""
    xq, xs, wg, gs, *_ = _operands(43)
    M, K, N = RAGGED_PREFILL
    r = rng(44)
    wu = r.integers(-127, 128, (K, N)).astype(np.int8)
    us = r.uniform(1e-3, 2e-2, N).astype(np.float32)
    want = _gated_jax(xq, xs, wg, gs, wu, us, act, False)
    got = to_np(cg.cim_gated_gemm_int8(t(xq), t(wg), t(wu), t(xs), t(gs),
                                       t(us), activation=act))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    wq, wsc = _gated_jax(xq, xs, wg, gs, wu, us, act, True)
    q, s = cg.cim_gated_gemm_int8(t(xq), t(wg), t(wu), t(xs), t(gs), t(us),
                                  activation=act, quantize_out=True)
    assert np.abs(to_np(q).astype(int) - wq.astype(int)).max() <= 1
    np.testing.assert_allclose(to_np(s), wsc, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# kernels 7 and 8: the grouped GEMMs' plan, and kernel 8's plain version
# against the JAX kernel at a ragged shape
# ---------------------------------------------------------------------------
# qwen2-moe's experts: kernel 8 (the gated pair, K 2048, N 1408) and
# kernel 7 (the down GEMM, K 1408, N 2048), with the clusters that E = 1,
# 2, 3 and 60 experts of that shape take at 8 rows
GROUPED = [("gated", 2048, 1408, [3, 2, 1, 1]),
           ("int8", 1408, 2048, [5, 3, 2, 1])]
GROUPED_IDS = [v for v, *_ in GROUPED]


@pytest.mark.parametrize("variant,K,N,clusters", GROUPED, ids=GROUPED_IDS)
@pytest.mark.parametrize("E", [60, 30])
@pytest.mark.parametrize("M", [8, 16, 17, 136])
def test_grouped_plan_at_the_served_shapes(E, M, variant, K, N, clusters):
    """qwen2-moe's experts at serve-moe's decode (E 60, 8 capacity rows),
    its TP-2 expert shard (E 30), the 16-row decode tile and prefill
    chunks of 17 and 136 rows an expert: the body's tile (8 or 16 rows,
    else 128-row prefill tiles; 64 output columns, 128 on the int8
    prefill tile), cluster 1 (E x the column tiles, x 2 weight streams on
    the gated body, give every SM a stream many times over), the launch E
    times the body's grid, the body's shared bytes."""
    plan = cg.grouped_plan(E, M, K, N, variant)
    assert plan.variant == variant and plan.cluster == 1
    assert plan.kind == ("decode" if M <= 16 else "prefill")
    assert plan.bm == {8: 8, 16: 16}.get(M, 128)
    assert plan.bn == (128 if plan.kind == "prefill" and variant == "int8"
                       else 64)
    assert plan == cg._plan_of(plan.kind, 1, M, K, variant)
    assert plan.grid(M, N) * E == E * -(-N // plan.bn) * (
        1 if M <= 128 else 2)
    assert plan.smem <= cg.MAX_SMEM
    assert plan in cg.gemm_plans(M, K, N, variant)


@pytest.mark.parametrize("variant,K,N,clusters", GROUPED, ids=GROUPED_IDS)
def test_grouped_plan_counts_every_expert_and_refuses(variant, K, N,
                                                      clusters):
    """The cluster rule counts the blocks of all E experts (the plan
    cannot see which hold tokens): one expert is the dense plan of its
    variant (the gated pair: 22 tiles x 2 streams, a cluster of 3; the
    down GEMM: 32 tiles, 5), more take fewer, 60 fill the card at 1.  E
    outside 1 to 65535 (the grid's z extent) raises, and so does a
    variant with no grouped body, and a forced plan the body cannot take,
    as in gemm_plan; a forced plan the body takes is taken."""
    assert cg.grouped_plan(1, 8, K, N, variant) == cg.gemm_plan(8, K, N,
                                                                variant)
    assert [cg.grouped_plan(E, 8, K, N, variant).cluster
            for E in (1, 2, 3, 60)] == clusters
    for E in (0, -1, 65536):
        with pytest.raises(ValueError, match="experts"):
            cg.grouped_plan(E, 8, K, N, variant)
    with pytest.raises(ValueError, match="variant"):
        cg.grouped_plan(60, 8, K, N, "qin_f32")
    with cg.forced_gemm_plan(kind="decode"):
        with pytest.raises(ValueError, match="at most 16 rows"):
            cg.grouped_plan(60, 17, K, N, variant)
    with cg.forced_gemm_plan(cluster=8):
        with pytest.raises(ValueError, match="without a K step"):
            cg.grouped_plan(60, 8, 700, N, variant)
    with cg.forced_gemm_plan("prefill", 2):
        plan = cg.grouped_plan(60, 8, K, N, variant)
        assert (plan.kind, plan.cluster) == ("prefill", 2)


def _grouped_gated_jax(x, xs, wg, gs, wu, us, counts, act):
    """The JAX grouped gated kernel padded as ``ops`` pads the grouped
    MLP (rows to 32, K to CORE_K, N to CORE_N), interpret mode, sliced
    back."""
    E, M, _ = x.shape
    N = wg.shape[-1]
    x_p = jops._pad_grouped_acts(jnp.asarray(x))
    s_p, _ = jops._pad_to(jnp.asarray(xs), 1, jops.GROUP_ROW_ALIGN)
    g_p, gs_p, _ = jops._pad_grouped_weight(jnp.asarray(wg), jnp.asarray(gs))
    u_p, us_p, _ = jops._pad_grouped_weight(jnp.asarray(wu), jnp.asarray(us))
    out = jcg.cim_grouped_gated_gemm_int8(
        x_p, g_p, u_p, s_p, gs_p, us_p, counts=jnp.asarray(counts),
        activation=act, interpret=True)
    return to_np(out[:, :M, :N])


@pytest.mark.parametrize("act", [None, "silu"])
def test_grouped_gated_plain_matches_jax_at_ragged_shape(act):
    """Kernel 8's plain version (which the kernel is on the card: bitwise,
    activations within 1e-5) against the JAX kernel at E 3, M 13, K 1030,
    N 264 with expert 1 idle (count 0, its rows zero, as the dispatch
    leaves an empty capacity buffer): the f32 output within RTOL = 1e-6
    of its largest |h| (the interpreter fuses the epilogue; XLA's exp
    against torch's); without an activation bitwise the reference's
    epilogue run op by op on its exact int32 sums (ROADMAP C.2: hold the
    grouped kernels against the oracle where the interpreter differs);
    the requant bitwise the reference's row quantizer of the f32 output,
    not the interpreter's in-kernel requant, which multiplies by 1/127
    (C.2, as ``tests/test_torch_moe.py`` holds kernels 7 and 8); the idle
    expert's rows +0, code 0, scale 1e-12 / 127."""
    r = rng(45)
    E, M, K, N = 3, 13, 1030, 264
    x = r.integers(-127, 128, (E, M, K)).astype(np.int8)
    xs = r.uniform(1e-3, 1e-2, (E, M, 1)).astype(np.float32)
    x[1] = 0
    xs[1] = np.float32(1e-12) / np.float32(127)
    counts = np.array([2, 0, 5], np.int32)
    wg, wu = (r.integers(-127, 128, (E, K, N)).astype(np.int8)
              for _ in range(2))
    gs, us = (r.uniform(1e-3, 2e-2, (E, N)).astype(np.float32)
              for _ in range(2))
    got = cg.cim_grouped_gated_gemm_int8(t(x), t(wg), t(wu), t(xs), t(gs),
                                         t(us), counts=t(counts),
                                         activation=act)
    want = _grouped_gated_jax(x, xs, wg, gs, wu, us, counts, act)
    got = to_np(got)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    if act is None:
        acc_g, acc_u = (jnp.where(jnp.asarray(counts)[:, None, None] > 0,
                                  jax.vmap(jref.cim_gemm_int8_ref)(
                                      jnp.asarray(x), jnp.asarray(w)), 0)
                        for w in (wg, wu))
        g = acc_g.astype(jnp.float32) * jnp.asarray(xs) \
            * jnp.asarray(gs)[:, None, :]
        u = acc_u.astype(jnp.float32) * jnp.asarray(xs) \
            * jnp.asarray(us)[:, None, :]
        np.testing.assert_array_equal(got, to_np(g * u))
    assert not got[1].any() and not np.signbit(got[1]).any()
    q, s = cg.cim_grouped_gated_gemm_int8(t(x), t(wg), t(wu), t(xs), t(gs),
                                          t(us), counts=t(counts),
                                          activation=act, quantize_out=True)
    rq, rs = jref.quantize_rows_int8_ref(jnp.asarray(got))
    np.testing.assert_array_equal(to_np(q), to_np(rq))
    np.testing.assert_array_equal(to_np(s), to_np(rs))
    assert not to_np(q)[1].any()
    assert (to_np(s)[1] == np.float32(1e-12) / np.float32(127)).all()
