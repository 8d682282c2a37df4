"""The launch plan of the tensor-core int8 GEMM (kernels 3 and 6,
``repro_torch.kernels.cim_gemm.gemm_plan``), on the CPU: no card is
needed to check it; and the plain versions of both kernels against the
JAX package's kernels in interpret mode at a ragged prefill shape.

The plan picks the tile shape (decode: W^T on the tensor cores' A side,
up to 16 rows; prefill: 128 x 128 tiles), the cluster size that splits K
and the dynamic shared-memory bytes, from (M, K, N) alone.  The kernel's
own count of the bytes is held against this one on the card
(``tests/test_torch_cuda.py``).
"""
from __future__ import annotations

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import cim_gemm as jcg
from repro.kernels import ops as jops
from repro_torch.kernels import cim_gemm as cg
from torch_parity import rng, t, to_np

# served decode shapes (M = 8 slots): gemma-2b's down GEMM, qwen2-moe's
# shared down GEMM and kernel 6's tensor-parallel partials at TP-2
# (``chip_smoke.TP_GEMM_SHAPES``: gemma-2b's out-projection and down
# shards, qwen2-moe's shared down shard)
DECODE_SHAPES = [(8, 16384, 2048), (8, 5632, 2048), (8, 1024, 2048),
                 (8, 8192, 2048), (8, 2816, 2048)]
RAGGED = [(1, 5, 4), (3, 100, 36), (13, 1030, 68), (16, 1030, 264),
          (17, 1030, 264), (33, 2048, 512), (130, 1030, 264)]


@pytest.mark.parametrize("M", [1, 5, 8, 9, 16, 17, 33, 130, 200, 4096])
@pytest.mark.parametrize("K,N", [(16384, 2048), (1030, 264), (64, 4)])
def test_tile_shape_by_rows(M, K, N):
    """The decode tile up to DECODE_MAX_M rows (8 rows of it up to 8),
    the prefill tile above."""
    plan = cg.gemm_plan(M, K, N)
    if M <= cg.DECODE_MAX_M:
        assert plan.kind == "decode" and plan.bm == (8 if M <= 8 else 16)
        assert (plan.bn, plan.bk) == (cg.DEC_BN, cg.DEC_BK)
        assert plan.shape == plan.bm // 8 - 1
    else:
        assert plan.kind == "prefill" and plan.shape == 2
        assert (plan.bm, plan.bn, plan.bk) == (cg.PRE_BM, cg.PRE_BN,
                                               cg.PRE_BK)


def test_plan_is_a_function_of_m_k_n_only():
    """No dtype, epilogue, device or tensor enters the plan, and the same
    (M, K, N) always gives the same plan."""
    assert list(inspect.signature(cg.gemm_plan).parameters) == ["M", "K",
                                                                "N"]
    for M, K, N in DECODE_SHAPES + RAGGED + [(4096, 16384, 2048)]:
        assert cg.gemm_plan(M, K, N) == cg.gemm_plan(M, K, N)


@pytest.mark.parametrize("M,K,N", DECODE_SHAPES + RAGGED + [
    (200, 16384, 2048), (4096, 16384, 2048), (4096, 8192, 2048)])
def test_split_gives_every_rank_whole_steps(M, K, N):
    """Every plan the kernel takes splits K into whole steps of bk rows,
    contiguous and in rank order, every rank at least one; the last step
    is ragged (masked in the kernel) when bk does not divide K."""
    for plan in cg.gemm_plans(M, K, N):
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


@pytest.mark.parametrize("M,K,N", DECODE_SHAPES)
def test_served_decode_grids_fill_the_card(M, K, N):
    """At every served decode shape the rule's grid gives each of the
    132 SMs a block, with clusters of at most RULE_MAX_CLUSTER."""
    plan = cg.gemm_plan(M, K, N)
    assert plan.kind == "decode"
    assert plan.grid(M, N) >= cg.SMS, plan
    assert 1 < plan.cluster <= cg.RULE_MAX_CLUSTER


@pytest.mark.parametrize("M,K,N", DECODE_SHAPES + RAGGED + [
    (16, 16384, 2048), (200, 16384, 2048), (4096, 16384, 2048),
    (8, 200000, 2048)])
def test_shared_bytes_fit_a_block(M, K, N):
    """The rule's plan and every plan the kernel takes fit 232,448 bytes;
    the decode bytes grow with the rank's x slice."""
    assert cg.gemm_plan(M, K, N).smem <= cg.MAX_SMEM == 232448
    for plan in cg.gemm_plans(M, K, N):
        assert plan.smem <= cg.MAX_SMEM
    dec = [cg.smem_bytes("decode", 16, 16384, c) for c in (1, 2, 4, 8)]
    assert dec == sorted(dec, reverse=True)
    assert dec[0] > cg.MAX_SMEM


def test_forced_plan_rejects_what_the_kernel_cannot_take():
    """Forcing the plan works inside the block and ends with it; a
    cluster size or tile the kernel does not have raises at once; a
    forced plan the shape does not allow raises in gemm_plan."""
    rule = cg.gemm_plan(8, 16384, 2048)
    with cg.forced_gemm_plan(cluster=2):
        assert cg.gemm_plan(8, 16384, 2048).cluster == 2
        with cg.forced_gemm_plan(kind="prefill"):
            forced = cg.gemm_plan(8, 16384, 2048)
            assert (forced.kind, forced.cluster) == ("prefill", 2)
        assert cg.gemm_plan(8, 16384, 2048).kind == "decode"
    assert cg.gemm_plan(8, 16384, 2048) == rule
    for bad in (dict(cluster=0), dict(cluster=9), dict(kind="wgmma")):
        with pytest.raises(ValueError):
            with cg.forced_gemm_plan(**bad):
                pass
    with cg.forced_gemm_plan(kind="decode"):
        with pytest.raises(ValueError, match="at most 16 rows"):
            cg.gemm_plan(17, 1024, 64)
    with cg.forced_gemm_plan(kind="decode", cluster=1):
        with pytest.raises(ValueError, match="shared memory"):
            cg.gemm_plan(16, 16384, 2048)
    with cg.forced_gemm_plan(cluster=8):
        with pytest.raises(ValueError, match="without a K step"):
            cg.gemm_plan(8, 700, 64)       # 6 steps of 128
    assert cg.gemm_plan(8, 700, 64).cluster <= 6


def test_every_plan_listed_is_one_gemm_plan_takes():
    """``gemm_plans`` lists exactly the forced plans gemm_plan accepts."""
    for M, K, N in [(8, 1024, 2048), (16, 16384, 2048), (130, 1030, 264)]:
        plans = cg.gemm_plans(M, K, N)
        for kind in ("decode", "prefill"):
            for c in cg.CLUSTERS:
                with cg.forced_gemm_plan(kind, c):
                    try:
                        got = cg.gemm_plan(M, K, N)
                    except ValueError:
                        assert all((p.kind, p.cluster) != (kind, c)
                                   for p in plans)
                    else:
                        assert got in plans
        assert cg.gemm_plan(M, K, N) in plans


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
