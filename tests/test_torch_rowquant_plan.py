"""The launch plan of the row quantizer (kernel 1,
``repro_torch.kernels.cim_gemm.rowquant_plan``), on the CPU: no card is
needed to check it; and the plain version against the JAX kernel in
interpret mode at a ragged and at gemma-2b's widest K.

The plan picks, from (M, K, dtype, aligned) alone, the unit (16 bytes, or
one value when a row's bytes do not divide into 16 or x is not 16-byte
aligned) and the threads of the block that takes a row.  The card tests (``tests/test_torch_cuda.py``)
hold the kernel bitwise to its plain version under every plan listed
here.
"""
from __future__ import annotations

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import cim_gemm as cg
from torch_parity import rng, t, to_np

F32, BF16 = torch.float32, torch.bfloat16
# served shapes: gemma-2b's hidden requant and MLP input at decode (8
# slots), qwen2-moe's stacked expert rows (60 x 8) and shared MLP input,
# a 64-token prefill, a served prompt's and a 4096-token forward's hidden
# requant (and chip_smoke's 5056 rows)
SERVED = [(8, 16384, F32), (8, 2048, BF16), (480, 2048, BF16),
          (8, 5632, BF16), (64, 2048, BF16), (200, 16384, F32),
          (4096, 16384, F32), (5056, 16384, F32), (1, 2048, BF16)]
RAGGED = [(3, 1030, F32), (5, 1030, BF16), (1, 7, F32), (130, 1030, F32),
          (9, 100, BF16), (2, 70, F32)]
# rows longer than one block holds in registers
LONG = [(1, 1 << 20, F32), (4096, 65536, F32), (16, 1 << 19, BF16)]


def test_rule_at_the_served_shapes():
    """The plans ``chip_smoke.py`` times: a 64 KB row ([8, 16384] f32, a
    4096-token forward's [4096, 16384] f32) takes 512 threads, 8 units a
    thread; a 4 KB row ([8, 2048] bf16, [480, 2048] bf16) 128 threads at
    2 units a thread, 64 at 4 units past 4 SMS rows.  All read x once (one
    chunk) in 16-byte units."""
    want = {(8, 16384, F32): 512, (8, 2048, BF16): 128,
            (480, 2048, BF16): 128, (4096, 16384, F32): 512,
            (8, 16384, BF16): 512, (4096, 2048, BF16): 64}
    for (M, K, dtype), threads in want.items():
        plan = cg.rowquant_plan(M, K, dtype)
        assert plan.threads == threads, plan
        assert plan.vec and plan.chunks == 1


def test_plan_is_a_function_of_its_arguments_only():
    """No tensor, device or earlier call enters the plan: the same (M, K,
    dtype, aligned) always gives the same plan."""
    assert list(inspect.signature(cg.rowquant_plan).parameters) == [
        "M", "K", "dtype", "aligned"]
    for M, K, dtype in SERVED + RAGGED + LONG:
        for aligned in (True, False):
            assert cg.rowquant_plan(M, K, dtype, aligned) == \
                cg.rowquant_plan(M, K, dtype, aligned)


@pytest.mark.parametrize("M,K,dtype", SERVED + RAGGED + LONG)
def test_units_threads_and_bytes_that_fit(M, K, dtype):
    """16-byte units exactly when a row's bytes divide into 16; a block's
    threads are whole warps, a power of two from 32 to 1024 (more than
    RQ_THREADS only when the row needs them); each thread holds at most
    RQ_UNITS units, and a row that one block can hold is read in one
    chunk (x read once): every row up to 1024 threads x 8 units."""
    plan = cg.rowquant_plan(M, K, dtype)
    xb = 4 if dtype == F32 else 2
    assert plan.vec == (K * xb % 16 == 0)
    assert plan.units == (K * xb // 16 if plan.vec else K)
    assert 32 <= plan.threads <= cg.RQ_MAX_THREADS
    assert plan.threads & (plan.threads - 1) == 0
    held = plan.threads * cg.RQ_UNITS
    if plan.threads > cg.RQ_THREADS:
        assert plan.threads // 2 * cg.RQ_UNITS < plan.units
    fits = plan.units <= cg.RQ_MAX_THREADS * cg.RQ_UNITS
    assert (plan.chunks == 1) == fits
    assert plan.chunks == -(-plan.units // held)


@pytest.mark.parametrize("M,K,dtype", SERVED + RAGGED + LONG)
def test_threads_give_two_units_a_lane_below_4_sms_rows_four_above(
        M, K, dtype):
    """Up to RQ_THREADS, a block has the fewest threads (from 32) that give
    each at most two units of the row when the rows are fewer than 4 SMS
    (latency-bound: more warps issue their loads at once), four when they
    are more (PERF.md's sweep at half and twice the rule's threads)."""
    plan = cg.rowquant_plan(M, K, dtype)
    lane = 2 if M < 4 * cg.SMS else 4
    if plan.threads <= cg.RQ_THREADS:
        assert plan.units <= plan.threads * lane or \
            plan.threads == cg.RQ_THREADS
        assert plan.threads == 32 or \
            plan.threads // 2 * lane < plan.units


@pytest.mark.parametrize("M,K,dtype", [(1, 1 << 20, F32),
                                       (4096, 65536, F32)])
def test_long_rows_loop_in_chunks(M, K, dtype):
    """A row longer than 1024 threads hold in registers takes 1024
    threads and several chunks a thread (its x read twice but the last
    chunk): 2 at a 256 KB row, 32 at a 4 MB row."""
    plan = cg.rowquant_plan(M, K, dtype)
    chunks = 2 if K == 65536 else 32
    assert (plan.threads, plan.chunks) == (1024, chunks)


def test_unaligned_rows_take_single_values():
    """``aligned=False`` (x's first byte off a 16-byte boundary) gives
    single-value units whatever K is."""
    for M, K, dtype in SERVED:
        plan = cg.rowquant_plan(M, K, dtype, aligned=False)
        assert not plan.vec and plan.units == K


def test_forced_plans_and_refusals():
    """Forcing the threads works inside the block and ends with it; a
    thread count the kernel does not take raises at once; other dtypes
    and empty rows are refused."""
    rule = cg.rowquant_plan(8, 16384, F32)
    with cg.forced_rowquant_plan(1024):
        assert cg.rowquant_plan(8, 16384, F32).threads == 1024
        with cg.forced_rowquant_plan(32):
            plan = cg.rowquant_plan(8, 16384, F32)
            assert (plan.threads, plan.chunks) == (32, 16)
        assert cg.rowquant_plan(8, 16384, F32).threads == 1024
    assert cg.rowquant_plan(8, 16384, F32) == rule
    for bad in (0, 16, 48, 2048):
        with pytest.raises(ValueError):
            with cg.forced_rowquant_plan(bad):
                pass
    with pytest.raises(ValueError, match="dtype"):
        cg.rowquant_plan(8, 64, torch.float16)
    with pytest.raises(ValueError, match="empty"):
        cg.rowquant_plan(0, 64, F32)


# ---------------------------------------------------------------------------
# kernel 1's plain version against the JAX kernel
# ---------------------------------------------------------------------------
def _edge_rows(seed, M, K):
    """f32 rows (bf16 values) at magnitudes 1e-2 to 1e2, with an all-zero
    row and rows of exact ties at scales 1 and 2 (|max| 127 and 254)."""
    r = rng(seed)
    x = r.standard_normal((M, K)).astype(np.float32)
    x *= r.uniform(1e-2, 1e2, (M, 1)).astype(np.float32)
    x = t(x, torch.bfloat16).float().numpy()
    x[1] = 0.0
    k = np.arange(K) // 2 % 127
    sign = np.where(np.arange(K) % 2, 1.0, -1.0)
    for row, (amax, step) in ((2, (127.0, 0.5)), (3, (254.0, 1.0))):
        x[row] = sign * step * (2 * k + 1)
        x[row, 0] = amax
    return x


@pytest.mark.parametrize("K", [1030, 16384])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_rows_plain_matches_jax(K, dtype):
    """The port's row quantizer (its plain version on the CPU, which the
    kernel is bitwise on the card) against the reference at a ragged K
    and at gemma-2b's d_ff, with an all-zero row and exact ties: codes
    and scales bitwise the reference's oracle (``ref.quantize_rows_int8_
    ref``, a true division by 127).  The JAX kernel, interpreted, may fold
    its division by 127 into a reciprocal multiply (ROADMAP C, "the row
    quantizer divides"): its scales are held within one ulp (2e-7) and
    its codes within one step, and bitwise on every row whose scale is
    the oracle's (all of them on these inputs)."""
    x = _edge_rows(70, 6, K)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = BF16 if dtype == "bf16" else F32
    jx = jnp.asarray(x).astype(jdt)
    q, s = cg.quantize_rows_int8(t(x, tdt))
    rq, rs = jref.quantize_rows_int8_ref(jx)
    np.testing.assert_array_equal(to_np(q), to_np(rq))
    np.testing.assert_array_equal(to_np(s), to_np(rs))
    jq, js = (to_np(a) for a in jops.quantize_rows_int8(jx, interpret=True))
    q, s = to_np(q), to_np(s)
    np.testing.assert_allclose(s, js, rtol=2e-7, atol=0)
    assert np.abs(q.astype(int) - jq.astype(int)).max() <= 1
    same = (s == js).ravel()
    np.testing.assert_array_equal(q[same], jq[same])
    assert same.all()
    assert not q[1].any() and s[1, 0] == np.float32(1e-12) / np.float32(127)
