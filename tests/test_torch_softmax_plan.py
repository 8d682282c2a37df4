"""The launch plan of kernel 14, the online softmax
(``repro_torch.kernels.online_softmax.softmax_plan``), on the CPU: no
card is needed to check it; and the plain version against the JAX kernel
in interpret mode at one shape per regime.

The plan picks, from (R, C, dtype, aligned) alone, the regime (a warp a
row, a block a row, a thread-block cluster a row, or the two-launch
split), the threads of a block, the units a thread holds (16 bytes, or
one value when a row's bytes do not divide into 16 or x is not 16-byte
aligned), the cluster size and the launches.  The card tests
(``tests/test_torch_cuda.py``) hold the kernel to its plain version at
each regime's edges with the launches written out there.
"""
from __future__ import annotations

import inspect
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import online_softmax as sm
from torch_parity import rng, t, to_np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

F32, BF16 = torch.float32, torch.bfloat16
DTYPE = {"f32": F32, "bf16": BF16}

# (R, C, dtype, aligned) -> (regime, threads, units, cluster, vec,
# launches)
PINNED = {
    # chip_smoke's SOFTMAX_CASES: DiT-XL/2's scores, gemma-2b's logits
    # (8 clusters of 8 blocks of 1024 threads, 32000 values a block)
    (16384, 1024, F32, True): ("warp", 256, 8, 1, True, 1),
    (8, 256000, F32, True): ("cluster", 1024, 8, 8, True, 1),
    (8, 256000, BF16, True): ("cluster", 1024, 4, 8, True, 1),
    # the same x off 16-byte alignment: single values
    (16384, 1024, F32, False): ("warp", 256, 32, 1, False, 1),
    (8, 256000, F32, False): ("cluster", 1024, 32, 8, False, 1),
    (8, 256000, BF16, False): ("cluster", 1024, 32, 8, False, 1),
    # warp | block at 1024 columns (1025: C % 4 != 0, single values)
    (300, 1024, F32, True): ("warp", 256, 8, 1, True, 1),
    (300, 1025, F32, True): ("block", 64, 32, 1, False, 1),
    (300, 1028, F32, True): ("block", 64, 8, 1, True, 1),
    # block | cluster by rows: 132 rows fill the SMs, 131 take 2 blocks
    (132, 4096, F32, True): ("block", 128, 8, 1, True, 1),
    (131, 4096, F32, True): ("cluster", 64, 8, 2, True, 1),
    # block | cluster by the slice: halves keep at least 2048 values
    (1, 4095, F32, True): ("block", 128, 32, 1, False, 1),
    (1, 4096, F32, True): ("cluster", 64, 8, 2, True, 1),
    # one block holds 1024 x 32 values
    (200, 32768, F32, True): ("block", 1024, 8, 1, True, 1),
    (200, 32769, F32, True): ("cluster", 1024, 32, 2, False, 1),
    # spreading stops at 8 blocks; holding the row takes up to 16
    (1, 262144, F32, True): ("cluster", 1024, 8, 8, True, 1),
    (1, 262145, F32, True): ("cluster", 1024, 32, 16, False, 1),
    (1, 262144, BF16, True): ("cluster", 1024, 4, 8, True, 1),
    # cluster | split at 16 x 1024 x 32 = 524288 values
    (1, 524288, F32, True): ("cluster", 1024, 8, 16, True, 1),
    (1, 524289, F32, True): ("split", 256, 16, 1, False, 2),
    (1, 524288, BF16, True): ("cluster", 1024, 4, 16, True, 1),
    (1, 524296, BF16, True): ("split", 256, 2, 1, True, 2),
    # C % 4 != 0 (f32) or C % 8 != 0 (bf16): single values
    (8, 1001, F32, True): ("warp", 256, 32, 1, False, 1),
    (8, 1002, BF16, True): ("warp", 256, 32, 1, False, 1),
    (2, 12289, F32, True): ("cluster", 128, 32, 4, False, 1),
}
SHAPES = [k[:3] for k in PINNED] + [(3, 50000, F32), (4, 50000, BF16),
                                    (1000, 4100, F32), (7, 1, F32),
                                    (5, 33000, BF16), (1, 10 ** 6, F32),
                                    (9, 130000, BF16)]


@pytest.mark.parametrize("key", list(PINNED), ids=str)
def test_plan_at_served_shapes_and_every_edge(key):
    """Each regime's boundary and one past it, chip_smoke's cases, ragged
    C and unaligned x: the whole plan pinned."""
    plan = sm.softmax_plan(*key)
    assert (plan.regime, plan.threads, plan.units, plan.cluster, plan.vec,
            plan.launches) == PINNED[key]


def test_plan_is_a_function_of_its_arguments_only():
    """No tensor, device or earlier call enters the plan."""
    assert list(inspect.signature(sm.softmax_plan).parameters) == [
        "R", "C", "dtype", "aligned"]
    for R, C, dtype in SHAPES:
        for aligned in (True, False):
            assert sm.softmax_plan(R, C, dtype, aligned) == \
                sm.softmax_plan(R, C, dtype, aligned)


@pytest.mark.parametrize("R,C,dtype", SHAPES, ids=str)
def test_plan_holds_the_row_in_the_fewest_threads(R, C, dtype):
    """16-byte units exactly when a row's bytes divide into 16; a thread
    holds 32 values (16 in the split regime); a block's threads are a
    power of two from 32 to 1024, the fewest that hold its slice; the
    cluster a power of two up to 16 that holds the row; one launch up to
    524288 columns, two above."""
    xb = 4 if dtype == F32 else 2
    plan = sm.softmax_plan(R, C, dtype)
    per = 16 // xb if plan.vec else 1
    assert plan.vec == (C * xb % 16 == 0)
    assert plan.launches == (2 if C > sm.CLUSTER_MAX_C else 1)
    assert 32 <= plan.threads <= sm.MAX_THREADS
    assert plan.threads & (plan.threads - 1) == 0
    assert plan.cluster & (plan.cluster - 1) == 0
    assert plan.cluster <= sm.MAX_CLUSTER
    if plan.regime == "split":
        assert plan.units * per == sm.SPLIT_VALUES
        return
    assert plan.units * per == sm.VALUES
    if plan.regime == "warp":
        assert C <= 32 * sm.VALUES and plan.cluster == 1
        return
    assert plan.regime == ("block" if plan.cluster == 1 else "cluster")
    slice_units = -(-(C // per) // plan.cluster)
    assert plan.threads * plan.units >= slice_units
    assert plan.threads == 32 or plan.threads // 2 * plan.units < \
        slice_units
    # more blocks a row only where they are needed or fill idle SMs
    if plan.cluster > 1:
        held = sm.MAX_THREADS * sm.VALUES
        assert C > plan.cluster // 2 * held or (
            plan.cluster <= sm.SPREAD_CLUSTER
            and R * plan.cluster // 2 < sm.SMS
            and C // plan.cluster >= sm.MIN_SLICE)


def test_chip_smoke_cases_take_one_launch_each():
    """The ops phase's gate: the three SOFTMAX_CASES and the extreme rows
    take one launch each (4 launches of kernel 14)."""
    plans = [sm.softmax_plan(R, C, DTYPE[dtype])
             for _, R, C, dtype in chip_smoke.SOFTMAX_CASES]
    plans.append(sm.softmax_plan(256, 4, F32))
    assert [p.regime for p in plans] == ["warp", "cluster", "cluster",
                                         "warp"]
    assert sum(p.launches for p in plans) == 4


def test_refusals():
    with pytest.raises(ValueError, match="dtype"):
        sm.softmax_plan(8, 64, torch.float16)
    with pytest.raises(ValueError, match="empty"):
        sm.softmax_plan(0, 64, F32)
    with pytest.raises(ValueError, match="empty"):
        sm.softmax_plan(8, 0, F32)


# one shape per regime with the reference's block arguments (block_c
# divides C where C exceeds it): the rows body for warp and block, the
# two-sweep body for cluster and split
REGIME_SHAPES = [("warp", 64, 1000, 1024, F32),
                 ("block", 256, 2048, 2048, F32),
                 ("cluster", 4, 40960, 8192, F32),
                 ("cluster", 4, 40960, 8192, BF16),
                 ("split", 1, 532480, 106496, F32)]


@pytest.mark.parametrize("regime,R,C,block_c,dtype", REGIME_SHAPES,
                         ids=str)
def test_plain_matches_jax_kernel_per_regime(regime, R, C, block_c, dtype):
    """The plain version (what the port runs on the CPU) against the
    Pallas kernel in interpret mode: rtol 2e-5, atol 2e-6 (2**-7 relative
    in bf16), as ``tests/test_torch_online_softmax.py``."""
    assert sm.softmax_plan(R, C, dtype).regime == regime
    x = (rng(7).standard_normal((R, C)) * 4).astype(np.float32)
    x[0, :4] = [1e4, -1e4, 0.0, 1e4]
    jx = jnp.asarray(x)
    if dtype == BF16:
        jx = jx.astype(jnp.bfloat16)
    got = sm.online_softmax(t(x, dtype))
    assert got.dtype == dtype
    want = jops.online_softmax(jx, block_r=min(256, R), block_c=block_c,
                               interpret=True)
    rtol = 2e-5 if dtype == F32 else 2 ** -7
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=rtol,
                               atol=2e-6)


def test_forced_plans_and_refusals():
    """Forcing the threads and the cluster works inside the block and ends
    with it, for the block and cluster regimes only; a thread count or a
    cluster the kernel does not take raises at once."""
    rule = sm.softmax_plan(8, 256000, F32)
    with sm.forced_softmax_plan(512, 16):
        plan = sm.softmax_plan(8, 256000, F32)
        assert (plan.regime, plan.threads, plan.cluster) == \
            ("cluster", 512, 16)
        assert sm.softmax_plan(16384, 1024, F32).regime == "warp"
        assert sm.softmax_plan(1, 524289, F32).regime == "split"
    assert sm.softmax_plan(8, 256000, F32) == rule
    for bad in ((16, 1), (48, 1), (2048, 1), (512, 0), (512, 17)):
        with pytest.raises(ValueError):
            with sm.forced_softmax_plan(*bad):
                pass
