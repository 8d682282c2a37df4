"""Kernel 14 (online softmax) of the port against the JAX reference, on
the CPU.

The plain version (what ``repro_torch.kernels.ops.online_softmax`` runs
for CPU tensors) is held against the Pallas kernel in interpret mode
(both of its bodies: rows that fit ``block_c`` and the two-sweep long
rows) and against ``repro.kernels.ref.online_softmax_ref``, on the same
numpy inputs, at the JAX tests' tolerance: rtol 2e-5, atol 2e-6 (one
bf16 rounding, 2**-7 relative, in bf16).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.kernels import launch_counts, ops
from repro_torch.kernels import online_softmax as sm
from repro_torch.kernels import ref as tref
from torch_parity import rng, t, to_np


def _x(seed, r, c, scale=4.0):
    return (rng(seed).standard_normal((r, c)) * scale).astype(np.float32)


@pytest.mark.parametrize("r,c", [(256, 1024), (512, 512), (256, 4096)])
def test_plain_matches_jax_kernel_and_ref(r, c):
    """(256, 4096) takes the reference's two-sweep body at block_c 1024."""
    x = _x(1, r, c)
    got = ops.online_softmax(t(x), block_r=128, block_c=1024)
    want = jops.online_softmax(jnp.asarray(x), block_r=128, block_c=1024,
                               interpret=True)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(to_np(got),
                               np.asarray(jref.online_softmax_ref(
                                   jnp.asarray(x))), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(to_np(tref.online_softmax_ref(t(x))),
                               to_np(got), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("c", [4, 4096])
def test_extreme_values_stay_finite(c):
    row = np.zeros(c, np.float32)
    row[:4] = [1e4, -1e4, 0.0, 1e4]
    x = np.tile(row, (256, 1))
    got = to_np(ops.online_softmax(t(x), block_c=2048 if c > 4 else 4))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got.sum(-1), np.ones(256), rtol=1e-5)
    np.testing.assert_allclose(got[:, :4], np.tile([0.5, 0, 0, 0.5],
                                                   (256, 1)), atol=1e-7)


@pytest.mark.parametrize("scale", [0.1, 3.0, 50.0])
def test_rows_sum_to_one(scale):
    x = _x(2, 128, 512, scale)
    got = ops.online_softmax(t(x), block_r=64, block_c=256)
    np.testing.assert_allclose(to_np(got).sum(-1), np.ones(128), rtol=1e-4)
    want = jops.online_softmax(jnp.asarray(x), block_r=64, block_c=256,
                               interpret=True)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=2e-5,
                               atol=2e-6)


@pytest.mark.parametrize("c,block_c", [(512, 1024), (2048, 512)])
def test_bf16_matches_jax(c, block_c):
    x = _x(3, 64, c)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    got = ops.online_softmax(t(x, torch.bfloat16), block_r=64,
                             block_c=block_c)
    assert got.dtype == torch.bfloat16
    want = jops.online_softmax(jx, block_r=64, block_c=block_c,
                               interpret=True)
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=2 ** -7,
                               atol=2e-6)
    np.testing.assert_allclose(to_np(got),
                               to_np(jref.online_softmax_ref(jx)),
                               rtol=2 ** -7, atol=2e-6)


def test_regimes_follow_shared_memory_not_block_c():
    """The port's switch follows what its blocks hold on chip (32 values
    a thread in registers, ``softmax_plan``), not the reference's
    ``block_c``: a warp a row up to 1024 columns, one launch up to
    16 x 1024 x 32 = 524288 (gemma-2b's 256000 logits: a cluster of 8
    blocks a row), two above."""
    f32 = torch.float32
    assert sm.WARP_MAX_C == 1024
    assert sm.CLUSTER_MAX_C == 16 * 1024 * 32
    assert sm.softmax_plan(256, 1024, f32).regime == "warp"
    assert sm.softmax_plan(256, 1025, f32).regime == "block"
    plan = sm.softmax_plan(8, 256000, f32)
    assert (plan.regime, plan.cluster, plan.launches) == ("cluster", 8, 1)
    assert sm.softmax_plan(1, sm.CLUSTER_MAX_C, f32).launches == 1
    assert sm.softmax_plan(1, sm.CLUSTER_MAX_C + 1, f32).launches == 2


def test_block_arguments_must_divide_as_in_the_reference():
    x = t(_x(4, 96, 3000))
    ops.online_softmax(x, block_r=32, block_c=1000)
    ops.online_softmax(x, block_r=32, block_c=4096)   # one block per row
    with pytest.raises(ValueError):
        ops.online_softmax(x, block_r=64)
    with pytest.raises(ValueError):
        ops.online_softmax(x, block_r=32, block_c=2048)


def test_cpu_calls_launch_nothing_and_devices_must_agree():
    x = t(_x(5, 8, 64))
    before = launch_counts()
    ops.online_softmax(x)
    assert launch_counts() == before
    with pytest.raises(ValueError):
        sm.online_softmax(x[None])
    with pytest.raises(ValueError):             # neither CPU nor CUDA
        sm.online_softmax(x.to("meta"))
