"""Kernel 12 (flash-attention prefill) of the port against the JAX
reference, on the CPU.

The plain version (what ``repro_torch.kernels.ops.flash_attention`` runs
for CPU tensors) is held against the Pallas kernel in interpret mode and
against ``repro.kernels.ref.flash_attention_ref``, on the same numpy
inputs, at the JAX tests' own tolerances: 2e-5 in f32 (summation order),
2e-2 in bf16 (the reference rounds its scores to bf16, the kernel keeps
them in f32).  It is also held against the port's model prefill path,
``models.attention.dense_attention``, with positions ``arange(S)``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import launch_counts, ops
from repro_torch.kernels import ref as tref
from repro_torch.models.attention import dense_attention
from torch_parity import rng, t, to_np

TOL = {"f32": 2e-5, "bf16": 2e-2}


def _qkv(seed, B, Sq, Skv, H, KH, D, dtype="f32"):
    r = rng(seed)
    arrs = [r.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Skv, KH, D), (B, Skv, KH, D))]
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    return [jnp.asarray(a).astype(jd) for a in arrs], [t(a, td) for a in arrs]


def _close(a, b, tol):
    np.testing.assert_allclose(to_np(a), to_np(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 48)])
@pytest.mark.parametrize("kh", [1, 2, 4])
def test_plain_matches_jax_kernel_and_ref(causal, window, kh):
    (jq, jk, jv), (q, k, v) = _qkv(1, 2, 128, 128, 4, kh, 32)
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              block_q=64, block_k=64)
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                block_q=64, block_k=64, interpret=True)
    _close(got, want, TOL["f32"])
    _close(got, jref.flash_attention_ref(jq, jk, jv, causal, window),
           TOL["f32"])
    _close(tref.flash_attention_ref(q, k, v, causal, window),
           jref.flash_attention_ref(jq, jk, jv, causal, window), TOL["f32"])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dtypes_match_jax(dtype):
    (jq, jk, jv), (q, k, v) = _qkv(2, 1, 128, 128, 2, 2, 64, dtype)
    got = ops.flash_attention(q, k, v, block_q=64, block_k=64)
    assert got.dtype == q.dtype
    want = jops.flash_attention(jq, jk, jv, block_q=64, block_k=64,
                                interpret=True)
    _close(got, want, TOL[dtype])
    _close(got, jref.flash_attention_ref(jq, jk, jv), TOL[dtype])
    _close(tref.flash_attention_ref(q, k, v),
           jref.flash_attention_ref(jq, jk, jv), TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dit_head_dim_72_non_causal_matches_jax(dtype):
    """DiT-XL/2's attention: full (non-causal), H = KH, head dim 72
    (1152 / 16), against the Pallas kernel in interpret mode and the
    reference's oracle at a small S with a ragged last block."""
    (jq, jk, jv), (q, k, v) = _qkv(9, 2, 96, 96, 4, 4, 72, dtype)
    got = ops.flash_attention(q, k, v, causal=False, block_q=32,
                              block_k=32)
    _close(got, jops.flash_attention(jq, jk, jv, causal=False, block_q=32,
                                     block_k=32, interpret=True),
           TOL[dtype])
    _close(got, jref.flash_attention_ref(jq, jk, jv, False), TOL[dtype])
    assert fa.body_for(q.dtype, 72) == ("mma" if dtype == "bf16" else "fma")


@pytest.mark.parametrize("Sq,Skv,causal,window", [(64, 128, True, None),
                                                  (128, 64, True, None),
                                                  (64, 128, False, 40),
                                                  (128, 64, True, 24)])
def test_unequal_lengths_match_jax(Sq, Skv, causal, window):
    (jq, jk, jv), (q, k, v) = _qkv(3, 1, Sq, Skv, 4, 2, 16)
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              block_q=32, block_k=32)
    _close(got, jops.flash_attention(jq, jk, jv, causal=causal,
                                     window=window, block_q=32, block_k=32,
                                     interpret=True), TOL["f32"])
    _close(got, jref.flash_attention_ref(jq, jk, jv, causal, window),
           TOL["f32"])


def test_causal_mask_is_top_left_aligned():
    """Query i sees keys 0..i whatever Sq and Skv are: row 0 returns v[0]
    exactly, and rows at or past Skv see every key."""
    _, (q, k, v) = _qkv(4, 1, 96, 48, 2, 1, 16)
    out = fa.flash_attention(q, k, v, causal=True)
    full = fa.flash_attention(q, k, v, causal=False)
    torch.testing.assert_close(out[0, 0], v[0, 0].expand(2, 16), rtol=0,
                               atol=0)
    torch.testing.assert_close(out[0, 47:], full[0, 47:], rtol=1e-6,
                               atol=1e-6)


def test_rows_with_an_empty_window_attend_uniformly():
    """A window past the last key hides every key from the late rows;
    like the reference's oracle, they average all of V."""
    (jq, jk, jv), (q, k, v) = _qkv(5, 1, 100, 40, 2, 1, 16)
    out = fa.flash_attention(q, k, v, causal=True, window=16)
    _close(out, jref.flash_attention_ref(jq, jk, jv, True, 16), TOL["f32"])
    torch.testing.assert_close(out[0, 60:, 1],
                               v[0, :, 0].mean(0).expand(40, 16),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind,window", [("causal", None), ("sliding", 24),
                                         ("full", None)])
def test_plain_matches_port_dense_attention(dtype, kind, window):
    """The port's model prefill attention at positions arange(S) computes
    the same function (the "full" mask of DiT: kernel 12 non-causal)."""
    _, (q, k, v) = _qkv(6, 2, 64, 64, 4, 2, 32, dtype)
    pos = torch.arange(64)[None].expand(2, 64)
    got = ops.flash_attention(q, k, v, causal=kind != "full", window=window,
                              block_q=32, block_k=32)
    _close(got, dense_attention(q, k, v, pos, pos, kind, window),
           TOL[dtype])


def test_block_arguments_must_divide_as_in_the_reference():
    _, (q, k, v) = _qkv(7, 1, 96, 96, 2, 2, 16)
    ops.flash_attention(q, k, v, block_q=32, block_k=48)
    ops.flash_attention(q, k, v, block_q=256, block_k=512)  # min(block, S)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, block_q=64)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, block_k=40)


def test_cpu_calls_launch_nothing_and_devices_must_agree():
    _, (q, k, v) = _qkv(8, 1, 32, 32, 2, 1, 16)
    before = launch_counts()
    ops.flash_attention(q, k, v)
    assert launch_counts() == before
    with pytest.raises(ValueError):
        fa.flash_attention(q, k.to("meta"), v)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, window=0)
