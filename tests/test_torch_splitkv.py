"""The port's split-KV decode (partial walk + combine) against the JAX
reference, on the CPU.

The plain split version (what the CUDA wrappers run for CPU tensors) is
held against ``repro.kernels.ops.decode_attention_splitkv`` run in
interpret mode, as the JAX package's own tests run it, and against
``repro.kernels.ref.decode_attention_ref``.  At the shapes used here the
reference's 64-slot blocks split exactly where the port's 64-slot steps
do, so both sides cut the cache in the same places.  Tolerance:
``ATTN_TOL = 1e-5`` of the output's largest magnitude (summation order
of the softmax, the PV product and the combine).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import launch_counts, ops
from repro_torch.kernels import ref as tref
from torch_parity import rng, t, to_np

ATTN_TOL = 1e-5
EMPTY = 2 ** 30


def close(a, b, rtol=ATTN_TOL):
    a, b = to_np(a), to_np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.abs(b).max()), 1e-30)
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * scale)


def _case(seed, B, S, KH, G, D, quantized, fill):
    """Ring-cache inputs; row b holds positions 0..fill[b]-1 in a
    shuffled order, the rest of the row is empty."""
    r = rng(seed)
    q = r.standard_normal((B, KH, G, D)).astype(np.float32)
    if quantized:
        k = r.integers(-127, 128, (B, S, KH, D)).astype(np.int8)
        v = r.integers(-127, 128, (B, S, KH, D)).astype(np.int8)
        ks = r.uniform(1e-3, 2e-2, (B, S, KH)).astype(np.float32)
        vs = r.uniform(1e-3, 2e-2, (B, S, KH)).astype(np.float32)
    else:
        k = r.standard_normal((B, S, KH, D)).astype(np.float32)
        v = r.standard_normal((B, S, KH, D)).astype(np.float32)
        ks = vs = None
    pos = np.full((B, S), EMPTY, np.int32)
    for b, n in enumerate(fill):
        pos[b, :n] = r.permutation(n)
    qp = np.array([max(n - 1, 0) for n in fill], np.int32)
    return q, k, v, pos, qp, ks, vs


def _both(args):
    return ([None if a is None else jnp.asarray(a) for a in args],
            [None if a is None else t(a) for a in args])


# fill: a full row, a row visible only in the first split, a single-token
# row and an all-empty row
FILL = [256, 20, 1, 0]


@pytest.mark.parametrize("n_splits", [1, 2, 4])
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("window", [None, 9])
def test_splitkv_plain_matches_jax(n_splits, quantized, window):
    args = _case(20, 4, 256, 2, 4, 16, quantized, FILL)
    (q, k, v, pos, qp, ks, vs), targs = _both(args)
    want = jops.decode_attention_splitkv(
        q, k, v, pos, qp, k_scale=ks, v_scale=vs, window=window,
        block_k=64, n_splits=n_splits, interpret=True)
    oracle = jref.decode_attention_ref(q, k, v, pos, qp, window=window,
                                       k_scale=ks, v_scale=vs)
    got = ops.decode_attention_splitkv(*targs, window=window,
                                       n_splits=n_splits)
    assert got.dtype == torch.float32 and got.shape == (4, 2, 4, 16)
    close(got, want)
    close(got, oracle)


def test_ops_decode_attention_splits_above_2048(monkeypatch):
    """At S = 4096 both dispatchers take the split walk with the
    reference's count (2) and agree within ATTN_TOL."""
    calls = []
    real = da.decode_attention_partial

    def spy(*a, **kw):
        calls.append(kw["n_splits"])
        return real(*a, **kw)
    monkeypatch.setattr(da, "decode_attention_partial", spy)
    args = _case(21, 3, 4096, 1, 4, 16, True, [4096, 3000, 700])
    (q, k, v, pos, qp, ks, vs), targs = _both(args)
    want = jops.decode_attention(q, k, v, pos, qp, k_scale=ks, v_scale=vs,
                                 interpret=True)
    got = ops.decode_attention(*targs)
    assert calls == [2]
    close(got, want)
    close(got, jref.decode_attention_ref(q, k, v, pos, qp, k_scale=ks,
                                         v_scale=vs))


@pytest.mark.parametrize("S,expect", [(64, 1), (2048, 1), (2049, 1),
                                      (4096, 2), (8192, 4), (10000, 4),
                                      (20000, 8), (1 << 20, 8)])
def test_split_rule_is_the_reference_rule(S, expect):
    assert ops.n_splits_for(S) == expect


@pytest.mark.parametrize("S", [1, 63, 64, 300, 4096, 5056, 8192])
@pytest.mark.parametrize("n_splits", [1, 2, 3, 4, 8])
def test_split_boundaries_fall_on_kernel_steps(S, n_splits):
    L = da.split_len(S, n_splits)
    assert L % da.SPLIT_STEP == 0
    assert n_splits * L >= S


def test_single_walk_below_threshold(monkeypatch):
    """Up to 2048 slots decode attention is one walk, as in the
    reference; n_splits=1 forces it above."""
    monkeypatch.setattr(da, "decode_attention_partial", None)
    args = _case(22, 2, 2048, 1, 2, 16, True, [2048, 5])
    got = ops.decode_attention(*[None if a is None else t(a) for a in args])
    assert got.shape == (2, 1, 2, 16)
    args = _case(23, 2, 2112, 1, 2, 16, True, [2112, 5])
    ops.decode_attention(*[None if a is None else t(a) for a in args],
                         n_splits=1)


def test_partial_states_of_dead_and_empty_rows():
    """A split with no visible slot in a row that has some emits
    (o, m, l) = (0, -1e30, 0); a row with no visible slot at all attends
    uniformly, so each split holds m = -1e30 and l = its slot count."""
    args = _case(24, 2, 192, 1, 2, 8, True, [30, 0])
    targs = [None if a is None else t(a) for a in args]
    o, m, l = da.decode_attention_partial(*targs, n_splits=3)
    assert o.shape == (2, 1, 3, 2, 8) and m.shape == l.shape == (2, 1, 3, 2, 1)
    assert (m[0, :, 1:] == tref.NEG_INF).all() and (l[0, :, 1:] == 0).all()
    assert (o[0, :, 1:] == 0).all() and (m[0, :, 0] > tref.NEG_INF).all()
    assert (m[1] == tref.NEG_INF).all()
    torch.testing.assert_close(l[1], torch.full_like(l[1], 64.0))
    # the combine of those states is the reference's uniform softmax
    q, k, v, pos, qp, ks, vs = args
    got = to_np(da.decode_attention_combine(o, m, l, torch.float32))
    mean_v = (v[1].astype(np.float32) * vs[1][..., None]).mean(0)
    np.testing.assert_allclose(got[1, 0], np.broadcast_to(mean_v[0], (2, 8)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_splits", [1, 3])
def test_empty_splits_are_neutral(n_splits):
    """More splits than steps: the splits past the cache are empty and
    leave the result unchanged."""
    args = _case(25, 2, 100, 2, 2, 16, False, [100, 40])
    targs = [None if a is None else t(a) for a in args]
    base = ops.decode_attention_splitkv(*targs, n_splits=n_splits)
    wide = ops.decode_attention_splitkv(*targs, n_splits=8)
    close(wide, base)
    o, m, l = da.decode_attention_partial(*targs, n_splits=8)
    assert (m[:, :, 2:] == tref.NEG_INF).all() and (l[:, :, 2:] == 0).all()


def test_bf16_split_close_to_single_walk():
    """A bf16 cache: the split walk in bf16 agrees with the single walk
    within one bf16 rounding of the output."""
    args = _case(26, 2, 320, 1, 4, 32, False, [320, 130])
    q, k, v, pos, qp, _, _ = [None if a is None else t(a) for a in args]
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    one = ops.decode_attention(q, k, v, pos, qp, n_splits=1)
    split = ops.decode_attention_splitkv(q, k, v, pos, qp, n_splits=3)
    assert split.dtype == torch.bfloat16
    close(split, one, rtol=2 ** -7)


def test_cpu_split_launches_nothing():
    before = launch_counts()
    args = _case(27, 1, 128, 1, 1, 8, True, [128])
    ops.decode_attention_splitkv(*[None if a is None else t(a)
                                   for a in args], n_splits=2)
    assert launch_counts() == before
