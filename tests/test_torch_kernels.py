"""The port's kernel modules against the JAX reference, on the CPU.

Each ported kernel's plain version (what a CUDA wrapper runs for CPU
tensors) is held against the JAX kernel run through
``repro.kernels.ops`` / ``repro.kernels.cim_gemm`` in interpret mode and
against ``repro.kernels.ref``, on the same numpy inputs.  Integer
outputs (int8 codes) must be exact; float outputs carry
``RTOL = 1e-6`` relative to the output's largest magnitude: the int32
accumulators are exact on both sides and the epilogues round in the
same order, so only XLA's and torch's elementwise kernels (tanh, exp)
may differ by an ulp.  Attention allows ``ATTN_TOL = 1e-5`` (summation
order of the softmax and the PV product).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import cim_gemm as jcg
from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.kernels import _build, launch_counts
from repro_torch.kernels import cim_gemm as cg
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from torch_parity import rng, t, to_np

RTOL = 1e-6
ATTN_TOL = 1e-5


def close(a, b, rtol=RTOL):
    a, b = to_np(a), to_np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.abs(b).max()), 1e-30)
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * scale)


def exact(a, b):
    np.testing.assert_array_equal(to_np(a), to_np(b))


def _w(r, K, N):
    return (r.integers(-127, 128, (K, N)).astype(np.int8),
            r.uniform(1e-3, 2e-2, N).astype(np.float32))


def _x(r, M, K, dtype):
    x = r.standard_normal((M, K)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bf16"
                               else jnp.float32)
    tx = t(x, torch.bfloat16 if dtype == "bf16" else torch.float32)
    return jx, tx


# ---------------------------------------------------------------------------
# kernel 1: row quantizer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("M,K,dtype", [(8, 64, "f32"), (5, 200, "bf16"),
                                       (3, 1024, "f32")])
def test_quantize_rows_matches_jax(M, K, dtype):
    jx, tx = _x(rng(1), M, K, dtype)
    jq, js = jops.quantize_rows_int8(jx, interpret=True)
    rq, rs = jref.quantize_rows_int8_ref(jx)
    q, s = cg.quantize_rows_int8(tx)
    exact(q, jq)
    exact(q, rq)
    exact(s, rs)
    # XLA folds the interpreted kernel's division by 127 into a multiply
    # by the reciprocal, one ulp off its own oracle; the port divides
    np.testing.assert_allclose(to_np(s), to_np(js), rtol=2e-7, atol=0)


def test_quantize_weights_bitwise():
    w = rng(2).standard_normal((96, 40)).astype(np.float32) * 0.1
    jq, js = jops.quantize_weights_int8(jnp.asarray(w))
    q, s = ops.quantize_weights_int8(t(w))
    exact(q, jq)
    exact(s, js)


# ---------------------------------------------------------------------------
# kernel 2: quantize-in GEMM
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("act", [None, "gelu", "silu", "relu"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_qin_matches_jax(act, dtype):
    r = rng(3)
    jx, tx = _x(r, 8, 128, dtype)
    w, ws = _w(r, 128, 96)
    b = r.standard_normal(96).astype(np.float32)
    res = r.standard_normal((8, 96)).astype(np.float32)
    want = jops.cim_quantized_matmul_fused(
        jx, jnp.asarray(w), jnp.asarray(ws), bias=jnp.asarray(b),
        residual=jnp.asarray(res), activation=act, interpret=True)
    oracle = jref.fused_matmul_ref(jx, jnp.asarray(w), jnp.asarray(ws),
                                   bias=jnp.asarray(b),
                                   residual=jnp.asarray(res),
                                   activation=act)
    got = cg.cim_gemm_int8_fused_qin(tx, t(w), t(ws), bias=t(b),
                                     residual=t(res), activation=act)
    assert got.dtype == torch.float32
    close(got, want)
    close(got, oracle)


# ---------------------------------------------------------------------------
# kernel 3: pre-quantized GEMM (+ requant epilogue)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("quantize_out", [False, True])
def test_fused_matches_jax(quantize_out):
    r = rng(4)
    M, K, N = 8, 256, 128
    xq = r.integers(-127, 128, (M, K)).astype(np.int8)
    xs = r.uniform(1e-3, 1e-2, (M, 1)).astype(np.float32)
    w, ws = _w(r, K, N)
    res = None if quantize_out else r.standard_normal((M, N)).astype(
        np.float32)
    want = jcg.cim_gemm_int8_fused(
        jnp.asarray(xq), jnp.asarray(w), jnp.asarray(xs),
        jnp.asarray(ws)[None, :],
        residual=None if res is None else jnp.asarray(res),
        activation="gelu" if quantize_out else None,
        quantize_out=quantize_out, interpret=True)
    got = cg.cim_gemm_int8_fused(
        t(xq), t(w), t(xs), t(ws), residual=None if res is None else t(res),
        activation="gelu" if quantize_out else None,
        quantize_out=quantize_out)
    if quantize_out:
        # the requant of an activation: codes move at most one step where
        # an ulp of GELU crosses a rounding tie
        assert np.abs(to_np(got[0]).astype(int)
                      - to_np(want[0]).astype(int)).max() <= 1
        close(got[1], want[1])
    else:
        close(got, want)
    acc = tref.cim_gemm_int8_ref(t(xq), t(w))
    exact(acc, jref.cim_gemm_int8_ref(jnp.asarray(xq), jnp.asarray(w)))


# ---------------------------------------------------------------------------
# kernel 4: gated GEMM
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_gated_matches_jax(act):
    r = rng(5)
    M, K, N = 8, 128, 256
    xq = r.integers(-127, 128, (M, K)).astype(np.int8)
    xs = r.uniform(1e-3, 1e-2, (M, 1)).astype(np.float32)
    (wg, gs), (wu, us) = _w(r, K, N), _w(r, K, N)
    want = jcg.cim_gated_gemm_int8(
        jnp.asarray(xq), jnp.asarray(wg), jnp.asarray(wu), jnp.asarray(xs),
        jnp.asarray(gs)[None, :], jnp.asarray(us)[None, :], activation=act,
        interpret=True)
    got = cg.cim_gated_gemm_int8(t(xq), t(wg), t(wu), t(xs), t(gs), t(us),
                                 activation=act)
    close(got, want)


# ---------------------------------------------------------------------------
# the MLP pipeline and its dispatch rules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d_ff", [128, 8320])
def test_quantized_mlp_matches_jax_oracle(d_ff):
    """d_ff = 8320 > MAX_FUSED_QUANT_N takes the separate-requant branch;
    both branches give the reference oracle's result."""
    r = rng(6)
    jx, tx = _x(r, 4, 64, "bf16")
    (g, gs), (u, us), (d, ds) = _w(r, 64, d_ff), _w(r, 64, d_ff), \
        _w(r, d_ff, 64)
    res = r.standard_normal((4, 64)).astype(np.float32)
    qtree = {"gate": (jnp.asarray(g), jnp.asarray(gs)),
             "up": (jnp.asarray(u), jnp.asarray(us)),
             "down": (jnp.asarray(d), jnp.asarray(ds))}
    want = jref.quantized_mlp_ref(jx, qtree, "gelu",
                                  residual=jnp.asarray(res))
    got = ops.cim_quantized_mlp(tx, t(u), t(us), t(d), t(ds), gate_q=t(g),
                                gate_scale=t(gs), residual=t(res),
                                activation="gelu")
    close(got, want, rtol=1e-5)


def test_quantized_mlp_matches_jax_kernel_pipeline():
    r = rng(7)
    jx, tx = _x(r, 8, 64, "f32")
    (g, gs), (u, us), (d, ds) = _w(r, 64, 128), _w(r, 64, 128), \
        _w(r, 128, 64)
    want = jops.cim_quantized_mlp(
        jx, jnp.asarray(u), jnp.asarray(us), jnp.asarray(d),
        jnp.asarray(ds), gate_q=jnp.asarray(g), gate_scale=jnp.asarray(gs),
        activation="gelu", interpret=True)
    got = ops.cim_quantized_mlp(tx, t(u), t(us), t(d), t(ds), gate_q=t(g),
                                gate_scale=t(gs), activation="gelu")
    close(got, want, rtol=1e-5)


class _Spy:
    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("quantize_rows_int8", "cim_gemm_int8_fused_qin",
                     "cim_gemm_int8_fused", "cim_gated_gemm_int8"):
            fn = getattr(ops, name)
            monkeypatch.setattr(ops, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def spy(*a, **kw):
            self.calls.append((name, kw.get("quantize_out", False)))
            return fn(*a, **kw)
        return spy


@pytest.mark.parametrize("d_ff,expect", [
    (128, [("quantize_rows_int8", False), ("cim_gated_gemm_int8", True),
           ("cim_gemm_int8_fused", False)]),
    (8196, [("quantize_rows_int8", False), ("cim_gated_gemm_int8", False),
            ("quantize_rows_int8", False), ("cim_gemm_int8_fused", False)]),
])
def test_mlp_dispatch_rule(monkeypatch, d_ff, expect):
    """d_ff > MAX_FUSED_QUANT_N re-quantizes the hidden state with its own
    launch (gemma-2b: 4 launches per MLP); narrower MLPs fuse it."""
    spy = _Spy(monkeypatch)
    r = rng(8)
    (g, gs), (u, us), (d, ds) = _w(r, 32, d_ff), _w(r, 32, d_ff), \
        _w(r, d_ff, 32)
    ops.cim_quantized_mlp(t(r.standard_normal((2, 32)).astype(np.float32)),
                          t(u), t(us), t(d), t(ds), gate_q=t(g),
                          gate_scale=t(gs))
    assert spy.calls == expect


@pytest.mark.parametrize("K,expect", [
    (4096, [("cim_gemm_int8_fused_qin", False)]),
    (4100, [("quantize_rows_int8", False), ("cim_gemm_int8_fused", False)]),
])
def test_matmul_dispatch_rule(monkeypatch, K, expect):
    """K <= MAX_FUSED_QUANT_K quantizes inside the GEMM (one launch)."""
    spy = _Spy(monkeypatch)
    r = rng(9)
    w, ws = _w(r, K, 8)
    out = ops.cim_quantized_matmul_fused(
        t(r.standard_normal((2, K)).astype(np.float32)), t(w), t(ws))
    assert spy.calls == expect and out.shape == (2, 8)


# ---------------------------------------------------------------------------
# kernel 5: flash-decode
# ---------------------------------------------------------------------------
def _decode_case(r, B, S, KH, G, D, quantized, fill):
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
    pos = np.full((B, S), 2 ** 30, np.int32)
    for b, n in enumerate(fill):
        pos[b, :n] = r.permutation(n)
    qp = np.array([max(n - 1, 0) for n in fill], np.int32)
    return q, k, v, pos, qp, ks, vs


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_matches_jax(quantized, window):
    r = rng(10)
    args = _decode_case(r, 3, 64, 1, 4, 16, quantized, [64, 20, 7])
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    q, k, v, pos, qp, ks, vs = jargs
    want = jops.decode_attention(q, k, v, pos, qp, k_scale=ks, v_scale=vs,
                                 window=window, block_k=16, interpret=True)
    oracle = jref.decode_attention_ref(q, k, v, pos, qp, window=window,
                                       k_scale=ks, v_scale=vs)
    targs = [None if a is None else t(a) for a in args]
    got = da.decode_attention(*targs, window=window)
    close(got, want, rtol=ATTN_TOL)
    close(got, oracle, rtol=ATTN_TOL)


def test_decode_attention_all_empty_row_is_uniform():
    """A row with no visible slot gets the uniform softmax, as the
    reference's keep-list exception makes its kernel do."""
    r = rng(11)
    q, k, v, pos, qp, ks, vs = _decode_case(r, 2, 32, 1, 2, 16, True,
                                            [0, 10])
    got = to_np(da.decode_attention(t(q), t(k), t(v), t(pos), t(qp), t(ks),
                                    t(vs)))
    mean_v = (v[0].astype(np.float32) * vs[0][..., None]).mean(0)
    np.testing.assert_allclose(got[0, 0], np.broadcast_to(mean_v[0],
                                                          (2, 16)),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the plain gelu against an f64 gelu
# ---------------------------------------------------------------------------
def _saturating_tanh(real):
    """torch.tanh as some runs computed it on f32: exactly +-1 from
    |y| >= 4.5 on (true tanh(5) = 1 - 9.1e-5); other dtypes as they are."""
    def tanh(y, *args, **kwargs):
        out = real(y, *args, **kwargs)
        if y.dtype == torch.float32:
            out = torch.where(y.abs() >= 4.5, torch.sign(y), out)
        return out
    return tanh


@pytest.mark.parametrize("f32_tanh", ["torch", "saturating"])
def test_plain_gelu_within_two_ulp_of_f64(monkeypatch, f32_tanh):
    """The plain gelu on f32 x within 2 ulp of |x| of the gelu computed
    in f64 (gelu(x) = x cdf with cdf in [0, 1], so one ulp of the f32 cdf
    moves the output by at most ulp(x)), at arguments whose tanh argument
    straddles +-5 and at a spread of others; also with an f32 tanh that
    saturates near +-5, which the plain gelu must not depend on."""
    if f32_tanh == "saturating":
        monkeypatch.setattr(torch, "tanh", _saturating_tanh(torch.tanh))
    c = np.sqrt(2.0 / np.pi)
    near = np.linspace(3.5, 4.1, 20001)
    x = np.concatenate([near, -near, np.linspace(-8.0, 8.0, 20001),
                        np.logspace(-6, 1.5, 2001),
                        -np.logspace(-6, 1.5, 2001)]).astype(np.float32)
    d = x.astype(np.float64)
    inner = c * (d + 0.044715 * d ** 3)
    assert inner[:near.size].min() < 5 < inner[:near.size].max()
    assert inner[near.size:2 * near.size].min() < -5 \
        < inner[near.size:2 * near.size].max()
    want = d * 0.5 * (1.0 + np.tanh(inner))
    got = to_np(tref.gelu_tanh(t(x))).astype(np.float64)
    ulps = np.abs(got - want) / np.spacing(np.abs(x))
    assert ulps.max() <= 2.0, (x[ulps.argmax()], ulps.max())


# ---------------------------------------------------------------------------
# wrappers: device dispatch, counters, build flags
# ---------------------------------------------------------------------------
def test_cpu_calls_launch_nothing():
    before = launch_counts()
    cg.quantize_rows_int8(torch.ones((2, 8)))
    assert launch_counts() == before


@pytest.mark.parametrize("make", [
    lambda: cg.quantize_rows_int8(torch.ones((2, 8), device="meta")),
    lambda: cg.cim_gemm_int8_fused_qin(
        torch.ones((2, 8)), torch.ones((8, 4), dtype=torch.int8,
                                       device="meta"), torch.ones(4)),
])
def test_wrappers_refuse_other_devices(make):
    """No silent CPU fallback: a tensor that is neither all-CPU nor
    all-CUDA raises instead of taking the plain version."""
    with pytest.raises(ValueError):
        make()


def test_build_flags_target_hopper_without_fast_math():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert {p.name for p in _build.sources()} == {
        "cim_gemm.cu", "decode_attention.cu", "flash_attention.cu",
        "online_softmax.cu", "ssd_scan.cu"}
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch")
