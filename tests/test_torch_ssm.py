"""The port's Mamba-2 block (``repro_torch/models/ssm.py``) against the
JAX reference (``repro.models.ssm``), on the CPU.

Inputs are numpy arrays from a seed handed to both sides; weights come
from the reference's ``mamba2_init`` through numpy (bf16 bit for bit).
Tolerances, with their reasons:

* ``_causal_conv`` in f32: 1e-6 of the largest output (the same sums in
  the same order; silu's exp may differ by an ulp between XLA and torch);
  in bf16 one bf16 step of the element (2**-8 relative) plus 2**-8 of the
  largest output: every product, sum, bias add and silu step is rounded
  to bf16 on both sides in the reference's order, and an exp an ulp apart
  can move one rounding.
* the scan (``ssd_scan_plain`` from an initial state) against
  ``ssd_chunked``: 2e-4, the reference kernel tests' tolerance for y and
  the final state (f32 products summed in another order).
* ``mamba2_apply``: 2e-2 of the largest |output| on the bf16 block output
  (the in-projection and out-projection round to bf16, the gated rmsnorm
  runs in bf16; one rounding moves an element by up to 2**-8 of itself,
  and several such steps compound); the f32 state and the decode
  recurrence 1e-3 of the largest |state| (it is built from bf16 b, c and
  x that can sit one rounding apart); the conv tail bitwise (a copy of the
  in-projection's bf16 output, which both sides round alike) or within
  one bf16 step where the two in-projections round apart; the index
  exactly.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm

from repro_torch.convert import to_torch
from repro_torch.kernels import launch_counts
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models import ssm
from torch_parity import rng, t, to_np

SCAN_TOL = 2e-4
CFG = ssm.SSMConfig(state_dim=8, head_dim=16, expand=2, conv_kernel=4,
                    chunk=8)
JCFG = jssm.SSMConfig(state_dim=8, head_dim=16, expand=2, conv_kernel=4,
                      chunk=8)
D = 32


def _rel(got, want, rel, what=""):
    got, want = to_np(got), np.asarray(to_np(want), np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (what, err,
                                             np.abs(want).max())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_matches_reference(dtype, with_tail):
    r = rng(1)
    B, S, C, K = 2, 11, 24, 4
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    x = r.standard_normal((B, S, C)).astype(np.float32)
    w = (0.5 * r.standard_normal((K, C))).astype(np.float32)
    b = (0.1 * r.standard_normal(C)).astype(np.float32)
    tail = r.standard_normal((B, K - 1, C)).astype(np.float32)
    jt = jnp.asarray(tail, jdt) if with_tail else None
    want = jssm._causal_conv(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                             jnp.asarray(b, jdt), jt)
    got = ssm._causal_conv(t(x, tdt), t(w, tdt), t(b, tdt),
                           t(tail, tdt) if with_tail else None)
    assert got.dtype == tdt
    g, wv = to_np(got), np.asarray(to_np(want), np.float32)
    top = np.abs(wv).max()
    if dtype == "f32":
        np.testing.assert_allclose(g, wv, rtol=0, atol=1e-6 * top)
    else:
        np.testing.assert_allclose(g, wv, rtol=2 ** -8, atol=2 ** -8 * top)


def test_softplus_is_logaddexp_without_a_cutoff():
    x = np.array([-80.0, -20.0, -1.0, 0.0, 0.5, 19.0, 21.0, 30.0, 90.0],
                 np.float32)
    got = to_np(ssm.softplus(t(x)))
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _scan_inputs(seed, B, S, H, G, P, N):
    r = rng(seed)
    dt = r.uniform(1e-3, 1e-1, (B, S, H)).astype(np.float32)
    x = (dt[..., None] * r.standard_normal((B, S, H, P))).astype(np.float32)
    la = (-dt * r.uniform(1, 16, H)).astype(np.float32)
    b = r.standard_normal((B, S, G, N)).astype(np.float32)
    c = r.standard_normal((B, S, G, N)).astype(np.float32)
    h0 = r.standard_normal((B, H, P, N)).astype(np.float32)
    return x, la, b, c, h0


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("with_h0", [False, True])
def test_scan_plain_from_initial_state_matches_ssd_chunked(G, with_h0):
    """The model layout ([B, S, H, P], b and c per group) from ``h0``."""
    x, la, b, c, h0 = _scan_inputs(2, 2, 48, 4, G, 8, 4)
    jy, jh = jssm.ssd_chunked(*(jnp.asarray(a) for a in (x, la, b, c)), 16,
                              jnp.asarray(h0) if with_h0 else None)
    y, h = ss.ssd_scan_plain(t(x), t(la), t(b), t(c), 16,
                             t(h0) if with_h0 else None)
    for got, want in ((y, jy), (h, jh)):
        np.testing.assert_allclose(to_np(got), np.asarray(want),
                                   rtol=SCAN_TOL, atol=SCAN_TOL)


def test_scan_ragged_last_chunk_equals_the_padded_reference():
    """S = 45 at chunk 16: the port's last chunk is 13 long; the
    reference pads x, log_a, b and c with zeros to 48, which changes
    nothing."""
    x, la, b, c, h0 = _scan_inputs(3, 1, 45, 4, 1, 8, 4)

    def pad(a):
        return np.pad(a, [(0, 0), (0, 3)] + [(0, 0)] * (a.ndim - 2))
    jy, jh = jssm.ssd_chunked(*(jnp.asarray(pad(a)) for a in (x, la, b, c)),
                              16, jnp.asarray(h0))
    before = launch_counts()
    y, h = ss.ssd_scan(t(x), t(la), t(b), t(c), 16, t(h0))
    assert launch_counts() == before          # CPU tensors: plain version
    np.testing.assert_allclose(to_np(y), np.asarray(jy)[:, :45],
                               rtol=SCAN_TOL, atol=SCAN_TOL)
    np.testing.assert_allclose(to_np(h), np.asarray(jh), rtol=SCAN_TOL,
                               atol=SCAN_TOL)


def test_scan_flat_layout_with_h0_equals_model_layout():
    """The ops layout ([BH, S, P], b and c per row) and the model layout
    are one function: heads flattened, b and c repeated per head."""
    x, la, b, c, h0 = _scan_inputs(4, 2, 40, 4, 2, 8, 4)
    y, h = ss.ssd_scan(t(x), t(la), t(b), t(c), 16, t(h0))
    B, S, H, P = x.shape
    flat = x.transpose(0, 2, 1, 3).reshape(B * H, S, P)
    bf = np.repeat(b, 2, 2).transpose(0, 2, 1, 3).reshape(B * H, S, -1)
    cf = np.repeat(c, 2, 2).transpose(0, 2, 1, 3).reshape(B * H, S, -1)
    yf, hf = ss.ssd_scan(t(flat), t(la.transpose(0, 2, 1).reshape(B * H, S)),
                         t(bf), t(cf), 16, t(h0.reshape(B * H, P, -1)))
    np.testing.assert_array_equal(
        to_np(yf).reshape(B, H, S, P).transpose(0, 2, 1, 3), to_np(y))
    np.testing.assert_array_equal(to_np(hf).reshape(h.shape), to_np(h))


def test_scan_refuses_shapes_that_do_not_fit():
    x, la, b, c, h0 = (t(a) for a in _scan_inputs(5, 1, 16, 4, 1, 8, 4))
    for args in ((x, la[:, :8], b, c, 8, None), (x, la, b, c, 8, h0[:, :2]),
                 (x, la, t(np.zeros((1, 16, 3, 4), np.float32)),
                  t(np.zeros((1, 16, 3, 4), np.float32)), 8, None),
                 (x[0], la, b, c, 8, None)):
        with pytest.raises(ValueError):
            ss.ssd_scan(*args)


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------
def _block():
    """(reference params, port Mamba2) with the reference's init."""
    params = jax.tree.map(lambda p: p.value, jssm.mamba2_init(
        jax.random.PRNGKey(7), D, JCFG),
        is_leaf=lambda p: hasattr(p, "axes"))
    # a nonzero conv bias and dt bias reach more of the arithmetic
    r = rng(8)
    params["conv_b"] = jnp.asarray(
        0.1 * r.standard_normal(params["conv_b"].shape), jnp.bfloat16)
    params["dt_bias"] = jnp.asarray(
        0.5 * r.standard_normal(params["dt_bias"].shape), jnp.float32)
    m = ssm.Mamba2(D, CFG, torch.bfloat16, "cpu")
    with torch.no_grad():
        for name, leaf in params.items():
            if name == "norm":
                m.norm.scale.copy_(to_torch(np.asarray(leaf["scale"]), "cpu"))
            else:
                getattr(m, name).copy_(to_torch(np.asarray(leaf), "cpu"))
    return params, m


def _x(seed, B, S):
    return rng(seed).standard_normal((B, S, D)).astype(np.float32)


def _jcache(B, seed=None):
    c = jssm.init_ssm_cache(B, D, JCFG)
    if seed is None:
        return c
    r = rng(seed)
    return {"conv": jnp.asarray(r.standard_normal(c["conv"].shape),
                                jnp.bfloat16),
            "ssm": jnp.asarray(0.3 * r.standard_normal(c["ssm"].shape),
                               jnp.float32),
            "index": jnp.asarray(r.integers(0, 50, c["index"].shape),
                                 jnp.int32)}


def _port_cache(jc):
    return {k: to_torch(np.asarray(v), "cpu") for k, v in jc.items()}


def _check_cache(got, want):
    np.testing.assert_array_equal(to_np(got["index"]),
                                  np.asarray(want["index"]))
    tail_g = to_np(got["conv"])
    tail_w = np.asarray(to_np(want["conv"]), np.float32)
    np.testing.assert_allclose(tail_g, tail_w, rtol=2 ** -8, atol=0)
    _rel(got["ssm"], want["ssm"], 1e-3, "state")


def test_init_follows_mamba2_init():
    m = ssm.Mamba2(D, CFG, torch.bfloat16, "cpu")
    m.init_(torch.Generator().manual_seed(0))
    H = CFG.n_heads(D)
    torch.testing.assert_close(m.a_log, torch.log(torch.arange(
        1, H + 1, dtype=torch.float32)))
    assert bool((m.d_skip == 1).all()) and bool((m.norm.scale == 1).all())
    assert bool((m.dt_bias == 0).all()) and bool((m.conv_b == 0).all())
    assert float(m.conv_w.float().abs().max()) <= 0.2
    assert m.in_proj.shape == (D, 2 * 64 + 2 * 8 + H)
    assert m.out_proj.shape == (64, D)


@pytest.mark.parametrize("S", [13, 16])
def test_apply_without_cache_matches_reference(S):
    params, m = _block()
    x = _x(10, 2, S)
    want, _ = jssm.mamba2_apply(params, jnp.asarray(x, jnp.bfloat16), JCFG)
    got = ssm.mamba2_apply(m, t(x, torch.bfloat16), CFG)
    assert got.dtype == torch.bfloat16
    _rel(got, want, 2e-2, "out")


@pytest.mark.parametrize("cache_seed", [None, 11])
def test_prefill_with_cache_matches_reference(cache_seed):
    """S = 13 (not a multiple of the chunk, 8) from a zero cache and from
    a nonzero one (state, conv tail and index): the output and the
    updated cache, written in place."""
    params, m = _block()
    x = _x(12, 2, 13)
    jc = _jcache(2, cache_seed)
    want, jnew = jssm.mamba2_apply(params, jnp.asarray(x, jnp.bfloat16),
                                   JCFG, cache=jc)
    cache = _port_cache(jc)
    views = dict(cache)
    got = ssm.mamba2_apply(m, t(x, torch.bfloat16), CFG, cache=cache)
    _rel(got, want, 2e-2, "out")
    _check_cache(cache, jnew)
    assert all(cache[k] is views[k] for k in cache)    # updated in place


def test_stepwise_decode_matches_reference():
    """A 13-token prefill, then 5 single-token decode steps (the O(1)
    recurrence) on both sides, each fed the same next input."""
    params, m = _block()
    x = _x(13, 2, 18)
    jc = _jcache(2)
    cache = _port_cache(jc)
    want, jc = jssm.mamba2_apply(params, jnp.asarray(x[:, :13],
                                                     jnp.bfloat16),
                                 JCFG, cache=jc)
    got = ssm.mamba2_apply(m, t(x[:, :13], torch.bfloat16), CFG, cache)
    _rel(got, want, 2e-2, "prefill")
    for s in range(13, 18):
        want, jc = jssm.mamba2_apply(params, jnp.asarray(x[:, s:s + 1],
                                                         jnp.bfloat16),
                                     JCFG, cache=jc)
        got = ssm.mamba2_apply(m, t(x[:, s:s + 1], torch.bfloat16), CFG,
                               cache)
        _rel(got, want, 2e-2, f"decode {s}")
        _check_cache(cache, jc)
    assert to_np(cache["index"]).tolist() == [18, 18]


def test_prefill_split_equals_whole_within_the_scan_tolerance():
    """The initial state carries a prefill across a split: 13 tokens then
    7 from the cache give the state and outputs of 20 at once (the port
    against itself, the chunk boundaries falling elsewhere)."""
    _, m = _block()
    x = t(_x(14, 1, 20), torch.bfloat16)
    whole = ssm.init_ssm_cache(1, D, CFG)
    a = ssm.mamba2_apply(m, x, CFG, whole)
    split = ssm.init_ssm_cache(1, D, CFG)
    b1 = ssm.mamba2_apply(m, x[:, :13], CFG, split)
    b2 = ssm.mamba2_apply(m, x[:, 13:], CFG, split)
    _rel(torch.cat([b1, b2], 1), a, 2e-2, "out")
    _rel(split["ssm"], whole["ssm"], SCAN_TOL, "state")
    assert torch.equal(split["conv"], whole["conv"])
    assert torch.equal(split["index"], whole["index"])
