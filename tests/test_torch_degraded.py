"""Degraded mode of the port (``repro_torch.quant.degraded_mode``) against
the reference's (``tests/test_reliability.py``'s degraded-mode cases): an
inf scale, NaN or inf in the input, bias and residual, and the MoE
fallback each equal the reference's ``degraded_mode`` output, on the
pipeline (the screen and the gated plain versions, one function with the
card's kernels) and on the plain oracle; a healthy layer is bitwise the
same with the mode on and off; with the mode off the launch counts are
today's, with it on they are today's plus one screen a site and the
fallback chains (gemma-2b-smoke and qwen2-moe-a2.7b-smoke decode steps);
``degraded`` or ``fault_hook`` under tensor parallelism raises."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from repro.quant import QuantizedLinear as JQL
from repro.quant import degraded_mode as jdegraded
from repro.quant import (quantize_linear, quantize_mlp, quantize_moe_experts,
                         quantized_matmul, quantized_mlp_apply,
                         quantized_moe_apply)
from repro_torch.kernels import cim_gemm, ops
from repro_torch.quant import QuantizedLinear, QuantPlan, degraded_mode
from repro_torch.quant import linear as tlinear
from torch_parity import port_model, rng, t

# the f32 epilogues: the port's plain versions and XLA's fused
# multiply-adds round apart in the last bits
TOL = dict(rtol=1e-6, atol=1e-6)
RNG = rng(0)
W = RNG.normal(size=(64, 96)).astype(np.float32)
X = RNG.normal(size=(4, 64)).astype(np.float32)
B = RNG.normal(size=96).astype(np.float32)
R = RNG.normal(size=(4, 96)).astype(np.float32)
W_DOWN = RNG.normal(size=(96, 64)).astype(np.float32)
W_GATE = RNG.normal(size=(64, 96)).astype(np.float32)
E, K, N = 2, 32, 48
WE_UP = RNG.normal(size=(E, K, N)).astype(np.float32)
WE_GATE = RNG.normal(size=(E, K, N)).astype(np.float32)
WE_DOWN = RNG.normal(size=(E, N, K)).astype(np.float32)
XE = RNG.normal(size=(E, 4, K)).astype(np.float32)


def _ql(jql) -> QuantizedLinear:
    return QuantizedLinear(t(np.asarray(jql.q)), t(np.asarray(jql.scale)))


def _module(jtree) -> nn.Module:
    m = nn.Module()
    for k, v in jtree.items():
        if isinstance(v, JQL):
            setattr(m, k, _ql(v))
    return m


def _close(got, want, **kw):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **(kw or TOL))


def _poison(a: np.ndarray, where, value) -> np.ndarray:
    a = a.copy()
    a[where] = value
    return a


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("case", ["inf_scale", "nan_x", "inf_bias",
                                  "nan_residual"])
def test_matmul_fallback_equals_reference(case, use_kernel):
    """One corrupted operand at a time: non-finite output with the mode
    off, and with it on the reference's sanitized fallback (the poisoned
    channel or row contributes zero, the rest untouched)."""
    w = quantize_linear(jnp.asarray(W))
    q, s = np.asarray(w.q), np.asarray(w.scale)
    x, b, r = X, B, R
    if case == "inf_scale":
        s = _poison(s, 3, np.inf)
    elif case == "nan_x":
        x = _poison(X, (1, 5), np.nan)
    elif case == "inf_bias":
        b = _poison(B, 7, -np.inf)
    else:
        r = _poison(R, (2, 9), np.nan)
    jw = JQL(jnp.asarray(q), jnp.asarray(s))
    with jdegraded(True):
        want = quantized_matmul(jnp.asarray(x), jw, bias=jnp.asarray(b),
                                residual=jnp.asarray(r))
    tw = QuantizedLinear(t(q), t(s))
    plain = tlinear.quantized_matmul(t(x), tw, use_kernel=use_kernel,
                                     bias=t(b), residual=t(r))
    assert not torch.isfinite(plain).all()
    with degraded_mode(True):
        got = tlinear.quantized_matmul(t(x), tw, use_kernel=use_kernel,
                                       bias=t(b), residual=t(r))
    assert torch.isfinite(got).all()
    _close(got, want)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("gated", [True, False])
def test_mlp_fallback_equals_reference(gated, use_kernel):
    """A NaN up scale, then a NaN input on healthy weights, with and
    without the gate projection and the residual."""
    leaves = {"up": jnp.asarray(W), "down": jnp.asarray(W_DOWN)}
    if gated:
        leaves["gate"] = jnp.asarray(W_GATE)
    good = quantize_mlp(leaves)
    bad = dict(good, up=JQL(good["up"].q,
                            good["up"].scale.at[0].set(jnp.nan)))
    x_nan = _poison(X, (0, 0), np.nan)
    for tree, x, res in ((bad, X, R[:, :64]), (good, x_nan, None)):
        with jdegraded(True):
            want = quantized_mlp_apply(
                tree, jnp.asarray(x), "gelu",
                residual=None if res is None else jnp.asarray(res))
        with degraded_mode(True):
            got = tlinear.quantized_mlp_apply(
                _module(tree), t(x), "gelu", use_kernel=use_kernel,
                residual=None if res is None else t(res))
        assert torch.isfinite(got).all()
        _close(got, want)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_moe_fallback_equals_reference(use_kernel):
    """A NaN expert scale: the grouped fallback (with a skip list on the
    pipeline, which gives the reference's bits) equals the reference's."""
    qp = quantize_moe_experts({"up": jnp.asarray(WE_UP),
                               "gate": jnp.asarray(WE_GATE),
                               "down": jnp.asarray(WE_DOWN)})
    bad = dict(qp, up=JQL(qp["up"].q, qp["up"].scale.at[0, 0].set(jnp.nan)))
    with jdegraded(True):
        want = quantized_moe_apply(bad, jnp.asarray(XE), "silu")
    mod = _module(bad)
    assert not torch.isfinite(tlinear.quantized_moe_apply(
        mod, t(XE), "silu", use_kernel=use_kernel)).all()
    counts = torch.tensor([4, 4], dtype=torch.int32)
    with degraded_mode(True):
        got = tlinear.quantized_moe_apply(
            mod, t(XE), "silu", use_kernel=use_kernel,
            expert_counts=counts if use_kernel else None)
    assert torch.isfinite(got).all()
    _close(got, want)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_healthy_layer_bitwise_with_mode_on(use_kernel):
    """No NaN: the screen passes and the output is bitwise the unscreened
    one at every site, and no screen trips."""
    mlp = _module(quantize_mlp({"up": jnp.asarray(W),
                                "gate": jnp.asarray(W_GATE),
                                "down": jnp.asarray(W_DOWN)}))
    moe = _module(quantize_moe_experts({"up": jnp.asarray(WE_UP),
                                        "down": jnp.asarray(WE_DOWN)}))
    w = _ql(quantize_linear(jnp.asarray(W)))

    def run():
        return (tlinear.quantized_matmul(t(X), w, use_kernel=use_kernel,
                                         bias=t(B), residual=t(R)),
                tlinear.quantized_mlp_apply(mlp, t(X), "gelu",
                                            use_kernel=use_kernel,
                                            residual=t(X)),
                tlinear.quantized_moe_apply(moe, t(XE), "gelu",
                                            use_kernel=use_kernel))
    trips = cim_gemm.screen_trips("cpu")
    plain = run()
    with degraded_mode(True):
        screened = run()
    for a, b in zip(plain, screened):
        assert torch.equal(a, b)
    assert cim_gemm.screen_trips("cpu") == trips


# the pipeline's entry points a decode step calls (ops' own names)
PIPELINE = ("quantize_rows_int8", "cim_gemm_int8_fused_qin",
            "cim_gemm_int8_fused", "cim_gated_gemm_int8",
            "cim_grouped_gemm_int8", "cim_grouped_gated_gemm_int8",
            "finite_screen")


def _step_launches(monkeypatch, arch, degraded):
    """Pipeline calls of one decode step of ``arch``'s smoke model under
    the full plan, by name (the CPU runs the plain versions; a counting
    wrapper stands in for each launch)."""
    from repro_torch.serving import ServingEngine
    counts = dict.fromkeys(PIPELINE, 0)
    for name in PIPELINE:
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    model = port_model(QuantPlan.full(), arch)
    eng = ServingEngine(model, n_slots=2, max_len=32, prefill_bucket=8,
                        degraded=degraded)
    prompt = np.arange(1, 6, dtype=np.int32)
    toks = eng._to_host(eng._prefill_one(
        np.concatenate([prompt, np.full(3, 5, np.int32)]), 0, 5))
    before = dict(counts)
    eng.slot_last[:] = int(np.argmax(toks))
    eng._decode_all(eng.slot_last)
    return {k: counts[k] - before[k] for k in PIPELINE}, model.cfg.n_layers


@pytest.mark.parametrize("arch,off,on", [
    # per layer per decode step: QKV 1, out 1, the MLP 3 (d_ff <= 8192)
    ("gemma-2b", 5, 5 + 3 + (1 + 1 + 4)),
    # QKV 1, out 1, the experts 3 and the shared MLP 3
    ("qwen2-moe-a2.7b", 8, 8 + 4 + (1 + 1 + 4 + 4))])
def test_launches_per_layer_off_and_on(monkeypatch, arch, off, on):
    """Mode off: today's launches (the screen never runs).  Mode on: one
    screen a quantized site and its fallback chain (QKV and the
    out-projection one gated launch each, an MLP or the experts four:
    the fallback re-quantizes with the gated row quantizer)."""
    got, L = _step_launches(monkeypatch, arch, False)
    assert sum(got.values()) == off * L and got["finite_screen"] == 0
    got, L = _step_launches(monkeypatch, arch, True)
    assert sum(got.values()) == on * L
    assert got["finite_screen"] == (4 if arch.startswith("qwen") else 3) * L


def test_degraded_and_fault_hook_refused_under_tp(monkeypatch):
    """Tensor parallelism now carries them: the engines take ``degraded``
    and ``fault_hook`` with ``tp=`` (a group of one here; 2 and 4 ranks
    in ``test_torch_tp_families.py``), and a rank's shard under degraded
    mode screens and falls back as the unsharded site, a scale's NaN
    included (its output bitwise the whole leaf's)."""
    from repro_torch.parallel.context import TPGroup, tp_context
    from repro_torch.serving import PagedServingEngine, ServingEngine
    for cls in (ServingEngine, PagedServingEngine):
        for kw in (dict(degraded=True), dict(fault_hook=lambda p, x: None)):
            eng = cls(port_model(arch="gemma-2b"),
                      quant_plan=QuantPlan.full(), tp=TPGroup(), **kw)
            assert eng.tp is not None
    w = _ql(quantize_linear(jnp.asarray(W)))
    scale = w.scale.clone()
    scale[5] = float("nan")

    def qkv(sharded):
        out = QuantizedLinear(w.q.reshape(64, 6, 16), scale.reshape(6, 16))
        out.tp_size = 1 if sharded else None
        return out
    with degraded_mode(True):
        want = tlinear.quantized_qkv_proj(qkv(False), t(X))
        with tp_context(TPGroup()):
            got = tlinear.quantized_qkv_proj(qkv(True), t(X))
    assert torch.isfinite(want).all()
    assert torch.equal(got, want)


def test_gated_plain_versions_write_only_when_tripped():
    """The plain versions take the screen's flag as the kernels do: at 0
    the sentinel ``out`` is untouched, at 1 it holds the ungated plain
    version on the sanitized operands; ``out=`` without ``gate=``
    raises.  (The kernels are held to the same on the card.)"""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(5, 64, generator=g)
    x[1, 3] = float("nan")
    xq = torch.randint(-127, 128, (5, 64), dtype=torch.int8, generator=g)
    xs = torch.rand(5, 1, generator=g) * 1e-2
    xs[2, 0] = float("inf")
    w = torch.randint(-127, 128, (64, 32), dtype=torch.int8, generator=g)
    ws = torch.rand(32, generator=g) * 1e-2
    ws[4] = float("-inf")
    res = torch.randn(5, 32, generator=g)
    gx = xq.reshape(1, 5, 64).repeat(2, 1, 1)
    gxs, gw, gws = xs.reshape(1, 5, 1).repeat(2, 1, 1), w.repeat(2, 1, 1), \
        ws.repeat(2, 1)
    san = (lambda a: torch.nan_to_num(a, nan=0.0, posinf=0.0, neginf=0.0))
    cases = [
        (lambda o, f: cim_gemm.quantize_rows_int8(x, gate=f, out=o),
         lambda: cim_gemm.quantize_rows_int8(san(x)),
         [torch.full((5, 64), 7, dtype=torch.int8), torch.full((5, 1), 9.)]),
        (lambda o, f: cim_gemm.cim_gemm_int8_fused_qin(
            x, w, ws, residual=res, gate=f, out=o),
         lambda: cim_gemm.cim_gemm_int8_fused_qin(san(x), w, san(ws),
                                                  residual=res),
         [torch.full((5, 32), 9.)]),
        (lambda o, f: cim_gemm.cim_gemm_int8_fused(
            xq, w, xs, ws, residual=res, gate=f, out=o),
         lambda: cim_gemm.cim_gemm_int8_fused(xq, w, san(xs), san(ws),
                                              residual=res),
         [torch.full((5, 32), 9.)]),
        (lambda o, f: cim_gemm.cim_gated_gemm_int8(
            xq, w, w, xs, ws, ws, "silu", gate=f, out=o),
         lambda: cim_gemm.cim_gated_gemm_int8(xq, w, w, san(xs), san(ws),
                                              san(ws), "silu"),
         [torch.full((5, 32), 9.)]),
        (lambda o, f: cim_gemm.cim_grouped_gemm_int8(
            gx, gw, gxs, gws, gate=f, out=o),
         lambda: cim_gemm.cim_grouped_gemm_int8(gx, gw, san(gxs), san(gws)),
         [torch.full((2, 5, 32), 9.)]),
        (lambda o, f: cim_gemm.cim_grouped_gated_gemm_int8(
            gx, gw, gw, gxs, gws, gws, gate=f, out=o),
         lambda: cim_gemm.cim_grouped_gated_gemm_int8(
             gx, gw, gw, san(gxs), san(gws), san(gws)),
         [torch.full((2, 5, 32), 9.)])]
    for call, want, outs in cases:
        for v in (0, 1):
            got = [o.clone() for o in outs]
            call(got[0] if len(got) == 1 else tuple(got),
                 torch.tensor([v], dtype=torch.int32))
            ref = outs if v == 0 else want()
            ref = [ref] if isinstance(ref, torch.Tensor) else list(ref)
            for a, b in zip(got, ref):
                assert torch.equal(a, b)
        with pytest.raises(ValueError, match="needs gate"):
            call(outs[0] if len(outs) == 1 else tuple(outs), None)
