"""The differentiable SSD scan (``kernels.ssd_scan.SSDScan``) against the
JAX reference, on the CPU.

The reference's scan gradient is JAX autodiff through the chunked form
``repro.models.ssm.ssd_chunked`` (its model pads S to a multiple of the
chunk with zeros; its Pallas kernel has no backward).  ``SSDScan`` runs
the kernel's forward (its plain version on CPU tensors) and recomputes
that chunked form in plain f32 torch for the backward.

Tolerances:
* dx, dlog_a, db, dc, dh0 against ``jax.vjp`` of ``ssd_chunked`` on the
  same numpy-seeded inputs and cotangents, f32: within ``GRAD_REL`` =
  1e-4 of each gradient's largest |value| (the same f32 sums in other
  orders);
* ``torch.autograd.gradcheck`` in f64 (its default tolerances) with a
  ragged last chunk;
* a zamba2-smoke train step (weights in f32) through the Function
  against the same step through direct autograd of the plain scan
  (``kernel_mode(False)``): the loss bitwise (both forwards run the
  plain scan), each gradient within ``STEP_REL`` = 1e-5 of its leaf's
  largest |value| (the chunked recompute sums the chunk states in
  another order than the plain scan's chunk loop, so the bits are not
  the same).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import ssd_chunked as jssd_chunked

from repro_torch import optim
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.data import for_model
from repro_torch.kernels import ssd_scan as ss
from repro_torch.launch.steps import build_train_step
from repro_torch.models import ssm as tssm
from repro_torch.quant import kernel_mode
from torch_parity import numpy_tree, port_model, rel_close, rng, smoke, t

GRAD_REL = 1e-4
STEP_REL = 1e-5
NAMES = ("dx", "dlog_a", "db", "dc", "dh0")


def _inputs(seed, B, S, H, G, P, N, h0, dtype=np.float32):
    """Scan inputs in the model's layout, as a Mamba-2 block makes them:
    dt-scaled x, log_a = -dt · (1..H), b and c per group; cotangents of
    y and the final state."""
    g = rng(seed)
    dt = np.log1p(np.exp(g.standard_normal((B, S, H))))
    arrs = {
        "x": g.standard_normal((B, S, H, P)) * dt[..., None],
        "log_a": -dt * np.arange(1, H + 1),
        "b": g.standard_normal((B, S, G, N)),
        "c": g.standard_normal((B, S, G, N)),
        "h0": g.standard_normal((B, H, P, N)) if h0 else None,
        "dy": g.standard_normal((B, S, H, P)),
        "dfinal": g.standard_normal((B, H, P, N)),
    }
    return {k: None if v is None else v.astype(dtype)
            for k, v in arrs.items()}


def _reference_grads(a, chunk, dy=True, dfinal=True):
    """``jax.vjp`` of the reference's ``ssd_chunked``, S padded to a
    multiple of ``chunk`` with zeros as its model pads it."""
    S = a["x"].shape[1]
    pad = (-S) % chunk

    def f(x, log_a, b, c, *h0):
        padded = [jnp.pad(v, [(0, 0), (0, pad)] + [(0, 0)] * (v.ndim - 2))
                  for v in (x, log_a, b, c)]
        y, final = jssd_chunked(*padded, chunk, h0[0] if h0 else None)
        return y[:, :S], final

    primals = [a[k] for k in ("x", "log_a", "b", "c", "h0")
               if a[k] is not None]
    (y, final), vjp = jax.vjp(f, *primals)
    cot = (a["dy"] if dy else np.zeros_like(a["dy"]),
           a["dfinal"] if dfinal else np.zeros_like(a["dfinal"]))
    grads = [np.asarray(g) for g in vjp(cot)]
    return np.asarray(y), np.asarray(final), grads


def _port(a, chunk, dy=True, dfinal=True):
    """(y, final, grads) through ``SSDScan`` on CPU tensors."""
    ins = [None if a[k] is None else t(a[k]).requires_grad_()
           for k in ("x", "log_a", "b", "c", "h0")]
    y, final = ss.SSDScan.apply(*ins[:4], chunk, ins[4])
    outs = [(y, t(a["dy"]))] if dy else []
    outs += [(final, t(a["dfinal"]))] if dfinal else []
    torch.autograd.backward([o for o, _ in outs], [g for _, g in outs])
    return y, final, [i.grad for i in ins if i is not None]


@pytest.mark.parametrize("G,h0,S", [(1, False, 32), (1, True, 32),
                                    (2, False, 32), (2, True, 32),
                                    (1, True, 30), (2, False, 29)])
def test_grads_match_reference_vjp(G, h0, S):
    """The model's layout (B 2, H 4, P 8, N 6, chunk 8), b and c shared
    by G groups of heads, from a zero or a given state, S on the chunk
    and ragged: y and the final state, then every gradient, against the
    reference."""
    a = _inputs(S + 10 * G + h0, 2, S, 4, G, 8, 6, h0)
    wy, wf, want = _reference_grads(a, 8)
    y, final, got = _port(a, 8)
    rel_close(y, wy, 1e-5)
    rel_close(final, wf, 1e-5)
    assert len(got) == len(want) == (5 if h0 else 4)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        rel_close(g, w, GRAD_REL)


def _flat(a):
    """Inputs of one head and one group a row in the flattened layout:
    x, b, c, dy [BH, S, K], log_a [BH, S], h0 and dfinal [BH, P, N]."""
    axis = {"h0": 1, "dfinal": 1}
    return {k: None if v is None else v.squeeze(axis.get(k, 2))
            for k, v in a.items()}


def test_flat_layout_grads_match_reference_vjp():
    """Flattened heads: the reference's chunked form with one head and
    one group a row."""
    a = _inputs(5, 3, 24, 1, 1, 8, 6, True)
    _, _, want = _reference_grads(a, 8)
    _, _, got = _port(_flat(a), 8)
    for name, g, w in zip(NAMES, got, want):
        rel_close(g, w.reshape(g.shape), GRAD_REL)


@pytest.mark.parametrize("layout", ["model", "flat"])
def test_gradcheck_f64_ragged(layout):
    """``gradcheck`` on the Function in f64 (the plain forward and the
    recompute both run in f64 then), S 13 over chunks of 4: a ragged
    last chunk of 1, with an initial state."""
    if layout == "model":
        a = _inputs(7, 1, 13, 4, 2, 3, 2, True, np.float64)
    else:
        a = _flat(_inputs(8, 2, 13, 1, 1, 3, 2, True, np.float64))
    ins = [t(a[k]).requires_grad_() for k in ("x", "log_a", "b", "c", "h0")]
    assert torch.autograd.gradcheck(
        lambda x, la, b, c, h0: ss.SSDScan.apply(x, la, b, c, 4, h0), ins)


@pytest.mark.parametrize("which", ["dy", "dfinal"])
def test_one_cotangent_at_a_time(which):
    """Only y, then only the final state, reaches the loss: the other
    cotangent is None inside the backward, and the gradients equal the
    reference's for a zero cotangent there."""
    a = _inputs(11, 2, 24, 4, 2, 8, 6, True)
    dy, dfinal = which == "dy", which == "dfinal"
    _, _, want = _reference_grads(a, 8, dy, dfinal)
    _, _, got = _port(a, 8, dy, dfinal)
    for name, g, w in zip(NAMES, got, want):
        rel_close(g, w, GRAD_REL)


def test_inputs_that_need_no_grad_get_none():
    """Only the inputs that require grad get a gradient; the backward
    recomputes nothing for the others."""
    a = _inputs(12, 1, 16, 2, 1, 4, 4, True)
    x = t(a["x"]).requires_grad_()
    rest = [t(a[k]) for k in ("log_a", "b", "c", "h0")]
    y, final = ss.SSDScan.apply(x, *rest[:3], 8, rest[3])
    (y.sum() + final.sum()).backward()
    assert x.grad is not None and all(r.grad is None for r in rest)
    got = ss.ssd_scan_grads(*(t(a[k]) for k in ("x", "log_a", "b", "c")),
                            8, t(a["h0"]), t(a["dy"]), None,
                            needs=(False, True, False, False, False))
    assert [g is None for g in got] == [True, False, True, True, True]


def _zamba2_f32():
    """The port's zamba2-smoke on the reference's weights cast to f32
    (the config's ``param_dtype`` "float32"): gradients in f32, so the
    comparison is of the scan's two backwards and not of bf16
    rounding."""
    _, _, params = smoke("zamba2-1.2b")
    cfg = dataclasses.replace(reduced_config(get_config("zamba2-1.2b")),
                              param_dtype="float32")
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        numpy_tree(params))
    return params_from_jax(tree, cfg, device="cpu")


def _zamba2_step(monkeypatch, plain: bool):
    """One ``build_train_step`` step of zamba2-smoke in f32 (2
    microbatches of 2 rows of 300 tokens: 38 chunks of 8, the last
    ragged); returns (metrics, the mean gradients, the number of
    ``SSDScan`` backward calls)."""
    calls = []
    grads = ss.ssd_scan_grads

    def counted(*a, **kw):
        calls.append(1)
        return grads(*a, **kw)
    monkeypatch.setattr(ss, "ssd_scan_grads", counted)
    model = _zamba2_f32()
    cfg = model.cfg
    ocfg = optim.AdamWConfig(learning_rate=1e-3)
    step = build_train_step(cfg, model, ocfg)
    state = optim.init(ocfg, step.params)
    batch = for_model(cfg, batch=4, seq_len=300, seed=6).batch_at(0)
    with kernel_mode(False if plain else None):
        met = step(state, batch)
    return met, {k: g.clone() for k, g in step.grads.items()}, len(calls)


def test_zamba2_train_step_through_the_function(monkeypatch):
    """zamba2-smoke's train step with the scan through ``SSDScan`` (the
    default) against the same step with kernels off (direct autograd of
    the plain scan): the loss bitwise, every gradient within
    ``STEP_REL``; the Function's backward ran once a Mamba-2 layer a
    microbatch, and never on the plain path."""
    met, got, n = _zamba2_step(monkeypatch, plain=False)
    wmet, want, wn = _zamba2_step(monkeypatch, plain=True)
    cfg = reduced_config(get_config("zamba2-1.2b"))
    mamba = sum(m == "mamba2" for m, _ in cfg.layer_specs())
    assert mamba == 2 and n == mamba * cfg.train_microbatches and wn == 0
    assert torch.equal(met["loss"], wmet["loss"])
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(wmet["grad_norm"]), rtol=STEP_REL)
    assert got.keys() == want.keys()
    for k in got:
        rel_close(got[k], want[k], STEP_REL)


def test_no_grad_forward_never_touches_the_function(monkeypatch):
    """Under ``no_grad`` a Mamba-2 block (weights that require grad)
    calls the kernel's wrapper, as serving does, and never ``SSDScan``;
    with grad on it goes through ``SSDScan``."""
    applied, wrapped = [], []
    apply, wrapper = ss.SSDScan.apply, ss.ssd_scan
    monkeypatch.setattr(ss.SSDScan, "apply",
                        lambda *a: applied.append(1) or apply(*a))
    monkeypatch.setattr(ss, "ssd_scan",
                        lambda *a: wrapped.append(1) or wrapper(*a))
    model = port_model(arch="zamba2-1.2b").trainable()
    block = next(b for b in model.layers if b.spec[0] == "mamba2")
    x = t(rng(13).standard_normal((2, 40, model.cfg.d_model)),
          torch.bfloat16)
    with torch.no_grad():
        out = tssm.mamba2_apply(block.mamba, x, model.cfg.ssm)
    assert (applied, wrapped) == ([], [1])
    again = tssm.mamba2_apply(block.mamba, x, model.cfg.ssm)
    assert (applied, wrapped) == ([1], [1, 1])
    assert again.requires_grad and torch.equal(out, again.detach())
