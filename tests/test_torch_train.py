"""Training through the port against the JAX reference, on the CPU:
``Model.loss`` and its gradients, the train steps, and the
differentiable cacheless attention above 2048 tokens.

Tolerances:
* ``Model.loss`` and every leaf's gradient on the 10 LM ``*-smoke``
  configs, weights carried over in f32 (the smoke weights cast up, the
  config's ``param_dtype`` "float32" on both sides, so the comparison is
  of the algorithm and not of where each framework rounds bf16): the
  loss within 1e-5 relative, each gradient within ``GRAD_REL`` = 1e-4 of
  its leaf's largest magnitude (f32 sums in other orders; measured
  worst 7e-6, the Mamba-2 scan).  The reference's gradient tree has the
  parameters' structure, so ``convert.params_from_jax`` carries it
  across.  qwen2-moe runs the jitted reference: in f32 no router
  near-tie flips (C.5 is a bf16 near-tie), so the jitted loss equals
  the op-by-op one bit for bit (checked once; op by op the gradient
  took 36 s).
* the chunked loss equals the unchunked one within 1e-6 (the same sums
  in another order); remat is bitwise its absence.
* three ``simple_train_step``s of gemma-2b-smoke in bf16: each loss within
  ``STEP_REL`` = 1e-3 of the reference's (bf16 rounds at other places in
  the two frameworks); ``train_microbatches`` 2 in f32: the losses within
  1e-5, the updated weights within 1e-4 of each leaf's largest magnitude
  (AdamW divides each gradient by its own running magnitude, so an
  element whose gradient is near zero moves by up to the learning rate
  on a rounding difference; measured 1.2e-5).
* the differentiable attention: dq, dk, dv within 1e-4 of each one's
  largest magnitude against ``jax.grad`` of the reference's
  ``blockwise_attention`` (f32); kernel 12's branch (its plain version
  on the CPU, f32 scores, masked block pairs skipped) within 1e-4
  against plain autograd of ``flash_attention_plain``; on bf16 inputs
  whose keys share a large component, dq, dk, dv within ``SHARED_REL``
  = 2**-7 (relative L2) of an f64 softmax's autograd (the bf16 rounding
  of the gradients and inputs is ~2**-9).
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import ARCH_IDS
from repro.configs import get_config as jget
from repro.configs import reduced_config as jred
from repro.data import for_model as jfor_model
from repro.launch.steps import build_train_step as jbuild_train_step
from repro.models import attention as jattn
from repro.models import build_model
from repro.training import simple_train_step as jsimple_train_step

from repro_torch import optim
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.data import for_model
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.steps import build_train_step
from repro_torch.models import attention as tattn
from repro_torch.training import device_batch, simple_train_step
from torch_parity import numpy_tree, rel_close, rng, smoke

GRAD_REL = 1e-4
STEP_REL = 1e-3
ATTN_REL = 1e-4
SHARED_REL = 2 ** -7


def _f32(arch):
    """(jax cfg, jax model, f32 params) and the port's f32 model of the
    ``arch`` smoke config: the smoke weights cast to f32."""
    jcfg, _, params = smoke(arch)
    jcfg = dataclasses.replace(jcfg, param_dtype="float32")
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              param_dtype="float32")
    model = params_from_jax(numpy_tree(params), cfg, device="cpu")
    return jcfg, build_model(jcfg), params, model.trainable()


def _grads_close(model, jgrads, cfg, rel):
    """Each port gradient against the reference's leaf (carried across
    by ``params_from_jax``; a leaf the loss does not reach, None here,
    is zero there)."""
    want = params_from_jax(numpy_tree(jgrads), cfg, device="cpu")
    for (name, p), (_, w) in zip(model.named_parameters(),
                                 want.named_parameters()):
        if p.grad is None:
            assert not w.detach().any(), name
            continue
        if w.detach().abs().max() == 0:
            assert not p.grad.any(), name
            continue
        rel_close(p.grad, w.detach(), rel)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_reference(arch):
    jcfg, jm, params, model = _f32(arch)
    batch = jfor_model(jcfg, batch=2, seq_len=16, seed=3).batch_at(0)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        params, batch)
    loss, met = model.loss(device_batch(batch, torch.device("cpu")))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(met["aux"]), float(jmet["aux"]),
                               rtol=1e-5, atol=1e-9)
    assert float(met["tokens"]) == float(jmet["tokens"])
    _grads_close(model, jg, model.cfg, GRAD_REL)


def test_chunked_loss_and_mask_match():
    """A budget of 2**10 logits cuts gemma-2b-smoke's loss into 8 chunks
    (each recomputed in the backward): the loss and gradients equal the
    unchunked ones and the reference's chunked ones; a ``loss_mask`` is
    honoured alike."""
    jcfg, jm, params, model = _f32("gemma-2b")
    batch = jfor_model(jcfg, batch=2, seq_len=16, seed=4).batch_at(0)
    batch["loss_mask"] = (rng(9).random((2, 16)) < 0.6).astype(np.float32)
    tb = device_batch(batch, torch.device("cpu"))
    whole, _ = model.loss(tb)
    whole.backward()
    g_whole = [p.grad.clone() for p in model.parameters()]
    model.zero_grad()
    model.LOSS_CHUNK_BUDGET = jm.LOSS_CHUNK_BUDGET = 2 ** 10
    chunked, met = model.loss(tb)
    chunked.backward()
    np.testing.assert_allclose(float(chunked), float(whole), rtol=1e-6)
    for g, p in zip(g_whole, model.parameters()):
        rel_close(p.grad, g, 1e-6)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        params, batch)
    np.testing.assert_allclose(float(chunked), float(jl), rtol=1e-5)
    assert float(met["tokens"]) == float(jmet["tokens"]) == batch[
        "loss_mask"].sum()
    _grads_close(model, jg, model.cfg, GRAD_REL)


def test_remat_is_bitwise_its_absence():
    """``cfg.remat`` recomputes each layer in the backward: the same
    loss and gradients bit for bit (qwen2-moe-smoke: the auxiliary
    rides through the checkpoint too)."""
    _, _, _, model = _f32("qwen2-moe-a2.7b")
    batch = device_batch(jfor_model(smoke("qwen2-moe-a2.7b")[0], 2, 16,
                                    seed=5).batch_at(0), torch.device("cpu"))
    out = {}
    for remat in (False, True):
        model.cfg = dataclasses.replace(model.cfg, remat=remat)
        model.zero_grad()
        loss, met = model.loss(batch)
        loss.backward()
        out[remat] = (loss, met["aux"], [p.grad.clone() for p in
                                         model.parameters()])
    assert torch.equal(out[False][0], out[True][0])
    assert torch.equal(out[False][1], out[True][1]) and out[True][1] > 0
    for a, b in zip(out[False][2], out[True][2]):
        assert torch.equal(a, b)


def test_remat_and_microbatches_follow_the_reference_configs():
    for arch in ARCH_IDS:
        for red in (False, True):
            want = jred(jget(arch)) if red else jget(arch)
            got = reduced_config(get_config(arch)) if red else get_config(
                arch)
            assert (got.remat, got.train_microbatches) == (
                want.remat, want.train_microbatches), (arch, red)


def test_three_train_steps_match_reference():
    """gemma-2b-smoke in bf16, AdamW at 3e-3 with clipping and decay:
    three ``simple_train_step``s, loss by loss."""
    jcfg, jm, params = smoke("gemma-2b")
    jocfg = joptim.AdamWConfig(learning_rate=3e-3)
    jstep = jsimple_train_step(jm, jocfg)
    jstate = joptim.init(jocfg, params)
    model = params_from_jax(numpy_tree(params),
                            reduced_config(get_config("gemma-2b")),
                            device="cpu")
    ocfg = optim.AdamWConfig(learning_rate=3e-3)
    step = simple_train_step(model, ocfg)
    state = optim.init(ocfg, step.params)
    pipe = jfor_model(jcfg, batch=4, seq_len=16, seed=2)
    jp = params
    for i in range(3):
        batch = pipe.batch_at(i)
        jp, jstate, jmet = jstep(jp, jstate, batch)
        met = step(state, batch)
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=STEP_REL)
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=STEP_REL)
        assert float(met["lr"]) == float(jmet["lr"])
    assert set(met) == set(jmet)


def test_microbatches_sum_in_f32_as_the_reference():
    """``train_microbatches`` 2 (gemma-2b-smoke in f32, batch 4): the
    reference's ``build_train_step`` (a scan summing the microbatch
    gradients in f32, then one AdamW step) against the port's, two steps."""
    jcfg, _, params, model = _f32("gemma-2b")
    jcfg = dataclasses.replace(jcfg, train_microbatches=2)
    model.cfg = dataclasses.replace(model.cfg, train_microbatches=2)
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(
        jax.sharding.AxisType.Auto,) * 2)
    bundle = jbuild_train_step(jcfg, mesh, "train_4k")
    jstate = joptim.init(joptim.AdamWConfig(), params)
    step = build_train_step(model.cfg, model)
    state = optim.init(optim.AdamWConfig(), step.params)
    pipe = for_model(model.cfg, batch=4, seq_len=16, seed=6)
    jp = jax.tree.map(jnp.copy, params)        # the step donates them
    for i in range(2):
        batch = pipe.batch_at(i)
        jp, jstate, jmet = bundle.fn(jp, jstate, batch)
        met = step(state, batch)
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
    want = params_from_jax(numpy_tree(jp), model.cfg, device="cpu")
    for (n, p), (_, w) in zip(model.named_parameters(),
                              want.named_parameters()):
        rel_close(p, w.detach(), 1e-4)


# ---------------------------------------------------------------------------
# the differentiable cacheless attention
# ---------------------------------------------------------------------------
S_ATTN = 2100     # just above DENSE_SEQ_THRESHOLD: 5 q blocks, 3 KV blocks


def _attn_inputs(seed, S, H, KH, D, Dv=None):
    r = rng(seed)
    shapes = ((1, S, H, D), (1, S, KH, D), (1, S, KH, Dv or D),
              (1, S, H, Dv or D))
    return [r.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("kind,window,prefix,offset", [
    ("causal", None, None, 0), ("sliding", 700, None, 0),
    ("prefix", None, 300, 0), ("causal", None, None, 37)])
def test_attention_grads_match_reference_blockwise(kind, window, prefix,
                                                    offset):
    """dq, dk, dv of ``cacheless_attention`` above 2048 tokens (the
    ``CachelessAttention`` Function on the blockwise forward) against
    ``jax.grad`` of the reference's ``blockwise_attention`` under its
    custom VJP; the last case gives positions that start at 37 (caller
    given, not aligned)."""
    q, k, v, do = _attn_inputs(1, S_ATTN, 4, 2, 16)
    pos = (np.arange(S_ATTN)[None] + offset).astype(np.int32)

    def jloss(q_, k_, v_):
        out = jattn.blockwise_attention(q_, k_, v_, jnp.asarray(pos),
                                        jnp.asarray(pos), kind, window,
                                        prefix)
        return jnp.sum(out * do)
    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = tattn.cacheless_attention(tq, tk, tv, torch.from_numpy(pos), kind,
                                    window, aligned_positions=offset == 0,
                                    prefix_len=prefix)
    out.backward(torch.from_numpy(do))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        rel_close(got, w, ATTN_REL)


@pytest.mark.parametrize("kind,window,prefix,D,Dv", [
    ("causal", None, None, 16, 16), ("sliding", 700, None, 16, 16),
    ("prefix", None, 300, 16, 16), ("causal", None, None, 24, 16)])
def test_kernel_branch_grads_match_plain_autograd(kind, window, prefix, D,
                                                  Dv):
    """The Function's kernel-12 branch, run on CPU tensors (the kernel's
    plain version with ``lse``, the backward on f32 scores that skips
    the block pairs no query sees a key of) against plain autograd of
    ``flash_attention_plain``; the last case pads v from 16 to 24 as
    MLA's path does, through ``cacheless_attention``'s own padding."""
    q, k, v, do = _attn_inputs(2, S_ATTN, 4, 1, D, Dv)
    pos = torch.arange(S_ATTN)[None]
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    vp = torch.nn.functional.pad(tv, (0, D - Dv))
    out = tattn.CachelessAttention.apply(tq, tk, vp, pos, kind, window,
                                         prefix, True)[..., :Dv]
    out.backward(torch.from_numpy(do))
    got = (tq.grad, tk.grad, tv.grad)
    rq, rk, rv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    want = fa.flash_attention_plain(
        rq, rk, torch.nn.functional.pad(rv, (0, D - Dv)),
        causal=True, window=window, prefix_len=prefix or 0)[..., :Dv]
    rel_close(out.detach(), want.detach(), 1e-6)
    want.backward(torch.from_numpy(do))
    for g, w in zip(got, (rq.grad, rk.grad, rv.grad)):
        rel_close(g, w, ATTN_REL)


@pytest.mark.parametrize("kernel", [False, True])
def test_backward_keeps_dq_accurate_when_keys_share_a_component(kernel):
    """bf16 inputs whose keys share one large component, as a trained
    layer's keys do: the backward's dq, dk and dv within ``SHARED_REL``
    (relative L2) of autograd through an f64 softmax, after the
    blockwise forward or kernel 12's plain version.  delta is summed
    from the backward's own p and dp, so each row of ds sums to zero and
    the shared component adds nothing to dq; taken from the forward's
    output (p rounded to bf16 in its PV product) it would miss by ~2**-9
    of |do| |o| a row, and dq by that times the shared component."""
    S, H, KH, D = 1024, 4, 1, 64
    r = rng(6)
    shared = np.sign(r.standard_normal((1, 1, KH, D))) * 0.9
    q = torch.from_numpy(0.15 * r.standard_normal((1, S, H, D))).to(
        torch.bfloat16)
    k = torch.from_numpy(0.15 * r.standard_normal((1, S, KH, D))
                         + shared).to(torch.bfloat16)
    v, do = (torch.from_numpy(r.standard_normal(s)).to(torch.bfloat16)
             for s in ((1, S, KH, D), (1, S, H, D)))
    pos = torch.arange(S)[None]
    blocks = dict(q_block=256, kv_block=512)
    if kernel:
        _, lse = fa.flash_attention_plain(q, k, v, return_lse=True)
    else:
        _, lse = tattn.blockwise_forward(q, k, v, pos, pos, "causal",
                                         **blocks)
    got = tattn.blockwise_backward(q, k, v, pos, pos, lse, do, "causal",
                                   f32_scores=kernel, **blocks)
    q64, k64, v64 = (a.double().requires_grad_() for a in (q, k, v))
    s64 = torch.einsum("bqgd,bkd->bgqk", q64,
                       k64[:, :, 0]) / D ** 0.5
    s64 = s64.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(),
                          float("-inf"))
    out = torch.einsum("bgqk,bkd->bqgd", torch.softmax(s64, -1),
                       v64[:, :, 0])
    out.backward(do.double())
    for name, g, w in zip("qkv", got, (q64.grad, k64.grad, v64.grad)):
        err = float((g.double() - w).norm() / w.norm())
        assert err <= SHARED_REL, (name, err)


def test_plain_lse_is_the_blockwise_lse():
    """Kernel 12's plain version and the blockwise forward give the same
    log-sum-exp (f32, within 1e-6) and 1e30 for a row with no visible
    key (a window past the keys under Sq > Skv would be one; here a
    query before every key under caller positions)."""
    q, k, v, _ = _attn_inputs(3, 300, 4, 2, 16)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    _, lse = fa.flash_attention_plain(tq, tk, tv, True, 40,
                                      return_lse=True)
    pos = torch.arange(300)[None]
    _, blse = tattn.blockwise_forward(tq, tk, tv, pos, pos, "sliding", 40,
                                      q_block=128, kv_block=64)
    rel_close(blse, lse, 1e-6)
    _, empty = tattn.blockwise_forward(tq, tk, tv, pos - 1000, pos,
                                       "causal")
    assert bool((empty == 1e30).all())


def test_no_grad_and_short_paths_skip_the_function(monkeypatch):
    """Serving (no grad) and S <= 2048 never enter the Function: the
    dense path stays plain autograd and the served forward's bits stay
    as they were; all of it runs with ``models.attention._fa`` replaced
    by a namespace holding kernel 12's wrapper alone, as the launch
    counters of ``chip_smoke.py`` and the card tests replace it."""
    calls = []
    real = tattn.CachelessAttention.apply
    monkeypatch.setattr(tattn.CachelessAttention, "apply",
                        lambda *a: calls.append(1) or real(*a))
    # the launch counters' stand-in for the kernel module holds its
    # wrapper alone: nothing else of it may be reached through ``_fa``
    monkeypatch.setattr(tattn, "_fa", SimpleNamespace(
        flash_attention=fa.flash_attention))
    q, k, v, _ = _attn_inputs(4, S_ATTN, 2, 1, 16)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    pos = torch.arange(S_ATTN)[None]
    with torch.no_grad():
        served = tattn.cacheless_attention(tq, tk, tv, pos, "causal")
    assert not calls
    assert torch.equal(served, tattn.blockwise_attention(
        tq.detach(), tk.detach(), tv.detach(), pos, pos, "causal"))
    tattn.cacheless_attention(tq[:, :2048], tk[:, :2048], tv[:, :2048],
                              pos[:, :2048], "causal").sum().backward()
    assert not calls and tq.grad is not None
    trained = tattn.cacheless_attention(tq, tk, tv, pos, "causal")
    assert calls and torch.equal(trained.detach(), served)
