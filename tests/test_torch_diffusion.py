"""The port's diffusion sampler and engine (``repro_torch.diffusion``)
against the JAX reference, on the CPU.

``dit-test`` with f32 params under the full plan, the reference's weights
crossing over through ``dit_params_from_jax`` (``tests/test_torch_dit.py``
holds the model itself).  The reference runs through its oracle, as its
own tests run it.

Tolerances:
* exact: ``DiffusionSchedule.timesteps`` and ``alpha_bars`` (the same
  numpy float64 arithmetic), 0 steps returning the noise, and the port's
  engine against its own direct ``sample()`` call (bitwise);
* ``guided_eps`` with CFG: 1e-5 of the largest |eps| (the model's
  tolerance, ``tests/test_torch_dit.py``);
* ``sample`` over 4 DDIM or 4 Euler steps, and the port's ``sample`` on
  the JAX engine's noise against the JAX engine's latents: 1e-4 of the
  largest |x| (the per-step eps differences carried through the steps'
  float32 updates).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.diffusion import DiffusionEngine as JEngine
from repro.diffusion import DiffusionSchedule as JSchedule
from repro.diffusion import ImageRequest as JRequest
from repro.diffusion import guided_eps as jguided_eps
from repro.diffusion import sample as jsample

from repro_torch.configs import get_dit_config
from repro_torch.diffusion import (DiffusionEngine, DiffusionSchedule,
                                   ImageRequest, guided_eps, sample)
from repro_torch.serving import EngineStallError, RequestStatus
from torch_parity import jax_dit, port_dit, rel_close, rng, t, to_np

EPS_REL = 1e-5
X_REL = 1e-4
CFG = get_dit_config("dit-test")


@functools.lru_cache(maxsize=None)
def _port():
    return port_dit(True)


def _latents(seed: int, B: int = 2) -> np.ndarray:
    return rng(seed).standard_normal(
        (B, CFG.in_channels, CFG.input_size, CFG.input_size)).astype(
            np.float32)


# ---------------------------------------------------------------------------
# schedule and sampler
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1000, 100])
def test_schedule_is_the_references(n):
    s, js = DiffusionSchedule(n_train_steps=n), JSchedule(n_train_steps=n)
    np.testing.assert_array_equal(s.alpha_bars(), js.alpha_bars())
    np.testing.assert_array_equal(s.betas(), js.betas())
    for steps in (0, 1, 4, 8, 50):
        np.testing.assert_array_equal(s.timesteps(steps),
                                      js.timesteps(steps))
    assert list(DiffusionSchedule(n_train_steps=100).timesteps(4)) == [
        99, 66, 33, 0]


@pytest.mark.parametrize("cfg_scale", [0.0, 4.0])
def test_guided_eps_matches_reference(cfg_scale):
    """The 2B-stacked conditional + null-label evaluation against the
    reference's."""
    _, jm, _, qparams = jax_dit()
    x = _latents(1)
    tt = np.full((2,), 700, np.int32)
    y = np.array([1, 5], np.int32)
    want = jguided_eps(jm, qparams, jnp.asarray(x), jnp.asarray(tt),
                       jnp.asarray(y), cfg_scale)
    got = guided_eps(_port(), t(x), t(tt), t(y), cfg_scale)
    rel_close(got, want, EPS_REL)


@pytest.mark.parametrize("method", ["ddim", "euler"])
def test_sample_matches_reference(method):
    """4 guided steps from the same noise."""
    _, jm, _, qparams = jax_dit()
    x = _latents(2)
    y = np.array([3, 9], np.int32)
    want = jax.jit(lambda p, n, yy: jsample(
        jm, p, yy, x_init=n, num_steps=4, cfg_scale=2.0,
        method=method))(qparams, jnp.asarray(x), jnp.asarray(y))
    got = sample(_port(), t(y), x_init=t(x), num_steps=4, cfg_scale=2.0,
                 method=method)
    rel_close(got, want, X_REL)


def test_sample_edges():
    m = _port()
    x = t(_latents(3))
    y = torch.tensor([1, 2])
    assert torch.equal(sample(m, y, x_init=x, num_steps=0), x)
    with pytest.raises(ValueError, match="x_init or generator"):
        sample(m, y, num_steps=1)
    with pytest.raises(ValueError, match="heun"):
        sample(m, y, x_init=x, num_steps=1, method="heun")
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    a = sample(m, y, generator=g1, num_steps=1)
    assert torch.equal(a, sample(m, y, generator=g2, num_steps=1))
    d = sample(m, y, x_init=x, num_steps=2, method="ddim")
    e = sample(m, y, x_init=x, num_steps=2, method="euler")
    assert not torch.allclose(d, e)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------
def _engine(**kw) -> DiffusionEngine:
    return DiffusionEngine(_port(), batch_size=2, **kw)


def test_engine_pads_and_delivers():
    eng = _engine()
    reqs = [ImageRequest(uid=i, label=i % CFG.n_classes, num_steps=2,
                         seed=9) for i in range(5)]
    for r in reqs:
        assert eng.submit(r) is RequestStatus.QUEUED
    eng.run_until_done()
    assert all(r.ok for r in reqs)
    st = eng.stats
    assert (st.images_out, st.batches, st.denoise_steps) == (5, 3, 6)
    assert st.batch_occupancy == [1.0, 1.0, 0.5]
    assert (st.submitted, st.completed) == (5, 5)
    for r in reqs:
        assert r.latents.shape == (CFG.in_channels, CFG.input_size,
                                   CFG.input_size)
        assert r.latents.dtype == np.float32
        assert np.isfinite(r.latents).all()


def test_engine_groups_by_key_in_queue_order():
    eng = _engine()
    reqs = [ImageRequest(uid=0, label=1, num_steps=2),
            ImageRequest(uid=1, label=2, num_steps=1),
            ImageRequest(uid=2, label=3, num_steps=2),
            ImageRequest(uid=3, label=4, num_steps=1, cfg_scale=2.0)]
    for r in reqs:
        eng.submit(r)
    eng.step()                                   # uid 0 + 2
    assert [r.done for r in reqs] == [True, False, True, False]
    assert [r.uid for r in eng.queue] == [1, 3]
    eng.step()                                   # uid 1 alone (padded)
    assert reqs[1].done and not reqs[3].done
    eng.run_until_done()
    assert all(r.ok for r in reqs) and eng.stats.batches == 3


def test_engine_latents_are_its_direct_sample_bitwise():
    eng = _engine()
    reqs = [ImageRequest(uid=i, label=i + 1, num_steps=2, cfg_scale=1.5,
                         method="euler", seed=11) for i in range(2)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    noise = torch.stack([eng._noise(r) for r in reqs])
    direct = sample(_port(), torch.tensor([1, 2], dtype=torch.int32),
                    x_init=noise, num_steps=2, cfg_scale=1.5,
                    method="euler")
    for i, r in enumerate(reqs):
        assert np.array_equal(to_np(direct[i]), r.latents)
    # (seed, uid) seeds the noise: another uid or seed draws other noise
    other = [eng._noise(ImageRequest(uid=0, label=0, seed=s))
             for s in (11, 12)]
    assert torch.equal(eng._noise(reqs[0]), other[0])
    assert not torch.equal(other[0], other[1])
    assert not torch.equal(eng._noise(reqs[0]), eng._noise(reqs[1]))


def test_port_sample_on_the_jax_engines_noise():
    """The reference engine (full plan, its jitted sampler) on two
    requests; the port's ``sample`` from the JAX engine's own noise
    (``jax.random``; the port's engine draws from torch, ROADMAP C)
    gives the same latents."""
    _, jm, params, _ = jax_dit()
    from repro.quant import QuantPlan as JPlan
    jeng = JEngine(jm, params, batch_size=2, quant_plan=JPlan.full())
    jreqs = [JRequest(uid=i, label=4 + i, num_steps=3, cfg_scale=2.0,
                      seed=7) for i in range(2)]
    for r in jreqs:
        jeng.submit(r)
    jeng.run_until_done()
    noise = np.stack([np.asarray(jeng._noise(r)) for r in jreqs])
    got = sample(_port(), torch.tensor([4, 5]), x_init=t(noise),
                 num_steps=3, cfg_scale=2.0)
    rel_close(got, np.stack([r.latents for r in jreqs]), X_REL)


def test_engine_submit_validation_and_backpressure():
    eng = _engine(max_queue=1)
    for bad in (ImageRequest(uid=0, label=CFG.n_classes),      # null id
                ImageRequest(uid=0, label=-1),
                ImageRequest(uid=0, label=0, num_steps=-1),
                ImageRequest(uid=0, label=0, method="heun")):
        with pytest.raises(ValueError):
            eng.submit(bad)
        assert bad.status is RequestStatus.REJECTED
    assert eng.submit(ImageRequest(uid=1, label=0)) is RequestStatus.QUEUED
    full = ImageRequest(uid=2, label=0)
    assert eng.submit(full) is RequestStatus.REJECTED
    assert "queue full" in full.error
    assert eng.stats.rejected == 5


def test_engine_deadlines_drain_and_shutdown():
    now = [0.0]
    eng = _engine(clock=lambda: now[0])
    late = ImageRequest(uid=0, label=1, num_steps=1, deadline_s=1.0)
    ok = ImageRequest(uid=1, label=2, num_steps=1)
    eng.submit(late)
    eng.submit(ok)
    now[0] = 2.0
    eng.drain()
    assert late.status is RequestStatus.TIMED_OUT and ok.ok
    assert eng.submit(ImageRequest(uid=2, label=0)) is \
        RequestStatus.REJECTED                    # closed
    eng2 = _engine()
    queued = ImageRequest(uid=3, label=0, num_steps=1)
    eng2.submit(queued)
    eng2.shutdown(drain=False)
    assert queued.status is RequestStatus.REJECTED
    eng3 = _engine()
    eng3.submit(ImageRequest(uid=4, label=0, num_steps=1))
    eng3.submit(ImageRequest(uid=5, label=0, num_steps=2))
    with pytest.raises(EngineStallError):
        eng3.run_until_done(max_iters=1)
    with pytest.raises(ValueError):
        eng3.run_until_done(on_stall="ignore")


def test_engine_applies_the_plan_and_fails_non_finite_latents():
    from repro_torch.quant import QuantizedLinear, QuantPlan
    m = port_dit(False)
    eng = DiffusionEngine(m, batch_size=2, quant_plan=QuantPlan.full())
    assert isinstance(m.blocks[0].adaln.kernel, QuantizedLinear)
    with torch.no_grad():
        m.final.linear.bias.fill_(float("nan"))
    r = ImageRequest(uid=0, label=1, num_steps=1)
    eng.submit(r)
    eng.run_until_done()
    assert r.status is RequestStatus.FAILED and eng.stats.failed == 1
