"""The port's chaos harness (``repro_torch.reliability.chaos``) against the
reference's: on gemma-2b-smoke under the full plan and degraded mode, a
soak of greedy requests at the swept BERs {1e-6, 1e-4, 1e-2} with NaN
logits planted at rate 0.25 ends every request as the reference's soak
does, with the same tokens and the same ``ChaosReport``; a fault-free
soak is bitwise a plain serve; the outlier guard at fraction 1.0 serves
as the fault-free engine at 1e-2; a paged soak keeps every invariant;
the weights come back bitwise; a NaN planted by a diffusion
``fault_hook`` fails only its own request."""
import functools

import numpy as np
import pytest

from repro.quant import QuantPlan as JPlan
from repro.reliability import chaos_soak as jchaos_soak
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.quant import QuantPlan
from repro_torch.reliability import chaos_soak, quantized_leaves
from repro_torch.serving import PagedServingEngine, Request, ServingEngine
from torch_parity import numpy_tree, smoke

BERS = (1e-6, 1e-4, 1e-2)
SOAK = dict(seed=42, period=2, logit_nan_rate=0.25, max_iters=200)
ENGINE = dict(n_slots=2, max_len=32, prefill_bucket=4)


def _prompts(vocab, n=5):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, 4 + i % 3).astype(np.int32)
            for i in range(n)]


def _requests(cls, vocab, n=5, temperature=0.0):
    return [cls(uid=i, prompt=p, max_new_tokens=3 + i % 3,
                temperature=temperature, top_k=5, seed=11)
            for i, p in enumerate(_prompts(vocab, n))]


def _port_model():
    """The port's gemma-2b-smoke holding the reference's full-plan
    leaves (the engines' plan is then a no-op on them)."""
    cfg, jm, params = smoke("gemma-2b")
    return params_from_jax(numpy_tree(jm.quantize(params, JPlan.full())),
                           reduced_config(get_config("gemma-2b")),
                           device="cpu")


def _outcome(reqs, res):
    return ([(r.status.value, list(r.generated)) for r in reqs],
            res.statuses, vars(res.chaos), res.decode_steps)


@functools.lru_cache(maxsize=None)
def _reference_sweep():
    cfg, jm, params = smoke("gemma-2b")
    eng = JEngine(jm, params, quant_plan=JPlan.full(), degraded=True,
                  **ENGINE)
    out = {}
    for ber in BERS:
        reqs = _requests(JRequest, cfg.vocab)
        res = jchaos_soak(eng, reqs, ber=ber, **SOAK)
        assert res.healthy, res.violations
        out[ber] = _outcome(reqs, res)
    return out


@pytest.fixture(scope="module")
def port_sweep():
    model = _port_model()
    clean = quantized_leaves(model)
    eng = ServingEngine(model, quant_plan=QuantPlan.full(), degraded=True,
                        **ENGINE)
    out = {}
    for ber in BERS:
        reqs = _requests(Request, model.cfg.vocab)
        res = chaos_soak(eng, reqs, ber=ber, **SOAK)
        assert res.healthy, res.violations
        assert res.chaos.weight_injections > 0
        if ber >= 1e-4:
            assert res.chaos.bits_faulted > 0
        back = quantized_leaves(model)
        assert all(np.array_equal(back[p].q, clean[p].q) for p in clean)
        out[ber] = _outcome(reqs, res)
    return out


@pytest.mark.parametrize("ber", BERS)
def test_soak_equals_reference(port_sweep, ber):
    """Statuses and tokens request by request, the soak's status counts,
    its ChaosReport (campaigns, bits faulted, NaN rows planted) and its
    decode steps equal the reference's soak on the same engine sweep."""
    assert port_sweep[ber] == _reference_sweep()[ber]


def _serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run_until_done(max_iters=200)
    return [list(r.generated) for r in reqs]


def test_fault_free_soak_is_a_plain_serve():
    model = _port_model()
    want = _serve(ServingEngine(model, quant_plan=QuantPlan.full(),
                                **ENGINE),
                  _requests(Request, model.cfg.vocab, temperature=0.7))
    eng = ServingEngine(model, quant_plan=QuantPlan.full(), **ENGINE)
    reqs = _requests(Request, model.cfg.vocab, temperature=0.7)
    res = chaos_soak(eng, reqs, ber=0.0, seed=42, max_iters=200)
    assert res.healthy and res.statuses == {"ok": 5}
    assert [list(r.generated) for r in reqs] == want


def test_outlier_guard_at_full_fraction_serves_fault_free():
    """``protect_fraction=1.0`` restores every channel after each
    campaign: a soak at 1e-2 serves exactly as the fault-free engine."""
    model = _port_model()
    want = _serve(ServingEngine(model, quant_plan=QuantPlan.full(),
                                **ENGINE),
                  _requests(Request, model.cfg.vocab, temperature=0.7))
    eng = ServingEngine(model, quant_plan=QuantPlan.full(), **ENGINE)
    reqs = _requests(Request, model.cfg.vocab, temperature=0.7)
    res = chaos_soak(eng, reqs, ber=1e-2, seed=42, period=2,
                     protect_fraction=1.0, max_iters=200)
    assert res.healthy and res.chaos.bits_faulted > 0
    assert [list(r.generated) for r in reqs] == want


def test_paged_soak_keeps_invariants():
    """The paged engine under degraded mode and chaos at each BER, over a
    pool that preempts: every request terminal, every invariant clean,
    the pool drained and the weights restored."""
    model = _port_model()
    clean = quantized_leaves(model)
    eng = PagedServingEngine(model, quant_plan=QuantPlan.full(),
                             degraded=True, n_slots=2, max_len=32,
                             block_size=4, num_blocks=4, prefill_chunk=4)
    for ber in BERS:
        reqs = _requests(Request, model.cfg.vocab, temperature=0.7)
        res = chaos_soak(eng, reqs, ber=ber, **SOAK)
        assert res.healthy, res.violations
        eng.paged.allocator.check()
        assert eng.paged.allocator.n_used == 0
    assert eng.stats.preemptions > 0
    back = quantized_leaves(model)
    assert all(np.array_equal(back[p].q, clean[p].q) for p in clean)


def test_diffusion_fault_hook_fails_only_its_request():
    """A NaN planted in one latent of a batch fails that request only;
    the others are bitwise the undegraded engine's latents."""
    from repro_torch.diffusion import DiffusionEngine, ImageRequest
    from torch_parity import port_dit

    def run(**kw):
        eng = DiffusionEngine(port_dit(True), batch_size=4, **kw)
        reqs = [ImageRequest(uid=i, label=i % 3, num_steps=2, seed=5)
                for i in range(4)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        return reqs, eng

    want, _ = run()

    def hook(phase, lat):
        assert phase == "denoise" and lat.shape[0] == 4
        lat = lat.copy()
        lat[2, 0, 1, 1] = np.nan
        return lat
    got, eng = run(degraded=True, fault_hook=hook)
    assert [r.status.value for r in got] == ["ok", "ok", "failed", "ok"]
    assert eng.stats.failed == 1 and eng.stats.completed == 3
    for a, b in zip(got, want):
        if a.ok:
            assert np.array_equal(a.latents, b.latents)
