"""Shared helpers for the port's parity tests (``tests/test_torch_*.py``).

The JAX package is the reference: inputs are made with numpy from a
seed and handed to both sides; weights come from the reference's
``Model.init`` and cross over through numpy (bf16 bit for bit).
"""
from __future__ import annotations

import functools

import jax
import numpy as np
import torch

from repro.configs import get_config, get_dit_config, reduced_config
from repro.models import build_model

ARCH = "gemma-2b"
DIT_ARCH = "dit-test"


def rng(seed: int = 0) -> np.random.Generator:
    return np.random.default_rng(seed)


def to_np(a) -> np.ndarray:
    """A JAX or torch array as a float/int numpy array (bf16 -> f32)."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def rel_close(got, want, rel: float) -> None:
    """Same shape, and max |got - want| within ``rel`` of the largest
    |want|."""
    got, want = to_np(got), np.asarray(to_np(want), np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def t(a: np.ndarray, dtype: torch.dtype | None = None) -> torch.Tensor:
    """numpy -> CPU tensor (optionally cast)."""
    out = torch.from_numpy(np.array(a, copy=True))
    return out if dtype is None else out.to(dtype)


@functools.lru_cache(maxsize=None)
def smoke(arch: str = ARCH):
    """(jax cfg, jax model, jax params) of the reduced ``arch``."""
    cfg = reduced_config(get_config(arch))
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    return cfg, model, params


def numpy_tree(params):
    return jax.tree.map(np.asarray, params)


def port_model(plan=None, arch: str = ARCH):
    """A fresh port Model (CPU) holding the reference smoke weights of
    ``arch``, with ``plan`` (a port QuantPlan) applied."""
    from repro_torch.configs import get_config as tget
    from repro_torch.configs import reduced_config as tred
    from repro_torch.convert import params_from_jax
    _, _, params = smoke(arch)
    model = params_from_jax(numpy_tree(params), tred(tget(arch)),
                            device="cpu")
    return model if plan is None else model.quantize(plan)


@functools.lru_cache(maxsize=None)
def jax_dit(arch: str = DIT_ARCH):
    """(jax cfg, jax model, params, full-plan params) of the DiT
    ``arch``."""
    from repro.models.dit import DiTModel
    cfg = get_dit_config(arch)
    m = DiTModel(cfg)
    params = m.init(jax.random.PRNGKey(0))
    return cfg, m, params, m.quantize(params)


def port_dit(quantized: bool, arch: str = DIT_ARCH):
    """A fresh port DiTModel (CPU) holding the reference's weights of
    ``arch`` (its full-plan tree when ``quantized``)."""
    from repro_torch.configs import get_dit_config as tget_dit
    from repro_torch.convert import dit_params_from_jax
    _, _, params, qparams = jax_dit(arch)
    return dit_params_from_jax(numpy_tree(qparams if quantized else params),
                               tget_dit(arch), device="cpu")


def serve_jax(arch: str, engine_cls, jplan, prompts, uids=None,
              max_new_tokens: int = 8, **kw):
    """Serve ``prompts[uid]`` for each of ``uids`` (default all) on a
    fresh JAX engine of ``arch``'s smoke model; returns the requests and
    the top-2 logit margin of every sampled step, keyed (uid, step)."""
    from repro.serving import Request as JRequest
    _, jm, params = smoke(arch)
    eng = engine_cls(jm, params, quant_plan=jplan, **kw)
    margins = {}
    sample = eng._sample

    def recording(req, logits, step):
        top = np.sort(np.asarray(logits, np.float64))[-2:]
        margins[(req.uid, step)] = top[1] - top[0]
        return sample(req, logits, step)
    eng._sample = recording
    reqs = [JRequest(uid=i, prompt=prompts[i], max_new_tokens=max_new_tokens)
            for i in (range(len(prompts)) if uids is None else uids)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert all(r.status.value == "ok" for r in reqs)
    return reqs, margins


def assert_same_tokens(jreqs, margins, tokens, margin, name=""):
    """Greedy token streams equal to the reference's step for step up to
    the first step where they part, which must be a near tie (the
    reference's top-2 margin there at most ``margin``); at least half of
    all steps compared equal.  ``tokens``: the port's streams, in the
    order of ``jreqs``."""
    compared = total = 0
    for jr, toks in zip(jreqs, tokens):
        assert len(toks) == len(jr.generated), (name, jr.uid)
        total += len(toks)
        for step, (a, b) in enumerate(zip(jr.generated, toks)):
            if a != b:
                assert margins[(jr.uid, step)] <= margin, (
                    name, jr.uid, step, jr.generated, toks)
                break
            compared += 1
    assert compared >= total // 2, (name, compared, total)
