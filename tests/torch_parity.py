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

from repro.configs import get_config, reduced_config
from repro.models import build_model

ARCH = "gemma-2b"


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


def t(a: np.ndarray, dtype: torch.dtype | None = None) -> torch.Tensor:
    """numpy -> CPU tensor (optionally cast)."""
    out = torch.from_numpy(np.array(a, copy=True))
    return out if dtype is None else out.to(dtype)


@functools.lru_cache(maxsize=None)
def smoke():
    """(jax cfg, jax model, jax params) of the reduced gemma-2b."""
    cfg = reduced_config(get_config(ARCH))
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    return cfg, model, params


def numpy_tree(params):
    return jax.tree.map(np.asarray, params)


def port_model(plan=None):
    """A fresh port Model (CPU) holding the reference smoke weights,
    with ``plan`` (a port QuantPlan) applied."""
    from repro_torch.configs import get_config as tget
    from repro_torch.configs import reduced_config as tred
    from repro_torch.convert import params_from_jax
    _, _, params = smoke()
    model = params_from_jax(numpy_tree(params), tred(tget(ARCH)),
                            device="cpu")
    return model if plan is None else model.quantize(plan)
