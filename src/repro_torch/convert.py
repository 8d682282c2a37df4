"""Load the JAX reference's parameters into the port's :class:`Model`.

``params_from_jax(tree, cfg)`` takes the reference's parameter tree as
numpy arrays (``jax.tree.map(np.asarray, params)``; bf16 leaves carry
the ``bfloat16`` dtype of ``ml_dtypes``) and returns a port model with
the same weights.  bf16 is read bit for bit through an int16 view, so
this module needs neither JAX nor ``ml_dtypes``.  The reference stacks
each group of identical layers on a leading axis; those leaves are
unstacked into per-layer blocks.  Quantized leaves (the reference's
``QuantizedLinear`` named tuples ``(q, scale)``: qkv q [d, H+2KH, Dh]
with scale [H+2KH, Dh], o q [H, Dh, d] with scale [d], MLP q [in, out]
with scale [out]) become the port's ``QuantizedLinear`` modules.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.quant.linear import QuantizedLinear


def to_torch(arr: np.ndarray, device) -> torch.Tensor:
    """numpy -> torch on ``device``; bf16 (``ml_dtypes``) bit for bit."""
    arr = np.array(arr, copy=True, order="C")   # writable, contiguous
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def _is_quantized(leaf) -> bool:
    return hasattr(leaf, "q") and hasattr(leaf, "scale") and \
        isinstance(leaf, tuple)


def _assign(module: torch.nn.Module, name: str, leaf, layer: int | None,
            device) -> None:
    """Set ``module.<name>`` from a (possibly stacked) reference leaf."""
    def pick(a):
        return to_torch(a if layer is None else a[layer], device)

    if _is_quantized(leaf):
        if hasattr(module, name):
            delattr(module, name)
        setattr(module, name, QuantizedLinear(pick(leaf.q), pick(leaf.scale)))
        return
    value = pick(leaf)
    current = getattr(module, name)
    if tuple(current.shape) != tuple(value.shape):
        raise ValueError(f"{name}: reference shape {tuple(value.shape)} != "
                         f"port shape {tuple(current.shape)}")
    with torch.no_grad():
        current.copy_(value.to(current.dtype))


def params_from_jax(tree: dict, cfg: ModelConfig, device=None) -> Model:
    """The reference's numpy parameter tree -> a port :class:`Model` on
    ``device`` (default: the card)."""
    device = resolve_device(device)
    model = Model(cfg)
    model.to_empty(device=device)
    _assign(model, "embed", tree["embed"]["embedding"], None, device)
    _assign(model, "final_norm", tree["final_norm"]["scale"], None, device)
    i = 0
    for gi, (_spec, count) in enumerate(cfg.layer_groups()):
        group = tree[f"group_{gi}"]
        for j in range(count):
            block = model.layers[i]
            _assign(block, "mixer_norm", group["mixer_norm"]["scale"], j,
                    device)
            _assign(block, "ffn_norm", group["ffn_norm"]["scale"], j, device)
            attn = group["attn"]
            if "qkv" in attn:
                for name in ("q", "k", "v"):
                    delattr(block.attn, name)
            for name, leaf in attn.items():
                _assign(block.attn, name, leaf, j, device)
            for name, leaf in group["mlp"].items():
                _assign(block.mlp, name, leaf, j, device)
            i += 1
    return model
