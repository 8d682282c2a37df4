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
with scale [out]; MoE expert stacks q [E, in, out] with scale [E, out])
become the port's ``QuantizedLinear`` modules.  An MoE group's ``moe``
leaves (router, expert stacks ``up``/``gate``/``down``, the ``shared``
MLP), an MLA group's ``mla`` leaves (``q_down``, ``q_norm.scale``,
``q_up``, ``kv_down``, ``kv_norm.scale``, ``kv_up``, ``o`` [H, v, d]), a
Mamba-2 group's ``mamba`` leaves (``in_proj``, ``conv_w``, ``conv_b``,
``a_log``, ``d_skip``, ``dt_bias``, ``norm.scale``, ``out_proj``; no
FFN), an xLSTM group's ``mlstm`` or ``slstm`` leaves (the f32 gates,
``r`` and ``b`` stay f32; the sLSTM's ``ffn``; no FFN), an untied
``head.kernel``, the ``q_norm`` and ``k_norm`` scales of a ``qk_norm``
config, a vision config's ``frontend_proj.kernel`` and every norm's
``scale`` (and ``bias``, where a layernorm tree has one) cross over the
same way.  A leaf whose shape differs from the port's is refused, and so
is a leaf the port's module does not have, a group without its block's
mixer, and a tree whose ``q_norm`` or ``frontend_proj`` does not match
the config.

``dit_params_from_jax(tree, cfg)`` does the same for the reference's
``DiTModel`` tree: the scanned ``blocks`` axis is unstacked into the
port's :class:`~repro_torch.models.dit.DiTBlock` list, and quantized
block leaves (the adaLN kernel q [d, 6d] with scale [6d], the attention
and MLP leaves) cross over as ``QuantizedLinear`` modules.

``reference_paths(model)`` spells every parameter's path in the
reference's tree (``['group_0']['mixer_norm']['scale'][1]``: layer 1 of
the group's stacked leaf), the key of the optimizer's decay mask.
``quantized_paths(model)`` is the inverse map of the quantized leaves,
kept beside the loaders so the two cannot drift apart: the reference's
path of each stacked quantized leaf (``['group_0']['attn']['qkv']``,
``['group_0']['moe']['shared']['down']``, ``['blocks']['adaln']['kernel']``)
to the port's modules it stacks, in layer order (the fault campaigns of
:mod:`repro_torch.reliability.faults` draw per stacked leaf).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.dit import DiTConfig
from repro_torch.device import resolve_device
from repro_torch.models.dit import DiTModel
from repro_torch.models.model import MIXER_ATTR, Model
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
            device, shape: tuple | None = None) -> None:
    """Set ``module.<name>`` from a (possibly stacked) reference leaf.
    ``shape``: the port's shape of a leaf the module does not hold yet
    (the fused qkv)."""
    def pick(a):
        return to_torch(a if layer is None else a[layer], device)

    current = getattr(module, name, None)    # absent: the fused qkv
    if _is_quantized(leaf):
        q, scale = pick(leaf.q), pick(leaf.scale)
        want = tuple(current.shape) if isinstance(current, torch.Tensor) \
            else shape
        if want is not None and want != tuple(q.shape):
            raise ValueError(f"{name}: reference shape {tuple(q.shape)} != "
                             f"port shape {want}")
        if current is not None:
            delattr(module, name)
        setattr(module, name, QuantizedLinear(q, scale))
        return
    if current is None:
        raise ValueError(f"{type(module).__name__} has no leaf {name!r}")
    value = pick(leaf)
    if tuple(current.shape) != tuple(value.shape):
        raise ValueError(f"{name}: reference shape {tuple(value.shape)} != "
                         f"port shape {tuple(current.shape)}")
    with torch.no_grad():
        current.copy_(value.to(current.dtype))


def _assign_tree(module: torch.nn.Module, leaves: dict, layer: int,
                 device) -> None:
    """Each leaf of ``leaves`` into ``module``'s attribute of its name; a
    nested dict (a norm's ``{"scale": ...}``, the sLSTM's ``ffn``) into
    the submodule of its name."""
    for name, leaf in leaves.items():
        if isinstance(leaf, dict):
            sub = getattr(module, name, None)
            if not isinstance(sub, torch.nn.Module):
                raise ValueError(f"{type(module).__name__} has no module "
                                 f"{name!r}")
            _assign_tree(sub, leaf, layer, device)
        else:
            _assign(module, name, leaf, layer, device)


def _assign_attention(attn: torch.nn.Module, leaves: dict, layer: int,
                      device) -> None:
    """An attention layer's leaves; a fused ``qkv`` leaf replaces the
    module's q/k/v and must have their fused shape [d, H + 2*KH, Dh].
    The ``q_norm``/``k_norm`` leaves ({"scale": [Dh]}) go to the layer's
    scales of the same names."""
    if ("q_norm" in leaves) != hasattr(attn, "q_norm"):
        raise ValueError("q_norm/k_norm: the tree and the config disagree "
                         "on qk_norm")
    shape = None
    if "qkv" in leaves:
        d, H, Dh = attn.q.shape
        shape = (d, H + 2 * attn.k.shape[1], Dh)
        for name in ("q", "k", "v"):
            delattr(attn, name)
    for name, leaf in leaves.items():
        if name in ("q_norm", "k_norm"):
            _assign(attn, name, leaf["scale"], layer, device)
        else:
            _assign(attn, name, leaf, layer, device, shape=shape)


def _assign_norm(owner: torch.nn.Module, name: str, leaves: dict,
                 layer: int | None, device) -> None:
    """A norm's ``scale`` into ``owner.<name>``, and a layernorm's
    ``bias`` (when the tree has one) into a new ``owner.<name>_bias`` of
    the scale's shape."""
    _assign(owner, name, leaves["scale"], layer, device)
    if "bias" in leaves:
        scale = getattr(owner, name)
        setattr(owner, name + "_bias", torch.nn.Parameter(
            torch.empty_like(scale), requires_grad=False))
        _assign(owner, name + "_bias", leaves["bias"], layer, device)


def params_from_jax(tree: dict, cfg: ModelConfig, device=None) -> Model:
    """The reference's numpy parameter tree -> a port :class:`Model` on
    ``device`` (default: the card)."""
    device = resolve_device(device)
    model = Model(cfg)
    model.to_empty(device=device)
    _assign(model, "embed", tree["embed"]["embedding"], None, device)
    if not cfg.tie_embeddings:
        _assign(model, "head", tree["head"]["kernel"], None, device)
    _assign_norm(model, "final_norm", tree["final_norm"], None, device)
    if ("frontend_proj" in tree) != hasattr(model, "frontend_proj"):
        raise ValueError("frontend_proj: the tree and the config disagree")
    if "frontend_proj" in tree:
        _assign(model, "frontend_proj", tree["frontend_proj"]["kernel"],
                None, device)
    i = 0
    for gi, (_spec, count) in enumerate(cfg.layer_groups()):
        group = tree[f"group_{gi}"]
        for j in range(count):
            block = model.layers[i]
            i += 1
            _assign_norm(block, "mixer_norm", group["mixer_norm"], j, device)
            key = MIXER_ATTR[block.spec[0]]
            if key not in group:
                raise ValueError(f"group_{gi}: no {key!r} leaves for a "
                                 f"{block.spec[0]!r} block")
            if key == "attn":
                _assign_attention(block.attn, group["attn"], j, device)
            else:
                _assign_tree(block.mixer, group[key], j, device)
            if block.spec[1] == "none":       # a recurrent block: no FFN
                continue
            _assign_norm(block, "ffn_norm", group["ffn_norm"], j, device)
            if "moe" in group:
                moe = dict(group["moe"])
                for name, leaf in moe.pop("shared", {}).items():
                    _assign(block.moe.shared, name, leaf, j, device)
                for name, leaf in moe.items():
                    _assign(block.moe, name, leaf, j, device)
            else:
                for name, leaf in group["mlp"].items():
                    _assign(block.mlp, name, leaf, j, device)
    return model


def dit_params_from_jax(tree: dict, cfg: DiTConfig,
                        device=None) -> DiTModel:
    """The reference's numpy ``DiTModel`` parameter tree -> a port
    :class:`DiTModel` on ``device`` (default: the card)."""
    device = resolve_device(device)
    model = DiTModel(cfg)
    model.to_empty(device=device)
    for name in ("kernel", "bias"):
        _assign(model.patch_embed, name, tree["patch_embed"][name], None,
                device)
        for part in ("adaln", "linear"):
            _assign(getattr(model.final, part), name,
                    tree["final"][part][name], None, device)
    for name, leaf in tree["t_embed"].items():
        _assign(model.t_embed, name, leaf, None, device)
    _assign(model, "y_table", tree["y_embed"]["table"], None, device)
    blocks = tree["blocks"]
    for j, block in enumerate(model.blocks):
        _assign_attention(block.attn, blocks["attn"], j, device)
        for name, leaf in blocks["mlp"].items():
            _assign(block.mlp, name, leaf, j, device)
        for name, leaf in blocks["adaln"].items():
            _assign(block.adaln, name, leaf, j, device)
        _check_scales(block)
    return model


def _check_scales(block: torch.nn.Module) -> None:
    """Each quantized leaf's scale has its output channels' shape: the
    fused qkv's [H + 2*KH, Dh], every other leaf's [out]."""
    for mod in (block.attn, block.mlp, block.adaln):
        for name, leaf in mod.named_children():
            want = leaf.q.shape[1:] if name == "qkv" else leaf.q.shape[-1:]
            if tuple(leaf.scale.shape) != tuple(want):
                raise ValueError(f"{name}: reference scale shape "
                                 f"{tuple(leaf.scale.shape)} != port shape "
                                 f"{tuple(want)}")


# ---------------------------------------------------------------------------
# The reference's paths of the quantized leaves
# ---------------------------------------------------------------------------
def _leaf_paths(prefix: str, module: torch.nn.Module):
    """(path, leaf) of every :class:`QuantizedLinear` under ``module``,
    spelled as the reference's ``keystr`` spells its tree path."""
    for name, sub in module.named_modules():
        if isinstance(sub, QuantizedLinear):
            yield prefix + "".join(f"['{p}']" for p in name.split(".")), sub


def _spell(name: str) -> str:
    """The reference's ``keystr`` spelling of a parameter ``name``
    (dotted, relative to ``module``): a norm scale held as a tensor
    (``mixer_norm``, ``ffn_norm``, ``final_norm``, attention's
    ``q_norm``/``k_norm``) is the reference's ``<norm>['scale']``, its
    ``<norm>_bias`` the reference's ``<norm>['bias']``."""
    parts = name.split(".")
    last = parts[-1]
    if last.endswith("_norm_bias"):
        parts[-1:] = [last[: -len("_bias")], "bias"]
    elif last.endswith("_norm"):
        parts.append("scale")
    return "".join(f"['{p}']" for p in parts)


def reference_paths(model: Model) -> dict[str, torch.nn.Parameter]:
    """Every parameter of an LM ``model`` keyed by its path in the
    reference's tree, in the model's order: the outer leaves as the
    reference names them (``['embed']['embedding']``,
    ``['head']['kernel']``, ``['frontend_proj']['kernel']``,
    ``['final_norm']['scale']``), a block's leaves under its group with
    the layer's index in the group's stack last (``['group_0']['attn']
    ['q'][1]``)."""
    outer = {"embed": "['embed']['embedding']", "head": "['head']['kernel']",
             "frontend_proj": "['frontend_proj']['kernel']"}
    out: dict[str, torch.nn.Parameter] = {}
    for name, p in model.named_parameters(recurse=False):
        out[outer.get(name) or _spell(name)] = p
    i = 0
    for gi, (_spec, count) in enumerate(model.cfg.layer_groups()):
        for j in range(count):
            block = model.layers[i]
            i += 1
            for name, p in block.named_parameters():
                out[f"['group_{gi}']{_spell(name)}[{j}]"] = p
    return out


def quantized_paths(model) -> dict[str, list[QuantizedLinear]]:
    """The reference's ``keystr`` path of each stacked quantized leaf ->
    the port's :class:`QuantizedLinear` modules it stacks, in layer
    order: the inverse of the unstacking above.  An LM's group ``gi``
    stacks its layers' leaves under ``['group_<gi>']['<mixer key>']...``
    and ``['group_<gi>']['mlp' | 'moe']...`` (the MoE's shared MLP under
    ``['moe']['shared']``); a DiT's blocks under ``['blocks']['attn' |
    'mlp' | 'adaln']...``.  So a stacked leaf of the reference is
    ``np.stack`` of these modules' tensors."""
    out: dict[str, list[QuantizedLinear]] = {}
    if isinstance(model, DiTModel):
        parts = [("['blocks']", block, key) for block in model.blocks
                 for key in ("attn", "mlp", "adaln")]
    else:
        parts, i = [], 0
        for gi, (spec, count) in enumerate(model.cfg.layer_groups()):
            for _ in range(count):
                block = model.layers[i]
                i += 1
                parts.append((f"['group_{gi}']", block, MIXER_ATTR[spec[0]]))
                if spec[1] != "none":
                    parts.append((f"['group_{gi}']", block,
                                  "moe" if spec[1] == "moe" else "mlp"))
    for prefix, block, key in parts:
        for path, leaf in _leaf_paths(f"{prefix}['{key}']",
                                      getattr(block, key)):
            out.setdefault(path, []).append(leaf)
    return out
