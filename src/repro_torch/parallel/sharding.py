"""Logical-axis rules and shard placement (port of
``repro/parallel/sharding.py`` and of ``Model.quantize(mesh=)``).

The logical axes: every parameter, optimizer-state, cache and input leaf
carries a tuple of logical axis names (:func:`param_axes`,
:func:`cache_axes`, the reference's ``Model.param_axes()`` and
``cache_axes()`` by the same paths), and :func:`resolve_spec` binds them
to a grid, an ordered mapping from mesh axis name to size
(``launch.mesh``), by the reference's greedy two-pass rule with its
divisibility fallback.  A spec is a tuple with one entry a dimension:
None, an axis name or a tuple of names (the reference's
``PartitionSpec``).  The dry run (``launch.dryrun``) sums each leaf's
shard under it; the data-parallel train step (``launch.steps``) splits
the batch by :func:`batch_sharding` and its moments by the ``fsdp``
axis (:func:`local_slices`).

Tensor parallelism (the divisibility fallback for the ``heads``,
``kv_heads``, ``mlp``, ``expert``, ``vocab`` and ``kv_seq`` axes, and
the logical axes the reference's bf16 mixers carry):

:func:`shard_model` cuts, in place, a model's leaves to one rank's
shards; a quantized leaf's ``q`` and ``scale`` stay co-sharded on the
output-channel axis.  A dimension that the group size does not divide
keeps its leaves whole on every rank (the reference's replicate-on-
indivisible rule), and the layers then run the unsharded path.  The
norms (``qk_norm``'s per-head weight and layernorm's included),
``frontend_proj``, the router and DiT's adaLN stay whole (adaLN's six
chunks are needed whole on every rank).  A sharded model records the
rank it holds (``tp_rank``, ``tp_size``).

Each kind of layer and how a rank holds it:

* the vocabulary: the embedding's rows and the untied head's columns
  (DiT: the label table's rows) where the ``vocab`` axis binds the
  group, ``resolve_spec`` of ``("vocab", "fsdp")`` on ``{"model": p}``
  (every LM config's vocabulary divides 2 and 4; DiT's 1001 and 17
  label rows do not, and stay whole): a lookup reads zero outside the
  rank's rows and the ranks' rows are summed, the logits are the
  rank's columns gathered (:mod:`repro_torch.models.layers`).
* attention (int8): the columns laid out as [its q heads | its k heads |
  its v heads]: q heads shard when ``H % p == 0``; K/V heads shard when
  ``KH % p == 0``, and are otherwise computed whole on every rank (an
  MQA head, ``KH == 1``; other indivisible KV counts keep the attention
  whole).  Each rank attends its own q heads, and its attention output
  is the row-parallel out-projection's input shard.
* the ring cache and MLA's latent cache: cut by :func:`seq_cut_slots`,
  ``resolve_spec`` of :func:`cache_axes` on ``{"model": p}``: where the
  KV heads cannot take the model axis (an MQA head; MLA's latent has
  none) ``kv_seq`` binds it, and rank r holds the slots
  ``[r cap / p, (r + 1) cap / p)`` (a capacity that p does not divide
  stays whole); the rank's slot range is recorded on the cache's
  ``k`` or ``c_kv`` leaf (:func:`record_slot_range`), where the layer
  reads it.  The paged pools carry no ``kv_seq`` axis and hold their
  KV heads as the layer does.
* MLP (int8): up/gate column-parallel, down row-parallel; routed expert
  stacks on their leading expert axis.
* the bf16 mixers shard by head and gather the heads' outputs (one
  all-gather a layer and forward) before a whole out-projection, so
  every rank computes the unsharded mixer's function:
  Mamba-2 (``in_proj``'s z, x and dt columns, the conv channels,
  ``a_log``, ``d_skip``, ``dt_bias`` of the rank's SSM heads; B and C
  whole unless the group size divides the groups), MLA (``q_up`` and
  ``kv_up``; the down-projections whole, the latent cache by sequence
  as above), the mLSTM (``q``, ``k``, ``v``, the gates and the chunk
  state; ``up`` and the conv whole, as every head reads all of the
  conv's channels) and the sLSTM (``r``, ``b`` and the carry: its
  recurrence is block-diagonal by head).  The f32 input products of
  the mLSTM's gates and the sLSTM keep their small weights whole and
  are cut after the product: a column slice of an f32 product rounds
  apart from the whole one on the card.

A cut is a dict {axis: the global indices a rank keeps}.  A cut
quantized leaf records them (``tp_index``, and the whole leaf's shape
``tp_shape``; its scale's, ``tp_scale_index`` and ``tp_scale_shape``):
a weight fault drawn over the whole leaf lands on the rank that holds
it, and outlier protection ranks the whole leaf's channels
(:mod:`repro_torch.reliability.faults`).

:func:`draw_sharded` fills a model on the meta device with
``init``'s weights one leaf at a time, each quantized (where the plan
covers it) and cut before the next is drawn: a rank then holds its
shards and one leaf's f32 temporary at most, never the whole model.
"""
from __future__ import annotations

import logging
import re
from typing import Callable, Optional

import torch
from torch import nn

from repro_torch.quant.linear import QuantizedLinear, quantize_linear
from repro_torch.quant.plan import FULL_INT8, covered_kinds
from .context import TPGroup

log = logging.getLogger(__name__)

Cut = dict   # axis -> LongTensor: the global indices a rank keeps


# ---------------------------------------------------------------------------
# Logical axes and the rules
# ---------------------------------------------------------------------------
# logical axis -> candidate mesh axes (in binding-priority order)
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "fsdp": ("pod", "data"),        # ZeRO parameter/optimizer sharding
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "expert": ("model",),           # expert parallelism
    # context parallelism: binds whatever the structural dims left free
    "kv_seq": ("data", "model"),
    "layers": (),                   # the reference's scan axis: replicated
}

# experts spread over both axes
EP_WIDE_RULES = dict(DEFAULT_RULES, expert=("model", "data"))

Spec = tuple    # per dimension: None, a mesh axis name or a tuple of names


def resolve_spec(shape: tuple, axes: Optional[tuple], grid: dict,
                 rules: Optional[dict] = None) -> Spec:
    """One leaf's logical ``axes`` bound to ``grid`` (mesh axis -> size,
    in order): each logical axis takes its rule's mesh axes in order,
    each mesh axis at most once a leaf, skipping one whose size (times
    the sizes already taken for this dimension) does not divide the
    dimension.  ``kv_seq`` binds in a second pass, to the mesh axes the
    other dimensions left free.  No axes, a scalar or axes of another
    rank than ``shape``: replicated (``()``)."""
    rules = rules or DEFAULT_RULES
    if axes is None or len(shape) == 0 or len(axes) != len(shape):
        return ()
    used: set = set()
    parts: list = [None] * len(shape)

    def bind(i: int, dim: int, logical: str) -> None:
        chosen, prod = [], 1
        for cand in rules.get(logical, ()):
            if cand in used or cand not in grid:
                continue
            if dim % (prod * grid[cand]) == 0:
                chosen.append(cand)
                used.add(cand)
                prod *= grid[cand]
        parts[i] = (tuple(chosen) if len(chosen) > 1
                    else (chosen[0] if chosen else None))

    for i, (dim, logical) in enumerate(zip(shape, axes)):
        if logical is not None and logical != "kv_seq":
            bind(i, dim, logical)
    for i, (dim, logical) in enumerate(zip(shape, axes)):
        if logical == "kv_seq":
            bind(i, dim, logical)
    return tuple(parts)


def _tree_map(fn, tree, other):
    """``fn(leaf, other_leaf)`` over two trees of one structure (dicts,
    lists and tuples; a tuple in ``other`` is a leaf: its axes)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, a, b) for a, b in zip(tree, other))
    return fn(tree, other)


def make_shardings(grid: dict, shapes, axes,
                   rules: Optional[dict] = None):
    """The spec of every leaf of ``shapes`` (a tree of tensors, ``meta``
    ones included) under its logical axes in ``axes`` (the same tree,
    tuples at the leaves)."""
    return _tree_map(lambda t, a: resolve_spec(tuple(t.shape), a, grid,
                                               rules), shapes, axes)


def batch_sharding(grid: dict, rules: Optional[dict] = None,
                   batch: Optional[int] = None) -> Spec:
    """The spec of a [batch, ...] input: its leading dimension over the
    ``batch`` rule's mesh axes.  With ``batch`` (the global batch size)
    a mesh axis whose size, times those already taken, does not divide
    it is skipped (a batch of 6 on pod 2, data 4 binds pod only; a
    batch of 5 replicates); without, every axis of the rule in the grid
    binds."""
    rules = rules or DEFAULT_RULES
    axes, prod = [], 1
    for a in rules["batch"]:
        if a not in grid:
            continue
        if batch is not None and batch % (prod * grid[a]) != 0:
            continue
        axes.append(a)
        prod *= grid[a]
    return (tuple(axes) if len(axes) > 1 else (axes[0] if axes else None),)


def input_shardings(grid: dict, specs: dict,
                    rules: Optional[dict] = None) -> dict:
    """Every batch input sharded on its leading (batch) dimension where
    the grid divides it (:func:`batch_sharding`); a scalar replicated."""
    return {k: batch_sharding(grid, rules, batch=t.shape[0]) if t.dim()
            else () for k, t in specs.items()}


def _bound(part) -> tuple:
    return () if part is None else (part,) if isinstance(part, str) \
        else tuple(part)


def shard_shape(shape: tuple, spec: Spec, grid: dict) -> tuple:
    """The shape of one rank's shard of a leaf of ``shape`` under
    ``spec`` (every bound dimension divides, :func:`resolve_spec`)."""
    out = list(shape)
    for i, part in enumerate(spec):
        for a in _bound(part):
            out[i] //= grid[a]
    return tuple(out)


def shard_nbytes(t: torch.Tensor, spec: Spec, grid: dict) -> int:
    """Bytes of one rank's shard of ``t`` under ``spec``."""
    n = 1
    for d in shard_shape(tuple(t.shape), spec, grid):
        n *= d
    return n * t.element_size()


def local_slices(shape: tuple, spec: Spec, grid: dict,
                 rank: int) -> tuple:
    """Rank ``rank``'s shard of a leaf as one slice a dimension: ranks
    number the grid's points in its axes' order, the last fastest (a
    ``{"data": 2}`` grid: rank r is data index r)."""
    coords, rest = {}, rank
    for a in reversed(list(grid)):
        coords[a] = rest % grid[a]
        rest //= grid[a]
    out = []
    for i, dim in enumerate(shape):
        names = _bound(spec[i]) if i < len(spec) else ()
        index, count = 0, 1
        for a in names:
            index, count = index * grid[a] + coords[a], count * grid[a]
        k = dim // count
        out.append(slice(index * k, (index + 1) * k))
    return tuple(out)


# A leaf's logical axes by its path in the reference's tree (a block's
# leaves relative to its group, without the group's "layers" axis).
_OUTER_AXES = {
    "['embed']['embedding']": ("vocab", "fsdp"),
    "['head']['kernel']": ("fsdp", "vocab"),
    "['frontend_proj']['kernel']": ("fsdp", None),
}
_MLP_AXES = {"up": ("fsdp", "mlp"), "gate": ("fsdp", "mlp"),
             "down": ("mlp", "fsdp")}
_BLOCK_AXES = {
    **{f"['mlp']['{k}']": a for k, a in _MLP_AXES.items()},
    **{f"['moe']['shared']['{k}']": a for k, a in _MLP_AXES.items()},
    **{f"['slstm']['ffn']['{k}']": a for k, a in _MLP_AXES.items()},
    "['attn']['q']": ("fsdp", "heads", None),
    "['attn']['k']": ("fsdp", "kv_heads", None),
    "['attn']['v']": ("fsdp", "kv_heads", None),
    "['attn']['o']": ("heads", None, "fsdp"),
    "['moe']['router']": ("fsdp", None),
    "['moe']['up']": ("expert", "fsdp", "mlp"),
    "['moe']['gate']": ("expert", "fsdp", "mlp"),
    "['moe']['down']": ("expert", "mlp", "fsdp"),
    "['mamba']['in_proj']": ("fsdp", "mlp"),
    "['mamba']['conv_w']": (None, "mlp"),
    "['mamba']['conv_b']": ("mlp",),
    "['mamba']['a_log']": ("heads",),
    "['mamba']['d_skip']": ("heads",),
    "['mamba']['dt_bias']": ("heads",),
    "['mamba']['out_proj']": ("mlp", "fsdp"),
    "['mla']['q_down']": ("fsdp", None),
    "['mla']['q_up']": (None, "heads", None),
    "['mla']['kv_down']": ("fsdp", None),
    "['mla']['kv_up']": (None, "heads", None),
    "['mla']['o']": ("heads", None, "fsdp"),
    "['mlstm']['up']": ("fsdp", "mlp"),
    "['mlstm']['conv_w']": (None, "mlp"),
    "['mlstm']['conv_b']": ("mlp",),
    "['mlstm']['q']": ("mlp", "heads", None),
    "['mlstm']['k']": ("mlp", "heads", None),
    "['mlstm']['v']": ("mlp", "heads", None),
    "['mlstm']['igate']": (None, "heads"),
    "['mlstm']['fgate']": (None, "heads"),
    "['mlstm']['fgate_b']": ("heads",),
    "['mlstm']['down']": ("mlp", "fsdp"),
    "['slstm']['w']": ("fsdp", None, "heads", None),
    "['slstm']['r']": (None, "heads", None, None),
    "['slstm']['b']": (None, "heads", None),
}
_GROUP_PATH = re.compile(r"^\['group_\d+'\](.*)\[\d+\]$")


def _leaf_axes(path: str, ndim: int) -> tuple:
    m = _GROUP_PATH.match(path)
    rel = m.group(1) if m else path
    axes = (_BLOCK_AXES if m else _OUTER_AXES).get(rel)
    if axes is None and rel.endswith(("['scale']", "['bias']")):
        axes = (None,) * ndim            # a norm: replicated
    if axes is None or len(axes) != ndim:
        raise KeyError(f"no logical axes for {path} ({ndim}-d)")
    return axes


def param_axes(model) -> dict:
    """The logical axes of every parameter of an unquantized LM
    ``model``, keyed as :func:`repro_torch.convert.reference_paths` keys
    them (a block's leaf with its layer index last): the reference's
    ``Model.param_axes()`` by the same paths, without the stacked
    groups' leading ``"layers"`` axis (replicated under every rule)."""
    from repro_torch.convert import reference_paths
    return {k: _leaf_axes(k, p.dim())
            for k, p in reference_paths(model).items()}


_KV_AXES = {"k": ("batch", "kv_seq", "kv_heads", None),
            "v": ("batch", "kv_seq", "kv_heads", None),
            "k_scale": ("batch", "kv_seq", "kv_heads"),
            "v_scale": ("batch", "kv_seq", "kv_heads"),
            "pos": ("batch", "kv_seq"), "index": ("batch",)}
_CACHE_AXES = {
    "mla": {"c_kv": ("batch", "kv_seq", None),
            "k_rope": ("batch", "kv_seq", None), "index": ("batch",)},
    "mamba2": {"conv": ("batch", None, "mlp"),
               "ssm": ("batch", "heads", None, None), "index": ("batch",)},
    "mlstm": {"conv": ("batch", None, "mlp"),
              "C": ("batch", "heads", None, None),
              "n": ("batch", "heads", None), "m": ("batch", "heads"),
              "index": ("batch",)},
    "slstm": {"c": ("batch", "heads", None), "n": ("batch", "heads", None),
              "h": ("batch", "heads", None), "m": ("batch", "heads", None),
              "index": ("batch",)},
}


def cache_axes(model, kv_dtype: Optional[str] = None) -> list:
    """The logical axes of ``model.init_cache(batch, max_len,
    kv_dtype)``'s leaves, one dict a layer (the reference's
    ``cache_axes()`` without the ``"layers"`` axis; the int8 scales
    where ``kv_dtype``, default the config's, is int8)."""
    int8 = (kv_dtype or model.cfg.kv_cache_dtype) == "int8"
    out = []
    for block in model.layers:
        mixer = block.spec[0]
        if mixer in _CACHE_AXES:
            out.append(dict(_CACHE_AXES[mixer]))
        else:
            out.append({k: a for k, a in _KV_AXES.items()
                        if int8 or not k.endswith("_scale")})
    return out


def cache_span(cfg, mixer: str, max_len: int) -> int:
    """The slots a ``mixer`` layer's ring cache of ``max_len`` holds: a
    sliding-window layer only the window."""
    if mixer == "attn_local" and cfg.sliding_window:
        return min(max_len, cfg.sliding_window)
    return max_len


def leaf_seq_slots(leaf: str, shape: tuple, p: int) -> Optional[int]:
    """The slots a tensor-parallel rank of ``p`` holds of a ring cache's
    ``k`` or an MLA latent cache's ``c_kv`` leaf of the whole ``shape``:
    ``shape[1] // p`` where :func:`resolve_spec` binds the leaf's
    ``kv_seq`` axis to the model axis of ``{"model": p}`` (the KV heads,
    if any, cannot take it and p divides the capacity), rank r the slots
    [r n, (r + 1) n); None where the slots stay whole (p 1 cuts
    nothing)."""
    axes = _CACHE_AXES["mla"]["c_kv"] if leaf == "c_kv" else _KV_AXES[leaf]
    if p <= 1:
        return None
    i = axes.index("kv_seq")
    if resolve_spec(tuple(shape), axes, {"model": p})[i] != "model":
        return None
    return shape[i] // p


def seq_cut_slots(cfg, mixer: str, p: int, max_len: int) -> Optional[int]:
    """The one rule for context parallelism at serving: the slots a rank
    of ``p`` holds of a ``mixer`` layer's ring cache (its
    :func:`cache_span`) or MLA latent cache of ``max_len`` slots
    (:func:`leaf_seq_slots` of the whole leaf), None where the cache
    stays whole or the layer holds none (a recurrent state).
    ``Model.init_cache`` allocates by it and the manifest counts by
    it."""
    if mixer == "mla":
        return leaf_seq_slots("c_kv", (1, max_len, cfg.mla.kv_lora_rank),
                              p)
    if mixer not in ("attn", "attn_local"):
        return None
    return leaf_seq_slots("k", (1, cache_span(cfg, mixer, max_len),
                                cfg.n_kv_heads, cfg.head_dim), p)


def record_slot_range(leaf: torch.Tensor, first: int, slots: int) -> None:
    """Record on a rank's cache leaf that it holds the slots ``[first,
    first + leaf.shape[1])`` of a cache of ``slots`` slots cut by
    sequence (read back by :func:`slot_range`)."""
    leaf.kv_seq = (first, slots)


def slot_range(leaf: torch.Tensor) -> Optional[tuple[int, int]]:
    """(the first slot, the whole capacity) recorded on ``leaf`` or, for
    a view of it (the engine's slot view), on the leaf it views; None
    for a whole cache."""
    base = leaf if leaf._base is None else leaf._base
    return getattr(base, "kv_seq", None)


def _span(n: int, group: TPGroup) -> torch.Tensor:
    k = n // group.size
    return torch.arange(group.rank * k, (group.rank + 1) * k)


def _take(t: torch.Tensor, cut: Cut) -> torch.Tensor:
    """``t`` cut on each axis of ``cut`` (a copy; ``t`` itself when the
    cut is empty)."""
    for axis, idx in sorted(cut.items()):
        t = t.index_select(axis, idx.to(t.device))
    return t.contiguous()


def cut_quantized(w: QuantizedLinear, q_cut: Cut, scale_cut: Cut,
                  p: int) -> None:
    """Keep the rank's part of ``w.q`` and ``w.scale`` (copies, so the
    whole tensors are released), record where it lies in the whole leaf
    and mark ``w`` sharded ``p`` ways."""
    w.tp_shape = tuple(w.q.shape)
    w.tp_index = tuple(q_cut.get(a) for a in range(w.q.dim()))
    w.tp_scale_shape = tuple(w.scale.shape)
    w.tp_scale_index = tuple(scale_cut.get(a)
                             for a in range(w.scale.dim()))
    w.q = _take(w.q, q_cut)
    w.scale = _take(w.scale, scale_cut)
    w.tp_size = p


def _cut_param(owner: nn.Module, name: str, cut: Cut) -> None:
    t = getattr(owner, name)
    setattr(owner, name, nn.Parameter(_take(t.detach(), cut),
                                      requires_grad=False))
    owner.__dict__.setdefault("_tp_cut", set()).add(name)


# ---------------------------------------------------------------------------
# The cuts of each layer kind: {leaf: cut} (a quantized leaf's scale under
# "<leaf>.scale"), or None when the layer stays whole
# ---------------------------------------------------------------------------
def attention_cuts(H: int, KH: int, group: TPGroup) -> Optional[dict]:
    p = group.size
    kv_split = KH % p == 0
    if H % p or not (kv_split or KH == 1):
        return None
    qh = _span(H, group)
    kv = _span(KH, group) if kv_split else torch.arange(KH)
    wide = torch.cat([qh, H + kv, H + KH + kv])
    return {"q": {1: qh}, "k": {1: kv}, "v": {1: kv}, "o": {0: qh},
            "o.scale": {}, "qkv": {1: wide}, "qkv.scale": {0: wide}}


def mlp_cuts(F: int, group: TPGroup) -> Optional[dict]:
    if F % group.size:
        return None
    c = _span(F, group)
    return {"up": {1: c}, "up.scale": {0: c}, "gate": {1: c},
            "gate.scale": {0: c}, "down": {0: c}, "down.scale": {}}


def expert_cuts(E: int, group: TPGroup) -> Optional[dict]:
    if E % group.size:
        return None
    e = _span(E, group)
    return {name + sfx: {0: e} for name in ("up", "gate", "down")
            for sfx in ("", ".scale")}


def mamba_cuts(ssm, d_model: int, group: TPGroup) -> Optional[dict]:
    H, P, N, G = (ssm.n_heads(d_model), ssm.head_dim, ssm.state_dim,
                  ssm.n_groups)
    p = group.size
    if H % p or (G > 1 and G % p):
        return None
    di = ssm.d_inner(d_model)
    heads = _span(H, group)
    ch = (heads[:, None] * P + torch.arange(P)).reshape(-1)
    groups = _span(G, group) if G > 1 else torch.arange(G)
    gch = (groups[:, None] * N + torch.arange(N)).reshape(-1)
    GN = G * N
    cols = torch.cat([ch, di + ch, 2 * di + gch, 2 * di + GN + gch,
                      2 * di + 2 * GN + heads])
    conv = torch.cat([ch, di + gch, di + GN + gch])
    return {"in_proj": {1: cols}, "conv_w": {1: conv}, "conv_b": {0: conv},
            "a_log": {0: heads}, "d_skip": {0: heads},
            "dt_bias": {0: heads}}


def mla_cuts(H: int, group: TPGroup) -> Optional[dict]:
    if H % group.size:
        return None
    h = _span(H, group)
    return {"q_up": {1: h}, "kv_up": {1: h}}


def mlstm_cuts(H: int, group: TPGroup) -> Optional[dict]:
    """q, k and v by head; the gates' weights stay whole (their f32
    products are cut after them, as the sLSTM's input projection)."""
    if H % group.size:
        return None
    h = _span(H, group)
    return {"q": {1: h}, "k": {1: h}, "v": {1: h}}


def slstm_cuts(H: int, group: TPGroup) -> Optional[dict]:
    """The recurrent weights ``r`` and ``b`` by head; the input
    projection ``w`` stays whole (its f32 product is cut after it: a
    column slice of it rounds apart from the whole on the card)."""
    if H % group.size:
        return None
    h = _span(H, group)
    return {"r": {1: h}, "b": {1: h}}


def _apply_cuts(mod: nn.Module, cuts: dict, p: int) -> None:
    """Cut each of ``mod``'s leaves named in ``cuts`` that is not cut yet,
    and mark ``mod`` sharded ``p`` ways."""
    done = mod.__dict__.get("_tp_cut", set())
    for name, cut in cuts.items():
        if name.endswith(".scale"):
            continue
        leaf = getattr(mod, name, None)
        if isinstance(leaf, QuantizedLinear):
            if leaf.tp_size is None:
                cut_quantized(leaf, cut, cuts.get(name + ".scale", {}), p)
        elif isinstance(leaf, torch.Tensor) and name not in done:
            _cut_param(mod, name, cut)
    mod.tp_size = p


def vocab_cuts(model, group: TPGroup) -> Optional[dict]:
    """The rows of the embedding (DiT: the label table) and the columns
    of the untied head that ``group.rank`` holds, when the ``vocab`` axis
    binds the model axis (:func:`resolve_spec` of ``("vocab", "fsdp")``
    on ``{"model": p}``: p divides the rows); None when they stay whole
    (a group of one rank cuts nothing by vocabulary)."""
    table = "y_table" if hasattr(model, "blocks") else "embed"
    V, d = getattr(model, table).shape
    if group.size <= 1 or resolve_spec(
            (V, d), _OUTER_AXES["['embed']['embedding']"],
            {"model": group.size})[0] != "model":
        return None
    rows = _span(V, group)
    cuts = {table: {0: rows}}
    if hasattr(model, "head"):
        cuts["head"] = {1: rows}
    return cuts


BF16_MIXERS = ("mamba2", "mla", "mlstm", "slstm")
# parts cut whether or not the plan quantized them
PLAIN_PARTS = BF16_MIXERS + ("vocab",)


def _layer_parts(model, group: TPGroup) -> list:
    """(kind, module, cuts or None) for every layer part of ``model`` (an
    LM or a DiT) that tensor parallelism may shard, the cuts from the
    config's (whole) dimensions."""
    cfg = model.cfg
    parts = [("vocab", model, vocab_cuts(model, group))]
    if hasattr(model, "blocks"):                     # DiT: H = KH
        return parts + [part for block in model.blocks for part in (
            ("attention", block.attn,
             attention_cuts(cfg.n_heads, cfg.n_heads, group)),
            ("mlp", block.mlp, mlp_cuts(cfg.d_ff, group)))]
    for block in model.layers:
        mixer, ffn = block.spec
        if mixer in ("attn", "attn_local"):
            cuts = attention_cuts(cfg.n_heads, cfg.n_kv_heads, group)
            parts.append(("attention", block.attn, cuts))
        elif mixer == "mamba2":
            parts.append(("mamba2", block.mamba,
                          mamba_cuts(cfg.ssm, cfg.d_model, group)))
        elif mixer == "mla":
            parts.append(("mla", block.mla, mla_cuts(cfg.n_heads, group)))
        elif mixer == "mlstm":
            parts.append(("mlstm", block.mlstm,
                          mlstm_cuts(cfg.xlstm.n_heads, group)))
        elif mixer == "slstm":
            parts.append(("slstm", block.slstm,
                          slstm_cuts(cfg.xlstm.n_heads, group)))
        if ffn == "moe":
            parts.append(("experts", block.moe,
                          expert_cuts(cfg.moe.n_routed_experts, group)))
            if hasattr(block.moe, "shared"):
                parts.append(("shared mlp", block.moe.shared,
                              mlp_cuts(cfg.moe.shared_width, group)))
        elif ffn == "dense":
            parts.append(("mlp", block.mlp, mlp_cuts(cfg.d_ff, group)))
    return parts


def _quantized(kind: str, mod: nn.Module) -> bool:
    names = ("qkv", "o") if kind == "attention" else ("up", "down")
    return all(isinstance(getattr(mod, n, None), QuantizedLinear)
               for n in names)


def _sharded_ways(mod: nn.Module) -> Optional[int]:
    """The group size ``mod`` was sharded for (its own mark, or its
    quantized leaves'), None if whole."""
    ways = {w.tp_size for w in mod.children()
            if isinstance(w, QuantizedLinear) and w.tp_size is not None}
    return getattr(mod, "tp_size", None) or (ways.pop() if ways else None)


def shard_model(model, group: TPGroup):
    """Cut the leaves of ``model`` (an LM or a DiT) to ``group.rank``'s
    shards, in place; returns the model, marked with the rank it holds
    (``tp_rank``, ``tp_size``: its ring and latent caches are cut by
    sequence from them, ``Model.init_cache``).  Attention and the MLPs
    shard once quantized (their bf16 forms stay whole); the bf16 mixers
    (Mamba-2, MLA, mLSTM, sLSTM) shard by head, the vocabulary by rows.
    Modules already sharded for a group of this size are left as they
    are (for another size: raises).  Each layer kind that stays whole
    (not quantized, or a dimension that ``group.size`` does not divide)
    is logged once."""
    held = getattr(model, "tp_rank", None)
    if held is not None and (held, model.tp_size) != (group.rank,
                                                      group.size):
        raise ValueError(f"the model holds rank {held} of "
                         f"{model.tp_size}, not rank {group.rank} of "
                         f"{group.size}")
    whole = set()
    for kind, mod, cuts in _layer_parts(model, group):
        ways = _sharded_ways(mod)
        if ways is not None and kind != "vocab":
            if ways != group.size:
                raise ValueError(f"{kind} is sharded {ways} ways, not "
                                 f"{group.size}")
            continue
        if cuts is None or (kind not in PLAIN_PARTS
                            and not _quantized(kind, mod)):
            whole.add(kind)
            continue
        _apply_cuts(mod, cuts, group.size)
        if kind == "attention":
            mod.n_kv_heads = len(cuts["k"][1])
    model.tp_rank, model.tp_size = group.rank, group.size
    for kind in sorted(whole):
        log.info("tensor parallelism over %d ranks: the %s stays whole "
                 "(not quantized, or a dimension %d does not divide)",
                 group.size, kind, group.size)
    return model


# ---------------------------------------------------------------------------
# Drawing only a rank's shards
# ---------------------------------------------------------------------------
class _Drawer:
    """The sink of :func:`repro_torch.models.layers.truncated_normal_`
    while a meta model is drawn (:func:`draw_sharded`): each drawn leaf
    is quantized where the plan covers its layer, cut by its layer's
    cuts, and placed in its module."""

    def __init__(self, model, group: TPGroup, plan, device):
        self.group, self.device = group, device
        self.drawn: set = set()
        self.owners = {id(p): (mod, name) for mod in model.modules()
                       for name, p in mod._parameters.items()
                       if p is not None}
        self.parts = {id(mod): (kind, cuts)
                      for kind, mod, cuts in _layer_parts(model, group)}
        # the module -> its quantized kind, as the plan's rewrite
        # (quant/plan.py) would quantize it after a whole draw
        self.quant: dict = {}
        both = plan.covers("attn_qkv") and plan.covers("attn_out")
        if hasattr(model, "blocks"):
            for block in model.blocks:
                if both:
                    self.quant[id(block.attn)] = "attention"
                if plan.covers("mlp"):
                    self.quant[id(block.mlp)] = "mlp"
                if plan.covers("adaln"):
                    self.quant[id(block.adaln)] = "adaln"
        else:
            for block in model.layers:
                kinds = covered_kinds(*block.spec)
                if both and "attn_qkv" in kinds:
                    self.quant[id(block.attn)] = "attention"
                if "mlp" in kinds and plan.covers("mlp"):
                    self.quant[id(block.mlp)] = "mlp"
                if "moe_experts" in kinds and plan.covers("moe_experts"):
                    self.quant[id(block.moe)] = "experts"
                    if hasattr(block.moe, "shared"):
                        self.quant[id(block.moe.shared)] = "mlp"
        self.pieces: dict = {}      # id(attention) -> {"q"|"k"|"v": leaf}

    def record(self, p, generator, scale) -> None:
        self.drawn.add(id(p))

    def place(self, p, generator, scale) -> None:
        tmp = torch.empty(p.shape, dtype=torch.float32, device=self.device)
        nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0, generator=generator)
        w = tmp.mul_(scale).to(p.dtype)
        del tmp
        mod, name = self.owners[id(p)]
        kind, cuts = self.parts.get(id(mod), (None, None))
        quant = self.quant.get(id(mod))
        if (quant == "experts" and name == "router") or (
                quant == "adaln" and name != "kernel"):
            quant = None
        if quant is None:
            if kind in PLAIN_PARTS and cuts is not None and name in cuts:
                w = _take(w, cuts[name])
                mod.__dict__.setdefault("_tp_cut", set()).add(name)
            setattr(mod, name, nn.Parameter(w, requires_grad=False))
            return
        delattr(mod, name)
        if quant != "attention":
            ql = quantize_linear(w)
            if cuts is not None and name in cuts:
                cut_quantized(ql, cuts[name], cuts[name + ".scale"],
                              self.group.size)
            setattr(mod, name, ql)
            return
        # attention: o as quantize_attention makes it; q, k and v each
        # quantized alone (per-output-channel scales: a piece's columns
        # are the fused leaf's), joined once all three are drawn
        if name == "o":                          # [H, Dh, d]
            flat = quantize_linear(w.reshape(-1, w.shape[-1]))
            ql = QuantizedLinear(flat.q.reshape(w.shape), flat.scale)
        else:                                    # [d, heads, Dh]
            flat = quantize_linear(w.reshape(w.shape[0], -1))
            ql = QuantizedLinear(flat.q.reshape(w.shape),
                                 flat.scale.reshape(w.shape[1:]))
        if cuts is not None:                     # scale [d] or [heads, Dh]
            scale_cut = {} if name == "o" else {0: cuts[name][1]}
            cut_quantized(ql, cuts[name], scale_cut, self.group.size)
        if name == "o":
            mod.o = ql
            return
        got = self.pieces.setdefault(id(mod), {})
        got[name] = ql
        if len(got) == 3:
            self._join_qkv(mod, [got.pop(n) for n in ("q", "k", "v")], cuts)
            del self.pieces[id(mod)]

    def _join_qkv(self, attn, parts: list, cuts) -> None:
        qkv = QuantizedLinear(torch.cat([g.q for g in parts], dim=1),
                              torch.cat([g.scale for g in parts], dim=0))
        if cuts is not None:
            d, H, Dh = parts[0].tp_shape
            qkv.tp_shape = (d, H + 2 * parts[1].tp_shape[1], Dh)
            qkv.tp_index = (None, cuts["qkv"][1], None)
            qkv.tp_scale_shape = qkv.tp_shape[1:]
            qkv.tp_scale_index = (cuts["qkv"][1], None)
            qkv.tp_size = self.group.size
            attn.n_kv_heads = len(cuts["k"][1])
        attn.qkv = qkv


def draw_sharded(model, group: TPGroup, generator: torch.Generator,
                 device, plan=None):
    """Fill ``model`` (an LM or a DiT on the meta device) with the weights
    its ``init`` draws from ``generator`` (on ``device``), holding only
    ``group.rank``'s shards: every leaf is drawn whole in turn, in
    ``init``'s order from the same generator, then quantized (where
    ``plan``, default the full plan, covers its layer) and cut before the
    next one is drawn, so the bits are the whole draw's slices and the
    rank holds its shards plus one leaf's temporaries at most.  The
    leaves ``init`` fills without drawing (norms, biases, Mamba-2's
    ``a_log``) are allocated first and cut at the end by
    :func:`shard_model`.  Returns the model."""
    from repro_torch.models import layers
    if any(not t.is_meta for t in model.parameters()):
        raise ValueError("draw_sharded: the model must be on the meta "
                         "device")
    plan = FULL_INT8 if plan is None else plan
    drawer = _Drawer(model, group, plan, device)
    with layers.leaf_sink(drawer.record):       # which leaves are drawn
        model.draw_(generator)
    for mod in model.modules():
        for name, p in list(mod._parameters.items()):
            if p is not None and id(p) not in drawer.drawn:
                setattr(mod, name, nn.Parameter(
                    torch.empty(p.shape, dtype=p.dtype, device=device),
                    requires_grad=False))
    with layers.leaf_sink(drawer.place):
        model.draw_(generator)
    if drawer.pieces:
        raise RuntimeError("draw_sharded: an attention layer's q, k and v "
                           "were not all drawn")
    model.quantize(plan)
    return shard_model(model, group)


def build_in_turns(group: TPGroup, build: Callable):
    """Run ``build()`` on one rank at a time, with a barrier between
    turns, and return its result: ranks that share one card then never
    draw at once (each rank's draw holds one leaf's f32 temporary beside
    its shards).  ``build`` should leave only its result on the
    device."""
    out = None
    for turn in range(group.size):
        if group.rank == turn:
            out = build()
        group.barrier()
    return out
