"""The CIM execution contract, stated declaratively (port of
``repro/analysis/manifest.py``).

This module is the one place where "a full-plan dense decode block is 6
launches" lives.  The contract is stated per *logical site class*, not
per kernel; on the port each class maps to launch counters of
:data:`repro_torch.kernels.KERNELS` (:data:`KERNEL_SITES`):

=============  =====================================================
site class     launch counters
=============  =====================================================
quantize       ``quantize_rows_int8`` (standalone row-absmax int8)
fused_gemm     ``cim_gemm_int8_fused_qin`` / ``cim_gemm_int8_fused``
               / ``cim_gated_gemm_int8`` (dequant, bias, activation and
               residual in the epilogue)
acc_gemm       ``cim_gemm_int8`` — the int32 partial GEMM; only legal
               on a tensor-parallel rank, feeding the exact int32
               ``all_reduce`` across ranks
grouped_moe    ``cim_grouped_gemm_int8`` / ``cim_grouped_gated_gemm_int8``
decode_attn    ``decode_attention`` / ``decode_attention_paged`` /
               ``decode_attention_partial``
attn_combine   ``decode_attention_combine`` (the split walk's merge)
=============  =====================================================

Expected counts are derived from the config dims with the thresholds
the wrappers branch on (``MAX_FUSED_QUANT_K/N``): at reduced dims a
dense decode block is 6 launches, full-width gemma-2b (d_ff 16384 >
``MAX_FUSED_QUANT_N``) takes a 7th, a standalone hidden requant.

Two views of the same rule:

* :func:`block_sites`, :func:`model_sites`, :func:`dit_sites` — the
  reference's functions, by site class.  The reference scans stacked
  layer groups, so :func:`model_sites` counts each group's block once
  ("depth-free"); the live attribution (``obs/attribution.py``) books
  these, as the reference's does.
* :func:`layer_launches`, :func:`step_launches`,
  :func:`dit_step_launches` — what the port launches, by launch
  counter (``passes.classify`` gives the site classes): every layer is its own launch, so a step is the sum over
  layers (each group's block times its count), and each layer's decode
  walk follows the code: a sliding-window layer walks its window-sized
  ring, and the paged walk does not split at the reference's 2048-slot
  threshold (ROADMAP C.15: the reference's :func:`block_sites` adds the
  combine to every layer above 2048 slots).  The auditor and
  ``chip_smoke.py`` hold the launch counters against these.

Kernels no site class covers (:data:`UNCONTRACTED`): kernel 12 (flash
attention: a DiT block's attention on the card; the reference runs it
at the XLA level), kernels 13 and 14 (no full-plan model path), and the
degraded mode's screen.
"""
from __future__ import annotations

from collections import Counter

import torch

from repro_torch.kernels.cim_gemm import MAX_FUSED_QUANT_K, MAX_FUSED_QUANT_N
from repro_torch.kernels.decode_attention import walk_plan
from repro_torch.kernels.ops import SPLIT_MIN_SLOTS, n_splits_for

# decode_attention splits the KV range above this many cache slots
# (kernels/ops.py): the combine then joins the partial softmaxes.
SPLITKV_THRESHOLD = SPLIT_MIN_SLOTS

SITE_CLASSES = ("quantize", "fused_gemm", "acc_gemm", "grouped_moe",
                "decode_attn", "attn_combine")

# launch counter (a key of repro_torch.kernels.KERNELS) -> site class; the
# reference maps its Pallas kernel functions, which the port does not
# have (its VMEM/tiling tables, vmem_budget_bytes, WEIGHT_BLOCK_OPERANDS
# and PREFETCH_REQUIRED, are TPU tiling and have no counterpart)
KERNEL_SITES = {
    "quantize_rows_int8": "quantize",
    "cim_gemm_int8_fused_qin": "fused_gemm",
    "cim_gemm_int8_fused": "fused_gemm",
    "cim_gated_gemm_int8": "fused_gemm",
    "cim_gemm_int8": "acc_gemm",
    "cim_grouped_gemm_int8": "grouped_moe",
    "cim_grouped_gated_gemm_int8": "grouped_moe",
    "decode_attention": "decode_attn",
    "decode_attention_paged": "decode_attn",
    "decode_attention_partial": "decode_attn",
    "decode_attention_combine": "attn_combine",
}
UNCONTRACTED = frozenset({"flash_attention", "ssd_scan", "online_softmax",
                          "finite_screen"})

# ---------------------------------------------------------------------------
# Expected collectives on a tensor-parallel rank
# ---------------------------------------------------------------------------
# Per sharded transformer block (dense and MoE alike): the two
# row-parallel GEMMs (attention out-projection, MLP down) each make one
# f32 ``all_reduce`` MAX (the global row absmax, so every rank quantizes
# against the same scale) and one int32 ``all_reduce`` SUM (the exact
# partial-accumulator sum before the single epilogue).  The keys are the
# kinds ``parallel.context.TPGroup`` counts.
BLOCK_TP_COLLECTIVES = {"max": 2, "sum": 2}
# An MoE block's experts run expert-parallel and their outputs are
# gathered once: the reference's shard_map leaves that gather to XLA's
# resharding (its out_specs stay on the expert axis), so no all-gather
# appears in its trace; the port makes it explicitly.
MOE_TP_COLLECTIVES = {"gather": 1}
ALLOWED_COLLECTIVES = frozenset({"max", "sum", "gather"})
# The exactness contract: cross-rank accumulator sums are integer.
SUM_DTYPE = torch.int32


# The reference pads K to its CIM core's k_dim (128) and d_ff to n_dim
# (256) before comparing with the thresholds.  MAX_FUSED_QUANT_K (4096)
# and MAX_FUSED_QUANT_N (8192) are multiples of both, so the padded and
# the unpadded comparison agree for every K and d_ff; the port compares
# unpadded, as its wrappers do.
def gemm_in_sites(k_dim: int) -> Counter:
    """Launches of one fused GEMM taking a float activation of inner dim
    ``k_dim`` (``kernels/ops.py cim_quantized_matmul_fused``): the
    activation quantize rides in the kernel up to ``MAX_FUSED_QUANT_K``
    columns, then becomes a standalone quantize."""
    if k_dim <= MAX_FUSED_QUANT_K:
        return Counter({"fused_gemm": 1})
    return Counter({"fused_gemm": 1, "quantize": 1})


def mlp_sites(d_ff: int, grouped: bool = False) -> Counter:
    """Launches of one fused MLP pipeline (gated or not — both are
    quantize + front GEMM + down GEMM): the mid-pipeline requant rides
    the front GEMM's epilogue until the hidden row exceeds
    ``MAX_FUSED_QUANT_N``, then becomes a standalone quantize."""
    gemm = "grouped_moe" if grouped else "fused_gemm"
    n_q = 1 if d_ff <= MAX_FUSED_QUANT_N else 2
    return Counter({"quantize": n_q, gemm: 2})


def _moe_dims(cfg):
    mo = cfg.moe
    return mo.d_expert, (mo.shared_width if mo.n_shared_experts else None)


def _check_spec(spec) -> None:
    mixer, ffn = spec
    if mixer not in ("attn", "attn_local"):
        raise ValueError(f"no full-plan contract for mixer {mixer!r}")
    if ffn not in ("dense", "moe", "none"):
        raise ValueError(f"no full-plan contract for ffn {ffn!r}")


def block_sites(cfg, spec, phase: str, sharded: bool = False,
                kv_len: int = 0) -> Counter:
    """Expected site-class counts for ONE transformer block (the
    reference's function).

    ``spec`` is the ``(mixer, ffn)`` pair of a layer group; ``phase`` is
    ``"prefill"`` / ``"decode"`` / ``"step"`` (DiT).  ``sharded`` asks
    for a tensor-parallel rank's counts; ``kv_len`` is the attended
    cache length (decides split-KV, for every layer alike: see
    :func:`layer_launches` for what the port launches).
    """
    _check_spec(spec)
    _mixer, ffn = spec
    q_dim = cfg.n_heads * cfg.head_dim
    sites: Counter = Counter()
    # attention: QKV projection + decode kernel + out projection
    sites += gemm_in_sites(cfg.d_model)
    if sharded:
        sites["acc_gemm"] += 1                       # row-parallel out
    else:
        sites += gemm_in_sites(q_dim)
    if phase == "decode":
        sites["decode_attn"] += 1
        if kv_len > SPLITKV_THRESHOLD:
            sites["attn_combine"] += 1
    # feed-forward
    if ffn == "dense":
        if sharded:
            # column front (quantize + gated/fused GEMM) + row down (the
            # global row-quant outside any kernel, the int32 acc kernel)
            sites.update(quantize=1, fused_gemm=1, acc_gemm=1)
        else:
            sites += mlp_sites(cfg.d_ff)
    elif ffn == "moe":
        d_expert, shared_ff = _moe_dims(cfg)
        # expert-parallel sharding keeps each expert's dims intact, so
        # the routed pipeline is the unsharded grouped profile either way
        sites += mlp_sites(d_expert, grouped=True)
        if shared_ff is not None:
            if sharded:
                sites.update(quantize=1, fused_gemm=1, acc_gemm=1)
            else:
                sites += mlp_sites(shared_ff)
    return sites


def _groups(model_or_cfg):
    cfg = getattr(model_or_cfg, "cfg", model_or_cfg)
    return cfg, cfg.layer_groups()


def model_sites(model, phase: str, sharded: bool = False,
                kv_len: int = 0) -> Counter:
    """The reference's per-step counts: each layer group contributes its
    block's profile once, whatever its depth (the reference scans a
    group's stacked layers over one traced block body).  ``model`` is a
    port model or its config."""
    cfg, groups = _groups(model)
    total: Counter = Counter()
    for spec, _count in groups:
        total += block_sites(cfg, spec, phase, sharded=sharded,
                             kv_len=kv_len)
    return total


def dit_sites(cfg, sharded: bool = False) -> Counter:
    """Expected per-evaluation counts for a DiT block: adaLN modulation
    GEMM (bias in the epilogue) + QKV + out-projection + MLP pipeline."""
    if sharded:
        raise ValueError("DiT TP audit not in the contract matrix yet")
    q_dim = cfg.n_heads * cfg.head_dim
    sites = gemm_in_sites(cfg.d_model)               # adaLN (cond vector)
    sites += gemm_in_sites(cfg.d_model)              # QKV
    sites += gemm_in_sites(q_dim)                    # out-proj
    sites += mlp_sites(cfg.d_ff)
    return sites


def supports_full_plan(model) -> bool:
    """True when every layer group has a contract entry (attention mixer
    + dense/moe/none ffn): the archs the audit covers.  MLA, Mamba-2 and
    xLSTM mixers have none (ROADMAP A.3).  ``model`` is a port model or
    its config."""
    _cfg, groups = _groups(model)
    for (mixer, ffn), _count in groups:
        if mixer not in ("attn", "attn_local"):
            return False
        if ffn not in ("dense", "moe", "none"):
            return False
    return True


def mlp_pipeline_dispatches(d_ff: int, grouped: bool = False) -> int:
    """Total launches of one standalone fused MLP pipeline."""
    return sum(mlp_sites(d_ff, grouped=grouped).values())


# ---------------------------------------------------------------------------
# What the port launches, by launch counter
# ---------------------------------------------------------------------------
def _projection(k_dim: int) -> Counter:
    if k_dim <= MAX_FUSED_QUANT_K:
        return Counter({"cim_gemm_int8_fused_qin": 1})
    return Counter({"quantize_rows_int8": 1, "cim_gemm_int8_fused": 1})


def _mlp(d_ff: int, gated: bool, grouped: bool = False) -> Counter:
    if grouped:
        front = ("cim_grouped_gated_gemm_int8" if gated
                 else "cim_grouped_gemm_int8")
        down = "cim_grouped_gemm_int8"
    else:
        front = "cim_gated_gemm_int8" if gated else "cim_gemm_int8_fused"
        down = "cim_gemm_int8_fused"
    out = Counter({front: 1})
    out[down] += 1
    out["quantize_rows_int8"] = 1 if d_ff <= MAX_FUSED_QUANT_N else 2
    return out


def _sharded_mlp(gated: bool) -> Counter:
    """A rank's MLP: the column front (row quantize, gated or fused GEMM
    writing f32), the hidden requant on the global row scale outside
    any kernel, the row-parallel down as an int32 partial."""
    front = "cim_gated_gemm_int8" if gated else "cim_gemm_int8_fused"
    return Counter({"quantize_rows_int8": 1, front: 1, "cim_gemm_int8": 1})


def _decode_walk(cfg, mixer: str, kv_len: int, paged: bool, tp: int,
                 block_size: int) -> Counter:
    """One layer's decode attention: the single walk, or the split walk
    and the combine.  A ring walk splits by its layer's cache (a
    sliding-window layer holds ``min(kv_len, window)`` slots); a paged
    walk splits only when its table row outgrows a block
    (``walk_plan(...).splits``, above about 189 thousand int8 slots at D
    256, G 8)."""
    if paged:
        heads = cfg.n_heads // tp
        group = heads // max(1, cfg.n_kv_heads // tp)
        split = walk_plan(kv_len, cfg.head_dim, group, torch.int8, "paged",
                          bs=block_size).splits > 1
        if not split:
            return Counter({"decode_attention_paged": 1})
    else:
        span = kv_len
        if mixer == "attn_local" and cfg.sliding_window:
            span = min(kv_len, cfg.sliding_window)
        if n_splits_for(span) == 1:
            return Counter({"decode_attention": 1})
    return Counter({"decode_attention_partial": 1,
                    "decode_attention_combine": 1})


def layer_launches(cfg, spec, phase: str, *, sharded: bool = False,
                   kv_len: int = 0, paged: bool = False, tp: int = 1,
                   block_size: int = 16) -> Counter:
    """Launches of ONE full-plan layer in one forward of ``phase``
    (``"prefill"``, a prefill chunk included, or ``"decode"``), by launch
    counter.  ``kv_len`` is the attended cache length (the ring's
    ``max_len``, the paged table's capacity), ``paged`` the paged walk
    over ``block_size``-slot blocks; ``sharded`` a tensor-parallel rank of
    a group of ``tp``.  A prefill attends with the plain dense path (no
    launch).  Its classification is :func:`block_sites`' up to the
    split-KV rule (C.15)."""
    _check_spec(spec)
    if phase not in ("prefill", "decode"):
        raise ValueError(f"unknown LM phase {phase!r}")
    mixer, ffn = spec
    out = _projection(cfg.d_model)                   # QKV
    if sharded:
        out["cim_gemm_int8"] += 1                    # row-parallel out
    else:
        out += _projection(cfg.n_heads * cfg.head_dim)
    if phase == "decode":
        out += _decode_walk(cfg, mixer, kv_len, paged, tp if sharded else 1,
                            block_size)
    if ffn == "dense":
        out += _sharded_mlp(cfg.gated) if sharded else _mlp(cfg.d_ff,
                                                             cfg.gated)
    elif ffn == "moe":
        d_expert, shared_ff = _moe_dims(cfg)
        out += _mlp(d_expert, cfg.gated, grouped=True)
        if shared_ff is not None:
            out += (_sharded_mlp(cfg.gated) if sharded
                    else _mlp(shared_ff, cfg.gated))
    return out


def step_launches(model, phase: str, **kw) -> Counter:
    """A whole step's launches by counter: each group's
    :func:`layer_launches` times its depth.  ``model`` is a port model or
    its config; ``kw`` as :func:`layer_launches`."""
    cfg, groups = _groups(model)
    total: Counter = Counter()
    for spec, count in groups:
        for name, n in layer_launches(cfg, spec, phase, **kw).items():
            total[name] += n * count
    return total


def dit_block_launches(cfg) -> Counter:
    """One DiT block's plan launches per evaluation: adaLN (bias in the
    epilogue), QKV, out-projection and the ungated gelu MLP.  On the card
    the block also launches kernel 12 once (uncontracted)."""
    out = _projection(cfg.d_model)                   # adaLN (cond vector)
    out += _projection(cfg.d_model)                  # QKV
    out += _projection(cfg.n_heads * cfg.head_dim)   # out-proj
    out += _mlp(cfg.d_ff, gated=False)
    return out


def dit_step_launches(cfg) -> Counter:
    """One DiT evaluation's plan launches: every block's."""
    return Counter({k: v * cfg.n_layers
                    for k, v in dit_block_launches(cfg).items()})


def step_collectives(model) -> Counter:
    """A tensor-parallel rank's collectives in one forward (prefill or
    decode alike) of a full-plan model, by ``TPGroup`` kind: each layer's
    :data:`BLOCK_TP_COLLECTIVES` (an MoE layer's
    :data:`MOE_TP_COLLECTIVES` too)."""
    _cfg, groups = _groups(model)
    total: Counter = Counter()
    for (_mixer, ffn), count in groups:
        for kind, n in BLOCK_TP_COLLECTIVES.items():
            total[kind] += n * count
        if ffn == "moe":
            for kind, n in MOE_TP_COLLECTIVES.items():
                total[kind] += n * count
    return total
