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
# A bf16 mixer (MLA, Mamba-2, mLSTM, sLSTM) runs its rank's heads and
# gathers their outputs once before its whole out-projection.
MIXER_TP_COLLECTIVES = {"gather": 1}
# Under degraded mode, per site: a column shard's screen flag is
# max-reduced (QKV, a rank's experts); a row-parallel site's fallback
# (the out-projection, an MLP's down) runs its sanitized global row scale
# and int32 sum whatever the flag says.
DEGRADED_TP_COLLECTIVES = {"qkv": {"max": 1}, "out": {"max": 1, "sum": 1},
                           "mlp": {"max": 1, "sum": 1},
                           "experts": {"max": 1}}
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


def seq_cut(cfg, mixer: str, tp: int, kv_len: int,
            paged: bool = False) -> bool:
    """Whether a tensor-parallel rank of ``tp`` holds only its slots of
    a ``mixer`` layer's ring or latent cache of ``kv_len`` slots
    (``parallel.sharding.seq_cut_slots``, the rule ``Model.init_cache``
    allocates by).  The paged pools carry no ``kv_seq`` axis."""
    from repro_torch.parallel.sharding import seq_cut_slots
    return not paged and kv_len > 0 and seq_cut_slots(
        cfg, mixer, tp, kv_len) is not None


def block_sites(cfg, spec, phase: str, sharded: bool = False,
                kv_len: int = 0, tp: int = 2) -> Counter:
    """Expected site-class counts for ONE transformer block (the
    reference's function, but for the ring cut by sequence).

    ``spec`` is the ``(mixer, ffn)`` pair of a layer group; ``phase`` is
    ``"prefill"`` / ``"decode"`` / ``"step"`` (DiT).  ``sharded`` asks
    for a tensor-parallel rank's counts (of a group of ``tp``);
    ``kv_len`` is the attended cache length (decides split-KV, for
    every layer alike: see :func:`layer_launches` for what the port
    launches).  A rank whose ring is cut by sequence (:func:`seq_cut`)
    walks its slots in splits and merges the ranks' partials whatever
    the length: one ``decode_attn`` and one ``attn_combine``, where the
    reference's function counts the one walk below 2048 slots (ROADMAP
    C: its tensor parallelism attends the whole ring).
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
        if kv_len > SPLITKV_THRESHOLD or (
                sharded and seq_cut(cfg, _mixer, tp, kv_len)):
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
                kv_len: int = 0, tp: int = 2) -> Counter:
    """The reference's per-step counts: each layer group contributes its
    block's profile once, whatever its depth (the reference scans a
    group's stacked layers over one traced block body), with
    :func:`block_sites`' combine on a ring cut by sequence.  ``model``
    is a port model or its config."""
    cfg, groups = _groups(model)
    total: Counter = Counter()
    for spec, _count in groups:
        total += block_sites(cfg, spec, phase, sharded=sharded,
                             kv_len=kv_len, tp=tp)
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
    xLSTM mixers have none, as in the reference's manifest.  ``model`` is
    a port model or its config."""
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
    sliding-window layer holds ``min(kv_len, window)`` slots), and on a
    rank of a ring cut by sequence always (kernel 9 over the rank's
    slots, kernel 10 over every rank's partials); a paged walk splits
    only when its table row outgrows a block (``walk_plan(...).splits``,
    above about 189 thousand int8 slots at D 256, G 8)."""
    if seq_cut(cfg, mixer, tp, kv_len, paged):
        return Counter({"decode_attention_partial": 1,
                        "decode_attention_combine": 1})
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


BF16_MIXERS = ("mla", "mamba2", "mlstm", "slstm")


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
    split-KV rule (C.15).  The bf16 mixers, which no plan kind covers
    (MLA, Mamba-2, mLSTM, sLSTM), launch nothing of the plan, sharded or
    not; a Mamba-2 layer's prefill launches kernel 13 once (the decode
    recurrence is plain torch); their FFN is counted as an attention
    block's."""
    mixer, ffn = spec
    if mixer not in ("attn", "attn_local") + BF16_MIXERS or ffn not in (
            "dense", "moe", "none"):
        raise ValueError(f"no launch rule for layer {spec}")
    if phase not in ("prefill", "decode"):
        raise ValueError(f"unknown LM phase {phase!r}")
    out: Counter = Counter()
    if mixer == "mamba2" and phase == "prefill":
        out["ssd_scan"] += 1
    if mixer in ("attn", "attn_local"):
        out += _projection(cfg.d_model)              # QKV
        if sharded:
            out["cim_gemm_int8"] += 1                # row-parallel out
        else:
            out += _projection(cfg.n_heads * cfg.head_dim)
        if phase == "decode":
            out += _decode_walk(cfg, mixer, kv_len, paged,
                                tp if sharded else 1, block_size)
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
    :func:`layer_launches` times its depth, for a model under the
    full-plan contract (:func:`supports_full_plan`; else raises).
    ``model`` is a port model or its config; ``kw`` as
    :func:`layer_launches`."""
    cfg, groups = _groups(model)
    total: Counter = Counter()
    for spec, count in groups:
        _check_spec(spec)
        for name, n in layer_launches(cfg, spec, phase, **kw).items():
            total[name] += n * count
    return total


def dit_block_launches(cfg, sharded: bool = False) -> Counter:
    """One DiT block's plan launches per evaluation: adaLN (bias in the
    epilogue), QKV, out-projection and the ungated gelu MLP; ``sharded``
    a tensor-parallel rank's (adaLN whole, the out-projection's int32
    partial, the column-parallel MLP).  On the card the block also
    launches kernel 12 once (uncontracted)."""
    out = _projection(cfg.d_model)                   # adaLN (cond vector)
    out += _projection(cfg.d_model)                  # QKV
    if sharded:
        out["cim_gemm_int8"] += 1                    # row-parallel out
        return out + _sharded_mlp(gated=False)
    out += _projection(cfg.n_heads * cfg.head_dim)   # out-proj
    out += _mlp(cfg.d_ff, gated=False)
    return out


def dit_step_launches(cfg, sharded: bool = False) -> Counter:
    """One DiT evaluation's plan launches: every block's."""
    return Counter({k: v * cfg.n_layers for k, v in
                    dit_block_launches(cfg, sharded).items()})


def seq_gathers(cfg, mixer: str, phase: str, tp: int) -> int:
    """The all-gathers a rank of ``tp`` makes for ONE layer whose ring or
    latent cache it holds cut by sequence (:func:`seq_cut`), in one
    forward of ``phase``: a prefill gathers the rows' slots whole (1); a
    decode step gathers the heads' queries where the rank holds only its
    own (1; an attention layer's MQA head, MLA's heads), then the
    partials (attention: kernel 9's; MLA: the softmax states and the
    latent sums, 2)."""
    if phase == "prefill":
        return 1
    if mixer == "mla":
        return 2 + (cfg.n_heads % tp == 0)
    return 1 + (cfg.n_heads % tp == 0 and cfg.n_kv_heads == 1)


def layer_collectives(cfg, spec, degraded: bool = False, *,
                      phase: str = "decode", tp: int = 2,
                      kv_len: int | None = None,
                      paged: bool = False) -> Counter:
    """A tensor-parallel rank's collectives in one forward of ``phase`` of
    ONE layer whose parts all shard, by ``TPGroup`` kind: an attention
    mixer's out-projection and an MLP's down each 1 MAX + 1 SUM
    (:data:`BLOCK_TP_COLLECTIVES` for the two), a bf16 mixer's
    :data:`MIXER_TP_COLLECTIVES`, the routed experts'
    :data:`MOE_TP_COLLECTIVES` (and the shared MLP's pair); with
    ``degraded`` each site's :data:`DEGRADED_TP_COLLECTIVES` too; with
    ``kv_len`` (the ring's or the latent cache's slots, or the paged
    table's with ``paged``) a ring cut by sequence's
    :func:`seq_gathers`."""
    mixer, ffn = spec
    out: Counter = Counter()
    sites = []
    if mixer in ("attn", "attn_local"):
        out.update(max=1, sum=1)
        sites += ["qkv", "out"]
    else:
        out.update(MIXER_TP_COLLECTIVES)
    if kv_len is not None and seq_cut(cfg, mixer, tp, kv_len, paged):
        out["gather"] += seq_gathers(cfg, mixer, phase, tp)
    if ffn == "dense":
        out.update(max=1, sum=1)
        sites.append("mlp")
    elif ffn == "moe":
        out.update(MOE_TP_COLLECTIVES)
        sites.append("experts")
        if cfg.moe.shared_width:
            out.update(max=1, sum=1)
            sites.append("mlp")
    if degraded:
        for site in sites:
            out.update(DEGRADED_TP_COLLECTIVES[site])
    return out


def vocab_collectives(cfg, tp: int = 2) -> Counter:
    """A tensor-parallel rank's collectives for the vocabulary in one
    forward, when ``tp`` divides it (``parallel.sharding.vocab_cuts``):
    the embedding lookup's SUM (none for an audio frontend, which looks
    up no token) and the logits' gather."""
    if tp <= 1 or cfg.vocab % tp:
        return Counter()
    out = Counter(gather=1)
    if cfg.frontend != "audio":
        out["sum"] = 1
    return out


def step_collectives(model, degraded: bool = False, *,
                     phase: str = "decode", tp: int = 2,
                     kv_len: int | None = None,
                     paged: bool = False) -> Counter:
    """A tensor-parallel rank's collectives in one forward of ``phase`` of
    a model whose layers all shard, by ``TPGroup`` kind: each layer's
    :func:`layer_collectives` (a full-plan dense or MoE block:
    :data:`BLOCK_TP_COLLECTIVES`, plus :data:`MOE_TP_COLLECTIVES` for
    the experts; the gathers of a ring cut by sequence with ``kv_len``)
    and the vocabulary's (:func:`vocab_collectives`)."""
    cfg, groups = _groups(model)
    total = vocab_collectives(cfg, tp)
    for spec, count in groups:
        for kind, n in layer_collectives(cfg, spec, degraded, phase=phase,
                                         tp=tp, kv_len=kv_len,
                                         paged=paged).items():
            total[kind] += n * count
    return total


def run_collectives(model, decode_steps: int, prefills: int,
                    **kw) -> Counter:
    """A run's collectives on a tensor-parallel rank: ``decode_steps``
    forwards of the decode phase and ``prefills`` of the prefill phase
    (a paged engine's chunks included), each :func:`step_collectives`
    (``kw``: its keywords)."""
    total: Counter = Counter()
    for phase, n in (("decode", decode_steps), ("prefill", prefills)):
        for kind, k in step_collectives(model, phase=phase, **kw).items():
            total[kind] += k * n
    return total


def dit_step_collectives(cfg, degraded: bool = False,
                         tp: int = 2) -> Counter:
    """A tensor-parallel rank's collectives in one DiT evaluation: per
    block the out-projection's and the MLP down's MAX + SUM (adaLN and
    QKV need none); with ``degraded`` the QKV flag's MAX and the two
    row-parallel fallbacks' MAX + SUM; the label lookup's SUM where
    ``tp`` divides the label table's rows (no registered DiT's)."""
    per = Counter(max=2, sum=2)
    if degraded:
        for site in ("qkv", "out", "mlp"):
            per.update(DEGRADED_TP_COLLECTIVES[site])
    out = Counter({k: v * cfg.n_layers for k, v in per.items()})
    if tp > 1 and (cfg.n_classes + 1) % tp == 0:
        out["sum"] += 1
    return out
