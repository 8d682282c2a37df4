#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU with the CUDA toolkit; imports nothing of JAX or of
the JAX package.  Phases, each printing its lines:

1. build  — compile every ``src/repro_torch/csrc/*.cu`` for sm_90a.
2. card   — the card's name and power limit (nvidia-smi).
3. check  — each kernel against its plain version on the card, at
            gemma-2b's decode shape (M = 8) and the prefill shapes of the
            serve runs (M = 64, 256, and 5056: serve-long's largest).
            The paged walk is also held bitwise against the ring walk on
            the same logical cache, and the split walk at NS = 1 bitwise
            against the single walk.  The grouped GEMMs at qwen2-moe's
            decode (E = 60, T = 8) and prefill (T = 48) shapes with a
            skip list holding zeros; the requant epilogue of kernels 3,
            4 and 8 bitwise; the ring and paged walks at KH 16, G 1,
            D 128; kernel 6 (int8 -> int32) exactly at the TP partials'
            shapes (M = 8, 64, 256, 5056) and ragged ones; each head of
            the flash-decode walks bitwise at G = 4 (a TP-2 rank's heads
            of gemma-2b's one KV head) and at G = 8; the plan's GEMMs at
            DiT-XL/2's block shapes (kernel 2 on the f32 adaLN input with
            a bias, on the bf16 QKV and out-projection inputs; kernel 1 on
            the MLP input; kernel 3 with gelu and its requant, and to
            f32); kernel 12's prefix mode (``prefix_len``) on both bodies
            at paligemma-3b's cacheless forward (S 4096, p 256) and at a
            ragged S with p inside a tile (not counted).  The degraded
            mode's kernels: the finite screen's flag against its plain
            version at 16384 to 8388608 values (finite, NaN, +-inf), and
            the gated fallback of kernels 1, 2, 3, 4, 7 and 8 at
            gemma-2b's decode shape (M 8) and qwen2-moe's (E 60, T 8), NaN
            and +-inf planted in every float operand: with the flag at 0
            a sentinel-filled output untouched bitwise, at 1 the plain
            version on the sanitized operands (integers exact, floats
            bitwise or within ``GELU_RTOL`` after an activation).
   ops    — kernels 12-14 through ``repro_torch.kernels.ops`` at the
            widths of models in the registry: flash
            attention at gemma-2b's prefill (S 2048, 8 heads on 1 KV head,
            D 256, bf16, causal), gemma3-4b's sliding layers (S 4096, KH 4,
            window 1024), qwen2-moe's (16 heads of 128), an f32 case
            with Sq != Skv and DiT-XL/2's full attention (B 8, S 1024, 16
            heads of 72: the tensor-core body at D 72); the SSD scan at one zamba2-1.2b Mamba-2 layer
            (64 heads, S 2048, P 64, N 64, chunk 128), then (not
            counted) from a nonzero initial state there and at
            serve-zamba2's 1984-token prefill in the model's layout;
            softmax over
            DiT-XL/2's attention scores [16 x 1024, 1024] (a warp a row),
            gemma-2b's logits [8, 256000] in f32 and bf16 (a cluster a
            row) and the extreme rows [1e4, -1e4, 0, 1e4], each case's
            regime from ``softmax_plan`` printed.  The counters must
            read exactly 5 / 1 / 4 (the softmax its plans' launches: one
            a case); each
            output is held against its plain version, and each bf16 flash
            case with Sq == Skv against the model's prefill attention
            (``dense_attention``).
4. serve  — full-width gemma-2b (random weights from a seed, built and
            quantized once, shared by the three runs) served by
            ``ServingEngine(quant_plan=QuantPlan.full())``: 8 greedy
            requests; every request must end OK and the kernels' launch
            counters must match the plan (7 launches per layer per decode
            step).  The serve phases take their launch pins from the
            port's manifest (``repro_torch.analysis.manifest``) wherever
            it states a contract.
   serve-paged — ``PagedServingEngine`` over a pool too small for the
            first 8 of its 16 requests, so it must preempt: every request
            OK, the pool drains, counters exact (7 per layer per decode
            step, 6 per layer per prefill chunk).
   obs    — the serve and serve-paged requests again, each engine with
            ``obs=Observability()`` on a step clock: tokens bitwise the
            runs without obs, every span closed once, ``dispatches_total``
            times the 18 layers equal to the launch counters by site
            class; the hooks' host time per step and the decode step
            with and without obs; ``audit_lm`` on one full-width decode
            step, ring and paged (launches by counter and site class,
            the dtype flow outside the kernel wrappers).
   serve-long — the ring engine at 8192 slots, where decode attention
            takes the split walk: 8 launches per layer per decode step.
   reference — one full-width ring prefill + decode step and one paged
            two-chunk prefill + decode step held against the plain path,
            and the reduced config's logits too.
   profile — one decode step's wall time beside the device time the
            profiler attributes to kernels, and the largest kernels.
   forward-long — one cacheless ``Model.forward`` of 4096 tokens on the
            same full-plan gemma-2b: attention above 2048 tokens runs on
            kernel 12, exactly 18 launches (one a layer) beside the
            plan's GEMMs; logits within 5% of the largest |logit| of the
            same forward given explicit positions (the plain blockwise
            path), argmax equal up to near ties; the dense path's logits
            beside both (how far the reference's own roundings land
            apart); ms per forward and kernel 12's share of the device
            time.
   chaos  — the reliability layer on the same gemma-2b
            (``phase_chaos``): degraded mode on the healthy model (the
            serve phase's tokens bitwise, ``DEGRADED_PER_LAYER`` 16
            launches per layer per decode step, no host sync under CUDA's
            sync debug mode, a profiled step with and without it); an inf
            in one layer's out-projection scale (FAILED without degraded
            mode, OK with it, screens tripped); ``chaos_soak`` at BERs
            1e-6, 1e-4, 1e-2 through the ring engine and 1e-4 through the
            paged engine (every request terminal, every invariant held,
            seconds per campaign printed); the int8 weights bitwise
            restored.
   serve-tp — gemma-2b is freed; two tensor-parallel ranks (processes
            joined by gloo, both on the one card) draw full-width
            gemma-2b in turn, keep their shards and serve the serve
            phase's 8 requests: every request OK, the ranks agree, the
            tokens bitwise the serve run's, per rank 6 launches per layer
            per decode step and 5 per prefill, 2 MAX + 2 SUM reductions
            per layer per forward; ms per decode step, the collectives'
            host time, memory per rank.
   serve-tp-paged — the same ranks through the paged engine over the
            serve-paged pool: preempts, drains, tokens bitwise.
   reference-tp — one prefill + decode step at TP-2: logits bitwise the
            unsharded kernel path's.
   serve-moe — gemma-2b is freed; full-width qwen2-moe-a2.7b (random
            weights from the seed, 24 layers, 60 experts top-4 + the
            shared MLP, built in bf16 and quantized once) served by the
            ring engine: 8 greedy requests, every request OK, counters
            exact (9 launches per layer per decode step, 8 per prefill);
            ms per decode step, memory and its peak, active experts.
   serve-moe-paged — the same model through the paged engine over a
            pool that must preempt: every request OK, the pool drains,
            counters exact.
   reference-moe, profile-moe — as reference and profile, on qwen2-moe.
   serve-moe-tp — qwen2-moe is freed; two ranks draw it one after the
            other (a barrier between, so the card holds one bf16 copy and
            the first rank's shards, about 37 GiB), keep their shards (30
            experts, 8 KV heads, half the shared MLP each) and serve
            serve-moe's requests: tokens bitwise, 9 launches per layer per
            decode step, 2 MAX + 2 SUM + 1 gather per layer per forward.
   serve-dit — full-width DiT-XL/2 (random weights from the seed, 28
            blocks, d 1152, 16 heads of 72, 1024 tokens, the full plan)
            served by ``DiffusionEngine``: 8 DDIM and 4 Euler requests at
            batch 4, 8 steps at guidance 4.0 (the null-label rows stacked:
            8 rows an evaluation); every request OK with finite latents,
            exactly 7 launches per block per evaluation (the 6 plan
            launches and 1 of kernel 12), the engine's latents bitwise a
            direct ``sample()`` and a replay of the first batch with
            ``obs=`` (its evaluation and image counters the batch's), one
            evaluation within 5% of the largest
            |eps| of the plain path; ms per evaluation, images/s, the
            profiled device share; the first batch again under degraded
            mode with a fault hook that plants a NaN in one request's
            latents: that request FAILED, the others bitwise, 18
            launches per block per evaluation.
   serve-zamba2 — full-width zamba2-1.2b (random weights from the seed,
            38 layers: 32 Mamba-2, 6 attention + dense-geglu, 1.35 B
            parameters, the full plan, int8 KV) on the ring engine: 8
            slots of 2048, bucket 64, 8 requests of 16-1984 tokens, 32
            new each; every request OK, exactly 6 launches per attention
            layer per decode step, none per Mamba-2 layer, kernel 13 once
            per Mamba-2 layer per prefill; the 1984-token request's logits
            bitwise a direct prefill + decode loop's at the engine's 8
            rows, and at batch 1 its prefill bitwise and its greedy tokens
            equal but at near ties; that prefill's logits within 5% of the
            plain path's; ms per decode
            step, tok/s, the 1984-token prefill's wall time and its
            profiled device time by kernel (kernel 13's share).
   serve-gemma3 — full-width gemma3-4b (3.88 B parameters: 29 sliding
            layers of 1024 and 5 global, qk_norm; drawn and quantized
            block by block, the full plan, int8 KV): the ring engine at 8
            slots of 4096 (local layers hold 1024 slots; the global
            layers' walk splits in 2: 7 launches per local layer and 8
            per global layer per decode step) and the paged engine (7,
            drains) on 8 requests of 16-3000 tokens, 32 new; a 1500-token
            prefill + 4 decode steps against the plain path; a cacheless
            forward of 4096 tokens: kernel 12 exactly 29 times sliding and
            5 causal, logits within 5% of the blockwise path.
   serve-paligemma — full-width paligemma-3b on the ring engine with text
            prompts (prefix_len 256; 7 per layer per decode step); 256
            seeded patch embeddings + 64 tokens prefilled into a ring,
            then 16 decode steps, against the plain path; a cacheless
            forward of 256 patches + 3840 tokens: kernel 12's prefix mode
            exactly 18 times, against the plain path.
   musicgen — full-width musicgen-medium: a ring prefill of 512 seeded
            frame embeddings (2 rows), 16 decode steps fed seeded frames,
            6 launches per layer per decode step, against the plain path.
   serve-deepseek, serve-command — deepseek-67b and command-r-plus-104b
            at full width cut to 4 layers on the ring engine: QKV and
            out-projection above K 4096 as kernel 1 + kernel 3, 9
            launches per layer per decode step; one prefill + decode step
            against the plain path.
   serve-deepseek-v3 — deepseek-v3-671b at full width (MLA: 128 heads,
            q_lora 1536, kv_lora 512, nope 128, rope 64, v 128; 256
            experts top-8 of 2048 and a shared one; the untied head of
            129280) cut to 4 layers (its 3 dense of d_ff 18432, 1 MoE),
            drawn and quantized block by block (expert stacks over
            chunks of experts; the draw's peak printed): the ring engine
            at 8 slots of 1024 on 8 requests, exactly 4 launches per
            dense layer and 6 per MoE layer per decode step (MLA itself
            none: bf16 torch products, as the reference's einsum); one
            prefill + decode step against the plain path; a cacheless
            forward of 4096 tokens: kernel 12 exactly 4 times (causal, D
            192, v padded to 192), logits within 5% of the blockwise
            path on the tokens both paths route alike (most of them).
   serve-xlstm — xlstm-350m at full width, nothing cut (21 mLSTM, 3
            sLSTM layers): the ring engine at 8 slots of 2048 on 8
            requests of 16-1984 tokens, exactly 0 plan launches; the
            1984-token request's logits bitwise a direct loop from a
            zeroed cache (the engine's slot reset, ROADMAP C.14) at the
            engine's 8 rows; its prefill within 5% of the plain path; ms
            per decode step.
5. times  — each kernel's median time at the serve shapes beside its
            bound, its plain version and one PyTorch call (library_ms);
            the row quantizer at four shapes (gemma-2b's hidden requant
            and MLP input at decode, qwen2-moe's stacked expert rows, a
            4096-token forward's hidden requant) under its plan and at
            half and twice its threads; the grouped GEMMs with the
            expert counts of a served decode step and with every expert
            active (kernels 7 and 8 also under every plan of their body,
            kernel 7 also at a prefill chunk of 48 rows an expert); the
            split walk then the combine at serve-long's end state, the
            combine launched plainly and as a programmatic dependent of
            the walk; kernels 3 and 4 with the
            requant epilogue at the shared MLP's shapes, and kernel 6 at
            the TP partials' shapes (beside ``torch._int_mm``); the
            tensor-core GEMM of kernels 2, 3, 4 and 6 under every plan
            it takes at decode shapes (tile shape and cluster size, one
            line a plan), and at the prefill shapes of
            ``PREFILL_GEMMS``, each against ``torch._int_mm``; the
            flash-decode walks at five shapes (gemma-2b's ring and paged
            walks and kernel 9 at the end state of serve and
            serve-long, the ring and paged walks at qwen2-moe's heads):
            kept steps, time a step, the launch plan, SDPA beside them,
            and each again at every cluster size the plan can pick;
            kernels 12-14 at the ops phase's shapes (beside SDPA and
            ``torch.softmax``; none computes the SSD scan), kernel 12's
            bf16 cases on both of its bodies, the softmax also beside a
            copy of its bytes and, where its plan takes a cluster, under
            16 blocks of 512 threads a row; the plan's launches of a
            DiT-XL/2 block (``DIT_GEMMS`` and the row quantizer) beside
            their bounds and ``torch._int_mm``; kernel 12's prefix mode at
            paligemma-3b's forward beside SDPA with the same boolean
            mask; kernels 8 and 7 at deepseek-v3's decode shape (E 256,
            8 rows an expert) with a served step's expert counts and
            with all 256 active; kernel 12 at MLA's forward (B 1, S
            4096, 128 heads, D 192, v padded) held against its plain
            version and beside SDPA (E 192, Ev 128), its bound from the
            unpadded work; the degraded mode's gated launches with the
            flag at 0 beside their kernels' ungated launches, and the
            screen.  Collectives are never captured in a graph.

The LM serve runs (with the family's serve runs and the obs phase's
two) must launch kernels
12-14 and the screen zero times and every other kernel at least once
(the kernels' JSON record takes the screen's launches from the chaos
phase's degraded serve); the kernels' JSON
record adds serve-dit's and serve-zamba2's launches to theirs, and takes
kernel 12's launches from forward-long, serve-dit, the family's two
cacheless forwards and serve-deepseek-v3's, kernel 13's from the ops phase and serve-zamba2, and
kernel 14's from the ops phase.  The last two
lines are the kernels' JSON record and ``{"ok": true, "device": {...}}``.
Any failure exits non-zero before that line.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
DEVICE = "cuda"
SEED = 0            # weights, prompts and test inputs are drawn from it
NEW_TOKENS = 32     # generated per request in the serve phase

# The card's published peaks (NVIDIA H100 SXM data sheet, dense): HBM
# bytes/s, int8 and bf16 tensor-core ops/s, f32 (non-tensor) ops/s.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12

# Tolerances of phase 3 (kernel against plain version on the same inputs).
GELU_RTOL = 1e-5        # tanhf/expf may differ from torch's by an ulp
# Decode attention: the plain output (f32 on int8 KV) is rounded to the
# kernel's bf16 first; then each element may differ by 2**-7 of itself
# (one bf16 ulp at a rounding boundary) plus 1e-3 of its own query row's
# largest |out| (f32 summation order, for elements near zero).
ATTN_RTOL = 2 ** -7
ATTN_ATOL_ROW = 1e-3
# Full-model logits, kernel path against plain path (same weights).
LOGITS_ATOL_REL = 5e-2  # of the largest |logit|

SOURCES = {
    "quantize_rows_int8": ("src/repro_torch/csrc/cim_gemm.cu",
                           "src/repro/kernels/cim_gemm.py:231"),
    "cim_gemm_int8_fused_qin": ("src/repro_torch/csrc/cim_gemm.cu",
                                "src/repro/kernels/cim_gemm.py:423"),
    "cim_gemm_int8_fused": ("src/repro_torch/csrc/cim_gemm.cu",
                            "src/repro/kernels/cim_gemm.py:307"),
    "cim_gated_gemm_int8": ("src/repro_torch/csrc/cim_gemm.cu",
                            "src/repro/kernels/cim_gemm.py:517"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:192"),
    "decode_attention_partial": ("src/repro_torch/csrc/decode_attention.cu",
                                 "src/repro/kernels/decode_attention.py:289"),
    "decode_attention_combine": ("src/repro_torch/csrc/decode_attention.cu",
                                 "src/repro/kernels/decode_attention.py:274"),
    "decode_attention_paged": ("src/repro_torch/csrc/decode_attention.cu",
                               "src/repro/kernels/decode_attention.py:374"),
    "cim_grouped_gemm_int8": ("src/repro_torch/csrc/cim_gemm.cu",
                              "src/repro/kernels/cim_gemm.py:683"),
    "cim_grouped_gated_gemm_int8": ("src/repro_torch/csrc/cim_gemm.cu",
                                    "src/repro/kernels/cim_gemm.py:811"),
    "cim_gemm_int8": ("src/repro_torch/csrc/cim_gemm.cu",
                      "src/repro/kernels/cim_gemm.py:189"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:80"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:71"),
    "online_softmax": ("src/repro_torch/csrc/online_softmax.cu",
                       "src/repro/kernels/online_softmax.py:58"),
    # the degraded mode's screen: the reference's is an XLA reduction and
    # lax.cond, no Pallas kernel
    "finite_screen": ("src/repro_torch/csrc/cim_gemm.cu",
                      "src/repro/quant/linear.py:129"),
}
# Launched only under degraded mode (the chaos phase).
DEGRADED_KERNELS = ("finite_screen",)
# Kernels 12-14 are reached through the ops surface, and kernel 12 also
# by the cacheless forward above 2048 tokens (forward-long) and by DiT's
# full attention (serve-dit); the ops phase drives them at the widths of
# models in the registry, the LM serve runs launch them 0 times.
OPS_KERNELS = ("flash_attention", "ssd_scan", "online_softmax")
# (case, B, Sq, Skv, H, KH, D, dtype, causal, window); the first is the
# timed row: DiT-XL/2's, the shape of most of kernel 12's served launches
FLASH_CASES = (
    ("DiT-XL/2 attention", 8, 1024, 1024, 16, 16, 72, "bf16", False, None),
    ("gemma-2b prefill", 1, 2048, 2048, 8, 1, 256, "bf16", True, None),
    ("gemma3-4b sliding layer", 1, 4096, 4096, 8, 4, 256, "bf16", True,
     1024),
    ("qwen2-moe-a2.7b prefill", 1, 2048, 2048, 16, 16, 128, "bf16", True,
     None),
    ("f32, Sq != Skv", 2, 512, 1024, 4, 2, 64, "f32", True, None),
)
# zamba2-1.2b's Mamba-2 layer: B 1 x 64 heads, S 2048, P 64, N 64
SSD_CASE = (64, 2048, 64, 64, 128)
# (case, R, C, dtype): the first is the timed row
SOFTMAX_CASES = (
    ("DiT-XL/2 attention scores", 16 * 1024, 1024, "f32"),
    ("gemma-2b logits", 8, 256000, "f32"),
    ("gemma-2b logits", 8, 256000, "bf16"),
)
# Tolerances of the ops phase (kernel against plain version): flash
# attention in f32 2e-5 (the reference's) of the element plus 2e-5 of its
# row's largest |out|; in bf16 2**-7 and 2**-7 of the row (p is rounded
# to bf16 against the running max in the kernel, against the row max in
# the plain version); against the model's dense_attention the reference's
# bf16 tolerance, 2e-2 absolute and relative (it rounds its scores to
# bf16).  The SSD scan 2e-4 of the element plus 2e-4 of the tensor's
# largest magnitude.  Softmax in f32 2e-5 of the element plus 2e-6 of
# the largest output (the reference's rtol, its atol scaled by the
# largest output, at most 1); in bf16 2**-7 (one rounding apart).
FLASH_TOL = {"f32": 2e-5, "bf16": 2 ** -7}
FLASH_DENSE_TOL = 2e-2
SSD_TOL = 2e-4
SOFTMAX_TOL = {"f32": (2e-5, 2e-6), "bf16": (2 ** -7, 0.0)}
MOE_ARCH = "qwen2-moe-a2.7b"
# qwen2-moe-a2.7b's widths, for the kernel checks and times
MOE_E, MOE_D, MOE_F, MOE_SHARED = 60, 2048, 1408, 5632
# the paged run's pool (160 allocatable blocks of 16 slots) and requests:
# the first eight need more than the pool holds, so it must preempt
PAGED_BLOCK = 16
PAGED_NUM_BLOCKS = 161
PAGED_PROMPTS = [600, 520, 450, 380, 300, 240, 180, 120, 90, 64, 48, 40, 32,
                 24, 20, 16]
# the serve runs' prompt lengths (ring, serve-moe and the TP runs)
SERVE_LENGTHS = [16, 40, 64, 65, 100, 128, 150, 200]
# the long run: a ring of 8192 slots, 4 splits
LONG_MAX_LEN = 8192
LONG_PROMPTS = [5000, 2500, 300, 40]
LONG_NEW_TOKENS = 16
# the cacheless forward above 2048 tokens: kernel 12's model path.  The
# port's logit tolerance against JAX at the smoke size
# (tests/test_torch_model.py), printed for each pair of attention paths
# and used for the near-tie rule of the argmax
LONG_FORWARD_S = 4096
LONG_LOGIT_ATOL = 0.15
# zamba2-1.2b served by the ring engine (serve-zamba2): 8 slots of 2048,
# bucket 64; 8 requests, the first of 1984 tokens (a bucket multiple:
# kernel 13 over 15 chunks of 128 and a ragged one of 64)
# The chaos phase: the chaos bench's sweep at full width, one campaign
# every CHAOS_PERIOD fetches (a campaign at 1e-2 over gemma-2b's 1.98 GB of
# int8 draws about 1.6e8 faults on the host)
CHAOS_BERS = (1e-6, 1e-4, 1e-2)
CHAOS_PAGED_BER = 1e-4
CHAOS_SEED = 42
CHAOS_PERIOD = 4
CHAOS_NAN_RATE = 0.2
# launches per layer per decode step under degraded mode
# (``degraded_launches``): the plan's 7 (9), one screen a quantized site
# (3; 4) and the fallback chains (QKV 1, out-proj 1, an MLP or the
# experts 4 each)
DEGRADED_PER_LAYER = {"gemma-2b": 16, "qwen2-moe-a2.7b": 23}
# launches of one call in the graph that times a gated fallback launch
FALLBACK_REPS = 64
ZAMBA_ARCH = "zamba2-1.2b"
ZAMBA_PREFILL = 1984
ZAMBA_PROMPTS = [ZAMBA_PREFILL, 16, 40, 100, 257, 500, 1000, 1500]
# DiT-XL/2 served by the diffusion engine (serve-dit): batches of 4
# latents (8 rows with the guidance's null-label rows stacked), 8 steps at
# guidance scale 4.0; 8 DDIM requests, then 4 Euler ones
DIT_ARCH = "dit-xl-2"
DIT_BATCH = 4
DIT_STEPS = 8
DIT_CFG_SCALE = 4.0
DIT_REQUESTS = (("ddim", 8), ("euler", 4))
# one full-width evaluation, kernel path against the plain path (the
# GEMMs' plain versions, dense attention): 1.83% of the largest |eps| on
# an H100 at seed 0, with room for codes that flip at other ties
DIT_EPS_ATOL_REL = 3e-2   # of the largest |eps|
# the plan's GEMMs of a DiT-XL/2 block at 2B = 8 rows of 1024 tokens:
# (launch, kernel, M, K, N, form)
DIT_GEMMS = (
    ("adaLN", "cim_gemm_int8_fused_qin", 8, 1152, 6912, "f32 + bias"),
    ("QKV", "cim_gemm_int8_fused_qin", 8192, 1152, 3456, "bf16"),
    ("out-proj", "cim_gemm_int8_fused_qin", 8192, 1152, 1152, "bf16"),
    ("MLP up", "cim_gemm_int8_fused", 8192, 1152, 4608, "gelu + requant"),
    ("MLP down", "cim_gemm_int8_fused", 8192, 4608, 1152, "f32 out"))
# the dense family beyond gemma-2b, full width (serve-gemma3,
# serve-paligemma, musicgen, serve-deepseek, serve-command): gemma3-4b on
# the ring at 8 slots of 4096 (its local layers hold 1024) and the paged
# engine in chunks of 512 over prompts up to 3000 tokens, some past the
# window, and a cacheless forward of 4096 tokens; paligemma-3b's text
# prompts, some inside the 256-position prefix, a direct prefill of 256
# patches + 64 tokens then 16 decode steps, and a cacheless forward of
# 256 patches + 3840 tokens; musicgen-medium on 512 frames then 16 fed
# frames; deepseek-67b and command-r-plus-104b cut to 4 layers
GEMMA3_ARCH = "gemma3-4b"
GEMMA3_MAX_LEN = 4096
GEMMA3_CHUNK = 512
GEMMA3_PROMPTS = [3000, 16, 1500, 40, 2200, 100, 1100, 600]
GEMMA3_LONG_S = 4096
PALI_ARCH = "paligemma-3b"
PALI_PROMPTS = [16, 40, 100, 128, 200, 255, 300, 600]
PALI_TEXT = 64
PALI_STEPS = 16
PALI_LONG_TEXT = 3840
MUSIC_ARCH = "musicgen-medium"
MUSIC_FRAMES = 512
MUSIC_STEPS = 16
DEEP_ARCHS = ("deepseek-67b", "command-r-plus-104b")
DEEP_LAYERS = 4
V3_ARCH = "deepseek-v3-671b"
V3_LAYERS = 4            # 3 dense (first_k_dense) + 1 MoE of 256 experts
V3_FORWARD_S = 4096
# kernel 12 at MLA's cacheless forward: B, S, heads, D_qk, D_v
MLA_FLASH = (1, V3_FORWARD_S, 128, 192, 128)
XLSTM_ARCH = "xlstm-350m"
XLSTM_PROMPTS = ZAMBA_PROMPTS       # the 1984-token one first: on the bucket
# mixers with no FFN and no plan launch at a decode step
RECURRENT = ("mamba2", "mlstm", "slstm")
# kernel 12's prefix mode in the check phase (case, B, S, H, KH, D, p):
# paligemma-3b's cacheless forward, and a ragged S with p inside a tile
FLASH_PREFIX_CASES = (
    ("paligemma-3b forward", 1, 4096, 8, 1, 256, 256),
    ("ragged", 2, 1000, 4, 2, 128, 77))
# tensor parallelism: ranks on the one card, joined by gloo
TP = 2
TP_BACKEND = "gloo"
# kernel 6's shapes: the row-parallel partials of gemma-2b at TP-2
# (out-projection and down) and of qwen2-moe's shared down
TP_GEMM_SHAPES = ((1024, 2048), (8192, 2048), (2816, 2048))


class SmokeError(RuntimeError):
    pass


def need(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def say(*parts) -> None:
    print(*parts, flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def time_ms(torch, calls, reps: int = 20) -> float:
    """Median ms of one call on the device.  ``calls`` are callables on
    distinct inputs, captured once into a CUDA graph in round-robin
    order, so that their operands together exceed the 50 MB L2 cache and
    each call finds its weights cold, as the decode loop does (every
    layer has its own weights).  Replaying the graph leaves out the host
    time between launches (the Python wrappers' checks and allocations),
    which eager launches would add to every kernel shorter than it."""
    for c in calls:
        c()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in calls:
            c()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / len(calls))
    del graph
    return statistics.median(samples)


def copies_for(nbytes: int) -> int:
    return max(1, min(64, math.ceil(128e6 / max(nbytes, 1))))


def bound(nbytes, ops, peak) -> tuple[float, str]:
    """The least ms the card could take: the larger of the bytes over
    the memory rate and the operations over ``peak``, and which."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    log = _build.build_all()
    say(f"[build] {len(log)} sources in {time.perf_counter() - t0:.2f} s")
    for name, rec in log.items():
        regs = [ln.strip() for ln in rec["log"].splitlines()
                if "registers" in ln]
        say(f"[build]   {name}: {rec['seconds']:.2f} s; "
            + "; ".join(regs))


def phase_card(torch) -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(f"[card] {out}")
    say(f"[card] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    return out


def _rand_inputs(torch, M, dev, gen):
    """Operands at gemma-2b's widths for M activation rows."""
    d, ff, hk_dh = 2048, 16384, (8 + 2 * 1) * 256

    def w(K, N):
        return (torch.randint(-127, 128, (K, N), dtype=torch.int8,
                              device=dev, generator=gen),
                torch.rand(N, device=dev, generator=gen) * 2e-3 + 1e-4)
    x = torch.randn((M, d), device=dev, generator=gen).to(torch.bfloat16)
    h = torch.randn((M, ff), device=dev, generator=gen) * 0.05
    res = torch.randn((M, d), device=dev, generator=gen).to(torch.bfloat16)
    return dict(x=x, h=h, res=res, wqkv=w(d, hk_dh), wo=w(d, d),
                wg=w(d, ff), wu=w(d, ff), wd=w(ff, d))


def _decode_inputs(torch, dev, gen, B=8, S=1024, KH=1, G=8, D=256,
                   lengths=None):
    lengths = lengths or [S] * B
    q = torch.randn((B, KH, G, D), device=dev, generator=gen).to(
        torch.bfloat16)
    k = torch.randint(-127, 128, (B, S, KH, D), dtype=torch.int8,
                      device=dev, generator=gen)
    v = torch.randint(-127, 128, (B, S, KH, D), dtype=torch.int8,
                      device=dev, generator=gen)
    ks = torch.rand((B, S, KH), device=dev, generator=gen) * 0.02 + 1e-3
    vs = torch.rand((B, S, KH), device=dev, generator=gen) * 0.02 + 1e-3
    pos = torch.full((B, S), 2 ** 30, dtype=torch.int32, device=dev)
    for b, n in enumerate(lengths):
        pos[b, :n] = torch.arange(n, dtype=torch.int32, device=dev)
    qp = torch.tensor([n - 1 for n in lengths], dtype=torch.int32,
                      device=dev)
    return q, k, v, pos, qp, ks, vs


def _to_pages(torch, k, v, pos, ks, vs, bs, seed):
    """The paged layout of a ring cache: each block of ``bs`` slots that
    holds a position goes to a pool block in shuffled order, the others
    to the null block 0.  The ring's copies of those null blocks are
    zeroed in place, so both layouts hold the same logical cache.
    Returns (tables [B, nb], [k, v, pos, k_scale, v_scale] pools)."""
    import numpy as np
    B, S = pos.shape
    nb = S // bs
    dev = pos.device
    used = (pos.reshape(B, nb, bs) != 2 ** 30).any(-1)
    NB = 1 + B * nb
    ids = torch.as_tensor(np.random.default_rng(seed).permutation(
        np.arange(1, NB)), dtype=torch.int32, device=dev)
    tables = torch.zeros((B, nb), dtype=torch.int32, device=dev)
    tables[used] = ids[:int(used.sum())]
    null = ~used.repeat_interleave(bs, 1)
    pools = []
    for a, fill in ((k, 0), (v, 0), (pos, 2 ** 30), (ks, 0), (vs, 0)):
        a.masked_fill_(null.reshape(B, S, *[1] * (a.dim() - 2)), fill)
        pool = torch.full((NB, bs) + tuple(a.shape[2:]), fill,
                          dtype=a.dtype, device=dev)
        pool[tables[used].long()] = a.reshape(B, nb, bs, *a.shape[2:])[used]
        pools.append(pool)
    return tables, pools


def _stack(torch, E, K, N, gen):
    """int8 weights [E, K, N] and their f32 scales [E, N]."""
    dev = gen.device
    return (torch.randint(-127, 128, (E, K, N), dtype=torch.int8,
                          device=dev, generator=gen),
            torch.rand((E, N), device=dev, generator=gen) * 2e-3 + 1e-4)


def _served_like_counts(torch, gen, dev, E=MOE_E, active=25):
    """int32 [E] expert counts with ``active`` experts holding tokens, as
    a decode step of 8 rows x top-4 leaves about 25 of 60."""
    counts = torch.zeros(E, dtype=torch.int32, device=dev)
    on = torch.randperm(E, device=dev, generator=gen)[:active]
    counts[on] = torch.randint(1, 3, (active,), dtype=torch.int32,
                               device=dev, generator=gen)
    return counts


def _grouped_rows(torch, counts, T, K, gen):
    """Stacked int8 capacity rows [E, T, K] and scales [E, T, 1]: an
    expert without tokens has zero rows (scale 1e-12/127), as the row
    quantizer leaves an empty capacity buffer."""
    E = counts.shape[0]
    dev = counts.device
    x = torch.randint(-127, 128, (E, T, K), dtype=torch.int8, device=dev,
                      generator=gen)
    xs = torch.rand((E, T, 1), device=dev, generator=gen) * 1e-2 + 1e-4
    empty = counts == 0
    x[empty] = 0
    xs[empty] = torch.full((), 1e-12, device=dev) / torch.full(
        (), 127.0, device=dev)
    return x, xs


def phase_check(torch) -> dict:
    """Each kernel against its plain version; returns max |err| per
    kernel (decode shape)."""
    from repro_torch.kernels import cim_gemm as cg
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(1)
    errs: dict[str, float] = {}

    def record(name, a, b, exact, M, rtol=0.0, atol=0.0, rule=None,
               where=None):
        """``atol`` is a number or a tensor that broadcasts to ``b``;
        M = 8 (the decode shape) records the kernel's max |err|."""
        a32, b32 = a.float(), b.float()
        diff = (a32 - b32).abs()
        err = diff.max().item()
        if exact:
            ok = torch.equal(a, b)
            rule = "bitwise"
        else:
            limit = atol + rtol * b32.abs()
            ok = bool((diff <= limit).all())
            worst = (diff / limit.clamp_min(1e-30)).max().item()
            rule = (f"{rule or f'rtol={rtol:g} atol={atol:.3g}'}; "
                    f"largest err/limit {worst:.3g}")
        where = where or f"M={M}"
        say(f"[check] {name} {where}: max_abs_err={err:.3g} ({rule}) "
            f"{'ok' if ok else 'FAIL'}")
        need(ok, f"{name} at {where} disagrees with its plain version")
        if M == 8:
            errs[name] = max(errs.get(name, 0.0), err)

    for M in (8, 64, 256, 5056):
        t = _rand_inputs(torch, M, dev, gen)
        for x in (t["x"], t["h"]):
            q, s = cg.quantize_rows_int8(x)
            qr, sr = cg.quantize_rows_int8_plain(x)
            record("quantize_rows_int8", q, qr, True, M)
            record("quantize_rows_int8", s, sr, True, M)
        w, ws = t["wqkv"]
        record("cim_gemm_int8_fused_qin",
               cg.cim_gemm_int8_fused_qin(t["x"], w, ws),
               cg.cim_gemm_int8_fused_qin_plain(t["x"], w, ws), True, M)
        w, ws = t["wo"]
        record("cim_gemm_int8_fused_qin",
               cg.cim_gemm_int8_fused_qin(t["x"], w, ws, residual=t["res"]),
               cg.cim_gemm_int8_fused_qin_plain(t["x"], w, ws, None,
                                                t["res"]), True, M)
        ref = cg.cim_gemm_int8_fused_qin_plain(t["x"], w, ws, ws, None,
                                               "gelu")
        record("cim_gemm_int8_fused_qin[gelu]",
               cg.cim_gemm_int8_fused_qin(t["x"], w, ws, bias=ws,
                                          activation="gelu"),
               ref, False, M, GELU_RTOL, GELU_RTOL * ref.abs().max().item())
        hq, hs = cg.quantize_rows_int8(t["h"])
        w, ws = t["wd"]
        record("cim_gemm_int8_fused",
               cg.cim_gemm_int8_fused(hq, w, hs, ws, residual=t["res"]),
               cg.cim_gemm_int8_fused_plain(hq, w, hs, ws, None, t["res"]),
               True, M)
        xq, xs = cg.quantize_rows_int8(t["x"])
        (wg, gs), (wu, us) = t["wg"], t["wu"]
        ref = cg.cim_gated_gemm_int8_plain(xq, wg, wu, xs, gs, us, "gelu")
        record("cim_gated_gemm_int8",
               cg.cim_gated_gemm_int8(xq, wg, wu, xs, gs, us, "gelu"),
               ref, False, M, GELU_RTOL, GELU_RTOL * ref.abs().max().item())
    q, k, v, pos, qp, ks, vs = _decode_inputs(
        torch, dev, gen, lengths=[1, 17, 100, 250, 513, 800, 1000, 1024])
    ref = da.decode_attention_plain(q, k, v, pos, qp, ks, vs).to(q.dtype)
    row_max = ref.float().abs().amax(-1, keepdim=True)
    rule = f"rtol=2^-7 atol={ATTN_ATOL_ROW:g} x row max"
    record("decode_attention", da.decode_attention(q, k, v, pos, qp, ks, vs),
           ref, False, 8, ATTN_RTOL, ATTN_ATOL_ROW * row_max, rule=rule)

    def attn_record(name, out, ref, where):
        ref = ref.to(out.dtype)
        row = ref.float().abs().amax(-1, keepdim=True)
        record(name, out, ref, False, 8, ATTN_RTOL, ATTN_ATOL_ROW * row,
               rule=rule, where=where)

    # paged walk: 16-slot blocks over 1024 slots in shuffled order, row 0
    # with an all-null table (no visible slot: the uniform softmax)
    q, k, v, pos, qp, ks, vs = _decode_inputs(
        torch, dev, gen, lengths=[0, 17, 100, 250, 513, 800, 1000, 1024])
    tables, (kp, vp, pp, ksp, vsp) = _to_pages(torch, k, v, pos, ks, vs,
                                               PAGED_BLOCK, SEED)
    need(bool((tables[0] == 0).all()), "row 0's table is not all null")
    paged = da.decode_attention_paged(q, kp, vp, pp, tables, qp, ksp, vsp)
    where = f"B=8 bs={PAGED_BLOCK} S=1024"
    attn_record("decode_attention_paged", paged,
                da.decode_attention_paged_plain(q, kp, vp, pp, tables, qp,
                                                ksp, vsp), where)
    record("decode_attention_paged vs ring walk", paged,
           da.decode_attention(q, k, v, pos, qp, ks, vs), True, 0,
           where=where)

    # split walk at 8192 slots: each NS against the plain split version,
    # NS = 1 bitwise against the single walk; the combine on the kernel's
    # partial states against its plain version
    q, k, v, pos, qp, ks, vs = _decode_inputs(
        torch, dev, gen, S=8192,
        lengths=[1, 100, 1500, 2049, 4000, 5016, 7000, 8192])
    single = da.decode_attention(q, k, v, pos, qp, ks, vs)
    for ns in (1, 2, 4, 8):
        where = f"B=8 S=8192 NS={ns}"
        out = ops.decode_attention_splitkv(q, k, v, pos, qp, ks, vs,
                                           n_splits=ns)
        attn_record("decode_attention_partial", out,
                    kref.decode_attention_splitkv_ref(
                        q, k, v, pos, qp, ns, da.split_len(8192, ns),
                        k_scale=ks, v_scale=vs), where)
        if ns == 1:
            record("split walk NS=1 vs single walk", out, single, True, 0,
                   where=where)
        o, m, l = da.decode_attention_partial(q, k, v, pos, qp, ks, vs,
                                              n_splits=ns)
        attn_record("decode_attention_combine",
                    da.decode_attention_combine(o, m, l, q.dtype),
                    da.decode_attention_combine_plain(o, m, l, q.dtype),
                    where)

    # grouped GEMMs at qwen2-moe's widths: decode (T = 8) and a 64-token
    # prefill of 8 rows (T = 48), 35 of the 60 experts without tokens
    for T in (8, 48):
        counts = _served_like_counts(torch, gen, dev)
        x, xs = _grouped_rows(torch, counts, T, MOE_D, gen)
        (wg, gs), (wu, us) = (_stack(torch, MOE_E, MOE_D, MOE_F, gen)
                              for _ in range(2))
        where = f"E={MOE_E} T={T} active={int((counts > 0).sum())}"
        ref = cg.cim_grouped_gated_gemm_int8_plain(x, wg, wu, xs, gs, us,
                                                   counts, "silu")
        h = cg.cim_grouped_gated_gemm_int8(x, wg, wu, xs, gs, us,
                                           counts=counts, activation="silu")
        record("cim_grouped_gated_gemm_int8", h, ref, False, T, GELU_RTOL,
               GELU_RTOL * ref.abs().max().item(), where=where)
        need(bool((h[counts == 0] == 0).all()),
             "a skipped expert's rows are not zero")
        q, s = cg.cim_grouped_gated_gemm_int8(x, wg, wu, xs, gs, us,
                                              counts=counts,
                                              activation="silu",
                                              quantize_out=True)
        qr, sr = cg.quantize_rows_int8_plain(h)
        record("cim_grouped_gated_gemm_int8[requant q]", q, qr, True, 0,
               where=where)
        record("cim_grouped_gated_gemm_int8[requant scale]", s, sr, True, 0,
               where=where)
        wd, ds = _stack(torch, MOE_E, MOE_F, MOE_D, gen)
        down = cg.cim_grouped_gemm_int8(q, wd, s, ds, counts=counts)
        record("cim_grouped_gemm_int8", down,
               cg.cim_grouped_gemm_int8_plain(q, wd, s, ds, None, counts),
               True, T, where=where)
        record("cim_grouped_gemm_int8 skip list vs full run", down,
               cg.cim_grouped_gemm_int8(q, wd, s, ds), True, 0, where=where)
        del wg, wu, wd

    # the requant epilogue of kernels 3 and 4 at the shared MLP's width,
    # the expert width and a ragged width: bitwise the row quantizer of
    # the f32 output the same kernel writes without it
    for M, N in ((8, MOE_SHARED), (8, MOE_F), (40, 1000)):
        xq = torch.randint(-127, 128, (M, MOE_D), dtype=torch.int8,
                           device=dev, generator=gen)
        xs = torch.rand((M, 1), device=dev, generator=gen) * 1e-2 + 1e-4
        (wg, gs), (wu, us) = (_stack(torch, 1, MOE_D, N, gen)
                              for _ in range(2))
        wg, gs, wu, us = wg[0], gs[0], wu[0], us[0]
        for name, fn, args in (
                ("cim_gated_gemm_int8", cg.cim_gated_gemm_int8,
                 (xq, wg, wu, xs, gs, us, "silu")),
                ("cim_gemm_int8_fused", cg.cim_gemm_int8_fused,
                 (xq, wg, xs, gs, None, None, "gelu"))):
            q, s = fn(*args, quantize_out=True)
            qr, sr = cg.quantize_rows_int8_plain(fn(*args))
            record(f"{name}[requant]", torch.cat([q.float(), s], 1),
                   torch.cat([qr.float(), sr], 1), True, 0,
                   where=f"M={M} N={N}")

    # ring and paged walks at qwen2-moe's heads (KH 16, G 1, D 128)
    q, k, v, pos, qp, ks, vs = _decode_inputs(
        torch, dev, gen, KH=16, G=1, D=128,
        lengths=[0, 17, 100, 250, 513, 800, 1000, 1024])
    where = "B=8 KH=16 G=1 D=128 S=1024"
    tables, (kp, vp, pp, ksp, vsp) = _to_pages(torch, k, v, pos, ks, vs,
                                               PAGED_BLOCK, SEED)
    ring = da.decode_attention(q, k, v, pos, qp, ks, vs)
    attn_record("decode_attention[KH=16]", ring,
                da.decode_attention_plain(q, k, v, pos, qp, ks, vs), where)
    paged = da.decode_attention_paged(q, kp, vp, pp, tables, qp, ksp, vsp)
    attn_record("decode_attention_paged[KH=16]", paged,
                da.decode_attention_paged_plain(q, kp, vp, pp, tables, qp,
                                                ksp, vsp), where)
    record("decode_attention_paged vs ring walk", paged, ring, True, 0,
           where=where)

    # kernel 6 (int8 -> int32, no epilogue): the TP row-parallel partials
    # at decode (M = 8), the prefill shapes and ragged edges, exactly
    for M in (8, 64, 256, 5056):
        for K, N in TP_GEMM_SHAPES[:2] if M > 8 else TP_GEMM_SHAPES:
            x = torch.randint(-127, 128, (M, K), dtype=torch.int8,
                              device=dev, generator=gen)
            w = torch.randint(-127, 128, (K, N), dtype=torch.int8,
                              device=dev, generator=gen)
            record("cim_gemm_int8", cg.cim_gemm_int8(x, w),
                   cg.cim_gemm_int8_plain(x, w), True, M,
                   where=f"M={M} K={K} N={N}")
    for M, K, N in ((13, 1030, 68), (3, 100, 36), (1, 5, 4)):
        x = torch.randint(-127, 128, (M, K), dtype=torch.int8, device=dev,
                          generator=gen)
        w = torch.randint(-127, 128, (K, N), dtype=torch.int8, device=dev,
                          generator=gen)
        record("cim_gemm_int8", cg.cim_gemm_int8(x, w),
               cg.cim_gemm_int8_plain(x, w), True, 0,
               where=f"M={M} K={K} N={N}")

    # head-parallel decode: a TP-2 rank of gemma-2b attends 4 of the 8 q
    # heads of its one KV head; each head's bits must not depend on the
    # group (ring and paged walks, G = 4 against G = 8)
    q, k, v, pos, qp, ks, vs = _decode_inputs(
        torch, dev, gen, lengths=[0, 17, 100, 250, 513, 800, 1000, 1024])
    tables, (kp, vp, pp, ksp, vsp) = _to_pages(torch, k, v, pos, ks, vs,
                                               PAGED_BLOCK, SEED)
    ring = da.decode_attention(q, k, v, pos, qp, ks, vs)
    paged = da.decode_attention_paged(q, kp, vp, pp, tables, qp, ksp, vsp)
    for r in range(TP):
        heads = slice(r * 8 // TP, (r + 1) * 8 // TP)
        qr = q[:, :, heads].contiguous()
        where = f"B=8 KH=1 G=4 (heads {heads.start}..{heads.stop - 1}) S=1024"
        record("decode_attention G=4 vs G=8", da.decode_attention(
            qr, k, v, pos, qp, ks, vs), ring[:, :, heads], True, 0,
            where=where)
        record("decode_attention_paged G=4 vs G=8",
               da.decode_attention_paged(qr, kp, vp, pp, tables, qp, ksp,
                                         vsp), paged[:, :, heads], True, 0,
               where=where)

    _check_dit_gemms(torch, record, dev, gen)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return errs


# ---------------------------------------------------------------------------
# the degraded mode: the finite screen and the gated fallback
# ---------------------------------------------------------------------------
def _poison(torch, t, gen):
    """A copy of the float tensor ``t`` with a NaN, a +inf and a -inf at
    random places."""
    a = t.clone().reshape(-1)
    idx = torch.randperm(a.numel(), device=a.device, generator=gen)[:3]
    a[idx] = torch.tensor([math.nan, math.inf, -math.inf], device=a.device,
                          dtype=a.dtype)
    return a.reshape(t.shape)


def _fallback_cases(torch, dev, gen):
    """(name, where, call(fn, gate, out), kernel, plain, out specs,
    exact) of kernels 1, 2, 3, 4, 7 and 8 at gemma-2b's decode shape
    (M 8) and qwen2-moe's (E 60, T 8), every float operand poisoned."""
    t = _rand_inputs(torch, 8, dev, gen)
    p = (lambda a: _poison(torch, a, gen))
    x, h, res = p(t["x"]), p(t["h"]), p(t["res"])
    wqkv, sqkv = t["wqkv"][0], p(t["wqkv"][1])
    wo, so = t["wo"][0], p(t["wo"][1])
    wg, sg = t["wg"][0], p(t["wg"][1])
    wu, su = t["wu"][0], p(t["wu"][1])
    wd, sd = t["wd"][0], p(t["wd"][1])
    hq = torch.randint(-127, 128, (8, 16384), dtype=torch.int8, device=dev,
                       generator=gen)
    hs = p(torch.rand((8, 1), device=dev, generator=gen) * 1e-2 + 1e-4)
    xq = torch.randint(-127, 128, (8, 2048), dtype=torch.int8, device=dev,
                       generator=gen)
    xs = p(torch.rand((8, 1), device=dev, generator=gen) * 1e-2 + 1e-4)
    counts = _served_like_counts(torch, gen, dev)
    ex, exs = _grouped_rows(torch, counts, 8, MOE_D, gen)
    exs = p(exs)
    (eg, egs), (eu, eus) = (_stack(torch, MOE_E, MOE_D, MOE_F, gen)
                            for _ in range(2))
    egs, eus = p(egs), p(eus)
    eh = torch.randint(-127, 128, (MOE_E, 8, MOE_F), dtype=torch.int8,
                       device=dev, generator=gen)
    ehs = p(torch.rand((MOE_E, 8, 1), device=dev, generator=gen) * 1e-2
            + 1e-4)
    ed, eds = _stack(torch, MOE_E, MOE_F, MOE_D, gen)
    eds = p(eds)
    from repro_torch.kernels import cim_gemm as cg
    f32 = torch.float32
    return [
        ("quantize_rows_int8", "[8, 16384] f32",
         lambda fn, g, o: fn(h, gate=g, out=o), cg.quantize_rows_int8,
         cg.quantize_rows_int8_plain,
         [((8, 16384), torch.int8), ((8, 1), f32)], True),
        ("cim_gemm_int8_fused_qin", "QKV [8, 2048] bf16",
         lambda fn, g, o: fn(x, wqkv, sqkv, None, None, None, g, o),
         cg.cim_gemm_int8_fused_qin, cg.cim_gemm_int8_fused_qin_plain,
         [((8, 2560), f32)], True),
        ("cim_gemm_int8_fused_qin", "out-proj with residual",
         lambda fn, g, o: fn(x, wo, so, None, res, None, g, o),
         cg.cim_gemm_int8_fused_qin, cg.cim_gemm_int8_fused_qin_plain,
         [((8, 2048), f32)], True),
        ("cim_gated_gemm_int8", "[8, 2048] x 2 x [2048, 16384] gelu",
         lambda fn, g, o: fn(xq, wg, wu, xs, sg, su, "gelu", gate=g,
                             out=o),
         cg.cim_gated_gemm_int8, cg.cim_gated_gemm_int8_plain,
         [((8, 16384), f32)], False),
        ("cim_gemm_int8_fused", "down [8, 16384] with residual",
         lambda fn, g, o: fn(hq, wd, hs, sd, None, res, None, gate=g, out=o),
         cg.cim_gemm_int8_fused, cg.cim_gemm_int8_fused_plain,
         [((8, 2048), f32)], True),
        ("cim_grouped_gated_gemm_int8", f"E={MOE_E} T=8 silu",
         lambda fn, g, o: fn(ex, eg, eu, exs, egs, eus, counts, "silu",
                             gate=g, out=o),
         cg.cim_grouped_gated_gemm_int8,
         cg.cim_grouped_gated_gemm_int8_plain,
         [((MOE_E, 8, MOE_F), f32)], False),
        ("cim_grouped_gemm_int8", f"E={MOE_E} T=8 down",
         lambda fn, g, o: fn(eh, ed, ehs, eds, None, counts, None, gate=g,
                             out=o),
         cg.cim_grouped_gemm_int8, cg.cim_grouped_gemm_int8_plain,
         [((MOE_E, 8, MOE_D), f32)], True)]


def phase_check_fallback(torch, errs: dict) -> None:
    """The degraded mode's kernels against their plain versions: the
    screen's flag (0 on finite values, 1 with a NaN or an inf) at the
    decode outputs' sizes and a prefill's; each gated fallback of kernels
    1, 2, 3, 4, 7 and 8 (``_fallback_cases``) with the flag at 0, where
    its sentinel-filled output must come back untouched bitwise, and at
    1, where it must equal its plain version on the sanitized operands
    (integers exact, floats bitwise, or within ``GELU_RTOL`` after an
    activation).  Adds the screen's max |err| (the flags') to ``errs``."""
    from repro_torch.kernels import cim_gemm as cg
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(11)
    trips = cg.screen_trips(dev)
    flags = tripped = 0
    for n in (8 * 2048, 8 * 2560, MOE_E * 8 * MOE_D, 4096 * 2048):
        x = torch.randn(n, device=dev, generator=gen)
        for bad in (None, math.nan, math.inf, -math.inf):
            y = x.clone()
            if bad is not None:
                y[int(torch.randint(n, (1,), generator=gen, device=dev))] = \
                    bad
                tripped += 1
            got, want = cg.finite_screen(y), cg.finite_screen_plain(y)
            need(torch.equal(got, want) and int(got) == (bad is not None),
                 f"finite_screen at n={n} ({bad}): {int(got)} != "
                 f"{int(want)}")
            flags += 1
    need(cg.screen_trips(dev) - trips == 2 * tripped,
         "finite_screen: the trip counter missed a screen")
    say(f"[check] finite_screen: {flags} screens of 16384 to 8388608 "
        f"values, flags equal the plain version's, {tripped} tripped and "
        f"counted ok")
    errs["finite_screen"] = 0.0
    for name, where, call, fn, plain, outs, exact in _fallback_cases(
            torch, dev, gen):
        for v in (0, 1):
            flag = torch.tensor([v], dtype=torch.int32, device=dev)
            got, want = ([torch.full(s, 77 if d == torch.int8 else 12345.0,
                                     dtype=d, device=dev) for s, d in outs]
                         for _ in range(2))
            call(fn, flag, got[0] if len(got) == 1 else tuple(got))
            call(plain, flag, want[0] if len(want) == 1 else tuple(want))
            _sync(torch)
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(got, want))
            if v == 0 or exact:
                ok = all(torch.equal(a, b) for a, b in zip(got, want))
                rule = "bitwise"
            else:
                ok = all(torch.equal(a, b) if a.dtype == torch.int8 else
                         bool(((a - b).abs() <= 1e-6 + GELU_RTOL * b.abs())
                              .all()) for a, b in zip(got, want))
                rule = f"rtol={GELU_RTOL:g} atol=1e-06"
            ok = ok and all(bool(torch.isfinite(a.float()).all())
                            for a in got)
            what = "passed: sentinel untouched" if v == 0 else \
                "tripped: sanitized operands"
            say(f"[check] {name}[fallback] {where}, {what}: "
                f"max_abs_err={err:.3g} ({rule}) {'ok' if ok else 'FAIL'}")
            need(ok, f"{name}'s fallback ({where}, flag {v}) disagrees "
                 f"with its plain version")


def times_fallback(torch, card: str) -> dict:
    """The degraded mode's cost on a healthy step, at the check's shapes
    (``_fallback_cases``): each gated fallback launch with the flag at 0
    (its blocks read the flag and leave) beside the same kernel's
    ungated launch, each the same call ``FALLBACK_REPS`` times in one
    CUDA graph (so the kernel's operands are warm in L2, and a gated
    launch's time is what a launch that exits costs in a graph), and the
    screen at the decode outputs' sizes.  Returns the screen's row of
    the kernels' record, at the out-projection's output [8, 2048] f32."""
    from repro_torch.kernels import cim_gemm as cg
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(12)
    passed = torch.zeros(1, dtype=torch.int32, device=dev)
    for name, where, call, fn, _, outs, _ in _fallback_cases(torch, dev,
                                                             gen):
        bufs = [torch.empty(s, dtype=d, device=dev) for s, d in outs]
        out = bufs[0] if len(bufs) == 1 else tuple(bufs)
        kern = time_ms(torch, [lambda: call(fn, None, None)] * FALLBACK_REPS)
        gated = time_ms(torch,
                        [lambda: call(fn, passed, out)] * FALLBACK_REPS)
        say(f"[times] {name}[fallback] {where}: {gated:.4f} ms a gated "
            f"launch with the flag passed, against {kern:.4f} ms for the "
            f"kernel's launch (warm), on {card}")
    row = None
    for shape in ((8, 2048), (8, 2560), (MOE_E, 8, MOE_D)):
        n = math.prod(shape)
        xs = [torch.randn(shape, device=dev, generator=gen)
              for _ in range(copies_for(4 * n))]
        ms = time_ms(torch, [(lambda x=x: cg.finite_screen(x)) for x in xs])
        plain_ms = time_ms(torch, [lambda: cg.finite_screen_plain(xs[0])],
                           reps=5)
        b, by = bound(4 * n + 4, n, F32_OPS_PER_S)
        say(f"[times] finite_screen {list(shape)} f32: {ms:.4f} ms (bound "
            f"{b:.5f} ms by {by}, plain {plain_ms:.4f} ms) on {card}")
        if row is None:
            row = dict(name="finite_screen", ms=ms, plain_ms=plain_ms,
                       bound_ms=b, bound_by=by, library_ms=None)
    return row


def _dit_operands(torch, dev, gen, launch, name, M, K, N):
    """Operands of one ``DIT_GEMMS`` launch drawn from ``gen``: int8
    weights ``w`` [K, N] with scales ``ws``; for kernel 2 its float input
    ``x`` (f32 with a ``bias`` for the adaLN, else bf16), for kernel 3
    int8 codes ``xq`` with row scales ``xs``.  ``run`` makes the launch
    as the block makes it (MLP up with the in-kernel requant), and
    ``nbytes`` counts each input read once and the output written once."""
    from types import SimpleNamespace
    from repro_torch.kernels import cim_gemm as cg
    o = SimpleNamespace(
        w=torch.randint(-127, 128, (K, N), dtype=torch.int8, device=dev,
                        generator=gen),
        ws=torch.rand(N, device=dev, generator=gen) * 2e-3 + 1e-4,
        x=None, bias=None, xq=None, xs=None)
    if name == "cim_gemm_int8_fused_qin":
        o.x = torch.randn((M, K), device=dev, generator=gen)
        if launch == "adaLN":
            o.bias = torch.randn(N, device=dev, generator=gen)
            o.nbytes = M * K * 4 + K * N + 2 * N * 4 + M * N * 4
        else:
            o.x = o.x.to(torch.bfloat16)
            o.nbytes = M * K * 2 + K * N + N * 4 + M * N * 4
        o.run = lambda: cg.cim_gemm_int8_fused_qin(o.x, o.w, o.ws,
                                                   bias=o.bias)
        return o
    o.xq = torch.randint(-127, 128, (M, K), dtype=torch.int8, device=dev,
                         generator=gen)
    o.xs = torch.rand((M, 1), device=dev, generator=gen) * 1e-2 + 1e-4
    if launch == "MLP up":
        o.nbytes = M * K + M * 4 + K * N + N * 4 + M * N + M * 4
        o.run = lambda: cg.cim_gemm_int8_fused(
            o.xq, o.w, o.xs, o.ws, activation="gelu", quantize_out=True)
    else:
        o.nbytes = M * K + M * 4 + K * N + N * 4 + M * N * 4
        o.run = lambda: cg.cim_gemm_int8_fused(o.xq, o.w, o.xs, o.ws)
    return o


def _dit_mlp_input() -> tuple:
    """(M, K) of the MLP's input, which kernel 1 quantizes."""
    return next((M, K) for launch, _, M, K, _, _ in DIT_GEMMS
                if launch == "MLP up")


def _check_dit_gemms(torch, record, dev, gen) -> None:
    """The plan's GEMMs at DiT-XL/2's shapes (``DIT_GEMMS``: 2B = 8 rows
    of 1024 tokens) against their plain versions with ``record`` (see
    :func:`phase_check`): kernel 2 on the f32 adaLN input with the bias
    in its epilogue and on the bf16 QKV and out-projection inputs,
    kernel 1 on the MLP input, kernel 3 with gelu and the requant (MLP
    up) and to f32 (MLP down)."""
    from repro_torch.kernels import cim_gemm as cg
    for launch, name, M, K, N, form in DIT_GEMMS:
        where = f"DiT-XL/2 {launch} M={M} K={K} N={N} {form}"
        o = _dit_operands(torch, dev, gen, launch, name, M, K, N)
        if o.x is not None:
            record(name, o.run(), cg.cim_gemm_int8_fused_qin_plain(
                o.x, o.w, o.ws, o.bias), True, 0, where=where)
        elif launch == "MLP up":
            h = cg.cim_gemm_int8_fused(o.xq, o.w, o.xs, o.ws,
                                       activation="gelu")
            ref = cg.cim_gemm_int8_fused_plain(o.xq, o.w, o.xs, o.ws, None,
                                               None, "gelu")
            record(name, h, ref, False, 0, GELU_RTOL,
                   GELU_RTOL * ref.abs().max().item(), where=where)
            q, s = o.run()
            qr, sr = cg.quantize_rows_int8_plain(h)
            record(f"{name}[requant]", torch.cat([q.float(), s], 1),
                   torch.cat([qr.float(), sr], 1), True, 0, where=where)
        else:
            record(name, o.run(), cg.cim_gemm_int8_fused_plain(
                o.xq, o.w, o.xs, o.ws), True, 0, where=where)
        del o
    M, K = _dit_mlp_input()
    x = torch.randn((M, K), device=dev, generator=gen).to(torch.bfloat16)
    q, s = cg.quantize_rows_int8(x)
    qr, sr = cg.quantize_rows_int8_plain(x)
    record("quantize_rows_int8", torch.cat([q.float(), s], 1),
           torch.cat([qr.float(), sr], 1), True, 0,
           where=f"DiT-XL/2 MLP input [{M}, {K}] bf16")


def _flash_inputs(torch, gen, B, Sq, Skv, H, KH, D, dtype):
    """q [B, Sq, H, D], k and v [B, Skv, KH, D] from N(0, 1)."""
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    return tuple(torch.randn(shape, device=gen.device, generator=gen).to(dt)
                 for shape in ((B, Sq, H, D), (B, Skv, KH, D),
                               (B, Skv, KH, D)))


def _ssd_inputs(torch, gen, BH, S, P, N):
    """A Mamba-2 layer's scan inputs: dt log-uniform in [1e-3, 1e-1] per
    position, A in [1, 16] per head; x = dt * N(0, 1), log_a = -dt * A
    (<= 0), b and c N(0, 1)."""
    dev = gen.device
    dt = torch.exp(torch.empty((BH, S, 1), device=dev).uniform_(
        math.log(1e-3), math.log(1e-1), generator=gen))
    x = dt * torch.randn((BH, S, P), device=dev, generator=gen)
    a = torch.empty((BH, 1), device=dev).uniform_(1.0, 16.0, generator=gen)
    b, c = (torch.randn((BH, S, N), device=dev, generator=gen)
            for _ in range(2))
    return x, -dt[..., 0] * a, b, c


def _softmax_input(torch, gen, case, R, C, dtype):
    """Scores N(0, 2) for attention, logits N(0, 4)."""
    scale = 4.0 if "logits" in case else 2.0
    x = torch.randn((R, C), device=gen.device, generator=gen) * scale
    return x.to(torch.bfloat16 if dtype == "bf16" else torch.float32)


def phase_ops(torch) -> tuple[dict, dict]:
    """Kernels 12-14 through ``repro_torch.kernels.ops`` at the widths of
    models in the registry: the counters are set to 0, every case is
    driven, the counters are read and must be exact.  Then each output is held
    against its plain version, and flash attention at gemma-2b and
    gemma3-4b also against the model's prefill attention
    (``models.attention.dense_attention`` at positions arange(S)).
    Returns the launch counts and the max |err| of each kernel's timed
    (first) case."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import launch_counts, ops, reset_launch_counts
    from repro_torch.kernels import online_softmax as sm
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models.attention import dense_attention
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(3)
    flash = [_flash_inputs(torch, gen, *c[1:8]) for c in FLASH_CASES]
    ssd = _ssd_inputs(torch, gen, *SSD_CASE[:4])
    soft = [_softmax_input(torch, gen, *c) for c in SOFTMAX_CASES]
    extreme = torch.tensor([[1e4, -1e4, 0.0, 1e4]], device=dev).repeat(256,
                                                                       1)
    _sync(torch)

    reset_launch_counts()
    f_out = [ops.flash_attention(q, k, v, causal=c[8], window=c[9])
             for c, (q, k, v) in zip(FLASH_CASES, flash)]
    s_out = ops.ssd_scan(*ssd, chunk=SSD_CASE[4])
    m_out = [ops.online_softmax(x) for x in soft]
    e_out = ops.online_softmax(extreme)
    _sync(torch)
    counts = launch_counts()
    plans = [sm.softmax_plan(*x.shape, x.dtype, x.data_ptr() % 16 == 0)
             for x in (*soft, extreme)]
    for (case, R, C, dtype), plan in zip(
            (*SOFTMAX_CASES, ("rows [1e4, -1e4, 0, 1e4]", 256, 4, "f32")),
            plans):
        say(f"[ops] online_softmax {case} [{R}, {C}] {dtype}: regime "
            f"{plan.regime}, {plan.threads} threads, {plan.units} units a "
            f"thread, cluster {plan.cluster}, {plan.launches} launch(es)")
    want = {name: 0 for name in SOURCES}
    want.update(flash_attention=len(FLASH_CASES), ssd_scan=1,
                online_softmax=sum(p.launches for p in plans))
    say(f"[ops] launches "
        f"{json.dumps({k: counts[k] for k in OPS_KERNELS})} (the softmax "
        f"its plans' launches)")
    need(counts == want, f"launch counts {counts} != expected {want}")

    errs: dict[str, float] = {}

    def held(name, where, got, ref, limit, rule, timed):
        diff = (got.float() - ref.float()).abs()
        ok = bool(torch.isfinite(got).all()) and bool((diff <= limit).all())
        worst = (diff / limit.clamp_min(1e-30)).max().item()
        err = diff.max().item()
        say(f"[ops] {name} {where}: max_abs_err={err:.3g} ({rule}; largest "
            f"err/limit {worst:.3g}) {'ok' if ok else 'FAIL'}")
        need(ok, f"{name} at {where} disagrees with its reference")
        if timed:
            errs[name] = max(errs.get(name, 0.0), err)

    for i, (c, (q, k, v), out) in enumerate(zip(FLASH_CASES, flash, f_out)):
        case, B, Sq, Skv, H, KH, D, dtype, causal, window = c
        where = (f"{case} (B {B}, Sq {Sq}, Skv {Skv}, H {H}, KH {KH}, "
                 f"D {D}, {dtype}, window {window})")
        plain = fa.flash_attention_plain(q, k, v, causal, window)
        ref = plain.float().abs()
        tol = FLASH_TOL[dtype]
        held("flash_attention", where, out, plain,
             tol * ref + tol * ref.amax(-1, keepdim=True),
             f"rtol={tol:.3g} + {tol:.3g} x row max", i == 0)
        if dtype == "bf16" and Sq == Skv:
            pos = torch.arange(Sq, device=dev)[None].expand(B, Sq)
            kind = ("full" if not causal else
                    "causal" if window is None else "sliding")
            dense = dense_attention(q, k, v, pos, pos, kind, window)
            held("flash_attention vs dense_attention", f"{where}, {kind}",
                 out, dense,
                 FLASH_DENSE_TOL * (1 + dense.float().abs()),
                 f"rtol=atol={FLASH_DENSE_TOL:g}", False)
        del plain, ref

    BH, S, P, N, L = SSD_CASE
    for what, got, ref in zip(("y", "final state"), s_out,
                              ss.ssd_scan_plain(*ssd, L)):
        held("ssd_scan", f"zamba2-1.2b Mamba-2 layer (BH {BH}, S {S}, "
             f"P {P}, N {N}, chunk {L}) {what}", got, ref,
             SSD_TOL * ref.abs() + SSD_TOL * ref.abs().max(),
             f"rtol={SSD_TOL:g} + {SSD_TOL:g} x max", True)
    # from a nonzero initial state (the model path's continuation), at
    # SSD_CASE and at serve-zamba2's longest prefill in the model's layout
    # (B 1, 1984 tokens, 64 heads, b and c per group); not counted
    h0 = torch.randn((BH, P, N), device=dev, generator=gen)
    served = _ssd_inputs(torch, gen, BH, ZAMBA_PREFILL, P, N)
    served = (served[0].transpose(0, 1)[None].contiguous(),
              served[1].t()[None].contiguous(),
              served[2][:1].transpose(0, 1)[None].contiguous(),
              served[3][:1].transpose(0, 1)[None].contiguous(), h0[None])
    for where, args in ((f"BH {BH}, S {S}, P {P}, N {N}, chunk {L}, h0",
                         (*ssd, L, h0)),
                        (f"B 1, S {ZAMBA_PREFILL}, H {BH}, G 1, P {P}, "
                         f"N {N}, chunk {L}, h0", (*served[:4], L,
                                                   served[4]))):
        for what, got, ref in zip(("y", "final state"), ss.ssd_scan(*args),
                                  ss.ssd_scan_plain(*args)):
            held("ssd_scan", f"{where} {what}", got, ref,
                 SSD_TOL * ref.abs() + SSD_TOL * ref.abs().max(),
                 f"rtol={SSD_TOL:g} + {SSD_TOL:g} x max", False)
    del served, h0

    for i, (c, x, out, plan) in enumerate(zip(SOFTMAX_CASES, soft, m_out,
                                              plans)):
        case, R, C, dtype = c
        ref = sm.online_softmax_plain(x)
        rtol, atol = SOFTMAX_TOL[dtype]
        r32 = ref.float().abs()
        held("online_softmax",
             f"{case} [{R}, {C}] {dtype} ({plan.regime}, cluster "
             f"{plan.cluster})", out,
             ref, rtol * r32 + atol * r32.max(),
             f"rtol={rtol:.3g} + {atol:g} x max", i == 0)
        sums = out.float().sum(-1)
        need(bool(((sums - 1).abs() <= 1e-2).all()),
             f"online_softmax {case}: a row sums to {sums.min().item()}")
    want_e = torch.tensor([0.5, 0.0, 0.0, 0.5], device=dev).expand(256, 4)
    held("online_softmax", "rows [1e4, -1e4, 0, 1e4] x 256", e_out, want_e,
         torch.full_like(want_e, 1e-7), "atol=1e-7 of [0.5, 0, 0, 0.5]",
         False)
    del flash, ssd, soft, f_out, s_out, m_out
    torch.cuda.empty_cache()
    return counts, errs


def expected_launches(cfg, decode_steps, forwards, kv_len=1024,
                      paged=False, tp=False) -> dict:
    """Launches the full plan makes over ``forwards`` forwards (decode
    steps, prefills or prefill chunks) of which ``decode_steps`` are
    decode steps, by launch counter: the sum of ``layer_launches`` over
    the layers.  ``kv_len`` is the decode walk's cache (the ring's
    ``max_len``, the paged table's capacity), ``paged`` the paged walk,
    ``tp`` a tensor-parallel rank of ``TP``."""
    want = {name: 0 for name in SOURCES}
    for mixer, ffn in cfg.layer_specs():
        for name, n in layer_launches(cfg, mixer, ffn, decode_steps,
                                      forwards, kv_len, paged, tp).items():
            want[name] += n
    return want


def layer_launches(cfg, mixer, ffn, decode_steps, forwards, kv_len=1024,
                   paged=False, tp=False) -> dict:
    """One (mixer, ffn) layer's launches over ``forwards`` forwards of
    which ``decode_steps`` are decode steps.  An attention layer's are the
    port's manifest's (``analysis.manifest.layer_launches``: the
    projections, the MLP or MoE pipeline, the decode walk by ``kv_len``
    and ``paged``, a rank's kernel 6 and requant outside any kernel under
    ``tp``); a prefill attends with the plain dense path.  The layers the
    manifest has no contract for keep this rule: a Mamba-2 layer
    launches kernel 13 once per prefill and nothing at a decode step (its
    projections are bf16 ``torch.matmul``, its decode recurrence plain
    torch); an MLA layer launches only its FFN's (row-quant, gated,
    requant fused when d_ff <= 8192 or one more row-quant, down; an MoE
    FFN the grouped pipeline and the shared MLP's): its projections and
    absorbed attention are bf16 ``torch`` products, as the reference's
    plain ``einsum`` (no plan kind covers them); an mLSTM or sLSTM layer
    launches nothing."""
    from collections import Counter
    from repro_torch.analysis import manifest
    from repro_torch.kernels.cim_gemm import MAX_FUSED_QUANT_N
    want = Counter()
    if mixer in ("attn", "attn_local"):
        walk = dict(sharded=tp, kv_len=kv_len, paged=paged, tp=TP,
                    block_size=PAGED_BLOCK)
        for phase, n in (("decode", decode_steps),
                         ("prefill", forwards - decode_steps)):
            for name, k in manifest.layer_launches(
                    cfg, (mixer, ffn), phase, **walk).items():
                want[name] += k * n
        return want
    if mixer == "mamba2":
        want["ssd_scan"] += forwards - decode_steps
    if mixer in RECURRENT:
        return want
    want["cim_gated_gemm_int8" if cfg.gated
         else "cim_gemm_int8_fused"] += forwards
    want["cim_gemm_int8_fused"] += forwards
    if ffn == "moe":
        want["quantize_rows_int8"] += 2 * forwards
        want["cim_grouped_gated_gemm_int8"] += forwards
        want["cim_grouped_gemm_int8"] += forwards
    else:
        want["quantize_rows_int8"] += (
            1 if cfg.d_ff <= MAX_FUSED_QUANT_N else 2) * forwards
    return want


def launches_per_layer_step(cfg, kv_len=1024, paged=False,
                            by_ffn=False) -> dict:
    """Launches of one decode step, per layer mixer kind (e.g. gemma3-4b:
    7 on a local layer, 8 on a global one with the split walk), or per
    ``"mixer/ffn"`` kind with ``by_ffn`` (deepseek-v3: ``mla/dense`` and
    ``mla/moe``)."""
    out = {}
    for mixer, ffn in cfg.layer_specs():
        key = f"{mixer}/{ffn}" if by_ffn else mixer
        if key not in out:
            out[key] = sum(layer_launches(cfg, mixer, ffn, 1, 1, kv_len,
                                          paged).values())
    return out


def launches_per_decode_step(cfg, counts, decode_steps, forwards,
                             tp=False) -> float:
    """Launches per attention (or MLA) layer per decode step: all counted
    launches less the prefills' (``forwards`` without decode steps), over
    the steps (a recurrent layer launches nothing at a decode step)."""
    prefill = sum(expected_launches(cfg, 0, forwards - decode_steps,
                                    tp=tp).values())
    layers = sum(m not in RECURRENT for m, _ in cfg.layer_specs())
    return (sum(counts.values()) - prefill) / (layers * decode_steps)


def _sync(torch) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _serve(torch, engine, reqs, prefill_counter):
    """Submit ``reqs``, set the launch counters (and a tensor-parallel
    engine's collective counters) to 0, step the engine until every
    request is terminal and read the counters.  Returns (counts, wall
    seconds, ms of each step that ran no prefill)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    for r in reqs:
        engine.submit(r)
    reset_launch_counts()
    if engine.tp is not None:
        engine.tp.reset_counts()
    step_ms = []
    t0 = time.perf_counter()
    while engine.pending():
        s0 = time.perf_counter()
        before = getattr(engine.stats, prefill_counter)
        engine.step()
        _sync(torch)
        if getattr(engine.stats, prefill_counter) == before:
            step_ms.append((time.perf_counter() - s0) * 1e3)
    engine.run_until_done()      # nothing left to step: the ranks' check
    wall = time.perf_counter() - t0
    return launch_counts(), wall, step_ms


def _check_served(cfg, reqs, new_tokens):
    from repro_torch.serving import RequestStatus
    need(all(r.status is RequestStatus.OK for r in reqs),
         f"requests not OK: {[r.status.value for r in reqs]}")
    need(all(len(r.generated) == new_tokens for r in reqs),
         "a request stopped early")
    need(all(0 <= t < cfg.vocab for r in reqs for t in r.generated),
         "token out of the vocabulary")


def _prompts(cfg, lengths, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lengths]


def phase_serve(torch) -> tuple[dict, dict]:
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.quant import QuantPlan
    from repro_torch.serving import Request, ServingEngine

    cfg = get_config("gemma-2b")
    t0 = time.perf_counter()
    model = Model(cfg).init(SEED, device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say(f"[serve] gemma-2b init: {n_params / 1e9:.3f} B parameters, "
        f"{time.perf_counter() - t0:.1f} s")
    engine = ServingEngine(model, n_slots=8, max_len=1024,
                           prefill_bucket=64, quant_plan=QuantPlan.full())
    torch.cuda.synchronize()
    say(f"[serve] quantized (full plan), device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    lengths = SERVE_LENGTHS
    reqs = [Request(uid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(_prompts(cfg, lengths, SEED))]
    counts, wall, step_ms = _serve(torch, engine, reqs, "prefills")
    st = engine.stats
    _check_served(cfg, reqs, NEW_TOKENS)
    want = expected_launches(cfg, st.decode_steps,
                             st.decode_steps + st.prefills)
    say(f"[serve] {len(reqs)} requests OK: {st.tokens_out} decode tokens "
        f"+ {st.prefills} prefills in {wall:.2f} s "
        f"({(st.tokens_out + st.prefills) / wall:.1f} tok/s), "
        f"{st.decode_steps} decode steps, median "
        f"{statistics.median(step_ms):.2f} ms per decode step")
    say(f"[serve] launches {json.dumps(counts)}")
    need(counts == want, f"launch counts {counts} != expected {want}")
    per = launches_per_decode_step(cfg, counts, st.decode_steps,
                                   st.decode_steps + st.prefills)
    say(f"[serve] {per:g} launches per layer per decode step")
    for r in reqs[:2]:
        say(f"[serve]   req {r.uid}: prompt[{len(r.prompt)}] -> "
            f"{r.generated[:12]}...")
    return counts, dict(model=model, lengths=lengths,
                        tokens=[r.generated for r in reqs],
                        step_ms=statistics.median(step_ms))


def phase_serve_paged(torch, model, tag: str = "serve-paged"
                      ) -> tuple[dict, list, float]:
    """The paged engine on the shared model, over a pool that cannot hold
    the first eight requests at once.  Returns the launch counts, the
    requests' tokens and the median ms of a decode-only step."""
    from repro_torch.quant import QuantPlan
    from repro_torch.serving import PagedServingEngine, Request

    cfg = model.cfg
    engine = PagedServingEngine(
        model, n_slots=8, max_len=1024, prefill_bucket=64,
        block_size=PAGED_BLOCK, prefill_chunk=64,
        num_blocks=PAGED_NUM_BLOCKS, quant_plan=QuantPlan.full())
    alloc = engine.paged.allocator
    say(f"[{tag}] pool {alloc.num_blocks - 1} blocks x "
        f"{PAGED_BLOCK} = {(alloc.num_blocks - 1) * PAGED_BLOCK} positions; "
        f"{len(PAGED_PROMPTS)} requests, prompts {PAGED_PROMPTS[0]}.."
        f"{PAGED_PROMPTS[-1]} tokens, {NEW_TOKENS} new each")
    reqs = [Request(uid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(_prompts(cfg, PAGED_PROMPTS, SEED + 1))]
    counts, wall, step_ms = _serve(torch, engine, reqs, "prefill_chunks")
    st = engine.stats
    _check_served(cfg, reqs, NEW_TOKENS)
    need(st.preemptions >= 1, "the tight pool never preempted")
    alloc.check()
    need(alloc.n_used == 0, f"{alloc.n_used} blocks still held at the end")
    want = expected_launches(cfg, st.decode_steps,
                             st.decode_steps + st.prefill_chunks,
                             kv_len=engine._obs_kv_slots(), paged=True)
    say(f"[{tag}] {len(reqs)} requests OK: {st.tokens_out} decode "
        f"tokens + {st.prefills} prefills ({st.prefill_chunks} chunks) in "
        f"{wall:.2f} s ({(st.tokens_out + st.prefills) / wall:.1f} tok/s), "
        f"{st.decode_steps} decode steps, median "
        f"{statistics.median(step_ms):.2f} ms per decode-only step, "
        f"{st.preemptions} preemptions ({st.evicted_blocks} blocks evicted)")
    say(f"[{tag}] launches {json.dumps(counts)}")
    need(counts == want, f"launch counts {counts} != expected {want}")
    per = launches_per_decode_step(cfg, counts, st.decode_steps,
                                   st.decode_steps + st.prefill_chunks)
    say(f"[{tag}] {per:g} launches per layer per decode step")
    return counts, [r.generated for r in reqs], statistics.median(step_ms)


def _timed_hooks(obs) -> list:
    """Wrap every ``on_*`` hook of ``obs`` in a host timer; returns the
    one-element list the seconds add up in."""
    spent = [0.0]

    def timed(fn):
        def hook(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[0] += time.perf_counter() - t0
        return hook
    for name in dir(obs):
        if name.startswith("on_"):
            setattr(obs, name, timed(getattr(obs, name)))
    return spent


def phase_obs(torch, serve: dict, paged: tuple, card: str) -> dict:
    """gemma-2b's serve and serve-paged runs again on the shared model,
    each engine with ``obs=Observability()`` on a step clock: tokens
    bitwise the runs without obs, every request's span closed once, and
    the booked ``dispatches_total`` (the manifest's ``model_sites`` per
    forward: one block of gemma-2b's one layer group) times the depth
    equal to the launch counters by site class.  Prints the hooks' host
    µs per engine step and the decode-only step's median ms with obs
    beside the run without.  Then ``audit_lm`` on one full-width decode
    step of the same model, ring and paged (launches by counter and by
    site class, the dtype flow outside the wrappers).  Returns the two
    serves' launch counts, summed."""
    from repro_torch.analysis import audit_lm
    from repro_torch.analysis.passes import classify
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.obs import Observability
    from repro_torch.quant import QuantPlan
    from repro_torch.serving import PagedServingEngine, Request, ServingEngine

    model = serve["model"]
    cfg = model.cfg
    need(len(cfg.layer_groups()) == 1, "obs: one layer group expected")
    L = cfg.n_layers
    total = {}
    ring_kw = dict(n_slots=8, max_len=1024, prefill_bucket=64)
    for name, cls, kw, lengths, seed, want, off_ms, counter in (
            ("ring", ServingEngine, ring_kw, SERVE_LENGTHS, SEED,
             serve["tokens"], serve["step_ms"], "prefills"),
            ("paged", PagedServingEngine,
             dict(ring_kw, block_size=PAGED_BLOCK, prefill_chunk=64,
                  num_blocks=PAGED_NUM_BLOCKS), PAGED_PROMPTS, SEED + 1,
             paged[0], paged[1], "prefill_chunks")):
        obs = Observability()
        spent = _timed_hooks(obs)
        tick = [0]
        engine = cls(model, quant_plan=QuantPlan.full(), obs=obs,
                     clock=lambda: float(tick[0]), **kw)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=NEW_TOKENS)
                for i, p in enumerate(_prompts(cfg, lengths, seed))]
        for r in reqs:
            engine.submit(r)
        reset_launch_counts()
        step_ms, hook_us = [], []
        while engine.pending():
            s0, h0 = time.perf_counter(), spent[0]
            before = getattr(engine.stats, counter)
            engine.step()
            _sync(torch)
            if getattr(engine.stats, counter) == before:
                step_ms.append((time.perf_counter() - s0) * 1e3)
            hook_us.append((spent[0] - h0) * 1e6)
            tick[0] += 1
        counts = launch_counts()
        total = {k: total.get(k, 0) + n for k, n in counts.items()}
        _check_served(cfg, reqs, NEW_TOKENS)
        need([r.generated for r in reqs] == want,
             f"obs {name}: tokens differ from the run without obs")
        ends = obs.events.select("request_end")
        need(sorted(e["uid"] for e in ends) == [r.uid for r in reqs]
             and all(obs.traces[r.uid].closed for r in reqs),
             f"obs {name}: a request's span was not closed exactly once")
        booked = {k[0][1]: v for k, v in obs.dispatches_total.series.items()}
        launched = dict(classify(counts))
        need({k: v * L for k, v in booked.items()} == launched,
             f"obs {name}: dispatches_total x {L} layers {booked} != "
             f"the launch counters by site class {launched}")
        snap = obs.snapshot()["metrics"]["counters"]
        need(snap["tokens_total"]["series"][""]
             == sum(len(r.generated) for r in reqs),
             f"obs {name}: tokens_total disagrees with the run")
        on_ms = statistics.median(step_ms)
        say(f"[obs] {name}: {len(reqs)} requests OK, tokens bitwise the run "
            f"without obs, {len(ends)} spans closed once; dispatches_total "
            f"x {L} layers == launches by site class {json.dumps(launched)}")
        say(f"[obs] {name}: hooks' host time per engine step: mean "
            f"{statistics.mean(hook_us):.1f} µs (the first prices of each "
            f"shape simulate the paper's TPU once), median "
            f"{statistics.median(hook_us):.1f} µs, over {len(hook_us)} "
            f"steps; decode-only step median {on_ms:.2f} ms with obs, "
            f"{off_ms:.2f} ms without ({card})")
        del engine
    for paged_walk in (False, True):
        t0 = time.perf_counter()
        rep = audit_lm(cfg.name, "decode", paged=paged_walk, batch=8,
                       kv_len=1024, model=model)
        for line in rep.diff_lines():
            say(f"[obs] audit {line} in {time.perf_counter() - t0:.2f} s")
        need(rep.ok, f"obs: audit_lm found violations: {rep.diff_lines()}")
    return total


def phase_serve_long(torch, model) -> dict:
    """The ring engine at 8192 slots on the shared model: decode
    attention takes the split walk (4 splits)."""
    from repro_torch.kernels import ops
    from repro_torch.quant import QuantPlan
    from repro_torch.serving import Request, ServingEngine

    cfg = model.cfg
    engine = ServingEngine(model, n_slots=4, max_len=LONG_MAX_LEN,
                           prefill_bucket=64, quant_plan=QuantPlan.full())
    reqs = [Request(uid=i, prompt=p, max_new_tokens=LONG_NEW_TOKENS)
            for i, p in enumerate(_prompts(cfg, LONG_PROMPTS, SEED + 2))]
    counts, wall, step_ms = _serve(torch, engine, reqs, "prefills")
    st = engine.stats
    _check_served(cfg, reqs, LONG_NEW_TOKENS)
    want = expected_launches(cfg, st.decode_steps,
                             st.decode_steps + st.prefills,
                             kv_len=LONG_MAX_LEN)
    say(f"[serve-long] {len(reqs)} requests OK (prompts {LONG_PROMPTS}, "
        f"{ops.n_splits_for(LONG_MAX_LEN)} splits): {st.tokens_out} decode "
        f"tokens + {st.prefills} prefills in {wall:.2f} s, "
        f"{st.decode_steps} decode steps, median "
        f"{statistics.median(step_ms):.2f} ms per decode step")
    say(f"[serve-long] launches {json.dumps(counts)}")
    need(counts == want, f"launch counts {counts} != expected {want}")
    per = launches_per_decode_step(cfg, counts, st.decode_steps,
                                   st.decode_steps + st.prefills)
    say(f"[serve-long] {per:g} launches per layer per decode step")
    need(per == 8, f"{per} launches per layer per decode step, not 8")
    return counts


class CountsRecorder:
    """Keeps, without a host sync, the expert counts (the grouped
    kernels' skip list) of every MoE layer of every decode forward."""

    def __init__(self):
        from repro_torch.models import moe
        self.mod, self.fn, self.decode = moe, moe.expert_counts, []

    def __enter__(self):
        def record(r, n_experts):
            counts = self.fn(r, n_experts)
            if r.expert_ids.shape[1] == 1:
                self.decode.append(counts)
            return counts
        self.mod.expert_counts = record
        return self

    def __exit__(self, *exc):
        self.mod.expert_counts = self.fn


def phase_serve_moe(torch) -> tuple[dict, dict]:
    """Full-width qwen2-moe-a2.7b on the ring engine: 8 slots, 8 greedy
    requests of 16-200 prompt tokens, 32 new each."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.quant import QuantPlan
    from repro_torch.serving import Request, ServingEngine

    cfg = get_config(MOE_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg).init(SEED, device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say(f"[serve-moe] {MOE_ARCH} init: {n_params / 1e9:.3f} B parameters "
        f"in bf16 ({cfg.n_layers} layers, {cfg.moe.n_routed_experts} "
        f"experts top-{cfg.moe.top_k}, shared {cfg.moe.shared_width}), "
        f"{time.perf_counter() - t0:.1f} s, device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    engine = ServingEngine(model, n_slots=8, max_len=1024,
                           prefill_bucket=64, quant_plan=QuantPlan.full())
    torch.cuda.synchronize()
    say(f"[serve-moe] quantized (full plan): device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, peak so far "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    lengths = SERVE_LENGTHS
    reqs = [Request(uid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(_prompts(cfg, lengths, SEED + 3))]
    with CountsRecorder() as rec:
        counts, wall, step_ms = _serve(torch, engine, reqs, "prefills")
    st = engine.stats
    _check_served(cfg, reqs, NEW_TOKENS)
    want = expected_launches(cfg, st.decode_steps,
                             st.decode_steps + st.prefills)
    say(f"[serve-moe] {len(reqs)} requests OK: {st.tokens_out} decode "
        f"tokens + {st.prefills} prefills in {wall:.2f} s "
        f"({(st.tokens_out + st.prefills) / wall:.1f} tok/s), "
        f"{st.decode_steps} decode steps, median "
        f"{statistics.median(step_ms):.2f} ms per decode step")
    gib = 2 ** 30
    say(f"[serve-moe] device memory {torch.cuda.memory_allocated() / gib:.2f} "
        f"GiB, peak {torch.cuda.max_memory_allocated() / gib:.2f} GiB")
    say(f"[serve-moe] launches {json.dumps(counts)}")
    need(counts == want, f"launch counts {counts} != expected {want}")
    per = launches_per_decode_step(cfg, counts, st.decode_steps,
                                   st.decode_steps + st.prefills)
    say(f"[serve-moe] {per:g} launches per layer per decode step")
    need(per == 9, f"{per} launches per layer per decode step, not 9")
    prefill = sum(expected_launches(cfg, 0, 1).values()) / cfg.n_layers
    say(f"[serve-moe] {prefill:g} launches per layer per prefill")
    need(prefill == 8, f"{prefill} launches per layer per prefill, not 8")
    steps = torch.stack(rec.decode).reshape(st.decode_steps, cfg.n_layers,
                                            -1)
    active = (steps > 0).sum(-1).float()
    need(len(rec.decode) == st.decode_steps * cfg.n_layers,
         "expert counts were not recorded at every decode step")
    say(f"[serve-moe] active experts per layer per decode step: mean "
        f"{active.mean().item():.2f} of {cfg.moe.n_routed_experts} "
        f"(min {active.min().item():g}, max {active.max().item():g})")
    for r in reqs[:2]:
        say(f"[serve-moe]   req {r.uid}: prompt[{len(r.prompt)}] -> "
            f"{r.generated[:12]}...")
    # the skip list of layer 0 at the middle decode step, for the times
    mid = steps[st.decode_steps // 2, 0].clone()
    return counts, dict(model=model, step_counts=mid,
                        tokens=[r.generated for r in reqs],
                        mean_active=active.mean().item())


def phase_reference(torch, model, seed: int,
                    tag: str = "reference") -> None:
    """The kernel path against the plain path on the same weights: one
    full-width ring prefill + decode step, one full-width paged prefill
    in two chunks + decode step, and the reduced config end to end.
    Launches made here are not counted for the serve runs."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import Model
    from repro_torch.quant import QuantPlan, kernel_mode

    def run(m, toks, lengths, plain):
        caches = m.init_cache(toks.shape[0], 1024 if m.cfg.d_model > 64
                              else 64, kv_dtype="int8")
        with torch.no_grad(), kernel_mode(False if plain else None):
            a = m.prefill_padded(toks, caches, lengths)
            b = m.decode_step(a.argmax(-1), caches)
        return torch.cat([a, b], dim=1)

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    arch = model.cfg.name
    for name, m, S in ((arch, model, 64), (
            f"{arch}-smoke", Model(reduced_config(get_config(arch)))
            .init(seed, device=DEVICE).quantize(QuantPlan.full()), 16)):
        B = 4
        toks = torch.randint(0, m.cfg.vocab, (B, S), device=DEVICE,
                             generator=gen)
        lengths = torch.tensor([S, S - 3, S // 2, 1], dtype=torch.int32,
                               device=DEVICE)
        kern = run(m, toks, lengths, plain=False)
        plain = run(m, toks, lengths, plain=True)
        need(bool(torch.isfinite(kern).all()), f"{name}: non-finite logits")
        need(kern.shape == (B, 2, m.cfg.vocab), f"{name}: logits shape")
        err = (kern - plain).abs().max().item()
        tol = LOGITS_ATOL_REL * plain.abs().max().item()
        same = (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()
        say(f"[{tag}] {name}: prefill+decode logits kernel vs plain "
            f"max_abs_err={err:.4g} (tol {tol:.4g}), argmax agreement "
            f"{same:.3f}")
        need(err <= tol, f"{name}: kernel path disagrees with plain path")

    # paged: two 64-token chunks into shuffled 16-slot blocks, then one
    # decode step on the paged kernel (the same next tokens on both paths)
    B, C = 2, 64
    nb = (2 * C + PAGED_BLOCK) // PAGED_BLOCK
    toks = torch.randint(0, model.cfg.vocab, (B, 2 * C + 1), device=DEVICE,
                         generator=gen)
    tables = (torch.randperm(B * nb, device=DEVICE, generator=gen) + 1).to(
        torch.int32).reshape(B, nb)

    def run_paged(plain):
        caches = model.init_paged_cache(B, 1 + B * nb, PAGED_BLOCK, nb,
                                        kv_dtype="int8")
        caches[0]["block_tables"].copy_(tables)

        def i32(*v):
            return torch.tensor(v, dtype=torch.int32, device=DEVICE)
        with torch.no_grad(), kernel_mode(False if plain else None):
            a = model.prefill_padded(toks[:, :C], caches, i32(C, C),
                                     offset=i32(0, 0))
            b = model.prefill_padded(toks[:, C:2 * C], caches,
                                     i32(C, C - 24), offset=i32(C, C))
            c = model.decode_step(toks[:, 2 * C:], caches)
        return torch.cat([a, b, c], dim=1)

    kern, plain = run_paged(False), run_paged(True)
    need(bool(torch.isfinite(kern).all()), "paged: non-finite logits")
    need(kern.shape == (B, 3, model.cfg.vocab), "paged: logits shape")
    err = (kern - plain).abs().max().item()
    tol = LOGITS_ATOL_REL * plain.abs().max().item()
    same = (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()
    say(f"[{tag}] {arch} paged: two-chunk prefill + decode logits "
        f"kernel vs plain max_abs_err={err:.4g} (tol {tol:.4g}), argmax "
        f"agreement {same:.3f}")
    need(err <= tol, "paged: kernel path disagrees with plain path")


def degraded_launches(cfg, decode_steps, forwards) -> dict:
    """``expected_launches`` under degraded mode: per quantized site and
    forward one screen and its fallback chain — QKV and out-proj the
    same launches as the site (one of kernel 2, or kernel 1 then kernel
    3 above ``MAX_FUSED_QUANT_K``), a dense MLP row-quant, gated (or
    kernel 3 ungated), row-quant, down (the fallback never fuses the
    requant), an MoE layer the same over the experts (grouped) and over
    the shared MLP."""
    from repro_torch.kernels.cim_gemm import MAX_FUSED_QUANT_K
    want = expected_launches(cfg, decode_steps, forwards)
    for mixer, ffn in cfg.layer_specs():
        if mixer in RECURRENT:
            continue
        sites = []
        if mixer != "mla":
            sites += [cfg.d_model, cfg.n_heads * cfg.head_dim]
        for K in sites:
            want["finite_screen"] += forwards
            if K <= MAX_FUSED_QUANT_K:
                want["cim_gemm_int8_fused_qin"] += forwards
            else:
                want["quantize_rows_int8"] += forwards
                want["cim_gemm_int8_fused"] += forwards
        mlps = [("cim_gated_gemm_int8" if cfg.gated
                 else "cim_gemm_int8_fused", "cim_gemm_int8_fused")]
        if ffn == "moe":
            mlps.append(("cim_grouped_gated_gemm_int8" if cfg.gated
                         else "cim_grouped_gemm_int8",
                         "cim_grouped_gemm_int8"))
        for up, down in mlps:
            want["finite_screen"] += forwards
            want["quantize_rows_int8"] += 2 * forwards
            want[up] += forwards
            want[down] += forwards
    return want


def _chaos_requests(cfg):
    """The chaos bench's workload: 4 requests of 4-6 prompt tokens and
    4-6 new tokens, sampled at temperature 0.7, top-k 5, seed 11."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(0)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, 4 + i % 3)
                    .astype(np.int32), max_new_tokens=4 + i % 3,
                    temperature=0.7, top_k=5, seed=11) for i in range(4)]


class CampaignClock:
    """Seconds the chaos monkeys spend drawing campaigns (``inject_tree``)
    and writing them into the model (``load_leaves``), read by wrapping
    the names the chaos module calls."""

    def __init__(self, torch):
        from repro_torch.reliability import chaos
        self.torch, self.mod = torch, chaos
        self.seconds = {"draw": 0.0, "load": 0.0}
        self.saved = {n: getattr(chaos, n) for n in ("inject_tree",
                                                     "load_leaves")}

    def __enter__(self):
        for name, key in (("inject_tree", "draw"), ("load_leaves", "load")):
            fn = self.saved[name]

            def timed(*a, _fn=fn, _key=key, **kw):
                t0 = time.perf_counter()
                out = _fn(*a, **kw)
                _sync(self.torch)
                self.seconds[_key] += time.perf_counter() - t0
                return out
            setattr(self.mod, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.mod, name, fn)


def phase_chaos(torch, serve: dict) -> dict:
    """The reliability layer on the serve phase's full-width gemma-2b:
    (a) ``degraded=True`` on a healthy model serves the serve phase's
    requests with its tokens bitwise, at ``degraded_launches``' counts
    (16 launches per layer per decode step); one decode step with the
    mode off and on under CUDA's sync debug mode "error" (the screens
    and gated launches add no host sync); (b) ``inf`` planted in one
    layer's out-projection scale: with the mode off every request ends
    FAILED on the health check, with it on every request ends OK and the
    device's count of tripped screens grows; (c) ``chaos_soak`` on the
    ring engine at ``CHAOS_BERS`` (the chaos bench's workload at full
    width, ``CHAOS_PERIOD``), (d) one soak through the paged engine at
    ``CHAOS_PAGED_BER``, each with every request terminal and every
    invariant held; (e) afterwards every int8 weight bitwise its
    snapshot from before the soaks.  Returns the launch counts of (a)."""
    import contextlib

    import numpy as np
    from repro_torch.kernels import cim_gemm as cg
    from repro_torch.quant import QuantPlan, degraded_mode
    from repro_torch.reliability import chaos_soak, quantized_leaves
    from repro_torch.serving import (PagedServingEngine, Request,
                                     RequestStatus, ServingEngine)
    model = serve["model"]
    cfg = model.cfg
    dev = torch.device(DEVICE)
    plan = QuantPlan.full()
    L = sum(m not in RECURRENT for m, _ in cfg.layer_specs())

    # (a) healthy, degraded
    engine = ServingEngine(model, n_slots=8, max_len=1024, prefill_bucket=64,
                           quant_plan=plan, degraded=True)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(_prompts(cfg, serve["lengths"], SEED))]
    trips = cg.screen_trips(dev)
    counts, wall, step_ms = _serve(torch, engine, reqs, "prefills")
    st = engine.stats
    _check_served(cfg, reqs, NEW_TOKENS)
    same = [r.generated for r in reqs] == serve["tokens"]
    say(f"[chaos] (a) degraded, healthy: {len(reqs)} requests OK, tokens "
        f"{'bitwise the serve phase' if same else 'DIFFER'}s, median "
        f"{statistics.median(step_ms):.2f} ms per decode step, "
        f"{cg.screen_trips(dev) - trips} screens tripped")
    need(same, "chaos: degraded mode changed a healthy serve's tokens")
    need(cg.screen_trips(dev) == trips, "chaos: a healthy screen tripped")
    want = degraded_launches(cfg, st.decode_steps,
                             st.decode_steps + st.prefills)
    say(f"[chaos] (a) launches {json.dumps(counts)}")
    need(counts == want, f"chaos: degraded launch counts {counts} != {want}")
    prefill = sum(degraded_launches(cfg, 0, st.prefills).values())
    per = (sum(counts.values()) - prefill) / (L * st.decode_steps)
    base = launches_per_layer_step(cfg)["attn"]
    say(f"[chaos] (a) {per:g} launches per layer per decode step with "
        f"degraded mode ({base:g} without)")
    need(per == DEGRADED_PER_LAYER[cfg.name],
         f"chaos: {per} launches per layer per decode step, not "
         f"{DEGRADED_PER_LAYER[cfg.name]}")
    syncs = {}
    cache = model.init_cache(8, 64, kv_dtype="int8")
    tok = torch.zeros((8, 1), dtype=torch.long, device=dev)
    for deg in (False, True):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.no_grad(), (degraded_mode(True) if deg
                                   else contextlib.nullcontext()):
                model.decode_step(tok, cache)
            syncs[deg] = "no host sync"
        except RuntimeError as e:
            syncs[deg] = f"a host sync ({str(e).splitlines()[0][:80]})"
        finally:
            torch.cuda.set_sync_debug_mode("default")
    say(f"[chaos] (a) one decode step under sync debug mode 'error': "
        f"{syncs[False]} with the mode off, {syncs[True]} with it on")
    need(syncs[True] == syncs[False] == "no host sync",
         "chaos: a degraded decode step synchronised with the host")
    del engine, cache
    # wall and device time of a decode step, without and with the mode
    phase_profile(torch, model, SEED, "chaos-profile")
    with degraded_mode(True):
        phase_profile(torch, model, SEED, "chaos-profile-degraded")

    # (b) one layer's out-projection scale holds an inf
    o = model.layers[len(model.layers) // 2].attn.o
    saved = o.scale.clone()
    o.scale[7] = math.inf
    outcome = {}
    for deg in (False, True):
        eng = ServingEngine(model, n_slots=8, max_len=1024,
                            prefill_bucket=64, quant_plan=plan,
                            degraded=deg)
        short = [Request(uid=i, prompt=p, max_new_tokens=4)
                 for i, p in enumerate(_prompts(cfg, serve["lengths"],
                                                SEED))]
        t0 = cg.screen_trips(dev)
        for r in short:
            eng.submit(r)
        eng.run_until_done()
        _sync(torch)
        outcome[deg] = ([r.status for r in short],
                        cg.screen_trips(dev) - t0)
    o.scale.copy_(saved)
    off, on = outcome[False], outcome[True]
    say(f"[chaos] (b) inf in layer {len(model.layers) // 2}'s out-projection "
        f"scale: mode off {sorted({s.value for s in off[0]})} (health "
        f"check), mode on {sorted({s.value for s in on[0]})} with "
        f"{on[1]} screens tripped (read once after the run)")
    need(all(s is RequestStatus.FAILED for s in off[0]),
         "chaos: a poisoned layer served without degraded mode")
    need(all(s is RequestStatus.OK for s in on[0]) and on[1] > 0,
         "chaos: degraded mode did not carry the poisoned layer")

    # (c), (d) the soaks
    pristine = quantized_leaves(model)
    soaks = [("ring", ServingEngine, ber, {}) for ber in CHAOS_BERS]
    soaks.append(("paged", PagedServingEngine, CHAOS_PAGED_BER,
                  dict(block_size=16, prefill_chunk=4)))
    for kind, cls, ber, kw in soaks:
        eng = cls(model, n_slots=2, max_len=32, prefill_bucket=4,
                  quant_plan=plan, degraded=True, **kw)
        reqs = _chaos_requests(cfg)
        t0 = time.perf_counter()
        with CampaignClock(torch) as clock:
            res = chaos_soak(eng, reqs, ber=ber, seed=CHAOS_SEED,
                             period=CHAOS_PERIOD,
                             logit_nan_rate=CHAOS_NAN_RATE, max_iters=200)
        secs = time.perf_counter() - t0
        rep = res.chaos
        say(f"[chaos] ({'c' if kind == 'ring' else 'd'}) {kind} soak at ber "
            f"{ber:g}: statuses {res.statuses}, {rep.weight_injections} "
            f"campaigns, {rep.bits_faulted} bits faulted, "
            f"{rep.logit_hits} NaN rows, {res.decode_steps} decode steps, "
            f"{secs:.2f} s ({clock.seconds['draw']:.2f} s drawing, "
            f"{clock.seconds['load']:.2f} s writing the campaigns and the "
            f"restore; "
            f"{clock.seconds['draw'] / max(1, rep.weight_injections):.2f} s "
            f"drawn per campaign)")
        need(all(r.done for r in reqs), "chaos: a request is not terminal")
        need(res.healthy, f"chaos: invariants violated: {res.violations}")
        need(rep.weight_injections > 0, "chaos: no weight campaign ran")
        need(ber < 1e-4 or rep.bits_faulted > 0,
             f"chaos: no bit faulted at ber {ber:g}")
        if kind == "paged":
            eng.paged.allocator.check()
            need(eng.paged.allocator.n_used == 0,
                 "chaos: the paged soak left blocks held")
        del eng

    # (e) the weights are back
    back = quantized_leaves(model)
    need(set(back) == set(pristine) and all(
        np.array_equal(back[p].q, pristine[p].q)
        and np.array_equal(back[p].scale, pristine[p].scale)
        for p in pristine), "chaos: the int8 weights were not restored")
    say(f"[chaos] (e) {len(pristine)} stacked leaves "
        f"({sum(v.q.nbytes for v in pristine.values()) / 1e9:.3f} GB int8) "
        f"bitwise their snapshot after the soaks")
    del pristine, back
    gc.collect()
    return counts


def phase_profile(torch, model, seed: int, tag: str = "profile") -> None:
    """Where a decode step's time goes: wall time per step (no profiler)
    beside the device time the profiler attributes to kernels, at the
    serve shape (8 rows, 1024-slot int8 cache, 64-token prompts)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    caches = model.init_cache(8, 1024, kv_dtype="int8")
    toks = torch.randint(0, model.cfg.vocab, (8, 64), device=DEVICE,
                         generator=gen)
    lengths = torch.full((8,), 64, dtype=torch.int32, device=DEVICE)
    n = 5
    with torch.no_grad():
        nxt = model.prefill_padded(toks, caches, lengths).argmax(-1)
        for _ in range(3):
            model.decode_step(nxt, caches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            model.decode_step(nxt, caches)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                model.decode_step(nxt, caches)
            torch.cuda.synchronize()
    # kernel events only: a CPU op's device time repeats its kernels'
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0)
        if dev > 0:
            rows.append((dev / 1e3 / n, e.count // n, e.key))
    dev_ms = sum(r[0] for r in rows)
    if dev_ms == 0:
        say(f"[{tag}] decode step {wall_ms:.2f} ms wall; device time not "
            f"measured (the profiler saw no device activity)")
        return
    say(f"[{tag}] decode step {wall_ms:.2f} ms wall, {dev_ms:.2f} ms of "
        f"device kernels (busy share {dev_ms / wall_ms:.3f}), "
        f"{sum(r[1] for r in rows)} kernel launches per step")
    for ms, cnt, key in sorted(rows, reverse=True)[:12]:
        say(f"[{tag}]   {ms:8.3f} ms  {cnt:5d} x  {key[:90]}")


def phase_forward_long(torch, model) -> dict:
    """The cacheless forward above 2048 tokens on the shared full-plan
    gemma-2b: one ``Model.forward`` of ``LONG_FORWARD_S`` tokens with the
    model's own positions attends on kernel 12, exactly one launch per
    layer, beside the plan's GEMMs.  Its logits are held against the same
    forward given explicit ``arange`` positions, which attends with the
    plain blockwise path (``models.attention.blockwise_attention``), by
    this script's rule for full-width logits of a kernel path against a
    plain path (``LOGITS_ATOL_REL`` of the largest |logit|), the argmax
    equal wherever the blockwise path's top-2 margin is wider than twice
    ``LONG_LOGIT_ATOL``.  Beside that, the dense path (the threshold
    raised to S for one forward): how far two of the reference's own
    roundings of one function land apart, and whether each pair stays
    within ``LONG_LOGIT_ATOL``.  Prints ms per forward on the kernel and
    the blockwise paths and kernel 12's share of the device time
    (profiler).  Returns the launch counts of the kernel path's
    forward."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import attention as attn_mod

    cfg, S = model.cfg, LONG_FORWARD_S
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    toks = torch.randint(0, cfg.vocab, (1, S), device=DEVICE, generator=gen)
    pos = torch.arange(S, device=DEVICE)[None]
    with torch.no_grad():
        _sync(torch)
        reset_launch_counts()
        kern = model(toks)
        _sync(torch)
        counts = launch_counts()
        plain = model(toks, positions=pos)
        threshold = attn_mod.DENSE_SEQ_THRESHOLD
        attn_mod.DENSE_SEQ_THRESHOLD = S
        try:
            dense = model(toks)
        finally:
            attn_mod.DENSE_SEQ_THRESHOLD = threshold
        _sync(torch)
    want = expected_launches(cfg, 0, 1)
    want["flash_attention"] = cfg.n_layers
    say(f"[forward-long] gemma-2b, full plan, S {S}: launches "
        f"{json.dumps(counts)}")
    need(counts == want, f"forward-long: launch counts {counts} != {want}")
    need(kern.shape == (1, S, cfg.vocab) and bool(torch.isfinite(kern).all()),
         "forward-long: logits shape or non-finite")
    errs = {pair: (a - b).abs().max().item() for pair, a, b in (
        ("kernel 12 vs blockwise", kern, plain),
        ("kernel 12 vs dense", kern, dense),
        ("blockwise vs dense", plain, dense))}
    tol = LOGITS_ATOL_REL * plain.abs().max().item()
    for pair, err in errs.items():
        say(f"[forward-long] logits {pair}: max_abs_err={err:.4g} "
            f"({'within' if err <= LONG_LOGIT_ATOL else 'over'} "
            f"{LONG_LOGIT_ATOL})")
    top2 = plain.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1])
    differ = kern.argmax(-1) != plain.argmax(-1)
    worst = margin[differ].max().item() if bool(differ.any()) else 0.0
    err = errs["kernel 12 vs blockwise"]
    say(f"[forward-long] kernel 12 vs blockwise: max_abs_err={err:.4g} "
        f"(tol {tol:.4g}: {LOGITS_ATOL_REL:g} of the largest |logit|), "
        f"argmax differs at {int(differ.sum())} of {S} positions (widest "
        f"margin there {worst:.4g}, limit {2 * LONG_LOGIT_ATOL})")
    need(err <= tol, "forward-long: logits disagree")
    need(worst <= 2 * LONG_LOGIT_ATOL,
         "forward-long: argmax differs away from a near tie")
    del kern, plain, dense

    def wall_ms(fn, n=3):
        with torch.no_grad():
            fn()
            _sync(torch)
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            _sync(torch)
        return (time.perf_counter() - t0) * 1e3 / n
    kern_ms = wall_ms(lambda: model(toks))
    plain_ms = wall_ms(lambda: model(toks, positions=pos))
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
        model(toks)
        _sync(torch)
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        t = (getattr(e, "self_cuda_time_total", 0) if t is None else t) / 1e3
        rows.append((t, e.count, e.key))
    dev_ms = sum(r[0] for r in rows)
    flash_ms = sum(r[0] for r in rows if "flash_attention" in r[2])
    say(f"[forward-long] {kern_ms:.2f} ms per forward on kernel 12, "
        f"{plain_ms:.2f} ms on the blockwise path")
    if dev_ms == 0:
        say("[forward-long] device time not measured (the profiler saw no "
            "device activity)")
    else:
        say(f"[forward-long] profiled forward: {dev_ms:.2f} ms of device "
            f"kernels, kernel 12 {flash_ms:.3f} ms ({flash_ms / dev_ms:.3f}"
            f" of it, {cfg.n_layers} launches)")
        for t, cnt, key in sorted(rows, reverse=True)[:6]:
            say(f"[forward-long]   {t:9.3f} ms  {cnt:4d} x  {key[:90]}")
    torch.cuda.empty_cache()
    return counts


def phase_serve_dit(torch) -> dict:
    """Full-width DiT-XL/2 (random weights from the seed, bf16, the full
    plan) served by ``DiffusionEngine``: ``DIT_REQUESTS`` at batch
    ``DIT_BATCH``, ``DIT_STEPS`` steps at guidance ``DIT_CFG_SCALE``
    (each step one evaluation of 2B = 8 rows).  Every request OK with
    finite latents; exactly 7 launches per block per evaluation (the 6
    plan launches and 1 of kernel 12); the engine's latents bitwise a
    direct ``sample()`` on the same noise, and a replay of the first batch
    with ``obs=Observability()`` bitwise too, its ``denoise_evals_total``
    and ``images_total`` the batch's; one evaluation within
    ``DIT_EPS_ATOL_REL`` of the largest |eps| of the plain path (the
    GEMMs' plain versions under ``kernel_mode(False)``, dense attention
    by explicit positions), which launches nothing.  Prints ms per
    evaluation, images/s and the profiled device share of an evaluation.
    Returns the launch counts of the served run."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.analysis import manifest
    from repro_torch.configs import get_dit_config
    from repro_torch.diffusion import DiffusionEngine, ImageRequest, sample
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.dit import DiTModel
    from repro_torch.obs import Observability
    from repro_torch.quant import QuantPlan, kernel_mode
    from repro_torch.serving import RequestStatus

    cfg = get_dit_config(DIT_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = DiTModel(cfg).init(SEED, device=DEVICE)
    engine = DiffusionEngine(model, batch_size=DIT_BATCH,
                             quant_plan=QuantPlan.full())
    _sync(torch)
    say(f"[serve-dit] {DIT_ARCH} ({cfg.n_layers} blocks, d {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.head_dim}, {cfg.tokens} tokens) drawn "
        f"and quantized (full plan) in {time.perf_counter() - t0:.1f} s, "
        f"device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.default_rng(SEED + 6)
    reqs = []
    for method, n in DIT_REQUESTS:
        reqs += [ImageRequest(uid=len(reqs) + i,
                              label=int(rng.integers(cfg.n_classes)),
                              num_steps=DIT_STEPS, cfg_scale=DIT_CFG_SCALE,
                              method=method, seed=SEED) for i in range(n)]
    for r in reqs:
        engine.submit(r)
    _sync(torch)
    reset_launch_counts()
    t0 = time.perf_counter()
    engine.run_until_done()
    _sync(torch)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    st = engine.stats
    evals = st.denoise_steps      # one stacked 2B evaluation a step
    need(all(r.status is RequestStatus.OK for r in reqs),
         f"serve-dit: requests not OK: {[r.status.value for r in reqs]}")
    shape = (cfg.in_channels, cfg.input_size, cfg.input_size)
    need(all(r.latents.shape == shape and np.isfinite(r.latents).all()
             for r in reqs), "serve-dit: latents of the wrong shape or "
         "non-finite")
    L = cfg.n_layers
    # the plan's launches from the manifest, kernel 12 (no site class)
    # once per block
    want = {name: 0 for name in SOURCES}
    for k, n in manifest.dit_step_launches(cfg).items():
        want[k] = n * evals
    want["flash_attention"] = L * evals
    say(f"[serve-dit] {len(reqs)} requests OK in {st.batches} batches of "
        f"{DIT_BATCH} ({evals} evaluations of {2 * DIT_BATCH} rows): "
        f"{wall:.2f} s, {st.images_out / wall:.3f} images/s, "
        f"{wall * 1e3 / evals:.2f} ms per evaluation in the engine")
    say(f"[serve-dit] launches {json.dumps(counts)}")
    need(counts == want, f"serve-dit: launch counts {counts} != {want}")
    per = sum(counts.values()) / (L * evals)
    say(f"[serve-dit] {per:g} launches per block per evaluation, "
        f"{counts['flash_attention'] / (L * evals):g} of them kernel 12")
    need(per == 7, f"serve-dit: {per} launches per block per evaluation")

    first = reqs[:DIT_BATCH]
    noise = torch.stack([engine._noise(r) for r in first])
    labels = torch.tensor([r.label for r in first], dtype=torch.int32,
                          device=DEVICE)
    direct = sample(model, labels, x_init=noise, num_steps=DIT_STEPS,
                    cfg_scale=DIT_CFG_SCALE).cpu().numpy()
    same = all(np.array_equal(direct[i], r.latents)
               for i, r in enumerate(first))
    say(f"[serve-dit] engine latents vs a direct sample(): "
        f"{'bitwise' if same else 'DIFFER'}")
    need(same, "serve-dit: the engine's latents are not its sample()'s")

    # the first batch again with obs: the same latents bitwise, the
    # counters the batch's
    def replay_of(batch):
        return [dataclasses.replace(r, status=RequestStatus.QUEUED,
                                    latents=None, error=None,
                                    finished_at=None) for r in batch]
    obs = Observability()
    watched = DiffusionEngine(model, batch_size=DIT_BATCH, obs=obs)
    replay = replay_of(first)
    for r in replay:
        watched.submit(r)
    watched.run_until_done()
    c = obs.snapshot()["metrics"]["counters"]
    got = (c["denoise_evals_total"]["series"][""],
           c["images_total"]["series"][""])
    same = all(np.array_equal(a.latents, b.latents)
               for a, b in zip(replay, first))
    say(f"[serve-dit] the first batch again with obs: latents "
        f"{'bitwise' if same else 'DIFFER'}; denoise_evals_total "
        f"{got[0]:g}, images_total {got[1]:g}")
    need(same, "serve-dit: obs changed the latents")
    need(got == (2 * DIT_STEPS * DIT_BATCH, DIT_BATCH)
         and watched.stats.denoise_steps == DIT_STEPS,
         f"serve-dit: obs counters {got} disagree with the batch")
    del watched

    # the first batch again, under degraded mode, with a fault hook that
    # plants a NaN in one request's latents
    def plant(phase, lat):
        lat = lat.copy()
        lat[1, 0, 0, 0] = np.nan
        return lat
    replay = replay_of(first)
    deg = DiffusionEngine(model, batch_size=DIT_BATCH, degraded=True,
                          fault_hook=plant)
    for r in replay:
        deg.submit(r)
    reset_launch_counts()
    deg.run_until_done()
    _sync(torch)
    dcounts, devals = launch_counts(), deg.stats.denoise_steps
    dwant = {name: 0 for name in SOURCES}
    dwant.update(cim_gemm_int8_fused_qin=6 * L * devals,
                 quantize_rows_int8=3 * L * devals,
                 cim_gemm_int8_fused=4 * L * devals,
                 flash_attention=L * devals, finite_screen=4 * L * devals)
    statuses = [r.status.value for r in replay]
    kept = all(np.array_equal(a.latents, b.latents)
               for a, b in zip(replay, first) if a.ok)
    say(f"[serve-dit] degraded batch with a NaN planted in request "
        f"{replay[1].uid}'s latents: {statuses}, the others' latents "
        f"{'bitwise the undegraded run' if kept else 'DIFFER'}; "
        f"{sum(dcounts.values()) / (L * devals):g} launches per block per "
        f"evaluation")
    need(statuses == ["ok", "failed"] + ["ok"] * (DIT_BATCH - 2) and kept,
         "serve-dit: the fault hook's NaN did not fail only its request")
    need(dcounts == dwant, f"serve-dit: degraded launch counts {dcounts} "
         f"!= {dwant}")
    del deg

    # one evaluation, the kernel path against the plain path
    x = torch.cat([noise, noise])
    tt = torch.full((2 * DIT_BATCH,), 500, dtype=torch.int32, device=DEVICE)
    yy = torch.cat([labels, torch.full_like(labels, cfg.null_class)])
    pos = torch.arange(cfg.tokens, device=DEVICE).expand(2 * DIT_BATCH,
                                                         cfg.tokens)
    C = cfg.in_channels
    with torch.no_grad():
        kern = model(x, tt, yy)[:, :C]
        _sync(torch)
        before = launch_counts()
        with kernel_mode(False):
            plain = model(x, tt, yy, positions=pos)[:, :C]
        _sync(torch)
        need(launch_counts() == before, "serve-dit: the plain path "
             "launched a kernel")
    err = (kern - plain).abs().max().item()
    top = plain.abs().max().item()
    say(f"[serve-dit] one evaluation (t 500, {2 * DIT_BATCH} rows), kernel "
        f"path vs plain path: eps max_abs_err={err:.4g}, "
        f"{err / top:.4g} of the largest |eps| {top:.4g} (tol "
        f"{DIT_EPS_ATOL_REL:g})")
    need(bool(torch.isfinite(kern).all()) and err <= DIT_EPS_ATOL_REL * top,
         "serve-dit: eps disagrees with the plain path")
    del kern, plain

    def evaluate():
        with torch.no_grad():
            model(x, tt, yy)
    evaluate()
    _sync(torch)
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        evaluate()
    _sync(torch)
    eval_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        evaluate()
        _sync(torch)
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        d = getattr(e, "self_device_time_total", None)
        d = (getattr(e, "self_cuda_time_total", 0) if d is None else d) / 1e3
        rows.append((d, e.count, e.key))
    dev_ms = sum(r[0] for r in rows)
    per_s = DIT_BATCH * 1e3 / (eval_ms * DIT_STEPS)
    say(f"[serve-dit] {eval_ms:.2f} ms per evaluation ({2 * DIT_BATCH} rows "
        f"x {cfg.tokens} tokens), {per_s:.3f} images/s at {DIT_STEPS} "
        f"guided steps")
    if dev_ms == 0:
        say("[serve-dit] device time not measured (the profiler saw no "
            "device activity)")
    else:
        say(f"[serve-dit] profiled evaluation: {dev_ms:.2f} ms of device "
            f"kernels (busy share {dev_ms / eval_ms:.3f}), "
            f"{sum(r[1] for r in rows)} kernel launches")
        for d, cnt, key in sorted(rows, reverse=True)[:8]:
            say(f"[serve-dit]   {d:8.3f} ms  {cnt:5d} x  {key[:90]}")
    say(f"[serve-dit] device memory peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _prefill_profile(torch, model, prompt, tag: str, share: str) -> None:
    """One batch-1 ``prefill_padded`` of ``prompt`` from a fresh cache:
    its wall time (no profiler, the median of 3) beside the device time
    the profiler attributes to kernels, split by kernel, and the share of
    the kernel whose name holds ``share``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    toks = torch.as_tensor(prompt, dtype=torch.long, device=DEVICE)[None]
    lengths = torch.tensor([len(prompt)], dtype=torch.int32, device=DEVICE)

    def run():
        caches = model.init_cache(1, 2048, kv_dtype="int8")
        with torch.no_grad():
            model.prefill_padded(toks, caches, lengths)
    run()
    _sync(torch)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        _sync(torch)
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        _sync(torch)
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        d = getattr(e, "self_device_time_total", None)
        d = (getattr(e, "self_cuda_time_total", 0) if d is None else d) / 1e3
        if d > 0:
            rows.append((d, e.count, e.key))
    dev_ms = sum(r[0] for r in rows)
    wall = statistics.median(walls)
    say(f"[{tag}] prefill of {len(prompt)} tokens: {wall:.2f} ms wall "
        f"(median of 3)")
    if dev_ms == 0:
        say(f"[{tag}] device time not measured (the profiler saw no device "
            f"activity)")
        return
    mine = sum(r[0] for r in rows if share in r[2])
    say(f"[{tag}] profiled prefill: {dev_ms:.2f} ms of device kernels (busy "
        f"share {dev_ms / wall:.3f}), {sum(r[1] for r in rows)} kernel "
        f"launches; {share} {mine:.3f} ms = {mine / dev_ms:.3f} of the "
        f"device time")
    for d, cnt, key in sorted(rows, reverse=True)[:10]:
        say(f"[{tag}]   {d:8.3f} ms  {cnt:5d} x  {key[:90]}")


def _check_direct_loops(torch, model, req, served: dict,
                        tag: str = "serve-zamba2",
                        engine_like: bool = False) -> None:
    """``req`` (served by the ring engine at 8 slots) against direct
    ``prefill_padded`` then ``decode_step`` loops on the same model, fed
    the engine's tokens: at the engine's batch shape (8 rows, the request
    and 7 copies of it) its logits must be bitwise the engine's at every
    step, so its greedy tokens are the engine's.  With ``engine_like``
    (a recurrent model without attention caches) the loop starts as the
    engine's slot does, from caches whose every leaf is zero (ROADMAP
    C.14), and prefills the request alone at batch 1 (into row 0, then
    copied to the other rows); the prefill of all 8 rows at once is
    printed beside it (the xLSTM's batched products round by batch
    count).  Otherwise it starts from ``init_cache``, prefills 8 rows,
    and also runs at batch 1, where the prefill
    must be bitwise, and each decode step's greedy token the engine's
    unless the step is a near tie (top-2 margin within the two paths'
    largest logit difference there), with every step's logits within
    ``LOGITS_ATOL_REL`` of the largest.  The Mamba-2 decode's product of
    the state with c (a batched product over the rows' heads) rounds by
    batch shape, so at batch 1 the logits move by a bf16 step or so once
    a rounding flips."""
    import numpy as np
    n = len(req.generated)
    served = np.stack([served[i] for i in range(n)])

    def loop(B, one=False):
        caches = model.init_cache(B, 2048, kv_dtype="int8")
        if engine_like:
            for c in caches:
                for v in c.values():
                    v.zero_()
        P = 1 if one else B
        toks = torch.as_tensor(req.prompt, dtype=torch.long,
                               device=DEVICE)[None].expand(P, -1)
        lengths = torch.full((P,), len(req.prompt), dtype=torch.int32,
                             device=DEVICE)
        with torch.no_grad():
            rows = [{k: v[:P] for k, v in c.items()} for c in caches]
            out = [model.prefill_padded(toks.contiguous(), rows,
                                        lengths)[0, -1]]
            for c in caches:
                for v in c.values():
                    v[P:] = v[:1]
            for step in range(1, n):
                nxt = torch.full((B, 1), req.generated[step - 1],
                                 dtype=torch.long, device=DEVICE)
                out.append(model.decode_step(nxt, caches)[0, -1])
        return torch.stack(out).float().cpu().numpy()

    same8 = loop(8, engine_like)
    bitwise = bool((same8 == served).all())
    start = "a zeroed cache" if engine_like else "init_cache"
    if engine_like:
        diff8 = np.abs(loop(8) - served).max()
        say(f"[{tag}] prefilling all 8 rows at once instead moves the "
            f"logits by {diff8:.4g} at most")
        start += ", prefilled at batch 1 as the engine does,"
    say(f"[{tag}] request of {len(req.prompt)} tokens: a direct loop from "
        f"{start} at the engine's 8 rows gives the engine's logits "
        f"{'bitwise at every step' if bitwise else 'NOT bitwise'} (largest "
        f"difference {np.abs(same8 - served).max():.4g}), greedy tokens "
        f"{'equal' if list(same8.argmax(-1)) == req.generated else 'DIFFER'}")
    need(bitwise and list(same8.argmax(-1)) == req.generated,
         f"{tag}: the engine is not its direct loop at its batch")
    if engine_like:
        return
    one = loop(1)
    diff = np.abs(one - served).max(-1)
    top2 = np.sort(one, -1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    agree = one.argmax(-1) == np.asarray(req.generated)
    ties = ~agree & (margin <= diff)
    exact = int((diff == 0).sum())
    say(f"[serve-zamba2] at batch 1: prefill logits "
        f"{'bitwise' if diff[0] == 0 else 'DIFFER'}; {exact} of {n} steps "
        f"bitwise, largest logit difference {diff.max():.4g} "
        f"({diff.max() / np.abs(served).max():.3g} of the largest); greedy "
        f"tokens equal at {int(agree.sum())} of {n} steps, the others near "
        f"ties: {int(ties.sum())}")
    need(diff[0] == 0 and bool((agree | ties).all())
         and diff.max() <= LOGITS_ATOL_REL * np.abs(served).max(),
         "serve-zamba2: the engine disagrees with a direct batch-1 loop")


def phase_serve_zamba2(torch) -> dict:
    """Full-width zamba2-1.2b (random weights from the seed, 38 layers:
    32 Mamba-2 and 6 attention + dense-geglu, bf16, the full plan, int8
    KV) on the ring engine: 8 slots of 2048, bucket 64, ``ZAMBA_PROMPTS``
    with 32 new tokens each.  Every request OK; launches exact: 6 per
    attention layer per decode step, none on a Mamba-2 layer, kernel 13
    once per Mamba-2 layer per prefill.  The 1984-token request (a bucket
    multiple, so the engine pads nothing) against direct
    ``prefill_padded`` then ``decode_step`` loops
    (``_check_direct_loops``); off the bucket the engine's pad tokens
    enter the Mamba-2 state (ROADMAP C.11), so only that request is
    compared.  One prefill held against the plain
    path (``kernel_mode(False)``: the GEMMs' and the scan's plain
    versions) on the logits.  Prints ms per decode step, tok/s, the
    1984-token prefill's wall time and its profiled device time by
    kernel.  Returns the launch counts of the served run."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.quant import QuantPlan, kernel_mode
    from repro_torch.serving import Request, ServingEngine

    cfg = get_config(ZAMBA_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg).init(SEED, device=DEVICE)
    _sync(torch)
    n_params = sum(p.numel() for p in model.parameters())
    specs = cfg.layer_specs()
    n_mamba = sum(m == "mamba2" for m, _ in specs)
    n_attn = len(specs) - n_mamba
    say(f"[serve-zamba2] {ZAMBA_ARCH} init: {n_params / 1e9:.3f} B "
        f"parameters in bf16 ({n_mamba} Mamba-2 layers, {n_attn} attention "
        f"layers), {time.perf_counter() - t0:.1f} s")
    engine = ServingEngine(model, n_slots=8, max_len=2048,
                           prefill_bucket=64, quant_plan=QuantPlan.full())
    _sync(torch)
    say(f"[serve-zamba2] quantized (full plan), device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    prompts = _prompts(cfg, ZAMBA_PROMPTS, SEED + 7)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]
    served_logits = {}            # the compared request's, by step
    sample = engine._sample

    def recording(req, logits, step):
        if req.uid == 0:
            served_logits[step] = logits
        return sample(req, logits, step)
    engine._sample = recording
    counts, wall, step_ms = _serve(torch, engine, reqs, "prefills")
    st = engine.stats
    _check_served(cfg, reqs, NEW_TOKENS)
    want = expected_launches(cfg, st.decode_steps,
                             st.decode_steps + st.prefills,
                             kv_len=engine._obs_kv_slots())
    say(f"[serve-zamba2] {len(reqs)} requests OK (prompts "
        f"{ZAMBA_PROMPTS}): {st.tokens_out} decode tokens + {st.prefills} "
        f"prefills in {wall:.2f} s "
        f"({(st.tokens_out + st.prefills) / wall:.1f} tok/s), "
        f"{st.decode_steps} decode steps, median "
        f"{statistics.median(step_ms):.2f} ms per decode step")
    say(f"[serve-zamba2] launches {json.dumps(counts)}")
    need(counts == want, f"serve-zamba2: launch counts {counts} != {want}")
    per = launches_per_decode_step(cfg, counts, st.decode_steps,
                                   st.decode_steps + st.prefills)
    say(f"[serve-zamba2] {per:g} launches per attention layer per decode "
        f"step, 0 per Mamba-2 layer; kernel 13 "
        f"{counts['ssd_scan'] / (n_mamba * st.prefills):g} per Mamba-2 "
        f"layer per prefill")
    need(per == 6, f"serve-zamba2: {per} launches per attention layer per "
         f"decode step, not 6")
    need(counts["ssd_scan"] == n_mamba * st.prefills,
         "serve-zamba2: kernel 13 not once per Mamba-2 layer per prefill")

    # the bucket-multiple request against direct prefill + decode loops
    first = reqs[0]
    need(len(first.prompt) % engine.bucket == 0,
         "serve-zamba2: the compared prompt is not a bucket multiple")
    _check_direct_loops(torch, model, first, served_logits)
    toks = torch.as_tensor(first.prompt, dtype=torch.long,
                           device=DEVICE)[None]
    lengths = torch.tensor([len(first.prompt)], dtype=torch.int32,
                           device=DEVICE)
    with torch.no_grad():
        # the kernel path against the plain path on one prefill
        logits = model.prefill_padded(
            toks, model.init_cache(1, 2048, kv_dtype="int8"), lengths)
        with kernel_mode(False):
            plain = model.prefill_padded(
                toks, model.init_cache(1, 2048, kv_dtype="int8"), lengths)
    err = (logits - plain).abs().max().item()
    tol = LOGITS_ATOL_REL * plain.abs().max().item()
    say(f"[serve-zamba2] {len(first.prompt)}-token prefill logits, kernel "
        f"path vs plain path: max_abs_err={err:.4g} (tol {tol:.4g}), argmax "
        f"{'equal' if int(plain.argmax()) == int(logits.argmax()) else 'DIFFER'}")
    need(bool(torch.isfinite(logits).all()) and err <= tol,
         "serve-zamba2: kernel path disagrees with plain path")
    del logits, plain
    _prefill_profile(torch, model, first.prompt, "serve-zamba2",
                     "ssd_scan")
    say(f"[serve-zamba2] device memory peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# the attention + dense-FFN family beyond gemma-2b
# ---------------------------------------------------------------------------
def _draw_quantized(torch, cfg, tag: str):
    """``Model(cfg)`` on the card with ``Model.init(SEED)``'s weights, drawn
    and quantized under the full plan one block at a time: the card holds
    the bf16 (and the quantizer's f32) copy of one block at a time, never
    of the whole stack (command-r-plus-104b's gated weight alone is 1.66
    GB in f32)."""
    from types import SimpleNamespace
    from repro_torch.models import Model
    from repro_torch.quant import QuantPlan
    from repro_torch.quant.plan import apply_plan
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg)
    layers = model.layers
    model.layers = torch.nn.ModuleList()
    model.to_empty(device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    model.init_outer(gen)
    n_params = sum(p.numel() for p in model.parameters())
    for block in layers:
        block.to_empty(device=DEVICE)
        n_params += sum(p.numel() for p in block.parameters())
        block.init_(gen)
        apply_plan(SimpleNamespace(layers=[block]), QuantPlan.full())
    model.layers = layers
    _sync(torch)
    gib = 2 ** 30
    say(f"[{tag}] {cfg.name}: {n_params / 1e9:.3f} B parameters ({cfg.n_layers}"
        f" layers, d {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} "
        f"KV of {cfg.head_dim}, d_ff {cfg.d_ff} {cfg.activation}, "
        f"{cfg.norm}{', qk_norm' if cfg.qk_norm else ''}) drawn and "
        f"quantized block by block in {time.perf_counter() - t0:.1f} s: "
        f"device memory {torch.cuda.memory_allocated() / gib:.2f} GiB, "
        f"peak {torch.cuda.max_memory_allocated() / gib:.2f} GiB")
    return model


def _free(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


def _served_run(torch, tag, engine, reqs, prefill_counter,
                new_tokens=NEW_TOKENS) -> dict:
    """Serve ``reqs`` on ``engine`` and pin its launches exactly: every
    request OK, the counts ``expected_launches`` gives, and per layer per
    decode step ``launches_per_layer_step``.  Returns the counts."""
    cfg = engine.model.cfg
    counts, wall, step_ms = _serve(torch, engine, reqs, prefill_counter)
    st = engine.stats
    _check_served(cfg, reqs, new_tokens)
    forwards = st.decode_steps + getattr(st, prefill_counter)
    walk = dict(kv_len=engine._obs_kv_slots(), paged=hasattr(engine, "paged"))
    want = expected_launches(cfg, st.decode_steps, forwards, **walk)
    say(f"[{tag}] {len(reqs)} requests OK (prompts "
        f"{[len(r.prompt) for r in reqs]}): {st.tokens_out} decode tokens + "
        f"{st.prefills} prefills ({getattr(st, prefill_counter)} "
        f"{prefill_counter.replace('_', ' ')}) in {wall:.2f} s "
        f"({(st.tokens_out + st.prefills) / wall:.1f} tok/s), "
        f"{st.decode_steps} decode steps, median "
        f"{statistics.median(step_ms):.2f} ms per decode-only step")
    say(f"[{tag}] launches {json.dumps(counts)}")
    need(counts == want, f"{tag}: launch counts {counts} != {want}")
    per = launches_per_layer_step(cfg, **walk)
    say(f"[{tag}] launches per layer per decode step {json.dumps(per)} "
        f"(mean {launches_per_decode_step(cfg, counts, st.decode_steps, forwards):g})")
    return counts


def _held(tag, what, kern, plain) -> float:
    """Kernel-path logits against plain-path logits: finite, within
    ``LOGITS_ATOL_REL`` of the plain path's largest |logit|."""
    err = (kern - plain).abs().max().item()
    tol = LOGITS_ATOL_REL * plain.abs().max().item()
    same = (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()
    say(f"[{tag}] {what}: logits kernel vs plain max_abs_err={err:.4g} "
        f"(tol {tol:.4g}), argmax agreement {same:.3f}")
    need(bool(kern.isfinite().all()) and err <= tol,
         f"{tag}: {what}: the kernel path disagrees with the plain path")
    return err


class FlashModes:
    """Counts kernel 12's launches by mask while active: ``sliding``
    (a window), ``prefix`` (prefix_len > 0), ``causal``, ``full``.  The
    attention layer's handle on the kernel module (``models.attention.
    _fa``) is pointed at a recording stand-in; the kernel module itself is
    left alone, since its wrapper counts launches on its own name."""

    def __init__(self):
        from types import SimpleNamespace
        from repro_torch.models import attention
        self.mod, self.fa = attention, attention._fa
        self.modes = {"causal": 0, "sliding": 0, "prefix": 0, "full": 0}

        def counted(q, k, v, causal=True, window=None, **kw):
            mode = ("full" if not causal else "sliding" if window
                    else "prefix" if kw.get("prefix_len") else "causal")
            self.modes[mode] += 1
            return self.fa.flash_attention(q, k, v, causal, window, **kw)
        self.stand_in = SimpleNamespace(flash_attention=counted)

    def __enter__(self):
        self.mod._fa = self.stand_in
        return self

    def __exit__(self, *exc):
        self.mod._fa = self.fa


class RoutesRecorder:
    """Keeps, for every MoE layer of every forward while active
    (``models.moe.route`` wrapped), each token's routing [B, S, K]: its
    top-k expert ids, sorted, an id e written -1 - e where the entry was
    dropped at the expert's capacity."""

    def __init__(self, torch):
        from repro_torch.models import moe
        self.torch, self.mod, self.fn, self.ids = torch, moe, moe.route, []

    def __enter__(self):
        def record(router, x, cfg):
            r = self.fn(router, x, cfg)
            kept = self.torch.zeros_like(r.keep).scatter_(1, r.order,
                                                          r.keep)
            ids = r.expert_ids
            sig = self.torch.where(kept.reshape(ids.shape), ids, -1 - ids)
            self.ids.append(sig.sort(-1).values)
            return r
        self.mod.route = record
        return self

    def __exit__(self, *exc):
        self.mod.route = self.fn


def _forward_vs_plain(torch, tag, model, S, want_modes, **inputs) -> dict:
    """One cacheless forward of S positions with the model's own positions
    (kernel 12 on every layer, counted by mask) against the same forward
    given explicit positions (the plain blockwise path).  In an MoE model
    the two attentions' roundings can flip a near tie of the router, and
    a token routed to another expert (or dropped at an expert's capacity
    where it was kept) is another function: the logits are then held on
    the tokens whose every MoE layer routed them alike in both forwards,
    which must be most of them (deepseek-v3 at full width on an H100:
    3336 of 4096; the int8 row codes of three dense layers carry the
    attentions' rounding differences to the router's 256-way top-8,
    whose 8th and 9th logits lie close).  Returns the kernel path's
    launch counts."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    pos = torch.arange(S, device=DEVICE)[None]
    with torch.no_grad(), FlashModes() as fm, \
            RoutesRecorder(torch) as routes:
        _sync(torch)
        reset_launch_counts()
        t0 = time.perf_counter()
        kern = model(**inputs)
        _sync(torch)
        kern_ms = (time.perf_counter() - t0) * 1e3
        counts = launch_counts()
        t0 = time.perf_counter()
        plain = model(positions=pos, **inputs)
        _sync(torch)
        plain_ms = (time.perf_counter() - t0) * 1e3
    modes = {k: v for k, v in fm.modes.items() if v}
    say(f"[{tag}] cacheless forward of {S} positions: kernel 12 "
        f"{counts['flash_attention']} launches by mask {json.dumps(modes)} "
        f"(want {json.dumps(want_modes)}); {kern_ms:.1f} ms on kernel 12, "
        f"{plain_ms:.1f} ms on the blockwise path (first calls)")
    need(modes == want_modes and counts["flash_attention"]
         == sum(want_modes.values()), f"{tag}: kernel 12 launches {modes}")
    need(kern.shape == (1, S, model.cfg.vocab), f"{tag}: logits shape")
    if routes.ids:
        n = len(routes.ids) // 2
        same = torch.ones(S, dtype=torch.bool, device=kern.device)
        for a, b in zip(routes.ids[:n], routes.ids[n:]):
            same &= (a == b).all(-1)[0]
        err_all = (kern - plain).abs().max().item()
        say(f"[{tag}] routing: {int(same.sum())} of {S} tokens take the "
            f"same experts in every MoE layer on both paths; over all "
            f"tokens the logits differ by {err_all:.4g} at most")
        need(int(same.sum()) > S // 2,
             f"{tag}: the two paths route {int((~same).sum())} tokens "
             f"apart")
        kern, plain = kern[:, same], plain[:, same]
    _held(tag, f"cacheless forward of {S} positions", kern, plain)
    del kern, plain
    torch.cuda.empty_cache()
    return counts


def _ring_vs_plain(torch, tag, model, B, max_len, steps, prompt, seed,
                   feed=None):
    """A prefill into a fresh int8 ring cache then ``steps`` decode steps,
    on the kernel path and on the plain path (``kernel_mode(False)``):
    the plain path is fed the kernel path's greedy tokens (or the same
    ``feed`` inputs), and every step's logits are held.  ``prompt`` is a
    dict of ``prefill_padded``'s inputs (tokens, lengths and
    embeddings)."""
    from repro_torch.quant import kernel_mode
    toks = prompt.pop("tokens", None)

    def run(plain, fed):
        caches = model.init_cache(B, max_len, kv_dtype="int8")
        out, nxt = [], []
        with torch.no_grad(), kernel_mode(False if plain else None):
            a = model.prefill_padded(toks, caches, **prompt)
            out.append(a)
            for i in range(steps):
                if feed is not None:
                    a = model.decode_step(None, caches,
                                          frame_embeddings=feed[i])
                else:
                    tok = a.argmax(-1) if fed is None else fed[i]
                    nxt.append(tok)
                    a = model.decode_step(tok, caches)
                out.append(a)
        return torch.cat(out, dim=1), nxt
    kern, fed = run(False, None)
    plain, _ = run(True, fed or None)
    need(kern.shape == (B, steps + 1, model.cfg.vocab), f"{tag}: shape")
    return _held(tag, f"prefill + {steps} decode steps", kern, plain)


def phase_serve_gemma3(torch) -> tuple[dict, dict]:
    """Full-width gemma3-4b (34 layers, 29 sliding-window of 1024 and 5
    global, qk_norm, GQA 8 on 4 of 256) under the full plan, int8 KV: the
    ring engine at 8 slots of ``GEMMA3_MAX_LEN`` (local layers hold 1024
    slots; the global layers' walk takes 2 splits), then the paged
    engine over the same requests, each with exact launches; one 1500-
    token prefill (past the window) + decode steps against the plain
    path; a cacheless forward of 4096 tokens, kernel 12 exactly 29 times
    sliding and 5 causal.  Returns (served launch counts, kernel 12's
    cacheless counts)."""
    from repro_torch.configs import get_config
    from repro_torch.quant import QuantPlan
    from repro_torch.serving import (PagedServingEngine, Request,
                                     ServingEngine)
    tag = "serve-gemma3"
    cfg = get_config(GEMMA3_ARCH)
    model = _draw_quantized(torch, cfg, tag)
    # a global layer's ring of GEMMA3_MAX_LEN slots takes the split walk
    # above 2048 slots; a local layer's 1024 slots one walk (the
    # manifest's layer_launches; ROADMAP C.15)
    runs = []
    for name, cls, kw, prefill_counter in (
            ("ring", ServingEngine, {}, "prefills"),
            ("paged", PagedServingEngine,
             dict(block_size=PAGED_BLOCK, prefill_chunk=GEMMA3_CHUNK),
             "prefill_chunks")):
        engine = cls(model, n_slots=8, max_len=GEMMA3_MAX_LEN,
                     prefill_bucket=64, quant_plan=QuantPlan.full(), **kw)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=NEW_TOKENS)
                for i, p in enumerate(_prompts(cfg, GEMMA3_PROMPTS,
                                               SEED + 8))]
        runs.append(_served_run(torch, f"{tag} {name}", engine, reqs,
                                prefill_counter))
        if name == "paged":
            alloc = engine.paged.allocator
            alloc.check()
            need(alloc.n_used == 0, f"{tag}: {alloc.n_used} blocks held")
        else:
            tokens = [r.generated for r in reqs]
        del engine
        _free(torch)
    paged_tokens = [r.generated for r in reqs]
    same = sum(a == b for a, b in zip(tokens, paged_tokens))
    say(f"[{tag}] paged streams equal to the ring's for {same} of "
        f"{len(tokens)} requests (the paged prefill runs in chunks of "
        f"{GEMMA3_CHUNK}, the ring's in one)")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    toks = torch.randint(0, cfg.vocab, (1, 1500), device=DEVICE,
                         generator=gen)
    _ring_vs_plain(torch, tag, model, 1, 2048, 4, dict(
        tokens=toks, lengths=torch.tensor([1500], dtype=torch.int32,
                                          device=DEVICE)), SEED)
    toks = torch.randint(0, cfg.vocab, (1, GEMMA3_LONG_S), device=DEVICE,
                         generator=gen)
    n_local = sum(m == "attn_local" for m, _ in cfg.layer_specs())
    fwd = _forward_vs_plain(torch, tag, model, GEMMA3_LONG_S,
                            {"causal": cfg.n_layers - n_local,
                             "sliding": n_local}, tokens=toks)
    del model
    _free(torch)
    return {k: sum(r[k] for r in runs) for k in runs[0]}, fwd


def phase_serve_paligemma(torch) -> tuple[dict, dict]:
    """Full-width paligemma-3b (18 layers of gemma-2b's shape under the
    ``"prefix"`` mask, frontend_proj [1152, 2048]) under the full plan:
    the ring engine on text prompts (prefix_len = frontend_len = 256:
    text positions below 256 attend both ways, as in the reference), 7
    launches per layer per decode step; a direct prefill of 256 seeded
    patch embeddings + ``PALI_TEXT`` tokens into an int8 ring and
    ``PALI_STEPS`` decode steps against the plain path; a cacheless
    forward of 256 patches + ``PALI_LONG_TEXT`` tokens, kernel 12's prefix
    mode exactly 18 times, against the plain path."""
    from repro_torch.configs import get_config
    from repro_torch.quant import QuantPlan
    from repro_torch.serving import Request, ServingEngine
    tag = "serve-paligemma"
    cfg = get_config(PALI_ARCH)
    model = _draw_quantized(torch, cfg, tag)
    engine = ServingEngine(model, n_slots=8, max_len=1024, prefill_bucket=64,
                           quant_plan=QuantPlan.full())
    reqs = [Request(uid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(_prompts(cfg, PALI_PROMPTS, SEED + 10))]
    counts = _served_run(torch, tag, engine, reqs, "prefills")
    del engine
    _free(torch)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    patches = torch.randn((1, cfg.frontend_len, cfg.frontend_dim),
                          device=DEVICE, generator=gen)
    toks = torch.randint(0, cfg.vocab, (1, PALI_TEXT), device=DEVICE,
                         generator=gen)
    _ring_vs_plain(torch, f"{tag} patches", model, 1, 1024, PALI_STEPS, dict(
        tokens=toks, patch_embeddings=patches,
        lengths=torch.tensor([PALI_TEXT], dtype=torch.int32,
                             device=DEVICE)), SEED)
    toks = torch.randint(0, cfg.vocab, (1, PALI_LONG_TEXT), device=DEVICE,
                         generator=gen)
    fwd = _forward_vs_plain(torch, tag, model,
                            cfg.frontend_len + PALI_LONG_TEXT,
                            {"prefix": cfg.n_layers}, tokens=toks,
                            patch_embeddings=patches)
    del model
    _free(torch)
    return counts, fwd


def phase_musicgen(torch) -> dict:
    """Full-width musicgen-medium (48 layers, MHA 24 x 64, layernorm, an
    ungated gelu MLP of 6144) under the full plan, int8 KV: a ring
    prefill of ``MUSIC_FRAMES`` seeded frame embeddings in 2 rows, then
    ``MUSIC_STEPS`` decode steps each fed seeded frames; launches exact
    (6 per layer per decode step), logits against the plain path."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    tag = "musicgen"
    cfg = get_config(MUSIC_ARCH)
    model = _draw_quantized(torch, cfg, tag)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    B = 2
    frames = torch.randn((B, MUSIC_FRAMES, cfg.d_model), device=DEVICE,
                         generator=gen)
    feed = [torch.randn((B, 1, cfg.d_model), device=DEVICE, generator=gen)
            for _ in range(MUSIC_STEPS)]
    lengths = torch.tensor([MUSIC_FRAMES, MUSIC_FRAMES - 100],
                           dtype=torch.int32, device=DEVICE)
    caches = model.init_cache(B, 1024, kv_dtype="int8")
    step_ms = []
    with torch.no_grad():
        _sync(torch)
        reset_launch_counts()
        model.prefill_padded(None, caches, lengths, frame_embeddings=frames)
        for f in feed:
            t0 = time.perf_counter()
            model.decode_step(None, caches, frame_embeddings=f)
            _sync(torch)
            step_ms.append((time.perf_counter() - t0) * 1e3)
        counts = launch_counts()
    want = expected_launches(cfg, MUSIC_STEPS, MUSIC_STEPS + 1)
    say(f"[{tag}] {B} rows: prefill of {MUSIC_FRAMES} frames, "
        f"{MUSIC_STEPS} decode steps, median "
        f"{statistics.median(step_ms):.2f} ms per decode step; launches "
        f"{json.dumps(counts)}")
    need(counts == want, f"{tag}: launch counts {counts} != {want}")
    per = launches_per_layer_step(cfg)
    say(f"[{tag}] launches per layer per decode step {json.dumps(per)}")
    need(per == {"attn": 6}, f"{tag}: {per} per layer per decode step")
    _ring_vs_plain(torch, tag, model, B, 1024, MUSIC_STEPS, dict(
        frame_embeddings=frames, lengths=lengths), SEED, feed=feed)
    del model, caches
    _free(torch)
    return counts


def phase_serve_deep(torch, arch: str) -> dict:
    """Full width, depth cut to ``DEEP_LAYERS`` layers (deepseek-67b's 95 and
    command-r-plus-104b's 64 cannot be drawn on one card): the ring
    engine at 8 slots of 1024, 8 requests; QKV and out-projection at K
    8192 / 12288 above ``MAX_FUSED_QUANT_K`` take kernel 1 then kernel 3:
    9 launches per layer per decode step; one ring prefill + decode step
    against the plain path."""
    from repro_torch.configs import get_config
    from repro_torch.quant import QuantPlan
    from repro_torch.serving import Request, ServingEngine
    tag = f"serve-{arch.split('-')[0]}"
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=DEEP_LAYERS)
    say(f"[{tag}] {arch} at full width, depth cut to {DEEP_LAYERS} of "
        f"{full.n_layers} layers ({full.param_count() / 1e9:.1f} B "
        f"parameters uncut)")
    model = _draw_quantized(torch, cfg, tag)
    engine = ServingEngine(model, n_slots=8, max_len=1024, prefill_bucket=64,
                           quant_plan=QuantPlan.full())
    reqs = [Request(uid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(_prompts(cfg, SERVE_LENGTHS, SEED + 13))]
    counts = _served_run(torch, tag, engine, reqs, "prefills")
    per = launches_per_layer_step(cfg)
    need(per == {"attn": 9}, f"{tag}: {per} per layer per decode step")
    del engine
    _free(torch)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 14)
    toks = torch.randint(0, cfg.vocab, (4, 64), device=DEVICE, generator=gen)
    _ring_vs_plain(torch, tag, model, 4, 1024, 1, dict(
        tokens=toks, lengths=torch.tensor([64, 61, 32, 1], dtype=torch.int32,
                                          device=DEVICE)), SEED)
    del model
    _free(torch)
    return counts


def phase_serve_v3(torch) -> tuple[dict, dict, dict]:
    """deepseek-v3-671b at full width (d 7168, 128 heads of MLA: q_lora
    1536, kv_lora 512, nope 128, rope 64, v 128; 256 experts top-8 of
    2048, one shared of 2048; the untied head of 129280), depth cut to
    ``V3_LAYERS`` (its 3 dense layers of d_ff 18432, then 1 MoE layer):
    671 B parameters cannot be drawn on one card.  Drawn and quantized
    block by block under the full plan (the expert stacks over chunks of
    experts), the draw's peak printed.  The ring engine at 8 slots of
    1024 on 8 requests of ``SERVE_LENGTHS``: launches exact, 4 per dense
    layer and 6 per MoE layer per decode step (MLA launches none: its
    projections and absorbed attention are bf16 torch products); one ring
    prefill + decode step against the plain path; a cacheless forward of
    ``V3_FORWARD_S`` tokens: kernel 12 exactly once a layer, causal, at
    D_qk 192 with v padded to 192, logits within 5% of the blockwise
    path.  A decode step is profiled (``phase_profile``).  Returns
    (served launch counts, kernel 12's cacheless counts, the expert
    counts of a served decode step's MoE layer)."""
    from repro_torch.configs import get_config
    from repro_torch.quant import QuantPlan
    from repro_torch.serving import Request, ServingEngine
    tag = "serve-deepseek-v3"
    full, cfg = get_config(V3_ARCH), _v3_config()
    say(f"[{tag}] {V3_ARCH} at full width, depth cut to {V3_LAYERS} of "
        f"{full.n_layers} layers ({cfg.moe.first_k_dense} dense, "
        f"{V3_LAYERS - cfg.moe.first_k_dense} MoE of "
        f"{cfg.moe.n_routed_experts} experts top-{cfg.moe.top_k}; "
        f"{full.param_count() / 1e9:.1f} B parameters uncut)")
    model = _draw_quantized(torch, cfg, tag)
    engine = ServingEngine(model, n_slots=8, max_len=1024, prefill_bucket=64,
                           quant_plan=QuantPlan.full())
    reqs = [Request(uid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(_prompts(cfg, SERVE_LENGTHS, SEED + 16))]
    with CountsRecorder() as rec:
        counts = _served_run(torch, tag, engine, reqs, "prefills")
    per = launches_per_layer_step(cfg, by_ffn=True)
    say(f"[{tag}] launches per layer per decode step by kind "
        f"{json.dumps(per)} (MLA itself: none)")
    need(per == {"mla/dense": 4, "mla/moe": 6},
         f"{tag}: {per} per layer per decode step")
    steps = torch.stack(rec.decode)
    active = (steps > 0).sum(-1).float()
    say(f"[{tag}] active experts per decode step: mean "
        f"{active.mean().item():.2f} of {cfg.moe.n_routed_experts} (min "
        f"{active.min().item():g}, max {active.max().item():g}); capacity "
        f"1 row an expert a batch row")
    step_counts = steps[len(steps) // 2].clone()
    del engine
    _free(torch)
    phase_profile(torch, model, SEED, "profile-deepseek-v3")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 17)
    toks = torch.randint(0, cfg.vocab, (4, 64), device=DEVICE, generator=gen)
    _ring_vs_plain(torch, tag, model, 4, 1024, 1, dict(
        tokens=toks, lengths=torch.tensor([64, 61, 32, 1], dtype=torch.int32,
                                          device=DEVICE)), SEED)
    toks = torch.randint(0, cfg.vocab, (1, V3_FORWARD_S), device=DEVICE,
                         generator=gen)
    fwd = _forward_vs_plain(torch, tag, model, V3_FORWARD_S,
                            {"causal": cfg.n_layers}, tokens=toks)
    say(f"[{tag}] device memory peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model
    _free(torch)
    return counts, fwd, step_counts


def phase_serve_xlstm(torch) -> dict:
    """xlstm-350m at full width, nothing cut (24 layers: 21 mLSTM with
    inner width 2048 in 4 heads of 512, chunk 64, and 3 sLSTM with heads
    of 256 and a geglu FFN of 1365; vocab 50304, untied): the ring engine
    at 8 slots of 2048, bucket 64, 8 requests of ``XLSTM_PROMPTS`` with
    32 new tokens each; every request OK and exactly 0 plan launches (no
    plan kind covers an xLSTM block, as in the reference).  The
    1984-token request (a bucket multiple: the engine pads nothing)
    against a direct prefill + decode loop at the engine's 8 rows from a
    zeroed cache (the engine's slot reset, ROADMAP C.14), prefilled at
    batch 1 as the engine prefills: logits bitwise at every step; its prefill's logits within 5% of the plain path's
    (``kernel_mode(False)``).  Prints ms per decode step and the
    1984-token prefill's wall time, and profiles a decode step
    (``phase_profile``).  Returns the served launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.quant import QuantPlan, kernel_mode
    from repro_torch.serving import Request, ServingEngine
    tag = "serve-xlstm"
    cfg = get_config(XLSTM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg).init(SEED, device=DEVICE)
    _sync(torch)
    n_params = sum(p.numel() for p in model.parameters())
    specs = cfg.layer_specs()
    say(f"[{tag}] {XLSTM_ARCH} init: {n_params / 1e9:.3f} B parameters "
        f"({specs.count(('mlstm', 'none'))} mLSTM, "
        f"{specs.count(('slstm', 'none'))} sLSTM layers), "
        f"{time.perf_counter() - t0:.1f} s")
    engine = ServingEngine(model, n_slots=8, max_len=2048,
                           prefill_bucket=64, quant_plan=QuantPlan.full())
    reqs = [Request(uid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(_prompts(cfg, XLSTM_PROMPTS, SEED + 18))]
    served_logits = {}
    sample = engine._sample

    def recording(req, logits, step):
        if req.uid == 0:
            served_logits[step] = logits
        return sample(req, logits, step)
    engine._sample = recording
    counts, wall, step_ms = _serve(torch, engine, reqs, "prefills")
    st = engine.stats
    _check_served(cfg, reqs, NEW_TOKENS)
    want = expected_launches(cfg, st.decode_steps,
                             st.decode_steps + st.prefills)
    say(f"[{tag}] {len(reqs)} requests OK (prompts {XLSTM_PROMPTS}): "
        f"{st.tokens_out} decode tokens + {st.prefills} prefills in "
        f"{wall:.2f} s ({(st.tokens_out + st.prefills) / wall:.1f} tok/s), "
        f"{st.decode_steps} decode steps, median "
        f"{statistics.median(step_ms):.2f} ms per decode step")
    say(f"[{tag}] launches {json.dumps(counts)}")
    need(counts == want and not any(counts.values()),
         f"{tag}: launch counts {counts} != {want} (none)")
    first = reqs[0]
    need(len(first.prompt) % engine.bucket == 0,
         f"{tag}: the compared prompt is not a bucket multiple")
    _check_direct_loops(torch, model, first, served_logits, tag,
                        engine_like=True)
    toks = torch.as_tensor(first.prompt, dtype=torch.long,
                           device=DEVICE)[None]
    lengths = torch.tensor([len(first.prompt)], dtype=torch.int32,
                           device=DEVICE)
    with torch.no_grad():
        _sync(torch)
        t0 = time.perf_counter()
        logits = model.prefill_padded(toks, model.init_cache(1, 2048),
                                      lengths)
        _sync(torch)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        with kernel_mode(False):
            plain = model.prefill_padded(toks, model.init_cache(1, 2048),
                                         lengths)
    say(f"[{tag}] {len(first.prompt)}-token prefill (batch 1): "
        f"{prefill_ms:.1f} ms wall")
    _held(tag, f"{len(first.prompt)}-token prefill", logits, plain)
    del logits, plain
    phase_profile(torch, model, SEED, "profile-xlstm")
    say(f"[{tag}] device memory peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del engine, model
    _free(torch)
    return counts


def _event_ms(torch, fn, reps: int = 3) -> float:
    """Median ms of ``fn`` run eagerly, timed with CUDA events (a call
    too large to capture in a graph beside the others)."""
    fn()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples)


def times_flash_mla(torch, card: str) -> None:
    """Kernel 12 at MLA's cacheless forward (``MLA_FLASH``: B 1, S 4096,
    128 heads, q and k at 192, v at 128 padded with zeros to 192, causal),
    as the model launches it: held against its plain version (on 16 heads
    at a time, the scores of all 128 being 8.6 GB) within 2^-7 + 2^-7 x
    row max on the first 128 columns, its padded columns exactly 0; timed
    beside SDPA on the unpadded v (E 192, Ev 128).  The bound counts the
    reference's work, not the padded one: 2 (192 + 128) per visible pair
    and head, at the bf16 peak."""
    from repro_torch.kernels import flash_attention as fa
    B, S, H, D, Dv = MLA_FLASH
    gen = torch.Generator(device=DEVICE).manual_seed(19)
    q, k, v = _flash_inputs(torch, gen, B, S, S, H, H, D, "bf16")
    v = v[..., :Dv].contiguous()
    vp = torch.nn.functional.pad(v, (0, D - Dv))
    out = fa.flash_attention(q, k, vp)
    tol, err = FLASH_TOL["bf16"], 0.0
    for h in range(0, H, 16):
        heads = slice(h, h + 16)
        plain = fa.flash_attention_plain(
            q[:, :, heads].contiguous(), k[:, :, heads].contiguous(),
            vp[:, :, heads].contiguous()).float()[..., :Dv]
        got = out[:, :, heads].float()
        ref = plain.abs()
        diff = (got[..., :Dv] - plain).abs()
        need(bool(got.isfinite().all())
             and bool((diff <= tol * ref + tol * ref.amax(-1,
                                                          keepdim=True)).all())
             and not bool(got[..., Dv:].any()),
             f"flash_attention at MLA's shape disagrees (heads {heads})")
        err = max(err, diff.max().item())
        del plain, got, ref, diff
    say(f"[check] flash_attention MLA (B {B}, S {S}, H {H}, D {D}, v {Dv} "
        f"padded to {D}, causal, mma body): max_abs_err={err:.3g} "
        f"(rtol={tol:.3g} + {tol:.3g} x row max), padded columns 0 ok")
    del out
    nbytes = 2 * B * S * H * (2 * D + 2 * Dv)
    insts = [tuple(a.clone() for a in (q, k, vp))
             for _ in range(copies_for(nbytes))]
    ms = time_ms(torch, [(lambda a=a: fa.flash_attention(*a))
                         for a in insts])
    del insts
    plain_ms = sum(_event_ms(torch, lambda h=h: fa.flash_attention_plain(
        q[:, :, h:h + 16].contiguous(), k[:, :, h:h + 16].contiguous(),
        vp[:, :, h:h + 16].contiguous()), reps=1) for h in range(0, H, 16))
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    sdpa_ms = time_ms(torch, [
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)])
    pairs = B * S * (S + 1) // 2
    b, by = bound(nbytes, 2 * (D + Dv) * pairs * H, BF16_OPS_PER_S)
    say(f"[times] flash_attention (MLA, B {B}, S {S}, H {H}, D {D}, v {Dv} "
        f"padded, causal): {ms:.4f} ms, bound {b:.4f} ms by {by} (the "
        f"unpadded work: {pairs} visible pairs a head), plain {plain_ms:.4f}"
        f" ms (16 heads at a time), SDPA (E {D}, Ev {Dv}) {sdpa_ms:.4f} ms "
        f"on {card}")
    del q, k, v, vp, qt, kt, vt
    torch.cuda.empty_cache()


def phase_check_prefix(torch) -> None:
    """Kernel 12's prefix mode (``prefix_len``) against its plain version
    on both bodies, at paligemma-3b's cacheless forward (B 1, S 4096, 8
    heads on 1 KV head of 256, p 256) and at a ragged S with p inside a
    tile (not counted)."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=DEVICE).manual_seed(15)
    for case, B, S, H, KH, D, p in FLASH_PREFIX_CASES:
        q, k, v = _flash_inputs(torch, gen, B, S, S, H, KH, D, "bf16")
        plain = fa.flash_attention_plain(q, k, v, True, None, p).float()
        ref = plain.abs()
        tol = FLASH_TOL["bf16"]
        limit = tol * ref + tol * ref.amax(-1, keepdim=True)
        for body in fa.BODIES:
            out = fa.flash_attention(q, k, v, True, None, body=body,
                                     prefix_len=p)
            diff = (out.float() - plain).abs()
            ok = bool(out.isfinite().all()) and bool((diff <= limit).all())
            say(f"[check] flash_attention prefix {case} (B {B}, S {S}, H {H}"
                f", KH {KH}, D {D}, p {p}, {body} body): max_abs_err="
                f"{diff.max().item():.3g} (rtol={tol:.3g} + {tol:.3g} x row "
                f"max) {'ok' if ok else 'FAIL'}")
            need(ok, f"flash_attention prefix at {case} ({body}) disagrees")
        del q, k, v, plain, ref, limit
    torch.cuda.empty_cache()


def times_dit(torch, card: str) -> None:
    """The plan's launches of a DiT-XL/2 block at 2B = 8 rows
    (``DIT_GEMMS``, and kernel 1 on the MLP input) under the plan's rule,
    each beside its bound and ``torch._int_mm`` on the same int8
    operands (no epilogue); their sum over a block and over the blocks
    of an evaluation.  Kernel 12 at the block's attention is the
    ops phase's "DiT-XL/2 attention" case (``times_ops``)."""
    from repro_torch.configs import get_dit_config
    from repro_torch.kernels import cim_gemm as cg
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(7)

    def int_mm_ms(xq, w):
        if xq.shape[0] <= 16:  # torch._int_mm needs more than 16 rows
            xp = torch.zeros((32, xq.shape[1]), dtype=torch.int8,
                             device=dev)
            xp[:xq.shape[0]] = xq
            xq = xp
        w_cm = w.t().contiguous().t()
        return time_ms(torch, [lambda: torch._int_mm(xq, w_cm)], reps=10)

    blocks = get_dit_config(DIT_ARCH).n_layers
    block_ms = 0.0
    for launch, name, M, K, N, form in DIT_GEMMS:
        insts = [_dit_operands(torch, dev, gen, launch, name, M, K, N)
                 for _ in range(copies_for(K * N + M * K))]
        ms = time_ms(torch, [o.run for o in insts], reps=10)
        o = insts[0]
        b, by = bound(o.nbytes, 2 * M * K * N, INT8_OPS_PER_S)
        lib = int_mm_ms(o.xq if o.x is None else
                        cg.quantize_rows_int8(o.x)[0], o.w)
        variant = "qin_f32" if form.startswith("f32 +") else (
            "qin_bf16" if name.endswith("qin") else "int8")
        plan = cg.gemm_plan(M, K, N, variant)
        block_ms += ms
        say(f"[times] DiT-XL/2 {launch}: {name} (M={M}, K={K}, N={N}, "
            f"{form}; {plan.variant} {plan.kind} cluster {plan.cluster}): "
            f"{ms:.4f} ms, bound {b:.5f} ms by {by}, torch._int_mm "
            f"{lib:.4f} ms ({ms / lib:.2f}x) on {card}")
        if launch == "MLP up":    # the requant's other form (ROADMAP B.14)
            two = time_ms(torch, [
                (lambda o=o: cg.quantize_rows_int8(cg.cim_gemm_int8_fused(
                    o.xq, o.w, o.xs, o.ws, activation="gelu")))
                for o in insts], reps=10)
            say(f"[times] DiT-XL/2 MLP up as the GEMM to f32 then the row "
                f"quantizer: {two:.4f} ms, against {ms:.4f} ms with the "
                f"requant in its epilogue, on {card}")
        del insts, o
        torch.cuda.empty_cache()
    M, K = _dit_mlp_input()
    xs = [torch.randn((M, K), device=dev, generator=gen).to(torch.bfloat16)
          for _ in range(copies_for(M * K * 2))]
    ms = time_ms(torch, [(lambda a=a: cg.quantize_rows_int8(a)) for a in xs],
                 reps=10)
    b, by = bound(M * K * 2 + M * K + M * 4, 0, INT8_OPS_PER_S)
    block_ms += ms
    say(f"[times] DiT-XL/2 MLP quantize: quantize_rows_int8 ([{M}, {K}] "
        f"bf16): {ms:.4f} ms, bound {b:.5f} ms by {by}, library null on "
        f"{card}")
    say(f"[times] DiT-XL/2 the plan's 6 launches of a block: {block_ms:.4f}"
        f" ms, x {blocks} blocks {blocks * block_ms:.3f} ms an evaluation "
        f"(kernel 12: the DiT-XL/2 attention line, x {blocks}) on {card}")
    del xs
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# tensor parallelism: TP ranks on the one card
# ---------------------------------------------------------------------------
def _timed_collectives(torch, group) -> list:
    """Time each collective of ``group`` on the host, after the work
    queued before it has finished (so the time is the collective's own:
    gloo's round trip through host memory).  Returns a one-element list
    of the seconds spent, growing as collectives run."""
    spent = [0.0]
    for name in ("all_reduce_max", "all_reduce_sum", "all_gather"):
        fn = getattr(group, name)

        def timed(t, fn=fn):
            _sync(torch)
            t0 = time.perf_counter()
            out = fn(t)
            spent[0] += time.perf_counter() - t0
            return out
        setattr(group, name, timed)
    return spent


def _tp_rank(group, spec: dict) -> dict:
    """One tensor-parallel rank: draw the model in turn (one rank at a
    time holds the bf16 weights), keep this rank's shards, serve each of
    ``spec["runs"]`` and, if asked, compute one prefill + decode step's
    logits.  Returns numbers and tokens (no tensors)."""
    import numpy as np
    import torch
    from repro_torch.models import Model
    from repro_torch.parallel.context import rank_device, tp_context
    from repro_torch.parallel.sharding import build_in_turns, shard_model
    from repro_torch.quant import QuantPlan
    from repro_torch.serving import PagedServingEngine, Request, ServingEngine

    dev = rank_device(spec["device"], TP_BACKEND, group.rank)
    cuda = dev.type == "cuda"
    cfg = spec["cfg"]
    gib = 2 ** 30

    def build():
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = Model(cfg).init(SEED, device=dev)
        shard_model(model.quantize(QuantPlan.full()), group)
        _sync(torch)
        mem = {}
        if cuda:
            torch.cuda.empty_cache()
            mem = dict(build_peak_gib=torch.cuda.max_memory_allocated() / gib,
                       after_plan_gib=torch.cuda.memory_allocated() / gib)
        return model, dict(mem, build_s=time.perf_counter() - t0)

    model, memory = build_in_turns(group, build)
    out = dict(rank=group.rank, memory=memory, runs={},
               kv_heads=[b.attn.n_kv_heads for b in model.layers])
    spent = _timed_collectives(torch, group)
    for run in spec["runs"]:
        paged = run["engine"] == "paged"
        cls = PagedServingEngine if paged else ServingEngine
        engine = cls(model, quant_plan=QuantPlan.full(), tp=group,
                     **run["kw"])
        reqs = [Request(uid=i, prompt=p, max_new_tokens=run["new"])
                for i, p in enumerate(_prompts(cfg, run["lengths"],
                                               run["seed"]))]
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        spent[0] = 0.0
        counts, wall, step_ms = _serve(
            torch, engine, reqs, "prefill_chunks" if paged else "prefills")
        st = engine.stats
        res = dict(tokens=[r.generated for r in reqs],
                   status=[r.status.value for r in reqs],
                   launches=counts, collectives=dict(group.counts),
                   collective_s=spent[0], wall=wall,
                   step_ms=statistics.median(step_ms),
                   decode_steps=st.decode_steps, prefills=st.prefills,
                   prefill_chunks=st.prefill_chunks,
                   preemptions=st.preemptions,
                   tokens_out=st.tokens_out)
        if paged:
            engine.paged.allocator.check()
            res["blocks_held"] = engine.paged.allocator.n_used
        if cuda:
            res["memory_gib"] = torch.cuda.memory_allocated() / gib
            res["peak_gib"] = torch.cuda.max_memory_allocated() / gib
        out["runs"][run["name"]] = res
        del engine
    if "reference" in spec:
        toks, lengths = (torch.as_tensor(a, device=dev)
                         for a in spec["reference"])
        caches = model.init_cache(toks.shape[0], 1024, kv_dtype="int8")
        with torch.no_grad(), tp_context(group):
            a = model.prefill_padded(toks, caches, lengths)
            b = model.decode_step(a.argmax(-1), caches)
        out["logits"] = np.asarray(torch.cat([a, b], dim=1).cpu())
    return out


def _reference_input(torch, cfg, seed):
    """Tokens [4, 64] and lengths for reference-tp (numpy)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab, (4, 64)).astype(np.int64),
            np.array([64, 61, 32, 1], np.int32))


def reference_logits(torch, model, ref_input):
    """One prefill + decode step on the unsharded kernel path: the logits
    reference-tp must reproduce bit for bit."""
    toks, lengths = (torch.as_tensor(a, device=DEVICE) for a in ref_input)
    caches = model.init_cache(toks.shape[0], 1024, kv_dtype="int8")
    with torch.no_grad():
        a = model.prefill_padded(toks, caches, lengths)
        b = model.decode_step(a.argmax(-1), caches)
    return torch.cat([a, b], dim=1).cpu()


def phase_tp(torch, tag: str, cfg, runs: list, want_tokens: dict,
             ref=None) -> dict:
    """Serve ``runs`` at TP ranks on the one card (gloo) and hold each
    against the unsharded run: every request OK, the ranks agree, rank
    0's tokens bitwise ``want_tokens[run]``, per layer per decode step 6
    launches (9 for an MoE layer) and per prefill 5 (8), per layer per
    forward 2 MAX + 2 SUM (+1 gather), the paged run preempts and drains.
    ``ref`` = (input, logits): reference-tp's bitwise logits.  Returns
    the launch counts summed over ranks and runs."""
    from repro_torch.analysis import manifest
    from repro_torch.parallel.context import spawn
    spec = dict(device=DEVICE, cfg=cfg, runs=runs)
    if ref is not None:
        spec["reference"] = ref[0]
    t0 = time.perf_counter()
    ranks = spawn(_tp_rank, TP, args=(spec,), backend=TP_BACKEND,
                  timeout_s=900)
    say(f"[{tag}] {TP} ranks ({TP_BACKEND}, one card) in "
        f"{time.perf_counter() - t0:.1f} s")
    moe = cfg.moe is not None
    L = cfg.n_layers
    total = {name: 0 for name in SOURCES}
    for rk in ranks:
        mem = rk["memory"]
        say(f"[{tag}] rank {rk['rank']}: drew and sharded in "
            f"{mem['build_s']:.1f} s, peak {mem.get('build_peak_gib', 0):.2f}"
            f" GiB while drawing, {mem.get('after_plan_gib', 0):.2f} GiB "
            f"after the plan; KV heads per layer {rk['kv_heads'][0]} of "
            f"{cfg.n_kv_heads}")
        KH = cfg.n_kv_heads
        need(rk["kv_heads"] == [KH // TP if KH % TP == 0 else KH] * L,
             f"rank {rk['rank']} holds {rk['kv_heads']} KV heads")
    for run in runs:
        name = run["name"]
        res = [rk["runs"][name] for rk in ranks]
        paged = run["engine"] == "paged"
        for r in res:
            need(r["status"] == ["ok"] * len(run["lengths"]),
                 f"{name}: requests not OK: {r['status']}")
            need(all(len(t) == run["new"] for t in r["tokens"]),
                 f"{name}: a request stopped early")
        need(all(r["tokens"] == res[0]["tokens"] for r in res),
             f"{name}: the ranks' tokens differ")
        need(res[0]["tokens"] == want_tokens[name],
             f"{name}: tokens differ from the unsharded run's")
        r0 = res[0]
        steps = r0["decode_steps"]
        fwd = steps + (r0["prefill_chunks"] if paged else r0["prefills"])
        walk = dict(kv_len=run["kw"]["max_len"], paged=paged)
        want = expected_launches(cfg, steps, fwd, tp=True, **walk)
        want_coll = {k: n * fwd for k, n in
                     manifest.step_collectives(cfg).items()}
        want_coll.setdefault("gather", 0)
        for r in res:
            need(r["launches"] == want,
                 f"{name}: launch counts {r['launches']} != {want}")
            need(r["collectives"] == dict(want_coll, bcast=0),
                 f"{name}: collectives {r['collectives']} != {want_coll}")
            for k in total:
                total[k] += r["launches"][k]
        per = launches_per_decode_step(cfg, r0["launches"], steps, fwd,
                                       tp=True)
        pre = sum(expected_launches(cfg, 0, 1, tp=True).values()) / L
        need(per == (9 if moe else 6),
             f"{name}: {per} launches per layer per decode step")
        need(pre == (8 if moe else 5),
             f"{name}: {pre} launches per layer per prefill")
        if paged:
            need(all(r["preemptions"] >= 1 for r in res),
                 f"{name}: the tight pool never preempted")
            need(all(r["blocks_held"] == 0 for r in res),
                 f"{name}: blocks still held at the end")
        say(f"[{name}] {len(run['lengths'])} requests OK on every rank, "
            f"tokens bitwise the unsharded run's: {r0['tokens_out']} decode "
            f"tokens + {r0['prefills']} prefills"
            + (f" ({r0['prefill_chunks']} chunks, {r0['preemptions']} "
               f"preemptions)" if paged else "")
            + f" in {r0['wall']:.2f} s, {steps} decode steps")
        for r, rk in zip(res, ranks):
            coll = r["collective_s"] * 1e3 / fwd
            say(f"[{name}] rank {rk['rank']}: median {r['step_ms']:.2f} ms "
                f"per decode step; collectives {coll:.2f} ms per forward "
                f"(gloo through host memory)"
                + (f"; memory {r['memory_gib']:.2f} GiB, peak "
                   f"{r['peak_gib']:.2f} GiB" if "memory_gib" in r else ""))
        say(f"[{name}] per rank: {per:g} launches per layer per decode "
            f"step, {pre:g} per prefill; per layer per forward "
            f"{r0['collectives']['max'] // (L * fwd)} MAX + "
            f"{r0['collectives']['sum'] // (L * fwd)} SUM + "
            f"{r0['collectives']['gather'] // (L * fwd)} gather")
        say(f"[{name}] launches (rank 0) {json.dumps(r0['launches'])}")
    if ref is not None:
        import numpy as np
        want = ref[1].numpy()
        for rk in ranks:
            got = rk["logits"]
            need(got.shape == want.shape and np.isfinite(got).all(),
                 "reference-tp: logits shape or non-finite")
            need(np.array_equal(got, want),
                 f"reference-tp: rank {rk['rank']} logits differ from the "
                 f"unsharded kernel path's (max |diff| "
                 f"{np.abs(got - want).max():.4g})")
        say(f"[reference-tp] {cfg.name} prefill + decode logits at TP-{TP} "
            f"bitwise the unsharded kernel path's on every rank")
    return total


def _sdpa_ms(torch, q, k, v, pos, qp, ks, vs):
    """One SDPA call over the dequantized bf16 cache [B, KH, S, D]
    (dequantizing and gathering not timed)."""
    import torch.nn.functional as F
    B, KH, G, D = q.shape
    kd = (k.float() * ks[..., None]).to(torch.bfloat16).transpose(1, 2)
    vd = (v.float() * vs[..., None]).to(torch.bfloat16).transpose(1, 2)
    mask = (pos <= qp[:, None])[:, None, None, :]
    q4 = q.reshape(B, KH * G, 1, D)
    return time_ms(torch, [lambda: F.scaled_dot_product_attention(
        q4, kd, vd, attn_mask=mask, enable_gqa=True)])


def walk_shapes():
    """The flash-decode walks' five timed shapes: (case, mode, visible
    lengths, S, KH, G, D, NS).  gemma-2b's and qwen2-moe's heads at the
    serve runs' end state (prompts + generated tokens visible in 1024
    slots), ring and paged (16-slot blocks, shuffled); kernel 9 at
    serve-long's end state (8192 slots, 4 splits)."""
    end = [n + NEW_TOKENS for n in SERVE_LENGTHS]
    long_end = [n + LONG_NEW_TOKENS for n in LONG_PROMPTS]
    return (("gemma-2b ring", "ring", end, 1024, 1, 8, 256, 1),
            ("gemma-2b paged", "paged", end, 1024, 1, 8, 256, 1),
            ("kernel 9 at serve-long", "split", long_end, LONG_MAX_LEN, 1,
             8, 256, 4),
            ("qwen2-moe ring", "ring", end, 1024, 16, 1, 128, 1),
            ("qwen2-moe paged", "paged", end, 1024, 16, 1, 128, 1))


def kept_steps(lengths, S, ns, step=64):
    """The longest walk's kept 64-slot steps: a row's visible prefix cut
    into the ``ns`` splits of ``split_len`` slots (one walk at ns 1)."""
    steps = -(-S // step)
    L = -(-steps // ns) * step
    return max(-(-(min(n, (s + 1) * L) - s * L) // step)
               for n in lengths for s in range(ns) if n > s * L)


def times_walks(torch, card: str) -> None:
    """The three walks at :func:`walk_shapes`: ms (CUDA-graph replays of
    L2-cold copies), the kept steps of the longest walk and the time per
    step, the launch plan's cluster size and stages, SDPA on the same
    cache beside it; at qwen2-moe's heads also the plain version and the
    bound; then each walk forced to every cluster size the plan picks
    from, with the clusters the card holds at once."""
    from repro_torch.kernels import decode_attention as da
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(5)
    for case, mode, lengths, S, KH, G, D, NS in walk_shapes():
        B = len(lengths)
        insts = [_decode_inputs(torch, dev, gen, B=B, S=S, KH=KH, G=G, D=D,
                                lengths=lengths)
                 for _ in range(copies_for(2 * B * S * KH * D))]
        if mode == "paged":
            for i, (q, k, v, pos, qp, ks, vs) in enumerate(insts):
                tables, pools = _to_pages(torch, k, v, pos, ks, vs,
                                          PAGED_BLOCK, SEED + i)
                insts[i] = (q, *pools[:3], tables, qp, *pools[3:])
        call, plain = {
            "ring": (da.decode_attention, da.decode_attention_plain),
            "paged": (da.decode_attention_paged,
                      da.decode_attention_paged_plain),
            "split": (lambda *a: da.decode_attention_partial(
                *a, n_splits=NS), None)}[mode]
        calls = [(lambda a=a: call(*a)) for a in insts]
        ms = time_ms(torch, calls)
        a = insts[0]
        if mode == "paged":
            q, kp, vp, pp, tables, qp, ksp, vsp = a
            bt = tables.long()
            ring = (q, kp[bt].reshape(B, S, KH, D),
                    vp[bt].reshape(B, S, KH, D), pp[bt].reshape(B, S), qp,
                    ksp[bt].reshape(B, S, KH), vsp[bt].reshape(B, S, KH))
        else:
            ring = a
        lib = _sdpa_ms(torch, *ring)
        steps = kept_steps(lengths, S, NS)

        def resident():
            return da.max_active_clusters(a[0].dtype, a[1].dtype, mode, S,
                                          KH, G, D, NS, PAGED_BLOCK)
        p = da.walk_plan(S, D, G, a[1].dtype, mode, NS, PAGED_BLOCK)
        say(f"[times] walk {case} (B {B}, S {S}, KH {KH}, G {G}, D {D}, "
            f"NS {NS}): {ms:.4f} ms, longest walk {steps} kept steps, "
            f"{ms / steps * 1e3:.2f} us a step; cluster {p.cluster} x "
            f"{da.STAGES} stages, {p.smem} B shared, {resident()} clusters "
            f"resident, {-(-steps // p.cluster)} steps a rank; SDPA "
            f"{lib:.4f} ms on {card}")
        sweep = []
        for c in da.CLUSTERS:
            with da.forced_plan(c):
                sweep.append(f"{c}: {time_ms(torch, calls):.4f} ms "
                             f"({resident()} resident)")
        say(f"[times] walk {case} at each cluster size: "
            f"{', '.join(sweep)} on {card}")
        if case.startswith("qwen2-moe"):
            plain_ms = time_ms(torch, [lambda: plain(*a)], reps=5)
            visible = sum(lengths)
            nbytes = (B * KH * G * D * 4 + visible * KH * (2 * D + 8)
                      + visible * 4 + B * 4)
            if mode == "paged":
                nbytes += a[4].numel() * 4
            b, by = bound(nbytes, 4 * visible * KH * G * D, F32_OPS_PER_S)
            say(f"[times] {call.__name__} (qwen2-moe heads, {mode}): "
                f"{ms:.4f} ms, bound {b:.5f} ms by {by}, plain "
                f"{plain_ms:.4f} ms, SDPA {lib:.4f} ms on {card}")
        del insts, calls, a, ring


# prefill shapes timed beside ``torch._int_mm``: kernel 3 at forward-long's
# down GEMM and a served prompt's, kernel 6 at the long forward's TP-2 down
# shard, and kernels 2 and 4 at forward-long's QKV and gated GEMMs
PREFILL_GEMMS = (("cim_gemm_int8_fused", 4096, 16384, 2048),
                 ("cim_gemm_int8_fused", 200, 16384, 2048),
                 ("cim_gemm_int8", 4096, 8192, 2048),
                 ("cim_gemm_int8_fused_qin", 4096, 2048, 2560),
                 ("cim_gated_gemm_int8", 4096, 2048, 16384))
# the tensor-core body's variant of each dense GEMM as the times phase
# drives it (kernel 2 on bf16 x, as the models feed it)
GEMM_VARIANT = {"cim_gemm_int8_fused": "int8", "cim_gemm_int8": "int8",
                "cim_gated_gemm_int8": "gated",
                "cim_gemm_int8_fused_qin": "qin_bf16"}


def times_gemm_plans(torch, card: str) -> None:
    """The tensor-core GEMM under every plan it takes at the decode
    shapes (kernel 3 at gemma-2b's down GEMM with its bf16 residual,
    kernel 6 at the TP partials, kernel 4 at gemma-2b's gated GEMM and at
    qwen2-moe's shared one with its requant, kernel 2 at gemma-2b's QKV),
    one line a plan; then the prefill shapes of ``PREFILL_GEMMS`` under
    the plan's rule, each beside ``torch._int_mm`` on the same operands
    (without the epilogue) and its bound."""
    from repro_torch.kernels import cim_gemm as cg
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(6)

    def ri(*shape):
        return torch.randint(-127, 128, shape, dtype=torch.int8, device=dev,
                             generator=gen)

    def rf(*shape):
        return torch.rand(shape, device=dev, generator=gen) * 1e-2 + 1e-4

    def operands(name, M, K, N):
        w = ri(K, N)
        if name == "cim_gemm_int8":
            x = ri(M, K)
            return (lambda: cg.cim_gemm_int8(x, w)), x, w, \
                M * K + K * N + M * N * 4, 2 * M * K * N
        if name == "cim_gemm_int8_fused_qin":
            x = torch.randn((M, K), device=dev, generator=gen).to(
                torch.bfloat16)
            ws = rf(N)
            return (lambda: cg.cim_gemm_int8_fused_qin(x, w, ws)), \
                cg.quantize_rows_int8(x)[0], w, \
                M * K * 2 + K * N + N * 4 + M * N * 4, 2 * M * K * N
        x, xs = ri(M, K), rf(M, 1)
        if name == "cim_gated_gemm_int8":
            # qwen2-moe's shared MLP requantizes its hidden state in-kernel
            qout = N == MOE_SHARED
            wu, gs, us = ri(K, N), rf(N), rf(N)
            return (lambda: cg.cim_gated_gemm_int8(
                x, w, wu, xs, gs, us, "silu" if qout else "gelu",
                quantize_out=qout)), \
                x, torch.cat([w, wu], 1), \
                M * K + M * 4 + 2 * (K * N + N * 4) + M * N * (
                    1 if qout else 4) + (M * 4 if qout else 0), \
                4 * M * K * N
        ws = rf(N)
        r = torch.randn((M, N), device=dev, generator=gen).to(torch.bfloat16)
        return (lambda: cg.cim_gemm_int8_fused(x, w, xs, ws, residual=r)), \
            x, w, M * K + M * 4 + K * N + N * 4 + M * N * 6, 2 * M * K * N

    def int_mm_ms(x, w):
        xp = x
        if x.shape[0] <= 16:  # torch._int_mm needs more than 16 rows
            xp = torch.zeros((32, x.shape[1]), dtype=torch.int8, device=dev)
            xp[:x.shape[0]] = x
        w_cm = w.t().contiguous().t()
        return time_ms(torch, [lambda: torch._int_mm(xp, w_cm)])

    decode = [("cim_gemm_int8_fused", 8, 16384, 2048)] + [
        ("cim_gemm_int8", 8, K, N) for K, N in TP_GEMM_SHAPES] + [
        ("cim_gated_gemm_int8", 8, 2048, 16384),
        ("cim_gated_gemm_int8", 8, MOE_D, MOE_SHARED),
        ("cim_gemm_int8_fused_qin", 8, 2048, 2560)]
    for name, M, K, N in decode:
        variant = GEMM_VARIANT[name]
        insts = [operands(name, M, K, N) for _ in range(copies_for(
            K * N * (2 if variant == "gated" else 1)))]
        calls = [i[0] for i in insts]
        rule = cg.gemm_plan(M, K, N, variant)
        b, by = bound(insts[0][3], insts[0][4], INT8_OPS_PER_S)
        lib = int_mm_ms(insts[0][1], insts[0][2])
        for plan in cg.gemm_plans(M, K, N, variant):
            with cg.forced_gemm_plan(plan.kind, plan.cluster):
                ms = time_ms(torch, calls)
            say(f"[times] {name} plan (M={M}, K={K}, N={N}) {plan.kind} "
                f"cluster {plan.cluster}: {ms:.4f} ms, grid "
                f"{plan.grid(M, N)} blocks, {plan.smem} B shared"
                f"{' (the rule)' if plan == rule else ''}; bound {b:.5f} ms "
                f"by {by}, torch._int_mm {lib:.4f} ms on {card}")
        del insts, calls
    for name, M, K, N in PREFILL_GEMMS:
        insts = [operands(name, M, K, N) for _ in range(copies_for(
            K * N * (2 if name == "cim_gated_gemm_int8" else 1)))]
        ms = time_ms(torch, [i[0] for i in insts], reps=10)
        b, by = bound(insts[0][3], insts[0][4], INT8_OPS_PER_S)
        lib = int_mm_ms(insts[0][1], insts[0][2])
        plan = cg.gemm_plan(M, K, N, GEMM_VARIANT[name])
        how = f"{plan.variant} {plan.kind} cluster {plan.cluster}"
        say(f"[times] {name} prefill (M={M}, K={K}, N={N}, {how}): "
            f"{ms:.4f} ms, bound {b:.5f} ms by {by}, torch._int_mm "
            f"{lib:.4f} ms ({ms / lib:.2f}x) on {card}")
        del insts
        torch.cuda.empty_cache()


# the row quantizer's timed shapes (M, K, dtype): gemma-2b's hidden
# requant and its MLP input at decode, qwen2-moe's stacked expert rows (E
# 60 x 8 capacity rows), the hidden requant of a 4096-token forward; the
# first is the kernels line's row
RQ_SHAPES = ((8, 16384, "f32"), (8, 2048, "bf16"), (480, 2048, "bf16"),
             (4096, 16384, "f32"))


def _rq_input(torch, M, K, dtype, gen):
    x = torch.randn((M, K), device=gen.device, generator=gen)
    return x if dtype == "f32" else x.to(torch.bfloat16)


def times_rowquant(torch, card: str) -> dict:
    """The row quantizer at each of RQ_SHAPES under the plan's rule and at
    half and twice the rule's threads (one line a plan), beside its bound (x read once, the codes and
    scales written once) and its plain version; returns the kernels
    line's row (the first shape)."""
    from repro_torch.kernels import cim_gemm as cg
    gen = torch.Generator(device=torch.device(DEVICE)).manual_seed(8)
    row = None
    for M, K, dtype in RQ_SHAPES:
        xb = 4 if dtype == "f32" else 2
        nbytes = M * K * xb + M * K + M * 4
        xs = [_rq_input(torch, M, K, dtype, gen)
              for _ in range(copies_for(nbytes))]
        calls = [(lambda x=x: cg.quantize_rows_int8(x)) for x in xs]
        rule = cg.rowquant_plan(M, K, xs[0].dtype)
        ms = time_ms(torch, calls)
        plain_ms = time_ms(torch, [lambda: cg.quantize_rows_int8_plain(
            xs[0])], reps=5)
        b, by = bound(nbytes, 3 * M * K, F32_OPS_PER_S)
        say(f"[times] quantize_rows_int8 ([{M}, {K}] {dtype}): {ms:.4f} "
            f"ms, bound {b:.5f} ms by {by}, plain {plain_ms:.4f} ms; plan "
            f"{M} blocks of {rule.threads} on {card}")
        for threads in (rule.threads // 2, rule.threads * 2):
            if not 32 <= threads <= 1024:
                continue
            with cg.forced_rowquant_plan(threads):
                pms = time_ms(torch, calls)
            say(f"[times] quantize_rows_int8 plan ([{M}, {K}] {dtype}) "
                f"{threads} threads: {pms:.4f} ms on {card}")
        if row is None:
            row = dict(name="quantize_rows_int8", ms=ms, plain_ms=plain_ms,
                       bound_ms=b, bound_by=by, library_ms=None)
        del xs, calls
    return row


def times_grouped_plans(torch, card: str, counts) -> None:
    """The grouped GEMMs under every plan their body takes (one line a
    plan), with a served step's expert counts: kernel 8 at serve-moe's
    decode shape with its requant; kernel 7 at the experts' down GEMM at
    decode (T 8) and at a prefill chunk's 48 capacity rows an expert."""
    from repro_torch.kernels import cim_gemm as cg
    gen = torch.Generator(device=counts.device).manual_seed(9)
    E, T, K, N = MOE_E, 8, MOE_D, MOE_F
    x, xs = _grouped_rows(torch, counts, T, K, gen)
    (wg, gs), (wu, us) = (_stack(torch, E, K, N, gen) for _ in range(2))
    rule = cg.grouped_plan(E, T, K, N)
    active = int((counts > 0).sum())
    for plan in cg.gemm_plans(T, K, N, "gated"):
        with cg.forced_gemm_plan(plan.kind, plan.cluster):
            ms = time_ms(torch, [lambda: cg.cim_grouped_gated_gemm_int8(
                x, wg, wu, xs, gs, us, counts=counts, activation="silu",
                quantize_out=True)])
        say(f"[times] cim_grouped_gated_gemm_int8 plan (E={E}, {active} "
            f"active, T={T}, K={K}, N={N}) {plan.kind} cluster "
            f"{plan.cluster}: {ms:.4f} ms, grid {plan.grid(T, N) * E} "
            f"blocks{' (the rule)' if plan == rule else ''} on {card}")
    del x, xs, wg, gs, wu, us
    K, N = MOE_F, MOE_D
    wd, ds = _stack(torch, E, K, N, gen)
    for T in (8, 48):
        x, xs = _grouped_rows(torch, counts, T, K, gen)
        rule = cg.grouped_plan(E, T, K, N, "int8")
        for plan in cg.gemm_plans(T, K, N, "int8"):
            with cg.forced_gemm_plan(plan.kind, plan.cluster):
                ms = time_ms(torch, [lambda: cg.cim_grouped_gemm_int8(
                    x, wd, xs, ds, counts=counts)])
            say(f"[times] cim_grouped_gemm_int8 plan (E={E}, {active} "
                f"active, T={T}, K={K}, N={N}) {plan.kind} cluster "
                f"{plan.cluster}: {ms:.4f} ms, grid {plan.grid(T, N) * E} "
                f"blocks{' (the rule)' if plan == rule else ''} on {card}")


def times_grouped_v3(torch, card: str, counts) -> None:
    """Kernels 8 and 7 at deepseek-v3's served decode shape (E 256, 8
    capacity rows an expert: 8 batch rows at capacity 1; gated K 7168, N
    2048 with its requant; down K 2048, N 7168) with a served step's
    expert counts (``counts``, from serve-deepseek-v3) and with every
    expert active, beside their bounds (the active experts' rows and
    weights, every expert's outputs) and a bf16 ``torch.bmm`` over the
    active experts' dequantized weights (a yardstick).  No plain time:
    the plain versions widen all 256 experts' weights to f64 (30 GB a
    stack)."""
    from repro_torch.kernels import cim_gemm as cg
    gen = torch.Generator(device=counts.device).manual_seed(21)
    cfg = dataclasses.replace(_v3_config(), n_layers=1)
    E, T, D, F = (cfg.moe.n_routed_experts, 8, cfg.d_model,
                  cfg.moe.d_expert)
    full = torch.ones(E, dtype=torch.int32, device=counts.device)
    for name, K, N, mats, out_bytes in (
            ("cim_grouped_gated_gemm_int8", D, F, 2, F + 4),
            ("cim_grouped_gemm_int8", F, D, 1, 4 * D)):
        w = [_stack(torch, E, K, N, gen) for _ in range(mats)]
        for tag, cnt in (("served", counts), ("all experts", full)):
            x, xs = _grouped_rows(torch, cnt, T, K, gen)

            def call(x=x, xs=xs, cnt=cnt):
                if mats == 2:
                    (wg, gs), (wu, us) = w
                    return cg.cim_grouped_gated_gemm_int8(
                        x, wg, wu, xs, gs, us, counts=cnt,
                        activation="silu", quantize_out=True)
                return cg.cim_grouped_gemm_int8(x, w[0][0], xs, w[0][1],
                                                counts=cnt)
            ms = time_ms(torch, [call])
            a = int((cnt > 0).sum())
            nbytes = (a * (T * K + T * 4 + mats * (K * N + N * 4))
                      + E * T * out_bytes + E * 4)
            b, by = bound(nbytes, 2 * mats * a * T * K * N, INT8_OPS_PER_S)
            on = (cnt > 0).nonzero().squeeze(1)
            xb = torch.randn((a, T, K), device=counts.device,
                             generator=gen).to(torch.bfloat16)
            wb = torch.cat([(q[on].float() * sc[on][:, None, :])
                            for q, sc in w], -1).to(torch.bfloat16)
            bmm = time_ms(torch, [lambda: torch.bmm(xb, wb)])
            say(f"[times] {name} deepseek-v3 ({tag}: {a} of {E} experts "
                f"active, T={T}, K={K}, N={N}): {ms:.4f} ms, bound "
                f"{b:.4f} ms by {by}; yardstick bf16 torch.bmm over the "
                f"active experts {bmm:.4f} ms on {card}")
            del x, xs, xb, wb
        del w
        torch.cuda.empty_cache()


def _v3_config():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(V3_ARCH), n_layers=V3_LAYERS)


def phase_times(torch, serve: dict, moe: dict, counts: dict, errs: dict,
                card: str, v3_counts=None) -> list:
    from repro_torch.kernels import cim_gemm as cg
    from repro_torch.kernels import decode_attention as da

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(2)
    M = 8
    rows = []

    def int_mm(xq, w_cm):
        # torch._int_mm needs more than 16 rows: pad to 32
        xp = torch.zeros((32, xq.shape[1]), dtype=torch.int8, device=dev)
        xp[:xq.shape[0]] = xq
        return lambda: torch._int_mm(xp, w_cm)

    def gemm_row(name, make, plain, lib, nbytes, ops, peak=INT8_OPS_PER_S):
        n = copies_for(nbytes)
        insts = [make() for _ in range(n)]
        ms = time_ms(torch, [i[0] for i in insts])
        plain_ms = time_ms(torch, [plain(*insts[0][1])], reps=5)
        lib_ms = time_ms(torch, [lib(*insts[0][1])]) if lib else None
        b, by = bound(nbytes, ops, peak)
        rows.append(dict(name=name, ms=ms, plain_ms=plain_ms, bound_ms=b,
                         bound_by=by, library_ms=lib_ms))

    d, ff, hk = 2048, 16384, 2560

    def wmat(K, N):
        return (torch.randint(-127, 128, (K, N), dtype=torch.int8,
                              device=dev, generator=gen),
                torch.rand(N, device=dev, generator=gen) * 2e-3 + 1e-4)

    def x_bf16(K):
        return torch.randn((M, K), device=dev, generator=gen).to(
            torch.bfloat16)

    # row quantizer at the hidden-state requant ([8, 16384] f32, the row)
    # and the other shapes of RQ_SHAPES, each under every plan
    rows.append(times_rowquant(torch, card))

    # QKV: x [8, 2048] bf16 @ [2048, 2560] int8
    def make_qkv():
        x = x_bf16(d)
        w, ws = wmat(d, hk)
        return (lambda: cg.cim_gemm_int8_fused_qin(x, w, ws)), (x, w, ws)
    gemm_row("cim_gemm_int8_fused_qin", make_qkv,
             lambda x, w, ws: lambda: cg.cim_gemm_int8_fused_qin_plain(
                 x, w, ws),
             lambda x, w, ws: int_mm(cg.quantize_rows_int8(x)[0],
                                     w.t().contiguous().t()),
             M * d * 2 + d * hk + hk * 4 + M * hk * 4, 2 * M * d * hk)

    # down: x_q [8, 16384] @ [16384, 2048] + residual
    def make_down():
        hq = torch.randint(-127, 128, (M, ff), dtype=torch.int8, device=dev,
                           generator=gen)
        hs = torch.rand((M, 1), device=dev, generator=gen) * 1e-2
        w, ws = wmat(ff, d)
        r = x_bf16(d)
        return (lambda: cg.cim_gemm_int8_fused(hq, w, hs, ws, residual=r)), \
            (hq, w, hs, ws, r)
    gemm_row("cim_gemm_int8_fused", make_down,
             lambda hq, w, hs, ws, r: lambda: cg.cim_gemm_int8_fused_plain(
                 hq, w, hs, ws, None, r),
             lambda hq, w, hs, ws, r: int_mm(hq, w.t().contiguous().t()),
             M * ff + M * 4 + ff * d + d * 4 + M * d * 2 + M * d * 4,
             2 * M * ff * d)

    # gated: x_q [8, 2048] @ 2 x [2048, 16384]
    def make_gated():
        xq = torch.randint(-127, 128, (M, d), dtype=torch.int8, device=dev,
                           generator=gen)
        xs = torch.rand((M, 1), device=dev, generator=gen) * 1e-2
        (wg, gs), (wu, us) = wmat(d, ff), wmat(d, ff)
        return (lambda: cg.cim_gated_gemm_int8(xq, wg, wu, xs, gs, us,
                                               "gelu")), \
            (xq, wg, wu, xs, gs, us)
    gemm_row("cim_gated_gemm_int8", make_gated,
             lambda xq, wg, wu, xs, gs, us: lambda:
             cg.cim_gated_gemm_int8_plain(xq, wg, wu, xs, gs, us, "gelu"),
             lambda xq, wg, wu, xs, gs, us: int_mm(
                 xq, torch.cat([wg, wu], 1).t().contiguous().t()),
             M * d + M * 4 + 2 * d * ff + 2 * ff * 4 + M * ff * 4,
             4 * M * d * ff)

    # kernel 6 at the TP row-parallel partials (decode, M = 8): the row
    # is gemma-2b's down shard; the out-projection and qwen2-moe's shared
    # down shards are printed beside it
    for K, N in TP_GEMM_SHAPES:
        def make_k6(K=K, N=N):
            xq = torch.randint(-127, 128, (M, K), dtype=torch.int8,
                               device=dev, generator=gen)
            w = torch.randint(-127, 128, (K, N), dtype=torch.int8,
                              device=dev, generator=gen)
            return (lambda: cg.cim_gemm_int8(xq, w)), (xq, w)
        nbytes = M * K + K * N + M * N * 4
        insts = [make_k6() for _ in range(copies_for(nbytes))]
        ms = time_ms(torch, [i[0] for i in insts])
        xq, w = insts[0][1]
        plain_ms = time_ms(torch, [lambda: cg.cim_gemm_int8_plain(xq, w)],
                           reps=5)
        lib_ms = time_ms(torch, [int_mm(xq, w.t().contiguous().t())])
        b, by = bound(nbytes, 2 * M * K * N, INT8_OPS_PER_S)
        say(f"[times] cim_gemm_int8 (M={M}, K={K}, N={N}): {ms:.4f} ms, "
            f"bound {b:.5f} ms by {by}, plain {plain_ms:.4f} ms, "
            f"torch._int_mm {lib_ms:.4f} ms on {card}")
        if (K, N) == TP_GEMM_SHAPES[1]:
            rows.append(dict(name="cim_gemm_int8", ms=ms, plain_ms=plain_ms,
                             bound_ms=b, bound_by=by, library_ms=lib_ms))
        del insts

    # decode attention at the end-of-serve cache state: the served
    # lengths + generated tokens are visible, the rest of 1024 is empty
    lengths = [n + NEW_TOKENS for n in serve["lengths"]]
    B, S, KH, G, D = 8, 1024, 1, 8, 256
    n = copies_for(2 * B * S * KH * D)
    insts = [_decode_inputs(torch, dev, gen, lengths=lengths)
             for _ in range(n)]
    ms = time_ms(torch, [(lambda a=a: da.decode_attention(*a))
                         for a in insts])
    plain_ms = time_ms(torch, [lambda: da.decode_attention_plain(
        *insts[0])], reps=5)

    def attn_bytes(visible, B, KH, G, D, out_bytes):
        """q read once, the visible slots' int8 K and V, their scales and
        positions, q_pos, and the outputs."""
        return (B * KH * G * D * 2 + visible * KH * (2 * D + 2 * 4)
                + visible * 4 + B * 4 + out_bytes)

    lib_ms = _sdpa_ms(torch, *insts[0])
    visible = sum(lengths)
    nbytes = attn_bytes(visible, B, KH, G, D, B * KH * G * D * 2)
    b, by = bound(nbytes, 4 * visible * KH * G * D, F32_OPS_PER_S)
    rows.append(dict(name="decode_attention", ms=ms, plain_ms=plain_ms,
                     bound_ms=b, bound_by=by, library_ms=lib_ms))

    # paged walk at the same visible lengths, 16-slot blocks shuffled
    pinsts = []
    for i in range(n):
        q, k, v, pos, qp, ks, vs = _decode_inputs(torch, dev, gen,
                                                  lengths=lengths)
        tables, (kp, vp, pp, ksp, vsp) = _to_pages(torch, k, v, pos, ks, vs,
                                                   PAGED_BLOCK, SEED + i)
        pinsts.append((q, kp, vp, pp, tables, qp, ksp, vsp))
    ms = time_ms(torch, [(lambda a=a: da.decode_attention_paged(*a))
                         for a in pinsts])
    plain_ms = time_ms(torch, [lambda: da.decode_attention_paged_plain(
        *pinsts[0])], reps=5)
    q, kp, vp, pp, tables, qp, ksp, vsp = pinsts[0]
    bt = tables.long()
    lib_ms = _sdpa_ms(torch, q, kp[bt].reshape(B, S, KH, D),
                      vp[bt].reshape(B, S, KH, D), pp[bt].reshape(B, S), qp,
                      ksp[bt].reshape(B, S, KH), vsp[bt].reshape(B, S, KH))
    nbytes = attn_bytes(visible, B, KH, G, D,
                        B * KH * G * D * 2) + tables.numel() * 4
    b, by = bound(nbytes, 4 * visible * KH * G * D, F32_OPS_PER_S)
    rows.append(dict(name="decode_attention_paged", ms=ms,
                     plain_ms=plain_ms, bound_ms=b, bound_by=by,
                     library_ms=lib_ms))
    del pinsts, insts

    # split walk and combine at serve-long's end state: 4 rows of 8192
    # slots, the prompts + generated tokens visible, 4 splits
    from repro_torch.kernels import ops
    lengths = [n + LONG_NEW_TOKENS for n in LONG_PROMPTS]
    B, S, NS = len(lengths), LONG_MAX_LEN, ops.n_splits_for(LONG_MAX_LEN)
    n = copies_for(2 * B * S * KH * D)
    insts = [_decode_inputs(torch, dev, gen, B=B, S=S, lengths=lengths)
             for _ in range(n)]
    ms = time_ms(torch, [(lambda a=a: da.decode_attention_partial(
        *a, n_splits=NS)) for a in insts])
    plain_ms = time_ms(torch, [lambda: da.decode_attention_partial_plain(
        *insts[0], n_splits=NS)], reps=5)
    lib_ms = _sdpa_ms(torch, *insts[0])
    single_ms = time_ms(torch, [(lambda a=a: da.decode_attention(*a))
                                for a in insts])
    say(f"[times] single walk at the same shapes (B={B}, S={S}): "
        f"{single_ms:.4f} ms, against {ms:.4f} ms for the {NS}-split "
        f"partial walk on {card}")
    visible = sum(lengths)
    part_bytes = B * KH * NS * G * (D + 2) * 4
    nbytes = attn_bytes(visible, B, KH, G, D, part_bytes)
    b, by = bound(nbytes, 4 * visible * KH * G * D, F32_OPS_PER_S)
    rows.append(dict(name="decode_attention_partial", ms=ms,
                     plain_ms=plain_ms, bound_ms=b, bound_by=by,
                     library_ms=lib_ms))
    parts = [da.decode_attention_partial(*a, n_splits=NS) for a in insts]
    parts += [tuple(t.clone() for t in parts[i % len(parts)])
              for i in range(copies_for(part_bytes) - len(parts))]
    # the combine alone; then the split walk and the combine as served,
    # one after the other
    ms = time_ms(torch, [(lambda p=p: da.decode_attention_combine(
        *p, torch.bfloat16)) for p in parts])
    plain_ms = time_ms(torch, [lambda: da.decode_attention_combine_plain(
        *parts[0], torch.bfloat16)], reps=5)
    nbytes = part_bytes + B * KH * G * D * 2
    b, by = bound(nbytes, 4 * B * KH * NS * G * (D + 1), F32_OPS_PER_S)
    rows.append(dict(name="decode_attention_combine", ms=ms,
                     plain_ms=plain_ms, bound_ms=b, bound_by=by,
                     library_ms=None))
    pair = time_ms(torch, [(lambda a=a: da.decode_attention_combine(
        *da.decode_attention_partial(*a, n_splits=NS), torch.bfloat16))
        for a in insts])
    say(f"[times] split walk then combine (B={B}, S={S}, NS={NS}): "
        f"{pair:.4f} ms on {card}")
    del parts, insts

    # grouped GEMMs at serve-moe's decode shapes (E = 60, T = 8) with the
    # expert counts of a served decode step (the skip list), then with
    # every expert active; the bound counts the active experts' rows and
    # weights and every expert's outputs
    E, T, Dm, F = MOE_E, 8, MOE_D, MOE_F
    served = moe["step_counts"].to(dev)
    full = torch.ones(E, dtype=torch.int32, device=dev)

    def grouped_bytes(cnt, K, N, mats, out_bytes):
        a = int((cnt > 0).sum())
        return (a * (T * K + T * 4 + mats * (K * N + N * 4))
                + E * T * out_bytes + E * 4), a

    def make_grouped_gated(cnt):
        x, xs = _grouped_rows(torch, cnt, T, Dm, gen)
        (wg, gs), (wu, us) = (_stack(torch, E, Dm, F, gen)
                              for _ in range(2))
        return (lambda: cg.cim_grouped_gated_gemm_int8(
            x, wg, wu, xs, gs, us, counts=cnt, activation="silu",
            quantize_out=True)), (x, wg, wu, xs, gs, us, cnt)

    def make_grouped_down(cnt):
        hq, hs = _grouped_rows(torch, cnt, T, F, gen)
        wd, ds = _stack(torch, E, F, Dm, gen)
        return (lambda: cg.cim_grouped_gemm_int8(hq, wd, hs, ds,
                                                 counts=cnt)), \
            (hq, wd, hs, ds, cnt)

    def gated_plain(x, wg, wu, xs, gs, us, cnt):
        return lambda: cg.quantize_rows_int8_plain(
            cg.cim_grouped_gated_gemm_int8_plain(x, wg, wu, xs, gs, us, cnt,
                                                 "silu"))

    def down_plain(hq, wd, hs, ds, cnt):
        return lambda: cg.cim_grouped_gemm_int8_plain(hq, wd, hs, ds, None,
                                                      cnt)

    def bmm_yardstick(w_and_scales, cnt, K):
        """One bf16 torch.bmm over the active experts' dequantized
        weights (gate and up side by side): a yardstick, not a port."""
        on = (cnt > 0).nonzero().squeeze(1)
        x = torch.randn((len(on), T, K), device=dev,
                        generator=gen).to(torch.bfloat16)
        w = torch.cat([(q[on].float() * sc[on][:, None, :])
                       for q, sc in w_and_scales], -1).to(torch.bfloat16)
        return time_ms(torch, [lambda: torch.bmm(x, w)])

    for name, make, plain, K, N, weights, out_bytes in (
            ("cim_grouped_gated_gemm_int8", make_grouped_gated, gated_plain,
             Dm, F,
             lambda a: ((a[1], a[4]), (a[2], a[5])), F + 4),
            ("cim_grouped_gemm_int8", make_grouped_down, down_plain, F, Dm,
             lambda a: ((a[1], a[3]),), 4 * Dm)):
        for tag, cnt in (("served", served), ("all experts", full)):
            inst = make(cnt)
            mats = len(weights(inst[1]))
            nbytes, a = grouped_bytes(cnt, K, N, mats, out_bytes)
            ms = time_ms(torch, [inst[0]])
            b, by = bound(nbytes, 2 * mats * a * T * K * N, INT8_OPS_PER_S)
            bmm = bmm_yardstick(weights(inst[1]), cnt, K)
            say(f"[times] {name} ({tag}: {a} of {E} experts active, T={T}, "
                f"K={K}, N={N}): {ms:.4f} ms, bound {b:.4f} ms by {by}; "
                f"yardstick bf16 torch.bmm over the active experts "
                f"{bmm:.4f} ms on {card}")
            if tag == "served":
                plain_ms = time_ms(torch, [plain(*inst[1])], reps=5)
                rows.append(dict(name=name, ms=ms, plain_ms=plain_ms,
                                 bound_ms=b, bound_by=by, library_ms=None))
            if name == "cim_grouped_gated_gemm_int8" and tag == "served":
                x, wg, wu, xs, gs, us, c = inst[1]
                two = time_ms(torch, [lambda: cg.quantize_rows_int8(
                    cg.cim_grouped_gated_gemm_int8(
                        x, wg, wu, xs, gs, us, counts=c,
                        activation="silu").reshape(E * T, N))])
                say(f"[times] {name} (served) as the GEMM then the row "
                    f"quantizer: {two:.4f} ms, against {ms:.4f} ms with "
                    f"the requant in its epilogue, on {card}")
            del inst

    times_grouped_plans(torch, card, served)
    times_grouped_v3(torch, card, v3_counts.to(dev))

    # kernels 3 and 4 with the requant epilogue at the shared MLP's shapes
    # ([8, 2048] x [2048, 5632]; gated: two weights), against the same
    # kernel without it followed by the row quantizer; enough copies of
    # the weights that each call finds them cold
    N = MOE_SHARED

    def make_shared():
        xq = torch.randint(-127, 128, (M, Dm), dtype=torch.int8, device=dev,
                           generator=gen)
        xs = torch.rand((M, 1), device=dev, generator=gen) * 1e-2 + 1e-4
        (wg, gs), (wu, us) = wmat(Dm, N), wmat(Dm, N)
        return xq, xs, wg, gs, wu, us

    shared = [make_shared() for _ in range(copies_for(Dm * N))]
    for name, fn, pick, mats in (
            ("cim_gated_gemm_int8", cg.cim_gated_gemm_int8,
             lambda xq, xs, wg, gs, wu, us: (xq, wg, wu, xs, gs, us, "silu"),
             2),
            ("cim_gemm_int8_fused", cg.cim_gemm_int8_fused,
             lambda xq, xs, wg, gs, wu, us: (xq, wg, xs, gs, None, None,
                                             "gelu"), 1)):
        args = [pick(*a) for a in shared]
        fused = time_ms(torch, [(lambda a=a: fn(*a, quantize_out=True))
                                for a in args])
        two = time_ms(torch, [(lambda a=a: cg.quantize_rows_int8(fn(*a)))
                              for a in args])
        nbytes = M * Dm + M * 4 + mats * (Dm * N + N * 4) + M * N + M * 4
        b, by = bound(nbytes, 2 * mats * M * Dm * N, INT8_OPS_PER_S)
        say(f"[times] {name} quantize_out (M={M}, K={Dm}, N={N}): "
            f"{fused:.4f} ms in one launch (bound {b:.4f} ms by {by}), "
            f"{two:.4f} ms as the GEMM then the row quantizer, on {card}")
    del shared

    times_gemm_plans(torch, card)
    times_dit(torch, card)
    times_walks(torch, card)
    rows += times_ops(torch, card)
    times_flash_mla(torch, card)
    rows.append(times_fallback(torch, card))
    out = []
    for r in rows:
        src, repl = SOURCES[r["name"]]
        entry = {"name": r["name"], "route": "cuda", "source": src,
                 "replaces": repl, "launches": counts[r["name"]],
                 "max_abs_err": errs[r["name"]], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        lib = ("null" if r["library_ms"] is None
               else f"{r['library_ms']:.4f}")
        say(f"[times] {r['name']}: {r['ms']:.4f} ms (bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}, plain "
            f"{r['plain_ms']:.4f} ms, library {lib} ms) on {card}")
        out.append(entry)
    return out


def times_ops(torch, card: str) -> list:
    """Kernels 12-14 at the ops phase's shapes: each case's median ms
    beside its bound, its plain version and one PyTorch call (SDPA with
    GQA and the window as a mask for flash attention, ``torch.softmax``;
    none computes the SSD scan).  The first case of each kernel is its
    row of the kernels line, the others are printed; a flash case that
    runs on the tensor cores is also timed on the CUDA-core body."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import online_softmax as sm
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import ssd_scan as ss
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = []

    def timed(name, case, calls, plain, lib, nbytes, ops, peak, first):
        ms = time_ms(torch, calls)
        plain_ms = time_ms(torch, [plain], reps=5)
        lib_ms = time_ms(torch, [lib]) if lib else None
        b, by = bound(nbytes, ops, peak)
        lib_s = "null" if lib_ms is None else f"{lib_ms:.4f} ms"
        say(f"[times] {name} ({case}): {ms:.4f} ms, bound {b:.5f} ms by "
            f"{by}, plain {plain_ms:.4f} ms, library {lib_s} on {card}")
        if first:
            rows.append(dict(name=name, ms=ms, plain_ms=plain_ms,
                             bound_ms=b, bound_by=by, library_ms=lib_ms))

    for i, c in enumerate(FLASH_CASES):
        case, B, Sq, Skv, H, KH, D, dtype, causal, window = c
        size = 2 if dtype == "bf16" else 4
        nbytes = size * (2 * B * Sq * H * D + 2 * B * Skv * KH * D)
        insts = [_flash_inputs(torch, gen, B, Sq, Skv, H, KH, D, dtype)
                 for _ in range(copies_for(nbytes))]
        visible = kref.prefill_visible(Sq, Skv, causal, window, dev)
        q, k, v = insts[0]
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        # SDPA (GQA, its top-left causal mask or the window as a mask)
        mask = None if window is None else visible
        timed("flash_attention", case,
              [(lambda a=a: fa.flash_attention(*a, causal, window))
               for a in insts],
              lambda: fa.flash_attention_plain(q, k, v, causal, window),
              lambda: torch.nn.functional.scaled_dot_product_attention(
                  qt, kt, vt, attn_mask=mask,
                  is_causal=causal and mask is None, enable_gqa=True),
              nbytes, 4 * B * H * D * int(visible.sum()),
              BF16_OPS_PER_S if dtype == "bf16" else F32_OPS_PER_S, i == 0)
        body = fa.body_for(q.dtype, D)
        if body == "mma":    # the CUDA-core body at the same shape
            fma_ms = time_ms(torch, [
                (lambda a=a: fa.flash_attention(*a, causal, window,
                                                body="fma"))
                for a in insts])
            say(f"[times] flash_attention ({case}) on the CUDA cores' f32 "
                f"body: {fma_ms:.4f} ms (the tensor-core body above) on "
                f"{card}")
        del insts, q, k, v, qt, kt, vt, visible

    # the prefix mode at paligemma-3b's cacheless forward, beside SDPA
    # with the same boolean mask
    case, B, S, H, KH, D, p = FLASH_PREFIX_CASES[0]
    nbytes = 2 * (2 * B * S * H * D + 2 * B * S * KH * D)
    insts = [_flash_inputs(torch, gen, B, S, S, H, KH, D, "bf16")
             for _ in range(copies_for(nbytes))]
    visible = kref.prefill_visible(S, S, True, None, dev, p)
    q, k, v = insts[0]
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    where = f"prefix {case}, B {B}, S {S}, H {H}, KH {KH}, D {D}, p {p}"
    timed("flash_attention", where,
          [(lambda a=a: fa.flash_attention(*a, prefix_len=p))
           for a in insts],
          lambda: fa.flash_attention_plain(q, k, v, True, None, p),
          lambda: torch.nn.functional.scaled_dot_product_attention(
              qt, kt, vt, attn_mask=visible, enable_gqa=True),
          nbytes, 4 * B * H * D * int(visible.sum()), BF16_OPS_PER_S, False)
    fma_ms = time_ms(torch, [
        (lambda a=a: fa.flash_attention(*a, prefix_len=p, body="fma"))
        for a in insts])
    say(f"[times] flash_attention ({where}) on the CUDA cores' f32 body: "
        f"{fma_ms:.4f} ms on {card}")
    del insts, q, k, v, qt, kt, vt, visible

    # the scan: the least work counts C·Bᵀ and G·X on and below the
    # diagonal only
    BH, S, P, N, L = SSD_CASE
    nbytes = 4 * (2 * BH * S * P + BH * S + 2 * BH * S * N + BH * P * N)
    insts = [_ssd_inputs(torch, gen, BH, S, P, N)
             for _ in range(copies_for(nbytes))]
    tri = L * (L + 1) // 2
    ops_ssd = BH * (S // L) * (2 * tri * (N + P) + 4 * L * P * N)
    timed("ssd_scan", f"zamba2-1.2b Mamba-2 layer, BH {BH}, S {S}, P {P}, "
          f"N {N}, chunk {L}",
          [(lambda a=a: ss.ssd_scan(*a, chunk=L)) for a in insts],
          lambda: ss.ssd_scan_plain(*insts[0], L), None, nbytes, ops_ssd,
          F32_OPS_PER_S, True)
    del insts

    # the softmax beside a copy of the same bytes (what one read and one
    # write of x take here) and, where the plan takes a cluster, under a
    # cluster of 16 blocks of 512 threads
    for i, (case, R, C, dtype) in enumerate(SOFTMAX_CASES):
        nbytes = 2 * R * C * (2 if dtype == "bf16" else 4)
        insts = [_softmax_input(torch, gen, case, R, C, dtype)
                 for _ in range(copies_for(nbytes))]
        x = insts[0]
        plan = sm.softmax_plan(R, C, x.dtype)
        where = (f"{case} [{R}, {C}] {dtype}, {plan.regime}, "
                 f"{plan.threads} threads, cluster {plan.cluster}")
        timed("online_softmax", where,
              [(lambda a=a: sm.online_softmax(a)) for a in insts],
              lambda: sm.online_softmax_plain(x),
              lambda: torch.softmax(x, -1), nbytes, 4 * R * C,
              F32_OPS_PER_S, i == 0)
        outs = [torch.empty_like(a) for a in insts]
        copy_ms = time_ms(torch, [(lambda a=a, o=o: o.copy_(a))
                                  for a, o in zip(insts, outs)])
        say(f"[times] online_softmax ({case} [{R}, {C}] {dtype}): a copy "
            f"of the same bytes (copy_) {copy_ms:.4f} ms on {card}")
        if plan.regime == "cluster":
            with sm.forced_softmax_plan(512, 16):
                forced_ms = time_ms(torch, [
                    (lambda a=a: sm.online_softmax(a)) for a in insts])
            say(f"[times] online_softmax ({case} [{R}, {C}] {dtype}) under "
                f"16 blocks of 512 threads a row: {forced_ms:.4f} ms on "
                f"{card}")
        del insts, outs, x
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: src/repro_torch not found; run from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    try:
        phase_build()
        card = phase_card(torch)
        errs = phase_check(torch)
        phase_check_fallback(torch, errs)
        phase_check_prefix(torch)
        ops_counts, ops_errs = phase_ops(torch)
        errs.update(ops_errs)
        counts, serve = phase_serve(torch)
        # each run sets the counters to 0 first; the JSON line sums them
        paged_counts, paged_tokens, paged_ms = phase_serve_paged(
            torch, serve["model"])
        runs = [counts, paged_counts,
                phase_obs(torch, serve, (paged_tokens, paged_ms), card)]
        torch.cuda.empty_cache()
        runs.append(phase_serve_long(torch, serve["model"]))
        torch.cuda.empty_cache()
        phase_reference(torch, serve["model"], SEED)
        phase_profile(torch, serve["model"], SEED)
        long_counts = phase_forward_long(torch, serve["model"])
        chaos_counts = phase_chaos(torch, serve)
        cfg = serve["model"].cfg
        ref_input = _reference_input(torch, cfg, SEED + 4)
        ref_logits = reference_logits(torch, serve["model"], ref_input)
        del serve["model"]
        gc.collect()
        torch.cuda.empty_cache()
        runs.append(phase_tp(torch, "serve-tp", cfg, [
            dict(name="serve-tp", engine="ring", lengths=serve["lengths"],
                 seed=SEED, new=NEW_TOKENS, kw=dict(
                     n_slots=8, max_len=1024, prefill_bucket=64)),
            dict(name="serve-tp-paged", engine="paged",
                 lengths=PAGED_PROMPTS, seed=SEED + 1, new=NEW_TOKENS,
                 kw=dict(n_slots=8, max_len=1024, prefill_bucket=64,
                         block_size=PAGED_BLOCK, prefill_chunk=64,
                         num_blocks=PAGED_NUM_BLOCKS))],
            {"serve-tp": serve["tokens"], "serve-tp-paged": paged_tokens},
            ref=(ref_input, ref_logits)))
        moe_counts, moe = phase_serve_moe(torch)
        runs.append(moe_counts)
        moe_paged_counts, _, _ = phase_serve_paged(torch, moe["model"],
                                                   "serve-moe-paged")
        runs.append(moe_paged_counts)
        torch.cuda.empty_cache()
        phase_reference(torch, moe["model"], SEED, "reference-moe")
        phase_profile(torch, moe["model"], SEED, "profile-moe")
        moe_cfg = moe["model"].cfg
        del moe["model"]
        gc.collect()
        torch.cuda.empty_cache()
        runs.append(phase_tp(torch, "serve-moe-tp", moe_cfg, [
            dict(name="serve-moe-tp", engine="ring",
                 lengths=serve["lengths"], seed=SEED + 3, new=NEW_TOKENS,
                 kw=dict(n_slots=8, max_len=1024, prefill_bucket=64))],
            {"serve-moe-tp": moe["tokens"]}))
        dit_counts = phase_serve_dit(torch)
        zamba_counts = phase_serve_zamba2(torch)
        # the dense family beyond gemma-2b: their serve runs launch
        # kernel 12 zero times, their cacheless forwards only kernel 12
        # (counted below)
        g3_counts, g3_forward = phase_serve_gemma3(torch)
        pali_counts, pali_forward = phase_serve_paligemma(torch)
        runs += [g3_counts, pali_counts, phase_musicgen(torch)]
        runs += [phase_serve_deep(torch, arch) for arch in DEEP_ARCHS]
        v3_counts, v3_forward, v3_steps = phase_serve_v3(torch)
        runs += [v3_counts, phase_serve_xlstm(torch)]
        counts = {k: sum(r[k] for r in runs) for k in counts}
        need(all(v > 0 for k, v in counts.items()
                 if k not in OPS_KERNELS + DEGRADED_KERNELS),
             f"a kernel was never launched by the serve runs: {counts}")
        need(not any(counts[k] for k in OPS_KERNELS + DEGRADED_KERNELS),
             f"a serve run launched a kernel of the ops phase or of the "
             f"degraded mode: {counts}")
        counts = {k: v + dit_counts[k] + zamba_counts[k]
                  for k, v in counts.items()}
        # kernel 14: the ops phase's own exact count; kernel 13: the ops
        # phase's and serve-zamba2's; kernel 12: its model paths',
        # forward-long and serve-dit
        counts.update({k: ops_counts[k] for k in OPS_KERNELS})
        counts["ssd_scan"] += zamba_counts["ssd_scan"]
        counts["finite_screen"] = chaos_counts["finite_screen"]
        counts["flash_attention"] = (long_counts["flash_attention"]
                                     + dit_counts["flash_attention"]
                                     + g3_forward["flash_attention"]
                                     + pali_forward["flash_attention"]
                                     + v3_forward["flash_attention"])
        kernels = phase_times(torch, serve, moe, counts, errs, card,
                              v3_steps)
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
