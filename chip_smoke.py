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
            D 128.
4. serve  — full-width gemma-2b (random weights from a seed, built and
            quantized once, shared by the three runs) served by
            ``ServingEngine(quant_plan=QuantPlan.full())``: 8 greedy
            requests; every request must end OK and the kernels' launch
            counters must match the plan (7 launches per layer per decode
            step).
   serve-paged — ``PagedServingEngine`` over a pool too small for the
            first 8 of its 16 requests, so it must preempt: every request
            OK, the pool drains, counters exact (7 per layer per decode
            step, 6 per layer per prefill chunk).
   serve-long — the ring engine at 8192 slots, where decode attention
            takes the split walk: 8 launches per layer per decode step.
   reference — one full-width ring prefill + decode step and one paged
            two-chunk prefill + decode step held against the plain path,
            and the reduced config's logits too.
   profile — one decode step's wall time beside the device time the
            profiler attributes to kernels, and the largest kernels.
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
5. times  — each kernel's median time at the serve shapes beside its
            bound, its plain version and one PyTorch call (library_ms);
            the grouped GEMMs with the expert counts of a served decode
            step and with every expert active, and kernels 3 and 4 with
            the requant epilogue at the shared MLP's shapes.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before
that line.
"""
from __future__ import annotations

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
# bytes/s, int8 tensor-core ops/s, f32 (non-tensor) ops/s.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
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
}
MOE_ARCH = "qwen2-moe-a2.7b"
# qwen2-moe-a2.7b's widths, for the kernel checks and times
MOE_E, MOE_D, MOE_F, MOE_SHARED = 60, 2048, 1408, 5632
# the paged run's pool (160 allocatable blocks of 16 slots) and requests:
# the first eight need more than the pool holds, so it must preempt
PAGED_BLOCK = 16
PAGED_NUM_BLOCKS = 161
PAGED_PROMPTS = [600, 520, 450, 380, 300, 240, 180, 120, 90, 64, 48, 40, 32,
                 24, 20, 16]
# the long run: a ring of 8192 slots, 4 splits
LONG_MAX_LEN = 8192
LONG_PROMPTS = [5000, 2500, 300, 40]
LONG_NEW_TOKENS = 16


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
    torch.cuda.synchronize()
    return errs


def expected_launches(cfg, decode_steps, forwards,
                       attention=("decode_attention",)) -> dict:
    """Launches the full plan makes, per layer and forward (decode step,
    prefill or prefill chunk): QKV, out-proj; for a dense FFN row-quant,
    gated (re-quantizing its output when d_ff <= 8192, else one more
    row-quant: gemma-2b's 16384), down; for an MoE FFN row-quant of the
    stacked expert rows, grouped gated (requant fused), grouped down,
    and the shared MLP's row-quant, gated (requant fused), down.  Per
    layer and decode step one launch of each ``attention`` kernel; a
    prefill attends with the plain dense path."""
    from repro_torch.kernels.cim_gemm import MAX_FUSED_QUANT_N
    want = {name: 0 for name in SOURCES}
    for _mixer, ffn in cfg.layer_specs():
        want["cim_gemm_int8_fused_qin"] += 2 * forwards
        want["cim_gemm_int8_fused"] += forwards
        want["cim_gated_gemm_int8"] += forwards
        if ffn == "moe":
            want["quantize_rows_int8"] += 2 * forwards
            want["cim_grouped_gated_gemm_int8"] += forwards
            want["cim_grouped_gemm_int8"] += forwards
        else:
            want["quantize_rows_int8"] += (
                1 if cfg.d_ff <= MAX_FUSED_QUANT_N else 2) * forwards
        for name in attention:
            want[name] += decode_steps
    return want


def launches_per_decode_step(cfg, counts, decode_steps, forwards) -> float:
    """Launches per layer per decode step: all counted launches less the
    prefills' (``forwards`` without decode steps), over the steps."""
    prefill = sum(expected_launches(cfg, 0, forwards - decode_steps,
                                    ()).values())
    return (sum(counts.values()) - prefill) / (cfg.n_layers * decode_steps)


def _serve(torch, engine, reqs, prefill_counter):
    """Submit ``reqs``, set the launch counters to 0, step the engine
    until every request is terminal and read the counters.  Returns
    (counts, wall seconds, ms of each step that ran no prefill)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    for r in reqs:
        engine.submit(r)
    reset_launch_counts()
    step_ms = []
    t0 = time.perf_counter()
    while engine.pending():
        s0 = time.perf_counter()
        before = getattr(engine.stats, prefill_counter)
        engine.step()
        torch.cuda.synchronize()
        if getattr(engine.stats, prefill_counter) == before:
            step_ms.append((time.perf_counter() - s0) * 1e3)
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
    lengths = [16, 40, 64, 65, 100, 128, 150, 200]
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
    return counts, dict(model=model, lengths=lengths)


def phase_serve_paged(torch, model, tag: str = "serve-paged") -> dict:
    """The paged engine on the shared model, over a pool that cannot hold
    the first eight requests at once."""
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
                             attention=("decode_attention_paged",))
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
    return counts


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
    want = expected_launches(
        cfg, st.decode_steps, st.decode_steps + st.prefills,
        attention=("decode_attention_partial", "decode_attention_combine"))
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
    lengths = [16, 40, 64, 65, 100, 128, 150, 200]
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
    prefill = sum(expected_launches(cfg, 0, 1, ()).values()) / cfg.n_layers
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


def phase_times(torch, serve: dict, moe: dict, counts: dict, errs: dict,
                card: str) -> list:
    from repro_torch.kernels import cim_gemm as cg
    from repro_torch.kernels import decode_attention as da
    import torch.nn.functional as F

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(2)
    M = 8
    rows = []

    def bound(nbytes, ops, peak):
        t_b = nbytes / HBM_BYTES_PER_S * 1e3
        t_o = ops / peak * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

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

    # row quantizer at the hidden-state requant: [8, 16384] f32
    def make_rq():
        h = torch.randn((M, ff), device=dev, generator=gen)
        return (lambda: cg.quantize_rows_int8(h)), (h,)
    gemm_row("quantize_rows_int8", make_rq,
             lambda h: lambda: cg.quantize_rows_int8_plain(h), None,
             M * ff * 4 + M * ff + M * 4, 3 * M * ff, F32_OPS_PER_S)

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

    def sdpa_ms(q, k, v, pos, qp, ks, vs):
        """One SDPA call over the dequantized bf16 cache [B, KH, S, D]
        (dequantizing and gathering not timed)."""
        B, KH, G, D = q.shape
        kd = (k.float() * ks[..., None]).to(torch.bfloat16).transpose(1, 2)
        vd = (v.float() * vs[..., None]).to(torch.bfloat16).transpose(1, 2)
        mask = (pos <= qp[:, None])[:, None, None, :]
        q4 = q.reshape(B, KH * G, 1, D)
        return time_ms(torch, [lambda: F.scaled_dot_product_attention(
            q4, kd, vd, attn_mask=mask, enable_gqa=True)])

    def attn_bytes(visible, B, KH, G, D, out_bytes):
        """q read once, the visible slots' int8 K and V, their scales and
        positions, q_pos, and the outputs."""
        return (B * KH * G * D * 2 + visible * KH * (2 * D + 2 * 4)
                + visible * 4 + B * 4 + out_bytes)

    lib_ms = sdpa_ms(*insts[0])
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
    lib_ms = sdpa_ms(q, kp[bt].reshape(B, S, KH, D),
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
    lib_ms = sdpa_ms(*insts[0])
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
    ms = time_ms(torch, [(lambda p=p: da.decode_attention_combine(
        *p, torch.bfloat16)) for p in parts])
    plain_ms = time_ms(torch, [lambda: da.decode_attention_combine_plain(
        *parts[0], torch.bfloat16)], reps=5)
    nbytes = part_bytes + B * KH * G * D * 2
    b, by = bound(nbytes, 4 * B * KH * NS * G * (D + 1), F32_OPS_PER_S)
    rows.append(dict(name="decode_attention_combine", ms=ms,
                     plain_ms=plain_ms, bound_ms=b, bound_by=by,
                     library_ms=None))
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
        counts, serve = phase_serve(torch)
        # each run sets the counters to 0 first; the JSON line sums them
        runs = [counts, phase_serve_paged(torch, serve["model"])]
        torch.cuda.empty_cache()
        runs.append(phase_serve_long(torch, serve["model"]))
        torch.cuda.empty_cache()
        phase_reference(torch, serve["model"], SEED)
        phase_profile(torch, serve["model"], SEED)
        del serve["model"]
        gc.collect()
        torch.cuda.empty_cache()
        moe_counts, moe = phase_serve_moe(torch)
        runs.append(moe_counts)
        runs.append(phase_serve_paged(torch, moe["model"],
                                      "serve-moe-paged"))
        torch.cuda.empty_cache()
        counts = {k: sum(r[k] for r in runs) for k in counts}
        need(all(v > 0 for v in counts.values()),
             f"a kernel was never launched by the serve runs: {counts}")
        phase_reference(torch, moe["model"], SEED, "reference-moe")
        phase_profile(torch, moe["model"], SEED, "profile-moe")
        del moe["model"]
        gc.collect()
        torch.cuda.empty_cache()
        kernels = phase_times(torch, serve, moe, counts, errs, card)
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
