#!/usr/bin/env python3
"""Time kernels of another checkout beside this one's on one NVIDIA GPU.

    python3 ab_kernels.py DIR KERNEL [KERNEL ...]

DIR holds the other checkout's ``src/`` (for example a parent commit
unpacked with ``git archive HEAD^ src | tar -x -C build/parent``).  Each
KERNEL names a wrapper of ``repro_torch.kernels`` with cases in CASES.
The trees run in turns old | new | new | old, one process a turn (both
packages are ``repro_torch``), each building only the sources of the
named kernels (as ``chip_smoke.SOURCES`` lists them).  One line a case
gives the four times (ms, CUDA-graph replays through
``chip_smoke.time_ms``, operands cold in L2) and whether all four turns
gave the same output bits.  A kernel in CLOSE (the SSD scan and the
online softmax: two designs may sum in different orders) must give the
same bits in the two turns of each tree, and the new tree's outputs must
lie within its tolerance of the old tree's (the turns' outputs go through files under
``build/ab_out/``).  Exits 1 if a case fails its check, 2 on bad
arguments or no GPU.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent


def _rowquant_cases(torch, cs, cg, gen):
    """The row quantizer at chip_smoke's RQ_SHAPES."""
    for M, K, dtype in cs.RQ_SHAPES:
        xb = 4 if dtype == "f32" else 2
        xs = [cs._rq_input(torch, M, K, dtype, gen)
              for _ in range(cs.copies_for(M * K * (xb + 1)))]
        yield (f"[{M}, {K}] {dtype}",
               [(lambda x=x: cg.quantize_rows_int8(x)) for x in xs])


def _grouped_operands(torch, cs, gen, K, N, T=8):
    """serve-moe's experts at T capacity rows each (8 at a decode step)
    with 25 of 60 experts active (a served step's counts), then with all
    60: (tag, counts, x, xs, w, ws)."""
    served = cs._served_like_counts(torch, gen, gen.device, E=cs.MOE_E)
    for tag, cnt in (("25 of 60 active", served),
                     ("all 60 active", torch.ones_like(served))):
        x, xs = cs._grouped_rows(torch, cnt, T, K, gen)
        w, ws = cs._stack(torch, cs.MOE_E, K, N, gen)
        yield tag, cnt, x, xs, w, ws


def _grouped_gated_cases(torch, cs, cg, gen):
    """Kernel 8 at serve-moe's decode shape, with its requant (as served)
    and with f32 out."""
    for tag, cnt, x, xs, wg, gs in _grouped_operands(
            torch, cs, gen, cs.MOE_D, cs.MOE_F):
        wu, us = cs._stack(torch, cs.MOE_E, cs.MOE_D, cs.MOE_F, gen)
        for qo in (True, False):
            yield (f"{'requant' if qo else 'f32'}, {tag}",
                   [lambda cnt=cnt, x=x, xs=xs, wg=wg, gs=gs, wu=wu, us=us,
                    qo=qo: cg.cim_grouped_gated_gemm_int8(
                        x, wg, wu, xs, gs, us, counts=cnt,
                        activation="silu", quantize_out=qo)])


def _grouped_cases(torch, cs, cg, gen):
    """Kernel 7 at serve-moe's down projection of the experts: at a decode
    step (T 8), at the 16-row decode tile and at a prefill chunk's 48
    capacity rows an expert (the prefill tile)."""
    for T in (8, 16, 48):
        for tag, cnt, x, xs, w, ws in _grouped_operands(
                torch, cs, gen, cs.MOE_F, cs.MOE_D, T):
            yield (tag if T == 8 else f"T {T}, {tag}",
                   [lambda cnt=cnt, x=x, xs=xs, w=w, ws=ws:
                    cg.cim_grouped_gemm_int8(x, w, xs, ws, counts=cnt)])


def _combine_cases(torch, cs, cg, gen):
    """Kernel 10 at serve-long's end state (B 4, KH 1, G 8, D 256, NS 4,
    bf16 out) on split states drawn from the seed, enough copies that
    each call finds its partials cold."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    B, KH, G, D = len(cs.LONG_PROMPTS), 1, 8, 256
    NS = ops.n_splits_for(cs.LONG_MAX_LEN)
    dev = gen.device

    def states():
        return (torch.randn((B, KH, NS, G, D), device=dev, generator=gen),
                torch.randn((B, KH, NS, G, 1), device=dev,
                            generator=gen) * 3,
                torch.rand((B, KH, NS, G, 1), device=dev,
                           generator=gen) * 50 + 0.5)
    parts = [states() for _ in range(cs.copies_for(B * KH * NS * G * D * 4))]
    yield (f"B={B} KH={KH} G={G} D={D} NS={NS} bf16",
           [lambda p=p: da.decode_attention_combine(*p, torch.bfloat16)
            for p in parts])


def _ssd_cases(torch, cs, cg, gen):
    """Kernel 13 through the flattened-head signature both trees take, at
    the ops phase's zamba2-1.2b layer (S 2048) and at serve-zamba2's
    longest prompt (S 1984: a ragged last chunk), from a zero state."""
    from repro_torch.kernels import ssd_scan as ss
    BH, S, P, N, L = cs.SSD_CASE
    for s in (S, 1984):
        nbytes = 4 * (2 * BH * s * P + BH * s + 2 * BH * s * N)
        insts = [cs._ssd_inputs(torch, gen, BH, s, P, N)
                 for _ in range(cs.copies_for(nbytes))]
        yield (f"BH {BH}, S {s}, P {P}, N {N}, chunk {L}",
               [lambda a=a: ss.ssd_scan(*a, chunk=L) for a in insts])


def _softmax_cases(torch, cs, cg, gen):
    """Kernel 14 at the ops phase's SOFTMAX_CASES (DiT-XL/2's scores,
    gemma-2b's logits in f32 and bf16), enough copies that each call finds
    x cold in L2."""
    from repro_torch.kernels import online_softmax as sm
    for case, R, C, dtype in cs.SOFTMAX_CASES:
        nbytes = 2 * R * C * (2 if dtype == "bf16" else 4)
        xs = [cs._softmax_input(torch, gen, case, R, C, dtype)
              for _ in range(cs.copies_for(nbytes))]
        yield (f"{case} [{R}, {C}] {dtype}",
               [lambda x=x: sm.online_softmax(x) for x in xs])


def _flash_cases(torch, cs, cg, gen):
    """Kernel 12 at the ops phase's FLASH_CASES through the signature
    both trees take (no ``lse``): every case must give the old tree's
    bits."""
    from repro_torch.kernels import flash_attention as fa
    for case, B, Sq, Skv, H, KH, D, dtype, causal, window in cs.FLASH_CASES:
        size = 2 if dtype == "bf16" else 4
        nbytes = size * (2 * B * Sq * H * D + 2 * B * Skv * KH * D)
        insts = [cs._flash_inputs(torch, gen, B, Sq, Skv, H, KH, D, dtype)
                 for _ in range(cs.copies_for(nbytes))]
        yield (case, [lambda a=a: fa.flash_attention(*a, causal, window)
                      for a in insts])


# wrapper name -> cases (label, calls on distinct inputs); add a kernel
# here to time it
CASES = {
    "quantize_rows_int8": _rowquant_cases,
    "cim_grouped_gated_gemm_int8": _grouped_gated_cases,
    "cim_grouped_gemm_int8": _grouped_cases,
    "decode_attention_combine": _combine_cases,
    "ssd_scan": _ssd_cases,
    "online_softmax": _softmax_cases,
    "flash_attention": _flash_cases,
}
# kernels held to a tolerance across trees, chip_smoke's: a number (rtol
# and share of the largest magnitude alike) or, by dtype, (rtol, share)
CLOSE = {"ssd_scan": "SSD_TOL", "online_softmax": "SOFTMAX_TOL"}
OUT = ROOT / "build" / "ab_out"


def _slug(name: str) -> str:
    return "".join(ch if ch.isalnum() else "_" for ch in name)


def child(src: str, turn: str, kernels: list[str]) -> int:
    """Build the sources of ``kernels`` in ``src/repro_torch``, time each
    case of ``kernels`` and print the times and the outputs' digests as
    the last line; the outputs of a kernel in CLOSE go to
    ``OUT/<turn>_<case>.pt``."""
    import torch
    sys.path.insert(0, src)
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import cim_gemm as cg
    names = sorted({pathlib.Path(cs.SOURCES[k][0]).name for k in kernels})
    _build.sources = lambda: [_build.CSRC / n for n in names]
    t0 = time.perf_counter()
    _build.build_all()
    cs.say(f"[ab] {_build.CSRC.parent} built in "
           f"{time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(10)
    times, digests = {}, {}
    for kernel in kernels:
        for label, calls in CASES[kernel](torch, cs, cg, gen):
            name = f"{kernel} {label}"
            out = calls[0]()
            out = out if isinstance(out, tuple) else (out,)
            torch.cuda.synchronize()
            h = hashlib.sha256()
            for t in out:
                h.update(t.cpu().contiguous().view(torch.uint8).numpy()
                         .tobytes())
            digests[name] = h.hexdigest()
            if kernel in CLOSE:
                OUT.mkdir(parents=True, exist_ok=True)
                torch.save([t.cpu() for t in out],
                           OUT / f"{turn}_{_slug(name)}.pt")
            times[name] = cs.time_ms(torch, calls)
            del calls, out
        torch.cuda.empty_cache()
    print(json.dumps({"times": times, "digests": digests}), flush=True)
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--turn"] and len(sys.argv) > 4:
        return child(sys.argv[2], sys.argv[3], sys.argv[4:])
    if len(sys.argv) < 3 or any(k not in CASES for k in sys.argv[2:]):
        print(f"usage: ab_kernels.py DIR KERNEL [KERNEL ...]; kernels: "
              f"{', '.join(CASES)}", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        torch = None
    if torch is None or not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 2
    other, kernels = pathlib.Path(sys.argv[1]).resolve(), sys.argv[2:]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    turns = []
    for i, tree in enumerate((other, ROOT, ROOT, other)):
        proc = subprocess.run(
            [sys.executable, str(ROOT / "ab_kernels.py"), "--turn",
             str(tree / "src"), str(i), *kernels], capture_output=True,
            text=True, timeout=900)
        lines = proc.stdout.splitlines()
        for line in lines[:-1]:
            print(line, flush=True)
        if proc.returncode != 0 or not lines:
            print(proc.stderr[-4000:], file=sys.stderr)
            print(f"ab_kernels: FAILED: the turn of {tree}", file=sys.stderr)
            return 1
        turns.append(json.loads(lines[-1]))
    print(f"[ab] old = {other}, new = {ROOT}; ms, CUDA-graph replays, on "
          f"{card}")
    differ = 0
    for name in turns[1]["times"]:
        times = " | ".join(f"{t['times'][name]:.4f}" for t in turns)
        digests = [t["digests"][name] for t in turns]
        kernel = name.split()[0]
        if kernel not in CLOSE:
            same = len(set(digests)) == 1
            differ += not same
            print(f"[ab] {name}: {times}; "
                  f"{'bitwise equal' if same else 'BITS DIFFER'}")
            continue
        import chip_smoke as cs
        import torch
        old, new = (torch.load(OUT / f"{i}_{_slug(name)}.pt")
                    for i in (0, 1))
        tol = getattr(cs, CLOSE[kernel])
        if isinstance(tol, dict):
            rtol, share = tol["bf16" if old[0].dtype == torch.bfloat16
                              else "f32"]
        else:
            rtol = share = tol
        worst = max(((n.float() - o.float()).abs() / (
            rtol * o.float().abs() + share * o.float().abs().max())
            .clamp_min(1e-30)).max().item() for o, n in zip(old, new))
        ok = digests[0] == digests[3] and digests[1] == digests[2] and \
            worst <= 1
        differ += not ok
        print(f"[ab] {name}: {times}; each tree bitwise across its turns: "
              f"{digests[0] == digests[3] and digests[1] == digests[2]}; "
              f"new within {rtol:g} + {share:g} x max of old: largest "
              f"err/limit {worst:.3g} {'ok' if ok else 'FAIL'}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
