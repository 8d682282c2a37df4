#!/usr/bin/env python3
"""Where kernel 13's time goes: the SSD scan with one phase switched off
at a time, on one NVIDIA GPU.

    python3 tools/ssd_scan_phases.py [BH,S,P,N,L[,g] ...]

Builds variants of ``src/repro_torch/csrc/ssd_scan.cu`` under
``build/ssd_phases/`` (one ``nvcc`` each, all at once), in each of which
one phase's loop runs no iteration: G (``C·Bᵀ`` on and below the
diagonal), Y (``G·X``), S (the chunk's state contribution), Yoff (``C·hᵀ``
from the entering state), the wait on the predecessor, or every product
(what is left: staging, the scan of log_a, the state hand-off).  Each
variant's outputs are wrong; only its time means anything.  One line a
variant and case: the median ms of 20 launches (CUDA events, the flags'
memset included).  A case is ``BH,S,P,N,L`` in the ops layout ([BH, S,
P], b and c per row), or with a sixth field (any, e.g. ``g``) the
model's layout (B 1, H = BH, b and c of one group).  Default:
zamba2-1.2b's layer, S 2048.
"""
from __future__ import annotations

import ctypes
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "ssd_phases"
FLAGS = ("SKIP_G", "SKIP_Y", "SKIP_S", "SKIP_YOFF", "NOWAIT")
# (text of the kernel, its switchable form)
SWITCHES = (
    ("for (int blk = warp; blk < n_blk; blk += NT / 32)",
     "for (int blk = warp; blk < (SKIP_G ? 0 : n_blk); blk += NT / 32)"),
    ("for (int id = tid; id < 2 * nNT * nPT; id += NT)",
     "for (int id = tid; id < (SKIP_S ? 0 : 2 * nNT * nPT); id += NT)"),
    ("while (ld_acquire(flag) == 0)",
     "while (!NOWAIT && ld_acquire(flag) == 0)"),
    ("if (hin == nullptr) return;",
     "if (hin == nullptr || SKIP_YOFF) return;"),
    ("for (int id = tid; id < nT * nPT; id += NT) {\n"
     "    const int tt = fold(id / nPT, nT), pt = id % nPT;\n    float yv",
     "for (int id = tid; id < (SKIP_Y ? 0 : nT * nPT); id += NT) {\n"
     "    const int tt = fold(id / nPT, nT), pt = id % nPT;\n    float yv"),
)
VARIANTS = {"all phases": (), "no G": ("SKIP_G",), "no Y": ("SKIP_Y",),
            "no S": ("SKIP_S",), "no Yoff": ("SKIP_YOFF",),
            "no wait": ("NOWAIT",),
            "no products": ("SKIP_G", "SKIP_Y", "SKIP_S", "SKIP_YOFF")}


def build() -> dict:
    src = (ROOT / "src/repro_torch/csrc/ssd_scan.cu").read_text()
    for a, b in SWITCHES:
        if a not in src:
            raise SystemExit(f"ssd_scan_phases: the kernel no longer holds "
                             f"{a!r}; update SWITCHES")
        src = src.replace(a, b, 1)
    head = "".join(f"#ifndef {m}\n#define {m} 0\n#endif\n" for m in FLAGS)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "phases.cu").write_text(head + src)
    procs = {}
    for name, on in VARIANTS.items():
        lib = OUT / f"lib{len(procs)}.so"
        cmd = ["/usr/local/cuda/bin/nvcc", "-gencode",
               "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC",
               *[f"-D{m}=1" for m in on], "-o", str(lib),
               str(OUT / "phases.cu")]
        procs[name] = (subprocess.Popen(cmd), lib)
    for name, (proc, _) in procs.items():
        if proc.wait() != 0:
            raise SystemExit(f"ssd_scan_phases: nvcc failed for {name}")
    return {name: lib for name, (_, lib) in procs.items()}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ssd_scan_phases: no CUDA device", file=sys.stderr)
        return 2
    cases = [tuple(int(v) if v.isdigit() else v for v in a.split(","))
             for a in sys.argv[1:]] or [(64, 2048, 64, 64, 128)]
    libs = build()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    for case in cases:
        BH, S, P, N, L = case[:5]
        grouped = len(case) > 5
        x = torch.randn((BH, S, P), device=dev, generator=gen) * 0.01
        la = -torch.rand((BH, S), device=dev, generator=gen) * 0.1
        b, c = (torch.randn((1 if grouped else BH, S, N), device=dev,
                            generator=gen) for _ in range(2))
        B, H = (1, BH) if grouped else (BH, 1)
        nc = -(-S // L)
        y = torch.empty_like(x)
        fin = torch.empty((BH, P, N), device=dev)
        ws = torch.empty(((nc - 1) * BH * P * N,), device=dev)
        flags = torch.zeros((nc * BH + 1,), dtype=torch.int32, device=dev)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        for name, lib in libs.items():
            fn = ctypes.CDLL(str(lib)).ssd_scan_launch
            fn.argtypes = [P_] * 9 + [I_] * 8 + [P_]

            def run():
                flags.zero_()
                err = fn(x.data_ptr(), la.data_ptr(), b.data_ptr(),
                         c.data_ptr(), None, y.data_ptr(), fin.data_ptr(),
                         ws.data_ptr(), flags.data_ptr(), B, S, H, 1, P, N,
                         L, int(P % 4 == 0 and N % 4 == 0), stream)
                if err:
                    raise RuntimeError(f"{name}: launch failed ({err})")
            for _ in range(3):
                run()
            torch.cuda.synchronize()
            times = []
            for _ in range(20):
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                run()
                t1.record()
                t1.synchronize()
                times.append(t0.elapsed_time(t1))
            print(f"[phases] {case} {name}: "
                  f"{statistics.median(times):.4f} ms on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
