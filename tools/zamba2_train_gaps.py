#!/usr/bin/env python3
"""How far zamba2-1.2b's training path on the kernels lies from the plain
path, and how far a fault planted in kernel 13 moves it, on one NVIDIA
GPU.

    python3 tools/zamba2_train_gaps.py

Builds kernels 12 and 13 only, trains full-width zamba2-1.2b as
``chip_smoke.py``'s train-zamba2 phase does (one warm-up step, then
``TRAIN_STEPS``), and on one microbatch of the trained model prints what
the phase's path gate reads (the relative loss and grad-norm gaps, the
largest and median relative gradient gap over the trained weights):

- bf16: the kernel path against the plain path (kernels off), and
  against itself with kernel 13's forward swapped for the plain scan
  (the same backward, y a rounding apart): the rounding floor of the
  bf16 gradients;
- the weights cast to f32: the kernel path against the plain path, then
  with a fault planted in kernel 13's output at every Mamba-2 layer call:
  one chunk's y (chunk 20 of 32) scaled by 1 + eps, and the scan
  restarted from a zero state at chunk 16 (a look-back that stops after
  16 chunks).

For each fault also what the phase's y gate reads: the last Mamba-2
layer's scan from a seeded state, y and the final state against the
plain scan in f64, and whether they lie within ``SSD_TOL`` of each
element plus ``SSD_TOL`` of the largest |value|.  Exits 2 without a GPU.
"""
from __future__ import annotations

import pathlib
import statistics
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
FAULT_CHUNK = 20
RESTART_CHUNK = 16
SCALES = (1e-4, 1e-3, 1e-2)


def planted(real, fault):
    """``real`` (the raw kernel-13 wrapper) with ``fault`` in its output:
    ("scale", eps) or ("restart", None)."""
    import torch

    def scan(x, log_a, b, c, chunk=128, h0=None):
        kind, eps = fault
        cut = (FAULT_CHUNK if kind == "scale" else RESTART_CHUNK) * chunk
        if x.shape[1] <= cut:
            return real(x, log_a, b, c, chunk, h0)
        if kind == "scale":
            y, final = real(x, log_a, b, c, chunk, h0)
            y = y.clone()
            y[:, cut:cut + chunk] *= 1 + eps
            return y, final
        head, tail = ([t[:, s].contiguous() for t in (x, log_a, b, c)]
                      for s in (slice(None, cut), slice(cut, None)))
        y0, _ = real(*head, chunk, h0)
        y1, final = real(*tail, chunk, None)
        return torch.cat([y0, y1], 1), final
    scan.launches = 0       # the wrapper counts its launches on its name
    return scan


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("zamba2_train_gaps: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import ssm as ssm_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    _build.sources = lambda: [csrc / "ssd_scan.cu",
                              csrc / "flash_attention.cu"]
    cs.phase_build()
    card = cs.phase_card(torch)
    cfg = get_config(cs.ZAMBA_ARCH)
    run = cs._train_steps(torch, "gaps", cfg, card, cs.TRAIN_BATCH,
                          cs.TRAIN_STEPS)
    model, params = run["model"], run["params"]
    micro = cs._train_micro(torch, run, cs.TRAIN_BATCH
                            // cfg.train_microbatches)
    del run
    real = ss.ssd_scan

    def grads(m, p, plain, fault=None):
        if fault is not None:
            ss.ssd_scan = (ss.ssd_scan_plain if fault == "plain"
                           else planted(real, fault))
        try:
            return cs._loss_grads(torch, m, p, micro, plain)
        finally:
            ss.ssd_scan = real

    def gap(what, a, b):
        (la, ga), (lb, gb) = a, b
        na, nb, rel = cs._grads_apart(torch, ga, gb)
        worst = max(rel, key=rel.get)
        cs.say(f"[gaps] {what}: loss {abs(la - lb) / abs(lb):.3g}, grad "
               f"norm {abs(na - nb) / nb:.3g}, largest gradient gap "
               f"{rel[worst]:.3g} ({worst}), median "
               f"{statistics.median(rel.values()):.3g} over {len(rel)} "
               f"weights")

    kernel = grads(model, params, False)
    gap("bf16, kernel path vs plain path", kernel,
        grads(model, params, True))
    gap("bf16, kernel path vs kernel 13's forward swapped for the plain "
        "scan (rounding floor)", kernel, grads(model, params, False,
                                              "plain"))
    del kernel, params
    cs._free(torch)
    m32, p32 = cs._f32_copy(torch, model)
    plain = grads(m32, p32, True)
    gap("f32, kernel path vs plain path", grads(m32, p32, False), plain)
    faults = [("scale", e) for e in SCALES] + [("restart", None)]
    for fault in faults:
        gap(f"f32, {describe(fault)} vs plain path",
            grads(m32, p32, False, fault), plain)
    del plain, m32, p32
    cs._free(torch)

    caught = []
    trainable = ss.ssd_scan_trainable

    def spy(x, log_a, b, c, chunk=128, h0=None):
        caught[:] = [(x, log_a, b, c, chunk)]
        return trainable(x, log_a, b, c, chunk, h0)

    ssm_mod._ssd.ssd_scan_trainable = spy
    try:
        with torch.no_grad():
            model.loss(micro)
    finally:
        ssm_mod._ssd.ssd_scan_trainable = trainable
    x, la, b, c, chunk = caught[0]
    gen = torch.Generator(device=cs.DEVICE).manual_seed(cs.SEED + 12)
    h0 = torch.randn((x.shape[0], x.shape[2], x.shape[3], b.shape[3]),
                     generator=gen, device=cs.DEVICE)
    y64, f64 = ss.ssd_scan_plain(x.double(), la.double(), b.double(),
                                 c.double(), chunk, h0.double())
    for fault in [None] + faults:
        fn = real if fault is None else planted(real, fault)
        with torch.no_grad():
            y, final = fn(x, la, b, c, chunk, h0)
        reads = []
        for name, got, want in (("y", y, y64), ("final", final, f64)):
            d, big = (got.double() - want).abs(), want.abs().max()
            ok = bool((d <= cs.SSD_TOL * want.abs()
                       + cs.SSD_TOL * big).all())
            reads.append(f"{name} {float(d.max() / big):.3g} of its "
                         f"largest |value| {'within' if ok else 'BEYOND'}")
        cs.say(f"[gaps] y gate ({tuple(x.shape)}), "
               f"{describe(fault) if fault else 'kernel 13'}: "
               + ", ".join(reads) + f" (rtol={cs.SSD_TOL:g} + "
               f"{cs.SSD_TOL:g} x max)")
    return 0


def describe(fault) -> str:
    kind, eps = fault
    if kind == "scale":
        return f"chunk {FAULT_CHUNK}'s y x (1 + {eps:g})"
    return f"the scan restarted at chunk {RESTART_CHUNK}"


if __name__ == "__main__":
    sys.exit(main())
