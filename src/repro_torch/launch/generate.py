"""Image-generation CLI: the port's diffusion engine on a DiT.

    PYTHONPATH=src python -m repro_torch.launch.generate --int8
    PYTHONPATH=src python -m repro_torch.launch.generate --arch dit-test \
        --device cpu --int8 --cfg 4 --method euler

Runs on the card unless ``--device cpu`` is given (the kernels' plain
versions on the CPU).  Weights are random, drawn from ``--seed`` (the
port's ``DiTModel.init``).  ``--int8`` serves the full INT8 plan: 6
plan launches per DiT block, beside one launch of kernel 12 for the
block's attention on the card.  ``--cfg W`` turns on classifier-free
guidance (the conditional and null-label rows stacked into one batch).
Output goes through :func:`~repro_torch.launch.console.emit`.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import DIT_ARCH_IDS, get_dit_config
from repro_torch.diffusion import DiffusionEngine, ImageRequest
from repro_torch.models.dit import DiTModel
from repro_torch.quant import QuantPlan
from .console import emit


def main(argv: list[str] | None = None) -> list[ImageRequest]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=DIT_ARCH_IDS, default="dit-xl-2")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--int8", action="store_true",
                    help="serve the full INT8 QuantPlan (CUDA kernels on "
                         "the card, their plain versions on the CPU)")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--cfg", type=float, default=0.0,
                    help="classifier-free guidance scale (0 = off)")
    ap.add_argument("--method", choices=("ddim", "euler"), default="ddim")
    ap.add_argument("--images", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_dit_config(args.arch)
    model = DiTModel(cfg).init(args.seed, device=args.device)
    engine = DiffusionEngine(
        model, batch_size=args.batch,
        quant_plan=QuantPlan.full() if args.int8 else None)
    rng = np.random.default_rng(args.seed)
    reqs = [ImageRequest(uid=i, label=int(rng.integers(cfg.n_classes)),
                         num_steps=args.steps, cfg_scale=args.cfg,
                         method=args.method, seed=args.seed + 1)
            for i in range(args.images)]
    for r in reqs:
        engine.submit(r)
    t0 = time.perf_counter()
    engine.run_until_done()
    dt = time.perf_counter() - t0
    st = engine.stats
    plan = ", full int8 plan" if args.int8 else ""
    emit(f"generated {st.images_out} latents of {args.arch} "
         f"({cfg.tokens} tokens each) on {model.device}{plan} in "
         f"{dt:.2f}s ({st.images_out / dt:.2f} images/s)")
    emit(f"batches: {st.batches}, denoise steps per batch: {args.steps}, "
         f"evaluations of {2 * args.batch if args.cfg > 0 else args.batch} "
         f"rows: {st.denoise_steps}, mean batch occupancy: "
         f"{np.mean(st.batch_occupancy):.2f}")
    for r in reqs[:3]:
        lat = r.latents
        emit(f"  img {r.uid} [{r.status.value}]: class {r.label:4d} -> "
             f"latent {lat.shape}, mean {lat.mean():+.3f}, "
             f"std {lat.std():.3f}")
    return reqs


if __name__ == "__main__":
    main()
