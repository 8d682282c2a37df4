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
``--tp N`` (with ``--int8``) serves tensor-parallel over N ranks, each a
process drawing only its shards (``--backend`` as the serve CLI's);
every rank must deliver the latents of the others.  Output goes through
:func:`~repro_torch.launch.console.emit`.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import DIT_ARCH_IDS, get_dit_config
from repro_torch.device import resolve_device
from repro_torch.diffusion import DiffusionEngine, ImageRequest
from repro_torch.models.dit import DiTModel
from repro_torch.parallel.context import BACKENDS, spawn
from repro_torch.quant import QuantPlan
from repro_torch.serving import RequestStatus
from .console import emit


def _requests(cfg, args) -> list[ImageRequest]:
    rng = np.random.default_rng(args.seed)
    return [ImageRequest(uid=i, label=int(rng.integers(cfg.n_classes)),
                         num_steps=args.steps, cfg_scale=args.cfg,
                         method=args.method, seed=args.seed + 1)
            for i in range(args.images)]


def _generate(model, reqs, args, tp=None):
    """Serve ``reqs`` to the end; returns (engine, seconds)."""
    engine = DiffusionEngine(
        model, batch_size=args.batch,
        quant_plan=QuantPlan.full() if args.int8 else None, tp=tp)
    for r in reqs:
        engine.submit(r)
    t0 = time.perf_counter()
    engine.run_until_done()
    return engine, time.perf_counter() - t0


def _generate_rank(group, args) -> dict:
    """One tensor-parallel rank: draw this rank's shards, in turn, and
    serve the requests; returns what rank 0 reports."""
    from repro_torch.parallel.context import rank_device
    from repro_torch.parallel.sharding import build_in_turns
    device = rank_device(args.device, args.backend, group.rank)
    cfg = get_dit_config(args.arch)
    model = build_in_turns(group, lambda: DiTModel(cfg).init(
        args.seed, device=device, tp=group, plan=QuantPlan.full()))
    reqs = _requests(cfg, args)
    engine, seconds = _generate(model, reqs, args, tp=group)
    st = engine.stats
    return dict(device=str(device), seconds=seconds,
                stats=(st.images_out, st.batches, st.denoise_steps,
                       st.batch_occupancy),
                results=[(r.status.value, r.latents) for r in reqs])


def parser() -> argparse.ArgumentParser:
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
    ap.add_argument("--tp", type=int, default=0,
                    help="serve tensor-parallel over this many ranks "
                         "(needs --int8)")
    ap.add_argument("--backend", choices=BACKENDS, default="gloo",
                    help="process-group backend of --tp")
    return ap


def main(argv: list[str] | None = None) -> list[ImageRequest]:
    ap = parser()
    args = ap.parse_args(argv)
    if args.tp and not args.int8:
        ap.error("--tp serves the INT8 plan: add --int8")

    cfg = get_dit_config(args.arch)
    reqs = _requests(cfg, args)
    if args.tp:
        where = resolve_device(args.device)      # no card: raises here
        out = spawn(_generate_rank, args.tp, args=(args,),
                    backend=args.backend)[0]
        for r, (status, latents) in zip(reqs, out["results"]):
            r.status, r.latents = RequestStatus(status), latents
        images, batches, evals, occupancy = out["stats"]
        where, dt = f"{args.tp} ranks on {where.type} ({args.backend})", \
            out["seconds"]
    else:
        model = DiTModel(cfg).init(args.seed, device=args.device)
        engine, dt = _generate(model, reqs, args)
        st = engine.stats
        images, batches, evals, occupancy = (
            st.images_out, st.batches, st.denoise_steps, st.batch_occupancy)
        where = str(model.device)
    plan = ", full int8 plan" if args.int8 else ""
    emit(f"generated {images} latents of {args.arch} "
         f"({cfg.tokens} tokens each) on {where}{plan} in "
         f"{dt:.2f}s ({images / dt:.2f} images/s)")
    emit(f"batches: {batches}, denoise steps per batch: {args.steps}, "
         f"evaluations of {2 * args.batch if args.cfg > 0 else args.batch} "
         f"rows: {evals}, mean batch occupancy: {np.mean(occupancy):.2f}")
    for r in reqs[:3]:
        lat = r.latents
        emit(f"  img {r.uid} [{r.status.value}]: class {r.label:4d} -> "
             f"latent {lat.shape}, mean {lat.mean():+.3f}, "
             f"std {lat.std():.3f}")
    return reqs


if __name__ == "__main__":
    main()
