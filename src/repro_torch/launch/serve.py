"""Serving CLI: the port's continuous-batching engine on a model.

    PYTHONPATH=src python -m repro_torch.launch.serve --int8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced
    PYTHONPATH=src python -m repro_torch.launch.serve --int8 --tp 2
    PYTHONPATH=src python -m repro_torch.launch.serve --int8 --tp 2 \
        --device cpu --reduced

Runs on the card unless ``--device cpu`` is given.  Weights are random,
drawn from ``--seed`` (the port's ``Model.init``).  ``--tp N`` serves
the INT8 plan tensor-parallel over N ranks, each a process of its own
(``spawn``): with ``--backend gloo`` (the default) every rank uses the
one card (or the CPU), with ``--backend nccl`` rank r takes card r.  The
ranks draw the model one after another, each drawing only its shards
(every family; musicgen's audio frontend takes frame embeddings and is
refused by this token CLI), and every rank must produce the tokens of
the others.  Output goes through
:func:`~repro_torch.launch.console.emit`, the one place this package
writes to the terminal.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.parallel.context import BACKENDS, rank_device, spawn
from repro_torch.quant import QuantPlan
from repro_torch.serving import Request, RequestStatus, ServingEngine
from .console import emit


def _config(args: dict):
    cfg = get_config(args["arch"])
    return reduced_config(cfg) if args["reduced"] else cfg


def _requests(cfg, args: dict) -> list[Request]:
    rng = np.random.default_rng(args["seed"])
    reqs = []
    for i in range(args["requests"]):
        plen = int(rng.integers(4, 14))
        reqs.append(Request(
            uid=i, prompt=rng.integers(0, cfg.vocab, plen).astype(np.int32),
            max_new_tokens=args["max_new"],
            temperature=args["temperature"], top_k=40, seed=args["seed"]))
    return reqs


def _serve(model, reqs: list[Request], args: dict, tp=None):
    """Serve ``reqs`` to the end; returns (engine, seconds)."""
    engine = ServingEngine(
        model, n_slots=args["slots"], max_len=args["max_len"],
        prefill_bucket=16,
        quant_plan=QuantPlan.full() if args["int8"] else None, tp=tp)
    for r in reqs:
        engine.submit(r)
    t0 = time.perf_counter()
    engine.run_until_done()
    return engine, time.perf_counter() - t0


def _serve_rank(group, args: dict) -> dict:
    """One tensor-parallel rank: draw this rank's shards of the model, in
    turn, and serve the requests; returns what rank 0 reports."""
    from repro_torch.parallel.sharding import build_in_turns
    device = rank_device(args["device"], args["backend"], group.rank)
    cfg = _config(args)

    def build():
        model = Model(cfg).init(args["seed"], device=device, tp=group,
                                plan=QuantPlan.full())
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        return model

    model = build_in_turns(group, build)
    reqs = _requests(cfg, args)
    engine, seconds = _serve(model, reqs, args, tp=group)
    return dict(device=str(device), seconds=seconds,
                tokens_out=engine.stats.tokens_out,
                decode_steps=engine.stats.decode_steps,
                occupancy=engine.stats.batch_occupancy,
                results=[(r.uid, r.status.value, list(r.generated))
                         for r in reqs])


def main(argv: list[str] | None = None) -> list[Request]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma-2b")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reduced smoke config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--int8", action="store_true",
                    help="serve the full INT8 QuantPlan (CUDA kernels on "
                         "the card, their plain versions on the CPU)")
    ap.add_argument("--tp", type=int, default=0,
                    help="serve tensor-parallel over this many ranks "
                         "(needs --int8)")
    ap.add_argument("--backend", choices=BACKENDS, default="gloo",
                    help="process-group backend of --tp: gloo (ranks "
                         "share one card or the CPU) or nccl (a card per "
                         "rank)")
    args = vars(ap.parse_args(argv))
    if args["tp"] and not args["int8"]:
        ap.error("--tp serves the INT8 plan: add --int8")
    cfg = _config(args)
    if cfg.frontend == "audio":
        raise SystemExit("audio-frontend archs need embedding inputs; "
                         "use the token-backbone archs for this CLI")

    if args["tp"]:
        device = resolve_device(args["device"])   # no card: raises here
        ranks = spawn(_serve_rank, args["tp"], args=(args,),
                      backend=args["backend"])
        out = ranks[0]
        reqs = _requests(cfg, args)
        for r, (_uid, status, generated) in zip(reqs, out["results"]):
            r.generated, r.status = generated, RequestStatus(status)
        where = f"{args['tp']} ranks on {device.type} ({args['backend']})"
        seconds, tokens = out["seconds"], out["tokens_out"]
        steps, occupancy = out["decode_steps"], out["occupancy"]
    else:
        model = Model(cfg).init(args["seed"], device=args["device"])
        reqs = _requests(cfg, args)
        engine, seconds = _serve(model, reqs, args)
        where = str(model.device)
        tokens, steps = engine.stats.tokens_out, engine.stats.decode_steps
        occupancy = engine.stats.batch_occupancy
    occ = float(np.mean(occupancy)) if occupancy else 0.0
    emit(f"served {len(reqs)} requests on {where}: {tokens} tokens in "
         f"{seconds:.2f}s ({tokens / seconds:.1f} tok/s), {steps} decode "
         f"steps, mean occupancy {occ:.2f}")
    for r in reqs[:4]:
        emit(f"  req {r.uid} [{r.status.value}]: prompt[{len(r.prompt)}] "
             f"-> {r.generated}")
    return reqs


if __name__ == "__main__":
    main()
