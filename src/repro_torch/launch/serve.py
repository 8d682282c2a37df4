"""Serving CLI: the port's continuous-batching engine on a model.

    PYTHONPATH=src python -m repro_torch.launch.serve --int8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced

Runs on the card unless ``--device cpu`` is given.  Weights are random,
drawn from ``--seed`` (the port's ``Model.init``).  Output goes through
:func:`emit`, the one place this package writes to the terminal.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.models import Model
from repro_torch.quant import QuantPlan
from repro_torch.serving import Request, ServingEngine


def emit(*parts, sep: str = " ") -> None:
    """Write one line to stdout (the CLI reporting channel)."""
    sys.stdout.write(sep.join(str(p) for p in parts) + "\n")


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
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    model = Model(cfg).init(args.seed, device=args.device)
    engine = ServingEngine(model, n_slots=args.slots, max_len=args.max_len,
                           prefill_bucket=16,
                           quant_plan=QuantPlan.full() if args.int8 else None)

    rng = np.random.default_rng(args.seed)
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(4, 14))
        reqs.append(Request(
            uid=i, prompt=rng.integers(0, cfg.vocab, plen).astype(np.int32),
            max_new_tokens=args.max_new, temperature=args.temperature,
            top_k=40, seed=args.seed))
        engine.submit(reqs[-1])

    t0 = time.perf_counter()
    engine.run_until_done()
    dt = time.perf_counter() - t0
    st = engine.stats
    occ = float(np.mean(st.batch_occupancy)) if st.batch_occupancy else 0.0
    emit(f"served {len(reqs)} requests on {model.device}: {st.tokens_out} "
         f"tokens in {dt:.2f}s ({st.tokens_out / dt:.1f} tok/s), "
         f"{st.decode_steps} decode steps, mean occupancy {occ:.2f}")
    for r in reqs[:4]:
        emit(f"  req {r.uid} [{r.status.value}]: prompt[{len(r.prompt)}] "
             f"-> {r.generated}")
    return reqs


if __name__ == "__main__":
    main()
