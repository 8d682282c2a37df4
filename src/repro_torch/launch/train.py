"""Training entry point (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --reduced --steps 50 --batch 8 --seq 64 --device cpu

Runs on the card unless ``--device cpu`` is given.  ``--reduced`` trains
the smoke-scale config of the chosen architecture; without it the full
width (random weights from ``--seed``).  The data pipeline, the
optimizer (AdamW, bf16 moments above 1e11 parameters), gradient
accumulation over the config's ``train_microbatches``, checkpointing
and straggler detection are the library's.  Output goes through
:func:`~repro_torch.launch.console.emit`.
"""
from __future__ import annotations

import argparse
import json

from repro_torch import optim
from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.data import for_model
from repro_torch.device import resolve_device
from repro_torch.launch.console import emit
from repro_torch.launch.steps import build_train_step, optimizer_config
from repro_torch.models import Model
from repro_torch.training import Trainer, TrainerConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--checkpoint-dir", default="checkpoints/train")
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    model = Model(cfg).init(args.seed, device=resolve_device(args.device))
    n_params = sum(p.numel() for p in model.parameters())
    emit(f"arch={cfg.name} params={n_params/1e6:.2f}M "
         f"layers={cfg.n_layers} groups={len(cfg.layer_groups())}")

    ocfg = optim.AdamWConfig(learning_rate=args.lr,
                             moment_dtype=optimizer_config(cfg).moment_dtype)
    step = build_train_step(cfg, model, ocfg)
    opt_state = optim.init(ocfg, step.params)
    pipe = for_model(cfg, batch=args.batch, seq_len=args.seq,
                     seed=args.seed)
    tcfg = TrainerConfig(total_steps=args.steps,
                         checkpoint_every=args.checkpoint_every,
                         log_every=5, checkpoint_dir=args.checkpoint_dir)
    trainer = Trainer(model, step, opt_state, pipe, tcfg)
    out = trainer.run()
    emit(json.dumps({"final_step": out["final_step"],
                     "final_loss": out["final_loss"],
                     "stragglers": len(out["stragglers"])}))
    for rec in out["history"]:
        emit(f"  step {rec['step']:5d} loss {rec['loss']:.4f} "
             f"dt {rec['dt']*1e3:.0f}ms")


if __name__ == "__main__":
    main()
