"""Dry run of every (architecture x input shape) cell on a grid (port
of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell's production step over 512
forced host devices and reads XLA's memory and cost analyses.  Here each
cell's step (``launch.steps.build_step``) is built on torch's ``meta``
device at full width, unquantized, as the reference's is: the model,
the AdamW state (bf16 moments above 1e11 parameters), the cache at the
cell's batch x sequence, the inputs of ``configs.input_specs``.  Nothing
is allocated and nothing runs.  Each record holds:

* ``memory.argument_bytes_per_device``: each argument leaf's shard
  under ``parallel.sharding.resolve_spec`` on the grid, summed (the
  parameters, the optimizer state or the cache, the inputs): the
  counterpart of XLA's ``argument_size_in_bytes``;
  ``temp_bytes_per_device`` (XLA's scratch) has no counterpart without
  a compiler and is null, so ``total_bytes_per_device`` is the
  arguments';
* ``fits``: whether the arguments fit 80 GiB, and ``fits_card`` the
  card's ``torch.cuda.mem_get_info()`` total (null without a card);
* ``cache_bytes``: the port's cache leaves whole (the int8 KV cache's
  scales, positions and write index included) beside the reference's
  analytic ``_cache_bytes`` (an int8 element at ``1 + 4 / head_dim``
  bytes, no positions);
* ``roofline``: the roofline row on the H100 (``launch.roofline``);
* ``params``: ``param_count()``.

Usage:
    python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--single-pod-only]
    python -m repro_torch.launch.dryrun --all --grid 1x1
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Optional

import torch

from repro_torch.configs import (ARCH_IDS, ASSIGNED_SHAPES, SHAPES,
                                 cell_applicable, get_config)
from repro_torch.launch import roofline as rf
from repro_torch.launch.console import emit
from repro_torch.launch.mesh import (grid_name, make_production_mesh,
                                     mesh_chip_count, parse_grid)
from repro_torch.launch.steps import build_step
from repro_torch.parallel.sharding import DEFAULT_RULES, shard_nbytes

OUT_DIR = Path("experiments/dryrun_torch")
FIT_BYTES = 80 * 2 ** 30


def _leaves(tree, specs):
    """(tensor, spec) of every leaf of an argument tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, specs[k])
    elif isinstance(tree, (list, tuple)):
        for v, s in zip(tree, specs):
            yield from _leaves(v, s)
    else:
        yield tree, specs


def card_bytes() -> Optional[int]:
    """The card's memory (``mem_get_info``'s total), None without one."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.mem_get_info()[1]


def run_cell(arch: str, shape: str, grid: dict, verbose: bool = True,
             kv_int8: bool = False, replicate_params: bool = False) -> dict:
    cfg = get_config(arch)
    if kv_int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    # serving-side: small models skip FSDP entirely
    rules = dict(DEFAULT_RULES, fsdp=()) if replicate_params else None
    name = grid_name(grid)
    record: dict = {"arch": arch, "shape": shape, "mesh": name,
                    "variant": {"kv_int8": kv_int8,
                                "replicate_params": replicate_params}}
    ok, reason = cell_applicable(cfg, shape)
    if not ok:
        record.update(status="skipped", reason=reason)
        return record

    t0 = time.time()
    chips = mesh_chip_count(grid)
    try:
        bundle = build_step(cfg, grid, shape, rules)
        arg_bytes = sum(shard_nbytes(t, s, grid)
                        for t, s in _leaves(bundle.args, bundle.specs))
        off_meta = [t.device for t, _ in _leaves(bundle.args, bundle.specs)
                    if not t.is_meta]
        if off_meta:
            raise RuntimeError(f"a dry-run leaf is not on meta: "
                               f"{off_meta[0]}")
    except Exception as e:  # noqa: BLE001 - report per-cell failures
        record.update(status="failed", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-2000:])
        return record
    t_build = time.time() - t0
    cache_whole = (sum(t.numel() * t.element_size()
                       for t, _ in _leaves(bundle.args[2], bundle.specs[2]))
                   if bundle.kind != "train" else 0)
    cell = SHAPES[shape]
    cache_analytic = (rf._cache_bytes(cfg, cell.global_batch, cell.seq_len)
                      if bundle.kind != "train" else 0.0)
    mem_d = {"argument_bytes_per_device": arg_bytes,
             "temp_bytes_per_device": None,
             "total_bytes_per_device": arg_bytes}
    card = card_bytes()
    report = rf.analyze(arch, shape, name, chips, None, cfg, cell,
                        chip=rf.H100)
    record.update(
        status="ok", chips=chips, build_s=round(t_build, 3),
        memory=mem_d, fits=arg_bytes <= FIT_BYTES,
        fits_card=None if card is None else arg_bytes <= card,
        card_bytes=card,
        cache_bytes={"port": cache_whole, "analytic": cache_analytic},
        roofline=report.row(), params=cfg.param_count(),
        collectives=report.collective_counts)
    if verbose:
        gib = arg_bytes / 2 ** 30
        emit(f"[{arch} x {shape} x {name}] OK {gib:.2f} GiB/dev "
             f"fits={record['fits']} bottleneck={report.bottleneck} "
             f"roofline={report.roofline_fraction:.3f} "
             f"step={report.step_s:.4g}s")
    return record


def record_name(arch: str, shape: str, grid: dict, kv_int8: bool = False,
                replicate_params: bool = False) -> str:
    suffix = ("__kvint8" if kv_int8 else "") + \
        ("__repl" if replicate_params else "")
    return f"{arch}__{shape}__{grid_name(grid)}{suffix}.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--grid", default=None,
                    help="one grid instead of the production ones: "
                         "DATAxMODEL or PODxDATAxMODEL (1x1: one card)")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 KV cache variant")
    ap.add_argument("--replicate-params", action="store_true",
                    help="no-FSDP serving variant")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--quiet", action="store_true",
                    help="one line a grid, not one a cell")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.grid:
        grids = [parse_grid(args.grid)]
    elif args.multi_pod:
        grids = [make_production_mesh(multi_pod=True)]
    elif args.single_pod_only:
        grids = [make_production_mesh()]
    else:
        grids = [make_production_mesh(), make_production_mesh(multi_pod=True)]
    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in ASSIGNED_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape required unless --all")
        cells = [(args.arch, args.shape)]

    failures = 0
    for grid in grids:
        tally = {"ok": 0, "skipped": 0, "failed": 0}
        for arch, shape in cells:
            rec = run_cell(arch, shape, grid, kv_int8=args.kv_int8,
                           replicate_params=args.replicate_params,
                           verbose=not args.quiet)
            name = record_name(arch, shape, grid, args.kv_int8,
                               args.replicate_params)
            (out_dir / name).write_text(json.dumps(rec, indent=2,
                                                   default=str))
            tally[rec["status"]] += 1
            if rec["status"] == "failed":
                failures += 1
                emit(f"[{arch} x {shape}] FAILED: {rec['error']}")
            elif rec["status"] == "skipped" and not args.quiet:
                emit(f"[{arch} x {shape}] SKIPPED: {rec['reason']}")
        emit(f"[{grid_name(grid)}] {len(cells)} cells: {tally['ok']} ok, "
             f"{tally['skipped']} skipped, {tally['failed']} failed")
    emit(f"\ndone: {len(cells) * len(grids)} cells, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
