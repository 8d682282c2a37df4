"""Production grids (port of ``repro/launch/mesh.py``).

A grid is an ordered mapping from mesh axis name to size: what the
reference's ``jax.make_mesh`` names, without devices.  The port runs one
process a rank and places nothing by a mesh; the dry run
(:mod:`repro_torch.launch.dryrun`) and the data-parallel train step
resolve the logical axes against a grid
(:func:`repro_torch.parallel.sharding.resolve_spec`).  Nothing here
touches a device.
"""
from __future__ import annotations

import math


def make_production_mesh(*, multi_pod: bool = False) -> dict:
    """16x16 = 256 chips a pod; 2x16x16 = 512 chips across two pods."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_smoke_mesh() -> dict:
    """1x1: one card."""
    return {"data": 1, "model": 1}


def parse_grid(text: str) -> dict:
    """``"16x16"`` -> data 16, model 16; ``"2x16x16"`` -> pod 2, data 16,
    model 16; ``"1x1"`` -> one card."""
    sizes = [int(s) for s in text.lower().split("x")]
    if len(sizes) not in (2, 3) or min(sizes) < 1:
        raise ValueError(f"a grid is DATAxMODEL or PODxDATAxMODEL, got "
                         f"{text!r}")
    names = ("data", "model") if len(sizes) == 2 else ("pod", "data",
                                                        "model")
    return dict(zip(names, sizes))


def grid_name(grid: dict) -> str:
    return "x".join(str(n) for n in grid.values())


def mesh_chip_count(grid: dict) -> int:
    return math.prod(grid.values())
