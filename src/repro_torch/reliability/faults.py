"""Seeded, deterministic CIM weight-memory fault models (port of
``repro/reliability/faults.py``).

The paper's CIM-MXU keeps int8 weights *resident* in SRAM macros
(weight-stationary, §III-B), so the dominant hardware failure mode is
not transient datapath noise but corruption of the stored weight bits:
retention upsets, stuck cells, and whole-column (bit-line / sense-amp)
failures inside a macro.

This module injects exactly those faults into the software mirror of the
resident weights, the int8 ``q`` buffers of the model's
:class:`~repro_torch.quant.QuantizedLinear` leaves, per the CIM-tile
geometry of the simulator's MXU model (``CIMCoreConfig``: a macro stores
a ``k_dim x n_dim`` block; a column failure takes out one output channel
across one macro's k-rows).

Everything is host-side numpy on uint8 bit views and fully deterministic
from ``FaultConfig.seed``, so a campaign is replayable bit for bit and
equal to the reference's: the reference stacks each group's layers on a
leading axis and draws one stream per stacked leaf, seeded from the
leaf's tree path, so :func:`quantized_leaves` gathers the port's
per-layer buffers into those stacks under the reference's path strings
(:func:`repro_torch.convert.quantized_paths`), :func:`inject_tree`
injects them as the reference does, and :func:`load_leaves` writes the
result back into the model's buffers in place.

Mitigations modeled alongside:

* :func:`protect_tree` — outlier-channel protection: the requant guard
  keeps a pristine copy of the output channels with the largest
  per-channel ``scale`` (where a flipped int8 MSB causes the largest
  absolute weight error, ``err = dq * scale``) and restores them after
  injection.
* :func:`ecc_residual_ber` — the residual bit-error rate after an
  in-macro SECDED(72,64) code, costed by the simulator's
  ``EnergyModel.with_cim_ecc`` (:mod:`repro_torch.core.energy`).
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

FAULT_KINDS = ("bit_flip", "stuck_at_0", "stuck_at_1", "column_kill")


@dataclass(frozen=True)
class FaultConfig:
    """One fault-injection campaign over a weight tree.

    ``ber`` is the per-*bit* error probability for the bit-level kinds,
    and the per-(tile, column) failure probability for ``column_kill``.
    ``tile_k``/``tile_n`` default to the paper's CIM macro geometry
    (``CIMCoreConfig``: 128 x 256); use :meth:`from_mxu` to take them
    from a simulator MXU model.
    """

    kind: str = "bit_flip"
    ber: float = 0.0
    seed: int = 0
    tile_k: int = 128   # macro rows (reduction dim) — CIMCoreConfig.k_dim
    tile_n: int = 256   # macro cols (output dim)    — CIMCoreConfig.n_dim

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if not 0.0 <= self.ber <= 1.0:
            raise ValueError(f"ber must be in [0, 1], got {self.ber}")

    @classmethod
    def from_mxu(cls, mxu, **kw) -> "FaultConfig":
        """Tile geometry from a simulator ``CIMMXUConfig``
        (:mod:`repro_torch.core.hardware`)."""
        return cls(tile_k=mxu.core.k_dim, tile_n=mxu.core.n_dim, **kw)


@dataclass
class FaultReport:
    """What a deterministic injection campaign actually touched."""

    kind: str = ""
    ber: float = 0.0
    seed: int = 0
    leaves: int = 0            # QuantizedLinear leaves visited
    total_bits: int = 0        # bits at risk (8 * int8 elements)
    faults: int = 0            # bits flipped/stuck, or cells zeroed
    per_leaf: dict = None      # path -> fault count

    def __post_init__(self):
        if self.per_leaf is None:
            self.per_leaf = {}


# ---------------------------------------------------------------------------
# Single-tensor injection
# ---------------------------------------------------------------------------
def inject_int8(q: np.ndarray, cfg: FaultConfig,
                rng: np.random.Generator) -> tuple[np.ndarray, int]:
    """Inject ``cfg`` faults into one int8 tensor; returns (copy, count).

    Bit-level kinds draw the fault count from Binomial(bits, ber) and
    place faults uniformly over the flat uint8 bit view — ``bit_flip``
    XORs, ``stuck_at_0``/``stuck_at_1`` AND/OR a mask (so a cell stuck
    at its current value is correctly a no-op).  ``column_kill`` views
    the tensor as [rows, out_channels] (output channels on the last
    axis, all leading axes flattened — the layout the fused kernels
    stream), carves it into ``tile_k``-row x single-column macro cells,
    and zeroes whole cells with probability ``ber`` each: one dead
    bit-line takes out one output channel within one resident macro.
    """
    if q.dtype != np.int8:
        raise TypeError(f"expected int8 weights, got {q.dtype}")
    out = np.array(q, copy=True)
    if cfg.ber <= 0.0 or out.size == 0:
        return out, 0

    if cfg.kind == "column_kill":
        cols = out.shape[-1]
        rows = out.size // cols
        q2 = out.reshape(rows, cols)
        n_slabs = -(-rows // cfg.tile_k)              # ceil
        kill = rng.random((n_slabs, cols)) < cfg.ber  # per macro cell
        killed = 0
        for s, j in zip(*np.nonzero(kill)):
            lo = s * cfg.tile_k
            hi = min(lo + cfg.tile_k, rows)
            q2[lo:hi, j] = 0
            killed += hi - lo
        return out, killed

    flat = out.reshape(-1).view(np.uint8)
    n_bits = flat.size * 8
    k = int(rng.binomial(n_bits, cfg.ber))
    if k == 0:
        return out, 0
    pos = rng.choice(n_bits, size=k, replace=False)
    byte_idx = pos // 8
    mask = (np.uint8(1) << (pos % 8).astype(np.uint8))
    if cfg.kind == "bit_flip":
        np.bitwise_xor.at(flat, byte_idx, mask)
    elif cfg.kind == "stuck_at_0":
        np.bitwise_and.at(flat, byte_idx, np.uint8(0xFF) ^ mask)
    else:  # stuck_at_1
        np.bitwise_or.at(flat, byte_idx, mask)
    return out, k


# ---------------------------------------------------------------------------
# The model's stacked leaves
# ---------------------------------------------------------------------------
class Leaf(NamedTuple):
    """One stacked quantized leaf on the host: ``q`` int8 [L, ...] and
    ``scale`` f32 [L, ...], layer j being the j-th module of its path."""

    q: np.ndarray
    scale: np.ndarray


def quantized_leaves(model) -> dict[str, Leaf]:
    """The reference's path -> the stacked host copy of the model's
    quantized leaves under it (:func:`repro_torch.convert.quantized_paths`),
    in the reference's shapes: qkv q [L, d, H + 2 KH, Dh], o q [L, H, Dh,
    d], MoE expert stacks q [L, E, K, N] with scale [L, E, N]."""
    from repro_torch.convert import quantized_paths
    return {path: Leaf(np.stack([m.q.cpu().numpy() for m in mods]),
                       np.stack([m.scale.cpu().numpy() for m in mods]))
            for path, mods in quantized_paths(model).items()}


@torch.no_grad()
def load_leaves(model, leaves: dict[str, Leaf]) -> None:
    """Write stacked leaves back into the model's buffers in place
    (``copy_``: no buffer is reallocated, so addresses and shapes stay,
    as a captured CUDA graph needs).  Every path must be one of the
    model's, with the shapes :func:`quantized_leaves` gives."""
    from repro_torch.convert import quantized_paths
    paths = quantized_paths(model)
    if set(leaves) - set(paths):
        raise KeyError(f"not leaves of this model: "
                       f"{sorted(set(leaves) - set(paths))}")
    for path, leaf in leaves.items():
        mods = paths[path]
        if leaf.q.shape != (len(mods), *mods[0].q.shape):
            raise ValueError(f"{path}: q {leaf.q.shape} does not stack "
                             f"{len(mods)} x {tuple(mods[0].q.shape)}")
        for j, m in enumerate(mods):
            m.q.copy_(torch.from_numpy(leaf.q[j]))
            m.scale.copy_(torch.from_numpy(leaf.scale[j]))


def _leaf_rng(path: str, cfg: FaultConfig) -> np.random.Generator:
    """Independent, replayable stream per leaf: the campaign seed mixed
    with a stable hash of the tree path (order-independent)."""
    return np.random.default_rng((cfg.seed, zlib.crc32(path.encode())))


def inject_tree(leaves: dict[str, Leaf],
                cfg: FaultConfig) -> tuple[dict[str, Leaf], FaultReport]:
    """Inject faults into every leaf's ``q`` (:func:`quantized_leaves`).

    Only the int8 resident-weight tensors are touched — scales pass
    through unchanged.  Returns new leaves (the inputs are not modified)
    plus a :class:`FaultReport`, both equal to the reference's
    ``inject_tree`` on the same stacked tree."""
    report = FaultReport(kind=cfg.kind, ber=cfg.ber, seed=cfg.seed)
    out = {}
    for path, leaf in leaves.items():
        faulted, n = inject_int8(leaf.q, cfg, _leaf_rng(path, cfg))
        report.leaves += 1
        report.total_bits += leaf.q.size * 8
        if n:
            report.faults += n
            report.per_leaf[path] = n
        out[path] = Leaf(faulted, leaf.scale)
    return out, report


def protect_tree(clean: dict[str, Leaf], faulted: dict[str, Leaf],
                 fraction: float = 0.05) -> dict[str, Leaf]:
    """Outlier-channel protection: restore the top-``fraction`` output
    channels (ranked by mean |scale| — where requant amplifies a flipped
    bit the most, ``err = dq * scale``) of every faulted leaf from the
    pristine one.

    Channels are the last axis of ``q`` (the axis the fused kernels emit
    and every ``scale`` layout reduces onto); the per-channel score
    averages |scale| over any extra structure axes (layers, heads,
    experts)."""
    if not 0.0 <= fraction <= 1.0:
        raise ValueError(f"fraction must be in [0, 1], got {fraction}")
    out = {}
    for path, f in faulted.items():
        c = clean[path]
        n = c.q.shape[-1]
        n_protect = int(np.ceil(fraction * n))
        if n_protect == 0:
            out[path] = f
            continue
        scale = np.abs(np.asarray(c.scale, np.float32))
        if scale.shape and scale.shape[-1] == n:
            score = scale.reshape(-1, n).mean(axis=0)
        else:  # scale laid out on other axes
            score = np.full(n, scale.mean(), np.float32)
        chans = np.argsort(score)[-n_protect:]
        q = np.array(f.q, copy=True)
        q[..., chans] = c.q[..., chans]
        out[path] = Leaf(q, f.scale)
    return out


# ---------------------------------------------------------------------------
# ECC model (SECDED 72,64 — the classic DRAM/SRAM word code)
# ---------------------------------------------------------------------------
def ecc_residual_ber(ber: float, data_bits: int = 64,
                     code_bits: int = 72) -> float:
    """Residual per-data-bit error rate after in-macro SECDED.

    A (72,64) word corrects any single bit error; a word is uncorrectable
    when >= 2 of its ``code_bits`` are hit:

        W = 1 - (1-p)^72 - 72 p (1-p)^71

    An uncorrectable word at these rates almost surely carries exactly 2
    flipped bits, so the residual rate per data bit is ~ ``2 W / 64``
    (double-error miscorrection noise folded into the same constant).
    At p = 1e-4 this is ~8e-7 — 2 orders of magnitude suppression; the
    energy/area price is costed by ``EnergyModel.with_cim_ecc``.
    """
    if not 0.0 <= ber <= 1.0:
        raise ValueError(f"ber must be in [0, 1], got {ber}")
    p, n = float(ber), code_bits
    w_ok = (1 - p) ** n + n * p * (1 - p) ** (n - 1)
    return min(1.0, 2.0 * max(0.0, 1.0 - w_ok) / data_bits)
