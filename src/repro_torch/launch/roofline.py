"""Roofline terms of a (arch x shape x grid) cell (port of
``repro/launch/roofline.py``).

Three terms, in seconds:

    compute    = FLOPs / (chips * peak FLOP/s)
    memory     = bytes / (chips * memory bytes/s)
    collective = wire bytes a chip / (chips * link bytes/s)

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` and
the collectives from the optimized HLO text; the port has neither, so
the FLOPs and bytes are the analytic floors (:func:`analytic_floors`,
the reference's own lower bounds, which it takes wherever XLA counts
less: the values its rows hold when it is given no cost), and the
collectives are the ones a run counted (:class:`CollectiveMeter` on a
``TPGroup``: each collective's kind and input bytes), priced by the
reference's ring factors.

The chip is an argument: :data:`V5E` holds the reference's constants
under its names (``PEAK_FLOPS``, ``HBM_BW``, ``ICI_BW``), :data:`H100`
NVIDIA's H100 SXM data sheet at 700 W (989 TFLOP/s dense bf16, 3.35
TB/s HBM3, NVLink 450 GB/s each way).
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Optional

from repro_torch.launch.console import emit

# TPU v5e-like target constants (the reference's)
PEAK_FLOPS = 197e12          # bf16 FLOP/s per chip
HBM_BW = 819e9               # bytes/s per chip
ICI_LINKS = 4
ICI_BW_PER_LINK = 50e9       # bytes/s per link
ICI_BW = ICI_LINKS * ICI_BW_PER_LINK

# NVIDIA H100 SXM (80 GB HBM3) at 700 W, from its data sheet
H100_PEAK_FLOPS = 989e12     # bf16 FLOP/s dense (tensor cores)
H100_HBM_BW = 3.35e12        # bytes/s
H100_NVLINK_BW = 450e9       # bytes/s each way


@dataclass(frozen=True)
class Chip:
    name: str
    peak_flops: float
    hbm_bw: float
    link_bw: float


V5E = Chip("tpu-v5e", PEAK_FLOPS, HBM_BW, ICI_BW)
H100 = Chip("h100-sxm", H100_PEAK_FLOPS, H100_HBM_BW, H100_NVLINK_BW)
CHIPS = {c.name: c for c in (V5E, H100)}


# wire-bytes factor per participant for a ring implementation, as a
# function of result bytes R and group size n
def _wire_factor(op: str, n: int) -> float:
    if n <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (n - 1) / n          # reduce-scatter + all-gather
    if op == "all-gather":
        return (n - 1) / n                # result is the gathered tensor
    if op == "reduce-scatter":
        return (n - 1) * 1.0              # result is the scattered shard
    if op == "all-to-all":
        return (n - 1) / n
    if op == "collective-permute":
        return 1.0
    return 1.0


# the port's collective kinds (``TPGroup.counts``, the pipeline's hops)
# as the reference's HLO ops
KIND_OPS = {"max": "all-reduce", "sum": "all-reduce",
            "gather": "all-gather", "bcast": "all-gather",
            "hop": "collective-permute"}


@dataclass
class CollectiveStats:
    counts: dict
    result_bytes: dict
    wire_bytes_per_chip: float

    @property
    def total_result_bytes(self) -> float:
        return sum(self.result_bytes.values())


def collective_stats(counts: dict, input_bytes: dict,
                     group_size: int) -> CollectiveStats:
    """The reference's ``parse_collectives`` for counted collectives:
    ``counts`` and ``input_bytes`` by the port's kind (a ``TPGroup``'s
    counts, a :class:`CollectiveMeter`'s bytes) over a group of
    ``group_size`` ranks.  A gather's result is its ranks' inputs
    together, every other kind's its input; each is priced by its op's
    ring factor."""
    out_counts: dict = {}
    result: dict = {}
    wire = 0.0
    for kind, n in counts.items():
        if not n:
            continue
        op = KIND_OPS[kind]
        b = input_bytes.get(kind, 0) * (group_size if op == "all-gather"
                                        else 1)
        out_counts[op] = out_counts.get(op, 0) + n
        result[op] = result.get(op, 0) + b
        wire += b * _wire_factor(op, group_size)
    return CollectiveStats(out_counts, result, wire)


@dataclass
class CollectiveMeter:
    """Counts a group's collectives and their input bytes by kind while
    it is the group's ``observer`` (``with CollectiveMeter(group) as
    m:``); :meth:`stats` prices them."""
    group: object
    counts: dict = field(default_factory=dict)
    input_bytes: dict = field(default_factory=dict)

    def __call__(self, kind: str, t) -> None:
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.input_bytes[kind] = (self.input_bytes.get(kind, 0)
                                  + t.numel() * t.element_size())

    def __enter__(self) -> "CollectiveMeter":
        if self.group.observer is not None:
            raise RuntimeError("the group already has an observer")
        self.group.observer = self
        return self

    def __exit__(self, *exc) -> None:
        self.group.observer = None

    def stats(self) -> CollectiveStats:
        return collective_stats(self.counts, self.input_bytes,
                                self.group.size)


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    floor_flops: float
    floor_bytes: float
    collective_wire_bytes: float
    collective_counts: dict
    model_flops: float
    compute_s: float
    memory_s: float
    collective_s: float
    chip: str = H100.name
    peak_flops: float = H100.peak_flops

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        return self.model_flops / max(1.0, self.floor_flops)

    @property
    def roofline_fraction(self) -> float:
        """MODEL_FLOPS throughput at the modelled step time against the
        chips' peak."""
        return (self.model_flops / max(1e-30, self.step_s)) / \
            (self.chips * self.peak_flops)

    def row(self) -> dict:
        d = asdict(self)
        d.update(bottleneck=self.bottleneck, step_s=self.step_s,
                 useful_flops_fraction=self.useful_flops_fraction,
                 roofline_fraction=self.roofline_fraction)
        return d


def model_flops(cfg, shape_cell) -> float:
    """Analytic *useful* FLOPs (6ND train; 2·N_active·D serve)."""
    n_active = cfg.active_param_count()
    B, S = shape_cell.global_batch, shape_cell.seq_len
    if shape_cell.step == "train":
        return 6.0 * n_active * B * S
    if shape_cell.step == "prefill":
        return 2.0 * n_active * B * S
    # decode: q_tokens per sequence (speculative verify counts all drafts)
    return 2.0 * n_active * B * getattr(shape_cell, "q_tokens", 1)


def _attention_flops(cfg, B: int, q_len: int, kv_len: int) -> float:
    """Quadratic attention FLOPs across the stack (QK^T + S·V)."""
    total = 0.0
    for mixer, _ in cfg.layer_specs():
        if mixer == "attn":
            eff = kv_len
            dh_qk = dh_v = cfg.head_dim
            h = cfg.n_heads
        elif mixer == "attn_local":
            eff = min(kv_len, cfg.sliding_window or kv_len)
            dh_qk = dh_v = cfg.head_dim
            h = cfg.n_heads
        elif mixer == "mla":
            eff = kv_len
            if q_len == 1:   # absorbed decode: scores+values vs latent
                dh_qk = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
                dh_v = cfg.mla.kv_lora_rank
            else:
                dh_qk = cfg.mla.qk_head_dim
                dh_v = cfg.mla.v_head_dim
            h = cfg.n_heads
        else:
            continue  # SSM/xLSTM quadratic-chunk part is negligible
        causal = 0.5 if (q_len == kv_len and q_len > 1) else 1.0
        total += 2.0 * B * q_len * eff * h * (dh_qk + dh_v) * causal
    return total


def _cache_bytes(cfg, B: int, kv_len: int, dtype_bytes: int = 2) -> float:
    """Bytes to read the full decode state once (KV/latent/SSM); an int8
    KV element counts ``1 + 4 / head_dim`` bytes (its f32 scale per
    position and head)."""
    kv_b = 1 + 4.0 / cfg.head_dim if cfg.kv_cache_dtype == "int8" \
        else dtype_bytes
    total = 0.0
    for mixer, _ in cfg.layer_specs():
        if mixer == "attn":
            total += 2 * B * kv_len * cfg.n_kv_heads * cfg.head_dim \
                * kv_b / dtype_bytes
        elif mixer == "attn_local":
            eff = min(kv_len, cfg.sliding_window or kv_len)
            total += 2 * B * eff * cfg.n_kv_heads * cfg.head_dim \
                * kv_b / dtype_bytes
        elif mixer == "mla":
            total += B * kv_len * (cfg.mla.kv_lora_rank +
                                   cfg.mla.qk_rope_head_dim)
        elif mixer == "mamba2":
            s = cfg.ssm
            total += B * s.n_heads(cfg.d_model) * s.head_dim * s.state_dim * 2
        elif mixer == "mlstm":
            x = cfg.xlstm
            di = int(x.mlstm_proj_factor * cfg.d_model)
            total += B * (di // x.n_heads) * di * 2
        elif mixer == "slstm":
            total += B * cfg.d_model * 4
    return total * dtype_bytes


def analytic_floors(cfg, cell) -> tuple[float, float]:
    """(executed FLOPs, bytes) lower bounds for one step.  Training runs
    about 8ND of matmul work with per-layer remat (2ND forward + 4ND
    backward + 2ND recompute), so a remat'd compute-bound step's useful
    share is at most 6/8."""
    B, S = cell.global_batch, cell.seq_len
    n_active = cfg.active_param_count()
    p_bytes = 2.0 * cfg.param_count()
    if cell.step == "train":
        fwd = 2.0 * n_active * B * S + _attention_flops(cfg, B, S, S)
        mult = 4.0 if cfg.remat else 3.0      # fwd + 2x bwd (+ recompute)
        flops = fwd * mult
        act_bytes = 6.0 * cfg.n_layers * B * S * cfg.d_model * 2
        return flops, 4.0 * p_bytes + act_bytes
    if cell.step == "prefill":
        flops = 2.0 * n_active * B * S + _attention_flops(cfg, B, S, S)
        return flops, p_bytes + 2.0 * _cache_bytes(cfg, B, S)
    # decode
    q = getattr(cell, "q_tokens", 1)
    flops = 2.0 * n_active * B * q + _attention_flops(cfg, B, q, S)
    return flops, p_bytes + _cache_bytes(cfg, B, S)


def analyze(arch: str, shape: str, mesh_name: str, chips: int,
            collectives: Optional[CollectiveStats], cfg, shape_cell,
            chip: Chip = H100) -> RooflineReport:
    """The cell's three terms on ``chips`` of ``chip``: FLOPs and bytes
    from :func:`analytic_floors`, the collectives' wire bytes from
    ``collectives`` (None: none)."""
    flops, nbytes = analytic_floors(cfg, shape_cell)
    coll = collectives or CollectiveStats({}, {}, 0.0)
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        floor_flops=flops, floor_bytes=nbytes,
        collective_wire_bytes=coll.wire_bytes_per_chip,
        collective_counts=coll.counts,
        model_flops=model_flops(cfg, shape_cell),
        compute_s=flops / (chips * chip.peak_flops),
        memory_s=nbytes / (chips * chip.hbm_bw),
        collective_s=coll.wire_bytes_per_chip / (chips * chip.link_bw),
        chip=chip.name, peak_flops=chip.peak_flops,
    )


def summarize(dryrun_dir: str = "experiments/dryrun_torch",
              mesh: str = "16x16", chip: Chip = H100) -> list[dict]:
    """The dry run's per-cell records (``launch.dryrun``) as the roofline
    table's rows, the terms re-derived on ``chip``."""
    from pathlib import Path

    from repro_torch.configs import SHAPES, get_config

    rows = []
    for p in sorted(Path(dryrun_dir).glob(f"*__{mesh}.json")):
        rec = json.loads(p.read_text())
        head = {"arch": rec["arch"], "shape": rec["shape"], "mesh": mesh}
        if rec.get("status") == "skipped":
            rows.append(dict(head, status="skipped", reason=rec["reason"]))
            continue
        if rec.get("status") != "ok":
            rows.append(dict(head, status=rec.get("status")))
            continue
        cfg = get_config(rec["arch"])
        if rec.get("variant", {}).get("kv_int8"):
            import dataclasses
            cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
        rep = analyze(rec["arch"], rec["shape"], mesh, rec["chips"], None,
                      cfg, SHAPES[rec["shape"]], chip=chip)
        rows.append(dict(
            head, status="ok", compute_s=rep.compute_s,
            memory_s=rep.memory_s, collective_s=rep.collective_s,
            bottleneck=rep.bottleneck,
            roofline_fraction=rep.roofline_fraction,
            useful_flops_fraction=rep.useful_flops_fraction,
            mem_gib_per_dev=(rec["memory"]["argument_bytes_per_device"]
                             / 2 ** 30),
            fits=rec["fits"], step_s=rep.step_s))
    return rows


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--chip", choices=list(CHIPS), default=H100.name)
    args = ap.parse_args()
    rows = summarize(args.dir, args.mesh, CHIPS[args.chip])
    emit(f"{'arch':22s} {'shape':12s} {'compute_s':>10s} {'memory_s':>10s} "
         f"{'coll_s':>9s} {'bottleneck':>10s} {'roofline':>9s} "
         f"{'GiB/dev':>8s} {'fits':>5s}")
    for r in rows:
        if r["status"] != "ok":
            emit(f"{r['arch']:22s} {r['shape']:12s} {r['status'].upper()}")
            continue
        emit(f"{r['arch']:22s} {r['shape']:12s} {r['compute_s']:10.4f} "
             f"{r['memory_s']:10.4f} {r['collective_s']:9.4f} "
             f"{r['bottleneck']:>10s} {r['roofline_fraction']:9.3f} "
             f"{r['mem_gib_per_dev']:8.2f} {str(r['fits']):>5s}")


if __name__ == "__main__":
    main()
