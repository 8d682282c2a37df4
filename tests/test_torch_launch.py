"""The port's launch layer against the JAX reference, on the CPU: the
shape cells and ``input_specs``, the configs' counts, the roofline
functions, the logical-axis rules and the dry run.

Everything here is arithmetic on shapes: the reference's side is
``abstract_params`` / ``abstract_cache`` / ``eval_shape`` and its
``resolve_spec`` on ``AbstractMesh`` grids (as ``tests/test_distribution.py``
builds them), the port's side ``meta`` tensors.  The roofline functions
and the specs are held exactly; the dry run's argument bytes equal a sum
over the reference's abstract arguments sharded by its own rules.
"""
from __future__ import annotations

import dataclasses
import functools
import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.utils._python_dispatch import TorchDispatchMode

from repro import optim as joptim
from repro.configs import SHAPES as JSHAPES
from repro.configs import cell_applicable as jcell_applicable
from repro.configs import get_config as jget_config
from repro.configs import input_specs as jinput_specs
from repro.launch import roofline as jrf
from repro.launch.steps import optimizer_config as joptimizer_config
from repro.models import build_model
from repro.parallel import sharding as jsh

from repro_torch.configs import (ARCH_IDS, ASSIGNED_SHAPES, SHAPES,
                                 cell_applicable, get_config, input_specs)
from repro_torch.launch import dryrun, mesh, roofline as rf
from repro_torch.launch.steps import build_step
from repro_torch.models import Model
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.context import TPGroup

GRIDS = {"1x1": {"data": 1, "model": 1},
         "16x16": {"data": 16, "model": 16},
         "2x16x16": {"pod": 2, "data": 16, "model": 16}}
RULES = {"default": sh.DEFAULT_RULES, "ep_wide": sh.EP_WIDE_RULES,
         "replicate_params": dict(sh.DEFAULT_RULES, fsdp=())}
JRULES = {"default": jsh.DEFAULT_RULES, "ep_wide": jsh.EP_WIDE_RULES,
          "replicate_params": dict(jsh.DEFAULT_RULES, fsdp=())}
DRYRUN_ARCHS = ("gemma-2b", "qwen2-moe-a2.7b", "zamba2-1.2b",
                "deepseek-v3-671b")
# the archs the reference sets long_context_capable for
LONG_CONTEXT = {"gemma3-4b", "zamba2-1.2b", "xlstm-350m",
                "deepseek-v3-671b"}


def _abstract_mesh(grid: dict) -> AbstractMesh:
    sizes, names = tuple(grid.values()), tuple(grid)
    try:
        return AbstractMesh(sizes, names)              # jax >= 0.5
    except TypeError:
        return AbstractMesh(tuple(zip(names, sizes)))  # jax 0.4.x


def _cfgs(arch, kv=None):
    jc, tc = jget_config(arch), get_config(arch)
    if kv:
        jc = dataclasses.replace(jc, kv_cache_dtype=kv)
        tc = dataclasses.replace(tc, kv_cache_dtype=kv)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _reference(arch: str):
    """(model, param shapes, param axes) of the full-width reference."""
    model = build_model(jget_config(arch))
    shapes, axes = model.abstract_params()
    return model, shapes, axes


def _flat(tree, is_leaf=None) -> dict:
    return {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _is_axes(a) -> bool:
    return a is None or isinstance(a, tuple)


# ---------------------------------------------------------------------------
# shape cells and configs
# ---------------------------------------------------------------------------
def test_shape_cells_match_reference():
    assert list(SHAPES) == list(JSHAPES)
    assert list(ASSIGNED_SHAPES) == ["train_4k", "prefill_32k",
                                     "decode_32k", "long_500k"]
    for name, cell in SHAPES.items():
        assert dataclasses.asdict(cell) == dataclasses.asdict(JSHAPES[name])


@pytest.mark.parametrize("shape", list(JSHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch, shape):
    jc, tc = _cfgs(arch)
    want, got = jinput_specs(jc, shape), input_specs(tc, shape)
    assert list(got) == list(want)
    for k, spec in want.items():
        assert got[k].is_meta
        assert tuple(got[k].shape) == tuple(spec.shape), k
        assert str(got[k].dtype).replace("torch.", "") == str(spec.dtype)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cells_and_counts_match_reference(arch):
    jc, tc = _cfgs(arch)
    assert tc.long_context_capable == jc.long_context_capable == (
        arch in LONG_CONTEXT)
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
    for shape in JSHAPES:
        assert cell_applicable(tc, shape) == jcell_applicable(jc, shape)


# ---------------------------------------------------------------------------
# the roofline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", list(JSHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_roofline_functions_match_reference(arch, shape):
    for kv in ("bfloat16", "int8"):
        jc, tc = _cfgs(arch, kv)
        jcell, cell = JSHAPES[shape], SHAPES[shape]
        B, S = cell.global_batch, cell.seq_len
        assert rf.model_flops(tc, cell) == jrf.model_flops(jc, jcell)
        for q, kvl in ((1, S), (S, S), (7, 100), (4, 1024)):
            assert rf._attention_flops(tc, B, q, kvl) == \
                jrf._attention_flops(jc, B, q, kvl)
        for db in (1, 2, 4):
            assert rf._cache_bytes(tc, B, S, db) == \
                jrf._cache_bytes(jc, B, S, db)
        assert rf.analytic_floors(tc, cell) == jrf.analytic_floors(jc, jcell)


@pytest.mark.parametrize("shape", list(JSHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analyze_on_v5e_matches_reference(arch, shape):
    """No HLO and no collectives: the reference's terms from its floors,
    on its own chip constants."""
    jc, tc = _cfgs(arch)
    for name, chips in (("16x16", 256), ("2x16x16", 512), ("1x1", 1)):
        want = jrf.analyze(arch, shape, name, chips, {}, "", jc,
                           JSHAPES[shape])
        got = rf.analyze(arch, shape, name, chips, None, tc,
                         SHAPES[shape], chip=rf.V5E)
        for k in ("compute_s", "memory_s", "collective_s", "model_flops",
                  "bottleneck", "step_s", "roofline_fraction",
                  "useful_flops_fraction"):
            assert getattr(got, k) == getattr(want, k), k
        # given no cost, the reference's FLOPs and bytes are its floors
        assert want.flops_undercounted
        assert (got.floor_flops, got.floor_bytes) == (want.hlo_flops,
                                                      want.hlo_bytes)
        row = dict(got.row(), hlo_flops=got.floor_flops,
                   hlo_bytes=got.floor_bytes, flops_undercounted=True)
        assert {k: v for k, v in row.items()
                if k not in ("chip", "peak_flops", "floor_flops",
                             "floor_bytes")} == want.row()


def test_chip_constants():
    assert (rf.PEAK_FLOPS, rf.HBM_BW, rf.ICI_BW) == (
        jrf.PEAK_FLOPS, jrf.HBM_BW, jrf.ICI_BW)
    assert (rf.H100.peak_flops, rf.H100.hbm_bw, rf.H100.link_bw) == (
        989e12, 3.35e12, 450e9)


def test_decode_32k_int8_hand_check():
    """gemma-2b at decode_32k with an int8 KV cache on one H100: the
    reference's cache bytes and floors, 13.2 ms of memory time."""
    cfg = dataclasses.replace(get_config("gemma-2b"), kv_cache_dtype="int8")
    cell = SHAPES["decode_32k"]
    assert rf._cache_bytes(cfg, 128, 32768) / 2 ** 30 == 36.5625
    assert rf._cache_bytes(get_config("gemma-2b"), 128, 32768) / 2 ** 30 \
        == 72.0
    flops, nbytes = rf.analytic_floors(cfg, cell)
    assert round(flops / 1e12, 3) == 1.260 and round(nbytes / 1e9, 2) == 44.27
    rep = rf.analyze("gemma-2b", "decode_32k", "1x1", 1, None, cfg, cell)
    assert rep.bottleneck == "memory"
    assert round(rep.memory_s * 1e3, 1) == 13.2
    assert round(rep.compute_s * 1e3, 2) == 1.27


def test_counted_collectives_price_as_parsed_hlo():
    """The counted collectives' wire bytes equal the reference's
    ``parse_collectives`` on HLO of the same ops over the same group:
    two f32[1024] all-reduces (MAX, SUM), one all-gather of f32[512]
    inputs (a f32[1024] result) and a hop of bf16[8,16]."""
    hlo = "\n".join([
        "  %a = f32[1024]{0} all-reduce(f32[1024]{0} %x), "
        "replica_groups={{0,1}}, to_apply=%max",
        "  %b = f32[1024]{0} all-reduce(f32[1024]{0} %y), "
        "replica_groups={{0,1}}, to_apply=%sum",
        "  %c = f32[1024]{0} all-gather(f32[512]{0} %z), "
        "replica_groups={{0,1}}, dimensions={0}",
        "  %d = bf16[8,16]{1,0} collective-permute(bf16[8,16]{1,0} %w), "
        "source_target_pairs={{0,1},{1,0}}"])
    want = jrf.parse_collectives(hlo, default_group=2)
    group = TPGroup()
    group.size = 2          # the meter prices a group of 2; nothing is sent
    with rf.CollectiveMeter(group) as meter:
        for kind, t in (("max", torch.zeros(1024)), ("sum", torch.zeros(1024)),
                        ("gather", torch.zeros(512)),
                        ("hop", torch.zeros(8, 16, dtype=torch.bfloat16))):
            meter(kind, t)
    assert group.observer is None
    got = meter.stats()
    assert got.counts == want.counts
    assert got.result_bytes == want.result_bytes
    assert got.wire_bytes_per_chip == want.wire_bytes_per_chip
    rep = rf.analyze("gemma-2b", "decode_32k", "1x2", 2, got,
                     get_config("gemma-2b"), SHAPES["decode_32k"])
    assert rep.collective_s == want.wire_bytes_per_chip / (2 * 450e9)
    assert rep.collective_counts == want.counts


def test_meter_sees_a_groups_collectives():
    group = TPGroup()
    with rf.CollectiveMeter(group) as meter:
        group.all_reduce_sum(torch.zeros(4, dtype=torch.int32))
        group.all_gather(torch.zeros(3, 2))
        group.broadcast(torch.zeros(5, dtype=torch.bfloat16), 0)
    assert meter.counts == {"sum": 1, "gather": 1, "bcast": 1}
    assert meter.input_bytes == {"sum": 16, "gather": 24, "bcast": 10}
    assert meter.stats().wire_bytes_per_chip == 0.0      # a group of 1


# ---------------------------------------------------------------------------
# the logical axes and the rules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_match_reference(arch):
    """By the reference's path, a block's leaf with its layer index last:
    the reference's stacked axes less the leading "layers"."""
    _, shapes, axes = _reference(arch)
    want = _flat(axes, _is_axes)
    got = sh.param_axes(Model(get_config(arch)))
    assert len(got) == sum(
        s.shape[0] if k.startswith("['group_") else 1
        for k, s in _flat(shapes).items())
    for k, a in got.items():
        if k.startswith("['group_"):
            base = k[: k.rindex("[")]
            assert want[base] == ("layers",) + a, k
        else:
            assert want[k] == a, k


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_axes_match_reference(arch, kv):
    model, _, _ = _reference(arch)
    want = model.cache_axes(kv)
    port = Model(get_config(arch))
    got = sh.cache_axes(port, kv)
    cache = port.init_cache(2, 8, kv)
    i = 0
    for gi, (_, count) in enumerate(model.groups):
        for _ in range(count):
            assert set(got[i]) == set(cache[i])
            assert {k: ("layers",) + a for k, a in got[i].items()} == \
                want[f"group_{gi}"]
            i += 1
    assert i == len(got)


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_resolve_spec_matches_reference(arch, grid):
    """Every leaf of the arch's parameters and of its bf16 and int8
    caches at decode_32k and long_500k, under both rule sets and
    ``replicate_params``."""
    model, shapes, axes = _reference(arch)
    leaves = [(tuple(s.shape), a) for s, a in zip(
        _flat(shapes).values(), _flat(axes, _is_axes).values())]
    for kv in ("bfloat16", "int8"):
        for shape in ("decode_32k", "long_500k"):
            cell = JSHAPES[shape]
            c = _flat(model.abstract_cache(cell.global_batch, cell.seq_len,
                                           kv))
            ca = _flat(model.cache_axes(kv), _is_axes)
            leaves += [(tuple(c[k].shape), ca[k]) for k in c]
    leaves += [((), ()), ((5, 5), ("batch",)), ((4, 4), None)]
    jmesh = _abstract_mesh(GRIDS[grid])
    for name, rules in RULES.items():
        for shp, a in leaves:
            want = tuple(jsh.resolve_spec(shp, a, jmesh, JRULES[name]))
            assert sh.resolve_spec(shp, a, GRIDS[grid], rules) == want, \
                (name, shp, a)


def test_resolve_spec_reference_cases():
    """The reference's own resolver cases (``tests/test_distribution.py``
    ``TestResolveSpec``)."""
    g1, g2 = GRIDS["16x16"], GRIDS["2x16x16"]
    rs = sh.resolve_spec
    assert rs((256000, 2048), ("vocab", "fsdp"), g1) == ("model", "data")
    assert rs((256000, 2048), ("vocab", "fsdp"), g2) == \
        ("model", ("pod", "data"))
    assert rs((4, 32768, 8, 128), ("batch", "kv_seq", "kv_heads", None),
              g1)[2] is None
    assert rs((128, 32768, 8, 128), ("batch", "kv_seq", "kv_heads", None),
              g1) == ("data", "model", None, None)
    assert rs((1, 524288, 4, 256), ("batch", "kv_seq", "kv_heads", None),
              g1) == (None, ("data", "model"), None, None)
    assert rs((256, 7168, 2048), ("expert", "fsdp", "mlp"), g2) == \
        ("model", ("pod", "data"), None)
    assert rs((), (), g1) == () and rs((5, 5), ("batch",), g1) == ()
    assert rs((64, 12288, 96, 128), ("layers", "fsdp", "heads", None),
              g1) == (None, "data", "model", None)


@pytest.mark.parametrize("batch", [None, 64, 6, 5, 1, 32])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_batch_sharding_matches_reference(grid, batch):
    want = jsh.batch_sharding(_abstract_mesh(GRIDS[grid]), batch=batch).spec
    assert sh.batch_sharding(GRIDS[grid], batch=batch) == tuple(want)


@pytest.mark.parametrize("shape", list(JSHAPES))
def test_input_shardings_match_reference(shape):
    for arch in ("gemma-2b", "paligemma-3b", "musicgen-medium"):
        jc, tc = _cfgs(arch)
        for grid in GRIDS.values():
            jmesh = _abstract_mesh(grid)
            want = jsh.input_shardings(jmesh, jinput_specs(jc, shape))
            got = sh.input_shardings(grid, input_specs(tc, shape))
            assert got == {k: tuple(v.spec) for k, v in want.items()}


def test_local_slices_cover_the_leaf_once():
    grid = {"pod": 2, "data": 4, "model": 2}
    shape, spec = (16, 12, 8), (("pod", "data"), None, "model")
    seen = np.zeros(shape, np.int32)
    for rank in range(16):
        sl = sh.local_slices(shape, spec, grid, rank)
        assert tuple(s.stop - s.start for s in sl) == \
            sh.shard_shape(shape, spec, grid) == (2, 12, 4)
        seen[sl] += 1
    # the 2 x 4 x 2 grid holds each element on the ranks that differ only
    # in axes the spec leaves free: none here, so every element once
    assert (seen == 1).all()
    assert sh.local_slices((6, 4), ("data", None), {"data": 2}, 1) == \
        (slice(3, 6), slice(0, 4))


# ---------------------------------------------------------------------------
# grids and the dry run
# ---------------------------------------------------------------------------
def test_grids():
    assert mesh.make_production_mesh() == {"data": 16, "model": 16}
    assert mesh.make_production_mesh(multi_pod=True) == \
        {"pod": 2, "data": 16, "model": 16}
    assert mesh.make_smoke_mesh() == {"data": 1, "model": 1}
    for name, grid in GRIDS.items():
        assert mesh.parse_grid(name) == grid
        assert mesh.grid_name(grid) == name
    assert [mesh.mesh_chip_count(g) for g in GRIDS.values()] == [1, 256, 512]
    with pytest.raises(ValueError):
        mesh.parse_grid("16")


def _shard_bytes(shape_dtype, spec, jmesh) -> int:
    n = 1
    for i, d in enumerate(shape_dtype.shape):
        part = spec[i] if i < len(spec) else None
        names = () if part is None else (part,) if isinstance(part, str) \
            else part
        for a in names:
            d //= jmesh.shape[a]
        n *= d
    return n * np.dtype(shape_dtype.dtype).itemsize


def _reference_argument_bytes(arch, shape, grid, kv=None) -> int:
    """The reference step's arguments (its ``build_step``'s: parameters,
    then the optimizer state or the cache, and the inputs), each leaf's
    shard under the reference's ``resolve_spec`` on an AbstractMesh."""
    model, pshapes, paxes = _reference(arch)
    cfg = jget_config(arch)
    if kv:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=kv)
    jmesh = _abstract_mesh(grid)
    cell = JSHAPES[shape]

    def tree_bytes(shapes, axes):
        s, a = _flat(shapes), _flat(axes, _is_axes)
        return sum(_shard_bytes(s[k], jsh.resolve_spec(
            tuple(s[k].shape), a[k], jmesh), jmesh) for k in s)

    total = tree_bytes(pshapes, paxes)
    if cell.step == "train":
        oshapes = jax.eval_shape(functools.partial(
            joptim.init, joptimizer_config(cfg)), pshapes)
        total += tree_bytes(oshapes, {"mu": paxes, "nu": paxes,
                                      "step": ()})
    else:
        kvd = cfg.kv_cache_dtype
        total += tree_bytes(model.abstract_cache(cell.global_batch,
                                                 cell.seq_len, kvd),
                            model.cache_axes(kvd))
    specs = jinput_specs(cfg, shape)
    sharded = jsh.input_shardings(jmesh, specs)
    total += sum(_shard_bytes(specs[k], tuple(sharded[k].spec), jmesh)
                 for k in specs)
    return total


@pytest.mark.parametrize("shape", list(ASSIGNED_SHAPES))
@pytest.mark.parametrize("arch", DRYRUN_ARCHS)
def test_dryrun_argument_bytes_match_reference(arch, shape):
    for grid in GRIDS.values():
        for kv in (None, "int8"):
            rec = dryrun.run_cell(arch, shape, grid, verbose=False,
                                  kv_int8=kv == "int8")
            ok, _ = cell_applicable(get_config(arch), shape)
            if not ok:
                assert rec["status"] == "skipped"
                continue
            assert rec["status"] == "ok", rec.get("error")
            assert rec["memory"]["argument_bytes_per_device"] == \
                _reference_argument_bytes(arch, shape, grid, kv)
            assert rec["params"] == get_config(arch).param_count()
            assert rec["chips"] == mesh.mesh_chip_count(grid)
            assert rec["memory"]["temp_bytes_per_device"] is None
            assert rec["fits"] == (rec["memory"]["argument_bytes_per_device"]
                                   <= 80 * 2 ** 30)


def test_dryrun_cache_bytes_both_counts():
    """The int8 cache: the port's leaves (codes, scales, positions, write
    index) beside the reference's analytic count; the difference is the
    int32 positions and indices alone."""
    rec = dryrun.run_cell("gemma-2b", "decode_32k", GRIDS["1x1"],
                          verbose=False, kv_int8=True)
    port, analytic = rec["cache_bytes"]["port"], rec["cache_bytes"]["analytic"]
    assert analytic == 36.5625 * 2 ** 30
    L, B, S = 18, 128, 32768
    assert port - analytic == L * (B * S * 4 + B * 4)
    assert rec["fits"] and round(rec["roofline"]["memory_s"] * 1e3, 1) == 13.2


class _OffMeta(TorchDispatchMode):
    """Records every op whose output is a tensor off the meta device."""

    def __init__(self):
        super().__init__()
        self.off = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (list, tuple)) else (out,)):
            if isinstance(t, torch.Tensor) and not t.is_meta:
                self.off.append(str(func))
        return out


@pytest.mark.parametrize("grid", list(GRIDS))
def test_dryrun_creates_no_tensor_off_meta(grid):
    with _OffMeta() as mode:
        for arch in ARCH_IDS:
            for shape in ASSIGNED_SHAPES:
                rec = dryrun.run_cell(arch, shape, GRIDS[grid],
                                      verbose=False)
                assert rec["status"] in ("ok", "skipped")
    assert mode.off == []


@pytest.mark.parametrize("argv", [["--all"], ["--all", "--grid", "1x1"],
                                  ["--all", "--single-pod-only",
                                   "--kv-int8"]])
def test_dryrun_cli_all(tmp_path, argv, capsys):
    """Every assigned cell on each grid: 0 failed, and exactly the
    reference's long_500k skips (the six archs without the flag)."""
    assert dryrun.main(argv + ["--out", str(tmp_path), "--quiet"]) == 0
    recs = [json.loads(p.read_text()) for p in tmp_path.glob("*.json")]
    grids = {r["mesh"] for r in recs}
    assert len(recs) == 40 * len(grids)
    skipped = sorted((r["arch"], r["mesh"]) for r in recs
                     if r["status"] == "skipped")
    assert all(r["status"] in ("ok", "skipped") for r in recs)
    assert skipped == sorted((a, g) for a in ARCH_IDS if a not in
                             LONG_CONTEXT for g in grids)
    assert {r["shape"] for r in recs if r["status"] == "skipped"} == \
        {"long_500k"}
    assert "0 failures" in capsys.readouterr().out
    rows = rf.summarize(str(tmp_path), sorted(grids)[0])
    if "--kv-int8" not in argv:
        assert len(rows) == 40
        assert all(r["status"] in ("ok", "skipped") for r in rows)


def test_step_bundles_are_meta_with_the_references_arguments():
    """Each bundle's arguments are the reference's: the parameters by
    path, the optimizer state (train) or the cache (serving), the inputs
    of ``input_specs``; all on meta, with a spec a leaf."""
    cfg = get_config("qwen2-moe-a2.7b")
    for shape, kind in (("train_4k", "train"), ("prefill_32k", "prefill"),
                        ("decode_32k", "decode")):
        b = build_step(cfg, GRIDS["16x16"], shape)
        assert b.kind == kind and b.model.embed.is_meta
        params = b.args[0]
        assert list(params) == list(sh.param_axes(b.model))
        assert list(b.args[-1 if kind == "train" else 1]) == \
            list(input_specs(cfg, shape))
        if kind == "train":
            assert set(b.args[1]) == {"mu", "nu", "step"}
            assert b.args[1]["mu"][next(iter(params))].dtype == torch.float32
        else:
            assert len(b.args[2]) == cfg.n_layers
        leaves = list(dryrun._leaves(b.args, b.specs))
        assert leaves and all(t.is_meta for t, _ in leaves)
    big = build_step(get_config("deepseek-v3-671b"), GRIDS["1x1"], "train_4k")
    mu = big.args[1]["mu"]
    assert next(iter(mu.values())).dtype == torch.bfloat16
