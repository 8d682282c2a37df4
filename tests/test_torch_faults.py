"""The port's CIM fault campaigns (``repro_torch.reliability.faults``)
against the reference's, bit for bit: on gemma-2b-smoke,
qwen2-moe-a2.7b-smoke (the [L, E, K, N] expert leaves) and the DiT smoke
config, for each of the four fault kinds, the ``FaultReport`` and every
layer's faulted codes equal the reference's ``inject_tree`` on its
stacked tree; ``protect_tree`` and ``ecc_residual_ber`` equal the
reference's; loading and restoring the leaves is bitwise and keeps the
model's buffers."""
import dataclasses

import jax
import numpy as np
import pytest

from repro.quant import QuantizedLinear as JQL
from repro.quant import QuantPlan as JPlan
from repro.reliability import ecc_residual_ber as jecc
from repro.reliability import inject_tree as jinject
from repro.reliability import protect_tree as jprotect
from repro_torch.convert import dit_params_from_jax, params_from_jax
from repro_torch.reliability import (FAULT_KINDS, FaultConfig,
                                     ecc_residual_ber, inject_tree,
                                     load_leaves, protect_tree,
                                     quantized_leaves)
from torch_parity import jax_dit, numpy_tree, smoke

CONFIGS = ("gemma-2b", "qwen2-moe-a2.7b", "dit-test")
# per-bit rates, and per macro cell for column_kill (the smoke leaves have
# few 128-row slabs)
BER = {"bit_flip": 1e-3, "stuck_at_0": 2e-3, "stuck_at_1": 2e-3,
       "column_kill": 5e-2}


def _jax_tree(config):
    """The reference's full-plan tree of ``config``."""
    if config.startswith("dit"):
        return jax_dit(config)[3]
    _, jm, params = smoke(config)
    return jm.quantize(params, JPlan.full())


def _port_model(config, jtree):
    """The port's model holding the reference's quantized leaves."""
    from repro_torch.configs import get_config, get_dit_config
    from repro_torch.configs import reduced_config
    if config.startswith("dit"):
        return dit_params_from_jax(numpy_tree(jtree), get_dit_config(config),
                                   device="cpu")
    return params_from_jax(numpy_tree(jtree),
                           reduced_config(get_config(config)), device="cpu")


@pytest.fixture(scope="module", params=CONFIGS)
def pair(request):
    jtree = _jax_tree(request.param)
    return request.param, jtree, _port_model(request.param, jtree)


def _jleaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JQL))
    return {jax.tree_util.keystr(p): leaf for p, leaf in flat
            if isinstance(leaf, JQL)}


def test_leaves_are_the_reference_stacks(pair):
    """Same paths, same stacked shapes and codes as the reference's tree
    (qkv's column axis is Dh; the experts' scale [L, E, N])."""
    config, jtree, model = pair
    leaves, want = quantized_leaves(model), _jleaves(jtree)
    assert set(leaves) == set(want)
    for path, leaf in leaves.items():
        assert np.array_equal(leaf.q, np.asarray(want[path].q)), path
        assert np.array_equal(leaf.scale, np.asarray(want[path].scale)), path
    if config == "qwen2-moe-a2.7b":
        assert leaves["['group_0']['moe']['up']"].q.ndim == 4
        assert "['group_0']['moe']['shared']['down']" in leaves


@pytest.mark.parametrize("kind", FAULT_KINDS)
def test_campaign_bit_for_bit(pair, kind):
    """The report key for key and every layer's faulted codes equal the
    reference's; the scales pass through; a second campaign replays."""
    config, jtree, model = pair
    cfg = FaultConfig(kind=kind, ber=BER[kind], seed=7)
    jft, jrep = jinject(jtree, _jcfg(cfg))
    clean = quantized_leaves(model)
    faulted, rep = inject_tree(clean, cfg)
    for name in ("kind", "ber", "seed", "leaves", "total_bits", "faults"):
        assert getattr(rep, name) == getattr(jrep, name), name
    assert rep.per_leaf == jrep.per_leaf and rep.faults > 0
    want = _jleaves(jft)
    for path, leaf in faulted.items():
        assert np.array_equal(leaf.q, np.asarray(want[path].q)), path
        assert leaf.scale is clean[path].scale
    # every layer's module holds the reference's slice once loaded
    from repro_torch.convert import quantized_paths
    load_leaves(model, faulted)
    try:
        for path, mods in quantized_paths(model).items():
            for j, m in enumerate(mods):
                assert np.array_equal(m.q.numpy(),
                                      np.asarray(want[path].q)[j]), (path, j)
    finally:
        load_leaves(model, clean)
    again, rep2 = inject_tree(clean, cfg)
    assert rep2.per_leaf == rep.per_leaf and all(
        np.array_equal(again[p].q, faulted[p].q) for p in faulted)


@pytest.mark.parametrize("kind", FAULT_KINDS)
def test_sharded_campaign_is_the_whole_campaigns_slice(pair, kind):
    """Each leaf cut as two tensor-parallel ranks cut it (every other
    output channel a rank, on the last axis): each rank's faulted part
    equals its slice of the reference's faulted leaf, bit for bit, and
    each rank's report is the reference's whole one."""
    from repro_torch.reliability.faults import Leaf, Shard
    config, jtree, model = pair
    cfg = FaultConfig(kind=kind, ber=BER[kind], seed=7)
    jft, jrep = jinject(jtree, _jcfg(cfg))
    want = _jleaves(jft)
    clean = quantized_leaves(model)
    for rank in range(2):
        parts = {}
        for path, leaf in clean.items():
            idx = np.arange(rank, leaf.q.shape[-1], 2)
            index = (None,) * (leaf.q.ndim - 2) + (idx,)
            parts[path] = Leaf(np.take(leaf.q, idx, axis=-1), leaf.scale,
                               Shard(leaf.q.shape[1:], index))
        faulted, rep = inject_tree(parts, cfg)
        for name in ("leaves", "total_bits", "faults", "per_leaf"):
            assert getattr(rep, name) == getattr(jrep, name), (rank, name)
        for path, leaf in faulted.items():
            assert np.array_equal(
                leaf.q, np.take(np.asarray(want[path].q),
                                parts[path].shard.index[-1], axis=-1)), \
                (rank, path)


def _jcfg(cfg):
    from repro.reliability import FaultConfig as JFault
    return JFault(**dataclasses.asdict(cfg))


def test_load_writes_each_layer_in_place_and_restores(pair):
    """``load_leaves`` puts layer j's slice of each faulted stack into the
    module's own buffers (same storage), and the pristine leaves restore
    the model bitwise."""
    from repro_torch.convert import quantized_paths
    _, _, model = pair
    clean = quantized_leaves(model)
    faulted, _ = inject_tree(clean, FaultConfig(ber=1e-2, seed=3))
    paths = quantized_paths(model)
    ptrs = {p: [m.q.data_ptr() for m in mods] for p, mods in paths.items()}
    load_leaves(model, faulted)
    for path, mods in paths.items():
        assert [m.q.data_ptr() for m in mods] == ptrs[path]
        for j, m in enumerate(mods):
            assert np.array_equal(m.q.numpy(), faulted[path].q[j]), path
    load_leaves(model, clean)
    back = quantized_leaves(model)
    assert all(np.array_equal(back[p].q, clean[p].q) for p in clean)
    with pytest.raises(KeyError):
        load_leaves(model, {"['nope']": clean[next(iter(clean))]})


@pytest.mark.parametrize("fraction", [0.0, 0.25, 1.0])
def test_protect_tree_equals_reference(pair, fraction):
    _, jtree, model = pair
    cfg = FaultConfig(kind="bit_flip", ber=5e-3, seed=11)
    jft, _ = jinject(jtree, _jcfg(cfg))
    jprot = _jleaves(jprotect(jtree, jft, fraction))
    clean = quantized_leaves(model)
    prot = protect_tree(clean, inject_tree(clean, cfg)[0], fraction)
    for path, leaf in prot.items():
        assert np.array_equal(leaf.q, np.asarray(jprot[path].q)), path
    if fraction == 1.0:
        assert all(np.array_equal(prot[p].q, clean[p].q) for p in clean)


def test_ecc_residual_and_config_checks():
    for ber in (0.0, 1e-6, 1e-4, 1e-2, 0.3):
        assert ecc_residual_ber(ber) == jecc(ber)
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultConfig(kind="gamma_ray")
    with pytest.raises(ValueError, match="ber"):
        FaultConfig(ber=1.5)


def test_protect_tree_on_shards_is_the_whole_result_cut():
    """``protect_tree`` on each of 2 gloo ranks' shards of gemma-2b-smoke
    (``tests/torch_tp_ranks.py``, no JAX), after the whole tree's
    campaign cut to each shard: every leaf bitwise the unsharded
    result's cut to the shard, for the column-parallel leaves (QKV, the
    MLP's up and gate: the output channels of their cut scales ranked
    after one MAX each) and the row-parallel ones (the out-projection
    and down: their scales whole on every rank)."""
    import torch_tp_ranks as ranks
    from repro_torch.parallel.context import spawn
    model = _port_model("gemma-2b", _jax_tree("gemma-2b"))
    cfg = FaultConfig(kind="bit_flip", ber=5e-3, seed=11)
    clean = quantized_leaves(model)
    whole = protect_tree(clean, inject_tree(clean, cfg)[0], 0.25)
    case = dict(model=model, fault=cfg, fraction=0.25)
    res = spawn(ranks.run_cases, 2, args=({"p": ("protect", case)},))
    cut = {"column": 0, "row": 0}
    for r in res:
        got = r["p"]
        assert set(got["leaves"]) == set(whole)
        for path, (q, index) in got["leaves"].items():
            w = whole[path].q
            assert index is not None, path
            at = [np.arange(w.shape[0])] + [
                np.arange(n) if i is None else i
                for n, i in zip(w.shape[1:], index)]
            assert np.array_equal(q, w[np.ix_(*at)]), path
            kind = "row" if path.endswith(("['o']", "['down']")) \
                else "column"
            cut[kind] += 1
        # one MAX for each leaf whose scale is cut: QKV, up, gate
        assert got["counts"]["max"] == 3
    assert cut["column"] and cut["row"]
