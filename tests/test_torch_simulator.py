"""The port's simulator (``repro_torch.core``) and its bridge against the
reference's ``repro.core``: the operator graph of every registered LM
config (prefill and decode, with and without the full plan) and of
DiT-XL/2 equal op by op, ``simulate_graph``'s costs equal on the paper's
four hardware points, and the ECC costing and the fault geometry taken
from a simulator MXU equal.  Pure Python on both sides."""
import dataclasses
import enum

import pytest

import repro.core as jcore
import repro_torch.core as tcore
from repro.configs import get_config as jget
from repro.configs import get_dit_config as jget_dit
from repro.core import bridge as jbridge
from repro.quant import QuantPlan as JPlan
from repro_torch.configs import ARCH_IDS, get_config, get_dit_config
from repro_torch.core import bridge as tbridge
from repro_torch.quant import QuantPlan

HARDWARE = ("tpuv4i_baseline", "cim_tpu", "design_a", "design_b")
# (stage, batch, q_len, kv_len)
STAGES = (("prefill", 2, 512, 512), ("decode", 8, 1, 1280))


def plain(obj):
    """A dataclass tree as plain Python (enums by name), so the two
    packages' classes compare by value."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.name
    if isinstance(obj, (list, tuple)):
        return [plain(x) for x in obj]
    if isinstance(obj, dict):
        return {plain(k): plain(v) for k, v in obj.items()}
    return obj


def _costs(core, graph):
    out = []
    for name in HARDWARE:
        cost = core.simulate_graph(getattr(core, name)(), graph)
        out.append((plain(cost), cost.latency_s, cost.total_energy_j,
                    cost.mxu_energy_j))
    return out


def test_port_core_is_the_reference_core():
    """Every public name of the reference's core exists in the port's."""
    assert set(jcore.__all__) == set(tcore.__all__)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_graph_and_costs_equal(arch):
    """Prefill and decode, unplanned and under the full plan: the same
    ops in the same order with the same fields, and the same cost on
    each hardware point."""
    tcfg, jcfg = get_config(arch), jget(arch)
    for _, batch, q_len, kv_len in STAGES:
        for tplan, jplan in ((None, None), (QuantPlan.full(), JPlan.full())):
            tg = tbridge.graph_from_config(tcfg, batch, q_len, kv_len,
                                           quant_plan=tplan)
            jg = jbridge.graph_from_config(jcfg, batch, q_len, kv_len,
                                           quant_plan=jplan)
            assert len(tg.ops) == len(jg.ops) > tcfg.n_layers
            for a, b in zip(tg.ops, jg.ops):
                assert plain(a) == plain(b), (arch, q_len, a.name)
            assert plain(tg) == plain(jg)
            assert tg.total_macs == jg.total_macs
        assert _costs(tcore, tg) == _costs(jcore, jg)


@pytest.mark.parametrize("planned", [False, True])
def test_dit_graph_and_costs_equal(planned):
    tg = tbridge.dit_graph_from_config(
        get_dit_config("dit-xl-2"), 8,
        quant_plan=QuantPlan.full() if planned else None)
    jg = jbridge.dit_graph_from_config(
        jget_dit("dit-xl-2"), 8, quant_plan=JPlan.full() if planned
        else None)
    assert plain(tg) == plain(jg) and tg.repeat == jg.repeat == 28
    assert _costs(tcore, tg) == _costs(jcore, jg)


def test_ecc_costing_and_fault_geometry_equal():
    """``EnergyModel.with_cim_ecc`` and the MXU area under ECC as the
    reference's; ``FaultConfig.from_mxu`` takes the port's simulator MXU
    with no duck typing and reads the reference's tile geometry."""
    from repro.reliability import FaultConfig as JFault
    from repro_torch.reliability import FaultConfig
    ecc = tcore.DEFAULT_ENERGY_MODEL.with_cim_ecc()
    assert plain(ecc) == plain(jcore.DEFAULT_ENERGY_MODEL.with_cim_ecc())
    for name in HARDWARE:
        for flag in (False, True):
            assert tcore.mxu_area_mm2(getattr(tcore, name)(), cim_ecc=flag) \
                == jcore.mxu_area_mm2(getattr(jcore, name)(), cim_ecc=flag)
    g_t = tbridge.graph_from_config(get_config("gemma-2b"), 8, 1, 1280,
                                    quant_plan=QuantPlan.full())
    g_j = jbridge.graph_from_config(jget("gemma-2b"), 8, 1, 1280,
                                    quant_plan=JPlan.full())
    small_t, small_j = tcore.cim_tpu(8, 8, num_mxus=2), \
        jcore.cim_tpu(8, 8, num_mxus=2)
    assert tcore.simulate_graph(small_t, g_t, em=ecc).mxu_energy_j == \
        jcore.simulate_graph(small_j, g_j,
                             em=jcore.DEFAULT_ENERGY_MODEL.with_cim_ecc()
                             ).mxu_energy_j
    for mxu_t, mxu_j in ((tcore.cim_tpu().mxu, jcore.cim_tpu().mxu),
                         (tcore.design_a().mxu, jcore.design_a().mxu)):
        got = FaultConfig.from_mxu(mxu_t, kind="column_kill", ber=1e-3)
        want = JFault.from_mxu(mxu_j, kind="column_kill", ber=1e-3)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
