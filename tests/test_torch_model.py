"""The port's dense model against the JAX reference, on the CPU.

Weights come from the reference's ``Model.init`` on ``gemma-2b-smoke``
and cross over through ``repro_torch.convert.params_from_jax``.  Integer
stages (int8 weights, scales, int8 KV codes, ring writes) must be
exact.  Logits carry ``LOGIT_ATOL = 0.15``: XLA and torch round bf16
products and f32 ``rsqrt``/``tanh`` differently, so activations differ
by an ulp here and there, which can move an int8 code by one at a
rounding tie; the smoke logits are O(5).
"""
from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.model import block_apply as jblock_apply
from repro.quant import QuantPlan as JPlan
from repro.quant.linear import QuantizedLinear as JQL

from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.models import Model
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.model import block_apply
from repro_torch.quant import QuantizedLinear, QuantPlan, kernel_mode
from torch_parity import numpy_tree, port_model, rng, smoke, t, to_np

LOGIT_ATOL = 0.15
REPO = pathlib.Path(__file__).resolve().parent.parent


def _plans():
    return [("full", JPlan.full(), QuantPlan.full()),
            ("none", None, None)]


def test_reduced_config_dims():
    cfg = reduced_config(get_config("gemma-2b"))
    jcfg = smoke()[0]
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab", "activation", "tie_embeddings"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert (cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab) == (64, 4, 4, 1, 16, 128, 256)
    assert cfg.layer_groups() == jcfg.layer_groups()


def test_full_config_matches_reference():
    from repro.configs import get_config as jget
    cfg, jcfg = get_config("gemma-2b"), jget("gemma-2b")
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab", "activation", "rope_theta"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.param_count() == jcfg.param_count()


# ---------------------------------------------------------------------------
# (b) weights: conversion and quantization, bitwise
# ---------------------------------------------------------------------------
def test_params_from_jax_bitwise():
    _, _, params = smoke()
    m = port_model()
    np.testing.assert_array_equal(to_np(m.embed),
                                  to_np(params["embed"]["embedding"]))
    g = params["group_0"]
    for i, block in enumerate(m.layers):
        for name in ("q", "k", "v", "o"):
            np.testing.assert_array_equal(
                to_np(getattr(block.attn, name)),
                to_np(g["attn"][name][i]))
        for name in ("up", "down", "gate"):
            np.testing.assert_array_equal(to_np(getattr(block.mlp, name)),
                                          to_np(g["mlp"][name][i]))
        assert block.attn.q.dtype == torch.bfloat16


def test_quantized_leaves_bitwise():
    """Model.quantize(QuantPlan.full()) in the port gives the reference's
    int8 leaves bit for bit, and the reference's quantized tree converts
    to the same QuantizedLinear modules."""
    cfg, jm, params = smoke()
    jq = jm.quantize(params, JPlan.full())
    ours = port_model(QuantPlan.full())
    theirs = params_from_jax(numpy_tree(jq), ours.cfg, device="cpu")
    g = jq["group_0"]
    for i, (a, b) in enumerate(zip(ours.layers, theirs.layers)):
        for mod_a, mod_b, names, tree in (
                (a.attn, b.attn, ("qkv", "o"), g["attn"]),
                (a.mlp, b.mlp, ("up", "down", "gate"), g["mlp"])):
            for name in names:
                qa, qb = getattr(mod_a, name), getattr(mod_b, name)
                assert isinstance(qa, QuantizedLinear)
                assert isinstance(tree[name], JQL)
                for leaf in ("q", "scale"):
                    np.testing.assert_array_equal(
                        to_np(getattr(qa, leaf)), to_np(getattr(qb, leaf)))
                    np.testing.assert_array_equal(
                        to_np(getattr(qa, leaf)),
                        to_np(getattr(tree[name], leaf)[i]))
    assert ours.layers[0].attn.qkv.q.shape == (64, 4 + 2, 16)
    assert not hasattr(ours.layers[0].attn, "q")


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------
def test_rmsnorm_rope_close():
    r = rng(20)
    x = r.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = np.arange(5, dtype=np.int32)[None].repeat(2, 0)
    np.testing.assert_allclose(
        to_np(tlayers.apply_rope(t(x), t(pos))),
        to_np(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos))),
        rtol=1e-5, atol=1e-5)
    scale = r.uniform(0.5, 1.5, 16).astype(np.float32)
    np.testing.assert_allclose(
        to_np(tlayers.rmsnorm_apply(t(scale), t(x))),
        to_np(jlayers.rmsnorm_apply({"scale": jnp.asarray(scale)},
                                    jnp.asarray(x))), rtol=1e-5, atol=1e-5)


def test_quantize_kv_bitwise():
    x = rng(21).standard_normal((2, 7, 1, 16)).astype(np.float32)
    q, s = tattn._quantize_kv(t(x))
    jq, js = jattn._quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(to_np(q), to_np(jq))
    np.testing.assert_array_equal(to_np(s), to_np(js))


@pytest.mark.parametrize("S,cap,valid", [
    (1, 8, None),                 # decode
    (5, 8, [5, 2]),               # wrapped scatter with pad suffix
    (12, 8, [12, 3]),             # S >= cap: last cap valid entries
    (8, 8, None)])
def test_ring_update_matches_reference(S, cap, valid):
    r = rng(22)
    buf = r.integers(-100, 100, (2, cap, 3)).astype(np.int32)
    new = r.integers(-100, 100, (2, S, 3)).astype(np.int32)
    idx = np.array([6, 13], np.int32)
    vl = None if valid is None else np.array(valid, np.int32)
    want = jattn._ring_update(jnp.asarray(buf), jnp.asarray(new),
                              jnp.asarray(idx),
                              None if vl is None else jnp.asarray(vl))
    got = t(buf)
    tattn._ring_update(got, t(new), t(idx), None if vl is None else t(vl))
    np.testing.assert_array_equal(to_np(got), to_np(want))


# ---------------------------------------------------------------------------
# (c) one block; prefill + decode logits
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,jplan,plan", _plans())
def test_block_close(name, jplan, plan):
    jcfg, jm, params = smoke()
    p = params if jplan is None else jm.quantize(params, jplan)
    lp = jax.tree.map(lambda a: a[0], p["group_0"])
    x = rng(23).standard_normal((2, 8, 64)).astype(np.float32)
    pos = np.arange(8, dtype=np.int32)[None].repeat(2, 0)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    want, _, _ = jblock_apply(lp, ("attn", "dense"), jcfg, jx,
                              jnp.asarray(pos), None, None)
    m = port_model(plan)
    got = block_apply(m.layers[0], m.cfg, t(x, torch.bfloat16), t(pos),
                      None)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=0, atol=0.1)


@pytest.mark.parametrize("name,jplan,plan", _plans())
def test_prefill_decode_logits_close(name, jplan, plan):
    jcfg, jm, params = smoke()
    p = params if jplan is None else jm.quantize(params, jplan)
    kv = "int8" if plan is not None else None
    toks = rng(24).integers(0, 256, (2, 16)).astype(np.int32)
    lengths = np.array([16, 9], np.int32)
    jc = jm.init_cache(2, 32, kv_dtype=kv)
    jl, jc = jm.prefill_padded(p, {"inputs": jnp.asarray(toks)}, jc,
                               jnp.asarray(lengths))
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    jd, jc = jm.decode_step(p, {"inputs": jnp.asarray(nxt)[:, None]}, jc)

    m = port_model(plan)
    tc = m.init_cache(2, 32, kv_dtype=kv)
    tl = m.prefill_padded(t(toks).long(), tc, t(lengths))
    assert [int(c["index"][0]) for c in tc] == [16] * 4
    td = m.decode_step(t(nxt).long()[:, None], tc)
    np.testing.assert_allclose(to_np(tl), to_np(jl), rtol=0, atol=LOGIT_ATOL)
    np.testing.assert_allclose(to_np(td), to_np(jd), rtol=0, atol=LOGIT_ATOL)
    if kv == "int8":
        # the prompt's and the decoded token's int8 KV codes land in the
        # same slots (pad slots hold RoPE of the 2**30 sentinel, masked
        # and not compared)
        jk = np.asarray(jc["group_0"]["k"][0])
        tk = to_np(tc[0]["k"])
        valid = np.arange(32)[None, :] <= lengths[:, None]
        diff = np.abs(jk.astype(int) - tk.astype(int))[valid]
        assert diff.max() <= 1 and (diff == 0).mean() > 0.98
        np.testing.assert_array_equal(to_np(tc[0]["pos"]),
                                      np.asarray(jc["group_0"]["pos"][0]))


def test_kernel_mode_false_is_plain_oracle():
    """kernel_mode(False) is the caller's explicit choice of the plain
    oracle; on CPU the pipeline runs the same plain math, so both agree
    exactly."""
    m = port_model(QuantPlan.full())
    toks = torch.as_tensor(rng(25).integers(0, 256, (2, 6)))
    with torch.no_grad():
        a = m(toks)
        with kernel_mode(False):
            b = m(toks)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# (e) import isolation; (f) device selection
# ---------------------------------------------------------------------------
def _forbidden(mod: str) -> bool:
    return mod == "jax" or mod.startswith("jax.") or mod == "repro" \
        or mod.startswith("repro.") or mod == "ml_dtypes"


def test_port_imports_no_jax_subprocess():
    code = ("import sys\n"
            "import repro_torch, repro_torch.configs, repro_torch.kernels, "
            "repro_torch.quant, repro_torch.models, repro_torch.serving, "
            "repro_torch.convert, repro_torch.launch.serve, "
            "repro_torch.models.moe, repro_torch.parallel, "
            "repro_torch.parallel.context, repro_torch.parallel.sharding, "
            "repro_torch.quant.tp, repro_torch.models.dit, "
            "repro_torch.diffusion, repro_torch.launch.generate, "
            "repro_torch.reliability, repro_torch.reliability.chaos, "
            "repro_torch.core, repro_torch.core.bridge, "
            "repro_torch.obs, repro_torch.analysis, repro_torch.data, "
            "repro_torch.optim, repro_torch.checkpoint, "
            "repro_torch.training, repro_torch.launch.steps, "
            "repro_torch.launch.train, repro_torch.launch.console, "
            "repro_torch.launch.mesh, repro_torch.launch.roofline, "
            "repro_torch.launch.dryrun, repro_torch.parallel.pipeline\n"
            "for arch in repro_torch.configs.ARCH_IDS:\n"
            "    repro_torch.configs.get_config(arch)\n"
            "sys.path.insert(0, '.')\n"
            "import chip_smoke, ab_kernels\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.') or m == 'ml_dtypes')\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_port_sources_import_no_jax():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "ab_kernels.py"]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert not any(_forbidden(n) for n in names), (f, names)


def test_port_library_has_no_print():
    """The T201 rule of tools/lint.py covers the port's package too."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("repro_lint",
                                                  REPO / "tools" / "lint.py")
    lint = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lint)
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    assert files and all(lint._in_library(f) for f in files)
    assert sum((lint._check_prints(f) for f in files), []) == []


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_init_needs_card_unless_cpu(no_card):
    cfg = reduced_config(get_config("gemma-2b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg).init(0)
    m = Model(cfg).init(0, device="cpu")
    assert m.device.type == "cpu"
    assert m.embed.dtype == torch.bfloat16
    assert float(m.embed.float().abs().max()) <= 2.0
    # two draws from one seed agree
    m2 = Model(cfg).init(0, device="cpu")
    assert torch.equal(m.embed, m2.embed)


def test_params_from_jax_needs_card_unless_cpu(no_card):
    _, _, params = smoke()
    cfg = reduced_config(get_config("gemma-2b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax(numpy_tree(params), cfg)
