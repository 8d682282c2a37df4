"""The port's attention + dense-FFN family beyond gemma-2b against the JAX
reference, on the CPU: gemma3-4b (5:1 local/global, qk_norm),
deepseek-67b (llama), command-r-plus-104b (layernorm, qk_norm, tied),
paligemma-3b (patch embeddings, ``frontend_proj``, the ``"prefix"`` mask)
and musicgen-medium (frame embeddings, layernorm, gelu MLP, MHA), each at
its reduced ``*-smoke`` size.

Weights come from the reference's ``Model.init`` through
``params_from_jax``; inputs are numpy from a seed.  Integer stages
(weights, row codes, row scales, int32 accumulators) are exact on the
same input; norms within 1e-6 in f32 (of the largest |out| where it
exceeds 1); a block within 0.1 in bf16; logits
within ``LOGIT_ATOL = 0.15`` (``tests/test_torch_model.py``: XLA and
torch round bf16 products differently, which can move an int8 code at a
tie).  The prefix mask of ``dense_attention``, ``blockwise_attention``
and kernel 12's plain version is held within 1e-6 of the reference's
``blockwise_attention(..., "prefix", prefix_len=...)`` in f32.  The
serving engines are in ``tests/test_torch_dense_family_serving.py``.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jkref
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.model import block_apply as jblock_apply
from repro.quant import QuantPlan as JPlan

from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tkref
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.model import block_apply
from repro_torch.quant import QuantPlan
from torch_parity import numpy_tree, port_model, rng, smoke, t, to_np

ARCHS = ("gemma3-4b", "deepseek-67b", "command-r-plus-104b", "paligemma-3b",
         "musicgen-medium")
LOGIT_ATOL = 0.15
NORM_ATOL = 1e-6
PREFIX_ATOL = 1e-6
# the layer whose stages are compared: gemma3-4b-smoke's first global
# layer (local and global alternate there); an "attn" layer elsewhere
LAYER = 1
CONFIG_FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                 "d_ff", "vocab", "activation", "norm", "rope_theta",
                 "qk_norm", "tie_embeddings", "sliding_window",
                 "local_global_pattern", "frontend", "frontend_len",
                 "frontend_dim", "family", "param_dtype", "kv_cache_dtype")


def _jax_layer(tree, cfg, layer):
    """Layer ``layer``'s leaves of the reference's stacked tree."""
    i = 0
    for gi, (_spec, count) in enumerate(cfg.layer_groups()):
        if layer < i + count:
            return jax.tree.map(lambda a: a[layer - i], tree[f"group_{gi}"])
        i += count
    raise IndexError(layer)


def _inputs(arch, seed, B=2, S=12):
    """(tokens [B, S] int32, patches [B, P, frontend_dim] f32 or None,
    frames [B, S, d] f32 or None) of the smoke config."""
    cfg = smoke(arch)[0]
    r = rng(seed)
    toks = r.integers(0, 256, (B, S)).astype(np.int32)
    patches = frames = None
    if cfg.frontend == "vision":
        patches = r.standard_normal(
            (B, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    if cfg.frontend == "audio":
        frames = r.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return toks, patches, frames


def _jbatch(toks, patches, frames):
    if frames is not None:
        return {"frame_embeddings": jnp.asarray(frames)}
    out = {"inputs": jnp.asarray(toks)}
    if patches is not None:
        out["patch_embeddings"] = jnp.asarray(patches)
    return out


def _tkw(patches, frames):
    return {k: t(v) for k, v in (("patch_embeddings", patches),
                                 ("frame_embeddings", frames))
            if v is not None}


# ---------------------------------------------------------------------------
# (a) configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_param_count_match_reference(arch):
    from repro.configs import get_config as jget
    cfg, jcfg = get_config(arch), jget(arch)
    for f in CONFIG_FIELDS:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.layer_specs() == jcfg.layer_specs()
    assert cfg.param_count() == jcfg.param_count()
    small, jsmall = reduced_config(cfg), smoke(arch)[0]
    for f in CONFIG_FIELDS + ("name",):
        assert getattr(small, f) == getattr(jsmall, f), f
    assert small.layer_groups() == jsmall.layer_groups()
    assert small.param_count() == jsmall.param_count()


def test_registry_serves_the_family():
    assert set(ARCHS) <= set(ARCH_IDS)
    counts = {a: get_config(a).param_count() for a in ARCHS}
    assert counts == {"gemma3-4b": 3_879_731_200,
                      "deepseek-67b": 67_423_436_800,
                      "command-r-plus-104b": 103_809_024_000,
                      "paligemma-3b": 2_508_587_008,
                      "musicgen-medium": 1_365_245_952}
    specs = get_config("gemma3-4b").layer_specs()
    assert specs.count(("attn_local", "dense")) == 29
    assert specs.count(("attn", "dense")) == 5


# ---------------------------------------------------------------------------
# (b) norms
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["layernorm", "layernorm+bias", "rmsnorm",
                                  "qk_norm"])
def test_norms_match_reference(case):
    """f32 within 1e-6 of the larger of 1 and the largest |out| (qk_norm:
    the rmsnorm of each [Dh] head of a [B, S, H, Dh] tensor), bf16
    within one bf16 step of it."""
    r = rng(50)
    shape = (2, 5, 4, 16) if case == "qk_norm" else (3, 7, 64)
    x = (r.standard_normal(shape) * 3 + 0.5).astype(np.float32)
    scale = r.standard_normal(shape[-1]).astype(np.float32)
    bias = r.standard_normal(shape[-1]).astype(np.float32)
    for jdt, tdt, atol in ((jnp.float32, torch.float32, NORM_ATOL),
                           (jnp.bfloat16, torch.bfloat16, 2 ** -7)):
        jx, tx = jnp.asarray(x).astype(jdt), t(x).to(tdt)
        if case.startswith("layernorm"):
            p = {"scale": jnp.asarray(scale)}
            b = None
            if case.endswith("bias"):
                p["bias"], b = jnp.asarray(bias), t(bias)
            want = jlayers.layernorm_apply(p, jx)
            got = tlayers.norm_apply("layernorm", t(scale), tx, b)
        else:
            want = jlayers.rmsnorm_apply({"scale": jnp.asarray(scale)}, jx)
            got = tlayers.norm_apply("rmsnorm", t(scale), tx)
        assert got.dtype == tdt
        w = to_np(want)
        np.testing.assert_allclose(to_np(got), w, rtol=0,
                                   atol=atol * max(1.0, np.abs(w).max()))


def test_norm_apply_refuses_unknown_kinds():
    with pytest.raises(ValueError):
        tlayers.norm_apply("batchnorm", torch.ones(4), torch.ones(2, 4))
    with pytest.raises(ValueError):
        tlayers.norm_apply("rmsnorm", torch.ones(4), torch.ones(2, 4),
                           torch.zeros(4))


# ---------------------------------------------------------------------------
# (c) weights: conversion and quantization, bitwise
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_bitwise(arch):
    """Every leaf crosses over bit for bit: the norms' scales, q_norm and
    k_norm, frontend_proj; the full plan's int8 leaves are the
    reference's quantization."""
    cfg, jm, params = smoke(arch)
    m = port_model(arch=arch)
    np.testing.assert_array_equal(to_np(m.final_norm),
                                  to_np(params["final_norm"]["scale"]))
    assert hasattr(m, "frontend_proj") == ("frontend_proj" in params)
    if hasattr(m, "frontend_proj"):
        assert m.frontend_proj.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            to_np(m.frontend_proj), to_np(params["frontend_proj"]["kernel"]))
    for i, block in enumerate(m.layers):
        jl = _jax_layer(params, cfg, i)
        for name in ("mixer_norm", "ffn_norm"):
            np.testing.assert_array_equal(to_np(getattr(block, name)),
                                          to_np(jl[name]["scale"]))
        assert hasattr(block.attn, "q_norm") == cfg.qk_norm
        for name in ("q", "k", "v", "o"):
            np.testing.assert_array_equal(to_np(getattr(block.attn, name)),
                                          to_np(jl["attn"][name]))
        if cfg.qk_norm:
            for name in ("q_norm", "k_norm"):
                np.testing.assert_array_equal(
                    to_np(getattr(block.attn, name)),
                    to_np(jl["attn"][name]["scale"]))
        assert hasattr(block.mlp, "gate") == (cfg.activation != "gelu")
    qm = port_model(QuantPlan.full(), arch)
    jq = jm.quantize(params, JPlan.full())
    if hasattr(qm, "frontend_proj"):      # outside the plan, as the reference
        assert isinstance(qm.frontend_proj, torch.nn.Parameter)
        assert qm.frontend_proj.dtype == torch.bfloat16
    for i, block in enumerate(qm.layers):
        jl = _jax_layer(jq, cfg, i)
        leaves = [(block.attn.qkv, jl["attn"]["qkv"]),
                  (block.attn.o, jl["attn"]["o"])]
        leaves += [(getattr(block.mlp, n), jl["mlp"][n])
                   for n in ("up", "down", "gate") if n in jl["mlp"]]
        for got, want in leaves:
            np.testing.assert_array_equal(to_np(got.q), np.asarray(want.q))
            np.testing.assert_array_equal(to_np(got.scale),
                                          np.asarray(want.scale))


def test_convert_carries_a_layernorm_bias_and_refuses_mismatches():
    """A layernorm tree with a bias (the reference's ``layernorm_init(dim,
    bias=True)``) crosses over into ``<norm>_bias``; a tree without the
    config's ``q_norm`` or ``frontend_proj`` is refused."""
    from repro_torch.convert import params_from_jax
    arch = "command-r-plus-104b"
    _, _, params = smoke(arch)
    tree = numpy_tree(params)
    cfg = reduced_config(get_config(arch))
    b = rng(51).standard_normal(tree["final_norm"]["scale"].shape)
    tree["final_norm"] = dict(tree["final_norm"], bias=b.astype(np.float32))
    m = params_from_jax(tree, cfg, device="cpu")
    np.testing.assert_array_equal(to_np(m.final_norm_bias), tree[
        "final_norm"]["bias"])
    x = torch.randn((2, 3, 64))
    want = tlayers.layernorm_apply(m.final_norm, x, m.final_norm_bias)
    from repro_torch.models.model import _norm
    assert torch.equal(_norm("layernorm", m.final_norm, x, m, "final_norm"),
                       want)
    bad = numpy_tree(params)
    bad["group_0"]["attn"] = {k: v for k, v in bad["group_0"]["attn"].items()
                              if k != "q_norm"}
    with pytest.raises(ValueError, match="qk_norm"):
        params_from_jax(bad, cfg, device="cpu")
    _, _, pparams = smoke("paligemma-3b")
    bad = numpy_tree(pparams)
    del bad["frontend_proj"]
    with pytest.raises(ValueError, match="frontend_proj"):
        params_from_jax(bad, reduced_config(get_config("paligemma-3b")),
                        device="cpu")


# ---------------------------------------------------------------------------
# (d) one block: its int8 stages exact, its output close
# ---------------------------------------------------------------------------
def _kind(cfg, mixer):
    if mixer == "attn_local":
        return "sliding", cfg.sliding_window
    return ("prefix" if cfg.frontend == "vision" else "causal"), None


@functools.lru_cache(maxsize=None)
def _stage_inputs(arch):
    """The reference's inputs of layer ``LAYER``'s four GEMM stages
    under the full plan, on a seeded bf16 x [2, 8, d]: the normed input
    (QKV), the attention output after qk_norm, RoPE and the layer's mask
    (out-projection), the normed post-attention state (MLP up/gate), the
    MLP hidden state (down)."""
    cfg, jm, params = smoke(arch)
    jl = _jax_layer(jm.quantize(params, JPlan.full()), cfg, LAYER)
    mixer = cfg.layer_specs()[LAYER][0]
    kind, window = _kind(cfg, mixer)
    pfx = cfg.frontend_len if cfg.frontend == "vision" else None
    x = jnp.asarray(rng(52).standard_normal((2, 8, cfg.d_model)),
                    jnp.bfloat16)
    pos = jnp.broadcast_to(jnp.arange(8)[None], (2, 8))
    h = jlayers.norm_apply(cfg.norm, jl["mixer_norm"], x)
    qkv = jl["attn"]["qkv"]
    d, HK, Dh = qkv.q.shape
    H = cfg.n_heads
    wide = jkref.fused_matmul_ref(h.reshape(-1, d), qkv.q.reshape(d, -1),
                                  qkv.scale.reshape(-1)).astype(x.dtype)
    q, k, v = jnp.split(wide.reshape(2, 8, HK, Dh),
                        (H, H + cfg.n_kv_heads), axis=2)
    if cfg.qk_norm:
        q = jlayers.rmsnorm_apply(jl["attn"]["q_norm"], q)
        k = jlayers.rmsnorm_apply(jl["attn"]["k_norm"], k)
    q = jlayers.apply_rope(q, pos, cfg.rope_theta)
    k = jlayers.apply_rope(k, pos, cfg.rope_theta)
    att = jattn.dense_attention(q, k, v, pos, pos, kind, window, pfx)
    x1, _ = jattn.attention_apply(jl["attn"], h, pos, mask_kind=kind,
                                  window=window, prefix_len=pfx,
                                  rope_theta=cfg.rope_theta, residual=x)
    h2 = jlayers.norm_apply(cfg.norm, jl["ffn_norm"], x1)
    mlp = jl["mlp"]
    act = {"geglu": "gelu", "swiglu": "silu"}.get(cfg.activation,
                                                  cfg.activation)
    flat = h2.reshape(-1, d)
    if "gate" in mlp:
        hidden = jkref.gated_mlp_hidden_ref(flat, mlp["gate"].q,
                                            mlp["gate"].scale, mlp["up"].q,
                                            mlp["up"].scale, act)
    else:
        hidden = jkref.fused_matmul_ref(flat, mlp["up"].q, mlp["up"].scale,
                                        activation=act)
    return {"qkv": np.asarray(h.reshape(-1, d).astype(jnp.float32)),
            "out": np.asarray(att.reshape(16, -1).astype(jnp.float32)),
            "mlp": np.asarray(flat.astype(jnp.float32)),
            "down": np.asarray(hidden)}


@pytest.mark.parametrize("stage", ["qkv", "out", "mlp", "down"])
@pytest.mark.parametrize("arch", ARCHS)
def test_block_int8_stages_exact(arch, stage):
    """Each GEMM stage of layer ``LAYER`` under the full plan, fed the
    reference's own input: the row codes, the row scales and the int32
    accumulators against the port's int8 weight are the reference's
    exactly (the bf16 inputs widened to f32 on both sides)."""
    src = _stage_inputs(arch)[stage]
    block = port_model(QuantPlan.full(), arch).layers[LAYER]
    d = block.attn.qkv.q.shape[0]
    w = {"qkv": block.attn.qkv.q.reshape(d, -1),
         "out": block.attn.o.q.reshape(-1, d),
         "mlp": getattr(block.mlp, "gate", block.mlp.up).q,
         "down": block.mlp.down.q}[stage]
    jq, js = jkref.quantize_rows_int8_ref(jnp.asarray(src))
    tq, ts = tkref.quantize_rows_int8_ref(t(src))
    np.testing.assert_array_equal(to_np(tq), np.asarray(jq))
    np.testing.assert_array_equal(to_np(ts), np.asarray(js))
    np.testing.assert_array_equal(
        to_np(tkref.cim_gemm_int8_ref(tq, w)),
        np.asarray(jkref.cim_gemm_int8_ref(jq, jnp.asarray(to_np(w)))))


@pytest.mark.parametrize("plan_name", ["full", "none"])
@pytest.mark.parametrize("arch", ARCHS)
def test_block_close(arch, plan_name):
    """Layer ``LAYER`` (its norms, qk_norm, mask and MLP kind) on a bf16
    input against the reference's ``block_apply``: within 0.1."""
    cfg, jm, params = smoke(arch)
    full = plan_name == "full"
    p = jm.quantize(params, JPlan.full()) if full else params
    jl = _jax_layer(p, cfg, LAYER)
    spec = cfg.layer_specs()[LAYER]
    x = rng(53).standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(8, dtype=np.int32)[None], (2, 8))
    pfx = cfg.frontend_len if cfg.frontend == "vision" else None
    want, _, _ = jblock_apply(jl, spec, cfg,
                              jnp.asarray(x).astype(jnp.bfloat16),
                              jnp.asarray(pos), None, pfx)
    m = port_model(QuantPlan.full() if full else None, arch)
    got = block_apply(m.layers[LAYER], m.cfg, t(x, torch.bfloat16),
                      t(pos), None, prefix_len=pfx)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=0, atol=0.1)


# ---------------------------------------------------------------------------
# (e) forward, prefill + decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_close(arch):
    """The cacheless forward with the config's inputs (paligemma: 4 patch
    embeddings then the tokens; musicgen: frame embeddings)."""
    _, jm, params = smoke(arch)
    toks, patches, frames = _inputs(arch, 54)
    want = jm.forward(params, _jbatch(toks, patches, frames))[0]
    got = port_model(arch=arch)(None if frames is not None
                                else t(toks).long(), **_tkw(patches, frames))
    assert got.shape == want.shape
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=0,
                               atol=LOGIT_ATOL)


@pytest.mark.parametrize("plan_name", ["full", "none"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_logits_close(arch, plan_name):
    """A padded prefill then two decode steps (int8 KV under the full
    plan): logits within LOGIT_ATOL and the write index at the
    reference's.  paligemma's text prompt takes prefix_len =
    frontend_len; musicgen is fed frame embeddings throughout."""
    cfg, jm, params = smoke(arch)
    full = plan_name == "full"
    p = jm.quantize(params, JPlan.full()) if full else params
    kv = "int8" if full else None
    toks, _, frames = _inputs(arch, 55, S=16)
    lengths = np.array([16, 11], np.int32)
    jc = jm.init_cache(2, 32, kv_dtype=kv)
    jl, jc = jm.prefill_padded(p, _jbatch(toks, None, frames), jc,
                               jnp.asarray(lengths))
    m = port_model(QuantPlan.full() if full else None, arch)
    tc = m.init_cache(2, 32, kv_dtype=kv)
    tin = None if frames is not None else t(toks).long()
    tl = m.prefill_padded(tin, tc, t(lengths), **_tkw(None, frames))
    np.testing.assert_allclose(to_np(tl), to_np(jl), rtol=0, atol=LOGIT_ATOL)
    r = rng(56)
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    for _ in range(2):
        if frames is not None:
            f = r.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
            jd, jc = jm.decode_step(p, {"frame_embeddings": jnp.asarray(f)},
                                    jc)
            td = m.decode_step(None, tc, frame_embeddings=t(f))
        else:
            jd, jc = jm.decode_step(p, {"inputs": jnp.asarray(nxt)[:, None]},
                                    jc)
            td = m.decode_step(t(nxt).long()[:, None], tc)
        np.testing.assert_allclose(to_np(td), to_np(jd), rtol=0,
                                   atol=LOGIT_ATOL)
        nxt = np.asarray(jnp.argmax(jd[:, -1], -1)).astype(np.int32)
    assert to_np(tc[0]["index"]).tolist() == [18, 13]
    np.testing.assert_array_equal(to_np(tc[0]["index"]),
                                  np.asarray(jc["group_0"]["index"][0]))


@pytest.mark.parametrize("plan_name", ["full", "none"])
def test_paligemma_patch_prefill_then_decode_close(plan_name):
    """4 patch embeddings + 12 tokens written into a ring cache in one
    forward (the reference's ``forward(..., caches=)``; the port's
    ``prefill_padded(patch_embeddings=)``), then two text decode steps
    under prefix_len = frontend_len."""
    arch = "paligemma-3b"
    cfg, jm, params = smoke(arch)
    full = plan_name == "full"
    p = jm.quantize(params, JPlan.full()) if full else params
    kv = "int8" if full else None
    toks, patches, _ = _inputs(arch, 57)
    jc = jm.init_cache(2, 32, kv_dtype=kv)
    jl, jc, _ = jm.forward(p, _jbatch(toks, patches, None), caches=jc)
    m = port_model(QuantPlan.full() if full else None, arch)
    tc = m.init_cache(2, 32, kv_dtype=kv)
    tl = m.prefill_padded(t(toks).long(), tc, t(np.array([12, 12])),
                          patch_embeddings=t(patches))
    np.testing.assert_allclose(to_np(tl)[:, 0], to_np(jl)[:, -1], rtol=0,
                               atol=LOGIT_ATOL)
    assert to_np(tc[0]["index"]).tolist() == [16, 16]
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    for _ in range(2):
        jd, jc = jm.decode_step(p, {"inputs": jnp.asarray(nxt)[:, None]}, jc)
        td = m.decode_step(t(nxt).long()[:, None], tc)
        np.testing.assert_allclose(to_np(td), to_np(jd), rtol=0,
                                   atol=LOGIT_ATOL)
        nxt = np.asarray(jnp.argmax(jd[:, -1], -1)).astype(np.int32)


def test_frontend_inputs_are_checked():
    m = port_model(arch="musicgen-medium")
    with pytest.raises(ValueError, match="frame_embeddings"):
        m(torch.zeros((1, 3), dtype=torch.long))
    g = port_model(arch="deepseek-67b")
    with pytest.raises(ValueError, match="vision"):
        g(torch.zeros((1, 3), dtype=torch.long),
          patch_embeddings=torch.zeros((1, 4, 32)))
    with pytest.raises(ValueError, match="audio"):
        g(torch.zeros((1, 3), dtype=torch.long),
          frame_embeddings=torch.zeros((1, 3, 64)))


def test_port_init_draws_the_family():
    """``Model.init`` fills every leaf (no NaN left from ``to_empty``):
    q_norm/k_norm and the layernorm scales at 1, frontend_proj drawn; a
    model drawn block by block after ``init_outer`` is ``init``'s."""
    from repro_torch.models import Model
    for arch in ("command-r-plus-104b", "paligemma-3b"):
        cfg = reduced_config(get_config(arch))
        m = Model(cfg).init(0, device="cpu")
        for name, p in m.named_parameters():
            assert bool(torch.isfinite(p.float()).all()), name
        if cfg.qk_norm:
            assert bool((m.layers[0].attn.q_norm == 1).all())
        two = Model(cfg)
        two.to_empty(device="cpu")
        gen = torch.Generator().manual_seed(0)
        two.init_outer(gen)
        for block in two.layers:
            block.init_(gen)
        for (n, a), (_, b) in zip(m.named_parameters(),
                                  two.named_parameters()):
            assert torch.equal(a, b), n


# ---------------------------------------------------------------------------
# (f) the prefix mask
# ---------------------------------------------------------------------------
# (B, S, H, KH, D, prefix_len, q_block, kv_block): p 0, inside a block,
# on a block edge, the whole sequence, past it
PREFIX_CASES = [(2, 40, 4, 2, 16, 0, 8, 16), (1, 37, 4, 1, 16, 11, 8, 16),
                (2, 48, 2, 2, 8, 16, 16, 16), (1, 30, 4, 4, 16, 30, 8, 8),
                (1, 25, 2, 1, 16, 40, 8, 16)]


def _qkv(seed, B, S, H, KH, D):
    r = rng(seed)
    return tuple(r.standard_normal(s).astype(np.float32)
                 for s in ((B, S, H, D), (B, S, KH, D), (B, S, KH, D)))


@pytest.mark.parametrize("impl", ["dense", "blockwise", "kernel12_plain"])
@pytest.mark.parametrize("B,S,H,KH,D,p,qb,kb", PREFIX_CASES)
def test_prefix_mask_matches_reference_blockwise(impl, B, S, H, KH, D, p, qb,
                                                 kb):
    q, k, v = _qkv(58, B, S, H, KH, D)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    want = jattn.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(pos), "prefix", prefix_len=p, q_block=qb, kv_block=kb)
    if impl == "dense":
        got = tattn.dense_attention(t(q), t(k), t(v), t(pos), t(pos),
                                    "prefix", prefix_len=p)
    elif impl == "blockwise":
        got = tattn.blockwise_attention(t(q), t(k), t(v), t(pos), t(pos),
                                        "prefix", prefix_len=p, q_block=qb,
                                        kv_block=kb)
    else:
        got = tfa.flash_attention(t(q), t(k), t(v), causal=True,
                                  prefix_len=p)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0,
                               atol=PREFIX_ATOL)


def test_prefix_mask_is_bidirectional_in_the_prefix_only():
    """Rows before p see every key before p (and their own causal keys);
    rows after it see keys up to themselves; p = 0 is the causal mask."""
    ok = tkref.prefill_visible(6, 6, True, None, "cpu", prefix_len=3)
    want = np.tril(np.ones((6, 6), bool))
    want[:, :3] = True
    np.testing.assert_array_equal(ok.numpy(), want)
    pos = torch.arange(6)
    bias = tattn._mask_bias(pos, pos, "prefix", prefix_len=3)
    np.testing.assert_array_equal((bias == 0).numpy(), want)
    np.testing.assert_array_equal(
        tkref.prefill_visible(6, 6, True, None, "cpu", 0).numpy(),
        np.tril(np.ones((6, 6), bool)))


def test_kernel12_refuses_a_prefix_it_does_not_define():
    q = torch.zeros((1, 8, 2, 16))
    for kw in (dict(prefix_len=-1), dict(prefix_len=4, causal=False),
               dict(prefix_len=4, window=3)):
        with pytest.raises(ValueError, match="prefix_len"):
            tfa.flash_attention(q, q, q, **kw)


@pytest.fixture
def paths(monkeypatch):
    """Record each cacheless attention's path and mask."""
    seen = []

    def spy(name, fn):
        def recorded(*a, **kw):
            seen.append((name, a[5] if len(a) > 5 else kw.get("kind")))
            return fn(*a, **kw)
        return recorded
    monkeypatch.setattr(tattn, "dense_attention",
                        spy("dense", tattn.dense_attention))
    monkeypatch.setattr(tattn, "blockwise_attention",
                        spy("blockwise", tattn.blockwise_attention))
    return seen


@pytest.mark.parametrize("S,path", [(2048, "dense"), (2049, "blockwise")])
def test_vision_forward_attends_under_the_prefix_mask(paths, S, path):
    """Every layer of paligemma-3b-smoke is a global layer under the
    ``"prefix"`` mask, on the dense path up to 2048 tokens and blockwise
    above it on the CPU (kernel 12 on the card); gemma3-4b-smoke's local
    layers take ``"sliding"``, its global ones ``"causal"``."""
    m = port_model(arch="paligemma-3b")
    toks = torch.as_tensor(rng(59).integers(0, 256, (1, S - 4))).long()
    pe = torch.as_tensor(rng(60).standard_normal((1, 4, 32)),
                         dtype=torch.float32)
    with torch.no_grad():
        m(toks, patch_embeddings=pe, last_index=torch.tensor([S - 1]))
    assert paths == [(path, "prefix")] * m.cfg.n_layers
    paths.clear()
    g = port_model(arch="gemma3-4b")
    with torch.no_grad():
        g(toks[:, :16])
    assert paths == [("dense", "sliding"), ("dense", "causal")] * 2


# ---------------------------------------------------------------------------
# (g) dispatch rules the family reaches first
# ---------------------------------------------------------------------------
def test_projection_above_fused_k_takes_row_quant_then_gemm(monkeypatch):
    """deepseek-67b's and command-r-plus-104b's QKV and out-projections
    have K > MAX_FUSED_QUANT_K: kernel 1 then kernel 3 (two launches),
    the same function as kernel 2's single launch below it."""
    calls = []
    for name in ("quantize_rows_int8", "cim_gemm_int8_fused",
                 "cim_gemm_int8_fused_qin"):
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _f=fn, _n=name, **kw: (
            calls.append(_n), _f(*a, **kw))[1])
    r = rng(61)
    for K in (ops.MAX_FUSED_QUANT_K, ops.MAX_FUSED_QUANT_K + 8):
        x = t(r.standard_normal((3, K)).astype(np.float32))
        w, s = ops.quantize_weights_int8(t(r.standard_normal(
            (K, 16)).astype(np.float32)))
        got = ops.cim_quantized_matmul_fused(x, w, s)
        np.testing.assert_array_equal(to_np(got), to_np(
            tkref.fused_matmul_ref(x, w, s)))
    assert calls == ["cim_gemm_int8_fused_qin", "quantize_rows_int8",
                     "cim_gemm_int8_fused"]
    for arch, over in (("deepseek-67b", True), ("command-r-plus-104b", True),
                       ("gemma3-4b", False), ("musicgen-medium", False)):
        cfg = get_config(arch)
        assert (cfg.d_model > ops.MAX_FUSED_QUANT_K) == over
        assert (cfg.n_heads * cfg.head_dim > ops.MAX_FUSED_QUANT_K) == over


def test_ungated_gelu_mlp_is_three_launches(monkeypatch):
    """musicgen-medium's MLP (gelu, not gated, d_ff 6144 <= 8192): row
    quantize, kernel 3 with the requant in its epilogue, kernel 3 down."""
    calls = []
    for name in ("quantize_rows_int8", "cim_gemm_int8_fused",
                 "cim_gated_gemm_int8"):
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _f=fn, _n=name, **kw: (
            calls.append(_n), _f(*a, **kw))[1])
    block = port_model(QuantPlan.full(), "musicgen-medium").layers[0]
    x = torch.randn((2, 3, 64), generator=torch.Generator().manual_seed(0))
    tlayers.mlp_apply(block.mlp, x.bfloat16(), "gelu", residual=x)
    assert calls == ["quantize_rows_int8", "cim_gemm_int8_fused",
                     "cim_gemm_int8_fused"]
    assert get_config("musicgen-medium").d_ff <= ops.MAX_FUSED_QUANT_N


@pytest.mark.parametrize("arch", ["gemma3-4b", "command-r-plus-104b",
                                  "paligemma-3b"])
def test_tensor_parallelism_refuses_the_untested_features(arch):
    """Tensor parallelism takes ``qk_norm``, layernorm and the vision
    frontend now (held against the unsharded port in
    ``test_torch_tp_families.py``): the attention shards, ``qk_norm``'s
    per-head weights, the norms and ``frontend_proj`` stay whole."""
    from repro_torch.parallel.context import TPGroup
    from repro_torch.parallel.sharding import shard_model
    m = port_model(QuantPlan.full(), arch)
    whole = {k: v.shape for k, v in m.state_dict().items()}
    shard_model(m, TPGroup(1, 2, "gloo"))
    attn = m.layers[0].attn
    assert attn.o.tp_size == 2 and attn.o.q.shape[0] == m.cfg.n_heads // 2
    for k, v in m.state_dict().items():
        if "norm" in k or "frontend_proj" in k:
            assert v.shape == whole[k], k
