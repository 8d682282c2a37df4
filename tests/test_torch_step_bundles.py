"""The port's prefill and decode step bundles (``launch.steps``
``build_prefill_step``, ``build_decode_step``) against the reference's
``Model.prefill_last`` and ``decode_step`` on the same smoke weights, on
the CPU.

The reference's methods are called directly, not under a mesh (C.4);
an MoE arch's run op by op (``jax.disable_jit``: jitted, XLA's fusions
round the bf16 intermediates otherwise and flip a near tie of the
router, C.5).  Logits within ``LOGIT_ATOL`` (the parity tests' bound:
XLA and torch round bf16 products and f32 ``rsqrt`` differently), the
greedy tokens equal, the write index the reference's; under the full
plan an int8 KV cache whose first layer's codes are exact where that
layer is attention (its input is the embedding, the same bits on both
sides).
"""
from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.quant import QuantPlan as JPlan

from repro_torch.configs import get_config, reduced_config
from repro_torch.launch.steps import build_decode_step, build_prefill_step
from repro_torch.quant import QuantPlan
from torch_parity import port_model, rng, smoke, t, to_np

LOGIT_ATOL = 0.15
SEED = 10
# the caches beyond attention's ring: a hybrid's SSM state, the
# xLSTM's, gemma3-4b's sliding windows (gemma-2b, paligemma-3b and
# musicgen-medium, the token, vision and audio inputs:
# tests/test_torch_pipeline_dp.py)
STEP_ARCHS = ("zamba2-1.2b", "xlstm-350m", "gemma3-4b")


def _bundle_model(bundle, arch, full):
    """The bundle's meta model given the reference smoke weights."""
    port = port_model(None, arch)
    bundle.model.load_state_dict(port.state_dict(), assign=True)
    if full:
        bundle.model.quantize(QuantPlan.full())
    return bundle.model


def _inputs(cfg, seed, B=2, S=12):
    r = rng(seed)
    toks = r.integers(0, 256, (B, S)).astype(np.int32)
    jb, tb = {}, {}
    if cfg.frontend == "audio":
        f = r.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        jb["frame_embeddings"], tb["frame_embeddings"] = jnp.asarray(f), t(f)
        return jb, tb
    jb["inputs"], tb["inputs"] = jnp.asarray(toks), t(toks)
    if cfg.frontend == "vision":
        pe = r.standard_normal((B, cfg.frontend_len,
                                cfg.frontend_dim)).astype(np.float32)
        jb["patch_embeddings"], tb["patch_embeddings"] = \
            jnp.asarray(pe), t(pe)
    return jb, tb


def check_bundles(arch: str, full: bool) -> None:
    """``build_prefill_step`` then two steps of ``build_decode_step`` on
    one cache, each bundle's model given the same weights, against
    ``prefill_last`` and ``decode_step``."""
    cfg, jm, params = smoke(arch)
    p = jm.quantize(params, JPlan.full()) if full else params
    kv = "int8" if full else None
    tcfg = reduced_config(get_config(arch))
    pre = build_prefill_step(tcfg, shape="prefill_32k")
    dec = build_decode_step(tcfg, shape="decode_32k")
    assert pre.kind == "prefill" and dec.kind == "decode"
    model = _bundle_model(pre, arch, full)
    _bundle_model(dec, arch, full)
    jb, tb = _inputs(cfg, SEED)
    jc = jm.init_cache(2, 32, kv_dtype=kv)
    def op_by_op():
        return jax.disable_jit() if cfg.moe is not None else \
            contextlib.nullcontext()
    with op_by_op():
        jl, jc = jm.prefill_last(p, jb, jc)
    tc = model.init_cache(2, 32, kv)
    tl, tc = pre.fn(tb, tc)
    assert tuple(tl.shape) == (2, 1, cfg.vocab)
    np.testing.assert_allclose(to_np(tl), to_np(jl), rtol=0,
                               atol=LOGIT_ATOL)
    if full and cfg.layer_specs()[0][0] in ("attn", "attn_local"):
        for name in ("k", "v"):
            np.testing.assert_array_equal(
                to_np(tc[0][name]), np.asarray(jc["group_0"][name][0]))
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    assert to_np(tl[:, -1].argmax(-1)).tolist() == nxt.tolist()
    r = rng(SEED + 1)
    for _ in range(2):
        if cfg.frontend == "audio":
            f = r.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
            jin, tin = {"frame_embeddings": jnp.asarray(f)}, \
                {"frame_embeddings": t(f)}
        else:
            jin, tin = {"inputs": jnp.asarray(nxt)[:, None]}, \
                {"inputs": t(nxt)[:, None]}
        with op_by_op():
            jd, jc = jm.decode_step(p, jin, jc)
        td, tc = dec.fn(tin, tc)
        np.testing.assert_allclose(to_np(td), to_np(jd), rtol=0,
                                   atol=LOGIT_ATOL)
        nxt = np.asarray(jnp.argmax(jd[:, -1], -1)).astype(np.int32)
        assert to_np(td[:, -1].argmax(-1)).tolist() == nxt.tolist()
    np.testing.assert_array_equal(to_np(tc[0]["index"]),
                                  np.asarray(jc["group_0"]["index"][0]))




@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_prefill_and_decode_bundles_match_reference(arch, full):
    check_bundles(arch, full)
