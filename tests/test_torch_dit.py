"""The port's DiT (``repro_torch.models.dit``) against the JAX reference,
on the CPU.

``dit-test`` with f32 params: the reference's ``DiTModel.init`` draws
the weights, which cross over through
``repro_torch.convert.dit_params_from_jax``; inputs come from a numpy
seed.  The reference's quantized path runs as its own tests run it,
through its oracle (``use_kernel=None`` resolves to it on the CPU), and
for one block also through the Pallas kernels in interpret mode.

Tolerances:
* exact: ``patchify``/``unpatchify``, the converted weights, the port's
  int8 quantization of them, and every integer stage fed the same input
  (the adaLN, QKV, out-projection and MLP row codes, their scales and
  the int32 accumulators);
* ``STAGE_CODE_RATE``: the same stages fed each side's own input (the
  reference's f32 elementwise ops and the port's differ by an ulp here
  and there, which can move a code at a rounding tie): every code within
  1 LSB, at most that share of codes off by one (ROADMAP B's exp/tanh
  note);
* ``timestep_embedding``: 1e-6 plus t * 2**-24 in a row of timestep t
  (XLA's f32 exp and torch's put a few frequencies an ulp apart, at most
  2**-24 below 1, and t radians carry that into sin and cos); ``_ln``
  1e-6 (f32 rsqrt of two libraries);
* one block and the whole forward: 1e-5 of the largest |out| (the f32
  roundings above, carried through the int8 stages); the block against
  the interpreted Pallas kernels 2e-4, the reference's own
  kernel-against-oracle tolerance.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_dit_config as jget_dit
from repro.kernels import ref as jkref
from repro.models import attention as jattn
from repro.models import dit as jdit
from repro.quant import kernel_mode as jkernel_mode

from repro_torch.configs import (DIT_ARCH_IDS, DiTConfig, all_dit_configs,
                                 get_config, get_dit_config)
from repro_torch.convert import dit_params_from_jax
from repro_torch.kernels import launch_counts
from repro_torch.kernels import ref as tkref
from repro_torch.models import attention as tattn
from repro_torch.models import dit as tdit
from repro_torch.quant import (DIT_LAYER_KINDS, QuantizedLinear, QuantPlan,
                               kernel_mode)
from torch_parity import DIT_ARCH as ARCH
from torch_parity import (jax_dit, numpy_tree, port_dit, rel_close, rng,
                          t, to_np)

EMB_TOL = 1e-6
OUT_REL = 1e-5
KERNEL_TOL = 2e-4
STAGE_CODE_RATE = 0.01


def _inputs(seed: int, B: int = 2):
    cfg = get_dit_config(ARCH)
    r = rng(seed)
    x = r.standard_normal((B, cfg.in_channels, cfg.input_size,
                           cfg.input_size)).astype(np.float32)
    tt = np.array([500, 10, 999, 0][:B], np.int32)
    y = np.array([3, 7, 0, 15][:B], np.int32)
    return x, tt, y


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["dit-xl-2", "dit-test"])
def test_configs_match_reference(arch):
    cfg, jcfg = get_dit_config(arch), jget_dit(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for prop in ("head_dim", "d_ff", "tokens", "out_channels",
                 "null_class"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop
    assert cfg.param_count() == jcfg.param_count()


def test_registry():
    assert DIT_ARCH_IDS == ("dit-xl-2", "dit-test")
    assert all(isinstance(c, DiTConfig) for c in all_dit_configs().values())
    xl = get_dit_config("dit-xl-2")
    assert (xl.d_model, xl.n_heads, xl.head_dim, xl.tokens) == (
        1152, 16, 72, 1024)
    with pytest.raises(KeyError):
        get_dit_config("gemma-2b")
    with pytest.raises(KeyError):
        get_config("dit-xl-2")
    assert DIT_LAYER_KINDS == ("adaln", "attn_qkv", "attn_out", "mlp")


def test_param_count_matches_the_meta_model():
    """The port's module tree at DiT-XL/2 (on ``meta``, nothing drawn)
    holds the reference's approximate count within 0.1%."""
    cfg = get_dit_config("dit-xl-2")
    n = sum(p.numel() for p in tdit.DiTModel(cfg).parameters())
    assert abs(n - cfg.param_count()) / n < 1e-3


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------
def test_patchify_roundtrip_exact():
    x = rng(1).standard_normal((2, 4, 8, 8)).astype(np.float32)
    tok = tdit.patchify(t(x), 2)
    np.testing.assert_array_equal(to_np(tok),
                                  np.asarray(jdit.patchify(jnp.asarray(x),
                                                           2)))
    back = tdit.unpatchify(tok, 2, 4, 8)
    np.testing.assert_array_equal(to_np(back), x)
    np.testing.assert_array_equal(
        to_np(back), np.asarray(jdit.unpatchify(jnp.asarray(to_np(tok)),
                                                2, 4, 8)))


def test_timestep_embedding_and_ln():
    tt = np.array([0, 1, 10, 500, 999], np.int32)
    for dim in (32, 256):
        err = np.abs(to_np(tdit.timestep_embedding(t(tt), dim))
                     - np.asarray(jdit.timestep_embedding(jnp.asarray(tt),
                                                          dim)))
        assert (err <= EMB_TOL + tt[:, None] * 2.0 ** -24).all(), err.max()
    x = (rng(2).standard_normal((2, 16, 64)) * 3 + 1).astype(np.float32)
    np.testing.assert_allclose(to_np(tdit._ln(t(x))),
                               np.asarray(jdit._ln(jnp.asarray(x))),
                               rtol=EMB_TOL, atol=EMB_TOL)
    assert tdit._ln(t(x).bfloat16()).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------
def test_dit_params_from_jax_bitwise():
    _, _, params, _ = jax_dit()
    m = port_dit(False)
    np.testing.assert_array_equal(to_np(m.y_table),
                                  np.asarray(params["y_embed"]["table"]))
    np.testing.assert_array_equal(to_np(m.final.linear.kernel),
                                  np.asarray(params["final"]["linear"][
                                      "kernel"]))
    blocks = params["blocks"]
    for j, b in enumerate(m.blocks):
        for name in ("q", "k", "v", "o"):
            np.testing.assert_array_equal(
                to_np(getattr(b.attn, name)),
                np.asarray(blocks["attn"][name][j]))
        np.testing.assert_array_equal(to_np(b.mlp.up),
                                      np.asarray(blocks["mlp"]["up"][j]))
        np.testing.assert_array_equal(to_np(b.adaln.kernel),
                                      np.asarray(blocks["adaln"]["kernel"][
                                          j]))


def test_port_quantization_is_the_references():
    """The port's full plan on the converted f32 weights gives the
    reference's int8 codes and scales exactly; the patch embed, the
    embedders and the final layer stay unquantized."""
    _, _, _, qparams = jax_dit()
    m = port_dit(False).quantize(QuantPlan.full())
    blocks = qparams["blocks"]
    for j, b in enumerate(m.blocks):
        for mod, name, leaf in ((b.attn, "qkv", blocks["attn"]["qkv"]),
                                (b.attn, "o", blocks["attn"]["o"]),
                                (b.mlp, "up", blocks["mlp"]["up"]),
                                (b.mlp, "down", blocks["mlp"]["down"]),
                                (b.adaln, "kernel",
                                 blocks["adaln"]["kernel"])):
            w = getattr(mod, name)
            assert isinstance(w, QuantizedLinear), name
            np.testing.assert_array_equal(to_np(w.q), np.asarray(leaf.q[j]))
            np.testing.assert_array_equal(to_np(w.scale),
                                          np.asarray(leaf.scale[j]))
    assert not isinstance(m.final.adaln.kernel, QuantizedLinear)
    assert not isinstance(m.patch_embed.kernel, QuantizedLinear)


def test_partial_plans_and_idempotence():
    m = port_dit(False).quantize(QuantPlan.none())
    assert not isinstance(m.blocks[0].adaln.kernel, QuantizedLinear)
    assert hasattr(m.blocks[0].attn, "q")
    m.quantize(dataclasses.replace(QuantPlan.none(), mlp=True))
    assert isinstance(m.blocks[0].mlp.up, QuantizedLinear)
    assert not isinstance(m.blocks[0].adaln.kernel, QuantizedLinear)
    m.quantize(QuantPlan.full())
    q = m.blocks[0].adaln.kernel.q.clone()
    m.quantize(QuantPlan.full())
    assert torch.equal(m.blocks[0].adaln.kernel.q, q)


def test_converter_refuses_foreign_shapes():
    _, _, params, qparams = jax_dit()
    tree = numpy_tree(params)
    tree["blocks"]["mlp"]["up"] = tree["blocks"]["mlp"]["up"][:, :, :-1]
    with pytest.raises(ValueError, match="up"):
        dit_params_from_jax(tree, get_dit_config(ARCH), device="cpu")
    tree = numpy_tree(qparams)
    ql = tree["blocks"]["attn"]["qkv"]
    tree["blocks"]["attn"]["qkv"] = type(ql)(ql.q[:, :, :-1], ql.scale)
    with pytest.raises(ValueError, match="qkv"):
        dit_params_from_jax(tree, get_dit_config(ARCH), device="cpu")
    tree = numpy_tree(qparams)
    ql = tree["blocks"]["adaln"]["kernel"]
    tree["blocks"]["adaln"]["kernel"] = type(ql)(ql.q, ql.scale[:, :-1])
    with pytest.raises(ValueError, match="scale"):
        dit_params_from_jax(tree, get_dit_config(ARCH), device="cpu")


# ---------------------------------------------------------------------------
# the integer stages of one full-plan block
# ---------------------------------------------------------------------------
def _block_inputs(seed: int):
    cfg = get_dit_config(ARCH)
    r = rng(seed)
    x = (r.standard_normal((2, cfg.tokens, cfg.d_model)) * 0.5).astype(
        np.float32)
    c = (r.standard_normal((2, cfg.d_model)) * 0.5).astype(np.float32)
    return x, c


def _jax_block(j: int = 0):
    _, _, _, qparams = jax_dit()
    return jax.tree.map(lambda a: a[j], qparams["blocks"])


def _stage_inputs_jax(jb, x, c):
    """The reference's inputs of the adaLN, QKV, out-projection and MLP
    GEMMs of one full-plan block, and the MLP's f32 hidden state."""
    cfg = jget_dit(ARCH)
    x, c = jnp.asarray(x), jnp.asarray(c)
    mod = jdit.adaln_apply(jb["adaln"], c, 6)
    h = jdit._modulate(jdit._ln(x), mod[0], mod[1])
    wide = jkref.fused_matmul_ref(h.reshape(-1, cfg.d_model),
                                  jb["attn"]["qkv"].q.reshape(
                                      cfg.d_model, -1),
                                  jb["attn"]["qkv"].scale.reshape(-1))
    q, k, v = jnp.split(wide.reshape(2, cfg.tokens, 3 * cfg.n_heads, -1),
                        3, axis=2)
    pos = jnp.broadcast_to(jnp.arange(cfg.tokens)[None], (2, cfg.tokens))
    att = jattn.dense_attention(q, k, v, pos, pos, "full")
    attn_out, _ = jattn.attention_apply(jb["attn"], h, pos,
                                        mask_kind="full", use_rope=False)
    x1 = x + mod[2][:, None, :] * attn_out
    h2 = jdit._modulate(jdit._ln(x1), mod[3], mod[4])
    up = jb["mlp"]["up"]
    hidden = jkref.fused_matmul_ref(h2.reshape(-1, cfg.d_model), up.q,
                                    up.scale, activation="gelu")
    return {"adaln": jax.nn.silu(c), "qkv": h.reshape(-1, cfg.d_model),
            "out": att.reshape(-1, cfg.d_model),
            "mlp": h2.reshape(-1, cfg.d_model), "down": hidden}


def _stage_inputs_port(b, x, c):
    """The port's own inputs of the same stages."""
    cfg = get_dit_config(ARCH)
    x, c = t(x), t(c)
    mod = tdit.adaln_apply(b.adaln, c, 6)
    h = tdit._modulate(tdit._ln(x), mod[0], mod[1])
    wide = tkref.fused_matmul_ref(h.reshape(-1, cfg.d_model),
                                  b.attn.qkv.q.reshape(cfg.d_model, -1),
                                  b.attn.qkv.scale.reshape(-1))
    q, k, v = torch.split(wide.reshape(2, cfg.tokens, 3 * cfg.n_heads, -1),
                          cfg.n_heads, dim=2)
    pos = torch.arange(cfg.tokens).expand(2, cfg.tokens)
    att = tattn.dense_attention(q, k, v, pos, pos, "full")
    attn_out = tattn.attention_apply(b.attn, h, pos, mask_kind="full",
                                     use_rope=False)
    x1 = x + mod[2][:, None, :] * attn_out
    h2 = tdit._modulate(tdit._ln(x1), mod[3], mod[4])
    hidden = tkref.fused_matmul_ref(h2.reshape(-1, cfg.d_model), b.mlp.up.q,
                                    b.mlp.up.scale, activation="gelu")
    return {"adaln": tkref.silu(c), "qkv": h.reshape(-1, cfg.d_model),
            "out": att.reshape(-1, cfg.d_model),
            "mlp": h2.reshape(-1, cfg.d_model), "down": hidden}


def _weights(b):
    d = get_dit_config(ARCH).d_model
    return {"adaln": b.adaln.kernel.q, "qkv": b.attn.qkv.q.reshape(d, -1),
            "out": b.attn.o.q.reshape(-1, d), "mlp": b.mlp.up.q,
            "down": b.mlp.down.q}


@pytest.mark.parametrize("stage", ["adaln", "qkv", "out", "mlp", "down"])
def test_integer_stages_exact_on_the_same_input(stage):
    """Each GEMM stage of a full-plan block fed the reference's own
    input: the row codes, the row scales and the int32 accumulators are
    the reference's exactly (the down GEMM's codes are the MLP hidden
    state's requant)."""
    x, c = _block_inputs(11)
    src = np.asarray(_stage_inputs_jax(_jax_block(), x, c)[stage])
    w = _weights(port_dit(True).blocks[0])[stage]
    jq, js = jkref.quantize_rows_int8_ref(jnp.asarray(src))
    tq, ts = tkref.quantize_rows_int8_ref(t(src))
    np.testing.assert_array_equal(to_np(tq), np.asarray(jq))
    np.testing.assert_array_equal(to_np(ts), np.asarray(js))
    np.testing.assert_array_equal(
        to_np(tkref.cim_gemm_int8_ref(tq, w)),
        np.asarray(jkref.cim_gemm_int8_ref(jq, jnp.asarray(to_np(w)))))


def test_integer_stages_on_each_sides_own_input():
    """The same stages fed each side's own input (the chain of the
    block's f32 elementwise ops in each framework): every row code
    within 1 LSB of the reference's, at most ``STAGE_CODE_RATE`` of them
    off by one."""
    x, c = _block_inputs(12)
    ref = _stage_inputs_jax(_jax_block(), x, c)
    got = _stage_inputs_port(port_dit(True).blocks[0], x, c)
    for stage in ref:
        jq, _ = jkref.quantize_rows_int8_ref(ref[stage])
        tq, _ = tkref.quantize_rows_int8_ref(got[stage])
        diff = np.abs(to_np(tq).astype(np.int32)
                      - np.asarray(jq).astype(np.int32))
        assert diff.max() <= 1, stage
        assert diff.mean() <= STAGE_CODE_RATE, (stage, diff.mean())


# ---------------------------------------------------------------------------
# one block, the whole forward
# ---------------------------------------------------------------------------
def test_block_matches_reference_oracle():
    cfg = get_dit_config(ARCH)
    x, c = _block_inputs(13)
    pos = np.broadcast_to(np.arange(cfg.tokens)[None], (2, cfg.tokens))
    want = jdit.dit_block_apply(_jax_block(1), jnp.asarray(x),
                                jnp.asarray(c), jget_dit(ARCH),
                                jnp.asarray(pos))
    got = tdit.dit_block_apply(port_dit(True).blocks[1], t(x), t(c), cfg,
                               t(pos), aligned_positions=True)
    rel_close(got, want, OUT_REL)


def test_block_matches_interpreted_pallas_kernels():
    """The reference's block on its Pallas kernels in interpret mode (as
    ``tests/test_diffusion.py`` runs it) against the port's block, whose
    CPU wrappers run the kernels' plain versions."""
    cfg = get_dit_config(ARCH)
    x, c = _block_inputs(14)
    pos = np.broadcast_to(np.arange(cfg.tokens)[None], (2, cfg.tokens))
    with jkernel_mode(True):
        want = jdit.dit_block_apply(_jax_block(), jnp.asarray(x),
                                    jnp.asarray(c), jget_dit(ARCH),
                                    jnp.asarray(pos))
    got = tdit.dit_block_apply(port_dit(True).blocks[0], t(x), t(c), cfg,
                               t(pos), aligned_positions=True)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=KERNEL_TOL,
                               atol=KERNEL_TOL)


@pytest.mark.parametrize("quantized", [True, False])
def test_forward_matches_reference(quantized):
    _, jm, params, qparams = jax_dit()
    x, tt, y = _inputs(15)
    want = jm.forward(qparams if quantized else params, jnp.asarray(x),
                      jnp.asarray(tt), jnp.asarray(y))
    m = port_dit(quantized)
    before = launch_counts()
    got = m(t(x), t(tt), t(y))
    assert launch_counts() == before           # the CPU launches nothing
    assert got.shape == (2, 4, 8, 8) and got.dtype == torch.float32
    rel_close(got, want, OUT_REL)
    rel_close(m.conditioning(t(tt), t(y)),
               jm.conditioning(qparams, jnp.asarray(tt), jnp.asarray(y)),
               OUT_REL)


def test_explicit_positions_and_kernel_mode_compute_the_same():
    """Explicit positions (the plain dense attention) and
    ``kernel_mode(False)`` (the GEMMs' plain oracles) are the CPU path's
    own functions: the same bits."""
    m = port_dit(True)
    x, tt, y = _inputs(16)
    a = m(t(x), t(tt), t(y))
    pos = torch.arange(16).expand(2, 16)
    with kernel_mode(False):
        b = m(t(x), t(tt), t(y), positions=pos)
    assert torch.equal(a, b)


def test_learn_sigma_doubles_the_output_channels():
    cfg = dataclasses.replace(get_dit_config(ARCH), learn_sigma=True)
    m = tdit.DiTModel(cfg).init(0, device="cpu")
    x, tt, y = _inputs(17)
    out = m(t(x), t(tt), t(y))
    assert out.shape == (2, 8, 8, 8) and bool(torch.isfinite(out).all())


def test_init_on_the_card_by_default_and_explicit_cpu():
    m = tdit.DiTModel(get_dit_config(ARCH))
    assert m.device.type == "meta"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            m.init(0)
    m.init(0, device="cpu")
    assert m.device.type == "cpu"
    a = tdit.DiTModel(get_dit_config(ARCH)).init(3, device="cpu")
    b = tdit.DiTModel(get_dit_config(ARCH)).init(3, device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                  b.parameters()))
