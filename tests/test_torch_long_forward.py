"""The cacheless forward above 2048 tokens, the port against the JAX
reference, on the CPU.

Without a cache the reference attends densely up to
``DENSE_SEQ_THRESHOLD`` = 2048 tokens and with ``blockwise_attention``
(an online softmax over KV blocks) above it.  The port does the same:
on the card, with the model's own positions, above the threshold it
launches kernel 12 (held against its plain version by
``tests/test_torch_cuda.py``); on CPU tensors, and for caller-given
positions on either device, it runs its copy of the reference's
``blockwise_attention``.

* The port's ``blockwise_attention`` against the reference's on the same
  numpy inputs: f32 within ``TOL["f32"]`` = 1e-5 (summation order), bf16
  within ``TOL["bf16"]`` = 2e-2 (both round the score and PV einsums to
  bf16, and the two frameworks accumulate those in different orders, so
  a product may land one bf16 ulp apart).
* ``Model.forward`` without caches at S = 4096 on ``gemma-2b-smoke``,
  reference weights carried over by ``convert.py``, unquantized and
  under the full plan: the int8 weights of layer 0 and the int8 codes and
  scales of its first activation quantization exact; logits within
  ``LOGIT_ATOL`` = 0.15 (``tests/test_torch_model.py``); the greedy
  argmax at every position equal to the reference's unless the
  reference's top-2 margin there is at most twice that.
* The dispatch: S <= 2048 takes ``dense_attention``, S > 2048 the
  blockwise path on the CPU, whatever the positions; nothing launches.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.quant import QuantPlan as JPlan

from repro_torch.kernels import launch_counts
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.quant import QuantizedLinear, QuantPlan
from torch_parity import port_model, rng, smoke, t, to_np

TOL = {"f32": 1e-5, "bf16": 2e-2}
LOGIT_ATOL = 0.15
MARGIN = 2 * LOGIT_ATOL
S_LONG = 4096
SENTINEL = 2 ** 30


def _qkv(seed, B, S, H, KH, D, dtype):
    r = rng(seed)
    arrs = [r.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, D), (B, S, KH, D), (B, S, KH, D))]
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    return [jnp.asarray(a).astype(jd) for a in arrs], [t(a, td) for a in arrs]


def _close(a, b, tol):
    np.testing.assert_allclose(to_np(a), to_np(b), rtol=tol, atol=tol)


# (B, S, H, KH, D, q_block, kv_block): S a multiple of neither block, G 2;
# G 8 (MQA) over several KV blocks; one block each way (the blocks are
# cut to S, as in the reference)
SHAPES = [(2, 300, 4, 2, 16, 64, 96), (1, 257, 8, 1, 32, 128, 64),
          (1, 200, 4, 4, 16, 512, 1024)]


@pytest.mark.parametrize("B,S,H,KH,D,q_block,kv_block", SHAPES)
@pytest.mark.parametrize("kind,window", [("causal", None), ("sliding", 37)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_blockwise_matches_jax(dtype, kind, window, B, S, H, KH, D, q_block,
                               kv_block):
    (jq, jk, jv), (q, k, v) = _qkv(1, B, S, H, KH, D, dtype)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want = jattn.blockwise_attention(jq, jk, jv, jnp.asarray(pos),
                                     jnp.asarray(pos), kind, window,
                                     q_block=q_block, kv_block=kv_block)
    got = tattn.blockwise_attention(q, k, v, t(pos), t(pos), kind, window,
                                    q_block=q_block, kv_block=kv_block)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, TOL[dtype])


def _padded_positions(S, lengths, offsets):
    """Per-row positions ``offset + arange`` with the 2**30 sentinel past
    each row's length, as ``Model.prefill_padded`` builds them."""
    ar = np.arange(S, dtype=np.int64)
    pos = [np.where(ar < n, ar + o, SENTINEL) for n, o in zip(lengths,
                                                              offsets)]
    return np.stack(pos).astype(np.int32)


@pytest.mark.parametrize("kind,window", [("causal", None), ("sliding", 50)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_blockwise_caller_positions_match_jax(dtype, kind, window):
    """Caller-given positions: rows offset by 0 and 700, and sentinel
    padding past each row's length (the padded queries and keys take
    the reference's mask)."""
    B, S, H, KH, D = 2, 333, 4, 1, 16
    (jq, jk, jv), (q, k, v) = _qkv(2, B, S, H, KH, D, dtype)
    pos = _padded_positions(S, (333, 290), (0, 700))
    want = jattn.blockwise_attention(jq, jk, jv, jnp.asarray(pos),
                                     jnp.asarray(pos), kind, window,
                                     q_block=128, kv_block=96)
    got = tattn.blockwise_attention(q, k, v, t(pos), t(pos), kind, window,
                                    q_block=128, kv_block=96)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("kind,window", [("causal", None), ("sliding", 29)])
def test_blockwise_is_dense_attention(kind, window):
    """The same function as the port's dense path at positions arange(S),
    f32 within the summation order."""
    _, (q, k, v) = _qkv(3, 2, 280, 4, 2, 16, "f32")
    pos = torch.arange(280).expand(2, 280)
    _close(tattn.blockwise_attention(q, k, v, pos, pos, kind, window,
                                     q_block=64, kv_block=64),
           tattn.dense_attention(q, k, v, pos, pos, kind, window),
           TOL["f32"])


# ---------------------------------------------------------------------------
# the model's cacheless forward at S = 4096
# ---------------------------------------------------------------------------
def _tokens():
    return rng(40).integers(0, 256, (1, S_LONG)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_logits(plan_name: str) -> np.ndarray:
    _, jm, params = smoke()
    p = params if plan_name == "none" else jm.quantize(params, JPlan.full())
    logits, _, _ = jm.forward(p, {"inputs": jnp.asarray(_tokens())})
    return to_np(logits)


@pytest.mark.parametrize("plan_name", ["full", "none"])
def test_long_forward_matches_jax(plan_name):
    want = _jax_logits(plan_name)
    m = port_model(QuantPlan.full() if plan_name == "full" else None)
    with torch.no_grad():
        got = to_np(m(torch.as_tensor(_tokens()).long()))
    assert got.shape == want.shape == (1, S_LONG, 256)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
    # greedy argmax equal wherever the reference's top-2 margin is wider
    # than twice the logit tolerance
    top2 = np.sort(want, -1)[..., -2:]
    differ = got.argmax(-1) != want.argmax(-1)
    assert (top2[..., 1] - top2[..., 0])[differ].max(initial=0) <= MARGIN
    assert differ.mean() < 0.01


def test_long_forward_int8_stages_of_layer0_exact():
    """Under the full plan: layer 0's int8 weights and scales, and the
    int8 codes and row scales of its first activation quantization (the
    QKV GEMM's input: rmsnorm of the embedded 4096 tokens), exactly the
    reference's."""
    _, jm, params = smoke()
    jp = jm.quantize(params, JPlan.full())
    g = jp["group_0"]
    m = port_model(QuantPlan.full())
    attn = m.layers[0].attn
    for mod, jtree, names in ((attn, g["attn"], ("qkv", "o")),
                              (m.layers[0].mlp, g["mlp"],
                               ("up", "gate", "down"))):
        for name in names:
            leaf = getattr(mod, name)
            assert isinstance(leaf, QuantizedLinear)
            for part in ("q", "scale"):
                np.testing.assert_array_equal(
                    to_np(getattr(leaf, part)),
                    to_np(getattr(jtree[name], part)[0]))
    toks = _tokens()
    jx = jp["embed"]["embedding"][jnp.asarray(toks)]
    jh = jlayers.rmsnorm_apply({"scale": g["mixer_norm"]["scale"][0]}, jx)
    jq, js = jref.quantize_rows_int8_ref(jh.reshape(S_LONG, -1))
    tx = tlayers.embedding_apply(m.embed, torch.as_tensor(toks).long())
    th = tlayers.rmsnorm_apply(m.layers[0].mixer_norm, tx)
    tq, ts = tref.quantize_rows_int8_ref(th.reshape(S_LONG, -1))
    np.testing.assert_array_equal(to_np(tq), to_np(jq))
    np.testing.assert_array_equal(to_np(ts), to_np(js))


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
@pytest.fixture
def calls(monkeypatch):
    """Count the attention paths the model takes."""
    seen = {"dense": 0, "blockwise": 0}

    def spy(name, fn):
        def counted(*a, **kw):
            seen[name] += 1
            return fn(*a, **kw)
        return counted
    monkeypatch.setattr(tattn, "dense_attention",
                        spy("dense", tattn.dense_attention))
    monkeypatch.setattr(tattn, "blockwise_attention",
                        spy("blockwise", tattn.blockwise_attention))
    return seen


@pytest.mark.parametrize("S,path", [(2048, "dense"), (2049, "blockwise")])
@pytest.mark.parametrize("given", [False, True])
def test_cacheless_dispatch_on_cpu(calls, S, path, given):
    """Up to 2048 tokens the forward attends densely, above it blockwise,
    in every layer, with the default positions or caller-given ones;
    a CPU forward launches no kernel."""
    m = port_model(None)
    toks = torch.as_tensor(rng(41).integers(0, 256, (1, S))).long()
    pos = torch.arange(S)[None] if given else None
    before = launch_counts()
    with torch.no_grad():
        m(toks, positions=pos, last_index=torch.tensor([S - 1]))
    assert launch_counts() == before
    L = m.cfg.n_layers
    assert calls == {"dense": L if path == "dense" else 0,
                     "blockwise": L if path == "blockwise" else 0}
    assert tattn.DENSE_SEQ_THRESHOLD == jattn.DENSE_SEQ_THRESHOLD == 2048
