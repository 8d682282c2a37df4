"""Tensor-parallel INT8 serving of the port against its unsharded path
and the JAX reference, on the CPU (gloo process groups of 1, 2 and 4
ranks; the ranks run ``tests/torch_tp_ranks.py`` and import no JAX).

(a) Kernel 6's plain version (``cim_gemm_int8``, int8 x int8 -> int32)
    against ``repro.kernels.ops.cim_int8_gemm_acc`` in interpret mode and
    against the reference's oracle: exactly equal, ragged shapes
    included.  ``cim_hidden_int8`` and ``cim_quantized_matmul`` against
    the reference's ops within ``RTOL = 1e-6`` of the output's largest
    magnitude (tanh/exp may move an ulp), as ``test_torch_kernels.py``.
(b) Every ``quant/tp.py`` function (``matmul_column``, ``matmul_row``,
    ``mlp``, ``decode_attn``, ``decode_attn_paged``) and the grouped MoE
    (``grouped_moe``: ``quantized_moe_apply`` under the group) on
    each rank's shards of ``gemma-2b-smoke`` and ``qwen2-moe-a2.7b-smoke``
    (weights from the reference's ``Model.init``), at group sizes 1, 2
    and 4, plain and kernel path: bitwise equal to the rank's slice of
    the port's unsharded output, and to the reference's unsharded
    oracle by the rules of the existing tests: the GEMMs within 1e-6 of
    scale, the MLPs (dense and grouped, f32 before the cast to bf16)
    within ``MLP_TOL = 1e-5`` (``test_torch_kernels.py``,
    ``test_torch_moe.py``), attention within ``ATTN_TOL = 1e-5``.
    The collectives each call makes: 1 MAX + 1 SUM for a row-parallel
    GEMM and for the MLP, 1 gather for the experts, none otherwise.
    ``gemma-2b-smoke`` has one KV head, so at every size its ranks hold
    it whole (the reference's replicate-on-indivisible rule), and at 4
    ranks each attends a single q head.
(c) The engines at 2 ranks: ring, paged, and paged over a pool that must
    preempt, on both models.  Greedy tokens bitwise the port's unsharded
    engines' (which ``test_torch_serving.py``, ``test_torch_paged.py``
    and ``test_torch_moe_serving.py`` hold against JAX), and equal to
    fresh JAX engines by the rule of ``test_torch_moe_serving.py``
    (equal up to the first step where the streams part, which must be a
    near tie of the reference's logits; at least half compared).  The
    paged engines are held against fresh JAX paged engines, one slot per
    request (ROADMAP C.1).  Prefill + decode logits bitwise the
    unsharded port's.  Per rank: the sharded leaves hold 1/p of ``q``
    and ``scale``, the cache KH/p heads where KH divides (gemma's one
    head: the ring's slots cut by sequence, the paged pools whole); per
    layer and forward 2 MAX + 2 SUM (+1 gather for an MoE layer; on
    gemma's ring +1 gather a prefill, the rows' slots, and +2 a decode
    step, the q heads and kernel 9's partials), per forward the
    embedding's SUM and the logits' gather; kernel entry calls per
    layer: 6 per decode step and 5 per prefill for a dense layer, 9 and
    8 for an MoE layer, and on gemma's ring kernels 9 and 10 in place of
    kernel 5 (7 per decode step).
(d) At 4 ranks, models whose MLP (or routed experts) 4 does not divide:
    those leaves stay whole and run the unsharded path, the rest shard,
    and the tokens stay bitwise.
(e) The group and launcher plumbing: a group of one, a shard outside
    its group, a failing rank, the CLI.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.quant import QuantPlan as JPlan
from repro.serving import PagedServingEngine as JPagedEngine
from repro.serving import ServingEngine as JEngine

import torch_tp_ranks as ranks
from repro_torch.analysis import manifest
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import cim_gemm as cg
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import Model
from repro_torch.parallel.context import TPGroup, spawn, tp_context
from repro_torch.parallel.sharding import shard_model
from repro_torch.quant import (QuantPlan, quantized_moe_apply,
                               quantized_out_proj, quantized_qkv_proj)
from repro_torch.quant.linear import _canon_activation
from repro_torch.serving import (PagedServingEngine, Request, RequestStatus,
                                 ServingEngine)
from torch_parity import (assert_same_tokens, port_model, rng, serve_jax, t,
                          to_np)

RTOL = 1e-6
MLP_TOL = 1e-5
ATTN_TOL = 1e-5
LOGIT_ATOL = 0.15          # tests/test_torch_model.py
MARGIN = 2 * LOGIT_ATOL
ARCHS = ("gemma-2b", "qwen2-moe-a2.7b")
SIZES = (1, 2, 4)
FUNCTIONS = ("matmul_column", "matmul_row", "mlp", "grouped_moe",
             "decode_attn", "decode_attn_paged")
PROMPT_LENS = (3, 17, 9, 30, 5)
MAX_NEW = 8
RING_KW = dict(n_slots=3, max_len=64, prefill_bucket=16)
PAGED_KW = dict(n_slots=5, max_len=64, prefill_bucket=16, block_size=8,
                prefill_chunk=8)
# 12 allocatable blocks of 8 slots: the five requests need 16 at once
TIGHT_KW = dict(PAGED_KW, num_blocks=13)
# the deadline run: per request (None = none), and each rank's clock
# (start, seconds a read): rank 1's alone would expire other requests at
# other steps
DEADLINES = (None, 12.0, None, 3.0, 30.0)
CLOCKS = ((0.0, 1.0), (1e6, 0.5))


def close(a, b, rtol=RTOL):
    a, b = to_np(a), to_np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.abs(b).max()), 1e-30)
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * scale)


def exact(a, b):
    np.testing.assert_array_equal(to_np(a), to_np(b))


# ---------------------------------------------------------------------------
# (a) kernel 6 and the ops surface
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("M,K,N", [(1, 4, 4), (8, 128, 256), (13, 100, 36),
                                   (64, 256, 200), (3, 70, 128)])
def test_cim_gemm_int8_matches_jax(M, K, N):
    r = rng(60)
    x = r.integers(-127, 128, (M, K)).astype(np.int8)
    w = r.integers(-127, 128, (K, N)).astype(np.int8)
    want = jops.cim_int8_gemm_acc(jnp.asarray(x), jnp.asarray(w),
                                  interpret=True)
    got = cg.cim_gemm_int8(t(x), t(w))
    assert got.dtype == torch.int32 and got.shape == (M, N)
    exact(got, want)
    exact(got, jref.cim_gemm_int8_ref(jnp.asarray(x), jnp.asarray(w)))
    exact(ops.cim_int8_gemm_acc(t(x), t(w)), want)


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_cim_hidden_int8_matches_jax(gated, act):
    r = rng(61)
    M, K, N = 9, 128, 96
    xq = r.integers(-127, 128, (M, K)).astype(np.int8)
    xs = r.uniform(1e-3, 2e-2, (M, 1)).astype(np.float32)
    (uq, us), (gq, gs) = [(r.integers(-127, 128, (K, N)).astype(np.int8),
                           r.uniform(1e-3, 2e-2, N).astype(np.float32))
                          for _ in range(2)]
    if not gated:
        gq = gs = None
    j = [None if a is None else jnp.asarray(a)
         for a in (xq, xs, uq, us, gq, gs)]
    want = jops.cim_hidden_int8(*j, activation=act, interpret=True)
    got = ops.cim_hidden_int8(*[None if a is None else t(a)
                                for a in (xq, xs, uq, us, gq, gs)],
                              activation=act)
    assert got.dtype == torch.float32
    close(got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cim_quantized_matmul_matches_jax(dtype):
    r = rng(62)
    x = r.standard_normal((7, 200)).astype(np.float32)
    w = r.integers(-127, 128, (200, 72)).astype(np.int8)
    s = r.uniform(1e-3, 2e-2, 72).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bf16"
                               else jnp.float32)
    tx = t(x, torch.bfloat16 if dtype == "bf16" else torch.float32)
    want = jops.cim_quantized_matmul(jx, jnp.asarray(w), jnp.asarray(s),
                                     interpret=True)
    got = ops.cim_quantized_matmul(tx, t(w), t(s))
    close(got, want)
    # the unfused and the fused pipeline compute the same function
    exact(got, ops.cim_quantized_matmul_fused(tx, t(w), t(s)))


# ---------------------------------------------------------------------------
# (b) the TP functions at 1, 2 and 4 ranks
# ---------------------------------------------------------------------------
def _function_case(arch: str, seed: int) -> dict:
    """A quantized port model of ``arch`` (reference weights) and inputs
    at its widths: 5 activation rows, a 3-row int8 decode cache of 32
    slots and its paged layout (blocks of 8 in shuffled order)."""
    model = port_model(QuantPlan.full(), arch)
    cfg = model.cfg
    r = rng(seed)
    d, H, KH, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    bf = torch.bfloat16
    case = dict(model=model, act=_canon_activation(cfg.activation),
                x=t(r.standard_normal((5, d)).astype(np.float32), bf),
                res=t(r.standard_normal((5, d)).astype(np.float32), bf),
                attn_out=t(r.standard_normal((5, H, D)).astype(np.float32),
                           bf),
                q=t(r.standard_normal((3, 1, H, D)).astype(np.float32), bf))
    if cfg.moe is not None:
        E = cfg.moe.n_routed_experts
        counts = r.integers(1, 4, E).astype(np.int32)
        counts[[1, E - 2]] = 0
        xe = r.standard_normal((E, 6, d)).astype(np.float32)
        xe[counts == 0] = 0.0
        case.update(xe=t(xe, bf), counts=t(counts))
    B, S, bs = 3, 32, 8
    lengths = [32, 13, 1]
    pos = np.full((B, S), 2 ** 30, np.int32)
    for b, n in enumerate(lengths):
        pos[b, :n] = np.arange(n)
    ring = dict(k=r.integers(-127, 128, (B, S, KH, D)).astype(np.int8),
                v=r.integers(-127, 128, (B, S, KH, D)).astype(np.int8),
                k_scale=r.uniform(1e-3, 2e-2, (B, S, KH)).astype(np.float32),
                v_scale=r.uniform(1e-3, 2e-2, (B, S, KH)).astype(np.float32),
                pos=pos)
    nb = S // bs
    tables = (r.permutation(B * nb) + 1).astype(np.int32).reshape(B, nb)
    paged = {}
    for name, a in ring.items():
        fill = 2 ** 30 if name == "pos" else 0
        pool = np.full((1 + B * nb, bs) + a.shape[2:], fill, a.dtype)
        pool[tables.reshape(-1)] = a.reshape(B * nb, bs, *a.shape[2:])
        paged[name] = t(pool)
    paged["tables"] = t(tables)
    case["ring"] = {k: t(v) for k, v in ring.items()}
    case["ring"]["q_pos"] = t(np.array([n - 1 for n in lengths], np.int32))
    case["paged"] = paged
    return case


_RESULTS: dict = {}


def _function_results(p: int) -> dict:
    """Rank results of (b) at group size ``p``: one spawn per size (the
    engines of (c) ride along at 2 ranks, the fallbacks of (d) at 4)."""
    if p not in _RESULTS:
        cases = {f"fn/{arch}": ("functions", _function_case(arch, 70))
                 for arch in ARCHS}
        if p == 1:
            _RESULTS[1] = [ranks.run_cases(TPGroup(), cases)]
        else:
            cases.update(_ENGINE_CASES[p]())
            _RESULTS[p] = spawn(ranks.run_cases, p, args=(cases,))
    return _RESULTS[p]


def _heads_of(rank, p, H, KH):
    """The reference-independent statement of a rank's QKV head layout:
    [its q heads | its k heads | its v heads], KV heads whole when KH
    does not divide p."""
    q = list(range(rank * H // p, (rank + 1) * H // p))
    kv = (list(range(rank * KH // p, (rank + 1) * KH // p)) if KH % p == 0
          else list(range(KH)))
    return q + [H + j for j in kv] + [H + KH + j for j in kv]


def _unsharded(arch, fn, use_kernel):
    """(the port's unsharded output of ``fn``, the reference oracle's,
    the tolerance between them) on the inputs of :func:`_function_case`;
    the grouped MLP's outputs are f32 (the TP function returns them cast
    to x's dtype)."""
    case = _function_case(arch, 70)
    block = case["model"].layers[0]
    cfg = case["model"].cfg
    act = case["act"]
    if fn == "matmul_column":
        qkv = block.attn.qkv
        port = quantized_qkv_proj(qkv, case["x"], use_kernel=use_kernel)
        d = cfg.d_model
        jax = jref.fused_matmul_ref(
            jnp.asarray(to_np(case["x"])).astype(jnp.bfloat16),
            jnp.asarray(to_np(qkv.q).reshape(d, -1)),
            jnp.asarray(to_np(qkv.scale).reshape(-1))).reshape(port.shape)
        return port, jax, RTOL
    if fn == "matmul_row":
        o = block.attn.o
        port = quantized_out_proj(o, case["attn_out"], residual=case["res"],
                                  use_kernel=use_kernel)
        jax = jref.fused_matmul_ref(
            jnp.asarray(to_np(case["attn_out"]).reshape(5, -1)).astype(
                jnp.bfloat16),
            jnp.asarray(to_np(o.q).reshape(-1, cfg.d_model)),
            jnp.asarray(to_np(o.scale)),
            residual=jnp.asarray(to_np(case["res"])).astype(jnp.bfloat16))
        return port, jax, RTOL
    if fn == "mlp":
        mlp = block.moe.shared if cfg.moe is not None else block.mlp
        leaves = {k: (getattr(mlp, k).q, getattr(mlp, k).scale)
                  for k in ("up", "gate", "down")}
        if use_kernel:
            port = ops.cim_quantized_mlp(
                case["x"], *leaves["up"], *leaves["down"],
                gate_q=leaves["gate"][0], gate_scale=leaves["gate"][1],
                residual=case["res"], activation=act)
        else:
            port = tref.quantized_mlp_ref(case["x"], leaves, act,
                                          residual=case["res"])
        jax = jref.quantized_mlp_ref(
            jnp.asarray(to_np(case["x"])).astype(jnp.bfloat16),
            {k: (jnp.asarray(to_np(q)), jnp.asarray(to_np(s)))
             for k, (q, s) in leaves.items()}, act,
            residual=jnp.asarray(to_np(case["res"])).astype(jnp.bfloat16))
        return port, jax, MLP_TOL
    if fn == "grouped_moe":
        moe = block.moe
        leaves = {k: (getattr(moe, k).q, getattr(moe, k).scale)
                  for k in ("up", "gate", "down")}
        if use_kernel:
            port = ops.cim_quantized_grouped_mlp(
                case["xe"], *leaves["up"], *leaves["down"],
                gate_q=leaves["gate"][0], gate_scale=leaves["gate"][1],
                expert_counts=case["counts"], activation=act)
        else:
            port = tref.grouped_quantized_mlp_ref(case["xe"], leaves, act)
        assert torch.equal(port.to(torch.bfloat16), quantized_moe_apply(
            moe, case["xe"], act, use_kernel=use_kernel,
            expert_counts=case["counts"]))
        jax = jref.grouped_quantized_mlp_ref(
            jnp.asarray(to_np(case["xe"])).astype(jnp.bfloat16),
            {k: (jnp.asarray(to_np(q)), jnp.asarray(to_np(sc)))
             for k, (q, sc) in leaves.items()}, act)
        return port, jax, MLP_TOL
    ring, q = case["ring"], case["q"]
    B, _, H, D = q.shape
    KH = ring["k"].shape[2]
    q4 = q[:, 0].reshape(B, KH, H // KH, D)
    jq = jnp.asarray(to_np(q4)).astype(jnp.bfloat16)
    jring = {k: jnp.asarray(to_np(v)) for k, v in ring.items()}
    if fn == "decode_attn":
        args = (q4, ring["k"], ring["v"], ring["pos"], ring["q_pos"],
                ring["k_scale"], ring["v_scale"])
        port = (ops.decode_attention(*args) if use_kernel
                else tref.decode_attention_ref(*args[:5], k_scale=args[5],
                                               v_scale=args[6]))
        jax = jref.decode_attention_ref(
            jq, jring["k"], jring["v"], jring["pos"], jring["q_pos"],
            k_scale=jring["k_scale"], v_scale=jring["v_scale"])
    else:
        pg = case["paged"]
        args = (q4, pg["k"], pg["v"], pg["pos"], pg["tables"], ring["q_pos"],
                pg["k_scale"], pg["v_scale"])
        port = (ops.decode_attention_paged(*args) if use_kernel
                else tref.decode_attention_paged_ref(
                    *args[:6], k_scale_pages=args[6], v_scale_pages=args[7]))
        j = {k: jnp.asarray(to_np(v)) for k, v in pg.items()}
        jax = jref.decode_attention_paged_ref(
            jq, j["k"], j["v"], j["pos"], j["tables"], jring["q_pos"],
            k_scale_pages=j["k_scale"], v_scale_pages=j["v_scale"])
    return port.reshape(B, H, D), jnp.reshape(jax, (B, H, D)), ATTN_TOL


def _slice_of(fn, full, rank, p, cfg):
    """The part of the unsharded output that rank ``rank`` computes."""
    if fn == "matmul_column":
        idx = _heads_of(rank, p, cfg.n_heads, cfg.n_kv_heads)
        return full[:, idx].reshape(full.shape[0], -1)
    if fn in ("decode_attn", "decode_attn_paged"):
        H = cfg.n_heads
        return full[:, rank * H // p:(rank + 1) * H // p]
    return full


WANT_COLLECTIVES = {"matmul_column": (0, 0, 0), "matmul_row": (1, 1, 0),
                    "mlp": (1, 1, 0), "grouped_moe": (0, 0, 1),
                    "decode_attn": (0, 0, 0), "decode_attn_paged": (0, 0, 0)}


@pytest.mark.parametrize("path", ["plain", "kernel"])
@pytest.mark.parametrize("p", SIZES)
@pytest.mark.parametrize("arch,fn", [(a, f) for a in ARCHS for f in FUNCTIONS
                                     if f != "grouped_moe" or a != ARCHS[0]])
def test_tp_function_bitwise(arch, fn, p, path):
    cfg = reduced_config(get_config(arch))
    port, jax, tol = _unsharded(arch, fn, path == "kernel")
    close(port, np.asarray(jax), tol)
    if fn == "grouped_moe":
        port = port.to(torch.bfloat16)
    for rank, res in enumerate(_function_results(p)):
        got = res[f"fn/{arch}"][path]
        exact(got[fn], _slice_of(fn, to_np(port), rank, p, cfg))
        c = got[fn + ".counts"]
        assert (c["max"], c["sum"], c["gather"]) == WANT_COLLECTIVES[fn]


@pytest.mark.parametrize("p", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_shards_hold_one_pth(arch, p):
    """Each rank's leaves hold 1/p of ``q`` and of ``scale`` on the
    sharded axis; the KV heads shard where KH divides."""
    cfg = reduced_config(get_config(arch))
    d, H, KH, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    KH_r = KH // p if KH % p == 0 else KH
    want = {"kv_heads": KH_r,
            "attn.qkv": ((d, H // p + 2 * KH_r, D), (H // p + 2 * KH_r, D),
                         p),
            "attn.o": ((H // p, D, d), (d,), p)}
    if cfg.moe is None:
        F, name = cfg.d_ff, "mlp"
    else:
        E, Fe = cfg.moe.n_routed_experts, cfg.moe.d_expert
        F, name = cfg.moe.shared_width, "shared"
        want.update({"experts.up": ((E // p, d, Fe), (E // p, Fe), p),
                     "experts.gate": ((E // p, d, Fe), (E // p, Fe), p),
                     "experts.down": ((E // p, Fe, d), (E // p, d), p)})
    want.update({f"{name}.up": ((d, F // p), (F // p,), p),
                 f"{name}.gate": ((d, F // p), (F // p,), p),
                 f"{name}.down": ((F // p, d), (d,), p)})
    for res in _function_results(p):
        assert res[f"fn/{arch}"]["shapes"] == want


# ---------------------------------------------------------------------------
# (c) the engines at 2 ranks, (d) the fallbacks at 4
# ---------------------------------------------------------------------------
def _prompts():
    r = rng(30)
    return [r.integers(0, 256, n).astype(np.int32) for n in PROMPT_LENS]


ENGINES = (("ring", ServingEngine, RING_KW),
           ("paged", PagedServingEngine, PAGED_KW),
           ("tight", PagedServingEngine, TIGHT_KW))


def _logits_input():
    r = rng(31)
    toks = torch.as_tensor(r.integers(0, 256, (3, 16)), dtype=torch.long)
    return toks, torch.tensor([16, 11, 4], dtype=torch.int32)


def _engine_cases_2() -> dict:
    cases = {f"eng/{arch}": ("engines", dict(
        model=port_model(QuantPlan.full(), arch), engines=ENGINES,
        prompts=_prompts(), max_new=MAX_NEW, logits=_logits_input()))
        for arch in ARCHS}
    cases["deadlines/gemma-2b"] = ("deadlines", dict(
        model=port_model(None), engines=ENGINES[:2], prompts=_prompts(),
        deadlines=DEADLINES, clocks=CLOCKS, max_new=MAX_NEW))
    return cases


def _mixed_config(arch):
    """``arch``'s smoke config with the MLP (gemma-2b) or the routed
    experts (qwen2-moe) at a size that 4 ranks do not divide."""
    cfg = reduced_config(get_config(arch))
    if cfg.moe is None:
        return dataclasses.replace(cfg, d_ff=130, name=cfg.name + "-mixed")
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, n_routed_experts=6),
        name=cfg.name + "-mixed")


def _mixed_model(arch):
    return Model(_mixed_config(arch)).init(7, device="cpu").quantize(
        QuantPlan.full())


def _engine_cases_4() -> dict:
    return {f"mixed/{arch}": ("engines", dict(
        model=_mixed_model(arch), engines=ENGINES[:1], prompts=_prompts(),
        max_new=MAX_NEW)) for arch in ARCHS}


_ENGINE_CASES = {2: _engine_cases_2, 4: _engine_cases_4}
_UNSHARDED: dict = {}


def _serve_unsharded(key, model, cls, kw):
    if key not in _UNSHARDED:
        eng = cls(model, quant_plan=QuantPlan.full(), **kw)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=MAX_NEW)
                for i, p in enumerate(_prompts())]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        assert all(r.status is RequestStatus.OK for r in reqs)
        _UNSHARDED[key] = ([r.generated for r in reqs], eng.stats)
    return _UNSHARDED[key]


@pytest.mark.parametrize("engine", [e[0] for e in ENGINES])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_engine_tokens_bitwise(arch, engine):
    _, cls, kw = next(e for e in ENGINES if e[0] == engine)
    want, stats = _serve_unsharded((arch, engine), port_model(None, arch),
                                   cls, kw)
    for res in _function_results(2):
        got = res[f"eng/{arch}"][engine]
        assert got["status"] == ["ok"] * len(PROMPT_LENS)
        assert got["tokens"] == want
        assert got["decode_steps"] == stats.decode_steps
        assert got["preemptions"] == stats.preemptions
        if engine != "ring":
            assert got["blocks_held"] == 0
    if engine == "tight":
        assert stats.preemptions > 0


@pytest.mark.parametrize("engine", ["ring", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_engine_matches_jax(arch, engine):
    prompts = _prompts()
    if engine == "ring":
        jreqs, margins = serve_jax(arch, JEngine, JPlan.full(), prompts,
                                   max_new_tokens=MAX_NEW, **RING_KW)
    else:
        jreqs, margins = [], {}
        for uid in range(len(prompts)):
            one, m = serve_jax(arch, JPagedEngine, JPlan.full(), prompts,
                               [uid], MAX_NEW, **dict(PAGED_KW, n_slots=1))
            jreqs += one
            margins.update(m)
    got = _function_results(2)[0][f"eng/{arch}"][engine]["tokens"]
    assert all(len(toks) == MAX_NEW for toks in got)
    assert_same_tokens(jreqs, margins, got, MARGIN, (arch, engine))


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_engine_launches_and_collectives(arch):
    """Per rank, layer and forward: kernel entry calls 6 per decode step
    and 5 per prefill for a dense layer (9 and 8 for an MoE layer; on
    gemma-2b's ring, cut by sequence, kernels 9 and 10 in place of
    kernel 5: 7 per decode step), and 2 MAX + 2 SUM reductions (+1
    gather for an MoE layer; +1 gather a prefill and +2 a decode step on
    gemma-2b's ring); per forward one SUM (the embedding) and one gather
    (the logits)."""
    moe = arch != "gemma-2b"
    cfg = reduced_config(get_config(arch))
    L = cfg.n_layers
    for res in _function_results(2):
        for engine in ("ring", "paged"):
            got = res[f"eng/{arch}"][engine]
            steps = got["decode_steps"]
            fwd = steps + (got["prefill_chunks"] if engine == "paged"
                           else got["prefills"])
            seq = not moe and engine == "ring"
            want = dict.fromkeys(ranks.SPY_NAMES + ranks.SPY_ATTN, 0)
            want.update(cim_gemm_int8_fused_qin=L * fwd,
                        cim_gemm_int8=2 * L * fwd,
                        quantize_rows_int8=(2 if moe else 1) * L * fwd,
                        cim_gated_gemm_int8=L * fwd)
            if seq:
                want.update(decode_attention_partial=L * steps,
                            decode_attention_combine=L * steps)
            else:
                want["decode_attention" if engine == "ring"
                     else "decode_attention_paged"] = L * steps
            if moe:
                want.update(cim_grouped_gated_gemm_int8=L * fwd,
                            cim_grouped_gemm_int8=L * fwd)
            assert got["launches"] == want, engine
            per_step, per_prefill = (9, 8) if moe else (7 if seq else 6, 5)
            assert sum(want.values()) == L * (per_step * steps
                                              + per_prefill * (fwd - steps))
            gather = L * fwd if moe else 0
            if seq:
                gather += L * (2 * steps + (fwd - steps))
            want_coll = dict(max=2 * L * fwd, sum=2 * L * fwd + fwd,
                             gather=gather + fwd, bcast=0)
            assert got["collectives"] == want_coll, engine
            assert dict(manifest.run_collectives(
                cfg, steps, fwd - steps, kv_len=RING_KW["max_len"],
                paged=engine == "paged"), bcast=0) == want_coll


@pytest.mark.parametrize("engine", ["ring", "paged"])
def test_tp_deadlines_follow_rank0_clock(engine):
    """Two ranks on different clocks (``CLOCKS``) serve requests with
    deadlines: rank 0's clock decides, in one broadcast per step with a
    pending deadline, so both ranks time out the same requests (one
    mid-decode, one while queued) at the same step, and every status,
    token and step is the unsharded engine's on rank 0's clock."""
    _, cls, kw = next(e for e in ENGINES if e[0] == engine)

    def unsharded(clock):
        eng = cls(port_model(None), quant_plan=QuantPlan.full(),
                  clock=ranks.StepClock(*clock), **kw)
        return ranks.serve_with_deadlines(eng, _prompts(), DEADLINES,
                                          MAX_NEW)
    want = unsharded(CLOCKS[0])
    assert want["status"] == ["ok", "timed_out", "ok", "timed_out", "ok"]
    assert want["tokens"][1] and not want["tokens"][3]
    assert unsharded(CLOCKS[1])["ended"] != want["ended"]
    for res in _function_results(2):
        got = res["deadlines/gemma-2b"][engine]
        for key in ("status", "tokens", "ended", "steps"):
            assert got[key] == want[key], key
        assert got["collectives"]["bcast"] == want["with_deadline"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_engine_caches_hold_rank_heads(arch):
    cfg = reduced_config(get_config(arch))
    KH = cfg.n_kv_heads
    for res in _function_results(2):
        for engine in ("ring", "paged"):
            heads = res[f"eng/{arch}"][engine]["cache_kv_heads"]
            assert heads == (KH // 2 if KH % 2 == 0 else KH,) * cfg.n_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_logits_bitwise(arch):
    model = port_model(QuantPlan.full(), arch)
    toks, lengths = _logits_input()
    caches = model.init_cache(3, 32, kv_dtype="int8")
    with torch.no_grad():
        a = model.prefill_padded(toks, caches, lengths)
        b = model.decode_step(a.argmax(-1), caches)
    want = to_np(torch.cat([a, b], dim=1))
    for res in _function_results(2):
        exact(res[f"eng/{arch}"]["logits"], want)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_fallback_keeps_indivisible_leaves_whole(arch):
    """At 4 ranks gemma's MLP of 130 and qwen2-moe's 6 routed experts
    stay whole and run unsharded; attention (and qwen2-moe's shared MLP)
    shard; the tokens are the unsharded engine's."""
    want, stats = _serve_unsharded(("mixed", arch), _mixed_model(arch),
                                   ServingEngine, RING_KW)
    L = reduced_config(get_config(arch)).n_layers
    fwd = stats.decode_steps + stats.prefills
    for res in _function_results(4):
        got = res[f"mixed/{arch}"]
        assert got["ring"]["tokens"] == want
        shapes = got["shapes"]
        assert shapes["attn.o"][2] == 4
        # per forward the embedding's SUM and the logits' gather
        if arch == "gemma-2b":
            # the one KV head's ring cut by sequence: +1 gather a
            # prefill (the rows' slots), +2 a decode step (q, partials)
            assert shapes["mlp.up"][2] is None
            assert got["ring"]["collectives"] == dict(
                max=L * fwd, sum=L * fwd + fwd,
                gather=L * (fwd + stats.decode_steps) + fwd, bcast=0)
        else:
            assert shapes["experts.up"][2] is None
            assert shapes["shared.up"][2] == 4
            assert got["ring"]["collectives"] == dict(
                max=2 * L * fwd, sum=2 * L * fwd + fwd, gather=fwd,
                bcast=0)


# ---------------------------------------------------------------------------
# (e) plumbing
# ---------------------------------------------------------------------------
def test_group_of_one_counts_and_returns_input():
    g = TPGroup()
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert g.all_reduce_max(x) is x and g.all_reduce_sum(x) is x
    assert g.all_gather(x) is x and g.agree(b"any")
    assert g.broadcast_flags([True, False]) == [True, False]
    assert g.counts == {"max": 1, "sum": 1, "gather": 1, "bcast": 1}
    g.reset_counts()
    assert g.counts == {"max": 0, "sum": 0, "gather": 0, "bcast": 0}
    with pytest.raises(ValueError):
        TPGroup(0, 2)                  # no backend
    with pytest.raises(ValueError):
        TPGroup(2, 2, "gloo")          # rank outside the group


def test_sharded_leaf_needs_its_group():
    model = shard_model(port_model(QuantPlan.full()), TPGroup())
    x = torch.zeros((1, 2, model.cfg.d_model), dtype=torch.bfloat16)
    qkv = model.layers[0].attn.qkv
    with pytest.raises(RuntimeError, match="tensor-parallel group"):
        quantized_qkv_proj(qkv, x)
    with tp_context(TPGroup()):
        assert quantized_qkv_proj(qkv, x).shape[-2] == qkv.q.shape[1]


def test_tp_engine_refuses_what_ranks_cannot_agree_on():
    with pytest.raises(ValueError, match="quant_plan"):
        ServingEngine(port_model(None), tp=TPGroup())
    eng = ServingEngine(port_model(None), quant_plan=QuantPlan.full(),
                        tp=TPGroup(), **RING_KW)
    # deadlines are decided by rank 0's clock, so they are accepted
    assert eng.submit(Request(uid=0, prompt=np.ones(3, np.int32),
                              deadline_s=5.0)) is RequestStatus.QUEUED


def _fails_on_rank_1(group):
    if group.rank == 1:
        raise ArithmeticError("rank 1 gives up")
    group.barrier()
    return group.rank


def test_spawn_raises_for_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 gives up"):
        spawn(_fails_on_rank_1, 2, timeout_s=60)


def test_serve_cli_tp_on_cpu(capsys):
    from repro_torch.launch import serve
    argv = ["--device", "cpu", "--reduced", "--int8", "--requests", "3",
            "--slots", "2", "--max-new", "4", "--max-len", "32"]
    one = serve.main(argv)
    two = serve.main(argv + ["--tp", "2"])
    assert [r.generated for r in two] == [r.generated for r in one]
    assert all(r.status is RequestStatus.OK for r in two)
    assert "served 3 requests on 2 ranks on cpu (gloo)" in \
        capsys.readouterr().out
    with pytest.raises(SystemExit):            # --tp without --int8
        serve.main(["--tp", "2", "--device", "cpu"])
