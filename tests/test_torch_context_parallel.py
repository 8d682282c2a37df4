"""Context parallelism at serving (ROADMAP A.3, ``kv_seq``): the ring
cache of gemma-2b-smoke's one KV head and deepseek-v3-smoke's MLA latent
cache cut by sequence over 2 gloo ranks on the CPU (the ranks run
``tests/torch_tp_ranks.py`` and import no JAX).

A ring of ``CAP`` = 128 slots: rank r holds slots [64 r, 64 r + 64).
The direct loop prefills three rows at once, of 150 tokens (gemma's
ring wraps: the S >= cap write; MLA's latent cache is no ring and
takes 120), 90 (across the shards' boundary) and 20 (rank 1's shard
empty through every step), then decodes ``STEPS`` greedy tokens.

(a) ``_ring_update`` and ``_write_latent`` on a shard, each path (S == 1,
    S >= cap, the scatter with pads), equal the whole write's slots;
    kernel 9's plain version on each of 2 and 4 ranks' slots
    (``cluster_slots``) merged by kernel 10's within ``1e-5`` of the
    reference's split walk in interpret mode, and bitwise the port's
    unsharded walk in as many splits.
(b) Every cache leaf on each rank after the prefill and after every
    decode step: bitwise the unsharded cache's slots of that rank.
(c) The logits of every forward bitwise the unsharded port's walked as
    the ranks walk: gemma's split walk forced to 2 splits
    (``ops.walk_as_ranks``: the ranks' 1 split each, merged by kernel
    10's plain version; MLA's latent as 2 merged chunks, the merge plain
    torch); MLA within
    ``MLA_TOL`` of the largest |logit| of the unsharded port's default
    walk, the greedy tokens equal.
(d) The ring engine at 2 ranks: tokens bitwise the unsharded engine's,
    and equal to the unsharded JAX reference's ring engine by the rule
    of ``test_torch_serving.py`` (the JAX TP tests fail, ROADMAP C.4);
    gemma's logits within ``LOGIT_ATOL`` of the reference's wherever the
    streams agree so far (MLA's are not held to the jitted reference:
    its fused bf16 roundings flip near ties of the router,
    ``test_torch_mla_serving.py``).
(e) Each rank's cache leaves hold exactly ``shard_nbytes`` of the whole
    leaf under ``resolve_spec`` on ``{"data": 1, "model": 2}``; the
    direct loop's launches and collectives are the manifest's.
(f) One rule cuts (``parallel.sharding.seq_cut_slots``): each cache
    records its own cut on its slot leaf, so caches of two capacities
    coexist on one model; ``quant.tp.seq_cut`` reads it, or walks a
    whole cache as ranks inside ``ops.walk_as_ranks``.
"""
from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

import torch_tp_ranks as ranks
from repro.quant import QuantPlan as JPlan
from repro.serving import ServingEngine as JEngine
from repro_torch.analysis import manifest
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import ops
from repro_torch.models.attention import _ring_update
from repro_torch.models.mla import _write_latent
from repro_torch.parallel.context import spawn
from repro_torch.parallel.sharding import (cache_axes, record_slot_range,
                                           resolve_spec, seq_cut_slots,
                                           shard_nbytes, slot_range)
from repro_torch.quant import tp as qtp
from repro_torch.quant import QuantPlan
from repro_torch.serving import ServingEngine
from torch_parity import assert_same_tokens, port_model, rng, smoke

ARCHS = ("gemma-2b", "deepseek-v3-671b")
P = 2
CAP = 128
DIRECT_LENS = {"gemma-2b": (150, 90, 20), "deepseek-v3-671b": (120, 90, 20)}
STEPS = 5
ENGINE_LENS = (100, 20, 70)
MAX_NEW = 6
RING_KW = dict(n_slots=3, max_len=CAP, prefill_bucket=16)
LOGIT_ATOL = 0.15            # tests/test_torch_serving.py
MARGIN = 2 * LOGIT_ATOL
# MLA's decode merges the ranks' softmax sums in another order than the
# unsharded row's: within this fraction of the largest |logit| (0 seen
# at these sizes)
MLA_TOL = 1e-3


def _direct_input(arch):
    lens = DIRECT_LENS[arch]
    r = rng(50)
    toks = torch.as_tensor(r.integers(0, _cfg(arch).vocab,
                                      (len(lens), max(lens))))
    return toks, torch.tensor(lens, dtype=torch.int32)


def _prompts(cfg):
    r = rng(51)
    return [r.integers(0, cfg.vocab, n).astype(np.int32) for n in ENGINE_LENS]


def _cfg(arch):
    return reduced_config(get_config(arch))


_RESULTS: dict = {}


def _results() -> list:
    if not _RESULTS:
        cases = {arch: ("context", dict(
            model=port_model(QuantPlan.full(), arch), cap=CAP, steps=STEPS,
            direct=_direct_input(arch), kw=RING_KW,
            prompts=_prompts(_cfg(arch)), max_new=MAX_NEW))
            for arch in ARCHS}
        _RESULTS["ranks"] = spawn(ranks.run_cases, P, args=(cases,))
    return _RESULTS["ranks"]


_UNSHARDED: dict = {}


def _unsharded(arch, as_ranks: bool = False):
    """The unsharded port's direct loop, on one thread as the ranks run;
    ``as_ranks``: its decode walked as P ranks walk theirs
    (``ops.walk_as_ranks``: the ring in P splits, MLA's latent in P
    merged chunks)."""
    key = (arch, as_ranks)
    if key not in _UNSHARDED:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            model = port_model(QuantPlan.full(), arch)
            toks, lengths = _direct_input(arch)
            with (ops.walk_as_ranks(P) if as_ranks else
                  contextlib.nullcontext()):
                _UNSHARDED[key] = ranks.direct_loop(model, None, toks,
                                                    lengths, CAP, STEPS)
        finally:
            torch.set_num_threads(threads)
    return _UNSHARDED[key]


# ---------------------------------------------------------------------------
# (a) the writes on a shard, each path
# ---------------------------------------------------------------------------
WRITES = {"decode": (1, None), "wrap": (150, (150, 140, 20)),
          "scatter": (40, (40, 33, 4))}


@pytest.mark.parametrize("path", list(WRITES))
def test_ring_update_on_a_shard_is_the_whole_write_cut(path):
    S, valid = WRITES[path]
    r = rng(52)
    whole = torch.as_tensor(r.integers(-127, 128, (3, CAP, 1, 4)),
                            dtype=torch.int8)
    new = torch.as_tensor(r.integers(-127, 128, (3, S, 1, 4)),
                          dtype=torch.int8)
    idx = torch.tensor([0, 60, 125], dtype=torch.int32)
    vl = None if valid is None else torch.tensor(valid, dtype=torch.int32)
    shards = [whole[:, k * 64:(k + 1) * 64].clone() for k in range(P)]
    _ring_update(whole, new, idx, vl)
    for k, buf in enumerate(shards):
        _ring_update(buf, new, idx, vl, seq=(k * 64, CAP))
        assert torch.equal(buf, whole[:, k * 64:(k + 1) * 64]), k


@pytest.mark.parametrize("S", [1, 40])
def test_write_latent_on_a_shard_is_the_whole_write_cut(S):
    r = rng(53)
    whole = torch.as_tensor(r.standard_normal((3, CAP, 8))).to(torch.bfloat16)
    new = torch.as_tensor(r.standard_normal((3, S, 8))).to(torch.bfloat16)
    idx = torch.tensor([0, 60, 125], dtype=torch.int32)
    shards = [whole[:, k * 64:(k + 1) * 64].clone() for k in range(P)]
    _write_latent(whole, new, idx)
    for k, buf in enumerate(shards):
        _write_latent(buf, new, idx, seq=(k * 64, CAP))
        assert torch.equal(buf, whole[:, k * 64:(k + 1) * 64]), k


# kernel 9 on each rank's slots (its wrapper's ``cluster_slots``: on the
# card the whole ring's cluster; the plain version has none) merged by
# kernel 10, against the reference's split walk in interpret mode at p s
# splits (tests/test_torch_splitkv.py's rule: ATTN_TOL of the largest
# |value|); rows visible on rank 0 alone and an all-empty row included
@pytest.mark.parametrize("p", [2, 4])
def test_rank_partials_merged_match_jax_split_walk(p):
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro_torch.kernels import decode_attention as da
    r = rng(54)
    B, S, KH, G, D = 4, 512, 1, 4, 16
    q = r.standard_normal((B, KH, G, D)).astype(np.float32)
    k, v = (r.integers(-127, 128, (B, S, KH, D)).astype(np.int8)
            for _ in range(2))
    ks, vs = (r.uniform(1e-3, 2e-2, (B, S, KH)).astype(np.float32)
              for _ in range(2))
    pos = np.full((B, S), 2 ** 30, np.int32)
    for b, n in enumerate((512, 100, 1, 0)):
        pos[b, :n] = r.permutation(n)
    qp = np.array([511, 99, 0, 0], np.int32)
    L = S // p
    n = ops.n_splits_for(L)
    parts = [da.decode_attention_partial(
        *(torch.from_numpy(np.ascontiguousarray(a[:, k0:k0 + L]))
          if a.ndim > 1 and a.shape[1] == S else torch.from_numpy(a)
          for a in (q, k, v, pos, qp, ks, vs)),
        n_splits=n, cluster_slots=S) for k0 in range(0, S, L)]
    o, m, l = (torch.cat([t[i] for t in parts], dim=2) for i in range(3))
    got = ops.decode_attention_combine(o, m, l, torch.float32)
    want = jops.decode_attention_splitkv(
        *(jnp.asarray(a) for a in (q, k, v, pos, qp)), k_scale=jnp.asarray(
            ks), v_scale=jnp.asarray(vs), block_k=64, n_splits=p * n,
        interpret=True)
    want = np.asarray(want, np.float32)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    # the unsharded port's walk in p s splits, bit for bit
    whole = ops.decode_attention(*(torch.from_numpy(a) for a in (
        q, k, v, pos, qp, ks, vs)), n_splits=p * n)
    assert torch.equal(got, whole)
    assert da.walk_plan(L, D, G, torch.int8, "split", n,
                        cluster_slots=S).cluster == da.cluster_for(S, D)


# ---------------------------------------------------------------------------
# (b) the caches, (c) the logits
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_caches_slot_by_slot(arch):
    want = _unsharded(arch)["caches"]
    for k, res in enumerate(_results()):
        got = res[arch]["caches"]
        assert len(got) == len(want) == STEPS + 1
        for t, (g, w) in enumerate(zip(got, want)):
            for layer, (gl, wl) in enumerate(zip(g, w)):
                assert set(gl) == set(wl)
                for name, leaf in gl.items():
                    whole = wl[name]
                    if name != "index":
                        L = leaf.shape[1]
                        whole = whole[:, k * L:(k + 1) * L]
                        assert L == CAP // P, (name, leaf.shape)
                    np.testing.assert_array_equal(leaf, whole,
                                                  err_msg=(t, layer, name))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_bitwise_the_unsharded_walk_as_ranks(arch):
    """gemma: each rank walks its 64 slots in one split
    (``n_splits_for(64)``), so the merged output is the unsharded walk's
    at 2 splits; MLA: the unsharded latent walked as 2 merged chunks."""
    want = _unsharded(arch, as_ranks=True)["logits"]
    for res in _results():
        np.testing.assert_array_equal(res[arch]["logits"], want)


def test_mla_decode_within_tolerance():
    want = _unsharded("deepseek-v3-671b")["logits"]
    for res in _results():
        got = res["deepseek-v3-671b"]["logits"]
        assert got.shape == want.shape and np.isfinite(got).all()
        assert np.abs(got - want).max() <= MLA_TOL * np.abs(want).max()
        assert (got.argmax(-1) == want.argmax(-1)).all()


# ---------------------------------------------------------------------------
# (d) the engine
# ---------------------------------------------------------------------------
def _serve_unsharded(arch):
    eng = ServingEngine(port_model(None, arch), quant_plan=QuantPlan.full(),
                        **RING_KW)
    return ranks.served_logits(eng, _prompts(_cfg(arch)), MAX_NEW)


def _serve_jax(arch):
    from repro.serving import Request as JRequest
    _, jm, params = smoke(arch)
    eng = JEngine(jm, params, quant_plan=JPlan.full(), **RING_KW)
    seen, margins = {}, {}
    sample = eng._sample

    def recording(req, logits, step):
        seen[(req.uid, step)] = np.asarray(logits, np.float32)
        top = np.sort(np.asarray(logits, np.float64))[-2:]
        margins[(req.uid, step)] = top[1] - top[0]
        return sample(req, logits, step)
    eng._sample = recording
    reqs = [JRequest(uid=i, prompt=p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(_prompts(_cfg(arch)))]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert all(r.status.value == "ok" for r in reqs)
    return reqs, margins, seen


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_unsharded_and_jax(arch):
    port = _serve_unsharded(arch)
    jreqs, margins, jlogits = _serve_jax(arch)
    for res in _results():
        got = res[arch]["engine"]
        assert got["status"] == ["ok"] * len(ENGINE_LENS)
        assert got["tokens"] == port["tokens"]
        assert_same_tokens(jreqs, margins, got["tokens"], MARGIN, arch)
        if arch != "gemma-2b":
            continue
        for key, want in jlogits.items():
            if key in got["logits"] and all(
                    a == b for a, b in zip(
                        jreqs[key[0]].generated[:key[1]],
                        got["tokens"][key[0]][:key[1]])):
                assert np.abs(got["logits"][key] - want).max() <= \
                    LOGIT_ATOL, (arch, key)


# ---------------------------------------------------------------------------
# (e) bytes, launches and collectives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_bytes_are_the_dry_runs_shards(arch):
    model = port_model(QuantPlan.full(), arch)
    whole = model.init_cache(RING_KW["n_slots"], CAP, kv_dtype="int8")
    axes = cache_axes(model, "int8")
    grid = {"data": 1, "model": P}
    want = [{k: shard_nbytes(t, resolve_spec(tuple(t.shape), a[k], grid),
                             grid) for k, t in c.items()}
            for c, a in zip(whole, axes)]
    cut = sum(v for c in want for k, v in c.items() if k != "index")
    full = sum(t.numel() * t.element_size() for c in whole
               for k, t in c.items() if k != "index")
    assert cut * P == full                  # every slot leaf is cut
    for res in _results():
        assert res[arch]["cache_bytes"] == want


@pytest.mark.parametrize("arch", ARCHS)
def test_direct_loop_launches_and_collectives(arch):
    cfg = _cfg(arch)
    want = manifest.run_collectives(cfg, STEPS, 1, tp=P, kv_len=CAP)
    launches = dict.fromkeys(ranks.SPY_NAMES + ranks.SPY_ATTN, 0)
    for spec in cfg.layer_specs():
        for phase, n in (("decode", STEPS), ("prefill", 1)):
            if spec[0] == "mla":
                continue            # no plan launch (and no kernel walk)
            for name, k in manifest.layer_launches(
                    cfg, spec, phase, sharded=True, tp=P,
                    kv_len=CAP).items():
                launches[name] += k * n
    for res in _results():
        got = res[arch]
        assert got["collectives"] == dict(dict.fromkeys(
            ("max", "sum", "gather", "bcast"), 0), **want)
        if arch == "gemma-2b":
            assert got["launches"] == launches
            assert got["launches"]["decode_attention"] == 0
            assert got["launches"]["decode_attention_partial"] == \
                cfg.n_layers * STEPS


# ---------------------------------------------------------------------------
# (f) one rule, recorded with each cache
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_each_cache_records_its_own_cut(arch):
    """Rank 1's caches of CAP slots (cut by sequence) and of CAP - 1
    (p does not divide it: whole) on one model: each records its own
    cut on its slot leaf, a slot view reads the same, and the manifest
    counts by the rule ``init_cache`` allocates by."""
    cfg = _cfg(arch)
    model = port_model(QuantPlan.full(), arch)
    model.tp_rank, model.tp_size = 1, P
    cut = model.init_cache(2, CAP, kv_dtype="int8")
    whole = model.init_cache(2, CAP - 1, kv_dtype="int8")
    leaf = "k" if arch == "gemma-2b" else "c_kv"
    for c, w, (mixer, _) in zip(cut, whole, cfg.layer_specs()):
        assert c[leaf].shape[1] == seq_cut_slots(cfg, mixer, P, CAP) \
            == CAP // P
        assert slot_range(c[leaf]) == slot_range(c[leaf][1:2]) == (
            CAP // P, CAP)
        assert w[leaf].shape[1] == CAP - 1 and slot_range(w[leaf]) is None
        assert seq_cut_slots(cfg, mixer, P, CAP - 1) is None
        assert manifest.seq_cut(cfg, mixer, P, CAP)
        assert not manifest.seq_cut(cfg, mixer, P, CAP - 1)
        assert not manifest.seq_cut(cfg, mixer, P, CAP, paged=True)


def test_seq_cut_reads_the_cache_or_the_walk():
    k = torch.zeros(2, CAP, 1, 4, dtype=torch.int8)
    assert qtp.seq_cut("k", k) is None
    with ops.walk_as_ranks(P):
        assert qtp.seq_cut("k", k) == qtp.SeqCut(None, P, 0, CAP)
        assert qtp.seq_cut("c_kv", torch.zeros(2, CAP, 8)) == \
            qtp.SeqCut(None, P, 0, CAP)
        # 2 KV heads take the model axis; P does not divide CAP - 1
        assert qtp.seq_cut("k", torch.zeros(2, CAP, 2, 4)) is None
        assert qtp.seq_cut("k", torch.zeros(2, CAP - 1, 1, 4)) is None
    half = torch.zeros(2, CAP // P, 1, 4, dtype=torch.int8)
    record_slot_range(half, CAP // P, CAP)
    with pytest.raises(RuntimeError, match="tensor-parallel group"):
        qtp.seq_cut("k", half[0:1])          # no group of 2 current
