"""Tensor parallelism for every LM family and DiT, degraded mode and
fault hooks under TP, and each rank drawing only its shards, on the CPU
(gloo process groups of 2 and 4 ranks; the ranks run
``tests/torch_tp_ranks.py`` and import no JAX).

Each family's smoke config (weights from the reference's ``Model.init``
through ``convert``) is sharded over the ranks and held against the
port's unsharded model, which the family's own tests hold against JAX:

(a) ``shard_model`` accepts every registered LM config at 2 ranks (no
    mixer, ``qk_norm``, layernorm or frontend is refused), and each
    rank holds 1/p of every sharded leaf on its sharded axis.
(b) The ring engine (and the paged one for the attention-only families)
    at 2 ranks: tokens bitwise the unsharded engine's on the same
    requests, every request OK, the caches 1/p (KV heads, SSM heads,
    mLSTM and sLSTM heads; where the KV heads cannot be cut, paligemma's
    one head and MLA's latent, the ring's slots by sequence, the paged
    pools whole), launches per layer and forward the manifest's, and
    the collectives per forward pinned (``manifest.run_collectives``: an
    attention block 2 MAX + 2 SUM, a bf16 mixer one gather, the experts
    one gather, a ring cut by sequence one gather a prefill and two or
    three a decode step, the vocabulary's SUM and gather); prefill and
    decode logits bitwise the unsharded model's (on the CPU the bf16
    mixers' column slices are bitwise too, and MLA's merged softmax at
    these sizes; ``PERF.md`` states the card's tolerance).  musicgen is driven with frame embeddings
    through ``prefill_padded`` and ``decode_step``; deepseek-v3 also
    through a cacheless forward of 2100 tokens.  At 4 ranks the bf16
    families and gemma3-4b (one KV head a rank) again.
(c) DiT at 2 and 4 ranks: ``DiffusionEngine(tp=)`` latents bitwise a
    direct unsharded ``sample()`` on the same noise, and a direct
    ``sample()`` under the group too; 6 plan launches a block and 2 MAX
    + 2 SUM per block and evaluation.
(d) Degraded mode: NaN and inf planted in a column-parallel leaf's shard
    (rank 1's QKV columns; rank 1's MLP up columns, whose NaN reaches the
    row-parallel down through the global row scale) and in a
    row-parallel leaf (the out-projection's scale, whole on every rank,
    as in the one unsharded copy): every rank takes the fallbacks, and
    tokens are bitwise the unsharded degraded engine's on the same
    faults; a healthy degraded run is bitwise the mode-off one, with the
    degraded collectives pinned.
(e) A chaos soak with ``fault_hook`` at 2 ranks: statuses, tokens and
    the report equal the unsharded soak's, and every int8 weight is
    restored bitwise.
(f) ``Model.init(tp=)`` / ``DiTModel.init(tp=)``: every tensor bitwise
    the whole draw's, quantized and cut.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import torch_tp_ranks as ranks
from repro_torch.analysis import manifest
from repro_torch.configs import get_config, get_dit_config, reduced_config
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.diffusion import DiffusionEngine, ImageRequest, sample
from repro_torch.models import Model
from repro_torch.parallel.context import TPGroup, spawn
from repro_torch.parallel.sharding import shard_model
from repro_torch.quant import QuantPlan
from repro_torch.reliability import chaos_soak
from repro_torch.serving import (PagedServingEngine, Request, RequestStatus,
                                 ServingEngine)
from torch_parity import port_dit, port_model, rng

ATTENTION = ("gemma3-4b", "command-r-plus-104b", "paligemma-3b")
BF16 = ("zamba2-1.2b", "deepseek-v3-671b", "xlstm-350m")
AT_FOUR = ("gemma3-4b",) + BF16
PROMPT_LENS = (3, 17, 9, 30)
MAX_NEW = 6
RING_KW = dict(n_slots=3, max_len=64, prefill_bucket=16)
PAGED_KW = dict(n_slots=3, max_len=64, prefill_bucket=16, block_size=8,
                prefill_chunk=8)
ENGINES = (("ring", ServingEngine, RING_KW),
           ("paged", PagedServingEngine, PAGED_KW))
DIT = dict(batch=2, steps=3, cfg=2.0, labels=(1, 5, 3))
DEGRADED_ARCH = "gemma3-4b"
# (leaf, whole-leaf scale index, the q axis of each scale axis, value):
# rank 1's QKV columns (layer 1: q head 3 of 4, v head 3 of 4), rank 1's
# MLP up column 100 of 128 (layer 2), the out-projection's scale (whole)
FAULTS = (("layers.1.attn.qkv", (3, 5), (1, 2), float("nan")),
          ("layers.1.attn.qkv", (11, 2), (1, 2), float("inf")),
          ("layers.2.mlp.up", (100,), (1,), float("nan")),
          ("layers.3.attn.o", (7,), (2,), float("inf")))
SOAK = dict(ber=1e-2, seed=42, period=3, logit_nan_rate=0.2, max_iters=200)
GENERATE_ARGV = ["--arch", "dit-test", "--device", "cpu", "--int8",
                 "--images", "2", "--batch", "2", "--steps", "1"]


def _prompts(vocab: int) -> list:
    r = rng(40)
    return [r.integers(0, vocab, n).astype(np.int32) for n in PROMPT_LENS]


def _cfg(arch: str):
    return reduced_config(get_config(arch))


def _logits_input(cfg) -> dict:
    r = rng(41)
    if cfg.frontend == "audio":
        f = torch.as_tensor(r.standard_normal((2, 9, cfg.d_model)),
                            dtype=torch.float32)
        steps = [torch.as_tensor(r.standard_normal((2, 1, cfg.d_model)),
                                 dtype=torch.float32) for _ in range(2)]
        return dict(frames=f, lengths=torch.tensor([9, 6], dtype=torch.int32),
                    steps=steps)
    return dict(tokens=torch.as_tensor(r.integers(0, cfg.vocab, (3, 16))),
                lengths=torch.tensor([16, 11, 4], dtype=torch.int32))


def _family_case(arch: str, engines) -> tuple:
    cfg = _cfg(arch)
    case = dict(model=port_model(QuantPlan.full(), arch),
                logits=_logits_input(cfg))
    if cfg.frontend != "audio":
        case.update(engines=engines, prompts=_prompts(cfg.vocab),
                    max_new=MAX_NEW)
    return ("family", case)


def _dit_case() -> tuple:
    cfg = get_dit_config("dit-test")
    r = rng(42)
    noise = torch.as_tensor(r.standard_normal(
        (2, cfg.in_channels, cfg.input_size, cfg.input_size)),
        dtype=torch.float32)
    return ("dit", dict(DIT, model=port_dit(True), noise=noise,
                        direct_labels=torch.tensor([4, 7])))


def _degraded_case(faults) -> tuple:
    cfg = _cfg(DEGRADED_ARCH)
    return ("degraded", dict(model=port_model(QuantPlan.full(),
                                              DEGRADED_ARCH),
                             faults=faults, kw=RING_KW,
                             prompts=_prompts(cfg.vocab), max_new=MAX_NEW))


def _chaos_case() -> tuple:
    cfg = _cfg("gemma-2b")
    return ("chaos", dict(model=port_model(QuantPlan.full()), kw=RING_KW,
                          prompts=_prompts(cfg.vocab), max_new=MAX_NEW,
                          soak=SOAK))


LONG_S = 2100            # a cacheless forward above 2048 tokens (MLA)


def _long_input(cfg) -> torch.Tensor:
    return torch.as_tensor(rng(43).integers(0, cfg.vocab, (1, LONG_S)))


def _cases(p: int) -> dict:
    if p == 4:
        cases = {arch: _family_case(arch, ENGINES[:1]) for arch in AT_FOUR}
        cases["dit"] = _dit_case()
        return cases
    cases = {arch: _family_case(arch, ENGINES) for arch in ATTENTION}
    cases.update({arch: _family_case(arch, ENGINES[:1]) for arch in BF16})
    cases["deepseek-v3-671b"][1]["long"] = _long_input(
        _cfg("deepseek-v3-671b"))
    cases["musicgen-medium"] = _family_case("musicgen-medium", ())
    cases["dit"] = _dit_case()
    cases["degraded"] = _degraded_case(FAULTS)
    cases["healthy"] = _degraded_case(())
    cases["chaos"] = _chaos_case()
    cases["cli"] = ("cli", dict(argv=GENERATE_ARGV + ["--tp", "2"]))
    cases["draws"] = ("draws", dict(configs=[
        _cfg(a) for a in ATTENTION + BF16 + ("musicgen-medium",
                                             "qwen2-moe-a2.7b")]
        + [get_dit_config("dit-test")]))
    return cases


_RESULTS: dict = {}


def _results(p: int) -> list:
    """Every case's rank results at group size ``p``: one spawn a size."""
    if p not in _RESULTS:
        _RESULTS[p] = spawn(ranks.run_cases, p, args=(_cases(p),))
    return _RESULTS[p]


_UNSHARDED: dict = {}


def _unsharded(key, fn):
    """The unsharded port's result of ``fn()``, once, on one thread (as
    the ranks run)."""
    if key not in _UNSHARDED:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            _UNSHARDED[key] = fn()
        finally:
            torch.set_num_threads(threads)
    return _UNSHARDED[key]


def _served(arch, engine):
    cfg = _cfg(arch)
    _, cls, kw = next(e for e in ENGINES if e[0] == engine)

    def run():
        eng = cls(port_model(None, arch), quant_plan=QuantPlan.full(), **kw)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=MAX_NEW)
                for i, p in enumerate(_prompts(cfg.vocab))]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        assert all(r.status is RequestStatus.OK for r in reqs)
        return [r.generated for r in reqs], eng.stats
    return _unsharded(("served", arch, engine), run)


# ---------------------------------------------------------------------------
# (a) every config shards, each leaf 1/p
# ---------------------------------------------------------------------------
def _check_one_pth(cfg, full: dict, got: dict, p: int) -> None:
    """Each rank's leaves against the whole model's: the leaves tensor
    parallelism cuts hold 1/p on their sharded axis (the fused QKV its q
    heads and its KV heads when KH divides; Mamba-2's in_proj and conv
    the SSM heads' channels, B and C whole), the rest whole."""
    H, KH = cfg.n_heads, cfg.n_kv_heads
    for key, leaves in full.items():
        mixer, mod = key.split("/")
        for name, shape in leaves.items():
            mine = got[key][name]
            if name == "kv_heads":
                assert mine == (KH // p if KH % p == 0 else KH), key
                continue
            quantized = isinstance(shape[0], tuple)
            if quantized:
                (q, s, _), (mq, ms, ways) = shape, mine
            else:
                q, s, mq, ms = shape, shape, mine, mine
            cut = _cut_axes(cfg, mixer, mod, name, q, p)
            if cut is None:
                assert (mq, ms) == (q, s), (key, name)
                continue
            assert not quantized or ways == p, (key, name)
            axis, n = cut
            want = q[:axis] + (n,) + q[axis + 1:]
            assert mq == want, (key, name, mq, want)


def _cut_axes(cfg, mixer, mod, name, q, p):
    """(axis, rank's size) of a leaf's q (or parameter) that TP cuts, or
    None when it stays whole."""
    if mod == "attn":
        KH = cfg.n_kv_heads
        KHr = KH // p if KH % p == 0 else KH
        return {"qkv": (1, cfg.n_heads // p + 2 * KHr),
                "o": (0, cfg.n_heads // p)}.get(name)
    if mod in ("mlp", "shared"):
        return {"up": (1, q[1] // p), "gate": (1, q[1] // p),
                "down": (0, q[0] // p)}.get(name)
    if mod == "moe":
        return (0, q[0] // p) if name in ("up", "gate", "down") else None
    if mod == "mamba":
        s = cfg.ssm
        di, H = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model)
        GN = 2 * s.n_groups * s.state_dim
        return {"in_proj": (1, (2 * di + H) // p + GN),
                "conv_w": (1, di // p + GN), "conv_b": (0, di // p + GN),
                "a_log": (0, H // p), "d_skip": (0, H // p),
                "dt_bias": (0, H // p)}.get(name)
    if mod == "mla":
        return (1, q[1] // p) if name in ("q_up", "kv_up") else None
    if mod == "mlstm":
        return (1, q[1] // p) if name in ("q", "k", "v") else None
    if mod == "slstm":
        return {"r": (1, q[1] // p), "b": (1, q[1] // p)}.get(name)
    return None


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shard_model_accepts_every_config(arch):
    """No mixer, ``qk_norm``, layernorm or frontend is refused at 2
    ranks, and each rank holds 1/p of every leaf TP cuts."""
    cfg = _cfg(arch)
    whole = Model(cfg).init(0, device="cpu").quantize(QuantPlan.full())
    full = ranks.tp_shapes(whole)
    for r in range(2):
        model = Model(cfg).init(0, device="cpu").quantize(QuantPlan.full())
        shard_model(model, TPGroup(r, 2, "gloo"))
        _check_one_pth(cfg, full, ranks.tp_shapes(model), 2)


# ---------------------------------------------------------------------------
# (b) the families' engines and logits
# ---------------------------------------------------------------------------
def _launches(cfg, stats, engine, p):
    fwd = stats.decode_steps + (stats.prefill_chunks if engine == "paged"
                                else stats.prefills)
    want = dict.fromkeys(ranks.SPY_NAMES + ranks.SPY_ATTN + ranks.SPY_SCAN,
                         0)
    kw = dict(sharded=True, tp=p, kv_len=RING_KW["max_len"],
              paged=engine == "paged", block_size=PAGED_KW["block_size"])
    for spec in cfg.layer_specs():
        for phase, n in (("decode", stats.decode_steps),
                         ("prefill", fwd - stats.decode_steps)):
            for name, k in manifest.layer_launches(cfg, spec, phase,
                                                   **kw).items():
                want[name] += k * n
    return want, fwd


FAMILY_RUNS = ([(a, e[0], 2) for a in ATTENTION for e in ENGINES]
               + [(a, "ring", 2) for a in BF16]
               + [(a, "ring", 4) for a in AT_FOUR])


@pytest.mark.parametrize("arch,engine,p", FAMILY_RUNS)
def test_family_engine_bitwise(arch, engine, p):
    """Tokens bitwise the unsharded engine's, every request OK; launches
    by counter the manifest's per layer; collectives the manifest's per
    forward; the caches hold the rank's heads."""
    cfg = _cfg(arch)
    want, stats = _served(arch, engine)
    launches, fwd = _launches(cfg, stats, engine, p)
    paged = engine == "paged"
    coll = manifest.run_collectives(
        cfg, stats.decode_steps, fwd - stats.decode_steps, tp=p,
        kv_len=RING_KW["max_len"], paged=paged)
    for res in _results(p):
        got = res[arch][engine]
        assert got["status"] == ["ok"] * len(PROMPT_LENS)
        assert got["tokens"] == want
        assert got["decode_steps"] == stats.decode_steps
        assert got["launches"] == launches
        assert got["collectives"] == dict(dict.fromkeys(
            ("max", "sum", "gather", "bcast"), 0), **coll)
        for c, spec in zip(got["cache_shapes"], cfg.layer_specs()):
            _check_cache(cfg, spec[0], c, p, paged)


def _check_cache(cfg, mixer, shapes, p, paged):
    """A rank's cache of a ``mixer`` layer: its heads, and its slots
    where the ring is cut by sequence (``manifest.seq_cut``)."""
    cap = RING_KW["max_len"]
    if manifest.seq_cut(cfg, mixer, p, cap, paged):
        key = "c_kv" if mixer == "mla" else "k"
        assert shapes[key][1] == cap // p, shapes
    if mixer in ("attn", "attn_local"):
        KH = cfg.n_kv_heads
        heads = KH // p if KH % p == 0 else KH
        key = "k" if "k" in shapes else "k_pages"
        assert shapes[key][2] == heads, shapes
    elif mixer == "mamba2":
        s = cfg.ssm
        di, H = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model)
        assert shapes["ssm"][1] == H // p
        assert shapes["conv"][2] == di // p + 2 * s.n_groups * s.state_dim
    elif mixer == "mlstm":
        assert shapes["C"][1] == shapes["n"][1] == shapes["m"][1] == \
            cfg.xlstm.n_heads // p
        assert shapes["conv"][2] == cfg.xlstm.mlstm_inner(cfg.d_model)
    elif mixer == "slstm":
        assert all(shapes[k][1] == cfg.xlstm.n_heads // p
                   for k in ("c", "n", "h", "m"))
    else:                                        # MLA: the latent whole
        assert shapes["c_kv"][2] == cfg.mla.kv_lora_rank


LOGIT_RUNS = ([(a, 2) for a in ATTENTION + BF16 + ("musicgen-medium",)]
              + [(a, 4) for a in AT_FOUR])


@pytest.mark.parametrize("arch,p", LOGIT_RUNS)
def test_family_logits_bitwise(arch, p):
    """One prefill and two decode steps: the logits on every rank bitwise
    the unsharded model's (musicgen fed frame embeddings), and the
    forwards' collectives the manifest's."""
    cfg = _cfg(arch)
    case = _family_case(arch, ())[1]
    want = _unsharded(("logits", arch), lambda: ranks._logits(
        port_model(QuantPlan.full(), arch), None, case))
    # one prefill and two decode steps over a ring of 32 slots (64 for
    # frames: ranks._logits)
    coll = manifest.run_collectives(
        cfg, 2, 1, tp=p, kv_len=64 if cfg.frontend == "audio" else 32)
    for res in _results(p):
        np.testing.assert_array_equal(res[arch]["logits"], want)
        assert res[arch]["logits.collectives"] == dict(
            dict.fromkeys(("max", "sum", "gather", "bcast"), 0), **coll)


def test_mla_long_forward_bitwise():
    """deepseek-v3-smoke's cacheless forward of 2100 tokens (MLA above the
    dense threshold: blockwise on the CPU, kernel 12 on the card) at 2
    ranks: the last row's logits bitwise the unsharded model's."""
    arch = "deepseek-v3-671b"
    toks = _long_input(_cfg(arch))

    def run():
        with torch.no_grad():
            return port_model(QuantPlan.full(), arch)(
                toks, last_index=torch.tensor([LONG_S - 1])).numpy()
    want = _unsharded(("long", arch), run)
    for res in _results(2):
        np.testing.assert_array_equal(res[arch]["long"], want)


@pytest.mark.parametrize("arch", ATTENTION + BF16 + ("musicgen-medium",))
def test_family_shards_hold_one_pth(arch):
    cfg = _cfg(arch)
    full = ranks.tp_shapes(port_model(QuantPlan.full(), arch))
    for res in _results(2):
        _check_one_pth(cfg, full, res[arch]["shapes"], 2)


# ---------------------------------------------------------------------------
# (c) DiT
# ---------------------------------------------------------------------------
def _dit_want():
    def run():
        model = port_dit(True)
        eng = DiffusionEngine(model, batch_size=DIT["batch"],
                              quant_plan=QuantPlan.full())
        reqs = [ImageRequest(uid=i, label=lab, num_steps=DIT["steps"],
                             cfg_scale=DIT["cfg"])
                for i, lab in enumerate(DIT["labels"])]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        case = _dit_case()[1]
        with torch.no_grad():
            direct = sample(model, case["direct_labels"],
                            x_init=case["noise"], num_steps=DIT["steps"],
                            cfg_scale=DIT["cfg"])
        return [r.latents for r in reqs], direct.numpy(), eng.stats
    return _unsharded("dit", run)


@pytest.mark.parametrize("p", [2, 4])
def test_dit_latents_bitwise(p):
    """``DiffusionEngine(tp=)``'s latents and a direct ``sample()`` under
    the group bitwise the unsharded ones; per block and evaluation 6
    plan launches (adaLN whole, QKV, the out-projection's int32 partial,
    the MLP's three) and 2 MAX + 2 SUM."""
    latents, direct, stats = _dit_want()
    cfg = get_dit_config("dit-test")
    evals = stats.denoise_steps           # guidance stacks into one batch
    for res in _results(p):
        got = res["dit"]
        assert got["status"] == ["ok"] * len(DIT["labels"])
        for a, b in zip(got["latents"], latents):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got["sample"], direct)
        want = dict.fromkeys(ranks.SPY_NAMES + ranks.SPY_ATTN
                             + ranks.SPY_SCAN, 0)
        want.update({k: v * evals for k, v in
                     manifest.dit_step_launches(cfg, sharded=True).items()})
        assert got["launches"] == want
        assert got["collectives"] == dict(
            bcast=0, gather=0, **{k: v * evals for k, v in
                                  manifest.dit_step_collectives(cfg).items()})
        attn = got["shapes"]["attn/attn"]
        assert attn["qkv"][0][1] == 3 * cfg.n_heads // p
        assert attn["o"][0][0] == cfg.n_heads // p
        assert got["shapes"]["attn/mlp"]["up"][0][1] == cfg.d_ff // p


# ---------------------------------------------------------------------------
# (d) degraded mode, (e) the chaos soak under TP
# ---------------------------------------------------------------------------
def _degraded_want(faults):
    cfg = _cfg(DEGRADED_ARCH)

    def run():
        model = port_model(QuantPlan.full(), DEGRADED_ARCH)
        for path, idx, axes, value in faults:
            assert ranks.poison(ranks._leaf(model, path), idx, axes, value)
        eng = ServingEngine(model, quant_plan=QuantPlan.full(),
                            degraded=True, **RING_KW)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=MAX_NEW)
                for i, p in enumerate(_prompts(cfg.vocab))]
        for r in reqs:
            eng.submit(r)
        with ranks.fallbacks() as seen:
            eng.run_until_done()
        return ([r.generated for r in reqs], [r.status.value for r in reqs],
                dict(seen), eng.stats)
    return _unsharded(("degraded", faults), run)


def test_degraded_tp_takes_every_fallback_bitwise():
    """The planted faults: each rank holds the NaN or inf it should (rank
    1 the column shards' faults, every rank the whole scale's); every
    rank takes the same fallbacks (the QKV column site on the max-
    reduced flag, the row-parallel sites on their whole output), and the
    tokens are bitwise the unsharded degraded engine's on the same
    faults, every request OK."""
    tokens, status, seen, _ = _degraded_want(FAULTS)
    assert status == ["ok"] * len(PROMPT_LENS) and seen["gated"] > 0
    res = _results(2)
    assert [r["degraded"]["held"] for r in res] == [
        [False, False, False, True], [True, True, True, True]]
    for r in res:
        got = r["degraded"]
        assert got["status"] == status and got["tokens"] == tokens
        assert got["fallbacks"]["gated"] > 0 and got["fallbacks"]["row"] > 0
    assert res[0]["degraded"]["fallbacks"] == res[1]["degraded"]["fallbacks"]


def test_degraded_tp_healthy_is_bitwise_and_pinned():
    """A healthy degraded run at 2 ranks: the mode-off tokens, no
    fallback written, and per layer and forward the degraded collectives
    (the QKV flag's MAX, the two row-parallel fallbacks' MAX + SUM)."""
    cfg = _cfg(DEGRADED_ARCH)
    tokens, _, _, stats = _degraded_want(())
    assert tokens == _served(DEGRADED_ARCH, "ring")[0]
    fwd = stats.decode_steps + stats.prefills
    want = manifest.run_collectives(cfg, stats.decode_steps, stats.prefills,
                                    degraded=True, kv_len=RING_KW["max_len"])
    assert want["max"] == 5 * cfg.n_layers * fwd
    for r in _results(2):
        got = r["healthy"]
        assert got["tokens"] == tokens
        assert got["fallbacks"] == {"gated": 0, "row": 0}
        assert got["collectives"] == dict(dict(gather=0, bcast=0), **want)


def test_chaos_soak_under_tp_equals_unsharded_and_restores():
    """``chaos_soak`` with the monkey's ``fault_hook`` at 2 ranks: the
    campaigns land on the ranks that hold each faulted weight, so the
    statuses, tokens and report equal the unsharded soak's; every int8
    weight is bitwise its snapshot afterwards."""
    cfg = _cfg("gemma-2b")

    def run():
        eng = ServingEngine(port_model(QuantPlan.full()),
                            quant_plan=QuantPlan.full(), degraded=True,
                            **RING_KW)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=MAX_NEW,
                        temperature=0.7, top_k=5, seed=11)
                for i, p in enumerate(_prompts(cfg.vocab))]
        res = chaos_soak(eng, reqs, **SOAK)
        return ([r.status.value for r in reqs], [r.generated for r in reqs],
                dataclasses.asdict(res.chaos))
    status, tokens, report = _unsharded("chaos", run)
    assert report["bits_faulted"] > 0 and report["weight_injections"] > 0
    for r in _results(2):
        got = r["chaos"]
        assert got["violations"] == [] and got["restored"]
        assert got["sharded"] > 0
        assert (got["status"], got["tokens"], got["report"]) == (
            status, tokens, report)


# ---------------------------------------------------------------------------
# (f) each rank draws only its shards
# ---------------------------------------------------------------------------
def test_draw_sharded_is_the_whole_draw_cut():
    for r in _results(2):
        assert r["draws"] and all(v == [] for v in r["draws"].values()), \
            r["draws"]


def test_generate_cli_tp_on_cpu():
    """The DiT CLI's rank at 2 ranks (``launch.generate --tp 2`` runs it
    in each spawned rank): it draws its shards and delivers latents
    bitwise the unsharded CLI's; ``--tp`` without ``--int8`` is
    refused."""
    from repro_torch.launch import generate
    one = generate.main(GENERATE_ARGV)
    for r in _results(2):
        got = r["cli"]
        assert [s for s, _ in got["results"]] == ["ok"] * len(one)
        for a, (_, b) in zip(one, got["results"]):
            np.testing.assert_array_equal(a.latents, b)
    with pytest.raises(SystemExit):
        generate.main(["--tp", "2", "--device", "cpu"])
