"""Vocabulary parallelism at serving (ROADMAP A.3, ``vocab``): the
embedding's rows and the untied head's columns cut over 2 gloo ranks on
the CPU (the ranks run ``tests/torch_tp_ranks.py`` and import no JAX),
as the reference places them (``("vocab", "fsdp")`` and ``("fsdp",
"vocab")`` under ``resolve_spec``).

(a) The lookup on a rank (ids outside its rows read zero, one int32 SUM
    of the rows' bits) is bitwise the whole table's, bf16 and f32, a
    -0.0 row included; the tied and untied logits (the rank's columns,
    one gather) are bitwise the whole product's on the CPU.
(b) A tied (command-r-plus-104b-smoke) and an untied
    (deepseek-67b-smoke) model at 2 ranks: prefill and decode logits
    bitwise the unsharded model's, one SUM (the lookup) and one gather
    (the logits) a forward beside the layers' collectives, and each
    rank's embedding and head bytes exactly ``shard_nbytes`` of the
    whole leaf under ``resolve_spec`` on ``{"data": 1, "model": 2}``.
(c) ``Model.init(tp=)`` draws only the rank's rows, bitwise the whole
    draw's; DiT's label tables (1001 and 17 rows) stay whole.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_tp_ranks as ranks
from repro_torch.analysis import manifest
from repro_torch.configs import get_config, get_dit_config, reduced_config
from repro_torch.models import Model, layers
from repro_torch.models.dit import DiTModel
from repro_torch.parallel.context import TPGroup, spawn
from repro_torch.parallel.sharding import (resolve_spec, shard_nbytes,
                                           vocab_cuts)
from repro_torch.quant import QuantPlan
from torch_parity import port_model, rng

P = 2
MODELS = ("command-r-plus-104b", "deepseek-67b")
DTYPES = (torch.bfloat16, torch.float32)
GRID = {"data": 1, "model": P}


def _table(dtype):
    r = rng(60)
    emb = torch.as_tensor(r.standard_normal((256, 16)),
                          dtype=torch.float32).to(dtype)
    emb[200] = -0.0                     # a row of negative zeros
    tokens = torch.as_tensor(r.integers(0, 256, (3, 10)))
    tokens[0, :3] = torch.tensor([200, 0, 255])
    x = torch.as_tensor(r.standard_normal((3, 10, 16)),
                        dtype=torch.float32).to(dtype)
    return emb, tokens, x


def _logits_input(cfg):
    r = rng(61)
    return (torch.as_tensor(r.integers(0, cfg.vocab, (3, 16))),
            torch.tensor([16, 11, 4], dtype=torch.int32))


def _cfg(arch):
    return reduced_config(get_config(arch))


_RESULTS: dict = {}


def _results() -> list:
    if not _RESULTS:
        case = dict(tables=[_table(d) for d in DTYPES],
                    models={a: port_model(QuantPlan.full(), a)
                            for a in MODELS},
                    logits=_logits_input(_cfg(MODELS[0])),
                    draws=[_cfg(a) for a in MODELS])
        _RESULTS["ranks"] = spawn(ranks.run_cases, P,
                                  args=({"vocab": ("vocab", case)},))
    return [r["vocab"] for r in _RESULTS["ranks"]]


def _bits(a: np.ndarray) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_lookup_and_logits_bitwise(dtype):
    emb, tokens, x = _table(dtype)
    want = dict(lookup=ranks.np_of(emb[tokens]),
                tied=ranks.np_of(layers.embedding_attend(emb, x)),
                untied=ranks.np_of(layers.lm_head_apply(emb.t().contiguous(),
                                                        x)))
    for res in _results():
        got = res["tables"][DTYPES.index(dtype)]
        for key, w in want.items():
            np.testing.assert_array_equal(_bits(got[key]), _bits(w),
                                          err_msg=key)
        assert got["counts"] == dict(max=0, sum=1, gather=2, bcast=0)


@pytest.mark.parametrize("arch", MODELS)
def test_model_logits_bitwise_and_collectives(arch):
    cfg = _cfg(arch)
    toks, lengths = _logits_input(cfg)
    want = ranks.direct_loop(port_model(QuantPlan.full(), arch), None, toks,
                             lengths, 32, 1)["logits"]
    coll = manifest.run_collectives(cfg, 1, 1, tp=P, kv_len=32)
    for res in _results():
        np.testing.assert_array_equal(res[arch]["logits"], want)
        assert res[arch]["collectives"] == dict(dict.fromkeys(
            ("max", "sum", "gather", "bcast"), 0), **coll)
    vocab = manifest.vocab_collectives(cfg, P)
    assert vocab == {"sum": 1, "gather": 1}


@pytest.mark.parametrize("arch", MODELS)
def test_embedding_and_head_bytes_are_the_shards(arch):
    model = port_model(QuantPlan.full(), arch)
    want = {}
    for name, axes in (("embed", ("vocab", "fsdp")),
                       ("head", ("fsdp", "vocab"))):
        if hasattr(model, name):
            t = model.get_parameter(name)
            spec = resolve_spec(tuple(t.shape), axes, GRID)
            assert "model" in spec
            want[name] = shard_nbytes(t, spec, GRID)
    assert ("head" in want) == (not _cfg(arch).tie_embeddings)
    for res in _results():
        assert res[arch]["bytes"] == want


@pytest.mark.parametrize("arch", MODELS)
def test_draw_holds_only_the_ranks_rows(arch):
    cfg = _cfg(arch)
    whole = Model(cfg).init(0, device="cpu")
    V = cfg.vocab
    for k, res in enumerate(_results()):
        got = res["draw/" + cfg.name]
        rows = slice(k * V // P, (k + 1) * V // P)
        np.testing.assert_array_equal(got["embed"],
                                      ranks.np_of(whole.embed[rows]))
        if "head" in got:
            np.testing.assert_array_equal(got["head"],
                                          ranks.np_of(whole.head[:, rows]))


@pytest.mark.parametrize("arch", ["dit-xl-2", "dit-test"])
def test_dit_label_table_stays_whole(arch):
    cfg = get_dit_config(arch)
    model = DiTModel(cfg)                           # on the meta device
    for p in (2, 4):
        assert vocab_cuts(model, TPGroup(0, p, "gloo")) is None
        assert manifest.dit_step_collectives(cfg, tp=p) == \
            manifest.dit_step_collectives(cfg, tp=1)
