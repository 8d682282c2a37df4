"""GPipe stages, the data-parallel train step and the step builders of
the port, on the CPU.

The pipeline runs on gloo ranks (``parallel.context.spawn``: one spawn
of 2 ranks and one of 4 run every rank case, in
``tests/torch_pp_ranks.py``) and is held bitwise against its stages run
in sequence on the same microbatches: the reference's own case
(``tanh(x @ w)``, ``tests/test_distribution.py`` ``TestPipelineParallel``)
and gemma-2b-smoke's decoder blocks, each rank drawing only its own
layers.  The DP-2 train step is held against the single-rank step on
the same rows: the loss within ``LOSS_REL`` relative, each f32 gradient
sum within ``GRAD_REL`` of its leaf's largest element (the all-reduce
adds the two ranks' sums where the single rank adds four microbatches
in turn), the two ranks' parameters bitwise equal after two steps, and
within ``PARAM_ULPS`` bf16 steps of the single rank's.
The prefill and decode bundles are held against the reference's
``Model.prefill_last`` and ``decode_step`` on the same weights here for
token, vision and audio inputs (``tests/test_torch_step_bundles.py``
holds the other caches, and says how).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import torch_pp_ranks as ranks
from test_torch_step_bundles import check_bundles

from repro_torch import optim
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch.steps import (build_step, build_train_step,
                                      optimizer_config)
from repro_torch.models import Model
from repro_torch.parallel.context import TPGroup, spawn
from repro_torch.parallel.pipeline import (block_stage_fn, draw_stage,
                                           gpipe_loop, pipeline_apply,
                                           stage_layers)
from repro_torch.quant import QuantPlan
from torch_parity import rng

LOSS_REL = 1e-6
GRAD_REL = 1e-6
PARAM_ULPS = 1
SEED = 3
MICRO = 4
# each block sees the same rows in the pipeline and in the sequence: 4
# microbatches of 2 rows of 16 tokens
BLOCK_X = rng(SEED).standard_normal((8, 16, 64)).astype(np.float32)
TANH_X = rng(SEED + 1).standard_normal((8, 16)).astype(np.float32)
TANH_W = (rng(SEED + 2).standard_normal((4, 16, 16)) * 0.3).astype(
    np.float32)
TRAIN_ROWS, TRAIN_SEQ = 4, 32


def _train_batches():
    r = rng(SEED + 3)
    return [{"inputs": r.integers(0, 256, (TRAIN_ROWS, TRAIN_SEQ)),
             "targets": r.integers(0, 256, (TRAIN_ROWS, TRAIN_SEQ))}
            for _ in range(2)]


def _cases(p: int) -> dict:
    cases = {"tanh": ("tanh", dict(ws=TANH_W[:p], x=TANH_X,
                                   microbatches=MICRO))}
    for full in (False, True):
        cases[f"blocks/{full}"] = ("blocks", dict(
            seed=SEED, full=full, x=BLOCK_X, microbatches=MICRO))
    if p == 2:
        cases["train"] = ("train", dict(seed=SEED,
                                        batches=_train_batches()))
    return cases


_RESULTS: dict = {}


def _results(p: int) -> list:
    """Every case's rank results at group size ``p``: one spawn a size."""
    if p not in _RESULTS:
        _RESULTS[p] = spawn(ranks.run_cases, p, args=(_cases(p),))
    return _RESULTS[p]


def _one_thread(fn):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(threads)


def _sequential(stage_fn, stages, x: torch.Tensor) -> torch.Tensor:
    """Each microbatch through every stage in turn."""
    outs = []
    for mx in x.reshape(MICRO, x.shape[0] // MICRO, *x.shape[1:]):
        for params in stages:
            mx = stage_fn(params, mx)
        outs.append(mx)
    return torch.cat(outs)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p", [2, 4])
def test_pipeline_reference_case_bitwise(p):
    want = _one_thread(lambda: ranks.bits(_sequential(
        lambda w, x: torch.tanh(x @ w), torch.from_numpy(TANH_W[:p]),
        torch.from_numpy(TANH_X))))
    for r in _results(p):
        np.testing.assert_array_equal(r["tanh"]["out"], want)


_SEQ_BLOCKS: dict = {}


def _sequential_blocks(full: bool) -> np.ndarray:
    """gemma-2b-smoke's whole draw from the seed (quantized under the
    full plan or not), every block in turn on each microbatch."""
    if full not in _SEQ_BLOCKS:
        cfg = ranks.smoke_cfg()

        def run():
            model = Model(cfg).init(SEED, device="cpu")
            if full:
                model.quantize(QuantPlan.full())
            x = torch.from_numpy(BLOCK_X).to(torch.bfloat16)
            return ranks.bits(_sequential(block_stage_fn(cfg),
                                          [model.layers], x))
        _SEQ_BLOCKS[full] = _one_thread(run)
    return _SEQ_BLOCKS[full]


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("p", [2, 4])
def test_pipeline_blocks_bitwise(p, full):
    """gemma-2b-smoke's 4 blocks over p stages (each rank drawing only
    its layers) give the bits of the 4 blocks in sequence, on every
    rank."""
    want = _sequential_blocks(full)
    res = _results(p)
    assert [r[f"blocks/{full}"]["layers"] for r in res] == \
        [len(stage_layers(4, s, p)) for s in range(p)]
    for r in res:
        np.testing.assert_array_equal(r[f"blocks/{full}"]["out"], want)


@pytest.mark.parametrize("p", [2, 4])
def test_pipeline_hops_counted(p):
    """Stage 0 sends each of the M microbatches, the last stage receives
    them, a middle stage does both; one broadcast replicates the
    outputs; nothing else is counted."""
    for rank, r in enumerate(_results(p)):
        got = r["tanh"]
        want_hops = MICRO * ((rank > 0) + (rank < p - 1))
        assert got["hops"] == want_hops
        assert got["counts"] == {"max": 0, "sum": 0, "gather": 0,
                                 "bcast": 1}


def test_pipeline_on_one_rank_is_the_stage():
    group = TPGroup()
    x = torch.from_numpy(TANH_X)
    w = torch.from_numpy(TANH_W[0])
    out = pipeline_apply(group, lambda w, x: torch.tanh(x @ w), w, x, 4)
    want = _sequential(lambda w, x: torch.tanh(x @ w), [w], x)
    assert torch.equal(out, want)
    assert group.hops == 0 and group.counts["bcast"] == 1
    with pytest.raises(ValueError):
        pipeline_apply(group, lambda w, x: x, w, x, 3)
    hops: list = []
    micro = x.reshape(4, 2, 16)
    assert torch.equal(gpipe_loop(lambda w, x: x + 1, None, micro, group,
                                  hop_s=hops), micro + 1)
    assert hops == []


def test_stage_layers_split_contiguously():
    for n, p in ((18, 2), (4, 4), (7, 3), (61, 4)):
        spans = [stage_layers(n, s, p) for s in range(p)]
        assert [i for sp in spans for i in sp] == list(range(n))
        assert max(map(len, spans)) - min(map(len, spans)) <= 1
    assert stage_layers(18, 1, 2) == range(9, 18)


@pytest.mark.parametrize("stage", [0, 1])
def test_draw_stage_gives_the_whole_draws_bits(stage):
    cfg = ranks.smoke_cfg()
    whole = Model(cfg).init(SEED, device="cpu")
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    blocks = draw_stage(Model(cfg), stage, 2, gen, "cpu")
    for block, want in zip(blocks, [whole.layers[i] for i in
                                    stage_layers(4, stage, 2)]):
        got, ref = dict(block.named_parameters()), \
            dict(want.named_parameters())
        assert list(got) == list(ref)
        for k in ref:
            assert torch.equal(got[k], ref[k]), k


# ---------------------------------------------------------------------------
# data parallelism
# ---------------------------------------------------------------------------
_SINGLE: dict = {}


def _single_rank() -> dict:
    if not _SINGLE:
        _SINGLE.update(_one_thread(lambda: ranks.train_steps(
            None, dict(seed=SEED, batches=_train_batches()), dp=False)))
    return _SINGLE


def test_dp_train_matches_single_rank():
    """Step 1's loss and every f32 gradient sum against the single-rank
    step on the same 4 rows (4 microbatches of 1 row; a rank: its 2 rows
    in 2 microbatches), then step 2's loss."""
    want = _single_rank()
    for r in _results(2):
        got = r["train"]
        for a, b in zip(got["losses"], want["losses"]):
            assert abs(a - b) <= LOSS_REL * abs(b), (a, b)
        assert list(got["grads"]) == list(want["grads"])
        for k, g in want["grads"].items():
            err = np.abs(got["grads"][k] - g).max()
            assert err <= GRAD_REL * np.abs(g).max(), (k, err)


def test_dp_ranks_hold_the_same_weights():
    a, b = (r["train"]["params"] for r in _results(2))
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in steps of their dtype between two arrays of bf16 bits
    (int16, as ``ranks.bits`` gives them) or of f32 values."""
    def ordered(x):
        if x.dtype == np.float32:
            x, top = x.view(np.int32), 2 ** 31
        else:
            top = 2 ** 15
        x = x.astype(np.int64)
        return np.where(x < 0, -top - x, x)
    return np.abs(ordered(a) - ordered(b))


def test_dp_weights_match_the_single_ranks():
    """ZeRO-1's update against the single-rank step's: after two steps
    each rank's bf16 parameters within ``PARAM_ULPS`` steps of the
    single rank's, in steps of each leaf's dtype (bf16 weights, f32
    norm scales): the update sees gradients that differ in f32's last
    bits, which may move a rounding by one step."""
    want = _single_rank()["params"]
    for r in _results(2):
        got = r["train"]["params"]
        assert list(got) == list(want)
        for k, w in want.items():
            assert got[k].dtype == w.dtype, k
            assert _ulps(got[k], w).max() <= PARAM_ULPS, k


def test_dp_moments_are_a_ranks_shard():
    """ZeRO-1: each rank's moments cover its fsdp shard of every leaf the
    data axis divides (half of its elements) and every other leaf (the
    norms' scales) whole."""
    want = _single_rank()["moment_shapes"]
    total = sum(int(np.prod(s)) for s in want.values())
    for r in _results(2):
        got = r["train"]["moment_shapes"]
        whole = [k for k in want if got[k] == want[k]]
        assert all(k.endswith("['scale']") or "_norm" in k for k in whole)
        for k in want:
            if k not in whole:
                assert int(np.prod(got[k])) * 2 == int(np.prod(want[k]))
        kept = sum(int(np.prod(want[k])) for k in whole)
        assert r["train"]["moments"] == (total - kept) // 2 + kept
        assert abs(r["train"]["moments"] - total / 2) <= kept


def test_dp_collectives_counted():
    """Two steps: a SUM of every f32 gradient sum and of the loss, a
    gather of every cut leaf."""
    want = _single_rank()
    cut = sum(want["moment_shapes"][k] != s for k, s in
              _results(2)[0]["train"]["moment_shapes"].items())
    n = len(want["grads"])
    for r in _results(2):
        assert r["train"]["counts"] == {"max": 0, "sum": 2 * (n + 1),
                                        "gather": 2 * cut, "bcast": 0}


def test_dp_refuses_a_batch_that_does_not_split():
    cfg = ranks.smoke_cfg()
    model = Model(cfg).init(SEED, device="cpu")
    step = build_train_step(cfg, model, dp=TPGroup(0, 2, "gloo"))
    state = optim.init(optimizer_config(cfg), step.shards)
    r = rng(0)
    with pytest.raises(ValueError, match="data-parallel"):
        step(state, {"inputs": r.integers(0, 256, (3, 8)),
                     "targets": r.integers(0, 256, (3, 8))})


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("arch", ["gemma-2b", "paligemma-3b",
                                  "musicgen-medium"])
def test_prefill_and_decode_bundles_match_reference(arch, full):
    check_bundles(arch, full)


def test_build_step_dispatches_by_the_cells_step():
    cfg = reduced_config(get_config("gemma-2b"))
    assert [build_step(cfg, None, s).kind for s in
            ("train_4k", "prefill_32k", "decode_32k", "long_500k",
             "decode_32k_spec4")] == ["train", "prefill", "decode",
                                      "decode", "decode"]
    spec4 = build_step(cfg, None, "decode_32k_spec4")
    assert tuple(spec4.args[1]["inputs"].shape) == (128, 4)


def test_train_bundle_runs_once_drawn():
    """The train bundle's step builds itself at its first call, on the
    drawn model, and equals ``build_train_step``'s."""
    cfg = dataclasses.replace(reduced_config(get_config("gemma-2b")),
                              train_microbatches=2)
    bundle = build_step(cfg, None, "train_4k")
    bundle.model.init(SEED, device="cpu")
    ocfg = optimizer_config(cfg)
    from repro_torch.convert import reference_paths
    state = optim.init(ocfg, reference_paths(bundle.model))
    batch = _train_batches()[0]
    got = bundle.fn(state, batch)
    other = Model(cfg).init(SEED, device="cpu")
    step = build_train_step(cfg, other, ocfg)
    want = step(optim.init(ocfg, step.params), batch)
    assert float(got["loss"]) == float(want["loss"])
    for k, p in reference_paths(bundle.model).items():
        assert torch.equal(p, step.params[k]), k
