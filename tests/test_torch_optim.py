"""The training substrate of the port against the JAX reference, on the
CPU: the data pipeline, AdamW, the int8 gradient compression, the
checkpointer, the straggler policy and the fault-tolerant trainer.

Tolerances:
* the pipeline's batches, the compression's codes and scales, the decay
  set and the straggler flags: exact;
* one AdamW update: each bf16 parameter within one bf16 ulp of the
  reference's (2**-8 of its magnitude: XLA's CPU compiler may fuse a
  multiply-add that torch rounds twice, and the f32 difference can move
  a bf16 rounding); the moments within 1e-5 of each leaf's largest
  magnitude (2**-8 for bf16 moments, one bf16 ulp): the global norm,
  hence the clip scale, lands within 1e-5 relative (f32 sums of 1.6e5
  squares taken in another order);
* ``cosine_schedule`` within 1e-7 relative (f32 cos);
* the trainer's crash-and-resume: bitwise an uninterrupted run.
"""
from __future__ import annotations

import re
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.data import DataConfig as JDataConfig
from repro.data import Pipeline as JPipeline
from repro.data import for_model as jfor_model
from repro.optim.adamw import _decay_mask
from repro.training import StragglerPolicy as JStraggler

from repro_torch import optim
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_jax, reference_paths
from repro_torch.data import DataConfig, Pipeline, for_model
from repro_torch.kernels import _build
from repro_torch.kernels import cim_gemm as cg
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models import Model
from repro_torch.models import attention as tattn
from repro_torch.training import (StragglerPolicy, Trainer, TrainerConfig,
                                  simple_train_step)
from torch_parity import (numpy_tree, port_model, rel_close, smoke,
                          to_np)


def ref_leaves(tree) -> dict:
    """The reference tree's leaves by ``keystr`` path."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in flat}


def ref_leaf(leaves: dict, key: str) -> np.ndarray:
    """The reference's value at a port key: a stacked leaf's layer when
    the key ends in ``[j]``."""
    m = re.fullmatch(r"(.*)\[(\d+)\]", key)
    if m and m.group(1) in leaves:
        return leaves[m.group(1)][int(m.group(2))]
    return leaves[key]


# ---------------------------------------------------------------------------
# data pipeline: bitwise
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["gemma-2b", "paligemma-3b",
                                  "musicgen-medium"])
def test_pipeline_batches_bitwise(arch):
    """Text, vision and audio batches: the same arrays, dtypes and keys
    as the reference's, at several steps; the stream moves with the
    step and is a pure function of it."""
    jcfg, _, _ = smoke(arch)
    cfg = reduced_config(get_config(arch))
    for seed, step in ((0, 0), (3, 7), (11, 123)):
        want = jfor_model(jcfg, batch=4, seq_len=16, seed=seed).batch_at(step)
        pipe = for_model(cfg, batch=4, seq_len=16, seed=seed)
        got = pipe.batch_at(step)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(pipe.host_batch_at(step)["targets"],
                                      want["targets"])
    assert not np.array_equal(pipe.batch_at(1)["targets"],
                              pipe.batch_at(2)["targets"])


def test_file_tokens_bitwise(tmp_path):
    """The memory-mapped file source draws the reference's windows."""
    path = tmp_path / "tokens.bin"
    np.random.default_rng(5).integers(0, 1000, 5000).astype(
        np.uint32).tofile(path)
    kw = dict(vocab=1000, batch=3, seq_len=32, seed=2, source="file",
              path=str(path))
    for step in (0, 4):
        want = JPipeline(JDataConfig(**kw)).batch_at(step)
        got = Pipeline(DataConfig(**kw)).batch_at(step)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# AdamW, the schedule, the compression
# ---------------------------------------------------------------------------
def test_decay_set_is_the_reference_s():
    """The decay mask follows the reference's paths on every config: the
    port's keys name the reference's leaves with their shapes, and the
    leaves decayed are the reference's own set (the port's norms are
    ``mixer_norm``, ``ffn_norm``, ``final_norm`` and its sLSTM bias
    ``b``: by name alone the mask would decay every norm)."""
    from repro.configs import ARCH_IDS
    from repro.configs import get_config as jget
    from repro.configs import reduced_config as jred
    from repro.models import build_model
    for arch in ARCH_IDS:
        shapes, _ = build_model(jred(jget(arch))).abstract_params()
        flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
        ref = {jax.tree_util.keystr(p): (tuple(x.shape), _decay_mask(p))
               for p, x in flat}
        port: dict = {}
        for key, p in reference_paths(
                Model(reduced_config(get_config(arch)))).items():
            m = re.fullmatch(r"(.*)\[(\d+)\]", key)
            base = m.group(1) if key.startswith("['group_") else key
            port.setdefault(base, []).append(tuple(p.shape))
        assert set(port) == set(ref), arch
        for base, shapes_ in port.items():
            want = ref[base][0]
            got = ((len(shapes_), *shapes_[0]) if base.startswith(
                "['group_") else shapes_[0])
            assert got == want, (arch, base)
        assert ({k for k in ref if ref[k][1]}
                == {k for k in port if optim.decay_mask(k)}), arch


def _grads_like(params, seed, scale):
    r = np.random.default_rng(seed)
    return jax.tree.map(lambda p: jnp.asarray(
        r.standard_normal(p.shape).astype(np.float32) * scale, p.dtype),
        params)


@pytest.mark.parametrize("moments,clip,steps", [("float32", 1.0, 2),
                                                ("float32", None, 1),
                                                ("bfloat16", 1.0, 1)])
def test_adamw_update_matches_reference(moments, clip, steps):
    """AdamW on every leaf of gemma-2b-smoke (bf16 weights, f32 norms):
    with global-norm clipping active (grad norm ~ 300 against 1.0) or
    off, f32 or bf16 moments, weight decay 0.1 on the reference's decay
    set; one or two steps (the bias corrections at step 2)."""
    _, _, params = smoke("gemma-2b")
    jcfg = joptim.AdamWConfig(learning_rate=1e-2, clip_norm=clip,
                              moment_dtype=moments)
    ocfg = optim.AdamWConfig(learning_rate=1e-2, clip_norm=clip,
                             moment_dtype=moments)
    jstate = joptim.init(jcfg, params)
    jparams = params
    model = port_model()
    tparams = reference_paths(model)
    state = optim.init(ocfg, tparams)
    apply = optim.update(ocfg)
    japply = jax.jit(joptim.update(jcfg))
    for step in range(steps):
        jgrads = _grads_like(params, step, 1.0)
        leaves = ref_leaves(numpy_tree(jgrads))
        grads = {k: torch.tensor(to_np(ref_leaf(leaves, k))).to(p.dtype)
                 for k, p in tparams.items()}
        jparams, jstate, jm = japply(jgrads, jstate, jparams)
        m = apply(grads, state, tparams)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-5)
    assert float(m["lr"]) == float(jm["lr"])
    assert int(state["step"]) == int(jstate["step"]) == steps
    wp, wmu, wnu = (ref_leaves(numpy_tree(t)) for t in
                    (jparams, jstate["mu"], jstate["nu"]))
    mrel = 2.0 ** -8 if moments == "bfloat16" else 1e-5
    for key, p in tparams.items():
        want = to_np(ref_leaf(wp, key))
        ulp = 2.0 ** -8 if p.dtype == torch.bfloat16 else 1e-6
        np.testing.assert_allclose(to_np(p), want, rtol=ulp,
                                   atol=ulp * 1e-3, err_msg=key)
        for got, ref in ((state["mu"][key], wmu), (state["nu"][key], wnu)):
            assert got.dtype == (torch.bfloat16 if moments == "bfloat16"
                                 else torch.float32)
            rel_close(got, ref_leaf(ref, key), mrel)


def test_adamw_converges_quadratic():
    ocfg = optim.AdamWConfig(learning_rate=0.1, weight_decay=0.0,
                             clip_norm=None)
    params = {"['w']": torch.tensor([5.0, -3.0])}
    state = optim.init(ocfg, params)
    upd = optim.update(ocfg)
    for _ in range(200):
        upd({"['w']": 2 * params["['w']"]}, state, params)
    assert float(params["['w']"].abs().max()) < 0.05


def test_cosine_schedule_matches_reference():
    want = joptim.cosine_schedule(1e-3, warmup=10, total=100)
    got = optim.cosine_schedule(1e-3, warmup=10, total=100)
    for s in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(
            float(got(torch.tensor(s, dtype=torch.int32))),
            float(want(jnp.asarray(s, jnp.int32))), rtol=1e-7)


def test_int8_compression_codes_and_scales_exact():
    """Per-tensor int8 codes and f32 scales equal the reference's, on
    f32 and bf16 gradients, and the round trip decompresses alike."""
    r = np.random.default_rng(3)
    tree = {"a": r.standard_normal((64, 48)).astype(np.float32) * 0.01,
            "b": r.standard_normal((7,)).astype(np.float32) * 3.0,
            "c": np.zeros((5,), np.float32)}
    for dtype in ("float32", "bfloat16"):
        jg = {k: jnp.asarray(v, dtype) for k, v in tree.items()}
        tg = {k: torch.tensor(to_np(v)).to(getattr(torch, dtype))
              for k, v in jg.items()}
        jq, js = joptim.int8_compress_grads(jg)
        q, s = optim.int8_compress_grads(tg)
        for k in tree:
            np.testing.assert_array_equal(q[k].numpy(), np.asarray(jq[k]))
            np.testing.assert_array_equal(s[k].numpy(), np.asarray(js[k]))
        back = optim.int8_decompress_grads(q, s)
        jback = joptim.int8_decompress_grads(jq, js)
        for k in tree:
            np.testing.assert_array_equal(back[k].numpy(),
                                          np.asarray(jback[k]))
    lq, ls = optim.int8_compress_grads([tg["a"], tg["b"]])
    assert isinstance(lq, list) and lq[1].dtype == torch.int8


# ---------------------------------------------------------------------------
# checkpointer
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip_bf16_bits_and_device(tmp_path):
    """bf16 round-trips bit for bit (stored as uint16), f32 and int32
    too, in the caller's tree structure; ``restore`` places tensors on
    the device it is given and casts to the reference tree's dtype."""
    model = port_model()
    tree = {"params": dict(model.named_parameters()),
            "opt": {"step": torch.tensor(7, dtype=torch.int32),
                    "mu": [torch.randn(3, 4)]}}
    ck = Checkpointer(tmp_path, async_writes=False)
    ck.save(10, tree)
    assert ck.latest_step() == 10
    back = ck.restore(10, tree, device="cpu")
    for name, p in model.named_parameters():
        got = back["params"][name]
        assert got.dtype == p.dtype and got.device.type == "cpu"
        assert torch.equal(got.view(torch.int16) if p.dtype ==
                           torch.bfloat16 else got,
                           p.detach().view(torch.int16) if p.dtype ==
                           torch.bfloat16 else p.detach())
    assert int(back["opt"]["step"]) == 7
    assert torch.equal(back["opt"]["mu"][0], tree["opt"]["mu"][0])
    with pytest.raises(FileNotFoundError):
        ck.restore(11, tree)


def test_async_retention_and_latest(tmp_path):
    ck = Checkpointer(tmp_path, keep=2, async_writes=True)
    x = {"w": torch.arange(6.0)}
    for s in (1, 2, 3, 4):
        ck.save(s, x)
    ck.wait()
    assert ck.latest_step() == 4
    steps = sorted(int(p.name.split("_")[1])
                   for p in tmp_path.glob("step_*"))
    assert steps == [3, 4]
    step, back = ck.restore_latest(x)
    assert step == 4 and torch.equal(back["w"], x["w"])


def test_async_snapshot_is_a_copy(tmp_path, monkeypatch):
    """An in-place update made right after ``save`` (the next AdamW
    step racing the writer thread) does not reach the checkpoint: the
    snapshot is a host copy taken before ``save`` returns.  The writer
    is held until the update is done."""
    gate = threading.Event()
    real_savez = np.savez

    def held_savez(*a, **kw):
        assert gate.wait(timeout=30)
        return real_savez(*a, **kw)

    monkeypatch.setattr(np, "savez", held_savez)
    w = torch.arange(1000, dtype=torch.float32)
    b = torch.ones(8, dtype=torch.bfloat16)
    ck = Checkpointer(tmp_path, async_writes=True)
    ck.save(1, {"w": w, "b": b})
    with torch.no_grad():
        w.add_(1.0)
        b.mul_(3.0)
    gate.set()
    ck.wait()
    back = ck.restore(1, {"w": w, "b": b})
    assert torch.equal(back["w"], torch.arange(1000, dtype=torch.float32))
    assert torch.equal(back["b"], torch.ones(8, dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------
def test_straggler_policy_flags_the_reference_s_steps():
    r = np.random.default_rng(4)
    times = list(np.abs(r.normal(0.1, 0.01, 60)))
    for i in (12, 30, 31, 50):
        times[i] = 0.1 * (3 + i % 5)
    for kw in ({}, {"warmup": 3, "k": 2.0}, {"beta": 0.5, "k": 1.0}):
        got, want = StragglerPolicy(**kw), JStraggler(**kw)
        flags = [got.observe(s, dt) for s, dt in enumerate(times)]
        assert flags == [want.observe(s, dt) for s, dt in enumerate(times)]
        assert got.flagged == want.flagged and got.flagged


def _trainer(tmp_path, total, hook=None, async_checkpoint=False):
    cfg = reduced_config(get_config("gemma-2b"))
    _, _, params = smoke("gemma-2b")
    model = params_from_jax(numpy_tree(params), cfg, device="cpu")
    ocfg = optim.AdamWConfig(learning_rate=3e-3, weight_decay=0.0)
    step = simple_train_step(model, ocfg)
    opt_state = optim.init(ocfg, step.params)
    pipe = for_model(cfg, batch=4, seq_len=16, seed=1)
    tc = TrainerConfig(total_steps=total, checkpoint_every=5, log_every=4,
                       checkpoint_dir=str(tmp_path),
                       async_checkpoint=async_checkpoint)
    return Trainer(model, step, opt_state, pipe, tc, failure_hook=hook)


def test_loss_decreases(tmp_path):
    out = _trainer(tmp_path, 30).run()
    assert out["final_step"] == 30
    assert out["final_loss"] < out["history"][0]["loss"], out["history"]


def test_crash_restart_is_bitwise_an_uninterrupted_run(tmp_path):
    """A crash at step 8 (async checkpoints every 5), a relaunch that
    restores step 5 and runs to 12: every weight and moment, and the
    last loss, bitwise those of a run that never crashed."""
    def bomb(step):
        if step == 8:
            raise RuntimeError("simulated node failure")

    crashed = _trainer(tmp_path / "b", 12, bomb, async_checkpoint=True)
    with pytest.raises(RuntimeError):
        crashed.run()
    crashed.ckpt.wait()
    assert crashed.ckpt.latest_step() == 5
    resumed = _trainer(tmp_path / "b", 12, async_checkpoint=True)
    out = resumed.run()
    assert out["final_step"] == 12 and resumed.ckpt.latest_step() == 12
    straight = _trainer(tmp_path / "c", 12, async_checkpoint=True)
    want = straight.run()
    assert out["final_loss"] == want["final_loss"]
    for (n, p), (_, q) in zip(resumed.model.named_parameters(),
                              straight.model.named_parameters()):
        assert torch.equal(p, q), n
    for k in ("mu", "nu"):
        for key, t in resumed.opt_state[k].items():
            assert torch.equal(t, straight.opt_state[k][key]), (k, key)
    assert int(resumed.opt_state["step"]) == 12


# ---------------------------------------------------------------------------
# the guard: a kernel without a backward refuses a tensor that needs one
# ---------------------------------------------------------------------------
class NoLibrary(Exception):
    pass


class OnCard(torch.Tensor):
    """A CPU tensor that reports the card as its device: a wrapper given
    it takes its card branch (``_launch.on_cpu`` reads ``.device``)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def on_card(t):
    """``t`` as an :class:`OnCard` view (same storage, same autograd
    history)."""
    return t.as_subclass(OnCard)


# past the guard, a launch stops at the first step that needs the card:
# the library load (patched below), or, in a torch built without CUDA,
# the output's allocation
PAST_THE_GUARD = (NoLibrary, AssertionError)


@pytest.fixture
def no_library(monkeypatch):
    """A launch that gets past the guard stops at the library load."""
    def load(name):
        raise NoLibrary(name)

    monkeypatch.setattr(_build, "load", load)


def _guard_calls():
    x = on_card(torch.randn(8, 64)).requires_grad_()
    w = on_card(torch.randint(-127, 128, (64, 32), dtype=torch.int8))
    s = on_card(torch.rand(32) + 0.5)
    xq = on_card(torch.randint(-127, 128, (8, 64), dtype=torch.int8))
    # a row quantizer's scale of an activation that needs grad
    xs = on_card(torch.rand(8, 1) + 0.5).requires_grad_()
    q = on_card(torch.randn(1, 64, 2, 16)).requires_grad_()
    k = on_card(torch.randn(1, 64, 1, 16))
    return {
        "quantize_rows_int8": lambda: cg.quantize_rows_int8(x),
        "cim_gemm_int8_fused_qin": lambda: cg.cim_gemm_int8_fused_qin(
            x, w, s),
        "cim_gemm_int8_fused": lambda: cg.cim_gemm_int8_fused(
            xq, w, xs, s),
        "cim_gated_gemm_int8": lambda: cg.cim_gated_gemm_int8(
            xq, w, w, xs, s, s),
        "flash_attention": lambda: fa.flash_attention(q, k, k),
        "ssd_scan": lambda: ss.ssd_scan(
            on_card(torch.randn(2, 16, 8)).requires_grad_(),
            on_card(-torch.rand(2, 16)), on_card(torch.randn(2, 16, 4)),
            on_card(torch.randn(2, 16, 4)), chunk=8),
    }


@pytest.mark.parametrize("name", ["quantize_rows_int8",
                                  "cim_gemm_int8_fused_qin",
                                  "cim_gemm_int8_fused",
                                  "cim_gated_gemm_int8", "flash_attention",
                                  "ssd_scan"])
def test_guard_raises_on_a_tensor_that_needs_grad(no_library, name):
    """Kernels 1-4, 12 and 13 on the card branch: an input that requires
    grad under grad mode raises, naming the kernel, before any launch;
    under ``no_grad`` the call goes past the guard towards its launch."""
    call = _guard_calls()[name]
    with pytest.raises(RuntimeError, match=f"{name}: the kernel has no "
                                           f"backward"):
        call()
    with torch.no_grad(), pytest.raises(PAST_THE_GUARD) as past:
        call()
    assert (isinstance(past.value, NoLibrary)
            or "not compiled with CUDA" in str(past.value)), past.value


def test_the_attention_function_launches_kernel_12_under_grad(no_library):
    """Inside ``CachelessAttention.forward`` grad mode is off, so kernel
    12 goes past the guard towards its launch whatever its inputs
    require."""
    q = on_card(torch.randn(1, 2100, 2, 16)).requires_grad_()
    k = on_card(torch.randn(1, 2100, 1, 16))
    pos = on_card(torch.arange(2100)[None])
    with pytest.raises(PAST_THE_GUARD) as past:
        tattn.CachelessAttention.apply(q, k, k, pos, "causal", None, None,
                                       True)
    assert (isinstance(past.value, NoLibrary)
            or "not compiled with CUDA" in str(past.value)), past.value


def test_zamba2_training_on_the_card_raises(monkeypatch, no_library):
    """Without the kernel's library, a training loss through kernel 13 on
    the card raises at the launch, not at the guard: the scan goes
    through ``SSDScan``, whose forward runs with grad mode off, so the
    guard lets it by and the call fails only where the launch needs the
    card (the library load here).  The model runs on the CPU; the
    scan's inputs reach its wrapper as card tensors."""
    scan = ss.ssd_scan
    monkeypatch.setattr(ss, "ssd_scan", lambda *a, **kw: scan(
        *(on_card(t) if isinstance(t, torch.Tensor) else t for t in a),
        **kw))
    model = port_model(arch="zamba2-1.2b").trainable()
    batch = {"inputs": torch.zeros((1, 16), dtype=torch.long),
             "targets": torch.zeros((1, 16), dtype=torch.long)}
    with pytest.raises(PAST_THE_GUARD) as past:
        model.loss(batch)
    assert (isinstance(past.value, NoLibrary)
            or "not compiled with CUDA" in str(past.value)), past.value


def test_a_quantized_model_is_not_trained():
    from repro_torch.quant import QuantPlan
    with pytest.raises(NotImplementedError, match="quantized"):
        port_model(QuantPlan.full()).trainable()
    assert not any(p.requires_grad for p in port_model().parameters())
