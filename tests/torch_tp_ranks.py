"""Rank-side work of ``tests/test_torch_tp.py``: what each tensor-parallel
rank computes on its shards, returned as numpy so that the parent test
can hold it against the unsharded port and the JAX reference.

Imports torch, numpy and the port only (no JAX): the ranks are processes
started with ``spawn`` and import this module by name.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops
from repro_torch.parallel.context import tp_context
from repro_torch.parallel.sharding import shard_model
from repro_torch.quant import QuantPlan
from repro_torch.quant import tp as qtp
from repro_torch.serving import PagedServingEngine, Request

# the entry points a launch goes through (``ops`` and the attention walks)
SPY_NAMES = ("quantize_rows_int8", "cim_gemm_int8_fused_qin",
             "cim_gemm_int8_fused", "cim_gated_gemm_int8", "cim_gemm_int8",
             "cim_grouped_gemm_int8", "cim_grouped_gated_gemm_int8")
SPY_ATTN = ("decode_attention", "decode_attention_paged")


def np_of(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


@contextlib.contextmanager
def spy():
    """Count the calls of every kernel entry point (on the CPU each runs
    its plain version; on the card each call is one launch)."""
    counts = dict.fromkeys(SPY_NAMES + SPY_ATTN, 0)
    saved = []

    def wrap(mod, name):
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def counted(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        setattr(mod, name, counted)
    for name in SPY_NAMES:
        wrap(ops, name)
    for name in SPY_ATTN:
        wrap(da, name)
    try:
        yield counts
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def leaf_shapes(model) -> dict:
    """The shapes of layer 0's quantized leaves and its KV head count."""
    block = model.layers[0]
    out = {"kv_heads": block.attn.n_kv_heads}
    mods = {"attn": block.attn}
    if block.spec[1] == "moe":
        mods["experts"] = block.moe
        if hasattr(block.moe, "shared"):
            mods["shared"] = block.moe.shared
    else:
        mods["mlp"] = block.mlp
    for mname, mod in mods.items():
        for name in ("qkv", "o", "up", "gate", "down"):
            w = getattr(mod, name, None)
            if hasattr(w, "q"):
                out[f"{mname}.{name}"] = (tuple(w.q.shape),
                                          tuple(w.scale.shape), w.tp_size)
    return out


def _local_heads(q, H_l, KH_l, rank):
    """q [B, 1, H, D] -> this rank's [B, KH_l, G_l, D] (its q heads)."""
    B, _, _, D = q.shape
    ql = q[:, 0, rank * H_l:(rank + 1) * H_l]
    return ql.reshape(B, KH_l, H_l // KH_l, D).contiguous()


def _kv_local(t, kv: slice):
    return t[:, :, kv].contiguous()


def functions(group, case: dict) -> dict:
    """Every ``quant/tp.py`` function on this rank's shards of
    ``case["model"]`` (a quantized port model whose attention and MLPs
    the group size divides), with the plain path and with the kernel
    path; returns outputs and collective counts."""
    model = shard_model(case["model"], group)
    block = model.layers[0]
    attn = block.attn
    r = group.rank
    H_l, KH_l = attn.o.q.shape[0], attn.n_kv_heads
    kv = (slice(r * KH_l, (r + 1) * KH_l)
          if KH_l < case["ring"]["k"].shape[2] else slice(None))
    out = {"shapes": leaf_shapes(model), "rank": r}
    for use_kernel in (False, True):
        tag = "kernel" if use_kernel else "plain"
        res = {}

        def run(name, fn):
            group.reset_counts()
            res[name] = np_of(fn())
            res[name + ".counts"] = dict(group.counts)
        d = case["x"].shape[1]
        qkv = attn.qkv
        run("matmul_column", lambda: qtp.matmul_column(
            group, case["x"], qkv.q.reshape(d, -1), qkv.scale.reshape(-1),
            use_kernel))
        o = attn.o
        x2 = case["attn_out"][:, r * H_l:(r + 1) * H_l].reshape(
            case["attn_out"].shape[0], -1)
        run("matmul_row", lambda: qtp.matmul_row(
            group, x2, o.q.reshape(-1, d), o.scale, use_kernel,
            residual=case["res"]))
        mlp = block.moe.shared if block.spec[1] == "moe" else block.mlp
        run("mlp", lambda: qtp.mlp(group, case["x"], mlp, case["act"],
                                   use_kernel, residual=case["res"]))
        if block.spec[1] == "moe":
            run("grouped_moe", lambda: qtp.grouped_moe(
                group, case["xe"], block.moe, case["act"], use_kernel,
                expert_counts=case["counts"]))
        ring, paged = case["ring"], case["paged"]
        q4 = _local_heads(case["q"], H_l, KH_l, r)
        heads = (q4.shape[0], H_l, q4.shape[-1])      # [B, H_l, D]
        run("decode_attn", lambda: qtp.decode_attn(
            q4, _kv_local(ring["k"], kv), _kv_local(ring["v"], kv),
            ring["pos"], ring["q_pos"], _kv_local(ring["k_scale"], kv),
            _kv_local(ring["v_scale"], kv),
            use_kernel=use_kernel).reshape(heads))
        run("decode_attn_paged", lambda: qtp.decode_attn_paged(
            q4, _kv_local(paged["k"], kv), _kv_local(paged["v"], kv),
            paged["pos"], paged["tables"], ring["q_pos"],
            _kv_local(paged["k_scale"], kv),
            _kv_local(paged["v_scale"], kv),
            use_kernel=use_kernel).reshape(heads))
        out[tag] = res
    return out


def _serve(engine, prompts, max_new):
    reqs = [Request(uid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for req in reqs:
        engine.submit(req)
    with spy() as counts:
        engine.tp.reset_counts()
        engine.run_until_done()
    st = engine.stats
    out = dict(tokens=[list(r.generated) for r in reqs],
               status=[r.status.value for r in reqs],
               launches=dict(counts), collectives=dict(engine.tp.counts),
               decode_steps=st.decode_steps, prefills=st.prefills,
               prefill_chunks=st.prefill_chunks,
               preemptions=st.preemptions,
               cache_kv_heads=tuple(c["k" if "k" in c else "k_pages"].shape[2]
                                    for c in engine.cache))
    if isinstance(engine, PagedServingEngine):
        engine.paged.allocator.check()
        out["blocks_held"] = engine.paged.allocator.n_used
    return out


def engines(group, case: dict) -> dict:
    """The ring and paged engines over this rank's shards of
    ``case["model"]``, and one prefill + decode step's logits."""
    model = case["model"]
    plan = QuantPlan.full()
    out = {}
    for name, cls, kw in case["engines"]:
        eng = cls(model, quant_plan=plan, tp=group, **kw)
        out[name] = _serve(eng, case["prompts"], case["max_new"])
    out["shapes"] = leaf_shapes(model)
    if "logits" in case:
        toks, lengths = case["logits"]
        caches = model.init_cache(toks.shape[0], 32, kv_dtype="int8")
        with torch.no_grad(), tp_context(group):
            a = model.prefill_padded(toks, caches, lengths)
            b = model.decode_step(a.argmax(-1), caches)
        out["logits"] = np_of(torch.cat([a, b], dim=1))
    return out


class StepClock:
    """An engine clock that reads ``start + rate * n`` on its n-th read:
    each rank of the deadline test gets its own ``start`` and ``rate``."""

    def __init__(self, start: float, rate: float):
        self.start, self.rate, self.reads = start, rate, 0

    def __call__(self) -> float:
        self.reads += 1
        return self.start + self.rate * self.reads


def serve_with_deadlines(engine, prompts, deadlines, max_new) -> dict:
    """Serve ``prompts`` with per-request ``deadlines``, stepping by hand;
    returns each request's status, tokens and the step at which it went
    terminal, the steps taken, and how many of them began with a pending
    request that carries a deadline."""
    reqs = [Request(uid=i, prompt=p, max_new_tokens=max_new, deadline_s=d)
            for i, (p, d) in enumerate(zip(prompts, deadlines))]
    for req in reqs:
        engine.submit(req)
    if engine.tp is not None:
        engine.tp.reset_counts()
    ended, steps, with_deadline = {}, 0, 0
    while engine.pending():
        with_deadline += any(r.deadline_s is not None and not r.done
                             for r in reqs)
        engine.step()
        steps += 1
        for r in reqs:
            if r.done:
                ended.setdefault(r.uid, steps)
    engine.run_until_done()      # under tp: the ranks' agreement check
    return dict(status=[r.status.value for r in reqs],
                tokens=[list(r.generated) for r in reqs],
                ended=[ended[r.uid] for r in reqs], steps=steps,
                with_deadline=with_deadline)


def deadlines(group, case: dict) -> dict:
    """Each engine of ``case["engines"]`` over this rank's shards, read
    from this rank's own clock (``case["clocks"][rank]``), serving
    requests with deadlines; and the broadcasts each run made."""
    out = {}
    for name, cls, kw in case["engines"]:
        eng = cls(case["model"], quant_plan=QuantPlan.full(), tp=group,
                  clock=StepClock(*case["clocks"][group.rank]), **kw)
        out[name] = serve_with_deadlines(eng, case["prompts"],
                                         case["deadlines"], case["max_new"])
        out[name]["collectives"] = dict(group.counts)
    return out


def run_cases(group, cases: dict) -> dict:
    """``cases``: name -> ("functions" | "engines", case dict).  One
    thread per rank: the ranks share the host's cores, and the shapes
    are tiny."""
    torch.set_num_threads(1)
    todo = {"functions": functions, "engines": engines,
            "deadlines": deadlines}
    return {name: todo[kind](group, case)
            for name, (kind, case) in cases.items()}

