"""Rank-side work of ``tests/test_torch_tp.py`` and
``tests/test_torch_tp_families.py``: what each tensor-parallel rank
computes on its shards, returned as numpy so that the parent test can
hold it against the unsharded port and the JAX reference.

Imports torch, numpy and the port only (no JAX): the ranks are processes
started with ``spawn`` and import this module by name.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.kernels import cim_gemm as cg
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import Model
from repro_torch.models.dit import DiTModel
from repro_torch.parallel.context import tp_context
from repro_torch.parallel.sharding import shard_model
from repro_torch.quant import QuantPlan
from repro_torch.quant.linear import quantized_moe_apply
from repro_torch.quant import tp as qtp
from repro_torch.serving import PagedServingEngine, Request, ServingEngine

# the entry points a launch goes through (``ops``, the attention walks and
# the SSD scan)
SPY_NAMES = ("quantize_rows_int8", "cim_gemm_int8_fused_qin",
             "cim_gemm_int8_fused", "cim_gated_gemm_int8", "cim_gemm_int8",
             "cim_grouped_gemm_int8", "cim_grouped_gated_gemm_int8")
SPY_ATTN = ("decode_attention", "decode_attention_paged",
            "decode_attention_partial", "decode_attention_combine")
SPY_SCAN = ("ssd_scan",)


def np_of(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


@contextlib.contextmanager
def spy(scan: bool = False):
    """Count the calls of every kernel entry point (on the CPU each runs
    its plain version; on the card each call is one launch), the SSD
    scan's too with ``scan``."""
    counts = dict.fromkeys(SPY_NAMES + SPY_ATTN + (SPY_SCAN if scan
                                                    else ()), 0)
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
    for name in SPY_SCAN if scan else ():
        wrap(ssd, name)
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
            def grouped_moe():
                with tp_context(group):
                    return quantized_moe_apply(
                        block.moe, case["xe"], case["act"],
                        use_kernel=use_kernel, expert_counts=case["counts"])
            run("grouped_moe", grouped_moe)
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


def _serve(engine, prompts, max_new, scan=False):
    reqs = [Request(uid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for req in reqs:
        engine.submit(req)
    with spy(scan) as counts:
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
                                    for c in engine.cache
                                    if "k" in c or "k_pages" in c),
               cache_shapes=[{k: tuple(v.shape) for k, v in c.items()
                              if k not in ("index", "block_tables")}
                             for c in engine.cache])
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


# ---------------------------------------------------------------------------
# every family, DiT, degraded mode and faults (tests/test_torch_tp_families.py)
# ---------------------------------------------------------------------------
def tp_shapes(model) -> dict:
    """Per layer kind (its first layer): each leaf's shape (a quantized
    leaf's q and scale), the attention's KV heads."""
    out = {}
    layers = getattr(model, "blocks", None) or model.layers
    for block in layers:
        spec = getattr(block, "spec", ("attn", "dense"))
        mods = {}
        for name in ("attn", "mla", "mamba", "mlstm", "slstm", "mlp", "moe"):
            mod = getattr(block, name, None)
            if mod is not None:
                mods[name] = mod
        if "moe" in mods and hasattr(mods["moe"], "shared"):
            mods["shared"] = mods["moe"].shared
        for mname, mod in mods.items():
            key = f"{spec[0]}/{mname}"
            if key in out:
                continue
            leaves = {}
            for name, leaf in mod.named_children():
                if hasattr(leaf, "q"):
                    leaves[name] = (tuple(leaf.q.shape),
                                    tuple(leaf.scale.shape), leaf.tp_size)
            for name, p in mod.named_parameters(recurse=False):
                leaves[name] = tuple(p.shape)
            if mname == "attn":
                leaves["kv_heads"] = mod.n_kv_heads
            out[key] = leaves
    return out


def _logits(model, group, case):
    """One prefill and two decode steps' logits under the group: token
    prompts, or an audio config's frame embeddings."""
    feed = case["logits"]
    with torch.no_grad(), tp_context(group):
        if "frames" in feed:
            frames, lengths, steps = feed["frames"], feed["lengths"], \
                feed["steps"]
            caches = model.init_cache(frames.shape[0], 64, kv_dtype="int8")
            outs = [model.prefill_padded(None, caches, lengths,
                                         frame_embeddings=frames)]
            for f in steps:
                outs.append(model.decode_step(None, caches,
                                              frame_embeddings=f))
        else:
            toks, lengths = feed["tokens"], feed["lengths"]
            caches = model.init_cache(toks.shape[0], 32, kv_dtype="int8")
            outs = [model.prefill_padded(toks, caches, lengths)]
            for _ in range(2):
                outs.append(model.decode_step(outs[-1].argmax(-1), caches))
    return np_of(torch.cat(outs, dim=1))


def family(group, case: dict) -> dict:
    """A family's smoke model sharded over the group: its leaf shapes,
    the engines of ``case["engines"]`` over the same requests, and the
    logits of :func:`_logits`."""
    model = shard_model(case["model"], group)
    out = {"shapes": tp_shapes(model)}
    for name, cls, kw in case.get("engines", ()):
        eng = cls(model, quant_plan=QuantPlan.full(), tp=group, **kw)
        out[name] = _serve(eng, case["prompts"], case["max_new"], scan=True)
    if "logits" in case:
        group.reset_counts()
        out["logits"] = _logits(model, group, case)
        out["logits.collectives"] = dict(group.counts)
    if "long" in case:                  # a cacheless forward, its last row
        with torch.no_grad(), tp_context(group):
            out["long"] = np_of(model(case["long"], last_index=torch.tensor(
                [case["long"].shape[1] - 1])))
    return out


def dit(group, case: dict) -> dict:
    """DiT at the group: the engine's latents, a direct ``sample()`` under
    the group on the same noise, launches and collectives."""
    from repro_torch.diffusion import DiffusionEngine, ImageRequest, sample
    model = case["model"]
    eng = DiffusionEngine(model, batch_size=case["batch"],
                          quant_plan=QuantPlan.full(), tp=group)
    reqs = [ImageRequest(uid=i, label=lab, num_steps=case["steps"],
                         cfg_scale=case["cfg"]) for i, lab in
            enumerate(case["labels"])]
    for r in reqs:
        eng.submit(r)
    group.reset_counts()
    with spy(scan=True) as counts:
        eng.run_until_done()
    out = dict(latents=[r.latents for r in reqs],
               status=[r.status.value for r in reqs],
               launches=dict(counts), collectives=dict(group.counts),
               shapes=tp_shapes(model))
    with torch.no_grad(), tp_context(group):
        out["sample"] = np_of(sample(model, case["direct_labels"],
                                     x_init=case["noise"],
                                     num_steps=case["steps"],
                                     cfg_scale=case["cfg"]))
    return out


def poison(w, scale_index: tuple, q_axes: tuple, value: float) -> bool:
    """Set ``w.scale`` at the whole leaf's ``scale_index`` to ``value``
    where this rank holds it (``q_axes``: the q axis of each scale
    axis); returns whether it does."""
    at = []
    for i, ax in zip(scale_index, q_axes):
        held = None if w.tp_index is None else w.tp_index[ax]
        if held is None:
            at.append(i)
            continue
        hit = (held == i).nonzero()
        if not len(hit):
            return False
        at.append(int(hit[0, 0]))
    with torch.no_grad():
        w.scale[tuple(at)] = value
    return True


def _leaf(model, path: str):
    mod = model
    for part in path.split("."):
        mod = mod[int(part)] if part.isdigit() else getattr(mod, part)
    return mod


@contextlib.contextmanager
def fallbacks():
    """Count the gated fallbacks that wrote a layer's output: the plain
    gated launches' writes (``cim_gemm._gated_out``) and the row-parallel
    sites' (``quant.tp._write_if``), each when its flag was set."""
    seen = {"gated": 0, "row": 0}
    saved_out, saved_write = cg._gated_out, qtp._write_if

    def gated_out(gate, out, result):
        if out is not None and cg._tripped(gate):
            seen["gated"] += 1
        return saved_out(gate, out, result)

    def write_if(flag, new, out):
        seen["row"] += bool(flag.reshape(-1)[0])
        return saved_write(flag, new, out)
    cg._gated_out, qtp._write_if = gated_out, write_if
    try:
        yield seen
    finally:
        cg._gated_out, qtp._write_if = saved_out, saved_write


def degraded(group, case: dict) -> dict:
    """The ring engine in degraded mode over the group, with NaN/inf
    planted at whole-leaf places of ``case["faults"]`` (each on the
    ranks that hold it): statuses, tokens, fallbacks taken, launches and
    collectives."""
    model = shard_model(case["model"], group)
    held = [poison(_leaf(model, path), idx, axes, value)
            for path, idx, axes, value in case["faults"]]
    eng = ServingEngine(model, quant_plan=QuantPlan.full(), tp=group,
                        degraded=True, **case["kw"])
    with fallbacks() as seen:
        res = _serve(eng, case["prompts"], case["max_new"])
    res.update(held=held, fallbacks=dict(seen))
    return res


def chaos(group, case: dict) -> dict:
    """A chaos soak through the ring engine over the group (degraded,
    ``fault_hook`` from the monkey): statuses, tokens, the report, and
    whether every int8 weight is back bitwise afterwards."""
    from repro_torch.reliability import chaos_soak, quantized_leaves
    model = shard_model(case["model"], group)
    eng = ServingEngine(model, quant_plan=QuantPlan.full(), tp=group,
                        degraded=True, **case["kw"])
    before = quantized_leaves(model)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=case["max_new"],
                    temperature=0.7, top_k=5, seed=11)
            for i, p in enumerate(case["prompts"])]
    res = chaos_soak(eng, reqs, **case["soak"])
    after = quantized_leaves(model)
    return dict(status=[r.status.value for r in reqs],
                tokens=[list(r.generated) for r in reqs],
                report=dataclasses.asdict(res.chaos),
                violations=res.violations,
                restored=all(np.array_equal(before[p].q, after[p].q)
                             for p in before),
                sharded=sum(v.shard is not None for v in before.values()))


def draws(group, case: dict) -> dict:
    """Each config of ``case["configs"]`` drawn leaf by leaf into this
    rank's shards (``init(tp=)``) against the whole draw, quantized and
    cut: the names of the tensors whose bits differ (none expected)."""
    out = {}
    for cfg in case["configs"]:
        cls = DiTModel if hasattr(cfg, "patch_size") else Model
        mine = cls(cfg).init(0, device="cpu", tp=group,
                             plan=QuantPlan.full())
        whole = shard_model(cls(cfg).init(0, device="cpu").quantize(
            QuantPlan.full()), group)
        a, b = mine.state_dict(), whole.state_dict()
        out[cfg.name] = sorted(set(a) ^ set(b)) + sorted(
            k for k in set(a) & set(b)
            if a[k].shape != b[k].shape or not torch.equal(a[k], b[k]))
    return out


def cli(group, case: dict) -> dict:
    """The DiT CLI's rank (``launch.generate._generate_rank``) on the
    arguments ``case["argv"]``."""
    from repro_torch.launch import generate
    args = generate.parser().parse_args(case["argv"])
    return generate._generate_rank(group, args)


# ---------------------------------------------------------------------------
# context and vocabulary parallelism, protect_tree on shards
# (tests/test_torch_context_parallel.py, test_torch_vocab_parallel.py,
# test_torch_faults.py)
# ---------------------------------------------------------------------------
def caches_np(caches) -> list:
    return [{k: np_of(v.clone()) for k, v in c.items()} for c in caches]


def direct_loop(model, group, toks, lengths, cap: int, steps: int) -> dict:
    """A prefill of ``toks`` (``lengths`` valid) into int8 ring caches of
    ``cap`` slots, then ``steps`` greedy decode steps, under ``group``:
    the logits of each forward and every cache leaf after each."""
    with torch.no_grad(), tp_context(group):
        caches = model.init_cache(toks.shape[0], cap, kv_dtype="int8")
        outs = [model.prefill_padded(toks, caches, lengths)]
        snaps = [caches_np(caches)]
        for _ in range(steps):
            outs.append(model.decode_step(outs[-1].argmax(-1), caches))
            snaps.append(caches_np(caches))
    return dict(logits=np_of(torch.cat(outs, dim=1)), caches=snaps)


def served_logits(engine, prompts, max_new) -> dict:
    """Serve ``prompts`` greedily; the tokens and the logits each
    sampled step saw, keyed (uid, step)."""
    seen = {}
    sample = engine._sample

    def recording(req, logits, step):
        seen[(req.uid, step)] = np.array(logits, np.float32, copy=True)
        return sample(req, logits, step)
    engine._sample = recording
    reqs = [Request(uid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for req in reqs:
        engine.submit(req)
    engine.run_until_done()
    return dict(tokens=[list(r.generated) for r in reqs],
                status=[r.status.value for r in reqs], logits=seen)


def context(group, case: dict) -> dict:
    """The ring (or MLA's latent) cache cut by sequence on this rank:
    :func:`direct_loop`, the ring engine's tokens and logits, launches
    and collectives, and each cache leaf's bytes."""
    model = shard_model(case["model"], group)
    toks, lengths = case["direct"]
    group.reset_counts()
    with spy() as counts:
        out = direct_loop(model, group, toks, lengths, case["cap"],
                          case["steps"])
    out.update(launches=dict(counts), collectives=dict(group.counts))
    eng = ServingEngine(model, quant_plan=QuantPlan.full(), tp=group,
                        **case["kw"])
    out["engine"] = served_logits(eng, case["prompts"], case["max_new"])
    out["cache_bytes"] = [{k: v.numel() * v.element_size()
                           for k, v in c.items()} for c in eng.cache]
    return out


def vocab(group, case: dict) -> dict:
    """The vocabulary cut by rows on this rank: the lookup and the
    gathered logits of ``case["tables"]`` (whole tables, cut here) and a
    model's embedding and head bytes, its logits under the group."""
    from repro_torch.models import layers
    r, p = group.rank, group.size
    out = {"tables": []}
    for emb, tokens, x in case["tables"]:
        n = emb.shape[0] // p
        rows = emb[r * n:(r + 1) * n].contiguous()
        group.reset_counts()
        got = dict(lookup=layers.embedding_apply(rows, tokens, group),
                   tied=layers.embedding_attend(rows, x, group),
                   untied=layers.lm_head_apply(rows.t().contiguous(), x,
                                               group))
        out["tables"].append(dict({k: np_of(v) for k, v in got.items()},
                                  counts=dict(group.counts)))
    for name, model in case["models"].items():
        model = shard_model(model, group)
        toks, lengths = case["logits"]
        group.reset_counts()
        res = direct_loop(model, group, toks, lengths, 32, 1)
        res["collectives"] = dict(group.counts)
        res["bytes"] = {k: model.get_parameter(k).numel()
                        * model.get_parameter(k).element_size()
                        for k in ("embed", "head") if hasattr(model, k)}
        out[name] = res
    for cfg in case["draws"]:
        drawn = Model(cfg).init(0, device="cpu", tp=group,
                                plan=QuantPlan.full())
        out["draw/" + cfg.name] = {k: np_of(drawn.get_parameter(k))
                                   for k in ("embed", "head")
                                   if hasattr(drawn, k)}
    return out


def protect(group, case: dict) -> dict:
    """``protect_tree`` on this rank's shards: each protected leaf's q and
    where it lies in the whole leaf."""
    from repro_torch.reliability import (inject_tree, protect_tree,
                                         quantized_leaves)
    model = shard_model(case["model"], group)
    clean = quantized_leaves(model)
    faulted, _ = inject_tree(clean, case["fault"])
    group.reset_counts()
    prot = protect_tree(clean, faulted, case["fraction"], group)
    return dict(counts=dict(group.counts),
                leaves={p: (leaf.q, None if leaf.shard is None
                            else leaf.shard.index)
                        for p, leaf in prot.items()})


def run_cases(group, cases: dict) -> dict:
    """``cases``: name -> (kind, case dict).  One thread per rank: the
    ranks share the host's cores, and the shapes are tiny."""
    torch.set_num_threads(1)
    todo = {"functions": functions, "engines": engines,
            "deadlines": deadlines, "family": family, "dit": dit,
            "degraded": degraded, "chaos": chaos, "draws": draws,
            "cli": cli, "context": context, "vocab": vocab,
            "protect": protect}
    return {name: todo[kind](group, case)
            for name, (kind, case) in cases.items()}

