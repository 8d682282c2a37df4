"""The port's paged serving path against the JAX reference, on the CPU.

(a) ``BlockAllocator``/``PagedKVCache`` against the reference's classes
    under the same random alloc/free/ensure/release sequences: the same
    block ids, tables, free list and refcounts, exceptions at the same
    steps, invariants after every step.
(b) ``_paged_update``/``_gather_paged`` against the reference's, with
    sentinel-index rows, pads and null table entries: exact.
(c) the plain paged decode against ``repro.kernels.ops.
    decode_attention_paged`` in interpret mode and against
    ``decode_attention_paged_ref`` at the shapes the reference pins
    (windows straddling blocks, int8 KV, all-empty and single-token
    rows), within ``ATTN_TOL = 2e-5`` of the output's largest magnitude
    (the reference's own pin); and bitwise against the port's plain ring
    version on the equivalent layout.
(d) the port's ``PagedServingEngine`` on ``gemma-2b-smoke`` (full and
    empty plan) against a fresh JAX ``PagedServingEngine`` — one that
    reuses no block, since the reference's block reuse is unreliable on
    this jax (ROADMAP C.1) — by the margin rule of
    tests/test_torch_serving.py, and against the port's ring engine.
(e) the reference's engine pins, re-stated on the port.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.quant import QuantPlan as JPlan
from repro.serving import BlockAllocator as JAllocator
from repro.serving import PagedKVCache as JPagedKVCache
from repro.serving import PagedServingEngine as JPagedEngine
from repro.serving import PoolExhausted as JPoolExhausted
from repro.serving import Request as JRequest

from repro_torch.kernels import launch_counts, ops
from repro_torch.models import attention as tattn
from repro_torch.quant import QuantPlan
from repro_torch.serving import (BlockAllocator, PagedKVCache,
                                 PagedServingEngine, PoolExhausted, Request,
                                 RequestStatus, ServingEngine)
from torch_parity import port_model, rng, smoke, t, to_np

ATTN_TOL = 2e-5
LOGIT_ATOL = 0.15          # tests/test_torch_model.py
MARGIN = 2 * LOGIT_ATOL
EMPTY = 2 ** 30


class _NoCacheModel:
    def init_paged_cache(self, *a, **kw):
        return []


# ---------------------------------------------------------------------------
# (a) allocator and block tables, step for step against the reference
# ---------------------------------------------------------------------------
def _same_allocator(a, j):
    assert a._free == j._free
    np.testing.assert_array_equal(a._ref, j._ref)
    assert (a.n_free, a.n_used) == (j.n_free, j.n_used)
    a.check()
    j.check()


@pytest.mark.parametrize("num_blocks", [2, 5, 17, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_allocator_matches_reference(num_blocks, seed):
    r = np.random.default_rng((num_blocks, seed))
    a, j = BlockAllocator(num_blocks, 4), JAllocator(num_blocks, 4)
    held = []
    for _ in range(200):
        op = r.random()
        if held and op < 0.4:
            b = held.pop(int(r.integers(len(held))))
            a.free(b)
            j.free(b)
        elif held and op < 0.5:
            b = held[int(r.integers(len(held)))]
            a.retain(b)
            j.retain(b)
            held.append(b)
        else:
            try:
                b = a.alloc()
            except PoolExhausted:
                with pytest.raises(JPoolExhausted):
                    j.alloc()
                assert a.n_free == 0
                continue
            assert j.alloc() == b and b != 0
            held.append(b)
        _same_allocator(a, j)
    for b in held:
        a.free(b)
        j.free(b)
    _same_allocator(a, j)
    assert a.n_free == num_blocks - 1


@pytest.mark.parametrize("n_slots", [1, 3, 4])
@pytest.mark.parametrize("tight", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_paged_cache_matches_reference(n_slots, tight, seed):
    """Random grow/release/failed-grow sequences: ensure is atomic (a
    PoolExhausted grow changes nothing) and the port's tables, per-slot
    block counts and free list equal the reference's at every step."""
    nbk = 1 + n_slots * 3 if tight else None
    a = PagedKVCache(_NoCacheModel(), n_slots, max_len=32, block_size=4,
                     num_blocks=nbk)
    j = JPagedKVCache(_NoCacheModel(), n_slots, max_len=32, block_size=4,
                      num_blocks=nbk)
    r = np.random.default_rng((n_slots, seed, tight))
    tokens_of = np.zeros(n_slots, int)
    for _ in range(150):
        slot = int(r.integers(n_slots))
        if r.random() < 0.5:
            want = tokens_of[slot] + int(r.integers(1, 9))
            before = (a.allocator.n_free, a.tables[slot].copy())
            try:
                new = a.ensure(slot, want)
            except PoolExhausted:
                with pytest.raises(JPoolExhausted):
                    j.ensure(slot, want)
                assert a.allocator.n_free == before[0]
                np.testing.assert_array_equal(a.tables[slot], before[1])
            else:
                assert j.ensure(slot, want) == new
                tokens_of[slot] = want
        else:
            assert a.release(slot) == j.release(slot)
            tokens_of[slot] = 0
        np.testing.assert_array_equal(a.tables, j.tables)
        np.testing.assert_array_equal(a.n_blocks_of, j.n_blocks_of)
        _same_allocator(a.allocator, j.allocator)
        live = [b for row in a.tables for b in row if b != 0]
        assert len(set(live)) == len(live) == a.allocator.n_used
        assert a.utilization() == j.utilization()
    for slot in range(n_slots):
        a.release(slot)
    assert a.allocator.n_used == 0 and (a.tables == 0).all()


def test_allocator_errors():
    alloc = BlockAllocator(4, block_size=2)
    b = alloc.alloc()
    alloc.free(b)
    with pytest.raises(ValueError, match="double free"):
        alloc.free(b)
    with pytest.raises(ValueError, match="invalid block"):
        alloc.free(0)
    with pytest.raises(ValueError, match="invalid block"):
        alloc.free(99)
    with pytest.raises(ValueError):
        BlockAllocator(1, 4)
    pc = PagedKVCache(_NoCacheModel(), 2, max_len=16, block_size=4)
    with pytest.raises(PoolExhausted, match="table"):
        pc.ensure(0, 17)                 # 5 blocks > max_blocks = 4
    assert pc.allocator.n_used == 0 and pc.capacity_tokens == 16


# ---------------------------------------------------------------------------
# (b) pool writes and gathers, exactly as the reference's
# ---------------------------------------------------------------------------
def _tables(r, B, nb, NB):
    """Tables of distinct blocks with null tails; row 2 is all null."""
    ids = r.permutation(np.arange(1, NB))
    tables = np.zeros((B, nb), np.int32)
    i = 0
    for b, n in enumerate([nb, nb - 2, 0, 1][:B]):
        tables[b, :n] = ids[i:i + n]
        i += n
    return tables


@pytest.mark.parametrize("S", [1, 5, 12])
@pytest.mark.parametrize("kind", ["int8", "f32", "pos", "scale"])
def test_paged_update_matches_reference(S, kind):
    r = rng(40 + S)
    B, nb, bs, KH, D = 4, 4, 4, 2, 3
    NB = 1 + B * nb
    tail = {"int8": (KH, D), "f32": (KH, D), "pos": (), "scale": (KH,)}[kind]
    if kind == "int8":
        pool = r.integers(-127, 128, (NB, bs) + tail).astype(np.int8)
        new = r.integers(-127, 128, (B, S) + tail).astype(np.int8)
    elif kind == "pos":
        pool = r.integers(0, 99, (NB, bs)).astype(np.int32)
        new = r.integers(0, 99, (B, S)).astype(np.int32)
    else:
        pool = r.standard_normal((NB, bs) + tail).astype(np.float32)
        new = r.standard_normal((B, S) + tail).astype(np.float32)
    tables = _tables(r, B, nb, NB)
    # a running row, one starting mid-block, a sentinel-index row and a
    # row writing past its allocated blocks into null entries
    idx = np.array([0, 3, EMPTY, 2], np.int32)
    valid = np.array([S, max(S - 2, 0), S, S], np.int32)
    want = jattn._paged_update(jnp.asarray(pool), jnp.asarray(new),
                               jnp.asarray(tables), jnp.asarray(idx),
                               jnp.asarray(valid))
    got = t(pool)
    tattn._paged_update(got, t(new), t(tables), t(idx), t(valid))
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    np.testing.assert_array_equal(to_np(got)[0], pool[0])     # null block
    want_nv = jattn._paged_update(jnp.asarray(pool), jnp.asarray(new),
                                  jnp.asarray(tables), jnp.asarray(idx))
    got = t(pool)
    tattn._paged_update(got, t(new), t(tables), t(idx))
    np.testing.assert_array_equal(to_np(got), np.asarray(want_nv))
    # the gather reads through the same tables
    np.testing.assert_array_equal(
        to_np(tattn._gather_paged(got, t(tables))),
        np.asarray(jattn._gather_paged(want_nv, jnp.asarray(tables))))


# ---------------------------------------------------------------------------
# (c) the plain paged decode
# ---------------------------------------------------------------------------
def _ring_and_pages(B, S, KH, G, D, bs, seed, int8=False, lengths=None):
    """Equivalent ring and paged caches (numpy): the pools hold a seeded
    permutation of blocks, block 0 is the null block, and rows shorter
    than S keep their tail table entries null."""
    r = np.random.default_rng(seed)
    nb = S // bs
    q = r.normal(size=(B, KH, G, D)).astype(np.float32)
    k = r.normal(size=(B, S, KH, D)).astype(np.float32)
    v = r.normal(size=(B, S, KH, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    lengths = lengths or [S] * B
    for b, L in enumerate(lengths):
        pos[b, L:] = EMPTY
        k[b, L:] = 0.0
        v[b, L:] = 0.0
    q_pos = np.asarray([max(L - 1, 0) for L in lengths], np.int32)
    ring = dict(k=k, v=v, pos=pos)
    if int8:
        kq, ks = jattn._quantize_kv(jnp.asarray(k))
        vq, vs = jattn._quantize_kv(jnp.asarray(v))
        ring.update(k=np.asarray(kq), v=np.asarray(vq), k_scale=np.asarray(ks),
                    v_scale=np.asarray(vs))
    NB = 1 + B * nb
    perm = r.permutation(np.arange(1, NB))
    tables = np.zeros((B, nb), np.int32)
    paged = {}
    for name, a in ring.items():
        pool = np.zeros((NB, bs) + a.shape[2:], a.dtype)
        if name == "pos":
            pool[:] = EMPTY
        paged[name] = pool
    i = 0
    for b, L in enumerate(lengths):
        for lb in range(-(-L // bs)):
            p = int(perm[i])
            i += 1
            tables[b, lb] = p
            for name, a in ring.items():
                paged[name][p] = a[b, lb * bs:(lb + 1) * bs]
    return q, q_pos, ring, paged, tables


def _paged_args(q, q_pos, paged, tables, conv):
    return (conv(q), conv(paged["k"]), conv(paged["v"]), conv(paged["pos"]),
            conv(tables), conv(q_pos),
            None if "k_scale" not in paged else conv(paged["k_scale"]),
            None if "v_scale" not in paged else conv(paged["v_scale"]))


CASES = {
    # name: (B, S, KH, G, bs, seed, int8, lengths, window)
    "fp_mqa": (3, 32, 2, 1, 8, 0, False, [32, 17, 9], None),
    "fp_gqa": (3, 32, 2, 4, 8, 0, False, [32, 17, 9], None),
    "sliding": (2, 32, 2, 2, 8, 1, False, [32, 21], 7),
    "straddle15": (3, 64, 2, 2, 8, 5, False, [64, 41, 26], 15),
    "straddle17": (3, 64, 2, 2, 8, 5, False, [64, 41, 26], 17),
    "straddle24": (3, 64, 2, 2, 8, 5, False, [64, 41, 26], 24),
    "null_tail": (3, 48, 2, 2, 8, 6, False, [48, 19, 9], 15),
    "int8_window": (2, 32, 2, 4, 8, 7, True, [32, 21], 17),
    "int8": (3, 32, 2, 4, 8, 2, True, [32, 13, 24], None),
    "all_empty": (2, 16, 2, 2, 8, 3, False, [16, 0], None),
    "single_token": (2, 16, 2, 2, 8, 4, False, [1, 16], None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_paged_plain_matches_jax(name):
    B, S, KH, G, bs, seed, int8, lengths, window = CASES[name]
    q, q_pos, ring, paged, tables = _ring_and_pages(B, S, KH, G, 8, bs, seed,
                                                    int8, lengths)
    jq, jk, jv, jpos, jbt, jqp, jks, jvs = _paged_args(q, q_pos, paged,
                                                       tables, jnp.asarray)
    want = jops.decode_attention_paged(jq, jk, jv, jpos, jbt, jqp,
                                       k_scale_pages=jks, v_scale_pages=jvs,
                                       window=window, interpret=True)
    oracle = jref.decode_attention_paged_ref(jq, jk, jv, jpos, jbt, jqp,
                                             window=window,
                                             k_scale_pages=jks,
                                             v_scale_pages=jvs)
    targs = _paged_args(q, q_pos, paged, tables, t)
    got = ops.decode_attention_paged(*targs[:6], k_scale_pages=targs[6],
                                     v_scale_pages=targs[7], window=window)
    assert np.isfinite(to_np(got)).all()
    scale = max(float(np.abs(np.asarray(oracle)).max()), 1e-30)
    for ref in (want, oracle):
        np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=0,
                                   atol=ATTN_TOL * scale)
    # the port's ring version on the equivalent layout gives the same bits
    ring_out = ops.decode_attention(
        t(q), t(ring["k"]), t(ring["v"]), t(ring["pos"]), t(q_pos),
        None if not int8 else t(ring["k_scale"]),
        None if not int8 else t(ring["v_scale"]), window=window)
    np.testing.assert_array_equal(to_np(got), to_np(ring_out))


# ---------------------------------------------------------------------------
# (d) the engine against a fresh JAX engine and the port's ring engine
# ---------------------------------------------------------------------------
PROMPT_LENS = (3, 17, 9, 30, 5)


def _prompts():
    r = rng(41)
    return [r.integers(0, 256, n).astype(np.int32) for n in PROMPT_LENS]


# one slot per request and a roomy pool: no block is freed and reused
# before the last request ends
ENGINE_KW = dict(n_slots=5, max_len=64, prefill_bucket=16, block_size=8,
                 prefill_chunk=8)


def _serve_jax(jplan):
    _, jm, params = smoke()
    eng = JPagedEngine(jm, params, quant_plan=jplan, **ENGINE_KW)
    margins = {}
    sample = eng._sample

    def recording(req, logits, step):
        top = np.sort(np.asarray(logits, np.float64))[-2:]
        margins[(req.uid, step)] = top[1] - top[0]
        return sample(req, logits, step)
    eng._sample = recording
    reqs = [JRequest(uid=i, prompt=p, max_new_tokens=8)
            for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    return reqs, margins


def _serve_port(engine_cls, plan, **kw):
    eng = engine_cls(port_model(), quant_plan=plan, **kw)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=8)
            for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    return eng, reqs


@pytest.mark.parametrize("name,jplan,plan", [
    ("full", JPlan.full(), QuantPlan.full()), ("none", None, None)])
def test_greedy_tokens_match_fresh_jax_paged_engine(name, jplan, plan):
    jreqs, margins = _serve_jax(jplan)
    eng, reqs = _serve_port(PagedServingEngine, plan, **ENGINE_KW)
    assert all(r.status is RequestStatus.OK for r in reqs)
    assert all(r.status.value == "ok" for r in jreqs)
    compared = total = 0
    for jr, r in zip(jreqs, reqs):
        assert len(r.generated) == len(jr.generated) == 8
        for step, (a, b) in enumerate(zip(jr.generated, r.generated)):
            total += 1
            if margins[(jr.uid, step)] <= MARGIN:
                break
            assert a == b, (name, jr.uid, step, jr.generated, r.generated)
            compared += 1
    assert compared >= total // 2, (compared, total)
    assert eng.stats.prefills == 5
    assert eng.stats.prefill_chunks == sum(-(-n // 8) for n in PROMPT_LENS)
    eng.paged.allocator.check()
    assert eng.paged.allocator.n_used == 0
    # the same requests on the port's ring engine give the same tokens
    _, ring = _serve_port(ServingEngine, plan, n_slots=3, max_len=64,
                          prefill_bucket=16)
    assert [r.generated for r in ring] == [r.generated for r in reqs]


# ---------------------------------------------------------------------------
# (e) the reference's engine pins, on the port
# ---------------------------------------------------------------------------
def _engine(**kw):
    for k, v in dict(n_slots=4, max_len=64, prefill_bucket=16,
                     block_size=8).items():
        kw.setdefault(k, v)
    return PagedServingEngine(port_model(), **kw)


def _requests(n, seed=0, out=4, max_prompt=20):
    r = np.random.default_rng(seed)
    return [Request(uid=i, prompt=r.integers(1, 256, int(
        r.integers(1, max_prompt))).astype(np.int32), max_new_tokens=out)
        for i in range(n)]


def _run(eng, reqs, max_iters=2000):
    for r in reqs:
        eng.submit(r)
    eng.run_until_done(max_iters=max_iters)
    return [r.generated for r in reqs]


def test_continuous_batching_drains_pool():
    eng = _engine(quant_plan=QuantPlan.full())
    assert eng.kv_dtype == "int8"
    assert all("k_scale_pages" in c for c in eng.cache)
    # every layer reads the one device table tensor
    assert len({c["block_tables"].data_ptr() for c in eng.cache}) == 1
    reqs = _requests(6, out=5)
    _run(eng, reqs)
    assert all(r.status is RequestStatus.OK and len(r.generated) == 5
               for r in reqs)
    eng.paged.allocator.check()
    assert eng.paged.allocator.n_used == 0 and (eng.paged.tables == 0).all()
    assert eng.stats.prefill_chunks >= eng.stats.prefills == 6
    assert len(eng.stats.cache_utilization) >= eng.stats.decode_steps > 0


def test_greedy_matches_stepwise_forward():
    """Paged greedy decode == argmax of a full forward over the whole
    sequence at every step."""
    prompt = np.array([5, 9, 2, 7], np.int32)
    eng = _engine(prefill_chunk=4)
    req = Request(uid=0, prompt=prompt, max_new_tokens=5)
    _run(eng, [req])
    toks = list(prompt)
    with torch.no_grad():
        for _ in range(5):
            logits = eng.model.forward(torch.tensor([toks]))
            toks.append(int(logits[0, -1].argmax()))
    assert req.generated == toks[len(prompt):]


def test_chunked_prefill_matches_single_chunk():
    prompt = np.arange(1, 14, dtype=np.int32)                  # 13 tokens
    gens = [_run(_engine(prefill_chunk=c),
                 [Request(uid=0, prompt=prompt, max_new_tokens=6)])[0]
            for c in (16, 4)]
    assert gens[0] == gens[1]


def test_chunked_prefill_interleaves_with_decode():
    eng = _engine(prefill_chunk=4)
    a = Request(uid=0, prompt=np.array([3, 1, 4], np.int32),
                max_new_tokens=12)
    eng.submit(a)
    eng.step()                               # a prefills and decodes
    b = Request(uid=1, prompt=np.arange(1, 17, dtype=np.int32),
                max_new_tokens=2)
    eng.submit(b)
    before = len(a.generated)
    eng.step()                               # b's first chunk, a decodes
    assert len(a.generated) == before + 1 and not b.generated
    eng.run_until_done(max_iters=60)
    assert a.ok and len(a.generated) == 12
    assert b.ok and len(b.generated) == 2


def test_decode_leaves_other_rows_untouched():
    """A decode step masks the write index of rows that do not decode:
    a mid-prefill row's blocks and index come through unchanged."""
    eng = _engine(prefill_chunk=4, quant_plan=QuantPlan.full())
    a = Request(uid=0, prompt=np.array([3, 1, 4], np.int32),
                max_new_tokens=8)
    eng.submit(a)
    eng.step()
    b = Request(uid=1, prompt=np.arange(1, 17, dtype=np.int32),
                max_new_tokens=2)
    eng.submit(b)
    eng.step()                               # b: chunk 1 of 4
    blocks = [int(x) for x in eng.paged.tables[1] if x]
    snap = [{k: v[blocks].clone() for k, v in c.items()
             if k.endswith("_pages")} for c in eng.cache]
    eng._ensure(0, int(eng.slot_pos[0]) + 1)
    mask = np.array([True, False, False, False])
    eng._decode_masked(eng.slot_last, mask)
    for c, s in zip(eng.cache, snap):
        for k, v in s.items():
            assert torch.equal(c[k][blocks], v), k
        assert int(c["index"][1]) >= EMPTY


def test_preemption_resumes_bitwise_greedy():
    """Under a tight pool the youngest sequence is evicted and resumed by
    recompute; greedy tokens equal a roomy pool's and the pool drains."""
    runs = []
    for num_blocks in (9, None):             # 8 allocatable vs roomy
        eng = _engine(num_blocks=num_blocks, prefill_chunk=8)
        gens = _run(eng, _requests(6, seed=1, out=6))
        eng.paged.allocator.check()
        assert eng.paged.allocator.n_used == 0
        assert eng.stats.completed == 6
        runs.append((eng, gens))
    (tight, tg), (roomy, rg) = runs
    assert tight.stats.preemptions >= 1 and tight.stats.evicted_blocks >= 1
    assert roomy.stats.preemptions == 0
    assert tg == rg


def test_freed_blocks_reused_clean():
    """After a drain/refill cycle the reused blocks generate what a fresh
    engine generates (the release-time position scrub); the reference's
    own pin of this fails on this jax (ROADMAP C.1)."""
    r = np.random.default_rng(3)
    prompt_a = r.integers(1, 256, 11).astype(np.int32)
    prompt_b = r.integers(1, 256, 9).astype(np.int32)
    eng = _engine(n_slots=1, prefill_chunk=8)
    _run(eng, [Request(uid=0, prompt=prompt_a, max_new_tokens=6)])
    reused = _run(eng, [Request(uid=1, prompt=prompt_b, max_new_tokens=6)])
    fresh = _run(_engine(n_slots=1, prefill_chunk=8),
                 [Request(uid=1, prompt=prompt_b, max_new_tokens=6)])
    assert reused == fresh
    # the scrub reset every freed block's positions in every layer
    assert all(bool((c["pos_pages"][1:] == EMPTY).all()) for c in eng.cache)


def test_sole_sequence_pool_exhaustion_fails_not_stalls():
    eng = _engine(n_slots=1, num_blocks=3, prefill_chunk=8)
    req = Request(uid=0, prompt=np.ones(12, np.int32), max_new_tokens=32)
    _run(eng, [req], max_iters=100)
    assert req.status is RequestStatus.FAILED
    assert "pool exhausted" in req.error
    assert eng.stats.pool_exhaustions >= 1
    eng.paged.allocator.check()
    assert eng.paged.allocator.n_used == 0


def test_expiry_and_shutdown_release_blocks():
    now = [0.0]
    eng = _engine(clock=lambda: now[0])
    live = Request(uid=0, prompt=np.ones(9, np.int32), max_new_tokens=64,
                   deadline_s=5.0)
    eng.submit(live)
    eng.step()
    assert eng.paged.allocator.n_used > 0
    now[0] = 10.0
    eng.step()
    assert live.status is RequestStatus.TIMED_OUT
    assert eng.paged.allocator.n_used == 0
    eng.submit(Request(uid=1, prompt=np.ones(4, np.int32),
                       max_new_tokens=64))
    eng.step()
    assert eng.paged.allocator.n_used > 0
    eng.shutdown(drain=False)
    assert eng.paged.allocator.n_used == 0
    eng.paged.allocator.check()


def test_block_granular_submit_bounds():
    eng = _engine()                          # 8 blocks x 8 = 64 positions
    cap = eng.paged.capacity_tokens
    assert cap == 64
    with pytest.raises(ValueError, match="block table"):
        eng.submit(Request(uid=0, prompt=np.ones(cap, np.int32)))
    ok = Request(uid=1, prompt=np.ones(cap - 1, np.int32), max_new_tokens=1)
    _run(eng, [ok], max_iters=80)
    assert ok.status is RequestStatus.OK
    with pytest.raises(ValueError, match="empty"):
        eng.submit(Request(uid=2, prompt=np.zeros(0, np.int32)))
    with pytest.raises(ValueError):
        _engine(prefill_chunk=0)


def test_ring_engine_frees_slots_through_clear_slot():
    """Every terminal path of the ring engine frees its slot through the
    ``_clear_slot`` hook the paged engine overrides."""
    class Counting(ServingEngine):
        cleared = 0

        def _clear_slot(self, slot):
            Counting.cleared += 1
            super()._clear_slot(slot)
    eng = Counting(port_model(), n_slots=2, max_len=32, prefill_bucket=8)
    _run(eng, _requests(3, out=2, max_prompt=8))
    assert Counting.cleared == 3
    eng.submit(Request(uid=9, prompt=np.ones(3, np.int32),
                       max_new_tokens=9))
    eng.step()
    eng.shutdown(drain=False)
    assert Counting.cleared == 4


def test_cpu_paged_engine_launches_nothing():
    before = launch_counts()
    _run(_engine(quant_plan=QuantPlan.full()), _requests(2, out=2))
    assert launch_counts() == before
