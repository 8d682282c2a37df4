"""The port's CUDA kernels against their plain versions, on the card.

Imports only torch and numpy, so it runs on a GPU host without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a CUDA device every test skips.  Shapes are small and ragged
(rows, columns and K not multiples of the kernels' tiles) to reach the
edge masks that the gemma-2b shapes of ``chip_smoke.py`` never touch.
Tolerances: integer outputs and epilogues without an activation are
bitwise (the int32 accumulator is exact and the epilogue rounds in the
plain version's order); activations allow 1e-5 relative (tanh/exp may
differ by an ulp); requantized activations may move one int8 step at a
rounding tie.  Attention is held against the plain version computed in
f32 and rounded to q's dtype, element by element: 2**-7 of the element
(one bf16 ulp at a rounding boundary; 1e-5 for f32 output) plus a share
of its own query row's largest |out| (1e-3, for f32 summation order;
2**-7 on a bf16 cache, whose probabilities the kernel rounds to bf16 as
the reference does and the f32 oracle does not).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import cim_gemm as cg
from repro_torch.kernels import decode_attention as da

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (hand-written CUDA kernels)")
    return torch.device("cuda")


def _gen(seed):
    return np.random.default_rng(seed)


def _t(a, dev, dtype=None):
    t = torch.as_tensor(np.ascontiguousarray(a), device=dev)
    return t if dtype is None else t.to(dtype)


def _w(rng, K, N, dev):
    return (_t(rng.integers(-127, 128, (K, N)).astype(np.int8), dev),
            _t(rng.uniform(1e-3, 2e-2, N).astype(np.float32), dev))


@pytest.mark.parametrize("M,K,dtype", [(3, 70, torch.float32),
                                       (5, 2048, torch.bfloat16),
                                       (2, 16384, torch.float32)])
def test_rowquant_bitwise(dev, M, K, dtype):
    x = _t(_gen(0).standard_normal((M, K)).astype(np.float32), dev, dtype)
    before = cg.quantize_rows_int8.launches
    q, s = cg.quantize_rows_int8(x)
    qr, sr = cg.quantize_rows_int8_plain(x)
    torch.cuda.synchronize()
    assert cg.quantize_rows_int8.launches == before + 1
    assert torch.equal(q, qr) and torch.equal(s, sr)


@pytest.mark.parametrize("M,K,N", [(1, 64, 96), (13, 100, 36),
                                   (8, 2048, 2560), (70, 1030, 68)])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_qin_bitwise_without_activation(dev, M, K, N, xdtype):
    rng = _gen(1)
    x = _t(rng.standard_normal((M, K)).astype(np.float32), dev, xdtype)
    w, ws = _w(rng, K, N, dev)
    b = _t(rng.standard_normal(N).astype(np.float32), dev)
    r = _t(rng.standard_normal((M, N)).astype(np.float32), dev, xdtype)
    for bias, res in ((None, None), (b, r)):
        out = cg.cim_gemm_int8_fused_qin(x, w, ws, bias=bias, residual=res)
        ref = cg.cim_gemm_int8_fused_qin_plain(x, w, ws, bias, res)
        torch.cuda.synchronize()
        assert torch.equal(out, ref)


@pytest.mark.parametrize("act", ["gelu", "silu", "relu"])
def test_qin_activation_close(dev, act):
    rng = _gen(2)
    x = _t(rng.standard_normal((9, 300)).astype(np.float32), dev)
    w, ws = _w(rng, 300, 100, dev)
    b = _t(rng.standard_normal(100).astype(np.float32), dev)
    out = cg.cim_gemm_int8_fused_qin(x, w, ws, bias=b, activation=act)
    ref = cg.cim_gemm_int8_fused_qin_plain(x, w, ws, b, None, act)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("M,K,N", [(8, 16384, 2048), (3, 1000, 40),
                                   (33, 64, 4)])
def test_fused_bitwise(dev, M, K, N):
    rng = _gen(3)
    xq = _t(rng.integers(-127, 128, (M, K)).astype(np.int8), dev)
    xs = _t(rng.uniform(1e-3, 1e-1, (M, 1)).astype(np.float32), dev)
    w, ws = _w(rng, K, N, dev)
    r = _t(rng.standard_normal((M, N)).astype(np.float32), dev,
           torch.bfloat16)
    out = cg.cim_gemm_int8_fused(xq, w, xs, ws, residual=r)
    ref = cg.cim_gemm_int8_fused_plain(xq, w, xs, ws, None, r)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    q, s = cg.cim_gemm_int8_fused(xq, w, xs, ws, quantize_out=True)
    qr, sr = cg.quantize_rows_int8_plain(
        cg.cim_gemm_int8_fused_plain(xq, w, xs, ws))
    assert torch.equal(q, qr) and torch.equal(s, sr)


@pytest.mark.parametrize("M,K,N", [(8, 2048, 512), (5, 136, 20)])
def test_gated_close(dev, M, K, N):
    rng = _gen(4)
    xq = _t(rng.integers(-127, 128, (M, K)).astype(np.int8), dev)
    xs = _t(rng.uniform(1e-3, 1e-2, (M, 1)).astype(np.float32), dev)
    wg, gs = _w(rng, K, N, dev)
    wu, us = _w(rng, K, N, dev)
    h = cg.cim_gated_gemm_int8(xq, wg, wu, xs, gs, us, "gelu")
    hr = cg.cim_gated_gemm_int8_plain(xq, wg, wu, xs, gs, us, "gelu")
    torch.testing.assert_close(h, hr, rtol=1e-5, atol=1e-6)
    q, s = cg.cim_gated_gemm_int8(xq, wg, wu, xs, gs, us, "gelu",
                                  quantize_out=True)
    qr, sr = cg.quantize_rows_int8_plain(hr)
    assert (q.int() - qr.int()).abs().max().item() <= 1
    torch.testing.assert_close(s, sr, rtol=1e-5, atol=0)
    # the in-kernel requant is the row quantizer of the kernel's own h
    qk, sk = cg.quantize_rows_int8_plain(h)
    assert torch.equal(q, qk) and torch.equal(s, sk)


def _cache(rng, B, S, KH, D, quantized, dev, fill, dtype):
    if quantized:
        k = _t(rng.integers(-127, 128, (B, S, KH, D)).astype(np.int8), dev)
        v = _t(rng.integers(-127, 128, (B, S, KH, D)).astype(np.int8), dev)
        ks = _t(rng.uniform(1e-3, 2e-2, (B, S, KH)).astype(np.float32), dev)
        vs = _t(rng.uniform(1e-3, 2e-2, (B, S, KH)).astype(np.float32), dev)
    else:
        k = _t(rng.standard_normal((B, S, KH, D)).astype(np.float32), dev,
               dtype)
        v = _t(rng.standard_normal((B, S, KH, D)).astype(np.float32), dev,
               dtype)
        ks = vs = None
    pos = np.full((B, S), 2 ** 30, np.int32)
    for b in range(B):
        n = fill[b]
        pos[b, :n] = rng.permutation(n)
    return k, v, ks, vs, _t(pos, dev)


@pytest.mark.parametrize("qdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("B,S,KH,G,D,window", [
    (2, 100, 1, 8, 256, None), (3, 70, 2, 4, 16, None),
    (2, 130, 1, 1, 64, 8), (8, 1024, 1, 8, 256, None)])
def test_decode_attention_close(dev, qdtype, quantized, B, S, KH, G, D,
                                window):
    rng = _gen(5)
    fill = [int(rng.integers(1, S + 1)) for _ in range(B)]
    fill[0] = 0                                   # an all-empty row
    k, v, ks, vs, pos = _cache(rng, B, S, KH, D, quantized, dev, fill,
                               qdtype)
    q = _t(rng.standard_normal((B, KH, G, D)).astype(np.float32), dev,
           qdtype)
    qp = _t(np.array([max(f - 1, 0) for f in fill], np.int32), dev)
    out = da.decode_attention(q, k, v, pos, qp, ks, vs, window=window)
    wide = (lambda t: t) if quantized else (lambda t: t.float())
    ref = da.decode_attention_plain(q.float(), wide(k), wide(v), pos, qp, ks,
                                    vs, window=window).to(q.dtype).float()
    assert out.dtype == q.dtype and out.shape == q.shape
    rtol = 2 ** -7 if qdtype == torch.bfloat16 else 1e-5
    row = 2 ** -7 if k.dtype == torch.bfloat16 else 1e-3
    limit = rtol * ref.abs() + row * ref.abs().amax(-1, keepdim=True)
    err = (out.float() - ref).abs()
    assert bool((err <= limit).all()), (err / limit).max().item()


def _attn_limit(ref, qdtype, kvdtype):
    """The decode-attention rule above: 2**-7 of the element on bf16
    output (1e-5 on f32) plus a share of its query row's largest |out|
    (1e-3; 2**-7 on a bf16 cache)."""
    rtol = 2 ** -7 if qdtype == torch.bfloat16 else 1e-5
    row = 2 ** -7 if kvdtype == torch.bfloat16 else 1e-3
    return rtol * ref.abs() + row * ref.abs().amax(-1, keepdim=True)


def _ring_case(dev, seed, B, S, KH, G, D, quantized, qdtype):
    rng = _gen(seed)
    fill = [int(rng.integers(1, S + 1)) for _ in range(B)]
    fill[0] = 0                                   # an all-empty row
    if B > 2:
        fill[1] = 1                               # a single-token row
    k, v, ks, vs, pos = _cache(rng, B, S, KH, D, quantized, dev, fill,
                               qdtype)
    q = _t(rng.standard_normal((B, KH, G, D)).astype(np.float32), dev,
           qdtype)
    qp = _t(np.array([max(f - 1, 0) for f in fill], np.int32), dev)
    return q, k, v, pos, qp, ks, vs


def _to_pages(seed, bs, k, v, pos, ks, vs):
    """The paged layout of a ring cache: blocks holding a position go to
    shuffled pool blocks, the others to the null block 0; the ring's
    copies of those null blocks are zeroed, so both layouts hold one
    logical cache."""
    B, S = pos.shape
    nb = S // bs
    dev = pos.device
    used = (pos.reshape(B, nb, bs) != 2 ** 30).any(-1)
    NB = 1 + B * nb
    ids = torch.as_tensor(_gen(seed).permutation(np.arange(1, NB)),
                          dtype=torch.int32, device=dev)
    tables = torch.zeros((B, nb), dtype=torch.int32, device=dev)
    tables[used] = ids[:int(used.sum())]
    null = ~used.repeat_interleave(bs, 1)                    # [B, S]
    pages = []
    for a, fill in ((k, 0), (v, 0), (pos, 2 ** 30), (ks, 0), (vs, 0)):
        if a is None:
            pages.append(None)
            continue
        a.masked_fill_(null.reshape(B, S, *[1] * (a.dim() - 2)), fill)
        pool = torch.full((NB, bs) + tuple(a.shape[2:]), fill,
                          dtype=a.dtype, device=dev)
        pool[tables[used].long()] = a.reshape(B, nb, bs, *a.shape[2:])[used]
        pages.append(pool)
    return tables, pages


PAGED_SHAPES = [(8, 1024, 1, 8, 256, 16, None), (3, 96, 2, 4, 16, 8, 7),
                (4, 128, 1, 1, 64, 32, None), (2, 192, 2, 16, 128, 64, 50)]


@pytest.mark.parametrize("qdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("B,S,KH,G,D,bs,window", PAGED_SHAPES)
def test_paged_bitwise_vs_ring_and_close_to_plain(dev, qdtype, quantized, B,
                                                  S, KH, G, D, bs, window):
    """The paged walk on shuffled blocks (one row all null) returns the
    ring walk's bits on the same logical cache, and agrees with its
    plain version by the decode-attention rule."""
    q, k, v, pos, qp, ks, vs = _ring_case(dev, 6, B, S, KH, G, D, quantized,
                                          qdtype)
    tables, (kp, vp, pp, ksp, vsp) = _to_pages(7, bs, k, v, pos, ks, vs)
    assert bool((tables[0] == 0).all())
    before = da.decode_attention_paged.launches
    paged = da.decode_attention_paged(q, kp, vp, pp, tables, qp, ksp, vsp,
                                      window=window)
    ring = da.decode_attention(q, k, v, pos, qp, ks, vs, window=window)
    torch.cuda.synchronize()
    assert da.decode_attention_paged.launches == before + 1
    assert torch.equal(paged, ring)
    wide = (lambda t: t) if quantized else (lambda t: t.float())
    ref = da.decode_attention_paged_plain(
        q.float(), wide(kp), wide(vp), pp, tables, qp, ksp, vsp,
        window=window).to(q.dtype).float()
    err = (paged.float() - ref).abs()
    limit = _attn_limit(ref, qdtype, kp.dtype)
    assert bool((err <= limit).all()), (err / limit).max().item()


SPLIT_SHAPES = [(8, 8192, 1, 8, 256, None), (3, 700, 2, 4, 16, None),
                (2, 4096, 1, 1, 64, 300), (4, 2500, 2, 16, 128, None)]


@pytest.mark.parametrize("qdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("B,S,KH,G,D,window", SPLIT_SHAPES)
def test_split_one_bitwise_and_more_close(dev, qdtype, quantized, B, S, KH,
                                          G, D, window):
    """Partial + combine at NS = 1 return the single walk's bits; at
    NS > 1 they agree with the plain split version (and the combine with
    its plain version on the kernel's partial states) by the
    decode-attention rule."""
    from repro_torch.kernels import ops
    q, k, v, pos, qp, ks, vs = _ring_case(dev, 8, B, S, KH, G, D, quantized,
                                          qdtype)
    one = da.decode_attention(q, k, v, pos, qp, ks, vs, window=window)
    p0, c0 = da.decode_attention_partial.launches, \
        da.decode_attention_combine.launches
    split1 = ops.decode_attention_splitkv(q, k, v, pos, qp, ks, vs,
                                          window=window, n_splits=1)
    torch.cuda.synchronize()
    assert da.decode_attention_partial.launches == p0 + 1
    assert da.decode_attention_combine.launches == c0 + 1
    assert torch.equal(split1, one)
    wide = (lambda t: t) if quantized else (lambda t: t.float())
    for ns in (2, 3, 4, 8):
        out = ops.decode_attention_splitkv(q, k, v, pos, qp, ks, vs,
                                           window=window, n_splits=ns)
        ref = ops.decode_attention_splitkv(
            q.float().cpu(), wide(k).cpu(), wide(v).cpu(), pos.cpu(),
            qp.cpu(), None if ks is None else ks.cpu(),
            None if vs is None else vs.cpu(), window=window,
            n_splits=ns).to(q.dtype).float().to(dev)
        err = (out.float() - ref).abs()
        limit = _attn_limit(ref, qdtype, k.dtype)
        assert bool((err <= limit).all()), (ns, (err / limit).max().item())
        o, m, l = da.decode_attention_partial(q, k, v, pos, qp, ks, vs,
                                              window=window, n_splits=ns)
        got = da.decode_attention_combine(o, m, l, q.dtype).float()
        ref = da.decode_attention_combine_plain(o, m, l, q.dtype).float()
        err = (got - ref).abs()
        limit = _attn_limit(ref, qdtype, torch.float32)
        assert bool((err <= limit).all()), (ns, (err / limit).max().item())


def test_decode_wrappers_reject_bad_tables_and_dtypes(dev):
    q, k, v, pos, qp, ks, vs = _ring_case(dev, 9, 2, 64, 1, 2, 16, True,
                                          torch.float32)
    tables, (kp, vp, pp, ksp, vsp) = _to_pages(10, 16, k, v, pos, ks, vs)
    ok = (q, kp, vp, pp, tables, qp, ksp, vsp)
    da.decode_attention_paged(*ok)
    bad = [
        (TypeError, dict(tables=tables.long())),
        (ValueError, dict(tables=tables[:1])),
        (ValueError, dict(tables=tables.t().contiguous().t())),
        (TypeError, dict(ksp=None, vsp=None)),             # int8 unscaled
        (TypeError, dict(q=q.half())),
        (ValueError, dict(pp=pp[:, :8].contiguous())),
        (ValueError, dict(tables=tables.cpu())),           # device mix
    ]
    names = ("q", "kp", "vp", "pp", "tables", "qp", "ksp", "vsp")
    for exc, change in bad:
        args = dict(zip(names, ok), **change)
        with pytest.raises(exc):
            da.decode_attention_paged(*(args[n] for n in names))
    with pytest.raises(TypeError):
        da.decode_attention_partial(q, k, v, pos, qp, ks.double(), vs)
    with pytest.raises(ValueError):
        da.decode_attention_partial(q, k, v, pos, qp, ks, vs, n_splits=0)
    o, m, l = da.decode_attention_partial(q, k, v, pos, qp, ks, vs)
    with pytest.raises(ValueError):
        da.decode_attention_combine(o, m[:, :, :1].contiguous(), l,
                                    torch.float32)
    with pytest.raises(TypeError):
        da.decode_attention_combine(o, m, l, torch.float16)


def test_wrappers_reject_bad_inputs(dev):
    x = torch.zeros((4, 64), device=dev)
    w = torch.zeros((64, 6), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        cg.cim_gemm_int8_fused_qin(x, w, torch.ones(6, device=dev))
    with pytest.raises(TypeError):
        cg.quantize_rows_int8(torch.zeros((4, 64), dtype=torch.float16,
                                          device=dev))


def test_reduced_engine_on_card(dev):
    """The reduced config serves on the card through the ring path's five
    kernels and no other (its d_ff of 128 takes the gated GEMM's
    quantize_out branch; 64 slots take the single walk), and its
    greedy tokens agree with the plain path's on at least 90% of steps
    (an ulp of GELU can flip a near tie of the random-weight logits)."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import Model
    from repro_torch.quant import QuantPlan, kernel_mode
    from repro_torch.serving import Request, RequestStatus, ServingEngine

    cfg = reduced_config(get_config("gemma-2b"))
    prompts = [np.arange(1, n + 1, dtype=np.int32) * 7 % 256
               for n in (3, 17, 30)]

    def serve(plain):
        eng = ServingEngine(Model(cfg).init(0, device=dev), n_slots=2,
                            max_len=64, prefill_bucket=16,
                            quant_plan=QuantPlan.full())
        reqs = [Request(uid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        with kernel_mode(False if plain else None):
            eng.run_until_done()
        return reqs

    reset_launch_counts()
    kern = serve(plain=False)
    counts = launch_counts()
    plain = serve(plain=True)
    assert launch_counts() == counts
    ring = ("quantize_rows_int8", "cim_gemm_int8_fused_qin",
            "cim_gemm_int8_fused", "cim_gated_gemm_int8", "decode_attention")
    assert all(counts[k] > 0 for k in ring), counts
    assert sum(counts.values()) == sum(counts[k] for k in ring), counts
    assert all(r.status is RequestStatus.OK for r in kern + plain)
    agree = sum(a == b for ka, pa in zip(kern, plain)
                for a, b in zip(ka.generated, pa.generated))
    assert agree >= 0.9 * sum(len(r.generated) for r in plain)


def test_reduced_paged_engine_on_card(dev):
    """The reduced config serves on the card through the paged engine
    (paged attention, tight pool, preemption) and through the ring engine
    at 4096 slots (split attention); greedy tokens agree with the plain
    path on at least 90% of steps, every request ends OK, the pool
    drains, and each engine's attention kernel was launched."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import Model
    from repro_torch.quant import QuantPlan, kernel_mode
    from repro_torch.serving import (PagedServingEngine, Request,
                                     RequestStatus, ServingEngine)

    cfg = reduced_config(get_config("gemma-2b"))
    prompts = [np.arange(1, n + 1, dtype=np.int32) * 7 % 256
               for n in (3, 17, 30, 9, 12)]
    model = Model(cfg).init(0, device=dev).quantize(QuantPlan.full())

    def serve(make, plain):
        eng = make()
        reqs = [Request(uid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        with kernel_mode(False if plain else None):
            eng.run_until_done()
        return eng, reqs

    engines = {
        "decode_attention_paged": lambda: PagedServingEngine(
            model, n_slots=3, max_len=64, prefill_bucket=16, block_size=8,
            num_blocks=7, prefill_chunk=8, quant_plan=QuantPlan.full()),
        "decode_attention_partial": lambda: ServingEngine(
            model, n_slots=3, max_len=4096, prefill_bucket=16,
            quant_plan=QuantPlan.full()),
    }
    for kernel, make in engines.items():
        reset_launch_counts()
        eng, kern = serve(make, plain=False)
        counts = launch_counts()
        assert counts[kernel] > 0, (kernel, counts)
        if kernel == "decode_attention_paged":
            assert eng.stats.preemptions >= 1
            eng.paged.allocator.check()
            assert eng.paged.allocator.n_used == 0
        else:
            assert counts["decode_attention_combine"] == counts[kernel]
        assert counts["decode_attention"] == 0
        _, plain = serve(make, plain=True)
        assert launch_counts() == counts
        assert all(r.status is RequestStatus.OK for r in kern + plain)
        agree = sum(a == b for ka, pa in zip(kern, plain)
                    for a, b in zip(ka.generated, pa.generated))
        assert agree >= 0.9 * sum(len(r.generated) for r in plain)


# ---------------------------------------------------------------------------
# grouped-expert GEMMs (kernels 7 and 8) and the in-kernel requant
# ---------------------------------------------------------------------------
def _grouped(rng, E, M, K, N, dev, zero=()):
    """int8 rows [E, M, K] (all zero for the experts in ``zero``, as a
    capacity buffer without tokens), scales, two weight stacks, counts."""
    x = rng.integers(-127, 128, (E, M, K)).astype(np.int8)
    xs = rng.uniform(1e-3, 1e-2, (E, M, 1)).astype(np.float32)
    counts = rng.integers(1, 9, E).astype(np.int32)
    for e in zero:
        x[e] = 0
        xs[e] = np.float32(1e-12) / np.float32(127)
        counts[e] = 0
    stacks = [(_t(rng.integers(-127, 128, (E, K, N)).astype(np.int8), dev),
               _t(rng.uniform(1e-3, 2e-2, (E, N)).astype(np.float32), dev))
              for _ in range(2)]
    return _t(x, dev), _t(xs, dev), stacks, _t(counts, dev)


@pytest.mark.parametrize("E,M,K,N", [(60, 8, 2048, 1408), (5, 13, 100, 36),
                                     (3, 48, 1408, 2048)])
def test_grouped_gemm_bitwise_and_skip(dev, E, M, K, N):
    """Kernel 7 without an activation is bitwise its plain version; an
    expert whose count is 0 comes out as the full run on its zero rows."""
    x, xs, [(w, ws), (b, _)], counts = _grouped(_gen(20), E, M, K, N, dev,
                                                zero=(0, E - 1))
    bias = ws * 0.5
    before = cg.cim_grouped_gemm_int8.launches
    out = cg.cim_grouped_gemm_int8(x, w, xs, ws, bias=bias, counts=counts)
    full = cg.cim_grouped_gemm_int8(x, w, xs, ws, bias=bias)
    torch.cuda.synchronize()
    assert cg.cim_grouped_gemm_int8.launches == before + 2
    ref = cg.cim_grouped_gemm_int8_plain(x, w, xs, ws, bias, counts)
    assert torch.equal(out, ref) and torch.equal(full, out)
    act = cg.cim_grouped_gemm_int8(x, w, xs, ws, counts=counts,
                                   activation="silu")
    torch.testing.assert_close(act, cg.cim_grouped_gemm_int8_plain(
        x, w, xs, ws, None, counts, "silu"), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("E,M,K,N", [(60, 8, 2048, 1408), (4, 48, 2048, 1408),
                                     (3, 5, 96, 1000)])
def test_grouped_gated_close_and_requant_bitwise(dev, E, M, K, N):
    """Kernel 8 against its plain version (silu within 1e-5), skipped
    experts exactly zero, and the requant epilogue bitwise the row
    quantizer of the kernel's own f32 output."""
    x, xs, [(wg, gs), (wu, us)], counts = _grouped(_gen(21), E, M, K, N,
                                                   dev, zero=(1,))
    h = cg.cim_grouped_gated_gemm_int8(x, wg, wu, xs, gs, us, counts=counts,
                                       activation="silu")
    hr = cg.cim_grouped_gated_gemm_int8_plain(x, wg, wu, xs, gs, us, counts,
                                              "silu")
    torch.testing.assert_close(h, hr, rtol=1e-5, atol=1e-6)
    assert float(h[1].abs().max()) == 0.0
    for _ in range(2):                   # the workspace is left zeroed
        q, s = cg.cim_grouped_gated_gemm_int8(x, wg, wu, xs, gs, us,
                                              counts=counts,
                                              activation="silu",
                                              quantize_out=True)
        qr, sr = cg.quantize_rows_int8_plain(h)
        torch.cuda.synchronize()
        assert torch.equal(q, qr) and torch.equal(s, sr)
    assert s.shape == (E, M, 1)


@pytest.mark.parametrize("M,K,N", [(8, 2048, 5632), (8, 1408, 1408),
                                   (37, 300, 1000)])
def test_requant_epilogue_bitwise_dense(dev, M, K, N):
    """Kernels 3 and 4 with quantize_out: one launch each, bitwise the
    row quantizer of the f32 output the same kernel writes without it."""
    rng = _gen(22)
    xq = _t(rng.integers(-127, 128, (M, K)).astype(np.int8), dev)
    xs = _t(rng.uniform(1e-3, 1e-2, (M, 1)).astype(np.float32), dev)
    wg, gs = _w(rng, K, N, dev)
    wu, us = _w(rng, K, N, dev)
    for fn, args in ((cg.cim_gated_gemm_int8, (xq, wg, wu, xs, gs, us,
                                               "silu")),
                     (cg.cim_gemm_int8_fused, (xq, wg, xs, gs, None, None,
                                               "gelu"))):
        h = fn(*args)
        before = (cg.quantize_rows_int8.launches, fn.launches)
        q, s = fn(*args, quantize_out=True)
        torch.cuda.synchronize()
        assert (cg.quantize_rows_int8.launches, fn.launches) == (
            before[0], before[1] + 1)
        qr, sr = cg.quantize_rows_int8_plain(h)
        assert torch.equal(q, qr) and torch.equal(s, sr)


def test_grouped_wrappers_reject_bad_inputs(dev):
    x, xs, [(w, ws), _], counts = _grouped(_gen(23), 3, 4, 64, 8, dev)
    with pytest.raises(TypeError):
        cg.cim_grouped_gemm_int8(x, w, xs, ws, counts=counts.long())
    with pytest.raises(ValueError):
        cg.cim_grouped_gemm_int8(x, w[:2], xs, ws)
    with pytest.raises(ValueError):
        cg.cim_grouped_gemm_int8(x, w, xs[:, :, 0].contiguous(), ws)
    with pytest.raises(ValueError):
        cg.cim_grouped_gated_gemm_int8(x, w, w[..., :4].contiguous(), xs,
                                       ws, ws[:, :4].contiguous())


@pytest.mark.parametrize("quantized", [True, False])
def test_decode_walks_at_qwen2_moe_heads(dev, quantized):
    """The ring and paged walks at qwen2-moe's KH 16, G 1, D 128: paged
    bitwise the ring walk, both within the decode-attention rule of
    their plain versions."""
    q, k, v, pos, qp, ks, vs = _ring_case(dev, 24, 8, 1024, 16, 1, 128,
                                          quantized, torch.bfloat16)
    tables, (kp, vp, pp, ksp, vsp) = _to_pages(25, 16, k, v, pos, ks, vs)
    ring = da.decode_attention(q, k, v, pos, qp, ks, vs)
    paged = da.decode_attention_paged(q, kp, vp, pp, tables, qp, ksp, vsp)
    torch.cuda.synchronize()
    assert torch.equal(paged, ring)
    wide = (lambda t: t) if quantized else (lambda t: t.float())
    ref = da.decode_attention_plain(q.float(), wide(k), wide(v), pos, qp, ks,
                                    vs).to(q.dtype).float()
    err = (ring.float() - ref).abs()
    limit = _attn_limit(ref, q.dtype, k.dtype)
    assert bool((err <= limit).all()), (err / limit).max().item()


def test_reduced_moe_engines_on_card(dev):
    """Reduced qwen2-moe serves on the card through the ring and the
    paged engine: every request OK, the pool drains, 9 launches per layer
    per decode step and 8 per prefill forward (ring) or chunk (paged),
    and greedy tokens agree with the plain path on at least 90% of
    steps."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import Model
    from repro_torch.quant import QuantPlan, kernel_mode
    from repro_torch.serving import (PagedServingEngine, Request,
                                     RequestStatus, ServingEngine)

    cfg = reduced_config(get_config("qwen2-moe-a2.7b"))
    prompts = [np.arange(1, n + 1, dtype=np.int32) * 7 % 256
               for n in (3, 17, 30, 9, 12)]
    model = Model(cfg).init(0, device=dev).quantize(QuantPlan.full())
    L = cfg.n_layers
    engines = {
        "ring": (lambda: ServingEngine(model, n_slots=3, max_len=64,
                                       prefill_bucket=16,
                                       quant_plan=QuantPlan.full()),
                 "decode_attention", "prefills"),
        "paged": (lambda: PagedServingEngine(
            model, n_slots=3, max_len=64, prefill_bucket=16, block_size=8,
            num_blocks=7, prefill_chunk=8, quant_plan=QuantPlan.full()),
            "decode_attention_paged", "prefill_chunks"),
    }
    for name, (make, attn, fwd_stat) in engines.items():
        runs = []
        for plain in (False, True):
            eng = make()
            reqs = [Request(uid=i, prompt=p, max_new_tokens=6)
                    for i, p in enumerate(prompts)]
            for r in reqs:
                eng.submit(r)
            reset_launch_counts()
            with kernel_mode(False if plain else None):
                eng.run_until_done()
            runs.append((eng, reqs, launch_counts()))
        (eng, kern, counts), (_, plain, plain_counts) = runs
        steps, fwd = eng.stats.decode_steps, getattr(eng.stats, fwd_stat)
        assert all(r.status is RequestStatus.OK for r in kern + plain)
        want = dict.fromkeys(counts, 0)
        want.update(quantize_rows_int8=2 * L * (steps + fwd),
                    cim_gemm_int8_fused_qin=2 * L * (steps + fwd),
                    cim_gemm_int8_fused=L * (steps + fwd),
                    cim_gated_gemm_int8=L * (steps + fwd),
                    cim_grouped_gemm_int8=L * (steps + fwd),
                    cim_grouped_gated_gemm_int8=L * (steps + fwd))
        want[attn] = L * steps
        assert counts == want, (name, counts)
        assert sum(counts.values()) == 9 * L * steps + 8 * L * fwd
        assert not any(plain_counts.values()), plain_counts
        if name == "paged":
            assert eng.stats.preemptions >= 1
            eng.paged.allocator.check()
            assert eng.paged.allocator.n_used == 0
        agree = sum(a == b for ka, pa in zip(kern, plain)
                    for a, b in zip(ka.generated, pa.generated))
        assert agree >= 0.9 * sum(len(r.generated) for r in plain), name
