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
the reference does and the f32 oracle does not).  Kernels 12-14 (flash
attention, the SSD scan, online softmax) carry the tolerances their
tests state: flash attention 2e-5 in f32 and 2**-7 of the element plus
2**-7 of its row in bf16 (on both of its bodies), the scan 2e-4,
softmax 2e-5 (f32) and 2**-7 (bf16).
"""
from __future__ import annotations

import contextlib
import dataclasses

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


def _rows_with_edges(rng, M, K):
    """f32 rows [M, K] of normal values at magnitudes from 1e-2 to 1e2,
    where they exist with row 1 all zero (scale 1e-12 / 127), row 2 of
    exact ties at scale 1 (|max| 127; 0.5, 1.5, ..., 126.5 and their
    negatives divide to half-integers exactly) and row 3 of exact ties at
    scale 2 (|max| 254; odd integers); every value is a bf16 value too,
    so both dtypes meet the same ties."""
    x = rng.standard_normal((M, K)).astype(np.float32)
    x *= rng.uniform(1e-2, 1e2, (M, 1)).astype(np.float32)
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    if M > 1:
        x[1] = 0.0
    k = np.arange(K) // 2 % 127
    sign = np.where(np.arange(K) % 2, 1.0, -1.0)
    for row, (amax, step) in ((2, (127.0, 0.5)), (3, (254.0, 1.0))):
        if row < M:
            x[row] = sign * step * (2 * k + 1)
            x[row, 0] = amax
    return x


# M from one row to a 4096-token forward, K of gemma-2b's d_model, qwen2's
# shared d_ff, gemma-2b's d_ff and a ragged width (single-value units);
# one long row that takes more than one chunk
@pytest.mark.parametrize("M,K", [(1, 2048), (3, 1030), (8, 16384),
                                 (8, 5632), (130, 1030), (480, 2048),
                                 (4096, 16384), (1, 1 << 20)])
def test_rowquant_bitwise_under_every_plan(dev, M, K):
    """Kernel 1 under the plan's rule and with 32, 128 and 1024 threads a
    block (rows of several chunks, and of one), f32 and bf16 x: the codes
    and scales bitwise its plain version, all-zero rows and exact ties
    included; one launch a call."""
    x = _rows_with_edges(_gen(60), M, K)
    for dtype in (torch.float32, torch.bfloat16):
        xt = _t(x, dev, dtype)
        qr, sr = cg.quantize_rows_int8_plain(xt)
        rule = cg.rowquant_plan(M, K, dtype)
        for threads in (rule.threads, 32, 128, 1024):
            with cg.forced_rowquant_plan(threads):
                plan = cg.rowquant_plan(M, K, dtype)
                assert plan == dataclasses.replace(rule, threads=threads)
                before = cg.quantize_rows_int8.launches
                q, s = cg.quantize_rows_int8(xt)
                torch.cuda.synchronize()
                assert cg.quantize_rows_int8.launches == before + 1
                assert torch.equal(q, qr) and torch.equal(s, sr), plan


def test_rowquant_unaligned_rows_take_single_values(dev):
    """x whose first byte is not 16-byte aligned (a view one value into
    its storage) takes the single-value units, bitwise the plain
    version."""
    x = _rows_with_edges(_gen(61), 9, 2048)
    for dtype in (torch.float32, torch.bfloat16):
        flat = _t(np.concatenate([[1.0], x.ravel()]).astype(np.float32),
                  dev, dtype)
        xt = flat[1:].view(9, 2048)
        assert xt.data_ptr() % 16 and xt.is_contiguous()
        assert not cg.rowquant_plan(9, 2048, dtype, aligned=False).vec
        q, s = cg.quantize_rows_int8(xt)
        qr, sr = cg.quantize_rows_int8_plain(xt)
        torch.cuda.synchronize()
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


def test_card_plain_gelu_within_few_ulp_of_the_cpu_one(dev):
    """The plain gelu on an f32 card tensor (torch's f32 tanh, the
    kernels' tanhf) against the same function on the CPU (an f64 tanh
    rounded once): the two oracles differ only in the tanh, so they stay
    within 4 ulp of |x| everywhere (gelu(x) = x cdf, cdf in [0, 1]) and,
    where x >= 0 and cdf >= 1/2 leaves no cancellation, within 8 ulp of
    the output; at tanh arguments straddling +-5 and a spread of
    others."""
    from repro_torch.kernels import ref as kref
    near = np.linspace(3.5, 4.1, 20001)
    x = np.concatenate([near, -near, np.linspace(-8.0, 8.0, 20001),
                        np.logspace(-6, 1.5, 2001),
                        -np.logspace(-6, 1.5, 2001)]).astype(np.float32)
    cpu = kref.gelu_tanh(torch.from_numpy(x)).numpy().astype(np.float64)
    card = kref.gelu_tanh(_t(x, dev)).cpu().numpy().astype(np.float64)
    diff = np.abs(card - cpu)
    ulps_x = diff / np.spacing(np.abs(x))
    assert ulps_x.max() <= 4.0, (x[ulps_x.argmax()], ulps_x.max())
    pos = x > 0
    ulps_out = diff[pos] / np.spacing(np.abs(cpu[pos]).astype(np.float32))
    assert ulps_out.max() <= 8.0, (x[pos][ulps_out.argmax()],
                                   ulps_out.max())


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


RANK_SHAPES = [(8, 8192, 1, 8, 256, None), (8, 1024, 1, 8, 256, None),
               (3, 256, 2, 4, 16, None), (2, 4096, 1, 1, 64, 300)]


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("B,S,KH,G,D,window", RANK_SHAPES)
def test_partial_on_each_ranks_slots_is_the_unsharded_split_walk(
        dev, p, B, S, KH, G, D, window):
    """Kernel 9 on each of p ranks' slots of a ring cut by sequence
    (``cluster_slots``: the whole ring's cluster) in ``n_splits_for(S /
    p)`` splits, the partials in rank order merged by kernel 10: bitwise
    the unsharded walk in p times those splits (rows whose visible slots
    leave the last ranks empty included), and by the decode-attention
    rule its plain split version; without ``cluster_slots`` a rank takes
    its own length's cluster size."""
    from repro_torch.kernels import ops
    q, k, v, pos, qp, ks, vs = _ring_case(dev, 9, B, S, KH, G, D, True,
                                          torch.bfloat16)
    L = S // p
    ns = ops.n_splits_for(L)
    parts = []
    for r in range(p):
        cut = slice(r * L, (r + 1) * L)
        before = da.decode_attention_partial.launches
        parts.append(da.decode_attention_partial(
            q, k[:, cut].contiguous(), v[:, cut].contiguous(),
            pos[:, cut].contiguous(), qp, ks[:, cut].contiguous(),
            vs[:, cut].contiguous(), window=window, n_splits=ns,
            cluster_slots=S))
        assert da.decode_attention_partial.launches == before + 1
    o, m, l = (torch.cat([t[i] for t in parts], dim=2).contiguous()
               for i in range(3))
    got = da.decode_attention_combine(o, m, l, q.dtype)
    want = ops.decode_attention(q, k, v, pos, qp, ks, vs, window=window,
                                n_splits=p * ns)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    ref = ops.decode_attention_splitkv(
        q.float().cpu(), k.cpu(), v.cpu(), pos.cpu(), qp.cpu(), ks.cpu(),
        vs.cpu(), window=window, n_splits=p * ns).to(q.dtype).float()
    err = (got.float().cpu() - ref).abs()
    limit = _attn_limit(ref, torch.bfloat16, k.dtype)
    assert bool((err <= limit).all()), (err / limit).max().item()
    assert da.walk_plan(L, D, G, k.dtype, "split", ns,
                        cluster_slots=S).cluster == da.cluster_for(S, D)


def test_tp_two_sequence_cut_decode_on_card(dev):
    """gemma-2b-smoke at 2 gloo ranks sharing the card, its ring of 128
    slots cut by sequence: the prefill + decode logits bitwise the
    unsharded model's with the walk in 2 splits, kernels 9 and 10 on
    every layer's decode step and kernel 5 never."""
    from repro_torch.parallel.context import spawn
    res = spawn(_seq_cut_rank, 2, args=("cuda",), timeout_s=600)
    want, _ = _seq_cut_logits(dev, None)
    for got, launches in res:
        np.testing.assert_array_equal(got, want)
        assert launches["decode_attention"] == 0
        assert launches["decode_attention_partial"] == \
            launches["decode_attention_combine"] == 4 * 3


def _seq_cut_logits(dev, group):
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.kernels import launch_counts, ops, reset_launch_counts
    from repro_torch.models import Model
    from repro_torch.parallel.context import tp_context
    cfg = reduced_config(get_config("gemma-2b"))
    model = Model(cfg).init(0, device=dev) if group is None else Model(
        cfg).init(0, device=dev, tp=group)
    if group is None:
        model.quantize()
    rng = _gen(11)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (3, 90)), device=dev)
    lengths = torch.tensor([90, 70, 20], dtype=torch.int32, device=dev)
    with torch.no_grad(), tp_context(group), (
            ops.walk_as_ranks(2) if group is None else
            contextlib.nullcontext()):
        caches = model.init_cache(3, 128, kv_dtype="int8")
        reset_launch_counts()
        outs = [model.prefill_padded(toks, caches, lengths)]
        for _ in range(3):
            outs.append(model.decode_step(outs[-1].argmax(-1), caches))
    return torch.cat(outs, dim=1).cpu().numpy(), launch_counts()


def _seq_cut_rank(group, device):
    from repro_torch.parallel.context import rank_device
    return _seq_cut_logits(rank_device(device, "gloo", group.rank), group)


def _partials(seed, B, KH, NS, G, D, dev):
    """Split states (o, m, l) as the partial walk leaves them: random
    rows, a split of each (row, head) empty (m = -1e30, l = 0, o = 0)
    where NS > 1, and (row 0, head 0) empty in every split."""
    rng = _gen(seed)
    o = rng.standard_normal((B, KH, NS, G, D)).astype(np.float32)
    m = (3 * rng.standard_normal((B, KH, NS, G, 1))).astype(np.float32)
    l = rng.uniform(0.5, 50.0, (B, KH, NS, G, 1)).astype(np.float32)
    if NS > 1:
        empty = rng.integers(0, NS, (B, KH))
        for b in range(B):
            for h in range(KH):
                o[b, h, empty[b, h]], m[b, h, empty[b, h]] = 0.0, -1e30
                l[b, h, empty[b, h]] = 0.0
    o[0, 0], m[0, 0], l[0, 0] = 0.0, -1e30, 0.0
    return _t(o, dev), _t(m, dev), _t(l, dev)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,D", [(1, 64), (2, 128), (4, 256), (8, 256),
                                 (8, 64), (3, 96)])
def test_combine_bitwise_against_its_plain_version(dev, out_dtype, G, D):
    """Kernel 10 at NS 1 to 8 on split states with empty splits and an
    all-empty (row, head): bitwise its plain version (the splits summed in
    ascending order, each product and sum rounded on its own), in f32 and
    bf16 out, on 16-byte rows and (D 96 from an unaligned base) single
    values; and the split walk at NS 1 with the combine bitwise the
    single walk at the same G and D (D divides 256).  One launch a
    call."""
    for ns in range(1, 9):
        o, m, l = _partials(70 + ns, 3, 2, ns, G, D, dev)
        if D == 96:  # an o that is not 16-byte aligned
            o = o.new_empty(o.numel() + 1)[1:].view(o.shape).copy_(o)
        n = da.decode_attention_combine.launches
        got = da.decode_attention_combine(o, m, l, out_dtype)
        torch.cuda.synchronize()
        assert da.decode_attention_combine.launches == n + 1
        assert got.dtype == out_dtype and got.shape == (3, 2, G, D)
        want = da.decode_attention_combine_plain(o, m, l, out_dtype)
        assert torch.equal(got, want), ns
        assert not got[0, 0].float().any()
    if 256 % D:
        return
    from repro_torch.kernels import ops
    qdtype = out_dtype
    q, k, v, pos, qp, ks, vs = _ring_case(dev, 79, 3, 700, 2, G, D, True,
                                          qdtype)
    one = da.decode_attention(q, k, v, pos, qp, ks, vs)
    split1 = ops.decode_attention_splitkv(q, k, v, pos, qp, ks, vs,
                                          n_splits=1)
    torch.cuda.synchronize()
    assert torch.equal(split1, one)


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


# qwen2-moe's expert down GEMM at serve-moe's decode (E 60, M 8), its
# TP-2 expert shard (E 30), the decode tile at 16 rows, prefill chunks
# (17 and 136 rows an expert) and ragged widths; one row
@pytest.mark.parametrize("E,M,K,N", [(60, 8, 1408, 2048),
                                     (30, 8, 1408, 2048), (4, 16, 1030, 264),
                                     (3, 17, 1030, 264), (5, 136, 1408, 512),
                                     (2, 1, 96, 36)])
def test_grouped_gemm_bitwise_under_every_plan(dev, E, M, K, N):
    """Kernel 7 on the int8 tensor-core body under every plan it takes
    (both tile shapes, clusters 1 to 8), an idle expert in the skip list:
    without an activation bitwise its plain version and the run without a
    skip list, with and without a bias (an idle expert's rows are then
    act(bias)); gelu and silu within 1e-5; the requant, with and without
    a bias, bitwise the row quantizer of its own f32 output.  One launch
    a call."""
    x, xs, [(w, ws), _], counts = _grouped(_gen(65), E, M, K, N, dev,
                                           zero=(E - 1,))
    bias = _t(_gen(66).standard_normal((E, N)).astype(np.float32), dev)
    fn, plain = cg.cim_grouped_gemm_int8, cg.cim_grouped_gemm_int8_plain
    bare = plain(x, w, xs, ws, None, counts)
    biased = plain(x, w, xs, ws, bias, counts)
    acts = {act: plain(x, w, xs, ws, bias, counts, act)
            for act in ("gelu", "silu")}
    plans = cg.gemm_plans(M, K, N, "int8")
    assert cg.grouped_plan(E, M, K, N, "int8") in plans
    for plan in plans:
        with cg.forced_gemm_plan(plan.kind, plan.cluster):
            assert cg.grouped_plan(E, M, K, N, "int8") == plan
            n7 = fn.launches
            assert torch.equal(fn(x, w, xs, ws, counts=counts), bare), plan
            got = fn(x, w, xs, ws, bias=bias, counts=counts)
            assert torch.equal(got, biased), plan
            assert torch.equal(fn(x, w, xs, ws, bias=bias), got), plan
            for act, ref in acts.items():
                torch.testing.assert_close(fn(
                    x, w, xs, ws, bias=bias, counts=counts, activation=act),
                    ref, rtol=1e-5, atol=1e-6)
            for b in (None, bias):
                h = fn(x, w, xs, ws, bias=b, counts=counts,
                       activation="silu")
                q, s = fn(x, w, xs, ws, bias=b, counts=counts,
                          activation="silu", quantize_out=True)
                qr, sr = cg.quantize_rows_int8_plain(h)
                torch.cuda.synchronize()
                assert torch.equal(q, qr) and torch.equal(s, sr), plan
            assert fn.launches == n7 + 9


@pytest.mark.parametrize("active", [0, 1, 25, 60])
def test_grouped_gemm_skip_list_at_the_served_shape(dev, active):
    """Kernel 7 at qwen2-moe's expert down GEMM (E 60, M 8, K 1408, N
    2048) with 0, 1, 25 and 60 of 60 experts holding tokens (the idle
    experts' rows zero, as the dispatch leaves them): bitwise the run
    without a skip list and the plain version; the idle experts' rows +0
    without a bias, with the requant the code 0 at scale row_scale(0);
    with a bias its rows exactly, and with gelu act(bias) bitwise the run
    without a skip list and, requantized, the row quantizer's codes and
    scales of it."""
    E, M, K, N = 60, 8, 1408, 2048
    rng = _gen(67)
    idle = tuple(sorted(rng.permutation(E)[active:]))
    x, xs, [(w, ws), _], counts = _grouped(rng, E, M, K, N, dev, zero=idle)
    bias = _t(rng.standard_normal((E, N)).astype(np.float32), dev)
    assert int((counts > 0).sum()) == active
    fn, plain = cg.cim_grouped_gemm_int8, cg.cim_grouped_gemm_int8_plain
    off = counts == 0
    h = fn(x, w, xs, ws, counts=counts)
    assert torch.equal(h, fn(x, w, xs, ws))
    assert torch.equal(h, plain(x, w, xs, ws, None, counts))
    assert not torch.signbit(h[off]).any() and not h[off].any()
    q, s = fn(x, w, xs, ws, counts=counts, activation="silu",
              quantize_out=True)
    qr, sr = cg.quantize_rows_int8_plain(fn(x, w, xs, ws, counts=counts,
                                            activation="silu"))
    torch.cuda.synchronize()
    assert torch.equal(q, qr) and torch.equal(s, sr)
    zero_scale = torch.full((), 1e-12, device=dev) / torch.full(
        (), 127.0, device=dev)
    assert not q[off].any() and bool((s[off] == zero_scale).all())
    hb = fn(x, w, xs, ws, bias=bias, counts=counts, activation="gelu")
    torch.testing.assert_close(hb, plain(x, w, xs, ws, bias, counts, "gelu"),
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(hb, fn(x, w, xs, ws, bias=bias, activation="gelu"))
    h0 = fn(x, w, xs, ws, bias=bias, counts=counts)
    assert torch.equal(h0[off], bias[off][:, None, :].expand_as(h0[off]))
    qb, sb = fn(x, w, xs, ws, bias=bias, counts=counts, activation="gelu",
                quantize_out=True)
    qbr, sbr = cg.quantize_rows_int8_plain(hb)
    torch.cuda.synchronize()
    assert torch.equal(qb, qbr) and torch.equal(sb, sbr)


def test_grouped_gemm_decode_plans_replay_their_bits_from_a_graph(dev):
    """A CUDA-graph replay of each decode plan of kernel 7 at the served
    shape (25 of 60 experts active) returns the eager launch's bits, with
    a bias and without, with and without the requant epilogue (its
    counters reset by the launch before the capture)."""
    E, M, K, N = 60, 8, 1408, 2048
    rng = _gen(68)
    x, xs, [(w, ws), _], counts = _grouped(
        rng, E, M, K, N, dev, zero=tuple(rng.permutation(E)[25:]))
    bias = _t(rng.standard_normal((E, N)).astype(np.float32), dev)
    fn = cg.cim_grouped_gemm_int8
    for plan in cg.gemm_plans(M, K, N, "int8"):
        if plan.kind != "decode":
            continue
        with cg.forced_gemm_plan(plan.kind, plan.cluster):
            def calls():
                return (fn(x, w, xs, ws, counts=counts),
                        *fn(x, w, xs, ws, counts=counts, activation="silu",
                            quantize_out=True),
                        *fn(x, w, xs, ws, bias=bias, counts=counts,
                            activation="silu", quantize_out=True))
            eager = calls()
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                captured = calls()
            for _ in range(2):
                graph.replay()
                torch.cuda.synchronize()
                for a, e in zip(captured, eager):
                    assert torch.equal(a, e), plan


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


# qwen2-moe's served decode (E 60, M 8) and its TP-2 expert shard (E 30),
# the decode tile at 16 rows, prefill chunks (17 and 136 rows an expert)
# and ragged widths; one row
@pytest.mark.parametrize("E,M,K,N", [(60, 8, 2048, 1408),
                                     (30, 8, 2048, 1408), (4, 16, 1030, 264),
                                     (3, 17, 1030, 264), (5, 136, 2048, 512),
                                     (2, 1, 96, 36)])
def test_grouped_gated_bitwise_under_every_plan(dev, E, M, K, N):
    """Kernel 8 on the gated tensor-core body under every plan it takes
    (both tile shapes, clusters 1 to 8), an idle expert in the skip list:
    without an activation bitwise its plain version, gelu and silu within
    1e-5, the requant bitwise the row quantizer of its own f32 output.
    One launch a call."""
    x, xs, [(wg, gs), (wu, us)], counts = _grouped(_gen(62), E, M, K, N,
                                                   dev, zero=(E - 1,))
    args = (x, wg, wu, xs, gs, us, counts)
    bare = cg.cim_grouped_gated_gemm_int8_plain(*args, None)
    acts = {act: cg.cim_grouped_gated_gemm_int8_plain(*args, act)
            for act in ("gelu", "silu")}
    plans = cg.gemm_plans(M, K, N, "gated")
    assert cg.grouped_plan(E, M, K, N) in plans
    for plan in plans:
        with cg.forced_gemm_plan(plan.kind, plan.cluster):
            assert cg.grouped_plan(E, M, K, N) == plan
            n8 = cg.cim_grouped_gated_gemm_int8.launches
            assert torch.equal(cg.cim_grouped_gated_gemm_int8(
                *args, activation=None), bare), plan
            for act, ref in acts.items():
                torch.testing.assert_close(cg.cim_grouped_gated_gemm_int8(
                    *args, activation=act), ref, rtol=1e-5, atol=1e-6)
            h = cg.cim_grouped_gated_gemm_int8(*args, activation="silu")
            q, s = cg.cim_grouped_gated_gemm_int8(*args, activation="silu",
                                                  quantize_out=True)
            qr, sr = cg.quantize_rows_int8_plain(h)
            torch.cuda.synchronize()
            assert torch.equal(q, qr) and torch.equal(s, sr), plan
            assert cg.cim_grouped_gated_gemm_int8.launches == n8 + 5


@pytest.mark.parametrize("active", [0, 1, 25, 60])
def test_grouped_gated_skip_list_at_the_served_shape(dev, active):
    """Kernel 8 at qwen2-moe's decode shape with 0, 1, 25 and 60 of 60
    experts holding tokens (the idle experts' rows zero, as the dispatch
    leaves them): the output bitwise the run without a skip list (the
    reference's claim) and the plain version, the idle experts' rows +0
    in f32, and with the requant code 0 at scale row_scale(0)."""
    E, M, K, N = 60, 8, 2048, 1408
    rng = _gen(63)
    idle = tuple(sorted(rng.permutation(E)[active:]))
    x, xs, [(wg, gs), (wu, us)], counts = _grouped(rng, E, M, K, N, dev,
                                                   zero=idle)
    assert int((counts > 0).sum()) == active
    args = (x, wg, wu, xs, gs, us)
    h = cg.cim_grouped_gated_gemm_int8(*args, counts, activation=None)
    assert torch.equal(h, cg.cim_grouped_gated_gemm_int8(*args,
                                                         activation=None))
    assert torch.equal(h, cg.cim_grouped_gated_gemm_int8_plain(
        *args, counts, None))
    q, s = cg.cim_grouped_gated_gemm_int8(*args, counts, activation="silu",
                                          quantize_out=True)
    qr, sr = cg.quantize_rows_int8_plain(cg.cim_grouped_gated_gemm_int8(
        *args, counts, activation="silu"))
    torch.cuda.synchronize()
    assert torch.equal(q, qr) and torch.equal(s, sr)
    off = counts == 0
    zero_scale = torch.full((), 1e-12, device=dev) / torch.full(
        (), 127.0, device=dev)
    assert not torch.signbit(h[off]).any() and not h[off].any()
    assert not q[off].any() and bool((s[off] == zero_scale).all())


def test_grouped_gated_decode_plans_replay_their_bits_from_a_graph(dev):
    """A CUDA-graph replay of each decode plan of kernel 8 at the served
    shape (25 of 60 experts active) returns the eager launch's bits, with
    and without the requant epilogue (its counters reset by the launch
    before the capture)."""
    E, M, K, N = 60, 8, 2048, 1408
    rng = _gen(64)
    x, xs, [(wg, gs), (wu, us)], counts = _grouped(
        rng, E, M, K, N, dev, zero=tuple(rng.permutation(E)[25:]))
    args = (x, wg, wu, xs, gs, us, counts)
    for plan in cg.gemm_plans(M, K, N, "gated"):
        if plan.kind != "decode":
            continue
        with cg.forced_gemm_plan(plan.kind, plan.cluster):
            def calls():
                return (cg.cim_grouped_gated_gemm_int8(*args, "silu"),
                        *cg.cim_grouped_gated_gemm_int8(
                            *args, "silu", quantize_out=True))
            eager = calls()
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                captured = calls()
            for _ in range(2):
                graph.replay()
                torch.cuda.synchronize()
                for a, e in zip(captured, eager):
                    assert torch.equal(a, e), plan


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


# ---------------------------------------------------------------------------
# kernel 6 (int8 -> int32) and tensor parallelism on the one card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("M,K,N", [
    (8, 1024, 2048), (8, 8192, 2048), (8, 2816, 2048),      # TP-2 partials
    (64, 8192, 2048), (256, 1024, 2048), (5056, 8192, 2048),
    (13, 1030, 68), (3, 100, 36), (1, 5, 4), (33, 7, 260)])
def test_cim_gemm_int8_exact(dev, M, K, N):
    rng = _gen(30)
    x = _t(rng.integers(-127, 128, (M, K)).astype(np.int8), dev)
    w = _t(rng.integers(-127, 128, (K, N)).astype(np.int8), dev)
    before = cg.cim_gemm_int8.launches
    gated = cg.cim_gemm_int8.gated_launches
    out = cg.cim_gemm_int8(x, w)
    torch.cuda.synchronize()
    assert cg.cim_gemm_int8.launches == before + 1
    assert cg.cim_gemm_int8.gated_launches == gated
    assert out.dtype == torch.int32 and out.shape == (M, N)
    assert torch.equal(out, cg.cim_gemm_int8_plain(x, w))


def test_cim_gemm_int8_rejects_bad_inputs(dev):
    x = torch.zeros((4, 64), dtype=torch.int8, device=dev)
    w = torch.zeros((64, 8), dtype=torch.int8, device=dev)
    with pytest.raises(TypeError):
        cg.cim_gemm_int8(x.float(), w)
    with pytest.raises(ValueError):
        cg.cim_gemm_int8(x, w[:, :6].contiguous())       # N % 4
    with pytest.raises(ValueError):
        cg.cim_gemm_int8(x, w[:32])                      # K mismatch
    with pytest.raises(ValueError):
        cg.cim_gemm_int8(x, torch.zeros((8, 64), dtype=torch.int8,
                                        device=dev).t())  # not contiguous


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("KH,G,D,p", [(1, 8, 256, 2), (1, 8, 256, 4),
                                      (1, 4, 16, 4), (16, 1, 128, 2)])
def test_decode_heads_bitwise_across_groups(dev, quantized, KH, G, D, p):
    """Head-parallel decode: a rank's heads (G/p of one KV head, or KH/p
    KV heads) give the bits of the same heads in the whole walk, ring
    and paged."""
    q, k, v, pos, qp, ks, vs = _ring_case(dev, 31, 6, 256, KH, G, D,
                                          quantized, torch.bfloat16)
    tables, (kp, vp, pp, ksp, vsp) = _to_pages(32, 16, k, v, pos, ks, vs)
    ring = da.decode_attention(q, k, v, pos, qp, ks, vs)
    paged = da.decode_attention_paged(q, kp, vp, pp, tables, qp, ksp, vsp)
    for r in range(p):
        if KH == 1:
            heads = slice(r * G // p, (r + 1) * G // p)

            def part(t):
                return t[:, :, heads].contiguous()
            got = da.decode_attention(part(q), k, v, pos, qp, ks, vs)
            gotp = da.decode_attention_paged(part(q), kp, vp, pp, tables,
                                             qp, ksp, vsp)
            want, wantp = ring[:, :, heads], paged[:, :, heads]
        else:
            kv = slice(r * KH // p, (r + 1) * KH // p)

            def part(t, dim=2):
                return None if t is None else t.narrow(
                    dim, kv.start, kv.stop - kv.start).contiguous()
            got = da.decode_attention(part(q, 1), part(k), part(v), pos, qp,
                                      part(ks), part(vs))
            gotp = da.decode_attention_paged(part(q, 1), part(kp), part(vp),
                                             pp, tables, qp, part(ksp),
                                             part(vsp))
            want, wantp = ring[:, kv], paged[:, kv]
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(gotp, wantp)


# ---------------------------------------------------------------------------
# the flash-decode body (kernels 5, 9, 11): step list, stages, clusters
# ---------------------------------------------------------------------------
def _ordered_case(dev, seed, B, S, KH, G, D, quantized, lengths, q_pos,
                  first=None):
    """A cache whose row b holds positions first[b] .. first[b] +
    lengths[b] - 1 in slot order (the rest empty), so a window picks
    contiguous slots."""
    rng = _gen(seed)
    k, v, ks, vs, _ = _cache(rng, B, S, KH, D, quantized, dev, [0] * B,
                             torch.bfloat16)
    pos = np.full((B, S), 2 ** 30, np.int32)
    for b, n in enumerate(lengths):
        pos[b, :n] = np.arange(n) + (first[b] if first else 0)
    q = _t(rng.standard_normal((B, KH, G, D)).astype(np.float32), dev,
           torch.bfloat16)
    return (q, k, v, _t(pos, dev), _t(np.array(q_pos, np.int32), dev), ks,
            vs)


def _walks_agree(dev, case, window, splits=(1, 2, 4, 8), bs=16):
    """Ring, paged and split walks over one logical cache: paged == ring
    and NS 1 (+ combine) == ring bitwise; ring, paged and every split
    count within the decode-attention rule of the plain versions."""
    from repro_torch.kernels import ops
    q, k, v, pos, qp, ks, vs = case
    tables, (kp, vp, pp, ksp, vsp) = _to_pages(42, bs, k, v, pos, ks, vs)
    ring = da.decode_attention(q, k, v, pos, qp, ks, vs, window=window)
    paged = da.decode_attention_paged(q, kp, vp, pp, tables, qp, ksp, vsp,
                                      window=window)
    torch.cuda.synchronize()
    assert torch.equal(paged, ring)
    wide = (lambda t: t) if ks is not None else (lambda t: t.float())
    cpu = [None if t is None else t.cpu()
           for t in (q.float(), wide(k), wide(v), pos, qp, ks, vs)]
    ref = da.decode_attention_plain(*cpu, window=window).to(q.dtype).float()
    limit = _attn_limit(ref, q.dtype, k.dtype).to(dev)
    err = (ring.float() - ref.to(dev)).abs()
    assert bool((err <= limit).all()), (err / limit).max().item()
    for ns in splits:
        out = ops.decode_attention_splitkv(q, k, v, pos, qp, ks, vs,
                                           window=window, n_splits=ns)
        torch.cuda.synchronize()
        if ns == 1:
            assert torch.equal(out, ring)
        ref = ops.decode_attention_splitkv(*cpu, window=window,
                                           n_splits=ns).to(q.dtype).float()
        err = (out.float() - ref.to(dev)).abs()
        limit = _attn_limit(ref, q.dtype, k.dtype).to(dev)
        assert bool((err <= limit).all()), (ns, (err / limit).max().item())
    return ring


@pytest.mark.parametrize("quantized", [True, False])
def test_all_masked_row_at_8192_through_every_walk(dev, quantized):
    """A row with no visible slot in 8192 (every slot holds a position
    after q_pos; beside a long and a short row): every walk keeps all its
    steps and returns the uniform average of V, decided over the whole
    row by each split and each cluster rank; ring, paged and NS 1, 2, 4,
    8 agree as the pins and the rule say."""
    B, S = 3, 8192
    case = _ordered_case(dev, 40, B, S, 1, 8, 256, quantized,
                         [S, 5016, 77], [0, 5015, 76], first=[100, 0, 0])
    ring = _walks_agree(dev, case, None)
    q, k, v, pos, qp, ks, vs = case
    vd = v[0, :, 0].float() * (vs[0, :, 0, None] if quantized else 1.0)
    mean = vd.mean(0)
    torch.testing.assert_close(ring[0, 0].float(),
                               mean.expand(8, 256).to(ring.dtype).float(),
                               rtol=2 ** -7, atol=1e-3 * mean.abs().max())


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("window", [40, 700])
def test_window_at_the_end_and_across_ranks(dev, quantized, window):
    """Windows over ordered positions at 8192 slots: row 0 sees only its
    last ``window`` slots (the last split, the last kept step: the last
    cluster rank's share when it is the only step), row 1 a window that
    crosses the 4096-slot split boundary and the ranks' shares, row 2
    one short of a step boundary."""
    S = 8192
    case = _ordered_case(dev, 41, 3, S, 1, 8, 256, quantized,
                         [S, 4401, 1000], [S - 1, 4400, 63 + window])
    _walks_agree(dev, case, window)


# (B, S, KH, G, D): gemma-2b's heads, qwen2-moe's, and a narrow head of
# odd group size whose rows are not 16-byte multiples (the element copy)
CLUSTER_SHAPES = [(8, 1024, 1, 8, 256), (4, 1024, 4, 1, 128),
                  (3, 200, 2, 3, 8)]


@pytest.mark.parametrize("cluster", da.CLUSTERS)
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("B,S,KH,G,D", CLUSTER_SHAPES)
def test_every_cluster_size(dev, cluster, quantized, B, S, KH, G, D):
    """Each cluster size the plan can pick, forced through it: paged ==
    ring == NS 1 bitwise at that size, every walk within the
    decode-attention rule."""
    case = _ring_case(dev, 43, B, S, KH, G, D, quantized, torch.bfloat16)
    with da.forced_plan(cluster=cluster):
        plan = da.walk_plan(S, D, G, case[1].dtype, "paged", bs=8)
        assert plan.cluster == cluster
        _walks_agree(dev, case, 60 if D == 8 else None, splits=(1, 3),
                     bs=8)


def test_walk_shared_memory_matches_the_kernel_layout(dev):
    """The wrapper's byte count (``smem_bytes``, which the plan and the
    CPU tests use) is the kernel's own ``layout`` total, over the served
    heads and narrow ones, every cache dtype, ranges from one slot to
    8192 and paged table rows."""
    for kv in (torch.int8, torch.bfloat16, torch.float32):
        size = torch.empty((), dtype=kv).element_size()
        for D in (256, 128, 64, 8, 4):
            for G in (1, 2, 3, 8, 16):
                for rng, ntab in ((1, 0), (200, 0), (1024, 0), (1024, 64),
                                  (2048, 0), (8192, 512)):
                    want = da.kernel_smem_bytes(kv, D, G, rng, ntab)
                    got = da.smem_bytes(size, D, G, rng, ntab)
                    assert got == want, (kv, D, G, rng, ntab, got, want)


# Registers ptxas gives the walk body decode_attention_kernel<TQ, TKV,
# MAXG, MODE> (``nvcc -Xptxas -v`` for sm_90a) at the served types, bf16
# q over an int8 cache, keyed (MAXG, MODE): MAXG 8 (gemma-2b's G 8,
# D 256) and MAXG 1 (qwen2-moe's G 1, D 128); MODE 0 ring, 1 paged,
# 2 split.
DECODE_REGS = {(8, 0): 138, (8, 1): 134, (8, 2): 144,
               (1, 0): 89, (1, 1): 82, (1, 2): 83}


def test_decode_walk_body_registers_and_no_spill(dev):
    """No instantiation of the walk body spills (no local memory, no
    stack; ``cuobjdump --dump-resource-usage``), the served ones keep
    their registers, and each plan of the served walks fits the card
    with at least one cluster resident."""
    import pathlib
    import re
    import subprocess
    from repro_torch.kernels import _build
    _build.load("decode_attention")
    tool = pathlib.Path(_build._nvcc()).parent / "cuobjdump"
    lib = _build.BUILD_DIR / "libdecode_attention.so"
    text = subprocess.run([str(tool), "--dump-resource-usage", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    pat = re.compile(r"Function (\S*decode_attention_kernel\S*):\s*\n"
                     r"\s*(.*)")
    use = {m.group(1): {k: int(v) for k, v in (
        f.split(":") for f in m.group(2).split()) if v.isdigit()}
        for m in pat.finditer(text)}
    served = re.compile(r"decode_attention_kernelI13__nv_bfloat16a"
                        r"Li(\d+)ELi(\d)E")
    regs = {(int(m.group(1)), int(m.group(2))): u["REG"]
            for name, u in use.items() if (m := served.search(name))}
    print("served registers", regs)
    assert len(use) == 60, sorted(use)      # 4 type pairs x 5 MAXG x 3
    for name, u in use.items():
        assert u["LOCAL"] == 0 and u["STACK"] == 0, (name, u)
    for key, want in DECODE_REGS.items():
        assert regs[key] == want, (key, regs)
    for mode, S, KH, G, D, ns in (("ring", 1024, 1, 8, 256, 1),
                                  ("paged", 1024, 1, 8, 256, 1),
                                  ("split", 8192, 1, 8, 256, 4),
                                  ("ring", 1024, 16, 1, 128, 1),
                                  ("paged", 1024, 16, 1, 128, 1)):
        n = da.max_active_clusters(torch.bfloat16, torch.int8, mode, S, KH,
                                   G, D, ns, 16 if mode == "paged" else None)
        print("resident clusters", mode, S, KH, G, D, ns, n)
        assert n >= 1, (mode, S, G, D, n)


def _tp_rank_on_card(group, seed):
    """One of 2 gloo ranks on the one card: the row-parallel
    out-projection and the TP MLP at gemma-2b's widths on this rank's
    shards, against the unsharded kernel path on the whole weights."""
    import types
    from repro_torch.kernels import ops
    from repro_torch.parallel.context import rank_device
    from repro_torch.quant import tp as qtp
    dev = rank_device("cuda", "gloo", group.rank)
    rng = _gen(seed)
    M, d, F, HD = 8, 2048, 16384, 2048
    x = _t(rng.standard_normal((M, d)).astype(np.float32), dev,
           torch.bfloat16)
    res = _t(rng.standard_normal((M, d)).astype(np.float32), dev,
             torch.bfloat16)
    attn = _t(rng.standard_normal((M, HD)).astype(np.float32), dev,
              torch.bfloat16)
    (up, us), (gate, gs) = _w(rng, d, F, dev), _w(rng, d, F, dev)
    (down, ds), (o, os_) = _w(rng, F, d, dev), _w(rng, HD, d, dev)
    whole_mlp = ops.cim_quantized_mlp(x, up, us, down, ds, gate_q=gate,
                                      gate_scale=gs, residual=res,
                                      activation="gelu")
    whole_row = ops.cim_quantized_matmul_fused(attn, o, os_, residual=res)
    p, r = group.size, group.rank
    cols, rows = slice(r * F // p, (r + 1) * F // p), \
        slice(r * HD // p, (r + 1) * HD // p)

    def leaf(q, s):
        return types.SimpleNamespace(q=q.contiguous(), scale=s.contiguous())
    mlp = types.SimpleNamespace(up=leaf(up[:, cols], us[cols]),
                                gate=leaf(gate[:, cols], gs[cols]),
                                down=leaf(down[cols], ds))
    before = cg.cim_gemm_int8.launches
    tp_mlp = qtp.mlp(group, x, mlp, "gelu", True, residual=res)
    tp_row = qtp.matmul_row(group, attn[:, rows].contiguous(),
                            o[rows].contiguous(), os_, True, residual=res)
    torch.cuda.synchronize()
    return dict(mlp=bool(torch.equal(tp_mlp, whole_mlp)),
                row=bool(torch.equal(tp_row, whole_row)),
                k6=cg.cim_gemm_int8.launches - before,
                collectives=dict(group.counts))


def _tp_degraded_rank_on_card(group, seed):
    """One of 2 gloo ranks on the one card: gemma3-4b-smoke drawn into
    this rank's shards (KV heads too), one decode step with degraded
    mode under CUDA's sync debug mode "error" (the screens, the MAX of a
    column shard's flag, the gated fallbacks, kernel 6's gated partials
    and the fallbacks' sums: no host sync but gloo's own staging
    copies), bitwise the step without the mode; then a NaN in rank 1's
    QKV columns: every rank's logits finite and alike."""
    import hashlib
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import Model
    from repro_torch.parallel.context import rank_device, tp_context
    from repro_torch.quant import QuantPlan, degraded_mode
    dev = rank_device("cuda", "gloo", group.rank)
    cfg = reduced_config(get_config("gemma3-4b"))
    model = Model(cfg).init(seed, device=dev, tp=group,
                            plan=QuantPlan.full())
    rng = _gen(seed)
    toks = _t(rng.integers(0, cfg.vocab, (4, 12)).astype(np.int64), dev)
    lengths = _t(np.array([12, 9, 5, 1], np.int32), dev)

    def step(degraded):
        caches = model.init_cache(4, 64, kv_dtype="int8")
        with torch.no_grad(), tp_context(group):
            a = model.prefill_padded(toks, caches, lengths)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                with degraded_mode(degraded):
                    b = model.decode_step(a.argmax(-1), caches)
                synced = None
            except RuntimeError as e:
                b, synced = None, str(e).splitlines()[0]
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return b, synced
    step(True)                        # the screen's workspace, made once
    healthy, synced_off = step(False)
    degraded, synced_on = step(True)
    qkv = model.layers[1].attn.qkv
    if group.rank == 1:
        with torch.no_grad():
            qkv.scale[0, 3] = float("nan")
    tripped, _ = step(True)
    torch.cuda.synchronize()
    return dict(synced=(synced_off, synced_on),
                bitwise=bool(torch.equal(healthy, degraded)),
                finite=bool(torch.isfinite(tripped).all()),
                digest=hashlib.sha256(tripped.cpu().numpy().tobytes())
                .hexdigest())


def test_tp_degraded_step_no_host_sync(dev):
    from repro_torch.parallel.context import spawn
    outs = spawn(_tp_degraded_rank_on_card, 2, args=(34,), backend="gloo",
                 timeout_s=300)
    for out in outs:
        assert out["synced"] == (None, None), out["synced"]
        assert out["bitwise"] and out["finite"]
    assert outs[0]["digest"] == outs[1]["digest"]


def test_tp_two_ranks_on_one_card_bitwise(dev):
    from repro_torch.parallel.context import spawn
    for out in spawn(_tp_rank_on_card, 2, args=(33,), backend="gloo",
                     timeout_s=300):
        assert out["mlp"] and out["row"]
        assert out["k6"] == 2
        assert out["collectives"] == {"max": 2, "sum": 2, "gather": 0,
                                      "bcast": 0}


# Registers ptxas gives each instantiation (``nvcc -Xptxas -v`` for
# sm_90a), keyed by the mangled template arguments: of the dense GEMMs'
# tensor-core body cim_gemm_i8_kernel<EPI, SHAPE, VAR> at each of its tile
# shapes (("i8", EPI, SHAPE, VAR): SHAPE 0 and 1 the decode tile at 8 and
# 16 rows, 2 the prefill tile; VAR 0 int8 x (kernels 3 and 6), 1 the gated
# pair (kernel 4), 2 and 3 f32 and bf16 x quantized in the kernel (kernel
# 2)), of the grouped GEMMs on the same body,
# cim_gemm_i8_grouped_kernel<EPI, SHAPE, VAR> (("grouped_i8", EPI, SHAPE,
# VAR): VAR 0 kernel 7, 1 kernel 8) and of the row quantizer
# rowquant_kernel<XE, VEC> (("rowquant", XE, VEC): kernel 1, f32
# or bf16 x, 16-byte or single-value units).  A change that moves one (as
# run-time branches once took the int8 GEMM template from 80 to 66 and
# slowed gemma-2b's down GEMM 1.5x) fails that mode's test here.
GEMM_MODES = {
    "qin_f32": {("i8", 0, 0, 2): 110, ("i8", 0, 1, 2): 113,   # kernel 2
                ("i8", 0, 2, 2): 180},
    "qin_bf16": {("i8", 0, 0, 3): 112, ("i8", 0, 1, 3): 113,
                 ("i8", 0, 2, 3): 128},
    "fused": {("i8", 0, 0, 0): 92, ("i8", 0, 1, 0): 99,     # kernel 3
              ("i8", 0, 2, 0): 128},
    "fused_requant": {("i8", 1, 0, 0): 96, ("i8", 1, 1, 0): 95,
                      ("i8", 1, 2, 0): 160},
    "gated": {("i8", 0, 0, 1): 94, ("i8", 0, 1, 1): 99,     # kernel 4
              ("i8", 0, 2, 1): 128},
    "gated_requant": {("i8", 1, 0, 1): 90, ("i8", 1, 1, 1): 101,
                      ("i8", 1, 2, 1): 148},
    "grouped": {("grouped_i8", 0, 0, 0): 112,               # kernel 7
                ("grouped_i8", 0, 1, 0): 115,
                ("grouped_i8", 0, 2, 0): 188},
    "grouped_requant": {("grouped_i8", 1, 0, 0): 112,
                        ("grouped_i8", 1, 1, 0): 122,
                        ("grouped_i8", 1, 2, 0): 192},
    "grouped_gated": {("grouped_i8", 0, 0, 1): 102,         # kernel 8
                      ("grouped_i8", 0, 1, 1): 106,
                      ("grouped_i8", 0, 2, 1): 165},
    "grouped_gated_requant": {("grouped_i8", 1, 0, 1): 92,
                              ("grouped_i8", 1, 1, 1): 104,
                              ("grouped_i8", 1, 2, 1): 163},
    "acc": {("i8", 2, 0, 0): 92, ("i8", 2, 1, 0): 96,       # kernel 6
            ("i8", 2, 2, 0): 158},
    "rowquant": {("rowquant", 4, 1): 57, ("rowquant", 4, 0): 50,  # kernel 1
                 ("rowquant", 2, 1): 61, ("rowquant", 2, 0): 46},
}


def _mode_registers():
    """{template arguments: {"REG", "STACK", "LOCAL", ...}} of every
    instantiation in the built library, from the toolkit's
    ``cuobjdump --dump-resource-usage``."""
    import pathlib
    import re
    import subprocess
    from repro_torch.kernels import _build
    _build.load("cim_gemm")
    tool = pathlib.Path(_build._nvcc()).parent / "cuobjdump"
    lib = _build.BUILD_DIR / "libcim_gemm.so"
    text = subprocess.run([str(tool), "--dump-resource-usage", str(lib)],
                          capture_output=True, text=True, check=True).stdout

    def usage(use):
        return {k: int(v) for k, v in (f.split(":") for f in use.split())
                if v.isdigit()}
    out = {}
    for kind, name in (("i8", r"cim_gemm_i8_kernelILi(\d)ELi(\d)ELi(\d)EE"),
                       ("grouped_i8",
                        r"cim_gemm_i8_grouped_kernelILi(\d)ELi(\d)ELi(\d)EE"),
                       ("rowquant", r"rowquant_kernelILi(\d)ELb([01])EE")):
        pat = re.compile(r"Function \S*" + name + r"\S*:\s*\n\s*(.*)")
        for m in pat.finditer(text):
            *args, use = m.groups()
            out[(kind, *map(int, args))] = usage(use)
    return out


def _run_mode(mode, dev):
    """One launch of ``mode`` and its plain version: (out, ref, exact)."""
    rng = _gen(34)
    M, K, N, E = 8, 1030, 264, 3
    x = _t(rng.standard_normal((M, K)).astype(np.float32), dev)
    xq = _t(rng.integers(-127, 128, (M, K)).astype(np.int8), dev)
    xs = _t(rng.uniform(1e-3, 1e-2, (M, 1)).astype(np.float32), dev)
    (w, ws), (w2, ws2) = _w(rng, K, N, dev), _w(rng, K, N, dev)
    gx, gxs, [(gw, gws), (gw2, gws2)], counts = _grouped(rng, E, M, K, N,
                                                         dev, zero=(1,))
    if mode == "rowquant":
        q, sc = cg.quantize_rows_int8(x)
        qr, sr = cg.quantize_rows_int8_plain(x)
        return (torch.cat([q.float(), sc], -1),
                torch.cat([qr.float(), sr], -1), True)
    if mode.startswith("qin"):
        xx = x.to(torch.bfloat16) if mode == "qin_bf16" else x
        return (cg.cim_gemm_int8_fused_qin(xx, w, ws),
                cg.cim_gemm_int8_fused_qin_plain(xx, w, ws), True)
    if mode == "acc":
        return cg.cim_gemm_int8(xq, w), cg.cim_gemm_int8_plain(xq, w), True
    calls = {
        "fused": (cg.cim_gemm_int8_fused, (xq, w, xs, ws),
                  cg.cim_gemm_int8_fused_plain, True),
        "gated": (cg.cim_gated_gemm_int8, (xq, w, w2, xs, ws, ws2, "silu"),
                  cg.cim_gated_gemm_int8_plain, False),
        "grouped": (cg.cim_grouped_gemm_int8, (gx, gw, gxs, gws, None,
                                               counts),
                    cg.cim_grouped_gemm_int8_plain, True),
        "grouped_gated": (cg.cim_grouped_gated_gemm_int8,
                          (gx, gw, gw2, gxs, gws, gws2, counts, "silu"),
                          cg.cim_grouped_gated_gemm_int8_plain, False)}
    fn, args, plain, exact = calls[mode.replace("_requant", "")]
    if not mode.endswith("_requant"):
        return fn(*args), plain(*args), exact
    q, s = fn(*args, quantize_out=True)
    qr, sr = cg.quantize_rows_int8_plain(fn(*args))
    return (torch.cat([q.float(), s], -1), torch.cat([qr.float(), sr], -1),
            True)


@pytest.mark.parametrize("mode", list(GEMM_MODES))
def test_gemm_template_mode_and_registers(dev, mode):
    """Each compile-time mode of the GEMMs launches, agrees with its plain
    version (bitwise; activations within 1e-5; the requant epilogue
    bitwise the row quantizer of the kernel's f32 output) and keeps its
    registers at every tile shape, with nothing spilled; the library
    holds exactly the instantiations pinned here."""
    out, ref, exact = _run_mode(mode, dev)
    torch.cuda.synchronize()
    if exact:
        assert torch.equal(out, ref)
    else:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
    found = _mode_registers()
    for key, regs in GEMM_MODES[mode].items():
        use = found[key]
        assert use["REG"] == regs, (mode, key, use)
        assert use["LOCAL"] == 0 and use["STACK"] == 0, (mode, key, use)
    assert set(found) == {k for m in GEMM_MODES.values() for k in m}


# ---------------------------------------------------------------------------
# kernels 3 and 6 on the tensor cores: every plan, both tile shapes
# ---------------------------------------------------------------------------
def _i8_case(M, K, N, dev, seed=50):
    rng = _gen(seed)
    xq = _t(rng.integers(-127, 128, (M, K)).astype(np.int8), dev)
    xs = _t(rng.uniform(1e-3, 1e-2, (M, 1)).astype(np.float32), dev)
    w, ws = _w(rng, K, N, dev)
    b = _t(rng.standard_normal(N).astype(np.float32), dev)
    r = _t(rng.standard_normal((M, N)).astype(np.float32), dev)
    return xq, xs, w, ws, b, r


@pytest.mark.parametrize("K,N", [(1030, 264), (2048, 512)])
@pytest.mark.parametrize("M", [1, 8, 16, 17, 33, 130, 4096])
def test_i8_gemm_bitwise_under_every_plan(dev, M, K, N):
    """Under every plan the kernel takes (both tile shapes, clusters 1 to
    8), with ragged K and N (byte and 4-byte copies) and aligned ones
    (16-byte copies): kernel 6 exact; kernel 3 bitwise its plain version
    with an f32 residual and bias and with a bf16 residual, its
    activations within 1e-5, and its requant bitwise the row quantizer
    of its own f32 output.  One launch a call."""
    xq, xs, w, ws, b, r = _i8_case(M, K, N, dev)
    plans = cg.gemm_plans(M, K, N)
    assert {p.kind for p in plans} == ({"decode", "prefill"} if M <= 16
                                       else {"prefill"})
    acc_ref = cg.cim_gemm_int8_plain(xq, w)
    f32_ref = cg.cim_gemm_int8_fused_plain(xq, w, xs, ws, b, r)
    bf16_ref = cg.cim_gemm_int8_fused_plain(xq, w, xs, ws, None,
                                            r.to(torch.bfloat16))
    for plan in plans:
        with cg.forced_gemm_plan(plan.kind, plan.cluster):
            n3, n6 = cg.cim_gemm_int8_fused.launches, cg.cim_gemm_int8.launches
            assert torch.equal(cg.cim_gemm_int8(xq, w), acc_ref), plan
            assert torch.equal(cg.cim_gemm_int8_fused(
                xq, w, xs, ws, bias=b, residual=r), f32_ref), plan
            assert torch.equal(cg.cim_gemm_int8_fused(
                xq, w, xs, ws, residual=r.to(torch.bfloat16)), bf16_ref), plan
            for act in ("gelu", "silu", "relu"):
                out = cg.cim_gemm_int8_fused(xq, w, xs, ws, bias=b,
                                             activation=act)
                ref = cg.cim_gemm_int8_fused_plain(xq, w, xs, ws, b, None,
                                                   act)
                torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
            h = cg.cim_gemm_int8_fused(xq, w, xs, ws, activation="silu")
            q, s = cg.cim_gemm_int8_fused(xq, w, xs, ws, activation="silu",
                                          quantize_out=True)
            qr, sr = cg.quantize_rows_int8_plain(h)
            torch.cuda.synchronize()
            assert torch.equal(q, qr) and torch.equal(s, sr), plan
            assert cg.cim_gemm_int8_fused.launches == n3 + 7
            assert cg.cim_gemm_int8.launches == n6 + 1


@pytest.mark.parametrize("K,N", [(1030, 264), (2048, 512)])
@pytest.mark.parametrize("M", [1, 8, 16, 17, 130, 4096])
def test_qin_gemm_bitwise_under_every_plan(dev, M, K, N):
    """Kernel 2 on the tensor-core body under every plan it takes, with f32
    and bf16 x, ragged K and N (value-by-value and 4-byte copies) and
    aligned ones (16-byte copies): without an activation bitwise its plain
    version with a bias and an f32 residual and with a bf16 residual (the
    in-kernel codes and scales are the row quantizer's); its activations
    within 1e-5.  One launch a call."""
    rng = _gen(53)
    x32 = rng.standard_normal((M, K)).astype(np.float32)
    w, ws = _w(rng, K, N, dev)
    b = _t(rng.standard_normal(N).astype(np.float32), dev)
    r = _t(rng.standard_normal((M, N)).astype(np.float32), dev)
    rb = r.to(torch.bfloat16)
    for xdtype, variant in ((torch.float32, "qin_f32"),
                            (torch.bfloat16, "qin_bf16")):
        x = _t(x32, dev, xdtype)
        plans = cg.gemm_plans(M, K, N, variant)
        assert {p.kind for p in plans} == (
            {"decode", "prefill"} if M <= 16 else {"prefill"})
        f32_ref = cg.cim_gemm_int8_fused_qin_plain(x, w, ws, b, r)
        bf16_ref = cg.cim_gemm_int8_fused_qin_plain(x, w, ws, None, rb)
        acts = {act: cg.cim_gemm_int8_fused_qin_plain(x, w, ws, b, None, act)
                for act in ("gelu", "silu", "relu")}
        for plan in plans:
            with cg.forced_gemm_plan(plan.kind, plan.cluster):
                n2 = cg.cim_gemm_int8_fused_qin.launches
                assert torch.equal(cg.cim_gemm_int8_fused_qin(
                    x, w, ws, bias=b, residual=r), f32_ref), plan
                assert torch.equal(cg.cim_gemm_int8_fused_qin(
                    x, w, ws, residual=rb), bf16_ref), plan
                for act, ref in acts.items():
                    out = cg.cim_gemm_int8_fused_qin(x, w, ws, bias=b,
                                                     activation=act)
                    torch.testing.assert_close(out, ref, rtol=1e-5,
                                               atol=1e-6)
                torch.cuda.synchronize()
                assert cg.cim_gemm_int8_fused_qin.launches == n2 + 5


@pytest.mark.parametrize("K,N", [(1030, 264), (2048, 512)])
@pytest.mark.parametrize("M", [1, 8, 16, 17, 130, 4096])
def test_gated_gemm_bitwise_under_every_plan(dev, M, K, N):
    """Kernel 4 on the tensor-core body under every plan it takes, with
    ragged and aligned K and N: without an activation (act(g) = g)
    bitwise its plain version; gelu and silu within 1e-5; the requant
    bitwise the row quantizer of its own f32 output.  One launch a
    call."""
    xq, xs, wg, gs, _, _ = _i8_case(M, K, N, dev, seed=54)
    wu, us = _w(_gen(55), K, N, dev)
    args = (xq, wg, wu, xs, gs, us)
    plans = cg.gemm_plans(M, K, N, "gated")
    assert {p.kind for p in plans} == ({"decode", "prefill"} if M <= 16
                                       else {"prefill"})
    assert all(p.bn == 64 for p in plans)
    bare = cg.cim_gated_gemm_int8_plain(*args, None)
    acts = {act: cg.cim_gated_gemm_int8_plain(*args, act)
            for act in ("gelu", "silu")}
    for plan in plans:
        with cg.forced_gemm_plan(plan.kind, plan.cluster):
            n4 = cg.cim_gated_gemm_int8.launches
            assert torch.equal(cg.cim_gated_gemm_int8(*args, None), bare), \
                plan
            for act, ref in acts.items():
                torch.testing.assert_close(cg.cim_gated_gemm_int8(*args, act),
                                           ref, rtol=1e-5, atol=1e-6)
            h = cg.cim_gated_gemm_int8(*args, "silu")
            q, s = cg.cim_gated_gemm_int8(*args, "silu", quantize_out=True)
            qr, sr = cg.quantize_rows_int8_plain(h)
            torch.cuda.synchronize()
            assert torch.equal(q, qr) and torch.equal(s, sr), plan
            assert cg.cim_gated_gemm_int8.launches == n4 + 5


# served decode shapes of kernels 4 and 2: qwen2-moe's shared MLP (with
# its requant), gemma-2b's TP-2 MLP shard, gemma-2b's and qwen2-moe's QKV
@pytest.mark.parametrize("variant,M,K,N", [
    ("gated", 8, 2048, 5632), ("gated", 8, 2048, 8192),
    ("qin_bf16", 8, 2048, 2560), ("qin_f32", 16, 2048, 6144)])
def test_qin_and_gated_decode_plans_replay_their_bits_from_a_graph(
        dev, variant, M, K, N):
    """A CUDA-graph replay of each decode plan (clusters included) of
    kernels 4 and 2 returns the eager launch's bits (kernel 4 with and
    without the requant epilogue, its counters reset by the launch before
    the capture)."""
    rng = _gen(56)
    xq, xs, wg, gs, _, r = _i8_case(M, K, N, dev, seed=57)
    wu, us = _w(rng, K, N, dev)
    x = _t(rng.standard_normal((M, K)).astype(np.float32), dev,
           torch.float32 if variant == "qin_f32" else torch.bfloat16)

    def calls():
        if variant == "gated":
            return (cg.cim_gated_gemm_int8(xq, wg, wu, xs, gs, us, "gelu"),
                    *cg.cim_gated_gemm_int8(xq, wg, wu, xs, gs, us, "gelu",
                                            quantize_out=True))
        return (cg.cim_gemm_int8_fused_qin(x, wg, gs, residual=r),)
    for plan in cg.gemm_plans(M, K, N, variant):
        if plan.kind != "decode":
            continue
        with cg.forced_gemm_plan(plan.kind, plan.cluster):
            eager = calls()
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                captured = calls()
            for _ in range(2):
                graph.replay()
                torch.cuda.synchronize()
                for a, e in zip(captured, eager):
                    assert torch.equal(a, e), plan


def test_i8_decode_plans_replay_their_bits_from_a_graph(dev):
    """A CUDA-graph replay of each decode plan (clusters included)
    returns the eager launch's bits, for kernel 6 and for kernel 3 with
    and without the requant epilogue (its counters reset by the launch
    before the capture)."""
    xq, xs, w, ws, b, r = _i8_case(8, 5632, 2048, dev, seed=51)
    for plan in cg.gemm_plans(8, 5632, 2048):
        if plan.kind != "decode":
            continue
        with cg.forced_gemm_plan(plan.kind, plan.cluster):
            def calls():
                return (cg.cim_gemm_int8(xq, w),
                        cg.cim_gemm_int8_fused(xq, w, xs, ws, residual=r),
                        *cg.cim_gemm_int8_fused(xq, w, xs, ws,
                                                quantize_out=True))
            eager = calls()
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                captured = calls()
            for _ in range(2):
                graph.replay()
                torch.cuda.synchronize()
                for a, e in zip(captured, eager):
                    assert torch.equal(a, e), plan


def test_i8_shared_memory_matches_the_kernel_layout(dev):
    """The plan's byte count (``smem_bytes``, which the CPU tests hold)
    is the kernel's own ``i8_layout`` total, for both tile shapes of every
    variant at every cluster size and K from one step to gemma-2b's
    d_ff."""
    for variant in cg.VARIANTS:
        for K in (5, 128, 129, 1030, 2816, 16384):
            for M in (8, 16, 130):
                for c in cg.CLUSTERS:
                    kind = "decode" if M <= 16 else "prefill"
                    plan = cg._plan_of(kind, c, M, K, variant)
                    assert plan.smem == cg.kernel_smem_bytes(plan, K), \
                        (plan, K)


def test_paged_walk_above_one_block_runs_in_slices(dev):
    """ROADMAP C.9: an int8 paged walk at gemma-2b's heads (B 1, KH 1,
    G 8, D 256) over 12,000 blocks of 16 (192,000 slots, about 100 MB of
    K and V), past the 189,312 one block can plan, runs: the split walk
    and the combine, no paged walk, within the decode-attention rule of
    its plain version."""
    B, KH, G, D, bs, nb = 1, 1, 8, 256, 16, 12000
    S = nb * bs
    plan = da.walk_plan(S, D, G, torch.int8, "paged", bs=bs)
    assert plan.splits > 1
    rng = _gen(52)
    NB = nb + 1
    kp = _t(rng.integers(-127, 128, (NB, bs, KH, D)).astype(np.int8), dev)
    vp = _t(rng.integers(-127, 128, (NB, bs, KH, D)).astype(np.int8), dev)
    ksp = _t(rng.uniform(1e-3, 2e-2, (NB, bs, KH)).astype(np.float32), dev)
    vsp = _t(rng.uniform(1e-3, 2e-2, (NB, bs, KH)).astype(np.float32), dev)
    fill = S - 1000
    pos = np.full(S, 2 ** 30, np.int32)
    pos[:fill] = rng.permutation(fill)
    tables = np.zeros((B, nb), np.int32)
    tables[0] = rng.permutation(np.arange(1, NB))
    pp = np.full((NB, bs), 2 ** 30, np.int32)
    pp[tables[0]] = pos.reshape(nb, bs)
    pp, tables = _t(pp, dev), _t(tables, dev)
    q = _t(rng.standard_normal((B, KH, G, D)).astype(np.float32), dev,
           torch.bfloat16)
    qp = _t(np.array([fill - 1], np.int32), dev)
    launches = (da.decode_attention_paged.launches,
                da.decode_attention_partial.launches,
                da.decode_attention_combine.launches)
    out = da.decode_attention_paged(q, kp, vp, pp, tables, qp, ksp, vsp)
    torch.cuda.synchronize()
    assert (da.decode_attention_paged.launches,
            da.decode_attention_partial.launches,
            da.decode_attention_combine.launches) == (
        launches[0], launches[1] + 1, launches[2] + 1)
    ref = da.decode_attention_paged_plain(q.float(), kp, vp, pp, tables, qp,
                                          ksp, vsp).to(q.dtype).float()
    err = (out.float() - ref).abs()
    limit = _attn_limit(ref, q.dtype, kp.dtype)
    assert bool(torch.isfinite(out.float()).all())
    assert bool((err <= limit).all()), (err / limit).max().item()


# ---------------------------------------------------------------------------
# kernels 12-14: flash-attention prefill, the SSD scan, online softmax
# ---------------------------------------------------------------------------
def _close_rows(got, ref, rtol, row_atol, where):
    """|got - ref| <= rtol |ref| + row_atol x its row's largest |ref|."""
    got, ref = got.float(), ref.float()
    row = ref.abs().amax(-1, keepdim=True)
    limit = rtol * ref.abs() + row_atol * row + 1e-30
    err = (got - ref).abs()
    assert bool(torch.isfinite(got).all()), where
    assert bool((err <= limit).all()), (where, (err / limit).max().item())


# (B, Sq, Skv, H, KH, D, causal, window): ragged tails; a window that
# empties whole KV tiles; Sq != Skv both ways (top-left causal mask);
# rows with no visible key (window past the keys: uniform attention)
FLASH_SHAPES = [(2, 100, 100, 4, 2, 64, True, None),
                (1, 130, 130, 8, 1, 256, True, 40),
                (1, 200, 200, 4, 4, 128, False, 33),
                (1, 70, 150, 4, 4, 128, False, None),
                (1, 150, 70, 4, 2, 128, True, None),
                (1, 100, 40, 2, 1, 64, True, 16),
                (2, 64, 64, 2, 2, 48, True, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,H,KH,D,causal,window", FLASH_SHAPES)
def test_flash_attention_close(dev, dtype, B, Sq, Skv, H, KH, D, causal,
                               window):
    """Kernel 12 against its plain version: f32 within 2e-5 (summation
    order); bf16 within 2**-7 of the element plus 2**-7 of its row's
    largest |out| (p is rounded to bf16 against the running max in the
    kernel and against the row max in the plain version)."""
    from repro_torch.kernels import flash_attention as fa
    rng = _gen(20)
    q, k, v = (_t(rng.standard_normal(s).astype(np.float32), dev, dtype)
               for s in ((B, Sq, H, D), (B, Skv, KH, D), (B, Skv, KH, D)))
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    ref = fa.flash_attention_plain(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    tol = 2e-5 if dtype == torch.float32 else 2 ** -7
    _close_rows(out, ref, tol, tol, (B, Sq, Skv, H, KH, D, causal, window))


def test_flash_attention_empty_rows_attend_uniformly(dev):
    """Rows whose window holds no key average all of V, as the
    reference's dense oracle does."""
    from repro_torch.kernels import flash_attention as fa
    rng = _gen(21)
    q = _t(rng.standard_normal((1, 100, 2, 64)).astype(np.float32), dev)
    k, v = (_t(rng.standard_normal((1, 40, 1, 64)).astype(np.float32), dev)
            for _ in range(2))
    out = fa.flash_attention(q, k, v, causal=True, window=16)
    mean_v = v[0, :, 0].mean(0)
    torch.testing.assert_close(out[0, 55:, 0],
                               mean_v.expand(45, 64), rtol=1e-5, atol=1e-6)


# (B, Sq, Skv, H, KH, D, causal, window) for both bodies in bf16: D 64,
# 128 and 256 (and 48, a padded tile); Sq and Skv not multiples of 64,
# Sq != Skv both ways; G 1, 2 and 8; windows 1, 63 and 1024; rows with no
# visible key
BODY_SHAPES = [(2, 100, 100, 4, 2, 64, True, None),
               (1, 77, 130, 8, 1, 128, True, 1),
               (1, 130, 77, 8, 8, 256, False, 63),
               (1, 1000, 1000, 2, 1, 256, True, 1024),
               (2, 200, 333, 4, 4, 64, True, 63),
               (1, 300, 517, 16, 2, 128, True, None),
               (1, 100, 40, 2, 1, 64, True, 16),
               (1, 96, 96, 2, 2, 48, True, None)]


@pytest.mark.parametrize("body", ["mma", "fma"])
@pytest.mark.parametrize("B,Sq,Skv,H,KH,D,causal,window", BODY_SHAPES)
def test_flash_attention_bodies_close(dev, body, B, Sq, Skv, H, KH, D,
                                      causal, window):
    """Both bodies of kernel 12 in bf16, the tensor cores' (mma.sync) and
    the CUDA cores' f32 one, against the plain version: 2**-7 of the
    element plus 2**-7 of its row's largest |out|; one launch each."""
    from repro_torch.kernels import flash_attention as fa
    rng = _gen(24)
    q, k, v = (_t(rng.standard_normal(s).astype(np.float32), dev,
                  torch.bfloat16)
               for s in ((B, Sq, H, D), (B, Skv, KH, D), (B, Skv, KH, D)))
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=causal, window=window,
                             body=body)
    ref = fa.flash_attention_plain(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    _close_rows(out, ref, 2 ** -7, 2 ** -7,
                (body, B, Sq, Skv, H, KH, D, causal, window))


def test_flash_attention_tensor_core_body_spills_nothing(dev):
    """Every instantiation of the tensor-core body (tiles 64, 128 and 256
    wide) keeps its accumulators in registers: no local memory, no stack
    (``cuobjdump --dump-resource-usage``)."""
    import pathlib
    import re
    import subprocess
    from repro_torch.kernels import _build
    _build.load("flash_attention")
    tool = pathlib.Path(_build._nvcc()).parent / "cuobjdump"
    lib = _build.BUILD_DIR / "libflash_attention.so"
    text = subprocess.run([str(tool), "--dump-resource-usage", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    pat = re.compile(r"Function \S*flash_attention_mma_kernelILi(\d+)E"
                     r"\S*:\s*\n\s*(.*)")
    use = {int(m.group(1)): {k: int(v) for k, v in (
        f.split(":") for f in m.group(2).split()) if v.isdigit()}
        for m in pat.finditer(text)}
    assert sorted(use) == [64, 128, 256], use
    for dm, u in use.items():
        assert u["LOCAL"] == 0 and u["STACK"] == 0, (dm, u)
        assert u["REG"] <= 255, (dm, u)


def test_flash_attention_body_choice(dev):
    """bf16 with D % 8 == 0 (D 72: DiT-XL/2's heads; D 40 and 136 in the
    64- and 256-wide tiles) takes the tensor cores by default, f32 and other bf16 head sizes the CUDA cores; the
    tensor-core body refuses what it cannot take (f32, D 36), and a q
    that does not start 16-byte aligned."""
    from repro_torch.kernels import flash_attention as fa
    assert fa.body_for(torch.bfloat16, 256) == "mma"
    for d in (40, 72, 136):
        assert fa.body_for(torch.bfloat16, d) == "mma", d
    assert fa.body_for(torch.bfloat16, 36) == "fma"
    assert fa.body_for(torch.float32, 64) == "fma"
    q = torch.zeros((1, 8, 4, 64), device=dev)
    k = torch.zeros((1, 8, 2, 64), device=dev)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, k, body="mma")
    q36 = torch.zeros((1, 8, 4, 36), device=dev, dtype=torch.bfloat16)
    k36 = torch.zeros((1, 8, 2, 36), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention(q36, k36, k36, body="mma")
    fa.flash_attention(q36, k36, k36)
    q72 = torch.zeros((1, 8, 4, 72), device=dev, dtype=torch.bfloat16)
    k72 = torch.zeros((1, 8, 2, 72), device=dev, dtype=torch.bfloat16)
    fa.flash_attention(q72, k72, k72, causal=False, body="mma")
    flat = torch.zeros(1 + 8 * 4 * 64, device=dev, dtype=torch.bfloat16)
    qm = flat[1:].view(1, 8, 4, 64)
    kb = k.bfloat16()
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention(qm, kb, kb)
    torch.testing.assert_close(fa.flash_attention(qm, kb, kb, body="fma"),
                               fa.flash_attention_plain(qm, kb, kb))


# DiT-XL/2's attention (B 8 = 2 x 4 CFG rows, S 1024, H = KH 16, D 72,
# full), ragged lengths around the 64-row tiles, and a head size in each
# tile width the D % 8 gate opens (D 40: DM 64, 5 of its 8 chunks a row;
# D 72: DM 128; D 136: DM 256, 17 of 32), non-causal and causal
@pytest.mark.parametrize("B,S,H,D,causal", [
    (8, 1024, 16, 72, False), (2, 333, 4, 72, False), (1, 65, 3, 72, False),
    (2, 333, 4, 40, False), (2, 333, 4, 136, False), (2, 333, 4, 72, True),
    (1, 200, 2, 136, True)])
def test_flash_attention_head_dim_multiple_of_8(dev, B, S, H, D, causal):
    """Kernel 12 at a bf16 head size that is a multiple of 8 but not of
    16, on its tensor-core body (head dims past D zero-filled in the
    tile), against its plain version and against the CUDA-core body:
    2**-7 of the element plus 2**-7 of its row; the head's neighbours in
    memory do not leak into it (q, k, v cut from wider tensors whose
    other heads hold large values)."""
    from repro_torch.kernels import flash_attention as fa
    rng = _gen(25)
    wide = [_t(rng.standard_normal((B, S, H + 1, D)).astype(np.float32),
               dev, torch.bfloat16) for _ in range(3)]
    for w in wide:
        w[:, :, H] = 1e4
    q, k, v = (w[:, :, :H].contiguous() for w in wide)
    ref = fa.flash_attention_plain(q, k, v, causal=causal)
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=causal)
    fma = fa.flash_attention(q, k, v, causal=causal, body="fma")
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 2
    assert fa.body_for(q.dtype, D) == "mma"
    _close_rows(out, ref, 2 ** -7, 2 ** -7, ("mma", B, S, H, D, causal))
    _close_rows(fma, ref, 2 ** -7, 2 ** -7, ("fma", B, S, H, D, causal))


def test_gemm_adaln_bias_and_mlp_gelu_requant_at_dit_xl2(dev):
    """The plan's GEMMs at DiT-XL/2's new forms: kernel 2 on f32 input
    with the adaLN bias in its epilogue ([8, 1152] x [1152, 6912]),
    bitwise its plain version; kernel 3 with gelu and the in-kernel
    requant at the MLP up GEMM ([8192, 1152] x [1152, 4608]): the f32
    output within 1e-5 of the plain version, the codes and scales the
    row quantizer's of the kernel's own f32 output, and within one step
    of the plain version's."""
    rng = _gen(26)
    x = _t(rng.standard_normal((8, 1152)).astype(np.float32), dev)
    w, ws = _w(rng, 1152, 6912, dev)
    b = _t(rng.standard_normal(6912).astype(np.float32), dev)
    before = cg.cim_gemm_int8_fused_qin.launches
    out = cg.cim_gemm_int8_fused_qin(x, w, ws, bias=b)
    ref = cg.cim_gemm_int8_fused_qin_plain(x, w, ws, bias=b)
    torch.cuda.synchronize()
    assert cg.cim_gemm_int8_fused_qin.launches == before + 1
    assert torch.equal(out, ref)
    xq = _t(rng.integers(-127, 128, (8192, 1152)).astype(np.int8), dev)
    xs = _t(rng.uniform(1e-3, 1e-2, (8192, 1)).astype(np.float32), dev)
    wu, us = _w(rng, 1152, 4608, dev)
    h = cg.cim_gemm_int8_fused(xq, wu, xs, us, activation="gelu")
    hr = cg.cim_gemm_int8_fused_plain(xq, wu, xs, us, activation="gelu")
    q, s = cg.cim_gemm_int8_fused(xq, wu, xs, us, activation="gelu",
                                  quantize_out=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(h, hr, rtol=1e-5, atol=1e-6)
    qk, sk = cg.quantize_rows_int8_plain(h)
    assert torch.equal(q, qk) and torch.equal(s, sk)
    qr, _ = cg.quantize_rows_int8_plain(hr)
    assert (q.int() - qr.int()).abs().max().item() <= 1


def _dit_test_on_card(dev):
    from repro_torch.configs import get_dit_config
    from repro_torch.models.dit import DiTModel
    cfg = get_dit_config("dit-test")
    return cfg, DiTModel(cfg).init(0, device=dev).quantize()


def test_dit_forward_launches_seven_per_block(dev):
    """dit-test (f32) under the full plan on the card: a forward is 6
    plan launches and 1 of kernel 12 a block (whatever the depth), and
    agrees with the plain path (``kernel_mode(False)`` and explicit
    positions) within 1e-3 of its largest |out|."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.quant import kernel_mode
    cfg, m = _dit_test_on_card(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((3, 4, 8, 8), device=dev, generator=gen)
    tt = torch.tensor([999, 500, 0], device=dev)
    y = torch.tensor([0, 5, cfg.null_class], device=dev)
    reset_launch_counts()
    with torch.no_grad():
        out = m(x, tt, y)
        torch.cuda.synchronize()
        counts = launch_counts()
        pos = torch.arange(cfg.tokens, device=dev).expand(3, cfg.tokens)
        with kernel_mode(False):
            plain = m(x, tt, y, positions=pos)
    L = cfg.n_layers
    want = {"cim_gemm_int8_fused_qin": 3 * L, "quantize_rows_int8": L,
            "cim_gemm_int8_fused": 2 * L, "flash_attention": L}
    assert {k: v for k, v in counts.items() if v} == want, counts
    err = (out - plain).abs().max().item()
    assert err <= 1e-3 * plain.abs().max().item(), err


def test_dit_denoise_step_graph_replay_bitwise(dev):
    """One guided dit-test denoise evaluation (2B stacked rows) captured
    in a CUDA graph and replayed on new inputs: bitwise the eager
    evaluation on them."""
    from repro_torch.diffusion import guided_eps
    _, m = _dit_test_on_card(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((2, 4, 8, 8), device=dev, generator=gen)
    tt = torch.tensor([700, 700], device=dev, dtype=torch.int32)
    y = torch.tensor([1, 2], device=dev, dtype=torch.int32)
    with torch.no_grad():
        guided_eps(m, x, tt, y, 2.0)            # sizes every workspace
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = guided_eps(m, x, tt, y, 2.0)
        x.copy_(torch.randn((2, 4, 8, 8), device=dev, generator=gen))
        tt.fill_(300)
        graph.replay()
        torch.cuda.synchronize()
        eager = guided_eps(m, x, tt, y, 2.0)
    assert torch.equal(out, eager)


def test_long_forward_launches_kernel12_once_per_layer(dev):
    """Full-width gemma-2b (bf16, no plan) without caches: above 2048
    tokens, with the model's own positions, each of the 18 layers attends
    in one launch of kernel 12; at 2048 tokens, or with explicit
    positions, none.  The two S 4096 forwards' logits agree within 0.15
    (the port's logit tolerance), the argmax equal wherever the top-2
    margin is wider than twice that."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import Model
    cfg = get_config("gemma-2b")
    model = Model(cfg).init(0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (1, 4096), device=dev, generator=gen)
    pos = torch.arange(4096, device=dev)[None]
    outs = []
    for x, p, want in ((toks, None, cfg.n_layers), (toks, pos, 0),
                       (toks[:, :2048], None, 0)):
        before = fa.flash_attention.launches
        with torch.no_grad():
            outs.append(model(x, positions=p))
        torch.cuda.synchronize()
        assert fa.flash_attention.launches - before == want, x.shape
        assert bool(torch.isfinite(outs[-1]).all())
    kern, plain = outs[0], outs[1]
    assert (kern - plain).abs().max().item() <= 0.15
    top2 = plain.topk(2, dim=-1).values
    differ = kern.argmax(-1) != plain.argmax(-1)
    assert bool(((top2[..., 0] - top2[..., 1])[differ] <= 0.3).all())
    del model, outs, kern, plain
    torch.cuda.empty_cache()


# (BH, S, P, N, chunk): one chunk; many chunks with a ragged last one;
# P split over blocks with a ragged slice; N 128 at chunk 64
SSD_SHAPES = [(3, 128, 64, 64, 128), (2, 300, 40, 16, 64),
              (4, 256, 16, 8, 16), (1, 1000, 70, 64, 128),
              (2, 192, 32, 128, 64), (2, 37, 8, 4, 128)]


@pytest.mark.parametrize("BH,S,P,N,chunk", SSD_SHAPES)
def test_ssd_scan_close(dev, BH, S, P, N, chunk):
    """Kernel 13 against its plain version (the same chunked arithmetic
    in f32): y and the final state within 2e-4 relative plus 2e-4 of
    the tensor's largest magnitude (summation order)."""
    from repro_torch.kernels import ssd_scan as ss
    rng = _gen(22)
    dt = rng.uniform(1e-3, 1e-1, (BH, S, 1)).astype(np.float32)
    x = _t(dt * rng.standard_normal((BH, S, P)).astype(np.float32), dev)
    la = _t(-dt[..., 0] * rng.uniform(1, 16, (BH, 1)).astype(np.float32),
            dev)
    b, c = (_t(rng.standard_normal((BH, S, N)).astype(np.float32), dev)
            for _ in range(2))
    before = ss.ssd_scan.launches
    y, h = ss.ssd_scan(x, la, b, c, chunk=chunk)
    yr, hr = ss.ssd_scan_plain(x, la, b, c, chunk)
    torch.cuda.synchronize()
    assert ss.ssd_scan.launches == before + 1
    for got, ref in ((y, yr), (h, hr)):
        assert got.shape == ref.shape
        limit = 2e-4 * ref.abs() + 2e-4 * ref.abs().max()
        assert bool(((got - ref).abs() <= limit).all()), (
            BH, S, P, N, chunk, ((got - ref).abs() / limit).max().item())


# zamba2-1.2b's Mamba-2 layer at serve-zamba2's longest prompt: B 1 x 64
# heads, 1984 tokens (15 chunks of 128 and a ragged one of 64)
SSD_ZAMBA2 = (64, 1984, 64, 64, 128)


@pytest.mark.parametrize("BH,S,P,N,chunk", SSD_SHAPES + [SSD_ZAMBA2])
def test_ssd_scan_from_h0_per_group_close(dev, BH, S, P, N, chunk):
    """Kernel 13 in the model's layout (x [1, S, H, P] with H = BH, b and
    c [1, S, G, N] read per group: G 2 where H is even, else 1) from a
    nonzero initial state, against its plain version (b and c repeated
    per head): y and the final state within 2e-4 relative plus 2e-4 of
    the tensor's largest magnitude; one launch."""
    from repro_torch.kernels import ssd_scan as ss
    rng = _gen(24)
    H, G = BH, 2 if BH % 2 == 0 else 1
    dt = rng.uniform(1e-3, 1e-1, (1, S, H)).astype(np.float32)
    x = _t(dt[..., None] * rng.standard_normal((1, S, H, P)).astype(
        np.float32), dev)
    la = _t(-dt * rng.uniform(1, 16, H).astype(np.float32), dev)
    b, c = (_t(rng.standard_normal((1, S, G, N)).astype(np.float32), dev)
            for _ in range(2))
    h0 = _t(rng.standard_normal((1, H, P, N)).astype(np.float32), dev)
    before = ss.ssd_scan.launches
    y, h = ss.ssd_scan(x, la, b, c, chunk, h0)
    yr, hr = ss.ssd_scan_plain(x, la, b, c, chunk, h0)
    torch.cuda.synchronize()
    assert ss.ssd_scan.launches == before + 1
    for got, ref in ((y, yr), (h, hr)):
        assert got.shape == ref.shape
        limit = 2e-4 * ref.abs() + 2e-4 * ref.abs().max()
        assert bool(((got - ref).abs() <= limit).all()), (
            BH, S, P, N, chunk, ((got - ref).abs() / limit).max().item())


# registers of ssd_scan_kernel<VEC> (cuobjdump), VEC = float4 global
# access; a change to the kernel that moves them updates them here
SSD_REGS = {"true": 92, "false": 93}


def test_ssd_scan_registers_and_no_spill(dev):
    """Kernel 13's two instantiations keep their tiles in registers: no
    local memory and no stack, registers pinned."""
    import pathlib
    import re
    import subprocess
    from repro_torch.kernels import _build
    _build.load("ssd_scan")
    tool = pathlib.Path(_build._nvcc()).parent / "cuobjdump"
    lib = _build.BUILD_DIR / "libssd_scan.so"
    text = subprocess.run([str(tool), "--dump-resource-usage", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    pat = re.compile(r"Function \S*ssd_scan_kernelILb(\d)E\S*:\s*\n\s*(.*)")
    use = {("true" if m.group(1) == "1" else "false"): {
        k: int(v) for k, v in (f.split(":") for f in m.group(2).split())
        if v.isdigit()} for m in pat.finditer(text)}
    assert sorted(use) == ["false", "true"], text[-2000:]
    for vec, u in use.items():
        assert u["LOCAL"] == 0 and u["STACK"] == 0, (vec, u)
    assert {k: u["REG"] for k, u in use.items()} == SSD_REGS, use


def test_mamba2_block_on_card_matches_cpu(dev):
    """A Mamba-2 block (d 256, 8 SSM heads of 64, state 64, chunk 128) on
    the card (kernel 13 for the prefill, the recurrence for decode)
    against the same block on the CPU (the plain scan): a 300-token
    prefill from a nonzero cache, then 3 decode steps.  bf16 outputs
    within 2e-2 of the largest |output| (cuBLAS and the CPU round the
    bf16 projections apart), the f32 state within 1e-3 of its largest,
    the index exactly; one launch of kernel 13, in the prefill."""
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import ssm
    cfg = ssm.SSMConfig(state_dim=64, head_dim=64, expand=2, chunk=128)
    d = 256
    m_cpu = ssm.Mamba2(d, cfg, torch.bfloat16, "cpu")
    m_cpu.init_(torch.Generator().manual_seed(5))
    with torch.no_grad():
        m_cpu.dt_bias.normal_(0.0, 0.5, generator=torch.Generator()
                              .manual_seed(6))
    m_gpu = ssm.Mamba2(d, cfg, torch.bfloat16, dev)
    m_gpu.load_state_dict(m_cpu.state_dict())
    rng = _gen(25)
    x = rng.standard_normal((2, 303, d)).astype(np.float32)
    caches = []
    for where in ("cpu", dev):
        c = ssm.init_ssm_cache(2, d, cfg, device=where)
        c["ssm"].copy_(torch.as_tensor(
            0.3 * _gen(26).standard_normal(tuple(c["ssm"].shape)),
            dtype=torch.float32))
        caches.append(c)
    before = ss.ssd_scan.launches
    outs = []
    for m, c, where in ((m_cpu, caches[0], "cpu"), (m_gpu, caches[1], dev)):
        xs = _t(x, where, torch.bfloat16)
        with torch.no_grad():
            o = [ssm.mamba2_apply(m, xs[:, :300], cfg, c)]
            o += [ssm.mamba2_apply(m, xs[:, s:s + 1], cfg, c)
                  for s in range(300, 303)]
        outs.append(torch.cat(o, 1).float().cpu())
    torch.cuda.synchronize()
    assert ss.ssd_scan.launches == before + 1
    err = (outs[1] - outs[0]).abs().max().item()
    assert err <= 2e-2 * outs[0].abs().max().item(), err
    st = caches[0]["ssm"]
    assert (caches[1]["ssm"].cpu() - st).abs().max().item() <= \
        1e-3 * st.abs().max().item()
    assert caches[1]["index"].cpu().tolist() == [303, 303]
    assert torch.equal(caches[1]["conv"].cpu(), caches[0]["conv"]) or \
        (caches[1]["conv"].cpu().float() - caches[0]["conv"].float()).abs()\
        .max().item() <= 2 ** -8 * caches[0]["conv"].float().abs().max()\
        .item()


# (R, C, dtype, unaligned, launches): each regime of softmax_plan and its
# edges, the expected launches written out.  "warp" up to 1024 columns;
# "block" from 1025 when the rows fill the card (R 132, or a row under
# 2 x 2048 values); "cluster" at fewer rows (R 131) or rows one block
# cannot hold (above 32768 values: 16 blocks, the non-portable size, from
# 262145); "split" (two launches) above 524288.  Ragged C (single-value
# units) and x = y[1:] of a y whose rows do not divide into 16 bytes (x
# off 16-byte alignment).
F32, BF16 = torch.float32, torch.bfloat16
SOFTMAX_SHAPES = [(300, 64, F32, False, 1), (5, 1000, F32, False, 1),
                  (4, 1024, BF16, False, 1), (1000, 1025, F32, False, 1),
                  (3, 12288, F32, False, 1), (2, 12289, F32, False, 1),
                  (132, 4096, F32, False, 1), (131, 4096, F32, False, 1),
                  (1, 4095, F32, False, 1), (1, 4096, F32, False, 1),
                  (3, 50000, F32, False, 1), (4, 50000, BF16, False, 1),
                  (1, 262144, F32, False, 1), (1, 262145, F32, False, 1),
                  (1, 524288, F32, False, 1), (2, 524289, F32, False, 2),
                  (2, 600000, BF16, False, 2), (5, 1001, F32, True, 1),
                  (3, 12289, BF16, True, 1), (2, 524289, F32, True, 2)]


def _softmax_x(dev, R, C, dtype, unaligned, seed=23):
    """Scores N(0, 4) with an extreme row head [1e4, -1e4, 0, 1e4]; x[1:]
    of an [R + 1, C] tensor when ``unaligned``."""
    rng = _gen(seed)
    y = _t((rng.standard_normal((R + 1, C)) * 4).astype(np.float32), dev,
           dtype)
    y[1, :4] = torch.tensor([1e4, -1e4, 0.0, 1e4], device=dev).to(dtype)
    x = y[1:] if unaligned else y[:R]
    assert x.is_contiguous() and (x.data_ptr() % 16 != 0) == unaligned
    return x


@pytest.mark.parametrize("R,C,dtype,unaligned,launches", SOFTMAX_SHAPES)
def test_online_softmax_close(dev, R, C, dtype, unaligned, launches):
    """Kernel 14 against its plain version: f32 within 2e-5 relative
    plus 2e-6 of the largest output; bf16 within 2**-7 (one bf16
    rounding apart).  The launches of each regime: one, two for the
    split rows."""
    from repro_torch.kernels import online_softmax as sm
    x = _softmax_x(dev, R, C, dtype, unaligned)
    before = sm.online_softmax.launches
    out = sm.online_softmax(x)
    ref = sm.online_softmax_plain(x)
    torch.cuda.synchronize()
    assert sm.online_softmax.launches == before + launches
    assert out.dtype == dtype
    if dtype == torch.float32:
        limit = 2e-5 * ref.abs() + 2e-6 * ref.abs().max()
    else:
        limit = 2 ** -7 * ref.float().abs()
    err = (out.float() - ref.float()).abs()
    assert bool((err <= limit).all()), (R, C, (err / limit).max().item())
    torch.testing.assert_close(out.float().sum(-1),
                               torch.ones(R, device=dev), rtol=1e-2,
                               atol=0)


@pytest.mark.parametrize("R,C,dtype", [(300, 64, F32), (1000, 1025, F32),
                                       (8, 256000, F32), (8, 256000, BF16),
                                       (1, 262145, F32),
                                       (2, 600000, BF16)])
def test_online_softmax_graph_replay_is_its_eager_call(dev, R, C, dtype):
    """A CUDA-graph replay of each regime (warp, block, cluster of 8 and
    of 16, split) returns the eager call's bits."""
    from repro_torch.kernels import online_softmax as sm
    x = _softmax_x(dev, R, C, dtype, False, seed=29)
    eager = sm.online_softmax(x)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = sm.online_softmax(x)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)


def test_online_softmax_division_is_ieee(dev):
    """The kernels' division (the row's correctly rounded reciprocal and
    one remainder step, the IEEE division below 2^-100) is bitwise torch's
    p / d on 2^22 quotients: p in [0, 1) and down to subnormal exps, d in
    [1, 3e5] (a row's sums)."""
    from repro_torch.kernels import _launch
    n = 1 << 22
    g = torch.Generator(device=dev).manual_seed(31)
    p = torch.exp(-torch.rand(n, device=dev, generator=g) * 110)
    p[: n // 4] = torch.rand(n // 4, device=dev, generator=g)
    p[:16] = 0.0
    d = torch.rand(n, device=dev, generator=g) * 3e5 + 1
    q = torch.empty_like(p)
    fn = _launch.bind("online_softmax", "online_softmax_div_check",
                      [_launch.P, _launch.P, _launch.P, _launch.I,
                       _launch.P])
    _launch.check("online_softmax", fn(_launch.ptr(p), _launch.ptr(d),
                                       _launch.ptr(q), n, _launch.stream(p)),
                  "online_softmax_div_check")
    assert torch.equal(q, p / d)


# registers of kernel 14's bodies (cuobjdump), by (body, bytes of an
# element, 16-byte units): the block body within the 64 that 1024
# threads leave it
SOFTMAX_REGS = {("warp", 2, "0"): 48, ("warp", 2, "1"): 48,
                ("warp", 4, "0"): 48, ("warp", 4, "1"): 52,
                ("block", 2, "0"): 63, ("block", 2, "1"): 63,
                ("block", 4, "0"): 64, ("block", 4, "1"): 64,
                ("stats", 2, "0"): 31, ("stats", 2, "1"): 32,
                ("stats", 4, "0"): 32, ("stats", 4, "1"): 32,
                ("normalize", 2, "0"): 47, ("normalize", 2, "1"): 39,
                ("normalize", 4, "0"): 47, ("normalize", 4, "1"): 39}


def test_online_softmax_no_local_memory(dev):
    """Every instantiation of kernel 14 (the warp, block, stats and
    normalize bodies at f32 / bf16 x 16-byte / single-value units) keeps
    its values in registers: no local memory and no stack
    (``cuobjdump --dump-resource-usage``), registers pinned; the block
    body fits 1024 threads (64 registers)."""
    import pathlib
    import re
    import subprocess
    from repro_torch.kernels import _build
    _build.load("online_softmax")
    tool = pathlib.Path(_build._nvcc()).parent / "cuobjdump"
    lib = _build.BUILD_DIR / "libonline_softmax.so"
    text = subprocess.run([str(tool), "--dump-resource-usage", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    pat = re.compile(r"Function \S*softmax_(warp|block|stats|normalize)_"
                     r"kernelILi(\d)ELb(\d)E\S*:\s*\n\s*(.*)")
    use = {(m.group(1), int(m.group(2)), m.group(3)): {
        k: int(v) for k, v in (f.split(":") for f in m.group(4).split())
        if v.isdigit()} for m in pat.finditer(text)}
    assert sorted(use) == sorted(
        (body, xe, vec) for body in ("warp", "block", "stats", "normalize")
        for xe in (2, 4) for vec in ("0", "1")), text[-2000:]
    for key, u in use.items():
        assert u["LOCAL"] == 0 and u["STACK"] == 0, (key, u)
        if key[0] == "block":
            assert u["REG"] <= 64, (key, u)
    assert {k: u["REG"] for k, u in use.items()} == SOFTMAX_REGS, use


def test_new_kernel_wrappers_reject_bad_inputs(dev):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import online_softmax as sm
    from repro_torch.kernels import ssd_scan as ss
    q = torch.zeros((1, 8, 4, 64), device=dev)
    k = torch.zeros((1, 8, 2, 64), device=dev)
    fa.flash_attention(q, k, k)
    for exc, args in (
            (TypeError, (q, k.bfloat16(), k.bfloat16())),
            (TypeError, (q.half(), k.half(), k.half())),
            (ValueError, (q.transpose(1, 2).contiguous().transpose(1, 2),
                          k, k)),
            (ValueError, (q, torch.zeros((1, 8, 3, 64), device=dev),
                          torch.zeros((1, 8, 3, 64), device=dev))),
            (ValueError, (torch.zeros((1, 8, 2, 320), device=dev),
                          torch.zeros((1, 8, 2, 320), device=dev),
                          torch.zeros((1, 8, 2, 320), device=dev))),
            (ValueError, (q, k.cpu(), k.cpu()))):
        with pytest.raises(exc):
            fa.flash_attention(*args)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, k, window=0)
    x = torch.zeros((2, 64, 8), device=dev)
    la = torch.zeros((2, 64), device=dev)
    b = torch.zeros((2, 64, 4), device=dev)
    ss.ssd_scan(x, la, b, b, chunk=16)
    for exc, args, kw in (
            (TypeError, (x.bfloat16(), la, b, b), {}),
            (ValueError, (x, la[:, :32].contiguous(), b, b), {}),
            (ValueError, (x, la, b.transpose(0, 1).contiguous()
                          .transpose(0, 1), b), {}),
            (ValueError, (torch.zeros((2, 512, 8), device=dev),
                          torch.zeros((2, 512), device=dev),
                          torch.zeros((2, 512, 4), device=dev),
                          torch.zeros((2, 512, 4), device=dev)),
             {"chunk": 256}),
            (ValueError, (torch.zeros((1, 128, 8), device=dev),
                          torch.zeros((1, 128), device=dev),
                          torch.zeros((1, 128, 256), device=dev),
                          torch.zeros((1, 128, 256), device=dev)),
             {"chunk": 128})):
        with pytest.raises(exc):
            ss.ssd_scan(*args, **kw)
    s = torch.zeros((4, 100), device=dev)
    sm.online_softmax(s)
    for exc, arg in ((TypeError, s.half()), (ValueError, s[None]),
                     (ValueError, s.t().contiguous().t())):
        with pytest.raises(exc):
            sm.online_softmax(arg)


# ---------------------------------------------------------------------------
# the dense family beyond gemma-2b: kernel 12's prefix mode, the walks at
# its shapes, its blocks and forwards on the card
# ---------------------------------------------------------------------------
# (B, S, H, KH, D, prefix_len): p 0 (causal), on a tile edge (64), inside
# a tile (77, 150), past the sequence; ragged S; paligemma-3b's heads (8
# on 1 of 256), GQA and D 72 (the 128-wide tile)
PREFIX_SHAPES = [(1, 333, 8, 1, 256, 0), (1, 333, 8, 1, 256, 64),
                 (2, 517, 4, 2, 128, 77), (1, 200, 16, 2, 64, 150),
                 (1, 130, 2, 2, 72, 200)]


@pytest.mark.parametrize("body", ["mma", "fma"])
@pytest.mark.parametrize("B,S,H,KH,D,p", PREFIX_SHAPES)
def test_flash_attention_prefix_close(dev, body, B, S, H, KH, D, p):
    """Kernel 12 with ``prefix_len`` on both bodies against its plain
    version (keys before p visible to every query): 2**-7 of the element
    plus 2**-7 of its row's largest |out|, one launch; every q tile walks
    every KV tile below p (a query of the first tile sees the last key of
    the prefix)."""
    from repro_torch.kernels import flash_attention as fa
    rng = _gen(27)
    q, k, v = (_t(rng.standard_normal(s).astype(np.float32), dev,
                  torch.bfloat16)
               for s in ((B, S, H, D), (B, S, KH, D), (B, S, KH, D)))
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, body=body, prefix_len=p)
    ref = fa.flash_attention_plain(q, k, v, True, None, p)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    _close_rows(out, ref, 2 ** -7, 2 ** -7, (body, B, S, H, KH, D, p))
    if p:
        causal = fa.flash_attention_plain(q, k, v, True, None, 0)
        assert not torch.equal(ref[:, :min(p, S) - 1], causal[:, :min(p, S)
                                                              - 1])


def test_flash_attention_prefix_f32(dev):
    """The CUDA-core body in f32 with a prefix inside a tile: 2e-5."""
    from repro_torch.kernels import flash_attention as fa
    rng = _gen(28)
    q, k, v = (_t(rng.standard_normal(s).astype(np.float32), dev)
               for s in ((2, 150, 4, 64), (2, 150, 2, 64), (2, 150, 2, 64)))
    out = fa.flash_attention(q, k, v, prefix_len=45)
    ref = fa.flash_attention_plain(q, k, v, True, None, 45)
    _close_rows(out, ref, 2e-5, 2e-5, "f32 prefix 45")


# (B, S, KH, G, D, window): gemma3-4b's local layers (KH 4, G 2, D 256,
# window 1024 over 2048 slots: half the keys past the window),
# command-r-plus-104b's heads (96 on 8 KV: G 12, D 128), musicgen-medium's
# MHA (24 heads of 64: G 1)
FAMILY_WALKS = [(8, 2048, 4, 2, 256, 1024), (8, 1024, 8, 12, 128, None),
                (8, 1024, 24, 1, 64, None)]


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("B,S,KH,G,D,window", FAMILY_WALKS)
def test_decode_walks_at_family_shapes(dev, quantized, B, S, KH, G, D,
                                       window):
    """The ring walk (kernel 5) and the paged walk (kernel 11) at the
    family's decode shapes: paged bitwise the ring walk on the same
    logical cache, both within the decode-attention rule of the plain
    version."""
    q, k, v, pos, qp, ks, vs = _ring_case(dev, 29, B, S, KH, G, D,
                                          quantized, torch.bfloat16)
    tables, (kp, vp, pp, ksp, vsp) = _to_pages(30, 16, k, v, pos, ks, vs)
    ring = da.decode_attention(q, k, v, pos, qp, ks, vs, window=window)
    paged = da.decode_attention_paged(q, kp, vp, pp, tables, qp, ksp, vsp,
                                      window=window)
    torch.cuda.synchronize()
    assert torch.equal(paged, ring)
    wide = (lambda t: t) if quantized else (lambda t: t.float())
    ref = da.decode_attention_plain(q.float(), wide(k), wide(v), pos, qp, ks,
                                    vs, window=window).to(q.dtype).float()
    err = (ring.float() - ref).abs()
    limit = _attn_limit(ref, q.dtype, k.dtype)
    assert bool((err <= limit).all()), (err / limit).max().item()


def _family_pair(dev, arch):
    """The reduced ``arch`` under the full plan on the CPU and the same
    weights on the card."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import Model
    from repro_torch.quant import QuantPlan
    cfg = reduced_config(get_config(arch))
    cpu = Model(cfg).init(0, device="cpu").quantize(QuantPlan.full())
    card = Model(cfg).init(0, device="cpu").quantize(QuantPlan.full())
    return cfg, cpu, card.to(dev)


@pytest.mark.parametrize("arch", ["gemma3-4b", "command-r-plus-104b",
                                  "musicgen-medium", "paligemma-3b"])
def test_family_block_and_prefill_decode_on_card(dev, arch):
    """A qk_norm block (gemma3-4b, command-r-plus-104b), a layernorm block
    (command-r-plus-104b, musicgen-medium) and a prefix block
    (paligemma-3b) on the card against the same block on the CPU (plain
    versions): within 5% of the largest |out|; then an int8-KV prefill +
    decode step on the card, launches exact per layer, logits within 5%
    of the CPU's largest |logit|."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.model import block_apply
    cfg, cpu, card = _family_pair(dev, arch)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 16, cfg.d_model), generator=gen).bfloat16()
    pos = torch.arange(16).expand(2, 16)
    pfx = cfg.frontend_len if cfg.frontend == "vision" else None
    with torch.no_grad():
        want = block_apply(cpu.layers[1], cfg, x, pos, None, True, pfx)
        got = block_apply(card.layers[1], cfg, x.to(dev), pos.to(dev), None,
                          True, pfx).cpu()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 5e-2 * want.float().abs().max().item(), err
    lengths = torch.tensor([16, 11], dtype=torch.int32)
    if cfg.frontend == "audio":
        frames = torch.randn((2, 16, cfg.d_model), generator=gen)
        step = torch.randn((2, 1, cfg.d_model), generator=gen)
        ins, dec = dict(frame_embeddings=frames), dict(frame_embeddings=step)
        toks, nxt = None, None
    else:
        toks = torch.randint(0, cfg.vocab, (2, 16), generator=gen)
        nxt = torch.randint(0, cfg.vocab, (2, 1), generator=gen)
        ins = dec = {}
    outs = []
    for m, where in ((cpu, "cpu"), (card, dev)):
        c = m.init_cache(2, 64, kv_dtype="int8")

        def move(a, where=where):
            return None if a is None else a.to(where)
        with torch.no_grad():
            reset_launch_counts()
            a = m.prefill_padded(move(toks), c, move(lengths),
                                 **{k: move(v) for k, v in ins.items()})
            b = m.decode_step(move(nxt), c,
                              **{k: move(v) for k, v in dec.items()})
        outs.append((torch.cat([a, b], 1).cpu(), launch_counts()))
    (want, zero), (got, counts) = outs
    assert not any(zero.values())
    err = (got - want).abs().max().item()
    assert err <= 5e-2 * want.abs().max().item(), err
    per = 6 if cfg.d_ff <= 8192 else 7
    total = sum(counts.values())
    assert total == cfg.n_layers * (2 * (per - 1) + 1), counts
    assert counts["decode_attention"] == cfg.n_layers


def test_paligemma_long_forward_launches_prefix_kernel12(dev):
    """Reduced paligemma-3b (4 patches) without caches above 2048
    positions: each layer attends in one launch of kernel 12 in its
    prefix mode; with explicit positions (the blockwise path), none; the
    logits within 5% of the blockwise path's largest |logit|."""
    from repro_torch.kernels import flash_attention as fa
    cfg, _, card = _family_pair(dev, "paligemma-3b")
    gen = torch.Generator(device=dev).manual_seed(4)
    toks = torch.randint(0, cfg.vocab, (1, 2100), device=dev, generator=gen)
    pe = torch.randn((1, 4, cfg.frontend_dim), device=dev, generator=gen)
    S = 2104
    seen = []
    from types import SimpleNamespace
    from repro_torch.models import attention

    def spy(*a, **kw):
        seen.append(kw.get("prefix_len"))
        return fa.flash_attention(*a, **kw)
    attention._fa = SimpleNamespace(flash_attention=spy)
    try:
        before = fa.flash_attention.launches
        with torch.no_grad():
            kern = card(toks, patch_embeddings=pe)
            n = fa.flash_attention.launches - before
            plain = card(toks, patch_embeddings=pe,
                         positions=torch.arange(S, device=dev)[None])
    finally:
        attention._fa = fa
    assert seen == [4] * cfg.n_layers and n == cfg.n_layers
    err = (kern - plain).abs().max().item()
    assert err <= 5e-2 * plain.abs().max().item(), err


@pytest.mark.parametrize("H,D,Dv", [(4, 24, 16), (8, 192, 128)])
def test_mla_cacheless_attention_pads_v_for_kernel12(dev, H, D, Dv):
    """MLA's cacheless attention above 2048 tokens (q and k at D, v at Dv
    < D: deepseek-v3-smoke's 24 / 16 and the full 192 / 128): one launch
    of kernel 12 on the card with v padded to D, the output cut back to
    Dv: within 2**-7 of the element plus 2**-7 of its row's largest |out|
    of the kernel's plain version on the padded v (CPU), and within 2e-2
    (1 + |out|) of the blockwise path on the CPU (``chip_smoke.py``'s
    FLASH_DENSE_TOL: the blockwise path rounds p to bf16 against another
    running max)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import cacheless_attention
    S = 2100
    gen = torch.Generator().manual_seed(5)
    q, k = (torch.randn((1, S, H, D), generator=gen).bfloat16()
            for _ in range(2))
    v = torch.randn((1, S, H, Dv), generator=gen).bfloat16()
    pos = torch.arange(S)[None]
    blockwise = cacheless_attention(q, k, v, pos, "causal").float()
    plain = fa.flash_attention_plain(
        q, k, torch.nn.functional.pad(v, (0, D - Dv))).float()
    before = fa.flash_attention.launches
    got = cacheless_attention(q.to(dev), k.to(dev), v.to(dev), pos.to(dev),
                              "causal", aligned_positions=True)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.shape == (1, S, H, Dv)
    got = got.float().cpu()
    assert not bool(plain[..., Dv:].any())
    ref = plain[..., :Dv].abs()
    limit = 2 ** -7 * ref + 2 ** -7 * ref.amax(-1, keepdim=True)
    assert bool(((got - plain[..., :Dv]).abs() <= limit).all())
    assert bool(((got - blockwise).abs()
                 <= 2e-2 * (1 + blockwise.abs())).all())


def test_mla_model_on_card_matches_cpu(dev):
    """deepseek-v3-smoke under the full plan: the MLA + dense block on the
    card against the CPU within 5% of the largest |out|; the absorbed
    MLA prefill + decode on the card within 2**-7 of the largest |out|;
    an int8-KV ring prefill + decode step launches exactly the FFNs'
    kernels (3 a dense layer, 6 an MoE layer a forward; none for MLA)
    with finite logits; a cacheless forward above 2048 tokens launches
    kernel 12 once a layer."""
    from repro_torch.kernels import (flash_attention as fa, launch_counts,
                                     reset_launch_counts)
    from repro_torch.models import mla as tmla
    from repro_torch.models.model import block_apply
    cfg, cpu, card = _family_pair(dev, "deepseek-v3-671b")
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((2, 16, cfg.d_model), generator=gen).bfloat16()
    pos = torch.arange(16).expand(2, 16)
    with torch.no_grad():
        want = block_apply(cpu.layers[0], cfg, x, pos, None, True)
        got = block_apply(card.layers[0], cfg, x.to(dev), pos.to(dev), None,
                          True).cpu()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 5e-2 * want.float().abs().max().item(), err
        outs = []
        for m, where in ((cpu, "cpu"), (card, dev)):
            c = tmla.init_mla_cache(2, 32, cfg.mla, device=where)
            a = tmla.mla_apply(m.layers[1].mla, x.to(where), pos.to(where),
                               cfg.mla, cache=c)
            b = tmla.mla_apply(m.layers[1].mla, x[:, :1].to(where),
                               c["index"][:, None].clone(), cfg.mla,
                               cache=c)
            outs.append(torch.cat([a, b], 1).float().cpu())
        err = (outs[1] - outs[0]).abs().max().item()
        assert err <= 2 ** -7 * outs[0].abs().max().item(), err
        toks = torch.randint(0, cfg.vocab, (2, 16), generator=gen).to(dev)
        c = card.init_cache(2, 64, kv_dtype="int8")
        reset_launch_counts()
        a = card.prefill_padded(toks, c, torch.tensor([16, 11],
                                                      dtype=torch.int32))
        b = card.decode_step(a.argmax(-1), c)
        counts = launch_counts()
        assert bool(a.isfinite().all()) and bool(b.isfinite().all())
        per = {"mla/dense": 3, "mla/moe": 6}
        want_total = 2 * sum(per[f"mla/{f}"] for _, f in cfg.layer_specs())
        assert sum(counts.values()) == want_total, counts
        assert counts["cim_grouped_gated_gemm_int8"] == 2 * sum(
            f == "moe" for _, f in cfg.layer_specs())
        before = fa.flash_attention.launches
        toks = torch.randint(0, cfg.vocab, (1, 2100), generator=gen)
        assert bool(card(toks.to(dev)).isfinite().all())
        assert fa.flash_attention.launches - before == cfg.n_layers


def test_xlstm_on_card_matches_cpu(dev):
    """xlstm-350m-smoke: both blocks with a cache (a ragged 11-token
    prefill, then a decode step) on the card against the CPU: outputs
    within 2**-7 of the largest |out|, f32 states within 1e-4 of their
    largest |value| (the card's f32 sums and exp differ from the CPU's);
    a ring prefill + decode step launches no kernel and its logits are
    within 5% of the CPU's largest |logit|."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import Model
    from repro_torch.models import xlstm as txl
    cfg = reduced_config(get_config("xlstm-350m"))
    cpu = Model(cfg).init(0, device="cpu")
    card = Model(cfg).init(0, device="cpu").to(dev)
    gen = torch.Generator().manual_seed(7)
    x = torch.randn((2, 11, cfg.d_model), generator=gen).bfloat16()
    x1 = torch.randn((2, 1, cfg.d_model), generator=gen).bfloat16()
    for layer, kind in ((0, "mlstm"), (1, "slstm")):
        apply = getattr(txl, f"{kind}_block_apply")
        init = getattr(txl, f"init_{kind}_cache")
        res = []
        for m, where in ((cpu, "cpu"), (card, dev)):
            c = init(2, cfg.d_model, cfg.xlstm, device=where)
            blk = getattr(m.layers[layer], kind)
            with torch.no_grad():
                a = apply(blk, x.to(where), cfg.xlstm, c)
                b = apply(blk, x1.to(where), cfg.xlstm, c)
            res.append((torch.cat([a, b], 1).float().cpu(),
                        {n: v.cpu() for n, v in c.items()}))
        (want, wc), (got, gc) = res
        err = (got - want).abs().max().item()
        assert err <= 2 ** -7 * want.abs().max().item(), (kind, err)
        for name, v in wc.items():
            if v.dtype == torch.float32:
                e = (gc[name] - v).abs().max().item()
                assert e <= 1e-4 * v.abs().max().item(), (kind, name, e)
    toks = torch.randint(0, cfg.vocab, (2, 16), generator=gen)
    nxt = torch.randint(0, cfg.vocab, (2, 1), generator=gen)
    outs = []
    for m, where in ((cpu, "cpu"), (card, dev)):
        c = m.init_cache(2, 64)
        with torch.no_grad():
            reset_launch_counts()
            a = m.prefill_padded(toks.to(where), c,
                                 torch.tensor([16, 11], dtype=torch.int32))
            b = m.decode_step(nxt.to(where), c)
        outs.append((torch.cat([a, b], 1).cpu(), launch_counts()))
    (want, _), (got, counts) = outs
    assert not any(counts.values()), counts
    err = (got - want).abs().max().item()
    assert err <= 5e-2 * want.abs().max().item(), err


# ---------------------------------------------------------------------------
# the degraded mode: the finite screen and the gated fallback of kernels 1,
# 2, 3, 4, 7 and 8
# ---------------------------------------------------------------------------
def _flag(v, dev):
    return torch.tensor([v], dtype=torch.int32, device=dev)


def _poisoned(t, seed):
    """A copy of the float tensor ``t`` with a NaN, a +inf and a -inf at
    seeded places."""
    a = t.clone().reshape(-1)
    idx = _gen(seed).permutation(a.numel())[:3]
    for i, v in zip(idx.tolist(), (np.nan, np.inf, -np.inf)):
        a[i] = v
    return a.reshape(t.shape)


def _sentinel(shape, dtype, dev):
    return torch.full(shape, 77 if dtype == torch.int8 else 12345.0,
                      dtype=dtype, device=dev)


def _fallback_calls(dev, M, K, N, E, xdtype):
    """name -> (call(fn, gate, out), kernel, plain, out shapes and dtypes,
    exact) for kernels 1, 2, 3, 4, 7 and 8 on poisoned float operands, and
    kernel 6 (int8 operands only: its integers exact)."""
    rng = _gen(61)
    x = _poisoned(_t(rng.standard_normal((M, K)).astype(np.float32), dev,
                     xdtype), 1)
    xq = _t(rng.integers(-127, 128, (M, K)).astype(np.int8), dev)
    xs = _poisoned(_t(rng.uniform(1e-3, 1e-2, (M, 1)).astype(np.float32),
                      dev), 2) if M >= 3 else \
        _t(rng.uniform(1e-3, 1e-2, (M, 1)).astype(np.float32), dev)
    (w, ws), (w2, ws2) = _w(rng, K, N, dev), _w(rng, K, N, dev)
    ws, ws2 = _poisoned(ws, 3), _poisoned(ws2, 4)
    bias = _poisoned(_t(rng.standard_normal(N).astype(np.float32), dev), 5)
    res = _poisoned(_t(rng.standard_normal((M, N)).astype(np.float32), dev),
                    6)
    gx, gxs, [(gw, gws), (gw2, gws2)], counts = _grouped(rng, E, M, K, N,
                                                         dev, zero=(1,))
    gxs, gws, gws2 = _poisoned(gxs, 7), _poisoned(gws, 8), _poisoned(gws2, 9)
    gbias = _poisoned(_t(rng.standard_normal((E, N)).astype(np.float32), dev),
                      10)
    f32 = torch.float32
    return {
        "rowquant": (lambda fn, g, o: fn(x, gate=g, out=o),
                     cg.quantize_rows_int8, cg.quantize_rows_int8_plain,
                     [((M, K), torch.int8), ((M, 1), f32)], True),
        "qin": (lambda fn, g, o: fn(x, w, ws, bias, res, None, g, o),
                cg.cim_gemm_int8_fused_qin, cg.cim_gemm_int8_fused_qin_plain,
                [((M, N), f32)], True),
        "fused": (lambda fn, g, o: fn(xq, w, xs, ws, bias, res, None,
                                      gate=g, out=o),
                  cg.cim_gemm_int8_fused, cg.cim_gemm_int8_fused_plain,
                  [((M, N), f32)], True),
        "gated": (lambda fn, g, o: fn(xq, w, w2, xs, ws, ws2, "silu",
                                      gate=g, out=o),
                  cg.cim_gated_gemm_int8, cg.cim_gated_gemm_int8_plain,
                  [((M, N), f32)], False),
        "grouped": (lambda fn, g, o: fn(gx, gw, gxs, gws, gbias, counts,
                                        "gelu", gate=g, out=o),
                    cg.cim_grouped_gemm_int8, cg.cim_grouped_gemm_int8_plain,
                    [((E, M, N), f32)], False),
        "grouped_gated": (lambda fn, g, o: fn(gx, gw, gw2, gxs, gws, gws2,
                                              counts, "silu", gate=g, out=o),
                          cg.cim_grouped_gated_gemm_int8,
                          cg.cim_grouped_gated_gemm_int8_plain,
                          [((E, M, N), f32)], False),
        # kernel 6: a row-parallel site's partial under tensor parallelism
        "acc": (lambda fn, g, o: fn(xq, w, gate=g, out=o),
                cg.cim_gemm_int8, cg.cim_gemm_int8_plain,
                [((M, N), torch.int32)], True)}


def _check_fallback(dev, calls):
    """Flag 0: the sentinel outputs untouched bitwise, one launch counted
    a call (kernel 6's gated form also on its own counter).  Flag 1: the
    plain version on the sanitized operands, its integers exact, its
    floats bitwise or within the activations' 1e-5."""
    for name, (call, fn, plain, outs, exact) in calls.items():
        for v in (0, 1):
            got = [_sentinel(s, d, dev) for s, d in outs]
            want = [_sentinel(s, d, dev) for s, d in outs]
            before = fn.launches
            gated = cg.cim_gemm_int8.gated_launches
            call(fn, _flag(v, dev), got[0] if len(got) == 1 else tuple(got))
            call(plain, _flag(v, dev), want[0] if len(want) == 1
                 else tuple(want))
            torch.cuda.synchronize()
            assert fn.launches == before + 1, name
            assert cg.cim_gemm_int8.gated_launches == gated + (
                fn is cg.cim_gemm_int8), name
            for a, b in zip(got, want):
                assert torch.isfinite(a.float()).all(), (name, v)
                if v == 0 or exact or a.dtype == torch.int8:
                    assert torch.equal(a, b), (name, v)
                else:
                    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("M", [1, 8, 16, 130])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_fallback_gated_under_the_plan(dev, M, xdtype):
    _check_fallback(dev, _fallback_calls(dev, M, 1030, 264, 3, xdtype))


@pytest.mark.parametrize("M,kind,cluster", [(8, "decode", 1),
                                            (8, "decode", 5),
                                            (16, "prefill", 1),
                                            (130, "prefill", 3)])
def test_fallback_gated_under_forced_plans(dev, M, kind, cluster):
    """The fallback's tile shapes and clusters (rank 0 merging the ranks'
    sums) as the plain kernels' forced plans."""
    calls = _fallback_calls(dev, M, 2048, 512, 3, torch.float32)
    del calls["rowquant"]
    with cg.forced_gemm_plan(kind, cluster):
        _check_fallback(dev, calls)


def test_finite_screen_flags_and_counts(dev):
    """The screen over sizes 1 to 2^22, aligned and not (float4 or single
    loads, one block to the grid's cap): 0 on finite values, 1 with a
    NaN, +inf or -inf anywhere; each trip counted once; one launch a
    call."""
    trips = cg.screen_trips(dev)
    seen = 0
    for n in (1, 3, 4, 1027, 8 * 2048, 1 << 22):
        base = torch.randn(n + 1, device=dev)
        for x in (base[:n], base[1:]):
            before = cg.finite_screen.launches
            assert int(cg.finite_screen(x)) == 0
            for where in sorted({0, n // 2, n - 1}):
                for v in (float("nan"), float("inf"), float("-inf")):
                    bad = x.clone() if x.data_ptr() % 16 == 0 else \
                        base.clone()[1:]
                    bad[where] = v
                    assert int(cg.finite_screen(bad)) == 1, (n, where, v)
                    seen += 1
            assert int(cg.finite_screen(x)) == 0
            assert cg.finite_screen.launches == before + 2 + 3 * len(
                {0, n // 2, n - 1})
    assert cg.screen_trips(dev) == trips + seen


def test_degraded_layers_no_host_sync_and_trip(dev):
    """Under degraded mode the layers' screens and gated fallbacks make no
    host sync (CUDA sync debug mode "error"); healthy outputs are bitwise
    the mode-off ones, and with an inf scale the output equals the CPU
    fallback's."""
    from torch import nn

    from repro_torch.kernels import ref as kref
    from repro_torch.quant import QuantizedLinear, degraded_mode
    from repro_torch.quant import linear as ql
    rng = _gen(70)
    w, ws = _w(rng, 256, 512, dev)
    x = _t(rng.standard_normal((8, 256)).astype(np.float32), dev)
    mlp = nn.Module()
    for name, (K, N) in (("up", (256, 384)), ("gate", (256, 384)),
                         ("down", (384, 256))):
        setattr(mlp, name, QuantizedLinear(*_w(rng, K, N, dev)))
    moe = nn.Module()
    for name, (K, N) in (("up", (256, 128)), ("gate", (256, 128)),
                         ("down", (128, 256))):
        q, s = _t(rng.integers(-127, 128, (4, K, N)).astype(np.int8), dev), \
            _t(rng.uniform(1e-3, 2e-2, (4, N)).astype(np.float32), dev)
        setattr(moe, name, QuantizedLinear(q, s))
    xe = _t(rng.standard_normal((4, 8, 256)).astype(np.float32), dev)
    counts = _t(np.array([8, 0, 3, 8], np.int32), dev)

    def run(lin):
        return (ql.quantized_matmul(x, lin, use_kernel=True, residual=x[:, :1]
                                    .expand(8, 512).contiguous()),
                ql.quantized_mlp_apply(mlp, x, "gelu", use_kernel=True,
                                       residual=x),
                ql.quantized_moe_apply(moe, xe, "silu", use_kernel=True,
                                       expert_counts=counts))
    good = QuantizedLinear(w, ws)
    off = run(good)
    bad_s = ws.clone()
    bad_s[7] = float("inf")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with degraded_mode(True):
            on = run(good)
            tripped = run(QuantizedLinear(w, bad_s))[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    want = kref.fused_matmul_ref(x.cpu(), w.cpu(), torch.nan_to_num(
        bad_s.cpu(), 0.0, 0.0, 0.0), residual=x[:, :1].expand(8, 512).cpu())
    assert torch.isfinite(tripped).all()
    assert torch.equal(tripped.cpu(), want)


FALLBACK_KERNELS = {
    "i8": (r"cim_gemm_i8_fallback_kernelILi(\d)ELi(\d)EE", 12),
    "acc": (r"cim_gemm_i8_acc_fallback_kernelILi(\d)EE", 3),
    "grouped_i8": (r"cim_gemm_i8_grouped_fallback_kernelILi(\d)ELi(\d)EE",
                   6),
    "rowquant": (r"rowquant_fallback_kernelILi(\d)ELb([01])EE", 4)}


def test_fallback_kernels_spill_nothing(dev):
    """Every gated instantiation is in the fallback's library (3 tile
    shapes x 4 variants dense, x 2 grouped, kernel 6's 3; the row
    quantizer's 4), none is in the ungated one, and none spills; their
    registers are printed."""
    import pathlib
    import re
    import subprocess
    from repro_torch.kernels import _build
    tool = pathlib.Path(_build._nvcc()).parent / "cuobjdump"

    def dump(name):
        _build.load(name)
        return subprocess.run([str(tool), "--dump-resource-usage",
                               str(_build.BUILD_DIR / f"lib{name}.so")],
                              capture_output=True, text=True,
                              check=True).stdout
    text = dump("cim_gemm_fallback")
    assert "fallback_kernel" not in dump("cim_gemm")
    for kind, (name, count) in FALLBACK_KERNELS.items():
        found = {}
        for m in re.finditer(r"Function \S*" + name + r"\S*:\s*\n\s*(.*)",
                             text):
            *args, use = m.groups()
            found[tuple(map(int, args))] = {
                k: int(v) for k, v in (f.split(":") for f in use.split())
                if v.isdigit()}
        print(kind, {k: v["REG"] for k, v in sorted(found.items())})
        assert len(found) == count, (kind, sorted(found))
        for key, use in found.items():
            assert use["LOCAL"] == 0 and use["STACK"] == 0, (kind, key, use)


# ---------------------------------------------------------------------------
# observability and the launch audit on the card
# ---------------------------------------------------------------------------
# the registry's full-plan archs: a fact of the configs, not of the card
AUDIT_ARCHS = ("gemma-2b", "gemma3-4b", "deepseek-67b", "command-r-plus-104b",
               "paligemma-3b", "musicgen-medium", "qwen2-moe-a2.7b")


def test_audit_archs_are_the_full_plan_archs():
    from repro_torch.analysis import full_plan_archs
    assert sorted(full_plan_archs()) == sorted(AUDIT_ARCHS)


@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("arch", AUDIT_ARCHS)
def test_audit_lm_clean_on_card(dev, arch, phase, paged):
    """One smoke-config step on the card: the launch counters' deltas are
    the manifest's per-layer counts by counter and by site class, and the
    dtype flow outside the wrappers is clean."""
    from repro_torch.analysis import audit_lm
    rep = audit_lm(arch, phase, paged=paged, reduced=True, device=dev)
    assert rep.ok, rep.diff_lines()
    assert rep.n_dispatches > 0


@pytest.mark.parametrize("arch,kw", [
    ("gemma-2b", dict(tp=2)), ("qwen2-moe-a2.7b", dict(tp=2)),
    ("gemma3-4b", dict(kv_len=4096)), ("gemma-2b", dict(kv_len=4096))])
def test_audit_lm_tp_and_split_walk_on_card(dev, arch, kw):
    """A TP rank (one in-process rank: kernel 6 and the collectives) and
    the split walk above 2048 slots (gemma3-4b: its global layers only,
    ROADMAP C.15)."""
    from repro_torch.analysis import audit_lm
    rep = audit_lm(arch, "decode", reduced=True, device=dev, **kw)
    assert rep.ok, rep.diff_lines()
    if "kv_len" in kw:
        assert rep.launches["decode_attention_combine"] > 0


def test_audit_dit_clean_on_card(dev):
    """dit-test's evaluation on the card: the plan launches the manifest's
    per block, kernel 12 once a block outside the contract."""
    from repro_torch.analysis import audit_dit
    from repro_torch.configs import get_dit_config
    rep = audit_dit("dit-test", device=dev)
    assert rep.ok, rep.diff_lines()
    assert rep.launches["flash_attention"] == \
        get_dit_config("dit-test").n_layers


def _syncs(fn) -> int:
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
def test_obs_adds_no_device_sync(dev, paged):
    """A decode step with obs makes no more device-to-host syncs than one
    without: the hooks read host values only.  Same tokens either way."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import Model
    from repro_torch.obs import Observability
    from repro_torch.quant import QuantPlan
    from repro_torch.serving import (PagedServingEngine, Request,
                                     ServingEngine)
    model = Model(reduced_config(get_config("gemma-2b"))).init(0,
                                                                device=dev)
    rng = _gen(7)
    prompts = [rng.integers(1, 256, n).astype(np.int32) for n in (5, 9, 3)]
    counts, tokens = [], []
    for obs in (None, Observability()):
        cls = PagedServingEngine if paged else ServingEngine
        kw = dict(block_size=8, prefill_chunk=16) if paged else {}
        eng = cls(model, n_slots=3, max_len=64, prefill_bucket=16,
                  quant_plan=QuantPlan.full(), obs=obs, **kw)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.step()                 # prefills (+ the first decode)
        counts.append(_syncs(eng.step))
        eng.run_until_done()
        tokens.append([r.generated for r in reqs])
    assert counts[1] <= counts[0], counts
    assert tokens[0] == tokens[1]


# ---------------------------------------------------------------------------
# training: kernel 12's lse, the differentiable cacheless attention, the
# guard on kernels without a backward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("body", ["mma", "fma"])
@pytest.mark.parametrize("B,Sq,Skv,H,KH,D,causal,window", BODY_SHAPES)
def test_flash_attention_lse_close(dev, body, B, Sq, Skv, H, KH, D, causal,
                                   window):
    """Kernel 12 with ``return_lse`` on both bodies (bf16): the output
    bitwise the launch without ``lse`` (the write changes nothing else),
    the log-sum-exp within 1e-5 of the element plus 1e-5 of the largest
    |lse| of the plain version's (both sum f32 scores, in other orders),
    and 1e30 exactly on the same rows (no visible key)."""
    from repro_torch.kernels import flash_attention as fa
    rng = _gen(40)
    q, k, v = (_t(rng.standard_normal(s).astype(np.float32), dev,
                  torch.bfloat16)
               for s in ((B, Sq, H, D), (B, Skv, KH, D), (B, Skv, KH, D)))
    before = fa.flash_attention.launches
    plain_out = fa.flash_attention(q, k, v, causal=causal, window=window,
                                   body=body)
    out, lse = fa.flash_attention(q, k, v, causal=causal, window=window,
                                  body=body, return_lse=True)
    _, ref = fa.flash_attention_plain(q, k, v, causal, window,
                                      return_lse=True)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 2
    assert torch.equal(out, plain_out)
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    empty = ref == 1e30
    assert torch.equal(lse == 1e30, empty)
    got, want = lse[~empty], ref[~empty]
    limit = 1e-5 * want.abs() + 1e-5 * want.abs().max()
    assert bool(((got - want).abs() <= limit).all())


def test_flash_attention_lse_f32(dev):
    """The CUDA-core body in f32 with ``lse``, ragged, GQA: within 1e-5."""
    from repro_torch.kernels import flash_attention as fa
    rng = _gen(41)
    q, k, v = (_t(rng.standard_normal(s).astype(np.float32), dev)
               for s in ((2, 150, 4, 64), (2, 150, 2, 64), (2, 150, 2, 64)))
    out, lse = fa.flash_attention(q, k, v, prefix_len=45, return_lse=True)
    ref_out, ref = fa.flash_attention_plain(q, k, v, True, None, 45,
                                            return_lse=True)
    _close_rows(out, ref_out, 2e-5, 2e-5, "f32 prefix 45")
    torch.testing.assert_close(lse, ref, rtol=1e-5, atol=1e-5)


# (S, H, KH, D, Dv, kind, window, prefix): gemma-2b's causal layer just
# above the threshold, gemma3-4b's sliding one, paligemma-3b's prefix,
# DiT-XL/2's head size (D 72, no mask), MLA's D 192 with v at 128
TRAIN_ATTN_SHAPES = [(2304, 8, 1, 256, 256, "causal", None, None),
                     (2304, 8, 4, 256, 256, "sliding", 1024, None),
                     (2304, 8, 1, 256, 256, "prefix", None, 256),
                     (2304, 16, 16, 72, 72, "full", None, None),
                     (2304, 8, 8, 192, 128, "causal", None, None)]


@pytest.mark.parametrize("S,H,KH,D,Dv,kind,window,prefix", TRAIN_ATTN_SHAPES)
def test_cacheless_attention_grads_on_the_card(dev, S, H, KH, D, Dv, kind,
                                               window, prefix):
    """``cacheless_attention`` with inputs that need grad above 2048
    tokens: one launch of kernel 12 (with ``lse``) in the forward, the
    plain-torch backward; out and dq, dk, dv against plain autograd of
    kernel 12's plain version on the same bf16 inputs, within 2**-6 of
    each one's largest magnitude (the backward's p is unrounded f32, the
    plain version's PV rounds p to bf16, and both gradients round to
    bf16 at the end)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as attn_mod
    rng = _gen(42)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in (
        (1, S, H, D), (1, S, KH, D), (1, S, KH, Dv), (1, S, H, Dv))]
    q, k, v = (_t(a, dev, torch.bfloat16).requires_grad_()
               for a in arrs[:3])
    do = _t(arrs[3], dev, torch.bfloat16)
    pos = torch.arange(S, device=dev)[None]
    before = fa.flash_attention.launches
    out = attn_mod.cacheless_attention(q, k, v, pos, kind, window, True,
                                       prefix)
    assert fa.flash_attention.launches == before + 1
    out.backward(do)
    rq, rk, rv = (_t(a, dev, torch.bfloat16).requires_grad_()
                  for a in arrs[:3])
    want = fa.flash_attention_plain(
        rq, rk, torch.nn.functional.pad(rv, (0, D - Dv)),
        causal=kind != "full", window=window,
        prefix_len=prefix or 0)[..., :Dv]
    want.backward(do)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    for name, got, ref in (("out", out, want), ("dq", q.grad, rq.grad),
                           ("dk", k.grad, rk.grad), ("dv", v.grad, rv.grad)):
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= 2 ** -6 * ref.float().abs().max().item(), (name, err)


def test_remat_train_step_launches_kernel_12_twice_a_layer(dev):
    """gemma-2b-smoke with remat at 2112 tokens through the port's train
    step on the card: kernel 12 launches in each layer's forward and its
    recompute (2 a layer a microbatch, none other), the loss is finite
    and every weight moved."""
    import dataclasses
    from repro_torch import optim
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data import for_model
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import Model
    cfg = dataclasses.replace(reduced_config(get_config("gemma-2b")),
                              remat=True)
    model = Model(cfg).init(0, device=dev)
    step = build_train_step(cfg, model)
    state = optim.init(optim.AdamWConfig(), step.params)
    before = {k: p.detach().clone() for k, p in step.params.items()}
    reset_launch_counts()
    met = step(state, for_model(cfg, 4, 2112, seed=0).batch_at(0))
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {k: 0 for k in counts}
    want["flash_attention"] = cfg.train_microbatches * cfg.n_layers * 2
    assert counts == want
    assert np.isfinite(float(met["loss"]))
    assert all(not torch.equal(before[k], p) for k, p in
               step.params.items())


@pytest.mark.parametrize("layout", ["model", "flat"])
def test_ssd_scan_function_on_the_card(dev, layout):
    """``SSDScan`` on the card: one launch of kernel 13 a forward and
    none in the backward; y and the final state within 2e-4 of their
    largest |value| (the kernel's tolerance) and dx, dlog_a, db, dc, dh0
    within 1e-4 of each one's largest |value| (the same chunked
    recompute in f32, summed in other orders) of the Function on CPU
    copies (its plain forward).  A zamba2 layer's widths (P = N = 64,
    chunk 128), S 300 (a ragged last chunk), from an initial state; the
    model's layout with b and c per group (H 8 on G 2), and flattened
    heads."""
    from repro_torch.kernels import ssd_scan as ss
    rng = _gen(44)
    B, S, H, G, P, N = (2, 300, 8, 2, 64, 64) if layout == "model" else (
        6, 300, 1, 1, 64, 64)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H))))
    arrs = [rng.standard_normal((B, S, H, P)) * dt[..., None],
            -dt * np.arange(1, H + 1), rng.standard_normal((B, S, G, N)),
            rng.standard_normal((B, S, G, N)),
            rng.standard_normal((B, H, P, N)),
            rng.standard_normal((B, S, H, P)),
            rng.standard_normal((B, H, P, N))]
    if layout == "flat":
        arrs = [a.squeeze(1 if i in (4, 6) else 2)
                for i, a in enumerate(arrs)]
    arrs = [a.astype(np.float32) for a in arrs]
    out = {}
    for where in ("cpu", dev):
        ins = [_t(a, where).requires_grad_() for a in arrs[:5]]
        before = ss.ssd_scan.launches
        y, final = ss.SSDScan.apply(*ins[:4], 128, ins[4])
        launched = ss.ssd_scan.launches - before
        torch.autograd.backward([y, final], [_t(arrs[5], where),
                                             _t(arrs[6], where)])
        if where != "cpu":
            torch.cuda.synchronize()
            assert launched == 1 and ss.ssd_scan.launches == before + 1
        out[str(where)] = [y, final] + [i.grad for i in ins]
    for i, (got, want) in enumerate(zip(out[str(dev)], out["cpu"])):
        tol = 2e-4 if i < 2 else 1e-4
        err = (got.detach().cpu() - want.detach()).abs().max().item()
        assert err <= tol * want.detach().abs().max().item(), (i, err)


def test_zamba2_smoke_train_step_on_the_card(dev):
    """zamba2-smoke with remat at 2112 tokens through the port's train
    step on the card: kernel 13 in each Mamba-2 layer's forward and its
    recompute, kernel 12 with ``lse`` likewise in each attention layer
    (2 a layer a microbatch each, none other), the loss finite and every
    weight moved."""
    import dataclasses
    from repro_torch import optim
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data import for_model
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import Model
    cfg = dataclasses.replace(reduced_config(get_config("zamba2-1.2b")),
                              remat=True)
    model = Model(cfg).init(0, device=dev)
    step = build_train_step(cfg, model)
    state = optim.init(optim.AdamWConfig(), step.params)
    before = {k: p.detach().clone() for k, p in step.params.items()}
    reset_launch_counts()
    met = step(state, for_model(cfg, 4, 2112, seed=0).batch_at(0))
    torch.cuda.synchronize()
    counts = launch_counts()
    mixers = [m for m, _ in cfg.layer_specs()]
    want = {k: 0 for k in counts}
    want["ssd_scan"] = cfg.train_microbatches * mixers.count("mamba2") * 2
    want["flash_attention"] = cfg.train_microbatches * mixers.count(
        "attn") * 2
    assert counts == want and want["ssd_scan"] > 0
    assert np.isfinite(float(met["loss"]))
    assert np.isfinite(float(met["grad_norm"]))
    assert all(not torch.equal(before[k], p) for k, p in
               step.params.items())


def test_guard_refuses_training_through_kernels_without_a_backward(dev):
    """On the card, kernels 1-4 and 13 refuse an input that requires grad
    under grad mode, naming the kernel; under ``no_grad`` they launch."""
    from repro_torch.kernels import ssd_scan as ss
    rng = _gen(43)
    x = _t(rng.standard_normal((8, 256)).astype(np.float32), dev)
    w, s = _w(rng, 256, 128, dev)
    xq, xs = cg.quantize_rows_int8(x)
    xs = xs.clone().requires_grad_()
    xg = x.clone().requires_grad_()
    calls = {
        "quantize_rows_int8": lambda: cg.quantize_rows_int8(xg),
        "cim_gemm_int8_fused_qin": lambda: cg.cim_gemm_int8_fused_qin(
            xg, w, s),
        "cim_gemm_int8_fused": lambda: cg.cim_gemm_int8_fused(xq, w, xs, s),
        "cim_gated_gemm_int8": lambda: cg.cim_gated_gemm_int8(
            xq, w, w, xs, s, s),
        "ssd_scan": lambda: ss.ssd_scan(
            _t(rng.standard_normal((2, 64, 16)).astype(np.float32),
               dev).requires_grad_(),
            -_t(rng.random((2, 64)).astype(np.float32), dev),
            _t(rng.standard_normal((2, 64, 8)).astype(np.float32), dev),
            _t(rng.standard_normal((2, 64, 8)).astype(np.float32), dev),
            chunk=16),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name}: the kernel has no"):
            call()
        with torch.no_grad():
            call()
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the launch layer on the card
# ---------------------------------------------------------------------------
def test_dryrun_all_allocates_nothing_on_card(dev, tmp_path):
    """``dryrun --all --grid 1x1``: every cell built on meta, 0 failed,
    and the card's allocated bytes unchanged; ``fits_card`` read from
    the card's total."""
    import json
    from repro_torch.launch import dryrun
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    assert dryrun.main(["--all", "--grid", "1x1", "--out", str(tmp_path),
                        "--quiet"]) == 0
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before
    rec = json.loads((tmp_path / "gemma-2b__decode_32k__1x1.json")
                     .read_text())
    assert rec["card_bytes"] == torch.cuda.mem_get_info()[1]
    assert rec["fits_card"] == (rec["memory"]["argument_bytes_per_device"]
                                <= rec["card_bytes"])


def test_pipeline_two_ranks_bitwise_on_card(dev):
    """gemma-2b-smoke's 4 blocks as 2 GPipe stages (gloo ranks sharing
    the card, each drawing only its layers, the full plan): every rank's
    output bitwise the 4 blocks in sequence on the same microbatches."""
    import torch_pp_ranks as ranks
    from repro_torch.models import Model
    from repro_torch.parallel.context import spawn
    from repro_torch.parallel.pipeline import block_stage_fn
    from repro_torch.quant import QuantPlan
    seed, micro = 5, 4
    x = _gen(seed).standard_normal((8, 16, 64)).astype(np.float32)
    case = dict(seed=seed, full=True, x=x, microbatches=micro,
                device="cuda")
    res = spawn(ranks.run_cases, 2, args=({"b": ("blocks", case)},))
    cfg = ranks.smoke_cfg()
    model = Model(cfg).init(seed, device=dev).quantize(QuantPlan.full())
    xt = _t(x, dev, torch.bfloat16)
    stage = block_stage_fn(cfg)
    seq = torch.cat([stage(model.layers, mx)
                     for mx in xt.reshape(micro, 2, 16, 64)])
    want = ranks.bits(seq.cpu())
    for r in res:
        assert r["b"]["hops"] == micro
        np.testing.assert_array_equal(r["b"]["out"], want)


def test_decode_bundle_split_walk_gives_the_plain_paths_tokens(dev):
    """``build_decode_step`` on gemma-2b-smoke (full plan, int8 ring of
    4096 slots: the split walk and the combine) after a 3000-token
    prefill: its greedy tokens over 8 steps equal the plain path's
    (``kernel_mode(False)``) fed the same way."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import build_decode_step
    from repro_torch.quant import QuantPlan, kernel_mode
    cfg = dataclasses.replace(reduced_config(get_config("gemma-2b")),
                              kv_cache_dtype="int8")
    bundle = build_decode_step(cfg)
    model = bundle.model.init(7, device=dev).quantize(QuantPlan.full())
    prompt = _t(_gen(7).integers(0, cfg.vocab, (2, 3000)), dev)

    def run(plain):
        cache = model.init_cache(2, 4096)
        toks = []
        with torch.no_grad(), kernel_mode(False if plain else None):
            logits = model.prefill_padded(prompt, cache,
                                          torch.tensor([3000, 2500]))
            for _ in range(8):
                nxt = logits[:, -1].argmax(-1).to(torch.int32)
                toks.append(nxt.tolist())
                logits, cache = bundle.fn({"inputs": nxt[:, None]}, cache)
        return toks

    reset_launch_counts()
    kern = run(False)
    counts = launch_counts()
    assert counts["decode_attention_partial"] == 8 * cfg.n_layers
    assert counts["decode_attention_combine"] == 8 * cfg.n_layers
    assert run(True) == kern
