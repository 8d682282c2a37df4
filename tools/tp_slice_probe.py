#!/usr/bin/env python3
"""Two facts that keep the vocabulary- and sequence-cut serving paths
bitwise the unsharded ones, read on one NVIDIA GPU.

    python3 tools/tp_slice_probe.py

Builds only the decode-attention kernels and prints:

- ``[gemm]``: the bf16 logits product (``models.layers.embedding_attend``
  tied, ``lm_head_apply`` untied) on each half of the vocabulary's rows
  (columns) against the whole product's columns, at gemma-2b's,
  paligemma-3b's, deepseek-v3's and qwen2-moe's heads and 1, 4 and 8
  rows: how many logits differ, the largest difference and the largest
  |logit|;
- ``[k9]``: kernel 9 on each half of a ring of 8192, 1024 and 128 int8
  slots (gemma-2b's one KV head, 8 query rows, D 256) with the whole
  ring's cluster (``cluster_slots``) and without, each merged by kernel
  10, against the unsharded walk in twice the rank's splits: whether
  the merged output is that walk's bit for bit, whether the raw
  partials are (a rank with no visible slot in a row emits an
  all-masked row's state, which kernel 10 weighs to zero), the largest
  difference from the plain version, and the cluster sizes of the
  whole ring and of a rank's half.

Exits 2 without a GPU.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tp_slice_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    _build.sources = lambda: [p for p in sorted(_build.CSRC.glob("*.cu"))
                              if p.stem == "decode_attention"]
    t0 = time.time()
    _build.build_all()
    print(f"[build] decode_attention.cu in {time.time() - t0:.1f} s")
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    from repro_torch.models import layers
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(
            torch.bfloat16)

    for name, V, d, tied in (("gemma-2b", 256000, 2048, True),
                             ("paligemma-3b", 257216, 2048, True),
                             ("deepseek-v3", 129280, 7168, False),
                             ("qwen2-moe", 151936, 2048, False)):
        W = rnd(V, d) if tied else rnd(d, V, scale=d ** -0.5)
        for B in (1, 4, 8):
            x = rnd(B, 1, d)
            whole = (layers.embedding_attend(W, x) if tied
                     else layers.lm_head_apply(W, x))
            diffs = []
            for r in range(2):
                rows = slice(r * V // 2, (r + 1) * V // 2)
                part = (layers.embedding_attend(W[rows].contiguous(), x)
                        if tied else layers.lm_head_apply(
                            W[:, rows].contiguous(), x))
                w = whole[..., rows]
                diffs.append((int((part != w).sum()),
                              float((part - w).abs().max()),
                              float(w.abs().max())))
            print(f"[gemm] {name} B{B}: (differing, max |diff|, max "
                  f"|logit|) by half {diffs}", flush=True)
        del W
        torch.cuda.empty_cache()

    B, KH, G, D = 8, 1, 8, 256
    for S in (8192, 1024, 128):
        for visible in (None, [40, 300, 5000 % S, S - 1, 10, 64, 63, 2]):
            q = rnd(B, KH, G, D)
            k, v = (torch.randint(-127, 128, (B, S, KH, D), device=dev,
                                  dtype=torch.int8, generator=g)
                    for _ in range(2))
            ks, vs = (torch.rand(B, S, KH, device=dev, generator=g) * 0.02
                      for _ in range(2))
            qp = torch.tensor(visible or [S - 1 - 37 * b for b in range(B)],
                              device=dev, dtype=torch.int32)
            pos = torch.arange(S, device=dev, dtype=torch.int32).expand(
                B, S)
            pos = torch.where(pos <= qp[:, None], pos,
                              torch.full_like(pos, 2 ** 30)).contiguous()
            L = S // 2
            ns = ops.n_splits_for(L)
            o, m, l = da.decode_attention_partial(q, k, v, pos, qp, ks, vs,
                                                  n_splits=2 * ns)
            want = da.decode_attention_combine(o, m, l, q.dtype)

            def merged(cluster_slots):
                parts = [da.decode_attention_partial(
                    q, *(t[:, r * L:(r + 1) * L].contiguous()
                         for t in (k, v, pos)), qp,
                    *(t[:, r * L:(r + 1) * L].contiguous()
                      for t in (ks, vs)), n_splits=ns,
                    cluster_slots=cluster_slots) for r in range(2)]
                cat = [torch.cat([p[i] for p in parts], 2).contiguous()
                       for i in range(3)]
                return cat, da.decode_attention_combine(*cat, q.dtype)
            (o2, m2, l2), got = merged(S)
            _, got_own = merged(None)
            plain = ops.ref.decode_attention_ref(
                q.cpu(), k.cpu(), v.cpu(), pos.cpu(), qp.cpu(),
                k_scale=ks.cpu(), v_scale=vs.cpu())
            print(f"[k9] S {S} {'rows cut short' if visible else 'full'}: "
                  f"merged == unsharded {torch.equal(got, want)}, without "
                  f"cluster_slots {torch.equal(got_own, want)}; partials "
                  f"equal {torch.equal(o2, o)} {torch.equal(m2, m)} "
                  f"{torch.equal(l2, l)}; max |diff| from the plain "
                  f"version {float((got.float().cpu() - plain).abs().max()):.3g};"
                  f" clusters {da.cluster_for(S, D)} (ring), "
                  f"{da.cluster_for(L, D)} (a half)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
