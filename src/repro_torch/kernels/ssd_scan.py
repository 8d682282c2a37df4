"""Chunked SSD (Mamba-2) scan (port of ``repro/kernels/ssd_scan.py``,
with the initial state of ``repro/models/ssm.py::ssd_chunked``).

The state-space dual form, one chunk at a time: inside a chunk the
output is ``(C·Bᵀ ∘ L)·X`` plus the entering state's ``exp(cum) · C·hᵀ``;
the state ``h [P, N]`` then decays by the chunk's total and takes
``(X ∘ decay)ᵀ·B``.  The state starts at ``h0`` (zeros when None).  The
CUDA body is ``csrc/ssd_scan.cu``: one block per (head, chunk), the
chunk states passed on by a look-back inside the one launch; its note
says how.  The wrapper takes its plain version for CPU tensors; for
CUDA tensors it launches the kernel or raises, and counts the launch.

Two layouts, f32 throughout:

* flattened heads (the ops surface, the reference kernel's):
  x [BH, S, P], log_a [BH, S], b and c [BH, S, N], h0 [BH, P, N];
* the model's (``ssd_chunked``'s): x [B, S, H, P], log_a [B, S, H], b
  and c [B, S, G, N] per group (head h reads group h // (H // G), as
  ``jnp.repeat`` broadcasts them), h0 [B, H, P, N].

y comes back in x's layout and dtype, the final state as h0's layout.
``chunk`` is the reference's chunk length; a ragged last chunk is
shorter and exact (the reference pads S to a multiple of it, with zeros
that change nothing).

Training takes :class:`SSDScan` (:func:`ssd_scan_trainable` picks it
when autograd would differentiate the scan): the kernel's forward, and
the reference's gradient, autograd of its chunked form
(:func:`ssd_chunked`) recomputed from the inputs in plain f32 torch.
The kernel has no backward of its own, as the reference's has none.
"""
from __future__ import annotations

from typing import Optional

import torch

from ._launch import I, bind, check, on_cpu, ptr, require, stream
from ._launch import P as PTR

# the kernel holds one chunk of b, c and C·Bᵀ in shared memory: at most
# 128 positions, and what a block may hold on the card (227 KiB)
MAX_CHUNK = 128
SMEM_LIMIT = 232448

_LIB = "ssd_scan"


def _dims(x, log_a, b, c, h0) -> tuple[int, int, int, int, int, int]:
    """(B, S, H, G, P, N) of either layout; raises on a shape that does
    not fit it."""
    if x.dim() == 3:
        B, S, P = x.shape
        H = G = 1
        N = b.shape[-1] if b.dim() == 3 else -1
        shapes = {"log_a": (B, S), "b": (B, S, N), "c": (B, S, N),
                  "h0": (B, P, N)}
    elif x.dim() == 4:
        B, S, H, P = x.shape
        G, N = (b.shape[2], b.shape[3]) if b.dim() == 4 else (1, -1)
        shapes = {"log_a": (B, S, H), "b": (B, S, G, N),
                  "c": (B, S, G, N), "h0": (B, H, P, N)}
    else:
        raise ValueError(f"x: expected [BH, S, P] or [B, S, H, P], got "
                         f"shape {tuple(x.shape)}")
    for name, t in (("log_a", log_a), ("b", b), ("c", c), ("h0", h0)):
        if t is not None and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{shapes[name]}")
    if N < 1 or G < 1 or H % G:
        raise ValueError(f"ssd_scan: N={N} and G={G} must be positive "
                         f"and G must divide H={H}")
    return B, S, H, G, P, N


def _sums_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain forms' arithmetic: f32, or f64 for f64 inputs (the
    gradient checks run them in f64)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _exp_segsum(a: torch.Tensor) -> torch.Tensor:
    """[..., T] -> [..., T, T]: ``exp(cum_t - cum_s)`` for ``s <= t``, 0
    above the diagonal (the reference's ``exp(_segsum(a))``).  The
    exponent is masked before the exp: above the diagonal it is positive
    and may overflow, and an inf there would make a NaN of the
    gradient."""
    T = a.shape[-1]
    cum = torch.cumsum(a, -1)
    tri = torch.ones((T, T), dtype=torch.bool, device=a.device).tril()
    seg = torch.where(tri, cum[..., :, None] - cum[..., None, :], 0.0)
    return torch.where(tri, torch.exp(seg), 0.0)


def _plain_flat(x, log_a, b, c, chunk, h0):
    """The reference kernel's body on flattened heads, chunk by chunk,
    in f32 (f64 for f64 inputs)."""
    BH, S, P = x.shape
    N = b.shape[-1]
    chunk = min(chunk, S)
    f = _sums_dtype(x)
    h = (torch.zeros((BH, P, N), dtype=f, device=x.device)
         if h0 is None else h0.to(f).clone())
    ys = []
    for c0 in range(0, S, chunk):
        xs = x[:, c0:c0 + chunk].to(f)
        la = log_a[:, c0:c0 + chunk].to(f)
        bs = b[:, c0:c0 + chunk].to(f)
        cs = c[:, c0:c0 + chunk].to(f)
        cum = torch.cumsum(la, -1)                              # [BH, L]
        cb = torch.matmul(cs, bs.transpose(1, 2))               # [BH, t, s]
        y = torch.matmul(cb * _exp_segsum(la), xs)
        y = y + torch.exp(cum)[..., None] * torch.matmul(cs,
                                                         h.transpose(1, 2))
        ys.append(y)
        decay_out = torch.exp(cum[:, -1:] - cum)                # [BH, L]
        h = torch.exp(cum[:, -1])[:, None, None] * h + torch.matmul(
            (xs * decay_out[..., None]).transpose(1, 2), bs)
    return torch.cat(ys, 1).to(x.dtype), h


def ssd_scan_plain(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, chunk: int = 128,
                   h0: Optional[torch.Tensor] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version, in either layout: the model's layout is
    flattened to one row per (batch, head), b and c repeated per head."""
    B, S, H, G, P, N = _dims(x, log_a, b, c, h0)
    if x.dim() == 3:
        return _plain_flat(x, log_a, b, c, chunk, h0)

    def flat(t):                     # [B, S, H, K] -> [B * H, S, K]
        return t.transpose(1, 2).reshape(B * H, S, -1)
    rep = H // G
    y, h = _plain_flat(
        flat(x), log_a.transpose(1, 2).reshape(B * H, S),
        flat(b.repeat_interleave(rep, 2)), flat(c.repeat_interleave(rep, 2)),
        chunk, None if h0 is None else h0.reshape(B * H, P, N))
    return (y.reshape(B, H, S, P).transpose(1, 2).contiguous(),
            h.reshape(B, H, P, N))


def ssd_scan(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, chunk: int = 128,
             h0: Optional[torch.Tensor] = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(y, final state) of the chunked scan from ``h0`` (None: zeros),
    in either layout.  One launch on CUDA tensors, which must be f32 and
    contiguous, with ``chunk`` at most 128 and the block's shared memory
    within the card's (N 256 at chunk 128 is not)."""
    if chunk < 1:
        raise ValueError("chunk must be positive")
    B, S, H, G, P, N = _dims(x, log_a, b, c, h0)
    if on_cpu(x, log_a, b, c, h0):
        return ssd_scan_plain(x, log_a, b, c, chunk, h0)
    for name, t in (("x", x), ("log_a", log_a), ("b", b), ("c", c),
                    ("h0", h0)):
        if t is not None:
            require(t, name, torch.float32)
    chunk = min(chunk, S)
    if chunk > MAX_CHUNK or S == 0 or P == 0:
        raise ValueError(f"ssd_scan takes 0 < S, 0 < P and chunk <= "
                         f"{MAX_CHUNK}; got S={S}, P={P}, chunk={chunk}")
    smem = bind(_LIB, "ssd_scan_smem_bytes", [I, I, I])(chunk, P, N)
    if smem > SMEM_LIMIT:
        raise ValueError(f"ssd_scan: chunk {chunk} with P={P}, N={N} needs "
                         f"{smem} bytes of shared memory, above "
                         f"{SMEM_LIMIT}")
    nc = -(-S // chunk)
    y = torch.empty_like(x)
    final = torch.empty((B, H, P, N) if x.dim() == 4 else (B, P, N),
                        dtype=torch.float32, device=x.device)
    ws = torch.empty(((nc - 1) * B * H * P * N,), dtype=torch.float32,
                     device=x.device)
    flags = torch.zeros((nc * B * H + 1,), dtype=torch.int32,
                        device=x.device)
    vec = int(P % 4 == 0 and N % 4 == 0
              and all(t.data_ptr() % 16 == 0 for t in (x, b, c)))
    fn = bind(_LIB, "ssd_scan_launch",
              [PTR] * 9 + [I] * 8 + [PTR])
    check(_LIB, fn(ptr(x), ptr(log_a), ptr(b), ptr(c), ptr(h0), ptr(y),
                   ptr(final), ptr(ws), ptr(flags), B, S, H, G, P, N, chunk,
                   vec, stream(x)), "ssd_scan")
    ssd_scan.launches += 1
    return y, final


ssd_scan.launches = 0


# ---------------------------------------------------------------------------
# training: the reference's gradient around the kernel's forward
# ---------------------------------------------------------------------------
def ssd_chunked(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``models/ssm.py ssd_chunked`` in torch, in the
    model's layout and x's dtype, every chunk at once: the intra-chunk
    products, the chunk-final states, the inter-chunk recurrence as one
    [c+1, c+1] decay product, the entering states' outputs.  S is padded
    to a multiple of ``chunk`` with zeros, as the reference's model pads
    it (a zero step moves neither the first S outputs nor the state).
    b and c are repeated over the heads of their group as ``jnp.repeat``
    does, so autograd sums their gradients over those heads as its VJP
    does."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    pad = (-S) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        log_a = torch.nn.functional.pad(log_a, (0, 0, 0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, 0, 0, pad))
        c = torch.nn.functional.pad(c, (0, 0, 0, 0, 0, pad))
    nc = (S + pad) // chunk

    def chunked(t):                  # [B, S, H, K] -> [B, nc, H, l, K]
        return t.reshape(B, nc, chunk, H, -1).transpose(2, 3)
    xc = chunked(x)
    bc = chunked(b.repeat_interleave(H // G, 2))
    cc = chunked(c.repeat_interleave(H // G, 2))
    ac = log_a.reshape(B, nc, chunk, H).transpose(2, 3)          # [B,c,H,l]
    cum = torch.cumsum(ac, -1)
    # 1. intra-chunk: (C·Bᵀ ∘ L)·X
    y = torch.matmul(torch.matmul(cc, bc.transpose(-1, -2))
                     * _exp_segsum(ac), xc)                      # [B,c,H,l,P]
    # 2. each chunk's final state from a zero start: Xᵀ·(B ∘ decay)
    decay = torch.exp(cum[..., -1:] - cum)
    states = torch.matmul(xc.transpose(-1, -2), bc * decay[..., None])
    # 3. the states entering each chunk, and the final one
    if h0 is None:
        h0 = x.new_zeros((B, H, P, N))
    states = torch.cat([h0[:, None].to(x.dtype), states], 1)     # [B,c+1,..]
    last = torch.nn.functional.pad(cum[..., -1].transpose(1, 2), (1, 0))
    mixed = torch.matmul(_exp_segsum(last),         # [B, H, c+1, c+1]
                         states.transpose(1, 2).reshape(B, H, nc + 1, P * N))
    mixed = mixed.reshape(B, H, nc + 1, P, N)
    entering = mixed[:, :, :-1].transpose(1, 2)                  # [B,c,H,P,N]
    # 4. the entering states' outputs: exp(cum) · C·hᵀ
    y = y + torch.matmul(cc, entering.transpose(-1, -2)) * torch.exp(
        cum)[..., None]
    y = y.transpose(2, 3).reshape(B, S + pad, H, P)[:, :S]
    return y, mixed[:, :, -1]


def ssd_scan_grads(x, log_a, b, c, chunk, h0, dy, dfinal, needs=None):
    """(dx, dlog_a, db, dc, dh0) of the scan for the cotangents ``dy``
    (of y) and ``dfinal`` (of the final state; either may be None): the
    reference's gradient, autograd of :func:`ssd_chunked` recomputed
    from the inputs in f32 (f64 for f64 inputs).  Either layout; a
    gradient comes back in its input's dtype, None where ``needs`` (five
    flags, default all) says it is not wanted or the input is None."""
    flat = x.dim() == 3
    needs = needs or (True,) * 5
    f = _sums_dtype(x)
    with torch.enable_grad():
        ins = [None if t is None else t.detach().to(f).requires_grad_(n)
               for t, n in zip((x, log_a, b, c, h0), needs)]
        xm, lm, bm, cm, hm = ins
        if flat:                  # one head and one group a row
            xm, lm, bm, cm = (xm[:, :, None], lm[:, :, None],
                              bm[:, :, None], cm[:, :, None])
            hm = None if hm is None else hm[:, None]
        y, final = ssd_chunked(xm, lm, bm, cm, min(chunk, x.shape[1]), hm)
        if flat:
            y, final = y[:, :, 0], final[:, 0]
        outs = [(o, g.to(f)) for o, g in ((y, dy), (final, dfinal))
                if g is not None]
        wrt = [t for t in ins if t is not None and t.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in outs], wrt,
                                       [g for _, g in outs],
                                       allow_unused=True)
                   if outs and wrt else [None] * len(wrt))
    grads = []
    for t, src in zip(ins, (x, log_a, b, c, h0)):
        if t is None or not t.requires_grad:
            grads.append(None)
            continue
        g = next(got)
        grads.append(torch.zeros_like(src) if g is None else g.to(src.dtype))
    return tuple(grads)


class SSDScan(torch.autograd.Function):
    """The chunked scan, differentiable: (y, final state) of
    :func:`ssd_scan` in either layout.

    Forward: one launch of kernel 13 on CUDA tensors (grad mode is off
    inside ``forward``, so the kernel launches there whatever its inputs
    require), the plain version on CPU tensors.  Only the inputs are
    kept, never a chunk's [L, L] decay matrix.  Backward: the
    reference's gradient (:func:`ssd_scan_grads`: autograd of the
    chunked form, recomputed in plain f32 torch; the reference's scan
    is differentiated by JAX through ``ssd_chunked``, and its Pallas
    kernel has no backward)."""

    @staticmethod
    def forward(ctx, x, log_a, b, c, chunk, h0):
        y, final = ssd_scan(x, log_a, b, c, chunk, h0)
        ctx.save_for_backward(x, log_a, b, c, h0)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, log_a, b, c, h0 = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dla, db, dc, dh0 = ssd_scan_grads(
            x, log_a, b, c, ctx.chunk, h0, dy, dfinal,
            needs=need[:4] + need[5:])
        return dx, dla, db, dc, None, dh0


def ssd_scan_trainable(x: torch.Tensor, log_a: torch.Tensor,
                       b: torch.Tensor, c: torch.Tensor, chunk: int = 128,
                       h0: Optional[torch.Tensor] = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`ssd_scan`, through :class:`SSDScan` when autograd would
    differentiate it (grad mode on and an input that requires grad), so
    that the kernel takes part in training; otherwise the wrapper
    itself."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, log_a, b, c, h0)):
        return SSDScan.apply(x, log_a, b, c, chunk, h0)
    return ssd_scan(x, log_a, b, c, chunk, h0)
