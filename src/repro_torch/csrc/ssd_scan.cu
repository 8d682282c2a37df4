// Chunked SSD (Mamba-2) scan for Hopper (sm_90a), chunk-parallel.
//
// Replaces src/repro/kernels/ssd_scan.py: ssd_scan (_ssd_kernel), the
// state-space dual form over chunks of L positions, and the model path's
// src/repro/models/ssm.py: ssd_chunked, which also starts from an initial
// state h0 [P, N] per head.  Per chunk, with cum the running sum of log_a
// inside the chunk and h the state entering it:
//   G = (C·Bᵀ) ∘ Lmask,  Lmask[t, s] = exp(cum_t - cum_s) for s <= t
//   y = G·X + exp(cum) ∘ (C·hᵀ)
//   h' = exp(cum_L) h + (X ∘ exp(cum_L - cum))ᵀ·B
// All four products run in f32 on the CUDA cores (no TF32: it keeps about
// three digits and the reference's tolerance is 2e-4).
//
// Layout: x, y [B, S, H, P]; log_a [B, S, H]; b, c [B, S, G, N] read per
// group (head h takes group h / (H / G), as jnp.repeat broadcasts them);
// h0 and the final state [B, H, P, N].  The flattened form of the ops
// surface ([BH, S, P], b and c per row) is the case H = G = 1.
//
// Design: one block per (head, chunk) unit, so the chunk axis is parallel
// (zamba2-1.2b's layer, 64 heads x 16 chunks of 128: 1024 units).  Only the
// step h -> h' is sequential; it is a decoupled look-back over published
// chunk states, all in one launch:
//  1. a block takes a ticket (an atomic counter) and works on unit
//     (chunk = ticket / BH, head = ticket % BH): chunk-major, so a unit's
//     predecessor in its head holds a smaller ticket and is already running
//     or done, whatever order the blocks are dispatched in;
//  2. it stages x, b and c of its chunk (b and c transposed, [n][t]) in
//     shared memory by asynchronous copies, with zeros past the sequence
//     (a zero x, log_a, b and c change nothing, so a ragged last chunk is
//     exact), and scans log_a;
//  3. it computes G on and below the diagonal (above it the exponent is
//     positive and can overflow), then y_diag = G·X into y, then its own
//     state contribution (X ∘ decay)ᵀ·B, all before it waits;
//  4. thread 0 waits until the predecessor has published the state leaving
//     chunk - 1 (ld.acquire on its flag; chunk 0 takes h0 or zeros); the
//     block computes h' = exp(cum_L) h + contribution, writes it to the
//     workspace (the last chunk to the final state) and publishes it
//     (fence, st.release on its flag) before it finishes its own output;
//  5. y += exp(cum) ∘ C·hᵀ, each thread re-reading the y elements it wrote
//     in step 3.
// A wait that lasts over 2 s traps (the launch fails) rather than hang the
// card.  4 x 4 register tiles and float4 shared-memory reads throughout
// (a warp's tiles of G share rows, so that its reads of c and b are
// broadcast);
// the y tiles pair row tile t with row tile nT-1-t in thread order, so the
// triangular G·X work is even across warps; the contribution is summed in
// two halves of the positions, so that all warps take part.  One block of
// 640 threads an SM: at chunk 128 and P = N = 64 the block holds 167 KB of
// shared memory.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// threads per block: 20 warps, one for each block of 8 x 4 tiles of G on
// or below the diagonal at chunk 128
constexpr int NT = 640;
constexpr int HU = 8;         // state elements a thread loads at once
constexpr int MAXL = 128;     // longest chunk (warp 0 scans 4 per lane)
constexpr long long WAIT_NS = 2000000000LL;

struct Layout {
  // chunk padded to 4 and its row stride; P and N padded to 4; the row
  // stride of h transposed; the region that holds G, then the
  // contribution's two halves [2][Pp][Np] and h transposed [Np][HS]
  int Lp, LS, Pp, Np, HS, R;
  __host__ __device__ Layout(int L, int P, int N)
      : Lp((L + 3) & ~3), LS(((L + 3) & ~3) + 4), Pp((P + 3) & ~3),
        Np((N + 3) & ~3), HS(((P + 3) & ~3) + 4), R(0) {
    const int g = Lp * Lp, sh = 2 * Pp * Np + Np * HS;
    R = g > sh ? g : sh;
  }
  __host__ __device__ size_t floats() const {
    return 2 * (size_t)Np * LS + (size_t)Lp * Pp + (size_t)R +
           3 * (size_t)Lp;
  }
};

struct Args {
  const float* x;
  const float* la;
  const float* b;
  const float* c;
  const float* h0;  // null: zeros
  float* y;
  float* fin;
  float* ws;        // [nc - 1][BH][P][N] published chunk states
  int* flags;       // [nc][BH] publish flags, then the ticket counter
  int B, S, H, G, P, N, L, nc;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// asynchronous copies to shared memory; a source size of 0 writes zeros
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(d), "l"(src), "r"(in ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(d), "l"(src), "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::
                   : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ long long now_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// the row tile of the raw index r of nT: the first half in order, the
// second half mirrored, so that consecutive threads hold short and long
// rows of the triangle alike
__device__ __forceinline__ int fold(int r, int nT) {
  const int half = (nT + 1) / 2;
  return r < half ? r : nT - 1 - (r - half);
}

// VEC: P % 4 == 0, N % 4 == 0 and x, y, b, c 16-byte aligned (16-byte
// global access)
template <bool VEC>
__global__ void __launch_bounds__(NT, 1) ssd_scan_kernel(const Args a) {
  const Layout lay(a.L, a.P, a.N);
  const int Lp = lay.Lp, LS = lay.LS, Pp = lay.Pp, Np = lay.Np,
            HS = lay.HS;
  const int nT = Lp / 4, nPT = Pp / 4, nNT = Np / 4;
  extern __shared__ __align__(16) float smem[];
  float* s_ct = smem;               // [Np][LS]  c transposed
  float* s_bt = s_ct + Np * LS;     // [Np][LS]  b transposed
  float* s_x = s_bt + Np * LS;      // [Lp][Pp]
  float* s_gt = s_x + Lp * Pp;      // [Lp][Lp]  G transposed: [s][t]
  float* s_st = s_gt;               // [2][Pp][Np] contribution (after G·X)
  float* s_ht = s_gt + 2 * Pp * Np; // [Np][HS]  h entering the chunk
  float* s_cum = s_gt + lay.R;      // [Lp]
  float* s_ecum = s_cum + Lp;       // [Lp] exp(cum_t)
  float* s_dec = s_ecum + Lp;       // [Lp] exp(cum_L - cum_s)
  __shared__ int s_ticket;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int BH = a.B * a.H, P = a.P, N = a.N;
  if (tid == 0) s_ticket = atomicAdd(a.flags + a.nc * BH, 1);
  __syncthreads();
  const int ci = s_ticket / BH, bh = s_ticket % BH;
  const int bi = bh / a.H, h = bh % a.H, g = h / (a.H / a.G);
  const int c0 = ci * a.L, Lv = min(a.L, a.S - c0);
  const int64_t xrow = (int64_t)a.H * P, brow = (int64_t)a.G * N;
  const int64_t pos0 = (int64_t)bi * a.S + c0;
  const float* xb = a.x + pos0 * xrow + (int64_t)h * P;
  float* yb = a.y + pos0 * xrow + (int64_t)h * P;
  const float* lab = a.la + pos0 * a.H + h;
  const float* bb = a.b + pos0 * brow + (int64_t)g * N;
  const float* cb = a.c + pos0 * brow + (int64_t)g * N;

  // stage the chunk (asynchronous copies, all in flight at once): x
  // [t][p], b and c [n][t], zeros past Lv, P and N
  if (VEC) {
    for (int i = tid; i < Lp * nPT; i += NT) {
      const int s = i / nPT, q = i % nPT;
      const bool in = s < Lv;
      cp_async16(s_x + s * Pp + 4 * q, in ? xb + s * xrow + 4 * q : xb, in);
    }
  } else {
    for (int i = tid; i < Lp * Pp; i += NT) {
      const int s = i / Pp, p = i % Pp;
      const bool in = s < Lv && p < P;
      cp_async4(s_x + i, in ? xb + s * xrow + p : xb, in);
    }
  }
  if (VEC) {  // 16-byte loads of b and c, transposed by four stores
    const int nq = Np / 4;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int base = tid; base < Lp * nq; base += 4 * NT) {
      float4 vb[4], vc[4];  // every load in flight before the stores
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = base + u * NT, s = i % Lp, q = i / Lp;
        const bool in = i < Lp * nq && s < Lv;
        const int64_t o = in ? s * brow + 4 * q : 0;
        vb[u] = in ? __ldg(reinterpret_cast<const float4*>(bb + o)) : z;
        vc[u] = in ? __ldg(reinterpret_cast<const float4*>(cb + o)) : z;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = base + u * NT, s = i % Lp, q = i / Lp;
        if (i >= Lp * nq) break;
        float* db = s_bt + 4 * q * LS + s;
        float* dc = s_ct + 4 * q * LS + s;
        db[0] = vb[u].x, db[LS] = vb[u].y, db[2 * LS] = vb[u].z;
        db[3 * LS] = vb[u].w;
        dc[0] = vc[u].x, dc[LS] = vc[u].y, dc[2 * LS] = vc[u].z;
        dc[3 * LS] = vc[u].w;
      }
    }
  } else {
    for (int i = tid; i < Lp * Np; i += NT) {
      const int s = i / Np, n = i % Np;
      const bool in = s < Lv && n < N;
      const int64_t o = in ? s * brow + n : 0;
      cp_async4(s_bt + n * LS + s, bb + o, in);
      cp_async4(s_ct + n * LS + s, cb + o, in);
    }
  }
  if (warp == 0) {  // inclusive running sum of log_a over the chunk
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = lane * 4 + e;
      v[e] = t < Lv ? lab[(int64_t)t * a.H] : 0.0f;
    }
    v[1] += v[0];
    v[2] += v[1];
    v[3] += v[2];
    float tot = v[3];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, tot, o);
      if (lane >= o) tot += up;
    }
    const float before = tot - v[3];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = lane * 4 + e;
      if (t < Lp) s_cum[t] = before + v[e];
    }
  }
  cp_async_wait_all();
  __syncthreads();
  const float cum_last = s_cum[Lp - 1];  // = cum at Lv - 1 (zeros after)
  for (int t = tid; t < Lp; t += NT) {
    s_ecum[t] = expf(s_cum[t]);
    s_dec[t] = expf(cum_last - s_cum[t]);
  }

  // G for the 4 x 4 tiles on or below the diagonal, stored [s][t]: a warp
  // takes a block of 8 row tiles x 4 column tiles, so that its lanes share
  // 8 rows of c and 4 of b (broadcast reads)
  const int nBS = (nT + 3) / 4;
  int n_blk = 0;
  for (int bt = 0; bt * 8 < nT; ++bt) n_blk += min(2 * bt + 2, nBS);
  for (int blk = warp; blk < n_blk; blk += NT / 32) {
    int bt = 0, rem = blk;
    while (rem >= min(2 * bt + 2, nBS)) rem -= min(2 * bt++ + 2, nBS);
    const int tt = bt * 8 + lane % 8, st = rem * 4 + lane / 8;
    if (tt >= nT || st > tt) continue;
    float gv[4][4] = {};
#pragma unroll 4
    for (int n = 0; n < Np; ++n) {
      const float4 cv = ld4(s_ct + n * LS + tt * 4);
      const float4 bv = ld4(s_bt + n * LS + st * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          gv[i][e] = fmaf(at(cv, i), at(bv, e), gv[i][e]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int s = st * 4 + e;
      float o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = tt * 4 + i;
        o[i] = s <= t ? gv[i][e] * expf(s_cum[t] - s_cum[s]) : 0.0f;
      }
      *reinterpret_cast<float4*>(s_gt + s * Lp + tt * 4) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
  }
  __syncthreads();

  // y_diag = G·X into y, 4 positions x 4 columns a tile
  for (int id = tid; id < nT * nPT; id += NT) {
    const int tt = fold(id / nPT, nT), pt = id % nPT;
    float yv[4][4] = {};
    const int s_end = tt * 4 + 4;
#pragma unroll 4
    for (int s = 0; s < s_end; ++s) {
      const float4 gv = ld4(s_gt + s * Lp + tt * 4);
      const float4 xv = ld4(s_x + s * Pp + pt * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int f = 0; f < 4; ++f)
          yv[i][f] = fmaf(at(gv, i), at(xv, f), yv[i][f]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = tt * 4 + i;
      if (t >= Lv) continue;
      float* yr = yb + t * xrow + pt * 4;
      if (VEC) {
        *reinterpret_cast<float4*>(yr) =
            make_float4(yv[i][0], yv[i][1], yv[i][2], yv[i][3]);
      } else {
#pragma unroll
        for (int f = 0; f < 4; ++f)
          if (pt * 4 + f < P) yr[f] = yv[i][f];
      }
    }
  }
  __syncthreads();  // G is read; its region takes the contribution

  // the chunk's own contribution (X ∘ dec)ᵀ·B, 4 columns of P x 4 of N,
  // in two halves of the chunk's positions (summed when h' is formed), 4
  // positions a step (the zeros past Lv add nothing)
  const int Lh = ((Lp / 2) + 3) & ~3;
  for (int id = tid; id < 2 * nNT * nPT; id += NT) {
    const int half = id / (nNT * nPT), nt = id % (nNT * nPT) / nPT,
              pt = id % nPT;
    float hn[4][4] = {};  // [p][n]
    const int s_end = half ? Lp : Lh;
#pragma unroll 2
    for (int s = half * Lh; s < s_end; s += 4) {
      const float4 d4 = ld4(s_dec + s);
      float4 xv[4], bv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j] = ld4(s_x + (s + j) * Pp + pt * 4);
#pragma unroll
      for (int r = 0; r < 4; ++r) bv[r] = ld4(s_bt + (nt * 4 + r) * LS + s);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const float xw = at(xv[j], f) * at(d4, j);
#pragma unroll
          for (int r = 0; r < 4; ++r)
            hn[f][r] = fmaf(xw, at(bv[r], j), hn[f][r]);
        }
    }
    float* dst = s_st + half * Pp * Np;
#pragma unroll
    for (int f = 0; f < 4; ++f)
      *reinterpret_cast<float4*>(dst + (pt * 4 + f) * Np + nt * 4) =
          make_float4(hn[f][0], hn[f][1], hn[f][2], hn[f][3]);
  }

  // the state entering the chunk: the predecessor's published one
  const int64_t hsz = (int64_t)P * N;
  if (tid == 0 && ci > 0) {
    const int* flag = a.flags + (int64_t)(ci - 1) * BH + bh;
    const long long t0 = now_ns();
    unsigned ns = 32;
    while (ld_acquire(flag) == 0) {
      __nanosleep(ns);
      if (ns < 256) ns *= 2;
      if (now_ns() - t0 > WAIT_NS) __trap();
    }
  }
  __syncthreads();
  const float* hin = ci > 0 ? a.ws + ((int64_t)(ci - 1) * BH + bh) * hsz
                   : a.h0 != nullptr ? a.h0 + bh * hsz : nullptr;
  float* hout = ci == a.nc - 1 ? a.fin + bh * hsz
                               : a.ws + ((int64_t)ci * BH + bh) * hsz;
  const float e_last = expf(cum_last);
  for (int base = tid; base < Pp * Np; base += HU * NT) {
    float hv[HU];  // every load in flight before the first use
#pragma unroll
    for (int u = 0; u < HU; ++u) {
      const int i = base + u * NT, p = i / Np, n = i % Np;
      hv[u] = (hin != nullptr && i < Pp * Np && p < P && n < N)
                  ? __ldcg(hin + p * N + n) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < HU; ++u) {
      const int i = base + u * NT, p = i / Np, n = i % Np;
      if (i >= Pp * Np) break;
      if (p < P && n < N)
        hout[p * N + n] = fmaf(e_last, hv[u], s_st[p * Np + n] +
                                                  s_st[(Pp + p) * Np + n]);
      s_ht[n * HS + p] = hv[u];
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0 && ci < a.nc - 1)
    st_release(a.flags + (int64_t)ci * BH + bh, 1);
  if (hin == nullptr) return;  // a zero state adds nothing to y

  // y += exp(cum) ∘ C·hᵀ over the tiles this thread wrote above
  for (int id = tid; id < nT * nPT; id += NT) {
    const int tt = fold(id / nPT, nT), pt = id % nPT;
    float ch[4][4] = {};
#pragma unroll 4
    for (int n = 0; n < Np; ++n) {
      const float4 cv = ld4(s_ct + n * LS + tt * 4);
      const float4 hv = ld4(s_ht + n * HS + pt * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int f = 0; f < 4; ++f)
          ch[i][f] = fmaf(at(cv, i), at(hv, f), ch[i][f]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = tt * 4 + i;
      if (t >= Lv) continue;
      float* yr = yb + t * xrow + pt * 4;
      const float et = s_ecum[t];
      if (VEC) {
        const float4 o = ld4(yr);
        *reinterpret_cast<float4*>(yr) = make_float4(
            fmaf(et, ch[i][0], o.x), fmaf(et, ch[i][1], o.y),
            fmaf(et, ch[i][2], o.z), fmaf(et, ch[i][3], o.w));
      } else {
#pragma unroll
        for (int f = 0; f < 4; ++f)
          if (pt * 4 + f < P) yr[f] = fmaf(et, ch[i][f], yr[f]);
      }
    }
  }
}

template <bool VEC>
cudaError_t launch(const Args& a, size_t smem, cudaStream_t st) {
  static size_t granted[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (smem > 48 * 1024 && smem > granted[dev % 64]) {
    e = cudaFuncSetAttribute(ssd_scan_kernel<VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    granted[dev % 64] = smem;
  }
  const unsigned units = (unsigned)a.nc * (unsigned)(a.B * a.H);
  ssd_scan_kernel<VEC><<<units, NT, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for chunk L, head dim P and state N.
int ssd_scan_smem_bytes(int L, int P, int N) {
  return (int)(sizeof(float) * Layout(L, P, N).floats());
}

// f32 throughout; x, y [B, S, H, P], la [B, S, H], b, c [B, S, G, N],
// h0 (or null) and fin [B, H, P, N].  ws holds (ceil(S / L) - 1) * B * H
// * P * N floats; flags ceil(S / L) * B * H + 1 ints, zero.  0 < L <= 128,
// H % G == 0; the wrapper checks the shared memory.  vec: P % 4 == 0,
// N % 4 == 0 and x, y, b, c 16-byte aligned.
int ssd_scan_launch(const void* x, const void* la, const void* b,
                    const void* c, const void* h0, void* y, void* fin,
                    void* ws, void* flags, int B, int S, int H, int G,
                    int P, int N, int L, int vec, void* stream) {
  if (L < 1 || L > MAXL || N < 1 || P < 1 || S < 1 || G < 1 || H % G)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const float*>(x);
  a.la = static_cast<const float*>(la);
  a.b = static_cast<const float*>(b);
  a.c = static_cast<const float*>(c);
  a.h0 = static_cast<const float*>(h0);
  a.y = static_cast<float*>(y);
  a.fin = static_cast<float*>(fin);
  a.ws = static_cast<float*>(ws);
  a.flags = static_cast<int*>(flags);
  a.B = B, a.S = S, a.H = H, a.G = G, a.P = P, a.N = N, a.L = L;
  a.nc = (S + L - 1) / L;
  const size_t smem = (size_t)ssd_scan_smem_bytes(L, P, N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(vec ? launch<true>(a, smem, st) : launch<false>(a, smem, st));
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
