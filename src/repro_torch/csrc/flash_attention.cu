// Flash-attention prefill for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py: flash_attention
// (_flash_kernel): causal, sliding-window or full attention of a prompt,
// and causal with a bidirectional prefix (the reference's "prefix" mask of
// a vision config's global layers: key k is visible to query q when k <= q
// or k < prefix), an online softmax over KV blocks, GQA through the KV
// index map h // G.
//
// What bounds it on the card: the two products, 4 * D operations per
// visible (query, key) pair and head, against q, k, v and the output read
// or written once; at gemma-2b's prefill (S 2048, D 256) that is ~900
// operations per byte, far above the ~295 where bf16 tensor cores stop
// waiting for memory, so the bound is arithmetic at the tensor cores'
// rate.  Two bodies:
//
// * bf16 with D % 8 == 0 (every head size of the registry: 64, 72 at DiT-XL/2,
//   128, 256) runs on the tensor cores, FlashAttention-2 style: mma.sync
//   m16n8k16, bf16 operands, f32 accumulators.  A block of 4 warps owns BQ =
//   64 query rows (16 per warp) of one head and walks KV tiles of BK = 64
//   keys.  It stages its q tile in shared memory once (bf16) and
//   double-buffers the K and V tiles with cp.async: tile j + 1 is in flight
//   while tile j computes.  Keys past Skv and rows past Sq are zero-filled by
//   the copy (source size 0), head dims past D too (the tile is DM = 64, 128
//   or 256 wide; D % 8 == 0 makes a row of one head whole 16-byte chunks, so a
//   chunk is all head dims or all zeros and never reads the next head's
//   values).  The zero columns add exact zeros to q K^T and the O columns past
//   D are never stored, so D 72 runs in the DM 128 tile at 128 / 72 = 1.78
//   times the head's own mma work; the scale stays 1/sqrt(D) of the true D.
//   Rows are 16-byte chunks XOR-swizzled by row % 8 (the swizzle indexed by
//   DM, a power of two), so that ldmatrix reads 8 rows without bank conflicts.
//   S = q K^T comes out of the mma in f32 fragments (q by ldmatrix as A, K
//   rows by ldmatrix as B); each score is then __fmul_rn(s, 1/sqrt(D)), masked
//   scores are set to -1e30 and keys past Skv to -inf, on the tiles that hold
//   a diagonal, a window edge or the end of the keys only.  The online-softmax
//   state lives in the fragment layout: a thread holds two rows (lane / 4 and
//   lane / 4 + 8) and a row's max and sum are quad shuffles (xor 1, 2): m_new
//   = max(m, max s), p = exp(s - m_new), l = l * corr + sum p over the
//   unrounded p, corr = exp(m - m_new).  p is then rounded to bf16 (the
//   reference's p.astype(v.dtype)) and is the A operand of P V straight from
//   registers; V is read as B by ldmatrix.trans.  The O accumulator (16 x DM
//   per warp, DM / 2 f32 a thread) stays in registers for the sweep. Shared
//   memory: 640 * DM bytes (160 KB at D 256: one block an SM).
// * f32, and bf16 with another D, run on the CUDA cores in f32 fused
//   multiply-adds (TF32 would miss the f32 tolerance of 2e-5): one block
//   of 8 warps per 64 query rows, KV tiles of 32 keys, q staged as f32,
//   K transposed and V staged as f32, one buffer.  Warp w owns query rows
//   w, w + 8, ..., w + 56; lane j scores key j of the tile for those 8
//   rows, and the lane that owns head dims lane + 32u of a row keeps its
//   accumulators; row max and sum are warp shuffles, p_j is broadcast
//   from lane j.  The same masks, rounding and softmax rules as above.
//
// Both end by writing acc / max(l, 1e-30) in q's dtype once, from one
// launch.  Where the caller passes an ``lse`` buffer [B, H, Sq] f32 (the
// differentiable cacheless attention's forward), each row's log-sum-exp
// m + log(l), in scaled-score units, goes there too, or 1e30 for a row
// with no visible key (its max stays at -1e30), which the backward turns
// into p = exp(s - 1e30) = 0; the reference's fa_fwd saves the same.
// Without it nothing else changes: the output's arithmetic is the same.
//
// Masks and skipped tiles (both bodies): the causal mask is aligned
// top-left (query and key positions both start at 0); a prefix p moves a
// causal row's last visible key from q to max(q, p - 1), so every q tile
// walks every KV tile below p.  A block walks
// only the KV tiles between the first visible key of its first row and
// the last visible key of its last row, heaviest q tiles first; the keys
// it skips are masked for every row of the tile, which the reference's
// kernel computes to exactly nothing (a masked block before the first
// live one is erased by corr = exp(-1e30 - m) = 0, one after it adds
// exp(-1e30 - m) = 0).  A row with no visible key attends uniformly over
// all Skv keys in the reference; a block holding such a row walks every
// tile, so it does too.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 256;        // threads per block
constexpr int NW = NT / 32;    // warps per block
constexpr int BQ = 64;         // query rows per block
constexpr int BK = 32;         // keys per KV tile (one per lane)
constexpr int RPW = BQ / NW;   // query rows per warp
constexpr int KTS = BK + 1;    // row stride of the transposed K tile
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// q [B, Sq, H, D]; k, v [B, Skv, KH, D]; out [B, Sq, H, D]; lse [B, H,
// Sq] or null.  DMAX: the head dims a lane's accumulators cover (32 per
// register), >= D.
template <typename T, int DMAX>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int Sq,
                       int Skv, int H, int KH, int D, int causal, int window,
                       int prefix, float scale) {
  constexpr int U = DMAX / 32;
  const int Dp = (D + 3) & ~3;  // q and K^T rows, padded with zeros
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                    // [BQ][Dp]
  float* s_kt = s_q + BQ * Dp;          // [Dp][KTS]
  float* s_v = s_kt + Dp * KTS;         // [BK][DMAX]

  // the causal grid's heaviest q tiles first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int i = tid; i < BQ * Dp; i += NT) {
    const int r = i / Dp, d = i % Dp;
    const int qp = q0 + r;
    s_q[i] = (qp < Sq && d < D)
                 ? to_f(q[(((int64_t)b * Sq + qp) * H + h) * D + d])
                 : 0.0f;
  }

  // visible keys of query qp: [lo, hi]
  auto lo_of = [&](int qp) { return window > 0 ? max(0, qp - window + 1) : 0; };
  auto hi_of = [&](int qp) {
    return causal ? min(max(qp, prefix - 1), Skv - 1) : Skv - 1;
  };
  const int q_last = min(q0 + BQ, Sq) - 1;
  int kv_lo = lo_of(q0), kv_hi = hi_of(q_last);
  if (lo_of(q_last) > hi_of(q_last)) {  // an empty row: uniform over all
    kv_lo = 0;
    kv_hi = Skv - 1;
  }

  float m[RPW], l[RPW], acc[RPW][U];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int u = 0; u < U; ++u) acc[i][u] = 0.0f;
  }

  const int64_t row_stride = (int64_t)KH * D;  // elements between keys
  const T* kb = k + (int64_t)b * Skv * row_stride + (int64_t)kh * D;
  const T* vb = v + (int64_t)b * Skv * row_stride + (int64_t)kh * D;

  for (int k0 = kv_lo / BK * BK; k0 <= kv_hi; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * DMAX; i += NT) {
      const int j = i / DMAX, d = i % DMAX;
      const int kp = k0 + j;
      const bool in = kp < Skv && d < D;
      const int64_t at = kp * row_stride + d;
      if (d < Dp) s_kt[d * KTS + j] = in ? to_f(kb[at]) : 0.0f;
      s_v[i] = in ? to_f(vb[at]) : 0.0f;
    }
    __syncthreads();

    // scores of rows warp + NW * i against key k0 + lane
    float s[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) s[i] = 0.0f;
    for (int d = 0; d < Dp; d += 4) {
      const float k0v = s_kt[(d + 0) * KTS + lane];
      const float k1v = s_kt[(d + 1) * KTS + lane];
      const float k2v = s_kt[(d + 2) * KTS + lane];
      const float k3v = s_kt[(d + 3) * KTS + lane];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(s_q + (warp + NW * i) * Dp + d);
        s[i] = fmaf(qv.x, k0v, s[i]);
        s[i] = fmaf(qv.y, k1v, s[i]);
        s[i] = fmaf(qv.z, k2v, s[i]);
        s[i] = fmaf(qv.w, k3v, s[i]);
      }
    }

    // online-softmax update; s[i] becomes p (rounded for a bf16 PV)
    const int kp = k0 + lane;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int qp = q0 + warp + NW * i;
      const bool vis = (!causal || kp <= qp || kp < prefix) &&
                       (window <= 0 || kp > qp - window);
      const float sc =
          kp >= Skv ? -INFINITY : (vis ? __fmul_rn(s[i], scale) : NEG_INF);
      const float m_new = fmaxf(m[i], warp_max(sc));
      float p = expf(sc - m_new);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(p);
      m[i] = m_new;
      if (std::is_same<T, __nv_bfloat16>::value)
        p = __bfloat162float(__float2bfloat16(p));
      s[i] = p;
#pragma unroll
      for (int u = 0; u < U; ++u) acc[i][u] *= corr;
    }

    // acc += p . v
    const int nj = min(BK, Skv - k0);
    for (int j = 0; j < nj; ++j) {
      float vv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) vv[u] = s_v[j * DMAX + lane + 32 * u];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float pj = __shfl_sync(FULL, s[i], j);
#pragma unroll
        for (int u = 0; u < U; ++u) acc[i][u] = fmaf(pj, vv[u], acc[i][u]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int qp = q0 + warp + NW * i;
    if (qp >= Sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && lane == 0)
      lse[((int64_t)b * H + h) * Sq + qp] =
          m[i] > NEG_INF ? m[i] + logf(l[i]) : 1e30f;
    T* o = out + (((int64_t)b * Sq + qp) * H + h) * D;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int d = lane + 32 * u;
      if (d < D) o[d] = from_f<T>(acc[i][u] / lc);
    }
  }
}
// Above 48 KB a kernel needs the attribute; set once per device and
// kernel, outside any graph capture (the first call of a size is never
// captured).  ``granted`` is the caller's per-kernel record.
template <typename K>
cudaError_t opt_in(K kern, size_t smem, size_t (&granted)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (smem > 48 * 1024 && smem > granted[dev % 64]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    granted[dev % 64] = smem;
  }
  return cudaSuccess;
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Sq, int Skv, int H, int KH, int D,
           int causal, int window, int prefix, float scale,
           cudaStream_t st) {
  const int Dp = (D + 3) & ~3;
  const size_t smem =
      sizeof(float) * ((size_t)BQ * Dp + (size_t)Dp * KTS + (size_t)BK * DMAX);
  auto kern = flash_attention_kernel<T, DMAX>;
  static size_t granted[64] = {};
  cudaError_t e = opt_in(kern, smem, granted);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, st>>>(static_cast<const T*>(q),
                               static_cast<const T*>(k),
                               static_cast<const T*>(v), static_cast<T*>(out),
                               lse, Sq, Skv, H, KH, D, causal, window,
                               prefix, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out,
             float* lse, int B, int Sq, int Skv, int H, int KH, int D,
             int causal, int window, int prefix, float scale,
             cudaStream_t st) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, out, lse, B, Sq, Skv, H, KH, D, causal,
                         window, prefix, scale, st);
  if (D <= 128)
    return launch<T, 128>(q, k, v, out, lse, B, Sq, Skv, H, KH, D, causal,
                          window, prefix, scale, st);
  return launch<T, 256>(q, k, v, out, lse, B, Sq, Skv, H, KH, D, causal,
                        window, prefix, scale, st);
}

// ---------------------------------------------------------------------------
// The tensor-core body (bf16, D % 8 == 0)
// ---------------------------------------------------------------------------
constexpr int MT = 128;       // threads per block: 4 warps
constexpr int MBQ = 64;       // query rows per block, 16 per warp

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// element offset of 16-byte chunk c of row r in a [rows][DM] tile
template <int DM>
__device__ __forceinline__ int swz(int r, int c) {
  return r * DM + ((c ^ (r & 7)) << 3);
}

// 16 bytes global -> shared; zero-fills when !ok (source size 0)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16 x 16, row) . b (16 x 8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// Copy rows row0 .. row0 + ROWS - 1 of a [rows, stride] bf16 matrix (D
// columns used) into a swizzled [ROWS][DM] tile; rows past nrows and
// columns past D read as zero.
template <int DM, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int64_t stride, int row0,
                                          int nrows, int D, int tid) {
  constexpr int CPR = DM / 8;  // 16-byte chunks a row
#pragma unroll
  for (int i = tid; i < ROWS * CPR; i += MT) {
    const int r = i / CPR, c = i % CPR;
    const int row = row0 + r;
    const bool ok = row < nrows && c * 8 < D;
    const bf16* g = ok ? src + (int64_t)row * stride + c * 8 : src;
    cp_async16(smem_addr(dst + swz<DM>(r, c)), g, ok);
  }
}

// Byte offset, in a swizzled [rows][DM] tile, of row ``r`` and of chunk
// ``8 * (c / 8) + j`` for the chunk phase j = c % 8: the part that
// varies with c / 8 is a constant (128 bytes a step) that the unrolled
// loops fold into the ldmatrix address.
template <int DM>
__device__ __forceinline__ uint32_t tile_off(int r, int j) {
  return (uint32_t)(r * DM + ((j ^ (r & 7)) << 3)) * 2u;
}

// q [B, Sq, H, D]; k, v [B, Skv, KH, D]; out [B, Sq, H, D], all bf16;
// lse [B, H, Sq] f32 or null; D % 8 == 0, D <= DM.  Grid (H, q tiles,
// B): every head's heaviest q tile is scheduled before any lighter one.
template <int DM, int BK, int MINB>
__global__ void __launch_bounds__(MT, MINB)
flash_attention_mma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out,
                           float* __restrict__ lse,
                           int Sq, int Skv, int H, int KH, int D, int causal,
                           int window, int prefix, float scale) {
  constexpr int KS = DM / 16;  // k-steps of q K^T
  constexpr int ON = DM / 8;   // 8-wide column tiles of O
  constexpr int SN = BK / 8;   // 8-wide column tiles of S
  constexpr uint32_t ROW16 = 16 * DM * 2;       // bytes of 16 tile rows
  constexpr uint32_t KV_BYTES = BK * DM * 2;    // one K or V buffer
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_raw);  // [MBQ][DM]
  bf16* s_k = s_q + MBQ * DM;                      // [2][BK][DM]
  bf16* s_v = s_k + 2 * BK * DM;                   // [2][BK][DM]

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * MBQ;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // visible keys of query qp: [lo, hi]
  auto lo_of = [&](int qp) {
    return window > 0 ? max(0, qp - window + 1) : 0;
  };
  auto hi_of = [&](int qp) {
    return causal ? min(max(qp, prefix - 1), Skv - 1) : Skv - 1;
  };
  const int q_last = min(q0 + MBQ, Sq) - 1;
  int kv_lo = lo_of(q0), kv_hi = hi_of(q_last);
  const bool empty_row = lo_of(q_last) > hi_of(q_last);
  if (empty_row) {  // an empty row: uniform over all keys
    kv_lo = 0;
    kv_hi = Skv - 1;
  }
  // tiles where every row of the block sees every key need no mask
  const int full_lo = empty_row ? Skv : lo_of(q_last);
  const int full_hi = hi_of(q0);

  const int64_t qs = (int64_t)H * D, kvs = (int64_t)KH * D;
  const bf16* qb = q + (int64_t)b * Sq * qs + (int64_t)h * D;
  const bf16* kb = k + (int64_t)b * Skv * kvs + (int64_t)kh * D;
  const bf16* vb = v + (int64_t)b * Skv * kvs + (int64_t)kh * D;

  const int kt0 = kv_lo / BK, kt1 = kv_hi / BK;
  load_tile<DM, MBQ>(s_q, qb, qs, q0, Sq, D, tid);
  load_tile<DM, BK>(s_k, kb, kvs, kt0 * BK, Skv, D, tid);
  load_tile<DM, BK>(s_v, vb, kvs, kt0 * BK, Skv, D, tid);
  cp_async_commit();

  // ldmatrix addresses: lane l gives row l % 16 (q; chunk + l / 16),
  // for K rows 8 * (l / 16) + l % 8 (chunk + l / 8 % 2), for V rows
  // 8 * (l / 8 % 2) + l % 8 (chunk + l / 16), in chunk phases j = 0..3
  const int mi = lane >> 3;
  uint32_t q_off[4], k_off[4], v_off[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    q_off[j] = smem_addr(s_q) +
               tile_off<DM>(warp * 16 + (lane & 15), 2 * j + (lane >> 4));
    k_off[j] = tile_off<DM>((mi >> 1) * 8 + (lane & 7), 2 * j + (mi & 1));
    v_off[j] = tile_off<DM>((mi & 1) * 8 + (lane & 7), 2 * j + (mi >> 1));
  }
  const uint32_t k_base = smem_addr(s_k), v_base = smem_addr(s_v);

  // a thread's rows: qr and qr + 8; its columns in an 8-wide tile:
  // 2 * (lane % 4) and + 1
  const int qr = q0 + warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  float o[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};

  for (int kt = kt0; kt <= kt1; ++kt) {
    const int buf = (kt - kt0) & 1;
    if (kt < kt1) {  // the next tile's copies fly while this one computes
      load_tile<DM, BK>(s_k + (buf ^ 1) * BK * DM, kb, kvs, (kt + 1) * BK,
                        Skv, D, tid);
      load_tile<DM, BK>(s_v + (buf ^ 1) * BK * DM, vb, kvs, (kt + 1) * BK,
                        Skv, D, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t kbuf = k_base + buf * KV_BYTES;
    const uint32_t vbuf = v_base + buf * KV_BYTES;

    // S = q K^T: 16 rows x BK keys a warp, SN column tiles of 8 keys
    float s[SN][4];
#pragma unroll
    for (int n = 0; n < SN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, q_off[kk & 3] + (kk >> 2) * 128);
#pragma unroll
      for (int np = 0; np < SN / 2; ++np) {
        uint32_t bb[4];
        ldsm_x4(bb, kbuf + k_off[kk & 3] + (kk >> 2) * 128 + np * ROW16);
        mma_bf16(s[2 * np], a, bb[0], bb[1]);
        mma_bf16(s[2 * np + 1], a, bb[2], bb[3]);
      }
    }

    // scale, then mask on the diagonal / window-edge / last tiles
    const int k0 = kt * BK;
    const bool edge = !(k0 + BK <= Skv && full_lo <= k0 &&
                        k0 + BK - 1 <= full_hi);
#pragma unroll
    for (int n = 0; n < SN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(s[n][e], scale);
        if (edge) {
          const int kp = k0 + 8 * n + cq + (e & 1);
          const int qp = qr + 8 * (e >> 1);
          const bool vis = (!causal || kp <= qp || kp < prefix) &&
                           (window <= 0 || kp > qp - window);
          x = kp >= Skv ? -INFINITY : (vis ? x : NEG_INF);
        }
        s[n][e] = x;
      }
    }

    // online softmax per row (a row lives in one quad)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < SN; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float corr[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
      corr[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
    // p rounded to bf16, packed as the A fragments of P V
    uint32_t p[SN][2];
#pragma unroll
    for (int n = 0; n < SN; ++n) {
      const float p0 = expf(s[n][0] - mx[0]), p1 = expf(s[n][1] - mx[0]);
      const float p2 = expf(s[n][2] - mx[1]), p3 = expf(s[n][3] - mx[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      p[n][0] = pack_bf16(p0, p1);
      p[n][1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(FULL, rs[i], 1);
      rs[i] += __shfl_xor_sync(FULL, rs[i], 2);
      l[i] = l[i] * corr[i] + rs[i];
    }
    // a row whose max did not move has corr exactly 1: skip the rescale
    // when that holds for the whole warp
    if (__any_sync(FULL, corr[0] != 1.0f || corr[1] != 1.0f)) {
#pragma unroll
      for (int n = 0; n < ON; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }
    }

    // O += P V: k-steps of 16 keys, V rows as B by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {p[2 * kk][0], p[2 * kk][1], p[2 * kk + 1][0],
                             p[2 * kk + 1][1]};
#pragma unroll
      for (int dp = 0; dp < DM / 16; ++dp) {
        uint32_t bb[4];
        ldsm_x4_t(bb, vbuf + v_off[dp & 3] + (dp >> 2) * 128 + kk * ROW16);
        mma_bf16(o[2 * dp], a, bb[0], bb[1]);
        mma_bf16(o[2 * dp + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();  // this buffer is refilled by the next iteration
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = qr + 8 * i;
    if (qp >= Sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    // a row's m and l are whole in each lane of its quad
    if (lse != nullptr && (lane & 3) == 0)
      lse[((int64_t)b * H + h) * Sq + qp] =
          m[i] > NEG_INF ? m[i] + logf(l[i]) : 1e30f;
    bf16* orow = out + ((int64_t)b * Sq + qp) * qs + (int64_t)h * D;
#pragma unroll
    for (int n = 0; n < ON; ++n) {
      const int d = 8 * n + cq;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) =
            __floats2bfloat162_rn(o[n][2 * i] / lc, o[n][2 * i + 1] / lc);
    }
  }
}

template <int DM, int BK, int MINB>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int Sq, int Skv, int H, int KH, int D,
               int causal, int window, int prefix, float scale,
               cudaStream_t st) {
  const size_t smem = sizeof(bf16) * (size_t)(MBQ + 4 * BK) * DM;
  auto kern = flash_attention_mma_kernel<DM, BK, MINB>;
  static size_t granted[64] = {};
  cudaError_t e = opt_in(kern, smem, granted);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H, (Sq + MBQ - 1) / MBQ, B);
  kern<<<grid, MT, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, Sq, Skv, H,
      KH, D, causal, window, prefix, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// kind: 1 = float32, 2 = bfloat16 (q, k, v and out).  body: 0 = the CUDA
// cores' f32 body, 1 = the tensor-core body (bf16, D % 8 == 0, 16-byte
// aligned q, k, v and out).  0 < D <= 256, H % KH == 0, window 0 = none,
// prefix 0 = none (a prefix only with causal and no window; checked by the
// wrapper).  lse: null, or f32 [B, H, Sq] for each row's log-sum-exp.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, void* lse, int kind, int body, int B,
                           int Sq, int Skv, int H, int KH, int D, int causal,
                           int window, int prefix, float scale,
                           void* stream) {
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > 256 || KH < 1 || H % KH || prefix < 0)
    return (int)cudaErrorInvalidValue;
  if (body == 1) {
    if (kind != 2 || D % 8) return (int)cudaErrorInvalidValue;
    if (D <= 64)
      return launch_mma<64, 64, 2>(q, k, v, out, lse_f, B, Sq, Skv, H, KH,
                                   D, causal, window, prefix, scale, st);
    if (D <= 128)
      return launch_mma<128, 64, 2>(q, k, v, out, lse_f, B, Sq, Skv, H, KH,
                                    D, causal, window, prefix, scale, st);
    return launch_mma<256, 64, 1>(q, k, v, out, lse_f, B, Sq, Skv, H, KH, D,
                                  causal, window, prefix, scale, st);
  }
  if (kind == 2)
    return launch_d<__nv_bfloat16>(q, k, v, out, lse_f, B, Sq, Skv, H, KH, D,
                                   causal, window, prefix, scale, st);
  return launch_d<float>(q, k, v, out, lse_f, B, Sq, Skv, H, KH, D, causal,
                         window, prefix, scale, st);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
