// Flash-attention prefill for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py: flash_attention
// (_flash_kernel): causal or sliding-window attention of a whole prompt,
// an online softmax over KV blocks, GQA through the KV index map h // G.
//
// What bounds it on the card: the two products, 4 * Sq * Skv * D
// operations per head (about half of that under the causal mask),
// against q, k, v and the output read or written once; at gemma-2b's
// prefill (S 2048, D 256) that is ~900 operations per byte, far above
// the ~295 where bf16 tensor cores stop waiting for memory, so the bound
// is arithmetic.  This kernel does that arithmetic in f32 on the CUDA
// cores (fused multiply-adds, not the tensor cores), so it runs well
// above the bf16 bound; mma/wgmma tiles are left for later work.
//
// Design: one block per (q tile of BQ = 64 rows, head, batch row); the
// TPU's sequential kv grid axis becomes a loop inside the block over KV
// tiles of BK = 32 keys, so the online-softmax state lives in registers
// for the whole sweep and the output is written once.  The block stages
// its q tile in shared memory as f32 once; per KV tile it stages K
// transposed ([d][key], padded against bank conflicts) and V ([key][d]),
// both as f32, read from KV head h / G in place (KV is never repeated).
// Warp w owns query rows w, w + 8, ..., w + 56; lane j scores key j of
// the tile for those 8 rows (float4 reads of q, broadcast), multiplies by
// 1/sqrt(D) and masks with -1e30, as the reference does; keys past Skv
// score -inf, so they weigh exactly 0.  The row max and sum are warp
// shuffles, and the running (m, l) of each row is held by every lane of
// its warp: m_new = max(m, max s), p = exp(s - m_new), l = l * corr +
// sum p with corr = exp(m - m_new).  p is rounded to v's dtype before PV
// when that is bf16 (the reference's p.astype(v.dtype)); l sums the
// unrounded p.  The lane that owns head dims lane + 32u of a row keeps
// its accumulators in registers: acc = acc * corr + sum_j p_j v_j, p_j
// broadcast from lane j by a shuffle.  The end writes
// acc / max(l, 1e-30) in q's dtype.
//
// Masks and skipped tiles: the causal mask is aligned top-left (query
// and key positions both start at 0).  A block walks only the KV tiles
// between the first visible key of its first row and the last visible
// key of its last row; the keys it skips are masked for every row of the
// tile, which the reference's kernel computes to exactly nothing (a
// masked block before the first live one is erased by corr = exp(-1e30
// - m) = 0, one after it adds exp(-1e30 - m) = 0).  A row with no
// visible key attends uniformly over all Skv keys in the reference; a
// block holding such a row walks every tile, so it does too.
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

// q [B, Sq, H, D]; k, v [B, Skv, KH, D]; out [B, Sq, H, D].  DMAX: the
// head dims a lane's accumulators cover (32 per register), >= D.
template <typename T, int DMAX>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Skv, int H, int KH, int D, int causal, int window,
                       float scale) {
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
  auto hi_of = [&](int qp) { return causal ? min(qp, Skv - 1) : Skv - 1; };
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
      const bool vis = (!causal || kp <= qp) &&
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
    T* o = out + (((int64_t)b * Sq + qp) * H + h) * D;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int d = lane + 32 * u;
      if (d < D) o[d] = from_f<T>(acc[i][u] / lc);
    }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int H, int KH, int D, int causal, int window,
           float scale, cudaStream_t st) {
  const int Dp = (D + 3) & ~3;
  const size_t smem =
      sizeof(float) * ((size_t)BQ * Dp + (size_t)Dp * KTS + (size_t)BK * DMAX);
  auto kern = flash_attention_kernel<T, DMAX>;
  // above 48 KB a kernel needs the attribute; set once per device, outside
  // any graph capture (the first call of a size is never captured)
  static size_t granted[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > 48 * 1024 && smem > granted[dev % 64]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    granted[dev % 64] = smem;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, st>>>(static_cast<const T*>(q),
                               static_cast<const T*>(k),
                               static_cast<const T*>(v), static_cast<T*>(out),
                               Sq, Skv, H, KH, D, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             int Sq, int Skv, int H, int KH, int D, int causal, int window,
             float scale, cudaStream_t st) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, out, B, Sq, Skv, H, KH, D, causal, window,
                         scale, st);
  if (D <= 128)
    return launch<T, 128>(q, k, v, out, B, Sq, Skv, H, KH, D, causal, window,
                          scale, st);
  return launch<T, 256>(q, k, v, out, B, Sq, Skv, H, KH, D, causal, window,
                        scale, st);
}

}  // namespace

extern "C" {

// kind: 1 = float32, 2 = bfloat16 (q, k, v and out).  0 < D <= 256,
// H % KH == 0, window 0 = none (checked by the wrapper).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int kind, int B, int Sq, int Skv, int H,
                           int KH, int D, int causal, int window, float scale,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > 256 || KH < 1 || H % KH) return (int)cudaErrorInvalidValue;
  if (kind == 2)
    return launch_d<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, KH, D, causal,
                                   window, scale, st);
  return launch_d<float>(q, k, v, out, B, Sq, Skv, H, KH, D, causal, window,
                         scale, st);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
