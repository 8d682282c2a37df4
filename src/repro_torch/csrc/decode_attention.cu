// Flash-decode over the ring KV cache for Hopper (sm_90a).
//
// Replaces src/repro/kernels/decode_attention.py::decode_attention
// (_decode_kernel, _attend_block, _keep_blocks): one query token per
// sequence attends over the cache with an online softmax; int8 K/V are
// dequantized inside the kernel with the per-(slot, head) scales factored
// out of the dots, s = (q . k_q) * k_scale * (1/sqrt(D)) and
// o += (p * v_scale) . v_q.
//
// What bounds it on the card: the K/V bytes of the visible slots (one
// int8 byte per element, plus scales and positions); the dots are 2
// operations per byte.  One block per (batch row, kv head) holds all G
// query rows of the GQA group, so each K/V byte is read once for the
// whole group.
//
// Design: the block walks the S slots in steps of BS (64 int8 slots).
// A step whose slots are all masked (beyond q_pos, or outside the
// sliding window) is skipped, as the reference's keep list skips its
// blocks; the skip is exact because a masked slot's probability is
// exp(-1e30 - m) = 0, and a row with no visible slot at all skips
// nothing, so it gets the reference's uniform softmax.  A kept step
// copies its K and V rows into shared memory with 16-byte loads, all
// issued before any is used.  Each warp then scores whole slots (lanes
// split D, a shuffle reduction per query row) and masks with -1e30; one
// warp per query row updates the running max m and sum l and turns the
// scores into probabilities (times v_scale on the int8 path); each
// thread owns one head dimension d for a few query rows and accumulates
// p . v in registers, rescaled by exp(m_old - m_new).  l is clamped at
// 1e-30 before the division.  A walk split across blocks (split-KV) and
// copies overlapped with compute are left for later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 256;      // threads per block
constexpr int NW = NT / 32;  // warps per block
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

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

// slots per step: 64 int8 rows, 32 bf16 rows, 16 f32 rows
template <typename TKV>
__host__ __device__ constexpr int steps_slots() {
  return 64 / (int)sizeof(TKV);
}

// Copy nj rows of D elements (global row stride `stride` elements) into
// a dense [nj][D] shared-memory tile.
template <typename TKV>
__device__ __forceinline__ void stage_rows(TKV* __restrict__ dst,
                                           const TKV* __restrict__ src,
                                           int64_t stride, int nj, int D,
                                           int tid) {
  const int row_bytes = D * (int)sizeof(TKV);
  if (row_bytes % 16 == 0 && (stride * (int64_t)sizeof(TKV)) % 16 == 0 &&
      (reinterpret_cast<uintptr_t>(src) % 16) == 0) {
    const int per_row = row_bytes / 16;
    for (int i = tid; i < nj * per_row; i += NT) {
      const int r = i / per_row, c = i % per_row;
      reinterpret_cast<uint4*>(dst + (int64_t)r * D)[c] =
          reinterpret_cast<const uint4*>(src + r * stride)[c];
    }
  } else {
    for (int i = tid; i < nj * D; i += NT) {
      const int r = i / D, c = i % D;
      dst[(int64_t)r * D + c] = src[r * stride + c];
    }
  }
}

template <typename TQ, typename TKV, int MAXG>
__global__ void __launch_bounds__(NT)
decode_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                        const TKV* __restrict__ v,
                        const int32_t* __restrict__ pos,
                        const int32_t* __restrict__ q_pos,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        TQ* __restrict__ out, int S, int KH, int G, int D,
                        int window, float scale) {
  constexpr bool QUANT = std::is_same<TKV, int8_t>::value;
  constexpr int BS = steps_slots<TKV>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TKV* s_k = reinterpret_cast<TKV*>(smem_raw);           // [BS][D]
  TKV* s_v = s_k + BS * D;                               // [BS][D]
  float* s_q = reinterpret_cast<float*>(s_v + BS * D);   // [G][D]
  float* s_p = s_q + G * D;                              // [G][BS]
  float* s_corr = s_p + G * BS;                          // [G]
  float* s_m = s_corr + G;                               // [G]
  float* s_l = s_m + G;                                  // [G]
  int* s_ok = reinterpret_cast<int*>(s_l + G);           // [BS]

  const int kh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qp = q_pos[b];
  const int32_t* prow = pos + (int64_t)b * S;
  auto visible = [&](int kp) {
    return kp <= qp && (window <= 0 || kp > qp - window);
  };

  const int64_t q_base = ((int64_t)b * KH + kh) * G * D;
  for (int i = tid; i < G * D; i += NT) s_q[i] = to_f(q[q_base + i]);
  for (int g = tid; g < G; g += NT) {
    s_m[g] = NEG_INF;
    s_l[g] = 0.0f;
  }
  // A row with no visible slot keeps every step (uniform softmax).
  int any = 0;
  for (int j = tid; j < S; j += NT) any |= visible(prow[j]);
  const bool skip_ok = __syncthreads_or(any) != 0;

  // accumulator ownership: head dim d_own, query rows g0 + t * gstep
  const int gstep = NT / D;
  const int d_own = tid % D, g0 = tid / D;
  float acc[MAXG];
#pragma unroll
  for (int t = 0; t < MAXG; ++t) acc[t] = 0.0f;

  const int64_t row_stride = (int64_t)KH * D;  // elements between slots
  for (int j0 = 0; j0 < S; j0 += BS) {
    const int nj = min(BS, S - j0);
    int ok = 0;
    if (tid < nj) {
      ok = visible(prow[j0 + tid]);
      s_ok[tid] = ok;
    }
    if (__syncthreads_or(ok) == 0 && skip_ok) continue;

    // 1. stage the step's K and V rows
    const int64_t base = ((int64_t)b * S + j0) * row_stride + kh * D;
    stage_rows(s_k, k + base, row_stride, nj, D, tid);
    stage_rows(s_v, v + base, row_stride, nj, D, tid);
    __syncthreads();

    // 2. scores, one warp per slot
    for (int jj = warp; jj < nj; jj += NW) {
      const TKV* kr = s_k + jj * D;
      float part[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) part[g] = 0.0f;
      for (int d = lane; d < D; d += 32) {
        const float kv = to_f(kr[d]);
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          if (g < G) part[g] = fmaf(s_q[g * D + d], kv, part[g]);
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
#pragma unroll
        for (int o = 16; o; o >>= 1)
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], o);
      }
      if (lane == 0) {
        const float ks =
            QUANT ? k_scale[((int64_t)b * S + j0 + jj) * KH + kh] : 1.0f;
        const bool vis = s_ok[jj] != 0;
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < G) {
            float s = part[g];
            if (QUANT) s = __fmul_rn(s, ks);
            s = __fmul_rn(s, scale);
            s_p[g * BS + jj] = vis ? s : NEG_INF;
          }
        }
      }
    }
    __syncthreads();

    // 3. online-softmax update, one warp per query row
    for (int g = warp; g < G; g += NW) {
      float* row = s_p + g * BS;
      float mx = NEG_INF;
      for (int jj = lane; jj < nj; jj += 32) mx = fmaxf(mx, row[jj]);
#pragma unroll
      for (int o = 16; o; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = s_m[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int jj = lane; jj < nj; jj += 32) {
        float p = expf(row[jj] - m_new);
        sum += p;
        if (QUANT) {
          p = __fmul_rn(p, v_scale[((int64_t)b * S + j0 + jj) * KH + kh]);
        } else if (std::is_same<TKV, __nv_bfloat16>::value) {
          // the reference casts p to the cache dtype before the PV dot
          p = __bfloat162float(__float2bfloat16(p));
        }
        row[jj] = p;
      }
#pragma unroll
      for (int o = 16; o; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        s_corr[g] = corr;
        s_l[g] = s_l[g] * corr + sum;
        s_m[g] = m_new;
      }
    }
    __syncthreads();

    // 4. acc = acc * corr + p . v for this thread's (g, d) elements
    float pv[MAXG];
#pragma unroll
    for (int t = 0; t < MAXG; ++t) pv[t] = 0.0f;
    for (int jj = 0; jj < nj; ++jj) {
      const float vv = to_f(s_v[jj * D + d_own]);
#pragma unroll
      for (int t = 0; t < MAXG; ++t) {
        const int g = g0 + t * gstep;
        if (g < G) pv[t] = fmaf(s_p[g * BS + jj], vv, pv[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < MAXG; ++t) {
      const int g = g0 + t * gstep;
      if (g < G) acc[t] = acc[t] * s_corr[g] + pv[t];
    }
    __syncthreads();
  }

  const int64_t o_base = ((int64_t)b * KH + kh) * G * D;
#pragma unroll
  for (int t = 0; t < MAXG; ++t) {
    const int g = g0 + t * gstep;
    if (g < G) {
      const float l = fmaxf(s_l[g], 1e-30f);
      out[o_base + (int64_t)g * D + d_own] = from_f<TQ>(acc[t] / l);
    }
  }
}

template <typename TQ, typename TKV, int MAXG>
int launch_g(const void* q, const void* k, const void* v, const void* pos,
             const void* q_pos, const void* ks, const void* vs, void* out,
             int B, int S, int KH, int G, int D, int window, float scale,
             cudaStream_t st) {
  constexpr int BS = steps_slots<TKV>();
  const size_t smem = 2 * (size_t)BS * D * sizeof(TKV) +
                      sizeof(float) * ((size_t)G * D + (size_t)G * BS + 3 * G) +
                      sizeof(int) * BS;
  auto kern = decode_attention_kernel<TQ, TKV, MAXG>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(KH, B), NT, smem, st>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const int32_t*>(pos),
      static_cast<const int32_t*>(q_pos), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<TQ*>(out), S, KH, G, D,
      window, scale);
  return (int)cudaGetLastError();
}

// MAXG: accumulators per thread = query rows per head dim; the smallest
// power of two that covers G (the wrapper keeps G <= 16).
template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const void* pos,
           const void* q_pos, const void* ks, const void* vs, void* out,
           int B, int S, int KH, int G, int D, int window, float scale,
           cudaStream_t st) {
#define REPRO_LAUNCH(MG)                                                   \
  return launch_g<TQ, TKV, MG>(q, k, v, pos, q_pos, ks, vs, out, B, S, KH, \
                               G, D, window, scale, st)
  if (G <= 1) REPRO_LAUNCH(1);
  if (G <= 2) REPRO_LAUNCH(2);
  if (G <= 4) REPRO_LAUNCH(4);
  if (G <= 8) REPRO_LAUNCH(8);
  REPRO_LAUNCH(16);
#undef REPRO_LAUNCH
}

}  // namespace

extern "C" {

// q_kind: 1 = float32, 2 = bfloat16.  kv_kind: 0 = int8 (k_scale and
// v_scale given), otherwise the same code as q_kind.  window 0 = none.
// Requires 256 % D == 0 and G <= 16 (checked by the wrapper).
int decode_attention_launch(const void* q, int q_kind, const void* k,
                            const void* v, int kv_kind, const void* pos,
                            const void* q_pos, const void* k_scale,
                            const void* v_scale, void* out, int B, int S,
                            int KH, int G, int D, int window, float scale,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_kind == 2) {
    if (kv_kind == 0)
      return launch<__nv_bfloat16, int8_t>(q, k, v, pos, q_pos, k_scale,
                                           v_scale, out, B, S, KH, G, D,
                                           window, scale, st);
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, pos, q_pos, nullptr,
                                                nullptr, out, B, S, KH, G, D,
                                                window, scale, st);
  }
  if (kv_kind == 0)
    return launch<float, int8_t>(q, k, v, pos, q_pos, k_scale, v_scale, out,
                                 B, S, KH, G, D, window, scale, st);
  return launch<float, float>(q, k, v, pos, q_pos, nullptr, nullptr, out, B,
                              S, KH, G, D, window, scale, st);
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
