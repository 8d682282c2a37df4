// INT8 GEMM kernels for Hopper (sm_90a): row quantizer + one GEMM template.
//
// Replaces, in src/repro/kernels/cim_gemm.py:
//   quantize_rows_int8       (_rowquant_kernel)
//   cim_gemm_int8_fused_qin  (_cim_gemm_fused_qin_kernel)
//   cim_gemm_int8_fused      (_cim_gemm_fused_kernel, without quantize_out)
//   cim_gated_gemm_int8      (_cim_gated_kernel, without quantize_out)
//
// What bounds them on the card: at decode (M = 8 rows) every weight byte
// is used by 8 rows only, so the GEMMs are bound by the int8 weight bytes
// they stream from device memory (2 int8 operations per byte per row,
// far below the ~600 operations per byte where int8 compute would bind).
// The row quantizer runs one block per row, so at decode it has only
// M = 8 blocks on 132 SMs: it is bound by that lack of parallelism, not by
// its bytes ([8, 16384] f32 in, about 0.66 MB, for the hidden requant).
// Splitting each row across blocks, or fusing the requant into the gated
// GEMM's epilogue, is left for later work.
//
// Design: one template, cim_gemm_kernel<TX, GATED>.  A block owns an
// 8-row x 32-column output tile; its 256 threads are 8 column groups
// (4 adjacent columns each) x 32 slices of K.  K is swept in tiles of
// 1024: the tile's activations are packed four int8 values per 32-bit
// word into shared memory (quantized on the fly from f32/bf16 with the
// row scale found in the prologue when TX is a float type, copied when
// TX is int8).  Weights stay [K, N] int8 as the public functions hold
// them (no private transposed copy, no extra memory): each thread loads
// 4 rows x 4 columns as four 32-bit words straight into registers,
// transposes the 4x4 bytes with __byte_perm so each word holds 4
// consecutive K values of one column, and feeds __dp4a, accumulating
// exactly in int32.  Every thread issues all its weight loads of a tile
// before it computes, so 32 words per thread are in flight.  The 32 K
// slices are summed through shared memory, and the epilogue runs in f32
// in the reference's order, with explicitly rounded multiplies and adds
// (no fused multiply-add) so results without an activation match the
// plain version bit for bit.  wgmma, TMA and split-K over blocks are
// left for later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 8;         // output rows per block
constexpr int BN = 32;        // output columns per block
constexpr int TN = BN / 4;    // threads along N, 4 columns each
constexpr int TK = 32;        // threads along K
constexpr int NT = TN * TK;   // threads per block (256)
constexpr int BK = 1024;      // K extent of one shared-memory tile
constexpr int KW = BK / 4;    // packed int8x4 words per row per tile
constexpr int JW = KW / TK;   // packed words per thread per tile
static_assert(BM * BN == NT, "epilogue maps one output per thread");

enum Act { ACT_NONE = 0, ACT_GELU = 1, ACT_SILU = 2, ACT_RELU = 3 };

__device__ __forceinline__ float load_f(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}

// scale = (amax + 1e-12) / 127 with IEEE rounding, as the reference.
__device__ __forceinline__ float row_scale(float amax) {
  return __fdiv_rn(__fadd_rn(amax, 1e-12f), 127.0f);
}

// clip(round_half_even(x / scale), -127, 127)
__device__ __forceinline__ int quant1(float x, float scale) {
  float r = rintf(__fdiv_rn(x, scale));
  return (int)fminf(fmaxf(r, -127.0f), 127.0f);
}

__device__ __forceinline__ float activate(float x, int act) {
  if (act == ACT_GELU) {
    // tanh-approximate GELU in the reference's operation order
    const float c = 0.7978845608028654f;
    float x3 = __fmul_rn(__fmul_rn(x, x), x);
    float inner = __fmul_rn(c, __fadd_rn(x, __fmul_rn(0.044715f, x3)));
    float cdf = __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner)));
    return __fmul_rn(x, cdf);
  }
  if (act == ACT_SILU) {
    return __fmul_rn(x, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x))));
  }
  if (act == ACT_RELU) return fmaxf(x, 0.0f);
  return x;
}

// 4 rows x 4 columns of int8 (r[i] = row i, byte c = column c) ->
// 4 words, col[c] = the 4 rows of column c (byte i = row i).
__device__ __forceinline__ void transpose4x4(const uint32_t r[4],
                                             uint32_t col[4]) {
  uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);  // a0 b0 a1 b1
  uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);  // a2 b2 a3 b3
  uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);  // c0 d0 c1 d1
  uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);  // c2 d2 c3 d3
  col[0] = __byte_perm(t0, t2, 0x5410);
  col[1] = __byte_perm(t0, t2, 0x7632);
  col[2] = __byte_perm(t1, t3, 0x5410);
  col[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ void load_rows(const int8_t* __restrict__ w,
                                          int k, int K, int N, int ncol,
                                          uint32_t r[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k + i;
    r[i] = (kr < K && ncol < N)
               ? __ldg(reinterpret_cast<const unsigned int*>(
                     w + (int64_t)kr * N + ncol))
               : 0u;
  }
}

// Sum one int32 accumulator tile over the TK slices of K; returns the
// total for this thread's epilogue element (row tid / BN, col tid % BN).
__device__ __forceinline__ int reduce_k(int (*s_red)[BM][BN],
                                        int acc[BM][4], int tx, int ty,
                                        int tid) {
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) s_red[ty][m][4 * tx + c] = acc[m][c];
  __syncthreads();
  const int em = tid / BN, en = tid % BN;
  int s = 0;
#pragma unroll 8
  for (int t = 0; t < TK; ++t) s += s_red[t][em][en];
  __syncthreads();
  return s;
}

template <typename TX, bool GATED>
__global__ void __launch_bounds__(NT)
cim_gemm_kernel(const TX* __restrict__ x, const float* __restrict__ xs,
                const int8_t* __restrict__ w, const float* __restrict__ ws,
                const int8_t* __restrict__ w2, const float* __restrict__ ws2,
                const float* __restrict__ bias, const void* __restrict__ res,
                int res_kind, int act, float* __restrict__ out, int M, int K,
                int N) {
  constexpr bool QUANT_IN = !std::is_same<TX, int8_t>::value;
  __shared__ float s_scale[BM];
  __shared__ int s_x[BM][KW];
  __shared__ int s_red[TK][BM][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TN, ty = tid / TN;
  const int warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ncol = n0 + 4 * tx;

  // Prologue: the row scales (absmax over the full K when quantizing in).
  if constexpr (QUANT_IN) {
    for (int m = warp; m < BM; m += NT / 32) {
      float amax = 0.0f;
      if (m0 + m < M) {
        const int64_t base = (int64_t)(m0 + m) * K;
        for (int k = lane; k < K; k += 32)
          amax = fmaxf(amax, fabsf(load_f(x, base + k)));
      }
#pragma unroll
      for (int o = 16; o; o >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      if (lane == 0) s_scale[m] = row_scale(amax);
    }
  } else {
    if (tid < BM) s_scale[tid] = (m0 + tid < M) ? xs[m0 + tid] : 0.0f;
  }
  __syncthreads();

  int acc[BM][4];
  int acc2[BM][4];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = acc2[m][c] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // Stage the activation tile as packed int8x4 words.
    for (int i = tid; i < BM * KW; i += NT) {
      const int m = i / KW, kw = i % KW;
      const int k = k0 + 4 * kw;
      uint32_t packed = 0;
      if (m0 + m < M) {
        const int64_t base = (int64_t)(m0 + m) * K;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int q = 0;
          if (k + e < K) {
            if constexpr (QUANT_IN)
              q = quant1(load_f(x, base + k + e), s_scale[m]);
            else
              q = (int)x[base + k + e];
          }
          packed |= (uint32_t)(q & 0xff) << (8 * e);
        }
      }
      s_x[m][kw] = (int)packed;
    }
    __syncthreads();

    uint32_t wr[JW][4];
    uint32_t wr2[GATED ? JW : 1][4];
#pragma unroll
    for (int j = 0; j < JW; ++j) {
      const int k = k0 + 4 * (ty + TK * j);
      load_rows(w, k, K, N, ncol, wr[j]);
      if constexpr (GATED) load_rows(w2, k, K, N, ncol, wr2[j]);
    }
#pragma unroll
    for (int j = 0; j < JW; ++j) {
      const int kw = ty + TK * j;
      uint32_t col[4];
      transpose4x4(wr[j], col);
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const int xw = s_x[m][kw];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[m][c] = __dp4a(xw, (int)col[c], acc[m][c]);
      }
      if constexpr (GATED) {
        transpose4x4(wr2[j], col);
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          const int xw = s_x[m][kw];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc2[m][c] = __dp4a(xw, (int)col[c], acc2[m][c]);
        }
      }
    }
    __syncthreads();
  }

  const int tot = reduce_k(s_red, acc, tx, ty, tid);
  int tot2 = 0;
  if constexpr (GATED) tot2 = reduce_k(s_red, acc2, tx, ty, tid);

  // Epilogue (post-processing): dequant, bias, activation, residual.
  const int em = tid / BN, en = tid % BN;
  const int gm = m0 + em, gn = n0 + en;
  if (gm >= M || gn >= N) return;
  const float xsv = s_scale[em];
  const int64_t o = (int64_t)gm * N + gn;
  float y;
  if constexpr (GATED) {
    const float g = __fmul_rn(__fmul_rn((float)tot, xsv), ws[gn]);
    const float u = __fmul_rn(__fmul_rn((float)tot2, xsv), ws2[gn]);
    y = __fmul_rn(activate(g, act), u);
  } else {
    y = __fmul_rn(__fmul_rn((float)tot, xsv), ws[gn]);
    if (bias != nullptr) y = __fadd_rn(y, bias[gn]);
    y = activate(y, act);
    if (res_kind == 1)
      y = __fadd_rn(y, static_cast<const float*>(res)[o]);
    else if (res_kind == 2)
      y = __fadd_rn(
          y, __bfloat162float(static_cast<const __nv_bfloat16*>(res)[o]));
  }
  out[o] = y;
}

// One block per row: absmax reduction, then quantize the row.
template <typename T>
__global__ void __launch_bounds__(256)
rowquant_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scale, int K) {
  __shared__ float s_amax[32];
  const int64_t base = (int64_t)blockIdx.x * K;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float amax = 0.0f;
  for (int k = tid; k < K; k += blockDim.x)
    amax = fmaxf(amax, fabsf(load_f(x, base + k)));
#pragma unroll
  for (int o = 16; o; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (lane == 0) s_amax[warp] = amax;
  __syncthreads();
  if (warp == 0) {
    amax = lane < (int)(blockDim.x / 32) ? s_amax[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (lane == 0) s_amax[0] = amax;
  }
  __syncthreads();
  const float s = row_scale(s_amax[0]);
  for (int k = tid; k < K; k += blockDim.x)
    q[base + k] = (int8_t)quant1(load_f(x, base + k), s);
  if (tid == 0) scale[blockIdx.x] = s;
}

inline dim3 gemm_grid(int M, int N) {
  return dim3((N + BN - 1) / BN, (M + BM - 1) / BM);
}

}  // namespace

// x_kind / res_kind: 1 = float32, 2 = bfloat16 (res_kind 0 = none).
// act: 0 none, 1 gelu (tanh), 2 silu, 3 relu.
// Each entry point returns cudaGetLastError() after its launch.
extern "C" {

int cim_quantize_rows_int8(const void* x, int x_kind, void* q, void* scale,
                           int M, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_kind == 1)
    rowquant_kernel<float><<<M, 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scale), K);
  else
    rowquant_kernel<__nv_bfloat16><<<M, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scale), K);
  return (int)cudaGetLastError();
}

int cim_gemm_int8_fused_qin(const void* x, int x_kind, const void* w,
                            const void* ws, const void* bias, const void* res,
                            int res_kind, int act, void* out, int M, int K,
                            int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* w8 = static_cast<const int8_t*>(w);
  const float* wsf = static_cast<const float*>(ws);
  const float* b = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  if (x_kind == 1)
    cim_gemm_kernel<float, false><<<gemm_grid(M, N), NT, 0, st>>>(
        static_cast<const float*>(x), nullptr, w8, wsf, nullptr, nullptr, b,
        res, res_kind, act, o, M, K, N);
  else
    cim_gemm_kernel<__nv_bfloat16, false><<<gemm_grid(M, N), NT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), nullptr, w8, wsf, nullptr,
        nullptr, b, res, res_kind, act, o, M, K, N);
  return (int)cudaGetLastError();
}

int cim_gemm_int8_fused(const void* xq, const void* xs, const void* w,
                        const void* ws, const void* bias, const void* res,
                        int res_kind, int act, void* out, int M, int K, int N,
                        void* stream) {
  cim_gemm_kernel<int8_t, false>
      <<<gemm_grid(M, N), NT, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
          static_cast<const int8_t*>(w), static_cast<const float*>(ws),
          nullptr, nullptr, static_cast<const float*>(bias), res, res_kind,
          act, static_cast<float*>(out), M, K, N);
  return (int)cudaGetLastError();
}

int cim_gated_gemm_int8(const void* xq, const void* xs, const void* wg,
                        const void* gs, const void* wu, const void* us,
                        int act, void* out, int M, int K, int N,
                        void* stream) {
  cim_gemm_kernel<int8_t, true>
      <<<gemm_grid(M, N), NT, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
          static_cast<const int8_t*>(wg), static_cast<const float*>(gs),
          static_cast<const int8_t*>(wu), static_cast<const float*>(us),
          nullptr, nullptr, 0, act, static_cast<float*>(out), M, K, N);
  return (int)cudaGetLastError();
}

const char* cim_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
