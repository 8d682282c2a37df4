// INT8 GEMM kernels for Hopper (sm_90a): row quantizer + one GEMM template.
//
// Replaces, in src/repro/kernels/cim_gemm.py:
//   quantize_rows_int8           (_rowquant_kernel)
//   cim_gemm_int8_fused_qin      (_cim_gemm_fused_qin_kernel)
//   cim_gemm_int8_fused          (_cim_gemm_fused_kernel)
//   cim_gated_gemm_int8          (_cim_gated_kernel)
//   cim_grouped_gemm_int8        (_cim_grouped_gemm_kernel)
//   cim_grouped_gated_gemm_int8  (_cim_grouped_gated_kernel)
//   cim_gemm_int8                (_cim_gemm_kernel)
// the GEMMs with their quantize_out epilogue (_rowquant) in-kernel, and
// cim_gemm_int8 as the template with an int32 store for its epilogue.
//
// What bounds them on the card: at decode (M = 8 rows) every weight byte
// is used by 8 rows only, so the GEMMs are bound by the int8 weight bytes
// they stream from device memory (2 int8 operations per byte per row,
// far below the ~600 operations per byte where int8 compute would bind).
// The grouped GEMMs are bound by the weight bytes of the experts that
// received tokens: an expert whose count is 0 streams none.  The row
// quantizer runs one block per row, so at decode it has only M = 8
// blocks on 132 SMs: it is bound by that lack of parallelism, not by its
// bytes ([8, 16384] f32 in, about 0.66 MB, for gemma-2b's hidden
// requant, which is too wide for the fused requant below).
//
// Design: one template, cim_gemm_kernel<TX, GATED, EPI, GROUPED>.  A
// block owns an 8-row x 32-column output tile of one expert (blockIdx.z;
// the dense GEMMs, GROUPED false, have one and no skip list); its 256
// threads are 8 column groups (4 adjacent columns each) x 32 slices of
// K.  K is swept in tiles of 1024: the tile's
// activations are packed four int8 values per 32-bit word into shared
// memory (quantized on the fly from f32/bf16 with the row scale found in
// the prologue when TX is a float type, copied when TX is int8).
// Weights stay [K, N] int8 (per expert [E, K, N]) as the public functions
// hold them (no private transposed copy, no extra memory): each thread
// loads 4 rows x 4 columns as four 32-bit words straight into registers,
// transposes the 4x4 bytes with __byte_perm so each word holds 4
// consecutive K values of one column, and feeds __dp4a, accumulating
// exactly in int32.  Every thread issues all its weight loads of a tile
// before it computes, so 32 words per thread are in flight.  The 32 K
// slices are summed through shared memory, and the epilogue runs in f32
// in the reference's order, with explicitly rounded multiplies and adds
// (no fused multiply-add) so results without an activation match the
// plain version bit for bit.  EPI_ACC (cim_gemm_int8, the row-parallel
// partial of tensor parallelism) stores the exact int32 sum instead and
// reads no scale: the caller sums the partials of all ranks and runs the
// epilogue once.  A block of an expert whose count is 0
// (the grouped GEMMs' skip list) skips the K sweep and runs the epilogue
// on zero accumulators, as the reference's kernel does.  GROUPED and
// EPI are compile-time: with the expert offsets and the requant tail
// decided at run time, ptxas gave the dense int8 GEMM 66 registers in
// place of 80 and gemma-2b's down GEMM ran 1.5x slower.
//
// The requant epilogue (quantize_out): a row's scale needs its absmax
// over all N columns, which 32-column blocks share.  Every block writes
// its f32 tile to a scratch buffer, publishes each row's |max| with an
// atomicMax on the float's bits (non-negative floats order as unsigned
// ints; max is exact in any order), fences, and bumps its row band's
// arrival counter.  The block that arrives last quantizes the band's
// rows from the scratch tile (reading through L2, where the other blocks'
// stores and atomics landed, 8 float4 loads in flight per thread) with
// the row quantizer's arithmetic, so q
// and the scale are bitwise quantize_rows_int8 of the f32 output, and
// resets the band's maxima and counter to 0 for the next launch.  One
// launch, the present grid, no block waits on another.  wgmma, TMA and
// split-K over blocks are left for later work.
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
// The epilogue: f32 out, f32 out requantized (quantize_out), int32 sum.
enum Epi { EPI_F32 = 0, EPI_QOUT = 1, EPI_ACC = 2 };

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

// The requant tail of a quantize_out launch: the last block of a row band
// turns the band's f32 rows into int8 codes and scales.  ``h`` holds the
// f32 output of every block of the band, ``amax`` the rows' |max| bits,
// which are reset to 0 for the next launch once read into ``s_rs``.
__device__ __forceinline__ void requant_band(const float* h,
                                             unsigned int* amax,
                                             int8_t* __restrict__ q,
                                             float* __restrict__ qs,
                                             float* s_rs, int m0, int M,
                                             int N, int tid) {
  if (tid < BM && m0 + tid < M) {
    const float s = row_scale(__uint_as_float(__ldcg(&amax[m0 + tid])));
    s_rs[tid] = s;
    qs[m0 + tid] = s;
    amax[m0 + tid] = 0u;
  }
  __syncthreads();
  // The band's rows as one run of float4 (N % 4 == 0), RQ loads in
  // flight per thread before any is quantized: L2 latency, not bytes,
  // bounds one block's pass over 8 x N values.
  constexpr int RQ = 8;
  const int n4 = N / 4;
  const int total = min(BM, M - m0) * n4;
  const float4* h4 = reinterpret_cast<const float4*>(h + (int64_t)m0 * N);
  char4* q4 = reinterpret_cast<char4*>(q + (int64_t)m0 * N);
  for (int i0 = tid; i0 < total; i0 += RQ * NT) {
    float4 v[RQ];
#pragma unroll
    for (int u = 0; u < RQ; ++u)
      if (i0 + u * NT < total) v[u] = __ldcg(&h4[i0 + u * NT]);
#pragma unroll
    for (int u = 0; u < RQ; ++u) {
      const int i = i0 + u * NT;
      if (i < total) {
        const float s = s_rs[i / n4];
        q4[i] = make_char4(quant1(v[u].x, s), quant1(v[u].y, s),
                           quant1(v[u].z, s), quant1(v[u].w, s));
      }
    }
  }
}

// x [E, M, K] (TX), w/w2 [E, K, N] int8; xs [E, M] (int8 x only),
// ws/ws2/bias [E, N] f32; res [M, N] (dense only); counts [E] int32 or
// null (no skip list); out [E, M, N] f32.  With EPI_QOUT out is the f32
// scratch and q [E, M, N] int8, qs [E, M] f32 receive the requantized
// rows; amax [E * M] and arrive [E * gridDim.y] must be 0.  With EPI_ACC
// out holds int32 [M, N] and xs, ws, bias and res are not read.
template <typename TX, bool GATED, int EPI, bool GROUPED>
__global__ void __launch_bounds__(NT)
cim_gemm_kernel(const TX* __restrict__ x, const float* __restrict__ xs,
                const int8_t* __restrict__ w, const float* __restrict__ ws,
                const int8_t* __restrict__ w2, const float* __restrict__ ws2,
                const float* __restrict__ bias, const void* __restrict__ res,
                int res_kind, int act, const int* __restrict__ counts,
                float* __restrict__ out, int8_t* __restrict__ q,
                float* __restrict__ qs,
                unsigned int* amax, int* arrive, int M, int K, int N) {
  constexpr bool QUANT_IN = !std::is_same<TX, int8_t>::value;
  __shared__ float s_scale[BM];
  __shared__ int s_x[BM][KW];
  __shared__ int s_red[TK][BM][BN];
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int tx = tid % TN, ty = tid / TN;
  const int warp = tid / 32, lane = tid % 32;
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ncol = n0 + 4 * tx;

  // This block's expert: offset every per-expert operand.
  bool active = true;
  if constexpr (GROUPED) {
    x += (int64_t)e * M * K;
    w += (int64_t)e * K * N;
    ws += (int64_t)e * N;
    if constexpr (GATED) {
      w2 += (int64_t)e * K * N;
      ws2 += (int64_t)e * N;
    }
    if (bias != nullptr) bias += (int64_t)e * N;
    out += (int64_t)e * M * N;
    active = counts == nullptr || counts[e] > 0;
  }

  // Prologue: the row scales (absmax over the full K when quantizing in).
  if constexpr (QUANT_IN) {
    for (int m = warp; m < BM; m += NT / 32) {
      float amx = 0.0f;
      if (m0 + m < M) {
        const int64_t base = (int64_t)(m0 + m) * K;
        for (int k = lane; k < K; k += 32)
          amx = fmaxf(amx, fabsf(load_f(x, base + k)));
      }
#pragma unroll
      for (int o = 16; o; o >>= 1)
        amx = fmaxf(amx, __shfl_xor_sync(0xffffffffu, amx, o));
      if (lane == 0) s_scale[m] = row_scale(amx);
    }
  } else if constexpr (EPI != EPI_ACC) {
    if (tid < BM)
      s_scale[tid] = (m0 + tid < M) ? xs[(int64_t)e * M + m0 + tid] : 0.0f;
  }
  __syncthreads();

  int acc[BM][4];
  int acc2[BM][4];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = acc2[m][c] = 0;

  // An expert with no tokens streams no weights (uniform per block).
  const int kend = active ? K : 0;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    // Stage the activation tile as packed int8x4 words.
    for (int i = tid; i < BM * KW; i += NT) {
      const int m = i / KW, kw = i % KW;
      const int k = k0 + 4 * kw;
      uint32_t packed = 0;
      if (m0 + m < M) {
        const int64_t base = (int64_t)(m0 + m) * K;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int v = 0;
          if (k + j < K) {
            if constexpr (QUANT_IN)
              v = quant1(load_f(x, base + k + j), s_scale[m]);
            else
              v = (int)x[base + k + j];
          }
          packed |= (uint32_t)(v & 0xff) << (8 * j);
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
  // Thread tid owns row em = tid / 32 (its warp) and column en = lane.
  const int em = tid / BN, en = tid % BN;
  const int gm = m0 + em, gn = n0 + en;
  const bool valid = gm < M && gn < N;
  const int64_t o = (int64_t)gm * N + gn;
  if constexpr (EPI == EPI_ACC) {
    if (valid) reinterpret_cast<int*>(out)[o] = tot;
    return;
  }
  const float xsv = s_scale[em];
  float y = 0.0f;
  if (valid) {
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
  if constexpr (EPI == EPI_QOUT) {

    // publish the rows' |max|; the band's last block requantizes the
    // band (see the note at the top of this file)
    float a = valid ? fabsf(y) : 0.0f;
#pragma unroll
    for (int off = 16; off; off >>= 1)
      a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
    amax += (int64_t)e * M;
    if (lane == 0 && gm < M) atomicMax(&amax[gm], __float_as_uint(a));
    __threadfence();
    __syncthreads();
    int* band = arrive + (int64_t)e * gridDim.y + blockIdx.y;
    if (tid == 0) s_last = atomicAdd(band, 1) == (int)gridDim.x - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    // s_scale is free again: every thread read its row scale before the
    // barriers above
    requant_band(out, amax, q + (int64_t)e * M * N, qs + (int64_t)e * M,
                 s_scale, m0, M, N, tid);
    if (tid == 0) *band = 0;
  }
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

inline dim3 gemm_grid(int E, int M, int N) {
  return dim3((N + BN - 1) / BN, (M + BM - 1) / BM, E);
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
    cim_gemm_kernel<float, false, EPI_F32, false>
        <<<gemm_grid(1, M, N), NT, 0, st>>>(
        static_cast<const float*>(x), nullptr, w8, wsf, nullptr, nullptr, b,
        res, res_kind, act, nullptr, o, nullptr, nullptr, nullptr, nullptr,
        M, K, N);
  else
    cim_gemm_kernel<__nv_bfloat16, false, EPI_F32, false>
        <<<gemm_grid(1, M, N), NT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), nullptr, w8, wsf, nullptr,
        nullptr, b, res, res_kind, act, nullptr, o, nullptr, nullptr, nullptr,
        nullptr, M, K, N);
  return (int)cudaGetLastError();
}

// The pre-quantized GEMMs, dense (E = 1) and grouped, plain (w2 null) or
// gated (act(x w) * (x w2)).  counts null = no skip list; q null = f32
// output in out, else the requantized rows in q / qs with out as scratch.
int cim_gemm_int8_launch(const void* xq, const void* xs, const void* w,
                         const void* ws, const void* w2, const void* ws2,
                         const void* bias, const void* res, int res_kind,
                         const void* counts, int act, void* out, void* q,
                         void* qs, void* amax, void* arrive, int E, int M,
                         int K, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = gemm_grid(E, M, N);
  const int8_t* x8 = static_cast<const int8_t*>(xq);
  const float* xsf = static_cast<const float*>(xs);
  const int* cnt = static_cast<const int*>(counts);
  float* o = static_cast<float*>(out);
  int8_t* q8 = static_cast<int8_t*>(q);
  float* qsf = static_cast<float*>(qs);
  unsigned int* am = static_cast<unsigned int*>(amax);
  int* arr = static_cast<int*>(arrive);
  // dense GEMMs (E = 1) skip the expert offsets and the skip list at
  // compile time; quantize_out is its own instantiation
#define LAUNCH(GATED, EPI, GROUPED)                                        \
  cim_gemm_kernel<int8_t, GATED, EPI, GROUPED><<<grid, NT, 0, st>>>(       \
      x8, xsf, static_cast<const int8_t*>(w), static_cast<const float*>(ws), \
      static_cast<const int8_t*>(w2), static_cast<const float*>(ws2),        \
      static_cast<const float*>(bias), res, res_kind, act, cnt, o, q8, qsf,  \
      am, arr, M, K, N)
#define LAUNCH_Q(GATED, GROUPED)         \
  if (q8 != nullptr)                     \
    LAUNCH(GATED, EPI_QOUT, GROUPED);    \
  else                                   \
    LAUNCH(GATED, EPI_F32, GROUPED)
  const bool gated = w2 != nullptr;
  if (E > 1) {
    if (gated) { LAUNCH_Q(true, true); } else { LAUNCH_Q(false, true); }
  } else {
    if (gated) { LAUNCH_Q(true, false); } else { LAUNCH_Q(false, false); }
  }
#undef LAUNCH_Q
#undef LAUNCH
  return (int)cudaGetLastError();
}

// x_q [M, K] int8 @ w [K, N] int8 -> out int32 [M, N], exact.
int cim_gemm_int8_acc(const void* xq, const void* w, void* out, int M, int K,
                      int N, void* stream) {
  cim_gemm_kernel<int8_t, false, EPI_ACC, false>
      <<<gemm_grid(1, M, N), NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), nullptr, static_cast<const int8_t*>(w),
      nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0, nullptr,
      static_cast<float*>(out), nullptr, nullptr, nullptr, nullptr, M, K, N);
  return (int)cudaGetLastError();
}

const char* cim_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
