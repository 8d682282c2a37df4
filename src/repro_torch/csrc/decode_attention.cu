// Flash-decode for Hopper (sm_90a): the ring cache, the paged
// (block-table) cache and the split-KV walk with its combine.
//
// Replaces src/repro/kernels/decode_attention.py:
//   decode_attention (_decode_kernel, _attend_block, _keep_blocks), the
//   ring kernel;
//   decode_attention_paged (_decode_paged_kernel), the same body reading
//   KV blocks of shared pools through per-row block tables;
//   decode_attention_splitkv (_decode_splitkv_kernel), the KV walk cut
//   into NS slices that emit raw (o, m, l), and _combine_kernel, which
//   renormalizes them.
// One query token per sequence attends over the cache with an online
// softmax; int8 K/V are dequantized inside the kernel with the
// per-(slot, head) scales factored out of the dots,
// s = (q . k_q) * k_scale * (1/sqrt(D)) and o += (p * v_scale) . v_q.
//
// What bounds it on the card: the K/V bytes of the visible slots (one
// int8 byte per element, plus scales and positions); the dots are 2
// operations per byte.  One block per (batch row, kv head[, split])
// holds all G query rows of the GQA group, so each K/V byte is read
// once for the whole group.  The ring and paged walks run B x KH
// blocks; at B = 8, KH = 1 that is 8 blocks on 132 SMs, which is what
// the split walk is for: B x KH x NS blocks on a long cache.
//
// Design: one kernel body, decode_attention_kernel<TQ, TKV, MAXG, MODE>,
// for all three walks, so that their arithmetic is the same instruction
// for instruction.  The block walks its logical slots in steps of BS
// (64 int8 slots).  Each step first maps its slots to physical rows:
// slot j of row b is row b * S + j of the ring, or row
// tables[b, j / bs] * bs + j % bs of the pools (the ring is the paged
// kernel with the identity table), and every load of K, V, scales and
// positions goes through that row.  A step whose slots are all masked
// (beyond q_pos, or outside the sliding window) is skipped, as the
// reference's keep list skips its blocks; the skip is exact because a
// masked slot's probability is exp(-1e30 - m) = 0.  A row with no
// visible slot anywhere skips nothing, so it gets the reference's
// uniform softmax; that exception is decided over the row's whole
// logical range (null table entries included) in every mode, also by
// each split.  A kept step copies its K and V rows into shared memory
// with 16-byte loads, all issued before any is used.  Each warp then
// scores whole slots (lanes split D, a shuffle reduction per query row)
// and masks with -1e30; one warp per query row updates the running max
// m and sum l and turns the scores into probabilities (times v_scale on
// the int8 path); each thread owns one head dimension d for a few query
// rows and accumulates p . v in registers, rescaled by exp(m_old -
// m_new).  The ring and paged walks end with acc / max(l, 1e-30).  A
// split walks [split * L, min(S, (split + 1) * L)) with L a multiple of
// the step, so its steps are the single walk's steps, and writes its raw
// acc, m and l; a split with no kept step writes m = -1e30, l = 0,
// acc = 0.  The combine (one block per (row, kv head)) takes
// m_g = max_s m, w = exp(m - m_g), l_g = sum l w, acc = sum o w and
// writes acc / max(l_g, 1e-30) in q's dtype; its products and sums are
// rounded one by one (__fmul_rn, __fadd_rn), so at NS = 1 (w = 1
// exactly) it returns the single walk's bits.  Copies overlapped with
// compute are left for later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 256;      // threads per block
constexpr int NW = NT / 32;  // warps per block
constexpr float NEG_INF = -1e30f;

enum Mode { RING = 0, PAGED = 1, SPLIT = 2 };

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

// Everything a walk reads and writes.  Ring and split: k/v [B, S, KH, D],
// pos [B, S], scales [B, S, KH].  Paged: k/v [NB, bs, KH, D],
// pos [NB, bs], scales [NB, bs, KH], tables [B, nb], S = nb * bs.
template <typename TQ, typename TKV>
struct Args {
  const TQ* q;
  const TKV* k;
  const TKV* v;
  const int32_t* pos;
  const int32_t* q_pos;
  const float* k_scale;
  const float* v_scale;
  const int32_t* tables;
  TQ* out;        // ring, paged: [B, KH, G, D]
  float* o_part;  // split: [B, KH, NS, G, D]
  float* m_part;  // split: [B, KH, NS, G]
  float* l_part;  // split: [B, KH, NS, G]
  int S, KH, G, D, window;
  int bs, nb, NB;  // paged
  int split_len;   // split: slots per split, a multiple of 64
  float scale;
};

// Copy nj K or V rows of D elements into a dense [nj][D] shared-memory
// tile; row r starts at element slots[r] * stride + col0 of src.
template <typename TKV>
__device__ __forceinline__ void stage_rows(TKV* __restrict__ dst,
                                           const TKV* __restrict__ src,
                                           const int* __restrict__ slots,
                                           int64_t stride, int64_t col0,
                                           int nj, int D, bool vec,
                                           int tid) {
  if (vec) {
    const int per_row = D * (int)sizeof(TKV) / 16;
    for (int i = tid; i < nj * per_row; i += NT) {
      const int r = i / per_row, c = i % per_row;
      reinterpret_cast<uint4*>(dst + (int64_t)r * D)[c] =
          reinterpret_cast<const uint4*>(src + slots[r] * stride + col0)[c];
    }
  } else {
    for (int i = tid; i < nj * D; i += NT) {
      const int r = i / D, c = i % D;
      dst[(int64_t)r * D + c] = src[slots[r] * stride + col0 + c];
    }
  }
}

template <typename TQ, typename TKV, int MAXG, int MODE>
__global__ void __launch_bounds__(NT)
decode_attention_kernel(const Args<TQ, TKV> a) {
  constexpr bool QUANT = std::is_same<TKV, int8_t>::value;
  constexpr int BS = steps_slots<TKV>();
  const int S = a.S, KH = a.KH, G = a.G, D = a.D, window = a.window;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TKV* s_k = reinterpret_cast<TKV*>(smem_raw);           // [BS][D]
  TKV* s_v = s_k + BS * D;                               // [BS][D]
  float* s_q = reinterpret_cast<float*>(s_v + BS * D);   // [G][D]
  float* s_p = s_q + G * D;                              // [G][BS]
  float* s_corr = s_p + G * BS;                          // [G]
  float* s_m = s_corr + G;                               // [G]
  float* s_l = s_m + G;                                  // [G]
  int* s_ok = reinterpret_cast<int*>(s_l + G);           // [BS]
  int* s_slot = s_ok + BS;                               // [BS]

  const int kh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qp = a.q_pos[b];
  auto visible = [&](int kp) {
    return kp <= qp && (window <= 0 || kp > qp - window);
  };
  // physical row of logical slot j of row b
  auto slot_of = [&](int j) -> int {
    if constexpr (MODE == PAGED) {
      int blk = a.tables[(int64_t)b * a.nb + j / a.bs];
      if (blk < 0 || blk >= a.NB) blk = 0;  // never read outside the pool
      return blk * a.bs + j % a.bs;
    } else {
      return b * S + j;
    }
  };

  const int64_t q_base = ((int64_t)b * KH + kh) * G * D;
  for (int i = tid; i < G * D; i += NT) s_q[i] = to_f(a.q[q_base + i]);
  for (int g = tid; g < G; g += NT) {
    s_m[g] = NEG_INF;
    s_l[g] = 0.0f;
  }
  // A row with no visible slot keeps every step (uniform softmax).
  int any = 0;
  for (int j = tid; j < S; j += NT) any |= visible(a.pos[slot_of(j)]);
  const bool skip_ok = __syncthreads_or(any) != 0;

  int j_lo = 0, j_hi = S;
  if constexpr (MODE == SPLIT) {
    j_lo = split * a.split_len;
    j_hi = min(S, j_lo + a.split_len);
  }

  // accumulator ownership: head dim d_own, query rows g0 + t * gstep
  const int gstep = NT / D;
  const int d_own = tid % D, g0 = tid / D;
  float acc[MAXG];
#pragma unroll
  for (int t = 0; t < MAXG; ++t) acc[t] = 0.0f;

  const int64_t row_stride = (int64_t)KH * D;  // elements between rows
  const int64_t col0 = (int64_t)kh * D;
  const bool vec = (D * (int)sizeof(TKV)) % 16 == 0 &&
                   (row_stride * (int64_t)sizeof(TKV)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.v) % 16 == 0;
  for (int j0 = j_lo; j0 < j_hi; j0 += BS) {
    const int nj = min(BS, j_hi - j0);
    int ok = 0;
    if (tid < nj) {
      const int p = slot_of(j0 + tid);
      s_slot[tid] = p;
      ok = visible(a.pos[p]);
      s_ok[tid] = ok;
    }
    if (__syncthreads_or(ok) == 0 && skip_ok) continue;

    // 1. stage the step's K and V rows
    stage_rows(s_k, a.k, s_slot, row_stride, col0, nj, D, vec, tid);
    stage_rows(s_v, a.v, s_slot, row_stride, col0, nj, D, vec, tid);
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
            QUANT ? a.k_scale[(int64_t)s_slot[jj] * KH + kh] : 1.0f;
        const bool vis = s_ok[jj] != 0;
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < G) {
            float s = part[g];
            if (QUANT) s = __fmul_rn(s, ks);
            s = __fmul_rn(s, a.scale);
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
          p = __fmul_rn(p, a.v_scale[(int64_t)s_slot[jj] * KH + kh]);
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

  if constexpr (MODE == SPLIT) {
    // raw partial state, renormalized by the combine kernel
    const int64_t part = ((int64_t)b * KH + kh) * gridDim.z + split;
#pragma unroll
    for (int t = 0; t < MAXG; ++t) {
      const int g = g0 + t * gstep;
      if (g < G) a.o_part[(part * G + g) * D + d_own] = acc[t];
    }
    for (int g = tid; g < G; g += NT) {
      a.m_part[part * G + g] = s_m[g];
      a.l_part[part * G + g] = s_l[g];
    }
  } else {
    const int64_t o_base = ((int64_t)b * KH + kh) * G * D;
#pragma unroll
    for (int t = 0; t < MAXG; ++t) {
      const int g = g0 + t * gstep;
      if (g < G) {
        const float l = fmaxf(s_l[g], 1e-30f);
        a.out[o_base + (int64_t)g * D + d_own] = from_f<TQ>(acc[t] / l);
      }
    }
  }
}

// One block per (row, kv head): renormalize the NS partial states
// against their common max.  o [BH, NS, G, D], m/l [BH, NS, G].
template <typename TQ>
__global__ void __launch_bounds__(NT)
combine_kernel(const float* __restrict__ o, const float* __restrict__ m,
               const float* __restrict__ l, TQ* __restrict__ out, int NS,
               int G, int D) {
  const int64_t bh = blockIdx.x;
  const float* ob = o + bh * NS * G * D;
  const float* mb = m + bh * NS * G;
  const float* lb = l + bh * NS * G;
  for (int i = threadIdx.x; i < G * D; i += NT) {
    const int g = i / D;
    float mg = mb[g];
    for (int s = 1; s < NS; ++s) mg = fmaxf(mg, mb[s * G + g]);
    float w = expf(mb[g] - mg);
    float lg = __fmul_rn(lb[g], w);
    float acc = __fmul_rn(ob[i], w);
    for (int s = 1; s < NS; ++s) {
      w = expf(mb[s * G + g] - mg);
      lg = __fadd_rn(lg, __fmul_rn(lb[s * G + g], w));
      acc = __fadd_rn(acc, __fmul_rn(ob[(int64_t)s * G * D + i], w));
    }
    out[bh * G * D + i] = from_f<TQ>(acc / fmaxf(lg, 1e-30f));
  }
}

template <typename TQ, typename TKV, int MAXG, int MODE>
int launch_g(const Args<TQ, TKV>& a, int B, int NS, cudaStream_t st) {
  constexpr int BS = steps_slots<TKV>();
  const int G = a.G, D = a.D;
  const size_t smem =
      2 * (size_t)BS * D * sizeof(TKV) +
      sizeof(float) * ((size_t)G * D + (size_t)G * BS + 3 * G) +
      2 * sizeof(int) * BS;
  auto kern = decode_attention_kernel<TQ, TKV, MAXG, MODE>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(a.KH, B, NS), NT, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// MAXG: accumulators per thread = query rows per head dim; the smallest
// power of two that covers G (the wrapper keeps G <= 16).
template <typename TQ, typename TKV, int MODE>
int launch_t(const Args<TQ, TKV>& a, int B, int NS, cudaStream_t st) {
  if (a.G <= 1) return launch_g<TQ, TKV, 1, MODE>(a, B, NS, st);
  if (a.G <= 2) return launch_g<TQ, TKV, 2, MODE>(a, B, NS, st);
  if (a.G <= 4) return launch_g<TQ, TKV, 4, MODE>(a, B, NS, st);
  if (a.G <= 8) return launch_g<TQ, TKV, 8, MODE>(a, B, NS, st);
  return launch_g<TQ, TKV, 16, MODE>(a, B, NS, st);
}

// The untyped arguments of the C entry points.
struct Raw {
  const void *q, *k, *v, *pos, *q_pos, *k_scale, *v_scale, *tables;
  void *out, *o_part, *m_part, *l_part;
  int S, KH, G, D, window, bs, nb, NB, split_len;
  float scale;
};

template <typename TQ, typename TKV, int MODE>
int launch_typed(const Raw& r, int B, int NS, cudaStream_t st) {
  Args<TQ, TKV> a;
  a.q = static_cast<const TQ*>(r.q);
  a.k = static_cast<const TKV*>(r.k);
  a.v = static_cast<const TKV*>(r.v);
  a.pos = static_cast<const int32_t*>(r.pos);
  a.q_pos = static_cast<const int32_t*>(r.q_pos);
  a.k_scale = static_cast<const float*>(r.k_scale);
  a.v_scale = static_cast<const float*>(r.v_scale);
  a.tables = static_cast<const int32_t*>(r.tables);
  a.out = static_cast<TQ*>(r.out);
  a.o_part = static_cast<float*>(r.o_part);
  a.m_part = static_cast<float*>(r.m_part);
  a.l_part = static_cast<float*>(r.l_part);
  a.S = r.S;
  a.KH = r.KH;
  a.G = r.G;
  a.D = r.D;
  a.window = r.window;
  a.bs = r.bs;
  a.nb = r.nb;
  a.NB = r.NB;
  a.split_len = r.split_len;
  a.scale = r.scale;
  return launch_t<TQ, TKV, MODE>(a, B, NS, st);
}

// q_kind: 1 = float32, 2 = bfloat16.  kv_kind: 0 = int8 (scales given),
// otherwise the same code as q_kind.
template <int MODE>
int run(const Raw& r, int q_kind, int kv_kind, int B, int NS, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_kind == 2) {
    if (kv_kind == 0)
      return launch_typed<__nv_bfloat16, int8_t, MODE>(r, B, NS, st);
    return launch_typed<__nv_bfloat16, __nv_bfloat16, MODE>(r, B, NS, st);
  }
  if (kv_kind == 0) return launch_typed<float, int8_t, MODE>(r, B, NS, st);
  return launch_typed<float, float, MODE>(r, B, NS, st);
}

}  // namespace

extern "C" {

// Ring walk.  window 0 = none.  Requires 256 % D == 0 and G <= 16
// (checked by the wrapper), as do the other walks.
int decode_attention_launch(const void* q, int q_kind, const void* k,
                            const void* v, int kv_kind, const void* pos,
                            const void* q_pos, const void* k_scale,
                            const void* v_scale, void* out, int B, int S,
                            int KH, int G, int D, int window, float scale,
                            void* stream) {
  Raw r{};
  r.q = q; r.k = k; r.v = v; r.pos = pos; r.q_pos = q_pos;
  r.k_scale = k_scale; r.v_scale = v_scale; r.out = out;
  r.S = S; r.KH = KH; r.G = G; r.D = D; r.window = window; r.scale = scale;
  return run<RING>(r, q_kind, kv_kind, B, 1, stream);
}

// Paged walk over pools of NB blocks of bs slots, tables [B, nb].
int decode_attention_paged_launch(const void* q, int q_kind, const void* k,
                                  const void* v, int kv_kind,
                                  const void* pos, const void* tables,
                                  const void* q_pos, const void* k_scale,
                                  const void* v_scale, void* out, int B,
                                  int NB, int bs, int nb, int KH, int G,
                                  int D, int window, float scale,
                                  void* stream) {
  Raw r{};
  r.q = q; r.k = k; r.v = v; r.pos = pos; r.tables = tables;
  r.q_pos = q_pos; r.k_scale = k_scale; r.v_scale = v_scale; r.out = out;
  r.S = nb * bs; r.KH = KH; r.G = G; r.D = D; r.window = window;
  r.bs = bs; r.nb = nb; r.NB = NB; r.scale = scale;
  return run<PAGED>(r, q_kind, kv_kind, B, 1, stream);
}

// Split walk: n_splits slices of split_len slots (a multiple of 64) of
// the ring; raw o [B, KH, NS, G, D], m/l [B, KH, NS, G] in float32.
int decode_attention_partial_launch(const void* q, int q_kind, const void* k,
                                    const void* v, int kv_kind,
                                    const void* pos, const void* q_pos,
                                    const void* k_scale, const void* v_scale,
                                    void* o_part, void* m_part, void* l_part,
                                    int B, int S, int KH, int G, int D,
                                    int window, float scale, int n_splits,
                                    int split_len, void* stream) {
  Raw r{};
  r.q = q; r.k = k; r.v = v; r.pos = pos; r.q_pos = q_pos;
  r.k_scale = k_scale; r.v_scale = v_scale;
  r.o_part = o_part; r.m_part = m_part; r.l_part = l_part;
  r.S = S; r.KH = KH; r.G = G; r.D = D; r.window = window;
  r.split_len = split_len; r.scale = scale;
  return run<SPLIT>(r, q_kind, kv_kind, B, n_splits, stream);
}

// Combine: o [B*KH, NS, G, D], m/l [B*KH, NS, G] -> out [B*KH, G, D] in
// the dtype out_kind names (1 = float32, 2 = bfloat16).
int decode_attention_combine_launch(const void* o, const void* m,
                                    const void* l, void* out, int out_kind,
                                    int BH, int NS, int G, int D,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* of = static_cast<const float*>(o);
  const float* mf = static_cast<const float*>(m);
  const float* lf = static_cast<const float*>(l);
  if (out_kind == 2)
    combine_kernel<__nv_bfloat16><<<BH, NT, 0, st>>>(
        of, mf, lf, static_cast<__nv_bfloat16*>(out), NS, G, D);
  else
    combine_kernel<float><<<BH, NT, 0, st>>>(of, mf, lf,
                                             static_cast<float*>(out), NS,
                                             G, D);
  return (int)cudaGetLastError();
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
