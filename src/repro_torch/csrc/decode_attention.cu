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
// What bounds it on the card.  Not bytes and not arithmetic: a 64-slot
// step of int8 K and V at D 256 is 32 KB (10 ns of HBM) and 4 G D f32
// operations a slot, under the f32 ridge.  A walk is bound by the round
// trips to device memory it waits for one after another, and by how few
// SMs hold it: B x KH blocks (8 for gemma-2b's one KV head) walk their
// steps in series.  The design takes the round trips off each step and
// spreads a walk over a thread-block cluster.
//
// One kernel body, decode_attention_kernel<TQ, TKV, MAXG, MODE>, serves
// all three walks, so that their arithmetic is the same instruction for
// instruction; the walks differ only in where slot j of row b lives
// (row b * S + j of the ring, or row tables[b, j / bs] * bs + j % bs of
// the pools: the ring is the paged walk with the identity table) and in
// what the end writes.  A cluster of C blocks (C a launch attribute, one
// of 1, 2, 4, 8, chosen by the wrapper's launch plan) walks one (row,
// kv head[, split]):
// 1. Step list.  Every block of the cluster reads the positions of the
//    cluster's logical range once, 32 slots a warp per load, and keeps a
//    visibility bitmask of it in shared memory; warp 0 compacts the
//    steps (BS = 64 int8, 32 bf16 or 16 f32 slots) holding a visible
//    slot into a list.  A step whose slots are all masked (beyond q_pos,
//    or outside the sliding window) is skipped, as the reference's keep
//    list skips its blocks; the skip is exact because a masked slot's
//    probability is exp(-1e30 - m) = 0.  A row with no visible slot
//    anywhere skips nothing, so it gets the reference's uniform softmax:
//    a range with a visible slot decides it; a split with none scans
//    the rest of its row (in every mode the exception is decided over
//    the row's whole logical range, null table entries included).
//    Positions are not read again.
// 2. Stages.  Rank r of the cluster walks the kept steps
//    [r n / C, (r + 1) n / C) of the list through a ring of NST = 4
//    stages in shared memory (2 or 3 timed within 2.4% of 4), each holding one step's K rows, V rows, k_scale
//    and v_scale, filled with cp.async (16-byte copies for the rows,
//    4-byte for the scales, one commit group a step): while step i is
//    scored the copies of steps i + 1 .. i + NST - 1 are in flight.
// 3. No load from device memory inside the compute.  Scores, softmax
//    and p . v read shared memory and registers only.  A step has two
//    block barriers: after one, every thread adds the previous step's
//    p . v to its accumulators and scores this step (whole dots over D,
//    one thread a (slot, query row), each dot in four interleaved partial
//    sums added pairwise, K rows padded by 16 bytes so that
//    the lanes' 16-byte reads of consecutive slots fall in distinct
//    banks; int8 is widened with a byte permute and one subtraction);
//    after the other, one warp per query row takes the step's max, the
//    running max m and sum l, turns the scores into probabilities (times
//    v_scale on the int8 path, rounded to bf16 on a bf16 cache, as the
//    reference does) and writes them, and every thread refills the stage
//    the previous step freed.  p . v: a thread owns 4 head dimensions
//    and every query row for a slice of a step's slots; its accumulators
//    are rescaled by exp(m_old - m_new) once a step, and the slices'
//    partial sums are added in slice order at the end.
// 4. Cluster merge.  Each rank leaves its (m, l, acc) in shared memory;
//    after cluster.sync() rank r merges every C-th slice of the outputs
//    in rank order through distributed shared memory, as the combine
//    does: m_g = max m_r, w_r = exp(m_r - m_g), l = sum l_r w_r,
//    acc = sum acc_r w_r, products and sums rounded one by one
//    (__fmul_rn, __fadd_rn).  An empty rank holds m = -1e30, l = 0,
//    acc = 0 and weighs 0 (or, with every rank empty, leaves m = -1e30,
//    l = 0, acc = 0).  The ring and paged walks write acc / max(l,
//    1e-30) in q's dtype; a split writes the raw merged acc, m and l.
//    A second cluster.sync() keeps every rank's shared memory alive
//    until the reads are done.
// A split walks [split * L, min(S, (split + 1) * L)) with L a multiple
// of 64, so its steps are the single walk's steps.  The combine takes
// m_g = max_s m, w_s = exp(m_s - m_g), l_g = sum_s l_s w_s and acc =
// sum_s o_s w_s, summed in ascending s, and writes acc / max(l_g, 1e-30)
// in q's dtype, rounded one by one, so at NS = 1 (w = 1 exactly) it
// returns the single walk's bits.  Its bytes are few (serve-long's end
// state: 4 x 8 x 4 partial rows of 256 floats, 128 KB), so it is bound by
// latency: a block takes one (row, kv head, query row) and a slice of D,
// filling the card with B KH G blocks; its threads put all their
// partials' 16-byte loads in flight before anything waits, while one warp
// computes the row's NS weights and l_g once, for every thread of the
// block.
//
// Why the bitwise pins hold (paged == ring, split NS 1 + combine ==
// single walk, a head's bits whatever the number of heads in the launch,
// so TP ranks reproduce the unsharded run): every partition of the work
// depends only on the logical slot indices, the positions, S and the
// template types — the step size on TKV, the cluster size on S and D
// (the wrapper's plan), the p . v slices on D; the stage count is a
// constant — never on B, KH, G, NS or the mode.  Each dot sums d in a fixed order, each
// query row's softmax and accumulators are its own, and the merge order
// is the rank order.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;      // threads per block
constexpr int NW = NT / 32;  // warps per block
constexpr float NEG_INF = -1e30f;
// dynamic shared memory a block may use on sm_90 (227 KB)
constexpr int MAX_SMEM = 232448;
// stages of the shared-memory ring: the copies of three steps are in
// flight while one is scored
constexpr int NST = 4;

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

// 4 packed int8 -> 4 exact floats: 0x4B0000xx is 2^23 + xx, and
// xx = b + 128 after flipping the sign bits.
__device__ __forceinline__ void widen4(uint32_t w, float* f) {
  const uint32_t x = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440)) - 8388736.0f;
  f[1] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7441)) - 8388736.0f;
  f[2] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7442)) - 8388736.0f;
  f[3] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7443)) - 8388736.0f;
}
// 16 bytes of a row -> 16 / sizeof(TKV) floats
__device__ __forceinline__ void widen16(uint4 r, int8_t*, float* f) {
  widen4(r.x, f);
  widen4(r.y, f + 4);
  widen4(r.z, f + 8);
  widen4(r.w, f + 12);
}
__device__ __forceinline__ void widen16(uint4 r, __nv_bfloat16*, float* f) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void widen16(uint4 r, float*, float* f) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
// 4 consecutive elements of a row (4-, 8- or 16-byte aligned) -> floats
__device__ __forceinline__ void load4(const int8_t* p, float* f) {
  widen4(*reinterpret_cast<const uint32_t*>(p), f);
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(r.x << 16);
  f[1] = __uint_as_float(r.x & 0xFFFF0000u);
  f[2] = __uint_as_float(r.y << 16);
  f[3] = __uint_as_float(r.y & 0xFFFF0000u);
}
__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  f[0] = r.x;
  f[1] = r.y;
  f[2] = r.z;
  f[3] = r.w;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most NST - 2 groups are pending: the next step's copies
// have landed
__device__ __forceinline__ void cp_async_wait() {
  static_assert(NST == 4, "the wait count is NST - 2");
  asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

// slots per step: 64 int8 rows, 32 bf16 rows, 16 f32 rows
template <typename TKV>
__host__ __device__ constexpr int steps_slots() {
  return 64 / (int)sizeof(TKV);
}

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// Shared-memory layout in bytes, the same on the host (which checks the
// wrapper's count) and in the kernel.  The stage ring is reused for the
// p . v slices' partial sums at the end.  kv_bytes = sizeof(TKV).
struct Layout {
  int k_pitch, v_pitch, stage;  // bytes of a staged K row, V row, stage
  int q, s, p, corr, ml, mask, list, table, total;  // offsets, total
  // (the last 16 bytes hold the count of kept steps)
};
__host__ __device__ inline Layout layout(int kv_bytes, int D, int G,
                                         int MAXG, int range, int ntab) {
  Layout L;
  const int BS = 64 / kv_bytes;
  const int row = align16(D * kv_bytes);
  L.k_pitch = row + 16;
  L.v_pitch = row;
  L.stage = BS * (L.k_pitch + L.v_pitch) + 2 * BS * 4;
  const int dw = D < 4 ? D : 4;
  const int nj = BS < NT / (D / dw) ? BS : NT / (D / dw);
  const int part = nj * G * D * 4;
  const int ring = NST * L.stage > part ? NST * L.stage : part;
  L.q = align16(ring);
  L.s = L.q + align16(G * D * 4);
  L.p = L.s + align16(G * BS * 4);
  L.corr = L.p + align16(BS * MAXG * 4);
  L.ml = L.corr + align16(G * 4);
  L.mask = L.ml + align16(2 * G * 4);
  L.list = L.mask + align16((range + 31) / 32 * 4);
  L.table = L.list + align16((range + BS - 1) / BS * 4);
  L.total = L.table + align16(ntab * 4) + 16;
  return L;
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

// One block an SM is the plan's own occupancy at D 256 (the stage ring),
// so ptxas need not squeeze registers: at a tighter count it saved
// registers on the stack around the division's slow-path call.
template <typename TQ, typename TKV, int MAXG, int MODE>
__global__ void __launch_bounds__(NT, 1)
decode_attention_kernel(const Args<TQ, TKV> a) {
  constexpr bool QUANT = std::is_same<TKV, int8_t>::value;
  constexpr bool BF16 = std::is_same<TKV, __nv_bfloat16>::value;
  constexpr int ES = (int)sizeof(TKV);
  constexpr int BS = steps_slots<TKV>();
  constexpr int E = 16 / ES;                   // elements in 16 bytes
  constexpr int NGRP = NT / BS;                // score threads per slot
  constexpr int GPT = (MAXG + NGRP - 1) / NGRP;  // dots per thread
  constexpr int RPW = (MAXG + NW - 1) / NW;      // softmax rows per warp
  constexpr int PL = (BS + 31) / 32;             // softmax slots per lane

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int S = a.S, KH = a.KH, G = a.G, D = a.D, window = a.window;
  const int kh = blockIdx.x / C, b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const int j_lo = MODE == SPLIT ? split * a.split_len : 0;
  const int j_hi = MODE == SPLIT ? min(S, j_lo + a.split_len) : S;
  const int range = max(j_hi - j_lo, 0);
  const int range_max = MODE == SPLIT ? a.split_len : S;
  const Layout L = layout(ES, D, G, MAXG, range_max,
                          MODE == PAGED ? a.nb : 0);
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* s_ring = smem;
  float* s_q = reinterpret_cast<float*>(smem + L.q);        // [G][D]
  float* s_s = reinterpret_cast<float*>(smem + L.s);        // [G][BS]
  float* s_p = reinterpret_cast<float*>(smem + L.p);        // [BS][MAXG]
  float* s_corr = reinterpret_cast<float*>(smem + L.corr);  // [G]
  float* s_m = reinterpret_cast<float*>(smem + L.ml);       // [G]
  float* s_l = s_m + G;                                     // [G]
  uint32_t* s_mask = reinterpret_cast<uint32_t*>(smem + L.mask);
  int* s_list = reinterpret_cast<int*>(smem + L.list);
  int* s_table = reinterpret_cast<int*>(smem + L.table);
  int* s_n = reinterpret_cast<int*>(smem + L.total - 16);  // kept steps

  const int qp = a.q_pos[b];
  auto visible = [&](int kp) {
    return kp <= qp && (window <= 0 || kp > qp - window);
  };
  // q's loads are issued first and stored after the positions' loads,
  // so that the two round trips overlap (G D <= MAXG NT)
  const int64_t q_base = ((int64_t)b * KH + kh) * G * D;
  float q_in[MAXG];
#pragma unroll
  for (int u = 0; u < MAXG; ++u) {
    const int i = tid + u * NT;
    q_in[u] = i < G * D ? to_f(a.q[q_base + i]) : 0.0f;
  }
  if constexpr (MODE == PAGED) {
    // the row's table, entries outside the pool read as the null block
    for (int i = tid; i < a.nb; i += NT) {
      const int blk = a.tables[(int64_t)b * a.nb + i];
      s_table[i] = (blk < 0 || blk >= a.NB) ? 0 : blk;
    }
    __syncthreads();
  }
  // physical row of logical slot j of row b
  auto slot_of = [&](int j) -> int64_t {
    if constexpr (MODE == PAGED) {
      return (int64_t)s_table[j / a.bs] * a.bs + j % a.bs;
    } else {
      return (int64_t)b * S + j;
    }
  };

  // 1. visibility bitmask of the range (bit i of word w: slot
  // j_lo + 32 w + i), four words a warp per round of loads
  const int words = (range + 31) / 32;
  for (int w0 = warp * 4; w0 < words; w0 += NW * 4) {
    bool vis[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j_lo + (w0 + u) * 32 + lane;
      vis[u] = j < j_hi && visible(a.pos[slot_of(j)]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint32_t bits = __ballot_sync(0xffffffffu, vis[u]);
      if (lane == 0 && w0 + u < words) s_mask[w0 + u] = bits;
    }
  }
#pragma unroll
  for (int u = 0; u < MAXG; ++u) {
    const int i = tid + u * NT;
    if (i < G * D) s_q[i] = q_in[u];
  }
  __syncthreads();
  auto step_bits = [&](int s) -> uint32_t {
    if constexpr (BS == 64) {
      return s_mask[2 * s] | (2 * s + 1 < words ? s_mask[2 * s + 1] : 0u);
    } else if constexpr (BS == 32) {
      return s_mask[s];
    } else {
      return (s_mask[s / 2] >> (16 * (s & 1))) & 0xFFFFu;
    }
  };
  // the kept steps, in order
  const int nsteps = (range + BS - 1) / BS;
  if (warp == 0) {
    int n = 0;
    for (int s0 = 0; s0 < nsteps; s0 += 32) {
      const int s = s0 + lane;
      const bool kept = s < nsteps && step_bits(s) != 0;
      const uint32_t bal = __ballot_sync(0xffffffffu, kept);
      if (kept) s_list[n + __popc(bal & ((1u << lane) - 1u))] = s;
      n += __popc(bal);
    }
    if (lane == 0) *s_n = n;
  }
  __syncthreads();
  int n = *s_n;
  bool every = false;  // no visible slot in the row: keep every step
  if (n == 0 && nsteps > 0) {
    int any = 0;
    if constexpr (MODE == SPLIT) {
      // the rest of the row, eight slots a thread per round
      const int rest = S - range;
      for (int j0 = 0; j0 < rest; j0 += 8 * NT) {
        int found = 0;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = j0 + u * NT + tid;
          if (i < rest) {
            const int j = i < j_lo ? i : i + range;
            found |= visible(a.pos[(int64_t)b * S + j]);
          }
        }
        any = __syncthreads_or(found);
        if (any) break;
      }
    }
    every = any == 0;
    if (every) n = nsteps;
  }
  // this rank's share of the kept steps
  const int lo = rank * n / C;  // n < 2^27: no 64-bit division call
  const int mine = (rank + 1) * n / C - lo;
  auto step_of = [&](int i) { return every ? lo + i : s_list[lo + i]; };

  // 2. the stage ring
  const int64_t row_stride = (int64_t)KH * D;  // elements between rows
  const int64_t col0 = (int64_t)kh * D;
  const int row_bytes = D * ES;
  const bool vec = row_bytes % 16 == 0 &&
                   (row_stride * ES) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.v) % 16 == 0;
  auto stage_k = [&](int i) { return s_ring + (i % NST) * L.stage; };
  auto stage_v = [&](int i) { return stage_k(i) + BS * L.k_pitch; };
  auto stage_sc = [&](int i) {
    return reinterpret_cast<float*>(stage_v(i) + BS * L.v_pitch);
  };
  auto issue = [&](int i) {
    if (i < mine) {
      const int j0 = j_lo + step_of(i) * BS;
      const int nj = min(BS, j_hi - j0);
      unsigned char* sk = stage_k(i);
      unsigned char* sv = stage_v(i);
      if (vec) {
        const int cpr = row_bytes / 16;  // 16-byte chunks a row
        for (int c = tid; c < 2 * nj * cpr; c += NT) {
          int r = c / cpr;
          const int ch = c - r * cpr;
          const bool is_v = r >= nj;
          if (is_v) r -= nj;
          const int64_t src = slot_of(j0 + r) * row_stride + col0;
          const unsigned char* g = reinterpret_cast<const unsigned char*>(
              (is_v ? a.v : a.k) + src);
          unsigned char* d = is_v ? sv + r * L.v_pitch : sk + r * L.k_pitch;
          cp_async16(d + ch * 16, g + ch * 16);
        }
      } else {
        for (int c = tid; c < 2 * nj * D; c += NT) {
          int r = c / D;
          const int e = c - r * D;
          const bool is_v = r >= nj;
          if (is_v) r -= nj;
          const TKV x = (is_v ? a.v : a.k)[slot_of(j0 + r) * row_stride +
                                            col0 + e];
          reinterpret_cast<TKV*>(is_v ? sv + r * L.v_pitch
                                      : sk + r * L.k_pitch)[e] = x;
        }
      }
      if constexpr (QUANT) {
        float* sc = stage_sc(i);
        for (int r = tid; r < 2 * nj; r += NT) {
          const bool is_v = r >= nj;
          const int rr = is_v ? r - nj : r;
          cp_async4(sc + (is_v ? BS : 0) + rr,
                    (is_v ? a.v_scale : a.k_scale) +
                        slot_of(j0 + rr) * KH + kh);
        }
      }
    }
    cp_async_commit();
  };

  // p . v ownership: 4 head dims (dq) x every query row, slots of slice jg
  const int DW = D < 4 ? D : 4;
  const int ND = D / DW;
  const int NJ = min(BS, NT / ND);
  const int JPG = BS / NJ;
  const int dq = tid % ND, jg = tid / ND;
  const bool pv_on = jg < NJ;
  float acc[MAXG][4];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.0f;
  // running max and sum of the rows this warp owns (g = warp + k NW)
  float m_r[RPW], l_r[RPW];
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    m_r[k] = NEG_INF;
    l_r[k] = 0.0f;
  }

  auto pv = [&](int i) {
    if (!pv_on) return;
    const int nj = min(BS, j_hi - (j_lo + step_of(i) * BS));
    const unsigned char* sv = stage_v(i);
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        const float c = s_corr[g];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][e] = __fmul_rn(acc[g][e], c);
      }
    }
    const int jend = min(nj, (jg + 1) * JPG);
    for (int jj = jg * JPG; jj < jend; ++jj) {
      const TKV* vr = reinterpret_cast<const TKV*>(sv + jj * L.v_pitch) +
                      dq * DW;
      float vv[4];
      if (DW == 4) {
        load4(vr, vv);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) vv[e] = e < DW ? to_f(vr[e]) : 0.0f;
      }
      const float* pr = s_p + jj * MAXG;
      float p[MAXG];
      if constexpr (MAXG % 4 == 0) {
#pragma unroll
        for (int g = 0; g < MAXG; g += 4) {
          const float4 t = *reinterpret_cast<const float4*>(pr + g);
          p[g] = t.x;
          p[g + 1] = t.y;
          p[g + 2] = t.z;
          p[g + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int g = 0; g < MAXG; ++g) p[g] = pr[g];
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[g][e] = fmaf(p[g], vv[e], acc[g][e]);
        }
      }
    }
  };

  auto scores = [&](int i) {
    const int j0 = j_lo + step_of(i) * BS;
    const int nj = min(BS, j_hi - j0);
    const int j = tid % BS, c = tid / BS;
    if (j >= nj || c >= G) return;
    // each dot in 4 partial sums (element 4 t + x into sum x), added
    // pairwise at the end: four independent FMA chains a dot
    float dot[GPT][4];
#pragma unroll
    for (int u = 0; u < GPT; ++u)
#pragma unroll
      for (int x = 0; x < 4; ++x) dot[u][x] = 0.0f;
    const unsigned char* kr = stage_k(i) + j * L.k_pitch;
    if (row_bytes % 16 == 0) {
      for (int ch = 0; ch < row_bytes / 16; ++ch) {
        float kf[E];
        widen16(*reinterpret_cast<const uint4*>(kr + ch * 16),
                static_cast<TKV*>(nullptr), kf);
#pragma unroll
        for (int u = 0; u < GPT; ++u) {
          const int g = c + u * NGRP;
          if (g < G) {
            const float4* qv =
                reinterpret_cast<const float4*>(s_q + g * D + ch * E);
#pragma unroll
            for (int e4 = 0; e4 < E / 4; ++e4) {
              const float4 qq = qv[e4];
              dot[u][0] = fmaf(qq.x, kf[4 * e4], dot[u][0]);
              dot[u][1] = fmaf(qq.y, kf[4 * e4 + 1], dot[u][1]);
              dot[u][2] = fmaf(qq.z, kf[4 * e4 + 2], dot[u][2]);
              dot[u][3] = fmaf(qq.w, kf[4 * e4 + 3], dot[u][3]);
            }
          }
        }
      }
    } else {
      const TKV* kt = reinterpret_cast<const TKV*>(kr);
      for (int d0 = 0; d0 < D; d0 += 4) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int d = d0 + x;
          if (d < D) {
            const float kf = to_f(kt[d]);
#pragma unroll
            for (int u = 0; u < GPT; ++u) {
              const int g = c + u * NGRP;
              if (g < G) dot[u][x] = fmaf(s_q[g * D + d], kf, dot[u][x]);
            }
          }
        }
      }
    }
    const int js = j0 - j_lo + j;
    const bool vis = (s_mask[js / 32] >> (js % 32)) & 1u;
    const float ks = QUANT ? stage_sc(i)[j] : 1.0f;
#pragma unroll
    for (int u = 0; u < GPT; ++u) {
      const int g = c + u * NGRP;
      if (g < G) {
        float s = __fadd_rn(__fadd_rn(dot[u][0], dot[u][1]),
                            __fadd_rn(dot[u][2], dot[u][3]));
        if (QUANT) s = __fmul_rn(s, ks);
        s = __fmul_rn(s, a.scale);
        s_s[g * BS + j] = vis ? s : NEG_INF;
      }
    }
  };

  auto softmax = [&](int i) {
    const int nj = min(BS, j_hi - (j_lo + step_of(i) * BS));
    const float* vsc = stage_sc(i) + BS;
#pragma unroll
    for (int k = 0; k < RPW; ++k) {
      const int g = warp + k * NW;
      if (g >= G) break;
      float sv[PL];
      float mx = NEG_INF;
#pragma unroll
      for (int u = 0; u < PL; ++u) {
        const int jj = lane + 32 * u;
        sv[u] = jj < nj ? s_s[g * BS + jj] : NEG_INF;
        mx = fmaxf(mx, sv[u]);
      }
#pragma unroll
      for (int o = 16; o; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_r[k], mx);
      float sum = 0.0f;
#pragma unroll
      for (int u = 0; u < PL; ++u) {
        const int jj = lane + 32 * u;
        if (jj < nj) {
          float p = expf(sv[u] - m_new);
          sum += p;
          if (QUANT) {
            p = __fmul_rn(p, vsc[jj]);
          } else if (BF16) {
            // the reference casts p to the cache dtype before the PV dot
            p = __bfloat162float(__float2bfloat16(p));
          }
          s_p[jj * MAXG + g] = p;
        }
      }
#pragma unroll
      for (int o = 16; o; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float corr = expf(m_r[k] - m_new);
      l_r[k] = __fmaf_rn(l_r[k], corr, sum);
      m_r[k] = m_new;
      if (lane == 0) s_corr[g] = corr;
    }
  };

  // the walk: rounds 1 - NST .. -1 fill the ring, then two block
  // barriers a step (one call site a phase, so each is inlined)
  for (int i = 1 - NST;; ++i) {
    if (i >= 0) {
      if (i > 0) pv(i - 1);
      if (i == mine) break;
      scores(i);
      __syncthreads();
      softmax(i);
    }
    issue(i + NST - 1);
    if (i >= -1) {
      cp_async_wait();
      __syncthreads();
    }
  }
  __syncthreads();

  // this rank's state: the p . v slices summed in slice order into
  // slice 0 of the (now free) stage ring
  float* part = reinterpret_cast<float*>(s_ring);  // [NJ][G][D]
  if (pv_on) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (e < DW)
            part[((int64_t)jg * G + g) * D + dq * DW + e] = acc[g][e];
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < RPW; ++k) {
      const int g = warp + k * NW;
      if (g < G) {
        s_m[g] = m_r[k];
        s_l[g] = l_r[k];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += NT) {
    float t = part[e];
    for (int s = 1; s < NJ; ++s) t = __fadd_rn(t, part[s * G * D + e]);
    part[e] = t;
  }

  // 4. merge the ranks' states through distributed shared memory
  cluster.sync();
  for (int e = rank * NT + tid; e < G * D; e += C * NT) {
    const int g = e / D;
    float mg = *cluster.map_shared_rank(s_m + g, 0);
    for (int r = 1; r < C; ++r)
      mg = fmaxf(mg, *cluster.map_shared_rank(s_m + g, r));
    float w = expf(*cluster.map_shared_rank(s_m + g, 0) - mg);
    float lg = __fmul_rn(*cluster.map_shared_rank(s_l + g, 0), w);
    float o = __fmul_rn(*cluster.map_shared_rank(part + e, 0), w);
    for (int r = 1; r < C; ++r) {
      w = expf(*cluster.map_shared_rank(s_m + g, r) - mg);
      lg = __fadd_rn(lg, __fmul_rn(*cluster.map_shared_rank(s_l + g, r), w));
      o = __fadd_rn(o, __fmul_rn(*cluster.map_shared_rank(part + e, r), w));
    }
    if constexpr (MODE == SPLIT) {
      // raw partial state, renormalized by the combine kernel
      const int64_t pidx = ((int64_t)b * KH + kh) * gridDim.z + split;
      a.o_part[pidx * G * D + e] = o;
      if (e % D == 0) {
        a.m_part[pidx * G + g] = mg;
        a.l_part[pidx * G + g] = lg;
      }
    } else {
      a.out[q_base + e] = from_f<TQ>(o / fmaxf(lg, 1e-30f));
    }
  }
  cluster.sync();
}

// The combine: block (bh, g, z) renormalizes query row g of (row, kv
// head) bh over D elements z V blockDim.x .. + V blockDim.x - 1, V a
// thread (16-byte loads when V = 4).  o [BH, NS, G, D], m/l [BH, NS, G].
// Shared memory: the NS weights, the NS products l_s w_s, l_g.
constexpr int CB_NT = 128;  // the combine's most threads a block
constexpr int CB_U = 8;     // partials a thread has in flight

__device__ __forceinline__ void cb_unpack(const float4& v, float (&f)[4]) {
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void cb_unpack(const float& v, float (&f)[1]) {
  f[0] = v;
}

// Splits s0 .. s0 + CB_U - 1 (below NS) of the thread's V elements, all
// loads in flight before any is used.
template <typename Vec>
__device__ __forceinline__ void cb_load(Vec (&v)[CB_U], const float* ob,
                                        int64_t stride, int s0, int NS) {
#pragma unroll
  for (int u = 0; u < CB_U; ++u)
    if (s0 + u < NS)
      v[u] = __ldg(reinterpret_cast<const Vec*>(ob + (s0 + u) * stride));
}

template <typename TQ, int V>
__global__ void __launch_bounds__(CB_NT)
combine_kernel(const float* __restrict__ o, const float* __restrict__ m,
               const float* __restrict__ l, TQ* __restrict__ out, int NS,
               int G, int D) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  extern __shared__ float s_cb[];
  float* s_w = s_cb;
  float* s_p = s_cb + NS;
  const int tid = threadIdx.x, g = (int)blockIdx.y;
  const int64_t bh = blockIdx.x;
  const int i = ((int)blockIdx.z * (int)blockDim.x + tid) * V;
  const bool live = i < D;  // D % V == 0
  const int64_t stride = (int64_t)G * D;  // from one split's row to the next
  const float* ob = o + (bh * NS * G + g) * D + i;

  Vec v[CB_U];
  if (live) cb_load(v, ob, stride, 0, NS);
  if (tid < 32) {
    // m_g (max is exact in any order), each weight once, then l_g in
    // ascending s
    const float* mb = m + bh * NS * G + g;
    const float* lb = l + bh * NS * G + g;
    float mg = __int_as_float(0xff800000);  // -inf
    for (int s = tid; s < NS; s += 32) mg = fmaxf(mg, mb[(int64_t)s * G]);
#pragma unroll
    for (int off = 16; off; off >>= 1)
      mg = fmaxf(mg, __shfl_xor_sync(0xffffffffu, mg, off));
    for (int s = tid; s < NS; s += 32) {
      const float w = expf(mb[(int64_t)s * G] - mg);
      s_w[s] = w;
      s_p[s] = __fmul_rn(lb[(int64_t)s * G], w);
    }
    __syncwarp();
    if (tid == 0) {
      float lg = s_p[0];
      for (int s = 1; s < NS; ++s) lg = __fadd_rn(lg, s_p[s]);
      s_p[NS] = lg;
    }
  }
  __syncthreads();
  if (!live) return;
  float acc[V];
  for (int s0 = 0; s0 < NS; s0 += CB_U) {
    if (s0 > 0) cb_load(v, ob, stride, s0, NS);
#pragma unroll
    for (int u = 0; u < CB_U; ++u) {
      const int s = s0 + u;
      if (s < NS) {
        const float w = s_w[s];
        float f[V];
        cb_unpack(v[u], f);
#pragma unroll
        for (int j = 0; j < V; ++j)
          acc[j] = s == 0 ? __fmul_rn(f[j], w)
                          : __fadd_rn(acc[j], __fmul_rn(f[j], w));
      }
    }
  }
  const float den = fmaxf(s_p[NS], 1e-30f);
  TQ* ot = out + (bh * G + g) * D + i;
#pragma unroll
  for (int j = 0; j < V; ++j) ot[j] = from_f<TQ>(acc[j] / den);
}

// The launch plan the wrapper chose: cluster size C, the dynamic shared
// memory it counted (checked against the layout), and for a query the
// slot for cudaOccupancyMaxActiveClusters' answer.
struct Plan {
  int B, NS, C, smem;
  int* max_clusters;  // non-null: report the occupancy, launch nothing
};

template <typename TQ, typename TKV, int MAXG, int MODE>
int launch_g(const Args<TQ, TKV>& a, const Plan& pl, cudaStream_t st) {
  const Layout L = layout((int)sizeof(TKV), a.D, a.G, MAXG,
                          MODE == SPLIT ? a.split_len : a.S,
                          MODE == PAGED ? a.nb : 0);
  if (pl.smem < L.total || pl.smem > MAX_SMEM || pl.C < 1 || pl.C > 8)
    return (int)cudaErrorInvalidValue;
  auto kern = decode_attention_kernel<TQ, TKV, MAXG, MODE>;
  // the opt-in above 48 KB, once per device and instantiation, at the
  // largest size so that no later call (inside a graph capture) needs it
  static bool granted[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (!granted[dev % 64]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    granted[dev % 64] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.C * a.KH, pl.B, pl.NS);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = (size_t)pl.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (pl.max_clusters != nullptr)
    return (int)cudaOccupancyMaxActiveClusters(pl.max_clusters, kern, &cfg);
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// MAXG: query rows a thread's accumulators cover; the smallest power of
// two that covers G (the wrapper keeps G <= 16).
template <typename TQ, typename TKV, int MODE>
int launch_t(const Args<TQ, TKV>& a, const Plan& pl, cudaStream_t st) {
  if (a.G <= 1) return launch_g<TQ, TKV, 1, MODE>(a, pl, st);
  if (a.G <= 2) return launch_g<TQ, TKV, 2, MODE>(a, pl, st);
  if (a.G <= 4) return launch_g<TQ, TKV, 4, MODE>(a, pl, st);
  if (a.G <= 8) return launch_g<TQ, TKV, 8, MODE>(a, pl, st);
  return launch_g<TQ, TKV, 16, MODE>(a, pl, st);
}

// The untyped arguments of the C entry points.
struct Raw {
  const void *q, *k, *v, *pos, *q_pos, *k_scale, *v_scale, *tables;
  void *out, *o_part, *m_part, *l_part;
  int S, KH, G, D, window, bs, nb, NB, split_len;
  float scale;
};

template <typename TQ, typename TKV, int MODE>
int launch_typed(const Raw& r, const Plan& pl, cudaStream_t st) {
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
  return launch_t<TQ, TKV, MODE>(a, pl, st);
}

// q_kind: 1 = float32, 2 = bfloat16.  kv_kind: 0 = int8 (scales given),
// otherwise the same code as q_kind.
template <int MODE>
int run(const Raw& r, int q_kind, int kv_kind, const Plan& pl,
        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_kind == 2) {
    if (kv_kind == 0)
      return launch_typed<__nv_bfloat16, int8_t, MODE>(r, pl, st);
    return launch_typed<__nv_bfloat16, __nv_bfloat16, MODE>(r, pl, st);
  }
  if (kv_kind == 0) return launch_typed<float, int8_t, MODE>(r, pl, st);
  return launch_typed<float, float, MODE>(r, pl, st);
}

}  // namespace

extern "C" {

// Ring walk.  window 0 = none.  Requires 256 % D == 0 and G <= 16
// (checked by the wrapper), as do the other walks.  cluster and smem are
// the wrapper's launch plan (walk_plan).
int decode_attention_launch(const void* q, int q_kind, const void* k,
                            const void* v, int kv_kind, const void* pos,
                            const void* q_pos, const void* k_scale,
                            const void* v_scale, void* out, int B, int S,
                            int KH, int G, int D, int window, float scale,
                            int cluster, int smem, void* stream) {
  Raw r{};
  r.q = q; r.k = k; r.v = v; r.pos = pos; r.q_pos = q_pos;
  r.k_scale = k_scale; r.v_scale = v_scale; r.out = out;
  r.S = S; r.KH = KH; r.G = G; r.D = D; r.window = window; r.scale = scale;
  return run<RING>(r, q_kind, kv_kind, Plan{B, 1, cluster, smem, nullptr},
                   stream);
}

// Paged walk over pools of NB blocks of bs slots, tables [B, nb].
int decode_attention_paged_launch(const void* q, int q_kind, const void* k,
                                  const void* v, int kv_kind,
                                  const void* pos, const void* tables,
                                  const void* q_pos, const void* k_scale,
                                  const void* v_scale, void* out, int B,
                                  int NB, int bs, int nb, int KH, int G,
                                  int D, int window, float scale,
                                  int cluster, int smem, void* stream) {
  Raw r{};
  r.q = q; r.k = k; r.v = v; r.pos = pos; r.tables = tables;
  r.q_pos = q_pos; r.k_scale = k_scale; r.v_scale = v_scale; r.out = out;
  r.S = nb * bs; r.KH = KH; r.G = G; r.D = D; r.window = window;
  r.bs = bs; r.nb = nb; r.NB = NB; r.scale = scale;
  return run<PAGED>(r, q_kind, kv_kind, Plan{B, 1, cluster, smem, nullptr},
                    stream);
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
                                    int split_len, int cluster, int smem,
                                    void* stream) {
  Raw r{};
  r.q = q; r.k = k; r.v = v; r.pos = pos; r.q_pos = q_pos;
  r.k_scale = k_scale; r.v_scale = v_scale;
  r.o_part = o_part; r.m_part = m_part; r.l_part = l_part;
  r.S = S; r.KH = KH; r.G = G; r.D = D; r.window = window;
  r.split_len = split_len; r.scale = scale;
  return run<SPLIT>(r, q_kind, kv_kind,
                    Plan{B, n_splits, cluster, smem, nullptr}, stream);
}

// How many clusters of the walk's instantiation (q_kind, kv_kind as
// above, G, mode 0 ring / 1 paged / 2 split) can be resident at once
// with this plan (cudaOccupancyMaxActiveClusters); S, bs and split_len
// only size the layout check.  Returns a CUDA error code.
int decode_attention_max_clusters(int q_kind, int kv_kind, int mode, int S,
                                  int KH, int G, int D, int bs,
                                  int split_len, int cluster, int smem,
                                  int* out) {
  Raw r{};
  r.S = S; r.KH = KH; r.G = G; r.D = D; r.bs = bs;
  r.nb = bs > 0 ? S / bs : 0; r.split_len = split_len;
  const Plan pl{1, 1, cluster, smem, out};
  if (mode == PAGED) return run<PAGED>(r, q_kind, kv_kind, pl, nullptr);
  if (mode == SPLIT) return run<SPLIT>(r, q_kind, kv_kind, pl, nullptr);
  return run<RING>(r, q_kind, kv_kind, pl, nullptr);
}

// Dynamic shared-memory bytes of one block of a walk whose cache
// elements are kv_bytes wide, reading a range of `range` slots and, on
// the paged walk, a table row of ntab entries: layout().total, which
// the wrapper's smem_bytes mirrors (a card test pins the two).
int decode_attention_smem_bytes(int kv_bytes, int D, int G, int range,
                                int ntab) {
  int maxg = 1;
  while (maxg < G) maxg *= 2;
  return layout(kv_bytes, D, G, maxg, range, ntab).total;
}

// Combine: o [B*KH, NS, G, D], m/l [B*KH, NS, G] -> out [B*KH, G, D] in
// the dtype out_kind names (1 = float32, 2 = bfloat16).
int decode_attention_combine_launch(const void* o, const void* m,
                                    const void* l, void* out, int out_kind,
                                    int BH, int NS, int G, int D,
                                    void* stream) {
  if (BH < 1 || NS < 1 || G < 1 || G > 65535 || D < 1 ||
      (out_kind != 1 && out_kind != 2))
    return (int)cudaErrorInvalidValue;
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(o) % 16 == 0;
  const int per = vec ? D / 4 : D;  // threads a query row needs
  const int nt = per >= CB_NT ? CB_NT : (per + 31) / 32 * 32;
  const dim3 grid(BH, G, (per + nt - 1) / nt);
  const size_t smem = (size_t)(2 * NS + 1) * sizeof(float);
  const auto st = static_cast<cudaStream_t>(stream);
  const float* of = static_cast<const float*>(o);
  const float* mf = static_cast<const float*>(m);
  const float* lf = static_cast<const float*>(l);
  if (out_kind == 2) {
    auto* ob = static_cast<__nv_bfloat16*>(out);
    if (vec)
      combine_kernel<__nv_bfloat16, 4><<<grid, nt, smem, st>>>(of, mf, lf, ob,
                                                              NS, G, D);
    else
      combine_kernel<__nv_bfloat16, 1><<<grid, nt, smem, st>>>(of, mf, lf, ob,
                                                              NS, G, D);
  } else {
    auto* ob = static_cast<float*>(out);
    if (vec)
      combine_kernel<float, 4><<<grid, nt, smem, st>>>(of, mf, lf, ob, NS, G,
                                                      D);
    else
      combine_kernel<float, 1><<<grid, nt, smem, st>>>(of, mf, lf, ob, NS, G,
                                                      D);
  }
  return (int)cudaGetLastError();
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
