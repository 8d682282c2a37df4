// Chunked SSD (Mamba-2) scan for Hopper (sm_90a).
//
// Replaces src/repro/kernels/ssd_scan.py: ssd_scan (_ssd_kernel), the
// state-space dual form over chunks of L positions with the state
// h [P, N] carried from one chunk to the next, starting at zero.  Per
// chunk, with cum the running sum of log_a inside the chunk:
//   G = (C·Bᵀ) ∘ Lmask,  Lmask[t, s] = exp(cum_t - cum_s) for s <= t
//   y = G·X + exp(cum) ∘ (C·hᵀ)
//   h = exp(cum_L) h + (X ∘ exp(cum_L - cum))ᵀ·B
// All four products run in this kernel, in f32 on the CUDA cores (no
// TF32: it keeps about three digits and the reference's tolerance is
// 2e-4).
//
// What bounds it on the card: arithmetic.  At zamba2-1.2b's Mamba-2
// layer (64 heads, S 2048, P 64, N 64, L 128) the products are ~6.4e9
// operations (C·Bᵀ and G·X counted whole) against ~136 MB of inputs and
// outputs, ~47 operations per byte, above the ~20 where f32 CUDA cores
// stop waiting for memory.
//
// Design: one block per (head, slice of PB = 32 columns of P); the TPU's
// sequential chunk axis becomes a loop inside the block, and the block's
// rows of h stay in shared memory for the whole sequence.  Rows of h are
// independent across p, so splitting P doubles the blocks at zamba2's
// 64 heads (128 on 132 SMs), each block recomputing C·Bᵀ for its slice.
// Per chunk the block stages x's slice, and b and c transposed
// ([n][position], rows padded by 4 floats), as f32 with zeros past the
// sequence (a zero log_a, x, b and c change nothing, so a ragged last
// chunk is exact); warp 0 scans log_a into cum.  Then, with a barrier
// between steps, 4 x 4 register tiles and float4 shared-memory reads:
// (1) G for the tiles on or below the diagonal only (exp(cum_t - cum_s)
// above it is positive and can overflow), stored transposed; (2) y of
// the chunk, G·X over s <= t plus exp(cum_t) times C·hᵀ from the old h,
// written to device memory; (3) the new h in place.  The final state is
// written once at the end.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;       // threads per block
constexpr int PB = 32;        // columns of P per block
constexpr int MAXL = 128;     // longest chunk (warp 0 scans 4 per lane)
constexpr int NP4 = PB / 4;   // 4-column tiles of the P slice

struct Layout {
  int Lp, LS, Np;  // chunk padded to 4, its row stride, N padded to 4
  __host__ __device__ Layout(int L, int N)
      : Lp((L + 3) & ~3), LS(((L + 3) & ~3) + 4), Np((N + 3) & ~3) {}
  __host__ __device__ size_t floats() const {
    return 2 * (size_t)Np * LS + (size_t)Lp * PB + (size_t)Lp * Lp +
           (size_t)Np * PB + 3 * (size_t)Lp;
  }
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// row of the id-th tile of the lower triangle, row by row
__device__ __forceinline__ int tri_row(int id) {
  int r = (int)((sqrtf(8.0f * id + 1.0f) - 1.0f) * 0.5f);
  while ((r + 1) * (r + 2) / 2 <= id) ++r;
  while (r * (r + 1) / 2 > id) --r;
  return r;
}

// x [BH, S, P], la [BH, S], b/c [BH, S, N] -> y [BH, S, P],
// fin [BH, P, N]; L: positions per chunk (<= MAXL).
__global__ void __launch_bounds__(NT)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ la,
                const float* __restrict__ b, const float* __restrict__ c,
                float* __restrict__ y, float* __restrict__ fin, int S, int P,
                int N, int L) {
  const Layout lay(L, N);
  const int Lp = lay.Lp, LS = lay.LS, Np = lay.Np, nT = Lp / 4;
  extern __shared__ __align__(16) float smem[];
  float* s_ct = smem;                  // [Np][LS]  c transposed
  float* s_bt = s_ct + Np * LS;        // [Np][LS]  b transposed
  float* s_x = s_bt + Np * LS;         // [Lp][PB]
  float* s_gt = s_x + Lp * PB;         // [Lp][Lp]  G transposed: [s][t]
  float* s_ht = s_gt + Lp * Lp;        // [Np][PB]  h transposed
  float* s_cum = s_ht + Np * PB;       // [Lp]
  float* s_ecum = s_cum + Lp;          // [Lp] exp(cum_t)
  float* s_dec = s_ecum + Lp;          // [Lp] exp(cum_L - cum_s)

  const int g = blockIdx.x, p0 = blockIdx.y * PB;
  const int Pb = min(PB, P - p0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t row0 = (int64_t)g * S;

  for (int i = tid; i < Np * PB; i += NT) s_ht[i] = 0.0f;

  for (int c0 = 0; c0 < S; c0 += L) {
    const int Lv = min(L, S - c0);
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < Lp * PB; i += NT) {
      const int s = i / PB, p = i % PB;
      s_x[i] = (s < Lv && p < Pb) ? x[(row0 + c0 + s) * P + p0 + p] : 0.0f;
    }
    for (int i = tid; i < Lp * Np; i += NT) {
      const int s = i / Np, n = i % Np;
      const bool in = s < Lv && n < N;
      const int64_t src = (row0 + c0 + s) * N + n;
      s_bt[n * LS + s] = in ? b[src] : 0.0f;
      s_ct[n * LS + s] = in ? c[src] : 0.0f;
    }
    if (warp == 0) {  // inclusive running sum of log_a over the chunk
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = lane * 4 + e;
        v[e] = t < Lv ? la[row0 + c0 + t] : 0.0f;
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
    __syncthreads();
    const float cum_last = s_cum[Lp - 1];  // = cum at Lv - 1 (zeros after)
    for (int t = tid; t < Lp; t += NT) {
      s_ecum[t] = expf(s_cum[t]);
      s_dec[t] = expf(cum_last - s_cum[t]);
    }

    // (1) G for the 4 x 4 tiles on or below the diagonal, stored [s][t]
    const int n_live = nT * (nT + 1) / 2;
    for (int id = tid; id < n_live; id += NT) {
      const int tt = tri_row(id), st = id - tt * (tt + 1) / 2;
      float gv[4][4] = {};
      for (int n = 0; n < Np; ++n) {
        const float4 cv = ld4(s_ct + n * LS + tt * 4);
        const float4 bv = ld4(s_bt + n * LS + st * 4);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            gv[a][e] = fmaf(at(cv, a), at(bv, e), gv[a][e]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = st * 4 + e;
        float o[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int t = tt * 4 + a;
          o[a] = s <= t ? gv[a][e] * expf(s_cum[t] - s_cum[s]) : 0.0f;
        }
        *reinterpret_cast<float4*>(s_gt + s * Lp + tt * 4) =
            make_float4(o[0], o[1], o[2], o[3]);
      }
    }
    __syncthreads();

    // (2) y = G·X + exp(cum) ∘ (C·hᵀ), 4 positions x 4 columns a tile
    for (int id = tid; id < nT * NP4; id += NT) {
      const int tt = id / NP4, pt = id % NP4;
      float yv[4][4] = {}, ch[4][4] = {};
      const int s_end = min(Lp, tt * 4 + 4);
      for (int s = 0; s < s_end; ++s) {
        const float4 gv = ld4(s_gt + s * Lp + tt * 4);
        const float4 xv = ld4(s_x + s * PB + pt * 4);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int f = 0; f < 4; ++f)
            yv[a][f] = fmaf(at(gv, a), at(xv, f), yv[a][f]);
      }
      for (int n = 0; n < Np; ++n) {
        const float4 cv = ld4(s_ct + n * LS + tt * 4);
        const float4 hv = ld4(s_ht + n * PB + pt * 4);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int f = 0; f < 4; ++f)
            ch[a][f] = fmaf(at(cv, a), at(hv, f), ch[a][f]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = tt * 4 + a;
        if (t >= Lv) continue;
        float* yr = y + (row0 + c0 + t) * P + p0;
        const float et = s_ecum[t];
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int p = pt * 4 + f;
          if (p < Pb) yr[p] = yv[a][f] + et * ch[a][f];
        }
      }
    }
    __syncthreads();

    // (3) h = exp(cum_L) h + (X ∘ dec)ᵀ·B, 4 columns of P x 4 of N a tile
    const float e_last = expf(cum_last);
    for (int id = tid; id < NP4 * (Np / 4); id += NT) {
      const int nt = id / NP4, pt = id % NP4;
      float hn[4][4] = {};  // [p][n]
      for (int s = 0; s < Lv; ++s) {
        const float4 xv = ld4(s_x + s * PB + pt * 4);
        const float dec = s_dec[s];
        float bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) bv[r] = s_bt[(nt * 4 + r) * LS + s];
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const float xw = at(xv, f) * dec;
#pragma unroll
          for (int r = 0; r < 4; ++r) hn[f][r] = fmaf(xw, bv[r], hn[f][r]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float* hr = s_ht + (nt * 4 + r) * PB + pt * 4;
        const float4 old = ld4(hr);
        *reinterpret_cast<float4*>(hr) = make_float4(
            e_last * old.x + hn[0][r], e_last * old.y + hn[1][r],
            e_last * old.z + hn[2][r], e_last * old.w + hn[3][r]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < Pb * N; i += NT) {
    const int p = i / N, n = i % N;
    fin[((int64_t)g * P + p0 + p) * N + n] = s_ht[n * PB + p];
  }
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for chunk L and state N, in bytes.
int ssd_scan_smem_bytes(int L, int N) {
  return (int)(sizeof(float) * Layout(L, N).floats());
}

// f32 throughout.  0 < L <= 128; the wrapper checks the shared memory.
int ssd_scan_launch(const void* x, const void* la, const void* b,
                    const void* c, void* y, void* fin, int BH, int S, int P,
                    int N, int L, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L < 1 || L > MAXL || N < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)ssd_scan_smem_bytes(L, N);
  static size_t granted[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > 48 * 1024 && smem > granted[dev % 64]) {
    e = cudaFuncSetAttribute(ssd_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    granted[dev % 64] = smem;
  }
  const dim3 grid(BH, (P + PB - 1) / PB);
  ssd_scan_kernel<<<grid, NT, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(la),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<float*>(y), static_cast<float*>(fin), S, P, N, L);
  return (int)cudaGetLastError();
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
