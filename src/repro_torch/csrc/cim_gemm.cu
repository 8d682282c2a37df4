// INT8 GEMM kernels for Hopper (sm_90a): the row quantizer and the int8
// GEMMs on one tensor-core body (dense, and grouped over experts).
//
// Replaces, in src/repro/kernels/cim_gemm.py:
//   quantize_rows_int8           (_rowquant_kernel)
//   cim_gemm_int8_fused_qin      (_cim_gemm_fused_qin_kernel)
//   cim_gemm_int8_fused          (_cim_gemm_fused_kernel)
//   cim_gated_gemm_int8          (_cim_gated_kernel)
//   cim_grouped_gemm_int8        (_cim_grouped_gemm_kernel)
//   cim_grouped_gated_gemm_int8  (_cim_grouped_gated_kernel)
//   cim_gemm_int8                (_cim_gemm_kernel)
// the GEMMs with their quantize_out epilogue (_rowquant) in-kernel.  The
// dense GEMMs (kernels 2, 3, 4 and 6) run on cim_gemm_i8_kernel, the
// tensor-core body, and so do the grouped GEMMs (kernel 7 on the int8
// variant, kernel 8 on the gated one, through cim_gemm_i8_grouped_kernel).
//
// What bounds them on the card: at decode (M = 8 rows) every weight byte
// is used by 8 rows only, so the GEMMs are bound by the int8 weight bytes
// they stream from device memory (2 int8 operations per byte per row,
// far below the ~600 operations per byte where int8 compute would bind).
// At prefill (M = 4096 in a long forward) each weight byte serves 4096
// rows and the int8 operations bind (gemma-2b's down GEMM: 2.7e11
// operations, 0.139 ms at 1979 TOPS).  The grouped GEMMs are bound by the
// weight bytes of the experts that received tokens: an expert whose count
// is 0 streams none.  The row quantizer is bound by its bytes (x read
// once, the codes written once) where the rows are many (a 4096-token
// forward's hidden state, [4096, 16384] f32: 0.10 ms at 3.35 TB/s); at
// decode ([8, 16384] f32, 0.66 MB) by the latency of one launch and one
// pass to device memory, far above its 0.0002 ms byte bound.
//
// The row quantizer, rowquant_kernel<XE, VEC>: a row's scale needs its
// |max| over all of K before any code exists, so a plain kernel reads x
// twice.  Here a row takes one block whose threads hold the row in
// registers (up to RQ_V units of 16 bytes a thread, all loads in flight at
// once), so x is read once and q written once up to 1024 x RQ_V units a
// row (64 KB of f32: every served row).  The wrapper's plan
// (rowquant_plan) gives a row about two units a thread when the rows are
// few (the pass is latency-bound: more warps issue their loads at once
// and the quantize pass is short), four when they are many.  Splitting a
// row over a thread-block cluster was timed and never faster (PERF.md).
// Codes and scales are the reference's: row_scale's IEEE division, and
// quant4 (a multiply by the correctly rounded reciprocal, the IEEE
// division where that lies near a rounding boundary), bitwise the
// division.  Rows that are not 16-byte aligned take single values as
// units.
//
// The dense GEMMs: cim_gemm_i8_kernel<EPI, SHAPE, VAR>.  The product is
// mma.sync.m16n8k32 s8 x s8 -> s32, exact (|sum| <= K 127^2 fits int32 up
// to K ~ 133,000), so the f32 epilogue sees the same int32 totals as the
// plain version in any summation order.  Weights stay [K, N] int8 as the
// public functions hold them (no transposed copy, no extra memory); the
// s8 mma wants both operands contiguous along K, so each lane reads the
// 32-bit word of 4 adjacent columns in the 4 rows of its k-quad from
// shared memory and transposes the 4 x 4 bytes with __byte_perm
// (transpose4x4): the 4 columns' k-quads fill the same fragment slot of
// 4 mma tiles, a column permutation inside the block tile that the
// stores undo.  A stage's 16-byte chunks are XOR-swizzled by row, so
// every warp-wide read of the fragments meets 32 banks.  The wrapper's
// plan (gemm_plan) picks one of two tile shapes and a thread-block
// cluster of C blocks (1 to 8, a launch attribute) that splits the K
// steps; rank 0 sums the ranks' int32 partials through distributed shared
// memory (exact in any order) and runs the epilogue.
// - Decode tile (M <= 16; 8 or 16 rows): bound by bytes in flight.  The
//   operands are swapped: W^T is the mma's A side (16 output columns a
//   tile), the rows of x its n = 8 side, so at M = 8 no lane of the tensor
//   core is padding.  A block owns 64 columns; the cluster splits K so the
//   grid gives every SM a block (gemma-2b's down GEMM: 32 column tiles x 5
//   ranks = 160 blocks).  Each rank stages its activation slice once (rows
//   padded by 16 bytes: the 8 rows a warp reads meet distinct banks) and
//   streams its weight slice with 16-byte cp.async into a ring of 4
//   stages of 128 rows, so three stages are in flight while one is
//   multiplied.  8 warps: 4 along the stage's rows x 2 along its columns;
//   lane t reads its quad's rows in a rotated order (every read then meets
//   both halves of a bank line) and rotates its x words by t bytes to
//   match: the same k permutation on both sides.  The warps' sums meet in
//   shared memory, the ranks' in rank 0.
// - Prefill tile (M > 16): bound by the mma issue rate.  128-row tiles,
//   K steps of 64, stage rows of 128 weight bytes, 8 warps of 64 x 32
//   (4 x 4 mma tiles of 16 x 8), x by ldmatrix, a cp.async ring of 4
//   stages of x and w (opted in above 48 KB once per device before any
//   graph capture), 2 blocks an SM (128 registers) with the f32 epilogue
//   of an int8 x, 1 with the others (they spill at 128, or the f32 x
//   ring fills the SM).  Tiles that do not fill the card (a served
//   prompt: M 200 at N 2048, 32 tiles) take a cluster along K as the
//   decode tile does.
// The variants (VAR) differ in x and in the weights:
// - V_I8 (kernels 3 and 6): x int8 [M, K] with its row scales.
// - V_GATED (kernel 4): two weights, w_gate and w_up, stream through the
//   one ring: a stage row holds 64 columns of each side by side (128
//   bytes, swizzled as the prefill rows, each weight copied in its own
//   pass), so a tile has 64 output columns and 128 accumulator columns,
//   as many as the prefill tile of the others.  On the prefill tile the
//   warps are 4 along the rows x 2 along the columns, each 32 rows x 32
//   output columns of both weights, so a thread holds g and u of the same
//   outputs and the epilogue forms act(g) * u in registers, in the
//   reference's order (g = acc_g xs gs, u = acc_u xs us, each multiply
//   rounded on its own).  Its 128 registers at two blocks an SM are tight:
//   the fragment offsets are one base and immediates, and the epilogue
//   reads the lane's coordinates again rather than keep them through the
//   loop, which leaves no spill (one block an SM was 1.5x slower).
// - V_QF32 and V_QBF16 (kernel 2): x f32 or bf16, quantized in the kernel
//   with the row quantizer's arithmetic, so the codes and scales are
//   bitwise quantize_rows_int8's and the int32 totals those of the plain
//   version.  A row's scale needs its |max| over all of K before any code
//   exists: each rank takes the maxima of its rows over its own K slice,
//   the ranks of a cluster exchange them through distributed shared memory
//   (max is exact in any order) and every block derives the scales.  The
//   decode tile then quantizes the rank's x slice into shared memory
//   once; on the prefill tile the ring carries x as it is (16-byte
//   cp.async) and each step quantizes its x tile into an int8 tile that
//   the mma reads.  The division by the scale bound the prefill tile (the
//   transform took half its time): the codes come from a multiply by the
//   correctly rounded reciprocal, and the IEEE division decides only near
//   a rounding boundary (quant4), bitwise the same.
// The variants' operands travel in the int8 body's argument fields (I8Args)
// rather than in new ones: a larger struct, or the same fields declared
// as unions, moved ptxas's register allocation of kernels 3 and 6.
// wgmma and TMA are left for later work: on mma.sync the prefill tile
// reaches about a fifth of the int8 peak (PERF.md).
// The epilogue runs in f32 in the reference's order, with explicitly
// rounded multiplies and adds (no fused multiply-add), so results without
// an activation match the plain version bit for bit.  EPI_ACC
// (cim_gemm_int8, the row-parallel partial of tensor parallelism) stores
// the exact int32 sum instead and reads no scale: the caller sums the
// partials of all ranks and runs the epilogue once.
//
// The grouped GEMMs run the body once per expert: V_I8 for kernel 7
// (one weight, an optional bias, the expert down GEMM), V_GATED for
// kernel 8.  The expert is blockIdx.z, and cim_gemm_i8_grouped_kernel
// moves every operand to that expert's slice (x, xs, the weights and
// their scales, kernel 7's bias, the output, and with quantize_out q, qs
// and the requant's row maxima and band counters) before the body runs;
// the dense kernels never see the expert or the skip list (counts, a
// second kernel argument), so their argument struct, and with it their
// register allocation, is as it was.  A block of an expert whose count is
// 0 (the skip list, read from the device, no host sync) streams no
// weights.  Where the epilogue of zero accumulators is +0 (the gated pair,
// act(+0) * (+0); kernel 7 without a bias) it stores that (or the code 0
// and the row scale row_scale(0)) and leaves, with no K reduction and no
// wait, so the idle experts' tiles cost one short store each rather than
// a wave slot.  With a bias the rows are act(bias), as in the reference:
// the block runs the body with no K step and takes part in the requant.
// EPI and VAR are compile-time: with the requant tail decided at run time,
// ptxas once gave an int8 GEMM 66 registers in place of 80 and it ran
// 1.5x slower.
//
// The requant epilogue (quantize_out): a row's scale needs its absmax
// over all N columns, which the column tiles share.  Every block writes
// its f32 tile to a scratch buffer, publishes each row's |max| with an
// atomicMax on the float's bits (non-negative floats order as unsigned
// ints; max is exact in any order), fences, and bumps its row band's
// arrival counter (the band is the tile's rows: 8 or 16 on the decode
// tile, 128 on the prefill tile, per expert on the grouped body; only
// rank 0 of a cluster counts in).  The block that arrives last quantizes
// the band's rows from the scratch tile (reading through L2, where the
// other blocks' stores and atomics landed, 8 float4 loads in flight per
// thread) with the row quantizer's arithmetic, so q and the scale are
// bitwise quantize_rows_int8 of the f32 output, and resets the band's
// maxima and counter to 0 for the next launch.  One launch, no block
// waits on another.
//
// The degraded mode (src/repro/quant/linear.py:90-134, whose isfinite screen
// and lax.cond have no Pallas kernel): finite_screen_kernel reduces a
// layer's f32 output to one int32 flag on the device (1: a NaN or inf),
// and the layer's fallback chain runs gated instantiations of the row
// quantizer (rowquant_fallback_kernel) and of the body
// (cim_gemm_i8_fallback_kernel, cim_gemm_i8_grouped_fallback_kernel, f32
// epilogue) that take the flag's address: every block reads the flag
// first and leaves at once when the screen passed, so a healthy step pays
// the screen and launches that exit, with no host sync; when it tripped,
// they read x, the scales, the bias and the residual through nan_to_num
// (SAN; the int8 weights never) and the chain's last launch writes the
// layer's output in place.  The fallback never fuses the requant (its
// chain quantizes the hidden state with the gated row quantizer, the
// same bits).  The ungated kernels are the same code as before: SAN is a
// template argument, and their instantiations and argument structs are
// unchanged.  The gated instantiations build from this source into a
// library of their own (cim_gemm_fallback.cu defines CIM_GEMM_FALLBACK
// and includes this file), in parallel with this one.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

enum Act { ACT_NONE = 0, ACT_GELU = 1, ACT_SILU = 2, ACT_RELU = 3 };
// The epilogue: f32 out, f32 out requantized (quantize_out), int32 sum.
enum Epi { EPI_F32 = 0, EPI_QOUT = 1, EPI_ACC = 2 };

__device__ __forceinline__ float load_f(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
// element i of x as f32: XE = 4 for f32 x, 2 for bf16 x
template <int XE>
__device__ __forceinline__ float load_x(const void* p, int64_t i) {
  if constexpr (XE == 4)
    return load_f(static_cast<const float*>(p), i);
  else
    return load_f(static_cast<const __nv_bfloat16*>(p), i);
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

// nan_to_num(v, 0, 0, 0): how the degraded fallback (SAN) reads a float
// operand; opnd<false> is the plain read, so SAN false compiles to the
// code it always was.
__device__ __forceinline__ bool nonfinite(float v) {
  return (__float_as_uint(v) & 0x7f800000u) == 0x7f800000u;
}
__device__ __forceinline__ float san(float v) {
  return nonfinite(v) ? 0.0f : v;
}
template <bool SAN>
__device__ __forceinline__ float opnd(float v) {
  if constexpr (SAN)
    return san(v);
  else
    return v;
}
template <bool SAN, int N>
__device__ __forceinline__ void opnd_all(float (&f)[N]) {
  if constexpr (SAN) {
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = san(f[i]);
  }
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

// ---------------------------------------------------------------------------
// The dense int8 GEMMs on the tensor cores (kernels 2, 3, 4 and 6); see the
// note at the top of this file.
// ---------------------------------------------------------------------------
constexpr int I8_NT = 256;           // threads per block: 8 warps
constexpr int I8_MAX_SMEM = 232448;  // dynamic shared memory a block may use
// decode tile: up to 16 rows, DBN columns, K steps of 128 rows, DNST
// stages in the cp.async ring
constexpr int DBN = 64, DBK = 128, DNST = 4;
// prefill tile: 128 rows, 128 weight bytes a stage row, K steps of 64,
// PNST stages
constexpr int PBM = 128, PBN = 128, PBK = 64, PNST = 4;
constexpr int PPITCH = PBN + 4;  // int32 row pitch of a rank's partial tile
// the tile shapes of the wrapper's plan: decode at 8 or 16 rows, prefill
enum Shape { DEC8 = 0, DEC16 = 1, PRE = 2 };
// the body's variants: int8 x (kernels 3 and 6), int8 x with two weights
// (kernel 4), f32 or bf16 x quantized in the kernel (kernel 2)
enum Var { V_I8 = 0, V_GATED = 1, V_QF32 = 2, V_QBF16 = 3 };
// weight streams, bytes of an x element, and whether x is quantized in
__host__ __device__ constexpr int var_nw(int v) {
  return v == V_GATED ? 2 : 1;
}
__host__ __device__ constexpr int var_xe(int v) {
  return v == V_QF32 ? 4 : v == V_QBF16 ? 2 : 1;
}
__host__ __device__ constexpr bool var_qin(int v) { return v >= V_QF32; }
// the last bytes of shared memory: row maxima [128] (with quantize-in: the
// rank's row maxima, read by the other ranks), the requant's or the
// quantize-in's row scales [128], the last-block flag
constexpr int I8_TAIL = 128 * 4 + 128 * 4 + 16;

struct I8Layout {
  int x, x_pitch, tail, total;  // byte offsets (x: the decode x slice)
};
// Dynamic shared memory of one block (cim_gemm_i8_smem_bytes; the wrapper's
// gemm_plan counts the same).  Decode: the ring of NST stages of DBK rows
// of DBN bytes a weight (reused for the warps' K sums), then the rank's
// activation slice: MR rows of spr * DBK bytes, each padded by 16 so that
// the 8 rows a warp reads fall on distinct banks.  Prefill: the ring of NST
// stages of x [PBM][PBK] (f32 or bf16 values with quantize-in) and w
// [PBK][PBN] bytes, then with quantize-in the int8 x tile of the step, or
// with a cluster the int32 partial tile that takes the place of both for
// the merge, whichever is larger.
__host__ __device__ inline I8Layout i8_layout(int shape, int var, int K,
                                              int C) {
  I8Layout L;
  if (shape == PRE) {
    const int ring = PNST * (PBM * PBK * var_xe(var) + PBK * PBN);
    const int body = ring + (var_qin(var) ? PBM * PBK : 0);
    const int part = C > 1 ? PBM * PPITCH * 4 : 0;
    L.x = ring;  // quantize-in: the int8 x tile
    L.x_pitch = 0;
    L.tail = body > part ? body : part;
  } else {
    const int mr = shape == DEC8 ? 8 : 16;
    const int steps = (K + DBK - 1) / DBK;
    const int spr = (steps + C - 1) / C;
    L.x = DNST * DBK * DBN * var_nw(var);
    L.x_pitch = spr * DBK + 16;
    L.tail = L.x + mr * L.x_pitch;
  }
  L.total = L.tail + I8_TAIL;
  return L;
}

// The other variants' operands travel in the int8 body's fields (see the
// note at the top of this file): f32 or bf16 x in x's slot, and the gated
// body, which has no bias and no residual, carries the up weight in res's
// slot and its scales in bias's (x_in, w_up, s_up).
struct I8Args {
  const int8_t* x;     // [M, K] int8; V_QF32, V_QBF16: f32 or bf16
  const float* xs;     // [M] (V_I8, V_GATED; not read by EPI_ACC)
  const int8_t* w;     // [K, N] (V_GATED: the gate's)
  const float* ws;     // [N]
  const float* bias;   // [N] or null; V_GATED: the up weight's scales [N]
  const void* res;     // [M, N] f32 or bf16, or null; V_GATED: the up
                       // weight [K, N]
  int res_kind, act;
  void* out;           // f32 [M, N] (EPI_QOUT: the scratch), int32 (EPI_ACC)
  int8_t* q;           // EPI_QOUT: [M, N]
  float* qs;           // EPI_QOUT: [M]
  unsigned int* amax;  // EPI_QOUT: [M], zero
  int* arrive;         // EPI_QOUT: one counter a row band, zero
  int M, K, N;
  int x16, w16;        // rows copyable in 16-byte chunks
};

__device__ __forceinline__ const void* x_in(const I8Args& a) {
  return static_cast<const void*>(a.x);
}
__device__ __forceinline__ const int8_t* w_up(const I8Args& a) {
  return static_cast<const int8_t*>(a.res);
}
__device__ __forceinline__ const float* s_up(const I8Args& a) {
  return a.bias;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared; zero-fills when !ok (source size 0)
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16 x 32, row) . b (32 x 8, col): s8 in, s32 accumulated exactly
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Swizzles of a stage: 16-byte chunk c of stage row r lies at chunk
// c ^ swz(r), so that each warp-wide 32-bit read of the fragment loops
// (and each 8-row ldmatrix of x) touches 32 distinct banks.
__device__ __forceinline__ int dswz(int r) { return ((r >> 3) & 1) << 1; }
__device__ __forceinline__ int pswz(int r) { return ((r >> 2) & 3) << 1; }
__device__ __forceinline__ int xswz(int r) { return (r >> 1) & 3; }

// Copy weight rows k0 .. k0 + ROWS - 1 (rows at or past kend read as zero)
// into a swizzled stage of ROWS rows of CPR chunks (pswz when PSWZ, else
// dswz): with one weight (NW 1) its columns n0 .. n0 + 16 CPR - 1; with two
// (the gated body) the first CPR / 2 chunks of a row from w (the gate) and
// the rest from the up weight, both at columns n0 .. n0 + 8 CPR - 1, one
// weight a pass (the source is then fixed at compile time).  Columns past
// N read as zero.  16-byte copies when w16, else 4-byte ones (N % 4 == 0).
template <int ROWS, int CPR, int NW, bool PSWZ>
__device__ __forceinline__ void copy_w(uint32_t dst, const I8Args& a, int k0,
                                       int kend, int n0, int tid) {
  constexpr int CW = CPR / NW;  // chunks of one weight in a stage row
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const int8_t* src = w == 0 ? a.w : w_up(a);
    if (a.w16) {
#pragma unroll
      for (int i = tid; i < ROWS * CW; i += I8_NT) {
        const int r = i / CW, c = i % CW;
        const int k = k0 + r, n = n0 + 16 * c;
        const bool ok = k < kend && n < a.N;
        const int s = PSWZ ? pswz(r) : dswz(r);
        cp16(dst + r * CPR * 16 + 16 * ((c + CW * w) ^ s),
             ok ? src + (int64_t)k * a.N + n : src, ok);
      }
    } else {
      for (int i = tid; i < ROWS * CW * 4; i += I8_NT) {
        const int r = i / (CW * 4), wd = i % (CW * 4);
        const int k = k0 + r, n = n0 + 4 * wd;
        const bool ok = k < kend && n < a.N;
        const int s = PSWZ ? pswz(r) : dswz(r);
        cp4(dst + r * CPR * 16 + 16 * (((wd >> 2) + CW * w) ^ s) +
                4 * (wd & 3),
            ok ? src + (int64_t)k * a.N + n : src, ok);
      }
    }
  }
}

// Copy x rows m0 .. m0 + rows - 1 (past M zero), columns k0 .. k0 + cols
// - 1 (at or past kend zero) to dst: chunk c of row r at byte r * pitch +
// 16 (c ^ xswz(r)) when SWZ, else r * pitch + 16 c.  16-byte copies when
// x16, else byte by byte (synchronous: rows of any length and alignment).
template <bool SWZ>
__device__ __forceinline__ void copy_x(unsigned char* dst, int pitch,
                                       const I8Args& a, int rows, int cols,
                                       int m0, int k0, int kend, int tid) {
  if (a.x16) {
    const int cpr = cols / 16;
    for (int i = tid; i < rows * cpr; i += I8_NT) {
      const int r = i / cpr, c = i % cpr;
      const int m = m0 + r, k = k0 + 16 * c;
      const bool ok = m < a.M && k < kend;
      cp16(smem_u32(dst + r * pitch + 16 * (SWZ ? c ^ xswz(r) : c)),
           ok ? a.x + (int64_t)m * a.K + k : a.x, ok);
    }
  } else {
    for (int i = tid; i < rows * cols; i += I8_NT) {
      const int r = i / cols, b = i % cols;
      const int m = m0 + r, k = k0 + b;
      const int c = b / 16;
      dst[r * pitch + 16 * (SWZ ? c ^ xswz(r) : c) + b % 16] =
          (m < a.M && k < kend) ? (unsigned char)a.x[(int64_t)m * a.K + k]
                                : (unsigned char)0;
    }
  }
}

// 16 bytes of x as f32: 4 f32 values or 8 bf16 ones (a bf16 is the high
// half of its f32)
__device__ __forceinline__ void unpack16(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack16(const uint4& v, float (&f)[8]) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// Four int8 codes quant1(f[j], s), byte j from f[j], for values of the
// row whose scale s is (so |f / s| <= 127), given r = 1 / s correctly
// rounded: y = f r lies within 2.3e-5 of the rounded quotient f / s (two
// roundings of 2^-24 relative at |f / s| <= 127.5), so rint(y) is the code
// unless y lies within 2^-14 of a rounding boundary; then the IEEE
// division decides the four (NaN lands there too).  Zeros, the padding of
// ragged tiles, never reach the division, whose slow path a zero dividend
// takes.
__device__ __forceinline__ uint32_t quant4(const float* f, float s,
                                           float r) {
  float c[4];
  bool near = false;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float y = __fmul_rn(f[j], r);
    c[j] = rintf(y);
    near |= !(fabsf(__fsub_rn(y, c[j])) < 0.5f - 0x1p-14f);
  }
  if (near) {
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = (float)quant1(f[j], s);
  }
  uint32_t p = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    p |= (uint32_t)((int)c[j] & 0xff) << (8 * j);
  return p;
}

// ---------------------------------------------------------------------------
// The row quantizer (kernel 1); see the note at the top of this file.
// ---------------------------------------------------------------------------
constexpr int RQ_V = 8;          // units a thread holds
constexpr int RQ_MAX_NT = 1024;  // threads of a block

// Units i0 + j G (j < RQ_V) of a row of n units at xr, zero past the
// row: 16 bytes (f32 or bf16 values) when VEC, else one value as f32.
template <int XE, bool VEC, typename Unit>
__device__ __forceinline__ void rq_load(Unit (&v)[RQ_V],
                                        const unsigned char* xr, int i0,
                                        int G, int n) {
#pragma unroll
  for (int j = 0; j < RQ_V; ++j) {
    const int i = i0 + j * G;
    if constexpr (VEC)
      v[j] = i < n ? __ldg(reinterpret_cast<const uint4*>(xr) + i)
                   : make_uint4(0u, 0u, 0u, 0u);
    else
      v[j] = i < n ? load_x<XE>(xr, i) : 0.0f;
  }
}

template <int XE, bool VEC, bool SAN, typename Unit>
__device__ __forceinline__ float rq_absmax(const Unit (&v)[RQ_V]) {
  float a = 0.0f;
#pragma unroll
  for (int j = 0; j < RQ_V; ++j) {
    if constexpr (VEC) {
      float f[16 / XE];
      unpack16(v[j], f);
      opnd_all<SAN>(f);
#pragma unroll
      for (int i = 0; i < 16 / XE; ++i) a = fmaxf(a, fabsf(f[i]));
    } else {
      a = fmaxf(a, fabsf(opnd<SAN>(v[j])));
    }
  }
  return a;
}

// The codes of the units rq_load gave, with the row's scale s (r = 1 / s
// correctly rounded), to qr (the row's first code).
template <int XE, bool VEC, bool SAN, typename Unit>
__device__ __forceinline__ void rq_store(const Unit (&v)[RQ_V], int8_t* qr,
                                         int i0, int G, int n, float s,
                                         float r) {
#pragma unroll
  for (int j = 0; j < RQ_V; ++j) {
    const int i = i0 + j * G;
    if (i >= n) continue;
    if constexpr (!VEC) {
      qr[i] = (int8_t)quant1(opnd<SAN>(v[j]), s);
    } else {
      float f[16 / XE];
      unpack16(v[j], f);
      opnd_all<SAN>(f);
      if constexpr (XE == 4)
        reinterpret_cast<uint32_t*>(qr)[i] = quant4(f, s, r);
      else
        reinterpret_cast<uint2*>(qr)[i] =
            make_uint2(quant4(f, s, r), quant4(f + 4, s, r));
    }
  }
}

// x [M, K] (XE = 4: f32, 2: bf16) -> q [M, K] int8, scale [M].  Block m
// takes row m, in units of 16 bytes when VEC, else single values.  A
// thread holds RQ_V units of the row at a time: when the row is longer
// than blockDim RQ_V units, the first pass walks it for the |max| and the
// second reads all but the last chunk again.  SAN reads x through
// nan_to_num (the degraded fallback).
template <int XE, bool VEC, bool SAN>
__device__ __forceinline__ void rowquant_rows(const void* __restrict__ x,
                                              int8_t* __restrict__ q,
                                              float* __restrict__ scale,
                                              int K) {
  using Unit = typename std::conditional<VEC, uint4, float>::type;
  constexpr int PER = VEC ? 16 / XE : 1;  // values of a unit
  __shared__ float s_warp[32];
  const int tid = threadIdx.x, G = blockDim.x, m = (int)blockIdx.x;
  const int n = K / PER;  // units of the row (32-bit arithmetic only)
  const int chunk = G * RQ_V;
  const int nch = max(1, (n + chunk - 1) / chunk);
  const int64_t first = (int64_t)m * K;
  const unsigned char* xr = static_cast<const unsigned char*>(x) + first * XE;
  int8_t* qr = q + first;

  Unit v[RQ_V];
  float amx = 0.0f;
  for (int c = 0; c < nch; ++c) {
    rq_load<XE, VEC>(v, xr, c * chunk + tid, G, n);
    amx = fmaxf(amx, rq_absmax<XE, VEC, SAN>(v));
  }
  // the row's |max|: the block's lanes, then its warps
#pragma unroll
  for (int o = 16; o; o >>= 1)
    amx = fmaxf(amx, __shfl_xor_sync(0xffffffffu, amx, o));
  if (tid % 32 == 0) s_warp[tid / 32] = amx;
  __syncthreads();
  amx = 0.0f;
  for (int w = 0; w < G / 32; ++w) amx = fmaxf(amx, s_warp[w]);
  const float s = row_scale(amx), r = __frcp_rn(s);
  for (int c = nch - 1; c >= 0; --c) {
    if (c != nch - 1) rq_load<XE, VEC>(v, xr, c * chunk + tid, G, n);
    rq_store<XE, VEC, SAN>(v, qr, c * chunk + tid, G, n, s, r);
  }
  if (tid == 0) scale[m] = s;
}

template <int XE, bool VEC>
__global__ void __launch_bounds__(RQ_MAX_NT)
rowquant_kernel(const void* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scale, int K) {
  rowquant_rows<XE, VEC, false>(x, q, scale, K);
}

// The degraded fallback of the row quantizer: nothing when the screen's
// flag (*gate) is 0 (passed); else the rows of nan_to_num(x).
template <int XE, bool VEC>
__global__ void __launch_bounds__(RQ_MAX_NT)
rowquant_fallback_kernel(const void* __restrict__ x, int8_t* __restrict__ q,
                         float* __restrict__ scale, int K,
                         const int* __restrict__ gate) {
  if (*gate == 0) return;
  rowquant_rows<XE, VEC, true>(x, q, scale, K);
}

// Quantize-in: the |max| of x rows m0 .. m0 + rows - 1 (0 past M) over
// columns k_lo .. kend - 1, as float bits into s_part[0 .. rows - 1].  Warp
// w takes rows w, w + 8, ..., two at a time, its lanes 16-byte loads along
// the rows (8 a row in flight) when x16, else single values: the band's
// rows come from L2, and the loads in flight set the pace.
template <int XE, bool SAN>
__device__ __forceinline__ void qin_row_max(const I8Args& a, int m0,
                                            int rows, int k_lo, int kend,
                                            unsigned int* s_part, int tid) {
  constexpr int VEC = 16 / XE;  // values of a 16-byte load
  constexpr int NW8 = I8_NT / 32, U = 8;
  const int warp = tid / 32, lane = tid % 32;
  const int n = (kend - k_lo) / VEC;  // 16-byte loads of a row (x16)
  for (int r0 = warp; r0 < rows; r0 += 2 * NW8) {
    float amx[2] = {0.0f, 0.0f};
    bool live[2];
    int64_t base[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      live[h] = r0 + NW8 * h < rows && m0 + r0 + NW8 * h < a.M;
      base[h] = (int64_t)(m0 + r0 + NW8 * h) * a.K + k_lo;
    }
    if (a.x16) {
      for (int i0 = lane; i0 < n; i0 += U * 32) {
        uint4 v[2][U];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int u = 0; u < U; ++u)
            v[h][u] = live[h] && i0 + 32 * u < n
                          ? __ldg(reinterpret_cast<const uint4*>(
                                static_cast<const unsigned char*>(x_in(a)) +
                                base[h] * XE) + i0 + 32 * u)
                          : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int u = 0; u < U; ++u) {
            float f[VEC];
            unpack16(v[h][u], f);
            opnd_all<SAN>(f);
#pragma unroll
            for (int j = 0; j < VEC; ++j) amx[h] = fmaxf(amx[h], fabsf(f[j]));
          }
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (live[h])
          for (int k = lane; k < kend - k_lo; k += 32)
            amx[h] = fmaxf(amx[h],
                           fabsf(opnd<SAN>(load_x<XE>(x_in(a), base[h] + k))));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int o = 16; o; o >>= 1)
        amx[h] = fmaxf(amx[h], __shfl_xor_sync(0xffffffffu, amx[h], o));
      if (lane == 0 && r0 + NW8 * h < rows)
        s_part[r0 + NW8 * h] = __float_as_uint(amx[h]);
    }
  }
}

// Quantize-in: the rows' scales from the maxima of every rank of the
// cluster (read through distributed shared memory; max is exact in any
// order), row_scale as the row quantizer's.  s_part stays as it is until
// the ranks' last cluster barrier, so no rank reads a block that has
// left.
__device__ __forceinline__ void qin_scales(cg::cluster_group& cluster, int C,
                                           unsigned int* s_part,
                                           float* s_scale, int rows,
                                           int tid) {
  if (C > 1)
    cluster.sync();
  else
    __syncthreads();
  if (tid < rows) {
    unsigned int amx = s_part[tid];
    if (C > 1)
      for (int r = 0; r < C; ++r)
        amx = max(amx, cluster.map_shared_rank(s_part, r)[tid]);
    s_scale[tid] = row_scale(__uint_as_float(amx));
  }
  __syncthreads();
}

// Quantize-in, decode: x rows 0 .. rows - 1 (zero past M), columns k_lo ..
// k_lo + cols - 1 (zero at or past kend), quantized with the rows' scales
// into the rank's activation slice (row pitch ``pitch``), four codes a
// 32-bit word, four words a thread in flight.
template <int XE, bool SAN>
__device__ __forceinline__ void qin_stage_slice(unsigned char* dst, int pitch,
                                                const I8Args& a, int rows,
                                                int cols, int k_lo, int kend,
                                                const float* s_scale,
                                                int tid) {
  const int wpr = cols / 4, total = rows * wpr;
  for (int i0 = tid; i0 < total; i0 += 4 * I8_NT) {
    float v[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * I8_NT;
      const int r = i / wpr, k = k_lo + 4 * (i % wpr);
      const bool row = i < total && r < a.M;
      const int64_t o = (int64_t)r * a.K + k;
      if (row && a.x16 && k < kend) {
        // 4 values in one load: K % 4 == 0, so k + 3 < kend
        if constexpr (XE == 4) {
          const float4 f = __ldg(reinterpret_cast<const float4*>(
              static_cast<const float*>(x_in(a)) + o));
          v[u][0] = f.x;
          v[u][1] = f.y;
          v[u][2] = f.z;
          v[u][3] = f.w;
        } else {
          const uint2 h = __ldg(reinterpret_cast<const uint2*>(
              static_cast<const __nv_bfloat16*>(x_in(a)) + o));
          v[u][0] = __uint_as_float(h.x << 16);
          v[u][1] = __uint_as_float(h.x & 0xffff0000u);
          v[u][2] = __uint_as_float(h.y << 16);
          v[u][3] = __uint_as_float(h.y & 0xffff0000u);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[u][j] = row && k + j < kend ? load_x<XE>(x_in(a), o + j) : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * I8_NT;
      if (i < total) {
        const int r = i / wpr;
        const float s = s_scale[r];
        opnd_all<SAN>(v[u]);
        *reinterpret_cast<uint32_t*>(dst + r * pitch + 4 * (i % wpr)) =
            quant4(v[u], s, __frcp_rn(s));
      }
    }
  }
}

// Quantize-in, prefill: x rows m0 .. m0 + PBM - 1 (zero past M), columns
// k0 .. k0 + PBK - 1 (zero at or past kend) as they are (f32 or bf16) into
// dst, row pitch PBK XE bytes: 16-byte cp.async when x16, else value by
// value (synchronous: rows of any length and alignment).
template <int XE>
__device__ __forceinline__ void copy_xraw(unsigned char* dst, const I8Args& a,
                                          int m0, int k0, int kend, int tid) {
  const unsigned char* x = static_cast<const unsigned char*>(x_in(a));
  if (a.x16) {
    constexpr int VEC = 16 / XE, CPR = PBK / VEC;
#pragma unroll
    for (int i = tid; i < PBM * CPR; i += I8_NT) {
      const int r = i / CPR, c = i % CPR;
      const int m = m0 + r, k = k0 + VEC * c;
      const bool ok = m < a.M && k < kend;
      cp16(smem_u32(dst + 16 * i), ok ? x + ((int64_t)m * a.K + k) * XE : x,
           ok);
    }
  } else {
    using U = typename std::conditional<XE == 4, uint32_t, uint16_t>::type;
    for (int i = tid; i < PBM * PBK; i += I8_NT) {
      const int r = i / PBK, b = i % PBK;
      const int m = m0 + r, k = k0 + b;
      reinterpret_cast<U*>(dst)[i] =
          m < a.M && k < kend
              ? reinterpret_cast<const U*>(x)[(int64_t)m * a.K + k]
              : (U)0;
    }
  }
}

// Quantize-in, prefill: the step's x tile (src, PBM x PBK values as
// copy_xraw lays them out) quantized with the rows' scales into the int8
// tile the mma reads (dst, swizzled as copy_x<true> lays a stage out), a
// 16-byte chunk (4 or 8 values) a thread at a time.
template <int XE, bool SAN>
__device__ __forceinline__ void qin_quantize_tile(const unsigned char* src,
                                                  unsigned char* dst,
                                                  const float* s_scale,
                                                  int tid) {
  constexpr int VEC = 16 / XE, CPR = PBK / VEC;
#pragma unroll
  for (int i = tid; i < PBM * CPR; i += I8_NT) {
    const int r = i / CPR, k = VEC * (i % CPR);
    float f[VEC];
    unpack16(*reinterpret_cast<const uint4*>(src + 16 * i), f);
    opnd_all<SAN>(f);
    const float s = s_scale[r], rs = __frcp_rn(s);
    unsigned char* d = dst + r * PBK + 16 * ((k >> 4) ^ xswz(r)) + (k & 15);
    if constexpr (VEC == 4)
      *reinterpret_cast<uint32_t*>(d) = quant4(f, s, rs);
    else
      *reinterpret_cast<uint2*>(d) = make_uint2(quant4(f, s, rs),
                                                quant4(f + 4, s, rs));
  }
}

// The copies of one K step (from row k0) into stage st of the ring.
template <int SHAPE, int VAR>
__device__ __forceinline__ void load_step(unsigned char* smem, int st,
                                          const I8Args& a, int k0, int kend,
                                          int m0, int n0, int tid) {
  constexpr int NW = var_nw(VAR), XE = var_xe(VAR);
  if constexpr (SHAPE == PRE) {
    constexpr int XB = PBM * PBK * XE;
    unsigned char* s = smem + st * (XB + PBK * PBN);
    if constexpr (var_qin(VAR))
      copy_xraw<XE>(s, a, m0, k0, kend, tid);
    else
      copy_x<true>(s, PBK, a, PBM, PBK, m0, k0, kend, tid);
    copy_w<PBK, PBN / 16, NW, true>(smem_u32(s + XB), a, k0, kend, n0, tid);
  } else {
    copy_w<DBK, DBN * NW / 16, NW, NW == 2>(
        smem_u32(smem + st * DBK * DBN * NW), a, k0, kend, n0, tid);
  }
}

// dequant, bias, activation, residual in the reference's order, each
// product and sum rounded on its own (EPI_F32 and EPI_QOUT); xs is the
// row's scale.  SAN reads the operands through nan_to_num.
template <bool SAN>
__device__ __forceinline__ float i8_epilogue(const I8Args& a, float xs,
                                             int tot, int gm, int gn) {
  float y = __fmul_rn(__fmul_rn((float)tot, xs), opnd<SAN>(a.ws[gn]));
  if (a.bias != nullptr) y = __fadd_rn(y, opnd<SAN>(a.bias[gn]));
  y = activate(y, a.act);
  const int64_t o = (int64_t)gm * a.N + gn;
  if (a.res_kind == 1)
    y = __fadd_rn(y, opnd<SAN>(static_cast<const float*>(a.res)[o]));
  else if (a.res_kind == 2)
    y = __fadd_rn(y, opnd<SAN>(__bfloat162float(
                         static_cast<const __nv_bfloat16*>(a.res)[o])));
  return y;
}

// The f32 output of row gm (lm in the tile), column gn from the int32
// totals t0 (and t1, the gated body's up side): the gated epilogue
// act(acc_g xs gs) * (acc_u xs us) as the reference's _cim_gated_kernel
// orders it, or i8_epilogue with the row's scale from xs (from the
// quantize-in scales s_scale).
template <int VAR, bool SAN>
__device__ __forceinline__ float i8_out(const I8Args& a,
                                        const float* s_scale, int t0, int t1,
                                        int lm, int gm, int gn) {
  if constexpr (VAR == V_GATED) {
    const float xs = opnd<SAN>(a.xs[gm]);
    const float g = __fmul_rn(__fmul_rn((float)t0, xs), opnd<SAN>(a.ws[gn]));
    const float u =
        __fmul_rn(__fmul_rn((float)t1, xs), opnd<SAN>(s_up(a)[gn]));
    return __fmul_rn(activate(g, a.act), u);
  } else if constexpr (var_qin(VAR)) {
    return i8_epilogue<SAN>(a, s_scale[lm], t0, gm, gn);
  } else {
    return i8_epilogue<SAN>(a, opnd<SAN>(a.xs[gm]), t0, gm, gn);
  }
}

// EPI_QOUT, after the block's f32 stores with its rows' |max| in s_amax:
// publish the maxima, count the block in its row band, and in the band's
// last block turn the band's ``rows`` f32 rows (from m0) into int8 codes
// and scales with the row quantizer's arithmetic (8 float4 loads in
// flight a thread), resetting the maxima and the counter to 0.
__device__ __forceinline__ void i8_requant(const I8Args& a, unsigned char* tl,
                                           int m0, int rows, int band,
                                           int blocks, int tid) {
  unsigned int* s_amax = reinterpret_cast<unsigned int*>(tl);
  float* s_rs = reinterpret_cast<float*>(tl + 512);
  int* s_last = reinterpret_cast<int*>(tl + 1024);
  const int M = a.M, N = a.N;
  __syncthreads();
  if (tid < rows && m0 + tid < M) atomicMax(&a.amax[m0 + tid], s_amax[tid]);
  __threadfence();
  __syncthreads();
  if (tid == 0) *s_last = atomicAdd(&a.arrive[band], 1) == blocks - 1;
  __syncthreads();
  if (!*s_last) return;
  __threadfence();
  if (tid < rows && m0 + tid < M) {
    const float s = row_scale(__uint_as_float(__ldcg(&a.amax[m0 + tid])));
    s_rs[tid] = s;
    a.qs[m0 + tid] = s;
    a.amax[m0 + tid] = 0u;
  }
  __syncthreads();
  constexpr int RQ = 8;
  const int n4 = N / 4;
  const int total = min(rows, M - m0) * n4;
  const float4* h4 = reinterpret_cast<const float4*>(
      static_cast<const float*>(a.out) + (int64_t)m0 * N);
  char4* q4 = reinterpret_cast<char4*>(a.q + (int64_t)m0 * N);
  for (int i0 = tid; i0 < total; i0 += RQ * I8_NT) {
    float4 v[RQ];
#pragma unroll
    for (int u = 0; u < RQ; ++u)
      if (i0 + u * I8_NT < total) v[u] = __ldcg(&h4[i0 + u * I8_NT]);
#pragma unroll
    for (int u = 0; u < RQ; ++u) {
      const int i = i0 + u * I8_NT;
      if (i < total) {
        const float s = s_rs[i / n4];
        q4[i] = make_char4(quant1(v[u].x, s), quant1(v[u].y, s),
                           quant1(v[u].z, s), quant1(v[u].w, s));
      }
    }
  }
  if (tid == 0) a.arrive[band] = 0;
}

// One body: two tile shapes (SHAPE, from the wrapper's plan), three
// epilogues (EPI) and four variants (VAR).  A cluster of C blocks (a launch
// attribute, 1 to 8) shares one output tile and splits its K steps: rank r
// takes steps [r steps / C, (r + 1) steps / C) of the ceil(K / BK); rank 0
// sums the ranks' int32 partials through distributed shared memory and
// runs the epilogue.  SAN (the degraded fallback) reads every float
// operand through nan_to_num: x (quantize-in), the row and weight scales,
// the bias and the residual.
template <int EPI, int SHAPE, int VAR, bool SAN = false>
__device__ __forceinline__ void i8_body(const I8Args& a) {
  constexpr bool DEC = SHAPE != PRE;
  constexpr bool QIN = var_qin(VAR);
  constexpr int NW = var_nw(VAR);             // weight streams
  constexpr int XE = var_xe(VAR);             // bytes of an x element
  constexpr int NJ = SHAPE == DEC16 ? 2 : 1;  // decode: n-tiles of 8 rows
  constexpr int MR = 8 * NJ;                  // decode: rows of the tile
  constexpr int BK = DEC ? DBK : PBK;
  constexpr int BN = DEC ? DBN : PBN / NW;    // output columns of a tile
  constexpr int NST = DEC ? DNST : PNST;
  constexpr int XB = PBM * PBK * XE;          // prefill: x bytes of a stage
  constexpr int RB = DEC ? DBN * NW : PBN;    // weight bytes of a stage row
  constexpr int STAGE = DEC ? DBK * RB : XB + PBK * PBN;
  // decode warps: WK along the stage's K rows x WN along its columns,
  // KSW k-steps of 32 rows each a stage
  constexpr int WN = DBN / 32, WK = 8 / WN, KSW = DBK / (32 * WK);
  // prefill warps: 2^PWL along the tile's columns (2 for the gated body:
  // 32 output columns of both weights each), the rest along its rows,
  // RPW rows each
  constexpr int PWL = NW == 2 ? 1 : 2;
  constexpr int RPW = PBM >> (3 - PWL);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = (int)(blockIdx.x / C) * BN;
  const int m0 = DEC ? 0 : (int)blockIdx.y * PBM;
  const I8Layout L = i8_layout(SHAPE, VAR, a.K, C);
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* tail = smem + L.tail;
  // quantize-in: the rank's row maxima and the rows' scales
  unsigned int* s_part = reinterpret_cast<unsigned int*>(tail);
  float* s_xs = reinterpret_cast<float*>(tail + 512);
  if (EPI == EPI_QOUT && tid < 128)
    reinterpret_cast<unsigned int*>(tail)[tid] = 0u;

  // this rank's K steps
  const int steps = (a.K + BK - 1) / BK;
  const int s_lo = rank * steps / C;  // steps < 2^28: no 64-bit division
  const int nsteps = (rank + 1) * steps / C - s_lo;
  const int k_lo = s_lo * BK;
  const int kend = min(a.K, (s_lo + nsteps) * BK);
  const uint32_t ring = smem_u32(smem);

  if constexpr (DEC && !QIN)  // the rank's activation slice, once, in group 0
    copy_x<false>(smem + L.x, L.x_pitch, a, MR, L.x_pitch - 16, 0, k_lo, kend,
                  tid);
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) {
    if (i < nsteps)
      load_step<SHAPE, VAR>(smem, i, a, k_lo + i * BK, kend, m0, n0, tid);
    cp_commit();
  }
  if constexpr (QIN) {
    // the rows' scales while the first stages fly; the decode tile then
    // quantizes its x slice once
    constexpr int ROWS = DEC ? MR : PBM;
    qin_row_max<XE, SAN>(a, m0, ROWS, k_lo, kend, s_part, tid);
    qin_scales(cluster, C, s_part, s_xs, ROWS, tid);
    if constexpr (DEC)
      qin_stage_slice<XE, SAN>(smem + L.x, L.x_pitch, a, MR, L.x_pitch - 16,
                               k_lo, kend, s_xs, tid);
  }

  // decode: warp (wk, wn) takes stage rows 32 KSW wk .. + 32 KSW - 1 and
  // output columns 32 wn .. + 31 (two m-tiles of W^T); prefill: warp (wm, wn)
  // takes rows RPW wm .. + RPW - 1 (TA m-tiles of x) and columns 32 wn ..
  // + 31 (4 n-tiles of W) of each weight.  acc[w] sums weight w.
  constexpr int TA = DEC ? 2 : RPW / 16, TB = DEC ? NJ : 4;
  int acc[NW][TA][TB][4];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int i = 0; i < TA; ++i)
#pragma unroll
      for (int j = 0; j < TB; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[w][i][j][r] = 0;

  // Per-lane shared-memory offsets within a stage.  W fragments: lane
  // (g, t) reads the 32-bit word of 4 adjacent columns 4 (8 wn + g) .. + 3
  // in 4 rows of its k-quad and transposes them (transpose4x4): the 4
  // columns' k-quads fill one fragment slot of 4 tiles, a column
  // permutation inside the tile that the stores undo.
  const int wa = DEC ? warp / WN : warp >> PWL;  // wk (decode), wm (prefill)
  const int wn = DEC ? warp % WN : warp & ((1 << PWL) - 1);
  const int c16 = 2 * wn + (g >> 2);  // the word's chunk in its row
  uint32_t w_off[2][4];
  if constexpr (DEC) {
    // lane t reads its quad's rows in the order 4t + ((j + t) & 3): every
    // read then meets both halves of a bank line; the k permutation is
    // undone on the x side by rotating its words by t bytes
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ra = 32 * KSW * wa + 4 * t + ((j + t) & 3), rb = ra + 16;
      if constexpr (NW == 1) {
        w_off[0][j] = ra * DBN + 16 * (c16 ^ dswz(ra)) + 4 * (g & 3);
        w_off[1][j] = rb * DBN + 16 * (c16 ^ dswz(rb)) + 4 * (g & 3);
      } else {
        w_off[0][j] = ra * RB + 16 * (c16 ^ pswz(ra)) + 4 * (g & 3);
        w_off[1][j] = rb * RB + 16 * (c16 ^ pswz(rb)) + 4 * (g & 3);
      }
    }
  } else if constexpr (NW == 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ra = 4 * t + j, rb = ra + 16;  // + 32 per k-step of the stage
      w_off[0][j] = XB + ra * PBN + 16 * (c16 ^ pswz(ra)) + 4 * (g & 3);
      w_off[1][j] = XB + rb * PBN + 16 * (c16 ^ pswz(rb)) + 4 * (g & 3);
    }
  } else {
    // the same offsets, written as one base and the rows as immediates
    // (every row 4t + j, + 16, + 32 a lane reads has pswz 2t): the gated
    // prefill tile keeps its registers for the two weights' fragments
    const uint32_t wb =
        XB + 4 * t * PBN + 16 * (c16 ^ (2 * t)) + 4 * (g & 3);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w_off[0][j] = wb + j * PBN;
      w_off[1][j] = wb + (16 + j) * PBN;
    }
  }
  // the gated body: the up weight's word lies 4 chunks past the gate's
  // (c16 < 4) before the swizzle; every row a lane reads has pswz 2t, so
  // after it the word moves by 64 bytes, down when bit 2 of 2t is set
  const int du = NW == 2 ? ((t & 2) ? -64 : 64) : 0;
  // prefill x fragments by ldmatrix: lane l gives row (l & 7) + 8 ((l >> 3)
  // & 1) of the m-tile, chunk (l >> 4) of the k-step
  const int xr = RPW * wa + (lane & 7) + 8 * ((lane >> 3) & 1);
  const uint32_t x_off = xr * PBK;
  const int x_c = lane >> 4, x_s = xswz(xr);
  // decode x words: row 8 j + g, byte 4 t of the step's 32-row slice
  const uint32_t xd =
      smem_u32(smem + L.x) + g * L.x_pitch + 32 * KSW * wa + 4 * t;

  for (int it = 0; it < nsteps; ++it) {
    cp_wait<NST - 2>();
    __syncthreads();
    const int nx = it + NST - 1;
    if (nx < nsteps)
      load_step<SHAPE, VAR>(smem, nx % NST, a, k_lo + nx * BK, kend, m0, n0,
                            tid);
    cp_commit();
    const uint32_t sb = ring + (it % NST) * STAGE;
    if constexpr (DEC) {
#pragma unroll
      for (int ks = 0; ks < KSW; ++ks)
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          uint32_t r0[4], r1[4], a0[4], a1[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            r0[j] = lds32(sb + w_off[0][j] + w * du + ks * 32 * RB);
            r1[j] = lds32(sb + w_off[1][j] + w * du + ks * 32 * RB);
          }
          transpose4x4(r0, a0);
          transpose4x4(r1, a1);
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const uint32_t xa = xd + j * 8 * L.x_pitch + it * DBK + 32 * ks;
            const uint32_t v0 = lds32(xa), v1 = lds32(xa + 16);
            const uint32_t b0 = __funnelshift_r(v0, v0, 8 * t);
            const uint32_t b1 = __funnelshift_r(v1, v1, 8 * t);
            mma_s8(acc[w][0][j], a0[0], a0[1], a1[0], a1[1], b0, b1);
            mma_s8(acc[w][1][j], a0[2], a0[3], a1[2], a1[3], b0, b1);
          }
        }
    } else {
      if constexpr (QIN) {
        // this step's x tile into int8 (the tile was last read by the
        // step before, which every warp has left)
        qin_quantize_tile<XE, SAN>(smem + (it % NST) * STAGE, smem + L.x,
                                   s_xs, tid);
        __syncthreads();
      }
      const uint32_t xb = QIN ? smem_u32(smem + L.x) : sb;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t af[TA][4];
#pragma unroll
        for (int mt = 0; mt < TA; ++mt)
          ldsm_x4(af[mt], xb + x_off + mt * 16 * PBK +
                              16 * ((2 * ks + x_c) ^ x_s));
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          uint32_t r0[4], r1[4], b0[4], b1[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            r0[j] = lds32(sb + w_off[0][j] + w * du + ks * 32 * PBN);
            r1[j] = lds32(sb + w_off[1][j] + w * du + ks * 32 * PBN);
          }
          transpose4x4(r0, b0);
          transpose4x4(r1, b1);
#pragma unroll
          for (int mt = 0; mt < TA; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              mma_s8(acc[w][mt][nt], af[mt][0], af[mt][1], af[mt][2],
                     af[mt][3], b0[nt], b1[nt]);
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free

  if constexpr (DEC) {
    // the warps' K sums: red[w][wk][m][col] in the tile's own column order
    int* red = reinterpret_cast<int*>(smem);
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int tp = 0; tp < 2; ++tp)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int rho = g + 8 * (r >> 1);  // the m-tile's row
            const int col = 32 * wn + 4 * (rho & 7) + 2 * tp + (rho >> 3);
            const int m = 8 * j + 2 * t + (r & 1);
            red[((w * WK + wa) * MR + m) * DBN + col] = acc[w][tp][j][r];
          }
    __syncthreads();
    constexpr int PER = MR * DBN / I8_NT;  // outputs a thread
    constexpr int WS = WK * MR * DBN;      // the sums of one weight
    int tot[NW][PER];
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int e = w * WS + tid + I8_NT * i;
        tot[w][i] = red[e];
#pragma unroll
        for (int k = 1; k < WK; ++k) tot[w][i] += red[e + k * MR * DBN];
      }
    if (C > 1) {
      // each thread overwrites only sums it has read itself
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int i = 0; i < PER; ++i)
          red[w * MR * DBN + tid + I8_NT * i] = tot[w][i];
      cluster.sync();
      if (rank == 0)
        for (int r = 1; r < C; ++r) {
          const int* rem = cluster.map_shared_rank(red, r);
#pragma unroll
          for (int w = 0; w < NW; ++w)
#pragma unroll
            for (int i = 0; i < PER; ++i)
              tot[w][i] += rem[w * MR * DBN + tid + I8_NT * i];
        }
      cluster.sync();  // the other ranks' shared memory stays until read
      if (rank != 0) return;
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + I8_NT * i;
      const int m = e / DBN, gn = n0 + e % DBN;
      const bool valid = m < a.M && gn < a.N;
      const int64_t o = (int64_t)m * a.N + gn;
      if constexpr (EPI == EPI_ACC) {
        if (valid) static_cast<int*>(a.out)[o] = tot[0][i];
      } else {
        float y = 0.0f;
        if (valid) {
          y = i8_out<VAR, SAN>(a, s_xs, tot[0][i], tot[NW - 1][i], m, m,
                               gn);
          static_cast<float*>(a.out)[o] = y;
        }
        if constexpr (EPI == EPI_QOUT) {
          // a warp's 32 outputs lie in one row
          float mx = fabsf(y);
#pragma unroll
          for (int off = 16; off; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          if (lane == 0)
            atomicMax(reinterpret_cast<unsigned int*>(tail) + m,
                      __float_as_uint(mx));
        }
      }
    }
    if constexpr (EPI == EPI_QOUT)
      i8_requant(a, tail, 0, MR, 0, (int)gridDim.x / C, tid);
  } else {
    // the lane's coordinates; the gated tile at two blocks an SM reads them
    // again from %tid.x here rather than keep them live through the main
    // loop (which left ptxas 4 registers short: 16 bytes of spills)
    int ewa = wa, ewn = wn, eg = g, et = t;
    if constexpr (NW == 2) {
      uint32_t r;
      asm volatile("mov.u32 %0, %%tid.x;" : "=r"(r));
      ewa = (int)(r / 32) >> PWL;
      ewn = (int)(r / 32) & ((1 << PWL) - 1);
      eg = (int)(r % 32) >> 2;
      et = (int)r & 3;
    }
    // thread (g, t) of warp (wm, wn) holds, for m-tile mt and half h, row
    // RPW wm + 16 mt + g + 8 h at output columns 32 wn + 8 t .. + 7 of each
    // weight w: acc[w][mt][q][2h] at column + q and acc[w][mt][q][2h + 1]
    // at column + 4 + q (partial tile column 64 w + the output column)
    if (C > 1) {
      int* part = reinterpret_cast<int*>(smem);  // [PBM][PPITCH]
      if (rank != 0) {
#pragma unroll
        for (int w = 0; w < NW; ++w)
#pragma unroll
          for (int mt = 0; mt < TA; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              int4* p = reinterpret_cast<int4*>(
                  part + (RPW * ewa + 16 * mt + eg + 8 * h) * PPITCH + 64 * w +
                  32 * ewn + 8 * et);
              p[0] = make_int4(acc[w][mt][0][2 * h], acc[w][mt][1][2 * h],
                               acc[w][mt][2][2 * h], acc[w][mt][3][2 * h]);
              p[1] = make_int4(acc[w][mt][0][2 * h + 1],
                               acc[w][mt][1][2 * h + 1],
                               acc[w][mt][2][2 * h + 1],
                               acc[w][mt][3][2 * h + 1]);
            }
      }
      cluster.sync();
      if (rank == 0)
        for (int r = 1; r < C; ++r) {
          const int* rem = cluster.map_shared_rank(part, r);
#pragma unroll
          for (int w = 0; w < NW; ++w)
#pragma unroll
            for (int mt = 0; mt < TA; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int4* p = reinterpret_cast<const int4*>(
                    rem + (RPW * ewa + 16 * mt + eg + 8 * h) * PPITCH +
                    64 * w + 32 * ewn + 8 * et);
                const int4 u = p[0], v = p[1];
                acc[w][mt][0][2 * h] += u.x;
                acc[w][mt][1][2 * h] += u.y;
                acc[w][mt][2][2 * h] += u.z;
                acc[w][mt][3][2 * h] += u.w;
                acc[w][mt][0][2 * h + 1] += v.x;
                acc[w][mt][1][2 * h + 1] += v.y;
                acc[w][mt][2][2 * h + 1] += v.z;
                acc[w][mt][3][2 * h + 1] += v.w;
              }
        }
      cluster.sync();
      if (rank != 0) return;
    }
#pragma unroll
    for (int mt = 0; mt < TA; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lm = RPW * ewa + 16 * mt + eg + 8 * h;
        const int gm = m0 + lm;
        const int gn0 = n0 + 32 * ewn + 8 * et;
        int v[NW][8];
#pragma unroll
        for (int w = 0; w < NW; ++w)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            v[w][q] = acc[w][mt][q][2 * h];
            v[w][4 + q] = acc[w][mt][q][2 * h + 1];
          }
        const bool full = gm < a.M && gn0 + 8 <= a.N;
        const int64_t o = (int64_t)gm * a.N + gn0;
        if constexpr (EPI == EPI_ACC) {
          int* out = static_cast<int*>(a.out);
          if (full) {
            reinterpret_cast<int4*>(out + o)[0] =
                make_int4(v[0][0], v[0][1], v[0][2], v[0][3]);
            reinterpret_cast<int4*>(out + o)[1] =
                make_int4(v[0][4], v[0][5], v[0][6], v[0][7]);
          } else if (gm < a.M) {
#pragma unroll
            for (int q = 0; q < 8; ++q)
              if (gn0 + q < a.N) out[o + q] = v[0][q];
          }
        } else if constexpr (NW == 2) {
          // the gated pair in two halves of 4 columns, each stored before
          // the next is formed: fewer values live across the activation's
          // calls (the division's slow path) at two blocks an SM
          float* out = static_cast<float*>(a.out);
          float mx = 0.0f;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float y[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int c = 4 * hh + q;
              y[q] = 0.0f;
              if (gm < a.M && gn0 + c < a.N) {
                y[q] = i8_out<VAR, SAN>(a, s_xs, v[0][c], v[1][c], lm, gm,
                                        gn0 + c);
                mx = fmaxf(mx, fabsf(y[q]));
              }
            }
            if (full) {
              reinterpret_cast<float4*>(out + o)[hh] =
                  make_float4(y[0], y[1], y[2], y[3]);
            } else if (gm < a.M) {
#pragma unroll
              for (int q = 0; q < 4; ++q)
                if (gn0 + 4 * hh + q < a.N) out[o + 4 * hh + q] = y[q];
            }
          }
          if constexpr (EPI == EPI_QOUT) {
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            if (et == 0 && gm < a.M)
              atomicMax(reinterpret_cast<unsigned int*>(tail) + lm,
                        __float_as_uint(mx));
          }
        } else {
          float y[8];
          float mx = 0.0f;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            y[q] = 0.0f;
            if (gm < a.M && gn0 + q < a.N) {
              y[q] = i8_out<VAR, SAN>(a, s_xs, v[0][q], v[NW - 1][q], lm,
                                      gm, gn0 + q);
              mx = fmaxf(mx, fabsf(y[q]));
            }
          }
          float* out = static_cast<float*>(a.out);
          if (full) {
            reinterpret_cast<float4*>(out + o)[0] =
                make_float4(y[0], y[1], y[2], y[3]);
            reinterpret_cast<float4*>(out + o)[1] =
                make_float4(y[4], y[5], y[6], y[7]);
          } else if (gm < a.M) {
#pragma unroll
            for (int q = 0; q < 8; ++q)
              if (gn0 + q < a.N) out[o + q] = y[q];
          }
          if constexpr (EPI == EPI_QOUT) {
            // the row's 32 columns of this warp lie in its 4 t lanes
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            if (et == 0 && gm < a.M)
              atomicMax(reinterpret_cast<unsigned int*>(tail) + lm,
                        __float_as_uint(mx));
          }
        }
      }
    if constexpr (EPI == EPI_QOUT)
      i8_requant(a, tail, m0, PBM, (int)blockIdx.y, (int)gridDim.x / C, tid);
  }
}

// The dense GEMMs: two blocks an SM (128 registers), but one on the
// prefill tile with the requant or the int32 epilogue, which spill at 128,
// or with f32 x, whose ring leaves room for one.
template <int EPI, int SHAPE, int VAR>
__global__ void __launch_bounds__(
    I8_NT, SHAPE == PRE && (EPI != EPI_F32 || VAR == V_QF32) ? 1 : 2)
cim_gemm_i8_kernel(const I8Args a) {
  i8_body<EPI, SHAPE, VAR>(a);
}

// The degraded fallback of the dense GEMMs (f32 epilogue): every block
// leaves at once when the screen's flag (*gate) is 0 (passed); else the
// body on operands read through nan_to_num.  One block an SM: the
// sanitizing reads must not spill, and the path runs only on a fault.
template <int SHAPE, int VAR>
__global__ void __launch_bounds__(I8_NT, 1)
cim_gemm_i8_fallback_kernel(const I8Args a, const int* __restrict__ gate) {
  if (*gate == 0) return;
  i8_body<EPI_F32, SHAPE, VAR, true>(a);
}

// The grouped GEMMs, a block of an idle expert (count 0) where the
// epilogue gives zero accumulators +0 (the gated pair: act(+0) * (+0);
// kernel 7 without a bias: act(+0), the scales of the reference being
// positive): +0 in f32, or with the requant the code 0 and the row scale
// row_scale(0) (the row's |max| being 0), over the block's tile, stored
// by rank 0 of its cluster.
template <int EPI, int SHAPE, int VAR>
__device__ __forceinline__ void i8_idle(const I8Args& a) {
  constexpr int BN = SHAPE == PRE ? PBN / var_nw(VAR) : DBN;
  cg::cluster_group cluster = cg::this_cluster();
  if (cluster.block_rank() != 0) return;
  const int tile = (int)(blockIdx.x / cluster.num_blocks());
  const int n0 = tile * BN, m0 = SHAPE == PRE ? (int)blockIdx.y * PBM : 0;
  const int rows = min(SHAPE == PRE ? PBM : 8 * (SHAPE + 1), a.M - m0);
  const int c4 = min(BN, a.N - n0) / 4;  // N % 4 == 0
  for (int i = threadIdx.x; i < rows * c4; i += I8_NT) {
    const int64_t o = (int64_t)(m0 + i / c4) * a.N + n0 + 4 * (i % c4);
    if constexpr (EPI == EPI_QOUT)
      *reinterpret_cast<char4*>(a.q + o) = make_char4(0, 0, 0, 0);
    else
      *reinterpret_cast<float4*>(static_cast<float*>(a.out) + o) =
          make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  if constexpr (EPI == EPI_QOUT)
    if (tile == 0 && (int)threadIdx.x < rows)
      a.qs[m0 + threadIdx.x] = row_scale(0.0f);
}

// The grouped GEMMs: expert blockIdx.z of x [E, M, K] with xs [E, M], the
// weights [E, K, N] with their scales [E, N] (V_I8, kernel 7: one weight
// and an optional bias [E, N]; V_GATED, kernel 8: the gate and up
// weights), the output [E, M, N] (with the requant q [E, M, N], qs [E,
// M], amax [E * M] and one counter a row band and expert); counts [E] or
// null.  ``a`` holds expert 0's operands in the variant's fields.  Two
// blocks an SM on the decode tiles; one on the prefill tile, where the
// expert's operands leave the gated body no registers to spare at two.
template <int EPI, int SHAPE, int VAR, bool SAN>
__device__ __forceinline__ void i8_grouped(const I8Args& a,
                                           const int* __restrict__ counts) {
  const int e = (int)blockIdx.z;
  const int64_t kn = (int64_t)a.K * a.N, mn = (int64_t)a.M * a.N;
  I8Args b = a;
  b.x = a.x + e * (int64_t)a.M * a.K;
  b.xs = a.xs + (int64_t)e * a.M;
  b.w = a.w + e * kn;
  b.ws = a.ws + (int64_t)e * a.N;
  if constexpr (VAR == V_GATED) {
    b.bias = s_up(a) + (int64_t)e * a.N;
    b.res = w_up(a) + e * kn;
  } else if (a.bias != nullptr) {
    b.bias = a.bias + (int64_t)e * a.N;
  }
  b.out = static_cast<float*>(a.out) + e * mn;
  if constexpr (EPI == EPI_QOUT) {
    b.q = a.q + e * mn;
    b.qs = a.qs + (int64_t)e * a.M;
    b.amax = a.amax + (int64_t)e * a.M;
    b.arrive = a.arrive + (int64_t)e * gridDim.y;
  }
  if (counts != nullptr && counts[e] <= 0) {
    if (VAR == V_GATED || a.bias == nullptr) {
      i8_idle<EPI, SHAPE, VAR>(b);
      return;
    }
    // act(bias) and its requant: the body with no K step reads no x and
    // no weight byte and runs the epilogue on zero accumulators
    b.K = 0;
  }
  i8_body<EPI, SHAPE, VAR, SAN>(b);
}

template <int EPI, int SHAPE, int VAR>
__global__ void __launch_bounds__(I8_NT, SHAPE == PRE ? 1 : 2)
cim_gemm_i8_grouped_kernel(const I8Args a, const int* __restrict__ counts) {
  i8_grouped<EPI, SHAPE, VAR, false>(a, counts);
}

// The degraded fallback of the grouped GEMMs (f32 epilogue), gated as
// cim_gemm_i8_fallback_kernel; the skip list stays.
template <int SHAPE, int VAR>
__global__ void __launch_bounds__(I8_NT, 1)
cim_gemm_i8_grouped_fallback_kernel(const I8Args a,
                                    const int* __restrict__ counts,
                                    const int* __restrict__ gate) {
  if (*gate == 0) return;
  i8_grouped<EPI_F32, SHAPE, VAR, true>(a, counts);
}

#ifndef CIM_GEMM_FALLBACK
// The degraded mode's screen: flag[0] = 1 when any of x[0 .. n) (f32, in
// float4s when vec) is NaN or +-inf, else 0, in one launch.  Each block
// ORs its verdict into ws[0] and counts itself in ws[1]; the last block to
// arrive writes the flag, adds a trip to ws[2] (read by the host after a
// run) and leaves ws[0] and ws[1] zero for the next launch.
constexpr int SCREEN_NT = 256;
__global__ void __launch_bounds__(SCREEN_NT)
finite_screen_kernel(const float* __restrict__ x, int64_t n, int vec,
                     int* __restrict__ flag, unsigned int* ws) {
  bool bad = false;
  const int64_t stride = (int64_t)gridDim.x * SCREEN_NT;
  const int64_t i0 = (int64_t)blockIdx.x * SCREEN_NT + threadIdx.x;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (int64_t i = i0; i < n / 4; i += stride) {
      const float4 v = __ldg(x4 + i);
      bad |= nonfinite(v.x) || nonfinite(v.y) || nonfinite(v.z) ||
             nonfinite(v.w);
    }
  } else {
    for (int64_t i = i0; i < n; i += stride) {
      const float v = __ldg(x + i);
      bad |= nonfinite(v);
    }
  }
  bad = __syncthreads_or(bad);
  if (threadIdx.x != 0) return;
  if (bad) atomicOr(&ws[0], 1u);
  __threadfence();
  if (atomicAdd(&ws[1], 1u) != gridDim.x - 1) return;
  __threadfence();
  const unsigned int tripped = atomicExch(&ws[0], 0u);
  *flag = (int)tripped;
  if (tripped) atomicAdd(&ws[2], 1u);
  atomicExch(&ws[1], 0u);
}
#endif  // CIM_GEMM_FALLBACK

// A launch of ``grid`` blocks of ``threads`` in clusters of C along x.
template <typename... P, typename... A>
cudaError_t launch_clustered(void (*kernel)(P...), dim3 grid, int threads,
                             int C, int smem, cudaStream_t st, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The body's grid: column tiles x C, row tiles (prefill), experts.
template <int SHAPE, int VAR>
dim3 i8_grid(const I8Args& a, int C, int E) {
  constexpr int BN = SHAPE == PRE ? PBN / var_nw(VAR) : DBN;
  return dim3((a.N + BN - 1) / BN * C,
              SHAPE == PRE ? (a.M + PBM - 1) / PBM : 1, E);
}

template <int EPI, int SHAPE, int VAR>
cudaError_t i8_launch(const I8Args& a, int C, int smem, cudaStream_t st) {
  return launch_clustered(cim_gemm_i8_kernel<EPI, SHAPE, VAR>,
                          i8_grid<SHAPE, VAR>(a, C, 1), I8_NT, C, smem, st,
                          a);
}

template <int EPI, int VAR>
cudaError_t i8_run(const I8Args& a, int shape, int C, int smem,
                   cudaStream_t st) {
  if (shape == DEC8) return i8_launch<EPI, DEC8, VAR>(a, C, smem, st);
  if (shape == DEC16) return i8_launch<EPI, DEC16, VAR>(a, C, smem, st);
  return i8_launch<EPI, PRE, VAR>(a, C, smem, st);
}

#ifdef CIM_GEMM_FALLBACK
// the degraded fallback (gate: the screen's flag)
template <int VAR>
cudaError_t i8_fallback_run(const I8Args& a, int shape, int C, int smem,
                            cudaStream_t st, const int* gate) {
  if (shape == DEC8)
    return launch_clustered(cim_gemm_i8_fallback_kernel<DEC8, VAR>,
                            i8_grid<DEC8, VAR>(a, C, 1), I8_NT, C, smem, st,
                            a, gate);
  if (shape == DEC16)
    return launch_clustered(cim_gemm_i8_fallback_kernel<DEC16, VAR>,
                            i8_grid<DEC16, VAR>(a, C, 1), I8_NT, C, smem, st,
                            a, gate);
  return launch_clustered(cim_gemm_i8_fallback_kernel<PRE, VAR>,
                          i8_grid<PRE, VAR>(a, C, 1), I8_NT, C, smem, st, a,
                          gate);
}

template <int VAR>
cudaError_t i8_grouped_fallback_run(const I8Args& a, const int* counts,
                                    int E, int shape, int C, int smem,
                                    cudaStream_t st, const int* gate) {
  if (shape == DEC8)
    return launch_clustered(cim_gemm_i8_grouped_fallback_kernel<DEC8, VAR>,
                            i8_grid<DEC8, VAR>(a, C, E), I8_NT, C, smem, st,
                            a, counts, gate);
  if (shape == DEC16)
    return launch_clustered(cim_gemm_i8_grouped_fallback_kernel<DEC16, VAR>,
                            i8_grid<DEC16, VAR>(a, C, E), I8_NT, C, smem, st,
                            a, counts, gate);
  return launch_clustered(cim_gemm_i8_grouped_fallback_kernel<PRE, VAR>,
                          i8_grid<PRE, VAR>(a, C, E), I8_NT, C, smem, st, a,
                          counts, gate);
}
#endif  // CIM_GEMM_FALLBACK

template <int EPI, int VAR>
cudaError_t i8_grouped_run(const I8Args& a, const int* counts, int E,
                           int shape, int C, int smem, cudaStream_t st) {
  if (shape == DEC8)
    return launch_clustered(cim_gemm_i8_grouped_kernel<EPI, DEC8, VAR>,
                            i8_grid<DEC8, VAR>(a, C, E), I8_NT, C, smem, st,
                            a, counts);
  if (shape == DEC16)
    return launch_clustered(cim_gemm_i8_grouped_kernel<EPI, DEC16, VAR>,
                            i8_grid<DEC16, VAR>(a, C, E), I8_NT, C, smem, st,
                            a, counts);
  return launch_clustered(cim_gemm_i8_grouped_kernel<EPI, PRE, VAR>,
                          i8_grid<PRE, VAR>(a, C, E), I8_NT, C, smem, st, a,
                          counts);
}

template <typename... P>
cudaError_t opt_in_smem(void (*kernel)(P...)) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, I8_MAX_SMEM);
}

#ifdef CIM_GEMM_FALLBACK
template <int VAR>
cudaError_t i8_opt_in_fallback() {
  cudaError_t e = opt_in_smem(cim_gemm_i8_fallback_kernel<DEC8, VAR>);
  if (e == cudaSuccess)
    e = opt_in_smem(cim_gemm_i8_fallback_kernel<DEC16, VAR>);
  if (e == cudaSuccess)
    e = opt_in_smem(cim_gemm_i8_fallback_kernel<PRE, VAR>);
  if constexpr (VAR == V_I8 || VAR == V_GATED) {
    if (e == cudaSuccess)
      e = opt_in_smem(cim_gemm_i8_grouped_fallback_kernel<DEC8, VAR>);
    if (e == cudaSuccess)
      e = opt_in_smem(cim_gemm_i8_grouped_fallback_kernel<DEC16, VAR>);
    if (e == cudaSuccess)
      e = opt_in_smem(cim_gemm_i8_grouped_fallback_kernel<PRE, VAR>);
  }
  return e;
}
#endif  // CIM_GEMM_FALLBACK

template <int EPI, int VAR>
cudaError_t i8_opt_in_one() {
  cudaError_t e = opt_in_smem(cim_gemm_i8_kernel<EPI, DEC8, VAR>);
  if (e == cudaSuccess) e = opt_in_smem(cim_gemm_i8_kernel<EPI, DEC16, VAR>);
  if (e == cudaSuccess) e = opt_in_smem(cim_gemm_i8_kernel<EPI, PRE, VAR>);
  if constexpr ((VAR == V_I8 || VAR == V_GATED) && EPI != EPI_ACC) {
    if (e == cudaSuccess)
      e = opt_in_smem(cim_gemm_i8_grouped_kernel<EPI, DEC8, VAR>);
    if (e == cudaSuccess)
      e = opt_in_smem(cim_gemm_i8_grouped_kernel<EPI, DEC16, VAR>);
    if (e == cudaSuccess)
      e = opt_in_smem(cim_gemm_i8_grouped_kernel<EPI, PRE, VAR>);
  }
  return e;
}

// The opt-in above 48 KB, for every instantiation of this library at the
// largest size, once per device at its first launch: no later launch
// (inside a graph capture) needs it.
cudaError_t i8_opt_in() {
  static bool granted[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || granted[dev % 64]) return e;
#ifdef CIM_GEMM_FALLBACK
  e = i8_opt_in_fallback<V_I8>();
  if (e == cudaSuccess) e = i8_opt_in_fallback<V_GATED>();
  if (e == cudaSuccess) e = i8_opt_in_fallback<V_QF32>();
  if (e == cudaSuccess) e = i8_opt_in_fallback<V_QBF16>();
#else
  e = i8_opt_in_one<EPI_F32, V_I8>();
  if (e == cudaSuccess) e = i8_opt_in_one<EPI_QOUT, V_I8>();
  if (e == cudaSuccess) e = i8_opt_in_one<EPI_ACC, V_I8>();
  if (e == cudaSuccess) e = i8_opt_in_one<EPI_F32, V_GATED>();
  if (e == cudaSuccess) e = i8_opt_in_one<EPI_QOUT, V_GATED>();
  if (e == cudaSuccess) e = i8_opt_in_one<EPI_F32, V_QF32>();
  if (e == cudaSuccess) e = i8_opt_in_one<EPI_F32, V_QBF16>();
#endif
  if (e == cudaSuccess) granted[dev % 64] = true;
  return e;
}

// The body's argument struct: the gated variant carries the up weight in
// res's field and its scales in bias's (see I8Args).
I8Args i8_args(const void* x, const void* xs, const void* w, const void* ws,
               const void* w2, const void* ws2, const void* bias,
               const void* res, int res_kind, int act, void* out, void* q,
               void* qs, void* amax, void* arrive, int M, int K, int N,
               int var) {
  I8Args a;
  a.x = static_cast<const int8_t*>(x);
  a.xs = static_cast<const float*>(xs);
  a.w = static_cast<const int8_t*>(w);
  a.ws = static_cast<const float*>(ws);
  a.bias = static_cast<const float*>(var == V_GATED ? ws2 : bias);
  a.res = var == V_GATED ? w2 : res;
  a.res_kind = res_kind;
  a.act = act;
  a.out = out;
  a.q = static_cast<int8_t*>(q);
  a.qs = static_cast<float*>(qs);
  a.amax = static_cast<unsigned int*>(amax);
  a.arrive = static_cast<int*>(arrive);
  a.M = M;
  a.K = K;
  a.N = N;
  a.x16 = (int64_t)K * var_xe(var) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.w16 = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(w2) % 16 == 0;
  return a;
}

}  // namespace

// The entry points of the two libraries built from this source: this
// file (cim_gemm) launches the kernels with a null ``gate``, and
// cim_gemm_fallback.cu, which defines CIM_GEMM_FALLBACK and includes it,
// the degraded fallback's gated instantiations with a given one (its
// entry names end in _fallback).  Each library instantiates only its own
// kernels, so the two build in parallel and the kernels with a null gate
// are the code they were.
#ifdef CIM_GEMM_FALLBACK
#define CIM_ENTRY(name) name##_fallback
#else
#define CIM_ENTRY(name) name
#endif

// x_kind / res_kind: 1 = float32, 2 = bfloat16 (res_kind 0 = none).
// act: 0 none, 1 gelu (tanh), 2 silu, 3 relu.
// Each entry point returns cudaGetLastError() after its launch.
extern "C" {

// The row quantizer under the wrapper's plan (rowquant_plan): one block
// of ``threads`` a row, 16-byte units when ``vec`` (K x_bytes % 16 == 0,
// x 16-byte aligned).  With ``gate`` (the screen's int32 flag on the
// device) the degraded fallback: nothing when the flag is 0, else the
// rows of nan_to_num(x).
int CIM_ENTRY(cim_quantize_rows_int8)(const void* x, int x_kind, void* q,
                                      void* scale, int M, int K, int threads,
                                      int vec, const void* gate,
                                      void* stream) {
  const int xe = x_kind == 1 ? 4 : 2;
  if ((x_kind != 1 && x_kind != 2) || M < 1 || K < 1 || threads < 32 ||
      threads % 32 || threads > RQ_MAX_NT ||
      (vec && ((int64_t)K * xe % 16 ||
               reinterpret_cast<uintptr_t>(x) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* q8 = static_cast<int8_t*>(q);
  float* s = static_cast<float*>(scale);
#ifdef CIM_GEMM_FALLBACK
  const int* g = static_cast<const int*>(gate);
  if (g == nullptr) return (int)cudaErrorInvalidValue;
  if (xe == 4 && vec)
    rowquant_fallback_kernel<4, true><<<M, threads, 0, st>>>(x, q8, s, K, g);
  else if (xe == 4)
    rowquant_fallback_kernel<4, false><<<M, threads, 0, st>>>(x, q8, s, K, g);
  else if (vec)
    rowquant_fallback_kernel<2, true><<<M, threads, 0, st>>>(x, q8, s, K, g);
  else
    rowquant_fallback_kernel<2, false><<<M, threads, 0, st>>>(x, q8, s, K, g);
#else
  if (gate != nullptr) return (int)cudaErrorInvalidValue;
  if (xe == 4) {
    if (vec) rowquant_kernel<4, true><<<M, threads, 0, st>>>(x, q8, s, K);
    else rowquant_kernel<4, false><<<M, threads, 0, st>>>(x, q8, s, K);
  } else {
    if (vec) rowquant_kernel<2, true><<<M, threads, 0, st>>>(x, q8, s, K);
    else rowquant_kernel<2, false><<<M, threads, 0, st>>>(x, q8, s, K);
  }
#endif
  return (int)cudaGetLastError();
}

// The dense GEMMs on the tensor cores, x [M, K] @ w [K, N] int8, by
// variant (var): 0 int8 x with xs [M] (kernels 3 and 6), 1 the same with
// the gated pair w / w2 and ws / ws2 [N] (kernel 4), 2 or 3 f32 or bf16 x
// quantized in the kernel (kernel 2).  The f32 epilogue (q null; ws / bias
// [N], res [M, N] as above), the requant epilogue (variants 0 and 1: q
// [M, N], qs [M], amax [M] and arrive [one a row band] given, zeros) or,
// with acc (variant 0), the exact int32 sum in out [M, N].  shape (0/1
// decode at 8/16 rows, 2 prefill), cluster and smem are the wrapper's plan
// (gemm_plan); N % 4 == 0.  With ``gate`` (the screen's int32 flag on the
// device; f32 epilogue only) the degraded fallback: every block leaves
// when the flag is 0, else the body on operands read through nan_to_num.
int CIM_ENTRY(cim_gemm_i8_launch)(const void* x, const void* xs,
                                  const void* w, const void* ws,
                                  const void* w2, const void* ws2,
                                  const void* bias, const void* res,
                                  int res_kind, int act, int acc, void* out,
                                  void* q, void* qs, void* amax,
                                  void* arrive, int M, int K, int N, int var,
                                  int shape, int cluster, int smem,
                                  const void* gate, void* stream) {
  const bool qin = var_qin(var);
  if (var < V_I8 || var > V_QBF16 || shape < DEC8 || shape > PRE || M < 1 ||
      K < 1 || N < 1 || N % 4 || (shape != PRE && M > 8 * (shape + 1)) ||
      cluster < 1 || cluster > 8 || (var == V_GATED) != (w2 != nullptr) ||
      (acc && var != V_I8) || (q != nullptr && (acc || qin)) ||
      smem < i8_layout(shape, var, K, cluster).total || smem > I8_MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  if (var == V_GATED && (bias != nullptr || res != nullptr || res_kind))
    return (int)cudaErrorInvalidValue;
#ifdef CIM_GEMM_FALLBACK
  if (gate == nullptr || acc || q != nullptr)
    return (int)cudaErrorInvalidValue;
#else
  if (gate != nullptr) return (int)cudaErrorInvalidValue;
#endif
  const I8Args a = i8_args(x, xs, w, ws, w2, ws2, bias, res, res_kind, act,
                           out, q, qs, amax, arrive, M, K, N, var);
  cudaError_t e = i8_opt_in();
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#ifdef CIM_GEMM_FALLBACK
  const int* g = static_cast<const int*>(gate);
  if (var == V_GATED)
    e = i8_fallback_run<V_GATED>(a, shape, cluster, smem, st, g);
  else if (var == V_QF32)
    e = i8_fallback_run<V_QF32>(a, shape, cluster, smem, st, g);
  else if (var == V_QBF16)
    e = i8_fallback_run<V_QBF16>(a, shape, cluster, smem, st, g);
  else
    e = i8_fallback_run<V_I8>(a, shape, cluster, smem, st, g);
#else
  if (acc)
    e = i8_run<EPI_ACC, V_I8>(a, shape, cluster, smem, st);
  else if (q != nullptr && var == V_GATED)
    e = i8_run<EPI_QOUT, V_GATED>(a, shape, cluster, smem, st);
  else if (q != nullptr)
    e = i8_run<EPI_QOUT, V_I8>(a, shape, cluster, smem, st);
  else if (var == V_GATED)
    e = i8_run<EPI_F32, V_GATED>(a, shape, cluster, smem, st);
  else if (var == V_QF32)
    e = i8_run<EPI_F32, V_QF32>(a, shape, cluster, smem, st);
  else if (var == V_QBF16)
    e = i8_run<EPI_F32, V_QBF16>(a, shape, cluster, smem, st);
  else
    e = i8_run<EPI_F32, V_I8>(a, shape, cluster, smem, st);
#endif
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The grouped GEMMs on the tensor-core body: x [E, M, K] int8 with xs [E,
// M]; by variant (var) 0 (kernel 7) one weight w [E, K, N] with ws [E, N]
// and an optional bias [E, N], 1 (kernel 8) the gate and up weights w /
// w2 [E, K, N] with ws / ws2 [E, N] and no bias; counts [E] int32 or null
// (no skip list); the f32 output out [E, M, N] (q null), or the requant
// (q [E, M, N], qs [E, M], amax [E M] and arrive [E x row bands] given,
// zeros; out the scratch).  shape, cluster and smem are the wrapper's
// plan (grouped_plan); N % 4 == 0.  ``gate`` as in cim_gemm_i8_launch (f32
// output only).
int CIM_ENTRY(cim_grouped_i8_launch)(const void* x, const void* xs,
                                     const void* w, const void* ws,
                                     const void* w2, const void* ws2,
                                     const void* bias, const void* counts,
                                     int act, void* out, void* q, void* qs,
                                     void* amax, void* arrive, int E, int M,
                                     int K, int N, int var, int shape,
                                     int cluster, int smem, const void* gate,
                                     void* stream) {
  if ((var != V_I8 && var != V_GATED) || E < 1 || E > 65535 ||
      shape < DEC8 || shape > PRE || M < 1 || K < 1 || N < 1 || N % 4 ||
      (shape != PRE && M > 8 * (shape + 1)) || cluster < 1 || cluster > 8 ||
      (var == V_GATED) != (w2 != nullptr) ||
      (var == V_GATED && bias != nullptr) ||
      smem < i8_layout(shape, var, K, cluster).total || smem > I8_MAX_SMEM)
    return (int)cudaErrorInvalidValue;
#ifdef CIM_GEMM_FALLBACK
  if (gate == nullptr || q != nullptr) return (int)cudaErrorInvalidValue;
#else
  if (gate != nullptr) return (int)cudaErrorInvalidValue;
#endif
  const I8Args a = i8_args(x, xs, w, ws, w2, ws2, bias, nullptr, 0, act, out,
                           q, qs, amax, arrive, M, K, N, var);
  cudaError_t e = i8_opt_in();
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(counts);
#ifdef CIM_GEMM_FALLBACK
  const int* g = static_cast<const int*>(gate);
  e = var == V_GATED
          ? i8_grouped_fallback_run<V_GATED>(a, c, E, shape, cluster, smem,
                                             st, g)
          : i8_grouped_fallback_run<V_I8>(a, c, E, shape, cluster, smem, st,
                                          g);
#else
  if (var == V_GATED)
    e = q != nullptr
            ? i8_grouped_run<EPI_QOUT, V_GATED>(a, c, E, shape, cluster,
                                                smem, st)
            : i8_grouped_run<EPI_F32, V_GATED>(a, c, E, shape, cluster, smem,
                                               st);
  else
    e = q != nullptr
            ? i8_grouped_run<EPI_QOUT, V_I8>(a, c, E, shape, cluster, smem,
                                             st)
            : i8_grouped_run<EPI_F32, V_I8>(a, c, E, shape, cluster, smem,
                                            st);
#endif
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

#ifdef CIM_GEMM_FALLBACK
const char* cim_gemm_fallback_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
#else
// The degraded mode's screen over x [n] f32 (n >= 1): flag [1] int32 gets
// 1 when any value is NaN or +-inf, else 0.  ws: 3 unsigned words on the
// device, zero before the first launch (every launch leaves ws[0] and
// ws[1] zero); ws[2] counts the screens that tripped.
int cim_finite_screen(const void* x, int64_t n, void* flag, void* ws,
                      void* stream) {
  if (n < 1 || flag == nullptr || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  const int vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int64_t units = vec ? n / 4 : n;
  // about 8 units a thread, at most 4 blocks an SM
  const int64_t want = (units + 8 * SCREEN_NT - 1) / (8 * SCREEN_NT);
  const int blocks = (int)(want < 528 ? want : 528);
  finite_screen_kernel<<<blocks, SCREEN_NT, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, vec, static_cast<int*>(flag),
      static_cast<unsigned int*>(ws));
  return (int)cudaGetLastError();
}

// The dynamic shared-memory bytes of a block of that plan (i8_layout).
int cim_gemm_i8_smem_bytes(int shape, int var, int K, int cluster) {
  return i8_layout(shape, var, K, cluster).total;
}

const char* cim_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
#endif  // CIM_GEMM_FALLBACK

}  // extern "C"
