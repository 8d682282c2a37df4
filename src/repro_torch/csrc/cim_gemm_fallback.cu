// The degraded mode's gated fallback of kernels 1, 2, 3, 4, 6, 7 and 8:
// the gated instantiations of csrc/cim_gemm.cu (rowquant_fallback_kernel,
// cim_gemm_i8_fallback_kernel, cim_gemm_i8_acc_fallback_kernel (kernel 6,
// a row-parallel partial under tensor parallelism),
// cim_gemm_i8_grouped_fallback_kernel; see
// the note there), built into a library of their own so that they compile
// in parallel with the ungated kernels.  Entry points:
// cim_quantize_rows_int8_fallback, cim_gemm_i8_launch_fallback and
// cim_grouped_i8_launch_fallback, the ungated entries' arguments with a
// non-null gate.
#define CIM_GEMM_FALLBACK 1
#include "cim_gemm.cu"
