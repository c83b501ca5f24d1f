// Shared helpers of the port's hand-written kernels (plain C interface,
// loaded with ctypes; see kernels/build.py).
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

// Explicitly fused multiply-add with one rounding: the accumulation chain
// of every kernel is written with it, so it never depends on what the
// compiler chooses to contract.
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

// a·y + b·w − z with each product rounded, then the two sums in order:
// the rounding of the reference's epilogue 2a·y + 2b·w1 − w2 on the CPU.
// The _rn intrinsics are never contracted into an FMA by the compiler.
__device__ __forceinline__ double axpby_sub(double a, double y, double b,
                                            double w, double z) {
  return __dsub_rn(__dadd_rn(__dmul_rn(a, y), __dmul_rn(b, w)), z);
}
__device__ __forceinline__ float axpby_sub(float a, float y, float b, float w,
                                           float z) {
  return __fsub_rn(__fadd_rn(__fmul_rn(a, y), __fmul_rn(b, w)), z);
}

// Thread block for an [R, nb] output: threadIdx.x runs along the vector
// block (neighbouring threads read neighbouring addresses of a row-major
// x), threadIdx.y along rows; one CTA holds 256 threads.
inline dim3 row_block(long long nb) {
  int bx = nb >= 128 ? 128 : (nb >= 32 ? int((nb + 31) / 32 * 32) : int(nb));
  if (bx < 1) bx = 1;
  int by = 256 / bx;
  return dim3(bx, by < 1 ? 1 : by);
}

// Output columns each thread keeps in registers (columns j, j + bx, ...):
// one load of a row's index/value then feeds NJ independent gathers of x,
// so their latencies overlap instead of queueing one behind another.
inline int cols_per_thread(long long nb, dim3 block) {
  return nb > 2LL * block.x ? 4 : (nb > block.x ? 2 : 1);
}

inline dim3 row_grid(long long R, dim3 block) {
  return dim3((unsigned)((R + block.y - 1) / block.y));
}

}  // namespace repro_torch
