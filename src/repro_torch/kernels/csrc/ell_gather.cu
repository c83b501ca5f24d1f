// ELL SpMMV with a threaded accumulator: y = y0 + A·x.
//
// Replaces: src/repro/kernels/ell_gather.py::ell_gather_spmv (Pallas TPU
// tile kernel, body _kernel). The TPU kernel re-buckets the ELL block into
// (row block x column block) tiles (build_tiles) so each gather stays in
// VMEM; Hopper has no such limit: gathers go through the 50 MB L2, so this
// kernel reads the plain [R, W] ELL block directly.
//
// Bound on an H100 SXM: memory. At Hubbard(12,6), n_b = 512, fp64 the
// function must move x (3.50 GB) + ELL (0.13 GB at 13 entries a row, more
// with the padding to W) + y (3.50 GB) ≈ 7.1 GB, which takes ≈ 2.1 ms at
// 3.35 TB/s; its 2·nnz·n_b ≈ 1.1e10 fp64 operations take 0.3 ms at
// 34 TFLOP/s.
//
// Design: one CTA owns a block of rows; its threads run along n_b, so the
// gathered row x[c, :] of each slot is one coalesced read, and the row's
// column index and value are the same address for every thread of the
// row (a broadcast). Each thread keeps up to 4 output columns in
// registers, so one load of a slot's index and value feeds 4 independent
// gathers whose latencies overlap (the first version, one column at a
// time, was latency-bound: 10.8 ms at n_b = 512 against a 2.1 ms bound,
// measured by chip_smoke.py on an H100). Per output element the slots are
// accumulated in slot order with an explicit fma, starting from y0 (or 0):
// the same chain of
// single roundings as the reference's scan, so fp64 results can equal the
// CPU reference bit for bit. A slot whose value is 0 (ELL padding, or an
// unstored entry) is skipped without loading x: fma(0, x, acc) == acc for
// every finite x, so only the stored entries cost traffic. The ragged edge
// (R and n_b of any size, n_b = 1 for Lanczos included) is masked here.
#include "common.cuh"

namespace repro_torch {

template <typename T, int NJ>
__global__ void ell_gather_kernel(const int* __restrict__ cols,
                                  const T* __restrict__ vals,
                                  const T* __restrict__ x,
                                  const T* __restrict__ y0,
                                  T* __restrict__ y, long long R, int W,
                                  long long nb) {
  const long long r = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (r >= R) return;
  const int* cr = cols + r * W;
  const T* vr = vals + r * W;
  const long long bx = blockDim.x;
  for (long long j0 = threadIdx.x; j0 < nb; j0 += NJ * bx) {
    T acc[NJ];
#pragma unroll
    for (int k = 0; k < NJ; ++k) {
      const long long j = j0 + k * bx;
      acc[k] = (y0 != nullptr && j < nb) ? y0[r * nb + j] : T(0);
    }
    for (int w = 0; w < W; ++w) {
      const T v = vr[w];
      if (v == T(0)) continue;
      const T* xr = x + (long long)cr[w] * nb;
#pragma unroll
      for (int k = 0; k < NJ; ++k) {
        const long long j = j0 + k * bx;
        if (j < nb) acc[k] = fma_rn(v, xr[j], acc[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < NJ; ++k) {
      const long long j = j0 + k * bx;
      if (j < nb) y[r * nb + j] = acc[k];
    }
  }
}

template <typename T, int NJ>
static void launch_nj(const void* cols, const void* vals, const void* x,
                      const void* y0, void* y, long long R, long long W,
                      long long nb, dim3 block, cudaStream_t stream) {
  ell_gather_kernel<T, NJ><<<row_grid(R, block), block, 0, stream>>>(
      static_cast<const int*>(cols), static_cast<const T*>(vals),
      static_cast<const T*>(x), static_cast<const T*>(y0), static_cast<T*>(y),
      R, (int)W, nb);
}

template <typename T>
static int launch_ell_gather(const void* cols, const void* vals, const void* x,
                             const void* y0, void* y, long long R, long long W,
                             long long nb, void* stream) {
  if (R > 0 && nb > 0) {
    const dim3 block = row_block(nb);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (cols_per_thread(nb, block)) {
      case 4: launch_nj<T, 4>(cols, vals, x, y0, y, R, W, nb, block, s); break;
      case 2: launch_nj<T, 2>(cols, vals, x, y0, y, R, W, nb, block, s); break;
      default: launch_nj<T, 1>(cols, vals, x, y0, y, R, W, nb, block, s);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

extern "C" int ell_gather_f64(const void* cols, const void* vals, const void* x,
                              const void* y0, void* y, long long R, long long W,
                              long long nb, void* stream) {
  return repro_torch::launch_ell_gather<double>(cols, vals, x, y0, y, R, W, nb,
                                                stream);
}

extern "C" int ell_gather_f32(const void* cols, const void* vals, const void* x,
                              const void* y0, void* y, long long R, long long W,
                              long long nb, void* stream) {
  return repro_torch::launch_ell_gather<float>(cols, vals, x, y0, y, R, W, nb,
                                               stream);
}
