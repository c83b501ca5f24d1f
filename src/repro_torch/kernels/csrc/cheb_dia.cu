// Fused Chebyshev step of a DIA operator:
//   y = 2a·(Σ_d dvals[d, i]·x[i + off_d]) + 2b·w1 − w2.
//
// Replaces: src/repro/kernels/cheb_dia.py::cheb_dia (Pallas TPU kernel,
// body _kernel). On the TPU an unaligned offset is assembled from two
// aligned VMEM tiles; on Hopper a shifted row of x is an ordinary
// coalesced load, so the grid needs no diagonal axis and no scratch.
//
// Bound on an H100 SXM: memory. At Hubbard(12,6), n_b = 512, fp64 the
// function must move x = w1 (3.50 GB) + w2 (3.50 GB) + y (3.50 GB) +
// dvals (61 diagonals, 0.42 GB) ≈ 10.9 GB, which takes ≈ 3.3 ms at
// 3.35 TB/s; the arithmetic is far below the fp64 peak.
//
// Design: one CTA owns a block of rows, its threads run along n_b. For
// each output element the diagonals are visited in ascending offset order
// (= ascending column = the ELL slot order of the same operator), each a
// shifted load of x with no gather, accumulated with an explicit fma;
// rows whose shifted index leaves [0, Rx) are masked. A diagonal with no
// entry in this row (dvals == 0) is skipped without loading x, which is
// bit-neutral for finite x and keeps the traffic at the stored entries
// although the DIA form stores every diagonal for every row. Each thread
// keeps up to 4 output columns in registers, so one diagonal value feeds 4
// independent shifted loads of x, and the CTA's rows of dvals are staged
// in shared memory with all their loads in flight at once, so the scan
// over the 61 diagonals waits on no chain of global loads. (The first
// version, one column at a time with dvals read from global memory, took
// 27.9 ms at n_b = 512 against a 3.3 ms bound; with the 4 columns alone,
// 18.3 ms; both measured by chip_smoke.py on an H100.) w1 and w2
// are read once, in the epilogue 2a·acc + 2b·w1 − w2, rounded as the
// reference's is on the CPU (no FMA there): κ = 5.
#include "common.cuh"

namespace repro_torch {

constexpr int kMaxDiags = 64;  // DIA_MAX_DIAGS of kernels/ops.py

struct DiaOffsets {
  int n;
  int off[kMaxDiags];
};

template <typename T, int NJ>
__global__ void cheb_dia_kernel(const DiaOffsets offs,
                                const T* __restrict__ dvals,
                                const T* __restrict__ x,
                                const T* __restrict__ w1,
                                const T* __restrict__ w2, T* __restrict__ y,
                                long long R, long long Rx, long long nb, T a2,
                                T b2) {
  // stage this CTA's rows of dvals in shared memory, all loads in flight
  // at once, so the scan over the diagonals below waits on no global load
  extern __shared__ __align__(16) unsigned char smem[];
  T* sdv = reinterpret_cast<T*>(smem) + threadIdx.y * offs.n;
  const long long r = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  for (int d = threadIdx.x; d < offs.n; d += blockDim.x)
    sdv[d] = r < R ? dvals[(long long)d * R + r] : T(0);
  __syncthreads();
  if (r >= R) return;
  const long long bx = blockDim.x;
  for (long long j0 = threadIdx.x; j0 < nb; j0 += NJ * bx) {
    T acc[NJ];
#pragma unroll
    for (int k = 0; k < NJ; ++k) acc[k] = T(0);
    for (int d = 0; d < offs.n; ++d) {
      const long long i = r + offs.off[d];
      if (i < 0 || i >= Rx) continue;
      const T v = sdv[d];
      if (v == T(0)) continue;
      const T* xr = x + i * nb;
#pragma unroll
      for (int k = 0; k < NJ; ++k) {
        const long long j = j0 + k * bx;
        if (j < nb) acc[k] = fma_rn(v, xr[j], acc[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < NJ; ++k) {
      const long long j = j0 + k * bx;
      if (j < nb) {
        const long long e = r * nb + j;
        y[e] = axpby_sub(a2, acc[k], b2, w1[e], w2[e]);
      }
    }
  }
}

template <typename T, int NJ>
static void launch_nj(const DiaOffsets& offs, const void* dvals, const void* x,
                      const void* w1, const void* w2, void* y, long long R,
                      long long Rx, long long nb, double alpha, double beta,
                      dim3 block, cudaStream_t stream) {
  const size_t smem = sizeof(T) * offs.n * block.y;
  cheb_dia_kernel<T, NJ><<<row_grid(R, block), block, smem, stream>>>(
      offs, static_cast<const T*>(dvals), static_cast<const T*>(x),
      static_cast<const T*>(w1), static_cast<const T*>(w2),
      static_cast<T*>(y), R, Rx, nb, T(2.0 * T(alpha)), T(2.0 * T(beta)));
}

template <typename T>
static int launch_cheb_dia(const int* offsets, int n_diag, const void* dvals,
                           const void* x, const void* w1, const void* w2,
                           void* y, long long R, long long Rx, long long nb,
                           double alpha, double beta, void* stream) {
  if (n_diag < 0 || n_diag > kMaxDiags) return (int)cudaErrorInvalidValue;
  DiaOffsets offs;
  offs.n = n_diag;
  for (int d = 0; d < n_diag; ++d) offs.off[d] = offsets[d];
  if (R > 0 && nb > 0) {
    dim3 block = row_block(nb);
    // the staged dvals rows stay within the default 48 KB of shared memory
    while (block.y > 1 && sizeof(T) * n_diag * block.y > 48 * 1024)
      block.y /= 2;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (cols_per_thread(nb, block)) {
      case 4:
        launch_nj<T, 4>(offs, dvals, x, w1, w2, y, R, Rx, nb, alpha, beta,
                        block, s);
        break;
      case 2:
        launch_nj<T, 2>(offs, dvals, x, w1, w2, y, R, Rx, nb, alpha, beta,
                        block, s);
        break;
      default:
        launch_nj<T, 1>(offs, dvals, x, w1, w2, y, R, Rx, nb, alpha, beta,
                        block, s);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// offsets: host array of n_diag ascending ints (copied into the launch).
extern "C" int cheb_dia_f64(const int* offsets, int n_diag, const void* dvals,
                            const void* x, const void* w1, const void* w2,
                            void* y, long long R, long long Rx, long long nb,
                            double alpha, double beta, void* stream) {
  return repro_torch::launch_cheb_dia<double>(offsets, n_diag, dvals, x, w1, w2,
                                              y, R, Rx, nb, alpha, beta, stream);
}

extern "C" int cheb_dia_f32(const int* offsets, int n_diag, const void* dvals,
                            const void* x, const void* w1, const void* w2,
                            void* y, long long R, long long Rx, long long nb,
                            double alpha, double beta, void* stream) {
  return repro_torch::launch_cheb_dia<float>(offsets, n_diag, dvals, x, w1, w2,
                                             y, R, Rx, nb, alpha, beta, stream);
}
