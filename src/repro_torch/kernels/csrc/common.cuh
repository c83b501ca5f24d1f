// Shared parts of the port's hand-written kernels (plain C interface,
// loaded with ctypes; see kernels/build.py): the rounding helpers, the
// cache-hinted loads and stores, and the slab-ordered sweep that both
// kernels run.
//
// The slab sweep computes y[:, slab] = y0 + A·x[:, slab] (or an epilogue
// of the sum) for one column slab of width c at a time on row-major
// blocks. One CTA takes a tile of rows of one slab, and the tiles are
// numbered slab-major (every row tile of slab 0, then slab 1, ...), so the
// CTAs in flight hold a narrow band of rows of one slab, and the x rows
// that the operator's far entries (Hubbard(12,6)'s up-spin hops, up to
// ±232,848 rows) still have to read stay in L2. The streams read or
// written once (y0, w2, y) carry streaming hints. (An L2 evict_last
// policy on the x loads, tried, changed nothing measurable; persistent
// CTAs that staged the next tile's rows during the current tile's
// arithmetic, tried, ran the DIA step 1.36× slower: PERF.md.)
//
// Each CTA stages its tile's operator rows, which are contiguous, into
// shared memory with cp.async in 16-byte chunks: the loop over a row's
// entries then waits on no chain of global loads, and the operator
// streams from device memory at full width. A row's threads run along the
// slab with 16-byte vector loads, two a thread (at c = 32 fp64: 8 threads
// a row, four rows a warp), and issue the x loads of several entries at
// once before folding them. Registers are capped so that 3–4 CTAs share an SM: the
// sweep is bound by the x loads it keeps in flight.
//
// Arithmetic is that of the plain versions: per output element the
// entries are folded with fma_rn in ascending slot (= offset) order from
// y0 or 0, entries that are not stored are never visited (bit-neutral for
// finite x: fma(0, x, acc) == acc), and the Chebyshev epilogue is
// axpby_sub. So fp64 and fp32 results equal kernels/ref.py bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

// ---------------------------------------------------------------- loads --

// V consecutive elements (16-byte aligned when V > 1): ld through the
// read-only path, ld_stream / st_stream with the streaming hint (.cs).
template <typename T, int V> struct VecIO;

template <> struct VecIO<double, 1> {
  __device__ static void ld(const double* p, double* o) { o[0] = __ldg(p); }
  __device__ static void ld_stream(const double* p, double* o) {
    o[0] = __ldcs(p);
  }
  __device__ static void st_stream(double* p, const double* v) {
    __stcs(p, v[0]);
  }
};
template <> struct VecIO<double, 2> {
  __device__ static void ld(const double* p, double* o) {
    const double2 v = __ldg(reinterpret_cast<const double2*>(p));
    o[0] = v.x;
    o[1] = v.y;
  }
  __device__ static void ld_stream(const double* p, double* o) {
    const double2 v = __ldcs(reinterpret_cast<const double2*>(p));
    o[0] = v.x;
    o[1] = v.y;
  }
  __device__ static void st_stream(double* p, const double* v) {
    __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
  }
};
template <> struct VecIO<float, 1> {
  __device__ static void ld(const float* p, float* o) { o[0] = __ldg(p); }
  __device__ static void ld_stream(const float* p, float* o) {
    o[0] = __ldcs(p);
  }
  __device__ static void st_stream(float* p, const float* v) {
    __stcs(p, v[0]);
  }
};
template <> struct VecIO<float, 4> {
  __device__ static void ld(const float* p, float* o) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
  __device__ static void ld_stream(const float* p, float* o) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
  __device__ static void st_stream(float* p, const float* v) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};

// ------------------------------------------------------ shared staging --

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Copy the bytes [src, src + n) into dst asynchronously, as whole 16-byte
// chunks from the chunk that holds src (a 16-byte chunk never crosses a
// page, so the bytes read around the range are readable). All threads of
// the CTA take part. src's first byte lands at landing(dst, src).
__device__ __forceinline__ void stage_bytes(unsigned char* dst,
                                            const void* src, long long n) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(src);
  const uintptr_t a = p & ~uintptr_t(15);
  const uintptr_t b = (p + uintptr_t(n) + 15) & ~uintptr_t(15);
  for (uintptr_t o = uintptr_t(threadIdx.x) * 16; o < b - a;
       o += uintptr_t(blockDim.x) * 16)
    cp_async16(dst + o, reinterpret_cast<const void*>(a + o));
}
template <typename P>
__device__ __forceinline__ const P* landing(const unsigned char* dst,
                                            const void* src) {
  return reinterpret_cast<const P*>(
      dst + (reinterpret_cast<uintptr_t>(src) & uintptr_t(15)));
}

// Bytes a staged range of at most n bytes may take (see stage_bytes).
inline long long staged_capacity(long long n) {
  return (n + 15) / 16 * 16 + 16;
}

// ----------------------------------------------------------- the sweep --

// Geometry of one launch of the sweep: an [R, nb] output, row-major, in
// slabs of c columns and tiles of tile_rows rows.
struct Sweep {
  long long R;      // rows of y (and of the operator)
  long long nb;     // columns of x and y
  long long c;      // slab width
  long long n_rt;   // row tiles per slab
  long long n_tiles;  // n_rt · slabs
  int tile_rows;    // rows per tile (one CTA's rows)
  int lanes;        // threads per row
  long long op_bytes;    // shared bytes of the staged operator rows
};

constexpr int kThreads = 256;

// Shared bytes a tile's staged operator rows may take: 64 KB for the DIA
// kernel (a few KB at 128 rows: its tiles are halved only for operators
// far denser than lattice models), the 227 KB a block can have on Hopper
// for the ELL kernel, whose padded rows take W·(4 + S) bytes each.
constexpr long long kDiaOpBytes = 64 * 1024;
constexpr long long kSmemMax = 227 * 1024;

// CTAs per SM the register budget aims at: 4 (64 registers a thread),
// 3 for the variants that keep 4 vectors a thread in flight. Without a
// cap the sweep took 74–88 registers, 2–3 CTAs an SM, and ran up to 1.7×
// slower; a cap of 5 or 6 CTAs spilled and was slower too
// (scripts/torch_kernel_ab.py on an H100 80GB HBM3, 700 W; PERF.md).
constexpr int min_blocks(int nv) { return nv == 4 ? 3 : 4; }

// The operator policy Op provides:
//   static constexpr int kHeader;     shared bytes before the staged rows
//   void init(unsigned char* smem);   fill the header (before the sync)
//   void stage(buf, r0, rows);        issue the cp.async of a tile's rows
//   View view(buf, smem, r0);         the staged tile, after the wait
//   View::row(i, e0, e1)              entries [e0, e1) of the tile's row i
//   View::entry(e, r, col, v) -> bool the entry's column and value, false
//                                     to skip it (not stored / masked)
//   void start(acc, e, in)            the accumulator's first value
//   void finish(acc, y, e, in)        the epilogue and the store
// for the VEC-wide vector at element offset e of y (and y0, w1, w2), in
// the slab when `in`. One CTA a tile, the tiles in slab-major order.
template <typename T, int VEC, int NV, class Op>
__global__ void __launch_bounds__(kThreads, min_blocks(NV))
    slab_sweep(const Op op, const T* __restrict__ x, T* __restrict__ y,
               const Sweep sw) {
  extern __shared__ __align__(16) unsigned char smem[];
  // entries whose x loads are in flight at once: 8 scalars for a lane with
  // one scalar column (n_b = 1), else 4 vectors a lane
  constexpr int U = VEC == 1 && NV == 1 ? 8 : 4 / NV;
  const long long slab = blockIdx.x / sw.n_rt;
  const long long r0 = (blockIdx.x % sw.n_rt) * sw.tile_rows;
  const long long r1 = r0 + sw.tile_rows < sw.R ? r0 + sw.tile_rows : sw.R;
  unsigned char* const opbuf = smem + Op::kHeader;
  op.init(smem);
  op.stage(opbuf, r0, (int)(r1 - r0));
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int L = sw.lanes;
  const int lane = threadIdx.x % L;
  const long long step = (long long)L * VEC * NV;
  const auto v = op.view(opbuf, smem, r0);
  const long long jb = slab * sw.c;
  const long long je = jb + sw.c < sw.nb ? jb + sw.c : sw.nb;
  for (long long r = r0 + threadIdx.x / L; r < r1; r += blockDim.x / L) {
    int e0, e1;
    v.row((int)(r - r0), e0, e1);
    for (long long j = jb + (long long)lane * VEC; j < je; j += step) {
      T acc[NV][VEC];
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        const long long jj = j + q * (long long)L * VEC;
        op.start(acc[q], r * sw.nb + jj, jj < je);
      }
      for (int e = e0; e < e1; e += U) {
        long long col[U];
        T val[U];
        bool ok[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          col[u] = 0;
          val[u] = T(0);
          ok[u] = e + u < e1 && v.entry(e + u, r, col[u], val[u]);
        }
        T xv[U][NV][VEC];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int q = 0; q < NV; ++q) {
            const long long jj = j + q * (long long)L * VEC;
            if (ok[u] && jj < je) {
              VecIO<T, VEC>::ld(x + col[u] * sw.nb + jj, xv[u][q]);
            } else {
#pragma unroll
              for (int w = 0; w < VEC; ++w) xv[u][q][w] = T(0);
            }
          }
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (ok[u]) {
#pragma unroll
            for (int q = 0; q < NV; ++q)
#pragma unroll
              for (int w = 0; w < VEC; ++w)
                acc[q][w] = fma_rn(val[u], xv[u][q][w], acc[q][w]);
          }
      }
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        const long long jj = j + q * (long long)L * VEC;
        op.finish(acc[q], y, r * sw.nb + jj, jj < je);
      }
    }
  }
}

// How a launch lays threads over a slab, chosen on the host.
struct SweepPlan {
  int vec;    // elements per vector load (16 bytes, or 1)
  int nv;     // vectors per thread per pass over a row's entries
  int lanes;  // threads per row
};

inline int pow2_ceil(long long n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// 16-byte vectors when every row segment of the slab is 16-byte aligned
// (`aligned`: all block pointers are, and nb and c are multiples of the
// vector), else scalars; half as many lanes as the slab has vectors (up
// to 16), so that each lane decodes an entry once for two vectors (at
// c = 32 fp64 this took the step from 8.8 to 7.5 ms against one vector
// or four a lane; scripts/torch_kernel_ab.py, PERF.md); each lane up to
// 4 vectors a pass.
template <typename T>
inline SweepPlan plan_sweep(long long nb, long long c, bool aligned) {
  const int vmax = 16 / (int)sizeof(T);
  SweepPlan p;
  p.vec = (aligned && nb % vmax == 0 && c % vmax == 0) ? vmax : 1;
  const long long width = (c + p.vec - 1) / p.vec;
  p.lanes = pow2_ceil(width < 32 ? width : 32);
  if (p.lanes >= 4) p.lanes /= 2;
  const long long per_lane = (width + p.lanes - 1) / p.lanes;
  p.nv = per_lane >= 4 ? 4 : pow2_ceil(per_lane);
  return p;
}

inline bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

inline Sweep make_sweep(long long R, long long nb, long long c,
                        const SweepPlan& p, int rows, long long op_bytes) {
  Sweep sw;
  sw.R = R;
  sw.nb = nb;
  sw.c = c;
  sw.lanes = p.lanes;
  sw.tile_rows = rows;
  sw.n_rt = (R + rows - 1) / rows;
  sw.n_tiles = sw.n_rt * ((nb + c - 1) / c);
  sw.op_bytes = op_bytes;
  return sw;
}

// Launch the sweep: one CTA a tile, in slab-major order, so the CTAs that
// run at once hold a narrow band of rows of one slab.
template <typename T, int VEC, int NV, class Op>
static cudaError_t launch_sweep(const Op& op, const T* x, T* y,
                                const Sweep& sw, cudaStream_t stream) {
  const size_t smem = Op::kHeader + sw.op_bytes;
  auto kern = slab_sweep<T, VEC, NV, Op>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  if (sw.n_tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kern<<<(unsigned)sw.n_tiles, kThreads, smem, stream>>>(op, x, y, sw);
  return cudaGetLastError();
}

// Dispatch a SweepPlan's nv onto the compiled NV instances (its vec is
// the op's VEC, fixed by the caller).
template <typename T, int VEC, class Op>
static cudaError_t run_sweep(const SweepPlan& p, const Op& op, const T* x,
                             T* y, const Sweep& sw, cudaStream_t s) {
  switch (p.nv) {
    case 4: return launch_sweep<T, VEC, 4>(op, x, y, sw, s);
    case 2: return launch_sweep<T, VEC, 2>(op, x, y, sw, s);
    default: return launch_sweep<T, VEC, 1>(op, x, y, sw, s);
  }
}

}  // namespace repro_torch
