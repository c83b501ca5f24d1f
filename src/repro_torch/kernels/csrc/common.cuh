// Shared parts of the port's hand-written kernels (plain C interface,
// loaded with ctypes; see kernels/build.py): the rounding helpers, the
// cache-hinted loads and stores, and the slab-ordered sweep that both
// kernels run.
//
// The slab sweep computes y[:, slab] = y0 + A·x[:, slab] (or an epilogue
// of the sum) for one column slab of width c at a time on row-major
// blocks, for P row shards of R rows at once (a block of every shard in
// one launch; P = 1 is one block). One CTA takes a tile of rows of one
// shard and one slab, and the tiles are numbered slab-major (every row
// tile of every shard in slab 0, then slab 1, ...), so the CTAs in flight
// hold a narrow band of rows of one slab, and the x rows
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
// entries are folded with mac in ascending slot (= offset) order from y0
// or 0, entries that are not stored are never visited (bit-neutral for
// finite x: fma(0, x, acc) == acc, and a complex zero adds ±0 to each
// plane), and the Chebyshev epilogue is axpby_sub. So results equal
// kernels/ref.py bit for bit, in fp64, fp32, complex128 and complex64.
//
// A complex value is the pair (re, im) as torch lays it out; c128 is one
// 16-byte vector, c64 one 8-byte one, so the sweep's vector loads carry
// whole complex values and a complex128 lane has the footprint of an fp64
// lane with two columns.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace repro_torch {

// Complex values, laid out as torch's complex128 / complex64.
struct __align__(16) c128 {
  double re, im;
  c128() = default;
  __host__ __device__ constexpr c128(double r, double i = 0.0)
      : re(r), im(i) {}
};
struct __align__(8) c64 {
  float re, im;
  c64() = default;
  __host__ __device__ constexpr c64(float r, float i = 0.0f) : re(r), im(i) {}
};

// The real type of an element type (the Chebyshev scalars' type).
template <typename T> struct RealOf { using type = T; };
template <> struct RealOf<c128> { using type = double; };
template <> struct RealOf<c64> { using type = float; };

// acc + v·x, rounded as the plain versions (and the reference's scan on
// the CPU) round it; the accumulation chain of every kernel is written
// with it, in explicitly rounded intrinsics, so it never depends on what
// the compiler chooses to contract. Real: one fused multiply-add. Complex:
// each plane of the product one fused multiply-add over a rounded
// product, fma(vr, xr, −vi·xi) and fma(vi, xr, vr·xi), as XLA's CPU
// backend contracts the complex product, then one rounded add into each
// plane of the accumulator: 8 flops an entry (two FMAs, two multiplies,
// two adds).
__device__ __forceinline__ double mac(double v, double x, double acc) {
  return __fma_rn(v, x, acc);
}
__device__ __forceinline__ float mac(float v, float x, float acc) {
  return __fmaf_rn(v, x, acc);
}
__device__ __forceinline__ c128 mac(c128 v, c128 x, c128 acc) {
  const double pr = __fma_rn(v.re, x.re, -__dmul_rn(v.im, x.im));
  const double pi = __fma_rn(v.im, x.re, __dmul_rn(v.re, x.im));
  return c128(__dadd_rn(acc.re, pr), __dadd_rn(acc.im, pi));
}
__device__ __forceinline__ c64 mac(c64 v, c64 x, c64 acc) {
  const float pr = __fmaf_rn(v.re, x.re, -__fmul_rn(v.im, x.im));
  const float pi = __fmaf_rn(v.im, x.re, __fmul_rn(v.re, x.im));
  return c64(__fadd_rn(acc.re, pr), __fadd_rn(acc.im, pi));
}

__device__ __forceinline__ bool is_zero(double v) { return v == 0.0; }
__device__ __forceinline__ bool is_zero(float v) { return v == 0.0f; }
__device__ __forceinline__ bool is_zero(c128 v) {
  return v.re == 0.0 && v.im == 0.0;
}
__device__ __forceinline__ bool is_zero(c64 v) {
  return v.re == 0.0f && v.im == 0.0f;
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
// complex y, w, z with real a, b: each plane on its own
__device__ __forceinline__ c128 axpby_sub(double a, c128 y, double b, c128 w,
                                          c128 z) {
  return c128(axpby_sub(a, y.re, b, w.re, z.re),
              axpby_sub(a, y.im, b, w.im, z.im));
}
__device__ __forceinline__ c64 axpby_sub(float a, c64 y, float b, c64 w,
                                         c64 z) {
  return c64(axpby_sub(a, y.re, b, w.re, z.re),
             axpby_sub(a, y.im, b, w.im, z.im));
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

template <> struct VecIO<c128, 1> {
  __device__ static void ld(const c128* p, c128* o) {
    const double2 v = __ldg(reinterpret_cast<const double2*>(p));
    o[0] = c128(v.x, v.y);
  }
  __device__ static void ld_stream(const c128* p, c128* o) {
    const double2 v = __ldcs(reinterpret_cast<const double2*>(p));
    o[0] = c128(v.x, v.y);
  }
  __device__ static void st_stream(c128* p, const c128* v) {
    __stcs(reinterpret_cast<double2*>(p), make_double2(v[0].re, v[0].im));
  }
};
template <> struct VecIO<c64, 1> {
  __device__ static void ld(const c64* p, c64* o) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    o[0] = c64(v.x, v.y);
  }
  __device__ static void ld_stream(const c64* p, c64* o) {
    const float2 v = __ldcs(reinterpret_cast<const float2*>(p));
    o[0] = c64(v.x, v.y);
  }
  __device__ static void st_stream(c64* p, const c64* v) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(v[0].re, v[0].im));
  }
};
template <> struct VecIO<c64, 2> {
  __device__ static void ld(const c64* p, c64* o) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = c64(v.x, v.y);
    o[1] = c64(v.z, v.w);
  }
  __device__ static void ld_stream(const c64* p, c64* o) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
    o[0] = c64(v.x, v.y);
    o[1] = c64(v.z, v.w);
  }
  __device__ static void st_stream(c64* p, const c64* v) {
    __stcs(reinterpret_cast<float4*>(p),
           make_float4(v[0].re, v[0].im, v[1].re, v[1].im));
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

// Geometry of one launch of the sweep: P row shards of an [R, nb] output,
// row-major, in slabs of c columns and tiles of tile_rows rows. Shard p's
// rows of x and y start p·sx and p·sy elements past their bases (the
// operands' own shard strides: a block of every shard may be a strided
// view of a larger buffer), and its operator rows are p·R .. p·R + R − 1.
struct Sweep {
  long long P;      // row shards
  long long R;      // rows of y (and of the operator) per shard
  long long nb;     // columns of x and y
  long long c;      // slab width
  long long n_rt;   // row tiles per shard and slab
  long long n_tiles;  // n_rt · P · slabs
  long long sx, sy;   // shard strides of x and y, in elements
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
//   static constexpr long long kOpBytes;  most shared bytes of the rows
//   static constexpr bool kShards;    takes P > 1 shards (else P = 1)
//   void init(unsigned char* smem);   fill the header (before the sync)
//   void stage(buf, g0, rows);        issue the cp.async of a tile's rows
//   View view(buf, smem, g0);         the staged tile, after the wait
//   View::row(i, e0, e1)              entries [e0, e1) of the tile's row i
//   View::entry(e, g, col, v) -> bool the entry's column and value, false
//                                     to skip it (not stored / masked)
//   void start(acc, p, e, in)         the accumulator's first value
//   void finish(acc, y, p, e, in)     the epilogue and the store
// with g0, g operator rows (shard p's row r is p·R + r), for the VEC-wide
// vector at element offset e of shard p's rows of y (and y0, w1, w2,
// which the op offsets by their own shard strides; y comes offset), in
// the slab when `in`. One CTA a tile, the tiles in slab-major order.
template <typename T, int VEC, int NV, class Op>
__global__ void __launch_bounds__(kThreads, min_blocks(NV))
    slab_sweep(const Op op, const T* __restrict__ x, T* __restrict__ y,
               const Sweep sw) {
  extern __shared__ __align__(16) unsigned char smem[];
  // entries whose x loads are in flight at once: 8 scalars for a lane with
  // one scalar column (n_b = 1; 4 complex128, which take twice the
  // registers), else 4 vectors a lane
  constexpr int U =
      VEC == 1 && NV == 1 ? (sizeof(T) > 8 ? 4 : 8) : 4 / NV;
  // tile t of shard p in slab `slab`; rows r0 .. r1 − 1 of the shard
  // (an op of one block, Op::kShards false, is shard 0 at compile time)
  long long slab, p = 0, t = blockIdx.x;
  if constexpr (Op::kShards) {
    const long long per_slab = sw.P * sw.n_rt;
    slab = blockIdx.x / per_slab;
    t = blockIdx.x - slab * per_slab;
    p = t / sw.n_rt;
    t -= p * sw.n_rt;
    x += p * sw.sx;
    y += p * sw.sy;
  } else {
    slab = blockIdx.x / sw.n_rt;
    t = blockIdx.x % sw.n_rt;
  }
  const long long r0 = t * sw.tile_rows;
  const long long r1 = r0 + sw.tile_rows < sw.R ? r0 + sw.tile_rows : sw.R;
  const long long g0 = p * sw.R + r0;  // the operator row of r0
  unsigned char* const opbuf = smem + Op::kHeader;
  op.init(smem);
  op.stage(opbuf, g0, (int)(r1 - r0));
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int L = sw.lanes;
  const int lane = threadIdx.x % L;
  const long long step = (long long)L * VEC * NV;
  const auto v = op.view(opbuf, smem, g0);
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
        op.start(acc[q], p, r * sw.nb + jj, jj < je);
      }
      for (int e = e0; e < e1; e += U) {
        long long col[U];
        T val[U];
        bool ok[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          col[u] = 0;
          val[u] = T(0);
          ok[u] = e + u < e1 &&
                  v.entry(e + u, g0 + (r - r0), col[u], val[u]);
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
                acc[q][w] = mac(val[u], xv[u][q][w], acc[q][w]);
          }
      }
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        const long long jj = j + q * (long long)L * VEC;
        op.finish(acc[q], y, p, r * sw.nb + jj, jj < je);
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
// (`aligned`: all block pointers and shard strides are, and nb and c are
// multiples of the vector), else scalars; half as many lanes as the slab
// has vectors (up to 16), so that each lane decodes an entry once for two
// vectors (at c = 32 fp64 this took the step from 8.8 to 7.5 ms against
// one vector or four a lane; scripts/torch_kernel_ab.py, PERF.md); each
// lane up to 4 vectors a pass.
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

// A shard stride of elements of S bytes keeps 16-byte alignment.
inline bool aligned16(long long stride, long long S) {
  return (stride * S) % 16 == 0;
}

// P shards of R rows, shard strides sx (x) and sy (y) in elements.
inline Sweep make_sweep(long long P, long long R, long long nb, long long c,
                        long long sx, long long sy, const SweepPlan& p,
                        int rows, long long op_bytes) {
  Sweep sw;
  sw.P = P;
  sw.R = R;
  sw.nb = nb;
  sw.c = c;
  sw.sx = sx;
  sw.sy = sy;
  sw.lanes = p.lanes;
  sw.tile_rows = rows;
  sw.n_rt = (R + rows - 1) / rows;
  sw.n_tiles = sw.n_rt * P * ((nb + c - 1) / c);
  sw.op_bytes = op_bytes;
  return sw;
}

// Launch the sweep: one CTA a tile, in slab-major order, so the CTAs that
// run at once hold a narrow band of rows of one slab. The kernel may take
// Op::kHeader + Op::kOpBytes shared bytes, allowed once per instance and
// device (the first launch on a device sets the attribute; it is not set
// again on every launch).
template <typename T, int VEC, int NV, class Op>
static cudaError_t launch_sweep(const Op& op, const T* x, T* y,
                                const Sweep& sw, cudaStream_t stream) {
  constexpr long long kMaxSmem = Op::kHeader + Op::kOpBytes;
  static std::atomic<unsigned long long> allowed{0};  // a bit per device
  const long long smem = Op::kHeader + sw.op_bytes;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (sw.n_tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  auto kern = slab_sweep<T, VEC, NV, Op>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit == 0 || (allowed.load(std::memory_order_acquire) & bit) == 0) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kMaxSmem);
    if (e != cudaSuccess) return e;
    allowed.fetch_or(bit, std::memory_order_release);
  }
  kern<<<(unsigned)sw.n_tiles, kThreads, (size_t)smem, stream>>>(op, x, y,
                                                                 sw);
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
