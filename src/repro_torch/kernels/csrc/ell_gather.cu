// ELL SpMMV with a threaded accumulator: y = y0 + A·x, and the same
// product with the fused Chebyshev epilogue, y = 2a·(y0 + A·x) + 2b·w1 − w2
// (the ell_gather_cheb_* entries).
//
// Replaces: src/repro/kernels/ell_gather.py::ell_gather_spmv (Pallas TPU
// tile kernel, body _kernel). The TPU kernel re-buckets the ELL block into
// (row block x column block) tiles (build_tiles) so each gather stays in
// VMEM; Hopper gathers through its 50 MB L2, so this kernel reads the
// block's rows as they are, less their padding.
//
// Bound on an H100 SXM: memory. At Hubbard(12,6), n_b = 512, fp64 the
// function must move x (3.50 GB) + ELL (0.13 GB at 13 entries a row) + y
// (3.50 GB) ≈ 7.1 GB: ≈ 2.1 ms at 3.35 TB/s. At n_b = 1 (Lanczos) it is
// ≈ 0.15 GB: ≈ 0.044 ms.
//
// What held the previous design back (one CTA per block of rows, threads
// along n_b, the row's slots read from device memory in a dependent
// chain; chip_smoke.py run 3 on an H100 80GB HBM3, 700 W): 10.78 ms at
// n_b = 512 fp64, level with cuSPARSE (10.74 ms); at n_b = 1, 0.57 ms
// against cuSPARSE's 0.10 ms, because one thread walked a row's 23 slots
// at a 92-byte stride and each gather waited on its slot's index load.
//
// The design now: the slab sweep of common.cuh in one slab (c = n_b: the
// operator costs 156 B a row at Hubbard(12,6) fp64, too much to re-read
// per slab; kernels/ell_gather.py::slab_for), over the block's
// padding-free form: int32 row pointers, and per row only its stored
// entries, in slot order, each an int32 column and a value. (The padded
// [R, W = 23] block, 276 B a row, held n_b = 1 level with cuSPARSE's CSR
// product: its time follows the bytes it reads; PERF.md.) Each CTA
// stages its tile's rows, contiguous in memory, with cp.async in 16-byte
// chunks, so the operator streams at full width and the loop over a
// row's entries reads shared memory only; the x loads of several entries
// are issued at once. At n_b = 1 a thread owns a row and its 8 gathers in
// flight come from L2 (x is 6.8 MB); at n_b = 512 16 threads own a row,
// with 16-byte vector loads. Per output element the entries are
// accumulated in slot order with an explicit fma from y0 (or 0): the
// chain of single roundings of the reference's scan over the padded
// block, whose zero slots change no bit (fma(0, x, acc) == acc for every
// finite x), so results equal the plain version bit for bit. The ragged
// edge (R, n_b and the last slab of any size) is masked here. Wide rows
// shrink the tile (sweep_ell), and a row too wide to stage alone is read
// where it lies, so any W is taken. Complex128 and complex64 blocks run
// the same sweep with c128 / c64 values (common.cuh::mac).
//
// One launch takes a block of every row shard (the entries' EllShards):
// the engines of core/spmv.py contract a phase of P shards at once, from
// the shards' stacked padding-free form (row pointers over P·R rows,
// columns local to the shard's x) and the shard stride of each operand,
// so the strided views the engines hold (a shard's [x_p ‖ halo] rows of
// one buffer, the prefix of a halo buffer, the owned rows of an s-step
// extended block) go in as they are. A tile lies inside one shard. One
// launch a shard left the card under one wave at the 8-shard solves'
// shape (6,000 rows × 64 columns a launch: 375 CTAs) and paid a launch's
// host cost for 2–6 µs of bound work; one shard is P = 1.
#include "common.cuh"

namespace repro_torch {

template <typename T>
struct EllView {  // the tile's rows, staged or where they lie
  const int* rp;    // the tile's row pointers
  const int* cols;  // the tile's entries, from rp[0]
  const T* vals;
  __device__ void row(int i, int& e0, int& e1) const {
    e0 = rp[i] - rp[0];
    e1 = rp[i + 1] - rp[0];
  }
  __device__ bool entry(int e, long long, long long& col, T& v) const {
    v = vals[e];
    if (is_zero(v)) return false;
    col = cols[e];
    return true;
  }
};

// With EPI the store is the Chebyshev step's epilogue 2a·acc + 2b·w1 − w2
// (w1, w2 [R, nb] a shard like y), rounded as cheb_dia.cu's is
// (axpby_sub). y0, w1 and w2 are offset to shard p by their own shard
// strides.
template <typename T, int VEC, bool EPI>
struct EllOp {
  static constexpr int kHeader = 0;
  static constexpr long long kOpBytes = kSmemMax;
  static constexpr bool kShards = true;
  const int* rowptr;
  const int* cols;
  const T* vals;
  const T* y0;  // nullptr: start from 0
  const T* w1;  // EPI only
  const T* w2;
  long long sy0, sw1, sw2;  // shard strides, in elements
  typename RealOf<T>::type a2, b2;  // EPI: 2·alpha, 2·beta (real)
  long long rp_cap, cols_cap;  // shared bytes of the staged parts
  bool staged;  // false: rows too wide to stage, read in place

  __device__ void init(unsigned char*) const {}
  __device__ void stage(unsigned char* buf, long long g0, int rows) const {
    if (!staged) return;
    const long long eb = rowptr[g0], ee = rowptr[g0 + rows];
    stage_bytes(buf, rowptr + g0, (long long)(rows + 1) * 4);
    stage_bytes(buf + rp_cap, cols + eb, (ee - eb) * 4);
    stage_bytes(buf + rp_cap + cols_cap, vals + eb, (ee - eb) * sizeof(T));
  }
  __device__ EllView<T> view(const unsigned char* buf, const unsigned char*,
                             long long g0) const {
    if (!staged) {
      const long long eb = rowptr[g0];
      return EllView<T>{rowptr + g0, cols + eb, vals + eb};
    }
    const int* rp = landing<int>(buf, rowptr + g0);
    const long long eb = rp[0];
    return EllView<T>{rp, landing<int>(buf + rp_cap, cols + eb),
                      landing<T>(buf + rp_cap + cols_cap, vals + eb)};
  }
  __device__ void start(T* acc, long long p, long long e, bool in) const {
    if (y0 != nullptr && in) {
      VecIO<T, VEC>::ld_stream(y0 + p * sy0 + e, acc);
    } else {
#pragma unroll
      for (int w = 0; w < VEC; ++w) acc[w] = T(0);
    }
  }
  __device__ void finish(const T* acc, T* y, long long p, long long e,
                         bool in) const {
    if (!in) return;
    if (!EPI) {
      VecIO<T, VEC>::st_stream(y + e, acc);
      return;
    }
    T a[VEC], b[VEC], out[VEC];
    VecIO<T, VEC>::ld(w1 + p * sw1 + e, a);
    VecIO<T, VEC>::ld_stream(w2 + p * sw2 + e, b);
#pragma unroll
    for (int w = 0; w < VEC; ++w) out[w] = axpby_sub(a2, acc[w], b2, a[w], b[w]);
    VecIO<T, VEC>::st_stream(y + e, out);
  }
};

// The epilogue's operands (w1 == nullptr: none).
template <typename T>
struct EllEpi {
  const T* w1;
  const T* w2;
  typename RealOf<T>::type a2, b2;
};

struct EllArgs {
  const int* rowptr;
  const int* cols;
  const void* vals;
  // tiles of at most tile_rows rows (a power of two,
  // kernels/plan.py::ELL_TILE_ROWS), tile_max the most entries in one
  // from a multiple of tile_rows of a shard, max_row the most in a row
  long long tile_rows, tile_max, max_row;
};

// The shards of one launch: P blocks of R rows, each operand's shard
// stride in elements (sy0 of y0, sw1 / sw2 of the epilogue's blocks).
struct EllShards {
  long long P, R, sx, sy0, sw1, sw2, sy;
};

// One pass of rows a tile (at most tile_rows), halved while the tile's
// entries would not fit kSmemMax; a row too wide to stage alone is read
// from device memory where it lies.
template <typename T, int VEC, bool EPI>
static cudaError_t sweep_ell(const SweepPlan& p, const EllArgs& a,
                             const EllShards& g, const T* x, const T* y0,
                             const EllEpi<T>& ep, T* y, long long nb,
                             long long c, cudaStream_t s) {
  long long rp_cap = 0, cols_cap = 0, vals_cap = 0;
  const auto fits = [&](long long rows) {
    const long long n =
        a.tile_max < rows * a.max_row ? a.tile_max : rows * a.max_row;
    rp_cap = staged_capacity((rows + 1) * 4);
    cols_cap = staged_capacity(n * 4);
    vals_cap = staged_capacity(n * (long long)sizeof(T));
    return rp_cap + cols_cap + vals_cap <= kSmemMax;
  };
  long long rows = kThreads / p.lanes;
  if (rows > a.tile_rows) rows = a.tile_rows;
  while (rows > 1 && !fits(rows)) rows /= 2;
  const bool staged = fits(rows);
  // a tile may hold fewer rows than the CTA's threads cover in one pass
  const Sweep sw = make_sweep(g.P, g.R, nb, c, g.sx, g.sy, p, (int)rows,
                              staged ? rp_cap + cols_cap + vals_cap : 0);
  const EllOp<T, VEC, EPI> op{a.rowptr, a.cols,
                              static_cast<const T*>(a.vals), y0, ep.w1,
                              ep.w2, g.sy0, g.sw1, g.sw2, ep.a2, ep.b2,
                              rp_cap, cols_cap, staged};
  return run_sweep<T, VEC>(p, op, x, y, sw, s);
}

template <typename T, int VEC>
static cudaError_t sweep_ell(const SweepPlan& p, const EllArgs& a,
                             const EllShards& g, const T* x, const T* y0,
                             const EllEpi<T>& ep, T* y, long long nb,
                             long long c, cudaStream_t s) {
  return ep.w1 != nullptr
             ? sweep_ell<T, VEC, true>(p, a, g, x, y0, ep, y, nb, c, s)
             : sweep_ell<T, VEC, false>(p, a, g, x, y0, ep, y, nb, c, s);
}

// ------------------------------------------------------------- entries --

// w1_ == nullptr: no epilogue (w2_, alpha and beta unused).
template <typename T>
static int launch_ell_gather(const EllArgs& a, const EllShards& g,
                             const void* x_, const void* y0_, const void* w1_,
                             const void* w2_, double alpha, double beta,
                             void* y_, long long nb, long long c,
                             void* stream) {
  if (g.P < 1 || g.R < 0 || nb < 0 || g.sx < 0 || g.sy0 < 0 || g.sw1 < 0 ||
      g.sw2 < 0 || g.sy < 0)
    return (int)cudaErrorInvalidValue;
  if (g.R == 0 || nb == 0) return (int)cudaGetLastError();
  if (c < 1 || c > nb || a.tile_rows < 1 ||
      (a.tile_rows & (a.tile_rows - 1)) != 0 || a.tile_max < 0 ||
      a.max_row < 0 || (w1_ != nullptr) != (w2_ != nullptr))
    return (int)cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(x_);
  const T* y0 = static_cast<const T*>(y0_);
  T* y = static_cast<T*>(y_);
  using Real = typename RealOf<T>::type;
  const EllEpi<T> ep{static_cast<const T*>(w1_), static_cast<const T*>(w2_),
                     Real(2.0 * Real(alpha)), Real(2.0 * Real(beta))};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr long long S = sizeof(T);
  const bool strides16 =
      g.P == 1 || (aligned16(g.sx, S) && aligned16(g.sy, S) &&
                   (y0 == nullptr || aligned16(g.sy0, S)) &&
                   (ep.w1 == nullptr ||
                    (aligned16(g.sw1, S) && aligned16(g.sw2, S))));
  const SweepPlan p = plan_sweep<T>(
      nb, c, strides16 && aligned16(x) && aligned16(y0) && aligned16(y) &&
                 aligned16(ep.w1) && aligned16(ep.w2));
  constexpr int VW = 16 / sizeof(T);
  const cudaError_t e =
      p.vec == VW ? sweep_ell<T, VW>(p, a, g, x, y0, ep, y, nb, c, s)
                  : sweep_ell<T, 1>(p, a, g, x, y0, ep, y, nb, c, s);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace repro_torch

// rowptr int32 [P·R + 1], cols int32 [nnz] and vals [nnz] the stacked
// padding-free form of P shards' blocks (kernels/plan.py::CompactEll,
// compact_ell_grouped; nnz may be 0), cols indexing rows of the shard's
// x; tile_max the most entries in any tile_rows rows of a shard from a
// multiple of tile_rows (a power of two), max_row in a row. Shard p's
// x [Rx, nb], y0 and y [R, nb] are row-major (row stride nb) and start
// p·sx, p·sy0, p·sy elements past x, y0, y; y0 may be null and may be y
// (with sy0 == sy: each element is read before it is written, by the
// same thread); c the slab width (1 <= c <= nb). The ell_gather_cheb_*
// entries also take w1, w2 (shard strides sw1, sw2; not y) and the real
// alpha, beta, and store 2a·(y0 + A·x) + 2b·w1 − w2. P = 1 with any
// strides is one block.
#define ELL_GATHER_ENTRY(NAME, CHEB, T)                                      \
  extern "C" int NAME(const void* rowptr, const void* cols,                 \
                      const void* vals, long long tile_rows,                \
                      long long tile_max, long long max_row, const void* x, \
                      const void* y0, void* y, long long P, long long R,    \
                      long long nb, long long c, long long sx,              \
                      long long sy0, long long sy, void* stream) {          \
    const repro_torch::EllArgs a{static_cast<const int*>(rowptr),           \
                                 static_cast<const int*>(cols), vals,       \
                                 tile_rows, tile_max, max_row};             \
    const repro_torch::EllShards g{P, R, sx, sy0, 0, 0, sy};                \
    return repro_torch::launch_ell_gather<T>(a, g, x, y0, nullptr, nullptr, \
                                             0.0, 0.0, y, nb, c, stream);   \
  }                                                                          \
  extern "C" int CHEB(const void* rowptr, const void* cols,                 \
                      const void* vals, long long tile_rows,                \
                      long long tile_max, long long max_row, const void* x, \
                      const void* y0, const void* w1, const void* w2,       \
                      void* y, long long P, long long R, long long nb,      \
                      long long c, long long sx, long long sy0,             \
                      long long sw1, long long sw2, long long sy,           \
                      double alpha, double beta, void* stream) {            \
    if (w1 == nullptr || w2 == nullptr) return (int)cudaErrorInvalidValue;  \
    const repro_torch::EllArgs a{static_cast<const int*>(rowptr),           \
                                 static_cast<const int*>(cols), vals,       \
                                 tile_rows, tile_max, max_row};             \
    const repro_torch::EllShards g{P, R, sx, sy0, sw1, sw2, sy};            \
    return repro_torch::launch_ell_gather<T>(a, g, x, y0, w1, w2, alpha,    \
                                             beta, y, nb, c, stream);       \
  }

ELL_GATHER_ENTRY(ell_gather_f64, ell_gather_cheb_f64, double)
ELL_GATHER_ENTRY(ell_gather_f32, ell_gather_cheb_f32, float)
ELL_GATHER_ENTRY(ell_gather_c128, ell_gather_cheb_c128, repro_torch::c128)
ELL_GATHER_ENTRY(ell_gather_c64, ell_gather_cheb_c64, repro_torch::c64)
