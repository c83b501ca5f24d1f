// Fused Chebyshev step of a DIA operator:
//   y = 2a·(Σ_d dvals[d, i]·x[i + off_d]) + 2b·w1 − w2.
//
// Replaces: src/repro/kernels/cheb_dia.py::cheb_dia (Pallas TPU kernel,
// body _kernel). On the TPU an unaligned offset is assembled from two
// aligned VMEM tiles; on Hopper a shifted row of x is an ordinary load,
// so the grid needs no diagonal axis.
//
// Bound on an H100 SXM: memory. At Hubbard(12,6), n_b = 512, fp64 the
// function must move x = w1 (3.50 GB) + w2 (3.50 GB) + y (3.50 GB) +
// dvals (61 diagonals, 0.42 GB) ≈ 10.9 GB, which takes ≈ 3.3 ms at
// 3.35 TB/s; the arithmetic is far below the fp64 peak.
//
// What held the previous design back (one CTA per 2 rows, threads along
// the whole n_b, rows in order, the CTA's 61 dvals staged in shared
// memory; 10.72 ms at n_b = 512 fp64 against the 3.26 ms bound,
// chip_smoke.py run 3 on an H100 80GB HBM3, 700 W): Hubbard(12,6)'s 30
// up-spin diagonals lie at multiples of 924 rows up to ±232,848, so the
// reads of one 4 KB x row by its up-hop neighbours lie far apart in the
// sweep and mostly miss L2: each x row came from device memory several
// times (≈ 36 GB a step at ≈ 3 TB/s), and every x read, hit or miss,
// crossed from L2 to the SMs (≈ 56 GB a step).
//
// The design now: the slab sweep of common.cuh, c columns at a time
// (the rule of kernels/plan.py::slab_width; c = 32 at fp64 n_b = 512),
// so the x rows that the far entries still have to read stay in L2, over
// a compact operator that a narrow slab can afford to read n_b/c times:
// per row only its stored entries, in ascending offset order, each a
// uint8 diagonal id, with int32 row pointers, and their values from a
// table when the values off the main diagonal take at most 256 distinct
// values (Hubbard: one, −t), the main diagonal dense: 25 B a row at
// Hubbard(12,6) fp64, against 488 B of dense dvals (or 121 B with a value
// an entry, which the kernel also takes). Each CTA stages its tile's row
// pointers, ids, value indices and main-diagonal values with cp.async;
// the offsets and the value table sit in shared memory. An entry whose
// column leaves [0, Rx) is masked. w1 and w2 are read once, in the
// epilogue 2a·acc + 2b·w1 − w2, rounded as the reference's is on the CPU
// (no FMA there): κ = 5. What the sweep then bounds at is not device
// memory but the x loads in flight (PERF.md): the registers are
// capped for 4 CTAs an SM, and a staged band of x rows or narrower slabs,
// tried, only cost occupancy.
//
// Complex operators (Exciton, TopIns) run the same sweep with c128 / c64
// values (common.cuh): the compact form's table holds complex values, the
// Chebyshev scalars stay real, the epilogue acts on each plane. At
// Exciton(L = 30), n_b = 384, complex128 the step takes 6.46 ms, 0.58 of
// its 3.75 ms bound, at the rule's c = 16 (chip_smoke.py, H100 80GB HBM3,
// 700 W; PERF.md).
#include "common.cuh"

namespace repro_torch {

constexpr int kMaxDiags = 64;  // DIA_MAX_DIAGS of kernels/ops.py

struct DiaOffsets {
  int n;
  int off[kMaxDiags];
};

// The operator's values: per entry (vals), or, with TABLE, an entry's
// value is table[vidx[e]] (table[0] without vidx) off the main diagonal
// and diag[r] on it (id diag_id).
template <typename T, bool TABLE>
struct DiaView {
  const int* rp;        // the tile's row pointers
  const uint8_t* ids;   // the tile's entries, from rp[0]
  const T* vals;        // per entry, or (TABLE) the tile's diag rows
  const uint8_t* vidx;  // TABLE: per entry, or null
  const T* table;       // TABLE: shared
  const int* off;       // offsets table (shared)
  long long Rx, r0;
  int diag_id;
  __device__ void row(int i, int& e0, int& e1) const {
    e0 = rp[i] - rp[0];
    e1 = rp[i + 1] - rp[0];
  }
  __device__ bool entry(int e, long long r, long long& col, T& v) const {
    const int id = ids[e];
    col = r + off[id];
    if (TABLE)
      v = id == diag_id ? vals[r - r0] : table[vidx != nullptr ? vidx[e] : 0];
    else
      v = vals[e];
    return col >= 0 && col < Rx;
  }
};

template <typename T, int VEC, bool TABLE>
struct DiaOp {
  static constexpr int kTable = 256;  // TABLE_MAX of kernels/plan.py
  static constexpr int kHeader = kMaxDiags * sizeof(int) + kTable * sizeof(T);
  static constexpr long long kOpBytes = kDiaOpBytes;
  static constexpr bool kShards = false;  // one block a launch
  DiaOffsets offs;
  const int* rowptr;
  const uint8_t* ids;
  const T* vals;        // per entry, or (TABLE) the main diagonal [R]
  const uint8_t* vidx;
  const T* table;
  int n_table, diag_id;
  const T* w1;
  const T* w2;
  long long Rx;
  typename RealOf<T>::type a2, b2;  // 2·alpha, 2·beta (real)
  long long rp_cap, ids_cap, vidx_cap;  // shared bytes of the staged parts

  __device__ void init(unsigned char* smem) const {
    int* s_off = reinterpret_cast<int*>(smem);
    for (int d = threadIdx.x; d < offs.n; d += blockDim.x) s_off[d] = offs.off[d];
    T* s_table = reinterpret_cast<T*>(smem + kMaxDiags * sizeof(int));
    for (int k = threadIdx.x; k < n_table; k += blockDim.x) s_table[k] = table[k];
  }
  __device__ void stage(unsigned char* buf, long long r0, int rows) const {
    const long long eb = rowptr[r0], ee = rowptr[r0 + rows];
    stage_bytes(buf, rowptr + r0, (long long)(rows + 1) * 4);
    stage_bytes(buf + rp_cap, ids + eb, ee - eb);
    unsigned char* rest = buf + rp_cap + ids_cap;
    if (TABLE) {
      if (vidx != nullptr) stage_bytes(rest, vidx + eb, ee - eb);
      if (diag_id >= 0)
        stage_bytes(rest + vidx_cap, vals + r0, (long long)rows * sizeof(T));
    } else {
      stage_bytes(rest, vals + eb, (ee - eb) * sizeof(T));
    }
  }
  __device__ DiaView<T, TABLE> view(const unsigned char* buf,
                                    const unsigned char* smem,
                                    long long r0) const {
    const int* rp = landing<int>(buf, rowptr + r0);
    const long long eb = rp[0];
    const unsigned char* rest = buf + rp_cap + ids_cap;
    DiaView<T, TABLE> v;
    v.rp = rp;
    v.ids = landing<uint8_t>(buf + rp_cap, ids + eb);
    v.vals = TABLE ? landing<T>(rest + vidx_cap, vals + r0)
                   : landing<T>(rest, vals + eb);
    v.vidx = TABLE && vidx != nullptr ? landing<uint8_t>(rest, vidx + eb)
                                      : nullptr;
    v.table = reinterpret_cast<const T*>(smem + kMaxDiags * sizeof(int));
    v.off = reinterpret_cast<const int*>(smem);
    v.Rx = Rx;
    v.r0 = r0;
    v.diag_id = diag_id;
    return v;
  }
  __device__ void start(T* acc, long long, long long, bool) const {
#pragma unroll
    for (int w = 0; w < VEC; ++w) acc[w] = T(0);
  }
  // one shard (p = 0)
  __device__ void finish(const T* acc, T* y, long long, long long e,
                         bool in) const {
    if (!in) return;
    T a[VEC], b[VEC], out[VEC];
    VecIO<T, VEC>::ld(w1 + e, a);
    VecIO<T, VEC>::ld_stream(w2 + e, b);
#pragma unroll
    for (int w = 0; w < VEC; ++w) out[w] = axpby_sub(a2, acc[w], b2, a[w], b[w]);
    VecIO<T, VEC>::st_stream(y + e, out);
  }
};

struct DiaArgs {
  DiaOffsets offs;
  const int* rowptr;
  const uint8_t* ids;
  const void* vals;     // per entry, or (with a table) the main diagonal
  const uint8_t* vidx;
  const void* table;
  int n_table, diag_id;
  // tiles of tile_rows rows (a power of two, kernels/plan.py::TILE_ROWS),
  // tile_max the most entries in one from a multiple of tile_rows,
  // max_row the most in a row
  long long tile_rows, tile_max, max_row;
};

template <typename T, int VEC, bool TABLE>
static cudaError_t sweep_dia(const SweepPlan& p, const DiaArgs& a, const T* x,
                             const T* w1, const T* w2, T* y, long long R,
                             long long Rx, long long nb, long long c,
                             typename RealOf<T>::type a2,
                             typename RealOf<T>::type b2, cudaStream_t s) {
  // tile_rows, halved while the staged rows would exceed kDiaOpBytes: a
  // halved tile lies inside one of tile_rows rows, so tile_max bounds it
  long long rows = a.tile_rows, rp_cap, ids_cap, vidx_cap, vals_cap;
  for (;; rows /= 2) {
    const long long n = a.tile_max < rows * a.max_row ? a.tile_max
                                                       : rows * a.max_row;
    rp_cap = staged_capacity((rows + 1) * 4);
    ids_cap = staged_capacity(n);
    vidx_cap = TABLE && a.vidx != nullptr ? staged_capacity(n) : 0;
    vals_cap = staged_capacity((TABLE ? rows : n) * (long long)sizeof(T));
    if (rp_cap + ids_cap + vidx_cap + vals_cap <= kDiaOpBytes || rows == 1)
      break;
  }
  // a tile may hold fewer rows than the CTA's threads cover in one pass
  const Sweep sw = make_sweep(1, R, nb, c, 0, 0, p, (int)rows,
                              rp_cap + ids_cap + vidx_cap + vals_cap);
  const DiaOp<T, VEC, TABLE> op{a.offs, a.rowptr, a.ids,
                                static_cast<const T*>(a.vals), a.vidx,
                                static_cast<const T*>(a.table), a.n_table,
                                a.diag_id, w1, w2, Rx, a2, b2, rp_cap, ids_cap,
                                vidx_cap};
  return run_sweep<T, VEC>(p, op, x, y, sw, s);
}

template <typename T, int VEC>
static cudaError_t sweep_dia(const SweepPlan& p, const DiaArgs& a, const T* x,
                             const T* w1, const T* w2, T* y, long long R,
                             long long Rx, long long nb, long long c,
                             typename RealOf<T>::type a2,
                             typename RealOf<T>::type b2, cudaStream_t s) {
  return a.table != nullptr
             ? sweep_dia<T, VEC, true>(p, a, x, w1, w2, y, R, Rx, nb, c, a2,
                                       b2, s)
             : sweep_dia<T, VEC, false>(p, a, x, w1, w2, y, R, Rx, nb, c, a2,
                                        b2, s);
}

template <typename T>
static int launch_cheb_dia(const DiaArgs& a, const void* x_, const void* w1_,
                           const void* w2_, void* y_, long long R,
                           long long Rx, long long nb, long long c,
                           double alpha, double beta, void* stream) {
  if (R == 0 || nb == 0) return (int)cudaGetLastError();
  if (a.offs.n < 0 || a.offs.n > kMaxDiags || c < 1 || c > nb ||
      a.tile_rows < 1 || a.tile_rows > kThreads ||
      (a.tile_rows & (a.tile_rows - 1)) != 0 || a.tile_max < 0 ||
      a.max_row < 0 || a.n_table < 0 || a.n_table > 256)
    return (int)cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(x_);
  const T* w1 = static_cast<const T*>(w1_);
  const T* w2 = static_cast<const T*>(w2_);
  T* y = static_cast<T*>(y_);
  using Real = typename RealOf<T>::type;
  const Real a2 = Real(2.0 * Real(alpha)), b2 = Real(2.0 * Real(beta));
  const SweepPlan p = plan_sweep<T>(
      nb, c, aligned16(x) && aligned16(w1) && aligned16(w2) && aligned16(y));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int VW = 16 / sizeof(T);
  const cudaError_t e =
      p.vec == VW
          ? sweep_dia<T, VW>(p, a, x, w1, w2, y, R, Rx, nb, c, a2, b2, s)
          : sweep_dia<T, 1>(p, a, x, w1, w2, y, R, Rx, nb, c, a2, b2, s);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

static DiaArgs dia_args(const int* offsets, int n_diag, const void* rowptr,
                        const void* ids, const void* vals, const void* vidx,
                        const void* table, int n_table, const void* diag,
                        int diag_id, long long tile_rows, long long tile_max,
                        long long max_row) {
  DiaArgs a;
  a.offs.n = n_diag < 0 ? -1 : (n_diag > kMaxDiags ? kMaxDiags + 1 : n_diag);
  for (int d = 0; d < n_diag && d < kMaxDiags; ++d) a.offs.off[d] = offsets[d];
  a.rowptr = static_cast<const int*>(rowptr);
  a.ids = static_cast<const uint8_t*>(ids);
  a.vals = table != nullptr ? diag : vals;
  a.vidx = static_cast<const uint8_t*>(vidx);
  a.table = table;
  a.n_table = n_table;
  a.diag_id = table != nullptr && diag != nullptr ? diag_id : -1;
  a.tile_rows = tile_rows;
  a.tile_max = tile_max;
  a.max_row = max_row;
  return a;
}

}  // namespace repro_torch

// offsets: host array of n_diag ascending ints (copied into the launch);
// rowptr int32 [R + 1] and ids uint8 [nnz] the compact form
// (kernels/plan.py::CompactDia) with its values: vals [nnz], or a table
// of n_table values indexed by vidx uint8 [nnz] (null: index 0) and the
// main diagonal diag [R] for the entries with id diag_id; tile_max the
// most entries in any tile_rows rows from a multiple of tile_rows (a power
// of two up to 256), max_row in a row;
// x [Rx, nb], w1/w2/y [R, nb] row-major; c the slab width (1 <= c <= nb).
#define CHEB_DIA_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const int* offsets, int n_diag, const void* rowptr,    \
                      const void* ids, const void* vals, const void* vidx,   \
                      const void* table, int n_table, const void* diag,      \
                      int diag_id, long long tile_rows, long long tile_max,  \
                      long long max_row, const void* x, const void* w1,      \
                      const void* w2, void* y, long long R, long long Rx,    \
                      long long nb,                                          \
                      long long c, double alpha, double beta,                \
                      void* stream) {                                        \
    return repro_torch::launch_cheb_dia<T>(                                  \
        repro_torch::dia_args(offsets, n_diag, rowptr, ids, vals, vidx,      \
                              table, n_table, diag, diag_id, tile_rows,      \
                              tile_max, max_row),                            \
        x, w1, w2, y, R, Rx, nb, c, alpha, beta, stream);                   \
  }

CHEB_DIA_ENTRY(cheb_dia_f64, double)
CHEB_DIA_ENTRY(cheb_dia_f32, float)
CHEB_DIA_ENTRY(cheb_dia_c128, repro_torch::c128)
CHEB_DIA_ENTRY(cheb_dia_c64, repro_torch::c64)
