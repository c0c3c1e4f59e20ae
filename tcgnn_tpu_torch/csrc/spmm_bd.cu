// Block-diagonal (BD) SpMM, score-fused SpMM and its one-pass backward over
// the packed diagonal tiles, for Hopper (sm_90a).
//
// Replaces three TPU kernels:
//   * K5, `_bd_plain_kernel` (tcgnn_tpu/ops/spmm.py:813):
//       out[i] = sum_j P[i, j] * x[col(i, j)]
//   * K6, `_bd_sfused_kernel` (tcgnn_tpu/ops/spmm.py:928):
//       out[i] = sum_j P[i, j] * <xl[i], xr[c]> * xv[c],       c = col(i, j)
//   * K7, `_bd_sfused_bwd_kernel` (tcgnn_tpu/ops/spmm.py:1094), one pass
//     giving two sums:
//       dx3[i] = sum_j P[i, j] * (s * dy[c] + (t + w) * x[c])
//       u[i]   = sum_j P[i, j] * s * x[c]
//     with s = <x[i], x[c]>, t = <dy[i], x[c]>, w = <x[i], dy[c]>.
// The pack P is [Bp, bn, K*bn]: row i (bin b = i / bn) holds, side by side,
// the K diagonal tiles' row for bins b + offsets[k], so entry j of row i is
// column col(i, j) = (b + offsets[j / bn]) * bn + j % bn.  Its entries are
// int8 or int16 edge counts, or float or bfloat16 edge weights.
//
// Rounding is the TPU kernels': the pack and the features in the compute
// type, products summed in f32, the score rounded to the compute type
// before it multiplies the pack entry and that product rounded too
// (spmm.py:964, :1128), t + w summed in f32 before its one cast (:1134),
// and every output stored in the compute type (spmm.py:861-865).
//
// The TPU kernels multiply each bin's whole bn x K*bn tile on the MXU, with
// the bin's K neighbour bins of x stacked in VMEM.  On DD the pack is 0.55%
// nonzero (2,624 bins x 128 x 896, 301 MB as int8), so a dense product on
// Hopper would be 99% wasted work, and the halo stack of x (896 rows of up
// to 128 columns, for x and for dy in K7) does not fit a thread block's
// shared memory.  So these kernels are sparse in the pack.
//
// K5.  What bounds it: the pack, read whole whatever it holds (301 MB on
// DD: 0.090 ms at 3.35 TB/s), and then the latency of the gathers, one row
// of x per nonzero (x is 21 MB at d=16, hot in the 50 MB L2).  The design
// (csrc/sparse_row.cuh): a warp owns 4 consecutive rows; it reads a row's
// pack in 16-byte units (a 896-byte int8 row in two loads a lane) with
// streaming loads, the next row's units in flight while the current row is
// gathered; it skips zero 32-bit words with integer compares, compacts the
// nonzeros into a list in shared memory (an exclusive scan of the lanes'
// counts keeps a fixed order), and gathers the listed rows of x with every
// lane busy: groups of d/4 lanes (at least one) each fetch one listed row,
// 4 columns a lane in one 16-byte (f32) or 8-byte (bf16) load, several in
// flight before the first multiply-add.  d is tiled by 128 columns
// (grid.y), so any width runs.  The vector paths need alignment: a pack row
// of K*bn entries that is not a multiple of 16 bytes is read an entry a
// lane, and x rows whose width is not a multiple of 4 are read a column at
// a time, inside the same kernel.
//
// K6 and K7 walk a per-row index of the pack, not the pack: row_ptr over
// the node rows, and for each nonzero its node column (int32) and its value
// in the pack's type, derived on the device from the pack at upload
// (ops/blockdiag.py `bd_row_index`), in the pack's order, which is a row's
// ascending node column.  On DD it is 11 MB where the pack is 301 MB, so
// what bounds them is no longer the pack but the gathers: about 5 neighbour
// rows a node row (x is 43 MB at f32 d=32, mostly in the 50 MB L2), each a
// dependent load after its column.  The design keeps several gathers in
// flight and every lane busy: a lane group of g lanes owns one node row,
// each lane holding 4 consecutive columns (g the least power of two with
// 4 g >= d, so g = 8 at d=32 and g = 1 at d=2, where one lane holds a whole
// row and a warp takes 32 rows); the group reads the columns and values of
// kBatch of its row's nonzeros, then all their neighbour rows (xr, and xv
// when it is not xr, in K6; x and dy in K7) before the first multiply, and
// reduces each dot over its g lanes in log2(g) shuffles, the batch's dots
// (K7: three a nonzero) interleaved.  Each row's sums stay in one group in
// a fixed order: no atomics, the same sums from run to run.  The warp runs
// as many batches as its longest row needs (the other groups idle through
// them), so a dense row (up to 1,024 entries) costs its warp, not the
// launch.  Rows whose width is not a multiple of 4, or not 16-byte
// aligned, are read a column at a time inside the same kernel.  Past d =
// 128 (off the main path) the output is tiled by 128 columns (grid.y) and
// each tile's group, a whole warp, forms the full score over all of d.
//
// What they do not use.  Tensor cores: the TPU kernels' dense bn x K*bn
// tile products would be 99.45% zeros on DD; in true f32 (no TF32, the
// port's contract) K7's six products are about 116 GFLOP a call, 1.7 ms
// at 67 TFLOP/s.  Staging a bin's halo rows in shared memory: K7's x and
// dy halo is 896 rows x 32 x 4 B x 2 = 229 KB at f32 d=32, over the 227 KB
// a block may hold, and a row touches about 5 of the 896, so the L2 serves
// the gathers better.  One thread block of 8 warps; index arithmetic is
// 64-bit (YeastH's pack has 2.01e9 entries).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "sparse_row.cuh"

namespace {

namespace sr = sparse_row;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;  // K5
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kMaxK = 8;
constexpr int kMaxStripe = 1024;  // K * bn

struct Offsets {
  int v[kMaxK];
};

// The warp's rows: row0 + i for i < kRowsPerWarp, while below n.
__device__ __forceinline__ long long warp_row0() {
  return (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5) * kRowsPerWarp;
}

// K5.  grid: (row slabs of kRowsPerBlock, d-tiles of 128 columns).  A warp
// walks its kRowsPerWarp rows, each row's pack units in flight while the
// previous row is gathered.  flags: kVecPack (the vector path over 16-byte
// units of the pack), kVecX (x and out rows 16-byte aligned, d % 4 == 0).
constexpr int kVecPack = 1, kVecX = 2;

// Row `row` of the pack as 16-byte units: u[i] is unit lane + 32 i, zero
// past the row.
template <typename PackT, int kU>
__device__ __forceinline__ void load_pack_units(uint4 (&u)[kU], const PackT* pack, long long row,
                                                int stripe) {
  constexpr int E = 16 / sizeof(PackT);
  const int lane = threadIdx.x & 31;
  const uint4* units = reinterpret_cast<const uint4*>(pack + row * stripe);
  const int nunits = stripe / E;
#pragma unroll
  for (int i = 0; i < kU; ++i) {
    const int idx = lane + 32 * i;
    u[i] = idx < nunits ? __ldg(units + idx) : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename FeatT, typename PackT>
__global__ void __launch_bounds__(kThreads)
spmm_bd_kernel(const FeatT* __restrict__ x, const PackT* __restrict__ pack, Offsets offs,
               FeatT* __restrict__ out, int n, int d, int k, int bn, int flags) {
  namespace sr = sparse_row;
  constexpr int E = 16 / sizeof(PackT);  // pack entries of a 16-byte unit
  constexpr int kU = sr::kRowElems / E / 32;
  __shared__ int s_idx[kWarps][sr::kList];
  __shared__ int s_offs[kMaxK];
  if (threadIdx.x < kMaxK) s_offs[threadIdx.x] = offs.v[threadIdx.x];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stripe = k * bn;
  const bool vec_pack = flags & kVecPack, vec_x = flags & kVecX;
  const int d0 = blockIdx.y * sr::kTileD;
  const int g = sr::group_lanes(min(d - d0, sr::kTileD));
  const int c0 = d0 + (lane % g) * sr::kVec;
  const long long row0 = warp_row0();
  const long long row_end = min(row0 + kRowsPerWarp, (long long)n);
  uint4 next[kU];
  if (vec_pack && row0 < row_end) load_pack_units<PackT>(next, pack, row0, stripe);
  for (long long row = row0; row < row_end; ++row) {
    const long long b = row / bn;
    const PackT* prow = pack + row * stripe;
    // Entry j of the row: column (b + offsets[j / bn]) * bn + j % bn (a stray
    // entry outside the graph, zero in any pack the graph builds, reads as 0).
    auto entry = [&](int j, int& col, float& val) {
      const int kk = j / bn;
      const long long c = (b + s_offs[kk]) * bn + (j - kk * bn);
      const bool in = c >= 0 && c < n;
      col = in ? (int)c : 0;
      val = in ? sr::round_to<FeatT>(sr::to_f32(prow[j])) : 0.f;
    };
    unsigned mask = 0;
    float acc[sr::kVec];
    if (vec_pack) {
      // Bit i * E + e of the lane is entry (lane + 32 i) * E + e of the row.
#pragma unroll
      for (int i = 0; i < kU; ++i) {
        const uint4 u = next[i];
        if (u.x | u.y | u.z | u.w) mask |= sr::unit_mask<PackT, FeatT>(u) << (i * E);
      }
      if (row + 1 < row_end) load_pack_units<PackT>(next, pack, row + 1, stripe);
      sr::reduce_row(acc, mask, s_idx[warp],
                     [&](int bit) { return (lane + 32 * (bit / E)) * E + bit % E; }, entry,
                     x, d, c0, g, vec_x);
    } else {
      // Bit q of the lane is entry lane + 32 q of the row.
#pragma unroll 8
      for (int q = 0; q < 32; ++q) {
        const int j = lane + 32 * q;
        if (j < stripe && sr::round_to<FeatT>(sr::to_f32(prow[j])) != 0.f) mask |= 1u << q;
      }
      sr::reduce_row(acc, mask, s_idx[warp], [&](int bit) { return lane + 32 * bit; }, entry,
                     x, d, c0, g, vec_x);
    }
    if (lane < g) sr::store4(out + row * d, c0, d, acc, vec_x);
  }
}

// ---- K6 and K7: lane groups over the per-row index --------------------------

// Nonzeros a group has in flight, their neighbour rows all loaded before the
// first multiply.  K7 holds two rows a nonzero (x and dy).  Larger batches
// were slower on DD at d=32 (K6 8, K7 4 and up): the registers they hold
// cost more warps a multiprocessor than the loads they add in flight gain.
constexpr int kBatchK6 = 4;
constexpr int kBatchK7 = 2;

// Index value p in the compute type.  val_kind as pack_kind: 0 = int8,
// 1 = float, 2 = bfloat16, 3 = int16 (one branch on one value for the whole
// launch, instead of a kernel per pack type).
template <typename FeatT>
__device__ __forceinline__ float index_value(const void* __restrict__ vals, int val_kind,
                                             long long p) {
  float v;
  switch (val_kind) {
    case 0:
      v = sr::to_f32(static_cast<const int8_t*>(vals)[p]);
      break;
    case 1:
      v = static_cast<const float*>(vals)[p];
      break;
    case 2:
      v = sr::to_f32(static_cast<const __nv_bfloat16*>(vals)[p]);
      break;
    default:
      v = sr::to_f32(static_cast<const int16_t*>(vals)[p]);
  }
  return sr::round_to<FeatT>(v);
}

// The lane's group: g lanes (a power of two) own node row `row` (its own
// row, or -1 past n), whose nonzeros are [beg, end) of the index; the lane
// holds the 4 columns from `cl` of each 128-column tile, `c0` of the
// block's tile (grid.y).
struct Group {
  int row, cl, c0;
  long long beg, end;
};

__device__ __forceinline__ Group group_of(const long long* __restrict__ row_ptr, int n, int g) {
  const int lane = threadIdx.x & 31;
  const long long row = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * (32 / g) + lane / g;
  Group q;
  q.row = row < n ? (int)row : -1;
  q.cl = (lane % g) * sr::kVec;
  q.c0 = blockIdx.y * sr::kTileD + q.cl;
  q.beg = q.row >= 0 ? row_ptr[q.row] : 0;
  q.end = q.row >= 0 ? row_ptr[q.row + 1] : 0;
  return q;
}

// Columns [c0, c0 + 4) of row r of x; zeros for r < 0.
template <typename FeatT>
__device__ __forceinline__ void load_row4(float (&v)[sr::kVec], const FeatT* __restrict__ x,
                                          int r, int c0, int d, bool vec) {
  if (r >= 0) {
    sr::load4(v, x + (long long)r * d, c0, d, vec);
  } else {
#pragma unroll
    for (int c = 0; c < sr::kVec; ++c) v[c] = 0.f;
  }
}

__device__ __forceinline__ float dot4(const float (&a)[sr::kVec], const float (&b)[sr::kVec]) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < sr::kVec; ++c) s = fmaf(a[c], b[c], s);
  return s;
}

// Each s[i] summed over the group's g lanes by xor butterflies (every lane
// of the group ends with the same bits), the kN sums' shuffles interleaved.
template <int kN>
__device__ __forceinline__ void group_sum(float (&s)[kN], int g) {
  for (int off = 1; off < g; off <<= 1)
#pragma unroll
    for (int i = 0; i < kN; ++i) s[i] += __shfl_xor_sync(sr::kFull, s[i], off);
}

// The columns and values of the kB nonzeros from index position p0 on (-1
// and 0 past the row).
template <typename FeatT, int kB>
__device__ __forceinline__ void load_batch(int (&col)[kB], float (&a)[kB], const Group& q,
                                           long long p0, const int* __restrict__ cols,
                                           const void* __restrict__ vals, int val_kind) {
#pragma unroll
  for (int i = 0; i < kB; ++i) {
    const long long p = p0 + i;
    const bool in = p < q.end;
    col[i] = in ? cols[p] : -1;
    a[i] = in ? index_value<FeatT>(vals, val_kind, p) : 0.f;
  }
}

// Batches the warp runs: as many as its longest row needs.
__device__ __forceinline__ int warp_most(const Group& q) {
  return (int)__reduce_max_sync(sr::kFull, (unsigned)(q.end - q.beg));
}

// K6.  grid: (row blocks of 8 * 32 / g rows, d-tiles of 128 columns; one
// unless kWide).  kShare: xv is xr, whose rows are then read once (the
// narrow kernel only).  vec: d % 4 == 0 and every row 16-byte aligned.
template <typename FeatT, bool kShare, bool kWide>
__global__ void __launch_bounds__(kThreads)
bd_sfused_kernel(const FeatT* __restrict__ xl, const FeatT* __restrict__ xr,
                 const FeatT* __restrict__ xv, const long long* __restrict__ row_ptr,
                 const int* __restrict__ cols, const void* __restrict__ vals, int val_kind,
                 FeatT* __restrict__ out, int n, int d, int g, bool vec) {
  constexpr int kB = kBatchK6;
  const Group q = group_of(row_ptr, n, g);
  const int most = warp_most(q);
  float own[sr::kVec], acc[sr::kVec];
  if (!kWide) load_row4(own, xl, q.row, q.c0, d, vec);
#pragma unroll
  for (int c = 0; c < sr::kVec; ++c) acc[c] = 0.f;
  for (int e = 0; e < most; e += kB) {
    int col[kB];
    float a[kB], s[kB], vr[kB][sr::kVec], vv[kB][sr::kVec];
    load_batch<FeatT, kB>(col, a, q, q.beg + e, cols, vals, val_kind);
    if constexpr (!kWide) {
#pragma unroll
      for (int i = 0; i < kB; ++i) load_row4(vr[i], xr, col[i], q.c0, d, vec);
      if (!kShare) {
#pragma unroll
        for (int i = 0; i < kB; ++i) load_row4(vv[i], xv, col[i], q.c0, d, vec);
      }
#pragma unroll
      for (int i = 0; i < kB; ++i) s[i] = dot4(own, vr[i]);
    } else {
      // The score over all of d, a 128-column tile at a time; then this
      // block's tile of xv.
#pragma unroll
      for (int i = 0; i < kB; ++i) s[i] = 0.f;
      for (int t = q.cl; t < d; t += sr::kTileD) {
        load_row4(own, xl, q.row, t, d, vec);
#pragma unroll
        for (int i = 0; i < kB; ++i) load_row4(vr[i], xr, col[i], t, d, vec);
#pragma unroll
        for (int i = 0; i < kB; ++i) s[i] += dot4(own, vr[i]);
      }
#pragma unroll
      for (int i = 0; i < kB; ++i) load_row4(vv[i], xv, col[i], q.c0, d, vec);
    }
    group_sum<kB>(s, g);
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      if (col[i] < 0) continue;
      const float w = sr::round_to<FeatT>(a[i] * sr::round_to<FeatT>(s[i]));
#pragma unroll
      for (int c = 0; c < sr::kVec; ++c)
        acc[c] = fmaf(w, (kShare && !kWide) ? vr[i][c] : vv[i][c], acc[c]);
    }
  }
  if (q.row >= 0) sr::store4(out + (long long)q.row * d, q.c0, d, acc, vec);
}

// K7.  grid and vec as K6's.  Per nonzero: s = <x[i], x[c]>,
// t = <dy[i], x[c]>, w = <x[i], dy[c]>, the three sums' shuffles
// interleaved; then cs = a s and h = a (t + w) in the compute type,
// dx3[i] += cs dy[c] + h x[c] and u[i] += cs x[c].
template <typename FeatT, bool kWide>
__global__ void __launch_bounds__(kThreads)
bd_sfused_bwd_kernel(const FeatT* __restrict__ x, const FeatT* __restrict__ dy,
                     const long long* __restrict__ row_ptr, const int* __restrict__ cols,
                     const void* __restrict__ vals, int val_kind, FeatT* __restrict__ dx3,
                     FeatT* __restrict__ u, int n, int d, int g, bool vec) {
  constexpr int kB = kBatchK7;
  const Group q = group_of(row_ptr, n, g);
  const int most = warp_most(q);
  float x_r[sr::kVec], dy_r[sr::kVec], acc_dx[sr::kVec], acc_u[sr::kVec];
  if (!kWide) {
    load_row4(x_r, x, q.row, q.c0, d, vec);
    load_row4(dy_r, dy, q.row, q.c0, d, vec);
  }
#pragma unroll
  for (int c = 0; c < sr::kVec; ++c) acc_dx[c] = acc_u[c] = 0.f;
  for (int e = 0; e < most; e += kB) {
    int col[kB];
    // s[i], s[kB + i], s[2 kB + i]: nonzero i's s, t and w.
    float a[kB], s[3 * kB], xv[kB][sr::kVec], dv[kB][sr::kVec];
    load_batch<FeatT, kB>(col, a, q, q.beg + e, cols, vals, val_kind);
#pragma unroll
    for (int i = 0; i < 3 * kB; ++i) s[i] = 0.f;
    // The neighbours' columns from t, and their three partial dots.
    auto dots = [&](int t) {
#pragma unroll
      for (int i = 0; i < kB; ++i) load_row4(xv[i], x, col[i], t, d, vec);
#pragma unroll
      for (int i = 0; i < kB; ++i) load_row4(dv[i], dy, col[i], t, d, vec);
#pragma unroll
      for (int i = 0; i < kB; ++i) {
        s[i] += dot4(x_r, xv[i]);
        s[kB + i] += dot4(dy_r, xv[i]);
        s[2 * kB + i] += dot4(x_r, dv[i]);
      }
    };
    if constexpr (!kWide) {
      dots(q.c0);
    } else {
      // The sums over all of d, a 128-column tile at a time; then this
      // block's tile of x and dy.
      for (int t = q.cl; t < d; t += sr::kTileD) {
        load_row4(x_r, x, q.row, t, d, vec);
        load_row4(dy_r, dy, q.row, t, d, vec);
        dots(t);
      }
#pragma unroll
      for (int i = 0; i < kB; ++i) load_row4(xv[i], x, col[i], q.c0, d, vec);
#pragma unroll
      for (int i = 0; i < kB; ++i) load_row4(dv[i], dy, col[i], q.c0, d, vec);
    }
    group_sum<3 * kB>(s, g);
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      if (col[i] < 0) continue;
      const float cs = sr::round_to<FeatT>(a[i] * sr::round_to<FeatT>(s[i]));
      const float h = sr::round_to<FeatT>(a[i] * sr::round_to<FeatT>(s[kB + i] + s[2 * kB + i]));
#pragma unroll
      for (int c = 0; c < sr::kVec; ++c) {
        acc_dx[c] = fmaf(cs, dv[i][c], fmaf(h, xv[i][c], acc_dx[c]));
        acc_u[c] = fmaf(cs, xv[i][c], acc_u[c]);
      }
    }
  }
  if (q.row >= 0) {
    sr::store4(dx3 + (long long)q.row * d, q.c0, d, acc_dx, vec);
    sr::store4(u + (long long)q.row * d, q.c0, d, acc_u, vec);
  }
}

// ---- launches ----------------------------------------------------------------

unsigned row_blocks(int n) { return (unsigned)((n + kRowsPerBlock - 1) / kRowsPerBlock); }

struct PackArgs {
  const void *x, *pack;
  void* out;
  Offsets offs;
  int n, d, k, bn, pack_kind;
};

template <typename FeatT, typename PackT>
int launch_spmm(const PackArgs& a, cudaStream_t s) {
  constexpr int E = 16 / sizeof(PackT);
  int flags = 0;
  if ((a.k * a.bn) % E == 0 && sparse_row::aligned16(a.pack)) flags |= kVecPack;
  if (a.d % 4 == 0 && sparse_row::aligned16(a.x) && sparse_row::aligned16(a.out)) flags |= kVecX;
  const dim3 grid(row_blocks(a.n), (unsigned)((a.d + sparse_row::kTileD - 1) / sparse_row::kTileD));
  spmm_bd_kernel<FeatT, PackT><<<grid, kThreads, 0, s>>>(
      static_cast<const FeatT*>(a.x), static_cast<const PackT*>(a.pack), a.offs,
      static_cast<FeatT*>(a.out), a.n, a.d, a.k, a.bn, flags);
  return (int)cudaGetLastError();
}

int spmm_dispatch(int feat_kind, PackArgs a, const int* offsets, void* stream) {
  if (a.n < 1 || a.d < 1 || a.k < 1 || a.k > kMaxK || a.bn < 1 || a.k * a.bn > kMaxStripe ||
      a.pack_kind < 0 || a.pack_kind > 3 || feat_kind < 0 || feat_kind > 1)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < kMaxK; ++i) a.offs.v[i] = i < a.k ? offsets[i] : 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = feat_kind == 1;
  switch (a.pack_kind) {
    case 0:
      return bf16 ? launch_spmm<__nv_bfloat16, int8_t>(a, s) : launch_spmm<float, int8_t>(a, s);
    case 1:
      return bf16 ? launch_spmm<__nv_bfloat16, float>(a, s) : launch_spmm<float, float>(a, s);
    case 2:
      return bf16 ? launch_spmm<__nv_bfloat16, __nv_bfloat16>(a, s)
                  : launch_spmm<float, __nv_bfloat16>(a, s);
    default:
      return bf16 ? launch_spmm<__nv_bfloat16, int16_t>(a, s) : launch_spmm<float, int16_t>(a, s);
  }
}

// K6 and K7: xl/x, xr/dy and xv (nullptr: xr) in the compute type; the
// index; out0 (K6 out, K7 dx3) and out1 (K7 u).
struct IndexArgs {
  const void *a, *b, *c, *row_ptr, *cols, *vals;
  void *out0, *out1;
  int n, d, val_kind;
};

// The launch shape of K6/K7: g lanes a row and the d-tiles, and whether the
// rows take 16-byte (f32) or 8-byte (bf16) loads.
struct Shape {
  dim3 grid;
  int g;
  bool wide, vec;
};

Shape shape_of(const IndexArgs& a) {
  Shape sh;
  sh.wide = a.d > sr::kTileD;
  sh.g = sh.wide ? 32 : 1;
  while (!sh.wide && sh.g * sr::kVec < a.d) sh.g <<= 1;
  const int rows = kWarps * (32 / sh.g);
  sh.grid = dim3((unsigned)((a.n + rows - 1) / rows),
                 sh.wide ? (unsigned)((a.d + sr::kTileD - 1) / sr::kTileD) : 1u);
  sh.vec = a.d % sr::kVec == 0;
  for (const void* p : {a.a, a.b, a.c, (const void*)a.out0, (const void*)a.out1})
    if (p != nullptr && !sr::aligned16(p)) sh.vec = false;
  return sh;
}

template <typename FeatT>
int launch_index(bool bwd, const IndexArgs& a, cudaStream_t s) {
  const Shape sh = shape_of(a);
  const FeatT* fa = static_cast<const FeatT*>(a.a);
  const FeatT* fb = static_cast<const FeatT*>(a.b);
  const FeatT* fc = static_cast<const FeatT*>(a.c);
  const long long* rp = static_cast<const long long*>(a.row_ptr);
  const int* cols = static_cast<const int*>(a.cols);
  FeatT* o0 = static_cast<FeatT*>(a.out0);
  if (bwd) {
    const auto kernel = sh.wide ? bd_sfused_bwd_kernel<FeatT, true>
                                : bd_sfused_bwd_kernel<FeatT, false>;
    kernel<<<sh.grid, kThreads, 0, s>>>(fa, fb, rp, cols, a.vals, a.val_kind, o0,
                                        static_cast<FeatT*>(a.out1), a.n, a.d, sh.g, sh.vec);
  } else if (sh.wide) {
    bd_sfused_kernel<FeatT, false, true><<<sh.grid, kThreads, 0, s>>>(
        fa, fb, fc == nullptr ? fb : fc, rp, cols, a.vals, a.val_kind, o0, a.n, a.d, sh.g,
        sh.vec);
  } else {
    const auto kernel = fc == nullptr ? bd_sfused_kernel<FeatT, true, false>
                                      : bd_sfused_kernel<FeatT, false, false>;
    kernel<<<sh.grid, kThreads, 0, s>>>(fa, fb, fc, rp, cols, a.vals, a.val_kind, o0, a.n, a.d,
                                        sh.g, sh.vec);
  }
  return (int)cudaGetLastError();
}

int index_dispatch(bool bwd, int feat_kind, const IndexArgs& a, void* stream) {
  if (a.n < 1 || a.d < 1 || a.val_kind < 0 || a.val_kind > 3) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (feat_kind) {
    case 0:
      return launch_index<float>(bwd, a, s);
    case 1:
      return launch_index<__nv_bfloat16>(bwd, a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K5: out = P @ x over the packed diagonals, [n, d], any d >= 1.  pack:
// [Bp, bn, k*bn] with Bp * bn >= n; pack_kind: 0 = int8, 1 = float,
// 2 = bfloat16, 3 = int16.  offsets: k host ints, 1 <= k <= 8,
// k * bn <= 1024.  feat_kind: 0 = float, 1 = bfloat16, the type of the
// features and of the output.  Each function here returns the cudaError_t
// of the launch (0 = success).
extern "C" int tcgnn_spmm_bd(const void* x, const void* pack, const int* offsets, void* out,
                             int n, int d, int k, int bn, int feat_kind, int pack_kind,
                             void* stream) {
  const PackArgs a{x, pack, out, {}, n, d, k, bn, pack_kind};
  return spmm_dispatch(feat_kind, a, offsets, stream);
}

// K6 and K7 read the pack's per-row index: row_ptr [n + 1] int64; cols and
// vals [row_ptr[n]]: each nonzero's node column (int32, inside the graph)
// and its value, of val_kind (as pack_kind).  feat_kind as K5's.  Any
// d >= 1.

// K6: out = (P . (xl @ xr^T)) @ xv, [n, d]; xv == nullptr shares xr.
extern "C" int tcgnn_bd_sfused(const void* xl, const void* xr, const void* xv,
                               const void* row_ptr, const void* cols, const void* vals,
                               void* out, int n, int d, int feat_kind, int val_kind,
                               void* stream) {
  const IndexArgs a{xl, xr, xv, row_ptr, cols, vals, out, nullptr, n, d, val_kind};
  return index_dispatch(false, feat_kind, a, stream);
}

// K7: dx3 and u, both [n, d], from x and dy.
extern "C" int tcgnn_bd_sfused_bwd(const void* x, const void* dy, const void* row_ptr,
                                   const void* cols, const void* vals, void* dx3, void* u,
                                   int n, int d, int feat_kind, int val_kind, void* stream) {
  const IndexArgs a{x, dy, nullptr, row_ptr, cols, vals, dx3, u, n, d, val_kind};
  return index_dispatch(true, feat_kind, a, stream);
}

extern "C" const char* tcgnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
