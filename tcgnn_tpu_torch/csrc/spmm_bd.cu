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
// K6 and K7 keep the design of the first port: a warp reads a pack row into
// registers an entry a lane (lane l holds entries q*32 + l), finds its
// nonzeros by warp ballot, and for each one reads the neighbour's row of x
// from global memory (lane l holds columns l, l + 32, ...), forming each
// score as a warp dot with shuffles, only at the nonzeros.  They need all
// of d for the score, so d <= 128, as the score-fused kernels over SGT
// tiles.  One thread block of 8 warps owns 32 consecutive rows, 4 a warp,
// in all three kernels.  Index arithmetic is 64-bit (YeastH's pack has
// 2.01e9 entries).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sparse_row.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kMaxK = 8;
constexpr int kMaxStripe = 1024;              // K * bn
constexpr int kMaxChunks = kMaxStripe / 32;   // pack-row registers per lane
constexpr int kMaxD = 128;                    // K6/K7: 4 columns a lane

struct Offsets {
  int v[kMaxK];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// A value rounded to the compute type (a no-op for f32).
template <typename T>
__device__ __forceinline__ float round_to(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float pack_f32(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float pack_f32(int16_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float pack_f32(float v) { return v; }
__device__ __forceinline__ float pack_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename FeatT, typename PackT>
__device__ __forceinline__ void load_pack_row_as(float (&a)[kMaxChunks], const PackT* row_ptr,
                                                 int stripe) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < kMaxChunks; ++q) {
    const int j = q * 32 + lane;
    a[q] = j < stripe ? round_to<FeatT>(pack_f32(row_ptr[j])) : 0.f;
  }
}

// Pack row `row` into registers, in the compute type: a[q] is entry
// q * 32 + lane, zero past the stripe.  pack_kind: 0 = int8, 1 = float,
// 2 = bfloat16, 3 = int16 (one branch on one value for the whole launch,
// instead of a kernel per pack type).
template <typename FeatT>
__device__ __forceinline__ void load_pack_row(float (&a)[kMaxChunks], const void* pack,
                                              int pack_kind, long long row, int stripe) {
  const long long base = row * stripe;
  switch (pack_kind) {
    case 0:
      load_pack_row_as<FeatT>(a, static_cast<const int8_t*>(pack) + base, stripe);
      break;
    case 1:
      load_pack_row_as<FeatT>(a, static_cast<const float*>(pack) + base, stripe);
      break;
    case 2:
      load_pack_row_as<FeatT>(a, static_cast<const __nv_bfloat16*>(pack) + base, stripe);
      break;
    default:
      load_pack_row_as<FeatT>(a, static_cast<const int16_t*>(pack) + base, stripe);
  }
}

// Columns [col0, col0 + 32 * kCols) of row `r` of `src` into registers (lane
// holds col0 + lane + 32 c), zero past d.
template <typename FeatT, int kCols>
__device__ __forceinline__ void load_row(float (&dst)[kCols], const FeatT* src, long long r,
                                         int d, int col0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int f = col0 + lane + 32 * c;
    dst[c] = f < d ? to_f32(src[r * d + f]) : 0.f;
  }
}

template <typename FeatT, int kCols>
__device__ __forceinline__ void store_row(FeatT* out, const float (&acc)[kCols], long long r,
                                          int d, int col0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int f = col0 + lane + 32 * c;
    if (f < d) store(out + r * d + f, acc[c]);
  }
}

// The column of pack entry j of a row of bin b, or -1 outside the graph
// (entries there are zero in any pack the graph builds; the check keeps a
// stray one from reading out of bounds).
__device__ __forceinline__ long long pack_col(const Offsets& offs, long long b, int j, int bn,
                                              int n) {
  const int k = j / bn;
  const long long col = (b + offs.v[k]) * bn + (j - k * bn);
  return col >= 0 && col < n ? col : -1;
}

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

// K6.  kShare: xv is xr, whose row is then read once.
template <typename FeatT, int kCols, bool kShare>
__global__ void __launch_bounds__(kThreads)
bd_sfused_kernel(const FeatT* __restrict__ xl, const FeatT* __restrict__ xr,
                 const FeatT* __restrict__ xv, const void* __restrict__ pack, int pack_kind,
                 Offsets offs, FeatT* __restrict__ out, int n, int d, int k, int bn) {
  const int stripe = k * bn;
  const long long row0 = warp_row0();
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const long long row = row0 + i;
    if (row >= n) break;
    float a[kMaxChunks];
    load_pack_row<FeatT>(a, pack, pack_kind, row, stripe);
    float xl_r[kCols], acc[kCols];
    load_row<FeatT, kCols>(xl_r, xl, row, d, 0);
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
    const long long b = row / bn;
#pragma unroll
    for (int q = 0; q < kMaxChunks; ++q) {
      unsigned nz = __ballot_sync(0xffffffffu, a[q] != 0.f);
      while (nz) {
        const int jl = __ffs(nz) - 1;
        nz &= nz - 1;
        const float aj = __shfl_sync(0xffffffffu, a[q], jl);
        const long long col = pack_col(offs, b, q * 32 + jl, bn, n);
        if (col < 0) continue;
        float vr[kCols], vv[kCols];
        load_row<FeatT, kCols>(vr, xr, col, d, 0);
        if (!kShare) load_row<FeatT, kCols>(vv, xv, col, d, 0);
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < kCols; ++c) part = fmaf(xl_r[c], vr[c], part);
        const float w = round_to<FeatT>(aj * round_to<FeatT>(warp_sum(part)));
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[c] = fmaf(w, kShare ? vr[c] : vv[c], acc[c]);
      }
    }
    store_row<FeatT, kCols>(out, acc, row, d, 0);
  }
}

// K7.
template <typename FeatT, int kCols>
__global__ void __launch_bounds__(kThreads)
bd_sfused_bwd_kernel(const FeatT* __restrict__ x, const FeatT* __restrict__ dy,
                     const void* __restrict__ pack, int pack_kind, Offsets offs,
                     FeatT* __restrict__ dx3, FeatT* __restrict__ u, int n, int d, int k, int bn) {
  const int stripe = k * bn;
  const long long row0 = warp_row0();
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const long long row = row0 + i;
    if (row >= n) break;
    float a[kMaxChunks];
    load_pack_row<FeatT>(a, pack, pack_kind, row, stripe);
    float x_r[kCols], dy_r[kCols], acc_dx[kCols], acc_u[kCols];
    load_row<FeatT, kCols>(x_r, x, row, d, 0);
    load_row<FeatT, kCols>(dy_r, dy, row, d, 0);
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_dx[c] = acc_u[c] = 0.f;
    const long long b = row / bn;
#pragma unroll
    for (int q = 0; q < kMaxChunks; ++q) {
      unsigned nz = __ballot_sync(0xffffffffu, a[q] != 0.f);
      while (nz) {
        const int jl = __ffs(nz) - 1;
        nz &= nz - 1;
        const float aj = __shfl_sync(0xffffffffu, a[q], jl);
        const long long col = pack_col(offs, b, q * 32 + jl, bn, n);
        if (col < 0) continue;
        float xv[kCols], dv[kCols];
        load_row<FeatT, kCols>(xv, x, col, d, 0);
        load_row<FeatT, kCols>(dv, dy, col, d, 0);
        float ps = 0.f, pt = 0.f, pw = 0.f;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          ps = fmaf(x_r[c], xv[c], ps);
          pt = fmaf(dy_r[c], xv[c], pt);
          pw = fmaf(x_r[c], dv[c], pw);
        }
        const float s = warp_sum(ps), t = warp_sum(pt), w = warp_sum(pw);
        const float cs = round_to<FeatT>(aj * round_to<FeatT>(s));
        const float g = round_to<FeatT>(aj * round_to<FeatT>(t + w));
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          acc_dx[c] = fmaf(cs, dv[c], fmaf(g, xv[c], acc_dx[c]));
          acc_u[c] = fmaf(cs, xv[c], acc_u[c]);
        }
      }
    }
    store_row<FeatT, kCols>(dx3, acc_dx, row, d, 0);
    store_row<FeatT, kCols>(u, acc_u, row, d, 0);
  }
}

struct Args {
  const void *a, *b, *c, *pack;
  void *out0, *out1;
  Offsets offs;
  int n, d, k, bn, pack_kind;
};

enum class Op { kSpmm, kSfused, kSfusedShare, kSfusedBwd };

unsigned row_blocks(int n) { return (unsigned)((n + kRowsPerBlock - 1) / kRowsPerBlock); }

template <typename FeatT, int kCols>
int launch(Op op, const Args& a, cudaStream_t s) {
  const FeatT* fa = static_cast<const FeatT*>(a.a);
  const FeatT* fb = static_cast<const FeatT*>(a.b);
  FeatT* o0 = static_cast<FeatT*>(a.out0);
  switch (op) {
    case Op::kSpmm:
      break;  // launch_spmm
    case Op::kSfused:
      bd_sfused_kernel<FeatT, kCols, false><<<row_blocks(a.n), kThreads, 0, s>>>(
          fa, fb, static_cast<const FeatT*>(a.c), a.pack, a.pack_kind, a.offs, o0, a.n, a.d,
          a.k, a.bn);
      break;
    case Op::kSfusedShare:
      bd_sfused_kernel<FeatT, kCols, true><<<row_blocks(a.n), kThreads, 0, s>>>(
          fa, fb, fb, a.pack, a.pack_kind, a.offs, o0, a.n, a.d, a.k, a.bn);
      break;
    case Op::kSfusedBwd:
      bd_sfused_bwd_kernel<FeatT, kCols><<<row_blocks(a.n), kThreads, 0, s>>>(
          fa, fb, a.pack, a.pack_kind, a.offs, o0, static_cast<FeatT*>(a.out1), a.n, a.d, a.k,
          a.bn);
      break;
  }
  return (int)cudaGetLastError();
}

template <typename FeatT, typename PackT>
int launch_spmm(const Args& a, cudaStream_t s) {
  constexpr int E = 16 / sizeof(PackT);
  int flags = 0;
  if ((a.k * a.bn) % E == 0 && sparse_row::aligned16(a.pack)) flags |= kVecPack;
  if (a.d % 4 == 0 && sparse_row::aligned16(a.a) && sparse_row::aligned16(a.out0)) flags |= kVecX;
  const dim3 grid(row_blocks(a.n), (unsigned)((a.d + sparse_row::kTileD - 1) / sparse_row::kTileD));
  spmm_bd_kernel<FeatT, PackT><<<grid, kThreads, 0, s>>>(
      static_cast<const FeatT*>(a.a), static_cast<const PackT*>(a.pack), a.offs,
      static_cast<FeatT*>(a.out0), a.n, a.d, a.k, a.bn, flags);
  return (int)cudaGetLastError();
}

// Columns a lane holds in K6/K7 (d <= 128).
template <typename FeatT>
int launch_cols(Op op, const Args& a, cudaStream_t s) {
  if (op == Op::kSpmm) {
    switch (a.pack_kind) {
      case 0:
        return launch_spmm<FeatT, int8_t>(a, s);
      case 1:
        return launch_spmm<FeatT, float>(a, s);
      case 2:
        return launch_spmm<FeatT, __nv_bfloat16>(a, s);
      default:
        return launch_spmm<FeatT, int16_t>(a, s);
    }
  }
  if (a.d <= 32) return launch<FeatT, 1>(op, a, s);
  if (a.d <= 64) return launch<FeatT, 2>(op, a, s);
  if (a.d <= 96) return launch<FeatT, 3>(op, a, s);
  return launch<FeatT, 4>(op, a, s);
}

int dispatch(Op op, int feat_kind, Args a, const int* offsets, void* stream) {
  if (a.n < 1 || a.d < 1 || a.k < 1 || a.k > kMaxK || a.bn < 1 || a.k * a.bn > kMaxStripe ||
      a.pack_kind < 0 || a.pack_kind > 3 || (op != Op::kSpmm && a.d > kMaxD))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < kMaxK; ++i) a.offs.v[i] = i < a.k ? offsets[i] : 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (feat_kind) {
    case 0:
      return launch_cols<float>(op, a, s);
    case 1:
      return launch_cols<__nv_bfloat16>(op, a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Common arguments.  pack: [Bp, bn, k*bn] with Bp * bn >= n; pack_kind:
// 0 = int8, 1 = float, 2 = bfloat16, 3 = int16.  offsets: k host ints,
// 1 <= k <= 8, k * bn <= 1024.  feat_kind: 0 = float, 1 = bfloat16, the type
// of the features and of the outputs.  Each returns the cudaError_t of the
// launch (0 = success).

// K5: out = P @ x over the packed diagonals, [n, d], any d >= 1.
extern "C" int tcgnn_spmm_bd(const void* x, const void* pack, const int* offsets, void* out,
                             int n, int d, int k, int bn, int feat_kind, int pack_kind,
                             void* stream) {
  const Args a{x, nullptr, nullptr, pack, out, nullptr, {}, n, d, k, bn, pack_kind};
  return dispatch(Op::kSpmm, feat_kind, a, offsets, stream);
}

// K6: out = (P . (xl @ xr^T)) @ xv, [n, d], d <= 128; xv == nullptr shares xr.
extern "C" int tcgnn_bd_sfused(const void* xl, const void* xr, const void* xv, const void* pack,
                               const int* offsets, void* out, int n, int d, int k, int bn,
                               int feat_kind, int pack_kind, void* stream) {
  const Args a{xl, xr, xv, pack, out, nullptr, {}, n, d, k, bn, pack_kind};
  return dispatch(xv == nullptr ? Op::kSfusedShare : Op::kSfused, feat_kind, a, offsets,
                  stream);
}

// K7: dx3 and u, both [n, d], from x and dy, d <= 128.
extern "C" int tcgnn_bd_sfused_bwd(const void* x, const void* dy, const void* pack,
                                   const int* offsets, void* dx3, void* u, int n, int d, int k,
                                   int bn, int feat_kind, int pack_kind, void* stream) {
  const Args a{x, dy, nullptr, pack, dx3, u, {}, n, d, k, bn, pack_kind};
  return dispatch(Op::kSfusedBwd, feat_kind, a, offsets, stream);
}

extern "C" const char* tcgnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
