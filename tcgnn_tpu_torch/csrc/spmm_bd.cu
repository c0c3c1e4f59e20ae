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
// shared memory.  So these kernels are sparse in the pack: a warp reads a
// pack row into registers (lane l holds entries q*32 + l), finds its
// nonzeros by warp ballot, and for each one reads the neighbour's row of x
// from global memory (lane l holds columns l, l + 32, ...; the rows of
// nearby bins are hot in L2), as the score-fused kernels over SGT tiles do
// (csrc/spmm_sfused.cu).  K6 and K7 form each score as a warp dot with
// shuffles, only at the nonzeros.
//
// What bounds them: K5 reads the whole pack whatever it holds (301 MB on
// DD, at least 0.09 ms at 3.35 TB/s), and each nonzero costs a dependent
// row read from L2.  One thread block of 8 warps owns 32 consecutive rows,
// 4 a warp; K5 also splits d into tiles of up to 128 columns (grid.y), so
// any width runs; K6 and K7 need all of d for the score, so d <= 128, as the
// score-fused kernels over SGT tiles.  Index arithmetic is 64-bit (YeastH's
// pack has 2.01e9 entries).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// K5.  grid: (row slabs of kRowsPerBlock, column tiles of 32 * kCols).
template <typename FeatT, int kCols>
__global__ void __launch_bounds__(kThreads)
spmm_bd_kernel(const FeatT* __restrict__ x, const void* __restrict__ pack, int pack_kind,
               Offsets offs, FeatT* __restrict__ out, int n, int d, int k, int bn) {
  const int stripe = k * bn;
  const int col0 = blockIdx.y * 32 * kCols;
  const long long row0 = warp_row0();
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const long long row = row0 + i;
    if (row >= n) break;
    float a[kMaxChunks];
    load_pack_row<FeatT>(a, pack, pack_kind, row, stripe);
    const long long b = row / bn;
    float acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxChunks; ++q) {
      unsigned nz = __ballot_sync(0xffffffffu, a[q] != 0.f);
      while (nz) {
        const int jl = __ffs(nz) - 1;
        nz &= nz - 1;
        const float aj = __shfl_sync(0xffffffffu, a[q], jl);
        const long long col = pack_col(offs, b, q * 32 + jl, bn, n);
        if (col < 0) continue;
        float v[kCols];
        load_row<FeatT, kCols>(v, x, col, d, col0);
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[c] = fmaf(aj, v[c], acc[c]);
      }
    }
    store_row<FeatT, kCols>(out, acc, row, d, col0);
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
    case Op::kSpmm: {
      const dim3 grid(row_blocks(a.n), (unsigned)((a.d + 32 * kCols - 1) / (32 * kCols)));
      spmm_bd_kernel<FeatT, kCols>
          <<<grid, kThreads, 0, s>>>(fa, a.pack, a.pack_kind, a.offs, o0, a.n, a.d, a.k, a.bn);
      break;
    }
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

// Columns a lane holds: K5 tiles d by 128, so d > 96 takes 4.
template <typename FeatT>
int launch_cols(Op op, const Args& a, cudaStream_t s) {
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
