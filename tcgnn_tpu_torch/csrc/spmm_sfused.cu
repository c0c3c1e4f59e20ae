// Score-fused SpMM (AGNN aggregation) and its one-pass backward over the
// per-row index of SGT-condensed tiles, for Hopper (sm_90a).
//
// Replaces two TPU kernels together with the XLA row gathers in front of
// them:
//   * `_spmm_sfused_kernel` (tcgnn_tpu/ops/spmm.py:1335), forward:
//       out[i] = sum_j A[i, j] * <xl[i], xr[j]> * xv[j]
//   * `_spmm_sfused_bwd_kernel` (tcgnn_tpu/ops/spmm.py:1487), backward, one
//     pass giving two sums:
//       dx3[i] = sum_j A[i, j] * (s_ij * dy[j] + (t_ij + w_ij) * x[j])
//       u[i]   = sum_j A[i, j] * s_ij * x[j]
//     with s_ij = <xw[i], x[j]>, t_ij = <dyw[i], x[j]>, w_ij = <xw[i], dy[j]>:
//     the window rows (i) come from xw and dyw, which are x and dy on one
//     device and a shard's own and guest-window rows on the distributed
//     split stream, while the gathers (j) read x and dy (its halo slabs).
// Both outputs are f32.  The compute type is rounded where the TPU kernels
// round: the score to the compute type before it multiplies the tile entry,
// the product in the compute type (`a * s.astype(ct)`, spmm.py:1355,
// :1515), and t + w summed in f32 before its one cast (spmm.py:1519).
//
// The TPU kernels form the whole blk_h x blk_w score tile of each TC block
// in VMEM.  The tiles are 0.37% full on pubmed at 512x128 (81,120 nonzeros
// in 334 blocks), so these kernels read neither the tiles nor the score
// tiles but the tiles' per-row index, derived from them on the device at
// upload (ops/sfused.py `sgt_row_index`): for each nonzero, in row order,
// its window row (int32), its gathered row (int32) and its tile value (the
// tiles' type: int8 counts, or f32 / bf16).
//
// What bounds them: latency, not bytes or flops (both under 3.5 us on
// pubmed at d=32).  Each nonzero is a chain: its index entry, then the rows
// it gathers (xr and xv; x and dy), mostly from L2, then a dot product
// reduced across lanes.  The tile walk this file held before (a thread
// block per run of 8 TC blocks of a window and 32 of its rows, a warp a
// row) walked a row's nonzeros one after another, each behind a 5-shuffle
// warp reduction, so pubmed's hub row (degree 17,058, all in one slab of
// one window) cost one warp about 1,000 dependent steps in each of its
// window's 17 runs: that set the pace, 0.21 ms (K2) and 0.27 ms (K3) a call
// at any width.  On DD's block-diagonal residual (20,966 nonzeros over
// 334,925 rows) it read 45.6 MB of tiles and two barriers a tile for about
// one nonzero a 32-row slab.  The design here:
//   * equal nonzero ranges (as K8/K9, csrc/chunk.cu): lane group i takes the
//     index's nonzeros [i * P, (i + 1) * P), P a power of two from 8 (from
//     the nonzero count: enough groups to give every multiprocessor about
//     16 warps), so the hub spreads over a thousand groups and a graph of
//     mostly empty rows costs its nonzeros, not its rows.  Each nonzero
//     carries its row, so no group searches row_ptr;
//   * lane groups (as K6/K7, csrc/spmm_bd.cu): g lanes (the least power of
//     two with 4 g >= d, so g = 8 at d=32 and g = 1 at d <= 4) hold 4
//     columns a lane; a group reads a batch of its nonzeros' rows, columns
//     and values, then all their window rows and gathered rows, before the
//     first multiply, and reduces each dot in log2(g) shuffles, the batch's
//     dots (three a nonzero in K3) interleaved.  The window row is read
//     again for each nonzero (an L1 hit when the row repeats): that costs
//     registers, not a branch on every row change;
//   * every group of a warp runs the same number of batches (P / batch), so
//     the shuffles take the whole warp; the warp's last range may be short,
//     its missing nonzeros read as none;
//   * a row's sum stays in registers until the range leaves the row, then
//     is stored once; a row cut by a range boundary (only a range's first
//     and last row can be) is added with f32 atomics, summed across the
//     warp's groups first where they all end in one row (the hub: its
//     atomics queued at one L2 line: 0.011 of K2's 0.021 ms on pubmed at
//     d=32 without it, PERF.md section 6).  The outputs are
//     zeroed first (cudaMemsetAsync), since rows without nonzeros are never
//     visited.  Rows wholly inside a range repeat bit for bit from run to
//     run; a row cut into three parts or more may not (its atomics land in
//     any order).
// Past d = 128 (off the main path, which runs d = 32 and the class count)
// the output is tiled by 128 columns (grid.y) and each tile's group, a
// whole warp, forms the full scores over all of d.  Rows whose width is not
// a multiple of 4, or not 16-byte aligned, are read a column at a time
// inside the same kernel.  Tensor cores stay out, as in csrc/spmm_bd.cu:
// the tiles are 0.37% full, and the port's f32 is true f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "sparse_row.cuh"

namespace {

namespace sr = sparse_row;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// Nonzeros a group has in flight, their rows all loaded before the first
// multiply: K6/K7's batches (csrc/spmm_bd.cu), whose registers hold as many
// window rows again here.
constexpr int kBatchFwd = 4;
constexpr int kBatchBwd = 2;

// Nonzeros a lane group takes: enough groups for about 16 warps on each of
// the 132 multiprocessors, in 8 to 256 nonzeros (a power of two, so a
// multiple of either batch).  Measured on pubmed and DD's residual (PERF.md
// section 6): ranges of 32 and 64 were slower, and 8 beat 16 on DD's
// residual, whose 20,966 nonzeros fill few multiprocessors.
int range_len(long long nnz, int groups_per_warp) {
  const long long target = nnz / (132LL * 16 * groups_per_warp);
  int p = 8;
  while (p < 256 && p < target) p <<= 1;
  return p;
}

// Index value p in the compute type.  val_kind: 0 = int8, 1 = float,
// 2 = bfloat16 (one branch on one value for the whole launch, instead of a
// kernel per tile type).
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
    default:
      v = sr::to_f32(static_cast<const __nv_bfloat16*>(vals)[p]);
  }
  return sr::round_to<FeatT>(v);
}

// Whether the warp's groups all lie past the index (the whole warp returns).
__device__ __forceinline__ bool warp_done(long long nnz, int per, int g) {
  const long long grp0 = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * (32 / g);
  return grp0 * per >= nnz;
}

// The lane's group: its nonzeros [e0, e1) of the index (empty past nnz);
// the rows of its first and last nonzero (-1: none) and whether each has
// nonzeros outside the range (is cut); the lane's 4 columns from `cl` of
// each 128-column tile, `c0` of the block's tile (grid.y).
struct Range {
  long long e0, e1;
  int first, last;
  bool first_cut, last_cut;
  int cl, c0;
};

__device__ __forceinline__ Range range_of(const int* __restrict__ rows, long long nnz, int per,
                                          int g) {
  const int lane = threadIdx.x & 31;
  const long long grp =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * (32 / g) + lane / g;
  Range q;
  q.e0 = min(grp * per, nnz);
  q.e1 = min(q.e0 + per, nnz);
  const bool any = q.e0 < q.e1;
  q.first = any ? __ldg(rows + q.e0) : -1;
  q.last = any ? __ldg(rows + q.e1 - 1) : -1;
  q.first_cut = any && q.e0 > 0 && __ldg(rows + q.e0 - 1) == q.first;
  q.last_cut = any && q.e1 < nnz && __ldg(rows + q.e1) == q.last;
  q.cl = (lane % g) * sr::kVec;
  q.c0 = blockIdx.y * sr::kTileD + q.cl;
  return q;
}

// The rows, gathered rows and values of the kB nonzeros from index position
// p0 on (-1, -1 and 0 past the range).
template <typename FeatT, int kB>
__device__ __forceinline__ void load_batch(int (&r)[kB], int (&col)[kB], float (&a)[kB],
                                           const Range& q, long long p0,
                                           const int* __restrict__ rows,
                                           const int* __restrict__ cols,
                                           const void* __restrict__ vals, int val_kind) {
#pragma unroll
  for (int i = 0; i < kB; ++i) {
    const long long p = p0 + i;
    const bool in = p < q.e1;
    r[i] = in ? __ldg(rows + p) : -1;
    col[i] = in ? __ldg(cols + p) : -1;
    a[i] = in ? index_value<FeatT>(vals, val_kind, p) : 0.f;
  }
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

// Row `row`'s sums for the lane's columns into out: stored, or added with
// atomics where the row is cut by the range's ends.
__device__ __forceinline__ void flush(float* out, int row, const Range& q, int d,
                                      const float (&acc)[sr::kVec], bool vec) {
  float* dst = out + (long long)row * d;
  if ((row == q.first && q.first_cut) || (row == q.last && q.last_cut))
    sr::atomic_add4(dst, q.c0, d, acc);
  else
    sr::store4(dst, q.c0, d, acc, vec);
}

// The sums a group holds at the end of its range, for row `cur`, into out.
// Where every group of the warp ends in the same row (a row, such as
// pubmed's hub, that spans the warp's ranges), the groups' sums are added
// across the warp first and its first group adds them with one atomic a
// column, not one a group: same-row atomics from many ranges queue at one
// L2 line.  Called by the whole warp.
template <int kN>
__device__ __forceinline__ void flush_last(float* const (&out)[kN], int cur, const Range& q,
                                           int d, float (&acc)[kN][sr::kVec], int g, bool vec) {
  const int cur0 = __shfl_sync(sr::kFull, cur, 0);
  if (g < 32 && __all_sync(sr::kFull, cur == cur0) && cur0 >= 0) {
    for (int off = g; off < 32; off <<= 1)
#pragma unroll
      for (int o = 0; o < kN; ++o)
#pragma unroll
        for (int c = 0; c < sr::kVec; ++c) acc[o][c] += __shfl_xor_sync(sr::kFull, acc[o][c], off);
    if ((int)(threadIdx.x & 31) < g)
#pragma unroll
      for (int o = 0; o < kN; ++o) sr::atomic_add4(out[o] + (long long)cur0 * d, q.c0, d, acc[o]);
  } else if (cur >= 0) {
#pragma unroll
    for (int o = 0; o < kN; ++o) flush(out[o], cur, q, d, acc[o], vec);
  }
}

__device__ __forceinline__ void zero4(float (&acc)[sr::kVec]) {
#pragma unroll
  for (int c = 0; c < sr::kVec; ++c) acc[c] = 0.f;
}

// K2.  grid: (blocks of 8 warps of 32 / g ranges, d-tiles of 128 columns;
// one unless kWide).  kShare: xv is xr, whose rows are then read once (the
// narrow kernel only).  vec: d % 4 == 0 and every row 16-byte aligned.
template <typename FeatT, bool kShare, bool kWide>
__global__ void __launch_bounds__(kThreads)
sfused_kernel(const FeatT* __restrict__ xl, const FeatT* __restrict__ xr,
              const FeatT* __restrict__ xv, const int* __restrict__ rows,
              const int* __restrict__ cols, const void* __restrict__ vals, int val_kind,
              float* __restrict__ out, long long nnz, int d, int per, int g, bool vec) {
  constexpr int kB = kBatchFwd;
  if (warp_done(nnz, per, g)) return;
  const Range q = range_of(rows, nnz, per, g);
  float acc[1][sr::kVec];
  zero4(acc[0]);
  int cur = -1;
  for (int t = 0; t < per; t += kB) {
    int r[kB], col[kB];
    float a[kB], s[kB], own[kB][sr::kVec], vr[kB][sr::kVec], vv[kB][sr::kVec];
    load_batch<FeatT, kB>(r, col, a, q, q.e0 + t, rows, cols, vals, val_kind);
    if constexpr (!kWide) {
#pragma unroll
      for (int i = 0; i < kB; ++i) load_row4(own[i], xl, r[i], q.c0, d, vec);
#pragma unroll
      for (int i = 0; i < kB; ++i) load_row4(vr[i], xr, col[i], q.c0, d, vec);
      if (!kShare) {
#pragma unroll
        for (int i = 0; i < kB; ++i) load_row4(vv[i], xv, col[i], q.c0, d, vec);
      }
#pragma unroll
      for (int i = 0; i < kB; ++i) s[i] = dot4(own[i], vr[i]);
    } else {
      // The score over all of d, a 128-column tile at a time; then this
      // block's tile of xv.
#pragma unroll
      for (int i = 0; i < kB; ++i) s[i] = 0.f;
      for (int c = q.cl; c < d; c += sr::kTileD) {
#pragma unroll
        for (int i = 0; i < kB; ++i) load_row4(own[i], xl, r[i], c, d, vec);
#pragma unroll
        for (int i = 0; i < kB; ++i) load_row4(vr[i], xr, col[i], c, d, vec);
#pragma unroll
        for (int i = 0; i < kB; ++i) s[i] += dot4(own[i], vr[i]);
      }
#pragma unroll
      for (int i = 0; i < kB; ++i) load_row4(vv[i], xv, col[i], q.c0, d, vec);
    }
    group_sum<kB>(s, g);
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      if (r[i] < 0) continue;
      if (r[i] != cur) {
        if (cur >= 0) flush(out, cur, q, d, acc[0], vec);
        cur = r[i];
        zero4(acc[0]);
      }
      const float w = sr::round_to<FeatT>(a[i] * sr::round_to<FeatT>(s[i]));
#pragma unroll
      for (int c = 0; c < sr::kVec; ++c)
        acc[0][c] = fmaf(w, (kShare && !kWide) ? vr[i][c] : vv[i][c], acc[0][c]);
    }
  }
  float* const outs[1] = {out};
  flush_last<1>(outs, cur, q, d, acc, g, vec);
}

// K3.  grid and vec as K2's.  Per nonzero (row i, gathered row c):
// s = <xw[i], x[c]>, t = <dyw[i], x[c]>, w = <xw[i], dy[c]>, the three sums'
// shuffles interleaved; then cs = a s and h = a (t + w) in the compute type,
// dx3[i] += cs dy[c] + h x[c] and u[i] += cs x[c].
template <typename FeatT, bool kWide>
__global__ void __launch_bounds__(kThreads)
sfused_bwd_kernel(const FeatT* __restrict__ x, const FeatT* __restrict__ dy,
                  const FeatT* __restrict__ xw, const FeatT* __restrict__ dyw,
                  const int* __restrict__ rows, const int* __restrict__ cols,
                  const void* __restrict__ vals, int val_kind, float* __restrict__ dx3,
                  float* __restrict__ u, long long nnz, int d, int per, int g, bool vec) {
  constexpr int kB = kBatchBwd;
  if (warp_done(nnz, per, g)) return;
  const Range q = range_of(rows, nnz, per, g);
  float acc[2][sr::kVec];  // dx3's and u's
  zero4(acc[0]);
  zero4(acc[1]);
  int cur = -1;
  for (int t = 0; t < per; t += kB) {
    int r[kB], col[kB];
    // s[i], s[kB + i], s[2 kB + i]: nonzero i's s, t and w.
    float a[kB], s[3 * kB], xo[kB][sr::kVec], dyo[kB][sr::kVec], xv[kB][sr::kVec],
        dv[kB][sr::kVec];
    load_batch<FeatT, kB>(r, col, a, q, q.e0 + t, rows, cols, vals, val_kind);
#pragma unroll
    for (int i = 0; i < 3 * kB; ++i) s[i] = 0.f;
    // The window and gathered rows' columns from c, and their three partial
    // dots.
    auto dots = [&](int c) {
#pragma unroll
      for (int i = 0; i < kB; ++i) load_row4(xo[i], xw, r[i], c, d, vec);
#pragma unroll
      for (int i = 0; i < kB; ++i) load_row4(dyo[i], dyw, r[i], c, d, vec);
#pragma unroll
      for (int i = 0; i < kB; ++i) load_row4(xv[i], x, col[i], c, d, vec);
#pragma unroll
      for (int i = 0; i < kB; ++i) load_row4(dv[i], dy, col[i], c, d, vec);
#pragma unroll
      for (int i = 0; i < kB; ++i) {
        s[i] += dot4(xo[i], xv[i]);
        s[kB + i] += dot4(dyo[i], xv[i]);
        s[2 * kB + i] += dot4(xo[i], dv[i]);
      }
    };
    if constexpr (!kWide) {
      dots(q.c0);
    } else {
      // The sums over all of d, a 128-column tile at a time; then this
      // block's tile of x and dy.
      for (int c = q.cl; c < d; c += sr::kTileD) dots(c);
#pragma unroll
      for (int i = 0; i < kB; ++i) load_row4(xv[i], x, col[i], q.c0, d, vec);
#pragma unroll
      for (int i = 0; i < kB; ++i) load_row4(dv[i], dy, col[i], q.c0, d, vec);
    }
    group_sum<3 * kB>(s, g);
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      if (r[i] < 0) continue;
      if (r[i] != cur) {
        if (cur >= 0) {
          flush(dx3, cur, q, d, acc[0], vec);
          flush(u, cur, q, d, acc[1], vec);
        }
        cur = r[i];
        zero4(acc[0]);
        zero4(acc[1]);
      }
      const float cs = sr::round_to<FeatT>(a[i] * sr::round_to<FeatT>(s[i]));
      const float h = sr::round_to<FeatT>(a[i] * sr::round_to<FeatT>(s[kB + i] + s[2 * kB + i]));
#pragma unroll
      for (int c = 0; c < sr::kVec; ++c) {
        acc[0][c] = fmaf(cs, dv[i][c], fmaf(h, xv[i][c], acc[0][c]));
        acc[1][c] = fmaf(cs, xv[i][c], acc[1][c]);
      }
    }
  }
  float* const outs[2] = {dx3, u};
  flush_last<2>(outs, cur, q, d, acc, g, vec);
}

// ---- launches ----------------------------------------------------------------

// K2: a = xl, b = xr, c = xv (nullptr: xr); K3: a = x, b = dy, aw = xw,
// bw = dyw.  out0 is K2's out or K3's dx3, out1 K3's u.
struct Args {
  const void *a, *b, *c, *aw, *bw, *rows, *cols, *vals;
  float *out0, *out1;
  int n, d;
  long long nnz;
  int val_kind;
};

// The launch shape: g lanes a group, the nonzeros a group takes, the grid,
// and whether the rows take 16-byte (f32) or 8-byte (bf16) loads.
struct Shape {
  dim3 grid;
  int g, per;
  bool wide, vec;
};

Shape shape_of(const Args& a) {
  Shape sh;
  sh.wide = a.d > sr::kTileD;
  sh.g = sh.wide ? 32 : 1;
  while (!sh.wide && sh.g * sr::kVec < a.d) sh.g <<= 1;
  const int groups_per_warp = 32 / sh.g;
  sh.per = range_len(a.nnz, groups_per_warp);
  const long long groups = (a.nnz + sh.per - 1) / sh.per;
  const long long warps = (groups + groups_per_warp - 1) / groups_per_warp;
  sh.grid = dim3((unsigned)((warps + kWarps - 1) / kWarps),
                 sh.wide ? (unsigned)((a.d + sr::kTileD - 1) / sr::kTileD) : 1u);
  sh.vec = a.d % sr::kVec == 0;
  for (const void* p : {a.a, a.b, a.c, a.aw, a.bw, (const void*)a.out0, (const void*)a.out1})
    if (p != nullptr && !sr::aligned16(p)) sh.vec = false;
  return sh;
}

template <typename FeatT>
int launch(bool bwd, const Args& a, cudaStream_t s) {
  const Shape sh = shape_of(a);
  const FeatT* fa = static_cast<const FeatT*>(a.a);
  const FeatT* fb = static_cast<const FeatT*>(a.b);
  const FeatT* fc = static_cast<const FeatT*>(a.c);
  const int* rows = static_cast<const int*>(a.rows);
  const int* cols = static_cast<const int*>(a.cols);
  if (bwd) {
    const auto kernel = sh.wide ? sfused_bwd_kernel<FeatT, true> : sfused_bwd_kernel<FeatT, false>;
    kernel<<<sh.grid, kThreads, 0, s>>>(fa, fb, static_cast<const FeatT*>(a.aw),
                                        static_cast<const FeatT*>(a.bw), rows, cols, a.vals,
                                        a.val_kind, a.out0, a.out1, a.nnz, a.d, sh.per, sh.g,
                                        sh.vec);
  } else if (sh.wide) {
    sfused_kernel<FeatT, false, true><<<sh.grid, kThreads, 0, s>>>(
        fa, fb, fc == nullptr ? fb : fc, rows, cols, a.vals, a.val_kind, a.out0, a.nnz, a.d,
        sh.per, sh.g, sh.vec);
  } else {
    const auto kernel = fc == nullptr ? sfused_kernel<FeatT, true, false>
                                      : sfused_kernel<FeatT, false, false>;
    kernel<<<sh.grid, kThreads, 0, s>>>(fa, fb, fc, rows, cols, a.vals, a.val_kind, a.out0,
                                        a.nnz, a.d, sh.per, sh.g, sh.vec);
  }
  return (int)cudaGetLastError();
}

// Zero the outputs (rows without nonzeros are never visited; cut rows add
// into them), then launch.
int dispatch(bool bwd, int feat_kind, const Args& a, void* stream) {
  if (a.n < 1 || a.d < 1 || a.nnz < 0 || a.val_kind < 0 || a.val_kind > 2 || feat_kind < 0 ||
      feat_kind > 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = (size_t)a.n * a.d * sizeof(float);
  for (float* out : {a.out0, a.out1}) {
    if (out == nullptr) continue;
    const cudaError_t e = cudaMemsetAsync(out, 0, bytes, s);
    if (e != cudaSuccess) return (int)e;
  }
  if (a.nnz == 0) return (int)cudaSuccess;
  return feat_kind == 0 ? launch<float>(bwd, a, s) : launch<__nv_bfloat16>(bwd, a, s);
}

}  // namespace

// K2 and K3 read the tiles' per-row index: rows, cols and vals [nnz], each
// nonzero's window row (< n) and gathered row (int32), in row order, and its
// tile value of val_kind (0 = int8, 1 = float, 2 = bfloat16).  feat_kind:
// 0 = float, 1 = bfloat16, the type of the features.  Outputs are f32
// [n, d], zeroed here first.  Any d >= 1.  Each function returns the
// cudaError_t of the launch (0 = success).

// K2: out = (A . (xl @ xr^T)) @ xv; xv == nullptr shares xr.
extern "C" int tcgnn_spmm_sfused(const void* xl, const void* xr, const void* xv, const void* rows,
                                 const void* cols, const void* vals, void* out, int n, int d,
                                 int nnz, int feat_kind, int val_kind, void* stream) {
  const Args a{xl, xr, xv, nullptr, nullptr, rows, cols, vals, static_cast<float*>(out), nullptr,
               n, d, nnz, val_kind};
  return dispatch(false, feat_kind, a, stream);
}

// K3: dx3 and u from x and dy (the gathers) and xw and dyw (the window rows;
// nullptr: x and dy).
extern "C" int tcgnn_spmm_sfused_bwd(const void* x, const void* dy, const void* xw,
                                     const void* dyw, const void* rows, const void* cols,
                                     const void* vals, void* dx3, void* u, int n, int d, int nnz,
                                     int feat_kind, int val_kind, void* stream) {
  const Args a{x, dy, nullptr, xw == nullptr ? x : xw, dyw == nullptr ? dy : dyw, rows, cols,
               vals, static_cast<float*>(dx3), static_cast<float*>(u), n, d, nnz, val_kind};
  return dispatch(true, feat_kind, a, stream);
}

extern "C" const char* tcgnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
