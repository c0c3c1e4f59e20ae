// Chunk-route SpMM (K8) and SDDMM (K9), for Hopper (sm_90a).
//
// Replace the TPU kernels `_spmm_kernel` (tcgnn_tpu/ops/spmm.py:82) and
// `_sddmm_kernel` (tcgnn_tpu/ops/sddmm.py:44), together with the XLA row
// gather of the condensed slab `x[col_ids]` that the TPU runs in front of
// them (tcgnn_tpu/ops/spmm.py:161, sddmm.py:116), and the per-edge
// extraction through `edge_perm` after K9 (sddmm.py:248-255).  Both routes
// that the TPU kernels serve, the flat chunk layout and its window segments
// (the streamed route), hold the same edges; the kernels here read neither
// layout but the CSR row index derived from it when it is uploaded
// (`TorchChunkMeta.row_ptr`, `row_src`; sgt/translate.py): the edges of row
// r are e in [row_ptr[r], row_ptr[r + 1]), edge e's source row row_src[e].
//
// K8:  out[r, :] = sum over r's edges e of w[e] * x[row_src[e], :]   (w = 1 unweighted)
// K9:  out[e] = <xa[r, :], xb[row_src[e], :]>                     (e an edge of row r)
//
// x, xa, xb are float or bfloat16 (the compute type); w is f32 and is
// rounded to the compute type as the TPU kernel rounds it; products are
// summed in f32 and stored in f32 (the TPU kernel's output is f32 under
// bf16 too).
//
// What bounds them.  Both read the index once (row_src, 4 bytes an edge,
// plus w for weighted K8: on reddit 115 M edges, 460-920 MB) and gather one
// row of x (xb) an edge.  At d=16 the 15 MB of x sits in L2, and the 7.4 GB
// of row gathers from L2 set the pace; at d=602 x is 561 MB and the
// gathers from device memory (115 M rows of 2,408 bytes) bound it.  The
// chunk layout the TPU kernels walk (each TC block's edges in slots of
// `edge_chunk`) keeps a row's edges only 2.44 slots together on reddit:
// walked in slot order, K8 flushed a sum with atomics at every row change
// and K9 re-read xa[row] for every slot and scattered its scores.  So both
// walk CSR order instead:
//   * work is balanced by edges, not rows: warp i takes the edges
//     [i * P, (i + 1) * P) (P = `edges_per_warp`, from the edge count:
//     1,024 on reddit), and finds its first row by a 32-way search of
//     row_ptr (one probe a lane, four steps on reddit); a hub row (degree
//     12,263 on reddit) spreads over many warps like any other work;
//   * the warp walks its rows in order, reading their ends 32 at a time (one
//     load a lane, shared by shuffles);
//   * in a row, lanes form groups of g (4 g >= the columns of the d-tile),
//     each lane holding 4 consecutive columns, so one load instruction of
//     the warp fetches 32 / g edges' rows and no lane idles at small d
//     (`sparse_row.cuh`'s `group_lanes`, `load4`: one 16-byte load where
//     d % 4 == 0); the groups take the row's edges in turn, 4 edges' loads
//     in flight a lane in K8 at d <= 16 (8 groups), 8 above, 4 in K9;
//   * K8 sums a row in registers, adds the groups' sums by shuffles and
//     stores the row once; a row cut between two warps' ranges is added with
//     f32 atomics into the output the caller zeroed.  Rows wholly inside a
//     range repeat bit for bit from run to run; a row cut into three parts
//     or more (a row longer than P) may not, since its atomics land in any
//     order;
//   * K9 reads xa[row] into registers once a row; a group (g >= 4) sums
//     four edges' dots by recursive halving (log2(g) + 1 shuffles for the
//     four), and the warp stores the scores of consecutive edges with one
//     instruction;
//   * K8's wide rows take a grid axis of 128-column d-tiles (d=602: five);
//     K9 holds up to 512 columns of xa[row] a lane group and walks its
//     range once more for each further 512 columns, adding to its scores.
// Measured on the card, other layouts of the same walk lost (PERF.md,
// section 6): columns g apart where rows are not 16-byte aligned, rows
// padded to a multiple of 4 columns for the vector loads, ranges of 512.
// Index arithmetic is 64-bit wherever a product can pass 2^31.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sparse_row.cuh"

namespace {

using sparse_row::kFull;
using sparse_row::kTileD;
using sparse_row::kVec;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// Edges a warp takes: enough warps to fill the card twice over, in 32 to
// 1,024 edges (small graphs get many short ranges, reddit 1,024).
__host__ int edges_per_warp(long long num_edges) {
  const long long target = num_edges / (132LL * 64 * 2);
  int p = 32;
  while (p < 1024 && p < target) p <<= 1;
  return p;
}

// The row that holds edge e: the r < n with row_ptr[r] <= e < row_ptr[r + 1]
// (row_ptr[n] > e), found by the whole warp: each step probes 32 evenly
// spaced rows, one a lane, and keeps the span between the last probe at or
// below e and the next.
__device__ __forceinline__ int find_row(const long long* __restrict__ row_ptr, int n, long long e) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = n;  // row_ptr[lo] <= e < row_ptr[hi]
  while (hi - lo > 1) {
    const long long step = (hi - lo + 31) / 32;
    const long long p = lo + step * (lane + 1);
    const bool le = p < hi && __ldg(row_ptr + p) <= e;
    const int k = __popc(__ballot_sync(kFull, le));
    hi = min(hi, lo + step * (k + 1));
    lo += step * k;
  }
  return (int)lo;
}

// Calls fn(row, begin, end, whole) for each row with edges in the warp's
// range [e0, e1), in order: [begin, end) is the row's part of the range,
// whole says the part is the whole row.  Row ends are read 32 at a time.
template <typename RowFn>
__device__ __forceinline__ void for_each_row(const long long* __restrict__ row_ptr, int n,
                                             long long num_edges, long long e0, long long e1,
                                             RowFn fn) {
  const int lane = threadIdx.x & 31;
  int row = find_row(row_ptr, n, e0);
  long long start = __ldg(row_ptr + row);
  long long e = e0;
  while (e < e1) {
    const long long end_l = row + lane < n ? __ldg(row_ptr + row + lane + 1) : num_edges;
    for (int j = 0; j < 32 && e < e1; ++j, ++row) {
      const long long end = __shfl_sync(kFull, end_l, j);
      const long long stop = min(end, e1);
      if (stop > e) fn(row, e, stop, start >= e0 && end <= e1);
      start = end;
      e = stop;
    }
  }
}

// acc += sum over the edges p in [begin, end) that this lane's group takes
// (p = begin + grp, + ngrp, ...) of w[p] * x[row_src[p], c0:c0+4], kIn
// edges' loads in flight a lane.
template <typename FeatT, bool kWeighted, int kIn>
__device__ __forceinline__ void gather_edges(float (&acc)[kVec], const FeatT* __restrict__ x,
                                             const float* __restrict__ w,
                                             const int* __restrict__ row_src, long long begin,
                                             long long end, int d, int c0, int grp, int ngrp,
                                             bool vec) {
  long long p = begin + grp;
  for (; p + (kIn - 1) * ngrp < end; p += kIn * ngrp) {
    int src[kIn];
    float a[kIn], v[kIn][kVec];
#pragma unroll
    for (int i = 0; i < kIn; ++i) {
      src[i] = __ldg(row_src + p + i * ngrp);
      a[i] = kWeighted ? sparse_row::round_to<FeatT>(__ldg(w + p + i * ngrp)) : 1.f;
    }
#pragma unroll
    for (int i = 0; i < kIn; ++i) sparse_row::load4(v[i], x + (long long)src[i] * d, c0, d, vec);
#pragma unroll
    for (int i = 0; i < kIn; ++i)
#pragma unroll
      for (int c = 0; c < kVec; ++c) acc[c] = fmaf(a[i], v[i][c], acc[c]);
  }
  for (; p < end; p += ngrp) {
    const int src = __ldg(row_src + p);
    const float a = kWeighted ? sparse_row::round_to<FeatT>(__ldg(w + p)) : 1.f;
    float v[kVec];
    sparse_row::load4(v, x + (long long)src * d, c0, d, vec);
#pragma unroll
    for (int c = 0; c < kVec; ++c) acc[c] = fmaf(a, v[c], acc[c]);
  }
}

// K8: one warp an edge range, d-tile blockIdx.y (kTileD columns); vec: x
// and out rows 16-byte aligned (d % 4 == 0).
template <typename FeatT, bool kWeighted, int kIn>
__global__ void __launch_bounds__(kThreads)
spmm_csr_kernel(const FeatT* __restrict__ x, const float* __restrict__ w,
                const long long* __restrict__ row_ptr, const int* __restrict__ row_src,
                float* __restrict__ out, int n, int d, long long num_edges, int per_warp,
                bool vec) {
  const long long e0 = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * per_warp;
  if (e0 >= num_edges) return;  // the whole warp
  const long long e1 = min(num_edges, e0 + per_warp);
  const int lane = threadIdx.x & 31;
  const int d0 = blockIdx.y * kTileD;
  const int g = sparse_row::group_lanes(min(d - d0, kTileD));
  const int grp = lane / g, ngrp = 32 / g;
  const int c0 = d0 + (lane % g) * kVec;
  for_each_row(row_ptr, n, num_edges, e0, e1,
               [&](int row, long long begin, long long end, bool whole) {
                 float acc[kVec] = {0.f, 0.f, 0.f, 0.f};
                 gather_edges<FeatT, kWeighted, kIn>(acc, x, w, row_src, begin, end, d, c0, grp,
                                                     ngrp, vec);
#pragma unroll
                 for (int off = g; off < 32; off <<= 1)
#pragma unroll
                   for (int c = 0; c < kVec; ++c) acc[c] += __shfl_xor_sync(kFull, acc[c], off);
                 if (grp != 0) return;
                 float* dst = out + (long long)row * d;
                 if (whole)
                   sparse_row::store4(dst, c0, d, acc, vec);
                 else
                   sparse_row::atomic_add4(dst, c0, d, acc);
               });
}

// The dots of four edges, each held in parts by the g >= 4 lanes of a
// group, summed by recursive halving: a lane of the group's upper half keeps
// edges 2 and 3 and adds its partner's parts of them, the lower half edges
// 0 and 1; then the upper quarter of each half keeps the second, the lower
// the first; the remaining levels sum it over the quarter.  log2(g) + 1
// shuffles for the four (4 log2(g) one at a time).  Returns the lane's sum
// and sets i to its edge.
__device__ __forceinline__ float reduce4(const float (&s)[4], int g, int gl, int& i) {
  const int h = g >> 1, q = g >> 2;
  const bool hi = (gl & h) != 0, hq = (gl & q) != 0;
  const float k0 = (hi ? s[2] : s[0]) + __shfl_xor_sync(kFull, hi ? s[0] : s[2], h);
  const float k1 = (hi ? s[3] : s[1]) + __shfl_xor_sync(kFull, hi ? s[1] : s[3], h);
  float v = (hq ? k1 : k0) + __shfl_xor_sync(kFull, hq ? k0 : k1, q);
  for (int off = q >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  i = (hi ? 2 : 0) + (hq ? 1 : 0);
  return v;
}

// K9: one warp an edge range; vec: xa and xb rows 16-byte aligned (d % 4 ==
// 0).  A lane holds the columns cb + t * kTileD + 4 gl + (0..3) (t < T) of
// xa[row], cb stepping by T * kTileD; its group (g >= 4 lanes, 32 where
// T > 1) takes four edges at a time, p = base + i * ngrp + grp, sums their
// dots by `reduce4`, and the first lane of each quarter of the group stores
// one, so the warp stores 4 ngrp consecutive scores together (added to the
// previous pass's past cb = 0).
template <typename FeatT, int T>
__global__ void __launch_bounds__(kThreads)
sddmm_csr_kernel(const FeatT* __restrict__ xa, const FeatT* __restrict__ xb,
                 const long long* __restrict__ row_ptr, const int* __restrict__ row_src,
                 float* __restrict__ out, int n, int d, long long num_edges, int per_warp,
                 bool vec) {
  const long long e0 = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * per_warp;
  if (e0 >= num_edges) return;  // the whole warp
  const long long e1 = min(num_edges, e0 + per_warp);
  const int lane = threadIdx.x & 31;
  const int g = T == 1 ? max(4, sparse_row::group_lanes(d)) : 32;
  const int grp = lane / g, ngrp = 32 / g, gl = lane % g;
  const bool stores = (gl & ((g >> 2) - 1)) == 0;
  for (int cb = 0; cb < d; cb += T * kTileD) {
    for_each_row(row_ptr, n, num_edges, e0, e1,
                 [&](int row, long long begin, long long end, bool) {
                   float a[T][kVec];
#pragma unroll
                   for (int t = 0; t < T; ++t)
                     sparse_row::load4(a[t], xa + (long long)row * d, cb + t * kTileD + gl * kVec,
                                       d, vec);
                   // A trip count the same on every lane: the shuffles need the whole warp.
                   for (long long base = begin; base < end; base += 4 * ngrp) {
                     int src[4];
                     float s[4];
#pragma unroll
                     for (int i = 0; i < 4; ++i) {
                       const long long p = base + i * ngrp + grp;
                       src[i] = p < end ? __ldg(row_src + p) : 0;  // past the end: row 0, unused
                       s[i] = 0.f;
                     }
#pragma unroll
                     for (int i = 0; i < 4; ++i)
#pragma unroll
                       for (int t = 0; t < T; ++t) {
                         float b[kVec];
                         sparse_row::load4(b, xb + (long long)src[i] * d,
                                           cb + t * kTileD + gl * kVec, d, vec);
#pragma unroll
                         for (int c = 0; c < kVec; ++c) s[i] = fmaf(a[t][c], b[c], s[i]);
                       }
                     int i;
                     const float v = reduce4(s, g, gl, i);
                     const long long p = base + i * ngrp + grp;
                     if (stores && p < end) out[p] = cb == 0 ? v : out[p] + v;
                   }
                 });
  }
}

unsigned range_blocks(long long num_edges, int per_warp) {
  const long long warps = (num_edges + per_warp - 1) / per_warp;
  return (unsigned)((warps + kWarps - 1) / kWarps);
}

template <typename FeatT, bool kWeighted>
void spmm_launch_in(const FeatT* x, const float* w, const long long* row_ptr, const int* row_src,
                    float* out, int n, int d, long long num_edges, int per, bool vec, dim3 grid,
                    cudaStream_t s) {
  // Rows of x in flight a warp: 32 / g groups times kIn; d <= 16 has 8
  // groups, wider rows take 8 edges a lane.
  if (d <= 16)
    spmm_csr_kernel<FeatT, kWeighted, 4><<<grid, kThreads, 0, s>>>(x, w, row_ptr, row_src, out,
                                                                   n, d, num_edges, per, vec);
  else
    spmm_csr_kernel<FeatT, kWeighted, 8><<<grid, kThreads, 0, s>>>(x, w, row_ptr, row_src, out,
                                                                   n, d, num_edges, per, vec);
}

template <typename FeatT>
int spmm_launch(const void* x, const float* w, const long long* row_ptr, const int* row_src,
                float* out, int n, int d, long long num_edges, cudaStream_t s) {
  const int per = edges_per_warp(num_edges);
  const dim3 grid(range_blocks(num_edges, per), (unsigned)((d + kTileD - 1) / kTileD));
  const bool vec = d % kVec == 0 && sparse_row::aligned16(x) && sparse_row::aligned16(out);
  const FeatT* xf = static_cast<const FeatT*>(x);
  if (w != nullptr)
    spmm_launch_in<FeatT, true>(xf, w, row_ptr, row_src, out, n, d, num_edges, per, vec, grid, s);
  else
    spmm_launch_in<FeatT, false>(xf, w, row_ptr, row_src, out, n, d, num_edges, per, vec, grid, s);
  return (int)cudaGetLastError();
}

template <typename FeatT>
int sddmm_launch(const void* xa, const void* xb, const long long* row_ptr, const int* row_src,
                 float* out, int n, int d, long long num_edges, cudaStream_t s) {
  const int per = edges_per_warp(num_edges);
  const unsigned grid = range_blocks(num_edges, per);
  const bool vec = d % kVec == 0 && sparse_row::aligned16(xa) && sparse_row::aligned16(xb);
  const FeatT* a = static_cast<const FeatT*>(xa);
  const FeatT* b = static_cast<const FeatT*>(xb);
  if (d <= kTileD)
    sddmm_csr_kernel<FeatT, 1><<<grid, kThreads, 0, s>>>(a, b, row_ptr, row_src, out, n, d,
                                                         num_edges, per, vec);
  else if (d <= 2 * kTileD)
    sddmm_csr_kernel<FeatT, 2><<<grid, kThreads, 0, s>>>(a, b, row_ptr, row_src, out, n, d,
                                                         num_edges, per, vec);
  else
    sddmm_csr_kernel<FeatT, 4><<<grid, kThreads, 0, s>>>(a, b, row_ptr, row_src, out, n, d,
                                                         num_edges, per, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// K8.  x: [n, d]; row_ptr: int64 [n + 1]; row_src: int32 [num_edges]; out:
// f32 [n, d], zeroed by the caller (rows cut between warps are added with
// atomics); w: f32 [num_edges] in CSR order, or null (unweighted).
// feat_kind: 0 = float, 1 = bfloat16 (x).  Returns the cudaError_t of the
// launch (0 = success).
extern "C" int tcgnn_spmm_chunk(const void* x, const void* w, const void* row_ptr,
                                const void* row_src, void* out, int n, int d, int num_edges,
                                int feat_kind, void* stream) {
  if (n < 1 || d < 1 || num_edges < 1) return (int)cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  const long long* rp = static_cast<const long long*>(row_ptr);
  const int* rs = static_cast<const int*>(row_src);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (feat_kind) {
    case 0:
      return spmm_launch<float>(x, wf, rp, rs, o, n, d, num_edges, s);
    case 1:
      return spmm_launch<__nv_bfloat16>(x, wf, rp, rs, o, n, d, num_edges, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K9.  out: f32 [num_edges], one score an edge in CSR order; xa, xb: [n, d];
// the index as K8's.  feat_kind: 0 = float, 1 = bfloat16 (xa and xb).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int tcgnn_sddmm_chunk(const void* xa, const void* xb, const void* row_ptr,
                                 const void* row_src, void* out, int n, int d, int num_edges,
                                 int feat_kind, void* stream) {
  if (n < 1 || d < 1 || num_edges < 1) return (int)cudaErrorInvalidValue;
  const long long* rp = static_cast<const long long*>(row_ptr);
  const int* rs = static_cast<const int*>(row_src);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (feat_kind) {
    case 0:
      return sddmm_launch<float>(xa, xb, rp, rs, o, n, d, num_edges, s);
    case 1:
      return sddmm_launch<__nv_bfloat16>(xa, xb, rp, rs, o, n, d, num_edges, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* tcgnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
