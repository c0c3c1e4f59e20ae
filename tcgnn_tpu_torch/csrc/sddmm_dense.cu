// Per-edge SDDMM over an edge list (K4), for Hopper (sm_90a).
//
// Replaces the TPU kernel `_sddmm_grouped_kernel` (tcgnn_tpu/ops/sddmm.py:264)
// together with the per-edge extraction that follows it in `sddmm_tc_dense`
// (tcgnn_tpu/ops/sddmm.py:402-407):
//
//   out[e] = sum_k xa[row_e, k] * xb[col_e, k]        (f32 accumulation)
//
// The TPU kernel forms whole score tiles xa[window] @ xb[col_ids]^T, writes
// them to device memory, and reads each edge's entry back by its tile
// position.  A pubmed tile at 512x128 is about 1% full: the f32 score tiles
// are about 88 MB, of which one entry per edge is read.  Here each edge's dot
// is computed directly, which also fuses away the original CUDA system's
// scatter epilogue (TCGNN_kernel.cu:719-726).  The result is the same value
// per edge: the dot over all of d of the compute-type operands, summed in
// f32, in another order.
//
// Tile mode (pos != nullptr): the distributed layer's fused AGNN on a split
// feature axis multiplies score tiles [B, blk_h, blk_w] into the SpMM (K10),
// as the TPU kernel's `out_dtype=compute_dtype` tiles (sddmm.py:291).  Each
// edge's dot is then written once at its tile position pos[e], rounded to
// the compute type (or kept f32, as the TPU keeps tiles summed over several
// d-tiles), into a tile array the caller zeroed: positions without an edge
// stay 0, which the structural tile masks anyway.
//
// What bounds it: two row gathers an edge (xa[row_e] and xb[col_e], random
// rows, d * 4 bytes each in f32) after the edge's row and column are read,
// and one multiply-add per element read: memory latency and bandwidth, not
// arithmetic.  One edge a warp would keep one dot's loads in flight a warp,
// some 8 k edges on the whole card, and walk the banded graph's 1.2 M edges
// in about 145 rounds of two dependent latencies.  So:
//   * lanes form groups of g (4 g >= min(d, 128), g >= 4), each lane holding
//     4 consecutive columns (`sparse_row::load4`: one 16-byte f32 or 8-byte
//     bf16 load where d % 4 == 0 and the rows are 16-byte aligned, else four
//     scalar loads), so one load instruction of the warp reads 32 / g rows;
//   * a group takes 4 edges at a time, p = base + i * (32 / g) + grp: it
//     loads their 4 rows and columns, then their 8 feature rows, and sums
//     the four dots by `sparse_row::reduce4` (log2(g) + 1 shuffles for the
//     four); the first lane of each quarter of the group holds one, so the
//     warp stores 4 * 32 / g consecutive scores with one instruction, or
//     scatters them to pos;
//   * warps take equal ranges of consecutive edges (`edges_per_warp`, as K8
//     and K9, but as short as one round of four edges a group, so a small
//     graph still gets many warps), so consecutive edges of one row re-read
//     xa[row] from L1, and a hub row (pubmed: degree 17,058) spreads over
//     many warps;
//   * past 128 columns the group (g = 32) walks the row's further 128-column
//     tiles in a loop, adding to the same four sums, so every score is
//     stored once (bf16 tiles round once) at any d.
// The kernel reads each edge's own row, so it needs no row order: the
// distributed layer's split streams hold their edges per owner shard, out of
// row order.  Index arithmetic is 64-bit wherever a product can pass 2^31.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sparse_row.cuh"

namespace {

using sparse_row::kVec;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// OutT: float for per-edge scores (out[e]) and f32 tiles, FeatT for tiles
// in the compute type (out[pos[e]]).  G: lanes of a group (4, 8, 16, 32).
template <typename FeatT, typename OutT, int G>
__global__ void __launch_bounds__(kThreads)
sddmm_edge_kernel(const FeatT* __restrict__ xa, const FeatT* __restrict__ xb,
                  const int* __restrict__ rows, const int* __restrict__ cols,
                  const int* __restrict__ pos, OutT* __restrict__ out, long long num_edges,
                  int d, int per_warp, bool vec) {
  constexpr int kGroups = 32 / G;
  const long long e0 = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * per_warp;
  if (e0 >= num_edges) return;  // the whole warp
  const long long e1 = min(num_edges, e0 + per_warp);
  const int lane = threadIdx.x & 31;
  const int grp = lane / G, gl = lane % G;
  const bool stores = (gl & (G / 4 - 1)) == 0;
  // A trip count the same on every lane: reduce4 needs the whole warp.
  for (long long base = e0; base < e1; base += 4 * kGroups) {
    int r[4], c[4], q[4];
    float s[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long p = base + i * kGroups + grp;
      const bool in = p < e1;  // past the end: row 0 and column 0, unused
      r[i] = in ? __ldg(rows + p) : 0;
      c[i] = in ? __ldg(cols + p) : 0;
      q[i] = in && pos != nullptr ? __ldg(pos + p) : 0;
      s[i] = 0.f;
    }
    for (int c0 = gl * kVec; c0 < d; c0 += G * kVec) {
      float a[4][kVec], b[4][kVec];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sparse_row::load4(a[i], xa + (long long)r[i] * d, c0, d, vec);
        sparse_row::load4(b[i], xb + (long long)c[i] * d, c0, d, vec);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < kVec; ++k) s[i] = fmaf(a[i][k], b[i][k], s[i]);
    }
    int i;
    const float v = sparse_row::reduce4(s, G, gl, i);
    const long long p = base + i * kGroups + grp;
    if (stores && p < e1) {
      long long at = p;
      if (pos != nullptr) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j == i) at = q[j];
      }
      sparse_row::store1(out + at, v);
    }
  }
}

struct Args {
  const void *xa, *xb, *rows, *cols, *pos;
  void* out;
  long long num_edges;
  int d;
};

template <typename FeatT, typename OutT, int G>
int launch(const Args& a, cudaStream_t stream) {
  // At least one round of 4 edges a group: a small graph (a mesh shard's
  // 21 k edges) gets a warp a round (measured faster there than 32 edges a
  // warp, the least of K8 and K9).
  const int per = sparse_row::edges_per_warp(a.num_edges, 128 / G);
  const long long warps = (a.num_edges + per - 1) / per;
  const unsigned blocks = (unsigned)((warps + kWarps - 1) / kWarps);
  const bool vec = a.d % kVec == 0 && sparse_row::aligned16(a.xa) && sparse_row::aligned16(a.xb);
  sddmm_edge_kernel<FeatT, OutT, G><<<blocks, kThreads, 0, stream>>>(
      static_cast<const FeatT*>(a.xa), static_cast<const FeatT*>(a.xb),
      static_cast<const int*>(a.rows), static_cast<const int*>(a.cols),
      static_cast<const int*>(a.pos), static_cast<OutT*>(a.out), a.num_edges, a.d, per, vec);
  return (int)cudaGetLastError();
}

// Lanes of a group: 4 g >= min(d, 128), at least 4 (reduce4's four dots).
template <typename FeatT, typename OutT>
int launch_lanes(const Args& a, cudaStream_t stream) {
  if (a.d <= 16) return launch<FeatT, OutT, 4>(a, stream);
  if (a.d <= 32) return launch<FeatT, OutT, 8>(a, stream);
  if (a.d <= 64) return launch<FeatT, OutT, 16>(a, stream);
  return launch<FeatT, OutT, 32>(a, stream);
}

template <typename FeatT>
int launch_mode(const Args& a, bool tile_f32, cudaStream_t stream) {
  return a.pos == nullptr || tile_f32 ? launch_lanes<FeatT, float>(a, stream)
                                      : launch_lanes<FeatT, FeatT>(a, stream);
}

}  // namespace

// pos == nullptr: out[e] = <xa[rows[e]], xb[cols[e]]> for e < num_edges, f32.
// pos != nullptr (tile mode): out[pos[e]] = the same dot, rounded to the
// feature type (tile_f32 = 0) or f32 (tile_f32 = 1); out is a zeroed tile
// array of that type.  rows, cols, pos: int32 [num_edges], in any order.
// feat_kind: 0 = float, 1 = bfloat16 (xa and xb).  num_edges >= 1, d >= 1.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int tcgnn_sddmm_dense(const void* xa, const void* xb, const void* rows,
                                 const void* cols, const void* pos, void* out, int num_edges,
                                 int d, int feat_kind, int tile_f32, void* stream) {
  if (num_edges < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const Args a{xa, xb, rows, cols, pos, out, num_edges, d};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (feat_kind) {
    case 0:
      return launch_mode<float>(a, tile_f32 != 0, s);
    case 1:
      return launch_mode<__nv_bfloat16>(a, tile_f32 != 0, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* tcgnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
