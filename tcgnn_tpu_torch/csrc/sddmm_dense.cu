// Per-edge SDDMM over a CSR edge list, for Hopper (sm_90a).
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
// What bounds it: two row gathers per edge (2 * E * d feature reads of
// random rows) and one multiply-add per element read, so memory latency and
// bandwidth, not arithmetic.  Edges are spread over threads by edge index,
// not by row, so a hub row (pubmed: one of degree 17,058) spreads over the
// card like any other row's edges.
//
// Tile mode (pos != nullptr): the distributed layer's fused AGNN on a split
// feature axis multiplies score tiles [B, blk_h, blk_w] into the SpMM (K10),
// as the TPU kernel's `out_dtype=compute_dtype` tiles (sddmm.py:291).  Each
// edge's dot is then written at its tile position pos[e], rounded to the
// compute type (or kept f32, as the TPU keeps tiles summed over several
// d-tiles), into a tile array the caller zeroed: positions without an edge
// stay 0, which the structural tile masks anyway.
//
// Layout: a group of L lanes (L = 4, 8, 16 or 32: the smallest of these
// >= min(d, 32)) owns one edge; lane k of the group sums the columns k,
// k + L, ... of the edge's two rows, and the group adds its partial sums
// with shuffles.  Neighbouring groups own neighbouring edges, whose rows are
// mostly the same row in CSR order, so those reads share cache lines.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// OutT: float for per-edge scores (out[e]), FeatT for tile mode (out[pos[e]]).
template <typename FeatT, typename OutT, int L>
__global__ void __launch_bounds__(kThreads)
sddmm_edge_kernel(const FeatT* __restrict__ xa, const FeatT* __restrict__ xb,
                  const int* __restrict__ rows, const int* __restrict__ cols,
                  const int* __restrict__ pos, OutT* __restrict__ out, int num_edges, int d) {
  const long long e = ((long long)blockIdx.x * kThreads + threadIdx.x) / L;
  const int k0 = threadIdx.x % L;
  float s = 0.f;
  if (e < num_edges) {
    const FeatT* a = xa + (size_t)rows[e] * d;
    const FeatT* b = xb + (size_t)cols[e] * d;
    for (int k = k0; k < d; k += L) s = fmaf(to_f32(a[k]), to_f32(b[k]), s);
  }
  // Every lane of the warp takes part (an edge past the end adds zeros).
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (e < num_edges && k0 == 0) store(out + (pos == nullptr ? e : pos[e]), s);
}

struct Args {
  const void *xa, *xb, *rows, *cols, *pos;
  void* out;
  int num_edges, d;
};

template <typename FeatT, typename OutT, int L>
int launch(const Args& a, cudaStream_t stream) {
  const long long threads = (long long)a.num_edges * L;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  sddmm_edge_kernel<FeatT, OutT, L><<<blocks, kThreads, 0, stream>>>(
      static_cast<const FeatT*>(a.xa), static_cast<const FeatT*>(a.xb),
      static_cast<const int*>(a.rows), static_cast<const int*>(a.cols),
      static_cast<const int*>(a.pos), static_cast<OutT*>(a.out), a.num_edges, a.d);
  return (int)cudaGetLastError();
}

template <typename FeatT, typename OutT>
int launch_lanes(const Args& a, cudaStream_t stream) {
  if (a.d <= 4) return launch<FeatT, OutT, 4>(a, stream);
  if (a.d <= 8) return launch<FeatT, OutT, 8>(a, stream);
  if (a.d <= 16) return launch<FeatT, OutT, 16>(a, stream);
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
// array of that type.
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
