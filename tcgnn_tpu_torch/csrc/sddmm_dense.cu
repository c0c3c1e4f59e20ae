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

template <typename FeatT, int L>
__global__ void __launch_bounds__(kThreads)
sddmm_edge_kernel(const FeatT* __restrict__ xa, const FeatT* __restrict__ xb,
                  const int* __restrict__ rows, const int* __restrict__ cols,
                  float* __restrict__ out, int num_edges, int d) {
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
  if (e < num_edges && k0 == 0) out[e] = s;
}

template <typename FeatT, int L>
int launch(const void* xa, const void* xb, const void* rows, const void* cols, void* out,
           int num_edges, int d, cudaStream_t stream) {
  const long long threads = (long long)num_edges * L;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  sddmm_edge_kernel<FeatT, L><<<blocks, kThreads, 0, stream>>>(
      static_cast<const FeatT*>(xa), static_cast<const FeatT*>(xb),
      static_cast<const int*>(rows), static_cast<const int*>(cols), static_cast<float*>(out),
      num_edges, d);
  return (int)cudaGetLastError();
}

template <typename FeatT>
int launch_lanes(const void* xa, const void* xb, const void* rows, const void* cols, void* out,
                 int num_edges, int d, cudaStream_t stream) {
  if (d <= 4) return launch<FeatT, 4>(xa, xb, rows, cols, out, num_edges, d, stream);
  if (d <= 8) return launch<FeatT, 8>(xa, xb, rows, cols, out, num_edges, d, stream);
  if (d <= 16) return launch<FeatT, 16>(xa, xb, rows, cols, out, num_edges, d, stream);
  return launch<FeatT, 32>(xa, xb, rows, cols, out, num_edges, d, stream);
}

}  // namespace

// out[e] = <xa[rows[e]], xb[cols[e]]> for e < num_edges, f32.
// feat_kind: 0 = float, 1 = bfloat16 (xa and xb).  num_edges >= 1, d >= 1.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int tcgnn_sddmm_dense(const void* xa, const void* xb, const void* rows,
                                 const void* cols, void* out, int num_edges, int d,
                                 int feat_kind, void* stream) {
  if (num_edges < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (feat_kind) {
    case 0:
      return launch_lanes<float>(xa, xb, rows, cols, out, num_edges, d, s);
    case 1:
      return launch_lanes<__nv_bfloat16>(xa, xb, rows, cols, out, num_edges, d, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* tcgnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
