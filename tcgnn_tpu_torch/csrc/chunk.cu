// Chunk-layout SpMM (K8) and SDDMM (K9), for Hopper (sm_90a).
//
// Replace the TPU kernels `_spmm_kernel` (tcgnn_tpu/ops/spmm.py:82) and
// `_sddmm_kernel` (tcgnn_tpu/ops/sddmm.py:44), together with the XLA row
// gather of the condensed slab `x[col_ids]` that the TPU runs in front of
// them (tcgnn_tpu/ops/spmm.py:161, sddmm.py:116), and the per-edge
// extraction through `edge_perm` after K9 (sddmm.py:248-255).  One layout
// serves the chunk route and the streamed route: S window segments of
// `wseg` windows, each padded to `max_chunks` chunks of `ec` edge slots
// (the flat chunk route is S = 1, wseg = W).  Segments are a grid axis here,
// where the TPU scans one kernel call per segment.  Slot k of chunk i of
// segment s is the edge seg_eid[s,i,k], with
//
//   output row  (s * wseg + seg_window[s,i]) * blk_h + seg_r[s,i,k]
//   source row  seg_col_ids[s, seg_block[s,i] * blk_w + seg_c[s,i,k]]
//
// A padding slot has row blk_h; chunks from seg_chunks[s] on are padding
// chunks and are not read at all.
//
// K8:  out[row, :] += w[eid] * x[src, :]   (w = 1 when unweighted)
// K9:  out[eid] = <xa[row, :], xb[src, :]>
//
// x, xa, xb are float or bfloat16 (the compute type); w is f32 and is
// rounded to the compute type as the TPU kernel rounds it; products are
// summed in f32 and stored in f32 (the TPU kernel's output is f32 under
// bf16 too).
//
// What bounds them.  Both read the slots' metadata once (r and c, 8 bytes a
// slot, plus the edge id for K9 and for weighted K8: on reddit at 512x128,
// 1.02 M chunks of 128 slots, 1.05-1.57 GB) and gather one row of x per
// edge.  At d=16 the 15 MB of x sits in L2, so the metadata stream is the
// floor (about 0.36 ms at 3.35 TB/s); at d=602 x is 561 MB and the gathers
// (115 M rows of 2,408 bytes) bound it.  The TPU's one-hot products stood in
// for a scatter into VMEM (spmm.py:30-41); here each slot is a direct gather
// and a scatter-add.  What the design does about the bound:
//   * no slab: the kernels gather rows of x themselves, so nothing of size
//     [slots, d] is written to device memory (on reddit the slab would be
//     34 M rows: 2.2 GB at d=16, 82 GB at d=602);
//   * one warp per chunk; a group of L lanes (L = 4, 8, 16 or 32, the
//     smallest >= min(d, 32)) owns a slot at a time, so narrow features do
//     not leave lanes idle; each lane of the group loads one slot's
//     metadata, and the group's L slots are then shared by shuffles, so one
//     load instruction brings L slots;
//   * K8 gathers the rows of up to 16 slots (K9 of 8) before it adds any,
//     so their reads are in flight together;
//   * K8 sums in registers while consecutive slots share a row (a block's
//     edges keep CSR order) and adds the sum to the output with f32 atomics
//     when the row changes; the output is zeroed first by the caller.  The
//     atomics balance any degree skew: work is spread by chunk, not by
//     window, so a hub's window spreads over the card like any other;
//   * wide rows (d=602) take a grid axis of d-tiles of 32 * V columns (V up
//     to 4 a lane); each tile re-reads the slot metadata, 1/30 of the
//     gathers' bytes at d=602.
// Index arithmetic is 64-bit wherever a product of metadata can pass 2^31.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// A weight rounded to the compute type, as the TPU kernel casts it.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

struct Layout {
  const int *col_ids, *seg_r, *seg_c, *seg_eid, *seg_block, *seg_window, *seg_chunks;
  int max_chunks, ec, wseg, blk_h, blk_w;
  long long col_stride;  // B_max * blk_w: one segment's col_ids
};

// Adds a row run's sums to the output.
template <int L, int V>
__device__ __forceinline__ void flush(float* out, long long row, int n, int d, int d0, int gl,
                                      const float (&acc)[V]) {
  if (row < 0 || row >= n) return;
#pragma unroll
  for (int q = 0; q < V; ++q) {
    const int col = d0 + gl + q * L;
    if (col < d) atomicAdd(out + row * d + col, acc[q]);
  }
}

// One warp per chunk; in the warp, G = 32 / L groups of L lanes each walk a
// contiguous 1/G of the chunk's slots (so row runs stay together).  A lane
// owns the columns d0 + gl + q * L (q < V) of the d-tile blockIdx.y.
template <typename FeatT, int L, int V>
__global__ void __launch_bounds__(kThreads)
spmm_chunk_kernel(const FeatT* __restrict__ x, const float* __restrict__ w, Layout m,
                  float* out, int n, int d, int blocks_per_segment) {
  constexpr int G = 32 / L;
  constexpr int kB = V <= 2 ? 16 : 8;  // slots gathered together
  constexpr int kSub = kB < L ? kB : L;
  const int s = blockIdx.x / blocks_per_segment;
  const int chunk = (blockIdx.x % blocks_per_segment) * kWarps + (threadIdx.x >> 5);
  if (chunk >= m.seg_chunks[s]) return;  // the whole warp: padding chunk or past the end
  const int lane = threadIdx.x & 31;
  const int group = lane / L, gl = lane % L;
  const int d0 = blockIdx.y * L * V;

  const long long ci = (long long)s * m.max_chunks + chunk;
  const int* r_p = m.seg_r + ci * m.ec;
  const int* c_p = m.seg_c + ci * m.ec;
  const int* e_p = m.seg_eid + ci * m.ec;
  const long long row0 = ((long long)s * m.wseg + m.seg_window[ci]) * m.blk_h;
  const int* cols = m.col_ids + (long long)s * m.col_stride + (long long)m.seg_block[ci] * m.blk_w;
  const int per = (m.ec + G - 1) / G;  // the same trip count in every group
  const int k_begin = group * per;
  const int k_end = min(m.ec, k_begin + per);

  float acc[V];
#pragma unroll
  for (int q = 0; q < V; ++q) acc[q] = 0.f;
  int cur = -1;  // in-window row of the run being summed

  for (int t = 0; t < per; t += L) {
    // Lane gl of the group reads slot k_begin + t + gl's metadata.
    const int k = k_begin + t + gl;
    int r = m.blk_h, src = 0;
    float wk = 1.f;
    if (k < k_end) {
      r = r_p[k];
      if (r < m.blk_h) {
        src = cols[c_p[k]];
        if (w != nullptr) wk = round_to<FeatT>(w[e_p[k]]);
      }
    }
#pragma unroll
    for (int jb = 0; jb < L; jb += kSub) {
      int rj[kSub], sj[kSub];
      float wj[kSub], v[kSub][V];
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        rj[j] = __shfl_sync(0xffffffffu, r, jb + j, L);
        sj[j] = __shfl_sync(0xffffffffu, src, jb + j, L);
        wj[j] = __shfl_sync(0xffffffffu, wk, jb + j, L);
      }
#pragma unroll
      for (int j = 0; j < kSub; ++j)
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const int col = d0 + gl + q * L;
          v[j][q] = rj[j] < m.blk_h && col < d ? to_f32(x[(size_t)sj[j] * d + col]) : 0.f;
        }
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        if (rj[j] >= m.blk_h) continue;
        if (rj[j] != cur) {
          flush<L, V>(out, cur < 0 ? -1 : row0 + cur, n, d, d0, gl, acc);
          cur = rj[j];
#pragma unroll
          for (int q = 0; q < V; ++q) acc[q] = 0.f;
        }
#pragma unroll
        for (int q = 0; q < V; ++q) acc[q] = fmaf(wj[j], v[j][q], acc[q]);
      }
    }
  }
  flush<L, V>(out, cur < 0 ? -1 : row0 + cur, n, d, d0, gl, acc);
}

// One warp per chunk, as K8: G = 32 / L groups of L lanes each walk a
// contiguous 1/G of the chunk's slots, L slots at a time, lane gl reading
// slot gl's metadata.  For each of those slots the group sums the columns
// gl, gl + L, ... of the two rows, adds its partial sums with shuffles, and
// lane j keeps slot j's score, so the group's L scores are stored together.
template <typename FeatT, int L>
__global__ void __launch_bounds__(kThreads)
sddmm_chunk_kernel(const FeatT* __restrict__ xa, const FeatT* __restrict__ xb, Layout m,
                   float* __restrict__ out, int d, int blocks_per_segment) {
  constexpr int G = 32 / L;
  constexpr int kSub = L < 8 ? L : 8;  // slots whose rows are read together
  const int s = blockIdx.x / blocks_per_segment;
  const int chunk = (blockIdx.x % blocks_per_segment) * kWarps + (threadIdx.x >> 5);
  if (chunk >= m.seg_chunks[s]) return;  // the whole warp: padding chunk or past the end
  const int lane = threadIdx.x & 31;
  const int group = lane / L, gl = lane % L;

  const long long ci = (long long)s * m.max_chunks + chunk;
  const int* r_p = m.seg_r + ci * m.ec;
  const int* c_p = m.seg_c + ci * m.ec;
  const int* e_p = m.seg_eid + ci * m.ec;
  const long long row0 = ((long long)s * m.wseg + m.seg_window[ci]) * m.blk_h;
  const int* cols = m.col_ids + (long long)s * m.col_stride + (long long)m.seg_block[ci] * m.blk_w;
  const int per = (m.ec + G - 1) / G;
  const int k_begin = group * per;
  const int k_end = min(m.ec, k_begin + per);
  const int d_steps = (d + L - 1) / L;  // the same trip count on every lane

  for (int t = 0; t < per; t += L) {
    const int k = k_begin + t + gl;
    int eid = -1, src = 0;
    long long row = 0;
    if (k < k_end) {
      const int r = r_p[k];
      if (r < m.blk_h) {
        eid = e_p[k];
        row = row0 + r;
        src = cols[c_p[k]];
      }
    }
    float score = 0.f;
#pragma unroll
    for (int jb = 0; jb < L; jb += kSub) {
      long long rj[kSub];
      int sj[kSub];
      bool ok[kSub];
      float acc[kSub];
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        rj[j] = __shfl_sync(0xffffffffu, row, jb + j, L);
        sj[j] = __shfl_sync(0xffffffffu, src, jb + j, L);
        ok[j] = __shfl_sync(0xffffffffu, eid, jb + j, L) >= 0;
        acc[j] = 0.f;
      }
      for (int q = 0; q < d_steps; ++q) {
        const int col = gl + q * L;
        float a[kSub], b[kSub];
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          const bool in = ok[j] && col < d;
          a[j] = in ? to_f32(xa[rj[j] * d + col]) : 0.f;
          b[j] = in ? to_f32(xb[(long long)sj[j] * d + col]) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kSub; ++j) acc[j] = fmaf(a[j], b[j], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
#pragma unroll
        for (int off = L / 2; off > 0; off >>= 1)
          acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off, L);
        if (gl == jb + j) score = acc[j];
      }
    }
    if (eid >= 0) out[eid] = score;
  }
}

template <typename FeatT, int L, int V>
int launch_spmm(const void* x, const float* w, const Layout& m, float* out, int n, int d,
                int num_segments, cudaStream_t stream) {
  const int bps = (m.max_chunks + kWarps - 1) / kWarps;
  const dim3 grid((unsigned)num_segments * (unsigned)bps, (unsigned)((d + L * V - 1) / (L * V)));
  spmm_chunk_kernel<FeatT, L, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const FeatT*>(x), w, m, out, n, d, bps);
  return (int)cudaGetLastError();
}

template <typename FeatT>
int spmm_lanes(const void* x, const float* w, const Layout& m, float* out, int n, int d,
               int num_segments, cudaStream_t s) {
  if (d <= 4) return launch_spmm<FeatT, 4, 1>(x, w, m, out, n, d, num_segments, s);
  if (d <= 8) return launch_spmm<FeatT, 8, 1>(x, w, m, out, n, d, num_segments, s);
  if (d <= 16) return launch_spmm<FeatT, 16, 1>(x, w, m, out, n, d, num_segments, s);
  if (d <= 32) return launch_spmm<FeatT, 32, 1>(x, w, m, out, n, d, num_segments, s);
  if (d <= 64) return launch_spmm<FeatT, 32, 2>(x, w, m, out, n, d, num_segments, s);
  return launch_spmm<FeatT, 32, 4>(x, w, m, out, n, d, num_segments, s);
}

template <typename FeatT, int L>
int launch_sddmm(const void* xa, const void* xb, const Layout& m, float* out, int d,
                 int num_segments, cudaStream_t stream) {
  const int bps = (m.max_chunks + kWarps - 1) / kWarps;
  sddmm_chunk_kernel<FeatT, L><<<(unsigned)num_segments * (unsigned)bps, kThreads, 0, stream>>>(
      static_cast<const FeatT*>(xa), static_cast<const FeatT*>(xb), m, out, d, bps);
  return (int)cudaGetLastError();
}

template <typename FeatT>
int sddmm_lanes(const void* xa, const void* xb, const Layout& m, float* out, int d,
                int num_segments, cudaStream_t s) {
  if (d <= 4) return launch_sddmm<FeatT, 4>(xa, xb, m, out, d, num_segments, s);
  if (d <= 8) return launch_sddmm<FeatT, 8>(xa, xb, m, out, d, num_segments, s);
  if (d <= 16) return launch_sddmm<FeatT, 16>(xa, xb, m, out, d, num_segments, s);
  return launch_sddmm<FeatT, 32>(xa, xb, m, out, d, num_segments, s);
}

bool layout_ok(int num_segments, int max_chunks, int ec, int wseg, int blk_h, int blk_w) {
  return num_segments >= 1 && max_chunks >= 1 && ec >= 1 && wseg >= 1 && blk_h >= 1 &&
         blk_w >= 1 &&
         (long long)num_segments * ((max_chunks + kWarps - 1) / kWarps) < (1LL << 31);
}

}  // namespace

// K8.  out: f32 [n, d], zeroed by the caller; w: f32 [num_edges] or null
// (unweighted).  feat_kind: 0 = float, 1 = bfloat16 (x).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int tcgnn_spmm_chunk(const void* x, const void* w, const void* col_ids,
                                const void* seg_r, const void* seg_c, const void* seg_eid,
                                const void* seg_block, const void* seg_window,
                                const void* seg_chunks, void* out, int n, int d,
                                int num_segments, int max_chunks, int ec, int wseg, int blk_h,
                                int blk_w, int col_stride, int feat_kind, void* stream) {
  if (n < 1 || d < 1 || !layout_ok(num_segments, max_chunks, ec, wseg, blk_h, blk_w))
    return (int)cudaErrorInvalidValue;
  const Layout m{static_cast<const int*>(col_ids), static_cast<const int*>(seg_r),
                 static_cast<const int*>(seg_c), static_cast<const int*>(seg_eid),
                 static_cast<const int*>(seg_block), static_cast<const int*>(seg_window),
                 static_cast<const int*>(seg_chunks), max_chunks, ec, wseg, blk_h, blk_w,
                 (long long)col_stride};
  const float* wf = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (feat_kind) {
    case 0:
      return spmm_lanes<float>(x, wf, m, o, n, d, num_segments, s);
    case 1:
      return spmm_lanes<__nv_bfloat16>(x, wf, m, o, n, d, num_segments, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K9.  out: f32 [num_edges], one score per edge in CSR order (every edge has
// one slot).  feat_kind: 0 = float, 1 = bfloat16 (xa and xb).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int tcgnn_sddmm_chunk(const void* xa, const void* xb, const void* col_ids,
                                 const void* seg_r, const void* seg_c, const void* seg_eid,
                                 const void* seg_block, const void* seg_window,
                                 const void* seg_chunks, void* out, int d, int num_segments,
                                 int max_chunks, int ec, int wseg, int blk_h, int blk_w,
                                 int col_stride, int feat_kind, void* stream) {
  if (d < 1 || !layout_ok(num_segments, max_chunks, ec, wseg, blk_h, blk_w))
    return (int)cudaErrorInvalidValue;
  const Layout m{static_cast<const int*>(col_ids), static_cast<const int*>(seg_r),
                 static_cast<const int*>(seg_c), static_cast<const int*>(seg_eid),
                 static_cast<const int*>(seg_block), static_cast<const int*>(seg_window),
                 static_cast<const int*>(seg_chunks), max_chunks, ec, wseg, blk_h, blk_w,
                 (long long)col_stride};
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (feat_kind) {
    case 0:
      return sddmm_lanes<float>(xa, xb, m, o, d, num_segments, s);
    case 1:
      return sddmm_lanes<__nv_bfloat16>(xa, xb, m, o, d, num_segments, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* tcgnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
