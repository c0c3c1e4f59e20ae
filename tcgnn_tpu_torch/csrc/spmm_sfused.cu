// Score-fused SpMM (AGNN aggregation) and its one-pass backward over
// SGT-condensed tiles, for Hopper (sm_90a).
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
// in VMEM.  A pubmed tile at 512x128 is about 1% full, so here the score is
// computed only at the nonzero tile entries: per entry a warp forms the dot
// products over d (lane c holds columns c, c + 32, ...) and adds them across
// the warp with shuffles, then adds the weighted row to its sums.
//
// What bounds it: latency, as in the dense-tile SpMM (csrc/spmm_dense.cu),
// whose thread-block design this file keeps: one thread block of 8 warps per
// (slab of up to 32 rows of a window, run of up to run_blocks TC blocks of
// the window); per TC block the warps load their tile rows into registers,
// mark the columns their rows use, gather only those rows of the column-side
// operands into shared memory, and walk the nonzeros found by warp ballot.
// The window's own rows (xl, or x and dy) stay in registers for the whole
// run.  A window of more than run_blocks blocks (the pubmed hub's window:
// 134 TC blocks at 512x128, 2,133 at 16x8) is split into runs, one thread
// block each, whose f32 sums meet in the output through atomics (zeroed
// first); a window of one run stores its sums.  There is no d-tiling, as on
// the TPU: the score needs all of d at once, so d is at most 128 (a lane
// holds up to 4 columns).  blk_w is at most 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSlab = 32;                        // rows of a window per thread block
constexpr int kMaxRowsPerWarp = kSlab / kWarps;  // 4
constexpr int kMaxBlkW = 128;
constexpr int kMaxChunks = kMaxBlkW / 32;          // tile-row registers per lane
constexpr int kMaxGatherRows = kMaxBlkW / kWarps;  // gathered rows per warp
constexpr int kMaxD = 128;
constexpr size_t kStaticSmemLimit = 48 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

// A value rounded to the compute type (a no-op for f32).
template <typename T>
__device__ __forceinline__ float round_to(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// What every thread block works out first: its run, window and rows.
struct Place {
  int win, b_begin, b_end, row0, rows_per_warp;
  bool split;
};

__device__ __forceinline__ Place place(const int* win_start, const int* run_window,
                                       const int* run_block, int run_blocks, int slab,
                                       int slabs_per_window) {
  Place p;
  const int run = blockIdx.x / slabs_per_window;
  p.win = run_window[run];
  const int w_begin = win_start[p.win], w_end = win_start[p.win + 1];
  p.b_begin = run_block[run];
  p.b_end = min(p.b_begin + run_blocks, w_end);
  p.split = w_end - w_begin > run_blocks;
  p.row0 = (blockIdx.x % slabs_per_window) * slab;
  p.rows_per_warp = (slab + kWarps - 1) / kWarps;
  return p;
}

// Global row of the warp's i-th row, or -1 where it has none (past the
// slab, the window or n).
__device__ __forceinline__ long long warp_row(const Place& p, int i, int slab, int blk_h, int n) {
  const int lr = (threadIdx.x >> 5) * p.rows_per_warp + i;
  const int r = p.row0 + lr;
  const long long grow = (long long)p.win * blk_h + r;
  return i < p.rows_per_warp && lr < slab && r < blk_h && grow < n ? grow : -1;
}

// A tile entry as a float.  tile_kind: 0 = int8, 1 = float, 2 = bfloat16
// (a branch on one value for the whole launch, instead of a kernel per
// tile type).
__device__ __forceinline__ float tile_value(const void* tiles, int tile_kind, size_t i) {
  switch (tile_kind) {
    case 0:
      return to_f32(static_cast<const int8_t*>(tiles)[i]);
    case 1:
      return static_cast<const float*>(tiles)[i];
    default:
      return to_f32(static_cast<const __nv_bfloat16*>(tiles)[i]);
  }
}

// 1. The warp's tile rows of TC block b into registers (lane holds columns
//    q*32+lane), in the compute type, marking the columns they use.
template <typename FeatT>
__device__ __forceinline__ void load_tile_rows(float (&a)[kMaxRowsPerWarp][kMaxChunks],
                                               const void* tiles, int tile_kind, const Place& p,
                                               int b, int slab, int blk_h, int blk_w,
                                               int* used_by) {
  const size_t tile = (size_t)b * blk_h * blk_w;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kMaxRowsPerWarp; ++i) {
    const int lr = warp * p.rows_per_warp + i;
    const int r = p.row0 + lr;
    const bool row_ok = i < p.rows_per_warp && lr < slab && r < blk_h;
#pragma unroll
    for (int q = 0; q < kMaxChunks; ++q) {
      const int k = q * 32 + lane;
      a[i][q] = row_ok && k < blk_w
                    ? round_to<FeatT>(tile_value(tiles, tile_kind, tile + (size_t)r * blk_w + k))
                    : 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxRowsPerWarp; ++i)
#pragma unroll
    for (int q = 0; q < kMaxChunks; ++q)
      if (a[i][q] != 0.f) used_by[q * 32 + lane] = b;
}

// 2. The used rows of `src` (all of d, zero past it) into shared memory,
//    row k at dst + k * kD.  A warp issues its loads before its stores.
template <typename FeatT, int kCols>
__device__ __forceinline__ void gather(float* dst, const FeatT* src, const int* cols,
                                       const int* used_by, int b, int blk_w, int d) {
  constexpr int kD = 32 * kCols;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int row[kMaxGatherRows];
#pragma unroll
  for (int j = 0; j < kMaxGatherRows; ++j) {
    const int k = warp + j * kWarps;
    row[j] = k < blk_w && used_by[k] == b ? cols[k] : -1;
  }
  float v[kMaxGatherRows][kCols];
#pragma unroll
  for (int j = 0; j < kMaxGatherRows; ++j)
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      v[j][c] = row[j] >= 0 && col < d ? to_f32(src[(size_t)row[j] * d + col]) : 0.f;
    }
#pragma unroll
  for (int j = 0; j < kMaxGatherRows; ++j)
    if (row[j] >= 0) {
      const int k = warp + j * kWarps;
#pragma unroll
      for (int c = 0; c < kCols; ++c) dst[k * kD + lane + 32 * c] = v[j][c];
    }
}

// A window row of `src` into registers (zeros where there is none).
template <typename FeatT, int kCols>
__device__ __forceinline__ void load_row(float (&dst)[kCols], const FeatT* src, long long grow,
                                         int d) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int col = lane + 32 * c;
    dst[c] = grow >= 0 && col < d ? to_f32(src[grow * d + col]) : 0.f;
  }
}

// 4. One store per output element, or, for a run of a split window, an f32
//    atomic add.
template <int kCols>
__device__ __forceinline__ void store_row(float* out, const float (&acc)[kCols], long long grow,
                                          int d, bool split) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int col = lane + 32 * c;
    if (col >= d) continue;
    if (split)
      atomicAdd(out + grow * d + col, acc[c]);
    else
      out[grow * d + col] = acc[c];
  }
}

template <typename FeatT, int kCols, bool kShare>
__global__ void __launch_bounds__(kThreads)
sfused_kernel(const FeatT* __restrict__ xl, const FeatT* __restrict__ xr,
              const FeatT* __restrict__ xv, const void* __restrict__ tiles, int tile_kind,
              const int* __restrict__ col_ids, const int* __restrict__ win_start,
              const int* __restrict__ run_window, const int* __restrict__ run_block,
              float* out, int n, int d, int run_blocks, int blk_h, int blk_w, int slab,
              int slabs_per_window) {
  constexpr int kD = 32 * kCols;
  extern __shared__ float smem[];
  float* xr_s = smem;                                // [blk_w][kD] gathered xr rows
  float* xv_s = kShare ? smem : smem + blk_w * kD;  // gathered xv rows
  __shared__ int used_by[kMaxBlkW];  // last TC block whose slab rows use column k

  const Place p = place(win_start, run_window, run_block, run_blocks, slab, slabs_per_window);
  const int lane = threadIdx.x & 31;
  for (int k = threadIdx.x; k < kMaxBlkW; k += kThreads) used_by[k] = -1;

  long long grow[kMaxRowsPerWarp];
  float xl_r[kMaxRowsPerWarp][kCols], acc[kMaxRowsPerWarp][kCols];
#pragma unroll
  for (int i = 0; i < kMaxRowsPerWarp; ++i) {
    grow[i] = warp_row(p, i, slab, blk_h, n);
    load_row<FeatT, kCols>(xl_r[i], xl, grow[i], d);
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }
  __syncthreads();

  for (int b = p.b_begin; b < p.b_end; ++b) {
    float a[kMaxRowsPerWarp][kMaxChunks];
    load_tile_rows<FeatT>(a, tiles, tile_kind, p, b, slab, blk_h, blk_w, used_by);
    __syncthreads();
    const int* cols = col_ids + (size_t)b * blk_w;
    gather<FeatT, kCols>(xr_s, xr, cols, used_by, b, blk_w, d);
    if (!kShare) gather<FeatT, kCols>(xv_s, xv, cols, used_by, b, blk_w, d);
    __syncthreads();

    // 3. Per nonzero (r, k): s = <xl[r], xr[k]>, w = a * s in the compute
    //    type, acc[r] += w * xv[k].  (The next block's gather writes shared
    //    memory only after its barrier, which every thread reaches after
    //    finishing this step.)
#pragma unroll
    for (int i = 0; i < kMaxRowsPerWarp; ++i) {
      if (i >= p.rows_per_warp) continue;
#pragma unroll
      for (int q = 0; q < kMaxChunks; ++q) {
        unsigned nz = __ballot_sync(0xffffffffu, a[i][q] != 0.f);
        while (nz) {
          const int j = __ffs(nz) - 1;
          nz &= nz - 1;
          const float aj = __shfl_sync(0xffffffffu, a[i][q], j);
          const float* xrk = xr_s + (q * 32 + j) * kD;
          const float* xvk = xv_s + (q * 32 + j) * kD;
          float part = 0.f;
#pragma unroll
          for (int c = 0; c < kCols; ++c) part = fmaf(xl_r[i][c], xrk[lane + 32 * c], part);
          const float w = round_to<FeatT>(aj * round_to<FeatT>(warp_sum(part)));
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(w, xvk[lane + 32 * c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kMaxRowsPerWarp; ++i)
    if (grow[i] >= 0) store_row<kCols>(out, acc[i], grow[i], d, p.split);
}

template <typename FeatT, int kCols>
__global__ void __launch_bounds__(kThreads)
sfused_bwd_kernel(const FeatT* __restrict__ x, const FeatT* __restrict__ dy,
                  const FeatT* __restrict__ xw, const FeatT* __restrict__ dyw,
                  const void* __restrict__ tiles, int tile_kind, const int* __restrict__ col_ids,
                  const int* __restrict__ win_start, const int* __restrict__ run_window,
                  const int* __restrict__ run_block, float* dx3, float* u, int n, int d,
                  int run_blocks, int blk_h, int blk_w, int slab, int slabs_per_window) {
  constexpr int kD = 32 * kCols;
  extern __shared__ float smem[];
  float* x_s = smem;                // [blk_w][kD] gathered x rows
  float* dy_s = smem + blk_w * kD;  // gathered dy rows
  __shared__ int used_by[kMaxBlkW];

  const Place p = place(win_start, run_window, run_block, run_blocks, slab, slabs_per_window);
  const int lane = threadIdx.x & 31;
  for (int k = threadIdx.x; k < kMaxBlkW; k += kThreads) used_by[k] = -1;

  long long grow[kMaxRowsPerWarp];
  float x_r[kMaxRowsPerWarp][kCols], dy_r[kMaxRowsPerWarp][kCols];
  float acc_dx[kMaxRowsPerWarp][kCols], acc_u[kMaxRowsPerWarp][kCols];
#pragma unroll
  for (int i = 0; i < kMaxRowsPerWarp; ++i) {
    grow[i] = warp_row(p, i, slab, blk_h, n);
    load_row<FeatT, kCols>(x_r[i], xw, grow[i], d);
    load_row<FeatT, kCols>(dy_r[i], dyw, grow[i], d);
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_dx[i][c] = acc_u[i][c] = 0.f;
  }
  __syncthreads();

  for (int b = p.b_begin; b < p.b_end; ++b) {
    float a[kMaxRowsPerWarp][kMaxChunks];
    load_tile_rows<FeatT>(a, tiles, tile_kind, p, b, slab, blk_h, blk_w, used_by);
    __syncthreads();
    const int* cols = col_ids + (size_t)b * blk_w;
    gather<FeatT, kCols>(x_s, x, cols, used_by, b, blk_w, d);
    gather<FeatT, kCols>(dy_s, dy, cols, used_by, b, blk_w, d);
    __syncthreads();

    // 3. Per nonzero (r, k): the three scores, then
    //    cs = a * s and g = a * (t + w) in the compute type,
    //    dx3[r] += cs * dy[k] + g * x[k],  u[r] += cs * x[k].
#pragma unroll
    for (int i = 0; i < kMaxRowsPerWarp; ++i) {
      if (i >= p.rows_per_warp) continue;
#pragma unroll
      for (int q = 0; q < kMaxChunks; ++q) {
        unsigned nz = __ballot_sync(0xffffffffu, a[i][q] != 0.f);
        while (nz) {
          const int j = __ffs(nz) - 1;
          nz &= nz - 1;
          const float aj = __shfl_sync(0xffffffffu, a[i][q], j);
          const float* xk = x_s + (q * 32 + j) * kD;
          const float* dyk = dy_s + (q * 32 + j) * kD;
          float ps = 0.f, pt = 0.f, pw = 0.f;
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const float xv = xk[lane + 32 * c], dv = dyk[lane + 32 * c];
            ps = fmaf(x_r[i][c], xv, ps);
            pt = fmaf(dy_r[i][c], xv, pt);
            pw = fmaf(x_r[i][c], dv, pw);
          }
          const float s = warp_sum(ps), t = warp_sum(pt), w = warp_sum(pw);
          const float cs = round_to<FeatT>(aj * round_to<FeatT>(s));
          const float g = round_to<FeatT>(aj * round_to<FeatT>(t + w));
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const float xv = xk[lane + 32 * c], dv = dyk[lane + 32 * c];
            acc_dx[i][c] = fmaf(cs, dv, fmaf(g, xv, acc_dx[i][c]));
            acc_u[i][c] = fmaf(cs, xv, acc_u[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kMaxRowsPerWarp; ++i)
    if (grow[i] >= 0) {
      store_row<kCols>(dx3, acc_dx[i], grow[i], d, p.split);
      store_row<kCols>(u, acc_u[i], grow[i], d, p.split);
    }
}

struct Args {
  const void *a, *b, *c, *aw, *bw, *tiles, *col_ids, *win_start, *run_window, *run_block;
  float *out0, *out1;
  int n, d, num_runs, run_blocks, split, blk_h, blk_w, tile_kind;
};

struct Grid {
  int slab, slabs_per_window;
  dim3 grid;
};

Grid grid_of(const Args& a) {
  Grid g;
  g.slab = a.blk_h < kSlab ? a.blk_h : kSlab;
  g.slabs_per_window = (a.blk_h + g.slab - 1) / g.slab;
  g.grid = dim3((unsigned)a.num_runs * (unsigned)g.slabs_per_window);
  return g;
}

// Zero the outputs that split windows add into, and allow the kernel its
// dynamic shared memory.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, const Args& a, size_t smem, cudaStream_t stream) {
  if (a.split) {
    const size_t bytes = (size_t)a.n * a.d * sizeof(float);
    cudaError_t e = cudaMemsetAsync(a.out0, 0, bytes, stream);
    if (e == cudaSuccess && a.out1 != nullptr) e = cudaMemsetAsync(a.out1, 0, bytes, stream);
    if (e != cudaSuccess) return e;
  }
  if (smem > kStaticSmemLimit)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return cudaSuccess;
}

template <typename FeatT, int kCols, bool kShare>
int launch_fwd(const Args& a, cudaStream_t stream) {
  const auto kernel = sfused_kernel<FeatT, kCols, kShare>;
  const size_t smem = (kShare ? 1 : 2) * (size_t)a.blk_w * 32 * kCols * sizeof(float);
  const cudaError_t e = prepare(kernel, a, smem, stream);
  if (e != cudaSuccess) return (int)e;
  const Grid g = grid_of(a);
  kernel<<<g.grid, kThreads, smem, stream>>>(
      static_cast<const FeatT*>(a.a), static_cast<const FeatT*>(a.b),
      static_cast<const FeatT*>(a.c), a.tiles, a.tile_kind, static_cast<const int*>(a.col_ids),
      static_cast<const int*>(a.win_start), static_cast<const int*>(a.run_window),
      static_cast<const int*>(a.run_block), a.out0, a.n, a.d, a.run_blocks, a.blk_h, a.blk_w,
      g.slab, g.slabs_per_window);
  return (int)cudaGetLastError();
}

template <typename FeatT, int kCols>
int launch_bwd(const Args& a, cudaStream_t stream) {
  const auto kernel = sfused_bwd_kernel<FeatT, kCols>;
  const size_t smem = 2 * (size_t)a.blk_w * 32 * kCols * sizeof(float);
  const cudaError_t e = prepare(kernel, a, smem, stream);
  if (e != cudaSuccess) return (int)e;
  const Grid g = grid_of(a);
  kernel<<<g.grid, kThreads, smem, stream>>>(
      static_cast<const FeatT*>(a.a), static_cast<const FeatT*>(a.b),
      static_cast<const FeatT*>(a.aw), static_cast<const FeatT*>(a.bw), a.tiles, a.tile_kind,
      static_cast<const int*>(a.col_ids), static_cast<const int*>(a.win_start),
      static_cast<const int*>(a.run_window), static_cast<const int*>(a.run_block), a.out0,
      a.out1, a.n, a.d, a.run_blocks, a.blk_h, a.blk_w, g.slab, g.slabs_per_window);
  return (int)cudaGetLastError();
}

// The forward (bwd = false, share = whether xv is xr) or the backward.
template <typename FeatT>
int launch_cols(bool bwd, bool share, const Args& a, cudaStream_t stream) {
  if (bwd) {
    if (a.d <= 32) return launch_bwd<FeatT, 1>(a, stream);
    if (a.d <= 64) return launch_bwd<FeatT, 2>(a, stream);
    return launch_bwd<FeatT, 4>(a, stream);
  }
  if (share) {
    if (a.d <= 32) return launch_fwd<FeatT, 1, true>(a, stream);
    if (a.d <= 64) return launch_fwd<FeatT, 2, true>(a, stream);
    return launch_fwd<FeatT, 4, true>(a, stream);
  }
  if (a.d <= 32) return launch_fwd<FeatT, 1, false>(a, stream);
  if (a.d <= 64) return launch_fwd<FeatT, 2, false>(a, stream);
  return launch_fwd<FeatT, 4, false>(a, stream);
}

int dispatch(int feat_kind, bool bwd, bool share, const Args& a, void* stream) {
  if (a.blk_w < 1 || a.blk_w > kMaxBlkW || a.blk_h < 1 || a.run_blocks < 1 || a.d < 1 ||
      a.d > kMaxD || a.tile_kind < 0 || a.tile_kind > 2)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (feat_kind) {
    case 0:
      return launch_cols<float>(bwd, share, a, s);
    case 1:
      return launch_cols<__nv_bfloat16>(bwd, share, a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Forward: out = (A . (xl @ xr^T)) @ xv, f32 [n, d]; xv == nullptr shares xr.
// feat_kind: 0 = float, 1 = bfloat16 (xl, xr, xv).
// tile_kind: 0 = int8, 1 = float, 2 = bfloat16.
// run_window / run_block: num_runs runs of at most run_blocks TC blocks,
// covering every window's blocks in order.  split: some window has more
// than run_blocks blocks; the output is then zeroed here and its runs add
// into it.  1 <= d <= 128, 1 <= blk_w <= 128.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int tcgnn_spmm_sfused(const void* xl, const void* xr, const void* xv,
                                 const void* tiles, const void* col_ids, const void* win_start,
                                 const void* run_window, const void* run_block, void* out, int n,
                                 int d, int num_runs, int run_blocks, int split, int blk_h,
                                 int blk_w, int feat_kind, int tile_kind, void* stream) {
  const bool share = xv == nullptr;
  const Args a{xl, xr, share ? xr : xv, nullptr, nullptr, tiles, col_ids, win_start,
               run_window, run_block, static_cast<float*>(out), nullptr, n, d, num_runs,
               run_blocks, split, blk_h, blk_w, tile_kind};
  return dispatch(feat_kind, false, share, a, stream);
}

// Backward: dx3 and u, both f32 [n, d], from x and dy (feature type as
// above): the gathers read x and dy, the window rows xw and dyw (n rows;
// nullptr: x and dy).  Same tiling arguments as the forward.
extern "C" int tcgnn_spmm_sfused_bwd(const void* x, const void* dy, const void* xw,
                                     const void* dyw, const void* tiles, const void* col_ids,
                                     const void* win_start, const void* run_window,
                                     const void* run_block, void* dx3, void* u, int n, int d,
                                     int num_runs, int run_blocks, int split, int blk_h,
                                     int blk_w, int feat_kind, int tile_kind, void* stream) {
  const Args a{x, dy, nullptr, xw == nullptr ? x : xw, dyw == nullptr ? dy : dyw, tiles,
               col_ids, win_start, run_window, run_block,
               static_cast<float*>(dx3), static_cast<float*>(u), n, d, num_runs, run_blocks,
               split, blk_h, blk_w, tile_kind};
  return dispatch(feat_kind, true, false, a, stream);
}

extern "C" const char* tcgnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
