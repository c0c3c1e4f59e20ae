// Dense-tile SpMM over SGT-condensed tiles, for Hopper (sm_90a), plain
// (K1) and score-weighted (K10).
//
// K1 replaces the TPU kernel `_spmm_grouped_kernel` (tcgnn_tpu/ops/spmm.py:249)
// together with the XLA row gather the TPU had to run in front of it
// (`jnp.take(x, col_ids)`, tcgnn_tpu/ops/spmm.py:348):
//
//   out[w * blk_h + r, :] = sum_{b in window w} sum_k A[b, r, k] * X[col_ids[b * blk_w + k], :]
//
// accumulated in f32 and stored once per output element in the feature type
// (for windows split into runs, see below: one f32 sum per run).
//
// K10 (`tcgnn_spmm_fused`) replaces `_spmm_fused_kernel`
// (tcgnn_tpu/ops/spmm.py:1229, launched by `_spmm_fused_padded`, :1255) and
// its row gather (:1279).  It is the same kernel with a score tile S in the
// feature type beside A: each entry is W = ct(ct(A) * ct(S)), as the TPU
// kernel's `a.astype(ct) * s.astype(ct)`, and the output is f32 whatever the
// feature type.  The distributed layer's fused AGNN runs it when the feature
// axis is split (`parallel/graph.py`): a score needs the whole feature width,
// so the scores come as tiles (K4's tile mode) summed over the feature shards.
//
// What bounds it: latency, and one window.  Each TC block gathers up to
// blk_w rows of X picked by col_ids (pubmed at 512x128: 334 blocks x 128
// gathered rows x d), the tiles are int8 and about 1% full (an average
// degree of 4 in a 512x128 tile), and a random row gather is latency-bound
// long before it is bandwidth-bound.  A hub makes one window far longer
// than the rest (pubmed: one node of degree 17,058, 134 of the 334 TC
// blocks in its window).  What the design does about it:
//   * the gather happens here, into shared memory, not as a separate pass
//     that writes [B * blk_w, d] to device memory and reads it back;
//   * a slab of rows first marks which of the block's blk_w columns it uses,
//     and gathers only those rows (a padding block gathers nothing);
//   * a warp issues all its gather loads before it stores any, and reads its
//     tile rows once, into registers, so each TC block costs about one
//     round trip to memory per phase instead of one per gathered row;
//   * each warp walks its rows' tile entries 32 at a time and skips zeros
//     with a warp-wide ballot, so the multiply-adds follow the edges, not
//     the tile area;
//   * a window of more than run_blocks TC blocks (8, set by the host) is
//     split into runs of run_blocks, one thread block per run, so the hub's
//     window does not walk its blocks alone while the rest of the card idles.
//
// Layout: one thread block of 8 warps per (slab of up to 32 rows of a
// window, d-tile of 32 or 64 columns, run of up to run_blocks TC blocks of
// the window; the host lists the runs in run_window / run_block).  A warp
// owns up to 4 rows; a lane owns 1 or 2 columns of the d-tile.  The block
// walks its run in order, keeping the sums in registers: one partial sum per
// TC block (as a batched tile product sums each block), then one sum across
// blocks.  A window of one run stores its sums once, in the feature type.
// The runs of a split window add their f32 sums into `accum` (zeroed first)
// with atomics, in no fixed order; `accum` is the output itself for f32, and
// an f32 buffer converted once afterwards for bf16.  Rows past n in the
// last, partial window are not stored.  A window whose only block is a
// padding block stores zeros.  blk_w is at most 128 (a warp holds a tile row
// in 4 registers a lane).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSlab = 32;                        // rows of a window per thread block
constexpr int kMaxRowsPerWarp = kSlab / kWarps;  // 4
constexpr int kMaxBlkW = 128;
constexpr int kMaxChunks = kMaxBlkW / 32;             // tile-row registers per lane
constexpr int kMaxGatherRows = kMaxBlkW / kWarps;     // gathered rows per warp

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

// A value rounded to the feature type, as the TPU kernel casts its tiles
// (`a_ref[k].astype(compute_dtype)`): weighted f32 tiles round to bf16
// under bf16.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// kScored: multiply each tile entry by its score (K10); `scores` is unread
// otherwise.  OutT: the feature type (K1) or float (K10).
template <typename FeatT, typename TileT, typename OutT, bool kScored, int kColsPerLane>
__global__ void __launch_bounds__(kThreads)
spmm_dense_kernel(const FeatT* __restrict__ x, const TileT* __restrict__ tiles,
                  const FeatT* __restrict__ scores,
                  const int* __restrict__ col_ids, const int* __restrict__ win_start,
                  const int* __restrict__ run_window, const int* __restrict__ run_block,
                  OutT* out, float* accum, int n, int d,
                  int run_blocks, int blk_h, int blk_w, int slab, int slabs_per_window) {
  constexpr int kTileD = 32 * kColsPerLane;
  const int run = blockIdx.x / slabs_per_window;
  const int win = run_window[run];
  const int w_begin = win_start[win], w_end = win_start[win + 1];
  const int b_begin = run_block[run];
  const int b_end = min(b_begin + run_blocks, w_end);
  const bool split = w_end - w_begin > run_blocks;

  __shared__ float xs[kMaxBlkW * kTileD];  // gathered rows of this d-tile
  __shared__ int used_by[kMaxBlkW];        // last TC block whose slab rows use column k

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x % slabs_per_window) * slab;  // slab's first row in the window
  const int d0 = blockIdx.y * kTileD;
  const int rows_per_warp = (slab + kWarps - 1) / kWarps;    // <= kMaxRowsPerWarp

  for (int k = threadIdx.x; k < kMaxBlkW; k += kThreads) used_by[k] = -1;
  __syncthreads();

  float acc[kMaxRowsPerWarp][kColsPerLane];
#pragma unroll
  for (int i = 0; i < kMaxRowsPerWarp; ++i)
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) acc[i][c] = 0.f;

  for (int b = b_begin; b < b_end; ++b) {
    const size_t tile0 = (size_t)b * blk_h * blk_w;

    // 1. The warp's tile rows (K10: rows of W) into registers (lane holds
    //    columns q*32+lane), marking the columns they use with this block's
    //    index.
    float a[kMaxRowsPerWarp][kMaxChunks];
#pragma unroll
    for (int i = 0; i < kMaxRowsPerWarp; ++i) {
      const int lr = warp * rows_per_warp + i;
      const int r = row0 + lr;
      const bool row_ok = i < rows_per_warp && lr < slab && r < blk_h;
#pragma unroll
      for (int q = 0; q < kMaxChunks; ++q) {
        const int k = q * 32 + lane;
        const size_t at = tile0 + (size_t)r * blk_w + k;
        float w = row_ok && k < blk_w ? round_to<FeatT>(to_f32(tiles[at])) : 0.f;
        if (kScored && w != 0.f) w = round_to<FeatT>(w * to_f32(scores[at]));
        a[i][q] = w;
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxRowsPerWarp; ++i)
#pragma unroll
      for (int q = 0; q < kMaxChunks; ++q)
        if (a[i][q] != 0.f) used_by[q * 32 + lane] = b;
    __syncthreads();

    // 2. Gather the used rows of X (this d-tile only) into shared memory:
    //    every load of the warp is in flight before the first store.
    const int* cols = col_ids + (size_t)b * blk_w;
    int src[kMaxGatherRows];
#pragma unroll
    for (int j = 0; j < kMaxGatherRows; ++j) {
      const int k = warp + j * kWarps;
      src[j] = k < blk_w && used_by[k] == b ? cols[k] : -1;
    }
    float v[kMaxGatherRows][kColsPerLane];
#pragma unroll
    for (int j = 0; j < kMaxGatherRows; ++j)
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) {
        const int col = d0 + lane + 32 * c;
        v[j][c] = src[j] >= 0 && col < d ? to_f32(x[(size_t)src[j] * d + col]) : 0.f;
      }
#pragma unroll
    for (int j = 0; j < kMaxGatherRows; ++j)
      if (src[j] >= 0) {
        const int k = warp + j * kWarps;
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c) xs[k * kTileD + lane + 32 * c] = v[j][c];
      }
    __syncthreads();

    // 3. Multiply the slab's tile rows with the gathered rows, nonzeros only.
    //    (The next block's gather writes xs only after its barrier, which
    //    every thread reaches after finishing this step.)
#pragma unroll
    for (int i = 0; i < kMaxRowsPerWarp; ++i) {
      const int lr = warp * rows_per_warp + i;
      const int r = row0 + lr;
      if (i < rows_per_warp && lr < slab && r < blk_h) {
        float part[kColsPerLane];
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c) part[c] = 0.f;
#pragma unroll
        for (int q = 0; q < kMaxChunks; ++q) {
          unsigned nz = __ballot_sync(0xffffffffu, a[i][q] != 0.f);
          while (nz) {
            const int j = __ffs(nz) - 1;
            nz &= nz - 1;
            const float aj = __shfl_sync(0xffffffffu, a[i][q], j);
            const float* xk = xs + (q * 32 + j) * kTileD;
#pragma unroll
            for (int c = 0; c < kColsPerLane; ++c) part[c] = fmaf(aj, xk[lane + 32 * c], part[c]);
          }
        }
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c) acc[i][c] += part[c];
      }
    }
  }

  // 4. One store per output element in the output type, or, for a run of
  //    a split window, an f32 atomic add.
#pragma unroll
  for (int i = 0; i < kMaxRowsPerWarp; ++i) {
    const int lr = warp * rows_per_warp + i;
    const int r = row0 + lr;
    const long long grow = (long long)win * blk_h + r;
    if (i < rows_per_warp && lr < slab && r < blk_h && grow < n) {
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) {
        const int col = d0 + lane + 32 * c;
        if (col >= d) continue;
        if (split)
          atomicAdd(accum + grow * d + col, acc[i][c]);
        else
          store(out + grow * d + col, acc[i][c]);
      }
    }
  }
}

// bf16 output of split windows: one conversion of their f32 sums.
__global__ void __launch_bounds__(kThreads)
convert_split_windows(const float* __restrict__ accum, const int* __restrict__ win_start,
                      __nv_bfloat16* __restrict__ out, int n, int d, int blk_h,
                      int run_blocks) {
  const int win = blockIdx.x;
  if (win_start[win + 1] - win_start[win] <= run_blocks) return;
  const long long first = (long long)win * blk_h * d;
  const long long last = min((long long)(win + 1) * blk_h, (long long)n) * d;
  for (long long i = first + (long long)blockIdx.y * kThreads + threadIdx.x; i < last;
       i += (long long)gridDim.y * kThreads)
    out[i] = __float2bfloat16(accum[i]);
}

struct Args {
  const void *x, *tiles, *scores, *col_ids, *win_start, *run_window, *run_block;
  void *out, *accum;
  int n, d, num_windows, num_runs, run_blocks, split, blk_h, blk_w;
};

template <typename FeatT, typename TileT, typename OutT, bool kScored, int kColsPerLane>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int kTileD = 32 * kColsPerLane;
  const int slab = a.blk_h < kSlab ? a.blk_h : kSlab;
  const int slabs_per_window = (a.blk_h + slab - 1) / slab;
  if (a.split) {
    const cudaError_t e =
        cudaMemsetAsync(a.accum, 0, (size_t)a.n * a.d * sizeof(float), stream);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)a.num_runs * (unsigned)slabs_per_window,
                  (unsigned)((a.d + kTileD - 1) / kTileD));
  spmm_dense_kernel<FeatT, TileT, OutT, kScored, kColsPerLane><<<grid, kThreads, 0, stream>>>(
      static_cast<const FeatT*>(a.x), static_cast<const TileT*>(a.tiles),
      static_cast<const FeatT*>(a.scores),
      static_cast<const int*>(a.col_ids), static_cast<const int*>(a.win_start),
      static_cast<const int*>(a.run_window), static_cast<const int*>(a.run_block),
      static_cast<OutT*>(a.out), static_cast<float*>(a.accum), a.n, a.d, a.run_blocks,
      a.blk_h, a.blk_w, slab, slabs_per_window);
  const cudaError_t e = cudaGetLastError();
  if constexpr (std::is_same<OutT, __nv_bfloat16>::value) {
    if (e == cudaSuccess && a.split) {
      convert_split_windows<<<dim3((unsigned)a.num_windows, 32), kThreads, 0, stream>>>(
          static_cast<const float*>(a.accum), static_cast<const int*>(a.win_start),
          static_cast<__nv_bfloat16*>(a.out), a.n, a.d, a.blk_h, a.run_blocks);
      return (int)cudaGetLastError();
    }
  }
  return (int)e;
}

template <typename FeatT, typename TileT, typename OutT, bool kScored>
int launch_cols(const Args& a, cudaStream_t stream) {
  return a.d <= 32 ? launch<FeatT, TileT, OutT, kScored, 1>(a, stream)
                   : launch<FeatT, TileT, OutT, kScored, 2>(a, stream);
}

template <typename FeatT, typename OutT, bool kScored>
int launch_tile(int tile_kind, const Args& a, cudaStream_t stream) {
  switch (tile_kind) {
    case 0:
      return launch_cols<FeatT, int8_t, OutT, kScored>(a, stream);
    case 1:
      return launch_cols<FeatT, float, OutT, kScored>(a, stream);
    case 2:
      return launch_cols<FeatT, __nv_bfloat16, OutT, kScored>(a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// feat_kind: 0 = float, 1 = bfloat16 (x and out).
// tile_kind: 0 = int8, 1 = float, 2 = bfloat16.
// run_window / run_block: num_runs runs of at most run_blocks TC blocks,
// covering every window's blocks in order.  split: some window has more
// than run_blocks blocks; its runs then add into `out` (f32, zeroed here)
// or, for bf16, into `accum`, an f32 [n, d] buffer zeroed here and converted
// into `out` afterwards.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int tcgnn_spmm_dense(const void* x, const void* tiles, const void* col_ids,
                                const void* win_start, const void* run_window,
                                const void* run_block, void* out, void* accum, int n, int d,
                                int num_windows, int num_runs, int run_blocks, int split,
                                int blk_h, int blk_w, int feat_kind, int tile_kind,
                                void* stream) {
  if (blk_w < 1 || blk_w > kMaxBlkW || blk_h < 1 || run_blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (feat_kind == 0) accum = out;
  if (split && accum == nullptr) return (int)cudaErrorInvalidValue;
  const Args a{x, tiles, nullptr, col_ids, win_start, run_window, run_block, out, accum,
               n, d, num_windows, num_runs, run_blocks, split, blk_h, blk_w};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (feat_kind) {
    case 0:
      return launch_tile<float, float, false>(tile_kind, a, s);
    case 1:
      return launch_tile<__nv_bfloat16, __nv_bfloat16, false>(tile_kind, a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K10: out = (A . S) @ x, f32 [n, d] (n = the windows' rows), x of any row
// count (col_ids index it).  feat_kind: 0 = float, 1 = bfloat16 (x and the
// score tiles).  tile_kind as above (the structural tiles).  Runs as above;
// with split, the output is zeroed here and its runs add into it.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int tcgnn_spmm_fused(const void* x, const void* tiles, const void* scores,
                                const void* col_ids, const void* win_start,
                                const void* run_window, const void* run_block, void* out, int n,
                                int d, int num_runs, int run_blocks, int split, int blk_h,
                                int blk_w, int feat_kind, int tile_kind, void* stream) {
  if (blk_w < 1 || blk_w > kMaxBlkW || blk_h < 1 || run_blocks < 1 || d < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{x, tiles, scores, col_ids, win_start, run_window, run_block, out, out,
               n, d, 0, num_runs, run_blocks, split, blk_h, blk_w};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (feat_kind) {
    case 0:
      return launch_tile<float, float, true>(tile_kind, a, s);
    case 1:
      return launch_tile<__nv_bfloat16, float, true>(tile_kind, a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* tcgnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
