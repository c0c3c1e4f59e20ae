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
// What bounds it: latency.  The tiles are int8 and about 1% full at
// 512x128 (pubmed: 334 blocks, 21.9 MB of tiles, 0.0065 ms at 3.35 TB/s;
// an average degree of 4 in a 512x128 tile), so the bytes are few and each
// nonzero costs a dependent chain: its column id, then its row of x.  A hub
// makes one window far longer than the rest (pubmed: one node of degree
// 17,058, 134 of the 334 TC blocks in its window), and a shard of the
// distributed layer has few windows (the heaviest pubmed 4x2 shard: 11
// windows, 88 blocks).  What the design does about it
// (csrc/sparse_row.cuh):
//   * a warp owns tile rows (2 to 4 of a window) of a run of at most
//     run_blocks TC blocks (8, set by the host): a row of at most 8 x 128
//     entries, read in 16-byte units (an int8 block row of 128 in one load
//     of 8 lanes), the warp's next row in flight while the current one is
//     gathered; a window of more than run_blocks blocks is split into runs,
//     and each run of such a window into parts of at most kList entries a
//     row (a hub's row is nonzero in nearly every column of its run, and its
//     list sets the pace), one thread block a (run, part, slab of 16 to 32
//     rows), so the hub's window and a shard's few windows give thousands of
//     thread blocks;
//   * the row's nonzeros go into a list in shared memory (an exclusive scan
//     of the lanes' counts keeps a fixed order); the gather reads each
//     listed entry's column id (from the run's contiguous stretch of
//     col_ids), its tile entry and, for K10, its score, four entries' loads
//     in flight a lane, then their rows of x, with groups of d/4 lanes each
//     fetching one row, 4 columns a lane in one load, so no lane idles at
//     small d;
//   * no barrier of the thread block and no staging of gathered rows in
//     shared memory: a row's chain is its tile units (already in flight),
//     its entries' column ids, their rows of x.
// Tile rows that are not 16-byte units (int8 rows of blk_w = 8) are read an
// entry a lane, and x rows whose width is not a multiple of 4 a column at a
// time, inside the same kernel.
//
// A window of one run stores its sums once, in the output type.  The
// parts of a split window's runs add their f32 sums into `accum` with
// atomics, in no fixed order, where a row has nonzeros in the part;
// `accum` is the output itself for f32, and an f32 buffer converted once
// afterwards for bf16, and only the split windows' rows of it are zeroed
// first.  Rows past n in the last, partial window are not stored.  A window
// whose only block is a padding block stores zeros.  blk_w is at most 128
// and run_blocks * blk_w at most 1024 (a lane's 32-bit mask of its row's
// nonzeros).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "sparse_row.cuh"

namespace {

namespace sr = sparse_row;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxBlkW = 128;
constexpr int kVecTiles = 1, kVecX = 2;  // flags

// Tile row r of the run's blocks [b_begin, b_begin + nb) as 16-byte units:
// u[i] is unit lane + 32 i of the row's nb * blk_w entries (blk_w % E == 0,
// so a unit lies in one block), zero past them.
template <typename TileT, int kU>
__device__ __forceinline__ void load_tile_units(uint4 (&u)[kU], const TileT* tiles, int b_begin,
                                                int nb, int r, int blk_h, int blk_w) {
  constexpr int E = 16 / sizeof(TileT);
  const int lane = threadIdx.x & 31;
  const int per_block = blk_w / E;
#pragma unroll
  for (int i = 0; i < kU; ++i) {
    const int idx = lane + 32 * i;
    if (idx < nb * per_block) {
      const int bi = idx / per_block;
      const size_t at = ((size_t)(b_begin + bi) * blk_h + r) * blk_w + (size_t)(idx - bi * per_block) * E;
      u[i] = __ldg(reinterpret_cast<const uint4*>(tiles + at));
    } else {
      u[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// kScored: multiply each tile entry by its score (K10); `scores` is unread
// otherwise.  OutT: the feature type (K1) or float (K10).
template <typename FeatT, typename TileT, typename OutT, bool kScored>
__global__ void __launch_bounds__(kThreads)
spmm_dense_kernel(const FeatT* __restrict__ x, const TileT* __restrict__ tiles,
                  const FeatT* __restrict__ scores,
                  const int* __restrict__ col_ids, const int* __restrict__ win_start,
                  const int* __restrict__ run_window, const int* __restrict__ run_block,
                  OutT* out, float* accum, int n, int d,
                  int run_blocks, int blk_h, int blk_w, int rows_per_warp,
                  int slabs_per_window, int parts, int flags) {
  constexpr int E = 16 / sizeof(TileT);  // tile entries of a 16-byte unit
  constexpr int kU = sr::kRowElems / E / 32;
  __shared__ int s_idx[kWarps][sr::kList];
  // blockIdx.x: (run, part of the run, slab of the window).  A run of a
  // split window is cut into `parts` parts of sub_blocks blocks (a hub's
  // row holds a nonzero in nearly every column of its run, and its list
  // sets the run's pace); a run of a window that is not split is one part.
  const int slab = blockIdx.x % slabs_per_window;
  const int part = blockIdx.x / slabs_per_window % parts;
  const int run = blockIdx.x / slabs_per_window / parts;
  const int win = run_window[run];
  const int w_begin = win_start[win], w_end = win_start[win + 1];
  const bool split = w_end - w_begin > run_blocks;
  const int run_end = min(run_block[run] + run_blocks, w_end);
  const int sub_blocks = split ? (run_blocks + parts - 1) / parts : run_blocks;
  const int b_begin = run_block[run] + part * sub_blocks;
  const int nb = min(sub_blocks, run_end - b_begin);
  if (nb <= 0 || (!split && part > 0)) return;
  const int elems = nb * blk_w;  // entries of a row over the run, <= 1024
  const int* cols = col_ids + (size_t)b_begin * blk_w;  // entry t's column: cols[t]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool vec_tiles = flags & kVecTiles, vec_x = flags & kVecX;
  const int d0 = blockIdx.y * sr::kTileD;
  const int g = sr::group_lanes(min(d - d0, sr::kTileD));
  const int c0 = d0 + (lane % g) * sr::kVec;
  const int r0 = (slab * kWarps + warp) * rows_per_warp;
  const int r_end = min(r0 + rows_per_warp, blk_h);

  uint4 next[kU];
  if (vec_tiles && r0 < r_end) load_tile_units<TileT>(next, tiles, b_begin, nb, r0, blk_h, blk_w);
  for (int r = r0; r < r_end; ++r) {
    // Entry t of row r: its column, and its tile (and score) entry.
    auto entry = [&](int t, int& col, float& val) {
      const int bi = t / blk_w;
      const size_t at = ((size_t)(b_begin + bi) * blk_h + r) * blk_w + (t - bi * blk_w);
      col = __ldg(cols + t);
      val = sr::round_to<FeatT>(sr::to_f32(tiles[at]));
      if constexpr (kScored) val = sr::round_to<FeatT>(val * sr::to_f32(scores[at]));
    };
    unsigned mask = 0;
    int nnz;
    float acc[sr::kVec];
    if (vec_tiles) {
      // Bit i * E + e of the lane is entry (lane + 32 i) * E + e of the row.
#pragma unroll
      for (int i = 0; i < kU; ++i) {
        const uint4 u = next[i];
        if (u.x | u.y | u.z | u.w) mask |= sr::unit_mask<TileT, FeatT>(u) << (i * E);
      }
      if (r + 1 < r_end) load_tile_units<TileT>(next, tiles, b_begin, nb, r + 1, blk_h, blk_w);
      nnz = sr::reduce_row(acc, mask, s_idx[warp],
                           [&](int bit) { return (lane + 32 * (bit / E)) * E + bit % E; },
                           entry, x, d, c0, g, vec_x);
    } else {
      // Bit q of the lane is entry lane + 32 q of the row.
#pragma unroll 8
      for (int q = 0; q < 32; ++q) {
        const int t = lane + 32 * q;
        if (t < elems) {
          const int bi = t / blk_w;
          const size_t at = ((size_t)(b_begin + bi) * blk_h + r) * blk_w + (t - bi * blk_w);
          if (sr::round_to<FeatT>(sr::to_f32(tiles[at])) != 0.f) mask |= 1u << q;
        }
      }
      nnz = sr::reduce_row(acc, mask, s_idx[warp], [&](int bit) { return lane + 32 * bit; },
                           entry, x, d, c0, g, vec_x);
    }
    // One store per output element in the output type, or, for a part of a
    // split window's run, f32 atomic adds where the row has nonzeros.
    const long long grow = (long long)win * blk_h + r;
    if (lane < g && grow < n) {
      if (!split)
        sr::store4(out + grow * d, c0, d, acc, vec_x);
      else if (nnz > 0)
        sr::atomic_add4(accum + grow * d, c0, d, acc);
    }
  }
}

// The f32 sums of split windows zeroed before their runs add into them
// (the rows of other windows are stored whole).
__global__ void __launch_bounds__(kThreads)
zero_split_windows(float* __restrict__ accum, const int* __restrict__ win_start, int n, int d,
                   int blk_h, int run_blocks) {
  const int win = blockIdx.x;
  if (win_start[win + 1] - win_start[win] <= run_blocks) return;
  const long long first = (long long)win * blk_h * d;
  const long long last = min((long long)(win + 1) * blk_h, (long long)n) * d;
  for (long long i = first + (long long)blockIdx.y * kThreads + threadIdx.x; i < last;
       i += (long long)gridDim.y * kThreads)
    accum[i] = 0.f;
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

template <typename FeatT, typename TileT, typename OutT, bool kScored>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(TileT);
  // Rows a warp walks: 2 to 4, fewer where windows are short, so that a
  // window of 16 rows still fills the thread block.
  const int rows_per_warp = std::min(std::max(a.blk_h / (kWarps * 16), 2), 4);
  const int slabs_per_window = (a.blk_h + kWarps * rows_per_warp - 1) / (kWarps * rows_per_warp);
  // Parts of a split window's run: a row's part at most kList entries.
  const int parts = std::min(std::max(a.run_blocks * a.blk_w / sr::kList, 1), a.run_blocks);
  int flags = 0;
  if (a.blk_w % E == 0 && sr::aligned16(a.tiles)) flags |= kVecTiles;
  if (a.d % 4 == 0 && sr::aligned16(a.x) && sr::aligned16(a.out)) flags |= kVecX;
  // Thread blocks a window for the split windows' zeroing and conversion:
  // about 8 elements a thread, at most 32.
  const long long per = (long long)a.blk_h * a.d / (kThreads * 8);
  const unsigned per_window = per < 1 ? 1u : per > 32 ? 32u : (unsigned)per;
  if (a.split) {
    zero_split_windows<<<dim3((unsigned)a.num_windows, per_window), kThreads, 0, stream>>>(
        static_cast<float*>(a.accum), static_cast<const int*>(a.win_start), a.n, a.d, a.blk_h,
        a.run_blocks);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)a.num_runs * (unsigned)parts * (unsigned)slabs_per_window,
                  (unsigned)((a.d + sr::kTileD - 1) / sr::kTileD));
  spmm_dense_kernel<FeatT, TileT, OutT, kScored><<<grid, kThreads, 0, stream>>>(
      static_cast<const FeatT*>(a.x), static_cast<const TileT*>(a.tiles),
      static_cast<const FeatT*>(a.scores),
      static_cast<const int*>(a.col_ids), static_cast<const int*>(a.win_start),
      static_cast<const int*>(a.run_window), static_cast<const int*>(a.run_block),
      static_cast<OutT*>(a.out), static_cast<float*>(a.accum), a.n, a.d, a.run_blocks,
      a.blk_h, a.blk_w, rows_per_warp, slabs_per_window, parts, flags);
  const cudaError_t e = cudaGetLastError();
  if constexpr (std::is_same<OutT, __nv_bfloat16>::value) {
    if (e == cudaSuccess && a.split) {
      convert_split_windows<<<dim3((unsigned)a.num_windows, per_window), kThreads, 0,
                              stream>>>(
          static_cast<const float*>(a.accum), static_cast<const int*>(a.win_start),
          static_cast<__nv_bfloat16*>(a.out), a.n, a.d, a.blk_h, a.run_blocks);
      return (int)cudaGetLastError();
    }
  }
  return (int)e;
}

template <typename FeatT, typename OutT, bool kScored>
int launch_tile(int tile_kind, const Args& a, cudaStream_t stream) {
  switch (tile_kind) {
    case 0:
      return launch<FeatT, int8_t, OutT, kScored>(a, stream);
    case 1:
      return launch<FeatT, float, OutT, kScored>(a, stream);
    case 2:
      return launch<FeatT, __nv_bfloat16, OutT, kScored>(a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// feat_kind: 0 = float, 1 = bfloat16 (x and out).
// tile_kind: 0 = int8, 1 = float, 2 = bfloat16.
// run_window / run_block: num_runs runs of at most run_blocks TC blocks,
// covering every window's blocks in order.  split: some window has more
// than run_blocks blocks; the runs of such a window then add into `out`
// (f32) or, for bf16, into `accum`, an f32 [n, d] buffer converted into
// `out` afterwards, their rows zeroed here first.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int tcgnn_spmm_dense(const void* x, const void* tiles, const void* col_ids,
                                const void* win_start, const void* run_window,
                                const void* run_block, void* out, void* accum, int n, int d,
                                int num_windows, int num_runs, int run_blocks, int split,
                                int blk_h, int blk_w, int feat_kind, int tile_kind,
                                void* stream) {
  if (blk_w < 1 || blk_w > kMaxBlkW || blk_h < 1 || run_blocks < 1 ||
      run_blocks * blk_w > sr::kRowElems)
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
// with split, the split windows' rows of the output are zeroed here and
// their runs add into them.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int tcgnn_spmm_fused(const void* x, const void* tiles, const void* scores,
                                const void* col_ids, const void* win_start,
                                const void* run_window, const void* run_block, void* out, int n,
                                int d, int num_runs, int run_blocks, int split, int blk_h,
                                int blk_w, int feat_kind, int tile_kind, void* stream) {
  if (blk_w < 1 || blk_w > kMaxBlkW || blk_h < 1 || run_blocks < 1 ||
      run_blocks * blk_w > sr::kRowElems || d < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{x, tiles, scores, col_ids, win_start, run_window, run_block, out, out,
               n, d, (n + blk_h - 1) / blk_h, num_runs, run_blocks, split, blk_h, blk_w};
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
