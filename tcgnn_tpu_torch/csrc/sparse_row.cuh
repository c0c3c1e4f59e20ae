// One warp reduces one sparse row: the pieces the dense-tile SpMM (K1 and
// K10, csrc/spmm_dense.cu) and the block-diagonal SpMM (K5,
// csrc/spmm_bd.cu) share.  The edge-range kernels (K8 and K9,
// csrc/chunk.cu; K4, csrc/sddmm_dense.cu) take their lane groups, loads,
// range size and four-dot reduction from here too.
//
// A row holds at most kRowElems entries (a K5 pack row of K*bn <= 1024, or
// a K1 tile row over a run of at most 8 TC blocks of blk_w <= 128), almost
// all zero.  The warp reads the row in 16-byte units, lane l holding units
// l, l + 32, ... (a lane holds at most 32 entries, so one 32-bit mask a
// lane marks its nonzeros), or, where the row is not 16-byte aligned, one
// entry a lane at a time; zero units and words are skipped with integer
// compares.  An exclusive scan of the masks' counts gives each nonzero its
// place in a list in shared memory, in a fixed order, so the sums are the
// same from run to run.  The list holds row positions only: each entry's
// column and value are read in the gather, four entries' loads in flight a
// lane before their rows of x are read.  In the gather, lanes form groups
// of g (4 g >= the columns of the d-tile), each lane holding 4 consecutive
// columns, so one load instruction of the warp fetches 32 / g listed rows
// and no lane idles at small d.  The groups' partial sums meet by
// shuffles.  A list longer than kList entries (a dense row) is gathered in
// windows of kList.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace sparse_row {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kVec = 4;             // feature columns a lane holds
constexpr int kTileD = 32 * kVec;   // columns of a d-tile (grid.y)
constexpr int kList = 256;          // entries of a warp's list window
constexpr int kRowElems = 1024;     // entries of a row at most: 32 a lane

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(int16_t v) { return static_cast<float>(v); }

// A value rounded to the compute type (a no-op for f32).
template <typename T>
__device__ __forceinline__ float round_to(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The nonzero entries of a 16-byte unit of T entries, bit e for entry e,
// judged as the kernel's rounding to FeatT leaves them: integer compares
// on the words, a float compare only for f32 entries.
template <typename T, typename FeatT>
__device__ __forceinline__ unsigned unit_mask(const uint4& u) {
  constexpr int E = 16 / sizeof(T);
  unsigned m = 0;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const unsigned word = (&u.x)[w];
    unsigned b;
    if constexpr (sizeof(T) == 1) {
      // 0x01 in each nonzero byte, gathered into the top byte in order.
      b = ((__vcmpne4(word, 0u) & 0x01010101u) * 0x01020408u) >> 24;
    } else if constexpr (sizeof(T) == 2) {
      // int16: any nonzero half; bf16: a half other than +-0.
      const unsigned lo = std::is_same<T, int16_t>::value ? 0xffffu : 0x7fffu;
      b = ((word & lo) != 0u ? 1u : 0u) | ((word & (lo << 16)) != 0u ? 2u : 0u);
    } else {
      b = round_to<FeatT>(__uint_as_float(word)) != 0.f ? 1u : 0u;
    }
    m |= b << (w * (E / 4));
  }
  return m;
}

// Lanes of a group: the least power of two g with 4 g >= cols (cols <= 128).
__device__ __forceinline__ int group_lanes(int cols) {
  int g = 1;
  while (g * kVec < cols) g <<= 1;
  return g;
}

// Exclusive prefix sum of c over the warp; `total` gets the warp's sum.
__device__ __forceinline__ int warp_exclusive_scan(int c, int& total) {
  const int lane = threadIdx.x & 31;
  int s = c;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(kFull, s, off);
    if (lane >= off) s += t;
  }
  total = __shfl_sync(kFull, s, 31);
  return s - c;
}

// Columns [c0, c0 + 4) of a row of x, zero past d.  vec: d % 4 == 0 and x
// 16-byte aligned, so the four are one 16-byte (f32) or 8-byte (bf16) load.
template <typename T>
__device__ __forceinline__ void load4(float (&v)[kVec], const T* __restrict__ row, int c0, int d,
                                      bool vec) {
  if (vec) {
    if (c0 >= d) {
#pragma unroll
      for (int c = 0; c < kVec; ++c) v[c] = 0.f;
    } else if constexpr (sizeof(T) == 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(row + c0));
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(row + c0));
      v[0] = __uint_as_float(q.x << 16);
      v[1] = __uint_as_float(q.x & 0xffff0000u);
      v[2] = __uint_as_float(q.y << 16);
      v[3] = __uint_as_float(q.y & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int c = 0; c < kVec; ++c) v[c] = c0 + c < d ? to_f32(row[c0 + c]) : 0.f;
  }
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Columns [c0, c0 + 4) of an output row, each stored once in OutT; vec as
// for load4.
template <typename OutT>
__device__ __forceinline__ void store4(OutT* row, int c0, int d, const float (&acc)[kVec],
                                       bool vec) {
  if (c0 >= d) return;
  if (vec) {
    if constexpr (sizeof(OutT) == 4) {
      *reinterpret_cast<float4*>(row + c0) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(acc[0], acc[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(acc[2], acc[3]);
      uint2 q;
      q.x = *reinterpret_cast<const unsigned*>(&lo);
      q.y = *reinterpret_cast<const unsigned*>(&hi);
      *reinterpret_cast<uint2*>(row + c0) = q;
    }
  } else {
#pragma unroll
    for (int c = 0; c < kVec; ++c)
      if (c0 + c < d) store1(row + c0 + c, acc[c]);
  }
}

__device__ __forceinline__ void atomic_add4(float* row, int c0, int d, const float (&acc)[kVec]) {
#pragma unroll
  for (int c = 0; c < kVec; ++c)
    if (c0 + c < d) atomicAdd(row + c0 + c, acc[c]);
}

// acc += sum over the list's cnt entries p (this lane's group takes
// p = grp, grp + ngrp, ...) of val * x[col, c0:c0+4], with
// entry(s_idx[p], col, val) giving an entry's column and value (its loads
// issued for four entries before their rows of x are read).
template <typename FeatT, typename EntryFn>
__device__ __forceinline__ void gather_add(float (&acc)[kVec], const int* s_idx, int cnt,
                                           EntryFn entry, const FeatT* __restrict__ x, int d,
                                           int c0, int grp, int ngrp, bool vec) {
  int p = grp;
  for (; p + 3 * ngrp < cnt; p += 4 * ngrp) {
    int col[4];
    float a[4], v[4][kVec];
#pragma unroll
    for (int i = 0; i < 4; ++i) entry(s_idx[p + i * ngrp], col[i], a[i]);
#pragma unroll
    for (int i = 0; i < 4; ++i) load4(v[i], x + (long long)col[i] * d, c0, d, vec);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < kVec; ++c) acc[c] = fmaf(a[i], v[i][c], acc[c]);
  }
  for (; p < cnt; p += ngrp) {
    int col;
    float a, v[kVec];
    entry(s_idx[p], col, a);
    load4(v, x + (long long)col * d, c0, d, vec);
#pragma unroll
    for (int c = 0; c < kVec; ++c) acc[c] = fmaf(a, v[c], acc[c]);
  }
}

// The row's nonzeros, marked in each lane's `mask`, through the warp's list
// (s_idx: kList entries) into acc, then summed over the groups: on return
// every lane of a group holds the row's sums for its 4 columns.  index(bit)
// gives the row position of the lane's entry `bit` (cheap: the list holds
// positions only); entry(position, col, val) reads an entry's column and
// value, in the gather, where its loads overlap the others'.  Returns the
// row's count of nonzeros.
template <typename FeatT, typename IndexFn, typename EntryFn>
__device__ __forceinline__ int reduce_row(float (&acc)[kVec], unsigned mask, int* s_idx,
                                           IndexFn index, EntryFn entry,
                                           const FeatT* __restrict__ x, int d, int c0, int g,
                                           bool vec) {
  const int lane = threadIdx.x & 31;
  const int grp = lane / g, ngrp = 32 / g;
  const int mine = __popc(mask);
  int total;
  const int first = warp_exclusive_scan(mine, total);
#pragma unroll
  for (int c = 0; c < kVec; ++c) acc[c] = 0.f;
  for (int base = 0; base < total; base += kList) {
    if (mine && first < base + kList && first + mine > base) {
      int pos = first;
      for (unsigned m = mask; m; m &= m - 1, ++pos)
        if (pos >= base && pos < base + kList) s_idx[pos - base] = index(__ffs(m) - 1);
    }
    __syncwarp();
    gather_add(acc, s_idx, min(total - base, kList), entry, x, d, c0, grp, ngrp, vec);
    __syncwarp();
  }
#pragma unroll
  for (int off = g; off < 32; off <<= 1)
#pragma unroll
    for (int c = 0; c < kVec; ++c) acc[c] += __shfl_xor_sync(kFull, acc[c], off);
  return total;
}

// Edges a warp takes in the edge-range kernels (K8, K9 and K4): enough
// warps to fill the card twice over, in `least` (a power of two) to 1,024
// edges (small graphs get many short ranges, reddit 1,024).
__host__ inline int edges_per_warp(long long num_edges, int least = 32) {
  const long long target = num_edges / (132LL * 64 * 2);
  int p = least;
  while (p < 1024 && p < target) p <<= 1;
  return p;
}

// The dots of four edges, each held in parts by the g >= 4 lanes of a
// group (K9 and K4), summed by recursive halving: a lane of the group's
// upper half keeps edges 2 and 3 and adds its partner's parts of them, the
// lower half edges 0 and 1; then the upper quarter of each half keeps the
// second, the lower the first; the remaining levels sum it over the quarter.
// log2(g) + 1 shuffles for the four (4 log2(g) one at a time).  Returns the
// lane's sum and sets i to its edge.
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

// 16-byte aligned, for the vector paths.
__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace sparse_row
