// The mean negative log-likelihood over all nodes, forward and backward, for
// Hopper (sm_90a).
//
//   loss = -(1 / |K|) * sum_{i in K} logp[i, y[i]],   K = {i : y[i] != -100}
//   dlogp[i, c] = -(g / |K|) where c == y[i] (i in K), else 0
//
// Replaces no TPU kernel: the JAX package takes a one-hot NLL that XLA fuses
// into the log-softmax (tcgnn_tpu/train.py, loss_fn).  Added because
// PyTorch's F.nll_loss reduces all N rows in one thread block
// (nll_loss_forward_reduce_cuda_kernel_2d and its backward), so its time
// grows with the rows and not with the bytes: about 1.7 ms of an epoch over
// Yeast's 1.7 M rows.  Bound by bytes: the labels (8N), one f32 of logp a
// row (4N) and the N x C gradient (4NC), each moved once: 34 MB on Yeast
// (C 2), 41 MB on amazon0505 (C 22), 0.010-0.012 ms at 3.35 TB/s.
//
// nll_forward_kernel: one thread a row over a grid of at most `blocks`
// blocks (grid-stride past it), each thread summing -logp[i, y[i]] and its
// count in double; each block reduces them in a fixed tree into one partial
// of the scratch; the last block to take the integer ticket (zeroed by a
// memset before each launch) sums the partials in a fixed order and writes
// the mean and the count.  No float atomics: the same inputs give the same bits on every
// launch and every replay of a captured graph.  A label outside [0, C) that
// is not -100 fails a device assertion, as PyTorch's kernel does; there is
// no host check, which would synchronise inside a captured step.
//
// nll_backward_kernel: one flat, coalesced pass over the N x C gradient,
// four elements a thread (one 16-byte store), writing every element: it
// replaces the library's zero-fill and its one-block scatter.  g and the
// count are read on the device.

#include <cuda_runtime.h>

#include <cassert>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kIgnoreIndex = -100;
constexpr int kBackwardMaxBlocks = 16384;

// The block's sum of v, in thread 0, in a fixed order (a warp's shuffle
// tree, then the warps' sums in warp 0).  `shared` holds kWarps values and
// is not read again before the block's next __syncthreads.
__device__ double block_sum(double v, double* shared) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  v = threadIdx.x < kWarps ? shared[threadIdx.x] : 0.0;
  if (warp == 0) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// scratch: partial sums [gridDim.x], partial counts [gridDim.x], then the
// ticket (an unsigned int, zeroed before the launch) in the next 8 bytes.
__global__ void __launch_bounds__(kThreads)
    nll_forward_kernel(const float* __restrict__ logp, const long long* __restrict__ y,
                       long long n, int c, double* __restrict__ scratch,
                       float* __restrict__ loss, float* __restrict__ count_out) {
  double* part_sum = scratch;
  double* part_count = scratch + gridDim.x;
  unsigned int* ticket = reinterpret_cast<unsigned int*>(scratch + 2 * gridDim.x);
  __shared__ double s_sum[kWarps];
  __shared__ double s_count[kWarps];
  __shared__ bool last;

  double sum = 0.0;
  int count = 0;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const long long t = y[i];
    if (t == kIgnoreIndex) continue;
    assert(t >= 0 && t < c);
    sum -= static_cast<double>(logp[i * c + t]);
    ++count;
  }
  sum = block_sum(sum, s_sum);
  const double block_count = block_sum(static_cast<double>(count), s_count);
  if (threadIdx.x == 0) {
    part_sum[blockIdx.x] = sum;
    part_count[blockIdx.x] = block_count;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // The last block: every other block's partial is written and fenced.
  sum = 0.0;
  double total = 0.0;
  for (int b = threadIdx.x; b < gridDim.x; b += kThreads) {
    sum += __ldcg(part_sum + b);
    total += __ldcg(part_count + b);
  }
  sum = block_sum(sum, s_sum);
  total = block_sum(total, s_count);
  if (threadIdx.x == 0) {
    *loss = static_cast<float>(sum / total);
    *count_out = static_cast<float>(total);
  }
}

__global__ void __launch_bounds__(kThreads)
    nll_backward_kernel(const float* __restrict__ grad_loss, const float* __restrict__ count,
                        const long long* __restrict__ y, long long n, int c,
                        float* __restrict__ grad) {
  // PyTorch's arithmetic: -(g / total_weight), in float.
  const float v = -(*grad_loss / *count);
  const long long total = n * c;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads * 4;
  for (long long base = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * 4;
       base < total; base += stride) {
    long long row = base / c;
    int col = static_cast<int>(base - row * c);
    float out[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      out[k] = (base + k < total && __ldg(y + row) == col) ? v : 0.0f;
      if (++col == c) {
        col = 0;
        ++row;
      }
    }
    if (base + 4 <= total) {
      *reinterpret_cast<float4*>(grad + base) = make_float4(out[0], out[1], out[2], out[3]);
    } else {
      for (int k = 0; base + k < total; ++k) grad[base + k] = out[k];
    }
  }
}

}  // namespace

// logp [n, c] f32 and y [n] int64, contiguous; scratch 2 * blocks + 1
// doubles; loss and count 0-d f32.
extern "C" int tcgnn_nll_forward(void* logp, void* y, void* scratch, void* loss, void* count,
                                 int n, int c, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int need = (n + kThreads - 1) / kThreads;
  const int grid = need < 1 ? 1 : (need < blocks ? need : blocks);
  double* partials = static_cast<double*>(scratch);
  cudaError_t err = cudaMemsetAsync(partials + 2 * grid, 0, sizeof(unsigned int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  nll_forward_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(logp), static_cast<const long long*>(y), n, c, partials,
      static_cast<float*>(loss), static_cast<float*>(count));
  return static_cast<int>(cudaGetLastError());
}

// grad_loss and count 0-d f32, y [n] int64, grad [n, c] f32 (16-byte
// aligned), every element written.
extern "C" int tcgnn_nll_backward(void* grad_loss, void* count, void* y, void* grad, int n, int c,
                                  void* stream) {
  const long long groups = (static_cast<long long>(n) * c + 3) / 4;
  if (groups == 0) return 0;
  const long long need = (groups + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(need < kBackwardMaxBlocks ? need : kBackwardMaxBlocks);
  nll_backward_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grad_loss), static_cast<const float*>(count),
      static_cast<const long long*>(y), n, c, static_cast<float*>(grad));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tcgnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
