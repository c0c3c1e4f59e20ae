// Device stamps for the phase spans of the training step, and a count of a
// CUDA graph's nodes, for Hopper (sm_90a).
//
// Replaces no TPU kernel.  An epoch runs as one replay of the step's CUDA
// graph (TrainStep.many), and a replay runs no Python, so a host clock or a
// profiler range inside the step fires only once, at the capture.  The
// phases inside a replayed epoch (forward, the aggregations, the loss,
// backward, Adam) are marked by this one-thread kernel, captured into an
// instrumented twin of the step's graph (TrainStep.span_ms, which `many`
// never replays): it reads the card's nanosecond clock (%globaltimer) and
// writes it to ring[row, slot], the row that the counter on the card
// selects (counter % rows); the step's last stamp advances the counter, so
// each replay fills its own row.  The stream orders the stamp after the
// operations launched before it, so the difference of two stamps is the
// device time of what lies between them, one stamp's own launch included.
// Bounded by nothing but its launch: one thread, one load, one store.
//
// tcgnn_graph_nodes counts a captured graph's kernel, memset and copy nodes
// (child graphs' too), read from the graph (cudaGraphGetNodes), which a
// profiler trace of a replay can be held to.

#include <cuda_runtime.h>

#include <cstdlib>

namespace {

__global__ void stamp_kernel(long long* __restrict__ ring, int* __restrict__ counter, int slot,
                             int stride, int rows, int last) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const int count = *counter;
  ring[static_cast<long long>(count % rows) * stride + slot] = static_cast<long long>(now);
  if (last) *counter = count + 1;
}

// counts: kernel, memset, copy, other nodes.
cudaError_t count_nodes(cudaGraph_t graph, int* counts) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess || n == 0) return err;
  cudaGraphNode_t* nodes = static_cast<cudaGraphNode_t*>(std::malloc(n * sizeof(cudaGraphNode_t)));
  if (nodes == nullptr) return cudaErrorMemoryAllocation;
  err = cudaGraphGetNodes(graph, nodes, &n);
  for (size_t i = 0; err == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    if (err != cudaSuccess) break;
    if (type == cudaGraphNodeTypeKernel) {
      ++counts[0];
    } else if (type == cudaGraphNodeTypeMemset) {
      ++counts[1];
    } else if (type == cudaGraphNodeTypeMemcpy) {
      ++counts[2];
    } else if (type == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      err = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (err == cudaSuccess) err = count_nodes(child, counts);
    } else {
      ++counts[3];
    }
  }
  std::free(nodes);
  return err;
}

}  // namespace

extern "C" int tcgnn_stamp(void* ring, void* counter, int slot, int stride, int rows, int last,
                           void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(ring), static_cast<int*>(counter), slot, stride, rows, last);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tcgnn_graph_nodes(void* graph, void* counts) {
  int* c = static_cast<int*>(counts);
  c[0] = c[1] = c[2] = c[3] = 0;
  return static_cast<int>(count_nodes(static_cast<cudaGraph_t>(graph), c));
}

extern "C" const char* tcgnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
