// The device clock of the program's in-graph spans (blues_tpu_torch/
// profiling.py), for NVIDIA Hopper, sm_90a.
//
// A span inside a captured CUDA graph is two launches of stamp_kernel, one
// thread each, captured as kernel nodes: each reads the global nanosecond
// timer (%globaltimer) and writes it into a ring of rows, one row per
// replay of the graph, at the span's slot. The row is the replay's number,
// kept on the device: stamp_advance_kernel adds one to it at the start of
// each replay, so every replay keeps its own stamps until the ring wraps,
// and the host reads them all after the iteration, with no synchronise in
// between. The same kernel with one row and a zero counter stamps the
// clock's anchor outside any graph. The JAX package has no counterpart
// (TPU kernels are timed by the XLA profiler).

#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(unsigned long long* ring, const long long* counter, int slot, int n_slots,
                             int capacity) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  ring[(unsigned long long)(counter[0] % capacity) * n_slots + slot] = t;
}

__global__ void stamp_advance_kernel(long long* counter) { counter[0] += 1; }

}  // namespace

extern "C" {

int stamp_launch(void* ring, const void* counter, int slot, int n_slots, int capacity, void* stream) {
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((unsigned long long*)ring, (const long long*)counter, slot,
                                                  n_slots, capacity);
  return (int)cudaGetLastError();
}

int stamp_advance_launch(void* counter, void* stream) {
  stamp_advance_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((long long*)counter);
  return (int)cudaGetLastError();
}

}  // extern "C"
