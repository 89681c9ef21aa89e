// Device phase stamps: a one-thread kernel that writes (id, the device's
// clock) into a ring in device memory.
//
// No TPU kernel is replaced: the stamps time the phases of a training step
// (forward, backward, all-reduce, optimizer) inside a CUDA graph, where a
// host clock sees only the whole replay and a CUDA event cannot be read
// per replay without a host sync. A stamp captured into a graph is a kernel
// node, so every replay takes a new slot and writes the clock anew.
//
// The clock is %globaltimer (ns, the same on every SM). The kernel runs
// when the work queued before it on its stream has finished and before the
// work after it starts, so the difference of two stamps is the device time
// of what lies between them, a kernel launch's gap included. Bound by
// launch latency, a few microseconds a stamp; nothing else.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"

namespace {

// slots taken since the last reset; slot s lies at s % kStampSlots
__device__ unsigned long long stamp_head = 0;
// (id, ns) pairs
__device__ unsigned long long stamp_ring[2 * bevbert::kStampSlots];

__global__ void stamp_kernel(unsigned long long id) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const unsigned long long slot = atomicAdd(&stamp_head, 1ull) % bevbert::kStampSlots;
  stamp_ring[2 * slot] = id;
  stamp_ring[2 * slot + 1] = t;
}

}  // namespace

namespace bevbert {

cudaError_t launch_stamp(uint32_t id, cudaStream_t stream) {
  stamp_kernel<<<1, 1, 0, stream>>>(id);
  return cudaGetLastError();
}

cudaError_t read_stamps(unsigned long long* head, unsigned long long* ring, bool reset) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return err;
  if ((err = cudaMemcpyFromSymbol(head, stamp_head, sizeof *head)) != cudaSuccess) return err;
  const unsigned long long filled = *head < kStampSlots ? *head : kStampSlots;
  if (filled &&
      (err = cudaMemcpyFromSymbol(ring, stamp_ring, 2 * filled * sizeof *ring)) != cudaSuccess) {
    return err;
  }
  if (reset) {
    const unsigned long long zero = 0;
    return cudaMemcpyToSymbol(stamp_head, &zero, sizeof zero);
  }
  return cudaSuccess;
}

}  // namespace bevbert
