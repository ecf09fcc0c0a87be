// Device stamps of the tracer (runtime/tracing.py): one-thread kernels that
// read the card's global nanosecond timer at a point of a tick and write it
// into a ring of ticks that the tracer owns.
//
// Replaces no TPU kernel: the JAX package's tick is one compiled program and
// has no counterpart. It exists because a CUDA event recorded inside a
// captured graph is the same event on every replay, so events cannot time
// the layers of 25 replayed ticks without a host sync between them. A stamp
// is a kernel node of the graph: on every replay it reads %globaltimer when
// the work before it on the stream has ended and writes the value to
//
//     ring[(*tick % capacity) * points + point]
//
// where *tick is a device counter that ealv_advance moves on after each
// tick. Both read the counter through a pointer, so a replayed graph writes
// the row of the tick it is replayed in. The first stamp of a tick clears
// the row first, so a point that the tick does not reach reads 0.
//
// What bounds it: launch latency. One thread does a handful of loads and
// stores (at most `points` stores of 8 B), so a stamp costs the card about
// what an empty kernel costs, 2-3 us in a graph.

#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(long long* ring, const long long* tick, int capacity,
                             int points, int point, int clear) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  long long* row = ring + (*tick % capacity) * points;
  if (clear) {
    for (int i = 0; i < points; ++i) row[i] = 0;
  }
  row[point] = static_cast<long long>(now);
}

__global__ void advance_kernel(long long* tick) { *tick += 1; }

}  // namespace

extern "C" int ealv_stamp(void* ring, const void* tick, int capacity, int points,
                          int point, int clear, void* stream) {
  if (ring == nullptr || tick == nullptr || capacity <= 0 || point < 0 ||
      point >= points)
    return cudaErrorInvalidValue;
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(ring), static_cast<const long long*>(tick), capacity,
      points, point, clear);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ealv_advance(void* tick, void* stream) {
  if (tick == nullptr) return cudaErrorInvalidValue;
  advance_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(tick));
  return static_cast<int>(cudaGetLastError());
}
