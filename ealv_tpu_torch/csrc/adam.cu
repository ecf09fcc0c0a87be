// Multi-tensor fused Adam update for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ealv_tpu/ops/pallas_adam.py::
// adam_update_flat (body _adam_kernel) and its per-leaf dispatch adam_apply.
// For every tensor i of a table of (p, m, v, g, n) it applies, in place,
//
//     m <- b1 * m + (1 - b1) * g
//     v <- b2 * v + (1 - b2) * g * g
//     p <- p - lr * (m / c1) / (sqrt(v / c2) + eps)
//
// with c1 = 1 - b1^t and c2 = 1 - b2^t computed by the caller in f32 from a
// host step count. The formula is the JAX package's (optax's eps_root = 0
// form): sqrt(v / c2), not torch.optim.Adam's sqrt(v) / sqrt(c2).
//
// What bounds it on this card: 4 f32 reads and 3 f32 writes per element and
// a handful of flops, so device-memory bandwidth. At the CVAE's 4.3 M
// parameters that is 120 MB per step, about 36 us at 3.35 TB/s. The TPU
// kernel made one pallas_call per large leaf and left small leaves to XLA;
// here one launch covers every tensor of the optimizer step, so the 24
// parameter tensors of the CVAE cost one launch instead of 24:
//   - the table of tensors is passed by value as a __grid_constant__ kernel
//     parameter (no host-to-device copy, no allocation, no sync);
//   - each tensor is cut into chunks of kChunk elements; blocks stride over
//     the concatenated chunk list and find a chunk's tensor by binary search
//     over the chunk prefix sums, so a block never straddles two tensors;
//   - within a chunk, neighbouring threads touch neighbouring elements
//     (coalesced), and each element is read and written once.
// A table holds at most kMaxTensors tensors; the caller splits longer lists
// into several launches.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxTensors = 48;  // keep equal to ADAM_MAX_TENSORS in ops/adam.py
constexpr int kChunk = 4096;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

struct AdamTable {
  float* p[kMaxTensors];
  float* m[kMaxTensors];
  float* v[kMaxTensors];
  const float* g[kMaxTensors];
  long long n[kMaxTensors];
  long long chunk_start[kMaxTensors + 1];
  int n_tensors;
};

struct AdamScalars {
  float lr, c1, c2, b1, b2, omb1, omb2, eps;  // omb = 1 - b, rounded once
};

__global__ void __launch_bounds__(kThreads)
    adam_multi_kernel(const __grid_constant__ AdamTable t,
                      const AdamScalars s) {
  const long long total = t.chunk_start[t.n_tensors];
  for (long long c = blockIdx.x; c < total; c += gridDim.x) {
    int lo = 0, hi = t.n_tensors - 1;  // last tensor whose first chunk <= c
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (t.chunk_start[mid] <= c) lo = mid; else hi = mid - 1;
    }
    float* __restrict__ p = t.p[lo];
    float* __restrict__ m = t.m[lo];
    float* __restrict__ v = t.v[lo];
    const float* __restrict__ g = t.g[lo];
    const long long begin = (c - t.chunk_start[lo]) * kChunk;
    const long long end = min(begin + kChunk, t.n[lo]);
    for (long long j = begin + threadIdx.x; j < end; j += kThreads) {
      const float gj = g[j];
      const float mj = s.b1 * m[j] + s.omb1 * gj;
      const float vj = s.b2 * v[j] + s.omb2 * gj * gj;
      const float mhat = mj / s.c1;
      const float vhat = vj / s.c2;
      p[j] = p[j] - s.lr * mhat / (sqrtf(vhat) + s.eps);
      m[j] = mj;
      v[j] = vj;
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. `ptrs` is a host array of
// 4 * n_tensors device pointers, (p, m, v, g) per tensor, each a contiguous
// f32 array of sizes[i] > 0 elements. Launches one kernel on `stream` and
// does not synchronise. Returns the launch's cudaError_t (0 on success);
// 1 (cudaErrorInvalidValue) for n_tensors outside 1..kMaxTensors or an
// empty tensor.
extern "C" int adam_multi_f32(const unsigned long long* ptrs,
                              const long long* sizes, int n_tensors, float lr,
                              float c1, float c2, float b1, float b2,
                              float omb1, float omb2, float eps,
                              void* stream) {
  if (n_tensors <= 0 || n_tensors > kMaxTensors) return cudaErrorInvalidValue;
  AdamTable t;
  long long chunks = 0;
  for (int i = 0; i < n_tensors; ++i) {
    if (sizes[i] <= 0) return cudaErrorInvalidValue;
    t.p[i] = reinterpret_cast<float*>(ptrs[4 * i + 0]);
    t.m[i] = reinterpret_cast<float*>(ptrs[4 * i + 1]);
    t.v[i] = reinterpret_cast<float*>(ptrs[4 * i + 2]);
    t.g[i] = reinterpret_cast<const float*>(ptrs[4 * i + 3]);
    t.n[i] = sizes[i];
    t.chunk_start[i] = chunks;
    chunks += (sizes[i] + kChunk - 1) / kChunk;
  }
  t.chunk_start[n_tensors] = chunks;
  t.n_tensors = n_tensors;
  const AdamScalars s{lr, c1, c2, b1, b2, omb1, omb2, eps};
  const int blocks = static_cast<int>(chunks < kMaxBlocks ? chunks : kMaxBlocks);
  adam_multi_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(t, s);
  return cudaGetLastError();
}
