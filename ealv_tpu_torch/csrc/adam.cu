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
// a handful of flops, so device-memory bandwidth: 28 B per element, 120.66 MB
// per step at the CVAE's 4,309,220 parameters, 36.0 us at 3.35 TB/s. The
// design is a streaming pass that keeps enough bytes in flight:
//   - one launch covers every tensor of the optimizer step; the table is
//     passed by value as a __grid_constant__ kernel parameter (no copy to
//     the device, no allocation, no sync);
//   - the host plan (ops/adam.py::adam_plan) gives each tensor
//     ceil(n / kChunk) consecutive blocks; a block finds its tensor by a
//     binary search over the tensors' first blocks (uniform across the
//     block, at most 6 steps) and updates one chunk of kChunk elements;
//   - a tensor whose four arrays start on 16-byte boundaries is read and
//     written as float4: each thread loads kVecs float4 of g, m, v and p
//     (256 B) before it computes any, so an SM keeps tens of KB in flight;
//     neighbouring threads touch neighbouring float4 (coalesced). The last
//     n % 4 elements are a scalar tail, done by the tensor's last block;
//   - a tensor with any array off a 16-byte boundary takes the scalar path
//     for the whole tensor (the CVAE's tensors never do).
// The C entry checks the plan against kChunk and the alignment it claims,
// so a wrong plan is refused, never run.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxTensors = 48;  // ADAM_MAX_TENSORS in ops/adam.py
constexpr int kThreads = 256;    // THREADS
constexpr int kVecs = 4;         // VECS: float4 per array per thread
constexpr int kChunk = kThreads * kVecs * 4;  // CHUNK: elements per block

struct AdamTable {
  float* p[kMaxTensors];
  float* m[kMaxTensors];
  float* v[kMaxTensors];
  const float* g[kMaxTensors];
  long long n[kMaxTensors];
  int block_start[kMaxTensors + 1];  // first block of each tensor, then the total
  int vec[kMaxTensors];              // 1: float4 path, 0: scalar path
  int n_tensors;
};

struct AdamScalars {
  float lr, c1, c2, b1, b2, omb1, omb2, eps;  // omb = 1 - b, rounded once
};

__device__ __forceinline__ void adam_elem(float& p, float& m, float& v, float g,
                                          const AdamScalars& s) {
  m = s.b1 * m + s.omb1 * g;
  v = s.b2 * v + s.omb2 * g * g;
  const float mhat = m / s.c1;
  const float vhat = v / s.c2;
  p = p - s.lr * mhat / (sqrtf(vhat) + s.eps);
}

__device__ __forceinline__ void adam_vec(float4& p, float4& m, float4& v,
                                         const float4& g, const AdamScalars& s) {
  adam_elem(p.x, m.x, v.x, g.x, s);
  adam_elem(p.y, m.y, v.y, g.y, s);
  adam_elem(p.z, m.z, v.z, g.z, s);
  adam_elem(p.w, m.w, v.w, g.w, s);
}

__global__ void __launch_bounds__(kThreads)
    adam_multi_kernel(const __grid_constant__ AdamTable t,
                      const AdamScalars s) {
  const int b = blockIdx.x;
  int lo = 0, hi = t.n_tensors - 1;  // last tensor whose first block <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.block_start[mid] <= b) lo = mid; else hi = mid - 1;
  }
  float* __restrict__ p = t.p[lo];
  float* __restrict__ m = t.m[lo];
  float* __restrict__ v = t.v[lo];
  const float* __restrict__ g = t.g[lo];
  const long long begin = (long long)(b - t.block_start[lo]) * kChunk;
  const long long end = min(begin + kChunk, t.n[lo]);

  if (!t.vec[lo]) {
    for (long long j = begin + threadIdx.x; j < end; j += kThreads) {
      float pj = p[j], mj = m[j], vj = v[j];
      adam_elem(pj, mj, vj, g[j], s);
      p[j] = pj;
      m[j] = mj;
      v[j] = vj;
    }
    return;
  }
  // float4 index range of the whole vectors in [begin, end); begin is a
  // multiple of kChunk, so of 4
  const long long vbegin = begin >> 2;
  const long long vend = end >> 2;
  float4* __restrict__ p4 = reinterpret_cast<float4*>(p);
  float4* __restrict__ m4 = reinterpret_cast<float4*>(m);
  float4* __restrict__ v4 = reinterpret_cast<float4*>(v);
  const float4* __restrict__ g4 = reinterpret_cast<const float4*>(g);
  float4 pr[kVecs], mr[kVecs], vr[kVecs], gr[kVecs];
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {  // every load before any use
    const long long j = vbegin + u * kThreads + threadIdx.x;
    if (j < vend) {
      gr[u] = g4[j];
      mr[u] = m4[j];
      vr[u] = v4[j];
      pr[u] = p4[j];
    }
  }
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const long long j = vbegin + u * kThreads + threadIdx.x;
    if (j < vend) {
      adam_vec(pr[u], mr[u], vr[u], gr[u], s);
      p4[j] = pr[u];
      m4[j] = mr[u];
      v4[j] = vr[u];
    }
  }
  // scalar tail: the tensor's last n % 4 elements (empty but in its last block)
  const long long j = (vend << 2) + threadIdx.x;
  if (j < end) {
    float pj = p[j], mj = m[j], vj = v[j];
    adam_elem(pj, mj, vj, g[j], s);
    p[j] = pj;
    m[j] = mj;
    v[j] = vj;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. `ptrs` is a host array of
// 4 * n_tensors device pointers, planar: p of every tensor, then m, v and
// g, each a contiguous f32 array of sizes[i] > 0 elements. `block_start`
// (n_tensors + 1 ints) and `vec` (n_tensors ints) are the host plan of
// ops/adam.py::adam_plan. Launches one kernel of block_start[n_tensors]
// blocks on `stream` and does not synchronise. Returns the launch's
// cudaError_t (0 on success); 1 (cudaErrorInvalidValue) for n_tensors
// outside 1..kMaxTensors, an empty tensor, a plan whose block counts are
// not ceil(n / kChunk), or a float4 tensor with an array off a 16-byte
// boundary.
extern "C" int adam_multi_f32(const unsigned long long* ptrs,
                              const long long* sizes, const int* block_start,
                              const int* vec, int n_tensors, float lr,
                              float c1, float c2, float b1, float b2,
                              float omb1, float omb2, float eps,
                              void* stream) {
  if (n_tensors <= 0 || n_tensors > kMaxTensors || block_start[0] != 0)
    return cudaErrorInvalidValue;
  AdamTable t;
  for (int i = 0; i < n_tensors; ++i) {
    const unsigned long long pp = ptrs[i], pm = ptrs[n_tensors + i],
                             pv = ptrs[2 * n_tensors + i],
                             pg = ptrs[3 * n_tensors + i];
    if (sizes[i] <= 0 ||
        block_start[i + 1] - block_start[i] != (sizes[i] + kChunk - 1) / kChunk ||
        (vec[i] && ((pp | pm | pv | pg) & 15)))
      return cudaErrorInvalidValue;
    t.p[i] = reinterpret_cast<float*>(pp);
    t.m[i] = reinterpret_cast<float*>(pm);
    t.v[i] = reinterpret_cast<float*>(pv);
    t.g[i] = reinterpret_cast<const float*>(pg);
    t.n[i] = sizes[i];
    t.block_start[i] = block_start[i];
    t.vec[i] = vec[i] != 0;
  }
  t.block_start[n_tensors] = block_start[n_tensors];
  t.n_tensors = n_tensors;
  const AdamScalars s{lr, c1, c2, b1, b2, omb1, omb2, eps};
  adam_multi_kernel<<<block_start[n_tensors], kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(t, s);
  return cudaGetLastError();
}
