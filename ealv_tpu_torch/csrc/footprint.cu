// Fused Gaussian footprint and spread reduction for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ealv_tpu/ops/pallas_kernels.py::
// footprint_and_spread (body _footprint_kernel). For samples s (N, d),
// trajectory x (T, d), kernel width std (d,) and mask m (T,) it returns
//
//     sum[n] = sum_t m_t * exp(-0.5 * |w * (s_n - x_t)|^2)      (footprint)
//     max[n] = max_t m_t * exp(-0.5 * |w * (s_n - x_t)|^2)      (spread)
//
// with w = rsqrt(|std|): std acts as a variance, the squared distance is
// scaled by 1/|std|, not 1/std^2.
//
// What bounds it on this card: at the planner's largest call (N=2000,
// T=3000, d=3) it evaluates 6 M exponentials and moves only O((N+T)*d)
// floats, so it is bound by arithmetic and latency, never by device-memory
// bandwidth. The design follows from that:
//   - each thread owns one sample row, whitened once into registers;
//   - the block stages whitened trajectory points and the mask through
//     shared memory in chunks of kTChunk, so every point is read from device
//     memory once per block and whitened once per block;
//   - sum and max accumulate in f32 registers from direct per-dimension
//     differences. The |a|^2 + |b|^2 - 2ab expansion is not used: exp()
//     amplifies its cancellation error;
//   - the ragged tails of N (threads past N write nothing) and T (the last
//     chunk is shortened) are masked here, so callers pass exact shapes.
// N=2000 rows fill only ceil(2000/64) = 32 blocks of 64 threads on the 132
// SMs; splitting T across blocks with a second reduction pass is the first
// step to a faster kernel.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 64;
constexpr int kTChunk = 512;

template <int D>
__global__ void footprint_kernel(const float* __restrict__ samples,
                                 const float* __restrict__ traj,
                                 const float* __restrict__ stdv,
                                 const float* __restrict__ mask,
                                 float* __restrict__ out_sum,
                                 float* __restrict__ out_max, int n, int t) {
  __shared__ float s_traj[kTChunk * D];
  __shared__ float s_mask[kTChunk];

  float w[D];
#pragma unroll
  for (int k = 0; k < D; ++k) w[k] = rsqrtf(fabsf(stdv[k]));

  const int row = blockIdx.x * kThreads + threadIdx.x;
  float s[D];
#pragma unroll
  for (int k = 0; k < D; ++k)
    s[k] = row < n ? samples[(size_t)row * D + k] * w[k] : 0.0f;

  float acc_sum = 0.0f;
  float acc_max = -INFINITY;
  for (int base = 0; base < t; base += kTChunk) {
    const int len = min(kTChunk, t - base);
    __syncthreads();  // previous chunk fully consumed
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const float* src = traj + (size_t)(base + i) * D;
#pragma unroll
      for (int k = 0; k < D; ++k) s_traj[i * D + k] = src[k] * w[k];
      s_mask[i] = mask[base + i];
    }
    __syncthreads();
    for (int i = 0; i < len; ++i) {
      float sq = 0.0f;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float diff = s[k] - s_traj[i * D + k];
        sq = fmaf(diff, diff, sq);
      }
      const float e = expf(-0.5f * sq) * s_mask[i];
      acc_sum += e;
      // NaN-propagating max, as jnp.max / torch.amax
      acc_max = (e > acc_max || e != e) ? e : acc_max;
    }
  }
  if (row < n) {
    out_sum[row] = acc_sum;
    out_max[row] = acc_max;
  }
}

template <int D>
cudaError_t launch(const float* samples, const float* traj, const float* stdv,
                   const float* mask, float* out_sum, float* out_max, int n,
                   int t, cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  footprint_kernel<D><<<blocks, kThreads, 0, stream>>>(
      samples, traj, stdv, mask, out_sum, out_max, n, t);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. All pointers are device pointers
// to contiguous f32 arrays: samples (n, d), traj (t, d), stdv (d,), mask (t,),
// out_sum (n,), out_max (n,). Launches on `stream` and does not synchronise.
// Returns the launch's cudaError_t (0 on success); 1 (cudaErrorInvalidValue)
// for a d outside 1..8 or a non-positive n or t.
extern "C" int footprint_and_spread_f32(const float* samples,
                                        const float* traj, const float* stdv,
                                        const float* mask, float* out_sum,
                                        float* out_max, int n, int t, int d,
                                        void* stream) {
  if (n <= 0 || t <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return launch<1>(samples, traj, stdv, mask, out_sum, out_max, n, t, s);
    case 2: return launch<2>(samples, traj, stdv, mask, out_sum, out_max, n, t, s);
    case 3: return launch<3>(samples, traj, stdv, mask, out_sum, out_max, n, t, s);
    case 4: return launch<4>(samples, traj, stdv, mask, out_sum, out_max, n, t, s);
    case 5: return launch<5>(samples, traj, stdv, mask, out_sum, out_max, n, t, s);
    case 6: return launch<6>(samples, traj, stdv, mask, out_sum, out_max, n, t, s);
    case 7: return launch<7>(samples, traj, stdv, mask, out_sum, out_max, n, t, s);
    case 8: return launch<8>(samples, traj, stdv, mask, out_sum, out_max, n, t, s);
    default: return cudaErrorInvalidValue;
  }
}
