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
// What bounds it on this card: arithmetic. At the planner's largest call
// (N=2000, T=3000, d=3) it evaluates 6 M pairs of about 14 flops each, 84
// MFLOP, 1.25 us at 67 TFLOP/s f32, and moves only O((N + T) * d) floats
// (88 KB, 0.03 us at 3.35 TB/s). Every pair is a dependent chain (subtract,
// FMA, exponential, add, max), so the design is about keeping enough
// independent chains in flight on all 132 SMs:
//   - each thread owns kRows = 2 sample rows, whitened once into
//     registers, with two sums and two maxes. A trajectory point is read
//     once from shared memory as a broadcast (every thread reads the same
//     address: no bank conflicts) and serves two independent chains;
//   - a staged point is one float4 for d <= 3 (whitened coordinates and
//     the mask), two for d <= 7, three for d = 8;
//   - T is split: the grid is (S splits, row tiles). A block whitens and
//     stages its split's points and mask in shared memory, kStage at a
//     time, and writes one partial (sum, max) per row to a workspace. The
//     host plan (ops/footprint.py::footprint_plan) picks S from the shape
//     alone, so that the grid of kThreads-thread blocks has at least two
//     blocks per SM while a split keeps enough points to pay for staging
//     them;
//   - a second kernel sums and maxes each row's S partials in split order.
//     The summation order depends on the shape only: the same bits on every
//     call, and no atomics. With S = 1 (the planner's T = 10 calls, which
//     are launch-bound) the first kernel writes the outputs and there is no
//     second kernel and no workspace;
//   - differences are direct, per dimension, in f32: the |a|^2 + |b|^2 -
//     2ab expansion is not used, exp() amplifies its cancellation error;
//   - the whitening folds in sqrt(0.5 * log2(e)), so each pair takes one
//     exp2f instead of expf and a multiply;
//   - the ragged tails of N (rows past N are computed and never written)
//     and T (the last split and the last staged stretch are shorter) are
//     handled here, so callers pass exact shapes.
// The max propagates NaN, as jnp.max and torch.amax do.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kRows = 2;       // sample rows per thread
constexpr int kStage = 256;  // trajectory points staged in shared memory at a time
constexpr int kCombineThreads = 256;
// sqrt(0.5 * log2(e)): exp(-0.5 * q) = exp2(-q * 0.5 * log2(e))
constexpr float kWhiten = 0.84932180028801904272f;

__device__ __forceinline__ float nan_max(float acc, float e) {
  return (e > acc || e != e) ? e : acc;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    footprint_kernel(const float* __restrict__ samples,
                     const float* __restrict__ traj,
                     const float* __restrict__ stdv,
                     const float* __restrict__ mask,
                     float* __restrict__ dst_sum, float* __restrict__ dst_max,
                     int n, int t, int split_len) {
  constexpr int P = (D + 4) / 4;  // float4 per staged point: D coordinates, mask, padding
  __shared__ float4 s_pts[kStage * P];

  float w[D];
#pragma unroll
  for (int k = 0; k < D; ++k) w[k] = rsqrtf(fabsf(stdv[k])) * kWhiten;

  const int row0 = blockIdx.y * kThreads * kRows + threadIdx.x;
  float s[kRows][D];
  float acc_sum[kRows], acc_max[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r * kThreads;
#pragma unroll
    for (int k = 0; k < D; ++k)
      s[r][k] = row < n ? samples[(size_t)row * D + k] * w[k] : 0.0f;
    acc_sum[r] = 0.0f;
    acc_max[r] = -INFINITY;
  }

  const int t0 = blockIdx.x * split_len;
  const int t1 = min(t0 + split_len, t);
  for (int base = t0; base < t1; base += kStage) {
    const int len = min(kStage, t1 - base);
    __syncthreads();  // the previous stretch is fully consumed
#pragma unroll 1  // unrolled, it made ptxas spill registers at d = 1
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const float* src = traj + (size_t)(base + i) * D;
      float v[4 * P] = {};
#pragma unroll
      for (int k = 0; k < D; ++k) v[k] = src[k] * w[k];
      v[D] = mask[base + i];
#pragma unroll
      for (int j = 0; j < P; ++j)
        s_pts[i * P + j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
    }
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < len; ++i) {
      float x[4 * P];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float4 q = s_pts[i * P + j];
        x[4 * j] = q.x;
        x[4 * j + 1] = q.y;
        x[4 * j + 2] = q.z;
        x[4 * j + 3] = q.w;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float sq = 0.0f;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          const float diff = s[r][k] - x[k];
          sq = fmaf(diff, diff, sq);
        }
        const float e = exp2f(-sq) * x[D];
        acc_sum[r] += e;
        acc_max[r] = nan_max(acc_max[r], e);
      }
    }
  }

  // with S > 1, dst is the workspace: partials of split s at s * n
  const size_t off = (size_t)blockIdx.x * n;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r * kThreads;
    if (row < n) {
      dst_sum[off + row] = acc_sum[r];
      dst_max[off + row] = acc_max[r];
    }
  }
}

// sum and max of each row's partials, split 0 first
__global__ void __launch_bounds__(kCombineThreads)
    combine_kernel(const float* __restrict__ ws_sum,
                   const float* __restrict__ ws_max,
                   float* __restrict__ out_sum, float* __restrict__ out_max,
                   int n, int splits) {
  const int row = blockIdx.x * kCombineThreads + threadIdx.x;
  if (row >= n) return;
  float acc_sum = 0.0f, acc_max = -INFINITY;
#pragma unroll 8
  for (int k = 0; k < splits; ++k) {
    acc_sum += ws_sum[(size_t)k * n + row];
    acc_max = nan_max(acc_max, ws_max[(size_t)k * n + row]);
  }
  out_sum[row] = acc_sum;
  out_max[row] = acc_max;
}

template <int D>
cudaError_t launch(const float* samples, const float* traj, const float* stdv,
                   const float* mask, float* out_sum, float* out_max, float* ws,
                   int n, int t, int splits, int split_len, cudaStream_t stream) {
  const int tiles = (n + kThreads * kRows - 1) / (kThreads * kRows);
  float* dst_sum = splits > 1 ? ws : out_sum;
  float* dst_max = splits > 1 ? ws + (size_t)splits * n : out_max;
  footprint_kernel<D><<<dim3(splits, tiles), kThreads, 0, stream>>>(
      samples, traj, stdv, mask, dst_sum, dst_max, n, t, split_len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  combine_kernel<<<(n + kCombineThreads - 1) / kCombineThreads, kCombineThreads, 0,
                   stream>>>(dst_sum, dst_max, out_sum, out_max, n, splits);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. All pointers are device pointers
// to contiguous f32 arrays: samples (n, d), traj (t, d), stdv (d,), mask
// (t,), out_sum (n,), out_max (n,), and ws (2 * splits * n, the partials;
// unused and may be null when splits is 1). splits and split_len are the
// host plan of ops/footprint.py::footprint_plan: split k covers points
// [k * split_len, min((k + 1) * split_len, t)), and every split must be
// non-empty. Launches on `stream` (two kernels when splits > 1) and does
// not synchronise. Returns the launches' cudaError_t (0 on success); 1
// (cudaErrorInvalidValue) for a d outside 1..8, a non-positive n or t, or a
// plan outside those limits.
extern "C" int footprint_and_spread_f32(const float* samples,
                                        const float* traj, const float* stdv,
                                        const float* mask, float* out_sum,
                                        float* out_max, float* ws, int n, int t,
                                        int d, int splits, int split_len,
                                        void* stream) {
  if (n <= 0 || t <= 0 || splits < 1 || split_len < 1 ||
      (long long)(splits - 1) * split_len >= t ||
      (long long)splits * split_len < t || (splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FOOTPRINT_CASE(D)                                                   \
  case D:                                                                   \
    return launch<D>(samples, traj, stdv, mask, out_sum, out_max, ws, n, t, \
                     splits, split_len, s);
  switch (d) {
    FOOTPRINT_CASE(1)
    FOOTPRINT_CASE(2)
    FOOTPRINT_CASE(3)
    FOOTPRINT_CASE(4)
    FOOTPRINT_CASE(5)
    FOOTPRINT_CASE(6)
    FOOTPRINT_CASE(7)
    FOOTPRINT_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef FOOTPRINT_CASE
}
