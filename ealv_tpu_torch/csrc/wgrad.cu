// Direct weight gradient of a VALID strided 2-D convolution for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel ealv_tpu/ops/pallas_wgrad.py::
// conv_wgrad_direct (body _wgrad_kernel, phase planes _phase_planes). For x
// (B, Cin, H, W) and the output cotangent cot (B, Cout, OH, OW) of a
// stride-s, k x k VALID conv it returns, in f32,
//
//     dW[co, ci, kh, kw] = sum_{b, oh, ow} x[b, ci, s*oh + kh, s*ow + kw]
//                                          * cot[b, co, oh, ow]
//
// in torch's OIHW layout (the JAX function returns HWIO).
//
// What bounds it on this card: the CVAE encoder's convs have 3-20 channels,
// so the sums are long (B*OH*OW = 507 k, 124 k and 12.5 k terms at batch 64)
// and feed few outputs (k*k*Cin*Cout = 270, 900 and 5000). There is no
// matrix shape for the tensor cores to fill; the work is a long f32
// multiply-accumulate over bf16 or f32 reads, bound by load issue and by
// how many blocks the short output list can keep busy. The TPU kernel
// carried its accumulator across a sequential batch grid in VMEM; Hopper
// blocks run in no order, so the sum is split in two passes instead:
//   - pass 1: one block per (tap (ci, kh, kw), group of up to CG output
//     channels, batch chunk). Its threads stride over the chunk's (b, oh, ow)
//     positions, read one x value and CG cotangent values per position, and
//     keep CG f32 accumulators in registers. A warp-shuffle and shared-memory
//     reduction in a fixed order gives the block's partial sums, written to a
//     workspace (n_chunks, Cout, taps);
//   - pass 2: one thread per output sums its partials over the chunks in
//     chunk order.
// No float atomics, so dW is the same from run to run, as the TPU kernel's
// sequential batch grid made it. Both inputs are read through explicit
// element strides, so any layout works without a copy; the CVAE's first
// layer reads its image batch as a channels-last (NHWC) view. The odd tails
// (180 -> 89 leaves row and column 179 unread) need no masking: only
// positions s*oh + kh < s*(OH-1) + k <= H are ever read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct WgradShape {
  int B, Cin, Cout, OH, OW, k, s;
  int nb_chunk;  // batch images per chunk
  long long sx[4];  // x strides (b, c, h, w), in elements
  long long sc[4];  // cot strides (b, c, h, w), in elements
};

__device__ __forceinline__ float to_f32(float a) { return a; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 a) {
  return __bfloat162float(a);
}

template <typename T, int CG>
__global__ void __launch_bounds__(kThreads)
    wgrad_partial_kernel(const T* __restrict__ x, const T* __restrict__ cot,
                         float* __restrict__ ws, const WgradShape sh) {
  const int taps = sh.Cin * sh.k * sh.k;
  const int tap = blockIdx.x;  // (ci * k + kh) * k + kw, the OIHW order
  const int kw = tap % sh.k;
  const int kh = (tap / sh.k) % sh.k;
  const int ci = tap / (sh.k * sh.k);
  const int co0 = blockIdx.y * CG;
  const int b0 = blockIdx.z * sh.nb_chunk;
  const int nb = min(sh.nb_chunk, sh.B - b0);
  const int plane = sh.OH * sh.OW;
  const int total = nb * plane;

  float acc[CG];
#pragma unroll
  for (int j = 0; j < CG; ++j) acc[j] = 0.0f;

  const T* xb = x + ci * sh.sx[1] + kh * sh.sx[2] + kw * sh.sx[3];
  const T* cb = cot + co0 * sh.sc[1];
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int bl = i / plane;
    const int r = i - bl * plane;
    const int oh = r / sh.OW;
    const int ow = r - oh * sh.OW;
    const long long b = b0 + bl;
    const float xv = to_f32(xb[b * sh.sx[0] + (long long)(sh.s * oh) * sh.sx[2] +
                               (long long)(sh.s * ow) * sh.sx[3]]);
    const T* cp = cb + b * sh.sc[0] + oh * sh.sc[2] + ow * sh.sc[3];
#pragma unroll
    for (int j = 0; j < CG; ++j)
      if (co0 + j < sh.Cout) acc[j] += xv * to_f32(cp[j * sh.sc[1]]);
  }

  __shared__ float red[kWarps][CG];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < CG; ++j) {
    float a = acc[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) a += __shfl_down_sync(0xffffffffu, a, off);
    if (lane == 0) red[warp][j] = a;
  }
  __syncthreads();
  const int j = threadIdx.x;
  if (j < CG && co0 + j < sh.Cout) {
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[w][j];
    ws[((long long)blockIdx.z * sh.Cout + co0 + j) * taps + tap] = sum;
  }
}

__global__ void wgrad_reduce_kernel(const float* __restrict__ ws,
                                    float* __restrict__ dw, int n_out,
                                    int n_chunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  float sum = 0.0f;
  for (int c = 0; c < n_chunks; ++c) sum += ws[(long long)c * n_out + i];
  dw[i] = sum;
}

template <typename T, int CG>
cudaError_t launch_partial_cg(const void* x, const void* cot, float* ws,
                              const WgradShape& sh, int n_chunks,
                              cudaStream_t stream) {
  const dim3 grid(sh.Cin * sh.k * sh.k, (sh.Cout + CG - 1) / CG, n_chunks);
  wgrad_partial_kernel<T, CG><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(cot), ws, sh);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_partial(const void* x, const void* cot, float* ws,
                           const WgradShape& sh, int n_chunks,
                           cudaStream_t stream) {
  // the smallest channel group that holds Cout, at most 32 per block
  if (sh.Cout <= 4) return launch_partial_cg<T, 4>(x, cot, ws, sh, n_chunks, stream);
  if (sh.Cout <= 8) return launch_partial_cg<T, 8>(x, cot, ws, sh, n_chunks, stream);
  if (sh.Cout <= 16) return launch_partial_cg<T, 16>(x, cot, ws, sh, n_chunks, stream);
  return launch_partial_cg<T, 32>(x, cot, ws, sh, n_chunks, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes. x and cot are device pointers to
// arrays of one dtype (0: f32, 1: bf16) read through the element strides
// xs and cs (b, c, h, w). dims = (B, Cin, Cout, OH, OW, k, s, nb_chunk);
// ws is a device f32 workspace of n_chunks * Cout * Cin * k * k elements
// with n_chunks = ceil(B / nb_chunk); dw receives (Cout, Cin, k, k) f32.
// Launches the two passes on `stream` and does not synchronise. Returns the
// first failing launch's cudaError_t (0 on success); 1
// (cudaErrorInvalidValue) for a non-positive size or an unknown dtype.
extern "C" int conv_wgrad_direct(const void* x, const void* cot, float* ws,
                                 float* dw, int dtype, const int* dims,
                                 const long long* xs, const long long* cs,
                                 void* stream) {
  WgradShape sh;
  sh.B = dims[0]; sh.Cin = dims[1]; sh.Cout = dims[2]; sh.OH = dims[3];
  sh.OW = dims[4]; sh.k = dims[5]; sh.s = dims[6]; sh.nb_chunk = dims[7];
  for (int i = 0; i < 8; ++i)
    if (dims[i] <= 0) return cudaErrorInvalidValue;
  for (int i = 0; i < 4; ++i) { sh.sx[i] = xs[i]; sh.sc[i] = cs[i]; }
  const int n_chunks = (sh.B + sh.nb_chunk - 1) / sh.nb_chunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) err = launch_partial<float>(x, cot, ws, sh, n_chunks, st);
  else if (dtype == 1) err = launch_partial<__nv_bfloat16>(x, cot, ws, sh, n_chunks, st);
  else return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  const int n_out = sh.Cout * sh.Cin * sh.k * sh.k;
  wgrad_reduce_kernel<<<(n_out + 255) / 256, 256, 0, st>>>(ws, dw, n_out, n_chunks);
  return cudaGetLastError();
}
