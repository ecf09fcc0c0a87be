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
// in torch's OIHW layout (the JAX function returns HWIO). The TPU kernel
// carried its accumulator across a sequential batch grid in VMEM; Hopper
// blocks run in no order, so both kernels here split the sum in two passes:
// pass 1 writes one partial per block to a workspace, pass 2
// (wgrad_reduce_kernel) sums the partials in block order. No float atomics,
// so dW is the same from run to run, as the TPU kernel's sequential grid
// made it. Both inputs are read through explicit element strides, so any
// layout works without a copy; the CVAE's first layer reads its image batch
// as a channels-last (NHWC) view, and the trainer hands the later layers
// channels-last activations and cotangents.
//
// bf16 inputs (wgrad_mma_kernel, the trainer's path): dW[co, t] =
// sum_p cot[co, p] * X[p, t] is a GEMM with a long K (p = (b, oh, ow): 507 k,
// 124 k and 12.5 k at batch 64 for the CVAE encoder's three layers), a small
// M (Cout <= 20) and a small N (taps t = (ci, kh, kw): 27, 90, 250). The
// 63-137 M multiply-adds per layer are about 1 us of tensor-core time. The
// first design (one block per tap) re-read the cotangent once per tap,
// 27-250 times per layer. Here, as the TPU kernel's docstring set out, each
// input crosses the memory system about once: a block takes work items (a
// band of R output rows of one image, all columns), stages the band's
// s*(R-1)+k rows of x and its R rows of cot in shared memory, builds the
// im2col tile there from two offset tables (position and tap) and sums
// with warp-level tensor-core MMA (nvcuda::wmma, 16x16x16 bf16 fragments,
// f32 accumulators). Cout pads to 16, the taps of a channel group to 16;
// warps split the n-tiles, then the k-steps. A block's warps add their
// accumulators in a fixed order through shared memory. The staging is
// double-buffered: cp.async copies the block's next item while it computes
// on the current one. wgmma is not used: its 64-row tiles would leave two
// thirds idle at Cout <= 20, and the MACs are not the limit; TMA is not
// used: it needs 16-byte global strides, and layer 1's channels-last rows
// are 1,080 bytes and odd widths leave rows at 2-byte alignment. Contiguous
// spans (a channel plane's rows, or a channels-last band) are copied as
// their 16-byte-aligned superset (never past the 16-byte chunk that holds
// a valid element, so never outside the allocation); other strides are
// staged element by element. The schedule (band rows, groups, grid,
// shared-memory layout) is fixed on the host by ops/wgrad.py::wgrad_plan
// from the shape alone, so a channels-last view and its contiguous copy
// give the same bits.
//
// What bounds it on an H100 (measured at the trainer's layouts, batch 64):
// neither device memory (layer 1 reads about 24.6 MB in 47 us, 0.5 TB/s)
// nor the tensor cores, but the block's own shared-memory work per item.
// With the copies removed the kernel keeps 92% of its time; staging alone
// (with the offset tables and barriers) takes 45%, building the A tile
// 16%, and gathering the im2col tiles plus the MMAs the remaining 39%. The
// next step is to cut that per-item work (an A tile loaded straight from
// the staged cot, wider im2col gathers), not to copy faster.
//
// f32 inputs (wgrad_partial_kernel; the toy and CPU-agreement path, where
// TF32 tensor cores would break the f32 tolerance): one block per (tap
// (ci, kh, kw), group of up to CG output channels, batch chunk). Its
// threads stride over the chunk's (b, oh, ow) positions, read one x value
// and CG cotangent values per position, and keep CG f32 accumulators in
// registers; a warp-shuffle and shared-memory reduction in a fixed order
// gives the block's partial sums, written to a workspace (n_chunks, Cout,
// taps). The odd tails (180 -> 89 leaves row and column 179 unread) need
// no masking in either kernel: only positions s*oh + kh < s*(OH-1) + k <= H
// are ever read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cuda_pipeline.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

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

// ---- bf16: the tensor-core kernel ----

enum StageMode { kScalar = 0, kPlanes = 1, kChannelsLast = 2 };

// The host plan (ops/wgrad.py::WgradPlan and stage_modes), in the order of
// PLAN_FIELDS there, then the staging modes; sizes in elements, off_* in
// bytes of dynamic shared memory.
struct MmaPlan {
  int B, Cin, H, W, Cout, k, s, OH, OW, R, XR, n_bands, cig, MG, M_pad, N_pad,
      P_pad, n_items, G, kph, ntw, x_pitch, c_pitch, off_x0, off_x1, off_c0,
      off_c1, off_a, off_pos, off_tap, off_b, off_red, smem_bytes;
  int x_mode, x_hs, x_ws, c_mode, c_ps;
  long long sx[4];  // x strides (b, c, h, w), in elements
  long long sc[4];  // cot strides (b, c, h, w), in elements
};
constexpr int kPlanInts = 38;
static_assert(offsetof(MmaPlan, sx) == kPlanInts * sizeof(int),
              "MmaPlan's ints must come first, unpadded");

using bf16 = __nv_bfloat16;

// one work item: a band of `rows` output rows of image b from row oh0
struct Item {
  int b, oh0, rows, xrows, npos;
};

__device__ __forceinline__ Item item_at(const MmaPlan& p, int item) {
  Item it;
  it.b = item / p.n_bands;
  it.oh0 = (item - it.b * p.n_bands) * p.R;
  it.rows = min(p.R, p.OH - it.oh0);
  it.xrows = p.s * (it.rows - 1) + p.k;
  it.npos = it.rows * p.OW;
  return it;
}

// the item's first x row (channel 0) and first cot row (channel 0)
__device__ __forceinline__ const bf16* x_band(const MmaPlan& p, const bf16* x,
                                              const Item& it) {
  return x + it.b * p.sx[0] + (long long)(p.s * it.oh0) * p.sx[2];
}
__device__ __forceinline__ const bf16* cot_band(const MmaPlan& p, const bf16* cot,
                                                const Item& it) {
  return cot + it.b * p.sc[0] + (long long)it.oh0 * p.sc[2];
}

// misalignment of a span's start in elements: where its first element lands
// in the 16-byte chunks copied from the aligned address below it
__device__ __forceinline__ int span_lead(const bf16* src) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(src) & 15) >> 1);
}

// Start the asynchronous copy (cp.async) of the 16-byte chunks that cover
// src[0, len) to dst (16-byte aligned): src[i] lands at dst[span_lead(src)
// + i] once the block's pipeline has waited for it.
__device__ __forceinline__ void copy_span(bf16* dst, const bf16* src, int len) {
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(src) & ~uintptr_t(15);
  const uintptr_t a1 = (reinterpret_cast<uintptr_t>(src + len) + 15) & ~uintptr_t(15);
  const int n = static_cast<int>((a1 - a0) >> 4);
  for (int i = threadIdx.x; i < n; i += kThreads)
    __pipeline_memcpy_async(reinterpret_cast<uint4*>(dst) + i,
                            reinterpret_cast<const uint4*>(a0) + i, 16);
}

// Stage item `it`'s x slice (channels g0 .. g0+nci) and cot slice (channels
// c0 .. c0+nco) in xs and cs: contiguous spans by cp.async (complete after
// the pipeline's wait), other strides element by element (complete after
// the next __syncthreads).
__device__ void stage_item(const MmaPlan& p, const bf16* x, const bf16* cot,
                           const Item& it, bf16* xs, bf16* cs, int g0, int nci,
                           int c0, int nco) {
  const bf16* xb = x_band(p, x, it);
  if (p.x_mode == kPlanes) {
    for (int c = 0; c < nci; ++c)
      copy_span(xs + c * p.x_pitch, xb + (g0 + c) * p.sx[1], it.xrows * p.W);
  } else if (p.x_mode == kChannelsLast) {
    copy_span(xs, xb, it.xrows * p.W * p.Cin);
  } else {
    const int wu = p.x_hs, plane = it.xrows * wu;
    for (int e = threadIdx.x; e < nci * plane; e += kThreads) {
      const int c = e / plane, r = e - c * plane, h = r / wu, w = r - h * wu;
      xs[c * p.XR * wu + h * wu + w] =
          xb[(g0 + c) * p.sx[1] + h * p.sx[2] + w * p.sx[3]];
    }
  }
  const bf16* cb = cot_band(p, cot, it);
  if (p.c_mode == kPlanes) {
    for (int c = 0; c < nco; ++c)
      copy_span(cs + c * p.c_pitch, cb + (c0 + c) * p.sc[1], it.npos);
  } else if (p.c_mode == kChannelsLast) {
    copy_span(cs, cb, it.npos * p.Cout);
  } else {
    for (int e = threadIdx.x; e < nco * it.npos; e += kThreads) {
      const int c = e / it.npos, q = e - c * it.npos, oh = q / p.OW, ow = q - oh * p.OW;
      cs[c * p.R * p.OW + q] = cb[(c0 + c) * p.sc[1] + oh * p.sc[2] + ow * p.sc[3]];
    }
  }
}

// Shared-memory offset of staged channel j of a group starting at channel
// j0 (ops/wgrad.py::plane_base): its own span (band + (j0+j)*chan_stride),
// the one channels-last span from band, or scalar_pitch apart when staged
// element by element.
__device__ __forceinline__ int plane_base(int mode, int j, int j0, const bf16* band,
                                          long long chan_stride, int pitch,
                                          int scalar_pitch) {
  if (mode == kPlanes) return j * pitch + span_lead(band + (j0 + j) * chan_stride);
  if (mode == kChannelsLast) return span_lead(band) + j0 + j;
  return j * scalar_pitch;
}

// Pass 1, bf16. Block (g, i, j) takes items g, g + G, ... with input
// channels [i*cig, ...) and output channels [j*MG, ...); MT m-tiles of 16
// output channels, NTW n-tiles of 16 taps per warp.
template <int MT, int NTW>
__global__ void __launch_bounds__(kThreads)
    wgrad_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ cot,
                     float* __restrict__ ws, const MmaPlan p) {
  namespace wmma = nvcuda::wmma;
  extern __shared__ __align__(128) unsigned char smem[];
  // two staging buffers each: item i is read from buffer i % 2 while the
  // next item's copy lands in the other (chosen by a select: an indexed
  // pointer array would live in local memory)
  bf16* const xs0 = reinterpret_cast<bf16*>(smem + p.off_x0);
  bf16* const xs1 = reinterpret_cast<bf16*>(smem + p.off_x1);
  bf16* const cs0 = reinterpret_cast<bf16*>(smem + p.off_c0);
  bf16* const cs1 = reinterpret_cast<bf16*>(smem + p.off_c1);
  bf16* a_tile = reinterpret_cast<bf16*>(smem + p.off_a);  // [M_pad][P_pad]
  int* pos = reinterpret_cast<int*>(smem + p.off_pos);     // [P_pad]
  int* tap = reinterpret_cast<int*>(smem + p.off_tap);     // [N_pad]
  float* red = reinterpret_cast<float*>(smem + p.off_red); // [kph][M_pad][N_pad]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* b_tile = reinterpret_cast<bf16*>(smem + p.off_b) + warp * 256;  // [16][16]
  const bf16 zero = __ushort_as_bfloat16(0);

  const int kk = p.k * p.k;
  const int g0 = blockIdx.y * p.cig, nci = min(p.cig, p.Cin - g0), ntaps = nci * kk;
  const int c0 = blockIdx.z * p.MG, nco = min(p.MG, p.Cout - c0);
  // warps split the n-tiles, then the k-steps: with NT >= 8 n-tiles warp w
  // owns tiles w, w + 8 (one phase); else warp w owns tile w % NT in
  // k-step phase w / NT of kph
  const int NT = p.N_pad / 16;
  const int phase = NT >= kWarps ? 0 : warp / NT;
  const int n_first = NT >= kWarps ? warp : warp % NT;
  const bool active = phase < p.kph;

  for (int q = threadIdx.x; q < p.P_pad; q += kThreads) {
    const int oh = q / p.OW, ow = q - oh * p.OW;
    pos[q] = p.s * oh * p.x_hs + p.s * ow * p.x_ws;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MT][NTW];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NTW; ++j) wmma::fill_fragment(acc[m][j], 0.0f);

  if (blockIdx.x < p.n_items)
    stage_item(p, x, cot, item_at(p, blockIdx.x), xs0, cs0, g0, nci, c0, nco);
  __pipeline_commit();
  for (int item = blockIdx.x, i = 0; item < p.n_items; item += p.G, ++i) {
    const Item it = item_at(p, item);
    const bool odd = i & 1;
    bf16* const xs = odd ? xs1 : xs0;
    bf16* const cs = odd ? cs1 : cs0;
    // the next item's copy goes out before this item's arrival is awaited
    if (item + p.G < p.n_items)
      stage_item(p, x, cot, item_at(p, item + p.G), odd ? xs0 : xs1, odd ? cs0 : cs1,
                 g0, nci, c0, nco);
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();

    // the A tile [co][p] from the staged cot, zero past nco and npos, and
    // the tap offsets into the staged x, -1 past the group's taps
    const bf16* xb = x_band(p, x, it);
    const bf16* cb = cot_band(p, cot, it);
    for (int e = threadIdx.x; e < p.M_pad * p.P_pad; e += kThreads) {
      const int m = e / p.P_pad, q = e - m * p.P_pad;
      bf16 v = zero;
      if (m < nco && q < it.npos)
        v = cs[plane_base(p.c_mode, m, c0, cb, p.sc[1], p.c_pitch, p.R * p.OW) +
               q * p.c_ps];
      a_tile[e] = v;
    }
    for (int t = threadIdx.x; t < p.N_pad; t += kThreads) {
      int off = -1;
      if (t < ntaps) {
        const int c = t / kk, r = t - c * kk, kh = r / p.k, kw = r - kh * p.k;
        off = plane_base(p.x_mode, c, g0, xb, p.sx[1], p.x_pitch, p.XR * p.x_hs) +
              kh * p.x_hs + kw * p.x_ws;
      }
      tap[t] = off;
    }
    __syncthreads();

    if (active) {
      const int nks = (it.npos + 15) / 16;
      for (int ks = phase; ks < nks; ks += p.kph) {
        const int p0 = ks * 16;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m)
          wmma::load_matrix_sync(a[m], a_tile + m * 16 * p.P_pad + p0, p.P_pad);
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          const int n = n_first + j * kWarps;
          if (n < NT) {
            // the im2col tile [16 positions][16 taps]: lane owns one tap
            // column and every other row
            const int toff = tap[n * 16 + (lane & 15)];
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              const int row = (lane >> 4) + 2 * r, q = p0 + row;
              b_tile[row * 16 + (lane & 15)] =
                  (toff >= 0 && q < it.npos) ? xs[pos[q] + toff] : zero;
            }
            __syncwarp();
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
            wmma::load_matrix_sync(b, b_tile, 16);
#pragma unroll
            for (int m = 0; m < MT; ++m) wmma::mma_sync(acc[m][j], a[m], b, acc[m][j]);
            __syncwarp();
          }
        }
      }
    }
    __syncthreads();
  }

  // the phases' sums in phase order, then the block's partial to ws[g]
  if (active) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int n = n_first + j * kWarps;
        if (n < NT)
          wmma::store_matrix_sync(red + (phase * p.M_pad + m * 16) * p.N_pad + n * 16,
                                  acc[m][j], p.N_pad, wmma::mem_row_major);
      }
  }
  __syncthreads();
  const int taps = p.Cin * kk;
  for (int e = threadIdx.x; e < nco * ntaps; e += kThreads) {
    const int m = e / ntaps, t = e - m * ntaps;
    float sum = 0.0f;
    for (int ph = 0; ph < p.kph; ++ph) sum += red[(ph * p.M_pad + m) * p.N_pad + t];
    ws[((long long)blockIdx.x * p.Cout + c0 + m) * taps + g0 * kk + t] = sum;
  }
}

template <int MT, int NTW>
cudaError_t launch_mma_t(const void* x, const void* cot, float* ws, const MmaPlan& p,
                         cudaStream_t stream) {
  // raised once per instantiation to the largest size it has launched with
  static int smem_allowed = 48 * 1024;
  if (p.smem_bytes > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        wgrad_mma_kernel<MT, NTW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        p.smem_bytes);
    if (err != cudaSuccess) return err;
    smem_allowed = p.smem_bytes;
  }
  const dim3 grid(p.G, (p.Cin + p.cig - 1) / p.cig, (p.Cout + p.MG - 1) / p.MG);
  wgrad_mma_kernel<MT, NTW><<<grid, kThreads, p.smem_bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(cot), ws, p);
  return cudaGetLastError();
}

template <int MT>
cudaError_t launch_mma_m(const void* x, const void* cot, float* ws, const MmaPlan& p,
                         cudaStream_t stream) {
  if (p.ntw == 1) return launch_mma_t<MT, 1>(x, cot, ws, p, stream);
  if (p.ntw == 2) return launch_mma_t<MT, 2>(x, cot, ws, p, stream);
  return cudaErrorInvalidValue;
}

cudaError_t launch_mma(const void* x, const void* cot, float* ws, const MmaPlan& p,
                       cudaStream_t stream) {
  switch (p.M_pad / 16) {
    case 1: return launch_mma_m<1>(x, cot, ws, p, stream);
    case 2: return launch_mma_m<2>(x, cot, ws, p, stream);
    case 3: return launch_mma_m<3>(x, cot, ws, p, stream);
    case 4: return launch_mma_m<4>(x, cot, ws, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. x and cot are device pointers to
// arrays of one dtype (0: f32, 1: bf16) read through the element strides
// xs and cs (b, c, h, w). dims = (B, Cin, Cout, OH, OW, k, s, nb_chunk).
// f32 goes to wgrad_partial_kernel with n_chunks = ceil(B / nb_chunk); bf16
// goes to wgrad_mma_kernel with the host plan `plan` (kPlanInts values,
// ops/wgrad.py::PLAN_FIELDS then the staging modes) and n_chunks = its G.
// ws is a device f32 workspace of n_chunks * Cout * Cin * k * k elements;
// dw receives (Cout, Cin, k, k) f32. Launches the two passes on `stream`
// and does not synchronise. Returns the first failing launch's cudaError_t
// (0 on success); 1 (cudaErrorInvalidValue) for a non-positive size, an
// unknown dtype, or a bf16 call without a plan or with a plan it cannot run.
extern "C" int conv_wgrad_direct(const void* x, const void* cot, float* ws,
                                 float* dw, int dtype, const int* dims,
                                 const long long* xs, const long long* cs,
                                 const long long* plan, void* stream) {
  WgradShape sh;
  sh.B = dims[0]; sh.Cin = dims[1]; sh.Cout = dims[2]; sh.OH = dims[3];
  sh.OW = dims[4]; sh.k = dims[5]; sh.s = dims[6]; sh.nb_chunk = dims[7];
  for (int i = 0; i < 8; ++i)
    if (dims[i] <= 0) return cudaErrorInvalidValue;
  for (int i = 0; i < 4; ++i) { sh.sx[i] = xs[i]; sh.sc[i] = cs[i]; }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  int n_chunks;
  if (dtype == 0) {
    n_chunks = (sh.B + sh.nb_chunk - 1) / sh.nb_chunk;
    err = launch_partial<float>(x, cot, ws, sh, n_chunks, st);
  } else if (dtype == 1) {
    if (plan == nullptr) return cudaErrorInvalidValue;
    MmaPlan p;
    int fields[kPlanInts];  // the ints of MmaPlan, in order
    for (int i = 0; i < kPlanInts; ++i) fields[i] = static_cast<int>(plan[i]);
    memcpy(&p, fields, sizeof(fields));
    for (int i = 0; i < 4; ++i) { p.sx[i] = xs[i]; p.sc[i] = cs[i]; }
    n_chunks = p.G;
    err = launch_mma(x, cot, ws, p, st);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const int n_out = sh.Cout * sh.Cin * sh.k * sh.k;
  wgrad_reduce_kernel<<<(n_out + 255) / 256, 256, 0, st>>>(ws, dw, n_out, n_chunks);
  return cudaGetLastError();
}
