// The identification's belief fusion for Hopper (sm_90a): each belief's
// pushes into its ring of pending measurements, then the precision-weighted
// Gaussian fusion of the pending ones into its grid (`FingerprintBelief.push`
// then `update_prior`, ealv_tpu_torch/fingerprint/belief.py), for a list of
// beliefs in three launches.
//
// Replaces no Pallas kernel: the JAX package's `update_prior`
// (ealv_tpu/fingerprint/belief.py) is jnp code that XLA fuses. The port ran
// it as some 15 eager passes over the difference of every ring slot to every
// grid cell, (G, cap, d) and (G, cap) float32 tensors, of which only the
// pending columns count (2 a tick in the identification, 1 in error mode).
//
// What bounds it: bytes. Each belief's prior and variance are read and
// written once, 16 B a cell; at G = 125,000 cells and 16 beliefs that is 32
// MB, 9.55 us at 3.35 TB/s. The design reads only the pending columns and
// keeps every (G, n) intermediate out of device memory:
//   1. column pass: each block rebuilds its belief's ring with the pushes
//      applied in shared memory (block 0 writes the new ring and counters),
//      then, for each pending column, the block's sum and max over its
//      kCellsPerBlock cells of the column's pdf -> per-block partials;
//   2. cell pass: every block reduces its belief's column partials in one
//      fixed order (each block alike, so all hold the same totals),
//      recomputes the pdfs, and writes each cell's mean over the columns of
//      the renormalized pdf (4 B a cell) and the block's sum and max of it;
//   3. update pass: the cell pass's partials in one fixed order, then
//      renormalize, rescale and the precision-weighted posterior, the prior
//      and variance read once and written once.
// Beyond the bound's 16 B a cell, the passes read the grid twice (4d B a
// cell each, the second mostly from L2) and write and read the cell's mean
// (8 B). blockIdx.y is the belief: one launch serves up to kMaxBeliefs
// beliefs, whose pointers travel by value in a __grid_constant__ parameter,
// so eager calls and graph replays make the same launches. The pending
// count is read on the device and nothing synchronises, so a CUDA graph
// captures the call. With no pending measurement the update pass copies
// the prior and variance.
//
// Deterministic: every sum runs in a fixed order (a fixed cell-to-thread
// map, warp shuffles in xor order, the warps' partials in warp order, the
// blocks' partials in block order) and there are no atomics, so a repeated
// call and a graph's replay give the same bits.
//
// Arithmetic: f32 in update_prior's torch operations on CUDA, each rounded
// on its own (__fmul_rn, __fadd_rn, __fdiv_rn: never contracted into an
// FMA), with the precise expf, logf and tanhf; a division by a host scalar
// is a multiply by its f32 reciprocal, as torch's is. Only the sums' order
// differs from torch's. Maxima propagate NaN, as torch.amax does.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCellsPerThread = 4;
constexpr int kCellsPerBlock = kThreads * kCellsPerThread;
constexpr int kMaxD = 6;          // MAX_D in ops/belief.py
constexpr int kMaxCap = 256;      // MAX_CAP
constexpr int kMaxBeliefs = 16;   // MAX_BELIEFS: a launch's beliefs
constexpr int kPtrs = 15;         // pointers a belief, in Belief's order
constexpr int kInts = 3;
constexpr int kFloats = 6;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kFloor = 1e-6f;  // renormalize's clamp

struct Belief {
  const float* grid;       // (G, d)
  const float* prior;      // (G,)
  const float* prior_var;  // (G,)
  const float* meas_loc;   // (cap, d) the ring
  const float* meas_val;   // (cap,)
  const long long* meas_n;  // () pending count, 0..cap
  const long long* count;   // () fused so far
  const float* rows;       // (pushes, d), rows row_stride floats apart
  const float* vals;       // (pushes,), val_stride floats apart
  float* out_prior;
  float* out_var;
  float* out_loc;
  float* out_val;
  long long* out_n;
  long long* out_count;
  int pushes, row_stride, val_stride;
  float thresh, inv_thresh, inv_span;  // _process_meas: 1/thresh, 1/(clip - thresh)
  float inv_std;                       // 1/max(scale/2, 1e-6)
  float rescale_mul, rescale_add;      // scale - 50 scale, 50 scale
};

struct Fusion {
  Belief b[kMaxBeliefs];
  float* col_part;   // (beliefs, blocks, cap, 2): each block's sum and max of a column's pdf
  float* cell_part;  // (beliefs, blocks, 2): each block's sum and max of the cells' means
  float* cell_mean;  // (beliefs, G)
  int g, cap, blocks;
};

__device__ __forceinline__ float nan_max(float acc, float e) {
  return (e > acc || e != e) ? e : acc;
}

// torch.clamp(min=1e-6), which passes NaN
__device__ __forceinline__ float floor_clamp(float x) { return x < kFloor ? kFloor : x; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// exp(-0.5 * sum_k (c_k - loc_k)^2 / std)
template <int D>
__device__ __forceinline__ float gauss(const float* c, const float* loc, float inv_std) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const float diff = __fsub_rn(c[k], loc[k]);
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(diff, diff), inv_std));
  }
  return expf(__fmul_rn(-0.5f, acc));
}

// renormalize's exp(log(clamp(x / total)) - log(clamp(max / total)))
__device__ __forceinline__ float renorm(float x, float total, float log_max) {
  return expf(__fsub_rn(logf(floor_clamp(__fdiv_rn(x, total))), log_max));
}

__device__ __forceinline__ int clamp_count(long long n, int cap) {
  return n < 0 ? 0 : n < cap ? (int)n : cap;
}

// the pending count after the pushes: each push adds one, up to cap
__device__ __forceinline__ int pending(const Belief& a, int cap) {
  return clamp_count(clamp_count(*a.meas_n, cap) + (long long)a.pushes, cap);
}

template <int D>
__global__ void __launch_bounds__(kThreads) column_pass(const __grid_constant__ Fusion p) {
  const Belief& a = p.b[blockIdx.y];
  const int cap = p.cap;
  __shared__ float loc[kMaxCap * D];
  __shared__ float val[kMaxCap];
  __shared__ float wsum[kWarps][kMaxCap];
  __shared__ float wmax[kWarps][kMaxCap];
  __shared__ int n_s;
  for (int i = threadIdx.x; i < cap * D; i += kThreads) loc[i] = a.meas_loc[i];
  for (int i = threadIdx.x; i < cap; i += kThreads) val[i] = a.meas_val[i];
  __syncthreads();
  if (threadIdx.x == 0) {  // push's slot is the count modulo cap; the count stops at cap
    long long n = clamp_count(*a.meas_n, cap);
    for (int q = 0; q < a.pushes; ++q) {
      const int slot = (int)(n % cap);
#pragma unroll
      for (int k = 0; k < D; ++k) loc[slot * D + k] = a.rows[(long long)q * a.row_stride + k];
      val[slot] = a.vals[(long long)q * a.val_stride];
      n = n + 1 < cap ? n + 1 : cap;
    }
    n_s = (int)n;
  }
  __syncthreads();
  const int n = n_s;
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < cap * D; i += kThreads) a.out_loc[i] = loc[i];
    for (int i = threadIdx.x; i < cap; i += kThreads) a.out_val[i] = val[i];
    if (threadIdx.x == 0) {
      *a.out_n = 0;
      *a.out_count = *a.count + n;
    }
  }
  if (n == 0) return;

  float c[kCellsPerThread][D];
  bool ok[kCellsPerThread];
  const int first = blockIdx.x * kCellsPerBlock + threadIdx.x;
#pragma unroll
  for (int i = 0; i < kCellsPerThread; ++i) {
    const int g = first + i * kThreads;
    ok[i] = g < p.g;
#pragma unroll
    for (int k = 0; k < D; ++k) c[i][k] = ok[i] ? a.grid[(size_t)g * D + k] : 0.0f;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = 0; j < n; ++j) {
    float s = 0.0f, m = -INFINITY;
#pragma unroll
    for (int i = 0; i < kCellsPerThread; ++i) {
      if (!ok[i]) continue;
      const float f = gauss<D>(c[i], loc + j * D, a.inv_std);
      s = __fadd_rn(s, f);
      m = nan_max(m, f);
    }
    s = warp_sum(s);
    m = warp_max(m);
    if (lane == 0) {
      wsum[warp][j] = s;
      wmax[warp][j] = m;
    }
  }
  __syncthreads();
  float* part = p.col_part + ((size_t)blockIdx.y * p.blocks + blockIdx.x) * cap * 2;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    float s = wsum[0][j], m = wmax[0][j];
    for (int w = 1; w < kWarps; ++w) {
      s = __fadd_rn(s, wsum[w][j]);
      m = nan_max(m, wmax[w][j]);
    }
    part[2 * j] = s;
    part[2 * j + 1] = m;
  }
}

// the block's sum and max of (s, m) to out[0], out[1], warps in order
__device__ __forceinline__ void block_sum_max(float s, float m, float* out) {
  __shared__ float ws[kWarps], wm[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s = warp_sum(s);
  m = warp_max(m);
  if (lane == 0) {
    ws[warp] = s;
    wm[warp] = m;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      ws[0] = __fadd_rn(ws[0], ws[w]);
      wm[0] = nan_max(wm[0], wm[w]);
    }
    out[0] = ws[0];
    out[1] = wm[0];
  }
}

// one warp's sum and max over the blocks' partials part[blk * stride], part[blk * stride + 1]
__device__ __forceinline__ void blocks_sum_max(const float* part, int blocks, size_t stride,
                                               float& s, float& m) {
  s = 0.0f;
  m = -INFINITY;
  for (int blk = threadIdx.x & 31; blk < blocks; blk += 32) {
    s = __fadd_rn(s, part[blk * stride]);
    m = nan_max(m, part[blk * stride + 1]);
  }
  s = warp_sum(s);
  m = warp_max(m);
}

template <int D>
__global__ void __launch_bounds__(kThreads) cell_pass(const __grid_constant__ Fusion p) {
  const Belief& a = p.b[blockIdx.y];
  const int cap = p.cap;
  const int n = pending(a, cap);
  if (n == 0) return;
  __shared__ float loc[kMaxCap * D];
  __shared__ float col_total[kMaxCap], col_log_max[kMaxCap];
  for (int i = threadIdx.x; i < n * D; i += kThreads) loc[i] = a.out_loc[i];
  const float* part = p.col_part + (size_t)blockIdx.y * p.blocks * cap * 2;
  for (int j = threadIdx.x >> 5; j < n; j += kWarps) {
    float s, m;
    blocks_sum_max(part + 2 * j, p.blocks, (size_t)cap * 2, s, m);
    if ((threadIdx.x & 31) == 0) {
      col_total[j] = s;
      col_log_max[j] = logf(floor_clamp(__fdiv_rn(m, s)));
    }
  }
  __syncthreads();
  const float nf = (float)n;
  float* mean_out = p.cell_mean + (size_t)blockIdx.y * p.g;
  float s = 0.0f, m = -INFINITY;
  const int first = blockIdx.x * kCellsPerBlock + threadIdx.x;
#pragma unroll
  for (int i = 0; i < kCellsPerThread; ++i) {
    const int g = first + i * kThreads;
    if (g >= p.g) break;
    float c[D];
#pragma unroll
    for (int k = 0; k < D; ++k) c[k] = a.grid[(size_t)g * D + k];
    float acc = 0.0f;
    for (int j = 0; j < n; ++j)
      acc = __fadd_rn(acc, renorm(gauss<D>(c, loc + j * D, a.inv_std), col_total[j],
                                  col_log_max[j]));
    const float mean = __fdiv_rn(acc, nf);
    mean_out[g] = mean;
    s = __fadd_rn(s, mean);
    m = nan_max(m, mean);
  }
  block_sum_max(s, m, p.cell_part + ((size_t)blockIdx.y * p.blocks + blockIdx.x) * 2);
}

__global__ void __launch_bounds__(kThreads) update_pass(const __grid_constant__ Fusion p) {
  const Belief& a = p.b[blockIdx.y];
  const int n = pending(a, p.cap);
  const int first = blockIdx.x * kCellsPerBlock + threadIdx.x;
  if (n == 0) {
#pragma unroll
    for (int i = 0; i < kCellsPerThread; ++i) {
      const int g = first + i * kThreads;
      if (g >= p.g) break;
      a.out_prior[g] = a.prior[g];
      a.out_var[g] = a.prior_var[g];
    }
    return;
  }
  __shared__ float total_s, log_max_s, meas_s;
  if (threadIdx.x < 32) {
    float s, m;
    blocks_sum_max(p.cell_part + (size_t)blockIdx.y * p.blocks * 2, p.blocks, 2, s, m);
    if (threadIdx.x == 0) {
      total_s = s;
      log_max_s = logf(floor_clamp(__fdiv_rn(m, s)));
    }
  } else if (threadIdx.x == 32) {  // the pending values' sum of tanh(_process_meas) / 2 + 0.5
    float acc = 0.0f;
    for (int j = 0; j < n; ++j) {
      float t = __fsub_rn(a.thresh, a.out_val[j]);
      t = t > 0.0f ? __fmul_rn(t, a.inv_thresh) : __fmul_rn(t, a.inv_span);
      acc = __fadd_rn(acc, __fadd_rn(__fmul_rn(tanhf(t), 0.5f), 0.5f));
    }
    meas_s = acc;
  }
  __syncthreads();
  const float total = total_s, log_max = log_max_s, meas = meas_s, nf = (float)n;
  const float* mean_in = p.cell_mean + (size_t)blockIdx.y * p.g;
#pragma unroll
  for (int i = 0; i < kCellsPerThread; ++i) {
    const int g = first + i * kThreads;
    if (g >= p.g) break;
    const float mv = renorm(mean_in[g], total, log_max);
    const float var = __fadd_rn(__fmul_rn(mv, a.rescale_mul), a.rescale_add);
    const float pv = a.prior_var[g];
    const float post_var =
        __fdiv_rn(1.0f, __fadd_rn(__fdiv_rn(1.0f, pv), __fdiv_rn(nf, var)));
    a.out_var[g] = post_var;
    a.out_prior[g] =
        __fmul_rn(post_var, __fadd_rn(__fdiv_rn(a.prior[g], pv), __fdiv_rn(meas, var)));
  }
}

template <int D>
int launch(const Fusion& p, int count, cudaStream_t s) {
  const dim3 grid(p.blocks, count);
  column_pass<D><<<grid, kThreads, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cell_pass<D><<<grid, kThreads, 0, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  update_pass<<<grid, kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

int blocks_for(int g) { return (g + kCellsPerBlock - 1) / kCellsPerBlock; }

}  // namespace

// Plain C entry points, loaded with ctypes. Pointers are device pointers,
// each launch runs on `stream` and nothing synchronises.

// The scratch a call of `count` beliefs of g cells and a ring of cap needs,
// in floats.
extern "C" long long fuse_beliefs_scratch(int count, int g, int cap) {
  const long long blocks = blocks_for(g);
  return (long long)count * (blocks * cap * 2 + blocks * 2 + g);
}

// Push and fuse `count` beliefs of g cells of d states and a ring of cap
// slots, each in three launches together. Belief i's device pointers are
// ptrs[15 i .. 15 i + 14]: grid (g, d), prior (g,), prior_var (g,),
// meas_loc (cap, d), meas_val (cap,), meas_n (), count () (int64), the
// pushed rows and values, then the outputs prior, prior_var, meas_loc,
// meas_val, meas_n, count; ints[3 i ..]: the pushes, the rows' and the
// values' strides in floats; floats[6 i ..]: thresh, 1/thresh,
// 1/(clip - thresh), 1/std, scale - 50 scale, 50 scale. `scratch` holds
// fuse_beliefs_scratch(count, g, cap) floats. Returns the launches'
// cudaError_t (0 on success), or 1 (cudaErrorInvalidValue) for 1 <= count
// <= 16, 1 <= d <= 6 and 1 <= cap <= 256 not met, g * d past 2^31, a null
// pointer or a negative count of pushes.
extern "C" int fuse_beliefs_f32(const unsigned long long* ptrs, const int* ints,
                                const float* floats, int count, int g, int d, int cap,
                                float* scratch, void* stream) {
  if (count < 1 || count > kMaxBeliefs || g < 1 || d < 1 || d > kMaxD || cap < 1 ||
      cap > kMaxCap || (long long)g * d > 0x7fffffffLL || !scratch || !ptrs || !ints || !floats)
    return cudaErrorInvalidValue;
  Fusion p{};
  for (int i = 0; i < count; ++i) {
    const unsigned long long* q = ptrs + (size_t)i * kPtrs;
    const int* n = ints + (size_t)i * kInts;
    const float* f = floats + (size_t)i * kFloats;
    for (int k = 0; k < kPtrs; ++k)
      if (!q[k] && !(n[0] == 0 && (k == 7 || k == 8))) return cudaErrorInvalidValue;
    if (n[0] < 0) return cudaErrorInvalidValue;
    Belief& b = p.b[i];
    b.grid = reinterpret_cast<const float*>(q[0]);
    b.prior = reinterpret_cast<const float*>(q[1]);
    b.prior_var = reinterpret_cast<const float*>(q[2]);
    b.meas_loc = reinterpret_cast<const float*>(q[3]);
    b.meas_val = reinterpret_cast<const float*>(q[4]);
    b.meas_n = reinterpret_cast<const long long*>(q[5]);
    b.count = reinterpret_cast<const long long*>(q[6]);
    b.rows = reinterpret_cast<const float*>(q[7]);
    b.vals = reinterpret_cast<const float*>(q[8]);
    b.out_prior = reinterpret_cast<float*>(q[9]);
    b.out_var = reinterpret_cast<float*>(q[10]);
    b.out_loc = reinterpret_cast<float*>(q[11]);
    b.out_val = reinterpret_cast<float*>(q[12]);
    b.out_n = reinterpret_cast<long long*>(q[13]);
    b.out_count = reinterpret_cast<long long*>(q[14]);
    b.pushes = n[0];
    b.row_stride = n[1];
    b.val_stride = n[2];
    b.thresh = f[0];
    b.inv_thresh = f[1];
    b.inv_span = f[2];
    b.inv_std = f[3];
    b.rescale_mul = f[4];
    b.rescale_add = f[5];
  }
  p.g = g;
  p.cap = cap;
  p.blocks = blocks_for(g);
  p.col_part = scratch;
  p.cell_part = p.col_part + (size_t)count * p.blocks * cap * 2;
  p.cell_mean = p.cell_part + (size_t)count * p.blocks * 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return launch<1>(p, count, s);
    case 2: return launch<2>(p, count, s);
    case 3: return launch<3>(p, count, s);
    case 4: return launch<4>(p, count, s);
    case 5: return launch<5>(p, count, s);
    default: return launch<6>(p, count, s);
  }
}
