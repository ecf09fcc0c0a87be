// The KL-ergodic planner's inner-iteration bookkeeping for Hopper (sm_90a):
// the choice of the slot t_app and of the candidate windows, the window
// search's acceptance, and the step's acceptance.
//
// Replaces no Pallas kernel: in the JAX package these are a few dozen jnp
// operations on scalars and short vectors inside the planner's one jitted
// program (ealv_tpu/control/klerg.py `_line_search` and the inner loop of
// `plan_with_inputs`), which XLA fuses. The port ran them as torch
// operations, about 170 launches of one to fifty elements an inner
// iteration. Here they are three launches an inner iteration, at most:
//   1. descent_slot: t_app = argmin(djdlam), u_app = u_star[t_app],
//      step_done = !(djdlam[t_app] < 0), and either the fixed window's plan
//      where(t_app <= t < t_app + lam, u_app, u_eff) or the search's lam0,
//      its max_app_dur windows [tis, tfs) and their candidate plans
//      where(window, u_app, u), which the planner costs in one batch;
//   2. descent_window: the search's early-stopping acceptance over the
//      candidates' costs Js, the final pick, and the plan
//      where(ok & window, u_app, u_eff);
//   3. descent_accept: the step's acceptance of the new plan and its cost
//      against the last, and the plan, cost, footprint and stop flag it
//      keeps.
// and the cost the first two read (plan_cost, below), about 39 launches of
// torch operations a cost call before.
//
// What bounds it: latency. Each launch is a graph node of a few dozen
// scalar operations and copies of at most a few thousand floats; one block
// (a grid over the footprint for the third) does it.
//
// Arithmetic: none but J0 * 2 (exact, and rounded on its own by
// __fmul_rn; the library is built with --fmad=false besides). The rest is
// integer arithmetic in 64 bits (torch's int64), float comparisons and
// copies, so every output is bit-equal to the plain torch version
// (control/descent.py). NaN takes torch's rules: a comparison with a NaN is
// false, and argmin returns the first NaN if there is one, else the first
// least value (-0 and +0 tie), as torch.argmin does on the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxHorizon = 1024;
constexpr int kMaxAppDur = 1024;
constexpr int kMaxActions = 32;
constexpr int kMaxAcceptBlocks = 264;  // two a streaming multiprocessor

__device__ __forceinline__ bool is_nan(float v) { return v != v; }

// The search's window [ti, tf) of size l around the slot t_app.
__device__ __forceinline__ void window(long long t_app, long long idx, long long H,
                                       long long l, long long& ti, long long& tf) {
  ti = t_app == idx ? t_app : (t_app == H - 1 ? l - 1 : t_app - l);
  tf = t_app == idx ? l + 1 : (t_app == H - 1 ? t_app : t_app + l + 1);
}

// Launch 1. ints = [t_app, lam0, tis (mad), tfs (mad)]; out is the fixed
// window's plan (h, m) when fixed, else the candidates (mad, h, m).
__global__ void __launch_bounds__(kThreads)
    descent_slot_kernel(const float* __restrict__ djdlam, const float* __restrict__ u,
                        const float* __restrict__ u_eff, const float* __restrict__ u_star,
                        int h, int m, long long idx, int mad, long long lam, int fixed,
                        long long* __restrict__ ints, uint8_t* __restrict__ step_done,
                        float* __restrict__ u_app, float* __restrict__ out) {
  __shared__ long long s_tapp;
  if (threadIdx.x == 0) {
    int best = 0;
    float bv = djdlam[0];
    for (int i = 1; i < h && !is_nan(bv); ++i) {
      const float v = djdlam[i];
      if (is_nan(v) || v < bv) {
        best = i;
        bv = v;
      }
    }
    s_tapp = best;
    ints[0] = best;
    *step_done = !(bv < 0.0f);
  }
  __syncthreads();
  const long long t_app = s_tapp;
  const float* src = u_star + t_app * m;
  for (int j = threadIdx.x; j < m; j += blockDim.x) u_app[j] = src[j];
  if (fixed) {
    for (int e = threadIdx.x; e < h * m; e += blockDim.x) {
      const long long t = e / m;
      out[e] = (t >= t_app && t < t_app + lam) ? src[e % m] : u_eff[e];
    }
    return;
  }
  const long long H = h, M = mad;
  if (threadIdx.x == 0) {
    long long lam0;
    if (t_app == 0 || t_app == H - 1) {
      lam0 = min(H, M);
    } else if (t_app == idx) {
      lam0 = min(H - t_app, M);
    } else {
      lam0 = min(min(t_app - idx, H - t_app - idx), (M + 1) / 2);
    }
    ints[1] = max(lam0, 1LL);
  }
  long long ti, tf;
  for (int k = threadIdx.x; k < mad; k += blockDim.x) {  // the window of lam = k + 1
    window(t_app, idx, H, k + 1, ti, tf);
    ints[2 + k] = ti;
    ints[2 + mad + k] = tf;
  }
  const int hm = h * m;
  for (int e = threadIdx.x; e < mad * hm; e += blockDim.x) {
    const int k = e / hm, r = e - k * hm;
    const long long t = r / m;
    window(t_app, idx, H, k + 1, ti, tf);
    out[e] = (t >= ti && t < tf) ? src[r % m] : u[r];
  }
}

// Launch 2. win = [ti, tf] of the window taken, ok its success.
__global__ void __launch_bounds__(kThreads)
    descent_window_kernel(const float* __restrict__ Js, const float* __restrict__ J0p,
                          const long long* __restrict__ ints, const float* __restrict__ u_app,
                          const float* __restrict__ u_eff, int h, int m, long long idx, int mad,
                          long long* __restrict__ win, uint8_t* __restrict__ ok,
                          float* __restrict__ u_new) {
  __shared__ long long s_ti, s_tf;
  __shared__ bool s_ok;
  if (threadIdx.x == 0) {
    const float J0 = *J0p;
    const float J2 = __fmul_rn(J0, 2.0f);
    const long long lam0 = ints[1];
    const long long* tis = ints + 2;
    const long long* tfs = ints + 2 + mad;
    bool done = false;
    long long ti_l = idx, tf_l = lam0, ti = idx, tf = lam0;
    float Jn_last = J2, Jn = J2;
    for (int k = 0; k < mad; ++k) {
      const long long lam_k = lam0 - k;
      const bool active = !done && lam_k > 0;
      // lam0 <= mad, so sel < mad; the min only keeps the reads in bounds
      const long long sel = min(max(lam_k - 1, 0LL), (long long)mad - 1);
      // keep the current window as "last" before testing the next one
      if (active) {
        ti_l = ti;
        tf_l = tf;
        Jn_last = Jn;
        Jn = Js[sel];
      }
      done = done || (active && (Jn_last < J0) && (Jn > Jn_last));
      if (active) {
        ti = tis[sel];
        tf = tfs[sel];
      }
    }
    const bool take = !done && (Jn < J0);
    s_ti = take ? ti : ti_l;
    s_tf = take ? tf : tf_l;
    s_ok = done || take;
    win[0] = s_ti;
    win[1] = s_tf;
    *ok = s_ok;
  }
  __syncthreads();
  const long long ti = s_ti, tf = s_tf;
  const bool use = s_ok;
  for (int e = threadIdx.x; e < h * m; e += blockDim.x) {
    const long long t = e / m;
    u_new[e] = (use && t >= ti && t < tf) ? u_app[e % m] : u_eff[e];
  }
}

// Launch 3. step_done may be null (no slot search: false).
__global__ void __launch_bounds__(kThreads)
    descent_accept_kernel(const float* __restrict__ u_new, const float* __restrict__ cost,
                          const float* __restrict__ q, const uint8_t* __restrict__ step_done,
                          const float* __restrict__ u, const float* __restrict__ last_cost,
                          const float* __restrict__ q_keep, const uint8_t* __restrict__ done,
                          int hm, int n, int check_cost, float* __restrict__ u_out,
                          float* __restrict__ last_cost_out, float* __restrict__ q_keep_out,
                          uint8_t* __restrict__ done_out) {
  const float c = *cost, lc = *last_cost;
  const bool sd = step_done != nullptr && *step_done != 0;
  const bool brk = check_cost && (lc <= c);
  const bool d = *done != 0;
  const bool accept = !d && !sd && !brk;
  const int i0 = blockIdx.x * blockDim.x + threadIdx.x, stride = gridDim.x * blockDim.x;
  for (int e = i0; e < hm; e += stride) u_out[e] = accept ? u_new[e] : u[e];
  for (int e = i0; e < n; e += stride) q_keep_out[e] = accept ? q[e] : q_keep[e];
  if (i0 == 0) {
    *last_cost_out = accept ? c : lc;
    *done_out = d || sd || brk;
  }
}

// ------------------------------------------------------------- the plan cost
//
// plan_cost: the planner's cost of each of K candidate trajectories x_k
// (H, n) (control/klerg.py `_cost`; plain version control/descent.py
// `plan_cost_reference`):
//
//     q_n  = q_base_n + sum_h psi(s_n, x_kh)                  (the footprint)
//     l_n  = log(max(q_n / sum_m q_m, 1e-6)),  r_n = exp(l_n - max_m l_m)
//     qn_n = r'_n / sum_m r'_m,  r'_n = 1e-6 where r_n is NaN, else r_n
//     J_k  = sum_n p_n log(p_n / qn_n) + sum_h barr(x_kh)
//
// with barr(x) = sum_{j < rows} [x_j <= lo_j] w_j (x_j - lo_j)^p_j
//                               + [x_j >= hi_j] w_j (x_j - hi_j)^p_j,
// the box barrier's buffered limits.
//
// What bounds it: latency. At the planner's shapes (K <= 10 candidates,
// H = 10, N = 2000 samples, d <= 6) a call is 10^5 to 10^6 flops on some
// 40 KB; as torch operations it was about 39 launches (the footprint, four
// passes of renormalisation, the KL, 13 for the barrier). Here it is one:
// one block a candidate; its H whitened points in shared memory; each
// thread's PER samples keep their q in registers through four block
// reductions (sum, max, sum, sum), each in a fixed order, so a replay
// gives the same bits. Every load is issued before the first
// __syncthreads, so their latencies overlap: a thread's samples, base and
// target, and the box barrier's (step, row) pairs spread over all the
// threads, whose sum rides on the first reduction (one warp walking the
// rows would wait out a load latency a row).
//
// The footprint is K1's arithmetic (csrc/footprint.cu) step for step:
// samples and points whitened by rsqrt(|std|) * sqrt(0.5 log2 e), a fused
// multiply-add a dimension, exp2f, the sum over h in order from 0, then
// q_base added. So a single plan's footprint has K1's bits, and a
// candidate equal to the nominal plan gets the single plan's cost to the
// bit. The rest differs from the plain version by its order of summation
// alone: accurate logf and expf, IEEE division, no contraction. NaN takes
// torch's rules: the clamp and the max propagate it.

constexpr int kCostThreads = 512;
constexpr int kCostWarps = kCostThreads / 32;
constexpr int kCostMaxHorizon = 1024;
constexpr int kCostMaxDim = 8;
constexpr int kCostMaxRows = 64;
constexpr int kCostMaxSamples = 8 * kCostThreads;
constexpr int kCostMaxCandidates = 65535;
// sqrt(0.5 * log2(e)), K1's whitening: exp(-0.5 * q) = exp2(-q * 0.5 * log2(e))
constexpr float kWhiten = 0.84932180028801904272f;

struct Cols {
  int c[kCostMaxDim];
};

__device__ __forceinline__ float nan_max(float acc, float v) {
  return (v > acc || is_nan(v)) ? v : acc;
}

// A block-wide sum (or NaN-propagating max) in a fixed order: each warp's
// shuffle tree, then the first warp's over the warps' results.
// Two block-wide sums at once, each in block_reduce's order.
__device__ __forceinline__ float2 block_sum2(float2 v, float2* s_part2, float2* s_out2) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v.x += __shfl_down_sync(0xffffffffu, v.x, off);
    v.y += __shfl_down_sync(0xffffffffu, v.y, off);
  }
  if (lane == 0) s_part2[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kCostWarps ? s_part2[lane] : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v.x += __shfl_down_sync(0xffffffffu, v.x, off);
      v.y += __shfl_down_sync(0xffffffffu, v.y, off);
    }
    if (lane == 0) *s_out2 = v;
  }
  __syncthreads();
  return *s_out2;
}

template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* s_part, float* s_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_down_sync(0xffffffffu, v, off);
    v = kMax ? nan_max(v, o) : v + o;
  }
  if (lane == 0) s_part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kCostWarps ? s_part[lane] : (kMax ? -INFINITY : 0.0f);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_down_sync(0xffffffffu, v, off);
      v = kMax ? nan_max(v, o) : v + o;
    }
    if (lane == 0) *s_out = v;
  }
  __syncthreads();
  return *s_out;
}

template <int D, int PER>
__global__ void __launch_bounds__(kCostThreads)
    plan_cost_kernel(const float* __restrict__ trajs, long long cand_stride, int h,
                     int n_state, Cols cols, const float* __restrict__ samples,
                     const float* __restrict__ p_n, const float* __restrict__ q_base,
                     const float* __restrict__ stdv, int n, const float* __restrict__ b_lim,
                     const float* __restrict__ barr_weight, const float* __restrict__ power,
                     int rows, float* __restrict__ cost) {
  __shared__ float s_pts[kCostMaxHorizon * D];
  __shared__ float s_part[kCostWarps];
  __shared__ float2 s_part2[kCostWarps];
  __shared__ float s_out;
  __shared__ float2 s_out2;
  const float* x = trajs + blockIdx.x * cand_stride;
  float w[D];
#pragma unroll
  for (int k = 0; k < D; ++k) w[k] = rsqrtf(fabsf(stdv[k])) * kWhiten;
  // this thread's samples (whitened), base and target
  float s[PER][D], q[PER], p[PER];
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const int i = threadIdx.x + r * kCostThreads;
#pragma unroll
    for (int k = 0; k < D; ++k) s[r][k] = i < n ? samples[(long long)i * D + k] * w[k] : 0.0f;
    q[r] = i < n ? q_base[i] : 0.0f;
    p[r] = i < n ? p_n[i] : 0.0f;
  }
  // the barrier's (step, row) pairs over the threads
  float barr = 0.0f;
  for (int e = threadIdx.x; e < h * rows; e += kCostThreads) {
    const int t = e / rows, j = e - t * rows;
    const float xj = x[(long long)t * n_state + j], lo = b_lim[2 * j], hi = b_lim[2 * j + 1];
    const float lo_term = xj <= lo ? barr_weight[j] * powf(xj - lo, power[j]) : 0.0f;
    const float hi_term = xj >= hi ? barr_weight[j] * powf(xj - hi, power[j]) : 0.0f;
    barr += lo_term + hi_term;
  }
  for (int t = threadIdx.x; t < h; t += kCostThreads) {
#pragma unroll
    for (int k = 0; k < D; ++k) s_pts[t * D + k] = x[(long long)t * n_state + cols.c[k]] * w[k];
  }
  __syncthreads();

  // the footprint, q = q_base + sum_h psi, its sum and the barrier's
  float part = 0.0f;
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    if (threadIdx.x + r * kCostThreads < n) {
      float acc = 0.0f;
      for (int t = 0; t < h; ++t) {
        float sq = 0.0f;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          const float diff = s[r][k] - s_pts[t * D + k];
          sq = fmaf(diff, diff, sq);
        }
        acc += exp2f(-sq);
      }
      q[r] = q[r] + acc;
      part += q[r];
    }
  }
  const float2 sums = block_sum2(make_float2(part, barr), s_part2, &s_out2);
  const float total = sums.x;

  // renormalize: divide, clamp, log, and the max of the logs
  float top = -INFINITY;
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    if (threadIdx.x + r * kCostThreads < n) {
      float v = q[r] / total;
      v = is_nan(v) ? v : fmaxf(v, 1e-6f);
      q[r] = logf(v);
      top = nan_max(top, q[r]);
    }
  }
  top = block_reduce<true>(top, s_part, &s_out);

  // exp(l - max), NaN -> 1e-6 (cost_norm), and the sum
  part = 0.0f;
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    if (threadIdx.x + r * kCostThreads < n) {
      const float e = expf(q[r] - top);
      q[r] = is_nan(e) ? 1e-6f : e;
      part += q[r];
    }
  }
  const float denom = block_reduce<false>(part, s_part, &s_out);

  // the KL divergence
  part = 0.0f;
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    if (threadIdx.x + r * kCostThreads < n) part += p[r] * logf(p[r] / (q[r] / denom));
  }
  const float d_kl = block_reduce<false>(part, s_part, &s_out);
  if (threadIdx.x == 0) cost[blockIdx.x] = d_kl + sums.y;
}

template <int D>
cudaError_t launch_cost(const float* trajs, long long cand_stride, int k, int h, int n_state,
                        const Cols& cols, const float* samples, const float* p_n,
                        const float* q_base, const float* stdv, int n, const float* b_lim,
                        const float* barr_weight, const float* power, int rows, float* cost,
                        cudaStream_t stream) {
#define COST_LAUNCH(PER)                                                                     \
  plan_cost_kernel<D, PER><<<k, kCostThreads, 0, stream>>>(trajs, cand_stride, h, n_state,   \
                                                           cols, samples, p_n, q_base, stdv, \
                                                           n, b_lim, barr_weight, power,     \
                                                           rows, cost)
  if (n <= kCostThreads) {
    COST_LAUNCH(1);
  } else if (n <= 4 * kCostThreads) {
    COST_LAUNCH(4);
  } else {
    COST_LAUNCH(8);
  }
#undef COST_LAUNCH
  return cudaGetLastError();
}

bool bad_sizes(int h, int m, int mad) {
  return h < 1 || h > kMaxHorizon || m < 1 || m > kMaxActions || mad < 0 || mad > kMaxAppDur;
}

}  // namespace

// Launch 1: the slot and the fixed window's plan (fixed != 0; ints holds
// t_app alone then) or the search's windows and candidates (mad >= 1).
extern "C" int descent_slot_f32(const float* djdlam, const float* u, const float* u_eff,
                                const float* u_star, int h, int m, int idx, int mad,
                                long long lam, int fixed, long long* ints,
                                unsigned char* step_done, float* u_app, float* out,
                                void* stream) {
  if (bad_sizes(h, m, mad) || idx < 0 || (!fixed && mad < 1) || !djdlam || !u_eff ||
      !u_star || !ints || !step_done || !u_app || !out || (!fixed && !u))
    return cudaErrorInvalidValue;
  descent_slot_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      djdlam, u, u_eff, u_star, h, m, idx, mad, lam, fixed, ints, step_done, u_app, out);
  return cudaGetLastError();
}

// Launch 2: the window search's acceptance over the candidates' costs.
extern "C" int descent_window_f32(const float* Js, const float* J0, const long long* ints,
                                  const float* u_app, const float* u_eff, int h, int m,
                                  int idx, int mad, long long* win, unsigned char* ok,
                                  float* u_new, void* stream) {
  if (bad_sizes(h, m, mad) || mad < 1 || idx < 0 || !Js || !J0 || !ints || !u_app || !u_eff ||
      !win || !ok || !u_new)
    return cudaErrorInvalidValue;
  descent_window_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      Js, J0, ints, u_app, u_eff, h, m, idx, mad, win, ok, u_new);
  return cudaGetLastError();
}

// Launch 3: the step's acceptance; hm plan floats, n footprint floats.
extern "C" int descent_accept_f32(const float* u_new, const float* cost, const float* q,
                                  const unsigned char* step_done, const float* u,
                                  const float* last_cost, const float* q_keep,
                                  const unsigned char* done, int hm, int n, int check_cost,
                                  float* u_out, float* last_cost_out, float* q_keep_out,
                                  unsigned char* done_out, void* stream) {
  if (hm < 1 || n < 1 || !u_new || !cost || !q || !u || !last_cost || !q_keep || !done ||
      !u_out || !last_cost_out || !q_keep_out || !done_out)
    return cudaErrorInvalidValue;
  const int most = hm > n ? hm : n;
  int blocks = (most + kThreads - 1) / kThreads;
  if (blocks > kMaxAcceptBlocks) blocks = kMaxAcceptBlocks;
  descent_accept_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      u_new, cost, q, step_done, u, last_cost, q_keep, done, hm, n, check_cost, u_out,
      last_cost_out, q_keep_out, done_out);
  return cudaGetLastError();
}

// The plan cost of k candidates: trajs holds candidate c's (h, n_state)
// states, row-major, at trajs + c * cand_stride; cols (host memory) the d
// exploration columns; samples (n, d), p_n (n,), q_base (n,), stdv (d,);
// the box barrier's rows b_lim (rows, 2), barr_weight (rows,), power
// (rows,), which may be null when rows is 0; cost (k,). Launches one
// kernel on `stream` and does not synchronise. Returns its cudaError_t, or
// cudaErrorInvalidValue for sizes outside the kernel's limits.
extern "C" int plan_cost_f32(const float* trajs, long long cand_stride, int k, int h,
                             int n_state, const int* cols, int d, const float* samples,
                             const float* p_n, const float* q_base, const float* stdv, int n,
                             const float* b_lim, const float* barr_weight, const float* power,
                             int rows, float* cost, void* stream) {
  if (k < 1 || k > kCostMaxCandidates || h < 1 || h > kCostMaxHorizon || n < 1 ||
      n > kCostMaxSamples || d < 1 || d > kCostMaxDim || rows < 0 || rows > kCostMaxRows ||
      rows > n_state || (k > 1 && cand_stride < (long long)h * n_state) || !trajs || !cols ||
      !samples || !p_n || !q_base || !stdv || !cost ||
      (rows > 0 && (!b_lim || !barr_weight || !power)))
    return cudaErrorInvalidValue;
  Cols c = {};
  for (int j = 0; j < d; ++j) {
    if (cols[j] < 0 || cols[j] >= n_state) return cudaErrorInvalidValue;
    c.c[j] = cols[j];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define COST_CASE(D)                                                                       \
  case D:                                                                                  \
    return launch_cost<D>(trajs, cand_stride, k, h, n_state, c, samples, p_n, q_base, stdv, \
                          n, b_lim, barr_weight, power, rows, cost, s);
  switch (d) {
    COST_CASE(1)
    COST_CASE(2)
    COST_CASE(3)
    COST_CASE(4)
    COST_CASE(5)
    COST_CASE(6)
    COST_CASE(7)
    COST_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef COST_CASE
}
