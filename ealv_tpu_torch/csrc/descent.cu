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
