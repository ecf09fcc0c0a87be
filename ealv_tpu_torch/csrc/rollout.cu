// The KL-ergodic planner's horizon recurrences for Hopper (sm_90a): the
// open-loop rollout of plans through the dynamics model, and the costate's
// backward RK4 sweep.
//
// Replaces no Pallas kernel: in the JAX package both are `lax.scan`s inside
// the planner's one jitted program (ealv_tpu/control/klerg.py `_traj_states`,
// `_forward`, `_backward`), which XLA fuses. The port ran them as Python
// loops over the horizon, 100 to 1,000 torch launches of a few dozen floats
// a call, 17 rollouts and 5 sweeps a plan. Here each call is one launch.
//
// What bounds it: latency. A plan is h steps (10 in the cells) of an n <= 32
// state, each a chain of dependent operations a few hundred deep, so a
// launch is worth a graph node's latency (an empty kernel takes about 1 us
// a node) and the design keeps the chain short:
//   - one warp a plan, one lane a state row, each lane's rows of A, B (and
//     LQR's gain) in registers, zero-padded to NMAX (8, 12, 16 or 32, the
//     least that holds n, a template parameter). A matvec is NMAX warp
//     shuffles (lane j's entry to every lane), NMAX products and a pairwise
//     tree of adds; the step's B u_eff is summed once for its four stages;
//   - the SO(3) roll model's rotation (Rodrigues, the product with R, the
//     wrapped Euler angles) runs in a second warp beside the state's RK4:
//     the two exchange the angle rows' velocities and new values in shared
//     memory at one barrier a step. The rotation is one function, not
//     inlined, so nvcc compiles it once for every roll kernel;
//   - the plan is staged in shared memory before the chain starts; K plans
//     (the line search's candidates) are K blocks;
//   - the costate's block stages its matrices and drive with 256 threads,
//     then one warp sweeps, each step's column of jac in registers.
//
// Arithmetic: f32 with the precise math functions, in the stock torch
// path's operations (`control/dynamics.py`, `horizon_rollout_reference` and
// `costate_sweep_reference` in control/horizon.py), each product and sum
// rounded on its own (__fmul_rn, __fadd_rn: never contracted into an FMA,
// as torch's separate multiply and add kernels are not). Where a row of a
// matrix has at most two nonzero products (the double integrators' A and
// B, the speed model's sign-modulated B, the costate's A + B dmu but for
// the roll model's Euler-rate block and the speed model's velocity rows
// under BarrierPush) no order of the sum changes it, so those states and
// costates are bit-equal to the stock loop's; the roll model's 3x3
// products and norm, its trig calls, those costate rows and LQR's dense
// gain may differ from torch's reductions in the last place.
//
// The dynamics model is a template parameter (constant A and B; the speed
// model's |vel| rows and sign-modulated B; the roll model). The warm-start
// policy's action is a kernel argument, one branch a step that every lane
// takes alike (pass the control through; BarrierPush's velocity damping at
// a bound; LQR's -K x): as a template parameter it tripled the kernels nvcc
// compiles on a first run.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kSweepThreads = 256;  // the costate's staging block; warp 0 sweeps
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmemBytes = 48 * 1024;
constexpr int kExchange = 12;  // the roll model's warps' exchange: 2 x 3 velocities, 2 x 3 angles
constexpr float kSixth = static_cast<float>(1.0 / 6.0);
constexpr float kPi = static_cast<float>(3.14159265358979323846);
constexpr float kTwoPi = static_cast<float>(2.0 * 3.14159265358979323846);

enum Model { kLinear = 0, kSpeed = 1, kRoll = 2 };
enum Policy { kPass = 0, kBarrier = 1, kLqr = 2 };

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }

// c = a @ b for 3x3 matrices, each entry summed from j = 0 up
__device__ __forceinline__ void mm3(const float a[9], const float b[9], float c[9]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) acc = add_rn(acc, mul_rn(a[3 * i + j], b[3 * j + k]));
      c[3 * i + k] = acc;
    }
}

// torch.remainder(a, b) for b > 0 and |a| < 2b (an atan2f or asinf result,
// moved by pi, against 2pi): fmod, then moved into the divisor's sign. Here
// fmod is a, or a - b with a's sign, which is exact (b <= |a| < 2b)
__device__ __forceinline__ float wrap_mod(float a, float b) {
  const float mag = fabsf(a);
  float r = mag >= b ? copysignf(sub_rn(mag, b), a) : a;
  return r != 0.0f && r < 0.0f ? add_rn(r, b) : r;
}

// the value of entry `lane` of a 3x3 matrix (0 past the ninth lane),
// selected without indexing registers at run time
__device__ __forceinline__ float entry(const float a[9], int lane) {
  float v = 0.0f;
#pragma unroll
  for (int i = 0; i < 9; ++i) v = lane == i ? a[i] : v;
  return v;
}

struct RolloutArgs {
  const float* x0;       // (n,)
  const float* R0;       // (3, 3)
  const float* u;        // (k, h, m) plans
  const float* A;        // (n, n)
  const float* B;        // (n, m)
  const float* gain;     // (m, n), LQR's K
  const float* scale;    // (3,), the roll model's angle_scale
  const float* shift;    // (3,), its angle_shift
  float* xs;             // (k, h + 1, n)
  float* Rs;             // (k, h + 1, 3, 3)
  float* u_eff;          // (k, h, m)
  int h, n, m;
  float dt;
  int rk4;
  int policy;            // kPass, kBarrier or kLqr
  int rpw[3];            // the roll model's angle rows
  float neg_weight, b_lo, b_hi;  // BarrierPush's
};

// out[j] = v of lane j for j < n (0 past n): every lane gets the vector
template <int NMAX>
__device__ __forceinline__ void gather(float v, int n, float out[NMAX]) {
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    const float vj = __shfl_sync(kFull, v, j);
    out[j] = j < n ? vj : 0.0f;
  }
}

// p[I] + ... + p[I + L - 1] as a pairwise tree: log2(L) adds deep
template <int I, int L>
__device__ __forceinline__ float tree_sum(const float* p) {
  if constexpr (L == 1) {
    return p[I];
  } else {
    return add_rn(tree_sum<I, L / 2>(p), tree_sum<I + L / 2, L - L / 2>(p));
  }
}

// sum_j row[j] * v[j] over the zero-padded rows, as a tree: the same sum
// as any order wherever a row has one nonzero product
template <int NMAX>
__device__ __forceinline__ float dot(const float row[NMAX], const float v[NMAX]) {
  float prod[NMAX];
#pragma unroll
  for (int j = 0; j < NMAX; ++j) prod[j] = mul_rn(row[j], v[j]);
  return tree_sum<0, NMAX>(prod);
}

// The roll model's second warp: R <- exp(hat(w dt)) @ R from the angle rows'
// velocities w that warp 0 publishes each step, and the angle rows' new
// values, the wrapped XYZ Euler angles of the new R in planner
// coordinates, which it publishes back. Every lane computes the 3x3
// algebra; lanes write R and the angle rows.
__device__ __noinline__ void rotation_warp(const RolloutArgs& p, float* s_w, float* s_ang) {
  const int n = p.n, m = p.m, h = p.h;
  const int lane = threadIdx.x % kWarp;
  const int plan = blockIdx.x;
  float* xs = p.xs + (size_t)plan * (h + 1) * n;
  float* Rs = p.Rs + (size_t)plan * (h + 1) * 9;
  float R[9], sc[3], sh[3], w[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) R[i] = p.R0[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    sc[i] = p.scale[i];
    sh[i] = p.shift[i];
    w[i] = p.x0[p.rpw[i] + m];
  }
  if (lane < 9) Rs[lane] = entry(R, lane);
  __syncthreads();  // the plan is staged
  for (int t = 0; t < h; ++t) {
    if (t > 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i) w[i] = s_w[(t & 1) * 3 + i];
    }
    // Rodrigues: exp(hat(k theta)) = I + sin(theta) K + (1 - cos(theta)) K K
    float wd[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) wd[i] = mul_rn(w[i], p.dt);
    float theta = sqrtf(add_rn(add_rn(mul_rn(wd[0], wd[0]), mul_rn(wd[1], wd[1])),
                               mul_rn(wd[2], wd[2])));
    theta = theta < 1e-8f ? 1e-8f : theta;
    const float k0 = div_rn(wd[0], theta), k1 = div_rn(wd[1], theta),
                k2 = div_rn(wd[2], theta);
    const float K[9] = {0.0f, -k2, k1, k2, 0.0f, -k0, -k1, k0, 0.0f};
    float KK[9], E[9], Rn[9];
    mm3(K, K, KK);
    float st, ct;
    sincosf(theta, &st, &ct);
    const float omc = sub_rn(1.0f, ct);
#pragma unroll
    for (int i = 0; i < 9; ++i)
      E[i] = add_rn(add_rn(i % 4 == 0 ? 1.0f : 0.0f, mul_rn(st, K[i])), mul_rn(omc, KK[i]));
    mm3(E, R, Rn);
    // XYZ Euler angles, roll wrapped into [0, 2pi), pitch and yaw into [-pi, pi)
    float nr = -Rn[6];
    nr = nr < -1.0f ? -1.0f : (nr > 1.0f ? 1.0f : nr);
    float ang[3];
    ang[0] = wrap_mod(atan2f(Rn[7], Rn[8]), kTwoPi);
    ang[1] = sub_rn(wrap_mod(add_rn(asinf(nr), kPi), kTwoPi), kPi);
    ang[2] = sub_rn(wrap_mod(add_rn(atan2f(Rn[3], Rn[0]), kPi), kTwoPi), kPi);
    float ai = ang[0], hi = sh[0], ci = sc[0];
    int ri = p.rpw[0];
#pragma unroll
    for (int i = 1; i < 3; ++i) {
      ai = lane == i ? ang[i] : ai;
      hi = lane == i ? sh[i] : hi;
      ci = lane == i ? sc[i] : ci;
      ri = lane == i ? p.rpw[i] : ri;
    }
    const float angle = div_rn(sub_rn(ai, hi), ci);  // lane i < 3: angle i
#pragma unroll
    for (int i = 0; i < 9; ++i) R[i] = Rn[i];
    if (lane < 3) {
      xs[(t + 1) * n + ri] = angle;
      s_ang[((t + 1) & 1) * 3 + lane] = angle;
    }
    if (lane < 9) Rs[(t + 1) * 9 + lane] = entry(R, lane);
    __syncthreads();  // the step's angles out, the next step's w in
  }
}

// One warp a plan's state, lane `row` a state row, NMAX >= n the registers
// a row takes. The lane keeps its rows of A, B (and LQR's gain) in
// registers; the plan is staged in shared memory. The roll model's block
// has a second warp for the rotation (rotation_warp), which runs beside
// this one, each step's exchange at a barrier.
template <int MODEL, int NMAX>
__global__ void __launch_bounds__(2 * kWarp) horizon_rollout_kernel(RolloutArgs p) {
  extern __shared__ float smem[];
  const int n = p.n, m = p.m, h = p.h;
  float* su = smem;              // h * m, this plan's controls
  float* s_w = su + h * m;       // 2 * 3, the angle rows' velocities, by step parity
  float* s_ang = s_w + 6;        // 2 * 3, the angle rows' new values, by step parity
  if (MODEL == kRoll && threadIdx.x >= kWarp) {
    rotation_warp(p, s_w, s_ang);
    return;
  }
  const int lane = threadIdx.x;
  const int plan = blockIdx.x;
  const int row = lane < n ? lane : n - 1;  // lanes past n mirror the last row
  const int urow = lane < m ? lane : m - 1;  // the control a lane stands for
  const float* u = p.u + (size_t)plan * h * m;
  for (int i = lane; i < h * m; i += kWarp) su[i] = u[i];
  float a_row[NMAX], b_row[NMAX], k_row[NMAX];
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    a_row[j] = j < n ? p.A[row * n + j] : 0.0f;
    b_row[j] = j < m ? p.B[row * m + j] : 0.0f;
    k_row[j] = p.policy == kLqr && j < n ? p.gain[urow * n + j] : 0.0f;
  }
  int rot = -1, vrot = -1;  // the roll model's angle (or angle velocity) this row is
  if (MODEL == kRoll) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      rot = row == p.rpw[i] ? i : rot;
      vrot = row == p.rpw[i] + m ? i : vrot;
    }
  }
  float x = p.x0[row];
  float* xs = p.xs + (size_t)plan * (h + 1) * n;
  float* ue_out = p.u_eff + (size_t)plan * h * m;
  if (lane < n) xs[lane] = x;
  if (MODEL == kRoll) {
    __syncthreads();  // the plan is staged
  } else {  // R stays R0
    float* Rs = p.Rs + (size_t)plan * (h + 1) * 9;
    for (int i = lane; i < (h + 1) * 9; i += kWarp) Rs[i] = p.R0[i % 9];
    __syncwarp();  // the plan is staged
  }

  for (int t = 0; t < h; ++t) {
    // the policy's action at the pre-step state, lane k for control k
    float uk = su[t * m + urow];
    if (p.policy == kBarrier) {
      const float vel = __shfl_sync(kFull, x, urow + m);
      const bool active = (x >= p.b_hi && vel > 0.0f) || (x <= p.b_lo && vel < 0.0f);
      uk = active ? mul_rn(p.neg_weight, vel) : uk;
    } else if (p.policy == kLqr) {
      float xv[NMAX];
      gather<NMAX>(x, n, xv);
      uk = -dot<NMAX>(k_row, xv);
    }
    if (lane < m) ue_out[t * m + lane] = uk;
    float ue[NMAX];
    gather<NMAX>(uk, m, ue);
    float bmod = 1.0f;
    if (MODEL == kSpeed) {  // the |vel| rows of B follow the velocity's sign, +1 at 0
      const float v = __shfl_sync(kFull, x, row >= 2 * m ? row - m : 0);
      if (row >= 2 * m) bmod = v < 0.0f ? -1.0f : 1.0f;
    }
    // Bmod u_eff, frozen over the step's stages
    float bprod[NMAX];
#pragma unroll
    for (int k = 0; k < NMAX; ++k) bprod[k] = mul_rn(mul_rn(bmod, b_row[k]), ue[k]);
    const float bu = tree_sum<0, NMAX>(bprod);

    // f(y) = A y + Bmod u_eff for this lane's row. The roll model's stock A
    // also holds the Euler-rate block B(r, p) @ R at [rpw, rpw + m]: it
    // enters only the angle rows' derivatives (every row's A is zero at
    // the angle columns), and the step overwrites those rows with the
    // rotation warp's angles, so the block never reaches a state and the
    // kernel integrates the angle rows with the base A.
    auto f = [&](float y) {
      float yv[NMAX];
      gather<NMAX>(y, n, yv);
      return add_rn(dot<NMAX>(a_row, yv), bu);
    };
    const float dt = p.dt;
    float xn;
    if (p.rk4) {
      const float k1 = mul_rn(dt, f(x));
      const float k2 = mul_rn(dt, f(add_rn(x, mul_rn(k1, 0.5f))));
      const float k3 = mul_rn(dt, f(add_rn(x, mul_rn(k2, 0.5f))));
      const float k4 = mul_rn(dt, f(add_rn(x, k3)));
      xn = add_rn(x, mul_rn(kSixth, add_rn(add_rn(add_rn(k1, mul_rn(2.0f, k2)),
                                                    mul_rn(2.0f, k3)), k4)));
    } else {
      xn = add_rn(x, mul_rn(f(x), dt));
    }
    if (MODEL == kSpeed) {
      const float v = __shfl_sync(kFull, xn, row >= 2 * m ? row - m : 0);
      if (row >= 2 * m) xn = fabsf(v);
    }
    x = xn;
    if (MODEL == kRoll) {  // w out, the wrapped angles in
      if (lane < n && vrot >= 0) s_w[((t + 1) & 1) * 3 + vrot] = x;
      if (lane < n && rot < 0) xs[(t + 1) * n + lane] = x;
      __syncthreads();
      if (rot >= 0) x = s_ang[((t + 1) & 1) * 3 + rot];
    } else if (lane < n) {
      xs[(t + 1) * n + lane] = x;
    }
  }
}

// rho' = drive[t] - jac[t]^T rho, integrated with RK4 at step ndt (< 0)
// from rho = 0 over t = h - 1 down to 0; rhos[t] is rho after step t. The
// block stages jac and drive in shared memory, then warp 0 sweeps, lane
// `row` a costate row, its column of jac[t] read into registers a step.
template <int NMAX>
__global__ void __launch_bounds__(kSweepThreads)
    costate_sweep_kernel(const float* __restrict__ drive, const float* __restrict__ jac,
                         float* __restrict__ rhos, int h, int n, float ndt) {
  extern __shared__ float smem[];
  float* sJ = smem;            // h * n * n
  float* sd = sJ + h * n * n;  // h * n
#pragma unroll 4
  for (int i = threadIdx.x; i < h * n * n; i += kSweepThreads) sJ[i] = jac[i];
  for (int i = threadIdx.x; i < h * n; i += kSweepThreads) sd[i] = drive[i];
  __syncthreads();
  if (threadIdx.x >= kWarp) return;
  const int lane = threadIdx.x;
  const int row = lane < n ? lane : n - 1;
  float rho = 0.0f;
  for (int t = h - 1; t >= 0; --t) {
    float col[NMAX];  // (jac^T r)_row = sum_j jac[j][row] r_j
#pragma unroll
    for (int j = 0; j < NMAX; ++j) col[j] = j < n ? sJ[(t * n + j) * n + row] : 0.0f;
    const float d = sd[t * n + row];
    auto f = [&](float r) {
      float rv[NMAX];
      gather<NMAX>(r, n, rv);
      return sub_rn(d, dot<NMAX>(col, rv));
    };
    const float k1 = mul_rn(ndt, f(rho));
    const float k2 = mul_rn(ndt, f(add_rn(rho, mul_rn(k1, 0.5f))));
    const float k3 = mul_rn(ndt, f(add_rn(rho, mul_rn(k2, 0.5f))));
    const float k4 = mul_rn(ndt, f(add_rn(rho, k3)));
    rho = add_rn(rho, mul_rn(kSixth, add_rn(add_rn(add_rn(k1, mul_rn(2.0f, k2)),
                                                   mul_rn(2.0f, k3)), k4)));
    if (lane < n) rhos[t * n + lane] = rho;
  }
}

// the registers a row takes: the least of 8, 12, 16 and 32 that holds n
template <class F>
cudaError_t with_nmax(int n, F&& launch) {
  if (n <= 8) return launch(std::integral_constant<int, 8>());
  if (n <= 12) return launch(std::integral_constant<int, 12>());
  if (n <= 16) return launch(std::integral_constant<int, 16>());
  return launch(std::integral_constant<int, 32>());
}

template <int MODEL>
cudaError_t launch_rollout(const RolloutArgs& p, int k, cudaStream_t stream) {
  return with_nmax(p.n, [&](auto nmax) {
    horizon_rollout_kernel<MODEL, decltype(nmax)::value>
        <<<k, MODEL == kRoll ? 2 * kWarp : kWarp, sizeof(float) * (p.h * p.m + kExchange),
           stream>>>(p);
    return cudaGetLastError();
  });
}

}  // namespace

// Plain C entry points, loaded with ctypes. Pointers are device pointers to
// contiguous f32 arrays. Each launches on `stream`, does not synchronise,
// and returns the launch's cudaError_t (0 on success), or 1
// (cudaErrorInvalidValue) for arguments outside the limits named.

// The rollout of k plans u (k, h, m) from (x0 (n,), R0 (3, 3)): xs (k, h + 1,
// n) the states x_0..x_h, Rs (k, h + 1, 3, 3) the rotations, u_eff (k, h, m)
// the policy's action at each step. `model`: 0 constant A (n, n) and B (n,
// m); 1 the speed model (n = 3m, B's rows past 2m scaled by the velocity's
// sign, those states set to |vel| after each step); 2 the roll model (rows
// rpw0..2 < m the angles, their A rows the Euler-rate block at columns rpw +
// m, angle_scale and angle_shift (3,)). `policy`: 0 the control as given;
// 1 BarrierPush (weight, b_lo, b_hi); 2 LQR, u = -gain (m, n) x. `rk4` 1
// for RK4, 0 for an Euler step. Needs 1 <= m <= n <= 32, h >= 1, k >= 1,
// and a plan (h, m) within 48 KB.
extern "C" int horizon_rollout_f32(int model, int policy, const float* x0, const float* R0,
                                   const float* u, const float* A, const float* B,
                                   const float* gain, const float* angle_scale,
                                   const float* angle_shift, float* xs, float* Rs,
                                   float* u_eff, int k, int h, int n, int m, float dt,
                                   int rk4, int rpw0, int rpw1, int rpw2, float weight,
                                   float b_lo, float b_hi, void* stream) {
  if (k < 1 || h < 1 || m < 1 || m > n || n > kWarp || policy < kPass || policy > kLqr ||
      sizeof(float) * ((size_t)h * m + kExchange) > kMaxSmemBytes || !x0 || !R0 || !u || !A || !B ||
      !xs || !Rs || !u_eff || (policy == kLqr && !gain))
    return cudaErrorInvalidValue;
  if (model == kSpeed && n != 3 * m) return cudaErrorInvalidValue;
  if (model == kRoll) {
    const int rpw[3] = {rpw0, rpw1, rpw2};
    for (int r : rpw)
      if (r < 0 || r >= m || r + m >= n) return cudaErrorInvalidValue;
    if (!angle_scale || !angle_shift) return cudaErrorInvalidValue;
  }
  RolloutArgs p{x0, R0, u, A, B, gain, angle_scale, angle_shift, xs, Rs, u_eff,
                h, n, m, dt, rk4, policy, {rpw0, rpw1, rpw2}, -weight, b_lo, b_hi};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (model) {
    case kLinear: return launch_rollout<kLinear>(p, k, s);
    case kSpeed: return launch_rollout<kSpeed>(p, k, s);
    case kRoll: return launch_rollout<kRoll>(p, k, s);
    default: return cudaErrorInvalidValue;
  }
}

// The costate sweep: rho' = drive[t] - jac[t]^T rho over drive (h, n) and
// jac (h, n, n), RK4 at step -dt from rho = 0, t = h - 1 down to 0; writes
// rhos (h, n). Needs 1 <= n <= 32, h >= 1 and jac and drive within 48 KB.
extern "C" int costate_sweep_f32(const float* drive, const float* jac, float* rhos, int h,
                                 int n, float dt, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)h * n * n + (size_t)h * n);
  if (h < 1 || n < 1 || n > kWarp || smem > kMaxSmemBytes || !drive || !jac || !rhos)
    return cudaErrorInvalidValue;
  return with_nmax(n, [&](auto nmax) {
    costate_sweep_kernel<decltype(nmax)::value>
        <<<1, kSweepThreads, smem, static_cast<cudaStream_t>(stream)>>>(drive, jac, rhos, h,
                                                                        n, -dt);
    return cudaGetLastError();
  });
}
