"""The planner's horizon kernels (``csrc/rollout.cu``): the rollout of plans
through a dynamics model and the costate's backward RK4 sweep, one launch
a call on CUDA float32 tensors.

These wrappers take plain tensors and ints. The planner reaches them
through ``control/horizon.py``, which takes each model's and policy's
arguments from the object itself (``rollout_args``) and runs the plain
per-step versions on CPU tensors. A wrapper checks its inputs (float32,
contiguous, on one device, within the kernel's sizes) and raises on
anything else; ``check_rollout`` and ``check_costate`` are those checks
alone. A launch reads no value back, allocates its outputs with
``torch.empty`` and runs on the current stream, so a captured CUDA graph
replays it. Each wrapper's ``launches`` counts its kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import cuda_build

_SOURCE = "rollout.cu"
MAX_STATES = 32  # one lane a state row, kWarp in csrc/rollout.cu
MAX_SMEM = 48 * 1024  # a staged plan, or a sweep's matrices and drive, kMaxSmemBytes
EXCHANGE = 12  # floats beside a staged plan for the roll model's two warps, kExchange
LINEAR, SPEED, ROLL = 0, 1, 2  # the kernel's models
PASS, BARRIER, LQR = 0, 1, 2  # the kernel's policies


@functools.cache
def _library():
    # a plan launches K1 and the descent kernels too: one build call, so a
    # first run waits for one nvcc
    cuda_build.build(_SOURCE, "footprint.cu", "descent.cu")
    lib = cuda_build.load(_SOURCE)
    roll = lib.horizon_rollout_f32
    roll.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 \
        + [ctypes.c_float, ctypes.c_int] + [ctypes.c_int] * 3 + [ctypes.c_float] * 3 \
        + [ctypes.c_void_p]
    roll.restype = ctypes.c_int
    sweep = lib.costate_sweep_f32
    sweep.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p]
    sweep.restype = ctypes.c_int
    return roll, sweep


def _check(name: str, x, dev, shape) -> None:
    if x.dtype != torch.float32 or x.device != dev:
        raise TypeError(f"{name}: need float32 on {dev}, got {x.dtype} on {x.device}")
    if tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {tuple(shape)}, got "
                         f"{tuple(x.shape)} with strides {x.stride()}")


def check_rollout(x0, R0, u, *, A, B, dt, use_rk4, model, policy=PASS, gain=None,
                  angle_scale=None, angle_shift=None, rpw=(0, 0, 0),
                  barrier=(0.0, 0.0, 0.0)) -> tuple:
    """Raise unless ``horizon_rollout`` takes these inputs; returns (k, h,
    n, m): the plans, the horizon, the states and the controls."""
    if model not in (LINEAR, SPEED, ROLL) or policy not in (PASS, BARRIER, LQR):
        raise ValueError(f"the rollout kernel has no model {model} or policy {policy}")
    dev = u.device
    *batch, h, m = u.shape
    n = A.shape[0]
    _check("u", u, dev, (*batch, h, m))
    _check("x0", x0, dev, (n,))
    _check("R0", R0, dev, (3, 3))
    _check("A", A, dev, (n, n))
    _check("B", B, dev, (n, m))
    k = math.prod(batch)
    if not (1 <= m <= n <= MAX_STATES) or h < 1 or k < 1 or 4 * (h * m + EXCHANGE) > MAX_SMEM:
        raise ValueError(f"the rollout kernel takes 1 <= m <= n <= {MAX_STATES}, "
                         f"h, k >= 1 and a plan of {MAX_SMEM} B; got n={n}, m={m}, "
                         f"h={h}, k={k}")
    if model == SPEED and n != 3 * m:
        raise ValueError(f"the speed model has n = 3m states: n={n}, m={m}")
    if policy == BARRIER and n < 2 * m:
        raise ValueError(f"BarrierPush needs the velocity rows: n={n} < 2m={2 * m}")
    if policy == LQR:
        _check("gain", gain, dev, (m, n))
    if model == ROLL:
        _check("angle_scale", angle_scale, dev, (3,))
        _check("angle_shift", angle_shift, dev, (3,))
        if not all(0 <= r < m and r + m < n for r in rpw):
            raise ValueError(f"the roll model's angle rows {rpw} are not among m={m}")
    return k, h, n, m


def horizon_rollout(x0, R0, u, *, A, B, dt, use_rk4, model, policy=PASS, gain=None,
                    angle_scale=None, angle_shift=None, rpw=(0, 0, 0),
                    barrier=(0.0, 0.0, 0.0)):
    """Plans ``u`` (..., H, m) rolled out from (x0 (n,), R0 (3, 3)) through
    the kernel's ``model`` (A (n, n), B (n, m), step ``dt``, RK4 or Euler;
    the roll model's ``angle_scale``, ``angle_shift`` and angle rows
    ``rpw``) under its ``policy`` (BarrierPush's ``barrier`` = (weight,
    b_lo, b_hi); LQR's ``gain`` (m, n)), one launch for all the plans.
    Returns (states (..., H + 1, n), rotations (..., H + 1, 3, 3), applied
    controls (..., H, m)). CUDA float32 tensors only, or it raises."""
    k, h, n, m = check_rollout(x0, R0, u, A=A, B=B, dt=dt, use_rk4=use_rk4, model=model,
                               policy=policy, gain=gain, angle_scale=angle_scale,
                               angle_shift=angle_shift, rpw=rpw, barrier=barrier)
    if u.device.type != "cuda":
        raise TypeError(f"the rollout kernel runs on CUDA tensors, got {u.device}")
    batch = u.shape[:-2]
    xs = torch.empty((*batch, h + 1, n), device=u.device, dtype=torch.float32)
    Rs = torch.empty((*batch, h + 1, 3, 3), device=u.device, dtype=torch.float32)
    u_eff = torch.empty((*batch, h, m), device=u.device, dtype=torch.float32)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library()[0](
            model, policy, x0.data_ptr(), R0.data_ptr(), u.data_ptr(), A.data_ptr(),
            B.data_ptr(), ptr(gain if policy == LQR else None),
            ptr(angle_scale if model == ROLL else None),
            ptr(angle_shift if model == ROLL else None), xs.data_ptr(), Rs.data_ptr(),
            u_eff.data_ptr(), k, h, n, m, dt, int(use_rk4),
            *(rpw if model == ROLL else (0, 0, 0)),
            *(barrier if policy == BARRIER else (0.0, 0.0, 0.0)), stream)
    if err != 0:
        raise RuntimeError(f"rollout kernel launch failed: cudaError {err}")
    horizon_rollout.launches += 1
    return xs, Rs, u_eff


def check_costate(drive, jac) -> tuple:
    """Raise unless ``costate_sweep`` takes these inputs; returns (h, n)."""
    h, n = drive.shape[0], drive.shape[-1]
    _check("drive", drive, drive.device, (h, n))
    _check("jac", jac, drive.device, (h, n, n))
    if not 1 <= n <= MAX_STATES or h < 1 or 4 * h * n * (n + 1) > MAX_SMEM:
        raise ValueError(f"the costate kernel takes 1 <= n <= {MAX_STATES}, h >= 1 "
                         f"and {MAX_SMEM} B staged; got h={h}, n={n}")
    return h, n


def costate_sweep(drive, jac, dt: float):
    """The costate rhos (H, n) of rho' = drive[t] - jac[t]^T rho (drive (H,
    n), jac (H, n, n)), RK4 at step -dt backwards from rho = 0, one launch.
    CUDA float32 tensors only, or it raises."""
    h, n = check_costate(drive, jac)
    if drive.device.type != "cuda":
        raise TypeError(f"the costate kernel runs on CUDA tensors, got {drive.device}")
    rhos = torch.empty((h, n), device=drive.device, dtype=torch.float32)
    with torch.cuda.device(drive.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library()[1](drive.data_ptr(), jac.data_ptr(), rhos.data_ptr(), h, n, dt,
                            stream)
    if err != 0:
        raise RuntimeError(f"costate kernel launch failed: cudaError {err}")
    costate_sweep.launches += 1
    return rhos


horizon_rollout.launches = 0
costate_sweep.launches = 0
