"""K1: the fused Gaussian footprint and spread reduction.

``footprint_and_spread`` is the port of the Pallas TPU kernel
``ealv_tpu/ops/pallas_kernels.py::footprint_and_spread``. On a CUDA f32
tensor it launches the hand-written kernel ``csrc/footprint.cu`` (built at
first use, see ``cuda_build``); on a CPU tensor it computes the same thing
with ``footprint_and_spread_reference``; anything else raises. There is no
fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

_SOURCE = "footprint.cu"


def footprint_and_spread_reference(samples, traj, std, traj_mask):
    """Plain torch K1: whiten both sides by rsqrt(|std|), then
    (sum_t m_t psi, max_t m_t psi) with psi = exp(-0.5 |s_n - x_t|^2) from
    direct per-dimension differences in f32. The test oracle of the kernel
    and the path for CPU tensors."""
    w = torch.rsqrt(std.abs())
    sw = samples * w
    tw = traj * w
    sq = ((sw[:, None, :] - tw[None, :, :]) ** 2).sum(-1)
    psi = torch.exp(-0.5 * sq) * traj_mask[None, :]
    return psi.sum(1), psi.amax(1)


def _library():
    lib = cuda_build.load(_SOURCE)
    fn = lib.footprint_and_spread_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(samples, traj, std, traj_mask):
    n, d = samples.shape
    t = traj.shape[0]
    for name, x, shape in (("samples", samples, (n, d)), ("traj", traj, (t, d)),
                           ("std", std, (d,)), ("traj_mask", traj_mask, (t,))):
        if x.dtype != torch.float32 or x.device != samples.device:
            raise TypeError(f"{name}: need float32 on {samples.device}, got "
                            f"{x.dtype} on {x.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {shape}, got "
                             f"{tuple(x.shape)}")
    if not 1 <= d <= 8 or n == 0 or t == 0:
        raise ValueError(f"footprint kernel takes 1 <= d <= 8 and n, t > 0; "
                         f"got n={n}, t={t}, d={d}")
    fn = _library()
    out_sum = torch.empty(n, device=samples.device, dtype=torch.float32)
    out_max = torch.empty(n, device=samples.device, dtype=torch.float32)
    with torch.cuda.device(samples.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(samples.data_ptr(), traj.data_ptr(), std.data_ptr(),
                 traj_mask.data_ptr(), out_sum.data_ptr(), out_max.data_ptr(),
                 n, t, d, stream)
    if err != 0:
        raise RuntimeError(f"footprint kernel launch failed: cudaError {err}")
    footprint_and_spread.launches += 1
    return out_sum, out_max


def footprint_and_spread(samples, traj, std, traj_mask):
    """Fused (sum_t psi, max_t psi) over the trajectory.

    samples (N, d), traj (T, d), std (d,), traj_mask (T,) in {0, 1}.
    Returns (footprint (N,), spread (N,)) in float32. CUDA float32 tensors
    go to the kernel at every size; CPU tensors to the plain version.
    ``footprint_and_spread.launches`` counts kernel launches.
    """
    if samples.device.type == "cuda":
        if samples.dtype != torch.float32:
            raise TypeError(f"footprint kernel takes float32, got {samples.dtype}")
        return _launch(samples, traj, std, traj_mask)
    if samples.device.type == "cpu":
        return footprint_and_spread_reference(samples, traj, std, traj_mask)
    raise TypeError(f"no footprint path for device {samples.device}")


footprint_and_spread.launches = 0
