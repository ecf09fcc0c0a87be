"""K1: the fused Gaussian footprint and spread reduction.

``footprint_and_spread`` is the port of the Pallas TPU kernel
``ealv_tpu/ops/pallas_kernels.py::footprint_and_spread``. On a CUDA f32
tensor it launches the hand-written kernels of ``csrc/footprint.cu`` (built
at first use, see ``cuda_build``) with the schedule ``footprint_plan``
fixes here from the shape alone; on a CPU tensor it computes the same thing
with ``footprint_and_spread_reference``; anything else raises. There is no
fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import cuda_build

_SOURCE = "footprint.cu"
THREADS = 128        # threads per block, kThreads in csrc/footprint.cu
ROWS = 2             # sample rows per thread, kRows
MIN_BLOCKS = 2 * 132  # the grid aims at two blocks per SM
MIN_SPLIT = 64       # trajectory points a split stages at least


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


@dataclasses.dataclass(frozen=True)
class FootprintPlan:
    """The kernel's schedule for samples (n, d) and t trajectory points.
    The grid is (splits, tiles) blocks of ``THREADS``; block (k, j) takes
    trajectory points [k * split_len, min((k + 1) * split_len, t)) and the
    rows j * THREADS * ROWS + r * THREADS + thread for r < ROWS, and writes
    one partial (sum, max) per row to the workspace, which a second kernel
    combines in split order. With one split the first kernel writes the
    outputs."""

    n: int
    t: int
    splits: int     # S, trajectory splits
    split_len: int  # points per split; the last split may be shorter

    @property
    def tiles(self) -> int:
        return -(-self.n // (THREADS * ROWS))

    @property
    def ws_elems(self) -> int:
        return 2 * self.splits * self.n if self.splits > 1 else 0


@functools.lru_cache(maxsize=None)
def footprint_plan(n: int, t: int, d: int) -> FootprintPlan:
    """The plan for samples (n, d) and a trajectory of t points: as many
    splits as bring the grid to ``MIN_BLOCKS`` blocks while each split keeps
    ``MIN_SPLIT`` points (one split, no workspace, below that), cut to the
    number of non-empty splits of ceil(t / splits) points. The plan is the
    same for every d. More splits than that only add partials to combine:
    at 2000x3000x3 the 264 blocks of 91 points measured faster than more,
    shorter splits."""
    tiles = -(-n // (THREADS * ROWS))
    splits = max(1, min(-(-MIN_BLOCKS // tiles), t // MIN_SPLIT))
    split_len = -(-t // splits)
    return FootprintPlan(n, t, -(-t // split_len), split_len)


@functools.cache
def _library():
    fn = cuda_build.load(_SOURCE).footprint_and_spread_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
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
    plan = footprint_plan(n, t, d)
    fn = _library()
    out = torch.empty((2, n), device=samples.device, dtype=torch.float32)
    ws = (torch.empty(plan.ws_elems, device=samples.device, dtype=torch.float32)
          if plan.ws_elems else None)
    with torch.cuda.device(samples.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(samples.data_ptr(), traj.data_ptr(), std.data_ptr(),
                 traj_mask.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                 None if ws is None else ws.data_ptr(), n, t, d, plan.splits,
                 plan.split_len, stream)
    if err != 0:
        raise RuntimeError(f"footprint kernel launch failed: cudaError {err}")
    footprint_and_spread.launches += 1
    return out[0], out[1]


def footprint_and_spread(samples, traj, std, traj_mask):
    """Fused (sum_t psi, max_t psi) over the trajectory.

    samples (N, d), traj (T, d), std (d,), traj_mask (T,) in {0, 1}.
    Returns (footprint (N,), spread (N,)) in float32. CUDA float32 tensors
    go to the kernel at every size; CPU tensors to the plain version.
    ``footprint_and_spread.launches`` counts calls that went to the kernel,
    one per call, whether the plan runs one kernel or two (the T-split and
    its ordered combine).
    """
    if samples.device.type == "cuda":
        if samples.dtype != torch.float32:
            raise TypeError(f"footprint kernel takes float32, got {samples.dtype}")
        return _launch(samples, traj, std, traj_mask)
    if samples.device.type == "cpu":
        return footprint_and_spread_reference(samples, traj, std, traj_mask)
    raise TypeError(f"no footprint path for device {samples.device}")


footprint_and_spread.launches = 0
