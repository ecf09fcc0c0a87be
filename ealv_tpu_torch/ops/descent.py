"""The planner's inner-iteration kernels (``csrc/descent.cu``): the slot
and its candidate windows, the window search's acceptance, the step's
acceptance, and the cost of a plan or of candidate plans, one launch each
on CUDA float32 tensors.

These wrappers take plain tensors and ints. The planner reaches them
through ``control/descent.py``, which runs the plain torch versions on CPU
tensors. A wrapper checks its inputs (dtype, contiguity, one device, the
kernel's sizes) and raises on anything else; ``check_slot``,
``check_window``, ``check_accept`` and ``check_cost`` are those checks
alone. A launch
reads no value back, allocates its outputs with ``torch.empty`` and runs on
the current stream, so a captured CUDA graph replays it. Each wrapper's
``launches`` counts its kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import cuda_build

_SOURCE = "descent.cu"
MAX_HORIZON = 1024  # kMaxHorizon in csrc/descent.cu
MAX_APP_DUR = 1024  # kMaxAppDur: the search's windows
MAX_ACTIONS = 32  # kMaxActions
MAX_COST_HORIZON = 1024  # kCostMaxHorizon: the plan cost's steps
MAX_COST_SAMPLES = 4096  # kCostMaxSamples
MAX_COST_DIM = 8  # kCostMaxDim: K1's widths
MAX_BARRIER_ROWS = 64  # kCostMaxRows
MAX_CANDIDATES = 65535  # kCostMaxCandidates


class Slot(NamedTuple):
    """The slot step of an inner iteration. ``ints`` (int64): [t_app] for a
    fixed window, [t_app, lam0, tis, tfs] for the window search, whose
    windows [tis, tfs) (max_app_dur,) each are; ``u_app`` (m,) the control
    at t_app; ``step_done`` (() bool); ``plans``: the fixed window's new
    plan (H, m), or the search's candidates (max_app_dur, H, m) to cost."""

    ints: torch.Tensor
    u_app: torch.Tensor
    step_done: torch.Tensor
    plans: torch.Tensor

    @property
    def t_app(self):
        return self.ints[0]

    @property
    def lam0(self):
        return self.ints[1] if self.ints.shape[0] > 1 else None

    @property
    def tis(self):
        mad = (self.ints.shape[0] - 2) // 2
        return self.ints[2: 2 + mad] if mad > 0 else None

    @property
    def tfs(self):
        mad = (self.ints.shape[0] - 2) // 2
        return self.ints[2 + mad:] if mad > 0 else None


@functools.cache
def _library():
    lib = cuda_build.load(_SOURCE)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    slot = lib.descent_slot_f32
    slot.argtypes = [ptr] * 4 + [i32] * 4 + [i64, i32] + [ptr] * 5
    window = lib.descent_window_f32
    window.argtypes = [ptr] * 5 + [i32] * 4 + [ptr] * 4
    accept = lib.descent_accept_f32
    accept.argtypes = [ptr] * 8 + [i32] * 3 + [ptr] * 5
    cost = lib.plan_cost_f32
    cost.argtypes = [ptr, i64] + [i32] * 3 + [ptr, i32] + [ptr] * 4 + [i32] + [ptr] * 3 \
        + [i32, ptr, ptr]
    for fn in (slot, window, accept, cost):
        fn.restype = ctypes.c_int
    return slot, window, accept, cost


def _check(name: str, x, dev, shape, dtype=torch.float32) -> None:
    if x.dtype != dtype or x.device != dev:
        raise TypeError(f"{name}: need {dtype} on {dev}, got {x.dtype} on {x.device}")
    if tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {tuple(shape)}, got "
                         f"{tuple(x.shape)} with strides {x.stride()}")


def _check_sizes(h: int, m: int, idx: int, mad: int) -> None:
    if not (1 <= h <= MAX_HORIZON and 1 <= m <= MAX_ACTIONS and 0 <= idx
            and 0 <= mad <= MAX_APP_DUR):
        raise ValueError(f"the descent kernels take 1 <= H <= {MAX_HORIZON}, 1 <= m <= "
                         f"{MAX_ACTIONS}, idx >= 0 and max_app_dur <= {MAX_APP_DUR}; got "
                         f"H={h}, m={m}, idx={idx}, max_app_dur={mad}")


def _cuda_only(x, what: str) -> None:
    if x.device.type != "cuda":
        raise TypeError(f"the {what} kernel runs on CUDA tensors, got {x.device}")


def check_slot(djdlam, u, u_eff, u_star, idx: int, max_app_dur=None, lam=None) -> tuple:
    """Raise unless ``descent_slot`` takes these inputs: one of
    ``max_app_dur`` (the window search) and ``lam`` (a fixed window).
    Returns (H, m)."""
    if (max_app_dur is None) == (lam is None):
        raise ValueError("give the window search's max_app_dur or a fixed window's lam")
    dev = djdlam.device
    h = djdlam.shape[0] if djdlam.dim() == 1 else -1
    m = u_star.shape[-1] if u_star.dim() == 2 else -1
    _check("djdlam", djdlam, dev, (h,))
    for name, x in (("u", u), ("u_eff", u_eff), ("u_star", u_star)):
        _check(name, x, dev, (h, m))
    _check_sizes(h, m, idx, 0 if max_app_dur is None else max_app_dur)
    if max_app_dur is not None and max_app_dur < 1:
        raise ValueError(f"the window search needs max_app_dur >= 1, got {max_app_dur}")
    return h, m


def descent_slot(djdlam, u, u_eff, u_star, idx: int, max_app_dur=None, lam=None) -> Slot:
    """The slot t_app = argmin(djdlam) (H,), its control u_app = u_star[t_app]
    and step_done = not djdlam[t_app] < 0; with ``lam`` the plan u_eff with
    u_app over [t_app, t_app + lam), with ``max_app_dur`` the search's first
    window size lam0, its windows and their candidate plans (u with u_app
    over each window). One launch; CUDA float32 tensors only, or it raises."""
    h, m = check_slot(djdlam, u, u_eff, u_star, idx, max_app_dur, lam)
    _cuda_only(djdlam, "descent slot")
    dev, fixed = djdlam.device, lam is not None
    mad = 0 if fixed else max_app_dur
    ints = torch.empty(1 if fixed else 2 + 2 * mad, device=dev, dtype=torch.int64)
    step_done = torch.empty((), device=dev, dtype=torch.bool)
    u_app = torch.empty(m, device=dev, dtype=torch.float32)
    plans = torch.empty((h, m) if fixed else (mad, h, m), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library()[0](djdlam.data_ptr(), u.data_ptr(), u_eff.data_ptr(),
                            u_star.data_ptr(), h, m, idx, mad, int(lam or 0), int(fixed),
                            ints.data_ptr(), step_done.data_ptr(), u_app.data_ptr(),
                            plans.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"descent slot kernel launch failed: cudaError {err}")
    descent_slot.launches += 1
    return Slot(ints, u_app, step_done, plans)


def check_window(Js, J0, slot: Slot, u_eff, idx: int) -> tuple:
    """Raise unless ``descent_window`` takes these inputs; returns (H, m,
    max_app_dur)."""
    dev = Js.device
    mad = Js.shape[0] if Js.dim() == 1 else -1
    h, m = u_eff.shape if u_eff.dim() == 2 else (-1, -1)
    _check("Js", Js, dev, (mad,))
    _check("J0", J0, dev, ())
    _check("u_eff", u_eff, dev, (h, m))
    _check("u_app", slot.u_app, dev, (m,))
    _check("the slot's ints", slot.ints, dev, (2 + 2 * mad,), torch.int64)
    _check_sizes(h, m, idx, mad)
    if mad < 1:
        raise ValueError("the window search needs max_app_dur >= 1 costs")
    return h, m, mad


def descent_window(Js, J0, slot: Slot, u_eff, idx: int):
    """The window search's acceptance over the candidates' costs ``Js``
    (max_app_dur,) against the last cost ``J0`` (), on the windows of
    ``slot`` (a ``descent_slot`` launch's); returns (ti, tf, ok, u_new):
    the window taken, whether the search succeeded, and u_eff (H, m) with
    u_app over [ti, tf) if it did. One launch; CUDA float32 tensors only,
    or it raises."""
    h, m, mad = check_window(Js, J0, slot, u_eff, idx)
    _cuda_only(Js, "descent window")
    dev = Js.device
    win = torch.empty(2, device=dev, dtype=torch.int64)
    ok = torch.empty((), device=dev, dtype=torch.bool)
    u_new = torch.empty((h, m), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library()[1](Js.data_ptr(), J0.data_ptr(), slot.ints.data_ptr(),
                            slot.u_app.data_ptr(), u_eff.data_ptr(), h, m, idx, mad,
                            win.data_ptr(), ok.data_ptr(), u_new.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"descent window kernel launch failed: cudaError {err}")
    descent_window.launches += 1
    return win[0], win[1], ok, u_new


def check_accept(u_new, cost, q, step_done, u, last_cost, q_keep, done) -> tuple:
    """Raise unless ``descent_accept`` takes these inputs; returns (H, m, N)."""
    dev = u.device
    h, m = u.shape if u.dim() == 2 else (-1, -1)
    n = q.shape[0] if q.dim() == 1 else -1
    for name, x in (("u_new", u_new), ("u", u)):
        _check(name, x, dev, (h, m))
    for name, x in (("q", q), ("q_keep", q_keep)):
        _check(name, x, dev, (n,))
    for name, x in (("cost", cost), ("last_cost", last_cost)):
        _check(name, x, dev, ())
    _check("done", done, dev, (), torch.bool)
    if step_done is not None:
        _check("step_done", step_done, dev, (), torch.bool)
    if h < 1 or m < 1 or n < 1 or max(h * m, n) >= 2**31:
        raise ValueError(f"the accept kernel takes a plan and a footprint of 1 to 2^31 - 1 "
                         f"floats; got ({h}, {m}) and {n}")
    return h, m, n


def descent_accept(u_new, cost, q, step_done, u, last_cost, q_keep, done, check_cost: bool):
    """The step's acceptance: the new plan ``u_new`` (H, m) at ``cost`` ()
    with its footprint ``q`` (N,) is taken unless the loop is ``done``, the
    slot stopped it (``step_done``, () bool or None) or, with
    ``check_cost``, the cost did not fall below ``last_cost``. Returns (u,
    last_cost, q_keep, done) after the step. One launch; CUDA float32
    tensors only, or it raises."""
    h, m, n = check_accept(u_new, cost, q, step_done, u, last_cost, q_keep, done)
    _cuda_only(u, "descent accept")
    u_out, q_out = torch.empty_like(u), torch.empty_like(q_keep)
    cost_out, done_out = torch.empty_like(last_cost), torch.empty_like(done)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library()[2](u_new.data_ptr(), cost.data_ptr(), q.data_ptr(),
                            None if step_done is None else step_done.data_ptr(),
                            u.data_ptr(), last_cost.data_ptr(), q_keep.data_ptr(),
                            done.data_ptr(), h * m, n, int(check_cost), u_out.data_ptr(),
                            cost_out.data_ptr(), q_out.data_ptr(), done_out.data_ptr(),
                            stream)
    if err != 0:
        raise RuntimeError(f"descent accept kernel launch failed: cudaError {err}")
    descent_accept.launches += 1
    return u_out, cost_out, q_out, done_out


def check_cost(trajs, samples, p_n, q_base, std, explr_locs, b_lim=None, barr_weight=None,
               power=None) -> tuple:
    """Raise unless ``plan_cost`` takes these inputs: trajectories (H, n)
    or (K, H, n) whose candidates are each a row-major (H, n) block (a
    view of the rollout's post-step states is), samples (N, d), ``p_n`` and
    ``q_base`` (N,), ``std`` (d,), ``explr_locs`` d state columns as ints,
    and the box barrier's rows (b_lim (r, 2), barr_weight (r,), power
    (r,), r <= n) or none of them. Returns (K, H, n, N, d, r)."""
    dev = trajs.device
    if trajs.dtype != torch.float32:
        raise TypeError(f"trajs: need {torch.float32}, got {trajs.dtype}")
    if trajs.dim() not in (2, 3):
        raise ValueError(f"trajs: need (H, n) or (K, H, n), got {tuple(trajs.shape)}")
    k, h, n = (1, *trajs.shape) if trajs.dim() == 2 else tuple(trajs.shape)
    rows_ok = trajs.stride(-1) == 1 and (h == 1 or trajs.stride(-2) == n)
    if not rows_ok or (trajs.dim() == 3 and k > 1 and trajs.stride(0) < h * n):
        raise ValueError(f"trajs: each candidate must be a row-major ({h}, {n}) block, got "
                         f"strides {trajs.stride()}")
    n_s = samples.shape[0] if samples.dim() == 2 else -1
    d = samples.shape[1] if samples.dim() == 2 else -1
    _check("samples", samples, dev, (n_s, d))
    _check("p_n", p_n, dev, (n_s,))
    _check("q_base", q_base, dev, (n_s,))
    _check("std", std, dev, (d,))
    cols = list(explr_locs)
    if len(cols) != d or not all(isinstance(c, int) and 0 <= c < n for c in cols):
        raise ValueError(f"explr_locs: need {d} ints in [0, {n}), got {cols}")
    given = [x is not None for x in (b_lim, barr_weight, power)]
    r = 0
    if any(given):
        if not all(given):
            raise ValueError("give the barrier's b_lim, barr_weight and power, or none")
        r = b_lim.shape[0] if b_lim.dim() == 2 else -1
        _check("b_lim", b_lim, dev, (r, 2))
        _check("barr_weight", barr_weight, dev, (r,))
        _check("power", power, dev, (r,))
    if not (1 <= k <= MAX_CANDIDATES and 1 <= h <= MAX_COST_HORIZON
            and 1 <= n_s <= MAX_COST_SAMPLES and 1 <= d <= MAX_COST_DIM
            and 0 <= r <= min(n, MAX_BARRIER_ROWS)):
        raise ValueError(f"the cost kernel takes 1 <= K <= {MAX_CANDIDATES}, 1 <= H <= "
                         f"{MAX_COST_HORIZON}, 1 <= N <= {MAX_COST_SAMPLES}, 1 <= d <= "
                         f"{MAX_COST_DIM} and at most min(n, {MAX_BARRIER_ROWS}) barrier rows; "
                         f"got K={k}, H={h}, N={n_s}, d={d}, n={n}, rows={r}")
    return k, h, n, n_s, d, r


def plan_cost(trajs, samples, p_n, q_base, std, explr_locs, b_lim=None, barr_weight=None,
              power=None):
    """The planner's cost of each candidate trajectory: the KL divergence
    of the target ``p_n`` (N,) from the renormalised footprint q_base +
    sum_h psi(samples, x_h) over the columns ``explr_locs``, plus the box
    barrier summed over the steps. Trajectories (H, n) give a () cost,
    (K, H, n) a (K,) one. One launch; CUDA float32 tensors only, or it
    raises (``check_cost``)."""
    k, h, n, n_s, d, r = check_cost(trajs, samples, p_n, q_base, std, explr_locs, b_lim,
                                    barr_weight, power)
    _cuda_only(trajs, "plan cost")
    cost = torch.empty(trajs.shape[:-2], device=trajs.device, dtype=torch.float32)
    cols = (ctypes.c_int * d)(*explr_locs)
    stride = trajs.stride(0) if trajs.dim() == 3 else h * n
    ptr = lambda x: None if x is None else x.data_ptr()
    with torch.cuda.device(trajs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library()[3](trajs.data_ptr(), stride, k, h, n, cols, d, samples.data_ptr(),
                            p_n.data_ptr(), q_base.data_ptr(), std.data_ptr(), n_s,
                            ptr(b_lim), ptr(barr_weight), ptr(power), r, cost.data_ptr(),
                            stream)
    if err != 0:
        raise RuntimeError(f"plan cost kernel launch failed: cudaError {err}")
    plan_cost.launches += 1
    return cost


descent_slot.launches = 0
descent_window.launches = 0
descent_accept.launches = 0
plan_cost.launches = 0
