"""K2: the fused Adam update, and ``FusedAdam``, the optimizer that runs it.

``adam_apply`` is the port of the Pallas TPU kernel
``ealv_tpu/ops/pallas_adam.py::adam_update_flat`` and its per-leaf
dispatch ``adam_apply``. On CUDA f32 tensors it launches the hand-written
multi-tensor kernel ``csrc/adam.cu`` (built at first use, see
``cuda_build``): one launch per optimizer step covers every tensor, with no
size threshold. On CPU tensors it computes the same update with
``adam_update_reference``; anything else raises. There is no fallback from
the kernel to the plain version.

The update is the JAX package's (optax's, eps_root 0):
``p - lr * (m / c1) / (sqrt(v / c2) + eps)`` with ``c1 = 1 - b1^t`` and
``c2 = 1 - b2^t`` computed in f32 from the step count ``t``. As in the JAX
package the count lives on the device (``FusedAdam`` keeps an int32 ()
tensor, as ``PallasAdamState.count`` is an int32 array): the kernel's
one-thread prologue advances it and the update reads it through a pointer,
so a step reads no value back, and a captured CUDA graph of a trainer
call advances the count and its corrections on every replay.

Host cost: the kernel's plan (``adam_plan``), the checks and the ctypes
argument arrays are built once per tensor list and kept under a key of
every tensor's size, dtype, contiguity and device and the addresses of the
params and moments. The grads' addresses are not in the key: the trainer's
``zero_grad(set_to_none=True)`` makes new grads at new addresses on every
step, so they are read on every call and written into the cached pointer
table, and a grad off a 16-byte boundary (which changes the plan) adds its
misalignment to the key. Any other change of a grad (dtype, layout,
device, size) misses the cache and is checked again before a launch.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import operator

import numpy as np
import torch

from . import cuda_build

_SOURCE = "adam.cu"
ADAM_MAX_TENSORS = 48  # tensors per launch, kMaxTensors in csrc/adam.cu
THREADS = 256          # threads per block, kThreads
VECS = 4               # float4 of each array per thread, kVecs
CHUNK = THREADS * VECS * 4  # elements per block, kChunk
_PLAN_CACHE = 16       # tensor lists whose launch arguments are kept

_PTR = torch.Tensor.data_ptr
_FIELDS = (torch.Tensor.numel, operator.attrgetter("dtype"), torch.Tensor.is_contiguous,
           operator.attrgetter("device"))  # of every tensor, in the cache key


def bias_corrections(count, b1: float, b2: float):
    """(1 - b1^t, 1 - b2^t) in f32 for the post-increment step ``count``,
    as ``pallas_adam.py`` computes them: floats for an int count, () f32
    tensors on its device for a count tensor."""
    if isinstance(count, torch.Tensor):
        t = count.float()
        return tuple(1.0 - torch.full_like(t, b) ** t for b in (b1, b2))
    t = np.float32(count)
    one = np.float32(1.0)
    return float(one - np.float32(b1) ** t), float(one - np.float32(b2) ** t)


def adam_update_reference(p, m, v, g, lr, count, b1: float = 0.9,
                          b2: float = 0.999, eps: float = 1e-8):
    """Plain torch K2 on one tensor, in place, in the JAX kernel's order of
    operations, at the post-increment step ``count`` (an int, or a ()
    integer tensor that is read, not advanced). The test oracle of the
    kernel and the path for CPU tensors. Returns (p, m, v)."""
    c1, c2 = bias_corrections(count, b1, b2)
    m.mul_(b1).add_((1.0 - b1) * g)
    v.mul_(b2).add_((1.0 - b2) * g * g)
    p.sub_(lr * (m / c1) / (torch.sqrt(v / c2) + eps))
    return p, m, v


@dataclasses.dataclass(frozen=True)
class AdamPlan:
    """One launch's schedule: tensor i takes blocks ``block_start[i]`` to
    ``block_start[i + 1] - 1``, one ``CHUNK`` of elements each, read as
    float4 with a scalar tail of ``size % 4`` if ``vec[i]``, else element
    by element."""

    sizes: tuple[int, ...]
    vec: tuple[bool, ...]
    block_start: tuple[int, ...]

    @property
    def blocks(self) -> int:
        return self.block_start[-1]


def adam_plan(sizes, vec) -> AdamPlan:
    """The kernel's plan for tensors of ``sizes`` > 0 elements; ``vec[i]``
    says whether tensor i's four arrays all start on a 16-byte boundary."""
    starts = [0]
    for n in sizes:
        starts.append(starts[-1] + -(-n // CHUNK))
    return AdamPlan(tuple(sizes), tuple(bool(x) for x in vec), tuple(starts))


@functools.cache
def _library():
    fn = cuda_build.load(_SOURCE).adam_multi_f32
    fn.argtypes = [ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64),
                   ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int] \
        + [ctypes.c_float] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(tensors, n):
    """``tensors`` is params, exp_avg, exp_avg_sq and grads, n of each."""
    dev = tensors[0].device
    for k, x in enumerate(tensors):
        name = f"{('param', 'exp_avg', 'exp_avg_sq', 'grad')[k // n]} {k % n}"
        if x.dtype != torch.float32 or x.device != dev:
            raise TypeError(f"{name}: the Adam kernel takes float32 on {dev}, got "
                            f"{x.dtype} on {x.device}")
        if not x.is_contiguous() or x.data_ptr() % 4:
            raise ValueError(f"{name}: the Adam kernel takes contiguous, 4-byte "
                             f"aligned tensors, got strides {x.stride()}")
        if x.numel() != tensors[k % n].numel():
            raise ValueError(f"{name}: {x.numel()} elements, the parameter has "
                             f"{tensors[k % n].numel()}")
    return dev


def _build_launches(tensors, ptrs, sizes):
    """Check the tensors and build each launch's plan and ctypes arrays:
    (device, [(n_tensors, ptrs, sizes, block_start, vec, plan, part), ...])
    where ``part`` lists the launch's tensor indices."""
    n = len(sizes) // 4
    dev = _check(tensors, n)
    live = [i for i in range(n) if sizes[i] > 0]
    launches = []
    for lo in range(0, len(live), ADAM_MAX_TENSORS):
        part = live[lo: lo + ADAM_MAX_TENSORS]
        aligned = [all(ptrs[k * n + i] % 16 == 0 for k in range(4)) for i in part]
        plan = adam_plan([sizes[i] for i in part], aligned)
        launches.append((
            len(part),
            (ctypes.c_uint64 * (4 * len(part)))(*[ptrs[k * n + i] for k in range(4)
                                                  for i in part]),
            (ctypes.c_int64 * len(part))(*plan.sizes),
            (ctypes.c_int * (len(part) + 1))(*plan.block_start),
            (ctypes.c_int * len(part))(*plan.vec),
            plan, part))
    return dev, launches


_launch_cache: dict = {}


def _launches(tensors):
    """The launches for this tensor list (params, exp_avg, exp_avg_sq,
    grads), from the cache when every tensor's size, dtype, contiguity and
    device, the params' and moments' addresses and the grads' misalignment
    match a cached list's; the grads' current addresses are written into
    the pointer tables."""
    n = len(tensors) // 4
    fixed = tuple(map(_PTR, tensors[:3 * n]))
    grad_ptrs = tuple(map(_PTR, tensors[3 * n:]))
    off = tuple(p & 15 for p in grad_ptrs) if any(p & 15 for p in grad_ptrs) else None
    key = (fixed, off, *(tuple(map(f, tensors)) for f in _FIELDS))
    hit = _launch_cache.get(key)
    if hit is None:
        hit = _build_launches(tensors, fixed + grad_ptrs, key[2])
        adam_apply.builds += 1
        if len(_launch_cache) >= _PLAN_CACHE:
            _launch_cache.clear()
        _launch_cache[key] = hit
    for n_t, ptrs, *_, part in hit[1]:
        ptrs[3 * n_t:] = [grad_ptrs[i] for i in part]
    return hit


def _launch(tensors, lr, count, advance: bool, b1, b2, eps):
    dev, launches = _launches(tensors)
    if count.dtype != torch.int32 or count.device != dev or count.numel() != 1:
        raise TypeError(f"the Adam kernel takes its step count as one int32 on {dev}, "
                        f"got {count.dtype} {tuple(count.shape)} on {count.device}")
    fn = _library()
    switch = dev.index != torch.cuda.current_device()
    with torch.cuda.device(dev) if switch else contextlib.nullcontext():
        stream = torch.cuda.current_stream().cuda_stream
        for j, (n_t, ptrs, sizes, starts, vec, _, _) in enumerate(launches):
            err = fn(ptrs, sizes, starts, vec, n_t, count.data_ptr(), int(advance and j == 0),
                     lr, b1, b2, 1.0 - b1, 1.0 - b2, eps, stream)
            if err != 0:
                raise RuntimeError(f"Adam kernel launch failed: cudaError {err}")
            adam_apply.launches += 1


def adam_apply(params, mu, nu, grads, lr, count, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-8):
    """One Adam step over lists of tensors, in place. ``count`` is either
    the post-increment step as an int (the first update uses 1), as the
    JAX ``adam_update_flat`` takes it, or the steps taken so far as an
    int32 () tensor on the tensors' device, which the call advances in
    place before it reads it, as the JAX ``adam_apply`` advances
    ``PallasAdamState.count``. CUDA f32 tensors go to the kernel, one
    launch per ``ADAM_MAX_TENSORS`` non-empty tensors; CPU tensors to the
    plain version. ``adam_apply.launches`` counts kernel launches,
    ``adam_apply.builds`` the tensor lists that missed the launch cache and
    were checked and built anew."""
    if not params:
        return
    if not len(params) == len(mu) == len(nu) == len(grads):
        raise ValueError(f"{len(params)} params, {len(mu)} exp_avg, {len(nu)} "
                         f"exp_avg_sq and {len(grads)} grads")
    tensors = [*params, *mu, *nu, *grads]
    advance = isinstance(count, torch.Tensor)
    if tensors[0].is_cuda:
        if not advance:
            count = torch.full((), int(count), dtype=torch.int32, device=tensors[0].device)
        _launch(tensors, float(lr), count, advance, b1, b2, eps)
    elif all(x.device.type == "cpu" for x in tensors):
        if advance:
            count.add_(1)
        for p, m, v, g in zip(params, mu, nu, grads):
            adam_update_reference(p, m, v, g, lr, count, b1, b2, eps)
    else:
        raise TypeError(f"no Adam path for tensors on "
                        f"{sorted({str(x.device) for x in tensors})}")


adam_apply.launches = 0
adam_apply.builds = 0


def adam_update_flat(p, m, v, g, lr, count: int, b1: float = 0.9,
                     b2: float = 0.999, eps: float = 1e-8):
    """One fused Adam update on one flat f32 tensor, in place. Returns
    (p, m, v)."""
    adam_apply([p], [m], [v], [g], lr, count, b1, b2, eps)
    return p, m, v


def adam_init(params):
    """Zero first and second moments, one contiguous f32 tensor per
    parameter. Returns (mu, nu)."""
    zeros = lambda: [torch.zeros_like(p, dtype=torch.float32,
                                      memory_format=torch.contiguous_format)
                     for p in params]
    return zeros(), zeros()


class FusedAdam(torch.optim.Optimizer):
    """Adam whose ``step`` is one ``adam_apply`` per parameter group.

    The step count is an int32 () tensor on the parameters' device in each
    param group (``group["step"]``), one for the whole group as in the JAX
    optimizer state, advanced on the device by every step; the moments are
    ``exp_avg``/``exp_avg_sq`` per parameter, so ``state_dict`` and
    ``load_state_dict`` carry the whole optimizer state (a saved count
    that is a host int, as older checkpoints hold, loads too; the loaded
    count is copied into the group's own tensor). Each group's moment
    lists are looked up in ``self.state`` once and kept while the group's
    parameters with a grad stay the same tensors; ``load_state_dict`` drops
    them."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps, step=0))
        for group in self.param_groups:
            group["step"] = torch.zeros((), dtype=torch.int32,
                                        device=group["params"][0].device)
        self._moments: dict[int, tuple[list, list, list]] = {}

    def load_state_dict(self, state_dict):
        steps = [group["step"] for group in self.param_groups]
        super().load_state_dict(state_dict)
        for group, step in zip(self.param_groups, steps):
            step.copy_(torch.as_tensor(group["step"]))
            group["step"] = step
        self._moments.clear()

    def _group_moments(self, k, params):
        kept = self._moments.get(k)
        if kept is not None and len(kept[0]) == len(params) \
                and all(map(operator.is_, kept[0], params)):
            return kept[1], kept[2]
        for p in params:
            if not self.state[p]:
                mu, nu = adam_init([p])
                self.state[p]["exp_avg"], self.state[p]["exp_avg_sq"] = mu[0], nu[0]
        kept = (params, [self.state[p]["exp_avg"] for p in params],
                [self.state[p]["exp_avg_sq"] for p in params])
        self._moments[k] = kept
        return kept[1], kept[2]

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError("FusedAdam takes no closure")
        for k, group in enumerate(self.param_groups):
            params = group["params"]
            grads = [p.grad for p in params]
            if any(g is None for g in grads):
                params = [p for p, g in zip(params, grads) if g is not None]
                grads = [g for g in grads if g is not None]
                if not params:
                    continue
            mu, nu = self._group_moments(k, params)
            b1, b2 = group["betas"]
            adam_apply(params, mu, nu, grads, group["lr"], group["step"], b1, b2,
                       group["eps"])
