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
``c2 = 1 - b2^t`` computed in f32 on the host from the int step count
``t``, so a step reads no device value and never waits on the device.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_build

_SOURCE = "adam.cu"
ADAM_MAX_TENSORS = 48  # tensors per launch, kMaxTensors in csrc/adam.cu


def bias_corrections(count: int, b1: float, b2: float):
    """(1 - b1^t, 1 - b2^t) in f32 for the post-increment step ``count``,
    as ``pallas_adam.py`` computes them."""
    t = np.float32(count)
    one = np.float32(1.0)
    return float(one - np.float32(b1) ** t), float(one - np.float32(b2) ** t)


def adam_update_reference(p, m, v, g, lr, count: int, b1: float = 0.9,
                          b2: float = 0.999, eps: float = 1e-8):
    """Plain torch K2 on one tensor, in place, in the JAX kernel's order of
    operations. The test oracle of the kernel and the path for CPU
    tensors. Returns (p, m, v)."""
    c1, c2 = bias_corrections(count, b1, b2)
    m.mul_(b1).add_((1.0 - b1) * g)
    v.mul_(b2).add_((1.0 - b2) * g * g)
    p.sub_(lr * (m / c1) / (torch.sqrt(v / c2) + eps))
    return p, m, v


def _library():
    fn = cuda_build.load(_SOURCE).adam_multi_f32
    fn.argtypes = [ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64),
                   ctypes.c_int] + [ctypes.c_float] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda(params, mu, nu, grads):
    dev = params[0].device
    for i, group in enumerate(zip(params, mu, nu, grads)):
        for name, x in zip(("param", "exp_avg", "exp_avg_sq", "grad"), group):
            if x.dtype != torch.float32 or x.device != dev:
                raise TypeError(f"{name} {i}: the Adam kernel takes float32 on "
                                f"{dev}, got {x.dtype} on {x.device}")
            if not x.is_contiguous():
                raise ValueError(f"{name} {i}: the Adam kernel takes contiguous "
                                 f"tensors, got strides {x.stride()}")
            if x.numel() != group[0].numel():
                raise ValueError(f"{name} {i}: {x.numel()} elements, the "
                                 f"parameter has {group[0].numel()}")


def _launch(params, mu, nu, grads, lr, count, b1, b2, eps):
    _check_cuda(params, mu, nu, grads)
    fn = _library()
    c1, c2 = bias_corrections(count, b1, b2)
    live = [i for i, p in enumerate(params) if p.numel() > 0]
    with torch.cuda.device(params[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        for lo in range(0, len(live), ADAM_MAX_TENSORS):
            part = live[lo: lo + ADAM_MAX_TENSORS]
            ptrs = (ctypes.c_uint64 * (4 * len(part)))(*[
                t[i].data_ptr() for i in part for t in (params, mu, nu, grads)])
            sizes = (ctypes.c_int64 * len(part))(*[params[i].numel() for i in part])
            err = fn(ptrs, sizes, len(part), lr, c1, c2, b1, b2, 1.0 - b1,
                     1.0 - b2, eps, stream)
            if err != 0:
                raise RuntimeError(f"Adam kernel launch failed: cudaError {err}")
            adam_apply.launches += 1


def adam_apply(params, mu, nu, grads, lr, count: int, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-8):
    """One Adam step over lists of tensors, in place. ``count`` is the
    post-increment step (the first update uses 1). CUDA f32 tensors go to
    the kernel, one launch per ``ADAM_MAX_TENSORS`` tensors; CPU tensors to
    the plain version. ``adam_apply.launches`` counts kernel launches."""
    if not params:
        return
    devices = {x.device.type for t in (params, mu, nu, grads) for x in t}
    if devices == {"cuda"}:
        _launch(params, mu, nu, grads, float(lr), int(count), b1, b2, eps)
    elif devices == {"cpu"}:
        for p, m, v, g in zip(params, mu, nu, grads):
            adam_update_reference(p, m, v, g, lr, count, b1, b2, eps)
    else:
        raise TypeError(f"no Adam path for tensors on {sorted(devices)}")


adam_apply.launches = 0


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

    The step count is a host int in each param group (``group["step"]``),
    one for the whole group as in the JAX optimizer state; the moments are
    ``exp_avg``/``exp_avg_sq`` per parameter, so ``state_dict`` and
    ``load_state_dict`` carry the whole optimizer state."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps, step=0))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError("FusedAdam takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                if not self.state[p]:
                    mu, nu = adam_init([p])
                    self.state[p]["exp_avg"], self.state[p]["exp_avg_sq"] = mu[0], nu[0]
            group["step"] += 1
            b1, b2 = group["betas"]
            adam_apply(params, [self.state[p]["exp_avg"] for p in params],
                       [self.state[p]["exp_avg_sq"] for p in params],
                       [p.grad for p in params], group["lr"], group["step"],
                       b1, b2, group["eps"])
