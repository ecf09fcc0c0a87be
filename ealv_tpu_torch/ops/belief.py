"""The belief fusion kernel (``csrc/belief.cu``): a list of belief grids,
each with its pushes of new measurements, pushed and fused in three
launches on CUDA float32 tensors (``FingerprintBelief.push`` then
``update_prior``, ``fingerprint/belief.py``, which keeps the plain version
for CPU tensors).

A belief here is any object with the tensors ``grid`` (G, d), ``prior``
and ``prior_var`` (G,), ``meas_loc`` (cap, d), ``meas_val`` (cap,),
``meas_n`` and ``count`` (() int64) and the floats ``thresh``, ``clip`` and
``scale``; its pushes are (rows (P, d), values (P,)) or None, views that
need not be contiguous but for each row's own floats. ``check_fusion``
raises on anything the kernel does not take (a dtype, a device, a shape,
a width past ``MAX_D``, a ring past ``MAX_CAP``, beliefs of more than one
size); ``fuse_beliefs`` raises besides on CPU tensors. A call launches once
for each ``MAX_BELIEFS`` beliefs, and allocates its outputs and
scratch with ``torch.empty``, reads no value back and launches on the
current stream, so a captured CUDA graph replays it; ``fuse_beliefs.launches``
counts the calls of the C entry, three kernels each.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import cuda_build

_SOURCE = "belief.cu"
MAX_D = 6  # kMaxD in csrc/belief.cu
MAX_CAP = 256  # kMaxCap: a ring's slots
MAX_BELIEFS = 16  # kMaxBeliefs: the beliefs of one launch
_INPUTS = ("grid", "prior", "prior_var", "meas_loc", "meas_val", "meas_n", "count")
_OUTPUTS = ("prior", "prior_var", "meas_loc", "meas_val", "meas_n", "count")


@functools.cache
def _library():
    lib = cuda_build.load(_SOURCE)
    fuse = lib.fuse_beliefs_f32
    fuse.argtypes = [ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int),
                     ctypes.POINTER(ctypes.c_float)] + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p] * 2
    fuse.restype = ctypes.c_int
    scratch = lib.fuse_beliefs_scratch
    scratch.argtypes = [ctypes.c_int] * 3
    scratch.restype = ctypes.c_longlong
    return fuse, scratch


def _check(name: str, x, dev, shape, dtype=torch.float32, contiguous=True) -> None:
    if x.dtype != dtype or x.device != dev:
        raise TypeError(f"{name}: need {dtype} on {dev}, got {x.dtype} on {x.device}")
    if tuple(x.shape) != tuple(shape) or (contiguous and not x.is_contiguous()):
        raise ValueError(f"{name}: need a {'contiguous ' if contiguous else ''}"
                         f"{tuple(shape)}, got {tuple(x.shape)} with strides {x.stride()}")


def check_fusion(beliefs, pushes=None) -> tuple:
    """Raise unless ``fuse_beliefs`` takes these beliefs and pushes;
    returns their (G, d, cap)."""
    pushes = [None] * len(beliefs) if pushes is None else list(pushes)
    if not beliefs or len(pushes) != len(beliefs):
        raise ValueError(f"need one push (or None) for each of at least one belief, got "
                         f"{len(beliefs)} beliefs and {len(pushes)} pushes")
    dev = beliefs[0].prior.device
    size = None
    for i, (b, push) in enumerate(zip(beliefs, pushes)):
        g, d = b.grid.shape if b.grid.dim() == 2 else (0, 0)
        cap = b.meas_loc.shape[0]
        if not (g >= 1 and 1 <= d <= MAX_D and 1 <= cap <= MAX_CAP and g * d < 2**31):
            raise ValueError(f"belief {i}: the kernel takes a (G, d) grid with 1 <= d <= "
                             f"{MAX_D} and a ring of 1 to {MAX_CAP} slots; got grid "
                             f"{tuple(b.grid.shape)}, ring {tuple(b.meas_loc.shape)}")
        _check(f"belief {i} grid", b.grid, dev, (g, d))
        _check(f"belief {i} prior", b.prior, dev, (g,))
        _check(f"belief {i} prior_var", b.prior_var, dev, (g,))
        _check(f"belief {i} meas_loc", b.meas_loc, dev, (cap, d))
        _check(f"belief {i} meas_val", b.meas_val, dev, (cap,))
        _check(f"belief {i} meas_n", b.meas_n, dev, (), torch.int64)
        _check(f"belief {i} count", b.count, dev, (), torch.int64)
        if push is not None:
            rows, vals = push
            p = rows.shape[0] if rows.dim() == 2 else -1
            _check(f"belief {i} pushed rows", rows, dev, (p, d), contiguous=False)
            _check(f"belief {i} pushed values", vals, dev, (p,), contiguous=False)
            if (d > 1 and rows.stride(1) != 1) or max(rows.stride(0), vals.stride(0)) >= 2**31:
                raise ValueError(f"belief {i}: a pushed row's floats must be adjacent, and "
                                 f"the strides below 2^31; got strides {rows.stride()}, "
                                 f"{vals.stride()}")
        if size not in (None, (g, d, cap)):
            raise ValueError(f"belief {i}: one call takes beliefs of one (G, d, cap), got "
                             f"{(g, d, cap)} after {size}")
        size = (g, d, cap)
    return size


def _scalars(b) -> list:
    """thresh, 1/thresh, 1/(clip - thresh), 1/std, scale - 50 scale and 50
    scale in f32, as torch rounds a host scalar and its reciprocal."""
    f = np.float32
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        return [f(b.thresh), f(1) / f(b.thresh), f(1) / f(b.clip - b.thresh),
                f(1) / f(max(b.scale / 2.0, 1e-6)), f(b.scale - 50.0 * b.scale),
                f(50.0 * b.scale)]


def _launch(beliefs, pushes, g, d, cap) -> list:
    """One launch of at most MAX_BELIEFS beliefs of one size; their new
    tensors."""
    fuse, scratch_floats = _library()
    dev = beliefs[0].prior.device
    outs, ptrs, ints, floats = [], [], [], []
    for b, push in zip(beliefs, pushes):
        out = {name: torch.empty_like(getattr(b, name)) for name in _OUTPUTS}
        rows, vals = push if push is not None else (None, None)
        n = 0 if rows is None else rows.shape[0]
        ptrs += [getattr(b, name).data_ptr() for name in _INPUTS]
        ptrs += [rows.data_ptr() if n else 0, vals.data_ptr() if n else 0]
        ptrs += [out[name].data_ptr() for name in _OUTPUTS]
        ints += [n, rows.stride(0) if n else 0, vals.stride(0) if n else 0]
        floats += _scalars(b)
        outs.append(out)
    k = len(beliefs)
    scratch = torch.empty(scratch_floats(k, g, cap), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fuse((ctypes.c_uint64 * len(ptrs))(*ptrs), (ctypes.c_int * len(ints))(*ints),
                   (ctypes.c_float * len(floats))(*floats), k, g, d, cap,
                   scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"belief fusion kernel launch failed: cudaError {err}")
    fuse_beliefs.launches += 1
    return outs


def fuse_beliefs(beliefs, pushes=None) -> list:
    """Each belief's pushes (rows (P, d) with values (P,), in order, or None)
    written into its ring, then its pending measurements fused into its
    prior and variance and the ring emptied: ``push`` then ``update_prior``.
    Returns one dict a belief of its new ``prior``, ``prior_var``,
    ``meas_loc``, ``meas_val``, ``meas_n`` and ``count``; the old tensors
    are not written. One launch for each MAX_BELIEFS beliefs, all of one
    (G, d, cap). CUDA float32 tensors only, or it raises."""
    pushes = [None] * len(beliefs) if pushes is None else list(pushes)
    size = check_fusion(beliefs, pushes)
    if beliefs[0].prior.device.type != "cuda":
        raise TypeError(f"the belief fusion kernel runs on CUDA tensors, got "
                        f"{beliefs[0].prior.device}")
    return [new for lo in range(0, len(beliefs), MAX_BELIEFS)
            for new in _launch(beliefs[lo: lo + MAX_BELIEFS], pushes[lo: lo + MAX_BELIEFS],
                               *size)]


fuse_beliefs.launches = 0
