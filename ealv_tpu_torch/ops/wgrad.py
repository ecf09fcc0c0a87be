"""K3: the direct weight gradient of a VALID strided conv.

``conv_wgrad_direct`` is the port of the Pallas TPU kernel
``ealv_tpu/ops/pallas_wgrad.py::conv_wgrad_direct``. On CUDA tensors (f32 or
bf16) it launches the hand-written kernel ``csrc/wgrad.cu`` (built at first
use, see ``cuda_build``); on CPU tensors it computes the same thing with
``conv_wgrad_reference``; anything else raises. There is no fallback from
the kernel to the plain version.

Layouts are torch's: x (B, Cin, H, W), cot (B, Cout, OH, OW) and dW
(Cout, Cin, k, k) in f32 (the JAX function takes NHWC and returns HWIO).
The kernel reads both inputs through their strides, so a channels-last view
such as the CVAE's permuted image batch is read in place, without a copy.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

_SOURCE = "wgrad.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (b, oh, ow) positions a pass-1 block reduces at least; small planes take
# several images per block so that every block has work for its 256 threads
_POSITIONS_PER_BLOCK = 2048


def conv_wgrad_reference(x, cot, k: int, stride: int):
    """Plain torch K3: autograd's conv weight gradient on f32 copies of the
    inputs. The test oracle of the kernel and the path for CPU tensors."""
    return torch.nn.grad.conv2d_weight(
        x.float(), (cot.shape[1], x.shape[1], k, k), cot.float(), stride=stride)


def _library():
    fn = cuda_build.load(_SOURCE).conv_wgrad_direct
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                                           ctypes.POINTER(ctypes.c_int64),
                                           ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x, cot, k, stride):
    if x.dtype not in _DTYPES or cot.dtype != x.dtype or cot.device != x.device:
        raise TypeError(f"the wgrad kernel takes x and cot of one dtype (float32 "
                        f"or bfloat16) on one device, got {x.dtype} on {x.device} "
                        f"and {cot.dtype} on {cot.device}")
    fn = _library()
    B, cin, _, _ = x.shape
    _, cout, oh, ow = cot.shape
    nb_chunk = max(1, -(-_POSITIONS_PER_BLOCK // (oh * ow)))
    n_chunks = -(-B // nb_chunk)
    ws = torch.empty(n_chunks * cout * cin * k * k, device=x.device, dtype=torch.float32)
    dw = torch.empty((cout, cin, k, k), device=x.device, dtype=torch.float32)
    dims = (ctypes.c_int * 8)(B, cin, cout, oh, ow, k, stride, nb_chunk)
    xs = (ctypes.c_int64 * 4)(*x.stride())
    cs = (ctypes.c_int64 * 4)(*cot.stride())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), cot.data_ptr(), ws.data_ptr(), dw.data_ptr(),
                 _DTYPES[x.dtype], dims, xs, cs, stream)
    if err != 0:
        raise RuntimeError(f"wgrad kernel launch failed: cudaError {err}")
    conv_wgrad_direct.launches += 1
    return dw


def conv_wgrad_direct(x, cot, k: int, stride: int):
    """Weight gradient of a VALID stride-``stride`` k x k conv: x (B, Cin,
    H, W) and cot (B, Cout, OH, OW) -> dW (Cout, Cin, k, k) float32.

    CUDA tensors go to the kernel at every size; CPU tensors to the plain
    version. ``conv_wgrad_direct.launches`` counts kernel calls (each runs
    the two passes of ``csrc/wgrad.cu``)."""
    if x.dim() != 4 or cot.dim() != 4 or x.shape[0] != cot.shape[0]:
        raise ValueError(f"need x (B, Cin, H, W) and cot (B, Cout, OH, OW), got "
                         f"{tuple(x.shape)} and {tuple(cot.shape)}")
    want = tuple((n - k) // stride + 1 for n in x.shape[2:])
    if k < 1 or stride < 1 or tuple(cot.shape[2:]) != want or min(want) < 1:
        raise ValueError(f"cot {tuple(cot.shape)} is not the output of a VALID "
                         f"k={k} stride={stride} conv of x {tuple(x.shape)}")
    if x.device.type == "cuda":
        return _launch(x, cot, k, stride)
    if x.device.type == "cpu":
        return conv_wgrad_reference(x, cot, k, stride)
    raise TypeError(f"no wgrad path for device {x.device}")


conv_wgrad_direct.launches = 0
