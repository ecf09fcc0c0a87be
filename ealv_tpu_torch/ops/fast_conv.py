"""VALID strided conv whose weight gradient comes from K3 (port of
``ealv_tpu/ops/fast_conv.py::conv2d_valid_pallas``).

The forward is ``F.conv2d`` (no padding, no bias): the same math and
parameters as the plain conv; only the backward changes. dW comes from
``conv_wgrad_direct`` and is cast to the weight's dtype, as the JAX VJP
casts it (``.astype(w.dtype)``, bf16 at the default compute dtype). dx
comes from the transposed conv, with the floor-divided tail rows and
columns of x, which never entered a forward window, given zero gradient
(``_dx_conv_transpose`` of the JAX module). dx is computed only when x
needs a gradient; the image input of the first layer does not. Only the
JAX package's ``"pallas"`` variant is ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .wgrad import conv_wgrad_direct


def _dx_conv_transpose(cot, w, x_shape, stride: int):
    """dx (B, Cin, H, W) of a VALID conv. The transposed conv covers
    (OH - 1) * s + k rows; ``output_padding`` adds the remaining H minus
    that (less than s) rows and columns at the hi edge as zeros."""
    k = w.shape[-1]
    pad = tuple(n - ((o - 1) * stride + k) for n, o in zip(x_shape[2:], cot.shape[2:]))
    return F.conv_transpose2d(cot, w, stride=stride, output_padding=pad)


class _ConvValidDirect(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride: int):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        return F.conv2d(x, w, stride=stride)

    @staticmethod
    def backward(ctx, cot):
        x, w = ctx.saved_tensors
        s = ctx.stride
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _dx_conv_transpose(cot, w, x.shape, s).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = conv_wgrad_direct(x, cot, w.shape[-1], s).to(w.dtype)
        return dx, dw, None


def conv2d_valid_direct(x, w, stride: int):
    """y = VALID stride-``stride`` conv of x (B, Cin, H, W) with w (Cout,
    Cin, k, k), no bias; its weight gradient is K3's."""
    return _ConvValidDirect.apply(x, w, stride)
