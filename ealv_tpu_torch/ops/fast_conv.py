"""VALID strided convs whose weight gradient follows a chosen schedule (port
of ``ealv_tpu/ops/fast_conv.py``).

Every variant's forward is ``F.conv2d`` (no padding, no bias): the same
math and parameters as the plain conv; only the backward changes. dx comes
from the transposed conv, with the floor-divided tail rows and columns of
x, which never entered a forward window, given zero gradient
(``_dx_conv_transpose`` of the JAX module); it is computed only when x
needs a gradient (the image input of the first layer does not). dW is cast
to the weight's dtype, as the JAX VJPs cast it (``.astype(w.dtype)``, bf16
at the default compute dtype). The schedules of dW:

  - ``"s2d"`` (and ``True``): space-to-depth. The (Cout, Cin, k, k)
    gradient of a stride-s conv is a gathered subset of the (Cout, s*s*Cin,
    k', k') gradient of the stride-1 conv over ``_space_to_depth(x, s)``,
    k' = ceil(k / s). The stride-1 gradient is autograd's own
    (``torch.nn.grad.conv2d_weight``, cuDNN on the card), summed in x's
    dtype as the JAX schedule sums it; the gather is a selection, so its
    index (``tap_index``) is built once per layer, off the backward;
  - ``"im2col"``: the patch matrix of x (``F.unfold``, features (Cin, k, k),
    the order of ``lax.conv_general_dilated_patches``) contracted with the
    cotangent over every (b, oh, ow) position in one product whose result
    is f32 (the operands are widened, as ``preferred_element_type=f32``
    asks);
  - ``"pallas"``: K3, ``conv_wgrad_direct`` (``ops/wgrad.py``).
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


def _space_to_depth(x, s: int, h_tgt: int, w_tgt: int):
    """(B, C, H, W) -> (B, s*s*C, h_tgt, w_tgt), channel ((ph * s + pw) * C
    + c) holding x[..., c, p * s + ph, q * s + pw]. The spatial dims are
    sliced or zero-padded to exactly h_tgt*s x w_tgt*s first: rows beyond
    the last VALID window never enter the gradient, padded rows meet a
    zero cotangent slot."""
    b, c, h, w = x.shape
    hs, ws = h_tgt * s, w_tgt * s
    x = x[:, :, :hs, :ws]
    if hs > h or ws > w:
        x = F.pad(x, (0, max(ws - w, 0), 0, max(hs - h, 0)))
    x = x.reshape(b, c, h_tgt, s, w_tgt, s).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, s * s * c, h_tgt, w_tgt)


def tap_index(k: int, s: int, cin: int, device=None):
    """The gather from the s2d gradient to the conv's: for (ci, kh, kw) in
    (Cin, k, k) order, the flat index into the s2d gradient's (s*s*Cin,
    k', k') block of tap (kh // s, kw // s) at channel ((kh % s) * s +
    kw % s) * Cin + ci. int64 (Cin * k * k,)."""
    k2 = -(-k // s)
    kh = torch.arange(k)
    ch = (((kh % s)[:, None] * s + (kh % s)[None, :]) * cin)[None] \
        + torch.arange(cin)[:, None, None]
    flat = (ch * k2 + (kh // s)[:, None]) * k2 + (kh // s)[None, :]
    return flat.reshape(-1).to(device)


def _dw_s2d(x, cot, k: int, stride: int, taps):
    """Weight gradient (Cout, Cin, k, k) of a VALID stride-``stride`` conv,
    computed in s2d layout, in x's dtype; ``taps`` is ``tap_index(k,
    stride, Cin)`` on x's device."""
    s = stride
    cin = x.shape[1]
    cout, oh, ow = cot.shape[1:]
    k2 = -(-k // s)
    x2 = _space_to_depth(x, s, oh + k2 - 1, ow + k2 - 1)
    dw2 = torch.nn.grad.conv2d_weight(x2, (cout, s * s * cin, k2, k2), cot)
    return dw2.flatten(1).index_select(1, taps).reshape(cout, cin, k, k)


def _dw_im2col(x, cot, k: int, stride: int):
    """Weight gradient (Cout, Cin, k, k) of a VALID stride-``stride`` conv
    as one product of the materialised patch matrix with the cotangent,
    f32."""
    cin, cout = x.shape[1], cot.shape[1]
    patches = F.unfold(x.float(), k, stride=stride)  # (B, Cin*k*k, OH*OW)
    dw = torch.tensordot(cot.float().flatten(2), patches, dims=([0, 2], [0, 2]))
    return dw.reshape(cout, cin, k, k)


class _ConvValid(torch.autograd.Function):
    """VALID conv; dW by ``schedule`` ("s2d", "im2col" or "pallas")."""

    @staticmethod
    def forward(ctx, x, w, stride: int, schedule: str, taps):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.schedule, ctx.taps = stride, schedule, taps
        return F.conv2d(x, w, stride=stride)

    @staticmethod
    def backward(ctx, cot):
        x, w = ctx.saved_tensors
        s, k = ctx.stride, w.shape[-1]
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _dx_conv_transpose(cot, w, x.shape, s).to(x.dtype)
        if ctx.needs_input_grad[1]:
            if ctx.schedule == "s2d":
                taps = ctx.taps if ctx.taps is not None else tap_index(k, s, x.shape[1],
                                                                       x.device)
                dw = _dw_s2d(x, cot, k, s, taps)
            elif ctx.schedule == "im2col":
                dw = _dw_im2col(x, cot, k, s)
            else:
                dw = conv_wgrad_direct(x, cot, k, s)
            dw = dw.to(w.dtype)
        return dx, dw, None, None, None


def conv2d_valid(x, w, stride: int, taps=None):
    """y = VALID stride-``stride`` conv of x (B, Cin, H, W) with w (Cout,
    Cin, k, k), no bias; dW in space-to-depth layout. Pass ``taps``
    (``tap_index``, on x's device) from outside a CUDA graph capture: built
    here, it is built at every backward."""
    return _ConvValid.apply(x, w, stride, "s2d", taps)


def conv2d_valid_im2col(x, w, stride: int, taps=None):
    """The same forward; dW = patches(x)^T @ cot in f32."""
    return _ConvValid.apply(x, w, stride, "im2col", None)


def conv2d_valid_direct(x, w, stride: int, taps=None):
    """The same forward; dW is K3's."""
    return _ConvValid.apply(x, w, stride, "pallas", None)


CONV_VARIANTS = {
    True: conv2d_valid,  # bool back-compat: the s2d form
    "s2d": conv2d_valid,
    "im2col": conv2d_valid_im2col,
    "pallas": conv2d_valid_direct,
}
