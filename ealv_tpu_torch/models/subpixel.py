"""Subpixel (phase-decomposed) transposed convolution (port of
``ealv_tpu/models/subpixel.py``).

The VALID strided transposed conv ``F.conv_transpose2d(x, W, stride=s)``
computed as s*s stride-1 convolutions of the undilated input, one per
output phase. Tensors are NCHW and ``W`` is in ``ConvTranspose2d``'s layout
(Cin, Cout, k, k).

Math (1-D): y[i] = sum_m x[m] W[i - m s]. Writing i = q s + p for phase p
in [0, s): y[q s + p] = sum_t x[q - t] W_p[t] with W_p[t] = W[t s + p], a
FULL convolution of x with W_p, of length h + t_p - 1 where t_p =
ceil((k - p) / s) taps. ``F.conv2d`` cross-correlates, so each phase
kernel is flipped and padded by t_p - 1 on both sides. The JAX functions
flip the whole kernel first because flax's transposed-conv kernel is the
unflipped cross-correlation; ``utils/convert.py::params_from_jax`` already
flips it into this layout.

``subpixel_conv_transpose`` writes each phase into a strided slice of the
output; ``subpixel_conv_transpose_d2s`` stacks the phases and interleaves
them with a reshape (depth to space), the form the CVAE's ``"subpixel"``
decoder uses.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _taps(k: int, s: int, p: int) -> int:
    """Taps of phase ``p``'s kernel: ceil((k - p) / s), 0 when p >= k."""
    return max(0, -(-(k - p) // s))


def _phase(x, w, s: int, pi: int, pj: int):
    """Phase (pi, pj) of the transposed conv: (B, Cout, H + ti - 1, W + tj
    - 1); None where the phase has no tap (its outputs are zeros)."""
    k = w.shape[-1]
    ti, tj = _taps(k, s, pi), _taps(k, s, pj)
    if not (ti and tj):
        return None
    wp = w[:, :, pi::s, pj::s].flip(2, 3).transpose(0, 1)  # (Cout, Cin, ti, tj)
    return F.conv2d(x, wp.to(x.dtype), padding=(ti - 1, tj - 1))


def subpixel_conv_transpose(x, w, stride: int):
    """x (B, Cin, H, W), w (Cin, Cout, k, k) -> the VALID transposed conv
    (B, Cout, (H - 1) s + k, (W - 1) s + k), each phase written into its
    strided slice."""
    b, _, h, wd = x.shape
    k, s = w.shape[-1], stride
    out = x.new_zeros(b, w.shape[1], (h - 1) * s + k, (wd - 1) * s + k)
    for pi in range(s):
        for pj in range(s):
            yp = _phase(x, w, s, pi, pj)
            if yp is not None:
                out[:, :, pi::s, pj::s] = yp
    return out


def subpixel_conv_transpose_d2s(x, w, stride: int):
    """The same transposed conv with the phases assembled by depth to
    space: each phase zero-padded to (Qh, Qw), stacked to (B, Cout, Qh, s,
    Qw, s) and reshaped, so output row q s + p is phase p's row q."""
    b, _, h, wd = x.shape
    k, s = w.shape[-1], stride
    t = [_taps(k, s, p) for p in range(s)]
    qh, qw = h + max(t) - 1, wd + max(t) - 1
    rows = []
    for pi in range(s):
        cols = []
        for pj in range(s):
            yp = _phase(x, w, s, pi, pj)
            cols.append(x.new_zeros(b, w.shape[1], qh, qw) if yp is None else
                        F.pad(yp, (0, qw - yp.shape[3], 0, qh - yp.shape[2])))
        rows.append(torch.stack(cols, -1))  # (B, Cout, Qh, Qw, s)
    y = torch.stack(rows, 3)  # (B, Cout, Qh, s, Qw, s)
    y = y.reshape(b, w.shape[1], qh * s, qw * s)
    return y[:, :, :(h - 1) * s + k, :(wd - 1) * s + k]
