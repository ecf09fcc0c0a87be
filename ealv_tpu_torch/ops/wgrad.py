"""K3: the direct weight gradient of a VALID strided conv.

``conv_wgrad_direct`` is the port of the Pallas TPU kernel
``ealv_tpu/ops/pallas_wgrad.py::conv_wgrad_direct``. On CUDA tensors it
launches the hand-written kernels of ``csrc/wgrad.cu`` (built at first use,
see ``cuda_build``): bf16 inputs go to the tensor-core kernel, whose
schedule ``wgrad_plan`` and ``stage_modes`` fix here on the host; f32
inputs go to the direct f32 kernel. On CPU tensors it computes the same
thing with ``conv_wgrad_reference``; anything else raises. There is no
fallback from a kernel to the plain version.

Layouts are torch's: x (B, Cin, H, W), cot (B, Cout, OH, OW) and dW
(Cout, Cin, k, k) in f32 (the JAX function takes NHWC and returns HWIO).
The kernels read both inputs through their strides, so a channels-last view
such as the CVAE's permuted image batch is read in place, without a copy.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import cuda_build

_SOURCE = "wgrad.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# f32 kernel: (b, oh, ow) positions a pass-1 block reduces at least; small
# planes take several images per block so that every block has work for its
# 256 threads
_POSITIONS_PER_BLOCK = 2048

# bf16 tensor-core kernel (csrc/wgrad.cu, wgrad_mma_kernel)
WARPS = 8                # warps per block
MIN_BLOCKS = 132         # shrink the band until the grid has one block per SM
MAX_BLOCKS = 3 * 132     # the persistent grid; more work items loop
BAND_POSITIONS = 256     # output positions a band aims at before shrinking
MAX_GROUP_TAPS = 256     # taps per ci group: 16 n-tiles, two per warp
MAX_GROUP_CO = 64        # output channels per co group: four m-tiles
SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may take
# how a block stages a slice of x or cot: element by element through the
# strides, one contiguous span per channel plane (rows contiguous), or one
# span per item for the whole channels-last band
MODE_SCALAR, MODE_PLANES, MODE_CHANNELS_LAST = 0, 1, 2


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclasses.dataclass(frozen=True)
class WgradPlan:
    """The bf16 kernel's schedule for one shape. A work item is one band of
    ``R`` output rows (all columns) of one image; the grid is (G, n_cig,
    n_cog) blocks, block (g, i, j) takes items g, g + G, ... for input
    channels [i * cig, ...) and output channels [j * MG, ...), stages each
    item's ``XR`` x rows and R cot rows in shared memory and writes one
    partial (Cout-slice x tap-slice) to workspace row g. Every size in
    elements unless named ``*_bytes`` or ``off_*`` (byte offsets into the
    block's dynamic shared memory)."""

    B: int
    Cin: int
    H: int
    W: int
    Cout: int
    k: int
    s: int
    OH: int
    OW: int
    R: int          # output rows per band
    XR: int         # x rows staged per band, s * (R - 1) + k
    n_bands: int    # bands per image, ceil(OH / R)
    cig: int        # input channels per ci group
    n_cig: int
    MG: int         # output channels per co group
    n_cog: int
    M_pad: int      # MG rounded up to 16: the A tile rows
    N_pad: int      # cig * k * k rounded up to 16: the B tile columns
    P_pad: int      # R * OW rounded up to 16: the A tile's leading dimension
    n_items: int    # B * n_bands
    G: int          # blocks along the item axis
    kph: int        # k-step phases: warps sharing one n-tile
    ntw: int        # n-tiles per warp
    x_pitch: int    # per-plane span pitch of the staged x (planes mode)
    x_cap: int      # staged x elements per buffer, any mode
    c_pitch: int    # per-channel span pitch of the staged cot (planes mode)
    c_cap: int      # staged cot elements per buffer, any mode
    off_x0: int
    off_x1: int
    off_c0: int
    off_c1: int
    off_a: int      # A tile, M_pad x P_pad bf16
    off_pos: int    # position offsets, P_pad int32
    off_tap: int    # tap offsets, N_pad int32
    off_b: int      # one 16 x 16 bf16 B tile per warp
    off_red: int    # kph x M_pad x N_pad f32, the warps' sums
    smem_bytes: int

    @property
    def grid(self) -> tuple[int, int, int]:
        return (self.G, self.n_cig, self.n_cog)

    @property
    def ws_elems(self) -> int:
        return self.G * self.Cout * self.Cin * self.k * self.k


def _smem_layout(sizes):
    """Byte offsets of consecutive buffers, each 128-byte aligned, and the
    total."""
    offs, off = [], 0
    for size in sizes:
        offs.append(off)
        off += _up(size, 128)
    return offs, off


def _plan_for_band(B, Cin, H, W, Cout, k, s, R, cig, MG):
    OH, OW = (H - k) // s + 1, (W - k) // s + 1
    XR = s * (R - 1) + k
    n_bands = -(-OH // R)
    n_cig, n_cog = -(-Cin // cig), -(-Cout // MG)
    M_pad, N_pad, P_pad = _up(MG, 16), _up(cig * k * k, 16), _up(R * OW, 16)
    NT = N_pad // 16
    kph, ntw = (1, -(-NT // WARPS)) if NT >= WARPS else (WARPS // NT, 1)
    n_items = B * n_bands
    per_block = -(-n_items * n_cig * n_cog // MAX_BLOCKS)
    G = -(-n_items // per_block)
    # a span copy covers the 16-byte-aligned superset of its elements: up to
    # 7 leading and 8 trailing extra elements
    x_pitch = _up(XR * W + 16, 64)
    x_cap = max(_up(XR * W * Cin + 16, 64), cig * x_pitch)
    c_pitch = _up(R * OW + 16, 64)
    c_cap = max(_up(R * OW * Cout + 16, 64), min(MG, Cout) * c_pitch)
    offs, smem = _smem_layout([2 * x_cap, 2 * x_cap, 2 * c_cap, 2 * c_cap,
                               2 * M_pad * P_pad, 4 * P_pad, 4 * N_pad,
                               2 * 256 * WARPS, 4 * kph * M_pad * N_pad])
    return WgradPlan(B, Cin, H, W, Cout, k, s, OH, OW, R, XR, n_bands, cig, n_cig,
                     MG, n_cog, M_pad, N_pad, P_pad, n_items, G, kph, ntw, x_pitch,
                     x_cap, c_pitch, c_cap, *offs, smem)


@functools.lru_cache(maxsize=None)
def wgrad_plan(B: int, Cin: int, H: int, W: int, Cout: int, k: int, s: int) -> WgradPlan:
    """The bf16 kernel's tile plan for x (B, Cin, H, W), a k x k stride-s
    VALID conv and Cout output channels. Depends on the shape alone, never
    on strides, so every layout of the same values is summed in the same
    order. Bands start at ``BAND_POSITIONS`` output positions and halve
    until the grid has ``MIN_BLOCKS`` blocks or a band is one row, and
    while the block's shared memory exceeds ``SMEM_LIMIT``."""
    if k * k > MAX_GROUP_TAPS:
        raise ValueError(f"the bf16 wgrad kernel takes k*k <= {MAX_GROUP_TAPS}, got k={k}")
    OH, OW = (H - k) // s + 1, (W - k) // s + 1
    cig = min(Cin, MAX_GROUP_TAPS // (k * k))
    MG = min(_up(Cout, 16), MAX_GROUP_CO)
    R = min(OH, -(-BAND_POSITIONS // OW))
    while True:
        plan = _plan_for_band(B, Cin, H, W, Cout, k, s, R, cig, MG)
        blocks = plan.n_items * plan.n_cig * plan.n_cog
        if R == 1 or (blocks >= MIN_BLOCKS and plan.smem_bytes <= SMEM_LIMIT):
            break
        R = -(-R // 2)
    if plan.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"the bf16 wgrad kernel needs {plan.smem_bytes} bytes of shared "
                         f"memory for x {(B, Cin, H, W)}, k={k}, more than {SMEM_LIMIT}")
    return plan


def stage_modes(plan: WgradPlan, xs, cs):
    """How the kernel stages x and cot with strides ``xs`` and ``cs`` (b, c,
    h, w), and the shared-memory strides it then reads them with:
    (x_mode, x_hs, x_ws, c_mode, c_ps). A staged x element (ci, h, w) of a
    band lies at base(ci) + h * x_hs + w * x_ws, a staged cot element (co,
    p) with p = oh_l * OW + ow at base(co) + p * c_ps; ``plane_base`` gives
    base."""
    if xs[3] == 1 and xs[2] == plan.W:
        x = (MODE_PLANES, plan.W, 1)
    elif xs[1] == 1 and xs[3] == plan.Cin and xs[2] == plan.W * plan.Cin:
        x = (MODE_CHANNELS_LAST, plan.W * plan.Cin, plan.Cin)
    else:
        # row pitch: the s * (OW - 1) + k columns a band reads
        x = (MODE_SCALAR, plan.s * (plan.OW - 1) + plan.k, 1)
    if cs[3] == 1 and cs[2] == plan.OW:
        c = (MODE_PLANES, 1)
    elif cs[1] == 1 and cs[3] == plan.Cout and cs[2] == plan.OW * plan.Cout:
        c = (MODE_CHANNELS_LAST, plan.Cout)
    else:
        c = (MODE_SCALAR, 1)
    return (*x, *c)


def plane_base(mode: int, j: int, j0: int, lead: int, pitch: int, scalar_pitch: int) -> int:
    """Shared-memory offset of channel j (of a group starting at channel j0)
    of a staged slice: its own span at ``pitch`` in planes mode, the one
    channels-last span, or ``scalar_pitch`` apart when staged element by
    element. ``lead`` is the span's misalignment in elements (its start
    address mod 16, halved)."""
    if mode == MODE_PLANES:
        return j * pitch + lead
    if mode == MODE_CHANNELS_LAST:
        return lead + j0 + j
    return j * scalar_pitch


# the ints of csrc/wgrad.cu's MmaPlan, in order; stage_modes' five follow
PLAN_FIELDS = ("B", "Cin", "H", "W", "Cout", "k", "s", "OH", "OW", "R", "XR",
               "n_bands", "cig", "MG", "M_pad", "N_pad", "P_pad", "n_items", "G",
               "kph", "ntw", "x_pitch", "c_pitch", "off_x0", "off_x1", "off_c0",
               "off_c1", "off_a", "off_pos", "off_tap", "off_b", "off_red",
               "smem_bytes")


def conv_wgrad_reference(x, cot, k: int, stride: int, dtype=torch.float32):
    """Plain torch K3: autograd's conv weight gradient on copies of the
    inputs in ``dtype``. In f32 it is the path for CPU tensors; in f64 it is
    the card's test oracle, the exact sums that any f32 summation order
    (the kernels' or cuDNN's) is held to."""
    return torch.nn.grad.conv2d_weight(
        x.to(dtype), (cot.shape[1], x.shape[1], k, k), cot.to(dtype), stride=stride)


@functools.cache
def _library():
    fn = cuda_build.load(_SOURCE).conv_wgrad_direct
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                                           ctypes.POINTER(ctypes.c_int64),
                                           ctypes.POINTER(ctypes.c_int64),
                                           ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=256)
def _launch_args(dtype, xshape, xstride, cshape, cstride, k, s):
    """The C entry's argument arrays and the workspace size for one shape
    and layout, built once: (dims, xs, cs, plan or None, ws elements)."""
    B, cin, H, W = xshape
    _, cout, oh, ow = cshape
    xs = (ctypes.c_int64 * 4)(*xstride)
    cs = (ctypes.c_int64 * 4)(*cstride)
    if dtype == torch.float32:
        nb_chunk = max(1, -(-_POSITIONS_PER_BLOCK // (oh * ow)))
        dims = (ctypes.c_int * 8)(B, cin, cout, oh, ow, k, s, nb_chunk)
        return dims, xs, cs, None, -(-B // nb_chunk) * cout * cin * k * k
    plan = wgrad_plan(B, cin, H, W, cout, k, s)
    x_mode, x_hs, x_ws, c_mode, c_ps = stage_modes(plan, xstride, cstride)
    fields = [getattr(plan, f) for f in PLAN_FIELDS]
    arr = (ctypes.c_int64 * (len(fields) + 5))(*fields, x_mode, x_hs, x_ws, c_mode, c_ps)
    dims = (ctypes.c_int * 8)(B, cin, cout, oh, ow, k, s, 1)
    return dims, xs, cs, arr, plan.ws_elems


def _launch(x, cot, k, stride):
    if x.dtype not in _DTYPES or cot.dtype != x.dtype or cot.device != x.device:
        raise TypeError(f"the wgrad kernel takes x and cot of one dtype (float32 "
                        f"or bfloat16) on one device, got {x.dtype} on {x.device} "
                        f"and {cot.dtype} on {cot.device}")
    fn = _library()
    dims, xs, cs, plan, n_ws = _launch_args(x.dtype, tuple(x.shape), x.stride(),
                                            tuple(cot.shape), cot.stride(), k, stride)
    cout, cin = cot.shape[1], x.shape[1]
    ws = torch.empty(n_ws, device=x.device, dtype=torch.float32)
    dw = torch.empty((cout, cin, k, k), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), cot.data_ptr(), ws.data_ptr(), dw.data_ptr(),
                 _DTYPES[x.dtype], dims, xs, cs, plan, stream)
    if err != 0:
        raise RuntimeError(f"wgrad kernel launch failed: cudaError {err}")
    conv_wgrad_direct.launches += 1
    return dw


def conv_wgrad_direct(x, cot, k: int, stride: int):
    """Weight gradient of a VALID stride-``stride`` k x k conv: x (B, Cin,
    H, W) and cot (B, Cout, OH, OW) -> dW (Cout, Cin, k, k) float32.

    CUDA tensors go to a kernel at every size (bf16 to the tensor-core
    kernel, f32 to the direct one); CPU tensors to the plain version.
    ``conv_wgrad_direct.launches`` counts kernel calls (each runs the two
    passes of ``csrc/wgrad.cu``)."""
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
