"""K3, the direct conv weight gradient, against the JAX package.

The plain version is held against the Pallas kernel
``ealv_tpu.ops.pallas_wgrad.conv_wgrad_direct`` in interpret mode (its HWIO
result transposed to OIHW); the autograd function against autograd of
``F.conv2d``; and the whole CVAE with ``fast_encoder_grads="pallas"``
against the JAX CVAE with the same switch, in the form of
``tests/test_kernels.py::TestFastConv``. f32, TF32 off. On the CPU the
port takes the kernel's plain version; the kernel itself is held against it
in ``test_torch_cuda.py``.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ealv_tpu.models import CVAE as JCVAE, cvae_loss as j_loss
from ealv_tpu.ops.pallas_wgrad import conv_wgrad_direct as j_wgrad
from ealv_tpu_torch.models import CVAE, cvae_loss
from ealv_tpu_torch.ops import conv2d_valid_direct, conv_wgrad_direct
from ealv_tpu_torch.ops import wgrad as twg
from ealv_tpu_torch.utils.convert import params_from_jax
from test_torch_trainer import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# (B, H, W, Cin, Cout, k, s): the probe shapes of tests/test_kernels.py
# (the s2d pad, k = s, k > s and 1x1 cases)
PROBES = [(2, 17, 17, 3, 5, 3, 2), (1, 20, 20, 4, 6, 5, 3),
          (2, 16, 16, 2, 3, 3, 3), (1, 13, 11, 1, 2, 1, 1)]


def _inputs(shape, seed=0):
    B, H, W, cin, cout, k, s = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, cin)).astype(np.float32)
    cot = rng.normal(size=(B, (H - k) // s + 1, (W - k) // s + 1, cout)).astype(np.float32)
    return x, cot


@pytest.mark.parametrize("shape", PROBES)
def test_plain_matches_pallas_kernel(shape):
    """f32 sums in another order: rtol 1e-5, atol 1e-4."""
    x, cot = _inputs(shape)
    k, s = shape[5], shape[6]
    want = np.asarray(j_wgrad(jnp.asarray(x), jnp.asarray(cot), k=k, stride=s,
                              interpret=True)).transpose(3, 2, 0, 1)
    got = conv_wgrad_direct(torch.from_numpy(x).permute(0, 3, 1, 2),
                            torch.from_numpy(cot).permute(0, 3, 1, 2), k, s)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    assert conv_wgrad_direct.launches == 0  # CPU tensors never reach the kernel


def test_plain_reads_bf16_inputs():
    """bf16 inputs are upcast and summed in f32, as the TPU kernel does:
    against the Pallas kernel on the same bf16 values, rtol 1e-5, atol 1e-4."""
    shape = PROBES[0]
    x, cot = _inputs(shape, seed=1)
    xb, cb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(cot, jnp.bfloat16)
    want = np.asarray(j_wgrad(xb, cb, k=3, stride=2, interpret=True)).transpose(3, 2, 0, 1)
    tx = torch.tensor(np.asarray(xb.astype(jnp.float32))).bfloat16().permute(0, 3, 1, 2)
    tc = torch.tensor(np.asarray(cb.astype(jnp.float32))).bfloat16().permute(0, 3, 1, 2)
    got = conv_wgrad_direct(tx, tc, 3, 2)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", PROBES)
def test_plain_in_f64_is_the_exact_sum(shape, dtype):
    """The card's oracle, the plain version in f64, against the sums taken
    tap by tap in f64 with numpy on the same (f32 or bf16) values: rtol
    1e-12, atol 1e-12."""
    B, H, W, cin, cout, k, s = shape
    x, cot = _inputs(shape, seed=3)
    tx = torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2)
    tc = torch.from_numpy(cot).to(dtype).permute(0, 3, 1, 2)
    got = twg.conv_wgrad_reference(tx, tc, k, s, dtype=torch.float64)
    assert got.dtype == torch.float64
    xv = tx.permute(0, 2, 3, 1).double().numpy()
    cv = tc.permute(0, 2, 3, 1).double().numpy()
    oh, ow = cv.shape[1], cv.shape[2]
    want = np.zeros((cout, cin, k, k))
    for kh, kw in itertools.product(range(k), range(k)):
        patch = xv[:, kh:kh + s * (oh - 1) + 1:s, kw:kw + s * (ow - 1) + 1:s]
        want[:, :, kh, kw] = np.einsum("bhwi,bhwo->oi", patch, cv)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape", PROBES)
def test_autograd_function_matches_conv2d(shape):
    """Forward bit-equal to F.conv2d; dx (the floor-divided tail rows and
    columns zero) and dW against autograd of F.conv2d: rtol 1e-5, atol
    1e-5. dx is not computed when x needs no gradient."""
    x, cot = _inputs(shape, seed=2)
    B, H, W, cin, cout, k, s = shape
    w = np.random.default_rng(3).normal(size=(cout, cin, k, k)).astype(np.float32)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    tc = torch.from_numpy(cot).permute(0, 3, 1, 2)
    xa, wa = tx.clone().requires_grad_(), torch.tensor(w, requires_grad=True)
    xb, wb = tx.clone().requires_grad_(), torch.tensor(w, requires_grad=True)
    ya, yb = conv2d_valid_direct(xa, wa, s), F.conv2d(xb, wb, stride=s)
    assert torch.equal(ya, yb)
    (ya * tc).sum().backward()
    (yb * tc).sum().backward()
    torch.testing.assert_close(xa.grad, xb.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(wa.grad, wb.grad, rtol=1e-5, atol=1e-5)
    wc = torch.tensor(w, requires_grad=True)
    (conv2d_valid_direct(tx, wc, s) * tc).sum().backward()
    torch.testing.assert_close(wc.grad, wb.grad, rtol=1e-5, atol=1e-5)


KW = dict(img_dim=(24, 24, 3), z_dim=8, s_dim=2, hidden_dim=(32, 16),
          cnn_kernels=(3, 3), cnn_strides=(2, 2), cnn_channels=(4, 6))


def test_model_grads_match_jax_pallas_variant():
    """Whole-model loss and gradients with fast_encoder_grads="pallas" on
    both sides (JAX's Pallas wgrad in interpret mode), from the same
    weights and batch: loss at 1e-5, gradients at atol 1e-6."""
    rng = np.random.default_rng(0)
    jm = JCVAE(fast_encoder_grads="pallas", **KW)
    jp = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 2)),
                 jnp.zeros((1, 24, 24, 3)), train=False)
    x = rng.normal(size=(4, 2)).astype(np.float32)
    y = rng.uniform(size=(4, 24, 24, 3)).astype(np.float32)

    def jloss(p):
        out = jm.apply(p, jnp.asarray(x), jnp.asarray(y), train=False)
        return j_loss(out, jnp.asarray(y), beta=0.01, gamma=0.1, gamma_weight=0.1,
                      learn_force=False, other_locs=False)[0]

    jl, jg = jax.value_and_grad(jloss)(jp)
    tm = CVAE(fast_encoder_grads="pallas", **KW)
    tm.load_state_dict(params_from_jax(jp, tm))
    out = tm(torch.from_numpy(x), torch.from_numpy(y))
    tl, _ = cvae_loss(out, torch.from_numpy(y), beta=0.01, gamma=0.1, gamma_weight=0.1,
                      other_locs=False)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) < 1e-5
    want = params_from_jax(jg, tm)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=1e-6,
                                   err_msg=name)


def test_model_switch_keeps_parameters_and_values():
    """fast_encoder_grads="pallas" changes no parameter key and no value:
    the same weights give the same loss and gradients as the plain encoder
    (f32: rtol 1e-5, atol 1e-6)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(3, 2)).astype(np.float32))
    y = torch.from_numpy(rng.uniform(size=(3, 24, 24, 3)).astype(np.float32))
    models = [CVAE(fast_encoder_grads=v, **KW) for v in (False, "pallas")]
    models[0].reset_parameters(torch.Generator().manual_seed(0))
    models[1].load_state_dict(models[0].state_dict())
    losses = []
    for m in models:
        loss, _ = cvae_loss(m(x, y), y, beta=0.01, gamma=0.1, other_locs=False)
        loss.backward()
        losses.append(loss)
    torch.testing.assert_close(losses[1], losses[0], rtol=1e-5, atol=1e-6)
    for (n0, p0), (n1, p1) in zip(*(m.named_parameters() for m in models)):
        assert n0 == n1
        torch.testing.assert_close(p1.grad, p0.grad, rtol=1e-5, atol=1e-6)


# ---- the bf16 tensor-core kernel's schedule, emulated on the CPU ----
#
# csrc/wgrad.cu's wgrad_mma_kernel runs only on the card. Its index math is
# held here instead: the plan of ops/wgrad.py, and a step-by-step emulation
# of the kernel's schedule (span staging of the 16-byte-aligned superset,
# the A tile, the position and tap offset tables, the im2col tile, k-step
# phases, block partials and the pass-2 sum in block order), which tracks
# the storage index of every staged element as well as its value.

# the CVAE encoder's three layers at batch 2
CVAE_LAYERS = [(2, 180, 180, 3, 10, 3, 2), (2, 89, 89, 10, 10, 3, 2),
               (2, 44, 44, 10, 20, 5, 3)]
# tile edges: Cout of 16, 17, 33, 40 and 70 (two co groups); 16 and 17 taps;
# 300 taps (two ci groups); bands that do not divide OH, several items per
# block; B = 1
EDGES = [(2, 13, 13, 3, 16, 3, 2), (2, 13, 13, 3, 17, 3, 2), (1, 12, 12, 2, 33, 3, 1),
         (3, 9, 9, 2, 40, 3, 2), (1, 9, 9, 2, 70, 3, 2), (2, 15, 15, 1, 5, 4, 2),
         (2, 9, 9, 17, 6, 1, 1), (1, 13, 13, 12, 6, 5, 2), (6, 100, 100, 3, 10, 3, 2),
         (40, 100, 100, 3, 10, 3, 2), (1, 31, 31, 4, 12, 3, 2)]
SCHEDULE_SHAPES = CVAE_LAYERS + PROBES + EDGES
# (x, cot) layouts: memory order of (b, c, h, w), slowest first, extra
# elements per batch stride, storage offset. The trainer gives channels-last
# x and cot, and a last-layer cot sliced out of a wider row; "w-major" has
# no contiguous span and is staged element by element.
LAYOUTS = {
    "nchw": (("bchw", 0, 0), ("bchw", 0, 0)),
    "channels-last": (("bhwc", 0, 3), ("bhwc", 0, 5)),
    "trainer-last-layer": (("bhwc", 0, 1), ("bchw", 3, 0)),
    "w-major": (("bcwh", 0, 2), ("bcwh", 1, 7)),
}


def _strided(v, order, batch_pad, offset):
    """The NCHW array v in memory order ``order`` (slowest dim first), with
    ``batch_pad`` extra elements per image and ``offset`` leading ones, as
    a strided view of a NaN-filled buffer."""
    shape = v.shape
    strides, step = [0] * 4, 1
    for d in reversed(order):
        i = "bchw".index(d)
        strides[i] = step + (batch_pad if d == "b" else 0)
        step = strides[i] * shape[i]
    buf = torch.full((offset + step + 16,), float("nan"))
    out = buf.as_strided(shape, strides, offset)
    out.copy_(torch.from_numpy(v))
    return out


def _flat(t):
    n = t.untyped_storage().nbytes() // t.element_size()
    return torch.empty(0, dtype=t.dtype).set_(t.untyped_storage(), 0, (n,), (1,))


def _stage_span(val, src, dst, flat, start, length, room):
    """copy_span: the 8-element (16-byte) chunks that cover flat[start :
    start + length] land at dst (aligned), within ``room`` elements. The
    other elements of those chunks are NaN here (never to be read); src
    records each staged element's storage index (-2 for the others)."""
    a0, a1 = start - start % 8, -(-(start + length) // 8) * 8
    assert dst % 8 == 0 and a1 - a0 <= room
    idx = torch.arange(a0, a1)
    inside = (idx >= start) & (idx < start + length)
    val[dst:dst + a1 - a0] = torch.where(
        inside, flat[idx.clamp(max=flat.numel() - 1)].double(), float("nan"))
    src[dst:dst + a1 - a0] = torch.where(inside, idx, -2)
    return start % 8


def _emulate_mma_schedule(x, cot, k, s):
    """dW of csrc/wgrad.cu's bf16 kernel, block by block, from the plan
    and staging modes of ops/wgrad.py; also the number of times each (b,
    oh, ow, tap) term was summed, over all output channels (Cout if once
    each). Asserts that every staged element the
    schedule reads is the element the sum needs. Sums in f64."""
    B, Cin, H, W = x.shape
    Cout = cot.shape[1]
    plan = twg.wgrad_plan(B, Cin, H, W, Cout, k, s)
    x_mode, x_hs, x_ws, c_mode, c_ps = twg.stage_modes(plan, x.stride(), cot.stride())
    sx, sc = x.stride(), cot.stride()
    xf, cf = _flat(x), _flat(cot)
    OH, OW, kk = plan.OH, plan.OW, k * k
    q = torch.arange(plan.P_pad)
    pos = s * (q // OW) * x_hs + s * (q % OW) * x_ws  # the kernel's pos table
    ws = torch.zeros(plan.G, Cout, Cin * kk, dtype=torch.float64)
    count = torch.zeros(B, OH, OW, Cin * kk, dtype=torch.int64)
    for gi, gj, g in itertools.product(range(plan.n_cig), range(plan.n_cog), range(plan.G)):
        g0, c0 = gi * plan.cig, gj * plan.MG
        nci, nco = min(plan.cig, Cin - g0), min(plan.MG, Cout - c0)
        red = torch.zeros(plan.kph, plan.M_pad, plan.N_pad, dtype=torch.float64)
        for item in range(g, plan.n_items, plan.G):
            b, band = divmod(item, plan.n_bands)
            oh0 = band * plan.R
            rows = min(plan.R, OH - oh0)
            xrows, npos = s * (rows - 1) + k, rows * OW
            xval = torch.full((plan.x_cap,), float("nan"), dtype=torch.float64)
            xsrc = torch.full((plan.x_cap,), -1, dtype=torch.int64)
            cval = torch.full((plan.c_cap,), float("nan"), dtype=torch.float64)
            csrc = torch.full((plan.c_cap,), -1, dtype=torch.int64)
            xb = x.storage_offset() + b * sx[0] + s * oh0 * sx[2]
            cb = cot.storage_offset() + b * sc[0] + oh0 * sc[2]
            if x_mode == twg.MODE_PLANES:
                xlead = [_stage_span(xval, xsrc, c * plan.x_pitch, xf, xb + (g0 + c) * sx[1],
                                     xrows * W, plan.x_pitch) for c in range(nci)]
            elif x_mode == twg.MODE_CHANNELS_LAST:
                xlead = [_stage_span(xval, xsrc, 0, xf, xb, xrows * W * Cin, plan.x_cap)] * nci
            else:
                c_, h_, w_ = torch.meshgrid(torch.arange(nci), torch.arange(xrows),
                                            torch.arange(x_hs), indexing="ij")
                d = (c_ * plan.XR * x_hs + h_ * x_hs + w_).flatten()
                gidx = (xb + (g0 + c_) * sx[1] + h_ * sx[2] + w_ * sx[3]).flatten()
                xval[d], xsrc[d], xlead = xf[gidx].double(), gidx, [0] * nci
            if c_mode == twg.MODE_PLANES:
                clead = [_stage_span(cval, csrc, c * plan.c_pitch, cf, cb + (c0 + c) * sc[1],
                                     npos, plan.c_pitch) for c in range(nco)]
            elif c_mode == twg.MODE_CHANNELS_LAST:
                clead = [_stage_span(cval, csrc, 0, cf, cb, npos * Cout, plan.c_cap)] * nco
            else:
                c_, p_ = torch.meshgrid(torch.arange(nco), torch.arange(npos), indexing="ij")
                d = (c_ * plan.R * OW + p_).flatten()
                gidx = (cb + (c0 + c_) * sc[1] + (p_ // OW) * sc[2] + (p_ % OW) * sc[3]).flatten()
                cval[d], csrc[d], clead = cf[gidx].double(), gidx, [0] * nco
            p_ = torch.arange(npos)
            oh_l, ow = p_ // OW, p_ % OW
            # the A tile [co][p], zero past nco and npos
            a = torch.zeros(plan.M_pad, plan.P_pad, dtype=torch.float64)
            for m in range(nco):
                idx = twg.plane_base(c_mode, m, c0, clead[m], plan.c_pitch,
                                     plan.R * OW) + p_ * c_ps
                want = cb + (c0 + m) * sc[1] + oh_l * sc[2] + ow * sc[3]
                assert torch.equal(csrc[idx], want), (item, m)
                a[m, :npos] = cval[idx]
            # the tap table and the im2col tile [p][t], zero past the taps
            t = torch.arange(nci * kk)
            ci, kh, kw = t // kk, t % kk // k, t % k
            tap = torch.tensor([twg.plane_base(x_mode, c, g0, xlead[c], plan.x_pitch,
                                               plan.XR * x_hs) for c in ci.tolist()],
                               dtype=torch.int64) + kh * x_hs + kw * x_ws
            idx = pos[:npos, None] + tap[None, :]
            want = (xb + (g0 + ci)[None] * sx[1] + (s * oh_l[:, None] + kh[None]) * sx[2]
                    + (s * ow[:, None] + kw[None]) * sx[3])
            assert torch.equal(xsrc[idx], want), item
            bt = torch.zeros(plan.P_pad, plan.N_pad, dtype=torch.float64)
            bt[:npos, :nci * kk] = xval[idx]
            count.index_put_((torch.full_like(idx, b), (oh0 + oh_l)[:, None].expand_as(idx),
                              ow[:, None].expand_as(idx), (g0 * kk + t)[None].expand_as(idx)),
                             torch.full_like(idx, nco), accumulate=True)
            for ks in range(-(-npos // 16)):  # warps of phase ks % kph
                red[ks % plan.kph] += a[:, ks * 16:ks * 16 + 16] @ bt[ks * 16:ks * 16 + 16]
        part = red[0]
        for ph in range(1, plan.kph):
            part = part + red[ph]
        ws[g, c0:c0 + nco, g0 * kk:(g0 + nci) * kk] = part[:nco, :nci * kk]
    dw = ws[0]
    for g in range(1, plan.G):
        dw = dw + ws[g]
    return dw.reshape(Cout, Cin, k, k).float(), count


def _layout_inputs(shape, layout, seed=0):
    """Small integers: every sum of products here is exact in f32 in any
    order (below 2**24), so a wrong term shows as a whole-number error and
    the tolerances below need no allowance for summation order."""
    B, H, W, cin, cout, k, s = shape
    rng = np.random.default_rng(seed)
    x = rng.integers(-4, 5, (B, H, W, cin)).astype(np.float32)
    cot = rng.integers(-4, 5, (B, (H - k) // s + 1, (W - k) // s + 1, cout)).astype(np.float32)
    (xo, xp, xoff), (co, cp, coff) = LAYOUTS[layout]
    return (x, cot, _strided(x.transpose(0, 3, 1, 2).copy(), xo, xp, xoff),
            _strided(cot.transpose(0, 3, 1, 2).copy(), co, cp, coff))


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("shape", SCHEDULE_SHAPES)
def test_mma_schedule_reads_each_term_once(shape, layout):
    """Every (co, b, oh, ow, tap) term is summed exactly once, and every staged
    x and cot element the schedule reads is the element that term needs
    (so it lies inside the staged rows and never in a chunk's overhang);
    the emulated dW equals the plain version (f32: rtol 1e-5, atol 1e-4)."""
    k, s = shape[5], shape[6]
    _, _, tx, tc = _layout_inputs(shape, layout)
    got, count = _emulate_mma_schedule(tx, tc, k, s)
    assert bool((count == shape[4]).all())
    want = twg.conv_wgrad_reference(tx, tc, k, s)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape", SCHEDULE_SHAPES)
def test_mma_schedule_matches_pallas_kernel(shape):
    """The emulated schedule on the trainer's layouts against the Pallas
    kernel in interpret mode (f32: rtol 1e-5, atol 1e-4)."""
    k, s = shape[5], shape[6]
    x, cot, tx, tc = _layout_inputs(shape, "channels-last", seed=4)
    want = np.asarray(j_wgrad(jnp.asarray(x), jnp.asarray(cot), k=k, stride=s,
                              interpret=True)).transpose(3, 2, 0, 1)
    got, _ = _emulate_mma_schedule(tx, tc, k, s)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape,R,blocks", [
    ((64, 180, 180, 3, 10, 3, 2), 3, 384), ((64, 89, 89, 10, 10, 3, 2), 6, 256),
    ((64, 44, 44, 10, 20, 5, 3), 4, 256)])
def test_mma_plan_at_production_shapes(shape, R, blocks):
    """The encoder's layers at batch 64: at least one block per SM, bands of
    s*(R-1)+k staged rows, one ci and co group, shared memory under the
    limit, and the modes of the trainer's channels-last tensors."""
    B, H, W, cin, cout, k, s = shape
    plan = twg.wgrad_plan(B, cin, H, W, cout, k, s)
    assert (plan.R, plan.XR, plan.G) == (R, s * (R - 1) + k, blocks)
    assert plan.grid == (blocks, 1, 1) and blocks >= twg.MIN_BLOCKS
    assert plan.n_items == B * -(-plan.OH // R) and plan.smem_bytes <= twg.SMEM_LIMIT
    assert plan.M_pad == -(-cout // 16) * 16 and plan.N_pad == -(-cin * k * k // 16) * 16
    assert plan.ws_elems == blocks * cout * cin * k * k
    x = torch.empty(B, H, W, cin).permute(0, 3, 1, 2)
    cot = torch.empty(B, plan.OH, plan.OW, cout).permute(0, 3, 1, 2)
    modes = twg.stage_modes(plan, x.stride(), cot.stride())
    assert modes == (twg.MODE_CHANNELS_LAST, W * cin, cin, twg.MODE_CHANNELS_LAST, cout)
    offs = [plan.off_x0, plan.off_x1, plan.off_c0, plan.off_c1, plan.off_a, plan.off_pos,
            plan.off_tap, plan.off_b, plan.off_red, plan.smem_bytes]
    assert offs == sorted(offs) and all(o % 128 == 0 for o in offs)


def test_mma_plan_rejects_what_it_cannot_tile():
    with pytest.raises(ValueError):
        twg.wgrad_plan(1, 1, 20, 20, 4, 17, 1)  # 289 taps in one channel
