"""K1, K2, K3 and the belief fusion on the card: each CUDA kernel against
its plain torch version, at the main path's shapes and at ragged probe
shapes.

Every test here needs a CUDA device and skips without one. This file
imports neither JAX nor the JAX package, so it also runs on a machine
without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from ealv_tpu_torch.fingerprint import belief as tbel
from ealv_tpu_torch.models import CVAE
from ealv_tpu_torch.ops import adam as tad
from ealv_tpu_torch.ops import belief as tbo
from ealv_tpu_torch.ops import fast_conv as tfc
from ealv_tpu_torch.ops import footprint as tfp
from ealv_tpu_torch.ops import kernels as tk
from ealv_tpu_torch.ops import wgrad as twg
from ealv_tpu_torch.utils.config import ExperimentConfig


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(n, t, d, mask_kind, dev, seed=0):
    rng = np.random.default_rng(seed)
    samples = rng.uniform(-1, 1, (n, d))
    traj = rng.uniform(-1, 1, (t, d))
    std = np.full(d, 0.05)
    std[d // 2:] = 0.25
    mask = {"random": (rng.uniform(size=t) > 0.3) * 1.0, "zero": np.zeros(t),
            "ones": np.ones(t), "first300": (np.arange(t) < 300) * 1.0}[mask_kind]
    return [torch.tensor(a, dtype=torch.float32, device=dev)
            for a in (samples, traj, std, mask)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,d,mask_kind", [
    (700, 900, 4, "random"), (700, 900, 2, "random"), (700, 900, 6, "random"),
    (300, 500, 3, "zero"), (2000, 10, 3, "ones"), (2000, 3000, 3, "random"),
    (2000, 3000, 4, "random"), (2000, 10, 4, "ones"), (1, 1, 8, "ones"),
    # the repro planner table's: 1500 samples at d = 4 against its memory
    # ring and memory draw, 300 points filled, and its 10-step horizon
    (1500, 2000, 4, "first300"), (1500, 1000, 4, "first300"), (1500, 10, 4, "ones"),
    # T-splits cut unevenly: a T that S does not divide, more splits than
    # points per split, splits longer than one staged stretch, T = 1, d = 8
    (2000, 3001, 3, "random"), (3, 6400, 2, "random"), (33, 80000, 5, "random"),
    (2000, 1, 3, "ones"), (1500, 700, 8, "random"), (129, 513, 7, "random")])
def test_kernel_matches_plain(cuda, n, t, d, mask_kind):
    """f32 on both sides, summation order only: rtol 1e-5, atol 1e-6. One
    launch per call whether the plan splits T or not, and the same bits on
    a repeated call (the partials are combined in split order)."""
    args = _inputs(n, t, d, mask_kind, cuda)
    before = tfp.footprint_and_spread.launches
    got = tfp.footprint_and_spread(*args)
    assert tfp.footprint_and_spread.launches == before + 1
    want = tfp.footprint_and_spread_reference(*args)
    again = tfp.footprint_and_spread(*args)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, again):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_kernel_propagates_nan_across_splits(cuda):
    """A NaN point in one split makes every row's spread and footprint
    NaN, as torch.amax and sum do."""
    args = _inputs(50, 3000, 3, "ones", cuda)
    args[1][2500, 0] = float("nan")
    assert tfp.footprint_plan(50, 3000, 3).splits > 1
    got_sum, got_max = tfp.footprint_and_spread(*args)
    assert got_sum.isnan().all() and got_max.isnan().all()


@pytest.mark.cuda
def test_traj_footprint_goes_through_the_kernel(cuda):
    samples, traj, std, mask = _inputs(64, 100, 3, "random", cuda)
    full = torch.cat([traj, -traj], 1)
    before = tfp.footprint_and_spread.launches
    got = tk.traj_spread(full, samples, [0, 1, 2], std, traj_mask=mask)
    assert tfp.footprint_and_spread.launches == before + 1
    want = tk.traj_spread(full.cpu(), samples.cpu(), [0, 1, 2], std.cpu(),
                          traj_mask=mask.cpu())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_other_dtypes_and_shapes_raise(cuda):
    samples, traj, std, mask = _inputs(8, 9, 3, "ones", cuda)
    with pytest.raises(TypeError):
        tfp.footprint_and_spread(samples.double(), traj.double(), std.double(),
                                 mask.double())
    with pytest.raises(ValueError):
        tfp.footprint_and_spread(samples, traj.t().contiguous().t(), std, mask)
    with pytest.raises(ValueError):
        tfp.footprint_and_spread(*_inputs(8, 9, 9, "ones", cuda))


# ---- K2: the multi-tensor Adam kernel ----

# f32 on both sides with the same formula; nvcc contracts the moment
# updates into FMAs, so values may differ by a few ulps
ADAM_TOL = dict(rtol=1e-5, atol=1e-7)


def production_param_shapes(force=False):
    """The production CVAE's parameter shapes; with ``force`` the force
    variant's at states "xywb"."""
    cfg = ExperimentConfig(states="xywb" if force else "xyw")
    model = CVAE(img_dim=cfg.image_dim, z_dim=cfg.z_dim, s_dim=cfg.s_dim,
                 hidden_dim=cfg.model_hidden(), learn_force=force)
    return [tuple(p.shape) for p in model.parameters()]


def _adam_state(shapes, dev, seed=0):
    """(p, m, v, g) lists with non-zero moments, from a numpy seed."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    out = [[], [], [], []]
    for shape in shapes:
        out[0].append(t(rng.normal(0, 0.05, shape)))
        out[1].append(t(rng.normal(0, 1e-3, shape)))
        out[2].append(t(rng.uniform(0, 1e-5, shape)))
        out[3].append(t(rng.normal(0, 1e-2, shape)))
    return out


def _adam_check(shapes, dev, count, launches):
    p, m, v, g = _adam_state(shapes, dev)
    want = [[x.clone() for x in xs] for xs in (p, m, v)]
    before = tad.adam_apply.launches
    tad.adam_apply(p, m, v, g, 1e-3, count)
    assert tad.adam_apply.launches == before + launches
    for i in range(len(shapes)):
        tad.adam_update_reference(want[0][i], want[1][i], want[2][i], g[i], 1e-3, count)
    torch.cuda.synchronize()
    for got, ref in zip((p, m, v), want):
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, **ADAM_TOL)


@pytest.mark.cuda
def test_adam_kernel_matches_plain_at_production_shapes(cuda):
    """The CVAE's 24 parameter tensors (4.3 M elements) in one launch, at a
    step count > 1 with non-zero moments."""
    shapes = production_param_shapes()
    assert len(shapes) == 24
    _adam_check(shapes, cuda, count=7, launches=1)


@pytest.mark.cuda
def test_adam_kernel_matches_plain_at_the_force_variant_shapes(cuda):
    """The force variant's 24 tensors: one more encoder input column and
    one more decoder output row move the float4/scalar-tail split."""
    _adam_check(production_param_shapes(force=True), cuda, count=7, launches=1)


@pytest.mark.cuda
@pytest.mark.parametrize("sizes,count,launches", [
    ((1,), 1, 1), ((127,), 1, 1), ((129,), 3, 1), ((1, 127, 129, 4097, 3 * 4096 + 5), 2, 1),
    ((33,) * 50, 4, 2)])
def test_adam_kernel_ragged_sizes(cuda, sizes, count, launches):
    """Tensors shorter than a chunk, crossing chunk edges, and more tensors
    than one launch's table holds (two launches)."""
    _adam_check([(n,) for n in sizes], cuda, count, launches)


@pytest.mark.cuda
def test_adam_kernel_after_grads_are_replaced(cuda):
    """Two steps with new grad tensors for the second, as the trainer's
    zero_grad(set_to_none=True) makes them: once at new addresses (the old
    grads still alive) and once where the allocator may hand out the old
    grads' memory again; each against the plain version. New aligned grads
    of the same kind do not miss the launch cache."""
    shapes = [(64, 33), (7,), (4097,)]
    p, m, v, g = _adam_state(shapes, cuda)
    want = [[x.clone() for x in xs] for xs in (p, m, v)]
    tad.adam_apply(p, m, v, g, 1e-3, 1)
    builds = tad.adam_apply.builds
    g_new = _adam_state(shapes, cuda, seed=1)[3]
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(g, g_new))
    tad.adam_apply(p, m, v, g_new, 1e-3, 2)
    assert tad.adam_apply.builds == builds
    for count, grads in ((1, g), (2, g_new)):
        for i in range(len(shapes)):
            tad.adam_update_reference(want[0][i], want[1][i], want[2][i], grads[i],
                                      1e-3, count)
    del g
    g_third = _adam_state(shapes, cuda, seed=2)[3]
    tad.adam_apply(p, m, v, g_third, 1e-3, 3)
    for i in range(len(shapes)):
        tad.adam_update_reference(want[0][i], want[1][i], want[2][i], g_third[i], 1e-3, 3)
    torch.cuda.synchronize()
    for got, ref in zip((p, m, v), want):
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, **ADAM_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["grad", "all"])
def test_adam_kernel_takes_unaligned_tensors(cuda, which):
    """Contiguous views one element past a 16-byte boundary (of the grad
    only, or of all four arrays) take the scalar path; the aligned tensor
    beside them keeps float4. Against the plain version."""
    shapes = [(4097,), (3 * 4096 + 5,)]
    p, m, v, g = _adam_state(shapes, cuda)

    def shifted(x):
        buf = torch.empty(x.numel() + 1, device=cuda)
        out = buf[1:]
        out.copy_(x)
        return out

    arrays = [p, m, v, g] if which == "all" else [g]
    for xs in arrays:
        xs[0] = shifted(xs[0])
    assert g[0].data_ptr() % 16 != 0 and g[0].is_contiguous()
    want = [[x.clone() for x in xs] for xs in (p, m, v)]
    tad.adam_apply(p, m, v, g, 1e-3, 5)
    for i in range(len(shapes)):
        tad.adam_update_reference(want[0][i], want[1][i], want[2][i], g[i], 1e-3, 5)
    torch.cuda.synchronize()
    for got, ref in zip((p, m, v), want):
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, **ADAM_TOL)


@pytest.mark.cuda
def test_fused_adam_matches_torch_adam(cuda):
    """Three steps of FusedAdam against torch.optim.Adam on the card: the
    two formulas place the bias correction differently (sqrt(v / c2) vs
    sqrt(v) / sqrt(c2)), so rtol 1e-5, atol 1e-6."""
    rng = np.random.default_rng(3)
    init = [rng.normal(0, 0.1, s) for s in ((64, 33), (64,), (7, 3, 3, 3))]
    params = [[torch.tensor(a, dtype=torch.float32, device=cuda, requires_grad=True)
               for a in init] for _ in range(2)]
    opts = [tad.FusedAdam(params[0], lr=1e-3), torch.optim.Adam(params[1], lr=1e-3)]
    for step in range(3):
        grads = [rng.normal(0, 1e-2, a.shape) for a in init]
        for ps, opt in zip(params, opts):
            for p, gr in zip(ps, grads):
                p.grad = torch.tensor(gr, dtype=torch.float32, device=cuda)
            opt.step()
    for a, b in zip(*params):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_adam_kernel_rejects_other_grads_without_copying(cuda):
    p, m, v, g = _adam_state([(64, 48)], cuda)
    p0 = p[0].clone()
    before = tad.adam_apply.launches
    with pytest.raises(TypeError):
        tad.adam_apply(p, m, v, [g[0].bfloat16()], 1e-3, 1)
    with pytest.raises(ValueError):
        tad.adam_apply(p, m, v, [g[0].t().contiguous().t()], 1e-3, 1)
    with pytest.raises(ValueError):
        tad.adam_apply(p, m, v, [g[0][:, :24]], 1e-3, 1)
    with pytest.raises(TypeError):
        tad.adam_apply(p, m, v, [g[0].cpu()], 1e-3, 1)
    assert tad.adam_apply.launches == before
    assert torch.equal(p[0], p0)


# ---- K3: the direct conv weight gradient ----

# (B, H, W, Cin, Cout, k, s): the CVAE encoder's three layers at batch 64
# and 32, the probe shapes of the JAX package's tests, then the bf16 kernel's tile
# edges: Cout of 16, 17, 33 and 70 (two co groups); 16 and 17 taps; 300
# taps (two ci groups); bands that do not divide OH, with several items per
# block; B = 1
WGRAD_PRODUCTION = [(64, 180, 180, 3, 10, 3, 2), (64, 89, 89, 10, 10, 3, 2),
                    (64, 44, 44, 10, 20, 5, 3)]
# the same layers at 32 rows: one rank's shard of the batch at two ranks
WGRAD_DP = [(32,) + shape[1:] for shape in WGRAD_PRODUCTION]
WGRAD_PROBES = [(2, 17, 17, 3, 5, 3, 2), (1, 20, 20, 4, 6, 5, 3),
                (2, 16, 16, 2, 3, 3, 3), (1, 13, 11, 1, 2, 1, 1), (3, 9, 9, 2, 40, 3, 2),
                (2, 13, 13, 3, 16, 3, 2), (2, 13, 13, 3, 17, 3, 2), (1, 12, 12, 2, 33, 3, 1),
                (1, 9, 9, 2, 70, 3, 2), (2, 15, 15, 1, 5, 4, 2), (2, 9, 9, 17, 6, 1, 1),
                (1, 13, 13, 12, 6, 5, 2), (6, 100, 100, 3, 10, 3, 2),
                (40, 100, 100, 3, 10, 3, 2), (1, 31, 31, 4, 12, 3, 2)]
# (x, cot) memory orders of (b, c, h, w), slowest first, extra elements per
# batch stride and storage offset: the trainer's channels-last tensors, its
# last layer's cot sliced out of a wider row, and a w-major order that has
# no contiguous span (staged element by element)
WGRAD_LAYOUTS = {
    "channels-last": (("bhwc", 0, 3), ("bhwc", 0, 5)),
    "trainer-last-layer": (("bhwc", 0, 1), ("bchw", 3, 0)),
    "w-major": (("bcwh", 0, 2), ("bcwh", 1, 7)),
}


def _wgrad_inputs(shape, dtype, dev, seed=0, channels_last=False):
    B, H, W, cin, cout, k, s = shape
    rng = np.random.default_rng(seed)
    oh, ow = (H - k) // s + 1, (W - k) // s + 1
    x = torch.tensor(rng.normal(size=(B, H, W, cin)), dtype=dtype, device=dev)
    x = x.permute(0, 3, 1, 2) if channels_last else x.permute(0, 3, 1, 2).contiguous()
    cot = torch.tensor(rng.normal(size=(B, cout, oh, ow)), dtype=dtype, device=dev)
    return x, cot, k, s


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", WGRAD_PRODUCTION + WGRAD_DP + WGRAD_PROBES)
def test_wgrad_kernel_matches_plain(cuda, shape, dtype):
    """Against the plain version in f64, the exact sums: the kernels' f32
    summation error over up to 507 k terms, rtol 1e-4, atol 1e-3 (cuDNN's
    own f32 wgrad is off the exact sums by up to 3.4e-3 at the first layer,
    differently on every call, so it is no oracle at this tolerance). The
    channels-last view (the CVAE's first layer) is read in place and gives
    the same bits as the contiguous copy; two calls give the same bits."""
    x, cot, k, s = _wgrad_inputs(shape, dtype, cuda)
    before = twg.conv_wgrad_direct.launches
    got = twg.conv_wgrad_direct(x, cot, k, s)
    assert twg.conv_wgrad_direct.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (shape[4], shape[3], k, k)
    want = twg.conv_wgrad_reference(x, cot, k, s, dtype=torch.float64)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.double(), want, rtol=1e-4, atol=1e-3)
    xl, _, _, _ = _wgrad_inputs(shape, dtype, cuda, channels_last=True)
    assert not xl.is_contiguous() or shape[3] == 1
    assert torch.equal(twg.conv_wgrad_direct(xl, cot, k, s), got)
    assert torch.equal(twg.conv_wgrad_direct(x, cot, k, s), got)


def _strided(t, order, batch_pad, offset):
    """The NCHW tensor t in memory order ``order`` (slowest dim first), with
    ``batch_pad`` extra elements per image and ``offset`` leading ones."""
    strides, step = [0] * 4, 1
    for d in reversed(order):
        i = "bchw".index(d)
        strides[i] = step + (batch_pad if d == "b" else 0)
        step = strides[i] * t.shape[i]
    buf = torch.zeros(offset + step, dtype=t.dtype, device=t.device)
    out = buf.as_strided(t.shape, strides, offset)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", list(WGRAD_LAYOUTS))
@pytest.mark.parametrize("shape", [WGRAD_PRODUCTION[0], WGRAD_PRODUCTION[2],
                                   (2, 17, 17, 3, 5, 3, 2), (1, 9, 9, 2, 70, 3, 2),
                                   (1, 13, 13, 12, 6, 5, 2)])
def test_wgrad_kernel_reads_strided_inputs(cuda, shape, layout, dtype):
    """x and cot in the trainer's layouts (misaligned starts included) and
    in one with no contiguous span give the same bits as contiguous copies,
    which match the plain version in f64 (rtol 1e-4, atol 1e-3)."""
    x, cot, k, s = _wgrad_inputs(shape, dtype, cuda)
    (xo, xp, xoff), (co, cp, coff) = WGRAD_LAYOUTS[layout]
    xl, cl = _strided(x, xo, xp, xoff), _strided(cot, co, cp, coff)
    assert not cl.is_contiguous() or shape[0] == 1  # one image: no batch stride
    got = twg.conv_wgrad_direct(xl, cl, k, s)
    torch.testing.assert_close(
        got.double(), twg.conv_wgrad_reference(x, cot, k, s, dtype=torch.float64),
        rtol=1e-4, atol=1e-3)
    assert torch.equal(got, twg.conv_wgrad_direct(x, cot, k, s))


@pytest.mark.cuda
def test_conv_autograd_function_on_the_card(cuda):
    """Forward equals F.conv2d; dx and dW against autograd of F.conv2d (f32,
    TF32 off): rtol 1e-4, atol 1e-3."""
    x, cot, k, s = _wgrad_inputs((4, 45, 45, 10, 20, 5, 3), torch.float32, cuda)
    w = torch.tensor(np.random.default_rng(1).normal(size=(20, 10, k, k)),
                     dtype=torch.float32, device=cuda)
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    ya = tfc.conv2d_valid_direct(xa, wa, s)
    yb = torch.nn.functional.conv2d(xb, wb, stride=s)
    torch.testing.assert_close(ya, yb, rtol=0, atol=0)
    before = twg.conv_wgrad_direct.launches
    (ya * cot).sum().backward()
    (yb * cot).sum().backward()
    assert twg.conv_wgrad_direct.launches == before + 1
    torch.testing.assert_close(xa.grad, xb.grad, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(wa.grad, wb.grad, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
def test_wgrad_kernel_rejects_other_inputs(cuda):
    x, cot, k, s = _wgrad_inputs((2, 17, 17, 3, 5, 3, 2), torch.float32, cuda)
    before = twg.conv_wgrad_direct.launches
    with pytest.raises(TypeError):
        twg.conv_wgrad_direct(x, cot.bfloat16(), k, s)
    with pytest.raises(TypeError):
        twg.conv_wgrad_direct(x.half(), cot.half(), k, s)
    with pytest.raises(ValueError):
        twg.conv_wgrad_direct(x, cot[:, :, 1:], k, s)
    assert twg.conv_wgrad_direct.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["xyw", "xyzrpw", "xywb-force-ensemble", "arm", "eval",
                                  "fingerprint"])
def test_warm_toy_tick_never_synchronises(cuda, path):
    """The ticks of ``test_torch_sync.py`` (one ``Experiment.tick`` that
    makes no trainer call; an EvalExperiment tick; a capture tick and an
    identification tick in each seek mode) at toy size under
    ``torch.cuda.set_sync_debug_mode("error")``: any call that makes the
    host wait for the card raises."""
    from test_torch_sync import eval_parts, fingerprint_parts, tick_parts
    parts = {"xyw": lambda: tick_parts(cuda),
             "xyzrpw": lambda: tick_parts(cuda, states="xyzrpw"),
             "xywb-force-ensemble": lambda: tick_parts(cuda, states="xywb", learn_force=True,
                                                       use_z_ensemble=True),
             "arm": lambda: tick_parts(cuda, sim_backend="arm"),
             "eval": lambda: eval_parts(cuda),
             "fingerprint": lambda: fingerprint_parts(cuda)}[path]()
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        for _, call in parts:
            call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


# ------------------------------------------------------------ the belief fusion

BELIEF_STATES = {1: "x", 2: "xy", 3: "xyw", 4: "xyzw", 5: "xyzpw", 6: "xyzrpw"}
BELIEF_LIMS = [[-1.0, 1.0], [-0.8, 0.6], [-0.5, 0.9], [-1.0, 1.0], [-0.7, 0.7], [-1.0, 1.0]]
RING = ("prior", "prior_var", "meas_loc", "meas_val", "meas_n", "count")


def _belief(d, ns, cap, dev, rng, pending=0, thresh=0.8, clip=2.2):
    """A belief of ns^d cells with a random prior and variance, a ring of
    random past measurements and ``pending`` of them pending."""
    b = tbel.FingerprintBelief.create(BELIEF_STATES[d], BELIEF_LIMS[:d], num_samples=ns,
                                      meas_capacity=cap, thresh=thresh, clip=clip, device=dev)
    g = b.grid.shape[0]
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    return dataclasses.replace(
        b, prior=t(rng.uniform(0.2, 0.9, g)), prior_var=t(rng.uniform(0.05, 2.0, g)),
        meas_loc=t(rng.uniform(-1.0, 1.0, (cap, d))), meas_val=t(rng.uniform(0.0, 2.5, cap)),
        meas_n=torch.tensor(pending, device=dev), count=torch.tensor(7, device=dev))


def _pushes(d, n, dev, rng, k=1, i=0):
    """``n`` pushed rows as the identification passes them: rows i, i + k,
    ... of a (n k, d) tensor of relative poses, each with one distance."""
    rows = torch.tensor(rng.uniform(-1.0, 1.0, (n * k, d)), dtype=torch.float32, device=dev)
    dist = torch.tensor(rng.uniform(0.0, 2.5, k), dtype=torch.float32, device=dev)
    return rows[i::k], dist[i].expand(n)


def _plain(b, push):
    if push is not None:
        b = b.push_batch(*push)
    return b._update_prior_plain()


def _assert_fused_like(got, want):
    """Prior and variance within 1e-5 of the largest value (the sums'
    order); the ring and its counters exact."""
    for name in ("prior", "prior_var"):
        a, b = getattr(got, name), getattr(want, name)
        gap = float((a - b).abs().max() / b.abs().max())
        assert gap <= 1e-5, (name, gap)
    for name in ("meas_loc", "meas_val", "meas_n", "count"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("pending,n_push", [(0, 0), (0, 1), (0, 2), (5, 0), (62, 2), (64, 2),
                                            (40, 64)],
                         ids=["n0", "error-mode", "reflection", "pending-only", "ring-full",
                              "wrap-at-cap", "64-pushes"])
def test_belief_kernel_matches_plain_at_the_cells_size(cuda, pending, n_push):
    """50^3 cells at d = 3, a ring of 64: no measurement (the prior and
    variance as they were); one push (error mode), two (the yaw
    reflection); measurements pushed before; the ring filled to 64; two
    pushes at meas_n == cap (both into slot 0); 64 pushes that wrap."""
    rng = np.random.default_rng(pending * 100 + n_push)
    b = _belief(3, 50, 64, cuda, rng, pending)
    push = _pushes(3, n_push, cuda, rng) if n_push else None
    before = tbo.fuse_beliefs.launches
    (got,) = tbel.push_and_fuse([b], [push])
    assert tbo.fuse_beliefs.launches == before + 1
    want = _plain(b, push)
    torch.cuda.synchronize()
    _assert_fused_like(got, want)
    assert int(got.meas_n) == 0 and int(got.count) == 7 + min(pending + n_push, 64)
    if pending + n_push == 0:
        assert torch.equal(got.prior, b.prior) and torch.equal(got.prior_var, b.prior_var)


@pytest.mark.cuda
@pytest.mark.parametrize("d,ns,cap", [(1, 300, 8), (2, 40, 8), (4, 12, 16), (5, 8, 16),
                                      (6, 5, 16)])
@pytest.mark.parametrize("n_push", [1, 2])
def test_belief_kernel_matches_plain_at_other_widths(cuda, d, ns, cap, n_push):
    """The same at a small grid of every other width, with 3 measurements
    pending before the pushes."""
    rng = np.random.default_rng(d * 10 + n_push)
    b = _belief(d, ns, cap, cuda, rng, pending=3)
    push = _pushes(d, n_push, cuda, rng)
    (got,) = tbel.push_and_fuse([b], [push])
    _assert_fused_like(got, _plain(b, push))


def _identification_beliefs(dev, rng, ns=50, k=4):
    """The cell's 16 beliefs, three combinations of two pushes (the
    reflection) and one of one (error mode), each with its own thresholds,
    and their pushes."""
    beliefs, pushes = [], []
    for combo in range(4):
        reps = 1 if combo == 3 else 2
        rows = torch.tensor(rng.uniform(-1, 1, (reps * k, 3)), dtype=torch.float32, device=dev)
        dist = torch.tensor(rng.uniform(0.0, 2.5, k), dtype=torch.float32, device=dev)
        for i in range(k):
            beliefs.append(_belief(3, ns, 64, dev, rng, thresh=0.5 + 0.2 * combo,
                                   clip=2.0 + 0.3 * combo))
            pushes.append((rows[i::k], dist[i].expand(reps)))
    return beliefs, pushes


@pytest.mark.cuda
def test_belief_kernel_fuses_the_identification_in_one_launch(cuda):
    """The identification's 16 beliefs in one call of the C entry, each as
    its plain push and update; the old beliefs' tensors unchanged; the same
    bits on a repeated call."""
    rng = np.random.default_rng(16)
    beliefs, pushes = _identification_beliefs(cuda, rng)
    kept = [{n: getattr(b, n).clone() for n in RING} for b in beliefs]
    before = tbo.fuse_beliefs.launches
    got = tbel.push_and_fuse(beliefs, pushes)
    assert tbo.fuse_beliefs.launches == before + 1
    again = tbel.push_and_fuse(beliefs, pushes)
    torch.cuda.synchronize()
    for b, push, g, a, k in zip(beliefs, pushes, got, again, kept):
        _assert_fused_like(g, _plain(b, push))
        for n in RING:
            assert torch.equal(getattr(g, n), getattr(a, n)), n
            assert torch.equal(getattr(b, n), k[n]), n


@pytest.mark.cuda
def test_belief_kernel_splits_launches_by_count(cuda):
    """20 beliefs take two launches (16 a launch)."""
    rng = np.random.default_rng(20)
    small = [_belief(3, 10, 8, cuda, rng, pending=1 + i % 3) for i in range(20)]
    before = tbo.fuse_beliefs.launches
    got = tbel.push_and_fuse(small)
    assert tbo.fuse_beliefs.launches == before + 2
    for b, g in zip(small, got):
        _assert_fused_like(g, _plain(b, None))


@pytest.mark.cuda
def test_belief_kernel_replays_bit_equal_in_a_graph(cuda):
    """The 16 fusions captured in a CUDA graph: a replay gives the eager
    call's bits; the capture counts one launch."""
    rng = np.random.default_rng(5)
    beliefs, pushes = _identification_beliefs(cuda, rng)
    eager = tbel.push_and_fuse(beliefs, pushes)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = tbo.fuse_beliefs.launches
    with torch.cuda.graph(graph):
        static = tbel.push_and_fuse(beliefs, pushes)
    assert tbo.fuse_beliefs.launches == before + 1
    graph.replay()
    torch.cuda.synchronize()
    for e, s in zip(eager, static):
        for n in RING:
            assert torch.equal(getattr(e, n), getattr(s, n)), n


@pytest.mark.cuda
def test_belief_fusion_routes_cuda_through_the_kernel(cuda):
    """``update_prior`` and ``fuse_matches`` on CUDA beliefs launch the
    kernel, once for all of a call's beliefs."""
    from ealv_tpu_torch.fingerprint import identify as tid
    rng = np.random.default_rng(3)
    b = _belief(3, 20, 8, cuda, rng, pending=2)
    before = tbo.fuse_beliefs.launches
    got = b.update_prior()
    assert tbo.fuse_beliefs.launches == before + 1
    _assert_fused_like(got, _plain(b, None))
    beliefs = [_belief(2, 20, 8, cuda, rng) for _ in range(3)]
    fps = tid.FingerprintSet(z_mu=None, z_logvar=None, x=None, mask=None, center_img=None,
                             center=torch.zeros((3, 2), device=cuda))
    dists = torch.tensor([0.3, 1.1, 2.0], device=cuda)
    best = torch.tensor(rng.uniform(-1, 1, (3, 2)), dtype=torch.float32, device=cuda)
    test = torch.tensor([0.1, -0.2], device=cuda)
    lims = torch.tensor([[-1.0, 1.0]] * 2, device=cuda)
    new = tid.fuse_matches(beliefs, dists, best, test, fps, "xy", lims, lims)
    assert tbo.fuse_beliefs.launches == before + 2
    for i, (b, g) in enumerate(zip(beliefs, new)):
        _assert_fused_like(g, _plain(b, ((test - best[i])[None], dists[i].expand(1))))


@pytest.mark.cuda
def test_belief_kernel_rejects_other_inputs(cuda):
    """A dtype, shape or width the kernel does not take raises before any
    launch."""
    rng = np.random.default_rng(1)
    b = _belief(3, 10, 8, cuda, rng)
    before = tbo.fuse_beliefs.launches
    with pytest.raises(TypeError):
        tbo.fuse_beliefs([dataclasses.replace(b, prior=b.prior.double())])
    with pytest.raises(ValueError):
        tbo.fuse_beliefs([dataclasses.replace(b, prior_var=b.prior_var[:-1])])
    with pytest.raises(ValueError):
        tbo.fuse_beliefs([b], [(torch.zeros((2, 3), device=cuda).t().contiguous().t(),
                                torch.zeros(2, device=cuda))])
    with pytest.raises(TypeError):
        tbo.fuse_beliefs([b, _belief(3, 10, 8, "cpu", rng)])
    with pytest.raises(ValueError):
        tbo.fuse_beliefs([b, _belief(3, 12, 8, cuda, rng)])
    assert tbo.fuse_beliefs.launches == before
