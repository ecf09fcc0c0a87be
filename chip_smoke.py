#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ealv_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):
  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles every kernel (K1 footprint.cu, K2 adam.cu, K3
     wgrad.cu) from ealv_tpu_torch/csrc, one nvcc per source, in parallel;
  3. kernels vs their plain torch versions on the card, at the main paths'
     shapes (K1 at d = 3 for the xyw tick, d = 6 for the xyzrpw tick, and
     N = 2010 for the planner's add_recent_history samples) and the probe
     shapes (K1's and K3's the same bits on a repeated call), then device
     times (CUDA events) and host clock per call of each kernel, its plain
     version and the one PyTorch call for the same function where there is
     one (torch.optim.Adam(fused=True) for K2, cuDNN's bf16 wgrad for K3),
     beside each kernel's bound on this card;
  4. agreement: two toy-size ticks on the card and on the CPU with the same
     weights and the same fed random draws (float32, TF32 off), at xyw, at
     xywb with the force variant and the z-ensemble, and with each baseline
     explorer (randomWalk, uniform); three toy EvalExperiment ticks toward
     an ExplrDist target and toward a frozen CVAE's pdf, and
     evaluate_test_set on a toy set, card against CPU; one toy
     planner call on the card and on the CPU with the same fed draws for
     every dynamics model (single, double, speed, SO(3) roll), every
     warm-start policy (Roll, Zero, BarrierPush, LQR) and every mode
     (full_cost, fixed_lam, ctrl_app_search=False, add_recent_history,
     sample_near_current_loc), comparing the plan, the cost and the
     rolled-out R; one toy trainer call with both trainer kernels on, card
     vs CPU; one
     production-size trainer call on the card with the kernels on vs off,
     from the same weights and draws, ms per trainer call on and off (K2's
     launch cache must hit on every step), and the device's busy time in
     profiled calls;
  5. the tick paths at production size (180x180x3 images, 2000 target
     samples, 3000 trajectory points, batch 64, 25 Adam steps every third
     tick, bf16), trainer kernels off as in the JAX default: the xyw tick
     (double integrator), then the 6-DoF xyzrpw tick (SO(3) roll dynamics,
     linearized at every step); for each, warm ticks, then timed ticks,
     with K1's launch count read over the timed window; then the variant
     tick path (xywb, learn_force, use_z_ensemble, both trainer kernels
     on) with K1, K2 and K3 counted and the ensemble pdf held against its
     plain decode-and-average; then the eval path: a 25-point grid test set
     collected at 180x180, 12 EvalExperiment ticks toward a frozen
     production CVAE (12 K1 launches a plan), evaluate_test_set over the
     set, and baseline ticks (no K1 launch in their plan_step);
  6. the learning path at production size through the port's run entry
     (``ealv_tpu_torch.scripts.run_experiment.run``) with
     ``fast_encoder_grads="pallas"`` and ``fused_adam=True``: 12 exploration
     steps with a trainer call every third, post-training to 36 trainer
     calls, checkpoints every 6 steps and the postexplr checkpoint (in a
     temporary directory, removed afterwards), which is reloaded into a
     fresh Experiment and compared tensor for tensor.
The line before the last is the kernels' JSON record; the last line is the
result JSON. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

TOL = dict(rtol=1e-5, atol=1e-6)  # f32 K1: summation order only
# f32 K2, same formula; nvcc contracts the moment updates into FMAs
ADAM_TOL = dict(rtol=1e-5, atol=1e-7)
# K3 against the plain version in f64, the exact sums: the kernels' f32
# summation error over up to 507 k terms (at most 1.4e-3, on entries of
# |dW| > 1000, at the production layers). Not against the plain version in
# f32: cuDNN's f32 wgrad is off the exact sums by up to 3.4e-3 itself, and
# by a different amount on every call (split sums in no fixed order)
WGRAD_TOL = dict(rtol=1e-4, atol=1e-3)
# (B, H, W, Cin, Cout, k, s): the CVAE encoder's three layers at batch 64,
# the CPU tests' probe shapes, then the bf16 kernel's tile edges: Cout of
# 16, 17, 33 and 70 (two co groups); 16 and 17 taps; 300 taps (two ci
# groups); bands that do not divide OH, with several items per block; B = 1
WGRAD_PRODUCTION = [(64, 180, 180, 3, 10, 3, 2), (64, 89, 89, 10, 10, 3, 2),
                    (64, 44, 44, 10, 20, 5, 3)]
WGRAD_PROBES = [(2, 17, 17, 3, 5, 3, 2), (1, 20, 20, 4, 6, 5, 3),
                (2, 16, 16, 2, 3, 3, 3), (1, 13, 11, 1, 2, 1, 1), (3, 9, 9, 2, 40, 3, 2),
                (2, 13, 13, 3, 16, 3, 2), (2, 13, 13, 3, 17, 3, 2), (1, 12, 12, 2, 33, 3, 1),
                (1, 9, 9, 2, 70, 3, 2), (2, 15, 15, 1, 5, 4, 2), (2, 9, 9, 17, 6, 1, 1),
                (1, 13, 13, 12, 6, 5, 2), (6, 100, 100, 3, 10, 3, 2),
                (40, 100, 100, 3, 10, 3, 2), (1, 31, 31, 4, 12, 3, 2)]
# the production config (bench.py:372-379)
PRODUCTION = dict(states="xyw", num_target_samples=2000, num_traj_samples=3000,
                  image_dim=(180, 180, 3), batch_size=64, num_learning_opt=25)


def _smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _k1_bound_ms(n, t, d, mask):
    """The least time for K1 on these inputs: 3d + 5 f32 operations for each
    pair of a sample and an unmasked point (d subtractions and FMAs, the
    scale, the exponential, the mask, the add and the max) at 67 TFLOP/s,
    against each input read once and both outputs written once at 3.35
    TB/s."""
    pairs = n * int((mask != 0).sum())
    ops_ms = pairs * (3 * d + 5) / 67e12 * 1e3
    bytes_ms = 4 * (n * d + t * d + d + t + 2 * n) / 3.35e12 * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def phase_kernels(dev):
    """K1 against its plain version at the main paths' shapes and the probe
    shapes, the same bits on a repeated call; then kernel and plain times
    at the main paths' shapes: d = 3 (xyw), d = 6 (xyzrpw) and d = 4
    (xywb)."""
    import torch
    from ealv_tpu_torch.ops import (footprint_and_spread, footprint_and_spread_reference,
                                    footprint_plan)
    from ealv_tpu_torch.utils.timing import device_ms, host_ms

    g = torch.Generator(device=dev).manual_seed(0)
    u = lambda *s: torch.rand(s, generator=g, device=dev) * 2 - 1

    def case(n, t, d, mask_kind):
        samples, traj = u(n, d), u(t, d)
        std = torch.full((d,), 0.05, device=dev)
        std[d // 2:] = 0.25
        mask = torch.ones(t, device=dev)
        if mask_kind == "tail":
            mask[t * 2 // 3:] = 0.0
        elif mask_kind == "random":
            mask = (torch.rand(t, generator=g, device=dev) > 0.3).float()
        elif mask_kind == "zero":
            mask.zero_()
        return samples, traj, std, mask

    # (n, t, d, mask): the main paths' shapes (target spread and base
    # footprint 2000x3000, horizon costs 2000x10, at d = 3 and d = 6; N =
    # 2010 with add_recent_history), the CPU probe shapes, and T-splits cut
    # unevenly: a T that S does not divide, more splits than points per
    # split, splits longer than one staged stretch, T = 1, d = 8
    shapes = [(2000, 3000, 3, "tail"), (2000, 10, 3, "ones"),
              (2000, 3000, 6, "tail"), (2000, 10, 6, "ones"),
              (2000, 3000, 4, "tail"), (2000, 10, 4, "ones"),
              (2010, 3000, 6, "tail"), (2010, 10, 6, "ones"), (2010, 3000, 3, "random"),
              (700, 900, 4, "random"), (700, 900, 2, "random"),
              (700, 900, 6, "random"), (64, 100, 3, "ones"),
              (2000, 3000, 3, "zero"), (1, 1, 3, "ones"), (129, 513, 7, "random"),
              (2000, 3001, 3, "random"), (3, 6400, 2, "random"),
              (33, 80000, 5, "random"), (1500, 700, 8, "random"), (2000, 1, 3, "ones")]
    max_err = 0.0
    for n, t, d, mk in shapes:
        args = case(n, t, d, mk)
        got = footprint_and_spread(*args)
        again = footprint_and_spread(*args)
        want = footprint_and_spread_reference(*args)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, **TOL)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise RuntimeError(f"footprint kernel {n}x{t}x{d} is not deterministic")
        err = _max_err(got, want)
        max_err = max(max_err, err)
        plan = footprint_plan(n, t, d)
        print(f"[kernels] footprint_and_spread {n}x{t}x{d} mask={mk} (splits "
              f"{plan.splits} of {plan.split_len}): max|kernel-plain| = {err:.3e}, "
              f"bit-equal on repeat")
    rec = {}
    for n, t, d, mk in ((2000, 3000, 3, "tail"), (2000, 10, 3, "ones"),
                        (2000, 3000, 6, "tail"), (2000, 10, 6, "ones"),
                        (2000, 3000, 4, "tail"), (2000, 10, 4, "ones")):
        args = case(n, t, d, mk)
        kernel = lambda: footprint_and_spread(*args)
        plain = lambda: footprint_and_spread_reference(*args)
        ms, plain_ms = device_ms(kernel), device_ms(plain)
        h_ms, h_plain = host_ms(kernel), host_ms(plain)
        bound_ms, bound_by = _k1_bound_ms(n, t, d, args[3])
        print(f"[kernels] footprint_and_spread {n}x{t}x{d} mask={mk}: device (CUDA events, "
              f"median of 21 x 50) kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms; host "
              f"clock per call {h_ms:.4f} / {h_plain:.4f} ms; bound {bound_ms:.5f} ms "
              f"({bound_by})")
        rec[n, t, d] = dict(ms=ms, plain_ms=plain_ms, host_ms=h_ms, bound_ms=bound_ms,
                            bound_by=bound_by)
    out = dict(max_abs_err=max_err, **rec[2000, 3000, 3], library_ms=None, shape="2000x3000x3")
    for key in ((2000, 10, 3), (2000, 3000, 6), (2000, 10, 6), (2000, 3000, 4),
                (2000, 10, 4)):
        tag = "x".join(map(str, key))
        out.update({f"{k}_{tag}": v for k, v in rec[key].items()})
    return out


def _max_err(got, want):
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


def phase_adam(dev):
    """K2 against its plain version: the CVAE's 24 parameter tensors in one
    launch, ragged and tiny sizes, and tensors that start off a 16-byte
    boundary (the scalar path), at step counts > 1 with non-zero moments;
    then kernel, plain and torch.optim.Adam(fused=True) times."""
    import torch
    from ealv_tpu_torch.models import CVAE
    from ealv_tpu_torch.ops import adam as tad
    from ealv_tpu_torch.utils.config import ExperimentConfig
    from ealv_tpu_torch.utils.timing import device_ms, host_ms

    cfg = ExperimentConfig(**PRODUCTION)
    shapes_of = lambda **kw: [tuple(p.shape) for p in CVAE(
        img_dim=cfg.image_dim, z_dim=cfg.z_dim, hidden_dim=cfg.model_hidden(),
        **kw).parameters()]
    prod = shapes_of(s_dim=cfg.s_dim)
    # the variant path's CVAE (xywb, learn_force): one more encoder input
    # column and one more decoder output row
    force = shapes_of(s_dim=4, learn_force=True)
    g = torch.Generator(device=dev).manual_seed(1)

    def state(shapes, offset=0):
        def r(s, scale, rand=torch.randn):
            n = int(np.prod(s))
            buf = rand(n + offset, generator=g, device=dev) * scale
            return buf[offset:].view(s)
        return ([r(s, 0.05) for s in shapes], [r(s, 1e-3) for s in shapes],
                [r(s, 1e-5, torch.rand) for s in shapes], [r(s, 1e-2) for s in shapes])

    max_err = 0.0
    for shapes, count, offset in ((prod, 7, 0), (force, 7, 0), ([(1,)], 1, 0), ([(127,)], 1, 0),
                                  ([(129,)], 3, 0),
                                  ([(1,), (127,), (129,), (4097,), (3 * 4096 + 5,)], 2, 0),
                                  ([(129,), (4097,), (3 * 4096 + 5,)], 2, 1)):
        p, m, v, gr = state(shapes, offset)
        want = [[x.clone() for x in xs] for xs in (p, m, v)]
        before = tad.adam_apply.launches
        tad.adam_apply(p, m, v, gr, 1e-3, count)
        if tad.adam_apply.launches != before + 1:
            raise RuntimeError("adam_apply did not make exactly one launch")
        for i in range(len(shapes)):
            tad.adam_update_reference(want[0][i], want[1][i], want[2][i], gr[i], 1e-3, count)
        torch.cuda.synchronize()
        err = 0.0
        for got, ref in zip((p, m, v), want):
            for a, b in zip(got, ref):
                torch.testing.assert_close(a, b, **ADAM_TOL)
            err = max(err, _max_err(got, ref))
        max_err = max(max_err, err)
        n = sum(x.numel() for x in p)
        print(f"[kernels] adam_apply {len(shapes)} tensors, {n} elements, step {count}"
              f"{', offset 4 B (scalar path)' if offset else ''}: "
              f"max|kernel-plain| = {err:.3e}")
    p, m, v, gr = state(prod)
    n = sum(x.numel() for x in p)
    kernel = lambda: tad.adam_apply(p, m, v, gr, 1e-3, 7)
    plain = lambda: [tad.adam_update_reference(*t, 1e-3, 7) for t in zip(p, m, v, gr)]
    optimizers = []
    for make in (lambda ps: torch.optim.Adam(ps, lr=1e-3, fused=True), tad.FusedAdam):
        params = [x.clone().requires_grad_() for x in p]
        for q, d in zip(params, gr):
            q.grad = d.clone()
        optimizers.append(make(params).step)
    fused, ours = optimizers
    # in turns: kernel, fused, fused, kernel
    (ms, h_ms), (fused_ms, h_fused), (fused2, h_fused2), (ms2, h_ms2) = (
        (device_ms(f), host_ms(f)) for f in (kernel, fused, fused, kernel))
    plain_ms, h_plain = device_ms(plain), host_ms(plain)
    h_step = host_ms(ours)
    pf, mf, vf, gf = state(force)
    n_force = sum(x.numel() for x in pf)
    force_ms = device_ms(lambda: tad.adam_apply(pf, mf, vf, gf, 1e-3, 7))
    force_plain = device_ms(lambda: [tad.adam_update_reference(*t, 1e-3, 7)
                                     for t in zip(pf, mf, vf, gf)])
    force_bound = 28 * n_force / 3.35e12 * 1e3
    bound_ms = 28 * n / 3.35e12 * 1e3  # p, m, v, g read, p, m, v written, f32
    print(f"[kernels] adam_apply 24 CVAE tensors ({n} elements), ms per step, device "
          f"(CUDA events, median of 21 x 50, in turns kernel, fused, fused, kernel): "
          f"kernel {ms:.4f} / {ms2:.4f} (one launch), torch.optim.Adam(fused=True) "
          f"{fused_ms:.4f} / {fused2:.4f}, plain torch {plain_ms:.4f}; host clock per call: "
          f"kernel {h_ms:.4f} / {h_ms2:.4f}, FusedAdam.step {h_step:.4f}, fused {h_fused:.4f} / "
          f"{h_fused2:.4f}, plain {h_plain:.4f}; bound {bound_ms:.4f} (bytes)")
    print(f"[kernels] adam_apply at the force variant's 24 tensors ({n_force} elements, "
          f"xywb): device kernel {force_ms:.4f} ms per step, plain {force_plain:.4f}; "
          f"bound {force_bound:.4f} (bytes)")
    return dict(max_abs_err=max_err, ms=(ms + ms2) / 2, plain_ms=plain_ms,
                ms_force=force_ms, plain_ms_force=force_plain, bound_ms_force=force_bound,
                host_ms=(h_ms + h_ms2) / 2, bound_ms=bound_ms, bound_by="bytes",
                library_ms=(fused_ms + fused2) / 2, library_host_ms=(h_fused + h_fused2) / 2,
                optimizer_step_host_ms=h_step)


def _trainer_layout(x, cot, last_layer):
    """x and cot laid out as the trainer hands them to K3: channels-last
    views, except the encoder's last layer, whose cot is NCHW sliced out of
    rows three elements wider (its start 2-byte aligned in bf16)."""
    cl = lambda t: t.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
    if not last_layer:
        return cl(x), cl(cot)
    B, C, OH, OW = cot.shape
    rows = cot.new_zeros(B, C * OH * OW + 3)
    out = rows[:, :C * OH * OW].view(B, C, OH, OW)
    out.copy_(cot)
    return cl(x), out


def phase_wgrad(dev):
    """K3 against its plain version in f64 at the encoder's three production
    layers and the probe shapes, f32 and bf16 inputs, with the first
    layer's input a channels-last view as the CVAE gives it; the same
    values in the trainer's layouts give the same bits. Then kernel, plain
    and cuDNN's own bf16 wgrad times at the production layers, in the
    trainer's layouts."""
    import torch
    from ealv_tpu_torch.ops import wgrad as twg
    from ealv_tpu_torch.utils.timing import device_ms, host_ms

    g = torch.Generator(device=dev).manual_seed(2)

    def inputs(shape, dtype):
        B, H, W, cin, cout, k, s = shape
        x = torch.randn((B, H, W, cin), generator=g, device=dev).to(dtype).permute(0, 3, 1, 2)
        if shape != WGRAD_PRODUCTION[0]:
            x = x.contiguous()
        cot = torch.randn((B, cout, (H - k) // s + 1, (W - k) // s + 1), generator=g,
                          device=dev).to(dtype)
        return x, cot, k, s

    max_err = 0.0
    for shape in WGRAD_PRODUCTION + WGRAD_PROBES:
        for dtype in (torch.float32, torch.bfloat16):
            x, cot, k, s = inputs(shape, dtype)
            got = twg.conv_wgrad_direct(x, cot, k, s)
            want = twg.conv_wgrad_reference(x, cot, k, s, dtype=torch.float64)
            f32 = twg.conv_wgrad_reference(x, cot, k, s)
            again = twg.conv_wgrad_direct(x, cot, k, s)
            laid = twg.conv_wgrad_direct(*_trainer_layout(x, cot, shape == WGRAD_PRODUCTION[2]),
                                         k, s)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.double(), want, **WGRAD_TOL)
            if not torch.equal(got, again):
                raise RuntimeError(f"wgrad kernel {shape} is not deterministic")
            if not torch.equal(got, laid):
                raise RuntimeError(f"wgrad kernel {shape} gives other bits in the trainer's "
                                   "layouts")
            err = float((got.double() - want).abs().max())
            max_err = max(max_err, err)
            print(f"[kernels] conv_wgrad_direct {shape} {str(dtype)[6:]}: "
                  f"max|kernel-plain f64| = {err:.3e}, max|plain f32-plain f64| = "
                  f"{float((f32.double() - want).abs().max()):.3e} (|dW| <= "
                  f"{float(want.abs().max()):.1f}); bit-equal on repeat and in the "
                  f"trainer's layouts")
    ms = plain_ms = cudnn_ms = host = bound_bytes = 0.0
    for shape in WGRAD_PRODUCTION:
        x, cot, k, s = inputs(shape, torch.bfloat16)
        x, cot = _trainer_layout(x, cot, shape == WGRAD_PRODUCTION[2])
        fns = (lambda: twg.conv_wgrad_direct(x, cot, k, s),
               lambda: twg.conv_wgrad_reference(x, cot, k, s),
               lambda: torch.nn.grad.conv2d_weight(
                   x, (cot.shape[1], x.shape[1], k, k), cot, stride=s))
        t_k, t_p, t_c = (device_ms(f, inner=20) for f in fns)
        h_k, h_p, h_c = (host_ms(f, inner=20) for f in fns)
        ms, plain_ms, cudnn_ms, host = ms + t_k, plain_ms + t_p, cudnn_ms + t_c, host + h_k
        # x and cot read once in bf16, dW written once in f32
        bound_bytes += 2 * (x.numel() + cot.numel()) + 4 * cot.shape[1] * x.shape[1] * k * k
        print(f"[kernels] conv_wgrad_direct {shape} bf16 in the trainer's layouts, ms per "
              f"call, device (CUDA events, median of 21 x 20): kernel {t_k:.4f}, plain torch (f32 cuDNN on "
              f"upcast inputs) {t_p:.4f}, cuDNN bf16 wgrad {t_c:.4f}; host clock per "
              f"call: {h_k:.4f}, {h_p:.4f}, {h_c:.4f}")
    bound_ms = bound_bytes / 3.35e12 * 1e3
    print(f"[kernels] conv_wgrad_direct, the three encoder layers: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, cuDNN bf16 {cudnn_ms:.4f} ms per Adam step; host clock "
          f"{host:.4f} ms; bound {bound_ms:.4f} ms ({bound_bytes / 1e6:.1f} MB, bytes)")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, host_ms=host,
                bound_ms=bound_ms, bound_by="bytes", library_ms=cudnn_ms)


def _toy_draws(cfg, k, rng, dev, lims=None):
    """Valid fed draws for tick k of a toy run without ring wrap: history
    indices list the k+1 filled slots first; batch indices lie in them;
    planner samples in ``lims`` (default the robot limits), the entropy
    grade's samples and a baseline's unit draws."""
    import torch
    from ealv_tpu_torch.control import BaselineDraws
    from ealv_tpu_torch.runtime import TickDraws, TrainDraws
    lims = cfg.robot_lim if lims is None else lims
    d = lims.shape[0]
    samples = rng.uniform(lims[:, 0], lims[:, 1], (cfg.num_target_samples, d))
    grade = rng.uniform(cfg.robot_lim[:, 0], cfg.robot_lim[:, 1],
                        (cfg.num_target_samples, cfg.s_dim))
    filled = rng.permutation(k + 1)
    rest = k + 1 + rng.permutation(cfg.traj_buffer_capacity - k - 1)
    hist = np.concatenate([filled, rest])[: cfg.num_traj_samples]
    steps, B = cfg.num_learning_opt, cfg.batch_size
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)
    train = [TrainDraws(idx=t(rng.integers(0, k + 1, (steps, B)), torch.int64),
                        idx2=t(rng.integers(0, k + 1, (steps, B)), torch.int64),
                        eps=t(rng.standard_normal((steps, B, cfg.z_dim))))]
    baseline = BaselineDraws(cands=t(rng.uniform(size=(10, cfg.s_dim))),
                             state_u=t(rng.uniform(size=cfg.s_dim)))
    return TickDraws(samples=t(samples), hist_idx=t(hist, torch.int64), train=train,
                     grade_samples=[t(grade)], baseline=baseline)


TOY = dict(states="xyw", num_target_samples=64, num_traj_samples=100,
           image_dim=(24, 24, 3), batch_size=8, num_learning_opt=2, compute_dtype="float32")
# the toy tick paths held card against CPU: the default; the brightness
# state with the force variant and the z-ensemble; the two baselines
AGREEMENT_TICKS = {"xyw": {}, "xywb force z-ensemble": dict(states="xywb", learn_force=True,
                                                            use_z_ensemble=True),
                   "randomWalk xywb": dict(states="xywb", explr_method="randomWalk"),
                   "uniform": dict(explr_method="uniform")}


def _agree(runs, what):
    """Hold the card's list of outputs against the CPU's: f32 on both
    sides; the card sums in other orders and its convs take other
    algorithms, and one Adam step amplifies near-zero gradients. Returns
    the largest difference."""
    import torch
    err = 0.0
    for k, (a, b) in enumerate(zip(runs["cpu"], runs["cuda"])):
        for key in a:
            torch.testing.assert_close(b[key], a[key], rtol=1e-3, atol=1e-4,
                                       msg=lambda m: f"{what}, step {k} {key}: {m}")
            err = max(err, _max_err([b[key].float()], [a[key].float()]))
    return err


def phase_agreement():
    """Two toy ticks of each path of AGREEMENT_TICKS on the card and on the
    CPU with the same weights and fed draws: pose, brightness, plan (or the
    baseline's state), cost, loss, beta, gamma and the z ring."""
    from ealv_tpu_torch.utils.config import ExperimentConfig
    from ealv_tpu_torch.runtime import Experiment

    for what, kw in AGREEMENT_TICKS.items():
        cfg = ExperimentConfig(**{**TOY, **kw})
        runs = {}
        for dev in ("cpu", "cuda"):
            exp = Experiment(cfg, train_calls_per_tick=1, train_every=1, device=dev)
            es = exp.init(seed=0)
            rng = np.random.default_rng(1)
            out = []
            for k in range(2):
                es, info = exp.tick(es, _toy_draws(cfg, k, rng, dev))
                out.append({"pose": es.env.pose, "brightness": es.env.brightness,
                            "plan": es.pstate.x if exp.use_baseline else es.pstate.u,
                            "cost": info["ergodic_cost"], "loss": info["loss"],
                            "beta": info["beta"], "gamma": info["gamma"],
                            "z ring": es.mstate.z_buff})
            runs[dev] = [{k: v.detach().cpu() for k, v in o.items()} for o in out]
        err = _agree(runs, what)
        print(f"[agreement] 2 toy ticks ({what}), cuda vs cpu with fed draws: pose, "
              f"brightness, plan, ergodic cost, beta/gamma, loss and z ring agree (rtol 1e-3, "
              f"atol 1e-4), max|diff| {err:.3e}; loss {float(runs['cuda'][1]['loss']):.6f} "
              f"vs {float(runs['cpu'][1]['loss']):.6f}")


def _eval_target(kind, d, dev, img=(24, 24, 3), compute_dtype="float32", seed=0):
    """(pdf_fn, ctx) of an injected target over d explored states: an
    ExplrDist mixture of three pushes, or a frozen CVAE (weights from
    ``seed``) seeded with one random sample, its uncertainty as the pdf."""
    import torch
    from ealv_tpu_torch.control import ExplrDist
    from ealv_tpu_torch.models import CVAE, init_model_state, update_dist
    rng = np.random.default_rng(3)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    if kind == "explr":
        dist = ExplrDist.create(8, d, device=dev)
        for _ in range(3):
            dist = dist.push(t(rng.uniform(-0.6, 0.6, d)), t(rng.uniform(0.02, 0.08, d)))
        return (lambda ctx, s: ctx.pdf(s)), dist
    model = CVAE(img_dim=img, s_dim=d, compute_dtype=getattr(torch, compute_dtype))
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model.to(dev)
    ms, _ = update_dist(model, init_model_state(model, dev), t(rng.uniform(-1, 1, d)),
                        t(rng.uniform(0, 1, img)))
    return (lambda ctx, s: ctx[0].pdf(ctx[1], s)), (model, ms)


def phase_eval_agreement():
    """Three toy EvalExperiment ticks toward an ExplrDist target and toward
    a frozen CVAE's pdf, card against CPU with fed draws; then
    evaluate_test_set on a toy set."""
    import torch
    from ealv_tpu_torch.models import CVAE
    from ealv_tpu_torch.runtime import EvalExperiment, evaluate_test_set
    from ealv_tpu_torch.utils.config import ExperimentConfig

    cfg = ExperimentConfig(**TOY)
    for kind in ("explr", "cvae"):
        runs = {}
        for dev in ("cpu", "cuda"):
            fn, ctx = _eval_target(kind, cfg.s_dim, dev)
            ev_exp = EvalExperiment(cfg, fn, device=dev)
            ev = ev_exp.init([0.45, 0.03, 0.35, 3.14, 0.0, 0.2], seed=2)
            rng = np.random.default_rng(5)
            out = []
            for k in range(3):
                draws = _toy_draws(cfg, k, rng, dev, lims=ev.pstate.lims.cpu().numpy())
                ev, obs = ev_exp.tick(ev, ctx, draws)
                out.append({"pose": ev.env.pose, "robot_state": obs["robot_state"],
                            "plan": ev.pstate.u, "cost": obs["cost"]})
            runs[dev] = [{k: v.detach().cpu() for k, v in o.items()} for o in out]
        err = _agree(runs, f"eval {kind}")
        print(f"[agreement] 3 toy EvalExperiment ticks ({kind} target), cuda vs cpu with fed "
              f"draws: pose, robot state, plan and cost agree (rtol 1e-3, atol 1e-4), "
              f"max|diff| {err:.3e}")
    rng = np.random.default_rng(6)
    poses = rng.uniform(-1, 1, (9, 3)).astype(np.float32)
    images = rng.uniform(0, 1, (9, 24, 24, 3)).astype(np.float32)
    got = {}
    for dev in ("cpu", "cuda"):
        model = CVAE(img_dim=(24, 24, 3), s_dim=3)
        model.reset_parameters(torch.Generator().manual_seed(4))
        got[dev] = evaluate_test_set(model.to(dev), poses, images)
    err = 0.0
    for key in ("recon_mse", "recon_nll", "z_mu", "z_logvar", "img_pred"):
        np.testing.assert_allclose(got["cuda"][key], got["cpu"][key], rtol=1e-3, atol=1e-4,
                                   err_msg=key)
        err = max(err, float(np.abs(got["cuda"][key] - got["cpu"][key]).max()))
    if got["cuda"]["active_units"] != got["cpu"]["active_units"]:
        raise RuntimeError(f"active units {got['cuda']['active_units']} vs "
                           f"{got['cpu']['active_units']}")
    print(f"[agreement] evaluate_test_set on 9 toy samples, cuda vs cpu: MSE, NLL, latents "
          f"and images agree (rtol 1e-3, atol 1e-4), max|diff| {err:.3e}; mean NLL "
          f"{got['cuda']['mean_nll']:.5f} vs {got['cpu']['mean_nll']:.5f}")


# the planner agreement phase: (dynamics, policy, config flags) on a toy
# scene (horizon 10, 256 samples, 64 history points); every model and
# policy at the default flags, then every mode on the SO(3) roll model
PLANNER_STATES = {"single": "xy", "double": "xy", "speed": "xy", "roll": "xyzrpw"}
PLANNER_MODES = [{"full_cost": True}, {"fixed_lam": True}, {"ctrl_app_search": False},
                 {"add_recent_history": True}, {"sample_near_current_loc": True}]
PLANNER_CASES = ([(dyn, pol, {}) for dyn in ("double", "speed", "roll")
                  for pol in ("Roll", "Zero", "BarrierPush", "LQR")]
                 + [("single", pol, {}) for pol in ("Roll", "Zero", "LQR")]
                 + [("roll", "Roll", mode) for mode in PLANNER_MODES])


def _toy_plan(dyn_name, policy, mode, dev, H=10, N=256, M=64):
    """One planner call (``plan`` with fed draws, so the planner appends
    the recent history itself) on a toy scene made from seed 7: limits,
    a start state (a positive roll for the roll model), a non-zero initial
    plan, a Gaussian target, 64 visited states and the draws. Returns the
    plan u, the ergodic cost, R after rolling the plan out from the start,
    and the K1 launches of the call."""
    import torch
    from ealv_tpu_torch import control as tc
    from ealv_tpu_torch.ops import footprint_and_spread

    states = PLANNER_STATES[dyn_name]
    d = len(states)
    if dyn_name == "single":
        dyn = tc.SingleIntegrator(d, d, 0.1, device=dev)
    else:
        dyn = tc.make_dynamics(states, 0.1, use_magnitude=dyn_name == "speed", device=dev)
    n = dyn.num_states
    rng = np.random.default_rng(7)
    lim = np.array([[-0.75, 0.75] if c in "rpw" else [-1.0, 1.0] for c in states])
    ctrl = np.array([[-0.5, 0.5] if c in "rp" else [-1.25, 1.25] for c in states])
    x0 = np.zeros(n)
    x0[:d] = rng.uniform(-0.5, 0.5, d)
    if "r" in states:
        x0[states.index("r")] = 0.4
    hist = np.zeros((M, n))
    hist[:, :d] = np.clip(np.cumsum(rng.normal(0.0, 0.05, (M, d)), 0) + x0[:d],
                          lim[:, 0] * 0.9, lim[:, 1] * 0.9)
    if n > d:
        hist[:, d: 2 * d] = rng.normal(0.0, 0.1, (M, d))
    if n > 2 * d:
        hist[:, 2 * d:] = np.abs(hist[:, d: 2 * d])
    u0 = rng.normal(0.0, 0.2, (H, d))
    mu = rng.uniform(lim[:, 0] * 0.6, lim[:, 1] * 0.6)
    var = rng.uniform(0.05, 0.1, d)
    samples = rng.uniform(lim[:, 0] * 1.15, lim[:, 1] * 1.15, (N, d))
    if mode.get("sample_near_current_loc"):
        n_near = N - int(N * 0.9)
        samples[-n_near:] = rng.normal(0.0, 0.2, (n_near, d)) + x0[:d]
    hist_idx = rng.permutation(M)

    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    mu_t, var_t = t(mu), t(var)
    cfg = tc.KlergConfig(horizon=H, num_target_samples=N, num_traj_samples=M, R=0.5,
                         std=0.05, **mode)
    planner = tc.KlergPlanner(cfg, dyn, tc.make_policy(policy, dyn, H),
                              lambda _c, s: torch.exp(-0.5 * ((s - mu_t) ** 2 / var_t).sum(-1)),
                              states, explr_locs=list(range(d)), device=dev)
    barrier, _ = tc.setup_barrier(states, t(lim), t(ctrl), list(range(d)))
    if dyn_name == "single":  # its state holds the positions alone
        barrier = barrier.truncate(d)
    ps = planner.init_state(t(x0), t(lim), barrier, buffer_capacity=256, explr_lim_scale=1.15)
    for h in hist:
        ps.memory.push(t(h))
    ps = dataclasses.replace(ps, u=t(u0))
    before = footprint_and_spread.launches
    ps, info = planner.plan(ps, None, samples=t(samples),
                            hist_idx=torch.as_tensor(hist_idx, device=dev))
    launches = footprint_and_spread.launches - before
    s = ps.dyn
    for k in range(H):
        s = dyn.step(s, ps.u[k])
    return ps.u.cpu(), info["cost"].cpu(), s.R.cpu(), launches


def phase_planner_agreement():
    """Every dynamics model, policy and mode of the planner: one toy call
    on the card and on the CPU with the same fed draws (f32, TF32 off);
    plan and cost at rtol 1e-3, atol 1e-4, R at atol 1e-5 and orthonormal
    to 1e-5 on both; 13 K1 launches per call on the card in every mode."""
    import torch
    worst = {"u": 0.0, "cost": 0.0, "R": 0.0, "RtR": 0.0}
    for dyn_name, policy, mode in PLANNER_CASES:
        what = f"{dyn_name} / {policy} / {mode or 'default'}"
        u_c, cost_c, R_c, _ = _toy_plan(dyn_name, policy, mode, "cpu")
        u_g, cost_g, R_g, launches = _toy_plan(dyn_name, policy, mode, "cuda")
        torch.testing.assert_close(u_g, u_c, rtol=1e-3, atol=1e-4, msg=lambda m: f"{what}: u {m}")
        torch.testing.assert_close(cost_g, cost_c, rtol=1e-3, atol=0.0,
                                   msg=lambda m: f"{what}: cost {m}")
        torch.testing.assert_close(R_g, R_c, rtol=0.0, atol=1e-5, msg=lambda m: f"{what}: R {m}")
        rtr = max(float((R.T @ R - torch.eye(3)).abs().max()) for R in (R_c, R_g))
        if rtr > 1e-5:
            raise RuntimeError(f"{what}: R off orthonormal by {rtr:.2e}")
        if launches != 13:
            raise RuntimeError(f"{what}: {launches} K1 launches in one plan, expected 13")
        if float(u_c.abs().max()) == 0.0:
            raise RuntimeError(f"{what}: the plan is all zeros")
        for key, err in (("u", _max_err([u_g], [u_c])), ("cost", float((cost_g - cost_c).abs())),
                         ("R", _max_err([R_g], [R_c])), ("RtR", rtr)):
            worst[key] = max(worst[key], err)
    print(f"[agreement] planner, {len(PLANNER_CASES)} toy calls (4 dynamics x 4 policies, 5 "
          f"modes on the roll model), cuda vs cpu with fed draws: max|du| {worst['u']:.3e}, "
          f"max|dcost| {worst['cost']:.3e}, max|dR| {worst['R']:.3e}, max|R^T R - I| "
          f"{worst['RtR']:.3e}; 13 K1 launches per call on the card in every mode")


def _train_draws(cfg, n_filled, rng, dev):
    import torch
    from ealv_tpu_torch.runtime import TrainDraws
    steps, B = cfg.num_learning_opt, cfg.batch_size
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)
    return TrainDraws(idx=t(rng.integers(0, n_filled, (steps, B)), torch.int64),
                      idx2=t(rng.integers(0, n_filled, (steps, B)), torch.int64),
                      eps=t(rng.standard_normal((steps, B, cfg.z_dim))))


def _trainer_experiment(cfg, dev, kernels: bool):
    """An Experiment with both trainer kernels on (fast_encoder_grads=
    "pallas", fused_adam=True) or both off, weights from seed 0."""
    from ealv_tpu_torch.runtime import Experiment
    cfg = dataclasses.replace(cfg, fast_encoder_grads="pallas" if kernels else False)
    exp = Experiment(cfg, train_calls_per_tick=1, train_every=3, device=dev)
    exp.trainer = dataclasses.replace(exp.trainer, fused_adam=kernels)
    return exp, exp.init(seed=0)


def phase_trainer_agreement():
    """One toy trainer call with both trainer kernels on, on the card and
    on the CPU, from the same weights, ring and fed draws (f32, TF32 off)."""
    import torch
    from ealv_tpu_torch.ops import adam as tad, wgrad as twg
    from ealv_tpu_torch.runtime import train_call
    from ealv_tpu_torch.utils.config import ExperimentConfig

    cfg = ExperimentConfig(states="xyw", num_target_samples=64, num_traj_samples=100,
                           image_dim=(24, 24, 3), batch_size=8, num_learning_opt=2,
                           compute_dtype="float32")
    rng = np.random.default_rng(2)
    xs = rng.uniform(cfg.robot_lim[:, 0], cfg.robot_lim[:, 1], (12, cfg.s_dim))
    ys = rng.uniform(0, 1, (12, *cfg.image_dim))
    draws = _train_draws(cfg, 12, rng, "cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        exp, es = _trainer_experiment(cfg, dev, kernels=True)
        t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
        for x, y in zip(xs, ys):
            es.buf.push(t(x), t(y))
        k2, k3 = tad.adam_apply.launches, twg.conv_wgrad_direct.launches
        met = train_call(exp.trainer, es.model, es.opt, es.buf, t(0.01), t(0.5),
                         draws=dataclasses.replace(
                             draws, **{f: getattr(draws, f).to(dev) for f in ("idx", "idx2", "eps")}))
        k2, k3 = tad.adam_apply.launches - k2, twg.conv_wgrad_direct.launches - k3
        out[dev] = (met["loss"].cpu(), [p.detach().cpu() for p in es.model.parameters()])
        if dev == "cuda" and (k2, k3) != (2, 6):
            raise RuntimeError(f"toy trainer call made {k2} K2 launches and {k3} K3 "
                               "calls, expected 2 and 6")
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-3, atol=1e-4)
    perr = _max_err(out["cuda"][1], out["cpu"][1])
    print(f"[agreement] toy trainer call with K2 and K3 on, cuda vs cpu with fed draws: "
          f"losses {out['cuda'][0].tolist()} vs {out['cpu'][0].tolist()} (rtol 1e-3, "
          f"atol 1e-4); max|param diff| {perr:.3e}")


def _profiled_call(call):
    """One call under torch.profiler, ending in a synchronize: its host
    clock; the device's busy time, the union of its kernels' and copies'
    intervals; the plain sum of those intervals (more than the union only
    if some overlapped); the sum of ``self_device_time_total`` over
    ``key_averages()``'s device rows (a second reading of the same
    intervals); and the number of intervals. All in ms but the count."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    on_card = torch.autograd.DeviceType.CUDA
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == on_card)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy, end = busy + b - max(a, end), b
    summed = sum(b - a for a, b in spans)
    averaged = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == on_card)
    return wall, busy / 1e3, summed / 1e3, averaged / 1e3, len(spans)


def phase_trainer_production(n_filled=200, rounds=2):
    """One production-size trainer call with the trainer kernels on and off
    from the same weights, ring and fed draws: 25 losses within the bf16
    tolerance. Then ms per trainer call on and off, interleaved (on, off,
    off, on), host clock around calls that end in a synchronize, in which
    K2's launch cache must not miss; then one call of each, twice (on,
    off, off, on), under torch.profiler for the device's busy time."""
    import torch
    from ealv_tpu_torch.ops import adam as tad
    from ealv_tpu_torch.runtime import train_call
    from ealv_tpu_torch.utils.config import ExperimentConfig

    cfg = ExperimentConfig(**PRODUCTION)
    runs = {on: _trainer_experiment(cfg, "cuda", kernels=on) for on in (True, False)}
    ring = runs[True][1].buf
    g = torch.Generator(device="cuda").manual_seed(3)
    lo, hi = runs[True][0].robot_lim[:, 0], runs[True][0].robot_lim[:, 1]
    for _ in range(n_filled):
        ring.push(torch.rand(cfg.s_dim, generator=g, device="cuda") * (hi - lo) + lo,
                  torch.rand(cfg.image_dim, generator=g, device="cuda"))
    runs[False][1].buf = ring
    draws = _train_draws(cfg, n_filled, np.random.default_rng(4), "cuda")
    beta, gamma = torch.tensor(0.005, device="cuda"), torch.tensor(0.5, device="cuda")
    losses = {}
    for on, (exp, es) in runs.items():
        met = train_call(exp.trainer, es.model, es.opt, es.buf, beta, gamma, draws=draws)
        losses[on] = met["loss"].cpu()
    # the first step's loss sees the same weights: only the forward's bias
    # add differs in rounding (bf16). Later steps carry forward dW rounded to
    # bf16 from sums in other orders and Adam formulas that differ in the
    # last f32 bits; a rounding-level gradient moves its weight by up to lr
    # with either sign, so even the Adam formulas alone move the 25th loss by
    # 3e-2 at this config (CPU float arithmetic, same draws)
    torch.testing.assert_close(losses[True][0], losses[False][0], rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(losses[True], losses[False], rtol=5e-2, atol=5e-2)

    def call(on):
        exp, es = runs[on]
        train_call(exp.trainer, es.model, es.opt, es.buf, beta, gamma, generator=es.gen)

    times = {True: [], False: []}
    builds = tad.adam_apply.builds
    for _ in range(rounds):
        for on in (True, False, False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call(on)
            torch.cuda.synchronize()
            times[on].append((time.perf_counter() - t0) * 1e3)
    builds = tad.adam_apply.builds - builds
    if builds:
        raise RuntimeError(f"K2's launch cache missed {builds} times in {50 * rounds} "
                           "steps with the same parameters")
    on_ms, off_ms = float(np.median(times[True])), float(np.median(times[False]))
    print(f"[agreement] production trainer call, kernels on vs off, same weights and "
          f"draws: 25 losses agree (first at 1e-2, all at rtol 5e-2, atol 5e-2), max|diff| "
          f"{float((losses[True] - losses[False]).abs().max()):.3e}, last loss "
          f"{float(losses[True][-1]):.4f} vs {float(losses[False][-1]):.4f}")
    print(f"[trainer] ms per 25-step trainer call at production size: kernels on "
          f"{on_ms:.2f} (K2 + K3), off {off_ms:.2f} (torch.optim.Adam + cuDNN wgrad); "
          f"median of {2 * rounds} each, interleaved on/off/off/on, host clock "
          f"{[round(x, 2) for x in times[True]]} / {[round(x, 2) for x in times[False]]}; "
          f"K2 launch cache built {builds} times in {50 * rounds} steps")
    for on in (True, False, False, True):
        wall, busy, summed, averaged, n = _profiled_call(lambda: call(on))
        print(f"[trainer] profiled trainer call, kernels {'on' if on else 'off'}: host "
              f"{wall:.2f} ms; device busy {busy:.2f} ms (union of {n} kernel and copy "
              f"intervals; {100 * (1 - busy / wall):.1f}% idle), their sum {summed:.2f} "
              f"ms, key_averages sum {averaged:.2f} ms")
    return on_ms, off_ms


def phase_main_path(states="xyw", n_warm=6, n_timed=24):
    """The tick path at production size over ``states``: warm ticks, then
    timed ones with exactly 13 K1 launches each; then three ticks (one
    trainer call) and one plan_step (sync and plan) under torch.profiler,
    for the device's busy time and the number of device intervals beside
    the host clock. Returns (launches, ms/tick, peak MiB)."""
    import torch
    from ealv_tpu_torch.utils.config import ExperimentConfig
    from ealv_tpu_torch.runtime import Experiment
    from ealv_tpu_torch.ops import footprint_and_spread

    cfg = ExperimentConfig(**{**PRODUCTION, "states": states})
    exp = Experiment(cfg, train_calls_per_tick=1, train_every=3, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    es = exp.init(seed=0)
    for _ in range(n_warm):
        es, _ = exp.tick(es)
    torch.cuda.synchronize()

    footprint_and_spread.launches = 0
    t0 = time.perf_counter()
    es, infos = exp.run_chunk(es, n_timed)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_timed
    launches = footprint_and_spread.launches

    losses = infos["loss"].cpu()
    costs = infos["ergodic_cost"].cpu()
    trained = losses[losses != 0]
    if launches != 13 * n_timed:
        raise RuntimeError(f"footprint kernel launched {launches} times in "
                           f"{n_timed} ticks, expected {13 * n_timed}")
    if not (torch.isfinite(costs).all() and torch.isfinite(losses).all()):
        raise RuntimeError(f"non-finite costs {costs} or losses {losses}")
    if es.learning_ind <= 0 or trained.numel() == 0:
        raise RuntimeError(f"the trainer never ran (learning_ind {es.learning_ind})")
    if not all(p.is_cuda for p in es.model.parameters()) or not es.buf.y.is_cuda:
        raise RuntimeError("parameters or the replay ring left the card")
    if es.buf.y.dtype != torch.bfloat16 or es.buf.size != n_warm + n_timed:
        raise RuntimeError(f"replay ring {es.buf.y.dtype}, size {es.buf.size}")
    R = es.pstate.dyn.R
    rtr = float((R.T @ R - torch.eye(3, device=R.device)).abs().max())
    if not rtr < 1e-5:
        raise RuntimeError(f"the planner's R is off orthonormal by {rtr}")
    peak = torch.cuda.max_memory_allocated() / 2**20
    print(f"[main path {states}] {n_timed} ticks after {n_warm} warm: {dt * 1e3:.2f} "
          f"ms/tick = {1.0 / dt:.2f} Hz | last loss {float(trained[-1]):.4f} | ergodic cost "
          f"{float(costs[-1]):.4f} | learning_ind {es.learning_ind} | "
          f"K1 launches {launches} (13/tick) | planner |R^T R - I| {rtr:.1e} | "
          f"peak memory {peak:.1f} MiB")
    for what, call in (("3 ticks (one trainer call)", lambda: exp.run_chunk(es, 3)),
                       ("1 plan_step (sync + plan)",
                        lambda: exp.plan_step(es, exp._measured_robot_state(es.env)))):
        wall, busy, _, _, n = _profiled_call(call)
        print(f"[main path {states}] profiled {what}: host {wall:.2f} ms; device busy "
              f"{busy:.2f} ms ({100 * (1 - busy / wall):.1f}% idle) in {n} kernel and copy "
              f"intervals")
    return launches, dt * 1e3, peak


def _ensemble_plain(model, mstate, samples):
    """The ensemble pdf's plain version: one decode per ring latent, the
    logvars averaged over the ring, then the pdf's exp and max."""
    import dataclasses as dc
    import torch
    from ealv_tpu_torch.models.cvae import LOGVAR_LIMS
    with torch.no_grad():
        logvar = torch.stack([model.decode_samples(dc.replace(mstate, z=z), samples)[0]
                              for z in mstate.z_buff]).mean(0)
    return torch.exp(logvar.clamp(*LOGVAR_LIMS)).amax(1)


def phase_variant_path(n_warm=6, n_timed=12):
    """The experiment's options together at production width: states
    "xywb" (the brightness state), the force variant, the z-ensemble target
    (5 x 2000 decoder rows a plan) and both trainer kernels on; warm ticks,
    then timed ones with K1, K2 and K3 counted (13 K1 launches a tick and
    one per trainer call, whose entropy grade takes a fresh plain decode
    under the ensemble; 25 K2 and 75 K3 a trainer call). Then the ensemble
    pdf at 2000 samples against its plain decode-and-average, in the bf16
    model and in an f32 copy, and both timed. Returns (ms/tick, peak MiB,
    (K1, K2, K3 launches))."""
    import torch
    from ealv_tpu_torch.ops import adam as tad, footprint_and_spread, wgrad as twg
    from ealv_tpu_torch.runtime import Experiment
    from ealv_tpu_torch.utils.config import ExperimentConfig
    from ealv_tpu_torch.utils.timing import device_ms, host_ms

    cfg = ExperimentConfig(**{**PRODUCTION, "states": "xywb"}, learn_force=True,
                           use_z_ensemble=True, fast_encoder_grads="pallas")
    exp = Experiment(cfg, train_calls_per_tick=1, train_every=3, device="cuda")
    exp.trainer = dataclasses.replace(exp.trainer, fused_adam=True)
    torch.cuda.reset_peak_memory_stats()
    es = exp.init(seed=0)
    for _ in range(n_warm):
        es, _ = exp.tick(es)
    torch.cuda.synchronize()
    footprint_and_spread.launches = tad.adam_apply.launches = 0
    twg.conv_wgrad_direct.launches = 0
    calls0 = es.learning_ind
    t0 = time.perf_counter()
    es, infos = exp.run_chunk(es, n_timed)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_timed
    k1, k2, k3 = (footprint_and_spread.launches, tad.adam_apply.launches,
                  twg.conv_wgrad_direct.launches)
    calls = es.learning_ind - calls0
    peak = torch.cuda.max_memory_allocated() / 2**20
    if calls <= 0:
        raise RuntimeError("the variant path made no trainer call in the timed ticks")
    if (k1, k2, k3) != (13 * n_timed + calls, 25 * calls, 75 * calls):
        raise RuntimeError(f"variant path: {calls} trainer calls in {n_timed} ticks made "
                           f"K1 {k1}, K2 {k2}, K3 {k3} launches; expected "
                           f"{13 * n_timed + calls}, {25 * calls}, {75 * calls}")
    losses, costs = infos["loss"].cpu(), infos["ergodic_cost"].cpu()
    if not (torch.isfinite(losses).all() and torch.isfinite(costs).all()):
        raise RuntimeError(f"non-finite losses {losses} or costs {costs}")
    b = es.env.brightness
    if not (torch.isfinite(b) and es.buf.x.shape[1] == 4 and es.model.learn_force):
        raise RuntimeError(f"brightness {b}, ring width {es.buf.x.shape[1]}")
    if float(es.mstate.z_buff.abs().amin(1).min()) == 0.0:
        raise RuntimeError("the z ring is not full after the warm and timed ticks")
    print(f"[variant path] xywb, learn_force, use_z_ensemble, K2 and K3 on: {n_timed} ticks "
          f"after {n_warm} warm: {dt * 1e3:.2f} ms/tick = {1.0 / dt:.2f} Hz | {calls} trainer "
          f"calls | K1 {k1} (13/tick + 1/call) | K2 {k2} (25/call) | K3 {k3} (75/call) | last "
          f"loss {float(losses[losses != 0][-1]):.4f} | brightness {float(b):.4f} | peak "
          f"memory {peak:.1f} MiB")

    g = torch.Generator(device="cuda").manual_seed(7)
    lo, hi = exp.robot_lim[:, 0], exp.robot_lim[:, 1]
    samples = torch.rand((cfg.num_target_samples, 4), generator=g, device="cuda") \
        * (hi - lo) + lo
    model, ms = es.model, es.mstate
    f32 = exp.make_model().cuda()
    f32.compute_dtype = torch.float32
    f32.load_state_dict(model.state_dict())
    for name, m, tol in (("bf16", model, dict(rtol=3e-2, atol=1e-6)),
                         ("f32", f32, dict(rtol=1e-4, atol=1e-6))):
        ens = lambda: m.pdf(ms, samples, use_z_ensemble=True)
        plain = lambda: _ensemble_plain(m, ms, samples)
        got, want = ens(), plain()
        torch.testing.assert_close(got, want, **tol, msg=lambda e: f"ensemble pdf {name}: {e}")
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ens()
        torch.cuda.synchronize()
        transient = (torch.cuda.max_memory_allocated() - base) / 2**20
        err, e_ms, p_ms = (float((got - want).abs().max()), device_ms(ens, reps=11, inner=10),
                           device_ms(plain, reps=11, inner=10))
        h_ms = host_ms(ens, inner=10)
        single_ms = device_ms(lambda: m.pdf(ms, samples), reps=11, inner=10)
        print(f"[variant path] ensemble pdf at 2000 samples ({name} model): max|ensemble-plain| "
              f"{err:.3e} (rtol {tol['rtol']}); device ms: 10,000-row batch {e_ms:.4f}, five "
              f"2000-row decodes {p_ms:.4f}, one 2000-row decode (no ensemble) {single_ms:.4f}; "
              f"host clock {h_ms:.4f} ms; transient memory {transient:.1f} MiB")
    return dt * 1e3, peak, (k1, k2, k3)


def phase_eval_path(n_warm=2, n_timed=12, n_points=25):
    """The evaluation runtime at production size: a 25-point grid test set
    collected at 180x180 with the port's collector on the card, then 12
    timed EvalExperiment ticks (after 2 warm) toward a frozen production
    CVAE's pdf (weights from seed 0, seeded with the set's first sample),
    12 K1 launches a plan; evaluate_test_set over the set; and baseline
    ticks, whose plan_step makes no K1 launch (a trainer call makes one,
    for its entropy grade). Returns (ms per eval tick, launches per plan)."""
    import torch
    from ealv_tpu_torch.models import CVAE, init_model_state, update_dist
    from ealv_tpu_torch.ops import footprint_and_spread
    from ealv_tpu_torch.runtime import EvalExperiment, Experiment, evaluate_test_set
    from ealv_tpu_torch.scripts.collect_test_set import collect
    from ealv_tpu_torch.utils.config import ExperimentConfig
    from ealv_tpu_torch.utils.states import ws_conversion

    cfg = ExperimentConfig(**PRODUCTION)
    t0 = time.perf_counter()
    poses, images, forces = collect("grid", n_points, img=cfg.image_dim[0], device="cuda")
    collect_s = time.perf_counter() - t0
    if images.shape != (n_points, *cfg.image_dim) or not np.isfinite(images).all():
        raise RuntimeError(f"test set images {images.shape}")
    t = lambda a: torch.as_tensor(a, device="cuda")
    poses_r = ws_conversion(t(poses[:, cfg.sel()]), t(cfg.tray_lim), t(cfg.robot_lim))
    model = CVAE(img_dim=cfg.image_dim, s_dim=cfg.s_dim, hidden_dim=cfg.model_hidden(),
                 compute_dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.cuda()
    ms, _ = update_dist(model, init_model_state(model, "cuda"), poses_r[0], t(images[0]))
    ctx = (model, ms)
    ev_exp = EvalExperiment(cfg, lambda c, s: c[0].pdf(c[1], s), device="cuda")
    ev = ev_exp.init(seed=0)
    for _ in range(n_warm):
        ev, _ = ev_exp.tick(ev, ctx)
    torch.cuda.synchronize()
    footprint_and_spread.launches = 0
    t0 = time.perf_counter()
    costs = []
    for _ in range(n_timed):
        ev, obs = ev_exp.tick(ev, ctx)
        costs.append(obs["cost"])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_timed
    per_plan = footprint_and_spread.launches / n_timed
    if footprint_and_spread.launches != 12 * n_timed:
        raise RuntimeError(f"eval path: {footprint_and_spread.launches} K1 launches in "
                           f"{n_timed} ticks, expected {12 * n_timed}")
    costs = torch.stack(costs).cpu()
    if not torch.isfinite(costs).all() or obs["image"].shape != cfg.image_dim:
        raise RuntimeError(f"eval costs {costs}, image {tuple(obs['image'].shape)}")
    t0 = time.perf_counter()
    met = evaluate_test_set(model, poses_r, images, forces)
    eval_s = time.perf_counter() - t0
    if not (np.isfinite(met["recon_nll"]).all() and met["img_pred"].shape == images.shape):
        raise RuntimeError(f"evaluate_test_set: {met['recon_nll']}")
    print(f"[eval path] {n_points}-point grid test set at {cfg.image_dim[0]}x"
          f"{cfg.image_dim[1]} collected in {collect_s:.2f} s | {n_timed} EvalExperiment ticks "
          f"after {n_warm} warm, frozen production CVAE (bf16, seed 0) as the target: "
          f"{dt * 1e3:.2f} ms/tick | K1 {per_plan:.0f} per plan | last cost "
          f"{float(costs[-1]):.4f} | evaluate_test_set over the set in {eval_s:.3f} s: mean "
          f"MSE {met['mean_mse']:.5f}, mean NLL {met['mean_nll']:.5f}, active units "
          f"{met['active_units']}")

    for method in ("randomWalk", "uniform"):
        exp = Experiment(ExperimentConfig(**{**PRODUCTION, "states": "xywb"},
                                          explr_method=method),
                         train_calls_per_tick=1, train_every=3, device="cuda")
        es = exp.init(seed=0)
        footprint_and_spread.launches = 0
        for _ in range(3):
            exp.plan_step(es, exp._measured_robot_state(es.env))
        planned = footprint_and_spread.launches
        calls0 = es.learning_ind
        t0 = time.perf_counter()
        es, infos = exp.run_chunk(es, 6)
        torch.cuda.synchronize()
        b_ms = (time.perf_counter() - t0) / 6 * 1e3
        calls = es.learning_ind - calls0
        ticked = footprint_and_spread.launches - planned
        if planned != 0 or ticked != calls or calls <= 0:
            raise RuntimeError(f"{method}: {planned} K1 launches in 3 plan_steps (expected "
                               f"0), {ticked} in 6 ticks with {calls} trainer calls")
        if not torch.isfinite(infos["loss"]).all():
            raise RuntimeError(f"{method}: losses {infos['loss']}")
        print(f"[eval path] baseline {method} at xywb, production size: 0 K1 launches in 3 "
              f"plan_steps; {ticked} in 6 ticks = one per trainer call ({calls}, the entropy "
              f"grade); {b_ms:.2f} ms/tick (the first ticks, cold)")
    return dt * 1e3, per_plan


def phase_learning_path(steps=12, chunk=6, train_every=3, save_rate=6):
    """The learning path at production size through the port's run entry,
    with both trainer kernels on; the postexplr checkpoint is reloaded into
    a fresh Experiment and compared tensor for tensor."""
    import torch
    from ealv_tpu_torch.ops import adam as tad, footprint_and_spread, wgrad as twg
    from ealv_tpu_torch.runtime.checkpoint import load_checkpoint, state_leaves
    from ealv_tpu_torch.runtime.metrics import MetricsLog, run_dir
    from ealv_tpu_torch.scripts import run_experiment as cli

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        args = cli.build_parser().parse_args([
            "--steps", str(steps), "--chunk", str(chunk), "--train-every",
            str(train_every), "--save-rate", str(save_rate), "--out", tmp,
            "--device", "cuda"])

        def experiment():
            cfg = dataclasses.replace(cli.make_config(args), fast_encoder_grads="pallas")
            exp = cli.make_experiment(cfg, args)
            exp.trainer = dataclasses.replace(exp.trainer, fused_adam=True)
            return exp

        exp = experiment()
        dirp = run_dir(tmp, "synth", args.method, args.seed)
        ml = MetricsLog(dirp, echo=False)
        es = exp.init(seed=args.seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        footprint_and_spread.launches = 0
        tad.adam_apply.launches = 0
        twg.conv_wgrad_direct.launches = 0
        t0 = time.perf_counter()
        es = cli.run(exp, args, dirp, ml, es=es)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1, k2, k3 = (footprint_and_spread.launches, tad.adam_apply.launches,
                      twg.conv_wgrad_direct.launches)
        peak = torch.cuda.max_memory_allocated()

        calls = es.learning_ind
        target = int(steps * exp.cfg.target_learning_rate)
        losses = np.concatenate([np.atleast_1d(x) for x in ml.series["loss"]])
        n_post = losses.size - steps  # the ticks log one loss each
        if es.explr_step != steps or calls != target:
            raise RuntimeError(f"run ended at explr_step {es.explr_step}, "
                               f"learning_ind {calls}; expected {steps}, {target}")
        if k2 != 25 * calls or k3 != 75 * calls:
            raise RuntimeError(f"{calls} trainer calls made {k2} K2 launches and {k3} "
                               f"K3 calls; expected {25 * calls} and {75 * calls}")
        if k1 != 13 * steps + n_post:
            raise RuntimeError(f"K1 launched {k1} times; expected 13 per tick and one "
                               f"per post-training call, {13 * steps + n_post}")
        trained = losses[losses != 0]
        if not np.isfinite(losses).all() or trained.size != calls:
            raise RuntimeError(f"losses {losses}")
        if not all(p.is_cuda for p in es.model.parameters()) or not es.buf.y.is_cuda:
            raise RuntimeError("parameters or the replay ring left the card")
        cks = sorted(os.listdir(os.path.join(dirp, "checkpoints")))
        if cks != ["postexplr", "step_0000006", "step_0000012"]:
            raise RuntimeError(f"checkpoints {cks}")

        restored = load_checkpoint(os.path.join(dirp, "checkpoints", "postexplr"),
                                   experiment().init(seed=args.seed + 1))
        n_tensors = 0
        for (path, a), (_, b) in zip(state_leaves(es), state_leaves(restored), strict=True):
            if isinstance(a, torch.Tensor):
                if a.dtype != b.dtype or a.device != b.device or not torch.equal(a, b):
                    raise RuntimeError(f"{path}: the reloaded tensor differs")
                n_tensors += 1
            elif a != b:
                raise RuntimeError(f"{path}: {a!r} != {b!r}")
    print(f"[learning path] run entry at production size, K2 and K3 on: {steps} steps "
          f"(chunk {chunk}, a trainer call every {train_every}) + {n_post} post-training "
          f"calls = {calls} trainer calls in {wall:.1f} s (checkpoints included) | K2 "
          f"launches {k2} (25/call) | K3 calls {k3} (75/call) | K1 launches {k1} | last "
          f"loss {float(trained[-1]):.4f} | postexplr reloaded: {n_tensors} tensors "
          f"equal | peak memory {peak / 2**20:.1f} MiB")
    return k1, k2, k3


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from ealv_tpu_torch.ops import cuda_build

    # every f32 reference runs in full f32: cuDNN would run f32 convs in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _smi()
    print(f"[device] {smi} | torch {torch.__version__} | CUDA {torch.version.cuda} "
          f"| {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    sources = ("footprint.cu", "adam.cu", "wgrad.cu")
    t0 = time.perf_counter()
    cuda_build.build(*sources)
    for source in sources:
        cuda_build.load(source)
    print(f"[build] {', '.join(sources)} built in parallel and loaded in "
          f"{time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    k1 = phase_kernels(dev)
    k2 = phase_adam(dev)
    k3 = phase_wgrad(dev)
    phase_agreement()
    phase_eval_agreement()
    phase_planner_agreement()
    phase_trainer_agreement()
    phase_trainer_production()
    k1_launches, xyw_ms, xyw_peak = phase_main_path("xyw", n_warm=6, n_timed=24)
    k1_6dof, rpw_ms, rpw_peak = phase_main_path("xyzrpw", n_warm=6, n_timed=12)
    var_ms, var_peak, (k1_var, k2_var, k3_var) = phase_variant_path()
    eval_ms, eval_per_plan = phase_eval_path()
    print(f"[main paths] xyw {xyw_ms:.2f} ms/tick, peak {xyw_peak:.1f} MiB | xyzrpw "
          f"{rpw_ms:.2f} ms/tick, peak {rpw_peak:.1f} MiB ({rpw_ms / xyw_ms:.2f}x the time) | "
          f"xywb force z-ensemble {var_ms:.2f} ms/tick, peak {var_peak:.1f} MiB | eval "
          f"{eval_ms:.2f} ms/tick ({eval_per_plan:.0f} K1 launches a plan)")
    _, k2_launches, k3_launches = phase_learning_path()
    print(json.dumps({"kernels": [
        {"name": "footprint_and_spread", "route": "cuda",
         "source": "ealv_tpu_torch/csrc/footprint.cu",
         "replaces": "ealv_tpu/ops/pallas_kernels.py:55",
         "launches": k1_launches, "launches_xyzrpw": k1_6dof, "launches_variant": k1_var,
         "launches_eval_per_plan": eval_per_plan, **k1},
        {"name": "adam_apply", "route": "cuda",
         "source": "ealv_tpu_torch/csrc/adam.cu",
         "replaces": "ealv_tpu/ops/pallas_adam.py:55",
         "launches": k2_launches, "launches_variant": k2_var, **k2},
        {"name": "conv_wgrad_direct", "route": "cuda",
         "source": "ealv_tpu_torch/csrc/wgrad.cu",
         "replaces": "ealv_tpu/ops/pallas_wgrad.py:115",
         "launches": k3_launches, "launches_variant": k3_var, **k3}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
