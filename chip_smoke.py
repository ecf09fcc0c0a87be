#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ealv_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):
  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles every kernel (K1 footprint.cu, K2 adam.cu, K3
     wgrad.cu) from ealv_tpu_torch/csrc, one nvcc per source, in parallel;
  3. kernels vs their plain torch versions on the card, at the main paths'
     shapes and the CPU tests' probe shapes, plus kernel and plain timings
     (CUDA events);
  4. agreement: two toy-size ticks on the card and on the CPU with the same
     weights and the same fed random draws (float32, TF32 off); one toy
     trainer call with both trainer kernels on, card vs CPU; one
     production-size trainer call on the card with the kernels on vs off,
     from the same weights and draws, and ms per trainer call on and off;
  5. the tick path at production size (180x180x3 images, 2000 target
     samples, 3000 trajectory points, batch 64, 25 Adam steps every third
     tick, bf16), trainer kernels off as in the JAX default: warm ticks,
     then timed ticks, with the kernels' launch counts read over the timed
     window;
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


def _time_ms(fn, reps=21, inner=50):
    """Device time per call: median over ``reps`` of the mean time of
    ``inner`` back-to-back calls, from CUDA events. A spin kernel holds the
    stream while the host enqueues the calls, so the host's per-call
    overhead does not pace the device."""
    import torch
    host = _host_ms(fn, inner)
    spin = int(2e9 * 2 * host * 1e-3 * inner)  # twice the loop, at <= 2 GHz
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def _host_ms(fn, inner=50):
    """Host clock per call of ``inner`` back-to-back calls ending in a
    synchronize, after 5 warm calls: what a caller that launches the work
    and nothing else pays."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / inner * 1e3


def phase_kernels(dev):
    import torch
    from ealv_tpu_torch.ops import footprint_and_spread, footprint_and_spread_reference

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

    # (n, t, d, mask): the main path's shapes (target spread and base
    # footprint 2000x3000, horizon costs 2000x10) and the CPU probe shapes
    shapes = [(2000, 3000, 3, "tail"), (2000, 10, 3, "ones"),
              (700, 900, 4, "random"), (700, 900, 2, "random"),
              (700, 900, 6, "random"), (64, 100, 3, "ones"),
              (2000, 3000, 3, "zero"), (1, 1, 3, "ones"), (129, 513, 7, "random")]
    max_err = 0.0
    for n, t, d, mk in shapes:
        args = case(n, t, d, mk)
        got = footprint_and_spread(*args)
        want = footprint_and_spread_reference(*args)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, **TOL)
            max_err = max(max_err, float((a - b).abs().max()))
        print(f"[kernels] footprint_and_spread {n}x{t}x{d} mask={mk}: "
              f"max|kernel-plain| = {max(float((a - b).abs().max()) for a, b in zip(got, want)):.3e}")
    prod = case(2000, 3000, 3, "tail")
    ms = _time_ms(lambda: footprint_and_spread(*prod))
    plain_ms = _time_ms(lambda: footprint_and_spread_reference(*prod))
    print(f"[kernels] footprint_and_spread 2000x3000x3: kernel {ms:.4f} ms, "
          f"plain torch {plain_ms:.4f} ms (median of 21 x 50 launches)")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms)


def _max_err(got, want):
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


def phase_adam(dev):
    """K2 against its plain version: the CVAE's 24 parameter tensors in one
    launch, and ragged and tiny sizes, at step counts > 1 with non-zero
    moments; then kernel, plain and torch.optim.Adam(fused=True) times."""
    import torch
    from ealv_tpu_torch.models import CVAE
    from ealv_tpu_torch.ops import adam as tad
    from ealv_tpu_torch.utils.config import ExperimentConfig

    cfg = ExperimentConfig(**PRODUCTION)
    prod = [tuple(p.shape) for p in CVAE(img_dim=cfg.image_dim, z_dim=cfg.z_dim,
                                         s_dim=cfg.s_dim,
                                         hidden_dim=cfg.model_hidden()).parameters()]
    g = torch.Generator(device=dev).manual_seed(1)

    def state(shapes):
        r = lambda s, scale: torch.randn(s, generator=g, device=dev) * scale
        return ([r(s, 0.05) for s in shapes], [r(s, 1e-3) for s in shapes],
                [torch.rand(s, generator=g, device=dev) * 1e-5 for s in shapes],
                [r(s, 1e-2) for s in shapes])

    max_err = 0.0
    for shapes, count in ((prod, 7), ([(1,)], 1), ([(127,)], 1), ([(129,)], 3),
                          ([(1,), (127,), (129,), (4097,), (3 * 4096 + 5,)], 2)):
        p, m, v, gr = state(shapes)
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
        print(f"[kernels] adam_apply {len(shapes)} tensors, {n} elements, step {count}: "
              f"max|kernel-plain| = {err:.3e}")
    p, m, v, gr = state(prod)
    n = sum(x.numel() for x in p)
    kernel = lambda: tad.adam_apply(p, m, v, gr, 1e-3, 7)
    plain = lambda: [tad.adam_update_reference(*t, 1e-3, 7) for t in zip(p, m, v, gr)]
    params = [x.clone().requires_grad_() for x in p]
    for q, d in zip(params, gr):
        q.grad = d.clone()
    fused = torch.optim.Adam(params, lr=1e-3, fused=True).step
    ms, plain_ms, fused_ms = (_time_ms(f) for f in (kernel, plain, fused))
    host = [_host_ms(f) for f in (kernel, plain, fused)]
    print(f"[kernels] adam_apply 24 CVAE tensors ({n} elements), ms per step, device "
          f"(CUDA events, median of 21 x 50): kernel {ms:.4f} (one launch), plain torch "
          f"{plain_ms:.4f}, torch.optim.Adam(fused=True) {fused_ms:.4f}; host clock per "
          f"call: kernel {host[0]:.4f}, plain {host[1]:.4f}, fused {host[2]:.4f}")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms)


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
    ms = plain_ms = 0.0
    for shape in WGRAD_PRODUCTION:
        x, cot, k, s = inputs(shape, torch.bfloat16)
        x, cot = _trainer_layout(x, cot, shape == WGRAD_PRODUCTION[2])
        fns = (lambda: twg.conv_wgrad_direct(x, cot, k, s),
               lambda: twg.conv_wgrad_reference(x, cot, k, s),
               lambda: torch.nn.grad.conv2d_weight(
                   x, (cot.shape[1], x.shape[1], k, k), cot, stride=s))
        t_k, t_p, t_c = (_time_ms(f, inner=20) for f in fns)
        h_k, h_p, h_c = (_host_ms(f, inner=20) for f in fns)
        ms, plain_ms = ms + t_k, plain_ms + t_p
        print(f"[kernels] conv_wgrad_direct {shape} bf16 in the trainer's layouts, ms per "
              f"call, device (CUDA events, median of 21 x 20): kernel {t_k:.4f}, plain torch (f32 cuDNN on "
              f"upcast inputs) {t_p:.4f}, cuDNN bf16 wgrad {t_c:.4f}; host clock per "
              f"call: {h_k:.4f}, {h_p:.4f}, {h_c:.4f}")
    print(f"[kernels] conv_wgrad_direct, the three encoder layers: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms per Adam step")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms)


def _toy_draws(exp, k, rng, dev):
    """Valid fed draws for tick k of a toy run without ring wrap: history
    indices list the k+1 filled slots first; batch indices lie in them."""
    import torch
    from ealv_tpu_torch.runtime import TickDraws, TrainDraws
    cfg = exp.cfg
    lo, hi = exp.cfg.robot_lim[:, 0], exp.cfg.robot_lim[:, 1]
    samples = rng.uniform(lo, hi, (cfg.num_target_samples, cfg.s_dim))
    filled = rng.permutation(k + 1)
    rest = k + 1 + rng.permutation(cfg.traj_buffer_capacity - k - 1)
    hist = np.concatenate([filled, rest])[: cfg.num_traj_samples]
    steps, B = cfg.num_learning_opt, cfg.batch_size
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)
    train = [TrainDraws(idx=t(rng.integers(0, k + 1, (steps, B)), torch.int64),
                        idx2=t(rng.integers(0, k + 1, (steps, B)), torch.int64),
                        eps=t(rng.standard_normal((steps, B, cfg.z_dim))))]
    return TickDraws(samples=t(samples), hist_idx=t(hist, torch.int64), train=train)


def phase_agreement():
    import torch
    from ealv_tpu_torch.utils.config import ExperimentConfig
    from ealv_tpu_torch.runtime import Experiment

    cfg = ExperimentConfig(states="xyw", num_target_samples=64, num_traj_samples=100,
                           image_dim=(24, 24, 3), batch_size=8, num_learning_opt=2,
                           compute_dtype="float32")
    runs = {}
    for dev in ("cpu", "cuda"):
        exp = Experiment(cfg, train_calls_per_tick=1, train_every=1, device=dev)
        es = exp.init(seed=0)
        rng = np.random.default_rng(1)
        out = []
        for k in range(2):
            es, info = exp.tick(es, _toy_draws(exp, k, rng, dev))
            out.append({"pose": es.env.pose, "u": es.pstate.u,
                        "cost": info["ergodic_cost"], "loss": info["loss"],
                        "beta": info["beta"], "gamma": info["gamma"]})
        runs[dev] = [{k: v.detach().cpu() for k, v in o.items()} for o in out]
    # f32 on both sides; the card sums in other orders and its convs take
    # other algorithms, and one Adam step amplifies near-zero gradients
    for k, (a, b) in enumerate(zip(runs["cpu"], runs["cuda"])):
        for key in a:
            torch.testing.assert_close(b[key], a[key], rtol=1e-3, atol=1e-4,
                                       msg=lambda m: f"tick {k} {key}: {m}")
    print(f"[agreement] 2 toy ticks, cuda vs cpu with fed draws: pose, plan, "
          f"ergodic cost, beta/gamma and loss agree (rtol 1e-3, atol 1e-4); "
          f"loss {float(runs['cuda'][1]['loss']):.6f} vs "
          f"{float(runs['cpu'][1]['loss']):.6f}")


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


def phase_trainer_production(n_filled=200, rounds=2):
    """One production-size trainer call with the trainer kernels on and off
    from the same weights, ring and fed draws: 25 losses within the bf16
    tolerance. Then ms per trainer call on and off, interleaved (on, off,
    off, on), host clock around calls that end in a synchronize."""
    import torch
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
    times = {True: [], False: []}
    for _ in range(rounds):
        for on in (True, False, False, True):
            exp, es = runs[on]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_call(exp.trainer, es.model, es.opt, es.buf, beta, gamma, generator=es.gen)
            torch.cuda.synchronize()
            times[on].append((time.perf_counter() - t0) * 1e3)
    on_ms, off_ms = float(np.median(times[True])), float(np.median(times[False]))
    print(f"[agreement] production trainer call, kernels on vs off, same weights and "
          f"draws: 25 losses agree (first at 1e-2, all at rtol 5e-2, atol 5e-2), max|diff| "
          f"{float((losses[True] - losses[False]).abs().max()):.3e}, last loss "
          f"{float(losses[True][-1]):.4f} vs {float(losses[False][-1]):.4f}")
    print(f"[trainer] ms per 25-step trainer call at production size: kernels on "
          f"{on_ms:.2f} (K2 + K3), off {off_ms:.2f} (torch.optim.Adam + cuDNN wgrad); "
          f"median of {2 * rounds} each, interleaved on/off/off/on")
    return on_ms, off_ms


def phase_main_path(n_warm=6, n_timed=24):
    import torch
    from ealv_tpu_torch.utils.config import ExperimentConfig
    from ealv_tpu_torch.runtime import Experiment
    from ealv_tpu_torch.ops import footprint_and_spread

    cfg = ExperimentConfig(states="xyw", num_target_samples=2000,
                           num_traj_samples=3000, image_dim=(180, 180, 3),
                           batch_size=64, num_learning_opt=25)
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
    peak = torch.cuda.max_memory_allocated()
    print(f"[main path] {n_timed} ticks after {n_warm} warm: {dt * 1e3:.2f} ms/tick "
          f"= {1.0 / dt:.2f} Hz | last loss {float(trained[-1]):.4f} | ergodic cost "
          f"{float(costs[-1]):.4f} | learning_ind {es.learning_ind} | "
          f"K1 launches {launches} (13/tick) | peak memory {peak / 2**20:.1f} MiB")
    return launches


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
    phase_trainer_agreement()
    phase_trainer_production()
    k1_launches = phase_main_path()
    _, k2_launches, k3_launches = phase_learning_path()
    print(json.dumps({"kernels": [
        {"name": "footprint_and_spread", "route": "cuda",
         "source": "ealv_tpu_torch/csrc/footprint.cu",
         "replaces": "ealv_tpu/ops/pallas_kernels.py:55",
         "launches": k1_launches, **k1},
        {"name": "adam_apply", "route": "cuda",
         "source": "ealv_tpu_torch/csrc/adam.cu",
         "replaces": "ealv_tpu/ops/pallas_adam.py:55",
         "launches": k2_launches, **k2},
        {"name": "conv_wgrad_direct", "route": "cuda",
         "source": "ealv_tpu_torch/csrc/wgrad.cu",
         "replaces": "ealv_tpu/ops/pallas_wgrad.py:115",
         "launches": k3_launches, **k3}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
