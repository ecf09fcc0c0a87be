#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ealv_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):
  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles every kernel of the main path from ealv_tpu_torch/csrc;
  3. kernels vs their plain torch versions on the card, at the main path's
     shapes and the CPU tests' probe shapes, plus kernel and plain timings;
  4. agreement: two toy-size ticks on the card and on the CPU with the same
     weights and the same fed random draws (float32, TF32 off);
  5. the main path at production size (180x180x3 images, 2000 target
     samples, 3000 trajectory points, batch 64, 25 Adam steps every third
     tick, bf16): warm ticks, then timed ticks, with the kernels' launch
     counts read over the timed window.
The line before the last is the kernels' JSON record; the last line is the
result JSON. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

TOL = dict(rtol=1e-5, atol=1e-6)  # f32 K1: summation order only


def _smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _time_ms(fn, reps=21, inner=50):
    """Median over ``reps`` of the mean time of ``inner`` back-to-back
    calls, from CUDA events."""
    import torch
    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from ealv_tpu_torch.ops import cuda_build

    smi = _smi()
    print(f"[device] {smi} | torch {torch.__version__} | CUDA {torch.version.cuda} "
          f"| {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    cuda_build.load("footprint.cu")
    print(f"[build] footprint.cu built and loaded in {time.perf_counter() - t0:.1f} s")
    k1 = phase_kernels(torch.device("cuda"))
    phase_agreement()
    launches = phase_main_path()
    print(json.dumps({"kernels": [{
        "name": "footprint_and_spread", "route": "cuda",
        "source": "ealv_tpu_torch/csrc/footprint.cu",
        "replaces": "ealv_tpu/ops/pallas_kernels.py:55",
        "launches": launches, **k1}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
