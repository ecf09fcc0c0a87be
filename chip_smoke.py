#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ealv_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):
  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles every kernel (K1 footprint.cu, the planner's horizon
     recurrences rollout.cu, K2 adam.cu, K3 wgrad.cu, the belief fusion
     belief.cu) from
     ealv_tpu_torch/csrc, one nvcc per source, in parallel;
  3. kernels vs their plain torch versions on the card, at the main paths'
     shapes (K1 at d = 3 for the xyw tick, d = 6 for the xyzrpw tick, and
     N = 2010 for the planner's add_recent_history samples, and at the
     fingerprint capture's width, std x 0.1, where most terms underflow)
     and the probe shapes (K1's and K3's the same bits on a repeated
     call), then device
     times (CUDA events) and host clock per call of each kernel, its plain
     version and the one PyTorch call for the same function where there is
     one (torch.optim.Adam(fused=True) for K2, cuDNN's bf16 wgrad for K3),
     beside each kernel's bound on this card; the planner's rollout and
     costate kernels at the cells' shapes, bit-equal to their plain
     versions but for the SO(3) roll model's gap, and their device us as
     nodes of a captured graph beside an empty kernel's;
  4. agreement: two toy-size ticks on the card and on the CPU with the same
     weights and the same fed random draws (float32, TF32 off), at xyw, at
     xywb with the force variant and the z-ensemble, and with each baseline
     explorer (randomWalk, uniform); three toy EvalExperiment ticks toward
     an ExplrDist target and toward a frozen CVAE's pdf, and
     evaluate_test_set on a toy set, card against CPU; the fingerprint
     stage at toy size, card against CPU within 1e-4 (find_clusters with
     shift and kmeans, sample optimization on and off; 3-tick captures;
     calibrate_thresholds; 3 matrix-runtime ticks over the four default
     combinations in both seek modes; entropy slices); the kinematic arm at
     toy size, card against CPU from the same arm state: two ticks on each
     arm backend, and 8 host-loop steps over a SyntheticBridge on
     arm-dynamic in each of the serial, host-pipelined and device-resident
     modes, with a forced wedge and its escape and a pause the heartbeat
     recovers; one toy
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
     profiled calls; the trainer call captured in the post-training call's
     graph (runtime/graphs.py) against the eager call, kernels on and off:
     three post-training calls on fed draws (an eager call, a capture and
     its replay, a replay) bit for bit where two eager experiments agree,
     then host ms, busy ms and intervals eager against captured, the
     capture's seconds and memory, the optimizer per captured call, and
     the busy time of an eager call by kernel name, kernels on against
     off;
  5. the tick paths at production size (180x180x3 images, 2000 target
     samples, 3000 trajectory points, batch 64, 25 Adam steps every third
     tick, bf16), trainer kernels off as in the JAX default, each two ways
     in this call: whole ticks replayed as CUDA graphs (the default: warm
     ticks until every timed tick replays its pattern's graph, then timed
     ticks, the kernel counts read through the graphs with the wrappers'
     eager counts at 0, and the whole run, every tick's info and the final
     state, bit-equal to an eager experiment taking the same ticks; capture
     seconds by pattern, the shared pool's MiB) and eager ticks, three
     ticks of each under torch.profiler (host ms, busy ms, intervals): the
     xyw tick (double integrator), then the 6-DoF xyzrpw tick (SO(3) roll
     dynamics, linearized at every step); for each, K1's launch count over
     the timed window; then the variant
     tick path (xywb, learn_force, use_z_ensemble, both trainer kernels
     on) with K1, K2 and K3 counted and the ensemble pdf held against its
     plain decode-and-average; then the eval path: a 25-point grid test set
     collected at 180x180, EvalExperiment ticks toward a frozen production
     CVAE at xyw, xyzrpw and on the arm (60 warm ticks, so that a
     drift-correcting tick replays), each through its tick graph and
     eagerly in one call, in turns, 3 ticks of each profiled, every
     observation and the state bit-equal, 12 K1 launches a plan read
     through the graphs and none eager in the replayed chunks;
     evaluate_test_set over the set, and baseline ticks (no K1 launch in
     their plan_step); then the fingerprint path (bf16, weights from seed
     0, a 3-object scene): find_clusters over 1000 samples, a 50-tick
     capture at each true centre (through each capture's step graph), the
     first centre's capture steps again graphed and eager in turns
     (bit-equal, and the eager steps' fingerprint bit-equal to the public
     capture's), thresholds, identify_step, update_beliefs, match_forward
     and fuse_matches device times, 30 identification ticks over the four
     combinations in each seek mode with adoption at step 10, graphed and
     eager (histories and beliefs bit-equal), then identification ticks
     graphed and eager in turns; 12 K1 launches a capture or
     identification tick through the graphs and none in the clustering,
     matching or entropy slices; one belief fusion launch an
     identification tick and none elsewhere; the fusion kernel at the
     identification cell's sizes (16 beliefs of 50^3 cells) against its
     plain version, with both device times beside its bound; then the arm: 12 ticks
     on sim_backend="arm" two ways after 60 warm ticks (so that a
     drift-correcting tick replays its graph; 13 K1 launches a tick), then
     ArmEnv.step_vel
     (with and without the drift correction), step_pose and observe alone
     (device intervals, device ms and host ms per call; each enqueued
     behind a spin kernel must return before the spin ends: the host
     never waits for the device); the host loop on arm-dynamic in the
     device-resident mode through the runner's plan and step graphs and
     eagerly (drive_to_start with no K1 launch, then 24 timed steps at 13
     K1 launches a plan); and the host loop over
     NativeBridge: the controller library built from native/, its C++
     1 kHz loop against a numpy driver, the camera rendered on the card,
     12 absorbed steps and the loop's rate, jitter and missed deadlines;
     after the timed window of each path (xyw, xyzrpw, the variant path,
     the arm, the eval path, the fingerprint capture and identification in
     each seek mode; the eval and fingerprint steps replayed) one warm
     tick's calls (plan_step, the env steps,
     observe, absorb_step with the trainer call throttled out) run under
     torch.cuda.set_sync_debug_mode("error"): no call may synchronise (on
     xyw, xyzrpw, the variant path and the arm a replayed tick without and
     with a trainer call); on
     xyw also the card's launch queue depth, and plan_step bisected into
     pieces (the sync, the draws, the target decode, the base footprint,
     the initial cost, the first inner iteration's parts), each under the
     queue's depth, enqueued behind a spin kernel: none may wait;
     then the CVAE's options (MODEL_OPTIONS: the "subpixel" and
     "resize_conv" decoders, the "s2d" and "im2col" encoder weight-gradient
     schedules, lane_pad=8) beside the default: their layers at the
     production shapes (TF32 off; each subpixel form against the transposed
     conv, the schedules' dW against the f64 sums in f32 and bf16, the
     lane-padded conv and transposed conv against the unpadded ones), a toy
     trainer call per option card against CPU, and per option the
     production Experiment through its tick graphs, bit-equal to eager
     ticks, the sync check on a replayed tick with a trainer call, ms per
     tick, capture seconds, K1 (13 a tick) and K3 (0) through the graphs,
     and the captured post-training call's host and busy ms;
  6. the learning path at production size through the port's run entry
     (``ealv_tpu_torch.scripts.run_experiment.run``) with
     ``fast_encoder_grads="pallas"`` and ``fused_adam=True``: 12 exploration
     steps with a trainer call every third, post-training to 36 trainer
     calls, checkpoints every 6 steps and the postexplr checkpoint (in a
     temporary directory, removed afterwards), through the tick and
     post-training graphs, and its wall time; the postexplr checkpoint is
     reloaded into a fresh
     Experiment and compared tensor for tensor, and 3 post-training calls
     from it through the post-training graph are held bit for bit against
     the same calls made eagerly;
  7. data parallelism, the dashboard and the study CLIs: K1 at the
     dashboard's shapes (2500 grid samples against the 3000-point memory
     and the memory plus the 11-point plan) in phase 3; inside a one-rank
     NCCL group (destroyed afterwards), the data-parallel trainer call at
     the production config with K2 and K3 on, bit-equal to the plain call
     on the same draws (25 K2 and 75 K3 launches a call, K2's table never
     rebuilt; host ms and device busy ms beside the plain call's; captured
     in the post-training call's graph against eager post-training calls,
     kernels on and off), and 12 ticks of Experiment(mesh=...) at 13 K1
     launches a tick; two spawned
     ranks on the one card over gloo (a data-parallel SGD step's averaged
     gradients against the full batch's, the ranks bit-equal after a bf16
     Adam call with K2 and K3 at 32 rows a rank); the dashboard's payload
     on a warm production Experiment (2 K1 launches, one device-to-host
     copy, no host wait before it; device and host ms); the demo, the force
     study, the resume study at --small (bit-equal after a SIGKILL and
     --resume), the run entry's --profile trace (it names K1's kernel) and
     the browser panel (GET /status, POST /cmd pause);
  8. the port's ``repro planner`` table at 2 seeds x 30 steps (the
     published spec otherwise; 13 K1 launches a step), its rows finite and
     printed as one JSON line.
Every path of phases 4 to 8 whose K1 launches are counted has the
planner's horizon kernels counted beside them, from the same counts set to
0: 17 horizon_rollout and 5 costate_sweep launches a plan (a toy planner
mode's own numbers), one more rollout for each planner state set up in the
window (``init_state`` rolls out the zero plan), none where nothing plans.
The line before the last is the kernels' JSON record (the horizon kernels'
launches by path among it); the last line is the
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

from port_bench import trace
from port_bench.counts import k1_bound_s

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
# the same layers at 32 rows: one rank's shard of the batch at two ranks
WGRAD_DP = [(32,) + shape[1:] for shape in WGRAD_PRODUCTION]
WGRAD_PROBES = [(2, 17, 17, 3, 5, 3, 2), (1, 20, 20, 4, 6, 5, 3),
                (2, 16, 16, 2, 3, 3, 3), (1, 13, 11, 1, 2, 1, 1), (3, 9, 9, 2, 40, 3, 2),
                (2, 13, 13, 3, 16, 3, 2), (2, 13, 13, 3, 17, 3, 2), (1, 12, 12, 2, 33, 3, 1),
                (1, 9, 9, 2, 70, 3, 2), (2, 15, 15, 1, 5, 4, 2), (2, 9, 9, 17, 6, 1, 1),
                (1, 13, 13, 12, 6, 5, 2), (6, 100, 100, 3, 10, 3, 2),
                (40, 100, 100, 3, 10, 3, 2), (1, 31, 31, 4, 12, 3, 2)]
# the CVAE's options beside the default, as ExperimentConfig fields
MODEL_OPTIONS = {"default": {}, "subpixel": dict(decoder_mode="subpixel"),
                 "resize_conv": dict(decoder_mode="resize_conv"),
                 "s2d": dict(fast_encoder_grads="s2d"),
                 "im2col": dict(fast_encoder_grads="im2col"), "lane_pad 8": dict(lane_pad=8)}
# (B, H, Cin, Cout, k, s): the production decoder's three layers at the
# trainer's 2 x 64 rows (a batch and its cross-decode)
DECODER_LAYERS = [(128, 14, 20, 10, 5, 3), (128, 44, 10, 10, 3, 2), (128, 89, 10, 3, 3, 2)]
# f32, another summation order: the subpixel forms against the transposed
# conv as tests/test_cvae.py holds the JAX forms; a conv on zero-padded
# channels against the conv on the channels alone (the zero terms add 0)
SUBPIXEL_TOL = dict(rtol=1e-4, atol=1e-4)
LANE_TOL = dict(rtol=1e-5, atol=1e-5)
# the s2d schedule's dW from bf16 inputs is bf16, as the JAX schedule's (its
# stride-1 wgrad is the library's own in the inputs' dtype: cuDNN's bf16
# wgrad, deterministic, which the default encoder's backward runs too).
# Against the exact sums: K3's tolerance plus two bf16 ulps of the entry
# (2^-6 relative), the output's rounding and cuDNN's bf16 accumulation: on
# the H100 one entry of 5000 at the third layer sat 2.6 ulps of its own
# (0.065) off, 1.27e-3
WGRAD_BF16_OUT_TOL = dict(rtol=WGRAD_TOL["rtol"] + 2 ** -6, atol=WGRAD_TOL["atol"])
# the production config (bench.py:372-379)
PRODUCTION = dict(states="xyw", num_target_samples=2000, num_traj_samples=3000,
                  image_dim=(180, 180, 3), batch_size=64, num_learning_opt=25)


def _smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _k1_bound_ms(n, t, d, mask):
    """K1's least time on these inputs in ms and what bounds it
    (``port_bench.counts.k1_bound_s`` over the mask's unmasked points)."""
    bound_s, bound_by = k1_bound_s(n, t, d, int((mask != 0).sum()))
    return bound_s * 1e3, bound_by


def phase_kernels(dev):
    """K1 against its plain version at the main paths' shapes and the probe
    shapes, the same bits on a repeated call; then kernel and plain times
    at the main paths' shapes: d = 3 (xyw), d = 6 (xyzrpw) and d = 4
    (xywb), the dashboard payload's 50x50 grid (N = 2500) against the
    3000-point memory (the spread) and the memory plus the 11-point plan
    (the footprint, T = 3011), and the ``repro planner`` table's 1500
    samples at d = 4 against its 2000-slot memory (the spread), its
    1000-point memory draw (the base footprint), both with the first 300
    points valid as at the table's last step, and its 10-step horizon."""
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
        elif mask_kind.startswith("first"):  # a memory ring's fill
            mask = (torch.arange(t, device=dev) < int(mask_kind[5:])).float()
        return samples, traj, std, mask

    # (n, t, d, mask): the main paths' shapes (target spread and base
    # footprint 2000x3000, horizon costs 2000x10, at d = 3 and d = 6; N =
    # 2010 with add_recent_history; the dashboard's 2500-point grid against
    # 3000 and 3011 points, and 3010; the planner table's 1500 samples
    # against its 2000-slot memory and 1000-point draw, filled to 0, 31 and
    # 300 points, and its 10-step horizon), the CPU probe shapes, and T-splits cut
    # unevenly: a T that S does not divide, more splits than points per
    # split, splits longer than one staged stretch, T = 1, d = 8
    shapes = [(2000, 3000, 3, "tail"), (2000, 10, 3, "ones"),
              (2000, 3000, 6, "tail"), (2000, 10, 6, "ones"),
              (2000, 3000, 4, "tail"), (2000, 10, 4, "ones"),
              (2500, 3000, 3, "tail"), (2500, 3010, 3, "tail"), (2500, 3011, 3, "tail"),
              (2010, 3000, 6, "tail"), (2010, 10, 6, "ones"), (2010, 3000, 3, "random"),
              (1500, 2000, 4, "first31"), (1500, 1000, 4, "first31"),
              (1500, 2000, 4, "first300"), (1500, 1000, 4, "first300"),
              (1500, 1000, 4, "first0"), (1500, 10, 4, "ones"),
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
                        (2000, 3000, 4, "tail"), (2000, 10, 4, "ones"),
                        (2500, 3000, 3, "tail"), (2500, 3011, 3, "tail"),
                        (1500, 2000, 4, "first300"), (1500, 1000, 4, "first300"),
                        (1500, 10, 4, "ones")):
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
                (2000, 10, 4), (2500, 3000, 3), (2500, 3011, 3), (1500, 2000, 4),
                (1500, 1000, 4), (1500, 10, 4)):
        tag = "x".join(map(str, key))
        out.update({f"{k}_{tag}": v for k, v in rec[key].items()})
    capture, cap_err = _k1_capture_width(dev, u)
    out.update(capture)
    out["max_abs_err"] = max(max_err, cap_err)
    return out


def _k1_capture_width(dev, u):
    """K1 at the fingerprint capture's width (the production std x 0.1,
    where most terms of the Gaussian underflow to 0) and on a capture's
    inputs: samples in the shrunk box around a centre; at 2000x3000x3 the
    history sample of tick 50 (its first 50 rows valid, near the centre),
    at 2000x10x3 the plan's 10 states; against the plain version, then
    kernel and plain times beside the bound."""
    import torch
    from ealv_tpu_torch.ops import footprint_and_spread, footprint_and_spread_reference
    from ealv_tpu_torch.utils.config import ExperimentConfig
    from ealv_tpu_torch.utils.timing import device_ms, host_ms

    width = ExperimentConfig(**PRODUCTION).std * 0.1
    center = torch.tensor([0.3, -0.2, 0.0], device=dev)
    out, err = {}, 0.0
    for n, t in ((2000, 3000), (2000, 10)):
        samples = center + 0.4 * u(n, 3)
        traj = center + 0.1 * u(t, 3)
        mask = (torch.arange(t, device=dev) < 50).float()
        args = (samples, traj, torch.full((3,), width, device=dev), mask)
        got, want = footprint_and_spread(*args), footprint_and_spread_reference(*args)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, **TOL)
        e = _max_err(got, want)
        err = max(err, e)
        psi = torch.exp(-0.5 * ((samples[:, None] - traj[None, :min(t, 50)]) ** 2
                                / width).sum(-1))
        tiny, zeros = float((psi < 1e-6).float().mean()), float((psi == 0).float().mean())
        kernel = lambda: footprint_and_spread(*args)
        plain = lambda: footprint_and_spread_reference(*args)
        ms, plain_ms = device_ms(kernel), device_ms(plain)
        h_ms, h_plain = host_ms(kernel), host_ms(plain)
        bound_ms, bound_by = _k1_bound_ms(n, t, 3, args[3])
        print(f"[kernels] footprint_and_spread {n}x{t}x3 at the capture's width (std "
              f"{width:.6f}; of the valid terms {100 * tiny:.1f}% under 1e-6, "
              f"{100 * zeros:.1f}% exactly 0): "
              f"max|kernel-plain| = {e:.3e}; device kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms; host clock {h_ms:.4f} / {h_plain:.4f} ms; bound {bound_ms:.5f} ms "
              f"({bound_by})")
        tag = f"{n}x{t}x3_capture"
        out.update({f"ms_{tag}": ms, f"plain_ms_{tag}": plain_ms, f"host_ms_{tag}": h_ms,
                    f"bound_ms_{tag}": bound_ms, f"bound_by_{tag}": bound_by})
    return out, err


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
    # the step count on the card, as FusedAdam keeps it: the kernel's
    # one-thread prologue advances it, the update reads it
    p, m, v, gr = state(prod)
    want = [[x.clone() for x in xs] for xs in (p, m, v)]
    count = torch.full((), 6, dtype=torch.int32, device=dev)
    tad.adam_apply(p, m, v, gr, 1e-3, count)
    for i in range(len(prod)):
        tad.adam_update_reference(want[0][i], want[1][i], want[2][i], gr[i], 1e-3, 7)
    for got, ref in zip((p, m, v), want):
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, **ADAM_TOL)
    if int(count) != 7:
        raise RuntimeError(f"the Adam kernel advanced its count from 6 to {int(count)}")
    err = max(_max_err(got, ref) for got, ref in zip((p, m, v), want))
    max_err = max(max_err, err)
    print(f"[kernels] adam_apply 24 CVAE tensors with the step count on the card (6 -> 7, "
          f"advanced by the kernel's prologue): max|kernel-plain| = {err:.3e}")
    p, m, v, gr = state(prod)
    n = sum(x.numel() for x in p)
    count = torch.full((), 6, dtype=torch.int32, device=dev)
    kernel = lambda: tad.adam_apply(p, m, v, gr, 1e-3, count)
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
    # the stock optimizer per step at the same tensors: the trainer's
    # foreach path eager and capturable (the card's default, runtime/
    # trainer.py), the fused one, and K2's FusedAdam.step
    stock = {}
    for name, kw in (("foreach", dict(foreach=True)),
                     ("foreach, capturable", dict(foreach=True, capturable=True)),
                     ("fused", dict(fused=True)),
                     ("fused, capturable", dict(fused=True, capturable=True))):
        params = [x.clone().requires_grad_() for x in p]
        for q, d in zip(params, gr):
            q.grad = d.clone()
        step = torch.optim.Adam(params, lr=1e-3, **kw).step
        stock[name] = (device_ms(step), host_ms(step))
    stock["FusedAdam (K2)"] = (device_ms(ours), h_step)
    print("[kernels] optimizer step over the 24 CVAE tensors, device ms (CUDA events) / host "
          "ms: " + "; ".join(f"{k} {d:.4f} / {h:.4f}" for k, (d, h) in stock.items()))
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
                optimizer_step_host_ms=h_step,
                stock_step_ms={k: d for k, (d, _) in stock.items()})


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


def _graph_us(fn, inner=50, reps=11):
    """Device us a call of ``fn`` as one of ``inner`` nodes of a captured
    CUDA graph, as a tick graph replays it: median over ``reps`` replays,
    from CUDA events."""
    import torch
    fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) * 1e3 / inner)
    return float(np.median(times))


HORIZON = ("horizon_rollout", "costate_sweep")
# each path's horizon kernel launches, plans and planner set-ups, summed
# over its checked windows by _horizon_launches, for the kernels record
HORIZON_LAUNCHES: dict = {}


def _horizon_want(kcfg) -> tuple:
    """The horizon kernels' launches a plan (rollouts, costate sweeps) at a
    planner config: a rollout for the initial cost, for every inner
    iteration's forward pass, line search (its windows as one batch),
    ``full_cost`` substitutions and new plan's cost, and for the final
    plan; a sweep for every backward pass. (17, 5) at the default config."""
    search = kcfg.ctrl_app_search and not kcfg.fixed_lam
    per_iter = 2 + int(search) + int(kcfg.ctrl_app_search and kcfg.full_cost)
    return 2 + kcfg.num_iters * per_iter, kcfg.num_iters


def _horizon_launches(counts, plans, path, inits=0, per_plan=(17, 5), record=True):
    """Check the horizon kernels' launches in ``counts`` (kernel name ->
    launches, set to 0 before the window): ``per_plan`` (rollouts, sweeps)
    for each of ``plans`` planner calls, and one eager rollout for each of
    ``inits`` planner states set up (``init_state`` rolls out the zero
    plan). Adds them to ``HORIZON_LAUNCHES[path]``."""
    got = tuple(counts[k] for k in HORIZON)
    want = (per_plan[0] * plans + inits, per_plan[1] * plans)
    if got != want:
        raise RuntimeError(f"{path}: {got[0]} horizon_rollout and {got[1]} costate_sweep "
                           f"launches for {plans} plans and {inits} planner set-ups, expected "
                           f"{want[0]} and {want[1]} ({per_plan[0]} and {per_plan[1]} a plan)")
    if record:
        r = HORIZON_LAUNCHES.setdefault(path, dict.fromkeys(("plans", "inits", *HORIZON), 0))
        for k, v in zip(("plans", "inits", *HORIZON), (plans, inits, *got)):
            r[k] += v


def _horizon_record(name) -> dict:
    """A horizon kernel's launches by path for the kernels record: the
    total and, where the path plans, the launches a plan."""
    return {"launches": {p: r[name] for p, r in HORIZON_LAUNCHES.items()},
            "launches_per_plan": {p: (r[name] - (r["inits"] if name == HORIZON[0] else 0))
                                  / r["plans"] for p, r in HORIZON_LAUNCHES.items()
                                  if r["plans"]}}


def phase_rollout(dev):
    """The planner's horizon kernels (``control/horizon.py``) at the cells'
    shapes, H = 10 and the Roll policy: the rollout of one plan through the
    policy (``_forward``) and of the line search's 5 candidates as they
    are (the costs), for the double integrator (xyw, n = 6), the speed
    model (n = 9) and the SO(3) roll model (xyzrpw, n = 12), and the costate
    sweep on the planner's own matrices; each against its plain version
    (bit-equal but for the roll model, whose gap is printed), then device
    us a call of each as a node of a captured graph, beside an empty
    kernel's (the latency bound) and the plain version's, captured and
    eager."""
    import torch
    from ealv_tpu_torch.control import DynState, make_dynamics, make_policy
    from ealv_tpu_torch.control.horizon import (costate, costate_sweep_reference,
                                                horizon_rollout_reference, rollout, state_gap)
    from ealv_tpu_torch.utils.timing import device_ms

    g = torch.Generator(device=dev).manual_seed(0)
    bound = _graph_us(lambda: torch.cuda._sleep(0))
    print(f"[rollout] an empty kernel: {bound:.2f} us a graph node (the latency bound)")
    out = {k: {"bound_us": bound} for k in HORIZON}
    for name, kw in (("xyw", {}), ("xyw speed", {"use_magnitude": True}), ("xyzrpw", {})):
        dyn = make_dynamics(name.split()[0], dt=0.2, device=dev, **kw)
        pol = make_policy("Roll", dyn, 10)
        n, m = dyn.num_states, dyn.num_actions
        s0 = dyn.init(torch.rand(n, generator=g, device=dev) * 2 - 1)
        angles = getattr(dyn, "rpw", ())
        for k, p in ((1, pol), (5, None)):
            u = torch.rand((k, 10, m) if k > 1 else (10, m), generator=g, device=dev) * 2 - 1
            kern = lambda: rollout(dyn, p, s0.x, s0.R, u)
            plain = lambda: horizon_rollout_reference(dyn, p, s0.x, s0.R, u)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            equal = all(torch.equal(a, b) for a, b in zip(got, want))
            gap = max(state_gap(got[0], want[0], angles), state_gap(got[1], want[1]))
            if not angles and not equal:
                raise RuntimeError(f"rollout {name} K={k} is not bit-equal: {gap:.3e}")
            if gap > 1e-6:
                raise RuntimeError(f"rollout {name} K={k}: gap {gap:.3e} above 1e-6")
            us, plain_us, plain_ms = _graph_us(kern), _graph_us(plain), device_ms(plain)
            print(f"[rollout] horizon_rollout {name} n={n} K={k}: "
                  f"{'bit-equal' if equal else f'max rel gap {gap:.3e}'}; kernel {us:.2f} us "
                  f"a graph node; plain {plain_us:.2f} us captured, {plain_ms * 1e3:.2f} us "
                  f"eager (CUDA events)")
            out["horizon_rollout"][f"{name} K={k}"] = dict(us=us, plain_us=plain_us, plain_ms=plain_ms,
                                                          gap=gap, equal=equal)
        u = torch.rand((10, m), generator=g, device=dev) * 2 - 1
        xs, Rs, ue = horizon_rollout_reference(dyn, pol, s0.x, s0.R, u)
        xs, Rs = xs[:-1], Rs[:-1]
        A, B = dyn.get_lin(DynState(x=xs, R=Rs), ue) if dyn.state_dependent else (dyn.A, dyn.B)
        jac = A.expand(10, n, n) + B.expand(10, n, m) @ pol.dx(xs, ue)
        drive = torch.randn((10, n), generator=g, device=dev)
        kern = lambda: costate(drive, jac, 0.2)
        plain = lambda: costate_sweep_reference(drive, jac, 0.2)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        equal, gap = torch.equal(got, want), state_gap(got, want)
        if (not angles and not equal) or gap > 1e-6:
            raise RuntimeError(f"costate {name}: gap {gap:.3e}")
        us, plain_us, plain_ms = _graph_us(kern), _graph_us(plain), device_ms(plain)
        print(f"[rollout] costate_sweep {name} n={n}: "
              f"{'bit-equal' if equal else f'max rel gap {gap:.3e}'}; kernel {us:.2f} us a "
              f"graph node; plain {plain_us:.2f} us captured, {plain_ms * 1e3:.2f} us eager")
        out["costate_sweep"][name] = dict(us=us, plain_us=plain_us, plain_ms=plain_ms, gap=gap,
                                          equal=equal)
    return out


def phase_wgrad(dev):
    """K3 against its plain version in f64 at the encoder's three production
    layers at 64 rows and at 32 (one rank's shard at two ranks) and the
    probe shapes, f32 and bf16 inputs, with the first layer's input a
    channels-last view as the CVAE gives it; the same
    values in the trainer's layouts give the same bits. Then kernel, plain
    and cuDNN's own bf16 wgrad times at the production layers, at 64 and at
    32 rows, in the trainer's layouts."""
    import torch
    from ealv_tpu_torch.ops import wgrad as twg
    from ealv_tpu_torch.utils.timing import device_ms, host_ms

    g = torch.Generator(device=dev).manual_seed(2)

    def layer(shape, i):
        return shape[1:] == WGRAD_PRODUCTION[i][1:]

    def inputs(shape, dtype):
        B, H, W, cin, cout, k, s = shape
        x = torch.randn((B, H, W, cin), generator=g, device=dev).to(dtype).permute(0, 3, 1, 2)
        if not layer(shape, 0):
            x = x.contiguous()
        cot = torch.randn((B, cout, (H - k) // s + 1, (W - k) // s + 1), generator=g,
                          device=dev).to(dtype)
        return x, cot, k, s

    max_err = 0.0
    for shape in WGRAD_PRODUCTION + WGRAD_DP + WGRAD_PROBES:
        for dtype in (torch.float32, torch.bfloat16):
            x, cot, k, s = inputs(shape, dtype)
            got = twg.conv_wgrad_direct(x, cot, k, s)
            want = twg.conv_wgrad_reference(x, cot, k, s, dtype=torch.float64)
            f32 = twg.conv_wgrad_reference(x, cot, k, s)
            again = twg.conv_wgrad_direct(x, cot, k, s)
            laid = twg.conv_wgrad_direct(*_trainer_layout(x, cot, layer(shape, 2)), k, s)
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
    def times(shapes):
        ms = plain_ms = cudnn_ms = host = bound_bytes = 0.0
        for shape in shapes:
            x, cot, k, s = inputs(shape, torch.bfloat16)
            x, cot = _trainer_layout(x, cot, layer(shape, 2))
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
                  f"call, device (CUDA events, median of 21 x 20): kernel {t_k:.4f}, plain "
                  f"torch (f32 cuDNN on upcast inputs) {t_p:.4f}, cuDNN bf16 wgrad {t_c:.4f}; "
                  f"host clock per call: {h_k:.4f}, {h_p:.4f}, {h_c:.4f}")
        bound_ms = bound_bytes / 3.35e12 * 1e3
        print(f"[kernels] conv_wgrad_direct, the three encoder layers at {shapes[0][0]} rows: "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, cuDNN bf16 {cudnn_ms:.4f} ms per "
              f"Adam step; host clock {host:.4f} ms; bound {bound_ms:.4f} ms "
              f"({bound_bytes / 1e6:.1f} MB, bytes)")
        return dict(ms=ms, plain_ms=plain_ms, host_ms=host, bound_ms=bound_ms,
                    bound_by="bytes", library_ms=cudnn_ms)

    dp = times(WGRAD_DP)
    return dict(max_abs_err=max_err, **times(WGRAD_PRODUCTION),
                **{f"{key}_b32": v for key, v in dp.items()})


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


def _kept(row):
    """A tick's outputs as they are now: copies, since a replayed tick
    graph overwrites the state's tensors in place on the next tick."""
    return {k: v.detach().clone() for k, v in row.items()}


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
                out.append(_kept({"pose": es.env.pose, "brightness": es.env.brightness,
                            "plan": es.pstate.x if exp.use_baseline else es.pstate.u,
                            "cost": info["ergodic_cost"], "loss": info["loss"],
                            "beta": info["beta"], "gamma": info["gamma"],
                            "z ring": es.mstate.z_buff}))
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
                out.append(_kept({"pose": ev.env.pose, "robot_state": obs["robot_state"],
                                  "plan": ev.pstate.u, "cost": obs["cost"]}))
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
    and the kernels' launches in the call (the wrappers' counts)."""
    import torch
    from ealv_tpu_torch import control as tc
    from ealv_tpu_torch.runtime.graphs import kernel_counts

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
    before = kernel_counts()
    ps, info = planner.plan(ps, None, samples=t(samples),
                            hist_idx=torch.as_tensor(hist_idx, device=dev))
    launches = {k: n - before[k] for k, n in kernel_counts().items()}
    s = ps.dyn
    for k in range(H):
        s = dyn.step(s, ps.u[k])
    return ps.u.cpu(), info["cost"].cpu(), s.R.cpu(), launches


def phase_planner_agreement():
    """Every dynamics model, policy and mode of the planner: one toy call
    on the card and on the CPU with the same fed draws (f32, TF32 off);
    plan and cost at rtol 1e-3, atol 1e-4, R at atol 1e-5 and orthonormal
    to 1e-5 on both; 13 K1 launches per call on the card in every mode, and
    the horizon kernels' launches of its mode (17 rollouts and 5 costate
    sweeps at the default)."""
    import torch
    from ealv_tpu_torch.control import KlergConfig
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
        if launches["footprint_and_spread"] != 13:
            raise RuntimeError(f"{what}: {launches['footprint_and_spread']} K1 launches in one "
                               f"plan, expected 13")
        _horizon_launches(launches, 1, what, per_plan=_horizon_want(KlergConfig(**mode)),
                          record=False)
        if float(u_c.abs().max()) == 0.0:
            raise RuntimeError(f"{what}: the plan is all zeros")
        for key, err in (("u", _max_err([u_g], [u_c])), ("cost", float((cost_g - cost_c).abs())),
                         ("R", _max_err([R_g], [R_c])), ("RtR", rtr)):
            worst[key] = max(worst[key], err)
    print(f"[agreement] planner, {len(PLANNER_CASES)} toy calls (4 dynamics x 4 policies, 5 "
          f"modes on the roll model), cuda vs cpu with fed draws: max|du| {worst['u']:.3e}, "
          f"max|dcost| {worst['cost']:.3e}, max|dR| {worst['R']:.3e}, max|R^T R - I| "
          f"{worst['RtR']:.3e}; 13 K1 launches per call on the card in every mode, and the "
          f"horizon kernels' launches of its mode")


def _train_draws(cfg, n_filled, rng, dev):
    import torch
    from ealv_tpu_torch.runtime import TrainDraws
    steps, B = cfg.num_learning_opt, cfg.batch_size
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)
    return TrainDraws(idx=t(rng.integers(0, n_filled, (steps, B)), torch.int64),
                      idx2=t(rng.integers(0, n_filled, (steps, B)), torch.int64),
                      eps=t(rng.standard_normal((steps, B, cfg.z_dim))))


def _trainer_experiment(cfg, dev, kernels: bool, mesh=None):
    """An Experiment (over ``mesh``, if given) with both trainer kernels on
    (fast_encoder_grads="pallas", fused_adam=True) or both off, weights
    from seed 0."""
    from ealv_tpu_torch.runtime import Experiment
    cfg = dataclasses.replace(cfg, fast_encoder_grads="pallas" if kernels else False)
    exp = Experiment(cfg, train_calls_per_tick=1, train_every=3, device=dev, mesh=mesh)
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


def _profile(call):
    """One call under torch.profiler, ending in a synchronize: (its host
    ms, the device's work as ``port_bench.trace.events`` reads it: kernels,
    copies and sets, [(name, start_ns, end_ns)])."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return wall, trace.events(prof)[0]


def _profiled_call(call):
    """One call under torch.profiler (``_profile``): its host clock; the
    device's busy time, the union of its kernels' and copies' intervals
    (``port_bench.trace.busy_ns``); the plain sum of those intervals (more
    than the union only if some overlapped); their time summed by name (a
    second reading of the same intervals, ``port_bench.trace.by_name``);
    and the number of intervals. All in ms but the count."""
    wall, device = _profile(call)
    if not device:
        return wall, 0.0, 0.0, 0.0, 0
    lo, hi = min(a for _, a, _ in device), max(b for _, _, b in device)
    return (wall, trace.busy_ns(device, lo, hi) / 1e6,
            sum(b - a for _, a, b in device) / 1e6,
            sum(trace.by_name(device, lo, hi).values()) * 1e3, len(device))


def _behind_spin(call, spin_s=0.2):
    """Enqueue ``call`` behind a ``spin_s`` spin kernel: (seconds until the
    host got control back, seconds until the device finished). A call that
    never waits for the device returns long before the spin ends, unless
    it makes more launches than the card's launch queue holds (about a
    thousand): then the host waits for room in the queue."""
    import torch
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e9 * spin_s))
    t0 = time.perf_counter()
    call()
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    return enqueue, time.perf_counter() - t0


def _sync_free(path, parts):
    """Run the calls ``parts`` [(name, call)] in order under
    ``torch.cuda.set_sync_debug_mode("error")``, where any call that
    synchronises with the device (a blocking copy, ``.item()``, ``nonzero``,
    a synchronize) raises. On a failure the parts run again in "warn" mode
    to list every synchronising call with its line in the port; then the
    phase raises."""
    import traceback
    import warnings
    import torch

    def where():
        frames = [f for f in traceback.extract_stack() if "ealv_tpu_torch" in f.filename]
        if not frames:
            return "outside the port"
        f = frames[-1]
        return f"{f.filename.split('ealv_tpu_torch')[-1].lstrip('/')}:{f.lineno} {f.line}"

    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        for name, call in parts:
            call()
    except RuntimeError as e:
        if "synchroniz" not in str(e):
            raise
        found = []
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = lambda msg, *a, **k: found.append(f"{name}: {where()}")
            torch.cuda.set_sync_debug_mode("warn")
            for name, call in parts:
                call()
        raise RuntimeError(f"{path}: synchronising calls under set_sync_debug_mode: "
                           f"{found or e}") from e
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"[sync] {path}: {', '.join(n for n, _ in parts)} ran under "
          f"torch.cuda.set_sync_debug_mode('error'); none synchronised")


def _sync_check_catches():
    """The sync check itself: the two per-step copies SyntheticEnv.step_vel
    made before it built its constants once (its limits as a tensor from a
    Python tuple, and a Python scalar written into one element of its
    z-mask) each fail ``_sync_free``."""
    import torch
    mask = torch.ones(6, dtype=torch.bool, device="cuda")
    cases = {"a tensor from a Python tuple": lambda: torch.tensor(
                 ((0.325, 0.625),) * 6, device="cuda"),
             "a Python scalar written into one element": lambda: mask.__setitem__(2, False)}
    for what, call in cases.items():
        try:
            _sync_free(what, [(what, call)])
        except RuntimeError as e:
            print(f"[sync] the check catches {what}: {str(e)[:160]}")
            continue
        raise RuntimeError(f"the sync check missed {what}")


def _tick_builders():
    """``tests/test_torch_sync.py``, which builds the ticks the sync check
    runs, for its toy checks and here: ``untrained_tick(exp, es)`` (one
    ``Experiment.tick`` that makes no trainer call) and
    ``fingerprint_ticks(...)`` (a capture tick, an identification tick in
    each seek mode). It imports no JAX."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import test_torch_sync
    return test_torch_sync


def _plan_bisect(exp, es):
    """Where the host waits in a production plan_step: first the card's
    launch queue (trivial launches behind a spin kernel until one blocks),
    then plan_step itself and each piece of it (the sync, the draws, the
    target decode, the base footprint, the initial cost and the first
    inner iteration's forward, footprint, backward, line search and cost)
    enqueued behind a spin kernel, with its device intervals under the
    profiler. A piece under the queue's depth that returns only after the
    spin waits for the device, and fails the check."""
    import torch
    from ealv_tpu_torch.ops import cost_norm, renormalize, traj_footprint

    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e9 * 0.5))
    depth, t_prev = None, time.perf_counter()
    for i in range(4096):
        x.add_(1.0)
        t = time.perf_counter()
        if depth is None and t - t_prev > 0.05:
            depth = i
        t_prev = t
    torch.cuda.synchronize()
    print(f"[plan bisect] the launch queue: behind a 0.5 s spin kernel the host blocked at "
          f"launch {depth} of 4096 one-element adds")

    pl, cfg, ctx = exp.planner, exp.planner.cfg, (es.model, es.mstate)
    full = exp._measured_robot_state(es.env)
    use_prior = es.explr_step < exp.cfg.prior_steps
    st = {}
    cost = lambda u: pl._cost(st["ps"].dyn, u, st["samples"], st["p_n"], st["qb"],
                              st["ps"].barrier)

    def target():
        st["p"] = pl._target_dist(ctx, st["ps"], st["samples"], 1.0, use_prior=use_prior)
        st["p_n"] = cost_norm(st["p"])

    def footprint():
        q_iter = traj_footprint(st["fw"][1], st["samples"], pl._explr_idx, pl.std)
        st["q"] = renormalize(st["qb"] + q_iter)

    def backward():
        u_eff, xs, A, B, dbarr, dmu = st["fw"]
        du, st["djdlam"] = pl._backward(st["samples"], st["p"], st["q"], xs, A, B, dbarr, dmu)
        st["u_star"] = pl._saturate(u_eff + cfg.alpha * du)

    def apply():
        st["u_new"], _ = pl._apply(cost, st["ps"].u, st["fw"][0], st["u_star"],
                                   st["djdlam"], 0, st["J0"])

    pieces = [
        ("plan_step", lambda: exp.plan_step(es, full)),
        ("save_update", lambda: st.update(ps=pl.save_update(es.pstate, full, save=False))),
        ("_draw_samples", lambda: st.update(samples=pl._draw_samples(st["ps"]))),
        ("memory.sample", lambda: st.update(
            hist=st["ps"].memory.sample(cfg.num_traj_samples, st["ps"].gen))),
        ("_target_dist (pdf decode, spread)", target),
        ("base footprint", lambda: st.update(qb=traj_footprint(
            st["hist"][0], st["samples"], pl._explr_idx, pl.std, traj_mask=st["hist"][1]))),
        ("initial cost", lambda: st.update(J0=cost(st["ps"].u))),
        ("forward", lambda: st.update(fw=pl._forward(st["ps"], st["ps"].u, 0))),
        ("iteration footprint", footprint),
        ("backward", backward),
        ("_apply (line search)", apply),
        ("iteration cost", lambda: cost(st["u_new"]))]
    rows = []
    for name, call in pieces:
        _, _, _, _, n = _profiled_call(call)
        enqueue, spun = _behind_spin(call)
        rows.append((name, n, enqueue * 1e3, spun * 1e3))
        print(f"[plan bisect] {name}: {n} device intervals; behind a 0.2 s spin kernel the "
              f"host enqueued it in {enqueue * 1e3:.2f} ms of {spun * 1e3:.1f} ms")
    waits = [r for r in rows if r[1] < 1000 and r[2] > 0.5 * r[3]]
    if waits:
        raise RuntimeError(f"plan_step pieces under the launch queue's depth waited for "
                           f"the device: {waits}")


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


def _by_kernel(call):
    """Device ms per kernel or copy name in one call under torch.profiler
    (``port_bench.trace.by_name``)."""
    _, device = _profile(call)
    if not device:
        return {}
    lo, hi = min(a for _, a, _ in device), max(b for _, _, b in device)
    return {k: v * 1e3 for k, v in trace.by_name(device, lo, hi).items()}


def _pool_mib(graph):
    """The MiB of the memory segments in a step graph's pool (which the
    graphs of its patterns, and of the steps that share the pool, use),
    from ``torch.cuda.memory_snapshot()``; None where the snapshot does not
    name segments' pools."""
    import torch
    pool = tuple(graph.pool.id)
    segs = torch.cuda.memory_snapshot()
    if not any("segment_pool_id" in seg for seg in segs):
        return None
    return sum(seg["total_size"] for seg in segs
               if tuple(seg.get("segment_pool_id", ())) == pool) / 2**20


def _timed(call):
    """Host ms of one call that ends in a synchronize."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _post_train_draws(cfg, n_filled, rng):
    """Fed draws of one post-training call: the grade's samples in the
    robot limits and the trainer call's draws."""
    import torch
    from ealv_tpu_torch.runtime import PostTrainDraws
    lo, hi = cfg.robot_lim[:, 0], cfg.robot_lim[:, 1]
    return PostTrainDraws(samples=torch.as_tensor(
        rng.uniform(lo, hi, (cfg.num_target_samples, cfg.s_dim)), dtype=torch.float32,
        device="cuda"), train=_train_draws(cfg, n_filled, rng, "cuda"))


def phase_trainer_capture(n_filled=200, rounds=2):
    """The trainer call captured in the post-training call's graph
    (``Experiment.post_train_graph``, ``runtime/graphs.py``) against the
    eager call at production size, with the trainer kernels on and off.
    Three experiments from seed 0, their rings filled alike; two make their
    post-training calls eagerly (the graph set to None), one through the
    graph (an eager call, a capture and its replay, a replay), each on the
    same fed draws: the captured calls' rows and parameters must equal the
    eager ones bit for bit where the two eager experiments agree bit for
    bit, and stay within their spread where they do not. Then, on the
    generator's draws, host ms and device busy ms per call, eager against
    captured in turns (eager, captured, captured, eager); the capture's
    seconds and memory; the optimizer per captured call (stock foreach
    capturable, fused capturable, K2's FusedAdam); and where the busy time
    of an eager call with the kernels on and off parts, by kernel name."""
    import torch
    from ealv_tpu_torch.ops.adam import FusedAdam
    from ealv_tpu_torch.utils.config import ExperimentConfig

    cfg = ExperimentConfig(**PRODUCTION)
    err = lambda a, b: max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))
    out, by_kernel = {}, {}
    for on in (True, False):
        runs = [_trainer_experiment(cfg, "cuda", kernels=on) for _ in range(3)]
        for exp, es in runs:
            _fill_ring(es, cfg, n_filled)
        for exp, _ in runs[:2]:
            exp.post_train_graph = None
        graph = runs[2][0].post_train_graph
        rng = np.random.default_rng(11)
        spread = captured = 0.0
        for _ in range(3):
            draws = [_post_train_draws(cfg, n_filled, rng)]
            leaves = []
            for exp, es in runs:
                rows = exp.post_train_chunk(es, 1, draws)[1]
                leaves.append([*rows.values(), *(q.detach() for q in es.model.parameters())])
            spread = max(spread, err(leaves[1], leaves[0]))
            captured = max(captured, err(leaves[2], leaves[0]))
        name = "kernels on (K2 + K3)" if on else "kernels off (torch.optim.Adam + cuDNN)"
        if graph.counts != {(): [1, 1, 2]}:
            raise RuntimeError(f"post-training graph, {name}: [eager, captured, replays] "
                               f"{graph.counts}")
        if captured > spread:
            raise RuntimeError(f"captured trainer call, {name}: max|captured - eager| "
                               f"{captured:.3e} over 3 calls, two eager calls {spread:.3e}")
        print(f"[trainer graph] {name}, production size, fed draws, post-training calls: an "
              f"eager call, a capture and its replay, a replay; rows and parameters "
              f"max|captured - eager| {captured:.3e}, two eager experiments {spread:.3e}"
              + (" (bit for bit)" if captured == 0.0 else ""))
        # on the generator's draws: a new key, so one eager call and a capture
        (exp_e, es_e), (exp_g, es_g) = runs[0], runs[2]
        eager = lambda: exp_e.post_train_chunk(es_e, 1)
        replay = lambda: exp_g.post_train_chunk(es_g, 1)
        replay()
        capture_ms = _timed(replay)
        pool = _pool_mib(graph)
        recorded = graph.entries[((), None)].recorded
        times = {"eager": [], "captured": []}
        for _ in range(rounds):
            for which, call in (("eager", eager), ("captured", replay), ("captured", replay),
                                ("eager", eager)):
                times[which].append(_timed(call))
        peaks = {}
        for which, call in (("eager", eager), ("captured", replay)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            call()
            torch.cuda.synchronize()
            peaks[which] = torch.cuda.max_memory_allocated() / 2**20
        prof = {which: _profiled_call(call)
                for which, call in (("eager", eager), ("captured", replay))}
        res = {which: dict(host_ms=float(np.median(times[which])), busy_ms=prof[which][1])
               for which in times}
        res.update(capture_s=graph.capture_seconds[()][-1], pool_mib=pool)
        out[on] = res
        print(f"[trainer graph] {name}, generator draws: host ms per post-training call "
              f"eager {res['eager']['host_ms']:.2f}, captured {res['captured']['host_ms']:.2f} "
              f"(median of {2 * rounds}, in turns; eager {[round(x, 2) for x in times['eager']]}, "
              f"captured {[round(x, 2) for x in times['captured']]}); profiled: eager host "
              f"{prof['eager'][0]:.2f} ms, busy {prof['eager'][1]:.2f} ms in {prof['eager'][4]} "
              f"intervals; captured host {prof['captured'][0]:.2f} ms, busy "
              f"{prof['captured'][1]:.2f} ms in {prof['captured'][4]} intervals; capture "
              f"{res['capture_s']:.3f} s (the capturing call {capture_ms:.1f} ms with "
              f"its replay), the experiment's pool "
              f"{'not measured' if pool is None else f'{pool:.1f} MiB'}; peak allocated eager "
              f"{peaks['eager']:.1f} MiB, captured {peaks['captured']:.1f} MiB; the capture "
              f"recorded K2 {recorded['adam_apply']} and K3 "
              f"{recorded['conv_wgrad_direct']} launches")
        by_kernel[on] = _by_kernel(eager)
        if not on:
            stock = {}
            for opt_name, make in (
                    ("foreach, capturable (the stock default)", None),
                    ("fused, capturable", lambda ps: torch.optim.Adam(
                        ps, lr=exp_g.trainer.lr, fused=True, capturable=True)),
                    ("FusedAdam (K2)", lambda ps: FusedAdam(ps, lr=exp_g.trainer.lr))):
                if make is not None:
                    es_g.opt = make(es_g.model.parameters())
                    replay()
                    replay()
                stock[opt_name] = _profiled_call(replay)
            print("[trainer graph] the optimizer per captured post-training call (cuDNN "
                  "wgrad), device busy ms / host ms: " + "; ".join(
                      f"{k} {v[1]:.2f} / {v[0]:.2f}" for k, v in stock.items()))
    names = set(by_kernel[True]) | set(by_kernel[False])
    diff = sorted(names, key=lambda k: -abs(by_kernel[True].get(k, 0.0)
                                            - by_kernel[False].get(k, 0.0)))
    total = {on: sum(v.values()) for on, v in by_kernel.items()}
    print(f"[trainer graph] device ms by kernel of an eager post-training call, kernels on "
          f"{total[True]:.2f} vs off {total[False]:.2f}; the largest differences: " + "; ".join(
              f"{k[:70]} {by_kernel[True].get(k, 0.0):.2f} vs {by_kernel[False].get(k, 0.0):.2f}"
              for k in diff[:10]))
    return out


def _pattern_name(pattern) -> str:
    """A tick pattern (trainer calls, prior, drift corrections) in words."""
    if pattern == ():
        return "call"
    do, prior, drift = pattern
    return (f"{sum(do)} trainer call{'s' * (sum(do) != 1)}" + (", prior" if prior else "")
            + (f", {sum(drift)} drift" if any(drift) else ""))


def _graph_note(exp):
    """The experiment's captured steps: eager steps, captures (seconds)
    and replays of each pattern."""
    out = []
    for name, g in (("tick", exp.tick_graph), ("post-training", exp.post_train_graph)):
        if g is None or not (g.warmups or g.replays):
            continue
        out.append(f"{name} graphs " + ", ".join(
            f"[{_pattern_name(p)}: {w} eager, {c} captured ("
            f"{', '.join(f'{t:.2f}' for t in g.capture_seconds.get(p, []))} s), "
            f"{r} replays]" for p, (w, c, r) in g.counts.items()))
    return "; ".join(out)


def _experiment(cfg, graphs=True):
    """A production Experiment (a trainer call every third tick; K2 with
    K3) running its ticks with tick graphs (the default on the card) or,
    without ``graphs``, eagerly."""
    from ealv_tpu_torch.runtime import Experiment
    exp = Experiment(cfg, train_calls_per_tick=1, train_every=3, device="cuda")
    if cfg.fast_encoder_grads:
        exp.trainer = dataclasses.replace(exp.trainer, fused_adam=True)
    if not graphs:
        exp.tick_graph = exp.post_train_graph = None
    return exp


def _ready(exp, es, n):
    """Every one of the next ``n`` ticks replays its pattern's tick graph:
    the patterns follow from the host ints alone."""
    s = dataclasses.replace(es)
    for _ in range(n):
        pattern = exp._tick_pattern(s)
        if (pattern, None) not in exp.tick_graph.entries:
            return False
        s.explr_step += 1
        s.learning_ind += sum(pattern[0])
        if hasattr(s.env, "count"):
            s.env = dataclasses.replace(s.env, count=s.env.count + exp.cfg.data_to_ctrl_rate)
    return True


def _stacked(infos):
    """Per-tick info dicts and stacked chunk infos, stacked over all ticks."""
    import torch
    parts = [{k: v[None] for k, v in i.items()} if i["loss"].dim() == 0 else i
             for i in infos]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def _snapshot(es):
    """The state's leaves, tensors cloned: a captured tick overwrites its
    carry's buffers in place."""
    import torch
    from ealv_tpu_torch.runtime.checkpoint import state_leaves
    return [(p, v.clone() if isinstance(v, torch.Tensor) else v) for p, v in state_leaves(es)]


def _held_equal(what, want, got):
    """Raise where two runs' stacked infos or state leaves differ."""
    import torch
    if isinstance(want, dict):
        for k in want:
            bad = (want[k] != got[k]).reshape(want[k].shape[0], -1).any(1).nonzero()
            if bad.numel():
                err = _max_err([got[k].float()], [want[k].float()])
                raise RuntimeError(f"{what}: info {k!r} differs from tick {int(bad[0])}: "
                                   f"max|diff| {err:.3e}")
        return
    for (path, a), (_, b) in zip(want, got, strict=True):
        same = torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
        if not same:
            raise RuntimeError(f"{what}: {path} differs")


def _tick_paths(cfg, n_timed, least=9):
    """The production tick over ``cfg`` two ways in one call, each from
    seed 0 with a trainer call every third tick:

    - tick graphs: warm ticks (at least ``least``) until each of the next
      ``n_timed`` + 3 ticks replays its pattern's graph, then ``n_timed``
      timed ticks, every one a replay; the kernels counted through the
      graphs, the wrappers' eager counts 0; every tick's info and the whole
      state then held bit for bit against an eager experiment that takes
      the same ticks (its last ``n_timed`` timed);
    - eager: the tick and post-training graphs set to None;

    then three ticks of each under torch.profiler (host ms, busy ms,
    intervals). Returns (the tick graphs' experiment, its state,
    readings)."""
    import torch
    from ealv_tpu_torch.runtime.graphs import kernel_counts, kernel_launches, reset_launches

    out = dict(ms={}, peak={}, profile={})

    def timed(exp, es, n=n_timed):
        reset_launches(*exp.graphs())
        calls0 = es.learning_ind
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, infos = exp.run_chunk(es, n)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3, infos, es.learning_ind - calls0

    def profiled(mode, exp, es):
        wall, busy, _, _, n = _profiled_call(lambda: exp.run_chunk(es, 3))
        out["profile"][mode] = dict(host_ms=wall, busy_ms=busy, intervals=n)

    def reset():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    def peak(base):  # the MiB a run added at its peak to what was held before it
        return (torch.cuda.max_memory_allocated() - base) / 2**20

    # tick graphs
    base = reset()
    exp = _experiment(cfg)
    es = exp.init(seed=0)
    warm = []
    while len(warm) < least or not _ready(exp, es, n_timed + 3):
        if len(warm) > 150:
            raise RuntimeError(f"tick graphs: not every pattern captured after 150 ticks: "
                               f"{_graph_note(exp)}")
        warm.append(exp.tick(es)[1])
    out["ms"]["ticks"], infos, calls = timed(exp, es)  # replays counted from 0
    out["peak"]["ticks"] = peak(base)
    out["launches"], out["calls"] = kernel_launches(*exp.graphs()), calls
    eager_counts = kernel_counts()
    if exp.tick_graph.replays != n_timed or any(eager_counts.values()):
        raise RuntimeError(f"tick graphs: {exp.tick_graph.replays} replays in "
                           f"{n_timed} timed ticks, eager wrapper launches {eager_counts}")
    run = _stacked(warm + [infos])
    state = _snapshot(es)
    out["infos"], out["n_warm"] = infos, len(warm)
    out["capture_s"] = {_pattern_name(p): t for p, t in exp.tick_graph.capture_seconds.items()}
    out["pool_mib"] = _pool_mib(exp.tick_graph)
    profiled("ticks", exp, es)

    # eager, the same ticks
    base = reset()
    exp_e = _experiment(cfg, graphs=False)
    es_e = exp_e.init(seed=0)
    warm_e = [exp_e.tick(es_e)[1] for _ in range(len(warm))]
    out["ms"]["eager"], infos_e, _ = timed(exp_e, es_e)
    out["peak"]["eager"] = peak(base)
    _held_equal("tick graphs against eager ticks", _stacked(warm_e + [infos_e]), run)
    _held_equal("tick graphs against eager ticks", _snapshot(es_e), state)
    out["held"] = (len(warm) + n_timed, len(state))
    del state, run
    profiled("eager", exp_e, es_e)
    del exp_e, es_e
    torch.cuda.empty_cache()
    return exp, es, out


def _two_ways(name, r) -> str:
    """A path's readings in one line."""
    p = r["profile"]
    return (f"[{name}] ms/tick: tick graphs {r['ms']['ticks']:.2f}, eager "
            f"{r['ms']['eager']:.2f} | 3 profiled ticks, host ms / busy ms / intervals: "
            + "; ".join(f"{m} {p[m]['host_ms']:.2f} / {p[m]['busy_ms']:.2f} / "
                        f"{p[m]['intervals']}" for m in ("ticks", "eager"))
            + " | peak MiB above the memory held before the run: "
            + ", ".join(f"{m} {v:.1f}" for m, v in r["peak"].items())
            + f" | tick graphs' pool {r['pool_mib']} MiB | capture s by pattern "
            f"{r['capture_s']} | {r['held'][0]} ticks ({r['n_warm']} warm) bit-equal to eager "
            f"ticks, infos and {r['held'][1]} state leaves")


def phase_main_path(states="xyw", n_timed=24):
    """The tick path at production size over ``states``, two ways
    (``_tick_paths``: tick graphs bit-equal to eager ticks), 13 K1 launches
    a tick counted through the tick graphs; then the checks of the path's
    state and the sync check on a replayed tick without and with a trainer
    call. Returns (launches, ms/tick, peak MiB, readings)."""
    import torch
    from ealv_tpu_torch.utils.config import ExperimentConfig

    cfg = ExperimentConfig(**{**PRODUCTION, "states": states})
    exp, es, r = _tick_paths(cfg, n_timed)
    launches = r["launches"]["footprint_and_spread"]
    losses = r["infos"]["loss"].cpu()
    costs = r["infos"]["ergodic_cost"].cpu()
    trained = losses[losses != 0]
    if launches != 13 * n_timed:
        raise RuntimeError(f"footprint kernel launched {launches} times in {n_timed} ticks "
                           f"through the tick graphs, expected {13 * n_timed}")
    _horizon_launches(r["launches"], n_timed, f"main path {states}, tick graphs")
    if not (torch.isfinite(costs).all() and torch.isfinite(losses).all()):
        raise RuntimeError(f"non-finite costs {costs} or losses {losses}")
    if r["calls"] <= 0 or trained.numel() == 0:
        raise RuntimeError(f"the trainer never ran in the timed ticks ({r['calls']} calls)")
    if not all(p.is_cuda for p in es.model.parameters()) or not es.buf.y.is_cuda:
        raise RuntimeError("parameters or the replay ring left the card")
    if es.buf.y.dtype != torch.bfloat16 or int(es.buf.size) != es.explr_step:
        raise RuntimeError(f"replay ring {es.buf.y.dtype}, size {int(es.buf.size)}")
    R = es.pstate.dyn.R
    rtr = float((R.T @ R - torch.eye(3, device=R.device)).abs().max())
    if not rtr < 1e-5:
        raise RuntimeError(f"the planner's R is off orthonormal by {rtr}")
    ms = r["ms"]["ticks"]
    print(f"[main path {states}] {n_timed} timed ticks through the tick graphs: {ms:.2f} "
          f"ms/tick = {1e3 / ms:.2f} Hz | last loss {float(trained[-1]):.4f} | ergodic cost "
          f"{float(costs[-1]):.4f} | {r['calls']} trainer calls | K1 launches {launches} "
          f"(13/tick, the wrappers' eager counts 0), horizon_rollout "
          f"{r['launches']['horizon_rollout']} (17/tick), costate_sweep "
          f"{r['launches']['costate_sweep']} (5/tick) | planner |R^T R - I| {rtr:.1e} | "
          f"{_graph_note(exp)}")
    print(_two_ways(f"main path {states}", r))
    if states == "xyw":
        _sync_check_catches()
    ticks = _tick_builders()
    _sync_free(f"{states} tick", ticks.untrained_tick(exp, es))
    _sync_free(f"{states} tick with a trainer call", ticks.trained_tick(exp, es))
    if states == "xyw":
        _plan_bisect(exp, es)
    return launches, ms, r["peak"]["ticks"], r


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


def phase_variant_path(n_timed=12):
    """The experiment's options together at production width: states
    "xywb" (the brightness state), the force variant, the z-ensemble target
    (5 x 2000 decoder rows a plan) and both trainer kernels on; two ways
    (``_tick_paths``), with K1, K2 and K3 counted through the tick graphs
    over the timed ticks (13 K1 launches a tick and one per trainer call,
    whose entropy grade takes a fresh plain decode under the ensemble; 25
    K2 and 75 K3 a trainer call). Then the ensemble pdf at 2000 samples
    against its plain decode-and-average, in the bf16 model and in an f32
    copy, and both timed. Returns (ms/tick, peak MiB, (K1, K2, K3
    launches), readings)."""
    import torch
    from ealv_tpu_torch.utils.config import ExperimentConfig
    from ealv_tpu_torch.utils.timing import device_ms, host_ms

    cfg = ExperimentConfig(**{**PRODUCTION, "states": "xywb"}, learn_force=True,
                           use_z_ensemble=True, fast_encoder_grads="pallas")
    exp, es, r = _tick_paths(cfg, n_timed)
    counts, calls = r["launches"], r["calls"]
    k1, k2, k3 = (counts["footprint_and_spread"], counts["adam_apply"],
                  counts["conv_wgrad_direct"])
    if calls <= 0:
        raise RuntimeError("the variant path made no trainer call in the timed ticks")
    if (k1, k2, k3) != (13 * n_timed + calls, 25 * calls, 75 * calls):
        raise RuntimeError(f"variant path: {calls} trainer calls in {n_timed} ticks made "
                           f"K1 {k1}, K2 {k2}, K3 {k3} launches; expected "
                           f"{13 * n_timed + calls}, {25 * calls}, {75 * calls}")
    _horizon_launches(counts, n_timed, "variant path, tick graphs")
    losses, costs = r["infos"]["loss"].cpu(), r["infos"]["ergodic_cost"].cpu()
    if not (torch.isfinite(losses).all() and torch.isfinite(costs).all()):
        raise RuntimeError(f"non-finite losses {losses} or costs {costs}")
    b = es.env.brightness
    if not (torch.isfinite(b) and es.buf.x.shape[1] == 4 and es.model.learn_force):
        raise RuntimeError(f"brightness {b}, ring width {es.buf.x.shape[1]}")
    if float(es.mstate.z_buff.abs().amin(1).min()) == 0.0:
        raise RuntimeError("the z ring is not full after the warm and timed ticks")
    dt = r["ms"]["ticks"]
    print(f"[variant path] xywb, learn_force, use_z_ensemble, K2 and K3 on: {n_timed} timed "
          f"ticks through the tick graphs: {dt:.2f} ms/tick = {1e3 / dt:.2f} Hz | {calls} "
          f"trainer calls | K1 {k1} (13/tick + 1/call) | K2 {k2} (25/call) | K3 {k3} "
          f"(75/call) | last loss {float(losses[losses != 0][-1]):.4f} | brightness "
          f"{float(b):.4f} | {_graph_note(exp)}")
    print(_two_ways("variant path", r))
    ticks = _tick_builders()
    _sync_free("xywb force z-ensemble tick", ticks.untrained_tick(exp, es))
    _sync_free("xywb force z-ensemble tick with a trainer call", ticks.trained_tick(exp, es))

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
    return dt, r["peak"]["ticks"], (k1, k2, k3), r


def _option_layers(dev):
    """The options' layers at the production shapes (TF32 off): each
    subpixel form against F.conv_transpose2d at the decoder's three layers
    (f32); the s2d and im2col schedules' dW against the exact sums
    (``conv_wgrad_reference`` in f64) at the encoder's three layers, f32
    and bf16 inputs, the first layer's input a channels-last view as the
    CVAE gives it; the lane-padded conv and transposed conv (lane 8, f32)
    against the unpadded ones, their padded channels exact zeros. Returns
    the largest errors by check."""
    import torch
    import torch.nn.functional as F
    from ealv_tpu_torch.models.cvae import _lane_padded
    from ealv_tpu_torch.models.subpixel import (subpixel_conv_transpose,
                                                subpixel_conv_transpose_d2s)
    from ealv_tpu_torch.ops import fast_conv, wgrad as twg

    g = torch.Generator(device=dev).manual_seed(5)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev)
    worst = {}

    def held(what, got, want, tol):
        torch.testing.assert_close(got.double(), want.double(), **tol,
                                   msg=lambda e: f"model options, {what}: {e}")
        err = float((got.double() - want.double()).abs().max())
        worst[what.split(" at ")[0]] = max(worst.get(what.split(" at ")[0], 0.0), err)

    def padded(what, got, want, c):
        if float(got[:, c:].abs().max()) != 0.0:
            raise RuntimeError(f"model options, {what}: a padded channel is not zero")
        held(what, got[:, :c], want, LANE_TOL)

    for B, h, cin, cout, k, s in DECODER_LAYERS:
        x, b = rnd(B, cin, h, h), rnd(cout)
        w = rnd(cin, cout, k, k) / (cin * k * k) ** 0.5
        ref = F.conv_transpose2d(x, w, b, stride=s)
        for name, f in (("subpixel", subpixel_conv_transpose),
                        ("subpixel d2s", subpixel_conv_transpose_d2s)):
            held(f"{name} at {(B, h, cin, cout, k, s)}", f(x, w, s) + b[:, None, None], ref,
                 SUBPIXEL_TOL)
        padded(f"lane_pad 8 transposed conv at {(B, h, cin, cout, k, s)}",
               F.conv_transpose2d(*_lane_padded(x, w, b, 8, transposed=True), stride=s),
               ref, cout)
    for i, (B, H, W, cin, cout, k, s) in enumerate(WGRAD_PRODUCTION):
        taps = fast_conv.tap_index(k, s, cin, dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = rnd(B, H, W, cin).to(dtype).permute(0, 3, 1, 2)
            if i:
                x = x.contiguous()
            cot = rnd(B, cout, (H - k) // s + 1, (W - k) // s + 1).to(dtype)
            want = twg.conv_wgrad_reference(x, cot, k, s, dtype=torch.float64)
            for name, dw in (("s2d", fast_conv._dw_s2d(x, cot, k, s, taps)),
                             ("im2col", fast_conv._dw_im2col(x, cot, k, s))):
                tol = WGRAD_TOL if dw.dtype == torch.float32 else WGRAD_BF16_OUT_TOL
                held(f"{name} dW, {str(dtype)[6:]} in, {str(dw.dtype)[6:]} out at "
                     f"{(B, H, cin, cout, k, s)}", dw, want, tol)
        x, b = rnd(B, cin, H, W), rnd(cout)
        w = rnd(cout, cin, k, k) / (cin * k * k) ** 0.5
        padded(f"lane_pad 8 conv at {(B, H, cin, cout, k, s)}",
               F.conv2d(*_lane_padded(x, w, b, 8, transposed=False), stride=s),
               F.conv2d(x, w, b, stride=s), cout)
    print("[model options] layers at the production shapes, max|diff| against the plain "
          "version (f32 tolerance rtol/atol " + f"{SUBPIXEL_TOL['rtol']:g} subpixel, "
          f"{LANE_TOL['rtol']:g} lane pad; dW against the f64 sums at K3's {WGRAD_TOL}, "
          f"bf16 outputs {WGRAD_BF16_OUT_TOL}): " + "; ".join(
              f"{k} {v:.3e}" for k, v in worst.items()))
    return worst


def _option_toy_agreement(name, opts):
    """One toy trainer call under the option on the card and on the CPU
    from the same weights, ring and fed draws (f32, TF32 off): the losses
    at rtol 1e-3, atol 1e-4 as the default's (phase 4), the parameters
    within two Adam steps' reach of rounding-level gradients (2 lr a
    step). Returns (max|loss diff|, max|param diff|)."""
    import torch
    from ealv_tpu_torch.runtime import Experiment, train_call
    from ealv_tpu_torch.utils.config import ExperimentConfig

    cfg = ExperimentConfig(states="xyw", num_target_samples=64, num_traj_samples=100,
                           image_dim=(24, 24, 3), batch_size=8, num_learning_opt=2,
                           compute_dtype="float32", **opts)
    rng = np.random.default_rng(2)
    xs = rng.uniform(cfg.robot_lim[:, 0], cfg.robot_lim[:, 1], (12, cfg.s_dim))
    ys = rng.uniform(0, 1, (12, *cfg.image_dim))
    draws = _train_draws(cfg, 12, rng, "cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        exp = Experiment(cfg, train_calls_per_tick=1, train_every=3, device=dev)
        es = exp.init(seed=0)
        t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
        for x, y in zip(xs, ys):
            es.buf.push(t(x), t(y))
        met = train_call(exp.trainer, es.model, es.opt, es.buf, t(0.01), t(0.5),
                         draws=dataclasses.replace(
                             draws, **{f: getattr(draws, f).to(dev) for f in ("idx", "idx2", "eps")}))
        out[dev] = (met["loss"].cpu(), [p.detach().cpu() for p in es.model.parameters()])
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-3, atol=1e-4,
                               msg=lambda e: f"model option {name}, toy trainer call: {e}")
    perr = _max_err(out["cuda"][1], out["cpu"][1])
    if not perr <= 2 * cfg.model_lr * cfg.num_learning_opt:
        raise RuntimeError(f"model option {name}, toy trainer call: parameters {perr:.3e} "
                           "apart, card against CPU")
    return float((out["cuda"][0] - out["cpu"][0]).abs().max()), perr


def _option_production(name, opts, n_timed=6, rounds=4):
    """The production Experiment under the option (bf16, a trainer call
    every third tick, the trainer kernels off) through its tick graphs:
    warm ticks (at least 9) until each of the next ``n_timed`` + 3 replays
    its pattern's graph, then ``n_timed`` timed ticks (two or more trainer
    calls among them, replayed), K1, K2 and K3 counted through the graphs
    (13, 0 and 0 a tick; the wrappers' eager counts 0); every tick's info
    and the state then held bit for bit against an eager experiment taking
    the same ticks; the sync check on a replayed tick with a trainer call;
    then the trainer call captured in a post-training call (the
    post-training graph: an eager call, a capture) on the tick graphs'
    experiment: host ms per replay (median of ``rounds``), device busy ms
    and intervals (one profiled replay), its capture seconds. Returns the
    readings."""
    import gc
    import torch
    from ealv_tpu_torch.runtime import Experiment
    from ealv_tpu_torch.runtime.graphs import kernel_counts, kernel_launches, reset_launches
    from ealv_tpu_torch.utils.config import ExperimentConfig

    cfg = ExperimentConfig(**PRODUCTION, **opts)

    def make(graphs):
        exp = Experiment(cfg, train_calls_per_tick=1, train_every=3, device="cuda")
        if not graphs:
            exp.tick_graph = exp.post_train_graph = None
        return exp, exp.init(seed=0)

    exp, es = make(True)
    warm = []
    while len(warm) < 9 or not _ready(exp, es, n_timed + 3):
        if len(warm) > 60:
            raise RuntimeError(f"model option {name}: not every pattern captured after 60 "
                               f"ticks: {_graph_note(exp)}")
        warm.append(exp.tick(es)[1])
    reset_launches(*exp.graphs())
    calls0 = es.learning_ind
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, infos = exp.run_chunk(es, n_timed)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_timed * 1e3
    launches, calls, eager = kernel_launches(*exp.graphs()), es.learning_ind - calls0, \
        kernel_counts()
    k1, k2, k3 = (launches[k] for k in ("footprint_and_spread", "adam_apply",
                                        "conv_wgrad_direct"))
    if exp.tick_graph.replays != n_timed or any(eager.values()):
        raise RuntimeError(f"model option {name}: {exp.tick_graph.replays} replays in "
                           f"{n_timed} timed ticks, eager wrapper launches {eager}")
    if calls < 2 or (k1, k2, k3) != (13 * n_timed, 0, 0):
        raise RuntimeError(f"model option {name}: {calls} trainer calls and K1 {k1}, K2 "
                           f"{k2}, K3 {k3} launches in {n_timed} timed ticks, expected two "
                           f"or more calls and {13 * n_timed}, 0, 0")
    _horizon_launches(launches, n_timed, f"model option {name}, tick graphs")
    losses = infos["loss"]
    if not (torch.isfinite(losses).all() and torch.isfinite(infos["ergodic_cost"]).all()):
        raise RuntimeError(f"model option {name}: non-finite losses or costs")
    run, state = _stacked(warm + [infos]), _snapshot(es)
    capture_s = {_pattern_name(p): t for p, t in exp.tick_graph.capture_seconds.items()}
    _sync_free(f"model option {name}, a replayed tick with a trainer call",
               _tick_builders().trained_tick(exp, es))

    exp_e, es_e = make(False)
    warm_e = [exp_e.tick(es_e)[1] for _ in range(len(warm))]
    _, infos_e = exp_e.run_chunk(es_e, n_timed)
    _held_equal(f"model option {name}, tick graphs against eager ticks",
                _stacked(warm_e + [infos_e]), run)
    _held_equal(f"model option {name}, tick graphs against eager ticks", _snapshot(es_e), state)
    held = (len(warm) + n_timed, len(state))
    del exp_e, es_e, run, state

    graph = exp.post_train_graph
    call = lambda: exp.post_train_chunk(es, 1)
    call()
    call()
    if (graph.warmups, graph.captures) != (1, 1):
        raise RuntimeError(f"model option {name}: post-training graph {graph.warmups} eager "
                           f"calls, {graph.captures} captures")
    host = float(np.median([_timed(call) for _ in range(rounds)]))
    # two profiled replays, the reading with more device intervals kept: a
    # profile on the H100 once came back with 124 of about 13,000 intervals
    profiles = [_profiled_call(call) for _ in range(2)]
    wall, busy, _, _, n = max(profiles, key=lambda p: p[4])
    r = dict(ms=ms, k1=k1, k3=k3, calls=calls, capture_s=capture_s, held=held,
             host_ms=host, busy_ms=busy, intervals=n, profiled_host_ms=wall,
             profile_intervals=[p[4] for p in profiles],
             trainer_capture_s=graph.capture_seconds[()][-1],
             loss=float(losses[losses != 0][-1]))
    del exp, es, graph
    gc.collect()
    torch.cuda.empty_cache()
    return r


def phase_model_options(n_timed=6):
    """The CVAE's options (``MODEL_OPTIONS``: the subpixel and resize_conv
    decoders, the s2d and im2col encoder schedules, lane_pad 8) beside the
    default: their layers at the production shapes (``_option_layers``);
    one toy trainer call per option, card against CPU; per option the
    production Experiment through its tick graphs (``_option_production``:
    bit-equal to eager ticks, the sync check, ms per tick, capture seconds,
    K1 and K3, the captured post-training call's host and busy ms), all in
    this call. Returns the readings by option."""
    _option_layers("cuda")
    toy = {name: _option_toy_agreement(name, opts)
           for name, opts in MODEL_OPTIONS.items() if opts}
    print("[model options] toy trainer call card against CPU (f32, fed draws), max|loss "
          "diff| / max|param diff|: " + "; ".join(f"{k} {a:.3e} / {b:.3e}"
                                                  for k, (a, b) in toy.items()))
    out = {}
    for name, opts in MODEL_OPTIONS.items():
        t0 = time.perf_counter()
        r = out[name] = _option_production(name, opts, n_timed)
        print(f"[model options] {name}: {n_timed} timed ticks through the tick graphs "
              f"{r['ms']:.2f} ms/tick, {r['calls']} trainer calls replayed, K1 {r['k1']} "
              f"(13/tick), K3 {r['k3']}; tick-graph captures (s) "
              + ", ".join(f"{k} {', '.join(f'{t:.2f}' for t in v)}"
                          for k, v in r["capture_s"].items())
              + f"; {r['held'][0]} ticks bit-equal to eager (every info, {r['held'][1]} "
              f"state leaves); no sync in a replayed tick with a trainer call; captured "
              f"post-training call host {r['host_ms']:.2f} ms (median of 4), busy "
              f"{r['busy_ms']:.2f} ms in {r['intervals']} intervals (of "
              f"{r['profile_intervals']} in two profiled replays; profiled host "
              f"{r['profiled_host_ms']:.2f} ms), capture {r['trainer_capture_s']:.3f} s; "
              f"last loss {r['loss']:.4f}; {time.perf_counter() - t0:.1f} s")
    print("[model options] captured post-training call host ms / busy ms, ms/tick through "
          "the tick graphs: " + "; ".join(f"{k} {r['host_ms']:.2f} / {r['busy_ms']:.2f}, "
                                      f"{r['ms']:.2f}" for k, r in out.items()))
    return out


def _tree(tree, path=""):
    """[(path, value)] of every tensor or array (copied) and plain value in
    ``tree``, a generator as its state, a module by its name: a step's
    state or outs as they are now (a replayed step overwrites its carry in
    place)."""
    import torch
    from ealv_tpu_torch.runtime import graphs as tg
    if isinstance(tree, torch.Generator):
        return [(path, tree.get_state())]
    if isinstance(tree, torch.Tensor):
        return [(path, tree.detach().clone())]
    if isinstance(tree, np.ndarray):
        return [(path, torch.from_numpy(tree.copy()))]
    if isinstance(tree, torch.nn.Module):
        return [(path, type(tree).__name__)]
    if tg._leaf(tree):
        return [(path, tree)]
    return [leaf for k, v in tg._fields(tree)[1] for leaf in _tree(v, f"{path}.{k}")]


def _tree_equal(what, want, got):
    """Raise where two runs' leaves (``_tree``) differ, NaN equal to NaN;
    returns the number of leaves."""
    import torch
    if [p for p, _ in want] != [p for p, _ in got]:
        raise RuntimeError(f"{what}: the two runs' structures differ")
    for (path, a), (_, b) in zip(want, got):
        if isinstance(a, torch.Tensor):
            same = a.dtype == b.dtype and a.shape == b.shape and torch.equal(
                a.nan_to_num(), b.nan_to_num()) and torch.equal(a.isnan(), b.isnan())
        else:
            same = a == b
        if not same:
            raise RuntimeError(f"{what}: {path} differs")
    return len(want)


def _eval_pattern_name(pattern) -> str:
    """An eval runtime's step pattern in words (``EvalExperiment.step``:
    the step's kind and keys, the arm's drift correction last)."""
    kind, *keys, drift = pattern
    extra = {"tick": lambda: "", "capture": lambda: " first" if keys[0] else "",
             "identify": lambda: (f" {keys[3]}, {'adopted' if keys[4] else 'neutral'}, "
                                  f"{'update' if keys[5] else 'skip'}")}[kind]()
    return kind + extra + (", drift" if any(drift) else "")


def _steps_two_ways(name, make, step, n_warm, rounds=2, chunk=6, k1_per_step=12,
                    profile=True):
    """A step path of the eval runtime two ways in one call. ``make(graphs)``
    builds (ev_exp, state) with the runtime's tick graph or, eager, with
    ``tick_graph`` set to None; ``step(ev_exp, state)`` takes one step and
    returns (state, out). Both take ``n_warm`` steps, then ``rounds`` x 4
    chunks of ``chunk`` steps in turns (graphed, eager, eager, graphed),
    each timed: every graphed chunk replays its graphs on every step with
    no eager K1 launch, ``k1_per_step`` K1 launches a step read through the
    graphs, and in every chunk one plan a step (17 rollouts, 5 costate
    sweeps); then 3 steps of each under torch.profiler. Every out and the
    final state are held bit for bit. Returns the readings."""
    import torch
    from ealv_tpu_torch.runtime.graphs import kernel_counts, reset_launches, total_launches

    runs = {}
    for mode in ("graphs", "eager"):
        ev_exp, state = make(mode == "graphs")
        outs = []
        for _ in range(n_warm):
            state, out = step(ev_exp, state)
            outs.append(out)
        runs[mode] = [ev_exp, state, outs]
    g = runs["graphs"][0].tick_graph
    turns = {"graphs": [], "eager": []}
    per_step = {}
    for mode in ("graphs", "eager", "eager", "graphs") * rounds:
        run = runs[mode]
        reset_launches()
        replays = g.replays
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(chunk):
            run[1], out = step(run[0], run[1])
            run[2].append(out)  # a fresh tensor or a clone: no later step writes it
        torch.cuda.synchronize()
        turns[mode].append((time.perf_counter() - t0) / chunk * 1e3)
        eager_k1 = kernel_counts()["footprint_and_spread"]
        k1 = total_launches()["footprint_and_spread"]
        if mode == "graphs" and (g.replays - replays != chunk or eager_k1 or
                                 k1 != k1_per_step * chunk):
            raise RuntimeError(f"{name}: {g.replays - replays} replays in a chunk of {chunk}, "
                               f"K1 {k1} through the graphs ({eager_k1} eager)")
        if mode == "eager" and eager_k1 != k1_per_step * chunk:
            raise RuntimeError(f"{name}, eager: K1 {eager_k1} in {chunk} steps")
        _horizon_launches(total_launches(), chunk, f"{name}, {mode}")
        per_step[mode] = k1 / chunk
    profiles = {}
    for mode, run in runs.items() if profile else ():
        def three(run=run):
            for _ in range(3):
                run[1], out = step(run[0], run[1])
                run[2].append(out)
        wall, busy, _, _, n = _profiled_call(three)
        profiles[mode] = dict(host_ms=wall, busy_ms=busy, intervals=n)
    n_out = _tree_equal(f"{name}: graphed outs against eager outs", _tree(runs["eager"][2]),
                        _tree(runs["graphs"][2]))
    n_state = _tree_equal(f"{name}: graphed state against eager state",
                          _tree(runs["eager"][1]), _tree(runs["graphs"][1]))
    return dict(
        name=name, runs=runs, steps=len(runs["graphs"][2]), leaves=(n_out, n_state),
        turns=turns, ms={m: float(np.median(v)) if v else None for m, v in turns.items()},
        profile=profiles, pool_mib=_pool_mib(g), k1_per_step=per_step,
        counts={_eval_pattern_name(p): c for p, c in g.counts.items()},
        capture_s={_eval_pattern_name(p): [round(t, 3) for t in v]
                   for p, v in g.capture_seconds.items()})


def _two_ways_line(r) -> str:
    """A ``_steps_two_ways`` path's readings in one line."""
    p = r["profile"]
    ms = (f"ms/step in turns (medians of {len(r['turns']['graphs'])} chunks), graphed "
          f"{r['ms']['graphs']:.2f} {[round(v, 2) for v in r['turns']['graphs']]}, eager "
          f"{r['ms']['eager']:.2f} {[round(v, 2) for v in r['turns']['eager']]} | "
          if r["turns"]["graphs"] else "")
    prof = ("3 profiled steps, host ms / busy ms / intervals: " + "; ".join(
        f"{m} {p[m]['host_ms']:.2f} / {p[m]['busy_ms']:.2f} / {p[m]['intervals']}"
        for m in p) + " | ") if p else ""
    return (f"[graphs] {r['name']}: {ms}{prof}[eager, captured, replays] by pattern "
            f"{r['counts']} | capture s "
            f"{r['capture_s']} | pool {r['pool_mib']} MiB | {r['steps']} steps bit-equal to "
            f"eager steps: {r['leaves'][0]} out leaves, {r['leaves'][1]} state leaves")


def _frozen_cvae_target(cfg, poses, images):
    """(pdf_fn, ctx) of a frozen production CVAE over ``cfg``'s states
    (bf16, weights from seed 0) seeded with the test set's first sample."""
    import torch
    from ealv_tpu_torch.models import CVAE, init_model_state, update_dist
    from ealv_tpu_torch.utils.states import ws_conversion
    t = lambda a: torch.as_tensor(a, device="cuda")
    poses_r = ws_conversion(t(poses[:, cfg.sel()]), t(cfg.tray_lim), t(cfg.robot_lim))
    model = CVAE(img_dim=cfg.image_dim, s_dim=cfg.s_dim, hidden_dim=cfg.model_hidden(),
                 compute_dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to("cuda")
    ms, _ = update_dist(model, init_model_state(model, "cuda"), poses_r[0], t(images[0]))
    return (lambda c, s: c[0].pdf(c[1], s)), (model, ms), poses_r


def _eval_ticks(cfg, fn, ctx, name, n_warm=2, rounds=2, profile=True):
    """EvalExperiment ticks toward ``ctx`` two ways (``_steps_two_ways``)."""
    from ealv_tpu_torch.runtime import EvalExperiment

    def make(graphs):
        ev_exp = EvalExperiment(cfg, fn, device="cuda")
        if not graphs:
            ev_exp.tick_graph = None
        return ev_exp, ev_exp.init(seed=0)

    return _steps_two_ways(name, make, lambda ev_exp, ev: ev_exp.tick(ev, ctx), n_warm,
                           rounds=rounds, profile=profile)


def phase_eval_path(n_points=25):
    """The evaluation runtime at production size: a 25-point grid test set
    collected at 180x180 with the port's collector on the card; then
    EvalExperiment ticks toward a frozen production CVAE's pdf (weights
    from seed 0, seeded with the set's first sample) through the tick
    graph and eagerly in one call (``_steps_two_ways``: 2 warm ticks, 4
    chunks of 6 in turns, 3 profiled; 12 K1 launches a plan read through
    the graphs; every observation and the state bit-equal), at xyw, at
    xyzrpw (2 chunks, none profiled) and on the arm (60 warm ticks, so that
    the drift correction of every 20th command replays its graph; 2
    chunks, none profiled); a replayed tick
    under the sync check; evaluate_test_set over the set; and baseline
    ticks, whose plan_step makes no K1 launch (a trainer call makes one,
    for its entropy grade). Returns (ms per graphed eval tick, launches per
    plan)."""
    import torch
    from ealv_tpu_torch.runtime import Experiment, evaluate_test_set
    from ealv_tpu_torch.runtime.graphs import kernel_launches, reset_launches
    from ealv_tpu_torch.scripts.collect_test_set import collect
    from ealv_tpu_torch.utils.config import ExperimentConfig

    cfg = ExperimentConfig(**PRODUCTION)
    t0 = time.perf_counter()
    poses, images, forces = collect("grid", n_points, img=cfg.image_dim[0], device="cuda")
    collect_s = time.perf_counter() - t0
    if images.shape != (n_points, *cfg.image_dim) or not np.isfinite(images).all():
        raise RuntimeError(f"test set images {images.shape}")
    fn, ctx, poses_r = _frozen_cvae_target(cfg, poses, images)
    model = ctx[0]
    r = _eval_ticks(cfg, fn, ctx, "eval tick (xyw, frozen CVAE)")
    ev_exp, ev = r["runs"]["graphs"][:2]
    _sync_free("EvalExperiment tick", [("EvalExperiment.tick (replayed)",
                                        lambda: ev_exp.tick(ev, ctx))])
    obs = r["runs"]["graphs"][2]
    costs = torch.stack([o["cost"] for o in obs]).cpu()
    if not torch.isfinite(costs).all() or obs[-1]["image"].shape != cfg.image_dim:
        raise RuntimeError(f"eval costs {costs}, image {tuple(obs[-1]['image'].shape)}")
    print(_two_ways_line(r))
    for states, kw, n_warm, rounds in (("xyzrpw", {}, 2, 1), ("xyw", {"sim_backend": "arm"},
                                                             60, 1)):
        c = ExperimentConfig(**{**PRODUCTION, "states": states, **kw})
        f, x, _ = _frozen_cvae_target(c, poses, images)
        name = f"eval tick ({states}{', arm' if kw else ''}, frozen CVAE)"
        rr = _eval_ticks(c, f, x, name, n_warm=n_warm, rounds=rounds, profile=False)
        if kw and rr["counts"].get("tick, drift", [0, 0, 0])[2] < 2:
            raise RuntimeError(f"{name}: no replay of the drift-correcting tick: "
                               f"{rr['counts']}")
        print(_two_ways_line(rr))
        del rr
    t0 = time.perf_counter()
    met = evaluate_test_set(model, poses_r, images, forces)
    eval_s = time.perf_counter() - t0
    if not (np.isfinite(met["recon_nll"]).all() and met["img_pred"].shape == images.shape):
        raise RuntimeError(f"evaluate_test_set: {met['recon_nll']}")
    dt, per_plan = r["ms"]["graphs"], r["k1_per_step"]["graphs"]
    print(f"[eval path] {n_points}-point grid test set at {cfg.image_dim[0]}x"
          f"{cfg.image_dim[1]} collected in {collect_s:.2f} s | EvalExperiment ticks toward a "
          f"frozen production CVAE (bf16, seed 0): {dt:.2f} ms/tick through the tick graph, "
          f"{r['ms']['eager']:.2f} eager | K1 {per_plan:.0f} per plan through the graphs | last "
          f"cost "
          f"{float(costs[-1]):.4f} | evaluate_test_set over the set in {eval_s:.3f} s: mean "
          f"MSE {met['mean_mse']:.5f}, mean NLL {met['mean_nll']:.5f}, active units "
          f"{met['active_units']}")
    del r, ev_exp, ev, obs

    for method in ("randomWalk", "uniform"):
        exp = Experiment(ExperimentConfig(**{**PRODUCTION, "states": "xywb"},
                                          explr_method=method),
                         train_calls_per_tick=1, train_every=3, device="cuda")
        es = exp.init(seed=0)
        reset_launches(*exp.graphs())
        for _ in range(3):
            exp.plan_step(es, exp._measured_robot_state(es.env))
        planned = kernel_launches(*exp.graphs())["footprint_and_spread"]
        calls0 = es.learning_ind
        t0 = time.perf_counter()
        es, infos = exp.run_chunk(es, 6)
        torch.cuda.synchronize()
        b_ms = (time.perf_counter() - t0) / 6 * 1e3
        calls = es.learning_ind - calls0
        ticked = kernel_launches(*exp.graphs())["footprint_and_spread"] - planned
        if planned != 0 or ticked != calls or calls <= 0:
            raise RuntimeError(f"{method}: {planned} K1 launches in 3 plan_steps (expected "
                               f"0), {ticked} in 6 ticks with {calls} trainer calls")
        _horizon_launches(kernel_launches(*exp.graphs()), 0, f"baseline {method}")
        if not torch.isfinite(infos["loss"]).all():
            raise RuntimeError(f"{method}: losses {infos['loss']}")
        print(f"[eval path] baseline {method} at xywb, production size: 0 K1 launches in 3 "
              f"plan_steps and no horizon kernel launch in them or the ticks; {ticked} in 6 ticks = one per trainer call ({calls}, the entropy "
              f"grade); {b_ms:.2f} ms/tick (the first ticks, cold)")
    return dt, per_plan


# the fingerprint stage's toy widths (the JAX fingerprint tests' config)
FP_TOY = dict(states="xyw", image_dim=(24, 24, 3), cnn_kernels=(3, 3), cnn_strides=(2, 2),
              cnn_channels=(8, 8), hidden_dim=(64, 32), z_dim=8, num_target_samples=128,
              num_traj_samples=64, traj_buffer_capacity=256, buffer_capacity=256,
              compute_dtype="float32")
FP_COMBOS = (("L2", False), ("KL", False), ("BC", False), ("L2", True))


def _fp_model(cfg, dev, seed=0):
    import torch
    from ealv_tpu_torch.models import CVAE
    model = CVAE(img_dim=cfg.image_dim, z_dim=cfg.z_dim, s_dim=cfg.s_dim,
                 hidden_dim=cfg.model_hidden(), cnn_kernels=cfg.cnn_kernels,
                 cnn_strides=cfg.cnn_strides, cnn_channels=cfg.cnn_channels,
                 compute_dtype=getattr(torch, cfg.compute_dtype))
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(dev)


def _fp_toy_run(dev):
    """The fingerprint stage at toy size on ``dev`` with fed draws: every
    output as a flat dict of CPU tensors (labels and seek choices as
    floats)."""
    import torch
    from ealv_tpu_torch.data.replay import ReplayBuffer
    from ealv_tpu_torch.fingerprint import (ClusterDraws, FingerprintBelief, FingerprintSet,
                                            calibrate_thresholds, entropy_slices,
                                            find_clusters)
    from ealv_tpu_torch.fingerprint.capture import capture_fingerprint
    from ealv_tpu_torch.fingerprint.test_runtime import FingerprintMatrixRuntime
    from ealv_tpu_torch.utils.config import ExperimentConfig

    cfg = ExperimentConfig(**FP_TOY)
    model = _fp_model(cfg, dev)
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    # the sample optimization's 5 Adam steps send renormalize's max term to
    # the argmax sample and pass the decoder's ReLU kinks, so a near tie or
    # a pre-activation near 0 lets f32 noise move a sample by up to 1e-3:
    # these 60 samples keep the argmax 1.5e-3 ahead and every pre-activation
    # 1.4e-5 from 0 at every step (checked on the CPU)
    rng = np.random.default_rng(104)
    sx = t(rng.uniform(-1, 1, (3, 3)))
    sy = t(rng.uniform(0, 1, (3, *cfg.image_dim)))
    draws = ClusterDraws(samples=t(rng.uniform(-1, 1, (60, 3))),
                         resample_idx=t(rng.integers(0, 60, 30), torch.int64))
    rng = np.random.default_rng(11)
    out = {}
    for method in ("shift", "kmeans"):
        for opt in (False, True):
            res = find_clusters(model, sx, sy, cfg.robot_lim, num_pts=60, cluster_method=method,
                                bandwidth=0.3, use_optimize_samples=opt, draws=draws)
            tag = f"clusters {method}{' optimized' if opt else ''}"
            out[f"{tag} points"] = torch.as_tensor(res.points)
            out[f"{tag} means"] = torch.as_tensor(res.means, dtype=torch.float32)
            out[f"{tag} labels"] = torch.as_tensor(res.labels).float()
    dicts = []
    for i, center in enumerate(([0.2, -0.3, 0.0], [-0.4, 0.3, 0.5])):
        lims = np.asarray(center, np.float32)[:, None] + np.array([-0.4, 0.4], np.float32)
        tick_draws = [_toy_draws(cfg, k, rng, dev, lims=lims) for k in range(3)]
        fp = capture_fingerprint(model, cfg, np.asarray(center, np.float32), num_steps=3,
                                 min_pose_dist=0.0, seed=i, draws=tick_draws, device=dev)
        dicts.append(fp)
        out.update({f"capture {i} {k}": torch.as_tensor(v) for k, v in fp.items()})
    fps = FingerprintSet.from_lists(dicts, device=dev)
    beliefs = {}
    for m, e in FP_COMBOS:
        th, cl = calibrate_thresholds(fps, m)
        if not e:
            out[f"calibrated {m}"] = torch.tensor([th, cl])
        beliefs[f"{m}_error" if e else m] = [FingerprintBelief.create(
            cfg.states, cfg.robot_lim, num_samples=20, meas_capacity=8, thresh=th, clip=cl,
            device=dev) for _ in range(2)]
    for mode in ("fixed", "uncertain"):
        rt = FingerprintMatrixRuntime(cfg, model, fps, seek_mode=mode, update_tdist_step=1,
                                      beliefs={k: list(v) for k, v in beliefs.items()},
                                      device=dev)
        tick_draws = [_toy_draws(cfg, k, rng, dev) for k in range(3)]
        _, hist = rt.run(3, seed=2, draws=tick_draws)
        for h in hist:
            for key, v in h.items():
                if key != "step":
                    out[f"runtime {mode} step {h['step']} {key}"] = torch.as_tensor(
                        np.asarray(v, np.float32))
        for key, bs in rt.beliefs.items():
            out[f"runtime {mode} {key} priors"] = torch.stack([b.prior.cpu() for b in bs])
    buf = ReplayBuffer.create(16, cfg.s_dim, cfg.image_dim, dev)
    for _ in range(8):
        buf.push(t(rng.uniform(-1, 1, 3)), t(rng.uniform(0, 1, cfg.image_dim)))
    for ens in (False, True):
        sl = entropy_slices(model, buf, cfg.robot_lim, cfg.states, num_samples=60, num_seeds=4,
                            grid_pts=4, use_z_ensemble=ens,
                            unit_plane=t(rng.uniform(0, 1, (60, 2))),
                            seed_idx=t(rng.permutation(8)[:4], torch.int64))
        out[f"entropy slice ensemble={ens}"] = torch.as_tensor(sl["all"][1])
    return out


def phase_fingerprint_agreement():
    """The fingerprint stage at toy size (f32, TF32 off) on the card and on
    the CPU from the same weights and fed draws: find_clusters (shift and
    kmeans, sample optimization on and off), two 3-tick captures,
    calibrate_thresholds, 3 ticks of the matrix runtime over the four
    default combinations in both seek modes with adoption at step 1, and
    entropy slices with and without the z-ensemble. Every output within
    1e-4 (cluster labels and the adopted objects equal)."""
    import torch
    runs = {dev: _fp_toy_run(dev) for dev in ("cpu", "cuda")}
    err, n, bad = 0.0, 0, []
    for key, a in runs["cpu"].items():
        b = runs["cuda"][key]
        if a.shape != b.shape:
            bad.append(f"{key}: shape {tuple(b.shape)} on the card, {tuple(a.shape)} on the CPU")
        elif "labels" in key or "seek_k" in key:
            if not torch.equal(a, b):
                bad.append(f"{key}: {b.tolist()} vs {a.tolist()}")
        elif not (torch.isfinite(a[~torch.isnan(a)]).all()
                  and torch.equal(torch.isnan(a), torch.isnan(b))):
            bad.append(f"{key}: non-finite values or NaNs in other places")
        else:
            e = float((a - b).abs().nan_to_num(nan=0.0).max()) if a.numel() else 0.0
            if e >= 1e-4:
                bad.append(f"{key}: max|cuda-cpu| {e:.3e}")
            err, n = max(err, e), n + 1
    if bad:
        raise RuntimeError("fingerprint agreement failed: " + "; ".join(bad))
    print(f"[agreement] fingerprint stage at toy size, cuda vs cpu with fed draws: "
          f"find_clusters over 60 samples (shift, kmeans; optimized and not), two 3-tick "
          f"captures, "
          f"calibrate_thresholds, 3 matrix-runtime ticks x 4 combinations x 2 seek modes, "
          f"entropy slices: {n} outputs within 1e-4, max|diff| {err:.3e}; labels and adopted "
          f"objects equal")
    return err


# the identification cell's fusion: K = 4 objects, 50^3 cells, a ring of
# 64, three combinations of two pushes (the yaw reflection) and one of one
# (error mode), each with its own thresholds
FUSION_CELL = dict(objects=4, grid=50, ring=64, pushes=(2, 2, 2, 1))


def _fusion_beliefs(dev, objects, grid, ring, pushes, seed=0):
    """The cell's beliefs, a random prior and variance each, and their
    pushes as ``match_pushes`` makes them (rows i, K + i of one relative-pose
    tensor a combination, its distance expanded)."""
    import torch
    from ealv_tpu_torch.fingerprint import FingerprintBelief
    from ealv_tpu_torch.utils.config import ExperimentConfig
    cfg = ExperimentConfig(**PRODUCTION)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    beliefs, push = [], []
    for ci, reps in enumerate(pushes):
        rows = t(rng.uniform(-1, 1, (reps * objects, cfg.s_dim)))
        dist = t(rng.uniform(0.0, 2.5, objects))
        for i in range(objects):
            b = FingerprintBelief.create(cfg.states, cfg.robot_lim, num_samples=grid,
                                         meas_capacity=ring, thresh=0.5 + 0.1 * ci,
                                         clip=2.0 + 0.2 * ci, device=dev)
            g = b.grid.shape[0]
            beliefs.append(dataclasses.replace(b, prior=t(rng.uniform(0.2, 0.9, g)),
                                               prior_var=t(rng.uniform(0.05, 2.0, g))))
            push.append((rows[i::objects], dist[i].expand(reps)))
    return beliefs, push


def phase_fusion(dev, cell=FUSION_CELL):
    """The belief fusion kernel (``csrc/belief.cu``) at the identification
    cell's sizes: one ``push_and_fuse`` of its C x K beliefs against the
    plain push and ``update_prior`` of each on the card (prior and variance
    within 1e-5 of the largest value, ring and counters exact, the old
    beliefs unchanged); the kernel's launches a call; device ms (CUDA
    events) of the kernel's call and of the plain version's beside the
    bound, C x K x G x 16 B at 3.35 TB/s. Returns the record."""
    import torch
    from ealv_tpu_torch.fingerprint.belief import push_and_fuse
    from ealv_tpu_torch.ops.belief import fuse_beliefs
    from ealv_tpu_torch.utils.timing import device_ms

    beliefs, pushes = _fusion_beliefs(dev, **cell)
    kept = [b.prior.clone() for b in beliefs]
    before = fuse_beliefs.launches
    got = push_and_fuse(beliefs, pushes)
    launches = fuse_beliefs.launches - before

    def plain():
        return [(b.push_batch(*p) if p is not None else b)._update_prior_plain()
                for b, p in zip(beliefs, pushes)]

    want = plain()
    torch.cuda.synchronize()
    worst = 0.0
    for b, g, w, k in zip(beliefs, got, want, kept):
        for name in ("prior", "prior_var"):
            a, r = getattr(g, name), getattr(w, name)
            worst = max(worst, float((a - r).abs().max() / r.abs().max()))
        for name in ("meas_loc", "meas_val", "meas_n", "count"):
            if not torch.equal(getattr(g, name), getattr(w, name)):
                raise RuntimeError(f"fusion kernel: {name} differs from the plain version's")
        if not torch.equal(b.prior, k):
            raise RuntimeError("fusion kernel wrote into the old belief")
    if worst > 1e-5:
        raise RuntimeError(f"fusion kernel: prior or variance {worst:.3e} off the plain version")
    cells = beliefs[0].grid.shape[0]
    bound_ms = len(beliefs) * cells * 16 / 3.35e12 * 1e3
    kernel_ms = device_ms(lambda: push_and_fuse(beliefs, pushes), reps=11, inner=20)
    plain_ms = device_ms(plain, reps=5, inner=3)
    out = dict(beliefs=len(beliefs), cells=cells, launches_per_call=launches,
               device_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
               roofline_pct=bound_ms / kernel_ms * 100, worst_rel=worst)
    print(f"[fusion] {len(beliefs)} beliefs of {cells} cells, ring {cell['ring']}: kernel "
          f"{kernel_ms:.4f} ms device a call ({launches} launch of the C entry, 3 kernels), "
          f"plain push and update_prior {plain_ms:.4f} ms, bound {bound_ms:.5f} ms by bytes "
          f"({out['roofline_pct']:.1f}% of it); prior and variance within {worst:.2e} of the "
          f"plain version's, ring and counters exact")
    return out


def phase_fingerprint_path(n_capture=50, n_id=30, adopt=10):
    """The fingerprint stage at production size (bf16, weights from seed 0,
    ``TrayScene.make(3, seed=0)``): find_clusters over 1000 samples seeded
    by six images of the port's grid collector; a 50-tick sphere capture at
    each true centre (12 K1 launches a tick, read through the capture's
    step graph); the first centre's capture steps again two ways
    (``_steps_two_ways``: through its step graph and eagerly, in turns,
    every step bit-equal; the eager steps' fingerprint bit-equal to the
    public capture's); FingerprintSet and thresholds for L2, KL and BC;
    device times of one identify_step and of one update_beliefs per
    combination; the matrix runtime over the four combinations for 30
    ticks with adoption at step 10, fixed and then uncertain (12 K1
    launches a tick), through its step graph and eagerly, the histories
    and beliefs bit-equal; then identification ticks two ways in turns;
    replayed capture and identification steps under the sync check;
    entropy slices; none of the clustering, matching or slices launches
    K1. Returns the launch counts and times."""
    import torch
    from ealv_tpu_torch.data.replay import ReplayBuffer
    from ealv_tpu_torch.fingerprint import (FingerprintBelief, FingerprintSet,
                                            calibrate_thresholds, entropy_slices,
                                            find_clusters, identify_step, update_beliefs)
    from ealv_tpu_torch.fingerprint.identify import best_matches, fuse_matches, match_forward
    from ealv_tpu_torch.fingerprint.capture import capture_fingerprint, capture_start, \
        capture_step, finish_capture
    from ealv_tpu_torch.fingerprint.test_runtime import FingerprintMatrixRuntime, \
        _identification_tick
    from ealv_tpu_torch.runtime.graphs import reset_launches, total_launches
    from ealv_tpu_torch.scripts.collect_test_set import collect
    from ealv_tpu_torch.sim import TrayScene
    from ealv_tpu_torch.utils.config import ExperimentConfig
    from ealv_tpu_torch.utils.timing import device_ms

    cfg = ExperimentConfig(**PRODUCTION)
    dev = "cuda"
    torch.cuda.reset_peak_memory_stats()
    model = _fp_model(cfg, dev)
    scene = TrayScene.make(3, seed=0, device=dev)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    tl, rl = cfg.tray_lim, cfg.robot_lim
    poses, images, _ = collect("grid", 6, img=cfg.image_dim[0], device=dev)
    seeds_x = t((poses[:, cfg.sel()] - tl[:, 0]) / (tl[:, 1] - tl[:, 0])
                * (rl[:, 1] - rl[:, 0]) + rl[:, 0])
    seeds_y = t(images)
    gen = torch.Generator(device=dev).manual_seed(0)
    launches, counts = {}, {}

    def timed(name, fn):
        """fn() and its seconds; its kernel launches, eager and replayed by
        any graph (a capture's step graph lives only inside the call)."""
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        counts[name] = total_launches()
        launches[name] = counts[name]["footprint_and_spread"]
        return result, time.perf_counter() - t0

    res, cluster_s = timed("find_clusters", lambda: find_clusters(
        model, seeds_x, seeds_y, rl, num_pts=1000, generator=gen))
    truth = []
    for xy in scene.obj_xy.cpu().numpy():
        full = np.zeros(cfg.s_dim, np.float32)
        full[:2] = xy
        truth.append((full - tl[:, 0]) / (tl[:, 1] - tl[:, 0]) * (rl[:, 1] - rl[:, 0])
                     + rl[:, 0])
    dicts, capture_s = timed("capture", lambda: [capture_fingerprint(
        model, cfg, c.astype(np.float32), scene=scene, num_steps=n_capture, seed=i, device=dev)
        for i, c in enumerate(truth)])
    fps = FingerprintSet.from_lists(dicts, device=dev)
    thresholds = {m: calibrate_thresholds(fps, m) for m in ("L2", "KL", "BC")}

    # the first centre's capture again, two ways: its 50 steps in turns
    def make_capture(graphs):
        ev_exp, target, ev, ms = capture_start(model, cfg, truth[0].astype(np.float32),
                                               scene=scene, seed=0, device=dev)
        if not graphs:
            ev_exp.tick_graph = None
        return ev_exp, (ev, ms, target, 0)

    def capture_one(ev_exp, state):
        ev, ms, target, i = state
        ev, ms, out = capture_step(ev_exp, model, target, ev, ms, first=i == 0)
        return (ev, ms, target, i + 1), out

    cap = _steps_two_ways("capture step", make_capture, capture_one, n_capture - 24)
    eager_outs = cap["runs"]["eager"][2][:n_capture]
    fp0 = finish_capture([o[:3] for o in eager_outs], eager_outs[0][3], truth[0])
    _tree_equal("the public capture against the eager capture steps", _tree(fp0),
                _tree(dicts[0]))
    print(_two_ways_line(cap) + f"; its first {n_capture} steps' fingerprint bit-equal to the "
          f"public capture's")
    cap_ms = dict(cap["ms"])
    del cap, eager_outs

    obs_x, obs_y = t(dicts[0]["x"][-1]), t(dicts[0]["center_img"])
    identify_ms = device_ms(lambda: identify_step(model, fps, obs_x, obs_y), reps=5, inner=5)
    rl_t, tl_t = t(rl), t(tl)
    update_ms = {}
    for m, e in FP_COMBOS:
        th, cl = thresholds["L2" if e else m]
        bs = [FingerprintBelief.create(cfg.states, rl, thresh=th, clip=cl, device=dev)
              for _ in range(len(truth))]
        update_ms[f"{m}_error" if e else m] = device_ms(lambda: update_beliefs(
            model, fps, bs, obs_x, obs_y, cfg.states, rl_t, tl_t, m, e), reps=5, inner=5)
    # an identification tick's parts beside the planner's: the one match
    # forward its combinations share, and each combination's fusion
    match_ms = device_ms(lambda: match_forward(model, fps, obs_y), reps=5, inner=5)
    out_m, seed_y = match_forward(model, fps, obs_y)
    fuse_ms = {}
    for m, e in FP_COMBOS:
        th, cl = thresholds["L2" if e else m]
        bs = [FingerprintBelief.create(cfg.states, rl, thresh=th, clip=cl, device=dev)
              for _ in range(len(truth))]
        d, best = best_matches(out_m, seed_y, fps, m, e)
        fuse_ms[f"{m}_error" if e else m] = device_ms(lambda: fuse_matches(
            bs, d, best, obs_x, fps, cfg.states, rl_t, tl_t, e), reps=5, inner=5)

    runs, id_two = {}, {}
    for mode in ("fixed", "uncertain"):
        rts = {}
        for graphs in (True, False):
            rt = FingerprintMatrixRuntime(cfg, model, fps, combos=FP_COMBOS, seek_mode=mode,
                                          update_tdist_step=adopt, scene=scene, device=dev)
            if not graphs:
                rt._ev.tick_graph = None
            name = f"identify {mode}" + ("" if graphs else " eager")
            rts[graphs] = rt, *timed(name, lambda rt=rt: rt.run(n_id, seed=7))
        (rt, (beliefs, hist), runs[mode]), (rt_e, (beliefs_e, hist_e), eager_s) = \
            rts[True], rts[False]
        _tree_equal(f"identification ({mode}) through its step graph against eager",
                    _tree((hist_e, rt_e.seek_history, beliefs_e)),
                    _tree((hist, rt.seek_history, beliefs)))
        g = rt._ev.tick_graph
        dists = np.stack([np.stack([h[k] for k in beliefs]) for h in hist])
        if not (np.isfinite(dists).all() and all(torch.isfinite(b.prior).all()
                                                 for bs in beliefs.values() for b in bs)):
            raise RuntimeError(f"identification ({mode}): non-finite distances or beliefs")
        errors = {k: float(v["mean_error"]) for k, v in rt.results_table(np.stack(truth)).items()}
        share = [float((rt.seek_history[adopt:] == k).mean()) for k in range(len(truth))]
        print(f"[fingerprint path] identification ({mode}): {n_id} ticks, 4 combinations, "
              f"adoption at step {adopt}: {runs[mode] / n_id * 1e3:.2f} ms/tick through the "
              f"step graph ({eager_s / n_id * 1e3:.2f} eager; both with the set-up), history, "
              f"adopted objects and beliefs bit-equal | [eager, captured, replays] by pattern "
              f"{ {_eval_pattern_name(p): c for p, c in g.counts.items()} }, capture s "
              f"{ {_eval_pattern_name(p): [round(t, 3) for t in v] for p, v in g.capture_seconds.items()} } "
              f"| K1 {launches[f'identify {mode}']} through the graphs | mean localization "
              f"error { {k: round(v, 3) for k, v in errors.items()} } | seek share after "
              f"adoption {np.round(share, 2).tolist()}")
        del rt_e, beliefs_e, hist_e, rts

        # identification ticks two ways in turns, adopted from the start
        def make_id(graphs, mode=mode):
            rt = FingerprintMatrixRuntime(cfg, model, fps, combos=FP_COMBOS, seek_mode=mode,
                                          update_tdist_step=0, scene=scene, device=dev)
            if not graphs:
                rt._ev.tick_graph = None
            beliefs = [list(rt.beliefs[rt.combo_key(m, e)]) for m, e in FP_COMBOS]
            return rt._ev, (rt._ev.init(seed=8), beliefs)

        def identify_one(ev_exp, state, mode=mode):
            ev, beliefs = state
            ev, *out = _identification_tick(ev_exp, model, fps, cfg, FP_COMBOS, beliefs, 0, 0,
                                            0, 1, ev, rl_t, tl_t, mode)
            return (ev, beliefs), tuple(out)

        id_two[mode] = _steps_two_ways(f"identification tick ({mode})", make_id,
                                       identify_one, 2)
        print(_two_ways_line(id_two[mode]))
        id_two[mode].pop("runs")

    ticks = _tick_builders().fingerprint_ticks(cfg, model, scene, fps, truth[0], rl_t, tl_t,
                                               "cuda", warm=3)
    _sync_free("fingerprint capture and identification ticks", ticks)

    buf = ReplayBuffer.create(16, cfg.s_dim, cfg.image_dim, dev, img_dtype=torch.bfloat16)
    for x, y in zip(seeds_x, seeds_y):
        buf.push(x, y)
    slices, slices_s = timed("entropy_slices", lambda: entropy_slices(
        model, buf, rl, cfg.states, num_seeds=6, generator=gen))
    peak = torch.cuda.max_memory_allocated() / 2**20

    zs = np.concatenate([np.concatenate([d["z_mu"], d["z_var"]], 1) for d in dicts])
    if not (np.isfinite(zs).all() and np.isfinite(slices["all"][1]).all()):
        raise RuntimeError("non-finite captured latents or entropy slice")
    want = {"find_clusters": 0, "capture": 12 * n_capture * len(truth),
            "identify fixed": 12 * n_id, "identify uncertain": 12 * n_id,
            "identify fixed eager": 12 * n_id, "identify uncertain eager": 12 * n_id,
            "entropy_slices": 0}
    if launches != want:
        raise RuntimeError(f"fingerprint path K1 launches {launches}, expected {want}")
    # one fusion launch a tick for the 4 x 3 beliefs, through the graphs too
    fused = {name: counts[name]["fuse_beliefs"] for name in want}
    want_fused = {name: n_id if name.startswith("identify") else 0 for name in want}
    if fused != want_fused:
        raise RuntimeError(f"fingerprint path fusion launches {fused}, expected {want_fused}")
    fusion = phase_fusion(dev)
    # one plan a capture or identification tick; each capture and each
    # identification run sets up its planner state once
    for name, plans, inits in (("find_clusters", 0, 0), ("entropy_slices", 0, 0),
                               ("capture", n_capture * len(truth), len(truth)),
                               *((f"identify {m}{e}", n_id, 1) for m in ("fixed", "uncertain")
                                 for e in ("", " eager"))):
        _horizon_launches(counts[name], plans, f"fingerprint {name}", inits=inits)
    capture_ms = capture_s / (n_capture * len(truth)) * 1e3
    id_ms = (runs["fixed"] + runs["uncertain"]) / (2 * n_id) * 1e3
    print(f"[fingerprint path] production size, bf16, 3-object scene: find_clusters over 1000 "
          f"samples from 6 grid seeds {cluster_s:.2f} s ({len(res.means)} clusters) | "
          f"{len(truth)} captures of {n_capture} ticks: {capture_ms:.2f} ms/tick (host clock, "
          f"set-up included), poses kept {[len(d['x']) for d in dicts]} | thresholds "
          f"{ {m: tuple(round(v, 4) for v in th) for m, th in thresholds.items()} } | "
          f"identification {id_ms:.2f} ms/tick | entropy slices {slices_s:.2f} s | peak "
          f"memory {peak:.1f} MiB")
    print(f"[fingerprint path] device ms (CUDA events, median of 5 x 5): identify_step (K=3, "
          f"S={fps.x.shape[1]}, {cfg.image_dim[0]}x{cfg.image_dim[1]} images) "
          f"{identify_ms:.4f}; update_beliefs "
          f"{ {k: round(v, 4) for k, v in update_ms.items()} }; match_forward "
          f"{match_ms:.4f}; fuse_matches { {k: round(v, 4) for k, v in fuse_ms.items()} } "
          f"(four: {sum(fuse_ms.values()):.4f}) | K1 launches {launches} | fuse_beliefs "
          f"launches {fused} | horizon_rollout, "
          f"costate_sweep launches "
          f"{ {k: (c['horizon_rollout'], c['costate_sweep']) for k, c in counts.items()} }")
    return dict(capture_per_tick=launches["capture"] / (n_capture * len(truth)),
                identify_per_tick=launches["identify fixed"] / n_id,
                find_clusters=launches["find_clusters"],
                entropy_slices=launches["entropy_slices"], capture_ms=capture_ms,
                identify_ms=id_ms, peak=peak, capture_step_ms=cap_ms,
                identify_step_ms={m: r["ms"] for m, r in id_two.items()},
                fusion=dict(fusion, launches_identify_per_tick=fused["identify fixed"] / n_id))


# the arm phases: the wedge scene of tests/test_arm.py (one wide cylinder
# reaching well into the z band; the tray's centre lies 0.055 deep in its
# side, 27.5 N > 0.75 x 30 N) and the host loop's script: the stuck
# tolerance raised before steps 2 and 3 (a forced wedge: no motion counts
# as stuck, so the escape along the contact force fires), a pause before
# step 5 that the heartbeat (timeout 0) recovers at step 6
WEDGE = dict(obj_xy=[[0.45, 0.0], [0.95, 0.95]], obj_radius=[0.08, 0.01],
             obj_height=[0.45, 0.01])
HOST_MODES = {"serial": dict(pipeline=False), "host-pipelined": dict(device_fast=False),
              "device-resident": {}}


def _wedge_scene(dev):
    import torch
    from ealv_tpu_torch.sim.renderer import TrayScene
    return TrayScene.default(dev)._replace(
        **{k: torch.tensor(v, dtype=torch.float32, device=dev) for k, v in WEDGE.items()})


def _arm_state_to(s, dev):
    """An ArmState with its tensors (and its scene's) on ``dev``."""
    import torch
    move = lambda v: v.to(dev) if torch.is_tensor(v) else v
    return dataclasses.replace(s, q=s.q.to(dev), qdot=s.qdot.to(dev), pose=s.pose.to(dev),
                               vel=s.vel.to(dev), brightness=s.brightness.to(dev),
                               scene=type(s.scene)(*map(move, s.scene)))


def _host_script(k, runner):
    if k == 2:
        runner.stuck.tol = 1e9
    if k == 4:
        runner.stuck.tol = 1e-5
    if k == 5:
        runner.pause.pause()


def phase_arm_agreement(n_host=8):
    """The arm at toy width, card against CPU from the same weights, arm
    state and fed draws (f32, TF32 off): two ticks on each arm backend
    (arm-dynamic with the force variant and movable objects), then
    ``n_host`` host-loop steps over a SyntheticBridge on arm-dynamic in the
    wedge scene, in each of the serial, host-pipelined and device-resident
    modes, with the forced wedge and its escape and a pause the heartbeat
    recovers: per step the arm's joints and pose and the plan, the events
    logged, and the absorbed samples. rtol 1e-3, atol 1e-4 (as the other
    agreement phases). Then the long-run ticks (``_arm_long_agreement``).
    Returns the largest difference."""
    import torch
    from ealv_tpu_torch.hw.bridge import SyntheticBridge
    from ealv_tpu_torch.runtime import Experiment, HostLoopRunner
    from ealv_tpu_torch.runtime.watchdog import RecoveryHeartbeat
    from ealv_tpu_torch.utils.config import ExperimentConfig

    worst = 0.0
    for backend, kw in (("arm", {}), ("arm-dynamic", dict(learn_force=True, obj_mobility=0.2)),
                        ("arm-dynamic-soft", {})):
        cfg = ExperimentConfig(**{**TOY, **kw, "sim_backend": backend})
        runs, env0 = {}, None
        for dev in ("cpu", "cuda"):
            exp = Experiment(cfg, train_calls_per_tick=1, train_every=1, device=dev)
            es = exp.init(seed=0)
            env0 = es.env if env0 is None else env0
            es.env = _arm_state_to(env0, dev)
            rng = np.random.default_rng(1)
            out = []
            for k in range(2):
                es, info = exp.tick(es, _toy_draws(cfg, k, rng, dev))
                out.append(_kept({
                    "q": es.env.q, "pose": es.env.pose, "objects": es.env.scene.obj_xy,
                    "plan": es.pstate.u, "cost": info["ergodic_cost"], "force": info["force"],
                    "loss": info["loss"], "beta": info["beta"], "gamma": info["gamma"],
                    "z ring": es.mstate.z_buff}))
            runs[dev] = [{k: v.detach().cpu() for k, v in o.items()} for o in out]
        err = _agree(runs, f"arm ticks {backend}")
        worst = max(worst, err)
        print(f"[agreement] 2 toy ticks on {backend}, cuda vs cpu with fed draws: joints, pose, "
              f"objects, plan, cost, force, loss, beta/gamma and z ring agree (rtol 1e-3, "
              f"atol 1e-4), max|diff| {err:.3e}")

    cfg = ExperimentConfig(**{**TOY, "sim_backend": "arm-dynamic"})
    env0 = Experiment(cfg, device="cpu", scene=_wedge_scene("cpu")).init(seed=0).env
    for mode, kw in HOST_MODES.items():
        runs, logs = {}, {}
        for dev in ("cpu", "cuda"):
            exp = Experiment(cfg, train_calls_per_tick=1, train_every=1,
                             scene=_wedge_scene(dev), device=dev)
            es = exp.init(seed=0)
            es.env = _arm_state_to(env0, dev)
            bridge = SyntheticBridge(exp.env, es.env)
            draws = {k: _toy_draws(cfg, k, np.random.default_rng(100 + k), dev)
                     for k in range(n_host + 1)}
            runner = HostLoopRunner(exp, bridge, draws_fn=draws.get,
                                    heartbeat=RecoveryHeartbeat(period_s=100.0, timeout_s=0.0),
                                    **kw)
            if (runner._fast, runner._cmd_absorb_plan is not None) != (
                    (mode == "device-resident",) * 2):
                raise RuntimeError(f"{mode}: the runner took another step form")
            out = []
            for k in range(n_host):
                _host_script(k, runner)
                es = runner.step(es)
                # copies: a replayed step overwrites the state's tensors
                out.append(_kept({"q": bridge.state.q, "pose": bridge.state.pose,
                                  "plan": es.pstate.u,
                                  "explr_step": torch.tensor(float(es.explr_step))}))
            es = runner.run(es, 0)
            n = es.buf.size
            out.append({"ring x": es.buf.x[:n], "ring y": es.buf.y[:n].float(),
                        "ring force": es.buf.force[:n]})
            runs[dev] = [{k: v.detach().cpu() for k, v in o.items()} for o in out]
            logs[dev] = list(runner.events)
        if logs["cuda"] != logs["cpu"]:
            raise RuntimeError(f"host loop {mode}: events {logs['cuda']} on the card, "
                               f"{logs['cpu']} on the CPU")
        if "stuck_escape" not in logs["cuda"] or "recover" not in logs["cuda"]:
            raise RuntimeError(f"host loop {mode}: no escape or recovery in {logs['cuda']}")
        err = _agree(runs, f"host loop {mode}")
        worst = max(worst, err)
        print(f"[agreement] {n_host} toy host-loop steps, {mode}, arm-dynamic in the wedge, cuda "
              f"vs cpu with fed draws: events {logs['cuda']} equal; joints, pose, plan and "
              f"the absorbed samples agree (rtol 1e-3, atol 1e-4), max|diff| {err:.3e}")
    return max(worst, _arm_long_agreement())


# the long runs of tests/test_torch_arm_long.py: 128-slot rings that wrap, a
# trainer call every third tick; on arm-dynamic, xyz with the force variant
# and movable objects on the force study's wide, tall cylinders, from a
# start 5 cm into the first one, where the contact guard blocks (25 N)
ARM_LONG = dict(buffer_capacity=128, traj_buffer_capacity=128)
ARM_LONG_CASES = {"arm": dict(states="xyw", sim_backend="arm"),
                  "arm-dynamic": dict(states="xyz", sim_backend="arm-dynamic",
                                      learn_force=True, obj_mobility=0.2)}
CONTACT_SCENE = dict(obj_radius=[0.07, 0.06], obj_height=[0.38, 0.42])
CONTACT_START = (0.42, -0.06, 0.33)


def _arm_long_agreement(n_run=140, n_ticks=4, devs=("cpu", "cuda")):
    """The ticks the re-synchronised CPU tests hold against the JAX package
    (tests/test_torch_arm_long.py), card against CPU: a toy run of
    ``n_run`` ticks on the CPU (its own draws; the rings wrap at 128) is
    checkpointed at its start and its end, each checkpoint is loaded on
    both devices (``runtime/checkpoint.py``), and ``n_ticks`` ticks with
    fed draws follow (one trainer call among them), on "arm" and
    "arm-dynamic". Per tick the joints, pose, objects, plan, cost, force,
    loss, beta/gamma and the pushed sample; rtol 1e-3, atol 1e-4 (as the
    other agreement phases). Returns the largest difference."""
    import torch
    from ealv_tpu_torch.runtime import Experiment
    from ealv_tpu_torch.runtime.checkpoint import load_checkpoint, save_checkpoint
    from ealv_tpu_torch.sim.renderer import TrayScene
    from ealv_tpu_torch.utils.config import ExperimentConfig

    worst = 0.0
    for backend, kw in ARM_LONG_CASES.items():
        cfg = ExperimentConfig(**{**TOY, **ARM_LONG, **kw})
        dynamic = backend.startswith("arm-dynamic")

        def make(dev):
            scene = None
            if dynamic:
                scene = TrayScene.default(dev)._replace(**{
                    k: torch.tensor(v, device=dev) for k, v in CONTACT_SCENE.items()})
            exp = Experiment(cfg, train_calls_per_tick=1, train_every=3, scene=scene,
                             device=dev)
            start = [(lo + hi) / 2 for lo, hi in exp.tray6]
            if dynamic:
                start[:3] = CONTACT_START
            return exp, exp.init(seed=0, start_tray_pose=start)

        def save(es, path, dev):
            """A checkpoint of ``es`` to restore on ``dev``: a CPU
            generator's state does not fit a CUDA generator, so the random
            streams saved are fresh ones of ``dev`` (the ticks' draws are
            fed)."""
            gens = es.gen, es.pstate.gen
            es.gen, es.pstate.gen = torch.Generator(device=dev), torch.Generator(device=dev)
            try:
                return save_checkpoint(path, es)
            finally:
                es.gen, es.pstate.gen = gens

        exp, es = make(devs[0])
        with tempfile.TemporaryDirectory(prefix="arm_long_") as tmp:
            paths = {"start": {d: save(es, os.path.join(tmp, f"start_{i}"), d)
                               for i, d in enumerate(devs)}}
            es, _ = exp.run_chunk(es, n_run)
            if es.buf.total <= cfg.buffer_capacity:
                raise RuntimeError(f"{backend}: the replay ring never wrapped")
            paths[f"tick {n_run}"] = {d: save(es, os.path.join(tmp, f"long_{i}"), d)
                                      for i, d in enumerate(devs)}
            for label, path in paths.items():
                runs = {}
                for name, dev in zip(("cpu", "cuda"), devs):
                    exp_d, es_d = make(dev)
                    es_d = load_checkpoint(path[dev], es_d)
                    rng = np.random.default_rng(7)
                    out = []
                    for _ in range(n_ticks):
                        k = min(es_d.explr_step, cfg.buffer_capacity - 1)
                        es_d, info = exp_d.tick(es_d, _toy_draws(cfg, k, rng, dev))
                        slot = (es_d.buf.pos - 1) % es_d.buf.capacity
                        out.append(_kept({"q": es_d.env.q, "pose": es_d.env.pose,
                                    "objects": es_d.env.scene.obj_xy, "plan": es_d.pstate.u,
                                    "cost": info["ergodic_cost"], "force": info["force"],
                                    "loss": info["loss"], "beta": info["beta"],
                                    "gamma": info["gamma"], "pushed x": es_d.buf.x[slot],
                                    "pushed y": es_d.buf.y[slot]}))
                    if not any(float(o["loss"]) != 0.0 for o in out):
                        raise RuntimeError(f"{backend} from {label}: no trainer call")
                    runs[name] = [{k: v.detach().cpu() for k, v in o.items()} for o in out]
                force = max(float(o["force"].max()) for o in runs["cpu"])
                if dynamic and label == "start" and force <= 0.75 * 30.0:
                    raise RuntimeError(f"{backend} from its start: {force:.1f} N, the guard "
                                       "does not block")
                err = _agree(runs, f"arm ticks {backend} from {label}")
                worst = max(worst, err)
                print(f"[agreement] {n_ticks} toy ticks on {backend} from the CPU run's "
                      f"checkpoint at {label} (rings {int(es.buf.total)} pushes into 128 slots at "
                      f"the end; force up to {force:.1f} N), cuda vs cpu with fed draws: "
                      f"joints, pose, objects, plan, cost, force, loss, beta/gamma and the "
                      f"pushed sample agree (rtol 1e-3, atol 1e-4), max|diff| {err:.3e}")
    return worst


def phase_arm_path(n_timed=12):
    """The tick on the arm at production size (sim_backend="arm", xyw),
    two ways (``_tick_paths``) after at least 60 warm ticks, so that the
    tick graphs replay a drift-correcting tick (the 60th: the corrections
    fall on every 20th command) in the run held bit-equal to the eager
    ticks; exactly 13 K1 launches a timed tick; then ``ArmEnv.step_vel``
    (without and with the drift correction), ``step_pose`` and ``observe``
    alone at the tick's state: the device intervals of one call under
    torch.profiler, device ms by CUDA events, host ms, and a check that the
    host never waits for the device (each call enqueued behind a spin
    kernel returns before the spin ends). Returns (launches, ms/tick, peak
    MiB, the env calls' readings, the path's readings)."""
    import torch
    from ealv_tpu_torch.utils.config import ExperimentConfig
    from ealv_tpu_torch.utils.timing import device_ms, host_ms

    cfg = ExperimentConfig(**{**PRODUCTION, "sim_backend": "arm"})
    exp, es, r = _tick_paths(cfg, n_timed, least=60)
    launches = r["launches"]["footprint_and_spread"]
    drift = {p: c for p, c in exp.tick_graph.counts.items() if any(p[2])}
    if launches != 13 * n_timed:
        raise RuntimeError(f"arm path: K1 launched {launches} times in {n_timed} ticks, "
                           f"expected {13 * n_timed}")
    _horizon_launches(r["launches"], n_timed, "arm path, tick graphs")
    if not any(c[2] for c in drift.values()):
        raise RuntimeError(f"arm path: no drift-correcting tick replayed: {drift}")
    losses, costs = r["infos"]["loss"].cpu(), r["infos"]["ergodic_cost"].cpu()
    if not (torch.isfinite(losses).all() and torch.isfinite(costs).all()
            and torch.isfinite(es.env.q).all()) or es.learning_ind <= 0:
        raise RuntimeError(f"arm path: losses {losses}, costs {costs}, q {es.env.q}")
    if not (es.env.q.is_cuda and es.buf.y.is_cuda):
        raise RuntimeError("arm path: the arm or the replay ring left the card")
    dt = r["ms"]["ticks"]
    print(f"[arm path] sim_backend=arm, xyw: {n_timed} timed ticks through the tick graphs "
          f"after {r['n_warm']} warm: {dt:.2f} ms/tick = {1e3 / dt:.2f} Hz | last loss "
          f"{float(losses[losses != 0][-1]):.4f} | K1 launches {launches} (13/tick) | pose "
          f"{[round(v, 4) for v in es.env.pose.tolist()]} | {_graph_note(exp)}")
    print(_two_ways("arm path", r))
    ticks = _tick_builders()
    _sync_free("arm tick", ticks.untrained_tick(exp, es))
    _sync_free("arm tick with a trainer call", ticks.trained_tick(exp, es))

    env = exp.env
    cmd = torch.tensor([0.02, -0.01, 0.0, 0.0, 0.0, 0.1], device="cuda")
    target = torch.tensor([0.5, 0.05, 0.32, 3.1, 0.0, 0.2], device="cuda")
    calls = {"step_vel": lambda: env.step_vel(dataclasses.replace(es.env, count=0), cmd),
             "step_vel with the drift correction": lambda: env.step_vel(
                 dataclasses.replace(es.env, count=19), cmd),
             "step_pose": lambda: env.step_pose(es.env, target),
             "observe": lambda: env.observe(es.env)}
    readings = {}
    for what, call in calls.items():
        wall, busy, _, _, n = _profiled_call(call)
        # one call per timed window: the card's launch queue holds about a
        # thousand launches, and a fuller one makes the host wait, so the
        # device would be paced by the host's enqueue
        d_ms, h_ms = device_ms(call, reps=21, inner=1), host_ms(call, inner=20)
        # the host must not wait for the device: enqueued behind a 0.2 s
        # spin kernel, the call returns long before the spin ends
        enqueue, spun = _behind_spin(call)
        if n < 1000 and enqueue > 0.5 * spun:
            raise RuntimeError(f"ArmEnv.{what}: the host waited for the device "
                               f"({enqueue * 1e3:.1f} ms of {spun * 1e3:.1f} ms)")
        readings[what] = dict(device_ms=d_ms, host_ms=h_ms, intervals=n, busy_ms=busy)
        print(f"[arm path] ArmEnv.{what}: {n} device intervals a call (busy {busy:.4f} ms "
              f"under the profiler, host {wall:.4f} ms); device {d_ms:.4f} ms by CUDA events, "
              f"host clock {h_ms:.4f} ms; behind a spin kernel the host enqueued it in "
              f"{enqueue * 1e3:.2f} ms of {spun * 1e3:.1f} ms"
              + ("" if n < 1000 else " (over the launch queue: no wait check)"))
    return launches, dt, r["peak"]["ticks"], readings, r


def _count_plans(exp):
    """Count exp.plan_step calls (a list the caller clears)."""
    plans, plan_step = [], exp.plan_step

    def counted(*a, **k):
        plans.append(1)
        return plan_step(*a, **k)

    exp.plan_step = counted
    return plans


def _host_ready(runner, es, n):
    """Each of the runner's next ``n`` steady steps (no stuck hit or pause)
    replays its pattern's step graph: the patterns follow from the host
    ints and the arm's command count alone."""
    from ealv_tpu_torch.runtime.graphs import _spec
    s, env = dataclasses.replace(es), runner.bridge.state
    for _ in range(n):
        pattern = runner._pattern(s, env)
        if (pattern, _spec(((), (None, None)))) not in runner.step_graph.entries:
            return False
        s.learning_ind += sum(pattern[0])
        s.explr_step += 1
        env = dataclasses.replace(env, count=env.count + 1)
    return True


def _host_pattern_name(pattern) -> str:
    """A host-loop step pattern (trainer calls, prior, drift, brightness)."""
    do, prior, drift, b = pattern
    return (f"{sum(do)} trainer call{'s' * (sum(do) != 1)}" + (", prior" if prior else "")
            + (", drift" if any(drift) else "") + (", brightness" if b else ""))


def _counted(obj, name, n: list):
    """Count the calls of ``obj.name`` into ``n[0]``."""
    fn = getattr(obj, name)

    def counted(*a, **k):
        n[0] += 1
        return fn(*a, **k)

    setattr(obj, name, counted)


def phase_host_loop_path(least=24, rounds=2, chunk=6):
    """The host loop at production size on arm-dynamic, HostLoopRunner over
    a SyntheticBridge in the device-resident mode (command, observation,
    absorb and plan on the card; a 13+3-float watchdog slice to pinned host
    memory), two ways in one call: through the runner's plan and step
    graphs (the default on the card) and eagerly (those and the
    experiment's graphs None), from the same seed. drive_to_start (no K1
    launch), then
    the same steps on both: warm steps (at least ``least``) until each of
    the next ``2 rounds chunk`` + 3 steps replays its pattern's graph,
    ``rounds`` x 4 timed chunks of ``chunk`` steps in turns (graphed,
    eager, eager, graphed), 3 profiled steps each. In a graphed chunk every
    step replays and makes no eager K1 launch but in a primed plan after a
    stuck hit that the plan graph runs eagerly, and K1 launches 13 times a
    plan through the replays; in an eager chunk 13 a plan. Every pending command, every
    arm state, the events and every state leaf are held bit for bit. Then
    a replayed step without and with a trainer call under
    ``set_sync_debug_mode("error")``. Returns the readings."""
    import torch
    from ealv_tpu_torch.hw.bridge import SyntheticBridge
    from ealv_tpu_torch.runtime import Experiment, HostLoopRunner
    from ealv_tpu_torch.runtime.graphs import kernel_counts, reset_launches, total_launches
    from ealv_tpu_torch.utils.config import ExperimentConfig

    cfg = ExperimentConfig(**{**PRODUCTION, "sim_backend": "arm-dynamic"})
    runs = {}
    for mode in ("graphs", "eager"):
        exp = Experiment(cfg, train_calls_per_tick=1, train_every=3, device="cuda")
        es = exp.init(seed=0)
        bridge = SyntheticBridge(exp.env, es.env)
        runner = HostLoopRunner(exp, bridge)
        if not (runner._fast and runner._cmd_absorb_plan is not None):
            raise RuntimeError("host loop path: the device-resident step is not in use")
        if mode == "eager":
            runner.plan_graph = runner.step_graph = exp.tick_graph = exp.post_train_graph = None
        elif any(g is None or g.pool is not exp.graph_pool
                 for g in (runner.plan_graph, runner.step_graph)):
            raise RuntimeError("host loop path: no plan or step graph in the experiment's pool")
        primes, steps = [0], [0]
        _counted(runner, "_plan_obs", primes)
        _counted(runner, "_step_absorb_plan", steps)
        reset_launches()
        t0 = time.perf_counter()
        ok, pos = runner.drive_to_start(bridge.klerg_start_pose(), yaw_index=5)
        seek_s = time.perf_counter() - t0
        if total_launches()["footprint_and_spread"] or primes[0]:
            raise RuntimeError("drive_to_start made K1 launches or plans")
        runs[mode] = dict(runner=runner, es=es, primes=primes, steps=steps, outs=[],
                          seek=(ok, pos, seek_s))

    def step(run):
        run["runner"].step(run["es"])
        pending = run["runner"]._pending
        run["outs"].append((None if pending is None else pending[2].clone(),
                            _tree(run["runner"].bridge.state)))

    g_run = runs["graphs"]
    g = g_run["runner"].step_graph
    n_warm = 0
    while n_warm < least or not _host_ready(g_run["runner"], g_run["es"],
                                            2 * rounds * chunk + 3):
        if n_warm > 150:
            raise RuntimeError(f"host loop path: not every pattern captured after 150 steps: "
                               f"{g.counts}")
        for run in runs.values():
            step(run)
        n_warm += 1
    turns = {"graphs": [], "eager": []}
    k1 = {"graphs": [0, 0], "eager": [0, 0]}  # (launches, plans)
    for mode in ("graphs", "eager", "eager", "graphs") * rounds:
        run = runs[mode]
        reset_launches()
        replays, steps0, primes0 = g.replays, run["steps"][0], run["primes"][0]
        warm_plans = g_run["runner"].plan_graph.warmups
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(chunk):
            step(run)
        torch.cuda.synchronize()
        turns[mode].append((time.perf_counter() - t0) / chunk * 1e3)
        plans = run["steps"][0] - steps0 + run["primes"][0] - primes0
        launches, eager = total_launches()["footprint_and_spread"], \
            kernel_counts()["footprint_and_spread"]
        k1[mode][0] += launches
        k1[mode][1] += plans
        if mode == "graphs":
            eager_plans = g_run["runner"].plan_graph.warmups - warm_plans
            if (g.replays - replays != chunk or launches != 13 * plans
                    or eager != 13 * eager_plans):
                raise RuntimeError(f"host loop path: {g.replays - replays} replays in a chunk "
                                   f"of {chunk}, K1 {launches} through the graphs for {plans} "
                                   f"plans, {eager} eager")
        elif eager != 13 * plans:
            raise RuntimeError(f"host loop path, eager: K1 {eager} for {plans} plans")
        _horizon_launches(total_launches(), plans, f"host loop path, {mode}")
    profiles = {}
    for mode, run in runs.items():
        def three(run=run):
            for _ in range(3):
                step(run)
        wall, busy, _, _, n = _profiled_call(three)
        profiles[mode] = dict(host_ms=wall, busy_ms=busy, intervals=n)
    eager_run = runs["eager"]
    if eager_run["runner"].events != g_run["runner"].events:
        raise RuntimeError(f"host loop path: events {g_run['runner'].events} against eager "
                           f"{eager_run['runner'].events}")
    n_out = _tree_equal("host loop path: graphed commands and arm states against eager",
                        _tree(eager_run["outs"]), _tree(g_run["outs"]))
    n_state = _tree_equal("host loop path: graphed state against eager",
                          _snapshot(eager_run["es"]), _snapshot(g_run["es"]))
    es, bridge = g_run["es"], g_run["runner"].bridge
    if not (es.buf.y.is_cuda and bridge.state.q.is_cuda):
        raise RuntimeError("host loop path: the state left the card")
    if not torch.isfinite(bridge.state.pose).all():
        raise RuntimeError("host loop path: non-finite pose")
    sync = _tick_builders()
    for trained in (False, True):
        _sync_free(f"host-loop step (arm-dynamic, production, replayed"
                   f"{', a trainer call' if trained else ''})",
                   sync.host_loop_step(g_run["runner"], es, trained=trained))
    ok, pos, seek_s = g_run["seek"]
    r = dict(turns=turns, ms={m: float(np.median(v)) for m, v in turns.items()},
             profile=profiles, k1=k1, pool_mib=_pool_mib(g), n_warm=n_warm,
             counts={_host_pattern_name(p): c for p, c in g.counts.items()},
             capture_s={_host_pattern_name(p): [round(t, 3) for t in v]
                        for p, v in g.capture_seconds.items()},
             steps=len(g_run["outs"]), leaves=(n_out, n_state),
             events=g_run["runner"].events)
    p = r["profile"]
    print(f"[host loop path] arm-dynamic, device-resident, production: drive_to_start "
          f"{'reached' if ok else 'missed'} {np.round(pos, 3).tolist()} in {seek_s:.2f} s "
          f"(0 K1) | ms/step in turns (medians of {2 * rounds} chunks of {chunk} after "
          f"{n_warm} warm), graphed {r['ms']['graphs']:.2f} "
          f"{[round(v, 2) for v in turns['graphs']]}, eager {r['ms']['eager']:.2f} "
          f"{[round(v, 2) for v in turns['eager']]} | 3 profiled steps, host ms / busy ms / "
          f"intervals: " + "; ".join(f"{m} {p[m]['host_ms']:.2f} / {p[m]['busy_ms']:.2f} / "
                                     f"{p[m]['intervals']}" for m in p)
          + f" | K1 in the timed chunks: graphed {k1['graphs'][0]} through the replays for "
          f"{k1['graphs'][1]} plans, 0 eager in replayed steps; eager {k1['eager'][0]} for "
          f"{k1['eager'][1]} plans (13/plan) | [eager, captured, replays] by pattern "
          f"{r['counts']} | capture s {r['capture_s']} | pool {r['pool_mib']} MiB | "
          f"{r['steps']} steps bit-equal to eager steps: {n_out} command and arm leaves, "
          f"{n_state} state leaves, the events {r['events'] or 'none'} | learning_ind "
          f"{es.learning_ind}")
    return r


def phase_native_bridge(n_steps=12, budget_s=60.0):
    """The host loop over NativeBridge at production size: the controller
    library built from native/ by hw/native.build_native, its C++ 1 kHz
    loop against a numpy driver that integrates the commanded twist, and a
    camera callback (in the runner's thread) that renders the tray at
    180x180 on the card from the driver's pose. Runs until n_steps samples
    are absorbed, within budget_s seconds (a degraded loop rate fails
    commands and pauses the runner until the heartbeat recovers it, 0.2 s
    later). The runner takes the host-pipelined step through its step
    graph (the host observation staged), which replays once a pattern is
    captured; every plan (a step's, or one primed after a recovery) makes
    13 K1 launches, counted through the replays. Prints the loop's stats."""
    import torch
    from ealv_tpu_torch.hw.bridge import NativeBridge
    from ealv_tpu_torch.runtime import Experiment, HostLoopRunner
    from ealv_tpu_torch.runtime.graphs import reset_launches, total_launches
    from ealv_tpu_torch.runtime.watchdog import RecoveryHeartbeat
    from ealv_tpu_torch.sim.renderer import TrayScene, render_camera
    from ealv_tpu_torch.utils.config import ExperimentConfig

    cfg = ExperimentConfig(**PRODUCTION)
    exp = Experiment(cfg, train_calls_per_tick=1, train_every=3, device="cuda")
    es = exp.init(seed=0)
    scene = TrayScene.default("cuda")

    class Driver:
        """Integrates the commanded twist at 1 kHz (numpy only)."""

        def __init__(self, pose):
            self.pose, self.vel = np.asarray(pose, np.float64), np.zeros(6)

        def state(self):
            return self.pose.copy(), self.vel.copy(), np.zeros(6)

        def apply_velocity(self, twist):
            self.vel = np.asarray(twist, np.float64)
            self.pose = self.pose + self.vel * 1e-3

    drv = Driver(es.env.pose.cpu().numpy())

    def camera():
        pose = torch.as_tensor(drv.pose, dtype=torch.float32).to("cuda")
        return render_camera(scene, pose, 1.0, cfg.image_dim[:2]), time.monotonic()

    t_build = time.perf_counter()
    bridge = NativeBridge(driver=drv, camera=camera)
    t_build = time.perf_counter() - t_build
    bridge.start()
    try:
        runner = HostLoopRunner(exp, bridge,
                                heartbeat=RecoveryHeartbeat(period_s=5.0, timeout_s=0.2))
        if runner._fast or runner.step_graph is None:
            raise RuntimeError("native bridge: not the host-pipelined step through a graph")
        plans = [0]
        _counted(runner, "_plan_obs", plans)
        _counted(runner, "_step_absorb_plan", plans)
        reset_launches()
        t0, iters = time.perf_counter(), 0
        while es.explr_step < n_steps and time.perf_counter() - t0 < budget_s:
            es = runner.step(es)
            iters += 1
            if runner.pause.paused:
                time.sleep(0.05)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        bridge.stop()
    stats = bridge.loop_stats()
    g, k1 = runner.step_graph, total_launches()["footprint_and_spread"]
    _horizon_launches(total_launches(), plans[0], "native bridge")
    counts = {_host_pattern_name(p): c for p, c in g.counts.items()}
    capture_s = {_host_pattern_name(p): [round(t, 3) for t in v]
                 for p, v in g.capture_seconds.items()}
    if g.replays < 1 or k1 != 13 * plans[0]:
        raise RuntimeError(f"native bridge: {g.replays} step-graph replays, K1 {k1} for "
                           f"{plans[0]} plans")
    if es.explr_step < n_steps:
        raise RuntimeError(f"native bridge: {es.explr_step} samples in {iters} steps; events "
                           f"{runner.events}; loop {stats}")
    if not (es.buf.y.is_cuda and all(p.is_cuda for p in es.model.parameters())):
        raise RuntimeError("native bridge: the run left the card")
    if not np.isfinite(drv.pose).all() or stats["ticks"] <= 0:
        raise RuntimeError(f"native bridge: driver pose {drv.pose}, loop {stats}")
    print(f"[native bridge] library built/loaded in {t_build:.2f} s; {es.explr_step} samples "
          f"in {iters} host-loop steps, {wall:.2f} s ({wall / iters * 1e3:.2f} ms/step) | "
          f"host-pipelined step graph [eager, captured, replays] by pattern {counts}, "
          f"capture s {capture_s} | K1 launches {k1} for {plans[0]} plans (13/plan, through the replays) | "
          f"events {runner.events or 'none'} | "
          f"loop_stats: {stats['rate_hz']:.1f} Hz over {stats['ticks']} ticks, jitter mean "
          f"{stats['jitter_mean_s'] * 1e6:.1f} us, max {stats['jitter_max_s'] * 1e6:.1f} us, "
          f"{stats['missed']} missed deadlines | driver pose "
          f"{np.round(drv.pose[:3], 4).tolist()}")
    stats["ms_step"], stats["k1"], stats["plans"] = wall / iters * 1e3, k1, plans[0]
    return stats


def phase_learning_path(steps=12, chunk=6, train_every=3, save_rate=6, n_post=3):
    """The learning path at production size through the port's run entry,
    with both trainer kernels on, its ticks and post-training calls through
    the tick and post-training graphs. The postexplr checkpoint is reloaded
    into a fresh Experiment and compared tensor for tensor; then ``n_post``
    post-training calls from it through the post-training graph (an eager
    call, a capture and its replay, a replay) are held bit for bit against
    the same calls made eagerly from it."""
    import torch
    from ealv_tpu_torch.runtime.checkpoint import load_checkpoint, state_leaves
    from ealv_tpu_torch.runtime.graphs import kernel_launches, reset_launches
    from ealv_tpu_torch.runtime.metrics import MetricsLog, run_dir
    from ealv_tpu_torch.scripts import run_experiment as cli

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    args = cli.build_parser().parse_args([
        "--steps", str(steps), "--chunk", str(chunk), "--train-every",
        str(train_every), "--save-rate", str(save_rate), "--out", tmp, "--device", "cuda"])

    def experiment(graphs=True):
        cfg = dataclasses.replace(cli.make_config(args), fast_encoder_grads="pallas")
        exp = cli.make_experiment(cfg, args)
        exp.trainer = dataclasses.replace(exp.trainer, fused_adam=True)
        if not graphs:
            exp.tick_graph = exp.post_train_graph = None
        return exp

    try:
        exp = experiment()
        dirp = run_dir(tmp, "synth", args.method, args.seed)
        ml = MetricsLog(dirp, echo=False)
        es = exp.init(seed=args.seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(*exp.graphs())
        t0 = time.perf_counter()
        es = cli.run(exp, args, dirp, ml, es=es)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernel_launches(*exp.graphs())
        k1, k2, k3 = (counts["footprint_and_spread"], counts["adam_apply"],
                      counts["conv_wgrad_direct"])
        peak = torch.cuda.max_memory_allocated()

        calls = es.learning_ind
        target = int(steps * exp.cfg.target_learning_rate)
        losses = np.concatenate([np.atleast_1d(x) for x in ml.series["loss"]])
        n_posted = losses.size - steps  # the ticks log one loss each
        if es.explr_step != steps or calls != target:
            raise RuntimeError(f"run ended at explr_step {es.explr_step}, "
                               f"learning_ind {calls}; expected {steps}, {target}")
        if k2 != 25 * calls or k3 != 75 * calls:
            raise RuntimeError(f"{calls} trainer calls made {k2} K2 launches and {k3} "
                               f"K3 calls; expected {25 * calls} and {75 * calls}")
        if k1 != 13 * steps + n_posted:
            raise RuntimeError(f"K1 launched {k1} times; expected 13 per tick and one "
                               f"per post-training call, {13 * steps + n_posted}")
        _horizon_launches(counts, steps, "learning path, tick graphs")
        if exp.tick_graph.replays < 1 or exp.post_train_graph.replays < 1:
            raise RuntimeError(f"the run replayed no tick or post-training graph: "
                               f"{_graph_note(exp)}")
        trained = losses[losses != 0]
        if not np.isfinite(losses).all() or trained.size != calls:
            raise RuntimeError(f"losses {losses}")
        if not all(p.is_cuda for p in es.model.parameters()) or not es.buf.y.is_cuda:
            raise RuntimeError("parameters or the replay ring left the card")
        cks = sorted(os.listdir(os.path.join(dirp, "checkpoints")))
        if cks != ["postexplr", "step_0000006", "step_0000012"]:
            raise RuntimeError(f"checkpoints {cks}")

        postexplr = os.path.join(dirp, "checkpoints", "postexplr")
        restored = load_checkpoint(postexplr, experiment().init(seed=args.seed + 1))
        n_tensors = 0
        for (path, a), (_, b) in zip(state_leaves(es), state_leaves(restored), strict=True):
            if isinstance(a, torch.Tensor):
                if a.dtype != b.dtype or a.device != b.device or not torch.equal(a, b):
                    raise RuntimeError(f"{path}: the reloaded tensor differs")
                n_tensors += 1
            elif a != b:
                raise RuntimeError(f"{path}: {a!r} != {b!r}")
        del restored, es
        post = {}
        for mode in ("ticks", "eager"):
            exp_p = experiment(mode == "ticks")
            es_p = load_checkpoint(postexplr, exp_p.init(seed=args.seed + 1))
            _, rows = exp_p.post_train_chunk(es_p, n_post)
            post[mode] = (rows, _snapshot(es_p), exp_p)
            del es_p
        _held_equal("post-training through its graph against eager calls", post["eager"][0],
                    post["ticks"][0])
        _held_equal("post-training through its graph against eager calls", post["eager"][1],
                    post["ticks"][1])
        g = post["ticks"][2].post_train_graph
        if g.counts != {(): [1, 1, n_post - 1]}:
            raise RuntimeError(f"post-training graph: {g.counts}")
    finally:
        import shutil
        shutil.rmtree(tmp)
    print(f"[learning path] run entry at production size, K2 and K3 on: {steps} steps "
          f"(chunk {chunk}, a trainer call every {train_every}) + {n_posted} post-training "
          f"calls = {calls} trainer calls in {wall:.2f} s through the tick and post-training "
          f"graphs (checkpoints included) | K2 "
          f"launches {k2} (25/call) | K3 calls {k3} (75/call) | K1 launches {k1} | last "
          f"loss {float(trained[-1]):.4f} | postexplr reloaded: {n_tensors} tensors "
          f"equal | {n_post} post-training calls from it through the graph bit-equal to "
          f"eager calls ({len(post['ticks'][1])} state leaves) | peak memory "
          f"{peak / 2**20:.1f} MiB | {_graph_note(exp)}")
    return k1, k2, k3, wall


def _fill_ring(es, cfg, n_filled, seed=3):
    """Push ``n_filled`` uniform random samples to the experiment's ring,
    drawn on the card from a generator seeded with ``seed`` (every process
    that calls this with the same seed pushes the same samples)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    lo = torch.as_tensor(cfg.robot_lim[:, 0], device="cuda")
    hi = torch.as_tensor(cfg.robot_lim[:, 1], device="cuda")
    for _ in range(n_filled):
        es.buf.push(torch.rand(cfg.s_dim, generator=g, device="cuda") * (hi - lo) + lo,
                    torch.rand(cfg.image_dim, generator=g, device="cuda"))
    return es.buf


class _NcclGroup:
    """A one-rank NCCL process group over the card for the phases inside
    the ``with``, destroyed at its end so that no later phase inherits it."""

    def __enter__(self):
        import torch
        import torch.distributed as dist
        self._tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_")
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(self._tmp.name, "store"), 1), rank=0, world_size=1,
            device_id=torch.device("cuda", 0))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        dist.destroy_process_group()
        self._tmp.cleanup()
        return False


def phase_dp_trainer(n_filled=200, rounds=2):
    """The data-parallel trainer call at world size 1 over NCCL, at the
    production config with K2 and K3 on: bit-equal to the plain train_call
    on the same weights, ring and fed draws (the all-reduce is a copy, the
    division by 1 exact), 25 K2 and 75 K3 launches a call, K2's launch
    table built 0 times in the timed calls; then host ms a call and the
    device's busy ms under the profiler, beside the plain call's (the
    difference is the collective's cost). Inside an NCCL group."""
    import torch
    from ealv_tpu_torch.ops import adam as tad, wgrad as twg
    from ealv_tpu_torch.parallel import dp_train_call, make_mesh
    from ealv_tpu_torch.runtime import train_call
    from ealv_tpu_torch.utils.config import ExperimentConfig

    cfg = ExperimentConfig(**PRODUCTION)
    mesh = make_mesh(device="cuda")
    runs = {dp: _trainer_experiment(cfg, "cuda", kernels=True) for dp in (True, False)}
    runs[False][1].buf = _fill_ring(runs[True][1], cfg, n_filled)
    draws = _train_draws(cfg, n_filled, np.random.default_rng(4), "cuda")
    beta, gamma = torch.tensor(0.005, device="cuda"), torch.tensor(0.5, device="cuda")

    def call(dp, **kw):
        exp, es = runs[dp]
        if dp:
            return dp_train_call(exp.trainer, mesh, es.model, es.opt, es.buf, beta, gamma, **kw)
        return train_call(exp.trainer, es.model, es.opt, es.buf, beta, gamma, **kw)

    k2, k3 = tad.adam_apply.launches, twg.conv_wgrad_direct.launches
    met_dp = call(True, draws=draws)
    k2, k3 = tad.adam_apply.launches - k2, twg.conv_wgrad_direct.launches - k3
    met = call(False, draws=draws)
    if (k2, k3) != (25, 75):
        raise RuntimeError(f"the data-parallel call made {k2} K2 and {k3} K3 launches, "
                           "expected 25 and 75")
    differ = [name for (name, a), b in zip(runs[True][1].model.named_parameters(),
                                           runs[False][1].model.parameters())
              if not torch.equal(a, b)]
    differ += [f"metric {k}" for k, v in met.items() if not torch.equal(met_dp[k], v.float())]
    if differ:
        raise RuntimeError(f"the world-size-1 data-parallel call differs from the plain "
                           f"call in {len(differ)} tensors: {differ[:8]}")
    times = {True: [], False: []}
    builds = tad.adam_apply.builds
    for _ in range(rounds):
        for dp in (True, False, False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call(dp, generator=runs[dp][1].gen)
            torch.cuda.synchronize()
            times[dp].append((time.perf_counter() - t0) * 1e3)
    builds = tad.adam_apply.builds - builds
    if builds:
        raise RuntimeError(f"K2's launch table was built {builds} times in the timed "
                           "data-parallel and plain calls")
    busy, spans = {True: [], False: []}, {True: [], False: []}
    for dp in (True, False, False, True):
        _, b, _, _, n = _profiled_call(lambda: call(dp, generator=runs[dp][1].gen))
        busy[dp].append(round(b, 2))
        spans[dp].append(n)
    host = {dp: float(np.median(t)) for dp, t in times.items()}
    dev = {dp: float(np.median(b)) for dp, b in busy.items()}
    print(f"[dp trainer] world size 1 over NCCL, production, K2 + K3 on: bit-equal to the "
          f"plain call on the same draws (25 losses, {len(met)} metrics, every parameter); "
          f"K2 {k2} and K3 {k3} launches a call; K2's table built {builds} times in "
          f"{100 * rounds} timed steps | host ms a call: data-parallel {host[True]:.2f}, "
          f"plain {host[False]:.2f} (medians of {2 * rounds}, interleaved; "
          f"{[round(x, 2) for x in times[True]]} / {[round(x, 2) for x in times[False]]}) | "
          f"device busy ms a call: {dev[True]:.2f} / {dev[False]:.2f} (each profiled call: "
          f"{busy[True]} / {busy[False]} ms in {spans[True]} / {spans[False]} intervals)")
    captured = _dp_trainer_capture(cfg, mesh, n_filled, rounds)
    return dict(host_ms=host[True], plain_host_ms=host[False], busy_ms=dev[True],
                plain_busy_ms=dev[False], k2=k2, k3=k3, captured=captured)


def _dp_trainer_capture(cfg, mesh, n_filled, rounds):
    """The data-parallel trainer call captured in the post-training call's
    graph of an Experiment over the one NCCL rank (its all-reduces captured
    with it) against eager post-training calls at production size, with
    the trainer kernels on and off, as ``phase_trainer_capture`` holds the
    plain call: three experiments over the mesh from seed 0, their rings
    filled alike, two eager, one through the graph (an eager call, a
    capture and its replay, a replay) on the same fed draws; the captured
    call equals the eager one bit for bit where the two eager calls agree
    bit for bit (K3's deterministic wgrad), and stays within their spread
    where they do not (cuDNN's). Then host ms per call on the generator's
    draws, eager against captured in turns, and busy ms."""
    import torch

    err = lambda a, b: max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))
    out = {}
    for on in (True, False):
        runs = [_trainer_experiment(cfg, "cuda", kernels=on, mesh=mesh) for _ in range(3)]
        for exp, es in runs:
            _fill_ring(es, cfg, n_filled)
        for exp, _ in runs[:2]:
            exp.post_train_graph = None
        graph = runs[2][0].post_train_graph
        rng = np.random.default_rng(12)
        spread = gap = 0.0
        for _ in range(3):
            draws = [_post_train_draws(cfg, n_filled, rng)]
            leaves = []
            for exp, es in runs:
                rows = exp.post_train_chunk(es, 1, draws)[1]
                leaves.append([*rows.values(), *(q.detach() for q in es.model.parameters())])
            spread = max(spread, err(leaves[1], leaves[0]))
            gap = max(gap, err(leaves[2], leaves[0]))
        name = "kernels on (K2 + K3)" if on else "kernels off (torch.optim.Adam + cuDNN)"
        if graph.counts != {(): [1, 1, 2]} or gap > spread:
            raise RuntimeError(f"captured data-parallel call, {name}: [eager, captured, "
                               f"replays] {graph.counts}; max|captured - eager| {gap:.3e}, "
                               f"two eager calls {spread:.3e}")
        (exp_e, es_e), (exp_g, es_g) = runs[0], runs[2]
        eager = lambda: exp_e.post_train_chunk(es_e, 1)
        replay = lambda: exp_g.post_train_chunk(es_g, 1)
        replay()  # the generator's draws are a new key: an eager call, then a capture
        replay()
        times = {"eager": [], "captured": []}
        for _ in range(rounds):
            for which, call in (("eager", eager), ("captured", replay), ("captured", replay),
                                ("eager", eager)):
                times[which].append(_timed(call))
        busy = {which: _profiled_call(call)[1]
                for which, call in (("eager", eager), ("captured", replay))}
        recorded = graph.entries[((), None)].recorded
        res = dict(host_ms={w: float(np.median(t)) for w, t in times.items()}, busy_ms=busy,
                   gap=gap, spread=spread, capture_s=graph.capture_seconds[()][-1],
                   k2=recorded["adam_apply"], k3=recorded["conv_wgrad_direct"])
        out[on] = res
        print(f"[dp trainer graph] {name}, one NCCL rank, production, fed draws, "
              f"post-training calls: an eager call, a capture and its replay, a replay; rows "
              f"and parameters max|captured - eager| {gap:.3e}, two eager experiments "
              f"{spread:.3e}" + (" (bit for bit)" if gap == 0.0 else "")
              + f" | generator draws, host ms a call in turns: eager "
              f"{res['host_ms']['eager']:.2f}, captured {res['host_ms']['captured']:.2f} "
              f"({[round(x, 2) for x in times['eager']]} / "
              f"{[round(x, 2) for x in times['captured']]}); busy ms eager "
              f"{busy['eager']:.2f}, captured {busy['captured']:.2f} | capture "
              f"{res['capture_s']:.3f} s, recorded K2 {res['k2']} and K3 {res['k3']}")
        if (res["k2"], res["k3"]) != ((25, 75) if on else (0, 0)):
            raise RuntimeError(f"captured data-parallel call, {name}: K2 {res['k2']} and K3 "
                               f"{res['k3']} recorded")
        del runs, exp_e, es_e, exp_g, es_g, graph, eager, replay
        torch.cuda.empty_cache()
    return out


def _dp_rank(n_filled):
    """One rank of the two-rank gloo phase on the one card: a deterministic
    SGD step (lr 0.1) at the production widths in f32 (K3's f32 kernel at
    32 rows a rank) and a 25-step Adam call in bf16 with K2 and K3 on. Returns
    the SGD step's averaged gradients, the Adam call's parameters and
    losses and its K2 / K3 launches, on the CPU."""
    import torch
    from ealv_tpu_torch.ops import adam as tad, cuda_build, wgrad as twg
    from ealv_tpu_torch.parallel import dp_train_call, make_mesh
    from ealv_tpu_torch.utils.config import ExperimentConfig

    for source in ("adam.cu", "wgrad.cu", "footprint.cu"):
        cuda_build.load(source)  # built by the parent
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(device="cuda")
    grads, sgd_params = _sgd_step(n_filled, lambda *a, **k: dp_train_call(
        a[0], mesh, *a[1:], **k))
    cfg = ExperimentConfig(**PRODUCTION)
    exp, es = _trainer_experiment(cfg, "cuda", kernels=True)
    _fill_ring(es, cfg, n_filled)
    k2, k3 = tad.adam_apply.launches, twg.conv_wgrad_direct.launches
    met = dp_train_call(exp.trainer, mesh, es.model, es.opt, es.buf,
                        torch.tensor(0.005, device="cuda"), torch.tensor(0.5, device="cuda"),
                        generator=es.gen)
    k2, k3 = tad.adam_apply.launches - k2, twg.conv_wgrad_direct.launches - k3
    return dict(grads=grads, sgd_params=sgd_params, loss=met["loss"].cpu(), k2=k2, k3=k3,
                params=[p.detach().cpu() for p in es.model.parameters()])


def _sgd_step(n_filled, train):
    """One deterministic SGD step (lr 0.1, unweighted fed draws, f32,
    K3 on) at the production widths through ``train`` (the plain or the
    data-parallel call); returns the gradients it applied and the updated
    parameters, on the CPU."""
    import torch
    from ealv_tpu_torch.utils.config import ExperimentConfig

    cfg = dataclasses.replace(ExperimentConfig(**PRODUCTION), compute_dtype="float32",
                              num_learning_opt=1)
    exp, es = _trainer_experiment(cfg, "cuda", kernels=True)
    _fill_ring(es, cfg, n_filled)
    draws = _train_draws(cfg, n_filled, np.random.default_rng(5), "cuda")
    opt = torch.optim.SGD(es.model.parameters(), lr=0.1)
    train(exp.trainer, es.model, opt, es.buf, torch.tensor(0.0, device="cuda"),
          torch.tensor(0.0, device="cuda"), deterministic=True, weighted=False, draws=draws)
    params = list(es.model.parameters())
    return [p.grad.cpu() for p in params], [p.detach().cpu() for p in params]


def phase_dp_two_ranks(n_filled=200, timeout=600.0):
    """Two ranks on the one card over gloo (CUDA tensors; NCCL refuses two
    ranks on one device), spawned processes with the kernels built: the
    data-parallel SGD step's averaged gradients equal the one-process
    full-batch step's (the DDP contract; rtol 1e-4, atol 1e-4 x the
    tensor's largest gradient: f32 sums over other row splits), and the
    two ranks' updated parameters are bit-equal; a 25-step Adam call in bf16
    with K2 and K3 on leaves both ranks bit-equal with finite losses, 25 K2
    and 75 K3 launches a rank (K3 at 32 rows)."""
    import torch
    from ealv_tpu_torch.parallel._launch import run_ranks
    from ealv_tpu_torch.runtime import train_call

    t0 = time.perf_counter()
    ranks = run_ranks(_dp_rank, 2, args=(n_filled,), timeout=timeout, threads=None)
    wall = time.perf_counter() - t0
    full_grads, _ = _sgd_step(n_filled, train_call)
    worst = 0.0
    for g_dp, g in zip(ranks[0]["grads"], full_grads):
        torch.testing.assert_close(g_dp, g, rtol=1e-4, atol=1e-4 * float(g.abs().max()))
        worst = max(worst, float(((g_dp - g).abs() / g.abs().max().clamp(min=1e-30)).max()))
    for what in ("sgd_params", "params"):
        if not all(torch.equal(a, b) for a, b in zip(ranks[0][what], ranks[1][what])):
            raise RuntimeError(f"two ranks: the ranks' {what} differ")
    for r in ranks:
        if (r["k2"], r["k3"]) != (25, 75) or not torch.isfinite(r["loss"]).all():
            raise RuntimeError(f"two ranks: K2 {r['k2']}, K3 {r['k3']}, losses {r['loss']}")
    print(f"[dp two ranks] gloo, two processes on the one card, production widths: the SGD "
          f"step's averaged gradients vs the full batch's max|diff| / max|g| {worst:.2e} "
          f"(rtol 1e-4, atol 1e-4 x max|g|), the ranks' parameters bit-equal; bf16 Adam "
          f"call with K2 + K3: ranks bit-equal, K2 / K3 {ranks[0]['k2']} / {ranks[0]['k3']} "
          f"a rank, last loss {float(ranks[0]['loss'][-1]):.4f}; {wall:.1f} s with the "
          f"spawns")
    return worst


def phase_mesh_tick(xyw_ms, least=9, rounds=2, chunk=6):
    """The tick at the production config over a one-rank NCCL mesh (the
    planner's decode through sharded_pdf, the trainer through dp_train_call,
    K2 and K3 on) two ways in one call, from seed 0 over the same ticks:
    through the tick graphs, their collectives captured with them, and
    eagerly (every graph None). Warm ticks (at least ``least``) until each
    of the next ``2 rounds chunk`` + 3 ticks replays its pattern's graph,
    then ``rounds`` x 4 timed chunks of ``chunk`` ticks in turns (graphed,
    eager, eager, graphed): in a graphed chunk every tick replays with no
    eager kernel launch, and through the replays K1 launches 13 times a
    tick, K2 25 and K3 75 times a trainer call, as in an eager chunk. Every
    info and state leaf held bit for bit; 3 profiled ticks each; a replayed
    tick without and with a trainer call under ``set_sync_debug_mode
    ("error")``. Inside an NCCL group."""
    import torch
    from ealv_tpu_torch.parallel import make_mesh
    from ealv_tpu_torch.runtime import Experiment
    from ealv_tpu_torch.runtime.graphs import kernel_counts, reset_launches, total_launches
    from ealv_tpu_torch.utils.config import ExperimentConfig

    cfg = ExperimentConfig(**PRODUCTION, fast_encoder_grads="pallas")
    mesh = make_mesh(device="cuda")
    runs = {}
    for mode in ("graphs", "eager"):
        exp = Experiment(cfg, train_calls_per_tick=1, train_every=3, device="cuda", mesh=mesh)
        exp.trainer = dataclasses.replace(exp.trainer, fused_adam=True)
        if exp.eager_reason is not None or len(exp.graphs()) != 2:
            raise RuntimeError(f"mesh tick: an NCCL mesh ran eagerly ({exp.eager_reason})")
        if mode == "eager":
            exp.tick_graph = exp.post_train_graph = None
        runs[mode] = [exp, exp.init(seed=0), []]
    exp, es = runs["graphs"][:2]
    n_warm = 0
    while n_warm < least or not _ready(exp, es, 2 * rounds * chunk + 3):
        if n_warm > 150:
            raise RuntimeError(f"mesh tick: not every pattern captured after 150 ticks: "
                               f"{_graph_note(exp)}")
        for run in runs.values():
            run[2].append(run[0].tick(run[1])[1])
        n_warm += 1
    turns = {"graphs": [], "eager": []}
    k = {"graphs": dict.fromkeys(("K1", "K2", "K3", "ticks", "calls"), 0)}
    k["eager"] = dict(k["graphs"])
    names = {"K1": "footprint_and_spread", "K2": "adam_apply", "K3": "conv_wgrad_direct"}
    for mode in ("graphs", "eager", "eager", "graphs") * rounds:
        e, st, infos = runs[mode]
        reset_launches()
        replays, calls = exp.tick_graph.replays, st.learning_ind
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(chunk):
            infos.append(e.tick(st)[1])
        torch.cuda.synchronize()
        turns[mode].append((time.perf_counter() - t0) / chunk * 1e3)
        calls = st.learning_ind - calls
        got = {n: total_launches()[v] for n, v in names.items()}
        eager = kernel_counts()
        want = {"K1": 13 * chunk, "K2": 25 * calls, "K3": 75 * calls}
        if got != want or (mode == "graphs" and (exp.tick_graph.replays - replays != chunk
                                                 or any(eager.values()))):
            raise RuntimeError(f"mesh tick, {mode}: launches {got} for {chunk} ticks and "
                               f"{calls} trainer calls (eager {eager}), "
                               f"{exp.tick_graph.replays - replays} replays")
        _horizon_launches(total_launches(), chunk, f"mesh tick, {mode}")
        for n in names:
            k[mode][n] += got[n]
        k[mode]["ticks"] += chunk
        k[mode]["calls"] += calls
    profiles = {}
    for mode, run in runs.items():
        def three(run=run):
            for _ in range(3):
                run[2].append(run[0].tick(run[1])[1])
        wall, busy, _, _, n = _profiled_call(three)
        profiles[mode] = dict(host_ms=wall, busy_ms=busy, intervals=n)
    _held_equal("mesh tick graphs against eager mesh ticks", _stacked(runs["eager"][2]),
                _stacked(runs["graphs"][2]))
    state = _snapshot(es)
    _held_equal("mesh tick graphs against eager mesh ticks", _snapshot(runs["eager"][1]),
                state)
    losses, costs = (torch.stack([i[key] for i in runs["graphs"][2]]).cpu()
                     for key in ("loss", "ergodic_cost"))
    if not (torch.isfinite(losses).all() and torch.isfinite(costs).all()) \
            or es.learning_ind <= 0:
        raise RuntimeError(f"mesh tick: losses {losses}, costs {costs}")
    sync = _tick_builders()
    for build in (sync.untrained_tick, sync.trained_tick):
        _sync_free("mesh tick (one NCCL rank, production, replayed)", build(exp, es))
    ms = {m: float(np.median(v)) for m, v in turns.items()}
    p = profiles
    print(f"[mesh tick] production, one-rank NCCL mesh, K2 + K3: ms/tick in turns (medians "
          f"of {2 * rounds} chunks of {chunk} after {n_warm} warm), tick graphs "
          f"{ms['graphs']:.2f} {[round(v, 2) for v in turns['graphs']]}, eager "
          f"{ms['eager']:.2f} {[round(v, 2) for v in turns['eager']]} (the xyw tick of this "
          f"call: {xyw_ms:.2f}) | 3 profiled ticks, host ms / busy ms / intervals: "
          + "; ".join(f"{m} {p[m]['host_ms']:.2f} / {p[m]['busy_ms']:.2f} / "
                      f"{p[m]['intervals']}" for m in p)
          + f" | timed chunks, graphed: K1 {k['graphs']['K1']} in {k['graphs']['ticks']} "
          f"ticks, K2 {k['graphs']['K2']} and K3 {k['graphs']['K3']} in "
          f"{k['graphs']['calls']} trainer calls, through the replays, 0 eager; eager: K1 "
          f"{k['eager']['K1']}, K2 {k['eager']['K2']}, K3 {k['eager']['K3']} | "
          f"{_graph_note(exp)} | pool {_pool_mib(exp.tick_graph)} MiB | "
          f"{len(runs['graphs'][2])} ticks bit-equal to eager ticks, infos and {len(state)} "
          f"state leaves | learning_ind {es.learning_ind}")
    return dict(ms=ms, turns=turns, profile=profiles, k=k, k1=k["graphs"]["K1"],
                pool_mib=_pool_mib(exp.tick_graph))


def phase_dashboard(n_warm=6):
    """The dashboard's payload on a warm production Experiment: 2 K1
    launches and one device-to-host copy a payload, no host wait before the
    copy (enqueued behind a spin kernel, the device part returns before the
    spin ends), the frame's arrays finite and of the frame's shapes; device
    ms a payload by CUDA events, host ms with the copy. No render: the
    card's machine has no matplotlib."""
    import torch
    from ealv_tpu_torch.runtime import Experiment
    from ealv_tpu_torch.runtime.graphs import reset_launches, total_launches
    from ealv_tpu_torch.utils.config import ExperimentConfig
    from ealv_tpu_torch.utils.timing import device_ms, host_ms
    from ealv_tpu_torch.viz import LiveDashboard

    cfg = ExperimentConfig(**PRODUCTION)
    exp = Experiment(cfg, train_calls_per_tick=1, train_every=3, device="cuda")
    es = exp.init(seed=0)
    for _ in range(n_warm):
        es, _ = exp.tick(es)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dash_") as tmp:
        dash = LiveDashboard(exp, tmp)
        torch.cuda.synchronize()
        reset_launches()
        pl = dash.payload(es)
        counts = total_launches()
        launches = counts["footprint_and_spread"]
    _horizon_launches(counts, 0, "dashboard payload")
    n = 2 * cfg.s_dim  # (position, velocity) states
    shapes = {"image": cfg.image_dim, "img_pred": cfg.image_dim, "z_mu": (cfg.z_dim,),
              "p": (50, 50), "q": (50, 50), "path": (cfg.traj_buffer_capacity, n),
              "plan": (cfg.horizon + 1, n)}
    for k, shape in shapes.items():
        if pl[k].shape != tuple(shape) or not np.isfinite(pl[k]).all():
            raise RuntimeError(f"payload {k}: shape {pl[k].shape}, finite "
                               f"{np.isfinite(pl[k]).all()}")
    if launches != 2 or not (pl["p"] > 0).all() or pl["path_mask"].sum() < n_warm:
        raise RuntimeError(f"payload: {launches} K1 launches, p min {pl['p'].min()}, "
                           f"{pl['path_mask'].sum()} path points")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        dash.payload(es)
        torch.cuda.synchronize()
    on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = [e.name for e in on_card if "DtoH" in e.name]
    if len(copies) != 1:
        raise RuntimeError(f"payload: {len(copies)} device-to-host copies: {copies}")
    enqueue, spun = _behind_spin(lambda: dash.device_payload(es))
    if len(on_card) < 1000 and enqueue > 0.5 * spun:
        raise RuntimeError(f"payload: the host waited for the device before the copy "
                           f"({enqueue * 1e3:.1f} ms of {spun * 1e3:.1f} ms)")
    n_mem = cfg.traj_buffer_capacity
    d_ms = device_ms(lambda: dash.device_payload(es), reps=11, inner=1)
    h_ms = host_ms(lambda: dash.payload(es), inner=10)
    print(f"[dashboard] payload at production (50x50 grid, {n_mem}-point memory + "
          f"{cfg.horizon + 1}-point plan): K1 launches {launches} | device-to-host copies {len(copies)} | "
          f"{len(on_card)} device intervals | device {d_ms:.4f} ms by CUDA events | host "
          f"{h_ms:.4f} ms with the copy | enqueued behind a spin kernel in "
          f"{enqueue * 1e3:.2f} ms of {spun * 1e3:.1f} ms")
    return dict(launches=launches, device_ms=d_ms, host_ms=h_ms, intervals=len(on_card))


def phase_studies():
    """The demo and the study CLIs at short length on the card: the demo's
    chunks, the force study's contact-rich xyz run from a start in contact
    (contact in the ring and a finite reconstruction correlation required),
    the resume study at --small (bit-equal final checkpoints after a
    SIGKILL and --resume), the run entry with --profile (its trace names
    K1's kernel), and the browser panel answering GET /status and POST /cmd
    pause."""
    import torch
    import urllib.request
    from ealv_tpu_torch.runtime import demo
    from ealv_tpu_torch.runtime.panel import ControlHooks
    from ealv_tpu_torch.runtime.webpanel import WebPanel
    from ealv_tpu_torch.runtime.metrics import MetricsLog, run_dir
    from ealv_tpu_torch.scripts import force_study, resume_study
    from ealv_tpu_torch.scripts import run_experiment as cli

    t0 = time.perf_counter()
    dev = ["--device", "cuda"]
    es, rate = demo.main(["--steps", "6", "--chunk", "2", *dev])
    if es.explr_step != 6 or not rate or not es.buf.y.is_cuda:
        raise RuntimeError(f"demo: explr_step {es.explr_step}, rate {rate}")
    t_demo = time.perf_counter() - t0
    t0 = time.perf_counter()
    # from the top of the first object, 3 cm below it: contact from the first
    # step, so the ring holds pressed and free samples within a short run
    fs = force_study.main(["--steps", "24", "--eval-samples", "16", "--start", "0.42", "-0.06",
                           "0.35", *dev])
    if not fs["samples"] == fs["steps"] > 0 or not fs["contact"] > 0 or not np.isfinite(
            [fs["recon"]["corr"], fs["recon"]["mae"], fs["cross"]["mae"]]).all():
        raise RuntimeError(f"force study: {fs}")
    t_force = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_studies_") as tmp:
        t0 = time.perf_counter()
        leaves = resume_study.main(["--small", "--steps", "8", "--chunk", "2", "--save-rate",
                                    "4", "--out", os.path.join(tmp, "resume"), *dev])
        t_resume = time.perf_counter() - t0
        args = cli.build_parser().parse_args(["--small", "--steps", "4", "--chunk", "2",
                                              "--no-post-train", "--profile", "--out", tmp,
                                              *dev])
        dirp = run_dir(tmp, "synth", args.method, args.seed)
        cli.run(cli.make_experiment(cli.make_config(args), args), args, dirp,
                MetricsLog(dirp, echo=False))
        with open(os.path.join(dirp, "profile", "trace.json")) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        k1 = sorted(n for n in names if "footprint_kernel" in n)
        if not k1:
            raise RuntimeError("--profile: the trace names no footprint_kernel")
        log = open(os.path.join(dirp, "log.txt")).read()
        web = WebPanel(ControlHooks(), run_dir=tmp, port=0)
        web.start()
        try:
            url = f"http://127.0.0.1:{web.port}"
            with urllib.request.urlopen(url + "/status", timeout=10) as r:
                status = json.loads(r.read())
            with urllib.request.urlopen(urllib.request.Request(
                    url + "/cmd", data=b"pause"), timeout=10) as r:
                reply = r.read().decode()
        finally:
            web.stop()
    if status != {"paused": False, "manual": False, "save_pending": False} \
            or reply != "paused" or not web.hooks.pause_mgr.paused:
        raise RuntimeError(f"web panel: status {status}, reply {reply!r}")
    figures = [line for line in log.splitlines() if "figures" in line]
    print(f"[studies] demo 6 steps in {t_demo:.1f} s ({rate:.1f} steps/s after the first "
          f"chunk) | force study {fs['steps']} steps from a start in contact in "
          f"{t_force:.1f} s (contact in "
          f"{fs['contact']:.0%} of the ring): recon corr "
          f"{fs['recon']['corr']:.3f}, MAE {fs['recon']['mae']:.2f}; cross-decode corr "
          f"{fs['cross']['corr']:.3f} | resume study at --small: {leaves} leaves bit-equal "
          f"after SIGKILL + --resume ({t_resume:.1f} s) | --profile trace names {k1[:2]} | "
          f"web panel /status {status}, /cmd pause -> {reply!r} | run log: {figures}")
    return leaves


def phase_repro_planner(seeds=(0, 1), steps=30):
    """The port's ``repro planner`` table at a reduced length (``seeds`` x
    ``steps`` after one warm step a seed; the published spec otherwise:
    1500 x 1000 samples, horizon 10), 13 K1 launches a step; the port's
    rows finite. Prints the rows as one JSON line. Returns the launches."""
    from ealv_tpu_torch.runtime.graphs import reset_launches, total_launches
    from ealv_tpu_torch.scripts.repro import planner_study

    reset_launches()
    rows, _ = planner_study(seeds=seeds, steps=steps, device="cuda")
    counts = total_launches()
    launches = counts["footprint_and_spread"]
    want = 13 * len(seeds) * (steps + 1)
    if launches != want:
        raise RuntimeError(f"repro planner: {launches} K1 launches, expected {want}")
    # two planner set-ups a seed: the warm step's and the timed steps'
    _horizon_launches(counts, len(seeds) * (steps + 1), "repro planner", inits=2 * len(seeds))
    port = [dict(seed=seed, **m) for impl, seed, m in rows if impl == "port"]
    if len(port) != len(seeds) or not all(np.isfinite(list(r.values())).all() for r in port):
        raise RuntimeError(f"repro planner: rows {port}")
    print(f"[repro planner] {json.dumps(port)}")
    return launches


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
    sources = ("footprint.cu", "rollout.cu", "adam.cu", "wgrad.cu", "belief.cu")
    t0 = time.perf_counter()
    cuda_build.build(*sources)
    for source in sources:
        cuda_build.load(source)
    print(f"[build] {', '.join(sources)} built in parallel and loaded in "
          f"{time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    start = time.perf_counter()

    def stamp(what):  # the script's time by phase, against its time limit
        print(f"[time] {what} done at {time.perf_counter() - start:.1f} s")

    k1 = phase_kernels(dev)
    k2 = phase_adam(dev)
    k3 = phase_wgrad(dev)
    horizon = phase_rollout(dev)
    stamp("kernels")
    phase_agreement()
    phase_eval_agreement()
    fp_err = phase_fingerprint_agreement()
    arm_err = phase_arm_agreement()
    phase_planner_agreement()
    phase_trainer_agreement()
    stamp("agreement")
    phase_trainer_production()
    trainer_capture = phase_trainer_capture()
    stamp("trainer calls")
    k1_launches, xyw_ms, xyw_peak, xyw = phase_main_path("xyw", n_timed=24)
    stamp("xyw")
    with _NcclGroup():
        dp = phase_dp_trainer()
        mesh = phase_mesh_tick(xyw_ms)
    dp_worst = phase_dp_two_ranks()
    dash = phase_dashboard()
    stamp("data parallelism and dashboard")
    k1_6dof, rpw_ms, rpw_peak, rpw = phase_main_path("xyzrpw", n_timed=12)
    stamp("xyzrpw")
    var_ms, var_peak, (k1_var, k2_var, k3_var), var = phase_variant_path()
    stamp("variant")
    options = phase_model_options()
    stamp("model options")
    eval_ms, eval_per_plan = phase_eval_path()
    fp = phase_fingerprint_path()
    stamp("eval and fingerprint")
    k1_arm, arm_ms, arm_peak, step_vel, arm = phase_arm_path()
    stamp("arm")
    host = phase_host_loop_path()
    loop = phase_native_bridge()
    stamp("host loop and native bridge")
    print(f"[main paths] xyw {xyw_ms:.2f} ms/tick, peak {xyw_peak:.1f} MiB | xyzrpw "
          f"{rpw_ms:.2f} ms/tick, peak {rpw_peak:.1f} MiB ({rpw_ms / xyw_ms:.2f}x the time) | "
          f"xywb force z-ensemble {var_ms:.2f} ms/tick, peak {var_peak:.1f} MiB | eval "
          f"{eval_ms:.2f} ms/tick ({eval_per_plan:.0f} K1 launches a plan) | fingerprint "
          f"capture {fp['capture_ms']:.2f} and identification {fp['identify_ms']:.2f} ms/tick "
          f"(12 K1 launches a tick on both), peak {fp['peak']:.1f} MiB; toy card-vs-CPU "
          f"max|diff| {fp_err:.3e} | arm tick {arm_ms:.2f} ms, peak {arm_peak:.1f} MiB; "
          f"step_vel {step_vel['step_vel']['device_ms']:.4f} ms device, "
          f"{step_vel['step_vel']['intervals']} intervals "
          f"({step_vel['step_vel with the drift correction']['intervals']} with the drift "
          f"correction); "
          f"host loop {host['ms']['graphs']:.2f} ms/step graphed, {host['ms']['eager']:.2f} "
          f"eager; native loop {loop['rate_hz']:.1f} Hz; toy arm "
          f"card-vs-CPU max|diff| {arm_err:.3e}")
    paths = (("xyw", xyw), ("xyzrpw", rpw), ("xywb force z-ensemble K2 K3", var), ("arm", arm))
    print("[graphs] ms/tick, tick graphs / eager: " + "; ".join(
        f"{k} {r['ms']['ticks']:.2f} / {r['ms']['eager']:.2f}" for k, r in paths)
        + " | 3 profiled ticks, busy ms (host ms), tick graphs / eager: "
        + "; ".join(k + " " + " / ".join(
            f"{r['profile'][m]['busy_ms']:.2f} ({r['profile'][m]['host_ms']:.2f})"
            for m in ("ticks", "eager")) for k, r in paths)
        + " | tick graphs' pool MiB: " + "; ".join(f"{k} {r['pool_mib']}" for k, r in paths)
        + " | post-training call host ms / busy ms, captured (eager): " + "; ".join(
            f"kernels {'on' if on else 'off'} {r['captured']['host_ms']:.2f} / "
            f"{r['captured']['busy_ms']:.2f} ({r['eager']['host_ms']:.2f} / "
            f"{r['eager']['busy_ms']:.2f}), capture {r['capture_s']:.3f} s, pool "
            f"{r['pool_mib']} MiB" for on, r in trainer_capture.items()))
    _, k2_launches, k3_launches, _ = phase_learning_path()
    stamp("learning path")
    resume_leaves = phase_studies()
    stamp("studies")
    k1_repro = phase_repro_planner()
    stamp("repro planner")
    cap = dp["captured"][True]
    print(f"[parallel and dashboard] data-parallel call {dp['host_ms']:.2f} ms host, "
          f"{dp['busy_ms']:.2f} ms busy vs plain {dp['plain_host_ms']:.2f} / "
          f"{dp['plain_busy_ms']:.2f}; captured (K2 + K3) {cap['host_ms']['captured']:.2f} / "
          f"{cap['busy_ms']['captured']:.2f} vs eager {cap['host_ms']['eager']:.2f} / "
          f"{cap['busy_ms']['eager']:.2f} | two-rank gradients max rel diff {dp_worst:.2e} | "
          f"mesh tick {mesh['ms']['graphs']:.2f} ms graphed, {mesh['ms']['eager']:.2f} eager, "
          f"vs xyw {xyw_ms:.2f} | host-loop step {host['ms']['graphs']:.2f} ms graphed, "
          f"{host['ms']['eager']:.2f} eager | payload {dash['device_ms']:.4f} ms "
          f"device, {dash['host_ms']:.4f} ms host | resume study {resume_leaves} leaves "
          f"bit-equal")
    print(json.dumps({"kernels": [
        {"name": "footprint_and_spread", "route": "cuda",
         "source": "ealv_tpu_torch/csrc/footprint.cu",
         "replaces": "ealv_tpu/ops/pallas_kernels.py:55",
         "launches": k1_launches, "launches_xyzrpw": k1_6dof, "launches_variant": k1_var,
         "launches_eval_per_plan": eval_per_plan,
         "launches_capture_per_tick": fp["capture_per_tick"],
         "launches_identify_per_tick": fp["identify_per_tick"],
         "launches_find_clusters": fp["find_clusters"],
         "launches_entropy_slices": fp["entropy_slices"], "launches_arm": k1_arm,
         "launches_host_loop": host["k1"]["graphs"][0], "launches_mesh_tick": mesh["k1"],
         "launches_model_options": {k: r["k1"] for k, r in options.items()},
         "launches_dashboard_payload": dash["launches"],
         "launches_repro_planner": k1_repro, **k1},
        {"name": "adam_apply", "route": "cuda",
         "source": "ealv_tpu_torch/csrc/adam.cu",
         "replaces": "ealv_tpu/ops/pallas_adam.py:55",
         "launches": k2_launches, "launches_variant": k2_var,
         "launches_dp_call": dp["k2"], **k2},
        {"name": "conv_wgrad_direct", "route": "cuda",
         "source": "ealv_tpu_torch/csrc/wgrad.cu",
         "replaces": "ealv_tpu/ops/pallas_wgrad.py:115",
         "launches": k3_launches, "launches_variant": k3_var,
         "launches_model_options": {k: r["k3"] for k, r in options.items()},
         "launches_dp_call": dp["k3"], **k3},
        {"name": "horizon_rollout", "route": "cuda",
         "source": "ealv_tpu_torch/csrc/rollout.cu",
         "replaces": "ealv_tpu/control/klerg.py:168",
         **_horizon_record("horizon_rollout"), **horizon["horizon_rollout"]},
        {"name": "costate_sweep", "route": "cuda",
         "source": "ealv_tpu_torch/csrc/rollout.cu",
         "replaces": "ealv_tpu/control/klerg.py:226",
         **_horizon_record("costate_sweep"), **horizon["costate_sweep"]},
        {"name": "fuse_beliefs", "route": "cuda", "source": "ealv_tpu_torch/csrc/belief.cu",
         "replaces": None, **fp["fusion"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
