"""The identification runtime one tick at a time
(``FingerprintMatrixRuntime.init`` and ``tick``, ``fingerprint/test_runtime.py``):
each tick against the benchmark's plain-torch copy of the identification
(``port_bench/reference/identify.py``) at a toy size, ``run`` against its
own ticks, and the tracer's spans of a tick.

This file imports neither JAX nor the JAX package:

    python -m pytest -p no:cacheprovider tests/test_torch_fp_identify_tick.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from ealv_tpu_torch.fingerprint import test_runtime as trt
from ealv_tpu_torch.fingerprint.belief import FingerprintBelief
from ealv_tpu_torch.fingerprint.identify import FingerprintSet, calibrate_thresholds
from ealv_tpu_torch.models import CVAE
from ealv_tpu_torch.runtime import EvalExperiment
from ealv_tpu_torch.runtime import graphs as tg
from ealv_tpu_torch.runtime import tracing
from ealv_tpu_torch.sim.renderer import TrayScene
from port_bench import drive
from port_bench.reference import identify as ref
from port_bench.reference.tick import Tick

TOY = dict(states="xyw", image_dim=[24, 24, 3], cnn_kernels=[3, 3], cnn_strides=[2, 2],
           cnn_channels=[8, 8], hidden_dim=[64, 32], z_dim=8, num_target_samples=64,
           num_traj_samples=50, traj_buffer_capacity=128, compute_dtype="float32")
COMBOS = (("L2", False), ("KL", False), ("BC", False), ("L2", True))
K, SEED, ADOPT = 3, 2_400_000_019, 2
IDENT = dict(objects=K, grid=10, ring=8, combos=[list(c) for c in COMBOS], seek_combo=0,
             seek_fingerprint=1, sharpness=20.0, adopt_step=ADOPT, update_every=1)


@pytest.fixture(autouse=True)
def one_thread_tracer_off():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.disable()
    yield
    tracing.disable()
    torch.set_num_threads(threads)


def _fingerprints(model, cfg, rng):
    """K fingerprints of 5, 6 and 7 seeds (padded to 7): poses about a
    centre, each latent the CVAE's encode of a random image there, so the
    distances are the CVAE's own."""
    dicts = []
    for s in (5, 6, 7):
        center = rng.uniform(-0.5, 0.5, 3).astype(np.float32)
        x = (center + rng.normal(0, 0.05, (s, 3))).astype(np.float32)
        y = torch.tensor(rng.uniform(0, 1, (s, *cfg.image_dim)), dtype=torch.float32)
        with torch.no_grad():
            out = model(torch.tensor(x), y, train=False)
        dicts.append(dict(z_mu=out["z_mu"].numpy(), z_var=out["z_logvar"].numpy(), x=x,
                          center=center, center_img=np.zeros(cfg.image_dim, np.float32)))
    return FingerprintSet.from_lists(dicts, device="cpu")


def _runtime(seek_mode: str):
    """A toy runtime of the four combinations over a 10-point grid and an
    8-slot ring, on the CPU, its model at the seed's weights."""
    cfg = drive.program_config(TOY)
    model = CVAE(img_dim=cfg.image_dim, z_dim=cfg.z_dim, s_dim=cfg.s_dim,
                 hidden_dim=cfg.model_hidden(), cnn_kernels=cfg.cnn_kernels,
                 cnn_strides=cfg.cnn_strides, cnn_channels=cfg.cnn_channels)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    fps = _fingerprints(model, cfg, np.random.default_rng(5))
    beliefs = {}
    for m, e in COMBOS:
        th, cl = calibrate_thresholds(fps, m)
        beliefs[trt.FingerprintMatrixRuntime.combo_key(m, e)] = [
            FingerprintBelief.create(cfg.states, cfg.robot_lim, num_samples=10, meas_capacity=8,
                                     thresh=th, clip=cl, device="cpu") for _ in range(K)]
    return trt.FingerprintMatrixRuntime(
        cfg, model, fps, combos=COMBOS, seek_fingerprint=1, seek_mode=seek_mode,
        update_tdist_step=ADOPT, scene=TrayScene.make(K, seed=SEED, device="cpu"),
        beliefs=beliefs, device="cpu")


def _snapshot(state) -> dict:
    st = dict(**drive.planner_snapshot(state.ev.pstate), **drive.env_snapshot(state.ev.env),
              step=state.ev.step)
    for f in ref.BELIEF_STATE:
        st[f] = torch.stack([torch.stack([getattr(b, f) for b in bs]) for bs in state.beliefs])
    return st


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("seek_mode", ["fixed", "uncertain"])
def test_each_tick_agrees_with_the_plain_reference(seek_mode):
    """Five ticks, two before adoption and three after, each recomputed by
    the reference from the state before it (the env stepped with the
    program's plan, as the benchmark does). Both run the same float32 ops
    on the CPU, so what differs is the order of a few sums: the reference
    fuses over the ring's pending slots alone where the program sums all
    eight with zeros in the empty ones (the beliefs, a relative 1e-6, a
    few float32 steps), and the planner's footprint is taken in K1's
    arithmetic there (the cost, a relative 1e-5, as the benchmark's eval
    cells allow). The forward, the distances, the seek, the env step and
    the image are the same ops in the same order: bit for bit."""
    rt = _runtime(seek_mode)
    tick = Tick(drive.reference_config(TOY), "cpu", learning=False)
    tgt = ref.target(tick, SEED, {k: getattr(rt.fps, k) for k in
                                  ("z_mu", "z_logvar", "x", "center", "mask")},
                     dict(IDENT, seek_mode=seek_mode))
    state = rt.init(seed=7)
    seen = set()
    for i in range(5):
        snap = _snapshot(state)
        state, out = rt.tick(state)
        want = ref.identify_tick(tick, tgt, snap, state.ev.pstate.u)
        what = f"{seek_mode} tick {i}"
        assert int(out["seek_k"]) == want["seek_k"], what
        seen.add(int(out["seek_k"]))
        assert _rel(out["cost"], want["cost"]) <= 1e-5, what
        assert torch.equal(out["image"], want["image"]), what
        assert torch.equal(out["robot_state"], want["robot_state"]), what
        assert torch.equal(out["dists"], want["dists"]), what
        for c, bs in enumerate(state.beliefs):
            for k, b in enumerate(bs):
                assert _rel(b.prior, want["prior"][c, k]) <= 1e-6, (what, c, k)
                assert _rel(b.prior_var, want["prior_var"][c, k]) <= 1e-6, (what, c, k)
                assert b.prior.shape == (1000,) and int(b.meas_n) == 0
    if seek_mode == "fixed":
        assert seen == {1}
    # every belief has moved off its uniform start
    assert all(float(b.prior.std()) > 0 for bs in state.beliefs for b in bs)


def _history(rt, n: int, ticks: bool):
    """(each tick's outputs, the last beliefs) of ``n`` ticks, by ``run`` or
    by ``init`` and ``tick``."""
    if not ticks:
        beliefs, history = rt.run(n, seed=4)
        return [{k: torch.as_tensor(v) for k, v in h.items() if k != "step"}
                for h in history], beliefs
    state = rt.init(seed=4)
    keys = [rt.combo_key(m, e) for m, e in rt.combos]
    rows = []
    for _ in range(n):
        state, out = rt.tick(state)
        row = {"robot_state": out["robot_state"], "seek_k": out["seek_k"]}
        row.update({key: out["dists"][c] for c, key in enumerate(keys)})
        rows.append(row)
    return rows, dict(zip(keys, state.beliefs))


@pytest.mark.parametrize("staged", [False, True], ids=["eager", "staged"])
def test_run_equals_its_ticks(staged):
    """``run(n)`` and ``n`` calls of ``tick`` from ``init`` of the same seed
    give the same history and beliefs bit for bit, eagerly and through the
    step graph (``EagerGraph``, which replays by running the body again)."""
    rts = [_runtime("uncertain") for _ in range(2)]
    if staged:
        for rt in rts:
            rt._ev.tick_graph = tg.StepGraph(tg.EagerGraph)
    (h_run, b_run), (h_tick, b_tick) = _history(rts[0], 5, False), _history(rts[1], 5, True)
    assert len(h_run) == len(h_tick) == 5
    for a, b in zip(h_run, h_tick):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k].float(), b[k].float()), k
    for key in b_run:
        for x, y in zip(b_run[key], b_tick[key]):
            for f in dataclasses.fields(x):
                v, w = getattr(x, f.name), getattr(y, f.name)
                assert torch.equal(v, w) if torch.is_tensor(v) else v == w, (key, f.name)


def test_a_traced_tick_nests_seek_match_and_fuse_in_its_tick():
    """With the tracer on, each identification tick records the host span
    ``tick`` and the device span ``tick`` over ``seek``, the eval tick's
    ``decode``, ``descent`` and ``env``, then ``match`` and ``fuse``, in
    that order: 14 stamps. An eval tick keeps its 8 (``tick`` over
    ``decode``, ``descent`` and ``env``)."""
    tracing.enable("cpu")
    rt = _runtime("uncertain")
    rt._ev.tick_graph = tg.StepGraph(tg.EagerGraph)
    state = rt.init(seed=4)
    for _ in range(4):
        state, _ = rt.tick(state)
    tr = tracing.read()
    assert tr.ticks == range(4)
    assert len(tracing._tracer.points) == 14
    for t in range(4):
        host = [s for s in tr.host if s.tick == t and s.name == "tick"]
        device = [(i, s) for i, s in enumerate(tr.device) if s.tick == t]
        (top, dtick), = [(i, s) for i, s in device if s.name == "tick"]
        assert len(host) == 1 and host[0].start_ns <= dtick.start_ns <= dtick.end_ns \
            <= host[0].end_ns
        under = [s for i, s in device if s.parent == top]
        assert [s.name for s in under] == ["seek", "decode", "descent", "env", "match",
                                           "fuse"]
        assert all(a.end_ns <= b.start_ns for a, b in zip(under, under[1:]))
    tracing.disable()

    tracing.enable("cpu")
    cfg = drive.program_config(TOY)
    ev_exp = EvalExperiment(cfg, pdf_fn=lambda ctx, s: ctx.pdf(s), device="cpu")
    belief = FingerprintBelief.create(cfg.states, cfg.robot_lim, num_samples=10,
                                      meas_capacity=8, device="cpu")
    ev = ev_exp.init(seed=0)
    for _ in range(2):
        ev, _ = ev_exp.tick(ev, belief)
    tr = tracing.read()
    assert len(tracing._tracer.points) == 8
    for t in range(2):
        device = [(i, s) for i, s in enumerate(tr.device) if s.tick == t]
        (top, _), = [(i, s) for i, s in device if s.name == "tick"]
        assert [s.name for i, s in device if s.parent == top] == ["decode", "descent", "env"]
