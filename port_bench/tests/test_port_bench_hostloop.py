"""The host-loop cell ``arm.hostloop`` on the CPU at a toy size: the
reference arm (``reference/arm.py``) against the port's ``sim/arm.py`` on
seeded joint states, a sound run that reads correct, the controls and the
planted fault that its limits catch, and the cell's three readers on a
hand-made record. The data-only cell ``xyw.inline`` is found and runs."""

import importlib
import math

import numpy as np
import pytest
import torch

from port_bench import harness
from port_bench.reference import arm as ref_arm
from port_bench.reference.renderer import TrayScene as RefScene
from port_bench.reference.tick import TRAY6
from port_bench.tests.toy import toy_mix

SEED = 3_100_000_007


SECONDS = 600.0  # more than a toy window takes: its steps (num_steps) end it


def _toy():
    """The cell at a toy size, its compared steps drawn among the window's
    first eight of each kind (a drift-correction step among the first two,
    by the window's 40th step); the window ends by its steps, about 45."""
    files = toy_mix("arm.hostloop")
    files["traffic"]["compare"]["within"] = 8
    files["config"]["num_steps"] = 52
    return files


def _correct(files, r) -> bool:
    return all(r["gaps"].get(k, float("inf")) <= lim for k, lim in files["limits"].items())


@pytest.fixture(scope="module")
def sound():
    """A toy run with the fp8 and stuck controls beside the program."""
    files = _toy()
    return files, harness.measure(files, SEED, SECONDS, False, device="cpu",
                                  controls=("fp8", "stuck"))


def _arms():
    from ealv_tpu_torch.sim.arm import ArmEnv
    prog = ArmEnv(tray_lim=TRAY6, dt=0.04, img_hw=(24, 24), dynamic_contact=True,
                  device="cpu")
    return prog, ref_arm.ArmEnv(tray_lim=TRAY6, dt=0.04, img_hw=(24, 24), device="cpu")


def _joint_states(n=4, seed=5):
    rng = np.random.default_rng(seed)
    lo, hi = ref_arm.Q_MIN, ref_arm.Q_MAX
    return [torch.tensor(rng.uniform(lo + 0.2 * (hi - lo), hi - 0.2 * (hi - lo)),
                         dtype=torch.float32) for _ in range(n)]


def test_the_reference_arm_is_the_ports_bit_for_bit():
    """fk, the Jacobian, the DLS step, the IK, the contact force and guard,
    a velocity command with and without the drift correction, and the
    observation, on seeded joint states and twists."""
    from ealv_tpu_torch.sim import arm as prog_arm
    from ealv_tpu_torch.sim.renderer import TrayScene
    prog_env, ref_env = _arms()
    rng = np.random.default_rng(7)
    for q in _joint_states():
        for a, b in zip(prog_arm.fk(q), ref_arm.fk(q)):
            assert torch.equal(a, b)
        J = prog_arm.geometric_jacobian(q)
        assert torch.equal(J, ref_arm.geometric_jacobian(q))
        twist = torch.tensor(rng.normal(0, 0.1, 6), dtype=torch.float32)
        assert torch.equal(prog_arm._dls_solve(J, twist), ref_arm.dls_step(J, twist))
        pose = prog_env._ee_pose(q)
        assert torch.equal(pose, ref_env.ee_pose(q))
        target = pose + torch.tensor(rng.normal(0, 0.02, 6), dtype=torch.float32)
        assert torch.equal(prog_arm.solve_ik(q, target, 20), ref_arm.solve_ik(q, target, 20))
    start = torch.tensor([(lo + hi) / 2 for lo, hi in TRAY6])
    # a wide cylinder under the start pose, its top just above it: pressing
    # down, the contact force rises past the guard's threshold
    wide = dict(obj_xy=torch.tensor([[0.475, 0.0], [0.95, 0.95]]),
                obj_radius=torch.tensor([0.08, 0.01]), obj_height=torch.tensor([0.36, 0.01]))
    s_prog = prog_env.init(start, scene=TrayScene.default("cpu")._replace(**wide))
    s_ref = ref_env.init(start, scene=RefScene.default("cpu")._replace(**wide))
    assert torch.equal(s_prog.q, s_ref.q)
    for count in (0, 18, 19):  # the third command is the 20th: the drift correction runs
        s_prog.count = s_ref.count = count
        # down into the tray's objects and the table: the contact force and guard act
        cmd = torch.tensor([rng.normal(0, 0.05), rng.normal(0, 0.05), -0.4, 0.0, 0.0,
                            rng.normal(0, 0.1)], dtype=torch.float32)
        for _ in range(3):
            s_prog, s_ref = prog_env.step_vel(s_prog, cmd), ref_env.step_vel(s_ref, cmd)
        for name in ("q", "qdot", "pose", "vel", "brightness"):
            assert torch.equal(getattr(s_prog, name), getattr(s_ref, name)), (count, name)
        assert s_prog.count == s_ref.count
        prog_obs, ref_obs = prog_env.observe(s_prog), ref_env.observe(s_ref)
        for a, b in zip(prog_obs, ref_obs):
            assert torch.equal(a, b), count
    # the guard acts
    assert float(torch.linalg.vector_norm(ref_obs[2])) > 0.75 * ref_env.max_force
    skipped = ref_arm.ArmEnv(tray_lim=TRAY6, dt=0.04, img_hw=(24, 24), device="cpu",
                             drift_every=0)
    s = ref_env.init(start)
    s.count = ref_arm.DRIFT_EVERY - 1
    assert not torch.equal(ref_env.step_vel(s, cmd).q, skipped.step_vel(s, cmd).q)


def test_a_sound_run_is_correct(sound):
    files, r = sound
    assert _correct(files, r), r["gaps"]
    assert r["gaps"]["joints"] == 0.0 and r["gaps"]["state"] == 0.0
    assert len(r["per_tick"]) == files["traffic"]["compare"]["ticks"]


@pytest.mark.parametrize("control,caught_by", [("fp8", ("image", "latent_median")),
                                               ("stuck", ("state", "joints", "image", "cost"))])
def test_each_control_reads_above_a_named_limit(sound, control, caught_by):
    files, r = sound
    gaps = r["controls"][control]
    assert all(gaps[k] > files["limits"][k] for k in caught_by), gaps


def test_a_skipped_drift_correction_is_caught(monkeypatch):
    """The program's arm skips the drift correction's IK: the compared
    drift-correction step reads its joints above the limit."""
    from ealv_tpu_torch.sim import arm

    real = arm.solve_ik
    monkeypatch.setattr(arm, "solve_ik", lambda q0, pose6, iters=50:
                        q0 if iters == ref_arm.DRIFT_IK_ITERS else real(q0, pose6, iters))
    files = _toy()
    r = harness.measure(files, SEED, SECONDS, False, device="cpu")
    assert r["gaps"]["joints"] > files["limits"]["joints"] and not _correct(files, r)


def test_the_three_readers_on_a_hand_made_record():
    read = lambda name, run: importlib.import_module(f"port_bench.metrics.{name}").read(run)
    spans = {"ticks": 40, "device_ms": {"arm": 0.31, "tick": 2.5},
             "host_self_ms": {"watchdog": 0.04, "tick": 0.2}, "counts": {"prime": 2}}
    assert read("arm_ms", {"spans": spans}) == pytest.approx(0.31)
    assert read("watchdog_ms", {"spans": spans}) == pytest.approx(0.04)
    assert read("prime_pct", {"spans": spans}) == pytest.approx(5.0)
    assert read("prime_pct", {"spans": dict(spans, counts={})}) == 0.0
    # a program without the spans or the counters: nothing to read, no error
    bare = dict(spans, device_ms={}, host_self_ms={})
    bare.pop("counts")
    for name in ("arm_ms", "watchdog_ms", "prime_pct"):
        assert read(name, {"spans": bare}) is None
        assert read(name, {"spans": None}) is None


def test_the_inline_cell_trains_every_tick_and_reads_correct():
    files = harness.cell_files("xyw.inline")
    assert files["traffic"]["train_every"] == 1 and files["limits"] == harness.load_json(
        harness.ROOT / "limits" / "xyw.learn.json")
    inline = files
    files = toy_mix("xyw.learn")
    files["traffic"] = dict(inline["traffic"], chunk=5, settle=2,
                            compare=dict(inline["traffic"]["compare"], within=40))
    r = harness.measure(files, SEED, 0.5, False, device="cpu")
    assert _correct(files, r), r["gaps"]
    assert sum(r["trained"]) >= r["ticks"] - 1 and "params_worst" in r["gaps"]
    assert math.isfinite(r["gaps"]["loss"])
