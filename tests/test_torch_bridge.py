"""The port's bridges (``ealv_tpu_torch/hw/``) against the JAX package's on
the same command sequences: ``SyntheticBridge`` over the free env and the
dynamic-contact arm (service surface, packed observation, the
device-resident command-and-observe, the fast-path gate, pause gating),
``StampedCache``, ``NativeBridge`` over the two builds of the controller
library (the mux's 1 kHz outputs, stamp alignment, stale frames, the
degraded-rate rejection, pose commands, the brightness node), the C++
loop run briefly, the library's build directory, and ``RosBridgeServer``
with the injected ROS stand-ins of ``tests/test_host_loop.py``.

Tolerances: poses, twists and forces 2e-5 (f32 simulators; the arm's
damped solves round differently), images 2e-5; the controller outputs are
the same C++ code and compared exactly.
"""

import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealv_tpu.hw import bridge as jb
from ealv_tpu.hw.peripherals import BrightnessNode as JNode
from ealv_tpu.sim import SyntheticEnv as JEnv
from ealv_tpu.sim.arm import ArmEnv as JArm
from ealv_tpu.utils.config import TRAY_LIM
from ealv_tpu_torch.hw import bridge as tb, native as tn
from ealv_tpu_torch.hw.peripherals import BrightnessNode
from ealv_tpu_torch.sim import SyntheticEnv
from ealv_tpu_torch.sim.arm import ArmEnv
from ealv_tpu_torch.utils.convert import arm_state_from_jax
from test_host_loop import _Attr, _FakeGeom, _FakeRos, _FakeSrv
from test_torch_trainer import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAY6 = tuple(TRAY_LIM[s] for s in "xyzrpw")
START = [0.45, 0.0, 0.3, 3.14, 0.0, 0.0]


def bridges(kind):
    """(JAX bridge, port bridge) over the same env state."""
    if kind == "free":
        je = JEnv(tray_lim=TRAY6, dt=0.04, img_hw=(24, 24))
        te = SyntheticEnv(tray_lim=TRAY6, dt=0.04, img_hw=(24, 24), device="cpu")
        return (jb.SyntheticBridge(je, je.init(jnp.asarray(START))),
                tb.SyntheticBridge(te, te.init(torch.tensor(START))))
    je = JArm(tray_lim=TRAY6, dt=0.04, img_hw=(24, 24), dynamic_contact=True)
    te = ArmEnv(tray_lim=TRAY6, dt=0.04, img_hw=(24, 24), dynamic_contact=True, device="cpu")
    js = je.init(jnp.asarray([0.42, -0.06, 0.21, np.pi, 0, 0], jnp.float32))
    return jb.SyntheticBridge(je, js), tb.SyntheticBridge(te, arm_state_from_jax(js, "cpu"))


def close_obs(got, want, what):
    for g, w, name in zip(got, want, ("pose", "vel", "force", "image")):
        assert np.asarray(g).shape == np.asarray(w).shape, name
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5, err_msg=f"{what} {name}")


@pytest.mark.parametrize("kind", ["free", "arm-dynamic"])
def test_synthetic_bridge_matches_jax(kind):
    """Velocity commands with and without brightness, a pose command, the
    packed observation (force (3,) on the dynamic arm), the start pose and
    the observed-back brightness; a paused bridge refuses commands."""
    bj, bt = bridges(kind)
    assert bt._force_size == bj._force_size == (3 if kind != "free" else 1)
    assert bt._img_shape == bj._img_shape
    close_obs(bt.observe(), bj.observe(), "start")
    rng = np.random.default_rng(0)
    for k in range(6):
        twist = rng.uniform(-0.1, 0.1, 6).astype(np.float32)
        b = 0.3 if k == 2 else -1.0
        assert bt.klerg_cmd(twist, b) and bj.klerg_cmd(twist, b)
        close_obs(bt.observe(), bj.observe(), f"cmd {k}")
        assert bt.last_brightness == pytest.approx(bj.last_brightness, abs=1e-6)
    target = np.array([0.5, 0.05, 0.32, 3.1, 0.0, 0.2], np.float32)
    assert bt.klerg_pose(target) and bj.klerg_pose(target)
    np.testing.assert_allclose(bt.klerg_start_pose(), bj.klerg_start_pose(), atol=2e-5)
    bt.pause.pause()
    bj.pause.pause()
    assert not bt.klerg_cmd(np.zeros(6)) and not bj.klerg_cmd(np.zeros(6))
    assert not bt.klerg_pose(target) and bt.cmd_observe_device(np.zeros(7)) is None


@pytest.mark.parametrize("kind", ["free", "arm-dynamic"])
def test_cmd_observe_device_matches_jax(kind):
    """The device-resident command-and-observe: the packed observation and
    its watchdog prefix, from a host or a device command, with brightness
    kept (-1) or set."""
    bj, bt = bridges(kind)
    for cmd in ([0.05, 0, 0, 0, 0, 0.2, -1.0], [0, -0.04, 0.01, 0, 0, 0, 0.6]):
        cmd = np.asarray(cmd, np.float32)
        fj, sj = bj.cmd_observe_device(cmd)
        ft, st = bt.cmd_observe_device(torch.tensor(cmd))
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=2e-5, atol=2e-5)
        assert st.numpy().shape == (13 + bt._force_size,)


def test_device_fast_path_gate():
    """Overriding klerg_cmd or observe, in a subclass or on the instance,
    closes the device-resident path, as in the reference."""
    bj, bt = bridges("free")

    class Sub(tb.SyntheticBridge):
        def observe(self):
            return super().observe()

    assert bt.device_fast_path_ok() and bj.device_fast_path_ok()
    assert not Sub(bt.env, bt.state).device_fast_path_ok()
    bt.klerg_cmd = lambda *a, **k: True
    bj.klerg_cmd = lambda *a, **k: True
    assert not bt.device_fast_path_ok() and not bj.device_fast_path_ok()


def test_stamped_cache_matches_jax():
    cj, ct = jb.StampedCache(maxlen=8), tb.StampedCache(maxlen=8)
    assert ct.latest() == cj.latest() == (None, None)
    assert ct.closest(1.0) == cj.closest(1.0) == (None, None)
    for i, t in enumerate([0.0, 0.1, 0.25, 0.3, 0.55, 0.6, 0.61, 0.9, 1.2, 1.25]):
        cj.push(t, i)
        ct.push(t, i)
    assert ct.stamps() == cj.stamps() and len(ct.stamps()) == 8
    for q in (0.0, 0.31, 0.58, 0.95, 5.0):
        assert ct.closest(q) == cj.closest(q)
    assert ct.latest() == cj.latest()


class FakeDriver:
    """An integrator plant with the pose interface."""

    def __init__(self):
        self.pose = np.zeros(6)
        self.vel = np.zeros(6)
        self.poses = []

    def state(self):
        return self.pose.copy(), self.vel.copy(), np.array([0.0, 0.0, 2.0, 0, 0, 0])

    def apply_velocity(self, twist):
        self.vel = np.asarray(twist)
        self.pose = self.pose + self.vel * 1e-3

    def apply_pose(self, m):
        self.poses.append(np.asarray(m).copy())

    def pose_matrix(self):
        return np.eye(4).reshape(16)

    def pose_to_matrix(self, pose6):
        m = np.eye(4)
        m[:3, 3] = pose6[:3]
        return m.reshape(16)


def native_pair(**kw):
    clock = {"t": 0.0}
    pair = [mod.NativeBridge(driver=FakeDriver(), clock=lambda: clock["t"], **kw)
            for mod in (jb, tb)]
    return pair, clock


def test_native_bridge_mux_matches_jax():
    """The same commands through both builds of the controller library:
    the velocity ramp's 1 kHz outputs, the pose filter's, mode switches,
    and the reset to velocity mode."""
    (bj, bt), _ = native_pair()
    rng = np.random.default_rng(2)
    for k in range(4):
        twist = rng.uniform(-0.3, 0.3, 6)
        assert bt.klerg_cmd(twist) == bj.klerg_cmd(twist) is True
        for w in (np.zeros(6), np.array([0, 0, 35.0, 0, 0, 0])):  # over max_force
            bj.mux.set_wrench(w)
            bt.mux.set_wrench(w)
            for _ in range(25):
                np.testing.assert_array_equal(bt.mux.tick_velocity(), bj.mux.tick_velocity())
    assert bt.klerg_pose(np.array([0.4, 0.1, 0.3, 0, 0, 0])) and bj.klerg_pose(
        np.array([0.4, 0.1, 0.3, 0, 0, 0]))
    assert bt.mux.mode == bj.mux.mode == tn.ControlMode.POSE
    cur = np.eye(4).reshape(16)
    for _ in range(20):
        np.testing.assert_array_equal(bt.mux.tick_pose(cur), bj.mux.tick_pose(cur))
    bt.switch_controller("vel")
    bj.switch_controller("vel")
    assert bt.mux.mode == bj.mux.mode == tn.ControlMode.VELOCITY
    bt.switch_controller("pose")
    bt.reset()
    assert bt.mux.mode == tn.ControlMode.VELOCITY


def test_native_bridge_stamps_and_stale_frames_match_jax():
    """observe() takes the state sample closest to the camera's stamp; a
    frame older than max_img_age raises; no camera gives no image."""
    (bj, bt), clock = native_pair()
    for br in (bj, bt):
        for t in (100.0, 100.1, 100.2, 100.3, 100.4, 100.5):
            br._state_cache.push(t, (np.full(6, t), np.zeros(6), np.array([3.0, 4, 0, 0, 0, 0])))
        br.camera = lambda: (np.zeros((4, 4, 3)), 100.32)
    clock["t"] = 100.55
    oj, ot = bj.observe(), bt.observe()
    for a, b in zip(ot, oj):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ot[0], np.full(6, 100.3))
    assert ot[2].tolist() == [5.0]
    clock["t"] = 101.5
    for br, err in ((bj, jb.StaleObservationError), (bt, tb.StaleObservationError)):
        with pytest.raises(err):
            br.observe()
        br.camera = None
    assert bt.observe()[3] is None
    for a, b in zip(bt.state_latest(), bj.state_latest()):
        np.testing.assert_array_equal(a, b)


def test_native_bridge_degraded_rate_matches_jax():
    """A loop at a tenth of its rate fails commands (and resets the ramp);
    a recovered one accepts them again and ramps from zero."""
    (bj, bt), _ = native_pair()
    outs = []
    for br in (bj, bt):
        state = (np.zeros(6), np.zeros(6), np.zeros(6))
        for i in range(64):
            br._state_cache.push(i * br.dt, state)
        seq = [br.success_rate(), br.klerg_cmd([0.5, 0, 0, 0, 0, 0])]
        seq += [br.mux.tick_velocity()[0] for _ in range(40)]
        for i in range(64):
            br._state_cache.push(1.0 + i * 10 * br.dt, state)
        seq += [br.success_rate(), br.klerg_cmd([0.5, 0, 0, 0, 0, 0])]
        for i in range(64):
            br._state_cache.push(1000.0 + i * br.dt, state)
        seq += [br.klerg_cmd([0.5, 0, 0, 0, 0, 0]), br.mux.tick_velocity()[0]]
        outs.append(seq)
    assert outs[0] == outs[1]
    assert outs[1][1] is True and outs[1][-3] is False and outs[1][-2] is True
    assert outs[1][-1] < 0.5 * outs[1][41]


def test_native_bridge_pose_needs_the_pose_interface():
    class VelOnly:
        def state(self):
            return np.zeros(6), np.zeros(6), np.zeros(6)

        def apply_velocity(self, twist):
            pass

    br = tb.NativeBridge(driver=VelOnly(), clock=lambda: 0.0)
    assert br.klerg_cmd(np.zeros(6)) and not br.klerg_pose(np.zeros(6))
    br.pause.pause()
    assert not br.klerg_cmd(np.zeros(6))


def test_native_bridge_applies_brightness_like_jax():
    values = []
    for mod, node_cls in ((jb, JNode), (tb, BrightnessNode)):
        class Cam:
            def set(self, b):
                values.append((mod.__name__, b))

        node = node_cls(Cam(), clock=lambda: 0.0)
        br = mod.NativeBridge(driver=FakeDriver(), clock=lambda: 0.0, brightness_node=node)
        br.klerg_cmd(np.zeros(6), brightness=0.9)
        br.klerg_cmd(np.zeros(6), brightness=-1.0)  # unchanged
        assert node.current == 0.9
    assert [b for _, b in values[:2]] == [b for _, b in values[2:]] == [0.5, 0.9]


def test_native_loop_runs_the_driver():
    """The C++ loop (default clock) ticks the mux against a Python driver
    for a fifth of a second; its stats and the live ring come back. No
    rate or jitter bound: that is a wall-clock property of the machine."""
    drv = FakeDriver()
    br = tb.NativeBridge(driver=drv)
    br.start()
    try:
        for _ in range(20):
            br.klerg_cmd([0.05, 0, 0, 0, 0, 0])
            time.sleep(0.01)
        pose, vel, force, img = br.observe()
    finally:
        br.stop()
    s = br.loop_stats()
    assert s["ticks"] > 0 and s["elapsed_s"] > 0 and set(s) >= {"missed", "jitter_mean_s",
                                                                "rate_hz"}
    assert pose[0] > 0 and img is None and force.tolist() == [2.0]
    assert br.state_latest() is not None and 0.0 < br.success_rate() <= 1.0


def test_native_library_builds_in_the_port_directory():
    """The port's library is built from native/ into
    ealv_tpu_torch/_build/native/ (git-ignored), and importing the package
    loads no library: a fresh process that imports every module of the
    port has no libealv_native mapped."""
    tn.NativeControllers()  # builds on first use if needed
    assert tn._LIB.exists()
    assert str(tn._LIB.parent) == os.path.join(REPO, "ealv_tpu_torch", "_build", "native")
    ignored = subprocess.run(["git", "check-ignore", str(tn._LIB)], cwd=REPO,
                             capture_output=True, text=True)
    assert ignored.returncode == 0
    code = ("import importlib, pkgutil\n"
            "import ealv_tpu_torch\n"
            "for m in pkgutil.walk_packages(ealv_tpu_torch.__path__, 'ealv_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "print('libealv_native' in open('/proc/self/maps').read())\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "False"


@pytest.fixture()
def ros_servers():
    bj, bt = bridges("free")
    return [(mod.RosBridgeServer(br, ros, _FakeSrv, _FakeGeom), ros, br)
            for mod, br, ros in ((jb, bj, _FakeRos()), (tb, bt, _FakeRos()))]


def _vel_req(v):
    req = _Attr()
    for ax, x in zip(("x", "y", "z"), v[:3]):
        setattr(req.desired_vel.linear, ax, x)
    for ax, x in zip(("x", "y", "z"), v[3:]):
        setattr(req.desired_vel.angular, ax, x)
    req.desired_brightness = -1.0
    return req


def _pose6(msg):
    p, o = msg.position, msg.orientation
    return np.array([p.x, p.y, p.z, o.x, o.y, o.z, o.w])


def test_ros_server_matches_jax(ros_servers):
    """Registered services and topics; velocity and pose services move the
    robot the same way and answer the same poses; the quaternion round
    trip near roll = pi; pause and resume topics gate commands; one
    publish per state topic."""
    (sj, rj, bj), (st, rt, bt) = ros_servers
    assert set(rt.services) == set(rj.services) == {"/klerg_start_pose", "/klerg_cmd",
                                                    "/klerg_pose"}
    assert set(rt.subs) == set(rj.subs)
    for _ in range(5):
        aj = rj.services["/klerg_cmd"](_vel_req([0.05, 0, 0, 0, 0, 0]))
        at = rt.services["/klerg_cmd"](_vel_req([0.05, 0, 0, 0, 0, 0]))
        assert at.success and aj.success
        np.testing.assert_allclose(_pose6(at.actual_pose), _pose6(aj.actual_pose), atol=2e-5)
    target = np.array([0.5, 0.05, 0.3, np.pi - 0.2, 0.1, 0.4], np.float32)
    np.testing.assert_allclose(st._msg_pose6(st._pose_msg(target)), target, atol=1e-4)
    req = _Attr()
    req.desired_pose = st._pose_msg(target)
    req.desired_brightness = -1.0
    for _ in range(10):
        aj = rj.services["/klerg_pose"](req)
        at = rt.services["/klerg_pose"](req)
    np.testing.assert_allclose(_pose6(at.actual_pose), _pose6(aj.actual_pose), atol=2e-5)
    np.testing.assert_allclose(_pose6(rt.services["/klerg_start_pose"](None).start_pose),
                               _pose6(at.actual_pose), atol=1e-6)
    rt.subs["/pause"](None)
    assert not rt.services["/klerg_cmd"](_vel_req([0.1] * 3 + [0] * 3)).success
    rt.subs["/resume"](None)
    assert rt.services["/klerg_cmd"](_vel_req([0.1] * 3 + [0] * 3)).success
    st.publish_once()
    assert [t for t, _ in rt.published] == ["/ee_pose", "/ee_vel", "/ee_wrench"]


def test_serve_ros_needs_ros():
    _, bt = bridges("free")
    with pytest.raises(ImportError, match="ROS"):
        tb.serve_ros(bt)
