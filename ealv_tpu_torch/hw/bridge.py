"""Robot service bridges (port of ``ealv_tpu/hw/bridge.py``): the
reference's ROS surface without ROS.

``RobotBridge`` is the surface the host loop talks to: velocity and pose
commands (the ``/klerg_cmd``, ``/klerg_pose`` services), the start pose
(``/klerg_start_pose``), the synced observation, and the reset and
controller-switch topics. ``SyntheticBridge`` backs it with a simulator
(``SyntheticEnv`` or ``ArmEnv``) whose state stays on the env's device;
``NativeBridge`` with the C++ controller mux at 1 kHz against a robot
driver (numpy and ctypes only: no torch call enters its loop thread).
``RosBridgeServer`` re-exports a bridge as ROS services and topics, with
the ROS modules injected; ``serve_ros`` resolves the real ones and raises
``ImportError`` without a ROS install.

Observations cross to the host as numpy. ``SyntheticBridge.observe`` packs
(pose6, vel6, force, brightness, image) into one flat device tensor and
copies it once. Its device-resident form, ``cmd_observe_device``, keeps the
packed observation on the device and starts a copy of its small prefix
(pose6, vel6, force, brightness) into pinned host memory, read through
``HostCopy`` after its CUDA event.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..runtime.watchdog import PauseManager
from ..utils.host_copy import HostCopy


class RobotBridge:
    """Service surface: velocity/pose commands + synced observation."""

    def klerg_cmd(self, twist6, brightness: float = -1.0) -> bool:
        """Velocity command (UpdateVel). Returns success."""
        raise NotImplementedError

    def klerg_pose(self, pose6, brightness: float = -1.0) -> bool:
        """Pose command (UpdateState)."""
        raise NotImplementedError

    def klerg_start_pose(self):
        """(GetStartState): current pose6."""
        raise NotImplementedError

    def observe(self):
        """Synced (pose6, vel6, force, image) tuple."""
        raise NotImplementedError

    # topic surface
    def reset(self):
        pass

    def switch_controller(self, mode: str):
        pass


class SyntheticBridge(RobotBridge):
    """Back the service surface with a simulator env and its state (the
    role of the reference's FrankaBridge + pybullet_service)."""

    def __init__(self, env, env_state, pause: Optional[PauseManager] = None):
        self.env = env
        self.state = env_state
        self.pause = pause or PauseManager()
        self.device = env_state.pose.device
        # the packed observation's layout, from the env's own shapes: a
        # multi-element force must not shift the brightness slot
        _, _, force, img = env.observe(env_state)
        self._force_size = int(force.numel()) or 1
        self._img_shape = tuple(img.shape)
        self.last_brightness = 1.0

    def _tensor(self, v):
        return torch.as_tensor(np.asarray(v, np.float32), device=self.device)

    def _observe_packed(self, s):
        """(pose6, vel6, force, brightness, image) as one flat f32 tensor."""
        pose, vel, force, img = self.env.observe(s)
        return torch.cat([pose.float(), vel.float(), force.reshape(-1).float(),
                          s.brightness.reshape(1).float(), img.reshape(-1).float()])

    def cmd_observe_pure(self, s, cmd7):
        """Apply cmd7 = [vel6 | brightness, < 0 keeps it] to env state ``s``
        and observe: (new state, packed observation, its small prefix), all
        on the device. The host loop composes this with its absorb-and-plan
        half when the bridge leaves ``cmd_observe_device`` as it is."""
        b = torch.where(cmd7[6] >= 0, cmd7[6], s.brightness)
        s2 = self.env.step_vel(s, cmd7[:6], b)
        flat = self._observe_packed(s2)
        return s2, flat, flat[:13 + self._force_size]

    def klerg_cmd(self, twist6, brightness: float = -1.0) -> bool:
        if self.pause.paused:
            return False
        v = self._tensor(twist6)
        if brightness < 0:
            self.state = self.env.step_vel(self.state, v)
        else:
            self.state = self.env.step_vel(self.state, v, self._tensor(brightness))
        return True

    def klerg_pose(self, pose6, brightness: float = -1.0) -> bool:
        if self.pause.paused:
            return False
        p = self._tensor(pose6)
        if brightness < 0:
            self.state = self.env.step_pose(self.state, p)
        else:
            self.state = self.env.step_pose(self.state, p, self._tensor(brightness))
        return True

    def klerg_start_pose(self):
        return self.state.pose.cpu().numpy()

    def observe(self):
        flat = self._observe_packed(self.state).cpu().numpy()  # one copy to the host
        nf = self._force_size
        self.last_brightness = float(flat[12 + nf])
        return (flat[:6], flat[6:12], flat[12:12 + nf],
                flat[13 + nf:].reshape(self._img_shape))

    # ---- device-resident path ----
    def device_fast_path_ok(self) -> bool:
        """The device-resident command-and-observe bypasses ``klerg_cmd``
        and ``observe``, so it is only sound when neither is overridden, in
        a subclass or on the instance (bridges that wedge or fail by
        overriding them take the host-side path)."""
        cls = type(self)
        return (cls.klerg_cmd is SyntheticBridge.klerg_cmd
                and cls.observe is SyntheticBridge.observe
                and "klerg_cmd" not in self.__dict__
                and "observe" not in self.__dict__)

    def cmd_observe_device(self, cmd7):
        """Apply [vel6 | brightness] and observe, keeping the packed
        observation on the device. Returns (flat, small): the packed
        observation and a ``HostCopy`` of its prefix (pose6, vel6, force,
        brightness), in flight. None if paused (``klerg_cmd`` parity)."""
        if self.pause.paused:
            return None
        cmd7 = cmd7 if torch.is_tensor(cmd7) else self._tensor(cmd7)
        self.state, flat, small = self.cmd_observe_pure(self.state, cmd7)
        return flat, HostCopy(small)


class StaleObservationError(RuntimeError):
    """Raised when the camera frame is older than the lost-connection
    threshold (parity: got_img=False on a >1 s-old stamp,
    sensor_utils.py:486-489). The host loop treats it like a failed
    service call: pause, let the recovery heartbeat resume."""


class StampedCache:
    """Small ring of (stamp, value) pairs with closest-stamp lookup, the
    message_filters.Cache selection the reference uses to align the pose,
    velocity, force and brightness streams to each camera frame
    (sensor_utils.py:322-358)."""

    def __init__(self, maxlen: int = 64):
        self._buf = deque(maxlen=maxlen)
        self._lock = threading.Lock()

    def push(self, stamp: float, value):
        with self._lock:
            self._buf.append((float(stamp), value))

    def latest(self):
        with self._lock:
            return self._buf[-1] if self._buf else (None, None)

    def closest(self, t: float):
        """(stamp, value) of the cached element nearest ``t``."""
        with self._lock:
            if not self._buf:
                return None, None
            return min(self._buf, key=lambda sv: abs(sv[0] - t))

    def stamps(self):
        """All cached stamps, oldest first (loop-cadence diagnostics)."""
        with self._lock:
            return [s for s, _ in self._buf]


@dataclass
class NativeBridge(RobotBridge):
    """Back the service surface with the native controller mux running a
    1 kHz loop against a robot driver.

    ``driver`` supplies the plant: ``driver.state() -> (pose6, vel6,
    wrench6)`` and ``driver.apply_velocity(twist6)`` /
    ``driver.apply_pose(pose16)``. ``camera() -> image | (image, stamp)``
    supplies frames. The loop stamps every state sample, so ``observe``
    returns the pose/vel/wrench closest in time to the camera frame. With
    the default clock the loop is the C++ pacer (``native/src/rt_loop.cpp``);
    an injected ``clock`` runs a Python-paced thread instead (tests that own
    the time).
    """

    driver: object
    camera: Optional[Callable] = None
    dt: float = 1e-3
    cmd_dt: float = 0.1
    max_force: float = 30.0
    max_img_age: float = 1.0  # lost-connection threshold (:486-489)
    clock: Callable = time.monotonic
    pause: PauseManager = field(default_factory=PauseManager)
    # commanded brightness is applied through a BrightnessNode
    # (hw/peripherals.py), the role of the reference's /update_brightness
    brightness_node: Optional[object] = None
    _thread: Optional[threading.Thread] = None
    _running: bool = False

    def __post_init__(self):
        from .native import NativeControllers, ControlMode

        self._ControlMode = ControlMode
        self.mux = NativeControllers(self.dt, self.cmd_dt, self.max_force)
        self._state_cache = StampedCache()
        self._native_loop = None

    # ---- 1 kHz loop ----
    def start(self):
        if self.clock is time.monotonic:
            from .native import NativeLoop

            self._native_loop = NativeLoop(self.mux, self.dt, driver=self.driver)
            self._native_loop.start()
            return
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        if self._native_loop is not None:
            self._native_loop.stop()
            return
        self._running = False
        if self._thread:
            self._thread.join(timeout=1.0)

    def loop_stats(self) -> Optional[dict]:
        """Achieved tick rate / jitter / missed-deadline stats of the
        native loop (None under the Python pacing)."""
        return self._native_loop.stats() if self._native_loop else None

    def _loop(self):
        CM = self._ControlMode
        while self._running:
            pose6, vel6, wrench6 = self.driver.state()
            self._state_cache.push(self.clock(), (pose6, vel6, wrench6))
            self.mux.set_wrench(wrench6)
            if self.mux.mode == CM.VELOCITY:
                self.driver.apply_velocity(self.mux.tick_velocity())
            elif self.mux.mode == CM.POSE:
                self.driver.apply_pose(self.mux.tick_pose(self.driver.pose_matrix()))
            time.sleep(self.dt)

    def success_rate(self) -> float:
        """The control-command success rate (the reference's RT
        deadline-hit ratio, cartesian_vel_interface.cpp:216-219): the
        achieved fraction of the expected 1/dt ticks. 1.0 before the loop
        starts (no evidence of degradation yet)."""
        if self._native_loop is not None:
            s = self._native_loop.stats()
            if s["ticks"] <= 0 or s["elapsed_s"] <= 0:
                return 1.0
            return min(1.0, s["rate_hz"] * self.dt)
        stamps = self._state_cache.stamps()
        if len(stamps) < 2:
            return 1.0
        window = stamps[-1] - stamps[0]
        if window <= 0:
            return 1.0
        return min(1.0, (len(stamps) - 1) * self.dt / window)

    # ---- service surface ----
    def klerg_cmd(self, twist6, brightness: float = -1.0) -> bool:
        if self.pause.paused:
            return False
        if brightness >= 0 and self.brightness_node is not None:
            self.brightness_node.update(brightness)
        self.mux.switch_mode(self._ControlMode.VELOCITY)
        # success only while the loop keeps its rate; a degraded command
        # resets the velocity ramp on the C++ side (VelFilter::command with
        # rt_ok false), and the False return pauses the host loop until
        # the recovery heartbeat resumes
        rt_ok = self.success_rate() > 0.5
        return bool(self.mux.command_twist(np.asarray(twist6, np.float64), rt_ok))

    def klerg_pose(self, pose6, brightness: float = -1.0) -> bool:
        if self.pause.paused:
            return False
        # a driver without the pose interface cannot execute pose commands
        # in either loop form: reject rather than report a success the
        # robot never executes
        if not (hasattr(self.driver, "apply_pose")
                and hasattr(self.driver, "pose_matrix")
                and hasattr(self.driver, "pose_to_matrix")):
            return False
        if brightness >= 0 and self.brightness_node is not None:
            self.brightness_node.update(brightness)
        self.mux.switch_mode(self._ControlMode.POSE)
        self.mux.command_pose(self.driver.pose_to_matrix(pose6))
        return True

    def klerg_start_pose(self):
        return np.asarray(self.driver.state()[0])

    def observe(self):
        """Stamp-aligned (pose6, vel6, force, image): the state sample
        closest in time to the camera frame; stale frames raise
        StaleObservationError."""
        now = self.clock()
        img, img_stamp = None, now
        if self.camera:
            frame = self.camera()
            if isinstance(frame, tuple):
                img, img_stamp = frame
            else:
                img = frame
        if img is not None and now - img_stamp > self.max_img_age:
            raise StaleObservationError(
                f"camera frame is {now - img_stamp:.2f}s old "
                f"(threshold {self.max_img_age}s) — connection lost?")
        if self._native_loop is not None:
            hit = self._native_loop.state_closest(img_stamp)
            state = hit[1:] if hit else None
        else:
            _, state = self._state_cache.closest(img_stamp)
        if state is None:  # loop not started yet: read the driver directly
            state = self.driver.state()
        pose6, vel6, wrench6 = state
        force = np.linalg.norm(np.asarray(wrench6)[:3], keepdims=True)
        return np.asarray(pose6), np.asarray(vel6), force, img

    def state_latest(self):
        """Freshest (pose6, vel6) from the live 1 kHz state ring, or None
        before the loop starts: the planner's view, while ``observe`` stays
        aligned to the camera's stamp."""
        if self._native_loop is not None:
            hit = self._native_loop.state_latest()
            if hit is not None:
                return np.asarray(hit[1]), np.asarray(hit[2])
        else:
            _, state = self._state_cache.latest()
            if state is not None:
                return np.asarray(state[0]), np.asarray(state[1])
        return None

    def reset(self):
        self.mux.switch_mode(self._ControlMode.VELOCITY)

    def switch_controller(self, mode: str):
        self.mux.switch_mode(
            self._ControlMode.POSE if mode == "pose" else self._ControlMode.VELOCITY)


def _matrix_to_quat(R):
    """Rotation matrix -> (x, y, z, w) quaternion (Shepperd's method)."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                         (R[1, 0] - R[0, 1]) / s, 0.25 * s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 0.0)) * 2
    q = np.zeros(4)
    q[i] = 0.25 * s
    q[j] = (R[j, i] + R[i, j]) / s
    q[k] = (R[k, i] + R[i, k]) / s
    q[3] = (R[k, j] - R[j, k]) / s
    return q


def _quat_to_matrix(q):
    """(x, y, z, w) quaternion -> rotation matrix."""
    x, y, z, w = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


class RosBridgeServer:
    """The reference's ROS surface over a RobotBridge
    (franka_module.py:108-131): the ``/klerg_cmd`` (UpdateVel),
    ``/klerg_pose`` (UpdateState), ``/klerg_start_pose`` (GetStartState)
    services; the ``/reset``, ``/reset_joints``, ``/pause``, ``/resume``
    Empty topics; and the ``/ee_pose``, ``/ee_vel``, ``/ee_wrench`` state
    publishers. ``ros``/``srv``/``geom`` are the rospy module and message
    packages, injected; ``serve_ros`` resolves the real ones.
    """

    def __init__(self, bridge: RobotBridge, ros, srv, geom,
                 node_name: str = "ealv_bridge", rate_hz: float = 100.0):
        from ..utils.rotations import euler_angles_to_matrix, matrix_to_euler_angles
        self._e2m = lambda a: euler_angles_to_matrix(
            torch.as_tensor(np.asarray(a, np.float32)), "XYZ").numpy()
        self._m2e = lambda R: matrix_to_euler_angles(
            torch.as_tensor(np.asarray(R, np.float32)), "XYZ").numpy()
        self.bridge = bridge
        self.ros = ros
        self.srv = srv
        self.geom = geom
        self.rate_hz = rate_hz
        ros.init_node(node_name)
        self.services = [
            ros.Service("/klerg_start_pose", srv.GetStartState, self.start_cb),
            ros.Service("/klerg_cmd", srv.UpdateVel, self.vel_cb),
            ros.Service("/klerg_pose", srv.UpdateState, self.pose_cb),
        ]
        self.subs = [
            ros.Subscriber("/reset", srv.Empty, lambda _m: bridge.reset()),
            ros.Subscriber("/reset_joints", srv.Empty, lambda _m: bridge.reset()),
            ros.Subscriber("/pause", srv.Empty, self._pause_cb),
            ros.Subscriber("/resume", srv.Empty, self._resume_cb),
        ]
        self.pose_pub = ros.Publisher("/ee_pose", geom.PoseStamped, queue_size=1)
        self.vel_pub = ros.Publisher("/ee_vel", geom.TwistStamped, queue_size=1)
        self.wrench_pub = ros.Publisher("/ee_wrench", geom.WrenchStamped, queue_size=1)

    # ---- message conversion (pose6 = xyz + extrinsic-XYZ euler) ----
    def _pose_msg(self, pose6):
        msg = self.geom.Pose()
        msg.position.x, msg.position.y, msg.position.z = map(float, pose6[:3])
        q = _matrix_to_quat(self._e2m(pose6[3:6]))
        (msg.orientation.x, msg.orientation.y,
         msg.orientation.z, msg.orientation.w) = map(float, q)
        return msg

    def _msg_pose6(self, msg):
        q = [msg.orientation.x, msg.orientation.y, msg.orientation.z, msg.orientation.w]
        rpw = self._m2e(_quat_to_matrix(q))
        return np.array([msg.position.x, msg.position.y, msg.position.z, *rpw], np.float32)

    # ---- service callbacks (franka_module.py:261-347) ----
    def vel_cb(self, req):
        t = req.desired_vel
        twist6 = np.array([t.linear.x, t.linear.y, t.linear.z,
                           t.angular.x, t.angular.y, t.angular.z], np.float32)
        ok = self.bridge.klerg_cmd(twist6, float(req.desired_brightness))
        return self.srv.UpdateVelResponse(
            self._pose_msg(self.bridge.klerg_start_pose()), bool(ok))

    def pose_cb(self, req):
        pose6 = self._msg_pose6(req.desired_pose)
        ok = self.bridge.klerg_pose(pose6, float(req.desired_brightness))
        return self.srv.UpdateStateResponse(
            self._pose_msg(self.bridge.klerg_start_pose()), bool(ok))

    def start_cb(self, _req):
        return self.srv.GetStartStateResponse(
            self._pose_msg(self.bridge.klerg_start_pose()), True)

    def _pause_cb(self, _msg):
        pause = getattr(self.bridge, "pause", None)
        if pause is not None:
            pause.pause()

    def _resume_cb(self, _msg):
        pause = getattr(self.bridge, "pause", None)
        if pause is not None:
            pause.resume()

    # ---- state publishing (the 100 Hz pose/vel/wrench publishers) ----
    def publish_once(self):
        pose6, vel6, force, _img = self.bridge.observe()
        ps = self.geom.PoseStamped()
        ps.pose = self._pose_msg(pose6)
        self.pose_pub.publish(ps)
        tw = self.geom.TwistStamped()
        (tw.twist.linear.x, tw.twist.linear.y, tw.twist.linear.z) = map(float, vel6[:3])
        (tw.twist.angular.x, tw.twist.angular.y, tw.twist.angular.z) = map(float, vel6[3:6])
        self.vel_pub.publish(tw)
        wr = self.geom.WrenchStamped()
        wr.wrench.force.z = float(np.ravel(force)[0])
        self.wrench_pub.publish(wr)

    def spin(self):  # pragma: no cover - needs a live roscore
        rate = self.ros.Rate(self.rate_hz)
        while not self.ros.is_shutdown():
            self.publish_once()
            rate.sleep()


def serve_ros(bridge: RobotBridge, node_name: str = "ealv_bridge",
              rate_hz: float = 100.0, spin: bool = True):
    """Serve a RobotBridge as the reference's ROS services and topics;
    raises ImportError without rospy and the franka_test messages."""
    try:  # pragma: no cover - needs a ROS install
        import rospy
        import geometry_msgs.msg as geom
        from franka_test import srv as fsrv
        from std_msgs.msg import Empty as _EmptyMsg
    except ImportError as e:
        raise ImportError(
            "serve_ros needs a ROS environment (rospy + franka_test msgs); "
            "none is installed. RosBridgeServer holds the full service "
            "logic and accepts injected ros/srv/geom modules.") from e

    class _Srv:  # pragma: no cover
        GetStartState = fsrv.GetStartState
        GetStartStateResponse = fsrv.GetStartStateResponse
        UpdateVel = fsrv.UpdateVel
        UpdateVelResponse = fsrv.UpdateVelResponse
        UpdateState = fsrv.UpdateState
        UpdateStateResponse = fsrv.UpdateStateResponse
        # a bare `Empty = Empty` here is a NameError: class bodies do not
        # close over the enclosing function's names
        Empty = _EmptyMsg

    server = RosBridgeServer(bridge, rospy, _Srv, geom, node_name=node_name,
                             rate_hz=rate_hz)
    if spin:  # pragma: no cover
        server.spin()
    return server
