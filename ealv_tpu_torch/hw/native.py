"""ctypes bindings for the native realtime controller library (a copy of
``ealv_tpu/hw/native.py`` with the port's own build directory).

The C++ side (the repo's ``native/``) provides the hardware-path runtime the
reference implements as franka_hw plugins (SURVEY.md §2.2): slew-limited
velocity ramping, double low-pass pose filtering, PID joint moves, wrench
filtering, and the mode mux. Device code never touches this: it sits
strictly host-side between the planner's commands and the 1 kHz robot
loop, and no torch call enters its thread.

Build: ``python -m ealv_tpu_torch.hw.native`` or ``build_native()`` compiles
``native/src/*.cpp`` with ``native/include`` into
``ealv_tpu_torch/_build/native/`` (cmake+ninja, or plain g++ when cmake is
missing), under a file lock so that processes side by side build it once.
Importing this module builds and loads nothing; the first
``NativeControllers``, ``SilPlant`` or ``NativeLoop`` does. C ABI + ctypes.
"""

from __future__ import annotations

import ctypes
import enum
import fcntl
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build" / "native"
_LIB = _BUILD_DIR / "libealv_native.so"


class ControlMode(enum.IntEnum):
    VELOCITY = 0
    POSE = 1
    JOINT = 2


def build_native(force: bool = False) -> Path:
    """Compile the native library into the port's build directory (cmake
    if available, g++ fallback); returns its path."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _LIB.exists() and not force:
            return _LIB
        try:
            subprocess.run(
                ["cmake", "-S", str(_NATIVE_DIR), "-B", str(_BUILD_DIR), "-G", "Ninja"],
                check=True, capture_output=True,
            )
            subprocess.run(["cmake", "--build", str(_BUILD_DIR)], check=True,
                           capture_output=True)
        except (subprocess.CalledProcessError, FileNotFoundError):
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                 "-I", str(_NATIVE_DIR / "include"),
                 *sorted(str(p) for p in (_NATIVE_DIR / "src").glob("*.cpp")),
                 "-o", str(_LIB)],
                check=True,
            )
    return _LIB


def _load():
    return ctypes.CDLL(str(_LIB if _LIB.exists() else build_native()))


_d6 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


class NativeControllers:
    """Python handle on the ControllerMux (the go_vel surface)."""

    def __init__(self, dt: float = 1e-3, cmd_dt: float = 0.1,
                 max_force: float = 30.0):
        self._lib = _load()
        lib = self._lib
        lib.ealv_mux_create.restype = ctypes.c_void_p
        lib.ealv_mux_create.argtypes = [ctypes.c_double] * 3
        for name, argts in [
            ("ealv_mux_destroy", [ctypes.c_void_p]),
            ("ealv_mux_switch_mode", [ctypes.c_void_p, ctypes.c_int]),
            ("ealv_mux_command_twist", [ctypes.c_void_p, _d6, ctypes.c_int]),
            ("ealv_mux_command_pose", [ctypes.c_void_p, _d6]),
            ("ealv_mux_command_joints", [ctypes.c_void_p, _d6]),
            ("ealv_mux_set_wrench", [ctypes.c_void_p, _d6]),
            ("ealv_mux_tick_velocity", [ctypes.c_void_p, _d6]),
            ("ealv_mux_tick_pose", [ctypes.c_void_p, _d6, _d6]),
            ("ealv_mux_tick_joints", [ctypes.c_void_p, _d6, _d6]),
        ]:
            getattr(lib, name).argtypes = argts
        lib.ealv_mux_mode.restype = ctypes.c_int
        lib.ealv_mux_mode.argtypes = [ctypes.c_void_p]
        lib.ealv_mux_command_twist.restype = ctypes.c_int
        self._h = lib.ealv_mux_create(dt, cmd_dt, max_force)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ealv_mux_destroy(self._h)
            self._h = None

    # ---- mode switching (/switch_to_{pose,vel}_controller topics) ----
    def switch_mode(self, mode: ControlMode):
        self._lib.ealv_mux_switch_mode(self._h, int(mode))

    @property
    def mode(self) -> ControlMode:
        return ControlMode(self._lib.ealv_mux_mode(self._h))

    # ---- command surface (/klerg_cmd -> /vel_cmd | /pose_cmd | /joint_cmd) --
    def command_twist(self, twist, rt_ok: bool = True) -> bool:
        t = np.ascontiguousarray(twist, np.float64)
        return bool(self._lib.ealv_mux_command_twist(self._h, t, int(rt_ok)))

    def command_pose(self, pose_4x4):
        p = np.ascontiguousarray(pose_4x4, np.float64).reshape(16)
        self._lib.ealv_mux_command_pose(self._h, p)

    def command_joints(self, joints):
        j = np.ascontiguousarray(joints, np.float64)
        self._lib.ealv_mux_command_joints(self._h, j)

    def set_wrench(self, wrench):
        w = np.ascontiguousarray(wrench, np.float64)
        self._lib.ealv_mux_set_wrench(self._h, w)

    # ---- 1 kHz tick outputs ----
    def tick_velocity(self) -> np.ndarray:
        out = np.zeros(6)
        self._lib.ealv_mux_tick_velocity(self._h, out)
        return out

    def tick_pose(self, current_4x4) -> np.ndarray:
        c = np.ascontiguousarray(current_4x4, np.float64).reshape(16)
        out = np.zeros(16)
        self._lib.ealv_mux_tick_pose(self._h, c, out)
        return out.reshape(4, 4)

    def tick_joints(self, current) -> np.ndarray:
        c = np.ascontiguousarray(current, np.float64)
        out = np.zeros(7)
        self._lib.ealv_mux_tick_joints(self._h, c, out)
        return out


_STATE_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p,
                             ctypes.POINTER(ctypes.c_double),
                             ctypes.POINTER(ctypes.c_double),
                             ctypes.POINTER(ctypes.c_double))
_APPLY_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p,
                             ctypes.POINTER(ctypes.c_double))


class SilPlant:
    """Native velocity-integrator plant (SIL target with zero Python in
    the tick path)."""

    def __init__(self, dt: float = 1e-3):
        self._lib = _load()
        lib = self._lib
        lib.ealv_sil_plant_create.restype = ctypes.c_void_p
        lib.ealv_sil_plant_create.argtypes = [ctypes.c_double]
        lib.ealv_sil_plant_destroy.argtypes = [ctypes.c_void_p]
        lib.ealv_sil_plant_state.argtypes = [ctypes.c_void_p, _d6, _d6, _d6]
        lib.ealv_sil_plant_set_wrench.argtypes = [ctypes.c_void_p, _d6]
        self._h = lib.ealv_sil_plant_create(dt)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ealv_sil_plant_destroy(self._h)
            self._h = None

    def state(self):
        p, v, w = np.zeros(6), np.zeros(6), np.zeros(6)
        self._lib.ealv_sil_plant_state(self._h, p, v, w)
        return p, v, w

    def set_wrench(self, wrench6):
        self._lib.ealv_sil_plant_set_wrench(
            self._h, np.ascontiguousarray(wrench6, np.float64))


class NativeLoop:
    """The C++ realtime loop (rt_loop.h): paces ControllerMux ticks with
    absolute-deadline clock_nanosleep, keeps a native stamped-state ring,
    and reports achieved rate / jitter / missed-deadline stats.

    Construct with either ``plant=SilPlant(...)`` (all-native tick path)
    or a Python ``driver`` exposing ``state() -> (pose6, vel6, wrench6)``
    and ``apply_velocity(twist6)`` / ``apply_pose(pose16)`` — the
    callbacks cross the GIL each tick, so the Python-driver form is for
    SIL/bring-up; hardware drivers belong on the C side.
    """

    def __init__(self, mux: NativeControllers, dt: float = 1e-3,
                 plant: SilPlant | None = None, driver=None):
        if (plant is None) == (driver is None):
            raise ValueError("exactly one of plant/driver required")
        self._lib = _load()
        lib = self._lib
        lib.ealv_loop_create.restype = ctypes.c_void_p
        lib.ealv_loop_create.argtypes = [
            ctypes.c_void_p, ctypes.c_double, ctypes.c_void_p,
            _STATE_FN, _APPLY_FN, _APPLY_FN, _APPLY_FN]
        lib.ealv_loop_create_sil.restype = ctypes.c_void_p
        lib.ealv_loop_create_sil.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                             ctypes.c_void_p]
        for name in ("ealv_loop_destroy", "ealv_loop_start", "ealv_loop_stop"):
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.ealv_loop_stats.argtypes = [ctypes.c_void_p, _d6]
        lib.ealv_loop_state_closest.restype = ctypes.c_int
        lib.ealv_loop_state_closest.argtypes = [
            ctypes.c_void_p, ctypes.c_double,
            ctypes.POINTER(ctypes.c_double), _d6, _d6, _d6]
        lib.ealv_loop_state_latest.restype = ctypes.c_int
        lib.ealv_loop_state_latest.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_double), _d6, _d6, _d6]

        self._mux = mux      # keep alive: the loop holds a raw pointer
        self._plant = plant
        self._cbs = []       # keep ctypes callbacks alive
        self.has_pose = True  # whether pose-mode ticks can actually act
        if plant is not None:
            self._h = lib.ealv_loop_create_sil(mux._h, dt, plant._h)
        else:
            def state_cb(_, p, v, w):
                pose, vel, wrench = driver.state()
                for i in range(6):
                    p[i], v[i], w[i] = pose[i], vel[i], wrench[i]

            def vel_cb(_, t):
                driver.apply_velocity(np.ctypeslib.as_array(t, (6,)).copy())

            def pose_cb(_, m):
                driver.apply_pose(np.ctypeslib.as_array(m, (16,)).copy())

            def pose_mat_cb(_, m):
                out = np.asarray(driver.pose_matrix(), np.float64).reshape(16)
                for i in range(16):
                    m[i] = out[i]

            # without both callbacks the C loop's pose branch is a no-op
            # (rt_loop.cpp:121-124 guards on non-NULL vtable entries);
            # record it so callers can REJECT pose commands instead of
            # letting klerg_pose appear to succeed while the robot never
            # moves
            has_pose = hasattr(driver, "apply_pose") and hasattr(
                driver, "pose_matrix")
            self.has_pose = has_pose
            self._cbs = [
                _STATE_FN(state_cb), _APPLY_FN(vel_cb),
                _APPLY_FN(pose_cb) if has_pose else _APPLY_FN(0),
                _APPLY_FN(pose_mat_cb) if has_pose else _APPLY_FN(0),
            ]
            self._h = lib.ealv_loop_create(mux._h, dt, None, *self._cbs)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ealv_loop_stop(self._h)
            self._lib.ealv_loop_destroy(self._h)
            self._h = None

    def start(self):
        self._lib.ealv_loop_start(self._h)

    def stop(self):
        self._lib.ealv_loop_stop(self._h)

    def stats(self) -> dict:
        out = np.zeros(6)
        self._lib.ealv_loop_stats(self._h, out)
        ticks, missed, jmean, jmax, elapsed = out[:5]
        return {
            "ticks": int(ticks), "missed": int(missed),
            "jitter_mean_s": float(jmean), "jitter_max_s": float(jmax),
            "elapsed_s": float(elapsed),
            "rate_hz": float(ticks / elapsed) if elapsed > 0 else 0.0,
        }

    def state_closest(self, t: float):
        """(stamp, pose6, vel6, wrench6) nearest ``t`` or None."""
        stamp = ctypes.c_double()
        p, v, w = np.zeros(6), np.zeros(6), np.zeros(6)
        ok = self._lib.ealv_loop_state_closest(
            self._h, t, ctypes.byref(stamp), p, v, w)
        return (stamp.value, p, v, w) if ok else None

    def state_latest(self):
        stamp = ctypes.c_double()
        p, v, w = np.zeros(6), np.zeros(6), np.zeros(6)
        ok = self._lib.ealv_loop_state_latest(self._h, ctypes.byref(stamp),
                                              p, v, w)
        return (stamp.value, p, v, w) if ok else None


if __name__ == "__main__":
    path = build_native(force=True)
    print(f"built {path}")
