"""Peripheral hardware nodes: camera/lamp brightness drivers + node logic
(a copy of ``ealv_tpu/hw/peripherals.py``; stdlib only).

Parity targets: the reference's L1' peripheral nodes that make 'b' an
explorable state (SURVEY.md §1) — `scripts/conditional_brightness` (USB
camera brightness: 30 Hz `/usb_cam/brightness` publisher,
`/update_brightness` subscriber, v4l2 control writes) and
`scripts/lamp_brightness` (GVM WiFi LED lamp: same node surface plus
off-below-10% power hysteresis).

Design deltas from the reference, deliberate:

- The reference shells out to ``v4l2-ctl -d DEV -c brightness=N`` per
  update (conditional_brightness:33).  ``V4L2BrightnessDriver`` issues the
  ``VIDIOC_S_CTRL``/``VIDIOC_G_CTRL`` ioctls directly on the device fd —
  no subprocess fork in the control path — and discovers the control's
  real range with ``VIDIOC_QUERYCTRL`` instead of assuming 0..255.
- The reference's lamp is driven by the external ``libgvmled`` package
  (lamp_brightness:9), which is not part of the reference repo; the node
  only uses its four-call surface (``turn_on/turn_off/set_brightness
  [10,99]/set_cct [0,100]``, lamp_brightness:18).  ``GVMLampDriver``
  reproduces that surface against a pluggable ``transport`` (any
  ``callable(bytes)`` — a UDP socket send on a real deployment) so the
  node logic is software-in-the-loop testable on this hardware-less image.
- ``BrightnessNode`` carries the node behavior itself — normalized [0,1]
  commands, clip, lamp power hysteresis, periodic stamped publishing —
  decoupled from ROS: give it a rospy-like module to serve the reference's
  exact topic surface, or drive it directly from the host loop /
  NativeBridge (bridge.py wires commanded brightness through it).

The ioctl path is exercised in SIL tests with an injected ioctl/opener
(the JAX package's tests/test_peripherals.py); on a real box it needs only
/dev/video*.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Callable, Optional

# ---------------------------------------------------------------------------
# v4l2 ABI constants (linux/videodev2.h)
# ---------------------------------------------------------------------------

# _IOC(dir, type, nr, size): dir<<30 | size<<16 | type<<8 | nr
_IOC_WRITE, _IOC_READ = 1, 2


def _IOWR(typ: str, nr: int, size: int) -> int:
    return ((_IOC_READ | _IOC_WRITE) << 30) | (size << 16) | (ord(typ) << 8) | nr


# struct v4l2_control { __u32 id; __s32 value; }  (8 bytes)
_CONTROL_FMT = "Ii"
# struct v4l2_queryctrl { __u32 id; __u32 type; __u8 name[32];
#   __s32 min, max, step, default; __u32 flags; __u32 reserved[2]; } (68 B)
_QUERYCTRL_FMT = "II32siiiiI2I"

VIDIOC_G_CTRL = _IOWR("V", 27, struct.calcsize(_CONTROL_FMT))
VIDIOC_S_CTRL = _IOWR("V", 28, struct.calcsize(_CONTROL_FMT))
VIDIOC_QUERYCTRL = _IOWR("V", 36, struct.calcsize(_QUERYCTRL_FMT))

V4L2_CID_BRIGHTNESS = 0x00980900  # V4L2_CID_BASE + 0


def _default_ioctl(fd: int, request: int, buf: bytearray):
    import fcntl

    return fcntl.ioctl(fd, request, buf)


class V4L2BrightnessDriver:
    """Camera brightness via direct v4l2 ioctls on the device fd.

    ``set(b)`` / ``get()`` use normalized [0,1] brightness mapped onto the
    control's queried [minimum, maximum] range.  ``ioctl`` and ``opener``
    are injectable for SIL tests; defaults hit the real kernel interface.
    """

    def __init__(self, device: str = "/dev/video0",
                 ioctl: Callable = _default_ioctl,
                 opener: Callable = os.open,
                 cid: int = V4L2_CID_BRIGHTNESS):
        self.device = device
        self._ioctl = ioctl
        self.cid = cid
        self.fd = opener(device, os.O_RDWR)
        self.minimum, self.maximum = self._query_range()

    def _query_range(self):
        buf = bytearray(struct.pack(_QUERYCTRL_FMT, self.cid, 0, b"",
                                    0, 0, 0, 0, 0, 0, 0))
        try:
            self._ioctl(self.fd, VIDIOC_QUERYCTRL, buf)
            _, _, _, mn, mx, _, _, _, _, _ = struct.unpack(_QUERYCTRL_FMT, buf)
            if mx > mn:
                return mn, mx
        except OSError:
            pass
        # reference fallback: 0..255 (conditional_brightness:17)
        return 0, 255

    def set(self, b01: float) -> int:
        """Write normalized brightness; returns the raw value written."""
        b01 = min(1.0, max(0.0, float(b01)))
        raw = int(round(self.minimum + b01 * (self.maximum - self.minimum)))
        buf = bytearray(struct.pack(_CONTROL_FMT, self.cid, raw))
        self._ioctl(self.fd, VIDIOC_S_CTRL, buf)
        return raw

    def get(self) -> float:
        buf = bytearray(struct.pack(_CONTROL_FMT, self.cid, 0))
        self._ioctl(self.fd, VIDIOC_G_CTRL, buf)
        _, raw = struct.unpack(_CONTROL_FMT, buf)
        return (raw - self.minimum) / max(1, self.maximum - self.minimum)

    def close(self):
        if self.fd >= 0:
            os.close(self.fd)
            self.fd = -1


class GVMLampDriver:
    """The libgvmled call surface (lamp_brightness:18: ``set_brightness
    [10,99]`` / ``set_cct [0,100]`` / power) over a pluggable transport.

    ``transport`` is any ``callable(bytes)``; a real GVM WiFi lamp takes a
    UDP socket send (the wire protocol lives in the external libgvmled
    package the reference imports — it is not part of the reference repo,
    so the frame layout here is this framework's own compact encoding and
    the transport boundary is where a vendor codec drops in).
    """

    BRIGHTNESS_LO, BRIGHTNESS_HI = 10, 99

    def __init__(self, transport: Callable[[bytes], None]):
        self.transport = transport
        self.is_on = False
        self.brightness = self.BRIGHTNESS_LO
        self.cct = 50

    def _send(self, op: int, value: int):
        self.transport(struct.pack("<4sBB", b"EALV", op, value & 0xFF))

    def turn_on(self):
        self.is_on = True
        self._send(0x01, 1)

    def turn_off(self):
        self.is_on = False
        self._send(0x01, 0)

    def set_brightness(self, value: int):
        value = int(min(self.BRIGHTNESS_HI, max(self.BRIGHTNESS_LO, value)))
        self.brightness = value
        self._send(0x02, value)

    def set_cct(self, value: int):
        value = int(min(100, max(0, value)))
        self.cct = value
        self._send(0x03, value)


@dataclass
class BrightnessNode:
    """The BrightnessListener node logic (conditional_brightness:11-41 /
    lamp_brightness:13-53), ROS-optional.

    ``update(b01)`` is the `/update_brightness` callback: clip to [0,1],
    apply through the driver, remember the commanded value.  With a lamp
    driver (``off_below`` set), power hysteresis matches the reference's
    *intent*: below the threshold the lamp is switched off, and crossing
    back above it switches it on again before the brightness write.  (The
    reference compares the stored normalized value against the raw 10%
    threshold, lamp_brightness:38-41 — a unit slip that would re-send
    turn_on on every update; the normalized comparison here is the stated
    behavior of that code.)

    ``publish()`` emits one stamped brightness sample; ``serve(ros,
    msgs)`` registers the reference's exact topic surface (30 Hz
    `/usb_cam/brightness` timer + `/update_brightness` subscriber) on a
    rospy-like module, injectable for SIL tests.
    """

    driver: object
    initial: float = 0.5  # reference starting brightness
    off_below: Optional[float] = None  # lamp: 10/99 ≈ 0.1 power threshold
    rate_hz: float = 30.0
    clock: Callable = None
    current: float = field(init=False)

    def __post_init__(self):
        self.current = self.initial
        self._publications = []
        if self.off_below is not None:
            self.driver.turn_on()  # lamp_brightness:19: on before first write
        self.update(self.initial)

    def update(self, b01: float):
        b01 = min(1.0, max(0.0, float(b01)))
        if self.off_below is not None:
            if b01 < self.off_below:
                self.driver.turn_off()
            elif self.current < self.off_below:
                self.driver.turn_on()
            self.driver.set_brightness(
                int(b01 * GVMLampDriver.BRIGHTNESS_HI))
        else:
            self.driver.set(b01)
        self.current = b01

    def publish(self):
        """One stamped sample of the commanded brightness (the 30 Hz
        publisher body); returns (brightness, stamp)."""
        import time

        stamp = (self.clock or time.monotonic)()
        sample = (self.current, stamp)
        self._publications.append(sample)
        return sample

    def serve(self, ros, msgs, node_name: str = "BrightnessListener"):
        """Register the reference topic surface on a rospy-like module."""
        ros.init_node(node_name)
        pub = ros.Publisher("/usb_cam/brightness", msgs.BrightnessStamped,
                            queue_size=1)
        ros.Subscriber("/update_brightness", msgs.Float32,
                       lambda m: self.update(m.data))

        def _tick(_evt=None):
            b, stamp = self.publish()
            msg = msgs.BrightnessStamped()
            msg.brightness = b
            msg.header.frame_id = "usb_cam"
            msg.header.stamp = stamp
            pub.publish(msg)

        ros.Timer(1.0 / self.rate_hz, _tick)
        return pub
