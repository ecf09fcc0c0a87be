"""Interactive experiment control panel (headless CLI): a stdlib-only
copy of ``ealv_tpu/runtime/panel.py``.

Parity target: scripts/gui (tkinter panel, 375 LoC) — pause/resume/reset/
recover/manual/save, pose<->vel controller switches, z up/down nudges,
brightness control. This rebuild has no display server, so the panel is a
stdin-driven command loop wired to the same control hooks (PauseManager,
mode switching, env nudges); a GUI front-end can attach to the same
``ControlHooks`` surface.
"""

from __future__ import annotations

import sys
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

from .watchdog import PauseManager


@dataclass
class ControlHooks:
    """Callbacks the experiment loop exposes to the panel."""

    pause_mgr: PauseManager = field(default_factory=PauseManager)
    reset_fn: Optional[Callable[[], None]] = None
    recover_fn: Optional[Callable[[], None]] = None
    switch_mode_fn: Optional[Callable[[str], None]] = None  # 'pose' | 'vel'
    nudge_z_fn: Optional[Callable[[float], None]] = None
    brightness_fn: Optional[Callable[[float], None]] = None


HELP = """commands:
  pause | resume | manual | save      experiment flow control
  reset | recover                     robot recovery actions
  mode pose | mode vel                controller switch
  z up | z down                       nudge end-effector z
  b <0..1>                            set brightness
  status | help | quit
"""


class ControlPanel:
    """Command loop over ControlHooks; run() blocks, start() runs in a
    daemon thread alongside the experiment."""

    def __init__(self, hooks: ControlHooks, inp=None, out=None):
        self.hooks = hooks
        self.inp = inp or sys.stdin
        self.out = out or sys.stdout
        self._stop = False

    def _print(self, msg: str):
        print(msg, file=self.out, flush=True)

    def handle(self, line: str) -> bool:
        """Process one command; returns False on quit."""
        h = self.hooks
        parts = line.strip().split()
        if not parts:
            return True
        cmd = parts[0].lower()
        if cmd == "pause":
            h.pause_mgr.pause()
            self._print("paused")
        elif cmd == "resume":
            h.pause_mgr.resume()
            self._print("resumed")
        elif cmd == "manual":
            h.pause_mgr.manual = not h.pause_mgr.manual
            self._print(f"manual = {h.pause_mgr.manual}")
        elif cmd == "save":
            h.pause_mgr.request_save()
            self._print("save requested")
        elif cmd == "reset" and h.reset_fn:
            h.reset_fn()
            self._print("reset sent")
        elif cmd == "recover" and h.recover_fn:
            h.recover_fn()
            self._print("recovery sent")
        elif cmd == "mode" and len(parts) > 1 and h.switch_mode_fn:
            h.switch_mode_fn(parts[1])
            self._print(f"mode -> {parts[1]}")
        elif cmd == "z" and len(parts) > 1 and h.nudge_z_fn:
            h.nudge_z_fn(0.01 if parts[1] == "up" else -0.01)
            self._print(f"z {parts[1]}")
        elif cmd == "b" and len(parts) > 1 and h.brightness_fn:
            h.brightness_fn(float(parts[1]))
            self._print(f"brightness = {parts[1]}")
        elif cmd == "status":
            self._print(
                f"paused={h.pause_mgr.paused} manual={h.pause_mgr.manual} "
                f"save_pending={h.pause_mgr.save_requested}"
            )
        elif cmd in ("quit", "exit"):
            return False
        else:
            self._print(HELP)
        return True

    def run(self):
        self._print(HELP)
        for line in self.inp:
            if self._stop or not self.handle(line):
                break

    def start(self) -> threading.Thread:
        t = threading.Thread(target=self.run, daemon=True)
        t.start()
        return t

    def stop(self):
        self._stop = True
