"""The port's control panel (``ealv_tpu_torch/runtime/panel.py``, stdlib
only) against the JAX package's: the same command script through both
panels gives the same output text, the same hook calls and the same
flags; ``run`` reads stdin-like input to ``quit``; ``start`` runs it in a
thread."""

import io

from ealv_tpu.runtime import panel as jp
from ealv_tpu.runtime.watchdog import PauseManager as JPause
from ealv_tpu_torch.runtime import panel as tp
from ealv_tpu_torch.runtime.watchdog import PauseManager

SCRIPT = ["pause", "status", "resume", "manual", "manual", "save", "status", "reset",
          "recover", "mode pose", "mode vel", "z up", "z down", "b 0.3", "", "bogus",
          "help"]


def _drive(mod, pause_cls, lines):
    calls = []
    hooks = mod.ControlHooks(
        pause_mgr=pause_cls(), reset_fn=lambda: calls.append("reset"),
        recover_fn=lambda: calls.append("recover"),
        switch_mode_fn=lambda m: calls.append(("mode", m)),
        nudge_z_fn=lambda dz: calls.append(("z", dz)),
        brightness_fn=lambda b: calls.append(("b", b)))
    out = io.StringIO()
    panel = mod.ControlPanel(hooks, out=out)
    alive = [panel.handle(line) for line in lines]
    return out.getvalue(), calls, alive, hooks.pause_mgr


def test_panel_matches_jax():
    oj, cj, aj, pj = _drive(jp, JPause, SCRIPT + ["quit"])
    ot, ct, at, pt = _drive(tp, PauseManager, SCRIPT + ["quit"])
    assert ot == oj and ct == cj and at == aj
    assert (pt.paused, pt.manual, pt.save_requested) == (pj.paused, pj.manual,
                                                         pj.save_requested)
    assert at[-1] is False and ct[:2] == ["reset", "recover"]
    assert tp.HELP == jp.HELP


def test_panel_without_hooks_prints_help():
    out = io.StringIO()
    panel = tp.ControlPanel(tp.ControlHooks(), out=out)
    assert panel.handle("reset") and tp.HELP in out.getvalue()


def test_run_reads_until_quit_and_start_threads():
    hooks = tp.ControlHooks()
    out = io.StringIO()
    tp.ControlPanel(hooks, inp=io.StringIO("pause\nsave\nquit\nresume\n"), out=out).run()
    assert hooks.pause_mgr.paused and hooks.pause_mgr.save_requested  # stopped at quit
    hooks2 = tp.ControlHooks()
    panel = tp.ControlPanel(hooks2, inp=io.StringIO("pause\n"), out=io.StringIO())
    panel.start().join(timeout=5)
    assert hooks2.pause_mgr.paused
    panel.stop()
    assert panel._stop
