"""The browser control panel (``ealv_tpu_torch/runtime/webpanel.py``)
against the JAX ``WebPanel``: the same requests to both servers (each on a
free port of 127.0.0.1) give the same status codes, content types and
bodies, and the commands reach the hooks the same way. Then the run entry's
``--web-panel`` in the chunked loop: a save requested through the panel is
served between chunks, and the server is stopped when the run ends.
"""

import json
import os
import urllib.error
import urllib.request

import pytest

from ealv_tpu.runtime.panel import ControlHooks as JHooks
from ealv_tpu.runtime.webpanel import WebPanel as JWebPanel
from ealv_tpu_torch.runtime.panel import ControlHooks
from ealv_tpu_torch.runtime.webpanel import WebPanel
from ealv_tpu_torch.scripts import run_experiment as cli
from test_torch_trainer import one_torch_thread  # noqa: F401


def _request(port, path, body=None):
    """(status, content type, body) of one GET, or a POST with ``body``."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body.encode() if body is not None else None)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _hooks(cls, calls):
    return cls(reset_fn=lambda: calls.append("reset"),
               recover_fn=lambda: calls.append("recover"),
               switch_mode_fn=lambda m: calls.append(f"mode {m}"),
               nudge_z_fn=lambda dz: calls.append(f"z {dz:+.2f}"),
               brightness_fn=lambda b: calls.append(f"b {b:.2f}"))


@pytest.fixture
def panels(tmp_path):
    """A started port panel and JAX panel over recording hooks, each with a
    run dir of its own; stopped afterwards."""
    out = {}
    for side, hooks_cls, panel_cls in (("port", ControlHooks, WebPanel),
                                       ("jax", JHooks, JWebPanel)):
        calls = []
        run_dir = tmp_path / side
        run_dir.mkdir()
        web = panel_cls(_hooks(hooks_cls, calls), run_dir=str(run_dir), port=0)
        web.start()
        out[side] = (web, calls, run_dir)
    yield out
    for web, _, _ in out.values():
        web.stop()


SCRIPT = [("GET", "/status"), ("POST", "pause"), ("GET", "/status"), ("POST", "save"),
          ("POST", "manual"), ("GET", "/status?x=1"), ("POST", "resume"), ("POST", "reset"),
          ("POST", "recover"), ("POST", "mode vel"), ("POST", "z up"), ("POST", "z down"),
          ("POST", "b 0.5"), ("POST", "status"), ("POST", "bogus"), ("GET", "/dashboard.png"),
          ("GET", "/nope"), ("GET", "/")]


def test_endpoints_and_commands_match_jax(panels):
    """Every endpoint and every command of the panel's grammar, in one
    script, on both servers: equal replies, equal hook calls and flags; the
    dashboard frame 404 before it exists and served once it does."""
    replies = {}
    for side, (web, calls, run_dir) in panels.items():
        replies[side] = []
        for method, arg in SCRIPT:
            if method == "GET":
                replies[side].append(_request(web.port, arg))
            else:
                replies[side].append(_request(web.port, "/cmd", arg))
        (run_dir / "dashboard.png").write_bytes(b"\x89PNG frame")
        replies[side].append(_request(web.port, "/dashboard.png"))
        replies[side].append(_request(web.port, "/cmd2", "pause"))
    port, jax_ = replies["port"], replies["jax"]
    for (method, arg), a, b in zip(SCRIPT + [("GET", "frame"), ("POST", "/cmd2")], port, jax_):
        if arg == "/":
            assert a[0] == b[0] == 200 and a[1] == b[1] == "text/html"
            assert b"/dashboard.png" in a[2] and b"fetch('/cmd'" in a[2]
        else:
            assert a == b, (method, arg, a, b)
    assert port[0][2] == b'{"paused": false, "manual": false, "save_pending": false}'
    assert json.loads(port[2][2]) == {"paused": True, "manual": False, "save_pending": False}
    assert json.loads(port[5][2]) == {"paused": True, "manual": True, "save_pending": True}
    assert port[15][0] == 404 and port[-2] == (200, "image/png", b"\x89PNG frame")
    assert port[16][0] == port[-1][0] == 404
    web, calls, _ = panels["port"]
    assert calls == panels["jax"][1] == ["reset", "recover", "mode vel", "z +0.01",
                                         "z -0.01", "b 0.50"]
    pm = web.hooks.pause_mgr
    assert (pm.paused, pm.manual, pm.save_requested) == (False, True, True)


def test_run_entry_serves_the_panel(tmp_path, monkeypatch):
    """--web-panel 0 in the chunked loop: the URL in the log, a save
    requested through the panel served as a checkpoint before the next
    chunk, and the server stopped at the end of the run."""
    started = []
    orig = WebPanel.start

    def start(self):  # request a save through HTTP as soon as the panel is up
        thread = orig(self)
        started.append(self)
        assert _request(self.port, "/cmd", "save")[2] == b"save requested"
        return thread

    monkeypatch.setattr(WebPanel, "start", start)
    out = str(tmp_path / "run")
    es = cli.main(["--small", "--device", "cpu", "--chunk", "2", "--steps", "4",
                   "--no-post-train", "--save-rate", "100", "--web-panel", "0", "--out", out])
    assert es.explr_step == 4 and len(started) == 1
    d = os.path.join(out, "synth", "entklerg_0000")
    log = open(os.path.join(d, "log.txt")).read()
    assert f"web panel: http://127.0.0.1:{started[0].port}/" in log
    assert "checkpoint saved on panel request" in log
    assert sorted(os.listdir(os.path.join(d, "checkpoints"))) == ["step_0000000",
                                                                  "step_0000004"]
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(f"http://127.0.0.1:{started[0].port}/status", timeout=5)
