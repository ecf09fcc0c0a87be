"""Browser control panel (a stdlib-only copy of
``ealv_tpu/runtime/webpanel.py``): a small HTTP server over the same
``ControlHooks`` surface as the stdin ``ControlPanel``, serving the live
dashboard frame beside the controls, so one browser tab is the operator's
station on a machine with no display.

Endpoints:
  GET  /               control page (auto-refreshing dashboard + buttons)
  GET  /dashboard.png  latest dashboard frame from the run dir
  GET  /status         JSON of the pause/manual/save flags
  POST /cmd            body = one ControlPanel command line ("pause",
                       "mode vel", "b 0.5", ... the CLI panel's grammar)
"""

from __future__ import annotations

import io
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .panel import ControlHooks, ControlPanel

_PAGE = """<!doctype html>
<html><head><title>ealv_tpu_torch control panel</title>
<style>
 body {{ background:#14151a; color:#ddd; font:14px sans-serif; margin:1.2em }}
 button {{ margin:2px; padding:6px 12px; background:#2a2d36; color:#ddd;
          border:1px solid #444; border-radius:4px; cursor:pointer }}
 button:hover {{ background:#3a3f4d }}
 img {{ max-width:100%; border:1px solid #333; margin-top:0.8em }}
 #status {{ color:#8fc; margin-left:1em }}
</style></head>
<body>
<div>
 <button onclick="cmd('pause')">pause</button>
 <button onclick="cmd('resume')">resume</button>
 <button onclick="cmd('manual')">manual</button>
 <button onclick="cmd('save')">save</button>
 <button onclick="cmd('reset')">reset</button>
 <button onclick="cmd('recover')">recover</button>
 <button onclick="cmd('mode pose')">mode pose</button>
 <button onclick="cmd('mode vel')">mode vel</button>
 <button onclick="cmd('z up')">z+</button>
 <button onclick="cmd('z down')">z-</button>
 <input id="b" type="range" min="0" max="1" step="0.05" value="1"
        onchange="cmd('b '+this.value)"> brightness
 <span id="status"></span>
</div>
<img id="dash" src="/dashboard.png">
<script>
 function cmd(c) {{
   fetch('/cmd', {{method:'POST', body:c}})
     .then(r => r.text()).then(t => status.innerText = t);
 }}
 setInterval(() => {{
   dash.src = '/dashboard.png?' + Date.now();
   fetch('/status').then(r => r.json())
     .then(s => status.innerText = JSON.stringify(s));
 }}, 2000);
</script>
</body></html>
"""


class WebPanel:
    """Serve ControlHooks + the run dir's dashboard over HTTP."""

    def __init__(self, hooks: ControlHooks, run_dir: Optional[str] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.hooks = hooks
        self.run_dir = run_dir
        # reuse the CLI panel's command grammar/dispatch
        self._out = io.StringIO()
        self._panel = ControlPanel(hooks, inp=io.StringIO(), out=self._out)
        panel = self._panel
        out = self._out
        lock = threading.Lock()
        web = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, body, ctype="text/plain"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    self._send(200, _PAGE.encode(), "text/html")
                elif path == "/status":
                    h = web.hooks.pause_mgr
                    self._send(200, json.dumps({
                        "paused": h.paused, "manual": h.manual,
                        "save_pending": h.save_requested,
                    }).encode(), "application/json")
                elif path == "/dashboard.png" and web.run_dir:
                    f = os.path.join(web.run_dir, "dashboard.png")
                    if os.path.exists(f):
                        with open(f, "rb") as fh:
                            self._send(200, fh.read(), "image/png")
                    else:
                        self._send(404, b"no dashboard yet")
                else:
                    self._send(404, b"not found")

            def do_POST(self):
                if self.path != "/cmd":
                    self._send(404, b"not found")
                    return
                n = int(self.headers.get("Content-Length", 0))
                line = self.rfile.read(n).decode()
                with lock:  # one command at a time through the shared reply buffer
                    out.seek(0)
                    out.truncate()
                    panel.handle(line)
                    reply = out.getvalue().strip().encode()
                self._send(200, reply)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> threading.Thread:
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self._thread

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
