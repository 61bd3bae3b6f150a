"""Live interactive viewer: localhost HTTP presenter + WASD/mouse camera.

Counterpart of ``rayaccel_tpu/utils/viewer.py``: the same page, routes
(``/``, ``/frame.png``, ``/stats``, ``/input``) and controls. The
reference's interactive loop is a GLUT window with WASD/mouse camera
controls and a triple-buffered presenter (reference main.cpp:239-282,
DisplayBuffer.cpp:106-132); a headless host serves the framebuffer over
localhost HTTP instead:

- the render loop keeps accumulating progressive samples and publishes
  the latest tonemapped frame (the presenter's buffer swap is a
  bytes-object replacement under a lock);
- every camera input resets progressive accumulation, as the reference's
  spp reset on mouse/WASD movement does (main.cpp:204-205, 248-251);
- the browser page polls /frame.png and posts key/drag events.

Controls (reference main.cpp:253-282): W/S fly forward/back, A/D
strafe, mouse drag to look. After binding, ``Viewer.port`` holds the
port the server listens on, so ``port=0`` takes any free one.
"""

from __future__ import annotations

import dataclasses
import json
import math
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from rayaccel_tpu_torch import rng
from rayaccel_tpu_torch.utils.image import encode_png, tonemap

_PAGE = """<!doctype html>
<html><head><title>rayaccel_tpu live</title><style>
body { background:#111; color:#ccc; font-family:monospace; margin:0 }
#hud { position:fixed; top:8px; left:8px }
img  { display:block; margin:0 auto; image-rendering:pixelated;
       width:100vw; max-height:100vh; object-fit:contain }
</style></head><body>
<div id="hud">WASD: move &nbsp; drag: look &nbsp; <span id="spp"></span></div>
<img id="fb" draggable="false">
<script>
const img = document.getElementById('fb'), spp = document.getElementById('spp');
function refresh() {
  const f = new Image();
  f.onload = () => { img.src = f.src; setTimeout(refresh, 100); };
  f.onerror = () => setTimeout(refresh, 500);
  f.src = '/frame.png?t=' + Date.now();
  fetch('/stats').then(r => r.json()).then(s => {
    spp.textContent = s.spp + ' spp | ' + s.mrays.toFixed(2) + ' Mrays/s';
  }).catch(() => {});
}
refresh();
document.addEventListener('keydown', e => {
  if ('wasd'.includes(e.key)) fetch('/input?key=' + e.key);
});
let drag = null;
img.addEventListener('mousedown', e => drag = [e.clientX, e.clientY]);
window.addEventListener('mouseup', () => drag = null);
window.addEventListener('mousemove', e => {
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  drag = [e.clientX, e.clientY];
  if (dx || dy) fetch(`/input?yaw=${dx}&pitch=${dy}`);
});
</script></body></html>"""


class Viewer:
    """Drives ``renderer`` in a progressive loop while serving the live
    framebuffer on http://127.0.0.1:port/ . Call :meth:`run` (blocking);
    Ctrl-C stops the server and returns."""

    def __init__(self, renderer, base_key, world_up, move_step=0.5,
                 look_speed=0.2, port=8089, max_spp=0):
        self.renderer = renderer
        self.base_key = base_key
        self.world_up = np.asarray(world_up, np.float32)
        self.move_step = float(move_step)
        self.look_speed = float(look_speed)
        self.port = int(port)
        self.max_spp = int(max_spp)     # 0 = accumulate forever
        self._inputs: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._png = encode_png(np.zeros((2, 2, 3), np.uint8))
        self._stats = {"spp": 0, "mrays": 0.0}
        self._stop = threading.Event()

    # -- presenter side -------------------------------------------------
    def _publish(self, mrays):
        img = self.renderer.image()
        png = encode_png(tonemap(img, 1))
        with self._lock:
            self._png = png
            self._stats = {"spp": self.renderer.spp,
                           "mrays": float(mrays)}

    def _make_handler(viewer):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Cache-Control", "no-store")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/":
                    self._send(200, "text/html", _PAGE.encode())
                elif u.path == "/frame.png":
                    with viewer._lock:
                        png = viewer._png
                    self._send(200, "image/png", png)
                elif u.path == "/stats":
                    with viewer._lock:
                        body = json.dumps(viewer._stats).encode()
                    self._send(200, "application/json", body)
                elif u.path == "/input":
                    q = parse_qs(u.query)
                    viewer._inputs.put(q)
                    self._send(200, "text/plain", b"ok")
                else:
                    self._send(404, "text/plain", b"not found")
        return Handler

    # -- camera side ----------------------------------------------------
    def _apply_inputs(self) -> bool:
        """Drain pending inputs into camera moves. Returns True if the
        camera changed (=> accumulation reset, main.cpp:204-205)."""
        moved = False
        cam = self.renderer.camera
        while True:
            try:
                q = self._inputs.get_nowait()
            except queue.Empty:
                break
            if "key" in q:
                k = q["key"][0]
                fwd = cam.forward()
                strafe = fwd * 0.0
                n = np.cross(fwd, self.world_up)
                if np.linalg.norm(n) > 1e-6:
                    strafe = n / np.linalg.norm(n)
                delta = {"w": fwd, "s": -fwd,
                         "a": -strafe, "d": strafe}.get(k)
                if delta is not None:
                    cam = dataclasses.replace(
                        cam, origin=(cam.origin
                                     + delta * self.move_step).astype(
                                         np.float32))
                    moved = True
            if "yaw" in q or "pitch" in q:
                yaw = float(q.get("yaw", ["0"])[0])
                pitch = float(q.get("pitch", ["0"])[0])
                if yaw:
                    cam = cam.rotate(
                        math.radians(-yaw * self.look_speed), self.world_up)
                if pitch:
                    right = np.cross(cam.forward(), self.world_up)
                    if np.linalg.norm(right) > 1e-6:
                        cam = cam.rotate(
                            math.radians(-pitch * self.look_speed), right)
                moved = True
        if moved:
            self.renderer.set_camera(cam)
        return moved

    # -- main loop ------------------------------------------------------
    def run(self, quiet=False):
        server = ThreadingHTTPServer(("127.0.0.1", self.port),
                                     self._make_handler())
        self.port = server.server_address[1]
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        if not quiet:
            print(f"live viewer: http://127.0.0.1:{self.port}/ "
                  "(Ctrl-C to stop)")
        try:
            while not self._stop.is_set():
                self._apply_inputs()
                if self.max_spp and self.renderer.spp >= self.max_spp:
                    time.sleep(0.05)
                    continue
                t0 = time.perf_counter()
                key = rng.fold_in(self.base_key, self.renderer.spp)
                stats = self.renderer.render_frame(key)
                rays = int(stats.rays_traced)       # sync
                dt = time.perf_counter() - t0
                self._publish(rays / dt / 1e6)
        except KeyboardInterrupt:
            pass
        finally:
            server.shutdown()
            server.server_close()
        return 0

    def stop(self):
        self._stop.set()
