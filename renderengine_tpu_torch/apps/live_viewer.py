"""Live interactive viewer — the reference's windowed session over HTTP.

The reference is a GLFW window + ImGui options panel
(``Source/Samples/MainSample/main.cpp:22-206``, ``Window.cpp:7-74``,
``ImGuiVulkan.cpp:66-133``). This headless environment has no display, so
the present seam (``RenderLoop.on_present``) feeds a browser instead:

- ``GET /``        a page showing the stream and capturing key/mouse events
- ``GET /stream``  multipart/x-mixed-replace PNG stream (MJPEG-style)
- ``POST /input``  JSON event batches -> ``InputSystem`` (the GLFW-callback
                   analog: keys, cursor, scroll, buttons)
- ``GET /stats``   live fps/config JSON

Runtime options (the ImGui panel's role, ``main.cpp:93-144``): ``[``/``]``
exposure down/up, ``0``-``7`` debug input views, ``F1``-``F5`` BRDF debug
equations (``F6`` clears), ``g`` grid toggle, plus the CameraController's
orbit/free scheme (drag, WASD, F toggle, scroll zoom).

Only the loop thread renders; the HTTP handler threads touch the encoded
PNG frames and the event queue alone. Frames render on the CUDA card
unless ``--device`` names another device.

Usage:
    python -m renderengine_tpu_torch.apps.live_viewer --scenePath cube \
        --port 8412
then open http://localhost:8412/
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..core.config import DebugEquation, DebugInput, RenderConfig
from ..graph.render_loop import RenderLoop
from ..scene.camera import ViewProperties
from ..scene.camera_controller import CameraController
from ..scene.input import InputSystem
from ..utils import png

_PAGE = """<!DOCTYPE html>
<html><head><title>renderengine_tpu_torch</title><style>
body { margin:0; background:#111; color:#ccc; font:13px monospace; }
#v { display:block; margin:0 auto; outline:none; }
#bar { padding:4px 8px; }
</style></head><body>
<div id="bar">renderengine_tpu_torch live viewer &mdash; drag: orbit/look,
WASD: move (free cam), F: toggle cam, scroll: zoom, [ ]: exposure,
0-7: debug view, F1-F6: BRDF terms, g: grid &mdash; <span id="fps"></span></div>
<img id="v" src="/stream" tabindex="0">
<script>
const q = [];
function post() {
  if (!q.length) return;
  const batch = q.splice(0, q.length);
  fetch("/input", {method: "POST", body: JSON.stringify(batch)});
}
setInterval(post, 33);
setInterval(async () => {
  try { const s = await (await fetch("/stats")).json();
        document.getElementById("fps").textContent = s.fps.toFixed(1) + " fps"; }
  catch (e) {}
}, 1000);
const v = document.getElementById("v");
v.focus();
document.addEventListener("keydown", e => {
  if (e.repeat) return;
  q.push({t: "key", k: e.key, a: 0}); e.preventDefault();
});
document.addEventListener("keyup", e => { q.push({t: "key", k: e.key, a: 1}); });
v.addEventListener("mousemove", e => {
  const r = v.getBoundingClientRect();
  q.push({t: "cursor", x: e.clientX - r.left, y: e.clientY - r.top});
});
v.addEventListener("mousedown", e => {
  q.push({t: "button", b: e.button === 2 ? "right" : "left", d: true});
  e.preventDefault();
});
v.addEventListener("mouseup", e => {
  q.push({t: "button", b: e.button === 2 ? "right" : "left", d: false});
});
v.addEventListener("wheel", e => {
  q.push({t: "scroll", dx: 0, dy: e.deltaY > 0 ? -1 : 1}); e.preventDefault();
});
v.addEventListener("contextmenu", e => e.preventDefault());
</script></body></html>"""


class LiveViewer:
    """Owns the render loop, the input plumbing and the HTTP present."""

    def __init__(self, scene, config: RenderConfig, port: int = 8412,
                 backend: str | None = None, target_fps: float = 60.0,
                 host: str = "127.0.0.1", device=None):
        self.scene = scene
        self.config = config
        self.port = port
        self.host = host  # loopback by default: the viewer exposes camera/
        # config control and the frame stream; pass --host 0.0.0.0 to
        # deliberately serve the network
        self.inputs = InputSystem()
        self.controller = CameraController(scene.camera,
                                           viewport=(config.width, config.height))
        self.events: queue.Queue = queue.Queue()
        self.debug_input = DebugInput.NONE
        self.debug_equation = DebugEquation.NONE
        self._frame_lock = threading.Condition()
        self._frame_png: bytes | None = None
        self._frame_seq = 0
        self._stop = threading.Event()
        self.loop = RenderLoop(scene, config, on_update=self._update,
                               on_present=self._present, target_fps=target_fps,
                               backend=backend,
                               view_props_fn=self._view_props,
                               device=device)
        self._server = None

    # --- render thread side ------------------------------------------------

    def _drain_events(self) -> None:
        while True:
            try:
                e = self.events.get_nowait()
            except queue.Empty:
                return
            t = e.get("t")
            if t == "key":
                self._on_key(e.get("k", ""), int(e.get("a", 0)))
            elif t == "cursor":
                self.inputs.on_cursor(e.get("x", 0), e.get("y", 0))
            elif t == "scroll":
                self.inputs.on_scroll(e.get("dx", 0), e.get("dy", 0))
            elif t == "button":
                self.inputs.on_mouse_button(e.get("b", "left"),
                                            bool(e.get("d")))

    def _on_key(self, key: str, action: int) -> None:
        if action == 0:   # pressed edge: runtime options (the ImGui panel)
            if key == "[":
                self.scene.camera.exposure = max(
                    0.05, self.scene.camera.exposure / 1.25)
            elif key == "]":
                self.scene.camera.exposure = min(
                    20.0, self.scene.camera.exposure * 1.25)
            elif key.isdigit() and int(key) <= 7:
                self.debug_input = DebugInput(int(key))
            elif key in ("F1", "F2", "F3", "F4", "F5"):
                self.debug_equation = DebugEquation(int(key[1]))
            elif key == "F6":
                self.debug_equation = DebugEquation.NONE
            elif key == "g":
                self.loop.drain()
                self.loop.config = self.loop.config.replace(
                    grid=not self.loop.config.grid)
                from ..graph.frame import FrameRenderer
                self.loop.renderer = FrameRenderer(
                    self.scene, self.loop.config, device=self.loop.device,
                    backend=self.loop.renderer.backend)
        self.inputs.on_key(key.lower() if len(key) == 1 else key, action)

    def _update(self, dt: float) -> bool:
        if self._stop.is_set():
            return False
        self._drain_events()
        fi = self.inputs.get_frame_inputs()
        self.controller.update(dt, fi)
        self.inputs.end_frame()
        return True

    def _view_props(self) -> ViewProperties:
        return ViewProperties.from_camera(
            self.scene.camera, debug_input=self.debug_input,
            debug_equation=self.debug_equation)

    def _present(self, frame: np.ndarray) -> None:
        data = png.encode_png(frame)
        with self._frame_lock:
            self._frame_png = data
            self._frame_seq += 1
            self._frame_lock.notify_all()

    # --- HTTP side ---------------------------------------------------------

    def _make_handler(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path == "/":
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=frame")
                    self.end_headers()
                    seen = -1
                    try:
                        while not viewer._stop.is_set():
                            with viewer._frame_lock:
                                viewer._frame_lock.wait_for(
                                    lambda: viewer._frame_seq != seen
                                    or viewer._stop.is_set(), timeout=1.0)
                                data = viewer._frame_png
                                seen = viewer._frame_seq
                            if data is None:
                                continue
                            self.wfile.write(
                                b"--frame\r\nContent-Type: image/png\r\n"
                                b"Content-Length: " + str(len(data)).encode()
                                + b"\r\n\r\n" + data + b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                elif self.path == "/stats":
                    body = json.dumps({
                        "fps": viewer.loop.fps(),
                        "frame": viewer.loop.frame_index,
                        "exposure": float(viewer.scene.camera.exposure),
                        "debug_input": int(viewer.debug_input),
                        "backend": viewer.loop.renderer.backend,
                        "device": str(viewer.loop.device),
                    }).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_error(404)

            def do_POST(self):
                if self.path == "/input":
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        for e in json.loads(self.rfile.read(n) or b"[]"):
                            viewer.events.put(e)
                    except (ValueError, TypeError):
                        pass
                    self.send_response(204)
                    self.end_headers()
                else:
                    self.send_error(404)

        return Handler

    def start_server(self) -> int:
        """Start the HTTP server (daemon thread); returns the bound port."""
        self._server = ThreadingHTTPServer((self.host, self.port),
                                           self._make_handler())
        self.port = self._server.server_address[1]
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()
        return self.port

    def run(self, max_frames: int | None = None) -> None:
        self.start_server()
        print(f"live viewer at http://localhost:{self.port}/")
        try:
            self.loop.run(max_frames)
        finally:
            self.stop()

    def stop(self) -> None:
        self._stop.set()
        with self._frame_lock:
            self._frame_lock.notify_all()
        if self._server:
            self._server.shutdown()
            self._server = None


def main(argv=None) -> int:
    from ..core.args import ArgumentParser
    from ..core import asset_path, engine
    from ..scene.loader import load_scene

    parser = ArgumentParser(description="live_viewer.py — browser viewer")
    parser.add_option("gameDir", "game assets directory (/Game/... root)")
    parser.add_option("scenePath", "scene file or builtin (cube, sponza)")
    parser.add_option("width", "framebuffer width (default 800)")
    parser.add_option("height", "framebuffer height (default 600)")
    parser.add_option("port", "HTTP port (default 8412)")
    parser.add_option("shadowExtent", "shadow map resolution (default 2048)")
    parser.add_option("fps", "target fps (default 60)")
    parser.add_option("host", "bind address (default 127.0.0.1; use "
                      "0.0.0.0 to expose on the network)")
    parser.add_option("device", "torch device (default cuda; cpu runs the "
                      "kernels' plain versions)")
    parser.add_option("frames", "stop after this many frames (default: run "
                      "until interrupted)")
    if not parser.parse(argv):
        return -1
    device = engine.init(parser.get_string("device"))
    if parser.has("gameDir"):
        asset_path.set_game_directory(parser.get_string("gameDir"))
    asset_path.set_engine_directory(asset_path.default_engine_directory())

    width = parser.get_int("width", 800)
    height = parser.get_int("height", 600)
    scene = load_scene(parser.get_string("scenePath", "cube"))
    scene.camera.set_image_extent(width, height)
    cfg = RenderConfig(width=width, height=height,
                       shadow_extent=parser.get_int("shadowExtent", 2048))
    frames = parser.get_int("frames", 0)
    LiveViewer(scene, cfg, port=parser.get_int("port", 8412),
               target_fps=parser.get_float("fps", 60.0),
               host=parser.get_string("host", "127.0.0.1"),
               device=device).run(frames or None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
