"""The viewer app — parity with ``Source/Samples/MainSample/main.cpp``:
CLI (``--gameDir``, ``--scenePath``, ``main.cpp:165-181``), scene load,
orbit/free camera, frame loop with exposure/debug-view options, offscreen
output (PNG frames stand in for the swapchain present).

It renders on the CUDA card unless ``--device`` names another device
(``--device cpu`` runs every kernel's plain PyTorch version).

Examples:
    python -m renderengine_tpu_torch.apps.main_sample --scenePath sponza \
        --width 1920 --height 1080 --frames 5 --out /tmp/frame.png
    python -m renderengine_tpu_torch.apps.main_sample --scenePath cube \
        --width 128 --height 96 --frames 1 --device cpu --out /tmp/frame.png
    python -m renderengine_tpu_torch.apps.main_sample \
        --scenePath /Game/scene.gltf --gameDir ~/mygame --frames 60 --orbit \
        --out /tmp/anim.png
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

from ..core import asset_path
from ..core.args import ArgumentParser
from ..core.config import DebugEquation, DebugInput, RenderConfig
from ..graph.render_loop import RenderLoop
from ..scene.camera import ViewProperties
from ..scene.camera_controller import CameraController
from ..scene.input import InputSystem
from ..scene.loader import load_scene
from ..utils import png


def main(argv=None) -> int:
    parser = ArgumentParser(description="main_sample.py — the sample viewer")
    parser.add_option("gameDir", "game assets directory (/Game/... root)")
    parser.add_option("scenePath", "scene file or builtin (cube, sponza)")
    parser.add_option("width", "framebuffer width (default 800)")
    parser.add_option("height", "framebuffer height (default 600)")
    parser.add_option("frames", "number of frames to render (default 1)")
    parser.add_option("out", "output PNG path (frame index is appended for >1)")
    parser.add_option("orbit", "orbit the camera over the frames")
    parser.add_option("exposure", "exposure multiplier (default 1.0)")
    parser.add_option("debugInput", "debug view: 1..7 (see DebugInput)")
    parser.add_option("debugEquation", "BRDF term view: 1..5")
    parser.add_option("shadowExtent", "shadow map resolution (default 2048)")
    parser.add_option("noShadows", "disable the shadow pass")
    parser.add_option("fps", "pace the loop to this fps (default off)")
    parser.add_option("textureSpace", "light-chart (texture-space) shading:"
                      " lighting at chart resolution, full-res albedo")
    parser.add_option("chartDensity", "chart texels per screen pixel along"
                      " one axis at the layout camera (default 0.5)")
    parser.add_option("hud", "burn an FPS/stats HUD into the frames")
    parser.add_option("device", "torch device (default cuda; cpu runs the "
                      "kernels' plain versions)")
    if not parser.parse(argv):
        return -1

    from ..core import engine
    device = engine.init(parser.get_string("device"))

    if parser.has("gameDir"):
        asset_path.set_game_directory(parser.get_string("gameDir"))
    asset_path.set_engine_directory(asset_path.default_engine_directory())

    width = parser.get_int("width", 800)
    height = parser.get_int("height", 600)
    scene = load_scene(parser.get_string("scenePath", "cube"))
    scene.camera.set_image_extent(width, height)
    scene.camera.exposure = parser.get_float("exposure", 1.0)

    config = RenderConfig(
        width=width, height=height,
        shadow_extent=parser.get_int("shadowExtent", 2048),
        shadows=not parser.get_bool("noShadows"),
        texture_space=parser.get_bool("textureSpace"),
        chart_density=parser.get_float("chartDensity", 0.5),
        # the factored TSS screen pass has no debug taps (lightchart.py)
        debug_views=not parser.get_bool("textureSpace"),
    )

    frames = parser.get_int("frames", 1)
    out = parser.get_string("out", "/tmp/main_sample.png")
    debug_input = DebugInput(parser.get_int("debugInput", 0))
    debug_equation = DebugEquation(parser.get_int("debugEquation", 0))
    orbit = parser.get_bool("orbit")

    inputs = InputSystem()
    controller = CameraController(scene.camera, viewport=(width, height))
    saved = []

    def on_update(dt):
        controller.update(dt, inputs.get_frame_inputs())
        inputs.end_frame()
        if orbit:
            # synthesize an orbit drag: one viewport-width over the run
            inputs.on_mouse_button("right", True)
            x, y = inputs.get_frame_inputs().cursor_pos
            inputs.on_cursor(x + width / max(frames, 1) * 0.25, y)
        return True

    hud_on = parser.get_bool("hud")

    def on_present(frame: np.ndarray):
        if hud_on:
            from ..utils import hud
            frame = np.ascontiguousarray(frame)
            fps_now = loop.fps()
            hud.draw_stats(frame, fps_now, 1000.0 / max(fps_now, 1e-6),
                           scene.meshes.triangle_count)
        path = out if frames == 1 else str(Path(out).with_suffix("")) + f"_{len(saved):04d}.png"
        png.write_png(path, frame)
        saved.append(path)

    def view_props():
        return ViewProperties.from_camera(scene.camera, debug_input=debug_input,
                                          debug_equation=debug_equation)

    loop = RenderLoop(scene, config, on_update=on_update, on_present=on_present,
                      target_fps=parser.get_float("fps", 0.0),
                      view_props_fn=view_props, device=device)
    t0 = time.time()
    loop.run(max_frames=frames)
    dt = time.time() - t0
    n_tris = scene.meshes.triangle_count
    print(f"{frames} frame(s) of {n_tris} tris at {width}x{height} in {dt:.2f}s "
          f"({frames / max(dt, 1e-9):.2f} FPS incl. set-up) -> {saved[-1] if saved else out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
