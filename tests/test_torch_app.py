"""The port's apps on the CPU (``--device cpu``): ``main_sample`` against
the JAX package's ``main_sample``, its orbit/HUD and texture-space runs,
``live_viewer``'s page, stream and input round trip, and the editor's
project wizard.

Tolerance: the app frame meets the golden bar against the JAX app's
frame (within 1/255 on >= 99.9% of pixels, max 4/255); measured
identical on the ``cube`` scene. The JAX app renders its frame inside
``jit``; fault F1's class (fused rounding flipping a sampling decision)
does not show on this scene."""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from renderengine_tpu.apps import main_sample as jmain

from renderengine_tpu_torch.apps import editor, main_sample
from renderengine_tpu_torch.apps.live_viewer import LiveViewer
from renderengine_tpu_torch.apps.project import ProjectSettings, ProjectWizard
from renderengine_tpu_torch.core import asset_path
from renderengine_tpu_torch.core.config import RenderConfig
from renderengine_tpu_torch.graph.frame import FrameRenderer
from renderengine_tpu_torch.scene import procedural
from renderengine_tpu_torch.tools import goldens
from renderengine_tpu_torch.utils import png

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _asset_roots():
    yield
    asset_path.set_engine_directory(asset_path.default_engine_directory())


def test_main_sample_matches_the_jax_app(tmp_path):
    mine, ref = tmp_path / "mine.png", tmp_path / "jax.png"
    common = ["--scenePath", "cube", "--width", "128", "--height", "96",
              "--frames", "1"]
    assert main_sample.main(common + ["--device", "cpu",
                                      "--out", str(mine)]) == 0
    assert jmain.main(common + ["--out", str(ref)]) == 0
    a, b = png.read_png(str(mine)), png.read_png(str(ref))
    assert a.shape == (96, 128, 4) and a.dtype == np.uint8
    frac, mx = goldens.golden_bar(a, b)
    assert goldens.meets_bar(frac, mx), (frac, mx)


def test_main_sample_frame_is_the_renderers(tmp_path):
    """The app's frame is ``FrameRenderer.render()``'s for its config:
    byte for byte."""
    out = tmp_path / "f.png"
    assert main_sample.main(["--scenePath", "cube", "--width", "64",
                             "--height", "48", "--frames", "1",
                             "--device", "cpu", "--out", str(out)]) == 0
    sc = procedural.cube_scene()
    sc.camera.set_image_extent(64, 48)
    cfg = RenderConfig(width=64, height=48, shadow_extent=2048)
    img, _ = FrameRenderer(sc, cfg, device="cpu").render()
    np.testing.assert_array_equal(png.read_png(str(out)), img.numpy())


def test_main_sample_orbit_hud(tmp_path, capsys):
    out = tmp_path / "o.png"
    assert main_sample.main(["--scenePath", "cube", "--width", "96",
                             "--height", "64", "--frames", "3", "--orbit",
                             "--hud", "--shadowExtent", "64", "--device",
                             "cpu", "--out", str(out)]) == 0
    frames = [png.read_png(str(tmp_path / f"o_{i:04d}.png"))
              for i in range(3)]
    assert "3 frame(s) of 12 tris at 96x64" in capsys.readouterr().out
    # the orbit moved the camera; the HUD text is burned in yellow
    assert (frames[0] != frames[2]).any()
    for f in frames:
        hud = f[4:18, 4:90, :3].astype(int)
        assert ((hud == (255, 255, 64)).all(-1)).sum() > 20


def test_main_sample_texture_space(tmp_path):
    """``--textureSpace`` renders the factored texture-space frame (K2's
    plain version here), the same as its renderer."""
    out = tmp_path / "t.png"
    assert main_sample.main(["--scenePath", "cube", "--width", "64",
                             "--height", "48", "--frames", "2",
                             "--textureSpace", "--shadowExtent", "64",
                             "--device", "cpu", "--out", str(out)]) == 0
    got = png.read_png(str(tmp_path / "t_0001.png"))
    sc = procedural.cube_scene()
    sc.camera.set_image_extent(64, 48)
    cfg = RenderConfig(width=64, height=48, shadow_extent=64,
                       texture_space=True, debug_views=False)
    img, _ = FrameRenderer(sc, cfg, device="cpu").render()
    np.testing.assert_array_equal(got, img.numpy())


def test_main_sample_help_and_default_device(monkeypatch):
    assert main_sample.main(["--help"]) == -1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_sample.main(["--scenePath", "cube", "--frames", "1"])


@pytest.fixture
def viewer():
    sc = procedural.cube_scene(width=96, height=64)
    cfg = RenderConfig(width=96, height=64, shadow_extent=32,
                       translucency=False)
    v = LiveViewer(sc, cfg, port=0, target_fps=0.0, device="cpu")
    v.start_server()
    yield v
    v.stop()


def _url(v, path):
    return f"http://127.0.0.1:{v.port}{path}"


def test_live_viewer_page_stream_and_input_roundtrip(viewer):
    """Mirrors tests/test_live_viewer.py on the port's viewer."""
    page = urllib.request.urlopen(_url(viewer, "/"), timeout=5).read()
    assert b"/stream" in page and b"/input" in page
    events = [
        {"t": "button", "b": "right", "d": True},
        {"t": "cursor", "x": 10.0, "y": 10.0},
        {"t": "cursor", "x": 40.0, "y": 18.0},
        {"t": "scroll", "dx": 0, "dy": 1},
        {"t": "key", "k": "]", "a": 0},
        {"t": "key", "k": "g", "a": 0},          # grid on: a new renderer
    ]
    req = urllib.request.Request(_url(viewer, "/input"),
                                 data=json.dumps(events).encode(),
                                 method="POST")
    assert urllib.request.urlopen(req, timeout=5).status == 204
    fov0 = viewer.scene.camera.fov_degrees
    eye0 = np.asarray(viewer.scene.camera.eye).copy()
    exp0 = viewer.scene.camera.exposure
    got = {}

    def read_stream():
        r = urllib.request.urlopen(_url(viewer, "/stream"), timeout=30)
        assert r.headers["Content-Type"].startswith(
            "multipart/x-mixed-replace")
        assert r.readline().strip() == b"--frame"
        headers = {}
        while True:
            h = r.readline().strip()
            if not h:
                break
            k, _, val = h.partition(b":")
            headers[k.lower()] = val.strip()
        got["png"] = r.read(int(headers[b"content-length"]))

    t = threading.Thread(target=read_stream)
    t.start()
    for _ in range(4):
        assert viewer._update(1 / 60) is True
        viewer.loop.render_one()
    viewer.loop.drain()
    t.join(timeout=30)
    assert not t.is_alive()
    assert got["png"][:8] == b"\x89PNG\r\n\x1a\n"
    assert not np.allclose(np.asarray(viewer.scene.camera.eye), eye0)
    assert viewer.scene.camera.fov_degrees != fov0
    assert viewer.scene.camera.exposure > exp0
    assert viewer.loop.config.grid and viewer.loop.renderer.config.grid
    stats = json.loads(urllib.request.urlopen(
        _url(viewer, "/stats"), timeout=5).read())
    assert stats["frame"] >= 4 and stats["device"] == "cpu"


def test_editor_and_project_wizard(tmp_path, capsys):
    """Mirrors tests/test_scene_io.py's TestProject, and drives the editor
    app through the wizard and back."""
    settings = ProjectWizard.create_new_project(tmp_path / "proj", "MyGame")
    assert (tmp_path / "proj" / "MyGame.rproj").exists()
    assert (tmp_path / "proj" / "Assets").is_dir()
    loaded = ProjectSettings.from_file(tmp_path / "proj" / "MyGame.rproj")
    assert loaded.project_name == "MyGame"
    assert loaded.assets_dir == settings.assets_dir
    assert editor.main(["--new-project", str(tmp_path / "p2"),
                        "--name", "Other"]) == 0
    assert editor.main(["--project", str(tmp_path / "p2" / "Other.rproj")]) == 0
    out = capsys.readouterr().out
    assert "created project 'Other'" in out and "opened project 'Other'" in out
    assert asset_path.get_game_directory() == tmp_path / "p2"
