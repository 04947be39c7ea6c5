"""The port's host-side asset path against the JAX package's: scene
loaders (OBJ+MTL, glTF, GLB, Collada, binary FBX), CLI parsing, virtual
asset roots, input and the camera controller, EXR reading, the HDRI
environment capture (``shading/ibl.py``, a gather on the device) and JPEG
decoding through ``utils/image.py``.

Tolerances: loaders, EXR, the u8 skybox and JPEG decoding are exact (the
port's copies run the same numpy and the same native code);
``render_environment_map`` is within 1e-6 (absolute) of the JAX
package's on >= 95% of the values and within 2e-5 on all of them, on a
random HDRI in [0, 4): torch's and XLA's f32 ``atan2``/``asin`` differ in
the last bit on some directions, which moves a bilinear weight by up to
3e-6 at 48 texels a row, times a neighbour contrast of up to 4 (measured:
96.9% within 1e-6, max 1.12e-5)."""

import io
import struct
import zlib

import numpy as np
import pytest
import torch

from renderengine_tpu.core import args as jargs
from renderengine_tpu.core import asset_path as jasset
from renderengine_tpu.scene import camera as jcam
from renderengine_tpu.scene import camera_controller as jctl
from renderengine_tpu.scene import input as jinput
from renderengine_tpu.scene.loader import load_scene as jload
from renderengine_tpu.shading import ibl as jibl
from renderengine_tpu.utils import exr as jexr
from renderengine_tpu.utils import image as jimage

from renderengine_tpu_torch import native
from renderengine_tpu_torch.core import args, asset_path
from renderengine_tpu_torch.scene import procedural
from renderengine_tpu_torch.scene.camera import Camera
from renderengine_tpu_torch.scene.camera_controller import CameraController
from renderengine_tpu_torch.scene.input import InputSystem, KeyAction
from renderengine_tpu_torch.scene.loader import load_scene
from renderengine_tpu_torch.scene.materials import (AlphaMode,
                                                    material_handle_index)
from renderengine_tpu_torch.shading import ibl
from renderengine_tpu_torch.utils import exr, image, png

from test_asset_e2e import _write_full_texture_gltf
from test_scene_formats import DAE_CUBE, _write_fbx
from test_scene_io import _minimal_gltf

torch.set_num_threads(2)


def _same_upload(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def _obj_with_texture(tmp_path, rng):
    tex = rng.integers(0, 255, (16, 8, 3), dtype=np.uint8)
    png.write_png(str(tmp_path / "albedo.png"), tex)
    (tmp_path / "box.mtl").write_text(
        "newmtl red\nKd 1 0 0\nNs 50\nNi 1.5\nd 0.5\nmap_Kd albedo.png\n"
        "newmtl grey\nKd 0.5 0.5 0.5\n")
    (tmp_path / "box.obj").write_text(
        "mtllib box.mtl\n"
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\n"
        "vn 0 0 1\nvt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "usemtl red\nf 1/1/1 2/2/1 3/3/1 4/4/1\n"
        "usemtl grey\nf -1 -2 -3\n")
    return tmp_path / "box.obj"


def _glb(tmp_path):
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    idx = np.array([0, 1, 2, 0], np.uint16)
    blob = pos.tobytes() + idx.tobytes()
    import json
    gltf = {
        "asset": {"version": "2.0"}, "scene": 0,
        "scenes": [{"nodes": [0]}], "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0},
                                    "indices": 1}]}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5123, "count": 3,
             "type": "SCALAR"}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": 36},
                        {"buffer": 0, "byteOffset": 36, "byteLength": 6}],
        "buffers": [{"byteLength": len(blob)}],
    }
    jsn = json.dumps(gltf).encode()
    jsn += b" " * ((4 - len(jsn) % 4) % 4)
    glb = struct.pack("<III", 0x46546C67, 2, 0)
    glb += struct.pack("<II", len(jsn), 0x4E4F534A) + jsn
    glb += struct.pack("<II", len(blob), 0x004E4942) + blob
    glb = glb[:8] + struct.pack("<I", len(glb)) + glb[12:]
    p = tmp_path / "tri.glb"
    p.write_bytes(glb)
    return p


def _fixture(fmt, tmp_path, rng):
    if fmt == "obj":
        return _obj_with_texture(tmp_path, rng)
    if fmt == "gltf":
        return _minimal_gltf(tmp_path)
    if fmt == "gltf_textured":
        return _write_full_texture_gltf(tmp_path)[0]
    if fmt == "glb":
        return _glb(tmp_path)
    if fmt == "dae":
        (tmp_path / "scene.dae").write_text(DAE_CUBE)
        return tmp_path / "scene.dae"
    _write_fbx(tmp_path / "scene.fbx")
    return tmp_path / "scene.fbx"


@pytest.mark.parametrize("fmt", ["obj", "gltf", "gltf_textured", "glb",
                                 "dae", "fbx"])
def test_loaders_match_jax(fmt, tmp_path, rng):
    """``load_scene(path).upload()`` equals the JAX package's key by key,
    exactly; the camera the loader framed too."""
    path = _fixture(fmt, tmp_path, rng)
    mine, ref = load_scene(path), jload(path)
    assert mine.meshes.triangle_count == ref.meshes.triangle_count > 0
    np.testing.assert_array_equal(mine.camera.eye, ref.camera.eye)
    np.testing.assert_array_equal(mine.camera.look_at, ref.camera.look_at)
    _same_upload(mine.upload(), ref.upload())


def test_obj_mtl_semantics(tmp_path, rng):
    """The OBJ/MTL loader (mirrors tests/test_scene_io.py): the v flip,
    BLEND from ``d 0.5``, f0 from ``Ni``, a loaded base-color texture,
    quad triangulation and negative indices."""
    sc = load_scene(_obj_with_texture(tmp_path, rng))
    assert sc.meshes.triangle_count == 3
    pos, nrm, uv, vert_node, tri_vidx, tri_mat, _ = sc.meshes.build_arrays()
    assert uv[2, 1] == -1.0
    inst = sc.materials.instances[material_handle_index(int(tri_mat[0]))]
    assert inst.alpha_mode == AlphaMode.BLEND
    assert inst.properties.f0 == pytest.approx(0.04, rel=0.01)
    assert inst.properties.base_color_texture >= 0 and len(sc.textures) == 1


def test_obj_python_fallback_matches_jax(tmp_path, rng, monkeypatch):
    """Without the native tokenizer the OBJ loader takes its pure-Python
    path (host asset parsing, kept as the JAX package has it; it shares
    vertices where the native path emits one per corner) and equals the
    JAX package's Python path exactly."""
    from renderengine_tpu import native as jnative
    path = _obj_with_texture(tmp_path, rng)
    monkeypatch.setattr(native, "parse_obj", lambda p: None)
    monkeypatch.setattr(jnative, "parse_obj", lambda p: None)
    mine, ref = load_scene(path), jload(path)
    assert mine.meshes.vertex_count == 7       # 4 + 3, per mesh
    _same_upload(mine.upload(), ref.upload())


def test_ascii_fbx_rejected(tmp_path):
    f = tmp_path / "scene.fbx"
    f.write_text("; FBX 7.4.0 project file\nFBXHeaderExtension:  {\n}\n")
    with pytest.raises(ValueError, match="ASCII FBX"):
        load_scene(f)


def test_builtin_scenes_and_unknown_format(tmp_path):
    assert load_scene("cube").meshes.triangle_count == 12
    (tmp_path / "x.stl").write_text("solid")
    with pytest.raises(ValueError, match="unsupported scene format"):
        load_scene(tmp_path / "x.stl")


class TestArgsAndAssetPath:
    """Mirrors tests/test_core.py's TestArgs and TestAssetPath."""

    @pytest.mark.parametrize("argv", [
        ["--gameDir", "/tmp/g", "--scenePath", "s.obj", "--fast"],
        ["--width", "7", "--exposure", "1.5", "--flag", "--x", "no"]])
    def test_parse_like_jax(self, argv):
        p, q = args.ArgumentParser(), jargs.ArgumentParser()
        assert p.parse(argv) and q.parse(argv)
        assert p._values == q._values
        for k in ("gameDir", "scenePath", "fast", "width", "flag", "x"):
            assert p.get_string(k) == q.get_string(k)
            assert p.get_bool(k) == q.get_bool(k)
        assert p.get_int("missing", 7) == 7

    def test_help_returns_false(self):
        p = args.ArgumentParser(description="x")
        p.add_option("gameDir", "game dir")
        assert not p.parse(["--help"])
        assert "--gameDir" in p.help_text()

    def test_engine_and_game_roots(self, tmp_path):
        asset_path.set_engine_directory(tmp_path / "eng")
        asset_path.set_game_directory(tmp_path / "game")
        try:
            p = asset_path.AssetPath("/Engine/Textures/sky.png")
            assert p.get_path_on_disk() == tmp_path / "eng" / "Textures/sky.png"
            g = asset_path.AssetPath("/Game/scene.gltf")
            assert g.get_path_on_disk() == tmp_path / "game" / "scene.gltf"
            plain = asset_path.AssetPath(str(tmp_path / "x.bin"))
            assert plain.get_path_on_disk() == tmp_path / "x.bin"
            assert asset_path.default_engine_directory() == \
                jasset.default_engine_directory()
        finally:
            asset_path.set_engine_directory(
                asset_path.default_engine_directory())

    def test_game_root_required(self, monkeypatch):
        monkeypatch.setattr(asset_path, "_game_dir", None)
        with pytest.raises(RuntimeError, match="Game directory not set"):
            asset_path.AssetPath("/Game/x").get_path_on_disk()
        assert not asset_path.AssetPath("/Game/x").exists()


class TestController:
    """Mirrors tests/test_scene_io.py's TestController, and holds the
    port's controller to the JAX package's over one event sequence."""

    def test_orbit_drag_rotates_eye(self):
        cam = Camera(eye=np.array([0, 0, 5], np.float32))
        ctl = CameraController(cam, viewport=(100, 100))
        inp = InputSystem()
        inp.on_mouse_button("right", True)
        inp.on_cursor(50, 50)
        inp.end_frame()
        inp.on_cursor(60, 50)
        assert ctl.update(0.016, inp.get_frame_inputs())
        assert not np.allclose(cam.eye, [0, 0, 5])
        assert np.linalg.norm(cam.eye) == pytest.approx(5.0, rel=1e-4)

    def test_f_toggles_and_restores(self):
        cam = Camera(eye=np.array([0, 0, 5], np.float32))
        ctl = CameraController(cam, viewport=(100, 100))
        inp = InputSystem()
        inp.on_key("f", KeyAction.PRESSED)
        ctl.update(0.016, inp.get_frame_inputs())
        assert ctl.mode == ctl.FREE
        inp.end_frame()
        inp.on_key("w", KeyAction.PRESSED)
        ctl.update(0.5, inp.get_frame_inputs())
        assert cam.eye[2] < 5.0
        inp.end_frame()
        inp.on_key("f", KeyAction.PRESSED)
        ctl.update(0.016, inp.get_frame_inputs())
        assert ctl.mode == ctl.ORBIT
        assert np.allclose(cam.eye, [0, 0, 5])

    def test_scroll_zoom_clamped(self):
        cam = Camera()
        ctl = CameraController(cam, viewport=(100, 100))
        inp = InputSystem()
        for _ in range(30):
            inp.on_scroll(0, 5)
            ctl.update(0.016, inp.get_frame_inputs())
            inp.end_frame()
        assert cam.fov_degrees == 30.0

    def test_event_sequence_matches_jax(self, rng):
        """Orbit drags, scrolls, the F toggle, free-mode mouse-look and
        WASD flying: the camera after every frame equals the JAX
        package's exactly."""
        cams = [Camera(eye=np.array([3, 2, 4], np.float32)),
                jcam.Camera(eye=np.array([3, 2, 4], np.float32))]
        ctls = [CameraController(cams[0], viewport=(128, 96)),
                jctl.CameraController(cams[1], viewport=(128, 96))]
        inps = [InputSystem(), jinput.InputSystem()]
        for i in range(60):
            ev = []
            if i % 20 == 0:
                ev.append(("on_key", "f", KeyAction.PRESSED))
            if i % 20 == 1:
                ev.append(("on_key", "f", KeyAction.RELEASED))
            ev.append(("on_mouse_button", "right", bool(i % 7 != 3)))
            ev.append(("on_cursor", *rng.uniform(0, 96, 2)))
            if i % 5 == 0:
                ev.append(("on_scroll", 0, float(rng.integers(-2, 3))))
            if i % 3 == 0:
                ev.append(("on_key", "wasd"[i % 4], KeyAction.PRESSED))
            for inp in inps:
                for name, *a in ev:
                    getattr(inp, name)(*a)
            for ctl, inp in zip(ctls, inps):
                ctl.update(1 / 60, inp.get_frame_inputs())
                inp.end_frame()
            assert ctls[0].mode == ctls[1].mode
            for f in ("eye", "look_at", "up"):
                np.testing.assert_array_equal(getattr(cams[0], f),
                                              getattr(cams[1], f))
            assert cams[0].fov_degrees == cams[1].fov_degrees


def _write_exr_zip(path, img, compression):
    """A HALF-channel EXR with ZIPS (2) or ZIP (3) compression, as tinyexr
    and OpenEXR write them: per block, bytes split into even and odd
    halves, delta-predicted, deflated."""
    img = np.asarray(img, np.float16)
    h, w, c = img.shape
    names = ["R", "G", "B", "A"][:c]
    chans = sorted(names)

    def attr(name, atype, payload):
        return (name.encode() + b"\x00" + atype.encode() + b"\x00"
                + struct.pack("<i", len(payload)) + payload)

    chl = b"".join(n.encode() + b"\x00" + struct.pack("<iiii", 1, 0, 1, 1)
                   for n in chans) + b"\x00"
    header = (attr("channels", "chlist", chl)
              + attr("compression", "compression", bytes([compression]))
              + attr("dataWindow", "box2i",
                     struct.pack("<iiii", 0, 0, w - 1, h - 1))
              + attr("displayWindow", "box2i",
                     struct.pack("<iiii", 0, 0, w - 1, h - 1))
              + attr("lineOrder", "lineOrder", b"\x00") + b"\x00")
    lines = 1 if compression == 2 else 16
    head = struct.pack("<ii", 20000630, 2) + header
    n_blocks = -(-h // lines)
    pos = len(head) + 8 * n_blocks
    ci = {n: i for i, n in enumerate(names)}
    blocks, offsets = [], []
    for y in range(0, h, lines):
        raw = b"".join(img[yy, :, ci[n]].tobytes()
                       for yy in range(y, min(h, y + lines)) for n in chans)
        r = np.frombuffer(raw, np.uint8)
        t = np.concatenate([r[0::2], r[1::2]]).astype(np.int32)
        d = t.copy()
        d[1:] = (t[1:] - t[:-1] + 128) % 256
        comp = zlib.compress(d.astype(np.uint8).tobytes())
        block = struct.pack("<ii", y, len(comp)) + comp
        offsets.append(pos)
        blocks.append(block)
        pos += len(block)
    with open(path, "wb") as f:
        f.write(head + struct.pack(f"<{n_blocks}q", *offsets)
                + b"".join(blocks))


class TestExr:
    def test_roundtrip_float(self, tmp_path, rng):
        img = rng.random((17, 23, 3)).astype(np.float32) * 10.0
        exr.write_exr(str(tmp_path / "t.exr"), img)
        back = exr.read_exr(str(tmp_path / "t.exr"))
        np.testing.assert_array_equal(back, img)
        np.testing.assert_array_equal(back, jexr.read_exr(
            str(tmp_path / "t.exr")))

    @pytest.mark.parametrize("compression", [2, 3])
    def test_zip_half_reads_like_jax(self, tmp_path, rng, compression):
        img = (rng.random((37, 19, 4)) * 8.0).astype(np.float16)
        p = str(tmp_path / "z.exr")
        _write_exr_zip(p, img, compression)
        back = exr.read_exr(p)
        np.testing.assert_array_equal(back, img.astype(np.float32))
        np.testing.assert_array_equal(back, jexr.read_exr(p))

    def test_rejects_non_exr(self, tmp_path):
        (tmp_path / "junk.exr").write_bytes(b"not an exr at all")
        with pytest.raises(ValueError):
            exr.read_exr(str(tmp_path / "junk.exr"))


class TestIbl:
    def test_environment_map_matches_jax(self, tmp_path, rng):
        img = (rng.random((24, 48, 3)) * 4.0).astype(np.float32)
        exr.write_exr(str(tmp_path / "env.exr"), img)
        eq = ibl.load_hdri(str(tmp_path / "env.exr"))
        np.testing.assert_array_equal(eq, jibl.load_hdri(
            str(tmp_path / "env.exr")))
        assert eq.shape == (24, 48, 4)
        cube = ibl.render_environment_map(eq, size=16, device="cpu")
        ref = np.asarray(jibl.render_environment_map(eq, size=16))
        assert cube.shape == (6, 16, 16, 4) and cube.dtype == torch.float32
        d = np.abs(cube.numpy() - ref)
        assert (d <= 1e-6).mean() >= 0.95 and d.max() <= 2e-5, (
            (d <= 1e-6).mean(), d.max())
        u8 = ibl.environment_to_skybox_u8(cube)
        np.testing.assert_array_equal(u8, jibl.environment_to_skybox_u8(
            cube.numpy()))
        np.testing.assert_array_equal(u8, ibl.environment_to_skybox_u8(
            cube.numpy()))

    def test_env_capture_directions(self):
        """Mirrors tests/test_aux.py: +y bright, -y dark."""
        h, w = 32, 64
        v = np.linspace(-1, 1, h)[:, None, None]
        eq = np.broadcast_to(np.clip(v, 0, 1), (h, w, 1)).repeat(
            4, -1).astype(np.float32).copy()
        cube = ibl.render_environment_map(eq, size=8, device="cpu").numpy()
        assert cube[2, ..., 0].mean() > 0.55
        assert cube[3, ..., 0].mean() < 0.05

    def test_captured_environment_lights_the_upload(self):
        """``set_environment`` feeds the irradiance bake at upload, as in
        the JAX package."""
        sc = procedural.cube_scene(width=32, height=24)
        eq = np.ones((8, 16, 4), np.float32) * 2.0
        before = sc.upload()["irradiance"].copy()
        sc.textures.set_environment(
            ibl.render_environment_map(eq, size=8, device="cpu").numpy())
        after = sc.upload()["irradiance"]
        assert not np.array_equal(before, after)


def _jpeg(rng, w, h, **kw):
    from PIL import Image
    base = rng.uniform(0, 255, (h // 8 + 1, w // 8 + 1, 3))
    img = np.kron(base, np.ones((8, 8, 1)))[:h, :w].astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("kw", [dict(quality=95, subsampling=0),
                                dict(quality=80, subsampling=2),
                                dict(quality=85, progressive=True)])
def test_jpeg_through_read_image(tmp_path, rng, kw):
    """``utils/image.read_image`` decodes baseline and progressive JPEGs
    with the native library exactly as the JAX package's does, and a
    texture cache loads them."""
    pytest.importorskip("PIL")
    assert native.load_library() is not None
    p = tmp_path / "t.jpg"
    p.write_bytes(_jpeg(rng, 61, 37, **kw))
    mine = image.read_image(str(p))
    assert mine.shape == (37, 61, 4) and mine.dtype == np.uint8
    np.testing.assert_array_equal(mine, jimage.read_image(str(p)))
    sc = procedural.cube_scene(width=32, height=24)
    h = sc.textures.load_texture(str(p))
    assert sc.textures.load_texture(str(p)) == h      # deduped by path


def test_jpeg_without_the_native_library(tmp_path, rng, monkeypatch):
    """Without the native library a JPEG is refused with a message (the
    JAX package's behaviour; there is no Python JPEG decoder), and PNG
    falls back to the Python unfilter with the same pixels."""
    pytest.importorskip("PIL")
    p = tmp_path / "t.jpg"
    p.write_bytes(_jpeg(rng, 16, 16, quality=90))
    img = rng.integers(0, 255, (9, 13, 4), dtype=np.uint8)
    png.write_png(str(tmp_path / "t.png"), img)
    monkeypatch.setattr(native, "load_library", lambda: None)
    with pytest.raises(ValueError, match="native decoder unavailable"):
        image.read_image(str(p))
    np.testing.assert_array_equal(image.read_image(str(tmp_path / "t.png")),
                                  img)


def test_cubemap_faces_from_files(tmp_path, rng):
    """``load_cubemap_faces`` reads six files (a missing one is black) as
    the JAX package does."""
    from renderengine_tpu.scene import procedural as jproc
    paths = []
    for i in range(5):
        f = rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)
        png.write_png(str(tmp_path / f"{i}.png"), f)
        paths.append(str(tmp_path / f"{i}.png"))
    paths.append(str(tmp_path / "missing.png"))
    sc = procedural.cube_scene(width=32, height=24)
    ref = jproc.cube_scene(width=32, height=24)
    sc.textures.load_cubemap_faces(paths)
    ref.textures.load_cubemap_faces(paths)
    np.testing.assert_array_equal(sc.textures.cubemap, ref.textures.cubemap)
    assert not sc.textures.cubemap[5].any()
