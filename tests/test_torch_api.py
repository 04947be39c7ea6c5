"""Public functions of the ported modules that the frame does not call,
each held to its JAX counterpart on inputs made from a numpy seed:
``sampling.sample_texture``, ``sampling.sample_texture_aniso_tiered``,
``sampling.compute_lod``, ``srgb.srgb_to_linear_rgba``,
``setup.vertex_transform``, ``math3d.transform_points`` /
``transform_dirs`` and ``FrameRenderer.binning_stats``.

Tolerances, stated:
- texture taps (``sample_texture`` bilinear and trilinear, the tiered 16x
  anisotropic sampler), ``compute_lod`` and ``srgb_to_linear_rgba``:
  within 1e-6 (the same f32 ops in the same order, up to the rounding of
  a library ``pow``);
- ``vertex_transform``: hazard H1 (ROADMAP.md Queue 3), as
  ``tests/test_torch_setup.py`` holds clip coordinates: within 1e-5
  absolute + 1e-6 relative; the normals within 1e-6;
- ``transform_points`` / ``transform_dirs`` (numpy, the same code) and
  ``binning_stats`` (integer counts): exact.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden_configs
from renderengine_tpu.core import aabb as jaabb
from renderengine_tpu.core import math3d as jm3
from renderengine_tpu.core.config import RasterConfig as JRasterConfig
from renderengine_tpu.core.config import RenderConfig as JRenderConfig
from renderengine_tpu.graph import frame as jframe
from renderengine_tpu.raster import setup as jsetup
from renderengine_tpu.scene import camera as jcamera
from renderengine_tpu.scene import lights as jlights
from renderengine_tpu.scene import materials as jmaterials
from renderengine_tpu.scene import procedural as jproc
from renderengine_tpu.scene import scene as jscene
from renderengine_tpu.shading import sampling as jsmp
from renderengine_tpu.shading import srgb as jsrgb
from renderengine_tpu_torch.core import aabb as taabb
from renderengine_tpu_torch.core import math3d as tm3
from renderengine_tpu_torch.core.config import RasterConfig, RenderConfig
from renderengine_tpu_torch.graph import frame as tframe
from renderengine_tpu_torch.raster import setup as tsetup
from renderengine_tpu_torch.scene import camera as tcamera
from renderengine_tpu_torch.scene import lights as tlights
from renderengine_tpu_torch.scene import materials as tmaterials
from renderengine_tpu_torch.scene import procedural as tproc
from renderengine_tpu_torch.scene import scene as tscene
from renderengine_tpu_torch.shading import sampling as tsmp
from renderengine_tpu_torch.shading import srgb as tsrgb

torch.set_num_threads(2)

_JCASES = {n: (f, c) for n, f, c in golden_configs.golden_cases()}


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def atlas():
    """The ``normal_orm`` golden scene's texture atlas (numpy upload)."""
    dev = _JCASES["normal_orm"][0]().upload()
    return {k: np.asarray(dev[k]) for k in ("atlas", "tex_table", "mip_y",
                                            "mip_x")}


def _port_atlas(a):
    return (_t(a["atlas"].view(np.int32)), _t(a["tex_table"]),
            _t(a["mip_y"]), _t(a["mip_x"]))


@pytest.mark.parametrize("with_lod", [False, True],
                         ids=["bilinear", "trilinear"])
def test_sample_texture(atlas, with_lod):
    rng = np.random.default_rng(21)
    n_tex = atlas["tex_table"].shape[0]
    handle = rng.integers(-1, n_tex + 1, (24, 40)).astype(np.int32)
    uv = rng.uniform(-2.0, 3.0, (24, 40, 2)).astype(np.float32)
    lod = (rng.uniform(-1.0, 9.0, (24, 40)).astype(np.float32)
           if with_lod else None)
    a = tsmp.sample_texture(*_port_atlas(atlas), _t(handle), _t(uv),
                            None if lod is None else _t(lod)).numpy()
    b = np.asarray(jsmp.sample_texture(
        jnp.asarray(atlas["atlas"]), jnp.asarray(atlas["tex_table"]),
        jnp.asarray(atlas["mip_y"]), jnp.asarray(atlas["mip_x"]),
        jnp.asarray(handle), jnp.asarray(uv),
        None if lod is None else jnp.asarray(lod)))
    assert a.shape == (24, 40, 4)
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_compute_lod():
    rng = np.random.default_rng(22)
    uv = np.cumsum(rng.uniform(-0.02, 0.05, (32, 48, 2)), axis=1).astype(
        np.float32)
    tw = (2 ** rng.integers(2, 10, (32, 48))).astype(np.int32)
    th = (2 ** rng.integers(2, 10, (32, 48))).astype(np.int32)
    a = tsmp.compute_lod(_t(uv), _t(tw), _t(th)).numpy()
    b = np.asarray(jsmp.compute_lod(jnp.asarray(uv), jnp.asarray(tw),
                                    jnp.asarray(th)))
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_sample_texture_aniso_tiered(atlas):
    """One slot of the tiered 16x sampler at grazing footprints, some of
    them past a tier's budget (isotropic fallback)."""
    rng = np.random.default_rng(23)
    h, w = 16, 256
    row = atlas["tex_table"][3]
    tex = {k: np.full((h, w), row[i], np.int32)
           for i, k in enumerate(("page", "x", "y", "w", "h"))}
    nm = np.full((h, w), row[5], np.int32)
    uv = rng.uniform(0.0, 1.0, (h, w, 2)).astype(np.float32)
    ratio = rng.uniform(1.0, 24.0, (h, w)).astype(np.float32)
    dx = np.stack([ratio / row[3], np.zeros_like(ratio)], -1).astype(
        np.float32)
    dy = np.stack([np.zeros_like(ratio), np.full_like(ratio, 1.0 / row[4])],
                  -1).astype(np.float32)
    for fracs in ((1.0, 1.0, 1.0), (0.25, 0.15, 0.08)):
        a = tsmp.sample_texture_aniso_tiered(
            *(_port_atlas(atlas)[i] for i in (0, 2, 3)),
            {k: _t(v) for k, v in tex.items()}, _t(nm), _t(uv), _t(dx),
            _t(dy), tsmp.AnisoSpec(16, fracs)).numpy()
        b = np.asarray(jsmp.sample_texture_aniso_tiered(
            jnp.asarray(atlas["atlas"]), jnp.asarray(atlas["mip_y"]),
            jnp.asarray(atlas["mip_x"]),
            {k: jnp.asarray(v) for k, v in tex.items()}, jnp.asarray(nm),
            jnp.asarray(uv), jnp.asarray(dx), jnp.asarray(dy),
            jsmp.AnisoSpec(16, fracs)))
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_srgb_to_linear_rgba():
    rng = np.random.default_rng(24)
    c = rng.uniform(-0.1, 1.2, (64, 64, 4)).astype(np.float32)
    a = tsrgb.srgb_to_linear_rgba(_t(c)).numpy()
    b = np.asarray(jsrgb.srgb_to_linear_rgba(jnp.asarray(c)))
    np.testing.assert_array_equal(a[..., 3], c[..., 3])
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", ["cube_phong", "multimesh_opaque",
                                  "normal_orm"])
def test_vertex_transform(name):
    factory, _ = _JCASES[name]
    sc = factory()
    dev = sc.upload()
    rng = np.random.default_rng(25)
    view = np.asarray(sc.camera.view, np.float32)
    proj = np.asarray(sc.camera.proj, np.float32)
    # and a second camera, made from the seed
    eye = rng.uniform(-4, 4, 3).astype(np.float32)
    views = [(view, proj), (tm3.look_at(eye, np.zeros(3, np.float32),
                                        np.array([0, 1, 0], np.float32)),
                            proj)]
    keys = ("positions", "normals", "uvs", "vert_node", "transforms",
            "normal_mats")
    for v, p in views:
        a = tsetup.vertex_transform({k: _t(dev[k]) for k in keys}, _t(v),
                                    _t(p))
        b = jsetup.vertex_transform({k: jnp.asarray(dev[k]) for k in keys},
                                    jnp.asarray(v), jnp.asarray(p))
        np.testing.assert_allclose(a.world_pos.numpy(),
                                   np.asarray(b.world_pos), atol=1e-5,
                                   rtol=1e-6)
        np.testing.assert_allclose(a.world_normal.numpy(),
                                   np.asarray(b.world_normal), atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(a.clip.numpy(), np.asarray(b.clip),
                                   atol=1e-5, rtol=1e-6)
        np.testing.assert_array_equal(a.uv.numpy(), np.asarray(b.uv))


def test_transform_points_and_dirs():
    rng = np.random.default_rng(26)
    m = rng.uniform(-2, 2, (4, 4)).astype(np.float32)
    m[3] = [0.1, -0.2, 0.05, 1.5]
    pts = rng.uniform(-10, 10, (500, 3)).astype(np.float32)
    np.testing.assert_array_equal(tm3.transform_points(m, pts),
                                  jm3.transform_points(m, pts))
    np.testing.assert_array_equal(tm3.transform_dirs(m, pts),
                                  jm3.transform_dirs(m, pts))
    p = tm3.perspective_vk(1.0, 4 / 3, 0.1, 100.0)
    np.testing.assert_array_equal(tm3.transform_points(p, pts),
                                  jm3.transform_points(p, pts))


_JAX = types.SimpleNamespace(
    aabb=jaabb.AABB, m3=jm3, Scene=jscene.Scene, proc=jproc,
    Info=jmaterials.MaterialInstanceInfo,
    Props=jmaterials.MaterialProperties, Light=jlights.Light,
    LightType=jlights.LightType, Camera=jcamera.Camera,
    ViewProperties=jcamera.ViewProperties)
_PORT = types.SimpleNamespace(
    aabb=taabb.AABB, m3=tm3, Scene=tscene.Scene, proc=tproc,
    Info=tmaterials.MaterialInstanceInfo,
    Props=tmaterials.MaterialProperties, Light=tlights.Light,
    LightType=tlights.LightType, Camera=tcamera.Camera,
    ViewProperties=tcamera.ViewProperties)


def _dense_scene(m, w, h, n_quads=3000):
    """``tests/test_overflow_react.py``'s scene through either package:
    screen-filling quads stacked in depth, so (tile, tri) pairs far
    exceed a budget of 2 pairs a triangle."""
    sc = m.Scene()
    plane = m.proc.make_plane(0.5, normal_axis=2)
    rng = np.random.default_rng(7)
    for i in range(n_quads):
        mat = sc.materials.create_material_instance(m.Info(m.Props(
            base_color=np.array([*rng.uniform(0.2, 1.0, 3), 1.0],
                                np.float32))))
        z = -10.0 + 8.0 * (i + 1) / n_quads
        node = sc.tree.create_node(
            m.m3.translate([0, 0, z]) @ m.m3.scale([20, 20, 1]),
            m.aabb.from_points([[-0.5, -0.5, 0], [0.5, 0.5, 0]]))
        p, n, u, idx = plane
        base = sc.meshes.add_vertices(p, n, u)
        sc.meshes.add_mesh(idx + base, mat, node)
    sc.lights.add_light(m.Light(type=m.LightType.DIRECTIONAL,
                                color=np.ones(3, np.float32),
                                direction=m.m3.normalize([0.0, -0.3, -1.0]),
                                intensity=3.0))
    sc.camera = m.Camera(eye=np.array([0, 0, 2.0], np.float32),
                         look_at=np.array([0, 0, -5.0], np.float32),
                         up=np.array([0, 1, 0], np.float32),
                         fov_degrees=60.0, near=0.1, far=100.0,
                         width=w, height=h, exposure=1.0)
    return sc


def test_binning_stats_equal_jax():
    """The pair-budget check at a pose that overflows (the scene's own
    camera) and one that does not (far back), as
    ``tests/test_overflow_react.py`` uses it; both packages bin in the
    RasterConfig's shade tiles on their ``reference`` backends."""
    w, h = 64, 48
    kw = dict(width=w, height=h, shadows=False, skybox=False,
              translucency=False)
    jr = jframe.FrameRenderer(_dense_scene(_JAX, w, h), JRenderConfig(
        **kw, raster=JRasterConfig(pairs_per_tri=2, auto_tune_pairs=False)),
        backend="reference")
    tr = tframe.FrameRenderer(_dense_scene(_PORT, w, h), RenderConfig(
        **kw, raster=RasterConfig(pairs_per_tri=2, auto_tune_pairs=False)),
        device="cpu", backend="reference")
    seen = []
    for eye in (None, (0.0, 0.0, 60.0)):
        vps = []
        for m, r in ((_JAX, jr), (_PORT, tr)):
            if eye is None:
                vps.append(None)
                continue
            cam = r.scene_host.camera
            cam.set_camera_view(np.array(eye, np.float32), cam.look_at,
                                np.array([0, 1, 0], np.float32))
            vps.append(m.ViewProperties.from_camera(cam))
        want = jr.binning_stats(vps[0])
        got = tr.binning_stats(vps[1])
        assert got == want
        seen.append(got)
    assert seen[0]["overflow"] > 0 and seen[1]["overflow"] == 0
    assert 0 < seen[1]["live"] < seen[0]["live"]
    assert seen[0]["budget"] == seen[1]["budget"]
