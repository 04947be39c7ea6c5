"""Shadows: the port's packing, PCF lookup, light fits and shadow pass
against the JAX package's, on the same inputs made with numpy.

Tolerances, stated:
- ``pack_shadow_blocks``: equal to JAX's word for word (integer packing of
  the same quantised depths; the port holds the u32 words as int32 bit
  views).
- ``compute_shadow_directional`` on JAX's packed map: the factor is a
  count of passing taps over 9, so it is equal wherever no tap's compare
  hangs on the last bit of the threshold or of a texel coordinate; at most
  0.1% of pixels may differ, by at most 2/9. The penumbra counters are
  integers and must be equal.
- two-stage PCF == dense single-stage bit for bit when the budget
  suffices (as tests/test_shadow_sparse.py).
- the light fits are numpy copies: equal to the originals bit for bit.
- the shadow *map*, quantised to 16 bits: equal to JAX's texel for texel
  when the port's raster runs on JAX's triangle setup. On the port's own
  setup the plane coefficients differ in the last bits (hazard H1), which
  moves a few depths across a rounding boundary and flips coverage of a
  few silhouette texels: at most 0.2% of texels may differ at all
  (measured 43 of 32768) and at most 0.05% by more than one quantum
  (measured 8, all on silhouettes).
- one slice == two slices: exact."""

import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from renderengine_tpu.graph import frame as jframe
from renderengine_tpu.shading import fitting as jfit
from renderengine_tpu.shading import shadow as jshadow
from renderengine_tpu_torch.core.config import RenderConfig
from renderengine_tpu_torch.graph import frame as tframe
from renderengine_tpu_torch.shading import fitting as tfit
from renderengine_tpu_torch.shading import shadow as tshadow

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _lit_scene(pkg: str, kind: str):
    """Floor + floating box under one shadow-casting light of ``kind``
    (directional, spot or point), built from package ``pkg``'s modules."""
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    math3d, aabb = mod("core.math3d"), mod("core.aabb")
    lights, mats = mod("scene.lights"), mod("scene.materials")
    proc, cam = mod("scene.procedural"), mod("scene.camera")
    sc = mod("scene.scene").Scene()
    mat = sc.materials.create_material_instance(mats.MaterialInstanceInfo(
        mats.MaterialProperties(base_color=np.array([1, 1, 1, 1], np.float32),
                                perceptual_roughness=1.0)))
    for geo, tf, pts in (
            (proc.make_plane(0.5), math3d.scale([8, 1, 8]),
             [[-4, 0, -4], [4, 0, 4]]),
            (proc.make_box(0.5),
             math3d.translate([0, 2, 0]) @ math3d.scale([2, 0.2, 2]),
             [[-1, -0.1, -1], [1, 0.1, 1]])):
        p, n, u, i = geo
        node = sc.tree.create_node(tf, aabb.AABB.from_points(pts))
        sc.meshes.add_mesh(i + sc.meshes.add_vertices(p, n, u), mat, node)
    lt = lights.LightType
    light = {
        "directional": lights.Light(
            type=lt.DIRECTIONAL, color=np.ones(3, np.float32),
            direction=math3d.normalize([-0.4, -1.0, -0.2]), intensity=3.0),
        "spot": lights.Light(
            type=lt.SPOT, position=np.array([-4, 10, 0], np.float32),
            direction=np.asarray(math3d.normalize([4.0, -10.0, 0.0]),
                                 np.float32),
            intensity=600.0, falloff_radius=50.0, cos_inner=0.75,
            cos_outer=0.7),
        "point": lights.Light(
            type=lt.POINT, position=np.array([0.5, 5, 0.3], np.float32),
            intensity=300.0, falloff_radius=40.0),
    }[kind]
    sc.create_shadow_map(sc.lights.add_light(light))
    sc.camera = cam.Camera(eye=np.array([3, 6, 5], np.float32),
                           look_at=np.zeros(3, np.float32),
                           up=np.array([0, 1, 0], np.float32),
                           fov_degrees=60.0, near=0.1, far=50.0,
                           width=64, height=48)
    return sc


KINDS = ["directional", "spot", "point"]


@pytest.mark.parametrize("kind", KINDS)
def test_fitting_copies_equal_the_originals(kind):
    a = tfit.shadow_transforms_for_scene(
        _lit_scene("renderengine_tpu_torch", kind))
    b = jfit.shadow_transforms_for_scene(_lit_scene("renderengine_tpu", kind))
    assert a.shape == (6 if kind == "point" else 1, 4, 4)
    np.testing.assert_array_equal(a, b)


def test_fitting_on_the_golden_scene():
    from renderengine_tpu.scene import procedural as jproc
    from renderengine_tpu_torch.scene import procedural as tproc
    kw = dict(width=128, height=96, n_textures=48, target_tris=2_000)
    a = tfit.shadow_transforms_for_scene(tproc.sponza_scene(**kw))
    b = jfit.shadow_transforms_for_scene(jproc.sponza_scene(**kw))
    assert a.shape[0] == 2
    np.testing.assert_array_equal(a, b)


def _random_maps(rng, ns, e):
    """Smooth-ish depth with flat regions, steps and exact 0 / 1 texels
    (halves >= 0x8000 and the extremes must survive the int32 packing)."""
    d = rng.uniform(0, 1, (ns, e, e)).astype(np.float32)
    d[:, : e // 3] = 0.6
    d[:, :, : e // 4] = np.float32(0.9)
    d[:, 5, 7], d[:, 6, 7], d[:, -1, -1] = 0.0, 1.0, 0.999999
    return d


@pytest.mark.parametrize("e", [64, 52, 10])
def test_pack_shadow_blocks_word_for_word(rng, e):
    d = _random_maps(rng, 2, e)
    tp = tshadow.pack_shadow_blocks(_t(d))
    jp = jshadow.pack_shadow_blocks(jnp.asarray(d))
    assert tp.blocks.dtype == torch.int32 and tp.coarse.dtype == torch.int32
    np.testing.assert_array_equal(tp.blocks.numpy().view(np.uint32),
                                  np.asarray(jp.blocks))
    np.testing.assert_array_equal(tp.coarse.numpy().view(np.uint32),
                                  np.asarray(jp.coarse))
    # a word whose high half is >= 0x8000 is negative as int32 and unpacks
    # to the same half
    hi = (tp.blocks >> 16) & 0xFFFF
    assert (tp.blocks < 0).any()
    np.testing.assert_array_equal(hi.numpy(),
                                  np.asarray(jp.blocks) >> 16)


def _lookup_inputs(rng, kind, h=48, w=160):
    """Fragments scattered through the lit scene's box, the light's fitted
    transforms, and a packed random depth map."""
    sc = _lit_scene("renderengine_tpu", kind)
    tf = jfit.shadow_transforms_for_scene(sc)
    light = sc.lights.lights[0]
    pos = rng.uniform([-4, 0, -4], [4, 3, 4], (h, w, 3)).astype(np.float32)
    nrm = rng.normal(size=(h, w, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    lpos = np.asarray(light.position, np.float32)
    d = _random_maps(rng, tf.shape[0], 64)
    return tf, lpos, pos, nrm, d


@pytest.mark.parametrize("penumbra_tiles", [0, 6])
@pytest.mark.parametrize("kind", KINDS)
def test_shadow_lookup_matches_jax_on_jax_pack(rng, kind, penumbra_tiles):
    tf, lpos, pos, nrm, d = _lookup_inputs(rng, kind)
    jp = jshadow.pack_shadow_blocks(jnp.asarray(d))
    tp = tshadow.ShadowPack(_t(np.asarray(jp.blocks).view(np.int32)),
                            _t(np.asarray(jp.coarse).view(np.int32)))
    jst, tst = [], []
    cube = kind == "point"
    b = np.asarray(jshadow.compute_shadow_directional(
        jp, jnp.asarray(tf), jnp.int32(0), jnp.asarray(lpos),
        jnp.asarray(pos), jnp.asarray(nrm), penumbra_tiles=penumbra_tiles,
        stats_out=jst, cube=cube))
    a = tshadow.compute_shadow_directional(
        tp, _t(tf), torch.tensor(0, dtype=torch.int32), _t(lpos), _t(pos),
        _t(nrm), penumbra_tiles=penumbra_tiles, stats_out=tst,
        cube=cube).numpy()
    assert 0.02 < b.mean() < 0.98        # both lit and shadowed fragments
    diff = np.abs(a - b)
    assert (diff > 1e-6).mean() <= 1e-3
    assert diff.max() <= 2 / 9 + 1e-6
    if penumbra_tiles:
        assert [int(x) for x in tst[0]] == [int(x) for x in jst[0]]
        assert int(tst[0][1]) > 0        # budget 6 of 12 tiles overflows


@pytest.mark.parametrize("kind", KINDS)
def test_two_stage_equals_dense_when_budget_suffices(rng, kind):
    tf, lpos, pos, nrm, d = _lookup_inputs(rng, kind)
    d = rng.uniform(0, 1, d.shape).astype(np.float32)   # penumbra everywhere
    d[:, 30:] = 0.3                      # but a flat blocker's cells
    pack = tshadow.pack_shadow_blocks(_t(d))
    args = (pack, _t(tf), torch.tensor(0, dtype=torch.int32), _t(lpos),
            _t(pos), _t(nrm))
    cube = kind == "point"
    dense = tshadow.compute_shadow_directional(*args, cube=cube)
    n_tiles = (-(-pos.shape[0] // 8)) * (-(-pos.shape[1] // 128))
    st = []
    sparse = tshadow.compute_shadow_directional(
        *args, penumbra_tiles=n_tiles, stats_out=st, cube=cube)
    assert torch.equal(sparse, dense)
    n_pen, overflow = (int(x) for x in st[0])
    assert 0 < n_pen <= n_tiles and overflow == 0
    st = []
    tshadow.compute_shadow_directional(*args, penumbra_tiles=1, stats_out=st,
                                       cube=cube)
    assert int(st[0][1]) > 0             # over-budget segments are counted


def _sponza(w, h):
    from renderengine_tpu_torch.scene import procedural
    return procedural.sponza_scene(width=w, height=h, n_textures=8,
                                   target_tris=2_000)


def test_two_stage_frame_bit_exact_with_dense_and_overflow_grows():
    """Frame level, as tests/test_shadow_sparse.py: with the observed
    penumbra need as budget the frame equals the dense single-stage frame
    bit for bit; with a budget of 1 the overflow is counted, the renderer
    grows the budget from the counters and reaches the dense frame."""
    w, h = 384, 144
    sc = _sponza(w, h)
    cfg = RenderConfig(width=w, height=h, shadow_extent=256, skybox=False,
                       translucency=False)
    dense, st0 = tframe.FrameRenderer(sc, cfg, device="cpu").render()
    assert "penumbra_tiles" not in st0
    n_tiles = (-(-h // 8)) * (-(-w // 128))
    full, st = tframe.FrameRenderer(
        sc, cfg.replace(penumbra_tile_budget=n_tiles), device="cpu").render()
    assert torch.equal(full, dense)
    n_pen = int(st["penumbra_tiles"])
    assert 0 < n_pen and int(st["penumbra_overflow"]) == 0
    fit, st = tframe.FrameRenderer(
        sc, cfg.replace(penumbra_tile_budget=n_pen), device="cpu").render()
    assert torch.equal(fit, dense) and int(st["penumbra_overflow"]) == 0
    r = tframe.FrameRenderer(sc, cfg.replace(penumbra_tile_budget=1),
                             device="cpu")
    img, st = r.render()
    assert int(st["penumbra_overflow"]) > 0 and not torch.equal(img, dense)
    for _ in range(6):
        img, st = r.render()
        if torch.equal(img, dense):
            break
    assert r.config.penumbra_tile_budget > 1
    assert torch.equal(img, dense) and int(st["penumbra_overflow"]) == 0


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_shadow_pass_one_slice_equals_two(backend):
    sc = _sponza(128, 96)
    cfg = RenderConfig(width=128, height=96, shadow_extent=128)
    r = tframe.FrameRenderer(sc, cfg, device="cpu", backend=backend)
    u = torch.from_numpy(r.uniform_for_camera())
    svp = tframe.unpack_params(u, r.n_shadows)["shadow_viewproj"]
    one, ov1 = tframe.render_shadow_maps(r.scene_dev, svp, 128, r.n_shadows,
                                         cfg.raster, backend)
    two, ov2 = tframe.render_shadow_maps(r.scene_dev, svp, 128, r.n_shadows,
                                         cfg.raster, backend, n_slices=2)
    assert one.shape == (2, 128, 128)
    assert torch.equal(one, two)
    assert int(ov1) == 0 and int(ov2) == 0
    assert ((one > 0) & (one < 1)).float().mean() > 0.05
    with pytest.raises(ValueError, match="n_slices"):
        tframe.render_shadow_maps(r.scene_dev, svp, 128, r.n_shadows,
                                  cfg.raster, backend, n_slices=3)


def test_shadow_map_against_jax():
    """The port's shadow pass against the JAX package's (both brute-force
    rasters, front-culled, on the golden scene at 128^2)."""
    from renderengine_tpu.core.config import CullMode as JCull
    from renderengine_tpu.core.config import RenderConfig as JConfig
    from renderengine_tpu.raster import setup as jsetup
    from renderengine_tpu.scene import procedural as jproc
    from renderengine_tpu_torch.raster.reference_raster import (
        rasterize_reference)
    from renderengine_tpu_torch.raster.setup import TriSetup
    kw = dict(width=128, height=96, n_textures=8, target_tris=2_000)
    jcfg = JConfig(width=128, height=96, shadow_extent=128)
    jr = jframe.FrameRenderer(jproc.sponza_scene(**kw), jcfg,
                              backend="reference")
    ju = jnp.asarray(jr.uniform_for_camera())
    jsvp = jframe.unpack_params(ju, 2)["shadow_viewproj"]
    jmaps, _ = jframe.render_shadow_maps(jr.scene_dev, jsvp, 128, 2,
                                         jcfg.raster, "reference")
    r = tframe.FrameRenderer(_sponza(128, 96),
                             RenderConfig(width=128, height=96,
                                          shadow_extent=128),
                             device="cpu", backend="reference")
    u = torch.from_numpy(r.uniform_for_camera())
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    tmaps, _ = tframe.render_shadow_maps(
        r.scene_dev, tframe.unpack_params(u, 2)["shadow_viewproj"], 128, 2,
        r.config.raster, "reference")

    def quant(m):
        return np.round(np.clip(np.asarray(m), 0, 1) * 65535).astype(np.int64)

    dq = np.abs(quant(tmaps.numpy()) - quant(jmaps))
    assert (dq > 0).mean() <= 2e-3
    assert (dq > 1).mean() <= 5e-4
    # on JAX's setup the port's raster gives JAX's quantised map exactly
    for si in range(2):
        c = jsetup.corner_clip(jr.scene_dev["corner_attr"][..., 0:3],
                               jsvp[si])
        js = jsetup.triangle_setup_corners(c, jr.scene_dev["n_tris"], 128,
                                           128, JCull.FRONT)
        ts = TriSetup(*(torch.from_numpy(np.array(x))
                        for x in (js.coef, js.tie, js.valid, js.bbox)))
        g = rasterize_reference(ts, 128, 128)
        np.testing.assert_array_equal(quant(g.depth.numpy()),
                                      quant(jmaps[si]))
