"""Texture-space shading (``renderengine_tpu_torch/shading/lightchart.py``)
against the JAX package's ``shading/lightchart.py``, stage by stage, and
the port's mirrors of ``tests/test_lightchart.py``'s layout, rgb9e5,
subdivision and half-res checks.

Tolerances, stated:
- host layout (chart subdivision on upload, ``build_layout``,
  ``attach_chart_layout``, ``host_alpha_is_factor``): exact, array for
  array — numpy copies of the same code;
- rgb9e5 encode, block packing and alpha blocks: bit for bit (power-of-two
  scaling and round-half-even are exact in both);
- the samplers on the same table and uvs: within 1e-5 of the largest
  magnitude (relative);
- the bakes and the static/specular light passes on JAX's upload: within
  1e-5 of the largest magnitude (XLA contracts multiply-adds, H1); the
  visibility bake as ``tests/test_torch_shadow.py`` holds PCF (at most
  0.1% of texels off, by at most 2/9: a few depths cross a compare);
- decoded light tables: within one rgb9e5 step (2^(e - 24) for the
  texel's shared exponent e: 2^-9 to 2^-8 of its largest channel), since
  one H1 ulp can move a mantissa's rounding across a half.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aniso_inputs as ai
import golden_configs
from renderengine_tpu.graph import frame as jframe
from renderengine_tpu.scene import procedural as jproc
from renderengine_tpu.scene.camera import ViewProperties as JVP
from renderengine_tpu.shading import lightchart as jlc
from renderengine_tpu_torch.graph import frame as tframe
from renderengine_tpu_torch.graph.frame import FrameRenderer
from renderengine_tpu_torch.raster import cuda_raster as cr
from renderengine_tpu_torch.scene import procedural
from renderengine_tpu_torch.scene.camera import ViewProperties
from renderengine_tpu_torch.shading import lightchart as lc
from renderengine_tpu_torch.shading import shadow as tshadow
from renderengine_tpu_torch.tools import goldens

torch.set_num_threads(2)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _close(a, b, tol=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-30)
    assert np.abs(a - b).max() <= tol * scale, np.abs(a - b).max() / scale


# --- the host layout ---------------------------------------------------------

_LAYOUTS: dict = {}


def _layout(w=192, h=144, tris=12_000, density=0.5, budget=2_000_000):
    """``tests/test_lightchart.py::_layout``'s scene through both
    packages: (port upload, port layout, JAX upload, JAX layout, vp)."""
    key = (w, h, tris, density, budget)
    if key not in _LAYOUTS:
        kw = dict(width=w, height=h, n_textures=16, target_tris=tris)
        jd = jproc.sponza_scene(**kw).upload()
        sc = procedural.sponza_scene(**kw)
        td = sc.upload()
        vp = ViewProperties.from_camera(sc.camera)
        vpj = np.asarray(vp.proj) @ np.asarray(vp.view)
        valid = np.arange(len(td["tri_vidx"])) < int(td["n_tris"])
        lay = lc.build_layout(td["tri_vidx"], td["tri_material"],
                              td["world_pos"], vpj, w, h, density, budget,
                              valid)
        jlay = jlc.build_layout(jd["tri_vidx"], jd["tri_material"],
                                jd["world_pos"], vpj, w, h, density, budget,
                                valid)
        _LAYOUTS[key] = (td, lay, jd, jlay, vpj)
    return _LAYOUTS[key]


def test_layout_equals_jax():
    td, lay, jd, jlay, vpj = _layout()
    jv = JVP.from_camera(jproc.sponza_scene(
        width=192, height=144, n_textures=16, target_tris=12_000).camera)
    np.testing.assert_array_equal(vpj, np.asarray(jv.proj) @ np.asarray(jv.view))
    for a, b in zip(lay, jlay, strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert lay.n_texels > 100_000 and lay.height % 8 == 0


@pytest.mark.parametrize("density", [0.5, 1.0])
def test_chart_subdivided_upload_and_attach_equal_jax(density):
    """``Scene.upload(chart_subdiv=...)`` and ``attach_chart_layout``:
    every key equal (values and dtypes) to the JAX package's."""
    from renderengine_tpu.core.config import RenderConfig as JCfg
    from renderengine_tpu_torch.core.config import RenderConfig

    w, h = 320, 180
    kw = dict(width=w, height=h, n_textures=8, target_tris=2000)
    sc = procedural.sponza_scene(**kw)
    vp = ViewProperties.from_camera(sc.camera)
    vpj = np.asarray(vp.proj) @ np.asarray(vp.view)
    sub = dict(viewproj=vpj, width=w, height=h, density=density)
    td = sc.upload(chart_subdiv=sub)
    jd = jproc.sponza_scene(**kw).upload(chart_subdiv=sub)
    assert int(td["n_tris"]) > int(sc.upload()["n_tris"])
    lc.attach_chart_layout(td, vpj, RenderConfig(width=w, height=h,
                                                 chart_density=density))
    jlc.attach_chart_layout(jd, vpj, JCfg(width=w, height=h,
                                          chart_density=density))
    assert set(td) == set(jd)
    for k in jd:
        a, b = np.asarray(td[k]), np.asarray(jd[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_host_alpha_is_factor_equals_jax():
    jcases = {n: f for n, f, _ in golden_configs.golden_cases()}
    seen = set()
    for name, factory, _ in goldens.golden_cases():
        sc, jsc = factory(), jcases[name]()
        got = lc.host_alpha_is_factor(sc.upload(), sc.textures)
        assert got == jlc.host_alpha_is_factor(jsc.upload(), jsc.textures)
        seen.add(got)
    assert lc.host_alpha_is_factor({"mat_tex_base": np.array([0])}, None) \
        is False
    assert seen == {True, False}


# --- mirrors of tests/test_lightchart.py::TestLayout ------------------------

def test_bary_uv_roundtrip_exact():
    """corner_uv and texel_bary are exact inverses: mapping a texel's bary
    through its owner's corners lands on the texel."""
    _, lay, _, _, _ = _layout()
    iy, ix = np.nonzero(lay.texel_tri >= 0)
    sel = np.random.default_rng(0).choice(len(iy), 4000, replace=False)
    iy, ix = iy[sel], ix[sel]
    tb = lay.texel_bary[iy, ix]
    cu = lay.corner_uv[lay.texel_tri[iy, ix]]
    uv = ((1 - tb[:, :1] - tb[:, 1:]) * cu[:, 0] + tb[:, :1] * cu[:, 1]
          + tb[:, 1:] * cu[:, 2])
    np.testing.assert_allclose(uv, np.stack([ix, iy], -1), atol=1e-3)


def test_quad_mates_share_seamless_diagonal():
    """A texel owned by a tri's quad mate evaluates to the same world
    position through either triangle's plane."""
    td, lay, _, _, _ = _layout()
    tv, wp = td["tri_vidx"], td["world_pos"]
    rng = np.random.default_rng(1)
    tt = rng.integers(0, int(td["n_tris"]), 3000)
    b1 = rng.uniform(0.05, 0.6, 3000)
    b2 = rng.uniform(0.05, 0.3, 3000)
    cu = lay.corner_uv[tt]
    uv = ((1 - b1 - b2)[:, None] * cu[:, 0] + b1[:, None] * cu[:, 1]
          + b2[:, None] * cu[:, 2])
    ix = np.clip(np.round(uv[:, 0]).astype(int), 0, lc.ATLAS_W - 1)
    iy = np.clip(np.round(uv[:, 1]).astype(int), 0, lay.height - 1)
    own = lay.texel_tri[iy, ix]
    m = (own >= 0) & (own != tt) & (np.ptp(cu, axis=(1, 2)) > 0)
    assert m.sum() > 10
    tb = lay.texel_bary[iy[m], ix[m]]
    wo = wp[tv[own[m]]]
    w_owner = ((1 - tb[:, :1] - tb[:, 1:]) * wo[:, 0]
               + tb[:, :1] * wo[:, 1] + tb[:, 1:] * wo[:, 2])
    cu2 = lay.corner_uv[tt[m]]
    d1 = cu2[:, 1] - cu2[:, 0]
    d2 = cu2[:, 2] - cu2[:, 0]
    det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    p = np.stack([ix[m], iy[m]], -1) - cu2[:, 0]
    bb1 = (p[:, 0] * d2[:, 1] - p[:, 1] * d2[:, 0]) / det
    bb2 = (p[:, 1] * d1[:, 0] - p[:, 0] * d1[:, 1]) / det
    wm = wp[tv[tt[m]]]
    w_mine = ((1 - bb1 - bb2)[:, None] * wm[:, 0]
              + bb1[:, None] * wm[:, 1] + bb2[:, None] * wm[:, 2])
    assert np.abs(w_owner - w_mine).max() < 1e-4


def test_budget_respected_and_density_scales_texels():
    assert _layout(budget=300_000)[1].n_texels <= 300_000
    assert _layout(density=0.25)[1].n_texels < _layout(density=1.0)[1].n_texels


# --- mirrors of TestChartSubdivision -----------------------------------------

def _subdiv_pair(density=1.0):
    sc = procedural.sponza_scene(width=640, height=360, n_textures=8,
                                 target_tris=2000)
    vp = ViewProperties.from_camera(sc.camera)
    vpj = np.asarray(vp.proj) @ np.asarray(vp.view)
    return sc.upload(), sc.upload(chart_subdiv=dict(
        viewproj=vpj, width=640, height=360, density=density)), vpj


def test_subdivision_splits_floor_bounds_charts_keeps_mates():
    d0, d1, vpj = _subdiv_pair()
    n = int(d1["n_tris"])
    assert n > int(d0["n_tris"])
    valid = np.arange(len(d1["tri_vidx"])) < n
    area = lc._footprint_px(d1["world_pos"][d1["tri_vidx"]], vpj, 640, 360)
    r = np.sqrt(2.0 * np.maximum(area, 1.0))
    assert (r[valid] <= lc.MAX_R + 1e-3).all(), r[valid].max()
    # vector area is additive under subdivision: winding never flips
    def area_sum(dev):
        w = dev["world_pos"][dev["tri_vidx"]]
        k = int(dev["n_tris"])
        return np.cross(w[:k, 1] - w[:k, 0], w[:k, 2] - w[:k, 0]).sum(0)
    np.testing.assert_allclose(area_sum(d0), area_sum(d1), rtol=1e-4,
                               atol=1e-4)
    partner = lc._quad_mates(d1["tri_vidx"][:n], d1["tri_material"][:n])
    assert (partner >= 0).mean() > 0.6


def test_footprint_nearclip():
    vpj = np.array([[1, 0, 0, 0], [0, 1, 0, 0],
                    [0, 0, 1, 0], [0, 0, 1, 0]], np.float32)
    tri = np.array([[[-0.5, -0.5, 1.0], [0.5, -0.5, 1.0],
                     [0.0, 0.0, -1.0]]], np.float32)
    assert lc._footprint_px(tri, vpj, 100, 100)[0] > 500.0
    behind = np.array([[[0, 0, -1.0], [1, 0, -1.0], [0, 1, -1.0]]],
                      np.float32)
    assert lc._footprint_px(behind, vpj, 100, 100)[0] == 64.0
    np.testing.assert_array_equal(lc._footprint_px(tri, vpj, 100, 100),
                                  jlc._footprint_px(tri, vpj, 100, 100))


# --- rgb9e5 ------------------------------------------------------------------

def _hdr(rng, n):
    x = rng.uniform(0, 1, (n, 3)).astype(np.float32) ** 2
    x *= rng.choice([0.0, 1e-6, 1e-3, 0.1, 1.0, 40.0, 7e4],
                    (n, 1)).astype(np.float32)
    x[:8] = [[0, 0, 0], [-1, 2, 3], [1, 1, 1], [0.5, 0.25, 0.125],
             [65408, 1, 0], [1e9, 0, 0], [3e-5, 0, 0], [256.5, 1, 0.5]]
    return x


def test_rgb9e5_encode_bit_exact_and_planar_equals_minor():
    x = _hdr(np.random.default_rng(0), 4096)
    want = np.asarray(jlc.rgb9e5_encode(jnp.asarray(x)))
    t = torch.from_numpy(x)
    got = lc.rgb9e5_encode(t)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_u32(got), want)
    assert (want >= 2 ** 31).any()               # bit 31 is in use
    planar = lc.rgb9e5_encode_planes(t[:, 0], t[:, 1], t[:, 2])
    assert torch.equal(planar, got)
    np.testing.assert_array_equal(
        lc.rgb9e5_decode(got).numpy(),
        np.asarray(jlc.rgb9e5_decode(jnp.asarray(want))))


def test_rgb9e5_roundtrip_error_bound():
    """Shared-exponent packing: error <= 2^-9 of the max channel."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (2048, 3)).astype(np.float32) ** 2
    x *= rng.choice([1e-3, 0.1, 1.0, 40.0], (2048, 1)).astype(np.float32)
    dec = lc.rgb9e5_decode(lc.rgb9e5_encode(torch.from_numpy(x))).numpy()
    rel = np.abs(dec - x) / np.maximum(x.max(-1, keepdims=True), 1e-6)
    assert rel.max() <= 2.0 ** -9 + 1e-4


def test_block_tables_bit_exact():
    rng = np.random.default_rng(2)
    a = (rng.uniform(0, 4, (3, 24, 48)) ** 3).astype(np.float32)
    b = (rng.uniform(0, 2, (3, 24, 48))).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(
        _u32(lc.pack_rgbe_blocks(ta)),
        np.asarray(jlc.pack_rgbe_blocks(jnp.asarray(a))))
    np.testing.assert_array_equal(
        _u32(lc.merge_light_planes(lc.pack_rgbe_planes(ta),
                                   lc.pack_rgbe_planes(tb))),
        np.asarray(jlc.merge_light_planes(jlc.pack_rgbe_planes(
            jnp.asarray(a)), jlc.pack_rgbe_planes(jnp.asarray(b)))))
    alpha = rng.uniform(-0.1, 1.1, (24, 48)).astype(np.float32)
    np.testing.assert_array_equal(
        _u32(lc.pack_alpha_blocks(torch.from_numpy(alpha))),
        np.asarray(jlc.pack_alpha_blocks(jnp.asarray(alpha))))


def test_block_sample_matches_direct_bilinear():
    rng = np.random.default_rng(1)
    atlas = rng.uniform(0, 4, (24, 48, 3)).astype(np.float32)
    blocks = lc.pack_rgbe_blocks(torch.from_numpy(atlas).movedim(-1, 0))
    uv = np.stack([rng.uniform(0, 47, 400),
                   rng.uniform(0, 23, 400)], -1).astype(np.float32)
    out = lc.sample_rgbe_blocks(blocks, torch.from_numpy(uv), 24, 48).numpy()
    ix = np.floor(uv[:, 0]).astype(int)
    iy = np.floor(uv[:, 1]).astype(int)
    fx = (uv[:, 0] - ix)[:, None]
    fy = (uv[:, 1] - iy)[:, None]
    x1 = np.minimum(ix + 1, 47)
    y1 = np.minimum(iy + 1, 23)
    ref = ((atlas[iy, ix] * (1 - fx) + atlas[iy, x1] * fx) * (1 - fy)
           + (atlas[y1, ix] * (1 - fx) + atlas[y1, x1] * fx) * fy)
    assert np.abs(out - ref).max() < 0.01 * max(1.0, ref.max())


# --- the samplers, on the same tables and uvs --------------------------------

def _chart_uv_field(rng, h, w, ah, aw):
    """Per-pixel chart uvs as a screen would give them: smooth patches
    (about half a texel per pixel) with jumps between patches, where the
    guided upsample must reject far corners."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    patch = (yy // 9 + xx // 13) % 5
    off = rng.uniform(0, [aw - 40, ah - 40], (5, 2)).astype(np.float32)
    u = off[patch.astype(int), 0] + 0.5 * xx % 13 + 0.1 * yy
    v = off[patch.astype(int), 1] + 0.5 * yy % 9 + 0.05 * xx
    return np.stack([u, v], -1).astype(np.float32)


@pytest.mark.parametrize("y0,h", [(0, 23), (1, 24)])
def test_samplers_match_jax(y0, h):
    """``y0`` odd: the half grid starts on the slice's second row (the
    global even rows); the JAX form takes an even slice height there."""
    rng = np.random.default_rng(3)
    ah, aw, w = 64, 96, 34
    ld = (rng.uniform(0, 3, (3, ah, aw)) ** 2).astype(np.float32)
    ls = rng.uniform(0, 1, (3, ah, aw)).astype(np.float32)
    alpha = rng.uniform(0, 1, (ah, aw)).astype(np.float32)
    jl8 = jlc.merge_light_planes(jlc.pack_rgbe_planes(jnp.asarray(ld)),
                                 jlc.pack_rgbe_planes(jnp.asarray(ls)))
    jblk = jlc.pack_rgbe_blocks(jnp.asarray(ld))
    jab = jlc.pack_alpha_blocks(jnp.asarray(alpha))
    tl8, tblk, tab = (torch.from_numpy(np.array(x).view(np.int32))
                      for x in (jl8, jblk, jab))
    cuv = _chart_uv_field(rng, h, w, ah, aw)
    cuv[0, 0] = [-3.0, 1e4]                      # clamped at the edges
    jc, tc = jnp.asarray(cuv), torch.from_numpy(cuv)
    for j, t in zip(jlc.sample_light8(jl8, jc, ah, aw),
                    lc.sample_light8(tl8, tc, ah, aw), strict=True):
        _close(t.numpy(), j)
    for j, t in zip(jlc.sample_light_halfres(jl8, jc, ah, aw, y0=y0),
                    lc.sample_light_halfres(tl8, tc, ah, aw, y0=y0),
                    strict=True):
        assert t.shape == (h, w, 3)
        _close(t.numpy(), j)
    for need_alpha in (False, True):
        _close(lc.tss_shade_pre(tblk, tab, tc, ah, aw, need_alpha).numpy(),
               jlc.tss_shade_pre(jblk, jab, jc, ah, aw, need_alpha))
        _close(lc.tss_shade_pre_halfres(tblk, tab, tc, ah, aw, y0=y0,
                                        need_alpha=need_alpha).numpy(),
               jlc.tss_shade_pre_halfres(jblk, jab, jc, ah, aw, y0=y0,
                                         need_alpha=need_alpha))


# --- the bakes and light passes on JAX's upload ------------------------------

_JAX_TSS: dict = {}

PRE_BLEND = dict(texture_space=True, debug_views=False, translucency=True,
                 skybox=True, tss_preshaded_blend=True)


def _jax_tss(extra=PRE_BLEND):
    """The JAX package's TSS renderer on the ``shadows_pcf`` scene after
    one frame (bakes, shadow maps, visibility, static tables), memoized."""
    key = repr(sorted(extra.items()))
    if key not in _JAX_TSS:
        cases = {n: (f, c) for n, f, c in golden_configs.golden_cases()}
        factory, cfg = cases["shadows_pcf"]
        jr = jframe.FrameRenderer(factory(), cfg.replace(**extra),
                                  backend="reference")
        img = np.asarray(jr.render())
        _JAX_TSS[key] = (jr, img)
    return _JAX_TSS[key]


def _port_cfg(extra=PRE_BLEND):
    cfg = {n: c for n, _, c in goldens.golden_cases()}["shadows_pcf"]
    return cfg.replace(**extra)


_BAKED = ("chart_pos", "chart_normal", "chart_mat", "chart_vis",
          "chart_albedo", "chart_a", "chart_ld", "chart_base")


def _port_scene(jr):
    """JAX's upload (chart layout included) as the port's device dict,
    without the baked keys."""
    return tframe.scene_to_device(
        {k: np.asarray(v) for k, v in jr.scene_dev.items()
         if k not in _BAKED}, "cpu")


def test_bakes_match_jax():
    """The upload bake against the JAX package's bake function run outside
    ``jit``. Inside ``jit`` XLA fuses the material remap, and the mapped
    normal of texels whose chart-grid tangent frame is near-degenerate
    swings: JAX's jitted bake differs from its own eager bake there (4.3%
    of live texels on this scene, by up to 0.71; ROADMAP.md Queue 3 F8),
    while the frames agree at the golden bar (``test_torch_tss_frame.py``)."""
    jr, _ = _jax_tss()
    cfg = _port_cfg()
    sd = _port_scene(jr)
    up, aif = lc.setup_scene_tss(sd, cfg, jr._slots_used,
                                 jr._baked_exposure, alpha_is_factor=None)
    assert aif == jr._alpha_is_factor
    base = {k: v for k, v in jr.scene_dev.items() if k not in _BAKED}
    jup, _ = jlc._make_bake_fn(jr.config, jr._slots_used,
                               int(base["light_type"].shape[0]), True)(base)
    for k in ("chart_pos", "chart_normal", "chart_mat", "chart_albedo"):
        assert up[k].shape == jup[k].shape, k
        _close(up[k].numpy(), jup[k])
    np.testing.assert_array_equal(_u32(up["chart_a"]),
                                  np.asarray(jup["chart_a"]))
    live = np.asarray(jup["chart_mat"][15])
    assert 0.3 < live.mean() < 1.0
    # the jitted bake agrees except for those normals
    for k in ("chart_pos", "chart_mat"):
        _close(up[k].numpy(), jr.scene_dev[k])


def test_visibility_and_light_tables_match_jax():
    jr, _ = _jax_tss()
    cfg = _port_cfg()
    jsd = jr.scene_dev
    sd = _port_scene(jr)
    sd.update({k: torch.from_numpy(np.array(np.asarray(jsd[k])))
               for k in ("chart_pos", "chart_normal", "chart_mat",
                         "chart_albedo")})
    jm = jr._shadow_maps
    maps = tshadow.ShadowPack(
        torch.from_numpy(np.array(jm.blocks).view(np.int32)),
        torch.from_numpy(np.array(jm.coarse).view(np.int32)))
    u = torch.from_numpy(np.asarray(jr.uniform_for_camera()))
    params = tframe.unpack_params(u, jr.n_shadows)
    geo = {"pos": sd["chart_pos"], "normal": sd["chart_normal"],
           "mat_id": sd["chart_mat"][15]}
    vis = lc.bake_visibility(sd, geo, maps, params["shadow_viewproj"],
                             jr._shadow_lights)
    jvis = np.asarray(jsd["chart_vis"])
    d = np.abs(vis.numpy() - jvis)
    assert vis.shape == jvis.shape
    # shadowed and lit texels both occur under the lights with a map
    lit = jvis[[i for i, f in enumerate(jr._shadow_lights) if f]]
    lit = lit[:, np.asarray(jsd["chart_mat"][15]) > 0]
    assert 0.01 < (lit < 1).mean() < 0.99
    assert (d > 1e-6).mean() <= 1e-3 and d.max() <= 2 / 9 + 1e-6
    # the static tables and the per-frame pass on JAX's visibility
    sd["chart_vis"] = torch.from_numpy(jvis.copy())

    def tables_close(tabs, jtabs):
        _close(tabs["chart_base"].numpy(), jtabs["chart_base"])
        got = lc.rgb9e5_decode(tabs["chart_ld"]).numpy()
        want = np.asarray(jlc.rgb9e5_decode(jtabs["chart_ld"]))
        # one step of the texel's shared exponent e: 2^(e - 24)
        e = (np.asarray(jtabs["chart_ld"]) >> 27).astype(np.int64)
        step = np.exp2(e - 24.0)[..., None]
        assert (np.abs(got - want) <= step).all()

    tables_close(lc.static_tables(sd, cfg, jr._baked_exposure), jsd)
    # the exposure as the captured table program reads it (a 0-d device
    # tensor) against JAX's _ld_fn (its traced exposure), at the baked
    # exposure and at 1.5x
    for e in (jr._baked_exposure, 1.5 * jr._baked_exposure):
        tables_close(lc.static_tables(sd, cfg, torch.tensor(
            e, dtype=torch.float32)), jr._ld_fn(jsd, e))
    va = {"view_pos": params["view_pos"], "exposure": params["exposure"]}
    jva = {"view_pos": jnp.asarray(params["view_pos"].numpy()),
           "exposure": jnp.asarray(params["exposure"].numpy())}
    spec = lc.chart_light_spec(sd, sd["chart_pos"], sd["chart_normal"],
                               sd["chart_mat"], sd["chart_vis"], va)
    jspec = jlc.chart_light_spec(jsd, jsd["chart_pos"], jsd["chart_normal"],
                                 jsd["chart_mat"], jsd["chart_vis"], jva)
    _close(spec.numpy(), jspec)
    static = lc.chart_light_static(sd, sd["chart_pos"], sd["chart_normal"],
                                   sd["chart_mat"], sd["chart_vis"],
                                   jr._baked_exposure)
    _close(static.numpy(), jlc.chart_light_static(
        jsd, jsd["chart_pos"], jsd["chart_normal"], jsd["chart_mat"],
        jsd["chart_vis"], jr._baked_exposure))


_FRAGS: dict = {}


def _screen_fragments():
    """JAX's resolved opaque fragments of the ``shadows_pcf`` TSS frame
    and its merged light table, for both packages (memoized): (jr, JAX
    fragments, JAX light8, port scene, port fragments, port light8, ah,
    aw, JAX setup, G-buffer)."""
    if "f" not in _FRAGS:
        from renderengine_tpu.raster import reference_raster as jrref
        from renderengine_tpu.raster.setup import corner_clip as jcc
        from renderengine_tpu.raster.setup import \
            triangle_setup_corners as jtsc

        jr, _ = _jax_tss()
        jsd = jr.scene_dev
        cfg = _port_cfg()
        u = jnp.asarray(jr.uniform_for_camera())
        p = jframe.unpack_params(u, jr.n_shadows)
        vpm = (p["proj"][:, :, None] * p["view"][None, :, :]).sum(1)
        js = jtsc(jcc(jsd["corner_attr"][..., 0:3], vpm), jsd["n_opaque"],
                  cfg.width, cfg.height, jr.config.cull_mode)
        g = jrref.rasterize_reference(js, cfg.height, cfg.width)
        fr = jlc.resolve_tss(jsd, js.coef, g, cfg.height, cfg.width)
        ah, aw = jsd["chart_ld"].shape[1:]
        jl8 = jlc.merge_light_planes(jsd["chart_ld"], jsd["chart_ld"])
        sd = _port_scene(jr)
        tl8 = torch.from_numpy(np.array(jl8).view(np.int32))
        t = {k: torch.from_numpy(np.array(np.asarray(fr[k])))
             for k in ("chart_uv", "uv", "mat_id", "covered")}
        _FRAGS["f"] = (jr, fr, jl8, sd, t, tl8, ah, aw, js, g)
    return _FRAGS["f"]


def test_screen_shade_matches_jax_on_the_same_fragments():
    """``tss_shade`` / ``tss_shade_halfres`` (albedo tap + light table) on
    JAX's resolved opaque fragments and light table."""
    jr, fr, jl8, sd, t, tl8, ah, aw, js, g = _screen_fragments()
    jsd = jr.scene_dev
    cfg = _port_cfg()
    assert t["covered"].float().mean() > 0.5
    for dither in (False, True):
        kw = dict(slots_used=jr._slots_used, max_aniso=cfg.aniso(),
                  dither=dither)
        jkw = dict(kw, max_aniso=jr.config.aniso())
        _close(lc.tss_shade(sd, t["chart_uv"], t["uv"], t["mat_id"], tl8,
                            ah, aw, covered=t["covered"], **kw).numpy(),
               jlc.tss_shade(jsd, fr["chart_uv"], fr["uv"], fr["mat_id"], jl8,
                             ah, aw, covered=fr["covered"], **jkw))
        _close(lc.tss_shade_halfres(sd, t["chart_uv"], t["uv"], t["mat_id"],
                                    tl8, ah, aw, covered=t["covered"],
                                    **kw).numpy(),
               jlc.tss_shade_halfres(jsd, fr["chart_uv"], fr["uv"],
                                     fr["mat_id"], jl8, ah, aw,
                                     covered=fr["covered"], **jkw))
    # the port's resolve from the same G-buffer and setup
    tg = type(g)(*(None if x is None else torch.from_numpy(np.array(x))
                   for x in g))
    tr = lc.resolve_tss(sd, torch.from_numpy(np.array(js.coef)), tg,
                        cfg.height, cfg.width)
    for k in ("chart_uv", "uv"):
        _close(tr[k].numpy(), fr[k])
    assert torch.equal(tr["mat_id"], t["mat_id"])


# (y0, dither, max_taps, slot 0 used) of a screen-pass call: the headline's
# settings first
SHADE_SETTINGS = {"dither_aniso16": (0, True, 16, True),
                  "exact_aniso16": (0, False, 16, True),
                  "dither_trilinear": (0, True, 1, True),
                  "exact_trilinear": (0, False, 1, True),
                  "no_base_slot": (0, True, 16, False),
                  "band_y0_odd": (1, True, 16, True)}


@pytest.mark.parametrize("setting", list(SHADE_SETTINGS))
def test_shade_wrapper_on_the_cpu_is_the_plain_composition(setting):
    """``tss_shade_halfres`` on CPU tensors (JAX's fragments of the
    ``shadows_pcf`` frame) is ``tss_shade_halfres_plain``, bit for bit,
    and launches nothing; a band starting on an odd row takes the rows
    after the first (an even count)."""
    jr, _, _, sd, t, tl8, ah, aw, _, _ = _screen_fragments()
    y0, dither, taps, slot0 = SHADE_SETTINGS[setting]
    planes = [t[k][y0:] for k in ("chart_uv", "uv", "mat_id", "covered")]
    if y0 % 2:
        planes = [p[:p.shape[0] // 2 * 2] for p in planes]
    kw = dict(y0=y0, dither=dither, covered=planes[3],
              max_aniso=_port_cfg().aniso()._replace(max_taps=taps),
              slots_used=(slot0,) + tuple(jr._slots_used[1:]))
    before = dict(cr.launch_counts)
    got = lc.tss_shade_halfres(sd, *planes[:3], tl8, ah, aw, **kw)
    assert dict(cr.launch_counts) == before
    want = lc.tss_shade_halfres_plain(sd, *planes[:3], tl8, ah, aw, **kw)
    assert got.shape == planes[0].shape[:2] + (4,)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _bad_shade_args(case):
    """Synthetic screen-pass arguments (``aniso_inputs.tss_shade_case``)
    with one fault: (args, kwargs, the error's words)."""
    sc, cu, uv, mat, l8, ah, aw, cov = ai.tss_shade_case(3, 12, 20)
    kw = {"covered": cov}
    if case == "chart_uv_float64":
        cu = cu.double()
    elif case == "uv_shape":
        uv = uv[:, 1:]
    elif case == "mat_id_int64":
        mat = mat.long()
    elif case == "covered_uint8":
        kw["covered"] = cov.to(torch.uint8)
    elif case == "light8_shape":
        l8 = l8[1:]
    elif case == "mat_all_float32":
        sc = dict(sc, mat_all=sc["mat_all"].float())
    elif case == "odd_band_height":
        cu, uv, mat = cu[1:], uv[1:], mat[1:]
        kw = {"covered": cov[1:], "y0": 1}
    elif case == "one_row":
        cu, uv, mat = cu[:1], uv[:1], mat[:1]
        kw = {"covered": cov[:1]}
    elif case == "device_mix":
        l8 = torch.empty_like(l8, device="meta")
    words = {"chart_uv_float64": "chart_uv", "uv_shape": "uv must",
             "mat_id_int64": "mat_id", "covered_uint8": "covered",
             "light8_shape": "light8", "mat_all_float32": "float16",
             "odd_band_height": "even height", "one_row": "2 x 2",
             "device_mix": "device"}[case]
    return (sc, cu, uv, mat, l8, ah, aw), kw, words


@pytest.mark.parametrize("case", [
    "chart_uv_float64", "uv_shape", "mat_id_int64", "covered_uint8",
    "light8_shape", "mat_all_float32", "odd_band_height", "one_row",
    "device_mix"])
def test_shade_wrapper_refuses_bad_arguments(case):
    """The wrapper checks dtypes, shapes and devices on every device (the
    same checks guard the kernel's launch) before anything runs."""
    args, kw, words = _bad_shade_args(case)
    with pytest.raises(ValueError, match=words):
        lc.tss_shade_halfres(*args, **kw)


# --- mirror of TestPreshadedHalfres ------------------------------------------

def test_preshaded_halfres_parity():
    """The dense pre-shaded half-grid gather + guided upsample is
    near-lossless against the full-res pre-shaded gather at the same
    density (bounds of ``tests/test_lightchart.py``)."""
    factory = {n: f for n, f, _ in goldens.golden_cases()}["shadows_pcf"]
    cfg = _port_cfg().replace(chart_density=0.5)
    full, _ = FrameRenderer(factory(), cfg.replace(tss_halfres_light=0),
                            device="cpu").render()
    half, _ = FrameRenderer(factory(), cfg.replace(tss_halfres_light=1),
                            device="cpu").render()
    d = (full.int() - half.int()).abs().amax(-1).numpy()
    assert d.mean() < 2.0, d.mean()
    assert (d <= 16).mean() > 0.97, (d <= 16).mean()
    assert (d > 0).any()
