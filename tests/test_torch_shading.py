"""Shading: the same fragment inputs (numpy) through the JAX package's
shading functions, run op by op, and the port's.

Tolerances, stated:
- ``det_log2``, ``quad_dfdx``/``quad_dfdy``/``quad_derivs`` and the per-row
  segment selection are exact (bit ops, subtractions, integer counts).
- texture taps (trilinear, dense and tiered 16x aniso) within 2e-6: the
  same f32 ops in the same order, up to the rounding of library
  transcendentals (measured 0).
- ``brdf_lighting`` (all debug views), ``phong_lighting``: within 2e-4
  absolute + 2e-4 relative (``pow`` and ``sqrt`` of two libraries).
- ``encode_srgb8``: within 1/255 (a ``pow`` ulp can cross a rounding
  boundary), equal on >= 99.9% of channels.
- cubemap taps (``sample_cubemap``, ``sample_cubemap_f32``) and the skybox
  (``render_skybox``, ``render_skybox_halfres``) within 2e-6, except where
  a ray lies within rounding of a texel or face boundary and the two
  packages pick neighbouring texels (at most 0.1% of pixels).
- ``shade_sparse``: the selected tiles and the scattered result are equal
  (integer counts, ties to the lowest tile index).
- shadowed and ``ibl_diffuse`` lighting within 2e-4 absolute + 2e-4
  relative; with shadows at most 0.1% of pixels may sit outside it, where
  a PCF tap's compare hangs on the last bit of the threshold (a tap moves
  the factor by 1/9)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from renderengine_tpu.graph import frame as jframe
from renderengine_tpu.graph.uniforms import unpack_params as junpack
from renderengine_tpu.shading import pbr as jpbr
from renderengine_tpu.shading import phong as jphong
from renderengine_tpu.shading import sampling as jsmp
from renderengine_tpu.shading import shadow as jshadow
from renderengine_tpu.shading import skybox as jsky
from renderengine_tpu.shading.srgb import encode_srgb8 as jencode
from renderengine_tpu_torch.core.config import DebugEquation, DebugInput
from renderengine_tpu_torch.graph import frame as tframe
from renderengine_tpu_torch.graph.uniforms import unpack_params
from renderengine_tpu_torch.raster.reference_raster import rasterize_reference
from renderengine_tpu_torch.raster.setup import (corner_clip,
                                                 triangle_setup_corners,
                                                 viewproj)
from renderengine_tpu_torch.shading import pbr as tpbr
from renderengine_tpu_torch.shading import phong as tphong
from renderengine_tpu_torch.shading import sampling as tsmp
from renderengine_tpu_torch.shading import skybox as tsky
from renderengine_tpu_torch.shading.srgb import encode_srgb8
from renderengine_tpu_torch.tools import goldens

torch.set_num_threads(2)

_CASES = {n: (f, c) for n, f, c in goldens.golden_cases()}


def _frag(name):
    """Fragments of a golden view from the port's reference pipeline, as
    numpy, plus the scene dict (numpy and torch) and the uniforms."""
    factory, cfg = _CASES[name]
    r = tframe.FrameRenderer(factory(), cfg, device="cpu",
                             backend="reference")
    u = torch.from_numpy(r.uniform_for_camera())
    p = unpack_params(u, r.n_shadows)
    sc = r.scene_dev
    vo = tframe.cached_vertex_outputs(sc, p["view"], p["proj"])
    s = triangle_setup_corners(
        corner_clip(sc["corner_attr"][..., :3], viewproj(p["view"], p["proj"])),
        sc["n_opaque"], cfg.width, cfg.height, cfg.cull_mode)
    g = rasterize_reference(s, cfg.height, cfg.width)
    frag = tframe.resolve_attributes(sc, vo, s.coef, g, cfg.height, cfg.width)
    frag = {k: v.numpy() for k, v in frag.items()}
    jdev = r.scene_host.upload()
    return frag, jdev, sc, u.numpy(), r._slots_used, cfg


@pytest.fixture(scope="module")
def orm():
    return _frag("normal_orm")


def _t(x):
    return torch.from_numpy(np.array(x))


def test_det_log2_bit_exact():
    rng = np.random.default_rng(3)
    x = np.concatenate([
        np.exp2(rng.uniform(-60, 60, 4000)), rng.uniform(1e-6, 4, 4000),
        2.0 ** np.arange(-40, 40), [1e-40, 1e-20, 1.0, 3.0]]).astype(np.float32)
    a = tsmp.det_log2(_t(x)).numpy()
    b = np.asarray(jsmp.det_log2(jnp.asarray(x)))
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("shape", [(12, 16, 2), (11, 15, 3), (9, 7)])
def test_quad_derivs_exact(shape):
    rng = np.random.default_rng(5)
    v = rng.uniform(-3, 3, shape).astype(np.float32)
    cov = rng.uniform(size=shape[:2]) > 0.3
    for c in (None, cov):
        jd = jsmp.quad_derivs(jnp.asarray(v),
                              None if c is None else jnp.asarray(c))
        td = tsmp.quad_derivs(_t(v), None if c is None else _t(c))
        for a, b in zip(td, jd):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_topk_ties_go_to_lowest_index():
    """Hazard H2: ``jax.lax.top_k`` breaks ties to the lowest index;
    ``torch.topk`` does not promise that, a stable descending sort does."""
    vals = torch.tensor([5, 7, 7, 3, 7, 5])
    idx = torch.sort(vals, descending=True, stable=True).indices[:3]
    assert idx.tolist() == [1, 2, 4]
    rng = np.random.default_rng(9)
    member = rng.uniform(size=(16, 1000)) > 0.6
    member[:, 128:256] = member[:, 0:128]          # tied segment counts
    member[:, 512:640] = member[:, 0:128]
    for frac in (0.25, 0.15, 0.08):
        ts, tk = tsmp.select_row_segments(_t(member), 128, frac)
        js, jk = jsmp.select_row_segments(jnp.asarray(member), 128, frac)
        assert tk == jk
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("n_idx", [3, 3000])    # JAX: gather, one-hot dot
def test_table_lookups_exact(orm, n_idx):
    """The port's plain gathers equal JAX's row fetches, including the
    one-hot matmul path JAX takes for many indices into a small table."""
    _, jdev, *_ = orm
    table = np.asarray(jdev["mat_all"])
    idx = np.random.default_rng(2).integers(0, table.shape[0], (n_idx,),
                                            dtype=np.int32)
    np.testing.assert_array_equal(
        tsmp.table_lookup(_t(table), _t(idx)).numpy(),
        np.asarray(jsmp.table_lookup(jnp.asarray(table), jnp.asarray(idx))))
    cols = (0, 3, 16, 39)
    np.testing.assert_array_equal(
        tsmp.table_lookup_planar(_t(table), _t(idx), cols).numpy(),
        np.asarray(jsmp.table_lookup_planar(jnp.asarray(table),
                                            jnp.asarray(idx), cols)))


def _slot_planes(frag, jdev, si):
    from renderengine_tpu.shading.pbr import _slot
    row = np.asarray(jdev["mat_all"], np.float32)[
        np.asarray(frag["mat_id"], np.int64)]
    d = _slot(jnp.asarray(row[..., 16:]), si)
    return {k: np.asarray(v) for k, v in d.items()}


def test_trilinear_and_dense_aniso_taps(orm):
    frag, jdev, sc, *_ = orm
    tex = _slot_planes(frag, jdev, 0)
    rng = np.random.default_rng(11)
    uv = frag["uv"]
    lod = rng.uniform(-1, 8, uv.shape[:2]).astype(np.float32)
    ja = dict(atlas=jnp.asarray(jdev["atlas"]), mip_y=jnp.asarray(jdev["mip_y"]),
              mip_x=jnp.asarray(jdev["mip_x"]))
    planes = ("page", "x", "y", "w", "h")
    jt = {k: jnp.asarray(tex[k]) for k in planes}
    tt = {k: _t(tex[k]) for k in planes}
    nm = tex["n_mips"]
    a = tsmp.sample_texture_rows(sc["atlas"], sc["mip_y"], sc["mip_x"], tt,
                                 _t(nm), _t(uv), _t(lod)).numpy()
    b = np.asarray(jsmp.sample_texture_rows(ja["atlas"], ja["mip_y"],
                                            ja["mip_x"], jt, jnp.asarray(nm),
                                            jnp.asarray(uv), jnp.asarray(lod)))
    np.testing.assert_allclose(a, b, atol=2e-6, rtol=0)
    dx, dy = jsmp.quad_derivs(jnp.asarray(uv), jnp.asarray(frag["covered"]))
    a = tsmp.sample_texture_aniso(sc["atlas"], sc["mip_y"], sc["mip_x"], tt,
                                  _t(nm), _t(uv), _t(dx), _t(dy), 8).numpy()
    b = np.asarray(jsmp.sample_texture_aniso(
        ja["atlas"], ja["mip_y"], ja["mip_x"], jt, jnp.asarray(nm),
        jnp.asarray(uv), dx, dy, 8))
    np.testing.assert_allclose(a, b, atol=2e-6, rtol=0)


def test_tiered_aniso_taps(orm):
    frag, jdev, sc, *_ = orm
    cov = frag["covered"]
    dx, dy = jsmp.quad_derivs(jnp.asarray(frag["uv"]), jnp.asarray(cov))
    spec_j = jsmp.AnisoSpec(16, (0.25, 0.15, 0.08), (16, 4, 4, 4))
    spec_t = tsmp.AnisoSpec(16, (0.25, 0.15, 0.08), (16, 4, 4, 4))
    slots = [_slot_planes(frag, jdev, si) for si in (0, 2, 3)]
    planes = ("page", "x", "y", "w", "h")
    jout = jsmp.sample_slots_aniso_tiered(
        jnp.asarray(jdev["atlas"]), jnp.asarray(jdev["mip_y"]),
        jnp.asarray(jdev["mip_x"]),
        [({k: jnp.asarray(s[k]) for k in planes}, jnp.asarray(s["n_mips"]))
         for s in slots], jnp.asarray(frag["uv"]), dx, dy, spec_j,
        slot_caps=[16, 4, 4])
    tout = tsmp.sample_slots_aniso_tiered(
        sc["atlas"], sc["mip_y"], sc["mip_x"],
        [({k: _t(s[k]) for k in planes}, _t(s["n_mips"])) for s in slots],
        _t(frag["uv"]), _t(dx), _t(dy), spec_t, slot_caps=[16, 4, 4])
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.numpy()[cov], np.asarray(b)[cov],
                                   atol=2e-6, rtol=0)


def _shade_both(case, jfn, tfn, debug_input=0, debug_equation=0,
                max_aniso=None):
    frag, jdev, sc, u, slots, cfg = case
    u = u.copy()
    u[36], u[37] = debug_input, debug_equation
    jp = junpack(jnp.asarray(u), 0)
    tp = unpack_params(_t(u), 0)
    keys = ("view_pos", "exposure", "debug_input", "debug_equation")
    spec = cfg.aniso() if max_aniso is None else max_aniso
    jspec = jsmp.AnisoSpec(*spec) if isinstance(spec, tuple) else spec
    a = tfn(sc, _t(frag["pos"]), _t(frag["uv"]), _t(frag["normal"]),
            _t(frag["mat_id"]), {k: tp[k] for k in keys}, slots_used=slots,
            max_aniso=spec, covered=_t(frag["covered"])).numpy()
    b = np.asarray(jfn({k: jnp.asarray(v) for k, v in jdev.items()},
                       jnp.asarray(frag["pos"]), jnp.asarray(frag["uv"]),
                       jnp.asarray(frag["normal"]), jnp.asarray(frag["mat_id"]),
                       {k: jp[k] for k in keys}, slots_used=slots,
                       max_aniso=jspec, covered=jnp.asarray(frag["covered"])))
    cov = frag["covered"]
    np.testing.assert_allclose(a[cov], b[cov], atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("view", [
    (DebugInput.NONE, DebugEquation.NONE),
    (DebugInput.NORMALS, DebugEquation.NONE),
    (DebugInput.ROUGHNESS, DebugEquation.NONE),
    (DebugInput.NONE, DebugEquation.GEOMETRY),
    (DebugInput.NONE, DebugEquation.SPECULAR)])
def test_brdf_lighting_with_debug_views(orm, view):
    _shade_both(orm, jpbr.brdf_lighting, tpbr.brdf_lighting,
                int(view[0]), int(view[1]))


def test_phong_lighting_trilinear():
    case = _frag("cube_phong")
    _shade_both(case, jphong.phong_lighting, tphong.phong_lighting,
                max_aniso=1)


def test_encode_srgb8():
    rng = np.random.default_rng(4)
    x = rng.uniform(-0.2, 1.3, (64, 64, 3)).astype(np.float32)
    a = encode_srgb8(_t(x)).numpy().astype(np.int32)
    b = np.asarray(jencode(jnp.asarray(x))).astype(np.int32)
    assert np.abs(a - b).max() <= 1
    assert (a == b).mean() >= 0.999


# --- cubemap, skybox, sparse shading, shadowed and IBL lighting --------------

def _close_but_for(a, b, atol, rtol=0.0, share=1e-3):
    """|a - b| <= atol + rtol*|b| on all but ``share`` of the leading
    (pixel) entries."""
    bad = np.abs(a - b) > atol + rtol * np.abs(b)
    bad = bad.reshape(bad.shape[0], -1).any(-1) if bad.ndim > 1 else bad
    assert bad.mean() <= share, f"{bad.sum()} of {bad.size} outside"


@pytest.fixture(scope="module")
def sky_scene():
    factory, _ = _CASES["skybox_full"]
    return factory().upload()


def test_sample_cubemaps(sky_scene):
    rng = np.random.default_rng(6)
    dirs = rng.normal(size=(4000, 3)).astype(np.float32)
    dirs[:6] = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    dirs[6:9] = [[1, 1, 0.2], [-1, 0.3, -1], [0.5, -0.5, 0.5]]   # face ties
    cube = np.asarray(sky_scene["cubemap"])
    a = tsmp.sample_cubemap(_t(cube.view(np.int32)), _t(dirs)).numpy()
    b = np.asarray(jsmp.sample_cubemap(jnp.asarray(cube), jnp.asarray(dirs)))
    assert a.shape == (4000, 4) and b.std() > 0.01
    _close_but_for(a, b, 2e-6)
    irr = np.asarray(sky_scene["irradiance"])
    assert irr.dtype == np.float32 and irr.shape[-1] == 16
    a = tsmp.sample_cubemap_f32(_t(irr), _t(dirs)).numpy()
    b = np.asarray(jsmp.sample_cubemap_f32(jnp.asarray(irr),
                                           jnp.asarray(dirs)))
    _close_but_for(a, b, 2e-6)


@pytest.mark.parametrize("halfres", [False, True])
@pytest.mark.parametrize("h,w,y0,fh", [(96, 128, 0, None), (31, 53, 40, 96)])
def test_render_skybox(sky_scene, halfres, h, w, y0, fh):
    factory, cfg = _CASES["skybox_full"]
    r = tframe.FrameRenderer(factory(), cfg, device="cpu",
                             backend="reference")
    m = r.params_for_camera()["inv_vp_rot"]
    cube = np.asarray(sky_scene["cubemap"])
    tfn = tsky.render_skybox_halfres if halfres else tsky.render_skybox
    jfn = jsky.render_skybox_halfres if halfres else jsky.render_skybox
    a = tfn(_t(cube.view(np.int32)), _t(m), h, w, y0=y0,
            full_height=fh).numpy()
    b = np.asarray(jfn(jnp.asarray(cube), jnp.asarray(m), h, w, y0=y0,
                       full_height=fh))
    assert a.shape == (h, w, 4) and b[..., :3].std() > 0.01
    _close_but_for(a.reshape(-1, 4), b.reshape(-1, 4), 2e-6)


@pytest.mark.parametrize("max_tiles", [4, 10, 24])
def test_shade_sparse_selection_equals_jax_on_ties(max_tiles):
    """4 tile columns x 6 tile rows; several tiles of a row hold the same
    number of covered pixels, so the per-row top-k must break ties to the
    lowest tile index as ``jax.lax.top_k`` does."""
    rng = np.random.default_rng(8)
    h, w = 45, 500                        # partial last tile row and column
    cov = np.zeros((h, w), bool)
    for ty in range(6):
        for tx in range(4):
            n = [3, 7, 7, 7][(tx + ty) % 4] if ty != 2 else 5
            blk = cov[ty * 8:ty * 8 + 8, tx * 128:tx * 128 + 100]
            blk.reshape(-1)[:0] = False
            idx = rng.choice(blk.size, size=min(n, blk.size), replace=False)
            yy, xx = np.unravel_index(idx, blk.shape)
            blk[yy, xx] = True
    val = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)

    def shade_t(fr):
        return torch.cat([fr["val"], fr["covered"][..., None].float()], -1)

    def shade_j(fr):
        return jnp.concatenate(
            [fr["val"], fr["covered"][..., None].astype(jnp.float32)], -1)

    a = tframe.shade_sparse(shade_t, {"covered": _t(cov), "val": _t(val)},
                            h, w, 8, 128, max_tiles=max_tiles).numpy()
    b = np.asarray(jframe.shade_sparse(
        shade_j, {"covered": jnp.asarray(cov), "val": jnp.asarray(val)},
        h, w, 8, 128, max_tiles=max_tiles))
    np.testing.assert_array_equal(a, b)
    assert 0 < (a[..., 3] > 0).sum() <= cov.sum()
    if max_tiles == 24:
        assert (a[..., 3] > 0).sum() == cov.sum()
    else:
        assert (a[..., 3] > 0).sum() < cov.sum()      # tiles were dropped


def _lit_both(case, jfn, tfn, r, tst=None, jst=None, **kw):
    """Shade a golden view's fragments with both packages on the port's
    packed shadow maps (``r`` has rendered them); ``tst``/``jst`` collect
    each package's penumbra counters."""
    frag, jdev, sc, u, slots, cfg = case
    ns = r.n_shadows
    jp = junpack(jnp.asarray(u), ns)
    tp = unpack_params(_t(u), ns)
    keys = ("view_pos", "exposure", "debug_input", "debug_equation")
    spec = cfg.aniso()
    jmaps = tmaps = jtf = ttf = None
    if ns:
        tmaps, ttf = r._shadow_maps, tp["shadow_viewproj"]
        jmaps = jshadow.ShadowPack(
            jnp.asarray(tmaps.blocks.numpy().view(np.uint32)),
            jnp.asarray(tmaps.coarse.numpy().view(np.uint32)))
        jtf = jp["shadow_viewproj"]
    a = tfn(sc, _t(frag["pos"]), _t(frag["uv"]), _t(frag["normal"]),
            _t(frag["mat_id"]), {k: tp[k] for k in keys}, tmaps, ttf,
            slots_used=slots, shadow_lights=r._shadow_lights, max_aniso=spec,
            covered=_t(frag["covered"]), shadow_stats=tst, **kw).numpy()
    b = np.asarray(jfn({k: jnp.asarray(v) for k, v in jdev.items()},
                       jnp.asarray(frag["pos"]), jnp.asarray(frag["uv"]),
                       jnp.asarray(frag["normal"]), jnp.asarray(frag["mat_id"]),
                       {k: jp[k] for k in keys}, jmaps, jtf, slots_used=slots,
                       shadow_lights=r._shadow_lights,
                       max_aniso=jsmp.AnisoSpec(*spec),
                       covered=jnp.asarray(frag["covered"]), shadow_stats=jst,
                       **kw))
    return a, b, frag["covered"]


def _shadowed_case(shading=None):
    factory, cfg = _CASES["shadows_pcf"]
    if shading is not None:
        cfg = cfg.replace(shading=shading)
    r = tframe.FrameRenderer(factory(), cfg, device="cpu",
                             backend="reference")
    r.render()                            # fills the shadow-map cache
    return r


@pytest.mark.parametrize("penumbra_tiles", [0, 12])
def test_shadowed_brdf_lighting(penumbra_tiles):
    r = _shadowed_case()
    jst, tst = [], []
    case = _frag("shadows_pcf")
    a, b, cov = _lit_both(case, jpbr.brdf_lighting, tpbr.brdf_lighting, r,
                          tst, jst, penumbra_tiles=penumbra_tiles,
                          penumbra_full_h=96)
    _close_but_for(a[cov], b[cov], 2e-4, 2e-4)
    # the shadows are there: the same fragments without maps come out brighter
    frag, _, sc, u, slots, cfg = case
    tp = unpack_params(_t(u), r.n_shadows)
    keys = ("view_pos", "exposure", "debug_input", "debug_equation")
    lit = tpbr.brdf_lighting(
        sc, _t(frag["pos"]), _t(frag["uv"]), _t(frag["normal"]),
        _t(frag["mat_id"]), {k: tp[k] for k in keys}, slots_used=slots,
        max_aniso=cfg.aniso(), covered=_t(frag["covered"])).numpy()
    darker = (a[cov][:, :3].sum(-1) < lit[cov][:, :3].sum(-1) - 1e-3).mean()
    assert 0.05 < darker < 0.95
    if penumbra_tiles:
        # one (penumbra tiles, overflow) entry per shadow-casting light
        assert len(tst) == len(jst) == 2
        assert [[int(x) for x in s] for s in tst] == \
            [[int(x) for x in s] for s in jst]


def test_shadowed_phong_lighting():
    from renderengine_tpu_torch.core.config import ShadingModel
    r = _shadowed_case(ShadingModel.PHONG)
    a, b, cov = _lit_both(_frag("shadows_pcf"), jphong.phong_lighting,
                          tphong.phong_lighting, r)
    _close_but_for(a[cov], b[cov], 2e-4, 2e-4)


def test_ibl_diffuse_lighting():
    factory, cfg = _CASES["ibl_diffuse"]
    r = tframe.FrameRenderer(factory(), cfg, device="cpu",
                             backend="reference")
    case = _frag("ibl_diffuse")
    a, b, cov = _lit_both(case, jpbr.brdf_lighting, tpbr.brdf_lighting, r,
                          ibl_diffuse=True)
    np.testing.assert_allclose(a[cov], b[cov], atol=2e-4, rtol=2e-4)
    flat, _, _ = _lit_both(case, jpbr.brdf_lighting, tpbr.brdf_lighting, r)
    assert np.abs(a[cov] - flat[cov]).max() > 1e-2     # the term is there
