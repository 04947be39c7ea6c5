"""The row-band form of the frame (``graph.frame._frame_core(y0=...,
slice_h=...)``), which the sharded renderer runs one band a rank.

Tolerance, stated: the bands of a frame, stacked, equal the whole frame
byte for byte (same budgets, every overflow counter 0), for any band
heights, odd ones and bands that start mid-tile included (540 of the
1080p frame over two ranks is 4 rows into an 8-row tile):
``parallel.sharded.render_band`` renders whole tile rows and crops them,
so quad pairs, the dither pattern, the half-res grids and every
per-tile-row selection see the whole frame's rows. Against the JAX
package's band (its ``_frame_core(y0, slice_h)`` run outside ``jit``, as
``tests/test_torch_frame.py`` holds whole frames because of ROADMAP F1),
the port's band meets the golden bar: within 1/255 on >= 99.9% of pixels,
max 4/255 (both measure within 1/255 everywhere).

Where the port does more than the JAX body (ROADMAP F12): the dense
binning's corner cull tests a band's tiles where they lie in the whole
frame, and ``render_band`` widens a band to whole tile rows, plus
``BAND_HALO`` rows below it for the half-resolution passes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden_configs
from renderengine_tpu.graph import frame as jframe
from renderengine_tpu.graph.uniforms import unpack_params as junpack

from renderengine_tpu_torch.core.config import RenderConfig
from renderengine_tpu_torch.graph import frame as tframe
from renderengine_tpu_torch.graph.frame import FrameRenderer
from renderengine_tpu_torch.graph.uniforms import unpack_params
from renderengine_tpu_torch.parallel import sharded
from renderengine_tpu_torch.raster import cuda_raster as cr
from renderengine_tpu_torch.raster.setup import restrict_rows
from renderengine_tpu_torch.scene import procedural
from renderengine_tpu_torch.tools import goldens

torch.set_num_threads(2)

W, H = 64, 40          # 40 rows: two bands of 20 start mid-tile at row 20


def _sponza():
    return procedural.sponza_scene(width=W, height=H, n_textures=4,
                                   target_tris=400)


# the configs of tests/test_sharded.py at 64x40, and the texture-space
# headline (half-res sky and light, dithered sampling)
CONFIGS = {
    "full_features": dict(shadow_extent=32, grid=True),
    "texture_space": dict(shadow_extent=32, translucency=True,
                          debug_views=False, texture_space=True,
                          tss_preshaded_blend=True, chart_density=1.0),
    "tss_headline": dict(shadow_extent=32, debug_views=False,
                         texture_space=True, tss_preshaded_blend=True,
                         dither_trilinear=True, sky_halfres=True),
}


def _frame_and_bands(r, bands, halo=True):
    """The renderer's frame (rendered first, so its shadow maps exist) and
    the same frame as stacked bands [(y0, rows), ...] with its budgets."""
    img, st = r.render()
    sd = r.scene_dev
    params = unpack_params(torch.from_numpy(r.uniform_for_camera()),
                           r.n_shadows)
    vo = tframe.cached_vertex_outputs(sd, params["view"], params["proj"])
    kw = dict(shadow_lights=r._shadow_lights, has_mask=r._has_mask,
              alpha_is_factor=r._alpha_is_factor)
    args = (sd, params, vo, r._shadow_maps, r.config, r.n_shadows,
            r.backend, r._has_translucent, r._slots_used)
    parts = []
    for y0, rows in bands:
        if halo:
            b, bst = sharded.render_band(*args, y0, rows, **kw)
        else:
            b, bst = tframe._frame_core(*args, y0=y0, slice_h=rows, **kw)
        assert not any(int(v) for k, v in bst.items() if "overflow" in k)
        parts.append(b)
    assert not any(int(v) for k, v in st.items() if "overflow" in k)
    return img, torch.cat(parts, 0)


@pytest.mark.parametrize("backend", ["cuda", "reference"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_bands_stack_to_the_frame(name, backend):
    """Two bands of 20 rows (the second starts mid-tile), three of 8, 16
    and 16, and three of 5, 13 and 22 (odd heights, starts off the dither
    pattern), stacked, equal the whole frame byte for byte."""
    cfg = RenderConfig(width=W, height=H, **CONFIGS[name])
    r = FrameRenderer(_sponza(), cfg, device="cpu", backend=backend)
    for bands in ([(0, 20), (20, 20)], [(0, 8), (8, 16), (24, 16)],
                  [(0, 5), (5, 13), (18, 22)]):
        img, stacked = _frame_and_bands(r, bands)
        assert torch.equal(stacked, img), (bands, int(
            (stacked != img).any(-1).sum()))


def test_half_res_bands_need_the_halo():
    """On the band's own rows the half-res passes clamp at a band's last
    row, as the JAX package's do (ROADMAP F12): only row 19 moves, and
    ``render_band`` puts it back. ``band_extent`` widens a band to whole
    8-row tiles (24 with SSAA 3) and, where a half-res pass runs, past
    its end by the halo."""
    cfg = RenderConfig(width=W, height=H, **CONFIGS["tss_headline"])
    r = FrameRenderer(_sponza(), cfg, device="cpu")
    img, clamped = _frame_and_bands(r, [(0, 20), (20, 20)], halo=False)
    rows = torch.nonzero((clamped != img).any(-1).any(-1)).flatten()
    assert rows.tolist() == [19]
    assert sharded.band_extent(cfg, 0, 16) == (0, 16 + 8)
    assert sharded.band_extent(cfg, 20, 20) == (16, H)
    plain = cfg.replace(sky_halfres=False, chart_density=1.0)
    assert sharded.band_extent(plain, 0, 16) == (0, 16)
    assert sharded.band_extent(plain, 21, 5) == (16, 32)
    assert sharded.band_extent(plain.replace(ssaa=3), 6, 6) == (0, 24)


def test_tile_row_selection_needs_whole_tile_rows():
    """``shade_sparse`` keeps k tiles a tile row, the most covered first.
    Coverage built so that rows 16-23 (a frame tile row) lead on the left
    and rows 20-27 (the first tile row of a band from row 20) on the
    right: on its own rows the band keeps other tiles than the frame;
    on ``band_extent``'s rows (from 16), cropped, it keeps the frame's."""
    h, w = 40, 256
    cov = torch.zeros(h, w, dtype=torch.bool)
    cov[16:20, 0:100] = True
    cov[20:24, 128:160] = True

    def shade(fr):
        return fr["covered"].float()[..., None].expand(
            *fr["covered"].shape, 4)

    def kept(rows):
        return tframe.shade_sparse(shade, {"covered": cov[rows]},
                                   rows.stop - rows.start, w, 8, 128,
                                   max_tiles=5, full_height=h)

    full = kept(slice(0, h))
    assert not torch.equal(kept(slice(20, h)), full[20:])
    ys, ye = sharded.band_extent(RenderConfig(width=w, height=h), 20, 20)
    assert (ys, ye) == (16, h)
    assert torch.equal(kept(slice(ys, ye))[20 - ys:], full[20:])


def test_dense_binning_culls_band_tiles_where_they_lie():
    """K1's pair tables of a band, binned on the dense grid with the
    estimated ``dense_k``: the band's raster equals the whole frame's rows
    (the corner cull tests the band's tiles at their full-frame rows; with
    the band's own height as the viewport, live pairs were dropped)."""
    cfg = RenderConfig(width=W, height=H, **CONFIGS["full_features"])
    r = FrameRenderer(_sponza(), cfg, device="cpu")
    assert r.config.raster.dense_k
    sd = r.scene_dev
    params = unpack_params(torch.from_numpy(r.uniform_for_camera()),
                           r.n_shadows)
    s = tframe.opaque_setup(sd, params, r.config)
    g, a = cr.rasterize_cuda(s, H, W, prepared=tframe.opaque_pairs(
        sd, s, r.config))
    for y0, hs in ((8, 32), (20, 20), (12, 16)):
        ss = restrict_rows(s, y0, hs, H)
        prep = tframe.opaque_pairs(sd, ss, r.config, hs, y0)
        gb, ab = cr.rasterize_cuda(ss, hs, W, prepared=prep, y0=y0,
                                   full_height=H)
        assert torch.equal(gb.tri_id, g.tri_id[y0:y0 + hs]), y0
        assert torch.equal(gb.depth, g.depth[y0:y0 + hs])
        assert torch.equal(ab, a[y0:y0 + hs])


def test_band_skips_the_shadow_quad_and_checks_ssaa():
    """The shadow-map preview quad is anchored to a screen corner: the
    whole frame draws it, a band does not (as in the JAX package); a band
    whose height does not divide by the SSAA factor is refused."""
    cfg = RenderConfig(width=W, height=H, shadow_extent=64,
                       translucency=False, show_shadow_quad=True)
    r = FrameRenderer(_sponza(), cfg, device="cpu")
    img, stacked = _frame_and_bands(r, [(0, H)])
    assert torch.equal(img, stacked)
    _, top = _frame_and_bands(r, [(0, 20)])
    plain = FrameRenderer(_sponza(), cfg.replace(show_shadow_quad=False),
                          device="cpu").render()[0]
    assert torch.equal(top, plain[:20]) and not torch.equal(top, img[:20])
    r2 = FrameRenderer(_sponza(), cfg.replace(ssaa=2, show_shadow_quad=False),
                       device="cpu")
    with pytest.raises(ValueError, match="SSAA"):
        _frame_and_bands(r2, [(0, 21)], halo=False)


@pytest.mark.parametrize("name", ["shadows_pcf", "skybox_full"])
def test_band_against_the_jax_band(name):
    """The rows [44, 84) of a golden config (a band that starts mid-tile)
    through the port's ``_frame_core`` and through the JAX package's,
    outside ``jit``, both on the brute-force raster: the golden bar."""
    y0, hs = 44, 40
    _, jfac, jcfg = [c for c in golden_configs.golden_cases()
                     if c[0] == name][0]
    jr = jframe.FrameRenderer(jfac(), jcfg, backend="reference")
    ju = jnp.asarray(jr.uniform_for_camera())
    maps = None
    if jr.n_shadows:
        maps = jframe.render_shadow_pass(jr.scene_dev, ju, jcfg, jr.n_shadows,
                                         backend="reference")
    jp = junpack(ju, jr.n_shadows)
    jvo = jframe.cached_vertex_outputs(jr.scene_dev, jp["view"], jp["proj"])
    jband, _ = jframe._frame_core(
        jr.scene_dev, jp, jvo, maps, jcfg, jr.n_shadows, "reference",
        jr._has_translucent, jr._slots_used, y0=y0, slice_h=hs,
        shadow_lights=jr._shadow_lights, has_mask=jr._has_mask)
    _, factory, cfg = [c for c in goldens.golden_cases() if c[0] == name][0]
    r = FrameRenderer(factory(), cfg, device="cpu", backend="reference")
    _, band = _frame_and_bands(r, [(y0, hs)], halo=False)
    frac, mx = goldens.golden_bar(band.numpy(), np.asarray(jband))
    assert goldens.meets_bar(frac, mx), (frac, mx)
    assert frac == 1.0 and mx <= 1, (frac, mx)
