"""The frame pipeline (torch port of the JAX package's ``graph/frame.py``:
the per-pixel path and texture-space shading).

This layer replaces the reference's command-buffer recording + render
passes (``RenderScene::Render``, ``RenderScene.cpp:168-242``) as straight
function composition over tensors: shadow depth pass -> opaque base pass
-> alpha-mask cutoff pass -> skybox -> depth-peeled translucency -> sRGB
encode. ``FrameRenderer`` uploads the scene once, sizes the static budgets
from the initial camera, caches the shadow maps until
``mark_shadows_dirty()`` and marshals one packed uniform vector per frame.
On a CUDA device it captures the frame, the shadow pass and, with
texture-space shading, the visibility and light-table bakes into CUDA
graphs (``graph/program.py``; the JAX package's jitted frame, shadow,
``_vis_fn`` and ``_ld_fn`` programs), once at init and again when what
they bind changes, and a warm ``render()`` replays the frame's graph
without a host sync; on the CPU the pass chain runs eagerly.

Texture-space shading (``RenderConfig.texture_space``,
``shading/lightchart.py``): the upload lays out and bakes light charts,
every shadow-dirty frame bakes per-texel visibility and the static light
tables, and each frame runs the specular chart pass; the screen passes
then sample the chart tables. On the ``cuda`` backend the opaque pass and
the first two translucent layers share one K2 launch.

The reactive runtime (``FrameRenderer``): budgets sized at init from the
initial camera, every frame's overflow counters copied to pinned host memory
without a host wait and consumed by a non-blocking poll, which grows what
overflowed and tightens the per-layer shade and penumbra budgets to the
observed coverage. The overlays (editor grid, shadow-map preview quad)
composite after the translucent pass.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging

import numpy as np
import torch

from ..core.config import CullMode, RasterConfig, RenderConfig, ShadingModel
from ..device import resolve_device
from ..raster import binning
from ..raster import cuda_raster
from ..raster import reference_raster as rref
from ..raster.setup import (VertexOutputs, clip_coords, corner_clip,
                            restrict_rows, triangle_setup,
                            triangle_setup_corners, viewproj)
from ..scene.camera import ViewProperties
from ..shading import fitting
from ..shading import grid as grid_mod
from ..shading import lightchart, pbr, phong, skybox
from ..shading import shadow as shadow_mod
from ..shading.srgb import encode_srgb8
from ..shading.textured_quad import draw_textured_quad
from ..utils import profiling
from ..utils.profiling import span
from . import uniforms
from .program import Programs
from .uniforms import unpack_params

BACKENDS = ("reference", "cuda")

_log = logging.getLogger(__name__)

# test hook: force separate opaque/peel launches even where the merged
# opaque+dual-peel kernel (K2) applies (parity tests compare both paths)
_FORCE_UNMERGED = False


def check_config(config: RenderConfig) -> None:
    """Raise ValueError for a texture-space config the mode does not
    support (it needs PBR without the alpha-mask pass and
    ``debug_views=False``, and the pre-shaded switches need
    ``texture_space``)."""
    if config.texture_space:
        if config.shading != ShadingModel.PBR or config.alpha_mask:
            raise ValueError("texture_space supports the PBR path without "
                             "the alpha-mask pass")
        if config.debug_views:
            raise ValueError("texture_space needs debug_views=False (the "
                             "factored screen pass has no debug taps)")
    elif config.tss_preshaded or config.tss_preshaded_blend:
        raise ValueError("tss_preshaded(_blend) requires texture_space=True")


def _static_shadow_lights(dev_np: dict) -> tuple:
    """Per-light "pays the shadow lookup" flags, decided once on the host
    so lights without a map skip the PCF window gather. 0 = no lookup;
    1 = planar map (directional or spot); 6 = point-light cube (six
    consecutive face maps)."""
    lt = np.asarray(dev_np["light_type"])
    si = np.asarray(dev_np["light_shadow_index"])
    nl = int(np.asarray(dev_np["n_lights"]))

    def flag(i: int) -> int:
        if not (i < nl and si[i] >= 0):
            return 0
        return {1: 1, 2: 6, 3: 1}.get(int(lt[i]), 0)

    return tuple(flag(i) for i in range(lt.shape[0]))


def scene_to_device(dev_np: dict, device) -> dict:
    """``Scene.upload()`` output (either package's) -> the port's device
    dict. Ints and floats keep their exact values and dtypes; the u32
    block tables (``atlas``, ``cubemap``) become int32 bit views, unpacked
    on the device with ``(w >> s) & mask``."""
    out = {}
    for k, v in dev_np.items():
        a = np.asarray(v)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out[k] = torch.from_numpy(np.array(a, order="C")).to(device)
    return out


def _pair_budget(n_tris: int, pairs_per_tri: int = 4) -> int:
    """Static pair-table budget. Overflow is counted, not silent."""
    return pairs_per_tri * n_tris + 8192


def cached_vertex_outputs(scene, view, proj) -> VertexOutputs:
    """Vertex stage over the world-space cache (static transforms paid at
    upload): per-frame work is one 4x4 application per vertex."""
    world = scene["world_pos"]
    clip = clip_coords(world, viewproj(view, proj))
    return VertexOutputs(world, scene["world_normal"], scene["uvs"], clip)


def _effective_tiles(rc: RasterConfig, backend: str) -> tuple[int, int]:
    """Binning tile dims per backend: the ``cuda`` kernel owns its 8x32
    tile; everything else counts in the RasterConfig's shade tiles."""
    if backend == "cuda":
        return cuda_raster.TILE_H, cuda_raster.TILE_W
    return rc.tile_h, rc.tile_w


def rasterize(setup, height: int, width: int, backend: str,
              y0: int = 0, full_height: int | None = None,
              peel_bounds=None, attr_planes=None, tri_mat=None,
              prepared=None, max_pairs: int | None = None,
              active_tiles: int | None = None, peel_layers: int = 1):
    """Raster backend dispatch. ``y0``/``full_height`` render a row slice
    of a taller viewport. Returns (GBuffer, attrs-or-None): the ``cuda``
    backend interpolates vertex attributes in-kernel when ``attr_planes``
    is given, and fills GBuffer.mat_id when ``tri_mat`` is given.
    ``prepared`` reuses a bin+pack across peel layers; ``peel_layers=2``
    (``cuda`` only) returns the two nearest layers of one launch as
    [(g, attrs), (g, attrs)]."""
    if backend == "cuda":
        out = cuda_raster.rasterize_cuda(
            setup, height, width, max_pairs=max_pairs, y0=y0,
            full_height=full_height, peel_bounds=peel_bounds,
            attr_planes=attr_planes, tri_mat=tri_mat, prepared=prepared,
            active_tiles=active_tiles, peel_layers=peel_layers)
        if peel_layers == 2:
            return out
        return (out, None) if isinstance(out, rref.GBuffer) else out
    if peel_layers == 2:
        raise ValueError("peel_layers=2 is a cuda-only fast path")
    if backend == "reference":
        return rref.rasterize_reference(
            setup, height, width, y0=y0, full_height=full_height,
            peel_bounds=peel_bounds), None
    raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")


def resolve_attributes(scene, vo: VertexOutputs, coef, g, height: int,
                       width: int, y0: int = 0,
                       full_height: int | None = None,
                       tri_table: str = "tri_packed"):
    """G-buffer resolve: per-pixel perspective-correct vertex attributes
    (replaces hardware attribute interpolation feeding surface_pbr.frag).
    Barycentrics come from the kernel when it filled ``g.bary``, else are
    recomputed from ``coef`` at the rows [y0, y0+height) of a
    ``full_height`` viewport."""
    tri_id = g.tri_id
    if g.bary is not None:
        b01 = g.bary
        bary = torch.cat([b01, 1.0 - b01[..., :1] - b01[..., 1:2]], -1)
    else:
        bary, _ = rref.barycentrics_at(coef, tri_id, height, width, y0,
                                       full_height)
    safe_tri = tri_id.clamp_min(0).long()
    trow = scene[tri_table][safe_tri]             # [H,W,8] one gather
    vidx = trow[..., 0:3].long()
    # per-frame packed world attrs: pos3 | normal3 | uv2
    vattr = torch.cat([vo.world_pos, vo.world_normal, vo.uv], -1)
    corners = vattr[vidx]                         # [H,W,3,8]
    b = bary[..., None]
    interp = (corners[..., 0, :] * b[..., 0, :]
              + corners[..., 1, :] * b[..., 1, :]) \
        + corners[..., 2, :] * b[..., 2, :]
    return {
        "pos": interp[..., 0:3],
        "normal": interp[..., 3:6],
        "uv": interp[..., 6:8],
        "mat_id": trow[..., 3],
        "covered": tri_id >= 0,
    }


def shade_sparse(shade_fn, frag, height: int, width: int,
                 tile_h: int = 8, tile_w: int = 128,
                 max_tiles: int | None = None,
                 full_height: int | None = None):
    """Run a resolve+shade function only on tiles with coverage — for
    passes that touch few pixels (translucent peel layers). Covered tiles
    are gathered into a compact pseudo-image (quad derivatives stay
    tile-local), processed, and scattered back.

    Selection is per TILE-ROW: the full-frame tile budget ``max_tiles``
    converts to k = ceil(max_tiles / full-frame tile rows) tiles per tile
    row, picked by per-row top-k coverage count (ties to the lowest tile
    index: a stable descending sort, not ``torch.topk``). Each tile row's
    selection depends only on its own pixel rows, so an image-row split
    on tile rows selects identically. Tiles beyond k in their row go
    unshaded (the caller counts them).

    ``frag``: dict of [H,W(,C)] planes handed to ``shade_fn`` compacted;
    must contain "covered". ``full_height``: full framebuffer height when
    ``height`` is a slice. Returns rgba [H,W,4], zeros where unshaded.
    """
    nty = -(-height // tile_h)
    ntx = -(-width // tile_w)
    nty_full = -(-(full_height or height) // tile_h)
    if max_tiles is None:
        max_tiles = max(1, nty_full * ntx // 4)
    k_row = max(1, min(-(-max_tiles // nty_full), ntx))
    ph, pw = nty * tile_h - height, ntx * tile_w - width

    def tilefy(a):
        """[H,W(,C)] -> [nty, ntx, th, tw(,C)], zero padded."""
        a = torch.nn.functional.pad(
            a, (0, 0) * (a.dim() - 2) + (0, pw, 0, ph))
        a = a.reshape(nty, tile_h, ntx, tile_w, *a.shape[2:])
        return a.movedim(2, 1)

    cov_cnt = tilefy(frag["covered"]).reshape(nty, ntx, -1).sum(-1)
    sel = torch.sort(cov_cnt, dim=-1, descending=True,
                     stable=True).indices[:, :k_row]         # [nty, k_row]
    rows = torch.arange(nty, device=sel.device)[:, None]

    def gather_img(a):
        t = tilefy(a)[rows, sel]                     # [nty,k,th,tw,...]
        return t.reshape(nty * k_row * tile_h, tile_w, *t.shape[4:])

    rgba_sub = shade_fn({k: gather_img(v) for k, v in frag.items()})

    # scatter tiles back
    r = rgba_sub.reshape(nty, k_row, tile_h, tile_w, 4)
    out = torch.zeros((nty, ntx, tile_h, tile_w, 4), dtype=rgba_sub.dtype,
                      device=rgba_sub.device)
    out[rows, sel] = r
    out = out.movedim(2, 1).reshape(nty * tile_h, ntx * tile_w, 4)
    return out[:height, :width]


def shadow_setup(scene, light_viewproj, extent: int):
    """Triangle setup of one shadow map's depth-only pass: every triangle
    of the scene, front-culled to reduce peter-panning
    (``ShadowSystem.cpp:37-53``)."""
    c = corner_clip(scene["corner_attr"][..., 0:3], light_viewproj)
    return triangle_setup_corners(c, scene["n_tris"], extent, extent,
                                  CullMode.FRONT)


def render_shadow_maps(scene, shadow_viewproj, extent: int,
                       n_shadows: int, rc: RasterConfig, backend: str,
                       max_pairs: int | None = None, n_slices: int = 1,
                       cube_bases=()):
    """Depth-only raster per shadow map (reference ``ShadowSystem::Render``).
    shadow_viewproj: [NS,4,4]. Returns ([NS,E,E] f32, overflow): the
    shadow views' tile spans differ from the camera view's, so their
    binning overflow is counted separately ('overflow is counted, not
    silent' holds for every raster pass).

    One launch per map unless the caller asks for ``n_slices`` row slices
    (a 4096^2 map is 65536 kernel tiles, well within one launch on this
    card); slices go through the same ``y0``/``full_height`` path an
    image-row split of the frame uses, and ``max_pairs`` is then the
    per-slice budget.

    ``cube_bases``: the first map of each point light's six cube faces
    (``_cube_shadow_bases``); each face renders inside the span
    ``frame.shadow_cube`` (a region entered six times sums its time)."""
    if extent % n_slices:
        raise ValueError("n_slices must divide the shadow extent")
    slice_h = extent // n_slices
    faces = {b + f for b in cube_bases for f in range(6)}
    maps = []
    overflow = torch.zeros((), dtype=torch.int64,
                           device=shadow_viewproj.device)
    for si in range(n_shadows):
        with (span("frame.shadow_cube") if si in faces
              else contextlib.nullcontext()):
            s = shadow_setup(scene, shadow_viewproj[si], extent)
            budget = max_pairs or _pair_budget(s.coef.shape[0],
                                               rc.pairs_per_tri)
            rows = []
            for y0 in range(0, extent, slice_h):
                ss = s if n_slices == 1 else restrict_rows(s, y0, slice_h,
                                                           extent)
                prep = None
                if backend == "cuda":
                    prep = cuda_raster.prepare_pairs(ss, slice_h, extent,
                                                     max_pairs=budget, y0=y0,
                                                     full_height=extent)
                    overflow = overflow + prep.bins.n_overflow
                g, _ = rasterize(ss, slice_h, extent, backend, prepared=prep,
                                 max_pairs=budget, y0=y0, full_height=extent)
                rows.append(g.depth)
            maps.append(rows[0] if n_slices == 1 else torch.cat(rows, 0))
    return torch.stack(maps), overflow


def _cube_shadow_bases(dev_np: dict, shadow_lights) -> tuple:
    """The first map of each point light's six cube faces (the lights whose
    ``_static_shadow_lights`` flag is 6), decided once on the host."""
    si = np.asarray(dev_np["light_shadow_index"])
    return tuple(int(si[i]) for i, f in enumerate(shadow_lights) if f == 6)


def render_shadow_pass(scene, uniform, config: RenderConfig, n_shadows: int,
                       backend: str = "cuda", max_pairs: int | None = None,
                       return_overflow: bool = False, n_slices: int = 1,
                       cube_bases=()):
    """Standalone shadow depth pass, cached across frames by the caller —
    the reference renders it once until marked dirty
    (``RenderScene.cpp:170-181``). Returns the packed maps
    (``shadow.ShadowPack``)."""
    params = unpack_params(uniform, n_shadows)
    with span("frame.shadow"):
        maps, overflow = render_shadow_maps(
            scene, params["shadow_viewproj"], config.shadow_extent,
            n_shadows, config.raster, backend, max_pairs=max_pairs,
            n_slices=n_slices, cube_bases=cube_bases)
        # pack once per (cached) render: 3x3 PCF becomes one block gather
        packed = shadow_mod.pack_shadow_blocks(maps)
    return (packed, overflow) if return_overflow else packed


def render_frame(scene, uniform, shadow_maps, config: RenderConfig,
                 n_shadows: int, backend: str = "cuda",
                 has_translucent: bool = False,
                 slots_used=(True, True, True, True),
                 shadow_lights=None, has_mask: bool = False,
                 alpha_is_factor: bool = False, ls_atlas=None):
    """The per-frame pass chain (minus the cached shadow depth). scene:
    device dict; uniform: packed per-frame float32 vector
    (``graph.uniforms``); shadow_maps: ``shadow.ShadowPack`` or None.
    Texture-space configs read the baked chart keys of ``scene``;
    ``alpha_is_factor`` (from the bake) lets pre-shaded peels read alpha
    from the material table, and ``ls_atlas`` passes in a specular chart
    pass computed elsewhere.
    Returns ([H,W,4] uint8 sRGB image, stats): ``pair_overflow`` counts
    binned pairs that did not fit the static budget (nonzero means dropped
    triangles), ``pair_tail_overflow`` the span>dense_k pairs past the
    big-list cap, ``blend_pair_overflow`` everything the translucent pass
    dropped (pairs, sparse-grid tiles, unshaded tiles), and, when they
    apply, ``blend_shade_tiles`` [layers] (not for the pre-shaded TSS
    peels of the merged launch on a CUDA device, which one kernel shades
    whole), ``penumbra_tiles`` and ``penumbra_overflow``."""
    check_config(config)
    params = unpack_params(uniform, n_shadows)
    vo = cached_vertex_outputs(scene, params["view"], params["proj"])
    return _frame_core(scene, params, vo, shadow_maps, config, n_shadows,
                       backend, has_translucent, slots_used,
                       shadow_lights=shadow_lights, has_mask=has_mask,
                       alpha_is_factor=alpha_is_factor, ls_atlas=ls_atlas)


def _list_setup(scene, params, config: RenderConfig, corner_key: str, n_key,
                cull):
    """Triangle setup of one draw list: clip corners are a dense
    multiply-add over the STATIC per-corner attr table (scene.upload),
    not a gather."""
    fh, w = config.render_extent()
    vpm = viewproj(params["view"], params["proj"])
    return triangle_setup_corners(
        corner_clip(scene[corner_key][..., 0:3], vpm), scene[n_key], w, fh,
        cull)


def opaque_setup(scene, params, config: RenderConfig, has_mask: bool = False):
    """Triangle setup of the opaque pass. With the cutoff pass on, MASK
    triangles leave the opaque list (they sit between ``n_opaque_strict``
    and ``n_opaque``) and draw in their own peeled pass; otherwise they
    draw opaque (reference parity)."""
    n_key = ("n_opaque_strict" if (config.alpha_mask and has_mask)
             else "n_opaque")
    return _list_setup(scene, params, config, "corner_attr", n_key,
                       config.cull_mode)


def blend_setup(scene, params, config: RenderConfig):
    """Triangle setup of the translucent draw list (culling off,
    ``GraphicsPipelineCache.cpp:307``)."""
    return _list_setup(scene, params, config, "corner_attr_blend", "n_blend",
                       CullMode.NONE)


def _list_pairs(scene, setup, config: RenderConfig, corner_key: str,
                mat_key: str, budget: int, chart_key: str | None = None,
                slice_h: int | None = None, y0: int = 0):
    """A draw list's binned + packed pair table for K1/K2: 8 attribute
    planes (pos3 | normal3 | uv2), or with texture-space shading 4 (chart
    uv | uv, from ``chart_key``), and the material ids per pair. A row
    band [y0, y0+slice_h) of the frame passes its ``restrict_rows`` setup;
    the budget stays the full frame's."""
    fh, w = config.render_extent()
    if config.texture_space:
        ap = lightchart.tss_attribute_planes(setup, scene[chart_key],
                                             scene[corner_key][..., 6:8])
    else:
        ap = cuda_raster.attribute_planes(setup, scene[corner_key])
    return cuda_raster.prepare_pairs(
        setup, fh if slice_h is None else slice_h, w, max_pairs=budget,
        attr_planes=ap, tri_mat=scene[mat_key],
        dense_k=config.raster.dense_k or None, y0=y0, full_height=fh)


def opaque_pairs(scene, setup, config: RenderConfig,
                 slice_h: int | None = None, y0: int = 0):
    budget = (config.raster.pair_budget
              or _pair_budget(setup.coef.shape[0],
                              config.raster.pairs_per_tri))
    return _list_pairs(scene, setup, config, "corner_attr", "tri_material",
                       budget, "chart_corner", slice_h, y0)


def blend_pairs(scene, setup_t, config: RenderConfig,
                slice_h: int | None = None, y0: int = 0):
    """Bin + pack ONCE: every peel rasters the same blend geometry."""
    budget = (config.blend_pair_budget
              or _pair_budget(setup_t.coef.shape[0],
                              config.raster.pairs_per_tri))
    return _list_pairs(scene, setup_t, config, "corner_attr_blend",
                       "blend_tri_material", budget, "chart_corner_blend",
                       slice_h, y0)


def _tss_shade_fns(scene, config: RenderConfig, ls_atlas, slots_used,
                   alpha_is_factor: bool, y0: int = 0):
    """The texture-space screen passes of one frame, from this frame's
    specular chart pass ``ls_atlas`` [3,Ah,Aw]: (opaque dense pass, peel
    pass per pixel, peel pass dense, pre-shaded peel composite). The first
    three take (chart_uv [...,2], uv [...,2] or None, mat_id, need_alpha,
    covered) and return rgba; the last (None unless the peels are
    pre-shaded) takes (rgb [H,W,3], [(tri_id, chart_uv, mat_id)] of the
    two peel layers, nearest first) and composites them into rgb in place
    (``lightchart.tss_peel_composite``: every covered pixel, no budget).

    Factored TSS samples the merged light table (static diffuse planes +
    this frame's specular planes) beside one albedo tap; pre-shaded charts
    compose albedo * diffuse + specular in chart space and the screen pass
    is one rgb9e5 block gather (+ an alpha block, or the material factor
    alpha when ``alpha_is_factor``). Dense passes at chart density <= 0.5
    (or ``tss_halfres_light=1``) sample on the half-res pixel grid; the
    factored one is one kernel launch on a CUDA device
    (``lightchart.tss_shade_halfres``).
    ``tss_preshaded_blend`` pre-shades only the peels."""
    c_ah, c_aw = ls_atlas.shape[1:]
    pre_any = config.tss_preshaded or config.tss_preshaded_blend
    half = (config.chart_density <= 0.5 if config.tss_halfres_light < 0
            else bool(config.tss_halfres_light))

    if pre_any:
        rgb_blocks = lightchart.pack_rgbe_blocks(scene["chart_base"]
                                                 + ls_atlas)
        a_blocks = scene["chart_a"]

        def factor_alpha(out, mat_id, need_alpha):
            if not (need_alpha and alpha_is_factor):
                return out
            return lightchart.factor_alpha(out, scene["mat_all"], mat_id)

        def pre_px(chart_uv, uv, mat_id, need_alpha=True, covered=None):
            out = lightchart.tss_shade_pre(
                rgb_blocks, a_blocks, chart_uv, c_ah, c_aw,
                need_alpha=need_alpha and not alpha_is_factor)
            return factor_alpha(out, mat_id, need_alpha)

        def pre_dense(chart_uv, uv, mat_id, need_alpha=True, covered=None):
            if not half:
                return pre_px(chart_uv, uv, mat_id, need_alpha)
            out = lightchart.tss_shade_pre_halfres(
                rgb_blocks, a_blocks, chart_uv, c_ah, c_aw, y0=y0,
                need_alpha=need_alpha and not alpha_is_factor)
            return factor_alpha(out, mat_id, need_alpha)

        def peels(rgb, layers):
            layers = [tuple(t.contiguous() for t in lay) for lay in layers]
            return lightchart.tss_peel_composite(
                rgb.contiguous(), rgb_blocks, a_blocks, layers, c_ah, c_aw,
                mat_all=scene["mat_all"] if alpha_is_factor else None)

    if config.tss_preshaded:
        dense = pre_dense
    else:
        light8 = lightchart.merge_light_planes(
            scene["chart_ld"], lightchart.pack_rgbe_planes(ls_atlas))
        kw = dict(slots_used=slots_used, max_aniso=config.aniso(),
                  dither=config.dither_trilinear)

        def px(chart_uv, uv, mat_id, need_alpha=True, covered=None):
            return lightchart.tss_shade(scene, chart_uv, uv, mat_id, light8,
                                        c_ah, c_aw, covered=covered, **kw)

        def dense(chart_uv, uv, mat_id, need_alpha=True, covered=None):
            if half:
                return lightchart.tss_shade_halfres(
                    scene, chart_uv, uv, mat_id, light8, c_ah, c_aw, y0=y0,
                    covered=covered, **kw)
            return px(chart_uv, uv, mat_id, covered=covered)

    if pre_any:
        return dense, pre_px, pre_dense, peels
    return dense, px, dense, None


def resolve_ssaa(rgb: torch.Tensor, f: int) -> torch.Tensor:
    """[f*h, f*w, 3] linear colour -> [h, w, 3]: the mean of each ``f x
    f`` block in float32, the box resolve before the sRGB encode."""
    h, w = rgb.shape[0] // f, rgb.shape[1] // f
    return rgb.reshape(h, f, w, f, 3).mean(dim=(1, 3))


def _frame_core(scene, params, vo, shadow_maps, config: RenderConfig,
                n_shadows: int, backend: str, has_translucent: bool,
                slots_used, shadow_lights=None, has_mask: bool = False,
                alpha_is_factor: bool = False, ls_atlas=None,
                y0: int = 0, slice_h: int | None = None):
    """The frame body, shared by the whole frame (``y0=0``, ``slice_h``
    None: the render height) and a row band [y0, y0+slice_h) of it
    (``parallel.sharded``: one band a rank). Returns (img [slice_h/ssaa,
    W,4] u8, stats). Every budget stays in full-frame units (pairs, shade
    tiles per full-frame tile row, penumbra tiles by the full height), so
    a band selects what the whole frame selects on its rows; the shadow
    quad, anchored to a screen corner, is drawn on the whole frame only."""
    fh, w = config.render_extent()
    slice_h = fh if slice_h is None else slice_h
    is_full = slice_h == fh
    if config.ssaa > 1 and slice_h % config.ssaa:
        raise ValueError("the slice height must divide by the SSAA factor")

    def rows(s):
        return s if is_full else restrict_rows(s, y0, slice_h, fh)

    dev = vo.world_pos.device
    cuda = backend == "cuda"
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    overflow, tail_overflow, blend_overflow = zero, zero, zero
    shade_tile_counts = []   # observed covered shade tiles per peel layer
    shadow_stats = []        # (penumbra tiles, overflow) per shadow lookup
    shadow_tf = None
    if config.shadows and n_shadows > 0:
        shadow_tf = params["shadow_viewproj"]
    view_args = {
        "view_pos": params["view_pos"],
        "exposure": params["exposure"],
        "debug_input": params["debug_input"],
        "debug_equation": params["debug_equation"],
    }
    shade_fn = (pbr.brdf_lighting if config.shading == ShadingModel.PBR
                else phong.phong_lighting)

    def shade(frag, covered):
        return shade_fn(scene, frag["pos"], frag["uv"], frag["normal"],
                        frag["mat_id"], view_args, shadow_maps, shadow_tf,
                        slots_used=slots_used, shadow_lights=shadow_lights,
                        max_aniso=config.aniso(),
                        dither=config.dither_trilinear,
                        debug_views=config.debug_views,
                        penumbra_tiles=config.penumbra_tile_budget,
                        penumbra_full_h=fh, shadow_stats=shadow_stats,
                        ibl_diffuse=config.ibl_diffuse, covered=covered)

    def kernel_frag(g, attrs):
        return {"pos": attrs[..., 0:3], "normal": attrs[..., 3:6],
                "uv": attrs[..., 6:8], "mat_id": g.mat_id}

    mask_pass = config.alpha_mask and has_mask
    blend_pass = config.translucency and has_translucent

    # spans name the passes (utils/profiling.py): ranges for
    # torch.profiler while a session runs, and inside a renderer's
    # programs the device clock stamps of the passes of STAMPED
    tss = config.texture_space
    tss_peels = None
    if tss:
        # the per-frame SPECULAR chart pass (dense over chart texels, zero
        # gathers); the diffuse table is static (baked on upload /
        # shadow-dirty / exposure change)
        with span("frame.tss_spec"):
            if ls_atlas is None:
                ls_atlas = lightchart.chart_light_spec(
                    scene, scene["chart_pos"], scene["chart_normal"],
                    scene["chart_mat"], scene["chart_vis"], view_args)
            tss_dense, tss_blend_px, tss_blend_dense, tss_peels = \
                _tss_shade_fns(scene, config, ls_atlas, slots_used,
                               alpha_is_factor, y0)
    # merged launch (K2): on the TSS cuda path the opaque base pass and the
    # first TWO translucent peel layers share one tile walk
    merged_ok = (cuda and tss and blend_pass
                 and config.translucency_layers >= 2 and not mask_pass
                 and not _FORCE_UNMERGED)
    merged_layers = None
    with span("frame.setup"):
        setup = opaque_setup(scene, params, config, has_mask)
        # (the blend draw list's setup/binning sits before the opaque
        # raster, where a merged opaque+peel launch would consume it)
        setup_t = blend_setup(scene, params, config) if blend_pass else None
        # the band's rows: bboxes rebased, triangles outside dropped (the
        # planes stay the full frame's)
        setup_s = rows(setup)
        setup_ts = rows(setup_t) if blend_pass else None
    prep = prep_t = None
    if cuda:
        with span("frame.bin_pack"):
            prep = opaque_pairs(scene, setup_s, config, slice_h, y0)
            overflow = overflow + prep.bins.n_overflow
            tail_overflow = tail_overflow + prep.bins.n_tail
            if blend_pass:
                prep_t = blend_pairs(scene, setup_ts, config, slice_h, y0)
                blend_overflow = blend_overflow + prep_t.bins.n_overflow
                tail_overflow = tail_overflow + prep_t.bins.n_tail
    if merged_ok:
        # pre-shaded peels consume chart uv only: the blend stream
        # interpolates just that prefix
        nab = 2 if (config.tss_preshaded or config.tss_preshaded_blend) \
            else None
        with span("frame.merged_raster"):
            (g, attrs), merged_layers = cuda_raster.rasterize_cuda_merged(
                slice_h, w, prep, prep_t, y0=y0, full_height=fh,
                n_attrs_b=nab)
    else:
        with span("frame.raster"):
            g, attrs = rasterize(setup_s, slice_h, w, backend, y0=y0,
                                 full_height=fh, prepared=prep)
    covered = g.tri_id >= 0
    if tss:
        if attrs is not None:
            frag = {"chart_uv": attrs[..., 0:2], "uv": attrs[..., 2:4],
                    "mat_id": g.mat_id}
        else:
            frag = lightchart.resolve_tss(scene, setup.coef, g, slice_h, w,
                                          y0=y0, full_height=fh)
        with span("frame.shade"):
            rgba = tss_dense(frag["chart_uv"], frag["uv"], frag["mat_id"],
                             need_alpha=False, covered=covered)
    else:
        frag = (kernel_frag(g, attrs) if attrs is not None else
                resolve_attributes(scene, vo, setup.coef, g, slice_h, w,
                                   y0=y0, full_height=fh))
        with span("frame.shade"):
            rgba = shade(frag, covered)
    depth_eff = g.depth

    # alpha-MASK cutoff pass (beyond the reference's live path, which draws
    # MASK opaque): glTF semantics say discard fragments with sampled alpha
    # < material.alphaCutoff. Discarding under a z-buffer means the surface
    # BEHIND shows through, so the (small) MASK draw list is depth-peeled
    # front-to-back and the nearest PASSING fragment per pixel kept;
    # stacked discarded layers beyond config.mask_layers fall back to the
    # opaque surface. Shadows still treat MASK as opaque casters (parity).
    if mask_pass:
        with span("frame.mask"):
            setup_m = _list_setup(scene, params, config, "corner_attr_mask",
                                  "n_mask", config.cull_mode)
            setup_ms = rows(setup_m)
            mask_budget = _pair_budget(setup_m.coef.shape[0],
                                       config.raster.pairs_per_tri)
            prep_m = None
            if cuda:
                prep_m = _list_pairs(scene, setup_ms, config,
                                     "corner_attr_mask", "mask_tri_material",
                                     mask_budget, slice_h=slice_h, y0=y0)
                overflow = overflow + prep_m.bins.n_overflow
                tail_overflow = tail_overflow + prep_m.bins.n_tail
            prev_m = torch.full((slice_h, w), -1.0, dtype=torch.float32,
                                device=dev)
            resolved = torch.zeros((slice_h, w), dtype=torch.bool,
                                   device=dev)
            for _ in range(config.mask_layers):
                gm, attrs_m = rasterize(setup_ms, slice_h, w, backend,
                                        y0=y0, full_height=fh,
                                        peel_bounds=(prev_m, depth_eff),
                                        prepared=prep_m,
                                        max_pairs=mask_budget)
                covered_m = gm.tri_id >= 0
                frag_m = (kernel_frag(gm, attrs_m) if attrs_m is not None
                          else resolve_attributes(
                              scene, vo, setup_m.coef, gm, slice_h, w,
                              y0=y0, full_height=fh,
                              tri_table="mask_tri_packed"))
                rgba_m = shade(frag_m, covered_m)
                cutoff = scene["mat_core"][frag_m["mat_id"].long(), 13]
                accept = covered_m & (rgba_m[..., 3] >= cutoff) & ~resolved
                rgba = torch.where(accept[..., None], rgba_m, rgba)
                depth_eff = torch.where(accept, gm.depth, depth_eff)
                resolved = resolved | accept
                prev_m = torch.where(covered_m, gm.depth, 2.0)
            covered = covered | resolved

    # skybox where nothing was drawn (reference draws it last at far depth).
    # Reference quirk kept: the cubemap is a Unorm format sampled raw
    # (skybox.frag:30), so its stored (sRGB-encoded) values pass through as
    # if linear and get re-encoded by the swapchain.
    if config.skybox:
        with span("frame.sky"):
            sky_fn = (skybox.render_skybox_halfres if config.sky_halfres
                      else skybox.render_skybox)
            sky = sky_fn(scene["cubemap"], params["inv_vp_rot"], slice_h, w,
                         y0=y0, full_height=fh)
            rgb = torch.where(covered[..., None], rgba[..., :3],
                              sky[..., :3])
    else:
        rgb = torch.where(covered[..., None], rgba[..., :3], 0.0)

    # translucent pass: depth-peeled K nearest layers, composited
    # back-to-front with src-alpha blending — the order-correct version of
    # the reference's per-mesh back-to-front sorted draws with culling off
    # (RenderScene.cpp:127-159, GraphicsPipelineCache.cpp:307).
    if blend_pass:
        # budgets are stated in FULL-FRAME tiles: shade_sparse converts
        # them to a per-tile-row k by the full height, so a band selects
        # and drops what the whole frame does on its rows
        th, tw = config.raster.tile_h, config.raster.tile_w
        ntx_b = -(-w // tw)
        nty_b = -(-slice_h // th)            # the band's tile rows
        nty_full = -(-fh // th)
        n_tiles = nty_full * ntx_b
        shared_budget = max(1, int(n_tiles
                                   * config.translucency_tile_fraction))
        layer_budgets = config.blend_layer_tile_budgets

        def resolve_and_shade(fr, dense=False):
            # resolve + shade, on the compacted pseudo-image when sparse;
            # ``dense``: fr holds full [H, W] planes (a full-coverage peel
            # layer), so the half-res TSS passes apply
            if tss:
                tss_sh = tss_blend_dense if dense else tss_blend_px
                if "attrs" in fr:
                    # pre-shaded merged peels carry chart uv only
                    a = fr["attrs"]
                    uv = a[..., 2:4] if a.shape[-1] > 2 else None
                    return tss_sh(a[..., 0:2], uv, fr["mat_id"],
                                  covered=fr["covered"])
                gsub = rref.GBuffer(depth=None, tri_id=fr["tri_id"],
                                    bary=fr["bary"])
                fsub = lightchart.resolve_tss(
                    scene, setup_t.coef, gsub, *fr["tri_id"].shape,
                    tri_table="blend_tri_packed",
                    corner_table="chart_corner_blend")
                return tss_sh(fsub["chart_uv"], fsub["uv"], fsub["mat_id"],
                              covered=fr["covered"])
            if "attrs" in fr:
                fsub = {"pos": fr["attrs"][..., 0:3],
                        "normal": fr["attrs"][..., 3:6],
                        "uv": fr["attrs"][..., 6:8], "mat_id": fr["mat_id"]}
            else:
                gsub = rref.GBuffer(depth=None, tri_id=fr["tri_id"],
                                    bary=fr["bary"])
                fsub = resolve_attributes(scene, vo, setup_t.coef, gsub,
                                          *fr["tri_id"].shape,
                                          tri_table="blend_tri_packed")
            return shade(fsub, fr["covered"])

        active = (config.blend_tile_budget or None) if cuda else None
        if active:
            # sparse peel grid correctness guard: covered tiles beyond the
            # static budget would render empty
            blend_overflow = blend_overflow + (
                (prep_t.bins.counts > 0).sum() - active).clamp_min(0)
        # cuda: successive peel layers raster PAIRWISE in one launch (the
        # dual two-nearest kernel): each launch pays the full per-tile
        # walk, so halving launches halves that cost. The first two layers
        # may have come from the merged launch already.
        prev = torch.full((slice_h, w), -1.0, dtype=torch.float32,
                          device=dev)
        raster_layers = []
        li = 0
        if merged_layers is not None:
            raster_layers.extend(merged_layers)
            g_last = merged_layers[1][0]
            prev = torch.where(g_last.tri_id >= 0, g_last.depth, 2.0)
            li = 2
        with span("frame.peel_raster"):
            while li < config.translucency_layers:
                dual = cuda and li + 1 < config.translucency_layers
                out = rasterize(setup_ts, slice_h, w, backend, y0=y0,
                                full_height=fh,
                                peel_bounds=(prev, depth_eff),
                                prepared=prep_t, active_tiles=active,
                                peel_layers=2 if dual else 1)
                new = out if dual else [out]
                raster_layers.extend(new)
                li += len(new)
                g_last = new[-1][0]
                prev = torch.where(g_last.tri_id >= 0, g_last.depth, 2.0)
        # the pre-shaded TSS peels of the merged launch on the card: one
        # kernel shades every covered pixel of both layers and composites
        # them (no shade-tile budget, so none observed and none dropped)
        kernel_peels = (merged_layers is not None and tss_peels is not None
                        and config.translucency_layers == 2
                        and dev.type == "cuda")
        with span("frame.peel_shade"):
            if kernel_peels:
                rgb = tss_peels(rgb, [(gt.tri_id, attrs_t, gt.mat_id)
                                      for gt, attrs_t in raster_layers])
            else:
                layers = []
                for li, (gt, attrs_t) in enumerate(raster_layers):
                    budget = (layer_budgets[li] if li < len(layer_budgets)
                              else shared_budget)
                    budget = max(1, min(int(budget), n_tiles))
                    covered_t = gt.tri_id >= 0
                    sp_in = {"covered": covered_t, "tri_id": gt.tri_id}
                    if attrs_t is not None:
                        sp_in["attrs"] = attrs_t
                        sp_in["mat_id"] = gt.mat_id
                    elif gt.bary is not None:
                        sp_in["bary"] = gt.bary
                    else:  # reference backend: recompute bary densely
                        bary_t, _ = rref.barycentrics_at(
                            setup_t.coef, gt.tri_id, slice_h, w, y0, fh)
                        sp_in["bary"] = bary_t[..., :2]
                    if budget >= n_tiles:
                        # full-coverage layer (e.g. a screen-filling
                        # banner): the sparse tilefy/top-k/gather/scatter
                        # is pure overhead
                        rgba_t = resolve_and_shade(sp_in, dense=True)
                    else:
                        rgba_t = shade_sparse(resolve_and_shade, sp_in,
                                              slice_h, w, th, tw,
                                              max_tiles=budget,
                                              full_height=fh)
                    # observed need per layer in BUDGET-equivalent units
                    # (budget >= need <=> the per-row k covers the busiest
                    # tile row, mirroring shade_sparse's conversion);
                    # beyond-k tiles went unshaded => fold into the
                    # overflow counter
                    ct = torch.nn.functional.pad(
                        covered_t,
                        (0, ntx_b * tw - w, 0, nty_b * th - slice_h))
                    ct = ct.reshape(nty_b, th, ntx_b, tw)
                    row_need = ct.any(3).any(1).sum(-1)              # [nty]
                    shade_tile_counts.append(row_need.max() * nty_full)
                    if budget < n_tiles:
                        k_row = max(1, min(-(-budget // nty_full), ntx_b))
                        blend_overflow = blend_overflow + (
                            row_need - k_row).clamp_min(0).sum()
                    layers.append((covered_t, rgba_t))
                for covered_t, rgba_t in reversed(layers):
                    a = rgba_t[..., 3].clamp(0.0, 1.0) * covered_t
                    rgb = rgb * (1.0 - a[..., None]) \
                        + rgba_t[..., :3] * a[..., None]

    # editor ground grid (drawable form of the reference's never-drawn
    # Grid, SURVEY 2.3; blended + depth-tested against the opaque z-buffer)
    if config.grid:
        with span("frame.overlay"):
            rgb = grid_mod.render_grid(params["inv_vp"], params["view"],
                                       params["proj"], depth_eff, rgb,
                                       y0=y0, full_height=fh)

    # shadow-map preview overlay (TexturedQuad grayscale mode): the packed
    # 4x4 stride-2 windows hold even texel (2a-2, 2b-2) in the low 16 bits
    # of word 0 (int32 bit views here); a half-res preview is plenty.
    # Anchored to a screen corner, so the whole frame only: a band skips
    # it, as the JAX package's does
    if config.show_shadow_quad and shadow_maps is not None and is_full:
        with span("frame.overlay"):
            draw_src = (shadow_maps.blocks[0, 1:, 1:, 0] & 0xFFFF).to(
                torch.float32) / 65535.0
            rgb = draw_textured_quad(rgb, draw_src, grayscale=True)

    with span("frame.encode"):
        if config.ssaa > 1:
            rgb = resolve_ssaa(rgb, config.ssaa)
        img = encode_srgb8(rgb)
    stats = {"pair_overflow": overflow,
             "pair_tail_overflow": tail_overflow,
             "blend_pair_overflow": blend_overflow}
    if shade_tile_counts:
        stats["blend_shade_tiles"] = torch.stack(shade_tile_counts)
    if shadow_stats:
        stats["penumbra_tiles"] = torch.stack(
            [s[0] for s in shadow_stats]).max()
        stats["penumbra_overflow"] = torch.stack(
            [s[1] for s in shadow_stats]).sum()
    return img, stats


def bake_tss_visibility(scene, shadow_maps, u, n_shadows: int,
                        shadow_lights) -> None:
    """The per-texel PCF visibility bake of a shadow-dirty frame (the JAX
    ``FrameRenderer._vis_fn``) from the packed maps and the uniform ``u``'s
    shadow transforms, written into ``scene["chart_vis"]``."""
    params = unpack_params(u, n_shadows)
    geo = {"pos": scene["chart_pos"], "normal": scene["chart_normal"],
           "mat_id": scene["chart_mat"][15]}
    scene["chart_vis"].copy_(lightchart.bake_visibility(
        scene, geo, shadow_maps, params["shadow_viewproj"], shadow_lights))


def bake_tss_tables(scene, config: RenderConfig, u) -> None:
    """The static light tables (the JAX ``_ld_fn``) at the exposure in the
    uniform ``u``, written into ``chart_ld`` / ``chart_base``. The exposure
    is read on the device, so one captured program serves every exposure,
    as JAX's traced argument does; the tables equal those of the Python
    float (``f32(e) * ld``)."""
    for k, v in lightchart.static_tables(
            scene, config, unpack_params(u, 0)["exposure"]).items():
        scene[k].copy_(v)


def tss_bakes(scene, u, shadow_maps, n_shadows: int, shadow_lights,
              config: RenderConfig, visibility: bool) -> list:
    """(program name, key, function) of the texture-space bakes of a
    shadow-dirty frame (``visibility``) or an exposure frame, over a
    renderer's device state: each writes into the tables of ``scene`` that
    the frame reads, and its key is what it binds."""
    out = []
    if visibility:
        out.append(("vis", (config.shadow_extent, shadow_lights),
                    lambda: bake_tss_visibility(scene, shadow_maps, u,
                                                n_shadows, shadow_lights)))
    out.append(("tables", (config.tss_preshaded, config.tss_preshaded_blend),
                lambda: bake_tss_tables(scene, config, u)))
    return out


def bake_tss(bakes, programs=None) -> None:
    """Run the bakes of ``tss_bakes``: as replays of ``programs`` (captured
    here if their key changed), or op by op without them."""
    with span("frame.tss_bake"):
        for name, key, fn in bakes:
            if programs is None:
                fn()
            else:
                programs.get(name, key, fn)
                programs.replay(name)


class FrameRenderer:
    """Uploads the scene once and marshals host state into device args.

    The analog of Renderer+RenderScene's per-frame path
    (``Renderer.cpp:98-111``): per-frame host->device traffic is ONE
    packed uniform vector; the shadow depth pass is cached until
    ``mark_shadows_dirty()`` (reference dirty-flag semantics). ``device``
    defaults to ``cuda`` (and raises without it); ``backend`` defaults to
    ``"cuda"``, the tile kernel (its plain PyTorch version on a CPU
    device).

    With ``auto_tune_pairs`` on the ``cuda`` backend the budgets react to
    the frames: each frame's counters are queued for ``_poll_overflow``,
    which the next ``render()`` runs without waiting on the device."""

    # growth ceiling of the pair budgets (a packed table is P x 176 B)
    _MAX_PAIRS = 2_000_000
    # ... and of one shadow map's: its depth-only rows are P x 80 B, and a
    # 4096^2 map is one launch here where the JAX package caps each of its
    # 8 row slices at _MAX_PAIRS
    _MAX_SHADOW_PAIRS = 16_000_000

    # whether the budgets react to the frames (with ``auto_tune_pairs`` on
    # the ``cuda`` backend): the estimators at init, ``_poll_overflow``
    # after. The mesh renderer (``parallel.sharded``) has no controller
    _has_controller = True

    def __init__(self, scene_host, config: RenderConfig, device=None,
                 backend: str | None = None):
        self._setup(scene_host, config, device, backend or "cuda")
        self._start()

    def _setup(self, scene_host, config: RenderConfig, device,
               backend: str) -> None:
        """Upload the scene and size the budgets: the renderer's state up
        to the uniform and the programs (``_start``)."""
        check_config(config)
        # the captured programs (made by ``_start``, once the budgets are
        # known)
        self._graphs = False
        self.device = resolve_device(device)
        self._programs = Programs(self.device,
                                  ("frame", "shadow", "vis", "tables"))
        # the device clock stamps of the programs' passes (they outlive the
        # graphs that write them), the records of frames rendered under
        # torch.profiler, and the host's waits on the device (calls that
        # block on device work other than a presented frame's copy)
        self._stamps = profiling.Stamps(self.device)
        self.frame_records = profiling.new_frame_trace()
        self.host_syncs = 0
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
        self.backend = backend
        self.scene_host = scene_host
        self.config = config
        self.n_shadows = scene_host.n_shadow_maps if config.shadows else 0
        dev_np = self._upload()
        self.scene_dev = scene_to_device(dev_np, self.device)
        self._slots_used = tuple(bool((dev_np[k] >= 0).any()) for k in
                                 ("mat_tex_base", "mat_tex_emissive",
                                  "mat_tex_orm", "mat_tex_normal"))
        self._has_translucent = int(dev_np["n_blend"]) > 0
        self._has_mask = int(dev_np.get("n_mask", 0)) > 0
        self._shadow_lights = _static_shadow_lights(dev_np)
        self._cube_bases = _cube_shadow_bases(dev_np, self._shadow_lights)
        # the budgets below are sized at init from the initial camera; every
        # one has an overflow counter in the stats
        tune = (self._has_controller and backend == "cuda"
                and config.raster.auto_tune_pairs)
        self._react_overflow = tune
        if tune:
            ppt, abs_budget, dense_k = self._estimate_pair_budget()
            self.config = config = config.replace(raster=dataclasses.replace(
                config.raster, pairs_per_tri=ppt, pair_budget=abs_budget,
                dense_k=dense_k))
        if tune and self._has_translucent and config.translucency:
            frac, blend_budget, tile_budget = self._estimate_blend_budgets()
            self.config = config = config.replace(
                translucency_tile_fraction=min(
                    config.translucency_tile_fraction, frac),
                blend_pair_budget=blend_budget,
                blend_tile_budget=tile_budget)
        # the controller (``_poll_overflow``): queued counters of frames in
        # flight, observed per-peel-layer and penumbra coverage
        self._pending_overflow = []
        self._blend_obs = []
        self._polls_since_blend_retune = 0
        # consecutive low observations before a shrink. Must exceed the
        # period of typical camera motion (an orbit revisits its densest
        # view every few dozen frames): a shrink based on a shorter window
        # re-overflows at the next peak and the controller oscillates
        self.blend_shrink_after = 64
        self.blend_tile_floor = 16     # smallest per-layer shade budget
        self._pen_obs = []
        self._polls_since_pen_retune = 0
        self._pen_tuned = False
        # shrink floors: budgets an overflow proved insufficient (ratchet)
        self._blend_floor = ()
        self._pen_floor = 0
        # two-stage PCF pays once the window table dwarfs the coarse one:
        # start at 35% of the shade tiles and let observation tighten it
        if (tune and self.n_shadows > 0 and config.shadow_extent >= 1024
                and config.penumbra_tile_budget == 0):
            self.config = config = config.replace(
                penumbra_tile_budget=max(
                    256, self._shade_tile_total() * 35 // 100))
        # the shadow pass keeps its own pair budget: its tile spans differ
        # wildly from the camera view's (an ortho fit of the whole scene)
        if tune and self.n_shadows > 0:
            self._shadow_budget_val = self._estimate_shadow_budget()
        else:
            self._shadow_budget_val = _pair_budget(
                int(dev_np["tri_vidx"].shape[0]), config.raster.pairs_per_tri)
        self._shadow_maps = None
        self._shadows_dirty = True
        self._shadow_vp_cache = None
        self.shadow_overflow = 0    # dropped pairs of the last shadow pass
        self._alpha_is_factor = False
        if config.texture_space:
            # device bakes (once per upload): per-texel geometry, the full
            # material remap, the pre-shaded albedo, the static light
            # tables. alpha_is_factor is decided on the host from the
            # texture alpha channels.
            self._baked_exposure = float(scene_host.camera.exposure)
            with span("frame.tss_bake"):
                up, self._alpha_is_factor = lightchart.setup_scene_tss(
                    self.scene_dev, config, self._slots_used,
                    self._baked_exposure, lightchart.host_alpha_is_factor(
                        dev_np, getattr(scene_host, "textures", None)))
            self.scene_dev.update(up)

    def _upload(self, **kw) -> dict:
        """The host scene's upload dict (numpy arrays; ``kw``:
        ``upload``'s). With texture-space shading, huge-footprint triangles
        are subdivided at upload so every chart fits MAX_R texels at the
        requested density, and the charts are laid out from the INITIAL
        camera footprint (host, once)."""
        config, scene_host = self.config, self.scene_host
        if not config.texture_space:
            return scene_host.upload(**kw)
        vp0 = ViewProperties.from_camera(scene_host.camera)
        viewproj0 = np.asarray(vp0.proj) @ np.asarray(vp0.view)
        dev_np = scene_host.upload(chart_subdiv=dict(
            viewproj=viewproj0, width=config.width, height=config.height,
            density=config.chart_density), **kw)
        lightchart.attach_chart_layout(dev_np, viewproj0, config)
        return dev_np

    def _captures(self) -> bool:
        """Whether the programs are captured (a CUDA device) or
        dispatched op by op."""
        return self.device.type == "cuda"

    def _start(self) -> None:
        """The uniform of the initial camera and, where the programs are
        captured, every program."""
        config = self.config
        # the frame's one host->device input: the packed uniform, uploaded
        # into this tensor each frame (the programs read it in place)
        u0 = self.uniform_for_camera()
        self._u = torch.zeros(u0.shape, dtype=torch.float32,
                              device=self.device)
        uniforms.upload(self._u, u0)
        if self._captures():
            # the counterpart of the JAX package's _start_prewarm: every
            # program is captured here, so the first render() replays (on
            # every rank in the same order, for the mesh renderer)
            if self.n_shadows > 0:
                maps, _ = self._shadow_program().outputs
                # the pack the frame program reads; each shadow replay
                # copies its maps in (zeros until the first one)
                self._shadow_maps = shadow_mod.ShadowPack(
                    *(torch.zeros_like(t) for t in maps))
            if config.texture_space:
                # their warm-ups bake from the zero pack; the first
                # render() is shadow-dirty and bakes again before its frame.
                # Captured with the stamps bound, as a recapture inside
                # render() is (the cube lookup's ``frame.vis_cube``)
                with profiling.stamping(self._stamps):
                    for name, key, fn in self.tss_bakes(self.n_shadows > 0):
                        self._programs.get(name, key, fn)
            self._graphs = True
            self._programs.get("frame", self.config, self._frame_fn())

    @property
    def config(self) -> RenderConfig:
        return self._config

    @config.setter
    def config(self, cfg: RenderConfig) -> None:
        # a new config recaptures the frame program, as the JAX package
        # re-jits its frame function (the controller's re-tunes, a caller's
        # assignment)
        self._config = cfg
        if self._graphs:
            self._programs.get("frame", cfg, self._frame_fn())

    @property
    def program_counts(self) -> dict:
        """Captures and replays of each captured program (CUDA devices)."""
        return self._programs.counts

    def _frame_fn(self):
        """``render_frame`` with the renderer's static state bound: the
        function the frame program captures."""
        cfg = self.config
        stamps = self._stamps

        def frame():
            # stamped from its first operation to its last, which hands
            # the passes' device ns out as the counter ``pass_ns``
            with profiling.stamping(stamps):
                stamps.enter("frame")
                img, stats = render_frame(
                    self.scene_dev, self._u, self._shadow_maps, cfg,
                    self.n_shadows, self.backend, self._has_translucent,
                    self._slots_used, shadow_lights=self._shadow_lights,
                    has_mask=self._has_mask,
                    alpha_is_factor=self._alpha_is_factor)
                stats["pass_ns"] = stamps.finish()
            return img, stats
        return frame

    def _shadow_program(self):
        """The shadow pass captured at the current shadow budget and
        extent (the JAX package's ``_rebuild_shadow_fn``), recaptured when
        either changes."""
        cfg, budget = self.config, self._shadow_budget_val
        return self._programs.get(
            "shadow", (budget, cfg.shadow_extent),
            lambda: self._shadow_pass(cfg, budget))

    def _shadow_pass(self, cfg: RenderConfig, budget: int):
        """The shadow pass over this renderer's state, its stamps bound:
        (maps, overflow)."""
        with profiling.stamping(self._stamps):
            return render_shadow_pass(
                self.scene_dev, self._u, cfg, self.n_shadows, self.backend,
                max_pairs=budget, return_overflow=True,
                cube_bases=self._cube_bases)

    def tss_bakes(self, visibility: bool) -> list:
        """The texture-space bakes over this renderer's state (module
        ``tss_bakes``): the functions its programs capture, and run op by
        op, the eager bakes."""
        return tss_bakes(self.scene_dev, self._u, self._shadow_maps,
                         self.n_shadows, self._shadow_lights, self.config,
                         visibility)

    def program_stats(self) -> dict:
        """The captured programs' measurements (``CapturedProgram.stats``),
        their captures and replays, and the mode: ``captured`` (CUDA
        devices) or ``eager``."""
        return {"mode": "captured" if self._graphs else "eager",
                **self._programs.stats()}

    def _shade_tile_total(self) -> int:
        h, w = self.config.render_extent()
        return ((-(-h // self.config.raster.tile_h))
                * (-(-w // self.config.raster.tile_w)))

    def _init_camera(self):
        vp = ViewProperties.from_camera(self.scene_host.camera)
        view = torch.from_numpy(np.asarray(vp.view, np.float32)).to(self.device)
        proj = torch.from_numpy(np.asarray(vp.proj, np.float32)).to(self.device)
        return view, proj

    def _estimate_pair_budget(self) -> tuple[int, int, int]:
        """Size the pair-table budget from the initial camera: the
        post-cull live pair estimate with 1.35x headroom, and ``dense_k``
        from the span distribution (the JAX package's estimator)."""
        cfg = self.config
        h, w = cfg.render_extent()
        eth, etw = _effective_tiles(cfg.raster, self.backend)
        sc = self.scene_dev
        vo = cached_vertex_outputs(sc, *self._init_camera())
        s = triangle_setup(vo.clip, sc["tri_vidx"], sc["n_opaque"], w, h,
                           cfg.cull_mode)
        total = int(binning.live_pairs_estimate(s, h, w, eth, etw,
                                                cfg.raster.pairs_per_tri))
        t = int(sc["tri_vidx"].shape[0])
        ppt = min(64, max(2, -(-2 * total // max(t, 1))))
        abs_budget = min(self._MAX_PAIRS, int(1.35 * total) + 8192)
        # smallest k whose span>k triangle count fits the dense binning's
        # big-list cap with 4x orbit margin = the (CAP/4)-th largest span
        span = binning._tile_spans(s, eth, etw)[4]
        q = binning._BIG_TRI_CAP // 4
        dk = int(torch.sort(span).values[max(0, t - q)])
        # a span-heavy view (k would exceed 16) keeps the fill path
        dense_k = max(4, dk) if dk <= 16 else 0
        return ppt, abs_budget, dense_k

    def _estimate_shadow_budget(self) -> int:
        """Measure the (tile, triangle) spans each shadow view produces at
        the shadow extent (setup + span sum, no sort) and keep 1.3x
        headroom — the light fit tracks the scene, not the camera, so the
        count is stable across frames. The budget is one map's: the worst
        span count over all maps."""
        e = self.config.shadow_extent
        eth, etw = _effective_tiles(self.config.raster, self.backend)
        sc = self.scene_dev
        svp = fitting.shadow_transforms_for_scene(self.scene_host)
        worst = 0
        for m in np.asarray(svp, np.float32):
            clip = clip_coords(sc["world_pos"],
                               torch.from_numpy(m).to(self.device))
            s = triangle_setup(clip, sc["tri_vidx"], sc["n_tris"], e, e,
                               CullMode.FRONT)
            worst = max(worst, int(binning._tile_spans(s, eth, etw)[4].sum()))
        budget = int(1.3 * worst) + 8192
        if budget > self._MAX_SHADOW_PAIRS:
            _log.warning(
                "shadow span estimate %d exceeds the pair-table cap %d; "
                "shadow maps may drop geometry (overflow is counted)",
                budget, self._MAX_SHADOW_PAIRS)
        return min(self._MAX_SHADOW_PAIRS, budget)

    def _estimate_blend_budgets(self) -> tuple[float, int, int]:
        """Size the translucency budgets from the initial camera: the
        translucent draw list is usually few LARGE triangles covering a
        small screen fraction (hanging banners, glass), so neither the
        full-screen sparse-shading default nor the opaque per-tri pair
        budget fit its span profile. Returns (shade tile fraction, raster
        pair budget, raster covered-tile budget), each with headroom; the
        overflow counters cover camera moves past them."""
        cfg = self.config
        h, w = cfg.render_extent()
        n_tiles = self._shade_tile_total()
        eth, etw = _effective_tiles(cfg.raster, self.backend)
        nte = (-(-h // eth)) * (-(-w // etw))
        sc = self.scene_dev
        vo = cached_vertex_outputs(sc, *self._init_camera())
        s = triangle_setup(vo.clip, sc["blend_tri_vidx"], sc["n_blend"], w,
                           h, CullMode.NONE)
        shade_spans = int(binning._tile_spans(
            s, cfg.raster.tile_h, cfg.raster.tile_w)[4].sum())
        pair_spans = int(binning._tile_spans(s, eth, etw)[4].sum())
        pair_budget = max(3 * pair_spans // 2, 4096)
        # two-phase: spans sized the bin budget; now count EXACT covered
        # tiles at the kernel tile size (the sparse peel grid runs only
        # covered tiles)
        b = binning.bin_triangles(s, h, w, eth, etw, pair_budget)
        n_active = int((b.counts > 0).sum())
        tiles = min(max(2 * shade_spans, 16), n_tiles)
        tile_budget = min(max(2 * n_active, 256), nte)
        return tiles / n_tiles, pair_budget, tile_budget

    def mark_shadows_dirty(self) -> None:
        """Re-render shadow depth next frame (scene or light changed)."""
        self._shadows_dirty = True
        self._shadow_vp_cache = None   # refit to the CURRENT camera/scene

    def binning_stats(self, view_props: ViewProperties | None = None) -> dict:
        """One-off check of the opaque pair-table budget for a camera:
        {'live': pairs used, 'budget': capacity, 'overflow': dropped
        pairs}, counted on the device and read with one host read.
        Overflow > 0 means raise ``RasterConfig.pairs_per_tri``."""
        h, w = self.config.render_extent()
        u = torch.from_numpy(uniforms.pack_params(
            self.params_for_camera(view_props), self.n_shadows))
        params = unpack_params(u.to(self.device), self.n_shadows)
        sd = self.scene_dev
        budget = (self.config.raster.pair_budget
                  or _pair_budget(int(sd["tri_vidx"].shape[0]),
                                  self.config.raster.pairs_per_tri))
        eth, etw = _effective_tiles(self.config.raster, self.backend)
        vo = cached_vertex_outputs(sd, params["view"], params["proj"])
        s = triangle_setup(vo.clip, sd["tri_vidx"], sd["n_opaque"], w, h,
                           self.config.cull_mode)
        b = binning.bin_triangles(s, h, w, eth, etw, budget)
        live, overflow = torch.stack(
            [b.pair_valid.sum(), b.n_overflow.to(torch.int64)]).tolist()
        return {"live": live, "budget": int(budget), "overflow": overflow}

    def params_for_camera(self, view_props: ViewProperties | None = None):
        vp = view_props or ViewProperties.from_camera(self.scene_host.camera)
        params = vp.as_arrays()
        params["inv_vp_rot"] = skybox.skybox_ray_matrix(vp.view, vp.proj)
        params["inv_vp"] = grid_mod.grid_unproject_matrix(vp.view, vp.proj)
        if self.n_shadows > 0:
            # fit ONCE per dirty-flag cycle and cache. Deliberate
            # divergence: the reference refits per frame
            # (RenderScene.cpp:163-164 -> ShadowSystem::Update) while
            # rendering depth only on the dirty flag — i.e. it samples
            # REFIT coordinates against depths rendered with the old fit.
            # Caching the fit with the maps keeps sampling consistent.
            if self._shadows_dirty or self._shadow_vp_cache is None:
                with span("host.shadow_fit"):
                    self._shadow_vp_cache = \
                        fitting.shadow_transforms_for_scene(self.scene_host)
            params["shadow_viewproj"] = self._shadow_vp_cache
        return params

    def uniform_for_camera(self, view_props: ViewProperties | None = None):
        return uniforms.pack_params(self.params_for_camera(view_props),
                                    self.n_shadows)

    def _render_shadows(self) -> None:
        """The cached shadow pass: a blocking overflow check + regrow here
        is a one-off, not a per-frame stall. The maps are copied into the
        pack the frame reads, which keeps its storage."""
        for _ in range(4):
            if self._graphs:
                self._shadow_program()
                maps, sov = self._programs.replay("shadow")
            else:
                maps, sov = self._shadow_pass(self.config,
                                              self._shadow_budget_val)
            with span("host.shadow_read"):
                sov = int(sov)
            self.host_syncs += 1
            if (not self._react_overflow or sov == 0
                    or self._shadow_budget_val >= self._MAX_SHADOW_PAIRS):
                break
            self._shadow_budget_val = min(self._MAX_SHADOW_PAIRS,
                                          self._shadow_budget_val * 2)
            _log.warning("shadow pair budget overflow (%d dropped): budget "
                         "-> %d, re-rendering", sov, self._shadow_budget_val)
        if self._shadow_maps is None:
            self._shadow_maps = maps
        else:
            for dst, src in zip(self._shadow_maps, maps):
                dst.copy_(src)
        self.shadow_overflow = sov
        self._shadows_dirty = False

    # the poll waits on an unfinished frame only past this many queued ones
    # (a memory backstop: frames finish in order, so the queue stays short)
    _MAX_PENDING = 16

    def _queue_stats(self, stats: dict, record: dict | None = None) -> None:
        """Start the copy of one frame's counters to the host and queue it
        for ``_poll_overflow``: one int64 vector copied into pinned memory
        with ``non_blocking=True`` on the stream that computed it, and an
        event recorded after the copy, so the event's completion means the
        bytes have landed. On a CPU device the entry is ready at once.
        ``record``: the frame's ``profiling.frame_record``, which the poll
        hands the frame's stamps (``pass_ns``)."""
        keys = tuple(stats)
        shapes = tuple(tuple(stats[k].shape) for k in keys)
        flat = torch.cat([stats[k].reshape(-1).to(torch.int64) for k in keys])
        if flat.device.type != "cuda":
            self._pending_overflow.append(((keys, shapes, flat, record),
                                           None))
            return
        host = torch.empty(flat.shape, dtype=torch.int64, pin_memory=True)
        stream = torch.cuda.current_stream(flat.device)
        host.copy_(flat, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(stream)
        self._pending_overflow.append(((keys, shapes, host, record), ev))

    @staticmethod
    def _read_stats(entry) -> dict:
        """A queued entry's counters as host values: ints, and numpy
        arrays for the per-layer counts."""
        keys, shapes, host, _ = entry
        vals = host.tolist()
        out, i = {}, 0
        for k, shape in zip(keys, shapes):
            n = int(np.prod(shape, dtype=np.int64))
            out[k] = (vals[i] if not shape
                      else np.asarray(vals[i:i + n], np.int64).reshape(shape))
            i += n
        return out

    def _poll_overflow(self) -> None:
        """Consume the queued counters of frames that have finished; on a
        nonzero count grow the overflowing budget (opaque pairs or
        ``dense_k``, the blend budgets, the penumbra budget): a one-frame
        glitch instead of silently dropped geometry when the camera enters
        a dense view. Never waits on an unfinished frame unless more than
        ``_MAX_PENDING`` are queued. Without growth, the per-layer shade
        and penumbra budgets follow the observed coverage
        (``_maybe_retune_*``). The JAX package's controller, decision for
        decision."""
        grew = False
        while self._pending_overflow:
            entry, ev = self._pending_overflow[0]
            ready = ev is None or ev.query()
            # NEVER wait on an unfinished frame: popping an unready head
            # would serialize host and device inside the dispatch loop
            if (not grew and len(self._pending_overflow) <= self._MAX_PENDING
                    and not ready):
                break
            self._pending_overflow.pop(0)
            if grew:
                continue        # rendered with the old budgets
            if not ready:
                ev.synchronize()    # the queue is too deep: wait
                self.host_syncs += 1
            st = self._read_stats(entry)
            if entry[3] is not None and "pass_ns" in st:
                profiling.record_stamps(entry[3], st["pass_ns"])
            if "blend_shade_tiles" in st:
                self._observe_blend_tiles(st["blend_shade_tiles"])
            if "penumbra_tiles" in st:
                self._observe_penumbra(int(st["penumbra_tiles"]))
            cfg = self.config
            rc = cfg.raster
            t = int(self.scene_dev["tri_vidx"].shape[0])
            ov = int(st["pair_overflow"])
            tail_ov = int(st.get("pair_tail_overflow", 0))
            if tail_ov > 0 and rc.dense_k:
                # span>dense_k triangles overflowed the dense binning's
                # big-list cap: budget growth can never fix these, so grow
                # K; past 16 fall back to the capless fill path
                nk = rc.dense_k + max(2, rc.dense_k // 2)
                nk = nk if nk <= 16 else 0
                _log.warning("dense binning big-cap overflow (%d dropped): "
                             "dense_k %d -> %s", tail_ov, rc.dense_k,
                             nk or "fill path")
                cfg = cfg.replace(raster=dataclasses.replace(rc, dense_k=nk))
                rc = cfg.raster
            if ov > 0 and 0 < rc.pair_budget < self._MAX_PAIRS:
                # the overflow count is exact (live = budget + dropped):
                # grow straight to the observed need plus 15% headroom
                need = rc.pair_budget + ov
                nb = min(self._MAX_PAIRS, max(need + need // 7 + 8192,
                                              rc.pair_budget + 8192))
                _log.warning("pair budget overflow (%d dropped): budget %d "
                             "-> %d", ov, rc.pair_budget, nb)
                cfg = cfg.replace(raster=dataclasses.replace(
                    rc, pair_budget=nb))
            elif (ov > 0 and rc.pairs_per_tri < 64
                    and rc.pairs_per_tri * t < self._MAX_PAIRS):
                new_ppt = min(64, rc.pairs_per_tri
                              + max(1, rc.pairs_per_tri // 2))
                _log.warning("pair budget overflow (%d dropped): "
                             "pairs_per_tri %d -> %d", ov, rc.pairs_per_tri,
                             new_ppt)
                cfg = cfg.replace(raster=dataclasses.replace(
                    rc, pairs_per_tri=new_ppt))
            blend_ov = int(st["blend_pair_overflow"])
            if blend_ov > 0:
                # the counter folds pair, sparse-grid tile AND sparse-shade
                # tile overflow; grow every budget that exists. Per-layer
                # shade budgets jump straight to 2x the OBSERVED coverage
                # when that is more than doubling.
                changed = {}
                bb = cfg.blend_pair_budget
                if 0 < bb < self._MAX_PAIRS:
                    changed["blend_pair_budget"] = bb * 2
                if cfg.blend_tile_budget:
                    changed["blend_tile_budget"] = min(
                        2 * cfg.blend_tile_budget, self._MAX_PAIRS)
                if cfg.translucency_tile_fraction < 1.0:
                    changed["translucency_tile_fraction"] = min(
                        1.0, 2.0 * cfg.translucency_tile_fraction)
                if cfg.blend_layer_tile_budgets:
                    total = self._shade_tile_total()
                    obs = (self._blend_obs[-1] if self._blend_obs
                           else [0] * len(cfg.blend_layer_tile_budgets))
                    changed["blend_layer_tile_budgets"] = tuple(
                        min(total, max(2 * b, 2 * int(o)))
                        for b, o in zip(cfg.blend_layer_tile_budgets, obs))
                if changed:
                    _log.warning("blend budget overflow (%d dropped): "
                                 "growing %s", blend_ov, sorted(changed))
                    cfg = cfg.replace(**changed)
                    # ratchet: the pre-grow budgets are PROVEN too small.
                    # Floor future shrinks at the grown values and demand
                    # a fresh low streak, or an orbiting camera oscillates
                    # shrink -> overflow -> grow
                    if "blend_layer_tile_budgets" in changed:
                        grown = changed["blend_layer_tile_budgets"]
                        self._blend_floor = tuple(
                            max(a, b) for a, b in zip(
                                grown, self._blend_floor
                                or (0,) * len(grown)))
                    self._blend_obs.clear()
                    self._polls_since_blend_retune = 0
            pen_ov = int(st.get("penumbra_overflow", 0))
            if pen_ov > 0 and cfg.penumbra_tile_budget:
                # over-budget penumbra segments rendered the fully-shadowed
                # estimate this frame: jump to 1.5x the observed count
                total = self._shade_tile_total()
                obs = int(st["penumbra_tiles"])
                nb = min(total, max(2 * cfg.penumbra_tile_budget,
                                    obs + obs // 2))
                if nb > cfg.penumbra_tile_budget:
                    _log.warning("penumbra tile budget overflow (%d over): "
                                 "%d -> %d", pen_ov,
                                 cfg.penumbra_tile_budget, nb)
                    cfg = cfg.replace(penumbra_tile_budget=nb)
                    self._pen_floor = max(self._pen_floor, nb)
                    self._pen_obs.clear()
                    self._polls_since_pen_retune = 0
            if cfg is not self.config:
                self.config = cfg
                grew = True
        if not grew:
            self._maybe_retune_blend_layers()
            self._maybe_retune_penumbra()

    def _observe_blend_tiles(self, counts: np.ndarray) -> None:
        self._blend_obs.append(np.asarray(counts).astype(np.int64))
        if len(self._blend_obs) > max(64, self.blend_shrink_after):
            self._blend_obs.pop(0)
        self._polls_since_blend_retune += 1

    def _maybe_retune_blend_layers(self) -> None:
        """Drive the per-peel-layer sparse-shade budgets from OBSERVED
        coverage (previous frames' covered-tile counts) instead of the
        initial-camera estimate: deeper layers usually cover far less than
        layer 1 (a screen-filling banner has little banner-behind-banner).

        Policy:
        - first ready observation -> set budgets = 2x observed, once;
        - shrink only after ``blend_shrink_after`` consecutive
          observations all below 1/4 of budget (growth is the overflow
          counter's job, and it is exact)."""
        if not self._blend_obs or not self._react_overflow:
            return
        n_tiles = self._shade_tile_total()
        cur = self.config.blend_layer_tile_budgets
        first = not cur

        def target(c: int) -> int:
            # 2x headroom; saturate to the dense path near full coverage
            # (the sparse gather/scatter is pure overhead there)
            t = 2 * int(c)
            return n_tiles if t >= n_tiles else \
                min(n_tiles, max(self.blend_tile_floor, t))

        def floored(vals):
            if not self._blend_floor:
                return vals
            fl = self._blend_floor + (0,) * (len(vals)
                                             - len(self._blend_floor))
            return tuple(max(v, f) for v, f in zip(vals, fl))

        if first:
            new = floored(tuple(target(c) for c in self._blend_obs[-1]))
        else:
            window = self._blend_obs[-self.blend_shrink_after:]
            due = (len(window) >= self.blend_shrink_after
                   and self._polls_since_blend_retune
                   >= self.blend_shrink_after)
            if not due:
                return
            worst = np.maximum.reduce(window)
            raw = tuple(target(c) for c in worst)
            new = floored(raw)
            # shrink-only here, and only across a real gap
            if not (len(new) == len(cur)
                    and all(b <= c for b, c in zip(new, cur))
                    and any(2 * b < c for b, c in zip(new, cur))):
                # if the floor alone blocked a real shrink, decay it: each
                # grow -> blocked-shrink cycle halves the gap, so an
                # orbiting camera converges instead of oscillating
                if (self._blend_floor and len(raw) == len(cur)
                        and any(2 * b < c for b, c in zip(raw, cur))):
                    self._blend_floor = tuple(f // 2
                                              for f in self._blend_floor)
                    self._polls_since_blend_retune = 0
                return
        if new != cur:
            _log.info("blend shade budgets <- observed coverage: %s -> %s "
                      "(of %d tiles)", cur or "(shared)", new, n_tiles)
            self.config = self.config.replace(blend_layer_tile_budgets=new)
        self._polls_since_blend_retune = 0

    def _observe_penumbra(self, count: int) -> None:
        self._pen_obs.append(count)
        if len(self._pen_obs) > max(64, self.blend_shrink_after):
            self._pen_obs.pop(0)
        self._polls_since_pen_retune += 1

    def _maybe_retune_penumbra(self) -> None:
        """Tighten the two-stage-PCF window budget to ~1.5x the OBSERVED
        penumbra tile count (the blend budgets' policy: one
        first-observation tune, then shrink only after a streak)."""
        if not self._pen_obs or not self._react_overflow \
                or not self.config.penumbra_tile_budget:
            return
        total = self._shade_tile_total()
        cur = self.config.penumbra_tile_budget

        def target(c: int) -> int:
            return max(min(total, max(64, c + c // 2)), self._pen_floor)

        if not self._pen_tuned:
            new = target(self._pen_obs[-1])
            if new >= cur:       # only ever tightens at first observation
                self._pen_tuned = True
                return
        else:
            window = self._pen_obs[-self.blend_shrink_after:]
            due = (len(window) >= self.blend_shrink_after
                   and self._polls_since_pen_retune >= self.blend_shrink_after)
            if not due:
                return
            new = target(max(window))
            if not 2 * new < cur:          # real gap only
                # the blend budgets' floor decay (see above)
                raw = min(total, max(64, max(window) * 3 // 2))
                if self._pen_floor and 2 * raw < cur:
                    self._pen_floor //= 2
                    self._polls_since_pen_retune = 0
                return
        _log.info("penumbra tile budget <- observed: %d -> %d (of %d tiles)",
                  cur, new, total)
        self.config = self.config.replace(penumbra_tile_budget=new)
        self._pen_tuned = True
        self._polls_since_pen_retune = 0

    def render_eager(self):
        """The frame the program replays, dispatched op by op:
        ``render_frame`` over the renderer's state (the uniform of the last
        ``render()``, the cached shadow maps, the current budgets). The CPU
        path of ``render()``; on the card, for comparisons."""
        return self._frame_fn()()

    def render(self, view_props: ViewProperties | None = None):
        """Render one frame: returns (image [H,W,4] uint8 on the device,
        stats dict of tensors, see ``render_frame``, and ``pass_ns``, the
        device ns of the passes of ``profiling.STAMPED``), the frame's own
        tensors. Work is queued on the device; ``.cpu()`` fetches the
        image. The first frame, and the first after
        ``mark_shadows_dirty()``, also renders the shadow maps. With
        ``auto_tune_pairs`` the call first polls the counters of earlier
        frames that have finished (``_poll_overflow``, no host wait), and
        queues this frame's. On a CUDA device the frame, and the bakes of
        a shadow-dirty or exposure-change TSS frame, are replays of
        captured programs: a warm frame and an exposure-change frame make
        no host sync, a shadow-dirty frame one (the shadow pass's overflow
        read, as in the JAX package). Under ``torch.profiler`` the call
        leaves a record in ``profiling.frame_trace()``."""
        with profiling.frame_record(self.frame_records) as rec:
            syncs = self.host_syncs
            dirty = self.n_shadows > 0 and self._shadows_dirty
            out = self._render(view_props, rec)
            if rec is not None:
                rec.update(replayed=self._graphs, dirty=dirty)
                rec["syncs"] += self.host_syncs - syncs
        return out

    def _render(self, view_props, rec, params=None):
        # ``params``: host params to render in place of the camera's (the
        # (fn, scene_dev, params_builder) form of ``parallel.sharded``)
        if self._react_overflow:
            self._poll_overflow()
        u = (self.uniform_for_camera(view_props) if params is None
             else uniforms.pack_params(params, self.n_shadows))
        with span("host.upload"):
            uniforms.upload(self._u, u)
        bake = False
        if self.config.texture_space:
            # exposure is folded into the static diffuse bake; a change
            # re-bakes it (unless the shadow re-bake below does anyway)
            e = (float(view_props.exposure) if view_props is not None
                 else float(self.scene_host.camera.exposure))
            if e != self._baked_exposure:
                self._baked_exposure = e
                bake = True
        progs = self._programs if self._graphs else None
        if self.n_shadows > 0 and self._shadows_dirty:
            self._render_shadows()
            if self.config.texture_space:
                # the frame never gathers PCF windows: bake them per texel
                with span("host.bake"), profiling.stamping(self._stamps):
                    bake_tss(self.tss_bakes(True), progs)
        elif bake:
            with span("host.bake"), profiling.stamping(self._stamps):
                bake_tss(self.tss_bakes(False), progs)
        if self._graphs:
            with span("host.replay"):
                img, stats = self._programs.replay("frame")
        else:
            img, stats = self.render_eager()
        if self._react_overflow:
            with span("host.queue_stats"):
                self._queue_stats(stats, rec)
        if self._graphs:
            # the next replay overwrites the graph's outputs
            with span("host.clone"):
                img, stats = img.clone(), {k: v.clone()
                                           for k, v in stats.items()}
        return img, stats


__all__ = ["FrameRenderer", "render_frame", "render_shadow_pass",
           "render_shadow_maps", "scene_to_device", "rasterize",
           "shade_sparse", "resolve_attributes", "cached_vertex_outputs",
           "check_config",
           "RasterConfig", "RenderConfig"]
