"""The plain reference frame: the port's frame pass chain as it was when
the benchmark was written, on its ``reference`` backend, over plain
PyTorch only.

A frozen copy of ``renderengine_tpu_torch/graph/frame.py``'s pass chain
(shadow depth -> opaque base pass -> skybox -> depth-peeled translucency
-> sRGB encode, per-pixel PBR or texture-space shading) with these
departures:

- every raster pass goes through ``raster/binned_raster.py``: the same
  coverage, depth and winner rule as the brute-force oracle, evaluated
  only inside each triangle's bounding box (the oracle is O(T*H*W) and
  cannot run a 1080p frame of 260k triangles in a run's time);
- no tile kernel, no pair tables, no captured graphs, no budget
  controller, and no budget: nothing is dropped. Every covered peel
  pixel is shaded (what the port's sparse peel shading gives with a
  budget that covers every tile) and the PCF window runs at every pixel
  (what the two-stage PCF gives with a budget that covers every penumbra
  tile: the two are bit-exact). Where the port's dense peel shading
  computes otherwise (texture-space half-res light), a frame has one
  candidate image for each choice of path per layer: the port picks the
  path from its budgets, which the reference does not read;
- no editor grid, shadow-map quad, alpha-mask pass, Phong or band
  path: a config asking for one is refused;
- ``ssaa > 1`` renders every pass at ``config.render_extent()`` and
  resolves each candidate's linear colour to ``(height, width)`` by the
  ``ssaa x ssaa`` box mean in float32 before the sRGB encode, as the
  port's ``frame.encode`` does;
- ``lowp=True`` holds the G-buffer attributes and the shaded colours in
  bfloat16: the control of the benchmark's comparison (resolved after
  its bfloat16 rounding).

``ReferenceRenderer`` re-derives from the host scene everything the
port's renderer derives at set-up: the device scene, the chart layout at
the initial camera, the texture-space bakes, the shadow fit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import CullMode, RenderConfig, ShadingModel
from ..raster import reference_raster as rref
from ..raster.binned_raster import rasterize_binned
from ..raster.setup import (VertexOutputs, clip_coords, corner_clip,
                            triangle_setup_corners, viewproj)
from ..scene.camera import ViewProperties
from ..shading import fitting, lightchart, pbr, skybox
from ..shading import shadow as shadow_mod
from ..shading.srgb import encode_srgb8
from . import uniforms
from .uniforms import unpack_params


def check_config(config: RenderConfig) -> None:
    """Refuse what this reference does not render."""
    if (config.grid or config.show_shadow_quad or config.alpha_mask
            or config.shading != ShadingModel.PBR):
        raise ValueError("the reference renders PBR frames without grid, "
                         "shadow quad or alpha-mask pass")
    # the port folds the rendered rows into whole output rows: a whole
    # frame's height * ssaa rows always fold, so its one rule is ssaa >= 1
    if not isinstance(config.ssaa, int) or config.ssaa < 1:
        raise ValueError(f"ssaa must be a whole number >= 1, not "
                         f"{config.ssaa!r}")
    if config.texture_space and config.debug_views:
        raise ValueError("texture_space needs debug_views=False")


def _static_shadow_lights(dev_np: dict) -> tuple:
    """Per-light "pays the shadow lookup" flags: 0 = no lookup, 1 =
    planar map (directional or spot), 6 = point-light cube."""
    lt = np.asarray(dev_np["light_type"])
    si = np.asarray(dev_np["light_shadow_index"])
    nl = int(np.asarray(dev_np["n_lights"]))

    def flag(i: int) -> int:
        if not (i < nl and si[i] >= 0):
            return 0
        return {1: 1, 2: 6, 3: 1}.get(int(lt[i]), 0)

    return tuple(flag(i) for i in range(lt.shape[0]))


def scene_to_device(dev_np: dict, device) -> dict:
    """``Scene.upload()`` output -> device dict (u32 tables as int32 bit
    views)."""
    out = {}
    for k, v in dev_np.items():
        a = np.asarray(v)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out[k] = torch.from_numpy(np.array(a, order="C")).to(device)
    return out


def cached_vertex_outputs(scene, view, proj) -> VertexOutputs:
    world = scene["world_pos"]
    clip = clip_coords(world, viewproj(view, proj))
    return VertexOutputs(world, scene["world_normal"], scene["uvs"], clip)


def resolve_attributes(scene, vo: VertexOutputs, coef, g, height: int,
                       width: int, tri_table: str = "tri_packed"):
    """Per-pixel perspective-correct vertex attributes from barycentrics
    recomputed at the pixel centres."""
    tri_id = g.tri_id
    if g.bary is not None:
        b01 = g.bary
        bary = torch.cat([b01, 1.0 - b01[..., :1] - b01[..., 1:2]], -1)
    else:
        bary, _ = rref.barycentrics_at(coef, tri_id, height, width)
    safe_tri = tri_id.clamp_min(0).long()
    trow = scene[tri_table][safe_tri]
    vidx = trow[..., 0:3].long()
    vattr = torch.cat([vo.world_pos, vo.world_normal, vo.uv], -1)
    corners = vattr[vidx]
    b = bary[..., None]
    interp = (corners[..., 0, :] * b[..., 0, :]
              + corners[..., 1, :] * b[..., 1, :]) \
        + corners[..., 2, :] * b[..., 2, :]
    return {"pos": interp[..., 0:3], "normal": interp[..., 3:6],
            "uv": interp[..., 6:8], "mat_id": trow[..., 3],
            "covered": tri_id >= 0}


def render_shadow_maps(scene, shadow_viewproj, extent: int, n_shadows: int):
    """Depth-only raster per shadow map, front-culled: [NS,E,E] f32."""
    maps = []
    for si in range(n_shadows):
        c = corner_clip(scene["corner_attr"][..., 0:3], shadow_viewproj[si])
        s = triangle_setup_corners(c, scene["n_tris"], extent, extent,
                                   CullMode.FRONT)
        maps.append(rasterize_binned(s, extent, extent).depth)
    return torch.stack(maps)


def render_shadow_pass(scene, uniform, config: RenderConfig,
                       n_shadows: int):
    """The shadow maps at the uniform's shadow transforms, packed as the
    frame samples them (``shadow.ShadowPack``)."""
    params = unpack_params(uniform, n_shadows)
    maps = render_shadow_maps(scene, params["shadow_viewproj"],
                              config.shadow_extent, n_shadows)
    return shadow_mod.pack_shadow_blocks(maps)


def _list_setup(scene, params, config: RenderConfig, corner_key: str, n_key,
                cull):
    fh, w = config.render_extent()
    vpm = viewproj(params["view"], params["proj"])
    return triangle_setup_corners(
        corner_clip(scene[corner_key][..., 0:3], vpm), scene[n_key], w, fh,
        cull)


def _tss_shade_fns(scene, config: RenderConfig, ls_atlas, slots_used,
                   alpha_is_factor: bool):
    """The texture-space screen passes (opaque dense pass, peel pass per
    pixel, peel pass dense), as the port's ``_tss_shade_fns``; and whether
    the two peel passes compute differently (half-res light)."""
    c_ah, c_aw = ls_atlas.shape[1:]
    pre_any = config.tss_preshaded or config.tss_preshaded_blend
    half = (config.chart_density <= 0.5 if config.tss_halfres_light < 0
            else bool(config.tss_halfres_light))

    if pre_any:
        rgb_blocks = lightchart.pack_rgbe_blocks(scene["chart_base"]
                                                 + ls_atlas)
        a_blocks = scene["chart_a"]

        def factor_alpha(out, mat_id, need_alpha):
            from ..shading import sampling
            if not (need_alpha and alpha_is_factor):
                return out
            fa = sampling.table_lookup_planar(scene["mat_all"], mat_id,
                                              (3,))[0]
            return torch.cat([out[..., :3], fa[..., None]], -1)

        def pre_px(chart_uv, uv, mat_id, need_alpha=True, covered=None):
            out = lightchart.tss_shade_pre(
                rgb_blocks, a_blocks, chart_uv, c_ah, c_aw,
                need_alpha=need_alpha and not alpha_is_factor)
            return factor_alpha(out, mat_id, need_alpha)

        def pre_dense(chart_uv, uv, mat_id, need_alpha=True, covered=None):
            if not half:
                return pre_px(chart_uv, uv, mat_id, need_alpha)
            out = lightchart.tss_shade_pre_halfres(
                rgb_blocks, a_blocks, chart_uv, c_ah, c_aw, y0=0,
                need_alpha=need_alpha and not alpha_is_factor)
            return factor_alpha(out, mat_id, need_alpha)

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
                    scene, chart_uv, uv, mat_id, light8, c_ah, c_aw, y0=0,
                    covered=covered, **kw)
            return px(chart_uv, uv, mat_id, covered=covered)

    if pre_any:
        return dense, pre_px, pre_dense, half
    return dense, px, dense, half


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def resolve_ssaa(rgb: torch.Tensor, f: int) -> torch.Tensor:
    """[f*H,f*W,3] linear colour -> [H,W,3]: the mean of each ``f x f``
    block in float32, the port's resolve before its sRGB encode."""
    if f == 1:
        return rgb
    fh, fw = rgb.shape[:2]
    return rgb.reshape(fh // f, f, fw // f, f, 3).mean(dim=(1, 3))


def render_frame(scene, uniform, shadow_maps, config: RenderConfig,
                 n_shadows: int, has_translucent: bool, slots_used,
                 shadow_lights, alpha_is_factor: bool = False,
                 lowp: bool = False):
    """One frame's candidate [H,W,4] uint8 sRGB images: one, or one for
    each choice of the peel layers' shading paths where those differ (see
    the module); each rendered at ``config.render_extent()`` and resolved
    to ``(height, width)``."""
    check_config(config)
    params = unpack_params(uniform, n_shadows)
    vo = cached_vertex_outputs(scene, params["view"], params["proj"])
    lp = _bf16 if lowp else (lambda x: x)
    fh, w = config.render_extent()
    dev = vo.world_pos.device
    shadow_tf = (params["shadow_viewproj"]
                 if config.shadows and n_shadows > 0 else None)
    view_args = {"view_pos": params["view_pos"],
                 "exposure": params["exposure"],
                 "debug_input": params["debug_input"],
                 "debug_equation": params["debug_equation"]}

    def shade(frag, covered):
        return lp(pbr.brdf_lighting(
            scene, lp(frag["pos"]), lp(frag["uv"]), lp(frag["normal"]),
            frag["mat_id"], view_args, shadow_maps, shadow_tf,
            slots_used=slots_used, shadow_lights=shadow_lights,
            max_aniso=config.aniso(), dither=config.dither_trilinear,
            debug_views=config.debug_views,
            ibl_diffuse=config.ibl_diffuse,
            covered=covered))

    blend_pass = config.translucency and has_translucent
    tss = config.texture_space
    if tss:
        ls_atlas = lightchart.chart_light_spec(
            scene, scene["chart_pos"], scene["chart_normal"],
            scene["chart_mat"], scene["chart_vis"], view_args)
        tss_dense, tss_blend_px, tss_blend_dense, two_paths = \
            _tss_shade_fns(scene, config, lp(ls_atlas), slots_used,
                           alpha_is_factor)
    setup = _list_setup(scene, params, config, "corner_attr", "n_opaque",
                        config.cull_mode)
    setup_t = (_list_setup(scene, params, config, "corner_attr_blend",
                           "n_blend", CullMode.NONE) if blend_pass else None)
    g = rasterize_binned(setup, fh, w)
    covered = g.tri_id >= 0
    if tss:
        frag = lightchart.resolve_tss(scene, setup.coef, g, fh, w)
        rgba = lp(tss_dense(lp(frag["chart_uv"]), lp(frag["uv"]),
                            frag["mat_id"], need_alpha=False,
                            covered=covered))
    else:
        frag = resolve_attributes(scene, vo, setup.coef, g, fh, w)
        rgba = shade(frag, covered)
    depth_eff = g.depth

    if config.skybox:
        sky_fn = (skybox.render_skybox_halfres if config.sky_halfres
                  else skybox.render_skybox)
        sky = sky_fn(scene["cubemap"], params["inv_vp_rot"], fh, w)
        rgb = torch.where(covered[..., None], rgba[..., :3], sky[..., :3])
    else:
        rgb = torch.where(covered[..., None], rgba[..., :3], 0.0)

    outs = [rgb]
    if blend_pass:
        def resolve_and_shade(fr, dense=False):
            gsub = rref.GBuffer(depth=None, tri_id=fr["tri_id"],
                                bary=fr["bary"])
            if tss:
                tss_sh = tss_blend_dense if dense else tss_blend_px
                fsub = lightchart.resolve_tss(
                    scene, setup_t.coef, gsub, *fr["tri_id"].shape,
                    tri_table="blend_tri_packed",
                    corner_table="chart_corner_blend")
                return lp(tss_sh(lp(fsub["chart_uv"]), lp(fsub["uv"]),
                                 fsub["mat_id"], covered=fr["covered"]))
            fsub = resolve_attributes(scene, vo, setup_t.coef, gsub,
                                      *fr["tri_id"].shape,
                                      tri_table="blend_tri_packed")
            return shade(fsub, fr["covered"])

        prev = torch.full((fh, w), -1.0, dtype=torch.float32, device=dev)
        layers = []
        for li in range(config.translucency_layers):
            gt = rasterize_binned(setup_t, fh, w,
                                  peel_bounds=(prev, depth_eff))
            prev = torch.where(gt.tri_id >= 0, gt.depth, 2.0)
            covered_t = gt.tri_id >= 0
            bary_t, _ = rref.barycentrics_at(setup_t.coef, gt.tri_id, fh, w)
            fr = {"covered": covered_t, "tri_id": gt.tri_id,
                  "bary": bary_t[..., :2]}
            paths = [resolve_and_shade(fr)]
            if tss and two_paths:
                paths.append(resolve_and_shade(fr, dense=True))
            layers.append((covered_t, paths))
        # every choice of path per layer, composited back to front
        for covered_t, paths in reversed(layers):
            a = [p[..., 3].clamp(0.0, 1.0) * covered_t for p in paths]
            outs = [o * (1.0 - ai[..., None]) + p[..., :3] * ai[..., None]
                    for o in outs for p, ai in zip(paths, a)]
    return [encode_srgb8(resolve_ssaa(lp(o), config.ssaa)) for o in outs]


def bake_tss_visibility(scene, shadow_maps, u, n_shadows: int,
                        shadow_lights) -> None:
    """Per-texel PCF visibility into ``scene["chart_vis"]``."""
    params = unpack_params(u, n_shadows)
    geo = {"pos": scene["chart_pos"], "normal": scene["chart_normal"],
           "mat_id": scene["chart_mat"][15]}
    scene["chart_vis"].copy_(lightchart.bake_visibility(
        scene, geo, shadow_maps, params["shadow_viewproj"], shadow_lights))


def bake_tss_tables(scene, config: RenderConfig, u) -> None:
    """The static light tables at the uniform's exposure."""
    for k, v in lightchart.static_tables(
            scene, config, unpack_params(u, 0)["exposure"]).items():
        scene[k].copy_(v)


class ReferenceRenderer:
    """The scene uploaded and set up as the port's renderer sets it up at
    init (the chart layout and the texture-space bakes from the scene's
    camera as it stands now), rendering single frames eagerly.

    ``render(view_props, config, shadow_fit)`` renders the shadow maps at
    ``shadow_fit`` ([NS,4,4], from ``shadow_fit()`` at the camera the
    caller wants the maps fitted to), re-bakes the texture-space
    visibility from them when the fit changed, and renders the frame."""

    def __init__(self, scene_host, config: RenderConfig, device):
        check_config(config)
        self.device = torch.device(device)
        self.scene_host = scene_host
        self.n_shadows = scene_host.n_shadow_maps if config.shadows else 0
        if config.texture_space:
            vp0 = ViewProperties.from_camera(scene_host.camera)
            viewproj0 = np.asarray(vp0.proj) @ np.asarray(vp0.view)
            dev_np = scene_host.upload(chart_subdiv=dict(
                viewproj=viewproj0, width=config.width,
                height=config.height, density=config.chart_density))
            lightchart.attach_chart_layout(dev_np, viewproj0, config)
        else:
            dev_np = scene_host.upload()
        self.scene_dev = scene_to_device(dev_np, self.device)
        self.slots_used = tuple(bool((dev_np[k] >= 0).any()) for k in
                                ("mat_tex_base", "mat_tex_emissive",
                                 "mat_tex_orm", "mat_tex_normal"))
        self.has_translucent = int(dev_np["n_blend"]) > 0
        self.shadow_lights = _static_shadow_lights(dev_np)
        self.alpha_is_factor = False
        self.exposure = float(scene_host.camera.exposure)
        if config.texture_space:
            up, self.alpha_is_factor = lightchart.setup_scene_tss(
                self.scene_dev, config, self.slots_used, self.exposure,
                lightchart.host_alpha_is_factor(
                    dev_np, getattr(scene_host, "textures", None)))
            self.scene_dev.update(up)
        self._fit = None
        self._maps = None

    def shadow_fit(self) -> np.ndarray:
        """The shadow transforms fitted to the scene's camera now."""
        return fitting.shadow_transforms_for_scene(self.scene_host)

    def uniform(self, view_props: ViewProperties, shadow_fit) -> torch.Tensor:
        params = view_props.as_arrays()
        params["inv_vp_rot"] = skybox.skybox_ray_matrix(view_props.view,
                                                        view_props.proj)
        if self.n_shadows > 0:
            params["shadow_viewproj"] = shadow_fit
        return torch.from_numpy(uniforms.pack_params(
            params, self.n_shadows)).to(self.device)

    def render(self, view_props: ViewProperties, config: RenderConfig,
               shadow_fit=None, lowp: bool = False):
        """The candidate images of one frame at ``view_props`` (see the
        class and ``render_frame``); ``lowp``: the control, in
        bfloat16."""
        u = self.uniform(view_props, shadow_fit)
        if self.n_shadows > 0 and (
                self._fit is None
                or not np.array_equal(self._fit, np.asarray(shadow_fit))):
            self._maps = render_shadow_pass(self.scene_dev, u, config,
                                            self.n_shadows)
            self._fit = np.array(shadow_fit, copy=True)
            if config.texture_space:
                # the port's shadow-dirty bakes: visibility, then the
                # static tables that read it
                bake_tss_visibility(self.scene_dev, self._maps, u,
                                    self.n_shadows, self.shadow_lights)
                bake_tss_tables(self.scene_dev, config, u)
        if config.texture_space and float(view_props.exposure) != \
                self.exposure:
            raise ValueError("the reference bakes one exposure")
        return render_frame(self.scene_dev, u, self._maps, config,
                            self.n_shadows, self.has_translucent,
                            self.slots_used, self.shadow_lights,
                            self.alpha_is_factor, lowp=lowp)
