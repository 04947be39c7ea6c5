"""Blinn-Phong shading — port of the reference's legacy ``phong.glsl``
(the minimal-slice shading model, BASELINE config 1:
``ShadingModel.PHONG``); torch port of the JAX package's
``shading/phong.py``.

Material mapping from the PBR table: diffuse = baseColor (x texture),
specular = f0, shininess from roughness via a standard Blinn-Phong fit
(shininess = 2/alpha^2 - 2).
"""

from __future__ import annotations

import torch

from . import sampling
from .pbr import _sample_slot, _slot, dot3, norm
from .shadow import compute_shadow_directional
from .srgb import srgb_to_linear


def phong_lighting(scene, frag_pos, uv, frag_normal, mat_id, view_args,
                   shadow_maps=None, shadow_transforms=None,
                   slots_used=(True, True, True, True),
                   shadow_lights=None, max_aniso=1, debug_views=True,
                   penumbra_tiles=0, shadow_stats=None, ibl_diffuse=False,
                   dither=False, covered=None, penumbra_full_h=None):
    """Port of ``PhongLighting`` (phong.glsl:38-81), summed over lights.
    Light colors map: ambient = 0.03*color, diffuse = specular =
    intensity*color. Returns rgba (linear)."""
    dev = uv.device
    row = sampling.table_lookup(scene["mat_all"], mat_id)
    core = row[..., :16]
    mtex = row[..., 16:]
    duv_dx, duv_dy = sampling.quad_derivs(uv, covered)
    if slots_used[0]:
        tb = _slot(mtex, 0)
        base_tex = _sample_slot(scene, tb, uv, duv_dx, duv_dy,
                                torch.ones(4, device=dev), max_aniso, dither)
        diffuse_p = core[..., 0:4] * torch.cat(
            [srgb_to_linear(base_tex[..., :3]), base_tex[..., 3:4]], -1)
        diffuse_p = torch.where(tb["valid"][..., None], diffuse_p,
                                core[..., 0:4])
    else:
        diffuse_p = core[..., 0:4].expand(mat_id.shape + (4,))
    spec_p = core[..., 8:9]  # f0 as the specular strength
    rough = core[..., 10].clamp(0.089, 1.0)
    shininess = (2.0 / (rough * rough * rough * rough) - 2.0).clamp_min(1.0)

    n = norm(frag_normal)
    v = norm(view_args["view_pos"] - frag_pos)

    out = torch.zeros_like(frag_pos)
    for li in range(scene["light_type"].shape[0]):
        ltype = scene["light_type"][li]
        lcolor = scene["light_color"][li]
        lint = scene["light_intensity"][li]
        is_dir = ltype == 1
        ld = torch.where(is_dir, -scene["light_dir"][li][None, None, :],
                         scene["light_pos"][li] - frag_pos)
        dist = torch.sqrt(dot3(ld, ld)).clamp_min(1e-9)
        l = ld / dist[..., None]

        ambient = (0.03 * lcolor) * diffuse_p[..., :3]
        k_d = dot3(l, n).clamp_min(0.0)
        diffuse = k_d[..., None] * (lint * lcolor) * diffuse_p[..., :3]
        hv = norm(l + v)
        k_s = torch.pow(dot3(n, hv).clamp_min(0.0), shininess)
        specular = k_s[..., None] * (lint * lcolor) * spec_p

        att = torch.where(is_dir, 1.0, 1.0 / dist)
        cos_theta = dot3(-l, scene["light_dir"][li])
        eps = (scene["light_cos_inner"][li]
               - scene["light_cos_outer"][li]).clamp_min(1e-4)
        spot = ((cos_theta - scene["light_cos_outer"][li]) / eps).clamp(0.0, 1.0)
        spot = torch.where(ltype == 3, spot, 1.0)

        shadow = torch.zeros_like(k_d)
        if shadow_maps is not None and (shadow_lights is None
                                        or shadow_lights[li]):
            cube = shadow_lights is not None and shadow_lights[li] == 6
            casts = scene["light_shadow_index"][li] >= 0
            shadow = torch.where(
                casts,
                compute_shadow_directional(shadow_maps, shadow_transforms,
                                           scene["light_shadow_index"][li],
                                           scene["light_pos"][li], frag_pos, n,
                                           penumbra_tiles=penumbra_tiles,
                                           stats_out=shadow_stats,
                                           cube=cube,
                                           penumbra_full_h=penumbra_full_h),
                0.0)
        in_range = li < scene["n_lights"]
        contrib = (ambient + (1.0 - shadow)[..., None]
                   * (diffuse * spot[..., None] + specular * spot[..., None])) \
            * att[..., None]
        out = out + torch.where(in_range, contrib, 0.0)

    out = out * view_args["exposure"]
    return torch.cat([out, diffuse_p[..., 3:4]], -1)
