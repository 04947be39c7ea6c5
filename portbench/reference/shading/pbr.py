"""Filament-style PBR shading — the deferred-fragment-stage port of
``Assets/Shaders/pbr.glsl`` + ``surface_pbr.frag`` (torch port of the JAX
package's ``shading/pbr.py``).

Operates on [H,W]-shaped interpolated fragment attributes, dense over the
framebuffer. The light loop runs over the (small, static) light axis.
"""

from __future__ import annotations

import torch

from ..core.config import DebugEquation, DebugInput
from . import sampling
from .shadow import compute_shadow_directional
from .srgb import srgb_to_linear

PI = 3.14159265359


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of size 3, in (x + y) + z order."""
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def norm(v: torch.Tensor) -> torch.Tensor:
    """v / max(|v|, 1e-20) over the last axis."""
    return v / torch.sqrt(dot3(v, v)).clamp_min(1e-20)[..., None]


def cross(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.stack([u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
                        u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
                        u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]], -1)


# --- BRDF terms (pbr.glsl:237-280) ---------------------------------------

def d_ggx(noh, a):
    a2 = a * a
    f = (noh * a2 - noh) * noh + 1.0
    return a2 / (PI * f * f)


def f_schlick(u, f0):
    return f0 + (1.0 - f0) * torch.pow(1.0 - u, 5.0)[..., None]


def g_smith_ggx_correlated(nov, nol, a):
    a2 = a * a
    ggxl = nov * torch.sqrt((-nol * a2 + nol) * nol + a2)
    ggxv = nol * torch.sqrt((-nov * a2 + nov) * nov + a2)
    return 0.5 / (ggxv + ggxl).clamp_min(1e-9)


def fd_lambert():
    return 1.0 / PI


# --- material fetch + remap (pbr.glsl:100-233) ----------------------------

def _slot(mat_tex_row, si):
    """Slot descriptor from the packed mat_tex row (f32-exact small ints)."""
    d = mat_tex_row[..., 6 * si: 6 * si + 6]
    return {
        "page": d[..., 0].to(torch.int32),
        "x": d[..., 1].to(torch.int32),
        "y": d[..., 2].to(torch.int32),
        "w": d[..., 3].to(torch.int32),
        "h": d[..., 4].to(torch.int32),
        "n_mips": d[..., 5].to(torch.int32),
        "valid": d[..., 0] >= 0,
    }


def _sample_slot(scene, tex, uv, duv_dx, duv_dy, default, max_aniso=1,
                 dither=False, pre=None):
    """texture-if-present (``pbr.glsl:102``) with per-slot implicit LOD.
    ``max_aniso`` > 1 switches to anisotropic taps; ``pre`` is the slot's
    result from the shared-footprint tiered pass (``remap_material``)."""
    if pre is not None:
        return torch.where(tex["valid"][..., None], pre, default)
    spec = sampling.aniso_spec(max_aniso)
    if spec.max_taps > 1:
        s = sampling.sample_texture_aniso(
            scene["atlas"], scene["mip_y"], scene["mip_x"], tex,
            tex["n_mips"], uv, duv_dx, duv_dy, spec.max_taps, dither=dither)
        return torch.where(tex["valid"][..., None], s, default)
    size = torch.stack([tex["w"].to(torch.float32),
                        tex["h"].to(torch.float32)], -1)
    dx = duv_dx * size
    dy = duv_dy * size
    rho2 = torch.maximum(dx[..., 0] * dx[..., 0] + dx[..., 1] * dx[..., 1],
                         dy[..., 0] * dy[..., 0] + dy[..., 1] * dy[..., 1])
    lod = 0.5 * sampling.det_log2(rho2.clamp_min(1e-40))
    s = sampling.sample_texture_rows(scene["atlas"], scene["mip_y"],
                                     scene["mip_x"], tex, tex["n_mips"], uv,
                                     lod, dither=dither)
    return torch.where(tex["valid"][..., None], s, default)


def remap_material(scene, mat_id, frag_pos, uv, frag_normal,
                   slots_used=(True, True, True, True), max_aniso=1,
                   dither=False, covered=None):
    """GetBaseColor/GetEmissive/GetNormal/GetOcclusionRoughnessMetallic +
    RemapMaterial (``pbr.glsl:100-233``). Material state arrives as one
    packed row (``mat_all``: core 16 | tex 24).

    ``slots_used``: static per-scene flags (base, emissive, orm, normal);
    a slot no material uses skips its texture sampling entirely."""
    dev = uv.device
    row = sampling.table_lookup(scene["mat_all"], mat_id)
    core = row[..., :16]
    mtex = row[..., 16:]
    m = {
        "mat_base_color": core[..., 0:4],
        "mat_emissive": core[..., 4:8],
        "mat_f0": core[..., 8],
        "mat_metallic": core[..., 9],
        "mat_roughness": core[..., 10],
        "mat_ao": core[..., 11],
    }
    ones4 = torch.ones(4, device=dev)

    duv_dx, duv_dy = sampling.quad_derivs(uv, covered)

    # tiered-aniso path: ONE shared footprint/tier/segment-selection pass
    # drives all used slots
    spec = sampling.aniso_spec(max_aniso)
    pre = {}
    if spec.max_taps > 1 and spec.tile_fracs and not dither and uv.dim() == 3:
        idxs = [si for si in range(4) if slots_used[si]]
        descs = {si: _slot(mtex, si) for si in idxs}
        caps = spec.slot_caps or (spec.max_taps,) * 4
        res = sampling.sample_slots_aniso_tiered(
            scene["atlas"], scene["mip_y"], scene["mip_x"],
            [(descs[si], descs[si]["n_mips"]) for si in idxs],
            uv, duv_dx, duv_dy, spec, slot_caps=[caps[si] for si in idxs])
        pre = dict(zip(idxs, res))

    if slots_used[0]:
        tb = _slot(mtex, 0)
        base_tex = _sample_slot(scene, tb, uv, duv_dx, duv_dy, ones4,
                                max_aniso, dither, pre=pre.get(0))
        base_color = m["mat_base_color"] * torch.cat(
            [srgb_to_linear(base_tex[..., :3]), base_tex[..., 3:4]], -1)
        base_color = torch.where(tb["valid"][..., None], base_color,
                                 m["mat_base_color"])
    else:
        base_color = m["mat_base_color"].expand(mat_id.shape + (4,))

    if slots_used[1]:
        te = _slot(mtex, 1)
        em_tex = _sample_slot(scene, te, uv, duv_dx, duv_dy, ones4,
                              max_aniso, dither, pre=pre.get(1))
        emissive = m["mat_emissive"] * torch.cat(
            [srgb_to_linear(em_tex[..., :3]), em_tex[..., 3:4]], -1)
        emissive = torch.where(te["valid"][..., None], emissive,
                               m["mat_emissive"])
    else:
        emissive = m["mat_emissive"].expand(mat_id.shape + (4,))

    if slots_used[2]:
        to = _slot(mtex, 2)
        orm_tex = _sample_slot(scene, to, uv, duv_dx, duv_dy, ones4,
                               max_aniso, dither, pre=pre.get(2))
        ho = to["valid"]
        occ = torch.where(ho, m["mat_ao"] * orm_tex[..., 0], m["mat_ao"])
        prough = torch.where(ho, m["mat_roughness"] * orm_tex[..., 1],
                             m["mat_roughness"])
        metal = torch.where(ho, m["mat_metallic"] * orm_tex[..., 2],
                            m["mat_metallic"])
    else:
        occ, prough, metal = m["mat_ao"], m["mat_roughness"], m["mat_metallic"]

    # normal mapping via screen-space derivatives (pbr.glsl:121-145)
    if slots_used[3]:
        tn_slot = _slot(mtex, 3)
        hn = tn_slot["valid"]
        tn = _sample_slot(scene, tn_slot, uv, duv_dx, duv_dy,
                          torch.full((4,), 0.5, device=dev), max_aniso,
                          dither, pre=pre.get(3))[..., :3] * 2.0 - 1.0
    else:
        hn = torch.zeros(mat_id.shape, dtype=torch.bool, device=dev)
        tn = torch.zeros(mat_id.shape + (3,), dtype=torch.float32, device=dev)
    q1, q2 = sampling.quad_derivs(frag_pos, covered)
    st1 = duv_dx
    st2 = duv_dy

    n_geo = norm(frag_normal)
    t = norm(q1 * st2[..., 1:2] - q2 * st1[..., 1:2])
    b = -norm(cross(n_geo, t))
    mapped = norm(t * tn[..., 0:1] + b * tn[..., 1:2] + n_geo * tn[..., 2:3])
    normal = torch.where(hn[..., None], mapped, n_geo)

    # remaps (pbr.glsl:169-186)
    roughness = prough.clamp(0.089, 1.0) ** 2
    diffuse = (1.0 - metal)[..., None] * base_color[..., :3]
    f0 = ((m["mat_f0"] * (1.0 - metal))[..., None]
          + base_color[..., :3] * metal[..., None])
    out = {
        "normal": normal,
        "base_color": base_color,
        "diffuse": diffuse,
        "emissive": emissive,
        "f0": f0,
        "metallic": metal,
        "roughness": roughness,
        "occlusion": occ,
    }
    if slots_used[0]:
        # the raw base tap + its validity: the texture-space albedo bake
        # reuses this pass's sampling instead of running it again
        out["base_tex_raw"] = base_tex
        out["base_valid"] = tb["valid"]
    return out


# --- lights (pbr.glsl:283-352) --------------------------------------------

def _light_direction(light, frag_pos):
    ln = norm(light["light_pos"] - frag_pos)
    dn = norm(-light["light_dir"])
    is_dir = (light["light_type"] == 1)
    return torch.where(is_dir, dn, ln)


def _square_falloff(l_unnorm, falloff_radius):
    inv_r = 1.0 / falloff_radius.clamp_min(0.083)
    d2 = dot3(l_unnorm, l_unnorm)
    factor = d2 * inv_r * inv_r
    smooth = (1.0 - factor * factor).clamp_min(0.0)
    return (smooth * smooth) / d2.clamp_min(1e-4)


def _spot_attenuation(l, light_dir, cos_inner, cos_outer):
    spot_scale = 1.0 / (cos_inner - cos_outer).clamp_min(1e-4)
    spot_offset = -cos_outer * spot_scale
    dn = norm(-light_dir)
    cd = dot3(dn, l)
    att = (cd * spot_scale + spot_offset).clamp(0.0, 1.0)
    return att * att


_LIGHT_KEYS = ("light_type", "light_color", "light_pos", "light_dir",
               "light_intensity", "light_falloff", "light_cos_inner",
               "light_cos_outer", "light_shadow_index")


def brdf_lighting(scene, frag_pos, uv, frag_normal, mat_id, view_args,
                  shadow_maps=None, shadow_transforms=None,
                  slots_used=(True, True, True, True),
                  shadow_lights=None, max_aniso=1, debug_views=True,
                  ibl_diffuse=False, dither=False, covered=None):
    """Port of ``BRDF_Lighting``. Returns rgba (linear, pre-sRGB-encode).

    view_args: dict with view_pos [3], exposure, debug_input,
    debug_equation. shadow_maps: ``shadow.ShadowPack`` or None;
    shadow_transforms: [NS,4,4]. shadow_lights: optional per-light flags
    (0 = no lookup, 1 = planar map, 6 = point-light cube) — without it
    every light pays the PCF window gather just to multiply the result by
    zero. ``debug_views``: False drops the debug-switch selects
    (``pbr.glsl:410-440``)."""
    mat = remap_material(scene, mat_id, frag_pos, uv, frag_normal, slots_used,
                         max_aniso, dither, covered=covered)

    n = mat["normal"]
    v = norm(view_args["view_pos"] - frag_pos)

    n_lights = scene["light_type"].shape[0]
    l0 = torch.zeros_like(frag_pos)
    last = {}
    for li in range(n_lights):
        light = {k: scene[k][li] for k in _LIGHT_KEYS}
        in_range = li < scene["n_lights"]

        l = _light_direction(light, frag_pos)
        h = norm(v + l)
        nov = dot3(n, v).abs() + 1e-5
        noh = dot3(n, h).clamp(0.0, 1.0)
        nol = dot3(n, l).clamp(0.0, 1.0)
        hol = dot3(h, l).clamp(0.0, 1.0)

        d = d_ggx(noh, mat["roughness"])
        f = f_schlick(hol, mat["f0"])
        g = g_smith_ggx_correlated(nov, nol, mat["roughness"])
        fr = (d * g)[..., None] * f
        fd = (1.0 - f) * mat["occlusion"][..., None] * mat["diffuse"] \
            * fd_lambert()
        brdf = fr + fd

        is_punctual = (light["light_type"] == 2) | (light["light_type"] == 3)
        l_unnorm = light["light_pos"] - frag_pos
        att = torch.where(is_punctual,
                          _square_falloff(l_unnorm, light["light_falloff"]),
                          1.0)
        att = torch.where(
            light["light_type"] == 3,
            att * _spot_attenuation(l, light["light_dir"],
                                    light["light_cos_inner"],
                                    light["light_cos_outer"]),
            att)
        light_result = brdf * (light["light_intensity"] * att * nol)[..., None] \
            * light["light_color"]
        shadow = torch.zeros_like(nol)
        if shadow_maps is not None and (shadow_lights is None
                                        or shadow_lights[li]):
            # directional / spot planar maps, or a point-light cube
            # (shadow_lights[li] == 6). The lookup handles ortho (w == 1)
            # and perspective (divide + cull behind the light plane) alike.
            cube = shadow_lights is not None and shadow_lights[li] == 6
            casts = ((light["light_type"] == 1)
                     | (light["light_type"] == 2)
                     | (light["light_type"] == 3)) \
                & (light["light_shadow_index"] >= 0)
            shadow = torch.where(
                casts,
                compute_shadow_directional(
                    shadow_maps, shadow_transforms,
                    light["light_shadow_index"], light["light_pos"],
                    frag_pos, n, cube=cube),
                0.0)
        l0 = l0 + torch.where(in_range, (1.0 - shadow)[..., None] * light_result,
                              0.0)
        if debug_views:
            last = {"fd": fd, "f": f, "g": g, "d": d, "fr": fr,
                    "nol": nol, "nov": nov}

    color = l0 + mat["emissive"][..., :3] * mat["emissive"][..., 3:4]
    color = color * view_args["exposure"]
    if ibl_diffuse:
        # diffuse irradiance from the captured environment; replaces the
        # flat 0.03 ambient (pbr.glsl:448) when enabled. One row gather
        # from the tiny pre-convolved cube (scene.procedural_env).
        irr = sampling.sample_cubemap_f32(scene["irradiance"], mat["normal"])
        ambient = mat["diffuse"] * irr[..., :3] * mat["occlusion"][..., None]
    else:
        ambient = 0.03 * mat["base_color"][..., :3] \
            * mat["occlusion"][..., None]
    color = color + ambient
    out = torch.cat([color, mat["base_color"][..., 3:4]], -1)
    if not debug_views:
        return out

    # debug views (pbr.glsl:410-440)
    di = view_args["debug_input"]
    de = view_args["debug_equation"]
    ones = torch.ones_like(mat["occlusion"][..., None])

    def rgba(rgb):
        return torch.cat([rgb.expand(color.shape), ones], -1)

    if last:
        out = torch.where(de == int(DebugEquation.DIFFUSE), rgba(last["fd"]), out)
        out = torch.where(de == int(DebugEquation.FRESNEL), rgba(last["f"]), out)
        out = torch.where(
            de == int(DebugEquation.GEOMETRY),
            rgba((last["g"] * 4.0 * last["nol"].abs()
                  * last["nov"].abs())[..., None]), out)
        out = torch.where(de == int(DebugEquation.DISTRIBUTION),
                          rgba(last["d"][..., None]), out)
        out = torch.where(de == int(DebugEquation.SPECULAR), rgba(last["fr"]),
                          out)

    out = torch.where(di == int(DebugInput.BASE_COLOR), mat["base_color"], out)
    out = torch.where(di == int(DebugInput.DIFFUSE_COLOR), rgba(mat["diffuse"]),
                      out)
    out = torch.where(di == int(DebugInput.NORMALS), rgba(mat["normal"]), out)
    out = torch.where(di == int(DebugInput.OCCLUSION),
                      rgba(mat["occlusion"][..., None]), out)
    out = torch.where(
        di == int(DebugInput.EMISSIVE),
        rgba(mat["emissive"][..., :3] * mat["emissive"][..., 3:4]), out)
    out = torch.where(di == int(DebugInput.METALLIC),
                      rgba(mat["metallic"][..., None]), out)
    out = torch.where(di == int(DebugInput.ROUGHNESS),
                      rgba(mat["roughness"][..., None]), out)
    return out
