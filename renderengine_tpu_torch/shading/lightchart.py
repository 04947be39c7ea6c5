"""Texture-space ("light chart") shading (torch port of the JAX package's
``shading/lightchart.py``).

Every triangle gets a small chart — a regular barycentric sample grid —
packed into one atlas; quad-mate triangle pairs share one square so
bilinear filtering across their diagonal is seamless. At upload the
geometry and the full material remap are baked per chart texel; on
shadow-dirty the PCF visibility per light is baked too. Lighting is
factored as ``screen_rgb = albedo_tex * light_d + light_s``: the diffuse
half ``light_d`` is view-independent and baked, the specular half
``light_s`` is a dense per-frame pass over the chart texels. Both light
tables store one rgb9e5 word per texel in 2x2 clamp-to-edge blocks, so a
bilinear light sample is one row gather. The pre-shaded modes compose
``albedo * light_d + light_s`` in chart space and the screen pass is one
block gather.

Layout: the host-side chart layout (``build_layout`` and its helpers,
``attach_chart_layout``, ``host_alpha_is_factor``) is a numpy copy of the
JAX package's, bit for bit. The bakes, light passes, packing and screen
samplers are torch on the device; chart arrays are PLANAR ``[C,Ah,Aw]``.
u32 words (rgb9e5 texels, alpha blocks) are built in int64 and narrowed to
int32 bit views; a field is read back as ``(w >> s) & mask``, which is
exact on an arithmetic shift.

Reference: replaces the per-fragment work of
``Assets/Shaders/pbr.glsl:385-451`` + ``surface_pbr.frag``; the reference
has no analog (it shades every fragment every frame).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from ..utils.profiling import span

ATLAS_W = 1024          # fixed atlas width (texels)
MAX_R = 256             # largest chart edge sample count (square side R+1)


class ChartLayout(NamedTuple):
    corner_uv: np.ndarray   # [T,3,2] f32 per-corner atlas texel coords
    texel_tri: np.ndarray   # [Ah,Aw] i32 owning triangle (-1 = empty)
    texel_bary: np.ndarray  # [Ah,Aw,2] f32 (b1,b2) wrt the tri's corners
    height: int             # Ah (Aw is ATLAS_W)
    n_texels: int           # occupied texels (diagnostics)


# --- host-side layout (numpy) ----------------------------------------------

def _quad_mates(tri_vidx: np.ndarray, tri_mat: np.ndarray) -> np.ndarray:
    """partner[t] = t^1 when consecutive even/odd tris share exactly two
    vertex indices and a material (the standard quad split emitted by the
    loaders and procedural builders), else -1."""
    t = len(tri_vidx)
    partner = np.full(t, -1, np.int32)
    if t < 2:
        return partner
    e = (t // 2) * 2
    a = tri_vidx[0:e:2]         # [Q,3]
    b = tri_vidx[1:e:2]
    shared = (a[:, :, None] == b[:, None, :]).any(-1).sum(-1)
    ok = (shared == 2) & (tri_mat[0:e:2] == tri_mat[1:e:2])
    q = np.nonzero(ok)[0]
    partner[2 * q] = 2 * q + 1
    partner[2 * q + 1] = 2 * q
    return partner


def _footprint_px(world_tri: np.ndarray, viewproj: np.ndarray,
                  width: int, height: int) -> np.ndarray:
    """Approximate screen-space area (px^2) of each world triangle under
    the layout camera. [T,3,3] -> [T].

    Partially-behind triangles are near-clipped (Sutherland-Hodgman
    against w=eps, up to a 4-gon) and measured from the clipped polygon;
    fully-behind triangles get a small default."""
    h = np.concatenate([world_tri, np.ones_like(world_tri[..., :1])], -1)
    clip = h @ viewproj.T                       # [T,3,4]
    eps = 1e-4
    behind = clip[..., 3] <= eps                # [T,3]
    nb = behind.sum(-1)
    t = len(clip)
    idx = np.arange(t)

    def corner(base, off):
        return clip[idx, (base + off) % 3]      # [T,4]

    def isect(a, b):                            # near-plane hit on edge a->b
        wa, wb = a[:, 3:4], b[:, 3:4]
        d = np.where(np.abs(wb - wa) < 1e-20, 1e-20, wb - wa)
        return a + (eps - wa) / d * (b - a)

    # 4-vert polygon per case (duplicated verts add zero shoelace area):
    # nb=0 the tri itself; nb=1 (behind corner first) [I01, c1, c2, I20];
    # nb=2 (front corner first) [c0, I01, I20, I20]; nb=3 degenerate
    b1 = behind.argmax(-1)
    f1 = (~behind).argmax(-1)
    c0b, c1b, c2b = corner(b1, 0), corner(b1, 1), corner(b1, 2)
    c0f, c1f, c2f = corner(f1, 0), corner(f1, 1), corner(f1, 2)
    poly = np.stack([clip[:, 0], clip[:, 1], clip[:, 2], clip[:, 2]], 1)
    p1 = np.stack([isect(c0b, c1b), c1b, c2b, isect(c2b, c0b)], 1)
    i20f = isect(c2f, c0f)
    p2 = np.stack([c0f, isect(c0f, c1f), i20f, i20f], 1)
    poly = np.where((nb == 1)[:, None, None], p1, poly)
    poly = np.where((nb == 2)[:, None, None], p2, poly)

    w = np.maximum(poly[..., 3], eps)
    # clamp projected corners to a box around the viewport: off-screen
    # geometry must not dominate the texel budget
    x = np.clip(poly[..., 0] / w * (width * 0.5), -width, width)
    y = np.clip(poly[..., 1] / w * (height * 0.5), -height, height)
    xr = np.roll(x, -1, axis=1)
    yr = np.roll(y, -1, axis=1)
    area = 0.5 * np.abs((x * yr - xr * y).sum(-1))
    area = np.minimum(area, float(width * height))
    # fully outside the viewport on one side => tiny chart
    out = ((x <= -width * 0.5).all(-1) | (x >= width * 0.5).all(-1)
           | (y <= -height * 0.5).all(-1) | (y >= height * 0.5).all(-1))
    area = np.where(out, np.minimum(area, 64.0), area)
    return np.where(nb == 3, 64.0, area)


# corner-role encoding: 0 = unique (not on the shared diagonal),
# 1/2 = shared corners ranked by GLOBAL vertex id (so quad mates agree
# on which shared vertex maps to which square corner)
def _corner_roles(tri_vidx, partner):
    t = len(tri_vidx)
    pa = np.where(partner >= 0, partner, 0)
    sh = (tri_vidx[:, :, None] == tri_vidx[pa][:, None, :]).any(-1)  # [T,3]
    sh = np.where((partner >= 0)[:, None], sh,
                  np.array([False, True, True])[None])
    uniq = np.argmin(sh, axis=1)                             # [T]
    # rank shared corners by vertex id; unpaired tris rank by corner pos
    vid = np.where((partner >= 0)[:, None], tri_vidx,
                   np.arange(3)[None].repeat(t, 0))
    big = vid.max() + 1
    key = np.where(sh, vid, big)                             # unique last
    rank = key.argsort(1, kind="stable").argsort(1, kind="stable")  # [T,3]
    roles = np.where(np.arange(3)[None] == uniq[:, None], 0, rank + 1)
    return roles                                             # [T,3] in {0,1,2}


def build_layout(tri_vidx: np.ndarray, tri_mat: np.ndarray,
                 world_pos: np.ndarray, viewproj: np.ndarray,
                 width: int, height: int, density: float = 0.5,
                 budget_texels: int = 2_000_000,
                 valid: np.ndarray | None = None) -> ChartLayout:
    """Allocate + pack per-triangle charts (host-side, once per upload).

    ``density``: chart texels per screen pixel along one axis at the
    layout camera (0.5 => lighting at half screen resolution).
    ``valid``: bool [T] — padding tris get no chart.
    """
    t = len(tri_vidx)
    empty = ChartLayout(np.zeros((max(t, 1), 3, 2), np.float32),
                        np.full((8, ATLAS_W), -1, np.int32),
                        np.zeros((8, ATLAS_W, 2), np.float32), 8, 0)
    if t == 0:
        return empty
    tri_vidx = np.asarray(tri_vidx)
    world_tri = world_pos[tri_vidx]                       # [T,3,3]
    if valid is None:
        valid = np.ones(t, bool)
    degen = ~np.asarray(valid) | (np.abs(
        np.cross(world_tri[:, 1] - world_tri[:, 0],
                 world_tri[:, 2] - world_tri[:, 0])).max(-1) < 1e-12)
    if degen.all():
        return empty
    partner = _quad_mates(tri_vidx, tri_mat)
    pok = (partner >= 0) & ~degen & ~degen[np.clip(partner, 0, t - 1)]
    partner = np.where(pok, partner, -1)

    area = _footprint_px(world_tri, viewproj, width, height)
    r_raw = density * np.sqrt(2.0 * np.maximum(area, 1.0))

    def quantize(rr):
        r = np.exp2(np.ceil(np.log2(np.maximum(rr, 1.0)))).astype(np.int64)
        r = np.clip(r, 1, MAX_R)
        r = np.where(partner >= 0,
                     np.maximum(r, r[np.clip(partner, 0, t - 1)]), r)
        r[degen] = 0
        return r

    owner_mask = ~degen & ((partner < 0) | (np.arange(t) < partner))
    owners = np.nonzero(owner_mask)[0]
    scale = 1.0
    for _ in range(6):     # pow2 quantization overshoots; iterate to fit
        r = quantize(r_raw * scale)
        total = int(((r[owners] + 1) ** 2).sum())
        if total <= budget_texels:
            break
        scale *= max(0.5, 0.85 * np.sqrt(budget_texels / total))

    # shelf packing, grouped by (few, power-of-two) square sides
    sq_r = r[owners]
    bx = np.zeros(len(owners), np.int64)
    by = np.zeros(len(owners), np.int64)
    cur_y = 0
    for size in np.unique(sq_r)[::-1]:
        sel = np.nonzero(sq_r == size)[0]
        s = int(size) + 1
        per_row = max(1, ATLAS_W // s)
        k = np.arange(len(sel))
        bx[sel] = (k % per_row) * s
        by[sel] = cur_y + (k // per_row) * s
        cur_y = int(by[sel].max()) + s
    ah = max(8, -(-cur_y // 8) * 8)

    # per-tri square base + R
    sq_of = np.full(t, -1, np.int64)
    sq_of[owners] = np.arange(len(owners))
    mate_min = np.where(partner >= 0,
                        np.minimum(np.arange(t), partner), np.arange(t))
    sq_idx = sq_of[mate_min]                              # [T] (-1 degen)
    sq = np.maximum(sq_idx, 0)
    tb = np.stack([bx[sq], by[sq]], -1).astype(np.float32)  # [T,2]
    rr = r.astype(np.float32)

    # corner atlas uvs from roles: even/single tri is the lower-left
    # triangle (unique corner at (0,0)); the odd mate is upper-right
    # (unique at (R,R)); shared corners at (R,0)/(0,R) by role rank
    roles = _corner_roles(tri_vidx, partner)              # [T,3]
    is_odd = (partner >= 0) & (np.arange(t) % 2 == 1)
    # local uv per role: [even/odd][role] -> (u,v) in R units
    lut = np.array([[[0, 0], [1, 0], [0, 1]],             # even / single
                    [[1, 1], [1, 0], [0, 1]]], np.float32)
    local = lut[is_odd.astype(np.int64)[:, None], roles]  # [T,3,2]
    corner_uv = tb[:, None, :] + local * rr[:, None, None]
    corner_uv[degen | (sq_idx < 0)] = 0.0

    # texel maps, vectorized per square-size group. Owner of a texel is
    # the even tri below the diagonal (u+v <= 1), the odd mate above.
    # Closed-form bary from roles:
    #   even/single: b(role) = {U: 1-u-v, S1: u, S2: v}
    #   odd:         b(role) = {U: u+v-1, S1: 1-v, S2: 1-u}
    texel_tri = np.full((ah, ATLAS_W), -1, np.int32)
    texel_bary = np.zeros((ah, ATLAS_W, 2), np.float32)
    even_t = owners
    odd_t = np.where(partner[owners] >= 0, partner[owners], owners)
    for size in np.unique(sq_r):
        sel = np.nonzero(sq_r == size)[0]
        s = int(size) + 1
        rs = max(int(size), 1)
        gi, gj = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
        u = (gj / rs).astype(np.float32)                  # [S,S]
        v = (gi / rs).astype(np.float32)
        lower = (u + v) <= 1.0 + 1e-6
        te = even_t[sel]                                   # [K]
        to = odd_t[sel]
        own = np.where(lower[None], te[:, None, None], to[:, None, None])
        # candidate bary grids per role: [3,S,S]
        ge = np.stack([1.0 - u - v, u, v])
        go = np.stack([u + v - 1.0, 1.0 - v, 1.0 - u])
        b_ev = np.stack([ge[roles[te, 1]], ge[roles[te, 2]]], -1)  # [K,S,S,2]
        b_od = np.stack([go[roles[to, 1]], go[roles[to, 2]]], -1)
        # unpaired squares: the upper half belongs to the SAME tri with
        # extrapolated (even-formula) barycentrics, not the odd mapping
        use_ev = lower[None, :, :] | (te == to)[:, None, None]
        bary = np.where(use_ev[..., None], b_ev, b_od)
        ys = (by[sel][:, None, None] + gi[None]).astype(np.int64)
        xs = (bx[sel][:, None, None] + gj[None]).astype(np.int64)
        texel_tri[ys, xs] = own.astype(np.int32)
        texel_bary[ys, xs] = bary
    return ChartLayout(corner_uv.astype(np.float32), texel_tri, texel_bary,
                       ah, total)


def attach_chart_layout(dev: dict, viewproj: np.ndarray, config) -> None:
    """Host-side chart layout (once per upload): adds the texel->tri maps
    and per-corner chart uvs to the host upload dict."""
    lay = build_layout(
        np.asarray(dev["tri_vidx"]), np.asarray(dev["tri_material"]),
        np.asarray(dev["world_pos"]), viewproj,
        config.width, config.height, config.chart_density,
        config.chart_budget,
        valid=np.arange(len(dev["tri_vidx"])) < int(dev["n_tris"]))
    dev["chart_tri"] = lay.texel_tri
    dev["chart_bary"] = lay.texel_bary
    dev["chart_corner"] = lay.corner_uv
    cb = np.zeros((len(dev["blend_tri_vidx"]), 3, 2), np.float32)
    no, nbl = int(dev["n_opaque"]), int(dev["n_blend"])
    cb[:nbl] = lay.corner_uv[no:no + nbl]
    dev["chart_corner_blend"] = cb


def host_alpha_is_factor(dev: dict, textures) -> bool:
    """True iff no base texture modulates alpha (every used base texture's
    alpha channel is constant full), so the baked per-texel alpha equals
    the material base-color-factor alpha exactly. Conservative: any
    alpha-varying base texture on a material referenced by geometry, or a
    texture that cannot be inspected, returns False."""
    base = np.asarray(dev.get("mat_tex_base", np.empty(0, np.int32)))
    used = np.zeros(base.shape[0], bool)
    for key in ("tri_material", "blend_tri_material", "mask_tri_material"):
        if key in dev and len(np.asarray(dev[key])):
            m = np.asarray(dev[key])
            used[np.clip(m, 0, base.shape[0] - 1)] = True
    pend = getattr(textures, "_textures", None)
    handles = np.unique(base[used & (base >= 0)] if used.any()
                        else base[base >= 0])
    for h in handles:
        if pend is None or h < 0 or h >= len(pend):
            return False
        img = pend[int(h)].image
        full = 65535 if img.dtype == np.uint16 else 255
        if img.shape[-1] >= 4 and (img[..., 3] != full).any():
            return False
    return True


# --- device bakes (torch) ---------------------------------------------------

def _u32_view(w: torch.Tensor) -> torch.Tensor:
    """An int64 tensor of u32 values -> the words as int32 bit views
    (two's complement narrowing keeps bit 31)."""
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def _sum3(a, b, c):
    return (a + b) + c


def bake_geometry(scene) -> dict:
    """Per-texel world pos / shading inputs from the texel->tri maps."""
    tri = scene["chart_tri"]                       # [Ah,Aw] i32
    bary = scene["chart_bary"]                     # [Ah,Aw,2]
    safe = tri.clamp_min(0).long()
    trow = scene["tri_packed"][safe]               # [Ah,Aw,8]
    vidx = trow[..., 0:3].long()
    vattr = torch.cat([scene["world_pos"], scene["world_normal"],
                       scene["uvs"]], -1)          # [V,8]
    corners = vattr[vidx]                          # [Ah,Aw,3,8]
    b1 = bary[..., 0:1]
    b2 = bary[..., 1:2]
    b0 = 1.0 - b1 - b2
    interp = _sum3(corners[..., 0, :] * b0, corners[..., 1, :] * b1,
                   corners[..., 2, :] * b2)        # [Ah,Aw,8]
    n = interp[..., 3:6]
    nn = torch.sqrt(_sum3(n[..., 0] * n[..., 0], n[..., 1] * n[..., 1],
                          n[..., 2] * n[..., 2]))
    n = n / nn.clamp_min(1e-20)[..., None]
    return {
        "pos": interp[..., 0:3],
        "normal": n,
        "uv": interp[..., 6:8],
        "mat_id": trow[..., 3],
        "live": tri >= 0,
    }


def bake_material(scene, geo, slots_used, max_aniso=1,
                  ibl_diffuse: bool = False):
    """Full ``remap_material`` per chart texel, reduced to the factored
    per-texel constants the light pass needs. Returns (chart_mat
    [Ah,Aw,16] f32, the mapped normal [Ah,Aw,3], the remap dict):
      0:3  diffuse_nt  base-color FACTOR rgb x (1-metal)   (texture on screen)
      3:6  f0          (metal tint uses chart-res base color)
      6    roughness (remapped)      7  occlusion
      8:11 emissive premultiplied    11 base-color factor alpha
      12:15 ambient_d (x albedo_tex on screen)   15 live
    """
    from . import pbr, sampling

    # covered=live: dead chart texels hold zero uv — mask them out of the
    # quad derivatives like uncovered screen pixels
    mat = pbr.remap_material(scene, geo["mat_id"], geo["pos"], geo["uv"],
                             geo["normal"], slots_used, max_aniso,
                             covered=geo["live"])
    factor = sampling.table_lookup(scene["mat_all"], geo["mat_id"])[..., 0:4]
    one_m = (1.0 - mat["metallic"])[..., None]
    diffuse_nt = factor[..., :3] * one_m
    if ibl_diffuse:
        irr = sampling.sample_cubemap_f32(scene["irradiance"], mat["normal"])
        amb = diffuse_nt * irr[..., :3] * mat["occlusion"][..., None]
    else:
        amb = 0.03 * factor[..., :3] * mat["occlusion"][..., None]
    live = geo["live"][..., None].to(torch.float32)
    out = torch.cat([
        diffuse_nt,
        mat["f0"],
        mat["roughness"][..., None],
        mat["occlusion"][..., None],
        mat["emissive"][..., :3] * mat["emissive"][..., 3:4],
        factor[..., 3:4],
        amb,
        live,
    ], -1)
    return out * live, mat["normal"], mat


def bake_visibility(scene, geo, shadow_maps, shadow_transforms,
                    shadow_lights) -> torch.Tensor:
    """(1 - shadow) per texel per light — PCF runs here, once per
    shadow-dirty, never per frame. PLANAR [NL,Ah,Aw] f32; ``geo`` may
    carry pos/normal channel-minor or planar [3,Ah,Aw] (the stored form)."""
    from .shadow import compute_shadow_directional

    pos, normal = geo["pos"], geo["normal"]
    if pos.shape[0] == 3 and pos.dim() == 3:       # stored planar form
        pos = torch.movedim(pos, 0, -1)
        normal = torch.movedim(normal, 0, -1)
    nl = scene["light_type"].shape[0]
    vis = []
    for li in range(nl):
        if shadow_maps is None or not shadow_lights[li]:
            vis.append(torch.ones(geo["mat_id"].shape, dtype=torch.float32,
                                  device=pos.device))
            continue
        cube = shadow_lights[li] == 6
        # a point light's six-face select over every texel: its own span
        with span("frame.vis_cube") if cube else contextlib.nullcontext():
            s = compute_shadow_directional(
                shadow_maps, shadow_transforms,
                scene["light_shadow_index"][li], scene["light_pos"][li], pos,
                normal, penumbra_tiles=0, cube=cube)
            vis.append(1.0 - s)
    return torch.stack(vis, 0)


def _light_common(scene, li: int, pos, n, chart_vis):
    """Per-light direction + shared scalar weight (intensity x attenuation
    x nol x visibility) x color — the factor both lobes multiply
    (pbr.glsl:385-409). PLANAR: ``pos``/``n`` [3,Ah,Aw], ``chart_vis``
    [NL,Ah,Aw]. Returns ((lx,ly,lz), (cr,cg,cb)) planes."""
    lt = scene["light_type"][li]
    lc = scene["light_color"][li]
    lp = scene["light_pos"][li]
    ldir = scene["light_dir"][li]
    in_range = (li < scene["n_lights"]).to(torch.float32)

    px_, py_, pz_ = pos[0], pos[1], pos[2]
    nx_, ny_, nz_ = n[0], n[1], n[2]
    # direction: punctual = normalize(light_pos - pos); directional =
    # -normalize(light_dir)
    ux = lp[0] - px_
    uy = lp[1] - py_
    uz = lp[2] - pz_
    d2 = ux * ux + uy * uy + uz * uz
    inv = 1.0 / torch.sqrt(d2).clamp_min(1e-20)
    dn = -ldir / torch.sqrt((ldir * ldir).sum()).clamp_min(1e-20)
    is_dir = lt == 1
    lx = torch.where(is_dir, dn[0], ux * inv)
    ly = torch.where(is_dir, dn[1], uy * inv)
    lz = torch.where(is_dir, dn[2], uz * inv)
    nol = (nx_ * lx + ny_ * ly + nz_ * lz).clamp(0.0, 1.0)
    # square falloff for punctual lights
    inv_r = 1.0 / scene["light_falloff"][li].clamp_min(0.083)
    factor = d2 * (inv_r * inv_r)
    smooth = (1.0 - factor * factor).clamp_min(0.0)
    sq = (smooth * smooth) / d2.clamp_min(1e-4)
    is_punctual = (lt == 2) | (lt == 3)
    att = torch.where(is_punctual, sq, 1.0)
    # spot cone
    ci = scene["light_cos_inner"][li]
    co = scene["light_cos_outer"][li]
    spot_scale = 1.0 / (ci - co).clamp_min(1e-4)
    cd = dn[0] * lx + dn[1] * ly + dn[2] * lz
    satt = (cd * spot_scale - co * spot_scale).clamp(0.0, 1.0)
    att = torch.where(lt == 3, att * (satt * satt), att)
    cw = (scene["light_intensity"][li] * att * nol) * chart_vis[li] \
        * in_range
    return (lx, ly, lz), (cw * lc[0], cw * lc[1], cw * lc[2])


def chart_light_static(scene, chart_pos, chart_normal, chart_mat, chart_vis,
                       exposure):
    """The STATIC (view-independent) half of the factored lighting: summed
    diffuse from every light x baked PCF visibility, exposure folded in,
    plus the ambient term. PLANAR: inputs [3/16/NL,Ah,Aw], output
    [3,Ah,Aw]. The diffuse lobe's view-dependent (1 - F(hol)) factor is
    taken at normal incidence, (1 - f0). ``exposure``: a Python float or
    a 0-d float32 tensor (what a captured program reads, as JAX traces
    it), which give the same bytes: a float scales in float32 too."""
    from . import pbr

    k = pbr.fd_lambert()
    occ = chart_mat[7]
    fd = [(1.0 - chart_mat[3 + c]) * occ * chart_mat[c] * k
          for c in range(3)]
    ld = [torch.zeros_like(chart_pos[0]) for _ in range(3)]
    for li in range(scene["light_type"].shape[0]):
        _, common = _light_common(scene, li, chart_pos, chart_normal,
                                  chart_vis)
        for c in range(3):
            ld[c] = ld[c] + fd[c] * common[c]
    return torch.stack([ld[c] * exposure + chart_mat[12 + c]
                        for c in range(3)])                 # + ambient_d


def chart_light_spec(scene, chart_pos, chart_normal, chart_mat, chart_vis,
                     view_args):
    """The per-frame (view-dependent) half: summed Filament specular +
    emissive, exposed. Dense over chart texels, zero gathers. PLANAR:
    inputs [3/16/NL,Ah,Aw], output [3,Ah,Aw]."""
    from . import pbr

    nx_, ny_, nz_ = chart_normal[0], chart_normal[1], chart_normal[2]
    rough = chart_mat[6]
    vp = view_args["view_pos"]
    vx = vp[0] - chart_pos[0]
    vy = vp[1] - chart_pos[1]
    vz = vp[2] - chart_pos[2]
    vinv = 1.0 / torch.sqrt(vx * vx + vy * vy + vz * vz).clamp_min(1e-20)
    vx, vy, vz = vx * vinv, vy * vinv, vz * vinv
    nov = (nx_ * vx + ny_ * vy + nz_ * vz).abs() + 1e-5
    ls = [torch.zeros_like(rough) for _ in range(3)]
    for li in range(scene["light_type"].shape[0]):
        (lx, ly, lz), common = _light_common(scene, li, chart_pos,
                                             chart_normal, chart_vis)
        hx, hy, hz = vx + lx, vy + ly, vz + lz
        hinv = 1.0 / torch.sqrt(hx * hx + hy * hy + hz * hz).clamp_min(1e-20)
        hx, hy, hz = hx * hinv, hy * hinv, hz * hinv
        noh = (nx_ * hx + ny_ * hy + nz_ * hz).clamp(0.0, 1.0)
        nol = (nx_ * lx + ny_ * ly + nz_ * lz).clamp(0.0, 1.0)
        hol = (hx * lx + hy * ly + hz * lz).clamp(0.0, 1.0)
        d = pbr.d_ggx(noh, rough)
        s5 = torch.pow(1.0 - hol, 5.0)
        g = pbr.g_smith_ggx_correlated(nov, nol, rough)
        dg = d * g
        for c in range(3):
            f0c = chart_mat[3 + c]
            ls[c] = ls[c] + dg * (f0c + (1.0 - f0c) * s5) * common[c]
    e = view_args["exposure"]
    return torch.stack([(ls[c] + chart_mat[8 + c]) * e for c in range(3)])


# --- rgb9e5 shared-exponent HDR packing (one u32 per texel) -------------
# 9-bit mantissas r|g|b and a 5-bit shared exponent (the
# GL_EXT_texture_shared_exponent layout); max relative step 2^-9 of the
# dominant channel.

_E_BIAS = 24   # value = mant * 2^(e - _E_BIAS); e in [0,31]


def _rgb9e5_exponent(m: torch.Tensor):
    """Shared exponent e (int64) and 2^(_E_BIAS - e) (f32) of the channel
    max ``m`` (normal, positive: floor(log2 m) from its exponent bits)."""
    k = (m.view(torch.int32) >> 23).to(torch.int64) - 127
    e = (k + 16).clamp(0, 31)                      # mant of max in [256,511]
    inv_scale = ((127 + _E_BIAS - e) << 23).to(torch.int32).view(
        torch.float32)
    return e, inv_scale


def rgb9e5_encode_planes(r, g, b) -> torch.Tensor:
    """Three [...] f32 planes (>= 0, HDR) -> [...] rgb9e5 words (int32 bit
    views of the u32s)."""
    r = r.clamp(0.0, 65408.0)
    g = g.clamp(0.0, 65408.0)
    b = b.clamp(0.0, 65408.0)
    m = torch.maximum(torch.maximum(r, g), b).clamp_min(3e-5)
    e, inv_scale = _rgb9e5_exponent(m)

    def mant(c):
        return torch.round(c * inv_scale).clamp(0, 511).to(torch.int64)

    return _u32_view(mant(r) | (mant(g) << 9) | (mant(b) << 18) | (e << 27))


def rgb9e5_encode(rgb: torch.Tensor) -> torch.Tensor:
    """[...,3] f32 (>=0, HDR) -> [...] rgb9e5 words (int32 bit views);
    bit-identical to the planar form."""
    return rgb9e5_encode_planes(rgb[..., 0], rgb[..., 1], rgb[..., 2])


def rgb9e5_decode_planes(raw: torch.Tensor):
    """[...] rgb9e5 words (int32 bit views) -> (r, g, b) f32 planes."""
    e = (raw >> 27) & 31
    scale = ((127 - _E_BIAS + e) << 23).view(torch.float32)
    return ((raw & 511).to(torch.float32) * scale,
            ((raw >> 9) & 511).to(torch.float32) * scale,
            ((raw >> 18) & 511).to(torch.float32) * scale)


def rgb9e5_decode(raw: torch.Tensor) -> torch.Tensor:
    """[...] rgb9e5 words -> [...,3] f32."""
    return torch.stack(rgb9e5_decode_planes(raw), -1)


def _shift_blocks(p: torch.Tensor) -> list:
    """2x2 clamp-to-edge neighborhood planes [p, p+x, p+y, p+xy]."""
    px = torch.cat([p[:, 1:], p[:, -1:]], 1)
    py = torch.cat([p[1:], p[-1:]], 0)
    pxy = torch.cat([px[1:], px[-1:]], 0)
    return [p, px, py, pxy]


def pack_rgbe_planes(atlas_p: torch.Tensor) -> torch.Tensor:
    """PLANAR [3,Ah,Aw] f32 -> [4,Ah,Aw] rgb9e5 neighborhood planes."""
    p = rgb9e5_encode_planes(atlas_p[0], atlas_p[1], atlas_p[2])
    return torch.stack(_shift_blocks(p))


def pack_rgbe_blocks(atlas_p: torch.Tensor) -> torch.Tensor:
    """PLANAR [3,Ah,Aw] f32 -> [Ah*Aw,4] 2x2 clamp-to-edge rgb9e5 blocks:
    one 16-byte row gather fetches all four bilinear corners."""
    planes = pack_rgbe_planes(atlas_p)                      # [4,Ah,Aw]
    return planes.reshape(4, -1).t().contiguous()           # [Ah*Aw,4]


def merge_light_planes(ld_planes: torch.Tensor,
                       ls_planes: torch.Tensor) -> torch.Tensor:
    """[4,Ah,Aw] x2 (static diffuse, per-frame specular) -> [Ah*Aw,8]:
    ONE 32-byte row gather fetches both light tables' bilinear
    footprints."""
    both = torch.cat([ld_planes, ls_planes], 0)             # [8,Ah,Aw]
    return both.reshape(8, -1).t().contiguous()             # [Ah*Aw,8]


def _cell(ux, uy, ah: int, aw: int):
    """Texel cell of a chart uv (samples sit at integer positions):
    (flat row index, fx, fy)."""
    x = ux.clamp(0.0, aw - 1.001)
    y = uy.clamp(0.0, ah - 1.001)
    ix = torch.floor(x).to(torch.int64)
    iy = torch.floor(y).to(torch.int64)
    return iy * aw + ix, x - ix.to(torch.float32), y - iy.to(torch.float32)


def _blend_words(words, off: int, ws):
    """Bilinear mix of the four rgb9e5 corner words ``words[off:off+4]``
    with weights ``ws``: (r, g, b) planes."""
    acc = None
    for ci in range(4):
        r_, g_, b_ = rgb9e5_decode_planes(words[off + ci])
        t = (r_ * ws[ci], g_ * ws[ci], b_ * ws[ci])
        acc = t if acc is None else tuple(a + v for a, v in zip(acc, t))
    return acc


def sample_rgbe_blocks(blocks: torch.Tensor, uv: torch.Tensor,
                       ah: int, aw: int) -> torch.Tensor:
    """Bilinear light-table sample: uv [...,2] in texel coords. Returns
    [...,3] f32. ONE 16-byte gather."""
    flat, fx, fy = _cell(uv[..., 0], uv[..., 1], ah, aw)
    words = torch.movedim(blocks[flat], -1, 0)             # [4, ...]
    corners = [rgb9e5_decode_planes(words[k]) for k in range(4)]
    chans = []
    for c in range(3):
        top = corners[0][c] * (1 - fx) + corners[1][c] * fx
        bot = corners[2][c] * (1 - fx) + corners[3][c] * fx
        chans.append(top * (1 - fy) + bot * fy)
    return torch.stack(chans, -1)


def _slot_planes(p6):
    """``pbr._slot`` from 6 channel-leading planes (cols 16..21 of
    mat_all: page,x,y,w,h,n_mips for texture slot 0)."""
    return {
        "page": p6[0].to(torch.int32),
        "x": p6[1].to(torch.int32),
        "y": p6[2].to(torch.int32),
        "w": p6[3].to(torch.int32),
        "h": p6[4].to(torch.int32),
        "n_mips": p6[5].to(torch.int32),
        "valid": p6[0] >= 0,
    }


def sample_light8(light8: torch.Tensor, chart_uv: torch.Tensor,
                  ah: int, aw: int):
    """Bilinear sample of BOTH light tables from the merged [Ah*Aw,8] row
    table (``merge_light_planes``): ONE 32-byte gather per index. Returns
    ([...,3] ld, [...,3] ls)."""
    flat, fx, fy = _cell(chart_uv[..., 0], chart_uv[..., 1], ah, aw)
    words = torch.movedim(light8[flat], -1, 0)              # [8, ...]
    ws = ((1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy)
    return (torch.stack(_blend_words(words, 0, ws), -1),
            torch.stack(_blend_words(words, 4, ws), -1))


def _half_cell(chart_uv, ah: int, aw: int, y0: int):
    """The even-pixel half grid of a [H,W,2] chart uv (its rows start at
    the slice's first GLOBAL even row) and its texel cells and bilinear
    weights."""
    cux, cuy = chart_uv[..., 0], chart_uv[..., 1]
    r0 = y0 % 2
    hux = cux[r0::2, ::2]                            # [Hh,Wh]
    huy = cuy[r0::2, ::2]
    flat, fxh, fyh = _cell(hux, huy, ah, aw)
    ws = ((1 - fxh) * (1 - fyh), fxh * (1 - fyh),
          (1 - fxh) * fyh, fxh * fyh)
    return cux, cuy, r0, hux, huy, flat, ws


def sample_light_halfres(light8, chart_uv, ah: int, aw: int,
                         y0: int = 0, sim_radius: float = 3.0):
    """Light-table sampling on the HALF-resolution pixel grid + a
    chart-uv-guided upsample back to full res: ONE merged-table gather at
    the even-pixel half grid (4x fewer indices than full res), then a
    bilinear upsample where a corner's chart uv is within ``sim_radius``
    texels of the pixel's own (same surface), falling back toward the
    nearest corner at silhouettes. ``chart_uv`` [H,W,2]; ``y0``: global
    row of this image slice (the half grid follows the GLOBAL even rows).
    Returns ([H,W,3] ld, [H,W,3] ls)."""
    cux, cuy, r0, hux, huy, flat, ws = _half_cell(chart_uv, ah, aw, y0)
    words = torch.movedim(light8[flat], -1, 0)        # [8,Hh,Wh]
    ld3 = _blend_words(words, 0, ws)
    ls3 = _blend_words(words, 4, ws)
    out = _guided_upsample([*ld3, *ls3], hux, huy, cux, cuy, r0, sim_radius)
    return torch.stack(out[0:3], -1), torch.stack(out[3:6], -1)


def _guided_upsample(channels, hux, huy, cux, cuy, r0, sim_radius=3.0):
    """Chart-uv-guided 2x upsample shared by the half-res samplers:
    ``channels`` are half-grid [Hh,Wh] planes sampled at chart uv
    (hux,huy); (cux,cuy) are the full-res per-pixel chart uvs. Returns
    full-res planes (same count). All plane math — zero gathers."""
    h, w = cux.shape

    def up(x_):                      # h[i,j] -> full[y,x] = h[y//2,x//2]
        f = x_.repeat_interleave(2, 0).repeat_interleave(2, 1)
        if r0:
            f = torch.cat([f[:1], f[:-1]], 0)
        return f[:h, :w]

    def cshift(u):                   # full-res equivalent of the half +x
        ex = u[:, -1:]
        return torch.cat([u[:, 2:], ex, ex], 1)

    def rshift(u):                   # full-res equivalent of the half +y
        ey = u[-1:]
        if r0:
            # up() clamps full row 0 to half row 0 (phase shift), so the
            # +y neighbor of row 0 is half row 1 = upsampled row 3
            return torch.cat([u[3:4], u[3:], ey, ey], 0)
        return torch.cat([u[2:], ey, ey], 0)

    def shifts(p):
        """[p, p+x, p+y, p+xy] corner planes at FULL res: one upsample,
        then the half-grid neighbor shifts become full-res shifts by 2."""
        u = up(p)
        sx = cshift(u)
        return [u, sx, rshift(u), rshift(sx)]

    hl = list(channels) + [hux, huy]
    corners = [shifts(p) for p in hl]                 # [C+2][4] planes
    nc = len(channels)

    dev = cux.device
    yy = (torch.arange(h, dtype=torch.int64, device=dev) - r0) % 2
    xx = torch.arange(w, dtype=torch.int64, device=dev) % 2
    fy = (0.5 * yy.to(torch.float32))[:, None]
    fx = (0.5 * xx.to(torch.float32))[None, :]

    dists = [(corners[nc][ci] - cux).abs() + (corners[nc + 1][ci] - cuy).abs()
             for ci in range(4)]
    wts = [(1 - fy) * (1 - fx) * (dists[0] < sim_radius),
           (1 - fy) * fx * (dists[1] < sim_radius),
           fy * (1 - fx) * (dists[2] < sim_radius),
           fy * fx * (dists[3] < sim_radius)]
    tot = wts[0] + wts[1] + wts[2] + wts[3]
    inv_tot = 1.0 / tot.clamp_min(1e-6)
    # silhouette fallback: every corner rejected -> the corner whose chart
    # uv is closest to the pixel's own
    bd = torch.minimum(torch.minimum(dists[0], dists[1]),
                       torch.minimum(dists[2], dists[3]))
    degenerate = tot <= 1e-6
    bsel = [dists[0] == bd]
    taken = bsel[0]
    for ci in (1, 2, 3):
        s = (dists[ci] == bd) & ~taken
        bsel.append(s)
        taken = taken | s
    out = []
    for c in range(nc):
        acc = (corners[c][0] * wts[0] + corners[c][1] * wts[1]
               + corners[c][2] * wts[2] + corners[c][3] * wts[3]) * inv_tot
        best = (corners[c][0] * bsel[0] + corners[c][1] * bsel[1]
                + corners[c][2] * bsel[2] + corners[c][3] * bsel[3])
        out.append(torch.where(degenerate, best, acc))
    return out


def _alpha_mix(ar, ws):
    """Bilinear alpha from a 2x2 u8 alpha-block word."""
    a00 = (ar & 255).to(torch.float32)
    a10 = ((ar >> 8) & 255).to(torch.float32)
    a01 = ((ar >> 16) & 255).to(torch.float32)
    a11 = ((ar >> 24) & 255).to(torch.float32)
    return (a00 * ws[0] + a10 * ws[1] + a01 * ws[2] + a11 * ws[3]) / 255.0


def tss_shade_pre_halfres(rgb_blocks, a_blocks, chart_uv, ah: int, aw: int,
                          y0: int = 0, need_alpha: bool = True,
                          sim_radius: float = 3.0):
    """``tss_shade_pre`` for DENSE full-screen passes: gather the
    pre-shaded rgb block table on the half-pixel grid and
    chart-uv-guided-upsample. Alpha (when not a material factor) rides the
    same half grid. Returns [H,W,4]."""
    cux, cuy, r0, hux, huy, flat, ws = _half_cell(chart_uv, ah, aw, y0)
    words = torch.movedim(rgb_blocks[flat], -1, 0)    # [4,Hh,Wh]
    channels = list(_blend_words(words, 0, ws))
    if need_alpha:
        channels.append(_alpha_mix(a_blocks[flat], ws))
    out = _guided_upsample(channels, hux, huy, cux, cuy, r0, sim_radius)
    a = out[3] if need_alpha else torch.ones_like(out[0])
    return torch.stack([out[0], out[1], out[2], a], -1)


def _albedo_tap(scene, uv, mat_id, slots_used, max_aniso, dither, covered,
                like):
    """The screen pass's base-color tap: (linear albedo [...,3], texture
    alpha x base-color-factor alpha [...])."""
    from . import pbr, sampling
    from .srgb import srgb_to_linear

    pl7 = sampling.table_lookup_planar(scene["mat_all"], mat_id,
                                       (3, 16, 17, 18, 19, 20, 21))
    factor_a = pl7[0]
    if slots_used[0]:
        tb = _slot_planes(pl7[1:])
        duv_dx, duv_dy = sampling.quad_derivs(uv, covered)
        tap = pbr._sample_slot(scene, tb, uv, duv_dx, duv_dy,
                               torch.ones(4, device=uv.device), max_aniso,
                               dither)
        alb = torch.where(tb["valid"][..., None],
                          srgb_to_linear(tap[..., :3]), 1.0)
        ta = torch.where(tb["valid"], tap[..., 3], 1.0)
    else:
        alb = torch.ones_like(like)
        ta = torch.ones_like(like[..., 0])
    return alb, ta * factor_a


def tss_shade_halfres_plain(scene, chart_uv, uv, mat_id, light8,
                            ah: int, aw: int, y0: int = 0,
                            slots_used=(True, True, True, True),
                            max_aniso=1, dither: bool = False, covered=None):
    """``tss_shade`` with the half-res light path (dense [H,W] passes
    only), in plain PyTorch: the CPU path of ``tss_shade_halfres`` and its
    kernel's comparison on the card."""
    light_d, light_s = sample_light_halfres(light8, chart_uv, ah, aw, y0)
    alb, a = _albedo_tap(scene, uv, mat_id, slots_used, max_aniso, dither,
                         covered, light_d)
    return torch.cat([alb * light_d + light_s, a[..., None]], -1)


def _check_shade_args(scene, chart_uv, uv, mat_id, light8, ah: int, aw: int,
                      y0: int, covered) -> None:
    """Dtypes, shapes and device of ``tss_shade_halfres``'s arguments; on
    a CUDA device also the tables' contiguity and alignment."""
    def need(ok, msg):
        if not ok:
            raise ValueError(msg)

    need(chart_uv.dtype == torch.float32 and chart_uv.dim() == 3
         and chart_uv.shape[2] == 2, "chart_uv must be [H, W, 2] float32")
    h, w = chart_uv.shape[:2]
    need(h >= 2 and w >= 2, "the pass takes at least 2 x 2 pixels")
    need(y0 % 2 == 0 or h % 2 == 0,
         "a plane starting on an odd row must have an even height")
    need(uv is not None and uv.dtype == torch.float32
         and tuple(uv.shape) == (h, w, 2), "uv must be [H, W, 2] float32")
    need(mat_id.dtype == torch.int32 and tuple(mat_id.shape) == (h, w),
         "mat_id must be [H, W] int32")
    need(covered is None or (covered.dtype == torch.bool
                             and tuple(covered.shape) == (h, w)),
         "covered must be [H, W] bool")
    need(ah >= 2 and aw >= 2, "the chart atlas must be at least 2x2")
    need(light8.dtype == torch.int32
         and tuple(light8.shape) == (ah * aw, 8),
         "light8 must be [ah * aw, 8] int32")
    atlas, mat_all = scene["atlas"], scene["mat_all"]
    need(atlas.dtype == torch.int32 and atlas.dim() == 4
         and atlas.shape[3] in (4, 8),
         "the atlas must be [pages, ah, aw, 4 or 8] int32")
    need(scene["mip_x"].dtype == torch.int32
         and scene["mip_y"].dtype == torch.int32,
         "the mip tables must be int32")
    need(mat_all.dtype == torch.float16 and mat_all.dim() == 2
         and mat_all.shape[1] >= 22, "mat_all must be [n, >= 22] float16")
    tabs = [light8, atlas, scene["mip_x"], scene["mip_y"], mat_all]
    planes = [chart_uv, uv, mat_id] + ([] if covered is None else [covered])
    need(all(t.device == chart_uv.device for t in tabs + planes),
         "the pass's tensors must share chart_uv's device")
    if chart_uv.device.type == "cuda":
        need(all(t.is_contiguous() for t in tabs),
             "the pass's tables must be contiguous")
        need(light8.data_ptr() % 16 == 0 and atlas.data_ptr() % 16 == 0,
             "light8 and the atlas must start on 16 bytes")


def tss_shade_halfres(scene, chart_uv, uv, mat_id, light8,
                      ah: int, aw: int, y0: int = 0,
                      slots_used=(True, True, True, True),
                      max_aniso=1, dither: bool = False, covered=None):
    """The factored screen pass's kernel (``csrc/tss_shade.cu``): the
    arguments of ``tss_shade_halfres_plain``, checked on every device. CPU
    tensors take the plain version. On a CUDA device ONE launch on the
    current stream samples the light on the half grid, upsamples it and
    takes the albedo tap of every pixel, reading the planes in place
    through their strides; it never synchronises and returns a new
    [H, W, 4] float32 plane."""
    _check_shade_args(scene, chart_uv, uv, mat_id, light8, ah, aw, y0,
                      covered)
    if chart_uv.device.type == "cpu":
        return tss_shade_halfres_plain(scene, chart_uv, uv, mat_id, light8,
                                       ah, aw, y0, slots_used, max_aniso,
                                       dither, covered)
    from ..raster import cuda_raster
    from .sampling import aniso_spec
    h, w = chart_uv.shape[:2]
    atlas = scene["atlas"]
    out = torch.empty((h, w, 4), dtype=torch.float32,
                      device=chart_uv.device)
    cov = (None, 0, 0) if covered is None else (covered.data_ptr(),
                                                *covered.stride())
    lib = cuda_raster._library()
    with torch.cuda.device(chart_uv.device):
        rc = lib.tss_shade_launch(
            atlas.data_ptr(), atlas.shape[0] * atlas.shape[1] * atlas.shape[2],
            atlas.shape[1], atlas.shape[2], atlas.shape[3],
            scene["mip_x"].data_ptr(), scene["mip_y"].data_ptr(),
            light8.data_ptr(), aw, aw - 1.001, ah - 1.001,
            chart_uv.data_ptr(), *chart_uv.stride(), uv.data_ptr(),
            *uv.stride(), mat_id.data_ptr(), *mat_id.stride(), *cov,
            scene["mat_all"].data_ptr(), scene["mat_all"].shape[1],
            scene["mat_all"].shape[0], h, w, y0 % 2,
            int(bool(slots_used[0])), aniso_spec(max_aniso).max_taps,
            int(bool(dither)), out.data_ptr(),
            torch.cuda.current_stream(chart_uv.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tss_shade launch failed: CUDA error {rc}")
    cuda_raster.launch_counts["tss_shade"] += 1
    return out


def bake_albedo(scene, geo, slots_used=(True, True, True, True),
                max_aniso=1, tap=None, tap_valid=None):
    """Per-chart-texel base-color texture tap for the PRE-SHADED modes:
    linear rgb + alpha (texture alpha x the material base-color-factor
    alpha). ``tap``/``tap_valid``: the raw base tap of the material bake,
    reused instead of a second sampling pass."""
    from . import pbr, sampling
    from .srgb import srgb_to_linear

    uv = geo["uv"]
    row = sampling.table_lookup(scene["mat_all"], geo["mat_id"])
    factor_a = row[..., 3]
    if slots_used[0]:
        if tap is None:
            tb = pbr._slot(row[..., 16:], 0)
            duv_dx, duv_dy = sampling.quad_derivs(uv, geo["live"])
            tap = pbr._sample_slot(scene, tb, uv, duv_dx, duv_dy,
                                   torch.ones(4, device=uv.device),
                                   max_aniso)
            tap_valid = tb["valid"]
        alb = torch.where(tap_valid[..., None],
                          srgb_to_linear(tap[..., :3]), 1.0)
        ta = torch.where(tap_valid, tap[..., 3], 1.0)
    else:
        alb = torch.ones(uv.shape[:2] + (3,), dtype=torch.float32,
                         device=uv.device)
        ta = torch.ones(uv.shape[:2], dtype=torch.float32, device=uv.device)
    live = geo["live"][..., None].to(torch.float32)
    return alb * live, ta * factor_a * live[..., 0]


def pack_alpha_blocks(a: torch.Tensor) -> torch.Tensor:
    """[Ah,Aw] f32 alpha -> [Ah*Aw] 2x2 clamp-to-edge u8 blocks (a00 |
    a10<<8 | a01<<16 | a11<<24, int32 bit views): one 4-byte gather per
    bilinear alpha sample."""
    q = torch.round(a * 255.0).clamp(0, 255).to(torch.int64)
    qx = torch.cat([q[:, 1:], q[:, -1:]], 1)
    qy = torch.cat([q[1:], q[-1:]], 0)
    qxy = torch.cat([qx[1:], qx[-1:]], 0)
    return _u32_view(q | (qx << 8) | (qy << 16) | (qxy << 24)).reshape(-1)


def tss_shade_pre(rgb_blocks, a_blocks, chart_uv, ah: int, aw: int,
                  need_alpha: bool = False):
    """The PRE-SHADED screen pass: ONE 16-byte rgb9e5-block gather per
    pixel (+ one 4-byte alpha-block gather when the pass blends).
    Returns [...,4]."""
    flat, fx, fy = _cell(chart_uv[..., 0], chart_uv[..., 1], ah, aw)
    words = torch.movedim(rgb_blocks[flat], -1, 0)
    corners = [rgb9e5_decode_planes(words[k]) for k in range(4)]
    rgb = torch.stack(
        [(corners[0][c] * (1 - fx) + corners[1][c] * fx) * (1 - fy)
         + (corners[2][c] * (1 - fx) + corners[3][c] * fx) * fy
         for c in range(3)], -1)
    if need_alpha:
        ar = a_blocks[flat]
        a00 = (ar & 255).to(torch.float32)
        a10 = ((ar >> 8) & 255).to(torch.float32)
        a01 = ((ar >> 16) & 255).to(torch.float32)
        a11 = ((ar >> 24) & 255).to(torch.float32)
        a = ((a00 * (1 - fx) + a10 * fx) * (1 - fy)
             + (a01 * (1 - fx) + a11 * fx) * fy) / 255.0
    else:
        a = torch.ones_like(rgb[..., 0])
    return torch.cat([rgb, a[..., None]], -1)


def factor_alpha(rgba: torch.Tensor, mat_all: torch.Tensor,
                 mat_id: torch.Tensor) -> torch.Tensor:
    """``rgba`` [...,4] with its alpha replaced by the material's
    base-colour factor alpha (``mat_all`` column 3): the pre-shaded peels'
    alpha where the bake found the texture alpha to be that factor."""
    from . import sampling

    fa = sampling.table_lookup_planar(mat_all, mat_id, (3,))[0]
    return torch.cat([rgba[..., :3], fa[..., None]], -1)


def tss_peel_composite_plain(rgb, rgb_blocks, a_blocks, layers, ah: int,
                             aw: int, mat_all=None) -> torch.Tensor:
    """The pre-shaded peel pass of a texture-space frame in plain PyTorch:
    every pixel of each layer shaded by ``tss_shade_pre`` (alpha from
    ``a_blocks``, or with ``mat_all`` the material factor alpha), then the
    layers composited into ``rgb`` [H,W,3] back to front, as
    ``graph/frame.py`` composites its peels. ``layers``: [(tri_id [H,W]
    int32, chart_uv [H,W,2] f32, mat_id [H,W] int32)], nearest first.
    Writes ``rgb`` in place and returns it."""
    out = rgb
    for tri_id, chart_uv, mat_id in reversed(layers):
        c = tss_shade_pre(rgb_blocks, a_blocks, chart_uv, ah, aw,
                          need_alpha=mat_all is None)
        if mat_all is not None:
            c = factor_alpha(c, mat_all, mat_id)
        a = c[..., 3].clamp(0.0, 1.0) * (tri_id >= 0)
        out = out * (1.0 - a[..., None]) + c[..., :3] * a[..., None]
    return rgb.copy_(out)


def _check_peel_args(rgb, rgb_blocks, a_blocks, layers, ah: int, aw: int,
                     mat_all) -> None:
    """Dtypes, shapes, contiguity and device of ``tss_peel_composite``'s
    arguments."""
    def need(ok, msg):
        if not ok:
            raise ValueError(msg)

    need(rgb.dtype == torch.float32 and rgb.dim() == 3
         and rgb.shape[2] == 3, "rgb must be [H, W, 3] float32")
    h, w = rgb.shape[:2]
    need(ah >= 2 and aw >= 2, "the chart atlas must be at least 2x2")
    need(rgb_blocks.dtype == torch.int32
         and tuple(rgb_blocks.shape) == (ah * aw, 4),
         "rgb_blocks must be [ah * aw, 4] int32")
    tabs = [rgb, rgb_blocks]
    if mat_all is None:
        need(a_blocks is not None and a_blocks.dtype == torch.int32
             and tuple(a_blocks.shape) == (ah * aw,),
             "a_blocks must be [ah * aw] int32")
        tabs.append(a_blocks)
    else:
        need(mat_all.dtype == torch.float16 and mat_all.dim() == 2
             and mat_all.shape[1] > 3,
             "mat_all must be [n, > 3] float16")
        tabs.append(mat_all)
    need(len(layers) == 2, "the peel pass takes two layers")
    for tri_id, chart_uv, mat_id in layers:
        need(tri_id.dtype == torch.int32 and mat_id.dtype == torch.int32
             and tuple(tri_id.shape) == (h, w)
             and tuple(mat_id.shape) == (h, w),
             "tri_id and mat_id must be [H, W] int32")
        need(chart_uv.dtype == torch.float32
             and tuple(chart_uv.shape) == (h, w, 2),
             "chart_uv must be [H, W, 2] float32")
        tabs += [tri_id, chart_uv, mat_id]
    need(all(t.is_contiguous() for t in tabs),
         "the peel pass's tensors must be contiguous")
    need(all(t.device == rgb.device for t in tabs),
         "the peel pass's tensors must share rgb's device")
    need(rgb_blocks.data_ptr() % 16 == 0,
         "rgb_blocks must start on 16 bytes")


def tss_peel_composite(rgb, rgb_blocks, a_blocks, layers, ah: int, aw: int,
                       mat_all=None) -> torch.Tensor:
    """The pre-shaded peel pass's kernel (``csrc/tss_peel.cu``): the
    arguments of ``tss_peel_composite_plain``, checked on every device.
    CPU tensors take the plain version. On a CUDA device ONE launch on the
    current stream shades every covered pixel of both layers and
    composites them into ``rgb`` in place (no tile budget: nothing is
    dropped); it never synchronises and returns ``rgb``."""
    _check_peel_args(rgb, rgb_blocks, a_blocks, layers, ah, aw, mat_all)
    if rgb.device.type == "cpu":
        return tss_peel_composite_plain(rgb, rgb_blocks, a_blocks, layers,
                                        ah, aw, mat_all)
    from ..raster import cuda_raster
    planes = [t.data_ptr() for layer in layers for t in layer]
    lib = cuda_raster._library()
    with torch.cuda.device(rgb.device):
        rc = lib.tss_peel_launch(
            rgb.data_ptr(), rgb_blocks.data_ptr(),
            None if mat_all is not None else a_blocks.data_ptr(),
            None if mat_all is None else mat_all.data_ptr(),
            0 if mat_all is None else mat_all.shape[1], *planes,
            rgb.shape[0], rgb.shape[1], aw, aw - 1.001, ah - 1.001,
            torch.cuda.current_stream(rgb.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tss_peel launch failed: CUDA error {rc}")
    cuda_raster.launch_counts["tss_peel"] += 1
    return rgb


# --- the upload-time bake and the static light tables ---------------------
# Plain functions. The upload bake runs eagerly once per upload (the JAX
# package jits it); the renderers capture the visibility bake and the
# static tables into CUDA graphs (``graph.frame.tss_bakes``).

def bake_all(scene, config, slots_used, pre_any: bool,
             device_alpha_check: bool = False):
    """The upload-time bake (geometry, material, and for the pre-shaded
    modes the albedo + alpha blocks). Returns (new scene keys, extras):
    chart arrays are stored PLANAR ([C,Ah,Aw]); ``extras["alpha_dev"]``
    (with ``device_alpha_check``) is the largest gap between the baked
    alpha and the material factor alpha."""
    nl = int(scene["light_type"].shape[0])
    geo = bake_geometry(scene)
    cm, nrm, mraw = bake_material(scene, geo, slots_used=slots_used,
                                  max_aniso=config.aniso(),
                                  ibl_diffuse=config.ibl_diffuse)
    baked = {"chart_pos": torch.movedim(geo["pos"], -1, 0).contiguous(),
             "chart_normal": torch.movedim(nrm, -1, 0).contiguous(),
             "chart_mat": torch.movedim(cm, -1, 0).contiguous(),
             "chart_vis": torch.ones((nl,) + cm.shape[:2],
                                     dtype=torch.float32, device=cm.device)}
    extras = {}
    if pre_any:
        # pre-shaded modes: bake the base-color tap per texel too; the
        # static product albedo * diffuse light is kept as a raw f32 atlas
        alb, ta = bake_albedo(scene, geo, slots_used=slots_used,
                              max_aniso=config.aniso(),
                              tap=mraw.get("base_tex_raw"),
                              tap_valid=mraw.get("base_valid"))
        baked["chart_albedo"] = torch.movedim(alb, -1, 0).contiguous()
        baked["chart_a"] = pack_alpha_blocks(ta)
        if device_alpha_check:
            fa = scene["mat_all"][geo["mat_id"].long(), 3].to(torch.float32)
            live = geo["live"].to(torch.float32)
            extras = {"alpha_dev": (ta - fa * live).abs().max()}
    return baked, extras


def static_tables(scene, config, exposure) -> dict:
    """Static light tables, refreshed on shadow-dirty / exposure change:
    the factored screen pass reads ``chart_ld`` (rgb9e5 neighborhood
    planes, merged per frame with the specular planes); pre-shaded passes
    read ``chart_base`` (raw planar f32, re-packed with the per-frame
    specular). ``tss_preshaded_blend`` needs both. ``exposure``: a float
    or a 0-d float32 tensor (``chart_light_static``)."""
    pre_any = config.tss_preshaded or config.tss_preshaded_blend
    static = chart_light_static(scene, scene["chart_pos"],
                                scene["chart_normal"], scene["chart_mat"],
                                scene["chart_vis"], exposure)
    out = {}
    if not config.tss_preshaded:
        out["chart_ld"] = pack_rgbe_planes(static)          # [4,Ah,Aw]
    if pre_any:
        out["chart_base"] = scene["chart_albedo"] * static
    return out


def setup_scene_tss(scene_dev: dict, config, slots_used, exposure: float,
                    alpha_is_factor: bool | None = None):
    """Device bakes for texture-space shading (once per upload). Returns
    ``(updates, alpha_is_factor)``: ``updates`` holds the new scene keys
    (chart_pos/normal/mat/vis, chart_albedo/chart_a when pre-shading, and
    the initial ``static_tables``); ``alpha_is_factor`` says that no base
    texture modulates alpha, so pre-shaded peels can read it from the
    material table (checked on the device when the caller passes None)."""
    pre_any = config.tss_preshaded or config.tss_preshaded_blend
    up, extras = bake_all(scene_dev, config, slots_used, pre_any,
                          device_alpha_check=pre_any
                          and alpha_is_factor is None)
    if not pre_any:
        alpha_is_factor = False
    elif alpha_is_factor is None:
        alpha_is_factor = bool(float(extras["alpha_dev"]) < 0.5 / 255.0)
    sc2 = dict(scene_dev)
    sc2.update(up)
    up.update(static_tables(sc2, config, exposure))
    return up, alpha_is_factor


def tss_attribute_planes(setup, corner_uv, uv_corners) -> torch.Tensor:
    """The 4 raster attributes of the TSS screen pass (chart_u, chart_v,
    uv_u, uv_v) as rational planes [T,12] from the static per-corner chart
    uvs [T,3,2] and texture uvs [T,3,2] (``corner_attr[..., 6:8]``)."""
    from ..raster.cuda_raster import attribute_planes

    corners = torch.cat([corner_uv.to(torch.float32), uv_corners], -1)
    return attribute_planes(setup, corners)


def resolve_tss(scene, coef, g, height, width, y0=0, full_height=None,
                tri_table: str = "tri_packed",
                corner_table: str = "chart_corner"):
    """Resolve for TSS mode from barycentrics (the ``reference`` backend):
    chart uv + material uv + mat id (mirrors ``frame.resolve_attributes``)."""
    from ..raster import reference_raster as rref

    tri_id = g.tri_id
    if g.bary is not None:
        b01 = g.bary
        bary = torch.cat([b01, 1.0 - b01[..., :1] - b01[..., 1:2]], -1)
    else:
        bary, _ = rref.barycentrics_at(coef, tri_id, height, width, y0,
                                       full_height)
    safe = tri_id.clamp_min(0).long()
    trow = scene[tri_table][safe]
    vidx = trow[..., 0:3].long()
    b = bary[..., None]
    uvc = scene["uvs"][vidx]
    uv = _sum3(uvc[..., 0, :] * b[..., 0, :], uvc[..., 1, :] * b[..., 1, :],
               uvc[..., 2, :] * b[..., 2, :])
    cuv = scene[corner_table][safe]
    chart = _sum3(cuv[..., 0, :] * b[..., 0, :], cuv[..., 1, :] * b[..., 1, :],
                  cuv[..., 2, :] * b[..., 2, :])
    return {"chart_uv": chart, "uv": uv, "mat_id": trow[..., 3],
            "covered": tri_id >= 0}


def tss_shade(scene, chart_uv, uv, mat_id, light8, ah: int, aw: int,
              slots_used=(True, True, True, True), max_aniso=1,
              dither: bool = False, covered=None):
    """The TSS screen pass: one albedo tap (full-res texture detail) + ONE
    32-byte merged light-table gather. rgb = albedo * ld + ls; alpha =
    texture alpha x the material's base-color factor alpha."""
    light_d, light_s = sample_light8(light8, chart_uv, ah, aw)
    alb, a = _albedo_tap(scene, uv, mat_id, slots_used, max_aniso, dither,
                         covered, light_d)
    return torch.cat([alb * light_d + light_s, a[..., None]], -1)
