"""Procedural meshes, textures and scenes.

These play the role of the reference's sample assets (the repo ships no
Sponza): geometry authored counter-clockwise viewed from outside (front-
facing under the reference's cull config, ``GraphicsPipelineCache.cpp:296-297``
+ kClip y-flip), plus a Sponza-scale procedural scene for the benchmark
(BASELINE config 3: multi-mesh, hundreds of textures, bindless materials).
"""

from __future__ import annotations

import numpy as np

from ..core import math3d
from .camera import Camera
from .lights import Light, LightType
from .materials import AlphaMode, MaterialInstanceInfo, MaterialProperties, MaterialSystem
from .scene import Scene
from ..core.aabb import AABB

# --- meshes -------------------------------------------------------------


def make_box(half=1.0):
    """Unit cube, 24 verts / 12 tris, per-face normals + uvs, CCW outside.

    returns (positions[24,3], normals[24,3], uvs[24,2], indices[36])
    """
    h = float(half)
    faces = [
        # (normal, u axis, v axis)
        ((0, 0, 1), (1, 0, 0), (0, 1, 0)),
        ((0, 0, -1), (-1, 0, 0), (0, 1, 0)),
        ((1, 0, 0), (0, 0, -1), (0, 1, 0)),
        ((-1, 0, 0), (0, 0, 1), (0, 1, 0)),
        ((0, 1, 0), (1, 0, 0), (0, 0, -1)),
        ((0, -1, 0), (1, 0, 0), (0, 0, 1)),
    ]
    pos, nrm, uv, idx = [], [], [], []
    for f, (n, u, v) in enumerate(faces):
        n, u, v = (np.array(a, np.float32) for a in (n, u, v))
        # CCW when viewed from outside (along +n)
        corners = [n * h - u * h - v * h, n * h + u * h - v * h,
                   n * h + u * h + v * h, n * h - u * h + v * h]
        base = 4 * f
        pos += corners
        nrm += [n] * 4
        uv += [np.array(t, np.float32) for t in ((0, 1), (1, 1), (1, 0), (0, 0))]
        idx += [base, base + 1, base + 2, base, base + 2, base + 3]
    return np.stack(pos), np.stack(nrm), np.stack(uv), np.array(idx, np.uint32)


def make_plane(half=1.0, normal_axis=1):
    """Quad in the plane perpendicular to ``normal_axis`` (+y default),
    facing +axis, CCW from above."""
    h = float(half)
    if normal_axis == 1:
        pos = np.array([[-h, 0, h], [h, 0, h], [h, 0, -h], [-h, 0, -h]], np.float32)
        nrm = np.tile(np.array([[0, 1, 0]], np.float32), (4, 1))
    elif normal_axis == 2:
        pos = np.array([[-h, -h, 0], [h, -h, 0], [h, h, 0], [-h, h, 0]], np.float32)
        nrm = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    else:
        raise ValueError(normal_axis)
    uv = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint32)
    return pos, nrm, uv, idx


def make_uv_sphere(radius=1.0, stacks=16, slices=32):
    """UV sphere, CCW outside."""
    vs, ns, uvs = [], [], []
    for i in range(stacks + 1):
        phi = np.pi * i / stacks
        for j in range(slices + 1):
            theta = 2 * np.pi * j / slices
            n = np.array([np.sin(phi) * np.cos(theta), np.cos(phi), np.sin(phi) * np.sin(theta)], np.float32)
            vs.append(n * radius)
            ns.append(n)
            uvs.append(np.array([j / slices, i / stacks], np.float32))
    idx = []
    for i in range(stacks):
        for j in range(slices):
            a = i * (slices + 1) + j
            b = a + slices + 1
            # CCW viewed from outside (y-up, phi from +y pole)
            idx += [a, a + 1, b, b, a + 1, b + 1]
    return np.stack(vs), np.stack(ns), np.stack(uvs), np.array(idx, np.uint32)


# --- textures -----------------------------------------------------------


def checker_texture(size=256, tiles=8, c0=(255, 255, 255), c1=(40, 40, 40)):
    y, x = np.mgrid[0:size, 0:size]
    mask = ((x * tiles // size) + (y * tiles // size)) % 2
    img = np.empty((size, size, 4), np.uint8)
    img[..., :3] = np.where(mask[..., None] == 0, np.uint8(c0), np.uint8(c1))
    img[..., 3] = 255
    return img


def noise_texture(size=256, rng=None, base=(128, 128, 128), amp=80):
    rng = rng or np.random.default_rng(0)
    img = np.clip(
        np.asarray(base, np.float32) + rng.normal(0, amp / 3, (size, size, 3)), 0, 255
    ).astype(np.uint8)
    return np.concatenate([img, np.full((size, size, 1), 255, np.uint8)], axis=-1)


def _bilerp_up(g: np.ndarray, size: int) -> np.ndarray:
    """Separable bilinear upsample of a square grid to [size,size]."""
    n = g.shape[0]
    t = np.linspace(0, n - 1, size, dtype=np.float32)
    i0 = np.floor(t).astype(np.int32)
    i1 = np.minimum(i0 + 1, n - 1)
    f = (t - i0).astype(np.float32)
    a = g[i0, :] * (1 - f)[:, None] + g[i1, :] * f[:, None]
    return a[:, i0] * (1 - f)[None, :] + a[:, i1] * f[None, :]


def _fbm(size: int, rng, octaves: int = 5, base: int = 8) -> np.ndarray:
    """Band-limited value noise in [0,1] (fBm over bilinear upsamples)."""
    out = np.zeros((size, size), np.float32)
    amp, total, n = 1.0, 0.0, base
    for _ in range(octaves):
        out += amp * _bilerp_up(rng.random((n, n)).astype(np.float32), size)
        total += amp
        amp *= 0.5
        n = min(n * 2, size)
    return out / total


def normal_map_texture(size=512, rng=None, strength=2.0):
    """Tangent-space normal map from a procedural height field — fills the
    slot the reference loader takes from assimp normal maps
    (``AssimpSceneLoader.cpp:341-347``, consumed by ``pbr.glsl:121-145``)."""
    rng = rng or np.random.default_rng(0)
    h = _fbm(size, rng)
    dx = np.roll(h, -1, 1) - np.roll(h, 1, 1)
    dy = np.roll(h, -1, 0) - np.roll(h, 1, 0)
    n = np.stack([-dx * strength, -dy * strength, np.ones_like(h)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    img = np.empty((size, size, 4), np.uint8)
    img[..., :3] = np.clip((n * 0.5 + 0.5) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    img[..., 3] = 255
    return img


def orm_texture(size=512, rng=None):
    """Occlusion/roughness/metallic packed texture (glTF convention, the
    reference's aiTextureType_METALNESS slot)."""
    rng = rng or np.random.default_rng(0)
    occ = 1.0 - 0.45 * _fbm(size, rng) ** 2
    rough = 0.25 + 0.7 * _fbm(size, rng)
    metal = (_fbm(size, rng) > 0.62).astype(np.float32)
    img = np.empty((size, size, 4), np.uint8)
    for c, v in enumerate((occ, rough, metal)):
        img[..., c] = np.clip(v * 255.0 + 0.5, 0, 255).astype(np.uint8)
    img[..., 3] = 255
    return img


def emissive_texture(size=512, rng=None, color=(255, 180, 90), glow=0.2):
    """Mostly-dark emissive map with glowing veins (``pbr.glsl`` GetEmissive
    path; premultiplied by the material emissive factor)."""
    rng = rng or np.random.default_rng(0)
    f = _fbm(size, rng)
    veins = np.clip((f - (1.0 - glow)) / max(glow, 1e-3), 0.0, 1.0) ** 2
    img = np.zeros((size, size, 4), np.uint8)
    img[..., :3] = np.clip(veins[..., None] * np.asarray(color, np.float32)
                           + 0.5, 0, 255).astype(np.uint8)
    img[..., 3] = 255
    return img


def punch_alpha_grille(img: np.ndarray, cells=8, hole=0.55) -> np.ndarray:
    """Punch a grille of transparent holes into a texture's alpha channel
    (alpha-MASK content: glTF MASK materials cut where alpha < cutoff)."""
    size = img.shape[0]
    t = ((np.arange(size, dtype=np.float32) + 0.5) / size * cells) % 1.0
    inside = (np.abs(t - 0.5)[:, None] < hole / 2) & \
             (np.abs(t - 0.5)[None, :] < hole / 2)
    out = img.copy()
    out[..., 3] = np.where(inside, 0, 255).astype(np.uint8)
    return out


def gradient_cubemap(size=64):
    """Simple sky cubemap: blue-ish up, warm horizon, dark down."""
    faces = []
    axes = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]
    uv = (np.mgrid[0:size, 0:size].astype(np.float32) + 0.5) / size * 2 - 1
    v, u = uv[0], uv[1]
    for ax in axes:
        ax = np.array(ax, np.float32)
        # direction per texel for a standard cube-face layout
        if ax[0]:
            d = np.stack([np.full_like(u, ax[0]), -v, -u * ax[0]], -1)
        elif ax[1]:
            d = np.stack([u, np.full_like(u, ax[1]), v * ax[1]], -1)
        else:
            d = np.stack([u * ax[2], -v, np.full_like(u, ax[2])], -1)
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        t = np.clip(d[..., 1] * 0.5 + 0.5, 0, 1)[..., None]
        sky = np.array([90, 140, 220], np.float32)
        horizon = np.array([210, 170, 120], np.float32)
        ground = np.array([40, 35, 30], np.float32)
        col = np.where(t > 0.5, horizon + (sky - horizon) * (t - 0.5) * 2, ground + (horizon - ground) * t * 2)
        img = np.concatenate([col, np.full((size, size, 1), 255.0)], -1)
        faces.append(np.clip(img, 0, 255).astype(np.uint8))
    return np.stack(faces)


# --- scenes -------------------------------------------------------------


def cube_scene(textured=True, width=800, height=600) -> Scene:
    """BASELINE config 1: single textured cube + one directional light."""
    sc = Scene()
    tex = sc.textures.add_texture(checker_texture(), key="checker") if textured else -1
    mat = sc.materials.create_material_instance(
        MaterialInstanceInfo(
            MaterialProperties(
                base_color=np.array([1, 1, 1, 1], np.float32),
                perceptual_roughness=0.6,
                base_color_texture=tex,
            )
        )
    )
    node = sc.tree.create_node(np.eye(4, dtype=np.float32),
                               AABB.from_points([[-1, -1, -1], [1, 1, 1]]))
    p, n, u, i = make_box()
    base = sc.meshes.add_vertices(p, n, u)
    sc.meshes.add_mesh(i + base, mat, node)
    lid = sc.lights.add_light(
        Light(
            type=LightType.DIRECTIONAL,
            color=np.ones(3, np.float32),
            direction=math3d.normalize([-0.5, -1.0, -0.3]),
            intensity=3.0,
        )
    )
    sc.create_shadow_map(lid)
    sc.textures.set_cubemap(gradient_cubemap())
    sc.camera = Camera(eye=np.array([2.5, 2.0, 2.5], np.float32),
                       look_at=np.zeros(3, np.float32),
                       up=np.array([0, 1, 0], np.float32),
                       fov_degrees=45.0, near=0.1, far=100.0,
                       width=width, height=height, exposure=1.0)
    return sc


def sponza_scene(width=1920, height=1080, seed=0,
                 n_textures=200, target_tris=260_000, tex_size=None,
                 rich=None) -> Scene:
    """Sponza-scale procedural benchmark scene: a colonnaded atrium —
    floor, walls, two rows of columns with capitals, hanging translucent
    banners, alpha-MASK grilles — with ``n_textures`` distinct textures
    and ~``target_tris`` triangles (the reference's benchmark scale,
    BASELINE.md).

    Honest Sponza-class content (the reference's full material model,
    ``MaterialSystem.h:41-51`` + ``AssimpSceneLoader.cpp:263-361``):
    every material carries a FULL texture set — base color, tangent-space
    normal map, packed occlusion/roughness/metallic, emissive — at
    ``tex_size``² (512² default; real Sponza textures are 1-2k², procedural
    128² understates atlas-locality and mip-walk cost). A subset of
    materials is alpha-MASK (grilles) and a subset BLEND (banners), and
    TWO lights cast shadows (directional sun + a spot)."""
    rng = np.random.default_rng(seed)
    sc = Scene()
    if rich is None:
        # ``rich`` = the honest Sponza-class content: full texture sets,
        # MASK grilles, the second (spot) shadow caster. Default ON for
        # golden/bench scales; micro test scenes (n_textures < 8) keep
        # the lean base-only pool so the 1-CPU suite stays bounded —
        # slot coverage is certified by the goldens + targeted tests.
        rich = n_textures >= 8
    if tex_size is None:
        # bench scale gets the honest 512² (VERDICT: atlas locality +
        # mip-walk cost scale with content resolution); small test
        # scenes stay 128² — slot COVERAGE, not resolution, is what the
        # correctness harness certifies
        tex_size = 512 if n_textures >= 100 else 128

    # texture pool: full 4-slot sets + dedicated MASK (hole-punched) base
    # textures; any remainder becomes extra base-only variants so the
    # scene holds EXACTLY n_textures distinct images
    if not rich:
        n_mask, n_sets, n_extra = 0, 0, n_textures
    else:
        n_mask = 1 if n_textures < 50 else 4
        n_sets = max(1, (n_textures - n_mask) // 4)
        n_extra = max(0, n_textures - n_mask - 4 * n_sets)

    def base_img(t):
        if t % 3 == 0:
            return checker_texture(tex_size, tiles=int(rng.integers(2, 12)),
                                   c0=tuple(rng.integers(120, 255, 3)),
                                   c1=tuple(rng.integers(0, 120, 3)))
        return noise_texture(tex_size, rng,
                             base=tuple(rng.integers(60, 200, 3)))

    sets = []       # (base, normal, orm, emissive) handles
    for s in range(n_sets):
        sets.append((
            sc.textures.add_texture(base_img(s), key=f"base{s}"),
            sc.textures.add_texture(
                normal_map_texture(tex_size, rng,
                                   strength=float(rng.uniform(1.0, 3.0))),
                key=f"nrm{s}"),
            sc.textures.add_texture(orm_texture(tex_size, rng),
                                    key=f"orm{s}"),
            sc.textures.add_texture(
                emissive_texture(tex_size, rng,
                                 color=tuple(rng.integers(120, 255, 3)),
                                 # most emissive maps are near-black; a few glow
                                 glow=0.25 if s % 7 == 3 else 0.02),
                key=f"em{s}"),
        ))
    extra_handles = [sc.textures.add_texture(base_img(e + 1),
                                             key=f"extra{e}")
                     for e in range(n_extra)]
    mask_handles = [sc.textures.add_texture(
        punch_alpha_grille(base_img(0), cells=int(rng.integers(6, 12))),
        key=f"mask{k}") for k in range(n_mask)]

    # three pools: structure (columns/walls/spheres) is opaque with the
    # full texture set; hanging banners get dedicated BLEND materials
    # (the reference's translucent set is likewise a small curated
    # subset, RenderScene.cpp:127-159); grilles get MASK materials (the
    # reference's live path draws MASK opaque — no shader discard exists
    # in Assets/Shaders — and so does ours unless config.alpha_mask)
    mats, blend_mats = [], []
    n_opaque_mats = max(n_sets * 4 + n_extra, 8)
    for t in range(n_opaque_mats):
        is_blend = t % 29 == 7
        if n_sets:
            b, n, o, e = sets[t % n_sets]
        else:
            b, n, o, e = extra_handles[t % n_extra], -1, -1, -1
        if not is_blend and n_extra and n_sets and t >= n_sets * 4:
            b = extra_handles[(t - n_sets * 4) % n_extra]  # base-only variants
        mat = sc.materials.create_material_instance(
            MaterialInstanceInfo(
                MaterialProperties(
                    base_color=np.array([1, 1, 1, 0.45 if is_blend else 1.0],
                                        np.float32),
                    emissive=(np.array([1, 1, 1, 1], np.float32) if e >= 0
                              else np.zeros(4, np.float32)),
                    perceptual_roughness=float(rng.uniform(0.2, 0.95)),
                    metallic=float(rng.uniform(0, 0.4)),
                    f0=0.04,
                    base_color_texture=b,
                    normals_texture=n,
                    orm_texture=o,
                    emissive_texture=e,
                ),
                alpha_mode=AlphaMode.BLEND if is_blend else AlphaMode.OPAQUE,
            )
        )
        (blend_mats if is_blend else mats).append(mat)
    if not blend_mats:
        blend_mats = mats[:1]
    mask_mats = [sc.materials.create_material_instance(
        MaterialInstanceInfo(
            MaterialProperties(
                base_color=np.ones(4, np.float32),
                perceptual_roughness=0.7,
                base_color_texture=mask_handles[k % len(mask_handles)],
                normals_texture=sets[k % n_sets][1],
                orm_texture=sets[k % n_sets][2],
            ),
            alpha_mode=AlphaMode.MASK, alpha_cutoff=0.5,
        )) for k in range(max(n_mask, 2))] if rich else []

    box = make_box(0.5)
    sphere_hi = make_uv_sphere(0.5, stacks=24, slices=48)   # 2304 tris
    sphere_lo = make_uv_sphere(0.5, stacks=12, slices=24)   # 576 tris
    plane = make_plane(0.5)

    tri_budget = 0

    def add(geo, transform, mat, aabb_pts):
        nonlocal tri_budget
        p, n, u, i = geo
        node = sc.tree.create_node(transform, AABB.from_points(aabb_pts))
        base = sc.meshes.add_vertices(p, n, u)
        sc.meshes.add_mesh(i + base, mat, node)
        tri_budget += len(i) // 3

    # atrium: 40m x 20m floor
    add(plane, math3d.translate([0, 0, 0]) @ math3d.scale([40, 1, 20]),
        mats[0], [[-0.5, 0, -0.5], [0.5, 0, 0.5]])
    # walls
    for (tz, rot) in ((-10, 0.0), (10, np.pi)):
        add(plane, math3d.translate([0, 4, tz]) @ math3d.rotate(rot + np.pi / 2, [1, 0, 0]) @ math3d.scale([40, 1, 8]),
            mats[1 % len(mats)], [[-0.5, -0.5, -0.05], [0.5, 0.5, 0.05]])
    # column rows: spheres on boxes (sphere tessellation carries the tri load)
    mi = 2
    cx = np.linspace(-18, 18, 13)
    while tri_budget < target_tris:
        for x in cx:
            for z in (-6.0, 6.0):
                m = mats[mi % len(mats)]
                mi += 1
                add(box, math3d.translate([x, 1.5, z]) @ math3d.scale([0.8, 3.0, 0.8]),
                    m, [[-0.5, -0.5, -0.5], [0.5, 0.5, 0.5]])
                add(sphere_hi if tri_budget < target_tris * 0.8 else sphere_lo,
                    math3d.translate([x, 3.4, z]) @ math3d.scale(0.9),
                    mats[mi % len(mats)],
                    [[-0.5, -0.5, -0.5], [0.5, 0.5, 0.5]])
                mi += 1
                if tri_budget >= target_tris:
                    break
            if tri_budget >= target_tris:
                break
    # banners (translucent) hanging across the nave, facing the camera —
    # added ONCE (inside the fill loop they'd stack coplanar duplicates)
    for k, x in enumerate(np.linspace(-15, 15, 8)):
        m = blend_mats[k % len(blend_mats)]
        add(plane, math3d.translate([x, 3.0, 0]) @ math3d.rotate(np.pi / 2, [0, 0, 1]) @ math3d.scale([2.0, 1, 3.0]),
            m, [[-0.5, -0.05, -0.5], [0.5, 0.05, 0.5]])
    # alpha-MASK grilles spanning the column gaps along both colonnades
    if mask_mats:
        for k, x in enumerate((np.linspace(-18, 18, 13)[:-1] + 1.5)):
            for j, z in enumerate((-6.0, 6.0)):
                m = mask_mats[(2 * k + j) % len(mask_mats)]
                add(plane,
                    math3d.translate([x, 1.4, z])
                    @ math3d.rotate(np.pi / 2, [1, 0, 0])
                    @ math3d.scale([2.2, 1, 2.4]),
                    m, [[-0.5, -0.5, -0.05], [0.5, 0.5, 0.05]])

    lid = sc.lights.add_light(
        Light(type=LightType.DIRECTIONAL, color=np.ones(3, np.float32),
              direction=math3d.normalize([-0.35, -1.0, 0.25]), intensity=3.5)
    )
    sc.create_shadow_map(lid)
    sc.lights.add_light(
        Light(type=LightType.POINT, color=np.array([1.0, 0.7, 0.4], np.float32),
              position=np.array([0.0, 3.0, 0.0], np.float32), intensity=40.0,
              falloff_radius=12.0)
    )
    if rich:
        # second shadow CASTER: a spot over the nave aimed down the
        # colonnade (the reference fits/renders a map per shadow-casting
        # light, RenderScene.cpp:163-181; directional-only under-exercised)
        spot = sc.lights.add_light(
            Light(type=LightType.SPOT,
                  color=np.array([0.9, 0.95, 1.0], np.float32),
                  position=np.array([8.0, 7.5, 0.0], np.float32),
                  direction=math3d.normalize([-0.4, -1.0, 0.1]),
                  intensity=280.0, falloff_radius=25.0,
                  cos_inner=float(np.cos(np.radians(22.0))),
                  cos_outer=float(np.cos(np.radians(32.0)))))
        sc.create_shadow_map(spot)
    sc.textures.set_cubemap(gradient_cubemap())
    sc.camera = Camera(eye=np.array([-16.0, 3.0, 0.0], np.float32),
                       look_at=np.array([10.0, 2.0, 0.0], np.float32),
                       up=np.array([0, 1, 0], np.float32),
                       fov_degrees=60.0, near=0.1, far=120.0,
                       width=width, height=height, exposure=1.0)
    return sc


def sponza_cube_scene(width=1920, height=1080, seed=0, n_textures=200,
                      target_tris=260_000, tex_size=None,
                      rich=None) -> Scene:
    """``sponza_scene`` whose nave lamp (the point light at (0, 3, 0), a
    12 m falloff) also casts its shadow: six perspective cube-face maps
    (+X -X +Y -Y +Z -Z) after the sun's and the spot's, so with the spot
    the maps are sun 0, spot 1, lamp 2-7. Lights, materials, textures,
    meshes and camera are ``sponza_scene``'s; the faces take the
    renderer's one ``shadow_extent`` and the fit of
    ``fitting.compute_point_shadow_transforms``."""
    sc = sponza_scene(width=width, height=height, seed=seed,
                      n_textures=n_textures, target_tris=target_tris,
                      tex_size=tex_size, rich=rich)
    lamp = next(i for i, lt in enumerate(sc.lights.lights)
                if lt.type == LightType.POINT)
    sc.create_shadow_map(lamp)
    return sc
