"""RenderScene — the per-frame orchestrator owning all scene systems.

Reference: ``Source/Runtime/Renderer/RenderScene.{h,cpp}`` owns
MeshAllocator, SceneTree, LightSystem, ShadowSystem, CameraViewSystem,
MaterialSystem, Grid, Skybox; splits meshes into opaque (sorted by material
then node, ``RenderScene.cpp:105-125``) and translucent (re-sorted
back-to-front per frame, ``:127-159``).

``upload()`` produces one flat dict of numpy arrays (the "DeviceScene");
``graph.frame.scene_to_device`` moves it onto a torch device. The opaque/translucent
split becomes two triangle index ranges; back-to-front ordering of
translucent triangles is handled by depth peeling in the frame graph
(``graph/frame.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.aabb import AABB
from .camera import Camera
from .lights import LightSystem
from .materials import MaterialSystem, AlphaMode, material_handle_index
from .mesh import MeshAllocator
from .scene_tree import SceneTree
from .textures import TextureCache


@dataclass
class Scene:
    meshes: MeshAllocator = field(default_factory=MeshAllocator)
    tree: SceneTree = field(default_factory=SceneTree)
    lights: LightSystem = field(default_factory=LightSystem)
    materials: MaterialSystem = field(default_factory=MaterialSystem)
    textures: TextureCache = field(default_factory=TextureCache)
    camera: Camera = field(default_factory=Camera)
    n_shadow_maps: int = 0

    def create_shadow_map(self, light_id: int) -> int:
        """Reference ``ShadowSystem::CreateShadowMap`` (``ShadowSystem.cpp:229-238``):
        one depth map per directional light. Beyond the reference, spot
        lights get one perspective map and point lights six cube-face
        maps (consecutive indices, +X -X +Y -Y +Z -Z)."""
        from .lights import LightType

        shadow_id = self.n_shadow_maps
        is_point = self.lights.lights[light_id].type == LightType.POINT
        self.n_shadow_maps += 6 if is_point else 1
        self.lights.set_light_shadow_id(light_id, shadow_id)
        return shadow_id

    def scene_aabb(self) -> AABB:
        return self.tree.scene_aabb()

    def node_world_aabbs(self) -> tuple[list[AABB], list[np.ndarray]]:
        return self.tree.local_aabbs, self.tree.transforms

    # --- device upload -------------------------------------------------

    def upload(self, pad_tris_to: int = 256, chart_subdiv=None) -> dict:
        """Build the flat device dict. Triangle arrays are split into an
        opaque range [0, n_opaque) and a translucent range [n_opaque, n_tris),
        then padded to a multiple of ``pad_tris_to`` with degenerate
        triangles (all-zero vertices -> zero area -> never rastered), so
        scene edits of similar size keep the same shapes.

        ``chart_subdiv``: texture-space configs pass
        ``dict(viewproj=..., width=..., height=..., density=...)`` —
        triangles whose chart would exceed ``lightchart.MAX_R`` texels
        per edge (huge floors/walls) are subdivided on a power-of-two
        barycentric grid so every chart fits MAX_R at the requested
        density (see ``_chart_subdivide``)."""
        pos, nrm, uv, vert_node, tri_vidx, tri_mat_handle, tri_node = self.meshes.build_arrays()
        transforms, normal_mats = self.tree.build_arrays()

        # opaque/mask/translucent split by material alpha mode. Order is
        # opaque | MASK | blend, so "n_opaque" (opaque+MASK — the reference's
        # live-path semantics: MASK draws opaque, GraphicsPipelineCache.cpp)
        # and "n_opaque_strict" (true opaque only, used when the cutoff
        # pass is enabled) are both contiguous prefixes.
        tri_mat = np.array([material_handle_index(int(h)) for h in tri_mat_handle], np.int32)
        mat_arrays = self.materials.build_arrays()
        alpha_modes = mat_arrays["mat_alpha_mode"]
        tri_mode = alpha_modes[tri_mat] if len(tri_mat) else np.zeros(0, np.int32)
        # AlphaMode values already sort as opaque(0) < mask(1) < blend(2)
        order = np.argsort(tri_mode, kind="stable")
        tri_vidx = tri_vidx[order]
        tri_mat = tri_mat[order]
        tri_node = tri_node[order]
        tri_mode = tri_mode[order]
        if chart_subdiv is not None and len(tri_vidx):
            (pos, nrm, uv, vert_node, tri_vidx, tri_mat, tri_node,
             tri_mode) = _chart_subdivide(
                pos, nrm, uv, vert_node, tri_vidx, tri_mat, tri_node,
                tri_mode, transforms, **chart_subdiv)
        n_strict = int((tri_mode == int(AlphaMode.OPAQUE)).sum())
        n_mask = int((tri_mode == int(AlphaMode.MASK)).sum())
        n_opaque = n_strict + n_mask
        n_tris = len(tri_vidx)

        # pad with degenerate triangles
        pad = (-n_tris) % pad_tris_to if n_tris else pad_tris_to
        if pad:
            tri_vidx = np.concatenate([tri_vidx, np.zeros((pad, 3), np.int32)])
            tri_mat = np.concatenate([tri_mat, np.zeros(pad, np.int32)])
            tri_node = np.concatenate([tri_node, np.zeros(pad, np.int32)])
        if len(pos) == 0:
            pos = np.zeros((1, 3), np.float32)
            nrm = np.zeros((1, 3), np.float32)
            uv = np.zeros((1, 2), np.float32)
            vert_node = np.zeros(1, np.int32)
        if len(transforms) == 0:
            transforms = np.eye(4, dtype=np.float32)[None]
            normal_mats = np.eye(3, dtype=np.float32)[None]

        # world-space vertex cache: static scenes pay the node-transform
        # gather once at upload (the shadow-dirty-flag philosophy applied
        # to the vertex stage); per-frame vertex work is just clip = VP @ world
        tfv = transforms[np.clip(vert_node, 0, len(transforms) - 1)]
        wh = (tfv[:, :3, :3] * pos[:, None, :]).sum(-1) + tfv[:, :3, 3]
        ww = (tfv[:, 3, :3] * pos).sum(-1) + tfv[:, 3, 3]
        world_pos = (wh / ww[:, None]).astype(np.float32)
        nmv = normal_mats[np.clip(vert_node, 0, len(normal_mats) - 1)]
        wn = (nmv * nrm[:, None, :]).sum(-1)
        wn_n = np.linalg.norm(wn, axis=-1, keepdims=True)
        world_normal = (wn / np.maximum(wn_n, 1e-20)).astype(np.float32)

        # separate translucent ("blend") draw list: the peel passes bin and
        # raster only these (usually few) triangles
        n_blend = n_tris - n_opaque
        bpad = (-n_blend) % 64 if n_blend else 64
        blend_vidx = np.concatenate([tri_vidx[n_opaque:n_tris],
                                     np.zeros((bpad, 3), np.int32)])
        blend_mat = np.concatenate([tri_mat[n_opaque:n_tris], np.zeros(bpad, np.int32)])
        blend_node = np.concatenate([tri_node[n_opaque:n_tris], np.zeros(bpad, np.int32)])

        # dedicated MASK draw list (used only when RenderConfig.alpha_mask
        # enables the glTF cutoff test; otherwise these tris stay in the
        # n_opaque prefix and draw opaque, matching the reference)
        mpad = (-n_mask) % 64 if n_mask else 64
        mask_vidx = np.concatenate([tri_vidx[n_strict:n_opaque],
                                    np.zeros((mpad, 3), np.int32)])
        mask_mat = np.concatenate([tri_mat[n_strict:n_opaque], np.zeros(mpad, np.int32)])
        mask_node = np.concatenate([tri_node[n_strict:n_opaque], np.zeros(mpad, np.int32)])

        device = {
            "positions": pos,
            "normals": nrm,
            "uvs": uv,
            "vert_node": vert_node,
            "world_pos": world_pos,
            "world_normal": world_normal,
            "tri_vidx": tri_vidx,
            "tri_material": tri_mat,
            "tri_node": tri_node,
            "n_tris": np.int32(n_tris),
            "n_opaque": np.int32(n_opaque),
            "blend_tri_vidx": blend_vidx,
            "blend_tri_material": blend_mat,
            "blend_tri_node": blend_node,
            "n_blend": np.int32(n_blend),
            "mask_tri_vidx": mask_vidx,
            "mask_tri_material": mask_mat,
            "mask_tri_node": mask_node,
            "n_mask": np.int32(n_mask),
            "n_opaque_strict": np.int32(n_strict),
            "transforms": transforms,
            "normal_mats": normal_mats,
        }
        device.update(mat_arrays)
        device.update(self.lights.build_arrays())
        device.update(self.textures.build_atlas())
        device.update(_pack_rows(device))
        return device


def _chart_subdivide(pos, nrm, uv, vert_node, tri_vidx, tri_mat, tri_node,
                     tri_mode, transforms, viewproj, width, height,
                     density, max_k: int = 8, r_split: int = 128,
                     rounds: int = 3):
    """Subdivide triangles whose texture-space chart would exceed
    ``r_split`` texels per edge (huge floors/walls: charts are squares
    with uniform texel density, so one triangle can only ever get
    MAX_R^2 texels no matter its screen footprint, and a triangle
    spanning a large depth range spreads them evenly while the
    perspective-magnified near field needs most of them — pre-shaded
    albedo and lighting blur near the camera without this).

    Each oversized triangle is split on a power-of-two K x K barycentric
    grid into K^2 sub-triangles, ITERATIVELY (``rounds``): a cell's next
    footprint is measured from its own screen area, so near-field cells
    keep splitting while far cells stop — texel density adapts to
    perspective at no budget cost (cell areas sum to the parent's, and
    chart texels scale with area). Properties the chart packer and
    raster rely on:

    - K is a power of two and shared across quad mates, so grid weights
      c/K are exact binary fractions: shared-edge vertices interpolate
      BITWISE identically from both sides (addition is commutative and
      the zero-weight corner contributes an exact 0) — no cracks.
    - Up/down sub-triangle pairs are emitted adjacently at even indices
      with the parent's material, so ``lightchart._quad_mates`` pairs
      them into shared squares (seamless bilinear across the cell
      diagonal); segment starts are even-aligned with degenerate padding.
    - Sub-triangle winding preserves the parent's (CCW sub-grids for
      up-triangles, the down-triangle order re-wound to positive
      barycentric orientation), so culling is unchanged.
    - Original corner vertices are reused; interior/edge vertices are
      appended with object-space attrs interpolated linearly (exact for
      uv; normals renormalize at the world bake like any vertex).

    Neighbor parents subdivided at different K leave T-junctions on the
    shared edge; interpolated points sit within 1 ulp of the parent edge,
    so raster coverage is unaffected at pixel precision."""
    from ..shading.lightchart import MAX_R, _footprint_px, _quad_mates

    thr = min(r_split, MAX_R)
    for _ in range(rounds):
        args = _chart_subdivide_once(
            pos, nrm, uv, vert_node, tri_vidx, tri_mat, tri_node, tri_mode,
            transforms, viewproj, width, height, density, max_k, thr,
            _footprint_px, _quad_mates)
        if args is None:
            break
        (pos, nrm, uv, vert_node, tri_vidx, tri_mat, tri_node,
         tri_mode) = args
    return pos, nrm, uv, vert_node, tri_vidx, tri_mat, tri_node, tri_mode


def _chart_subdivide_once(pos, nrm, uv, vert_node, tri_vidx, tri_mat,
                          tri_node, tri_mode, transforms, viewproj, width,
                          height, density, max_k, thr,
                          _footprint_px, _quad_mates):
    """One subdivision round (see ``_chart_subdivide``); returns the
    rebuilt arrays, or None when nothing exceeds ``thr``."""
    t = len(tri_vidx)
    if len(transforms) == 0:
        transforms = np.eye(4, dtype=np.float32)[None]
    tfv = transforms[np.clip(vert_node, 0, len(transforms) - 1)]
    wh = (tfv[:, :3, :3] * pos[:, None, :]).sum(-1) + tfv[:, :3, 3]
    ww = (tfv[:, 3, :3] * pos).sum(-1) + tfv[:, 3, 3]
    world = (wh / np.maximum(np.abs(ww), 1e-20)[:, None]
             * np.sign(ww)[:, None]).astype(np.float32)
    area = _footprint_px(world[tri_vidx], viewproj, width, height)
    r_raw = density * np.sqrt(2.0 * np.maximum(area, 1.0))
    k = np.ones(t, np.int64)
    over = r_raw > thr
    if not over.any():
        return None
    k[over] = np.exp2(np.ceil(np.log2(r_raw[over] / thr))).astype(np.int64)
    k = np.minimum(k, max_k)
    partner = _quad_mates(tri_vidx, tri_mat)
    pa = np.where(partner >= 0, partner, np.arange(t))
    k = np.maximum(k, k[pa])          # mates share K: crack-free diagonal

    new_pos = [np.asarray(pos, np.float32)]
    new_nrm = [np.asarray(nrm, np.float32)]
    new_uv = [np.asarray(uv, np.float32)]
    new_node = [np.asarray(vert_node, np.int32)]
    vnext = len(pos)

    def grid_verts(i):
        """(K+1)-row barycentric vertex grid for tri i; returns index map
        g[(r,c)] -> global vertex id (corners reuse the originals)."""
        nonlocal vnext
        K = int(k[i])
        v0, v1, v2 = (int(v) for v in tri_vidx[i])
        a0, a1, a2 = pos[v0], pos[v1], pos[v2]
        n0, n1, n2 = nrm[v0], nrm[v1], nrm[v2]
        u0, u1, u2 = uv[v0], uv[v1], uv[v2]
        g = {}
        app_p, app_n, app_u = [], [], []
        for r in range(K + 1):
            for c in range(K + 1 - r):
                if (r, c) == (0, 0):
                    g[(r, c)] = v0
                elif (r, c) == (0, K):
                    g[(r, c)] = v1
                elif (r, c) == (K, 0):
                    g[(r, c)] = v2
                else:
                    s = np.float32(c / K)     # exact: K is a power of two
                    tt = np.float32(r / K)
                    w0 = np.float32(1.0) - s - tt
                    app_p.append(w0 * a0 + s * a1 + tt * a2)
                    app_n.append(w0 * n0 + s * n1 + tt * n2)
                    app_u.append(w0 * u0 + s * u1 + tt * u2)
                    g[(r, c)] = vnext
                    vnext += 1
        if app_p:
            new_pos.append(np.asarray(app_p, np.float32))
            new_nrm.append(np.asarray(app_n, np.float32))
            new_uv.append(np.asarray(app_u, np.float32))
            new_node.append(np.full(len(app_p), tri_node[i], np.int32))
        return g, int(k[i])

    def subdivide(i):
        """Sub-triangles of tri i as (pairs, singles) lists of vidx
        triples. Up-tri (r,c): rows CCW in barycentric space (parent
        winding); its paired down-tri shares two vertices."""
        g, K = grid_verts(i)
        pairs, singles = [], []
        for r in range(K):
            for c in range(K - r):
                up = (g[(r, c)], g[(r, c + 1)], g[(r + 1, c)])
                if c < K - r - 1:
                    down = (g[(r, c + 1)], g[(r + 1, c + 1)], g[(r + 1, c)])
                    pairs.append((up, down))
                else:
                    singles.append(up)
        return pairs, singles

    o_vidx, o_mat, o_node, o_mode = [], [], [], []

    def emit(vidx3, mat, node, mode):
        o_vidx.append(vidx3)
        o_mat.append(mat)
        o_node.append(node)
        o_mode.append(mode)

    for mode in sorted(set(int(m) for m in tri_mode)):
        seg = np.nonzero(tri_mode == mode)[0]
        if len(seg) == 0:
            continue
        if len(o_vidx) % 2:             # even-align so pairs stay mated
            emit((0, 0, 0), int(tri_mat[seg[0]]), 0, mode)
        kept_pairs, kept_singles = [], []
        sub_pairs, sub_singles = [], []
        i = 0
        while i < len(seg):
            ti = int(seg[i])
            is_pair = (partner[ti] == ti + 1 and i + 1 < len(seg)
                       and int(seg[i + 1]) == ti + 1)
            units = (ti, ti + 1) if is_pair else (ti,)
            if int(k[ti]) == 1:
                (kept_pairs if is_pair else kept_singles).append(units)
            else:
                for u in units:
                    p, s = subdivide(u)
                    sub_pairs.extend((pp, int(tri_mat[u]), int(tri_node[u]))
                                     for pp in p)
                    sub_singles.extend((ss, int(tri_mat[u]), int(tri_node[u]))
                                       for ss in s)
            i += len(units)
        for units in kept_pairs:
            for u in units:
                emit(tuple(int(v) for v in tri_vidx[u]), int(tri_mat[u]),
                     int(tri_node[u]), mode)
        for (up, down), mat, node in sub_pairs:
            emit(up, mat, node, mode)
            emit(down, mat, node, mode)
        for units in kept_singles:
            for u in units:
                emit(tuple(int(v) for v in tri_vidx[u]), int(tri_mat[u]),
                     int(tri_node[u]), mode)
        for ss, mat, node in sub_singles:
            emit(ss, mat, node, mode)

    return (np.concatenate(new_pos), np.concatenate(new_nrm),
            np.concatenate(new_uv), np.concatenate(new_node),
            np.asarray(o_vidx, np.int32), np.asarray(o_mat, np.int32),
            np.asarray(o_node, np.int32), np.asarray(o_mode, np.int32))


def _pack_rows(device: dict) -> dict:
    """Gather-friendly packed row tables: per-pixel lookups fetch ONE
    wide row instead of many scalars (the layout is shared with the JAX
    package, whose upload dict this one equals):

    - ``tri_packed`` i32 [T,8]: v0 v1 v2 material node pad3
    - ``mat_core`` f32 [M,16]: baseColor4 emissive4 f0 metallic roughness
      ao alphaMode alphaCutoff pad2
    - ``mat_tex`` f32 [M,24]: 4 slots x (page x y w h n_mips); page=-1
      means no texture (reference 'handle >= MAX_DESCRIPTOR_COUNT',
      pbr.glsl:102). Values are small ints — exact in f32.
    """
    t = len(device["tri_vidx"])
    tri_packed = np.zeros((t, 8), np.int32)
    tri_packed[:, 0:3] = device["tri_vidx"]
    tri_packed[:, 3] = device["tri_material"]
    tri_packed[:, 4] = device["tri_node"]
    tb = len(device["blend_tri_vidx"])
    blend_tri_packed = np.zeros((tb, 8), np.int32)
    blend_tri_packed[:, 0:3] = device["blend_tri_vidx"]
    blend_tri_packed[:, 3] = device["blend_tri_material"]
    blend_tri_packed[:, 4] = device["blend_tri_node"]
    tm = len(device["mask_tri_vidx"])
    mask_tri_packed = np.zeros((tm, 8), np.int32)
    mask_tri_packed[:, 0:3] = device["mask_tri_vidx"]
    mask_tri_packed[:, 3] = device["mask_tri_material"]
    mask_tri_packed[:, 4] = device["mask_tri_node"]

    m = len(device["mat_base_color"])
    mat_core = np.zeros((m, 16), np.float32)
    mat_core[:, 0:4] = device["mat_base_color"]
    mat_core[:, 4:8] = device["mat_emissive"]
    mat_core[:, 8] = device["mat_f0"]
    mat_core[:, 9] = device["mat_metallic"]
    mat_core[:, 10] = device["mat_roughness"]
    mat_core[:, 11] = device["mat_ao"]
    mat_core[:, 12] = device["mat_alpha_mode"]
    mat_core[:, 13] = device["mat_alpha_cutoff"]

    table = device["tex_table"]
    mat_tex = np.zeros((m, 24), np.float32)
    for si, key in enumerate(("mat_tex_base", "mat_tex_emissive",
                              "mat_tex_orm", "mat_tex_normal")):
        h = device[key]
        valid = h >= 0
        rows = table[np.clip(h, 0, len(table) - 1)].astype(np.float32)
        rows[~valid] = np.array([-1, 0, 0, 1, 1, 1], np.float32)
        mat_tex[:, 6 * si : 6 * si + 6] = rows

    # single f16 row per material: core 16 | tex 24 (f16 is exact for the
    # descriptor ints <= 2048; color quantization ~5e-4 is below the 8-bit
    # output step). One gather instead of two 64/96-byte ones.
    mat_all = np.concatenate([mat_core, mat_tex], axis=-1).astype(np.float16)

    # static per-CORNER attribute tables (pos3 | normal3 | uv2): world
    # transforms are baked at upload, so gathering vertex attrs per corner
    # is a one-time cost here — per-frame triangle setup and attribute
    # planes then run as dense FMAs with ZERO gathers (a per-frame
    # clip[tri_vidx] gather over T*3 corners cost ~11 ms at the 1080p
    # headline; see raster.setup.corner_clip)
    va = np.concatenate([device["world_pos"], device["world_normal"],
                         device["uvs"]], axis=-1).astype(np.float32)
    return {"tri_packed": tri_packed, "blend_tri_packed": blend_tri_packed,
            "mask_tri_packed": mask_tri_packed,
            "corner_attr": va[device["tri_vidx"]],
            "corner_attr_blend": va[device["blend_tri_vidx"]],
            "corner_attr_mask": va[device["mask_tri_vidx"]],
            "mat_core": mat_core, "mat_tex": mat_tex, "mat_all": mat_all}
