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

        ``chart_subdiv`` belongs to texture-space shading, which this
        package does not carry yet: passing it raises."""
        if chart_subdiv is not None:
            raise NotImplementedError(
                "chart_subdiv (texture-space shading) is not ported yet; "
                "it arrives with the texture-space slice")
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
