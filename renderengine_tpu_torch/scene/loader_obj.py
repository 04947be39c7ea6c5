"""Wavefront OBJ + MTL loader.

Host-side, emitting flat SoA arrays into a ``Scene`` — the role of
``AssimpSceneLoader`` (``Source/Runtime/AssimpSceneLoader.{h,cpp}``) for
OBJ content. Reference conventions honored:

- UV v axis flipped (``AssimpSceneLoader.cpp:231``)
- missing normals -> zero vector (``:234``); faces are triangulated (fan)
- per-material meshes under one scene node per OBJ object
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core.aabb import AABB
from .materials import AlphaMode, MaterialInstanceInfo, MaterialProperties
from .scene import Scene


def _parse_mtl(path: Path, scene: Scene, search_dir: Path) -> dict:
    """Returns name -> material handle."""
    mats = {}
    cur = None
    props = None
    alpha = AlphaMode.OPAQUE

    def flush():
        nonlocal cur, props, alpha
        if cur is not None:
            mats[cur] = scene.materials.create_material_instance(
                MaterialInstanceInfo(props, alpha_mode=alpha))
        cur, props, alpha = None, None, AlphaMode.OPAQUE

    if not path.exists():
        return mats
    for line in path.read_text(errors="replace").splitlines():
        t = line.split()
        if not t or t[0].startswith("#"):
            continue
        if t[0] == "newmtl":
            flush()
            cur = t[1] if len(t) > 1 else "default"
            props = MaterialProperties()
        elif props is None:
            continue
        elif t[0] == "Kd":
            props.base_color = np.array([*map(float, t[1:4]), props.base_color[3]], np.float32)
        elif t[0] == "Ke":
            props.emissive = np.array([*map(float, t[1:4]), 1.0], np.float32)
        elif t[0] == "Ns":
            # Blinn-Phong exponent -> perceptual roughness (Beckmann fit)
            ns = float(t[1])
            props.perceptual_roughness = float(np.clip(np.sqrt(2.0 / (ns + 2.0)), 0.0, 1.0))
        elif t[0] == "Ni":
            ior = float(t[1])
            props.f0 = ((ior - 1.0) / (ior + 1.0)) ** 2
        elif t[0] in ("d", "Tr"):
            a = float(t[1])
            if t[0] == "Tr":
                a = 1.0 - a
            props.base_color = np.array([*props.base_color[:3], a], np.float32)
            if a < 1.0:
                alpha = AlphaMode.BLEND
        elif t[0] == "map_Kd":
            tex_path = search_dir / t[-1]
            if tex_path.exists():
                props.base_color_texture = scene.textures.load_texture(str(tex_path))
        elif t[0] in ("map_bump", "bump", "norm"):
            tex_path = search_dir / t[-1]
            if tex_path.exists():
                props.normals_texture = scene.textures.load_texture(str(tex_path))
    flush()
    return mats


def load_obj(path, scene: Scene | None = None) -> Scene:
    """Loads an OBJ. Uses the native C++ tokenizer when available; the
    Python path below is the reference implementation and fallback (host
    asset parsing, kept as the JAX package has it: no device path)."""
    path = Path(path)
    scene = scene or Scene()

    from ..native import parse_obj

    native = parse_obj(path)
    if native is not None:
        mats = {}
        for lib in native["mtllibs"]:
            mats.update(_parse_mtl(path.parent / lib, scene, path.parent))
        default_mat = scene.materials.create_material_instance(MaterialInstanceInfo())
        handles = [mats.get(n, default_mat) for n in native["mat_names"]]
        t = len(native["mat"])
        for mi in np.unique(native["mat"]):
            sel = native["mat"] == mi
            pos = native["pos"][sel].reshape(-1, 3)
            nrm = native["nrm"][sel].reshape(-1, 3)
            uv = native["uv"][sel].reshape(-1, 2)
            node = scene.tree.create_node(np.eye(4, dtype=np.float32),
                                          AABB.from_points(pos) if len(pos) else AABB())
            base = scene.meshes.add_vertices(pos, nrm, uv)
            idx = np.arange(len(pos), dtype=np.uint32) + base
            handle = handles[mi] if 0 <= mi < len(handles) else default_mat
            scene.meshes.add_mesh(idx, handle, node)
        del t
        return scene
    positions: list = []
    normals: list = []
    uvs: list = []
    mats: dict = {}
    default_mat = None

    # per (object, material) triangle buckets of corner tuples
    current_obj = "default"
    current_mat = None
    buckets: dict = {}

    for line in path.read_text(errors="replace").splitlines():
        t = line.split()
        if not t or t[0].startswith("#"):
            continue
        if t[0] == "v":
            positions.append([float(t[1]), float(t[2]), float(t[3])])
        elif t[0] == "vn":
            normals.append([float(t[1]), float(t[2]), float(t[3])])
        elif t[0] == "vt":
            # reference flips v for Vulkan (AssimpSceneLoader.cpp:231)
            uvs.append([float(t[1]), -float(t[2])])
        elif t[0] == "mtllib":
            mats.update(_parse_mtl(path.parent / t[1], scene, path.parent))
        elif t[0] in ("o", "g"):
            current_obj = t[1] if len(t) > 1 else "default"
        elif t[0] == "usemtl":
            current_mat = mats.get(t[1])
        elif t[0] == "f":
            corners = []
            for v in t[1:]:
                parts = (v.split("/") + ["", ""])[:3]
                vi = int(parts[0])
                ti = int(parts[1]) if parts[1] else 0
                ni = int(parts[2]) if parts[2] else 0
                corners.append((vi, ti, ni))
            key = (current_obj, current_mat)
            tris = buckets.setdefault(key, [])
            for k in range(1, len(corners) - 1):  # fan triangulation
                tris.append((corners[0], corners[k], corners[k + 1]))

    if default_mat is None:
        default_mat = scene.materials.create_material_instance(MaterialInstanceInfo())

    pos = np.asarray(positions, np.float32).reshape(-1, 3)
    nrm = np.asarray(normals, np.float32).reshape(-1, 3) if normals else np.zeros((0, 3), np.float32)
    uv = np.asarray(uvs, np.float32).reshape(-1, 2) if uvs else np.zeros((0, 2), np.float32)

    def resolve(idx, n):
        return idx - 1 if idx > 0 else n + idx

    for (obj, mat), tris in buckets.items():
        # build a dedicated vertex stream per bucket (corner-indexed)
        vp, vn, vt, vidx = [], [], [], []
        seen = {}
        for tri in tris:
            for c in tri:
                if c not in seen:
                    seen[c] = len(vp)
                    vi, ti, ni = c
                    p = pos[resolve(vi, len(pos))]
                    vp.append(p)
                    vn.append(nrm[resolve(ni, len(nrm))] if ni else np.zeros(3, np.float32))
                    vt.append(uv[resolve(ti, len(uv))] if ti else np.zeros(2, np.float32))
                vidx.append(seen[c])
        vp = np.asarray(vp, np.float32)
        node = scene.tree.create_node(np.eye(4, dtype=np.float32), AABB.from_points(vp))
        base = scene.meshes.add_vertices(vp, np.asarray(vn, np.float32), np.asarray(vt, np.float32))
        scene.meshes.add_mesh(np.asarray(vidx, np.uint32) + base,
                              mat if mat is not None else default_mat, node)
    return scene
