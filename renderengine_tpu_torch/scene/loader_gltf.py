"""glTF 2.0 loader (.gltf + .bin / .glb), host-side, no dependencies.

The AssimpSceneLoader analog (``Source/Runtime/AssimpSceneLoader.cpp``)
for glTF content, honoring the reference's conventions:

- UV v axis flipped (``:231``)
- node recursion with premultiplied world transforms; glTF stores
  column-major matrices — transposed to our row-major convention (the
  same fix as the reference's row->column flip, ``:183-196``)
- materials: baseColor, emissive, metallic/roughness factors + textures,
  alphaMode OPAQUE/MASK/BLEND (``:263-361``); IOR extension -> f0
- lights via KHR_lights_punctual with the reference's normalization
  (max-channel + 10/683 lux scale, ``:109-117``)
- camera from the file if present, else auto-framed orbit (``:153-175``)
"""

from __future__ import annotations

import base64
import json
import struct
from pathlib import Path

import numpy as np

from ..core.aabb import AABB
from .camera import Camera
from .lights import Light, LightSystem, LightType, normalize_assimp_light_intensity
from .materials import AlphaMode, MaterialInstanceInfo, MaterialProperties
from .scene import Scene

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _load_buffers(gltf: dict, base_dir: Path, glb_bin: bytes | None):
    bufs = []
    for b in gltf.get("buffers", []):
        uri = b.get("uri")
        if uri is None:
            bufs.append(glb_bin)
        elif uri.startswith("data:"):
            bufs.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            bufs.append((base_dir / uri).read_bytes())
    return bufs


def _accessor(gltf, bufs, idx) -> np.ndarray:
    a = gltf["accessors"][idx]
    view = gltf["bufferViews"][a["bufferView"]]
    buf = bufs[view["buffer"]]
    dtype = _COMPONENT_DTYPES[a["componentType"]]
    ncomp = _TYPE_COUNTS[a["type"]]
    count = a["count"]
    offset = view.get("byteOffset", 0) + a.get("byteOffset", 0)
    stride = view.get("byteStride", 0)
    itemsize = np.dtype(dtype).itemsize * ncomp
    if stride and stride != itemsize:
        raw = np.frombuffer(buf, np.uint8, count * stride, offset).reshape(count, stride)
        arr = raw[:, :itemsize].copy().view(dtype).reshape(count, ncomp)
    else:
        arr = np.frombuffer(buf, dtype, count * ncomp, offset).reshape(count, ncomp)
    return arr


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T  # col-major file
    m = np.eye(4, dtype=np.float32)
    if "scale" in node:
        m[:3, :3] *= np.asarray(node["scale"], np.float32)
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ], np.float32)
        m[:3, :3] = r @ m[:3, :3]
    if "translation" in node:
        m[:3, 3] = np.asarray(node["translation"], np.float32)
    return m


def load_gltf(path, scene: Scene | None = None) -> Scene:
    path = Path(path)
    scene = scene or Scene()
    glb_bin = None
    if path.suffix.lower() == ".glb":
        data = path.read_bytes()
        magic, _version, _length = struct.unpack("<III", data[:12])
        assert magic == 0x46546C67, "not a GLB"
        off = 12
        gltf = None
        while off < len(data):
            clen, ctype = struct.unpack("<II", data[off : off + 8])
            chunk = data[off + 8 : off + 8 + clen]
            if ctype == 0x4E4F534A:
                gltf = json.loads(chunk)
            elif ctype == 0x004E4942:
                glb_bin = chunk
            off += 8 + clen
        assert gltf is not None
    else:
        gltf = json.loads(path.read_text())
    bufs = _load_buffers(gltf, path.parent, glb_bin)

    # textures
    tex_handles: dict = {}

    def texture(ti) -> int:
        if ti in tex_handles:
            return tex_handles[ti]
        handle = -1
        try:
            src = gltf["textures"][ti]["source"]
            img = gltf["images"][src]
            if "uri" in img and not img["uri"].startswith("data:"):
                handle = scene.textures.load_texture(str(path.parent / img["uri"]))
            elif "bufferView" in img:
                view = gltf["bufferViews"][img["bufferView"]]
                raw = bufs[view["buffer"]][view.get("byteOffset", 0):
                                           view.get("byteOffset", 0) + view["byteLength"]]
                import io
                from ..utils.png import read_png
                tmp = path.parent / f".embedded_{ti}.png"
                if raw[:8] == b"\x89PNG\r\n\x1a\n":
                    tmp.write_bytes(raw)
                    handle = scene.textures.load_texture(str(tmp))
                    tmp.unlink(missing_ok=True)
        except Exception:
            handle = -1
        tex_handles[ti] = handle
        return handle

    # materials (reference LoadMaterials, AssimpSceneLoader.cpp:263-361)
    mat_handles = []
    for m in gltf.get("materials", []):
        props = MaterialProperties()
        pbr = m.get("pbrMetallicRoughness", {})
        if "baseColorFactor" in pbr:
            props.base_color = np.asarray(pbr["baseColorFactor"], np.float32)
        props.metallic = float(pbr.get("metallicFactor", 1.0))
        props.perceptual_roughness = float(pbr.get("roughnessFactor", 1.0))
        if "baseColorTexture" in pbr:
            props.base_color_texture = texture(pbr["baseColorTexture"]["index"])
        if "metallicRoughnessTexture" in pbr:
            props.orm_texture = texture(pbr["metallicRoughnessTexture"]["index"])
        if "emissiveFactor" in m:
            props.emissive = np.array([*m["emissiveFactor"], 1.0], np.float32)
        if "emissiveTexture" in m:
            props.emissive_texture = texture(m["emissiveTexture"]["index"])
        if "normalTexture" in m:
            props.normals_texture = texture(m["normalTexture"]["index"])
        ior = m.get("extensions", {}).get("KHR_materials_ior", {}).get("ior")
        if ior:
            props.f0 = ((ior - 1.0) / (ior + 1.0)) ** 2
        mode = {"OPAQUE": AlphaMode.OPAQUE, "MASK": AlphaMode.MASK,
                "BLEND": AlphaMode.BLEND}[m.get("alphaMode", "OPAQUE")]
        mat_handles.append(scene.materials.create_material_instance(
            MaterialInstanceInfo(props, alpha_mode=mode,
                                 alpha_cutoff=m.get("alphaCutoff", 0.5))))
    default_mat = scene.materials.create_material_instance(MaterialInstanceInfo())

    # lights (KHR_lights_punctual)
    gltf_lights = gltf.get("extensions", {}).get("KHR_lights_punctual", {}).get("lights", [])

    max_vert_dist = 0.0
    file_camera = None

    def walk(node_idx, parent_tf):
        nonlocal max_vert_dist, file_camera
        node = gltf["nodes"][node_idx]
        tf = parent_tf @ _node_matrix(node)
        if "mesh" in node:
            mesh = gltf["meshes"][node["mesh"]]
            for prim in mesh.get("primitives", []):
                if prim.get("mode", 4) != 4:
                    continue  # triangles only
                attrs = prim["attributes"]
                pos = _accessor(gltf, bufs, attrs["POSITION"]).astype(np.float32)
                n = (_accessor(gltf, bufs, attrs["NORMAL"]).astype(np.float32)
                     if "NORMAL" in attrs else np.zeros_like(pos))
                if "TEXCOORD_0" in attrs:
                    uv = _accessor(gltf, bufs, attrs["TEXCOORD_0"]).astype(np.float32)
                    uv = uv * np.array([1.0, -1.0], np.float32)  # reference v flip
                else:
                    uv = np.zeros((len(pos), 2), np.float32)
                if "indices" in prim:
                    idx = _accessor(gltf, bufs, prim["indices"]).reshape(-1).astype(np.uint32)
                else:
                    idx = np.arange(len(pos), dtype=np.uint32)
                snode = scene.tree.create_node(tf, AABB.from_points(pos))
                base = scene.meshes.add_vertices(pos, n, uv)
                mat = mat_handles[prim["material"]] if "material" in prim else default_mat
                scene.meshes.add_mesh(idx + base, mat, snode)
                world = pos @ tf[:3, :3].T + tf[:3, 3]
                max_vert_dist = max(max_vert_dist, float(np.linalg.norm(world, axis=1).max()))
        light_idx = node.get("extensions", {}).get("KHR_lights_punctual", {}).get("light")
        if light_idx is not None and light_idx < len(gltf_lights):
            gl = gltf_lights[light_idx]
            color, intensity = normalize_assimp_light_intensity(
                np.asarray(gl.get("color", [1, 1, 1]), np.float32)
                * float(gl.get("intensity", 1.0)))
            ltype = {"directional": LightType.DIRECTIONAL, "point": LightType.POINT,
                     "spot": LightType.SPOT}[gl["type"]]
            light = Light(type=ltype, color=color, intensity=intensity,
                          position=tf[:3, 3].astype(np.float32),
                          direction=(tf[:3, :3] @ np.array([0, 0, -1], np.float32)))
            if ltype == LightType.SPOT:
                spot = gl.get("spot", {})
                light.cos_inner = float(np.cos(spot.get("innerConeAngle", 0.0)))
                light.cos_outer = float(np.cos(spot.get("outerConeAngle", np.pi / 4)))
            if ltype == LightType.POINT:
                light.falloff_radius = float(gl.get("range", 1e6))
            lid = scene.lights.add_light(light)
            if ltype == LightType.DIRECTIONAL:
                scene.create_shadow_map(lid)
        if "camera" in node and file_camera is None:
            cam = gltf["cameras"][node["camera"]]
            if cam.get("type") == "perspective":
                p = cam["perspective"]
                file_camera = (tf[:3, 3].astype(np.float32),
                               float(np.degrees(p.get("yfov", 0.8))),
                               float(p.get("znear", 0.1)),
                               float(p.get("zfar", 100.0)))
        for ch in node.get("children", []):
            walk(ch, tf)

    scn = gltf.get("scenes", [{}])[gltf.get("scene", 0)]
    for root in scn.get("nodes", []):
        walk(root, np.eye(4, dtype=np.float32))

    # camera (reference LoadCamera, AssimpSceneLoader.cpp:153-175)
    if file_camera is not None:
        pos, fov, near, far = file_camera
        scene.camera.set_camera_view(pos, np.zeros(3, np.float32),
                                     np.array([0, 1, 0], np.float32))
        scene.camera.fov_degrees = fov
        scene.camera.near, scene.camera.far = near, far
    elif max_vert_dist > 0:
        r = max_vert_dist * 15.0  # reference auto-framing quirk (:168-172)
        scene.camera.set_camera_view(np.array([r, r, r], np.float32),
                                     np.zeros(3, np.float32),
                                     np.array([0, 0, 1], np.float32))
    return scene
