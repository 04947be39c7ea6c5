"""COLLADA (.dae) loader, host-side, no dependencies.

The AssimpSceneLoader analog (``Source/Runtime/AssimpSceneLoader.cpp``)
for Collada content — the reference reads .dae through assimp's importer
(``AssimpSceneLoader.cpp:81`` ``ReadFile``), so the conventions honored
here are the same ones the reference applies to every assimp scene:

- UV v axis flipped (``AssimpSceneLoader.cpp:231``)
- missing normals -> zero vector (``:234``)
- node recursion with premultiplied world transforms (``:183-196``);
  Collada stores row-major matrices, matching our convention directly
- lights with the reference's normalization (max-channel + 10/683 lux
  scale, ``:109-117``); a directional light gets a shadow map
- camera from the file if present, else auto-framed orbit (``:153-175``)
- ``up_axis`` Z_UP / X_UP converted to the engine's Y-up at the root
  (what assimp's Collada importer does internally)

Covers COLLADA 1.4/1.5 ``profile_COMMON`` (phong / lambert / blinn /
constant), <triangles>, <polylist> and <polygons> (fan-triangulated),
shared-offset indexing, texture lookup through sampler2D -> surface ->
image, and <instance_light>/<instance_camera> in the visual scene.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

from ..core.aabb import AABB
from .lights import Light, LightType, normalize_assimp_light_intensity
from .materials import AlphaMode, MaterialInstanceInfo, MaterialProperties
from .scene import Scene

# root transforms converting the file's up axis to the engine's Y-up
_UP_FIX = {
    "Y_UP": np.eye(4, dtype=np.float32),
    "Z_UP": np.array([[1, 0, 0, 0], [0, 0, 1, 0], [0, -1, 0, 0],
                      [0, 0, 0, 1]], np.float32),
    "X_UP": np.array([[0, -1, 0, 0], [1, 0, 0, 0], [0, 0, 1, 0],
                      [0, 0, 0, 1]], np.float32),
}


def _strip_ns(root: ET.Element) -> None:
    """Drop XML namespaces in-place so tags match bare names."""
    for el in root.iter():
        if "}" in el.tag:
            el.tag = el.tag.split("}", 1)[1]


def _floats(text: str | None) -> np.ndarray:
    return np.array((text or "").split(), np.float32)


def _ints(text: str | None) -> np.ndarray:
    return np.array((text or "").split(), np.int64)


def _local_tf(node: ET.Element) -> np.ndarray:
    """Compose <matrix>/<translate>/<rotate>/<scale> children in document
    order (Collada semantics: apply in order of appearance)."""
    m = np.eye(4, dtype=np.float32)
    for el in node:
        t = np.eye(4, dtype=np.float32)
        if el.tag == "matrix":
            t = _floats(el.text).reshape(4, 4)  # row-major in the file
        elif el.tag == "translate":
            t[:3, 3] = _floats(el.text)[:3]
        elif el.tag == "rotate":
            x, y, z, deg = _floats(el.text)[:4]
            axis = np.array([x, y, z], np.float32)
            n = np.linalg.norm(axis)
            if n > 0:
                axis /= n
                a = np.radians(deg)
                c, s = np.cos(a), np.sin(a)
                x, y, z = axis
                t[:3, :3] = np.array([
                    [c + x * x * (1 - c), x * y * (1 - c) - z * s,
                     x * z * (1 - c) + y * s],
                    [y * x * (1 - c) + z * s, c + y * y * (1 - c),
                     y * z * (1 - c) - x * s],
                    [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s,
                     c + z * z * (1 - c)]], np.float32)
        elif el.tag == "scale":
            t[:3, :3] = np.diag(_floats(el.text)[:3])
        else:
            continue
        m = m @ t
    return m


class _Doc:
    """Indexed view of the document: id -> element, plus source arrays."""

    def __init__(self, root: ET.Element, base_dir: Path):
        self.root = root
        self.base_dir = base_dir
        self.by_id: dict[str, ET.Element] = {}
        for el in root.iter():
            i = el.get("id")
            if i is not None:
                self.by_id[i] = el

    def ref(self, url: str) -> ET.Element | None:
        return self.by_id.get((url or "").lstrip("#"))

    def source_array(self, source_id: str) -> np.ndarray:
        """<source> -> [N, stride] float array via its accessor."""
        src = self.ref(source_id)
        acc = src.find("technique_common/accessor")
        arr_el = self.ref(acc.get("source"))
        data = _floats(arr_el.text)
        stride = int(acc.get("stride", "1"))
        count = int(acc.get("count"))
        off = int(acc.get("offset", "0"))
        return data[off:off + count * stride].reshape(count, stride)


def _effect_material(doc: _Doc, effect: ET.Element, scene: Scene,
                     newparam_scope: ET.Element) -> MaterialInstanceInfo:
    """profile_COMMON -> MaterialProperties (diffuse color/texture,
    emission, specular+shininess -> roughness, transparency)."""
    props = MaterialProperties()
    alpha_mode = AlphaMode.OPAQUE

    def texture_path(sampler_sid: str) -> str | None:
        # texture -> sampler2D newparam -> surface newparam -> image
        for np_el in newparam_scope.iter("newparam"):
            if np_el.get("sid") != sampler_sid:
                continue
            s2d = np_el.find("sampler2D/source")
            if s2d is None:
                return None
            for np2 in newparam_scope.iter("newparam"):
                if np2.get("sid") != s2d.text:
                    continue
                init = np2.find("surface/init_from")
                img = doc.ref("#" + (init.text or "")) \
                    if init is not None else None
                if img is not None:
                    f = img.find("init_from")
                    return f.text if f is not None else None
        # 1.5 files may reference the image id directly
        img = doc.ref("#" + sampler_sid)
        if img is not None:
            f = img.find("init_from")
            return f.text if f is not None else None
        return None

    def load_tex(tex_el: ET.Element) -> int:
        p = texture_path(tex_el.get("texture", ""))
        if not p:
            return -1
        p = p.replace("file://", "").strip()
        try:
            return scene.textures.load_texture(str(doc.base_dir / p))
        except Exception:
            return -1

    shader = None
    for kind in ("phong", "blinn", "lambert", "constant"):
        shader = effect.find(f"profile_COMMON/technique/{kind}")
        if shader is not None:
            break
    if shader is None:
        return MaterialInstanceInfo(props)

    def color_of(tag: str):
        el = shader.find(tag)
        if el is None:
            return None, None
        c = el.find("color")
        t = el.find("texture")
        return (_floats(c.text) if c is not None else None), t

    diff, dtex = color_of("diffuse")
    if diff is None and shader.tag == "constant":
        diff, dtex = color_of("color")
    if diff is not None:
        props.base_color = np.resize(diff.astype(np.float32), 4)
        if len(diff) < 4:
            props.base_color[3] = 1.0
    if dtex is not None:
        props.base_color_texture = load_tex(dtex)
    emis, etex = color_of("emission")
    if emis is not None:
        props.emissive = np.resize(emis.astype(np.float32), 4)
    if etex is not None:
        props.emissive_texture = load_tex(etex)

    shin = shader.find("shininess/float")
    if shin is not None:
        # Blinn-Phong exponent -> perceptual roughness (Beckmann fit),
        # same mapping as the OBJ loader's Ns
        ns = float(shin.text)
        props.perceptual_roughness = float(
            np.clip(np.sqrt(2.0 / (ns + 2.0)), 0.0, 1.0))
    refl = shader.find("reflectivity/float")
    if refl is not None:
        props.metallic = float(np.clip(float(refl.text), 0.0, 1.0))

    tr = shader.find("transparency/float")
    if tr is not None:
        a = float(tr.text)
        # A_ONE (default): 1 = opaque. RGB_ZERO inverts.
        t_el = shader.find("transparent")
        if t_el is not None and t_el.get("opaque", "A_ONE") == "RGB_ZERO":
            a = 1.0 - a
        if a < 1.0:
            props.base_color = props.base_color.copy()
            props.base_color[3] = a
            alpha_mode = AlphaMode.BLEND
    return MaterialInstanceInfo(props, alpha_mode=alpha_mode)


def _primitive_inputs(prim: ET.Element, doc: _Doc, mesh: ET.Element):
    """Resolve the VERTEX/NORMAL/TEXCOORD inputs of a primitive block.
    Returns (pos, nrm, uv, offsets, n_offsets): arrays are the full
    source tables; offsets index into the interleaved <p> stream."""
    pos = nrm = uv = None
    off = {"VERTEX": None, "NORMAL": None, "TEXCOORD": None}
    max_off = 0
    for inp in prim.findall("input"):
        sem = inp.get("semantic")
        o = int(inp.get("offset", "0"))
        max_off = max(max_off, o)
        if sem == "VERTEX":
            vert = doc.ref(inp.get("source"))
            for vi in vert.findall("input"):
                if vi.get("semantic") == "POSITION":
                    pos = doc.source_array(vi.get("source"))
                elif vi.get("semantic") == "NORMAL":
                    nrm = doc.source_array(vi.get("source"))
            off["VERTEX"] = o
        elif sem == "NORMAL" and off["NORMAL"] is None:
            nrm = doc.source_array(inp.get("source"))
            off["NORMAL"] = o
        elif sem == "TEXCOORD" and off["TEXCOORD"] is None:
            uv = doc.source_array(inp.get("source"))
            off["TEXCOORD"] = o
    # NORMAL reached through <vertices> shares the VERTEX offset
    if nrm is not None and off["NORMAL"] is None:
        off["NORMAL"] = off["VERTEX"]
    return pos, nrm, uv, off, max_off + 1


def _emit_primitive(prim: ET.Element, doc: _Doc, mesh_el: ET.Element,
                    scene: Scene, tf: np.ndarray, mat_of: dict,
                    default_mat: int) -> float:
    """Triangulate one <triangles>/<polylist>/<polygons> block into the
    Scene. Returns the max world-space vertex distance (for framing)."""
    pos_t, nrm_t, uv_t, off, stride = _primitive_inputs(prim, doc, mesh_el)
    if pos_t is None:
        return 0.0
    if prim.tag == "polygons":
        chunks = [_ints(p.text) for p in prim.findall("p")]
        vcount = np.array([len(c) // stride for c in chunks], np.int64)
        p = np.concatenate(chunks) if chunks else np.zeros(0, np.int64)
    else:
        p = _ints(" ".join(e.text or "" for e in prim.findall("p")))
        if prim.tag == "polylist":
            vcount = _ints(prim.findtext("vcount", ""))
        else:  # triangles
            vcount = np.full(len(p) // (3 * stride), 3, np.int64)
    if len(p) == 0:
        return 0.0
    idx = p.reshape(-1, stride)   # one row per corner

    # fan-triangulate: corner row ranges per polygon
    starts = np.concatenate([[0], np.cumsum(vcount)[:-1]])
    tri_corners = []
    for s, n in zip(starts, vcount):
        for k in range(1, int(n) - 1):
            tri_corners += [s, s + k, s + k + 1]
    rows = idx[np.asarray(tri_corners, np.int64)]

    pos = pos_t[rows[:, off["VERTEX"]], :3].astype(np.float32)
    nrm = (nrm_t[rows[:, off["NORMAL"]], :3].astype(np.float32)
           if nrm_t is not None and off["NORMAL"] is not None
           else np.zeros_like(pos))   # missing -> zero (reference :234)
    if uv_t is not None and off["TEXCOORD"] is not None:
        uv = uv_t[rows[:, off["TEXCOORD"]], :2].astype(np.float32)
        uv = uv * np.array([1.0, -1.0], np.float32)  # reference v flip
    else:
        uv = np.zeros((len(pos), 2), np.float32)

    snode = scene.tree.create_node(tf, AABB.from_points(pos))
    base = scene.meshes.add_vertices(pos, nrm, uv)
    mat = mat_of.get(prim.get("material"), default_mat)
    scene.meshes.add_mesh(np.arange(len(pos), dtype=np.uint32) + base,
                          mat, snode)
    world = pos @ tf[:3, :3].T + tf[:3, 3]
    return float(np.linalg.norm(world, axis=1).max())


def load_dae(path, scene: Scene | None = None) -> Scene:
    path = Path(path)
    scene = scene or Scene()
    root = ET.fromstring(path.read_bytes())
    _strip_ns(root)
    doc = _Doc(root, path.parent)

    up = root.findtext("asset/up_axis", "Y_UP").strip()
    up_fix = _UP_FIX.get(up, _UP_FIX["Y_UP"])

    # materials: material id -> MaterialInstanceInfo handle
    mat_handle: dict[str, int] = {}
    for mat in root.iter("material"):
        ie = mat.find("instance_effect")
        eff = doc.ref(ie.get("url")) if ie is not None else None
        if eff is not None:
            info = _effect_material(doc, eff, scene, eff)
            mat_handle[mat.get("id")] = \
                scene.materials.create_material_instance(info)
    default_mat = scene.materials.create_material_instance(
        MaterialInstanceInfo())

    max_vert_dist = 0.0
    file_camera = None

    def instance_lights(node: ET.Element, tf: np.ndarray) -> None:
        for il in node.findall("instance_light"):
            ldef = doc.ref(il.get("url"))
            if ldef is None:
                continue
            tc = ldef.find("technique_common")
            for kind, ltype in (("directional", LightType.DIRECTIONAL),
                                ("point", LightType.POINT),
                                ("spot", LightType.SPOT)):
                el = tc.find(kind) if tc is not None else None
                if el is None:
                    continue
                color = _floats(el.findtext("color", "1 1 1"))[:3]
                color, intensity = normalize_assimp_light_intensity(
                    color.astype(np.float32))
                light = Light(
                    type=ltype, color=color, intensity=intensity,
                    position=tf[:3, 3].astype(np.float32),
                    # Collada lights point down local -Z
                    direction=(tf[:3, :3]
                               @ np.array([0, 0, -1], np.float32)))
                if ltype == LightType.SPOT:
                    ang = float(el.findtext("falloff_angle", "45"))
                    light.cos_outer = float(np.cos(np.radians(ang)))
                    light.cos_inner = float(np.cos(np.radians(ang) * 0.5))
                lid = scene.lights.add_light(light)
                if ltype == LightType.DIRECTIONAL:
                    scene.create_shadow_map(lid)

    def walk(node: ET.Element, parent_tf: np.ndarray) -> None:
        nonlocal max_vert_dist, file_camera
        tf = parent_tf @ _local_tf(node)
        for ig in node.findall("instance_geometry"):
            geom = doc.ref(ig.get("url"))
            if geom is None:
                continue
            # bind_material: symbol (as named by the primitive) -> target
            mat_of: dict[str, int] = {}
            for im in ig.iter("instance_material"):
                h = mat_handle.get((im.get("target") or "").lstrip("#"))
                if h is not None:
                    mat_of[im.get("symbol")] = h
            mesh_el = geom.find("mesh")
            if mesh_el is None:
                continue
            for prim in mesh_el:
                if prim.tag in ("triangles", "polylist", "polygons"):
                    max_vert_dist = max(max_vert_dist, _emit_primitive(
                        prim, doc, mesh_el, scene, tf, mat_of,
                        default_mat))
        instance_lights(node, tf)
        for ic in node.findall("instance_camera"):
            if file_camera is not None:
                continue
            cdef = doc.ref(ic.get("url"))
            persp = cdef.find("optics/technique_common/perspective") \
                if cdef is not None else None
            if persp is not None:
                yfov = persp.findtext("yfov")
                xfov = persp.findtext("xfov")
                fov = float(yfov) if yfov else \
                    (float(xfov) if xfov else 45.0)
                file_camera = (tf[:3, 3].astype(np.float32), fov,
                               float(persp.findtext("znear", "0.1")),
                               float(persp.findtext("zfar", "100.0")))
        for child in node.findall("node"):
            walk(child, tf)

    vscene = None
    ivs = root.find("scene/instance_visual_scene")
    if ivs is not None:
        vscene = doc.ref(ivs.get("url"))
    if vscene is None:
        vscene = root.find("library_visual_scenes/visual_scene")
    if vscene is not None:
        for node in vscene.findall("node"):
            walk(node, up_fix)

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
