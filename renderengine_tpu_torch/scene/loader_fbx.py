"""Binary FBX (7.x) loader, host-side, no dependencies.

The AssimpSceneLoader analog (``Source/Runtime/AssimpSceneLoader.cpp``)
for FBX content — the reference reads .fbx through assimp's importer
(``AssimpSceneLoader.cpp:81``), so the conventions honored here are the
ones the reference applies to every assimp scene:

- UV v axis flipped (``AssimpSceneLoader.cpp:231``)
- node recursion with premultiplied world transforms (``:183-196``)
- lights with the reference's normalization (``:109-117``); a
  directional light gets a shadow map
- file units kept as-authored (the reference passes no global-scale
  post-process, ``AssimpSceneLoader.cpp:73-75``)
- camera auto-framed when absent (``:153-175``)

Format: the Kaydara binary container (magic ``Kaydara FBX Binary``),
nested node records with typed properties ('Y','C','I','F','D','L'
scalars, 'f','d','i','l','b' arrays with optional zlib deflate, 'S','R'
blobs); 32-bit record headers below version 7500, 64-bit from 7500 on.
Reads Geometry (PolygonVertexIndex triangulation, LayerElementNormal /
UV / Material in all mapping x reference combinations), Model TRS
(Lcl Translation/Rotation/Scaling, XYZ Euler degrees), Materials
(Diffuse/Emissive/Shininess/Opacity), Textures (via OP connections to
DiffuseColor/EmissiveColor/NormalMap/ShininessExponent), Lights and the
OO/OP connection graph. ASCII FBX is rejected with transcode advice.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from ..core.aabb import AABB
from .lights import Light, LightType, normalize_assimp_light_intensity
from .materials import AlphaMode, MaterialInstanceInfo, MaterialProperties
from .scene import Scene

_MAGIC = b"Kaydara FBX Binary  \x00\x1a\x00"

_ARRAY_DTYPES = {b"f": np.float32, b"d": np.float64,
                 b"i": np.int32, b"l": np.int64, b"b": np.uint8}
_SCALAR_FMT = {b"Y": "<h", b"C": "<B", b"I": "<i",
               b"F": "<f", b"D": "<d", b"L": "<q"}


class FbxNode:
    __slots__ = ("name", "props", "children")

    def __init__(self, name: str, props: list, children: list):
        self.name, self.props, self.children = name, props, children

    def find(self, name: str):
        for c in self.children:
            if c.name == name:
                return c
        return None

    def find_all(self, name: str):
        return [c for c in self.children if c.name == name]


def _read_props(data: bytes, off: int, count: int) -> tuple[list, int]:
    props = []
    for _ in range(count):
        t = data[off:off + 1]
        off += 1
        if t in _SCALAR_FMT:
            fmt = _SCALAR_FMT[t]
            props.append(struct.unpack_from(fmt, data, off)[0])
            off += struct.calcsize(fmt)
        elif t in _ARRAY_DTYPES:
            n, enc, clen = struct.unpack_from("<III", data, off)
            off += 12
            dtype = _ARRAY_DTYPES[t]
            if enc == 1:
                raw = zlib.decompress(data[off:off + clen])
            else:
                raw = data[off:off + clen]
            off += clen
            props.append(np.frombuffer(raw, dtype, n))
        elif t in (b"S", b"R"):
            n = struct.unpack_from("<I", data, off)[0]
            off += 4
            blob = data[off:off + n]
            off += n
            props.append(blob.decode("utf-8", "replace")
                         if t == b"S" else blob)
        else:
            raise ValueError(f"unknown FBX property type {t!r}")
    return props, off


def _read_node(data: bytes, off: int, big: bool):
    """Returns (FbxNode | None, next_offset). None = null terminator."""
    if big:
        end, nprops, _plen = struct.unpack_from("<QQQ", data, off)
        off += 24
    else:
        end, nprops, _plen = struct.unpack_from("<III", data, off)
        off += 12
    nlen = data[off]
    off += 1
    if end == 0:
        return None, off
    name = data[off:off + nlen].decode("ascii", "replace")
    off += nlen
    props, off = _read_props(data, off, nprops)
    children = []
    while off < end:
        child, off = _read_node(data, off, big)
        if child is None:
            break
        children.append(child)
    return FbxNode(name, props, children), end


def parse_fbx(data: bytes) -> FbxNode:
    """Parse a binary FBX blob into a root FbxNode tree."""
    if not data.startswith(_MAGIC):
        if data[:1] == b";" or b"FBX" in data[:64]:
            raise ValueError(
                "ASCII FBX is not supported — export/convert to binary "
                "FBX (e.g. FBX Converter or Blender binary export)")
        raise ValueError("not an FBX file")
    version = struct.unpack_from("<I", data, len(_MAGIC))[0]
    big = version >= 7500
    off = len(_MAGIC) + 4
    roots = []
    while off < len(data):
        node, off = _read_node(data, off, big)
        if node is None:
            break
        roots.append(node)
    return FbxNode("", [], roots)


def _prop70(node: FbxNode, name: str):
    """Look up a Properties70 entry by name. Returns the value list
    after the 4 header strings (P: name, type, label, flags, v...)."""
    p70 = node.find("Properties70")
    if p70 is None:
        return None
    for p in p70.find_all("P"):
        if p.props and p.props[0] == name:
            return p.props[4:]
    return None


def _euler_xyz_deg(rx: float, ry: float, rz: float) -> np.ndarray:
    """FBX default rotation order: X then Y then Z (column-vector
    convention -> M = Rz @ Ry @ Rx), angles in degrees."""
    sx, cx = np.sin(np.radians(rx)), np.cos(np.radians(rx))
    sy, cy = np.sin(np.radians(ry)), np.cos(np.radians(ry))
    sz, cz = np.sin(np.radians(rz)), np.cos(np.radians(rz))
    rxm = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], np.float32)
    rym = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
    rzm = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], np.float32)
    return rzm @ rym @ rxm


def _model_tf(model: FbxNode) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    r = _prop70(model, "Lcl Rotation")
    pre = _prop70(model, "PreRotation")
    s = _prop70(model, "Lcl Scaling")
    t = _prop70(model, "Lcl Translation")
    rot = np.eye(3, dtype=np.float32)
    if r is not None:
        rot = _euler_xyz_deg(*[float(v) for v in r[:3]])
    if pre is not None:
        rot = _euler_xyz_deg(*[float(v) for v in pre[:3]]) @ rot
    if s is not None:
        rot = rot @ np.diag(np.asarray(s[:3], np.float32))
    m[:3, :3] = rot
    if t is not None:
        m[:3, 3] = np.asarray(t[:3], np.float32)
    return m


def _layer_per_corner(geom: FbxNode, layer_name: str, data_name: str,
                      idx_name: str, poly_vidx: np.ndarray,
                      ncomp: int) -> np.ndarray | None:
    """Expand a LayerElement to one row per polygon CORNER, handling
    mapping (ByPolygonVertex / ByVertice / ByPolygon / AllSame) x
    reference (Direct / IndexToDirect)."""
    layer = geom.find(layer_name)
    if layer is None:
        return None
    data = None
    index = None
    mapping = ref = ""
    for c in layer.children:
        if c.name == data_name:
            data = np.asarray(c.props[0], np.float64).reshape(-1, ncomp)
        elif c.name == idx_name:
            index = np.asarray(c.props[0], np.int64)
        elif c.name == "MappingInformationType":
            mapping = c.props[0]
        elif c.name == "ReferenceInformationType":
            ref = c.props[0]
    if data is None:
        return None
    n_corners = len(poly_vidx)
    vert_of_corner = np.where(poly_vidx < 0, ~poly_vidx, poly_vidx)
    ends = np.nonzero(poly_vidx < 0)[0]
    poly_of_corner = np.zeros(n_corners, np.int64)
    if len(ends):
        poly_of_corner[1:] = np.cumsum(
            np.isin(np.arange(n_corners - 1), ends).astype(np.int64))
    if mapping == "ByPolygonVertex":
        rows = np.arange(n_corners)
    elif mapping in ("ByVertice", "ByVertex"):
        rows = vert_of_corner
    elif mapping == "ByPolygon":
        rows = poly_of_corner
    else:  # AllSame
        rows = np.zeros(n_corners, np.int64)
    if ref == "IndexToDirect" and index is not None:
        rows = index[rows]
    return data[np.clip(rows, 0, len(data) - 1)].astype(np.float32)


def _triangulate(geom: FbxNode):
    """Geometry -> (pos, nrm, uv, mat_poly) with one row per triangle
    corner (fan triangulation of each polygon)."""
    v = geom.find("Vertices")
    pvi = geom.find("PolygonVertexIndex")
    if v is None or pvi is None:
        return None
    verts = np.asarray(v.props[0], np.float64).reshape(-1, 3)
    poly_vidx = np.asarray(pvi.props[0], np.int64)
    nrm = _layer_per_corner(geom, "LayerElementNormal", "Normals",
                            "NormalsIndex", poly_vidx, 3)
    uv = _layer_per_corner(geom, "LayerElementUV", "UV", "UVIndex",
                           poly_vidx, 2)
    # material layer: one row per corner, column 0 = material slot
    mat = _layer_per_corner(geom, "LayerElementMaterial", "Materials",
                            "MaterialsIndex", poly_vidx, 1)

    # fan-triangulate: corner ranges end where the index is negative
    corners = []
    start = 0
    for i, x in enumerate(poly_vidx):
        if x < 0:
            for k in range(start + 1, i):
                corners += [start, k, k + 1]
            start = i + 1
    rows = np.asarray(corners, np.int64)
    vert_of_corner = np.where(poly_vidx < 0, ~poly_vidx, poly_vidx)
    pos = verts[vert_of_corner[rows]].astype(np.float32)
    nrm = nrm[rows] if nrm is not None else np.zeros_like(pos)
    if uv is not None:
        uv = uv[rows] * np.array([1.0, -1.0], np.float32)  # ref v flip
    else:
        uv = np.zeros((len(pos), 2), np.float32)
    mat_slot = (mat[rows][:, 0].astype(np.int64) if mat is not None
                else np.zeros(len(rows), np.int64))
    return pos, nrm, uv, mat_slot


def _material_info(mat_node: FbxNode, textures: dict,
                   tex_conn: list, scene: Scene,
                   base_dir: Path) -> MaterialInstanceInfo:
    props = MaterialProperties()
    alpha_mode = AlphaMode.OPAQUE
    d = _prop70(mat_node, "DiffuseColor") or _prop70(mat_node, "Diffuse")
    if d is not None:
        props.base_color = np.array([*[float(v) for v in d[:3]], 1.0],
                                    np.float32)
    e = _prop70(mat_node, "EmissiveColor")
    ef = _prop70(mat_node, "EmissiveFactor")
    if e is not None:
        scale = float(ef[0]) if ef is not None else 1.0
        props.emissive = np.array(
            [float(v) * scale for v in e[:3]] + [1.0], np.float32)
    shin = _prop70(mat_node, "Shininess") \
        or _prop70(mat_node, "ShininessExponent")
    if shin is not None:
        ns = float(shin[0])
        props.perceptual_roughness = float(
            np.clip(np.sqrt(2.0 / (ns + 2.0)), 0.0, 1.0))
    op = _prop70(mat_node, "Opacity")
    tr = _prop70(mat_node, "TransparencyFactor")
    a = float(op[0]) if op is not None else \
        (1.0 - float(tr[0]) if tr is not None else 1.0)
    if a < 1.0:
        props.base_color = props.base_color.copy()
        props.base_color[3] = a
        alpha_mode = AlphaMode.BLEND

    # textures attached via OP connections (slot name -> texture id)
    slot_attr = {"DiffuseColor": "base_color_texture",
                 "EmissiveColor": "emissive_texture",
                 "NormalMap": "normals_texture",
                 "Bump": "normals_texture"}
    for tex_id, slot in tex_conn:
        attr = slot_attr.get(slot)
        fname = textures.get(tex_id)
        if attr is None or not fname:
            continue
        p = Path(fname.replace("\\", "/"))
        cand = p if p.is_absolute() else base_dir / p
        if not cand.exists():
            cand = base_dir / p.name
        try:
            setattr(props, attr, scene.textures.load_texture(str(cand)))
        except Exception:
            pass
    return MaterialInstanceInfo(props, alpha_mode=alpha_mode)


_FBX_LIGHT_TYPES = {0: LightType.POINT, 1: LightType.DIRECTIONAL,
                    2: LightType.SPOT}


def load_fbx(path, scene: Scene | None = None) -> Scene:
    path = Path(path)
    scene = scene or Scene()
    root = parse_fbx(path.read_bytes())

    objects = root.find("Objects")
    if objects is None:
        return scene

    # index objects by id; first property of each object node is the id
    geoms: dict[int, FbxNode] = {}
    models: dict[int, FbxNode] = {}
    materials: dict[int, FbxNode] = {}
    textures: dict[int, str] = {}
    attrs: dict[int, FbxNode] = {}
    for o in objects.children:
        if not o.props:
            continue
        oid = int(o.props[0])
        if o.name == "Geometry":
            geoms[oid] = o
        elif o.name == "Model":
            models[oid] = o
        elif o.name == "Material":
            materials[oid] = o
        elif o.name == "Texture":
            fn = o.find("RelativeFilename") or o.find("FileName")
            textures[oid] = fn.props[0] if fn is not None and fn.props \
                else ""
        elif o.name == "NodeAttribute":
            attrs[oid] = o

    # connection graph
    parent_of: dict[int, int] = {}          # model -> parent model (OO)
    geom_of: dict[int, list] = {}           # model -> [geometry ids]
    mats_of: dict[int, list] = {}           # model -> [material ids]
    attr_of: dict[int, int] = {}            # model -> node attribute
    tex_of: dict[int, list] = {}            # material -> [(tex id, slot)]
    conns = root.find("Connections")
    for c in (conns.children if conns is not None else []):
        if c.name != "C" or len(c.props) < 3:
            continue
        kind, child, parent = c.props[0], int(c.props[1]), int(c.props[2])
        if kind == "OO":
            if child in models and (parent in models or parent == 0):
                parent_of[child] = parent
            elif child in geoms and parent in models:
                geom_of.setdefault(parent, []).append(child)
            elif child in materials and parent in models:
                mats_of.setdefault(parent, []).append(child)
            elif child in attrs and parent in models:
                attr_of[parent] = child
        elif kind == "OP" and len(c.props) >= 4:
            if child in textures and parent in materials:
                tex_of.setdefault(parent, []).append(
                    (child, str(c.props[3])))

    # materials -> scene handles
    mat_handle: dict[int, int] = {}
    for mid, mnode in materials.items():
        info = _material_info(mnode, textures, tex_of.get(mid, []),
                              scene, path.parent)
        mat_handle[mid] = scene.materials.create_material_instance(info)
    default_mat = scene.materials.create_material_instance(
        MaterialInstanceInfo())

    def world_tf(mid: int) -> np.ndarray:
        chain = []
        cur = mid
        seen = set()
        while cur in models and cur not in seen:
            seen.add(cur)
            chain.append(models[cur])
            cur = parent_of.get(cur, 0)
        m = np.eye(4, dtype=np.float32)
        for node in reversed(chain):
            m = m @ _model_tf(node)
        return m

    max_vert_dist = 0.0
    for mid, model in models.items():
        tf = world_tf(mid)
        # lights (NodeAttribute "Light" via Properties70 LightType)
        aid = attr_of.get(mid)
        anode = attrs.get(aid) if aid is not None else None
        a_class = (anode.props[2] if anode is not None
                   and len(anode.props) > 2 else "")
        if a_class == "Light":
            lt = _prop70(anode, "LightType")
            color = _prop70(anode, "Color") or [1.0, 1.0, 1.0]
            inten = _prop70(anode, "Intensity")
            scale = float(inten[0]) / 100.0 if inten is not None else 1.0
            c, intensity = normalize_assimp_light_intensity(
                np.asarray([float(v) for v in color[:3]], np.float32)
                * scale)
            ltype = _FBX_LIGHT_TYPES.get(
                int(lt[0]) if lt is not None else 1,
                LightType.DIRECTIONAL)
            light = Light(type=ltype, color=c, intensity=intensity,
                          position=tf[:3, 3].astype(np.float32),
                          # FBX lights aim down local -Y
                          direction=(tf[:3, :3]
                                     @ np.array([0, -1, 0], np.float32)))
            lid = scene.lights.add_light(light)
            if ltype == LightType.DIRECTIONAL:
                scene.create_shadow_map(lid)
            continue
        for gid in geom_of.get(mid, []):
            tri = _triangulate(geoms[gid])
            if tri is None:
                continue
            pos, nrm, uv, mat_slot = tri
            snode = scene.tree.create_node(tf, AABB.from_points(pos))
            slots = mats_of.get(mid, [])
            # split corners into per-material meshes (3 per triangle)
            tri_slot = mat_slot[0::3]
            for slot in np.unique(tri_slot):
                sel = np.nonzero(tri_slot == slot)[0]
                csel = (sel[:, None] * 3 + np.arange(3)).reshape(-1)
                base = scene.meshes.add_vertices(pos[csel], nrm[csel],
                                                 uv[csel])
                h = mat_handle.get(slots[int(slot)]) \
                    if int(slot) < len(slots) else None
                scene.meshes.add_mesh(
                    np.arange(len(csel), dtype=np.uint32) + base,
                    h if h is not None else default_mat, snode)
            world = pos @ tf[:3, :3].T + tf[:3, 3]
            max_vert_dist = max(
                max_vert_dist, float(np.linalg.norm(world, axis=1).max()))

    if max_vert_dist > 0:
        r = max_vert_dist * 15.0  # reference auto-framing quirk (:168-172)
        scene.camera.set_camera_view(np.array([r, r, r], np.float32),
                                     np.zeros(3, np.float32),
                                     np.array([0, 0, 1], np.float32))
    return scene
