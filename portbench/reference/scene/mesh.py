"""One-big-buffer geometry store.

Reference: ``Source/Runtime/Renderer/MeshAllocator.{h,cpp}`` — all scene
geometry is appended into one vertex buffer + one uint32 index buffer and
uploaded once; meshes are (index_offset, index_count, material) ranges
grouped per scene node.

Difference from the reference: at upload we also flatten to *per-triangle* SoA
arrays (vertex indices, material id, node id) because the rasterizer is a
data-parallel sweep over triangles, not a sequence of draw calls.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Mesh:
    """A draw range (reference ``MeshAllocator.h:26-31``)."""

    index_offset: int
    index_count: int
    material: int  # MaterialHandle packed value
    node: int      # SceneNodeHandle


@dataclass
class MeshAllocator:
    positions: list = field(default_factory=list)  # np [n,3] chunks
    normals: list = field(default_factory=list)
    uvs: list = field(default_factory=list)
    indices: list = field(default_factory=list)    # np [n] uint32 chunks
    meshes: list = field(default_factory=list)     # list[Mesh]
    _vertex_count: int = 0
    _index_count: int = 0

    def add_vertices(self, positions, normals, uvs) -> int:
        """Append a vertex block; returns the base vertex index
        (the reference appends one vertex at a time, ``MeshAllocator.cpp:10-35``;
        we batch for host speed)."""
        p = np.asarray(positions, np.float32).reshape(-1, 3)
        n = np.asarray(normals, np.float32).reshape(-1, 3)
        t = np.asarray(uvs, np.float32).reshape(-1, 2)
        assert len(p) == len(n) == len(t)
        base = self._vertex_count
        self.positions.append(p)
        self.normals.append(n)
        self.uvs.append(t)
        self._vertex_count += len(p)
        return base

    def add_mesh(self, indices, material: int, node: int) -> Mesh:
        """Append an index block as one mesh (triangle list, absolute
        vertex indices)."""
        idx = np.asarray(indices, np.uint32).reshape(-1)
        assert len(idx) % 3 == 0, "triangle lists only"
        mesh = Mesh(self._index_count, len(idx), material, node)
        self.indices.append(idx)
        self._index_count += len(idx)
        self.meshes.append(mesh)
        return mesh

    @property
    def vertex_count(self) -> int:
        return self._vertex_count

    @property
    def triangle_count(self) -> int:
        return self._index_count // 3

    def build_arrays(self):
        """Consolidate to flat SoA numpy arrays:

        returns (positions[V,3], normals[V,3], uvs[V,2], vert_node[V],
        tri_vidx[T,3], tri_material[T], tri_node[T]) — the device upload
        set. ``vert_node`` is the per-vertex scene-node id (the reference
        passes the node index per draw via push constant,
        ``primitive.vert:21``; flattening it per vertex lets the vertex
        stage be one batched matmul).
        """
        if self._vertex_count == 0:
            z3 = np.zeros((0, 3), np.float32)
            return z3, z3, np.zeros((0, 2), np.float32), np.zeros(0, np.int32), \
                np.zeros((0, 3), np.int32), np.zeros(0, np.int32), np.zeros(0, np.int32)
        pos = np.concatenate(self.positions, axis=0)
        nrm = np.concatenate(self.normals, axis=0)
        uv = np.concatenate(self.uvs, axis=0)
        idx = np.concatenate(self.indices, axis=0) if self.indices else np.zeros(0, np.uint32)
        tri_vidx = idx.reshape(-1, 3).astype(np.int32)
        t = len(tri_vidx)
        tri_material = np.zeros(t, np.int32)
        tri_node = np.zeros(t, np.int32)
        vert_node = np.zeros(self._vertex_count, np.int32)
        flat_idx = idx.astype(np.int64)
        for m in self.meshes:
            lo, hi = m.index_offset // 3, (m.index_offset + m.index_count) // 3
            tri_material[lo:hi] = m.material
            tri_node[lo:hi] = m.node
            vert_node[flat_idx[m.index_offset : m.index_offset + m.index_count]] = m.node
        return pos, nrm, uv, vert_node, tri_vidx, tri_material, tri_node
