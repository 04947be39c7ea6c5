"""Flat scene node arrays.

Reference: ``Source/Runtime/Renderer/SceneTree.{h,cpp}`` — despite the name
there is no post-load hierarchy traversal: nodes are flat arrays of
pre-multiplied world transforms + local AABBs + parent handles, uploaded as
a storage buffer. We keep the same flat design (it is already the
shape a data-parallel device wants).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.aabb import AABB
from ..core.math3d import normal_matrix


@dataclass
class SceneTree:
    transforms: list = field(default_factory=list)   # world mat4 per node
    local_aabbs: list = field(default_factory=list)  # AABB per node
    parents: list = field(default_factory=list)      # parent handle (-1 root)

    def create_node(self, world_transform, local_aabb: AABB | None = None, parent: int = -1) -> int:
        """Returns the SceneNodeHandle (array index, ``SceneTree.cpp:6-13``)."""
        self.transforms.append(np.asarray(world_transform, np.float32).reshape(4, 4))
        self.local_aabbs.append(local_aabb if local_aabb is not None else AABB())
        self.parents.append(parent)
        return len(self.transforms) - 1

    def __len__(self) -> int:
        return len(self.transforms)

    def world_aabb(self, node: int) -> AABB:
        return self.local_aabbs[node].transform(self.transforms[node])

    def scene_aabb(self) -> AABB:
        """Union of world boxes (reference ``SceneTree.h:42-54``)."""
        box = AABB()
        for i in range(len(self.transforms)):
            box = box.union(self.world_aabb(i))
        return box

    def build_arrays(self):
        """(transforms[N,4,4], normal_mats[N,3,3]) — the device upload set.
        Normal matrices are transpose(inverse(mat3)) per node, hoisted out
        of the vertex kernel (the reference computes this per-vertex in
        ``primitive.vert:55``)."""
        n = len(self.transforms)
        if n == 0:
            return np.zeros((0, 4, 4), np.float32), np.zeros((0, 3, 3), np.float32)
        t = np.stack(self.transforms).astype(np.float32)
        nm = np.stack([normal_matrix(m) for m in self.transforms]).astype(np.float32)
        return t, nm
