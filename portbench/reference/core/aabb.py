"""Axis-aligned bounding boxes (reference ``Source/Runtime/BoundingBox.{h,cpp}``)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class AABB:
    """min/max box. Default is the empty box (min=+inf, max=-inf), so Union
    with anything yields the other box (reference ``BoundingBox.h:9-31``)."""

    min: np.ndarray = field(default_factory=lambda: np.full(3, np.inf, np.float32))
    max: np.ndarray = field(default_factory=lambda: np.full(3, -np.inf, np.float32))

    @staticmethod
    def from_points(points) -> "AABB":
        pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
        return AABB(pts.min(axis=0), pts.max(axis=0))

    def is_empty(self) -> bool:
        return bool(np.any(self.min > self.max))

    def union(self, other: "AABB") -> "AABB":
        return AABB(np.minimum(self.min, other.min), np.maximum(self.max, other.max))

    def intersects(self, other: "AABB") -> bool:
        return bool(np.all(self.min <= other.max) and np.all(other.min <= self.max))

    def corners(self) -> np.ndarray:
        """All 8 corners, [8, 3]."""
        mn, mx = self.min, self.max
        return np.array(
            [[x, y, z] for x in (mn[0], mx[0]) for y in (mn[1], mx[1]) for z in (mn[2], mx[2])],
            dtype=np.float32,
        )

    def transform(self, m: np.ndarray) -> "AABB":
        """Transform the 8 corners by a 4x4 and re-fit
        (reference ``BoundingBox.h:49-61``). Empty stays empty (inf corners
        would otherwise produce NaNs)."""
        if self.is_empty():
            return AABB()
        c = self.corners()
        h = c @ np.asarray(m, np.float32)[:3, :3].T + np.asarray(m, np.float32)[:3, 3]
        return AABB.from_points(h)

    def center(self) -> np.ndarray:
        return ((self.min + self.max) * 0.5).astype(np.float32)

    def extent(self) -> np.ndarray:
        return (self.max - self.min).astype(np.float32)
