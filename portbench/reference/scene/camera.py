"""Camera + per-frame view uniforms.

Reference: ``Source/Runtime/Renderer/Camera.{h,cpp}`` (orbit eye/lookat/up,
perspective pre-multiplied by kClip) and ``ViewProperties.h`` /
``CameraViewSystem.{h,cpp}`` (the per-frame View UBO: view, proj, pos,
exposure, debug switches).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core import math3d
from ..core.config import DebugEquation, DebugInput


@dataclass
class Camera:
    """Orbit-style camera (reference ``Camera.h:13-24`` defaults)."""

    eye: np.ndarray = field(default_factory=lambda: np.array([2.0, 2.0, 2.0], np.float32))
    look_at: np.ndarray = field(default_factory=lambda: np.array([0.0, 0.0, 0.0], np.float32))
    up: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, 0.0], np.float32))
    fov_degrees: float = 45.0
    near: float = 0.1
    far: float = 100.0
    width: int = 800
    height: int = 600
    exposure: float = 1.0

    def __post_init__(self):
        self._orthonormalize()

    def _orthonormalize(self):
        """Reference ``Camera.h:93-108``: re-derive up so the basis is
        orthonormal (and cache nothing else — matrices are cheap)."""
        d = math3d.normalize(np.asarray(self.eye, np.float32) - np.asarray(self.look_at, np.float32))
        if np.allclose(d, 0):
            return
        r = math3d.normalize(np.cross(np.asarray(self.up, np.float32), d))
        self.up = np.cross(d, r).astype(np.float32)

    def set_camera_view(self, eye, look_at, up) -> None:
        self.eye = np.asarray(eye, np.float32)
        self.look_at = np.asarray(look_at, np.float32)
        self.up = np.asarray(up, np.float32)
        self._orthonormalize()

    def set_image_extent(self, width: int, height: int) -> None:
        self.width, self.height = int(width), int(height)

    def move(self, direction, speed: float) -> None:
        d = np.asarray(direction, np.float32) * np.float32(speed)
        self.eye = self.eye + d
        self.look_at = self.look_at + d
        self._orthonormalize()

    @property
    def view(self) -> np.ndarray:
        return math3d.look_at(self.eye, self.look_at, self.up)

    @property
    def proj(self) -> np.ndarray:
        return math3d.perspective_vk(
            np.radians(self.fov_degrees), self.width / float(self.height), self.near, self.far
        )

    def forward(self) -> np.ndarray:
        """Camera forward is -z (``Camera.h:37``)."""
        return (-self.view[2, :3]).astype(np.float32)

    def right(self) -> np.ndarray:
        return self.view[0, :3].astype(np.float32)

    def frustum_corners(self) -> np.ndarray:
        return math3d.frustum_corners_world(self.view, self.proj)


@dataclass
class ViewProperties:
    """The per-frame view uniform block (reference ``view.glsl:1-11`` /
    ``ViewProperties.h``). ``as_arrays`` yields the per-frame uniform dict."""

    view: np.ndarray
    proj: np.ndarray
    pos: np.ndarray
    exposure: float = 1.0
    debug_input: DebugInput = DebugInput.NONE
    debug_equation: DebugEquation = DebugEquation.NONE

    @staticmethod
    def from_camera(cam: Camera, debug_input=DebugInput.NONE, debug_equation=DebugEquation.NONE):
        return ViewProperties(
            view=cam.view,
            proj=cam.proj,
            pos=np.asarray(cam.eye, np.float32),
            exposure=float(cam.exposure),
            debug_input=debug_input,
            debug_equation=debug_equation,
        )

    def as_arrays(self) -> dict:
        """Per-frame uniforms. The debug switches ride along as values, as
        in the reference, where they are uniforms too
        (``pbr.glsl:410-440``)."""
        return {
            "view": np.asarray(self.view, np.float32),
            "proj": np.asarray(self.proj, np.float32),
            "view_pos": np.asarray(self.pos, np.float32),
            "exposure": np.float32(self.exposure),
            "debug_input": np.int32(int(self.debug_input)),
            "debug_equation": np.int32(int(self.debug_equation)),
        }
