"""Light table.

Reference: ``Source/Runtime/Renderer/LightSystem.{h,cpp}`` — an append-only
array of Light structs uploaded once as a bindless storage buffer, and the
``Light`` layout consumed by ``pbr.glsl:286-300``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

import numpy as np


class LightType(IntEnum):
    """Matches the shader constants (``pbr.glsl:283-285``) and assimp's
    light-source enum used verbatim by the loader (``AssimpSceneLoader.cpp:108``)."""

    DIRECTIONAL = 1
    POINT = 2
    SPOT = 3


@dataclass
class Light:
    type: LightType = LightType.DIRECTIONAL
    color: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    position: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    direction: np.ndarray = field(default_factory=lambda: np.array([0, -1, 0], np.float32))
    intensity: float = 1.0       # lx (directional) or lm (punctual)
    falloff_radius: float = 1.0  # point/spot
    cos_inner: float = 1.0       # spot
    cos_outer: float = 0.5       # spot
    shadow_index: int = -1       # index into the shadow-map array, -1 = none


@dataclass
class LightSystem:
    lights: list = field(default_factory=list)

    def add_light(self, light: Light) -> int:
        self.lights.append(light)
        return len(self.lights) - 1

    def set_light_shadow_id(self, light_id: int, shadow_id: int) -> None:
        self.lights[light_id].shadow_index = shadow_id

    def __len__(self) -> int:
        return len(self.lights)

    def build_arrays(self) -> dict:
        """SoA dict of [L]-shaped arrays for the shading kernel. Always at
        least length 1 (zero-intensity dummy) so shapes stay static for
        empty scenes."""
        ls = self.lights or [Light(intensity=0.0)]
        return {
            "n_lights": np.int32(len(self.lights)),
            "light_type": np.array([int(l.type) for l in ls], np.int32),
            "light_color": np.stack([np.asarray(l.color, np.float32) for l in ls]),
            "light_pos": np.stack([np.asarray(l.position, np.float32) for l in ls]),
            "light_dir": np.stack([np.asarray(l.direction, np.float32) for l in ls]),
            "light_intensity": np.array([l.intensity for l in ls], np.float32),
            "light_falloff": np.array([l.falloff_radius for l in ls], np.float32),
            "light_cos_inner": np.array([l.cos_inner for l in ls], np.float32),
            "light_cos_outer": np.array([l.cos_outer for l in ls], np.float32),
            "light_shadow_index": np.array([l.shadow_index for l in ls], np.int32),
        }


def normalize_assimp_light_intensity(color: np.ndarray) -> tuple[np.ndarray, float]:
    """The reference's loader normalization (``AssimpSceneLoader.cpp:109-117``):
    intensity = max channel; color normalized by it when > 1; then scaled by
    10/683 (lux -> shading units)."""
    color = np.asarray(color, np.float32)
    intensity = float(color.max(initial=0.0))
    if intensity > 1.0:
        color = color / intensity
    intensity = 10.0 * intensity / 683.0
    return color.astype(np.float32), intensity
