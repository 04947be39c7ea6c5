"""PBR material registry.

Reference: ``Source/Runtime/Renderer/MaterialSystem.{h,cpp}`` +
``MaterialDefines.h``:

- ``MaterialProperties`` — baseColor, emissive (+exposure compensation in
  .a), f0, metallic, perceptualRoughness, ambientOcclusion, 5 texture
  handles (``MaterialSystem.h:41-51``).
- ``AlphaMode`` opaque/mask/blend (``MaterialSystem.h:53-58``): blend
  materials draw in the sorted translucent pass with culling off
  (``GraphicsPipelineCache.cpp:307``).
- ``MaterialHandle`` — bitfield {domain:2, model:2, index:28}
  (``MaterialDefines.h:26-97``).

The whole table uploads as one SoA buffer indexed by material id — the
device analog of the one MaterialProperties SSBO registered bindlessly
(``MaterialSystem.cpp:144-160``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

import numpy as np

INVALID_TEXTURE = -1  # reference: handle >= MAX_DESCRIPTOR_COUNT means "no texture" (pbr.glsl:102)


class AlphaMode(IntEnum):
    OPAQUE = 0
    MASK = 1
    BLEND = 2


class ShadingDomain(IntEnum):
    SURFACE = 0


class ShadingModel(IntEnum):
    LIT = 0
    UNLIT = 1


def make_material_handle(index: int, domain=ShadingDomain.SURFACE, model=ShadingModel.LIT) -> int:
    """Pack {domain:2, model:2, index:28} (``MaterialDefines.h:26-97``)."""
    assert 0 <= index < (1 << 28)
    return (int(domain) << 30) | (int(model) << 28) | index


def material_handle_index(handle: int) -> int:
    return handle & ((1 << 28) - 1)


@dataclass
class MaterialProperties:
    base_color: np.ndarray = field(default_factory=lambda: np.ones(4, np.float32))
    emissive: np.ndarray = field(default_factory=lambda: np.zeros(4, np.float32))
    f0: float = 0.04  # 0.16 * 0.5^2 default reflectance
    metallic: float = 0.0
    perceptual_roughness: float = 1.0
    ambient_occlusion: float = 1.0
    base_color_texture: int = INVALID_TEXTURE
    emissive_texture: int = INVALID_TEXTURE
    orm_texture: int = INVALID_TEXTURE     # occlusion/roughness/metallic
    normals_texture: int = INVALID_TEXTURE
    ao_texture: int = INVALID_TEXTURE


@dataclass
class MaterialInstanceInfo:
    properties: MaterialProperties = field(default_factory=MaterialProperties)
    alpha_mode: AlphaMode = AlphaMode.OPAQUE
    alpha_cutoff: float = 0.5  # glTF material.alphaCutoff (MASK mode only)


@dataclass
class MaterialSystem:
    instances: list = field(default_factory=list)  # list[MaterialInstanceInfo]

    def create_material_instance(self, info: MaterialInstanceInfo) -> int:
        """Returns a packed MaterialHandle (creation is 'deferred' in the
        reference, ``MaterialSystem.cpp:49-59``; here the table row exists
        immediately and the pipeline analog is just config)."""
        self.instances.append(info)
        return make_material_handle(len(self.instances) - 1)

    def is_translucent(self, handle: int) -> bool:
        """Reference ``MaterialSystem.h:118``: blend-mode materials are
        translucent and draw back-to-front."""
        return self.instances[material_handle_index(handle)].alpha_mode == AlphaMode.BLEND

    def __len__(self) -> int:
        return len(self.instances)

    def build_arrays(self) -> dict:
        """SoA dict of [M]-shaped arrays (at least one default row)."""
        ms = [i.properties for i in self.instances] or [MaterialProperties()]
        am = [i.alpha_mode for i in self.instances] or [AlphaMode.OPAQUE]
        return {
            "mat_base_color": np.stack([np.asarray(m.base_color, np.float32) for m in ms]),
            "mat_emissive": np.stack([np.asarray(m.emissive, np.float32) for m in ms]),
            "mat_f0": np.array([m.f0 for m in ms], np.float32),
            "mat_metallic": np.array([m.metallic for m in ms], np.float32),
            "mat_roughness": np.array([m.perceptual_roughness for m in ms], np.float32),
            "mat_ao": np.array([m.ambient_occlusion for m in ms], np.float32),
            "mat_tex_base": np.array([m.base_color_texture for m in ms], np.int32),
            "mat_tex_emissive": np.array([m.emissive_texture for m in ms], np.int32),
            "mat_tex_orm": np.array([m.orm_texture for m in ms], np.int32),
            "mat_tex_normal": np.array([m.normals_texture for m in ms], np.int32),
            "mat_tex_ao": np.array([m.ao_texture for m in ms], np.int32),
            "mat_alpha_mode": np.array([int(a) for a in am], np.int32),
            "mat_alpha_cutoff": np.array(
                [i.alpha_cutoff for i in self.instances] or [0.5], np.float32),
        }


def ior_to_f0(ior: float) -> float:
    """Reference loader: f0 = ((ior-1)/(ior+1))^2 (``AssimpSceneLoader.cpp:293-297``)."""
    return float(((ior - 1.0) / (ior + 1.0)) ** 2)
