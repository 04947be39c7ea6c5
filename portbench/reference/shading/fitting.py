"""Shadow frustum fitting (host-side, numpy; the JAX package's
``shading/fitting.py``, kept as this package's own copy).

Port of the *intended* behavior of ``ShadowSystem.cpp:129-204``
(``ComputeDirectionalLightViewMatrix`` + ``ComputeShadowTransform``):

1. camera frustum corners -> world AABB
2. extend toward the light to the scene's depth so off-screen casters are
   kept (near plane pushed to the farthest object along -z in light space)
3. union the world AABBs of objects intersecting that extended box
4. fit an ortho projection over the union in light view space

The reference's uninitialized-``up`` UB (SURVEY.md quirk list) is replaced
by the correct orthobasis from ``core.math3d.directional_light_view``.
"""

from __future__ import annotations

import numpy as np

from ..core import math3d
from ..core.aabb import AABB


def compute_shadow_transform(light_direction, camera, scene_box: AABB,
                             boxes: list[AABB], transforms: list[np.ndarray]):
    """Returns (shadow_view [4,4], shadow_proj [4,4]); the shader-facing
    MaterialShadowData.transform is ``shadow_proj @ shadow_view``."""
    cam_pts = camera.frustum_corners()
    cam_box_world = AABB.from_points(cam_pts)

    shadow_view = math3d.directional_light_view(light_direction)
    cam_box_view = cam_box_world.transform(shadow_view)
    scene_box_view = scene_box.transform(shadow_view)

    # keep all potential casters: bring the near plane (light looks -z) to
    # the farthest scene extent in the light direction
    if not scene_box_view.is_empty() and not cam_box_view.is_empty():
        cam_box_view.max[2] = scene_box_view.max[2]
    cam_box_world = cam_box_view.transform(np.linalg.inv(shadow_view).astype(np.float32))

    light_box_world = AABB()
    for box_local, tf in zip(boxes, transforms):
        box_world = box_local.transform(tf)
        if box_world.intersects(cam_box_world):
            light_box_world = light_box_world.union(box_world)
    if light_box_world.is_empty():
        light_box_world = scene_box if not scene_box.is_empty() else AABB.from_points([[-1, -1, -1], [1, 1, 1]])

    lb = light_box_world.transform(shadow_view)
    proj = math3d.ortho_vk(lb.min[0], lb.max[0], lb.min[1], lb.max[1], lb.min[2], lb.max[2])
    return shadow_view, proj


def compute_spot_shadow_transform(light, scene_box: AABB):
    """Perspective fit for a spot light's shadow map — BEYOND the
    reference, whose pipeline only renders the directional map
    (``shadow.glsl:27``): fov = the outer cone with a small guard band
    (so the 3x3 PCF apron stays on-map at the cone edge), far = the
    light's reach into the scene."""
    pos = np.asarray(light.position, np.float32)
    if not scene_box.is_empty():
        reach = float(np.linalg.norm(scene_box.corners() - pos,
                                     axis=1).max())
        nearest = float(np.linalg.norm(
            np.clip(pos, scene_box.min, scene_box.max) - pos))
    else:
        reach = max(float(light.falloff_radius), 1.0)
        nearest = 0.0
    far = max(reach, 1e-2)
    # scene-fitted near plane: perspective depth compresses toward 1, and
    # the shader's fixed minimum bias (shadow.glsl:35, 0.005) would swamp
    # a near->far range that starts at a tiny near. Pushing near to just
    # inside the closest geometry spends the u16 depth range on the span
    # that actually contains casters.
    near = max(far * 0.02, nearest * 0.8, 1e-3)
    cos_o = float(np.clip(light.cos_outer, -0.998, 0.998))
    fov = min(2.0 * np.arccos(cos_o) * 1.1, np.radians(170.0))
    d = math3d.normalize(np.asarray(light.direction, np.float32))
    up = np.array([0, 1, 0], np.float32)
    if abs(float(d @ up)) > 0.99:
        up = np.array([1, 0, 0], np.float32)
    view = math3d.look_at(pos, pos + d, up)
    proj = math3d.perspective_vk(float(fov), 1.0, near, far)
    return view, proj


# cube-face axes and ups, order +X -X +Y -Y +Z -Z (the face a fragment
# selects by its dominant |d| component and sign)
_CUBE_FACES = [
    (np.array([1, 0, 0], np.float32), np.array([0, 1, 0], np.float32)),
    (np.array([-1, 0, 0], np.float32), np.array([0, 1, 0], np.float32)),
    (np.array([0, 1, 0], np.float32), np.array([0, 0, 1], np.float32)),
    (np.array([0, -1, 0], np.float32), np.array([0, 0, 1], np.float32)),
    (np.array([0, 0, 1], np.float32), np.array([0, 1, 0], np.float32)),
    (np.array([0, 0, -1], np.float32), np.array([0, 1, 0], np.float32)),
]


def compute_point_shadow_transforms(light, scene_box: AABB):
    """Six perspective face fits for a point light's cube shadow —
    BEYOND the reference (directional-only live path). Face fov is a
    hair over 90 deg so the 3x3 PCF apron at a face edge stays on-map
    (neighboring faces overlap the seam)."""
    pos = np.asarray(light.position, np.float32)
    if not scene_box.is_empty():
        reach = float(np.linalg.norm(scene_box.corners() - pos,
                                     axis=1).max())
        nearest = float(np.linalg.norm(
            np.clip(pos, scene_box.min, scene_box.max) - pos))
    else:
        reach = max(float(light.falloff_radius), 1.0)
        nearest = 0.0
    far = max(reach, 1e-2)
    near = max(far * 0.02, nearest * 0.8, 1e-3)
    fov = 2.0 * np.arctan(1.06)          # ~93.3 deg: PCF guard band
    proj = math3d.perspective_vk(float(fov), 1.0, near, far)
    return [(proj @ math3d.look_at(pos, pos + ax, up)).astype(np.float32)
            for ax, up in _CUBE_FACES]


def shadow_transforms_for_scene(scene, extent_unused: int = 0) -> np.ndarray:
    """[NS,4,4] proj@view per shadow map (NS >= 1; identity rows for unused
    slots so shapes stay static). Point lights own six consecutive rows
    (cube faces)."""
    from ..scene.lights import LightType

    ns = max(1, scene.n_shadow_maps)
    out = np.tile(np.eye(4, dtype=np.float32), (ns, 1, 1))
    boxes, transforms = scene.node_world_aabbs()
    sbox = scene.scene_aabb()
    for light in scene.lights.lights:
        if light.shadow_index is None or light.shadow_index < 0:
            continue
        if light.type == LightType.POINT:
            for f, m in enumerate(
                    compute_point_shadow_transforms(light, sbox)):
                out[light.shadow_index + f] = m
            continue
        if light.type == LightType.SPOT:
            view, proj = compute_spot_shadow_transform(light, sbox)
        else:
            view, proj = compute_shadow_transform(light.direction,
                                                  scene.camera, sbox,
                                                  boxes, transforms)
        out[light.shadow_index] = (proj @ view).astype(np.float32)
    return out
