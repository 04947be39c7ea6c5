"""Scene loading dispatch — the public AssimpSceneLoader-equivalent API
(``AssimpSceneLoader.h:27-72``: Load + ResetCamera)."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core.asset_path import AssetPath
from .scene import Scene


def load_scene(path, scene: Scene | None = None) -> Scene:
    """Load a scene file (.obj, .gltf, .glb, .dae, .fbx) or a builtin
    procedural name ('cube', 'sponza'). Returns the populated Scene."""
    from . import procedural

    name = str(path)
    if name == "cube":
        return procedural.cube_scene()
    if name == "sponza":
        return procedural.sponza_scene()

    disk = AssetPath(name).get_path_on_disk() if not isinstance(path, Path) else path
    suffix = Path(disk).suffix.lower()
    if suffix == ".obj":
        from .loader_obj import load_obj

        scene = load_obj(disk, scene)
    elif suffix in (".gltf", ".glb"):
        from .loader_gltf import load_gltf

        scene = load_gltf(disk, scene)
    elif suffix == ".dae":
        from .loader_dae import load_dae

        scene = load_dae(disk, scene)
    elif suffix == ".fbx":
        from .loader_fbx import load_fbx

        scene = load_fbx(disk, scene)
    else:
        raise ValueError(f"unsupported scene format: {disk}")
    reset_camera(scene)
    return scene


def reset_camera(scene: Scene) -> None:
    """Auto-frame the orbit camera if the loader didn't place one
    (reference ``AssimpSceneLoader::LoadCamera``/``ResetCamera``,
    ``AssimpSceneLoader.cpp:153-175``)."""
    box = scene.scene_aabb()
    if box.is_empty():
        return
    # if the camera still sits at its default, frame the scene
    if np.allclose(scene.camera.eye, [2.0, 2.0, 2.0]):
        r = float(np.linalg.norm(box.corners(), axis=1).max()) * 1.5
        scene.camera.set_camera_view(np.array([r, r, r], np.float32),
                                     box.center(),
                                     np.array([0, 1, 0], np.float32))
