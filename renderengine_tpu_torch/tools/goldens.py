"""The golden-frame cases of this package, and the golden bar.

The same seven scenes and configs as the JAX package's
``tests/golden_configs.py``, built with this package's own scene and
config modules.

Each frame is held to the golden bar (``tests/test_golden.py``): within
1/255 per channel on >= 99.9% of pixels and 4/255 everywhere. The golden
is ``tests/goldens_torch/<name>.png`` where one exists, else the JAX
package's ``tests/goldens/<name>.png``. ``goldens_torch`` holds the configs
whose JAX golden carries XLA's fused (multiply-add contracted) rounding
into a discrete texture-sampling decision: the JAX package's own frame
function run outside ``jit``, without that fusion, misses those goldens
by the same margin as this package (``tests/test_torch_frame.py``).
Refreeze them with

    python -m renderengine_tpu_torch.tools.goldens --freeze NAME [NAME ...]

which renders NAME with the ``reference`` backend on the CPU.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..core.config import RenderConfig, ShadingModel
from ..utils.png import read_png, write_png

_TESTS = Path(__file__).resolve().parents[2] / "tests"
GOLDEN_DIR = _TESTS / "goldens"
TORCH_GOLDEN_DIR = _TESTS / "goldens_torch"
WIDTH, HEIGHT = 128, 96


def material_showcase_scene(width=WIDTH, height=HEIGHT):
    """Sphere + grazing floor, every texture slot wired: base color,
    tangent-space normal map, occlusion/roughness/metallic, emissive."""
    from ..core import math3d
    from ..core.aabb import AABB
    from ..scene import procedural
    from ..scene.camera import Camera
    from ..scene.lights import Light, LightType
    from ..scene.materials import MaterialInstanceInfo, MaterialProperties
    from ..scene.scene import Scene

    rng = np.random.default_rng(7)
    sc = Scene()
    tb = sc.textures.add_texture(
        procedural.checker_texture(128, tiles=6, c0=(220, 200, 170),
                                   c1=(90, 60, 40)), key="base")
    tn = sc.textures.add_texture(
        procedural.normal_map_texture(128, rng, strength=2.5), key="nrm")
    to = sc.textures.add_texture(procedural.orm_texture(128, rng), key="orm")
    te = sc.textures.add_texture(
        procedural.emissive_texture(128, rng, color=(255, 120, 40),
                                    glow=0.3), key="em")
    full = sc.materials.create_material_instance(MaterialInstanceInfo(
        MaterialProperties(base_color=np.ones(4, np.float32),
                           emissive=np.array([1, 1, 1, 1], np.float32),
                           perceptual_roughness=0.8, metallic=0.1,
                           base_color_texture=tb, normals_texture=tn,
                           orm_texture=to, emissive_texture=te)))
    floor = sc.materials.create_material_instance(MaterialInstanceInfo(
        MaterialProperties(base_color=np.ones(4, np.float32),
                           perceptual_roughness=0.5,
                           base_color_texture=tb, normals_texture=tn,
                           orm_texture=to)))

    def add(geo, tf, mat, pts):
        p, n, u, i = geo
        node = sc.tree.create_node(tf, AABB.from_points(pts))
        base = sc.meshes.add_vertices(p, n, u)
        sc.meshes.add_mesh(i + base, mat, node)

    add(procedural.make_uv_sphere(1.0, stacks=24, slices=48),
        math3d.translate([0, 1.0, 0]), full, [[-1, -1, -1], [1, 1, 1]])
    add(procedural.make_plane(0.5), math3d.scale([30, 1, 30]), floor,
        [[-0.5, 0, -0.5], [0.5, 0, 0.5]])
    sc.lights.add_light(Light(type=LightType.DIRECTIONAL,
                              color=np.ones(3, np.float32),
                              direction=math3d.normalize([-0.4, -1.0, -0.2]),
                              intensity=3.0))
    sc.camera = Camera(eye=np.array([0.0, 1.2, 4.5], np.float32),
                       look_at=np.array([0.0, 0.8, 0.0], np.float32),
                       up=np.array([0, 1, 0], np.float32),
                       fov_degrees=50.0, near=0.1, far=100.0,
                       width=width, height=height, exposure=1.0)
    return sc


def golden_cases():
    """[(name, scene_factory, RenderConfig)] of the seven goldens."""
    from ..scene import procedural

    w, h = WIDTH, HEIGHT

    def cube():
        return procedural.cube_scene(textured=True, width=w, height=h)

    def multimesh():
        return procedural.sponza_scene(width=w, height=h, n_textures=8,
                                       target_tris=1_500)

    def bindless():
        return procedural.sponza_scene(width=w, height=h, n_textures=48,
                                       target_tris=2_000)

    base = RenderConfig(width=w, height=h, shadow_extent=128)
    opaque = base.replace(shadows=False, skybox=False, translucency=False)
    return [
        ("cube_phong", cube, opaque.replace(shading=ShadingModel.PHONG)),
        ("multimesh_opaque", multimesh, opaque),
        ("bindless_textures", bindless, opaque),
        # directional shadow mapping (depth pass + PCF) over the full scene
        ("shadows_pcf", bindless,
         base.replace(skybox=False, translucency=False)),
        # skybox cubemap + the full default frame (translucency on)
        ("skybox_full", bindless, base),
        # diffuse irradiance from the environment cube in the lighting
        ("ibl_diffuse", bindless,
         base.replace(shadows=False, translucency=False, ibl_diffuse=True)),
        ("normal_orm", material_showcase_scene, opaque),
    ]


def golden_path(name: str) -> Path:
    own = TORCH_GOLDEN_DIR / f"{name}.png"
    return own if own.exists() else GOLDEN_DIR / f"{name}.png"


def golden_bar(img: np.ndarray, gold: np.ndarray) -> tuple[float, int]:
    """(fraction of pixels within 1/255, max channel diff)."""
    diff = np.abs(img.astype(np.int32) - gold.astype(np.int32)).max(-1)
    return float((diff <= 1).mean()), int(diff.max())


def meets_bar(frac_within_1: float, max_diff: int) -> bool:
    return frac_within_1 >= 0.999 and max_diff <= 4


def load_golden(name: str) -> np.ndarray:
    return read_png(str(golden_path(name)))


def _freeze(names) -> None:
    from ..graph.frame import FrameRenderer

    TORCH_GOLDEN_DIR.mkdir(exist_ok=True)
    for name, factory, cfg in golden_cases():
        if name not in names:
            continue
        img, _ = FrameRenderer(factory(), cfg, device="cpu",
                               backend="reference").render()
        img = img.numpy()
        frac, mx = golden_bar(img, read_png(str(GOLDEN_DIR / f"{name}.png")))
        write_png(str(TORCH_GOLDEN_DIR / f"{name}.png"), img)
        print(f"{name}: froze; against the JAX golden {frac:.6f} of pixels "
              f"within 1/255, max {mx}/255")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--freeze", nargs="+", required=True,
                    help="golden names to render and write to goldens_torch")
    _freeze(ap.parse_args().freeze)
