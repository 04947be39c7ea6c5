"""The reference's copy of the port's ``sponza_cube_scene``: the
procedural Sponza whose nave lamp (the point light at (0, 3, 0)) also
casts its shadow, six cube-face maps after the sun's and the spot's
(sun 0, spot 1, lamp 2-7). Imports nothing of the port."""

from portbench.reference.scene import procedural
from portbench.reference.scene.lights import LightType


def build(seed, **scene):
    sc = procedural.sponza_scene(seed=seed, **scene)
    lamp = next(i for i, lt in enumerate(sc.lights.lights)
                if lt.type == LightType.POINT)
    sc.create_shadow_map(lamp)
    return sc
