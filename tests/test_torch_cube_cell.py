"""The point-light cube shadow configuration (``sponza1080_tss_cube``: the
procedural Sponza whose nave lamp casts six cube-face maps, under the
texture-space headline) on the CPU: the port's scene and the plain
reference's copy are the same inputs, the cube faces render in their own
stamped region and give the maps of the pass without it, and a whole run of
the benchmark cell at a small size is correct, and not correct with the
lamp's +X and -X faces swapped. This file imports no JAX.
"""

import json

import numpy as np
import pytest
import torch

from portbench import checks, harness
from renderengine_tpu_torch.core.config import RenderConfig
from renderengine_tpu_torch.graph import frame as frame_mod
from renderengine_tpu_torch.graph.frame import FrameRenderer
from renderengine_tpu_torch.graph.uniforms import unpack_params
from renderengine_tpu_torch.raster import cuda_raster
from renderengine_tpu_torch.scene import procedural
from renderengine_tpu_torch.utils import profiling

CELL = "tss_cube.dirty_orbit"
W, H = 96, 64
SCENE = dict(width=W, height=H, n_textures=16, target_tris=3000)
SEED = 2**31 + 7
LAMP_BASE = 2                # sun 0, spot 1, the lamp's faces 2-7


def test_the_cube_configuration_loads():
    """The cell's configuration is the 1080p texture-space one with the
    cube scene's builder, under the shadow-dirty orbit, on one card."""
    spec = harness.load_cell(CELL)
    base = json.loads((harness.HERE / "configs" / "sponza1080_tss.json")
                      .read_text())
    assert spec["config"]["scene"] == dict(base["scene"],
                                           builder="sponza_cube_scene")
    assert spec["config"]["render_config"] == base["render_config"]
    assert spec["config"]["settle_frames"] == base["settle_frames"]
    assert spec["config"]["reduced"] == [] and spec["cell"]["chips"] == 1
    assert spec["traffic"]["name"] == "dirty_orbit"
    assert spec["traffic"]["shadows_dirty_every"] == 1


@pytest.mark.parametrize("seed", [3, SEED])
def test_the_cube_scenes_are_the_same_inputs(seed):
    """The port's ``sponza_cube_scene`` and the reference's file of that
    name digest alike: 8 maps, the lamp's six from index 2."""
    port = procedural.sponza_cube_scene(seed=seed, **SCENE)
    ref = checks.reference_builder("sponza_cube_scene")(seed=seed, **SCENE)
    assert harness.scene_fingerprint(port, port.camera.eye) == \
        harness.scene_fingerprint(ref, ref.camera.eye)
    for sc in (port, ref):
        assert sc.n_shadow_maps == 8
        lamp, = [lt for lt in sc.lights.lights if lt.type.value == 2]
        assert lamp.shadow_index == LAMP_BASE
    plain = procedural.sponza_scene(seed=seed, **SCENE)
    assert harness.scene_fingerprint(plain, plain.camera.eye) != \
        harness.scene_fingerprint(port, port.camera.eye)


def test_the_cube_faces_are_stamped_and_render_the_plain_maps():
    """A shadow-dirty texture-space frame of the cube scene enters
    ``frame.shadow_cube`` and ``frame.vis_cube`` (host clock stamps on the
    CPU), and counts no kernel launch (the CPU launches nothing); the
    maps rendered with the faces inside their span are the maps of the
    pass that stamps no face."""
    cfg = RenderConfig(width=W, height=H, shadow_extent=96,
                       debug_views=False, texture_space=True,
                       tss_preshaded_blend=True, dither_trilinear=True,
                       sky_halfres=True)
    r = FrameRenderer(procedural.sponza_cube_scene(seed=SEED, **SCENE), cfg,
                      device="cpu")
    assert r._cube_bases == (LAMP_BASE,) and r.n_shadows == 8
    before = dict(cuda_raster.launch_counts)
    r.render()
    r.mark_shadows_dirty()
    _, st = r.render()
    assert dict(cuda_raster.launch_counts) == before
    ns = dict(zip(profiling.STAMPED, st["pass_ns"].tolist()))
    assert ns["frame.shadow_cube"] > 0 and ns["frame.vis_cube"] > 0
    assert ns["frame.shadow_cube"] <= ns["frame.shadow"]
    params = unpack_params(r._u, r.n_shadows)
    args = (r.scene_dev, params["shadow_viewproj"], 96, r.n_shadows,
            r.config.raster, r.backend)
    spanned, ov_s = frame_mod.render_shadow_maps(*args,
                                                 cube_bases=r._cube_bases)
    plain, ov_p = frame_mod.render_shadow_maps(*args)
    assert torch.equal(spanned, plain) and int(ov_s) == int(ov_p) == 0
    assert torch.equal(r._shadow_maps.blocks,
                       frame_mod.shadow_mod.pack_shadow_blocks(plain).blocks)


def _faces_swapped(cell):
    """A fault: the lamp's +X and -X face transforms swapped in the port's
    frame (the shadow pass renders each face with the other's transform,
    and the visibility bake looks them up so)."""
    r = cell.r
    params_for_camera = r.params_for_camera

    def faulty(view_props=None):
        p = params_for_camera(view_props)
        svp = np.array(p["shadow_viewproj"], copy=True)
        svp[[LAMP_BASE, LAMP_BASE + 1]] = svp[[LAMP_BASE + 1, LAMP_BASE]]
        p["shadow_viewproj"] = svp
        return p
    r.params_for_camera = faulty


@pytest.mark.parametrize("case", ["sound", "faces_swapped"])
def test_a_cube_cell_run(case):
    """A whole CPU run of the cell at 96x64 with 96^2 maps (every frame
    shadow-dirty: the refit, the eight maps and both bakes): correct, with
    no frame off; with the lamp's +X and -X faces swapped in the port, not
    correct: 2.99% of the compared frame's bytes are off by more than 1
    against the 0.5% limit (seed 2**31 + 7)."""
    harness.set_cache_env()
    out = harness.run(CELL, SEED, 1.0, False, device="cpu",
                      require_card=False, settle_frames=2,
                      fault=_faces_swapped if case == "faces_swapped"
                      else None, scene_overrides=SCENE,
                      config_overrides=dict(width=W, height=H,
                                            shadow_extent=96))
    assert out["checks"]["inputs_differ"]["value"] == 0
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["correct"] == (case == "sound"), out["checks"]
    if case == "sound":
        assert out["checks"]["frame_off_gt1"]["value"] == 0.0
