"""The overlays of the frame — the editor ground grid
(``shading/grid.py``) and the shadow-map preview quad
(``shading/textured_quad.py``) — against the JAX package's on the same
inputs, alone and in the frame.

Tolerances: ``render_grid`` within 1e-5 of the JAX package's linear rgb
(measured 0 on these inputs); ``draw_textured_quad`` exact; frames with
``grid=True`` and ``show_shadow_quad=True`` at the golden bar against the
JAX frame (within 1/255 on >= 99.9% of pixels, max 4/255; measured
identical)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderengine_tpu.core.config import RenderConfig as JConfig
from renderengine_tpu.graph import frame as jframe
from renderengine_tpu.scene import procedural as jproc
from renderengine_tpu.scene.camera import ViewProperties as JViewProperties
from renderengine_tpu.shading import grid as jgrid
from renderengine_tpu.shading.textured_quad import \
    draw_textured_quad as jdraw

from renderengine_tpu_torch.core.config import RenderConfig
from renderengine_tpu_torch.graph.frame import FrameRenderer
from renderengine_tpu_torch.scene import procedural
from renderengine_tpu_torch.shading import grid
from renderengine_tpu_torch.shading.textured_quad import draw_textured_quad
from renderengine_tpu_torch.tools import goldens

torch.set_num_threads(2)


def _camera_mats(eye, w, h):
    sc = jproc.cube_scene(width=w, height=h)
    sc.camera.set_camera_view(np.asarray(eye, np.float32),
                              np.zeros(3, np.float32),
                              np.array([0, 1, 0], np.float32))
    vp = JViewProperties.from_camera(sc.camera)
    view = np.asarray(vp.view, np.float32)
    proj = np.asarray(vp.proj, np.float32)
    return view, proj, jgrid.grid_unproject_matrix(view, proj)


@pytest.mark.parametrize("eye,w,h", [((3.0, 2.0, 4.0), 96, 64),
                                     ((0.5, 6.0, 0.7), 67, 45),
                                     ((8.0, 0.6, -3.0), 128, 96)])
def test_render_grid_matches_jax(eye, w, h, rng):
    view, proj, inv_vp = _camera_mats(eye, w, h)
    np.testing.assert_array_equal(
        grid.grid_unproject_matrix(view, proj), inv_vp)
    depth = rng.uniform(0.8, 1.0, (h, w)).astype(np.float32)
    rgb = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    mine = grid.render_grid(torch.from_numpy(inv_vp), torch.from_numpy(view),
                            torch.from_numpy(proj), torch.from_numpy(depth),
                            torch.from_numpy(rgb)).numpy()
    ref = np.asarray(jgrid.render_grid(jnp.asarray(inv_vp),
                                       jnp.asarray(view), jnp.asarray(proj),
                                       jnp.asarray(depth), jnp.asarray(rgb)))
    assert (np.abs(mine - rgb).max(-1) > 1e-3).mean() > 0.01, "no grid drawn"
    np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-5)


def test_render_grid_row_slices_compose():
    """``y0``/``full_height``: two row slices (split on an even row, the
    quad-derivative parity) give the full-frame grid exactly."""
    view, proj, inv_vp = _camera_mats((3.0, 2.0, 4.0), 64, 48)
    t = [torch.from_numpy(a) for a in (inv_vp, view, proj)]
    depth = torch.ones(48, 64)
    rgb = torch.zeros(48, 64, 3)
    full = grid.render_grid(*t, depth, rgb)
    parts = [grid.render_grid(*t, depth[y0:y0 + 24], rgb[y0:y0 + 24],
                              y0=y0, full_height=48) for y0 in (0, 24)]
    assert torch.equal(torch.cat(parts), full)


@pytest.mark.parametrize("src,center,size", [
    ("gray", (-0.6, -0.6), (0.35, 0.35)),
    ("gray", (0.3, -0.2), (0.5, 0.25)),
    ("rgba8", (-0.5, 0.5), (0.4, 0.3)),
    ("rgb", (0.9, 0.9), (0.3, 0.3)),          # clipped at the corner
    ("gray", (3.0, 3.0), (0.1, 0.1)),         # off screen: unchanged
])
def test_textured_quad_matches_jax(src, center, size, rng):
    rgb = rng.uniform(0, 1, (45, 67, 3)).astype(np.float32)
    source = {"gray": rng.uniform(0, 1, (33, 21)).astype(np.float32),
              "rgba8": rng.integers(0, 255, (16, 24, 4), dtype=np.uint8),
              "rgb": rng.uniform(0, 1, (9, 9, 3)).astype(np.float32)}[src]
    mine = draw_textured_quad(torch.from_numpy(rgb), torch.from_numpy(source),
                              center=center, size=size).numpy()
    ref = np.asarray(jdraw(jnp.asarray(rgb), jnp.asarray(source),
                           center=center, size=size))
    np.testing.assert_array_equal(mine, ref)


def _configs(**kw):
    base = dict(width=128, height=96, shadow_extent=256, **kw)
    return RenderConfig(**base), JConfig(**base)


@pytest.mark.parametrize("kw", [dict(grid=True), dict(show_shadow_quad=True),
                                dict(grid=True, show_shadow_quad=True,
                                     translucency=False)],
                         ids=["grid", "shadow_quad", "both"])
def test_overlay_frames_against_jax(kw):
    """The whole frame with the overlays on, against the JAX package's
    frame of the same scene and config, at the golden bar; each overlay
    changes the frame."""
    cfg, jcfg = _configs(**kw)
    img, st = FrameRenderer(procedural.cube_scene(width=128, height=96), cfg,
                            device="cpu").render()
    ref = np.asarray(jframe.FrameRenderer(
        jproc.cube_scene(width=128, height=96), jcfg).render())
    frac, mx = goldens.golden_bar(img.numpy(), ref)
    assert goldens.meets_bar(frac, mx), (frac, mx)
    assert not any(int(v) for k, v in st.items() if "overflow" in k)
    off = {k: False for k in kw if k != "translucency"}
    plain, _ = FrameRenderer(procedural.cube_scene(width=128, height=96),
                             cfg.replace(**off), device="cpu").render()
    changed = (img != plain).any(-1).float().mean()
    assert changed > 0.02, float(changed)


def test_shadow_quad_shows_the_sun_map():
    """The quad shows the first shadow map's even texels, low 16 bits of
    word 0 of the packed blocks (int32 bit views here): nearest texels
    are dark, the cleared far plane is white."""
    cfg, _ = _configs(show_shadow_quad=True, translucency=False,
                      skybox=False)
    r = FrameRenderer(procedural.cube_scene(width=128, height=96), cfg,
                      device="cpu")
    img, _ = r.render()
    blocks = r._shadow_maps.blocks
    maps = (blocks[0, 1:, 1:, 0] & 0xFFFF).float() / 65535.0
    assert float(maps.max()) == 1.0 and float(maps.min()) < 0.9
    # the quad spans x in [0.125, 0.475) of the width, y likewise
    quad = img[10:34, 16:61, :3].float()
    assert (quad[..., 0] == quad[..., 1]).all() and \
        (quad[..., 1] == quad[..., 2]).all()
    assert int(quad.max()) == 255 and int(quad.min()) < 250
