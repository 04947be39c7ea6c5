"""SSAA x2 (``RenderConfig.ssaa=2``: the frame rendered at twice the width
and height, box-resolved) held to the JAX package's frames on the CPU, on
the procedural Sponza at 64x48 (128x96 inside, 8 textures, 2000
triangles) with 64^2 shadow maps.

Tolerances, stated: the golden bar (within 1/255 on >= 99.9% of pixels,
max 4/255), with every overflow counter 0.
- The per-pixel default (``RenderConfig()`` at that size and shadow
  extent; the port's ``cuda`` backend, the kernels' plain versions)
  against the JAX package's ``reference`` backend with its shadow pass and
  frame function called outside ``jit``, as
  ``tests/test_torch_frame.py::test_frozen_goldens_follow_the_unjitted_jax_frame``
  does (the jitted frame's fused rounding moves a texture-sampling
  decision on a few diagonals: ROADMAP.md F1/F3).
- The texture-space headline (``texture_space``, ``tss_preshaded_blend``,
  ``dither_trilinear``, ``sky_halfres``) against the JAX package's
  ``FrameRenderer.render()``, as ``tests/test_torch_tss_frame.py`` does,
  with the light tables sampled per pixel (``tss_halfres_light=0``): the
  half-res light upsample flips on last-bit differences of chart uvs
  (ROADMAP.md F7), so with it the frames are compared and the numbers
  printed, not held to the bar."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderengine_tpu.core.config import RenderConfig as JRenderConfig
from renderengine_tpu.graph import frame as jframe
from renderengine_tpu.scene import procedural as jproc
from renderengine_tpu_torch.core.config import RenderConfig
from renderengine_tpu_torch.graph.frame import FrameRenderer
from renderengine_tpu_torch.scene import procedural as tproc
from renderengine_tpu_torch.tools import goldens

torch.set_num_threads(2)

W, H = 64, 48
SCENE = dict(width=W, height=H, n_textures=8, target_tris=2000)
BASE = dict(width=W, height=H, shadow_extent=64, ssaa=2)
HEADLINE = dict(debug_views=False, texture_space=True,
                tss_preshaded_blend=True, dither_trilinear=True,
                sky_halfres=True)


def _port(cfg):
    r = FrameRenderer(tproc.sponza_scene(**SCENE), cfg, device="cpu",
                      backend="cuda")
    img, st = r.render()
    assert img.shape == (H, W, 4)
    assert not any(int(v) for k, v in st.items() if "overflow" in k)
    assert r.shadow_overflow == 0
    return img.numpy()


def test_per_pixel_ssaa2_meets_the_golden_bar_against_jax():
    jcfg = JRenderConfig(**BASE)
    jr = jframe.FrameRenderer(jproc.sponza_scene(**SCENE), jcfg,
                              backend="reference")
    ju = jnp.asarray(jr.uniform_for_camera())
    maps = jframe.render_shadow_pass(jr.scene_dev, ju, jcfg, jr.n_shadows,
                                     backend="reference")
    jimg = np.asarray(jframe.render_frame(
        jr.scene_dev, ju, maps, jcfg, jr.n_shadows, backend="reference",
        has_translucent=jr._has_translucent, slots_used=jr._slots_used,
        shadow_lights=jr._shadow_lights, has_mask=jr._has_mask))
    assert jimg.shape == (H, W, 4)
    img = _port(RenderConfig(**BASE))
    frac, mx = goldens.golden_bar(img, jimg)
    print(f"per-pixel ssaa2 vs the unjitted JAX frame: {frac:.6f} within "
          f"1/255, max {mx}/255")
    assert goldens.meets_bar(frac, mx), (frac, mx)
    # SSAA is on: the frame differs from the one rendered at 1x
    one = _port(RenderConfig(**dict(BASE, ssaa=1)))
    assert (one != img).any()


@pytest.mark.parametrize("halfres", [0, -1], ids=["per_pixel_light",
                                                  "halfres_light"])
def test_tss_headline_ssaa2_against_jax(halfres):
    kw = dict(BASE, **HEADLINE, tss_halfres_light=halfres)
    jimg = np.asarray(jframe.FrameRenderer(jproc.sponza_scene(**SCENE),
                                           JRenderConfig(**kw),
                                           backend="reference").render())
    img = _port(RenderConfig(**kw))
    frac, mx = goldens.golden_bar(img, jimg)
    print(f"TSS headline ssaa2, tss_halfres_light={halfres}, vs the JAX "
          f"frame: {frac:.6f} within 1/255, max {mx}/255")
    if halfres == 0:
        assert goldens.meets_bar(frac, mx), (frac, mx)
