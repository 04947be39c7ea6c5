"""The frozen reference against the port on the CPU, at a tiny scene."""

import numpy as np
import pytest
import torch

from portbench import checks, harness
from portbench.kernels import k1, k2
from portbench.reference.graph import frame as rf
from portbench.reference.graph.frame import ReferenceRenderer
from portbench.reference.raster import reference_raster as rr_oracle
from portbench.reference.raster.binned_raster import rasterize_binned
from portbench.reference.raster.setup import triangle_setup_corners
from portbench.reference.core.config import CullMode
from portbench.reference.scene import procedural as ref_procedural
from portbench.reference.scene.camera import ViewProperties as RefVP
from renderengine_tpu_torch.core.config import RasterConfig, RenderConfig
from renderengine_tpu_torch.graph.frame import FrameRenderer
from renderengine_tpu_torch.scene import procedural
from renderengine_tpu_torch.scene.camera import ViewProperties

W, H = 96, 64
SCENE = dict(width=W, height=H, n_textures=16, target_tris=3000)
TSS = dict(debug_views=False, texture_space=True, tss_preshaded_blend=True,
           dither_trilinear=True, sky_halfres=True)


def _random_setup(n, h, w, seed, cull=CullMode.BACK):
    g = torch.Generator().manual_seed(seed)
    c = torch.rand((n, 3, 4), generator=g) * 2.4 - 1.2
    c[..., 3] = torch.rand((n, 3), generator=g) * 1.5 + 0.2
    c[..., 2] = torch.rand((n, 3), generator=g) * c[..., 3]
    # shared edges and coplanar duplicates exercise the tie rules
    c[n // 2:n // 2 + 8] = c[:8]
    return triangle_setup_corners(c, n, w, h, cull)


@pytest.mark.parametrize("cull", [CullMode.BACK, CullMode.NONE])
def test_binned_raster_is_the_oracle(cull):
    s = _random_setup(200, 40, 56, 3, cull)
    want = rr_oracle.rasterize_reference(s, 40, 56)
    got = rasterize_binned(s, 40, 56, chunk=999)
    assert torch.equal(got.tri_id, want.tri_id)
    assert torch.equal(got.depth, want.depth)
    prev = torch.where(want.tri_id >= 0, want.depth, 2.0)
    zmax = torch.full((40, 56), 1.0)
    want2 = rr_oracle.rasterize_reference(s, 40, 56,
                                          peel_bounds=(prev, zmax))
    got2 = rasterize_binned(s, 40, 56, peel_bounds=(prev, zmax))
    assert torch.equal(got2.tri_id, want2.tri_id)
    assert torch.equal(got2.depth, want2.depth)
    # a pass with no valid triangle (a cube face that sees nothing)
    counts = {}
    none = rasterize_binned(s._replace(valid=torch.zeros_like(s.valid)),
                            40, 56, counts=counts)
    assert counts == {"fragments": 0, "triangles": 0}
    assert bool((none.tri_id < 0).all())


def _ref_frames(fields, vp_fn, dirty_fit: bool, scene_kw=SCENE):
    """The reference's candidate images of the frame at the pose
    ``vp_fn`` sets."""
    scene = ref_procedural.sponza_scene(seed=5, **scene_kw)
    rcfg = checks.reference_config(fields)
    rr = ReferenceRenderer(scene, rcfg, "cpu")
    fit0 = rr.shadow_fit()
    vp_fn(scene.camera)
    fit = rr.shadow_fit() if dirty_fit else fit0
    return rr.render(RefVP.from_camera(scene.camera), rcfg, fit)


def _port(fields, backend="reference", scene_kw=SCENE):
    return FrameRenderer(procedural.sponza_scene(seed=5, **scene_kw),
                         harness.render_config(RenderConfig, RasterConfig,
                                               fields),
                         device="cpu", backend=backend)


def _move(cam):
    cam.set_camera_view(np.array([-12.0, 3.5, 4.0], np.float32),
                        cam.look_at, np.array([0, 1, 0], np.float32))


def _no_drops(st):
    return all(int(v) == 0 for k, v in st.items() if "overflow" in k)


@pytest.mark.parametrize("tss,ssaa", [(False, 1), (True, 1), (False, 2),
                                      (True, 2)])
def test_reference_is_the_ports_reference_backend(tss, ssaa):
    """At the budgets the port chose, a frame that drops nothing is one
    of the reference's candidates, byte for byte; supersampled, each
    candidate is resolved to the output size as the port resolves."""
    fields = dict(width=W, height=H, shadow_extent=96, ssaa=ssaa,
                  **(TSS if tss else {}))
    port = _port(fields)
    port.render()
    _move(port.scene_host.camera)
    img, st = port.render(ViewProperties.from_camera(port.scene_host.camera))
    assert _no_drops(st)
    refs = _ref_frames(fields, _move, dirty_fit=False)
    assert len(refs) == (4 if tss else 1)
    assert img.shape == (H, W, 4)
    assert any(torch.equal(img, r) for r in refs)


def test_the_resolve_and_what_the_reference_refuses():
    x = torch.rand((8, 12, 3))
    assert rf.resolve_ssaa(x, 1) is x
    got = rf.resolve_ssaa(x, 2)
    assert got.shape == (4, 6, 3)
    assert torch.allclose(got[1, 2], x[2:4, 4:6].reshape(4, 3).mean(0))
    rf.check_config(checks.reference_config(dict(ssaa=3, **TSS)))
    for bad in (dict(ssaa=0), dict(ssaa=1.5), dict(alpha_mask=True),
                dict(grid=True)):
        with pytest.raises(ValueError):
            rf.check_config(checks.reference_config(bad))


def test_a_shadow_dirty_frame_is_the_ports():
    fields = dict(width=W, height=H, shadow_extent=96, **TSS)
    port = _port(fields)
    port.render()
    _move(port.scene_host.camera)
    port.mark_shadows_dirty()
    img, st = port.render(ViewProperties.from_camera(port.scene_host.camera))
    assert _no_drops(st)
    refs = _ref_frames(fields, _move, dirty_fit=True)
    assert any(torch.equal(img, r) for r in refs)


def test_a_frame_that_drops_work_is_not_the_reference():
    """The reference reads no budget: the port's frame at a penumbra
    budget that drops most penumbra segments counts the drop and differs
    from every candidate by more than the limit."""
    scene_kw = dict(SCENE, width=384)
    fields = dict(width=384, height=H, shadow_extent=96,
                  penumbra_tile_budget=1)
    port = _port(fields, scene_kw=scene_kw)
    img, st = port.render()
    assert int(st["penumbra_overflow"]) > 0
    refs = _ref_frames(fields, lambda cam: None, dirty_fit=False,
                       scene_kw=scene_kw)
    assert checks.frame_off(img.numpy(), refs) > \
        checks.LIMITS["frame_off_gt1"]


def test_the_ports_tile_kernel_path_stays_within_the_limit():
    """The port's default backend (the tile kernels' plain versions on
    the CPU) interpolates in the kernel; the reference recomputes
    barycentrics: close, not equal."""
    fields = dict(width=W, height=H, shadow_extent=96, **TSS)
    img, st = _port(fields, backend=None).render()
    refs = _ref_frames(fields, lambda cam: None, dirty_fit=False)
    assert checks.frame_off(img.numpy(), refs) <= \
        checks.LIMITS["frame_off_gt1"]
    assert _no_drops(st)


def test_kernel_counts_do_not_move_with_the_pair_budget():
    fields = dict(width=W, height=H, shadow_extent=96, **TSS)
    scene = ref_procedural.sponza_scene(seed=5, **SCENE)
    rr = ReferenceRenderer(scene, checks.reference_config(fields), "cpu")
    vp = RefVP.from_camera(scene.camera)
    fit = rr.shadow_fit()
    works = []
    for budget in (0, 5000, 400000):
        c = checks.reference_config(dict(fields, raster=dict(
            pair_budget=budget, pairs_per_tri=7)))
        p = checks.pass_counts(rr, vp, c, fit)
        works.append((k1.work(8, False, False, p["opaque"]["fragments"],
                              p["opaque"]["wins"], p["opaque"]["triangles"],
                              p["pixels"]),
                      k2.work(2, p["opaque"], dict(p["blend"], wins=sum(
                          p["blend"]["wins"])), p["pixels"]),
                      p["shadow"]))
    assert works[0] == works[1] == works[2]
    assert p["opaque"]["fragments"] >= p["opaque"]["wins"] > 0
    assert k1.variant("void (anonymous namespace)::raster_tile_kernel<8, "
                      "true, true>((anonymous namespace)::K1Args)") == \
        (8, True, True)
    assert k2.variant("void (anonymous namespace)::merged_tile_kernel<2>("
                      "(anonymous namespace)::K2Args)") == (2,)
