"""The supersampled benchmark configuration (``sponza1080_tss_ssaa2``:
the texture-space headline at ``ssaa`` 2, the stand-in for the Vulkan
reference's multisampled, resolved frame) on the CPU: it loads as the
1080p texture-space configuration plus ``ssaa``, and the port's frame
is the plain reference's (``portbench/reference/``), byte for byte,
with the resolve the reference holds it to. This file imports no JAX.
"""

import json

import numpy as np
import pytest
import torch

from portbench import checks, harness, schedule
from portbench.reference.graph.frame import ReferenceRenderer
from portbench.reference.scene import procedural as ref_procedural
from portbench.reference.scene.camera import ViewProperties as RefVP
from renderengine_tpu_torch.core.config import RasterConfig, RenderConfig
from renderengine_tpu_torch.graph import frame as frame_mod
from renderengine_tpu_torch.graph.frame import FrameRenderer
from renderengine_tpu_torch.scene import procedural
from renderengine_tpu_torch.scene.camera import ViewProperties

CELL = "tss_ssaa2.orbit"
W, H = 96, 64
SCENE = dict(width=W, height=H, n_textures=16, target_tris=3000)
SEED = 2**31 + 7
POSES = (40, 230)            # two poses of the cell's orbit


def test_the_supersampled_configuration_loads():
    """The cell's configuration is the 1080p texture-space one plus
    ``ssaa`` 2: 3840x2160 rendered, 1920x1080 out, the same scene."""
    spec = harness.load_cell(CELL)
    cfg = harness.render_config(RenderConfig, RasterConfig,
                                spec["config"]["render_config"])
    assert cfg.render_extent() == (2160, 3840)
    assert (cfg.height, cfg.width) == (1080, 1920)
    base = json.loads((harness.HERE / "configs" / "sponza1080_tss.json")
                      .read_text())
    assert spec["config"]["scene"] == base["scene"]
    assert spec["config"]["render_config"] == dict(base["render_config"],
                                                   ssaa=2)
    assert spec["config"]["guarantees"] == base["guarantees"]
    assert spec["config"]["reduced"] == [] and spec["cell"]["chips"] == 1
    assert spec["traffic"]["name"] == "orbit"


def _point_sampled(rgb, f):
    """A cheaper resolve: the first sample of each ``f x f`` block."""
    return rgb[::f, ::f].contiguous()


def _bfloat16(rgb, f, _resolve=frame_mod.resolve_ssaa):
    """A cheaper resolve: the box mean of bfloat16 samples."""
    return _resolve(rgb.to(torch.bfloat16), f).to(torch.float32)


FAULTS = (_point_sampled, _bfloat16)


def _frames(fields):
    """The port's frames at each of ``POSES`` (the harness's order: a
    first frame at the scene's own camera fits the shadow maps, then the
    orbit's poses with the maps cached): per pose, whether its counters
    report dropped work, its frame, and the frame again with each of
    the cheaper resolves in place of the port's box resolve."""
    sched = schedule.Schedule(harness.load_cell(CELL)["traffic"])
    r = FrameRenderer(procedural.sponza_scene(seed=SEED, **SCENE),
                      harness.render_config(RenderConfig, RasterConfig,
                                            fields),
                      device="cpu", backend="reference")
    cam = r.scene_host.camera
    eye0 = np.asarray(cam.eye, np.float32).copy()
    look0 = np.asarray(cam.look_at, np.float32).copy()
    r.render()
    out = []
    for i in POSES:
        sched.apply(cam, eye0, look0, i)
        vp = ViewProperties.from_camera(cam)
        img, st = r.render(vp)
        drops = any(int(v) for k, v in st.items() if "overflow" in k)
        faulty = {}
        for fault in FAULTS:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(frame_mod, "resolve_ssaa", fault)
                faulty[fault.__name__] = r.render(vp)[0]
        out.append((drops, img, faulty))
    return out


def _candidates(fields):
    """The reference's candidate images at each of ``POSES``."""
    sched = schedule.Schedule(harness.load_cell(CELL)["traffic"])
    scene = ref_procedural.sponza_scene(seed=SEED, **SCENE)
    rcfg = checks.reference_config(fields)
    rr = ReferenceRenderer(scene, rcfg, "cpu")
    fit0 = rr.shadow_fit()
    cam = scene.camera
    eye0 = np.asarray(cam.eye, np.float32).copy()
    look0 = np.asarray(cam.look_at, np.float32).copy()
    out = []
    for i in POSES:
        sched.apply(cam, eye0, look0, i)
        out.append(rr.render(RefVP.from_camera(cam), rcfg, fit0))
    return out


@pytest.mark.parametrize("halfres_light", [0, 1])
def test_the_supersampled_frame_is_the_references(halfres_light):
    """The port's texture-space headline at ``ssaa`` 2 (96x64 out,
    192x128 rendered, 96^2 shadow maps), at two poses of the orbit,
    against the plain reference's candidates of the same seed.

    Tolerance: none. A frame whose counters report no dropped work
    equals one candidate byte for byte: the reference is a frozen copy
    of the port's own ``reference``-backend frame path, resolved by the
    same float32 box mean, so any difference is a fault. Two cheaper
    resolves planted in the port, each 2x2 block point-sampled or
    averaged in bfloat16, match no candidate: the comparison catches
    them."""
    fields = dict(harness.load_cell(CELL)["config"]["render_config"],
                  width=W, height=H, shadow_extent=96,
                  tss_halfres_light=halfres_light)
    cands = _candidates(fields)
    assert all(c[0].shape == (H, W, 4) for c in cands)
    frames = _frames(fields)
    assert not all(drops for drops, _, _ in frames), "every frame dropped"
    for (drops, img, faulty), c in zip(frames, cands):
        assert img.shape == (H, W, 4)
        if not drops:
            assert any(torch.equal(img, x) for x in c)
        for name, bad in faulty.items():
            assert not any(torch.equal(bad, x) for x in c), name
